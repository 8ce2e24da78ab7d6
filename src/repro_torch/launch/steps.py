"""Serving step assembly (port of the serving half of
``repro.launch.steps``).  Training (``make_train_step``) comes with the
training slice."""

from __future__ import annotations

import torch

from repro_torch.models import zoo
from repro_torch.models.config import ModelConfig

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(model, batch):
        return zoo.prefill_fn(model, batch, cfg, max_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: logits -> next token (argmax, ties to the
    first index) -> the cache, updated in place."""
    def serve_step(model, cache, tokens):
        logits, new_cache = zoo.decode_fn(model, cache, tokens, cfg)
        return torch.argmax(logits, -1).to(torch.int32), new_cache
    return serve_step
