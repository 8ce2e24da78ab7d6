"""Model zoo: family dispatch (port of ``repro.models.zoo``).

``init_model`` builds a model from its ParamDef tree on a device (CUDA
unless the caller names another; no fallback to the CPU);
``prefill_fn`` / ``decode_fn`` are the serving entry points, on the
device the model lives on.  The dense and ssm families run; the others
raise ``NotImplementedError`` naming the slice that brings them.  The
abstract input and cache specs come with the dry-run slice.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params

__all__ = ["model_defs", "init_model", "prefill_fn", "decode_fn"]


def model_defs(cfg: ModelConfig):
    return lm.lm_defs(cfg)


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> lm.LM:
    """Random bf16 weights from the ParamDef tree
    (``params.init_params``)."""
    return lm.LM(cfg, init_params(model_defs(cfg), seed, torch.bfloat16,
                                  device))


def prefill_fn(model: lm.LM, batch: dict, cfg: ModelConfig, max_len: int):
    """batch: ``tokens`` [B, S] (and ``prefix_embeds``) on the model's
    device -> ``(last-position logits [B, V], cache)``."""
    return lm.prefill(model, batch["tokens"], cfg, max_len,
                      prefix_embeds=batch.get("prefix_embeds"))


def decode_fn(model: lm.LM, cache: dict, tokens, cfg: ModelConfig):
    """One decode step (the cache is updated in place, see
    ``lm.decode_step``) -> ``(logits [B, V], cache)``."""
    return lm.decode_step(model, cache, tokens, cfg)
