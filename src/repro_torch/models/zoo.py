"""Model zoo: family dispatch and input specs (port of
``repro.models.zoo``).

``init_model`` builds a model from its ParamDef tree on a device (CUDA
unless the caller names another; no fallback to the CPU);
``prefill_fn`` / ``decode_fn`` are the serving entry points of every
family, on the device the model lives on (the encdec family through
``models/encdec.py``, the others through ``models/lm.py``);
``init_cache`` is the matching zero cache.  ``batch_specs`` gives a
shape cell's model inputs as meta-device tensors (no memory) and
``make_batch`` draws them.  ``abstract_model`` and ``cache_specs`` are
the dry run's model and decode cache (``launch/dryrun.py``).  Under a
mesh the three give DTensors over meta shards, placed by their logical
axes (``params.abstract_tensor``).  ``loss_fn`` is the training loss of
every family.
"""

from __future__ import annotations

import torch

from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.params import (abstract_params, abstract_tensor,
                                      init_params, resolve_device)

__all__ = ["model_defs", "init_model", "abstract_model", "init_cache",
           "cache_specs", "loss_fn", "prefill_fn", "decode_fn",
           "batch_specs", "make_batch"]


def model_defs(cfg: ModelConfig):
    if cfg.family == "encdec":
        return encdec.encdec_defs(cfg)
    return lm.lm_defs(cfg)


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> lm.LM:
    """Random bf16 weights from the ParamDef tree
    (``params.init_params``)."""
    return lm.LM(cfg, init_params(model_defs(cfg), seed, torch.bfloat16,
                                  device))


def abstract_model(cfg: ModelConfig, dtype=torch.bfloat16) -> lm.LM:
    """The model over ``params.abstract_params`` (meta tensors, or
    DTensors over meta shards under a mesh): the dry run's model, never
    allocated."""
    return lm.LM(cfg, abstract_params(model_defs(cfg), dtype))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """The zero decode cache of ``cfg``'s family (``lm.init_cache`` /
    ``encdec.init_cache``) on ``device`` (CUDA unless named)."""
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, device)
    return lm.init_cache(cfg, batch, max_len, device)


def loss_fn(model: lm.LM, batch: dict, cfg: ModelConfig,
            remat: bool = True):
    """The training loss of ``cfg``'s family (``encdec.loss_fn`` /
    ``lm.loss_fn``) -> ``(loss, {"nll", "aux"})``; ``remat``: layers
    recomputed in the backward pass (``repro``'s default)."""
    if cfg.family == "encdec":
        return encdec.loss_fn(model, batch, cfg, remat)
    return lm.loss_fn(model, batch, cfg, remat)


def prefill_fn(model: lm.LM, batch: dict, cfg: ModelConfig, max_len: int):
    """batch: ``tokens`` [B, S] (and ``prefix_embeds`` [B, P, d], or
    ``frames`` [B, F, d] for encdec) on the model's device -> ``(last-
    position logits [B, V], cache)``."""
    if cfg.family == "encdec":
        return encdec.prefill(model, batch["frames"], batch["tokens"], cfg,
                              max_len)
    return lm.prefill(model, batch["tokens"], cfg, max_len,
                      prefix_embeds=batch.get("prefix_embeds"))


def decode_fn(model: lm.LM, cache: dict, tokens, cfg: ModelConfig):
    """One decode step (the cache is updated in place, see
    ``lm.decode_step``) -> ``(logits [B, V], cache)``."""
    if cfg.family == "encdec":
        return encdec.decode_step(model, cache, tokens, cfg)
    return lm.decode_step(model, cache, tokens, cfg)


# ------------------------------------------------------------- input specs

def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The decode cache of one shape cell on the meta device
    (``init_cache`` at its batch and ``seq_len``): ``repro``'s
    ``cache_specs`` (its keys, shapes and dtypes; the encdec cache's
    ``k`` / ``v`` / ``kv_pos`` hold ``seq_len`` slots and ``xk`` / ``xv``
    ``enc_seq``), under a mesh DTensors placed by ``lm.CACHE_AXES``
    (``repro``'s ``_CACHE_AXES``, ``lm.cache_leaf``)."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, "meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The model-input batch of one shape cell as meta-device tensors
    (``repro``'s ``batch_specs``: its shapes, dtypes and logical axes;
    under a mesh DTensors over meta shards, ``params.abstract_tensor``):
    int32 tokens (and targets for training), bf16 ``frames`` [B,
    enc_seq, d] (encdec) or ``prefix_embeds`` [B, n_patches, d] (vision,
    whose patches count against ``seq_len``); decode: one token a row."""
    B, S = shape.global_batch, shape.seq_len
    bf16, i32 = torch.bfloat16, torch.int32
    tok, emb = ("batch", "seq"), ("batch", "seq", None)
    if shape.kind == "decode":
        return {"tokens": abstract_tensor((B,), i32, ("batch",))}
    out = {}
    if cfg.family == "encdec":
        out["frames"] = abstract_tensor((B, cfg.enc_seq, cfg.d_model), bf16,
                                        emb)
    n_text = S
    if cfg.frontend == "vision":
        out["prefix_embeds"] = abstract_tensor((B, cfg.n_patches,
                                                cfg.d_model), bf16, emb)
        n_text = S - cfg.n_patches
    if shape.kind == "train":
        if cfg.family == "encdec":
            n_text = S
        out["tokens"] = abstract_tensor((B, n_text), i32, tok)
        out["targets"] = abstract_tensor((B, n_text), i32, tok)
    else:
        out["tokens"] = abstract_tensor((B, n_text), i32, tok)
    return out


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               device=None) -> dict:
    """A random batch matching ``batch_specs`` on ``device`` (CUDA
    unless named): token ids uniform in ``[0, min(vocab, 1000))``, float
    inputs standard normal cast to their dtype, drawn from one
    ``torch.Generator`` seeded with ``seed`` in the specs' order (other
    numbers than ``repro``'s ``jax.random`` draw)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, s in batch_specs(cfg, shape).items():
        if s.dtype == torch.int32:
            out[name] = torch.randint(0, min(cfg.vocab_size, 1000),
                                      tuple(s.shape), generator=gen,
                                      dtype=torch.int32, device=device)
        else:
            out[name] = torch.randn(tuple(s.shape), generator=gen,
                                    dtype=torch.float32,
                                    device=device).to(s.dtype)
    return out
