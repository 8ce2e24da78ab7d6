"""Encoder-decoder LM, whisper-small's backbone (port of
``repro.models.encdec``, serving half).

The audio frontend is a stub, as in ``repro``: the caller gives
precomputed frame embeddings ``[B, enc_seq, d_model]``.  The encoder is a
bidirectional transformer, the decoder adds cross-attention to the
encoder's output; LayerNorm, GeLU (``layers.gelu_tanh``) and absolute
sinusoidal positions (no RoPE: ``rope_theta`` is 0).  The model is the
``lm.LM`` container over ``encdec_defs``' tree (``enc_layers`` /
``dec_layers`` lists).

Attention routes.  Prefill runs every attention through the
flash-attention kernel: the encoder's self-attention without a mask, the
decoder's causal, the cross-attention without a mask over ``S != Skv``.
Decode runs both through the decode-attention kernel: self-attention
over the decoder's cache with ``q_pos = pos`` and the cache's slot
positions (a slot counts when ``0 <= kv_pos <= pos``), which is
``repro``'s blocked path; cross-attention over the cached encoder keys
and values, every slot counting.  ``repro``'s pallas decode masks by
``arange`` and ignores the positions (ROADMAP.md, Queue 3, fault 6); the
port follows the blocked path.

The decoder's self-cache holds ``max_len`` slots written at slot ``pos``
(not a ring; past ``max_len`` the write lands on the last slot, as
``dynamic_update_slice`` clamps it); decode writes it IN PLACE.
Training: ``loss_fn`` encodes the frames and runs ``decode_train`` (the
teacher-forced decoder: causal self-attention and cross-attention
through the flash kernel, whose backward entries run on the card), then
``lm.chunked_ce``; every encoder and decoder layer is recomputed in the
backward pass (``lm.remat_layer``), as ``repro`` checkpoints both scans.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import sharding as shd
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, resolve_device

__all__ = ["encdec_defs", "encode", "decode_train", "loss_fn", "init_cache",
           "prefill", "decode_step"]


def _sinusoid(S: int, d: int, dtype, device) -> torch.Tensor:
    """[S, d]: ``sin`` then ``cos`` of ``pos / 10000^(2 i / d)``, f32
    before the cast (``jnp.power``, ``sin`` and ``cos`` in f32)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _sinusoid_at(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """[d]: the sinusoid of the int scalar tensor ``pos``."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float() / torch.pow(torch.tensor(10000.0, device=pos.device),
                                  2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def encdec_defs(cfg: ModelConfig):
    d, v = cfg.d_model, cfg.vocab_padded
    enc_layer = {"norm1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
                 "norm2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}
    dec_layer = {"norm1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
                 "normx": L.norm_defs(cfg), "xattn": L.attention_defs(cfg),
                 "norm2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}
    return {
        "embed": ParamDef((v, d), ("vocab", "embed")),
        "enc_layers": [enc_layer] * cfg.n_enc_layers,
        "enc_norm": L.norm_defs(cfg),
        "dec_layers": [dec_layer] * cfg.n_layers,
        "final_norm": L.norm_defs(cfg),
        "head": ParamDef((d, v), ("embed", "vocab")),
    }


def _mlp_block(lp, x, cfg: ModelConfig):
    return x + L.mlp_apply(lp["mlp"], L.norm_apply(lp["norm2"], x, cfg), cfg)


def encode(model: lm.LM, frames, cfg: ModelConfig,
           remat: bool = False) -> torch.Tensor:
    """frames: [B, F, d] stub embeddings -> encoder states [B, F, d].
    ``remat``: each layer recomputed in the backward pass."""
    x = frames.to(torch.bfloat16)
    x = x + _sinusoid(x.shape[1], x.shape[2], x.dtype, x.device)[None]
    x = shd.shard(x, "batch", "seq", None)
    for lp in model.enc_layers:
        def body(x, lp=lp):
            y, _ = L.attention_apply(lp["attn"], L.norm_apply(
                lp["norm1"], x, cfg), cfg, causal=False)
            return _mlp_block(lp, x + y, cfg)
        x = lm.remat_layer(body, x) if remat else body(x)
    return L.norm_apply(model.enc_norm, x, cfg)


def decode_train(model: lm.LM, enc_out, tokens, cfg: ModelConfig,
                 remat: bool = True) -> torch.Tensor:
    """Teacher-forced decoder forward over ``tokens`` [B, S] against the
    encoder states ``enc_out`` [B, F, d]: hidden states [B, S, d] after
    the final norm.  ``remat``: each layer recomputed in the backward
    pass."""
    x = lm.lookup(model, tokens)
    x = x + _sinusoid(x.shape[1], x.shape[2], x.dtype, x.device)[None]
    x = shd.shard(x, "batch", "seq", None)
    for lp in model.dec_layers:
        def body(x, lp=lp):
            y, _ = L.attention_apply(lp["attn"], L.norm_apply(
                lp["norm1"], x, cfg), cfg, causal=True)
            x = x + y
            y, _ = L.attention_apply(lp["xattn"], L.norm_apply(
                lp["normx"], x, cfg), cfg, causal=False, cross_x=enc_out)
            return _mlp_block(lp, x + y, cfg)
        x = lm.remat_layer(body, x) if remat else body(x)
    return L.norm_apply(model.final_norm, x, cfg)


def loss_fn(model: lm.LM, batch: dict, cfg: ModelConfig,
            remat: bool = True):
    """batch: ``frames`` [B, F, d], ``tokens`` [B, S], ``targets`` [B, S]
    -> ``(loss, {"nll", "aux"})``, aux 0."""
    enc = encode(model, batch["frames"], cfg, remat=remat)
    x = decode_train(model, enc, batch["tokens"], cfg, remat=remat)
    mask = torch.ones_like(batch["targets"], dtype=torch.float32)
    loss = lm.chunked_ce(model, x, batch["targets"], mask, cfg)
    return loss, {"nll": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=x.device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """A zero decode cache on ``device`` (CUDA unless named): the decoder's
    self-attention ``k`` / ``v`` [nl, B, max_len, K, hd] bf16 and
    ``kv_pos`` [nl, max_len] (-1 = empty), the cross-attention keys and
    values ``xk`` / ``xv`` [nl, B, enc_seq, K, hd] bf16 and ``pos``; on
    the meta device under a mesh DTensors (``lm.cache_leaf``)."""
    leaf = lm.cache_leaf(resolve_device(device))
    nl, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    kv = lambda name, n: leaf((name,), (nl, batch, n, K, hd),
                              torch.bfloat16, 0)
    return {"k": kv("k", max_len), "v": kv("v", max_len),
            "kv_pos": leaf(("kv_pos",), (nl, max_len), torch.int32, -1),
            "xk": kv("xk", cfg.enc_seq), "xv": kv("xv", cfg.enc_seq),
            "pos": leaf(("pos",), (), torch.int32, 0)}


def prefill(model: lm.LM, frames, tokens, cfg: ModelConfig, max_len: int):
    """Encode the frames and teacher-force the prompt tokens (``S <=
    max_len``); build the decode cache: per layer the prompt's keys and
    values in slots ``0 .. S-1`` and the encoder's cross keys and
    values.  Returns ``(logits of the last position [B, V], cache)``."""
    enc = encode(model, frames, cfg)
    B, S = tokens.shape
    dev = enc.device
    if S > max_len:
        raise ValueError(f"{cfg.name}: a prompt of {S} tokens does not fit "
                         f"a cache of max_len {max_len}")
    cache: dict[str, Any] = init_cache(cfg, B, max_len, device=dev)
    xks, xvs = [], []
    x = lm.lookup(model, tokens)
    x = x + _sinusoid(S, cfg.d_model, x.dtype, dev)[None]
    for i, lp in enumerate(model.dec_layers):
        y, (k, v) = L.attention_apply(
            lp["attn"], L.norm_apply(lp["norm1"], x, cfg), cfg, causal=True)
        x = x + y
        y, (xk, xv) = L.attention_apply(
            lp["xattn"], L.norm_apply(lp["normx"], x, cfg), cfg,
            causal=False, cross_x=enc)
        x = _mlp_block(lp, x + y, cfg)
        cache["k"][i][:, :S] = k
        cache["v"][i][:, :S] = v
        xks.append(xk)
        xvs.append(xv)
    cache["kv_pos"][:, :S] = torch.arange(S, dtype=torch.int32, device=dev)
    cache["xk"], cache["xv"] = torch.stack(xks), torch.stack(xvs)
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device=dev)
    x = L.norm_apply(model.final_norm, x, cfg)
    return lm.logits_fn(model, x[:, -1:], cfg)[:, 0], cache


def decode_step(model: lm.LM, cache: dict, tokens, cfg: ModelConfig):
    """One decoder token against the self-cache and the cross keys and
    values.  tokens: [B] int.  Writes each layer's key, value and slot
    position at slot ``min(pos, max_len - 1)`` IN PLACE; returns
    ``(logits [B, V], new cache)``, the dict sharing those tensors with a
    new ``pos``."""
    B = tokens.shape[0]
    pos = cache["pos"]
    W, F_ = cache["k"].shape[2], cache["xk"].shape[2]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = lm.lookup(model, tokens)[:, None]
    x = x + _sinusoid_at(pos, cfg.d_model, x.dtype)
    slot = torch.clamp(pos, max=W - 1).reshape(1).long()
    # cross-attention: every cached frame counts (0 <= kv_pos <= q_pos)
    epos = torch.arange(F_, dtype=torch.int32, device=x.device)
    q_all = torch.full((1,), F_, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(model.dec_layers):
        p = lp["attn"]
        h = L.norm_apply(lp["norm1"], x, cfg)
        ck, cv, cpos = cache["k"][i], cache["v"][i], cache["kv_pos"][i]
        shd.index_copy_(ck, 1, slot, shd.split_last(
            h @ p["wk"].to(h.dtype), (B, 1, K, hd), "batch", None,
            "kv_heads", None))
        shd.index_copy_(cv, 1, slot, shd.split_last(
            h @ p["wv"].to(h.dtype), (B, 1, K, hd), "batch", None,
            "kv_heads", None))
        shd.index_copy_(cpos, 0, slot, pos.reshape(1))
        q = shd.split_last(h @ p["wq"].to(h.dtype), (B, 1, H, hd), "batch",
                           None, "heads", None)
        out = pa_ops.decode_attention(q, ck, cv, q_pos=pos.reshape(1),
                                      kv_pos=cpos, window=0, rope_theta=0.0)
        x = x + shd.merge_last(out, "batch", None, "heads", None) @ p[
            "wo"].to(h.dtype)
        p = lp["xattn"]
        h = L.norm_apply(lp["normx"], x, cfg)
        q = shd.split_last(h @ p["wq"].to(h.dtype), (B, 1, H, hd), "batch",
                           None, "heads", None)
        out = pa_ops.decode_attention(q, cache["xk"][i], cache["xv"][i],
                                      q_pos=q_all, kv_pos=epos, window=0,
                                      rope_theta=0.0)
        x = x + shd.merge_last(out, "batch", None, "heads", None) @ p[
            "wo"].to(h.dtype)
        x = _mlp_block(lp, x, cfg)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    x = L.norm_apply(model.final_norm, x, cfg)
    return lm.logits_fn(model, x, cfg)[:, 0], new_cache
