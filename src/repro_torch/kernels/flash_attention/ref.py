"""The plain version of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``): f32 math, the kernel's own iota
positions, the same masks and the same finite mask value."""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "attention_ref", "flash_attention_ref"]

NEG_INF = -1e30


def attention_ref(q5, k4, v4, *, causal: bool, window: int, kv_len=None):
    """q5: [B,K,G,S,hd]; k4/v4: [B,K,Skv,hd] -> [B,K,G,S,hd]; f32 math,
    output in q's dtype."""
    S, hd = q5.shape[3], q5.shape[4]
    Skv = k4.shape[2]
    dev = q5.device
    s = torch.einsum("bkgqh,bksh->bkgqs", q5.float(), k4.float()) \
        / math.sqrt(hd)
    q_pos = torch.arange(S, device=dev)[:, None]
    kv_pos = torch.arange(Skv, device=dev)[None, :]
    ok = torch.ones((S, Skv), dtype=torch.bool, device=dev)
    if kv_len is not None:
        ok &= kv_pos < kv_len
    if causal:
        ok &= q_pos >= kv_pos
    if window:
        ok &= (q_pos - kv_pos) < window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", w, v4.float())
    return out.to(q5.dtype)


def flash_attention_ref(q, k, v, *, causal: bool, window: int):
    """The same in the model's layout: q [B,S,H,hd]; k, v [B,Skv,K,hd]
    -> [B,S,H,hd], query head ``h = k * G + g`` under KV head ``k``."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    q5 = q.reshape(B, S, K, H // K, hd).permute(0, 2, 3, 1, 4)
    out = attention_ref(q5, k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
