"""The plain version of the decode-attention kernel (port of
``repro.kernels.paged_attention.ref``): f32 math over the ring cache,
a slot valid when ``0 <= kv_pos <= q_pos`` (and inside the window)."""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "decode_attention_ref", "decode_ref"]

NEG_INF = -1e30


def decode_attention_ref(q4, k4, v4, kv_pos, q_pos, *, window: int):
    """q4: [B,K,G,hd]; k4/v4: [B,K,W,hd]; kv_pos: [B,W]; q_pos: [B]
    -> [B,K,G,hd]."""
    hd = q4.shape[-1]
    s = torch.einsum("bkgh,bkwh->bkgw", q4.float(), k4.float()) \
        / math.sqrt(hd)
    ok = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window:
        ok &= (q_pos[:, None] - kv_pos) < window
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bkwh->bkgh", w, v4.float())
    return out.to(q4.dtype)


def decode_ref(q, k_cache, v_cache, kv_pos, q_pos, *, window: int):
    """The same in the model's layout: q [B,H,hd] (rotated); caches
    [B,W,K,hd]; kv_pos int32 [B,W] (-1 marks an empty slot); q_pos
    int32 [B] -> [B,H,hd]."""
    B, H, hd = q.shape
    K = k_cache.shape[2]
    out = decode_attention_ref(q.reshape(B, K, H // K, hd),
                               k_cache.transpose(1, 2),
                               v_cache.transpose(1, 2), kv_pos, q_pos,
                               window=window)
    return out.reshape(B, H, hd)
