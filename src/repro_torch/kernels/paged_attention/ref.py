"""The plain version of the decode-attention kernel (port of
``repro.kernels.paged_attention.ref``): f32 math over the ring cache,
a slot valid when ``0 <= kv_pos <= q_pos`` (and inside the window).

``decode_split`` is a test helper: a plain split-and-combine emulation of
the CUDA kernel's bf16 path (split-KV on the tensor cores), so that the
CPU tests hold its numerics; the main path never calls it."""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "decode_attention_ref", "decode_ref", "decode_split"]

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


def decode_split(q, k_cache, v_cache, kv_pos, q_pos, *, window: int,
                 chunk: int):
    """``decode_ref``'s function as the kernel's bf16 path computes it
    (bf16 in, bf16 out): the ring cut into chunks of ``chunk`` slots; per
    chunk, scores as f32 sums of 16-wide k-steps of exact bf16 products,
    scaled by ``log2(e) / sqrt(hd)``, its own max ``m_s`` (every p = 1
    where all its slots are masked), ``p = exp2(s - m_s)``, ``l_s`` the
    f32 sum of p and ``acc_s = p_hi V + p_lo V`` (``p_hi = bf16(p)``,
    ``p_lo = bf16(p - p_hi)``); then ``sum_s e_s acc_s / max(sum_s e_s
    l_s, 1e-30)``, ``e_s = exp2(m_s - max m)``.  (The kernel walks a
    chunk in 64-slot tiles with an online softmax: the same sums in
    another order.)"""
    if q.dtype != torch.bfloat16:
        raise ValueError("decode_split emulates the bf16 path")
    B, H, hd = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    q4 = q.float().reshape(B, K, H // K, hd)
    k4 = k_cache.float().transpose(1, 2)[:, :, None]   # [B, K, 1, W, hd]
    v4 = v_cache.float().transpose(1, 2)[:, :, None]
    s = sum(q4[..., None, d:d + 16] @ k4[..., d:d + 16].transpose(-1, -2)
            for d in range(0, hd, 16))[..., 0, :]       # [B, K, G, W]
    s = s * (math.log2(math.e) / math.sqrt(hd))
    ok = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window:
        ok &= (q_pos[:, None] - kv_pos) < window
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    bf = lambda x: x.to(torch.bfloat16).float()
    parts = []
    for start in range(0, W, chunk):
        sc = s[..., start:start + chunk]
        m = sc.amax(-1, keepdim=True)
        p = torch.exp2(sc - m)
        p_hi = bf(p)
        vc = v4[..., start:start + chunk, :]
        parts.append((m, p.sum(-1, keepdim=True),
                      (p_hi[..., None, :] @ vc + bf(p - p_hi)[..., None, :]
                       @ vc)[..., 0, :]))
    m = torch.stack([pt[0] for pt in parts]).amax(0)
    e = [torch.exp2(pt[0] - m) for pt in parts]
    l = sum(ei * pt[1] for ei, pt in zip(e, parts))
    acc = sum(ei * pt[2] for ei, pt in zip(e, parts))
    out = acc / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype).reshape(B, H, hd)
