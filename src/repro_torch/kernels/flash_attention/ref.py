"""The plain version of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``): f32 math, the kernel's own iota
positions, the same masks and the same finite mask value.

``flash_attention_bwd_ref`` is the plain version of the kernel's
backward entries: autograd of ``flash_attention_ref`` in f32.

``flash_attention_tiled`` is a test helper: a plain, tile-ordered
emulation of the CUDA kernel's bf16 (tensor-core) path, so that the CPU
tests hold its numerics; the main path never calls it."""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "BQ", "BKV", "attention_ref", "flash_attention_ref",
           "flash_attention_lse_ref", "flash_attention_bwd_ref",
           "flash_attention_tiled"]

NEG_INF = -1e30
#: query rows a block and keys a tile of the kernel's bf16 path
BQ, BKV = 64, 64


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


def flash_attention_lse_ref(q, k, v, *, causal: bool, window: int):
    """The log-sum-exp of each query row's scaled, masked scores, [B, H,
    S] f32 (natural log): what the forward kernel's LSE output holds."""
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    dev = q.device
    qf = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) / math.sqrt(hd)
    qp = torch.arange(S, device=dev)[:, None]
    kp = torch.arange(Skv, device=dev)[None, :]
    ok = torch.ones((S, Skv), dtype=torch.bool, device=dev)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= (qp - kp) < window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    return torch.logsumexp(s, -1).reshape(B, H, S)


def flash_attention_bwd_ref(q, k, v, do, *, causal: bool, window: int):
    """``(dq, dk, dv)`` f32: the gradients of ``flash_attention_ref``'s
    f32 output (before its cast) with respect to f32 copies of q, k, v,
    for the output gradient ``do`` [B, S, H, hd] (autograd in f32; GQA's
    sum over a group's heads included)."""
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        out = flash_attention_ref(qf, kf, vf, causal=causal, window=window)
        return torch.autograd.grad(out, (qf, kf, vf), do.float())


def flash_attention_tiled(q, k, v, *, causal: bool, window: int):
    """The kernel's bf16 path, tile by tile, in the model's layout (q
    [B,S,H,hd]; k, v [B,Skv,K,hd], bf16) -> [B,S,H,hd] bf16: per block of
    ``BQ`` query rows, the ``BKV``-key tiles the kernel visits (skipping
    those above the causal diagonal or before the window, zero keys past
    Skv, masked); scores as f32 sums of 16-wide k-steps of exact bf16
    products, scaled by ``log2(e) / sqrt(hd)``; the online softmax in f32
    with ``exp2``; ``P V`` as ``p_hi V + p_lo V``, ``p_hi = bf16(p)``,
    ``p_lo = bf16(p - p_hi)``, summed in f32."""
    if q.dtype != torch.bfloat16:
        raise ValueError("flash_attention_tiled emulates the bf16 path")
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    pad = -Skv % BKV
    qf = q.float().reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)
    # [B, K, 1, Skv + pad, hd]: broadcast over the group
    kf = torch.nn.functional.pad(k.float().transpose(1, 2),
                                 (0, 0, 0, pad))[:, :, None]
    vf = torch.nn.functional.pad(v.float().transpose(1, 2),
                                 (0, 0, 0, pad))[:, :, None]
    scale = math.log2(math.e) / math.sqrt(hd)
    bf = lambda x: x.to(torch.bfloat16).float()
    out = torch.empty_like(qf)
    for q0 in range(0, S, BQ):
        rows = torch.arange(q0, min(S, q0 + BQ))[:, None]
        qt = qf[..., q0:q0 + BQ, :]
        m = torch.full(qt.shape[:-1] + (1,), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        kv_end = min(Skv, q0 + BQ) if causal else Skv
        kv_start = (max(0, q0 - window + 1) // BKV) * BKV if window else 0
        for t0 in range(kv_start, kv_end, BKV):
            kt, vt = kf[..., t0:t0 + BKV, :], vf[..., t0:t0 + BKV, :]
            s = sum(qt[..., d:d + 16] @ kt[..., d:d + 16].transpose(-1, -2)
                    for d in range(0, hd, 16)) * scale
            keys = torch.arange(t0, t0 + BKV)[None, :]
            ok = keys < Skv
            if causal:
                ok = ok & (rows >= keys)
            if window:
                ok = ok & (rows - keys < window)
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            p_hi = bf(p)
            p_lo = bf(p - p_hi)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p_hi @ vt + p_lo @ vt
            m = m_new
        out[..., q0:q0 + BQ, :] = acc / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
