"""The plain version of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``): f32 math, the kernel's own iota
positions, the same masks and the same finite mask value.

``flash_attention_bwd_ref`` is the plain version of the kernel's
backward entries: autograd of ``flash_attention_ref`` in f32.

``flash_attention_tiled`` and ``flash_attention_bwd_tiled`` are test
helpers: plain, tile-ordered emulations of the CUDA kernels' bf16
(tensor-core) forward and backward, so that the CPU tests hold their
numerics; the main path never calls them."""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "BQ", "SMS", "BWD_ROWS", "attention_ref",
           "flash_attention_ref", "flash_attention_lse_ref",
           "flash_attention_bwd_ref", "kv_chunks", "visited_tiles",
           "flash_attention_tiled", "flash_attention_bwd_tiled"]

NEG_INF = -1e30
#: query rows a block of the kernel's bf16 forward (two warpgroups of 64)
BQ = 128
#: SMs of the card (H100 SXM): the kernel's tile choice reads the card's
#: own count
SMS = 132
#: rows of the backward entries' walked tiles (a block's fixed rows are
#: two such halves)
BWD_ROWS = 64


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


def kv_chunks(hd: int, Skv: int, blocks: int) -> int:
    """64-key chunks a key tile of the kernel's bf16 forward holds
    (``flash_attention.cu::fwd_chunks`` on ``SMS`` SMs): 1 above head dim
    128, 2 above 64; at head dim 64, 1 where ``Skv`` fits one chunk or the
    grid's ``blocks`` outnumber the SMs, else 2."""
    if hd > 128:
        return 1
    if hd > 64:
        return 2
    return 1 if Skv <= 64 or blocks > SMS else 2


def visited_tiles(B: int, S: int, Skv: int, H: int, hd: int, *,
                  causal: bool, window: int):
    """``(bkv, [(q0, [t0, ...]), ...])``: the key tiles of ``bkv`` keys
    that the kernel's block of query rows ``q0 .. q0 + BQ - 1`` visits,
    from the window's first key rounded down to a tile to the causal end
    (the tiles every row of the block masks are skipped)."""
    bkv = 64 * kv_chunks(hd, Skv, -(-S // BQ) * B * H)
    walk = []
    for q0 in range(0, S, BQ):
        kv_end = min(Skv, q0 + BQ) if causal else Skv
        kv_start = max(0, q0 - window + 1) // bkv * bkv if window else 0
        walk.append((q0, list(range(kv_start, kv_end, bkv))))
    return bkv, walk


def flash_attention_tiled(q, k, v, *, causal: bool, window: int):
    """The kernel's bf16 forward, tile by tile, in the model's layout (q
    [B,S,H,hd]; k, v [B,Skv,K,hd], bf16) -> [B,S,H,hd] bf16: per block of
    ``BQ`` query rows, the tiles of ``visited_tiles`` (zero keys past
    Skv, masked), each a chunk of 64 keys at a time: scores as f32 sums of
    16-wide k-steps of exact bf16 products, scaled by ``log2(e) /
    sqrt(hd)``; the online softmax in f32 with ``exp2``; ``P V`` as
    ``p_hi V + p_lo V``, ``p_hi = bf16(p)``, ``p_lo = bf16(p - p_hi)``,
    summed in f32."""
    if q.dtype != torch.bfloat16:
        raise ValueError("flash_attention_tiled emulates the bf16 path")
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    bkv, walk = visited_tiles(B, S, Skv, H, hd, causal=causal,
                              window=window)
    pad = -Skv % bkv
    qf = q.float().reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)
    # [B, K, 1, Skv + pad, hd]: broadcast over the group
    kf = torch.nn.functional.pad(k.float().transpose(1, 2),
                                 (0, 0, 0, pad))[:, :, None]
    vf = torch.nn.functional.pad(v.float().transpose(1, 2),
                                 (0, 0, 0, pad))[:, :, None]
    scale = math.log2(math.e) / math.sqrt(hd)
    bf = lambda x: x.to(torch.bfloat16).float()
    out = torch.empty_like(qf)
    for q0, tiles in walk:
        rows = torch.arange(q0, min(S, q0 + BQ))[:, None]
        qt = qf[..., q0:q0 + BQ, :]
        m = torch.full(qt.shape[:-1] + (1,), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for t0 in (c for t in tiles for c in range(t, t + bkv, 64)):
            kt, vt = kf[..., t0:t0 + 64, :], vf[..., t0:t0 + 64, :]
            s = sum(qt[..., d:d + 16] @ kt[..., d:d + 16].transpose(-1, -2)
                    for d in range(0, hd, 16)) * scale
            keys = torch.arange(t0, t0 + 64)[None, :]
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


def flash_attention_bwd_tiled(q, k, v, do, *, causal: bool, window: int,
                              split_dq: bool = True):
    """The backward entries' bf16 path, tile by tile, in the model's layout
    (q, do [B,S,H,hd]; k, v [B,Skv,K,hd], bf16) -> ``(dq, dk, dv)`` bf16:
    LSE and D from the plain forward in f32 (the kernels take D from the
    LSE forward's f32 output, O + O_lo); S and dP as f32 sums of 16-wide
    k-steps of exact bf16 products; P = exp2(S log2(e) / sqrt(hd) - LSE
    log2(e)), 0 where masked; dS = P (dP - D); P and dS rounded to bf16 as
    the A operands of dV += P^T dO and dK += dS^T Q, and dS as hi + lo =
    bf16(dS) + bf16(dS - bf16(dS)) in dQ += dS K, both products summed
    (``split_dq`` False: bf16 dS alone there, the unsplit baseline).  dK and
    dV are summed in f32 per query head over the ``BWD_ROWS``-row query
    tiles in order, then over a group's heads in head order 0 .. G - 1,
    dK scaled by 1/sqrt(hd), each rounded once to bf16; dQ in f32 over the
    ``BWD_ROWS``-key tiles in order, scaled, rounded.  The kernels walk
    only the tiles a mask leaves some pair in; every other tile adds
    exact zeros here."""
    if q.dtype != torch.bfloat16:
        raise ValueError("flash_attention_bwd_tiled emulates the bf16 path")
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    T = BWD_ROWS
    Sp, Skp = -(-S // T) * T, -(-Skv // T) * T
    bf = lambda x: x.to(torch.bfloat16).float()
    # [B, H, rows, hd], zero rows past S / Skv, KV heads repeated per group
    heads = lambda x, n, rep: torch.nn.functional.pad(
        x.float().transpose(1, 2).repeat_interleave(rep, 1),
        (0, 0, 0, n - x.shape[1]))
    qf, dof = heads(q, Sp, 1), heads(do, Sp, 1)
    kf, vf = heads(k, Skp, G), heads(v, Skp, G)
    lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    o = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                            window=window)
    dlt = (do.float() * o).sum(-1).transpose(1, 2)  # [B, H, S]
    pad_rows = lambda x: torch.nn.functional.pad(x, (0, Sp - S))[..., None]
    lse, dlt = pad_rows(lse), pad_rows(dlt)

    def steps(a, b):  # a b^T as f32 sums of 16-wide k-steps
        return sum(a[..., d:d + 16] @ b[..., d:d + 16].transpose(-1, -2)
                   for d in range(0, hd, 16))
    rows = torch.arange(Sp)[:, None]
    keys = torch.arange(Skp)[None, :]
    ok = (rows < S) & (keys < Skv)
    if causal:
        ok = ok & (rows >= keys)
    if window:
        ok = ok & (rows - keys < window)
    sc = steps(qf, kf) * (math.log2(math.e) / math.sqrt(hd))
    p = torch.where(ok, torch.exp2(sc - lse * math.log2(math.e)),
                    torch.zeros(()))
    ds = torch.where(ok, p * (steps(dof, vf) - dlt), torch.zeros(()))
    p_b, ds_hi = bf(p), bf(ds)
    ds_lo = bf(ds - ds_hi)

    dv = torch.zeros(B, H, Skp, hd)
    dk = torch.zeros_like(dv)
    for q0 in range(0, Sp, T):  # the dK / dV entry's query tiles
        t = slice(q0, q0 + T)
        dv = dv + p_b[..., t, :].transpose(-1, -2) @ dof[..., t, :]
        dk = dk + ds_hi[..., t, :].transpose(-1, -2) @ qf[..., t, :]
    dq = torch.zeros(B, H, Sp, hd)
    for t0 in range(0, Skp, T):  # the dQ entry's key tiles
        t = slice(t0, t0 + T)
        dq = dq + ds_hi[..., t] @ kf[..., t, :]
        if split_dq:
            dq = dq + ds_lo[..., t] @ kf[..., t, :]

    def group_sum(x):  # [B, H, Skp, hd] -> [B, K, Skp, hd], head order
        x = x.view(B, K, G, Skp, hd)
        acc = x[:, :, 0]
        for g in range(1, G):
            acc = acc + x[:, :, g]
        return acc
    scale = 1.0 / math.sqrt(hd)
    out = lambda x, n: bf(x[:, :, :n]).transpose(1, 2).to(torch.bfloat16)
    return (out(dq * scale, S), out(group_sum(dk) * scale, Skv),
            out(group_sum(dv), Skv))
