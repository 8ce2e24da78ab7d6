"""Common transformer layers: norms, RoPE, GQA attention, MLP, MoE (port
of ``repro.models.layers``).

Pure-function style: ``*_defs(cfg)`` returns the ParamDef tree of a
layer, ``*_apply(p, x, ...)`` runs it on ``p``, a mapping of tensors (a
dict, or the ``nn.ModuleDict`` / ``nn.ParameterDict`` of a model).
Attention goes through the flash-attention kernel's dispatch
(``repro_torch.kernels.flash_attention.ops``): the CUDA kernel on the
card, its plain version on the CPU, the counterpart of ``repro``'s
``attn_impl="pallas"``.  ``naive_attention`` is the reference for
arbitrary positions.  ``blocked_attention`` (online softmax over q and
kv blocks) and ``split_kv_decode_attention`` (flash-decoding: a partial
softmax a cache split, then a log-sum-exp combine) are ``repro``'s XLA
strategies as plain PyTorch; on the card the flash and decode kernels
stand in for them, and ``attention_apply`` and the decode path keep
their kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

__all__ = ["NEG_INF", "norm_defs", "norm_apply", "rope", "attention_defs",
           "naive_attention", "blocked_attention",
           "split_kv_decode_attention", "attention_apply", "sigmoid", "silu", "gelu_tanh",
           "column_halves", "mlp_defs", "mlp_apply", "moe_defs",
           "top_k_first", "moe_capacity",
           "moe_route", "moe_apply"]

NEG_INF = -1e30


# --------------------------------------------------------------------- norms

def norm_defs(cfg: ModelConfig):
    if cfg.norm_kind == "layer":
        return {"scale": ParamDef((cfg.d_model,), ("embed",), "ones"),
                "bias": ParamDef((cfg.d_model,), ("embed",), "zeros")}
    return {"scale": ParamDef((cfg.d_model,), ("embed",), "ones")}


def norm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Norms keep the activations' dtype; only the statistics are f32.
    The RMS norm casts ``rsqrt`` to the activations' dtype before both
    multiplies, as ``repro`` does."""
    if cfg.norm_kind == "layer":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
        return y.to(x.dtype)
    ms = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(ms + cfg.norm_eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


# ---------------------------------------------------------------------- RoPE

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable).  The
    half-split layout (not interleaved), f32 angles, output in x's dtype.
    ``theta == 0`` disables RoPE (absolute-position archs)."""
    if not theta:
        return x
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., :, None].float() * freqs          # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def attention_defs(cfg: ModelConfig):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, H * hd), ("embed", "hidden")),
        "wk": ParamDef((d, K * hd), ("embed", "kv_hidden")),
        "wv": ParamDef((d, K * hd), ("embed", "kv_hidden")),
        "wo": ParamDef((H * hd, d), ("hidden", "embed")),
    }


def _mask_bias(q_pos, kv_pos, causal: bool, window: int, kv_valid=None):
    """[Sq, Skv] additive mask (0 or NEG_INF), f32."""
    ok = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= kv_pos[None, :]
    if window:
        ok &= (q_pos[:, None] - kv_pos[None, :]) < window
    if kv_valid is not None:
        ok &= kv_valid[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def naive_attention(q, k, v, q_pos, kv_pos, causal, window, kv_valid=None):
    """q: [B,Sq,H,hd]; k,v: [B,Skv,K,hd].  Reference path (any
    positions)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) \
        / math.sqrt(hd)
    scores = scores + _mask_bias(q_pos, kv_pos, causal, window, kv_valid)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def blocked_attention(q, k, v, q_pos, kv_pos, causal, window,
                      kv_valid=None, block_kv: int = 1024,
                      block_q: int = 1024):
    """Online-softmax attention tiled over q and kv blocks (``repro``'s
    default XLA path): O(block_q * block_kv) scores at a time.  Padded
    query and key positions are ``2**30`` and padded keys invalid; with
    ``Skv <= block_kv`` it is ``naive_attention``."""
    B, Sq, H, hd = q.shape
    if Sq > block_q:
        nq = -(-Sq // block_q)
        pad = nq * block_q - Sq
        if pad:
            q = F.pad(q, (0, 0, 0, 0, 0, pad))
            q_pos = F.pad(q_pos, (0, pad), value=2**30)
        out = torch.cat([
            blocked_attention(q[:, i * block_q:(i + 1) * block_q], k, v,
                              q_pos[i * block_q:(i + 1) * block_q], kv_pos,
                              causal, window, kv_valid, block_kv=block_kv,
                              block_q=block_q)
            for i in range(nq)], dim=1)
        return out[:, :Sq]
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    if Skv <= block_kv:
        return naive_attention(q, k, v, q_pos, kv_pos, causal, window,
                               kv_valid)
    nblk = -(-Skv // block_kv)
    pad = nblk * block_kv - Skv
    if kv_valid is None:
        kv_valid = torch.ones((Skv,), dtype=torch.bool, device=k.device)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=2**30)
        kv_valid = F.pad(kv_valid, (0, pad), value=False)
    qg = q.reshape(B, Sq, K, G, hd).float()
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(nblk):
        blk = slice(j * block_kv, (j + 1) * block_kv)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, k[:, blk].float())
        s = s * scale + _mask_bias(q_pos, kv_pos[blk], causal, window,
                                   kv_valid[blk])
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p, v[:, blk].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def split_kv_decode_attention(q, ck, cv, cpos, q_pos, window,
                              n_splits: int):
    """Flash-decoding: a partial softmax a KV-cache split, then a
    log-sum-exp combine (``repro``'s split-KV decode).  q: [B, 1, H, hd]
    (rotated); ck / cv: [B, W, K, hd]; cpos: [W] (a slot is valid when
    ``0 <= cpos <= q_pos[0]`` and inside the window).  ``W`` not a
    multiple of ``n_splits`` runs as one split."""
    B, W, K, hd = ck.shape
    H = q.shape[2]
    G = H // K
    ns = n_splits if W % n_splits == 0 else 1
    qg = q.reshape(B, K, G, hd).float()
    cks = ck.reshape(B, ns, W // ns, K, hd)
    cvs = cv.reshape(B, ns, W // ns, K, hd)
    ps = cpos.reshape(ns, W // ns)
    s = torch.einsum("bkgh,bnwkh->bnkgw", qg, cks.float()) / math.sqrt(hd)
    ok = (ps >= 0) & (ps <= q_pos[0])
    if window:
        ok &= (q_pos[0] - ps) < window
    s = torch.where(ok[None, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    m = s.amax(-1)                                       # [B, ns, K, G]
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bnkgw,bnwkh->bnkgh", p, cvs.float())
    M = m.amax(1, keepdim=True)
    w = torch.exp(m - M)
    y = (acc * w[..., None]).sum(1) / torch.clamp(
        (l * w).sum(1), min=1e-30)[..., None]
    return y.reshape(B, 1, H, hd).to(q.dtype)


def attention_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
                    causal: bool = True, window: int = 0, cross_x=None):
    """Attention sub-layer: projections + RoPE + the flash-attention
    kernel + output projection.  Self-attention over positions
    ``arange(S)``; with ``cross_x`` [B, Skv, d] (encoder states) the keys
    and values come from it, nothing is rotated and no mask may be asked
    for.  Returns ``(out, (k, v))``, ``k`` / ``v`` this call's projected
    (and rotated) keys and values for the cache."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    # the split products' input: its gradient's partial sums meet here
    x = shd.shard(x, "batch", "seq", None)
    src = x if cross_x is None else shd.shard(cross_x, "batch", "seq", None)
    q = shd.split_last(x @ p["wq"].to(x.dtype), (B, -1, H, hd),
                       "batch", None, "heads", None)
    k = shd.split_last(src @ p["wk"].to(x.dtype), (B, -1, K, hd),
                       "batch", None, "kv_heads", None)
    v = shd.split_last(src @ p["wv"].to(x.dtype), (B, -1, K, hd),
                       "batch", None, "kv_heads", None)
    if cross_x is None:
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        k = rope(k, pos[None], cfg.rope_theta)
        q = rope(q, pos[None], cfg.rope_theta)
    q = shd.shard(q, "batch", None, "heads", None)
    k = shd.shard(k, "batch", None, "kv_heads", None)
    v = shd.shard(v, "batch", None, "kv_heads", None)
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    y = shd.merge_last(out, "batch", None, "heads", None) @ p["wo"].to(
        x.dtype)
    # the row-split product's partial sums meet here (a no-op off a mesh)
    return shd.shard(y, "batch", "seq", None), (k, v)


# ----------------------------------------------------------------------- MLP

# ``jax.nn``'s activations are composites that XLA rounds op by op; a
# fused ``F.silu`` / ``F.gelu`` rounds once and differs by an ulp in ~40 %
# of bf16 values.  These compose them as ``jax.nn`` does, each op rounded
# in x's dtype (its Python constants are weakly typed: x's dtype too).

class _Sigmoid(torch.autograd.Function):
    """``1 / (1 + exp(-x))`` op by op, differentiated as ``lax.logistic``
    is: ``g (y (1 - y))``, each op rounded in x's dtype.  Autograd of the
    ops themselves would give ``0 * inf = NaN`` where ``exp(-x)``
    overflows (bf16 x <= -89), where JAX gives 0."""

    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``1 / (1 + exp(-x))``, its gradient ``g y (1 -
    y)``."""
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * (1 / (1 + exp(-x)))``."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: ``x * 0.5 * (1 + tanh(
    sqrt(2 / pi) * (x + 0.044715 * x**3)))``, ``x**3`` as ``x * (x * x)``
    (``lax.integer_pow``)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


def mlp_defs(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":  # SwiGLU
        return {"wi": ParamDef((d, 2 * f), ("embed", "hidden")),
                "wo": ParamDef((f, d), ("hidden", "embed"))}
    return {"wi": ParamDef((d, f), ("embed", "hidden")),
            "wo": ParamDef((f, d), ("hidden", "embed"))}


def column_halves(x, wi):
    """``(x @ wi).chunk(2, -1)`` (SwiGLU's gate and up halves, the mamba
    block's ``u`` and ``z``).  Under a mesh, ``wi``'s split hidden dim
    would hold the two halves on different ranks: each half is then its
    own product, its weight laid out as ``hidden`` again."""
    if not shd.is_dtensor(wi):
        return (x @ wi).chunk(2, dim=-1)
    f = wi.shape[1] // 2
    return tuple(x @ shd.shard(w, "embed", "hidden")
                 for w in (wi[:, :f], wi[:, f:]))


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = shd.shard(x, "batch", "seq", None)
    if cfg.act == "silu":
        g, u = column_halves(x, p["wi"].to(x.dtype))
        h = silu(g) * u
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = gelu_tanh(x @ p["wi"].to(x.dtype))
    h = shd.shard(h, "batch", None, "hidden")
    return shd.shard(h @ p["wo"].to(x.dtype), "batch", None, None)


# ----------------------------------------------------------------------- MoE

def moe_defs(cfg: ModelConfig):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, E), ("embed", None)),
        "wi": ParamDef((E, d, 2 * f), ("experts", "embed", "expert_hidden")),
        "wo": ParamDef((E, f, d), ("experts", "expert_hidden", "embed")),
    }


def top_k_first(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries along the last
    dim, ties to the lower index (``jax.lax.top_k``'s order; ``torch.topk``
    promises none): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: ModelConfig, S: int) -> int:
    """Slots an expert has in a row of ``S`` tokens: ``capacity_factor *
    k * S / E`` rounded, at least 8 and a multiple of 8."""
    cap = int(cfg.capacity_factor * cfg.top_k * S / cfg.n_experts + 0.5)
    return max(8, -(-cap // 8) * 8)


def moe_route(p, x: torch.Tensor, cfg: ModelConfig):
    """The router of ``moe_apply``: ``(probs [B, S, E] f32, gate [B, S,
    k] f32, eidx [B, S, k] int64, pos [B, S, k] int64)``, ``pos`` the
    slot's place in its expert's queue of the row (a cumsum over the
    row's ``S * k`` slots in token order)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, -1)
    gate, eidx = top_k_first(probs, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    flat = F.one_hot(eidx, E).reshape(B, S * k, E)
    pos = torch.cumsum(flat, 1) - flat
    pos = torch.gather(pos, 2, eidx.reshape(B, S * k, 1)).reshape(B, S, k)
    return probs, gate, eidx, pos


def _dispatch(x, dest, rows: int, k: int):
    """``[B, rows, d]`` zeros with each token's ``k`` copies scattered to
    their rows ``dest`` [B, S * k, 1] (row-local)."""
    B, S, d = x.shape
    src = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    return x.new_zeros((B, rows, d)).scatter_(1, dest.expand(B, S * k, d),
                                              src)


def _combine(out, slot):
    """``out[b, slot[b]]``: each token's ``k`` expert outputs
    (row-local)."""
    rows = torch.arange(out.shape[0], device=out.device)[:, None, None]
    return out[rows, slot]


def _expert_product(eq: str, a, w, a_split, w_split: int, out_split):
    """``torch.einsum(eq, a, w)`` of the expert buffers ``a`` (rows first)
    and an expert weight ``w``.  Under a mesh each rank multiplies its
    rows of ``a`` by its part of ``w``'s expert-hidden dim ``w_split``
    (``a`` split alike along ``a_split``, if it holds that dim); the
    output takes the split at ``out_split``, or holds partial sums where
    the split dim is contracted.  DTensor's own einsum would merge the
    rows into a dim split over several mesh axes (a strided split whose
    bookkeeping costs minutes a call)."""
    if not shd.is_dtensor(a):
        return torch.einsum(eq, a, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    a_pl, w_pl, o_pl = [], [], []
    for pa, pw in zip(a.placements, w.placements):
        if pa == Shard(0):
            a_pl.append(pa)
            w_pl.append(Replicate())
            o_pl.append(Shard(0))
        elif pw == Shard(w_split):
            a_pl.append(Replicate() if a_split is None else Shard(a_split))
            w_pl.append(pw)
            o_pl.append(Partial() if out_split is None else Shard(out_split))
        else:
            a_pl.append(Replicate())
            w_pl.append(Replicate())
            o_pl.append(Replicate())
    return local_map(lambda x, y: torch.einsum(eq, x, y),
                     out_placements=o_pl, in_placements=(a_pl, w_pl),
                     device_mesh=a.device_mesh, redistribute_inputs=True)(a, w)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig):
    """Token-choice top-k MoE, capacity-bounded, dispatched per batch row
    (``repro``'s ``moe_apply``): each row's slots go to ``[E, cap]``
    buffers in queue order, a slot past its expert's capacity is dropped
    (its token keeps the residual only); the two expert products run as
    batched bf16 matmuls; each token's kept outputs are weighted by their
    gates (cast to bf16) and added in bf16.  Returns ``(y [B, S, d],
    the load-balancing aux loss, f32 scalar)``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    x = shd.shard(x, "batch", "seq", None)
    probs, gate, eidx, pos = moe_route(p, x, cfg)
    cap = moe_capacity(cfg, S)
    keep = pos < cap
    slot = eidx * cap + torch.where(keep, pos, 0)      # [B, S, k]
    # dispatch: every kept slot owns its buffer row; a dropped one writes
    # into a spare row that is sliced away (repro's spare column), so no
    # index depends on how many were kept
    dest = torch.where(keep, slot, E * cap).reshape(B, S * k, 1)
    # row-wise: under a mesh on each rank's rows (``sharding.local_call``)
    buf = shd.local_call(lambda x, dest: _dispatch(x, dest, E * cap + 1, k),
                         (x, dest), ((0, None), (0, None)), ((0, None),))
    buf = shd.shard(buf[:, :E * cap].reshape(B, E, cap, d), "batch",
                    "experts", None, None)
    # the experts' weights regathered from their FSDP split before use,
    # the expert-hidden split kept (repro's layout at use)
    wi = shd.shard(p["wi"].to(x.dtype), None, None, "expert_hidden")
    wo = shd.shard(p["wo"].to(x.dtype), None, "expert_hidden", None)
    if shd.is_dtensor(wi):
        # each half its own product (``column_halves``), on each rank's
        # rows and expert-hidden split
        f = wi.shape[-1] // 2
        g, u = (_expert_product("becd,edf->becf", buf, shd.shard(
            w, None, None, "expert_hidden"), None, 2, 3)
            for w in (wi[..., :f], wi[..., f:]))
    else:
        g, u = torch.einsum("becd,edf->becf", buf, wi).chunk(2, dim=-1)
    h = shd.shard(silu(g) * u, "batch", "experts", None, "expert_hidden")
    out = _expert_product("becf,efd->becd", h, wo, 3, 1, None)
    # combine: each slot's output times its gate in bf16, the k of a token
    # added in bf16 (into zeros, so their order does not matter)
    got = shd.local_call(_combine, (out.reshape(B, E * cap, d), slot),
                         ((0, None), (0, None)), ((0, None),))  # [B,S,k,d]
    w = (gate * keep).to(x.dtype)[..., None]
    contrib = torch.where(keep[..., None], got * w, torch.zeros_like(got))
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    y = shd.shard(y, "batch", "seq", None)
    return y, _aux_loss(probs.reshape(-1, E), eidx.reshape(-1, k), E)


def _aux_loss(probs, eidx, E: int):
    """Load-balancing auxiliary loss (Switch-style)."""
    me = probs.mean(0)
    ce = F.one_hot(eidx[:, 0], E).float().mean(0)
    return E * torch.sum(me * ce)
