"""Common transformer layers: norms, RoPE, GQA attention, MLP (port of
``repro.models.layers``, dense family).

Pure-function style: ``*_defs(cfg)`` returns the ParamDef tree of a
layer, ``*_apply(p, x, ...)`` runs it on ``p``, a mapping of tensors (a
dict, or the ``nn.ModuleDict`` / ``nn.ParameterDict`` of a model).
Attention goes through the flash-attention kernel's dispatch
(``repro_torch.kernels.flash_attention.ops``): the CUDA kernel on the
card, its plain version on the CPU, the counterpart of ``repro``'s
``attn_impl="pallas"``.  ``naive_attention`` is the reference for
arbitrary positions.  ``repro``'s XLA strategies ``blocked_attention``
and ``split_kv_decode_attention`` come with the sharding slice; MoE
with its own.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

__all__ = ["NEG_INF", "norm_defs", "norm_apply", "rope", "attention_defs",
           "naive_attention", "attention_apply", "silu", "gelu_tanh",
           "mlp_defs", "mlp_apply"]

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


def attention_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
                    causal: bool = True, window: int = 0):
    """Self-attention sub-layer over positions ``arange(S)``: projections +
    RoPE + the flash-attention kernel + output projection.  Returns
    ``(out, (k, v))``, ``k`` / ``v`` this call's projected (and rotated)
    keys and values for the cache."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(B, -1, H, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, -1, K, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, -1, K, hd)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    k = rope(k, pos[None], cfg.rope_theta)
    q = rope(q, pos[None], cfg.rope_theta)
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    y = out.reshape(B, -1, H * hd) @ p["wo"].to(x.dtype)
    return y, (k, v)


# ----------------------------------------------------------------------- MLP

# ``jax.nn``'s activations are composites that XLA rounds op by op; a
# fused ``F.silu`` / ``F.gelu`` rounds once and differs by an ulp in ~40 %
# of bf16 values.  These compose them as ``jax.nn`` does, each op rounded
# in x's dtype (its Python constants are weakly typed: x's dtype too).

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * (1 / (1 + exp(-x)))``."""
    return x * (1 / (1 + torch.exp(-x)))


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


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = x @ p["wi"].to(x.dtype)
    if cfg.act == "silu":
        g, u = h.chunk(2, dim=-1)
        h = silu(g) * u
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = gelu_tanh(h)
    return h @ p["wo"].to(x.dtype)
