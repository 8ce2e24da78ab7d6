"""Mamba-1 selective-SSM block, falcon-mamba-7b's layer (port of
``repro.models.ssm``).

The sequence pass runs the selective scan in chunks of 256 steps: per
chunk it materialises ``decay = exp(dt * A)`` and ``dBu = dt * u * B``
in f32 and hands them to the ssm_scan kernel's dispatch
(``repro_torch.kernels.ssm_scan.ops``: the CUDA kernel on the card, its
plain version on the CPU, the counterpart of ``repro``'s
``ssm_impl="pallas"``), carrying ``h`` from chunk to chunk.  ``repro``
loops over chunks with ``lax.scan`` under ``jax.checkpoint``, which
exists for the backward pass; here a Python loop.  Decode keeps the
conv state and ``h`` and advances one token in closed form, as in
``repro`` (plain PyTorch: ``repro`` has no kernel there).

The dtypes follow ``repro`` op for op: projections, the conv and the
softplus in bf16; ``A = -exp(A_log)``, ``decay``, ``dBu``, the scan and
the ``D`` skip in f32, cast to bf16 before the ``silu(z)`` gate.  The
activations are written as ``jax.nn.silu`` / ``softplus`` are, one
rounded bf16 op at a time (XLA rounds each; ``silu`` is
``layers.silu``, shared with the dense MLP): a fused
``F.silu`` / ``F.softplus`` rounds once and differs by an ulp in ~15 %
of the values, and one ulp of ``dt`` moves ``decay``, hence ``h``, by
several per cent.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import column_halves, silu
from repro_torch.models.params import ParamDef

__all__ = ["CHUNK", "ssm_defs", "causal_conv", "ssm_block_apply",
           "ssm_decode_step", "ssm_init_state"]

#: time steps a scan launch (``repro``'s default ``chunk``)
CHUNK = 256


def ssm_defs(cfg: ModelConfig):
    d, di, N, dtr, kc = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                         cfg.dt_rank, cfg.ssm_conv)
    return {
        "in_proj": ParamDef((d, 2 * di), ("embed", "hidden")),
        "conv_w": ParamDef((kc, di), ("state", "hidden")),
        "conv_b": ParamDef((di,), ("hidden",), "zeros"),
        "x_proj": ParamDef((di, dtr + 2 * N), ("hidden", None)),
        "dt_proj": ParamDef((dtr, di), (None, "hidden")),
        "dt_bias": ParamDef((di,), ("hidden",), "zeros"),
        "A_log": ParamDef((di, N), ("hidden", "state"), "ones"),
        "D": ParamDef((di,), ("hidden",), "ones"),
        "out_proj": ParamDef((di, d), ("hidden", "embed")),
    }


def _softplus(x):
    """``jax.nn.softplus``: ``max(x, 0) + log1p(exp(-|x|))``, each op
    rounded in x's dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(p, x, cfg: ModelConfig):
    """The input projection split into the conv input ``u`` and the gate
    ``z``, each [B, S, di] in x's dtype."""
    return column_halves(x, p["in_proj"].to(x.dtype))


def _selective(p, u_conv, cfg: ModelConfig):
    """``(dt, B, C)``: softplus(dt) [B,S,di] and the selective B, C
    [B,S,N], in u's dtype."""
    N, dtr = cfg.ssm_state, cfg.dt_rank
    proj = shd.shard(u_conv @ p["x_proj"].to(u_conv.dtype),  # [B,S,dtr+2N]
                     "batch", "seq", None)
    dt_in, Bmat, Cmat = proj.split([dtr, N, N], dim=-1)
    dt = _softplus(dt_in @ p["dt_proj"].to(u_conv.dtype)
                   + p["dt_bias"].to(u_conv.dtype))
    return dt, Bmat, Cmat


def causal_conv(p, u, kc: int, conv_state=None):
    """Depthwise causal conv1d along S with ``p["conv_w"]`` [kc, d] and
    ``p["conv_b"]``, each product and sum rounded in u's dtype (``repro``'s
    ``sum`` of shifted products).  conv_state: [B, kc-1, d] (zeros
    without one).  Returns ``(conv, the last kc-1 rows of [state, u])``;
    the RG-LRU block uses it too."""
    w = p["conv_w"].to(u.dtype)                        # [kc, d]
    if conv_state is None:
        pad = torch.zeros((u.shape[0], kc - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)                    # [B, S+kc-1, d]
    S = u.shape[1]
    out = up[:, 0:S] * w[0]
    for i in range(1, kc):
        out = out + up[:, i:i + S] * w[i]
    out = out + p["conv_b"].to(u.dtype)
    new_state = up[:, up.shape[1] - (kc - 1):] if kc > 1 else pad
    return out, new_state


def _causal_conv(p, u, cfg: ModelConfig, conv_state=None):
    """The mamba block's conv: ``causal_conv``, then silu."""
    out, new_state = causal_conv(p, u, cfg.ssm_conv, conv_state)
    return silu(out), new_state


def _discretise(dt, u, Bm, A):
    """``(decay, dBu)`` [B,T,di,N] f32 of a chunk: ``exp(dt * A)`` and
    ``(dt * u) * B``."""
    dtf = dt.float()
    decay = torch.exp(dtf[..., None] * A)
    dBu = (dtf * u.float())[..., None] * Bm.float()[..., None, :]
    return decay, dBu


def ssm_block_apply(p, x, cfg: ModelConfig, chunk: int = CHUNK,
                    return_state: bool = False):
    """Full mamba block over a sequence.  x: [B, S, d] -> [B, S, d].

    One ssm_scan call a chunk of ``chunk`` steps; the last chunk is padded
    with zeros (dt = 0 gives decay 1 and dBu 0, so h is exact).  With
    ``return_state`` also returns the decode state after the last token:
    ``{"conv": the last kc-1 pre-conv inputs [B, kc-1, di], "ssm": h_S
    [B, di, N] f32}``; that needs ``S >= kc - 1`` (a shorter prompt
    raises: it has fewer rows than the conv state holds)."""
    B, S, _ = x.shape
    di, N, kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    if return_state and S < kc - 1:
        raise ValueError(f"{cfg.name}: a prompt of {S} tokens is shorter "
                         f"than the conv state's ssm_conv - 1 = {kc - 1} "
                         f"rows; prefill needs at least {kc - 1} tokens")
    # the split products' input and output (no-ops off a mesh)
    x = shd.shard(x, "batch", "seq", None)
    u_pre, z = _ssm_inputs(p, x, cfg)
    u, _ = _causal_conv(p, u_pre, cfg)
    dt, Bm, Cm = _selective(p, u, cfg)
    A = -torch.exp(p["A_log"].float())                 # [di, N]

    pad = -S % chunk
    if pad:
        grow = lambda a: F.pad(a, (0, 0, 0, pad))
        u_s, dt, Bm, Cm = grow(u), grow(dt), grow(Bm), grow(Cm)
    else:
        u_s = u
    h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, S + pad, chunk):
        sl = slice(t0, t0 + chunk)
        decay, dBu = _discretise(dt[:, sl], u_s[:, sl], Bm[:, sl], A)
        h, yc = ssm_ops.ssm_scan(decay, dBu, Cm[:, sl].float().contiguous(),
                                 h)
        del decay, dBu
        ys.append(yc)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + u.float() * p["D"].float()
    y = y.to(x.dtype) * silu(z)
    out = shd.shard(y @ p["out_proj"].to(x.dtype), "batch", "seq", None)
    if return_state:
        return out, {"conv": u_pre[:, S - (kc - 1):], "ssm": h}
    return out


def ssm_decode_step(p, x, state: dict, cfg: ModelConfig):
    """One-token decode.  x: [B, 1, d]; state: ``{"conv": [B, kc-1, di],
    "ssm": [B, di, N] f32}`` -> ``(y [B, 1, d], new state)`` (new
    tensors; the caller decides where they go)."""
    u, z = _ssm_inputs(p, shd.shard(x, "batch", "seq", None), cfg)
    u, conv_state = _causal_conv(p, u, cfg, conv_state=state["conv"])
    dt, Bm, Cm = _selective(p, u, cfg)
    A = -torch.exp(p["A_log"].float())
    decay, dBu = _discretise(dt[:, 0], u[:, 0], Bm[:, 0], A)  # [B, di, N]
    h = decay * state["ssm"] + dBu
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())
    y = y + u[:, 0].float() * p["D"].float()
    y = y[:, None].to(x.dtype) * silu(z)
    return (shd.shard(y @ p["out_proj"].to(x.dtype), "batch", "seq", None),
            {"conv": conv_state, "ssm": h})


def ssm_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    """A zero decode state: conv [B, kc-1, di] bf16, ssm [B, di, N] f32."""
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }
