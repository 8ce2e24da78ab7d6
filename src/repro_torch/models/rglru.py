"""RG-LRU recurrent block, recurrentgemma's recurrent layer (port of
``repro.models.rglru``).

The block: a linear branch and a GeLU gate branch, a short causal
conv1d, and the Real-Gated Linear Recurrent Unit

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates, the gate factor ``sqrt(max(1 - a * a, 1e-9))``, its product
with ``i * u`` and the recurrence run through the rglru_scan kernel's
dispatch (``repro_torch.kernels.rglru_scan.ops``: the CUDA kernel on the
card, its plain version on the CPU) from the two gate GEMMs' outputs,
the conv output and ``nsp = -c * softplus(Lambda)``: one call a layer
over the whole prompt and one a decode step (S = 1), so that both paths
round ``1 - a * a`` and ``h`` as one FMA each, as XLA's contracted
multiply-adds do in ``repro``.

The dtypes follow ``repro`` op for op: the projections, the conv and the
two sigmoids in bf16 (``jax.nn.sigmoid`` rounds ``1 / (1 + exp(-x))``
one bf16 op at a time on the CPU), the softplus, ``a``, the gate factor
and the scan in f32.  XLA's
f32 ``exp`` and ``sqrt`` are not correctly rounded and differ from
PyTorch's by an ulp in ~10 % / ~0.5 % of values, so the block agrees
with ``repro`` to bf16 rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gelu_tanh
from repro_torch.models.params import ParamDef
from repro_torch.models.ssm import _softplus, causal_conv

__all__ = ["rglru_defs", "rglru_block_apply", "rglru_decode_step",
           "rglru_init_state"]

_C = 8.0  # Griffin's fixed gate temperature


def rglru_defs(cfg: ModelConfig):
    d = cfg.d_model
    return {
        "in_x": ParamDef((d, d), ("embed", "hidden")),
        "in_gate": ParamDef((d, d), ("embed", "hidden")),
        "conv_w": ParamDef((cfg.ssm_conv or 4, d), ("state", "hidden")),
        "conv_b": ParamDef((d,), ("hidden",), "zeros"),
        "w_r": ParamDef((d, d), ("hidden", "hidden")),
        "w_i": ParamDef((d, d), ("hidden", "hidden")),
        "lam": ParamDef((d,), ("hidden",), "ones"),
        "out": ParamDef((d, d), ("hidden", "embed")),
    }


def _gates(p, u):
    """``(r_pre, i_pre, nsp)`` of the conv output ``u`` (bf16): the two
    gate GEMMs' outputs [B, S, d] (bf16) and ``nsp = -c *
    softplus(Lambda)`` [d] f32; the scan forms ``repro``'s ``a = exp(nsp *
    sigmoid(r_pre))`` and gated input ``(sigmoid(i_pre) * u) * sqrt(max(1
    - a * a, 1e-9))`` from them (``rglru_scan.ref.gate_inputs``)."""
    # the row-split products' partial sums meet here (no-op off a mesh)
    gate = lambda w: shd.shard(u @ p[w].to(u.dtype), "batch", "seq",
                               "hidden")
    return gate("w_r"), gate("w_i"), -_C * _softplus(p["lam"].float())


def rglru_block_apply(p, x, cfg: ModelConfig, return_state: bool = False):
    """x: [B, S, d] -> [B, S, d]; with ``return_state`` also the exact
    decode state after the last token, ``{"conv": the last kc-1 inputs
    of the conv [B, kc-1, d], "h": h_S [B, d] f32}``, which needs ``S >=
    kc - 1`` (a shorter prompt raises: it has fewer rows than the conv
    state holds)."""
    B, S, d = x.shape
    kc = cfg.ssm_conv or 4
    if return_state and S < kc - 1:
        raise ValueError(f"{cfg.name}: a prompt of {S} tokens is shorter "
                         f"than the conv state's ssm_conv - 1 = {kc - 1} "
                         f"rows; prefill needs at least {kc - 1} tokens")
    # the split products' input and output (no-ops off a mesh)
    x = shd.shard(x, "batch", "seq", None)
    u_pre = x @ p["in_x"].to(x.dtype)
    gate = gelu_tanh(x @ p["in_gate"].to(x.dtype))
    u, _ = causal_conv(p, u_pre, kc)
    r_pre, i_pre, nsp = _gates(p, u)
    h0 = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    h_seq, h_n = scan_ops.rglru_scan(r_pre.contiguous(), i_pre.contiguous(),
                                     u.contiguous(), nsp, h0)
    y = h_seq.to(x.dtype) * gate
    out = shd.shard(y @ p["out"].to(x.dtype), "batch", "seq", None)
    if return_state:
        return out, {"conv": u_pre[:, S - (kc - 1):], "h": h_n}
    return out


def rglru_decode_step(p, x, state: dict, cfg: ModelConfig):
    """x: [B, 1, d]; state: ``{"conv": [B, kc-1, d], "h": [B, d] f32}``
    -> ``(y [B, 1, d], new state)`` (new tensors)."""
    kc = cfg.ssm_conv or 4
    x = shd.shard(x, "batch", "seq", None)
    u = x @ p["in_x"].to(x.dtype)
    gate = gelu_tanh(x @ p["in_gate"].to(x.dtype))
    u, conv_state = causal_conv(p, u, kc, state["conv"])
    r_pre, i_pre, nsp = _gates(p, u)
    _, h = scan_ops.rglru_scan(r_pre.contiguous(), i_pre.contiguous(),
                               u.contiguous(), nsp,
                               state["h"].float().contiguous())
    y = h[:, None].to(x.dtype) * gate
    return (shd.shard(y @ p["out"].to(x.dtype), "batch", "seq", None),
            {"conv": conv_state, "h": h})


def rglru_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    """A zero decode state: conv [B, kc-1, d] bf16, h [B, d] f32."""
    kc = cfg.ssm_conv or 4
    return {"conv": torch.zeros((batch, kc - 1, cfg.d_model),
                                dtype=torch.bfloat16, device=device),
            "h": torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                             device=device)}
