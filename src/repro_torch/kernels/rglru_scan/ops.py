"""The RG-LRU gates and recurrence, dispatched by device.

CPU tensors run the plain version (``ref.rglru_gated_scan_ref``), CUDA
tensors launch the CUDA kernel (``kernel.rglru_scan``), and a failed
build or launch raises; nothing falls back from one to the other.  On CUDA
tensors a call that would need a gradient (grad mode on, an input that
requires grad) raises ``NotImplementedError``: the kernel has no
backward yet, and its output would carry none; on the CPU autograd
differentiates the plain version.
``repro`` computes the recurrence as an XLA scan in chunks of 256 steps,
padding the last with ``a = 1, g = 0``, which leaves ``h`` unchanged
under an FMA: here the whole sequence is one call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan import ref

__all__ = ["rglru_scan", "launches"]

#: CUDA launches of the rglru_scan kernel made through ``rglru_scan``
launches = 0


def rglru_scan(r_pre: torch.Tensor, i_pre: torch.Tensor, u: torch.Tensor,
               nsp: torch.Tensor, h0: torch.Tensor):
    """r_pre, i_pre, u: [B, S, d] bf16 (the gate GEMMs' outputs and the
    conv output); nsp: [d] f32 (``-c * softplus(Lambda)``); h0: [B, d]
    f32 -> ``(h_seq [B, S, d], h_S [B, d])``, f32: ``a = exp(nsp *
    sigmoid(r_pre))``, ``x = sigmoid(i_pre) * u``, ``h_t = fma(a_t,
    h_{t-1}, x_t * sqrt(max(fma(-a_t, a_t, 1), 1e-9)))``."""
    global launches
    dev = r_pre.device
    if dev.type == "cpu":
        return ref.rglru_gated_scan_ref(r_pre, i_pre, u, nsp, h0)
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan runs on CPU or CUDA, not {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r_pre, i_pre, u, nsp, h0)):
        raise NotImplementedError(
            "rglru_scan: the CUDA kernel has no backward kernel yet "
            "(ROADMAP.md, Queue 1 item 3b: backward kernels for ssm_scan "
            "and rglru_scan); a gradient through it cannot be taken on "
            "the card")
    from repro_torch.kernels.rglru_scan import kernel
    out = kernel.rglru_scan(r_pre, i_pre, u, nsp, h0)
    launches += 1
    return out
