"""The selective scan, dispatched by device (port of
``repro.kernels.ssm_scan.ops``).

CPU tensors run the plain version (``ref.ssm_scan_ref``), CUDA tensors
launch the CUDA kernel (``kernel.ssm_scan``), and a failed build or
launch raises; nothing falls back from one to the other.  On CUDA
tensors a call that would need a gradient (grad mode on, an input that
requires grad) raises ``NotImplementedError``: the kernel has no
backward yet, and its output would carry none; on the CPU autograd
differentiates the plain version.  Unlike the
Pallas wrapper, nothing pads D: the kernel masks the ragged edge.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import ref

__all__ = ["ssm_scan", "launches"]

#: CUDA launches of the ssm_scan kernel made through ``ssm_scan``
launches = 0


def ssm_scan(decay: torch.Tensor, dbu: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor):
    """decay / dbu: [B,T,D,N]; c: [B,T,N]; h0: [B,D,N], f32 ->
    ``(h_out [B,D,N], y [B,T,D])``, f32."""
    global launches
    dev = decay.device
    if dev.type == "cpu":
        return ref.ssm_scan_ref(decay, dbu, c, h0)
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan runs on CPU or CUDA, not {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (decay, dbu, c, h0)):
        raise NotImplementedError(
            "ssm_scan: the CUDA kernel has no backward kernel yet "
            "(ROADMAP.md, Queue 1 item 3b: backward kernels for ssm_scan "
            "and rglru_scan); a gradient through it cannot be taken on "
            "the card")
    from repro_torch.kernels.ssm_scan import kernel
    out = kernel.ssm_scan(decay, dbu, c, h0)
    launches += 1
    return out
