"""The RG-LRU gates and recurrence, dispatched by device.

CPU tensors run the plain version (``ref.rglru_gated_scan_ref``), CUDA
tensors launch the CUDA kernel (``kernel.rglru_scan``), and a failed
build or launch raises; nothing falls back from one to the other.  On CUDA
tensors a call that needs a gradient (grad mode on, an input that
requires grad) goes through ``RglruScanFn``, whose backward launches the
backward kernel (``kernel.rglru_scan_bwd``) on the forward's saved
``h_seq``; on the CPU autograd differentiates the plain version.
``repro`` computes the recurrence as an XLA scan in chunks of 256 steps,
padding the last with ``a = 1, g = 0``, which leaves ``h`` unchanged
under an FMA: here the whole sequence is one call.  Counters:
``launches`` (the forward), ``bwd_launches`` and ``bwd_nsp_launches``
(the backward's second launch, made only where a batch has more rows than
one cluster adds up: at B > ``ref.CLUSTER_MAX``).

Meta tensors (the dry run) launch nothing: empty outputs of the kernel's
shapes, and its work (``analysis.roofline.rglru_work``; in the backward
``rglru_bwd_work``) added to the active op counter, on each rank's shards
where the inputs are DTensors (batch and channel splits kept:
``sharding.local_call``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan import ref

__all__ = ["rglru_scan", "RglruScanFn", "launches", "bwd_launches",
           "bwd_nsp_launches"]

#: CUDA launches of the rglru_scan kernel made through ``rglru_scan``
launches = 0
#: CUDA launches of the backward kernel and of its sum of the clusters'
#: dnsp partials
bwd_launches = 0
bwd_nsp_launches = 0


class RglruScanFn(torch.autograd.Function):
    """The scan kernel with its backward kernel, on CUDA tensors."""

    @staticmethod
    def forward(ctx, r_pre, i_pre, u, nsp, h0):
        global launches
        from repro_torch.kernels.rglru_scan import kernel
        h_seq, h_n = kernel.rglru_scan(r_pre, i_pre, u, nsp, h0)
        launches += 1
        ctx.save_for_backward(r_pre, i_pre, u, nsp, h0, h_seq)
        return h_seq, h_n

    @staticmethod
    def backward(ctx, dh_seq, dh_n):
        global bwd_launches, bwd_nsp_launches
        from repro_torch.kernels.rglru_scan import kernel
        r_pre, i_pre, u, nsp, h0, h_seq = ctx.saved_tensors
        out = kernel.rglru_scan_bwd(r_pre, i_pre, u, nsp, h0, h_seq,
                                    dh_seq.contiguous(), dh_n.contiguous())
        bwd_launches += 1
        B = r_pre.shape[0]
        if ref.cluster_rows(B) < B:
            bwd_nsp_launches += 1
        return out


class _MetaRglruFn(torch.autograd.Function):
    """The kernel on meta tensors: its shapes and its counted work
    (forward, and the backward's), no launch; saves what
    ``RglruScanFn`` saves."""

    @staticmethod
    def forward(ctx, r_pre, i_pre, u, nsp, h0):
        from repro_torch.analysis import opcount, roofline
        B, S, d = r_pre.shape
        opcount.add_kernel("rglru_scan", *roofline.rglru_work(B, S, d))
        h_seq = h0.new_empty((B, S, d))
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(r_pre, i_pre, u, nsp, h0, h_seq)
        return h_seq, h0.new_empty((B, d))

    @staticmethod
    def backward(ctx, dh_seq, dh_n):
        from repro_torch.analysis import opcount, roofline
        r_pre, i_pre, u, nsp, h0, _ = ctx.saved_tensors
        B, S, d = r_pre.shape
        opcount.add_kernel("rglru_scan_bwd", *roofline.rglru_bwd_work(B, S, d))
        return tuple(torch.empty_like(t) for t in (r_pre, i_pre, u, nsp, h0))


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
    if dev.type == "meta":
        from repro_torch.sharding import local_call
        return local_call(_MetaRglruFn.apply, (r_pre, i_pre, u, nsp, h0),
                          ((0, 2), (0, 2), (0, 2), (None, 0), (0, 1)),
                          ((0, 2), (0, 1)))
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan runs on CPU or CUDA, not {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r_pre, i_pre, u, nsp, h0)):
        return RglruScanFn.apply(r_pre, i_pre, u, nsp, h0)
    from repro_torch.kernels.rglru_scan import kernel
    out = kernel.rglru_scan(r_pre, i_pre, u, nsp, h0)
    launches += 1
    return out
