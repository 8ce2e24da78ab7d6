"""The selective scan, dispatched by device (port of
``repro.kernels.ssm_scan.ops``).

CPU tensors run the plain version (``ref.ssm_scan_ref``), CUDA tensors
launch the CUDA kernel (``kernel.ssm_scan``), and a failed build or
launch raises; nothing falls back from one to the other.  On CUDA
tensors a call that needs a gradient (grad mode on, an input that
requires grad) goes through ``SsmScanFn``: its forward launches the
training instantiation, which also writes every ``h_t``, and its
backward the backward kernel and the sum of ``dc``'s block partials; on
the CPU autograd differentiates the plain version.  Unlike the Pallas
wrapper, nothing pads D: the kernel masks the ragged edge.  Counters:
``launches`` (the serving forward), ``train_launches`` (the training
forward), ``bwd_launches`` and ``bwd_sum_launches``.

Meta tensors (the dry run) launch nothing: empty outputs of the kernel's
shapes, and its work (``analysis.roofline.scan_work``; in the backward
``ssm_bwd_work`` and ``ssm_dc_sum_work``) added to the active op
counter, on each rank's shards where the inputs are DTensors (batch and
state-channel splits kept: ``sharding.local_call``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import ref

__all__ = ["ssm_scan", "SsmScanFn", "launches", "train_launches",
           "bwd_launches", "bwd_sum_launches"]

#: CUDA launches of the ssm_scan kernel made through ``ssm_scan``
launches = 0
#: CUDA launches of its training instantiation (which also writes h)
train_launches = 0
#: CUDA launches of the backward kernel and of dc's partial sum
bwd_launches = 0
bwd_sum_launches = 0


class SsmScanFn(torch.autograd.Function):
    """The scan kernel with its backward kernel, on CUDA tensors: a chunk
    is one call, and one chunk's ``dh0`` reaches the chunk before it as
    the cotangent of its ``h_out``."""

    @staticmethod
    def forward(ctx, decay, dbu, c, h0):
        global train_launches
        from repro_torch.kernels.ssm_scan import kernel
        h_out, y, h_seq = kernel.ssm_scan_train(decay, dbu, c, h0)
        train_launches += 1
        ctx.save_for_backward(decay, h_seq, h0, c)
        return h_out, y

    @staticmethod
    def backward(ctx, dh_out, dy):
        global bwd_launches, bwd_sum_launches
        from repro_torch.kernels.ssm_scan import kernel
        decay, h_seq, h0, c = ctx.saved_tensors
        d_decay, d_dbu, dh0, part = kernel.ssm_scan_bwd(
            decay, h_seq, h0, c, dy.contiguous(), dh_out.contiguous())
        bwd_launches += 1
        dc = kernel.ssm_scan_dc_sum(part)
        bwd_sum_launches += 1
        return d_decay, d_dbu, dc, dh0


class _MetaScanFn(torch.autograd.Function):
    """The kernel on meta tensors: its shapes and its counted work, no
    launch; with a gradient to come, the training instantiation (which
    writes h_seq, saved as ``SsmScanFn`` saves it) and the backward's two
    kernels."""

    @staticmethod
    def forward(ctx, decay, dbu, c, h0):
        from repro_torch.analysis import opcount, roofline
        B, T, D, N = decay.shape
        train = any(ctx.needs_input_grad)
        opcount.add_kernel("ssm_scan_train" if train else "ssm_scan",
                           *roofline.scan_work(B, T, D, N, train))
        if train:
            ctx.save_for_backward(decay, torch.empty_like(decay), h0, c)
        return h0.new_empty((B, D, N)), h0.new_empty((B, T, D))

    @staticmethod
    def backward(ctx, dh_out, dy):
        from repro_torch.analysis import opcount, roofline
        decay, _, h0, c = ctx.saved_tensors
        B, T, D, N = decay.shape
        opcount.add_kernel("ssm_scan_bwd", *roofline.ssm_bwd_work(B, T, D, N))
        opcount.add_kernel("ssm_scan_dc_sum",
                           *roofline.ssm_dc_sum_work(B, T, D, N))
        return (torch.empty_like(decay), torch.empty_like(decay),
                torch.empty_like(c), torch.empty_like(h0))


def ssm_scan(decay: torch.Tensor, dbu: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor):
    """decay / dbu: [B,T,D,N]; c: [B,T,N]; h0: [B,D,N], f32 ->
    ``(h_out [B,D,N], y [B,T,D])``, f32."""
    global launches
    dev = decay.device
    if dev.type == "cpu":
        return ref.ssm_scan_ref(decay, dbu, c, h0)
    if dev.type == "meta":
        from repro_torch.sharding import local_call
        return local_call(_MetaScanFn.apply, (decay, dbu, c, h0),
                          ((0, 2), (0, 2), (0, None), (0, 1)),
                          ((0, 1), (0, 2)))
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan runs on CPU or CUDA, not {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (decay, dbu, c, h0)):
        return SsmScanFn.apply(decay, dbu, c, h0)
    from repro_torch.kernels.ssm_scan import kernel
    out = kernel.ssm_scan(decay, dbu, c, h0)
    launches += 1
    return out
