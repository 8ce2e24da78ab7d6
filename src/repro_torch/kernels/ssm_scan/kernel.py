"""CUDA launcher of the ssm_scan kernel (``csrc/ssm_scan.cu``).

Replaces ``repro/kernels/ssm_scan/kernel.py::ssm_scan_kernel``.  Takes
the Pallas kernel's inputs and gives its outputs, all contiguous f32:
decay / dbu ``[B, T, D, N]``, c ``[B, T, N]``, h0 ``[B, D, N]`` ->
``(h_out [B, D, N], y [B, T, D])``; any D (no padding), ``N <= 32``.
Built on first use (``repro_torch._build``), launched through ``ctypes``
on PyTorch's current stream.

Training: ``ssm_scan_train`` also returns every ``h_t`` (``h_seq [B, T,
D, N]``); ``ssm_scan_bwd`` launches the chunk's backward, which gives
``d decay``, ``d dbu``, ``dh0`` and ``dc``'s per-block partials, and
``ssm_scan_dc_sum`` adds the partials up in a fixed order (contiguous
segments of blocks across the card's threads, each in block order, then
the segments in order; no atomics).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _build

__all__ = ["MAX_N", "library", "ssm_scan", "ssm_scan_train", "ssm_scan_bwd",
           "ssm_scan_dc_sum"]

#: largest state size (the lanes of one warp)
MAX_N = 32

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the ssm_scan library."""
    lib = _build.load("ssm_scan", Path(__file__).parent / "csrc")
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    lib.ssm_scan_error_string.argtypes = [_I]
    lib.ssm_scan_launch.restype = _I
    lib.ssm_scan_launch.argtypes = [_I] * 4 + [_P] * 8
    lib.ssm_scan_bwd_blocks.restype = _I
    lib.ssm_scan_bwd_blocks.argtypes = [_I] * 2
    lib.ssm_scan_bwd_launch.restype = _I
    lib.ssm_scan_bwd_launch.argtypes = [_I] * 4 + [_P] * 11
    lib.ssm_scan_dc_sum_launch.restype = _I
    lib.ssm_scan_dc_sum_launch.argtypes = [_I] * 4 + [_P] * 3
    return lib


def _check(what: str, dev, B, T, D, N, *named) -> None:
    """Raise unless every ``(name, tensor, shape)`` is a contiguous f32
    tensor of that shape on ``dev`` and ``1 <= N <= MAX_N``."""
    for name, x, shape in named:
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be a contiguous float32 {shape} "
                f"tensor on {dev} (got {tuple(x.shape)} {x.dtype} on "
                f"{x.device})")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"{what}: N = {N} states; the kernel takes 1 to "
                         f"{MAX_N}")


def _raise(lib, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.ssm_scan_error_string(err).decode())


def _forward(what: str, decay, dbu, c, h0, train: bool):
    dev = decay.device
    _build.require_cuda(dev, what)
    B, T, D, N = decay.shape
    _check(what, dev, B, T, D, N, ("decay", decay, (B, T, D, N)),
           ("dbu", dbu, (B, T, D, N)), ("c", c, (B, T, N)),
           ("h0", h0, (B, D, N)))
    hout = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    y = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    hseq = (torch.empty((B, T, D, N), dtype=torch.float32, device=dev)
            if train else None)
    lib = library()
    _raise(lib, what, _build.launch(
        lib.ssm_scan_launch, dev, B, T, D, N, decay.data_ptr(),
        dbu.data_ptr(), c.data_ptr(), h0.data_ptr(), hout.data_ptr(),
        y.data_ptr(), None if hseq is None else hseq.data_ptr()))
    return (hout, y) if hseq is None else (hout, y, hseq)


def ssm_scan(decay: torch.Tensor, dbu: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (asynchronous on the current stream; a refused
    launch raises); returns new ``h_out`` and ``y`` tensors."""
    return _forward("ssm_scan", decay, dbu, c, h0, train=False)


def ssm_scan_train(decay: torch.Tensor, dbu: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor):
    """``ssm_scan`` that also writes every ``h_t``: returns ``(h_out, y,
    h_seq [B, T, D, N])``, the first two bitwise ``ssm_scan``'s."""
    return _forward("ssm_scan_train", decay, dbu, c, h0, train=True)


def ssm_scan_bwd(decay: torch.Tensor, h_seq: torch.Tensor,
                 h0: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                 dh_t: torch.Tensor):
    """The backward of one chunk (asynchronous; a refused launch raises):
    from ``decay`` and the forward's ``h_seq`` [B, T, D, N], ``h0`` [B,
    D, N], ``c`` [B, T, N] and the cotangents ``dy`` [B, T, D], ``dh_t``
    [B, D, N] (contiguous f32) -> ``(d_decay, d_dbu [B, T, D, N], dh0
    [B, D, N], dc_part [B, nblk, T, N])``: ``dc_part`` holds each block's
    sum over its channels, for ``ssm_scan_dc_sum``."""
    dev = decay.device
    _build.require_cuda(dev, "ssm_scan_bwd")
    B, T, D, N = decay.shape
    _check("ssm_scan_bwd", dev, B, T, D, N, ("decay", decay, (B, T, D, N)),
           ("h_seq", h_seq, (B, T, D, N)), ("h0", h0, (B, D, N)),
           ("c", c, (B, T, N)), ("dy", dy, (B, T, D)),
           ("dh_t", dh_t, (B, D, N)))
    lib = library()
    nblk = lib.ssm_scan_bwd_blocks(D, N)
    d_decay = torch.empty_like(decay)
    d_dbu = torch.empty_like(decay)
    dh0 = torch.empty_like(h0)
    part = torch.empty((B, nblk, T, N), dtype=torch.float32, device=dev)
    err = _build.launch(lib.ssm_scan_bwd_launch, dev, B, T, D, N,
                        decay.data_ptr(), h_seq.data_ptr(), h0.data_ptr(),
                        c.data_ptr(), dy.data_ptr(), dh_t.data_ptr(),
                        d_decay.data_ptr(), d_dbu.data_ptr(), dh0.data_ptr(),
                        part.data_ptr())
    _raise(lib, "ssm_scan_bwd", err)
    return d_decay, d_dbu, dh0, part


def ssm_scan_dc_sum(dc_part: torch.Tensor) -> torch.Tensor:
    """``dc`` [B, T, N]: ``ssm_scan_bwd``'s partials [B, nblk, T, N]
    summed over the blocks in a fixed order (f32): contiguous segments of
    blocks, each in block order, then the segments in order."""
    dev = dc_part.device
    _build.require_cuda(dev, "ssm_scan_dc_sum")
    if (dc_part.dim() != 4 or dc_part.dtype != torch.float32
            or not dc_part.is_contiguous()):
        raise ValueError("ssm_scan_dc_sum: dc_part must be a contiguous "
                         "float32 [B, nblk, T, N] tensor")
    B, nblk, T, N = dc_part.shape
    dc = torch.empty((B, T, N), dtype=torch.float32, device=dev)
    lib = library()
    err = _build.launch(lib.ssm_scan_dc_sum_launch, dev, B, T, N, nblk,
                        dc_part.data_ptr(), dc.data_ptr())
    _raise(lib, "ssm_scan_dc_sum", err)
    return dc
