"""CUDA launcher of the ssm_scan kernel (``csrc/ssm_scan.cu``).

Replaces ``repro/kernels/ssm_scan/kernel.py::ssm_scan_kernel``.  Takes
the Pallas kernel's inputs and gives its outputs, all contiguous f32:
decay / dbu ``[B, T, D, N]``, c ``[B, T, N]``, h0 ``[B, D, N]`` ->
``(h_out [B, D, N], y [B, T, D])``; any D (no padding), ``N <= 32``.
Built on first use (``repro_torch._build``), launched through ``ctypes``
on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _build

__all__ = ["MAX_N", "library", "ssm_scan"]

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
    lib.ssm_scan_launch.argtypes = [_I] * 4 + [_P] * 7
    return lib


def ssm_scan(decay: torch.Tensor, dbu: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (asynchronous on the current stream; a refused
    launch raises); returns new ``h_out`` and ``y`` tensors."""
    dev = decay.device
    _build.require_cuda(dev, "ssm_scan")
    B, T, D, N = decay.shape
    for name, x, shape in (("decay", decay, (B, T, D, N)),
                           ("dbu", dbu, (B, T, D, N)), ("c", c, (B, T, N)),
                           ("h0", h0, (B, D, N))):
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"ssm_scan: {name} must be a contiguous float32 {shape} "
                f"tensor on {dev} (got {tuple(x.shape)} {x.dtype} on "
                f"{x.device})")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"ssm_scan: N = {N} states; the kernel takes 1 to "
                         f"{MAX_N}")
    hout = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    y = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    lib = library()
    err = _build.launch(lib.ssm_scan_launch, dev, B, T, D, N,
                        decay.data_ptr(), dbu.data_ptr(), c.data_ptr(),
                        h0.data_ptr(), hout.data_ptr(), y.data_ptr())
    if err != 0:
        raise RuntimeError("ssm_scan launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    return hout, y
