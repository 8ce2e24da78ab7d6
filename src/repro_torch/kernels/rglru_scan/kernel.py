"""CUDA launcher of the rglru_scan kernel (``csrc/rglru_scan.cu``).

Replaces no Pallas kernel: ``repro.models.rglru.rglru_block_apply``'s
recurrence is an XLA scan.  Takes contiguous f32 ``a``, ``x`` (the gated
input ``i * u``) ``[B, S, d]`` and ``h0`` ``[B, d]`` and returns new
``h_seq [B, S, d]`` and ``h_S [B, d]`` tensors.  Built on first use (``repro_torch._build``), launched
through ``ctypes`` on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _build

__all__ = ["ENTRY", "library", "rglru_scan"]

#: the kernel's name, as it appears in the built library's symbols and in
#: a profiler's kernel names
ENTRY = "rglru_scan_kernel"

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the rglru_scan library."""
    lib = _build.load("rglru_scan", Path(__file__).parent / "csrc")
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    lib.rglru_scan_error_string.argtypes = [_I]
    lib.rglru_scan_launch.restype = _I
    lib.rglru_scan_launch.argtypes = [_I] * 3 + [_P] * 6
    return lib


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (asynchronous on the current stream; a refused
    launch raises); returns new ``h_seq`` and ``h_S`` tensors."""
    dev = a.device
    _build.require_cuda(dev, "rglru_scan")
    B, S, d = a.shape
    for name, t, shape in (("a", a, (B, S, d)), ("x", x, (B, S, d)),
                           ("h0", h0, (B, d))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"rglru_scan: {name} must be a contiguous float32 {shape} "
                f"tensor on {dev} (got {tuple(t.shape)} {t.dtype} on "
                f"{t.device})")
    h_seq = torch.empty((B, S, d), dtype=torch.float32, device=dev)
    h_n = torch.empty((B, d), dtype=torch.float32, device=dev)
    lib = library()
    err = _build.launch(lib.rglru_scan_launch, dev, B, S, d, a.data_ptr(),
                        x.data_ptr(), h0.data_ptr(), h_seq.data_ptr(),
                        h_n.data_ptr())
    if err != 0:
        raise RuntimeError("rglru_scan launch failed: "
                           + lib.rglru_scan_error_string(err).decode())
    return h_seq, h_n
