"""CUDA launcher of the flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_kernel``.
The kernel reads the model's ``[B, S, H, hd]`` / ``[B, Skv, K, hd]``
layout through strides (no transposed or padded copy) and writes a new
``[B, S, H, hd]`` tensor; ``hd <= 256`` (above 128 each query tile's
output dims are split over two blocks, ``mma_tile.cuh::out_split``).
bf16 runs on the tensor cores (``mma.sync``) and needs 16-byte rows
(``hd`` and every stride a multiple of 8, 16-byte aligned data), f32 on
the CUDA cores.  The library
is built on first use (``repro_torch._build``) and launched through
``ctypes`` on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch import _build

__all__ = ["DTYPES", "MAX_HD", "MMA_ENTRY", "library", "rows_aligned",
           "flash_attention"]

#: input dtypes the kernel takes, and their codes in the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest head dim
MAX_HD = 256
#: the name of the bf16 (tensor-core) kernel, as it appears in the built
#: library's symbols and in a profiler's kernel names
MMA_ENTRY = "flash_attention_mma_kernel"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the flash-attention library."""
    lib = _build.load("flash_attention", Path(__file__).parent / "csrc")
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_launch.restype = _I
    lib.flash_attention_launch.argtypes = (
        [_I] * 7 + [_P, _L, _L, _L] * 4 + [_I, _I, ctypes.c_float, _P])
    return lib


def check_inputs(what: str, dev: torch.device, *named) -> torch.dtype:
    """Raise unless every ``(name, tensor, dims)`` lies on ``dev``, has
    ``dims`` dims, a contiguous last dim and one dtype of ``DTYPES``;
    returns that dtype."""
    dtype = named[0][1].dtype
    for name, x, dims in named:
        if (x.device != dev or x.dtype != dtype or x.dim() != dims
                or x.stride(-1) != 1 or dtype not in DTYPES):
            raise ValueError(
                f"{what}: {name} must be a {dims}-d bf16 or f32 tensor on "
                f"{dev} with a contiguous last dim, of one dtype with the "
                f"others (got {tuple(x.shape)} {x.dtype} on {x.device})")
    return dtype


def rows_aligned(x: torch.Tensor) -> bool:
    """Whether every row of ``x``'s last dim starts on 16 bytes: the data
    16-byte aligned and every stride a multiple of 16 bytes (the bf16
    path's 16-byte copies)."""
    size = x.element_size()
    return (x.data_ptr() % 16 == 0 and x.shape[-1] * size % 16 == 0
            and all(st * size % 16 == 0 for st in x.stride()[:-1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int) -> torch.Tensor:
    """Launch the kernel on q ``[B, S, H, hd]``, k / v ``[B, Skv, K,
    hd]`` (CUDA, one dtype); returns the ``[B, S, H, hd]`` output in that
    dtype (asynchronous on the current stream; a refused launch raises).
    Query and key positions are ``arange(S)`` and ``arange(Skv)``."""
    dev = q.device
    _build.require_cuda(dev, "flash_attention")
    dtype = check_inputs("flash_attention", dev, ("q", q, 4), ("k", k, 4),
                         ("v", v, 4))
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape
            or H % K or hd > MAX_HD):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k / v "
                         f"{tuple(k.shape)} / {tuple(v.shape)} do not fit "
                         f"(H a multiple of K, hd <= {MAX_HD})")
    if dtype == torch.bfloat16 and not all(map(rows_aligned, (q, k, v))):
        raise ValueError("flash_attention: bf16 q / k / v need 16-byte rows "
                         "(hd and every stride a multiple of 8, the data "
                         "16-byte aligned)")
    o = torch.empty((B, S, H, hd), dtype=dtype, device=dev)
    lib = library()
    err = _build.launch(
        lib.flash_attention_launch, dev, DTYPES[dtype], B, S, Skv, H, K, hd,
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], o.data_ptr(), *o.stride()[:3],
        int(causal), int(window), 1.0 / math.sqrt(hd))
    if err != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    return o
