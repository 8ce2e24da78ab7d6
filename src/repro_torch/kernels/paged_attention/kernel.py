"""CUDA launcher of the decode-attention kernel
(``csrc/paged_attention.cu``).

Replaces ``repro/kernels/paged_attention/kernel.py::decode_attention_kernel``.
The kernel reads the model's ``[B, W, K, hd]`` ring cache through strides
(no transposed copy, no padding of ``W``), the slot positions through a
batch stride (0 for the model's one row shared by the batch) and
``q_pos`` likewise; ``hd <= 128``, ``G = H / K <= 32``, bf16 or f32.
Built on first use (``repro_torch._build``), launched through ``ctypes``
on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch import _build
from repro_torch.kernels.flash_attention.kernel import (DTYPES, MAX_HD,
                                                        check_inputs)

__all__ = ["library", "decode_attention"]

#: largest query group (warps a block)
MAX_G = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the decode-attention library."""
    lib = _build.load("paged_attention", Path(__file__).parent / "csrc")
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    lib.paged_attention_error_string.argtypes = [_I]
    lib.paged_attention_launch.restype = _I
    lib.paged_attention_launch.argtypes = (
        [_I] * 6 + [_P] + [_P, _L, _L, _L] * 2 + [_P, _L, _P, _L, _P, _I,
                                                  ctypes.c_float, _P])
    return lib


def _batch_stride(x: torch.Tensor, B: int, tail: int, name: str) -> int:
    """The batch stride of an int32 ``[tail]`` (0: shared by the batch)
    or ``[B, tail]`` tensor with a contiguous last dim."""
    if x.dtype != torch.int32 or x.stride(-1) != 1 or x.shape[-1] != tail:
        raise ValueError(f"decode_attention: {name} must be int32 [{tail}] "
                         f"or [B, {tail}] (got {tuple(x.shape)} {x.dtype})")
    if x.dim() == 1:
        return 0
    if x.dim() == 2 and x.shape[0] == B:
        return x.stride(0)
    raise ValueError(f"decode_attention: {name} must be [{tail}] or "
                     f"[{B}, {tail}] (got {tuple(x.shape)})")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_pos: torch.Tensor,
                     q_pos: torch.Tensor, *, window: int) -> torch.Tensor:
    """Launch the kernel on the rotated queries ``q [B, H, hd]``, the
    caches ``[B, W, K, hd]``, int32 ``kv_pos [W]`` or ``[B, W]`` (-1 marks
    an empty slot) and int32 ``q_pos [1]`` or ``[B]``, all on one CUDA
    device; returns ``[B, H, hd]`` in q's dtype (asynchronous on the
    current stream; a refused launch raises)."""
    dev = q.device
    _build.require_cuda(dev, "decode_attention")
    dtype = check_inputs("decode_attention", dev, ("q", q, 3),
                         ("k_cache", k_cache, 4), ("v_cache", v_cache, 4))
    B, H, hd = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != hd
            or v_cache.shape != k_cache.shape or H % K or hd > MAX_HD
            or H // K > MAX_G or not q.is_contiguous()):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} (contiguous) and caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not fit (H "
            f"a multiple of K, H / K <= {MAX_G}, hd <= {MAX_HD})")
    for name, x in (("kv_pos", kv_pos), ("q_pos", q_pos)):
        if x.device != dev:
            raise ValueError(f"decode_attention: {name} must be on {dev}")
    pos_sb = _batch_stride(kv_pos, B, W, "kv_pos")
    if (q_pos.dtype != torch.int32 or not q_pos.is_contiguous()
            or q_pos.numel() not in (1, B)):
        raise ValueError(f"decode_attention: q_pos must be int32 [1] or "
                         f"[{B}] (got {tuple(q_pos.shape)} {q_pos.dtype})")
    qpos_sb = 1 if q_pos.numel() == B else 0
    o = torch.empty((B, H, hd), dtype=dtype, device=dev)
    lib = library()
    err = _build.launch(
        lib.paged_attention_launch, dev, DTYPES[dtype], B, W, K, H // K, hd,
        q.data_ptr(), k_cache.data_ptr(), *k_cache.stride()[:3],
        v_cache.data_ptr(), *v_cache.stride()[:3], kv_pos.data_ptr(),
        pos_sb, q_pos.data_ptr(), qpos_sb, o.data_ptr(), int(window),
        1.0 / math.sqrt(hd))
    if err != 0:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.paged_attention_error_string(err).decode())
    return o
