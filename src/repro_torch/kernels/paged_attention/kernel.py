"""CUDA launcher of the decode-attention kernel
(``csrc/paged_attention.cu``).

Replaces ``repro/kernels/paged_attention/kernel.py::decode_attention_kernel``.
The kernel reads the model's ``[B, W, K, hd]`` ring cache through strides
(no transposed copy, no padding of ``W``; rows 16-byte aligned), the slot
positions through a batch stride (0 for the model's one row shared by
the batch) and ``q_pos`` likewise; ``hd <= 256``, any ``G = H / K``; bf16
on the tensor cores, f32 on the CUDA cores.  For bf16 it splits the ring
into chunks (``plan_split``) so that enough blocks cover the card; with
more than one chunk a second, small kernel combines the chunks' partials
from f32 scratch allocated here.  The library counts the launches of each
kernel where it makes them (``launch_counts``).  Built on first use
(``repro_torch._build``), launched through ``ctypes`` on PyTorch's
current stream.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch import _build
from repro_torch.kernels.flash_attention.kernel import (DTYPES, MAX_HD,
                                                        check_inputs,
                                                        rows_aligned)

__all__ = ["TILE", "GROUP_TILE", "MMA_ENTRY", "COMBINE_ENTRY", "COUNTERS",
           "library", "launch_counts", "group_tiles", "plan_split",
           "decode_attention"]

#: cache slots a tile; a chunk of the split is a multiple of it
TILE = 64
#: the name of the bf16 (tensor-core) kernel, as it appears in the built
#: library's symbols and in a profiler's kernel names
MMA_ENTRY = "paged_attention_mma_kernel"
#: the kernel that combines the chunks' partials
COMBINE_ENTRY = "paged_attention_combine_kernel"
#: the library's counters, in the order ``paged_attention_counts`` writes
#: them: launches of the f32 kernel, of the bf16 kernel, the chunks of
#: those bf16 launches summed, launches of the combine
COUNTERS = ("paged_attention_kernel", MMA_ENTRY, "mma_chunks",
            COMBINE_ENTRY)
#: query heads a block at most (the rows of a tensor-core tile; G is
#: tiled across blocks)
GROUP_TILE = 16
#: blocks the split aims for, per SM: several resident on an SM keep
#: enough tiles' loads in flight to cover device-memory latency
BLOCKS_PER_SM = 4

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
        [_I] * 10 + [_P] + [_P, _L, _L, _L] * 2
        + [_P, _L, _P, _L, _P, _P, _P, _I, ctypes.c_float, _P])
    lib.paged_attention_counts.restype = None
    lib.paged_attention_counts.argtypes = [_P, _I]
    return lib


def launch_counts(reset: bool = False) -> dict[str, int]:
    """``{counter: n}`` (``COUNTERS``): the kernels' launches since the
    last reset, as the library counts them where it launches each; zeroes
    the counters after reading them if ``reset``."""
    out = (ctypes.c_longlong * len(COUNTERS))()
    library().paged_attention_counts(out, int(reset))
    return dict(zip(COUNTERS, out))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def group_tiles(G: int) -> tuple[int, int]:
    """``(n_gt, gts)``: G query heads as ``n_gt`` blocks of ``gts <=
    GROUP_TILE`` heads, as even as can be."""
    n_gt = -(-G // GROUP_TILE)
    return n_gt, -(-G // n_gt)


def plan_split(W: int, blocks: int, sms: int) -> tuple[int, int]:
    """``(n_split, chunk)`` for a ring of ``W`` slots over ``blocks``
    blocks a chunk: chunks of whole ``TILE``-slot tiles, as many as bring
    the grid to ``BLOCKS_PER_SM * sms`` blocks and no more than there are
    tiles (so one chunk, and no combine, at ``W <= TILE``)."""
    tiles = -(-W // TILE)
    want = -(-BLOCKS_PER_SM * sms // blocks)
    chunk = TILE * -(-tiles // max(1, min(tiles, want)))
    return -(-W // chunk), chunk


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
            or not q.is_contiguous()):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} (contiguous) and caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not fit (H "
            f"a multiple of K, hd <= {MAX_HD})")
    if not all(map(rows_aligned, (q, k_cache, v_cache))):
        raise ValueError("decode_attention: q and the caches need 16-byte "
                         "rows (hd and every stride a multiple of 16 bytes, "
                         "the data 16-byte aligned)")
    for name, x in (("kv_pos", kv_pos), ("q_pos", q_pos)):
        if x.device != dev:
            raise ValueError(f"decode_attention: {name} must be on {dev}")
    pos_sb = _batch_stride(kv_pos, B, W, "kv_pos")
    if (q_pos.dtype != torch.int32 or not q_pos.is_contiguous()
            or q_pos.numel() not in (1, B)):
        raise ValueError(f"decode_attention: q_pos must be int32 [1] or "
                         f"[{B}] (got {tuple(q_pos.shape)} {q_pos.dtype})")
    qpos_sb = 1 if q_pos.numel() == B else 0
    G = H // K
    n_gt, gts = group_tiles(G)
    # f32 takes the one-pass CUDA-core kernel: one chunk, no combine
    n_split, chunk = (plan_split(W, B * K * n_gt, _sm_count(dev.index))
                      if dtype == torch.bfloat16 else (1, W))
    if n_split > 65535 or B * K * n_gt >= 2 ** 31:
        raise ValueError(f"decode_attention: a grid of {B * K * n_gt} x "
                         f"{n_split} blocks exceeds CUDA's limits")
    o = torch.empty((B, H, hd), dtype=dtype, device=dev)
    part_acc = part_ml = None
    if n_split > 1:   # one f32 scratch: acc [B*H, n_split, hd], then (m, l)
        part = torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                           device=dev)
        part_acc = part.data_ptr()
        part_ml = part_acc + 4 * B * H * n_split * hd
    lib = library()
    err = _build.launch(
        lib.paged_attention_launch, dev, DTYPES[dtype], B, W, K, G, hd,
        n_gt, gts, chunk, n_split, q.data_ptr(), k_cache.data_ptr(),
        *k_cache.stride()[:3], v_cache.data_ptr(), *v_cache.stride()[:3],
        kv_pos.data_ptr(), pos_sb, q_pos.data_ptr(), qpos_sb, o.data_ptr(),
        part_acc, part_ml, int(window),
        1.0 / math.sqrt(hd))
    if err != 0:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.paged_attention_error_string(err).decode())
    return o
