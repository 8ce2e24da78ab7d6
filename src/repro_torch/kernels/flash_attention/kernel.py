"""CUDA launcher of the flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_kernel``.
The kernel reads the model's ``[B, S, H, hd]`` / ``[B, Skv, K, hd]``
layout through strides (no transposed or padded copy) and writes a new
``[B, S, H, hd]`` tensor; ``hd <= 256``.  bf16 runs on Hopper's
``wgmma`` fed by TMA (``MMA_ENTRY``: a block of two warpgroups per 128
query rows, every head dim in one block, ``kernels/include/
wgmma_tma.cuh``) and needs 16-byte rows (``hd`` and every stride a
multiple of 8, 16-byte aligned data), f32 on the CUDA cores.  The C
launcher picks the key tile (64 or 128 keys, ``fwd_chunks``; mirrored by
``ref.kv_chunks``) and encodes the tensor maps at every call; a failed
query of the card's SM count is returned as a launch error.  The library
is built on first use (``repro_torch._build``) and launched through
``ctypes`` on PyTorch's current stream.

Training (bf16, ``hd <= BWD_MAX_HD``): ``flash_attention_lse`` runs the
same forward and also writes each query row's log-sum-exp and the
output's low halves (the f32 output less its bf16 rounding, in bf16);
``flash_attention_bwd_dot``, ``flash_attention_bwd_dkdv`` and
``flash_attention_bwd_dq`` launch the backward's three entries; where a
KV head serves several query heads, ``flash_attention_bwd_dkdv`` also
launches ``flash_attention_bwd_sum``, which adds the group's per-head
dK / dV partials (no atomics, every sum in a fixed order:
deterministic).  The dK / dV and dQ entries run on Hopper's ``wgmma``
fed by TMA (``kernels/include/wgmma_tma.cuh``); dS enters the dQ
product as two bf16 operands (hi + lo).  D's entry gives each query row
``hd / 8`` lanes (16-byte loads) and sums them by a fixed butterfly.  No Pallas kernel of
``repro`` has a backward; these stand in for XLA's differentiation of
``repro``'s ``layers.blocked_attention``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch import _build

__all__ = ["DTYPES", "MAX_HD", "BWD_MAX_HD", "MMA_ENTRY", "bind", "library",
           "rows_aligned", "flash_attention", "lse_rows",
           "flash_attention_lse", "flash_attention_bwd_dot",
           "flash_attention_bwd_dkdv", "flash_attention_bwd_dkdv_entry",
           "flash_attention_bwd_sum", "flash_attention_bwd_dq"]

#: input dtypes the kernel takes, and their codes in the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest head dim
MAX_HD = 256
#: the name of the bf16 forward kernel, as it appears in the built
#: library's symbols and in a profiler's kernel names (template arguments
#: ``<HDP, NK, LSE>``: HDP the head dim rounded up to 64, 128, 192 or
#: 256, NK the 64-key chunks of a key tile, ``LSE`` false for serving,
#: true for training)
MMA_ENTRY = "flash_fwd_wgmma_kernel"
#: largest head dim of the training entries (LSE forward and backward;
#: above 128 the dK / dV and dQ entries' two warpgroups split the output
#: dims of one 64-row tile)
BWD_MAX_HD = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the flash-attention library."""
    return bind(_build.load("flash_attention", Path(__file__).parent / "csrc"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C entries' result and argument types set (a build
    of ``csrc/flash_attention.cu``, this tree's or an earlier one with
    the same signatures)."""
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_launch.restype = _I
    lib.flash_attention_launch.argtypes = (
        [_I] * 7 + [_P, _L, _L, _L] * 4 + [_I, _I, ctypes.c_float, _P])
    lib.flash_attention_lse_launch.restype = _I
    lib.flash_attention_lse_launch.argtypes = (
        [_I] * 6 + [_P, _L, _L, _L] * 4 + [_I, _I, ctypes.c_float, _P, _L,
                                           _P, _P])
    lib.flash_bwd_dot_launch.restype = _I
    lib.flash_bwd_dot_launch.argtypes = (
        [_I] * 4 + [_P, _L, _L, _L] * 3 + [_P, _L, _P])
    lib.flash_bwd_dkdv_launch.restype = _I
    lib.flash_bwd_dkdv_launch.argtypes = (
        [_I] * 6 + [_P, _L, _L, _L] * 4 + [_P, _P, _L]
        + [_P, _L, _L, _L] * 2 + [_P, _P, _I, _I, ctypes.c_float, _P])
    lib.flash_bwd_sum_launch.restype = _I
    lib.flash_bwd_sum_launch.argtypes = (
        [_I] * 5 + [_P, _P] + [_P, _L, _L, _L] * 2 + [ctypes.c_float, _P])
    lib.flash_bwd_dq_launch.restype = _I
    lib.flash_bwd_dq_launch.argtypes = (
        [_I] * 6 + [_P, _L, _L, _L] * 4 + [_P, _P, _L]
        + [_P, _L, _L, _L] + [_I, _I, ctypes.c_float, _P])
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


def lse_rows(S: int) -> int:
    """The row stride of the LSE and D buffers: ``S`` rounded up to 64
    (the backward reads a tile's rows in 16-byte groups)."""
    return -(-S // 64) * 64


def _check_train(what: str, q, k, v) -> tuple:
    """The training entries' input checks; returns ``(B, S, Skv, H, K,
    hd)``."""
    dev = q.device
    _build.require_cuda(dev, what)
    check_inputs(what, dev, ("q", q, 4), ("k", k, 4), ("v", v, 4))
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the training entries take bf16 (got "
                         f"{q.dtype})")
    if hd > BWD_MAX_HD:
        raise ValueError(f"{what}: head dim {hd} is above the backward "
                         f"kernel's limit of {BWD_MAX_HD}")
    if (k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape or H % K
            or not all(map(rows_aligned, (q, k, v)))):
        raise ValueError(f"{what}: q {tuple(q.shape)} and k / v "
                         f"{tuple(k.shape)} / {tuple(v.shape)} do not fit "
                         "(H a multiple of K, 16-byte bf16 rows)")
    return B, S, Skv, H, K, hd


def _raise(lib, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.flash_attention_error_string(err).decode())


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int):
    """The bf16 forward of ``flash_attention`` (hd <= ``BWD_MAX_HD``),
    also writing each query row's log-sum-exp of its scaled, masked
    scores and the output's low halves: returns ``(o [B, S, H, hd], lse
    [B, H, lse_rows(S)] f32, o_lo [B, S, H, hd] bf16)``, ``lse[..., :S]``
    written (natural log), ``o + o_lo`` the f32 output to 2^-17 of it.
    ``lse`` and ``o_lo`` are views of one buffer (the kernel writes the
    low halves after the LSE rows)."""
    B, S, Skv, H, K, hd = _check_train("flash_attention_lse", q, k, v)
    dev = q.device
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    rows = lse_rows(S)
    n_lse = B * H * rows
    buf = torch.empty(n_lse + B * S * H * hd // 2, dtype=torch.float32,
                      device=dev)
    lse = buf[:n_lse].view(B, H, rows)
    o_lo = buf[n_lse:].view(torch.bfloat16).view(B, S, H, hd)
    lib = library()
    err = _build.launch(
        lib.flash_attention_lse_launch, dev, B, S, Skv, H, K, hd,
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], o.data_ptr(), *o.stride()[:3],
        int(causal), int(window), 1.0 / math.sqrt(hd), lse.data_ptr(), rows,
        o_lo.data_ptr())
    _raise(lib, "flash_attention_lse", err)
    return o, lse, o_lo


def flash_attention_bwd_dot(o: torch.Tensor, o_lo: torch.Tensor,
                            do: torch.Tensor, rows: int) -> torch.Tensor:
    """``D = rowsum(do * (o + o_lo))`` of the LSE forward's bf16 output
    ``o``, its low halves ``o_lo`` and the output's gradient ``do`` [B,
    S, H, hd], f32 ``[B, H, rows]`` (``[..., :S]`` written)."""
    dev = o.device
    _build.require_cuda(dev, "flash_attention_bwd_dot")
    check_inputs("flash_attention_bwd_dot", dev, ("o", o, 4),
                 ("o_lo", o_lo, 4), ("do", do, 4))
    B, S, H, hd = o.shape
    if (do.shape != o.shape or o_lo.shape != o.shape
            or not all(t.dtype == torch.bfloat16 for t in (o, o_lo, do))
            or not all(map(rows_aligned, (o, o_lo, do)))):
        raise ValueError("flash_attention_bwd_dot: o, o_lo and do must be "
                         "bf16 of one shape with 16-byte rows")
    dlt = torch.empty((B, H, rows), dtype=torch.float32, device=dev)
    lib = library()
    err = _build.launch(lib.flash_bwd_dot_launch, dev, B, S, H, hd,
                        o.data_ptr(), *o.stride()[:3], o_lo.data_ptr(),
                        *o_lo.stride()[:3], do.data_ptr(),
                        *do.stride()[:3], dlt.data_ptr(), rows)
    _raise(lib, "flash_attention_bwd_dot", err)
    return dlt


def _bwd_args(q, k, v, do, lse, dlt):
    if (do.shape != q.shape or do.dtype != q.dtype or not rows_aligned(do)
            or lse.shape != dlt.shape or lse.dtype != torch.float32
            or dlt.dtype != torch.float32 or not lse.is_contiguous()
            or not dlt.is_contiguous() or lse.shape[-1] % 64
            or lse.shape[:2] != (q.shape[0], q.shape[2])):
        raise ValueError("flash attention backward: do must match q; lse "
                         "and D f32 [B, H, rows], rows a multiple of 64")
    return (q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], do.data_ptr(), *do.stride()[:3],
            lse.data_ptr(), dlt.data_ptr(), lse.shape[-1])


def flash_attention_bwd_dkdv(q, k, v, do, lse, dlt, *, causal: bool,
                             window: int):
    """``(dk, dv, summed)``: dK and dV [B, Skv, K, hd] bf16 from the dK /
    dV entry, a block per (batch, query head, 128 keys; 64 above hd 128).
    Where a KV head serves several query heads (H > K) the entry writes
    each head's f32 partials and ``flash_attention_bwd_sum`` adds them up by group;
    ``summed`` says whether that second launch was made."""
    parts = flash_attention_bwd_dkdv_entry(q, k, v, do, lse, dlt,
                                           causal=causal, window=window)
    if q.shape[2] == k.shape[2]:
        return (*parts, False)
    return (*flash_attention_bwd_sum(*parts, k.shape[2]), True)


def flash_attention_bwd_dkdv_entry(q, k, v, do, lse, dlt, *,
                                   causal: bool, window: int):
    """The dK / dV entry's launch alone (``flash_attention_bwd_dkdv``
    less the group sum, for timing it): where H == K ``(dk, dv)`` [B,
    Skv, K, hd] bf16, else each query head's f32 sums ``(dk_part,
    dv_part)`` [B, Skv, H, hd], dK not yet scaled by 1/sqrt(hd)."""
    B, S, Skv, H, K, hd = _check_train("flash_attention_bwd_dkdv", q, k, v)
    args = _bwd_args(q, k, v, do, lse, dlt)
    if H == K:
        dk = torch.empty_like(k, memory_format=torch.contiguous_format)
        dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        outs = (dk.data_ptr(), *dk.stride()[:3], dv.data_ptr(),
                *dv.stride()[:3], None, None)
    else:
        dk = torch.empty((B, Skv, H, hd), dtype=torch.float32,
                         device=q.device)
        dv = torch.empty_like(dk)
        outs = (None, 0, 0, 0, None, 0, 0, 0, dk.data_ptr(), dv.data_ptr())
    lib = library()
    err = _build.launch(
        lib.flash_bwd_dkdv_launch, q.device, B, S, Skv, H, K, hd, *args,
        *outs, int(causal), int(window), 1.0 / math.sqrt(hd))
    _raise(lib, "flash_attention_bwd_dkdv", err)
    return dk, dv


def flash_attention_bwd_sum(dk_part: torch.Tensor, dv_part: torch.Tensor,
                            n_kv_heads: int):
    """``(dk, dv)`` [B, Skv, K, hd] bf16 from the partials of
    ``flash_attention_bwd_dkdv_entry`` (``K = n_kv_heads``): each group's
    H / K heads summed in head order, dK scaled by 1/sqrt(hd), each
    rounded once."""
    dev = dk_part.device
    _build.require_cuda(dev, "flash_attention_bwd_sum")
    B, Skv, H, hd = dk_part.shape
    K = n_kv_heads
    if (dv_part.shape != dk_part.shape or H % K
            or not all(t.dtype == torch.float32 and t.is_contiguous()
                       and t.device == dev for t in (dk_part, dv_part))):
        raise ValueError("flash_attention_bwd_sum: dk_part and dv_part must "
                         "be contiguous f32 [B, Skv, H, hd] on one device, "
                         "H a multiple of n_kv_heads")
    dk = torch.empty((B, Skv, K, hd), dtype=torch.bfloat16, device=dev)
    dv = torch.empty_like(dk)
    lib = library()
    err = _build.launch(
        lib.flash_bwd_sum_launch, dev, B, Skv, H, K, hd, dk_part.data_ptr(),
        dv_part.data_ptr(), dk.data_ptr(), *dk.stride()[:3], dv.data_ptr(),
        *dv.stride()[:3], 1.0 / math.sqrt(hd))
    _raise(lib, "flash_attention_bwd_sum", err)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, dlt, *, causal: bool,
                           window: int) -> torch.Tensor:
    """``dq`` [B, S, H, hd] bf16: the dQ entry, a block per (batch, head,
    128 query rows; 64 above hd 128) over the key tiles, dS entering ``dQ
    += dS K`` as bf16 hi + lo."""
    B, S, Skv, H, K, hd = _check_train("flash_attention_bwd_dq", q, k, v)
    args = _bwd_args(q, k, v, do, lse, dlt)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = library()
    err = _build.launch(
        lib.flash_bwd_dq_launch, q.device, B, S, Skv, H, K, hd, *args,
        dq.data_ptr(), *dq.stride()[:3], int(causal), int(window),
        1.0 / math.sqrt(hd))
    _raise(lib, "flash_attention_bwd_dq", err)
    return dq
