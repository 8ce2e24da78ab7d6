"""CUDA launcher of the rglru_scan kernel (``csrc/rglru_scan.cu``).

Replaces no Pallas kernel: ``repro.models.rglru``'s gates are XLA
element-wise ops and its recurrence an XLA scan.  Takes the gate GEMMs'
outputs ``r_pre``, ``i_pre`` and the conv output ``u`` (contiguous bf16
``[B, S, d]``, 16-byte aligned, ``d % 8 == 0``: the rows the kernel's TMA
tiles read), ``nsp`` (f32 ``[d]``) and ``h0`` (f32 ``[B, d]``) and
returns new ``h_seq [B, S, d]`` and ``h_S [B, d]`` tensors.  Built on
first use (``repro_torch._build``), launched through ``ctypes`` on
PyTorch's current stream.

Training: ``rglru_scan_bwd`` launches the backward from the forward's
saved ``h_seq``: one kernel (``rglru_scan_bwd_kernel``, the forward's
block walked from the last tile back, the reverse recurrence and the
gates' gradients one tile behind it in the same block, ``dnsp`` summed
in a fixed order across a cluster of batch rows), and for a batch of
more rows than a cluster holds (B > ``ref.CLUSTER_MAX``) a second launch,
the fixed-order sum of the clusters' partials.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _build

__all__ = ["ENTRY", "library", "rglru_scan", "rglru_scan_bwd"]

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
    lib.rglru_scan_smem_bytes.restype = _I
    lib.rglru_scan_smem_bytes.argtypes = []
    lib.rglru_scan_launch.restype = _I
    lib.rglru_scan_launch.argtypes = [_I] * 3 + [_P] * 8
    lib.rglru_scan_bwd_smem_bytes.restype = _I
    lib.rglru_scan_bwd_smem_bytes.argtypes = []
    lib.rglru_scan_bwd_scratch.restype = ctypes.c_longlong
    lib.rglru_scan_bwd_scratch.argtypes = [_I] * 3
    lib.rglru_scan_bwd_launch.restype = _I
    lib.rglru_scan_bwd_launch.argtypes = [_I] * 3 + [_P] * 15
    return lib


def rglru_scan(r_pre: torch.Tensor, i_pre: torch.Tensor, u: torch.Tensor,
               nsp: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (asynchronous on the current stream; a refused
    launch raises); returns new ``h_seq`` and ``h_S`` tensors.  Inputs
    the kernel does not take raise ``ValueError`` before the device is
    looked at: they must be on one device, contiguous, bf16 ``[B, S, d]``
    ``r_pre`` / ``i_pre`` / ``u`` starting 16-byte aligned with ``d % 8 ==
    0`` (a TMA tile's rows), f32 ``[d]`` ``nsp`` and ``[B, d]`` ``h0``."""
    if r_pre.dim() != 3:
        raise ValueError(f"rglru_scan: r_pre must be [B, S, d] (got "
                         f"{tuple(r_pre.shape)})")
    dev = r_pre.device
    B, S, d = r_pre.shape
    for name, t, shape, dtype in (
            ("r_pre", r_pre, (B, S, d), torch.bfloat16),
            ("i_pre", i_pre, (B, S, d), torch.bfloat16),
            ("u", u, (B, S, d), torch.bfloat16),
            ("nsp", nsp, (d,), torch.float32),
            ("h0", h0, (B, d), torch.float32)):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"rglru_scan: {name} must be a contiguous {dtype} {shape} "
                f"tensor on {dev} (got {tuple(t.shape)} {t.dtype} on "
                f"{t.device})")
    if d % 8:
        raise ValueError(f"rglru_scan: d = {d} is not a multiple of 8 (a "
                         f"TMA tile's bf16 rows start 16-byte aligned)")
    for name, t in (("r_pre", r_pre), ("i_pre", i_pre), ("u", u)):
        if t.data_ptr() % 16:
            raise ValueError(f"rglru_scan: {name} does not start 16-byte "
                             f"aligned (TMA reads it)")
    _build.require_cuda(dev, "rglru_scan")
    h_seq = torch.empty((B, S, d), dtype=torch.float32, device=dev)
    h_n = torch.empty((B, d), dtype=torch.float32, device=dev)
    lib = library()
    err = _build.launch(lib.rglru_scan_launch, dev, B, S, d,
                        r_pre.data_ptr(), i_pre.data_ptr(), u.data_ptr(),
                        nsp.data_ptr(), h0.data_ptr(), h_seq.data_ptr(),
                        h_n.data_ptr())
    if err != 0:
        raise RuntimeError("rglru_scan launch failed: "
                           + lib.rglru_scan_error_string(err).decode())
    return h_seq, h_n


def rglru_scan_bwd(r_pre: torch.Tensor, i_pre: torch.Tensor,
                   u: torch.Tensor, nsp: torch.Tensor, h0: torch.Tensor,
                   h_seq: torch.Tensor, dh_seq: torch.Tensor,
                   dh_s: torch.Tensor):
    """Launch the backward (asynchronous; a refused launch raises):
    ``rglru_scan``'s inputs, its ``h_seq`` and the cotangents ``dh_seq``
    [B, S, d], ``dh_s`` [B, d] (contiguous f32; the [B, S, d] tensors
    16-byte aligned, TMA reads them) -> ``(dr_pre, di_pre, du [B, S, d]
    bf16, dnsp [d], dh0 [B, d] f32)``."""
    if r_pre.dim() != 3:
        raise ValueError(f"rglru_scan_bwd: r_pre must be [B, S, d] (got "
                         f"{tuple(r_pre.shape)})")
    dev = r_pre.device
    B, S, d = r_pre.shape
    f32, bf = torch.float32, torch.bfloat16
    for name, t, shape, dtype in (
            ("r_pre", r_pre, (B, S, d), bf), ("i_pre", i_pre, (B, S, d), bf),
            ("u", u, (B, S, d), bf), ("nsp", nsp, (d,), f32),
            ("h0", h0, (B, d), f32), ("h_seq", h_seq, (B, S, d), f32),
            ("dh_seq", dh_seq, (B, S, d), f32), ("dh_s", dh_s, (B, d), f32)):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"rglru_scan_bwd: {name} must be a contiguous {dtype} "
                f"{shape} tensor on {dev} (got {tuple(t.shape)} {t.dtype} "
                f"on {t.device})")
    if d % 8:
        raise ValueError(f"rglru_scan_bwd: d = {d} is not a multiple of 8 "
                         f"(a TMA tile's bf16 rows start 16-byte aligned)")
    for name, t in (("r_pre", r_pre), ("i_pre", i_pre), ("u", u),
                    ("h_seq", h_seq), ("dh_seq", dh_seq)):
        if t.data_ptr() % 16:
            raise ValueError(f"rglru_scan_bwd: {name} does not start "
                             f"16-byte aligned (TMA reads it)")
    _build.require_cuda(dev, "rglru_scan_bwd")
    dr = torch.empty((B, S, d), dtype=bf, device=dev)
    di = torch.empty_like(dr)
    du = torch.empty_like(dr)
    dnsp = torch.empty((d,), dtype=f32, device=dev)
    dh0 = torch.empty((B, d), dtype=f32, device=dev)
    lib = library()
    scratch = torch.empty((lib.rglru_scan_bwd_scratch(B, S, d),), dtype=f32,
                          device=dev)
    err = _build.launch(lib.rglru_scan_bwd_launch, dev, B, S, d,
                        r_pre.data_ptr(), i_pre.data_ptr(), u.data_ptr(),
                        nsp.data_ptr(), h0.data_ptr(), h_seq.data_ptr(),
                        dh_seq.data_ptr(), dh_s.data_ptr(),
                        scratch.data_ptr(), dr.data_ptr(), di.data_ptr(),
                        du.data_ptr(), dnsp.data_ptr(), dh0.data_ptr())
    if err != 0:
        raise RuntimeError("rglru_scan_bwd launch failed: "
                           + lib.rglru_scan_error_string(err).decode())
    return dr, di, du, dnsp, dh0
