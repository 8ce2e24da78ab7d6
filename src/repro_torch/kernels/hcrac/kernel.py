"""CUDA launcher of the HCRAC probe kernel (``csrc/hcrac.cu``).

Replaces ``repro/kernels/hcrac/kernel.py::hcrac_lookup_kernel``: one
thread per query, 256 a block, the ragged last block masked by a bounds
check (no padding of the queries).  The static ``HCRACConfig`` values
(sets, ways, caching duration, sweep period, expiry flavour) are the
launch's arguments, as they are the Pallas kernel's.  The library is
built on first use (``repro_torch._build``) and launched through
``ctypes`` on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _build
from repro_torch.core.hcrac import HCRACConfig

#: threads per block
BLOCK = 256

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the probe library."""
    lib = _build.load("hcrac", Path(__file__).parent / "csrc")
    lib.hcrac_error_string.restype = ctypes.c_char_p
    lib.hcrac_error_string.argtypes = [_I]
    lib.hcrac_lookup_launch.restype = _I
    lib.hcrac_lookup_launch.argtypes = [_I] * 7 + [_P] * 6
    return lib


def hcrac_lookup(cfg: HCRACConfig, tags: torch.Tensor, itime: torch.Tensor,
                 gids: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Launch the probe of int32 ``gids [Q]`` at ``times [Q]`` against
    the int32 ``[sets, ways]`` table ``tags`` / ``itime``; returns the
    int32 hits ``[Q]`` (asynchronous on the current stream; a refused
    launch raises)."""
    dev = gids.device
    _build.require_cuda(dev, "hcrac_lookup")
    S, W = cfg.n_sets, cfg.n_ways
    for name, x, shape in (("gids", gids, None), ("times", times, None),
                           ("tags", tags, (S, W)), ("itime", itime, (S, W))):
        if (x.device != dev or x.dtype != torch.int32
                or not x.is_contiguous()
                or (shape is not None and tuple(x.shape) != shape)):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}" + (f" of shape {shape}" if shape
                                         else ""))
    Q = gids.shape[0]
    if gids.dim() != 1 or times.shape != gids.shape:
        raise ValueError("gids and times must be [Q] alike")
    hits = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q == 0:
        return hits
    lib = library()
    err = _build.launch(
        lib.hcrac_lookup_launch, dev, Q, S, W, cfg.caching_cycles,
        cfg.sweep_period, int(cfg.exact_expiry), BLOCK, gids.data_ptr(),
        times.data_ptr(), tags.data_ptr(), itime.data_ptr(), hits.data_ptr())
    if err != 0:
        raise RuntimeError("hcrac_lookup launch failed: "
                           + lib.hcrac_error_string(err).decode())
    return hits
