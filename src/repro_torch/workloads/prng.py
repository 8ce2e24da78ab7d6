"""Counter-based PRNG of the workload generator (port of
``repro.workloads.prng``).

Every random draw is a pure function ``hash(seed, core, lane, step)`` of
its coordinates: the murmur3 finalizer (fmix32) folded over the key
words with multiply-xor combining, in uint32 arithmetic with wraparound.

PyTorch has no usable uint32 multiply, and an int64 product of two
32-bit words can pass 2**63, so the hash runs on int64 tensors holding
values in ``[0, 2**32)`` and multiplies by a 32-bit constant in two
16-bit halves: ``h * M = h * M_lo + ((h * M_hi) mod 2**16) << 16``
(mod 2**32), where every partial product stays below 2**48.  The
result is bitwise ``repro``'s, including negative int32 words (taken
as their two's-complement bits) and lane constants above 2**31.
"""

from __future__ import annotations

import torch

__all__ = ["hash_u32", "uniform", "lanes"]

_M1 = 0x85EB_CA6B
_M2 = 0xC2B2_AE35
_GOLD = 0x9E37_79B9  # 2**32 / golden ratio: per-word stream separation
_MASK = 0xFFFF_FFFF

#: 1 / 2**24, the float32 uniform quantum (24 high hash bits)
_U24 = 5.9604645e-08


def _mul(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h * m mod 2**32`` for ``h`` in ``[0, 2**32)`` (int64) and a
    32-bit constant ``m``, without passing 2**63."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _word(w, device) -> torch.Tensor:
    if isinstance(w, int):  # lane constants may exceed int32
        return torch.tensor(w & _MASK, dtype=torch.int64, device=device)
    return w.to(torch.int64) & _MASK


def hash_u32(*words) -> torch.Tensor:
    """Mix integer words (Python ints or integer tensors, broadcast
    together) into a uint32 hash, returned as int64 in ``[0, 2**32)``."""
    device = next((w.device for w in words if isinstance(w, torch.Tensor)),
                  None)
    h = torch.tensor((_GOLD * (len(words) + 1)) & _MASK, dtype=torch.int64,
                     device=device)
    for w in words:
        h = _mul(h ^ _word(w, device), _M1)
        h = _mul(h ^ (h >> 15), _M2)
    # fmix32 finalizer
    h = h ^ (h >> 16)
    h = _mul(h, _M1)
    h = h ^ (h >> 13)
    h = _mul(h, _M2)
    return h ^ (h >> 16)


def uniform(*words) -> torch.Tensor:
    """float32 uniform in [0, 1) from the top 24 bits of ``hash_u32``
    (exact: a 24-bit integer times 2**-24)."""
    return (hash_u32(*words) >> 8).to(torch.float32) * _U24


def lanes(n: int) -> tuple[int, ...]:
    """``n`` distinct lane constants (golden-ratio strided) for drawing
    several independent uniforms per (seed, core, step) coordinate."""
    return tuple((_GOLD * (i + 1)) & _MASK for i in range(n))
