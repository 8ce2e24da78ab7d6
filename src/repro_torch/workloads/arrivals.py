"""Request-arrival process of the serving loop (port of
``repro.workloads.arrivals``).

Arrivals are drawn from the counter-based PRNG (``prng``), so the count
at step ``t`` is a pure function of ``(seed, t)`` and a whole grid of
arrival processes runs batched.  The model is a two-state ON/OFF burst
process:

* each scheduler step is independently ON with probability
  ``1 / burstiness`` (``burstiness = 1``: always ON);
* an ON step draws a geometric batch with mean ``rate * burstiness``,
  so the long-run mean is ``rate`` requests a step for every
  burstiness — the knob moves variance, not load.

Request attributes (prompt pages, decode length) are integer hashes of
the request index, bitwise ``repro``'s.  The counts take a float32
``log1p`` / ``log``, which differ by about an ulp between XLA and
PyTorch, so a rare count can differ from ``repro``'s (the ON/OFF gate
cannot: it is an exact uniform).  ``reference_counts`` is an independent
``np.random`` implementation of the same model, for statistical tests.

The params are ``[G]`` tensors in a batched launch (0-d for one
configuration); ``step_counts`` and ``request_attrs`` broadcast them
against their index arguments.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.workloads import prng

__all__ = ["ArrivalConfig", "ArrivalParams", "arrival_params",
           "step_counts", "request_attrs", "reference_counts"]

# independent lane constants for the arrival stream's draws
_L_ON, _L_COUNT, _L_PROMPT, _L_DECODE = prng.lanes(4)

_F32 = torch.float32
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """Host-side arrival-process description (hashable)."""
    rate: float = 2.0          # mean requests per scheduler step
    burstiness: float = 1.0    # >= 1; 1 = smooth, higher = bursty ON/OFF
    prompt_pages_min: int = 1  # KV pages per prompt (inclusive range)
    prompt_pages_max: int = 8
    decode_min: int = 16       # decode tokens per request (inclusive)
    decode_max: int = 64
    seed: int = 0

    def __post_init__(self):
        if not self.rate > 0.0:
            raise ValueError("arrival rate must be > 0")
        if not self.burstiness >= 1.0:
            raise ValueError("burstiness must be >= 1")
        if not 1 <= self.prompt_pages_min <= self.prompt_pages_max:
            raise ValueError("need 1 <= prompt_pages_min <= prompt_pages_max")
        if not 1 <= self.decode_min <= self.decode_max:
            raise ValueError("need 1 <= decode_min <= decode_max")


class ArrivalParams(NamedTuple):
    """The arrival process as tensors (``[G]``-stacked in a sweep)."""
    rate: torch.Tensor        # float32
    burstiness: torch.Tensor  # float32
    prompt_lo: torch.Tensor   # int32
    prompt_hi: torch.Tensor   # int32 (inclusive)
    decode_lo: torch.Tensor   # int32
    decode_hi: torch.Tensor   # int32 (inclusive)
    seed: torch.Tensor        # int32
    n_reqs: torch.Tensor      # int32: request budget of the stream


def arrival_params(cfg: ArrivalConfig, n_reqs: int,
                   device=None) -> ArrivalParams:
    """``cfg`` as 0-d tensors on ``device``."""
    f = lambda v: torch.tensor(v, dtype=_F32, device=device)
    i = lambda v: torch.tensor(v, dtype=_I32, device=device)
    return ArrivalParams(
        rate=f(cfg.rate), burstiness=f(cfg.burstiness),
        prompt_lo=i(cfg.prompt_pages_min), prompt_hi=i(cfg.prompt_pages_max),
        decode_lo=i(cfg.decode_min), decode_hi=i(cfg.decode_max),
        seed=i(cfg.seed), n_reqs=i(n_reqs))


def step_counts(p: ArrivalParams, steps) -> torch.Tensor:
    """Arrivals drawn at step indices ``steps`` (int32) -> int32, with
    ``p``'s leaves broadcast against ``steps``.

    ON/OFF gate ``uniform * b < 1`` with ``b = max(burstiness, 1)``; an
    ON step draws ``floor(log1p(-u) / log(q))``, ``q = clip(m / (1 + m),
    1e-9, 1 - 1e-6)``, ``m = rate * b``: geometric over 0, 1, 2, ... with
    mean ``m``.  Every float operation is a float32 tensor operation, so
    each rounds once, as in ``repro``.
    """
    steps = torch.as_tensor(steps).to(_I32)
    dev = steps.device
    one = torch.tensor(1.0, dtype=_F32, device=dev)
    b = torch.maximum(p.burstiness, one)
    on = prng.uniform(p.seed, _L_ON, steps) * b < one
    m = p.rate * b
    q = torch.clamp(m / (one + m),
                    torch.tensor(np.float32(1e-9), device=dev),
                    torch.tensor(np.float32(1.0 - 1e-6), device=dev))
    u = prng.uniform(p.seed, _L_COUNT, steps)
    n = torch.floor(torch.log1p(-u) / torch.log(q)).to(_I32)
    return torch.where(on, n, torch.zeros_like(n))


def request_attrs(p: ArrivalParams, i) -> tuple[torch.Tensor, torch.Tensor]:
    """Attributes of request index ``i`` -> ``(prompt_pages, decode)``,
    both int32: the uint32 hash modulo the inclusive span, plus the low
    end (integer only, bitwise ``repro``'s)."""
    i = torch.as_tensor(i).to(_I32)
    pspan = (p.prompt_hi - p.prompt_lo + 1).to(torch.int64) & 0xFFFF_FFFF
    dspan = (p.decode_hi - p.decode_lo + 1).to(torch.int64) & 0xFFFF_FFFF
    pages = p.prompt_lo + (prng.hash_u32(p.seed, _L_PROMPT, i)
                           % pspan).to(_I32)
    decode = p.decode_lo + (prng.hash_u32(p.seed, _L_DECODE, i)
                            % dspan).to(_I32)
    return pages, decode


def reference_counts(cfg: ArrivalConfig, n_steps: int,
                     seed: int = 0) -> np.ndarray:
    """Independent ``np.random`` implementation of the ON/OFF model: the
    statistical oracle for ``step_counts`` (mean rate, burst CDF)."""
    rng = np.random.default_rng(seed)
    on = rng.random(n_steps) < 1.0 / cfg.burstiness
    m = cfg.rate * cfg.burstiness
    q = m / (1.0 + m)
    # geometric over {0,1,...}: numpy's is over {1,2,...} with p=1-q
    n = rng.geometric(1.0 - q, n_steps) - 1
    return np.where(on, n, 0).astype(np.int64)
