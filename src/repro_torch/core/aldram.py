"""AL-DRAM per-bank timing margins (Lee et al., arXiv:1805.03047).

Port of ``repro.core.aldram`` (numpy, host-side configuration).

AL-DRAM is the complementary lever to ChargeCache: instead of lowering
timings for *recently accessed* rows, it profiles each DRAM module and
lowers the timings of every access according to the module's actual
margin — which depends on operating **temperature** (the DDR3 spec
guardbands the worst case, 85°C) and on **process variation** (each
bank's weakest cells bound how much of the thermal margin is safe).

The margin model reuses the thesis's bitline charge model
(``repro.core.charge_model``, DESIGN.md §9): cell leakage roughly
doubles every ``LEAKAGE_DOUBLING_C`` degrees, so a cell refreshed every
64 ms at temperature ``T`` holds the charge a *reference-temperature*
cell holds after ``64 * 2**((T - 85) / 10)`` ms — and the safe
tRCD/tRAS at ``T`` are the charge model's timings at that equivalent
age, clipped to the spec.  At 85°C the equivalent age is the full
retention window and the model returns the spec values: AL-DRAM at the
reference temperature is *exactly* the baseline (tested bitwise).

Per-bank variation: a deterministic per-bank penalty (a hash of
``(process_seed, bank)`` — the module's process bin) gives part of the
thermal margin back to the bank's weak cells.  The table is
position-stable: bank ``b``'s timings depend only on ``(config, b)``,
never on the table length, so a table padded to a grid's
``DRAMEnvelope`` agrees with the exact-geometry table on every bank the
simulator can address (the §8 masking invariant).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.core import charge_model
from repro_torch.core.timing import TimingParams, ms_to_cycles

#: DDR3 spec guardband temperature: the margin vanishes here by design.
TEMP_REFERENCE_C = 85.0
#: Leakage doubles (margin halves) roughly every 10°C [Liu+ ISCA'13].
LEAKAGE_DOUBLING_C = 10.0
#: Standard retention / refresh window the spec guardbands (64 ms).
RETENTION_MS = 64.0
#: The AL-DRAM evaluation's operating-temperature bins.
TEMPERATURE_BINS_C = (55.0, 70.0, 85.0)


@dataclasses.dataclass(frozen=True)
class ALDRAMConfig:
    """One profiled module: an operating temperature plus a process bin.

    Hashable (it is part of the experiment runner's dedup key); every
    numeric consequence — the per-bank tRCD/tRAS table — is derived
    on demand by ``per_bank_timings``.
    """
    temperature_c: float = 55.0   # AL-DRAM's headline operating point
    process_seed: int = 0         # module identity (per-bank variation)
    weak_penalty_max: int = 2     # cycles a weak bank gives back, tRCD
    weak_ras_factor: int = 2      # tRAS penalty = factor * tRCD penalty


def equivalent_idle_ms(temperature_c: float) -> float:
    """Reference-temperature cell age with the same charge deficit as a
    refresh-deadline cell at ``temperature_c`` (leakage-rate scaling)."""
    return RETENTION_MS * 2.0 ** (
        (temperature_c - TEMP_REFERENCE_C) / LEAKAGE_DOUBLING_C)


def module_timings(ald: ALDRAMConfig,
                   timing: TimingParams) -> tuple[int, int]:
    """Module-average safe (tRCD, tRAS) cycles at the config's
    temperature, before per-bank variation; clipped to the spec."""
    d = charge_model.derive_timings(equivalent_idle_ms(ald.temperature_c))
    return (min(d.tRCD_cycles, timing.tRCD),
            min(d.tRAS_cycles, timing.tRAS))


def _bank_penalty(seed: int, n_banks: int, max_penalty: int) -> np.ndarray:
    """Deterministic per-bank weak-cell penalty in ``[0, max_penalty]``.

    A splitmix-style mix of ``(seed, bank)`` — a pure function of the
    bank *index*, so the table prefix is identical at any padded length.
    """
    if max_penalty <= 0:
        return np.zeros(n_banks, np.int64)
    h = np.arange(n_banks, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    h += np.uint64((seed + 1) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF)
    h ^= h >> np.uint64(31)
    h *= np.uint64(0x94D049BB133111EB)
    h ^= h >> np.uint64(29)
    return (h % np.uint64(max_penalty + 1)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ThermalConfig:
    """A piecewise-constant temperature schedule along the stream.

    ``points`` is a sorted tuple of ``(start_ms, temperature_c)``
    segments; the first segment must start at 0 ms.  Empty ``points``
    means *no drift*: the module sits at its static
    ``ALDRAMConfig.temperature_c`` and every drift branch in the
    simulator is gated off, so a no-drift point is bitwise identical to
    the pre-drift engine (DESIGN.md §14).  Hashable — it rides the
    experiment runner's dedup key inside ``MechanismConfig``.
    """
    points: tuple = ()   # ((start_ms, temp_c), ...)

    def __post_init__(self):
        pts = tuple((float(ms), float(tc)) for ms, tc in self.points)
        object.__setattr__(self, "points", pts)
        if pts:
            assert pts[0][0] == 0.0, "first thermal segment must start at 0 ms"
            starts = [ms for ms, _ in pts]
            assert starts == sorted(starts), "thermal segments must be sorted"

    @property
    def n_segs(self) -> int:
        return len(self.points)

    def temps(self) -> tuple:
        return tuple(tc for _, tc in self.points)


class ThermalParams(NamedTuple):
    """Traced half of a thermal schedule: per-segment start cycles and
    leak-rate multipliers ``2**((T - 85) / 10)``, padded to the grid-wide
    segment count ``S`` (``seg_edge`` padded with ``2**30`` so padded
    segments are never selected).  ``S == 0`` leaves are the static
    no-drift gate: the simulator skips segment selection entirely."""
    enable: object       # bool scalar — this point drifts
    seg_edge: object     # i32 [S] segment start cycles
    seg_leak: object     # f32 [S] leak-rate multiplier per segment


def thermal_leak_scale(temperature_c: float) -> float:
    """Leak-rate multiplier vs the 85°C guardband: the same doubling law
    as ``equivalent_idle_ms``, applied to the running leak clock."""
    return 2.0 ** ((temperature_c - TEMP_REFERENCE_C) / LEAKAGE_DOUBLING_C)


def thermal_params_np(th: ThermalConfig, n_segs: int):
    """Numpy leaves of one point's ``ThermalParams``, padded to the
    grid-wide ``n_segs`` (position-stable: real segments first, padding
    starts at the never-reached cycle ``2**30`` and repeats the last
    real leak scale)."""
    S = int(n_segs)
    edge = np.full(S, np.int32(2**30), np.int32)
    leak = np.ones(S, np.float32)
    for i, (ms, tc) in enumerate(th.points):
        edge[i] = np.int32(ms_to_cycles(ms))
        leak[i:] = np.float32(thermal_leak_scale(tc))
    return np.asarray(th.n_segs > 0), edge, leak


def per_bank_timings(ald: ALDRAMConfig, timing: TimingParams,
                     n_banks: int) -> tuple[np.ndarray, np.ndarray]:
    """The profiled per-bank timing table: ``(tRCD[n_banks],
    tRAS[n_banks])`` int64 arrays, each in ``[1, spec]``.

    Position-stable in ``n_banks`` (see module docstring): entries past
    a grid point's active ``banks_total`` are present only because the
    block is padded to the shared ``DRAMEnvelope`` — ``fold_address``
    bounds every simulated bank id below the active count, so they are
    never read (DESIGN.md §9).
    """
    rcd0, ras0 = module_timings(ald, timing)
    pen = _bank_penalty(ald.process_seed, n_banks, ald.weak_penalty_max)
    rcd = np.minimum(rcd0 + pen, timing.tRCD)
    ras = np.minimum(ras0 + ald.weak_ras_factor * pen, timing.tRAS)
    return np.maximum(rcd, 1), np.maximum(ras, 1)
