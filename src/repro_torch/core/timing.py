"""DDR3 timing parameters and derived (lowered) parameter sets.

Port of ``repro.core.timing``.  All timings are in DRAM *bus cycles*
(DDR3-1600 -> 800 MHz bus, 1.25 ns per cycle), Table 5.1 of the thesis
(tRCD/tRAS = 11/28 cycles).  ``TimingVec`` is the tensor view: one int32
tensor per field, 0-d for one configuration or ``[G]`` for a stacked
sweep grid.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

CYCLE_NS = 1.25  # DDR3-1600: 800 MHz bus clock


@dataclasses.dataclass(frozen=True)
class TimingParams:
    """DRAM timing parameters in bus cycles."""

    tRCD: int = 11   # ACT -> READ/WRITE
    tRAS: int = 28   # ACT -> PRE
    tRP: int = 11    # PRE -> ACT
    tCL: int = 11    # READ -> first data
    tCWL: int = 8    # WRITE -> first data
    tBL: int = 4     # burst length on the data bus (BL8 @ DDR)
    tRTP: int = 6    # READ -> PRE
    tWR: int = 12    # end of write burst -> PRE
    #: rank-level ACT spacing: read only by the FR-FCFS controller tier,
    #: which this package does not carry yet; kept so the record matches
    tRRD: int = 6    # ACT -> ACT, same rank (7.5 ns)
    tFAW: int = 32   # four-ACT window per rank (40 ns)
    tREFI: int = 6240   # refresh interval (7.8 us)
    tRFC: int = 208     # refresh cycle time (260 ns, 4 Gb device)
    n_refresh_groups: int = 8192  # rows refreshed per retention window

    @property
    def tRC(self) -> int:
        return self.tRAS + self.tRP

    @property
    def retention_cycles(self) -> int:
        """Full retention / refresh window (64 ms)."""
        return self.tREFI * self.n_refresh_groups

    def with_reduction(self, d_rcd: int, d_ras: int) -> "TimingParams":
        return dataclasses.replace(
            self, tRCD=max(1, self.tRCD - d_rcd), tRAS=max(1, self.tRAS - d_ras)
        )


class TimingVec(NamedTuple):
    """Tensor view of ``TimingParams``: same field names, each an int32
    tensor (0-d per configuration, ``[G]`` once a grid is stacked)."""
    tRCD: torch.Tensor
    tRAS: torch.Tensor
    tRP: torch.Tensor
    tCL: torch.Tensor
    tCWL: torch.Tensor
    tBL: torch.Tensor
    tRTP: torch.Tensor
    tWR: torch.Tensor
    tRRD: torch.Tensor
    tFAW: torch.Tensor
    tREFI: torch.Tensor
    tRFC: torch.Tensor
    n_refresh_groups: torch.Tensor
    retention_cycles: torch.Tensor


def traced(tp: TimingParams) -> TimingVec:
    """The tensor view of a concrete ``TimingParams`` (0-d int32 leaves)."""
    return TimingVec(*(torch.tensor(getattr(tp, f), dtype=torch.int32)
                       for f in TimingVec._fields))


#: Baseline DDR3-1600 timings (Table 5.1).
DDR3_1600 = TimingParams()

#: ChargeCache-lowered timings at the default 1 ms caching duration
#: (Table 5.1: tRCD/tRAS reduction of 4/8 cycles).
DDR3_1600_CC_1MS = DDR3_1600.with_reduction(4, 8)


def ns_to_cycles(ns: float) -> int:
    """Quantize a nanosecond timing to (ceil) bus cycles."""
    return int(math.ceil(ns / CYCLE_NS - 1e-9))


def ms_to_cycles(ms: float) -> int:
    return int(round(ms * 1e6 / CYCLE_NS))


def cycles_to_ms(cycles: float) -> float:
    return cycles * CYCLE_NS / 1e6


#: Table 6.1 of the thesis (SPICE-derived ns values): caching duration
#: (ms) -> (tRCD ns, tRAS ns); the baseline row is the DDR3 spec.
TABLE_6_1 = {
    None: (13.75, 35.0),
    1.0: (8.0, 22.0),
    4.0: (9.0, 24.0),
    16.0: (11.0, 28.0),
}


def lowered_for_duration(duration_ms: float) -> TimingParams:
    """Lowered TimingParams for a caching duration, per Table 6.1.

    Durations between published points use the next-larger published
    duration (conservative).  Durations > 16 ms fall back to baseline.
    """
    for d in (1.0, 4.0, 16.0):
        if duration_ms <= d + 1e-9:
            rcd_ns, ras_ns = TABLE_6_1[d]
            return dataclasses.replace(
                DDR3_1600, tRCD=ns_to_cycles(rcd_ns), tRAS=ns_to_cycles(ras_ns)
            )
    return DDR3_1600
