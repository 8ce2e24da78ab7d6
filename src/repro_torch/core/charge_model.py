"""Bitline / sense-amplifier charge model (the SPICE stand-in).

Port of the closed forms of ``repro.core.charge_model``:

    V_cell(d)    = Vdd/2 + (Vdd/2) * exp(-(d / TAU_LEAK)^BETA)
    delta(d)     = COUPLING * (V_cell(d) - Vdd/2)
    t_ready(d)   = T0 + TAU_SA * ln(V_RM / delta(d))
    t_restore(d) = t_ready(d) + RAS_A + RAS_B * (Vdd - V_cell(d))

Computed in float32, operation for operation as the JAX package does:
``ns_to_cycles`` ceils these values, so float64 arithmetic could move a
NUAT bin or an AL-DRAM table entry by one cycle.  The model is host-side
configuration, evaluated on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import timing as timing_lib

VDD = 1.2
VHALF = VDD / 2.0
COUPLING = 0.125          # Cc / (Cc + Cb)
V_READY_MARGIN = 0.25 * VDD  # bitline deviation treated as "ready to access"

# Calibrated to Table 6.1 (see repro.core.charge_model).
TAU_LEAK_MS = 2603.7
BETA = 0.324
T0_NS = -30.2915          # affine offset absorbing wordline rise / overdrive
TAU_SA_NS = 26.1119
RAS_A_NS = 10.6195
RAS_B_NS_PER_V = 66.0217

_F32 = torch.float32


def cell_voltage(idle_ms):
    """Cell voltage after ``idle_ms`` ms of leakage following a PRE."""
    idle_ms = torch.as_tensor(idle_ms, dtype=_F32)
    decay = torch.exp(-torch.pow(torch.clamp(idle_ms, min=0.0) / TAU_LEAK_MS,
                                 BETA))
    return torch.where(idle_ms <= 0.0, torch.tensor(VDD, dtype=_F32),
                       VHALF + VHALF * decay)


def charge_sharing_delta(v_cell):
    return COUPLING * (torch.as_tensor(v_cell, dtype=_F32) - VHALF)


def t_ready_ns(idle_ms):
    """ACT -> ready-to-access time (the tRCD requirement) in ns."""
    delta = charge_sharing_delta(cell_voltage(idle_ms))
    return T0_NS + TAU_SA_NS * torch.log(V_READY_MARGIN / delta)


def t_restore_ns(idle_ms):
    """ACT -> full-restore time (the tRAS requirement) in ns."""
    v = cell_voltage(idle_ms)
    return t_ready_ns(idle_ms) + RAS_A_NS + RAS_B_NS_PER_V * (VDD - v)


@dataclasses.dataclass(frozen=True)
class DerivedTimings:
    duration_ms: float
    tRCD_ns: float
    tRAS_ns: float
    tRCD_cycles: int
    tRAS_cycles: int


def derive_timings(duration_ms: float) -> DerivedTimings:
    """Model-derived lowered timings for a caching duration (Table 6.1)."""
    rcd = float(t_ready_ns(duration_ms))
    ras = float(t_restore_ns(duration_ms))
    return DerivedTimings(
        duration_ms=duration_ms,
        tRCD_ns=rcd,
        tRAS_ns=ras,
        tRCD_cycles=timing_lib.ns_to_cycles(rcd),
        tRAS_cycles=timing_lib.ns_to_cycles(ras),
    )


def derived_table(durations_ms=(1.0, 4.0, 16.0, 64.0)):
    """Reproduce Table 6.1 from the model."""
    return [derive_timings(d) for d in durations_ms]


def lowered_params(duration_ms: float) -> timing_lib.TimingParams:
    """TimingParams with model-derived tRCD/tRAS for ChargeCache hits."""
    d = derive_timings(duration_ms)
    return dataclasses.replace(
        timing_lib.DDR3_1600,
        tRCD=min(d.tRCD_cycles, timing_lib.DDR3_1600.tRCD),
        tRAS=min(d.tRAS_cycles, timing_lib.DDR3_1600.tRAS),
    )
