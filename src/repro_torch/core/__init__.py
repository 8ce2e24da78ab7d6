"""ChargeCache core, ported: DRAM timing simulator (trace-driven and
over on-device synthetic streams), HCRAC, charge model, traces (the
counterpart of ``repro.core``)."""

from repro_torch.core.timing import (TimingParams, TimingVec, DDR3_1600,
                                     DDR3_1600_CC_1MS, lowered_for_duration,
                                     ms_to_cycles, ns_to_cycles, CYCLE_NS)
from repro_torch.core.dram import (DRAMConfig, DDR3_SYSTEM, DRAMEnvelope,
                                   GeomParams, INTERLEAVE_KINDS,
                                   InterleaveConfig, InterleaveParams,
                                   NO_ROW, compose_address, envelope_of,
                                   geom_params, interleave_params)
from repro_torch.core.aldram import ALDRAMConfig, ThermalConfig
from repro_torch.core.hcrac import HCRACConfig, HCRACParams, HCRACState
from repro_torch.core.simulator import (MechanismConfig, MechParams,
                                        REDUCE_KEYS, SimConfig, SimShape,
                                        mech_params, params_from_numpy,
                                        sim_shape, simulate, simulate_synth,
                                        sweep, sweep_synth, sweep_traces,
                                        weighted_speedup,
                                        default_nuat_bins, RLTL_EDGES_MS)
from repro_torch.core.traces import WorkloadSpec
from repro_torch.core import (aldram, charge_model, energy, mechanisms,
                              rltl, traces)

__all__ = [
    "ALDRAMConfig", "ThermalConfig", "aldram", "TimingParams", "TimingVec",
    "DDR3_1600", "DDR3_1600_CC_1MS", "lowered_for_duration", "ms_to_cycles",
    "ns_to_cycles", "CYCLE_NS", "DRAMConfig", "DDR3_SYSTEM", "DRAMEnvelope",
    "GeomParams", "INTERLEAVE_KINDS", "InterleaveConfig", "InterleaveParams",
    "NO_ROW", "compose_address", "envelope_of", "geom_params",
    "interleave_params",
    "HCRACConfig", "HCRACParams", "HCRACState", "MechanismConfig",
    "MechParams", "REDUCE_KEYS", "SimConfig", "SimShape", "mech_params",
    "params_from_numpy", "sim_shape", "simulate", "simulate_synth", "sweep",
    "sweep_synth", "sweep_traces", "WorkloadSpec",
    "weighted_speedup", "default_nuat_bins", "RLTL_EDGES_MS",
    "charge_model", "energy", "mechanisms", "rltl", "traces",
]
