"""On-device workload synthesis, ported (the counterpart of
``repro.workloads``): request streams generated per grid point from a
counter-based PRNG (``prng``), with the workload statistics as tensors
(``profiles``) and addresses composed through the channel-interleave
layer (``repro_torch.core.dram``), and the serving loop's request-arrival
process (``arrivals``).  The streamed entry points, ``sweep_synth`` /
``simulate_synth``, live in ``repro_torch.core.simulator``."""

from repro_torch.core.traces import WorkloadSpec
from repro_torch.workloads import arrivals, prng
from repro_torch.workloads.generator import generate, materialize
from repro_torch.workloads.profiles import (WorkloadParams, max_len_of,
                                            n_segs_of, profile_params,
                                            spec_params)

__all__ = [
    "WorkloadSpec", "WorkloadParams", "generate", "materialize",
    "max_len_of", "n_segs_of", "profile_params", "spec_params", "prng",
    "arrivals",
]
