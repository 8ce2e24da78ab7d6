"""Shared harness of the thesis's figure scripts (port of
``benchmarks/common.py``).

Workload sizes follow the thesis's methodology (``N_REQ_1C`` requests a
single-core workload, ``N_MIXES`` eight-core mixes of ``N_REQ_8C``
requests a core); every figure takes them as arguments, and ``QUICK``
holds ``repro``'s CI sizes for ``--quick``.  Each grid goes through
``repro_torch.experiment.Experiment``: on the card one ``sim_step``
launch a trace batch and chunk, with ``device="cpu"`` the plain engine.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time

import numpy as np

from repro_torch.core import (HCRACConfig, MechanismConfig, SimConfig,
                              WorkloadSpec, lowered_for_duration,
                              ms_to_cycles, weighted_speedup)
from repro_torch.core.traces import (WORKLOADS, multicore_batch,
                                     random_mixes, single_core_batch)
from repro_torch.experiment import Experiment
from repro_torch.experiment.results import Results

N_REQ_1C = 150_000
N_REQ_8C = 40_000
N_MIXES = 20
#: mixes of the capacity and duration studies (Fig 6.3 / 6.5)
N_SUB_MIXES = 5
SEED = 3

SINGLE_NAMES = tuple(w.name for w in WORKLOADS)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """How much of the thesis's evaluation a figure runs."""
    n_req_1c: int = N_REQ_1C
    n_req_8c: int = N_REQ_8C
    n_mixes: int = N_MIXES
    n_sub_mixes: int = N_SUB_MIXES
    singles: tuple = SINGLE_NAMES
    seed: int = SEED

    def mixes(self) -> list[list[str]]:
        """The eight-core mixes (``random_mixes``' first ``n_mixes``)."""
        return random_mixes(self.n_mixes, 8)

    def sub_mixes(self) -> list[list[str]]:
        return self.mixes()[:self.n_sub_mixes]


THESIS = Sizes()
#: ``repro``'s ``REPRO_BENCH_QUICK`` sizes
QUICK = Sizes(n_req_1c=20_000, n_req_8c=5_000, n_mixes=2, n_sub_mixes=1)


def mech_config(kind: str, n_cores: int = 1, n_entries: int = 128,
                caching_ms: float = 1.0) -> MechanismConfig:
    """Thesis configuration: 128 entries *per core* (Table 5.1); the
    simulator models the aggregate table."""
    return MechanismConfig(
        kind=kind,
        hcrac=HCRACConfig(n_entries=n_entries * n_cores,
                          caching_cycles=ms_to_cycles(caching_ms)),
        lowered=lowered_for_duration(caching_ms),
    )


def sim_cfg(kind: str, n_cores: int = 1, policy: str | None = None,
            **mech_kw) -> SimConfig:
    """One grid point: a full SimConfig for sweep()/simulate()."""
    if policy is None:
        policy = "open" if n_cores == 1 else "closed"
    return SimConfig(mech=mech_config(kind, n_cores, **mech_kw),
                     policy=policy)


@functools.lru_cache(maxsize=None)
def single_batch(name: str, n_req: int, seed: int):
    return single_core_batch(name, n_req, seed=seed)


@functools.lru_cache(maxsize=None)
def mix_batch(names: tuple, n_req: int, seed: int):
    return multicore_batch(list(names), n_req, seed=seed)


def singles_experiment(names, axes: dict, n_req: int = N_REQ_1C,
                       seed: int = SEED, **kw) -> Experiment:
    """The (single-core workload × axes) evaluation matrix as one
    Experiment with a leading ``workload`` dim."""
    traces = {n: single_batch(n, n_req, seed) for n in names}
    kw.setdefault("base", sim_cfg("base", 1))
    return Experiment(traces=traces, axes=axes, trace_dim="workload", **kw)


def mixes_experiment(mixes, axes: dict, n_req: int = N_REQ_8C,
                     seed: int = SEED, **kw) -> Experiment:
    """The (eight-core mix × axes) evaluation matrix as one Experiment;
    Results carry a leading ``mix`` dim (mix00, ...)."""
    traces = {f"mix{i:02d}": mix_batch(tuple(m), n_req, seed)
              for i, m in enumerate(mixes)}
    kw.setdefault("base", sim_cfg("base", 8))
    return Experiment(traces=traces, axes=axes, trace_dim="mix", **kw)


def experiment_singles(names, axes: dict, n_req: int = N_REQ_1C,
                       seed: int = SEED, **kw) -> Results:
    return singles_experiment(names, axes, n_req, seed, **kw).run()


def experiment_mixes(mixes, axes: dict, n_req: int = N_REQ_8C,
                     seed: int = SEED, **kw) -> Results:
    return mixes_experiment(mixes, axes, n_req, seed, **kw).run()


def experiment_synth(axes: dict, n_cores: int = 8, n_req: int = N_REQ_8C,
                     seed: int = SEED, **kw) -> Results:
    """A synthetic (on-device generated) evaluation matrix:
    ``Experiment(traces=None)`` over a workload axis; the base config
    sizes the streams and sets the matching row policy."""
    spec = WorkloadSpec(names=("milc_like",) * n_cores, n_req=n_req,
                        seed=seed)
    base = dataclasses.replace(sim_cfg("base", n_cores), workload=spec)
    return Experiment(traces=None, axes=axes, base=base, **kw).run()


def mech_speedups(res: Results, base: str = "base") -> dict:
    """Mean weighted speedup per mechanism label against ``base``,
    averaged over every other dim of ``res``."""
    sp = res.pairwise(
        "mechanism", base,
        lambda b, s: weighted_speedup(b["core_end"], s["core_end"]))
    return {m: float(np.mean(v)) for m, v in sp.items()}


def timed(fn, *args, **kw):
    t0 = time.time()
    out = fn(*args, **kw)
    return out, (time.time() - t0) * 1e6


def csv_row(name: str, us: float, derived: str) -> str:
    return f"{name},{us:.0f},{derived}"


def main(run, description: str, argv=None) -> None:
    """The command line of a figure: ``run(sizes, device)`` gives its CSV
    rows, printed one a line, then the ``sim_step`` launches it made."""
    from repro_torch.kernels.sim_step import ops
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--quick", action="store_true",
                    help="repro's CI sizes instead of the thesis's")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain engine (default: the card)")
    args = ap.parse_args(argv)
    before = ops.launches
    for row in run(QUICK if args.quick else THESIS, args.device):
        print(row, flush=True)
    print(f"# sim_step launches: {ops.launches - before}")
