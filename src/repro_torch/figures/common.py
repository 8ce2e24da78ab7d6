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
    """How much of the thesis's evaluation a figure or study runs.

    The first six fields size the figures; the rest are the simulator-
    side studies' own knobs (``repro``'s full sizes, ``QUICK`` its
    ``REPRO_BENCH_QUICK`` ones): ``sweep_req`` (``sweep_bench``),
    ``scaling_lens`` (``workloads``' length scaling), ``trace_reqs`` /
    ``trace_steps`` (``serving_trace``), ``serve_grid_reqs``,
    ``serve_bursts``, ``serve_scale`` and ``serve_host_reqs``
    (``serving_loop``), ``megasweep`` (its grid sizes).
    """
    n_req_1c: int = N_REQ_1C
    n_req_8c: int = N_REQ_8C
    n_mixes: int = N_MIXES
    n_sub_mixes: int = N_SUB_MIXES
    singles: tuple = SINGLE_NAMES
    seed: int = SEED
    sweep_req: int = 40_000
    scaling_lens: tuple = (5000, 20000, 60000)
    trace_reqs: int = 96
    trace_steps: int = 320
    serve_grid_reqs: int = 256
    serve_bursts: tuple = (1.0, 4.0)
    serve_scale: tuple = (10_000, 100_000)
    serve_host_reqs: int = 384
    megasweep: tuple = (10_000, 100_000)

    def mixes(self) -> list[list[str]]:
        """The eight-core mixes (``random_mixes``' first ``n_mixes``)."""
        return random_mixes(self.n_mixes, 8)

    def sub_mixes(self) -> list[list[str]]:
        return self.mixes()[:self.n_sub_mixes]


THESIS = Sizes()
#: ``repro``'s ``REPRO_BENCH_QUICK`` sizes
QUICK = Sizes(n_req_1c=20_000, n_req_8c=5_000, n_mixes=2, n_sub_mixes=1,
              sweep_req=5_000, scaling_lens=(1500, 3000), trace_reqs=32,
              trace_steps=120, serve_grid_reqs=64, serve_bursts=(1.0,),
              serve_scale=(1_000, 5_000), serve_host_reqs=96,
              megasweep=(2_000, 10_000))


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


def synth_experiment(axes: dict, n_cores: int = 8, n_req: int = N_REQ_8C,
                     seed: int = SEED, **kw) -> Experiment:
    """A synthetic (on-device generated) evaluation matrix:
    ``Experiment(traces=None)`` over ``axes``; the base config's
    ``milc_like`` spec sizes the streams (a workload axis may replace
    it) and its row policy matches the core count."""
    spec = WorkloadSpec(names=("milc_like",) * n_cores, n_req=n_req,
                        seed=seed)
    base = dataclasses.replace(sim_cfg("base", n_cores), workload=spec)
    return Experiment(traces=None, axes=axes, base=base, **kw)


def experiment_synth(axes: dict, n_cores: int = 8, n_req: int = N_REQ_8C,
                     seed: int = SEED, **kw) -> Results:
    return synth_experiment(axes, n_cores, n_req, seed, **kw).run()


def mech_speedups(res: Results, base: str = "base") -> dict:
    """Mean weighted speedup per mechanism label against ``base``,
    averaged over every other dim of ``res``."""
    sp = res.pairwise(
        "mechanism", base,
        lambda b, s: weighted_speedup(b["core_end"], s["core_end"]))
    return {m: float(np.mean(v)) for m, v in sp.items()}


def launch_counted(fn, *args, **kw):
    """Run ``fn`` and count the CUDA launches it made across the
    simulator's entries (``sim_step``, ``sim_synth``, ``sim_serve``,
    ``sim_window``): the port's counterpart of ``repro``'s
    ``compile_counted``.  Returns ``(fn's output, launches)``."""
    from repro_torch.kernels.sim_step import ops

    def total():
        return (ops.launches + ops.synth_launches + ops.serve_launches
                + ops.window_launches)
    before = total()
    out = fn(*args, **kw)
    return out, total() - before


def check_launches(what: str, res: Results, launches: int,
                   per_launch: int | None = None) -> None:
    """A study's launch promise: on the card the launches equal the
    runner's plan (``res.meta["n_kernel_launches"]``: one a trace batch
    and chunk) and, where given, ``per_launch``; on the CPU none."""
    planned = res.meta["n_kernel_launches"]
    on_card = res.meta["device"].startswith("cuda")
    want = (planned if per_launch is None else per_launch) if on_card else 0
    if launches != want or (on_card and launches != planned):
        raise AssertionError(
            f"{what}: {launches} kernel launches on {res.meta['device']}, "
            f"expected {want} (the runner planned {planned})")


def write_json(path, doc: dict) -> None:
    """A study's JSON document, written only where ``--json PATH`` says
    (never by default: the artifacts are not the checkout's)."""
    if path is None:
        return
    import json
    import os
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)


def timed(fn, *args, **kw):
    t0 = time.time()
    out = fn(*args, **kw)
    return out, (time.time() - t0) * 1e6


def csv_row(name: str, us: float, derived: str) -> str:
    return f"{name},{us:.0f},{derived}"


def main(run, description: str, argv=None, artifact: bool = False) -> None:
    """The command line of a figure or study: ``run(sizes, device)`` gives
    its CSV rows, printed one a line, then the launches it made of each
    ``sim_step.cu`` entry.  With ``artifact``, ``--json PATH``
    passes ``json_path=PATH`` to ``run`` for its JSON document."""
    from repro_torch.kernels.sim_step import ops
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--quick", action="store_true",
                    help="repro's CI sizes instead of the thesis's")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain engine (default: the card)")
    if artifact:
        ap.add_argument("--json", default=None, metavar="PATH",
                        help="write the study's JSON document to PATH")
    args = ap.parse_args(argv)
    kw = {"json_path": args.json} if artifact else {}
    counts = lambda: (("sim_step", ops.launches),
                      ("sim_window", ops.window_launches),
                      ("sim_synth", ops.synth_launches),
                      ("sim_serve", ops.serve_launches))
    before = dict(counts())
    for row in run(QUICK if args.quick else THESIS, args.device, **kw):
        print(row, flush=True)
    for entry, n in counts():
        print(f"# {entry} launches: {n - before[entry]}")
