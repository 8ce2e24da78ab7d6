"""The serving closed loop: scheduling policy against the DRAM
mechanism, end to end (port of ``benchmarks/serving_trace.py``).

The policy x mechanism study runs on the serving entry of ``sim_step``
(arrivals, admission, the KV pages' charge and the DRAM mechanism in one
launch a chunk).  The host scheduler is kept as the parity oracle: a
pinned arrival schedule is replayed through both (``run_host``, its
probes through the HCRAC probe kernel on the card, against
``simulate_serving``) and their per-step occupancy, retirement and hot-
probe counts must be equal before the study's numbers are reported.

::

    python -m repro_torch.figures.serving_trace [--quick] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.simulator import SimConfig, simulate_serving
from repro_torch.experiment import Experiment
from repro_torch.figures import common as C
from repro_torch.serving.loop import ServingSpec
from repro_torch.serving.loop.oracle import run_host
from repro_torch.workloads.arrivals import ArrivalConfig

POLICIES = ("fifo", "charge_aware")
MECHS = ("base", "chargecache")


def spec(sizes: C.Sizes = C.THESIS, policy: str = "fifo") -> ServingSpec:
    return ServingSpec(
        policy=policy,
        arrival=ArrivalConfig(rate=1.5, burstiness=1.0,
                              prompt_pages_min=1, prompt_pages_max=2,
                              decode_min=4, decode_max=12, seed=7),
        n_reqs=sizes.trace_reqs, max_batch=8, queue_cap=128,
        arrivals_max=4, n_steps=sizes.trace_steps, cycles_per_step=4000,
        hot_entries=1018, hot_ways=2, hot_caching_ms=0.05, hot_exact=True)


def pinned_counts(sizes: C.Sizes = C.THESIS) -> np.ndarray:
    return np.random.default_rng(42).integers(
        0, 4, size=sizes.trace_steps).astype(np.int32)


def host_parity(sizes: C.Sizes = C.THESIS, device=None) -> bool:
    """Replay a pinned schedule through the host oracle and the serving
    entry; exact agreement gates the study's numbers."""
    counts = pinned_counts(sizes)
    sp = spec(sizes, "fifo")
    res = simulate_serving(SimConfig(serving=sp), counts=counts,
                           device=device)
    sched, occ_host = run_host(sp, counts, device=device)
    checks = {
        "retired": res["retired"] == sched.stats["retired"],
        "occ": np.array_equal(np.asarray(res["steps"]["occ"]), occ_host),
        "admit_probes": res["admit_probes"] == sched.stats["admit_probes"],
        "admit_hot": res["admit_hot"] == sched.stats["admit_hot"]}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"host scheduler and serving entry differ in "
                             f"{bad}")
    return True


def experiment(sizes: C.Sizes = C.THESIS, device=None) -> Experiment:
    return Experiment(
        traces=None,
        axes={"policy": list(POLICIES), "mechanism": list(MECHS)},
        base=SimConfig(mech=C.mech_config("base"), serving=spec(sizes)),
        device=device)


def study(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    def work():
        parity = host_parity(sizes, device)
        res, launches = C.launch_counted(experiment(sizes, device).run)
        C.check_launches("the policy x mechanism serving grid", res,
                         launches)
        out = {"parity": parity, "results": res, "launches": launches}
        for policy in res.coords["policy"]:
            base = res.point(policy=policy, mechanism="base")
            cc = res.point(policy=policy, mechanism="chargecache")
            out[policy] = {
                "hot_frac": cc["admit_hot_rate"],
                "cc_hit": cc["hcrac_hit_rate"],
                # the serving clock is a fixed tick, so the DRAM win
                # shows up as access latency, not elapsed cycles
                "lat_ratio": base["avg_latency"] / max(cc["avg_latency"],
                                                       1e-9),
            }
        return out

    out, us = C.timed(work)
    return {**out, "us": us}


def rows(out: dict) -> list[str]:
    f, a = out["fifo"], out["charge_aware"]
    return [C.csv_row(
        "serving_closed_loop", out["us"],
        f"parity={int(out['parity'])}"
        f";fifo:hit={f['cc_hit']:.3f}/lat={f['lat_ratio']:.4f}"
        f"/hot={f['hot_frac']:.3f}"
        f";charge_aware:hit={a['cc_hit']:.3f}/lat={a['lat_ratio']:.4f}"
        f"/hot={a['hot_frac']:.3f}")]


def run(sizes: C.Sizes = C.THESIS, device=None) -> list[str]:
    return rows(study(sizes, device))


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0])
