"""The serving closed loop at scale (port of
``benchmarks/serving_loop.py``).

Three claims:

1. **One launch, four axes**: a policy x arrival_rate x burstiness x
   mechanism serving grid through ``Experiment(traces=None)`` is one
   launch of the serving entry on the card (asserted), every request
   stream drawn on the device.
2. **Charge-aware admission pays**: the charge predictor lifts the
   admission hot rate over FIFO, averaged over the (rate, burstiness)
   points (asserted).
3. **Throughput**: the serving entry against the host scheduler at
   10**4 and 10**5 requests (every request retires, asserted), and the
   host scheduler (``run_host``, its probes through the HCRAC probe
   kernel on the card) on the same arrival law at 384 requests.

``--json PATH`` writes the grid's numbers, the scale points, the host
baseline and every cell.

::

    python -m repro_torch.figures.serving_loop [--quick] [--device cpu] [--json PATH]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.simulator import SimConfig, simulate_serving
from repro_torch.experiment import Experiment
from repro_torch.figures import common as C
from repro_torch.serving.loop import ServingSpec
from repro_torch.serving.loop.oracle import run_host
from repro_torch.workloads.arrivals import (ArrivalConfig, arrival_params,
                                            step_counts)

POLICIES = ("fifo", "charge_aware", "preempting")
RATES = (1.0, 3.0)
MECHS = ("base", "chargecache")


def spec(n_reqs: int, rate: float = 8.0, max_batch: int = 8,
         policy: str = "charge_aware") -> ServingSpec:
    return ServingSpec(
        policy=policy,
        arrival=ArrivalConfig(rate=rate, burstiness=2.0,
                              prompt_pages_min=1, prompt_pages_max=2,
                              decode_min=4, decode_max=8, seed=11),
        n_reqs=n_reqs, max_batch=max_batch,
        queue_cap=4 * max_batch, arrivals_max=max_batch,
        cycles_per_step=4000,
        hot_entries=1024, hot_ways=2, hot_caching_ms=0.05, hot_exact=True)


def experiment(sizes: C.Sizes = C.THESIS, device=None) -> Experiment:
    base = SimConfig(mech=C.mech_config("base"),
                     serving=spec(sizes.serve_grid_reqs, rate=1.0,
                                  policy="fifo"))
    return Experiment(
        traces=None,
        axes={"policy": list(POLICIES), "arrival_rate": list(RATES),
              "burstiness": list(sizes.serve_bursts),
              "mechanism": list(MECHS)},
        base=base, device=device)


def grid(sizes: C.Sizes = C.THESIS, device=None):
    """The four-axis grid, the whole policy study; returns the Results
    and the kernel launches."""
    return C.launch_counted(experiment(sizes, device).run)


def scale_points(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    """The whole closed loop (arrivals, scheduling, the KV pages' charge
    and the DRAM mechanism) a request at growing stream lengths."""
    out = {}
    for n in sizes.serve_scale:
        sp = spec(n, rate=8.0, max_batch=32)
        res, us = C.timed(simulate_serving, SimConfig(serving=sp),
                          collect_steps=False, device=device)
        if res["retired"] != n:
            raise AssertionError(f"stream must drain: {res['retired']}/{n} "
                                 f"retired")
        out[n] = {"wall_us": us, "us_per_req": us / n,
                  "n_steps": res["n_steps"], "retired": res["retired"],
                  "admit_hot_rate": res["admit_hot_rate"]}
    return out


def host_baseline(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    """The host scheduler on the same arrival law (the parity oracle,
    as a throughput baseline); its counts drawn on the host."""
    n = sizes.serve_host_reqs
    sp = spec(n, rate=8.0, max_batch=32)
    counts = step_counts(arrival_params(sp.arrival, sp.n_reqs),
                         torch.arange(sp.steps(), dtype=torch.int32))
    (sched, _), us = C.timed(run_host, sp, counts.numpy(), device=device)
    if sched.stats["retired"] != n:
        raise AssertionError(f"host scheduler retired "
                             f"{sched.stats['retired']} of {n}")
    return {"wall_us": us, "us_per_req": us / n, "n_reqs": n}


def by_policy(res, sizes: C.Sizes = C.THESIS) -> dict:
    """Per policy over the (rate, burstiness) points, ChargeCache cells:
    the mean admission hot rate and HCRAC hit rate, the preemptions;
    every request of every cell must retire."""
    out = {}
    for pol in POLICIES:
        cells = [res.point(policy=pol, arrival_rate=r, burstiness=b,
                           mechanism="chargecache")
                 for r in RATES for b in sizes.serve_bursts]
        if not all(c["retired"] == sizes.serve_grid_reqs for c in cells):
            raise AssertionError(f"{pol}: not every request retired")
        out[pol] = {
            "admit_hot_rate": float(np.mean(
                [c["admit_hot_rate"] for c in cells])),
            "preempted": int(sum(c["preempted"] for c in cells)),
            "hcrac_hit_rate": float(np.mean(
                [c["hcrac_hit_rate"] for c in cells])),
        }
    return out


def study(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    (res, launches), grid_us = C.timed(grid, sizes, device)
    C.check_launches("the policy x arrival x burstiness x mechanism "
                     "serving grid", res, launches, 1)
    pol = by_policy(res, sizes)
    # claim 2: predicted-charge admission beats FIFO on admission heat
    if not (pol["charge_aware"]["admit_hot_rate"]
            > pol["fifo"]["admit_hot_rate"]):
        raise AssertionError(f"charge-aware admission no hotter than "
                             f"FIFO: {pol}")
    scale = scale_points(sizes, device)
    host = host_baseline(sizes, device)
    big = max(sizes.serve_scale)
    ratio = host["us_per_req"] / max(scale[big]["us_per_req"], 1e-9)
    return {"results": res, "launches": launches, "grid_us": grid_us,
            "by_policy": pol, "scale": scale, "host": host,
            "host_over_traced": ratio}


def document(out: dict) -> dict:
    """``repro``'s ``BENCH_serving.json`` keys (``launches`` in place of
    its compile count)."""
    res = out["results"]
    return {"grid": {"launches": out["launches"], "wall_us": out["grid_us"],
                     "by_policy": out["by_policy"], "meta": res.meta},
            "scale": {str(n): v for n, v in out["scale"].items()},
            "host": out["host"],
            "host_over_traced_us_per_req": out["host_over_traced"],
            "cells": res.to_table()}


def rows(out: dict) -> list[str]:
    pol, scale, host = out["by_policy"], out["scale"], out["host"]
    f_, a_ = pol["fifo"], pol["charge_aware"]
    big = max(scale)
    return [
        C.csv_row(
            "serving_grid", out["grid_us"],
            f"launches={out['launches']}"
            f";points={out['results'].meta['n_points']}"
            f";fifo_hot={f_['admit_hot_rate']:.3f}"
            f";ca_hot={a_['admit_hot_rate']:.3f}"
            f";preempted={pol['preempting']['preempted']}"),
        C.csv_row(
            "serving_scale", scale[big]["wall_us"],
            ";".join(f"N{n}_us_per_req={v['us_per_req']:.2f}"
                     for n, v in scale.items())
            + f";host_us_per_req={host['us_per_req']:.2f}"
            + f";host_over_traced={out['host_over_traced']:.1f}"),
    ]


def run(sizes: C.Sizes = C.THESIS, device=None, json_path=None) -> list[str]:
    out = study(sizes, device)
    C.write_json(json_path, document(out))
    return rows(out)


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0], artifact=True)
