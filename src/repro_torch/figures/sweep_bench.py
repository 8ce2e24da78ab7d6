"""The batched sweep engine: launch once, run many (port of
``benchmarks/sweep_bench.py``).

Runs a capacity x duration grid (20 points) through one ``sweep()`` call
and reports (a) the cold call (the kernel library loaded from
``build/kernels/``, built there first if it is not, then the run), (b)
the warm call (the run only) and (c) the cost a grid point.  Each call is
one ``sim_step`` launch on the card (asserted), and the two calls' HCRAC
hit counts are equal (asserted).

::

    python -m repro_torch.figures.sweep_bench [--quick] [--device cpu]
"""

from __future__ import annotations

from repro_torch.core import sweep
from repro_torch.core.traces import single_core_batch
from repro_torch.figures import common as C

CAPS = (32, 64, 128, 512, 1024)
DURATIONS_MS = (1.0, 2.0, 4.0, 16.0)
WORKLOAD = "soplex_like"
SEED = 11


def grid() -> list:
    return [C.sim_cfg("chargecache", 1, n_entries=cap, caching_ms=d)
            for cap in CAPS for d in DURATIONS_MS]


def study(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    batch = single_core_batch(WORKLOAD, sizes.sweep_req, seed=SEED)
    g = grid()
    want = 0 if device == "cpu" else 1
    (res_cold, n_cold), us_cold = C.timed(C.launch_counted, sweep, batch, g,
                                          device=device)
    (res_warm, n_warm), us_warm = C.timed(C.launch_counted, sweep, batch, g,
                                          device=device)
    if (n_cold, n_warm) != (want, want):
        raise AssertionError(f"expected {want} launch a sweep call, saw "
                             f"{n_cold} (cold) and {n_warm} (warm)")
    if len(res_cold) != len(g):
        raise AssertionError(f"{len(res_cold)} results for {len(g)} points")
    # the warm run must be deterministic
    if any(int(a["hcrac_hits"]) != int(b["hcrac_hits"])
           for a, b in zip(res_cold, res_warm)):
        raise AssertionError("the cold and warm calls' HCRAC hits differ")
    return {"cold": res_cold, "warm": res_warm, "us_cold": us_cold,
            "us_warm": us_warm, "launches": n_cold + n_warm,
            "points": len(g)}


def rows(out: dict) -> list[str]:
    g, warm = out["points"], out["warm"]
    hit_lo = warm[0]["hcrac_hit_rate"]
    hit_hi = warm[-len(DURATIONS_MS)]["hcrac_hit_rate"]
    return [
        C.csv_row("sweep_grid_cold", out["us_cold"],
                  f"points={g};launches={out['launches'] // 2}"
                  f";us_per_point={out['us_cold'] / g:.0f}"),
        C.csv_row("sweep_grid_warm", out["us_warm"],
                  f"points={g};us_per_point={out['us_warm'] / g:.0f}"
                  f";hit_32e={hit_lo:.3f};hit_1024e={hit_hi:.3f}"),
    ]


def run(sizes: C.Sizes = C.THESIS, device=None) -> list[str]:
    return rows(study(sizes, device))


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0])
