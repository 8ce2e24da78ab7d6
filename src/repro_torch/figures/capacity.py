"""Fig 6.3 + 6.4: HCRAC hit rate and speedup vs capacity (port of
``benchmarks/capacity.py``).

Paper claims: 128 entries -> 38% (1c) / 66% (8c) hit rate; speedup 8.8%
at 128 entries, 10.6% at 1024 (8-core); diminishing beyond.

The whole (workload × mechanism × capacity) grid is one Experiment; the
runner dedups the capacity-independent baseline.
"""

from __future__ import annotations

from repro_torch.core import weighted_speedup
from repro_torch.figures import common as C

CAPS = (32, 64, 128, 512, 1024)
SINGLE_AXES = {"mechanism": ["chargecache"], "capacity": CAPS}
# Table 5.1: 128 entries *per core* -> the aggregate table the simulator
# models is capacity x 8 (the coord label stays per-core)
EIGHT_AXES = {"mechanism": ["base", "chargecache"],
              "capacity": [(cap, cap * 8) for cap in CAPS]}


def single_hits(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    res = C.experiment_singles(sizes.singles, SINGLE_AXES, sizes.n_req_1c,
                               sizes.seed, device=device)
    cc = res.sel(mechanism="chargecache")
    return {"hits": {cap: float(cc.sel(capacity=cap)
                                .metric("hcrac_hit_rate").mean())
                     for cap in CAPS}, "results": res}


def eight(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    res = C.experiment_mixes(sizes.sub_mixes(), EIGHT_AXES, sizes.n_req_8c,
                             sizes.seed, device=device)
    ws = lambda b, s: weighted_speedup(b["core_end"], s["core_end"])
    hits, speed = {}, {}
    for cap in CAPS:
        at_cap = res.sel(capacity=cap)
        hits[cap] = float(at_cap.sel(mechanism="chargecache")
                          .metric("hcrac_hit_rate").mean())
        speed[cap] = float(at_cap.pairwise("mechanism", "base", ws)
                           ["chargecache"].mean())
    return {"hits": hits, "speed": speed, "results": res}


def rows(h1: dict, us1: float, e8: dict, us8: float) -> list[str]:
    return [
        C.csv_row("hitrate_fig6.3_single", us1,
                  ";".join(f"{c}e={v:.3f}" for c, v in h1["hits"].items())),
        C.csv_row("hitrate_fig6.3_eight", us8,
                  ";".join(f"{c}e={v:.3f}" for c, v in e8["hits"].items())),
        C.csv_row("speedup_fig6.4_capacity", 0,
                  ";".join(f"{c}e={v:.4f}"
                           for c, v in e8["speed"].items()))]


def run(sizes: C.Sizes = C.THESIS, device=None) -> list[str]:
    h1, us1 = C.timed(single_hits, sizes, device)
    e8, us8 = C.timed(eight, sizes, device)
    return rows(h1, us1, e8, us8)


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0])
