"""Fig 6.5 / Table 6.1: speedup and hit rate vs caching duration (port
of ``benchmarks/duration.py``).

Paper claim: 1 ms is the best duration — longer durations gain little hit
rate but lose timing reduction (Table 6.1's tRCD/tRAS grow with duration).

``duration_ms`` is a named axis (it sets both the HCRAC expiry and the
Table 6.1 lowered timings); the baseline dedups across it.
"""

from __future__ import annotations

from repro_torch.core import weighted_speedup
from repro_torch.figures import common as C

DURATIONS_MS = (1.0, 4.0, 16.0)
AXES = {"mechanism": ["base", "chargecache"], "duration_ms": DURATIONS_MS}


def work(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    res = C.experiment_mixes(sizes.sub_mixes(), AXES, sizes.n_req_8c,
                             sizes.seed, device=device)
    ws = lambda b, s: weighted_speedup(b["core_end"], s["core_end"])
    out = {}
    for d in DURATIONS_MS:
        at_d = res.sel(duration_ms=d)
        out[d] = (
            float(at_d.pairwise("mechanism", "base", ws)
                  ["chargecache"].mean()),
            float(at_d.sel(mechanism="chargecache")
                  .metric("hcrac_hit_rate").mean()))
    return {"avg": out, "results": res}


def rows(res: dict, us: float) -> list[str]:
    avg = res["avg"]
    best = max(avg, key=lambda d: avg[d][0])
    return [C.csv_row(
        "duration_fig6.5", us,
        ";".join(f"{d:g}ms:sp={v[0]:.4f}/hit={v[1]:.3f}"
                 for d, v in avg.items()) + f";best={best:g}ms")]


def run(sizes: C.Sizes = C.THESIS, device=None) -> list[str]:
    res, us = C.timed(work, sizes, device)
    return rows(res, us)


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0])
