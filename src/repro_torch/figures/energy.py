"""Fig 6.2: DRAM energy reduction of ChargeCache (avg & max, 1c / 8c;
port of ``benchmarks/energy.py``).

Paper claims: -1.8% avg / -6.9% max (single-core); -7.9% avg / -14.1% max
(eight-core).

Base + ChargeCache per workload/mix as a two-label mechanism axis; the
reduction is a ``Results.pairwise`` against the base label.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import energy as E
from repro_torch.figures import common as C

AXES = {"mechanism": ["base", "chargecache"]}


def reduction(base: dict, mech: dict) -> float:
    eb = E.energy_nj(base)["total"]
    em = E.energy_nj(mech)["total"]
    return 1.0 - em / eb


def single(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    res = C.experiment_singles(sizes.singles, AXES, sizes.n_req_1c,
                               sizes.seed, device=device)
    return {"reduction": res.pairwise("mechanism", "base",
                                      reduction)["chargecache"],
            "results": res}


def eight(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    res = C.experiment_mixes(sizes.mixes(), AXES, sizes.n_req_8c,
                             sizes.seed, device=device)
    return {"reduction": res.pairwise("mechanism", "base",
                                      reduction)["chargecache"],
            "results": res}


def rows(r1: dict, us1: float, r8: dict, us8: float) -> list[str]:
    red1, red8 = r1["reduction"], r8["reduction"]
    return [
        C.csv_row("energy_fig6.2_single", us1,
                  f"avg={np.mean(red1):.4f};max={np.max(red1):.4f}"),
        C.csv_row("energy_fig6.2_eight", us8,
                  f"avg={np.mean(red8):.4f};max={np.max(red8):.4f}")]


def run(sizes: C.Sizes = C.THESIS, device=None) -> list[str]:
    r1, us1 = C.timed(single, sizes, device)
    r8, us8 = C.timed(eight, sizes, device)
    return rows(r1, us1, r8, us8)


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0])
