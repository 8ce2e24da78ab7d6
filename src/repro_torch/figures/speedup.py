"""Fig 6.1: speedup of ChargeCache / NUAT / CC+NUAT / LL-DRAM over DDR3
(port of ``benchmarks/speedup.py``).

Paper claims: single-core avg +2.1% (up to 9.3%); eight-core avg +8.6%
(CC), +2.5% (NUAT), +9.6% (CC+NUAT), LL-DRAM ~+13%; and ~67% of
activations served with lowered timings on eight-core.

The mechanism axis enumerates registry entries; every (workload ×
mechanism) pair is one cell of one Experiment, and the speedups come
out of ``Results.pairwise`` against the base label.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import weighted_speedup
from repro_torch.figures import common as C

#: registry entries under study — ``rltl`` (arXiv:1805.03969 as a
#: mechanism: per-bank last-precharged-row registers) rides the same axis
MECHS = ("chargecache", "nuat", "cc_nuat", "rltl", "lldram")
AXES = {"mechanism": ("base",) + MECHS}


def single_core(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    res = C.experiment_singles(sizes.singles, AXES, sizes.n_req_1c,
                               sizes.seed, device=device)
    sp = res.pairwise(
        "mechanism", "base",
        lambda b, s: b["total_cycles"] / max(s["total_cycles"], 1))
    out = {m: dict(zip(sizes.singles, sp[m])) for m in MECHS}
    lowered = res.sel(mechanism="chargecache").metric("acts_lowered_frac")
    avg = {m: float(np.mean(sp[m])) for m in MECHS}
    mx = {m: float(np.max(sp[m])) for m in MECHS}
    return {"per_workload": out, "avg": avg, "max": mx,
            "lowered_frac": float(lowered.mean()), "results": res}


def eight_core(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    res = C.experiment_mixes(sizes.mixes(), AXES, sizes.n_req_8c,
                             sizes.seed, device=device)
    sp = res.pairwise(
        "mechanism", "base",
        lambda b, s: weighted_speedup(b["core_end"], s["core_end"]))
    lowered = res.sel(mechanism="chargecache").metric("acts_lowered_frac")
    avg = {m: float(np.mean(sp[m])) for m in MECHS}
    mx = {m: float(np.max(sp[m])) for m in MECHS}
    return {"per_mix": {m: sp[m].tolist() for m in MECHS},
            "avg": avg, "max": mx,
            "lowered_frac": float(lowered.mean()), "results": res}


def rows(res1: dict, us1: float, res8: dict, us8: float) -> list[str]:
    a, a8 = res1["avg"], res8["avg"]
    return [
        C.csv_row(
            "speedup_fig6.1_single", us1,
            f"cc={a['chargecache']:.4f};nuat={a['nuat']:.4f}"
            f";cc_nuat={a['cc_nuat']:.4f};rltl={a['rltl']:.4f}"
            f";lldram={a['lldram']:.4f}"
            f";cc_max={res1['max']['chargecache']:.4f}"),
        C.csv_row(
            "speedup_fig6.1_eight", us8,
            f"cc={a8['chargecache']:.4f};nuat={a8['nuat']:.4f}"
            f";cc_nuat={a8['cc_nuat']:.4f};rltl={a8['rltl']:.4f}"
            f";lldram={a8['lldram']:.4f}"
            f";lowered_frac={res8['lowered_frac']:.3f}")]


def run(sizes: C.Sizes = C.THESIS, device=None) -> list[str]:
    res1, us1 = C.timed(single_core, sizes, device)
    res8, us8 = C.timed(eight_core, sizes, device)
    return rows(res1, us1, res8, us8)


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0])
