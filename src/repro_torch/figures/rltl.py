"""Fig 3.1 / 3.2: RLTL vs time-since-refresh, t-RLTL sweep, both policies
(port of ``benchmarks/rltl.py``).

Paper claims reproduced here: 8 ms-RLTL ~86% (1-core avg) vs ~12% of
activations within 8 ms of a refresh; 0.125 ms-RLTL ~66% (1-core) and
~77% (8-core, closed-row).

``repro`` simulates each trace alone; here each figure is one
Experiment over its traces with the RLTL post-pass on (``rltl=True``),
whose cells equal those simulations bit for bit.
"""

from __future__ import annotations

from repro_torch.core.rltl import rltl_fractions, summarize
from repro_torch.figures import common as C

AXES = {"mechanism": ["base"]}


def fig_3_1_single(sizes: C.Sizes = C.THESIS, policy: str = "open",
                   device=None) -> dict:
    res = C.experiment_singles(sizes.singles, AXES, sizes.n_req_1c,
                               sizes.seed, base=C.sim_cfg("base", 1, policy),
                               rltl=True, device=device)
    per = {name: rltl_fractions(res.point(workload=name, mechanism="base"))
           for name in sizes.singles}
    return {"per_workload": per, "avg": summarize(per), "results": res}


def fig_3_1_eight(sizes: C.Sizes = C.THESIS, policy: str = "closed",
                  device=None) -> dict:
    res = C.experiment_mixes(sizes.mixes(), AXES, sizes.n_req_8c,
                             sizes.seed, base=C.sim_cfg("base", 8, policy),
                             rltl=True, device=device)
    per = {mix: rltl_fractions(res.point(mix=mix, mechanism="base"))
           for mix in res.coords["mix"]}
    return {"per_workload": per, "avg": summarize(per), "results": res}


def rows(res1: dict, us1: float, res1c: dict, usc: float, res8: dict,
         us8: float) -> list[str]:
    a, ac, a8 = res1["avg"], res1c["avg"], res8["avg"]
    return [
        C.csv_row(
            "rltl_fig3.1_single", us1,
            f"rltl8ms={a['rltl_8.0ms']:.3f};refresh8ms="
            f"{a['refresh_8ms_frac']:.3f};rltl0.125ms={a['rltl_0.125ms']:.3f}"),
        C.csv_row(
            "rltl_fig3.2_single_closedrow", usc,
            f"rltl0.125ms={ac['rltl_0.125ms']:.3f};rltl8ms="
            f"{ac['rltl_8.0ms']:.3f}"),
        C.csv_row(
            "rltl_fig3.1_eight", us8,
            f"rltl8ms={a8['rltl_8.0ms']:.3f};refresh8ms="
            f"{a8['refresh_8ms_frac']:.3f};rltl0.125ms="
            f"{a8['rltl_0.125ms']:.3f}")]


def run(sizes: C.Sizes = C.THESIS, device=None) -> list[str]:
    res1, us1 = C.timed(fig_3_1_single, sizes, "open", device)
    res1c, usc = C.timed(fig_3_1_single, sizes, "closed", device)
    res8, us8 = C.timed(fig_3_1_eight, sizes, "closed", device)
    return rows(res1, us1, res1c, usc, res8, us8)


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0])
