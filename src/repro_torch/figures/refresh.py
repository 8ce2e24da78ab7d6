"""Stateful rolling refresh and thermal drift (port of
``benchmarks/refresh.py``).

One Experiment runs mechanism x refresh tier x refresh pressure x
temperature drift over a four-core synthetic mix generated on the device:
``refresh_mode`` and the drift schedule are per-point data and the
pressure axis is a ``TimingParams`` sweep (the ``timing`` axis under
another label), so on the card the whole matrix is one launch of the
synthesis entry (asserted).

What the numbers must show (asserted, as in ``repro``):

* the stateful tier spends a ``tRFC/tREFI``-scale share of the run
  behind REF blackouts (the legacy tier none), and that share grows
  under DDR4-style 4x refresh pressure
  (``timing.with_refresh_pressure``);
* refresh pressure shrinks the retention window, so rows are younger on
  average: the share of ACTs to rows refreshed within 8 ms rises, and
  the charge-headroom mechanism (NUAT) gains speedup;
* AL-DRAM under a heating drift schedule loses its margin (``ramp`` runs
  slower than a cool stream, and no slower than base), while drift-
  blind mechanisms dedup to one run (base's cycles are equal).

``--json PATH`` writes the headline numbers and every cell.

::

    python -m repro_torch.figures.refresh [--quick] [--device cpu] [--json PATH]
"""

from __future__ import annotations

from repro_torch.core.timing import DDR3_1600, with_refresh_pressure
from repro_torch.experiment.spec import AXIS_BUILDERS
from repro_torch.figures import common as C

# the pressure axis is the timing axis under a friendlier label
AXIS_BUILDERS.setdefault("pressure", AXIS_BUILDERS["timing"])

MECHS = ("base", "chargecache", "nuat", "aldram")
PRESSURES = {"1x": DDR3_1600, "4x": with_refresh_pressure(DDR3_1600, 4)}
DRIFTS = ("none", "ramp")
N_CORES = 4
AXES = {"mechanism": list(MECHS), "refresh_mode": ["legacy", "stateful"],
        "pressure": PRESSURES, "temp_drift": list(DRIFTS)}


def experiment(sizes: C.Sizes = C.THESIS, device=None):
    """(mechanism x refresh_mode x pressure x drift) over one synthetic
    four-core mix, streamed on the device."""
    return C.synth_experiment(AXES, N_CORES, sizes.n_req_8c, sizes.seed,
                              device=device)


def refresh_grid(sizes: C.Sizes = C.THESIS, device=None):
    """The grid's Results and the kernel launches it made (drift-blind
    and legacy-identical points dedup)."""
    return C.launch_counted(experiment(sizes, device).run)


def summarize(res) -> dict:
    """The study's numbers: the REF blackout share and the refreshed-
    within-8 ms ACT share of base (stateful, no drift) at each pressure,
    the mechanism speedups a (tier, pressure), and the cycles of base and
    AL-DRAM (stateful, 1x) with and without the ``ramp`` drift."""
    cell = lambda **kw: res.sel(**kw).cells.flat[0]
    base = lambda rm, pr: cell(mechanism="base", refresh_mode=rm,
                               pressure=pr, temp_drift="none")
    blocked = {pr: float(base("stateful", pr)["ref_blocked_frac"])
               for pr in PRESSURES}
    ref8 = {}
    for pr in PRESSURES:
        s = base("stateful", pr)
        ref8[pr] = float(s["refresh8ms_acts"]) / max(float(s["acts"]), 1.0)
    speedup = {
        rm: {pr: C.mech_speedups(
            res.sel(refresh_mode=rm, pressure=pr, temp_drift="none"))
            for pr in PRESSURES}
        for rm in ("legacy", "stateful")}
    cycles = lambda m, d: int(cell(mechanism=m, refresh_mode="stateful",
                                   pressure="1x", temp_drift=d)
                              ["total_cycles"])
    return {"blocked": blocked,
            "legacy_blocked": float(base("legacy", "1x")["ref_blocked_frac"]),
            "ref8": ref8, "speedup": speedup,
            "al": {d: cycles("aldram", d) for d in DRIFTS},
            "bs": {d: cycles("base", d) for d in DRIFTS}}


def failed_checks(s: dict) -> list[str]:
    """The study's five assertions (``repro``'s) that ``summarize``'s
    numbers break."""
    blocked, ref8, al, bs = s["blocked"], s["ref8"], s["al"], s["bs"]
    nuat = s["speedup"]["stateful"]
    out = []
    if s["legacy_blocked"] != 0.0:
        out.append(f"legacy tier blocked {s['legacy_blocked']}")
    if not 0.0 < blocked["1x"] < blocked["4x"]:
        out.append(f"REF blackout share {blocked} not growing under "
                   f"pressure")
    if not ref8["4x"] > ref8["1x"]:
        out.append(f"refreshed-within-8ms ACT share {ref8} not rising")
    if not nuat["4x"]["nuat"] > nuat["1x"]["nuat"] - 1e-9:
        out.append(f"NUAT speedup {nuat['1x']['nuat']} -> "
                   f"{nuat['4x']['nuat']} falls under pressure")
    if bs["none"] != bs["ramp"]:
        out.append(f"drift-blind base cycles {bs} differ")
    if not al["none"] <= al["ramp"] <= bs["ramp"]:
        out.append(f"AL-DRAM drift cycles {al} against base {bs}")
    return out


def study(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    """The grid and its checks (raising ``AssertionError`` on a broken
    one, as ``repro``'s study does)."""
    (res, launches), us = C.timed(refresh_grid, sizes, device)
    C.check_launches("the mechanism x refresh x pressure x drift grid",
                     res, launches, 1)
    s = summarize(res)
    bad = failed_checks(s)
    if bad:
        raise AssertionError("; ".join(bad))
    return {**s, "launches": launches, "results": res, "us": us}


def document(out: dict) -> dict:
    """``repro``'s ``BENCH_refresh.json`` keys (``launches`` in place of
    its compile count)."""
    nuat, al = out["speedup"]["stateful"], out["al"]
    res = out["results"]
    return {"launches": out["launches"],
            "ref_blocked_frac_1x": out["blocked"]["1x"],
            "ref_blocked_frac_4x": out["blocked"]["4x"],
            "refresh8ms_frac_1x": out["ref8"]["1x"],
            "refresh8ms_frac_4x": out["ref8"]["4x"],
            "nuat_speedup_1x": nuat["1x"]["nuat"],
            "nuat_speedup_4x": nuat["4x"]["nuat"],
            "cc_speedup_1x": nuat["1x"]["chargecache"],
            "aldram_drift_slowdown": al["ramp"] / max(al["none"], 1),
            "speedup": out["speedup"], "cells": res.to_table(),
            "meta": res.meta}


def rows(out: dict) -> list[str]:
    b, nuat, al = out["blocked"], out["speedup"]["stateful"], out["al"]
    return [C.csv_row(
        "refresh_pressure_drift", out["us"],
        f"launches={out['launches']};blocked_1x={b['1x']:.4f}"
        f";blocked_4x={b['4x']:.4f};ref8_4x={out['ref8']['4x']:.4f}"
        f";nuat_1x={nuat['1x']['nuat']:.4f}"
        f";nuat_4x={nuat['4x']['nuat']:.4f}"
        f";aldram_drift={al['ramp'] / max(al['none'], 1):.4f}")]


def run(sizes: C.Sizes = C.THESIS, device=None, json_path=None) -> list[str]:
    out = study(sizes, device)
    C.write_json(json_path, document(out))
    return rows(out)


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0], artifact=True)
