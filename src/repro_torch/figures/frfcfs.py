"""The FR-FCFS controller tier's sensitivity study (port of
``benchmarks/frfcfs.py``).

One ``Experiment`` runs controller × mechanism × window depth over a
locality-heavy synthetic eight-core mix (streaming cores interleaving in
the same banks, the workload out-of-order scheduling exists for).  Any
frfcfs point routes the launch through the window engine at one window
depth (the grid's largest), the in-order points riding along at a window
cap of 1: on the card the whole matrix is one ``sim_window`` launch
(asserted from the library's count).

What the numbers must show (asserted):

* FR-FCFS harvests row-buffer locality: its row-hit rate is never below
  the in-order tier's on this mix;
* deeper windows never lose row hits on this mix;
* ChargeCache speeds up both tiers, and the two agree on its magnitude
  within ``CC_TIER_DELTA``: the thesis's in-order approximation does not
  invent the mechanism's benefit.

At the thesis's size (40 000 requests a core) the second does not hold,
in ``repro`` as in the port: window 16 harvests fewer row hits than
window 4 (ROADMAP.md, Queue 3), and the study raises there.

::

    python -m repro_torch.figures.frfcfs [--quick] [--device cpu]
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import WorkloadSpec, weighted_speedup
from repro_torch.experiment import Experiment
from repro_torch.figures import common as C

MECHS = ("base", "chargecache")
WINDOWS = (4, 8, 16)
#: streaming and high-row-locality cores sharing banks
LOCALITY_MIX = ("stream_copy_like", "stream_triad_like", "lbm_like",
                "libquantum_like") * 2
SEED = 7

#: the cross-tier bound on the ChargeCache speedup's difference: the
#: tiers schedule differently, but the mechanism's benefit is a bank-
#: timing property and must not swing by more than this across them
CC_TIER_DELTA = 0.15


def experiment(n_req: int = C.N_REQ_8C, device=None) -> Experiment:
    """(mechanism × controller × window) over the mix, streamed on the
    device."""
    spec = WorkloadSpec(names=LOCALITY_MIX, n_req=n_req, seed=SEED)
    base = dataclasses.replace(C.sim_cfg("base", len(LOCALITY_MIX)),
                               workload=spec)
    return Experiment(traces=None,
                      axes={"mechanism": list(MECHS),
                            "controller": ["inorder", "frfcfs"],
                            "window": list(WINDOWS)},
                      base=base, device=device)


def frfcfs_grid(n_req: int = C.N_REQ_8C, device=None):
    """The experiment's Results and the ``sim_window`` launches it made."""
    from repro_torch.kernels.sim_step import ops
    before = ops.window_launches
    res = experiment(n_req, device).run()
    return res, ops.window_launches - before


def summarize(cell) -> dict:
    """The study's numbers from ``cell(mechanism, controller, window)``,
    a cell's stats: the base row-hit rate in-order and at each window,
    ChargeCache's weighted speedup on each tier (window 8) and its
    difference, and frfcfs's cycles over in-order's."""
    rate = lambda s: float(s["row_hits"]) / max(float(s["n_req"]), 1.0)
    hit_rate = {"inorder": rate(cell("base", "inorder", 8))}
    for w in WINDOWS:
        hit_rate[f"frfcfs_w{w}"] = rate(cell("base", "frfcfs", w))
    cc_speedup = {ctrl: weighted_speedup(
        np.asarray(cell("base", ctrl, 8)["core_end"]),
        np.asarray(cell("chargecache", ctrl, 8)["core_end"]))
        for ctrl in ("inorder", "frfcfs")}
    cyc = {ctrl: int(cell("base", ctrl, 8)["total_cycles"])
           for ctrl in ("inorder", "frfcfs")}
    return {"hit_rate": hit_rate, "cc_speedup": cc_speedup,
            "cc_tier_delta": abs(cc_speedup["frfcfs"]
                                 - cc_speedup["inorder"]),
            "cycles_ratio": cyc["frfcfs"] / max(cyc["inorder"], 1)}


def failed_checks(s: dict) -> list[str]:
    """The study's three assertions (``repro``'s) that ``summarize``'s
    numbers break: FR-FCFS's row-hit rate below in-order's at some
    window; the deepest window below the shallowest; ChargeCache slower
    on a tier, or its speedups more than ``CC_TIER_DELTA`` apart."""
    h, cc = s["hit_rate"], s["cc_speedup"]
    out = [f"frfcfs w{w} row-hit rate {h[f'frfcfs_w{w}']} below in-order's "
           f"{h['inorder']}" for w in WINDOWS
           if h[f"frfcfs_w{w}"] < h["inorder"]]
    if h["frfcfs_w16"] < h["frfcfs_w4"] - 1e-12:
        out.append(f"window 16 row-hit rate {h['frfcfs_w16']} below window "
                   f"4's {h['frfcfs_w4']}")
    if min(cc.values()) < 1.0 - 1e-9 or s["cc_tier_delta"] > CC_TIER_DELTA:
        out.append(f"ChargeCache speedup {cc} (delta {s['cc_tier_delta']}, "
                   f"bound {CC_TIER_DELTA})")
    return out


def study(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    """The grid and its checks (raising ``AssertionError`` on the first
    broken one, as ``repro``'s study does); returns the numbers of the
    row."""
    (res, launches), us = C.timed(frfcfs_grid, sizes.n_req_8c, device)
    planned = res.meta["n_kernel_launches"]
    on_card = res.meta["device"].startswith("cuda")
    bad = [] if planned == 1 and launches == (1 if on_card else 0) else [
        f"{launches} sim_window launches ({planned} planned) for the "
        f"controller x mechanism x window grid, not one"]
    out = summarize(lambda m, c, w: res.sel(mechanism=m, controller=c,
                                            window=w).cells.flat[0])
    bad += failed_checks(out)
    if bad:
        raise AssertionError("; ".join(bad))
    return {**out, "results": res, "us": us, "launches": launches}


def rows(out: dict) -> list[str]:
    """``repro``'s CSV row, ``launches`` in place of its compile count."""
    h, cc = out["hit_rate"], out["cc_speedup"]
    return [C.csv_row(
        "frfcfs_controller_tier", out["us"],
        f"launches={out['launches']}"
        f";hit_inorder={h['inorder']:.4f}"
        f";hit_frfcfs_w16={h['frfcfs_w16']:.4f}"
        f";cc_inorder={cc['inorder']:.4f}"
        f";cc_frfcfs={cc['frfcfs']:.4f}"
        f";cyc_ratio={out['cycles_ratio']:.4f}")]


def run(sizes: C.Sizes = C.THESIS, device=None) -> list[str]:
    return rows(study(sizes, device))


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0])
