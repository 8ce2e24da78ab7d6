"""Row-Level Temporal Locality analysis (thesis §3, Figs 3.1/3.2).

Port of ``repro.core.rltl`` (numpy).

``t``-RLTL = fraction of row activations that occur within ``t`` after the
previous *precharge* of the same row.  The simulator accumulates the
interval histogram in-scan; this module turns it into the thesis's curves
and compares against the time-since-refresh fraction (NUAT's signal).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.simulator import RLTL_EDGES_MS


def rltl_fractions(stats: dict) -> dict:
    """Cumulative t-RLTL per histogram edge, plus the 8 ms refresh fraction.

    Fractions are over *all* measured activations (activations with no
    prior PRE — cold rows — count against RLTL, as in the thesis).
    """
    hist = np.asarray(stats["rltl_hist"], np.float64)
    acts = max(float(stats["acts"]), 1.0)
    cum = np.cumsum(hist)[: len(RLTL_EDGES_MS)]
    out = {f"rltl_{e}ms": float(c) / acts for e, c in zip(RLTL_EDGES_MS, cum)}
    out["refresh_8ms_frac"] = float(stats["refresh8ms_acts"]) / acts
    out["acts"] = acts
    return out


def summarize(per_workload: dict[str, dict]) -> dict:
    """Average the RLTL metrics across workloads (thesis reports means)."""
    keys = next(iter(per_workload.values())).keys()
    return {k: float(np.mean([v[k] for v in per_workload.values()]))
            for k in keys if k != "acts"}
