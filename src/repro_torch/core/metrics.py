"""Scalar-metric registry (port of ``repro.core.metrics``; numpy, host).

One source of truth for every derived scalar the engine reports: a
*metric* is a named host-side formula over integer *ingredient* counters
(``deps`` — stat keys like ``lat_sum``/``n_req``, or the engine-derived
``total_cycles``).  ``simulator._finalize`` and the serving engine's
``run_sweep`` call ``finalize_scalars``, which fills in every registered
metric whose deps are present.  The formulas are dtype-explicit numpy,
so they give the same float64 values as ``repro``'s.  The reduce path
and the streaming aggregations of ``repro.core.metrics`` belong to the
Experiment layer, not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

__all__ = ["Metric", "register_metric", "metric_names", "finalize_scalars"]


@dataclasses.dataclass(frozen=True)
class Metric:
    """A named scalar formula over integer stat ingredients.

    ``fn(*dep_arrays)`` must be numpy-vectorized (0-d in → 0-d out,
    [chunk] in → [chunk] out) and dtype-stable (float64 out, or int for
    ``as_int`` metrics).  ``best`` is the argbest direction."""
    name: str
    deps: tuple[str, ...]
    fn: Callable
    best: str = "min"           # "min" | "max"
    as_int: bool = False        # full-stats path stores int(...) not float()

    def __post_init__(self):
        assert self.best in ("min", "max"), self.best


_METRICS: dict[str, Metric] = {}


def register_metric(name: str, deps: Sequence[str], best: str = "min",
                    as_int: bool = False):
    """Register a metric formula: ``fn(*dep_values) -> value``."""
    def deco(fn):
        assert name not in _METRICS, f"metric {name!r} already registered"
        _METRICS[name] = Metric(name, tuple(deps), fn, best, as_int)
        return fn
    return deco


def metric_names() -> tuple[str, ...]:
    return tuple(_METRICS)


def finalize_scalars(stats: dict) -> dict:
    """Fill every registered metric whose deps are present into
    ``stats`` (in place; existing keys are never overwritten).  The
    shared tail of ``simulator._finalize`` and the serving engine's
    ``run_sweep`` — one formula table for both."""
    for name, m in _METRICS.items():
        if name in stats:
            continue
        if any(d not in stats or stats[d] is None for d in m.deps):
            continue
        v = m.fn(*[stats[d] for d in m.deps])
        stats[name] = int(v) if m.as_int else float(v)
    return stats


# --------------------------------------------------------------------------
# Built-in metrics.  The formulas are the exact ones ``_finalize`` (and
# the serving engine) used inline pre-§13; ints promote to float64
# exactly, so the vectorized forms are bitwise-equal to the old
# ``float(x) / max(int(y), 1)`` scalar arithmetic.
# --------------------------------------------------------------------------

@register_metric("avg_latency", deps=("lat_sum", "n_req"), best="min")
def _avg_latency(lat_sum, n_req):
    return lat_sum / np.maximum(n_req, 1)


@register_metric("hcrac_hit_rate", deps=("hcrac_hits", "hcrac_lookups"),
                 best="max")
def _hcrac_hit_rate(hits, lookups):
    return hits / np.maximum(lookups, 1)


@register_metric("acts_lowered_frac", deps=("acts_lowered", "acts"),
                 best="max")
def _acts_lowered_frac(acts_lowered, acts):
    return acts_lowered / np.maximum(acts, 1)


@register_metric("row_hit_rate", deps=("row_hits", "n_req"), best="max")
def _row_hit_rate(row_hits, n_req):
    return row_hits / np.maximum(n_req, 1)


@register_metric("rmpkc", deps=("acts", "total_cycles"), best="min")
def _rmpkc(acts, total_cycles):
    return 1000.0 * acts / np.maximum(total_cycles, 1)


@register_metric("ref_blocked_frac",
                 deps=("ref_blocked_cycles", "total_cycles"), best="min")
def _ref_blocked_frac(ref_blocked_cycles, total_cycles):
    """Fraction of the run a request sat behind a tRFC blackout — the
    stateful refresh engine's headline cost stat (DESIGN.md §14; zero
    under the legacy closed-form tier, which never issues REF)."""
    return ref_blocked_cycles / np.maximum(total_cycles, 1)


# --- serving-loop derived scalars (deps present only in serving mode) ---

@register_metric("admit_hot_rate", deps=("admit_hot", "admit_probes"),
                 best="max")
def _admit_hot_rate(admit_hot, admit_probes):
    return admit_hot / np.maximum(admit_probes, 1)


@register_metric("occ_mean", deps=("occ_sum", "n_steps"), best="max")
def _occ_mean(occ_sum, n_steps):
    return occ_sum / np.maximum(n_steps, 1)


@register_metric("qlen_mean", deps=("qlen_sum", "n_steps"), best="min")
def _qlen_mean(qlen_sum, n_steps):
    return qlen_sum / np.maximum(n_steps, 1)
