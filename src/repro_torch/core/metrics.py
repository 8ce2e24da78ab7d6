"""Scalar-metric registry and streaming aggregations (port of
``repro.core.metrics``; numpy, host).

One source of truth for every derived scalar the engine reports: a
*metric* is a named host-side formula over integer *ingredient* counters
(``deps`` — stat keys like ``lat_sum``/``n_req``, or the engine-derived
``total_cycles``).  Two consumers:

* the full-stats path: ``simulator._finalize`` and the serving engine's
  drain call ``finalize_scalars``, which fills in every registered
  metric whose deps are present;
* the reduce path (``Experiment(reduce=...)``): a launch lowers the
  metrics' integer deps (``resolve`` / ``deps_for``) to an int32
  ``[chunk, n_deps]`` array on the device, and the host applies the same
  formulas vectorized over the chunk.

The formulas are dtype-explicit numpy, so the scalar and the vectorized
call give the same float64 values, and both equal ``repro``'s.  An
*aggregation* (``mean`` / ``min`` / ``max`` / ``argbest``, or any
``register_aggregation`` name) folds a metric's values chunk by chunk
over the whole grid.  The public face is ``repro_torch.experiment.
metrics``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

__all__ = ["Metric", "register_metric", "metric_names", "resolve",
           "deps_for", "finalize_scalars", "register_aggregation",
           "aggregation_names", "make_aggregator"]


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


def resolve(names: Sequence[str], available: Sequence[str]
            ) -> tuple[Metric, ...]:
    """Metric objects for ``names``, validated against the launch's
    reducible ingredient keys.  A name that is itself a reducible key
    (a raw counter like ``retired`` or ``acts``) resolves to an identity
    metric, so ``reduce=("total_cycles", "retired")`` just works."""
    avail = set(available)
    out = []
    for n in names:
        m = _METRICS.get(n)
        if m is None:
            if n not in avail:
                raise ValueError(
                    f"{n!r} is neither a registered metric "
                    f"({metric_names()}) nor a reducible stat key")
            m = Metric(n, (n,), lambda x: x, best="max", as_int=True)
        missing = tuple(d for d in m.deps if d not in avail)
        if missing:
            raise ValueError(
                f"metric {n!r} needs deps {missing} which this launch mode "
                f"cannot reduce (available: {tuple(sorted(avail))})")
        out.append(m)
    return tuple(out)


def deps_for(metrics: Sequence[Metric]) -> tuple[str, ...]:
    """Ordered union of the metrics' ingredient keys (first-use order) —
    the ``reduce_keys`` a launch lowers on the device."""
    seen: list[str] = []
    for m in metrics:
        for d in m.deps:
            if d not in seen:
                seen.append(d)
    return tuple(seen)


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


# --------------------------------------------------------------------------
# Streaming aggregations
# --------------------------------------------------------------------------

_AGGREGATIONS: dict[str, Callable] = {}


def register_aggregation(name: str):
    """Register an aggregation factory: ``factory(metric) -> aggregator``
    with ``update(values, flat_idx)`` and ``result()``."""
    def deco(factory):
        _AGGREGATIONS[name] = factory
        return factory
    return deco


def aggregation_names() -> tuple[str, ...]:
    return tuple(_AGGREGATIONS)


def make_aggregator(agg: str, metric: Metric):
    if agg not in _AGGREGATIONS:
        raise ValueError(f"unknown aggregation {agg!r}; registered: "
                         f"{aggregation_names()}")
    return _AGGREGATIONS[agg](metric)


@register_aggregation("mean")
class _Mean:
    def __init__(self, metric: Metric):
        self._sum, self._n = 0.0, 0

    def update(self, values: np.ndarray, flat_idx: np.ndarray):
        self._sum += float(np.sum(values, dtype=np.float64))
        self._n += int(values.size)

    def result(self):
        return self._sum / max(self._n, 1)


class _Extremum:
    _cmp = min

    def __init__(self, metric: Metric):
        self._best = None

    def update(self, values: np.ndarray, flat_idx: np.ndarray):
        if values.size == 0:
            return
        v = float(type(self)._cmp(values.min(), values.max()))
        self._best = v if self._best is None else type(self)._cmp(
            self._best, v)

    def result(self):
        return self._best


@register_aggregation("min")
class _Min(_Extremum):
    _cmp = min


@register_aggregation("max")
class _Max(_Extremum):
    _cmp = max


@register_aggregation("argbest")
class _ArgBest:
    """Best grid point in the metric's ``best`` direction; ties keep the
    earliest flat index (deterministic under any chunking)."""

    def __init__(self, metric: Metric):
        self._lower_is_better = metric.best == "min"
        self._val, self._idx = None, None

    def update(self, values: np.ndarray, flat_idx: np.ndarray):
        if values.size == 0:
            return
        pick = int(np.argmin(values) if self._lower_is_better
                   else np.argmax(values))
        v, i = float(values[pick]), int(flat_idx[pick])
        better = (self._val is None
                  or (v < self._val if self._lower_is_better
                      else v > self._val)
                  or (v == self._val and i < self._idx))
        if better:
            self._val, self._idx = v, i

    def result(self):
        return {"value": self._val, "flat_index": self._idx}
