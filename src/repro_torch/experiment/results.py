"""Labeled experiment results (port of ``repro.experiment.results``;
numpy only).

``Results`` is the dense, labeled view of an evaluation grid in one of
two layouts:

* **materialized** — an N-dimensional *object* array of per-point stats
  dicts (exactly what ``simulate()`` returns): ``cells``;
* **streamed** — one float64 ndarray per metric over the same labeled
  grid: ``data`` (what ``Experiment(reduce=...)`` assembles chunk by
  chunk; a 10⁵–10⁶-point grid never materializes the object array).

Either way consumers select by meaning —

    res.sel(mechanism="chargecache", capacity=128)
    res.metric("hcrac_hit_rate")            # ndarray over the grid
    res.pairwise("mechanism", "base", fn)   # per-point vs-baseline values

— instead of re-deriving axis indices from a flat list.
``to_json``/``from_json`` round-trip the whole grid;
``ResultsWriter``/``from_jsonl`` stream a grid through an append-only
JSONL file without ever holding all points in memory (``to_jsonl`` is
the one-shot convenience for an already-assembled object).  Both formats
are ``repro``'s own, so a file either package wrote loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Mapping, Sequence

import numpy as np

#: scalar stats every consumer wants by default (``simulate()`` keys)
DEFAULT_METRICS = ("total_cycles", "avg_latency", "hcrac_hit_rate",
                   "acts_lowered_frac", "row_hit_rate", "rmpkc")

#: JSONL stream magic (header line ``kind`` field)
JSONL_KIND = "repro-results-v1"


def _encode_value(v):
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, np.generic):
        return v.item()
    return v


def _decode_value(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=np.dtype(v["dtype"]))
    return v


@dataclasses.dataclass
class Results:
    """A labeled grid of per-point results.

    Exactly one of ``cells`` / ``data`` is set.  ``cells`` is an object
    ndarray of shape ``tuple(len(coords[d]) for d in dims)``, every
    element one ``simulate()``-style stats dict.  ``data`` maps each
    metric name to a float64 ndarray of that same shape (the streamed
    layout; ``streamed`` is True).
    """
    dims: tuple[str, ...]
    coords: dict[str, tuple]
    cells: np.ndarray | None = None
    metrics: tuple[str, ...] = DEFAULT_METRICS
    meta: dict = dataclasses.field(default_factory=dict)
    data: dict[str, np.ndarray] | None = None

    def __post_init__(self):
        self.dims = tuple(self.dims)
        self.coords = {d: tuple(c) for d, c in self.coords.items()}
        self.metrics = tuple(self.metrics)
        expect = tuple(len(self.coords[d]) for d in self.dims)
        if (self.cells is None) == (self.data is None):
            raise ValueError("exactly one of cells (materialized) / data "
                             "(streamed)")
        if self.cells is not None:
            if self.cells.shape != expect:
                raise ValueError(f"cells shape {self.cells.shape}, coords "
                                 f"give {expect}")
        else:
            if not set(self.data) >= set(self.metrics):
                raise ValueError(f"streamed data missing metrics "
                                 f"{set(self.metrics) - set(self.data)}")
            for m, a in self.data.items():
                if a.shape != expect:
                    raise ValueError(f"metric {m!r} shape {a.shape}, "
                                     f"coords give {expect}")

    @property
    def streamed(self) -> bool:
        return self.data is not None

    @property
    def shape(self) -> tuple[int, ...]:
        if self.cells is not None:
            return self.cells.shape
        return tuple(len(self.coords[d]) for d in self.dims)

    # ---------------------------------------------------------------- sel
    def _coord_index(self, dim: str, label):
        if dim not in self.dims:
            raise KeyError(f"no dim {dim!r}; have {self.dims}")
        try:
            return self.coords[dim].index(label)
        except ValueError:
            raise KeyError(
                f"{label!r} not in {dim!r} coords {self.coords[dim]}") from None

    def sel(self, **labels) -> "Results":
        """Select by coordinate label.  Scalar labels drop their dim;
        list/tuple labels subset it.  Returns a new ``Results`` view.
        Works identically on both layouts."""
        labels = dict(labels)
        arrays = ({"__cells__": self.cells} if self.cells is not None
                  else dict(self.data))
        new_dims: list[str] = []
        new_coords: dict[str, tuple] = {}
        ax = 0
        for d in self.dims:
            if d not in labels:
                new_dims.append(d)
                new_coords[d] = self.coords[d]
                ax += 1
                continue
            v = labels.pop(d)
            if isinstance(v, (list, tuple)):
                idx = [self._coord_index(d, x) for x in v]
                arrays = {k: np.take(a, idx, axis=ax)
                          for k, a in arrays.items()}
                new_dims.append(d)
                new_coords[d] = tuple(v)
                ax += 1
            else:
                i = self._coord_index(d, v)
                arrays = {k: np.take(a, i, axis=ax)
                          for k, a in arrays.items()}
        if labels:
            raise KeyError(f"unknown dims {tuple(labels)}; have {self.dims}")
        if self.cells is not None:
            cells = arrays["__cells__"]
            if not isinstance(cells, np.ndarray):  # fully-scalar sel -> 0-d
                box = np.empty((), object)
                box[()] = cells
                cells = box
            return Results(dims=tuple(new_dims), coords=new_coords,
                           cells=cells, metrics=self.metrics,
                           meta=self.meta)
        arrays = {k: np.asarray(a) for k, a in arrays.items()}
        return Results(dims=tuple(new_dims), coords=new_coords,
                       data=arrays, metrics=self.metrics, meta=self.meta)

    def _cell(self, idx) -> dict:
        """The stats dict at one (already-resolved) grid index — a real
        cell when materialized, a synthesized ``{metric: float}`` dict
        when streamed."""
        if self.cells is not None:
            return self.cells[idx]
        return {m: float(self.data[m][idx]) for m in self.metrics}

    def item(self) -> dict:
        """The single stats dict of a fully-selected (0-d) result."""
        if int(np.prod(self.shape, dtype=np.int64)) != 1:
            raise ValueError(f"item() of a grid of shape {self.shape}")
        if self.cells is not None:
            return self.cells.reshape(())[()]
        return {m: float(self.data[m].reshape(())[()])
                for m in self.metrics}

    def point(self, **labels) -> dict:
        """``sel(...)`` down to one grid point; returns its stats dict."""
        return self.sel(**labels).item()

    # ------------------------------------------------------------ metrics
    def values(self, key: str) -> np.ndarray:
        """Object ndarray of ``stats[key]`` over the grid (any dtype)."""
        if self.cells is None:
            self._check_streamed(key)
            return self.data[key].astype(object)
        out = np.empty(self.shape, object)
        for i, s in np.ndenumerate(self.cells):
            out[i] = s.get(key)
        return out

    def _check_streamed(self, key: str) -> None:
        if key not in self.data:
            raise KeyError(f"streamed results carry only {tuple(self.data)}")

    def metric(self, key: str) -> np.ndarray:
        """Float ndarray of a scalar metric over the grid."""
        if self.cells is None:
            self._check_streamed(key)
            return np.asarray(self.data[key], dtype=float)
        return np.asarray(self.values(key).tolist(), dtype=float)

    def pairwise(self, dim: str, base, fn: Callable[[dict, dict], float]
                 ) -> dict:
        """``fn(base_stats, stats)`` per point, against the ``base`` label
        along ``dim``.  Returns ``{label: float ndarray over the other
        dims}`` for every non-base label (e.g. per-mechanism speedups).
        On streamed results ``fn`` receives the synthesized
        ``{metric: float}`` dicts."""
        b = self.sel(**{dim: base})
        out = {}
        for label in self.coords[dim]:
            if label == base:
                continue
            s = self.sel(**{dim: label})
            vals = np.empty(b.shape, float)
            for i in np.ndindex(b.shape or (1,)):
                j = i if b.shape else ()
                vals[j] = fn(b._cell(j), s._cell(j))
            out[label] = vals
        return out

    # ------------------------------------------------------------- export
    def to_table(self, metrics: Sequence[str] | None = None) -> list[dict]:
        """One row per grid point: coord labels + the selected metrics."""
        metrics = tuple(metrics) if metrics is not None else self.metrics
        rows = []
        for i in np.ndindex(self.shape or (1,)):
            j = i if self.shape else ()
            s = self._cell(j)
            row = {d: self.coords[d][k] for d, k in zip(self.dims, j)}
            for m in metrics:
                row[m] = _encode_value(s.get(m))
            rows.append(row)
        return rows

    def to_json(self, path: str | None = None, full: bool = True) -> str:
        """Serialize the labeled grid; ``full=False`` keeps only the
        declared metrics per cell (compact artifact).  A streamed result
        serializes its metric arrays under ``"data"``."""
        doc = {
            "dims": list(self.dims),
            "coords": {d: list(c) for d, c in self.coords.items()},
            "metrics": list(self.metrics),
            "meta": {k: _encode_value(v) for k, v in self.meta.items()},
        }
        if self.cells is not None:
            def cell(s):
                keys = (s.keys() if full
                        else [m for m in self.metrics if m in s])
                return {k: _encode_value(s[k]) for k in keys}
            doc["cells"] = [cell(s) for s in self.cells.flat]
        else:
            doc["data"] = {m: _encode_value(a)
                           for m, a in self.data.items()}
        text = json.dumps(doc, indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_json(cls, text: str) -> "Results":
        doc = json.loads(text)
        dims = tuple(doc["dims"])
        coords = {d: tuple(c) for d, c in doc["coords"].items()}
        shape = tuple(len(coords[d]) for d in dims)
        meta = {k: _decode_value(v) for k, v in doc.get("meta", {}).items()}
        metrics = tuple(doc.get("metrics", DEFAULT_METRICS))
        if "data" in doc:
            data = {m: np.asarray(_decode_value(v), np.float64
                                  ).reshape(shape)
                    for m, v in doc["data"].items()}
            return cls(dims=dims, coords=coords, data=data,
                       metrics=metrics, meta=meta)
        cells = np.empty(shape, object)
        flat = [{k: _decode_value(v) for k, v in c.items()}
                for c in doc["cells"]]
        if len(flat) != cells.size:
            raise ValueError(f"{len(flat)} cells for a grid of {cells.size}")
        for i, s in zip(np.ndindex(shape or (1,)), flat):
            cells[i if shape else ()] = s
        return cls(dims=dims, coords=coords, cells=cells,
                   metrics=metrics, meta=meta)

    # ------------------------------------------------------------- stream
    def to_jsonl(self, path: str) -> None:
        """One-shot JSONL dump of an assembled result (either layout) —
        the same stream format ``ResultsWriter`` appends incrementally;
        reading back with ``from_jsonl`` yields the streamed layout."""
        n_flat = int(np.prod(self.shape, dtype=np.int64))
        with ResultsWriter(path, self.dims, self.coords, self.metrics,
                           meta=self.meta) as w:
            rows = np.empty((n_flat, len(self.metrics)), np.float64)
            for t, i in enumerate(np.ndindex(self.shape or (1,))):
                s = self._cell(i if self.shape else ())
                for mi, m in enumerate(self.metrics):
                    v = s.get(m)
                    rows[t, mi] = np.nan if v is None else float(v)
            w.write(np.arange(n_flat, dtype=np.int64), rows)

    @classmethod
    def from_jsonl(cls, path: str) -> "Results":
        """Read a ``ResultsWriter`` stream back into the streamed
        layout.  Every grid point must have been written exactly once
        (the writer's coverage contract)."""
        with open(path) as f:
            head = json.loads(next(f))
            if head.get("kind") != JSONL_KIND:
                raise ValueError(
                    f"not a {JSONL_KIND} stream: {head.get('kind')!r}")
            dims = tuple(head["dims"])
            coords = {d: tuple(c) for d, c in head["coords"].items()}
            metrics = tuple(head["metrics"])
            meta = {k: _decode_value(v)
                    for k, v in head.get("meta", {}).items()}
            shape = tuple(len(coords[d]) for d in dims)
            n_flat = int(np.prod(shape, dtype=np.int64))
            flat = np.full((n_flat, len(metrics)), np.nan, np.float64)
            seen = np.zeros(n_flat, bool)
            for line in f:
                if not line.strip():
                    continue
                doc = json.loads(line)
                if doc.get("end"):
                    meta.update({k: _decode_value(v)
                                 for k, v in doc.get("meta", {}).items()})
                    continue
                idx = np.asarray(doc["i"], np.int64)
                if seen[idx].any():
                    raise ValueError("stream wrote a grid point twice")
                flat[idx] = np.asarray(doc["v"], np.float64)
                seen[idx] = True
        if not seen.all():
            raise ValueError(
                f"stream covered {int(seen.sum())}/{n_flat} grid points")
        data = {m: np.ascontiguousarray(flat[:, mi].reshape(shape))
                for mi, m in enumerate(metrics)}
        return cls(dims=dims, coords=coords, data=data, metrics=metrics,
                   meta=meta)


class ResultsWriter:
    """Incremental JSONL sink for a streamed grid.

    Layout: a header line (dims / coords / metrics / launch meta), then
    one line per drained chunk — ``{"i": [flat C-order indices],
    "v": [[one float row per index, metrics-ordered]]}`` — and a
    trailer ``{"end": true, "meta": {...}}`` with whatever final
    bookkeeping the runner learned (aggregates).  Host
    memory is O(chunk line), never O(grid); ``Results.from_jsonl``
    restores the streamed layout and checks full coverage.
    """

    def __init__(self, path: str, dims, coords, metrics,
                 meta: Mapping | None = None):
        self.path = path
        self.dims = tuple(dims)
        self.coords = {d: tuple(c) for d, c in dict(coords).items()}
        self.metrics = tuple(metrics)
        self.n_flat = int(np.prod(
            [len(self.coords[d]) for d in self.dims], dtype=np.int64))
        self.n_written = 0
        self._f = open(path, "w")
        header = {
            "kind": JSONL_KIND,
            "dims": list(self.dims),
            "coords": {d: list(c) for d, c in self.coords.items()},
            "metrics": list(self.metrics),
            "meta": {k: _encode_value(v)
                     for k, v in dict(meta or {}).items()},
        }
        self._f.write(json.dumps(header, sort_keys=True) + "\n")

    def write(self, flat_idx, rows) -> None:
        """Append one chunk: ``rows[k]`` are the metric values of flat
        C-order grid index ``flat_idx[k]``."""
        flat_idx = np.asarray(flat_idx, np.int64).reshape(-1)
        rows = np.asarray(rows, np.float64).reshape(
            len(flat_idx), len(self.metrics))
        if len(flat_idx) == 0:
            return
        self._f.write(json.dumps(
            {"i": flat_idx.tolist(), "v": rows.tolist()}) + "\n")
        self.n_written += len(flat_idx)

    def close(self, meta: Mapping | None = None) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(
            {"end": True,
             "meta": {k: _encode_value(v)
                      for k, v in dict(meta or {}).items()}},
            sort_keys=True) + "\n")
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        elif self._f is not None:
            self._f.close()
            self._f = None
