"""The golden full-size reference: what the JAX package computes for the
thesis experiment's two full-size workloads, recorded in
``data/golden_fullwidth.json`` (written by ``tests/_torch_golden.py``).

This module names the workloads, rebuilds their traces with either
package's ``traces`` module (``build_batch``), and loads the traces the
golden results were computed on (``load_batch``, from
``data/golden_traces.npz``).  The stored traces are needed because the
generator draws from numpy's ``Generator`` distributions, whose streams
differ between numpy versions: on another installation the same seed can
give other bytes.  ``trace_sha256`` is the digest the JSON records for
each trace.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"
GOLDEN_PATH = DATA / "golden_fullwidth.json"
TRACES_PATH = DATA / "golden_traces.npz"

#: the two full-size workloads (benchmarks/common.py sizes, Table 5.1)
WORKLOADS = {
    "eight_core": {"mix_seed": 42, "mix_index": 0, "n_cores": 8,
                   "n_req": 40_000, "seed": 3, "policy": "closed"},
    "single_core": {"name": "milc_like", "n_req": 150_000, "seed": 3,
                    "policy": "open"},
}

TRACE_FIELDS = ("gap", "bank", "row", "is_write", "dep", "next_same",
                "length")
#: the per-core request arrays stored for each workload (``next_same`` and
#: the padding are rebuilt by ``batch_traces``)
STORED_FIELDS = ("gap", "bank", "row", "is_write", "dep", "length")


def trace_sha256(batch) -> str:
    """Digest of a ``TraceBatch``'s arrays (field order, native bytes)."""
    h = hashlib.sha256()
    for f in TRACE_FIELDS:
        a = np.ascontiguousarray(getattr(batch, f))
        h.update(f"{f}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def build_batch(traces_mod, spec: dict):
    """The workload's ``TraceBatch`` from either package's ``traces``."""
    if "name" in spec:
        return traces_mod.single_core_batch(spec["name"], spec["n_req"],
                                            seed=spec["seed"])
    names = traces_mod.random_mixes(20, spec["n_cores"],
                                    seed=spec["mix_seed"])[spec["mix_index"]]
    return traces_mod.multicore_batch(names, spec["n_req"], seed=spec["seed"])


def load() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def save_batches(batches: dict) -> None:
    """Store ``{workload: TraceBatch}`` as the golden traces."""
    np.savez_compressed(TRACES_PATH, **{
        f"{w}.{f}": np.asarray(getattr(b, f))
        for w, b in batches.items() for f in STORED_FIELDS})


def load_batch(traces_mod, wname: str):
    """The stored trace of workload ``wname`` as ``traces_mod``'s
    ``TraceBatch``; raises if its digest is not the recorded one."""
    with np.load(TRACES_PATH) as z:
        a = {f: z[f"{wname}.{f}"] for f in STORED_FIELDS}
    batch = traces_mod.batch_traces([
        traces_mod.Trace(*(a[f][c, :n] for f in STORED_FIELDS[:-1]))
        for c, n in enumerate(a["length"])])
    want = load()["workloads"][wname]["trace_sha256"]
    if trace_sha256(batch) != want:
        raise ValueError(f"stored {wname} trace does not match its digest")
    return batch
