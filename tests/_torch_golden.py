"""Writes the golden full-size reference of the PyTorch/CUDA port.

Runs the JAX package (``repro``) on the CPU over the two full-size
workloads of ``repro_torch.golden.WORKLOADS`` and records, per mechanism
kind (default ``MechanismConfig``, ``rltl=True``), the exact-int stats
the port must reproduce bit for bit: ``BITWISE_KEYS``, ``core_end`` and
the RLTL histogram, plus a sha256 of each trace's arrays.
It also stores the traces themselves (``golden_traces.npz``), since numpy's
random streams differ between numpy versions.  ``chip_smoke.py`` reads
only these two files (``src/repro_torch/data/``).

Run from the repo root (about a minute on two CPU cores):

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python tests/_torch_golden.py
"""

from __future__ import annotations

import json
import sys

from repro_torch.golden import (GOLDEN_PATH, WORKLOADS, build_batch,
                                save_batches, trace_sha256)


def cell_record(stats: dict, keys) -> dict:
    rec = {k: int(stats[k]) for k in keys}
    rec["core_end"] = [int(x) for x in stats["core_end"]]
    rec["rltl_hist"] = [int(x) for x in stats["rltl_hist"]]
    rec["rltl_total"] = int(stats["rltl_total"])
    return rec


def batches() -> dict:
    """The full-size traces, from ``repro``'s generator."""
    from repro.core import traces
    return {w: build_batch(traces, spec) for w, spec in WORKLOADS.items()}


def compute(trace_batches: dict) -> dict:
    from _parity import BITWISE_KEYS
    from repro.core import MechanismConfig, SimConfig, sweep
    from repro.experiment import registry

    out = {"bitwise_keys": list(BITWISE_KEYS), "kinds": list(registry.names()),
           "workloads": {}}
    for wname, spec in WORKLOADS.items():
        batch = trace_batches[wname]
        grid = [SimConfig(mech=MechanismConfig(kind=k), policy=spec["policy"])
                for k in registry.names()]
        res = sweep(batch, grid, rltl=True)
        out["workloads"][wname] = {
            **spec,
            "n_steps": int(batch.length.sum()),
            "trace_sha256": trace_sha256(batch),
            "results": {k: cell_record(r, BITWISE_KEYS)
                        for k, r in zip(registry.names(), res)},
        }
    return out


def main() -> int:
    tb = batches()
    data = compute(tb)
    GOLDEN_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(GOLDEN_PATH, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    save_batches(tb)
    for wname, w in data["workloads"].items():
        print(wname, {k: r["total_cycles"] for k, r in w["results"].items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
