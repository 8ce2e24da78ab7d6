"""Every figure and study of the port in one run (port of
``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows, one section a driver, then
the kernel launches the run made.  With ``--json DIR`` it writes
``DIR/BENCH_results.json`` (name -> us_per_call, derived and its parsed
values, ``repro``'s layout) and each study's own document as
``DIR/BENCH_<name>.json``; without it nothing is written.  A driver that
raises is reported as an ``ERROR`` row and the run exits non-zero after
the others.

::

    python -m repro_torch.figures.run [--quick] [--device cpu] [--json DIR] [--only a,b]
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time
import traceback

from repro_torch.figures import common as C

#: (name, module, takes sizes and device, writes a JSON document), in
#: ``repro``'s order
DRIVERS = (
    ("charge_model", "charge_model", False, False),
    ("rltl", "rltl", True, False),
    ("sweep", "sweep_bench", True, False),
    ("speedup", "speedup", True, False),
    ("energy", "energy", True, False),
    ("capacity", "capacity", True, False),
    ("duration", "duration", True, False),
    ("geometry", "geometry", True, True),
    ("aldram", "aldram", True, True),
    ("refresh", "refresh", True, True),
    ("frfcfs", "frfcfs", True, False),
    ("workloads", "workloads", True, True),
    ("serving", "serving_trace", True, False),
    ("serving_loop", "serving_loop", True, True),
    ("megasweep", "megasweep", True, True),
)


def parse_derived(derived: str) -> dict:
    """``k=v;k2=v2`` -> dict, numeric values parsed."""
    out = {}
    for item in derived.split(";"):
        if "=" not in item:
            continue
        k, _, v = item.partition("=")
        try:
            out[k] = float(v)
        except ValueError:
            out[k] = v
    return out


def record(results: dict, row: str) -> None:
    name, _, rest = row.partition(",")
    us, _, derived = rest.partition(",")
    try:
        us_val = float(us)
    except ValueError:
        us_val = None
    results[name] = {"us_per_call": us_val, "derived": derived,
                     "values": parse_derived(derived)}


def run_all(sizes: C.Sizes = C.THESIS, device=None, json_dir=None,
            only=None) -> tuple[dict, list]:
    """Run the figures and studies (``only``: a set of names), printing
    each row; returns ``(results, the names that raised)``."""
    results: dict = {}
    failed = []
    for name, mod_name, sized, artifact in DRIVERS:
        if only is not None and name not in only:
            continue
        mod = importlib.import_module(f"repro_torch.figures.{mod_name}")
        kw = {}
        if artifact and json_dir is not None:
            kw["json_path"] = os.path.join(json_dir, f"BENCH_{name}.json")
        try:
            rows = mod.run(sizes, device, **kw) if sized else mod.run()
            for row in rows:
                print(row, flush=True)
                record(results, row)
        except Exception as e:
            failed.append(name)
            traceback.print_exc()
            print(f"{name},0,ERROR:{type(e).__name__}", flush=True)
            results[name] = {"us_per_call": None, "derived": None,
                             "error": type(e).__name__}
    if json_dir is not None:
        C.write_json(os.path.join(json_dir, "BENCH_results.json"), results)
    return results, failed


def main(argv=None) -> int:
    from repro_torch.kernels.hcrac import ops as hops
    from repro_torch.kernels.sim_step import ops
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="repro's CI sizes instead of the thesis's")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain engine (default: the card)")
    ap.add_argument("--json", default=None, metavar="DIR",
                    help="write BENCH_results.json and the studies' "
                         "documents under DIR")
    ap.add_argument("--only", default=None,
                    help="comma-separated driver names")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    print("name,us_per_call,derived", flush=True)
    t0 = time.time()
    _, failed = run_all(C.QUICK if args.quick else C.THESIS, args.device,
                        args.json, only)
    print(f"# {time.time() - t0:.1f} s; launches: sim_step {ops.launches}, "
          f"sim_synth {ops.synth_launches}, sim_serve {ops.serve_launches}, "
          f"sim_window {ops.window_launches}, hcrac {hops.launches}")
    if failed:
        print(f"# failed: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
