"""Clock stamps of the ``sim_window`` entry of ``sim_step.cu``: where a
step of the FR-FCFS window engine spends its SM cycles, on the card.

For each ``NAME=PATH`` argument it builds ``PATH`` with ``nvcc`` (the
port's flags, ``-DWINDOW_STAMPS``) into ``build/stamps/``, binds its C
interface (``kernel.bind_window_entry`` and the helper
``sim_window_stamps``, which a stamped source exports), and runs two
launches of chip_smoke phase 17 at full size: the eight-core golden trace
(6 points x 280 400 steps, depth 16: frfcfs windows 8 and 16 and in-order
riders, base and chargecache) and the study's launch
(``figures/frfcfs.py``, 8 points x 320 000 steps, synthesis feed).  A
stamped source keeps, per point, ``clock64()`` sums of: the whole step
loop, the successful admission attempts, the failed ones, the selection,
the service and its bookkeeping, the record fetch on the owner lane (a
part of the successful admissions) and lane 0's event stores (a part of
the service); then the counts of successful and failed attempts and of
steps.  A point that did not run the window loop (an in-order rider,
which the redesigned entry runs on the scan's path) has none.  It prints
each point's cycles a step and the share of each part, and writes them
to ``chiprun_out/window_stamps.json``.  The stamps themselves cost cycles
(a ``clock64`` read each, and the order they force), so the shares,
not the absolute sums, are the result.

Run from the root of a checkout on a machine with the card:

    python tests/_torch_window_stamps.py new=src/repro_torch/kernels/sim_step/csrc/sim_step.cu
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch import golden as golden_mod  # noqa: E402
from repro_torch.core import simulator as sim, traces  # noqa: E402
from repro_torch.kernels.sim_step import kernel, ops  # noqa: E402

#: a stamped source's per-point words, in its order
PARTS = ("loop", "admit_ok", "admit_fail", "select", "service", "fetch",
         "events")
COUNTS = ("n_ok", "n_fail", "steps")
MAX_G = 64


def build(name: str, src: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "stamps" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DWINDOW_STAMPS",
           f"-I{_build.INCLUDE_DIR}", "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "sim_window_kernel" in line or (
                "registers" in line and "window" in line):
            print(f"  {name}: {line.strip()}")
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    lib = kernel.bind_window_entry(kernel.bind_serve_entry(
        kernel.bind_scan_entries(ctypes.CDLL(str(out)))))
    lib.sim_window_stamps.restype = ctypes.c_int
    lib.sim_window_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def read_stamps(lib, G: int) -> list[dict]:
    n = len(PARTS) + len(COUNTS)
    buf = (ctypes.c_ulonglong * (MAX_G * n))()
    err = lib.sim_window_stamps(ctypes.cast(buf, ctypes.c_void_p), MAX_G * n)
    if err:
        raise RuntimeError(f"sim_window_stamps: CUDA error {err}")
    return [dict(zip(PARTS + COUNTS, buf[g * n:(g + 1) * n]))
            for g in range(G)]


def report(label: str, cells: list[tuple[str, dict]]) -> list[dict]:
    rows = []
    for name, st in cells:
        if not st["loop"]:
            print(f"  {label} {name}: no stamps (not the window loop)")
            continue
        steps = max(int(st["steps"]), 1)
        loop = max(int(st["loop"]), 1)
        row = {"point": name, "steps": int(st["steps"]),
               "cycles_per_step": st["loop"] / steps,
               "ok_per_step": st["n_ok"] / steps,
               "fail_per_step": st["n_fail"] / steps,
               **{f"{p}_share": st[p] / loop for p in PARTS[1:]},
               **{f"{p}_cycles_per_step": st[p] / steps for p in PARTS[1:]}}
        rows.append(row)
        print(f"  {label} {name}: {row['cycles_per_step']:.0f} cycles a "
              f"step ({row['ok_per_step']:.2f} successful, "
              f"{row['fail_per_step']:.2f} failed attempts); shares: "
              + ", ".join(f"{p} {100 * row[f'{p}_share']:.1f} % "
                          f"({row[f'{p}_cycles_per_step']:.0f})"
                          for p in PARTS[1:]), flush=True)
    return rows


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sources = dict(a.split("=", 1) for a in argv[1:])
    (grid6, b_args), (study, d_args) = cs.window_full_inputs(
        sim, traces, golden_mod)
    name_of = lambda c: (f"{c.mech.kind} {c.controller}"
                         + ("" if c.controller == "inorder"
                            else f" w{c.window}"))
    launches = {
        "golden": (lambda: ops.run_window(*b_args), grid6),
        "study": (lambda: ops.run_window_synth(d_args[0], cs.WINDOW_DEPTH,
                                               *d_args[1:], False), study)}
    out = {}
    for name, path in sources.items():
        lib = build(name, Path(path))
        kernel.library = lambda lib=lib: lib
        out[name] = {}
        for cell, (fn, grid) in launches.items():
            fn()  # a warm-up
            torch.cuda.synchronize()
            read_stamps(lib, len(grid))
            fn()
            torch.cuda.synchronize()
            st = read_stamps(lib, len(grid))
            out[name][cell] = report(f"{name} {cell}",
                                     [(name_of(c), s)
                                      for c, s in zip(grid, st)])
    dest = ROOT / "chiprun_out" / "window_stamps.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
