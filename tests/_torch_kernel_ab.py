"""Times the ``sim_step`` kernel's trace entry built from several CUDA
sources in one run on the card, so two versions of the kernel (say, a
parent commit's ``sim_step.cu`` and this tree's) are compared on the
same card, in turns.

For each ``NAME=PATH`` argument it builds ``PATH`` through the port's own
``repro_torch._build.build`` (same flags, content-keyed under
``build/kernels/``), prints what ptxas reports (registers, spills) for
each entry, then runs the full-size trace sweeps of ``chip_smoke.py``
phase 3 — the 38-point eight-core grid over 280 400 steps and the
8-point single-core sweep over 150 000 — with every library in turn, forward then backward, each a
CUDA-event median of 3 after a warm-up.  Every library's stats must equal
the first's.  Only the trace entry's C interface (``sim_step_launch``,
bound by ``kernel.bind_trace_entry``) is used, so any version of the
source builds and runs.

Run from the root of a checkout on a machine with the card:

    python tests/_torch_kernel_ab.py parent=old/sim_step.cu \\
        tree=src/repro_torch/kernels/sim_step/csrc/sim_step.cu
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.core import mechanisms, simulator as sim  # noqa: E402
from repro_torch.core import timing, traces  # noqa: E402
from repro_torch.golden import load_batch  # noqa: E402
from repro_torch.kernels.sim_step import kernel  # noqa: E402


def build(name: str, src: Path) -> ctypes.CDLL:
    lib = _build.build(f"ab_{name}", [src])
    for line in lib.with_suffix(".log").read_text().splitlines():
        entry = re.search(r"(sim_[a-z]+_kernel)", line)
        if "entry function" in line and entry:
            print(f"  {name}: {entry.group(1)}")
        elif "registers" in line or "spill" in line:
            print(f"  {name}:   {line.strip()}")
    return kernel.bind_trace_entry(ctypes.CDLL(str(lib)))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sources = dict(a.split("=", 1) for a in argv[1:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = {n: build(n, Path(p)) for n, p in sources.items()}
    batch8 = load_batch(traces, "eight_core")
    batch1 = load_batch(traces, "single_core")
    args8 = cs.launch_inputs(sim, batch8, cs.heat_grid(sim, timing))
    args1 = cs.launch_inputs(sim, batch1, [
        sim.SimConfig(mech=sim.MechanismConfig(kind=k), policy="open")
        for k in mechanisms.names()])
    times = {n: {"eight_core": [], "single_core": []} for n in libs}
    first = None
    for name in list(libs) + list(libs)[::-1]:
        kernel.library = lambda name=name: libs[name]
        stats = kernel.sim_step(*args8)[0]
        torch.cuda.synchronize()
        stats = torch.stack([stats[k] for k in sim.STAT_KEYS])
        first = stats if first is None else first
        bad = int((stats != first).sum())
        for cell, args in (("eight_core", args8), ("single_core", args1)):
            times[name][cell].append(
                cs.median_ms(lambda args=args: kernel.sim_step(*args)))
        print(f"{name}: eight-core {times[name]['eight_core'][-1]:.2f} ms, "
              f"single-core {times[name]['single_core'][-1]:.2f} ms, stats "
              f"differing from the first library's: {bad}", flush=True)
        if bad:
            return 1
    for name, t in times.items():
        print(f"{name}: median eight-core "
              f"{statistics.median(t['eight_core']):.2f} ms, single-core "
              f"{statistics.median(t['single_core']):.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
