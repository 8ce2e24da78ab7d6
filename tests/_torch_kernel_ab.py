"""Times the ``sim_step`` kernel's four entries built from several CUDA
sources in one run on the card, so two versions of the kernel (say, a
parent commit's ``sim_step.cu`` and this tree's) are compared on the
same card, in turns.

For each ``NAME=PATH`` argument it builds ``PATH`` through the port's own
``repro_torch._build.build`` (same flags and include path, content-keyed
under ``build/kernels/``), prints what ptxas reports (registers, spills)
for each entry and a census of its SASS (``cuobjdump -sass``:
instructions, integer-division sequences — one ``MUFU.RCP`` each —,
global and shared-memory loads, warp reductions) for each
``sim_*_kernel`` entry (``sim_step``, ``sim_synth``, ``sim_serve`` and
``sim_window``), then runs the full-size cells of ``chip_smoke.py``
phases 3, 5, 8 and 17 — the trace entry over the 38-point eight-core grid
(280 400 steps) and the 8-point single-core sweep (150 000 steps), the
synthesis entry over the 32-point synth grid (320 000 steps), the
serving entry over the 24-point serving grid (528 steps) and the 10**4-
and 10**5-request scale points (arrivals drawn in the kernel), and the
window entry over the eight-core golden trace (6 points x 280 400 steps)
and the FR-FCFS study's launch (8 points x 320 000 steps with the
synthesis pre-pass) — with every library in turn, forward then
backward, each a CUDA-event median of 3 after a warm-up (of 1 for the
10**5 point).  Every library's outputs must equal the first's: the
scans' and the window entry's stats (and its ``core_end``), and every
output of the serving entry (its stats, counters, clock and per-step
arrays).  Only the entries' C interfaces (``sim_step_launch``,
``sim_synth_launch``, ``sim_serve_launch`` and ``sim_window_launch``,
bound by ``kernel.bind_scan_entries``, ``bind_serve_entry`` and
``bind_window_entry``) are used, so any version of the source since the
window entry was written builds and runs.

Run from the root of a checkout on a machine with the card (the older
source in a directory the checkout's ``.gitignore`` lists, such as
``build/``):

    git show HEAD~1:src/repro_torch/kernels/sim_step/csrc/sim_step.cu \\
        > build/ab/sim_step_parent.cu
    python tests/_torch_kernel_ab.py parent=build/ab/sim_step_parent.cu \\
        tree=src/repro_torch/kernels/sim_step/csrc/sim_step.cu
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch import golden as golden_mod  # noqa: E402
from repro_torch.core import mechanisms, simulator as sim  # noqa: E402
from repro_torch.core import timing, traces  # noqa: E402
from repro_torch.golden import load_batch  # noqa: E402
from repro_torch.kernels.sim_step import kernel  # noqa: E402
from repro_torch.serving.loop import engine  # noqa: E402

CELLS = ("eight_core", "single_core", "synth", "serve_grid", "serve_1e4",
         "serve_1e5", "window_golden", "window_study")


#: SASS mnemonics the census counts, by what they stand for
CENSUS = (("divisions", r"MUFU\.RCP"), ("global loads", r"LDG"),
          ("shared loads", r"LDS"), ("warp reductions", r"REDUX"))


def sass_census(lib: Path) -> dict:
    """``{entry: {"instructions": n, <CENSUS name>: n, ...}}`` of the
    ``sim_*_kernel`` entries of a built library."""
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build.find_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, entry = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?(sim_[a-z]+_kernel)", line)
        if m or "Function :" in line:
            entry = m.group(1) if m else None
            if entry:
                out[entry] = dict.fromkeys(
                    ["instructions", *(k for k, _ in CENSUS)], 0)
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(\S.*?);", line)
        if entry is None or op is None:
            continue
        out[entry]["instructions"] += 1
        for k, pat in CENSUS:
            out[entry][k] += bool(re.search(rf"\b{pat}", op.group(1)))
    return out


def build(name: str, src: Path) -> ctypes.CDLL:
    lib = _build.build(f"ab_{name}", [src])
    for line in lib.with_suffix(".log").read_text().splitlines():
        entry = re.search(r"(sim_[a-z]+_kernel)", line)
        if "entry function" in line and entry:
            print(f"  {name}: {entry.group(1)}")
        elif "registers" in line or "spill" in line:
            print(f"  {name}:   {line.strip()}")
    for entry, counts in sass_census(lib).items():
        print(f"  {name}: {entry} SASS " + ", ".join(
            f"{k} {v}" for k, v in counts.items()))
    return kernel.bind_window_entry(kernel.bind_serve_entry(
        kernel.bind_scan_entries(ctypes.CDLL(str(lib)))))


def outputs(cell: str, out) -> torch.Tensor:
    """A launch's outputs as one int64 vector, to compare libraries."""
    if cell.startswith("window"):
        return torch.cat([torch.stack([out[0][k] for k in sim.STAT_KEYS])
                          .long().ravel(), out[1].long().ravel()])
    if not cell.startswith("serve"):
        return torch.stack([out[0][k] for k in sim.STAT_KEYS]).long().ravel()
    sim_stats, serve, now, ys = out
    parts = [*sim_stats.values(), *serve.values(), now, *(ys or ())]
    return torch.cat([p.long().ravel() for p in parts])


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
    args32 = sim._stage_synth(cs.synth_full_grid(sim, golden_mod, timing),
                              None, torch.device("cuda"))
    dev = torch.device("cuda")
    serve = {"serve_grid": engine.stage_serving(
        cs.serving_grid(sim, golden_mod, timing), None, True, dev)}
    for n_req in (10_000, 100_000):
        serve[f"serve_1e{len(str(n_req)) - 1}"] = engine.stage_serving(
            [cs.scale_config(sim, golden_mod, n_req)], None, False, dev)
    (_, win8), (_, study) = cs.window_full_inputs(sim, traces, golden_mod)
    launch = {"eight_core": lambda: kernel.sim_step(*args8),
              "single_core": lambda: kernel.sim_step(*args1),
              "synth": lambda: kernel.sim_synth(*args32),
              **{c: (lambda a=a: kernel.sim_serve(*a))
                 for c, a in serve.items()},
              "window_golden": lambda: kernel.sim_window(*win8),
              "window_study": lambda: kernel.sim_window_synth(
                  study[0], cs.WINDOW_DEPTH, *study[1:], False)}
    steps = {"eight_core": args8[6], "single_core": args1[6],
             "synth": args32[7],
             **{c: a[0].n_steps for c, a in serve.items()},
             "window_golden": win8[7], "window_study": study[7]}
    times = {n: {c: [] for c in CELLS} for n in libs}
    first = {}
    for name in list(libs) + list(libs)[::-1]:
        kernel.library = lambda name=name: libs[name]
        bad = 0
        for cell in CELLS:
            got = outputs(cell, launch[cell]())
            torch.cuda.synchronize()
            first.setdefault(cell, got)
            bad += int((got != first[cell]).sum())
            times[name][cell].append(cs.median_ms(
                launch[cell], reps=1 if cell == "serve_1e5" else 3))
        print(f"{name}: " + ", ".join(
            f"{c} {times[name][c][-1]:.2f} ms "
            f"({times[name][c][-1] * 1e6 / steps[c]:.0f} ns/step)"
            for c in CELLS)
            + f"; stats differing from the first library's: {bad}",
            flush=True)
        if bad:
            return 1
    for name, t in times.items():
        print(f"{name}: median " + ", ".join(
            f"{c} {statistics.median(t[c]):.2f} ms" for c in CELLS))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
