"""The streaming mega-sweep engine (port of ``benchmarks/megasweep.py``).

Two arms a grid size, each in its own subprocess so that ``ru_maxrss``
isolates the arm's peak host memory (on the card it includes the CUDA
context and the kernel library, alike in both arms; the row's
``rss_start_mb`` is the peak before the run, after they are loaded):

* ``full``: the object-cell path with ``pipeline_depth=0`` (launch, then
  drain, one chunk at a time): a stats dict a grid point, finished on
  the host;
* ``streamed``: ``reduce=`` (each chunk's metric ingredients lowered on
  the device), two chunks in flight and a ``ResultsWriter`` JSONL sink
  (``stream_to``): the host holds only ``[chunk, n_deps]`` integer
  columns and the grid's float metric arrays.

The grid is capacity x caching duration (500 distinct configurations)
times a label-only ``rep`` axis (``register_axis``) with ``dedup=False``,
so every replica launches, over 16-request streams in chunks of 512
points.  The parent holds the two arms' metric arrays equal bitwise,
the streamed arm's peak RSS to at most 1.05x the full arm's, and at 10**5
points (full size) the streamed arm to at least 1.2x the full arm's
points a second; each arm checks that it made more than one chunk and
that its launches equal the runner's plan (one a chunk on the card).
``--json PATH`` writes the flat numbers.

::

    python -m repro_torch.figures.megasweep [--quick] [--device cpu] [--json PATH]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.figures import common as C

#: metrics every arm gives; the streamed arm lowers exactly their
#: integer ingredients on the device (the metrics registry)
METRICS = ("avg_latency", "row_hit_rate", "total_cycles")
CAPS = (64, 128, 256, 1024)
N_DUR = 125  # capacity x duration = 500 distinct configurations
CHUNK = 512
N_REQ = 16  # short streams a point: launch economics dominate
#: the grid size of the headline (streamed >= 1.2x full points a second)
HEADLINE_POINTS = 100_000
HEADLINE_SPEEDUP = 1.2
RSS_SLACK = 1.05


def experiment(mode: str, n_points: int, device=None):
    """One arm's Experiment over ``n_points`` grid points (rounded down
    to whole replicas of the 500 configurations)."""
    from repro_torch.core.traces import single_core_batch
    from repro_torch.experiment import Experiment
    from repro_torch.experiment.spec import AXIS_BUILDERS, register_axis

    if "rep" not in AXIS_BUILDERS:
        # label-only replication: a mega-grid's seeds / replicas
        # dimension; param staging stacks the 500 distinct configs once
        # while every replica still launches (dedup=False)
        register_axis("rep")(lambda cfg, v: cfg)

    durs = tuple(np.round(np.linspace(0.5, 8.0, N_DUR), 6).tolist())
    reps = max(1, n_points // (len(CAPS) * N_DUR))
    batch = single_core_batch("stream_copy_like", N_REQ, seed=0)
    kw = dict(reduce=METRICS, pipeline_depth=2) if mode == "streamed" \
        else dict(pipeline_depth=0)
    return Experiment(
        traces=batch, base=C.sim_cfg("chargecache", 1),
        axes={"capacity": CAPS, "duration_ms": durs,
              "rep": tuple(range(reps))},
        metrics=METRICS, chunk_size=CHUNK, dedup=False, device=device, **kw)


def child(mode: str, n_points: int, out_npz: str, stream_to: str,
          device=None) -> dict:
    """One arm: run it, save the metric arrays for the parent's bitwise
    comparison, and return its time, peak RSS and launches."""
    import resource

    maxrss = lambda: resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024.0
    if device is None or str(device).startswith("cuda"):
        # the CUDA context and the kernel library, before the run: their
        # share of the arm's peak RSS
        import torch
        from repro_torch.kernels.sim_step import kernel
        torch.zeros(1, device=device or "cuda")
        kernel.library()
    rss_start = maxrss()
    exp = experiment(mode, n_points, device)
    run_kw = {"stream_to": stream_to} if mode == "streamed" else {}
    (res, launches), us = C.timed(C.launch_counted, exp.run, **run_kw)
    C.check_launches(f"the {mode} arm's {res.meta['n_chunks']} chunks", res,
                     launches)
    if res.meta["n_chunks"] < 2:
        raise AssertionError(f"one chunk only: {res.meta}")
    if res.streamed != (mode == "streamed"):
        raise AssertionError(f"the {mode} arm's Results streamed="
                             f"{res.streamed}")
    np.savez(out_npz, **{m: res.metric(m) for m in METRICS})
    n = int(np.prod(res.shape))
    return {"mode": mode, "n_points": n, "sec": us / 1e6,
            "points_per_sec": n / (us / 1e6),
            "maxrss_mb": maxrss(), "maxrss_start_mb": rss_start,
            "n_chunks": res.meta["n_chunks"], "launches": launches}


def run_arm(mode: str, n_points: int, tmp: str, device=None) -> tuple:
    """One arm in a subprocess of its own; returns its result and the
    path of its metric arrays."""
    import repro_torch
    out_npz = os.path.join(tmp, f"{mode}_{n_points}.npz")
    stream_to = os.path.join(tmp, f"{mode}_{n_points}.jsonl")
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "repro_torch.figures.megasweep", "--child",
           mode, str(n_points), out_npz, stream_to]
    if device is not None:
        cmd += ["--device", str(device)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise AssertionError(f"megasweep {mode}/{n_points} arm failed:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):]), out_npz


def study(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    # "quick": the grid stops short of the headline's size
    art: dict = {"quick": max(sizes.megasweep) < HEADLINE_POINTS,
                 "chunk": CHUNK, "n_req": N_REQ, "metrics": list(METRICS)}
    arms, growth = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in sizes.megasweep:
            full, full_npz = run_arm("full", n, tmp, device)
            streamed, str_npz = run_arm("streamed", n, tmp, device)
            if full["n_points"] != streamed["n_points"]:
                raise AssertionError(f"arms differ in size: {full} "
                                     f"{streamed}")
            a, b = np.load(full_npz), np.load(str_npz)
            for m in METRICS:
                if not np.array_equal(a[m], b[m]):
                    raise AssertionError(
                        f"streamed metrics diverge from materialized at "
                        f"n={n}, metric {m!r}")
            speedup = streamed["points_per_sec"] / full["points_per_sec"]
            for mode, r in (("full", full), ("streamed", streamed)):
                art[f"pps_{mode}_{n}"] = round(r["points_per_sec"], 1)
                art[f"rss_mb_{mode}_{n}"] = round(r["maxrss_mb"], 1)
                growth.setdefault(mode, []).append(r["maxrss_mb"])
            art[f"speedup_{n}"] = round(speedup, 3)
            arms[n] = {"full": full, "streamed": streamed,
                       "speedup": speedup,
                       "metrics": {m: np.array(a[m]) for m in METRICS}}
            # streamed never holds the object cells the full arm does
            if streamed["maxrss_mb"] > full["maxrss_mb"] * RSS_SLACK:
                raise AssertionError(
                    f"streamed peak RSS {streamed['maxrss_mb']:.0f} MB above "
                    f"materialized {full['maxrss_mb']:.0f} MB at n={n}")
    # peak host memory scales with the chunk, not the grid
    for mode in ("full", "streamed"):
        art[f"rss_growth_mb_{mode}"] = round(
            growth[mode][-1] - growth[mode][0], 1)
    big = max(sizes.megasweep)
    if big >= HEADLINE_POINTS and arms[big]["speedup"] < HEADLINE_SPEEDUP:
        raise AssertionError(
            f"streamed+pipelined must be >= {HEADLINE_SPEEDUP}x the "
            f"blocking materialized path at {big} points, got "
            f"{arms[big]['speedup']:.2f}x")
    return {"arms": arms, "document": art}


def rows(out: dict) -> list[str]:
    rows = []
    for n, a in out["arms"].items():
        full, streamed = a["full"], a["streamed"]
        rows.append(C.csv_row(
            f"megasweep_{n}", full["sec"] * 1e6,
            f"pps_full={full['points_per_sec']:.0f}"
            f";pps_streamed={streamed['points_per_sec']:.0f}"
            f";speedup={a['speedup']:.2f}"
            f";rss_full_mb={full['maxrss_mb']:.0f}"
            f";rss_streamed_mb={streamed['maxrss_mb']:.0f}"
            f";rss_start_mb={full['maxrss_start_mb']:.0f}"
            f";chunks={streamed['n_chunks']}"
            f";launches={streamed['launches']}"))
    return rows


def run(sizes: C.Sizes = C.THESIS, device=None, json_path=None) -> list[str]:
    out = study(sizes, device)
    C.write_json(json_path, out["document"])
    return rows(out)


def _child_main(argv) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("full", "streamed"))
    ap.add_argument("n_points", type=int)
    ap.add_argument("out_npz")
    ap.add_argument("stream_to")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    r = child(a.mode, a.n_points, a.out_npz, a.stream_to, a.device)
    print("RESULT " + json.dumps(r), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        _child_main(sys.argv[2:])
    else:
        C.main(run, __doc__.splitlines()[0], artifact=True)
