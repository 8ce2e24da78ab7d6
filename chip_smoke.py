#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the ``sim_step`` kernel (both entries: over a trace, and
synthesising its own streams) from the sources in the checkout, holds
each entry against its plain PyTorch version, drives the port's two
paths at full size (``repro_torch.core.simulator.sweep`` and
``sweep_synth``), checks the results against the JAX package's recorded
golden numbers (``src/repro_torch/data/golden_fullwidth.json`` and
``golden_synth.json``), and times the kernel.  It imports nothing of JAX
or of the ``repro`` package.  Phases:

1. the card's name and power limit, and the kernel's build time;
2. kernel against plain version (both on the card) at <= 2 000
   requests: every mechanism kind x 2 geometries, open and closed
   policy, stateful and legacy refresh, the ``ramp`` thermal schedule, a
   point folded into a padded 32-bank envelope, exact HCRAC expiry, and
   padded steps; then the full-size grid's inputs at a cut depth.  Every
   stat, bank array, ``core_end``, event gid lane and event time lane
   (where its gid is live) must agree exactly;
3. the main path at full size, on the stored traces the golden numbers
   were computed on (``golden_traces.npz``): the eight-core mix at 40 000
   requests a core over the 8 kinds plus a 30-point ChargeCache capacity
   x duration grid (one 38-point sweep), then single-core ``milc_like``
   at 150 000 requests over the 8 kinds, both with the RLTL post-pass;
   the 8-kind results must equal the golden file and order base <
   chargecache < cc_nuat < lldram by weighted speedup;
4. the synthesis entry against its plain version at a cut depth (1 500
   requests a core): on a 4-core mix, every kind x the 4 interleaves x
   ``ddr3_1ch`` / ``ddr3_2ch`` / a 32-bank geometry (the others padded
   into its envelope) x open and closed policy x stateful and legacy
   refresh, a phased spec on part of the points; then phase 5's 32
   points (8 cores, 1 024 HCRAC entries) cut to that depth.  The
   generated streams, every output as in phase 2, and the
   ``reduce_keys`` launch must agree exactly;
5. the synthesis path at full size: the 32-point grid of
   ``benchmarks/workloads.py::synth_grid`` (``repro_torch.golden.SYNTH``:
   two 8-core mixes at 40 000 requests a core x 4 interleaves x 2
   geometries x {base, chargecache}) through ``sweep_synth``; the
   kernel's full-size streams must equal the plain generator's on the
   card bit for bit; each stream is held to the golden digest of
   ``repro``'s stream, and where the digests match the stats must equal
   the golden numbers bit for bit, elsewhere at most
   ``MAX_DIFF_BLOCK_SHARE`` of the stream's blocks may differ and the
   stats are held to the generator's statistical tolerance
   (``repro_torch.golden.STAT_TOLERANCE``); kernel time, ns per step,
   the pre-pass share (a launch of 0 scan steps) and the bytes bound;
6. one JSON line of kernel numbers;
7. the last line: ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line is printed.  Exits
non-zero at once when no CUDA device is available.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
#: full-size workloads (benchmarks/common.py sizes, thesis Table 5.1)
HEAT_CAPS = (32, 64, 128, 256, 512, 1024)
HEAT_DURATIONS_MS = (0.5, 1.0, 2.0, 4.0, 16.0)
#: cut depth of the full-shape kernel-vs-plain comparison
CUT_STEPS = 1000
#: requests a core of the synthesis entry's kernel-vs-plain comparison
SYNTH_CUT_REQ = 1500
#: the largest share of a full-size stream's 1 000-position blocks that
#: may differ from ``repro``'s (float32 draws an ulp apart; at most 7 of
#: 320 differed on the H100)
MAX_DIFF_BLOCK_SHARE = 0.05
#: the metric ingredients of the reduced launches
REDUCE_KEYS = ("n_req", "acts", "hcrac_hits", "row_hits", "row_conflicts",
               "lat_sum", "total_cycles")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, sync):
    """Time ``fn()`` on the current stream with CUDA events, in ms."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    sync()
    return start.elapsed_time(end), out


def median_ms(fn, reps: int = 3) -> float:
    """One warm-up call, then the median of ``reps`` CUDA-event timings."""
    import torch
    fn()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(fn, torch.cuda.synchronize)[0]
                             for _ in range(reps))


# --------------------------------------------------------------------------
# phase 2: kernel against plain version
# --------------------------------------------------------------------------

def launch_inputs(sim, batch, grid, pad_steps=False, n_steps=None,
                  device="cuda"):
    """The arguments ``sweep`` hands to ``ops.run_sweep`` (events on)."""
    import torch
    return sim._stage(batch, grid, torch.device(device), pad_steps,
                      n_steps=n_steps) + (True,)


def compare_outputs(got, want) -> tuple[int, int]:
    """``(mismatching elements, max absolute difference)`` between two
    ``run_sweep`` outputs: stats, bank arrays, core_end and event gid
    lanes everywhere, each event time lane where its gid lane is live."""
    (gs, gc, ge), (ws, wc, we) = got, want
    pairs = [(gs[k], ws[k]) for k in ws] + [(gc, wc),
                                           (ge.act_ref8, we.act_ref8)]
    for gid_f, t_f in (("act_gid", "act_t"), ("pre1_gid", "pre1_t"),
                       ("pre2_gid", "pre2_t"), ("pre3_gid", "pre3_t")):
        w_gid = getattr(we, gid_f)
        live = w_gid >= 0
        pairs += [(getattr(ge, gid_f), w_gid),
                  (getattr(ge, t_f)[live], getattr(we, t_f)[live])]
    bad = err = 0
    for a, b in pairs:
        d = (a.to(b.device).long() - b.long()).abs()
        bad += int((d != 0).sum())
        err = max(err, int(d.max()) if d.numel() else 0)
    return bad, err


def phase_kernel_vs_plain(sim, traces, aldram, ops, ref, device="cuda"):
    """Hold the kernel against the plain version over the phase-2
    matrix; returns the largest absolute difference seen (0 when every
    case agrees, else it raises)."""
    import torch
    from repro_torch.core import mechanisms as registry
    from repro_torch.core.dram import DRAMConfig
    from repro_torch.core.hcrac import HCRACConfig

    ramp = aldram.ThermalConfig(points=((0.0, 55.0), (0.02, 70.0),
                                        (0.04, 85.0)))
    kinds = registry.names()
    geoms = (DRAMConfig(n_channels=1), DRAMConfig(n_channels=2, n_banks=16))
    cases = {
        # every kind x 2 geometries x policy x refresh tier; the 1-channel
        # points sit in the 32-bank envelope of the 2 x 16-bank geometry
        "kinds_geoms_policies": (
            traces.single_core_batch("milc_like", 1400, seed=5),
            [sim.SimConfig(dram=g, mech=sim.MechanismConfig(kind=k),
                           policy=pol, refresh_mode=rm)
             for g in geoms for k in kinds for pol in ("open", "closed")
             for rm in ("stateful", "legacy")], False),
        # multi-core, ramp drift, a 4-bank point padded to 32 banks,
        # padded (dead) steps
        "ramp_multicore_padded": (
            traces.multicore_batch(["milc_like", "mcf_like", "lbm_like",
                                    "hmmer_like"], 450, seed=2),
            [sim.SimConfig(dram=g, mech=sim.MechanismConfig(
                kind=k, thermal=ramp if k in ("nuat", "aldram", "cc_aldram")
                else aldram.ThermalConfig()), policy=pol)
             for g in (DRAMConfig(n_channels=1, n_banks=4),
                       DRAMConfig(n_channels=2, n_banks=16))
             for k in kinds for pol in ("open", "closed")], True),
        "exact_expiry": (
            traces.single_core_batch("mcf_like", 1500, seed=1),
            [sim.SimConfig(mech=sim.MechanismConfig(
                kind=k, hcrac=HCRACConfig(n_entries=n, exact_expiry=True)),
                policy=pol)
             for k in ("chargecache", "cc_nuat", "cc_aldram")
             for n in (32, 256) for pol in ("open", "closed")], False),
    }
    max_err = 0
    for name, (batch, grid, pad) in cases.items():
        args = launch_inputs(sim, batch, grid, pad_steps=pad, device=device)
        got = ops.run_sweep(*args)
        want = ref.run_sweep_ref(*args)
        bad, err = compare_outputs(got, want)
        max_err = max(max_err, err)
        print(f"  {name}: {len(grid)} points x {args[6]} steps, "
              f"mismatches {bad}", flush=True)
        check(bad == 0, f"kernel disagrees with plain version on {name}")
    return max_err


def heat_grid(sim, timing):
    """The 38-point full-size grid: the 8 kinds, then ChargeCache over
    capacity x caching duration (examples/chargecache_sim.py's grid)."""
    from repro_torch.core import mechanisms as registry
    from repro_torch.core.hcrac import HCRACConfig
    grid = [sim.SimConfig(mech=sim.MechanismConfig(kind=k), policy="closed")
            for k in registry.names()]
    for cap in HEAT_CAPS:
        for ms in HEAT_DURATIONS_MS:
            grid.append(sim.SimConfig(policy="closed", mech=sim.MechanismConfig(
                kind="chargecache",
                hcrac=HCRACConfig(n_entries=cap,
                                  caching_cycles=timing.ms_to_cycles(ms)),
                lowered=timing.lowered_for_duration(ms))))
    return grid


def check_golden(golden_w: dict, kinds, results) -> int:
    """Bitwise comparison of the 8-kind results with the golden record;
    returns the number of mismatching values."""
    bad = 0
    for k, r in zip(kinds, results):
        g = golden_w["results"][k]
        for key, want in g.items():
            got = r[key]
            got = [int(x) for x in got] if isinstance(want, list) else int(got)
            if got != want:
                bad += 1
                print(f"  MISMATCH {k}.{key}: got {got} want {want}")
    return bad


def print_table(title, kinds, results, sim):
    base = results[list(kinds).index("base")]
    print(f"\n{title}")
    print(f"  {'mechanism':<12}{'total_cycles':>14}{'acts':>10}"
          f"{'hcrac_hits':>12}{'rltl_total':>12}{'WS speedup':>12}")
    ws = {}
    for k, r in zip(kinds, results):
        ws[k] = sim.weighted_speedup(base["core_end"], r["core_end"])
        print(f"  {k:<12}{r['total_cycles']:>14}{r['acts']:>10}"
              f"{r['hcrac_hits']:>12}{r['rltl_total']:>12}{ws[k]:>12.4f}")
    return ws


def bytes_moved(batch, n_points, n_geom, n_steps, params_row, nb, n_segs):
    """Bytes the sweep must move: each input read once (trace arrays,
    lookahead tables, packed params), each output written once (stats,
    bank stats, core_end, 8 int32 + 1 bool event lanes per step)."""
    C, L = batch.gap.shape
    inputs = (C * L * (3 * 4 + 2) + C * 4 + n_geom * C * L
              + n_points * (params_row + n_segs) * 4)
    outputs = n_points * (4 * (16 + 2 * nb + C) + n_steps * (8 * 4 + 1))
    return inputs + outputs


# --------------------------------------------------------------------------
# phases 4-5: the synthesis entry
# --------------------------------------------------------------------------

def compare_streams(got: dict, want: dict) -> int:
    """Mismatching elements between two generated ``[G, C, L]`` streams."""
    return sum(int((got[k] != want[k].to(got[k].device)).sum())
               for k in ("gap", "bank", "row", "is_write", "dep",
                         "next_same"))


def synth_cut_grid(sim, traces):
    """Phase 4's grid: every kind x interleave x 3 geometries x policy x
    refresh tier on a 4-core mix, half of the (kind, interleave) cells on
    a two-phase spec."""
    from repro_torch.core import mechanisms as registry
    from repro_torch.core.dram import DRAMConfig, INTERLEAVE_KINDS
    from repro_torch.core.dram import InterleaveConfig
    names = ("mcf_like", "hmmer_like", "lbm_like", "milc_like")
    flat = traces.WorkloadSpec(names=names, n_req=SYNTH_CUT_REQ, seed=-3)
    phased = traces.WorkloadSpec(
        names=names, n_req=SYNTH_CUT_REQ, seed=11,
        phases=((0.3, ("stream_copy_like",) * 4),
                (0.7, ("omnetpp_like", "gcc_like", "lbm_like", "mcf_like"))))
    geoms = (DRAMConfig(n_channels=1), DRAMConfig(n_channels=2),
             DRAMConfig(n_channels=2, n_banks=16))
    return [sim.SimConfig(dram=g, mech=sim.MechanismConfig(kind=k),
                          policy=pol, refresh_mode=rm,
                          interleave=InterleaveConfig(il),
                          workload=phased if (ki + ii) % 2 else flat)
            for g in geoms for ki, k in enumerate(registry.names())
            for ii, il in enumerate(INTERLEAVE_KINDS)
            for pol in ("open", "closed") for rm in ("stateful", "legacy")]


def synth_vs_plain(sim, ops, ref, name, grid, device="cuda"):
    """Hold the synthesis entry against the plain version on ``grid``;
    returns ``(mismatches, max abs err, kernel ms, plain ms, points,
    steps)`` (it raises on any mismatch)."""
    import torch
    args = sim._stage_synth(grid, None, torch.device(device))
    got = ops.run_synth(*args, True, True)
    torch.cuda.synchronize()
    kernel_ms = median_ms(lambda: ops.run_synth(*args, True))
    plain_ms, want = cuda_ms(lambda: ref.run_synth_ref(*args, True, True),
                             torch.cuda.synchronize)
    bad, err = compare_outputs(got[:3], want[:3])
    s_bad = compare_streams(got[3], want[3])
    # the reduced launch (no events) against the plain version's columns
    red = sim.sweep_synth(grid, reduce_keys=REDUCE_KEYS, device=device)
    want_red = sim._reduce_device(want[0], want[1], REDUCE_KEYS).cpu()
    r_bad = int((torch.as_tensor(red) != want_red).sum())
    print(f"  {name}: {len(grid)} points x {args[5]} cores x {args[7]} "
          f"steps ({SYNTH_CUT_REQ} requests a core): kernel "
          f"{kernel_ms:.3f} ms, plain {plain_ms:.1f} ms; mismatches: "
          f"outputs {bad}, streams {s_bad}, reduce_keys {r_bad}",
          flush=True)
    check(bad + s_bad + r_bad == 0,
          f"synthesis entry disagrees with its plain version on {name}")
    return bad + s_bad + r_bad, err, kernel_ms, plain_ms, len(grid), args[7]


def synth_full_grid(sim, golden_mod, timing, n_req=None):
    """Phase 5's 32 full-size points, in ``golden.synth_points()`` order
    (at ``n_req`` requests a core where given)."""
    from repro_torch.core.dram import DRAMConfig, InterleaveConfig
    from repro_torch.core.hcrac import HCRACConfig
    from repro_torch.core.traces import WorkloadSpec
    S = golden_mod.SYNTH
    ms = S["caching_ms"]
    return [sim.SimConfig(
        dram=DRAMConfig(n_channels=S["geometries"][p["geometry"]]),
        mech=sim.MechanismConfig(
            kind=p["mechanism"],
            hcrac=HCRACConfig(n_entries=S["hcrac_entries"],
                              caching_cycles=timing.ms_to_cycles(ms)),
            lowered=timing.lowered_for_duration(ms)),
        policy=S["policy"], interleave=InterleaveConfig(p["interleave"]),
        workload=WorkloadSpec(names=tuple(S["mixes"][p["mix"]]),
                              n_req=n_req or S["n_req"], seed=S["seed"]))
        for p in golden_mod.synth_points()]


def point_batch(traces, stream: dict, i: int):
    """Point ``i``'s generated stream as a ``TraceBatch`` (host)."""
    f = {k: stream[k][i].cpu().numpy() for k in
         ("gap", "bank", "row", "is_write", "dep", "next_same")}
    return traces.TraceBatch(length=stream["length"][i].cpu().numpy(), **f)


def check_synth_golden(golden_mod, traces, gold: dict, results, stream
                       ) -> tuple[int, int, int]:
    """Hold phase 5's streams and stats to the golden record; returns
    ``(streams equal, streams differing, stat values differing where the
    streams are equal)``."""
    same = differ = bad = 0
    for i, (p, r, g) in enumerate(zip(golden_mod.synth_points(), results,
                                      gold["points"])):
        ref_s = gold["streams"][golden_mod.stream_key(p)]
        batch = point_batch(traces, stream, i)
        label = f"{golden_mod.stream_key(p)}/{p['mechanism']}"
        if golden_mod.trace_sha256(batch) == ref_s["sha256"]:
            same += 1
            for key in gold["bitwise_keys"] + ["core_end", "rltl_hist",
                                               "rltl_total"]:
                got = r[key]
                got = ([int(x) for x in got] if isinstance(g[key], list)
                       else int(got))
                if got != g[key]:
                    bad += 1
                    print(f"  MISMATCH {label}.{key}: got {got} want "
                          f"{g[key]}")
            continue
        differ += 1
        blocks = golden_mod.stream_block_digests(batch)
        diff = [(c, b) for c, row in enumerate(ref_s["blocks"])
                for b, d in enumerate(row) if blocks[c][b] != d]
        n_blocks = sum(len(row) for row in ref_s["blocks"])
        off = golden_mod.tolerance_violations(r, g)
        print(f"  stream {label} differs from repro's in {len(diff)} of "
              f"{n_blocks} blocks of {golden_mod.STREAM_BLOCK} positions "
              f"(core, block): {diff[:8]}; stats outside the tolerance: "
              f"{off or 'none'} (total_cycles {r['total_cycles']} vs "
              f"{g['total_cycles']})")
        check(len(diff) <= MAX_DIFF_BLOCK_SHARE * n_blocks,
              f"{label}: {len(diff)} of {n_blocks} blocks differ from "
              f"repro's (at most {MAX_DIFF_BLOCK_SHARE:.0%} may)")
        check(not off, f"{label}: stats outside the statistical tolerance")
    return same, differ, bad


def synth_bytes_moved(G, C, L, n_steps, params_row, nb, n_segs, wrow):
    """Bytes the synthesis launch must move: packed params and workload
    rows read once, stats, bank stats, core_end and event lanes written
    once, and the stream scratch (15 B a position: gap, bank, row and
    three flags) written by the pre-pass and read by the scan."""
    inputs = G * (params_row + n_segs + wrow) * 4
    outputs = G * (4 * (16 + 2 * nb + C) + n_steps * (8 * 4 + 1))
    return inputs + outputs + 2 * G * C * L * 15


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: the repro_torch package is not next to this "
              "script (run it from the root of a checkout)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import aldram, mechanisms, simulator as sim
    from repro_torch.core import timing, traces
    from repro_torch import golden as golden_mod
    from repro_torch.golden import build_batch, load, load_batch, trace_sha256
    from repro_torch.kernels.sim_step import kernel, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 1: the card and the build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    lib = kernel.library()
    print(f"sim_step build+load: {time.time() - t0:.1f} s ({lib._name})")
    log = Path(lib._name).with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")

    # --- phase 2: kernel against plain version --------------------------
    print("\nphase 2: sim_step kernel vs plain version (on the card)",
          flush=True)
    max_err = phase_kernel_vs_plain(sim, traces, aldram, ops, ref)

    golden = load()
    kinds = tuple(golden["kinds"])
    check(kinds == mechanisms.names(), "registered kinds differ from golden")
    w8 = golden["workloads"]["eight_core"]
    w1 = golden["workloads"]["single_core"]
    # the traces the golden numbers were computed on (their digests are
    # checked on load); numpy's random streams differ between versions,
    # so whether this installation's generator gives the same bytes is
    # reported, not required
    batch8 = load_batch(traces, "eight_core")
    batch1 = load_batch(traces, "single_core")
    import numpy as np
    same = [trace_sha256(build_batch(traces, w)) == w["trace_sha256"]
            for w in (w8, w1)]
    print(f"  numpy {np.__version__}: the trace generator reproduces the "
          f"golden traces: {same[0] and same[1]}")
    grid38 = heat_grid(sim, timing)

    # the full-size grid's own inputs at a cut depth
    args = launch_inputs(sim, batch8, grid38, n_steps=CUT_STEPS)
    got = ops.run_sweep(*args)
    torch.cuda.synchronize()
    cut_ms = median_ms(lambda: ops.run_sweep(*args))
    plain_t, want = cuda_ms(lambda: ref.run_sweep_ref(*args),
                            torch.cuda.synchronize)
    cut_bad, cut_err = compare_outputs(got, want)
    max_err = max(max_err, cut_err)
    print(f"  full-size inputs, {len(grid38)} points x {CUT_STEPS} steps: "
          f"kernel {cut_ms:.3f} ms, plain {plain_t:.1f} ms, "
          f"mismatches {cut_bad}", flush=True)
    check(cut_bad == 0, "kernel disagrees with plain version at full size")

    # --- phase 3: the main path at full size -----------------------------
    print("\nphase 3: main path at full size", flush=True)
    ops.launches = ops.synth_launches = 0
    t0 = time.time()
    res8 = sim.sweep(batch8, grid38, rltl=True)
    res1 = sim.sweep(batch1, [sim.SimConfig(
        mech=sim.MechanismConfig(kind=k), policy=w1["policy"])
        for k in kinds], rltl=True)
    wall = time.time() - t0
    launches = ops.launches
    print(f"  sweeps: {len(grid38)} points x {w8['n_steps']} steps, "
          f"{len(kinds)} points x {w1['n_steps']} steps, {wall:.1f} s "
          f"wall (host included), sim_step launches {launches}, "
          f"sim_step_synth launches {ops.synth_launches}")
    check(launches == 2 and ops.synth_launches == 0,
          f"expected 2 sim_step launches, saw {launches}")

    bad = check_golden(w8, kinds, res8[:len(kinds)])
    bad += check_golden(w1, kinds, res1)
    print(f"  golden comparison: {bad} mismatching values")
    check(bad == 0, "main path disagrees with the JAX golden numbers")
    for r in res8 + res1:
        check(r["rltl_hist"].shape == (len(sim.RLTL_EDGES_MS) + 1,)
              and r["core_end"].min() > 0, "malformed stats")
    ws8 = print_table(f"eight-core mix {w8['n_req']} req/core, closed "
                      f"policy", kinds, res8[:len(kinds)], sim)
    print_table(f"single-core {w1['name']} {w1['n_req']} req, open policy",
                kinds, res1, sim)
    check(ws8["base"] < ws8["chargecache"] < ws8["cc_nuat"] < ws8["lldram"],
          "speedup ordering base < chargecache < cc_nuat < lldram broken")
    print("\n  heat grid (ChargeCache, closed): hit rate / WS speedup")
    for i, (cap, ms) in enumerate((c, m) for c in HEAT_CAPS
                                  for m in HEAT_DURATIONS_MS):
        r = res8[len(kinds) + i]
        print(f"    {cap:5d} entries {ms:5.1f} ms: "
              f"{r['hcrac_hit_rate']:.4f} / "
              f"{sim.weighted_speedup(res8[0]['core_end'], r['core_end']):.4f}")

    # kernel times at the main path's shapes
    args8 = launch_inputs(sim, batch8, grid38)
    ms8 = median_ms(lambda: ops.run_sweep(*args8))
    args1 = launch_inputs(sim, batch1, [sim.SimConfig(
        mech=sim.MechanismConfig(kind=k), policy=w1["policy"])
        for k in kinds])
    ms1 = median_ms(lambda: ops.run_sweep(*args1))
    shape8, stacked8 = args8[0], args8[1]
    prow = kernel.pack(stacked8, args8[4])[0].shape[1]
    nbytes = bytes_moved(batch8, len(grid38), args8[3].shape[0],
                         w8["n_steps"], prow,
                         shape8.envelope.max_banks_total,
                         stacked8.thermal.seg_edge.shape[-1])
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"\n  kernel: {len(grid38)}-point eight-core sweep {ms8:.2f} ms "
          f"({ms8 * 1e6 / w8['n_steps']:.0f} ns/step), 8-point single-core "
          f"sweep {ms1:.2f} ms ({ms1 * 1e6 / w1['n_steps']:.0f} ns/step); "
          f"bytes bound {bound_ms:.4f} ms ({nbytes} B)")

    # --- phase 4: the synthesis entry against its plain version ---------
    print("\nphase 4: sim_step synthesis entry vs plain version (on the "
          "card)", flush=True)
    m_bad, m_err = synth_vs_plain(sim, ops, ref, "matrix",
                                  synth_cut_grid(sim, traces))[:2]
    # the full-size grid's points (8 cores, 1 024 HCRAC entries) cut
    (s_bad, s_err, s_cut_ms, s_plain_ms, s_cut_points,
     s_cut_steps) = synth_vs_plain(
        sim, ops, ref, "full-size grid cut",
        synth_full_grid(sim, golden_mod, timing, n_req=SYNTH_CUT_REQ))
    s_bad += m_bad
    s_err = max(s_err, m_err)
    max_err = max(max_err, s_err)

    # --- phase 5: the synthesis path at full size -------------------------
    print("\nphase 5: synthesis path at full size", flush=True)
    gold = golden_mod.load_synth()
    points = golden_mod.synth_points()
    grid32 = synth_full_grid(sim, golden_mod, timing)
    ops.launches = ops.synth_launches = 0
    t0 = time.time()
    res32 = sim.sweep_synth(grid32, rltl=True)
    wall32 = time.time() - t0
    synth_launches = ops.synth_launches
    print(f"  sweep_synth: {len(grid32)} points x {gold['n_steps']} steps, "
          f"{wall32:.1f} s wall (host included), sim_step_synth launches "
          f"{synth_launches}, sim_step launches {ops.launches}")
    check(synth_launches == 1 and ops.launches == 0,
          f"expected 1 sim_step_synth launch, saw {synth_launches}")
    for r in res32:
        check(r["rltl_hist"].shape == (len(sim.RLTL_EDGES_MS) + 1,)
              and r["core_end"].min() > 0 and r["n_req"] > 0,
              "malformed synth stats")
    # the kernel's full-size streams (a launch of 0 scan steps generates
    # them all) against the plain generator's, on the card
    args32 = sim._stage_synth(grid32, None, torch.device("cuda"))
    gen_args = args32[:7] + (0, False)
    stream = kernel.sim_synth(*gen_args, True)[3]
    t0 = time.time()
    plain_stream = ref.run_synth_ref(*gen_args, True)[3]
    torch.cuda.synchronize()
    fs_bad = compare_streams(stream, plain_stream)
    print(f"  full-size streams, kernel vs plain generator "
          f"({time.time() - t0:.1f} s): {fs_bad} mismatching elements",
          flush=True)
    check(fs_bad == 0, "full-size streams differ from the plain generator")
    del plain_stream
    same, differ, g_bad = check_synth_golden(golden_mod, traces, gold, res32,
                                             stream)
    print(f"  golden comparison: {same} streams equal to repro's (their "
          f"stats: {g_bad} mismatching values), {differ} streams differ "
          f"(stats within tolerance)")
    check(g_bad == 0, "synthesis path disagrees with the JAX golden numbers")
    print("\n  ChargeCache weighted speedup over base, per (mix, "
          "interleave, geometry):")
    for i in range(0, len(points), 2):
        p = points[i]
        ws = sim.weighted_speedup(res32[i]["core_end"],
                                  res32[i + 1]["core_end"])
        print(f"    {golden_mod.stream_key(p):<28} {ws:.4f} "
              f"(hcrac hit rate {res32[i + 1]['hcrac_hit_rate']:.4f})")
    ms32 = median_ms(lambda: ops.run_synth(*args32, True))
    gen_ms = median_ms(lambda: kernel.sim_synth(*gen_args))
    n32 = gold["n_steps"]
    wi, wf, _ = kernel.pack_synth(*args32[1:5])
    prow32 = kernel.pack(args32[1], torch.zeros_like(args32[4]))[0].shape[1]
    nbytes32 = synth_bytes_moved(
        len(grid32), args32[5], args32[6], args32[7], prow32,
        args32[0].envelope.max_banks_total,
        args32[1].thermal.seg_edge.shape[-1], wi.shape[1] + wf.shape[1])
    bound32 = nbytes32 / HBM_BYTES_PER_S * 1e3
    print(f"\n  kernel: {len(grid32)}-point synth sweep {ms32:.2f} ms "
          f"({ms32 * 1e6 / n32:.0f} ns/step); generation pre-pass alone "
          f"{gen_ms:.2f} ms ({100 * gen_ms / ms32:.1f} %); bytes bound "
          f"{bound32:.4f} ms ({nbytes32} B)")
    print(smi)

    # --- phase 6: kernel numbers -----------------------------------------
    print(json.dumps({"kernels": [{
        "name": "sim_step", "route": "cuda",
        "source": "src/repro_torch/kernels/sim_step/csrc/sim_step.cu",
        "replaces": "src/repro/kernels/sim_step/kernel.py:66",
        "launches": launches, "max_abs_err": max_err,
        "mismatches": cut_bad,
        "ms": ms8, "plain_ms": plain_t, "plain_steps": CUT_STEPS,
        "ms_at_plain_steps": cut_ms, "steps": w8["n_steps"],
        "points": len(grid38), "single_core_ms": ms1,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}, {
        "name": "sim_step_synth", "route": "cuda",
        "source": "src/repro_torch/kernels/sim_step/csrc/sim_step.cu",
        "replaces": "src/repro/kernels/sim_step/ops.py:65",
        "launches": synth_launches, "max_abs_err": s_err,
        "mismatches": s_bad + fs_bad, "ms": ms32, "plain_ms": s_plain_ms,
        "plain_points": s_cut_points, "plain_steps": s_cut_steps,
        "ms_at_plain_steps": s_cut_ms, "steps": n32,
        "points": len(grid32), "prepass_ms": gen_ms,
        "streams_equal_to_golden": same, "streams_differing": differ,
        "bound_ms": bound32, "bound_by": "bytes", "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
