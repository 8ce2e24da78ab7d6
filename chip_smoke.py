#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the ``sim_step`` kernel (three entries: over a trace,
synthesising its own streams, and the serving closed loop), the HCRAC
probe kernel, the flash- and decode-attention kernels and the ssm_scan
kernel from the sources in the checkout, holds each against its plain
PyTorch version, drives the port's six paths at full size
(``repro_torch.core.simulator.sweep``, ``sweep_synth``, the serving
loop: ``sweep_serving`` and the host scheduler's ``run_host``, dense-LM
serving of tinyllama-1.1b: ``prefill_fn`` / ``decode_fn`` and
``examples/serve_lm.py``'s run, SSM serving of falcon-mamba-7b, and the
Experiment layer drawing the thesis's five figures),
checks the results against the JAX package's recorded golden numbers
(``src/repro_torch/data/golden_fullwidth.json``, ``golden_synth.json``,
``golden_serving.json``, ``golden_lm.json`` and ``golden_lm_ssm.json``),
and times the kernels.  It imports nothing of JAX or of the ``repro``
package.  Phases:

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
   chargecache < cc_nuat < lldram by weighted speedup; the kernel times
   with ns per step beside the bytes bound and the dependent-chain bound
   (``CHAIN_CYCLES`` a request at the SM clock ``nvidia-smi`` reads
   during the sweep), and each entry's registers and spills as ptxas
   reports them (no scan entry may spill);
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
   the pre-pass share (a launch of 0 scan steps), the bytes bound and
   the chain bound; then the scans' divider (``kernel.floor_div``)
   against PyTorch's floor division on the card for every divisor of the
   phase 3-5 points, 2**24 dividends each plus the edges;
6. the HCRAC probe kernel against its plain version: tables of 128 and
   1 024 entries (2 ways) and 65 536 (16 ways), both expiry modes, 10**6
   queries with negative gids (Q not a multiple of the 256-thread
   block), then the host scheduler's own table at the few queries of one
   probe; zero mismatches; kernel times against the bytes bound (the
   queries and the table sets they touch);
7. the serving entry against the plain serving engine (both on the
   card) on the 24 points of ``repro_torch.golden.SERVING`` cut to
   ``SERVE_CUT_STEPS`` steps, then on the scale streams' geometry (32
   slots, a 128-entry queue) and on 48 slots with a 200-entry queue and
   48 arrivals a step (past one warp of lanes) under every policy and
   mechanism cut to ``SCALE_CUT_STEPS``: arrivals drawn in the kernel,
   pinned, and a ``reduce_keys`` launch; every output equal, per-step
   arrays included;
8. the serving path at full size: (a) host parity — the host scheduler
   (``run_host``, its probes through the probe kernel) and
   ``simulate_serving`` (the serving entry) on a pinned 320-step
   schedule of 96 requests agree in per-step occupancy, retirement and
   hot-probe stats; (b) the 24-point grid at 528 steps: with the golden
   (``repro``-drawn) counts pinned every stat equals the golden file;
   with counts drawn on the card, they are compared first, and where
   equal the stats must be too, elsewhere at most ``MAX_COUNT_DIFF`` of
   them may differ and every request must retire; (c) the 10**4- and
   10**5-request scale points, timed, every request retired, 10**4 held
   to the golden file as in (b), with the golden counts pinned and with
   counts drawn on the card; the serving entry's times beside its
   dependent-chain bound (``serve_chain_bound``: the DRAM service, the
   hot table's inserts and the scheduler's steps, each at the SM clock
   read during the run; every page access counted by a launch without
   warm-up), its registers and spills;
9. the flash-attention kernel against its plain version (both on the
   card): the count of tensor-core ``HMMA`` instructions in each bf16
   entry of the built library (``cuobjdump -sass``; none fails), then
   ``tests/test_kernels.py``'s matrix (5 shapes x bf16 / f32: hd
   32-128, S not a block multiple, MQA, non-causal, a sliding window)
   and the full-width prefill shapes B 4 x S 500, B 1 x S 4 096 and
   phase 12's B 4 x S 16 (H 32, K 4, hd 64, bf16), and phi4-mini's
   widths B 1 x S 2 048 (H 24, K 8, hd 128): bf16 outputs element by
   element within one bf16 ulp of the plain output plus 1e-5
   (``BF16_RTOL`` / ``BF16_ATOL``) and within 0.02 overall, f32 within
   2e-5; the full-width shapes timed (CUDA events around back-to-back
   calls, and around a CUDA graph of them: the device time a call)
   beside the plain version, ``scaled_dot_product_attention`` and the
   bound;
10. the decode-attention kernel likewise (the HMMA count of its bf16
    entries; element by element as bf16 flash, and within 0.03 overall):
    the matrix (nearly empty cache, W
    not a multiple, a window, MHA, G 48, rings that ``plan_split`` cuts
    into 2, 3, 7 and 33 splits of which all but the first hold no valid
    slot), and the full-width caches B 4, W 520 (516 filled), W 4 100
    (wrapped) and phase 12's W 28 (24 filled), K 4, G 8, hd 64, and
    granite's G 48 over K 1, hd 128, W 4 100; each case with its split
    count and the kernels it launched, as the library counts them;
11. tinyllama-1.1b at its published widths, the golden weights and
    tokens built on the card (digests equal to ``golden_lm.json``'s):
    ``prefill_fn`` on 4 x 500 tokens (cache 520), then 16 teacher-forced
    ``decode_fn`` steps, each step's top-8 logits and logsumexp within
    ``LM_LOGIT_TOL`` of ``repro``'s and the argmax equal where
    ``repro``'s margin exceeds twice that; 22 flash and 22 x 16 decode
    calls, each a split kernel and a combine launch (the library's
    counts); prefill and decode-step times and the kernels' share of
    the device time (``torch.profiler``);
12. ``examples/serve_lm.py``'s run on the port at full width (the
    main path of this slice): ``make_serve_step`` greedy decode of 4 x 16
    prompt tokens x 8 new tokens (tokens/s), the charge-aware
    ``Scheduler`` on 12 requests through the probe kernel, then
    ``simulate`` with ``base`` and ``chargecache`` (hit rate, speedup);
    the launch counts are zeroed before it and must read 22 flash, 22 x 8
    decode (each one split kernel, no combine), at least one probe and 2
    ``sim_step`` launches after it;
13.-15. falcon-mamba-7b serving (the ssm_scan kernel, the golden run,
    prefill at B 4 x 2 048);
16. the Experiment layer and the thesis's five figures
    (``repro_torch.experiment``, ``repro_torch.figures``): (a) an
    Experiment on the card against the plain engine — two single-core
    traces of 2 000 requests x every kind x capacity (32, 128) in chunks
    of 5 (12 unique points: a padded tail), RLTL on; the same group
    through ``sweep_traces``, and its launch half alone under
    ``torch.cuda.set_sync_debug_mode("error")``; a small synthetic and a
    small serving Experiment against direct sweeps on the card (their
    float draws are held to the plain engine on the card in phases 4 and
    7) — zero mismatches; (b) the two golden
    workloads through the Experiment's mechanism axis, every cell equal
    to ``golden_fullwidth.json``; (c) the five figures at the thesis's
    sizes (22 single-core workloads x 150 000 requests, 20 eight-core
    mixes x 40 000 a core; 5 mixes for capacity and duration), each
    figure's CSV rows, wall time and ``sim_step`` launches (equal to the
    runner's plan, one a trace batch and chunk), every Fig 6.1 cell and
    the first trace's cells of every other figure equal to a direct
    ``sweep()`` on the card, then the scheduler-policy study
    (``serving.study.policy_experiment``: the schedulers' probes through
    the probe kernel, the policy x mechanism grid through the sim_step
    kernel) against direct sweeps; the launch counts are zeroed before
    the figures and read after the study; (d) the eight-core average
    speedups ordered base < chargecache < cc_nuat < lldram and lldram's
    ``acts_lowered_frac`` 1.0 (``examples/chargecache_sim.py``'s check);
then one JSON line of kernel numbers, and the last line:
``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line is printed.  Exits
non-zero at once when no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
#: the scan's dependent chain a request (PERF.md section 6, PR 17): the
#: instruction classes on a ChargeCache point's loop-carried path with no
#: division and no global load left, their counts and their latency in
#: SM cycles on Hopper (4 for arithmetic: CUDA C++ Programming Guide,
#: "Multiprocessor Level"; ~30 for a shared-memory load: Luo et al. 2024,
#: arXiv:2402.13499)
CHAIN = (("integer add / logic / compare-select", 31, 4),
         ("integer multiply-add", 4, 4),
         ("shared-memory load", 1, 30))
CHAIN_CYCLES = sum(n * lat for _, n, lat in CHAIN)
#: the serving entry's three chains (PERF.md section 6, the serving
#: entry's bound), SM cycles: one access's DRAM service (``CHAIN`` less
#: its core pick: 25 ALU, 4 IMAD, 1 shared-memory load), one exact 2-way
#: hot-table insert (13 ALU, 2 IMAD, 1 load), and the scheduler's step at
#: the scale geometry (its warp collectives at ~30 cycles each, as a
#: shared-memory load): every step, each admission, each chunk of <= 32
#: records
SERVE_DRAM_CYCLES = 25 * 4 + 4 * 4 + 30
SERVE_HOT_CYCLES = 13 * 4 + 2 * 4 + 30
SERVE_STEP_CYCLES = 770
SERVE_ADMIT_CYCLES = 474
SERVE_CHUNK_CYCLES = 650
#: dividends a divisor of the device-divider check (plus the edges)
DIVIDER_SAMPLE = 1 << 24
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
#: cut depth of the serving entry's kernel-vs-plain comparison
SERVE_CUT_STEPS = 60
#: cut depth of the same comparison at the scale streams' geometry (the
#: queue fills and drops within 20 steps of pinned counts)
SCALE_CUT_STEPS = 40
#: the serving geometry past one warp of lanes that phase 7 also holds
WIDE_BATCH, WIDE_QUEUE = 48, 200
#: the largest share of a serving point's drawn arrival counts that may
#: differ from ``repro``'s (its own mirror rule: float32 ``log1p`` / ``log``
#: an ulp apart)
MAX_COUNT_DIFF = 1e-3
#: queries of the probe kernel's comparison (not a multiple of 256)
PROBE_Q = 1_000_003
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


def sm_clock_mhz(fn, seconds: float = 2.0) -> float:
    """The SM clock (``nvidia-smi --query-gpu=clocks.sm``, MHz) while
    ``fn()`` runs back to back for ``seconds``: the median of its samples
    every 100 ms, or one reading right after where none landed."""
    import tempfile
    import torch
    query = ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"]
    with tempfile.TemporaryFile("w+") as log:
        smi = subprocess.Popen(query + ["-lms", "100"], stdout=log,
                               stderr=subprocess.DEVNULL)
        try:
            t0 = time.time()
            while time.time() - t0 < seconds:
                fn()
                torch.cuda.synchronize()
        finally:
            smi.terminate()
            smi.wait(timeout=30)
        log.seek(0)
        mhz = [float(x) for x in log.read().split() if x.isdigit()]
    if not mhz:
        mhz = [float(subprocess.run(query, capture_output=True, text=True,
                                    check=True, timeout=60).stdout.split()[0])]
    return statistics.median(mhz)


def chain_bound_ms(n_steps: int, mhz: float) -> float:
    """The scan's dependent-chain bound: ``n_steps`` requests of
    ``CHAIN_CYCLES`` each at ``mhz``."""
    return n_steps * CHAIN_CYCLES / (mhz * 1e3)


def serve_chain_bound(n_acc: int, n_steps: int, admitted: int,
                      probes: int, mhz: float) -> tuple[float, str]:
    """The serving entry's dependent-chain bound of a point, ms, and the
    chain that sets it: ``n_acc`` page accesses through the DRAM service
    and the hot table's inserts, ``n_steps`` scheduler steps with
    ``admitted`` admissions and at least (n_acc + probes) / 32 chunks of
    records."""
    chunks = -(-(n_acc + probes) // 32)
    chains = {"dram": n_acc * SERVE_DRAM_CYCLES,
              "hot": n_acc * SERVE_HOT_CYCLES,
              "scheduler": (n_steps * SERVE_STEP_CYCLES
                            + admitted * SERVE_ADMIT_CYCLES
                            + chunks * SERVE_CHUNK_CYCLES)}
    name = max(chains, key=chains.get)
    return chains[name] / (mhz * 1e3), name


def ptxas_report(log: str) -> dict:
    """``{entry: {"registers", "spill_stores", "spill_loads"}}`` of the
    ``sim_*_kernel`` entries in a library's ``-Xptxas -v`` log."""
    import re
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(sim_[a-z]+_kernel)",
                      line)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "spill_stores": 0,
                          "spill_loads": 0}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry]["spill_stores"] = int(m.group(1))
            out[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
            entry = None
    return out


def check_divider(kernel, stacks) -> int:
    """The kernel's divider (``kernel.floor_div``) against PyTorch's floor
    division on the card, for every divisor (``kernel.DIVISOR_FIELDS``)
    of the grids ``stacks`` (``(stacked params, ns_idx)`` pairs):
    ``DIVIDER_SAMPLE`` seeded dividends each plus the edges (the int32
    extremes, -1, 0, 1, multiples of the divisor +- 1 near 0 and both
    extremes).  Returns the mismatching quotients and remainders."""
    import torch
    divisors = set()
    for stacked, ns_idx in stacks:
        params, _, offsets = kernel.pack(stacked, ns_idx)
        at = dict(zip(kernel.FIELDS, offsets))
        for f in kernel.DIVISOR_FIELDS:
            divisors.update(params[:, at[f]].unique().tolist())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    lo, hi = -2**31, 2**31 - 1
    bad = 0
    for d in sorted(divisors):
        edges = [lo, lo + 1, -1, 0, 1, hi - 1, hi]
        edges += [k * d + e for k in range(-3, 4) for e in (-1, 0, 1)]
        edges += [(lo // d + k) * d + e for k in range(3) for e in (-1, 0, 1)]
        edges += [(hi // d - k) * d + e for k in range(3) for e in (-1, 0, 1)]
        a = torch.cat([
            torch.tensor([v for v in edges if lo <= v <= hi],
                         dtype=torch.int32, device="cuda"),
            torch.randint(lo, hi + 1, (DIVIDER_SAMPLE,), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)])
        q, r = kernel.floor_div(a, d)
        bad += int((q != torch.div(a, d, rounding_mode="floor")).sum())
        bad += int((r != torch.remainder(a, d)).sum())
    print(f"  device divider vs torch floor division: {len(divisors)} "
          f"divisors of the phase 3-5 points ({min(divisors)} .. "
          f"{max(divisors)}), {DIVIDER_SAMPLE} random dividends each plus "
          f"the edges: {bad} mismatching values", flush=True)
    return bad


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


# --------------------------------------------------------------------------
# phases 6-8: the HCRAC probe kernel and the serving path
# --------------------------------------------------------------------------

def probe_case(hcl, cfg, rng, Q, device):
    """A random ``[sets, ways]`` table and ``Q`` queries against it: each
    way holds a gid of its own set (``set + k * sets``, k in [-3, 3), so
    a third are negative) or is empty (a fifth), inserted at a cycle in
    [0, 100 000); the queries draw gids the same way and times in
    [50 000, 150 000), so a good share hits."""
    import numpy as np
    import torch
    S, W = cfg.n_sets, cfg.n_ways
    own = lambda sets: sets + S * rng.integers(-3, 3, sets.shape)
    tags = own(np.repeat(np.arange(S)[:, None], W, axis=1))
    tags[rng.random((S, W)) < 0.2] = -1
    itime = rng.integers(0, 100_000, (S, W))
    st = hcl.state_from_numpy(tags, itime, itime, device=device)
    i32 = lambda x: torch.from_numpy(x.astype(np.int32)).to(device)
    return (st, i32(own(rng.integers(0, S, Q))),
            i32(rng.integers(50_000, 150_000, Q)))


def device_ms(fn, name: str, reps: int = 20):
    """Mean device time of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn``, from ``torch.profiler`` (the launch's host
    time excluded), in ms; None where the profiler saw no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time for e in prof.key_averages() if name in e.key]
    return us[0] / 1e3 if us else None


def probe_bound_ms(gids, cfg) -> float:
    """Bytes bound of one probe launch: each query's gid, time and hit
    (12 B) once, and the tags and insertion times of the sets these
    queries touch (their ways, 8 B each) once — what this run's data
    needs, not the whole table."""
    import torch
    touched = torch.unique(torch.remainder(gids.long(), cfg.n_sets)).numel()
    return ((gids.numel() * 12 + touched * cfg.n_ways * 8)
            / HBM_BYTES_PER_S * 1e3)


def probe_diff(got, want) -> tuple[int, int]:
    """``(queries whose hit differs, max |got - want|)`` of two probe
    results."""
    d = (got.long() - want.long()).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def phase_probe(hcl, hk, hops, href, host_cfg, device="cuda"):
    """Hold the probe kernel against its plain version; returns the row
    of kernel numbers (the 1 024-entry exact table at 10**6 queries, the
    serving grid's geometry, is the headline)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(13)
    out = {"max_abs_err": 0, "mismatches": 0, "cases": []}
    for entries, ways in ((128, 2), (1024, 2), (65536, 16)):
        for exact in (False, True):
            cfg = hcl.HCRACConfig(n_entries=entries, n_ways=ways,
                                  caching_cycles=40_000, exact_expiry=exact)
            st, gids, times = probe_case(hcl, cfg, rng, PROBE_Q, device)
            got = hops.hcrac_lookup(cfg, st, gids, times)
            plain_ms, want = cuda_ms(
                lambda: href.hcrac_lookup_ref(cfg, st, gids, times),
                torch.cuda.synchronize)
            bad, err = probe_diff(got, want)
            out["mismatches"] += bad
            out["max_abs_err"] = max(out["max_abs_err"], err)
            launch = lambda: hk.hcrac_lookup(cfg, st.tags, st.itime, gids,
                                             times)
            ms = median_ms(launch)
            dev_ms = device_ms(launch, "hcrac_lookup")
            bound = probe_bound_ms(gids, cfg)
            print(f"  {entries:6d} entries x {ways:2d} ways, "
                  f"{'exact' if exact else 'sweep'}: {PROBE_Q} queries, "
                  f"hits {int(want.sum())}, mismatches {bad}; kernel "
                  f"{ms:.4f} ms a launch, {dev_ms} ms device time "
                  f"(torch.profiler), plain {plain_ms:.3f} ms, bytes bound "
                  f"{bound:.4f} ms", flush=True)
            check(bad == 0, f"probe kernel disagrees with its plain version "
                            f"({entries} entries, exact={exact})")
            case = {"entries": entries, "ways": ways, "exact": exact,
                    "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                    "bound_ms": bound}
            out["cases"].append(case)
            if (entries, exact) == (1024, True):
                out.update({k: case[k] for k in ("ms", "device_ms",
                                                 "plain_ms", "bound_ms")})
    # the host scheduler's table (phase 8a) at one probe's few queries
    st, q_gids, q_times = probe_case(hcl, host_cfg, rng, 2, device)
    bad, err = probe_diff(hops.hcrac_lookup(host_cfg, st, q_gids, q_times),
                          href.hcrac_lookup_ref(host_cfg, st, q_gids, q_times))
    out["mismatches"] += bad
    out["max_abs_err"] = max(out["max_abs_err"], err)
    check(bad == 0, "probe kernel disagrees at the host scheduler's shape")
    out["main_path_probe_ms"] = median_ms(
        lambda: hk.hcrac_lookup(host_cfg, st.tags, st.itime, q_gids, q_times))
    out["main_path_probe_bound_ms"] = probe_bound_ms(q_gids, host_cfg)
    out["main_path_probe_device_ms"] = device_ms(
        lambda: hk.hcrac_lookup(host_cfg, st.tags, st.itime, q_gids,
                                q_times), "hcrac_lookup")
    print(f"  the host scheduler's table ({host_cfg.n_entries} entries), "
          f"2 queries: mismatches {bad}, kernel "
          f"{out['main_path_probe_ms']:.4f} ms a probe (launch included; "
          f"device time alone {out['main_path_probe_device_ms']} ms), "
          f"bytes bound {out['main_path_probe_bound_ms']:.3e} ms (the "
          f"queries and the sets they touch)", flush=True)
    return out


def serving_config(sim, golden_mod, timing, arr: dict, spec: dict,
                   mechanism: str, n_steps: int = 0):
    """A serving point of ``golden.SERVING`` from its arrival and spec
    kwargs, under ``mechanism`` as the grid builds it."""
    from repro_torch.core.hcrac import HCRACConfig
    from repro_torch.serving.loop.spec import ServingSpec
    from repro_torch.workloads.arrivals import ArrivalConfig
    S = golden_mod.SERVING
    ms = S["mech_caching_ms"]
    return sim.SimConfig(
        mech=sim.MechanismConfig(
            kind=mechanism,
            hcrac=HCRACConfig(n_entries=S["mech_entries"],
                              caching_cycles=timing.ms_to_cycles(ms)),
            lowered=timing.lowered_for_duration(ms)),
        serving=ServingSpec(arrival=ArrivalConfig(**arr), n_steps=n_steps,
                            **spec))


def serving_grid(sim, golden_mod, timing, n_steps=0):
    """The 24 serving points of ``golden.SERVING`` in launch order (cut
    to ``n_steps`` scheduler steps where given)."""
    S = golden_mod.SERVING
    return [serving_config(sim, golden_mod, timing,
                           *golden_mod.serving_spec_kwargs(
                               S["grid_reqs"], p["rate"], p["burstiness"],
                               S["grid_batch"], p["policy"]),
                           p["mechanism"], n_steps)
            for p in golden_mod.serving_points()]


def scale_grid(sim, golden_mod, timing, n_steps, max_batch=None,
               queue_cap=None):
    """The scale streams' geometry (``SERVING["scale"]``: 32 slots, a
    128-entry queue, up to 32 arrivals a step; or ``max_batch`` slots and
    arrivals a step and a ``queue_cap``-entry queue) under every policy
    and mechanism of the grid, cut to ``n_steps`` scheduler steps."""
    S = golden_mod.SERVING
    sc = S["scale"]
    out = []
    for pol in S["policies"]:
        arr, spec = golden_mod.serving_spec_kwargs(
            sc["n_reqs"], sc["rate"], sc["burstiness"],
            max_batch or sc["max_batch"], pol)
        if queue_cap:
            spec["queue_cap"] = queue_cap
        out += [serving_config(sim, golden_mod, timing, arr, spec, mech,
                               n_steps) for mech in S["mechanisms"]]
    return out


def scale_config(sim, golden_mod, n_reqs):
    """A ``benchmarks/serving_loop.py::scale_points`` point."""
    from repro_torch.serving.loop.spec import ServingSpec
    from repro_torch.workloads.arrivals import ArrivalConfig
    sc = golden_mod.SERVING["scale"]
    arr, spec = golden_mod.serving_spec_kwargs(
        n_reqs, sc["rate"], sc["burstiness"], sc["max_batch"], sc["policy"])
    return sim.SimConfig(serving=ServingSpec(arrival=ArrivalConfig(**arr),
                                             **spec))


def compare_serve(got, want) -> tuple[int, int]:
    """``(mismatching elements, max abs difference)`` between two
    ``run_serve`` outputs, per-step arrays included."""
    pairs = ([(got[0][k], want[0][k]) for k in want[0]]
             + [(got[1][k], want[1][k]) for k in want[1]]
             + [(got[2], want[2])])
    if want[3] is not None:
        pairs += list(zip(got[3], want[3]))
    bad = err = 0
    for a, b in pairs:
        d = (a.to(b.device).long() - b.long()).abs()
        bad += int((d != 0).sum())
        err = max(err, int(d.max()) if d.numel() else 0)
    return bad, err


def phase_serve_vs_plain(sim, engine, ops, ref, grid, device="cuda"):
    """The serving entry against the plain engine on ``grid``: drawn,
    pinned and reduced launches; returns ``(mismatches, max abs err,
    kernel ms, plain ms, steps)``."""
    import numpy as np
    import torch
    dev = torch.device(device)
    shape, params, warm = engine.stage_serving(grid, None, True, dev)
    n = shape.n_steps
    counts = torch.from_numpy(np.random.default_rng(3).integers(
        0, shape.arrivals_max + 1, (len(grid), n)).astype(np.int32)).to(dev)
    bad = err = 0
    plain_ms = None
    for name, c in (("drawn", None), ("pinned", counts)):
        got = ops.run_serve(shape, params, warm, c)
        torch.cuda.synchronize()
        t_ms, want = cuda_ms(lambda: ref.run_serve_ref(shape, params, warm,
                                                       c),
                             torch.cuda.synchronize)
        plain_ms = plain_ms or t_ms
        b, e = compare_serve(got, want)
        bad, err = bad + b, max(err, e)
        print(f"  {name} arrivals: {len(grid)} points x {n} steps, "
              f"mismatches {b} (plain {t_ms:.0f} ms; arrived "
              f"{int(want[1]['arrived'].sum())}, preempted "
              f"{int(want[1]['preempted'].sum())}, dropped "
              f"{int(want[1]['dropped'].sum())})", flush=True)
        if c is None:
            keys = engine.SERVE_REDUCE_KEYS
            red = sim.sweep_serving(grid, reduce_keys=keys, device=dev)
            want_red = engine._serve_reduce(shape, *want[:3], keys).cpu()
            r_bad = int((torch.as_tensor(red) != want_red).sum())
            print(f"  reduce_keys launch ({len(keys)} keys): mismatches "
                  f"{r_bad}", flush=True)
            bad += r_bad
    kernel_ms = median_ms(lambda: ops.run_serve(shape, params, warm, None))
    print(f"  kernel {kernel_ms:.3f} ms for {len(grid)} points x {n} steps",
          flush=True)
    check(bad == 0, "serving entry disagrees with the plain serving engine")
    return bad, err, kernel_ms, plain_ms, n


SERVE_KEYS_SKIP = ("counts", "arrivals", "occ", "qlen", "policy", "rate",
                   "burstiness", "mechanism")


def serving_mismatches(label, res: dict, gold: dict) -> int:
    """Values of a serving result that differ from a golden record."""
    bad = 0
    for key, want in gold.items():
        if key in SERVE_KEYS_SKIP:
            continue
        got = res[key]
        got = [int(x) for x in got] if isinstance(want, list) else int(got)
        if got != want:
            bad += 1
            print(f"  MISMATCH {label}.{key}: got {got} want {want}")
    for key in ("arrivals", "occ", "qlen"):
        if [int(x) for x in res["steps"][key]] != gold[key]:
            bad += 1
            print(f"  MISMATCH {label}.steps.{key}")
    return bad


def drawn_counts(cfg, n_steps: int, device):
    """The arrival counts a point draws on ``device``
    (``arrivals.step_counts``, the plain version of the kernel's draw,
    which phase 7 holds the kernel to)."""
    import torch
    from repro_torch.workloads import arrivals
    p = arrivals.arrival_params(cfg.serving.arrival, cfg.serving.n_reqs,
                                device)
    return arrivals.step_counts(p, torch.arange(
        n_steps, dtype=torch.int32, device=device)).cpu().numpy()


def check_drawn(label, res: dict, gold: dict, n_reqs: int,
                got_c) -> tuple[int, int]:
    """Hold a point run with counts drawn on the card (``got_c``) to its
    golden record: returns ``(counts differing, stat values differing
    where the counts are equal)``."""
    import numpy as np
    diff = int((np.asarray(got_c) != np.asarray(gold["counts"])).sum())
    if diff == 0:
        return 0, serving_mismatches(label, res, gold)
    print(f"  {label}: {diff} of {got_c.size} drawn counts differ from "
          f"repro's; retired {res['retired']} of {n_reqs}")
    check(diff <= MAX_COUNT_DIFF * got_c.size,
          f"{label}: {diff} drawn counts differ (at most "
          f"{MAX_COUNT_DIFF:.0e} of them may)")
    check(res["retired"] == n_reqs, f"{label}: not every request retired")
    return diff, 0


def serving_phases(sim, timing, golden_mod, regs: dict,
                   device="cuda") -> tuple:
    """Phases 6-8 (the probe kernel, the serving entry, the serving path
    at full size) on ``device``; returns the kernel line's entries for
    ``hcrac_lookup`` and ``sim_step_serve`` (``regs``: ptxas's report of
    the sim_step library)."""
    import numpy as np
    import torch
    from repro_torch.core import hcrac as hcl
    from repro_torch.kernels.hcrac import kernel as hk, ops as hops
    from repro_torch.kernels.hcrac import ref as href
    from repro_torch.kernels.sim_step import kernel, ops, ref
    from repro_torch.serving.loop import engine
    from repro_torch.serving.loop.oracle import run_host
    from repro_torch.serving.loop.spec import ServingSpec
    from repro_torch.workloads.arrivals import ArrivalConfig

    # --- phase 6: the probe kernel against its plain version -------------
    print("\nphase 6: HCRAC probe kernel vs plain version (on the card)",
          flush=True)
    host_spec = ServingSpec(
        policy="fifo", arrival=ArrivalConfig(
            rate=1.5, burstiness=1.0, prompt_pages_min=1, prompt_pages_max=2,
            decode_min=4, decode_max=12, seed=7),
        n_reqs=96, max_batch=8, queue_cap=128, arrivals_max=4, n_steps=320,
        cycles_per_step=4000, hot_entries=1018, hot_ways=2,
        hot_caching_ms=0.05, hot_exact=True)
    probe = phase_probe(hcl, hk, hops, href, host_spec.hot_cfg(), device)

    # --- phase 7: the serving entry against the plain engine -------------
    print("\nphase 7: sim_step serving entry vs plain serving engine (on "
          "the card)", flush=True)
    (v_bad, v_err, v_cut_ms, v_plain_ms, v_cut_steps) = phase_serve_vs_plain(
        sim, engine, ops, ref,
        serving_grid(sim, golden_mod, timing, n_steps=SERVE_CUT_STEPS),
        device)
    print("  the scale streams' geometry, every policy x mechanism:",
          flush=True)
    sc_bad, sc_err, *_ = phase_serve_vs_plain(
        sim, engine, ops, ref,
        scale_grid(sim, golden_mod, timing, n_steps=SCALE_CUT_STEPS), device)
    v_bad, v_err = v_bad + sc_bad, max(v_err, sc_err)
    print("  48 slots, a 200-entry queue, 48 arrivals a step, every policy "
          "x mechanism:", flush=True)
    wide_bad, wide_err, *_ = phase_serve_vs_plain(
        sim, engine, ops, ref,
        scale_grid(sim, golden_mod, timing, n_steps=SCALE_CUT_STEPS,
                   max_batch=WIDE_BATCH, queue_cap=WIDE_QUEUE), device)
    v_bad, v_err = v_bad + wide_bad, max(v_err, wide_err)

    # --- phase 8: the serving path at full size ---------------------------
    print("\nphase 8: serving path at full size", flush=True)
    gold_v = golden_mod.load_serving()
    hops.launches = ops.serve_launches = 0
    # (a) host parity on a pinned schedule (benchmarks/serving_trace.py)
    host_counts = np.random.default_rng(42).integers(
        0, 4, size=host_spec.n_steps).astype(np.int32)
    t0 = time.time()
    sched, occ_host = run_host(host_spec, host_counts, device)
    host_s = time.time() - t0
    host_probe_launches = hops.launches
    res_h = sim.simulate_serving(sim.SimConfig(serving=host_spec),
                                 counts=host_counts, device=device)
    parity = (np.array_equal(res_h["steps"]["occ"], occ_host)
              and res_h["retired"] == sched.stats["retired"]
              and res_h["admit_probes"] == sched.stats["admit_probes"]
              and res_h["admit_hot"] == sched.stats["admit_hot"])
    print(f"  (a) host scheduler {host_s:.1f} s ({host_probe_launches} probe "
          f"launches) vs simulate_serving: retired {sched.stats['retired']} "
          f"/ {res_h['retired']}, admit_probes "
          f"{sched.stats['admit_probes']} / {res_h['admit_probes']}, "
          f"admit_hot {sched.stats['admit_hot']} / {res_h['admit_hot']}, "
          f"per-step occupancy equal: "
          f"{np.array_equal(res_h['steps']['occ'], occ_host)}", flush=True)
    check(host_probe_launches > 0, "the host scheduler launched no probe")
    check(parity, "host scheduler and serving entry disagree")
    check(0 < res_h["admit_hot"] < res_h["admit_probes"],
          "host parity schedule is not discriminative")
    # (b) the 24-point grid at full depth against the golden file
    grid24 = serving_grid(sim, golden_mod, timing)
    pts = gold_v["points"]
    pinned24 = np.asarray([p["counts"] for p in pts], np.int32)
    res_p = sim.sweep_serving(grid24, counts=pinned24, collect_steps=True,
                              device=device)
    p_bad = sum(serving_mismatches(f"pinned/{i}", r, g)
                for i, (r, g) in enumerate(zip(res_p, pts)))
    print(f"  (b) 24 points x {gold_v['n_steps']} steps, repro's counts "
          f"pinned: {p_bad} values differ from the golden file", flush=True)
    check(p_bad == 0, "serving grid disagrees with the JAX golden numbers")
    t0 = time.time()
    res_d = sim.sweep_serving(grid24, collect_steps=True, device=device)
    grid_wall = time.time() - t0
    d_counts = d_bad = 0
    for p, r, g, cfg in zip(golden_mod.serving_points(), res_d, pts,
                            grid24):
        label = (f"{p['policy']}/r{p['rate']:g}/b{p['burstiness']:g}/"
                 f"{p['mechanism']}")
        c, b = check_drawn(label, r, g, golden_mod.SERVING["grid_reqs"],
                           drawn_counts(cfg, r["n_steps"], device))
        d_counts, d_bad = d_counts + c, d_bad + b
    print(f"      counts drawn on the card: {d_counts} of "
          f"{pinned24.size} differ from repro's; stats of the points with "
          f"equal counts: {d_bad} values differ ({grid_wall:.2f} s wall)",
          flush=True)
    check(d_bad == 0, "serving grid disagrees with the JAX golden numbers")
    print("      policy: admit_hot_rate (chargecache points, mean over "
          "rate x burstiness)")
    for pol in golden_mod.SERVING["policies"]:
        rates = [r["admit_hot_rate"] for p, r in
                 zip(golden_mod.serving_points(), res_d)
                 if p["policy"] == pol and p["mechanism"] == "chargecache"]
        print(f"        {pol:<13} {sum(rates) / len(rates):.4f}")
    # (c) the scale points
    scale = {}
    for n_req in (10_000, 100_000):
        cfg = scale_config(sim, golden_mod, n_req)
        t0 = time.time()
        r = sim.simulate_serving(cfg, device=device)
        wall = time.time() - t0
        check(r["retired"] == n_req, f"{n_req}-request stream did not drain")
        if n_req == golden_mod.SERVING["scale"]["n_reqs"]:
            gold_c = np.asarray(gold_v["scale"]["counts"], np.int32)
            p_bad = serving_mismatches(
                f"scale/{n_req}/pinned", sim.simulate_serving(
                    cfg, counts=gold_c, device=device), gold_v["scale"])
            print(f"  (c) {n_req} requests, repro's counts pinned: {p_bad} "
                  f"values differ from the golden file", flush=True)
            check(p_bad == 0, "10**4-request point with repro's counts "
                              "disagrees with the golden numbers")
            c, b = check_drawn(f"scale/{n_req}", r, gold_v["scale"], n_req,
                               drawn_counts(cfg, r["n_steps"], device))
            check(b == 0, "10**4-request point disagrees with the golden "
                          "numbers")
            print(f"      counts drawn on the card: {c} differ from "
                  f"repro's; stats differing {b}", flush=True)
        scale[n_req] = {"steps": r["n_steps"], "wall_s": wall,
                        "retired": r["retired"],
                        "admit_hot_rate": r["admit_hot_rate"],
                        "accesses": int(r["n_req"])}
    serve_launches, probe_launches = ops.serve_launches, hops.launches
    check(serve_launches > 0 and probe_launches > 0,
          f"serving path launches: sim_serve {serve_launches}, probe "
          f"{probe_launches}")
    # kernel times at the main path's shapes, beside the chain bound
    dev = torch.device(device)
    sh24, pa24, wa24 = engine.stage_serving(grid24, None, True, dev)
    ms24 = median_ms(lambda: ops.run_serve(sh24, pa24, wa24, None))
    staged = {n_req: engine.stage_serving(
        [scale_config(sim, golden_mod, n_req)], None, False, dev)
        for n_req in scale}
    mhz = sm_clock_mhz(lambda: ops.run_serve(*staged[10_000], None))

    def bound(cfgs) -> tuple[float, str, int]:
        """The slowest point's chain bound, its chain, and its page
        accesses with the warm-up (a launch without warm-up counts them)."""
        red = sim.sweep_serving(
            [dataclasses.replace(c, warmup_frac=0.0) for c in cfgs],
            reduce_keys=("n_req", "n_steps", "admitted", "admit_probes"),
            device=dev)
        return max((*serve_chain_bound(*map(int, r), mhz), int(r[0]))
                   for r in red)

    b24, chain24, _ = bound(grid24)
    for n_req, row in scale.items():
        row["ms"] = median_ms(lambda: ops.run_serve(*staged[n_req], None),
                              reps=1 if n_req > 10_000 else 3)
        row["chain_bound_ms"], row["chain"], row["all_accesses"] = bound(
            [scale_config(sim, golden_mod, n_req)])
        print(f"      {n_req} requests: {row['steps']} steps, "
              f"{row['accesses']} measured page accesses "
              f"({row['all_accesses']} with the warm-up), kernel "
              f"{row['ms']:.1f} ms ({row['ms'] * 1e6 / row['all_accesses']:.0f}"
              f" ns an access), chain bound {row['chain_bound_ms']:.2f} ms "
              f"({row['chain']}; {100 * row['chain_bound_ms'] / row['ms']:.1f}"
              f" % reached), {row['wall_s']:.2f} s wall, admit_hot_rate "
              f"{row['admit_hot_rate']:.4f}", flush=True)
    nb = sh24.sim.envelope.max_banks_total
    prow = kernel.pack(pa24.mech, wa24)[0].shape[1]
    v_bytes = len(grid24) * 4 * (prow + len(kernel.SERVE_FIELDS) + 16
                                 + 2 * nb + len(engine.SERVE_STAT_KEYS) + 1
                                 + 3 * sh24.n_steps)
    v_bound = v_bytes / HBM_BYTES_PER_S * 1e3
    n_access = sum(int(r["n_req"]) for r in res_d)
    reg = regs.get("sim_serve_kernel", {})
    spill = sum(reg.get(k, 0) for k in ("spill_stores", "spill_loads"))
    print(f"\n  serving kernel: 24-point grid x {sh24.n_steps} steps "
          f"{ms24:.3f} ms ({n_access} measured page accesses); chain bound "
          f"{b24:.3f} ms ({chain24}; {100 * b24 / ms24:.1f} % reached) at "
          f"{mhz:.0f} MHz; bytes bound {v_bound:.5f} ms ({v_bytes} B); "
          f"{reg.get('registers')} registers, {spill} B spilled; launches "
          f"on the serving path: sim_serve {serve_launches}, hcrac probe "
          f"{probe_launches}")
    print(f"  chain bound: DRAM {SERVE_DRAM_CYCLES} cycles an access, hot "
          f"table {SERVE_HOT_CYCLES} an insert, scheduler "
          f"{SERVE_STEP_CYCLES} a step + {SERVE_ADMIT_CYCLES} an admission "
          f"+ {SERVE_CHUNK_CYCLES} a chunk of <= 32 records")

    return ({
        "name": "hcrac_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/hcrac/csrc/hcrac.cu",
        "replaces": "src/repro/kernels/hcrac/kernel.py:49",
        "launches": probe_launches, "max_abs_err": probe["max_abs_err"],
        "mismatches": probe["mismatches"], "ms": probe["ms"],
        "plain_ms": probe["plain_ms"], "queries": PROBE_Q,
        "main_path_probe_ms": probe["main_path_probe_ms"],
        "main_path_probe_bound_ms": probe["main_path_probe_bound_ms"],
        "device_ms": probe["device_ms"],
        "main_path_probe_device_ms": probe["main_path_probe_device_ms"],
        "cases": probe["cases"],
        "bound_ms": probe["bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "sim_step_serve", "route": "cuda",
        "source": "src/repro_torch/kernels/sim_step/csrc/sim_step.cu",
        "replaces": "none (XLA scan, src/repro/serving/loop/engine.py:342)",
        "launches": serve_launches, "max_abs_err": v_err,
        "mismatches": v_bad, "ms": ms24, "plain_ms": v_plain_ms,
        "plain_steps": v_cut_steps, "ms_at_plain_steps": v_cut_ms,
        "steps": sh24.n_steps, "points": len(grid24),
        "counts_differing": d_counts,
        "scale": {str(k): v for k, v in scale.items()},
        "chain_bound_ms": b24, "chain": chain24, "sm_clock_mhz": mhz,
        "chain_share": b24 / ms24, "registers": reg.get("registers"),
        "spill_bytes": spill,
        "bound_ms": v_bound, "bound_by": "bytes", "library_ms": None})


# --------------------------------------------------------------------------
# phases 9-12: dense-LM serving (tinyllama-1.1b at full width)
# --------------------------------------------------------------------------

#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet), for the
#: operations bound of a bf16 kernel; f32 inputs take the 67 TFLOP/s of
#: the CUDA cores
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
#: tests/test_kernels.py's flash matrix (B, S, H, K, hd, causal, window),
#: then the full-width prefill shapes (tinyllama-1.1b: H 32, K 4, hd 64)
#: of phase 11, a longer prompt, and phase 12's
FLASH_MATRIX = [(2, 128, 4, 2, 64, True, 0), (1, 256, 8, 2, 64, True, 64),
                (2, 96, 4, 4, 32, True, 0), (1, 64, 4, 1, 128, False, 0),
                (1, 160, 6, 2, 48, True, 32)]
FLASH_FULL = [(4, 500, 32, 4, 64, True, 0), (1, 4096, 32, 4, 64, True, 0),
              (4, 16, 32, 4, 64, True, 0), (1, 2048, 24, 8, 128, True, 0)]
FLASH_TOL = {"bf16": 0.02, "f32": 2e-5}
#: tests/test_kernels.py's decode matrix (B, H, K, hd, W, window, filled
#: slots) and G 48; then rings of 128, 192, 448 and 4 100 slots with 40
#: filled, which ``plan_split`` cuts into 2, 3 and 7 chunks (a tile each:
#: 4 blocks a chunk want more chunks than that on any card) and, on 132
#: SMs, 33 chunks, each of at least 64 slots, so every chunk but the
#: first holds no valid slot; then the full-width
#: caches: phase 11's (520 slots, 516 filled), a 4 100-slot ring that has
#: wrapped (query at position 5 000), phase 12's last step (28 slots, 24
#: filled) and granite-34b's widths (H 48 over K 1, hd 128) on the
#: wrapped ring
DECODE_MATRIX = [(2, 8, 2, 64, 128, 0, 100), (1, 4, 4, 32, 256, 64, 256),
                 (2, 4, 1, 128, 64, 0, 10), (1, 8, 8, 64, 96, 0, 96),
                 (2, 48, 1, 128, 96, 0, 80), (2, 8, 2, 64, 128, 0, 40),
                 (2, 8, 2, 64, 192, 0, 40), (2, 8, 2, 64, 448, 0, 40),
                 (4, 32, 4, 64, 4100, 0, 40)]
DECODE_FULL = [(4, 32, 4, 64, 520, 0, 516), (4, 32, 4, 64, 4100, 0, 5001),
               (4, 32, 4, 64, 28, 0, 24), (4, 48, 1, 128, 4100, 0, 5001)]
#: split counts the decode cases must reach (read from the library's
#: counters)
DECODE_SPLITS = {1, 2, 3, 7}
DECODE_TOL = 0.03
#: a bf16 kernel output against its plain version, element by element:
#: |kernel - plain| <= BF16_ATOL + BF16_RTOL * |plain|.  Both compute in
#: f32 and round once to bf16, so a correct kernel differs where the two
#: f32 sums (summed in another order, ~1e-6 apart at these shapes) round
#: to neighbouring bf16 values: one ulp, at most 2^-7 of |plain|.  The
#: absolute limits above stay as a second check; alone they are larger
#: than the outputs at full width (~0.026 over 4 100 keys), where a
#: dropped 32-key tile moves an output by ~1e-3.
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
#: the card's logits against golden_lm.json: four bf16 ulps at the top
#: logits' magnitude (4-8), twice the largest difference between the
#: port on the CPU and repro (tests/_torch_golden.py lm)
LM_LOGIT_TOL = 0.125


def loop_ms(fn, n: int = 20) -> float:
    """Mean time of ``n`` back-to-back calls of ``fn`` on the current
    stream (CUDA events around the loop, after one warm-up), in ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profile_kernels(fn, names) -> tuple[float, float | None, dict]:
    """``fn()`` under ``torch.profiler``: ``(wall ms, device busy ms,
    {name: device ms of the kernels whose name holds it})``; busy is
    None when the profiler saw no device activity.  A name may be a
    tuple of alternatives, keyed by its first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if getattr(e, "device_type", None)
           == torch.autograd.DeviceType.CUDA]
    ms = lambda evs: sum(e.time_range.elapsed_us() for e in evs) / 1e3
    busy = ms(dev) if dev else None
    alts = lambda n: (n,) if isinstance(n, str) else n
    return wall, busy, {alts(n)[0]: ms([e for e in dev if any(
        a in e.name for a in alts(n))]) for n in names}


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` with the host's time taken out:
    ``reps`` calls captured into a CUDA graph, the graph replayed between
    two CUDA events, over ``reps`` (after warm-up calls, on a side stream
    as graph capture wants)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def hmma_counts(lib_path: str, entry: str) -> dict:
    """``{function: HMMA instructions}`` of the built library's functions
    whose (mangled) name holds ``entry``, from ``cuobjdump -sass`` of the
    CUDA toolkit that built it."""
    from repro_torch import _build
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib_path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if entry in fn:
                counts[fn] = 0
        elif fn in counts and "HMMA" in line:
            counts[fn] += 1
    return counts


def seeded(shape, seed: int, dtype, device):
    """Standard normal values from numpy's generator (seeded), as
    ``dtype`` on ``device``."""
    import numpy as np
    import torch
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def flash_bound(B, S, H, K, hd, causal, window, dtype) -> tuple:
    """``(bound ms, 'bytes' | 'operations')``: q, k, v read once and the
    output written once, against 4 * hd operations per valid (query, key)
    pair."""
    import torch
    q = torch.arange(S)[:, None]
    k = torch.arange(S)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= q >= k
    if window:
        ok &= (q - k) < window
    pairs = int(ok.sum()) * B * H
    size = 2 if dtype == "bf16" else 4
    nbytes = size * hd * (2 * B * S * H + 2 * B * S * K)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 4 * hd * pairs / PEAK_OPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def decode_bound(B, H, K, hd, valid: int, W: int, dtype) -> tuple:
    """``(bound ms, 'bytes' | 'operations')``: the valid slots' keys and
    values, the queries and ``kv_pos`` read once, the output written once,
    against 4 * hd operations per query row and valid slot."""
    size = 2 if dtype == "bf16" else 4
    nbytes = size * hd * (2 * B * H + 2 * B * K * valid) + 4 * W
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 4 * hd * B * H * valid / PEAK_OPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def kernel_diff(got, want, dn: str) -> tuple[float, float, float]:
    """``(max |got - want|, max |want|, worst share of the element-wise
    limit)``: ``BF16_ATOL + BF16_RTOL * |want|`` for bf16, the absolute
    ``FLASH_TOL['f32']`` for f32 (outputs of the small f32 shapes are
    ~0.1, so it is already ~1e-4 of them)."""
    w = want.float()
    d = (got.float() - w).abs()
    lim = (BF16_ATOL + BF16_RTOL * w.abs() if dn == "bf16"
           else FLASH_TOL["f32"])
    return float(d.max()), float(w.abs().max()), float((d / lim).max())


def phase_flash(fk, fr, dev) -> dict:
    """Flash kernel against its plain version (both on the card) over
    ``FLASH_MATRIX`` x {bf16, f32} and ``FLASH_FULL`` (bf16), after the
    HMMA count of its bf16 entries; times the full-width shapes beside
    the plain version and SDPA."""
    import re
    import torch
    import torch.nn.functional as F
    hmma = {int(re.search(r"ILi(\d+)E", fn).group(1)): n for fn, n in
            hmma_counts(fk.library()._name, fk.MMA_ENTRY).items()}
    print(f"  HMMA instructions of the bf16 entry {fk.MMA_ENTRY} by head "
          f"dim tile: {dict(sorted(hmma.items()))}", flush=True)
    check(sorted(hmma) == list(range(16, fk.MAX_HD + 1, 16))
          and min(hmma.values()) > 0,
          f"the bf16 flash entries do not all run on the tensor cores: "
          f"{hmma}")
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    out = {"max_abs_err": 0.0, "full": [], "hmma": hmma}
    cases = ([(c, d) for c in FLASH_MATRIX for d in dts]
             + [(c, "bf16") for c in FLASH_FULL])
    for i, (case, dn) in enumerate(cases):
        B, S, H, K, hd, causal, window = case
        q, k, v = (seeded(shape, 100 * i + j, dts[dn], dev) for j, shape in
                   enumerate(((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))))
        got = fk.flash_attention(q, k, v, causal=causal, window=window)
        plain_ms, want = cuda_ms(lambda: fr.flash_attention_ref(
            q, k, v, causal=causal, window=window), torch.cuda.synchronize)
        err, top, share = kernel_diff(got, want, dn)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        line = (f"  B{B} S{S} H{H} K{K} hd{hd} causal={causal} "
                f"window={window} {dn}: max |kernel - plain| {err:.3g} "
                f"(tolerance {FLASH_TOL[dn]}), max |plain| {top:.3g}, "
                f"worst share of the element-wise limit {share:.3g}")
        if case in FLASH_FULL:
            run = lambda: fk.flash_attention(q, k, v, causal=causal,
                                             window=window)
            sdpa = lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)
            ms, lib_ms = loop_ms(run), loop_ms(sdpa)
            dev_ms, lib_dev_ms = graph_ms(run), graph_ms(sdpa)
            bound, by = flash_bound(B, S, H, K, hd, causal, window, dn)
            row = {"shape": [B, S, H, K, hd], "ms": ms, "device_ms": dev_ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_device_ms": lib_dev_ms, "bound_ms": bound,
                   "bound_by": by, "bound_share": bound / dev_ms,
                   "max_abs_err": err}
            out["full"].append(row)
            line += (f"; kernel {ms:.4f} ms ({dev_ms:.4f} ms device, "
                     f"{100 * bound / dev_ms:.1f} % of its {by} bound "
                     f"{bound:.4f} ms), plain {plain_ms:.3f} ms, SDPA "
                     f"{lib_ms:.4f} ms ({lib_dev_ms:.4f} ms device)")
        print(line, flush=True)
        check(err <= FLASH_TOL[dn] and share <= 1.0,
              f"flash kernel disagrees with its plain version at {case} "
              f"{dn}")
    return out


def decode_case(case, seed: int, dev):
    """Rotated queries, a ring cache and its slot positions: ``fill``
    positions written into ``W`` slots, position p in slot p mod W, the
    newest W kept; the query at position ``fill - 1``."""
    import torch
    B, H, K, hd, W, window, fill = case
    q = seeded((B, H, hd), seed, torch.bfloat16, dev)
    kc = seeded((B, W, K, hd), seed + 1, torch.bfloat16, dev)
    vc = seeded((B, W, K, hd), seed + 2, torch.bfloat16, dev)
    slots = torch.arange(W)
    newest = fill - 1 - torch.remainder(fill - 1 - slots, W)
    kv_pos = torch.where(newest >= 0, newest, -1).to(torch.int32).to(dev)
    q_pos = torch.tensor([fill - 1], dtype=torch.int32, device=dev)
    return q, kc, vc, kv_pos, q_pos


def decode_launches(pk, counts: dict, calls: int) -> str:
    """Check that ``calls`` decode calls of one shape made, by the
    library's ``counts``, one split kernel each over the same number of
    chunks and a combine each where that number exceeds 1; returns their
    summary."""
    n_mma, chunks = counts[pk.MMA_ENTRY], counts["mma_chunks"]
    n_split = chunks // max(n_mma, 1)
    check(n_mma == calls and chunks == n_split * calls
          and counts[pk.COMBINE_ENTRY] == (calls if n_split > 1 else 0)
          and counts["paged_attention_kernel"] == 0,
          f"{calls} decode calls launched {counts}")
    return (f"{n_mma} x {pk.MMA_ENTRY} over {n_split} splits, "
            f"{counts[pk.COMBINE_ENTRY]} x {pk.COMBINE_ENTRY}")


def phase_decode(pk, pr, dev) -> dict:
    """Decode kernel against its plain version (both on the card) over
    ``DECODE_MATRIX`` and ``DECODE_FULL``, each case's first call counted
    by the library (its splits and combine); times the full-width caches
    beside the plain version and SDPA (a boolean mask of the valid
    slots)."""
    import re
    import torch
    import torch.nn.functional as F
    hmma = {int(re.search(r"ILi(\d+)E", fn).group(1)): n for fn, n in
            hmma_counts(pk.library()._name, pk.MMA_ENTRY).items()}
    print(f"  HMMA instructions of the bf16 entry {pk.MMA_ENTRY} by head "
          f"dim tile: {dict(sorted(hmma.items()))}", flush=True)
    check(sorted(hmma) == list(range(16, pk.MAX_HD + 1, 16))
          and min(hmma.values()) > 0,
          f"the bf16 decode entries do not all run on the tensor cores: "
          f"{hmma}")
    out = {"max_abs_err": 0.0, "full": [], "hmma": hmma}
    splits = set()
    for i, case in enumerate(DECODE_MATRIX + DECODE_FULL):
        B, H, K, hd, W, window, fill = case
        q, kc, vc, kv_pos, q_pos = decode_case(case, 10 * i, dev)
        run = lambda: pk.decode_attention(q, kc, vc, kv_pos, q_pos,
                                          window=window)
        pk.launch_counts(reset=True)
        got = run()
        counts = pk.launch_counts(reset=True)
        launched = decode_launches(pk, counts, 1)
        n_split = counts["mma_chunks"]
        splits.add(n_split)
        plain = lambda: pr.decode_ref(q, kc, vc, kv_pos.expand(B, W),
                                      q_pos.expand(B), window=window)
        plain_ms, want = cuda_ms(plain, torch.cuda.synchronize)
        err, top, share = kernel_diff(got, want, "bf16")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        ok = (kv_pos >= 0) & (kv_pos <= q_pos)
        if window:
            ok &= (q_pos - kv_pos) < window
        valid = int(ok.sum())
        line = (f"  B{B} H{H} K{K} hd{hd} W{W} window={window}, {valid} "
                f"valid slots, {launched}: max |kernel - plain| "
                f"{err:.3g} (tolerance {DECODE_TOL}), max |plain| {top:.3g}, "
                f"worst share of the element-wise limit {share:.3g}")
        if case in DECODE_FULL:
            mask = ok[None, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
            ms, lib_ms = loop_ms(run), loop_ms(sdpa)
            dev_ms, lib_dev_ms = graph_ms(run), graph_ms(sdpa)
            bound, by = decode_bound(B, H, K, hd, valid, W, "bf16")
            out["full"].append({
                "shape": [B, H, K, hd, W], "valid": valid,
                "n_split": n_split, "launched_a_call": counts,
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                "bound_ms": bound, "bound_by": by,
                "bound_share": bound / dev_ms, "max_abs_err": err})
            line += (f"; kernel {ms:.4f} ms "
                     f"({dev_ms:.4f} ms device, {100 * bound / dev_ms:.1f} % "
                     f"of its {by} bound {bound:.5f} ms), plain "
                     f"{plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms "
                     f"({lib_dev_ms:.4f} ms device)")
        print(line, flush=True)
        check(err <= DECODE_TOL and share <= 1.0,
              f"decode kernel disagrees with its plain version at {case}")
    check(DECODE_SPLITS <= splits,
          f"the decode cases reached the split counts {sorted(splits)}, "
          f"not all of {sorted(DECODE_SPLITS)}")
    return out


def check_logits(step: int, logits, rec: dict, tol: float = LM_LOGIT_TOL,
                 name: str = "golden_lm.json") -> tuple[float, int, int]:
    """Hold one step's ``[B, V]`` logits to its golden record: each row's
    sorted top-k values and its logsumexp within ``tol``, and the argmax
    equal to repro's where repro's top-1 minus top-2 margin exceeds twice
    that; returns ``(max |diff|, argmax rows checked, argmax rows
    differing)``."""
    import torch
    x = logits.float().cpu()
    k = len(rec["top_logits"][0])
    top = torch.topk(x, k, dim=-1).values
    want = torch.tensor(rec["top_logits"])
    lse = torch.logsumexp(x, -1)
    diff = max(float((top - want).abs().max()),
               float((lse - torch.tensor(rec["logsumexp"])).abs().max()))
    margin = want[:, 0] - want[:, 1]
    sure = margin > 2 * tol
    am = torch.argmax(x, -1)
    bad_am = int((am[sure] != torch.tensor(rec["argmax"])[sure]).sum())
    check(diff <= tol, f"step {step}: logits differ from {name} by "
                       f"{diff:.4f}")
    check(bad_am == 0, f"step {step}: argmax differs from repro's where "
                       f"its margin exceeds {2 * tol}")
    return diff, int(sure.sum()), bad_am


def lm_phases(golden_mod, sim, device="cuda") -> list:
    """Phases 9-12 (the two attention kernels, tinyllama-1.1b at full
    width against ``golden_lm.json``, and ``examples/serve_lm.py``'s run
    on the port) on ``device``; returns the kernel line's rows for
    ``flash_attention`` and ``paged_attention``."""
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.core.simulator import MechanismConfig, SimConfig
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fr
    from repro_torch.kernels.hcrac import ops as hops
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention import ref as pr
    from repro_torch.kernels.sim_step import ops as sops
    from repro_torch.launch import steps
    from repro_torch.models import lm, zoo
    from repro_torch.serving.scheduler import (Request, Scheduler,
                                               SchedulerConfig)
    dev = torch.device(device)

    print("\nphase 9: flash-attention kernel vs plain version (on the card)",
          flush=True)
    flash = phase_flash(fk, fr, dev)
    print("\nphase 10: decode-attention kernel vs plain version (on the "
          "card)", flush=True)
    dec = phase_decode(pk, pr, dev)

    # --- phase 11: tinyllama-1.1b at full width against repro -----------
    print("\nphase 11: tinyllama-1.1b at full width vs golden_lm.json",
          flush=True)
    L = golden_mod.LM
    gold = golden_mod.load_lm()
    cfg = get(L["config"])
    t0 = time.time()
    tree = golden_mod.golden_weights(lm.lm_defs(cfg), L["seed"], dev)
    check(golden_mod.weights_digest(tree) == gold["weights_digest"],
          "the golden weights built on the card differ from repro's")
    model = lm.LM(cfg, tree)
    prompt, dec_in = golden_mod.lm_tokens(cfg.vocab_size, dev)
    check(golden_mod.tokens_digest(prompt, dec_in) == gold["tokens_digest"],
          "the golden tokens built on the card differ from repro's")
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {sum(p.numel() for p in model.parameters())} "
          f"parameters (bf16), golden weights and tokens built on the card "
          f"in {time.time() - t0:.1f} s, digests equal to repro's",
          flush=True)
    prefill = lambda: zoo.prefill_fn(model, {"tokens": prompt}, cfg,
                                     L["max_len"])
    fa.launches = pa.launches = 0
    pk.launch_counts(reset=True)
    logits, cache = prefill()
    steps_out = [logits]
    for t in range(L["steps"]):
        logits, cache = zoo.decode_fn(model, cache, dec_in[t], cfg)
        steps_out.append(logits)
    torch.cuda.synchronize()
    c_flash, c_dec = fa.launches, pa.launches
    k_dec = pk.launch_counts(reset=True)
    print(f"  prefill B{L['batch']} x {L['prompt']} + {L['steps']} decode "
          f"steps: flash launches {c_flash}, decode calls {c_dec} "
          f"({decode_launches(pk, k_dec, c_dec)})", flush=True)
    check(c_flash == cfg.n_layers and c_dec == cfg.n_layers * L["steps"],
          f"expected {cfg.n_layers} flash and {cfg.n_layers * L['steps']} "
          f"decode launches")
    worst, sure, bad = 0.0, 0, 0
    for t, (x, rec) in enumerate(zip(steps_out, gold["steps"])):
        check(tuple(x.shape) == (L["batch"], cfg.vocab_padded)
              and bool(torch.isfinite(x.float()).all()),
              f"step {t}: malformed logits")
        d, n, b = check_logits(t, x, rec)
        worst, sure, bad = max(worst, d), sure + n, bad + b
    print(f"  {len(steps_out)} steps x {L['batch']} rows vs repro: max "
          f"|d| top-{L['top_k']} logits / logsumexp {worst:.4f} (tolerance "
          f"{LM_LOGIT_TOL}); argmax equal on all {sure} rows whose margin "
          f"exceeds {2 * LM_LOGIT_TOL}", flush=True)
    # times: prefill alone, then the decode steps on a copy of its cache
    prefill_ms = cuda_ms(prefill, torch.cuda.synchronize)[0]
    _, cache0 = prefill()
    run_cache = {k: v.clone() for k, v in cache0.items()}

    def decode_all():
        c = run_cache
        for t in range(L["steps"]):
            c = zoo.decode_fn(model, c, dec_in[t], cfg)[1]
    decode_ms = cuda_ms(decode_all, torch.cuda.synchronize)[0] / L["steps"]
    names = ("flash_attention", "paged_attention")
    p_wall, p_busy, p_k = profile_kernels(prefill, names)
    run_cache = {k: v.clone() for k, v in cache0.items()}
    d_wall, d_busy, d_k = profile_kernels(decode_all, names)
    share = lambda part, whole: (f"{100 * part / whole:.1f} %"
                                 if part is not None and whole
                                 else "not measured")
    print(f"  prefill {prefill_ms:.2f} ms; decode {decode_ms:.3f} ms a "
          f"step (CUDA events)", flush=True)
    print(f"  profiled prefill: {p_wall:.2f} ms wall, device busy "
          f"{p_busy} ms, flash kernel {p_k[names[0]]:.3f} ms "
          f"({share(p_k[names[0]], p_busy)} of the busy time)", flush=True)
    print(f"  profiled {L['steps']} decode steps: {d_wall:.2f} ms wall, "
          f"device busy {d_busy} ms, decode kernel {d_k[names[1]]:.3f} ms "
          f"({share(d_k[names[1]], d_busy)} of the busy time, "
          f"{share(d_busy, d_wall)} of the wall busy)", flush=True)

    # --- phase 12: examples/serve_lm.py's run on the port ----------------
    print("\nphase 12: examples/serve_lm.py on the port (tinyllama-1.1b, "
          "full width)", flush=True)
    n_new, batch = 8, 4
    serve = steps.make_serve_step(cfg)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, 16))
                               ).to(dev)
    fa.launches = pa.launches = hops.launches = sops.launches = 0
    pk.launch_counts(reset=True)
    _, cache = zoo.prefill_fn(model, {"tokens": prompts}, cfg,
                              max_len=16 + n_new + 4)
    tok = torch.zeros((batch,), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    outs = []
    for _ in range(n_new):
        tok, cache = serve(model, cache, tok)
        outs.append(tok.cpu())
    dt = time.time() - t0
    outs = torch.stack(outs)
    check(bool(((outs >= 0) & (outs < cfg.vocab_size)).all()),
          "decoded tokens out of range")
    print(f"  decoded {n_new} tokens x batch {batch} in {dt:.3f} s "
          f"({n_new * batch / dt:.1f} tok/s): {outs.T.tolist()}", flush=True)
    sched = Scheduler(SchedulerConfig(max_batch=batch, charge_aware=True),
                      device=dev)
    for rid in range(12):
        sched.submit(Request(rid=rid, prompt_len=int(rng.integers(2048, 8192)),
                             max_new=n_new))
    sched.run(200)
    trace = sched.emit_trace()
    base = sim.simulate(trace, SimConfig(mech=MechanismConfig(kind="base")),
                        device=dev)
    cc = sim.simulate(trace, SimConfig(
        mech=MechanismConfig(kind="chargecache")), device=dev)
    launches = {"flash": fa.launches, "decode": pa.launches,
                "probe": hops.launches, "sim_step": sops.launches}
    k_serve = pk.launch_counts(reset=True)
    print(f"  scheduler: {sched.stats}")
    print(f"  DRAM closed loop: hit={cc['hcrac_hit_rate']:.1%} "
          f"speedup={base['total_cycles'] / cc['total_cycles']:.4f}x")
    print(f"  launches on this path: {launches}; decode: "
          f"{decode_launches(pk, k_serve, launches['decode'])}", flush=True)
    check(launches["flash"] == cfg.n_layers
          and launches["decode"] == cfg.n_layers * n_new
          and k_serve[pk.COMBINE_ENTRY] == 0,
          f"serve_lm path launches {launches}: expected {cfg.n_layers} "
          f"flash, {cfg.n_layers * n_new} decode, no combine")
    check(launches["probe"] > 0 and launches["sim_step"] == 2,
          f"serve_lm path launches {launches}: the scheduler's probes and "
          f"two simulations must run on the card")
    check(sched.stats["retired"] == 12 and cc["total_cycles"] > 0,
          "the scheduler did not retire every request")

    rows = []
    for name, res, src, rep, n, n_c in (
            ("flash_attention", flash, "flash_attention/csrc/"
             "flash_attention.cu", "flash_attention/kernel.py:73",
             launches["flash"], c_flash),
            ("paged_attention", dec, "paged_attention/csrc/"
             "paged_attention.cu", "paged_attention/kernel.py:68",
             launches["decode"], c_dec)):
        # the main path's shape; ``launches`` counts the wrappers' calls
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}",
            "replaces": f"src/repro/kernels/{rep}", "launches": n,
            **res["full"][0], "max_abs_err": res["max_abs_err"],
            "launches_golden_run": n_c, "full": res["full"][1:]})
    rows[0].update({"prefill_ms": prefill_ms, "prefill_device_ms": p_busy,
                    "prefill_kernel_ms": p_k[names[0]],
                    "hmma": flash["hmma"]})
    rows[1].update({"hmma": dec["hmma"], "kernel_launches": k_serve,
                    "kernel_launches_golden_run": k_dec,
                    "decode_step_ms": decode_ms, "decode_device_ms":
                    d_busy / L["steps"] if d_busy else None,
                    "decode_kernel_ms": d_k[names[1]] / L["steps"]})
    return rows


# --------------------------------------------------------------------------
# phases 13-15: SSM serving (falcon-mamba-7b at full width)
# --------------------------------------------------------------------------

#: tests/test_kernels.py's ssm_scan shapes (B, T, D, N), then the
#: full-width chunk (falcon-mamba-7b: d_inner 8 192, N 16) at phase 15's
#: batch, the golden prompt's second chunk as prefill hands it over (44
#: steps and 212 padded ones: decay 1, dbu 0) and those 44 steps alone
SCAN_MATRIX = [(2, 16, 96, 8), (1, 32, 64, 16), (2, 8, 100, 4),
               (1, 64, 32, 16)]
SCAN_FULL = (4, 256, 8192, 16)
SCAN_TAIL = [(2, 256, 8192, 16, 44), (2, 44, 8192, 16, 44)]
#: the card's falcon-mamba-7b logits against golden_lm_ssm.json.  Full
#: depth: twice the largest difference between the port on the CPU and
#: repro (0.4688 on the top-8 logits, 0.0089 on the logsumexp;
#: tests/_torch_golden.py lm_ssm), which is the random model's chaos (an
#: ulp in 0.1 % of the weights moves repro's own logits by ~1).  Cut to
#: its first 2 layers, where that distance is 0.0312 (one bf16 ulp at the
#: top logits' magnitude 4-8) / 0.0070: four such ulps, as
#: LM_LOGIT_TOL; this run holds the port to bf16 rounding.
LM_SSM_LOGIT_TOL = 0.9375
LM_SSM_CUT_TOL = 0.125
#: phase 15: prefill of B 4 x 2 048 tokens (8 scan chunks a layer), then
#: greedy decode steps
SSM_SERVE = {"batch": 4, "prompt": 2048, "steps": 8}


def scan_bound_ms(B, T, D, N) -> float:
    """decay, dbu, c and h0 read once, h_out and y written once, f32,
    over the card's memory rate (2 operations a state element a step for
    h and 2 for y: ~1 operation a byte, far below the f32 rate)."""
    nbytes = 4 * (2 * B * T * D * N + B * T * N + 2 * B * D * N + B * T * D)
    return nbytes / HBM_BYTES_PER_S * 1e3


def scan_case(B, T, D, N, seed: int, dev, real=None):
    """Inputs as tests/test_kernels.py draws them (decay in [0.5, 1),
    dbu ~ 0.1 N(0, 1), c and a nonzero h0 ~ N(0, 1)); steps from ``real``
    on are padding (decay 1, dbu 0)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    decay = torch.rand((B, T, D, N), generator=g, device=dev) * 0.5 + 0.5
    dbu = torch.randn((B, T, D, N), generator=g, device=dev) * 0.1
    c = torch.randn((B, T, N), generator=g, device=dev)
    h0 = torch.randn((B, D, N), generator=g, device=dev)
    if real is not None:
        decay[:, real:] = 1.0
        dbu[:, real:] = 0.0
    return decay, dbu, c, h0


def phase_scan(sk, sr, dev) -> dict:
    """ssm_scan kernel against its plain version (both on the card):
    ``h_out`` bit for bit, ``y`` within ``ref.y_limit``; the full-width
    chunk timed beside the plain version and its bytes bound."""
    import torch
    out = {"max_abs_err": 0.0}
    cases = ([(c, None) for c in SCAN_MATRIX] + [(SCAN_FULL, None)]
             + [(c[:4], c[4]) for c in SCAN_TAIL])
    for i, (case, real) in enumerate(cases):
        B, T, D, N = case
        args = scan_case(B, T, D, N, 15 + i, dev, real)
        h, y = sk.ssm_scan(*args)
        plain_ms, (hr, yr) = cuda_ms(lambda: sr.ssm_scan_ref(*args),
                                     torch.cuda.synchronize)
        lim = sr.y_limit(*args)
        err = float((y - yr).abs().max())
        share = float(((y - yr).abs() / lim).max())
        h_bad = int((h != hr).sum())
        out["max_abs_err"] = max(out["max_abs_err"], err,
                                 float((h - hr).abs().max()))
        line = (f"  B{B} T{T} D{D} N{N}"
                + (f" ({real} steps, the rest padding)"
                   if real is not None and real < T else "")
                + f": h_out elements differing {h_bad}; y max |kernel - "
                f"plain| {err:.3g}, max |plain| {float(yr.abs().max()):.3g},"
                f" worst share of the limit {share:.3g}")
        if real is None and case == SCAN_FULL:
            ms = loop_ms(lambda: sk.ssm_scan(*args))
            bound = scan_bound_ms(B, T, D, N)
            out.update({"shape": list(case), "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "bytes"})
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bytes "
                     f"bound {bound:.4f} ms")
        print(line, flush=True)
        check(h_bad == 0 and share <= 1.0,
              f"ssm_scan kernel disagrees with its plain version at {case}")
        del args, h, y, hr, yr, lim
    return out


def ssm_phases(golden_mod, smi: str, device="cuda") -> dict:
    """Phases 13-15 (the ssm_scan kernel, falcon-mamba-7b at full width
    against ``golden_lm_ssm.json``, and its serving path timed) on
    ``device``; returns the kernel line's ``ssm_scan`` row."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as so
    from repro_torch.kernels.ssm_scan import ref as sr
    from repro_torch.launch import steps
    from repro_torch.models import lm, ssm, zoo
    dev = torch.device(device)
    torch.cuda.empty_cache()

    print("\nphase 13: ssm_scan kernel vs plain version (on the card)",
          flush=True)
    scan = phase_scan(sk, sr, dev)

    # --- phase 14: falcon-mamba-7b at full width against repro ----------
    print("\nphase 14: falcon-mamba-7b at full width vs golden_lm_ssm.json",
          flush=True)
    L = golden_mod.LM_SSM
    gold = golden_mod.load_lm(golden_mod.LM_SSM_PATH)
    cfg = get(L["config"])
    t0 = time.time()
    tree = golden_mod.golden_weights(lm.lm_defs(cfg), L["seed"], dev)
    check(golden_mod.weights_digest(tree) == gold["weights_digest"],
          "the golden weights built on the card differ from repro's")
    model = lm.LM(cfg, tree)
    del tree
    prompt, dec_in = golden_mod.lm_tokens(cfg.vocab_size, dev, spec=L)
    check(golden_mod.tokens_digest(prompt, dec_in) == gold["tokens_digest"],
          "the golden tokens built on the card differ from repro's")
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {sum(p.numel() for p in model.parameters())} "
          f"parameters (bf16), golden weights and tokens built on the card "
          f"in {time.time() - t0:.1f} s, digests equal to repro's",
          flush=True)
    cut_cfg = dataclasses.replace(cfg, n_layers=L["cut_layers"])
    full_tree = model.tree()
    cut_model = lm.LM(cut_cfg, dict(
        full_tree, layers=full_tree["layers"][:L["cut_layers"]]))
    check(golden_mod.weights_digest(cut_model.tree())
          == gold["cut"]["weights_digest"],
          "the cut model's weights differ from repro's")
    golden_runs = []          # (prefill launches, max logit diff) a run
    for name, m, c, rec, tol in (
            ("full depth", model, cfg, gold, LM_SSM_LOGIT_TOL),
            (f"first {cut_cfg.n_layers} layers", cut_model, cut_cfg,
             gold["cut"], LM_SSM_CUT_TOL)):
        so.launches = 0
        logits, cache = zoo.prefill_fn(m, {"tokens": prompt}, c,
                                       L["prompt"] + L["steps"])
        torch.cuda.synchronize()
        n_prefill = so.launches
        steps_out = [logits]
        for t in range(L["steps"]):
            logits, cache = zoo.decode_fn(m, cache, dec_in[t], c)
            steps_out.append(logits)
        torch.cuda.synchronize()
        n_decode = so.launches - n_prefill
        want = c.n_layers * math.ceil(L["prompt"] / ssm.CHUNK)
        print(f"  {name}: prefill B{L['batch']} x {L['prompt']} + "
              f"{L['steps']} decode steps: ssm_scan launches {n_prefill} in "
              f"prefill, {n_decode} in decode", flush=True)
        check(n_prefill == want and n_decode == 0,
              f"expected {want} ssm_scan launches in prefill and none in "
              f"decode")
        worst, sure = 0.0, 0
        for t, (x, r) in enumerate(zip(steps_out, rec["steps"])):
            check(tuple(x.shape) == (L["batch"], cfg.vocab_padded)
                  and bool(torch.isfinite(x.float()).all()),
                  f"step {t}: malformed logits")
            d, n, _ = check_logits(t, x, r, tol, "golden_lm_ssm.json")
            worst, sure = max(worst, d), sure + n
        print(f"  {name}: {len(steps_out)} steps x {L['batch']} rows vs "
              f"repro: max |d| top-{L['top_k']} logits / logsumexp "
              f"{worst:.4f} (tolerance {tol}); argmax equal on all {sure} "
              f"rows whose margin exceeds {2 * tol}", flush=True)
        golden_runs.append((n_prefill, worst))
    (c_prefill, worst_full), (_, worst_cut) = golden_runs
    del cache, steps_out, logits, cut_model, full_tree

    # --- phase 15: the serving path timed --------------------------------
    S = SSM_SERVE
    print(f"\nphase 15: falcon-mamba-7b serving path: prefill_fn B "
          f"{S['batch']} x {S['prompt']}, then {S['steps']} make_serve_step "
          f"steps", flush=True)
    tokens = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (S["batch"], S["prompt"]))).to(dev)
    max_len = S["prompt"] + S["steps"]
    serve = steps.make_serve_step(cfg)
    prefill = lambda: zoo.prefill_fn(model, {"tokens": tokens}, cfg, max_len)
    prefill()                     # warm-up at these shapes, not counted
    torch.cuda.reset_peak_memory_stats()
    fa.launches = pa.launches = so.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits, cache = prefill()
    mid.record()
    tok = torch.argmax(logits, -1).to(torch.int32)
    outs = []
    t1 = time.time()
    for _ in range(S["steps"]):
        tok, cache = serve(model, cache, tok)
        outs.append(tok.cpu())
    end.record()
    end.synchronize()
    t_dec = time.time() - t1
    launches = {"ssm_scan": so.launches, "flash": fa.launches,
                "decode": pa.launches}
    prefill_ms = start.elapsed_time(mid)
    decode_ms = mid.elapsed_time(end) / S["steps"]
    outs = torch.stack(outs)
    n_chunks = math.ceil(S["prompt"] / ssm.CHUNK)
    print(f"  launches on this path: {launches}", flush=True)
    check(launches["ssm_scan"] == cfg.n_layers * n_chunks
          and launches["flash"] == 0 and launches["decode"] == 0,
          f"serving path launches {launches}: expected "
          f"{cfg.n_layers * n_chunks} ssm_scan and no attention")
    check(bool(((outs >= 0) & (outs < cfg.vocab_size)).all()),
          "decoded tokens out of range")
    print(f"  prefill {prefill_ms:.2f} ms (CUDA events; host clock "
          f"{(t1 - t0) * 1e3:.2f} ms), decode {decode_ms:.3f} ms a step "
          f"(CUDA events), {S['steps'] * S['batch'] / t_dec:.1f} tok/s "
          f"(host clock, {t_dec:.3f} s for {S['steps']} steps); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB; tokens {outs.T.tolist()}", flush=True)
    # the decay / dBu materialisation of one full-width chunk, alone
    di, N = cfg.d_inner, cfg.ssm_state
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    dtc = (torch.rand((S["batch"], ssm.CHUNK, di), generator=g, device=dev)
           * 0.1).to(torch.bfloat16)
    uc = torch.randn((S["batch"], ssm.CHUNK, di), generator=g,
                     device=dev).to(torch.bfloat16)
    bc = torch.randn((S["batch"], ssm.CHUNK, N), generator=g,
                     device=dev).to(torch.bfloat16)
    A = -torch.exp(model.layers[0]["ssm"]["A_log"].float())
    disc_ms = loop_ms(lambda: ssm._discretise(dtc, uc, bc, A))
    del dtc, uc, bc
    groups = ("ssm_scan_kernel", ("gemm", "nvjet", "cutlass", "xmma"),
              "exp_kernel", ("MulFunctor", "mul_kernel"))
    p_wall, p_busy, p_k = profile_kernels(prefill, groups)
    run_cache = {"pos": cache["pos"].clone(),
                 "ssm": {k: v.clone() for k, v in cache["ssm"].items()}}

    def decode_all():
        c, t = run_cache, tok
        for _ in range(S["steps"]):
            t, c = serve(model, c, t)
    d_wall, d_busy, d_k = profile_kernels(decode_all, groups)
    share = lambda part, whole: (f"{100 * part / whole:.1f} %"
                                 if part is not None and whole
                                 else "not measured")
    print(f"  profiled prefill: {p_wall:.2f} ms wall, device busy {p_busy} "
          f"ms ({share(p_busy, p_wall)} of the wall); ssm_scan kernel "
          f"{p_k['ssm_scan_kernel']:.2f} ms ({share(p_k['ssm_scan_kernel'], p_busy)}), "
          f"GEMMs {p_k['gemm']:.2f} ms ({share(p_k['gemm'], p_busy)}), exp "
          f"{p_k['exp_kernel']:.2f} ms ({share(p_k['exp_kernel'], p_busy)}),"
          f" multiplies {p_k['MulFunctor']:.2f} ms "
          f"({share(p_k['MulFunctor'], p_busy)}); decay + dBu of one chunk "
          f"timed alone {disc_ms:.3f} ms, x {cfg.n_layers * n_chunks} "
          f"chunks = {disc_ms * cfg.n_layers * n_chunks:.1f} ms", flush=True)
    print(f"  profiled {S['steps']} decode steps: {d_wall:.2f} ms wall, "
          f"device busy {d_busy} ms ({share(d_busy, d_wall)} of the wall), "
          f"GEMMs {d_k['gemm']:.2f} ms ({share(d_k['gemm'], d_busy)}); the "
          f"weights' bytes bound a step "
          f"{2 * sum(p.numel() for p in model.parameters()) / HBM_BYTES_PER_S * 1e3:.2f} ms",
          flush=True)
    print(f"  card: {smi}", flush=True)
    del model, cache, run_cache
    torch.cuda.empty_cache()
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:43",
            "launches": launches["ssm_scan"],
            "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
            "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
            "bound_by": scan["bound_by"], "library_ms": None,
            "shape": scan["shape"], "launches_golden_run": c_prefill,
            "prefill_ms": prefill_ms, "prefill_device_ms": p_busy,
            "prefill_kernel_ms": p_k["ssm_scan_kernel"],
            "prefill_gemm_ms": p_k["gemm"],
            "discretise_chunk_ms": disc_ms, "decode_step_ms": decode_ms,
            "decode_device_ms": d_busy / S["steps"] if d_busy else None,
            "logits_max_diff": worst_full, "logits_max_diff_cut": worst_cut}


# --------------------------------------------------------------------------
# phase 16: the Experiment layer and the five figures
# --------------------------------------------------------------------------

#: (a): the two traces, the capacities and the chunk of the kernel-vs-plain
#: Experiment (12 unique points in chunks of 5: a padded tail)
EXP_CHECK = {"n_req": 2000, "names": ("milc_like", "mcf_like"),
             "caps": (32, 128), "chunk": 5}


def cell_mismatches(want: dict, got: dict, rltl: bool) -> int:
    """Values of two stats dicts that differ: every ``BITWISE_KEYS`` stat
    (``golden_fullwidth.json``'s list), ``core_end``, the per-bank
    accumulators and, with ``rltl``, the RLTL histogram."""
    import numpy as np
    from repro_torch import golden as golden_mod
    bad = sum(int(want[k]) != int(got[k])
              for k in golden_mod.load()["bitwise_keys"])
    keys = ["core_end", "bank_acts", "bank_act_ras_sum"]
    keys += ["rltl_hist"] if rltl else []
    return bad + sum(not np.array_equal(want[k], got[k]) for k in keys)


def results_mismatches(want, got, rltl: bool) -> int:
    check(want.dims == got.dims and want.coords == got.coords,
          "Results grids differ in dims or coords")
    return sum(cell_mismatches(a, b, rltl)
               for a, b in zip(want.cells.flat, got.cells.flat))


def experiment_vs_plain(sim, traces, mechanisms, Experiment, device="cuda"):
    """(a): the Experiment layer on the card against the plain engine,
    and the launch half's promise of no synchronisation; the synthetic
    and serving modes of the layer against direct sweeps on the card
    (their entries draw floats, whose last ulp the CPU's plain engine may
    round otherwise: phases 4 and 7 hold them against the plain engine
    on the card)."""
    import torch
    from repro_torch.serving.loop import ServingSpec
    from repro_torch.workloads.arrivals import ArrivalConfig
    E = EXP_CHECK
    batches = {n: traces.single_core_batch(n, E["n_req"], seed=3)
               for n in E["names"]}
    kw = dict(traces=batches, trace_dim="workload", rltl=True,
              chunk_size=E["chunk"],
              axes={"mechanism": list(mechanisms.names()),
                    "capacity": E["caps"]})
    t0 = time.time()
    got = Experiment(device=device, **kw).run()
    card_s = time.time() - t0
    t0 = time.time()
    want = Experiment(device="cpu", **kw).run()
    plain_s = time.time() - t0
    check(got.meta["n_unique"] % E["chunk"] != 0, "no padded tail chunk")
    bad = {"experiment": results_mismatches(want, got, rltl=True)}
    # the labeled group through sweep_traces, and its launch half alone
    # with every synchronisation an error
    _, _, cfgs = Experiment(device="cpu", **kw).expand()
    group = list(batches.values())
    direct = sim.sweep_traces(group, cfgs, rltl=True, device=device)
    plain = sim.sweep_traces(group, cfgs, rltl=True, device="cpu")
    bad["sweep_traces"] = sum(cell_mismatches(a, b, True) for ra, rb in
                              zip(plain, direct) for a, b in zip(ra, rb))
    dev, host = torch.device(device), torch.device("cpu")
    shape, stacked = sim._grid_shape_and_params(cfgs, cfgs, host)
    geoms, idx = sim._hoist_geoms(cfgs, cfgs, host)
    geoms = sim._tree_map(lambda x: x.to(dev), geoms)
    staged = [sim._stage_trace(b, shape, geoms, dev, cfgs[0].warmup_frac,
                               True) for b in group]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = sim._launch_grid(shape, stacked, idx, staged, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    bad["launch_half"] = sum(
        cell_mismatches(a, b, True) for ra, rb in zip(
            plain, sim._drain_grid(outs, cfgs, group)) for a, b in zip(ra, rb))
    # the synthetic and serving modes of the layer, small
    synth = Experiment(device=device, traces=None, chunk_size=3, rltl=True,
                       base=sim.SimConfig(workload=traces.WorkloadSpec(
                           names=("stream_copy_like", "mcf_like"),
                           n_req=300, seed=4)),
                       axes={"interleave": ["bank", "xor"],
                             "geometry": ["ddr3_2ch"],
                             "mechanism": ["base", "chargecache"]})
    res = synth.run()
    bad["synth"] = sum(cell_mismatches(a, b, True) for a, b in zip(
        sim.sweep_synth(synth.expand()[2], rltl=True, device=device),
        res.cells.flat))
    spec = ServingSpec(arrival=ArrivalConfig(
        rate=1.5, prompt_pages_min=1, prompt_pages_max=2, decode_min=4,
        decode_max=12, seed=7), n_reqs=24, max_batch=4, queue_cap=32,
        arrivals_max=4, n_steps=48, hot_entries=1018, hot_exact=True)
    serve = Experiment(device=device, traces=None, chunk_size=4,
                       base=sim.SimConfig(serving=spec),
                       axes={"policy": ["fifo", "charge_aware", "preempting"],
                             "arrival_rate": (0.5, 2.0)})
    res = serve.run()
    want_s = sim.sweep_serving(serve.expand()[2], device=device)
    bad["serving"] = sum(
        cell_mismatches(a, b, False) + sum(
            int(a[k]) != int(b[k]) for k in ("arrived", "dropped", "retired",
                                             "preempted", "admit_hot"))
        for a, b in zip(want_s, res.cells.flat))
    print(f"  (a) {len(group)} traces x {len(cfgs)} points ({got.meta['n_unique']}"
          f" unique, chunks of {E['chunk']}), card {card_s:.1f} s / plain "
          f"{plain_s:.1f} s (host clocks); the Experiment, sweep_traces and "
          f"its launch half under sync-debug 'error' against the plain "
          f"engine, a synthetic and a serving Experiment against direct "
          f"sweeps on the card: mismatching values {bad}", flush=True)
    check(sum(bad.values()) == 0, "the Experiment layer on the card "
          "disagrees with the plain engine or a direct sweep")
    return sum(bad.values())


def golden_through_experiment(sim, traces, golden_mod, Experiment) -> int:
    """(b): the two golden workloads through the Experiment's mechanism
    axis, every cell against ``golden_fullwidth.json``."""
    gold = golden_mod.load()
    kinds = tuple(gold["kinds"])
    bad = 0
    for wname in ("eight_core", "single_core"):
        w = gold["workloads"][wname]
        batch = golden_mod.load_batch(traces, wname)
        res = Experiment(traces=batch, axes={"mechanism": list(kinds)},
                         base=sim.SimConfig(policy=w["policy"]),
                         rltl=True).run()
        bad += check_golden(w, kinds, [res.point(mechanism=k)
                                       for k in kinds])
    print(f"  (b) golden workloads through the Experiment: {bad} "
          f"mismatching values", flush=True)
    check(bad == 0, "the Experiment disagrees with the golden numbers")
    return bad


def direct_mismatches(sim, res, exp, which, rltl: bool) -> int:
    """The Experiment's cells against a direct ``sweep()`` of each trace
    named in ``which`` (its trace-dim labels) on the card."""
    _, _, cfgs = exp.expand()
    dim = exp.trace_dim
    bad = 0
    for label in which:
        batch = exp.traces[label]
        row = res.sel(**{dim: label})
        for a, b in zip(sim.sweep(batch, cfgs, rltl=rltl), row.cells.flat):
            bad += cell_mismatches(a, b, rltl)
    return bad


def figure_phase(sim):
    """(c) and (d): the five figures at the thesis's sizes on the card,
    each cell equal to a direct sweep (every trace for Fig 6.1, the first
    trace of each group for the others); the eight-core ordering; and the
    scheduler-policy study.  Returns the main path's launch counts and
    the figures' numbers for the kernels line."""
    from repro_torch.figures import (capacity, common as C, duration,
                                     energy, rltl, speedup)
    from repro_torch.kernels.hcrac import ops as hops
    from repro_torch.kernels.sim_step import ops
    from repro_torch.serving import study
    S = C.THESIS
    t0 = time.time()
    mixes = S.mixes()
    for name in S.singles:
        C.single_batch(name, S.n_req_1c, S.seed)
    for m in mixes:
        C.mix_batch(tuple(m), S.n_req_8c, S.seed)
    print(f"  traces: {len(S.singles)} single-core x {S.n_req_1c} requests, "
          f"{len(mixes)} eight-core mixes x {S.n_req_8c} a core, built on "
          f"the host in {time.time() - t0:.1f} s", flush=True)

    figs = {}
    ops.launches = ops.synth_launches = ops.serve_launches = 0
    hops.launches = 0
    t_all = time.time()

    def run(name, fn, *args):
        before = ops.launches
        t = time.time()
        out = fn(S, *args, device="cuda")
        wall = time.time() - t
        res = out["results"]
        launches = ops.launches - before
        check(launches == res.meta["n_kernel_launches"],
              f"{name}: {launches} sim_step launches, the runner planned "
              f"{res.meta['n_kernel_launches']}")
        figs[name] = {"wall_s": wall, "launches": launches,
                      "chunks": res.meta["n_chunks"],
                      "traces": len(res.coords[res.dims[0]])}
        return out, wall * 1e6

    sp1, us1 = run("speedup_single", speedup.single_core)
    sp8, us8 = run("speedup_eight", speedup.eight_core)
    cap1, usc1 = run("capacity_single", capacity.single_hits)
    cap8, usc8 = run("capacity_eight", capacity.eight)
    dur, usd = run("duration", duration.work)
    en1, use1 = run("energy_single", energy.single)
    en8, use8 = run("energy_eight", energy.eight)
    rl1, usr1 = run("rltl_single_open", rltl.fig_3_1_single, "open")
    rlc, usrc = run("rltl_single_closed", rltl.fig_3_1_single, "closed")
    rl8, usr8 = run("rltl_eight", rltl.fig_3_1_eight, "closed")
    fig_s = time.time() - t_all
    fig_launches = ops.launches
    t0 = time.time()
    pol = study.policy_experiment(device="cuda")
    pol_res = pol.run()
    pol_s = time.time() - t0
    main_launches = {"sim_step": ops.launches, "hcrac": hops.launches,
                     "sim_synth": ops.synth_launches,
                     "sim_serve": ops.serve_launches}
    print(f"  main path: five figures {fig_s:.1f} s wall, sim_step launches "
          f"{fig_launches}; policy study {pol_s:.1f} s; counts after both: "
          f"{main_launches}", flush=True)
    check(main_launches["sim_step"] > 0 and main_launches["hcrac"] > 0,
          "the main path launched no sim_step or no probe kernel")
    rows = (speedup.rows(sp1, us1, sp8, us8)
            + capacity.rows(cap1, usc1, cap8, usc8) + duration.rows(dur, usd)
            + energy.rows(en1, use1, en8, use8)
            + rltl.rows(rl1, usr1, rlc, usrc, rl8, usr8))
    for row in rows:
        print(f"  {row}")
    for name, f in figs.items():
        print(f"    {name:<20} {f['wall_s']:7.2f} s wall, {f['traces']:2d} "
              f"traces x {f['chunks']} chunk(s) = {f['launches']} sim_step "
              f"launches")

    # (c) the cells against direct sweeps on the card
    t0 = time.time()
    bad = 0
    exp = C.singles_experiment(S.singles, speedup.AXES, S.n_req_1c, S.seed)
    bad += direct_mismatches(sim, sp1["results"], exp, S.singles, False)
    exp = C.mixes_experiment(mixes, speedup.AXES, S.n_req_8c, S.seed)
    bad += direct_mismatches(sim, sp8["results"], exp,
                             sp8["results"].coords["mix"], False)
    firsts = (
        (cap1, C.singles_experiment, S.singles, capacity.SINGLE_AXES, {},
         False),
        (cap8, C.mixes_experiment, S.sub_mixes(), capacity.EIGHT_AXES, {},
         False),
        (dur, C.mixes_experiment, S.sub_mixes(), duration.AXES, {}, False),
        (en1, C.singles_experiment, S.singles, energy.AXES, {}, False),
        (en8, C.mixes_experiment, mixes, energy.AXES, {}, False),
        (rl1, C.singles_experiment, S.singles, rltl.AXES,
         dict(base=C.sim_cfg("base", 1, "open"), rltl=True), True),
        (rlc, C.singles_experiment, S.singles, rltl.AXES,
         dict(base=C.sim_cfg("base", 1, "closed"), rltl=True), True),
        (rl8, C.mixes_experiment, mixes, rltl.AXES,
         dict(base=C.sim_cfg("base", 8, "closed"), rltl=True), True))
    n_size = {C.singles_experiment: S.n_req_1c, C.mixes_experiment:
              S.n_req_8c}
    for out, make, traces_of, axes, kw, with_rltl in firsts:
        exp = make(traces_of, axes, n_size[make], S.seed, **kw)
        res = out["results"]
        bad += direct_mismatches(sim, res, exp,
                                 res.coords[res.dims[0]][:1], with_rltl)
    for label in pol_res.coords["policy"]:
        for a, b in zip(sim.sweep(pol.traces[label], pol.expand()[2],
                                  rltl=False),
                        pol_res.sel(policy=label).cells.flat):
            bad += cell_mismatches(a, b, False)
    print(f"  (c) cells against direct sweeps on the card (every Fig 6.1 "
          f"trace, the first of each other group, both policy traces): "
          f"{bad} mismatching values ({time.time() - t0:.1f} s)", flush=True)
    check(bad == 0, "an Experiment cell differs from its direct sweep")

    # (d) the thesis's ordering (examples/chargecache_sim.py's check)
    a8 = sp8["avg"]
    lowered = sp8["results"].sel(mechanism="lldram").metric(
        "acts_lowered_frac")
    print(f"  (d) eight-core average speedups: base 1.0 < chargecache "
          f"{a8['chargecache']:.4f} < cc_nuat {a8['cc_nuat']:.4f} < lldram "
          f"{a8['lldram']:.4f}; lldram acts_lowered_frac "
          f"{lowered.min():.4f}..{lowered.max():.4f}", flush=True)
    check(1.0 < a8["chargecache"] < a8["cc_nuat"] < a8["lldram"],
          "speedup ordering base < chargecache < cc_nuat < lldram broken")
    check(bool((lowered == 1.0).all()), "lldram lowers fewer than all ACTs")
    return {"figures": figs, "figures_s": fig_s, "figure_launches":
            fig_launches, "main": main_launches, "cells_vs_direct": bad,
            "rows": rows, "policy_study_s": pol_s}


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
    from repro_torch.kernels.hcrac import kernel as hk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.ssm_scan import kernel as sk

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
    # the five libraries build at once, one nvcc each
    t0 = time.time()
    with ThreadPoolExecutor(5) as pool:
        libs = list(pool.map(lambda f: f(), (kernel.library, hk.library,
                                              fk.library, pk.library,
                                              sk.library)))
    print(f"sim_step + hcrac + flash_attention + paged_attention + ssm_scan "
          f"build+load: {time.time() - t0:.1f} s "
          f"({', '.join(b._name for b in libs)})")
    sim_log = Path(libs[0]._name).with_suffix(".log")
    regs = ptxas_report(sim_log.read_text() if sim_log.exists() else "")
    for built in libs:
        log = Path(built._name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if ("registers" in line or "spill" in line or "smem" in line
                        or "entry function" in line):
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
    shape1, stacked1 = args1[0], args1[1]
    nbytes1 = bytes_moved(batch1, len(kinds), args1[3].shape[0],
                          w1["n_steps"],
                          kernel.pack(stacked1, args1[4])[0].shape[1],
                          shape1.envelope.max_banks_total,
                          stacked1.thermal.seg_edge.shape[-1])
    bound1_ms = nbytes1 / HBM_BYTES_PER_S * 1e3
    mhz8 = sm_clock_mhz(lambda: ops.run_sweep(*args8))
    chain8, chain1 = (chain_bound_ms(w8["n_steps"], mhz8),
                      chain_bound_ms(w1["n_steps"], mhz8))
    print(f"\n  kernel: {len(grid38)}-point eight-core sweep {ms8:.2f} ms "
          f"({ms8 * 1e6 / w8['n_steps']:.1f} ns/step), bytes bound "
          f"{bound_ms:.4f} ms ({nbytes} B), chain bound {chain8:.2f} ms "
          f"({100 * chain8 / ms8:.1f} % reached); 8-point single-core "
          f"sweep {ms1:.2f} ms ({ms1 * 1e6 / w1['n_steps']:.1f} ns/step), "
          f"bytes bound {bound1_ms:.4f} ms ({nbytes1} B), chain bound "
          f"{chain1:.2f} ms ({100 * chain1 / ms1:.1f} % reached)")
    print(f"  chain bound: {CHAIN_CYCLES} cycles a request ("
          + ", ".join(f"{n} x {name} at {lat}" for name, n, lat in CHAIN)
          + f") at the SM clock read during the sweep, {mhz8:.0f} MHz")
    for entry, r in regs.items():
        print(f"  {entry}: {r['registers']} registers, spill stores "
              f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
    check(all(r["spill_stores"] + r["spill_loads"] == 0
              for r in regs.values()), "a scan entry spills registers")

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
    mhz32 = sm_clock_mhz(lambda: ops.run_synth(*args32, True))
    chain32 = chain_bound_ms(n32, mhz32)
    print(f"\n  kernel: {len(grid32)}-point synth sweep {ms32:.2f} ms "
          f"({ms32 * 1e6 / n32:.1f} ns/step); generation pre-pass alone "
          f"{gen_ms:.2f} ms ({100 * gen_ms / ms32:.1f} %), the scan "
          f"{ms32 - gen_ms:.2f} ms ({(ms32 - gen_ms) * 1e6 / n32:.1f} "
          f"ns/step); bytes bound {bound32:.4f} ms ({nbytes32} B); chain "
          f"bound {chain32:.2f} ms at {mhz32:.0f} MHz ({100 * chain32 / ms32:.1f}"
          f" % reached, {100 * chain32 / (ms32 - gen_ms):.1f} % of the scan)")

    # the divider every scan builds, on the divisors of phases 3-5
    div_bad = check_divider(kernel, [
        (args8[1], args8[4]), (args1[1], args1[4]),
        (args32[1], torch.zeros_like(args32[4])),
        (lambda a: (a[1], torch.zeros_like(a[4])))(sim._stage_synth(
            synth_cut_grid(sim, traces), None, torch.device("cuda")))])
    check(div_bad == 0, "the device divider disagrees with floor division")

    serve_rows = serving_phases(sim, timing, golden_mod, regs)
    max_err = max(max_err, serve_rows[1]["max_abs_err"])
    lm_rows = lm_phases(golden_mod, sim)
    ssm_row = ssm_phases(golden_mod, smi)

    # --- phase 16: the Experiment layer and the five figures -------------
    print("\nphase 16: the Experiment layer and the five figures", flush=True)
    from repro_torch.experiment import Experiment
    exp_bad = experiment_vs_plain(sim, traces, mechanisms, Experiment)
    gold_bad = golden_through_experiment(sim, traces, golden_mod, Experiment)
    fig = figure_phase(sim)
    serve_rows[0]["launches_policy_study"] = fig["main"]["hcrac"]
    print(smi)

    # --- kernel numbers ---------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "sim_step", "route": "cuda",
        "source": "src/repro_torch/kernels/sim_step/csrc/sim_step.cu",
        "replaces": "src/repro/kernels/sim_step/kernel.py:66",
        "launches": launches, "max_abs_err": max_err,
        "mismatches": cut_bad,
        "ms": ms8, "plain_ms": plain_t, "plain_steps": CUT_STEPS,
        "ms_at_plain_steps": cut_ms, "steps": w8["n_steps"],
        "points": len(grid38), "single_core_ms": ms1,
        "single_core_bound_ms": bound1_ms,
        "ns_per_step": ms8 * 1e6 / w8["n_steps"],
        "single_core_ns_per_step": ms1 * 1e6 / w1["n_steps"],
        "chain_bound_ms": chain8, "single_core_chain_bound_ms": chain1,
        "chain_cycles_per_request": CHAIN_CYCLES, "sm_clock_mhz": mhz8,
        "registers": regs.get("sim_step_kernel", {}).get("registers"),
        "spill_bytes": sum(regs.get("sim_step_kernel", {}).get(k, 0)
                           for k in ("spill_stores", "spill_loads")),
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "experiment_mismatches": exp_bad + gold_bad + fig["cells_vs_direct"],
        "figure_launches": fig["figure_launches"],
        "figures_s": fig["figures_s"],
        "figure_walls_s": {k: v["wall_s"] for k, v in fig["figures"].items()},
        "experiment_main_launches": fig["main"]}, {
        "name": "sim_step_synth", "route": "cuda",
        "source": "src/repro_torch/kernels/sim_step/csrc/sim_step.cu",
        "replaces": "src/repro/kernels/sim_step/ops.py:65",
        "launches": synth_launches, "max_abs_err": s_err,
        "mismatches": s_bad + fs_bad, "ms": ms32, "plain_ms": s_plain_ms,
        "plain_points": s_cut_points, "plain_steps": s_cut_steps,
        "ms_at_plain_steps": s_cut_ms, "steps": n32,
        "points": len(grid32), "prepass_ms": gen_ms,
        "streams_equal_to_golden": same, "streams_differing": differ,
        "ns_per_step": ms32 * 1e6 / n32, "chain_bound_ms": chain32,
        "chain_cycles_per_request": CHAIN_CYCLES, "sm_clock_mhz": mhz32,
        "divider_mismatches": div_bad,
        "registers": regs.get("sim_synth_kernel", {}).get("registers"),
        "spill_bytes": sum(regs.get("sim_synth_kernel", {}).get(k, 0)
                           for k in ("spill_stores", "spill_loads")),
        "bound_ms": bound32, "bound_by": "bytes", "library_ms": None},
        *serve_rows, *lm_rows, ssm_row]}))
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
