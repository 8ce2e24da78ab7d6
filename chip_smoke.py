#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the ``sim_step`` kernel (four entries: over a trace,
synthesising its own streams, the serving closed loop, and the FR-FCFS
window engine over a trace or its own streams), the HCRAC
probe kernel, the flash- and decode-attention kernels, the ssm_scan
and the rglru_scan kernels from the sources in the checkout, holds each against its plain
PyTorch version, drives the port's paths at full size
(``repro_torch.core.simulator.sweep``, ``sweep_synth``, the serving
loop: ``sweep_serving`` and the host scheduler's ``run_host``, dense-LM
serving of tinyllama-1.1b: ``prefill_fn`` / ``decode_fn`` and
``examples/serve_lm_torch.py``, SSM serving of falcon-mamba-7b, the
Experiment layer drawing the thesis's five figures, the FR-FCFS
controller study, the simulator-side studies with the ChargeCache
example, and the rest of the model zoo: recurrentgemma-2b, the MoE
configs, whisper-small, granite-34b, pixtral-12b and phi3-medium-14b),
training (the flash kernel's backward entries, tinyllama-1.1b's and
whisper-small's train steps, ``examples/train_lm_torch.py``) and
fault-tolerant training (``examples/fault_tolerance_torch.py``'s drill,
the two XLA attention strategies, a one-rank mesh), checks the results against the JAX package's recorded golden numbers
(``src/repro_torch/data/golden_fullwidth.json``, ``golden_synth.json``,
``golden_serving.json``, ``golden_lm.json``, ``golden_lm_ssm.json``,
``golden_frfcfs.json``, ``golden_drivers.json``, ``golden_lm_zoo.json``,
``golden_train.json`` and ``golden_ft.json``),
and times the kernels.  It imports nothing of JAX or of the ``repro``
package.  Phases:

1. the card's name and power limit, and the kernel's build time; while
   the kernels build, four worker processes make the plain runs that
   phases 4 and 7 hold the synthesis and serving entries to
   (``PLAIN_WORKERS``: host-bound eager loops, ~360 s one after
   another), and the script waits for them before phase 2;
2. kernel against plain version (both on the card) at <= 2 000
   requests: every mechanism kind x 2 geometries, open and closed
   policy, stateful and legacy refresh, the ``ramp`` thermal schedule, a
   point folded into a padded 32-bank envelope, exact HCRAC expiry,
   padded steps, and every kind under 4x refresh pressure
   (``timing.with_refresh_pressure``, stateful refresh); then the
   full-size grid's inputs at a cut depth.  Every
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
   refresh, a phased spec on part of the points; every kind under 4x
   refresh pressure on ``figures/refresh.py``'s four-core stream at 500
   requests a core; then phase 5's 32
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
   card): the SASS census of each bf16 forward instantiation of the
   built library (``cuobjdump -sass``: ``HGMMA``, wgmma, in every one,
   no ``HMMA``, mma.sync, and no ptxas warning of serialised wgmma), then
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
12. ``examples/serve_lm_torch.py``'s ``main`` at full width (its model
    and configuration passed in): ``make_serve_step`` greedy decode of 4 x 16
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
17. the FR-FCFS controller tier, the ``sim_window`` entry: (a) against
    the plain window engine on the card, 8 points (frfcfs windows 4, 8
    and 16 with in-order riders, on one channel and on 2 channels x 2
    ranks, where tRRD and tFAW bind, both row policies) x ~1 000 steps
    in one launch of depth 16, over a trace and over generated streams
    (the streams too), every output as in phase 2, and the general
    controller of ``window_ctl.cuh`` (40 cores; 8 cores at depth 40)
    with a rider; the in-order riders of every launch run the trace
    entry's scan in the same launch, and (b) and (d) name those blocks;
    (b) the eight-core
    golden trace at full size, {base, chargecache} x {in-order, frfcfs
    w8, w16} in one launch, the frfcfs points equal to
    ``golden_frfcfs.json`` (``repro``'s window engine on the CPU) bit
    for bit; its time, ns a step, the share of the window entry's
    dependent-chain bound (``WINDOW_STEP_CYCLES``) and the bytes bound;
    (c) that launch's in-order riders equal to the trace entry's output
    for the same points; (d) ``figures/frfcfs.py``'s grid at full size (8
    cores x 40 000 requests, controller x mechanism x window), the main
    path of this slice: the launch counts are zeroed before it and must
    read one ``sim_window`` launch after; its stream and every cell held
    to ``repro``'s run of ``benchmarks/frfcfs.py`` at that size
    (``golden_frfcfs.json``: bit for bit where the stream's digest is
    ``repro``'s, else within the statistical tolerance), and the study's
    three assertions evaluated on the card's numbers and on ``repro``'s,
    which must fare alike (at this size ``repro``'s own study breaks its
    window-depth assertion: ROADMAP.md, Queue 3); the entry's registers
    and spills;
18. the simulator-side studies (``repro_torch.figures``) and the examples,
    the main path of this slice: (a) geometry, aldram, refresh,
    workloads, sweep_bench, serving_trace, serving_loop and megasweep
    (10**4 and 10**5 points, each arm a subprocess) at ``repro``'s full
    size, the launch counts zeroed before them and read after (each
    study holds its launches to the runner's plan itself), each study's
    CSV rows, wall time and launches, and its cells against a direct
    ``sweep()`` / ``sweep_synth()`` / ``sweep_serving()`` on the card (the
    first mix of geometry and aldram; megasweep's 10**5 metric arrays
    against a direct sweep of its 500 distinct points); (b) the refresh
    study against ``repro``'s full-size run (``golden_drivers.json``: the
    stream's digest first, then every cell bit for bit where it is equal,
    else within the statistical tolerance, and the dedup's point count);
    (c) ``examples/chargecache_sim_torch.py`` at its default size,
    single-core and ``--eight-core`` in the order base < chargecache <
    cc_nuat < lldram, then ``--heat-grid`` and ``--geo-grid``, and the
    dispatcher ``python -m repro_torch.figures.run --quick`` on four
    studies writing its JSON under a temporary directory;
19. the flash and decode kernels at the zoo's shapes and the rglru_scan
    kernel against their plain versions: flash at recurrentgemma-2b's
    prefills (B 1 x S 2 100 and B 4 x 2 048, H 10 over K 1, hd 256,
    window 2 048), S 16 and a bidirectional case, whisper-small's
    encoder, decoder and cross-attention (64 queries over 1 500 frames),
    mixtral's and phi3.5-moe's prefills, bf16 (and f32 where short);
    decode over a 2 048-slot ring (G 10 over K 1, hd 256, wrapped),
    whisper's self- and cross-attention (all 1 500 frames valid) and
    mixtral's last step, each split as ``plan_split`` cuts it and in one
    chunk; rglru_scan (the gates, the gate factor and the recurrence
    from bf16 gate inputs, a channel saturating ``r`` to 0 and one ``i``
    to 1) bit for bit in ``h_seq`` and ``h_S`` at B 2 x 2 048 x 2 560,
    phase 20's prefill and a decode step, and on every non-NaN bf16 value
    as ``r_pre`` and ``i_pre`` (``RG_EVERY``); timed beside the plain
    versions, SDPA (a mask where there is one) and the bounds (the scan's
    bytes: three bf16 inputs read, h written); the hd-256 entries' and
    the scan's registers and spills, the scan's shared memory a block;
20. recurrentgemma-2b at published widths: its first 3 layers at B 1 x
    2 100 (the ring wraps) + 8 steps against ``golden_lm_zoo.json``; the
    full 26 layers at B 2 x 300 + 8 steps against the same model on the
    plain kernels, both within ``ZOO_ULPS``; then prefill B 4 x 2 048 and
    a decode step timed, with the kernels' device time
    (``torch.profiler``: also the element-wise kernels' share of the
    prefill and the kernels one decode step launches), every kernel's
    launches counted;
21. phi3.5-moe (2 layers, B 1 x 300 + 8 steps, against ``repro``: its
    router logits within ``ROUTE_LOGIT_ULPS`` of the record's, its
    expert choices equal but at near ties) and mixtral-8x22b (2 layers,
    B 2 x 300 + 8 steps, against the plain kernels, routing likewise),
    timed;
22. whisper-small at full depth (12 + 12 layers, 1 500 stub frames, B 2
    x 64 + 8 steps, cache 80) against the record, timed;
23. granite-34b (2 layers), pixtral-12b (2 layers, 256 stub patches) and
    phi3-medium-14b (4 layers) against the record; then pixtral-12b and
    phi3-medium-14b at full depth, prefill and decode timed;
24. training: (a) the flash kernel's training entries (the forward with
    its log-sum-exp and its output's low halves, O + O_lo within
    ``FLASH_O32_TOL`` of the f32 output, the backward's D, dK / dV (on
    wgmma), group-sum and dQ (on wgmma) entries) against their plain
    version (autograd of the f32 reference) at
    ``FLASH_BWD``'s shapes within ``FLASH_BWD_RTOL`` / ``ATOL``, each run
    twice and bitwise equal, each entry timed beside its bound, the whole
    backward beside its bound, the plain version, SDPA's backward alone
    (device, ``torch.profiler``) and SDPA's forward + backward (events),
    their ptxas numbers and the wgmma entries' SASS census (HGMMA), and
    the bf16 forward's serving instantiations' against
    ``SERVING_FLASH_PTXAS`` (no spill at HDP 64 and 128); (b) one
    ``make_train_step`` step of tinyllama-1.1b at published width (cut
    as ``golden.TRAIN`` says) from the golden weights built on the card
    against ``golden_train.json`` within ``golden.TRAIN_TOL``, the same
    step on the plain versions, then the full 22 layers against their
    plain-version step; (c) whisper-small's step (12 + 12 layers, B 2 x
    64 tokens, 1 500 frames) against its plain-version step within
    ``WHISPER_TRAIN_TOL`` and against the kernels' forward with the
    plain backward within ``golden.TRAIN_TOL``, its decoder
    self-attention's dQ held in place to phase (a)'s limit; (d)
    ``examples/train_lm_torch.py --preset 100m`` for 30 steps with a
    checkpoint at 20, resumed to 30 (the loss falls; the resumed run's
    last loss and parameters bitwise equal to the straight run's); (e)
    tinyllama-1.1b's full train step at B 4 x 2 048 timed, its tokens/s
    and share of 989 TFLOP/s;
25. fault-tolerant training: (a) ``examples/fault_tolerance_torch.py``'s
    drill (``golden.FT``: tinyllama-1.1b at published widths cut to 2
    layers, B 8 x 256; 40 steps, host 3 fails at 25, host 5 straggles
    from 12, a checkpoint every 10: 48 steps, four saves, one restore)
    with its report and printed lines equal to ``golden_ft.json``,
    finite falling losses, the flash training entries launched the
    straight run's count a step times 48, and its final parameters and
    AdamW state bitwise equal to a straight 40-step run (two straight
    runs are compared first; were they to differ, the drill would be
    held to 4x their distance, measured before it runs); step ms, save
    and restore s, checkpoint GB; (b) ``layers.blocked_attention``
    against the flash kernel (B 4 x S 500, phi4-mini B 1 x S 2 048) and
    ``layers.split_kv_decode_attention`` against the decode kernel (W
    520, granite's W 4 100) within ``tests/test_kernels.py``'s limits;
    (c) a one-rank ``nccl`` group over a ``FileStore``, ``launch.mesh.
    make_host_mesh()``, and the drill's last checkpoint restored into
    DTensor leaves placed by ``params.shard_params``: each
    ``full_tensor()`` bitwise equal to the plain restore;
26. the dry run (``launch/dryrun.py``), counted on the host: (a) the op
    counter over tinyllama-1.1b's full train step at phase 24 (e)'s B 4
    x 2 048 on meta tensors (no mesh): its FLOPs equal to
    ``train_flops`` less the terms no product of the step makes
    (``dryrun_flops``), its kernel calls equal to the launches phase 24
    (e) counted a step, and its per-device memory (arguments + peak of
    temporaries) held to phase 24 (e)'s ``max_memory_allocated`` within
    ``DRYRUN_MEM_RATIO``; (b) in a subprocess, away from phase 25's
    ``nccl`` group, ``run_cell`` on a ``fake`` group: tinyllama-1.1b
    ``train_4k`` on 16 x 16 and ``decode_32k`` on 2 x 16 x 16, both
    ``ok``;
then the total time, one JSON line of kernel numbers, and the last line:
``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line is printed.  Exits
non-zero at once when no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    # the H100's data-sheet rates (HBM_BYTES_PER_S, PEAK_OPS) and the
    # kernels' work formulas behind every bound printed here
    from repro_torch.analysis.roofline import (
        HBM_BYTES_PER_S, PEAK_OPS, bound_of, bwd_entry_bounds, decode_bound,
        flash_bound, flash_bwd_bound, rglru_bwd_bound, rglru_work,
        scan_bound_ms, scan_work, ssm_bwd_bound, train_flops)
except ImportError:     # run alone, without the package: main() says so
    pass
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
#: requests a core of phase 4's refresh-pressure points (the plain engine
#: takes ~7 ms a step on the card)
PRESSURE_CUT_REQ = 500
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


#: when the script started (the phase headings' clock)
T_START = time.time()


def phase(title: str) -> None:
    """Prints a phase heading with the seconds since the script
    started."""
    print(f"\nphase {title}  [t = {time.time() - T_START:.1f} s]",
          flush=True)


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


def ptxas_report(log: str, entry_re: str = r"(sim_[a-z]+_kernel)") -> dict:
    """``{entry: {"registers", "spill_stores", "spill_loads",
    "static_smem_bytes"}}`` of the entries whose mangled name matches
    ``entry_re`` (its first group names them; default: the
    ``sim_*_kernel`` entries) in a library's ``-Xptxas -v`` log."""
    import re
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?" + entry_re, line)
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
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[entry]["static_smem_bytes"] = int(m.group(1))
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
        # 4x refresh pressure (tREFI / 4), stateful refresh: the timing of
        # figures/refresh.py's pressure axis
        "refresh_pressure_4x": (
            traces.multicore_batch(["milc_like", "mcf_like"], 900, seed=4),
            [sim.SimConfig(timing=pressure_4x(), mech=sim.MechanismConfig(
                kind=k), policy=pol, refresh_mode="stateful")
             for k in kinds for pol in ("open", "closed")], False),
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


def pressure_4x():
    """4x refresh pressure, the timing of ``figures/refresh.py``'s
    pressure axis: tREFI / 4, floored at tRFC + 1."""
    from repro_torch.core.timing import DDR3_1600, with_refresh_pressure
    return with_refresh_pressure(DDR3_1600, 4)


def pressure_synth_grid(sim, traces):
    """Phase 4's refresh-pressure points: every kind under 4x pressure
    (stateful refresh) on ``figures/refresh.py``'s four-core stream."""
    from repro_torch.core import mechanisms as registry
    spec = traces.WorkloadSpec(names=("milc_like",) * 4,
                               n_req=PRESSURE_CUT_REQ, seed=3)
    return [sim.SimConfig(timing=pressure_4x(), mech=sim.MechanismConfig(
        kind=k), policy="closed", refresh_mode="stateful", workload=spec)
        for k in registry.names()]


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


def synth_vs_plain(sim, ops, name, grid, plain, device="cuda"):
    """Hold the synthesis entry against the plain version's ``(ms,
    outputs)`` on ``grid`` (a worker's run, ``load_plain``);
    returns ``(mismatches, max abs err, kernel ms, plain ms, points,
    steps)`` (it raises on any mismatch)."""
    import torch
    args = sim._stage_synth(grid, None, torch.device(device))
    got = ops.run_synth(*args, True, True)
    torch.cuda.synchronize()
    kernel_ms = median_ms(lambda: ops.run_synth(*args, True))
    plain_ms, want = plain
    bad, err = compare_outputs(got[:3], want[:3])
    s_bad = compare_streams(got[3], want[3])
    # the reduced launch (no events) against the plain version's columns
    red = sim.sweep_synth(grid, reduce_keys=REDUCE_KEYS, device=device)
    want_red = sim._reduce_device(want[0], want[1], REDUCE_KEYS).cpu()
    r_bad = int((torch.as_tensor(red) != want_red).sum())
    print(f"  {name}: {len(grid)} points x {args[5]} cores x {args[7]} "
          f"steps ({grid[0].workload.n_req} requests a core): kernel "
          f"{kernel_ms:.3f} ms, plain {plain_ms:.1f} ms (in a worker); "
          f"mismatches: "
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


def pinned_counts(shape, n_points: int, device):
    """Phase 7's pinned arrival counts, seeded, ``[n_points, n_steps]``."""
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(3).integers(
        0, shape.arrivals_max + 1, (n_points, shape.n_steps)).astype(
            np.int32)).to(device)


def phase_serve_vs_plain(sim, engine, ops, grid, plains, device="cuda"):
    """The serving entry against the plain engine's two runs ``plains``
    (workers' runs, ``load_plain``: arrivals drawn, then pinned) on
    ``grid``: drawn, pinned and reduced launches; returns ``(mismatches,
    max abs err, kernel ms, plain ms, steps)``."""
    import torch
    dev = torch.device(device)
    shape, params, warm = engine.stage_serving(grid, None, True, dev)
    n = shape.n_steps
    counts = pinned_counts(shape, len(grid), dev)
    bad = err = 0
    plain_ms = None
    for (name, c), (t_ms, want) in zip((("drawn", None), ("pinned", counts)),
                                       plains):
        got = ops.run_serve(shape, params, warm, c)
        torch.cuda.synchronize()
        plain_ms = plain_ms or t_ms
        b, e = compare_serve(got, want)
        bad, err = bad + b, max(err, e)
        print(f"  {name} arrivals: {len(grid)} points x {n} steps, "
              f"mismatches {b} (plain {t_ms:.0f} ms in a worker; arrived "
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


def serving_phases(sim, timing, traces, golden_mod, regs: dict,
                   plain_dir: str, device="cuda") -> tuple:
    """Phases 6-8 (the probe kernel, the serving entry, the serving path
    at full size) on ``device``; returns the kernel line's entries for
    ``hcrac_lookup`` and ``sim_step_serve`` (``regs``: ptxas's report of
    the sim_step library; ``plain_dir``: the plain workers' runs)."""
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
    phase("6: HCRAC probe kernel vs plain version (on the card)")
    host_spec = ServingSpec(
        policy="fifo", arrival=ArrivalConfig(
            rate=1.5, burstiness=1.0, prompt_pages_min=1, prompt_pages_max=2,
            decode_min=4, decode_max=12, seed=7),
        n_reqs=96, max_batch=8, queue_cap=128, arrivals_max=4, n_steps=320,
        cycles_per_step=4000, hot_entries=1018, hot_ways=2,
        hot_caching_ms=0.05, hot_exact=True)
    probe = phase_probe(hcl, hk, hops, href, host_spec.hot_cfg(), device)

    # --- phase 7: the serving entry against the plain engine -------------
    phase("7: sim_step serving entry vs plain serving engine (on "
          "the card)")
    # the grid, the scale streams' geometry and 48 slots, against the
    # plain runs the workers made during the build
    grids7 = [plain_grid(name, sim, traces, golden_mod, timing)
              for name in ("grid", "scale", "wide")]
    plains = [load_plain(plain_dir, f"serve:{name}:{mode}")
              for name in ("grid", "scale", "wide")
              for mode in ("drawn", "pinned")]
    (v_bad, v_err, v_cut_ms, v_plain_ms, v_cut_steps) = phase_serve_vs_plain(
        sim, engine, ops, grids7[0], plains[0:2], device)
    print("  the scale streams' geometry, every policy x mechanism:",
          flush=True)
    sc_bad, sc_err, *_ = phase_serve_vs_plain(sim, engine, ops, grids7[1],
                                              plains[2:4], device)
    v_bad, v_err = v_bad + sc_bad, max(v_err, sc_err)
    print("  48 slots, a 200-entry queue, 48 arrivals a step, every policy "
          "x mechanism:", flush=True)
    wide_bad, wide_err, *_ = phase_serve_vs_plain(sim, engine, ops, grids7[2],
                                                  plains[4:6], device)
    v_bad, v_err = v_bad + wide_bad, max(v_err, wide_err)
    del plains

    # --- phase 8: the serving path at full size ---------------------------
    phase("8: serving path at full size")
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


def load_example(name: str):
    """``examples/<name>.py`` of the checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    tuple of alternatives, keyed by its first.  The dict's
    ``"n_kernels"`` counts the kernels the device ran (copies and sets
    left out)."""
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
    by_name = {alts(n)[0]: ms([e for e in dev if any(
        a in e.name for a in alts(n))]) for n in names}
    by_name["n_kernels"] = sum(not e.name.startswith(("Memcpy", "Memset"))
                               for e in dev)
    return wall, busy, by_name


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


def sass_census(lib_path: str, entries, ops) -> dict:
    """``{function: {op: instructions}}`` (HMMA: mma.sync; HGMMA: wgmma)
    of the built library's functions whose (mangled) name holds one of
    ``entries``, from one ``cuobjdump -sass`` of the CUDA toolkit that
    built it."""
    from repro_torch import _build
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib_path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if any(e in fn for e in entries):
                counts[fn] = dict.fromkeys(ops, 0)
        elif fn in counts:
            for op in ops:
                counts[fn][op] += f" {op}." in line
    return counts


def hmma_counts(lib_path: str, entry: str) -> dict:
    """``{function: HMMA instructions}`` of the functions whose name holds
    ``entry``."""
    return {fn: c["HMMA"] for fn, c in
            sass_census(lib_path, (entry,), ("HMMA",)).items()}


#: the bf16 forward's instantiations ``HDP:chunks`` (64-key chunks a key
#: tile), serving and ``:lse`` training: every head dim up to 256 in
#: whole 64-dim subtiles, two chunks at HDP 128, one above, and at HDP 64
#: one (a short prompt, or two blocks an SM) or two
FWD_INSTANCES = [f"{hdp}:{nk}{lse}" for hdp, nk in
                 ((64, 1), (64, 2), (128, 2), (192, 1), (256, 1))
                 for lse in ("", ":lse")]


def flash_fwd_census(fk) -> dict:
    """The flash library's bf16 forward instantiations' SASS census
    (``{"HDP:chunks(:lse)": {"HGMMA": n, "HMMA": n}}``) and ptxas'
    warnings of lost performance (``wgmma`` serialised) in its build
    log."""
    import re
    lib = fk.library()._name
    sass = {}
    for fn, c in sass_census(lib, (fk.MMA_ENTRY,), ("HGMMA", "HMMA")).items():
        m = re.search(r"ILi(\d+)ELi(\d+)ELb([01])E", fn)
        sass[f"{m.group(1)}:{m.group(2)}" + (":lse" if m.group(3) == "1"
                                             else "")] = c
    log = Path(lib).with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    warns = [ln.strip() for ln in text.splitlines()
             if "Performance Loss" in ln]
    return {"sass": sass, "warnings": warns}


def seeded(shape, seed: int, dtype, device):
    """Standard normal values from numpy's generator (seeded), as
    ``dtype`` on ``device``."""
    import numpy as np
    import torch
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


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
    SASS census of its bf16 forward instantiations (``flash_fwd_census``);
    times the full-width shapes beside the plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    census = flash_fwd_census(fk)
    print(f"  SASS of the bf16 forward {fk.MMA_ENTRY} by HDP:chunks(:lse): "
          f"{census['sass']}", flush=True)
    for w in census["warnings"]:
        print(f"  ptxas: {w}", flush=True)
    check(sorted(census["sass"]) == sorted(FWD_INSTANCES)
          and all(c["HGMMA"] > 0 and c["HMMA"] == 0
                  for c in census["sass"].values())
          and not census["warnings"],
          f"a bf16 flash forward instantiation is missing, issues no wgmma "
          f"or an mma.sync, or ptxas serialised its products: {census}")
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    out = {"max_abs_err": 0.0, "full": [], "census": census["sass"]}
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


def decode_case(case, seed: int, dev, cross: bool = False):
    """Rotated queries, a ring cache and its slot positions: ``fill``
    positions written into ``W`` slots, position p in slot p mod W, the
    newest W kept; the query at position ``fill - 1``.  ``cross``: slot p
    holds position p (every slot below the query valid)."""
    import torch
    B, H, K, hd, W, window, fill = case
    q = seeded((B, H, hd), seed, torch.bfloat16, dev)
    kc = seeded((B, W, K, hd), seed + 1, torch.bfloat16, dev)
    vc = seeded((B, W, K, hd), seed + 2, torch.bfloat16, dev)
    slots = torch.arange(W)
    newest = (slots if cross
              else fill - 1 - torch.remainder(fill - 1 - slots, W))
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
    width against ``golden_lm.json``, and ``examples/serve_lm_torch.py``
    on the port) on ``device``; returns the kernel line's rows for
    ``flash_attention`` and ``paged_attention``."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fr
    from repro_torch.kernels.hcrac import ops as hops
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention import ref as pr
    from repro_torch.kernels.sim_step import ops as sops
    from repro_torch.models import lm, zoo
    dev = torch.device(device)

    phase("9: flash-attention kernel vs plain version (on the card)")
    flash = phase_flash(fk, fr, dev)
    phase("10: decode-attention kernel vs plain version (on the "
          "card)")
    dec = phase_decode(pk, pr, dev)

    # --- phase 11: tinyllama-1.1b at full width against repro -----------
    phase("11: tinyllama-1.1b at full width vs golden_lm.json")
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
    # the flash kernels: the f32 entry's name and the bf16 forward's
    names = (("flash_attention", "flash_fwd_wgmma_kernel"),
             "paged_attention")
    p_wall, p_busy, p_k = profile_kernels(prefill, names)
    run_cache = {k: v.clone() for k, v in cache0.items()}
    d_wall, d_busy, d_k = profile_kernels(decode_all, names)
    share = lambda part, whole: (f"{100 * part / whole:.1f} %"
                                 if part is not None and whole
                                 else "not measured")
    print(f"  prefill {prefill_ms:.2f} ms; decode {decode_ms:.3f} ms a "
          f"step (CUDA events)", flush=True)
    print(f"  profiled prefill: {p_wall:.2f} ms wall, device busy "
          f"{p_busy} ms, flash kernel {p_k['flash_attention']:.3f} ms "
          f"({share(p_k['flash_attention'], p_busy)} of the busy time)",
          flush=True)
    print(f"  profiled {L['steps']} decode steps: {d_wall:.2f} ms wall, "
          f"device busy {d_busy} ms, decode kernel {d_k[names[1]]:.3f} ms "
          f"({share(d_k[names[1]], d_busy)} of the busy time, "
          f"{share(d_busy, d_wall)} of the wall busy)", flush=True)

    # --- phase 12: examples/serve_lm_torch.py at full width -------------
    phase("12: examples/serve_lm_torch.py (tinyllama-1.1b, "
          "full width)")
    n_new, batch = 8, 4
    serve_lm = load_example("serve_lm_torch")
    fa.launches = pa.launches = hops.launches = sops.launches = 0
    pk.launch_counts(reset=True)
    ex = serve_lm.main(["--requests", "12", "--new", str(n_new), "--batch",
                        str(batch)], cfg=cfg, model=model)
    outs, sched, cc = ex["tokens"], ex["sched"], ex["chargecache"]
    check(bool(((outs >= 0) & (outs < cfg.vocab_size)).all()),
          "decoded tokens out of range")
    print(f"  decoded {n_new} tokens x batch {batch} in {ex['seconds']:.3f} "
          f"s ({ex['tok_s']:.1f} tok/s): {outs.T.tolist()}", flush=True)
    launches = {"flash": fa.launches, "decode": pa.launches,
                "probe": hops.launches, "sim_step": sops.launches}
    k_serve = pk.launch_counts(reset=True)
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
                    "prefill_kernel_ms": p_k['flash_attention'],
                    "census": flash["census"]})
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

    phase("13: ssm_scan kernel vs plain version (on the card)")
    scan = phase_scan(sk, sr, dev)

    # --- phase 14: falcon-mamba-7b at full width against repro ----------
    phase("14: falcon-mamba-7b at full width vs golden_lm_ssm.json")
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
    phase(f"15: falcon-mamba-7b serving path: prefill_fn B "
          f"{S['batch']} x {S['prompt']}, then {S['steps']} make_serve_step "
          f"steps")
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
# phases 19-23: the rest of the model zoo (hybrid, MoE, enc-dec, dense gaps)
# --------------------------------------------------------------------------

#: phase 19's flash shapes (B, S, Skv, H, K, hd, causal, window), each
#: the zoo's serving path gives the kernel: at hd 256 recurrentgemma-2b's
#: golden prefill (B 1 x S 2 100, H 10 over K 1, window 2 048), phase
#: 20's serving prefill (B 4 x 2 048), a short prompt and a bidirectional
#: case; whisper-small's encoder (1 500 frames, no mask), decoder (64
#: tokens, causal) and cross-attention (64 queries over the 1 500 frames,
#: no mask: S != Skv, the last 64-key tile holds 28 keys); mixtral-8x22b's
#: (H 48 over K 8, hd 128, window 4 096) and phi3.5-moe's (H 32 over K
#: 8) 300-token prefills.  bf16, and f32 too where S <= 256; the bf16
#: calls timed
FLASH_ZOO = [(1, 2100, 2100, 10, 1, 256, True, 2048),
             (4, 2048, 2048, 10, 1, 256, True, 2048),
             (1, 16, 16, 10, 1, 256, True, 2048),
             (2, 100, 100, 4, 4, 256, False, 0),
             (2, 1500, 1500, 12, 12, 64, False, 0),
             (2, 64, 64, 12, 12, 64, True, 0),
             (2, 64, 1500, 12, 12, 64, False, 0),
             (2, 300, 300, 48, 8, 128, True, 4096),
             (1, 300, 300, 32, 8, 128, True, 0)]
#: phase 19's decode shapes (B, H, K, hd, W, window, filled, cross): at
#: hd 256 phase 20's first serving step (2 048 slots, the query at 2 048)
#: and the golden run's last step (the ring wrapped); whisper-small's
#: self-attention at its golden run's last step (80 slots, 72 filled) and
#: its cross-attention (``cross``: slot p holds frame p, all 1 500 valid,
#: the query at position 1 500, as ``encdec.decode_step`` asks);
#: mixtral-8x22b's last golden step (308 slots, G 6, hd 128, window
#: 4 096).  Each split as ``plan_split`` cuts it and in one chunk, the
#: first timed
DECODE_ZOO = [(4, 10, 1, 256, 2048, 2048, 2049, False),
              (1, 10, 1, 256, 2048, 2048, 2116, False),
              (2, 12, 12, 64, 80, 0, 72, False),
              (2, 12, 12, 64, 1500, 0, 1501, True),
              (2, 48, 8, 128, 308, 4096, 308, False)]
#: phase 19's rglru_scan shapes (B, S, d): B 2 x 2 048,
#: phase 20's serving prefill and one decode step
SCAN_RG = [(2, 2048, 2560), (4, 2048, 2560), (4, 1, 2560)]
#: phase 19's sweep of every bf16 gate input (B, S, d): 65 536 elements
RG_EVERY = (2, 1024, 32)
#: a golden zoo run's logits against ``golden_lm_zoo.json`` (or a run on
#: the plain kernels, recurrentgemma-2b's full depth included), in bf16
#: ulps at the magnitude of the record's largest top logit: four, as
#: ``LM_LOGIT_TOL`` is at tinyllama's 4-8
ZOO_ULPS = 4
#: phase 20's serving shape: prefill B 4 x 2 048, then one decode step
RG_SERVE = {"batch": 4, "prompt": 2048, "steps": 1}
#: the full-depth runs on the plain kernels: B 2 x 300 tokens, 8 steps
ZOO_FULL = {"batch": 2, "prompt": 300, "steps": 8, "seed": 30, "top_k": 8}
#: mixtral-8x22b cut to 2 layers (5.2 G parameters), against the same
#: model on the plain kernels on the card (no repro record: see
#: golden.LM_ZOO)
MIXTRAL_CUT = {"config": "mixtral-8x22b", "cut_layers": 2, "batch": 2,
               "prompt": 300, "max_len": 308, "steps": 8, "seed": 31,
               "top_k": 8}
#: phase 23's full-depth serving shapes
DENSE_SERVE = {"pixtral-12b": {"batch": 2, "prompt": 300, "patches": 256,
                               "steps": 8, "seed": 32},
               "phi3-medium-14b": {"batch": 4, "prompt": 500, "steps": 8,
                                   "seed": 33}}


def ulp_tol(top: float, ulps: int) -> float:
    """``ulps`` bf16 ulps at magnitude ``top``."""
    import math
    return ulps * 2.0 ** (math.floor(math.log2(max(abs(top), 2.0 ** -126)))
                          - 7)


def rglru_case(B, S, d, seed: int, dev, every: bool = False):
    """The rglru_scan kernel's inputs ``(r_pre, i_pre, u, nsp, h0)`` on
    ``dev``, from a seeded generator: ``r_pre``, ``i_pre`` ~ 2 N(0, 1) and
    ``u`` ~ N(0, 1) in bf16, channel 1 of ``r_pre`` at -120 (``r = 0``:
    ``a = 1``, ``1 - a a`` clamped) and channel 2 of ``i_pre`` at 110 (``i
    = 1``), ``nsp = -8 softplus(lam)`` for ``lam`` ~ U(-1, 2), ``h0`` ~ N(0,
    1).  ``every``: ``r_pre`` runs through every bf16 bit pattern (NaNs
    as 0) and ``i_pre`` through the same values shuffled, so that every
    value the sigmoids' reciprocal can meet comes up; ``B S d`` = 65 536."""
    import torch
    from repro_torch.models.ssm import _softplus
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    draw = lambda scale: (torch.randn((B, S, d), generator=g, device=dev)
                          * scale).to(torch.bfloat16)
    r_pre, i_pre, u = draw(2.0), draw(2.0), draw(1.0)
    if every:
        bits = torch.arange(-2**15, 2**15, dtype=torch.int32, device=dev)
        nan = ((bits & 0x7F80) == 0x7F80) & ((bits & 0x7F) != 0)
        vals = torch.where(nan, 0, bits).to(torch.int16).view(torch.bfloat16)
        r_pre = vals.reshape(B, S, d).clone()
        i_pre = vals[torch.randperm(vals.numel(), generator=g,
                                    device=dev)].reshape(B, S, d)
    else:
        r_pre[..., 1] = -120.0
        i_pre[..., 2] = 110.0
    lam = torch.rand((d,), generator=g, device=dev) * 3.0 - 1.0
    return (r_pre, i_pre, u, -8.0 * _softplus(lam),
            torch.randn((B, d), generator=g, device=dev))


def plain_kernels():
    """A context in which the three model kernels' launchers run their
    plain versions on the card (the wrappers' counters still count):
    the reference a run without a ``repro`` record is held to."""
    import contextlib

    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.kernels.paged_attention import kernel as pk, ref as pr
    from repro_torch.kernels.rglru_scan import kernel as rk, ref as rr

    def decode_plain(q, kc, vc, kv_pos, q_pos, *, window):
        B, W = q.shape[0], kc.shape[1]
        return pr.decode_ref(q, kc, vc, kv_pos.expand(B, W),
                             q_pos.expand(B), window=window)

    @contextlib.contextmanager
    def ctx():
        saved = (fk.flash_attention, pk.decode_attention, rk.rglru_scan)
        fk.flash_attention = fr.flash_attention_ref
        pk.decode_attention = decode_plain
        rk.rglru_scan = rr.rglru_gated_scan_ref
        try:
            yield
        finally:
            fk.flash_attention, pk.decode_attention, rk.rglru_scan = saved
    return ctx()


def route_hook():
    """A context recording every MoE layer call's ``(eidx, router
    logits)`` (``layers.moe_route``'s, on the host) into the list it
    yields."""
    import contextlib

    from repro_torch.models import layers

    @contextlib.contextmanager
    def ctx():
        calls, orig = [], layers.moe_route

        def hooked(p, x, cfg):
            out = orig(p, x, cfg)
            logits = (x @ p["router"].to(x.dtype)).float()
            calls.append((out[2].cpu(), logits.cpu()))
            return out
        layers.moe_route = hooked
        try:
            yield calls
        finally:
            layers.moe_route = orig
    return ctx()


def run_steps(zoo, model, cfg, batch, dec, max_len: int, steps: int):
    """``prefill_fn`` then ``steps`` teacher-forced ``decode_fn`` steps;
    the logits of each."""
    import torch
    logits, cache = zoo.prefill_fn(model, batch, cfg, max_len)
    out = [logits]
    for t in range(steps):
        logits, cache = zoo.decode_fn(model, cache, dec[t], cfg)
        out.append(logits)
    torch.cuda.synchronize()
    return out


def hold_logits(label, steps_out, records, tol, vocab, skip_rows=None):
    """Each step's logits against its record (``check_logits``), rows in
    ``skip_rows[step]`` left out; returns ``(max |diff|, rows whose
    argmax was checked)``."""
    import torch
    worst, sure = 0.0, 0
    for t, (x, rec) in enumerate(zip(steps_out, records)):
        check(x.shape[1] == vocab and bool(torch.isfinite(x.float()).all()),
              f"{label} step {t}: malformed logits")
        keep = [r for r in range(x.shape[0])
                if not skip_rows or r not in skip_rows.get(t, ())]
        if not keep:
            continue
        sub = {k: [v[r] for r in keep] for k, v in rec.items()
               if isinstance(v, list)}
        d, n, _ = check_logits(t, x[keep], sub, tol, label)
        worst, sure = max(worst, d), sure + n
    return worst, sure


def plain_records(steps_out, k: int) -> list:
    """``golden.logits_record`` of a run's steps (a reference run)."""
    import torch
    return [{"top_ids": None, **{key: v for key, v in (
        ("top_logits", torch.topk(x.float().cpu(), k, -1).values.tolist()),
        ("logsumexp", torch.logsumexp(x.float().cpu(), -1).tolist()),
        ("argmax", torch.argmax(x.float().cpu(), -1).tolist()))}}
        for x in steps_out]


def zoo_golden_model(golden_mod, lm, zoo, cfg, spec, dev, rec=None):
    """The golden model of ``spec`` (cut as it says) and its inputs on the
    card, their digests held to ``rec`` where there is one."""
    import torch
    c = golden_mod.zoo_config(cfg, spec)
    tree = golden_mod.golden_weights(zoo.model_defs(c), spec["seed"], dev)
    batch, dec = golden_mod.zoo_inputs(c, spec, dev)
    if rec is not None:
        check(golden_mod.weights_digest(tree) == rec["weights_digest"],
              f"{c.name}: the golden weights built on the card differ from "
              f"repro's")
        check(golden_mod.inputs_digest(batch, dec) == rec["inputs_digest"],
              f"{c.name}: the golden inputs built on the card differ from "
              f"repro's")
    torch.cuda.synchronize()
    return lm.LM(c, tree), c, batch, dec


def kernel_counts(fa, pa, ro, pk) -> dict:
    return {"flash": fa.launches, "decode": pa.launches, "rglru": ro.launches,
            "decode_kernels": pk.launch_counts()}


def zero_counts(fa, pa, ro, pk) -> None:
    fa.launches = pa.launches = ro.launches = 0
    pk.launch_counts(reset=True)


def routing_flips(calls, rec_routing, golden_mod):
    """Compare a run's MoE routing (``route_hook``) with a record (a list
    per step of per-call ``routing_record``s): ``(tokens differing,
    tokens differing that are not near a tie of the record's logits,
    {step: batch rows whose last token's choice differs}, the largest
    distance of the run's router logits from the record's in bf16 ulps
    (``golden.route_logit_ulps``), tokens whose choice is not the
    first-index top-k of the run's own logits)``.  With the last 0 and
    the logits within ``ROUTE_LOGIT_ULPS``, every differing choice is the
    logits' rounding."""
    import torch
    from repro_torch.models import layers
    flips = off_tie = not_top = 0
    worst = 0.0
    rows = {}
    it = iter(calls)
    for t, step in enumerate(rec_routing):
        for r in step:
            eidx, logits = next(it)
            want = torch.tensor(r["eidx"], dtype=torch.int32)
            got = eidx.to(torch.int32).reshape(want.shape)
            ref_logits = torch.tensor(r["logits"])
            logits = logits.reshape(ref_logits.shape)
            worst = max(worst, float(golden_mod.route_logit_ulps(
                logits, ref_logits).max()))
            _, own = layers.top_k_first(torch.softmax(logits, -1),
                                        want.shape[-1])
            not_top += int((own.to(torch.int32) != got).any(-1).sum())
            diff = (got != want).any(-1).reshape(-1)
            near = golden_mod.route_near_ties(ref_logits,
                                              want.shape[-1]).reshape(-1)
            flips += int(diff.sum())
            off_tie += int((diff & ~near).sum())
            last = (got[:, -1] != want[:, -1]).any(-1)
            rows.setdefault(t, set()).update(
                torch.nonzero(last).reshape(-1).tolist())
    return flips, off_tie, rows, worst, not_top


def record_routing(calls, steps: int, n_layers: int, k: int, golden_mod):
    """A run's routing (``route_hook``) as ``routing_record``s per step."""
    out, it = [], iter(calls)
    for _ in range(steps + 1):
        out.append([golden_mod.routing_record(*next(it), k)
                    for _ in range(n_layers)])
    return out


def phase_zoo_kernels(fk, fr, pk, pr, rk, rr, dev) -> dict:
    """Phase 19: the two attention kernels at the zoo's shapes (hd 256,
    whisper's, the MoE configs') and the rglru_scan kernel against their
    plain versions on the card; times beside the plain versions, SDPA and
    the bounds; registers and spills."""
    import torch
    import torch.nn.functional as F
    out = {"flash": [], "decode": [], "scan": [], "max_abs_err": {}}
    for i, case in enumerate(FLASH_ZOO):
        B, S, Skv, H, K, hd, causal, window = case
        for dn, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            if dn == "f32" and S > 256:
                continue
            q, k, v = (seeded(sh, 300 + 10 * i + j, dt, dev) for j, sh in
                       enumerate(((B, S, H, hd), (B, Skv, K, hd),
                                  (B, Skv, K, hd))))
            got = fk.flash_attention(q, k, v, causal=causal, window=window)
            plain_ms, want = cuda_ms(lambda: fr.flash_attention_ref(
                q, k, v, causal=causal, window=window),
                torch.cuda.synchronize)
            err, top, share = kernel_diff(got, want, dn)
            out["max_abs_err"]["flash"] = max(
                out["max_abs_err"].get("flash", 0.0), err)
            line = (f"  flash B{B} S{S} Skv{Skv} H{H} K{K} hd{hd} "
                    f"causal={causal} window={window} {dn}: max |kernel - "
                    f"plain| {err:.3g} (tolerance {FLASH_TOL[dn]}), max "
                    f"|plain| {top:.3g}, worst share of the element-wise "
                    f"limit {share:.3g}")
            check(err <= FLASH_TOL[dn] and share <= 1.0,
                  f"flash kernel disagrees with its plain version at {case} "
                  f"{dn}")
            if dn == "bf16":
                mask = None
                if causal or window:
                    qi = torch.arange(S, device=dev)[:, None]
                    ki = torch.arange(Skv, device=dev)[None, :]
                    mask = torch.ones(S, Skv, dtype=torch.bool, device=dev)
                    if causal:
                        mask &= qi >= ki
                    if window:
                        mask &= (qi - ki) < window
                run = lambda: fk.flash_attention(q, k, v, causal=causal,
                                                 window=window)
                sdpa = lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)
                dev_ms, lib_dev_ms = graph_ms(run), graph_ms(sdpa)
                bound, by = flash_bound(B, S, H, K, hd, causal, window, dn,
                                        Skv)
                out["flash"].append({
                    "shape": [B, S, Skv, H, K, hd], "causal": causal,
                    "window": window, "device_ms": dev_ms,
                    "plain_ms": plain_ms, "library_device_ms": lib_dev_ms,
                    "bound_ms": bound, "bound_by": by,
                    "bound_share": bound / dev_ms, "max_abs_err": err})
                line += (f"; kernel {dev_ms:.4f} ms device "
                         f"({100 * bound / dev_ms:.1f} % of its {by} bound "
                         f"{bound:.4f} ms), plain {plain_ms:.3f} ms, SDPA "
                         f"{lib_dev_ms:.4f} ms device")
            print(line, flush=True)
            del q, k, v, got, want
    orig_plan = pk.plan_split
    for i, case in enumerate(DECODE_ZOO):
        B, H, K, hd, W, window, fill, cross = case
        q, kc, vc, kv_pos, q_pos = decode_case(case[:7], 400 + 10 * i, dev,
                                               cross)
        plain_ms, want = cuda_ms(lambda: pr.decode_ref(
            q, kc, vc, kv_pos.expand(B, W), q_pos.expand(B), window=window),
            torch.cuda.synchronize)
        ok = (kv_pos >= 0) & (kv_pos <= q_pos)
        if window:
            ok &= (q_pos - kv_pos) < window
        valid = int(ok.sum())
        for split in ("planned", "one chunk"):
            if split == "one chunk":
                pk.plan_split = lambda W, blocks, sms: (1, -(-W // 64) * 64)
            try:
                pk.launch_counts(reset=True)
                run = lambda: pk.decode_attention(q, kc, vc, kv_pos, q_pos,
                                                  window=window)
                got = run()
                counts = pk.launch_counts(reset=True)
                err, top, share = kernel_diff(got, want, "bf16")
                out["max_abs_err"]["decode"] = max(
                    out["max_abs_err"].get("decode", 0.0), err)
                line = (f"  decode B{B} H{H} K{K} hd{hd} W{W} window={window}"
                        f" query at {fill - 1}, {valid} valid slots, {split} "
                        f"({decode_launches(pk, counts, 1)}): max |kernel - "
                        f"plain| {err:.3g} (tolerance {DECODE_TOL}), max "
                        f"|plain| {top:.3g}, worst share {share:.3g}")
                check(err <= DECODE_TOL and share <= 1.0,
                      f"decode kernel disagrees with its plain version at "
                      f"{case} ({split})")
                if split == "planned":
                    sdpa = lambda: F.scaled_dot_product_attention(
                        q[:, :, None], kc.transpose(1, 2),
                        vc.transpose(1, 2), attn_mask=ok[None, None, None],
                        enable_gqa=True)
                    dev_ms, lib_dev_ms = graph_ms(run), graph_ms(sdpa)
                    bound, by = decode_bound(B, H, K, hd, valid, W, "bf16")
                    out["decode"].append({
                        "shape": [B, H, K, hd, W], "valid": valid,
                        "n_split": counts["mma_chunks"],
                        "device_ms": dev_ms, "plain_ms": plain_ms,
                        "library_device_ms": lib_dev_ms, "bound_ms": bound,
                        "bound_by": by, "bound_share": bound / dev_ms,
                        "max_abs_err": err})
                    line += (f"; kernel {dev_ms:.4f} ms device "
                             f"({100 * bound / dev_ms:.1f} % of its {by} bound "
                             f"{bound:.5f} ms), plain {plain_ms:.3f} ms, SDPA "
                             f"{lib_dev_ms:.4f} ms device")
                print(line, flush=True)
            finally:
                pk.plan_split = orig_plan
    smem = rk.library().rglru_scan_smem_bytes()
    args = rglru_case(*RG_EVERY, 499, dev, every=True)
    hs, hn = rk.rglru_scan(*args)
    ws, wn = rr.rglru_gated_scan_ref(*args)
    bad = int((hs != ws).sum()) + int((hn != wn).sum())
    print(f"  rglru_scan B{RG_EVERY[0]} S{RG_EVERY[1]} d{RG_EVERY[2]}, every "
          f"non-NaN bf16 value as r_pre and as i_pre: {bad} elements of h "
          f"differing from the plain version", flush=True)
    check(bad == 0, "rglru_scan disagrees with its plain version on the "
                    "bf16 sweep")
    out["scan_every_bf16_mismatches"] = bad
    for i, (B, S, d) in enumerate(SCAN_RG):
        args = rglru_case(B, S, d, 500 + i, dev)
        hs, hn = rk.rglru_scan(*args)
        plain_ms, (ws, wn) = cuda_ms(lambda: rr.rglru_gated_scan_ref(*args),
                                     torch.cuda.synchronize)
        bad = int((hs != ws).sum()) + int((hn != wn).sum())
        ms = loop_ms(lambda: rk.rglru_scan(*args))
        n_bytes = rglru_work(B, S, d)[1]
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        out["scan"].append({"shape": [B, S, d], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound,
                            "bound_by": "bytes", "bound_share": bound / ms,
                            "bytes": n_bytes, "mismatches": bad})
        print(f"  rglru_scan B{B} S{S} d{d} (bf16 gate inputs, channels 1 "
              f"and 2 saturated): {bad} elements of h_seq and h_S differing "
              f"from the plain version; kernel {ms:.4f} ms "
              f"({100 * bound / ms:.1f} % of its bytes bound {bound:.4f} ms, "
              f"{n_bytes / 1e6:.1f} MB), plain {plain_ms:.1f} ms", flush=True)
        check(bad == 0, f"rglru_scan disagrees with its plain version at "
                        f"{(B, S, d)}")
        del args, hs, hn, ws, wn
    print(f"  rglru_scan tiles: {smem} B of shared memory a block",
          flush=True)
    out["scan_smem_bytes"] = smem
    regs = {}
    for lib, name in ((fk.library(), "flash"), (pk.library(), "decode"),
                      (rk.library(), "rglru")):
        log = Path(lib._name).with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        regs.update(ptxas_report(
            text, r"(flash_fwd_wgmma_kernelILi256ELi1ELb0E|"
                  r"paged_attention_mma_kernelILi256E|rglru_scan_kernel)"))
    for entry, r in regs.items():
        print(f"  ptxas {entry}: {r['registers']} registers, spill stores "
              f"{r['spill_stores']} B, spill loads {r['spill_loads']} B",
              flush=True)
    out["ptxas"] = regs
    return out


def zoo_phases(golden_mod, smi: str, device="cuda") -> dict:
    """Phases 19-23 on ``device``; returns the kernel line's additions:
    ``flash`` / ``decode`` extras for their rows and the ``rglru_scan``
    row."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fr
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention import ref as pr
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan import ops as ro
    from repro_torch.kernels.rglru_scan import ref as rr
    from repro_torch.models import lm, zoo
    dev = torch.device(device)
    torch.cuda.empty_cache()
    gold = golden_mod.load_lm_zoo()
    share = lambda part, whole: (f"{100 * part / whole:.1f} %"
                                 if part is not None and whole
                                 else "not measured")

    phase("19: flash and decode kernels at the zoo's shapes, "
          "rglru_scan (on the card)")
    kern = phase_zoo_kernels(fk, fr, pk, pr, rk, rr, dev)
    result = {"kernels": kern, "runs": {}}

    def golden_run(name, ulps=ZOO_ULPS):
        """A ``golden_lm_zoo.json`` entry on the card: its logits held to
        the record, its kernels' launches counted."""
        rec = gold[name]
        spec = rec["spec"]
        t0 = time.time()
        model, c, batch, dec = zoo_golden_model(golden_mod, lm, zoo,
                                                get(spec["config"]), spec,
                                                dev, rec)
        tol = ulp_tol(max(abs(x) for s in rec["steps"]
                          for row in s["top_logits"] for x in row), ulps)
        zero_counts(fa, pa, ro, pk)
        with route_hook() as calls:
            steps_out = run_steps(zoo, model, c, batch, dec,
                                  spec["max_len"], spec["steps"])
        counts = kernel_counts(fa, pa, ro, pk)
        skip, routing = None, {}
        if "routing" in rec:
            flips, off_tie, skip, lg_ulps, not_top = routing_flips(
                calls, rec["routing"], golden_mod)
            n_tok = sum(len(r["near_ties"]) for st in rec["routing"]
                        for r in st)
            routing = {"flips": flips, "off_tie": off_tie,
                       "router_logit_ulps": lg_ulps, "not_top_k": not_top,
                       "near_ties": n_tok,
                       "rows_skipped": {t: sorted(r) for t, r in
                                        skip.items() if r}}
            print(f"  {name}: router logits vs repro's: at most {lg_ulps:g} "
                  f"bf16 ulps at the token's top logit (limit "
                  f"{golden_mod.ROUTE_LOGIT_ULPS}); {not_top} tokens' choice "
                  f"not the top-k of their logits; routing: {flips} tokens "
                  f"chose other experts, {off_tie} of them not near a tie "
                  f"({n_tok} near ties in the record at "
                  f"{golden_mod.ROUTE_NEAR_TIE_ULPS} ulps)", flush=True)
            check(lg_ulps <= golden_mod.ROUTE_LOGIT_ULPS and not_top == 0,
                  f"{name}: router logits differ from repro's by more than "
                  f"{golden_mod.ROUTE_LOGIT_ULPS} bf16 ulps, or the choice "
                  f"is not their top-k")
            check(off_tie == 0, f"{name}: routing differs from repro's "
                                f"beyond a near tie")
        worst, sure = hold_logits(name, steps_out, rec["steps"], tol,
                                  c.vocab_padded, skip)
        wall = time.time() - t0
        print(f"  {name} ({c.n_layers} layers, B{spec['batch']} x "
              f"{spec['prompt']}{' + ' + str(spec.get('patches')) + ' patches' if spec.get('patches') else ''}"
              f", {spec['steps']} steps): max |d| top-{spec['top_k']} logits "
              f"/ logsumexp vs repro {worst:.4f} (tolerance {tol:.4f}, "
              f"{ulps} bf16 ulps at the top logits), argmax equal on {sure} "
              f"rows; launches {counts}; {wall:.1f} s", flush=True)
        result["runs"][name] = {"max_diff": worst, "tol": tol,
                                "launches": counts, **routing}
        return model, c, counts

    def plain_run(label, model, c, batch, dec, max_len, steps, ulps,
                  moe=False):
        """``model`` on its kernels against itself on the plain versions
        (both on the card)."""
        zero_counts(fa, pa, ro, pk)
        with route_hook() as calls:
            steps_out = run_steps(zoo, model, c, batch, dec, max_len, steps)
        counts = kernel_counts(fa, pa, ro, pk)
        with plain_kernels(), route_hook() as ref_calls:
            ref_out = run_steps(zoo, model, c, batch, dec, max_len, steps)
        recs = plain_records(ref_out, 8)
        tol = ulp_tol(max(abs(x) for s in recs for row in s["top_logits"]
                          for x in row), ulps)
        skip, extra = None, {}
        if moe:
            ref_routing = record_routing(ref_calls, steps, c.n_layers,
                                         c.top_k, golden_mod)
            flips, off_tie, skip, lg_ulps, not_top = routing_flips(
                calls, ref_routing, golden_mod)
            extra = {"flips": flips, "off_tie": off_tie,
                     "router_logit_ulps": lg_ulps, "not_top_k": not_top}
            print(f"  {label}: router logits vs the plain run's: at most "
                  f"{lg_ulps:g} bf16 ulps (limit "
                  f"{golden_mod.ROUTE_LOGIT_ULPS}); {not_top} tokens' choice "
                  f"not the top-k of their logits; routing: {flips} tokens "
                  f"chose other experts, {off_tie} of them not near a tie",
                  flush=True)
            check(lg_ulps <= golden_mod.ROUTE_LOGIT_ULPS and not_top == 0,
                  f"{label}: router logits differ from the plain run's by "
                  f"more than {golden_mod.ROUTE_LOGIT_ULPS} bf16 ulps, or "
                  f"the choice is not their top-k")
            check(off_tie == 0, f"{label}: routing differs from the plain "
                                f"run beyond a near tie")
        worst, sure = hold_logits(label, steps_out, recs, tol,
                                  c.vocab_padded, skip)
        print(f"  {label}: kernels vs plain versions on the card: max |d| "
              f"top-8 logits / logsumexp {worst:.4f} (tolerance {tol:.4f}, "
              f"{ulps} bf16 ulps), argmax equal on {sure} rows; launches "
              f"{counts}", flush=True)
        result["runs"][label] = {"max_diff": worst, "tol": tol,
                                 "launches": counts, **extra}
        return counts

    def serve_timed(label, model, c, batch, max_len, steps):
        """Prefill and ``steps`` greedy decode steps timed (CUDA events),
        the three kernels' device time by ``torch.profiler``, the launches
        of this run (the main path of the phase)."""
        prefill = lambda: zoo.prefill_fn(model, batch, c, max_len)
        logits, cache = prefill()            # warm-up at these shapes
        del cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fa, pa, ro, pk)
        start, mid, end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
        start.record()
        logits, cache = prefill()
        mid.record()
        tok = torch.argmax(logits, -1)
        for _ in range(steps):
            logits, cache = zoo.decode_fn(model, cache, tok, c)
            tok = torch.argmax(logits, -1)
        end.record()
        end.synchronize()
        counts = kernel_counts(fa, pa, ro, pk)
        prefill_ms = start.elapsed_time(mid)
        decode_ms = mid.elapsed_time(end) / steps
        names = (("flash_attention", "flash_fwd_wgmma_kernel"),
                 "paged_attention", "rglru_scan",
                 ("gemm", "nvjet", "cutlass", "xmma"), "double",
                 "elementwise")
        kernel_keys = ("flash_attention", "paged_attention", "rglru_scan")
        p_wall, p_busy, p_k = profile_kernels(prefill, names)
        cache0 = cache

        def one_step():
            zoo.decode_fn(model, {k: (v.clone() if torch.is_tensor(v) else
                                      {kk: vv.clone() for kk, vv in v.items()})
                                  for k, v in cache0.items()}, tok, c)
        d_wall, d_busy, d_k = profile_kernels(one_step, names)
        print(f"  {label}: prefill B{batch['tokens'].shape[0]} x "
              f"{batch['tokens'].shape[1]} {prefill_ms:.2f} ms, decode "
              f"{decode_ms:.3f} ms a step (CUDA events); peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
              f"launches {counts}", flush=True)
        print(f"    profiled prefill: {p_wall:.2f} ms wall, device busy "
              f"{p_busy} ms; flash {p_k['flash_attention']:.3f} ms "
              f"({share(p_k['flash_attention'], p_busy)}), rglru_scan "
              f"{p_k['rglru_scan']:.3f} ms ({share(p_k['rglru_scan'], p_busy)}),"
              f" GEMMs {p_k['gemm']:.2f} ms ({share(p_k['gemm'], p_busy)}), "
              f"f64 kernels {p_k['double']:.2f} ms", flush=True)
        check(not p_k["double"], f"{label}: the prefill ran f64 kernels "
                                 f"(the plain versions' arithmetic)")
        print(f"    profiled prefill: element-wise kernels "
              f"{p_k['elementwise']:.2f} ms ({share(p_k['elementwise'], p_busy)}"
              f" of busy), {p_k['n_kernels']} kernel launches", flush=True)
        print(f"    profiled decode step (cache copy included): "
              f"{d_wall:.2f} ms wall, device busy {d_busy} ms "
              f"({share(d_busy, d_wall)} of the wall); decode kernel "
              f"{d_k['paged_attention']:.3f} ms, rglru_scan "
              f"{d_k['rglru_scan']:.3f} ms, GEMMs {d_k['gemm']:.2f} ms; "
              f"{d_k['n_kernels']} kernel launches (the cache copy's "
              f"memcpys left out)", flush=True)
        row = {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
               "prefill_device_ms": p_busy, "decode_device_ms": d_busy,
               "prefill_kernel_ms": {k: p_k[k] for k in kernel_keys},
               "decode_kernel_ms": {k: d_k[k] for k in kernel_keys},
               "prefill_gemm_ms": p_k["gemm"], "decode_gemm_ms": d_k["gemm"],
               "prefill_f64_ms": p_k["double"],
               "prefill_elementwise_ms": p_k["elementwise"],
               "prefill_kernel_launches": p_k["n_kernels"],
               "decode_kernel_launches": d_k["n_kernels"],
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": counts}
        result["runs"][label + " serving"] = row
        del cache, cache0
        return row

    def full_batch(c, spec, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        batch = {"tokens": torch.randint(0, c.vocab_size, (spec["batch"],
                                                           spec["prompt"]),
                                         generator=g, device=dev)}
        if spec.get("patches"):
            batch["prefix_embeds"] = torch.randn(
                (spec["batch"], spec["patches"], c.d_model), generator=g,
                device=dev).to(torch.bfloat16)
        dec = torch.randint(0, c.vocab_size, (spec["steps"], spec["batch"]),
                            generator=g, device=dev)
        return batch, dec

    # --- phase 20: recurrentgemma-2b -------------------------------------
    phase("20: recurrentgemma-2b at published widths")
    model, c, counts = golden_run("recurrentgemma-2b")
    n_attn = lm.layer_types(c).count("attn")
    n_rec = c.n_layers - n_attn
    steps = gold["recurrentgemma-2b"]["spec"]["steps"]
    check(counts["flash"] == n_attn and counts["decode"] == n_attn * steps
          and counts["rglru"] == n_rec * (1 + steps),
          f"recurrentgemma golden run launches {counts}")
    del model
    cfg = get("recurrentgemma-2b")
    t0 = time.time()
    tree = golden_mod.golden_weights(zoo.model_defs(cfg), 23, dev)
    model = lm.LM(cfg, tree)
    del tree
    batch, dec = full_batch(cfg, ZOO_FULL, ZOO_FULL["seed"])
    max_len = ZOO_FULL["prompt"] + ZOO_FULL["steps"]
    counts = plain_run(f"recurrentgemma-2b full depth ({cfg.n_layers} "
                       f"layers)", model, cfg, batch, dec, max_len,
                       ZOO_FULL["steps"], ZOO_ULPS)
    print(f"  full depth: {time.time() - t0:.1f} s", flush=True)
    g = torch.Generator(device=dev)
    g.manual_seed(20)
    tokens = torch.randint(0, cfg.vocab_size, (RG_SERVE["batch"],
                                               RG_SERVE["prompt"]),
                           generator=g, device=dev)
    rg_serve = serve_timed("recurrentgemma-2b", model, cfg,
                           {"tokens": tokens},
                           RG_SERVE["prompt"] + RG_SERVE["steps"],
                           RG_SERVE["steps"])
    n_attn = lm.layer_types(cfg).count("attn")
    n_rec = cfg.n_layers - n_attn
    check(rg_serve["launches"]["flash"] == n_attn
          and rg_serve["launches"]["decode"] == n_attn * RG_SERVE["steps"]
          and rg_serve["launches"]["rglru"] == n_rec * (1 + RG_SERVE["steps"]),
          f"recurrentgemma serving launches {rg_serve['launches']}")
    del model
    torch.cuda.empty_cache()

    # --- phase 21: the MoE family ----------------------------------------
    phase("21: the MoE family at published widths")
    model, c, counts = golden_run("phi3.5-moe-42b-a6.6b")
    spec = gold["phi3.5-moe-42b-a6.6b"]["spec"]
    check(counts["flash"] == c.n_layers
          and counts["decode"] == c.n_layers * spec["steps"],
          f"phi3.5-moe launches {counts}")
    moe_serve = serve_timed(f"phi3.5-moe-42b-a6.6b ({c.n_layers} layers)",
                            model, c,
                            golden_mod.zoo_inputs(c, spec, dev)[0],
                            spec["max_len"], spec["steps"])
    del model
    torch.cuda.empty_cache()
    t0 = time.time()
    model, c, batch, dec = zoo_golden_model(golden_mod, lm, zoo,
                                            get(MIXTRAL_CUT["config"]),
                                            MIXTRAL_CUT, dev)
    plain_run(f"mixtral-8x22b (first {c.n_layers} layers)", model, c, batch,
              dec, MIXTRAL_CUT["max_len"], MIXTRAL_CUT["steps"], ZOO_ULPS,
              moe=True)
    serve_timed(f"mixtral-8x22b (first {c.n_layers} layers)", model, c,
                batch, MIXTRAL_CUT["max_len"], MIXTRAL_CUT["steps"])
    print(f"  mixtral: {time.time() - t0:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()

    # --- phase 22: whisper-small -----------------------------------------
    phase("22: whisper-small at full depth")
    model, c, counts = golden_run("whisper-small")
    spec = gold["whisper-small"]["spec"]
    check(counts["flash"] == c.n_enc_layers + 2 * c.n_layers
          and counts["decode"] == 2 * c.n_layers * spec["steps"],
          f"whisper launches {counts}")
    wh_serve = serve_timed("whisper-small", model, c,
                           golden_mod.zoo_inputs(c, spec, dev)[0],
                           spec["max_len"], spec["steps"])
    del model

    # --- phase 23: the dense gaps ----------------------------------------
    phase("23: granite-34b, pixtral-12b and phi3-medium-14b")
    for name in ("granite-34b", "pixtral-12b", "phi3-medium-14b"):
        model, c, counts = golden_run(name)
        spec = gold[name]["spec"]
        check(counts["flash"] == c.n_layers
              and counts["decode"] == c.n_layers * spec["steps"],
              f"{name} launches {counts}")
        del model
        torch.cuda.empty_cache()
    dense_serve = {}
    for name, spec in DENSE_SERVE.items():
        cfg = get(name)
        t0 = time.time()
        tree = golden_mod.golden_weights(zoo.model_defs(cfg), spec["seed"],
                                         dev)
        model = lm.LM(cfg, tree)
        del tree
        batch, _ = full_batch(cfg, spec, spec["seed"])
        P = spec.get("patches", 0)
        dense_serve[name] = serve_timed(
            f"{name} full depth ({cfg.n_layers} layers, "
            f"{sum(p.numel() for p in model.parameters()) / 1e9:.1f} G "
            f"parameters)", model, cfg, batch, P + spec["prompt"]
            + spec["steps"], spec["steps"])
        check(dense_serve[name]["launches"]["flash"] == cfg.n_layers,
              f"{name} serving launches {dense_serve[name]['launches']}")
        print(f"  {name}: {time.time() - t0:.1f} s with its weights",
              flush=True)
        del model
        torch.cuda.empty_cache()
    print(f"  card: {smi}", flush=True)
    scan = kern["scan"][0]
    result["rglru_row"] = {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "none: src/repro/models/rglru.py:38 (_gates) and :76 "
                    "(the scan) are XLA ops",
        "launches": rg_serve["launches"]["rglru"],
        "max_abs_err": 0.0 if all(x["mismatches"] == 0
                                  for x in kern["scan"]) else None,
        "ms": scan["ms"], "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": scan["shape"],
        "full": kern["scan"][1:], "ptxas": kern["ptxas"].get(
            "rglru_scan_kernel"), "smem_bytes": kern["scan_smem_bytes"],
        "prefill_kernel_ms": rg_serve["prefill_kernel_ms"]["rglru_scan"],
        "serving": rg_serve}
    result["serving"] = {"recurrentgemma-2b": rg_serve,
                         "phi3.5-moe-42b-a6.6b": moe_serve,
                         "whisper-small": wh_serve, **dense_serve}
    return result


# --------------------------------------------------------------------------
# phase 24: training on the card (tinyllama-1.1b, whisper-small, the 100m
# example) and the flash kernel's backward entries
# --------------------------------------------------------------------------

#: phase 24 (a)'s backward shapes (B, S, Skv, H, K, hd, causal, window):
#: tinyllama-1.1b's train step at S 2 048, phi4-mini's widths, a sliding
#: window, whisper-small's encoder and its cross-attention (64 queries over
#: 1 500 frames, no mask), the 15m preset's hd 32 microbatch, and
#: recurrentgemma-2b's attention (hd 256, H 10 over K 1, window 2 048) at
#: B 1 x 2 100 and B 2 x 2 048
FLASH_BWD = [(2, 2048, 2048, 32, 4, 64, True, 0),
             (1, 2048, 2048, 24, 8, 128, True, 0),
             (2, 1024, 1024, 8, 2, 64, True, 256),
             (2, 1500, 1500, 12, 12, 64, False, 0),
             (2, 64, 1500, 12, 12, 64, False, 0),
             (4, 256, 256, 8, 4, 32, True, 0),
             (1, 2100, 2100, 10, 1, 256, True, 2048),
             (2, 2048, 2048, 10, 1, 256, True, 2048)]
#: ptxas registers of the wgmma entries at HDP 64 / 128 as they were built
#: before the HDP 256 instantiations (NVIDIA H100 80GB HBM3, nvcc 12.8):
#: their code paths are unchanged, so they stay within BWD_PTXAS_SLACK
BWD_PTXAS_BEFORE = {"flash_bwd_dkdv_wgmma_kernel:64": 184,
                    "flash_bwd_dkdv_wgmma_kernel:128": 250,
                    "flash_bwd_dq_wgmma_kernel:64": 139,
                    "flash_bwd_dq_wgmma_kernel:128": 155}
BWD_PTXAS_SLACK = 8
#: the backward entries' gradients against their plain version (autograd
#: of the f32 reference), element by element: |kernel - plain| <=
#: FLASH_BWD_RTOL * |plain| + FLASH_BWD_ATOL * max |plain| (of the
#: tensor).  Written before the first card run.  The kernel rounds each
#: gradient once to bf16 (at most 2^-9 of |plain|: the relative part, with
#: 4x margin), and rounds the second product's operands P, dS (and O,
#: which enters D) to bf16, which moves each term of a sum by at most 2^-9
#: of it: the sum moves by at most 2^-9 of the sum of its terms'
#: magnitudes, which cancellation can make larger than the sum itself but,
#: for these random inputs, not than the tensor's largest gradient (the
#: absolute part, 2x margin)
FLASH_BWD_RTOL, FLASH_BWD_ATOL = 2.0 ** -7, 2.0 ** -8
#: the LSE forward's output plus its low halves against the f32 output of
#: the plain version, max |d| / max |O|: 8x under a bf16 output's own
#: rounding (2^-9 of each element), so that the low halves are shown to
#: carry the f32 output into D (the kernel's P V keeps 2^-16 of p)
FLASH_O32_TOL = 2.0 ** -12
#: the group sum against its plain version on the same partials, element
#: by element: the two f32 sums differ in order only, so their bf16
#: roundings differ by at most one bf16 step, 2^-7 of the element (plus
#: 2^-24 of the largest, for elements near 0)
SUM_RTOL = 2.0 ** -7
#: ptxas registers and spill stores / loads (bytes) of the bf16 forward's
#: serving instantiations flash_fwd_wgmma_kernel<HDP, chunks, false>,
#: keyed "HDP:chunks", as the wgmma design built them (NVIDIA H100 80GB
#: HBM3, nvcc 12.9): the LSE flag's instantiations share their body and
#: must leave them as they were.  No spill at any; at HDP 64 with one
#: chunk at most 128 registers (two blocks an SM)
SERVING_FLASH_PTXAS = {
    "64:1": (121, 0, 0), "64:2": (171, 0, 0), "128:2": (199, 0, 0),
    "192:1": (183, 0, 0), "256:1": (214, 0, 0)}


def bwd_diff(got, want) -> tuple[float, float, float]:
    """``(max |got - want|, max |want|, worst share of the limit)`` under
    ``FLASH_BWD_RTOL`` / ``FLASH_BWD_ATOL``."""
    w = want.float()
    d = (got.float() - w).abs()
    top = float(w.abs().max())
    lim = FLASH_BWD_RTOL * w.abs() + FLASH_BWD_ATOL * top
    return float(d.max()), top, float((d / lim).max())


def flash_ptxas(fk) -> dict:
    """``{entry name: {"registers", "spill_stores", "spill_loads"}}`` of
    the flash library's bf16 wgmma entries, keyed ``<kernel>:<HDP>`` and,
    for the forward, ``:<chunks>`` (the training instantiation of
    ``flash_fwd_wgmma_kernel``, its LSE flag set, as
    ``flash_fwd_wgmma_kernel_lse``)."""
    import re
    log = Path(fk.library()._name).with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    regs = ptxas_report(text, r"((?:flash_fwd|flash_bwd_(?:dkdv|dq))_wgmma"
                              r"_kernelILi\d+E(?:Li\d+E)?(?:Lb[01]E)?)")
    out = {}
    for name, r in regs.items():
        m = re.match(r"(\w+?)ILi(\d+)E(?:Li(\d+)E)?(Lb1E)?", name)
        kern = m.group(1) + ("_lse" if m.group(4) else "")
        chunks = f":{m.group(3)}" if m.group(3) else ""
        out[f"{kern}:{m.group(2)}{chunks}"] = r
    return out


def flash_bwd(fk, q, k, v, o, o_lo, do, lse, causal, window):
    """The backward entries in the order ``FlashAttentionFn`` launches
    them (D, dK / dV, the group sum where a KV head serves several query
    heads, dQ): ``(dq, dk, dv)``."""
    dlt = fk.flash_attention_bwd_dot(o, o_lo, do, lse.shape[-1])
    dk, dv, _ = fk.flash_attention_bwd_dkdv(q, k, v, do, lse, dlt,
                                            causal=causal, window=window)
    dq = fk.flash_attention_bwd_dq(q, k, v, do, lse, dlt, causal=causal,
                                   window=window)
    return dq, dk, dv


def sdpa_mask(S, Skv, causal, window, dev) -> tuple:
    """``(attn_mask, is_causal)`` that give SDPA the attention of ``(causal,
    window)``: a boolean mask only where the window masks a pair that
    causality keeps (``window <= S - 1``); else no mask and
    ``is_causal``, so that SDPA may take its flash backend."""
    import torch
    if window and window < S:
        qp = torch.arange(S, device=dev)[:, None]
        kp = torch.arange(Skv, device=dev)[None, :]
        return (qp >= kp) & ((qp - kp) < window), False
    return None, bool(causal or window)


def sdpa_bwd_ms(q, k, v, do, causal, window, reps: int = 5) -> tuple:
    """SDPA's backward alone (``enable_gqa``; ``sdpa_mask``'s form): one
    forward, then ``reps`` backward passes of it under ``torch.profiler``,
    the device time of the kernels they launch over ``reps``; where the
    profiler sees no device activity, CUDA events around the ``reps``
    passes instead.  Returns ``(ms, 'profiler' | 'events', 'mask' |
    'is_causal' | 'none')``."""
    import torch
    import torch.nn.functional as F
    S, Skv = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    mask, is_causal = sdpa_mask(S, Skv, causal, window, q.device)
    form = "mask" if mask is not None else (
        "is_causal" if is_causal else "none")
    y = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=is_causal, enable_gqa=True)
    dot = do.transpose(1, 2)

    def grads():
        for _ in range(reps):
            torch.autograd.grad(y, (qt, kt, vt), dot, retain_graph=True)
    grads()
    _, busy, _ = profile_kernels(grads, ())
    if busy is not None:
        return busy / reps, "profiler", form
    return loop_ms(grads, 1) / reps, "events", form


def sdpa_bwd_worker() -> None:
    """Prints, as one JSON line, ``sdpa_bwd_ms`` at each of
    ``FLASH_BWD``'s shapes (inputs drawn as phase 24 (a) draws them); run
    in a fresh process by ``sdpa_bwd_times``."""
    import torch
    dev = torch.device("cuda")
    out = []
    for i, (B, S, Skv, H, K, hd, causal, window) in enumerate(FLASH_BWD):
        gen = torch.Generator(device=dev)
        gen.manual_seed(2400 + i)
        draw = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                          dtype=torch.float32).to(
                                              torch.bfloat16)
        q, k, v = draw(B, S, H, hd), draw(B, Skv, K, hd), draw(B, Skv, K, hd)
        out.append(sdpa_bwd_ms(q, k, v, draw(B, S, H, hd), causal, window))
    print(json.dumps(out), flush=True)


def sdpa_bwd_times() -> list:
    """``sdpa_bwd_ms`` at ``FLASH_BWD``'s shapes, measured in a fresh
    process: inside this long run the profiler has seen no device activity
    of SDPA's backward, where a fresh process sees it."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import chip_smoke; chip_smoke.sdpa_bwd_worker()")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"SDPA's backward timing failed: "
                               f"{res.stderr[-2000:]}")
    return [tuple(t) for t in json.loads(res.stdout.strip().splitlines()[-1])]


def flash_build_report(fk) -> dict:
    """The wgmma backward entries' SASS census (HGMMA: wgmma; HMMA:
    mma.sync) and ptxas' warnings of lost performance (``wgmma``
    serialised, ``setmaxnreg`` ignored) from the flash library's build
    log."""
    lib = fk.library()._name
    census = sass_census(lib, ("flash_bwd_dkdv_wgmma_kernel",
                               "flash_bwd_dq_wgmma_kernel"),
                         ("HGMMA", "HMMA"))
    log = Path(lib).with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    warns = [ln.strip() for ln in text.splitlines()
             if "setmaxnreg" in ln or "Performance Loss" in ln]
    return {"sass": census, "warnings": warns}


def phase_flash_bwd(fk, fr, fops, dev) -> dict:
    """Phase 24 (a): the training forward's LSE and the backward entries
    against their plain versions at ``FLASH_BWD``'s shapes (bf16 inputs
    from a seeded ``torch.Generator``), each shape run twice and required
    bitwise equal; timings beside the bounds, the plain version, SDPA's
    backward alone (device) and its forward + backward (events); the new
    entries' wgmma census; the serving entry's ptxas numbers against
    ``SERVING_FLASH_PTXAS``."""
    import math

    import torch
    import torch.nn.functional as F
    regs = flash_ptxas(fk)
    serving = {k.split(":", 1)[1]: (r["registers"], r["spill_stores"],
                                    r["spill_loads"])
               for k, r in regs.items() if k.split(":")[0] == fk.MMA_ENTRY}
    moved = {k: (serving.get(k), want)
             for k, want in SERVING_FLASH_PTXAS.items()
             if serving.get(k) != want}
    spilled = {k: (r["spill_stores"], r["spill_loads"])
               for k, r in regs.items()
               if k.split(":")[0] in (fk.MMA_ENTRY, fk.MMA_ENTRY + "_lse")
               and k.split(":")[1] in ("64", "128")
               and (r["spill_stores"] or r["spill_loads"])}
    training = {k: v for k, v in regs.items()
                if k.split(":")[0] != fk.MMA_ENTRY}
    for name, r in sorted(training.items()):
        print(f"  ptxas {name}: {r['registers']} registers, spill stores "
              f"{r['spill_stores']} B, loads {r['spill_loads']} B",
              flush=True)
    print(f"  serving entry {fk.MMA_ENTRY}, {len(SERVING_FLASH_PTXAS)} "
          f"instantiations: ptxas registers and spills as recorded: "
          f"{not moved} {moved or ''}; spills at HDP 64 / 128: "
          f"{spilled or 'none'}", flush=True)
    build = flash_build_report(fk)
    for fn, c in sorted(build["sass"].items()):
        print(f"  SASS {fn}: {c}", flush=True)
    for w in build["warnings"]:
        print(f"  ptxas: {w}", flush=True)
    check(not moved, f"the training flag moved the serving entry's "
                     f"registers or spills: {moved}")
    check(not spilled, f"the bf16 forward spills at HDP 64 / 128: "
                       f"{spilled}")
    drift = {k: (regs.get(k, {}).get("registers"), v)
             for k, v in BWD_PTXAS_BEFORE.items()
             if regs.get(k) is None
             or abs(regs[k]["registers"] - v) > BWD_PTXAS_SLACK}
    print(f"  wgmma entries at HDP 64 / 128 within {BWD_PTXAS_SLACK} "
          f"registers of before the HDP 256 instantiations: {not drift} "
          f"{drift or ''}", flush=True)
    check(not drift, f"the HDP 64 / 128 wgmma entries' registers moved: "
                     f"{drift}")
    check(len(build["sass"]) == 6 and all(
        c.get("HGMMA", 0) > 0 for c in build["sass"].values())
        and not build["warnings"],
        f"a backward entry issues no wgmma, or ptxas serialised its "
        f"products: {build['sass']} {build['warnings']}")
    gen = torch.Generator(device=dev)
    out = {"max_abs_err": 0.0, "worst_share": 0.0, "rows": [],
           "ptxas": training, "build": build,
           "serving_ptxas_moved": moved, "sum_err": 0.0}
    for i, (B, S, Skv, H, K, hd, causal, window) in enumerate(FLASH_BWD):
        gen.manual_seed(2400 + i)
        draw = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                          dtype=torch.float32).to(
                                              torch.bfloat16)
        q, k, v = draw(B, S, H, hd), draw(B, Skv, K, hd), draw(B, Skv, K, hd)
        do = draw(B, S, H, hd)
        o, lse, o_lo = fk.flash_attention_lse(q, k, v, causal=causal,
                                              window=window)
        o_serve = fk.flash_attention(q, k, v, causal=causal, window=window)
        lse_want = fr.flash_attention_lse_ref(q, k, v, causal=causal,
                                              window=window)
        lse_err = float((lse[..., :S] - lse_want).abs().max())
        same_o = bool(torch.equal(o, o_serve))
        o_want = fr.flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=causal, window=window)
        o32_err = float((o.float() + o_lo.float() - o_want).abs().max()
                        / o_want.abs().max())
        d_want = (do.float() * o_want).sum(-1).transpose(1, 2)
        dlt = fk.flash_attention_bwd_dot(o, o_lo, do, lse.shape[-1])
        dot_plain_ms, _ = cuda_ms(lambda: (do.float() * (
            o.float() + o_lo.float())).sum(-1), torch.cuda.synchronize)
        dot_err = float((dlt[..., :S] - d_want).abs().max())
        dot_top = float(d_want.abs().max())
        del o_want, d_want

        def bwd():
            return flash_bwd(fk, q, k, v, o, o_lo, do, lse, causal, window)
        got = bwd()
        again = bwd()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        plain_ms, want = cuda_ms(lambda: fr.flash_attention_bwd_ref(
            q, k, v, do, causal=causal, window=window),
            torch.cuda.synchronize)
        diffs = [bwd_diff(g, w) for g, w in zip(got, want)]
        err = max(d[0] for d in diffs)
        share = max(d[2] for d in diffs)
        del want, again
        # times: each entry and the whole backward (device, a CUDA graph of
        # 20 calls), the LSE forward; SDPA's backward alone (device) and
        # its forward + backward against the kernels' (events, with the
        # host)
        t_dot = graph_ms(lambda: fk.flash_attention_bwd_dot(
            o, o_lo, do, lse.shape[-1]))
        t_dkdv = graph_ms(lambda: fk.flash_attention_bwd_dkdv_entry(
            q, k, v, do, lse, dlt, causal=causal, window=window))
        t_sum = sum_plain_ms = sum_err = None
        if H != K:
            # the group sum against its plain version on the same partials
            parts = fk.flash_attention_bwd_dkdv_entry(
                q, k, v, do, lse, dlt, causal=causal, window=window)
            t_sum = graph_ms(lambda: fk.flash_attention_bwd_sum(*parts, K))
            sum_plain_ms, sums = cuda_ms(lambda: [
                (p.view(B, Skv, K, H // K, hd).sum(3) * c).to(torch.bfloat16)
                for p, c in zip(parts, (1.0 / math.sqrt(hd), 1.0))],
                torch.cuda.synchronize)
            d_w = [((g.float() - w.float()).abs(), w.float().abs())
                   for g, w in zip(fk.flash_attention_bwd_sum(*parts, K),
                                   sums)]
            sum_err = max(float(d.max()) for d, _ in d_w)
            sum_share = max(float((d / (SUM_RTOL * w + 2.0 ** -24 * w.max()))
                                  .max()) for d, w in d_w)
            out["sum_err"] = max(out["sum_err"], sum_err)
            check(sum_share <= 1.0,
                  f"the group sum disagrees with its plain version at "
                  f"{FLASH_BWD[i]}: worst share {sum_share:.3g} of one bf16 "
                  f"rounding")
            del parts, sums, d_w
        t_dq = graph_ms(lambda: fk.flash_attention_bwd_dq(
            q, k, v, do, lse, dlt, causal=causal, window=window))
        t_bwd = graph_ms(bwd)
        t_fwd = graph_ms(lambda: fk.flash_attention_lse(
            q, k, v, causal=causal, window=window))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        mask, is_causal = sdpa_mask(S, Skv, causal, window, dev)

        def sdpa():
            y = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=is_causal,
                enable_gqa=True)
            return torch.autograd.grad(y, (qt, kt, vt), do.transpose(1, 2))
        lib_ms = loop_ms(sdpa)

        def ours():
            o2, lse2, lo2 = fk.flash_attention_lse(q, k, v, causal=causal,
                                                   window=window)
            flash_bwd(fk, q, k, v, o2, lo2, do, lse2, causal, window)
        ours_ms = loop_ms(ours)
        bound, by = flash_bwd_bound(B, S, Skv, H, K, hd, causal, window)
        entry_bounds = bwd_entry_bounds(B, S, Skv, H, K, hd, causal, window)
        row = {"shape": [B, S, Skv, H, K, hd, causal, window],
               "max_abs_err": err, "worst_share": share, "lse_err": lse_err,
               "o_f32_err": o32_err, "dot_err": dot_err,
               "dot_rel_err": dot_err / max(dot_top, 1e-30),
               "sum_err": sum_err,
               "bitwise_twice": bitwise, "o_equals_serving": same_o,
               "dot_ms": t_dot, "dkdv_ms": t_dkdv, "sum_ms": t_sum,
               "dot_plain_ms": dot_plain_ms, "sum_plain_ms": sum_plain_ms,
               "dq_ms": t_dq, "bwd_ms": t_bwd, "fwd_lse_ms": t_fwd,
               "plain_ms": plain_ms, "fwd_bwd_events_ms": ours_ms,
               "library_fwd_bwd_ms": lib_ms, "bound_ms": bound,
               "bound_by": by, "bound_share": bound / t_bwd,
               "entry_bounds": entry_bounds,
               "errs": {n: {"max_abs_err": d[0], "max_plain": d[1],
                            "worst_share": d[2]}
                        for n, d in zip(("dq", "dk", "dv"), diffs)},
               "rel_err": [d[0] / max(d[1], 1e-30) for d in diffs]}
        out["rows"].append(row)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["worst_share"] = max(out["worst_share"], share)
        print(f"  B{B} S{S} Skv{Skv} H{H} K{K} hd{hd} causal={causal} "
              f"window={window}: dq / dk / dv max |kernel - plain| / max "
              f"|plain| {', '.join(f'{d[0]:.3g}/{d[1]:.3g}' for d in diffs)}"
              f", worst share of the limit {share:.3g}; D max |d| "
              f"{dot_err:.3g} of {dot_top:.3g}; LSE max |d| {lse_err:.3g}; "
              f"O + O_lo against the f32 output, max |d| / max |O| "
              f"{o32_err:.3g} (limit {FLASH_O32_TOL:.3g}); bitwise twice "
              f"{bitwise}; O equals the serving entry's {same_o}",
              flush=True)
        sum_txt = ("" if t_sum is None else
                   f", sum {t_sum:.4f} (max |d| from its plain version "
                   f"{sum_err:.3g})")
        print(f"    device ms: D {t_dot:.4f}, dK/dV {t_dkdv:.4f}{sum_txt}, "
              f"dQ {t_dq:.4f}, backward {t_bwd:.4f} ({100 * bound / t_bwd:.1f}"
              f" % of its {by} bound {bound:.4f} ms); LSE forward {t_fwd:.4f}; plain backward {plain_ms:.2f} ms; "
              f"events: the kernels' forward + backward {ours_ms:.4f} ms, "
              f"SDPA's {lib_ms:.4f} ms; entry bounds "
              + ", ".join(f"{n} {b[0]:.4f} ({b[1]})"
                          for n, b in entry_bounds.items()), flush=True)
        check(share <= 1.0 and bitwise and lse_err <= 1e-3
              and o32_err <= FLASH_O32_TOL
              and dot_err <= FLASH_O32_TOL * dot_top,
              f"the flash backward disagrees with its plain version, or is "
              f"not deterministic, at {FLASH_BWD[i]} (D: max |d| {dot_err:.3g}"
              f" of {dot_top:.3g}, limit {FLASH_O32_TOL:.3g} of the largest)")
        del q, k, v, do, o, lse, o_lo, got, dlt, qt, kt, vt
        torch.cuda.empty_cache()
    for row, (ms, by, form) in zip(out["rows"], sdpa_bwd_times()):
        row["library_bwd_ms"], row["library_bwd_by"] = ms, by
        row["library_bwd_form"] = form
        print(f"  {row['shape']}: SDPA's backward alone {ms:.4f} ms ({by}, "
              f"{form}) against the kernels' {row['bwd_ms']:.4f}",
              flush=True)
    return out


#: phase 24 (c): whisper-small's train step at published width (12 + 12
#: layers), B 2 x 64 tokens over 1 500 stub frames, counter-based inputs
WHISPER_TRAIN = {"batch": 2, "seq": 64, "frames": 1500, "seed": 26}
#: phase 24 (c)'s end-to-end limits for whisper-small's step against its
#: plain-version step (relative, as ``golden.TRAIN_TOL``).  The plain step
#: split into two microbatches moves a leaf's gradient norm by 4.31e-3
#: (``['dec_layers'][5]['attn']['wk']``, two card runs alike), above
#: ``TRAIN_TOL``'s 2^-8: a bf16 rounding anywhere in the forward moves the
#: step that far (the kernels' forward rounds O where the plain version
#: rounds the f32 output; SDPA's step lies 1.9e-2 away).  So the leaves
#: take 4x that floor, rounded down to a power of two, 2^-6; the loss,
#: grad_norm and lr keep ``TRAIN_TOL``.  The backward entries themselves
#: are held to ``TRAIN_TOL`` in the same step against the kernels'
#: forward with the plain backward (``plain_backward``): there the
#: forward is bitwise shared, and D taken from the bf16 output (the
#: backward's first design) lies 1.3e-2 away
#: (``tests/_torch_whisper_bwd.py``).
WHISPER_TRAIN_TOL = {"loss": 2.0 ** -12, "grad_norm": 2.0 ** -10,
                     "leaf_grad_norms": 2.0 ** -6, "lr": 1e-6}
#: phase 24 (d): the 100m example, a checkpoint at step 20, resumed to 30
EXAMPLE_TRAIN = {"preset": "100m", "steps": 30, "ckpt_every": 20}
#: phase 24 (e): tinyllama-1.1b's full train step timed (B 4 x S 2 048,
#: ``microbatches_for``' count for that shape), ``reps`` steps after one
#: warm-up step
TRAIN_TIMED = {"batch": 4, "seq": 2048, "reps": 3}


def train_counts(fops) -> dict:
    return {"flash": fops.launches, "bwd_dot": fops.bwd_dot_launches,
            "bwd_dkdv": fops.bwd_dkdv_launches,
            "bwd_sum": fops.bwd_sum_launches,
            "bwd_dq": fops.bwd_dq_launches}


def zero_train_counts(fops) -> None:
    fops.launches = fops.bwd_dot_launches = fops.bwd_sum_launches = 0
    fops.bwd_dkdv_launches = fops.bwd_dq_launches = 0


def dq_in_place(fk, fr):
    """A context in which every causal call of the dQ entry (in whisper-
    small: the decoder's self-attention) is also held, in place, to the
    plain backward of the same inputs: yields the list of its dQ's worst
    shares of phase 24 (a)'s limit."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        shares, launch = [], fk.flash_attention_bwd_dq

        def held(q, k, v, do, lse, dlt, *, causal, window):
            dq = launch(q, k, v, do, lse, dlt, causal=causal, window=window)
            if causal:
                want = fr.flash_attention_bwd_ref(q, k, v, do, causal=True,
                                                  window=window)[0]
                shares.append(bwd_diff(dq, want)[2])
            return dq
        fk.flash_attention_bwd_dq = held
        try:
            yield shares
        finally:
            fk.flash_attention_bwd_dq = launch
    return ctx()


def ops_as(**fns):
    """A context in which the dispatchers named in ``fns`` (``attn``,
    ``ssm``, ``rglru``) run the given functions in place of
    ``ops.flash_attention``, ``ops.ssm_scan`` and ``ops.rglru_scan``."""
    import contextlib

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rglru_scan import ops as ro
    from repro_torch.kernels.ssm_scan import ops as so
    where = {"attn": (fops, "flash_attention"), "ssm": (so, "ssm_scan"),
             "rglru": (ro, "rglru_scan")}

    @contextlib.contextmanager
    def ctx():
        saved = {k: getattr(*where[k]) for k in fns}
        for k, fn in fns.items():
            setattr(*where[k], fn)
        try:
            yield
        finally:
            for k, fn in saved.items():
                setattr(*where[k], fn)
    return ctx()


def plain_attention():
    """A context in which the model's attention runs the flash kernel's
    plain version on the card, differentiated by autograd (the reference
    a training step through the kernels is held to)."""
    from repro_torch.kernels.flash_attention import ref as fr

    def plain(q, k, v, *, causal=True, window=0):
        return fr.flash_attention_ref(q, k, v, causal=causal, window=window)
    return ops_as(attn=plain)


def plain_backward():
    """A context in which the model's attention runs the flash kernel's
    forward (so that every activation is bitwise the kernels' step's) and
    the plain backward (``ref.flash_attention_bwd_ref`` on the call's
    inputs): the reference that isolates the backward entries inside a
    train step."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr

    class KernelForwardPlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            ctx.save_for_backward(q, k, v)
            ctx.mask = (causal, window)
            return fk.flash_attention(q, k, v, causal=causal, window=window)

        @staticmethod
        def backward(ctx, do):
            q, k, v = ctx.saved_tensors
            causal, window = ctx.mask
            g = fr.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                           window=window)
            return (g[0].to(q.dtype), g[1].to(k.dtype), g[2].to(v.dtype),
                    None, None)

    def attn(q, k, v, *, causal=True, window=0):
        return KernelForwardPlainBackward.apply(q, k, v, causal, window)
    return ops_as(attn=attn)


def train_step_record(golden_mod, steps, adamw, model, cfg, batch,
                      microbatches: int) -> dict:
    """One ``make_train_step`` step from fresh AdamW state: ``{"loss",
    "grad_norm", "lr", "leaf_grad_norms"}`` (``golden.leaf_grad_norms``
    from the new first moment)."""
    opt_cfg = adamw.AdamWConfig()
    step = steps.make_train_step(cfg, opt_cfg, microbatches=microbatches)
    opt, out = step(model, adamw.init(model.tree()), batch)
    gn = float(out["grad_norm"])
    scale = min(1.0, opt_cfg.clip_norm / max(gn, 1e-9))
    return {"loss": float(out["loss"]), "grad_norm": gn,
            "lr": float(out["lr"]),
            "leaf_grad_norms": golden_mod.leaf_grad_norms(
                opt.m, opt_cfg.b1, scale)}


def golden_train_model(golden_mod, lm, cfg, seed: int, dev):
    """The golden weights of ``cfg`` built on the card; returns ``(model,
    weights digest)``."""
    import torch
    tree = golden_mod.golden_weights(lm.lm_defs(cfg), seed, dev)
    torch.cuda.synchronize()
    return lm.LM(cfg, tree), golden_mod.weights_digest(tree)


#: phase 24 (f): each scan backward kernel at full width against its plain
#: version, run twice: falcon-mamba-7b's chunk (B, T, D, N) with a nonzero
#: dh_T, and recurrentgemma-2b's rec layer (B, S, d)
SSM_BWD_FULL = (2, 256, 8192, 16)
RGLRU_BWD_FULL = (2, 2048, 2560)


def scan_bwd_ptxas(sk, rk) -> dict:
    """``ptxas_report`` of the rglru_scan backward kernel and of the dC
    sum's two instantiations (16-byte and scalar loads), from the two
    libraries' build logs."""
    regs = {}
    for lib in (sk.library(), rk.library()):
        log = Path(lib._name).with_suffix(".log")
        regs.update(ptxas_report(
            log.read_text() if log.exists() else "",
            r"(rglru_scan_bwd_kernel|ssm_scan_dc_sum_kernelILi\d+E)"))
    return regs


def phase_scan_bwd(dev) -> dict:
    """Phase 24 (f): the ssm_scan backward (its dc sum too) and the
    rglru_scan backward against their plain versions on the card at
    ``SSM_BWD_FULL`` / ``RGLRU_BWD_FULL``: every output bitwise but the
    sums dc and dnsp, held to their sum-order limits (``ref.dc_limit``,
    ``ref.dnsp_limit``), the rglru_scan backward also bitwise to its tiled
    walk (``ref.rglru_gated_scan_bwd_tiled``, dnsp in the kernel's order),
    and bitwise when run twice; device times (a CUDA graph of 20) beside
    the bounds and the plain versions' times; the dC sum's and the
    rglru_scan backward's registers, spills and shared memory."""
    import torch
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan import ref as rr
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ref as sr
    out = {"ptxas": scan_bwd_ptxas(sk, rk)}
    for entry, r in out["ptxas"].items():
        print(f"  (f) ptxas {entry}: {r['registers']} registers, spill "
              f"stores {r['spill_stores']} B, spill loads "
              f"{r['spill_loads']} B, static shared memory "
              f"{r.get('static_smem_bytes', 0)} B", flush=True)
    # falcon-mamba-7b's chunk
    B, T, D, N = SSM_BWD_FULL
    decay, dbu, c, h0 = scan_case(B, T, D, N, 2470, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(2471)
    dy = torch.randn((B, T, D), generator=g, device=dev)
    dh_t = torch.randn((B, D, N), generator=g, device=dev)
    h_out, y, h_seq = sk.ssm_scan_train(decay, dbu, c, h0)
    h_want, y_want = sr.ssm_scan_ref(decay, dbu, c, h0)
    train_err = max(float((h_out - h_want).abs().max()),
                    float((y - y_want).abs().max()))
    train_ok = (torch.equal(h_out, h_want)
                and torch.equal(h_seq[:, -1], h_out)
                and bool(((y - y_want).abs()
                          <= sr.y_limit(decay, dbu, c, h0)).all()))
    del h_out, y, h_want, y_want

    def bwd():
        d_decay, d_dbu, dh0, part = sk.ssm_scan_bwd(decay, h_seq, h0, c, dy,
                                                    dh_t)
        return d_decay, d_dbu, sk.ssm_scan_dc_sum(part), dh0
    got, again = bwd(), bwd()
    train_plain_ms, _ = cuda_ms(lambda: sr.ssm_scan_ref(decay, dbu, c, h0),
                                torch.cuda.synchronize)
    plain_ms, want = cuda_ms(lambda: sr.ssm_scan_bwd_ref(
        decay, dbu, c, h0, dy, dh_t), torch.cuda.synchronize)
    twice = all(torch.equal(a, b) for a, b in zip(got, again))
    differ = [int((got[i] != want[i]).sum()) for i in (0, 1, 3)]
    lim = sr.dc_limit(decay, dbu, h0, dy)
    dc_share = float(((got[2] - want[2]).abs() / lim).max())
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    part = sk.ssm_scan_bwd(decay, h_seq, h0, c, dy, dh_t)[3]
    ms = graph_ms(lambda: sk.ssm_scan_bwd(decay, h_seq, h0, c, dy, dh_t))
    sum_ms = graph_ms(lambda: sk.ssm_scan_dc_sum(part))
    sum_plain_ms, _ = cuda_ms(lambda: part.sum(1), torch.cuda.synchronize)
    train_ms = graph_ms(lambda: sk.ssm_scan_train(decay, dbu, c, h0))
    serve_ms = graph_ms(lambda: sk.ssm_scan(decay, dbu, c, h0))
    bound, by = ssm_bwd_bound(B, T, D, N)
    sum_bound, _ = bound_of(4 * (part.numel() + B * T * N), 0)
    train_bound, _ = bound_of(scan_work(B, T, D, N, train=True)[1], 0)
    print(f"  (f) ssm_scan backward B{B} T{T} D{D} N{N}, dh_T nonzero: "
          f"the training forward's h_out bitwise, y within its limit and "
          f"h_seq's last step h_out: {train_ok}; "
          f"d decay / d dbu / dh0 elements differing from the plain "
          f"version {differ}; dc worst share of its sum-order limit "
          f"{dc_share:.3g}; bitwise twice {twice}; device ms: backward "
          f"{ms:.4f} ({100 * bound / ms:.1f} % of its {by} bound "
          f"{bound:.4f}), dc sum {sum_ms:.4f} ({100 * sum_bound / sum_ms:.1f}"
          f" % of its bytes bound {sum_bound:.4f}), "
          f"training forward {train_ms:.4f} (bound {train_bound:.4f}; "
          f"serving {serve_ms:.4f}); plain backward {plain_ms:.2f} ms",
          flush=True)
    check(train_ok and twice and differ == [0, 0, 0] and dc_share <= 1.0,
          "the ssm_scan backward disagrees with its plain version, or is "
          "not deterministic")
    out["ssm"] = {"shape": [B, T, D, N], "max_abs_err": err,
                  "dc_share": dc_share, "bitwise_twice": twice, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                  "sum_ms": sum_ms, "sum_plain_ms": sum_plain_ms,
                  "sum_bound_ms": sum_bound, "train_ms": train_ms,
                  "serve_ms": serve_ms, "train_bound_ms": train_bound,
                  "train_err": train_err, "train_plain_ms": train_plain_ms}
    del decay, dbu, c, h0, dy, dh_t, h_seq, got, again, want, lim, part
    torch.cuda.empty_cache()
    # recurrentgemma-2b's rec layer
    B, S, d = RGLRU_BWD_FULL
    r_pre, i_pre, u, nsp, h0 = rglru_case(B, S, d, 2472, dev)
    g.manual_seed(2473)
    dh_seq = torch.randn((B, S, d), generator=g, device=dev)
    dh_s = torch.randn((B, d), generator=g, device=dev)
    h_seq, _ = rk.rglru_scan(r_pre, i_pre, u, nsp, h0)
    args = (r_pre, i_pre, u, nsp, h0, h_seq, dh_seq, dh_s)
    got, again = rk.rglru_scan_bwd(*args), rk.rglru_scan_bwd(*args)
    plain_ms, want = cuda_ms(lambda: rr.rglru_gated_scan_bwd_ref(*args),
                             torch.cuda.synchronize)
    tiled = all(torch.equal(g, w) for g, w in zip(
        got, rr.rglru_gated_scan_bwd_tiled(*args)))
    twice = all(torch.equal(a, b) for a, b in zip(got, again))
    differ = [int((got[i] != want[i]).sum()) for i in (0, 1, 2, 4)]
    finite = all(bool(x.isfinite().all()) for x in got)
    low = [float(got[i][..., 1].abs().max()) for i in (0, 1)]
    nsp_share = float(((got[3] - want[3]).abs()
                       / rr.dnsp_limit(*args)).max())
    err = max(float((a.float() - w.float()).abs().max())
              for a, w in zip(got, want))
    ms = graph_ms(lambda: rk.rglru_scan_bwd(*args))
    bound, by = rglru_bwd_bound(B, S, d)
    smem = rk.library().rglru_scan_bwd_smem_bytes()
    print(f"  (f) rglru_scan backward B{B} S{S} d{d}: dr_pre / di_pre / du "
          f"/ dh0 elements differing from the plain version {differ}; "
          f"every gradient finite {finite} (channel 1, r_pre -120 where "
          f"the sigmoid's bf16 exp overflows: max |dr_pre|, |di_pre| "
          f"{low}); "
          f"dnsp worst share of its sum-order limit {nsp_share:.3g}; "
          f"every output equal to the tiled walk's {tiled}; "
          f"bitwise twice {twice}; device ms {ms:.4f} "
          f"({100 * bound / ms:.1f} % of its {by} bound {bound:.4f}); "
          f"{smem} B of dynamic shared memory a block; plain backward "
          f"{plain_ms:.2f} ms", flush=True)
    check(twice and finite and tiled and differ == [0, 0, 0, 0]
          and nsp_share <= 1.0,
          "the rglru_scan backward disagrees with its plain version or its "
          "tiled walk, is not finite, or is not deterministic")
    out["rglru"] = {"shape": [B, S, d], "max_abs_err": err,
                    "dnsp_share": nsp_share, "bitwise_twice": twice,
                    "finite": finite, "tiled_equal": tiled,
                    "smem_bytes": smem,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by}
    del args, got, again, want, r_pre, i_pre, u, h_seq, dh_seq
    torch.cuda.empty_cache()
    return out


def train_kernel_counts() -> dict:
    """The launch counts of every kernel a train step may run."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rglru_scan import ops as ro
    from repro_torch.kernels.ssm_scan import ops as so
    return {**train_counts(fops), "ssm_scan": so.launches,
            "ssm_scan_train": so.train_launches, "ssm_bwd": so.bwd_launches,
            "ssm_bwd_sum": so.bwd_sum_launches, "rglru_scan": ro.launches,
            "rglru_bwd": ro.bwd_launches,
            "rglru_bwd_nsp": ro.bwd_nsp_launches}


def zero_train_kernel_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rglru_scan import ops as ro
    from repro_torch.kernels.ssm_scan import ops as so
    zero_train_counts(fops)
    so.launches = so.train_launches = so.bwd_launches = 0
    so.bwd_sum_launches = ro.launches = ro.bwd_launches = 0
    ro.bwd_nsp_launches = 0


def plain_train():
    """A context in which the model's attention and both scans run their
    plain versions on the card, differentiated by autograd: the
    reference the recurrent and MoE train steps are held to."""
    from repro_torch.kernels.flash_attention import ref as fr
    from repro_torch.kernels.rglru_scan import ref as rr
    from repro_torch.kernels.ssm_scan import ref as sr

    def attn(q, k, v, *, causal=True, window=0):
        return fr.flash_attention_ref(q, k, v, causal=causal, window=window)
    return ops_as(attn=attn, ssm=sr.ssm_scan_ref,
                  rglru=rr.rglru_gated_scan_ref)


def scans_plain_backward():
    """A context in which both scans run their kernels forward and their
    plain backward (``ssm_scan_bwd_ref``, ``rglru_gated_scan_bwd_ref``):
    with ``plain_backward``, the reference that isolates the backward
    kernels inside a train step."""
    import torch
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan import ref as rr
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ref as sr

    class Ssm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, decay, dbu, c, h0):
            ctx.save_for_backward(decay, dbu, c, h0)
            return sk.ssm_scan(decay, dbu, c, h0)

        @staticmethod
        def backward(ctx, dh, dy):
            d_decay, d_dbu, dc, dh0 = sr.ssm_scan_bwd_ref(
                *ctx.saved_tensors, dy, dh)
            return d_decay, d_dbu, dc, dh0

    class Rglru(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r_pre, i_pre, u, nsp, h0):
            h_seq, h_s = rk.rglru_scan(r_pre, i_pre, u, nsp, h0)
            ctx.save_for_backward(r_pre, i_pre, u, nsp, h0, h_seq)
            return h_seq, h_s

        @staticmethod
        def backward(ctx, dh_seq, dh_s):
            return rr.rglru_gated_scan_bwd_ref(*ctx.saved_tensors,
                                               dh_seq.float(), dh_s.float())
    return ops_as(ssm=lambda *a: Ssm.apply(*a),
                  rglru=lambda *a: Rglru.apply(*a))


def zoo_train_steps(golden_mod, dev) -> dict:
    """Phase 24 (g): ``golden.TRAIN_ZOO``'s train steps on the card.  For
    each: the plain-version step (``plain_train``) and the same step in
    two microbatches, whose distance sets the step's limits
    (``golden.train_limits``) before any kernel step runs; then the
    kernels' step, counted by the wrappers' counters (zeroed just before
    it), held to the plain step within those limits; then the kernels'
    forward with the plain backward (``plain_backward`` and
    ``scans_plain_backward``), held to the kernels' step within
    ``TRAIN_TOL``.  phi3.5-moe's 1-layer step peaks near the card's 80 GB
    and has run out of memory there on an H100 80GB from fragmentation
    alone (3.12 GiB refused with 7.33 GiB reserved but free), so these
    steps grow expandable segments (the caching allocator's setting,
    restored after)."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        return _zoo_train_steps(golden_mod, dev)
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def _zoo_train_steps(golden_mod, dev) -> dict:
    import gc

    import torch
    from repro_torch.configs import get
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    tol = golden_mod.TRAIN_TOL
    out = {}
    for name, spec in golden_mod.TRAIN_ZOO.items():
        cfg = golden_mod.zoo_config(get(spec["config"]), spec)
        batch = golden_mod.train_tokens(cfg.vocab_size, dev, spec)
        recs, walls = {}, {}
        for run in ("plain", "plain_mb2", "kernel", "plain_backward"):
            gc.collect()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated() / 2 ** 30
            model, _ = golden_train_model(golden_mod, lm, cfg, spec["seed"],
                                          dev)
            mb = 2 if run == "plain_mb2" else 1
            if run == "plain_backward":
                with plain_backward(), scans_plain_backward():
                    recs[run] = train_step_record(golden_mod, steps, adamw,
                                                  model, cfg, batch, mb)
            elif run == "kernel":
                limits = golden_mod.train_limits(floor)
                torch.cuda.synchronize()
                zero_train_kernel_counts()
                t0 = time.perf_counter()
                recs[run] = train_step_record(golden_mod, steps, adamw,
                                              model, cfg, batch, mb)
                torch.cuda.synchronize()
                walls[run] = time.perf_counter() - t0
                counts = train_kernel_counts()
            else:
                with plain_train():
                    t0 = time.perf_counter()
                    recs[run] = train_step_record(golden_mod, steps, adamw,
                                                  model, cfg, batch, mb)
                    torch.cuda.synchronize()
                    walls[run] = time.perf_counter() - t0
                if run == "plain_mb2":
                    floor = golden_mod.train_record_distance(
                        recs["plain_mb2"], recs["plain"])
            del model
            torch.cuda.empty_cache()
        dist = golden_mod.train_record_distance(recs["kernel"],
                                                recs["plain"])
        bwd = golden_mod.train_record_distance(recs["kernel"],
                                               recs["plain_backward"])
        kinds = {"falcon-mamba-7b": ("ssm_scan_train", "ssm_bwd",
                                     "ssm_bwd_sum"),
                 "recurrentgemma-2b": ("rglru_scan", "rglru_bwd", "flash",
                                       "bwd_dot", "bwd_dkdv", "bwd_dq",
                                       "bwd_sum"),
                 "phi3.5-moe-42b-a6.6b": ("flash", "bwd_dot", "bwd_dkdv",
                                          "bwd_dq", "bwd_sum")}[name]
        print(f"  (g) {name} ({cfg.n_layers} layers, published widths, "
              f"B{spec['batch']} x {spec['seq']}): loss "
              f"{recs['kernel']['loss']:.6f}, grad_norm "
              f"{recs['kernel']['grad_norm']:.6f}; the plain step's "
              f"microbatch split {floor}, so limits {limits}; relative "
              f"distance from the plain versions' step {dist}; from the "
              f"kernels' forward with the plain backward {bwd} (limits "
              f"{tol}); launches {counts}; step wall {walls['kernel']:.2f} s"
              f" (plain {walls['plain']:.2f} s); {held:.2f} GiB allocated "
              f"before the last step's model", flush=True)
        check(all(dist[k] <= limits[k] for k in tol),
              f"{name}'s train step disagrees with its plain step")
        check(all(bwd[k] <= tol[k] for k in tol),
              f"{name}'s train step disagrees with the same step on the "
              f"plain backward")
        check(all(counts[k] > 0 for k in kinds),
              f"{name}'s train step launched one of its kernels no time: "
              f"{counts}")
        out[name] = {"distance": dist, "backward_distance": bwd,
                     "floor": floor, "limits": limits, "launches": counts,
                     "wall_s": walls["kernel"], "plain_wall_s": walls["plain"],
                     "loss": recs["kernel"]["loss"]}
    return out


def train_phase(golden_mod, smi: str, device="cuda") -> list:
    """Phase 24 on ``device``: (a) the backward entries against their
    plain version, (b) tinyllama-1.1b's train step against
    ``golden_train.json`` and its plain-version step, (c) whisper-small's
    step against its plain-version step, (d) the 100m example's run and
    resume, (e) the timed full train step, (f) the scan backward kernels
    against their plain versions, (g) falcon-mamba-7b's, recurrentgemma-
    2b's and phi3.5-moe's train steps against their plain-version steps;
    returns the kernel line's rows: the whole backward
    (``flash_attention_bwd``), the hd 256 entries, the scans' backward
    kernels, then each flash entry."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fr
    from repro_torch.launch import steps
    from repro_torch.models import lm, zoo
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    dev = torch.device(device)
    t_phase = time.time()

    phase("24: training on the card")
    print("  (a) the flash kernel's backward entries vs their plain version",
          flush=True)
    bwd = phase_flash_bwd(fk, fr, fops, dev)
    tol = golden_mod.TRAIN_TOL

    # (b) tinyllama-1.1b: the golden step, then full depth
    rec = golden_mod.load_train()
    T = rec["train"]
    cfg = golden_mod.zoo_config(get(T["config"]), T)
    model, digest = golden_train_model(golden_mod, lm, cfg, T["seed"], dev)
    check(digest == rec["weights_digest"], "the golden training weights "
          "built on the card differ from repro's")
    batch = golden_mod.train_tokens(cfg.vocab_size, dev)
    check(golden_mod.tokens_digest(batch["tokens"], batch["targets"])
          == rec["tokens_digest"], "the golden training tokens differ")
    zero_train_counts(fops)
    got = train_step_record(golden_mod, steps, adamw, model, cfg, batch,
                            T["microbatches"])
    torch.cuda.synchronize()
    launches = train_counts(fops)
    model, _ = golden_train_model(golden_mod, lm, cfg, T["seed"], dev)
    with plain_attention():
        plain = train_step_record(golden_mod, steps, adamw, model, cfg,
                                  batch, T["microbatches"])
    dist = golden_mod.train_record_distance(got, rec["blocked"])
    dist_plain = golden_mod.train_record_distance(plain, rec["blocked"])
    print(f"  (b) tinyllama-1.1b ({cfg.n_layers} layers, published widths, "
          f"B{T['batch']} x {T['seq']}, {T['microbatches']} microbatches): "
          f"loss {got['loss']:.6f} (repro {rec['blocked']['loss']:.6f}), "
          f"grad_norm {got['grad_norm']:.6f} "
          f"({rec['blocked']['grad_norm']:.6f}); relative distance from "
          f"golden_train.json {dist} (limits {tol}); the plain versions' "
          f"step on the card {dist_plain}; launches {launches}", flush=True)
    check(all(dist[k] <= tol[k] for k in tol),
          "tinyllama-1.1b's train step disagrees with golden_train.json")
    check(all(dist_plain[k] <= tol[k] for k in tol),
          "the plain versions' train step disagrees with golden_train.json")
    check(all(n > 0 for n in launches.values())
          and launches["bwd_sum"] == launches["bwd_dkdv"],
          f"the train step launched a flash entry no time, or summed fewer "
          f"groups than it has layers: {launches}")
    del model
    full = get(T["config"])
    model, _ = golden_train_model(golden_mod, lm, full, T["seed"], dev)
    fk_full = train_step_record(golden_mod, steps, adamw, model, full, batch,
                                T["microbatches"])
    del model
    torch.cuda.empty_cache()
    model, _ = golden_train_model(golden_mod, lm, full, T["seed"], dev)
    with plain_attention():
        pl_full = train_step_record(golden_mod, steps, adamw, model, full,
                                    batch, T["microbatches"])
    del model
    torch.cuda.empty_cache()
    dist_full = golden_mod.train_record_distance(fk_full, pl_full)
    print(f"  (b) tinyllama-1.1b full depth ({full.n_layers} layers), same "
          f"batch: loss {fk_full['loss']:.6f}, grad_norm "
          f"{fk_full['grad_norm']:.6f}; relative distance from the plain "
          f"versions' step on the card {dist_full}", flush=True)
    check(all(dist_full[k] <= tol[k] for k in tol),
          "tinyllama-1.1b's full-depth step disagrees with its plain step")

    # (c) whisper-small: the kernels' step against the plain versions'
    # (WHISPER_TRAIN_TOL) and against the kernels' forward with the plain
    # backward (TRAIN_TOL); beside them, for the record, the plain step's
    # own distance from itself split into two microbatches
    W = WHISPER_TRAIN
    wcfg = get("whisper-small")
    recs = {}
    for name in ("kernel", "plain", "plain_mb2", "plain_backward"):
        tree = golden_mod.golden_weights(zoo.model_defs(wcfg), W["seed"], dev)
        wmodel = lm.LM(wcfg, tree)
        wbatch = golden_mod.train_tokens(wcfg.vocab_size, dev,
                                         {"batch": W["batch"],
                                          "seq": W["seq"],
                                          "seed": W["seed"]})
        wbatch["frames"] = golden_mod._embeds(
            W["seed"], golden_mod._LANE_FRAMES,
            (W["batch"], W["frames"], wcfg.d_model), dev)
        zero_train_counts(fops)
        if name == "kernel":
            with dq_in_place(fk, fr) as dq_shares:
                recs[name] = train_step_record(golden_mod, steps, adamw,
                                               wmodel, wcfg, wbatch, 1)
            w_launches = train_counts(fops)
        else:
            with (plain_backward() if name == "plain_backward"
                  else plain_attention()):
                recs[name] = train_step_record(
                    golden_mod, steps, adamw, wmodel, wcfg, wbatch,
                    2 if name == "plain_mb2" else 1)
        del wmodel, tree
        torch.cuda.empty_cache()
    wdist = golden_mod.train_record_distance(recs["kernel"], recs["plain"])
    wbwd = golden_mod.train_record_distance(recs["kernel"],
                                            recs["plain_backward"])
    wfloor = golden_mod.train_record_distance(recs["plain_mb2"],
                                              recs["plain"])
    print(f"  (c) whisper-small (12 + 12 layers, B{W['batch']} x "
          f"{W['seq']} tokens, {W['frames']} frames): loss "
          f"{recs['kernel']['loss']:.6f}, grad_norm "
          f"{recs['kernel']['grad_norm']:.6f}; relative distance from the "
          f"plain versions' step {wdist} (limits {WHISPER_TRAIN_TOL}); "
          f"from the kernels' forward with the plain backward {wbwd} "
          f"(limits {tol}); the plain step's microbatch split {wfloor}; "
          f"launches {w_launches}; in place, the decoder self-attention's "
          f"dQ at {len(dq_shares)} calls, worst share of phase 24 (a)'s "
          f"limit {max(dq_shares):.3f}", flush=True)
    check(len(dq_shares) == wcfg.n_layers and max(dq_shares) <= 1.0,
          f"whisper's decoder self-attention dQ leaves phase 24 (a)'s limit "
          f"in place: {dq_shares}")
    check(all(wdist[k] <= WHISPER_TRAIN_TOL[k] for k in tol),
          "whisper-small's train step disagrees with its plain step")
    check(all(wbwd[k] <= tol[k] for k in tol),
          "whisper-small's train step disagrees with the same step on the "
          "plain backward")
    check(all(n > 0 for k, n in w_launches.items() if k != "bwd_sum")
          and w_launches["bwd_sum"] == 0,
          f"whisper's train step launched a flash entry no time, or summed "
          f"partials of one-head groups: {w_launches}")

    # (d) the 100m example: a straight run with a checkpoint at step 20,
    # then a resume from it to the same last step
    E = EXAMPLE_TRAIN
    ex = load_example("train_lm_torch")
    ckpt_dir = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        argv = ["--preset", E["preset"], "--steps", str(E["steps"]),
                "--ckpt-every", str(E["ckpt_every"]), "--ckpt-dir",
                ckpt_dir, "--device", device]
        t0 = time.time()
        straight = ex.main(argv)
        ex_s = time.time() - t0
        resumed = ex.main(argv + ["--resume"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    last = E["steps"] - 1
    a, b = straight["losses"], resumed["losses"]
    bitwise = a[last] == b[last] and all(
        torch.equal(x, y) for x, y in zip(straight["model"].parameters(),
                                          resumed["model"].parameters()))
    print(f"  (d) examples/train_lm_torch.py --preset {E['preset']}: loss "
          f"{a[0]:.4f} at step 0, {a[last]:.4f} at step {last} "
          f"({ex_s:.1f} s with its checkpoint); resumed from step "
          f"{resumed['start']}: {b[last]:.4f}; last loss and parameters "
          f"bitwise equal: {bitwise}", flush=True)
    check(a[last] < a[0] and resumed["start"] == E["ckpt_every"],
          "the example's loss did not fall, or it did not resume")
    check(bitwise, "the resumed run's last loss or parameters differ from "
                   "the straight run's")
    del straight, resumed
    torch.cuda.empty_cache()

    # (e) the full train step timed
    TT = TRAIN_TIMED
    shape = ShapeConfig("train", TT["seq"], TT["batch"], "train")
    mb = steps.microbatches_for(full, shape)
    model, _ = golden_train_model(golden_mod, lm, full, T["seed"], dev)
    tbatch = golden_mod.train_tokens(full.vocab_size, dev, {
        "batch": TT["batch"], "seq": TT["seq"], "seed": T["seed"] + 1})
    step = steps.make_train_step(full, adamw.AdamWConfig(), microbatches=mb)
    opt = adamw.init(model.tree())
    torch.cuda.reset_peak_memory_stats()
    opt, out = step(model, opt, tbatch)
    torch.cuda.synchronize()
    walls = []
    zero_train_counts(fops)
    for _ in range(TT["reps"]):
        t0 = time.perf_counter()
        opt, out = step(model, opt, tbatch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    step_launches = {k: v // TT["reps"] for k, v in
                     train_counts(fops).items()}
    wall = statistics.median(walls)
    flops = train_flops(full, TT["batch"], TT["seq"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _, busy, by_name = profile_kernels(lambda: step(model, opt, tbatch), (
        (fk.MMA_ENTRY,), ("flash_bwd_dkdv_wgmma_kernel",),
        ("flash_bwd_dq_wgmma_kernel",), ("flash_bwd_dot_kernel",),
        ("flash_bwd_sum_kernel",),
        ("gemm", "Gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")))
    tok_s = TT["batch"] * TT["seq"] / wall
    print(f"  (e) tinyllama-1.1b full train step B{TT['batch']} x "
          f"{TT['seq']} ({mb} microbatch): {wall * 1e3:.1f} ms (median of "
          f"{TT['reps']}: {', '.join(f'{w * 1e3:.1f}' for w in walls)}), "
          f"{tok_s:,.0f} tokens/s, {flops:.3g} operations: "
          f"{100 * flops / wall / PEAK_OPS['bf16']:.1f} % of 989 TFLOP/s; "
          f"peak device memory {peak:.1f} GiB; launches a step "
          f"{step_launches}; loss {float(out['loss']):.4f}", flush=True)
    if busy is not None:
        print(f"    profiled step: device busy {busy:.1f} ms; "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in by_name.items()
                          if k != "n_kernels")
              + f"; {by_name['n_kernels']} kernels", flush=True)
    del model, opt
    torch.cuda.empty_cache()

    # (f) the scan backward kernels at full width; (g) the recurrent and
    # MoE families' train steps
    scan_bwd = phase_scan_bwd(dev)
    zoo_steps = zoo_train_steps(golden_mod, dev)
    print(f"  phase 24 {time.time() - t_phase:.1f} s; card: {smi}",
          flush=True)

    tiny = bwd["rows"][0]
    src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    replaces = ("none: XLA's differentiation of src/repro/models/layers.py:"
                "113 blocked_attention (repro's training path; no Pallas "
                "kernel has a backward)")
    rows = [{
        "name": "flash_attention_bwd", "route": "cuda", "source": src,
        "replaces": replaces,
        "launches": launches["bwd_dkdv"], "launches_golden_step": launches,
        "launches_whisper_step": w_launches,
        "launches_full_step": step_launches,
        "max_abs_err": bwd["max_abs_err"], "worst_share": bwd["worst_share"],
        "ms": tiny["bwd_ms"], "plain_ms": tiny["plain_ms"],
        "bound_ms": tiny["bound_ms"], "bound_by": tiny["bound_by"],
        "library_ms": tiny["library_bwd_ms"],
        "library": "SDPA's backward alone (enable_gqa), device time by "
                   f"{tiny['library_bwd_by']} (CUDA events where the "
                   "profiler saw no device activity); its forward + "
                   "backward by events "
                   f"{tiny['library_fwd_bwd_ms']:.4f} ms against the "
                   f"kernels' {tiny['fwd_bwd_events_ms']:.4f} ms",
        "entries": "D + dK/dV (+ the group sum) + dQ, a CUDA graph of 20",
        "shapes": bwd["rows"], "ptxas": bwd["ptxas"], "build": bwd["build"],
        "golden_distance": dist, "plain_golden_distance": dist_plain,
        "full_depth_distance": dist_full, "whisper_distance": wdist,
        "whisper_backward_distance": wbwd, "whisper_floor": wfloor,
        "whisper_dq_in_place_shares": dq_shares,
        "example": {"first_loss": a[0], "last_loss": a[last],
                    "resumed_last_loss": b[last], "bitwise": bitwise,
                    "seconds": ex_s},
        "train_step": {"ms": wall * 1e3, "tokens_per_s": tok_s,
                       "flops": flops,
                       "peak_share": flops / wall / PEAK_OPS["bf16"],
                       "peak_gib": peak, "busy_ms": busy,
                       "by_name": by_name, "microbatches": mb},
        "phase_s": time.time() - t_phase}]
    # each entry on its own, at the tinyllama shape (the sum's error against
    # its plain version on the same partials, worst over the shapes with a
    # group; the dK / dV and dQ entries' plain version is the whole plain
    # backward)
    errs = lambda *names: max(r["errs"][n]["max_abs_err"]
                              for r in bwd["rows"] for n in names)
    plain_all = ("autograd of the f32 reference, all three gradients at "
                 "once")
    # the hd 256 entries at recurrentgemma-2b's B 2 x 2 048, launched by
    # its train step
    rg_row = next(r for r in bwd["rows"] if r["shape"][5] == 256
                  and r["shape"][0] == 2)
    # B 1 x 2 100, where the window masks pairs: SDPA takes it as a mask
    win_row = next(r for r in bwd["rows"] if r["shape"][5] == 256
                   and r["shape"][0] == 1)
    rg = zoo_steps["recurrentgemma-2b"]["launches"]
    errs256 = lambda *names: max(r["errs"][n]["max_abs_err"]
                                 for r in bwd["rows"] if r["shape"][5] == 256
                                 for n in names)
    for name, key, count, err in (
            ("flash_bwd_dkdv_wgmma_hd256", "dkdv", "bwd_dkdv",
             errs256("dk", "dv")),
            ("flash_bwd_dq_wgmma_hd256", "dq", "bwd_dq", errs256("dq"))):
        b_ms, b_by = rg_row["entry_bounds"][key]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": rg[count],
            "max_abs_err": err, "ms": rg_row[f"{key}_ms"],
            "plain_ms": rg_row["plain_ms"], "plain": plain_all,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": rg_row["library_bwd_ms"],
            "library": "SDPA's backward alone (the whole backward), "
                       "is_causal: the 2 048 window masks no pair at S "
                       "2 048",
            "library_window_mask_ms": win_row["library_bwd_ms"],
            "library_window_mask_shape": win_row["shape"],
            "shape": rg_row["shape"], "launches_step": rg,
            "ptxas": {k: v for k, v in bwd["ptxas"].items()
                      if k.split(":")[1] == "256"}})
    ss, rs = scan_bwd["ssm"], scan_bwd["rglru"]
    fm = zoo_steps["falcon-mamba-7b"]["launches"]
    none_lib = "none: no PyTorch call computes this loop"
    rows += [{
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "none: XLA differentiates src/repro/models/ssm.py:130 "
                    "(the jax.checkpoint-ed chunk body under lax.scan)",
        "launches": fm["ssm_bwd"], "max_abs_err": ss["max_abs_err"],
        "dc_share": ss["dc_share"], "ms": ss["ms"],
        "plain_ms": ss["plain_ms"], "bound_ms": ss["bound_ms"],
        "bound_by": ss["bound_by"], "library_ms": None,
        "library": none_lib, "shape": ss["shape"],
        "train_forward_ms": ss["train_ms"],
        "serve_forward_ms": ss["serve_ms"],
        "train_forward_bound_ms": ss["train_bound_ms"],
        "launches_step": fm, "step": zoo_steps["falcon-mamba-7b"]}, {
        "name": "ssm_scan_dc_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "none: XLA's sum over channels in the same "
                    "differentiation",
        "launches": fm["ssm_bwd_sum"], "max_abs_err": ss["max_abs_err"],
        "ms": ss["sum_ms"], "plain_ms": ss["sum_plain_ms"],
        "plain": "torch sum of the same partials over the blocks",
        "bound_ms": ss["sum_bound_ms"], "bound_by": "bytes",
        "library_ms": ss["sum_plain_ms"],
        "library": "torch.sum over the blocks' dim (one call)",
        "shape": ss["shape"],
        "ptxas": {k: v for k, v in scan_bwd["ptxas"].items()
                  if k.startswith("ssm_scan_dc_sum")}}, {
        "name": "ssm_scan_train", "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:43 (the training "
                    "instantiation also writes every h_t)",
        "launches": fm["ssm_scan_train"], "max_abs_err": ss["train_err"],
        "ms": ss["train_ms"], "plain_ms": ss["train_plain_ms"],
        "plain": "ref.ssm_scan_ref (its h_t are the loop's)",
        "bound_ms": ss["train_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "library": none_lib, "shape": ss["shape"]}, {
        "name": "rglru_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "none: XLA differentiates src/repro/models/rglru.py:"
                    "38-47 (_gates) and :76-91 (the scan)",
        "launches": rg["rglru_bwd"], "max_abs_err": rs["max_abs_err"],
        "dnsp_share": rs["dnsp_share"], "ms": rs["ms"],
        "plain_ms": rs["plain_ms"], "bound_ms": rs["bound_ms"],
        "bound_by": rs["bound_by"], "library_ms": None,
        "library": none_lib, "shape": rs["shape"], "launches_step": rg,
        "ptxas": scan_bwd["ptxas"].get("rglru_scan_bwd_kernel"),
        "smem_bytes": rs["smem_bytes"], "tiled_equal": rs["tiled_equal"],
        "step": zoo_steps["recurrentgemma-2b"],
        "moe_step": zoo_steps["phi3.5-moe-42b-a6.6b"]}]
    for name, key, count, err, plain, note in (
            ("flash_bwd_dot", "dot", "bwd_dot",
             max(r["dot_err"] for r in bwd["rows"]), tiny["dot_plain_ms"],
             "rowsum(dO (O + O_lo)) in f32"),
            ("flash_bwd_dkdv_wgmma", "dkdv", "bwd_dkdv", errs("dk", "dv"),
             tiny["plain_ms"], plain_all),
            ("flash_bwd_sum", "sum", "bwd_sum", bwd["sum_err"],
             tiny["sum_plain_ms"], "the partials' sum over the group (torch "
             "sum, one bf16 cast)"),
            ("flash_bwd_dq_wgmma", "dq", "bwd_dq", errs("dq"),
             tiny["plain_ms"], plain_all)):
        b_ms, b_by = tiny["entry_bounds"][key]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[count],
            "max_abs_err": err, "ms": tiny[f"{key}_ms"], "plain_ms": plain,
            "plain": note, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": tiny["shape"]})
    return rows


# --------------------------------------------------------------------------
# phase 25: fault-tolerant training, the attention strategies, a mesh
# --------------------------------------------------------------------------

#: phase 25 (b): ``blocked_attention`` against the flash kernel at these
#: (B, S, H, K, hd, causal, window) and ``split_kv_decode_attention``
#: against the decode kernel at these ``DECODE_FULL`` rings (B, H, K, hd,
#: W, window, filled slots) with the splits asked for (W 4 100 is no
#: multiple of 8: one split)
STRATEGY_FLASH = [(4, 500, 32, 4, 64, True, 0),
                  (1, 2048, 24, 8, 128, True, 0)]
STRATEGY_DECODE = [((4, 32, 4, 64, 520, 0, 516), 8),
                   ((4, 48, 1, 128, 4100, 0, 5001), 4),
                   ((4, 48, 1, 128, 4100, 0, 5001), 8)]


def state_distance(ex, a: dict, b: dict) -> float:
    """The largest relative distance ``|x - y|_2 / |y|_2`` over the two
    runs' leaves (the drill example ``ex``'s ``state_leaves``; 0.0 when
    every leaf is bitwise equal)."""
    import torch
    worst = 0.0
    for x, y in zip(ex.state_leaves(a), ex.state_leaves(b), strict=True):
        if torch.equal(x, y):
            continue
        d = float((x.double() - y.double()).norm())
        worst = max(worst, d / max(float(y.double().norm()), 1e-30))
    return worst


def close_share(got, want, tol: float) -> tuple[float, float]:
    """``(max |got - want|, worst share of tol + tol |want|)``: numpy's
    ``assert_allclose`` rule with ``tests/test_kernels.py``'s limit."""
    w = want.float()
    d = (got.float() - w).abs()
    return float(d.max()), float((d / (tol + tol * w.abs())).max())


def strategy_phase(fk, pk, dev) -> dict:
    """Phase 25 (b): ``repro``'s two XLA strategies (the port's plain
    PyTorch) against the kernels that stand in for them on the card."""
    import torch
    from repro_torch.models import layers
    out = {"flash": [], "decode": []}
    for i, case in enumerate(STRATEGY_FLASH):
        B, S, H, K, hd, causal, window = case
        q, k, v = (seeded(shape, 500 + 10 * i + j, torch.bfloat16, dev)
                   for j, shape in enumerate(((B, S, H, hd), (B, S, K, hd),
                                              (B, S, K, hd))))
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        got = fk.flash_attention(q, k, v, causal=causal, window=window)
        want = layers.blocked_attention(q, k, v, pos, pos, causal, window)
        err, share = close_share(got, want, FLASH_TOL["bf16"])
        out["flash"].append({"shape": list(case), "max_abs_err": err,
                             "share": share})
        print(f"  (b) blocked_attention vs the flash kernel, B{B} S{S} H{H} "
              f"K{K} hd{hd} bf16: max |d| {err:.3g}, worst share of "
              f"{FLASH_TOL['bf16']} + {FLASH_TOL['bf16']} |plain| "
              f"{share:.3g}", flush=True)
        check(share <= 1.0, f"blocked_attention disagrees with the flash "
                            f"kernel at {case}")
    for i, (case, n_splits) in enumerate(STRATEGY_DECODE):
        B, H, K, hd, W, window, fill = case
        q, kc, vc, kv_pos, q_pos = decode_case(case, 600 + 10 * i, dev)
        got = pk.decode_attention(q, kc, vc, kv_pos, q_pos, window=window)
        want = layers.split_kv_decode_attention(
            q[:, None], kc, vc, kv_pos, q_pos, window, n_splits)[:, 0]
        err, share = close_share(got, want, DECODE_TOL)
        ns = n_splits if W % n_splits == 0 else 1
        out["decode"].append({"shape": list(case), "n_splits": ns,
                              "max_abs_err": err, "share": share})
        print(f"  (b) split_kv_decode_attention ({ns} split{'s' * (ns > 1)}) "
              f"vs the decode kernel, B{B} H{H} K{K} hd{hd} W{W}: max |d| "
              f"{err:.3g}, "
              f"worst share of {DECODE_TOL} + {DECODE_TOL} |plain| "
              f"{share:.3g}", flush=True)
        check(share <= 1.0, f"split_kv_decode_attention disagrees with the "
                            f"decode kernel at {case}, {ns} splits")
    return out


def mesh_restore(ckpt_dir: str, run: dict, defs, dev) -> dict:
    """Phase 25 (c): a one-rank ``nccl`` group, the host mesh, and the
    checkpoint restored into DTensor leaves against the plain restore."""
    import datetime
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import shard_params
    opt = run["opt"]
    template = {"params": run["model"].tree(), "opt": opt}
    store = tempfile.mkdtemp(dir=ROOT / "build")
    torch.cuda.set_device(0 if dev.index is None else dev.index)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh()
        target = {"params": shard_params(template["params"], defs, mesh),
                  "opt": opt._replace(m=shard_params(opt.m, defs, mesh),
                                      v=shard_params(opt.v, defs, mesh),
                                      master=shard_params(opt.master, defs,
                                                          mesh))}
        t0 = time.perf_counter()
        dtree, step, _ = ckpt.restore(ckpt_dir, target)
        torch.cuda.synchronize()
        d_s = time.perf_counter() - t0
        plain, step_p, _ = ckpt.restore(ckpt_dir, template)
        named, plain_named = ckpt._flatten(dtree), dict(ckpt._flatten(plain))
        n_dt = equal = 0
        places = set()
        for name, v in named:
            if hasattr(v, "full_tensor"):
                n_dt += 1
                places.add(tuple(repr(p) for p in v.placements))
                v = v.full_tensor()
            equal += bool(v.dtype == plain_named[name].dtype
                          and torch.equal(v, plain_named[name]))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(f"  (c) a one-rank nccl group, make_host_mesh() "
          f"{tuple(mesh.shape)} {mesh.mesh_dim_names}: step {step} restored "
          f"into {n_dt} DTensor leaves (placements {sorted(places)}) in "
          f"{d_s:.2f} s; {equal} of {len(named)} leaves bitwise equal to "
          f"the plain restore", flush=True)
    check(step == step_p and n_dt > 0 and equal == len(named),
          "the DTensor restore differs from the plain restore")
    return {"leaves": len(named), "dtensor_leaves": n_dt,
            "placements": sorted(places), "restore_s": d_s}


def ft_phase(golden_mod, smi: str, device="cuda") -> dict:
    """Phase 25; returns the drill's flash launches and its numbers."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.models import zoo
    dev = torch.device(device)
    t_phase = time.time()
    phase("25: fault-tolerant training (the drill), the attention "
          "strategies, a one-rank mesh")
    F, rec = golden_mod.FT, golden_mod.load_ft()
    ex = load_example("fault_tolerance_torch")
    argv = ["--full-width", "--layers", str(F["layers"]), "--seq",
            str(F["seq"]), "--batch", str(F["batch"]), "--device", device]
    cfg = ex.model_config(True, F["layers"])

    # (a) two straight runs: the step's own determinism, measured before
    # the drill, sets its limit
    zero_train_counts(fops)
    first = ex.straight(argv)
    torch.cuda.synchronize()
    per40 = train_counts(fops)
    second = ex.straight(argv)
    floor = state_distance(ex, second, first)
    limit = 4 * floor
    del second
    torch.cuda.empty_cache()
    per_step = {k: v // 40 for k, v in per40.items()}
    print(f"  (a) two straight 40-step runs: relative distance {floor:g} "
          f"(0 = bitwise); the drill's limit {limit:g}; flash launches a "
          f"step {per_step}", flush=True)
    check(all(v % 40 == 0 and v > 0 for v in per40.values())
          and per_step["bwd_dkdv"] == per_step["bwd_dq"] == cfg.n_layers,
          f"a straight run's flash launches are not a fixed count a step "
          f"over its {cfg.n_layers} layers: {per40}")
    ckpt_dir = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        zero_train_counts(fops)
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            drill = ex.main(argv + ["--ckpt-dir", ckpt_dir])
        torch.cuda.synchronize()
        drill_s = time.time() - t0
        launches = train_counts(fops)
        rep = drill["report"]
        lines = out.getvalue().splitlines()
        losses = [v for _, v in drill["losses"]]
        dist = state_distance(ex, drill, first)
        last = os.path.join(ckpt_dir, "step_00000040")
        gb = sum(f.stat().st_size for f in Path(last).iterdir()) / 1e9
        step_ms = statistics.median(drill["step_s"]) * 1e3
        print(f"  (a) the drill: tinyllama-1.1b {cfg.n_layers} layers "
              f"(published widths, {cfg.n_params() / 1e6:.0f} M parameters), "
              f"B{F['batch']} x {F['seq']}, {len(losses)} steps in "
              f"{drill_s:.1f} s: step {step_ms:.2f} ms (median), saves "
              f"{', '.join(f'{x:.2f}' for x in drill['save_s'])} s, restore "
              f"{drill['restore_s'][0]:.2f} s, checkpoint {gb:.3f} GB; "
              f"report {rep}; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"flash launches {launches}; relative distance from the "
              f"straight run {dist:g}", flush=True)
        for ln in lines:
            print(f"      | {ln}")
        want = rec["report"]
        check(lines == rec["lines"] and rep.steps_done == want["steps_done"]
              and rep.failures == want["failures"]
              and rep.redispatches == want["redispatches"]
              and [list(r) for r in rep.remeshes] == want["remeshes"]
              and rep.restored_from == want["restored_from"],
              "the drill's report or lines differ from golden_ft.json")
        check(len(losses) == 48 and all(map(math.isfinite, losses))
              and losses[-1] < losses[0],
              "the drill's losses are not finite or did not fall")
        check(launches == {k: v * 48 for k, v in per_step.items()},
              f"the drill's flash launches {launches} are not 48 steps' "
              f"{per_step}")
        check(dist <= limit, f"the drill ends {dist:g} from the straight "
                             f"run (limit {limit:g})")
        nums = {"step_ms": step_ms, "save_s": drill["save_s"],
                "restore_s": drill["restore_s"][0], "checkpoint_gb": gb,
                "drill_s": drill_s, "distance": dist, "floor": floor,
                "first_loss": losses[0], "last_loss": losses[-1]}
        del first
        strat = strategy_phase(fk, pk, dev)
        mesh = mesh_restore(ckpt_dir, drill, zoo.model_defs(cfg), dev)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del drill
    torch.cuda.empty_cache()
    wall = time.time() - t_phase
    print(f"  phase 25 {wall:.1f} s; card: {smi}", flush=True)
    return {"launches": launches, "per_step": per_step, **nums,
            "strategies": strat, "mesh": mesh, "phase_s": wall}


# --------------------------------------------------------------------------
# phase 26: the dry run
# --------------------------------------------------------------------------

#: phase 26 (a): measured peak over counted memory, allowed range (the
#: count is the tensors the step holds; what earlier phases left
#: allocated, the caching allocator's rounding and the libraries'
#: workspaces come on top: PERF.md section 6)
DRYRUN_MEM_RATIO = (1.0, 1.25)
#: phase 26 (b): the cells run through ``run_cell`` (arch, shape, 2 pods)
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", False),
                ("tinyllama-1.1b", "decode_32k", True))


def dryrun_flops(cfg, B: int, S: int) -> float:
    """``train_flops`` less what no product of the port's step does: the
    remat's recomputation stops at the last saved tensor, so each layer's
    last product (the MLP's down projection, 2 d_ff d a token) runs once,
    not twice; and the norm scales, counted among the parameters, feed
    no product (8 a parameter a token)."""
    n_norm = cfg.d_model * (2 * cfg.n_layers + 1)
    return (train_flops(cfg, B, S)
            - 2.0 * cfg.d_ff * cfg.d_model * B * S * cfg.n_layers
            - 8.0 * n_norm * B * S)


def dryrun_cells() -> list:
    """``run_cell`` over ``DRYRUN_CELLS`` in a fresh process (a ``fake``
    process group of 256 / 512 ranks in it), each record with its wall
    seconds."""
    code = (f"import json, sys, time; sys.path.insert(0, "
            f"{str(ROOT / 'src')!r}); "
            "from repro_torch.launch import dryrun; out = []\n"
            f"for a, s, mp in {DRYRUN_CELLS!r}:\n"
            "    t0 = time.time(); r = dryrun.run_cell(a, s, mp)\n"
            "    r['wall_s'] = time.time() - t0; r.pop('traceback', None)\n"
            "    out.append(r)\n"
            "print(json.dumps({'cells': out, "
            "'rss_gib': dryrun.peak_rss_gib()}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"the dry run's subprocess failed: "
                               f"{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def dryrun_phase(smi: str, peak_gib: float, step_launches: dict) -> dict:
    """Phase 26; ``peak_gib`` and ``step_launches``: phase 24 (e)'s
    ``max_memory_allocated`` and flash launches a step."""
    from repro_torch.configs import get
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig
    t_phase = time.time()
    phase("26: the dry run (the op counter on meta tensors, meta DTensors "
          "over a fake group)")
    TT = TRAIN_TIMED
    full = get("tinyllama-1.1b")
    t0 = time.time()
    per, arg_b, mb = dryrun.analyze_step(
        full, ShapeConfig("train", TT["seq"], TT["batch"], "train"))
    count_s = time.time() - t0
    want = dryrun_flops(full, TT["batch"], TT["seq"])
    pred_gib = (arg_b + per["peak_temp_bytes"]) / 2 ** 30
    ratio = peak_gib / pred_gib
    calls = {k: v["calls"] for k, v in per["kernels"].items()}
    print(f"  (a) tinyllama-1.1b full train step B{TT['batch']} x "
          f"{TT['seq']} ({mb} microbatch) counted on meta tensors in "
          f"{count_s:.1f} s: {per['flops']:.6g} FLOPs (train_flops less "
          f"the remat's early stop and the norms: {want:.6g}; "
          f"train_flops {train_flops(full, TT['batch'], TT['seq']):.6g}); "
          f"kernel calls {calls} (phase 24 (e) launches a step "
          f"{step_launches}); memory counted {pred_gib:.2f} GiB "
          f"(arguments {arg_b / 2 ** 30:.2f}, peak temporaries "
          f"{per['peak_temp_bytes'] / 2 ** 30:.2f}) against {peak_gib:.2f} "
          f"GiB measured in phase 24 (e): {ratio:.3f}x (limit "
          f"{DRYRUN_MEM_RATIO[0]}-{DRYRUN_MEM_RATIO[1]}x)", flush=True)
    check(abs(per["flops"] - want) <= 1e-9 * want,
          f"the counted FLOPs {per['flops']} differ from {want}")
    check(calls.get("flash_attention") == step_launches["flash"]
          and calls.get("flash_attention_bwd") == step_launches["bwd_dkdv"],
          f"the counted kernel calls {calls} differ from the launches "
          f"{step_launches}")
    check(DRYRUN_MEM_RATIO[0] <= ratio <= DRYRUN_MEM_RATIO[1],
          f"measured peak over counted memory {ratio:.3f} outside "
          f"{DRYRUN_MEM_RATIO}")
    sub = dryrun_cells()
    for r in sub["cells"]:
        print(f"  (b) run_cell {r['arch']} {r['shape']} {r['mesh']}: "
              f"{r['status']} in {r['wall_s']:.1f} s"
              + (f" (trace {r['trace_s']} s): {r['hlo_flops_per_dev']:.4g} "
                 f"FLOPs, {r['hlo_bytes_per_dev']:.4g} bytes, "
                 f"{r['coll_bytes_per_dev']:.4g} collective bytes a device, "
                 f"{r['hbm_gb_per_device']} GiB, {r['bound']}-bound "
                 f"(counted against H100 data-sheet rates)"
                 if r["status"] == "ok" else f": {r.get('error')}"),
              flush=True)
    print(f"  (b) subprocess peak RSS {sub['rss_gib']:.2f} GiB", flush=True)
    check(all(r["status"] == "ok" for r in sub["cells"]),
          "a dry-run cell is not ok")
    wall = time.time() - t_phase
    print(f"  phase 26 {wall:.1f} s; card: {smi}", flush=True)
    return {"flops": per["flops"], "flops_want": want, "pred_gib": pred_gib,
            "peak_gib": peak_gib, "calls": calls, "cells": sub["cells"],
            "phase_s": wall}


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


def direct_mismatches(sim, res, exp, which, rltl: bool,
                      device="cuda") -> int:
    """The Experiment's cells against a direct ``sweep()`` of each trace
    named in ``which`` (its trace-dim labels) on the card."""
    _, _, cfgs = exp.expand()
    dim = exp.trace_dim
    bad = 0
    for label in which:
        batch = exp.traces[label]
        row = res.sel(**{dim: label})
        for a, b in zip(sim.sweep(batch, cfgs, rltl=rltl, device=device),
                        row.cells.flat):
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


# --------------------------------------------------------------------------
# phase 17: the FR-FCFS controller tier (the sim_window entry)
# --------------------------------------------------------------------------

#: the window entry's dependent chain a step (PERF.md section 6),
#: SM cycles, in the cost model of ``CHAIN`` (4 an ALU op, ~30 a
#: shared-memory load and a warp collective): the in-order path's
#: ``CHAIN_CYCLES``; the selection (a slot's fields, then its bank's open
#: row, 6 ALU ops, two warp reductions: the key, then the slot); a
#: successful admission (the core's position, then its MSHR slot, front
#: record and gates, 10 ALU ops for the slot index and the issue time,
#: two reductions: the time, then the core, and the owner's stores read
#: back by the next attempt); and a failed one (the same loads and ALU
#: ops, one reduction)
WINDOW_SELECT_CYCLES = 2 * 30 + 6 * 4 + 2 * 30
WINDOW_ADMIT_CYCLES = 2 * 30 + 10 * 4 + 2 * 30 + 30
WINDOW_FAIL_CYCLES = 2 * 30 + 10 * 4 + 30
WINDOW_STEP_CYCLES = (CHAIN_CYCLES + WINDOW_SELECT_CYCLES
                      + WINDOW_ADMIT_CYCLES + WINDOW_FAIL_CYCLES)
#: requests a core of the window entry's kernel-vs-plain comparison (4
#: cores: ~1 000 steps)
WINDOW_CUT_REQ = 250
#: the window depth of phase 17's launches (the largest window they hold)
WINDOW_DEPTH = 16


def window_cut_grid(sim, with_workload=None):
    """Phase 17 (a)'s 8 points: frfcfs windows 4, 8 and 16 with in-order
    riders, on the default geometry and on 2 channels x 2 ranks (where
    tRRD and tFAW bind), both row policies; one launch of depth 16."""
    from repro_torch.core.dram import DRAMConfig
    d2 = DRAMConfig(n_channels=2, n_ranks=2, n_banks=8)
    points = (("base", "frfcfs", 4, None, "closed"),
              ("chargecache", "frfcfs", 8, None, "closed"),
              ("rltl", "inorder", 1, None, "open"),
              ("cc_aldram", "frfcfs", 16, None, "open"),
              ("base", "frfcfs", 16, d2, "closed"),
              ("chargecache", "frfcfs", 8, d2, "open"),
              ("nuat", "inorder", 1, d2, "closed"),
              ("cc_nuat", "frfcfs", 4, d2, "open"))
    grid = []
    for kind, ctrl, w, dram, pol in points:
        kw = {} if dram is None else {"dram": dram}
        cfg = sim.SimConfig(mech=sim.MechanismConfig(kind=kind),
                            controller=ctrl, window=w, policy=pol, **kw)
        if with_workload is not None:
            cfg = dataclasses.replace(cfg, workload=with_workload)
        grid.append(cfg)
    return grid


def window_full_inputs(sim, traces, golden_mod, device="cuda"):
    """Phase 17's two full-size launches: ``(golden, study)``, each
    ``(grid, launch arguments)`` — the eight-core golden trace under
    {base, chargecache} x {in-order, frfcfs w8, w16} (``ops.run_window``'s
    arguments at depth ``WINDOW_DEPTH``), and ``figures/frfcfs.py``'s
    unique points at the thesis size (``ops.run_window_synth``'s, the
    depth and ``collect_events`` to add)."""
    import torch
    from repro_torch.experiment import runner
    from repro_torch.figures import common as C, frfcfs
    gold = golden_mod.load_frfcfs()
    batch8 = golden_mod.load_batch(traces, gold["workload"])
    tiers = (("inorder", 1),) + tuple(("frfcfs", w)
                                      for w in golden_mod.FRFCFS["windows"])
    grid6 = [sim.SimConfig(mech=sim.MechanismConfig(kind=k),
                           policy=gold["policy"], controller=c, window=w)
             for k in golden_mod.FRFCFS["kinds"] for c, w in tiers]
    b_args = launch_inputs(sim, batch8, grid6, device=device)
    b_args = (b_args[0], WINDOW_DEPTH) + b_args[1:]
    _, _, cfgs = frfcfs.experiment(C.THESIS.n_req_8c).expand()
    study = runner._dedup(cfgs, True, "synth")[0]
    d_args = sim._stage_synth(study, None, torch.device(device))
    return (grid6, b_args), (study, d_args)


def window_chain_bound_ms(n_steps: int, mhz: float) -> float:
    return n_steps * WINDOW_STEP_CYCLES / (mhz * 1e3)


def window_phase(sim, traces, golden_mod, kernel, ops, ref, regs,
                 device="cuda"):
    """Phase 17: (a) the window entry against the plain window engine on
    the card, trace and synthesis feeds; (b) the eight-core golden trace
    at full size against ``golden_frfcfs.json``; (c) that launch's
    in-order riders against the trace entry; (d) ``figures/frfcfs.py``'s
    grid at full size, the main path of this slice, against ``repro``'s
    run of the study.  Returns the kernels-line entry."""
    import torch
    from repro_torch.figures import common as C, frfcfs
    dev = torch.device(device)
    W = WINDOW_DEPTH
    t_phase = time.time()

    # (a) kernel against plain version, both on the card
    batch = traces.multicore_batch(["mcf_like", "stream_copy_like",
                                    "lbm_like", "gcc_like"], WINDOW_CUT_REQ,
                                   seed=5)
    grid = window_cut_grid(sim)
    staged = sim._stage(batch, grid, dev)
    a_args = (staged[0], W) + staged[1:] + (True,)
    got = ops.run_window(*a_args)
    torch.cuda.synchronize()
    plain_ms, want = cuda_ms(lambda: ref.run_window_ref(*a_args),
                             torch.cuda.synchronize)
    a_bad, a_err = compare_outputs(got, want)
    cut_ms = median_ms(lambda: ops.run_window(*a_args))
    a_mhz = sm_clock_mhz(lambda: ops.run_window(*a_args))
    a_chain = window_chain_bound_ms(staged[6], a_mhz)
    print(f"  (a) trace feed, {len(grid)} points (windows 4/8/16, in-order "
          f"riders, 1 x 1 and 2 x 2 channels x ranks) x {staged[6]} steps: "
          f"kernel {cut_ms:.3f} ms ({cut_ms * 1e6 / staged[6]:.1f} ns/step, "
          f"{100 * a_chain / cut_ms:.1f} % of the chain bound at "
          f"{a_mhz:.0f} MHz), plain {plain_ms:.0f} ms, mismatches {a_bad}",
          flush=True)
    spec = traces.WorkloadSpec(names=("stream_copy_like", "mcf_like",
                                      "lbm_like", "libquantum_like"),
                               n_req=WINDOW_CUT_REQ, seed=7)
    sgrid = window_cut_grid(sim, with_workload=spec)
    y = sim._stage_synth(sgrid, None, dev)
    got = ops.run_window_synth(y[0], W, *y[1:], True, True)
    torch.cuda.synchronize()
    want = ref.run_window_synth_ref(y[0], W, *y[1:], True, True)
    s_bad = compare_streams(got[3], want[3])
    b, e = compare_outputs(got[:3], want[:3])
    s_bad += b
    a_err = max(a_err, e)
    y_ms = median_ms(lambda: ops.run_window_synth(y[0], W, *y[1:], True))
    print(f"  (a) synthesis feed, {len(sgrid)} points x {y[7]} steps: "
          f"kernel {y_ms:.3f} ms ({y_ms * 1e6 / y[7]:.1f} ns/step with the "
          f"pre-pass, {100 * window_chain_bound_ms(y[7], a_mhz) / y_ms:.1f} "
          f"% of the chain bound); streams and outputs, mismatches {s_bad}",
          flush=True)
    # the general controller (past 32 cores or 32 slots): 40 cores at the
    # depth of the cut grid, 8 cores at depth 40
    g_bad = 0
    for n_cores, depth in ((40, W), (8, 40)):
        gb = traces.multicore_batch(
            [("mcf_like", "stream_copy_like", "lbm_like", "gcc_like")[c % 4]
             for c in range(n_cores)], 320 // n_cores, seed=5)
        gg = [sim.SimConfig(mech=sim.MechanismConfig(kind=k),
                            controller=c, window=w, policy=p)
              for k, c, w, p in (("chargecache", "frfcfs", depth, "open"),
                                 ("base", "frfcfs", 4, "closed"),
                                 ("rltl", "inorder", 1, "closed"))]
        st_g = sim._stage(gb, gg, dev)
        g_args = (st_g[0], depth) + st_g[1:] + (True,)
        b, e = compare_outputs(ops.run_window(*g_args),
                               ref.run_window_ref(*g_args))
        g_bad += b
        a_err = max(a_err, e)
    print(f"  (a) the general controller (40 cores at depth {W}, 8 cores at "
          f"depth 40, with a rider): mismatches {g_bad}", flush=True)
    check(a_bad + s_bad + g_bad == 0,
          "sim_window disagrees with the plain engine")

    # (b) the golden eight-core trace at full size, one launch of 6 points
    gold = golden_mod.load_frfcfs()
    batch8 = golden_mod.load_batch(traces, gold["workload"])
    kinds = golden_mod.FRFCFS["kinds"]
    tiers = (("inorder", 1),) + tuple(("frfcfs", w)
                                      for w in golden_mod.FRFCFS["windows"])
    (grid6, b_args), (study_grid, d_args) = window_full_inputs(
        sim, traces, golden_mod, device)
    scan_blocks = [f"{c.mech.kind} {c.controller}" for c in grid6
                   if c.controller == "inorder"]
    out = ops.run_window(*b_args)
    res6 = sim._drain(out, grid6, lambda i: batch8.length, None)
    b_bad = 0
    for p in gold["points"]:
        r = res6[grid6.index(sim.SimConfig(
            mech=sim.MechanismConfig(kind=p["kind"]), policy=gold["policy"],
            controller="frfcfs", window=p["window"]))]
        for key in gold["bitwise_keys"] + ["core_end", "rltl_hist",
                                           "rltl_total", "bank_acts",
                                           "bank_act_ras_sum"]:
            want_v = p[key]
            got_v = ([int(x) for x in r[key]] if isinstance(want_v, list)
                     else int(r[key]))
            if got_v != want_v:
                b_bad += 1
                print(f"  MISMATCH {p['kind']} w{p['window']}.{key}: got "
                      f"{got_v} want {want_v}")
    n8 = gold["n_steps"]
    ms8 = median_ms(lambda: ops.run_window(*b_args))
    mhz = sm_clock_mhz(lambda: ops.run_window(*b_args))
    chain8 = window_chain_bound_ms(n8, mhz)
    prow = kernel.pack(b_args[2], b_args[5])[0].shape[1]
    nbytes = bytes_moved(batch8, len(grid6), b_args[4].shape[0], n8, prow,
                         b_args[0].envelope.max_banks_total,
                         b_args[2].thermal.seg_edge.shape[-1])
    bound8 = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  (b) eight-core golden trace, {len(grid6)} points x {n8} steps "
          f"(frfcfs w8 / w16 and in-order riders, base and chargecache; "
          f"blocks on the scan's path, run_point: {scan_blocks}): "
          f"{b_bad} values differ from golden_frfcfs.json; kernel "
          f"{ms8:.2f} ms ({ms8 * 1e6 / n8:.1f} ns/step), chain bound "
          f"{chain8:.2f} ms at {mhz:.0f} MHz ({WINDOW_STEP_CYCLES} cycles a "
          f"step: {CHAIN_CYCLES} the in-order path + {WINDOW_SELECT_CYCLES} "
          f"selection + {WINDOW_ADMIT_CYCLES} admission + "
          f"{WINDOW_FAIL_CYCLES} failed admission; "
          f"{100 * chain8 / ms8:.1f} % reached), bytes bound {bound8:.4f} "
          f"ms", flush=True)
    for i, k in enumerate(kinds):
        rows = [res6[i * len(tiers) + j] for j in range(len(tiers))]
        print("    " + k + ": " + ", ".join(
            f"{c}{'' if c == 'inorder' else f' w{w}'} hit rate "
            f"{r['row_hits'] / max(r['n_req'], 1):.4f} cycles "
            f"{r['total_cycles']}" for (c, w), r in zip(tiers, rows)))
    check(b_bad == 0, "sim_window disagrees with repro's golden FR-FCFS run")

    # (c) the in-order riders of that launch against the trace entry
    ridx = [i for i, cfg in enumerate(grid6) if cfg.controller == "inorder"]
    c_args = launch_inputs(sim, batch8, [grid6[i] for i in ridx],
                           device=device)
    step_out = ops.run_sweep(*c_args)
    rider = ({k: v[ridx] for k, v in out[0].items()}, out[1][ridx],
             type(out[2])(*(lane[ridx] for lane in out[2])))
    c_bad, _ = compare_outputs(rider, step_out)
    c_ms = median_ms(lambda: ops.run_sweep(*c_args))
    print(f"  (c) the launch's {len(ridx)} in-order riders against "
          f"sim_step_kernel on the same points: mismatches {c_bad}; "
          f"sim_step_kernel {c_ms:.2f} ms ({c_ms * 1e6 / n8:.1f} ns/step, "
          f"{100 * chain_bound_ms(n8, mhz) / c_ms:.1f} % of its own chain "
          f"bound); in the window launch they run the same scan "
          f"(run_point), the launch taking {ms8 * 1e6 / n8:.1f} ns/step for "
          f"its slowest (frfcfs) block", flush=True)
    check(c_bad == 0, "in-order riders differ from the trace entry")

    # (d) figures/frfcfs.py at full size: the main path of this slice
    ops.launches = ops.synth_launches = ops.window_launches = 0
    t0 = time.time()
    res, _ = frfcfs.frfcfs_grid(C.THESIS.n_req_8c, device=device)
    fig_s = time.time() - t0
    main_launches = {"sim_window": ops.window_launches,
                     "sim_step": ops.launches,
                     "sim_synth": ops.synth_launches}
    cell = lambda m, c, w: res.sel(mechanism=m, controller=c,
                                   window=w).cells.flat[0]
    fig = {**frfcfs.summarize(cell), "us": fig_s * 1e6,
           "launches": main_launches["sim_window"]}
    for row in frfcfs.rows(fig):
        print(f"  (d) {row}")
    print(f"  (d) figures/frfcfs.py's grid at {C.THESIS.n_req_8c} requests "
          f"a core x 8 cores, {res.meta['n_unique']} unique points: "
          f"{fig_s:.1f} s wall; launches {main_launches}", flush=True)
    check(main_launches["sim_window"] == 1 and res.meta["n_kernel_launches"]
          == 1, "figures/frfcfs.py made other than one sim_window launch")
    # the figure's launch alone (timed outside the counted run) and its
    # stream, held with every cell to repro's run of benchmarks/frfcfs.py
    d_ms = median_ms(lambda: ops.run_window_synth(d_args[0], W,
                                                  *d_args[1:], False))
    d_mhz = sm_clock_mhz(lambda: ops.run_window_synth(d_args[0], W,
                                                      *d_args[1:], False))
    d_steps = d_args[7]
    d_scan = [f"{c.mech.kind} {c.controller}" for c in study_grid
              if c.controller == "inorder"]
    print(f"  (d) its launch alone: {len(d_args[4])} points x {d_steps} "
          f"steps (blocks on the scan's path: {d_scan}), {d_ms:.2f} ms "
          f"({d_ms * 1e6 / d_steps:.1f} ns/step with "
          f"the pre-pass, "
          f"{100 * window_chain_bound_ms(d_steps, d_mhz) / d_ms:.1f} % of "
          f"the chain bound at {d_mhz:.0f} MHz)", flush=True)
    study = gold["study"]
    stream = kernel.sim_window_synth(d_args[0], W, *d_args[1:7], 0, False,
                                     True)[3]
    same_stream = (golden_mod.trace_sha256(point_batch(traces, stream, 0))
                   == study["stream_sha256"])
    want = {(g["mechanism"], g["controller"], g["window"]): g
            for g in study["cells"]}
    d_bad = 0
    for key, g in want.items():
        r = cell(*key)
        if same_stream:
            d_bad += sum(
                ([int(x) for x in r[k]] if k == "core_end" else int(r[k]))
                != g[k] for k in gold["bitwise_keys"] + ["core_end"])
        else:
            d_bad += len(golden_mod.tolerance_violations(r, g))
    port_failed = frfcfs.failed_checks(fig)
    repro_failed = frfcfs.failed_checks(frfcfs.summarize(
        lambda m, c, w: want[m, c, w]))
    print(f"  (d) against repro's run of benchmarks/frfcfs.py at this size "
          f"(golden_frfcfs.json): stream {'equal' if same_stream else 'differs'}"
          f", {len(want)} cells, {d_bad} "
          f"{'values differ' if same_stream else 'tolerance violations'}; "
          f"the study's assertions broken on the card: "
          f"{port_failed or 'none'}; in repro's run: {repro_failed or 'none'}",
          flush=True)
    check(d_bad == 0, "the FR-FCFS study differs from repro's")
    check(port_failed == repro_failed,
          "the FR-FCFS study's assertions fare otherwise than in repro")
    r = regs.get("sim_window_kernel", {})
    print(f"  sim_window_kernel: {r.get('registers')} registers, spill "
          f"stores {r.get('spill_stores')} B, spill loads "
          f"{r.get('spill_loads')} B; golden launch {ms8 * 1e6 / n8:.1f} "
          f"ns/step ({100 * chain8 / ms8:.1f} % of the {WINDOW_STEP_CYCLES}"
          f"-cycle bound), study launch {d_ms * 1e6 / d_steps:.1f} ns/step "
          f"({100 * window_chain_bound_ms(d_steps, d_mhz) / d_ms:.1f} %); "
          f"phase 17 {time.time() - t_phase:.1f} s", flush=True)
    return {
        "name": "sim_window", "route": "cuda",
        "source": "src/repro_torch/kernels/sim_step/csrc/sim_step.cu",
        "replaces": "src/repro/controller/engine.py:264 _run_window_impl "
                    "(an XLA scan, no Pallas kernel)",
        "launches": main_launches["sim_window"], "max_abs_err": a_err,
        "mismatches": a_bad + s_bad + g_bad + b_bad + c_bad + d_bad,
        "ms": ms8, "plain_ms": plain_ms, "plain_points": len(grid),
        "plain_steps": staged[6], "ms_at_plain_steps": cut_ms,
        "steps": n8, "points": len(grid6), "ns_per_step": ms8 * 1e6 / n8,
        "chain_bound_ms": chain8,
        "chain_cycles_per_step": WINDOW_STEP_CYCLES, "sm_clock_mhz": mhz,
        "registers": r.get("registers"),
        "spill_bytes": (r.get("spill_stores") or 0)
        + (r.get("spill_loads") or 0),
        "figure_s": fig_s, "figure_rows": frfcfs.rows(fig),
        "figure_launch_ms": d_ms, "figure_checks_broken": port_failed,
        "bound_ms": bound8, "bound_by": "bytes", "library_ms": None}


# --------------------------------------------------------------------------
# phase 18: the simulator-side studies and the examples
# --------------------------------------------------------------------------

#: megasweep's grid sizes in phase 18 (``repro``'s full size)
MEGASWEEP_SIZES = (10_000, 100_000)
#: the serving counters a serving cell is held to beside ``cell_mismatches``
SERVE_COUNTERS = ("arrived", "dropped", "retired", "preempted", "admit_hot",
                  "admit_probes")
#: the simulator-side studies in the order phase 18 runs them
STUDIES = ("geometry", "aldram", "refresh", "workloads", "sweep_bench",
           "serving_trace", "serving_loop", "megasweep")


def serve_mismatches(want: dict, got: dict) -> int:
    return cell_mismatches(want, got, False) + sum(
        int(want[k]) != int(got[k]) for k in SERVE_COUNTERS)


def study_cells_vs_direct(sim, mods, outs, S, device) -> dict:
    """(a): each study's cells against a direct sweep on the card: the
    first mix's for geometry and aldram, every cell of the synthetic and
    serving grids, sweep_bench's cold call against its warm one, and
    every point of megasweep's full arm (10**5 at full size: the 500
    distinct configurations and their replicas) against a direct sweep of
    the 500.  Returns mismatching values by study."""
    import numpy as np
    bad = {}
    for name in ("geometry", "aldram"):
        res = outs[name]["results"]
        bad[name] = direct_mismatches(sim, res, mods[name].experiment(
            S, device), res.coords["mix"][:1], False, device)
    for name in ("refresh", "workloads"):
        cfgs = mods[name].experiment(S, device).expand()[2]
        bad[name] = sum(cell_mismatches(a, b, False) for a, b in zip(
            sim.sweep_synth(cfgs, rltl=False, device=device),
            outs[name]["results"].cells.flat))
    for name in ("serving_trace", "serving_loop"):
        cfgs = mods[name].experiment(S, device).expand()[2]
        bad[name] = sum(serve_mismatches(a, b) for a, b in zip(
            sim.sweep_serving(cfgs, device=device),
            outs[name]["results"].cells.flat))
    sb = outs["sweep_bench"]
    bad["sweep_bench"] = sum(cell_mismatches(a, b, False)
                             for a, b in zip(sb["cold"], sb["warm"]))
    ms = mods["megasweep"]
    big = max(S.megasweep)
    exp = ms.experiment("full", big, device)
    _, coords, cfgs = exp.expand()
    reps = len(coords["rep"])
    direct = sim.sweep(exp.traces, cfgs[::reps], rltl=False, device=device)
    got = outs["megasweep"]["arms"][big]["metrics"]
    bad["megasweep"] = sum(int((got[m] != np.array(
        [float(r[m]) for r in direct]).reshape(got[m].shape[:-1] + (1,))
    ).sum()) for m in ms.METRICS)
    return bad


def refresh_vs_golden(sim, traces, golden_mod, kernel, refresh, out, S,
                      device) -> tuple[bool, int]:
    """(b): the refresh study at full size against ``repro``'s run
    (``golden_drivers.json``): its stream (the synthesis entry's pre-pass)
    against the recorded digest; where equal every cell's stats bit for
    bit and the headline numbers exactly, else each cell within the
    statistical tolerance; the dedup's unique point count equal.  Returns
    ``(stream equal, mismatching values or tolerance violations)``."""
    import torch
    gold = golden_mod.load_drivers()["refresh"]
    res = out["results"]
    check(res.meta["n_unique"] == gold["meta"]["n_unique"]
          and res.meta["n_points"] == gold["meta"]["n_points"],
          f"refresh dedups to {res.meta['n_unique']} of "
          f"{res.meta['n_points']} points, repro to {gold['meta']}")
    cfgs = refresh.experiment(S, device).expand()[2]
    args = sim._stage_synth(cfgs[:1], None, torch.device(device))
    stream = kernel.sim_synth(*(args[:7] + (0, False)), True)[3]
    batch = point_batch(traces, stream, 0)
    same = golden_mod.trace_sha256(batch) == gold["stream_sha256"]
    if not same:
        blocks = golden_mod.stream_block_digests(batch)
        diff = [(c, b) for c, row in enumerate(gold["stream_blocks"])
                for b, d in enumerate(row) if blocks[c][b] != d]
        n_blocks = sum(len(row) for row in gold["stream_blocks"])
        print(f"  (b) the stream differs from repro's in {len(diff)} of "
              f"{n_blocks} blocks: {diff[:8]}", flush=True)
        check(len(diff) <= MAX_DIFF_BLOCK_SHARE * n_blocks,
              "the refresh stream differs from repro's in too many blocks")
    bad = 0
    keys = gold["bitwise_keys"] + ["core_end", "bank_acts",
                                   "bank_act_ras_sum"]
    for g in gold["cells"]:
        r = res.sel(**{d: g[d] for d in gold["dims"]}).cells.flat[0]
        if same:
            bad += sum((int(r[k]) if not isinstance(g[k], list)
                        else [int(x) for x in r[k]]) != g[k] for k in keys)
        else:
            bad += len(golden_mod.tolerance_violations(r, g))
    doc = refresh.document(out)
    head = {k: doc[k] for k in gold["headline"]}
    if same:
        bad += sum(head[k] != v for k, v in gold["headline"].items())
    print(f"  (b) refresh against repro's full-size run "
          f"(golden_drivers.json): stream {'equal' if same else 'differs'}, "
          f"{len(gold['cells'])} cells, {res.meta['n_unique']} unique "
          f"points (repro {gold['meta']['n_unique']}), {bad} "
          f"{'values differ' if same else 'tolerance violations'}; "
          f"headline here {head}, in repro {gold['headline']}", flush=True)
    check(bad == 0, "the refresh study differs from repro's")
    return same, bad


def driver_phase(sim, traces, golden_mod, kernel, device="cuda") -> dict:
    """Phase 18: (a) the simulator-side studies at ``repro``'s full size,
    their launches and cells; (b) refresh against ``repro``'s run; (c) the
    ChargeCache example's four modes at its default size, and the
    dispatcher's quick spin.  Returns the launch counts and numbers for
    the kernels line."""
    import importlib
    import tempfile
    from repro_torch.figures import common as C, run as run_mod
    from repro_torch.kernels.hcrac import ops as hops
    from repro_torch.kernels.sim_step import ops
    mods = {name: importlib.import_module(f"repro_torch.figures.{name}")
            for name in STUDIES}
    megasweep, refresh = mods["megasweep"], mods["refresh"]
    S = dataclasses.replace(C.THESIS, megasweep=MEGASWEEP_SIZES)
    t_phase = time.time()

    def counts():
        return {"sim_step": ops.launches, "sim_synth": ops.synth_launches,
                "sim_serve": ops.serve_launches,
                "sim_window": ops.window_launches, "hcrac": hops.launches}

    # (a) the studies: the main path of this slice
    ops.launches = ops.synth_launches = ops.serve_launches = 0
    ops.window_launches = hops.launches = 0
    outs, walls, rows = {}, {}, []
    for name in STUDIES:
        before = counts()
        t0 = time.time()
        outs[name] = mods[name].study(S, device)
        after = counts()
        walls[name] = {"wall_s": time.time() - t0,
                       "launches": {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}}
        rows += mods[name].rows(outs[name])
        print(f"  (a) {name}: {walls[name]['wall_s']:.1f} s wall, launches "
              f"{walls[name]['launches']}", flush=True)
    main_launches = counts()
    # megasweep's arms launch in subprocesses of their own, each holding
    # its launches to its runner's plan; their counts come back here
    ms_launches = sum(a[m]["launches"] for a in outs["megasweep"]
                      ["arms"].values() for m in ("full", "streamed"))
    walls["megasweep"]["launches"]["sim_step (arms)"] = ms_launches
    print(f"  main path: {sum(w['wall_s'] for w in walls.values()):.1f} s; "
          f"launches {main_launches}, megasweep's arms {ms_launches} "
          f"sim_step", flush=True)
    for row in rows:
        print(f"  {row}")
    arm = (lambda r: f"{r['sec']:.2f} s ({r['points_per_sec']:.0f} "
           f"points/s, peak RSS {r['maxrss_mb']:.0f} MB, "
           f"{r['maxrss_start_mb']:.0f} MB before the run, {r['n_chunks']} "
           f"chunks)")
    for n, a in outs["megasweep"]["arms"].items():
        print(f"  megasweep {n} points: full {arm(a['full'])}, streamed "
              f"{arm(a['streamed'])}: {a['speedup']:.3f}x "
              f"(repro's headline: >= {megasweep.HEADLINE_SPEEDUP}x at "
              f"{megasweep.HEADLINE_POINTS})", flush=True)
    check(main_launches["sim_step"] > 0 and main_launches["sim_synth"] > 0
          and main_launches["sim_serve"] > 0 and main_launches["hcrac"] > 0
          and ms_launches > 0,
          f"the studies launched a kernel of their path no time: "
          f"{main_launches}")
    t0 = time.time()
    bad = study_cells_vs_direct(sim, mods, outs, S, device)
    print(f"  (a) cells against direct sweeps on the card "
          f"({time.time() - t0:.1f} s): mismatching values {bad}",
          flush=True)
    check(sum(bad.values()) == 0,
          "a study's cell differs from its direct sweep")

    # (b) refresh against repro's full-size run
    same, g_bad = refresh_vs_golden(sim, traces, golden_mod, kernel, refresh,
                                    outs["refresh"], S, device)

    # (c) the ChargeCache example at its default size, every mode
    ex = load_example("chargecache_sim_torch")
    t0 = time.time()
    order = {}
    for label, argv in (("single-core", []), ("eight-core", ["--eight-core"])):
        tab = ex.main(argv + ["--device", device])
        sp = {k: v["speedup"] for k, v in tab["rows"].items()}
        order[label] = sp
        print(f"  (c) examples/chargecache_sim_torch.py {' '.join(argv)}: "
              f"base 1.0 < chargecache {sp['chargecache']:.4f} < cc_nuat "
              f"{sp['cc_nuat']:.4f} < lldram {sp['lldram']:.4f}", flush=True)
        check(1.0 < sp["chargecache"] < sp["cc_nuat"] < sp["lldram"],
              f"{label}: speedup ordering base < chargecache < cc_nuat < "
              f"lldram broken")
    heat = ex.main(["--heat-grid", "--device", device])
    geo = ex.main(["--geo-grid", "--device", device])
    check(all(0.0 < h <= 1.0 for row in heat["hit"].values() for h in row)
          and all(v["cc"] > 1.0 for v in geo.values()),
          "the example's heat or geometry grid is malformed")
    ex_s = time.time() - t0
    print(f"  (c) the example's four modes: {ex_s:.1f} s", flush=True)
    # the dispatcher's quick spin over a few studies, its JSON under a
    # temporary directory
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        rc = run_mod.main(["--quick", "--only", "sweep,geometry,refresh,"
                           "serving", "--device", device, "--json", d])
        written = sorted(os.listdir(d))
    print(f"  (c) python -m repro_torch.figures.run --quick --only ...: "
          f"exit {rc}, {time.time() - t0:.1f} s, wrote {written}", flush=True)
    check(rc == 0 and "BENCH_results.json" in written,
          "the dispatcher's quick spin failed")
    print(f"  phase 18 {time.time() - t_phase:.1f} s", flush=True)
    return {"main": main_launches, "megasweep_launches": ms_launches,
            "walls": walls, "cells_vs_direct": bad,
            "refresh_stream_equal": same, "refresh_golden_bad": g_bad,
            "example_speedups": order, "example_s": ex_s, "rows": rows,
            "megasweep": {n: {k: a[k] for k in ("full", "streamed",
                                                  "speedup")}
                          for n, a in outs["megasweep"]["arms"].items()}}


def add_ft_rows(lm_rows: list, train_rows: list, ft: dict) -> None:
    """Phase 25's drill launches into the flash rows (forward: the LSE
    instantiation; the backward's entries) as ``launches_phase25``, added
    to ``launches``; (b)'s comparisons into the flash and decode rows."""
    counts = {"flash_attention": "flash", "flash_attention_bwd": "bwd_dkdv",
              "flash_bwd_dot": "bwd_dot", "flash_bwd_dkdv_wgmma": "bwd_dkdv",
              "flash_bwd_sum": "bwd_sum", "flash_bwd_dq_wgmma": "bwd_dq"}
    for row in lm_rows + train_rows:
        if row["name"] in counts:
            n = ft["launches"][counts[row["name"]]]
            row["launches_phase25"] = n
            row["launches"] += n
    flash, dec = lm_rows
    flash["strategy_blocked_attention"] = ft["strategies"]["flash"]
    dec["strategy_split_kv_decode"] = ft["strategies"]["decode"]
    train_rows[0]["fault_tolerance_drill"] = {
        k: v for k, v in ft.items() if k != "strategies"}


def add_zoo_rows(lm_rows: list, zoo_rows: dict) -> None:
    """Phases 19-23's numbers into the flash and decode rows of the kernel
    line (``zoo``: their phase-19 shapes; ``launches_zoo``: the serving
    runs' launches)."""
    flash, dec = lm_rows
    flash["zoo"] = zoo_rows["kernels"]["flash"]
    dec["zoo"] = zoo_rows["kernels"]["decode"]
    flash["ptxas_hd256"] = {k: v for k, v in zoo_rows["kernels"]["ptxas"]
                            .items() if k.startswith("flash")}
    dec["ptxas_hd256"] = {k: v for k, v in zoo_rows["kernels"]["ptxas"]
                          .items() if k.startswith("paged")}
    for row, key in ((flash, "flash"), (dec, "decode")):
        row["launches_zoo"] = {name: run["launches"][key] for name, run in
                               zoo_rows["serving"].items()}
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               zoo_rows["kernels"]["max_abs_err"]["flash"])
    dec["max_abs_err"] = max(dec["max_abs_err"],
                             zoo_rows["kernels"]["max_abs_err"]["decode"])
    flash["zoo_runs"] = zoo_rows["runs"]


# --------------------------------------------------------------------------
# the plain runs of phases 4 and 7, made by worker processes during the build
# --------------------------------------------------------------------------

#: the plain versions' runs that phases 4 and 7 hold the synthesis and
#: serving entries to, by worker process.  They are host-bound eager loops
#: (~360 s one after another on the H100's host); four workers make them
#: while the kernels build (the card then times nothing), balanced by
#: their times there: ``synth:<grid>``, ``serve:<grid>:<drawn|pinned>``
PLAIN_WORKERS = (
    ("synth:full",),
    ("synth:matrix", "serve:scale:pinned"),
    ("serve:wide:pinned", "serve:grid:drawn"),
    ("serve:wide:drawn", "serve:scale:drawn", "serve:grid:pinned",
     "synth:pressure"))
#: the worker processes and their output directories, stopped and removed
#: on the way out (``stop_plain_workers``)
_WORKERS: list = []
_PLAIN_DIRS: list = []


def plain_grid(name: str, sim, traces, golden_mod, timing) -> list:
    """The grid of a plain run (``PLAIN_WORKERS``), as the worker and the
    phase that holds the kernel to it both build it."""
    if name == "matrix":
        return synth_cut_grid(sim, traces)
    if name == "full":
        return synth_full_grid(sim, golden_mod, timing, n_req=SYNTH_CUT_REQ)
    if name == "pressure":
        return pressure_synth_grid(sim, traces)
    if name == "grid":
        return serving_grid(sim, golden_mod, timing, n_steps=SERVE_CUT_STEPS)
    if name == "scale":
        return scale_grid(sim, golden_mod, timing, n_steps=SCALE_CUT_STEPS)
    return scale_grid(sim, golden_mod, timing, n_steps=SCALE_CUT_STEPS,
                      max_batch=WIDE_BATCH, queue_cap=WIDE_QUEUE)


def plain_worker(jobs, out_dir: str) -> None:
    """A worker process: each plain run of ``jobs`` on the card, its
    ``(ms, outputs)`` saved as ``<out_dir>/<job>.pt`` (CUDA events around
    the run, taken beside the other workers and the build)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import golden as golden_mod
    from repro_torch.core import simulator as sim, timing, traces
    from repro_torch.kernels.sim_step import ref
    from repro_torch.serving.loop import engine
    dev = torch.device("cuda")
    for job in jobs:
        kind, name, *mode = job.split(":")
        grid = plain_grid(name, sim, traces, golden_mod, timing)
        if kind == "synth":
            args = sim._stage_synth(grid, None, dev)
            fn = lambda: ref.run_synth_ref(*args, True, True)
        else:
            staged = engine.stage_serving(grid, None, True, dev)
            counts = (pinned_counts(staged[0], len(grid), dev)
                      if mode == ["pinned"] else None)
            fn = lambda: ref.run_serve_ref(*staged, counts)
        torch.cuda.synchronize()
        torch.save(cuda_ms(fn, torch.cuda.synchronize),
                   Path(out_dir) / f"{job.replace(':', '-')}.pt")


def start_plain_workers() -> str:
    """Starts ``PLAIN_WORKERS``; returns the directory they write to."""
    import multiprocessing
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=ROOT / "build")
    _PLAIN_DIRS.append(out_dir)
    ctx = multiprocessing.get_context("spawn")
    for jobs in PLAIN_WORKERS:
        w = ctx.Process(target=plain_worker, args=(jobs, out_dir))
        w.start()
        _WORKERS.append(w)
    return out_dir


def wait_plain_workers() -> None:
    for w in _WORKERS:
        w.join()
    check(all(w.exitcode == 0 for w in _WORKERS),
          f"a plain worker failed: exit codes "
          f"{[w.exitcode for w in _WORKERS]}")


def stop_plain_workers() -> None:
    import shutil
    for w in _WORKERS:
        if w.is_alive():
            w.terminate()
        w.join()
    for d in _PLAIN_DIRS:
        shutil.rmtree(d, ignore_errors=True)


def load_plain(out_dir: str, job: str) -> tuple:
    """A worker's ``(ms, outputs)`` of ``job``, on the card."""
    import torch
    return torch.load(Path(out_dir) / f"{job.replace(':', '-')}.pt",
                      map_location="cuda", weights_only=False)


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
    # the plain runs of phases 4 and 7 start now, in worker processes
    plain_dir = start_plain_workers()
    from repro_torch.core import aldram, mechanisms, simulator as sim
    from repro_torch.core import timing, traces
    from repro_torch import golden as golden_mod
    from repro_torch.golden import build_batch, load, load_batch, trace_sha256
    from repro_torch.kernels.sim_step import kernel, ops, ref
    from repro_torch.kernels.hcrac import kernel as hk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.rglru_scan import kernel as rk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    # --- phase 1: the card and the build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    # the six libraries build at once, one nvcc each
    t0 = time.time()
    with ThreadPoolExecutor(6) as pool:
        libs = list(pool.map(lambda f: f(), (kernel.library, hk.library,
                                              fk.library, pk.library,
                                              sk.library, rk.library)))
    print(f"sim_step + hcrac + flash_attention + paged_attention + ssm_scan "
          f"+ rglru_scan build+load: {time.time() - t0:.1f} s "
          f"({', '.join(b._name for b in libs)})")
    t0 = time.time()
    wait_plain_workers()
    print(f"the plain runs of phases 4 and 7 in {len(PLAIN_WORKERS)} worker "
          f"processes: {time.time() - t_start:.1f} s from the start, "
          f"{time.time() - t0:.1f} s waited after the build", flush=True)
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
    phase("2: sim_step kernel vs plain version (on the card)")
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
    phase("3: main path at full size")
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
    phase("4: sim_step synthesis entry vs plain version (on the "
          "card)")
    # the matrix, the full-size grid's points (8 cores, 1 024 HCRAC
    # entries) cut, 4x refresh pressure, against the plain runs the
    # workers made during the build
    m_bad, m_err = synth_vs_plain(
        sim, ops, "matrix", plain_grid("matrix", sim, traces, golden_mod,
                                       timing),
        load_plain(plain_dir, "synth:matrix"))[:2]
    (s_bad, s_err, s_cut_ms, s_plain_ms, s_cut_points,
     s_cut_steps) = synth_vs_plain(
        sim, ops, "full-size grid cut",
        plain_grid("full", sim, traces, golden_mod, timing),
        load_plain(plain_dir, "synth:full"))
    p_bad, p_err = synth_vs_plain(
        sim, ops, "4x refresh pressure",
        plain_grid("pressure", sim, traces, golden_mod, timing),
        load_plain(plain_dir, "synth:pressure"))[:2]
    s_bad += m_bad + p_bad
    s_err = max(s_err, m_err, p_err)
    max_err = max(max_err, s_err)

    # --- phase 5: the synthesis path at full size -------------------------
    phase("5: synthesis path at full size")
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

    serve_rows = serving_phases(sim, timing, traces, golden_mod, regs,
                                plain_dir)
    max_err = max(max_err, serve_rows[1]["max_abs_err"])
    lm_rows = lm_phases(golden_mod, sim)
    ssm_row = ssm_phases(golden_mod, smi)

    # --- phase 16: the Experiment layer and the five figures -------------
    phase("16: the Experiment layer and the five figures")
    from repro_torch.experiment import Experiment
    exp_bad = experiment_vs_plain(sim, traces, mechanisms, Experiment)
    gold_bad = golden_through_experiment(sim, traces, golden_mod, Experiment)
    fig = figure_phase(sim)
    serve_rows[0]["launches_policy_study"] = fig["main"]["hcrac"]

    # --- phase 17: the FR-FCFS controller tier ----------------------------
    phase("17: the FR-FCFS controller tier (the sim_window entry)")
    window_row = window_phase(sim, traces, golden_mod, kernel, ops, ref,
                              regs)

    # --- phase 18: the simulator-side studies and the examples -----------
    phase("18: the simulator-side studies and the examples")
    drv = driver_phase(sim, traces, golden_mod, kernel)
    p18 = dict(drv["main"])
    p18["sim_step"] += drv["megasweep_launches"]
    for row, key in ((serve_rows[0], "hcrac"), (serve_rows[1], "sim_serve")):
        row["launches"] += p18[key]
        row["launches_phase18"] = p18[key]
    zoo_rows = zoo_phases(golden_mod, smi)
    add_zoo_rows(lm_rows, zoo_rows)
    train_rows = train_phase(golden_mod, smi)
    ft = ft_phase(golden_mod, smi)
    add_ft_rows(lm_rows, train_rows, ft)
    dryrun_phase(smi, train_rows[0]["train_step"]["peak_gib"],
                 train_rows[0]["launches_full_step"])
    print(f"\nchip_smoke total: {time.time() - t_start:.1f} s")
    print(smi)

    # --- kernel numbers ---------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "sim_step", "route": "cuda",
        "source": "src/repro_torch/kernels/sim_step/csrc/sim_step.cu",
        "replaces": "src/repro/kernels/sim_step/kernel.py:66",
        "launches": launches + p18["sim_step"],
        "launches_phase18": p18["sim_step"], "max_abs_err": max_err,
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
        "experiment_main_launches": fig["main"],
        "study_mismatches": sum(drv["cells_vs_direct"].values()),
        "study_walls_s": {k: v["wall_s"] for k, v in drv["walls"].items()},
        "study_launches": {k: v["launches"] for k, v in drv["walls"].items()},
        "megasweep": drv["megasweep"],
        "example_speedups": drv["example_speedups"]}, {
        "name": "sim_step_synth", "route": "cuda",
        "source": "src/repro_torch/kernels/sim_step/csrc/sim_step.cu",
        "replaces": "src/repro/kernels/sim_step/ops.py:65",
        "launches": synth_launches + p18["sim_synth"],
        "launches_phase18": p18["sim_synth"],
        "refresh_stream_equal_to_golden": drv["refresh_stream_equal"],
        "max_abs_err": s_err,
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
        *serve_rows, *lm_rows, ssm_row, window_row,
        zoo_rows["rglru_row"], *train_rows]}))
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
    finally:
        stop_plain_workers()
