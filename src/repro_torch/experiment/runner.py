"""Experiment runner (port of ``repro.experiment.runner``): dedup →
chunk → pipelined launches → Results.

1. ``Experiment.expand()`` turns the named axes into a flat ``SimConfig``
   grid (C order over the axis coords).
2. **Dedup**: grid points whose *canonical* configs coincide (knobs no
   active mechanism policy consumes are stripped — a ``base`` point is
   the same run at any HCRAC capacity) launch once and fan back out.
3. **Chunking**: the unique grid splits into chunks of ``chunk_size``
   points, or of as many as fit the memory budget (``bytes_per_point``;
   the budget is the card's free memory, or ``memory_budget_mb``,
   divided by the pipeline depth).  The tail chunk is padded by
   repeating its last point, so every launch has the same point count.
4. **Staging**: the params of the whole unique grid are staged once, on
   the host, padded for the whole grid (its envelope, HCRAC capacity
   and registry hints); each chunk takes its rows by indexing.  The
   traces (and their lookahead tables) go to the device once, before
   the first launch.
5. **Pipelined launch**: every chunk is a ``(launch, finish)`` pair of
   the mode's halves — ``simulator._launch_grid`` / ``_drain_grid`` over
   traces (one ``sim_step`` launch a trace batch), ``_launch_synth`` /
   ``_drain_synth``, or the serving engine's ``_launch_serving`` /
   ``_drain_serving``.  A launch half packs the chunk's params on the
   host and queues the kernel without waiting for the device; the
   ``ChunkScheduler`` keeps ``pipeline_depth`` of them in flight and
   drains the oldest, so the host's drain of chunk k overlaps the
   device's work on the chunks after it.
6. **Assembly**: full-stats mode fans per-point stats dicts into the
   dense labeled object-cell ``Results``; ``reduce=`` mode receives only
   ``[chunk, n_deps]`` integer ingredient columns per launch, applies
   the registered metric formulas vectorized, and assembles the streamed
   layout (``Results.data``).  Either mode can append every drained
   chunk to a ``ResultsWriter`` JSONL stream (``stream_to=``).

**Progress contract** (``repro``'s): ``progress(done, total)`` is called
once after every drained chunk with ``total = n_trace_rows ×
n_unique_configs``; a trace-mode chunk drains ``len(batches) × n_valid``
points at once (the chunk's block of one trace group), a serving or
synthetic chunk ``n_valid``.  Drains happen in launch order, so ``done``
rises strictly to ``total`` whatever the pipeline depth.

Every cell equals a direct ``sweep()`` / ``sweep_traces()`` of the same
expanded grid bit for bit, chunked, pipelined, reduced or not; and it
equals ``repro``'s ``Experiment`` cell for cell.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core import metrics as metrics_lib
from repro_torch.core import simulator as sim_mod
from repro_torch.core.dram import InterleaveConfig
from repro_torch.core.simulator import SimConfig
from repro_torch.core.traces import pad_batch_to
from repro_torch.experiment import registry
from repro_torch.experiment.results import Results, ResultsWriter
from repro_torch.experiment.spec import Experiment

#: memory budget for auto-chunking on the CPU (MiB)
DEFAULT_BUDGET_MB = 1024.0
#: share of the card's free memory (``torch.cuda.mem_get_info``) that
#: auto-chunking plans with; the rest is headroom for the allocator
CARD_BUDGET_SHARE = 0.5


def _canonical(cfg: SimConfig, mode: str) -> SimConfig:
    cfg = dataclasses.replace(cfg, mech=registry.canonical_mech(cfg.mech))
    if cfg.controller == "inorder":
        # only the frfcfs tier reads the window depth: in-order points
        # across a window axis are one run
        cfg = dataclasses.replace(
            cfg, window=SimConfig.__dataclass_fields__["window"].default)
    if mode == "synth":
        if cfg.dram.n_channels == 1:
            # with one active channel every interleave policy degenerates
            # to the identity (dram.compose_address) — dedup the axis
            cfg = dataclasses.replace(cfg, interleave=InterleaveConfig())
        return cfg
    # trace-driven and serving launches never consume the workload spec
    # or interleave policy — points differing only there dedup
    cfg = dataclasses.replace(cfg, workload=None,
                              interleave=InterleaveConfig())
    if mode == "serving":
        # knobs only read by disabled serving policies dedup too
        cfg = dataclasses.replace(cfg, serving=cfg.serving.canonical())
    return cfg


def _dedup(configs: list[SimConfig], enable: bool, mode: str):
    """Unique canonical configs + flat-index → unique-index map."""
    if not enable:
        return list(configs), list(range(len(configs)))
    unique: list[SimConfig] = []
    where: dict = {}
    index_map = []
    for cfg in configs:
        key = _canonical(cfg, mode)
        if key not in where:
            where[key] = len(unique)
            unique.append(key)
        index_map.append(where[key])
    return unique, index_map


def bytes_per_point(n_steps: int, n_sets_max: int, n_ways: int,
                    n_cores: int, mshr: int, n_traces: int, rltl: bool,
                    n_banks_total: int = 16, synth: bool = False,
                    window: int = 0) -> int:
    """Rough device bytes one grid point of one chunk holds, from its
    launch to the end of its drain, summed over the ``n_traces`` batches
    of a trace group (one launch each, all in flight together).

    - the packed params row: ~64 int32 fields plus the AL-DRAM per-bank
      tables (counted as 4 words a bank);
    - the outputs: 16 counters, 2 per-bank accumulators, ``core_end``;
    - the engine state: the kernel keeps the HCRAC table and the bank
      state in the block's shared memory, the plain engine in tensors
      (3 int32 a way, ~12 a bank, the MSHR ring a core): counted always;
    - with RLTL, the event record (8 int32 lanes and a bool lane a step,
      33 B) and the drain's post-pass over its 4 event slots a step
      (gid, time, kind, sort keys, two orders and the gathered copies:
      ~64 B a slot, 256 B a step);
    - a synthetic point's generated streams (3 int32 and 3 bool lanes a
      position, 15 B);
    - ``window > 0``, the FR-FCFS tier: the window engine's own state,
      ``repro``'s words (9 arrays of ``window`` slots, 6 a bank for the
      rank registers, ``mshr + 3`` a core for the admission gates),
      counted once: the port updates its state in place, where
      ``repro``'s scan carries it in and out.

    The shared trace and its lookahead tables are excluded (one copy a
    trace, not a point).
    """
    per = 4096
    per += (64 + 4 * n_banks_total) * 4
    per += (16 + 2 * n_banks_total + n_cores) * 4
    per += (n_sets_max * n_ways * 3 + 12 * n_banks_total
            + n_cores * (mshr + 6)) * 4
    if synth:
        per += 15 * n_steps
    if window > 0:
        per += (9 * window + 6 * n_banks_total + n_cores * (mshr + 3)) * 4
    if rltl:
        per += (33 + 256) * n_steps
    return per * max(1, n_traces)


def _budget_bytes(budget_mb: float | None, device: torch.device,
                  pipeline_depth: int) -> float:
    """The bytes one in-flight chunk may hold: ``budget_mb`` if given,
    else a share of the card's free memory (``DEFAULT_BUDGET_MB`` on the
    CPU), divided by the pipeline depth."""
    if budget_mb is not None:
        budget = budget_mb * 2**20
    elif device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] * CARD_BUDGET_SHARE
    else:
        budget = DEFAULT_BUDGET_MB * 2**20
    return budget / max(1, pipeline_depth)


def _auto_chunk(unique: list[SimConfig], groups, rltl: bool,
                budget_mb: float | None, mode: str = "trace",
                pipeline_depth: int = 0,
                device: torch.device = torch.device("cpu")) -> int:
    """Largest chunk fitting the budget.

    ``groups`` holds the trace batches (trace-driven mode); when it is
    empty the grid is synthetic and the stream dimensions come from the
    configs' ``WorkloadSpec``s (each point owns its generated stream).
    A serving grid is estimated from its own state: the hot-page table,
    the queue and slot arrays."""
    n_sets_max = max(c.mech.hcrac.n_sets for c in unique)
    n_ways = unique[0].mech.hcrac.n_ways
    n_banks_max = max(c.dram.banks_total for c in unique)
    ctrl, win = sim_mod._launch_controller(unique)
    win = win if ctrl == "frfcfs" else 0
    worst = 1
    for batches in groups.values():
        n_cores, max_len = batches[0][1].gap.shape[0], max(
            b.gap.shape[1] for _, b in batches)
        worst = max(worst, bytes_per_point(
            n_steps=n_cores * max_len, n_sets_max=n_sets_max,
            n_ways=n_ways, n_cores=n_cores, mshr=unique[0].mshr,
            n_traces=len(batches), rltl=rltl, n_banks_total=n_banks_max,
            window=win))
    if mode == "serving":
        sp = [c.serving for c in unique]
        per = 4096
        per += n_sets_max * n_ways * 3 * 4                # controller HCRAC
        per += max(s.hot_cfg().n_sets for s in sp) * sp[0].hot_ways * 3 * 4
        per += (64 + 16 * n_banks_max) * 4                # params, bank state
        per += (6 * sp[0].queue_cap + 4 * sp[0].max_batch) * 4
        worst = per
    elif not groups:
        from repro_torch.workloads.profiles import max_len_of
        n_cores = unique[0].workload.n_cores
        max_len = max_len_of([c.workload for c in unique])
        worst = bytes_per_point(
            n_steps=n_cores * max_len, n_sets_max=n_sets_max,
            n_ways=n_ways, n_cores=n_cores, mshr=unique[0].mshr,
            n_traces=1, rltl=rltl, n_banks_total=n_banks_max, synth=True,
            window=win)
    budget = _budget_bytes(budget_mb, device, pipeline_depth)
    return min(int(max(1, budget // worst)), len(unique))


class ChunkScheduler:
    """Bounded-in-flight launch pipeline on one device.

    ``run(work)`` consumes ``(launch, finish)`` pairs: ``launch()`` queues
    one chunk's kernel launches and returns their device outputs without
    waiting for them, and ``finish(out)`` waits for them and assembles.
    At most ``depth`` launches are in flight before the scheduler drains
    the oldest, so drains (and therefore progress callbacks and stream
    writes) happen strictly in launch order while the device works on
    the later chunks.  ``depth=0`` is launch-then-drain, one at a time.
    An exception from a launch or a drain propagates out of ``run``; the
    launches still in flight are abandoned.
    """

    def __init__(self, depth: int = 2):
        self.depth = max(0, int(depth))

    def run(self, work: Iterable[tuple[Callable, Callable]]) -> None:
        pending: deque = deque()
        for launch, finish in work:
            pending.append((launch(), finish))
            while len(pending) > self.depth:
                out, fin = pending.popleft()
                fin(out)
        while pending:
            out, fin = pending.popleft()
            fin(out)


def run_experiment(exp: Experiment, progress=None,
                   stream_to: str | None = None) -> Results:
    device = sim_mod._resolve_device(exp.device)
    host = torch.device("cpu")
    labeled, trace_items = exp.trace_items()
    cfg_dims, cfg_coords, configs = exp.expand()
    if not configs:
        configs = [exp.base]
    serving = exp.traces is None and configs[0].serving is not None
    synth = exp.traces is None and not serving
    mode = "serving" if serving else ("synth" if synth else "trace")
    unique, index_map = _dedup(configs, exp.dedup, mode)

    if serving:
        if any(cfg.serving is None for cfg in unique):
            raise ValueError("a serving experiment (base.serving set) must "
                             "set cfg.serving on every grid point")
        # one pseudo trace row so chunk fan-out/assembly is shared below
        trace_items = [(None, None)]
    if synth:
        if any(cfg.workload is None or not cfg.workload.names
               for cfg in unique):
            raise ValueError(
                "Experiment(traces=None) is the synthetic mode: every grid "
                "point needs a WorkloadSpec (add a 'workload' axis or set "
                "base.workload)")
        # fail up front (not mid-launch) on mixed core counts: the
        # streamed engine shares one [C, L] stream shape per grid
        cores = {cfg.workload.n_cores for cfg in unique}
        if len(cores) != 1:
            raise ValueError(
                f"a synthetic grid must share one core count, got "
                f"{sorted(cores)}: split the experiment per core count")
        trace_items = [(None, None)]

    # ---- the reduce contract ------------------------------------------
    reduced = exp.reduce is not None
    if reduced:
        if exp.rltl:
            raise ValueError("reduce= lowers scalar ingredients only; RLTL "
                             "histograms need the full-stats path "
                             "(reduce=None)")
        if exp.trace_metrics:
            raise ValueError("reduce= streams device-computed metrics only; "
                             "trace_metrics extras need the full-stats path")
        if serving:
            from repro_torch.serving.loop.engine import SERVE_REDUCE_KEYS
            available = SERVE_REDUCE_KEYS
        else:
            available = sim_mod.REDUCE_KEYS
        resolved = metrics_lib.resolve(exp.reduce_metrics(), available)
        reduce_keys = metrics_lib.deps_for(resolved)
        out_metrics = tuple(m.name for m in resolved)
    else:
        reduce_keys = None
        out_metrics = tuple(exp.metrics)

    # group traces by core count; pad within a group to the longest trace
    groups: dict[int, list] = {}
    if exp.traces is not None:
        for pos, (label, batch) in enumerate(trace_items):
            groups.setdefault(batch.gap.shape[0], []).append((pos, batch))

    depth = max(0, int(exp.pipeline_depth))
    chunk = exp.chunk_size or _auto_chunk(unique, groups, exp.rltl,
                                          exp.memory_budget_mb, mode,
                                          pipeline_depth=depth,
                                          device=device)
    chunk = max(1, min(chunk, len(unique)))
    n_unique = len(unique)
    n_chunks = -(-n_unique // chunk)
    # per-chunk row indices into the staged unique grid; the tail chunk
    # pads by repeating its last point
    chunk_idx = [torch.from_numpy(np.minimum(
        np.arange(ci * chunk, (ci + 1) * chunk), n_unique - 1))
        for ci in range(n_chunks)]
    n_valid = [min(chunk, n_unique - ci * chunk) for ci in range(n_chunks)]
    valid_cfgs = [unique[ci * chunk:ci * chunk + n_valid[ci]]
                  for ci in range(n_chunks)]

    def rows_of(tree, idx):
        """Per-chunk rows of once-staged ``[n_unique, ...]`` tensors."""
        return sim_mod._tree_map(lambda a: a[idx], tree)

    # ---- dense labeled frame + streaming sinks ----------------------
    dims = ((exp.trace_dim,) + cfg_dims) if labeled else cfg_dims
    coords = dict(cfg_coords)
    if labeled:
        coords[exp.trace_dim] = tuple(label for label, _ in trace_items)
    shape = tuple(len(coords[d]) for d in dims)
    cfg_shape = tuple(len(cfg_coords[d]) for d in cfg_dims)
    n_flat = int(np.prod(cfg_shape, dtype=np.int64)) if cfg_shape else 1
    imap = np.asarray(index_map, np.int64)
    n_rows = len(trace_items)
    n_batches = sum(len(b) for b in groups.values())

    meta = {"n_points": len(configs) * n_rows,
            "n_configs": len(configs), "n_unique": n_unique,
            "chunk_size": chunk, "n_chunks": n_chunks,
            # drains: a trace-mode chunk drains a whole trace group
            "n_launches": n_chunks * max(1, len(groups)),
            # kernel launches on the card (sim_step, or sim_window for an
            # frfcfs grid): one a trace batch
            "n_kernel_launches": n_chunks * max(1, n_batches),
            "mode": mode, "pipeline_depth": depth, "device": str(device)}
    if reduced:
        meta["reduce_keys"] = tuple(reduce_keys)

    writer = (ResultsWriter(stream_to, dims, coords, out_metrics,
                            meta=meta) if stream_to else None)

    by_trace: list[list] = [[None] * n_unique for _ in trace_items]
    flat_data = ({m: np.full((n_rows, n_flat), np.nan)
                  for m in out_metrics} if reduced else None)
    aggs: dict[str, tuple] = {}
    if exp.aggregate:
        if not reduced:
            raise ValueError("aggregate= needs reduce= (streamed metrics)")
        by_name = {m.name: m for m in resolved}
        for rn, (agg_name, metric_name) in dict(exp.aggregate).items():
            if metric_name not in by_name:
                raise ValueError(
                    f"aggregate {rn!r} refers to {metric_name!r}, which is "
                    f"not among the reduced metrics {out_metrics}")
            aggs[rn] = (metrics_lib.make_aggregator(
                agg_name, by_name[metric_name]), metric_name)

    total = n_rows * n_unique
    state = {"done": 0}

    def advance(n):
        state["done"] += n
        if progress is not None:
            progress(state["done"], total)

    def fan_reduced(t: int, ci: int, red: np.ndarray):
        """One trace row × one chunk of the on-device reduction: apply
        the registered formulas vectorized over the chunk's unique
        points and scatter into the flat streamed arrays."""
        lo, hi = ci * chunk, ci * chunk + n_valid[ci]
        cols = {k: red[:, j] for j, k in enumerate(reduce_keys)}
        pos = np.nonzero((imap >= lo) & (imap < hi))[0]
        src = imap[pos] - lo
        rows = np.empty((len(pos), len(resolved)), np.float64)
        for mi, m in enumerate(resolved):
            vals = np.asarray(m.fn(*[cols[d] for d in m.deps]),
                              np.float64)[src]
            flat_data[m.name][t, pos] = vals
            rows[:, mi] = vals
        gidx = t * n_flat + pos
        for agg, metric_name in aggs.values():
            agg.update(rows[:, out_metrics.index(metric_name)], gidx)
        if writer is not None:
            writer.write(gidx, rows)

    extras_by_t = [dict((exp.trace_metrics or {}).get(label, {}))
                   for label, _ in trace_items]

    def fan_full(t: int, ci: int, row: list):
        """Full-stats fan-out of one drained chunk row: store the
        unique-point cells and (optionally) stream the declared metric
        scalars for the covered flat grid points."""
        lo, hi = ci * chunk, ci * chunk + n_valid[ci]
        by_trace[t][lo:hi] = row
        if writer is None:
            return
        extra = extras_by_t[t]
        pos = np.nonzero((imap >= lo) & (imap < hi))[0]
        src = imap[pos] - lo
        rows = np.empty((len(pos), len(out_metrics)), np.float64)
        for k, p in enumerate(pos):
            cell = row[src[k]] if not extra else {**row[src[k]], **extra}
            for mi, m in enumerate(out_metrics):
                v = cell.get(m)
                rows[k, mi] = (np.nan if v is None or np.ndim(v) > 0
                               else float(v))
        writer.write(t * n_flat + pos, rows)

    def fan(t: int, ci: int, row):
        if reduced:
            fan_reduced(t, ci, row)
        else:
            fan_full(t, ci, list(row))

    # ---- stage once, then build the launch/drain work list ----------
    # the controller tier of the whole unique grid: one window depth, so
    # every chunk runs on one entry
    ctrl, win = sim_mod._launch_controller(unique)
    work: list[tuple[Callable, Callable]] = []

    if serving:
        from repro_torch.serving.loop import engine as serve_eng
        sshape, sparams, swarmups = serve_eng.stage_serving(
            unique, unique, collect_steps=False, device=host)
        for ci in range(n_chunks):
            pch = rows_of(sparams, chunk_idx[ci])
            wch = swarmups[chunk_idx[ci]]

            def launch(pch=pch, wch=wch):
                return serve_eng._launch_serving(
                    sshape, pch, wch, None, reduce_keys, device)

            def finish(out, ci=ci):
                fan(0, ci, serve_eng._drain_serving(
                    out, valid_cfgs[ci], sshape, reduce_keys))
                advance(n_valid[ci])

            work.append((launch, finish))

    if synth:
        (yshape, ystacked, wstack, ilstack, ywarmups, n_cores, max_len,
         n_steps) = sim_mod._stage_synth(unique, unique, host)
        for ci in range(n_chunks):
            staged = (yshape, *(rows_of(x, chunk_idx[ci]) for x in
                                (ystacked, wstack, ilstack, ywarmups)),
                      n_cores, max_len, n_steps)

            def launch(staged=staged):
                return sim_mod._launch_synth(staged, exp.rltl, reduce_keys,
                                             device, ctrl, win)

            def finish(out, ci=ci):
                fan(0, ci, sim_mod._drain_synth(out, valid_cfgs[ci],
                                                reduce_keys))
                advance(n_valid[ci])

            work.append((launch, finish))

    if mode == "trace":
        tshape, tstacked = sim_mod._grid_shape_and_params(unique, unique,
                                                          host)
        ns_geoms, ns_idx = sim_mod._hoist_geoms(unique, unique, host)
        ns_geoms = sim_mod._tree_map(lambda x: x.to(device), ns_geoms)
        # one unlabeled batch runs its exact request count (as sweep());
        # trace groups run the padded capacity (as sweep_traces())
        single = not labeled and len(trace_items) == 1
        warmup_frac = unique[0].warmup_frac
        for batches in groups.values():
            max_len = max(b.gap.shape[1] for _, b in batches)
            padded = [pad_batch_to(b, max_len) for _, b in batches]
            staged = [sim_mod._stage_trace(b, tshape, ns_geoms, device,
                                           warmup_frac, pad_steps=not single)
                      for b in padded]
            for ci in range(n_chunks):
                sch = rows_of(tstacked, chunk_idx[ci])
                nch = ns_idx[chunk_idx[ci]]

                def launch(sch=sch, nch=nch, staged=staged):
                    return sim_mod._launch_grid(tshape, sch, nch, staged,
                                                exp.rltl, reduce_keys, ctrl,
                                                win)

                def finish(outs, ci=ci, batches=batches, padded=padded):
                    rows = sim_mod._drain_grid(outs, valid_cfgs[ci], padded,
                                               reduce_keys)
                    for (pos, _), row in zip(batches, rows):
                        fan(pos, ci, row)
                    advance(len(batches) * n_valid[ci])

                work.append((launch, finish))

    ChunkScheduler(depth=depth).run(work)
    if state["done"] != total:
        raise RuntimeError(f"drained {state['done']} of {total} points")

    # ---- assemble ----------------------------------------------------
    if reduced:
        agg_out = {}
        for rn, (agg, _) in aggs.items():
            r = agg.result()
            if isinstance(r, dict) and "flat_index" in r \
                    and r["flat_index"] is not None:
                idx = (np.unravel_index(r["flat_index"], shape)
                       if shape else ())
                r = {**r, "coords": {d: coords[d][int(i)]
                                     for d, i in zip(dims, idx)}}
            agg_out[rn] = r
        if aggs:
            meta["aggregates"] = agg_out
        if writer is not None:
            writer.close(meta={"aggregates": agg_out} if aggs else {})
        data = {m: np.ascontiguousarray(a.reshape(shape))
                for m, a in flat_data.items()}
        return Results(dims=dims, coords=coords, data=data,
                       metrics=out_metrics, meta=meta)

    if writer is not None:
        writer.close()
    cells = np.empty(shape, object)
    for t, (label, _) in enumerate(trace_items):
        extra = dict((exp.trace_metrics or {}).get(label, {}))
        for flat, u in enumerate(index_map):
            idx = np.unravel_index(flat, cfg_shape) if cfg_shape else ()
            full = ((t,) + tuple(idx)) if labeled else tuple(idx)
            cells[full] = {**by_trace[t][u], **extra}
    return Results(dims=dims, coords=coords, cells=cells,
                   metrics=out_metrics, meta=meta)
