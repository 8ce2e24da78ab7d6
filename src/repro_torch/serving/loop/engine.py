"""The continuous-batching serving closed loop over ``[G]`` grid points
(port of ``repro.serving.loop.engine``).

One scan per grid point runs the whole serving loop — arrivals drawn
from the counter-based PRNG, a fixed-slot active set with validity
masks, registry-folded admission and preemption, hot-page (KV charge)
table updates, and the DRAM simulator's per-access ``_service`` step —
so the KV page charge and the DRAM bank state evolve together.  The
engine below (``_make_step`` / ``_run_serving_impl``) is written once
over a leading ``[G]`` axis: it is the plain version of the ``sim_serve``
entry of the CUDA ``sim_step`` kernel
(``repro_torch.kernels.sim_step``).  Which of the two runs is decided by
the device of the tensors, in ``ops.run_serve``.

Step order mirrors the host ``repro_torch.serving.scheduler.Scheduler``
(the parity oracle, ``oracle.run_host``):

  1. arrivals  — accept up to ``arrivals_max`` drawn requests into free
     queue slots; prefill-touch their prompt pages (hot inserts and DRAM
     writes), as ``Scheduler.submit`` does.
  2. preempt   — policy-gated: requeue the active request with the most
     remaining work when the queue is long (no host analogue).
  3. admit     — fill free slots from the queue, best score first, FIFO
     on ties (the host's stable sort).
  4. probe     — read-only hot-table probes of first-decode requests'
     pages (the ``admit_probes`` / ``admit_hot`` metric).
  5. decode    — every active request streams all its KV pages through
     the hot table and the DRAM simulator, then advances one token.
  6. retire    — free slots of finished requests; advance the clock.

Per-step work is bounded (``arrivals_max x prompt_pages_max`` prefill
accesses + ``max_batch x pages_max`` decode accesses), masked per
access.  A masked access changes no state, so an access slot no point
enables is skipped.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import hcrac as hcl
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import simulator as sim_mod
from repro_torch.core.dram import floordiv
from repro_torch.serving.loop import policies as pol_mod
from repro_torch.serving.loop.spec import ServingSpec
from repro_torch.workloads import arrivals as arr_mod
from repro_torch.workloads import prng

__all__ = ["ServingShape", "ServingParams", "LoopState", "run_sweep",
           "simulate_serving", "page_gid", "SERVE_STAT_KEYS",
           "SERVE_REDUCE_KEYS", "stage_serving"]

# independent lanes for the page -> (hot gid, DRAM bank, DRAM row) maps
_L_GID, _L_BANK, _L_ROW = prng.lanes(3)

#: intra-step DRAM spacing between a step's page accesses (cycles), the
#: host ``Scheduler.emit_trace``'s same-timestamp gap
_INTRA = 4

_I32 = torch.int32


def page_gid(rid, page) -> torch.Tensor:
    """Hot-table key of (request, page): the 32-bit avalanche hash masked
    to 31 bits, int32 (tensors broadcast together)."""
    return (prng.hash_u32(rid, page, _L_GID) & 0x7FFF_FFFF).to(_I32)


class ServingShape(NamedTuple):
    """Static half of a serving grid."""
    sim: sim_mod.SimShape
    hot: hcl.HCRACConfig      # padded hot-table shape carrier
    max_batch: int
    queue_cap: int
    arrivals_max: int
    prompt_pages_max: int     # prefill fan-out bound
    pages_max: int            # per-slot page-stream bound
    n_steps: int
    collect_steps: bool       # emit per-step (occ, qlen, arrivals)


class ServingParams(NamedTuple):
    """Per-point half, every leaf ``[G]``-stacked."""
    mech: sim_mod.MechParams
    arrival: arr_mod.ArrivalParams
    hot: hcl.HCRACParams
    policy: dict              # registry blocks {name: {leaf: tensor}}
    cycles_per_step: torch.Tensor  # int32
    page_tokens: torch.Tensor      # int32


class _RestParams(NamedTuple):
    """``ServingParams`` minus the DRAM params (which
    ``simulator._grid_shape_and_params`` stacks with grid-wide
    padding)."""
    arrival: arr_mod.ArrivalParams
    hot: hcl.HCRACParams
    policy: dict
    cycles_per_step: torch.Tensor
    page_tokens: torch.Tensor


class LoopState(NamedTuple):
    """Per-point loop state, every leaf with a leading ``[G]`` axis."""
    sim: sim_mod.SimState     # bank/bus/HCRAC/stats state (one idle core)
    hot: hcl.HCRACState       # KV hot-page table
    # fixed decode slots [G, S]; rid < 0 = free
    slot_rid: torch.Tensor
    slot_done: torch.Tensor
    slot_max: torch.Tensor
    slot_pages: torch.Tensor  # prompt pages
    # admission queue [G, Q]; rid < 0 = free
    q_rid: torch.Tensor
    q_done: torch.Tensor
    q_max: torch.Tensor
    q_pages: torch.Tensor
    q_touch: torch.Tensor     # last page-touch cycle (charge prediction)
    q_seq: torch.Tensor       # arrival sequence (FIFO key)
    n_arrived: torch.Tensor   # [G]
    next_seq: torch.Tensor    # [G]
    now: torch.Tensor         # [G] scheduler clock
    stats: dict               # SERVE_STAT_KEYS: [G]


SERVE_STAT_KEYS = ("arrived", "dropped", "admitted", "retired",
                   "preempted", "admit_probes", "admit_hot",
                   "occ_sum", "qlen_sum")

#: every key a serving launch can reduce on the device: the DRAM-side
#: counters (``total_cycles`` = the final scheduler clock), the serving
#: counters, and the step count (an ingredient of ``occ_mean`` /
#: ``qlen_mean``)
SERVE_REDUCE_KEYS = sim_mod.REDUCE_KEYS + SERVE_STAT_KEYS + ("n_steps",)


def _column(p: arr_mod.ArrivalParams) -> arr_mod.ArrivalParams:
    """``[G]`` arrival params as ``[G, 1]``, to broadcast over indices."""
    return arr_mod.ArrivalParams(*(x[:, None] for x in p))


def _init_loop_state(shape: ServingShape, n_points: int,
                     device) -> LoopState:
    S, Q = shape.max_batch, shape.queue_cap
    full = lambda v, *s: torch.full((n_points,) + s, v, dtype=_I32,
                                    device=device)
    return LoopState(
        sim=sim_mod._init_state(shape.sim, n_points, 1, device),
        hot=hcl.init(shape.hot, n_points, device),
        slot_rid=full(-1, S), slot_done=full(0, S), slot_max=full(0, S),
        slot_pages=full(0, S),
        q_rid=full(-1, Q), q_done=full(0, Q), q_max=full(0, Q),
        q_pages=full(0, Q), q_touch=full(0, Q), q_seq=full(0, Q),
        n_arrived=full(0), next_seq=full(0), now=full(0),
        stats={k: full(0) for k in SERVE_STAT_KEYS},
    )


def _probe_many(hshape: hcl.HCRACConfig, st: hcl.HCRACState, gids, t,
                p: hcl.HCRACParams) -> torch.Tensor:
    """Batched read-only hot-table lookup (no LRU side effect): ``gids
    [G, N]`` at cycles ``t [G]`` -> hits, bool ``[G, N]``.  Aliveness is
    ``hcrac._alive`` over the ``G * N`` queries as rows."""
    G, N = gids.shape
    g = torch.arange(G, device=gids.device)[:, None]
    set_idx = torch.remainder(gids, p.n_sets[:, None])
    tags = st.tags[g, set_idx]                                # [G, N, W]
    itime = st.itime[g, set_idx]
    rows = lambda x: x[:, None].expand(G, N).reshape(-1)
    alive = hcl._alive(hshape, set_idx.reshape(-1),
                       itime.reshape(G * N, -1), rows(t),
                       hcl.HCRACParams(*map(rows, p))).view(tags.shape)
    return ((tags != hcl.NO_TAG) & alive
            & (tags == gids[..., None])).any(dim=-1)


def _make_step(shape: ServingShape, p: ServingParams, warmups):
    """The per-step function over ``[G]`` points: ``step(st, step_idx,
    n_drawn [G])`` returns the next ``LoopState`` (the DRAM and hot-table
    state are updated in place) and the step's ``(occ, qlen, arrivals)``
    ``[G]``."""
    S, Q, A = shape.max_batch, shape.queue_cap, shape.arrivals_max
    Pp, Pt = shape.prompt_pages_max, shape.pages_max
    geom = p.mech.geom
    dev = warmups.device
    G = warmups.shape[0]
    g = torch.arange(G, device=dev)
    arr = _column(p.arrival)
    banks_total = geom.banks_total.to(torch.int64)[:, None]
    n_rows = geom.n_rows.to(torch.int64)[:, None]
    ar = lambda n: torch.arange(n, dtype=_I32, device=dev)
    # prefill access slots (arrival a, page k) and decode access slots
    # (slot s, page k), a- and s-major as repro's flattened scans
    a_idx, ka = ar(A).repeat_interleave(Pp), ar(Pp).repeat(A)
    s_idx, ks = ar(S).repeat_interleave(Pt), ar(Pt).repeat(S)
    no = torch.zeros(G, dtype=torch.bool, device=dev)
    yes = torch.ones(G, dtype=torch.bool, device=dev)

    def dram_of(rid, page):
        bank = (prng.hash_u32(rid, page, _L_BANK) % banks_total).to(_I32)
        row = (prng.hash_u32(rid, page, _L_ROW) % n_rows).to(_I32)
        return bank, row

    def access(st: LoopState, t, cnt, rids, pages, en, is_write, measure):
        """Stream masked (rid, page) accesses ``[G, N]`` through the hot
        table and the DRAM step, spaced ``_INTRA`` cycles apart by the
        running count ``cnt [G]``; returns the new count."""
        gids = page_gid(rids, pages)
        banks, rows = dram_of(rids, pages)
        wr = yes if is_write else no
        for j in range(en.shape[1]):
            e = en[:, j]
            if not bool(e.any()):
                continue
            hcl.insert(shape.hot, st.hot, gids[:, j], t, e, p.hot)
            sim_mod._service(shape.sim, p.mech, st.sim, t + _INTRA * cnt,
                             banks[:, j], rows[:, j], wr, no, e & measure, e)
            cnt = cnt + e.to(_I32)
        return cnt

    def step(st: LoopState, step_idx: int, n_drawn):
        t = st.now
        stats = dict(st.stats)
        measure = step_idx >= warmups

        # ---- 1. arrivals: fill free queue slots in position order -----
        q_invalid = st.q_rid < 0
        free_q = q_invalid.sum(dim=1, dtype=_I32)
        want = torch.minimum(n_drawn, p.arrival.n_reqs - st.n_arrived)
        n_new = torch.clamp(torch.minimum(want, free_q), max=A)
        inv_rank = q_invalid.to(_I32).cumsum(dim=1, dtype=_I32) - 1
        is_dest = q_invalid & (inv_rank < n_new[:, None])
        rid_new = st.n_arrived[:, None] + inv_rank
        pages_new, dec_new = arr_mod.request_attrs(arr, rid_new)
        q_rid = torch.where(is_dest, rid_new, st.q_rid)
        q_done = torch.where(is_dest, 0, st.q_done)
        q_pages = torch.where(is_dest, pages_new, st.q_pages)
        q_max = torch.where(is_dest, dec_new, st.q_max)
        q_touch = torch.where(is_dest, t[:, None], st.q_touch)
        q_seq = torch.where(is_dest, st.next_seq[:, None] + inv_rank,
                            st.q_seq)
        n_arrived = st.n_arrived + n_new
        next_seq = st.next_seq + n_new

        # prefill: each accepted arrival touches its prompt pages (hot
        # inserts + DRAM writes), like ``Scheduler.submit``
        rid_a = st.n_arrived[:, None] + a_idx
        pg_a, _ = arr_mod.request_attrs(arr, rid_a)
        en_a = (a_idx < n_new[:, None]) & (ka < pg_a)
        cnt = access(st, t, torch.zeros_like(t), rid_a, ka.expand_as(rid_a),
                     en_a, True, measure)

        # ---- 2. preemption (policy-gated, at most one per step) -------
        q_len = (Q - free_q) + n_new
        want_p = pol_mod.preempt_decision(
            p.policy, pol_mod.PreemptCtx(now=t, q_len=q_len))
        slot_valid = st.slot_rid >= 0
        remaining = st.slot_max - st.slot_done
        cand_p = slot_valid & (remaining >= 2)
        pe = want_p & (free_q - n_new > 0) & cand_p.any(dim=1)
        victim = torch.argmax(torch.where(cand_p, remaining, -1), dim=1)
        qdest = torch.argmin((q_rid >= 0).to(_I32), dim=1)  # first free

        def put(a, val):
            a = a.clone()
            a[g, qdest] = torch.where(pe, val, a[g, qdest])
            return a

        q_rid = put(q_rid, st.slot_rid[g, victim])
        q_done = put(q_done, st.slot_done[g, victim])
        q_max = put(q_max, st.slot_max[g, victim])
        q_pages = put(q_pages, st.slot_pages[g, victim])
        # its pages were last streamed on the previous decode step
        q_touch = put(q_touch, t - p.cycles_per_step)
        q_seq = put(q_seq, next_seq)  # back of the line
        next_seq = next_seq + pe.to(_I32)
        slot_rid = st.slot_rid.clone()
        slot_rid[g, victim] = torch.where(pe, -1, slot_rid[g, victim])

        # ---- 3. admission: best score first, FIFO (q_seq) on ties -----
        score = pol_mod.admission_scores(
            p.policy, pol_mod.AdmitCtx(
                now=t, q_touch=q_touch, q_seq=q_seq, q_valid=q_rid >= 0,
                caching_cycles=p.hot.caching_cycles))
        slot_done, slot_max, slot_pages = (st.slot_done.clone(),
                                           st.slot_max.clone(),
                                           st.slot_pages.clone())
        n_adm = torch.zeros_like(t)
        for _ in range(S):
            qv = q_rid >= 0
            sv = slot_rid >= 0
            can = qv.any(dim=1) & (~sv).any(dim=1)
            if not bool(can.any()):   # no point can admit: a no-op from
                break                 # here on
            sc = torch.where(qv, score, -torch.inf)
            tie = qv & (sc >= sc.max(dim=1, keepdim=True).values)
            pick = torch.argmin(torch.where(tie, q_seq, sim_mod.INF), dim=1)
            dest = torch.argmin(sv.to(_I32), dim=1)      # first free slot
            for sa, qa in ((slot_rid, q_rid), (slot_done, q_done),
                           (slot_max, q_max), (slot_pages, q_pages)):
                sa[g, dest] = torch.where(can, qa[g, pick], sa[g, dest])
            q_rid[g, pick] = torch.where(can, -1, q_rid[g, pick])
            n_adm = n_adm + can.to(_I32)

        # ---- 4. read-only probes of first-decode requests' pages ------
        rid_s = slot_rid[:, s_idx]
        slot_valid = slot_rid >= 0
        first = slot_valid & (slot_done == 0)
        en_pr = first[:, s_idx] & (ks < slot_pages[:, s_idx])
        hits = _probe_many(shape.hot, st.hot, page_gid(rid_s, ks), t, p.hot)
        stats["admit_probes"] = stats["admit_probes"] + en_pr.sum(
            dim=1, dtype=_I32)
        stats["admit_hot"] = stats["admit_hot"] + (hits & en_pr).sum(
            dim=1, dtype=_I32)

        # ---- 5. decode: stream every active request's KV pages --------
        npages = slot_pages + floordiv(
            slot_done + (p.page_tokens - 1)[:, None],
            p.page_tokens[:, None])
        en_d = slot_valid[:, s_idx] & (ks < npages[:, s_idx])
        access(st, t, cnt, rid_s, ks.expand_as(rid_s), en_d, False, measure)
        slot_done = slot_done + slot_valid.to(_I32)

        # ---- 6. retire ------------------------------------------------
        fin = slot_valid & (slot_done >= slot_max)
        occ = slot_valid.sum(dim=1, dtype=_I32)  # post-admit
        slot_rid = torch.where(fin, -1, slot_rid)
        qlen = (q_rid >= 0).sum(dim=1, dtype=_I32)

        stats["arrived"] = stats["arrived"] + n_new
        stats["dropped"] = stats["dropped"] + (want - n_new)
        stats["admitted"] = stats["admitted"] + n_adm
        stats["retired"] = stats["retired"] + fin.sum(dim=1, dtype=_I32)
        stats["preempted"] = stats["preempted"] + pe.to(_I32)
        stats["occ_sum"] = stats["occ_sum"] + occ
        stats["qlen_sum"] = stats["qlen_sum"] + qlen

        new_st = LoopState(
            sim=st.sim, hot=st.hot,
            slot_rid=slot_rid, slot_done=slot_done, slot_max=slot_max,
            slot_pages=slot_pages,
            q_rid=q_rid, q_done=q_done, q_max=q_max, q_pages=q_pages,
            q_touch=q_touch, q_seq=q_seq,
            n_arrived=n_arrived, next_seq=next_seq,
            now=t + p.cycles_per_step, stats=stats)
        return new_st, (occ, qlen, n_new)

    return step


def _run_serving_impl(shape: ServingShape, p: ServingParams, warmups,
                      counts=None):
    """Run ``shape.n_steps`` scheduler steps at every point of the
    ``[G]``-stacked ``p``; ``counts [G, n_steps]`` pins the arrivals
    (else they are drawn, ``arrivals.step_counts``).  Returns ``(sim
    stats, serve stats, final clock [G], (occ, qlen, arrivals) [G,
    n_steps] each or None)``."""
    dev = warmups.device
    G, n = warmups.shape[0], shape.n_steps
    if counts is None:
        counts = arr_mod.step_counts(
            _column(p.arrival), torch.arange(n, dtype=_I32, device=dev))
    counts = counts.to(_I32)
    step = _make_step(shape, p, warmups)
    st = _init_loop_state(shape, G, dev)
    ys = (tuple(torch.empty((G, n), dtype=_I32, device=dev)
                for _ in range(3)) if shape.collect_steps else None)
    for s in range(n):
        st, y = step(st, s, counts[:, s])
        if ys is not None:
            for lane, val in zip(ys, y):
                lane[:, s] = val
    return st.sim.stats, st.stats, st.now, ys


def _serve_reduce(shape: ServingShape, sim_stats, serve_stats, now,
                  reduce_keys):
    """``[G, len(reduce_keys)]`` int32 column stack on the device that
    holds the stats (``total_cycles`` is the final clock, ``n_steps``
    the horizon)."""
    bad = [k for k in reduce_keys if k not in SERVE_REDUCE_KEYS]
    if bad:
        raise ValueError(f"unknown serving reduce keys {bad}; known: "
                         f"{SERVE_REDUCE_KEYS}")
    cols = []
    for k in reduce_keys:
        if k == "total_cycles":
            cols.append(now)
        elif k == "n_steps":
            cols.append(torch.full_like(now, shape.n_steps))
        elif k in serve_stats:
            cols.append(serve_stats[k])
        else:
            cols.append(sim_stats[k])
    return torch.stack(cols, dim=-1)


def _resolve_static(specs: Sequence[ServingSpec], collect_steps: bool,
                    sim_shape: sim_mod.SimShape) -> ServingShape:
    s0 = specs[0]
    for sp in specs:
        if (sp.max_batch, sp.queue_cap, sp.arrivals_max, sp.hot_ways,
                sp.hot_exact) != (s0.max_batch, s0.queue_cap,
                                  s0.arrivals_max, s0.hot_ways, s0.hot_exact):
            raise ValueError("serving grids must share max_batch, "
                             "queue_cap, arrivals_max, hot_ways and "
                             "hot_exact")
    hot_sets_max = max(sp.hot_cfg().n_sets for sp in specs)
    return ServingShape(
        sim=sim_shape,
        hot=hcl.padded_shape(s0.hot_cfg(), hot_sets_max),
        max_batch=s0.max_batch,
        queue_cap=s0.queue_cap,
        arrivals_max=s0.arrivals_max,
        prompt_pages_max=max(sp.arrival.prompt_pages_max for sp in specs),
        pages_max=max(sp.pages_max() for sp in specs),
        n_steps=max(sp.steps() for sp in specs),
        collect_steps=collect_steps,
    )


@functools.lru_cache(maxsize=4096)
def _point_rest(sp: ServingSpec) -> _RestParams:
    """One spec's non-DRAM params as 0-d CPU tensors, cached by the
    (hashable) spec."""
    i32 = lambda v: torch.tensor(v, dtype=_I32)
    return _RestParams(arrival=arr_mod.arrival_params(sp.arrival, sp.n_reqs),
                       hot=hcl.params_of(sp.hot_cfg()),
                       policy=pol_mod.build_blocks(sp),
                       cycles_per_step=i32(sp.cycles_per_step),
                       page_tokens=i32(sp.page_tokens))


def stage_serving(grid, shape_grid=None, collect_steps: bool = False,
                  device=None) -> tuple:
    """Everything one serving launch reads, on ``device``: the static
    ``ServingShape``, the ``[G]``-stacked ``ServingParams`` and the
    warm-ups (scheduler steps) ``[G]`` — the leading arguments of
    ``ops.run_serve``."""
    grid = list(grid)
    if not grid:
        raise ValueError("empty serving sweep grid")
    shape_grid_l = list(shape_grid) if shape_grid is not None else grid
    for cfg in grid + shape_grid_l:
        if cfg.serving is None:
            raise ValueError("run_sweep needs cfg.serving set on every "
                             "grid point")
    sshape, mech = sim_mod._grid_shape_and_params(grid, shape_grid, device)
    shape = _resolve_static([cfg.serving for cfg in grid + shape_grid_l],
                            collect_steps, sshape)
    n_steps = shape.n_steps
    if n_steps >= 2**24:
        raise ValueError("serving stream too long for the scan horizon")
    max_cps = max(cfg.serving.cycles_per_step for cfg in grid)
    slack = _INTRA * (shape.arrivals_max * shape.prompt_pages_max
                      + shape.max_batch * shape.pages_max)
    if n_steps * max_cps + slack >= 2**30:
        raise ValueError("serving clock exceeds the int32 cycle horizon — "
                         "lower n_steps or cycles_per_step")
    rest = sim_mod._tree_map(lambda *xs: torch.stack(xs).to(device),
                             *(_point_rest(cfg.serving) for cfg in grid))
    params = ServingParams(mech=mech, **rest._asdict())
    # steps-based warm-up: the measured window of the DRAM-side stats
    warmups = torch.tensor([int(cfg.warmup_frac * n_steps) for cfg in grid],
                           dtype=_I32, device=device)
    return shape, params, warmups


def _pinned(counts, n_grid: int, shape: ServingShape, device):
    """Pinned counts as int32 ``[G, n_steps]`` on ``device``."""
    counts = np.asarray(counts, np.int32)
    if counts.ndim == 1:
        counts = np.broadcast_to(counts, (n_grid,) + counts.shape)
    if counts.shape != (n_grid, shape.n_steps):
        raise ValueError(f"pinned counts must be [n_steps={shape.n_steps}] "
                         f"or [G={n_grid}, n_steps]; got {counts.shape}")
    return torch.from_numpy(np.array(counts)).to(device)


def _launch_serving(shape: ServingShape, params, warmups, counts=None,
                    reduce_keys: tuple | None = None, device=None):
    """The launch half of a serving sweep: one ``ops.run_serve`` on
    ``device`` (default: where ``warmups`` lies), returning the device
    outputs without waiting for them, or with ``reduce_keys`` the int32
    ``[G, n_keys]`` reduction.  ``counts`` (on ``device``) pins the
    arrivals."""
    from repro_torch.kernels.sim_step import ops as sim_step_ops
    out = sim_step_ops.run_serve(shape, params, warmups, counts,
                                 device=device)
    if reduce_keys is None:
        return out
    return _serve_reduce(shape, *out[:3], reduce_keys)


def _drain_serving(out, grid, shape: ServingShape,
                   reduce_keys: tuple | None = None):
    """The drain half: the reduced int32 ``[len(grid), n_keys]`` array,
    or one finished stats dict for each of ``grid``'s points (the
    leading points of the launch)."""
    n = len(grid)
    if reduce_keys is not None:
        return out[:n].cpu().numpy()
    sim_stats, serve_stats, final_now, ys = out
    sim_np = {k: v[:n].cpu().numpy() for k, v in sim_stats.items()}
    serve_np = {k: v[:n].cpu().numpy() for k, v in serve_stats.items()}
    now_np = final_now[:n].cpu().numpy()
    ys_np = None if ys is None else tuple(y[:n].cpu().numpy() for y in ys)
    rows = []
    for i, cfg in enumerate(grid):
        res = sim_mod._finalize(
            {k: v[i] for k, v in sim_np.items()}, now_np[i:i + 1],
            (None, None), np.asarray([cfg.serving.n_reqs]), cfg)
        for k in SERVE_STAT_KEYS:
            res[k] = int(serve_np[k][i])
        res["n_steps"] = shape.n_steps
        metrics_lib.finalize_scalars(res)
        if ys_np is not None:
            res["steps"] = {"occ": ys_np[0][i], "qlen": ys_np[1][i],
                            "arrivals": ys_np[2][i]}
        rows.append(res)
    return rows


def run_sweep(grid, shape_grid=None, counts=None,
              collect_steps: bool = False,
              reduce_keys: tuple | None = None, device=None):
    """Evaluate a serving config grid (``cfg.serving`` set on every
    point) in one launch: on a CUDA device one launch of the ``sim_step``
    kernel's serving entry, on the CPU the plain engine.

    ``shape_grid`` pads the static facts for a larger grid than the one
    launched, ``counts`` pins the per-step arrivals (``[n_steps]``
    shared or ``[G, n_steps]``), and ``collect_steps`` returns per-step
    (occupancy, queue length, arrivals) arrays per point.  With
    ``reduce_keys`` (entries of ``SERVE_REDUCE_KEYS``) the launch
    reduces on the device and returns an int32 ``[G, n_keys]`` numpy
    array (no per-step arrays).  ``device`` defaults to CUDA.
    """
    grid = list(grid)
    device = sim_mod._resolve_device(device)
    if reduce_keys is not None:
        collect_steps = False
    shape, params, warmups = stage_serving(grid, shape_grid, collect_steps,
                                           device)
    if counts is not None:
        counts = _pinned(counts, len(grid), shape, device)
    out = _launch_serving(shape, params, warmups, counts, reduce_keys)
    return _drain_serving(out, grid, shape, reduce_keys)


def simulate_serving(cfg, counts=None, collect_steps: bool = True,
                     device=None) -> dict:
    """One serving grid point end to end (the single-point view of
    ``run_sweep``; per-step arrays collected by default)."""
    if cfg.serving is None:
        raise ValueError("simulate_serving needs cfg.serving")
    return run_sweep([cfg], counts=counts, collect_steps=collect_steps,
                     device=device)[0]
