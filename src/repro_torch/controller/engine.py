"""The FR-FCFS window engine, plain PyTorch over a ``[G]`` axis of points
(port of ``repro.controller.engine``).

One step = admit-then-serve.  Up to ``W`` admission attempts refill the
request window from the per-core issue fronts (each core in program
order, gated by its MSHR slot and its dependency, the in-order engine's
issue formula); then the window's oldest row hit, else its oldest
request, is served by the shared ``simulator._service`` with a per-rank
tRRD/tFAW floor on its ACT.  The state is the in-order ``SimState`` plus
``O(W + ranks)`` window and rank registers, updated in place with masked
writes: a point whose step is dead changes nothing.

A point at ``win_cap = 1`` (an in-order point riding a mixed grid)
serves requests in the in-order engine's order with its timings, bit for
bit.  A failed admission attempt changes no state, so every later
attempt of the step fails too: the admission loop stops at the first
attempt that no point can take, with the result ``repro``'s full
``fori_loop`` gives.

This is the plain version of the ``sim_window`` entry of the
``sim_step`` CUDA kernel (``kernels/sim_step/ops.py::run_window``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import dram as dram_lib
from repro_torch.core import simulator as sim_mod
from repro_torch.core.dram import GeomParams, floordiv, fold_address
from repro_torch.core.simulator import INF, Events, MechParams, SimShape

#: selection-key penalty of a window entry that is not a row hit: the
#: admission sequence stays below 2**24 (the trace-length horizon), so a
#: miss key ``HIT_PENALTY + seq < 2**27`` never meets a hit key
HIT_PENALTY = 1 << 26

#: a rank's ACT registers start far in the past, so its first ACT is
#: unconstrained; NEG + tFAW stays far below any real cycle
NEG = -(2 ** 28)

#: tFAW spans a rolling window of four ACTs a rank (DDR3)
FAW_DEPTH = 4

_I32 = torch.int32
_I32_MAX = 2 ** 31 - 1


class WindowState(NamedTuple):
    """The window engine's state, every leaf with a leading ``[G]``
    axis: the in-order ``SimState``, the request window, the per-core
    admission gates and the per-rank ACT registers (``NR``, the
    envelope's bank count, bounds every point's rank id)."""
    sim: sim_mod.SimState
    # the request window, [G, W] each; a slot is live iff w_valid
    w_valid: torch.Tensor   # bool
    w_core: torch.Tensor    # issuing core
    w_idx: torch.Tensor     # the core's request index (program order)
    w_bank: torch.Tensor    # folded bank
    w_row: torch.Tensor     # folded row
    w_write: torch.Tensor   # bool
    w_ns: torch.Tensor      # next_same lookahead (bool)
    w_arr: torch.Tensor     # issue (arrival at the controller) cycle
    w_seq: torch.Tensor     # admission sequence (the oldest-first key)
    # per-core admission gates
    yg_served: torch.Tensor    # [G, C] youngest admitted request served?
    yg_done: torch.Tensor      # [G, C] its completion (the dep bound)
    ring_served: torch.Tensor  # [G, C, MSHR] the slot's occupant served?
    # per-rank ACT windows
    rank_last_act: torch.Tensor  # [G, NR] newest ACT (running max)
    faw_ring: torch.Tensor       # [G, NR, FAW_DEPTH] last four ACTs
    faw_ptr: torch.Tensor        # [G, NR] slot of the oldest of the four
    # controller clock (requests issued by it admit) and admission count
    now: torch.Tensor  # [G]
    seq: torch.Tensor  # [G]


def _init_window(shape: SimShape, n_points: int, n_cores: int, W: int,
                 device=None) -> WindowState:
    nr = shape.envelope.max_banks_total
    z = lambda *s, dt=_I32: torch.zeros((n_points,) + s, dtype=dt,
                                        device=device)
    full = lambda v, *s, dt=_I32: torch.full((n_points,) + s, v, dtype=dt,
                                             device=device)
    return WindowState(
        sim=sim_mod._init_state(shape, n_points, n_cores, device),
        w_valid=z(W, dt=torch.bool), w_core=z(W), w_idx=z(W), w_bank=z(W),
        w_row=z(W), w_write=z(W, dt=torch.bool), w_ns=z(W, dt=torch.bool),
        w_arr=z(W), w_seq=z(W),
        yg_served=full(True, n_cores, dt=torch.bool), yg_done=z(n_cores),
        ring_served=full(True, n_cores, shape.mshr, dt=torch.bool),
        rank_last_act=full(NEG, nr), faw_ring=full(NEG, nr, FAW_DEPTH),
        faw_ptr=z(nr), now=z(), seq=z())


def _make_window_step(shape: SimShape, W: int, p: MechParams, trace: dict,
                      ns, ns_idx, warmup_steps):
    """The step over ``[G]`` points: ``step(ws, step_idx)`` updates ``ws``
    in place and returns the step's ``Events``.  The stream and its
    lookahead tables are laid out as ``simulator._make_step`` takes
    them: one ``[C, L]`` stream shared by every point or one ``[G, C,
    L]`` a point, ``ns [n, C, L]`` and each point's row ``ns_idx [G]``."""
    g = torch.arange(ns_idx.shape[0], device=trace["gap"].device)
    fields = ("gap", "bank", "row", "is_write", "dep", "length")
    if trace["gap"].dim() == 2:
        gap, bank, row, is_write, dep, length = (trace[k][None]
                                                 for k in fields)
        tix = torch.zeros_like(g)
    else:
        gap, bank, row, is_write, dep, length = (trace[k] for k in fields)
        tix = g
    n_cores, L = gap.shape[1:]
    mshr = shape.mshr
    T = p.timing
    cores = torch.arange(n_cores, device=gap.device)
    length = length[tix]

    def admit_one(ws: WindowState) -> bool:
        """One admission attempt at every point: the earliest-issue
        eligible core's front request enters the first free slot if the
        window has room and the request has arrived (``issue <= now``;
        an empty window instead moves ``now`` up to the arrival).
        Returns whether any point admitted."""
        st = ws.sim
        ptr_c = torch.clamp(st.ptr, 0, L - 1)
        gi = tix[:, None]
        d = dep[gi, cores, ptr_c]
        # request i waits on MSHR slot i % mshr (its occupant, request
        # i - mshr, must be served) and, if dependent, on the core's
        # youngest admitted request
        pos = torch.remainder(st.ptr, mshr)
        issue = torch.maximum(st.last_issue + gap[gi, cores, ptr_c],
                              st.mshr_ring[g[:, None], cores, pos])
        issue = torch.maximum(issue, torch.where(d, ws.yg_done, 0))
        elig = ((st.ptr < length) & ws.ring_served[g[:, None], cores, pos]
                & (~d | ws.yg_served))
        issue = torch.where(elig, issue, INF)
        c = torch.argmin(issue, dim=1)
        t_iss = issue[g, c]
        occ = ws.w_valid.sum(dim=1, dtype=_I32)
        can = ((occ < p.win_cap) & (t_iss < INF)
               & ((t_iss <= ws.now) | (occ == 0)))
        if not bool(can.any()):
            return False
        slot = torch.argmin(ws.w_valid.to(_I32), dim=1)  # first free
        pc = ptr_c[g, c]
        b_f, r_f = fold_address(p.geom, bank[tix, c, pc], row[tix, c, pc])
        for arr, val in ((ws.w_valid, True), (ws.w_core, c),
                         (ws.w_idx, st.ptr[g, c]), (ws.w_bank, b_f),
                         (ws.w_row, r_f), (ws.w_write, is_write[tix, c, pc]),
                         (ws.w_ns, ns[ns_idx, c, pc]), (ws.w_arr, t_iss),
                         (ws.w_seq, ws.seq)):
            arr[g, slot] = torch.where(can, val, arr[g, slot]).to(arr.dtype)
        pos_c = pos[g, c]
        ws.yg_served[g, c] &= ~can
        ws.ring_served[g, c, pos_c] &= ~can
        st.last_issue[g, c] = torch.where(can, t_iss, st.last_issue[g, c])
        st.ptr[g, c] += can.to(_I32)
        ws.now.copy_(torch.where(can & (occ == 0),
                                 torch.maximum(ws.now, t_iss), ws.now))
        ws.seq.add_(can.to(_I32))
        return True

    def step(ws: WindowState, step_idx: int) -> Events:
        # 1. admission: at most W attempts
        for _ in range(W):
            if not admit_one(ws):
                break
        st = ws.sim

        # 2. FR-FCFS selection: row hits first, then the oldest admission
        hitv = ws.w_valid & (st.open_row[g[:, None], ws.w_bank] == ws.w_row)
        key = torch.where(ws.w_valid,
                          torch.where(hitv, 0, HIT_PENALTY) + ws.w_seq,
                          _I32_MAX)
        e = torch.argmin(key, dim=1)
        alive = ws.w_valid[g, e]
        cc = ws.w_core[g, e]
        bi = ws.w_bank[g, e]
        t_arr = torch.where(alive, ws.w_arr[g, e], INF)
        measure = (step_idx >= warmup_steps) & alive

        # 3. the rank's ACT floor (global rank id = bank // banks a rank);
        # 0 for in-order riders, which max() ignores
        rank = floordiv(bi, p.geom.n_banks)
        fslot = ws.faw_ptr[g, rank]
        floor = torch.maximum(ws.rank_last_act[g, rank] + T.tRRD,
                              ws.faw_ring[g, rank, fslot] + T.tFAW)
        floor = torch.where(p.frfcfs, floor, 0)
        done, events, (t_act, needs_act) = sim_mod._service(
            shape, p, st, t_arr, bi, ws.w_row[g, e], ws.w_write[g, e],
            ws.w_ns[g, e], measure, alive, act_floor=floor)

        # 4. the rank window (real ACTs of frfcfs points only); the
        # running max keeps the register monotone when an old miss is
        # served after a younger request activated later
        upd = needs_act & alive & p.frfcfs
        last = ws.rank_last_act[g, rank]
        ws.rank_last_act[g, rank] = torch.where(
            upd, torch.maximum(last, t_act), last)
        ws.faw_ring[g, rank, fslot] = torch.where(
            upd, t_act, ws.faw_ring[g, rank, fslot])
        ws.faw_ptr[g, rank] = torch.where(
            upd, torch.remainder(fslot + 1, FAW_DEPTH), fslot)

        # 5. core and window bookkeeping (masked on a dead step)
        w = lambda new, old: torch.where(alive, new, old)
        idx = ws.w_idx[g, e]
        pos = torch.remainder(idx, mshr)
        youngest = alive & (idx == st.ptr[g, cc] - 1)
        st.last_complete[g, cc] = w(done, st.last_complete[g, cc])
        st.mshr_ring[g, cc, pos] = w(done, st.mshr_ring[g, cc, pos])
        st.core_end[g, cc] = w(torch.maximum(st.core_end[g, cc], done),
                               st.core_end[g, cc])
        ws.w_valid[g, e] &= ~alive
        ws.yg_served[g, cc] |= youngest
        ws.yg_done[g, cc] = torch.where(youngest, done, ws.yg_done[g, cc])
        ws.ring_served[g, cc, pos] |= alive
        # the next decision happens once this service's commands are out
        # on its channel's command bus
        ch = dram_lib.channel_of(p.geom, bi)
        ws.now.copy_(w(torch.maximum(ws.now, st.cmd_bus_free[g, ch]),
                       ws.now))
        return events

    return step


def _run_window_impl(shape: SimShape, W: int, params: MechParams,
                     trace: dict, ns, ns_idx, warmup_steps, n_steps: int,
                     collect_events: bool = True):
    """The window engine's sibling of ``simulator._run_impl``: ``n_steps``
    steps of window depth ``W`` at every point of the ``[G]``-stacked
    ``params``; returns ``(stats, core_end [G, C], events or None)``
    with the same trailing-REF retire.  Steps past the last request are
    dead no-ops."""
    n_cores = trace["gap"].shape[-2]
    n_points = ns_idx.shape[0]
    device = trace["gap"].device
    ws = _init_window(shape, n_points, n_cores, W, device)
    step = _make_window_step(shape, W, params, trace, ns, ns_idx,
                             warmup_steps)
    events = None
    if collect_events:
        events = Events(*(
            torch.empty((n_points, n_steps), device=device,
                        dtype=torch.bool if f == "act_ref8" else _I32)
            for f in Events._fields))
    for s in range(n_steps):
        ev = step(ws, s)
        if events is not None:
            for lane, val in zip(events, ev):
                lane[:, s] = val
    stats = sim_mod._retire_trailing_refs(ws.sim.stats, ws.sim.core_end,
                                          params)
    return stats, ws.sim.core_end, events


def _run_window_synth_impl(shape: SimShape, W: int, params: MechParams,
                           wparams, ilparams, warmups, n_cores: int,
                           max_len: int, n_steps: int,
                           collect_events: bool = True,
                           stream: bool = False):
    """The synthetic window engine over ``[G]`` points: every point
    generates its stream (``workloads.generate``), its lookahead is
    recomputed over the folded stream, and the window engine scans it;
    returns what ``simulator._run_synth_impl`` returns."""
    from repro_torch.workloads.generator import generate
    trace = generate(n_cores, max_len, wparams, params.geom, ilparams)
    geom = GeomParams(*(x[:, None, None] for x in params.geom))
    fb, fr = fold_address(geom, trace["bank"], trace["row"])
    ns = sim_mod._next_same_folded(shape.envelope.max_banks_total, fb, fr,
                                   trace["length"])
    ns_idx = torch.arange(ns.shape[0], dtype=_I32, device=ns.device)
    out = _run_window_impl(shape, W, params, trace, ns, ns_idx, warmups,
                           n_steps, collect_events)
    if stream:
        return out + ({**trace, "next_same": ns},)
    return out

