"""Trace-driven DRAM system simulator (the Ramulator stand-in), in PyTorch.

Port of the trace-driven main path of ``repro.core.simulator``: one step
of the scan = one memory request, end to end —

1. **CPU issue model**: each core issues its next request after its
   front-end gap, subject to an MSHR window and (for dependent requests)
   the previous request's completion; the core with the earliest issue
   time goes next (ties to the lowest core index).
2. **Memory controller / bank state machine**: row hit / closed /
   conflict with full DDR3 timing, command and data bus serialization,
   rolling refresh (stateful REF counters or the legacy closed-form
   blackout), open-row or closed-row policy with queue-hit lookahead.
3. **Mechanisms**: the HCRAC insert/lookup substrate and the registry's
   timing-selection fold (``repro_torch.core.mechanisms``).

A configuration splits into a static ``SimShape`` (padded DRAM envelope,
HCRAC array sizes, MSHR depth) and per-point ``MechParams`` tensors.  A
sweep grid stacks ``MechParams`` along a leading ``[G]`` axis, and the
engine below (``_service`` / ``_make_step`` / ``_run_impl``) is written
once over that axis: it is the plain version of the CUDA kernel in
``repro_torch.kernels.sim_step``.  Which of the two runs is decided by
the device of the tensors: CPU tensors run this engine, CUDA tensors
launch the kernel.  There is no fallback between them.

The integer semantics follow the JAX package exactly (int32 wrap-around,
floor division and modulo, first-index ties), so results are bitwise
equal to ``repro`` (tests/test_torch_simulator.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import aldram as aldram_lib
from repro_torch.core import dram as dram_lib
from repro_torch.core import hcrac as hcrac_lib
from repro_torch.core import mechanisms as registry
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import timing as timing_lib
from repro_torch.core.dram import (DRAMConfig, DDR3_SYSTEM, DRAMEnvelope,
                                   GeomParams, NO_ROW, envelope_of,
                                   floordiv, fold_address, geom_params,
                                   refresh_adjust, time_since_refresh)
from repro_torch.core.mechanisms import default_nuat_bins
from repro_torch.core.timing import (TimingParams, TimingVec, DDR3_1600,
                                     ms_to_cycles)
from repro_torch.core.traces import TraceBatch

#: issue time of an exhausted core; a step whose earliest issue is INF is
#: a dead (padded) step that writes nothing
INF = 2**30

#: RLTL histogram bucket upper edges, in ms (thesis Fig 3.2 uses
#: 0.125..32 ms; finer + coarser tails added).
RLTL_EDGES_MS = (0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class MechanismConfig:
    #: any kind registered in ``repro_torch.core.mechanisms`` (builtins:
    #: base | lldram | chargecache | nuat | rltl | cc_nuat | aldram |
    #: cc_aldram)
    kind: str = "chargecache"
    hcrac: hcrac_lib.HCRACConfig = hcrac_lib.HCRACConfig()
    lowered: TimingParams = dataclasses.field(
        default_factory=lambda: DDR3_1600.with_reduction(4, 8))
    nuat_bins: tuple = ()
    #: AL-DRAM module profile (temperature / process bin)
    aldram: aldram_lib.ALDRAMConfig = aldram_lib.ALDRAMConfig()
    #: piecewise-constant temperature drift along the stream; empty = none
    thermal: aldram_lib.ThermalConfig = aldram_lib.ThermalConfig()

    def __post_init__(self):
        if self.kind not in registry.names():
            raise ValueError(f"unregistered mechanism kind {self.kind!r}; "
                             f"known: {registry.names()}")
        if "nuat" in registry.components(self.kind) and not self.nuat_bins:
            object.__setattr__(self, "nuat_bins", default_nuat_bins())


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One simulated system.  The trace-driven in-order engine is the only
    tier of this package so far; the fields that select the other tiers
    of ``repro`` are kept so that a configuration naming them fails
    loudly instead of running something else."""
    dram: DRAMConfig = DDR3_SYSTEM
    timing: TimingParams = DDR3_1600
    mech: MechanismConfig = MechanismConfig()
    policy: str = "open"      # "open" (1-core) | "closed" (8-core), Table 5.1
    mshr: int = 8
    warmup_frac: float = 0.05
    #: "stateful" REF counters (default) or the "legacy" closed-form
    #: blackout tier; per-point data, so both mix in one grid
    refresh_mode: str = "stateful"
    #: on-device workload synthesis (``repro``'s ``sweep_synth``)
    workload: object | None = None
    #: the serving loop (``repro``'s ``sweep_serving``)
    serving: object | None = None
    #: "inorder" (this engine) or "frfcfs" (``repro.controller``)
    controller: str = "inorder"

    def __post_init__(self):
        if self.policy not in ("open", "closed"):
            raise ValueError(f"unknown row policy {self.policy!r}")
        if self.refresh_mode not in ("legacy", "stateful"):
            raise ValueError(f"unknown refresh mode {self.refresh_mode!r}")
        if self.controller not in ("inorder", "frfcfs"):
            raise ValueError(f"unknown controller {self.controller!r}")
        if self.controller == "frfcfs":
            raise NotImplementedError(
                "the FR-FCFS controller tier is not ported yet "
                "(ROADMAP.md, Queue 1: FR-FCFS controller tier)")
        if self.serving is not None:
            raise NotImplementedError(
                "the serving loop is not ported yet "
                "(ROADMAP.md, Queue 1: Serving)")
        if self.workload is not None:
            raise NotImplementedError(
                "on-device workload synthesis is not ported yet "
                "(ROADMAP.md, Queue 1: On-device workload synthesis)")


# --------------------------------------------------------------------------
# Static shape vs per-point params
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimShape:
    """The static half of a configuration: everything that sizes state."""
    envelope: DRAMEnvelope        # padded geometry layout
    hcrac: hcrac_lib.HCRACConfig  # shape carrier: max sets / ways / expiry
    mshr: int


class MechParams(NamedTuple):
    """The per-point half: int32/bool/float32 tensors (0-d per
    configuration, ``[G]``-stacked in a sweep) plus one block per
    block-bearing mechanism policy (``mech[name]``, gated by its
    ``enable`` leaf)."""
    timing: TimingVec
    geom: GeomParams
    closed_policy: torch.Tensor      # bool: closed-row policy (auto-PRE)
    hcrac: hcrac_lib.HCRACParams
    mech: dict                       # {policy: {leaf: tensor}}
    refresh_stateful: torch.Tensor   # bool: stateful REF tier
    thermal: aldram_lib.ThermalParams


def sim_shape(cfg: SimConfig, n_sets_max: int | None = None,
              envelope: DRAMEnvelope | None = None) -> SimShape:
    """The static shape of ``cfg``; ``n_sets_max`` pads the HCRAC arrays
    and ``envelope`` the DRAM geometry so a whole grid shares one shape."""
    h = cfg.mech.hcrac
    env = envelope if envelope is not None else envelope_of([cfg.dram])
    if not env.covers(cfg.dram):
        raise ValueError(f"envelope {env} does not cover {cfg.dram}")
    return SimShape(envelope=env,
                    hcrac=hcrac_lib.padded_shape(h, n_sets_max or h.n_sets),
                    mshr=cfg.mshr)


def mech_params(cfg: SimConfig, hints: dict | None = None,
                envelope: DRAMEnvelope | None = None) -> MechParams:
    """``cfg``'s numeric content as one point's params (0-d tensors).

    ``hints`` carries grid-wide padding facts (the NUAT bin count, the
    thermal segment count) so every point of a sweep shares one block
    structure; the envelope's bank count is injected as the reserved
    ``n_banks_padded`` hint that sizes the per-bank AL-DRAM tables.
    """
    env = envelope if envelope is not None else envelope_of([cfg.dram])
    hints = hints if hints is not None else registry.pad_hints([cfg.mech])
    hints = {n: {**h, "n_banks_padded": env.max_banks_total}
             for n, h in hints.items()}
    n_segs = hints.get("aldram", {}).get("n_segs", cfg.mech.thermal.n_segs)
    th_en, th_edge, th_leak = aldram_lib.thermal_params_np(
        cfg.mech.thermal, n_segs)
    return MechParams(
        timing=timing_lib.traced(cfg.timing),
        geom=geom_params(cfg.dram),
        closed_policy=torch.tensor(cfg.policy == "closed"),
        hcrac=hcrac_lib.params_of(cfg.mech.hcrac),
        mech=registry.build_blocks(cfg.mech, cfg.timing, hints),
        refresh_stateful=torch.tensor(cfg.refresh_mode == "stateful"),
        thermal=aldram_lib.ThermalParams(
            enable=torch.tensor(bool(th_en)),
            seg_edge=torch.from_numpy(th_edge),
            seg_leak=torch.from_numpy(th_leak)),
    )


def _tree_map(fn, *trees):
    """Map ``fn`` over the leaves of equally-structured NamedTuple/dict
    trees."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def _grid_shape_and_params(grid: Sequence[SimConfig],
                           shape_grid: Sequence[SimConfig] | None = None,
                           device=None):
    """Validate a grid; return its shared ``SimShape`` and its ``[G]``-
    stacked ``MechParams`` on ``device``.

    ``shape_grid`` (a superset of ``grid``, defaulting to it) determines
    the padded envelope, HCRAC capacity and registry pad hints, so chunks
    of one larger grid share one shape.  Padding is behaviour-neutral.
    """
    grid = list(grid)
    shape_grid = list(shape_grid) if shape_grid is not None else grid
    c0 = grid[0]
    for cfg in grid + shape_grid:
        if (cfg.mshr != c0.mshr or cfg.warmup_frac != c0.warmup_frac
                or cfg.mech.hcrac.n_ways != c0.mech.hcrac.n_ways
                or cfg.mech.hcrac.exact_expiry
                != c0.mech.hcrac.exact_expiry):
            raise ValueError("a sweep grid must share mshr, warmup_frac, "
                             "HCRAC n_ways and exact_expiry")
        if cfg.mech.hcrac.caching_cycles < 1:
            raise ValueError("HCRAC caching_cycles must be >= 1")
    n_sets_max = max(cfg.mech.hcrac.n_sets for cfg in shape_grid)
    if n_sets_max < max(cfg.mech.hcrac.n_sets for cfg in grid):
        raise ValueError("shape_grid must cover every launched config's "
                         "HCRAC capacity")
    env = envelope_of([cfg.dram for cfg in grid + shape_grid])
    hints = registry.pad_hints([cfg.mech for cfg in shape_grid])
    shape = sim_shape(c0, n_sets_max=n_sets_max, envelope=env)
    # points differing only in what mech_params does not read share one
    key = lambda c: (c.timing, c.dram, c.policy, c.mech, c.refresh_mode)
    points: dict = {}
    for cfg in grid:
        if key(cfg) not in points:
            points[key(cfg)] = mech_params(cfg, hints=hints, envelope=env)
    stacked = _tree_map(lambda *xs: torch.stack(xs).to(device),
                        *(points[key(c)] for c in grid))
    return shape, stacked


def params_from_numpy(tree: dict, device=None) -> MechParams:
    """Build ``MechParams`` from a nested dict of numpy arrays keyed by
    field name — the layout of ``repro``'s stacked ``MechParams`` (its
    ``_asdict()`` tree).  ``repro``'s controller-tier leaves (``frfcfs``,
    ``win_cap``) are accepted only at their in-order values."""
    tree = dict(tree)
    frfcfs = tree.pop("frfcfs", None)
    win_cap = tree.pop("win_cap", None)
    if (frfcfs is not None and np.any(frfcfs)) or (
            win_cap is not None and np.any(np.asarray(win_cap) != 1)):
        raise NotImplementedError(
            "FR-FCFS controller params: that tier is not ported yet")
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)
    sub = lambda cls, d: cls(**{f: t(d[f]) for f in cls._fields})
    return MechParams(
        timing=sub(TimingVec, tree["timing"]),
        geom=sub(GeomParams, tree["geom"]),
        closed_policy=t(tree["closed_policy"]),
        hcrac=sub(hcrac_lib.HCRACParams, tree["hcrac"]),
        mech={n: {k: t(v) for k, v in b.items()}
              for n, b in tree["mech"].items()},
        refresh_stateful=t(tree["refresh_stateful"]),
        thermal=sub(aldram_lib.ThermalParams, tree["thermal"]),
    )


# --------------------------------------------------------------------------
# Engine state
# --------------------------------------------------------------------------

class SimState(NamedTuple):
    """Per-point engine state, every leaf with a leading ``[G]`` axis.
    The engine updates the tensors in place."""
    # per-core issue model
    ptr: torch.Tensor            # [G, C] next request index
    last_issue: torch.Tensor     # [G, C]
    last_complete: torch.Tensor  # [G, C]
    mshr_ring: torch.Tensor      # [G, C, MSHR] completion times
    ring_idx: torch.Tensor       # [G, C]
    core_end: torch.Tensor       # [G, C] completion of last request so far
    # per-bank state (NB = the padded envelope's bank count)
    open_row: torch.Tensor       # [G, NB]
    ready_act: torch.Tensor
    ready_rdwr: torch.Tensor
    ready_pre: torch.Tensor
    last_pre_gid: torch.Tensor   # row id of the bank's latest PRE
    last_pre_t: torch.Tensor     # cycle of that PRE (RLTL registers)
    ref_k: torch.Tensor          # REF windows issued so far (stateful tier)
    last_ref_t: torch.Tensor     # issue cycle of the bank's latest REF
    # per-channel buses
    cmd_bus_free: torch.Tensor   # [G, NCH]
    data_bus_free: torch.Tensor  # [G, NCH]
    hcrac: hcrac_lib.HCRACState
    stats: dict                  # STAT_KEYS: [G]; BANK_STAT_KEYS: [G, NB]


STAT_KEYS = ("n_req", "lat_sum", "acts", "acts_lowered", "hcrac_hits",
             "hcrac_lookups", "row_hits", "row_closed", "row_conflicts",
             "reads", "writes", "pres", "act_ras_sum", "refresh8ms_acts",
             "refs_issued", "ref_blocked_cycles")

#: per-bank accumulators, sized to the padded envelope (entries past a
#: point's active banks stay zero)
BANK_STAT_KEYS = ("bank_acts", "bank_act_ras_sum")


class Events(NamedTuple):
    """Per-step ACT/PRE event record for the RLTL post-pass, each lane
    ``[G, n_steps]``: int32, except ``act_ref8`` (bool).  A gid of -1
    means no event; a time lane is meaningful only where its gid is."""
    act_gid: torch.Tensor   # global row id of a measured ACT
    act_t: torch.Tensor
    act_ref8: torch.Tensor  # ACT within 8 ms of the row's refresh
    pre1_gid: torch.Tensor  # conflict-PRE of the old open row
    pre1_t: torch.Tensor
    pre2_gid: torch.Tensor  # auto-PRE (closed-row policy)
    pre2_t: torch.Tensor
    pre3_gid: torch.Tensor  # REF-implied PRE of the open row (stateful)
    pre3_t: torch.Tensor


def _init_state(shape: SimShape, n_points: int, n_cores: int,
                device=None) -> SimState:
    nb = shape.envelope.max_banks_total
    nch = shape.envelope.max_channels
    z = lambda *s: torch.zeros((n_points,) + s, dtype=_I32, device=device)
    full = lambda v, *s: torch.full((n_points,) + s, v, dtype=_I32,
                                    device=device)
    stats = {k: z() for k in STAT_KEYS}
    stats.update({k: z(nb) for k in BANK_STAT_KEYS})
    return SimState(
        ptr=z(n_cores), last_issue=z(n_cores), last_complete=z(n_cores),
        mshr_ring=z(n_cores, shape.mshr), ring_idx=z(n_cores),
        core_end=z(n_cores),
        open_row=full(NO_ROW, nb),
        ready_act=z(nb), ready_rdwr=z(nb), ready_pre=z(nb),
        last_pre_gid=full(-1, nb), last_pre_t=z(nb),
        ref_k=z(nb), last_ref_t=z(nb),
        cmd_bus_free=z(nch), data_bus_free=z(nch),
        hcrac=hcrac_lib.init(shape.hcrac, n_points, device),
        stats=stats,
    )


def _service(shape: SimShape, p: MechParams, st: SimState, t_arr, bank,
             row, is_write, next_same, measure, enable):
    """Serve one request at every point (all arguments ``[G]``): updates
    ``st`` in place and returns ``(done, events)``.

    ``enable`` marks a live step; a dead step's state writes are masked
    and its events carry gid -1.
    """
    T = p.timing
    geom = p.geom
    hshape = shape.hcrac
    g = torch.arange(bank.shape[0], device=bank.device)
    ch = dram_lib.channel_of(geom, bank)
    stats = st.stats

    t0 = torch.maximum(t_arr, st.cmd_bus_free[g, ch])
    hc_gate = registry.hcrac_gate(p.mech)

    # --- rolling refresh: the stateful tier catches the bank's REF counter
    # up to the schedule (only the newest pending REF can still block); a
    # REF implies a precharge, closes the open row (HCRAC insert) and
    # advances every bank-ready clock to the end of its tRFC blackout
    stateful = p.refresh_stateful
    legacy = ~stateful
    ref_due = floordiv(t0, T.tREFI) + 1
    n_pend = torch.clamp(ref_due - st.ref_k[g, bank], min=0)
    do_ref = stateful & (n_pend > 0) & enable
    ready_act = st.ready_act[g, bank]
    ready_pre = st.ready_pre[g, bank]
    ready_rdwr = st.ready_rdwr[g, bank]
    busy0 = torch.maximum(torch.maximum(ready_act, ready_pre), ready_rdwr)
    ref_t = torch.maximum((ref_due - 1) * T.tREFI, ready_pre)
    ref_done = ref_t + T.tRFC
    openr0 = st.open_row[g, bank]
    ref_pre = do_ref & (openr0 != NO_ROW)
    openr = torch.where(do_ref, NO_ROW, openr0)
    clamp = lambda rdy: torch.where(do_ref, torch.maximum(rdy, ref_done), rdy)
    r_act_b = clamp(ready_act)
    r_pre_b = clamp(ready_pre)
    r_rdwr_b = clamp(ready_rdwr)
    gid_ref = dram_lib.global_row_id(geom, bank,
                                     torch.where(ref_pre, openr0, 0))
    hcrac_lib.insert(hshape, st.hcrac, gid_ref, ref_t, ref_pre & hc_gate,
                     p.hcrac)
    # legacy tier: the closed-form blackout, gated to the row's group
    radj = lambda tt: torch.where(legacy, refresh_adjust(T, tt, row), tt)

    is_hit = openr == row
    is_closed = openr == NO_ROW
    is_conflict = ~is_hit & ~is_closed

    # --- conflict path: PRE the open row (insert it into the HCRAC) ------
    t_pre = radj(torch.maximum(t0, r_pre_b))
    gid_old = dram_lib.global_row_id(geom, bank,
                                     torch.where(is_conflict, openr, 0))
    hcrac_lib.insert(hshape, st.hcrac, gid_old, t_pre,
                     is_conflict & hc_gate & enable, p.hcrac)

    # --- ACT ---------------------------------------------------------------
    t_act = torch.where(is_conflict, radj(t_pre + T.tRP),
                        radj(torch.maximum(t0, r_act_b)))
    needs_act = ~is_hit
    gid = dram_lib.global_row_id(geom, bank, row)
    cc_hit, _ = hcrac_lib.lookup(hshape, st.hcrac, gid, t_act, enable,
                                 p.hcrac)
    cc_hit = cc_hit & needs_act & hc_gate

    # per-bank last-PRE registers: cycles since this row's own latest PRE
    tslp = torch.where(st.last_pre_gid[g, bank] == gid,
                       t_act - st.last_pre_t[g, bank], INF)

    # leak clock: the legacy tier uses the closed-form schedule phase; the
    # stateful tier keys off the actual last REF of the row's group (the
    # bank's own newest REF, or an older one that ran on schedule)
    tsr_closed = time_since_refresh(geom, T, row, t_act)
    kw = ref_due - 1
    j_g = kw - torch.remainder(
        kw - torch.remainder(row, T.n_refresh_groups), T.n_refresh_groups)
    new_last_ref_t = torch.where(do_ref, ref_t, st.last_ref_t[g, bank])
    t_ref = torch.where(j_g == kw, new_last_ref_t, j_g * T.tREFI)
    tsr = torch.where(stateful & (j_g >= 0),
                      torch.clamp(t_act - t_ref, min=0), tsr_closed)
    # thermal drift: NUAT sees the leak clock scaled by the segment's
    # leak-rate multiplier (float32 multiply, round half to even).  A grid
    # without drift has S == 0 and skips this
    n_segs = p.thermal.seg_edge.shape[-1]
    if n_segs > 0:
        seg = (t_act[:, None] >= p.thermal.seg_edge).sum(
            dim=1, dtype=_I32) - 1
        seg = torch.clamp(seg, 0, n_segs - 1)
        tsr_eff = torch.where(
            p.thermal.enable,
            torch.round(tsr.to(torch.float32)
                        * p.thermal.seg_leak[g, seg]).to(_I32),
            tsr)
    else:
        seg = torch.zeros_like(bank)
        tsr_eff = tsr
    ctx = registry.SelectCtx(timing=T, geom=geom, hcrac_hit=cc_hit,
                             tsr=tsr_eff, tslp=tslp, needs_act=needs_act,
                             bank=bank, seg=seg)
    rcd, ras = registry.select_timings(p.mech, ctx)
    lowered_used = needs_act & ((rcd < T.tRCD) | (ras < T.tRAS))

    # --- READ / WRITE -------------------------------------------------------
    t_rdwr = torch.where(is_hit, torch.maximum(t0, r_rdwr_b), t_act + rcd)
    cas = torch.where(is_write, T.tCWL, T.tCL)
    # data bus occupancy: burst occupies [t_rdwr + cas, + tBL)
    t_rdwr = torch.maximum(t_rdwr, st.data_bus_free[g, ch] - cas)
    t_rdwr = torch.where(
        legacy, dram_lib.refresh_clamp_span(T, t_rdwr, cas + T.tBL, row),
        t_rdwr)
    done = t_rdwr + cas + T.tBL

    # --- bank state updates -------------------------------------------------
    new_ready_rdwr = torch.where(needs_act, t_act + rcd, r_rdwr_b)
    after_rw = torch.where(is_write, done + T.tWR, t_rdwr + T.tRTP)
    new_ready_pre = torch.maximum(
        torch.where(needs_act, t_act + ras, r_pre_b), after_rw)

    # closed-row policy: auto-precharge unless the next queued request from
    # this core hits the same row (queue-hit lookahead)
    auto_pre = p.closed_policy & ~next_same
    t_autopre = new_ready_pre
    hcrac_lib.insert(hshape, st.hcrac, gid, t_autopre,
                     auto_pre & hc_gate & enable, p.hcrac)
    new_open = torch.where(auto_pre, NO_ROW, row)
    new_ready_act = torch.where(
        auto_pre, t_autopre + T.tRP,
        torch.where(is_conflict, t_pre + T.tRP, r_act_b))

    i32 = lambda b: b.to(_I32)
    n_cmds = 1 + i32(needs_act) + i32(is_conflict) + i32(auto_pre)
    new_cmd_free = torch.maximum(st.cmd_bus_free[g, ch], t_arr) + n_cmds

    # last-PRE registers: the auto-PRE (if any) postdates the conflict-PRE,
    # which postdates the REF's implied precharge
    lp_gid0 = torch.where(ref_pre, gid_ref, st.last_pre_gid[g, bank])
    lp_t0 = torch.where(ref_pre, ref_t, st.last_pre_t[g, bank])
    new_lp_gid = torch.where(auto_pre, gid,
                             torch.where(is_conflict, gid_old, lp_gid0))
    new_lp_t = torch.where(auto_pre, t_autopre,
                           torch.where(is_conflict, t_pre, lp_t0))

    # --- stats ---------------------------------------------------------------
    m = i32(measure)
    acts = m * needs_act
    ref8 = needs_act & measure & (tsr < ms_to_cycles(8.0))
    for key, val in (
            ("n_req", m),
            ("lat_sum", m * (done - t_arr)),
            ("acts", acts),
            ("acts_lowered", m * lowered_used),
            ("hcrac_lookups", m * (needs_act & hc_gate)),
            ("hcrac_hits", m * cc_hit),
            ("row_hits", m * is_hit),
            ("row_closed", m * is_closed),
            ("row_conflicts", m * is_conflict),
            ("reads", m * ~is_write),
            ("writes", m * is_write),
            ("pres", m * (i32(is_conflict) + i32(auto_pre))),
            ("act_ras_sum", acts * ras),
            ("refresh8ms_acts", i32(ref8)),
            ("refs_issued", m * i32(stateful) * n_pend),
            ("ref_blocked_cycles", torch.where(
                do_ref & measure,
                torch.clamp(ref_done - torch.maximum(t0, busy0), min=0), 0))):
        stats[key] += val
    stats["bank_acts"][g, bank] += acts
    stats["bank_act_ras_sum"][g, bank] += acts * ras

    events = Events(
        act_gid=torch.where(needs_act & measure, gid, -1),
        act_t=t_act,
        act_ref8=ref8,
        pre1_gid=torch.where(is_conflict & enable, gid_old, -1),
        pre1_t=t_pre,
        pre2_gid=torch.where(auto_pre & enable, gid, -1),
        pre2_t=t_autopre,
        pre3_gid=torch.where(ref_pre, gid_ref, -1),
        pre3_t=ref_t,
    )

    # masked writes: a dead step leaves every state word untouched
    w = lambda new, old: torch.where(enable, new, old)
    for arr, new in ((st.open_row, new_open), (st.ready_act, new_ready_act),
                     (st.ready_rdwr, new_ready_rdwr),
                     (st.ready_pre, new_ready_pre),
                     (st.last_pre_gid, new_lp_gid),
                     (st.last_pre_t, new_lp_t)):
        arr[g, bank] = w(new, arr[g, bank])
    # do_ref already folds ``enable`` (and the stateful gate) in
    st.ref_k[g, bank] = torch.where(do_ref, ref_due, st.ref_k[g, bank])
    st.last_ref_t[g, bank] = new_last_ref_t
    st.cmd_bus_free[g, ch] = w(new_cmd_free, st.cmd_bus_free[g, ch])
    st.data_bus_free[g, ch] = w(done, st.data_bus_free[g, ch])
    return done, events


def _make_step(shape: SimShape, p: MechParams, trace: dict, ns, ns_idx,
               warmup_steps: int):
    """The per-request step over ``[G]`` points: ``step(st, step_idx)``
    updates ``st`` in place and returns the step's ``Events``.

    ``ns [n_geom, C, L]`` holds one queue-hit lookahead per distinct
    geometry and ``ns_idx [G]`` each point's row of it."""
    gap, bank, row = trace["gap"], trace["bank"], trace["row"]
    is_write, dep, length = trace["is_write"], trace["dep"], trace["length"]
    n_cores, L = gap.shape
    cores = torch.arange(n_cores, device=gap.device)
    g = torch.arange(ns_idx.shape[0], device=gap.device)

    def step(st: SimState, step_idx: int):
        # 1. earliest-issue core selection (ties to the lowest core index)
        ptr_c = torch.clamp(st.ptr, 0, L - 1)
        issue = torch.maximum(
            st.last_issue + gap[cores, ptr_c],
            st.mshr_ring[g[:, None], cores, st.ring_idx])
        issue = torch.maximum(
            issue, torch.where(dep[cores, ptr_c], st.last_complete, 0))
        issue = torch.where(st.ptr >= length, INF, issue)
        c = torch.argmin(issue, dim=1)
        t_arr = issue[g, c]

        # a step with every core exhausted is a dead no-op
        alive = t_arr < INF
        measure = alive & (step_idx >= warmup_steps)
        pc = ptr_c[g, c]
        b_act, r_act = fold_address(p.geom, bank[c, pc], row[c, pc])
        done, events = _service(shape, p, st, t_arr, b_act, r_act,
                                is_write[c, pc], ns[ns_idx, c, pc],
                                measure, alive)

        # 2. core bookkeeping (masked: a dead step must not advance cores)
        w = lambda new, old: torch.where(alive, new, old)
        ri = st.ring_idx[g, c]
        st.ptr[g, c] += alive.to(_I32)
        st.last_issue[g, c] = w(t_arr, st.last_issue[g, c])
        st.last_complete[g, c] = w(done, st.last_complete[g, c])
        st.mshr_ring[g, c, ri] = w(done, st.mshr_ring[g, c, ri])
        st.ring_idx[g, c] = w(torch.remainder(ri + 1, shape.mshr), ri)
        st.core_end[g, c] = w(torch.maximum(st.core_end[g, c], done),
                              st.core_end[g, c])
        return events

    return step


def _next_same_folded(nb: int, bank, row, length):
    """Closed-row queue-hit lookahead over *folded* addresses: ``out[..., c,
    i]`` is True iff core ``c``'s next live request to the same bank
    targets the same row.

    Vectorised form of ``repro``'s reverse scan: a stable sort by bank
    keeps each bank's requests in index order, so every live entry's
    successor in sorted order is its core's next request to that bank.
    Entries at or past ``length`` neither match nor are matched.
    """
    L = bank.shape[-1]
    bank, row = torch.broadcast_tensors(bank, row)
    live = torch.arange(L, device=bank.device) < length[:, None]
    key = torch.where(live, bank, nb)      # dead entries sort after all banks
    order = torch.sort(key, dim=-1, stable=True).indices
    kb = key.gather(-1, order)
    kr = row.gather(-1, order)
    same = ((kb[..., 1:] == kb[..., :-1]) & (kb[..., :-1] < nb)
            & (kr[..., 1:] == kr[..., :-1]))
    same = torch.cat([same, torch.zeros_like(same[..., :1])], dim=-1)
    return torch.zeros_like(same).scatter_(-1, order, same)


def _hoist_geoms(grid: Sequence[SimConfig], shape_grid: Sequence[SimConfig],
                 device=None):
    """The distinct fold geometries of a trace sweep (keyed over
    ``shape_grid`` so chunks of one grid share one table shape), stacked
    as ``GeomParams [n_geom]``, and each launched point's index into
    them (``int32 [G]``)."""
    keys: list[tuple] = []
    reps: list[DRAMConfig] = []
    for cfg in list(shape_grid) + list(grid):
        k = (cfg.dram.banks_total, cfg.dram.n_rows)
        if k not in keys:
            keys.append(k)
            reps.append(cfg.dram)
    idx = [keys.index((cfg.dram.banks_total, cfg.dram.n_rows))
           for cfg in grid]
    ns_geoms = _tree_map(lambda *xs: torch.stack(xs).to(device),
                         *(geom_params(d) for d in reps))
    return ns_geoms, torch.tensor(idx, dtype=_I32, device=device)


def _ns_tables(shape: SimShape, trace: dict, ns_geoms: GeomParams):
    """One folded queue-hit lookahead per distinct geometry:
    ``bool [n_geom, C, L]``."""
    col = GeomParams(*(x[:, None, None] for x in ns_geoms))
    fb, fr = fold_address(col, trace["bank"], trace["row"])
    return _next_same_folded(shape.envelope.max_banks_total, fb, fr,
                             trace["length"])


def _retire_trailing_refs(stats: dict, core_end, p: MechParams) -> dict:
    """Stateful tier: overwrite ``refs_issued`` with the rolling schedule
    over ``[0, total_cycles]`` — one REF per bank per elapsed tREFI window,
    including the window opening at t = 0."""
    stats = dict(stats)
    total = core_end.max(dim=-1).values
    sched = (floordiv(total, p.timing.tREFI) + 1) * p.geom.banks_total
    stats["refs_issued"] = torch.where(p.refresh_stateful, sched,
                                       stats["refs_issued"])
    return stats


def _run_impl(shape: SimShape, params: MechParams, trace: dict, ns, ns_idx,
              warmup_steps: int, n_steps: int, collect_events: bool = True):
    """Run ``n_steps`` requests at every point of the ``[G]``-stacked
    ``params``; returns ``(stats, core_end [G, C], events or None)``.

    ``n_steps`` may exceed the trace's request count: once every core is
    exhausted the remaining steps are dead no-ops.
    """
    n_cores = trace["gap"].shape[0]
    n_points = ns_idx.shape[0]
    device = trace["gap"].device
    st = _init_state(shape, n_points, n_cores, device)
    step = _make_step(shape, params, trace, ns, ns_idx, warmup_steps)
    events = None
    if collect_events:
        events = Events(*(
            torch.empty((n_points, n_steps), device=device,
                        dtype=torch.bool if f == "act_ref8" else _I32)
            for f in Events._fields))
    for s in range(n_steps):
        ev = step(st, s)
        if events is not None:
            for lane, val in zip(events, ev):
                lane[:, s] = val
    stats = _retire_trailing_refs(st.stats, st.core_end, params)
    return stats, st.core_end, events


# --------------------------------------------------------------------------
# RLTL post-pass and finishing
# --------------------------------------------------------------------------

def _rltl_post_pass(events) -> tuple[np.ndarray, int]:
    """Host (numpy) reference: match each measured ACT of one point to the
    most recent PRE of the same row; returns the RLTL interval histogram
    (thesis Fig 3.2 buckets) and the number of ACTs with a preceding PRE.
    ``events`` holds one point's ``[n_steps]`` lanes."""
    ev = Events(*(np.asarray(x) for x in events))
    pre_gid = np.concatenate([ev.pre1_gid, ev.pre2_gid, ev.pre3_gid])
    pre_t = np.concatenate([ev.pre1_t, ev.pre2_t, ev.pre3_t])
    am = ev.act_gid >= 0
    pm = pre_gid >= 0
    gid = np.concatenate([ev.act_gid[am], pre_gid[pm]])
    t = np.concatenate([ev.act_t[am], pre_t[pm]])
    kind = np.concatenate([np.ones(am.sum(), np.int8),
                           np.zeros(pm.sum(), np.int8)])  # PRE=0 < ACT=1
    order = np.lexsort((kind, t, gid))
    gid, t, kind = gid[order], t[order], kind[order]
    prev_same = np.zeros(len(gid), bool)
    prev_same[1:] = gid[1:] == gid[:-1]
    prev_is_pre = np.zeros(len(gid), bool)
    prev_is_pre[1:] = kind[:-1] == 0
    valid = (kind == 1) & prev_same & prev_is_pre
    intervals = np.where(valid, t - np.roll(t, 1), 0)[valid]
    edges = np.array([ms_to_cycles(e) for e in RLTL_EDGES_MS])
    bucket = np.searchsorted(edges, intervals, side="left")
    hist = np.bincount(bucket, minlength=len(RLTL_EDGES_MS) + 1)
    return hist.astype(np.int64), int(valid.sum())


def _rltl_device(events: Events):
    """The RLTL post-pass on the device that holds the events, batched
    over ``[G]``: returns ``(hist [G, B+1] int64, total [G] int64)``,
    bitwise ``_rltl_post_pass`` per point.

    Empty event slots are rewritten to a sentinel row id (maximal, kind
    ACT) so the stable sort parks them after every live row; they never
    validate.  The lexicographic (gid, t, kind) order is two stable sorts:
    by ``2 t + kind``, then by gid.
    """
    gid = torch.cat([events.act_gid, events.pre1_gid, events.pre2_gid,
                     events.pre3_gid], dim=-1)
    t = torch.cat([events.act_t, events.pre1_t, events.pre2_t,
                   events.pre3_t], dim=-1)
    n = events.act_gid.shape[-1]
    kind = torch.zeros_like(gid, dtype=torch.int64)
    kind[..., :n] = 1                                   # PRE=0 < ACT=1
    sent = 2**31 - 1
    live = gid >= 0
    gid = torch.where(live, gid, sent)
    kind = torch.where(live, kind, 1)
    order = torch.sort(t.to(torch.int64) * 2 + kind, dim=-1,
                       stable=True).indices
    order = order.gather(-1, torch.sort(gid.gather(-1, order), dim=-1,
                                        stable=True).indices)
    gid, t, kind = (x.gather(-1, order) for x in (gid, t, kind))
    no = torch.zeros_like(gid[..., :1], dtype=torch.bool)
    prev_same = torch.cat([no, gid[..., 1:] == gid[..., :-1]], dim=-1)
    prev_is_pre = torch.cat([no, kind[..., :-1] == 0], dim=-1)
    valid = (kind == 1) & prev_same & prev_is_pre & (gid != sent)
    prev_t = torch.cat([t[..., :1], t[..., :-1]], dim=-1)
    intervals = torch.where(valid, t - prev_t, 0)
    edges = torch.tensor([ms_to_cycles(e) for e in RLTL_EDGES_MS],
                         dtype=intervals.dtype, device=intervals.device)
    bucket = torch.searchsorted(edges, intervals.contiguous(), right=False)
    hist = torch.zeros(gid.shape[:-1] + (len(RLTL_EDGES_MS) + 1,),
                       dtype=torch.int64, device=gid.device)
    hist.scatter_add_(-1, bucket, valid.to(torch.int64))
    return hist, valid.sum(dim=-1)


def _device_trace(batch: TraceBatch, device=None) -> dict:
    """The trace arrays the engine reads, as tensors on ``device``.  The
    host ``batch.next_same`` is not shipped: the engine recomputes the
    lookahead over the folded stream (``_ns_tables``)."""
    t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    return {"gap": t(batch.gap, _I32), "bank": t(batch.bank, _I32),
            "row": t(batch.row, _I32),
            "is_write": t(batch.is_write, torch.bool),
            "dep": t(batch.dep, torch.bool),
            "length": t(batch.length, _I32)}


def _check_horizon(batch: TraceBatch) -> int:
    """The request count of ``batch``, after the int32 cycle-horizon
    guards (request count, and the arrival clock alone)."""
    n_req = int(np.asarray(batch.length).sum())
    if n_req >= 2**24:
        raise ValueError("trace too long for the int32 cycle horizon")
    arrival = int(np.asarray(batch.gap, np.int64).sum(axis=1).max())
    if arrival >= INF:
        raise ValueError(
            f"trace arrival clock ({arrival} cycles) overflows the int32 "
            f"horizon ({INF}); split the stream into shorter chunks")
    return n_req


def _finalize(raw_stats: dict, core_end, rltl: tuple, lengths: np.ndarray,
              cfg: SimConfig | None = None) -> dict:
    """Host-side post-processing of one point: numpy stats, the RLTL
    histogram, ``total_cycles`` and the registered derived metrics."""
    stats = {k: np.asarray(v) for k, v in raw_stats.items()}
    hist, rltl_total = rltl
    stats["rltl_hist"] = None if hist is None else np.asarray(hist)
    stats["rltl_total"] = None if rltl_total is None else int(rltl_total)
    stats["core_end"] = np.asarray(core_end)
    stats["total_cycles"] = int(stats["core_end"].max())
    if not 0 <= stats["total_cycles"] < INF:
        raise OverflowError(
            f"cycle clock overflowed the int32 horizon "
            f"(total_cycles={stats['total_cycles']}, limit={INF}); "
            f"split the stream into shorter chunks or reduce mean_gap")
    stats["n_cores"] = int(np.asarray(lengths).shape[0])
    stats["lengths"] = np.asarray(lengths)
    if cfg is not None:
        stats["n_channels"] = cfg.dram.n_channels
        stats["n_ranks"] = cfg.dram.n_ranks
        stats["n_banks"] = cfg.dram.n_banks
        stats["banks_total"] = cfg.dram.banks_total
    return metrics_lib.finalize_scalars(stats)


def _resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch engine on the CPU")
    return device


def _stage(batch: TraceBatch, grid: Sequence[SimConfig], device,
           pad_steps: bool = False,
           shape_grid: Sequence[SimConfig] | None = None,
           n_steps: int | None = None) -> tuple:
    """Everything one sweep launch reads, on ``device``: ``(shape,
    stacked params, trace, lookahead tables, ns_idx, warm-up steps,
    n_steps)`` — the leading arguments of ``ops.run_sweep``.  ``n_steps``
    defaults to the request count (``pad_steps``: cores x padded
    length)."""
    grid = list(grid)
    if not grid:
        raise ValueError("empty sweep grid")
    shape, stacked = _grid_shape_and_params(grid, shape_grid, device)
    n_req = _check_horizon(batch)
    trace = _device_trace(batch, device)
    if n_steps is None:
        n_steps = batch.gap.size if pad_steps else n_req
    ns_geoms, ns_idx = _hoist_geoms(
        grid, shape_grid if shape_grid is not None else grid, device)
    ns = _ns_tables(shape, trace, ns_geoms)
    return (shape, stacked, trace, ns, ns_idx,
            int(grid[0].warmup_frac * n_req), n_steps)


def sweep(batch: TraceBatch, grid: Sequence[SimConfig],
          pad_steps: bool = False, rltl: bool = True,
          shape_grid: Sequence[SimConfig] | None = None, device=None):
    """Evaluate every configuration in ``grid`` on ``batch`` in one launch.

    The grid (any mix of registered mechanism kinds, HCRAC capacities,
    caching durations, timing sets, row and refresh policies, and DRAM
    geometries padded to a shared envelope) is stacked into ``[G]``
    params and run as one sweep: on a CUDA device by one launch of the
    ``sim_step`` kernel, on the CPU by the plain engine.  Returns one
    stats dict per point, bitwise equal to ``repro.core.sweep``.

    ``pad_steps=True`` runs ``cores x padded length`` steps instead of the
    exact request count (padded steps are no-ops).  ``rltl=False`` skips
    the event record (``rltl_hist=None``).  ``shape_grid`` pads shapes for
    a larger grid than the one launched.  ``device`` defaults to CUDA.
    """
    from repro_torch.kernels.sim_step import ops as sim_step_ops

    grid = list(grid)
    launch = _stage(batch, grid, _resolve_device(device), pad_steps,
                    shape_grid)
    stats, core_end, events = sim_step_ops.run_sweep(*launch, rltl)
    hist = total = None
    if events is not None:
        hist, total = (x.cpu().numpy() for x in _rltl_device(events))
    stats_np = {k: v.cpu().numpy() for k, v in stats.items()}
    core_np = core_end.cpu().numpy()
    return [
        _finalize({k: v[i] for k, v in stats_np.items()}, core_np[i],
                  (None, None) if hist is None else (hist[i], total[i]),
                  batch.length, cfg)
        for i, cfg in enumerate(grid)
    ]


def simulate(batch: TraceBatch, cfg: SimConfig = SimConfig(),
             device=None) -> dict:
    """Run one configuration on a trace batch; returns its stats dict
    (a one-point ``sweep``)."""
    return sweep(batch, [cfg], device=device)[0]


def weighted_speedup(core_end_base: np.ndarray, core_end_mech: np.ndarray,
                     alone_end: np.ndarray | None = None) -> float:
    """Thesis metric: WS = sum_i IPC_shared_i / IPC_alone_i; with fixed
    per-core instruction counts this reduces to cycle ratios.  The speedup
    of a mechanism is WS_mech / WS_base."""
    if alone_end is None:
        alone_end = core_end_base
    ws_base = float(np.sum(alone_end / np.maximum(core_end_base, 1)))
    ws_mech = float(np.sum(alone_end / np.maximum(core_end_mech, 1)))
    return ws_mech / max(ws_base, 1e-9)
