"""DRAM system simulator (the Ramulator stand-in), in PyTorch.

Port of ``repro.core.simulator``'s in-order engine, over a trace
(``simulate`` / ``sweep``) or over streams each grid point generates
for itself (``simulate_synth`` / ``sweep_synth``, the generator in
``repro_torch.workloads``); the serving closed loop's entry points
(``simulate_serving`` / ``sweep_serving``) lead to
``repro_torch.serving.loop``, whose engine calls ``_service`` here.  One step of the scan = one memory request,
end to end —

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
import functools
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
                                   GeomParams, InterleaveConfig, NO_ROW,
                                   envelope_of, floordiv, fold_address,
                                   geom_params,
                                   refresh_adjust, time_since_refresh)
from repro_torch.core.mechanisms import default_nuat_bins
from repro_torch.core.timing import (TimingParams, TimingVec, DDR3_1600,
                                     ms_to_cycles)
from repro_torch.core.traces import (WORKLOAD_BY_NAME, TraceBatch,
                                     WorkloadSpec)

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
    """One simulated system.  The in-order engine, trace-driven or over an
    on-device synthetic stream (``workload``), is the only tier of this
    package so far; the fields that select the other tiers of ``repro``
    are kept so that a configuration naming them fails loudly instead of
    running something else."""
    dram: DRAMConfig = DDR3_SYSTEM
    timing: TimingParams = DDR3_1600
    mech: MechanismConfig = MechanismConfig()
    policy: str = "open"      # "open" (1-core) | "closed" (8-core), Table 5.1
    mshr: int = 8
    warmup_frac: float = 0.05
    #: "stateful" REF counters (default) or the "legacy" closed-form
    #: blackout tier; per-point data, so both mix in one grid
    refresh_mode: str = "stateful"
    #: synthetic workload (a ``traces.WorkloadSpec``) for the streamed
    #: path (``simulate_synth`` / ``sweep_synth``); ``None`` means
    #: trace-driven (the caller supplies a ``TraceBatch``)
    workload: WorkloadSpec | None = None
    #: channel-interleave policy of the streamed path's address
    #: composition (``dram.compose_address``); unused by traces
    interleave: InterleaveConfig = InterleaveConfig()
    #: the serving closed loop (a ``serving.loop.ServingSpec``) for
    #: ``simulate_serving`` / ``sweep_serving``; ``None`` means trace- or
    #: workload-driven as above
    serving: object | None = None
    #: "inorder" (this engine) or "frfcfs" (``repro.controller``)
    controller: str = "inorder"

    def __post_init__(self):
        if self.workload is not None and not isinstance(self.workload,
                                                        WorkloadSpec):
            raise TypeError("SimConfig.workload must be a WorkloadSpec")
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
            from repro_torch.serving.loop.spec import ServingSpec
            if not isinstance(self.serving, ServingSpec):
                raise TypeError("SimConfig.serving must be a ServingSpec")


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

#: the integer metric ingredients a launch can reduce to an int32
#: ``[G, n_deps]`` array on the device: the scalar counters plus
#: ``total_cycles`` (the max over the per-core end times)
REDUCE_KEYS = STAT_KEYS + ("total_cycles",)


def _reduce_device(raw_stats: dict, core_end, reduce_keys: tuple):
    """Stack the requested scalar counters into an int32 ``[G, n_deps]``
    array on the device that holds them."""
    bad = [k for k in reduce_keys if k not in REDUCE_KEYS]
    if bad:
        raise ValueError(f"unknown reduce keys {bad}; known: {REDUCE_KEYS}")
    return torch.stack([core_end.max(dim=-1).values if k == "total_cycles"
                        else raw_stats[k] for k in reduce_keys], dim=-1)


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
               warmup_steps):
    """The per-request step over ``[G]`` points: ``step(st, step_idx)``
    updates ``st`` in place and returns the step's ``Events``.

    The trace is one ``[C, L]`` stream shared by every point, or one
    ``[G, C, L]`` stream per point (the synthetic path).  ``ns [n, C,
    L]`` holds the queue-hit lookaheads and ``ns_idx [G]`` each point's
    row of it.  ``warmup_steps`` is an int or a ``[G]`` tensor."""
    g = torch.arange(ns_idx.shape[0], device=trace["gap"].device)
    fields = ("gap", "bank", "row", "is_write", "dep", "length")
    if trace["gap"].dim() == 2:     # one stream shared by every point
        gap, bank, row, is_write, dep, length = (trace[k][None]
                                                 for k in fields)
        tix = torch.zeros_like(g)
    else:
        gap, bank, row, is_write, dep, length = (trace[k] for k in fields)
        tix = g
    n_cores, L = gap.shape[1:]
    cores = torch.arange(n_cores, device=gap.device)
    length = length[tix]

    def step(st: SimState, step_idx: int):
        # 1. earliest-issue core selection (ties to the lowest core index)
        ptr_c = torch.clamp(st.ptr, 0, L - 1)
        issue = torch.maximum(
            st.last_issue + gap[tix[:, None], cores, ptr_c],
            st.mshr_ring[g[:, None], cores, st.ring_idx])
        issue = torch.maximum(
            issue, torch.where(dep[tix[:, None], cores, ptr_c],
                               st.last_complete, 0))
        issue = torch.where(st.ptr >= length, INF, issue)
        c = torch.argmin(issue, dim=1)
        t_arr = issue[g, c]

        # a step with every core exhausted is a dead no-op
        alive = t_arr < INF
        measure = alive & (step_idx >= warmup_steps)
        pc = ptr_c[g, c]
        b_act, r_act = fold_address(p.geom, bank[tix, c, pc],
                                    row[tix, c, pc])
        done, events = _service(shape, p, st, t_arr, b_act, r_act,
                                is_write[tix, c, pc], ns[ns_idx, c, pc],
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
    live = torch.arange(L, device=bank.device) < length[..., None]
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
              warmup_steps, n_steps: int, collect_events: bool = True):
    """Run ``n_steps`` requests at every point of the ``[G]``-stacked
    ``params``; returns ``(stats, core_end [G, C], events or None)``.

    ``n_steps`` may exceed the trace's request count: once every core is
    exhausted the remaining steps are dead no-ops.
    """
    n_cores = trace["gap"].shape[-2]
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


def _stage_trace(batch: TraceBatch, shape: SimShape, ns_geoms: GeomParams,
                 device, warmup_frac: float, pad_steps: bool = False):
    """One trace batch on ``device``: ``(trace, lookahead tables, warm-up
    steps, n_steps)``.  ``ns_geoms`` (on ``device``) are the grid's
    distinct fold geometries; the warm-up is ``int(warmup_frac x the
    request count)`` and ``n_steps`` the request count (``pad_steps``:
    cores x padded length, whose tail steps are no-ops)."""
    n_req = _check_horizon(batch)
    if pad_steps and batch.gap.size >= 2**24:
        raise ValueError("trace too long for the int32 cycle horizon")
    trace = _device_trace(batch, device)
    ns = _ns_tables(shape, trace, ns_geoms)
    return (trace, ns, int(warmup_frac * n_req),
            batch.gap.size if pad_steps else n_req)


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
    ns_geoms, ns_idx = _hoist_geoms(
        grid, shape_grid if shape_grid is not None else grid, device)
    trace, ns, warmup, steps = _stage_trace(
        batch, shape, ns_geoms, device, grid[0].warmup_frac, pad_steps)
    return (shape, stacked, trace, ns, ns_idx, warmup,
            steps if n_steps is None else n_steps)


def _launch_batch(staged: tuple, collect_events: bool = True,
                  reduce_keys: tuple | None = None):
    """The launch half of a sweep: one ``ops.run_sweep`` over ``_stage``'s
    tuple, returning the device outputs without waiting for them — the
    stats triple, or with ``reduce_keys`` the int32 ``[G, n_deps]``
    reduction (no events).  Nothing here synchronises with the device or
    copies to the host when the params are staged on the host."""
    from repro_torch.kernels.sim_step import ops as sim_step_ops
    out = sim_step_ops.run_sweep(*staged,
                                 collect_events and reduce_keys is None)
    if reduce_keys is None:
        return out
    return _reduce_device(out[0], out[1], reduce_keys)


def _drain_batch(out, grid, lengths, reduce_keys: tuple | None = None):
    """The drain half: wait for a ``_launch_batch`` output and bring it
    to the host, as the reduced int32 ``[len(grid), n_deps]`` array or
    one finished stats dict for each of ``grid``'s points (the leading
    points of the launch)."""
    return _drain(out, grid, lambda i: lengths, reduce_keys)


def _launch_grid(shape: SimShape, stacked: MechParams, ns_idx,
                 staged_traces: Sequence[tuple], collect_events: bool = False,
                 reduce_keys: tuple | None = None) -> list:
    """The launch half of ``sweep_traces``: one grid over several trace
    batches (``_stage_trace`` tuples of one step count), one output a
    batch, as ``_launch_batch`` returns it.

    On the card each batch is one ``sim_step`` launch.  On the CPU the
    plain engine's cost is a step's op count, nearly whatever the point
    count, so the batches run as one call over batch × grid points,
    each point with its own stream (the form the synthetic path uses),
    and the outputs split per batch; every point's result is the one a
    call per batch gives."""
    if len(staged_traces) == 1 or staged_traces[0][0]["gap"].is_cuda:
        return [_launch_batch((shape, stacked, trace, ns, ns_idx, warmup,
                               n_steps), collect_events, reduce_keys)
                for trace, ns, warmup, n_steps in staged_traces]
    from repro_torch.kernels.sim_step import ops as sim_step_ops
    n_steps = {st[3] for st in staged_traces}
    if len(n_steps) != 1:
        raise ValueError("a trace group must share one step count")
    B, G = len(staged_traces), ns_idx.shape[0]
    trace = {k: torch.stack([st[0][k] for st in staged_traces])
             .repeat_interleave(G, dim=0) for k in staged_traces[0][0]}
    n_geom = staged_traces[0][1].shape[0]
    ns = torch.cat([st[1] for st in staged_traces])
    ns_bg = (torch.arange(B, dtype=_I32)[:, None] * n_geom
             + ns_idx.to(_I32)[None, :]).reshape(-1)
    warmups = torch.tensor([st[2] for st in staged_traces],
                           dtype=_I32).repeat_interleave(G)
    stacked_bg = _tree_map(
        lambda a: a.repeat((B,) + (1,) * (a.dim() - 1)), stacked)
    stats, core_end, events = sim_step_ops.run_sweep(
        shape, stacked_bg, trace, ns, ns_bg, warmups, n_steps.pop(),
        collect_events and reduce_keys is None)
    if reduce_keys is not None:
        red = _reduce_device(stats, core_end, reduce_keys)
        return [red[b * G:(b + 1) * G] for b in range(B)]
    return [({k: v[b * G:(b + 1) * G] for k, v in stats.items()},
             core_end[b * G:(b + 1) * G],
             None if events is None
             else Events(*(lane[b * G:(b + 1) * G] for lane in events)))
            for b in range(B)]


def _drain_grid(outs: list, grid, batches, reduce_keys: tuple | None = None):
    """The drain half of ``sweep_traces``: ``out[b][g]`` stats dicts, or
    the int32 ``[batch, grid, n_deps]`` reduction."""
    rows = [_drain_batch(out, grid, b.length, reduce_keys)
            for out, b in zip(outs, batches)]
    return np.stack(rows) if reduce_keys is not None else rows


def _drain(out, grid, lengths_of, reduce_keys):
    """The host view of a launch's output: the reduced ``[G, n_deps]``
    int32 array (first ``len(grid)`` rows), or one finished stats dict
    per point of ``grid`` from the ``(stats, core_end, events or None)``
    triple (``lengths_of(i)`` gives point ``i``'s request counts)."""
    n = len(grid)
    if reduce_keys is not None:
        return out[:n].cpu().numpy()
    stats, core_end, events = out
    hist = total = None
    if events is not None:
        hist, total = (x.cpu().numpy() for x in _rltl_device(
            Events(*(lane[:n] for lane in events))))
    stats_np = {k: v[:n].cpu().numpy() for k, v in stats.items()}
    core_np = core_end[:n].cpu().numpy()
    return [
        _finalize({k: v[i] for k, v in stats_np.items()}, core_np[i],
                  (None, None) if hist is None else (hist[i], total[i]),
                  lengths_of(i), cfg)
        for i, cfg in enumerate(grid)
    ]


def sweep(batch: TraceBatch, grid: Sequence[SimConfig],
          pad_steps: bool = False, rltl: bool = True,
          shape_grid: Sequence[SimConfig] | None = None,
          reduce_keys: tuple | None = None, device=None):
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
    a larger grid than the one launched.  ``reduce_keys`` (entries of
    ``REDUCE_KEYS``) returns an int32 ``[G, len(reduce_keys)]`` numpy
    array reduced on the device instead, without events.  ``device``
    defaults to CUDA.
    """
    grid = list(grid)
    staged = _stage(batch, grid, _resolve_device(device), pad_steps,
                    shape_grid)
    out = _launch_batch(staged, rltl, reduce_keys)
    return _drain_batch(out, grid, batch.length, reduce_keys)


def sweep_traces(batches: Sequence[TraceBatch], grid: Sequence[SimConfig],
                 rltl: bool = False,
                 shape_grid: Sequence[SimConfig] | None = None,
                 reduce_keys: tuple | None = None, device=None):
    """Evaluate a config grid over several same-shape trace batches.

    Each batch is one launch of the whole grid (on a CUDA device one
    ``sim_step`` kernel launch, on the CPU the plain engine), with the
    scan padded to the trace capacity (cores x padded length: the tail
    steps are no-ops) and each batch's own warm-up.  The params are
    staged once, on the host, for every batch.  Returns ``out[b][g]``,
    the stats of batch ``b`` under config ``g``, bitwise equal to
    ``repro.core.sweep_traces`` (the RLTL histogram only with ``rltl``);
    with ``reduce_keys`` the int32 ``[batch, grid, n_deps]`` reduction.
    ``device`` defaults to CUDA.
    """
    batches = list(batches)
    grid = list(grid)
    if not batches or not grid:
        raise ValueError("empty sweep")
    if any(b.gap.shape != batches[0].gap.shape for b in batches):
        raise ValueError("sweep_traces requires same-shape trace batches")
    device = _resolve_device(device)
    host = torch.device("cpu")
    shape, stacked = _grid_shape_and_params(grid, shape_grid, host)
    ns_geoms, ns_idx = _hoist_geoms(
        grid, shape_grid if shape_grid is not None else grid, host)
    ns_geoms = _tree_map(lambda x: x.to(device), ns_geoms)
    staged = [_stage_trace(b, shape, ns_geoms, device, grid[0].warmup_frac,
                           pad_steps=True) for b in batches]
    outs = _launch_grid(shape, stacked, ns_idx, staged, rltl, reduce_keys)
    return _drain_grid(outs, grid, batches, reduce_keys)


def simulate(batch: TraceBatch, cfg: SimConfig = SimConfig(),
             device=None) -> dict:
    """Run one configuration on a trace batch; returns its stats dict
    (a one-point ``sweep``)."""
    return sweep(batch, [cfg], device=device)[0]


# --------------------------------------------------------------------------
# On-device workload synthesis: every point generates its own stream
# --------------------------------------------------------------------------

def _run_synth_impl(shape: SimShape, params: MechParams, wparams, ilparams,
                    warmups, n_cores: int, max_len: int, n_steps: int,
                    collect_events: bool = True, stream: bool = False):
    """The plain synthetic engine over ``[G]`` points: generate every
    point's stream (``workloads.generate``), recompute its queue-hit
    lookahead over the folded stream, and run the scan with one stream
    per point.  Returns ``(stats, core_end, events or None)``, plus the
    streams (``gap``/``bank``/``row``/``is_write``/``dep``/``next_same``
    ``[G, C, L]``, ``length [G, C]``) when ``stream`` is set."""
    from repro_torch.workloads.generator import generate
    trace = generate(n_cores, max_len, wparams, params.geom, ilparams)
    geom = GeomParams(*(x[:, None, None] for x in params.geom))
    fb, fr = fold_address(geom, trace["bank"], trace["row"])
    ns = _next_same_folded(shape.envelope.max_banks_total, fb, fr,
                           trace["length"])
    ns_idx = torch.arange(ns.shape[0], dtype=_I32, device=ns.device)
    out = _run_impl(shape, params, trace, ns, ns_idx, warmups, n_steps,
                    collect_events)
    if stream:
        return out + ({**trace, "next_same": ns},)
    return out


@functools.lru_cache(maxsize=256)
def _wparams(names: tuple, n_req: int, phases: tuple, n_segs: int):
    """One spec's ``WorkloadParams``, cached by what determines every leaf
    but the seed (staged as 0; the caller writes the seed column)."""
    from repro_torch.workloads.profiles import spec_params
    return spec_params(WorkloadSpec(names=names, n_req=n_req, seed=0,
                                    phases=phases), n_segs=n_segs)


def _check_synth_horizon(spec: WorkloadSpec) -> None:
    """A-priori int32 overflow guard: each core's expected arrival clock
    (``length x mean_gap``, maximised over the phase schedule, times 4
    for the geometric gap tail) must stay below ``INF``."""
    lengths = spec.lengths()
    for c, n in enumerate(spec.names):
        gaps = [WORKLOAD_BY_NAME[n].mean_gap] + [
            WORKLOAD_BY_NAME[nm[c]].mean_gap for _, nm in spec.phases]
        worst = 4.0 * float(lengths[c]) * max(max(gaps), 1.0)
        if worst >= float(INF):
            raise ValueError(
                f"core {c} ({n!r}, n_req={spec.n_req}) risks int32 cycle "
                f"overflow (~{worst:.3g} expected arrival cycles vs the "
                f"{INF} horizon); split the stream into shorter chunks")


def _stage_synth(grid: Sequence[SimConfig],
                 shape_grid: Sequence[SimConfig] | None, device) -> tuple:
    """Everything one synthetic launch reads, on ``device``: ``(shape,
    stacked params, workload params, interleave params, warm-ups [G],
    n_cores, max_len, n_steps)`` — the leading arguments of
    ``ops.run_synth``.  Each point's warm-up is ``int(warmup_frac x
    its request count)``, as the materialized path computes it."""
    from repro_torch.workloads.profiles import max_len_of, n_segs_of
    grid = list(grid)
    if not grid:
        raise ValueError("empty synthetic sweep grid")
    shape_l = list(shape_grid) if shape_grid is not None else grid
    for cfg in grid + shape_l:
        if cfg.workload is None or not cfg.workload.names:
            raise ValueError("sweep_synth needs cfg.workload set on every "
                             "grid point")
    n_cores = grid[0].workload.n_cores
    if any(cfg.workload.n_cores != n_cores for cfg in grid + shape_l):
        raise ValueError("synthetic grids must share the core count")
    shape, stacked = _grid_shape_and_params(grid, shape_grid, device)
    specs = [cfg.workload for cfg in grid + shape_l]
    max_len = max_len_of(specs)
    n_steps = n_cores * max_len
    if n_steps >= 2**24:
        raise ValueError("workload too long for the int32 cycle horizon")
    n_segs = n_segs_of(specs)
    for cfg in grid:
        _check_synth_horizon(cfg.workload)
    stack = lambda trees: _tree_map(lambda *xs: torch.stack(xs).to(device),
                                    *trees)
    wstack = stack([_wparams(cfg.workload.names, cfg.workload.n_req,
                             cfg.workload.phases, n_segs) for cfg in grid])
    seeds = torch.tensor([cfg.workload.seed for cfg in grid], dtype=_I32,
                         device=device)
    wstack = wstack._replace(
        seed=seeds[:, None].expand_as(wstack.seed).contiguous())
    ilstack = stack([dram_lib.interleave_params(cfg.interleave)
                     for cfg in grid])
    warmups = torch.tensor(
        [int(cfg.warmup_frac * int(cfg.workload.lengths().sum()))
         for cfg in grid], dtype=_I32, device=device)
    return (shape, stacked, wstack, ilstack, warmups, n_cores, max_len,
            n_steps)


def _launch_synth(staged: tuple, collect_events: bool = True,
                  reduce_keys: tuple | None = None, device=None):
    """The launch half of a synthetic sweep: one ``ops.run_synth`` over
    ``_stage_synth``'s tuple on ``device`` (default: where it was
    staged), returning the device outputs without waiting for them, or
    with ``reduce_keys`` the int32 ``[G, n_deps]`` reduction."""
    from repro_torch.kernels.sim_step import ops as sim_step_ops
    out = sim_step_ops.run_synth(*staged,
                                 collect_events and reduce_keys is None,
                                 device=device)
    if reduce_keys is None:
        return out
    return _reduce_device(out[0], out[1], reduce_keys)


def _drain_synth(out, grid, reduce_keys: tuple | None = None):
    """The drain half of a synthetic sweep (``_drain`` with each point's
    own request counts)."""
    return _drain(out, grid, lambda i: grid[i].workload.lengths(),
                  reduce_keys)


def sweep_synth(grid: Sequence[SimConfig], rltl: bool = True,
                shape_grid: Sequence[SimConfig] | None = None,
                reduce_keys: tuple | None = None, device=None):
    """Evaluate a synthetic grid (``cfg.workload`` set on every point):
    each point generates its own stream for its geometry and interleave
    policy and scans it, all in one launch — on a CUDA device one launch
    of the ``sim_step`` kernel's synthesis entry, on the CPU the plain
    engine.  Returns one stats dict per point (or, with ``reduce_keys``,
    an int32 ``[G, n_deps]`` array), bitwise equal to simulating the
    materialized stream (``workloads.materialize``) with ``sweep``.

    The specs must share the core count; per-core arrays pad to the
    longest spec over ``shape_grid`` (padded steps are no-ops).
    ``device`` defaults to CUDA.
    """
    grid = list(grid)
    staged = _stage_synth(grid, shape_grid, _resolve_device(device))
    return _drain_synth(_launch_synth(staged, rltl, reduce_keys), grid,
                        reduce_keys)


def simulate_synth(cfg: SimConfig, device=None) -> dict:
    """One synthetic point, streamed end to end (a one-point
    ``sweep_synth`` with the RLTL post-pass); bitwise ``simulate(
    materialize(cfg.workload, cfg.dram, cfg.interleave), cfg)``."""
    if cfg.workload is None:
        raise ValueError("simulate_synth needs cfg.workload")
    return sweep_synth([cfg], rltl=True, device=device)[0]


# --------------------------------------------------------------------------
# The serving closed loop (engine in repro_torch.serving.loop)
# --------------------------------------------------------------------------

def sweep_serving(grid: Sequence[SimConfig],
                  shape_grid: Sequence[SimConfig] | None = None,
                  counts=None, collect_steps: bool = False,
                  reduce_keys: tuple | None = None, device=None):
    """Evaluate a serving grid (``cfg.serving`` set on every point): one
    continuous-batching closed loop per point, all in one launch — on a
    CUDA device one launch of the ``sim_step`` kernel's serving entry, on
    the CPU the plain engine.  ``counts`` pins the per-step arrivals;
    with ``reduce_keys`` (``engine.SERVE_REDUCE_KEYS``) the result is an
    int32 ``[G, n_keys]`` array.  ``device`` defaults to CUDA.  The
    engine lives in ``repro_torch.serving.loop.engine``, imported here
    lazily (it imports this module)."""
    from repro_torch.serving.loop import engine
    return engine.run_sweep(grid, shape_grid=shape_grid, counts=counts,
                            collect_steps=collect_steps,
                            reduce_keys=reduce_keys, device=device)


def simulate_serving(cfg: SimConfig, counts=None,
                     collect_steps: bool = True, device=None) -> dict:
    """One serving point end to end (a one-point ``sweep_serving`` with
    the per-step occupancy / queue arrays)."""
    from repro_torch.serving.loop import engine
    return engine.simulate_serving(cfg, counts=counts,
                                   collect_steps=collect_steps,
                                   device=device)


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
