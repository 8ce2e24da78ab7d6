"""Host oracle of the controller tiers (port of
``repro.controller.oracle``): the window engine's admit-then-serve
protocol written out in plain Python integers over an explicit request
window, every cycle stamp computed exactly.  ``run_host`` equals
``simulate()`` on both tiers (``controller="inorder"`` rides the same
protocol with a window cap of 1), every scalar counter,
``total_cycles`` and the per-core end times.

Two choices, as in ``repro``: the mechanism timings come from the
port's registry (``mechanisms.select_timings`` and ``hcrac_gate`` on a
one-point grid), so the oracle checks the scheduling, bank, bus and
refresh arithmetic rather than a second copy of every mechanism's table;
the HCRAC is written out again in numpy (``_HostHCRAC``), since its
expiry and LRU are state the controller sees.  The oracle steps from
decision to decision, not cycle by cycle: every stamp is a closed-form
maximum over ready clocks, so the cycles between decisions are idle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.controller.engine import FAW_DEPTH, HIT_PENALTY, NEG
from repro_torch.core import mechanisms as registry
from repro_torch.core import simulator as sim_mod
from repro_torch.core.simulator import INF, SimConfig
from repro_torch.core.timing import ms_to_cycles

NO_ROW = -1
NO_TAG = -1


class _HostHCRAC:
    """Numpy transliteration of ``repro.core.hcrac`` (tags/itime/lru,
    IIC/EC sweep expiry, match > first-invalid > LRU victim)."""

    def __init__(self, cfg):
        self.n_sets = int(cfg.n_sets)
        self.n_ways = int(cfg.n_ways)
        self.caching_cycles = int(cfg.caching_cycles)
        self.sweep_period = int(cfg.sweep_period)
        self.exact_expiry = bool(cfg.exact_expiry)
        shape = (self.n_sets, self.n_ways)
        self.tags = np.full(shape, NO_TAG, np.int64)
        self.itime = np.zeros(shape, np.int64)
        self.lru = np.full(shape, -1, np.int64)

    def _valid(self, s, t):
        row_tags = self.tags[s]
        row_itime = self.itime[s]
        if self.exact_expiry:
            alive = (t - row_itime) <= self.caching_cycles
        else:
            ways = np.arange(self.n_ways, dtype=np.int64)
            phase = (s * self.n_ways + ways + 1) * self.sweep_period
            c = self.caching_cycles
            # same sweep window <=> no invalidation in (itime, t]
            # (python // floors, as the engine's floor division)
            alive = (t - phase) // c == (row_itime - phase) // c
        return (row_tags != NO_TAG) & alive

    def lookup(self, gid, t):
        """Returns the (unmasked) hit; refreshes matching entries' LRU —
        the engine's lookup touches LRU whenever tags match, even when
        the caller later discards the hit (row hit / gate off)."""
        s = gid % self.n_sets
        match = self._valid(s, t) & (self.tags[s] == gid)
        self.lru[s] = np.where(match, t, self.lru[s])
        return bool(match.any())

    def insert(self, gid, t, enable=True):
        if not enable:
            return
        s = gid % self.n_sets
        valid = self._valid(s, t)
        match = valid & (self.tags[s] == gid)
        if match.any():
            way = int(np.argmax(match))
        elif (~valid).any():
            way = int(np.argmin(valid))
        else:
            way = int(np.argmin(np.where(valid, self.lru[s],
                                         np.iinfo(np.int32).max)))
        self.tags[s, way] = gid
        self.itime[s, way] = t
        self.lru[s, way] = t


class _Entry(NamedTuple):
    """One window slot (folded address, admission metadata)."""
    core: int
    idx: int    # per-core program-order index
    bank: int   # folded
    row: int    # folded
    write: bool
    ns: bool    # queue-hit lookahead over the folded stream
    arr: int    # issue (arrival-at-controller) cycle
    seq: int    # global admission sequence


def _next_same_host(fb, fr, length):
    """Per-core queue-hit lookahead over *folded* addresses — the host
    twin of ``simulator._next_same_folded``."""
    C, L = fb.shape
    out = np.zeros((C, L), bool)
    for c in range(C):
        last: dict[int, int] = {}
        for i in range(int(length[c]) - 1, -1, -1):
            b = int(fb[c, i])
            j = last.get(b)
            out[c, i] = j is not None and fr[c, j] == fr[c, i]
            last[b] = i
    return out


def run_host(batch, cfg: SimConfig = SimConfig()) -> dict:
    """Run the host oracle; returns ``{**STAT_KEYS, total_cycles,
    core_end}`` with exact-int values matching ``simulate(batch, cfg)``.

    Handles both tiers: ``cfg.controller == "inorder"`` runs the same
    decision loop with a window cap of 1 (the window engine's in-order
    parity mode), ``"frfcfs"`` with ``cfg.window`` and the rank
    tRRD/tFAW floors enabled.
    """
    T = cfg.timing
    D = cfg.dram
    frfcfs = cfg.controller == "frfcfs"
    cap = int(cfg.window) if frfcfs else 1
    stateful = cfg.refresh_mode == "stateful"
    closed = cfg.policy == "closed"
    groups = int(T.n_refresh_groups)
    retention = int(T.retention_cycles)
    nb = int(D.banks_total)
    n_rows = int(D.n_rows)
    bpc = int(D.banks_per_channel)
    nch = int(D.n_channels)
    ms8 = int(ms_to_cycles(8.0))

    # mechanism timings: the engine's own param blocks of a one-point
    # grid, folded by the registry per request
    _, p = sim_mod._grid_shape_and_params([cfg])
    hc_gate = bool(registry.hcrac_gate(p.mech))
    th_enable = bool(p.thermal.enable[0])
    seg_edge = p.thermal.seg_edge[0].numpy()
    seg_leak = p.thermal.seg_leak[0].numpy()
    S = int(seg_edge.shape[-1])
    one = lambda v: torch.tensor([int(v)], dtype=torch.int32)

    gap = np.asarray(batch.gap, np.int64)
    dep = np.asarray(batch.dep, bool)
    wr = np.asarray(batch.is_write, bool)
    length = np.asarray(batch.length, np.int64)
    C, L = gap.shape
    mshr = cfg.mshr
    fb = np.mod(np.asarray(batch.bank, np.int64), nb)
    fr = np.mod(np.asarray(batch.row, np.int64), n_rows)
    ns = _next_same_host(fb, fr, length)
    n_req = int(length.sum())
    warmup = int(cfg.warmup_frac * n_req)

    # --- controller / bank / bus state (plain python ints) ---------------
    ptrs = [0] * C
    last_issue = [0] * C
    mshr_ring = [[0] * mshr for _ in range(C)]
    ring_served = [[True] * mshr for _ in range(C)]
    yg_served = [True] * C
    yg_done = [0] * C
    core_end = [0] * C
    open_row = [NO_ROW] * nb
    ready_act = [0] * nb
    ready_rdwr = [0] * nb
    ready_pre = [0] * nb
    last_pre_gid = [-1] * nb
    last_pre_t = [0] * nb
    ref_k = [0] * nb
    last_ref_t = [0] * nb
    cmd_free = [0] * nch
    data_free = [0] * nch
    hc = _HostHCRAC(cfg.mech.hcrac)
    n_ranks_g = nb // int(D.n_banks)
    rank_last_act = [int(NEG)] * n_ranks_g
    faw_ring = [[int(NEG)] * FAW_DEPTH for _ in range(n_ranks_g)]
    faw_ptr = [0] * n_ranks_g
    window: list[_Entry] = []
    now = 0
    seq = 0
    stats = {k: 0 for k in sim_mod.STAT_KEYS}

    def radj(t, row):
        """Legacy closed-form refresh blackout (dram.refresh_adjust)."""
        r = t % T.tREFI
        if r < T.tRFC and (row % groups) == ((t // T.tREFI) % groups):
            return t + (T.tRFC - r)
        return t

    def clamp_span(t, span, row):
        """Legacy burst clamp (dram.refresh_clamp_span)."""
        r = t % T.tREFI
        base = t - r
        k = t // T.tREFI
        g = row % groups
        in_this = r < T.tRFC and g == (k % groups)
        into_next = (r + span > T.tREFI) and g == ((k + 1) % groups)
        if in_this:
            return base + T.tRFC
        if into_next:
            return base + T.tREFI + T.tRFC
        return t

    def try_admit():
        nonlocal now, seq
        issues = []
        for c in range(C):
            ptr = ptrs[c]
            pos = ptr % mshr
            if ptr >= length[c] or not ring_served[c][pos] \
                    or (dep[c, ptr] and not yg_served[c]):
                issues.append(int(INF))
                continue
            t = max(last_issue[c] + int(gap[c, ptr]), mshr_ring[c][pos],
                    yg_done[c] if dep[c, ptr] else 0)
            issues.append(t)
        c = min(range(C), key=lambda i: issues[i])  # first min (argmin)
        t_iss = issues[c]
        occ = len(window)
        if not (occ < cap and t_iss < int(INF)
                and (t_iss <= now or occ == 0)):
            return False
        if occ == 0:
            now = max(now, t_iss)
        ptr = ptrs[c]
        window.append(_Entry(core=c, idx=ptr, bank=int(fb[c, ptr]),
                             row=int(fr[c, ptr]), write=bool(wr[c, ptr]),
                             ns=bool(ns[c, ptr]), arr=t_iss, seq=seq))
        ptrs[c] = ptr + 1
        last_issue[c] = t_iss
        yg_served[c] = False
        ring_served[c][ptr % mshr] = False
        seq += 1
        return True

    def service(ent: _Entry, measure: bool, floor: int):
        """One request through the bank/bus/refresh/mechanism pipeline —
        the host twin of ``simulator._service``."""
        b, row = ent.bank, ent.row
        ch = b // bpc
        t0 = max(ent.arr, cmd_free[ch])

        # stateful-refresh catch-up (legacy tier uses radj/clamp_span)
        ref_due = t0 // T.tREFI + 1
        n_pend = max(ref_due - ref_k[b], 0)
        do_ref = stateful and n_pend > 0
        busy0 = max(ready_act[b], ready_pre[b], ready_rdwr[b])
        ref_t = max((ref_due - 1) * T.tREFI, ready_pre[b])
        ref_done = ref_t + T.tRFC
        openr0 = open_row[b]
        ref_pre = do_ref and openr0 != NO_ROW
        openr = NO_ROW if do_ref else openr0
        r_act_b = max(ready_act[b], ref_done) if do_ref else ready_act[b]
        r_pre_b = max(ready_pre[b], ref_done) if do_ref else ready_pre[b]
        r_rdwr_b = max(ready_rdwr[b], ref_done) if do_ref \
            else ready_rdwr[b]
        gid_ref = b * n_rows + (openr0 if ref_pre else 0)
        hc.insert(gid_ref, ref_t, enable=ref_pre and hc_gate)
        adj = (lambda tt: tt) if stateful else (lambda tt: radj(tt, row))

        is_hit = openr == row
        is_closed = openr == NO_ROW
        is_conflict = not is_hit and not is_closed

        t_pre = adj(max(t0, r_pre_b))
        gid_old = b * n_rows + (openr if is_conflict else 0)
        hc.insert(gid_old, t_pre, enable=is_conflict and hc_gate)

        t_act = adj(t_pre + T.tRP) if is_conflict else adj(max(t0, r_act_b))
        needs_act = not is_hit
        if needs_act:
            t_act = max(t_act, floor)

        gid = b * n_rows + row
        cc_hit = hc.lookup(gid, t_act) and needs_act and hc_gate

        tslp = t_act - last_pre_t[b] if last_pre_gid[b] == gid \
            else int(INF)
        tsr_closed = (t_act - (row % groups) * T.tREFI) % retention
        kw = ref_due - 1
        j_g = kw - ((kw - (row % groups)) % groups)
        new_last_ref_t = ref_t if do_ref else last_ref_t[b]
        t_ref = new_last_ref_t if j_g == kw else j_g * T.tREFI
        tsr = max(t_act - t_ref, 0) if (stateful and j_g >= 0) \
            else tsr_closed
        if S > 0:
            seg = min(max(int(np.sum(t_act >= seg_edge)) - 1, 0), S - 1)
            if th_enable:
                tsr_eff = int(np.round(np.float32(tsr) * seg_leak[seg]))
            else:
                tsr_eff = tsr
        else:
            seg = 0
            tsr_eff = tsr

        ctx = registry.SelectCtx(
            timing=p.timing, geom=p.geom,
            hcrac_hit=torch.tensor([cc_hit]), tsr=one(tsr_eff),
            tslp=one(tslp), needs_act=torch.tensor([needs_act]),
            bank=one(b), seg=one(seg))
        rcd, ras = registry.select_timings(p.mech, ctx)
        rcd, ras = int(rcd), int(ras)
        lowered_used = needs_act and (rcd < T.tRCD or ras < T.tRAS)

        t_rdwr = max(t0, r_rdwr_b) if is_hit else t_act + rcd
        cas = T.tCWL if ent.write else T.tCL
        t_rdwr = max(t_rdwr, data_free[ch] - cas)
        if not stateful:
            t_rdwr = clamp_span(t_rdwr, cas + T.tBL, row)
        done = t_rdwr + cas + T.tBL

        new_ready_rdwr = t_act + rcd if needs_act else r_rdwr_b
        after_rw = done + T.tWR if ent.write else t_rdwr + T.tRTP
        new_ready_pre = max(t_act + ras if needs_act else r_pre_b,
                            after_rw)
        auto_pre = closed and not ent.ns
        t_autopre = new_ready_pre
        hc.insert(gid, t_autopre, enable=auto_pre and hc_gate)

        open_row[b] = NO_ROW if auto_pre else row
        ready_act[b] = t_autopre + T.tRP if auto_pre else \
            (t_pre + T.tRP if is_conflict else r_act_b)
        ready_rdwr[b] = new_ready_rdwr
        ready_pre[b] = new_ready_pre
        n_cmds = 1 + int(needs_act) + int(is_conflict) + int(auto_pre)
        cmd_free[ch] = max(cmd_free[ch], ent.arr) + n_cmds
        data_free[ch] = done
        lp_gid0 = gid_ref if ref_pre else last_pre_gid[b]
        lp_t0 = ref_t if ref_pre else last_pre_t[b]
        last_pre_gid[b] = gid if auto_pre else \
            (gid_old if is_conflict else lp_gid0)
        last_pre_t[b] = t_autopre if auto_pre else \
            (t_pre if is_conflict else lp_t0)
        if do_ref:
            ref_k[b] = ref_due
        last_ref_t[b] = new_last_ref_t

        m = int(measure)
        stats["n_req"] += m
        stats["lat_sum"] += m * (done - ent.arr)
        stats["acts"] += m * int(needs_act)
        stats["acts_lowered"] += m * int(lowered_used)
        stats["hcrac_lookups"] += m * int(needs_act and hc_gate)
        stats["hcrac_hits"] += m * int(cc_hit)
        stats["row_hits"] += m * int(is_hit)
        stats["row_closed"] += m * int(is_closed)
        stats["row_conflicts"] += m * int(is_conflict)
        stats["reads"] += m * int(not ent.write)
        stats["writes"] += m * int(ent.write)
        stats["pres"] += m * (int(is_conflict) + int(auto_pre))
        stats["act_ras_sum"] += m * int(needs_act) * ras
        stats["refresh8ms_acts"] += int(needs_act and measure
                                        and tsr < ms8)
        stats["refs_issued"] += m * int(stateful) * n_pend
        if do_ref and measure:
            stats["ref_blocked_cycles"] += max(ref_done - max(t0, busy0),
                                               0)
        return done, t_act, needs_act

    serviced = 0
    while serviced < n_req:
        # admission: refill up to the cap (a failed attempt leaves the
        # state unchanged, so breaking early == the engine's masked
        # no-op fori_loop iterations)
        for _ in range(cap):
            if not try_admit():
                break
        if not window:
            raise RuntimeError("window engine deadlock (oracle)")

        # FR-FCFS selection: hit-first, oldest admission first
        def key(ent):
            hit = open_row[ent.bank] == ent.row
            return (0 if hit else int(HIT_PENALTY)) + ent.seq
        ent = min(window, key=key)

        rank = ent.bank // int(D.n_banks)
        floor = 0
        if frfcfs:
            floor = max(rank_last_act[rank] + T.tRRD,
                        faw_ring[rank][faw_ptr[rank]] + T.tFAW)

        done, t_act, needs_act = service(ent, serviced >= warmup, floor)

        if needs_act and frfcfs:
            rank_last_act[rank] = max(rank_last_act[rank], t_act)
            faw_ring[rank][faw_ptr[rank]] = t_act
            faw_ptr[rank] = (faw_ptr[rank] + 1) % FAW_DEPTH

        cc = ent.core
        pos = ent.idx % mshr
        mshr_ring[cc][pos] = done
        ring_served[cc][pos] = True
        core_end[cc] = max(core_end[cc], done)
        if ent.idx == ptrs[cc] - 1:  # youngest admitted request
            yg_served[cc] = True
            yg_done[cc] = done
        window.remove(ent)
        now = max(now, cmd_free[ent.bank // bpc])
        serviced += 1

    if stateful:
        # trailing-REF retire (simulator._retire_trailing_refs)
        stats["refs_issued"] = (max(core_end) // T.tREFI + 1) * nb
    out = dict(stats)
    out["core_end"] = np.asarray(core_end, np.int64)
    out["total_cycles"] = max(core_end)
    return out
