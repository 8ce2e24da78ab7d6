"""HCRAC — the Highly-Charged Row Address Cache (thesis §4.2).

Port of ``repro.core.hcrac``, batched over a leading ``[G]`` axis of
sweep points.  A tag-only, set-associative cache of global row ids:
``insert`` on every PRE, ``lookup`` on every ACT (a hit means the row is
still highly charged), and the IIC/EC invalidation sweep emulated
exactly with timestamps: physical slot ``s = set * ways + way`` is swept
at cycles ``t ≡ (s+1) * C/k (mod C)``, so an entry inserted at ``t_i``
is alive at ``t`` iff

    floor((t - phase_s) / C) == floor((t_i - phase_s) / C)

(``exact_expiry=True`` is the idealised per-entry timer ``t - t_i <= C``).

``HCRACConfig`` is the static part (array shape, expiry flavour);
``HCRACParams`` holds the per-point active set count, caching duration
and sweep period as ``[G]`` int32 tensors.  A capacity-``k`` table lives
in the first ``k / n_ways`` sets of the padded state.

``insert`` and ``lookup`` update the state tensors in place (the eager
engine would otherwise copy the whole ``[G, sets, ways]`` table per
request) and return it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.dram import floordiv

NO_TAG = -1
_I32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class HCRACConfig:
    n_entries: int = 128          # total entries (thesis default, per core)
    n_ways: int = 2               # 2-way set associative, LRU (Table 5.1)
    caching_cycles: int = 800_000  # 1 ms at the 800 MHz bus clock
    exact_expiry: bool = False    # idealised timer instead of IIC/EC sweep

    @property
    def n_sets(self) -> int:
        if self.n_entries % self.n_ways:
            raise ValueError("n_entries must be a multiple of n_ways")
        return self.n_entries // self.n_ways

    @property
    def sweep_period(self) -> int:
        """IIC period: C / k cycles between successive slot invalidations."""
        return max(1, self.caching_cycles // self.n_entries)


class HCRACState(NamedTuple):
    tags: torch.Tensor    # [G, sets, ways] int32 global row id (NO_TAG = empty)
    itime: torch.Tensor   # [G, sets, ways] int32 insertion cycle
    lru: torch.Tensor     # [G, sets, ways] int32 last-touch cycle (LRU policy)


class HCRACParams(NamedTuple):
    """Per-point HCRAC values (0-d per configuration, ``[G]`` stacked).
    ``n_sets`` is the *active* set count, at most the padded shape's."""
    n_sets: torch.Tensor          # int32 active sets (capacity / n_ways)
    caching_cycles: torch.Tensor  # int32 caching duration C
    sweep_period: torch.Tensor    # int32 C / n_entries (IIC step)


def params_of(cfg: HCRACConfig) -> HCRACParams:
    """The tensor view of a concrete config (0-d leaves)."""
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    return HCRACParams(n_sets=i32(cfg.n_sets),
                       caching_cycles=i32(cfg.caching_cycles),
                       sweep_period=i32(cfg.sweep_period))


def init(cfg: HCRACConfig, n_points: int, device=None) -> HCRACState:
    shape = (n_points, cfg.n_sets, cfg.n_ways)
    full = lambda v: torch.full(shape, v, dtype=torch.int32, device=device)
    return HCRACState(tags=full(NO_TAG), itime=full(0), lru=full(-1))


def state_from_numpy(tags, itime, lru, device=None) -> HCRACState:
    """An ``HCRACState`` of int32 tensors on ``device`` from array-likes
    of any leading shape (``[sets, ways]`` for one table, ``[G, sets,
    ways]`` for a grid): how a table built elsewhere (``repro``'s
    ``HCRACState``, via ``np.asarray``) enters the port."""
    t = lambda x: torch.as_tensor(np.array(x, np.int32), device=device)
    return HCRACState(tags=t(tags), itime=t(itime), lru=t(lru))


def _alive(cfg: HCRACConfig, set_idx, itime, t, params: HCRACParams):
    """``[G, ways]`` bool: entries inserted at ``itime [G, ways]`` in set
    ``set_idx [G]`` are still valid at cycle ``t [G]``."""
    t = t[:, None]
    c = params.caching_cycles[:, None]
    if cfg.exact_expiry:
        return (t - itime) <= c
    ways = torch.arange(cfg.n_ways, dtype=torch.int32, device=itime.device)
    phase = (set_idx[:, None] * cfg.n_ways + ways + 1) \
        * params.sweep_period[:, None]
    # same sweep window <=> no invalidation of this slot in (itime, t]
    return floordiv(t - phase, c) == floordiv(itime - phase, c)


def _probe(cfg, st, gid, t, params):
    g = torch.arange(gid.shape[0], device=gid.device)
    set_idx = torch.remainder(gid, params.n_sets)
    row_tags = st.tags[g, set_idx]
    row_itime = st.itime[g, set_idx]
    valid = (row_tags != NO_TAG) & _alive(cfg, set_idx, row_itime, t, params)
    match = valid & (row_tags == gid[:, None])
    return g, set_idx, valid, match


def _enable(enable, like):
    return torch.as_tensor(enable, dtype=torch.bool,
                           device=like.device).expand(like.shape)


def lookup(cfg: HCRACConfig, st: HCRACState, gid, t, enable, params):
    """Look up global row ids ``gid [G]`` at cycles ``t [G]``.

    Returns ``(hit [G], st)``.  A hit refreshes only the matching ways'
    LRU stamps (gated by ``enable``); the insertion time is not re-armed.
    The returned ``hit`` is ungated.
    """
    g, set_idx, _, match = _probe(cfg, st, gid, t, params)
    en = _enable(enable, gid)
    st.lru[g, set_idx] = torch.where(match & en[:, None], t[:, None],
                                     st.lru[g, set_idx])
    return match.any(dim=1), st


def insert(cfg: HCRACConfig, st: HCRACState, gid, t, enable, params):
    """Insert global row ids ``gid [G]`` at cycles ``t [G]`` (on PRE).

    Victim: the first already-matching way, else the first invalid or
    expired way, else the least recently used valid way (first on ties).
    ``enable [G]`` masks the update per point.
    """
    g, set_idx, valid, match = _probe(cfg, st, gid, t, params)
    row_lru = st.lru[g, set_idx]
    inv_way = torch.argmin(valid.to(torch.int32), dim=1)  # first invalid
    lru_way = torch.argmin(
        torch.where(valid, row_lru, torch.full_like(row_lru, _I32_MAX)), dim=1)
    way = torch.where(match.any(dim=1),
                      torch.argmax(match.to(torch.int32), dim=1),
                      torch.where((~valid).any(dim=1), inv_way, lru_way))
    en = _enable(enable, gid)
    for arr, val in ((st.tags, gid), (st.itime, t), (st.lru, t)):
        arr[g, set_idx, way] = torch.where(en, val, arr[g, set_idx, way])
    return st


def occupancy(cfg: HCRACConfig, st: HCRACState, t,
              params: HCRACParams | None = None):
    """Fraction of entries alive at cycle ``t`` (a diagnostic), float32
    ``[G]`` over a ``[G]``-batched state of ``cfg``'s shape; ``t`` is a
    scalar or ``[G]``.  ``params`` defaults to ``cfg``'s own values."""
    G, S = st.tags.shape[:2]
    dev = st.tags.device
    if params is None:
        params = HCRACParams(*(torch.full((G,), int(v), dtype=torch.int32,
                                          device=dev)
                               for v in params_of(cfg)))
    t = torch.as_tensor(t, dtype=torch.int32, device=dev).expand(G)
    rep = lambda x: x.repeat_interleave(S)
    sets = torch.arange(S, dtype=torch.int32, device=dev).repeat(G)
    alive = _alive(cfg, sets, st.itime.reshape(G * S, -1), rep(t),
                   HCRACParams(*(rep(x) for x in params)))
    valid = (st.tags != NO_TAG) & alive.reshape(st.tags.shape)
    return valid.to(torch.float32).mean(dim=(1, 2))


def _ceil_log2(n: int) -> int:
    return (int(n) - 1).bit_length()


def storage_bits(cfg: HCRACConfig, n_ranks: int = 1, n_banks: int = 8,
                 n_rows: int = 65536) -> int:
    """Thesis Eq. 6.1/6.2: the storage cost (bits) of one HCRAC — each
    entry holds the rank (past one), bank and row address, a valid bit
    and its LRU state."""
    entry = _ceil_log2(n_ranks) if n_ranks > 1 else 0
    entry += _ceil_log2(n_banks) + _ceil_log2(n_rows) + 1
    lru_bits = 1 if cfg.n_ways == 2 else max(1, cfg.n_ways.bit_length())
    return cfg.n_entries * (entry + lru_bits)


def padded_shape(cfg: HCRACConfig, n_sets_max: int) -> HCRACConfig:
    """The static shape carrier for a capacity sweep: same ways / expiry,
    arrays sized for ``n_sets_max`` sets; the per-point fields are zeroed
    so configs differing only in capacity / duration share one shape."""
    if n_sets_max < cfg.n_sets:
        raise ValueError("padded HCRAC smaller than the config's")
    return dataclasses.replace(cfg, n_entries=n_sets_max * cfg.n_ways,
                               caching_cycles=0)
