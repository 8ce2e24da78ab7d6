"""Host-side parity oracle for the batched serving loop (port of
``repro.serving.loop.oracle``).

Drives the host ``repro_torch.serving.scheduler.Scheduler`` over a
pinned per-step arrival schedule, in the batched loop's step order
(arrivals → admission → occupancy snapshot → decode/retire), with the
scheduler keyed by the same hashed page ids the loop's hot table uses —
so per-step occupancy, retirement and the hot-probe stats are exactly
comparable.  The scheduler's hot-page probes run on ``device`` (the
probe kernel on the card, CUDA unless the caller names another).

Parity preconditions (what the caller's spec must satisfy):

* ``hot_exact=True`` — slot-phase independent aliveness (the IIC/EC
  sweep ties an entry's lifetime to its physical slot, which insertion
  order can permute between the two implementations);
* pinned counts small enough that the loop's clamps (``queue_cap``,
  ``arrivals_max``) never bind — the host queue is unbounded;
* ``page_tokens`` equal to the host ``Request.n_pages`` granule (2048).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.hot_pages import HotPageConfig
from repro_torch.serving.loop.engine import page_gid
from repro_torch.serving.loop.spec import ServingSpec
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig
from repro_torch.workloads.arrivals import arrival_params, request_attrs

__all__ = ["HashedScheduler", "scheduler_config", "run_host",
           "run_host_grid"]


class HashedScheduler(Scheduler):
    """Host scheduler keyed like the batched loop's hot table: page ids
    come from the same ``page_gid`` hash, so both sides index the same
    HCRAC sets with the same tags."""

    def _page_ids(self, req: Request) -> np.ndarray:
        ks = torch.arange(req.n_pages, dtype=torch.int32)
        return page_gid(torch.tensor(req.rid, dtype=torch.int32),
                        ks).numpy().astype(np.int64)


def scheduler_config(spec: ServingSpec) -> SchedulerConfig:
    """The host config equivalent to ``spec`` (the policy folded to the
    host's charge-aware switch; ``preempting`` has no host analogue and
    maps to charge-aware scoring without preemption)."""
    return SchedulerConfig(
        max_batch=spec.max_batch,
        charge_aware=(spec.policy != "fifo"),
        hot=HotPageConfig(n_entries=spec.hot_entries, n_ways=spec.hot_ways,
                          caching_ms=spec.hot_caching_ms,
                          exact_expiry=spec.hot_exact),
        cycles_per_step=spec.cycles_per_step)


def run_host(spec: ServingSpec, counts: np.ndarray, device=None):
    """Drive the host scheduler on the pinned schedule; returns
    ``(scheduler, per_step_occupancy)`` — the oracle side of the
    host-vs-batched comparison (``simulate_serving(cfg, counts=counts)``
    is the other side)."""
    if spec.page_tokens != 2048:
        raise ValueError("host Request pages are granuled at 2048 tokens")
    ap = arrival_params(spec.arrival, spec.n_reqs)
    s = HashedScheduler(scheduler_config(spec), device=device)
    occ, n_arrived = [], 0
    for k in np.asarray(counts):
        n_new = min(int(k), spec.n_reqs - n_arrived)
        if n_new > 0:
            rids = torch.arange(n_arrived, n_arrived + n_new,
                                dtype=torch.int32)
            pages, dec = request_attrs(ap, rids)
            for rid, pg, d in zip(rids.tolist(), pages.tolist(),
                                  dec.tolist()):
                s.submit(Request(rid=rid, prompt_len=pg * spec.page_tokens,
                                 max_new=d))
        n_arrived += n_new
        s._admit()
        occ.append(len(s.active))
        s.step()  # re-runs _admit (a no-op), decodes, retires
    return s, np.asarray(occ)


def run_host_grid(specs, counts: np.ndarray, device=None):
    """One host scheduler per (spec, schedule) pair; returns the list of
    ``(scheduler, occ)``.  ``counts`` is ``[n_steps]`` (shared by every
    spec) or ``[G, n_steps]``, as ``sweep_serving(grid, counts=...)``
    takes it."""
    specs = list(specs)
    counts = np.asarray(counts, np.int32)
    if counts.ndim == 1:
        counts = np.broadcast_to(counts, (len(specs),) + counts.shape)
    if counts.shape[0] != len(specs):
        raise ValueError(f"need one schedule per spec: {counts.shape[0]} "
                         f"!= {len(specs)}")
    return [run_host(sp, counts[g], device) for g, sp in enumerate(specs)]
