"""Continuous-batching decode scheduler with charge-aware request
grouping (port of ``repro.serving.scheduler``).

A continuous-batching serving loop (admit up to ``max_batch`` requests,
decode one token for the active set each step, retire finished
requests) with the ChargeCache policy: when more requests are runnable
than slots, the scheduler probes the hot-page table and prefers requests
whose KV pages are still charged (recently accessed).

Every page access is also logged; ``emit_trace`` converts the log to
the DRAM simulator's trace format (``repro_torch.core.traces``).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.traces import Trace, TraceBatch, batch_traces
from repro_torch.serving.hot_pages import HotPageConfig, HotPageTracker

__all__ = ["Request", "SchedulerConfig", "Scheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new: int
    done_tokens: int = 0

    @property
    def n_pages(self) -> int:
        return -(-(self.prompt_len + self.done_tokens) // 2048)


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 16
    charge_aware: bool = True
    hot: HotPageConfig = dataclasses.field(default_factory=HotPageConfig)
    cycles_per_step: int = 4000      # DRAM-clock cycles per decode step


class Scheduler:
    """The host scheduler; its hot-page table lives on ``device`` (CUDA
    unless the caller names another), where its probes run."""

    def __init__(self, cfg: SchedulerConfig, device=None):
        self.cfg = cfg
        self.tracker = HotPageTracker(cfg.hot, device=device)
        self.queue: deque[Request] = deque()
        self.active: list[Request] = []
        self.now = 0
        self.trace_pages: list[int] = []
        self.trace_times: list[int] = []
        self.stats = {"steps": 0, "hot_hits": 0, "probes": 0,
                      "retired": 0, "admit_probes": 0, "admit_hot": 0}

    def submit(self, req: Request):
        """Queue a request; its prompt prefill touches its KV pages, so a
        queued request carries page charge that decays with queue age."""
        pages = self._page_ids(req)
        self.tracker.touch(pages, self.now)
        self.trace_pages.extend(pages.tolist())
        self.trace_times.extend([self.now] * len(pages))
        self.queue.append(req)

    def _page_ids(self, req: Request) -> np.ndarray:
        base = req.rid * 131072
        return base + np.arange(req.n_pages, dtype=np.int64)

    def _admit(self):
        free = self.cfg.max_batch - len(self.active)
        if free <= 0 or not self.queue:
            return
        if not self.cfg.charge_aware or len(self.queue) <= free:
            for _ in range(min(free, len(self.queue))):
                self.active.append(self.queue.popleft())
            return
        # charge-aware: rank runnable requests by hot-page hits
        cands = list(self.queue)
        scores = []
        for r in cands:
            pages = self._page_ids(r)
            hits = self.tracker.probe(pages, self.now)
            self.stats["probes"] += len(pages)
            self.stats["hot_hits"] += int(hits.sum())
            scores.append(float(hits.mean()) if len(hits) else 0.0)
        # stable sort on negated scores: equal scores keep arrival order
        order = np.argsort(-np.asarray(scores), kind="stable")[:free]
        chosen = {cands[i].rid for i in order}
        self.active.extend(r for r in cands if r.rid in chosen)
        self.queue = deque(r for r in cands if r.rid not in chosen)

    def step(self):
        """One decode step for the active batch."""
        self._admit()
        # admission hot rate: how charged are a request's pages at its
        # first decode step (measured alike under both policies)
        for r in self.active:
            if r.done_tokens == 0:
                pages = self._page_ids(r)
                hits = self.tracker.probe(pages, self.now)
                self.stats["admit_probes"] += len(pages)
                self.stats["admit_hot"] += int(hits.sum())
        accessed = []
        for r in self.active:
            pages = self._page_ids(r)
            # decode touches the written page + streams the read pages
            accessed.append(pages)
            r.done_tokens += 1
        if accessed:
            flat = np.concatenate(accessed)
            self.tracker.touch(flat, self.now)
            self.trace_pages.extend(flat.tolist())
            self.trace_times.extend([self.now] * len(flat))
        still = []
        for r in self.active:
            if r.done_tokens < r.max_new:
                still.append(r)
            else:
                self.stats["retired"] += 1
        self.active = still
        self.now += self.cfg.cycles_per_step
        self.stats["steps"] += 1

    def run(self, n_steps: int):
        for _ in range(n_steps):
            if not self.queue and not self.active:
                break
            self.step()

    def emit_trace(self) -> TraceBatch:
        """Convert the page-access log to a DRAM simulator trace."""
        pages = np.asarray(self.trace_pages, np.int64)
        times = np.asarray(self.trace_times, np.int64)
        bank, row = self.tracker.page_to_dram(pages)
        # the first request's gap is the intra-step spacing, not the first
        # absolute timestamp
        gaps = np.diff(times, prepend=times[:1])
        # several accesses share a scheduler step -> small intra-step gaps
        same = gaps == 0
        gaps[same] = 4
        # saturate before the int64 -> int32 cast (the generator's int32
        # cycle-horizon guard)
        gaps = np.clip(gaps, 1, np.int64(1) << 20)
        tr = Trace(gap=gaps.astype(np.int32),
                   bank=bank, row=row,
                   is_write=np.zeros(len(pages), bool),
                   dep=np.zeros(len(pages), bool))
        return batch_traces([tr])
