"""Scheduler-policy study (port of ``repro.serving.study``): the host
closed loop that runs the continuous-batching scheduler with FIFO or
charge-aware admission and keeps its page-access trace.
``policy_experiment`` (the policy x mechanism grid) waits for the
Experiment layer."""

from __future__ import annotations

import numpy as np

from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig

__all__ = ["build_scheduler", "admission_hot_rate"]


def build_scheduler(charge_aware: bool, n_reqs: int = 48, steps: int = 120,
                    max_batch: int = 16, seed: int = 11,
                    device=None) -> Scheduler:
    """Run the decode loop and return the scheduler (with its trace).

    Requests arrive over time (a front-loaded schedule drawn from
    ``seed``): each submission prefill-touches its KV pages, so queued
    requests carry page charge that decays with queue age — the signal
    that lets charge-aware admission diverge from FIFO.  The hot-page
    table lives on ``device`` (CUDA unless the caller names another).
    """
    cfg = SchedulerConfig(max_batch=max_batch, charge_aware=charge_aware)
    sched = Scheduler(cfg, device=device)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=rid,
                    prompt_len=int(rng.integers(2048, 16384)),
                    max_new=int(rng.integers(16, 64)))
            for rid in range(n_reqs)]
    arrivals = np.sort(rng.integers(0, max(1, steps // 2), n_reqs))
    i = 0
    for t in range(steps):
        while i < n_reqs and arrivals[i] <= t:
            sched.submit(reqs[i])
            i += 1
        if i >= n_reqs and not sched.queue and not sched.active:
            break
        sched.step()  # an idle step just advances the clock
    return sched


def admission_hot_rate(sched: Scheduler) -> float:
    """Fraction of first-decode page probes that hit the hot-page table —
    the policy-comparable admission-quality metric."""
    return sched.stats["admit_hot"] / max(sched.stats["admit_probes"], 1)
