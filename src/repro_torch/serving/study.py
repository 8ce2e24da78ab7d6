"""Scheduler-policy study through the Experiment API (port of
``repro.serving.study``).

The closed loop: the continuous-batching scheduler runs with FIFO or
charge-aware admission (its hot-page probes through the HCRAC probe
kernel on the card), each run emits its page-access trace, and both
traces evaluate against a mechanism grid through the Experiment layer's
``sweep_traces`` path (policy × mechanism — the serving analogue of the
thesis's workload × mechanism matrix).  The scheduler's own hot-page hit
rate rides along as a per-grid-point metric (``hot_frac``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.hcrac import HCRACConfig
from repro_torch.core.simulator import MechanismConfig, SimConfig
from repro_torch.core.timing import lowered_for_duration, ms_to_cycles
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig

__all__ = ["build_scheduler", "admission_hot_rate", "policy_experiment"]


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


def policy_experiment(mechanisms=("base", "chargecache"),
                      n_entries: int = 1024, caching_ms: float = 1.0,
                      n_reqs: int = 48, steps: int = 120, seed: int = 11,
                      device=None, **kw):
    """The (scheduler policy × mechanism) grid as one Experiment.

    Runs both schedulers now (their hot tables on ``device``) and returns
    the unexecuted spec, on the same ``device``; ``.run()`` evaluates
    every cell — one ``sim_step`` launch a policy's trace and chunk on
    the card — and labels the Results with dims ``(policy, mechanism)``
    plus the per-policy ``hot_frac`` metric.
    """
    from repro_torch.experiment import Experiment
    traces, trace_metrics = {}, {}
    for label, aware in (("fifo", False), ("charge_aware", True)):
        sched = build_scheduler(aware, n_reqs=n_reqs, steps=steps, seed=seed,
                                device=device)
        traces[label] = sched.emit_trace()
        trace_metrics[label] = {"hot_frac": admission_hot_rate(sched)}
    base = SimConfig(mech=MechanismConfig(
        kind="base",
        hcrac=HCRACConfig(n_entries=n_entries,
                          caching_cycles=ms_to_cycles(caching_ms)),
        lowered=lowered_for_duration(caching_ms)))
    return Experiment(traces=traces, axes={"mechanism": list(mechanisms)},
                      base=base, trace_dim="policy",
                      trace_metrics=trace_metrics, device=device, **kw)
