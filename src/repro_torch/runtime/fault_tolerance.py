"""Fault-tolerant distributed runtime: failure detection, straggler
mitigation, elastic remesh, deterministic restart (port of
``repro.runtime.fault_tolerance``, numpy as there).

The coordinator's control loop runs against a simulated cluster
(``SimulatedCluster``), so every policy -- detection, deadline-based
straggler re-dispatch, shrink-to-survivors remesh, checkpoint-restore-
resume -- runs end to end in tests and in
``examples/fault_tolerance_torch.py``, whose ``remesh`` reports the
``elastic_mesh_shape`` of the survivors and whose restore goes through
``repro_torch.checkpoint.manager.restore`` (which re-shards DTensor
leaves onto the active mesh).

* **Failure detection**: a heartbeat table; a host is reported failed
  once, in the round where its missed beats reach
  ``missed_beats_to_fail`` (an equality: it is not reported again).
* **Straggler mitigation**: a per-step deadline of ``straggler_factor``
  times an EWMA of the median step time (seeded by the first median,
  kept in Python floats; the median over the hosts in the dict's
  insertion order); hosts over it are counted as re-dispatched to a
  spare.  The data-parallel shard is a pure function of the step, so a
  re-dispatch is a re-run; the loop records it and does nothing else.
* **Elastic remesh**: the largest (data x model) grid of the survivors
  that keeps the model axis; below it (degraded mode) the model axis
  shrinks to a power of two.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class FTConfig:
    heartbeat_interval_s: float = 1.0
    missed_beats_to_fail: int = 3
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.2
    min_data_axis: int = 1


class SimulatedCluster:
    """A host set with scriptable failures/stragglers (for tests)."""

    def __init__(self, n_hosts: int, seed: int = 0):
        self.n_hosts = n_hosts
        self.alive = np.ones(n_hosts, bool)
        self.slow = np.zeros(n_hosts, bool)
        self.clock = 0.0
        self.rng = np.random.default_rng(seed)

    def fail(self, host: int):
        self.alive[host] = False

    def make_straggler(self, host: int):
        self.slow[host] = True

    def heartbeats(self) -> np.ndarray:
        """Hosts that reported a beat this interval."""
        return self.alive.copy()

    def step_time(self, host: int, base: float) -> float:
        return base * (4.0 if self.slow[host] else 1.0)


class FailureDetector:
    def __init__(self, cfg: FTConfig, n_hosts: int):
        self.cfg = cfg
        self.missed = np.zeros(n_hosts, np.int32)

    def observe(self, beats: np.ndarray) -> list[int]:
        """Feed one heartbeat round; returns newly-failed host ids."""
        self.missed = np.where(beats, 0, self.missed + 1)
        return [int(i) for i in
                np.nonzero(self.missed == self.cfg.missed_beats_to_fail)[0]]


class StragglerMitigator:
    """EWMA step-time deadline; returns hosts to speculatively re-dispatch."""

    def __init__(self, cfg: FTConfig):
        self.cfg = cfg
        self.ewma: Optional[float] = None
        self.redispatched: int = 0

    def observe(self, step_times: dict[int, float]) -> list[int]:
        med = float(np.median(list(step_times.values())))
        self.ewma = (med if self.ewma is None
                     else (1 - self.cfg.ewma_alpha) * self.ewma
                     + self.cfg.ewma_alpha * med)
        deadline = self.cfg.straggler_factor * self.ewma
        slow = [h for h, t in step_times.items() if t > deadline]
        self.redispatched += len(slow)
        return slow


def elastic_mesh_shape(n_devices: int, model_axis: int,
                       min_data: int = 1) -> tuple[int, int]:
    """Largest (data, model) grid for the survivors, keeping the model
    axis intact (TP degree is fixed by the model's sharding); data axis
    shrinks to what remains."""
    if n_devices < model_axis:
        # degraded mode: shrink TP too (restore re-shards params anyway)
        model_axis = max(1, 2 ** int(np.log2(max(n_devices, 1))))
    data = max(min_data, n_devices // model_axis)
    return data, model_axis


@dataclasses.dataclass
class RunReport:
    steps_done: int
    failures: list
    redispatches: int
    remeshes: list
    restored_from: list


def fault_tolerant_run(n_steps: int, cluster: SimulatedCluster,
                       cfg: FTConfig,
                       do_step: Callable[[int, int], float],
                       save_ckpt: Callable[[int], None],
                       restore_ckpt: Callable[[], int],
                       remesh: Callable[[int], None],
                       ckpt_every: int = 10) -> RunReport:
    """The coordinator control loop (simulated time).

    ``do_step(step, n_hosts) -> step_time``; ``remesh(n_alive)`` rebuilds
    mesh+shardings; ``restore_ckpt() -> step`` reloads the latest step.
    """
    det = FailureDetector(cfg, cluster.n_hosts)
    strag = StragglerMitigator(cfg)
    report = RunReport(0, [], 0, [], [])
    step = 0
    while step < n_steps:
        failed = det.observe(cluster.heartbeats())
        if failed:
            report.failures.extend(failed)
            n_alive = int(cluster.alive.sum())
            remesh(n_alive)
            report.remeshes.append((step, n_alive))
            step = restore_ckpt()
            report.restored_from.append(step)
            continue
        base = do_step(step, int(cluster.alive.sum()))
        times = {int(h): cluster.step_time(int(h), base)
                 for h in np.nonzero(cluster.alive)[0]}
        slow = strag.observe(times)
        report.redispatches = strag.redispatched
        if slow:
            # speculative re-dispatch: the step's wall time becomes the
            # median (spare finishes first), not the straggler's
            pass
        step += 1
        report.steps_done = step
        if step % ckpt_every == 0:
            save_ckpt(step)
    return report
