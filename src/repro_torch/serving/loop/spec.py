"""Static description of a serving-loop run (port of
``repro.serving.loop.spec``).

``ServingSpec`` is a frozen, hashable record of everything about one
serving grid point that is not a DRAM setting: slot and queue capacities
(array shapes), the arrival process (whose numbers become tensors), the
admission policy's name (resolved through the policy registry), and the
hot-page table's geometry.  It hangs off ``SimConfig.serving``; the
engine is ``repro_torch.serving.loop.engine``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import hcrac as hcl
from repro_torch.core.timing import ms_to_cycles
from repro_torch.serving.loop import policies
from repro_torch.workloads.arrivals import ArrivalConfig

__all__ = ["ServingSpec"]


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    #: admission/preemption policy (``repro_torch.serving.loop.policies``)
    policy: str = "fifo"
    arrival: ArrivalConfig = ArrivalConfig()
    #: total request budget of the stream (arrivals stop at this count)
    n_reqs: int = 1024
    #: fixed decode slots (the continuous batch)
    max_batch: int = 16
    #: admission queue capacity (arrivals drop when full)
    queue_cap: int = 64
    #: bound on arrivals accepted per step
    arrivals_max: int = 8
    #: scan length; 0 = sized from rate and decode length (``steps()``)
    n_steps: int = 0
    #: DRAM-clock cycles per decode step (the scheduler's fixed tick)
    cycles_per_step: int = 4000
    #: tokens of KV per HBM page granule
    page_tokens: int = 2048
    # hot-page table (the serving-layer HCRAC over KV pages)
    hot_entries: int = 1024
    hot_ways: int = 2
    hot_caching_ms: float = 1.0
    #: idealised per-entry expiry (slot-phase independent aliveness,
    #: what the host-vs-batched parity pins)
    hot_exact: bool = False
    #: ``preempting`` policy: preempt when the queue is longer than this
    #: fraction of ``queue_cap``
    preempt_queue_frac: float = 0.5

    def __post_init__(self):
        if self.policy not in policies.names():
            raise ValueError(f"unregistered serving policy {self.policy!r}; "
                             f"known: {policies.names()}")
        if not (self.max_batch > 0 and self.queue_cap > 0):
            raise ValueError("max_batch and queue_cap must be > 0")
        if not 0 < self.arrivals_max <= self.queue_cap:
            raise ValueError("need 0 < arrivals_max <= queue_cap")
        if not (self.n_reqs > 0 and self.cycles_per_step > 0):
            raise ValueError("n_reqs and cycles_per_step must be > 0")
        if not self.page_tokens > 0:
            raise ValueError("page_tokens must be > 0")

    def hot_cfg(self) -> hcl.HCRACConfig:
        return hcl.HCRACConfig(
            n_entries=self.hot_entries, n_ways=self.hot_ways,
            caching_cycles=ms_to_cycles(self.hot_caching_ms),
            exact_expiry=self.hot_exact)

    def steps(self) -> int:
        """Scan length: explicit ``n_steps``, else sized so the whole
        request budget arrives and drains (mean decode service time over
        ``max_batch`` slots, 25 % slack)."""
        if self.n_steps:
            return self.n_steps
        a = self.arrival
        mean_decode = 0.5 * (a.decode_min + a.decode_max)
        fill = self.n_reqs / max(a.rate, 1e-6)
        drain = 1.25 * self.n_reqs * mean_decode / self.max_batch
        return int(fill + drain) + 32

    def pages_max(self) -> int:
        """Bound on the KV pages a request streams in one decode step:
        prompt pages plus the pages its decoded tokens have grown into
        (the last decode touches ``done = decode_max - 1``)."""
        a = self.arrival
        grown = (max(a.decode_max - 1, 0) + self.page_tokens - 1)
        return a.prompt_pages_max + grown // self.page_tokens
