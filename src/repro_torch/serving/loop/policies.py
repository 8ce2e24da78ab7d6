"""Registry of admission/preemption policies of the serving loop (port
of ``repro.serving.loop.policies``).

Each policy contributes a params block — a dict of tensors including a
boolean ``enable`` — present at every grid point, so a grid mixes
policies in one launch: the engine folds every registered policy's
score and preemption decision over the defaults, each gated by its
block's ``enable``.  The blocks are 0-d tensors for one configuration
and ``[G]``-stacked in a sweep; the fold broadcasts them against the
``[G, Q]`` queue.

A policy ranks queued requests by the hot-page charge model's
prediction, ``clip(1 - age / caching_cycles, 0, 1)`` of the request's
last page touch (``q_touch``), rather than by probing the table.
Admission breaks score ties by arrival order (FIFO).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["register_policy", "names", "get", "build_blocks",
           "admission_scores", "preempt_decision", "AdmitCtx",
           "PreemptCtx", "Policy"]

_REGISTRY: dict[str, "Policy"] = {}


def register_policy(name: str):
    """Class decorator: instantiate and register a serving policy."""
    def deco(cls):
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls
    return deco


def names() -> tuple:
    return tuple(_REGISTRY)


def get(name: str) -> "Policy":
    return _REGISTRY[name]


class AdmitCtx(NamedTuple):
    """What a policy may read when scoring queued requests."""
    now: torch.Tensor             # int32 [G]: scheduler clock
    q_touch: torch.Tensor         # int32 [G, Q]: last page-touch cycle
    q_seq: torch.Tensor           # int32 [G, Q]: arrival sequence number
    q_valid: torch.Tensor         # bool [G, Q]
    caching_cycles: torch.Tensor  # int32 [G]: hot-table charge window


class PreemptCtx(NamedTuple):
    now: torch.Tensor    # int32 [G]
    q_len: torch.Tensor  # int32 [G]: queue length after this step's arrivals


class Policy:
    """Base: a block is just the ``enable`` gate; no score (FIFO order),
    no preemption."""
    name = "?"

    def block(self, spec) -> dict:
        return {"enable": torch.tensor(spec.policy == self.name)}

    def score(self, blk: dict, ctx: AdmitCtx):
        return None

    def preempt(self, blk: dict, ctx: PreemptCtx):
        return None


def _charge_score(ctx: AdmitCtx) -> torch.Tensor:
    """Predicted page charge of each queued request: the hot-page decay
    law applied to its last touch (float32, each operation rounded once,
    the division tensor by tensor)."""
    age = (ctx.now[:, None] - ctx.q_touch).to(torch.float32)
    c = torch.clamp(ctx.caching_cycles.to(torch.float32), min=1.0)[:, None]
    return torch.clamp(1.0 - age / c, 0.0, 1.0)


@register_policy("fifo")
class FIFO(Policy):
    """Pure arrival order (the all-zero score + FIFO tie-break)."""


@register_policy("charge_aware")
class ChargeAware(Policy):
    """Admit requests whose KV pages are predicted still charged."""

    def score(self, blk, ctx):
        return _charge_score(ctx)


@register_policy("preempting")
class Preempting(Policy):
    """Charge-aware admission plus preempt-and-requeue when the queue is
    longer than ``preempt_queue_frac * queue_cap``: the active request
    with the most remaining work goes back to the queue (one a step)."""

    def block(self, spec):
        thresh = int(spec.preempt_queue_frac * spec.queue_cap)
        return {"enable": torch.tensor(spec.policy == self.name),
                "q_thresh": torch.tensor(thresh, dtype=torch.int32)}

    def score(self, blk, ctx):
        return _charge_score(ctx)

    def preempt(self, blk, ctx):
        return ctx.q_len > blk["q_thresh"]


def build_blocks(spec) -> dict:
    """One block per registered policy (every block at every point)."""
    return {n: pol.block(spec) for n, pol in _REGISTRY.items()}


def admission_scores(blocks: dict, ctx: AdmitCtx) -> torch.Tensor:
    """Fold every registered policy's score over the FIFO default (all
    zeros), each gated by its ``enable``: float32 ``[G, Q]``."""
    score = torch.zeros(ctx.q_touch.shape, dtype=torch.float32,
                        device=ctx.q_touch.device)
    for name, pol in _REGISTRY.items():
        s = pol.score(blocks[name], ctx)
        if s is not None:
            score = torch.where(blocks[name]["enable"][:, None], s, score)
    return score


def preempt_decision(blocks: dict, ctx: PreemptCtx) -> torch.Tensor:
    """Whether the enabled policy wants a preemption this step: bool
    ``[G]``."""
    do = torch.zeros(ctx.q_len.shape, dtype=torch.bool,
                     device=ctx.q_len.device)
    for name, pol in _REGISTRY.items():
        d = pol.preempt(blocks[name], ctx)
        if d is not None:
            do = torch.where(blocks[name]["enable"], d, do)
    return do
