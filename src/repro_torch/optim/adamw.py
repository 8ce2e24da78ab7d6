"""AdamW with a cosine schedule and global-norm clipping (port of
``repro.optim.adamw``).

The optimizer state mirrors the parameter tree ``LM.tree()`` gives
(nested dicts, the layers as a list of per-layer trees): f32 first and
second moments ``m`` / ``v`` and an f32 ``master`` copy of the bf16
parameters, which are rounded from it after every update.  The leaves
are taken in ``jax.tree_util.tree_leaves`` order of ``repro``'s stacked
tree (``leaves``): dict keys sorted, and a list of layer trees walked
leaf path by leaf path, each path over the layers in order, which is
how ``repro``'s ``[n_layers, ...]`` leaves unstack.  That order decides
``global_norm``'s sum, and so the clip scale.  ``update`` is pure: it
returns new trees and leaves its arguments as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

__all__ = ["AdamWConfig", "OptState", "leaves", "unflatten", "tree_map",
           "schedule", "init", "global_norm", "update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: dict
    v: dict
    #: f32 master copy of the (bf16) parameters
    master: dict


def _paths(tree, prefix=()):
    """The key paths of a tree's leaves in ``repro``'s flattening order
    (a path's list step is an ``int``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        # layer trees of one structure: each leaf path, then the layers
        for sub in _paths(tree[0]):
            for i in range(len(tree)):
                yield prefix + (i,) + sub
    else:
        yield prefix


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``repro``'s order (module docstring)."""
    return [_get(tree, p) for p in _paths(tree)]


def unflatten(like, flat) -> dict:
    """A tree of ``like``'s structure holding ``flat`` (in ``leaves``'
    order)."""
    it = dict(zip(_paths(like), flat))

    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v, prefix + (i,)) for i, v in enumerate(t)]
        return it[prefix]
    return build(like, ())


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the same-structure
    ``rest``)."""
    out = [fn(*xs) for xs in zip(leaves(tree), *map(leaves, rest))]
    return unflatten(tree, out)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or int), f32: linear
    warm-up, then a cosine decay to ``min_lr_frac`` of the peak."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.peak_lr * warm * frac


def init(params) -> OptState:
    """Zero moments and an f32 master copy of ``params`` (a tree of
    tensors, on their devices)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    first = leaves(params)[0]
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params),
                    master=tree_map(lambda p: p.detach().to(torch.float32,
                                                            copy=True),
                                    params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in order) of each leaf's f32 sum
    of squares."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def update(cfg: AdamWConfig, grads, state: OptState, params):
    """Returns ``(new_params, new_state, {"grad_norm", "lr"})``: the
    gradients clipped to ``clip_norm`` by their global norm, one AdamW
    step with bias correction and decoupled weight decay on the f32
    master, the new parameters rounded from it to their dtypes."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(p, g, m, v, w):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        w = w - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * w)
        return w.to(p.dtype), m, v, w

    out = [upd(*xs) for xs in zip(leaves(params), leaves(grads),
                                  leaves(state.m), leaves(state.v),
                                  leaves(state.master))]
    unf = lambda i: unflatten(params, [o[i] for o in out])
    return unf(0), OptState(step=step, m=unf(1), v=unf(2),
                            master=unf(3)), {"grad_norm": gnorm, "lr": lr}
