"""Carry weights between ``repro``'s parameter tree and the port's model.

``repro`` stacks the layers on a leading ``layers`` axis; the port keeps
one tree per layer.  ``from_repro`` takes ``repro``'s tree as numpy
arrays (float32, or ``ml_dtypes`` bfloat16 as ``np.asarray`` of a JAX
bf16 array gives them, read by their bits) and builds the port's model;
``to_repro`` gives the stacked tree back as float32 numpy arrays, which
hold bf16 weights exactly.  The round trip is exact.

Training state crosses the same way: ``tree_from_repro`` / ``tree_to_repro``
carry any tree of that shape (gradients, moments) unstacked to the port's
layer lists and back, keeping dtypes; ``opt_from_repro`` /
``opt_to_repro`` carry ``repro``'s ``OptState`` (``step``, ``m``, ``v``,
``master``, as numpy arrays) to the port's ``adamw.OptState`` and back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import resolve_device

__all__ = ["from_repro", "to_repro", "tree_from_repro", "tree_to_repro",
           "opt_from_repro", "opt_to_repro"]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, t) for k, t in tree.items()}
    return fn(tree)


#: the keys of a parameter tree whose layers ``repro`` stacks
_STACKED = ("layers", "enc_layers", "dec_layers")


def _depth(t) -> int:
    while isinstance(t, dict):
        t = next(iter(t.values()))
    return np.asarray(t).shape[0]


def from_repro(tree: dict, cfg: ModelConfig, device=None) -> lm.LM:
    """The port's model from ``repro``'s parameter tree (numpy leaves,
    ``layers`` / ``enc_layers`` / ``dec_layers`` stacked), in bf16 on
    ``device`` (CUDA unless named, ``params.resolve_device``)."""
    dev = resolve_device(device)
    conv = lambda a: _tensor(a).to(device=dev, dtype=torch.bfloat16)
    port = {}
    for k, t in tree.items():
        if k in _STACKED:
            port[k] = [_map(lambda a, i=i: conv(np.asarray(a)[i]), t)
                       for i in range(_depth(t))]
        else:
            port[k] = _map(conv, t)
    return lm.LM(cfg, port)


def to_repro(model: lm.LM) -> dict:
    """``repro``'s parameter tree (layer lists stacked) as float32 numpy
    arrays."""
    f32 = lambda t: t.detach().float().cpu().numpy()
    tree = model.tree()

    def stack(layers, path):
        def get(t):
            for k in path:
                t = t[k]
            return t
        return np.stack([f32(get(lp)) for lp in layers])

    def walk(layers, t, path):
        if isinstance(t, dict):
            return {k: walk(layers, v, path + (k,)) for k, v in t.items()}
        return stack(layers, path)

    return {k: (walk(t, t[0], ()) if isinstance(t, list) else _map(f32, t))
            for k, t in tree.items()}


def tree_from_repro(tree: dict, device=None, dtype=None) -> dict:
    """A tree of ``repro``'s shape (numpy leaves, layers stacked) as the
    port's (layer lists) of tensors on ``device`` (CUDA unless named),
    in ``dtype`` (default: each leaf's own; bf16 read by its bits)."""
    dev = resolve_device(device)
    conv = lambda a: _tensor(a).to(device=dev, dtype=dtype)
    out = {}
    for k, t in tree.items():
        if k in _STACKED:
            out[k] = [_map(lambda a, i=i: conv(np.asarray(a)[i]), t)
                      for i in range(_depth(t))]
        else:
            out[k] = _map(conv, t)
    return out


def tree_to_repro(tree: dict) -> dict:
    """The port's tree (layer lists) as ``repro``'s (stacked), numpy
    leaves in each tensor's dtype (bf16 as float32, which holds it
    exactly)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def walk(layers, t, path):
        if isinstance(t, dict):
            return {k: walk(layers, v, path + (k,)) for k, v in t.items()}
        leaf = lambda lp: host(_at(lp, path))
        return np.stack([leaf(lp) for lp in layers])

    return {k: (walk(t, t[0], ()) if isinstance(t, list) else _map(host, t))
            for k, t in tree.items()}


def _at(t, path):
    for k in path:
        t = t[k]
    return t


def opt_from_repro(state, device=None):
    """``repro``'s ``OptState`` (numpy ``step``, ``m``, ``v``,
    ``master`` trees, f32) as the port's ``adamw.OptState``."""
    from repro_torch.optim.adamw import OptState
    dev = resolve_device(device)
    return OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        m=tree_from_repro(state.m, dev, torch.float32),
        v=tree_from_repro(state.v, dev, torch.float32),
        master=tree_from_repro(state.master, dev, torch.float32))


def opt_to_repro(state) -> dict:
    """The port's ``adamw.OptState`` as numpy: ``{"step": int32 scalar,
    "m", "v", "master": repro-shaped f32 trees}``."""
    return {"step": np.int32(int(state.step)),
            "m": tree_to_repro(state.m), "v": tree_to_repro(state.v),
            "master": tree_to_repro(state.master)}
