"""Carry weights between ``repro``'s parameter tree and the port's model.

``repro`` stacks the layers on a leading ``layers`` axis; the port keeps
one tree per layer.  ``from_repro`` takes ``repro``'s tree as numpy
arrays (float32, or ``ml_dtypes`` bfloat16 as ``np.asarray`` of a JAX
bf16 array gives them, read by their bits) and builds the port's model;
``to_repro`` gives the stacked tree back as float32 numpy arrays, which
hold bf16 weights exactly.  The round trip is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import resolve_device

__all__ = ["from_repro", "to_repro"]


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
