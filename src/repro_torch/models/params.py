"""Declarative parameter trees (port of ``repro.models.params``).

A model is declared as a tree (nested dicts and lists) of ``ParamDef``s:
shape, logical axes and initialiser in one place.  ``init_params``
materialises it on a device (CUDA unless the caller names another,
``resolve_device``); ``count_params`` counts it.  ``param_specs`` and
``param_shardings`` are the tree's sharding views under a mesh
(``repro_torch.sharding``), and ``shard_params`` lays a tree of tensors
out as DTensors by its defs' logical axes.  ``abstract_params`` is the
dry run's tree: meta tensors, or DTensors over meta shards under a mesh
(``abstract_tensor``), so a full-size model is never allocated.
"""

from __future__ import annotations

import zlib
from typing import Iterator, NamedTuple

import torch

from repro_torch import sharding as shd

__all__ = ["ParamDef", "is_def", "leaf_paths", "map_defs", "init_params",
           "count_params", "resolve_device", "param_specs",
           "param_shardings", "shard_params", "local_shape",
           "contiguous_strides", "abstract_tensor", "abstract_params"]


class ParamDef(NamedTuple):
    shape: tuple
    axes: tuple                 # logical axis names (len == len(shape))
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0          # multiplier on the fan-in-scaled std

    @property
    def std(self) -> float:
        """The fan-in-scaled standard deviation of a ``normal`` leaf."""
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return self.scale / max(fan_in, 1) ** 0.5


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def leaf_paths(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """``(path, leaf)`` of every leaf, dict keys in sorted order (as
    ``jax.tree_util`` flattens them); a path reads like ``jax.tree_util
    .keystr``: ``['layers'][0]['attn']['wq']``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)) and not is_def(tree):
        for i, t in enumerate(tree):
            yield from leaf_paths(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def map_defs(fn, tree, prefix: str = ""):
    """The tree with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_defs(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_def(tree):
        return [map_defs(fn, t, f"{prefix}[{i}]") for i, t in enumerate(tree)]
    return fn(prefix, tree)


def path_id(path: str) -> int:
    """The leaf's 31-bit key: crc32 of its path (``hash()`` is salted per
    process)."""
    return zlib.crc32(path.encode()) & 0x7FFFFFFF


def resolve_device(device) -> torch.device:
    """The device a model helper builds on: CUDA unless the caller names
    another; raises when CUDA is wanted and missing (no fallback to the
    CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to build on the CPU")
    return device


def init_params(defs, seed: int = 0, dtype=torch.float32, device=None):
    """Materialise a ParamDef tree on ``device`` (``resolve_device``).
    Each ``normal`` leaf draws from its own ``torch.Generator`` seeded
    with the crc32 of its path mixed with ``seed``, so the result does not
    depend on traversal order.  The draws are not ``jax.random``'s: the
    same seed gives other weights than
    ``repro.models.params.init_params``."""
    device = resolve_device(device)

    def init_one(path, d: ParamDef):
        if len(d.shape) != len(d.axes):
            raise ValueError(f"{path}: shape {d.shape} vs axes {d.axes}")
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        gen = torch.Generator(device=device)
        # 32 bits: the CPU generator keeps only the low word of a seed
        gen.manual_seed((path_id(path) ^ (seed * 0x9E37_79B1)) & 0xFFFFFFFF)
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * d.std).to(dtype)

    return map_defs(init_one, defs)


def param_shardings(defs, mesh=None):
    """The tree of ``sharding.named_sharding``s (a mesh and its
    placements a leaf; None entries without a mesh)."""
    return map_defs(lambda _, d: shd.named_sharding(d.axes, d.shape, mesh),
                    defs)


def param_specs(defs, mesh=None):
    """The tree of canonical specs (``sharding.spec_for``)."""
    return map_defs(lambda _, d: shd.spec_for(d.axes, d.shape, mesh), defs)


def _zip_map(fn, tree, defs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, defs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(fn, t, d) for t, d in zip(tree, defs, strict=True)]
    return fn(tree, defs)


def shard_params(tree, defs, mesh=None):
    """``tree`` (tensors shaped as ``defs``' leaves: a model's
    ``LM.tree()``, or AdamW's moments and master copy) as DTensors on
    ``mesh`` (default: the active mesh), each placed by its def's logical
    axes.  Every rank holds the whole tensor and keeps its own shard of
    it (no communication)."""
    from torch.distributed.tensor import distribute_tensor
    mesh = shd.get_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("shard_params needs a mesh")

    def one(t, d: ParamDef):
        if tuple(t.shape) != tuple(d.shape):
            raise ValueError(f"shape {tuple(t.shape)} vs def {d.shape}")
        ns = shd.named_sharding(d.axes, d.shape, mesh)
        return distribute_tensor(t.to(mesh.device_type), mesh,
                                 ns.placements, src_data_rank=None)
    return _zip_map(one, tree, defs)


def local_shape(shape: tuple, mesh, placements) -> tuple:
    """The shard of a ``shape`` tensor that this rank holds under
    ``placements``: each ``Shard(d)`` cuts dim ``d`` as ``torch.chunk``
    does (ceil-sized pieces, the last ones short or empty), in mesh-dim
    order, so that the first mesh axis of a dim is the major one (JAX's
    order)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    out = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            n, c = mesh.size(m), coord[m]
            piece = -(-out[p.dim] // n)
            out[p.dim] = max(0, min(piece, out[p.dim] - c * piece))
    return tuple(out)


def contiguous_strides(shape: tuple) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (computed: a meta
    tensor made to read them would count as memory under the op
    counter)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def abstract_tensor(shape: tuple, dtype, axes=None):
    """A meta tensor of ``shape``; with a mesh active and logical
    ``axes`` given, a DTensor placed by them whose local shard is a meta
    tensor (``local_shape``): no memory either way."""
    shape = tuple(shape)
    ns = shd.named_sharding(tuple(axes), shape) if axes is not None else None
    if ns is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor
    local = torch.empty(local_shape(shape, ns.mesh, ns.placements),
                        dtype=dtype, device="meta")
    return DTensor.from_local(local, ns.mesh, ns.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def abstract_params(defs, dtype=torch.float32):
    """The tree of ``defs`` as meta tensors, or under a mesh
    (``sharding.set_mesh``) as DTensors over meta shards placed by each
    def's logical axes (``abstract_tensor``): the dry run's parameters,
    never allocated."""
    return map_defs(lambda _, d: abstract_tensor(d.shape, dtype, d.axes),
                    defs)


def count_params(defs) -> int:
    total = 0
    for _, d in leaf_paths(defs):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total
