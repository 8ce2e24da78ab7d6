"""Logical-axis sharding rules with a divisibility fallback (port of
``repro.sharding``), placed on a ``torch.distributed`` ``DeviceMesh``.

Parameters and activations are annotated with *logical* axis names
("embed", "hidden", "vocab", ...).  The rules table maps each logical
axis to an ordered list of mesh-axis candidates; a candidate is taken
only if it exists in the mesh, no other dim of the tensor took it, and
the product of the dim's taken axes divides the dim.  One rule set
serves every model config: phi4-mini's 24 query heads do not divide a
16-way "model" axis, so head-structured dims stay replicated while the
flattened projection dims (24 * 128 = 3072) still shard.

``spec_for`` gives the port's canonical spec: a tuple with one entry a
dim -- ``None``, one axis name, or a tuple of names -- trailing ``None``s
dropped (``repro``'s ``PartitionSpec`` as a plain tuple).  It reads only
``mesh.shape`` as a mapping of axis names to sizes, or a ``DeviceMesh``'s
``mesh_dim_names`` and ``shape``.  ``placements`` turns a spec into
DTensor placements on a ``DeviceMesh``: a dim split over several mesh
axes (the batch over ``("pod", "data")``) becomes one ``Shard(d)`` a
mesh axis in mesh-dim order, so the first axis is the major one, as in
JAX; a spec whose axes of one dim run against the mesh's order is
refused (DTensor would need a strided shard).

The active mesh and rules are process-global (``set_mesh``); without a
mesh every helper is a no-op.  The models do not call ``shard`` in this
port, just as ``repro``'s calls constrain nothing outside its dry run;
parameters and checkpoints are placed through ``params.param_shardings``
/ ``params.shard_params`` and ``checkpoint.manager.restore``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

__all__ = ["DEFAULT_RULES", "ShardingCtx", "set_mesh", "get_mesh",
           "axis_sizes", "spec_for", "placements", "NamedSharding",
           "named_sharding", "shard"]

#: logical axis -> ordered mesh-axis candidates.  A dim may absorb several
#: candidates (e.g. batch over ("pod", "data")) as long as divisibility
#: holds for the accumulated product.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),          # FSDP: param/optimizer shards over data
    "hidden": ("model",),        # TP: d_ff and flattened q-proj dims
    "kv_hidden": ("model",),
    "heads": ("model",),         # head-structured activations (if divisible)
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("data",),        # expert dim: FSDP storage; compute-time
                                 # layout is TP-on-expert_hidden (weights
                                 # regathered in moe_apply — see §Perf)
    "expert_hidden": ("model",),  # TP inside experts (mixtral fallback)
    "capacity": (),
    "seq": (),                   # overridden to ("data",) for SP hillclimbs
    # Decode caches: no assigned arch has kv_heads divisible by a 16-way
    # model axis, so the cache shards along its *sequence* dim instead
    # (split-KV / flash-decoding layout) — without this every decode cell
    # replicates its KV cache per device (measured 153 GB on phi3-medium).
    "kv_seq": ("model",),
    "kv_split": ("model",),   # flash-decoding partial-softmax splits
    "layers": (),                # scan dim, never sharded
    "state": (),                 # SSM state / conv taps
}


@dataclasses.dataclass
class ShardingCtx:
    mesh: Optional[object] = None
    rules: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))


_CTX = ShardingCtx()


def set_mesh(mesh, rules: Optional[dict] = None) -> None:
    """Make ``mesh`` (a ``DeviceMesh``, or None) the active mesh, with
    ``DEFAULT_RULES`` updated by ``rules``."""
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES)
    if rules:
        _CTX.rules.update(rules)


def get_mesh():
    return _CTX.mesh


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``
    and ``shape``) or of anything whose ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def spec_for(axes: tuple, shape: tuple, mesh=None,
             rules: Optional[dict] = None) -> tuple:
    """Logical axes -> the canonical spec under the divisibility rule
    (``()`` without a mesh)."""
    mesh = _CTX.mesh if mesh is None else mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return ()
    assert len(axes) == len(shape), (axes, shape)
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    entries = []
    for ax, dim in zip(axes, shape):
        got: list[str] = []
        if ax is not None:
            prod = 1
            for cand in rules.get(ax, ()):
                if cand not in sizes or cand in used:
                    continue
                n = sizes[cand]
                if dim % (prod * n) == 0:
                    got.append(cand)
                    used.add(cand)
                    prod *= n
        if not got:
            entries.append(None)
        elif len(got) == 1:
            entries.append(got[0])
        else:
            entries.append(tuple(got))
    # drop trailing Nones (canonical form)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: one
    a mesh dim, ``Shard(d)`` where dim ``d`` takes that mesh axis, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} takes mesh axes {axes} against the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A mesh and the placements of one tensor on it."""
    mesh: object
    placements: tuple


def named_sharding(axes: tuple, shape: tuple,
                   mesh=None) -> Optional[NamedSharding]:
    """``(mesh, placements)`` of a tensor with logical ``axes``, or None
    without a mesh."""
    mesh = _CTX.mesh if mesh is None else mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, placements(spec_for(axes, shape, mesh), mesh))


def shard(x, *axes):
    """Lay ``x`` out by logical axis names on the active mesh: a no-op
    without one, else a redistribution of the DTensor ``x``."""
    if _CTX.mesh is None:
        return x
    ns = named_sharding(tuple(axes), tuple(x.shape))
    return x.redistribute(ns.mesh, ns.placements)
