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
mesh every helper is a no-op.  The models call ``shard`` where ``repro``'s
do (the embeddings, each layer's output, q / k / v, the MLP's hidden
activations, the logits): without a mesh, or on a tensor that is no
DTensor, it returns its argument, so only the dry run's DTensors
(``launch/dryrun.py``) are laid out by it, as ``repro``'s constraints
act only inside its dry run.  Parameters and checkpoints are placed
through ``params.param_shardings`` / ``params.shard_params`` and
``checkpoint.manager.restore``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

__all__ = ["DEFAULT_RULES", "ShardingCtx", "set_mesh", "get_mesh",
           "axis_sizes", "spec_for", "placements", "NamedSharding",
           "named_sharding", "shard", "is_dtensor", "split_last",
           "merge_last", "split_leading", "pick_last", "logsumexp_last",
           "index_copy_", "local_call"]

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


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (the dry run's tensors under a mesh)."""
    if _CTX.mesh is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x, *axes):
    """Lay ``x`` out by logical axis names on the active mesh, and its
    gradient too (``jax.lax.with_sharding_constraint`` constrains the
    cotangent alike: partial sums that reach it are reduced there, as
    Megatron's all-reduce at a column-split product's input): a no-op
    without a mesh or where ``x`` is no DTensor."""
    if not is_dtensor(x):
        return x
    ns = named_sharding(tuple(axes), tuple(x.shape))
    return _Constrain.apply(x, ns.mesh, ns.placements)


class _Constrain(torch.autograd.Function):
    """``redistribute`` forward, and the gradient to the same layout."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.layout = (mesh, placements)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout), None, None


def split_last(x, shape: tuple, *axes):
    """``x.reshape(shape)``, where ``shape`` splits ``x``'s last dim in
    two (heads and head dim), laid out by the logical ``axes`` of the
    result (``shard``).  A DTensor is first laid out so that its last dim
    carries the split the first of the two new dims will have (a split
    of heads that do not divide a mesh axis would be uneven: the dim is
    gathered instead); without a mesh, or on a tensor that is no DTensor,
    a plain reshape."""
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Shard
    full = tuple(x.shape[:-1]) + tuple(shape[-2:])
    ns = named_sharding(tuple(axes), full)
    flat = tuple(Shard(x.dim() - 1) if p == Shard(len(full) - 2) else p
                 for p in ns.placements)
    return x.redistribute(ns.mesh, flat).reshape(shape)


def merge_last(x, *axes):
    """``x.reshape(x.shape[:-2] + (-1,))`` (heads back into a width).  A
    DTensor is laid out by the logical ``axes`` of ``x`` first and the
    merged dim takes the split of the heads dim; the gradient is laid out
    alike on both sides, so that its split undoes into heads (heads that
    do not divide a mesh axis leave the width whole)."""
    flat = tuple(x.shape[:-2]) + (-1,)
    if not is_dtensor(x):
        return x.reshape(flat)
    ns = named_sharding(tuple(axes), tuple(x.shape))
    y = _Constrain.apply(x, ns.mesh, ns.placements).reshape(flat)
    return _Constrain.apply(y, ns.mesh, ns.placements)


def split_leading(x, n: int):
    """``x.reshape((n, x.shape[0] // n) + x.shape[1:])`` (microbatches).
    A DTensor is split shard by shard: piece ``i`` of the result holds
    the ``i``-th ``1/n`` of every rank's shard (on one rank, the global
    reshape's rows), so no data moves and each rank keeps its share of
    every piece."""
    shape = (n, x.shape[0] // n) + tuple(x.shape[1:])
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import DTensor, Shard
    local = x.to_local()
    local = local.reshape((n, local.shape[0] // n) + tuple(local.shape[1:]))
    pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
          for p in x.placements]
    from repro_torch.models.params import contiguous_strides
    return DTensor.from_local(local, x.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def pick_last(x, idx):
    """``x[..., idx]``: ``torch.gather`` along the last dim of ``x`` at
    ``idx`` (one index a row).  A DTensor split along that dim (the
    logits' vocab) is picked from on each rank, an index outside the
    rank's part giving 0, and the picks are partial sums over the split
    (DTensor's own vocab-split gather keeps a mask that its backward
    cannot take)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, last = x.device_mesh, x.dim() - 1
    offset = _local_span(x, last)[0]

    def pick(xl, il):
        il = il.long() - offset
        ok = (il >= 0) & (il < xl.shape[-1])
        got = torch.gather(xl, -1, il.clamp(0, xl.shape[-1] - 1)[..., None])
        return torch.where(ok, got[..., 0], torch.zeros_like(got[..., 0]))

    x_pl = list(x.placements)
    idx_pl = [Replicate() if p == Shard(last) else p for p in x_pl]
    out_pl = [Partial() if p == Shard(last) else p for p in x_pl]
    return local_map(pick, out_placements=out_pl, in_placements=(x_pl, idx_pl),
                     device_mesh=mesh, redistribute_inputs=True)(x, idx)


def logsumexp_last(x):
    """``torch.logsumexp(x, -1)``.  On a DTensor split along the last dim
    (the logits' vocab) as ``max + log(sum(exp(x - max)))``, whose max and
    sum DTensor reduces over the split (all-reduces of one value a row),
    where its ``logsumexp`` would gather the whole dim first."""
    if not is_dtensor(x):
        return torch.logsumexp(x, -1)
    from torch.distributed.tensor import Replicate, Shard
    # the row values: the other dims' splits kept, the reduced one gone
    keep = [Replicate() if p == Shard(x.dim() - 1) else p
            for p in x.placements]
    m = torch.amax(x, -1, keepdim=True).detach().redistribute(
        x.device_mesh, keep)
    s = _Constrain.apply(torch.sum(torch.exp(x - m), -1, keepdim=True),
                         x.device_mesh, tuple(keep))
    return (m + torch.log(s))[..., 0]


def _local_span(x, dim: int) -> tuple:
    """``(offset, size)`` of this rank's part of the DTensor ``x``'s dim
    ``dim`` (``torch.chunk``'s pieces, mesh dims in order, as
    ``params.local_shape`` cuts them)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    off, size = 0, x.shape[dim]
    for m, p in enumerate(x.placements):
        if p == Shard(dim):
            piece = -(-size // mesh.size(m))
            off += coord[m] * piece
            size = max(0, min(piece, size - coord[m] * piece))
    return off, size


def index_copy_(dst, dim: int, index, src):
    """``dst.index_copy_(dim, index, src)`` (a decode step's cache write).
    A DTensor ``dst`` split along ``dim`` (a cache split along its ring)
    is written on each rank at the indices in its part only, from ``src``
    laid out as ``dst`` with ``dim`` whole (DTensor has no strategy for
    an in-place indexed write along a split dim)."""
    if not is_dtensor(dst):
        return dst.index_copy_(dim, index, src)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = [Replicate() if p == Shard(dim) else p for p in dst.placements]
    src = src.redistribute(dst.device_mesh, pl).to_local()
    index = index.to_local() if isinstance(index, DTensor) else index
    off, size = _local_span(dst, dim)
    local = dst.to_local()
    idx = index - off
    ok = (idx >= 0) & (idx < size)
    idx = idx.clamp(0, max(size - 1, 0))
    shape = [1] * local.dim()
    shape[dim] = -1
    old = local.index_select(dim, idx)
    local.index_copy_(dim, idx, torch.where(ok.reshape(shape), src, old))
    return dst


def local_call(fn, args: tuple, dims: tuple, out_dims: tuple):
    """``fn(*args)`` on each rank's shards where the lead argument
    (``args[0]``) is a DTensor, else ``fn(*args)``: the kernels' meta
    paths, and row-wise ops DTensor would otherwise gather (the MoE
    dispatch and combine).

    A kernel sees whole sequences, so each mesh dim may split its inputs
    only along one kind of dim, listed for each argument in ``dims`` as
    ``(batch dim, channel dim[, slot dim])`` (None where it has none; a
    non-tensor argument's entry is None) and for each output in
    ``out_dims``:

    * **batch** where the lead argument is split along its batch dim:
      every input holding a batch dim is split there too (one that holds
      none, as the RG-LRU's ``nsp``, is replicated, its gradient a
      partial sum);
    * else **slot** where an input is split along its slot dim (a decode
      cache split along its ring, flash-decoding's layout): the other
      inputs are replicated and the outputs are partial sums, which
      DTensor reduces when they are next used;
    * else **channel** (heads, state channels) where the lead argument is
      split along its channel dim: an input whose channel dim that mesh
      dim does not divide (flash's KV heads under split query heads, the
      scan's shared C) is replicated, and its gradient is a partial sum;
    * else every input is replicated on that mesh dim (DTensor gathers or
      reduces there: a collective the counter sees)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    lead = args[0]
    if not isinstance(lead, DTensor):
        return fn(*args)
    mesh = lead.device_mesh
    dims = tuple(None if d is None else tuple(d) + (None,) * (3 - len(d))
                 for d in dims)
    out_dims = tuple(tuple(d) + (None,) * (3 - len(d)) for d in out_dims)
    kinds = []
    for m, p in enumerate(lead.placements):
        n = mesh.size(m)
        if isinstance(p, Shard) and p.dim == dims[0][0]:
            kinds.append(0)
        elif any(isinstance(a, DTensor) and d[2] is not None
                 and a.placements[m] == Shard(d[2])
                 for a, d in zip(args, dims) if d is not None):
            kinds.append(2)
        elif (isinstance(p, Shard) and p.dim == dims[0][1]
              and lead.shape[p.dim] % n == 0):
            kinds.append(1)
        else:
            kinds.append(None)

    def split_of(a, d, m: int):
        """The dim of ``a`` (None: an output) that mesh dim ``m`` splits,
        or None."""
        kind = kinds[m]
        if d is None or kind is None or d[kind] is None:
            return None
        if kind == 1 and a is not None and a.shape[d[1]] % mesh.size(m):
            return None
        return d[kind]

    in_pl, grad_pl = [], []
    for a, d in zip(args, dims):
        if not isinstance(a, torch.Tensor):
            in_pl.append(None)
            grad_pl.append(None)
            continue
        pl, gl = [], []
        for m in range(mesh.ndim):
            dim = split_of(a, d, m)
            pl.append(Replicate() if dim is None else Shard(dim))
            gl.append(Partial() if dim is None and kinds[m] is not None
                      else pl[-1])
        in_pl.append(pl)
        grad_pl.append(gl)
    out_pl = []
    for d in out_dims:
        pl = []
        for m in range(mesh.ndim):
            dim = split_of(None, d, m)
            pl.append(Partial() if kinds[m] == 2 else
                      Replicate() if dim is None else Shard(dim))
        out_pl.append(pl)
    args = tuple(DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
                 if isinstance(a, torch.Tensor)
                 and not isinstance(a, DTensor) else a for a in args)
    # placements as lists: local_map reads a tuple as one entry an output
    mapped = local_map(fn, out_placements=tuple(out_pl) if len(out_pl) > 1
                       else out_pl[0], in_placements=tuple(in_pl),
                       in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                       redistribute_inputs=True)
    return mapped(*args)
