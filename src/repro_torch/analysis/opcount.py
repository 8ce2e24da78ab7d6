"""Per-device op counter (the port's counterpart of
``repro.analysis.hlo``).

``repro`` compiles a step and re-derives the roofline inputs from the
post-SPMD HLO text.  The port runs eagerly and has no HLO: it runs the
step once on meta tensors (no memory, no launch) under ``OpCounter``, a
``TorchDispatchMode`` that sees every ATen op with the shapes each rank
holds, and counts by ``hlo``'s rules:

* **FLOPs** -- 2 * |out| * contraction for every product (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``: ``matmul``, ``linear`` and ``einsum``
  reach the dispatcher as these).  Element-wise FLOPs are ignored, as in
  ``repro``.
* **bytes_min** -- operand and output bytes of the products (the floor
  under perfect element-wise fusion); **bytes** -- that plus the output
  writes and reads of data-movement ops (copies, casts, concatenation,
  gathers, scatters, padding; an in-place update counts its update, as
  ``hlo`` counts a dynamic-update-slice).
* **collective bytes** -- operand bytes of each ``c10d_functional``
  collective, by kind (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``broadcast``).
* **kernels** -- the port's kernels are never decomposed into their
  plain versions' ops: on meta tensors each dispatch adds its kernel's
  work (``roofline.*_work``, counted as the kernel does it: valid
  (query, key) pairs for flash) through ``add_kernel``; it goes into
  ``flops`` and into both byte counts.

Per device.  Under a ``DeviceMesh`` the step's tensors are DTensors over
meta shards.  A dispatch mode sees a DTensor op with its *global* shapes
(counting there and dividing is wrong wherever work is replicated), so
the counter declines DTensor ops (``NotImplemented``): DTensor then runs
its sharding propagation, its redistributions (the collectives) and the
local op on each shard, and the counter sees those, with local shapes.
A kernel's meta path runs on local shards too (``sharding.local_call``).
The ops DTensor runs on fake global tensors to learn an output's shape
are not counted.  On a ``cpu`` mesh DTensor moves a shard from one dim
to another by an all-gather and a local slice where NCCL would run an
all-to-all: such a move counts (its operand bytes) under
``all-gather``.

Memory.  The counter also tracks the bytes of live storages that ops
create during the run (a storage counts from the op that makes it until
its last tensor dies, autograd's saved tensors included) and keeps their
peak: the step's temporaries, whatever its arguments hold already
(``ignore``).  DTensor's own redistribution buffers, made and freed
inside one op, are not seen.

Loops need no trip counts: the step runs as Python, every iteration
counted once it happens.
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpCounter", "analyze", "add_kernel"]

_aten = torch.ops.aten
#: products: op -> index of (lhs, rhs) in its arguments
_PRODUCTS = {_aten.mm: (0, 1), _aten.addmm: (1, 2), _aten.bmm: (0, 1),
             _aten.baddbmm: (1, 2)}
#: data-movement ops whose output is written (and read back) once
_MOVES = {_aten.clone, _aten._to_copy, _aten.cat, _aten.gather,
          _aten.scatter, _aten.scatter_add, _aten.index, _aten.index_select,
          _aten.embedding, _aten.embedding_dense_backward,
          _aten.constant_pad_nd, _aten.slice_scatter, _aten.select_scatter,
          _aten.repeat, _aten.index_put, _aten.index_copy, _aten.roll,
          _aten.flip, _aten.sort, _aten.topk, _aten.cumsum, _aten.one_hot,
          _aten.masked_scatter}
#: in-place updates: op -> index of the update's argument
_UPDATES = {_aten.copy_: 1, _aten.index_put_: 2, _aten.index_copy_: 3,
            _aten.scatter_: 3, _aten.scatter_add_: 3}


def _collectives() -> dict:
    ns = torch.ops._c10d_functional
    kinds = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
             "all_reduce_coalesced": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_coalesced": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter",
             "all_to_all_single": "all-to-all", "broadcast": "broadcast"}
    return {getattr(ns, n): k for n, k in kinds.items() if hasattr(ns, n)}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


#: the counters in use, innermost last
_ACTIVE: list = []


def add_kernel(name: str, ops: float, nbytes: float) -> None:
    """Add one call of kernel ``name`` doing ``ops`` operations over
    ``nbytes`` bytes to the innermost counter in use (nothing without
    one)."""
    if _ACTIVE:
        _ACTIVE[-1].add_kernel(name, ops, nbytes)


class OpCounter(TorchDispatchMode):
    """Counts what the ops it sees do, per device (module docstring).
    ``ignore``: tensors whose storages exist before the run (parameters,
    optimizer state, batch, cache), never counted as temporaries."""

    def __init__(self, ignore=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_min = 0.0
        self.coll = defaultdict(float)
        self.kernels: dict = {}
        self.live = 0
        self.peak = 0
        self._coll_kinds = _collectives()
        self._seen = weakref.WeakSet()
        for t in tree_flatten(ignore)[0]:
            if isinstance(t, torch.Tensor):
                st = _storage(t.to_local() if _is_dtensor(t) else t)
                if st is not None:
                    self._seen.add(st)

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def add_kernel(self, name: str, ops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += ops
        k["bytes"] += nbytes
        self.flops += ops
        self.bytes += nbytes
        self.bytes_min += nbytes

    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or _is_dtensor(t):
                continue
            st = _storage(t)
            if st is None or st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            # let DTensor redistribute and run the local op: this mode
            # then sees that op on the shards
            return NotImplemented
        if any(_is_fake_type(t) for t in types) or _fake_mode_on():
            # DTensor's sharding propagation runs the op on fake global
            # tensors for its output's shape: no work of the step
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        pk = func.overloadpacket
        if pk in _PRODUCTS:
            i, j = _PRODUCTS[pk]
            a, b = args[i], args[j]
            self.flops += 2.0 * out.numel() * a.shape[-1]
            nb = _nbytes((a, b, out))
            self.bytes += nb
            self.bytes_min += nb
        elif pk in self._coll_kinds:
            self.coll[self._coll_kinds[pk]] += _nbytes(args[0])
        elif pk in _UPDATES:
            i = _UPDATES[pk]
            self.bytes += 2 * _nbytes(args[i] if len(args) > i else out)
        elif pk in _MOVES:
            self.bytes += 2 * _nbytes(out)
        self._track(out)
        return out

    def result(self) -> dict:
        """``hlo.analyze``'s keys (``flops``, ``bytes``, ``bytes_min``,
        ``collective_bytes`` by kind, ``collective_total``), and
        ``kernels`` (calls, flops and bytes of each) and
        ``peak_temp_bytes``."""
        coll = dict(self.coll)
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_min": self.bytes_min, "collective_bytes": coll,
                "collective_total": float(sum(coll.values())),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_temp_bytes": self.peak}


def analyze(fn, *args, ignore=(), **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` under a fresh ``OpCounter`` ->
    ``(its result, OpCounter.result())``; ``args`` and ``ignore`` are
    not temporaries."""
    with OpCounter(ignore=(args, kwargs, ignore)) as c:
        out = fn(*args, **kwargs)
    return out, c.result()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, type) and issubclass(t, DTensor)


def _fake_mode_on() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _is_fake_type(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, type) and issubclass(t, FakeTensor)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)
