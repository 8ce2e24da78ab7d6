"""Atomic, async checkpointing (port of ``repro.checkpoint.manager``),
in ``repro``'s on-disk layout, so either package reads what the other
wrote::

    ckpt_dir/step_00000100.tmp/      # written here first
        manifest.json                # step, leaves (name, key, shape,
                                     # dtype), extra
        shard_00000.npz              # leaf i under key "a<i>"
    ckpt_dir/step_00000100/          # renamed on completion

* **Atomic**: the ``.tmp`` directory is renamed only after the shard
  and the manifest are fsynced, so a crash mid-save never leaves a
  partial step that ``latest_step`` would pick.
* **Async**: ``AsyncCheckpointer.save_async`` copies the tree's device
  tensors to the host first (the only part the caller waits for) and
  writes in a background thread.
* **Names**: a leaf is stored under its key path as
  ``jax.tree_util.keystr`` writes it: ``['params']['embed']`` for a dict
  key, ``[0]`` for a list index, ``.m`` for a NamedTuple field
  (``OptState``).  A tree of dicts of arrays therefore has the same
  names in both packages; the port's layer lists name each layer's
  leaves apart (``['params']['layers'][0]['attn']['wq']``) where
  ``repro`` stacks them.
* **dtypes**: bf16 is stored as its uint16 bits with dtype name
  ``"bfloat16"`` (npz has no bf16), read back through a torch ``view``.

* **Elastic**: leaves are stored whole.  A DTensor leaf is gathered
  with ``full_tensor()`` -- a collective, so every rank of its mesh
  calls ``save`` (or ``save_async``) and the gathers run in leaf order
  on all of them; rank 0 of the process group writes and renames, and a
  barrier follows (in ``AsyncCheckpointer.wait`` for an async save).
  ``restore`` reads the file on every rank and places each leaf whose
  target is a DTensor on the target's mesh with its placements
  (``distribute_tensor``, every rank keeping its own shard), so a
  checkpoint saved under one mesh restores under another -- the smaller
  mesh of the survivors after ``runtime.fault_tolerance.
  elastic_mesh_shape``.

Leaves may be torch tensors, DTensors, numpy arrays or Python scalars;
``restore`` gives torch tensors, each on the device of its target leaf
(the CPU where the target leaf is no tensor), or DTensors where the
target leaf is one.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "AsyncCheckpointer", "latest_step", "restore"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> list:
    """``[(keystr, leaf)]`` in ``jax.tree_util``'s order: dict keys
    sorted, NamedTuple fields and list items in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(
            tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in _flatten(
            getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in _flatten(
            t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree, values: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[keystr]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), values,
                                     f"{prefix}.{f}") for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, values, f"{prefix}[{i}]")
                          for i, t in enumerate(tree))
    return values[prefix]


def _is_dtensor(v) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(v, DTensor)


def _gather(named: list) -> tuple[list, bool]:
    """``named`` with every DTensor leaf gathered whole (in leaf order,
    a collective on its mesh), and whether any leaf was one."""
    out, dist = [], False
    for name, v in named:
        if _is_dtensor(v):
            v, dist = v.full_tensor(), True
        out.append((name, v))
    return out, dist


def _writer() -> bool:
    """Whether this process writes a distributed save: rank 0 of the
    process group."""
    return torch.distributed.get_rank() == 0


def _host(v) -> np.ndarray:
    """A leaf as a host numpy array; bf16 as its uint16 bits (dtype name
    returned beside it by ``_stored``)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(v)


def _stored(v) -> tuple[np.ndarray, str]:
    """``(array to store, dtype name)`` of a leaf."""
    if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
        return _host(v), "bfloat16"
    arr = _host(v)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[dict] = None) -> str:
    """Synchronous save of ``tree`` as step ``step`` with an atomic
    rename; returns the step's directory.  With DTensor leaves every rank
    calls it (module docstring)."""
    named, dist = _gather(_flatten(tree))
    final = _final(ckpt_dir, step)
    if not dist or _writer():
        _write(ckpt_dir, step, named, extra)
    if dist:
        torch.distributed.barrier()
    return final


def _final(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _write(ckpt_dir: str, step: int, named: list,
           extra: Optional[dict]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _final(ckpt_dir, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, v) in enumerate(named):
        arr, dtype_name = _stored(v)
        key = f"a{i}"
        arrays[key] = arr
        manifest["leaves"].append({"name": name, "key": key,
                                   "shape": list(arr.shape),
                                   "dtype": dtype_name})
    with open(os.path.join(tmp, "shard_00000.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training (one save in flight at a
    time).  ``wait`` raises the background save's error, if any, and
    ``TimeoutError`` when the save outlasts ``timeout`` seconds; after a
    save of DTensor leaves every rank calls it, and it ends in a
    barrier."""

    def __init__(self, ckpt_dir: str, timeout: float = 600.0):
        self.ckpt_dir = ckpt_dir
        self.timeout = timeout
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._dist = False

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None):
        self.wait()
        named, self._dist = _gather(_flatten(tree))
        if self._dist and not _writer():
            return
        named = [(name, v.detach().to("cpu", copy=True)
                  if isinstance(v, torch.Tensor) else np.array(v))
                 for name, v in named]

        def work():
            try:
                _write(self.ckpt_dir, step, named, extra)
            except BaseException as e:  # surfaced on the next wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join(timeout=self.timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"checkpoint save still running after "
                                   f"{self.timeout} s")
            self._thread = None
        if self._dist:
            self._dist = False
            torch.distributed.barrier()
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step under ``ckpt_dir`` (``.tmp`` directories
    ignored), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(ckpt_dir: str, target_tree: Any, step: Optional[int] = None):
    """Restore into the structure of ``target_tree`` (its leaves name the
    devices; a DTensor leaf the mesh and placements the stored leaf is
    re-sharded to); returns ``(tree, step, extra)``.  A leaf the
    checkpoint lacks raises ``KeyError``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = _final(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {}
    with np.load(os.path.join(d, "shard_00000.npz")) as data:
        for leaf in manifest["leaves"]:
            by_name[leaf["name"]] = _tensor(data[leaf["key"]],
                                            leaf["dtype"])
    values = {}
    for name, tgt in _flatten(target_tree):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        t = by_name[name]
        if _is_dtensor(tgt):
            from torch.distributed.tensor import distribute_tensor
            mesh = tgt.device_mesh
            t = distribute_tensor(t.to(mesh.device_type), mesh,
                                  tgt.placements, src_data_rank=None)
        elif isinstance(tgt, torch.Tensor):
            t = t.to(tgt.device)
        values[name] = t
    return (_rebuild(target_tree, values), manifest["step"],
            manifest.get("extra", {}))
