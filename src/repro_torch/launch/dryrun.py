"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell: build the abstract
model, optimizer state, batch and cache with their production layouts
(DTensors over meta shards on a 16 x 16 or 2 x 16 x 16 ``DeviceMesh`` of
a ``fake`` process group: one process stands for every rank), run the
full step once under the op counter (``analysis.opcount``), and record
per-device memory and the roofline terms against the H100's data-sheet
constants (``analysis.roofline``).  Nothing is launched and no full-size
tensor is allocated: meta tensors hold shapes only, and each kernel's
meta path adds the kernel's own work.  The figures are counted, not
measured.

``repro`` lowers and compiles the step for 512 fake XLA devices and reads
the post-SPMD HLO; here DTensor's sharding propagation plays SPMD's part,
and the models' ``sharding.shard`` constraints sit where ``repro``'s do.
The record keeps ``repro``'s keys, with these changes:

* ``compile_s`` -> ``trace_s`` (the eager run on meta tensors; no
  ``lower_s``);
* ``fits_16gb`` -> ``fits_80gb``: under ``roofline.HBM_BYTES``;
* ``xla_cost_flops`` and ``cpu_dus_artifact_gb`` (XLA-only) are dropped,
  so ``hbm_gb_corrected`` equals ``hbm_gb_per_device``;
* ``hbm_gb_per_device`` = ``arg_gb`` (the local bytes of parameters,
  optimizer state -- m, v and the f32 master --, batch and cache) +
  ``temp_gb`` (the peak of the storages the step makes while it runs,
  its outputs included: the train step's new optimizer state lives
  beside the old one until the step returns, as on the card);
* ``kernels``: each kernel's calls, FLOPs and bytes a device (new).

A cell that raises records ``status: "error"`` with the traceback's tail.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
        tinyllama-1.1b --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import resource
import time
import traceback

import torch

from repro_torch import sharding as shd
from repro_torch.analysis import opcount
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ALIASES, get
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import zoo
from repro_torch.models.config import SHAPES
from repro_torch.optim import adamw

__all__ = ["cell_skip_reason", "abstract_opt_state", "fake_group",
           "analyze_step", "run_cell", "peak_rss_gib", "main"]


#: long_500k needs a sub-quadratic decode path (DESIGN.md §5).
def cell_skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: a 524288-token dense KV cache is "
                "architecturally undefined (DESIGN.md §5)")
    return None


def _f32_like(p):
    """An f32 tensor of ``p``'s shape and layout, on meta shards."""
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    local = torch.empty(p.to_local().shape, dtype=torch.float32,
                        device="meta")
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def abstract_opt_state(params) -> adamw.OptState:
    """AdamW's state for the tree ``params``: m, v and the f32 master copy
    shard exactly like their parameters (meta shards)."""
    from repro_torch.models.params import abstract_tensor
    return adamw.OptState(step=abstract_tensor((), torch.int32, ()),
                          m=adamw.tree_map(_f32_like, params),
                          v=adamw.tree_map(_f32_like, params),
                          master=adamw.tree_map(_f32_like, params))


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks in this process
    (this process is rank 0; collectives move nothing), destroyed on
    exit; reuses a group already initialised."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    flat = torch.utils._pytree.tree_flatten(tree)[0]
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in flat if isinstance(t, torch.Tensor))


def analyze_step(cfg, shape, microbatches: int | None = None) -> tuple:
    """Run one step of ``cfg`` at ``shape`` (train, prefill or a decode
    step) on the abstract model, optimizer state, batch and cache under
    the op counter, on the active mesh's layouts (plain meta tensors
    without one) -> ``(opcount.analyze's counts, the local bytes of the
    step's arguments, the microbatches of a train step or 1)``."""
    from torch.distributed.tensor.experimental import implicit_replication
    model = zoo.abstract_model(cfg)
    batch = zoo.batch_specs(cfg, shape)
    mb = 1
    if shape.kind == "train":
        mb = microbatches or steps_lib.microbatches_for(cfg, shape)
        step = steps_lib.make_train_step(
            cfg, adamw.AdamWConfig(), microbatches=mb,
            grad_accum_dtype=steps_lib.accum_dtype_for(cfg))
        args = (model, abstract_opt_state(model.tree()), batch)
        held = (model.tree(), args[1], batch)
    elif shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, shape.seq_len)
        args, held = (model, batch), (model.tree(), batch)
    else:   # decode: one new token against a seq_len cache
        step = steps_lib.make_serve_step(cfg)
        cache = zoo.cache_specs(cfg, shape)
        args = (model, cache, batch["tokens"])
        held = (model.tree(), cache, batch)
    # plain tensors the step makes (positions, masks) join the DTensors
    # as replicated
    with implicit_replication():
        _, per_dev = opcount.analyze(step, *args, ignore=held)
    return per_dev, _local_bytes(held), mb


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules: dict | None = None, microbatches: int | None = None,
             cfg=None) -> dict:
    """One cell's record (module docstring).  ``cfg`` replaces
    ``get(arch)`` (a reduced config, in the tests)."""
    cfg = get(arch) if cfg is None else cfg
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    skip = cell_skip_reason(cfg, shape)
    if skip:
        rec.update(status="skip", reason=skip)
        return rec
    n_dev = 512 if multi_pod else 256
    try:
        with fake_group(n_dev):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            shd.set_mesh(mesh, rules)
            try:
                t0 = time.time()
                per_dev, arg_b, mb = analyze_step(cfg, shape, microbatches)
                trace_s = time.time() - t0
            finally:
                shd.set_mesh(None)
        if shape.kind == "train":
            rec["microbatches"] = mb
        temp_b = per_dev["peak_temp_bytes"]
        hbm_b = arg_b + temp_b
        mf = rl.model_flops(cfg, shape, n_dev)
        roof = rl.roofline(per_dev, mf)
        rec.update(
            status="ok", trace_s=round(trace_s, 1),
            hbm_gb_per_device=round(hbm_b / 2**30, 3),
            arg_gb=round(arg_b / 2**30, 3), temp_gb=round(temp_b / 2**30, 3),
            hbm_gb_corrected=round(hbm_b / 2**30, 3),
            fits_80gb=bool(hbm_b < rl.HBM_BYTES),
            hlo_flops_per_dev=roof.flops, hlo_bytes_per_dev=roof.bytes,
            hlo_bytes_max_per_dev=per_dev["bytes"],
            coll_bytes_per_dev=roof.coll_bytes,
            coll_by_kind={k: float(v) for k, v in
                          per_dev["collective_bytes"].items()},
            compute_s=roof.compute_s, memory_s=roof.memory_s,
            collective_s=roof.collective_s, bound=roof.bound,
            model_flops_per_dev=mf, useful_frac=round(roof.useful_frac, 4),
            kernels=per_dev["kernels"])
    except Exception as e:  # a failure here is a sharding gap in the port
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def peak_rss_gib() -> float:
    """This process's peak resident set, GiB (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id (e.g. tinyllama-1.1b) or module name")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = []
    archs = list(ALIASES) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                print(f"=== {arch} x {shape} x "
                      f"{'2x16x16' if mp else '16x16'} ===", flush=True)
                rec = run_cell(arch, shape, mp)
                show = {k: v for k, v in rec.items() if k != "traceback"}
                print(json.dumps(show, indent=1), flush=True)
                cells.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
        print(f"wrote {args.out}")
    n_err = sum(1 for c in cells if c["status"] == "error")
    print(f"cells: {len(cells)}  ok: "
          f"{sum(1 for c in cells if c['status'] == 'ok')}  "
          f"skip: {sum(1 for c in cells if c['status'] == 'skip')}  "
          f"error: {n_err}  peak RSS {peak_rss_gib():.2f} GiB")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
