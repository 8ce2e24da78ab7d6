"""One process of ``tests/test_torch_sharding.py``'s multi-rank check.

    python tests/_torch_dist_worker.py rank RANK WORKDIR
    python tests/_torch_dist_worker.py jax WORKDIR

``rank``: rank RANK of a 4-rank ``gloo`` group over a ``FileStore`` in
WORKDIR (the test starts four, with ``PYTHONPATH=src``):
1. a 2 x 2 ``("data", "model")`` mesh: reduced tinyllama's parameters and
   AdamW state (seed 0; the moments drawn from seeded generators) placed
   by ``params.shard_params``; each leaf's placements and local shard are
   written out; the tree is saved under the mesh (``checkpoint.save`` and
   ``AsyncCheckpointer``, two steps);
2. a 2 x 2 ``("pod", "data")`` mesh: a ``("batch", "seq")`` tensor placed
   by ``sharding.named_sharding`` and by ``sharding.shard`` from a
   replicated DTensor (the batch over pod x data), and
   ``compress.cross_pod_mean`` over the pod group and over the world;
3. the group is destroyed; ranks 0 and 1 -- the survivors -- start a
   2-rank group and restore the checkpoint under
   ``elastic_mesh_shape(2, 2)``'s ``(1, 2)`` mesh, writing each leaf's
   placements, local shard and ``full_tensor()``.
Each rank writes ``WORKDIR/rank<r>.pt``.

``jax``: reads ``WORKDIR/layouts.json`` (mesh shapes, axis names, tensor
shapes and specs) and writes each device's index slices under JAX's
``NamedSharding`` to ``WORKDIR/jax_layouts.json``; run with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``.
"""

import datetime
import json
import sys
from pathlib import Path

TIMEOUT = datetime.timedelta(seconds=90)
WORLD = 4


def model_state():
    """Reduced tinyllama's parameters and AdamW state, the same on every
    rank, and its ParamDef tree."""
    import torch
    from repro_torch.configs import get
    from repro_torch.models import zoo
    from repro_torch.optim import adamw
    cfg = get("tinyllama-1.1b").reduced()
    model = zoo.init_model(cfg, seed=0, device="cpu")
    opt = adamw.init(model.tree())
    gen = torch.Generator().manual_seed(7)
    draw = lambda p: torch.randn(p.shape, generator=gen)
    opt = opt._replace(step=torch.tensor(3, dtype=torch.int32),
                       m=adamw.tree_map(draw, opt.m),
                       v=adamw.tree_map(lambda p: draw(p).abs(), opt.v))
    return model.tree(), opt, zoo.model_defs(cfg)


def sharded_state(params, opt, defs, mesh):
    from repro_torch.models.params import shard_params
    return {"params": shard_params(params, defs, mesh),
            "opt": opt._replace(m=shard_params(opt.m, defs, mesh),
                                v=shard_params(opt.v, defs, mesh),
                                master=shard_params(opt.master, defs,
                                                    mesh))}


def leaf_record(tree, full: bool = False) -> dict:
    from repro_torch.checkpoint.manager import _flatten
    out = {}
    for name, v in _flatten(tree):
        if hasattr(v, "placements"):
            out[name] = {"placements": [repr(p) for p in v.placements],
                         "local": v.to_local().clone()}
            if full:
                out[name]["full"] = v.full_tensor()
        else:
            out[name] = {"placements": None, "local": v}
    return out


def cross_pod_inputs(n: int, seed: int, dtype):
    """``n`` parts' gradients and residuals from a seed (numpy)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(size=(n, 5, 33)).astype(np.float32))
    err = torch.from_numpy((rng.normal(size=(n, 5, 33)) * 1e-3)
                           .astype(np.float32))
    return g.to(dtype), err


def run_rank(rank: int, work: Path) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch import sharding as shd
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.optim import compress
    from repro_torch.runtime.fault_tolerance import elastic_mesh_shape
    torch.set_num_threads(1)
    rec = {}
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / "store4"), WORLD),
        rank=rank, world_size=WORLD, timeout=TIMEOUT)
    params, opt, defs = model_state()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rec["coord"] = mesh.get_coordinate()
    state = sharded_state(params, opt, defs, mesh)
    rec["sharded"] = leaf_record(state)
    ckpt.save(str(work / "ckpt"), 7, state, extra={"data_step": 7})
    saver = ckpt.AsyncCheckpointer(str(work / "ckpt"))
    saver.save_async(8, state, extra={"data_step": 8})
    saver.wait()

    pmesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    rec["pod_coord"] = pmesh.get_coordinate()
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    ns = shd.named_sharding(("batch", "seq"), (8, 6), pmesh)
    placed = distribute_tensor(x, pmesh, ns.placements, src_data_rank=None)
    shd.set_mesh(pmesh)
    moved = shd.shard(distribute_tensor(x, pmesh, [Replicate()] * 2,
                                        src_data_rank=None), "batch", "seq")
    shd.set_mesh(None)
    rec["batch"] = {"placements": [repr(p) for p in placed.placements],
                    "local": placed.to_local().clone(),
                    "shard_placements": [repr(p) for p in moved.placements],
                    "shard_local": moved.to_local().clone()}
    pod, d = rec["pod_coord"]
    cross = {}
    for key, group, n, part, seed, dtype in (
            ("pod", pmesh.get_group("pod"), 2, pod, 10 + d, torch.float32),
            ("world", None, WORLD, rank, 20, torch.float32),
            ("world_bf16", None, WORLD, rank, 30, torch.bfloat16)):
        g, err = cross_pod_inputs(n, seed, dtype)
        cross[key] = compress.cross_pod_mean(g[part], err[part], group)
    rec["cross"] = cross
    dist.destroy_process_group()

    if rank < 2:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(work / "store2"), 2),
            rank=rank, world_size=2, timeout=TIMEOUT)
        shape = elastic_mesh_shape(2, 2)
        small = init_device_mesh("cpu", shape,
                                 mesh_dim_names=("data", "model"))
        rec["small_shape"] = shape
        rec["small_coord"] = small.get_coordinate()
        from repro_torch.optim import adamw
        blank = lambda t: adamw.tree_map(torch.zeros_like, t)
        target = sharded_state(
            blank(params), opt._replace(step=torch.zeros_like(opt.step),
                                        m=blank(opt.m), v=blank(opt.v),
                                        master=blank(opt.master)),
            defs, small)
        for step in (7, 8):
            restored, got_step, extra = ckpt.restore(str(work / "ckpt"),
                                                     target, step)
            rec[f"restored_{step}"] = {
                "step": got_step, "extra": extra,
                "leaves": leaf_record(restored, full=True)}
        dist.destroy_process_group()
    torch.save(rec, work / f"rank{rank}.pt")


def run_jax(work: Path) -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    queries = json.loads((work / "layouts.json").read_text())
    devs = jax.devices()
    out = []
    for q in queries:
        n = int(np.prod(q["mesh"]))
        mesh = Mesh(np.asarray(devs[:n]).reshape(q["mesh"]), tuple(q["axes"]))
        spec = P(*(tuple(e) if isinstance(e, list) else e
                   for e in q["spec"]))
        idx = NamedSharding(mesh, spec).devices_indices_map(
            tuple(q["shape"]))
        out.append({str(dv.id): [[s.start, s.stop] for s in sl]
                    for dv, sl in idx.items()})
    (work / "jax_layouts.json").write_text(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        run_rank(int(sys.argv[2]), Path(sys.argv[3]))
    else:
        run_jax(Path(sys.argv[2]))
