"""The port's sharding substrate against ``repro``'s, on the same inputs:

* ``sharding.spec_for`` equals ``repro.sharding.spec_for`` (as a plain
  tuple) for every leaf of all ten configs' ``model_defs`` on meshes
  ``{data 16, model 16}``, ``{pod 2, data 16, model 16}``, ``{data 31,
  model 16}``, ``{data 28, model 16}`` and ``{data 1}``, and the port's
  per-layer ``params.param_specs`` equal ``repro``'s stacked ones less
  their ``layers`` entry; plus ``tests/test_substrate.py``'s four cases;
* ``launch.mesh.make_production_mesh`` (256 and 512 ranks) and
  ``make_host_mesh`` on the ``fake`` backend, and ``steps.dp_degree`` /
  ``microbatches_for`` reading the active mesh;
* one 4-rank ``gloo`` group (``tests/_torch_dist_worker.py``, four
  processes over a ``FileStore`` under ``tmp_path``, each with a 90 s
  collective timeout and the whole run a 240 s limit), whose checks are
  each a test below: the placements (no strided shard) and local shards
  on a 2 x 2 mesh against JAX's ``NamedSharding`` layout (a JAX process
  with four host devices); an elastic save under 2 x 2 (``save`` and
  ``AsyncCheckpointer``) restored by the two survivors under
  ``elastic_mesh_shape(2, 2)`` = ``(1, 2)``, every shard and
  ``full_tensor()`` bitwise; the batch over ``("pod", "data")``;
  ``compress.cross_pod_mean`` against ``repro``'s under ``jax.vmap``;
* ``simulator._shard_grid`` over three CPU "devices": ``sweep`` and
  ``sweep_traces`` equal the unsharded port and ``repro`` bitwise,
  ``sweep_synth`` the unsharded port (its streams may differ from
  ``repro``'s by a float draw: ``tests/test_torch_synth.py``).
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import sharding as j_shd  # noqa: E402
from repro.configs import get as j_get  # noqa: E402
from repro.core import simulator as j_sim  # noqa: E402
from repro.core import traces as j_traces  # noqa: E402
from repro.models import params as j_params  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro.optim import compress as j_compress  # noqa: E402

from repro_torch import sharding as t_shd  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models import params as t_params  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.runtime.fault_tolerance import elastic_mesh_shape  # noqa: E402,E501

import _torch_dist_worker as worker  # noqa: E402
from _parity import assert_cell_matches  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = list(t_steps.TRAIN_PER_DEVICE_MICROBATCH)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "31x16": {"data": 31, "model": 16},
          "28x16": {"data": 28, "model": 16},
          "data1": {"data": 1}}
STACKED = re.compile(r"^\['(layers|enc_layers|dec_layers)'\]\[\d+\]")


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _repro_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _at(tree, path: str):
    """The node of ``tree`` at a ``leaf_paths`` path."""
    for quote, key in re.findall(r"\[('?)([^\]']+)\1\]", path):
        tree = tree[key if quote else int(key)]
    return tree


@pytest.mark.parametrize("name", CONFIGS)
def test_spec_for_matches_repro(name):
    jdefs = j_zoo.model_defs(j_get(name))
    tdefs = t_zoo.model_defs(t_get(name))
    jleaves = jax.tree_util.tree_leaves(
        jdefs, is_leaf=lambda x: isinstance(x, j_params.ParamDef))
    for shape in MESHES.values():
        mesh = FakeMesh(shape)
        for d in jleaves:
            assert t_shd.spec_for(d.axes, d.shape, mesh) == tuple(
                j_shd.spec_for(d.axes, d.shape, mesh)), (d, shape)
        want = _repro_specs(j_params.param_specs(jdefs, mesh))
        specs = t_params.param_specs(tdefs, mesh)
        paths = [path for path, _ in t_params.leaf_paths(tdefs)]
        assert len(paths) >= len(want)
        for path in paths:
            spec = _at(specs, path)
            if STACKED.match(path):
                assert spec == want[STACKED.sub(r"['\1']", path)][1:], path
            else:
                assert spec == want[path], path


def test_spec_for_substrate_cases():
    """``tests/test_substrate.py::test_sharding_rules_divisibility``'s four
    cases, through both packages."""
    m2 = FakeMesh({"model": 4, "data": 2})
    m3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
    rules = dict(t_shd.DEFAULT_RULES)
    assert rules == dict(j_shd.DEFAULT_RULES)
    cases = [(("vocab", "embed"), (51865, 768), m2, (None, "data")),
             (("vocab", "embed"), (51968, 768), m2, ("model", "data")),
             (("batch", "seq"), (256, 4096), m3, (("pod", "data"),)),
             (("batch", "seq"), (8, 4096), m3, ("pod",))]
    for axes, shape, mesh, want in cases:
        got = t_shd.spec_for(axes, shape, mesh, rules)
        assert got == want == tuple(j_shd.spec_for(axes, shape, mesh,
                                                   rules))
    assert t_shd.spec_for(("batch",), (8,)) == ()
    assert t_shd.named_sharding(("batch",), (8,)) is None


@pytest.mark.parametrize("multi_pod", [False, True])
def test_meshes_on_the_fake_backend(multi_pod):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        mesh = t_mesh.make_production_mesh(multi_pod=multi_pod,
                                           device_type="cpu")
        names = ("pod", "data", "model") if multi_pod else ("data",
                                                            "model")
        assert mesh.mesh_dim_names == names
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        host = t_mesh.make_host_mesh("cpu")
        assert host.mesh_dim_names == ("data",) and tuple(host.shape) == (n,)
        # a DeviceMesh resolves like the mapping of its axis sizes
        fake = FakeMesh(dict(zip(names, mesh.shape)))
        defs = t_zoo.model_defs(t_get("phi4-mini-3.8b"))
        assert t_params.param_specs(defs, mesh) == t_params.param_specs(
            defs, fake)
        ns = t_shd.named_sharding(("batch", "seq"), (256, 4096), mesh)
        from torch.distributed.tensor import Replicate, Shard
        assert ns.placements == ((Shard(0), Shard(0), Replicate())
                                 if multi_pod else (Shard(0), Replicate()))
        cfg = t_get("tinyllama-1.1b")
        shape = ShapeConfig("train", 4096, 256, "train")
        assert t_steps.dp_degree() == 1
        t_shd.set_mesh(mesh)
        try:
            dp = 32 if multi_pod else 16
            assert t_steps.dp_degree() == dp == t_steps.dp_degree(fake)
            assert t_steps.microbatches_for(cfg, shape) == \
                t_steps.microbatches_for(cfg, shape, fake) == 256 // (dp * 8)
        finally:
            t_shd.set_mesh(None)
        with pytest.raises(ValueError):
            t_mesh.make_production_mesh(multi_pod=not multi_pod,
                                        device_type="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- 4 gloo ranks

def _layout_queries() -> list:
    """(mesh, axes, shape, spec) of every leaf the ranks place: the 2 x 2
    and (1, 2) meshes' parameter leaves, then the batch on pod x data."""
    defs = t_zoo.model_defs(t_get("tinyllama-1.1b").reduced())
    out = []
    for mesh in ((2, 2), elastic_mesh_shape(2, 2)):
        fake = FakeMesh(dict(zip(("data", "model"), mesh)))
        for path, d in t_params.leaf_paths(defs):
            out.append({"mesh": list(mesh), "axes": ["data", "model"],
                        "path": path, "shape": list(d.shape),
                        "spec": t_shd.spec_for(d.axes, d.shape, fake)})
    out.append({"mesh": [2, 2], "axes": ["pod", "data"], "path": "batch",
                "shape": [8, 6],
                "spec": t_shd.spec_for(("batch", "seq"), (8, 6),
                                       FakeMesh({"pod": 2, "data": 2}))})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("gloo")
    queries = _layout_queries()
    (work / "layouts.json").write_text(json.dumps(queries))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    script = str(ROOT / "tests" / "_torch_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, script, "rank", str(r),
                               str(work)], env=env)
             for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, script, "jax", str(work)],
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}))
    deadline = time.monotonic() + 240
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 5
    recs = [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    layouts = json.loads((work / "jax_layouts.json").read_text())
    return work, recs, queries, layouts


def _jax_slice(layout: dict, device: int, shape) -> tuple:
    return tuple(slice(0 if a is None else a, n if b is None else b)
                 for (a, b), n in zip(layout[str(device)], shape))


def _state() -> dict:
    """The ranks' whole tree (``_torch_dist_worker.model_state``)."""
    params, opt, _ = worker.model_state()
    return {"params": params, "opt": opt}


def _full_state() -> dict:
    from repro_torch.checkpoint.manager import _flatten
    return dict(_flatten(_state()))


def _leaf_layouts(queries, layouts, mesh) -> dict:
    """``{leaf path: JAX layout}`` of the parameter leaves on ``mesh``."""
    return {q["path"]: lay for q, lay in zip(queries, layouts)
            if q["mesh"] == list(mesh) and q["axes"] == ["data", "model"]}


def _check_shards(leaves: dict, rank: int, full: dict, lay: dict) -> int:
    """Every DTensor leaf's local shard of ``rank`` is the JAX slice of
    the device of the same index in the mesh; returns how many leaves
    were split."""
    n_sharded = 0
    for name, rec in leaves.items():
        if rec["placements"] is None:
            assert torch.equal(rec["local"], full[name]), name
            continue
        assert not any("Strided" in p for p in rec["placements"]), name
        path = re.sub(r"^\['params'\]|^\['opt'\]\.(master|m|v)", "", name)
        want = full[name][_jax_slice(lay[path], rank,
                                     full[name].shape)]
        n_sharded += want.numel() < full[name].numel()
        assert rec["local"].dtype == full[name].dtype, name
        assert torch.equal(rec["local"], want), name
    return n_sharded


def test_placements_and_local_shards_follow_jax(ranks):
    _, recs, queries, layouts = ranks
    full = _full_state()
    lay = _leaf_layouts(queries, layouts, (2, 2))
    for r, rec in enumerate(recs):
        assert list(rec["coord"]) == [r // 2, r % 2]
        assert _check_shards(rec["sharded"], r, full, lay) > 0


def test_elastic_save_restores_under_the_survivors_mesh(ranks):
    work, recs, queries, layouts = ranks
    from repro_torch.checkpoint import manager as ckpt
    full = _full_state()
    assert ckpt.latest_step(str(work / "ckpt")) == 8
    lay = _leaf_layouts(queries, layouts, (1, 2))
    for step in (7, 8):
        for r in (0, 1):
            rec = recs[r]
            assert rec["small_shape"] == (1, 2)
            assert list(rec["small_coord"]) == [0, r]
            res = rec[f"restored_{step}"]
            assert res["step"] == step and res["extra"] == {
                "data_step": step}
            assert _check_shards(res["leaves"], r, full, lay) > 0
            for name, leaf in res["leaves"].items():
                if "full" in leaf:
                    assert torch.equal(leaf["full"], full[name]), name
        # what was written is the whole tree (one writer, every rank
        # gathered), and reads back without a mesh
        plain, got_step, _ = ckpt.restore(str(work / "ckpt"), _state(),
                                          step)
        assert got_step == step
        for name, v in ckpt._flatten(plain):
            assert torch.equal(v, full[name]), name


def test_batch_over_pod_and_data_is_pod_major(ranks):
    _, recs, queries, layouts = ranks
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    lay = layouts[-1]
    assert queries[-1]["spec"] == (("pod", "data"),)
    for r, rec in enumerate(recs):
        b = rec["batch"]
        assert b["placements"] == b["shard_placements"] == [
            "Shard(dim=0)", "Shard(dim=0)"]
        want = x[_jax_slice(lay, r, x.shape)]
        assert torch.equal(want, x[2 * r:2 * r + 2])
        assert torch.equal(b["local"], want)
        assert torch.equal(b["shard_local"], want)


@pytest.mark.parametrize("key", ["pod", "world", "world_bf16"])
def test_cross_pod_mean_matches_repro_under_vmap(ranks, key):
    """``new_err`` bitwise; the mean within ``P 2^-24 sum |terms|`` an
    element (the limit of two f32 sums of P terms in different orders,
    plus the bf16 rounding of a bf16 mean), set here before the
    comparison, and bitwise, since both add the parts in rank order."""
    _, recs, _, _ = ranks
    groups = ({d: [r for r in range(4) if recs[r]["pod_coord"][1] == d]
               for d in (0, 1)} if key == "pod" else {0: list(range(4))})
    for d, members in groups.items():
        seed = (10 + d) if key == "pod" else (20 if key == "world" else 30)
        dtype = torch.bfloat16 if key == "world_bf16" else torch.float32
        g, err = worker.cross_pod_inputs(len(members), seed, dtype)
        jg = jnp.asarray(g.float().numpy()).astype(
            jnp.bfloat16 if key == "world_bf16" else jnp.float32)
        mean, new_err = jax.vmap(
            lambda a, e: j_compress.cross_pod_mean(a, e, "pod"),
            axis_name="pod")(jg, jnp.asarray(err.numpy()))
        q_scale = [j_compress.quantize(jg[i], jnp.asarray(err[i].numpy()))
                   for i in range(len(members))]
        terms = np.stack([np.asarray(j_compress.dequantize(q, s))
                          for q, s, _ in q_scale])
        limit = len(members) * 2.0 ** -24 * np.abs(terms).sum(0)
        if key == "world_bf16":   # the mean's one rounding to bf16
            limit = limit + 2.0 ** -8 * np.abs(terms.mean(0))
        for i, r in enumerate(members):
            got_mean, got_err = recs[r]["cross"][key]
            assert got_mean.dtype == dtype
            np.testing.assert_array_equal(got_err.numpy(),
                                          np.asarray(new_err[i]))
            diff = np.abs(got_mean.float().numpy()
                          - np.asarray(mean[i], np.float32))
            assert (diff <= limit).all(), (key, float(diff.max()))
            # the port adds the parts in rank order, as XLA's mean does on
            # the CPU: bitwise
            np.testing.assert_array_equal(got_mean.float().numpy(),
                                          np.asarray(mean[i], np.float32))


# ------------------------------------------------------------ _shard_grid

def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]), k


def _grids(kinds=("base", "chargecache", "lldram", "nuat", "cc_nuat")):
    return ([j_sim.SimConfig(mech=j_sim.MechanismConfig(kind=k))
             for k in kinds],
            [t_sim.SimConfig(mech=t_sim.MechanismConfig(kind=k))
             for k in kinds])


def test_shard_grid_over_three_cpu_devices(monkeypatch):
    jgrid, tgrid = _grids()
    jb = j_traces.single_core_batch("milc_like", 200, seed=5)
    tb = t_traces.single_core_batch("milc_like", 200, seed=5)
    jbs = [j_traces.single_core_batch("mcf_like", 120, seed=s)
           for s in (1, 2)]
    tbs = [t_traces.single_core_batch("mcf_like", 120, seed=s)
           for s in (1, 2)]
    synth = [t_sim.SimConfig(mech=t_sim.MechanismConfig(kind=k),
                             workload=t_traces.WorkloadSpec(
                                 names=("mcf_like", "milc_like"), n_req=100,
                                 seed=4))
             for k in ("base", "chargecache", "lldram", "nuat")]
    plain = (t_sim.sweep(tb, tgrid, device="cpu"),
             t_sim.sweep_traces(tbs, tgrid, rltl=True, device="cpu"),
             t_sim.sweep_synth(synth, device="cpu"))
    from repro_torch.kernels.sim_step import ops
    calls = []
    scan, synth_run = t_sim._run_scan, ops.run_synth
    monkeypatch.setattr(t_sim, "_grid_devices",
                        lambda device: [torch.device("cpu")] * 3)
    monkeypatch.setattr(t_sim, "_run_scan", lambda *a: calls.append(
        a[3].closed_policy.shape[0]) or scan(*a))
    monkeypatch.setattr(ops, "run_synth", lambda *a, **k: calls.append(
        a[1].closed_policy.shape[0]) or synth_run(*a, **k))
    sharded = (t_sim.sweep(tb, tgrid, device="cpu"),
               t_sim.sweep_traces(tbs, tgrid, rltl=True, device="cpu"),
               t_sim.sweep_synth(synth, device="cpu"))
    # 5 points pad to 6: 2 a device; the traces' 2 x 5 to 12: 4 a device;
    # the synthetic 4 to 6: 2 a device
    assert calls == [2, 2, 2, 4, 4, 4, 2, 2, 2]
    want = (j_sim.sweep(jb, jgrid), j_sim.sweep_traces(jbs, jgrid,
                                                       rltl=True))
    for a, b, j in zip(plain[0], sharded[0], want[0]):
        _same(a, b)
        assert_cell_matches(j, b, rltl=True)
    for ra, rb, rj in zip(plain[1], sharded[1], want[1]):
        for a, b, j in zip(ra, rb, rj):
            _same(a, b)
            assert_cell_matches(j, b, rltl=True)
    for a, b in zip(plain[2], sharded[2]):
        _same(a, b)
