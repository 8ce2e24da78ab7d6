"""The dry run's substrate (``repro_torch.launch.dryrun``,
``analysis.opcount``, the kernels' meta paths, ``params.abstract_params``,
``zoo.abstract_model`` / ``cache_specs``) against ``repro``'s:

* ``cell_skip_reason`` equals ``repro.launch.dryrun``'s for the ten
  configs x four shapes.  ``repro``'s module sets ``XLA_FLAGS`` to 512
  devices when imported, so its side runs in a subprocess (one JAX
  process with 512 host devices), which also gives JAX's
  ``devices_indices_map`` slices below;
* ``abstract_model`` and ``cache_specs`` give ``repro``'s ``jax.eval_shape``
  shapes and dtypes, leaf by leaf (the port's per-layer leaves against
  ``repro``'s stacked ones less their ``layers`` dim), every config and
  shape; on a ``fake`` process group each leaf's local shard on ranks 0
  and 255 of the 16 x 16 mesh and 0 and 511 of the 2 x 16 x 16 mesh is
  JAX's slice for that device (parameters, and the decode_32k cache);
* the op counter against ``repro.analysis.hlo.analyze`` of the jitted and
  compiled step, one device, reduced configs: products outside attention
  and the scans equal (prefill of tinyllama-1.1b and falcon-mamba-7b
  exactly; tinyllama's train step exactly less one pass of the MLP's
  down projection: ``torch.utils.checkpoint`` recomputes a layer up to
  its last saved tensor, XLA's remat one product less); attention and
  the scan held to the kernels' formulas, with the gap to ``repro``'s
  blocked XLA count stated (``repro`` counts every (query, key) pair of
  a block, the kernel the valid ones; its scan one dot a step for y, the
  kernel h's updates too);
* each kernel's meta path returns the plain version's shapes and dtypes
  and adds its formula's counts, on meta tensors and on meta DTensors;
* one reduced cell through ``run_cell`` on a 16 x 16 fake group.

Every fake group is destroyed in its fixture's teardown.
"""

import json
import os
import re
import resource
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.analysis import hlo as j_hlo  # noqa: E402
from repro.configs import get as j_get  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro.models.config import SHAPES as J_SHAPES  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402

from repro_torch import sharding as t_shd  # noqa: E402
from repro_torch.analysis import opcount  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.configs import ALIASES  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import params as t_params  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402
from repro_torch.models.config import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(ALIASES)
STACKED = re.compile(r"^\['(layers|enc_layers|dec_layers)'\]\[\d+\]")
#: (mesh, rank) pairs whose local shards are checked
RANKS = [((16, 16), 0), ((16, 16), 255), ((2, 16, 16), 0),
         ((2, 16, 16), 511)]

_REPRO_SIDE = r"""
import json, sys
import numpy as np
from repro.launch import dryrun            # sets XLA_FLAGS: 512 devices
import jax
from jax.sharding import Mesh, NamedSharding
from repro import sharding as shd
from repro.configs import get
from repro.models import params, zoo
from repro.models.config import SHAPES
archs, ranks = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {"skip": {a: {s: dryrun.cell_skip_reason(get(a), SHAPES[s])
                    for s in SHAPES} for a in archs}, "layouts": {}}
devs = jax.devices()
for shape, want in ranks.items():
    shape = tuple(json.loads(shape))
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    mesh = Mesh(np.asarray(devs[:int(np.prod(shape))]).reshape(shape), axes)
    lay = out["layouts"][str(list(shape))] = {}
    for a in archs:
        cfg = get(a)
        leaves = {}
        flat, _ = jax.tree_util.tree_flatten_with_path(
            params.param_specs(zoo.model_defs(cfg), mesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        defs = {jax.tree_util.keystr(p): d for p, d in
                jax.tree_util.tree_flatten_with_path(
                    zoo.model_defs(cfg), is_leaf=params.is_def)[0]}
        for p, spec in flat:
            k = jax.tree_util.keystr(p)
            leaves[k] = (NamedSharding(mesh, spec), defs[k].shape)
        shd.set_mesh(mesh)
        cache = zoo.cache_specs(cfg, SHAPES["decode_32k"])
        shd.set_mesh(None)
        for p, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
            if getattr(leaf, "sharding", None) is not None:
                leaves["cache" + jax.tree_util.keystr(p)] = (leaf.sharding,
                                                             leaf.shape)
        lay[a] = {k: {str(r): [[sl.start or 0, n if sl.stop is None
                                else sl.stop]
                               for sl, n in zip(sh.devices_indices_map(
                                   tuple(s))[devs[r]], s)]
                      for r in want}
                  for k, (sh, s) in leaves.items()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def repro_side():
    """``repro``'s skip rule and JAX's slices, from a 512-device JAX
    process."""
    ranks = {}
    for shape, r in RANKS:
        ranks.setdefault(json.dumps(list(shape)), []).append(r)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-c", _REPRO_SIDE, json.dumps(ARCHS),
         json.dumps(ranks)], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_skip_rule_matches_repro(repro_side):
    for a in ARCHS:
        for s in T_SHAPES:
            assert dryrun.cell_skip_reason(t_get(a), T_SHAPES[s]) == \
                repro_side["skip"][a][s], (a, s)


# ------------------------------------------------------------ abstract trees

def _repro_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in flat}


def _port_leaves(tree, prefix="") -> dict:
    out = {}
    for path, t in t_params.leaf_paths(tree, prefix):
        out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return out


def _stacked(path: str) -> str:
    return STACKED.sub(r"['\1']", path)


@pytest.mark.parametrize("name", ARCHS)
def test_abstract_model_and_cache_specs_match_eval_shape(name):
    jcfg, tcfg = j_get(name), t_get(name)
    want = _repro_leaves(j_zoo.abstract_model(jcfg))
    got = _port_leaves(t_zoo.abstract_model(tcfg).tree())
    assert {_stacked(p) for p in got} == set(want)
    for path, (shape, dt) in got.items():
        wshape, wdt = want[_stacked(path)]
        if STACKED.match(path):
            wshape = wshape[1:]
        assert (shape, dt) == (wshape, wdt), path
    for s in T_SHAPES:
        want = _repro_leaves(j_zoo.cache_specs(jcfg, J_SHAPES[s]))
        cache = t_zoo.cache_specs(tcfg, T_SHAPES[s])
        got = _port_leaves(cache)
        assert got == want, (name, s)
        assert all(t.device.type == "meta"
                   for _, t in t_params.leaf_paths(cache))


@pytest.fixture(params=RANKS, ids=lambda r: f"{'x'.join(map(str, r[0]))}"
                                              f"-rank{r[1]}")
def fake_rank(request):
    """A fake group of the mesh's size in which this process is the given
    rank; the mesh active; both torn down after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, rank = request.param
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=int(np.prod(shape)))
    try:
        mesh = t_mesh.make_production_mesh(multi_pod=len(shape) == 3,
                                           device_type="cpu")
        t_shd.set_mesh(mesh)
        yield shape, rank
    finally:
        t_shd.set_mesh(None)
        dist.destroy_process_group()


def _local_leaves(tree) -> dict:
    return {p: tuple(t.to_local().shape) for p, t in
            t_params.leaf_paths(tree)}


def test_local_shards_are_jax_slices(fake_rank, repro_side):
    shape, rank = fake_rank
    lay = repro_side["layouts"][str(list(shape))]
    for name in ARCHS:
        cfg = t_get(name)
        jl = lay[name]
        tree = t_zoo.abstract_model(cfg).tree()
        got = _local_leaves(tree)
        for path, local in got.items():
            sl = jl[_stacked(path)][str(rank)]
            if STACKED.match(path):
                sl = sl[1:]
            want = tuple(b - a for a, b in sl)
            assert local == want, (name, path)
        cache = _local_leaves(t_zoo.cache_specs(cfg, T_SHAPES["decode_32k"]))
        for path, local in cache.items():
            sl = jl["cache" + path][str(rank)]
            assert local == tuple(b - a for a, b in sl), (name, path)
        # the layouts split something: FSDP over data, TP over model
        assert any(np.prod(got[p]) < np.prod(t.shape)
                   for p, t in t_params.leaf_paths(tree)), name


# ------------------------------------------------------- counter against hlo

def _repro_flops(name: str, kind: str, B: int, S: int) -> float:
    cfg = j_get(name).reduced()
    shape = JShape("x", S, B, kind)
    params = j_zoo.abstract_model(cfg)
    batch = j_zoo.batch_specs(cfg, shape)
    if kind == "train":
        step = j_steps.make_train_step(cfg, j_adamw.AdamWConfig())
        opt = jax.eval_shape(j_adamw.init, params)
        lowered = jax.jit(step).lower(params, opt, batch)
    else:
        step = j_steps.make_prefill_step(cfg, S)
        lowered = jax.jit(step).lower(params, batch)
    return j_hlo.analyze(lowered.compile().as_text())["flops"]


@pytest.mark.parametrize("name,kind,B,S", [
    ("tinyllama-1.1b", "prefill", 2, 64),
    ("tinyllama-1.1b", "train", 1, 1024),
    ("falcon-mamba-7b", "prefill", 2, 64)])
def test_counter_matches_hlo_analyze(name, kind, B, S):
    cfg = t_get(name).reduced()
    per, _, mb = dryrun.analyze_step(cfg, ShapeConfig("x", S, B, kind))
    assert mb == 1
    kernels = sum(k["flops"] for k in per["kernels"].values())
    products = per["flops"] - kernels
    want = _repro_flops(name, kind, B, S)
    L = cfg.n_layers
    if cfg.family == "ssm":
        # repro's XLA scan: one [B, D] x [B, N] dot a step of the padded
        # 256-step chunk for y; the kernel: 4 operations a state element
        # a step (h and y)
        T = -(-S // 256) * 256
        xla = 2 * B * T * cfg.d_inner * cfg.ssm_state * L
        assert per["kernels"]["ssm_scan"]["flops"] == \
            rl.scan_work(B, T, cfg.d_inner, cfg.ssm_state)[0] * L == 2 * xla
        assert products == want - xla
        return
    H, hd = cfg.n_heads, cfg.hd
    pairs = rl.valid_pairs(S, S, True, 0)
    # repro's blocked path (S <= its 1 024-key block: one block) makes
    # both products over every (query, key) pair: 4 hd S^2 a head forward;
    # in training again in the remat forward, twice that backward
    passes = 4 if kind == "train" else 1
    xla = passes * 4 * hd * S * S * B * H * L
    if kind == "train":
        assert per["kernels"]["flash_attention"]["flops"] == \
            2 * L * rl.flash_work(B, S, H, cfg.n_kv_heads, hd, True, 0,
                                  "bf16")[0]
        assert per["kernels"]["flash_attention_bwd"]["flops"] == \
            L * rl.flash_bwd_work(B, S, S, H, cfg.n_kv_heads, hd, True, 0)[0]
        assert kernels == 18 * hd * pairs * B * H * L
        early = 2 * cfg.d_ff * cfg.d_model * B * S * L
        assert products == want - xla + early
        assert products == rl.train_flops(cfg, B, S) - kernels - early \
            - 8 * cfg.d_model * (2 * L + 1) * B * S
    else:
        assert kernels == 4 * hd * pairs * B * H * L
        assert products == want - xla
    # the gap: the kernel counts the causal half, repro every pair
    assert kernels / xla == pytest.approx(
        (18 if kind == "train" else 4) * pairs / (16 if kind == "train"
                                                  else 4) / (S * S))


# ---------------------------------------------------------------- meta paths

def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _kernel_cases():
    g = torch.Generator().manual_seed(3)
    r = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=g).to(dt)
    B, S, H, K, hd = 2, 32, 4, 2, 16
    q, k, v = r(B, S, H, hd), r(B, S, K, hd), r(B, S, K, hd)
    W = 24
    ck, cv = r(B, W, K, hd), r(B, W, K, hd)
    kv_pos = torch.arange(W, dtype=torch.int32)
    q_pos = torch.tensor([W], dtype=torch.int32)
    decay = torch.rand(B, 16, 8, 4, generator=g) * 0.5 + 0.5
    dbu, c = r(B, 16, 8, 4, dt=torch.float32), r(B, 16, 4, dt=torch.float32)
    h0 = r(B, 8, 4, dt=torch.float32)
    rp, ip, u = r(B, 16, 8), r(B, 16, 8), r(B, 16, 8)
    nsp, hr = -torch.rand(8, generator=g), r(B, 8, dt=torch.float32)
    return [
        ("flash_attention", lambda *a: fa_ops.flash_attention(*a),
         (q, k, v), rl.flash_work(B, S, H, K, hd, True, 0, "bf16")),
        ("decode_attention",
         lambda *a: pa_ops.decode_attention(*a[:3], q_pos=a[4],
                                            kv_pos=a[3], window=0),
         (q[:, :1], ck, cv, kv_pos, q_pos),
         rl.decode_work(B, H, K, hd, W, W, "bf16")),
        ("ssm_scan", lambda *a: ssm_ops.ssm_scan(*a), (decay, dbu, c, h0),
         rl.scan_work(B, 16, 8, 4)),
        ("rglru_scan", lambda *a: rg_ops.rglru_scan(*a), (rp, ip, u, nsp, hr),
         rl.rglru_work(B, 16, 8))]


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("case", range(4))
def test_kernel_meta_paths_count_and_shape(case):
    name, fn, args, (ops, nbytes) = _kernel_cases()[case]
    want = _flat(fn(*args))                # the plain version, on the CPU
    with opcount.OpCounter() as c:
        got = _flat(fn(*(_meta(a) for a in args)))
    assert [(g.shape, g.dtype, g.device.type) for g in got] == \
        [(w.shape, w.dtype, "meta") for w in want]
    assert c.result()["kernels"] == {name: {"calls": 1, "flops": ops,
                                            "bytes": nbytes}}


@pytest.fixture
def fake_16x16():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = t_mesh.make_production_mesh(device_type="cpu")
        yield mesh
    finally:
        t_shd.set_mesh(None)
        dist.destroy_process_group()


def test_kernel_meta_paths_on_dtensors(fake_16x16):
    """Batch over ``data`` (16) and heads over ``model`` (16): each rank
    counts its B / 16 rows and H / 16 heads (the KV heads it needs), the
    output a DTensor of the global shape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_16x16
    B, S, H, K, hd = 32, 64, 32, 4, 16

    def dt(shape, pl, dtype=torch.bfloat16):
        local = t_params.local_shape(shape, mesh, pl)
        return DTensor.from_local(torch.empty(local, dtype=dtype,
                                              device="meta"), mesh, pl,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=t_params.contiguous_strides(shape))
    q = dt((B, S, H, hd), (Shard(0), Shard(2)))
    k = dt((B, S, K, hd), (Shard(0), Replicate()))
    with opcount.OpCounter() as c:
        o = fa_ops.flash_attention(q, k, k, causal=True, window=0)
    assert isinstance(o, DTensor) and tuple(o.shape) == (B, S, H, hd)
    assert o.placements == (Shard(0), Shard(2))
    assert c.result()["kernels"]["flash_attention"]["flops"] == \
        rl.flash_work(B // 16, S, H // 16, 1, hd, True, 0, "bf16")[0]
    x = dt((B, S, 128), (Shard(0), Shard(2)))
    nsp = dt((128,), (Replicate(), Shard(0)), torch.float32)
    h0 = dt((B, 128), (Shard(0), Replicate()), torch.float32)
    with opcount.OpCounter() as c:
        h_seq, h_n = rg_ops.rglru_scan(x, x, x, nsp, h0)
    assert tuple(h_seq.shape) == (B, S, 128) and h_seq.dtype == torch.float32
    assert c.result()["kernels"]["rglru_scan"] == {
        "calls": 1, "flops": rl.rglru_work(B // 16, S, 8)[0],
        "bytes": rl.rglru_work(B // 16, S, 8)[1]}


# ------------------------------------------------------------------ one cell

def test_reduced_cell_through_run_cell(fake_16x16):
    cfg = t_get("tinyllama-1.1b").reduced()
    shape = T_SHAPES["train_4k"]
    one, _, _ = dryrun.analyze_step(cfg, shape, 1)   # no mesh: one device
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.run_cell("tinyllama-1.1b", "train_4k", False, cfg=cfg,
                          microbatches=1)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["microbatches"] == 1 and rec["mesh"] == "16x16"
    assert rec["hlo_flops_per_dev"] * 256 >= one["flops"]
    assert rec["coll_bytes_per_dev"] > 0
    assert rec["coll_by_kind"].get("all-reduce", 0) > 0    # the gradients
    assert rec["fits_80gb"] and rec["hbm_gb_corrected"] == \
        rec["hbm_gb_per_device"]
    assert rec["model_flops_per_dev"] == rl.model_flops(cfg, shape, 256)
    assert (rss1 - rss0) / 2**20 <= 1.0                    # KiB -> GiB
