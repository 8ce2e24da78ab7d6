"""The training substrate of the PyTorch port against ``repro``: AdamW,
its schedule, int8 gradient compression, the data pipeline, checkpoints,
the train step's tables, ``grad_cast_bf16`` and ``chunked_ce``.

Tolerances.  AdamW's state is f32 element-wise arithmetic on both sides;
XLA on the CPU may contract ``a * b + c`` into one FMA where PyTorch
rounds twice, and its f32 ``sqrt`` / ``pow`` / ``cos`` may differ by an
ulp, and an element near zero keeps the rounding error of its larger
terms: ``m``, ``v`` and ``master`` agree within ``ADAM_ULPS`` ulps of the
tensor's largest element (relative ``ADAM_RTOL``), the bf16 parameters rounded from
``master`` within one bf16 ulp (a master value at a rounding boundary),
the schedule within ``SCHED_RTOL``.  The compression, the pipeline's
batches and checkpoints are bitwise.
"""

import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import manager as j_ckpt  # noqa: E402
from repro.configs import ALL_ARCHS, get as j_get  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro.models.config import SHAPES  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import compress as j_comp  # noqa: E402
from repro_torch.checkpoint import manager as t_ckpt  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim import compress as t_comp  # noqa: E402

#: f32 ulps AdamW's state may differ by (module docstring)
ADAM_ULPS = 4
ADAM_RTOL = ADAM_ULPS * 2.0 ** -23
SCHED_RTOL = 4 * 2.0 ** -23
GNORM_RTOL = 2.0 ** -16


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(got, want, rtol, what):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    lim = rtol * np.abs(want).max()
    bad = np.abs(got - want) > lim
    assert not bad.any(), (what, np.abs(got - want).max(), int(bad.sum()))


def _params(name="tinyllama-1.1b"):
    cfg = j_get(name).reduced()
    return cfg, j_zoo.init_model(cfg, seed=0)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.3,
                              jnp.float32).astype(p.dtype), params)


# ----------------------------------------------------------------- AdamW

@pytest.mark.parametrize("clip_norm", [1.0, 1e3], ids=["clipped", "free"])
def test_adamw_update_matches_repro(clip_norm):
    """Three updates on the same gradients (bf16, as a microbatch's) from
    the same state: grad norm, lr, ``m``, ``v``, ``master`` within
    ``ADAM_ULPS`` ulps, the bf16 parameters within one bf16 ulp."""
    cfg, params = _params()
    opt_cfg = j_adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2,
                                  decay_steps=10, clip_norm=clip_norm)
    t_cfg = t_adamw.AdamWConfig(**vars(opt_cfg))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    j_state = j_adamw.init(params)
    t_params = convert.tree_from_repro(np_params, "cpu", torch.bfloat16)
    t_state = t_adamw.init(t_params)
    rtol = GNORM_RTOL if clip_norm == 1.0 else ADAM_RTOL
    for step in range(3):
        g = _grads(params, step)
        params, j_state, jm = j_adamw.update(opt_cfg, g, j_state, params)
        t_g = convert.tree_from_repro(jax.tree_util.tree_map(np.asarray, g),
                                      "cpu")
        t_params, t_state, tm = t_adamw.update(t_cfg, t_g, t_state,
                                               t_params)
        _close(tm["grad_norm"], jm["grad_norm"], GNORM_RTOL, "grad_norm")
        assert (float(jm["grad_norm"]) > clip_norm) == (clip_norm == 1.0)
        _close(tm["lr"], jm["lr"], SCHED_RTOL, "lr")
        assert int(t_state.step) == int(j_state.step) == step + 1
        got = convert.opt_to_repro(t_state)
        for key in ("m", "v", "master"):
            for (path, w), h in zip(
                    jax.tree_util.tree_leaves_with_path(getattr(j_state,
                                                                key)),
                    jax.tree_util.tree_leaves(got[key])):
                _close(h, w, rtol, (step, key,
                                         jax.tree_util.keystr(path)))
        for w, h in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(
                            convert.tree_to_repro(t_params))):
            _close(h, w, 2.0 ** -7, ("params", step))


def test_adamw_leaves_follow_repros_order():
    """``adamw.leaves`` walks the port's tree in ``jax.tree_util``'s
    order of ``repro``'s stacked tree (layers unstacked in order), and
    ``unflatten`` inverts it."""
    cfg, params = _params("whisper-small")
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tree = convert.tree_from_repro(np_params, "cpu", torch.float32)
    flat = t_adamw.leaves(tree)
    runs = _runs(np_params, cfg)
    assert sum(n for _, n, _ in runs) == len(flat)
    for a, (i, n, stacked) in zip(jax.tree_util.tree_leaves(np_params),
                                  runs):
        got = (np.stack([_np(x) for x in flat[i:i + n]]) if stacked
               else _np(flat[i]))
        np.testing.assert_array_equal(np.asarray(a, np.float32), got)
    back = t_adamw.unflatten(tree, flat)
    assert all(x is y for x, y in zip(t_adamw.leaves(back), flat))


def _runs(tree, cfg):
    """``(start, count, stacked)`` of each ``repro`` leaf in the port's
    flat list: a stacked leaf is ``n_layers`` consecutive port leaves."""
    depth = {"enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers,
             "layers": cfg.n_layers}
    out, i = [], 0
    for path, _ in jax.tree_util.tree_leaves_with_path(tree):
        n = depth.get(path[0].key, 1)
        out.append((i, n, path[0].key in depth))
        i += n
    return out


def test_schedule_matches_repro_over_200_steps():
    cfg = j_adamw.AdamWConfig(warmup_steps=20, decay_steps=150)
    t_cfg = t_adamw.AdamWConfig(**vars(cfg))
    steps = np.arange(201, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: j_adamw.schedule(cfg, s))(
        jnp.asarray(steps)))
    got = t_adamw.schedule(t_cfg, torch.from_numpy(steps)).numpy()
    _close(got, want, SCHED_RTOL, "schedule")
    assert got[0] == 0.0 and abs(got[20] - cfg.peak_lr) < 1e-9


def test_opt_state_round_trips_through_convert():
    cfg, params = _params("phi3.5-moe-42b-a6.6b")
    state = j_adamw.init(params)
    state = state._replace(step=jnp.int32(7), m=_grads(params, 1),
                           v=_grads(params, 2))
    state = jax.tree_util.tree_map(np.asarray, state)
    t_state = convert.opt_from_repro(state, "cpu")
    back = convert.opt_to_repro(t_state)
    assert back["step"] == 7 and t_state.step.dtype == torch.int32
    for key in ("m", "v", "master"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(state, key)),
                        jax.tree_util.tree_leaves(back[key])):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)


# ------------------------------------------------------------ compression

@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_quantize_dequantize_bitwise(scale):
    rng = np.random.default_rng(int(scale * 10) + 1)
    g = (rng.normal(size=(33, 17)) * scale).astype(np.float32)
    err = (rng.normal(size=(33, 17)) * scale * 1e-2).astype(np.float32)
    for dt in (jnp.float32, jnp.bfloat16):
        gj = jnp.asarray(g).astype(dt)
        qj, sj, ej = j_comp.quantize(gj, jnp.asarray(err))
        gt = torch.from_numpy(np.asarray(gj.astype(jnp.float32))).to(
            torch.bfloat16 if dt == jnp.bfloat16 else torch.float32)
        qt, st, et = t_comp.quantize(gt, torch.from_numpy(err))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
        np.testing.assert_array_equal(t_comp.dequantize(qt, st).numpy(),
                                      np.asarray(j_comp.dequantize(qj, sj)))


def test_init_error_is_zero_f32_like_params():
    cfg, params = _params()
    tree = convert.tree_from_repro(jax.tree_util.tree_map(np.asarray,
                                                          params), "cpu")
    errs = t_comp.init_error(tree)
    for p, e in zip(t_adamw.leaves(tree), t_adamw.leaves(errs)):
        assert e.shape == p.shape and e.dtype == torch.float32
        assert not e.any()


# -------------------------------------------------------------- pipeline

@pytest.mark.parametrize("step,host,n_hosts", [
    (0, 0, 1), (3, 1, 2), (17, 3, 4), (1000, 0, 2)])
def test_pipeline_batches_bitwise(step, host, n_hosts):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=5)
    jd, td = j_pipe.DataConfig(**kw), t_pipe.DataConfig(**kw)
    for got, want in ((t_pipe.global_batch_at(td, step),
                       j_pipe.global_batch_at(jd, step)),
                      (t_pipe.host_batch_at(td, step, host, n_hosts),
                       j_pipe.host_batch_at(jd, step, host, n_hosts))):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    b = t_pipe.global_batch_at(td, step)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_prefetcher_order_resume_and_close():
    cfg = t_pipe.DataConfig(vocab_size=500, seq_len=16, global_batch=4,
                            seed=1, prefetch=2)
    pf = t_pipe.Prefetcher(cfg, start_step=5, host_id=1, n_hosts=2,
                           timeout=30.0)
    try:
        for step in range(5, 9):
            got = next(pf)
            want = t_pipe.host_batch_at(cfg, step, 1, 2)
            assert pf.step == step
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    before = threading.active_count()
    pf2 = t_pipe.Prefetcher(cfg, timeout=30.0)
    pf2.close()
    assert threading.active_count() <= before


def test_prefetcher_next_times_out_instead_of_hanging():
    cfg = t_pipe.DataConfig(vocab_size=500, seq_len=16, global_batch=4)
    pf = t_pipe.Prefetcher(cfg, timeout=0.2)
    pf.close()
    while not pf._q.empty():
        pf._q.get_nowait()
    with pytest.raises(TimeoutError):
        next(pf)


# ----------------------------------------------------------- checkpoints

def _plain_tree(seed):
    rng = np.random.default_rng(seed)
    bf = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    return {"params": {"embed": bf,
                       "layers": {"w": rng.normal(size=(2, 4, 3)).astype(
                           np.float32)}},
            "opt": {"step": np.int32(4),
                    "m": rng.normal(size=(7,)).astype(np.float32)}}


def _assert_same(got, want):
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                         jax.tree_util.tree_leaves(got)):
        a = np.asarray(a)
        if isinstance(b, torch.Tensor):
            if b.dtype == torch.bfloat16:
                b = b.view(torch.int16).numpy().view(np.uint16)
                a = a.view(np.uint16)
            else:
                b = b.numpy()
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b)


def test_checkpoint_repro_save_port_restore_bitwise(tmp_path):
    tree = _plain_tree(0)
    j_ckpt.save(str(tmp_path), 12, tree, extra={"data_step": 12})
    target = {"params": {"embed": torch.zeros(3, 5, dtype=torch.bfloat16),
                         "layers": {"w": torch.zeros(2, 4, 3)}},
              "opt": {"step": torch.zeros((), dtype=torch.int32),
                      "m": torch.zeros(7)}}
    got, step, extra = t_ckpt.restore(str(tmp_path), target)
    assert step == 12 and extra == {"data_step": 12}
    assert got["params"]["embed"].dtype == torch.bfloat16
    _assert_same(got, tree)


def test_checkpoint_port_save_repro_restore_bitwise(tmp_path):
    tree = _plain_tree(1)
    port = jax.tree_util.tree_map(
        lambda a: (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if a.dtype == ml_dtypes.bfloat16
                   else torch.from_numpy(np.array(a))), tree)
    t_ckpt.save(str(tmp_path), 3, port, extra={"k": 1})
    got, step, extra = j_ckpt.restore(str(tmp_path), tree)
    assert step == 3 and extra == {"k": 1}
    _assert_same(jax.tree_util.tree_map(np.asarray, got), tree)


def test_checkpoint_layout_and_tmp_ignored(tmp_path):
    d = str(tmp_path / "ck")
    t_ckpt.save(d, 5, {"a": torch.ones(2)})
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert sorted(os.listdir(d)) == ["step_00000005", "step_00000009.tmp"]
    assert sorted(os.listdir(os.path.join(d, "step_00000005"))) == [
        "manifest.json", "shard_00000.npz"]
    assert t_ckpt.latest_step(d) == j_ckpt.latest_step(d) == 5
    assert t_ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(str(tmp_path / "none"), {"a": torch.ones(2)})
    with pytest.raises(KeyError):
        t_ckpt.restore(d, {"b": torch.ones(2)})


def test_async_checkpointer_saves_model_and_opt_state(tmp_path):
    """The port's own train state (layer lists, an ``OptState``) written
    in the background and restored bitwise; names as ``keystr`` writes
    them."""
    cfg, params = _params()
    tree = convert.tree_from_repro(jax.tree_util.tree_map(np.asarray,
                                                          params), "cpu")
    state = t_adamw.init(tree)
    saver = t_ckpt.AsyncCheckpointer(str(tmp_path), timeout=60.0)
    saver.save_async(2, {"params": tree, "opt": state},
                     extra={"data_step": 2})
    saver.wait()
    names = [n for n, _ in t_ckpt._flatten({"params": tree, "opt": state})]
    assert "['params']['layers'][1]['attn']['wq']" in names
    assert ".m" not in names and "['opt'].step" in names
    zero = t_adamw.tree_map(torch.zeros_like, tree)
    got, step, extra = t_ckpt.restore(
        str(tmp_path), {"params": zero, "opt": t_adamw.init(zero)})
    assert step == 2 and extra["data_step"] == 2
    assert isinstance(got["opt"], t_adamw.OptState)
    for a, b in zip(t_adamw.leaves(tree), t_adamw.leaves(got["params"])):
        assert torch.equal(a, b) and a.dtype == b.dtype
    for a, b in zip(t_adamw.leaves(state.master),
                    t_adamw.leaves(got["opt"].master)):
        assert torch.equal(a, b)


# ---------------------------------------------------------- step tables

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_tables_match_repro(arch):
    cfg, t_cfg = j_get(arch), t_get(arch)

    class Mesh:
        def __init__(self, **shape):
            self.shape = shape
    for mesh in (None, Mesh(data=4), Mesh(pod=2, data=8, model=4)):
        jm = None if mesh is None else type("M", (), {"shape": mesh.shape})()
        assert t_steps.dp_degree(mesh) == j_steps.dp_degree(jm)
        for shape in SHAPES.values():
            assert (t_steps.microbatches_for(t_cfg, shape, mesh)
                    == j_steps.microbatches_for(cfg, shape, jm))
    want = j_steps.accum_dtype_for(cfg)
    got = t_steps.accum_dtype_for(t_cfg)
    assert str(got).split(".")[-1] == jnp.dtype(want).name


# ------------------------------------------------- grad cast, chunked CE

def test_grad_cast_bf16_matches_repros_vjp():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 9)).astype(np.float32)
    g = (rng.normal(size=(4, 9)) * 1.2345).astype(np.float32)
    y, vjp = jax.vjp(j_lm.grad_cast_bf16, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = t_lm.grad_cast_bf16(xt)
    (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), g)


@pytest.mark.parametrize("chunk", [16, 7])
def test_chunked_ce_matches_unchunked(chunk):
    """Chunks (the last short) give the unchunked masked mean cross
    entropy and its gradients, up to the f32 sums' order."""
    cfg = t_get("tinyllama-1.1b").reduced()
    from repro_torch.models import zoo
    model = zoo.init_model(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(4)
    B, S = 2, 40
    x = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    targets = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    mask = torch.from_numpy((rng.random((B, S)) > 0.2).astype(np.float32))

    def run(fn):
        xr = x.clone().requires_grad_(True)
        head = model.head
        head.requires_grad_(True)
        try:
            loss = fn(xr)
            gx, gh = torch.autograd.grad(loss, (xr, head))
        finally:
            head.requires_grad_(False)
        return loss.detach(), gx, gh

    got = run(lambda xr: t_lm.chunked_ce(model, xr, targets, mask, cfg,
                                         chunk=chunk))

    def full(xr):
        logits = t_lm.logits_fn(model, xr, cfg).float()
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
            reduction="none").reshape(B, S)
        return (nll * mask).sum() / mask.sum()
    want = run(full)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * float(b.abs().max()))
