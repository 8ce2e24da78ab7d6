"""The dense-LM serving path of the PyTorch port against ``repro``.

Small sizes on the CPU: the layers (norms, RoPE, MLP, attention) on the
same numpy-seeded inputs; the exact weight round trip ``convert``; the
reduced tinyllama / phi4-mini (tied embeddings) / granite (MQA, K = 1) /
phi3-medium (K 2 here, G 2) / pixtral (4 stub patch embeddings as a
prefix) configs through ``prefill_fn`` and three ``decode_fn`` steps
against ``repro`` with ``RunFlags(attn_impl="pallas")`` (its Pallas
kernels in interpret mode), weights carried across; and the port's own
prefill + decode against its full forward, as ``tests/test_models.py``
holds ``repro``'s.  For every one of the ten configs: the parameter
count, the zero decode cache and the shape cells' input specs against
``repro``'s.

Tolerances.  Both sides compute in bf16 with f32 statistics, but round
at other places (XLA on the CPU keeps excess precision inside a fusion,
PyTorch rounds every op): layer outputs agree to a few bf16 ulps, and
the reduced models' logits (|x| < 4, where a bf16 ulp is 2**-6) and
cache entries to 0.0625, four ulps there; slot positions and ``pos``
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS, get as j_get  # noqa: E402
from repro.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import params as j_params  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro_torch import golden  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import params as t_params  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402

#: the reduced models' logits and cache entries (module docstring)
LM_TOL = 0.0625
#: one layer's bf16 output: two ulps at |x| < 4
LAYER_TOL = 0.0313
PALLAS = j_lm.RunFlags(attn_impl="pallas")
SERVE_ARCHS = ["tinyllama_1p1b", "phi4_mini_3p8b", "granite_34b",
               "phi3_medium_14b", "pixtral_12b"]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_pair(rng, shape, scale=1.0):
    j = jnp.asarray(rng.normal(size=shape) * scale, jnp.float32).astype(
        jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _params_pair(defs_j, defs_t, seed=0):
    """``repro``'s random weights for a layer, and the same values as the
    port's tree (bf16)."""
    pj = j_params.init_params(defs_j, jax.random.PRNGKey(seed), jnp.bfloat16)
    pt = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16), pj)
    return pj, pt


def _cfg(arch, **kw):
    return (dataclasses.replace(j_get(arch).reduced(), **kw),
            dataclasses.replace(t_get(arch).reduced(), **kw))


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_match_repro(arch):
    j, t = j_get(arch), t_get(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert (t.hd, t.vocab_padded, t.n_params()) == (j.hd, j.vocab_padded,
                                                    j.n_params())
    assert t_lm.layer_types(t) == j_lm.layer_types(j)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_matches_repro_or_names_its_slice(arch):
    """Every family is ported: the ParamDef tree counts ``repro``'s
    parameters (no family names a later slice any more)."""
    cfg = t_get(arch)
    assert (t_params.count_params(t_zoo.model_defs(cfg))
            == j_params.count_params(j_zoo.model_defs(j_get(arch))))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_cache_matches_repro(arch):
    """``zoo.init_cache`` has the keys, shapes and dtypes of ``repro``'s
    decode cache (``zoo.cache_specs`` of a decode cell), and ``repro``'s
    zero values (``lm.init_cache``; the encdec cache is zeros but
    ``kv_pos`` -1)."""
    cfgj, cfgt = _cfg(arch)
    B, max_len = 3, 40
    want = dict(_leaves(j_zoo.cache_specs(
        cfgj, ShapeConfig("cell", max_len, B, "decode"))))
    got = dict(_leaves(t_zoo.init_cache(cfgt, B, max_len, device="cpu")))
    assert set(got) == set(want)
    for key, spec in want.items():
        assert tuple(got[key].shape) == spec.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(spec.dtype), key
    if cfgj.family != "encdec":
        for key, a in _leaves(j_lm.init_cache(cfgj, B, max_len)):
            assert np.array_equal(_f32(got[key]) if got[key].is_floating_point()
                                  else got[key].numpy(), np.asarray(a)), key


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_specs_match_repro(arch):
    """``zoo.batch_specs`` (meta tensors) has ``repro``'s inputs, shapes
    and dtypes in every shape cell, and ``make_batch`` draws them."""
    cfgj, cfgt = _cfg(arch)
    for shape in list(SHAPES.values()) + [ShapeConfig("p", 40, 2, "prefill"),
                                          ShapeConfig("t", 24, 2, "train")]:
        want = j_zoo.batch_specs(cfgj, shape)
        got = t_zoo.batch_specs(cfgt, shape)
        assert set(got) == set(want), shape.name
        for name, s in want.items():
            assert got[name].device.type == "meta"
            assert tuple(got[name].shape) == s.shape, (shape.name, name)
            assert str(got[name].dtype).split(".")[-1] == str(s.dtype)
    small = ShapeConfig("p", 40, 2, "prefill")
    batch = t_zoo.make_batch(cfgt, small, seed=3, device="cpu")
    again = t_zoo.make_batch(cfgt, small, seed=3, device="cpu")
    for name, x in batch.items():
        assert torch.equal(x, again[name])
        assert tuple(x.shape) == tuple(t_zoo.batch_specs(cfgt, small)[
            name].shape)
        if x.dtype == torch.int32:
            assert 0 <= int(x.min()) and int(x.max()) < min(
                cfgt.vocab_size, 1000)


def test_init_params_is_keyed_by_path():
    cfg = t_get("tinyllama_1p1b").reduced()
    defs = t_zoo.model_defs(cfg)
    a = t_params.init_params(defs, seed=3, device="cpu")
    b = t_params.init_params(defs, seed=3, device="cpu")
    c = t_params.init_params(defs, seed=4, device="cpu")
    wq = lambda t, i: t["layers"][i]["attn"]["wq"]
    assert torch.equal(wq(a, 0), wq(b, 0))
    assert not torch.equal(wq(a, 0), wq(a, 1))      # other path, other draw
    assert not torch.equal(wq(a, 0), wq(c, 0))
    std = defs["layers"][0]["attn"]["wq"].std
    assert abs(float(wq(a, 0).std()) / std - 1) < 0.1
    assert torch.equal(a["final_norm"]["scale"], torch.ones(cfg.d_model))


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_matches_repro(kind):
    cfgj, cfgt = _cfg("tinyllama_1p1b", norm_kind=kind)
    rng = np.random.default_rng(1)
    xj, xt = _bf16_pair(rng, (2, 7, cfgj.d_model), 3.0)
    pj, pt = _params_pair(j_layers.norm_defs(cfgj),
                          t_layers.norm_defs(cfgt))
    if kind == "layer":   # non-trivial scale and bias
        pj = {k: v + 0.5 for k, v in pj.items()}
        pt = {k: v + 0.5 for k, v in pt.items()}
    got = t_layers.norm_apply(pt, xt, cfgt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(j_layers.norm_apply(pj, xj,
                                                                   cfgj)),
                               atol=LAYER_TOL, rtol=0)


def test_rope_matches_repro():
    rng = np.random.default_rng(2)
    xj, xt = _bf16_pair(rng, (2, 9, 3, 16))
    pos = np.arange(100, 109, dtype=np.int32)
    want = j_layers.rope(xj, jnp.asarray(pos)[None], 10000.0)
    got = t_layers.rope(xt, torch.from_numpy(pos)[None], 10000.0)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LAYER_TOL, rtol=0)
    # theta 0 disables it; the half-split layout, not interleaved
    assert t_layers.rope(xt, torch.from_numpy(pos)[None], 0.0) is xt
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0
    out = t_layers.rope(x, torch.tensor([[1]]), 1.0)
    assert torch.allclose(out[0, 0, 0], torch.tensor(
        [np.cos(1.0), 0.0, np.sin(1.0), 0.0], dtype=torch.float32))


@pytest.mark.parametrize("name,jax_fn,port_fn", [
    ("silu", jax.nn.silu, t_layers.silu),
    ("gelu", jax.nn.gelu, t_layers.gelu_tanh),   # jax's default: tanh
    ("sigmoid", jax.nn.sigmoid, t_layers.sigmoid),   # the RG-LRU gates
])
def test_activation_equals_jax_nn(name, jax_fn, port_fn):
    """The MLP's activations are ``jax.nn``'s composites, rounded op by op
    in bf16 as XLA rounds them: equal bit for bit on the CPU."""
    rng = np.random.default_rng(12)
    xj, xt = _bf16_pair(rng, (4096,), 3.0)
    got = port_fn(xt)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_f32(got), _f32(jax_fn(xj))), name


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_repro(act):
    cfgj, cfgt = _cfg("tinyllama_1p1b", act=act)
    rng = np.random.default_rng(3)
    xj, xt = _bf16_pair(rng, (2, 5, cfgj.d_model))
    pj, pt = _params_pair(j_layers.mlp_defs(cfgj), t_layers.mlp_defs(cfgt))
    np.testing.assert_allclose(
        _f32(t_layers.mlp_apply(pt, xt, cfgt)),
        _f32(j_layers.mlp_apply(pj, xj, cfgj)), atol=LAYER_TOL, rtol=0)


@pytest.mark.parametrize("window", [0, 5])
def test_attention_matches_repro(window):
    cfgj, cfgt = _cfg("tinyllama_1p1b")
    rng = np.random.default_rng(4)
    S = 11
    xj, xt = _bf16_pair(rng, (2, S, cfgj.d_model))
    pj, pt = _params_pair(j_layers.attention_defs(cfgj),
                          t_layers.attention_defs(cfgt))
    pos = np.arange(S, dtype=np.int32)
    yj, (kj, vj) = j_layers.attention_apply(
        pj, xj, cfgj, q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
        causal=True, window=window, attn_impl="pallas")
    yt, (kt, vt) = t_layers.attention_apply(pt, xt, cfgt, causal=True,
                                            window=window)
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=LAYER_TOL,
                                   rtol=0)


# ------------------------------------------------------------ convert

@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_convert_round_trip_is_exact(arch):
    cfgj, cfgt = _cfg(arch)
    params = j_zoo.init_model(cfgj, seed=1)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = convert.from_repro(tree, cfgt, device="cpu")
    back = convert.to_repro(model)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        assert np.array_equal(a.astype(np.float32), flat_b[path]), path
    again = convert.from_repro(back, cfgt, device="cpu")
    for x, y in zip(model.parameters(), again.parameters()):
        assert x.dtype == y.dtype == torch.bfloat16 and torch.equal(x, y)
    assert (cfgt.tie_embeddings) == (model.head is None)


# ------------------------------------------------ prefill and decode

@pytest.fixture(scope="module")
def served():
    """``repro`` (pallas, interpret mode) and the port on each reduced
    config: the same weights, prompt and decode inputs; the logits and
    caches after prefill and after each of three decode steps."""
    out = {}
    for arch in SERVE_ARCHS:
        cfgj, cfgt = _cfg(arch)
        params = j_zoo.init_model(cfgj, seed=0)
        model = convert.from_repro(jax.tree_util.tree_map(np.asarray,
                                                          params), cfgt,
                                   device="cpu")
        rng = np.random.default_rng(11)
        B, S, T = 2, 12, 3
        prompt = rng.integers(0, cfgj.vocab_size, (B, S)).astype(np.int32)
        dec = rng.integers(0, cfgj.vocab_size, (T, B)).astype(np.int32)
        bj = {"tokens": jnp.asarray(prompt)}
        bt = {"tokens": torch.from_numpy(prompt)}
        P = cfgj.n_patches if cfgj.frontend == "vision" else 0
        if P:     # stub patch embeddings, a prefix of the sequence
            bj["prefix_embeds"], bt["prefix_embeds"] = _bf16_pair(
                rng, (B, P, cfgj.d_model))
        jl, jc = j_zoo.prefill_fn(params, bj, cfgj, max_len=P + S + 4,
                                  flags=PALLAS)
        tl, tc = t_zoo.prefill_fn(model, bt, cfgt, max_len=P + S + 4)
        rows = [(jl, jc, tl, {k: v.clone() for k, v in tc.items()})]
        for t in range(T):
            jl, jc = j_zoo.decode_fn(params, jc, jnp.asarray(dec[t]), cfgj,
                                     flags=PALLAS)
            tl, tc = t_zoo.decode_fn(model, tc, torch.from_numpy(dec[t]),
                                     cfgt)
            rows.append((jl, jc, tl, {k: v.clone() for k, v in tc.items()}))
        out[arch] = rows
    return out


@pytest.mark.parametrize("step", range(4), ids=["prefill", "decode1",
                                                "decode2", "decode3"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_matches_repro(served, arch, step):
    jl, jc, tl, tc = served[arch][step]
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LM_TOL, rtol=0)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]),
                                   atol=LM_TOL, rtol=0)
    assert np.array_equal(tc["kv_pos"].numpy(), np.asarray(jc["kv_pos"]))
    assert int(tc["pos"]) == int(jc["pos"])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port's own prefill + one decode step equal its full forward's
    last position (``tests/test_models.py``'s check, rel < 0.05)."""
    cfg = t_get(arch).reduced()
    model = t_zoo.init_model(cfg, seed=0, device="cpu")
    B, S = 2, 33
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)))
    x, aux = t_lm.forward(model, tokens, cfg)
    full = t_lm.logits_fn(model, x[:, -1:], cfg)[:, 0].float()
    _, cache = t_zoo.prefill_fn(model, {"tokens": tokens[:, :S - 1]}, cfg,
                                max_len=S + 4)
    ld, cache2 = t_zoo.decode_fn(model, cache, tokens[:, S - 1], cfg)
    rel = float((full - ld.float()).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 0.05, (arch, rel)
    assert int(cache2["pos"]) == S and float(aux) == 0.0
    assert bool(torch.isfinite(ld.float()).all())


def test_ring_cache_wraps_under_a_window():
    """With a sliding window shorter than the prompt, prefill keeps the
    last W positions in ring order and decode overwrites the oldest
    slot, as ``repro``'s ring does (the Pallas path, interpret mode)."""
    cfgj, cfgt = _cfg("tinyllama_1p1b", attn_window=8)
    params = j_zoo.init_model(cfgj, seed=2)
    model = convert.from_repro(jax.tree_util.tree_map(np.asarray, params),
                               cfgt, device="cpu")
    prompt = np.random.default_rng(5).integers(
        0, cfgj.vocab_size, (1, 13)).astype(np.int32)
    jl, jc = j_zoo.prefill_fn(params, {"tokens": jnp.asarray(prompt)}, cfgj,
                              max_len=32, flags=PALLAS)
    tl, tc = t_zoo.prefill_fn(model, {"tokens": torch.from_numpy(prompt)},
                              cfgt, max_len=32)
    assert tc["k"].shape[2] == 8
    for t in range(2):
        tok = np.asarray([t + 3], np.int32)
        jl, jc = j_zoo.decode_fn(params, jc, jnp.asarray(tok), cfgj,
                                 flags=PALLAS)
        tl, tc = t_zoo.decode_fn(model, tc, torch.from_numpy(tok), cfgt)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LM_TOL, rtol=0)
    assert np.array_equal(tc["kv_pos"].numpy(), np.asarray(jc["kv_pos"]))


def test_decode_writes_the_cache_in_place():
    cfg = t_get("tinyllama_1p1b").reduced()
    model = t_zoo.init_model(cfg, seed=0, device="cpu")
    _, cache = t_zoo.prefill_fn(model, {"tokens": torch.zeros(
        (1, 4), dtype=torch.long)}, cfg, max_len=8)
    k_before = cache["k"].clone()
    _, new = t_zoo.decode_fn(model, cache, torch.ones(1, dtype=torch.long),
                             cfg)
    assert new["k"] is cache["k"] and not torch.equal(cache["k"], k_before)
    assert int(cache["pos"]) == 4 and int(new["pos"]) == 5


def test_serve_step_matches_repro_greedy(monkeypatch):
    """``make_prefill_step`` then ``make_serve_step``: greedy argmax of
    the same logits (ties to the first index)."""
    cfgj, cfgt = _cfg("tinyllama_1p1b")
    params = j_zoo.init_model(cfgj, seed=0)
    model = convert.from_repro(jax.tree_util.tree_map(np.asarray, params),
                               cfgt, device="cpu")
    prompt = np.random.default_rng(9).integers(
        0, cfgj.vocab_size, (2, 6)).astype(np.int32)
    _, jc = j_steps.make_prefill_step(cfgj, 12, PALLAS)(
        params, {"tokens": jnp.asarray(prompt)})
    _, tc = t_steps.make_prefill_step(cfgt, 12)(
        model, {"tokens": torch.from_numpy(prompt)})
    j_serve = j_steps.make_serve_step(cfgj, PALLAS)
    t_serve = t_steps.make_serve_step(cfgt)
    jt, tt = jnp.zeros((2,), jnp.int32), torch.zeros(2, dtype=torch.int32)
    logits, _ = t_zoo.decode_fn(model, {k: v.clone() for k, v in tc.items()},
                                tt, cfgt)
    jt, jc = j_serve(params, jc, jt)
    tt, tc = t_serve(model, tc, tt)
    assert tt.dtype == torch.int32
    # equal where the top logit is unique in the port's bf16 logits
    top2 = torch.topk(logits.float(), 2).values
    unique = top2[:, 0] > top2[:, 1]
    assert torch.equal(tt[unique], torch.from_numpy(np.array(jt))[unique])
    assert torch.equal(tt, torch.argmax(logits, -1).to(torch.int32))
    logits = torch.zeros(1, 8, dtype=torch.bfloat16)
    logits[0, 3] = logits[0, 6] = 1.0
    monkeypatch.setattr(t_zoo, "decode_fn", lambda m, c, t, cfg: (logits, c))
    assert int(t_serve(model, {}, tt[:1])[0]) == 3


# -------------------------------------------------------------- golden

def test_golden_lm_tokens_reproduce_the_recorded_digest():
    """The counter-based token draw gives the inputs ``golden_lm.json``
    was computed on (the card rebuilds them, and the weights, the same
    way)."""
    rec = golden.load_lm()
    assert rec["lm"] == golden.LM
    cfg = t_get(golden.LM["config"])
    prompt, dec = golden.lm_tokens(cfg.vocab_size)
    assert golden.tokens_digest(prompt, dec) == rec["tokens_digest"]
    assert len(rec["steps"]) == golden.LM["steps"] + 1
    assert all(len(s["top_logits"]) == golden.LM["batch"]
               for s in rec["steps"])


def test_golden_weights_do_not_depend_on_the_chunking(monkeypatch):
    cfg = t_get("tinyllama_1p1b").reduced()
    defs = t_lm.lm_defs(cfg)
    a = golden.golden_weights(defs, 14)
    monkeypatch.setattr(golden, "_CHUNK", 1000)
    b = golden.golden_weights(defs, 14)
    assert golden.weights_digest(a) == golden.weights_digest(b)
    wq = a["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    std = defs["layers"][1]["attn"]["wq"].std
    assert abs(float(wq.float().std()) / std - 1) < 0.05
    assert float(wq.float().abs().max()) <= 3 ** 0.5 * std * 1.01


def test_defs_digest_is_the_weights_digest():
    """``golden.defs_digest`` draws only the elements ``weights_digest``
    reads, and gives its digest."""
    for arch in ("tinyllama_1p1b", "recurrentgemma_2b", "whisper_small",
                 "mixtral_8x22b"):
        defs = t_zoo.model_defs(t_get(arch).reduced())
        assert golden.defs_digest(defs, 21) == golden.weights_digest(
            golden.golden_weights(defs, 21))


@pytest.mark.parametrize("name", list(golden.LM_ZOO))
def test_golden_zoo_digests_reproduce(name):
    """Each ``golden_lm_zoo.json`` entry was computed on the inputs
    (tokens, stub frames or patch embeddings) and the weights that the
    counter-based draws give here, so the card rebuilds the same; the
    record holds every step's top-k logits per row, and the MoE entry
    every layer call's expert choices, router logits and near ties (those
    of ``golden.route_near_ties`` at today's margin), its choices the
    first-index top-k of its logits."""
    rec = golden.load_lm_zoo()[name]
    spec = golden.LM_ZOO[name]
    assert rec["spec"] == spec
    cfg = golden.zoo_config(t_get(spec["config"]), spec)
    assert rec["n_layers"] == cfg.n_layers
    batch, dec = golden.zoo_inputs(cfg, spec)
    assert batch["tokens"].shape == (spec["batch"], spec["prompt"])
    assert golden.inputs_digest(batch, dec) == rec["inputs_digest"]
    assert golden.defs_digest(t_zoo.model_defs(cfg), spec["seed"]) \
        == rec["weights_digest"]
    assert len(rec["steps"]) == spec["steps"] + 1
    assert all(len(s["top_logits"]) == spec["batch"]
               and len(s["top_logits"][0]) == spec["top_k"]
               for s in rec["steps"])
    if cfg.family == "moe":
        assert len(rec["routing"]) == spec["steps"] + 1
        assert all(len(step) == cfg.n_layers for step in rec["routing"])
        first = rec["routing"][0][0]
        assert np.asarray(first["eidx"]).shape == (spec["batch"],
                                                   spec["prompt"], cfg.top_k)
        for step in rec["routing"]:
            for call in step:
                logits = torch.tensor(call["logits"])
                assert logits.shape[-1] == cfg.n_experts
                near = golden.route_near_ties(logits, cfg.top_k)
                assert torch.nonzero(near.reshape(-1)).reshape(-1).tolist() \
                    == call["near_ties"]
                _, eidx = t_layers.top_k_first(torch.softmax(logits, -1),
                                               cfg.top_k)
                assert eidx.tolist() == call["eidx"]
