"""The MoE family of the PyTorch port (mixtral, phi3.5-moe) against
``repro``.

Small sizes on the CPU, numpy-seeded inputs through both packages:

* the router: ``layers.top_k_first`` against ``jax.lax.top_k`` on rows
  full of ties (first index wins); ``moe_route``'s expert choice equal to
  ``repro``'s wherever ``repro``'s probabilities leave a margin above
  the rounding bound between the chosen experts and the next;
* ``moe_apply`` on the same bf16 ``x`` and weights: the output within
  bf16 limits on every token whose routing is equal, the aux loss, and a
  router biased so that one expert's queue overflows its capacity (the
  drops are ``repro``'s);
* the reduced mixtral (window 32) and phi3.5-moe through ``prefill_fn``
  and four ``decode_fn`` steps against ``repro`` with
  ``RunFlags(attn_impl="pallas")``; ``forward``'s aux loss;
* the reduced mixtral on the card against its plain path on the CPU
  (``cuda``, skips without a card).

Tolerances.  The router's logits are a bf16 product: the two packages
may round a logit one bf16 ulp apart (their sums run in other orders),
so the order of two experts can flip only where their logits lie within
the sum of their two ulps (``_clear``), and a probability moves by at
most ~2 ulps of its logit (``PROB_TOL``).  The outputs, logits and caches
(|x| < 4) agree to ``LM_TOL`` = 0.0625, four bf16 ulps, as
``tests/test_torch_lm.py``; one layer's aux loss to 1e-5, the
forward's (its second layer on inputs that differ in bf16 rounding) to
2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get as j_get  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import params as j_params  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402

PALLAS = j_lm.RunFlags(attn_impl="pallas")
LM_TOL = 0.0625
#: how far a routing probability can move when each logit (|l| < 4)
#: moves by a bf16 ulp: ~2 ulps at |l| < 4
PROB_TOL = 2 * 2.0 ** -6
MOE_ARCHS = ["mixtral_8x22b", "phi3p5_moe_42b"]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(
        torch.bfloat16)


def _cfgs(arch="mixtral_8x22b"):
    return j_get(arch).reduced(), t_get(arch).reduced()


def _moe_inputs(cfgj, S, seed, bias=0.0):
    """``repro``'s random MoE weights and a bf16 ``x`` [2, S, d] (numpy
    seeded), as JAX and torch trees; ``bias`` > 0 pulls every token
    towards expert 0."""
    pj = j_params.init_params(j_layers.moe_defs(cfgj),
                              jax.random.PRNGKey(seed), jnp.bfloat16)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S, cfgj.d_model)).astype(np.float32)
    if bias:
        x[..., :8] += 1.0
        r = np.array(pj["router"].astype(jnp.float32))
        r[:8, 0] = bias
        pj["router"] = jnp.asarray(r, jnp.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    pt = jax.tree_util.tree_map(_t, pj)
    return pj, pt, xj, _t(xj)


def _repro_route(pj, xj, cfgj):
    """``repro``'s router: ``(probs, eidx, logits)``, numpy."""
    logits = (xj @ pj["router"].astype(xj.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, -1)
    _, eidx = jax.lax.top_k(probs, cfgj.top_k)
    return np.asarray(probs), np.asarray(eidx), np.asarray(logits)


def _bf16_ulp(x):
    """The bf16 ulp at each |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _clear(logits, k):
    """Tokens whose top-k set and order cannot flip under a one-ulp
    rounding of each logit: each of the sorted logits' first k gaps wider
    than the two neighbours' ulps together."""
    s = -np.sort(-logits, -1)
    gaps = [(s[..., j] - s[..., j + 1])
            > _bf16_ulp(s[..., j]) + _bf16_ulp(s[..., j + 1])
            for j in range(k)]
    return np.logical_and.reduce(gaps)


# ------------------------------------------------------------- router

def test_top_k_first_breaks_ties_to_the_lower_index():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (500, 8)).astype(np.float32)   # many ties
    vals, idx = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = t_layers.top_k_first(torch.from_numpy(x), 3)
    assert np.array_equal(ti.numpy(), np.asarray(idx))
    assert np.array_equal(tv.numpy(), np.asarray(vals))


def test_route_matches_repro_beyond_the_margin():
    cfgj, cfgt = _cfgs()
    pj, pt, xj, xt = _moe_inputs(cfgj, 96, seed=1)
    probs_j, eidx_j, logits_j = _repro_route(pj, xj, cfgj)
    probs, gate, eidx, pos = t_layers.moe_route(pt, xt, cfgt)
    np.testing.assert_allclose(probs.numpy(), probs_j, atol=PROB_TOL,
                               rtol=0)
    clear = _clear(logits_j, cfgj.top_k)
    assert clear.mean() > 0.9
    assert np.array_equal(eidx.numpy()[clear], eidx_j[clear])
    np.testing.assert_allclose(gate.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_capacity_positions_follow_the_row_cumsum():
    """Slot positions count earlier slots of the same expert in token
    then slot order; capacity ``capacity_factor * k * S / E`` rounded up
    to a multiple of 8, at least 8."""
    cfgj, cfgt = _cfgs()
    for S in (1, 16, 64, 300):
        cap = int(cfgj.capacity_factor * cfgj.top_k * S / cfgj.n_experts
                  + 0.5)
        assert t_layers.moe_capacity(cfgt, S) == max(8, -(-cap // 8) * 8)
    _, pt, _, xt = _moe_inputs(cfgj, 40, seed=2)
    _, _, eidx, pos = t_layers.moe_route(pt, xt, cfgt)
    flat_e, flat_p = eidx.reshape(2, -1), pos.reshape(2, -1)
    for b in range(2):
        seen = {}
        for e, p in zip(flat_e[b].tolist(), flat_p[b].tolist()):
            assert p == seen.get(e, 0)
            seen[e] = p + 1


# ----------------------------------------------------------- moe_apply

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_repro(arch):
    cfgj, cfgt = _cfgs(arch)
    pj, pt, xj, xt = _moe_inputs(cfgj, 48, seed=3)
    yj, aj = j_layers.moe_apply(pj, xj, cfgj)
    yt, at = t_layers.moe_apply(pt, xt, cfgt)
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == yj.shape
    probs_j, eidx_j, _ = _repro_route(pj, xj, cfgj)
    same = (t_layers.moe_route(pt, xt, cfgt)[2].numpy() == eidx_j).all(-1)
    assert same.mean() > 0.9
    np.testing.assert_allclose(_f32(yt)[same], _f32(yj)[same], atol=LM_TOL,
                               rtol=0)
    assert at.dtype == torch.float32
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


def test_capacity_drops_match_repro():
    """A router pulled towards expert 0: its queue of ``S`` slots a row
    overflows ``cap``, and the ``S - cap`` later tokens of each row keep
    only their second expert's output, as in ``repro``."""
    cfgj, cfgt = _cfgs()
    S = 64
    pj, pt, xj, xt = _moe_inputs(cfgj, S, seed=4, bias=3.0)
    probs_j, eidx_j, _ = _repro_route(pj, xj, cfgj)
    _, _, eidx, pos = t_layers.moe_route(pt, xt, cfgt)
    cap = t_layers.moe_capacity(cfgt, S)
    assert (eidx_j[..., 0] == 0).all()
    assert np.array_equal(eidx.numpy(), eidx_j)
    dropped = (pos >= cap).any(-1)
    assert int(dropped.sum()) == 2 * (S - cap)
    yj, _ = j_layers.moe_apply(pj, xj, cfgj)
    yt, _ = t_layers.moe_apply(pt, xt, cfgt)
    np.testing.assert_allclose(_f32(yt), _f32(yj), atol=LM_TOL, rtol=0)


# ---------------------------------------------- prefill and decode

@pytest.fixture(scope="module")
def served():
    """``repro`` (pallas, interpret mode) and the port on each reduced MoE
    config: the same weights, a 40-token prompt and four decode inputs;
    the logits and caches after prefill and after each step."""
    out = {}
    for arch in MOE_ARCHS:
        cfgj, cfgt = _cfgs(arch)
        params = j_zoo.init_model(cfgj, seed=0)
        model = convert.from_repro(jax.tree_util.tree_map(np.asarray,
                                                          params), cfgt,
                                   device="cpu")
        rng = np.random.default_rng(11)
        B, S, T = 2, 40, 4
        prompt = rng.integers(0, cfgj.vocab_size, (B, S)).astype(np.int32)
        dec = rng.integers(0, cfgj.vocab_size, (T, B)).astype(np.int32)
        jl, jc = j_zoo.prefill_fn(params, {"tokens": jnp.asarray(prompt)},
                                  cfgj, max_len=S + T, flags=PALLAS)
        tl, tc = t_zoo.prefill_fn(model, {"tokens": torch.from_numpy(
            prompt)}, cfgt, max_len=S + T)
        rows = [(jl, jc, tl, {k: v.clone() for k, v in tc.items()})]
        for t in range(T):
            jl, jc = j_zoo.decode_fn(params, jc, jnp.asarray(dec[t]), cfgj,
                                     flags=PALLAS)
            tl, tc = t_zoo.decode_fn(model, tc, torch.from_numpy(dec[t]),
                                     cfgt)
            rows.append((jl, jc, tl, {k: v.clone() for k, v in tc.items()}))
        out[arch] = rows
    return out


@pytest.mark.parametrize("step", range(5), ids=["prefill", "decode1",
                                                "decode2", "decode3",
                                                "decode4"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_aux_loss_matches_repro(arch):
    cfgj, cfgt = _cfgs(arch)
    params = j_zoo.init_model(cfgj, seed=1)
    model = convert.from_repro(jax.tree_util.tree_map(np.asarray, params),
                               cfgt, device="cpu")
    tokens = np.random.default_rng(5).integers(
        0, cfgj.vocab_size, (2, 24)).astype(np.int32)
    xj, aj = j_lm.forward(params, jnp.asarray(tokens), cfgj, PALLAS)
    xt, at = t_lm.forward(model, torch.from_numpy(tokens), cfgt)
    np.testing.assert_allclose(_f32(xt), _f32(xj), atol=LM_TOL, rtol=0)
    assert float(at) > 0
    # the second layer routes the first's bf16 output, which differs by
    # bf16 roundings: its mean probabilities move by ~1e-4 of themselves
    # (a flipped top-1 choice would move the sum by ~1 / (B S) = 2 %)
    np.testing.assert_allclose(float(at), float(aj), rtol=2e-3)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_moe.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_moe_serving_on_the_card_matches_the_cpu(cuda):
    """The reduced mixtral through ``prefill_fn`` and three ``decode_fn``
    steps on the card against the same model's plain path on the CPU."""
    _, cfg = _cfgs()
    model = t_zoo.init_model(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40)))
    outs = {}
    for dev in ("cpu", cuda):
        m = model.to(dev)
        logits, cache = t_zoo.prefill_fn(m, {"tokens": tokens.to(dev)}, cfg,
                                         max_len=48)
        got = [logits.float().cpu()]
        for t in range(3):
            logits, cache = t_zoo.decode_fn(
                m, cache, torch.full((2,), t + 5, device=dev), cfg)
            got.append(logits.float().cpu())
        outs[str(dev)] = got
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        torch.testing.assert_close(b, a, atol=LM_TOL, rtol=0)
