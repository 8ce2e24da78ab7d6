"""The hybrid family of the PyTorch port (recurrentgemma: RG-LRU blocks
and local attention) against ``repro``.

Small sizes on the CPU, numpy-seeded inputs through both packages:

* the recurrence: the plain scan ``ref.rglru_scan_ref`` (which forms the
  gated input ``g = ref.gated(a, x)`` itself) bit for bit against
  ``repro``'s scan on the same ``a`` and ``g``, through ``repro``'s own
  ``rglru_block_apply`` (its gates replaced by the test's ``a`` and
  ``g``; the final ``h`` of prompts of 1 to 300 steps, across a padded
  256-step chunk) and against XLA's ``a * h + g`` step; ``fma_f32``
  against XLA's contracted multiply-add;
* the kernel's function, ``ref.rglru_gated_scan_ref`` (the gates from the
  gate GEMMs' outputs, then the scan), bit for bit against the
  composition it replaced in the block (``_gates`` returning ``a`` and
  ``i * u``, then ``rglru_scan_ref``), saturating gates included;
* the block's parts (``_gates`` + ``ref.gate_inputs``,
  ``rglru_block_apply`` with its state, ``rglru_decode_step``) on the
  same bf16 inputs and weights;
* the reduced recurrentgemma (d 64, rec / rec / attn, hd 16, MQA, local
  window 32) through ``prefill_fn`` on a 40-token prompt (the ring
  wraps) and four ``decode_fn`` steps against ``repro`` with
  ``RunFlags(attn_impl="pallas")``, weights carried by ``convert``; the
  port's own prefill + decode against its forward; a prompt shorter than
  ``ssm_conv - 1`` refused (ROADMAP.md, Queue 3, fault 2);
* the launcher's C signature, its refusal of CPU tensors and of inputs
  its TMA tiles cannot read; the CUDA kernel bit for bit against its
  plain version (``cuda``, skips without a card).

Tolerances.  The scan is exact (one rounded FMA a step in both).  The
gates go through f32 ``exp`` and ``sqrt``, which XLA computes to within
an ulp of the correctly rounded value that PyTorch gives (~10 % and
~0.5 % of values differ by that ulp), so ``a``, the gated input and
``h`` agree to ``F32_TOL`` = 1e-5 relative, and the bf16 values (block
outputs, logits, conv states, caches) to a few bf16 ulps: ``LM_TOL`` =
0.0625 at |x| < 4, as ``tests/test_torch_lm.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get as j_get  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import params as j_params  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as rk  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as ro  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as rr  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import rglru as t_rglru  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402
from repro_torch.models.layers import sigmoid as t_sigmoid  # noqa: E402
from repro_torch.models.ssm import _softplus as t_softplus  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma_2b"
PALLAS = j_lm.RunFlags(attn_impl="pallas")
LM_TOL = 0.0625
F32_TOL = 1e-5


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_pair(rng, shape, scale=1.0):
    j = jnp.asarray(rng.normal(size=shape) * scale, jnp.float32).astype(
        jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _cfgs():
    return j_get(ARCH).reduced(), t_get(ARCH).reduced()


def _scan_inputs(B, S, d, seed=0):
    """``a`` in (0.5, 1), 1 in channel 0 (where ``1 - a * a`` is clamped
    to 1e-9), and ``x`` ~ 0.3 N(0, 1), f32 numpy."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, S, d)).astype(np.float32)
    a[..., 0] = 1.0
    return a, (rng.normal(size=(B, S, d)) * 0.3).astype(np.float32)


def _gate_case(B, S, d, seed=0):
    """The kernel's inputs, CPU tensors: ``r_pre``, ``i_pre`` ~ 2 N(0, 1)
    and ``u`` ~ N(0, 1) in bf16, ``nsp = -8 softplus(lam)`` for ``lam`` ~
    U(-1, 2) (f32), ``h0`` ~ 0.5 N(0, 1); channel 1 saturates ``r`` to 0
    (``r_pre`` = -120: ``a = 1``, ``1 - a * a`` clamped to 1e-9), channel
    2 saturates ``i`` to 1 (``i_pre`` = 110)."""
    rng = np.random.default_rng(seed)
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    r_pre = rng.normal(size=(B, S, d)) * 2
    i_pre = rng.normal(size=(B, S, d)) * 2
    r_pre[..., 1] = -120.0
    i_pre[..., 2] = 110.0
    lam = torch.from_numpy(rng.uniform(-1, 2, d).astype(np.float32))
    nsp = -8.0 * t_softplus(lam)
    h0 = torch.from_numpy((rng.normal(size=(B, d)) * 0.5).astype(np.float32))
    return (bf(r_pre), bf(i_pre), bf(rng.normal(size=(B, S, d))), nsp,
            h0), lam


def _former_gates(r_pre, i_pre, u, lam):
    """The block's gates as the port computed them before the kernel took
    them in: ``models.rglru._gates`` after its two GEMMs, returning ``a``
    and ``i * u`` (f32) for ``rglru_scan_ref``."""
    r = t_sigmoid(r_pre)
    i = t_sigmoid(i_pre)
    log_a = (-8.0 * t_softplus(lam.float())) * r.float()
    return torch.exp(log_a), (i * u).float()


# ------------------------------------------------------------ the scan

def test_fma_equals_xlas_contracted_multiply_add():
    rng = np.random.default_rng(0)
    x, y, z = (rng.normal(size=200_000).astype(np.float32) * s
               for s in (1.0, 1.0, 1e-3))
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(x, y, z))
    got = rr.fma_f32(*map(torch.from_numpy, (x, y, z))).numpy()
    assert np.array_equal(got, want)
    # two roundings differ somewhere: the test can tell them apart
    two = (torch.from_numpy(x) * torch.from_numpy(y)
           + torch.from_numpy(z)).numpy()
    assert not np.array_equal(two, want)


def test_fma_settles_halfway_cases_by_the_exact_sum():
    """Where the f64 sum falls exactly halfway between two f32 values,
    the exact sum's tail decides the side (one rounding, not two)."""
    one = torch.ones(1)
    # 1 + 2^-24 is halfway between 1 and 1 + 2^-23; a product 2^-24 +
    # 2^-60 (exact in f64 as a product, not after the add) tips it up
    a = torch.tensor([2.0 ** -12 + 2.0 ** -35], dtype=torch.float32)
    b = torch.tensor([2.0 ** -12], dtype=torch.float32)
    got = rr.fma_f32(a, b, one)
    assert float(got) == 1.0 + 2.0 ** -23
    assert float(rr.fma_f32(a, -b, one)) == 1.0 - 2.0 ** -24
    assert float(rr.fma_f32(b, b, one)) == 1.0     # a true tie: to even


def test_gate_factor_rounds_as_xlas_contracted_one_minus_a_squared():
    """``ref.gated``'s ``1 - a * a`` is XLA's (one FMA), bit for bit; the
    clamp at 1e-9 where ``a`` is 1."""
    a, x = _scan_inputs(1, 64, 512, seed=9)
    want = np.asarray(jax.jit(lambda a: jnp.maximum(1.0 - a * a, 1e-9))(a))
    one = torch.ones(())
    got = torch.clamp_min(rr.fma_f32(-torch.from_numpy(a),
                                     torch.from_numpy(a), one), 1e-9)
    assert np.array_equal(got.numpy(), want)
    assert np.all(want[..., 0] == np.float32(1e-9))
    g = rr.gated(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    assert np.array_equal(g, x * np.sqrt(want))


@pytest.mark.parametrize("S", [1, 7, 256, 300])
def test_plain_scan_is_repros_scan_bitwise(S, monkeypatch):
    """``repro``'s ``rglru_block_apply`` with its gates replaced by the
    test's ``a`` and ``g = ref.gated(a, x)``: its final ``h`` (256-step
    chunks, the last padded with a = 1, g = 0) equals the plain scan's of
    ``a`` and ``x`` bit for bit."""
    cfgj, _ = _cfgs()
    B, d = 2, cfgj.d_model
    a, x_in = _scan_inputs(B, S, d, seed=S)
    g = rr.gated(torch.from_numpy(a), torch.from_numpy(x_in)).numpy()
    monkeypatch.setattr(j_rglru, "_gates",
                        lambda p, u: (jnp.asarray(a), jnp.asarray(g)))
    p = j_params.init_params(j_rglru.rglru_defs(cfgj), jax.random.PRNGKey(0),
                             jnp.bfloat16)
    x = jnp.zeros((B, S, d), jnp.bfloat16)
    _, st = jax.jit(lambda p, x: j_rglru.rglru_block_apply(
        p, x, cfgj, return_state=True))(p, x)
    h_seq, h_n = rr.rglru_scan_ref(torch.from_numpy(a),
                                   torch.from_numpy(x_in), torch.zeros(B, d))
    assert h_seq.dtype == h_n.dtype == torch.float32
    assert torch.equal(h_seq[:, -1], h_n)
    assert np.array_equal(h_n.numpy(), np.asarray(st["h"]))

    def step(hh, ig):
        aa, gg = ig
        hh = aa * hh + gg
        return hh, hh
    hj, ys = jax.jit(lambda a, g: jax.lax.scan(
        step, jnp.zeros((B, d), jnp.float32),
        (a.transpose(1, 0, 2), g.transpose(1, 0, 2))))(a, g)
    assert np.array_equal(h_seq.numpy(), np.asarray(ys).transpose(1, 0, 2))
    assert np.array_equal(h_n.numpy(), np.asarray(hj))


def test_scan_carries_h0():
    """The dispatch (its plain version on CPU tensors) over 9 steps equals
    4 steps and then 5 from their ``h_S``."""
    (r_pre, i_pre, u, nsp, h0), _ = _gate_case(1, 9, 16, seed=3)
    cut = lambda t, sl: t[:, sl].contiguous()
    before = ro.launches
    full, hn = ro.rglru_scan(r_pre, i_pre, u, nsp, h0)
    first, h4 = ro.rglru_scan(*(cut(t, slice(0, 4)) for t in
                                (r_pre, i_pre, u)), nsp, h0)
    rest, hn2 = ro.rglru_scan(*(cut(t, slice(4, None)) for t in
                                (r_pre, i_pre, u)), nsp, h4)
    assert ro.launches == before            # the CPU runs no kernel
    assert torch.equal(torch.cat([first, rest], 1), full)
    assert torch.equal(hn, hn2)


@pytest.mark.parametrize("S", [1, 7, 300])
def test_gated_scan_ref_is_the_composition_it_replaces(S):
    """``ref.rglru_gated_scan_ref`` equals the block's former path (its
    gates before the kernel took them in, then ``rglru_scan_ref``) bit for
    bit, from ``h0 != 0``; the saturating channels give ``a = 1`` (the
    clamp) and ``i = 1``."""
    (r_pre, i_pre, u, nsp, h0), lam = _gate_case(2, S, 64, seed=20 + S)
    got_seq, got_n = rr.rglru_gated_scan_ref(r_pre, i_pre, u, nsp, h0)
    a, x = _former_gates(r_pre, i_pre, u, lam)
    want_seq, want_n = rr.rglru_scan_ref(a, x, h0)
    assert got_seq.dtype == got_n.dtype == torch.float32
    assert torch.equal(got_seq, want_seq) and torch.equal(got_n, want_n)
    ga, gx = rr.gate_inputs(r_pre, i_pre, u, nsp)
    assert torch.equal(ga, a) and torch.equal(gx, x)
    assert bool((a[..., 1] == 1).all())                 # r = 0
    assert torch.equal(rr.gated(a, x)[..., 1],
                       x[..., 1] * np.float32(np.sqrt(np.float32(1e-9))))
    assert torch.equal(x[..., 2], u[..., 2].float())    # i = 1


# ----------------------------------------------------------- the block

@pytest.fixture(scope="module")
def block_params():
    """``repro``'s random bf16 weights of one RG-LRU block (``lam`` and
    ``conv_b`` moved off their constant inits), and the port's copy."""
    cfgj, _ = _cfgs()
    pj = j_params.init_params(j_rglru.rglru_defs(cfgj),
                              jax.random.PRNGKey(5), jnp.bfloat16)
    rng = np.random.default_rng(6)
    d = cfgj.d_model
    pj["lam"] = jnp.asarray(rng.uniform(-1, 2, d), jnp.bfloat16)
    pj["conv_b"] = jnp.asarray(rng.normal(size=d) * 0.1, jnp.bfloat16)
    pt = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16), pj)
    return pj, pt


def test_gates_match_repro(block_params):
    cfgj, _ = _cfgs()
    pj, pt = block_params
    uj, ut = _bf16_pair(np.random.default_rng(7), (2, 9, cfgj.d_model))
    aj, gj = j_rglru._gates(pj, uj)
    r_pre, i_pre, nsp = t_rglru._gates(pt, ut)
    assert r_pre.dtype == i_pre.dtype == torch.bfloat16
    at, iut = rr.gate_inputs(r_pre, i_pre, ut, nsp)
    gt = rr.gated(at, iut)
    assert at.dtype == iut.dtype == gt.dtype == torch.float32
    np.testing.assert_allclose(_f32(at), _f32(aj), rtol=F32_TOL, atol=0)
    np.testing.assert_allclose(_f32(gt), _f32(gj), rtol=F32_TOL,
                               atol=F32_TOL)


def test_block_gates_feed_the_scan_as_before(block_params):
    """The block's new gates (``_gates``: the GEMMs and ``nsp``) through
    ``rglru_gated_scan_ref`` equal its former ``_gates`` (``a``, ``i *
    u``) through ``rglru_scan_ref``, on the block's weights."""
    cfgj, _ = _cfgs()
    _, pt = block_params
    _, ut = _bf16_pair(np.random.default_rng(12), (2, 30, cfgj.d_model))
    h0 = torch.from_numpy(np.random.default_rng(13).normal(
        size=(2, cfgj.d_model)).astype(np.float32))
    r_pre, i_pre, nsp = t_rglru._gates(pt, ut)
    got = rr.rglru_gated_scan_ref(r_pre, i_pre, ut, nsp, h0)
    want = rr.rglru_scan_ref(*_former_gates(r_pre, i_pre, ut, pt["lam"]),
                             h0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("S", [3, 20])
def test_block_matches_repro(block_params, S):
    cfgj, cfgt = _cfgs()
    pj, pt = block_params
    xj, xt = _bf16_pair(np.random.default_rng(8 + S), (2, S, cfgj.d_model))
    yj, sj = j_rglru.rglru_block_apply(pj, xj, cfgj, chunk=8,
                                       return_state=True)
    before = ro.launches
    yt, st = t_rglru.rglru_block_apply(pt, xt, cfgt, return_state=True)
    assert ro.launches == before            # the CPU runs no kernel
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == yj.shape
    np.testing.assert_allclose(_f32(yt), _f32(yj), atol=LM_TOL, rtol=0)
    np.testing.assert_allclose(_f32(st["conv"]), _f32(sj["conv"]),
                               atol=LM_TOL, rtol=0)
    assert st["h"].dtype == torch.float32
    np.testing.assert_allclose(_f32(st["h"]), _f32(sj["h"]), atol=1e-3,
                               rtol=1e-3)
    yn = t_rglru.rglru_block_apply(pt, xt, cfgt)
    assert torch.equal(yn, yt)


def test_decode_step_matches_repro(block_params):
    cfgj, cfgt = _cfgs()
    pj, pt = block_params
    rng = np.random.default_rng(9)
    xj, xt = _bf16_pair(rng, (2, 1, cfgj.d_model))
    cj, ct = _bf16_pair(rng, (2, 3, cfgj.d_model))
    h = (rng.normal(size=(2, cfgj.d_model)) * 0.5).astype(np.float32)
    yj, sj = j_rglru.rglru_decode_step(pj, xj, {"conv": cj,
                                                "h": jnp.asarray(h)}, cfgj)
    yt, st = t_rglru.rglru_decode_step(pt, xt, {"conv": ct,
                                                "h": torch.from_numpy(h)},
                                       cfgt)
    np.testing.assert_allclose(_f32(yt), _f32(yj), atol=LM_TOL, rtol=0)
    assert torch.equal(st["conv"], torch.cat([ct, _conv_in(pt, xt)], 1)[:, 1:])
    np.testing.assert_allclose(_f32(st["h"]), _f32(sj["h"]), atol=1e-4,
                               rtol=1e-4)


def _conv_in(p, x):
    return x @ p["in_x"].to(x.dtype)


def test_init_state_matches_repro():
    cfgj, cfgt = _cfgs()
    sj = j_rglru.rglru_init_state(cfgj, 3)
    st = t_rglru.rglru_init_state(cfgt, 3, "cpu")
    for key in ("conv", "h"):
        assert tuple(st[key].shape) == sj[key].shape
        assert not bool(st[key].any())
    assert st["conv"].dtype == torch.bfloat16
    assert st["h"].dtype == torch.float32


# ---------------------------------------------- prefill and decode

def _tree_clone(c):
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone()
            for k, v in c.items()}


@pytest.fixture(scope="module")
def served():
    """``repro`` (pallas, interpret mode) and the port on the reduced
    recurrentgemma, the same weights, a 40-token prompt (longer than the
    32-slot local window, so the ring wraps) and four decode inputs: the
    logits and caches after prefill and after each step."""
    cfgj, cfgt = _cfgs()
    params = j_zoo.init_model(cfgj, seed=0)
    model = convert.from_repro(jax.tree_util.tree_map(np.asarray, params),
                               cfgt, device="cpu")
    rng = np.random.default_rng(11)
    B, S, T = 2, 40, 4
    prompt = rng.integers(0, cfgj.vocab_size, (B, S)).astype(np.int32)
    dec = rng.integers(0, cfgj.vocab_size, (T, B)).astype(np.int32)
    jl, jc = j_zoo.prefill_fn(params, {"tokens": jnp.asarray(prompt)}, cfgj,
                              max_len=S + T, flags=PALLAS)
    tl, tc = t_zoo.prefill_fn(model, {"tokens": torch.from_numpy(prompt)},
                              cfgt, max_len=S + T)
    rows = [(jl, jc, tl, _tree_clone(tc))]
    for t in range(T):
        jl, jc = j_zoo.decode_fn(params, jc, jnp.asarray(dec[t]), cfgj,
                                 flags=PALLAS)
        tl, tc = t_zoo.decode_fn(model, tc, torch.from_numpy(dec[t]), cfgt)
        rows.append((jl, jc, tl, _tree_clone(tc)))
    return rows


@pytest.mark.parametrize("step", range(5), ids=["prefill", "decode1",
                                                "decode2", "decode3",
                                                "decode4"])
def test_serving_matches_repro(served, step):
    jl, jc, tl, tc = served[step]
    cfgj, _ = _cfgs()
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LM_TOL, rtol=0)
    assert tc["k"].shape[2] == cfgj.local_window     # the ring wrapped
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]),
                                   atol=LM_TOL, rtol=0)
    assert np.array_equal(tc["kv_pos"].numpy(), np.asarray(jc["kv_pos"]))
    np.testing.assert_allclose(_f32(tc["rec"]["conv"]),
                               _f32(jc["rec"]["conv"]), atol=LM_TOL, rtol=0)
    np.testing.assert_allclose(_f32(tc["rec"]["h"]), _f32(jc["rec"]["h"]),
                               atol=LM_TOL, rtol=0)
    assert int(tc["pos"]) == int(jc["pos"])


def test_layers_write_only_their_own_cache(served):
    """A rec layer's ring stays zero with ``kv_pos`` -1, an attn layer's
    recurrent state stays at ``rglru_init_state``, as ``repro``'s two
    branches leave them."""
    cfgj, _ = _cfgs()
    _, jc, _, tc = served[-1]
    for i, kind in enumerate(j_lm.layer_types(cfgj)):
        if kind == "rec":
            assert not bool(tc["k"][i].any()) and not bool(tc["v"][i].any())
            assert bool((tc["kv_pos"][i] == -1).all())
            assert bool(tc["rec"]["h"][i].any())
        else:
            assert not bool(tc["rec"]["h"][i].any())
            assert not bool(tc["rec"]["conv"][i].any())
            assert bool((tc["kv_pos"][i] >= 0).all())


def test_prefill_decode_matches_forward():
    """The port's own prefill + one decode step equal its full forward's
    last position (``tests/test_models.py``'s check, rel < 0.05)."""
    _, cfg = _cfgs()
    model = t_zoo.init_model(cfg, seed=0, device="cpu")
    B, S = 2, 37
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)))
    x, aux = t_lm.forward(model, tokens, cfg)
    full = t_lm.logits_fn(model, x[:, -1:], cfg)[:, 0].float()
    _, cache = t_zoo.prefill_fn(model, {"tokens": tokens[:, :S - 1]}, cfg,
                                max_len=S + 4)
    ld, cache2 = t_zoo.decode_fn(model, cache, tokens[:, S - 1], cfg)
    rel = float((full - ld.float()).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 0.05, rel
    assert int(cache2["pos"]) == S and float(aux) == 0.0


def test_short_prompt_raises_naming_the_limit():
    """``repro``'s prefill fails on a prompt shorter than ``ssm_conv -
    1``: the rec branch keeps a conv state of ``S`` rows, the attn
    branch ``kc - 1``, and ``lax.cond`` refuses branches of unequal
    types (ROADMAP.md, Queue 3, fault 2); the port refuses the prompt
    with a ``ValueError`` naming the limit."""
    cfgj, cfg = _cfgs()
    params = j_zoo.init_model(cfgj, seed=0)
    with pytest.raises(TypeError, match="cond"):
        j_zoo.prefill_fn(params, {"tokens": jnp.zeros((2, 2), jnp.int32)},
                         cfgj, max_len=16, flags=PALLAS)
    model = t_zoo.init_model(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="ssm_conv - 1 = 3"):
        t_zoo.prefill_fn(model, {"tokens": torch.zeros((2, 2),
                                                       dtype=torch.long)},
                         cfg, max_len=16)
    _, cache = t_zoo.prefill_fn(model, {"tokens": torch.zeros(
        (2, 3), dtype=torch.long)}, cfg, max_len=16)
    assert cache["rec"]["conv"].shape == (cfg.n_layers, 2, 3, cfg.d_model)


# ----------------------------------------------------- launcher binding

def test_launch_arguments_match_the_cuda_source(monkeypatch):
    """kernel.py's ctypes signature has the C launcher's arity and kinds
    (int / pointer), read from the source."""
    import ctypes

    from repro_torch import _build
    src = (ROOT / "src" / "repro_torch" / "kernels" / "rglru_scan" / "csrc"
           / "rglru_scan.cu").read_text()
    sig = re.search(r"int rglru_scan_launch\(([^)]*)\)", src).group(1)
    want = ["pointer" if "*" in p else " ".join(p.split()[:-1])
            for p in sig.split(",")]

    class Fake:
        def __getattr__(self, name):
            f = type("F", (), {})()
            setattr(self, name, f)
            return f

    fake = Fake()
    monkeypatch.setattr(_build, "load", lambda name, csrc: fake)
    rk.library.cache_clear()
    try:
        rk.library()
        argtypes = fake.rglru_scan_launch.argtypes
    finally:
        rk.library.cache_clear()
    assert [{ctypes.c_int: "int"}.get(a, "pointer")
            for a in argtypes] == want


def test_launcher_refuses_cpu_tensors_and_the_dispatch_other_devices():
    args, _ = _gate_case(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rk.rglru_scan(*args)
    # meta tensors (the dry run) take the meta path: the kernel's shapes,
    # no launch (tests/test_torch_dryrun.py holds its counts)
    before = ro.launches
    h_seq, h_n = ro.rglru_scan(*(t.to("meta") for t in args))
    want = rr.rglru_gated_scan_ref(*args)
    assert ro.launches == before
    for got, w in zip((h_seq, h_n), want):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (w.shape, w.dtype)


def _misaligned(t):
    """A contiguous copy of ``t`` starting 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case", ["f32 r_pre", "bf16 nsp", "d 12",
                                  "misaligned u", "strided i_pre",
                                  "h0 shape"])
def test_launcher_refuses_what_its_tma_tiles_cannot_read(case):
    """The launcher refuses each input the kernel does not take, naming
    it, before it looks at the device."""
    d = 12 if case == "d 12" else 16
    (r_pre, i_pre, u, nsp, h0), _ = _gate_case(2, 5, d)
    if case == "f32 r_pre":
        r_pre, match = r_pre.float(), "r_pre"
    elif case == "bf16 nsp":
        nsp, match = nsp.to(torch.bfloat16), "nsp"
    elif case == "d 12":
        match = "multiple of 8"
    elif case == "misaligned u":
        u, match = _misaligned(u), "u does not start 16-byte"
    elif case == "strided i_pre":
        i_pre, match = i_pre.transpose(0, 1).contiguous().transpose(0, 1), \
            "i_pre"
    else:
        h0, match = h0[:1], "h0"
    with pytest.raises(ValueError, match=match):
        rk.rglru_scan(r_pre, i_pre, u, nsp, h0)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_rglru.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 64), (1, 1, 2560), (2, 9, 296),
                                   (3, 1000, 2560)], ids=str)
def test_rglru_scan_kernel_matches_plain(cuda, shape):
    """bf16 gate inputs (saturating channels included) through the kernel
    and through its plain version on the card: ``h`` bit for bit (296
    channels: a block past ``d``; S 9, 300, 1 000: tiles past ``S``)."""
    B, S, d = shape
    args, _ = _gate_case(B, S, d, seed=1)
    args = [t.to(cuda) for t in args]
    before = ro.launches
    h_seq, h_n = ro.rglru_scan(*args)
    assert ro.launches == before + 1
    want_seq, want_n = rr.rglru_gated_scan_ref(*args)
    assert torch.equal(h_seq, want_seq) and torch.equal(h_n, want_n)


@pytest.mark.cuda
def test_rglru_scan_kernel_covers_every_bf16_gate_input(cuda):
    """Every non-NaN bf16 value as ``r_pre`` and, shuffled, as ``i_pre``
    (so every value the sigmoids' reciprocal meets, inf included): ``h``
    bit for bit against the plain version on the card."""
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32)
    nan = ((bits & 0x7F80) == 0x7F80) & ((bits & 0x7F) != 0)
    vals = torch.where(nan, 0, bits).to(torch.int16).view(torch.bfloat16)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(2**16))
    (_, _, u, nsp, h0), _ = _gate_case(2, 1024, 32, seed=6)
    args = [t.to(cuda) for t in (vals.reshape(2, 1024, 32),
                                 vals[perm].reshape(2, 1024, 32), u, nsp, h0)]
    h_seq, h_n = ro.rglru_scan(*args)
    want_seq, want_n = rr.rglru_gated_scan_ref(*args)
    assert torch.equal(h_seq, want_seq) and torch.equal(h_n, want_n)


@pytest.mark.cuda
def test_hybrid_serving_on_the_card_matches_the_cpu(cuda):
    """The reduced recurrentgemma through ``prefill_fn`` and three
    ``decode_fn`` steps on the card (flash and decode kernels at hd 16,
    the scan kernel) against the same model's plain path on the CPU."""
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
