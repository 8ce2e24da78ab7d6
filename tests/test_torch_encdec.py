"""The encoder-decoder family of the PyTorch port (whisper-small) against
``repro``.

Small sizes on the CPU, numpy-seeded inputs through both packages:

* the sinusoid positions (``_sinusoid``, ``_sinusoid_at``) in f32;
* the encoder on the same stub frames and weights;
* the reduced whisper-small (d 64, 2 + 2 layers, 16 frames, hd 16,
  LayerNorm, GeLU, no RoPE) through ``prefill_fn`` and four
  ``decode_fn`` steps against ``repro`` with its blocked attention
  (``RunFlags(attn_impl="blocked")``); past ``max_len`` the self-cache's
  write lands on its last slot in both;
* ``repro``'s pallas decode, which masks by ``arange`` and ignores the
  positions (ROADMAP.md, Queue 3, fault 6), differs from its blocked
  decode where the port does not;
* the caches and the weight round trip; ``zoo.batch_specs`` /
  ``make_batch``;
* the reduced whisper on the card against its plain path on the CPU
  (``cuda``, skips without a card).

Tolerances.  The sinusoids go through f32 ``pow``, ``sin`` and ``cos``,
which XLA and PyTorch round an ulp apart in places: 1e-6 before the
bf16 cast.  The encoder states, logits and caches (|x| < 4) agree to
``LM_TOL`` = 0.0625, four bf16 ulps, as ``tests/test_torch_lm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get as j_get  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import encdec as t_encdec  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402

ARCH = "whisper_small"
BLOCKED = j_lm.RunFlags(attn_impl="blocked")
PALLAS = j_lm.RunFlags(attn_impl="pallas")
LM_TOL = 0.0625
KEYS = ("k", "v", "xk", "xv")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cfgs():
    return j_get(ARCH).reduced(), t_get(ARCH).reduced()


def _model(seed=0):
    cfgj, cfgt = _cfgs()
    params = j_zoo.init_model(cfgj, seed=seed)
    model = convert.from_repro(jax.tree_util.tree_map(np.asarray, params),
                               cfgt, device="cpu")
    return params, model


def _batch(cfgj, B, S, seed):
    """Frames [B, enc_seq, d] (bf16) and prompt tokens [B, S], numpy
    seeded, for both packages."""
    rng = np.random.default_rng(seed)
    frames = jnp.asarray(rng.normal(size=(B, cfgj.enc_seq, cfgj.d_model)),
                         jnp.float32).astype(jnp.bfloat16)
    tokens = rng.integers(0, cfgj.vocab_size, (B, S)).astype(np.int32)
    bj = {"frames": frames, "tokens": jnp.asarray(tokens)}
    bt = {"frames": torch.from_numpy(np.array(frames.astype(
        jnp.float32))).to(torch.bfloat16), "tokens": torch.from_numpy(tokens)}
    return bj, bt


def test_sinusoids_match_repro():
    want = j_encdec._sinusoid(40, 64, jnp.float32)
    got = t_encdec._sinusoid(40, 64, torch.float32, "cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    for pos in (0, 7, 39):
        np.testing.assert_allclose(
            t_encdec._sinusoid_at(torch.tensor(pos, dtype=torch.int32), 64,
                                  torch.float32).numpy(),
            np.asarray(j_encdec._sinusoid_at(jnp.int32(pos), 64,
                                             jnp.float32)),
            atol=1e-6, rtol=0)


def test_encoder_matches_repro():
    cfgj, cfgt = _cfgs()
    params, model = _model(1)
    bj, bt = _batch(cfgj, 2, 4, seed=2)
    want = j_encdec.encode(params, bj["frames"], cfgj, BLOCKED)
    got = t_encdec.encode(model, bt["frames"], cfgt)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LM_TOL, rtol=0)


# ---------------------------------------------- prefill and decode

@pytest.fixture(scope="module")
def served():
    """``repro`` (blocked) and the port on the reduced whisper: the same
    weights, frames, a 6-token prompt (cache ``max_len`` 8, so the last
    two steps write past it) and four decode inputs; the logits and
    caches after prefill and after each step."""
    cfgj, cfgt = _cfgs()
    params, model = _model(0)
    bj, bt = _batch(cfgj, 2, 6, seed=11)
    dec = np.random.default_rng(12).integers(
        0, cfgj.vocab_size, (4, 2)).astype(np.int32)
    jl, jc = j_zoo.prefill_fn(params, bj, cfgj, max_len=8, flags=BLOCKED)
    tl, tc = t_zoo.prefill_fn(model, bt, cfgt, max_len=8)
    rows = [(jl, jc, tl, {k: v.clone() for k, v in tc.items()})]
    for t in range(4):
        jl, jc = j_zoo.decode_fn(params, jc, jnp.asarray(dec[t]), cfgj,
                                 flags=BLOCKED)
        tl, tc = t_zoo.decode_fn(model, tc, torch.from_numpy(dec[t]), cfgt)
        rows.append((jl, jc, tl, {k: v.clone() for k, v in tc.items()}))
    return rows


@pytest.mark.parametrize("step", range(5), ids=["prefill", "decode1",
                                                "decode2", "decode3",
                                                "decode4"])
def test_serving_matches_repro(served, step):
    jl, jc, tl, tc = served[step]
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LM_TOL, rtol=0)
    for key in KEYS:
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]),
                                   atol=LM_TOL, rtol=0)
    assert np.array_equal(tc["kv_pos"].numpy(), np.asarray(jc["kv_pos"]))
    assert int(tc["pos"]) == int(jc["pos"])


def test_self_cache_writes_clamp_to_the_last_slot(served):
    """Positions 6 and 7 fill the cache; 8 and 9 land on slot 7."""
    _, _, _, tc = served[-1]
    assert tc["kv_pos"][0].tolist() == [0, 1, 2, 3, 4, 5, 6, 9]
    assert int(tc["pos"]) == 10


def test_repros_pallas_decode_ignores_the_positions():
    """``repro``'s ``decode_step`` under ``attn_impl="pallas"`` masks the
    self-attention by ``arange`` (the query at 0 sees slot 0 only), so
    its logits move far from the blocked decode's, which the port
    follows (ROADMAP.md, Queue 3, fault 6: the reduced whisper, a 2 x 6
    prompt, one step)."""
    cfgj, cfgt = _cfgs()
    params, model = _model(0)
    bj, bt = _batch(cfgj, 2, 6, seed=11)
    tok = np.asarray([3, 5], np.int32)
    out = {}
    for name, flags in (("blocked", BLOCKED), ("pallas", PALLAS)):
        pl, c = j_zoo.prefill_fn(params, bj, cfgj, max_len=16, flags=flags)
        out[name] = (pl, j_zoo.decode_fn(params, c, jnp.asarray(tok), cfgj,
                                         flags=flags)[0])
    assert np.array_equal(_f32(out["blocked"][0]), _f32(out["pallas"][0]))
    gap = np.abs(_f32(out["blocked"][1]) - _f32(out["pallas"][1])).max()
    assert gap > 0.25
    _, tc = t_zoo.prefill_fn(model, bt, cfgt, max_len=16)
    tl, _ = t_zoo.decode_fn(model, tc, torch.from_numpy(tok), cfgt)
    np.testing.assert_allclose(_f32(tl), _f32(out["blocked"][1]),
                               atol=LM_TOL, rtol=0)


def test_init_cache_is_the_prefill_cache_shape():
    cfgj, cfgt = _cfgs()
    params, _ = _model(0)
    bj, _ = _batch(cfgj, 3, 5, seed=1)
    _, jc = j_zoo.prefill_fn(params, bj, cfgj, max_len=12, flags=BLOCKED)
    tc = t_zoo.init_cache(cfgt, 3, 12, device="cpu")
    assert set(tc) == set(jc)
    for key in KEYS + ("kv_pos", "pos"):
        assert tuple(tc[key].shape) == jc[key].shape, key
    assert all(tc[k].dtype == torch.bfloat16 for k in KEYS)
    assert bool((tc["kv_pos"] == -1).all())


def test_convert_round_trip_is_exact():
    cfgj, cfgt = _cfgs()
    params = j_zoo.init_model(cfgj, seed=1)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = convert.from_repro(tree, cfgt, device="cpu")
    assert len(model.enc_layers) == cfgt.n_enc_layers
    assert len(model.dec_layers) == cfgt.n_layers
    back = convert.to_repro(model)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        assert np.array_equal(a.astype(np.float32), flat_b[path]), path


def test_prefill_refuses_a_prompt_past_max_len():
    cfgj, cfgt = _cfgs()
    _, model = _model(0)
    _, bt = _batch(cfgj, 1, 9, seed=3)
    with pytest.raises(ValueError, match="max_len"):
        t_zoo.prefill_fn(model, bt, cfgt, max_len=8)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_encdec.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_encdec_serving_on_the_card_matches_the_cpu(cuda):
    """The reduced whisper through ``prefill_fn`` and three ``decode_fn``
    steps on the card (flash without a mask and causal, the decode
    kernel over the self-cache and the frames) against the same model's
    plain path on the CPU."""
    cfgj, cfg = _cfgs()
    model = t_zoo.init_model(cfg, seed=0, device="cpu")
    _, bt = _batch(cfgj, 2, 6, seed=4)
    outs = {}
    for dev in ("cpu", cuda):
        m = model.to(dev)
        logits, cache = t_zoo.prefill_fn(
            m, {k: v.to(dev) for k, v in bt.items()}, cfg, max_len=12)
        got = [logits.float().cpu()]
        for t in range(3):
            logits, cache = t_zoo.decode_fn(
                m, cache, torch.full((2,), t + 5, device=dev), cfg)
            got.append(logits.float().cpu())
        outs[str(dev)] = got
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        torch.testing.assert_close(b, a, atol=LM_TOL, rtol=0)
