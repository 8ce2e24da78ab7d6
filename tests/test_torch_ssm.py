"""The SSM serving path of the PyTorch port (falcon-mamba) against
``repro``.

Small sizes on the CPU, numpy-seeded inputs through both packages:

* the selective scan: the port's dispatch (the plain version on CPU
  tensors) against ``repro``'s Pallas kernel in interpret mode and its
  ``ssm_scan_ref``, on ``tests/test_kernels.py``'s four shapes, atol
  1e-4 as there;
* the mamba block's parts (``_causal_conv`` with and without a state,
  ``_selective``, ``ssm_block_apply`` with ``return_state`` at chunk 8
  over S 20, ``ssm_decode_step``) on the same bf16 inputs and weights;
* the reduced falcon-mamba (d 64, d_inner 128, N 8, 2 layers) through
  ``prefill_fn`` and three ``decode_fn`` steps against ``repro`` with
  ``RunFlags(ssm_impl="pallas")``, weights carried by ``convert``; the
  port's own prefill + decode against its forward; the short-prompt
  refusal; the weight round trip; the launcher's C signature and its
  refusal of CPU tensors; the golden tokens.

Tolerances.  The port computes ``repro``'s bf16 ops one rounded op at a
time, as XLA does on the CPU (``jax.nn.silu`` / ``softplus`` written out,
``models/ssm.py``), so the bf16 values (conv, dt, B, C, block outputs,
logits, conv state) agree to ``BF16_TOL`` = one bf16 ulp at |x| < 4
(2^-6; a GEMM summed in another order may round a value the other way),
and the f32 values (``h``, the scan's ``y``) to ``F32_TOL`` = 1e-4, the
Pallas kernel's own limit (they differ by f32 rounding of the scan and
of the N-sum, ~1e-7 at these sizes).  The CUDA kernel against its plain
version is a ``cuda`` test: ``h`` bit for bit, ``y`` within
``ref.y_limit``; it skips without a card.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get as j_get  # noqa: E402
from repro.kernels.ssm_scan import ops as j_scan_ops  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import params as j_params  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro_torch import golden  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as so  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as sr  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import params as t_params  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "falcon_mamba_7b"
BF16_TOL = 2.0 ** -6
F32_TOL = 1e-4
PALLAS = j_lm.RunFlags(ssm_impl="pallas")
#: tests/test_kernels.py::test_ssm_scan's shapes (B, T, D, N, block_d)
SCAN_CASES = [(2, 16, 96, 8, 32), (1, 32, 64, 16, 64), (2, 8, 100, 4, 32),
              (1, 64, 32, 16, 16)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_pair(rng, shape, scale=1.0):
    j = jnp.asarray(rng.normal(size=shape) * scale, jnp.float32).astype(
        jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0)


def _cfgs():
    return j_get(ARCH).reduced(), t_get(ARCH).reduced()


@pytest.fixture(scope="module")
def block_params():
    """``repro``'s random bf16 weights of one mamba block, and the same
    values as the port's tree.  ``A_log``, ``D``, ``conv_b`` and
    ``dt_bias`` are moved off their constant inits, so a slip in their
    use shows."""
    cfgj, _ = _cfgs()
    pj = j_params.init_params(j_ssm.ssm_defs(cfgj), jax.random.PRNGKey(3),
                              jnp.bfloat16)
    rng = np.random.default_rng(30)
    for k, scale in (("A_log", 0.5), ("D", 0.5), ("conv_b", 0.1),
                     ("dt_bias", 0.5)):
        pj[k] = (pj[k].astype(jnp.float32) + jnp.asarray(
            rng.normal(size=pj[k].shape) * scale, jnp.float32)).astype(
                jnp.bfloat16)
    pt = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16) for k, v in pj.items()}
    return pj, pt


def _scan_inputs(B, T, D, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.0, (B, T, D, N)).astype(np.float32),
            (rng.normal(size=(B, T, D, N)) * 0.1).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32),
            rng.normal(size=(B, D, N)).astype(np.float32))


# ---------------------------------------------------------------- scan

@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_scan_matches_repro(case):
    B, T, D, N, block_d = case
    arrays = _scan_inputs(B, T, D, N)
    want_k = j_scan_ops.ssm_scan(*map(jnp.asarray, arrays), block_d=block_d)
    want_r = j_ssm.ssm_scan_ref(*map(jnp.asarray, arrays))
    before = so.launches
    h, y = so.ssm_scan(*map(torch.from_numpy, arrays))
    assert so.launches == before                 # the CPU runs no kernel
    assert h.shape == (B, D, N) and y.shape == (B, T, D)
    assert h.dtype == y.dtype == torch.float32
    for want in (want_k, want_r):
        for got, w in zip((h, y), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       atol=F32_TOL, rtol=0)


def test_y_limit_bounds_the_sum_order():
    """``ref.y_limit`` bounds ``y`` summed over N in reverse order."""
    arrays = [torch.from_numpy(a) for a in _scan_inputs(2, 16, 96, 8, 4)]
    h, y = sr.ssm_scan_ref(*arrays)
    hs = arrays[3]
    rev = []
    for t in range(16):
        hs = arrays[0][:, t] * hs + arrays[1][:, t]
        prod = hs * arrays[2][:, t, None, :]
        acc = prod[..., -1]
        for n in range(6, -1, -1):
            acc = acc + prod[..., n]
        rev.append(acc)
    d = (torch.stack(rev, 1) - y).abs()
    lim = sr.y_limit(*arrays)
    assert bool((d <= lim).all()) and float(d.max()) > 0
    assert torch.equal(hs, h)


# ------------------------------------------------------------- block

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_repro(block_params, with_state):
    cfgj, cfgt = _cfgs()
    pj, pt = block_params
    rng = np.random.default_rng(5)
    uj, ut = _bf16_pair(rng, (2, 9, cfgj.d_inner))
    sj = st = None
    if with_state:
        sj, st = _bf16_pair(rng, (2, cfgj.ssm_conv - 1, cfgj.d_inner))
    yj, nj = j_ssm._causal_conv(pj, uj, cfgj, conv_state=sj)
    yt, nt = t_ssm._causal_conv(pt, ut, cfgt, conv_state=st)
    assert yt.dtype == nt.dtype == torch.bfloat16
    _close(yt, yj, BF16_TOL)
    _close(nt, nj, 0.0)


def test_selective_matches_repro(block_params):
    cfgj, cfgt = _cfgs()
    pj, pt = block_params
    uj, ut = _bf16_pair(np.random.default_rng(6), (2, 11, cfgj.d_inner))
    for got, want in zip(t_ssm._selective(pt, ut, cfgt),
                         j_ssm._selective(pj, uj, cfgj)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        _close(got, want, BF16_TOL)


def test_block_with_state_matches_repro(block_params):
    """Chunk 8 over S 20: two carries of h and a padded tail."""
    cfgj, cfgt = _cfgs()
    pj, pt = block_params
    xj, xt = _bf16_pair(np.random.default_rng(7), (2, 20, cfgj.d_model))
    yj, sj = j_ssm.ssm_block_apply(pj, xj, cfgj, chunk=8, ssm_impl="pallas",
                                   return_state=True)
    before = so.launches
    yt, st = t_ssm.ssm_block_apply(pt, xt, cfgt, chunk=8, return_state=True)
    assert so.launches == before
    assert yt.dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    _close(yt, yj, BF16_TOL)
    _close(st["conv"], sj["conv"], BF16_TOL)
    _close(st["ssm"], sj["ssm"], F32_TOL)
    # the chunk changes nothing but the launches
    y1, s1 = t_ssm.ssm_block_apply(pt, xt, cfgt, chunk=256, return_state=True)
    _close(y1, yt, BF16_TOL)
    _close(s1["ssm"], st["ssm"], F32_TOL)


def test_decode_step_matches_repro(block_params):
    cfgj, cfgt = _cfgs()
    pj, pt = block_params
    rng = np.random.default_rng(8)
    xj, xt = _bf16_pair(rng, (2, 1, cfgj.d_model))
    cj, ct = _bf16_pair(rng, (2, cfgj.ssm_conv - 1, cfgj.d_inner))
    h = rng.normal(size=(2, cfgj.d_inner, cfgj.ssm_state)).astype(np.float32)
    yj, sj = j_ssm.ssm_decode_step(pj, xj, {"conv": cj, "ssm": jnp.asarray(h)},
                                   cfgj)
    yt, st = t_ssm.ssm_decode_step(pt, xt, {"conv": ct,
                                            "ssm": torch.from_numpy(h)}, cfgt)
    _close(yt, yj, BF16_TOL)
    _close(st["conv"], sj["conv"], BF16_TOL)
    _close(st["ssm"], sj["ssm"], F32_TOL)


def test_short_prompt_raises_naming_the_limit():
    """``repro`` keeps a conv state of ``min(S, kc - 1)`` rows and fails
    in the next decode step; the port refuses the prompt."""
    _, cfg = _cfgs()
    model = t_zoo.init_model(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="ssm_conv - 1 = 3"):
        t_zoo.prefill_fn(model, {"tokens": torch.zeros((2, 2),
                                                       dtype=torch.long)},
                         cfg, max_len=8)
    _, cache = t_zoo.prefill_fn(model, {"tokens": torch.zeros(
        (2, 3), dtype=torch.long)}, cfg, max_len=8)
    assert cache["ssm"]["conv"].shape == (cfg.n_layers, 2, 3, cfg.d_inner)


# ------------------------------------------------------------ model

def test_convert_round_trip_is_exact():
    cfgj, cfgt = _cfgs()
    params = j_zoo.init_model(cfgj, seed=1)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = convert.from_repro(tree, cfgt, device="cpu")
    back = convert.to_repro(model)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        assert np.array_equal(a.astype(np.float32), flat_b[path]), path
    for k in ("A_log", "D", "conv_w", "dt_bias"):
        assert back["layers"]["ssm"][k].shape == tree["layers"]["ssm"][k].shape
    again = convert.from_repro(back, cfgt, device="cpu")
    for x, y in zip(model.parameters(), again.parameters()):
        assert x.dtype == y.dtype == torch.bfloat16 and torch.equal(x, y)


def _tree_clone(c):
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone()
            for k, v in c.items()}


@pytest.fixture(scope="module")
def served():
    """``repro`` (pallas, interpret mode) and the port on the reduced
    falcon-mamba, the same weights, prompt and decode inputs: the logits
    and caches after prefill and after each of three decode steps."""
    cfgj, cfgt = _cfgs()
    params = j_zoo.init_model(cfgj, seed=0)
    model = convert.from_repro(jax.tree_util.tree_map(np.asarray, params),
                               cfgt, device="cpu")
    rng = np.random.default_rng(12)
    B, S, T = 2, 12, 3
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


@pytest.mark.parametrize("step", range(4), ids=["prefill", "decode1",
                                                "decode2", "decode3"])
def test_serving_matches_repro(served, step):
    jl, jc, tl, tc = served[step]
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    _close(tl, jl, BF16_TOL)
    assert set(tc) == set(jc) == {"pos", "ssm"}
    for key, tol in (("conv", BF16_TOL), ("ssm", F32_TOL)):
        got, want = tc["ssm"][key], jc["ssm"][key]
        assert tuple(got.shape) == want.shape
        assert got.dtype == (torch.float32 if key == "ssm"
                             else torch.bfloat16)
        _close(got, want, tol)
    assert int(tc["pos"]) == int(jc["pos"])


def test_prefill_decode_matches_forward():
    """The port's own prefill + one decode step equal its full forward's
    last position (``tests/test_models.py``'s check, rel < 0.05), over
    two scan chunks."""
    _, cfg = _cfgs()
    model = t_zoo.init_model(cfg, seed=0, device="cpu")
    B, S = 2, 300
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


def test_decode_writes_the_state_in_place_and_serves_greedy():
    _, cfg = _cfgs()
    model = t_zoo.init_model(cfg, seed=0, device="cpu")
    _, cache = t_steps.make_prefill_step(cfg, 12)(
        model, {"tokens": torch.zeros((2, 5), dtype=torch.long)})
    h_before = cache["ssm"]["ssm"].clone()
    tok = torch.zeros(2, dtype=torch.int32)
    logits, _ = t_zoo.decode_fn(model, _tree_clone(cache), tok, cfg)
    tok2, new = t_steps.make_serve_step(cfg)(model, cache, tok)
    assert new["ssm"]["ssm"] is cache["ssm"]["ssm"]
    assert not torch.equal(cache["ssm"]["ssm"], h_before)
    assert int(cache["pos"]) == 5 and int(new["pos"]) == 6
    assert torch.equal(tok2, torch.argmax(logits, -1).to(torch.int32))


def test_serve_step_matches_repro_greedy():
    cfgj, cfgt = _cfgs()
    params = j_zoo.init_model(cfgj, seed=0)
    model = convert.from_repro(jax.tree_util.tree_map(np.asarray, params),
                               cfgt, device="cpu")
    prompt = np.random.default_rng(9).integers(
        0, cfgj.vocab_size, (2, 6)).astype(np.int32)
    _, jc = j_steps.make_prefill_step(cfgj, 12, PALLAS)(
        params, {"tokens": jnp.asarray(prompt)})
    _, tc = t_steps.make_prefill_step(cfgt, 12)(
        model, {"tokens": torch.from_numpy(prompt)})
    jt, tt = jnp.zeros((2,), jnp.int32), torch.zeros(2, dtype=torch.int32)
    for _ in range(3):
        logits, _ = t_zoo.decode_fn(model, _tree_clone(tc), tt, cfgt)
        jt, jc = j_steps.make_serve_step(cfgj, PALLAS)(params, jc, jt)
        tt, tc = t_steps.make_serve_step(cfgt)(model, tc, tt)
        # equal where the port's top logit leads by more than the
        # logits' tolerance (both sides feed back their own tokens, so
        # stop at the first row that may tie)
        top2 = torch.topk(logits.float(), 2).values
        sure = top2[:, 0] - top2[:, 1] > 2 * BF16_TOL
        assert torch.equal(tt[sure], torch.from_numpy(np.array(jt))[sure])
        if not bool(sure.all()):
            break


def test_init_cache_matches_repro():
    rj, rt = _cfgs()
    jc = j_lm.init_cache(rj, 3, 16)
    tc = t_lm.init_cache(rt, 3, 16, device="cpu")
    for key in ("conv", "ssm"):
        assert tuple(tc["ssm"][key].shape) == jc["ssm"][key].shape
    assert tc["ssm"]["conv"].dtype == torch.bfloat16
    assert tc["ssm"]["ssm"].dtype == torch.float32


def test_helpers_want_cuda_unless_told():
    """``init_params``, ``init_cache`` and ``from_repro`` build on CUDA
    unless the caller names a device: here, with no card, they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_params.init_params(t_zoo.model_defs(cfg), seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_lm.init_cache(cfg, 1, 4)
    cfgj, _ = _cfgs()
    tree = jax.tree_util.tree_map(np.asarray, j_zoo.init_model(cfgj, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.from_repro(tree, cfg)


# ----------------------------------------------------- launcher binding

def test_launch_arguments_match_the_cuda_source(monkeypatch):
    """kernel.py's ctypes signature has the C launcher's arity and kinds
    (int / pointer), read from the source."""
    import ctypes

    from repro_torch import _build
    src = (ROOT / "src" / "repro_torch" / "kernels" / "ssm_scan" / "csrc"
           / "ssm_scan.cu").read_text()
    sig = re.search(r"int ssm_scan_launch\(([^)]*)\)", src).group(1)
    want = ["pointer" if "*" in p else " ".join(p.split()[:-1])
            for p in sig.split(",")]

    class Fake:
        def __getattr__(self, name):
            f = type("F", (), {})()
            setattr(self, name, f)
            return f

    fake = Fake()
    monkeypatch.setattr(_build, "load", lambda name, csrc: fake)
    sk.library.cache_clear()
    try:
        sk.library()
        argtypes = fake.ssm_scan_launch.argtypes
    finally:
        sk.library.cache_clear()
    kinds = [{ctypes.c_int: "int"}.get(a, "pointer") for a in argtypes]
    assert kinds == want


def test_launcher_refuses_cpu_tensors_and_the_dispatch_other_devices():
    arrays = [torch.from_numpy(a) for a in _scan_inputs(1, 4, 8, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssm_scan(*arrays)
    # meta tensors (the dry run) take the meta path: the kernel's shapes,
    # no launch (tests/test_torch_dryrun.py holds its counts)
    before = so.launches
    got = so.ssm_scan(*(a.to("meta") for a in arrays))
    want = so.ssm_scan(*arrays)
    assert so.launches == before
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (w.shape, w.dtype)


# -------------------------------------------------------------- golden

def test_golden_tokens_reproduce_the_recorded_digest():
    rec = golden.load_lm(golden.LM_SSM_PATH)
    L = golden.LM_SSM
    assert rec["lm"] == L
    cfg = t_get(L["config"])
    prompt, dec = golden.lm_tokens(cfg.vocab_size, spec=L)
    assert prompt.shape == (L["batch"], L["prompt"])
    assert golden.tokens_digest(prompt, dec) == rec["tokens_digest"]
    for r in (rec, rec["cut"]):
        assert len(r["steps"]) == L["steps"] + 1
        assert all(len(s["top_logits"]) == L["batch"] for s in r["steps"])
    assert rec["cut"]["n_layers"] == L["cut_layers"] < cfg.n_layers


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_ssm.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES + [(1, 13, 37, 5, 0),
                                               (2, 9, 10, 32, 0)], ids=str)
def test_ssm_scan_kernel_matches_plain(cuda, case):
    B, T, D, N, _ = case
    arrays = [torch.from_numpy(a).to(cuda)
              for a in _scan_inputs(B, T, D, N, seed=1)]
    before = so.launches
    h, y = so.ssm_scan(*arrays)
    assert so.launches == before + 1
    hr, yr = sr.ssm_scan_ref(*arrays)
    assert torch.equal(h, hr)
    assert bool(((y - yr).abs() <= sr.y_limit(*arrays)).all())
