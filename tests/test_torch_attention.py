"""The attention kernels of the PyTorch port: flash attention (prefill)
and decode attention over the ring cache.

* On the CPU, the port's dispatch (``ops``, which runs the plain
  versions on CPU tensors) against ``repro``'s Pallas kernels in
  interpret mode, on ``tests/test_kernels.py``'s two matrices, from the
  same numpy-seeded inputs, with that file's tolerances: flash bf16
  0.02, f32 2e-5; decode 0.03 (both compute in f32 from the same inputs;
  the bf16 bound is a couple of output roundings).
* The dispatch's refusals and the launchers' C signatures.
* The CUDA kernels against their plain versions, marked ``cuda``, within
  ``KERNEL_TOL``: these skip where no CUDA device exists and run on the
  card with
  ``python -m pytest -m cuda tests/test_torch_attention.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as j_fa  # noqa: E402
from repro.kernels.paged_attention import ops as j_pa  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fr  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pk  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pr  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: tests/test_kernels.py::test_flash_attention's matrix
FLASH_CASES = [
    (2, 128, 4, 2, 64, True, 0),
    (1, 256, 8, 2, 64, True, 64),
    (2, 96, 4, 4, 32, True, 0),        # non-block-multiple S
    (1, 64, 4, 1, 128, False, 0),      # MQA, bidirectional
    (1, 160, 6, 2, 48, True, 32),      # odd head_dim, SWA
]
#: tests/test_kernels.py::test_paged_attention's matrix
DECODE_CASES = [
    (2, 8, 2, 64, 128, 0, 100),
    (1, 4, 4, 32, 256, 64, 256),
    (2, 4, 1, 128, 64, 0, 10),         # nearly-empty cache
    (1, 8, 8, 64, 96, 0, 96),          # MHA, non-multiple W
]
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16, 0.02),
          "f32": (jnp.float32, torch.float32, 2e-5)}
DECODE_TOL = 0.03
#: (atol, rtol) of a CUDA kernel against its plain version on the card,
#: as chip_smoke.py holds them: both sum in f32 and round once, so a bf16
#: output may differ by one bf16 ulp (2^-7 of it) where the two sums round
#: apart; f32 within the absolute 2e-5
KERNEL_TOL = {"bf16": (1e-5, 2.0 ** -7), "f32": (2e-5, 0.0)}


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _pair(a, jdt, tdt):
    """The same values as a JAX and a torch array of one dtype."""
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


def _flash_inputs(case, dtype, seed=0):
    B, S, H, K, hd, causal, window = case
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    return [_pair(_normal(rng, s), jdt, tdt)
            for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))]


def _decode_inputs(case, seed=0):
    B, H, K, hd, W, window, fill = case
    rng = np.random.default_rng(seed)
    q, kc, vc = (_pair(_normal(rng, s), jnp.bfloat16, torch.bfloat16)
                 for s in ((B, 1, H, hd), (B, W, K, hd), (B, W, K, hd)))
    kv_pos = np.where(np.arange(W) < fill, np.arange(W), -1).astype(np.int32)
    q_pos = np.asarray([fill - 1], np.int32)
    return q, kc, vc, kv_pos, q_pos


# ------------------------------------------------------- against repro

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_matches_repro(case, dtype):
    B, S, H, K, hd, causal, window = case
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(case, dtype)
    want = j_fa.flash_attention(qj, kj, vj, causal=causal, window=window,
                                block_q=64, block_kv=64)
    before = fa.launches
    got = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert fa.launches == before           # the CPU runs no kernel
    assert got.dtype == qt.dtype and got.shape == (B, S, H, hd)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("rope_theta", [0.0, 10000.0])
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_matches_repro(case, rope_theta):
    """Both wrappers rotate q themselves (``rope_theta``), so a second or
    a missing rotation would show here."""
    B, H, K, hd, W, window, fill = case
    (qj, qt), (kj, kt), (vj, vt), kv_pos, q_pos = _decode_inputs(case)
    want = j_pa.decode_attention(qj, kj, vj, q_pos=jnp.asarray(q_pos),
                                 kv_pos=jnp.asarray(kv_pos), window=window,
                                 rope_theta=rope_theta, block_kv=64)
    before = pa.launches
    got = pa.decode_attention(qt, kt, vt, q_pos=torch.from_numpy(q_pos),
                              kv_pos=torch.from_numpy(kv_pos), window=window,
                              rope_theta=rope_theta)
    assert pa.launches == before
    assert got.dtype == qt.dtype and got.shape == (B, 1, H, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=DECODE_TOL,
                               rtol=DECODE_TOL)


def test_decode_empty_slots_match_repro_kv_valid():
    """A slot whose position is -1 is empty, as one that ``repro``'s
    wrapper drops through ``kv_valid``."""
    case = DECODE_CASES[0]
    (qj, qt), (kj, kt), (vj, vt), kv_pos, q_pos = _decode_inputs(case, 3)
    valid = np.arange(case[4]) % 3 != 1
    want = j_pa.decode_attention(qj, kj, vj, q_pos=jnp.asarray(q_pos),
                                 kv_pos=jnp.asarray(kv_pos),
                                 kv_valid=jnp.asarray(valid), block_kv=64)
    got = pa.decode_attention(qt, kt, vt, q_pos=torch.from_numpy(q_pos),
                              kv_pos=torch.from_numpy(
                                  np.where(valid, kv_pos, -1)))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=DECODE_TOL,
                               rtol=DECODE_TOL)


def test_flash_plain_matches_naive_attention():
    """The plain flash version equals ``layers.naive_attention`` at its
    own positions (both f32 softmax over the same masks)."""
    case = FLASH_CASES[4]
    B, S, H, K, hd, causal, window = case
    (_, q), (_, k), (_, v) = _flash_inputs(case, "f32", seed=5)
    pos = torch.arange(S)
    got = fr.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = t_layers.naive_attention(q, k, v, pos, pos, causal, window)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)


# ------------------------------------------------- dispatch and binding

def test_flash_refuses_a_mask_over_unequal_lengths():
    """The wrapper masks by positions ``arange(S)`` / ``arange(Skv)``; a
    causal mask over ``S != Skv`` would leave rows without a key, so it
    raises rather than guess."""
    (_, q), (_, k), (_, v) = _flash_inputs(FLASH_CASES[2], "f32")
    with pytest.raises(ValueError, match="S == Skv"):
        fa.flash_attention(q, k[:, :-1], v[:, :-1], causal=True)
    with pytest.raises(ValueError, match="S == Skv"):
        fa.flash_attention(q, k[:, :-1], v[:, :-1], causal=False, window=4)
    # no mask: any Skv, as cross-attention would use it
    out = fa.flash_attention(q, k[:, :-5], v[:, :-5], causal=False)
    assert out.shape == q.shape


def test_launchers_refuse_cpu_tensors():
    (_, q), (_, k), (_, v) = _flash_inputs(FLASH_CASES[2], "f32")
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention(q, k, v, causal=True, window=0)
    (_, qd), (_, kc), (_, vc), kv_pos, q_pos = _decode_inputs(
        DECODE_CASES[0])
    with pytest.raises(ValueError, match="CUDA"):
        pk.decode_attention(qd[:, 0], kc, vc, torch.from_numpy(kv_pos),
                            torch.from_numpy(q_pos), window=0)


def _c_params(rel: str, fn: str) -> list[str]:
    src = (ROOT / "src" / "repro_torch" / "kernels" / rel).read_text()
    sig = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    return [" ".join(p.split()[:-1]) for p in sig.split(",")]


def _kind(ctype) -> str:
    import ctypes
    return {ctypes.c_int: "int", ctypes.c_longlong: "long long",
            ctypes.c_float: "float"}.get(ctype, "pointer")


@pytest.mark.parametrize("rel,fn,kernel_mod", [
    ("flash_attention/csrc/flash_attention.cu", "flash_attention_launch",
     fk),
    ("paged_attention/csrc/paged_attention.cu", "paged_attention_launch",
     pk),
])
def test_launch_arguments_match_the_cuda_source(rel, fn, kernel_mod,
                                                monkeypatch):
    """kernel.py's ctypes signature has the C launcher's arity and
    kinds (int / long long / float / pointer), read from the source."""
    from repro_torch import _build

    class Fake:
        def __getattr__(self, name):
            f = type("F", (), {})()
            setattr(self, name, f)
            return f

    fake = Fake()
    monkeypatch.setattr(_build, "load", lambda name, csrc: fake)
    kernel_mod.library.cache_clear()
    try:
        kernel_mod.library()
        argtypes = getattr(fake, fn).argtypes
    finally:
        kernel_mod.library.cache_clear()
    want = ["pointer" if "*" in p else p.replace("const ", "")
            for p in _c_params(rel, fn)]
    assert [_kind(a) for a in argtypes] == want


# ----------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_attention.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, S, H, K, hd, causal, window = case
    (_, q), (_, k), (_, v) = _flash_inputs(case, dtype, seed=1)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches == before + 1
    want = fr.flash_attention_ref(q, k, v, causal=causal, window=window)
    atol, rtol = KERNEL_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_kernel_matches_plain(cuda, case):
    B, H, K, hd, W, window, fill = case
    (_, q), (_, kc), (_, vc), kv_pos, q_pos = _decode_inputs(case, seed=2)
    q, kc, vc = q.to(cuda), kc.to(cuda), vc.to(cuda)
    kv_pos = torch.from_numpy(kv_pos).to(cuda)
    q_pos = torch.from_numpy(q_pos).to(cuda)
    before = pa.launches
    got = pa.decode_attention(q, kc, vc, q_pos=q_pos, kv_pos=kv_pos,
                              window=window)
    assert pa.launches == before + 1
    qr = t_layers.rope(q, q_pos[None], 10000.0)[:, 0]
    want = pr.decode_ref(qr, kc, vc, kv_pos.expand(B, W), q_pos.expand(B),
                         window=window)
    atol, rtol = KERNEL_TOL["bf16"]
    torch.testing.assert_close(got[:, 0].float(), want.float(), atol=atol,
                               rtol=rtol)
