"""The attention kernels of the PyTorch port: flash attention (prefill)
and decode attention over the ring cache.

* On the CPU, the port's dispatch (``ops``, which runs the plain
  versions on CPU tensors) against ``repro``'s Pallas kernels in
  interpret mode, on ``tests/test_kernels.py``'s two matrices, from the
  same numpy-seeded inputs, with that file's tolerances: flash bf16
  0.02, f32 2e-5; decode 0.03 (both compute in f32 from the same inputs;
  the bf16 bound is a couple of output roundings).
* The kernels' own numerics through their plain emulations
  (``flash_attention_tiled``: the bf16 tensor-core path tile by tile,
  with its ``p = p_hi + p_lo`` split; ``decode_split``: split-KV with its
  combine) against the plain versions within ``KERNEL_TOL`` and against
  ``repro``'s kernels within the tolerances above.
* The dispatch's refusals, the split plan and the C signatures of the
  launchers and of the decode library's launch counters.
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
    (1, 128, 6, 2, 128, True, 0),      # hd 128, G 3 (phi4-mini's widths)
    (2, 80, 4, 2, 16, True, 0),        # hd 16 (the reduced configs)
    (1, 144, 10, 1, 256, True, 64),    # hd 256, MQA G 10, a window
                                       # (recurrentgemma's widths)
    (2, 48, 4, 4, 256, False, 0),      # hd 256, bidirectional
    (2, 64, 4, 2, 64, False, 0, 200),  # cross attention, Skv 200: the
                                       # last key tile ragged
]
#: tests/test_kernels.py::test_paged_attention's matrix
DECODE_CASES = [
    (2, 8, 2, 64, 128, 0, 100),
    (1, 4, 4, 32, 256, 64, 256),
    (2, 4, 1, 128, 64, 0, 10),         # nearly-empty cache
    (1, 8, 8, 64, 96, 0, 96),          # MHA, non-multiple W
    (2, 48, 1, 128, 96, 0, 80),        # G 48 over K 1 (granite's widths)
    (1, 10, 1, 256, 64, 32, 60),       # hd 256, G 10, a window
]
#: split-KV cases (B, H, K, hd, W, window, fill) on a ring that keeps the
#: newest W positions, the query at position fill - 1
SPLIT_CASES = [
    (2, 8, 2, 64, 128, 0, 40),         # later chunks hold no valid slot
    (1, 4, 4, 32, 96, 0, 250),         # a wrapped ring
    (2, 8, 2, 64, 128, 48, 300),       # wrapped, under a window
    (2, 48, 1, 128, 96, 0, 70),        # G 48, K 1
    (1, 10, 1, 256, 192, 128, 300),    # hd 256, G 10: wrapped, a window
]
N_SPLITS = [1, 2, 3, 7]
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


def _dims(case):
    """``(B, S, Skv, H, K, hd, causal, window)`` of a ``FLASH_CASES``
    entry: ``Skv`` is its eighth element where it has one, else ``S``."""
    B, S, H, K, hd, causal, window = case[:7]
    return B, S, (case[7] if len(case) > 7 else S), H, K, hd, causal, window


def _flash_inputs(case, dtype, seed=0):
    B, S, Skv, H, K, hd, causal, window = _dims(case)
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    return [_pair(_normal(rng, s), jdt, tdt)
            for s in ((B, S, H, hd), (B, Skv, K, hd), (B, Skv, K, hd))]


def _decode_inputs(case, seed=0):
    B, H, K, hd, W, window, fill = case
    rng = np.random.default_rng(seed)
    q, kc, vc = (_pair(_normal(rng, s), jnp.bfloat16, torch.bfloat16)
                 for s in ((B, 1, H, hd), (B, W, K, hd), (B, W, K, hd)))
    kv_pos = np.where(np.arange(W) < fill, np.arange(W), -1).astype(np.int32)
    q_pos = np.asarray([fill - 1], np.int32)
    return q, kc, vc, kv_pos, q_pos


def _ring_inputs(case, seed=0):
    """bf16 q (rotated) / caches of ``case`` as JAX and torch arrays, and
    the ring's int32 slot positions ``[W]`` (position p in slot p mod W,
    the newest W kept, -1 where never written) and ``q_pos [1]``."""
    B, H, K, hd, W, window, fill = case
    rng = np.random.default_rng(seed)
    q, kc, vc = (_pair(_normal(rng, s), jnp.bfloat16, torch.bfloat16)
                 for s in ((B, H, hd), (B, W, K, hd), (B, W, K, hd)))
    slots = np.arange(W)
    newest = fill - 1 - np.remainder(fill - 1 - slots, W)
    kv_pos = np.where(newest >= 0, newest, -1).astype(np.int32)
    return q, kc, vc, kv_pos, np.asarray([fill - 1], np.int32)


def _within_one_ulp(got, want, dtype="bf16"):
    atol, rtol = KERNEL_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------- against repro

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_matches_repro(case, dtype):
    B, S, Skv, H, K, hd, causal, window = _dims(case)
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
    B, S, Skv, H, K, hd, causal, window = _dims(case)
    (_, q), (_, k), (_, v) = _flash_inputs(case, "f32", seed=5)
    pos = torch.arange(S)
    got = fr.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = t_layers.naive_attention(q, k, v, pos, pos, causal, window)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)


# ------------------------------------- the kernels' numerics, emulated

@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_tiled_matches_plain(case):
    """The bf16 path's numerics (f32 sums of exact bf16 products in
    16-wide steps, the scale to log2 units and then ``exp2``, ``p_hi +
    p_lo``, 128-row blocks over 64- or 128-key tiles with the causal /
    window skip) stay within one
    bf16 ulp of the f32 plain version, the limit the kernel is held to on
    the card."""
    B, S, Skv, H, K, hd, causal, window = _dims(case)
    (_, q), (_, k), (_, v) = _flash_inputs(case, "bf16", seed=6)
    got = fr.flash_attention_tiled(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, hd)
    _within_one_ulp(got, fr.flash_attention_ref(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_tiled_matches_repro(case):
    B, S, Skv, H, K, hd, causal, window = _dims(case)
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(case, "bf16", seed=7)
    want = j_fa.flash_attention(qj, kj, vj, causal=causal, window=window,
                                block_q=64, block_kv=64)
    got = fr.flash_attention_tiled(qt, kt, vt, causal=causal, window=window)
    tol = DTYPES["bf16"][2]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


#: (S, Skv, causal, window) over which the tile walk is checked: lengths
#: around the 64-key chunk and the 128-row block, windows from 1 key to
#: past S, and cross attention (S != Skv, no mask)
WALK_LENGTHS = (1, 16, 63, 64, 65, 127, 128, 129, 200, 300)
WALK_CASES = ([(S, S, c, w) for S in WALK_LENGTHS for c in (True, False)
               for w in (0, 1, 7, 64, 65, 128, 200)]
              + [(S, Skv, False, 0) for S in (1, 64, 129)
                 for Skv in (1, 63, 200, 1500)])


@pytest.mark.parametrize("hd,heads", [(64, 1), (64, 400), (128, 1),
                                      (256, 1)])
def test_flash_tile_walk_skips_no_valid_pair(hd, heads):
    """Every (query, key) pair the masks keep lies in a key tile that
    the query's 128-row block visits (``ref.visited_tiles``, the kernel's
    walk: 128-key tiles up to hd 128, 64 above, 64 at hd 64 where Skv
    fits 64 keys or the grid has more blocks than the card has SMs), and
    every visited tile starts below Skv."""
    for S, Skv, causal, window in WALK_CASES:
        qp = torch.arange(S)[:, None]
        kp = torch.arange(Skv)[None, :]
        dense = torch.ones(S, Skv, dtype=torch.bool)
        if causal:
            dense &= qp >= kp
        if window:
            dense &= qp - kp < window
        bkv, walk = fr.visited_tiles(1, S, Skv, heads, hd, causal=causal,
                                     window=window)
        assert bkv == (64 if hd > 128 or hd <= 64 and (
            Skv <= 64 or heads * -(-S // 128) > fr.SMS) else 128)
        seen = torch.zeros(S, Skv, dtype=torch.bool)
        for q0, tiles in walk:
            assert all(0 <= t0 < Skv for t0 in tiles)
            for t0 in tiles:
                seen[q0:q0 + fr.BQ, t0:t0 + bkv] = True
        assert not bool((dense & ~seen).any()), (S, Skv, causal, window)


def test_flash_tile_walk_follows_the_cuda_source():
    """The emulation's block rows, tile choice and window rounding are the
    kernel's own, read from ``flash_attention.cu``."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" /
           "csrc" / "flash_attention.cu").read_text()
    assert re.search(r"constexpr int FWD_BQ = (\d+);", src).group(1) == \
        str(fr.BQ)
    rule = re.search(r"int fwd_chunks\(int hd, int Skv, long long blocks, "
                     r"int sms\) \{(.*?)\n\}", src, re.S).group(1)
    for line in ("if (hd > 128) return 1;", "if (hd > 64) return 2;",
                 "return Skv <= 64 || blocks > sms ? 1 : 2;"):
        assert line in rule
    assert ("const int kv_start = window ? max(0, q0 - window + 1) / BKV "
            "* BKV : 0;") in src
    assert "static constexpr int BKV = 64 * NK;" in src


@pytest.mark.parametrize("n_split", N_SPLITS)
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_decode_split_matches_plain(case, n_split):
    """Split-and-combine over ``n_split`` chunks (a chunk with no valid
    slot, a wrapped ring, a window, G 48) equals the single softmax to
    one bf16 ulp: the same f32 sums in another order."""
    B, H, K, hd, W, window, fill = case
    (_, q), (_, kc), (_, vc), kv_pos, q_pos = _ring_inputs(case, seed=4)
    kv_pos = torch.from_numpy(kv_pos).expand(B, W)
    q_pos = torch.from_numpy(q_pos).expand(B)
    chunk = -(-W // n_split)
    if case == SPLIT_CASES[0] and n_split > 1:   # the last chunk is empty
        assert not bool((kv_pos[0, (n_split - 1) * chunk:] >= 0).any())
    got = pr.decode_split(q, kc, vc, kv_pos, q_pos, window=window,
                          chunk=chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, hd)
    assert bool(torch.isfinite(got.float()).all())
    _within_one_ulp(got, pr.decode_ref(q, kc, vc, kv_pos, q_pos,
                                       window=window))


@pytest.mark.parametrize("n_split", N_SPLITS)
def test_decode_split_matches_repro_at_g48(n_split):
    case = SPLIT_CASES[3]
    B, H, K, hd, W, window, fill = case
    (qj, qt), (kj, kt), (vj, vt), kv_pos, q_pos = _ring_inputs(case, seed=5)
    want = j_pa.decode_attention(qj[:, None], kj, vj,
                                 q_pos=jnp.asarray(q_pos),
                                 kv_pos=jnp.asarray(kv_pos), window=window,
                                 rope_theta=0.0, block_kv=32)
    got = pr.decode_split(qt, kt, vt, torch.from_numpy(kv_pos).expand(B, W),
                          torch.from_numpy(q_pos).expand(B), window=window,
                          chunk=-(-W // n_split))
    np.testing.assert_allclose(_f32(got), _f32(want[:, 0]), atol=DECODE_TOL,
                               rtol=DECODE_TOL)


def test_decode_split_all_masked_is_the_single_pass():
    """With no valid slot anywhere the single pass weighs every slot
    equally (each p = exp(-1e30 + 1e30) = 1); the combine does too, and
    stays finite."""
    case = SPLIT_CASES[0]
    B, H, K, hd, W, window, fill = case
    (_, q), (_, kc), (_, vc), _, _ = _ring_inputs(case, seed=9)
    kv_pos = torch.full((B, W), -1, dtype=torch.int32)
    q_pos = torch.full((B,), 5, dtype=torch.int32)
    want = pr.decode_ref(q, kc, vc, kv_pos, q_pos, window=0)
    for chunk in (W, 50, 7):
        got = pr.decode_split(q, kc, vc, kv_pos, q_pos, window=0,
                              chunk=chunk)
        _within_one_ulp(got, want)


@pytest.mark.parametrize("W,blocks,want", [
    (28, 16, (1, 64)),        # one tile: one split, no combine
    (64, 16, (1, 64)),
    (520, 16, (9, 64)),       # tinyllama's golden run
    (4100, 16, (33, 128)),    # a wrapped 4 100-slot ring
    (4100, 12, (33, 128)),    # granite: B 4 x K 1 x 3 head tiles
    (4100, 264, (2, 2112)),
    (4100, 2048, (1, 4160)),  # enough blocks already
])
def test_plan_split(W, blocks, want):
    n_split, chunk = pk.plan_split(W, blocks, sms=132)
    assert (n_split, chunk) == want
    assert chunk % pk.TILE == 0 and (n_split - 1) * chunk < W <= \
        n_split * chunk


@pytest.mark.parametrize("G,want", [(1, (1, 1)), (8, (1, 8)),
                                    (16, (1, 16)), (20, (2, 10)),
                                    (48, (3, 16)), (128, (8, 16))])
def test_group_tiles(G, want):
    n_gt, gts = pk.group_tiles(G)
    assert (n_gt, gts) == want and n_gt * gts >= G > (n_gt - 1) * gts


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


def test_library_key_covers_the_shared_headers(monkeypatch, tmp_path):
    """A kernel library is keyed by its sources and the shared headers
    (``kernels/include``), so an edited header rebuilds both kernels: the
    tensor-core tile and the backward entries' wgmma / TMA header."""
    import shutil

    from repro_torch import _build
    src = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / \
        "csrc" / "flash_attention.cu"
    before = _build.library_path("flash_attention", [src])
    for header in ("mma_tile.cuh", "wgmma_tma.cuh"):
        assert f'#include "{header}"' in src.read_text()
        assert (_build.INCLUDE_DIR / header).is_file()
        edited = tmp_path / header.split(".")[0]
        shutil.copytree(_build.INCLUDE_DIR, edited)
        monkeypatch.setattr(_build, "INCLUDE_DIR", edited)
        assert _build.library_path("flash_attention", [src]) == before
        (edited / header).write_text("// edited\n")
        assert _build.library_path("flash_attention", [src]) != before
        monkeypatch.undo()


def _c_params(rel: str, fn: str) -> list[str]:
    src = (ROOT / "src" / "repro_torch" / "kernels" / rel).read_text()
    sig = re.search(rf"(?:int|void) {fn}\(([^)]*)\)", src).group(1)
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
    ("paged_attention/csrc/paged_attention.cu", "paged_attention_counts",
     pk),
])
def test_launch_arguments_match_the_cuda_source(rel, fn, kernel_mod,
                                                monkeypatch):
    """kernel.py's ctypes signature has the C function's arity and
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
    B, S, Skv, H, K, hd, causal, window = _dims(case)
    (_, q), (_, k), (_, v) = _flash_inputs(case, dtype, seed=1)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches == before + 1
    want = fr.flash_attention_ref(q, k, v, causal=causal, window=window)
    atol, rtol = KERNEL_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _counted(run):
    """``run()`` and the decode library's launch counts it made."""
    pk.launch_counts(reset=True)
    out = run()
    return out, pk.launch_counts(reset=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", N_SPLITS)
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_decode_kernel_split_matches_plain(cuda, case, n_split,
                                           monkeypatch):
    """The kernel with ``n_split`` chunks pinned (``plan_split`` patched;
    a chunk with no valid slot among them) against the plain version and
    its split emulation; the library launched the split kernel once over
    ``n_split`` chunks, and the combine once where there are several."""
    B, H, K, hd, W, window, fill = case
    (_, q), (_, kc), (_, vc), kv_pos, q_pos = _ring_inputs(case, seed=3)
    q, kc, vc = q.to(cuda), kc.to(cuda), vc.to(cuda)
    kv_pos = torch.from_numpy(kv_pos).to(cuda)
    q_pos = torch.from_numpy(q_pos).to(cuda)
    chunk = -(-W // n_split)
    monkeypatch.setattr(pk, "plan_split",
                        lambda W, blocks, sms: (n_split, chunk))
    got, counts = _counted(lambda: pk.decode_attention(
        q, kc, vc, kv_pos, q_pos, window=window))
    assert counts == {"paged_attention_kernel": 0, pk.MMA_ENTRY: 1,
                      "mma_chunks": n_split,
                      pk.COMBINE_ENTRY: int(n_split > 1)}
    args = (q, kc, vc, kv_pos.expand(B, W), q_pos.expand(B))
    _within_one_ulp(got, pr.decode_ref(*args, window=window))
    _within_one_ulp(got, pr.decode_split(*args, window=window, chunk=chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("case", [SPLIT_CASES[0], SPLIT_CASES[3]], ids=str)
def test_decode_kernel_f32_matches_plain(cuda, case, per_row):
    """f32 caches take the one-pass CUDA-core kernel (the bf16 path's
    tensor cores would round them; G 48 tiled across blocks), with slot
    positions shared by the batch or ``[B, W]``, within the f32 limit."""
    B, H, K, hd, W, window, fill = case
    (_, q), (_, kc), (_, vc), kv_pos, q_pos = _ring_inputs(case, seed=8)
    q, kc, vc = (x.float().to(cuda) for x in (q, kc, vc))
    kv_pos = torch.from_numpy(kv_pos).to(cuda).expand(B, W)
    q_pos = torch.from_numpy(q_pos).to(cuda)
    got, counts = _counted(lambda: pk.decode_attention(
        q, kc, vc, kv_pos.contiguous() if per_row else kv_pos[0], q_pos,
        window=window))
    assert got.dtype == torch.float32
    assert counts == {"paged_attention_kernel": 1, pk.MMA_ENTRY: 0,
                      "mma_chunks": 0, pk.COMBINE_ENTRY: 0}
    _within_one_ulp(got, pr.decode_ref(q, kc, vc, kv_pos, q_pos.expand(B),
                                       window=window), "f32")


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_kernel_matches_plain(cuda, case):
    B, H, K, hd, W, window, fill = case
    (_, q), (_, kc), (_, vc), kv_pos, q_pos = _decode_inputs(case, seed=2)
    q, kc, vc = q.to(cuda), kc.to(cuda), vc.to(cuda)
    kv_pos = torch.from_numpy(kv_pos).to(cuda)
    q_pos = torch.from_numpy(q_pos).to(cuda)
    before = pa.launches
    got, counts = _counted(lambda: pa.decode_attention(
        q, kc, vc, q_pos=q_pos, kv_pos=kv_pos, window=window))
    assert pa.launches == before + 1
    # one split kernel over plan_split's chunks; the combine iff several
    assert counts[pk.MMA_ENTRY] == 1 and counts["mma_chunks"] >= 1
    assert counts[pk.COMBINE_ENTRY] == int(counts["mma_chunks"] > 1)
    qr = t_layers.rope(q, q_pos[None], 10000.0)[:, 0]
    want = pr.decode_ref(qr, kc, vc, kv_pos.expand(B, W), q_pos.expand(B),
                         window=window)
    atol, rtol = KERNEL_TOL["bf16"]
    torch.testing.assert_close(got[:, 0].float(), want.float(), atol=atol,
                               rtol=rtol)
