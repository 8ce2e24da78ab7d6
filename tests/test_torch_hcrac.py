"""The HCRAC probe kernel tier of the PyTorch port, and the hot-page
tracker that calls it.

* Against ``repro`` on the CPU, exact: the port's plain probe
  (``kernels/hcrac/ref.py``, which ``ops.hcrac_lookup`` runs for CPU
  tensors) against ``repro``'s Pallas probe (interpret mode, as
  ``repro``'s own tests run it), its plain reference and a sequential
  ``lookup`` per query, in both expiry modes, negative gids included;
  the tracker's table after ``touch`` and its ``probe`` against
  ``repro``'s ``HotPageTracker``, page ids past int32 included.
* The CUDA kernel against its plain version, marked ``cuda``: these skip
  without a CUDA device and run on the card with
  ``python -m pytest -m cuda tests/test_torch_hcrac.py``.  The card's
  machine has no JAX, so ``repro`` is imported where it is there.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import hcrac as j_hcl
    from repro.kernels.hcrac import ops as j_ops
    from repro.kernels.hcrac.ref import hcrac_lookup_ref as j_ref
    from repro.serving.hot_pages import HotPageConfig as JHotCfg
    from repro.serving.hot_pages import HotPageTracker as JTracker
except ImportError:    # no JAX here: only the port-internal tests run
    j_hcl = None

from repro_torch.core import hcrac as t_hcl  # noqa: E402
from repro_torch.kernels.hcrac import kernel, ops, ref  # noqa: E402
from repro_torch.serving.hot_pages import HotPageConfig  # noqa: E402
from repro_torch.serving.hot_pages import HotPageTracker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_ref():
    if j_hcl is None:
        pytest.skip("needs the JAX package (repro) to compare with")


def _cfgs():
    # 10 000 cycles over 64 entries: a sweep period (156) that does not
    # divide the caching duration, so slot phases matter
    return [t_hcl.HCRACConfig(n_entries=64, n_ways=2, caching_cycles=10_000,
                              exact_expiry=exact) for exact in (False, True)]


def _j_table(cfg, seed):
    """``repro``'s table after 150 inserts of gids in [-500, 500)."""
    rng = np.random.default_rng(seed)
    jc = j_hcl.HCRACConfig(n_entries=cfg.n_entries, n_ways=cfg.n_ways,
                           caching_cycles=cfg.caching_cycles,
                           exact_expiry=cfg.exact_expiry)
    st = j_hcl.init(jc)
    t = 0
    for g, dt in zip(rng.integers(-500, 500, 150), rng.integers(1, 300, 150)):
        t += int(dt)
        st = j_hcl.insert(jc, st, jnp.int32(g), jnp.int32(t))
    return jc, st, t


@pytest.mark.parametrize("exact", [False, True], ids=["sweep", "exact"])
def test_plain_probe_matches_repro(jax_ref, exact):
    """Port's plain probe == repro's Pallas probe == its reference ==
    sequential lookup, on 96 queries (not a multiple of the Pallas
    block) at three query times, negative gids included."""
    cfg = _cfgs()[int(exact)]
    jc, jst, t = _j_table(cfg, seed=1)
    st = t_hcl.state_from_numpy(*map(np.asarray, jst))
    rng = np.random.default_rng(2)
    qg = rng.integers(-500, 500, 96).astype(np.int32)
    qg[:6] = [-5, -37, -1_000_003, -1, 0, 2**31 - 1]
    for dt in (10, 3_000, 9_000):
        qt = np.full(96, t + dt, np.int32)
        got = ref.hcrac_lookup_ref(cfg, st, torch.from_numpy(qg),
                                   torch.from_numpy(qt)).numpy()
        want_k = np.asarray(j_ops.hcrac_lookup(jc, jst, jnp.asarray(qg),
                                               jnp.asarray(qt)))
        want_r = np.asarray(j_ref(jc, jst, jnp.asarray(qg), jnp.asarray(qt)))
        want_s = np.asarray([bool(j_hcl.lookup(jc, jst, jnp.int32(g),
                                               jnp.int32(qt[0]))[0])
                             for g in qg])
        np.testing.assert_array_equal(got, want_r)
        np.testing.assert_array_equal(got, want_s)
        np.testing.assert_array_equal(got, want_k)
        if dt == 10:
            assert got.any() and not got.all()


def test_state_from_numpy_any_leading_shape():
    tags = np.arange(12, dtype=np.int64).reshape(6, 2) - 3
    st = t_hcl.state_from_numpy(tags, tags + 1, tags + 2)
    assert st.tags.dtype == torch.int32 and tuple(st.tags.shape) == (6, 2)
    np.testing.assert_array_equal(st.lru.numpy(), tags + 2)
    g = t_hcl.state_from_numpy(tags[None], tags[None], tags[None])
    assert tuple(g.itime.shape) == (1, 6, 2)


@pytest.mark.parametrize("exact", [False, True], ids=["sweep", "exact"])
def test_tracker_matches_repro(jax_ref, exact):
    """``touch`` (inserts in page order, G = 1) leaves the same table as
    repro's tracker, and ``probe`` gives the same hits, for page ids of
    the host scheduler (``rid * 131072 + k``) past 2**31, which both cast
    to int32 by wrapping."""
    hc = dict(n_entries=256, n_ways=2, caching_ms=0.005, exact_expiry=exact)
    jt, tt = JTracker(JHotCfg(**hc)), HotPageTracker(HotPageConfig(**hc),
                                                     device="cpu")
    rng = np.random.default_rng(4)
    now = 0
    for rid in rng.integers(0, 40_000, 24):
        pages = int(rid) * 131072 + np.arange(rng.integers(1, 4),
                                              dtype=np.int64)
        jt.touch(pages, now)
        tt.touch(pages, now)
        now += int(rng.integers(100, 900))
    for name in ("tags", "itime", "lru"):
        np.testing.assert_array_equal(getattr(tt.state, name)[0].numpy(),
                                      np.asarray(getattr(jt.state, name)))
    probe = np.concatenate([int(r) * 131072 + np.arange(3, dtype=np.int64)
                            for r in rng.integers(0, 40_000, 30)])
    for t in (now, now + 2_000):
        np.testing.assert_array_equal(tt.probe(probe, t), jt.probe(probe, t))
    assert tt.probe(np.zeros(0, np.int64), now).shape == (0,)
    assert (np.asarray(probe, np.int64).astype(np.int32) < 0).any()


def test_cpu_dispatch_is_the_plain_version():
    cfg = _cfgs()[0]
    st = t_hcl.state_from_numpy(np.full((32, 2), 7), np.zeros((32, 2)),
                                np.zeros((32, 2)))
    gids = torch.tensor([7, 8, -25], dtype=torch.int32)
    times = torch.tensor([5, 5, 20_000], dtype=torch.int32)
    before = ops.launches
    got = ops.hcrac_lookup(cfg, st, gids, times)
    assert ops.launches == before
    assert got.dtype == torch.bool
    assert got.tolist() == ref.hcrac_lookup_ref(cfg, st, gids, times).tolist()
    assert got.tolist() == [True, False, False]
    empty = ops.hcrac_lookup(cfg, st, gids[:0], times[:0])
    assert empty.shape == (0,) and ops.launches == before


def test_kernel_refuses_cpu_tensors():
    cfg = _cfgs()[0]
    z = torch.zeros((32, 2), dtype=torch.int32)
    q = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.hcrac_lookup(cfg, z, z, q, q)


def test_tracker_wants_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here; the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        HotPageTracker(HotPageConfig())


def test_launch_arguments_match_the_cuda_source():
    """kernel.py's ctypes signature has the C launcher's arity, ints
    where the source takes ints."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "hcrac" / "csrc"
           / "hcrac.cu").read_text()
    sig = re.search(r"int hcrac_lookup_launch\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in sig.split(",")]
    ints = [p.startswith("int ") for p in params]
    assert ints == [True] * 7 + [False] * 6


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_hcrac.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("entries,ways,exact", [(128, 2, False),
                                                (1024, 2, True),
                                                (65536, 16, False)])
def test_kernel_matches_plain(cuda, entries, ways, exact):
    cfg = t_hcl.HCRACConfig(n_entries=entries, n_ways=ways,
                            caching_cycles=40_000, exact_expiry=exact)
    rng = np.random.default_rng(entries)
    S = cfg.n_sets
    # each way holds a gid of its own set (a third negative) or is empty
    own = lambda sets: sets + S * rng.integers(-3, 3, sets.shape)
    tags = own(np.repeat(np.arange(S)[:, None], ways, axis=1))
    tags[rng.random((S, ways)) < 0.2] = -1
    itime = rng.integers(0, 100_000, (S, ways))
    st = t_hcl.state_from_numpy(tags, itime, itime, device=cuda)
    Q = 70_001                                  # not a multiple of 256
    gids = torch.from_numpy(own(rng.integers(0, S, Q)).astype(np.int32))
    times = torch.from_numpy(rng.integers(50_000, 150_000, Q)
                             .astype(np.int32))
    before = ops.launches
    got = ops.hcrac_lookup(cfg, st, gids.to(cuda), times.to(cuda))
    assert ops.launches == before + 1
    want = ref.hcrac_lookup_ref(cfg, st, gids.to(cuda), times.to(cuda))
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < Q
