"""The core functions the port gained last, against ``repro``'s:
the charge model's integrator (``bitline_waveform``,
``t_ready_ns_numeric``), the HCRAC's ``storage_bits`` and ``occupancy``,
``dram.in_active_geometry``, and the charge-model figure's CSV rows.

Tolerances: ``bitline_waveform`` is bitwise (both packages take the same
float32 start and the same correctly rounded multiply and min each
step; the stated limit would have been one float32 ulp a value);
``t_ready_ns_numeric`` is then exactly equal, ``inf`` included;
``storage_bits`` and ``in_active_geometry`` are integer and bool, equal;
``occupancy`` is a float32 mean of the same bools, equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import charge_model as j_cm
    from repro.core import dram as j_dram
    from repro.core import hcrac as j_hcrac
except ImportError:    # no JAX here: only the port-internal tests run
    j_cm = None

from repro_torch.core import charge_model as t_cm  # noqa: E402
from repro_torch.core import dram as t_dram  # noqa: E402
from repro_torch.core import hcrac as t_hcrac  # noqa: E402
from repro_torch.figures import charge_model as t_fig  # noqa: E402


@pytest.fixture(scope="module")
def jax_ref():
    if j_cm is None:
        pytest.skip("needs the JAX package (repro) to compare with")


@pytest.mark.parametrize("idle_ms", [0.0, 1.0, 16.0, 64.0, 1e4])
def test_bitline_waveform_bitwise(jax_ref, idle_ms):
    jt, jv = j_cm.bitline_waveform(idle_ms)
    tt, tv = t_cm.bitline_waveform(idle_ms)
    assert tv.dtype == torch.float32 and tv.shape == (6000,)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("idle_ms", [0.0, 1.0, 16.0, 64.0, 1e4])
def test_t_ready_ns_numeric(jax_ref, idle_ms):
    assert t_cm.t_ready_ns_numeric(idle_ms) == j_cm.t_ready_ns_numeric(
        idle_ms)


def test_t_ready_numeric_inf_past_the_window():
    """A cell so decayed that the bitline never crosses the ready margin
    in the integration window reports inf, not the window's first step
    (``tests/test_refresh.py``'s case)."""
    assert np.isfinite(t_cm.t_ready_ns_numeric(64.0))
    assert t_cm.t_ready_ns_numeric(1e4) == float("inf")


@pytest.mark.parametrize("n_ranks", [1, 2])
@pytest.mark.parametrize("n_ways", [2, 4, 16])
def test_storage_bits(jax_ref, n_ways, n_ranks):
    kw = dict(n_entries=128, n_ways=n_ways)
    assert t_hcrac.storage_bits(t_hcrac.HCRACConfig(**kw),
                                n_ranks=n_ranks) == j_hcrac.storage_bits(
        j_hcrac.HCRACConfig(**kw), n_ranks=n_ranks)


def test_storage_bits_thesis_figure():
    """Thesis section 6.3: 128 entries of 21 bits, 336 B a core and a
    channel."""
    bits = t_hcrac.storage_bits(t_hcrac.HCRACConfig(n_entries=128,
                                                    n_ways=2))
    assert bits / 8 == 336


@pytest.mark.parametrize("exact", [False, True])
def test_occupancy_on_a_carried_state(jax_ref, exact):
    """A table filled by ``repro``'s inserts, carried across with
    ``state_from_numpy``: the port's occupancy equals ``repro``'s at
    several cycles, one table a point of a ``[G]`` batch."""
    rng = np.random.default_rng(3)
    kw = dict(n_entries=64, n_ways=2, caching_cycles=5_000,
              exact_expiry=exact)
    jcfg, tcfg = j_hcrac.HCRACConfig(**kw), t_hcrac.HCRACConfig(**kw)
    st = j_hcrac.init(jcfg)
    for t in np.sort(rng.integers(0, 20_000, 120)):
        st = j_hcrac.insert(jcfg, st, jnp.int32(rng.integers(0, 4096)),
                            jnp.int32(t))
    ts = (0, 4_000, 12_000, 19_000, 23_000, 40_000)
    tst = t_hcrac.state_from_numpy(*(np.stack([np.asarray(x)] * len(ts))
                                     for x in st))
    got = t_hcrac.occupancy(tcfg, tst, torch.tensor(ts, dtype=torch.int32))
    want = [float(j_hcrac.occupancy(jcfg, st, jnp.int32(t))) for t in ts]
    np.testing.assert_array_equal(got.numpy(), np.float32(want))
    assert 0.0 < float(got.max()) <= 1.0


def test_in_active_geometry(jax_ref):
    """Padded envelope addresses, negative and past-the-end banks and
    rows: the same bools as ``repro``'s."""
    cfg = dict(n_channels=2, n_ranks=1, n_banks=8, n_rows=1024)
    jg = j_dram.geom_params(j_dram.DRAMConfig(**cfg))
    tg = t_dram.geom_params(t_dram.DRAMConfig(**cfg))
    bank = np.array([0, 15, 16, 31, -1, 7, 3, 2**20], np.int32)
    row = np.array([0, 1023, 5, 1024, 9, -3, 2**30, 0], np.int32)
    want = np.asarray(j_dram.in_active_geometry(jg, jnp.asarray(bank),
                                                jnp.asarray(row)))
    got = t_dram.in_active_geometry(tg, torch.from_numpy(bank),
                                    torch.from_numpy(row))
    np.testing.assert_array_equal(want, got.numpy())
    assert want.tolist() == [True, True, False, False, False, False, False,
                             False]


def test_figure_rows_match_repro(jax_ref):
    """``figures/charge_model.py`` prints the rows of
    ``benchmarks/charge_model_bench.py`` (the timing column aside)."""
    from benchmarks import charge_model_bench
    strip = lambda r: (r.split(",")[0], r.split(",", 2)[2])
    assert [strip(r) for r in t_fig.run()] == [
        strip(r) for r in charge_model_bench.run()]
