"""Fig 6.1 (speedup), Fig 6.3/6.4 (capacity) and Fig 6.2 (energy) through
the port's figure scripts (``repro_torch.figures``) against ``repro``'s
(``benchmarks/speedup.py``, ``capacity.py``, ``energy.py``) on the same
small traces (``tests/_torch_figures.py``): every cell of each figure's
Experiment bitwise, every derived float64 number equal, and the CSV rows
equal but for their wall times.  The port runs its plain engine
(``device="cpu"``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.figures import capacity, energy, speedup  # noqa: E402
from repro_torch.figures import common as C  # noqa: E402

from _torch_figures import (SIZES, assert_results_equal,  # noqa: E402
                            fields, repro_benchmarks, repro_sizes)

JC = repro_benchmarks()


@pytest.fixture(scope="module")
def jc():
    if JC is None:
        pytest.skip("needs the JAX package (repro) to compare with")
    with repro_sizes(JC):
        yield JC


@pytest.fixture(scope="module")
def fig61(jc):
    from benchmarks import speedup as j_speedup
    (t1, us1), (t8, us8) = (C.timed(speedup.single_core, SIZES, "cpu"),
                            C.timed(speedup.eight_core, SIZES, "cpu"))
    return (t1, t8, speedup.rows(t1, us1, t8, us8), j_speedup.single_core(),
            j_speedup.eight_core(), j_speedup.run())


def test_speedup_single_core_numbers_equal_repro(fig61):
    t1, _, _, j1, _, _ = fig61
    assert t1["avg"] == j1["avg"] and t1["max"] == j1["max"]
    assert t1["lowered_frac"] == j1["lowered_frac"]
    for m in speedup.MECHS:
        assert t1["per_workload"][m] == {k: float(v) for k, v in
                                         j1["per_workload"][m].items()}


def test_speedup_eight_core_numbers_equal_repro(fig61):
    _, t8, _, _, j8, _ = fig61
    assert t8["per_mix"] == j8["per_mix"]
    assert t8["avg"] == j8["avg"] and t8["max"] == j8["max"]
    assert t8["lowered_frac"] == j8["lowered_frac"]


def test_speedup_cells_and_rows_equal_repro(fig61, jc):
    t1, t8, rows, _, _, jrows = fig61
    assert fields(rows) == fields(jrows)
    assert_results_equal(jc.experiment_singles(jc.SINGLE_NAMES,
                                               speedup.AXES), t1["results"])
    assert_results_equal(jc.experiment_mixes(jc.eight_core_mixes(),
                                             speedup.AXES), t8["results"])
    # the thesis's eight-core ordering holds on these traces too
    a8 = t8["avg"]
    assert 1.0 < a8["chargecache"] < a8["cc_nuat"] < a8["lldram"]
    lowered = t8["results"].sel(mechanism="lldram").metric(
        "acts_lowered_frac")
    assert (lowered == 1.0).all()


@pytest.fixture(scope="module")
def fig63(jc):
    from benchmarks import capacity as j_capacity
    (h1, us1), (e8, us8) = (C.timed(capacity.single_hits, SIZES, "cpu"),
                            C.timed(capacity.eight, SIZES, "cpu"))
    return h1, e8, capacity.rows(h1, us1, e8, us8), j_capacity.run()


def test_capacity_rows_equal_repro(fig63):
    _, _, rows, jrows = fig63
    assert fields(rows) == fields(jrows)


def test_capacity_cells_and_numbers_equal_repro(fig63, jc):
    """The figure's numbers recomputed from ``repro``'s Experiment of the
    same grid (``benchmarks/capacity.py``'s formulas) are the port's."""
    h1, e8, _, _ = fig63
    jres1 = jc.experiment_singles(jc.SINGLE_NAMES, capacity.SINGLE_AXES)
    assert_results_equal(jres1, h1["results"])
    jres8 = jc.experiment_mixes(jc.eight_core_mixes()[:5],
                                capacity.EIGHT_AXES)
    assert_results_equal(jres8, e8["results"])
    for cap in capacity.CAPS:
        assert h1["hits"][cap] == float(jres1.sel(
            mechanism="chargecache", capacity=cap).metric(
            "hcrac_hit_rate").mean())
        at = jres8.sel(capacity=cap)
        assert e8["hits"][cap] == float(at.sel(
            mechanism="chargecache").metric("hcrac_hit_rate").mean())
        assert e8["speed"][cap] == float(at.pairwise(
            "mechanism", "base", lambda b, s: jc.weighted_speedup(
                b["core_end"], s["core_end"]))["chargecache"].mean())


@pytest.fixture(scope="module")
def fig62(jc):
    from benchmarks import energy as j_energy
    (r1, us1), (r8, us8) = (C.timed(energy.single, SIZES, "cpu"),
                            C.timed(energy.eight, SIZES, "cpu"))
    return r1, r8, energy.rows(r1, us1, r8, us8), j_energy


def test_energy_rows_equal_repro(fig62):
    _, _, rows, j_energy = fig62
    assert fields(rows) == fields(j_energy.run())


def test_energy_reductions_equal_repro(fig62, jc):
    r1, r8, _, j_energy = fig62
    jres1 = jc.experiment_singles(jc.SINGLE_NAMES, energy.AXES)
    jres8 = jc.experiment_mixes(jc.eight_core_mixes(), energy.AXES)
    assert_results_equal(jres1, r1["results"])
    assert_results_equal(jres8, r8["results"])
    np.testing.assert_array_equal(r1["reduction"], jres1.pairwise(
        "mechanism", "base", j_energy.reduction)["chargecache"])
    np.testing.assert_array_equal(r8["reduction"], jres8.pairwise(
        "mechanism", "base", j_energy.reduction)["chargecache"])
