"""Fig 3.1/3.2 (RLTL) and Fig 6.5 / Table 6.1 (caching duration) through
the port's figure scripts against ``repro``'s (``benchmarks/rltl.py``,
``duration.py``) on the same small traces (``tests/_torch_figures.py``),
the scheduler-policy study (``serving.study.policy_experiment``) against
``repro``'s, and the figures' command line.  The port runs its plain
engine (``device="cpu"``)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.figures import common as C  # noqa: E402
from repro_torch.figures import duration, rltl, speedup  # noqa: E402
from repro_torch.serving import study as t_study  # noqa: E402

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
def fig31(jc):
    from benchmarks import rltl as j_rltl
    out = {}
    for key, fn, args, jfn in (
            ("single_open", rltl.fig_3_1_single, ("open",),
             j_rltl.fig_3_1_single),
            ("single_closed", rltl.fig_3_1_single, ("closed",),
             j_rltl.fig_3_1_single),
            ("eight", rltl.fig_3_1_eight, ("closed",),
             j_rltl.fig_3_1_eight)):
        got, us = C.timed(fn, SIZES, *args, device="cpu")
        out[key] = (got, us, jfn(*args))
    return out


@pytest.mark.parametrize("key", ["single_open", "single_closed", "eight"])
def test_rltl_fractions_equal_repro(fig31, key):
    """Each workload's t-RLTL fractions, refresh fraction and activation
    count (from the RLTL histogram of an Experiment with ``rltl=True``)
    equal ``repro``'s per-trace ``simulate``, and so do the averages."""
    got, _, want = fig31[key]
    assert got["per_workload"] == want["per_workload"]
    assert got["avg"] == want["avg"]


def test_rltl_rows_equal_repro(fig31):
    from benchmarks import rltl as j_rltl
    rows = rltl.rows(*(x for k in ("single_open", "single_closed", "eight")
                       for x in fig31[k][:2]))
    assert fields(rows) == fields(j_rltl.run())


def test_duration_equals_repro(jc):
    """Fig 6.5: the Experiment's cells, the per-duration speedup and hit
    rate, and the CSV row (best duration included)."""
    from benchmarks import duration as j_duration
    got, us = C.timed(duration.work, SIZES, "cpu")
    jres = jc.experiment_mixes(jc.eight_core_mixes()[:5], duration.AXES)
    assert_results_equal(jres, got["results"])
    ws = lambda b, s: jc.weighted_speedup(b["core_end"], s["core_end"])
    for d in duration.DURATIONS_MS:
        at = jres.sel(duration_ms=d)
        assert got["avg"][d] == (
            float(at.pairwise("mechanism", "base", ws)["chargecache"].mean()),
            float(at.sel(mechanism="chargecache").metric(
                "hcrac_hit_rate").mean()))
    assert fields(duration.rows(got, us)) == fields(j_duration.run())


def test_policy_experiment_equals_repro(jc):
    """The scheduler-policy study: both schedulers' traces (their probes
    through the probe kernel's plain version) x {base, chargecache},
    cell for cell, with the per-policy ``hot_frac``."""
    from repro.serving import study as j_study
    kw = dict(n_reqs=8, steps=20, seed=11)
    exp = t_study.policy_experiment(device="cpu", **kw)
    assert exp.device == "cpu" and exp.trace_dim == "policy"
    res = exp.run()
    jres = j_study.policy_experiment(**kw).run()
    assert res.dims == ("policy", "mechanism")
    assert_results_equal(jres, res)
    for p in ("fifo", "charge_aware"):
        assert res.point(policy=p, mechanism="base")["hot_frac"] == \
            jres.point(policy=p, mechanism="base")["hot_frac"]


def test_figure_command_line(monkeypatch, capsys):
    """``python -m repro_torch.figures.<name> [--quick] [--device cpu]``:
    the CSV rows, then the ``sim_step`` launch count (none on the CPU)."""
    tiny = C.Sizes(n_req_1c=300, n_req_8c=60, n_mixes=1,
                   singles=("mcf_like",))
    monkeypatch.setattr(C, "QUICK", tiny)
    C.main(speedup.run, "Fig 6.1", ["--quick", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [r.split(",")[0] for r in out[:2]] == [
        "speedup_fig6.1_single", "speedup_fig6.1_eight"]
    assert out[2] == "# sim_step launches: 0"


def test_figures_want_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    tiny = C.Sizes(n_req_1c=50, singles=("mcf_like",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        speedup.single_core(tiny)
