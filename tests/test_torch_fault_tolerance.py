"""The port's fault-tolerant runtime (``repro_torch.runtime.
fault_tolerance``) and its drill (``examples/fault_tolerance_torch.py``)
against ``repro``'s, on the same inputs made from a seed with numpy:

* ``FailureDetector`` and ``StragglerMitigator`` over seeded random beat
  rounds and step-time dicts (hosts in a shuffled insertion order): every
  output, the missed-beat table and the EWMA (Python floats) equal;
* ``elastic_mesh_shape`` equal over 1-600 devices x model axis {1, 2, 8,
  16} x min_data {1, 2};
* ``RunReport`` equal on ``tests/test_substrate.py``'s 60-step schedule and
  on the example's 40-step one (failure at 25, straggler from 12);
* the drill on the CPU (reduced tinyllama, B 8 x 32) prints ``repro``'s
  example's lines (run here, and as recorded in ``golden_ft.json``, which
  chip_smoke holds the drill on the card to), and its parameters and
  AdamW state after the failure, the restore and the resume equal a
  straight 40-step run's bitwise.
"""

import contextlib
import importlib.util
import io
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import fault_tolerance as j_ft  # noqa: E402

from repro_torch import golden  # noqa: E402
from repro_torch.runtime import fault_tolerance as t_ft  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", range(4))
def test_failure_detector_matches_repro(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    cfg = dict(missed_beats_to_fail=int(rng.integers(1, 5)))
    jd = j_ft.FailureDetector(j_ft.FTConfig(**cfg), n)
    td = t_ft.FailureDetector(t_ft.FTConfig(**cfg), n)
    for _ in range(60):
        beats = rng.random(n) > rng.random() * 0.6
        got, want = td.observe(beats.copy()), jd.observe(beats.copy())
        assert got == want and all(type(h) is int for h in got)
        np.testing.assert_array_equal(td.missed, jd.missed)
        assert td.missed.dtype == jd.missed.dtype


@pytest.mark.parametrize("seed", range(4))
def test_straggler_mitigator_matches_repro(seed):
    rng = np.random.default_rng(100 + seed)
    cfg = dict(straggler_factor=float(rng.uniform(1.2, 3.0)),
               ewma_alpha=float(rng.uniform(0.05, 0.5)))
    jm = j_ft.StragglerMitigator(j_ft.FTConfig(**cfg))
    tm = t_ft.StragglerMitigator(t_ft.FTConfig(**cfg))
    for _ in range(80):
        hosts = rng.permutation(16)[:int(rng.integers(1, 17))]
        base = float(rng.uniform(0.5, 2.0))
        times = {int(h): base * float(rng.choice([1.0, 1.1, 4.0, 0.7]))
                 for h in hosts}
        assert tm.observe(dict(times)) == jm.observe(dict(times))
        assert type(tm.ewma) is float and tm.ewma == jm.ewma
        assert tm.redispatched == jm.redispatched


@pytest.mark.parametrize("model_axis", [1, 2, 8, 16])
def test_elastic_mesh_shape_matches_repro(model_axis):
    for min_data in (1, 2):
        for n in range(1, 601):
            got = t_ft.elastic_mesh_shape(n, model_axis, min_data)
            assert got == j_ft.elastic_mesh_shape(n, model_axis, min_data)
            assert all(type(x) is int for x in got)


def _run(ft, n_steps: int, mesh_scale: int, model_axis: int):
    """``ft.fault_tolerant_run`` on a schedule of both tests' shape (host
    3 fails at 25, host 5 straggles from 12): the report, the remeshed
    shapes and the calls in order."""
    cluster = ft.SimulatedCluster(8)
    saved, calls, shapes = {}, [], []

    def do_step(step, n_hosts):
        if step == 25:
            cluster.fail(3)
        if step == 12:
            cluster.make_straggler(5)
        calls.append(("step", step, n_hosts))
        return 1.0

    def save_ckpt(step):
        saved["step"] = step
        calls.append(("save", step))

    def restore_ckpt():
        calls.append(("restore",))
        return saved.get("step", 0)

    def remesh(n_alive):
        shapes.append(ft.elastic_mesh_shape(n_alive * mesh_scale,
                                            model_axis))
        calls.append(("remesh", n_alive))

    rep = ft.fault_tolerant_run(n_steps, cluster, ft.FTConfig(), do_step,
                                save_ckpt, restore_ckpt, remesh,
                                ckpt_every=10)
    return _report(rep), shapes, calls


def _report(rep) -> tuple:
    return (rep.steps_done, rep.failures, rep.redispatches, rep.remeshes,
            rep.restored_from)


@pytest.mark.parametrize("schedule", ["substrate_60", "example_40"])
def test_run_report_matches_repro(schedule):
    args = (60, 8, 8) if schedule == "substrate_60" else (40, 64, 16)
    got, want = _run(t_ft, *args), _run(j_ft, *args)
    assert got == want
    if schedule == "example_40":
        rec = golden.load_ft()["report"]
        assert got[0] == (40, [3], 36, [(28, 7)], [20]) == (
            rec["steps_done"], rec["failures"], rec["redispatches"],
            [tuple(r) for r in rec["remeshes"]], rec["restored_from"])
        assert got[1] == [(28, 16)]
        # 28 + 20 steps: the failure is seen three beats after step 25
        assert sum(c[0] == "step" for c in got[2]) == 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The reduced model's ops are tiny: with the other test processes
    busy, torch's intra-op threads only contend (60x slower seen)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drill():
    ex = _load("fault_tolerance_torch")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ex.main(["--device", "cpu"])
    return res, out.getvalue().splitlines()


def test_drill_prints_repro_lines(drill, tmp_path, monkeypatch):
    res, printed = drill
    ex = _load("fault_tolerance")
    monkeypatch.setattr(ex, "tempfile", types.SimpleNamespace(
        mkdtemp=lambda prefix="": str(tmp_path / prefix)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ex.main()
    want = out.getvalue().splitlines()
    assert printed == want == golden.load_ft()["lines"]
    assert "\n".join(res["lines"]).splitlines() == printed
    assert _report(res["report"]) == (40, [3], 36, [(28, 7)], [20])
    steps = [s for s, _ in res["losses"]]
    assert steps == list(range(28)) + list(range(20, 40))
    losses = [v for _, v in res["losses"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_drill_equals_a_straight_run_bitwise(drill):
    """The drill's model and AdamW state after 48 steps (a restore from
    step 20 at step 28) equal a straight 40-step run's from the same
    seed, bit for bit."""
    res, _ = drill
    ex = _load("fault_tolerance_torch")
    ref = ex.straight(["--device", "cpu"])
    assert ref["losses"] == sorted(dict(res["losses"]).items())
    got, want = ex.state_leaves(res), ex.state_leaves(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
