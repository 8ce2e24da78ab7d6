"""The port's examples (``examples/*_torch.py``) against ``repro``'s
(``examples/chargecache_sim.py``, ``quickstart.py``'s
``chargecache_demo`` and ``train_step_demo``, ``serve_lm.py``'s
scheduler and DRAM closed loop), and ``train_lm_torch.py``'s resume
on the same seeded inputs at reduced sizes: the tables they print are
``repro``'s line for line (lines with a wall time left out), and the
tables the port's functions return hold the printed numbers.  The port
runs its plain engine (``--device cpu``)."""

import importlib.util
import os
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_ref():
    try:
        import jax  # noqa: F401
    except ImportError:
        pytest.skip("needs the JAX package (repro) to compare with")


def untimed(text: str) -> list[str]:
    """Printed lines without the ones that carry a wall time."""
    return [ln for ln in text.splitlines()
            if ln.strip() and "unique run" not in ln and "tok/s" not in ln]


@pytest.fixture(scope="module")
def sim_examples(jax_ref):
    return load("chargecache_sim_torch"), load("chargecache_sim")


@pytest.mark.parametrize("mode,n_req", [
    ([], 900), (["--eight-core"], 800), (["--heat-grid"], 600),
    (["--geo-grid"], 800)], ids=["table", "eight-core", "heat", "geo"])
def test_chargecache_sim_prints_repros_tables(sim_examples, mode, n_req,
                                              monkeypatch, capsys):
    port, ref = sim_examples
    argv = mode + ["--n-req", str(n_req)]
    got = port.main(argv + ["--device", "cpu"])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["chargecache_sim.py"] + argv)
    ref.main()
    theirs = capsys.readouterr().out
    assert untimed(mine) == untimed(theirs)
    if not mode or mode == ["--eight-core"]:
        for kind, row in got["rows"].items():
            assert f"{kind:>12s} {row['speedup']:8.4f}" in mine
        sp = {k: v["speedup"] for k, v in got["rows"].items()}
        assert sp["base"] == 1.0
    if mode == ["--eight-core"]:
        # the thesis's order through the example itself (on the card at
        # 60 000 requests in chip_smoke)
        assert 1.0 < sp["chargecache"] < sp["cc_nuat"] < sp["lldram"]
    if mode == ["--heat-grid"]:
        assert len(got["hit"]) == len(port.HEAT_CAPS)
    if mode == ["--geo-grid"]:
        assert set(got) == set(port.GEO_PRESETS)


def test_quickstart_prints_repros_demo(jax_ref, monkeypatch, capsys):
    """``chargecache_demo`` on a shortened soplex-like stream (the
    example's 40 000 requests cut to 1 500 in both packages)."""
    port, ref = load("quickstart_torch"), load("quickstart")
    for mod in (port, ref):
        orig = mod.single_core_batch
        monkeypatch.setattr(mod, "single_core_batch",
                            lambda name, n, seed, orig=orig: orig(
                                name, 1500, seed=seed))
    cells = port.chargecache_demo(device="cpu")
    mine = capsys.readouterr().out.splitlines()
    ref.chargecache_demo()
    theirs = capsys.readouterr().out.splitlines()
    # the heading names the workload it runs (repro's says mcf-like)
    assert mine[0] == theirs[0].replace("mcf-like", "soplex-like")
    assert mine[1:] == theirs[1:]
    assert int(cells["base"]["total_cycles"]) > int(
        cells["chargecache"]["total_cycles"])


def test_serve_lm_closed_loop_matches_repro(jax_ref, monkeypatch, capsys):
    """The scheduler's stats and the DRAM closed loop's line equal
    ``repro``'s (the same numpy draws after the prompts); the decoded
    tokens lie in the vocabulary (the two packages' random weights
    differ)."""
    port, ref = load("serve_lm_torch"), load("serve_lm")
    argv = ["--requests", "6", "--new", "3", "--batch", "2"]
    out = port.main(argv + ["--device", "cpu"])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"] + argv)
    ref.main()
    theirs = capsys.readouterr().out
    assert untimed(mine) == untimed(theirs)
    assert out["tokens"].shape == (3, 2)
    assert out["sched"].stats["retired"] == 6


def test_examples_want_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load("quickstart_torch").main([])


@pytest.mark.cuda
def test_examples_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_examples.py)")
    ex = load("chargecache_sim_torch")
    got = ex.main(["--n-req", "900"])
    want = ex.main(["--n-req", "900", "--device", "cpu"])
    assert got["rows"] == want["rows"]
    out = load("serve_lm_torch").main(["--requests", "4", "--new", "2"])
    assert out["sched"].stats["retired"] == 4


def _numbers(line: str) -> dict:
    return {k: float(v) for k, v in (w.split("=") for w in line.split()
                                     if "=" in w)}


def test_train_step_demo_prints_repros_lines(jax_ref, capsys):
    """``train_step_demo`` on ``repro``'s reduced tinyllama weights and
    batch (``zoo.init_model`` / ``make_batch`` draw with ``jax.random``,
    carried across): the same lines, the loss within the training tests'
    2^-6 and the gradient norm within 2^-6 of it (``tests/_torch_train.py``)
    — the printed 3 decimals may differ in the last."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get
    from repro.models import zoo as j_zoo
    from repro.models.config import ShapeConfig
    from repro_torch.configs import get as t_get
    from repro_torch.models import convert
    port, ref = load("quickstart_torch"), load("quickstart")
    ref.train_step_demo()
    theirs = capsys.readouterr().out.splitlines()
    cfg = get("tinyllama-1.1b").reduced()
    params = j_zoo.init_model(cfg, seed=0)
    batch = j_zoo.make_batch(cfg, ShapeConfig("demo", 64, 4, "train"))
    model = convert.from_repro(jax.tree_util.tree_map(np.asarray, params),
                               t_get("tinyllama-1.1b").reduced(),
                               device="cpu")
    tb = {k: torch.from_numpy(np.asarray(v, np.int64))
          for k, v in batch.items()}
    out = port.train_step_demo(device="cpu", model=model, batch=tb)
    mine = capsys.readouterr().out.splitlines()
    assert mine[0] == theirs[0] and len(mine) == len(theirs) == 2
    got, want = _numbers(mine[1]), _numbers(theirs[1])
    assert got.keys() == want.keys() == {"loss", "grad_norm"}
    assert abs(got["loss"] - want["loss"]) <= 2.0 ** -6 + 1e-3
    assert abs(got["grad_norm"] - want["grad_norm"]) <= (
        2.0 ** -6 * want["grad_norm"] + 1e-3)
    assert abs(out["loss"] - got["loss"]) <= 5e-4
    assert jnp.isfinite(out["grad_norm"])


def test_train_lm_resume_equals_a_straight_run(tmp_path, capsys):
    """``train_lm_torch.py --preset 15m`` on the CPU: 3 steps straight
    (a checkpoint at 2) against 2 steps, then ``--resume`` to 3 from the
    step-2 checkpoint; step 2's loss, the final parameters and the
    optimizer state bitwise equal."""
    ex = load("train_lm_torch")
    common = ["--device", "cpu", "--ckpt-every", "2"]
    a = ex.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "a")])
    ex.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    b = ex.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b"),
                          "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and b["start"] == 2
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000002"]
    assert a["losses"][2] == b["losses"][2] and list(b["losses"]) == [2]
    assert a["losses"][2] < a["losses"][0]
    for x, y in zip(a["model"].parameters(), b["model"].parameters()):
        assert torch.equal(x, y)
    from repro_torch.optim import adamw
    for x, y in zip(adamw.leaves(a["opt"].v), adamw.leaves(b["opt"].v)):
        assert torch.equal(x, y)
    assert int(a["opt"].step) == int(b["opt"].step) == 3
