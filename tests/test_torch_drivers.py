"""The simulator-side studies of the port (``repro_torch.figures``:
geometry, aldram, refresh, workloads, sweep_bench, serving_trace,
serving_loop, megasweep and the ``run`` dispatcher) against ``repro``'s
drivers (``benchmarks/``) on the same seeded inputs, at reduced sizes
(``SIZES``: eight-core mixes of 200 requests a core, the serving grid at
64 requests, megasweep at 2 000 points): every cell (integer stats
bitwise; synthetic streams and serving counts under their rules,
``tests/_torch_streams.py``), the CSV rows' derived fields (wall times
left out, ``launches`` where ``repro`` counts compiles) and the JSON
documents' keys.  ``repro``'s drivers write their documents into
``tmp_path``; the port writes none unless asked.  Also
``timing.with_refresh_pressure`` against ``repro``'s.  The port runs its
plain engine (``device="cpu"``), where every driver makes no launch."""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import timing as t_timing  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402
from repro_torch.figures import (aldram, geometry, megasweep,  # noqa: E402
                                 refresh, serving_loop, serving_trace,
                                 sweep_bench, workloads)
from repro_torch.figures import common as C  # noqa: E402
from repro_torch.figures import run as t_run  # noqa: E402
from repro_torch.workloads import arrivals as t_arr  # noqa: E402
from repro_torch.workloads import materialize as t_materialize  # noqa: E402

from _parity import assert_cell_matches  # noqa: E402
from _torch_figures import (assert_results_equal, repro_benchmarks,  # noqa: E402
                            repro_sizes)
from _torch_streams import (assert_stats_under_rule,  # noqa: E402
                            assert_streams_under_rule, stream_diff)

ROOT = Path(__file__).resolve().parents[1]
JC = repro_benchmarks()

SIZES = C.Sizes(n_req_1c=300, n_req_8c=200, n_mixes=2,
                singles=("mcf_like",), sweep_req=400, scaling_lens=(60,),
                trace_reqs=16, trace_steps=40, serve_grid_reqs=64,
                serve_bursts=(1.0,), serve_scale=(60,), serve_host_reqs=24,
                megasweep=(2_000,))


@pytest.fixture(scope="module")
def jc():
    if JC is None:
        pytest.skip("needs the JAX package (repro) to compare with")
    with repro_sizes(JC, SIZES):
        yield JC


def repro_run(module, monkeypatch, tmp_path, json_attr=None, **globals_):
    """``repro``'s driver ``run()`` with its module globals resized and
    its document sent to ``tmp_path``, on fresh compile caches (its
    one-compile assertions count this process's compiles); returns its
    rows and its document (``None`` where it writes none)."""
    import jax
    for k, v in globals_.items():
        monkeypatch.setattr(module, k, v)
    path = None
    if json_attr is not None:
        path = tmp_path / f"{json_attr}.json"
        monkeypatch.setattr(module, json_attr, str(path))
    jax.clear_caches()
    rows = module.run()
    doc = json.loads(path.read_text()) if path is not None else None
    return rows, doc


def derived(rows) -> list[dict]:
    """Each row's ``derived`` field as a dict, ``repro``'s ``compiles``
    read as the port's ``launches`` key."""
    out = []
    for r in rows:
        name, _, rest = r.split(",", 2)
        d = dict(kv.split("=", 1) for kv in rest.split(";") if "=" in kv)
        if "compiles" in d:
            d["launches"] = d.pop("compiles")
        out.append({"name": name, **d})
    return out


def assert_rows_match(t_rows, j_rows, timed=(), launches=0):
    """The rows equal but for wall-time-derived fields (``timed``) and the
    launch count, which is the port's (``launches``) against ``repro``'s
    one compile."""
    t, j = derived(t_rows), derived(j_rows)
    assert [r.keys() for r in t] == [r.keys() for r in j]
    for a, b in zip(t, j):
        if "launches" in a:
            assert int(a.pop("launches")) == launches
            b.pop("launches")
        for k in timed:
            a.pop(k, None), b.pop(k, None)
        assert a == b


def doc_keys(doc) -> set:
    return {"launches" if k == "compiles" else k for k in doc}


# ------------------------------------------------------------ timing

@pytest.mark.parametrize("tp,factor", [
    (None, 1), (None, 2), (None, 4), (None, 2.5), (None, 64),
    ({"tREFI": 2001, "tRFC": 100}, 2)],
    ids=["1x", "2x", "4x", "2.5x", "floor", "half-even"])
def test_with_refresh_pressure_matches_repro(tp, factor):
    """tREFI / factor rounded half to even, floored at tRFC + 1, as in
    ``repro``; factors below 1 refused in both."""
    jt = pytest.importorskip("repro.core.timing")
    t = (t_timing.DDR3_1600 if tp is None
         else t_timing.TimingParams(**tp))
    j = jt.DDR3_1600 if tp is None else jt.TimingParams(**tp)
    got = t_timing.with_refresh_pressure(t, factor)
    want = jt.with_refresh_pressure(j, factor)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if factor == 64:
        assert got.tREFI == t.tRFC + 1
    if tp is not None:
        assert got.tREFI == 1000  # 1000.5 rounds to the even neighbour
    with pytest.raises(AssertionError):
        t_timing.with_refresh_pressure(t, 0.5)
    with pytest.raises(AssertionError):
        jt.with_refresh_pressure(j, 0.5)


# ------------------------------------------ geometry and aldram (traces)

@pytest.fixture(scope="module")
def geo(jc):
    return geometry.study(SIZES, "cpu")


def test_geometry_matches_repro(geo, jc, monkeypatch, tmp_path):
    from benchmarks import geometry as j_geo
    rows, doc = repro_run(j_geo, monkeypatch, tmp_path, "GEOMETRY_JSON")
    assert_rows_match(geometry.rows(geo), rows)
    assert doc_keys(doc) == set(geometry.document(geo))
    assert doc["speedup_by_geometry"] == geo["speedup_by_geometry"]
    jres, compiles = j_geo.geometry_grid()
    assert compiles == 0  # run() compiled it
    assert_results_equal(jres, geo["results"])
    assert geo["results"].meta["n_unique"] == jres.meta["n_unique"]
    assert geo["launches"] == 0
    assert geo["results"].meta["n_kernel_launches"] == geometry.N_MIXES


@pytest.fixture(scope="module")
def ald(jc):
    return aldram.study(SIZES, "cpu")


def test_aldram_matches_repro(ald, jc, monkeypatch, tmp_path):
    """Cells, speedups, the per-bank tRAS spread and the dedup of the
    temperature-blind mechanisms equal ``repro``'s."""
    from benchmarks import aldram as j_ald
    rows, doc = repro_run(j_ald, monkeypatch, tmp_path, "ALDRAM_JSON")
    assert_rows_match(aldram.rows(ald), rows)
    assert doc_keys(doc) == set(aldram.document(ald))
    assert doc["speedup_by_temperature"] == ald["speedup_by_temperature"]
    assert doc["per_bank_tras"] == ald["per_bank_tras"]
    jres = j_ald.aldram_grid()[0]
    assert_results_equal(jres, ald["results"])
    for k in ("n_points", "n_unique"):
        assert ald["results"].meta[k] == jres.meta[k]
    assert ald["launches"] == 0


# ------------------------------------- refresh and workloads (synthetic)

def _stream_pair(spec_kw, dram_kw=None, interleave="bank"):
    from repro.core import dram as j_dram
    from repro.core import traces as j_traces
    from repro.workloads import materialize as j_materialize
    from repro_torch.core import dram as t_dram
    dram_kw = dram_kw or {}
    jb = j_materialize(j_traces.WorkloadSpec(**spec_kw),
                       j_dram.DRAMConfig(**dram_kw),
                       j_dram.InterleaveConfig(interleave))
    tb = t_materialize(t_traces.WorkloadSpec(**spec_kw),
                       t_dram.DRAMConfig(**dram_kw),
                       t_dram.InterleaveConfig(interleave))
    assert_streams_under_rule(jb, tb)
    return stream_diff(jb, tb) == 0


@pytest.fixture(scope="module")
def ref_study(jc):
    return refresh.study(SIZES, "cpu")


def test_refresh_matches_repro(ref_study, jc, monkeypatch, tmp_path):
    """The stream first (under the rule); then every cell, bitwise where
    it is equal; the row, the headline numbers and the dedup (drift-blind
    and legacy-identical points) as ``repro``'s."""
    from benchmarks import refresh as j_ref
    base = C.sim_cfg("base", refresh.N_CORES)
    equal = _stream_pair(
        dict(names=("milc_like",) * refresh.N_CORES, n_req=SIZES.n_req_8c,
             seed=SIZES.seed),
        dict(n_channels=base.dram.n_channels, n_banks=base.dram.n_banks),
        base.interleave.kind)
    rows, doc = repro_run(j_ref, monkeypatch, tmp_path, "REFRESH_JSON")
    assert doc_keys(doc) == set(refresh.document(ref_study))
    jres = j_ref.refresh_grid()[0]
    tres = ref_study["results"]
    assert tres.dims == jres.dims and tres.coords == jres.coords
    for k in ("n_points", "n_unique"):
        assert tres.meta[k] == jres.meta[k]
    for j, t in zip(jres.cells.flat, tres.cells.flat):
        assert_stats_under_rule(j, t, equal)
    if equal:
        assert_rows_match(refresh.rows(ref_study), rows)
        mine = refresh.document(ref_study)
        assert {k: mine[k] for k in doc if k not in
                ("compiles", "cells", "meta")} == {
            k: v for k, v in doc.items()
            if k not in ("compiles", "cells", "meta")}
    assert refresh.failed_checks(ref_study) == []
    assert ref_study["launches"] == 0


def test_golden_refresh_record_holds_the_port_stream():
    """``golden_drivers.json`` (``repro``'s full-size refresh study, which
    chip_smoke holds the card to): its stream against the port's
    generator on the CPU (digest, else at most 5 % of its blocks), its
    cells on the study's grid, and ``repro``'s row agreeing with its
    headline numbers."""
    from repro_torch import golden
    gold = golden.load_drivers()["refresh"]
    base = C.sim_cfg("base", gold["n_cores"])
    batch = t_materialize(t_traces.WorkloadSpec(
        names=("milc_like",) * gold["n_cores"], n_req=gold["n_req"],
        seed=gold["seed"]), base.dram, base.interleave)
    if golden.trace_sha256(batch) != gold["stream_sha256"]:
        blocks = golden.stream_block_digests(batch)
        diff = sum(a != b for mine, theirs in zip(blocks,
                                                  gold["stream_blocks"])
                   for a, b in zip(mine, theirs))
        assert diff <= 0.05 * sum(map(len, blocks))
    exp = refresh.experiment(C.Sizes(n_req_8c=gold["n_req"]), "cpu")
    dims, coords, cfgs = exp.expand()
    assert gold["dims"] == list(dims)
    assert len(gold["cells"]) == len(cfgs) == gold["meta"]["n_points"]
    h = gold["headline"]
    assert (f"blocked_1x={h['ref_blocked_frac_1x']:.4f};"
            f"blocked_4x={h['ref_blocked_frac_4x']:.4f}") in gold["row"]


def test_pressure_axis_is_the_timing_axis():
    from repro_torch.experiment.spec import AXIS_BUILDERS
    assert AXIS_BUILDERS["pressure"] is AXIS_BUILDERS["timing"]
    assert refresh.PRESSURES["4x"] == t_timing.with_refresh_pressure(
        t_timing.DDR3_1600, 4)


@pytest.fixture(scope="module")
def wl(jc):
    return workloads.study(SIZES, "cpu")


def test_workloads_matches_repro(wl, jc, monkeypatch, tmp_path):
    """Every (mix, interleave, geometry) stream under the rule, then every
    cell; the interleave speedups and the rows where all streams are
    equal; the length-scaling keys."""
    from benchmarks import workloads as j_wl
    from repro_torch.experiment.spec import GEOMETRY_PRESETS
    rows, doc = repro_run(j_wl, monkeypatch, tmp_path, "WORKLOADS_JSON",
                          SCALING_LENS=SIZES.scaling_lens)
    assert doc_keys(doc) == set(workloads.document(wl))
    assert set(doc["length_scaling"]) == {
        str(n) for n in wl["length_scaling"]}
    for v in doc["length_scaling"].values():
        assert set(v) == set(next(iter(wl["length_scaling"].values())))
    jres = j_wl.synth_grid()[0]
    tres = wl["results"]
    assert tres.dims == jres.dims and tres.coords == jres.coords
    assert tres.meta["n_unique"] == jres.meta["n_unique"]
    all_equal = True
    for mix, names in workloads.MIXES.items():
        for il in workloads.INTERLEAVES:
            for g in workloads.GEOMS:
                geom = GEOMETRY_PRESETS[g]
                equal = _stream_pair(
                    dict(names=tuple(names), n_req=SIZES.n_req_8c,
                         seed=SIZES.seed),
                    dict(n_channels=geom.n_channels, n_banks=geom.n_banks),
                    il)
                all_equal &= equal
                for m in workloads.MECHS:
                    sel = dict(workload=mix, interleave=il, geometry=g,
                               mechanism=m)
                    assert_stats_under_rule(jres.point(**sel),
                                            tres.point(**sel), equal)
    if all_equal:
        assert doc["speedup_by_interleave"] == wl["speedup_by_interleave"]
        assert_rows_match(workloads.rows(wl), rows,
                          timed=[f"L{n}_ratio" for n in SIZES.scaling_lens])
    assert wl["launches"] == 0


# ---------------------------------------------------------- sweep_bench

def test_sweep_bench_matches_repro(jc, monkeypatch, tmp_path):
    from benchmarks import sweep_bench as j_sb
    from repro.core import sweep as j_sweep
    from repro.core.traces import single_core_batch as j_single
    out = sweep_bench.study(SIZES, "cpu")
    sized = lambda name, n, seed: j_single(name, SIZES.sweep_req, seed=seed)
    rows, _ = repro_run(j_sb, monkeypatch, tmp_path,
                        single_core_batch=sized)
    assert_rows_match(sweep_bench.rows(out), rows, timed=["us_per_point"])
    batch = sized(sweep_bench.WORKLOAD, None, sweep_bench.SEED)
    for j, t in zip(j_sweep(batch, j_sb_grid(jc)), out["warm"]):
        assert_cell_matches(j, t)
    assert out["launches"] == 0


def j_sb_grid(jc):
    from benchmarks import sweep_bench as j_sb
    return [jc.sim_cfg("chargecache", 1, n_entries=cap, caching_ms=d)
            for cap in j_sb.CAPS for d in j_sb.DURATIONS_MS]


# ------------------------------------------------------------- serving

def assert_serving_cells_under_rule(exp, jres, tres):
    """Each serving cell: the arrival counts of both packages compared
    first; where equal, the cell bitwise (stats and serving counters),
    else under ``repro``'s mirror rule (< 1e-3 of the counts differ)."""
    import jax.numpy as jnp
    from repro.workloads import arrivals as j_arr
    assert tres.dims == jres.dims and tres.coords == jres.coords
    n_equal = 0
    for cfg, j, t in zip(exp.expand()[2], jres.cells.flat, tres.cells.flat):
        sp = cfg.serving
        arr = {f: getattr(sp.arrival, f) for f in (
            "rate", "burstiness", "prompt_pages_min", "prompt_pages_max",
            "decode_min", "decode_max", "seed")}
        steps = np.arange(sp.steps(), dtype=np.int32)
        tc = t_arr.step_counts(t_arr.arrival_params(
            t_arr.ArrivalConfig(**arr), sp.n_reqs),
            torch.from_numpy(steps)).numpy()
        jcnt = np.asarray(j_arr.step_counts(jnp, j_arr.arrival_params(
            j_arr.ArrivalConfig(**arr), sp.n_reqs), jnp.asarray(steps)))
        if np.array_equal(tc, jcnt):
            n_equal += 1
            assert_cell_matches(j, t)
            for k in ("arrived", "dropped", "retired", "preempted",
                      "admit_hot", "admit_probes", "occ_sum", "qlen_sum"):
                assert int(t[k]) == int(j[k]), k
        else:
            assert np.mean(tc != jcnt) < 1e-3
    return n_equal


def test_serving_trace_matches_repro(jc, monkeypatch, tmp_path):
    """The host parity and the policy x mechanism grid at 16 requests x
    40 steps: the row and every cell as ``repro``'s."""
    from benchmarks import serving_trace as j_st
    out = serving_trace.study(SIZES, "cpu")
    rows, _ = repro_run(j_st, monkeypatch, tmp_path,
                        N_REQS=SIZES.trace_reqs, N_STEPS=SIZES.trace_steps)
    assert_rows_match(serving_trace.rows(out), rows)
    from repro.core.simulator import SimConfig as JSimConfig
    from repro.experiment import Experiment as JExperiment
    jres = JExperiment(traces=None,
                       axes={"policy": list(serving_trace.POLICIES),
                             "mechanism": list(serving_trace.MECHS)},
                       base=JSimConfig(mech=jc.mech_config("base"),
                                       serving=j_st._spec())).run()
    assert assert_serving_cells_under_rule(
        serving_trace.experiment(SIZES, "cpu"), jres, out["results"]) > 0
    assert out["parity"] and out["launches"] == 0


@pytest.fixture(scope="module")
def sloop(jc):
    return serving_loop.study(SIZES, "cpu")


def test_serving_loop_matches_repro(sloop, jc, monkeypatch, tmp_path):
    """The grid's cells (counts compared first), its per-policy numbers
    and ``ca_hot > fifo_hot``; every scale point's retirement, steps and
    hot rate; the rows but their times; the document's keys."""
    from benchmarks import serving_loop as j_sl
    rows, doc = repro_run(j_sl, monkeypatch, tmp_path, "SERVING_JSON",
                          GRID_REQS=SIZES.serve_grid_reqs,
                          BURSTS=SIZES.serve_bursts,
                          SCALE_NS=SIZES.serve_scale,
                          HOST_REQS=SIZES.serve_host_reqs)
    mine = serving_loop.document(sloop)
    assert doc_keys(doc) == set(mine)
    assert set(doc["grid"]) - {"compiles"} == set(mine["grid"]) - {
        "launches"}
    jres = j_sl.grid()[0]
    n_equal = assert_serving_cells_under_rule(
        serving_loop.experiment(SIZES, "cpu"), jres, sloop["results"])
    if n_equal == len(sloop["results"].cells.flat):
        assert doc["grid"]["by_policy"] == sloop["by_policy"]
        assert_rows_match(serving_loop.rows(sloop), rows, timed=[
            f"N{n}_us_per_req" for n in SIZES.serve_scale] + [
            "host_us_per_req", "host_over_traced"])
    for n, v in sloop["scale"].items():
        for k in ("n_steps", "retired", "admit_hot_rate"):
            assert doc["scale"][str(n)][k] == v[k], (n, k)
    assert sloop["launches"] == 0


def test_host_baseline_counts_equal_repros_draw():
    """The host baseline's arrival counts, drawn with the port's
    ``step_counts`` (no ``xp`` argument), are ``repro``'s numpy draw."""
    j_arr = pytest.importorskip("repro.workloads.arrivals")
    sp = serving_loop.spec(SIZES.serve_host_reqs, rate=8.0, max_batch=32)
    steps = np.arange(sp.steps(), dtype=np.int32)
    t = t_arr.step_counts(t_arr.arrival_params(sp.arrival, sp.n_reqs),
                          torch.from_numpy(steps)).numpy()
    ja = j_arr.ArrivalConfig(**{f: getattr(sp.arrival, f) for f in (
        "rate", "burstiness", "prompt_pages_min", "prompt_pages_max",
        "decode_min", "decode_max", "seed")})
    j = j_arr.step_counts(np, j_arr.arrival_params(ja, sp.n_reqs, xp=np),
                          steps)
    assert np.mean(t != j) < 1e-3


# ------------------------------------------------------------ megasweep

def test_megasweep_matches_repro(jc, tmp_path):
    """Both arms (each a subprocess) against ``repro``'s Experiment of the
    same grid: the metric arrays equal; the document's keys as
    ``repro``'s; the rows name the grid size."""
    from benchmarks import megasweep as j_ms
    n = SIZES.megasweep[0]
    out = megasweep.study(SIZES, "cpu")
    j = j_ms._experiment("full", n).run()
    for m in megasweep.METRICS:
        np.testing.assert_array_equal(out["arms"][n]["metrics"][m],
                                      j.metric(m))
    assert out["arms"][n]["full"]["n_points"] == int(np.prod(j.shape))
    want = {"quick", "chunk", "n_req", "metrics", f"speedup_{n}",
            "rss_growth_mb_full", "rss_growth_mb_streamed"} | {
        f"{k}_{mode}_{n}" for k in ("pps", "rss_mb")
        for mode in ("full", "streamed")}
    assert set(out["document"]) == want
    row = megasweep.rows(out)
    assert [r.split(",")[0] for r in row] == [f"megasweep_{n}"]
    assert out["arms"][n]["streamed"]["launches"] == 0


# ------------------------------------------------- dispatcher, artifacts

def test_run_dispatches_and_writes_only_where_asked(monkeypatch, tmp_path,
                                                    capsys):
    """``python -m repro_torch.figures.run --quick --only ...``: the CSV
    rows, then ``BENCH_results.json`` (``repro``'s layout) and each
    study's document under ``--json DIR``; nothing in the checkout's
    root, and nothing at all without ``--json``."""
    before = set(os.listdir(ROOT))
    monkeypatch.setattr(C, "QUICK", SIZES)
    assert t_run.main(["--quick", "--device", "cpu", "--only",
                       "sweep,charge_model"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [r.split(",")[0] for r in out[1:5]] == [
        "charge_table6.1", "charge_fig4.2", "sweep_grid_cold",
        "sweep_grid_warm"]
    d = tmp_path / "out"
    assert t_run.main(["--quick", "--device", "cpu", "--only",
                       "sweep,refresh", "--json", str(d)]) == 0
    assert sorted(os.listdir(d)) == ["BENCH_refresh.json",
                                     "BENCH_results.json"]
    res = json.loads((d / "BENCH_results.json").read_text())
    assert set(res) == {"sweep_grid_cold", "sweep_grid_warm",
                        "refresh_pressure_drift"}
    assert res["sweep_grid_cold"]["values"]["points"] == 20.0
    assert set(res["sweep_grid_cold"]) == {"us_per_call", "derived",
                                           "values"}
    assert set(os.listdir(ROOT)) == before


def test_run_reports_a_failing_driver(monkeypatch, capsys):
    def boom(*a, **kw):
        raise ValueError("boom")
    monkeypatch.setattr(sweep_bench, "run", boom)
    assert t_run.main(["--device", "cpu", "--only", "sweep"]) == 1
    assert "sweep,0,ERROR:ValueError" in capsys.readouterr().out


def test_parse_derived_matches_repro(jc):
    from benchmarks import run as j_run
    row = "x,12,a=1.5;b=text;c=3"
    mine, theirs = {}, {}
    t_run.record(mine, row)
    j_run._record(theirs, row)
    assert mine == theirs


def test_check_launches_holds_the_plan():
    """On the card the launches must equal the runner's plan (and the
    study's own promise); on the CPU there are none."""
    res = type("R", (), {"meta": {"n_kernel_launches": 2,
                                  "device": "cuda:0"}})()
    C.check_launches("x", res, 2, 2)
    C.check_launches("x", res, 2)
    for launches, per in ((1, 2), (2, 1), (3, None)):
        with pytest.raises(AssertionError):
            C.check_launches("x", res, launches, per)
    res.meta["device"] = "cpu"
    C.check_launches("x", res, 0, 1)
    with pytest.raises(AssertionError):
        C.check_launches("x", res, 1, 1)


def test_drivers_want_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_bench.study(SIZES)


# ------------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_drivers.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["geometry", "aldram", "refresh",
                                  "workloads", "serving_loop"])
def test_study_on_the_card_equals_the_plain_engine(cuda, name):
    """Each study on the card against the same study on the CPU: every
    cell bitwise (synthetic streams and drawn counts are held to the plain
    engine on the card by chip_smoke), and the launches the runner
    planned: one a mix for geometry and aldram, one for the others."""
    mod = {"geometry": geometry, "aldram": aldram, "refresh": refresh,
           "workloads": workloads, "serving_loop": serving_loop}[name]
    got = mod.study(SIZES, "cuda")
    want = mod.study(SIZES, "cpu")
    per = 2 if name in ("geometry", "aldram") else 1
    assert got["launches"] == per
    if name in ("geometry", "aldram"):
        assert_results_equal(want["results"], got["results"])
    else:
        assert got["results"].coords == want["results"].coords


@pytest.mark.cuda
def test_sweep_bench_and_megasweep_on_the_card(cuda):
    out = sweep_bench.study(SIZES, "cuda")
    assert out["launches"] == 2
    for a, b in zip(out["cold"], out["warm"]):
        assert_cell_matches(a, b)
    ms = megasweep.study(SIZES, "cuda")
    n = SIZES.megasweep[0]
    assert ms["arms"][n]["full"]["launches"] == \
        ms["arms"][n]["full"]["n_chunks"]
