"""The port's streaming half of the Experiment layer — the ``reduce=``
path, the streaming aggregations, ``ResultsWriter`` / ``from_jsonl`` —
against ``repro``'s and inside the port (the counterparts of
``tests/test_streaming.py``).

* Reduce parity in each launch mode (trace / synthetic / serving): the
  streamed metrics equal the full-stats path's bit for bit, and the
  float64 values equal ``repro``'s reduced run (synthetic: where the two
  packages generate the same streams, which is checked first).
* Chunked + pipelined runs change nothing; ``pipeline_depth=0`` is the
  same run.
* Streamed ``Results``: ``.sel`` / ``.metric`` / ``.pairwise`` as on the
  object cells; JSONL round trips (float axis labels included), a JSONL
  ``repro`` wrote loads in the port; the writer's coverage contract.
* The progress contract: monotone, mode-uniform, ends at ``total``.
* Aggregations (``mean`` / ``min`` / ``max`` / ``argbest``) fold per
  chunk to what a dense pass gives, and to ``repro``'s aggregators' own
  values; ``resolve`` / ``deps_for`` as ``repro``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from repro.core import metrics as j_metrics
    from repro.core import simulator as j_sim
    from repro.core import traces as j_traces
    from repro.experiment.results import Results as JResults
    from repro.experiment.spec import Experiment as JExperiment
    from repro.serving.loop import ServingSpec as JSpec
    from repro.serving.loop import engine as j_serve_eng
    from repro.workloads import materialize as j_materialize
    from repro.workloads.arrivals import ArrivalConfig as JArrival
except ImportError:    # no JAX here: only the port-internal tests run
    j_sim = None

from repro_torch import golden  # noqa: E402
from repro_torch.core import simulator as sim_mod  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.core.traces import (WorkloadSpec,  # noqa: E402
                                     multicore_batch, single_core_batch)
from repro_torch.experiment import metrics as metrics_lib  # noqa: E402
from repro_torch.experiment import registry  # noqa: E402
from repro_torch.experiment.results import Results, ResultsWriter  # noqa: E402
from repro_torch.experiment.spec import Experiment  # noqa: E402
from repro_torch.serving.loop import ServingSpec  # noqa: E402
from repro_torch.serving.loop import engine as serve_eng  # noqa: E402
from repro_torch.workloads import materialize as t_materialize  # noqa: E402
from repro_torch.workloads.arrivals import ArrivalConfig  # noqa: E402

from _torch_streams import stream_diff  # noqa: E402

MODES = ("trace", "synth", "serving")
SERVE_KW = dict(n_reqs=24, max_batch=4, queue_cap=32, arrivals_max=4,
                n_steps=48, cycles_per_step=4000, hot_entries=1018,
                hot_ways=2, hot_caching_ms=0.05, hot_exact=True)
SERVE_ARR = dict(rate=1.5, burstiness=1.0, prompt_pages_min=1,
                 prompt_pages_max=2, decode_min=4, decode_max=12, seed=7)
MIXES = {"a": (["stream_copy_like", "tpcc64_like"], 0),
         "b": (["stream_triad_like", "hmmer_like"], 1)}


@pytest.fixture(scope="module")
def jax_ref():
    if j_sim is None:
        pytest.skip("needs the JAX package (repro) to compare with")


def _experiment(mode: str, pkg: str = "port", **kw):
    """A small grid in each launch mode (``chunk_size=2``: several
    launches), in the port (``device="cpu"``) or in ``repro``.  The sim
    modes sweep every registered mechanism, serving every registered
    serving policy."""
    port = pkg == "port"
    E = Experiment if port else JExperiment
    S = SimConfig if port else j_sim.SimConfig
    if port:
        kw["device"] = "cpu"
    if mode == "trace":
        make = multicore_batch if port else j_traces.multicore_batch
        traces = {k: make(names, n_req=64, seed=seed)
                  for k, (names, seed) in MIXES.items()}
        return E(traces=traces, axes={"mechanism": registry.names(),
                                      "capacity": (32, 1024)},
                 chunk_size=2, **kw)
    if mode == "synth":
        W = WorkloadSpec if port else j_traces.WorkloadSpec
        base = S(workload=W(names=("stream_copy_like",), n_req=64, seed=0))
        return E(traces=None, base=base,
                 axes={"workload": {"copy": ["stream_copy_like"],
                                    "triad": ["stream_triad_like"]},
                       "mechanism": registry.names()},
                 chunk_size=2, **kw)
    spec = (ServingSpec(arrival=ArrivalConfig(**SERVE_ARR), **SERVE_KW)
            if port else JSpec(arrival=JArrival(**SERVE_ARR), **SERVE_KW))
    return E(traces=None, base=S(serving=spec),
             axes={"policy": ["fifo", "charge_aware", "preempting"],
                   "arrival_rate": (0.5, 2.0)},
             chunk_size=2, **kw)


def _valid_metrics(mode: str) -> tuple[str, ...]:
    """Every registered metric whose deps the mode can lower, plus two
    raw reducible keys (the identity-metric fallback)."""
    avail = (serve_eng.SERVE_REDUCE_KEYS if mode == "serving"
             else sim_mod.REDUCE_KEYS)
    names = []
    for n in metrics_lib.metric_names():
        try:
            metrics_lib.resolve([n], avail)
        except ValueError:
            continue
        names.append(n)
    return tuple(names) + ("total_cycles", "acts")


@pytest.fixture(scope="module")
def runs():
    """Each mode's full-stats run and reduced run, with progress logs."""
    out = {}
    for mode in MODES:
        calls = []
        full = _experiment(mode).run(
            progress=lambda d, t, calls=calls: calls.append((d, t)))
        red = _experiment(mode, reduce=_valid_metrics(mode)).run()
        out[mode] = (full, red, calls)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_streamed_vs_materialized_bitwise(runs, mode):
    names = _valid_metrics(mode)
    full, red, _ = runs[mode]
    assert red.streamed and not full.streamed
    assert red.metrics == names
    for m in names:
        assert np.array_equal(red.metric(m), full.metric(m)), m
    dim = red.dims[0]
    a, b = red.coords[dim][0], red.coords[dim][1]
    key = names[0]
    assert np.array_equal(red.sel(**{dim: b}).metric(key),
                          full.sel(**{dim: b}).metric(key))
    fn = lambda base, s: s[key] - base[key]
    assert np.array_equal(red.pairwise(dim, a, fn)[b],
                          full.pairwise(dim, a, fn)[b])


def _comparable(mode: str) -> np.ndarray | None:
    """Which cells of the mode's grid the two packages must agree on bit
    for bit: all of them for traces (same bytes, checked) and serving
    (counts drawn in both engines; the port's equal repro's here, which
    ``test_torch_serving.py`` checks), the points whose generated
    streams are equal for the synthetic grid."""
    if mode == "trace":
        for names, seed in MIXES.values():
            assert golden.trace_sha256(multicore_batch(
                names, n_req=64, seed=seed)) == golden.trace_sha256(
                j_traces.multicore_batch(names, n_req=64, seed=seed))
        return None
    if mode == "serving":
        return None
    exp, jexp = _experiment("synth"), _experiment("synth", "repro")
    _, _, tcfgs = exp.expand()
    _, _, jcfgs = jexp.expand()
    ok = [stream_diff(j_materialize(j.workload, j.dram, j.interleave),
                      t_materialize(t.workload, t.dram, t.interleave)) == 0
          for j, t in zip(jcfgs, tcfgs)]
    return np.asarray(ok).reshape(tuple(len(v) for v in exp.expand()[1]
                                        .values()))


@pytest.mark.parametrize("mode", MODES)
def test_reduced_run_matches_repro(runs, jax_ref, mode):
    """The reduced float64 metrics equal ``repro``'s reduced run of the
    same grid, and so do the meta's launch facts."""
    names = _valid_metrics(mode)
    _, red, _ = runs[mode]
    jred = _experiment(mode, "repro", reduce=names).run()
    assert jred.dims == red.dims and jred.coords == red.coords
    for k in ("n_unique", "n_chunks", "chunk_size", "n_launches"):
        assert red.meta[k] == jred.meta[k], k
    ok = _comparable(mode)
    for m in names:
        got, want = red.metric(m), jred.metric(m)
        if ok is None:
            assert np.array_equal(got, want), m
        else:
            assert ok.any()
            assert np.array_equal(got[ok], want[ok]), m


def test_chunked_pipelined_depth_is_invisible():
    """Many pipelined launches and the serial depth-0 loop give the same
    run; the launch meta counts one drain a chunk and trace group and
    one kernel launch a chunk and trace batch."""
    keys = ("avg_latency", "total_cycles")
    res = _experiment("trace", reduce=keys).run()
    res0 = _experiment("trace", reduce=keys, pipeline_depth=0).run()
    assert res.meta["n_chunks"] >= 2
    assert res.meta["n_launches"] == res.meta["n_chunks"]
    assert res.meta["n_kernel_launches"] == 2 * res.meta["n_chunks"]
    for m in res.metrics:
        assert np.array_equal(res.metric(m), res0.metric(m))


@pytest.mark.parametrize("mode", MODES)
def test_progress_contract(runs, mode):
    full, _, calls = runs[mode]
    n_rows = len(full.coords["trace"]) if mode == "trace" else 1
    total = full.meta["n_unique"] * n_rows
    assert all(t == total for _, t in calls)
    assert calls[-1][0] == total
    dones = [d for d, _ in calls]
    assert all(x < y for x, y in zip(dones, dones[1:]))
    assert len(calls) == full.meta["n_launches"]
    chunk, n_unique = full.meta["chunk_size"], full.meta["n_unique"]
    n_valid = [min(chunk, n_unique - i * chunk)
               for i in range(full.meta["n_chunks"])]
    steps = [b - a for a, b in zip([0] + dones, dones)]
    assert steps == [nv * n_rows for nv in n_valid]


AGG_EXP = dict(
    axes={"mechanism": ["base", "chargecache"],
          "duration_ms": (0.5, 1.0, 8.0)},   # float coordinate labels
    chunk_size=2, reduce=("avg_latency", "row_hit_rate"),
    aggregate={"best": ("argbest", "avg_latency"),
               "mean_lat": ("mean", "avg_latency"),
               "lo": ("min", "avg_latency"),
               "hi": ("max", "row_hit_rate")})


def _agg_experiment(pkg="port"):
    if pkg == "port":
        return Experiment(traces=None, device="cpu", base=SimConfig(
            workload=WorkloadSpec(names=("stream_copy_like",), n_req=64,
                                  seed=0)), **AGG_EXP)
    return JExperiment(traces=None, base=j_sim.SimConfig(
        workload=j_traces.WorkloadSpec(names=("stream_copy_like",),
                                       n_req=64, seed=0)), **AGG_EXP)


@pytest.fixture(scope="module")
def agg_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream") / "stream.jsonl")
    return _agg_experiment().run(stream_to=path), path


def test_streamed_jsonl_roundtrip_and_aggregates(agg_run):
    res, path = agg_run
    back = Results.from_jsonl(path)
    assert back.dims == res.dims
    assert back.coords["duration_ms"] == (0.5, 1.0, 8.0)
    for m in res.metrics:
        assert np.array_equal(back.metric(m), res.metric(m))
    lat = res.metric("avg_latency")
    agg = res.meta["aggregates"]
    assert agg["mean_lat"] == float(np.mean(lat))
    assert agg["lo"] == float(np.min(lat))
    assert agg["hi"] == float(np.max(res.metric("row_hit_rate")))
    fi = int(np.argmin(lat.reshape(-1)))
    assert agg["best"]["flat_index"] == fi
    assert agg["best"]["value"] == float(lat.reshape(-1)[fi])
    idx = np.unravel_index(fi, res.shape)
    assert agg["best"]["coords"] == {
        d: res.coords[d][int(i)] for d, i in zip(res.dims, idx)}
    assert back.meta["aggregates"]["mean_lat"] == agg["mean_lat"]


def test_jsonl_crosses_packages(agg_run, jax_ref, tmp_path):
    """A JSONL stream ``repro`` wrote loads in the port and the reverse;
    where the streams of this synthetic grid are equal (checked) the
    metrics and aggregates are ``repro``'s."""
    res, path = agg_run
    jpath = str(tmp_path / "repro.jsonl")
    jres = _agg_experiment("repro").run(stream_to=jpath)
    back = Results.from_jsonl(jpath)
    assert back.dims == res.dims and back.coords == res.coords
    jback = JResults.from_jsonl(path)
    for m in res.metrics:
        assert np.array_equal(jback.metric(m), res.metric(m))
        assert np.array_equal(back.metric(m), jres.metric(m))
    spec = WorkloadSpec(names=("stream_copy_like",), n_req=64, seed=0)
    jspec = j_traces.WorkloadSpec(names=("stream_copy_like",), n_req=64,
                                  seed=0)
    if stream_diff(j_materialize(jspec), t_materialize(spec)) == 0:
        for m in res.metrics:
            assert np.array_equal(res.metric(m), jres.metric(m))
        assert res.meta["aggregates"] == jres.meta["aggregates"]


def test_full_stats_stream_to(runs, tmp_path):
    """stream_to in full-stats mode carries every point's declared
    metrics."""
    path = str(tmp_path / "full.jsonl")
    res = _experiment("synth").run(stream_to=path)
    back = Results.from_jsonl(path)
    for m in res.metrics:
        assert np.array_equal(back.metric(m), res.metric(m))
    assert np.array_equal(res.metric("total_cycles"),
                          runs["synth"][0].metric("total_cycles"))


def test_writer_coverage_contract(tmp_path):
    path = str(tmp_path / "partial.jsonl")
    dims, coords = ("x",), {"x": (1, 2, 3)}
    with ResultsWriter(path, dims, coords, ("m",)) as w:
        w.write([0, 1], [[1.0], [2.0]])
    with pytest.raises(ValueError, match="covered"):
        Results.from_jsonl(path)
    path2 = str(tmp_path / "dup.jsonl")
    w = ResultsWriter(path2, dims, coords, ("m",))
    w.write([0, 1], [[1.0], [2.0]])
    w.write([1, 2], [[2.0], [3.0]])
    w.close()
    with pytest.raises(ValueError, match="twice"):
        Results.from_jsonl(path2)
    with open(path2, "w") as f:
        f.write('{"kind": "something-else"}\n')
    with pytest.raises(ValueError, match="stream"):
        Results.from_jsonl(path2)


def test_reduce_rejects_full_stats_only_features():
    batch = single_core_batch("milc_like", 64, seed=0)
    with pytest.raises(ValueError, match="RLTL"):
        Experiment(traces=batch, axes={"mechanism": ["base"]}, rltl=True,
                   reduce=("avg_latency",), device="cpu").run()
    with pytest.raises(ValueError, match="trace_metrics"):
        Experiment(traces={"t": batch}, axes={"mechanism": ["base"]},
                   trace_metrics={"t": {"extra": 1.0}},
                   reduce=("avg_latency",), device="cpu").run()
    with pytest.raises(ValueError, match="reducible"):
        Experiment(traces=batch, axes={"mechanism": ["base"]},
                   reduce=("no_such_metric",), device="cpu").run()
    with pytest.raises(ValueError, match="aggregate"):
        Experiment(traces=batch, axes={"mechanism": ["base"]},
                   aggregate={"x": ("mean", "avg_latency")},
                   device="cpu").run()


# ------------------------------------------- the registry against repro

def test_metric_registry_matches_repro(jax_ref):
    """The same registered metrics, and ``resolve`` / ``deps_for`` give
    the same ingredient keys in every mode."""
    assert metrics_lib.metric_names() == j_metrics.metric_names()
    assert metrics_lib.aggregation_names() == j_metrics.aggregation_names()
    for mode, avail, javail in (
            ("trace", sim_mod.REDUCE_KEYS, j_sim.REDUCE_KEYS),
            ("serving", serve_eng.SERVE_REDUCE_KEYS,
             j_serve_eng.SERVE_REDUCE_KEYS)):
        assert tuple(avail) == tuple(javail)
        names = _valid_metrics(mode)
        got = metrics_lib.resolve(names, avail)
        want = j_metrics.resolve(names, javail)
        assert [(m.name, m.deps, m.best) for m in got] == \
            [(m.name, m.deps, m.best) for m in want]
        assert metrics_lib.deps_for(got) == j_metrics.deps_for(want)


@pytest.mark.parametrize("agg", ["mean", "min", "max", "argbest"])
def test_aggregations_match_repro(jax_ref, agg):
    """Each aggregation folded over uneven chunks (ties included) equals
    ``repro``'s aggregator fed the same chunks, and the dense answer."""
    rng = np.random.default_rng(5)
    values = rng.integers(0, 7, 41).astype(np.float64) / 3.0
    for metric in ("avg_latency", "row_hit_rate"):
        m = metrics_lib.resolve([metric], sim_mod.REDUCE_KEYS)[0]
        jm = j_metrics.resolve([metric], j_sim.REDUCE_KEYS)[0]
        a, b = metrics_lib.make_aggregator(agg, m), \
            j_metrics.make_aggregator(agg, jm)
        for lo, hi in ((0, 5), (5, 6), (6, 6), (6, 29), (29, 41)):
            idx = np.arange(lo, hi)
            a.update(values[lo:hi], idx)
            b.update(values[lo:hi], idx)
        assert a.result() == b.result()
        dense = {"mean": float(np.mean(values)), "min": float(values.min()),
                 "max": float(values.max())}
        if agg in dense:
            assert a.result() == dense[agg]
        else:
            pick = (np.argmin(values) if m.best == "min"
                    else np.argmax(values))
            assert a.result() == {"value": float(values[pick]),
                                  "flat_index": int(pick)}
    with pytest.raises(ValueError, match="unknown aggregation"):
        metrics_lib.make_aggregator("median", m)


def test_registry_serving_reexports():
    from repro_torch.serving.loop import policies
    assert registry.serving_policy_names() == policies.names()
    assert registry.register_policy is policies.register_policy
    with pytest.raises(AttributeError):
        registry.no_such_name
