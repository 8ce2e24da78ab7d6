"""The port's Experiment layer (``repro_torch.experiment``) and
``sweep_traces`` against ``repro``'s, and inside the port.

* Against ``repro`` on the CPU, on the same numpy-seeded traces (each
  package's own ``traces`` module, checked equal by
  ``golden.trace_sha256``): ``Experiment.run()`` cell for cell — every
  ``tests/_parity.py::BITWISE_KEYS`` stat, ``core_end`` and the per-bank
  accumulators bitwise — chunked and unchunked, on the mechanism,
  capacity, duration, temperature, temperature-drift, refresh, row-policy
  and geometry axes, over trace groups of two core counts; a synthetic
  workload × interleave grid (streams compared first, then the rule of
  ``tests/_torch_streams.py``); a serving grid over policy × arrival rate
  × burstiness (drawn counts compared first: where equal, bitwise);
  ``sweep_traces`` ``out[b][g]``; ``Results`` JSON written by either
  package loading in the other.
* Inside the port: the counterparts of ``tests/test_experiment.py`` —
  cells equal to direct ``sweep()`` / ``sweep_traces()`` even chunked,
  label selection, a toy mechanism with no simulator edits, cycle-free
  imports, dedup, memory-budget chunking — plus the port's own rules:
  CUDA unless ``device="cpu"``, the refused ``backend`` / ``frfcfs``
  axes, the ``ChunkScheduler``'s order and failures.
* The Experiment layer on the card against the plain engine, marked
  ``cuda``: skips without a CUDA device and runs there with
  ``python -m pytest -m cuda tests/test_torch_experiment.py``.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import simulator as j_sim
    from repro.core import traces as j_traces
    from repro.configs import aldram_ddr3 as j_aldram_cfg
    from repro.configs import chargecache_ddr3 as j_cc_cfg
    from repro.experiment import Experiment as JExperiment
    from repro.experiment import registry as j_reg
    from repro.experiment.results import Results as JResults
    from repro.serving.loop import ServingSpec as JSpec
    from repro.workloads import arrivals as j_arr
    from repro.workloads import materialize as j_materialize
except ImportError:    # no JAX here: only the port-internal tests run
    j_sim = None

from repro_torch import golden  # noqa: E402
from repro_torch.configs import aldram_ddr3, chargecache_ddr3  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402
from repro_torch.experiment import (Experiment, MechanismPolicy,  # noqa: E402
                                    Results, registry, register_mechanism)
from repro_torch.experiment import runner  # noqa: E402
from repro_torch.kernels.sim_step import ops  # noqa: E402
from repro_torch.serving.loop import ServingSpec  # noqa: E402
from repro_torch.workloads import arrivals as t_arr  # noqa: E402
from repro_torch.workloads import materialize as t_materialize  # noqa: E402

from _parity import BITWISE_KEYS, assert_cell_matches  # noqa: E402
from _torch_streams import (assert_stats_under_rule,  # noqa: E402
                            assert_streams_under_rule)

KINDS = registry.names()


@pytest.fixture(scope="module")
def jax_ref():
    if j_sim is None:
        pytest.skip("needs the JAX package (repro) to compare with")


def _batches(make, *args, **kw):
    """The same trace from both packages' ``traces`` (``make`` names the
    function), checked equal byte for byte; ``(repro's, port's)``."""
    t = getattr(t_traces, make)(*args, **kw)
    if j_sim is None:
        return None, t
    j = getattr(j_traces, make)(*args, **kw)
    assert golden.trace_sha256(j) == golden.trace_sha256(t)
    return j, t


def _same(j: dict, t: dict, rltl: bool = False):
    assert_cell_matches(j, t, rltl=rltl)
    for k in ("bank_acts", "bank_act_ras_sum"):
        np.testing.assert_array_equal(np.asarray(j[k]), t[k])


def _cells_equal(jres, tres, rltl: bool = False):
    assert tres.dims == jres.dims
    assert tres.coords == jres.coords
    assert tres.cells.shape == jres.cells.shape
    for j, t in zip(jres.cells.flat, tres.cells.flat):
        _same(j, t, rltl)


# ------------------------------------------------ chunked, all kinds

AXES_CHUNKED = {"mechanism": list(KINDS), "capacity": (48, 96)}


@pytest.fixture(scope="module")
def chunked():
    """Every registered kind x two capacities on one 700-request trace,
    five points a launch (12 unique points: a padded tail chunk);
    ``repro``'s run of the same experiment where JAX is there."""
    jb, tb = _batches("single_core_batch", "milc_like", 700, seed=9)
    exp = Experiment(traces=tb, axes=AXES_CHUNKED, chunk_size=5,
                     device="cpu")
    res = exp.run()
    jres = None
    if j_sim is not None:
        jres = JExperiment(traces=jb, axes=AXES_CHUNKED, chunk_size=5).run()
    return exp, tb, res, jres


def test_experiment_matches_sweep_even_chunked(chunked):
    exp, tb, res, _ = chunked
    assert res.meta["n_chunks"] >= 2
    assert res.meta["n_unique"] % res.meta["chunk_size"] != 0  # padded tail
    assert res.dims == ("mechanism", "capacity")
    # base dedups across the capacity axis
    assert res.meta["n_unique"] < res.meta["n_configs"]
    _, _, cfgs = exp.expand()
    for ref, got in zip(t_sim.sweep(tb, cfgs, rltl=False, device="cpu"),
                        res.cells.flat):
        _same(ref, got)


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_cells_match_repro(chunked, jax_ref, kind):
    _, _, res, jres = chunked
    assert jres.meta["n_unique"] == res.meta["n_unique"]
    assert jres.meta["n_chunks"] == res.meta["n_chunks"]
    for cap in AXES_CHUNKED["capacity"]:
        _same(jres.point(mechanism=kind, capacity=cap),
              res.point(mechanism=kind, capacity=cap))


# -------------------------------------- trace groups and sweep_traces

@pytest.fixture(scope="module")
def mixed_lengths():
    """Two single-core traces of different lengths (padded into one
    group) x three kinds through the Experiment and ``sweep_traces``."""
    pairs = {"milc_like": _batches("single_core_batch", "milc_like", 500,
                                   seed=5),
             "hmmer_like": _batches("single_core_batch", "hmmer_like", 400,
                                    seed=5)}
    axes = {"mechanism": ["base", "chargecache", "nuat"]}
    exp = Experiment(traces={k: t for k, (_, t) in pairs.items()},
                     trace_dim="workload", axes=axes, device="cpu")
    res = exp.run()
    _, _, cfgs = exp.expand()
    max_len = max(t.gap.shape[1] for _, t in pairs.values())
    padded = [t_traces.pad_batch_to(t, max_len) for _, t in pairs.values()]
    direct = t_sim.sweep_traces(padded, cfgs, device="cpu")
    return pairs, axes, res, cfgs, padded, direct


def test_experiment_matches_sweep_traces_mixed_lengths(mixed_lengths):
    _, _, res, cfgs, _, direct = mixed_lengths
    assert res.dims == ("workload", "mechanism")
    assert res.meta["n_kernel_launches"] == 2      # one a trace batch
    for bi in range(2):
        for gi in range(len(cfgs)):
            _same(direct[bi][gi], res.cells[bi, gi])


def test_sweep_traces_equals_one_sweep_a_batch(mixed_lengths):
    """The CPU runs a trace group as one plain-engine call over batch x
    grid points; the card launches once a batch: every point equals
    ``sweep()`` of its batch alone."""
    _, _, _, cfgs, padded, direct = mixed_lengths
    for b, row in zip(padded, direct):
        for ref, got in zip(t_sim.sweep(b, cfgs, pad_steps=True, rltl=False,
                                        device="cpu"), row):
            _same(ref, got)


def test_sweep_traces_matches_repro(mixed_lengths, jax_ref):
    pairs, axes, res, cfgs, padded, direct = mixed_lengths
    max_len = padded[0].gap.shape[1]
    jcfgs = [j_sim.SimConfig(mech=j_sim.MechanismConfig(kind=k))
             for k in axes["mechanism"]]
    want = j_sim.sweep_traces(
        [j_traces.pad_batch_to(j, max_len) for j, _ in pairs.values()],
        jcfgs)
    for wrow, grow in zip(want, direct):
        for j, t in zip(wrow, grow):
            _same(j, t)
    keys = ("n_req", "acts", "hcrac_hits", "total_cycles")
    got = t_sim.sweep_traces(padded, cfgs, reduce_keys=keys, device="cpu")
    assert got.shape == (2, len(cfgs), len(keys)) and got.dtype == np.int32
    np.testing.assert_array_equal(
        got, [[[int(c[k]) for k in keys] for c in row] for row in direct])


def test_sweep_traces_refuses_mixed_shapes():
    a = t_traces.single_core_batch("milc_like", 100, seed=1)
    b = t_traces.single_core_batch("milc_like", 120, seed=1)
    with pytest.raises(ValueError, match="same-shape"):
        t_sim.sweep_traces([a, b], [t_sim.SimConfig()], device="cpu")


# ------------------------------------------- the axes against repro

def _axes_pair(t_axes, j_axes, **kw):
    """One grid over a single-core and a two-core trace (two groups) in
    both packages."""
    single = _batches("single_core_batch", "lbm_like", 300, seed=2)
    mix = _batches("multicore_batch", ["mcf_like", "soplex_like"], 150,
                   seed=2)
    traces = {"single": single, "mix": mix}
    res = Experiment(traces={k: t for k, (_, t) in traces.items()},
                     axes=t_axes, device="cpu", **kw).run()
    jres = JExperiment(traces={k: j for k, (j, _) in traces.items()},
                       axes=j_axes, **kw).run()
    return res, jres


def test_geometry_temperature_mechanism_match_repro(jax_ref):
    axes = {"geometry": ["ddr3_1ch", "ddr3_2ch_16bank"],
            "temperature": (55.0, 85.0),
            "mechanism": ["base", "chargecache", "aldram", "cc_aldram"]}
    res, jres = _axes_pair(axes, axes, chunk_size=5)
    assert res.meta["n_unique"] == jres.meta["n_unique"] < 16
    _cells_equal(jres, res)


def test_duration_drift_refresh_policy_match_repro(jax_ref):
    axes = {"duration_ms": (0.5, 1.0, 8.0), "temp_drift": ["none", "ramp"],
            "refresh_mode": ["stateful", "legacy"],
            "policy": ["open", "closed"],
            "mechanism": ["chargecache", "nuat", "rltl"]}
    res, jres = _axes_pair(axes, axes)
    assert res.meta["n_unique"] == jres.meta["n_unique"]
    _cells_equal(jres, res)


def test_synthetic_grid_matches_repro(jax_ref):
    """``Experiment(traces=None)``: workload x interleave x geometry x
    mechanism, each point's stream generated for its geometry."""
    axes = {"workload": {"copy": ["stream_copy_like", "mcf_like"],
                         "mix": ["lbm_like", "gcc_like"]},
            "interleave": ["bank", "xor"],
            "geometry": ["ddr3_1ch", "ddr3_2ch"],
            "mechanism": ["base", "chargecache"]}
    t_base = t_sim.SimConfig(workload=t_traces.WorkloadSpec(
        names=("stream_copy_like", "mcf_like"), n_req=200, seed=4))
    j_base = j_sim.SimConfig(workload=j_traces.WorkloadSpec(
        names=("stream_copy_like", "mcf_like"), n_req=200, seed=4))
    exp = Experiment(traces=None, base=t_base, axes=axes,
                     chunk_size=4, device="cpu")
    res = exp.run()
    jexp = JExperiment(traces=None, base=j_base, axes=axes,
                       chunk_size=4)
    jres = jexp.run()
    assert res.meta["mode"] == "synth"
    assert res.meta["n_unique"] == jres.meta["n_unique"]
    assert res.coords == jres.coords
    _, _, tcfgs = exp.expand()
    _, _, jcfgs = jexp.expand()
    for j, t, jc, tc in zip(jres.cells.flat, res.cells.flat, jcfgs, tcfgs):
        n = assert_streams_under_rule(
            j_materialize(jc.workload, jc.dram, jc.interleave),
            t_materialize(tc.workload, tc.dram, tc.interleave))
        assert_stats_under_rule(j, t, n == 0)


SERVE_KW = dict(n_reqs=24, max_batch=4, queue_cap=32, arrivals_max=4,
                n_steps=40, cycles_per_step=4000, hot_entries=1018,
                hot_ways=2, hot_caching_ms=0.05, hot_exact=True)
SERVE_ARR = dict(rate=1.5, burstiness=1.0, prompt_pages_min=1,
                 prompt_pages_max=2, decode_min=4, decode_max=12, seed=7)
SERVE_AXES = {"policy": ["fifo", "charge_aware", "preempting"],
              "arrival_rate": (0.5, 2.0), "burstiness": (1.0, 4.0)}


def test_serving_grid_matches_repro(jax_ref):
    """A serving Experiment over policy x arrival rate x burstiness
    (counts drawn in the engine): where the two packages draw the same
    counts (compared first) every cell is bitwise, else under repro's
    mirror rule (< 1e-3 of the counts differ)."""
    t_spec = ServingSpec(arrival=t_arr.ArrivalConfig(**SERVE_ARR),
                         **SERVE_KW)
    j_spec = JSpec(arrival=j_arr.ArrivalConfig(**SERVE_ARR), **SERVE_KW)
    res = Experiment(traces=None, base=t_sim.SimConfig(serving=t_spec),
                     axes=SERVE_AXES, chunk_size=5, device="cpu").run()
    jres = JExperiment(traces=None, base=j_sim.SimConfig(serving=j_spec),
                       axes=SERVE_AXES, chunk_size=5).run()
    assert res.meta["mode"] == "serving"
    assert res.coords == jres.coords
    steps = np.arange(SERVE_KW["n_steps"], dtype=np.int32)
    n_equal = 0
    for idx in np.ndindex(res.shape):
        rate = SERVE_AXES["arrival_rate"][idx[1]]
        burst = SERVE_AXES["burstiness"][idx[2]]
        arr = dict(SERVE_ARR, rate=rate, burstiness=burst)
        tc = t_arr.step_counts(t_arr.arrival_params(
            t_arr.ArrivalConfig(**arr), SERVE_KW["n_reqs"]),
            torch.from_numpy(steps)).numpy()
        jc = np.asarray(j_arr.step_counts(jnp, j_arr.arrival_params(
            j_arr.ArrivalConfig(**arr), SERVE_KW["n_reqs"]),
            jnp.asarray(steps)))
        j, t = jres.cells[idx], res.cells[idx]
        if np.array_equal(tc, jc):
            n_equal += 1
            _same(j, t)
            for k in ("arrived", "dropped", "retired", "preempted",
                      "admit_hot", "admit_probes", "occ_sum", "qlen_sum"):
                assert int(t[k]) == int(j[k]), (idx, k)
        else:
            assert np.mean(tc != jc) < 1e-3
    assert n_equal > 0


# ------------------------------------------------------ Results

def test_results_label_selection_roundtrips():
    batch = t_traces.single_core_batch("lbm_like", 400, seed=2)
    res = Experiment(traces=batch,
                     axes={"mechanism": ["base", "chargecache"],
                           "capacity": (32, 64, 128)}, device="cpu").run()
    cc = res.sel(mechanism="chargecache")
    assert cc.dims == ("capacity",) and cc.shape == (3,)
    sub = res.sel(capacity=[64, 128])
    assert sub.coords["capacity"] == (64, 128)
    assert res.point(mechanism="chargecache", capacity=64) is not None
    assert (res.sel(mechanism="chargecache", capacity=64).item()
            ["total_cycles"] == res.cells[1, 1]["total_cycles"])
    hits = cc.metric("hcrac_hit_rate")
    assert hits.shape == (3,) and hits[0] <= hits[-1] + 0.02
    assert len(res.to_table()) == 6
    with pytest.raises(KeyError):
        res.sel(mechanism="nope")
    with pytest.raises(KeyError):
        res.sel(nodim=1)


def _json_cells_equal(a: Results, b: Results):
    assert a.dims == b.dims and a.coords == b.coords
    assert a.metrics == b.metrics
    for x, y in zip(a.cells.flat, b.cells.flat):
        for k in BITWISE_KEYS:
            assert int(x[k]) == int(y[k]), k
        assert np.array_equal(x["core_end"], y["core_end"])


def test_results_json_roundtrip():
    batch = t_traces.single_core_batch("gcc_like", 500, seed=4)
    res = Experiment(traces={"gcc_like": batch}, trace_dim="workload",
                     axes={"mechanism": ["base", "chargecache"]},
                     trace_metrics={"gcc_like": {"note": 0.5}},
                     device="cpu").run()
    back = Results.from_json(res.to_json())
    _json_cells_equal(res, back)
    for a, b in zip(res.cells.flat, back.cells.flat):
        assert a["rltl_hist"] is None and b["rltl_hist"] is None
        assert a["note"] == b["note"] == 0.5


def test_results_json_crosses_packages(chunked, jax_ref):
    """A JSON ``repro`` wrote loads in the port, and the reverse; the
    cells are the same either way."""
    _, _, res, jres = chunked
    from_repro = Results.from_json(jres.to_json())
    _json_cells_equal(res, from_repro)
    from_port = JResults.from_json(res.to_json())
    _json_cells_equal(res, from_port)
    assert from_port.meta["n_unique"] == res.meta["n_unique"]


# --------------------------------------------- registry and imports

def _register_turbo(reg):
    @reg.register_mechanism("turbo")
    class Turbo(reg.MechanismPolicy):
        components = ("lldram",)
        consumes = ()


def test_toy_mechanism_plugs_in_without_simulator_edits():
    """A registry entry composing LL-DRAM's block behaves as the builtin
    and is sweepable through the axis, on the plain engine and (its
    block set unchanged) through the kernel's dispatch; a toy with a
    block of its own is refused, the kernel having no body for it."""
    batch = t_traces.single_core_batch("soplex_like", 300, seed=7)
    with registry.temporary():
        _register_turbo(registry)
        assert "turbo" in registry.names()
        ops.check_registry()
        ref = t_sim.simulate(batch, t_sim.SimConfig(
            mech=t_sim.MechanismConfig(kind="lldram")), device="cpu")
        res = Experiment(traces=batch, axes={"mechanism": ["base", "turbo"]},
                         device="cpu").run()
        _same(ref, res.point(mechanism="turbo"))

        @register_mechanism("turbo_block")
        class TurboBlock(MechanismPolicy):
            def block(self, mech, timing, enabled, hints):
                return {"enable": torch.tensor(bool(enabled))}

        with pytest.raises(NotImplementedError, match="turbo_block"):
            Experiment(traces=batch, axes={"mechanism": ["turbo_block"]},
                       device="cpu").run()
    assert "turbo" not in registry.names()
    with pytest.raises(ValueError, match="turbo"):
        t_sim.MechanismConfig(kind="turbo")


def test_toy_mechanism_matches_repro(jax_ref):
    jb, tb = _batches("single_core_batch", "soplex_like", 300, seed=7)
    with registry.temporary(), j_reg.temporary():
        _register_turbo(registry)
        _register_turbo(j_reg)
        axes = {"mechanism": ["base", "turbo"]}
        res = Experiment(traces=tb, axes=axes, device="cpu").run()
        jres = JExperiment(traces=jb, axes=axes).run()
        _cells_equal(jres, res)


def test_import_order_is_cycle_free():
    """``from repro_torch.experiment import Experiment`` works in a fresh
    interpreter, and importing the figures compiles nothing."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.experiment import Experiment, register_mechanism\n"
         "from repro_torch.experiment.registry import names\n"
         "import repro_torch.figures.speedup, repro_torch.serving.study\n"
         "import sys\n"
         "assert 'chargecache' in names()\n"
         "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
         "               for m in sys.modules)"],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_dedup_preserves_hcrac_grid_uniformity():
    batch = t_traces.single_core_batch("lbm_like", 500, seed=1)
    base = t_sim.SimConfig(mech=t_sim.MechanismConfig(
        kind="base", hcrac=t_sim.hcrac_lib.HCRACConfig(n_entries=128,
                                                       n_ways=4)))
    res = Experiment(traces=batch, base=base, device="cpu",
                     axes={"mechanism": ["base", "chargecache"]}).run()
    assert res.meta["n_unique"] == 2
    assert int(res.point(mechanism="base")["total_cycles"]) > 0


def test_memory_budget_forces_chunking():
    """A tiny memory budget splits the grid, and changes no cell (RLTL
    histograms included)."""
    batch = t_traces.single_core_batch("milc_like", 300, seed=3)
    axes = {"mechanism": ["chargecache"], "capacity": (32, 64, 128, 256)}
    small = Experiment(traces=batch, axes=axes, rltl=True,
                       memory_budget_mb=0.05, device="cpu").run()
    whole = Experiment(traces=batch, axes=axes, rltl=True,
                       device="cpu").run()
    assert small.meta["n_chunks"] >= 2
    assert whole.meta["n_chunks"] == 1
    for a, b in zip(small.cells.flat, whole.cells.flat):
        _same(a, b, rltl=True)


def test_bytes_per_point_counts_the_port_buffers():
    kw = dict(n_steps=10_000, n_sets_max=64, n_ways=2, n_cores=1, mshr=8,
              n_traces=1, n_banks_total=16)
    plain = runner.bytes_per_point(rltl=False, **kw)
    events = runner.bytes_per_point(rltl=True, **kw)
    assert events - plain == (33 + 256) * 10_000
    assert runner.bytes_per_point(rltl=False, synth=True, **kw) \
        - plain == 15 * 10_000
    assert runner.bytes_per_point(rltl=False, **{**kw, "n_traces": 3}) \
        == 3 * plain


# --------------------------------------------------- the port's rules

def test_run_wants_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    batch = t_traces.single_core_batch("milc_like", 50, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(traces=batch, axes={"mechanism": ["base"]}).run()


def test_backend_axis_is_refused():
    batch = t_traces.single_core_batch("milc_like", 50, seed=0)
    with pytest.raises(ValueError, match="by device"):
        Experiment(traces=batch, axes={"backend": ["pallas"]},
                   device="cpu").expand()


def test_controller_and_window_axes():
    """``inorder`` runs and a window axis leaves in-order points as they
    are (one run at every depth, as ``repro`` dedups them); ``frfcfs``
    raises the port's refusal of that tier."""
    batch = t_traces.single_core_batch("milc_like", 200, seed=0)
    res = Experiment(traces=batch, device="cpu",
                     axes={"controller": ["inorder"], "window": (2, 8),
                           "mechanism": ["chargecache"]}).run()
    assert res.meta["n_unique"] == 1
    _same(res.point(controller="inorder", window=2, mechanism="chargecache"),
          res.point(controller="inorder", window=8, mechanism="chargecache"))
    with pytest.raises(NotImplementedError, match="FR-FCFS"):
        Experiment(traces=batch, axes={"controller": ["frfcfs"]},
                   device="cpu").expand()
    with pytest.raises(ValueError, match="window"):
        Experiment(traces=batch, axes={"window": (0,)},
                   device="cpu").expand()


def test_unknown_and_ambiguous_axes_raise():
    batch = t_traces.single_core_batch("milc_like", 50, seed=0)
    with pytest.raises(ValueError, match="unknown axis"):
        Experiment(traces=batch, axes={"nope": [1]}).expand()
    with pytest.raises(ValueError, match="ambiguous"):
        Experiment(traces=None, axes={"workload": [("mcf_like",
                                                    "lbm_like")]}).expand()
    with pytest.raises(ValueError, match="geometry preset"):
        Experiment(traces=batch, axes={"geometry": ["ddr9"]}).expand()


def test_chunk_scheduler_drains_in_launch_order():
    for depth in (0, 1, 2, 5):
        log, inflight = [], []

        def work():
            for i in range(6):
                def launch(i=i):
                    inflight.append(i)
                    log.append(("launch", i))
                    assert len(inflight) <= depth + 1
                    return i

                def finish(out, i=i):
                    assert out == i
                    inflight.remove(i)
                    log.append(("drain", i))
                yield launch, finish

        runner.ChunkScheduler(depth=depth).run(work())
        drains = [i for kind, i in log if kind == "drain"]
        assert drains == list(range(6))
        # a launch never runs more than depth ahead of the oldest drain
        for pos, (kind, i) in enumerate(log):
            if kind == "launch":
                done = sum(1 for k, _ in log[:pos] if k == "drain")
                assert i - done <= depth


def test_chunk_scheduler_propagates_a_failure():
    def boom(out):
        raise RuntimeError("chunk 1 failed")

    ok = []
    work = [(lambda: 0, ok.append), (lambda: 1, boom), (lambda: 2, ok.append)]
    with pytest.raises(RuntimeError, match="chunk 1"):
        runner.ChunkScheduler(depth=1).run(work)
    assert ok == [0]
    with pytest.raises(ZeroDivisionError):
        runner.ChunkScheduler(depth=2).run([(lambda: 1 // 0, ok.append)])


# -------------------------------------------------------- the configs

def test_ddr3_configs_match_repro(jax_ref):
    assert chargecache_ddr3.SIM_CONFIG.policy == j_cc_cfg.SIM_CONFIG.policy
    for mod, jmod in ((chargecache_ddr3, j_cc_cfg),
                      (aldram_ddr3, j_aldram_cfg)):
        assert list(mod.MECHANISMS) == list(jmod.MECHANISMS)
        for k, m in mod.MECHANISMS.items():
            jm = jmod.MECHANISMS[k]
            assert m.kind == jm.kind
            assert dataclasses.asdict(m.hcrac) == dataclasses.asdict(jm.hcrac)
            assert m.nuat_bins == tuple(tuple(b) for b in jm.nuat_bins)
        assert mod.SIM_CONFIG.mech.kind == jmod.SIM_CONFIG.mech.kind
    assert {k: dataclasses.asdict(v)
            for k, v in aldram_ddr3.TEMPERATURES.items()} == {
        k: dataclasses.asdict(v)
        for k, v in j_aldram_cfg.TEMPERATURES.items()}
    from repro_torch import configs
    assert "chargecache_ddr3" not in configs.ALL_ARCHS
    assert "aldram_ddr3" not in configs.ALL_ARCHS


def test_aldram_temperatures_feed_the_temperature_axis(jax_ref):
    """The documented ``{label: °C}`` form runs in both packages alike;
    ``repro``'s own docstring form (the labels alone) raises there
    (ROADMAP.md, Queue 3)."""
    jb, tb = _batches("single_core_batch", "mcf_like", 300, seed=1)
    temps = {k: a.temperature_c for k, a in aldram_ddr3.TEMPERATURES.items()}
    axes = {"temperature": temps, "mechanism": ["aldram", "cc_aldram"]}
    res = Experiment(traces=tb, axes=axes, base=aldram_ddr3.SIM_CONFIG,
                     device="cpu").run()
    jres = JExperiment(traces=jb, axes=axes,
                       base=j_aldram_cfg.SIM_CONFIG).run()
    assert res.coords["temperature"] == ("55C", "70C", "85C")
    _cells_equal(jres, res)
    with pytest.raises(ValueError, match="55C"):
        JExperiment(traces=jb, axes={
            "temperature": list(j_aldram_cfg.TEMPERATURES),
            "mechanism": ["aldram"]}).expand()


# ------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_experiment.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_experiment_on_the_card_matches_the_plain_engine(cuda):
    """Two single-core traces of 2 000 requests x every kind x capacity
    (32, 128), five points a launch (a padded tail): the card's cells
    equal the plain engine's, RLTL histograms included, and the launch
    half neither synchronises with the device nor copies to the host."""
    traces = {n: t_traces.single_core_batch(n, 2000, seed=3)
              for n in ("milc_like", "mcf_like")}
    axes = {"mechanism": list(KINDS), "capacity": (32, 128)}
    kw = dict(traces=traces, axes=axes, chunk_size=5, rltl=True,
              trace_dim="workload")
    before = ops.launches
    got = Experiment(device="cuda", **kw).run()
    assert ops.launches - before == got.meta["n_kernel_launches"]
    want = Experiment(device="cpu", **kw).run()
    for a, b in zip(want.cells.flat, got.cells.flat):
        _same(a, b, rltl=True)
    assert got.meta["n_unique"] % 5 != 0
    # the launch half: host-staged params, no synchronisation
    _, _, cfgs = Experiment(device="cpu", **kw).expand()
    host = torch.device("cpu")
    shape, stacked = t_sim._grid_shape_and_params(cfgs, cfgs, host)
    geoms, idx = t_sim._hoist_geoms(cfgs, cfgs, host)
    geoms = t_sim._tree_map(lambda x: x.to(cuda), geoms)
    staged = [t_sim._stage_trace(b, shape, geoms, cuda, 0.05, True)
              for b in traces.values()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = t_sim._launch_grid(shape, stacked, idx, staged, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    direct = t_sim._drain_grid(outs, cfgs, list(traces.values()))
    for bi in range(len(traces)):
        for a, b in zip(want.cells[bi].flat, direct[bi]):
            _same(a, b, rltl=True)
