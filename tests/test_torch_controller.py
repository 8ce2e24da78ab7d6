"""The port's FR-FCFS controller tier (``repro_torch.controller``) against
``repro``'s, and the ``sim_window`` CUDA entry against its plain version.

* Against ``repro`` on the CPU, on ``repro``'s own numpy-materialised
  streams: the window engine (``sweep(device="cpu")``) bitwise — every
  ``tests/_parity.py::BITWISE_KEYS`` stat, ``core_end``, the per-bank
  accumulators and the RLTL histogram — for base, chargecache, rltl and
  cc_aldram on the in-order tier (riding a window-engine launch at a
  window cap of 1) and at frfcfs window 8, against ``repro``'s per-config
  ``simulate`` (``repro``'s own ``sweep`` of an frfcfs grid does not run:
  ROADMAP.md, Queue 3); the two-channel closed-policy legacy-refresh
  case of ``tests/test_oracle.py``; a mixed-window ``sweep_traces``
  grid; a mixed-window ``sweep_synth`` grid (streams compared first, then
  the rule of ``tests/_torch_streams.py``); an ``Experiment`` over
  controller x window x mechanism, cell for cell; five points under
  thermal drift, AL-DRAM at 85 C, legacy refresh and an MSHR of 4
  (ROADMAP.md, "Facts that are not faults"), on every ``BITWISE_KEYS``
  stat and ``core_end``.
* The port's host oracle (``controller/oracle.py::run_host``) equals both
  engines.
* Inside the port: a ``win_cap = 1`` rider equals the in-order engine
  (stats, ``core_end`` and events); per-rank ACTs keep tRRD and tFAW.
* The CUDA entry against the plain engine, marked ``cuda``: these skip
  without a CUDA device and run there with
  ``python -m pytest -m cuda tests/test_torch_controller.py``.

Streams stay at a few hundred requests (the plain window engine costs a
few ms a step on the CPU) and every JAX compile is shared through module
fixtures.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from repro.core import simulator as j_sim
    from repro.core import traces as j_traces
    from repro.core.dram import DRAMConfig as JDRAMConfig
    from repro.experiment import Experiment as JExperiment
    from repro.experiment import runner as j_runner
    from repro.workloads import materialize as j_materialize
except ImportError:    # no JAX here: only the port-internal tests run
    j_sim = None

from repro_torch.controller import engine, oracle  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402
from repro_torch.core.dram import DRAMConfig  # noqa: E402
from repro_torch.experiment import Experiment, runner  # noqa: E402
from repro_torch.kernels.sim_step import ops, ref  # noqa: E402
from repro_torch.workloads import materialize as t_materialize  # noqa: E402

from _parity import BITWISE_KEYS, assert_cell_matches  # noqa: E402
from _torch_streams import (assert_stats_under_rule,  # noqa: E402
                            assert_streams_under_rule, stream_diff)

MECHS = ("base", "chargecache", "rltl", "cc_aldram")
TIERS = (("inorder", 1), ("frfcfs", 8))
DRAM_2CH = dict(n_channels=2, n_ranks=2, n_banks=8)
PINNED = dict(names=("mcf_like", "omnetpp_like"), n_req=160, seed=7)


@pytest.fixture(scope="module")
def jax_ref():
    if j_sim is None:
        pytest.skip("needs the JAX package (repro) to compare with")


def _cfg(sim, kind="base", controller="inorder", window=8, **kw):
    return sim.SimConfig(mech=sim.MechanismConfig(kind=kind),
                         controller=controller, window=window, **kw)


def _port_batch(spec_kw, dram=None):
    """A stream as the port's ``TraceBatch``: ``repro``'s materialised
    stream where JAX is there (the same bytes on both sides), else the
    port's own."""
    if j_sim is None:
        spec = t_traces.WorkloadSpec(**spec_kw)
        return None, t_materialize(spec, *(() if dram is None
                                           else (DRAMConfig(**dram),)))
    spec = j_traces.WorkloadSpec(**spec_kw)
    jb = j_materialize(spec, *(() if dram is None
                               else (JDRAMConfig(**dram),)))
    return jb, t_traces.TraceBatch(*(np.array(x) for x in jb))


def _same(want: dict, got: dict, rltl: bool = True):
    assert_cell_matches(want, got, rltl=rltl)
    for k in ("bank_acts", "bank_act_ras_sum"):
        np.testing.assert_array_equal(np.asarray(want[k]), got[k])


# ------------------------------------------------- the pinned stream

@pytest.fixture(scope="module")
def pinned():
    """Four kinds x both tiers on one stream: the port's one launch of
    the whole mixed grid (the window engine at depth 8, in-order points
    at a window cap of 1), ``repro``'s ``simulate`` of each point."""
    jb, tb = _port_batch(PINNED)
    grid = [_cfg(t_sim, k, c, w) for k in MECHS for c, w in TIERS]
    got = dict(zip(((k, c) for k in MECHS for c, _ in TIERS),
                   t_sim.sweep(tb, grid, device="cpu")))
    want = None
    if j_sim is not None:
        want = {(k, c): j_sim.simulate(jb, _cfg(j_sim, k, c, w))
                for k in MECHS for c, w in TIERS}
    return tb, got, want


@pytest.mark.parametrize("tier", [c for c, _ in TIERS])
@pytest.mark.parametrize("kind", MECHS)
def test_window_engine_matches_repro(pinned, jax_ref, kind, tier):
    _, got, want = pinned
    _same(want[kind, tier], got[kind, tier])


@pytest.mark.parametrize("tier", [c for c, _ in TIERS])
@pytest.mark.parametrize("kind", MECHS)
def test_oracle_matches_window_engine(pinned, kind, tier):
    tb, got, _ = pinned
    window = dict(TIERS)[tier]
    h = oracle.run_host(tb, _cfg(t_sim, kind, tier, window))
    for k in BITWISE_KEYS:
        assert int(h[k]) == int(got[kind, tier][k]), k
    np.testing.assert_array_equal(h["core_end"], got[kind, tier]["core_end"])


def test_oracle_matches_repro_oracle(pinned, jax_ref):
    """The port's oracle and ``repro``'s, on the frfcfs ChargeCache point."""
    from repro.controller import oracle as j_oracle
    tb, _, _ = pinned
    jb, _ = _port_batch(PINNED)
    h = oracle.run_host(tb, _cfg(t_sim, "chargecache", "frfcfs", 8))
    jh = j_oracle.run_host(jb, _cfg(j_sim, "chargecache", "frfcfs", 8))
    for k in BITWISE_KEYS:
        assert int(h[k]) == int(jh[k]), k
    np.testing.assert_array_equal(h["core_end"], jh["core_end"])


def test_frfcfs_reorders_on_the_pinned_stream(pinned):
    """The tier does something: frfcfs serves another schedule than
    in-order on this stream."""
    _, got, _ = pinned
    assert any(int(got[k, "frfcfs"]["total_cycles"])
               != int(got[k, "inorder"]["total_cycles"]) for k in MECHS)


def test_sweep_runs_an_frfcfs_grid_where_repros_sweep_raises(jax_ref):
    """``repro.core.sweep`` of a grid holding an frfcfs point raises:
    ``controller.engine._run_window_batched`` has ``static_argnums=(0,
    1, 6, 7)``, which marks argument 7, ``ns_geoms``, static where
    argument 5, ``n_steps``, is meant, and a ``GeomParams`` of arrays
    does not hash (ROADMAP.md, Queue 3).
    The port's ``sweep`` runs the grid, each point equal to ``repro``'s
    ``simulate``."""
    jb, tb = _port_batch(dict(names=("milc_like",), n_req=40, seed=0))
    grid = [("base", "frfcfs", 8), ("chargecache", "inorder", 1)]
    with pytest.raises(ValueError, match="hash"):
        j_sim.sweep(jb, [_cfg(j_sim, *m) for m in grid])
    got = t_sim.sweep(tb, [_cfg(t_sim, *m) for m in grid], device="cpu")
    for m, g in zip(grid, got):
        _same(j_sim.simulate(jb, _cfg(j_sim, *m)), g)


def test_legacy_refresh_closed_policy_two_channels(jax_ref):
    """``tests/test_oracle.py``'s two-channel, two-rank case: cc_nuat,
    closed rows, the legacy refresh tier, window 4."""
    jb, tb = _port_batch(PINNED, DRAM_2CH)
    kw = dict(policy="closed", refresh_mode="legacy")
    t_cfg = _cfg(t_sim, "cc_nuat", "frfcfs", 4,
                 dram=DRAMConfig(**DRAM_2CH), **kw)
    got = t_sim.simulate(tb, t_cfg, device="cpu")
    want = j_sim.simulate(jb, _cfg(j_sim, "cc_nuat", "frfcfs", 4,
                                   dram=JDRAMConfig(**DRAM_2CH), **kw))
    _same(want, got)
    h = oracle.run_host(tb, t_cfg)
    for k in BITWISE_KEYS:
        assert int(h[k]) == int(got[k]), k


# ------------------------------- drift, aldram, legacy refresh, small MSHR

FIVE_STREAM = dict(names=("mcf_like", "omnetpp_like"), n_req=160, seed=11)
FIVE = ("cc_aldram_w8_ramp", "cc_nuat_closed_w16_ramp", "aldram_w4_85C",
        "chargecache_closed_legacy_w8", "rltl_w2_mshr4")


def _five_point(sim, spec, name):
    """One of ROADMAP.md's five FR-FCFS points ("Facts that are not
    faults") in the package of ``sim`` (``spec``: its experiment spec
    module, for the ``ramp`` thermal schedule)."""
    ramp = spec.THERMAL_PRESETS["ramp"]
    mech = sim.MechanismConfig
    hot = dataclasses.replace(mech(kind="aldram").aldram, temperature_c=85.0)
    return {
        "cc_aldram_w8_ramp": lambda: sim.SimConfig(
            mech=mech(kind="cc_aldram", thermal=ramp), controller="frfcfs",
            window=8),
        "cc_nuat_closed_w16_ramp": lambda: sim.SimConfig(
            mech=mech(kind="cc_nuat", thermal=ramp), controller="frfcfs",
            window=16, policy="closed"),
        "aldram_w4_85C": lambda: sim.SimConfig(
            mech=mech(kind="aldram", aldram=hot), controller="frfcfs",
            window=4),
        "chargecache_closed_legacy_w8": lambda: sim.SimConfig(
            mech=mech(kind="chargecache"), controller="frfcfs", window=8,
            policy="closed", refresh_mode="legacy"),
        "rltl_w2_mshr4": lambda: sim.SimConfig(
            mech=mech(kind="rltl"), controller="frfcfs", window=2, mshr=4),
    }[name]()


@pytest.fixture(scope="module")
def five_stream():
    return _port_batch(FIVE_STREAM)


@pytest.mark.parametrize("name", FIVE)
def test_five_frfcfs_points_match_repro(five_stream, jax_ref, name):
    """The frfcfs tier under thermal drift, AL-DRAM at 85 C, the legacy
    refresh tier and an MSHR of 4: the port's ``simulate`` equals
    ``repro``'s on every ``BITWISE_KEYS`` stat and ``core_end``."""
    from repro.experiment import spec as j_spec
    from repro_torch.experiment import spec as t_spec
    jb, tb = five_stream
    got = t_sim.simulate(tb, _five_point(t_sim, t_spec, name), device="cpu")
    want = j_sim.simulate(jb, _five_point(j_sim, j_spec, name))
    for k in BITWISE_KEYS:
        assert int(got[k]) == int(want[k]), k
    np.testing.assert_array_equal(np.asarray(want["core_end"]),
                                  got["core_end"])


# ------------------------------------------ sweep_traces, sweep_synth

MIXED = (("base", "frfcfs", 4), ("chargecache", "frfcfs", 8),
         ("chargecache", "inorder", 1), ("base", "inorder", 1))


def test_sweep_traces_mixed_windows_match_repro(jax_ref):
    """Two same-shape batches x a grid of windows 4 and 8 and in-order
    riders: ``out[b][g]`` bitwise, RLTL included."""
    pairs = [_port_batch(dict(names=("lbm_like", "gcc_like"), n_req=110,
                              seed=s)) for s in (1, 2)]
    L = max(t.gap.shape[1] for _, t in pairs)
    jbs = [j_traces.pad_batch_to(j, L) for j, _ in pairs]
    tbs = [t_traces.pad_batch_to(t, L) for _, t in pairs]
    got = t_sim.sweep_traces(tbs, [_cfg(t_sim, *m) for m in MIXED],
                             rltl=True, device="cpu")
    want = j_sim.sweep_traces(jbs, [_cfg(j_sim, *m) for m in MIXED],
                              rltl=True)
    for wrow, grow in zip(want, got):
        for w, g in zip(wrow, grow):
            _same(w, g)


def test_sweep_synth_mixed_windows_match_repro(jax_ref):
    """Every point generates its own stream and runs it at its window:
    the streams under the rule of ``tests/_torch_streams.py`` first, then
    each point's stats."""
    spec = dict(names=("stream_copy_like", "mcf_like", "lbm_like"),
                n_req=90, seed=4)
    t_grid = [dataclasses.replace(_cfg(t_sim, *m),
                                  workload=t_traces.WorkloadSpec(**spec))
              for m in MIXED]
    j_grid = [dataclasses.replace(_cfg(j_sim, *m),
                                  workload=j_traces.WorkloadSpec(**spec))
              for m in MIXED]
    got = t_sim.sweep_synth(t_grid, device="cpu")
    want = j_sim.sweep_synth(j_grid)
    jb = j_materialize(j_traces.WorkloadSpec(**spec))
    tb = t_materialize(t_traces.WorkloadSpec(**spec))
    assert_streams_under_rule(jb, tb)
    equal = stream_diff(jb, tb) == 0
    for w, g in zip(want, got):
        assert_stats_under_rule(w, g, equal)


# ------------------------------------------------- the Experiment

def test_experiment_controller_window_mechanism_matches_repro(jax_ref):
    """controller x window x mechanism over a labelled trace, cell for
    cell against ``repro``'s Experiment; in-order points dedup across
    the window axis in both."""
    jb, tb = _port_batch(dict(names=("mcf_like", "libquantum_like"),
                              n_req=120, seed=11))
    axes = {"controller": ["inorder", "frfcfs"], "window": [2, 8],
            "mechanism": ["base", "chargecache"]}
    res = Experiment(traces={"mix": tb}, trace_dim="trace", axes=axes,
                     device="cpu").run()
    jres = JExperiment(traces={"mix": jb}, trace_dim="trace",
                       axes=axes).run()
    assert res.meta["n_unique"] == jres.meta["n_unique"] == 6
    assert res.dims == jres.dims and res.coords == jres.coords
    for w, g in zip(jres.cells.flat, res.cells.flat):
        _same(w, g, rltl=False)


@pytest.mark.parametrize("window", [1, 4, 16])
@pytest.mark.parametrize("n_cores,mshr,n_banks", [(1, 8, 16), (8, 8, 32),
                                                  (4, 16, 1024)])
def test_bytes_per_point_window_counts_repros_words(jax_ref, window,
                                                    n_cores, mshr, n_banks):
    """The window state's words are ``repro``'s (9 arrays of a slot, 6 a
    bank, ``mshr + 3`` a core); ``repro`` counts them twice (its scan
    carries them in and out), the port once (it updates in place)."""
    kw = dict(n_steps=5_000, n_sets_max=64, n_ways=2, n_cores=n_cores,
              mshr=mshr, n_traces=1, rltl=False, n_banks_total=n_banks)
    t_add = (runner.bytes_per_point(window=window, **kw)
             - runner.bytes_per_point(**kw))
    j_add = (j_runner.bytes_per_point(window=window, **kw)
             - j_runner.bytes_per_point(**kw))
    assert 2 * t_add == j_add


def test_frfcfs_study_matches_repros(jax_ref, monkeypatch):
    """``figures/frfcfs.py`` against ``benchmarks/frfcfs.py`` at 60
    requests a core: the stream (under the rule), every cell, and the
    study's numbers and broken assertions; one launch planned, as
    ``repro`` makes one compile."""
    from _torch_figures import repro_benchmarks
    from benchmarks import frfcfs as j_fig
    from repro_torch.figures import frfcfs
    monkeypatch.setattr(repro_benchmarks(), "N_REQ_8C", 60)
    jres, compiles = j_fig.frfcfs_grid()
    tres, launches = frfcfs.frfcfs_grid(60, device="cpu")
    assert compiles == 1 and launches == 0
    assert tres.meta["n_kernel_launches"] == 1
    spec = dict(names=frfcfs.LOCALITY_MIX, n_req=60, seed=frfcfs.SEED)
    jb = j_materialize(j_traces.WorkloadSpec(**spec))
    tb = t_materialize(t_traces.WorkloadSpec(**spec))
    assert_streams_under_rule(jb, tb)
    equal = stream_diff(jb, tb) == 0
    assert tres.dims == jres.dims and tres.coords == jres.coords
    for j, t in zip(jres.cells.flat, tres.cells.flat):
        assert_stats_under_rule(j, t, equal)
    if equal:
        cell = lambda res: (lambda m, c, w: res.sel(
            mechanism=m, controller=c, window=w).cells.flat[0])
        want = frfcfs.summarize(cell(jres))
        assert frfcfs.summarize(cell(tres)) == want
        assert frfcfs.failed_checks(want) == []


# --------------------------------------------------- inside the port

@pytest.fixture(scope="module")
def rider_stream():
    tb = t_traces.multicore_batch(["mcf_like", "gcc_like"], 120, seed=3)
    grid = [_cfg(t_sim, "rltl")]
    staged = t_sim._stage(tb, grid, torch.device("cpu"))
    return staged


@pytest.mark.parametrize("W", [1, 4])
def test_win_cap1_rider_equals_inorder_engine(rider_stream, W):
    """An in-order point on the window engine at any depth: stats,
    ``core_end`` and every event lane equal the in-order engine's."""
    shape, stacked, trace, ns, ns_idx, warmup, n_steps = rider_stream
    a = ref.run_sweep_ref(shape, stacked, trace, ns, ns_idx, warmup,
                          n_steps)
    b = ref.run_window_ref(shape, W, stacked, trace, ns, ns_idx, warmup,
                           n_steps)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert torch.equal(a[1], b[1])
    for f, x, y in zip(t_sim.Events._fields, a[2], b[2]):
        live = (a[2].act_gid if f in ("act_t", "act_ref8")
                else getattr(a[2], f.replace("_t", "_gid"))) >= 0
        assert torch.equal(x[live], y[live]), f
        if f.endswith("gid"):
            assert torch.equal(x, y), f


def test_rank_act_spacing_trrd_tfaw():
    """Every two ACTs of a rank are tRRD apart and any five span tFAW."""
    dram = DRAMConfig(n_channels=1, n_ranks=1, n_banks=8)
    tb = t_materialize(t_traces.WorkloadSpec(
        names=("mcf_like", "stream_copy_like", "gcc_like", "lbm_like"),
        n_req=80, seed=21), dram)
    cfg = _cfg(t_sim, controller="frfcfs", window=8, dram=dram,
               warmup_frac=0.0)
    shape, stacked, trace, ns, ns_idx, _, n_steps = t_sim._stage(
        tb, [cfg], torch.device("cpu"))
    _, _, ev = ref.run_window_ref(shape, 8, stacked, trace, ns, ns_idx, 0,
                                  n_steps)
    gid = ev.act_gid[0].numpy()
    t = ev.act_t[0].numpy()[gid >= 0]
    rank = gid[gid >= 0] // dram.n_rows // dram.n_banks
    T = cfg.timing
    assert len(t) > 50
    for r in np.unique(rank):
        ts = np.sort(t[rank == r])
        assert (np.diff(ts) >= T.tRRD).all()
        span = ts[engine.FAW_DEPTH:] - ts[:-engine.FAW_DEPTH]
        assert (span >= T.tFAW).all()


def test_frfcfs_refuses_serving_and_bad_windows():
    from repro_torch.serving.loop import ServingSpec
    with pytest.raises(ValueError, match="in-order"):
        t_sim.SimConfig(controller="frfcfs", serving=ServingSpec())
    with pytest.raises(ValueError, match="window"):
        t_sim.SimConfig(controller="frfcfs", window=0)
    assert t_sim._launch_controller([_cfg(t_sim)]) == ("inorder", 1)
    assert t_sim._launch_controller(
        [_cfg(t_sim), _cfg(t_sim, controller="frfcfs", window=4)],
        [_cfg(t_sim, controller="frfcfs", window=16)]) == ("frfcfs", 16)


# ------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_controller.py)")
    return torch.device("cuda")


KERNEL_GRID = (("base", "frfcfs", 4), ("chargecache", "frfcfs", 8),
               ("rltl", "inorder", 1), ("cc_aldram", "frfcfs", 16),
               ("nuat", "frfcfs", 8), ("base", "inorder", 1))


def _kernel_vs_plain(staged, W, n_steps):
    shape, stacked, trace, ns, ns_idx, warmup, _ = staged
    got = ops.run_window(shape, W, stacked, trace, ns, ns_idx, warmup,
                         n_steps)
    torch.cuda.synchronize()
    want = ref.run_window_ref(shape, W, stacked, trace, ns, ns_idx, warmup,
                              n_steps)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1])
    for f, x, y in zip(t_sim.Events._fields, got[2], want[2]):
        gid = want[2].act_gid if f in ("act_t", "act_ref8") else getattr(
            want[2], f.replace("_t", "_gid"))
        assert torch.equal(x[gid >= 0], y[gid >= 0]), f


@pytest.mark.cuda
@pytest.mark.parametrize("dram", [None, DRAM_2CH], ids=["1ch", "2ch2rk"])
@pytest.mark.parametrize("policy", ["open", "closed"])
def test_kernel_matches_plain(cuda, dram, policy):
    tb = t_materialize(t_traces.WorkloadSpec(
        names=("mcf_like", "stream_copy_like", "lbm_like", "gcc_like"),
        n_req=150, seed=5), *(() if dram is None else (DRAMConfig(**dram),)))
    kw = {} if dram is None else {"dram": DRAMConfig(**dram)}
    grid = [_cfg(t_sim, *m, policy=policy, **kw) for m in KERNEL_GRID]
    staged = t_sim._stage(tb, grid, cuda)
    _kernel_vs_plain(staged, 16, staged[-1] + 5)


@pytest.mark.cuda
def test_kernel_synth_feed_matches_plain(cuda):
    spec = t_traces.WorkloadSpec(names=("stream_copy_like", "mcf_like",
                                        "lbm_like"), n_req=120, seed=3)
    grid = [dataclasses.replace(_cfg(t_sim, *m), workload=spec)
            for m in KERNEL_GRID]
    y = t_sim._stage_synth(grid, None, cuda)
    got = ops.run_window_synth(y[0], 16, *y[1:], True, True)
    torch.cuda.synchronize()
    want = ref.run_window_synth_ref(y[0], 16, *y[1:], True, True)
    for k in ("gap", "bank", "row", "is_write", "dep", "next_same"):
        assert torch.equal(got[3][k], want[3][k]), k
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIVE)
def test_kernel_matches_plain_on_five_points(cuda, five_stream, name):
    """The window entry against the plain engine on the five points
    above, each with an in-order rider of the same mechanism (the scan's
    path in the same launch)."""
    from repro_torch.experiment import spec as t_spec
    cfg = _five_point(t_sim, t_spec, name)
    rider = dataclasses.replace(cfg, controller="inorder", window=1)
    staged = t_sim._stage(five_stream[1], [cfg, rider], cuda)
    _kernel_vs_plain(staged, cfg.window, staged[-1] + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cores,W", [(40, 16), (8, 40)],
                         ids=["40cores", "40slots"])
def test_kernel_general_controller_matches_plain(cuda, n_cores, W):
    """Past 32 cores or 32 window slots the entry runs window_ctl.cuh's
    general controller (cores parked in shared memory, slots strided
    past one warp); against the plain engine, with a rider."""
    names = ("mcf_like", "stream_copy_like", "lbm_like", "gcc_like")
    tb = t_traces.multicore_batch([names[c % 4] for c in range(n_cores)],
                                  240 // n_cores, seed=4)
    grid = [_cfg(t_sim, "chargecache", "frfcfs", W),
            _cfg(t_sim, "base", "frfcfs", 4, policy="closed"),
            _cfg(t_sim, "rltl", "inorder", 1)]
    staged = t_sim._stage(tb, grid, cuda)
    _kernel_vs_plain(staged, W, staged[-1] + 5)


@pytest.mark.cuda
def test_cuda_sweep_matches_cpu_sweep(cuda):
    tb = t_traces.multicore_batch(["mcf_like", "lbm_like"], 200, seed=8)
    grid = [_cfg(t_sim, *m) for m in KERNEL_GRID]
    before = ops.window_launches
    got = t_sim.sweep(tb, grid)
    assert ops.window_launches == before + 1
    for w, g in zip(t_sim.sweep(tb, grid, device="cpu"), got):
        _same(w, g)
