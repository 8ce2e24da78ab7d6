"""The port's serving closed loop (``sweep_serving`` / ``simulate_serving``,
the host scheduler and its oracle, the arrival process) against
``repro``'s, and inside the port.

* Against ``repro`` on the CPU: request attributes bitwise; drawn
  arrival counts under ``repro``'s own mirror rule (exact ON/OFF gate,
  under 1e-3 of counts differing: XLA's and PyTorch's float32 ``log1p``
  / ``log`` differ by about an ulp); the host scheduler's stats and
  emitted trace bitwise; the batched loop with pinned counts bitwise in
  every sim stat, serve stat and per-step array, for every policy x
  {base, chargecache}; ``reduce_keys`` equal to ``repro``'s.
* Inside the port: host-vs-batched parity on a pinned schedule
  (``repro``'s ``test_serving_loop.py`` checks), preemption liveness.
* The CUDA serving entry against its plain version, and the host
  scheduler's probes through the probe kernel, marked ``cuda``: these
  skip without a CUDA device and run on the card with
  ``python -m pytest -m cuda tests/test_torch_serving.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import simulator as j_sim
    from repro.serving import study as j_study
    from repro.serving.loop import ServingSpec as JSpec
    from repro.serving.loop import engine as j_engine
    from repro.serving.loop.oracle import run_host as j_run_host
    from repro.workloads import arrivals as j_arr
except ImportError:    # no JAX here: only the port-internal tests run
    j_sim = None

from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.kernels.sim_step import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.hcrac import ops as hc_ops  # noqa: E402
from repro_torch.serving import study as t_study  # noqa: E402
from repro_torch.serving.loop import engine as t_engine  # noqa: E402
from repro_torch.serving.loop import policies as t_pol  # noqa: E402
from repro_torch.serving.loop.oracle import run_host, run_host_grid  # noqa: E402
from repro_torch.serving.loop.spec import ServingSpec  # noqa: E402
from repro_torch.workloads import arrivals as t_arr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("fifo", "charge_aware", "preempting")
MECHS = ("base", "chargecache")
#: a small loop whose queue fills: drops and preemptions happen
GRID_KW = dict(n_reqs=40, max_batch=6, queue_cap=8, arrivals_max=4,
               n_steps=80, cycles_per_step=4000, hot_entries=64, hot_ways=2,
               hot_caching_ms=0.05, hot_exact=False, preempt_queue_frac=0.25)
GRID_ARR = dict(rate=2.0, burstiness=2.0, prompt_pages_min=1,
                prompt_pages_max=2, decode_min=4, decode_max=12, seed=7)
REDUCE = ("n_req", "acts", "hcrac_hits", "lat_sum", "total_cycles",
          "arrived", "dropped", "retired", "preempted", "admit_hot",
          "occ_sum", "n_steps")


@pytest.fixture(scope="module")
def jax_ref():
    if j_sim is None:
        pytest.skip("needs the JAX package (repro) to compare with")


def _t_spec(policy, arr=GRID_ARR, **kw):
    return ServingSpec(policy=policy, arrival=t_arr.ArrivalConfig(**arr),
                       **{**GRID_KW, **kw})


def _t_grid(**kw):
    return [t_sim.SimConfig(serving=_t_spec(p, **kw),
                            mech=t_sim.MechanismConfig(kind=k))
            for p in POLICIES for k in MECHS]


def _j_grid(**kw):
    return [j_sim.SimConfig(serving=JSpec(
        policy=p, arrival=j_arr.ArrivalConfig(**GRID_ARR),
        **{**GRID_KW, **kw}), mech=j_sim.MechanismConfig(kind=k))
        for p in POLICIES for k in MECHS]


def _pinned(n_points, n_steps=80, seed=5):
    return np.random.default_rng(seed).integers(
        0, 5, (n_points, n_steps)).astype(np.int32)


def _assert_rows_equal(got: dict, want: dict):
    for k, w in want.items():
        if k == "steps":
            for f in w:
                np.testing.assert_array_equal(got["steps"][f],
                                              np.asarray(w[f]), err_msg=f)
        elif w is None:
            assert got[k] is None, k
        elif np.ndim(w) == 0:
            assert float(got[k]) == float(w), (k, got[k], w)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                          err_msg=k)


@pytest.fixture(scope="module")
def pinned_pair(jax_ref):
    """Both packages over the 6-point policy x mechanism grid on pinned
    per-point schedules, per-step arrays collected."""
    counts = _pinned(6)
    want = j_sim.sweep_serving(_j_grid(), counts=counts, collect_steps=True)
    got = t_sim.sweep_serving(_t_grid(), counts=counts, collect_steps=True,
                              device="cpu")
    return got, want


# ------------------------------------------------------- arrival process

def test_request_attrs_bitwise(jax_ref):
    cfg = dict(prompt_pages_min=1, prompt_pages_max=8, decode_min=16,
               decode_max=64, seed=-9)
    idx = np.arange(-64, 4032, dtype=np.int32)
    tp = t_arr.arrival_params(t_arr.ArrivalConfig(**cfg), 1)
    jp = j_arr.arrival_params(j_arr.ArrivalConfig(**cfg), 1, xp=np)
    got = t_arr.request_attrs(tp, torch.from_numpy(idx))
    want = j_arr.request_attrs(np, jp, idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].min() >= 1 and got[0].max() <= 8


@pytest.mark.parametrize("rate,burst", [(0.5, 1.0), (2.0, 1.0), (2.0, 4.0),
                                        (6.0, 8.0)])
def test_step_counts_under_repro_rule(jax_ref, rate, burst):
    """Drawn counts: the ON/OFF gate exactly, under 1e-3 of the counts
    differing from repro's traced draw (its own mirror rule)."""
    cfg = dict(rate=rate, burstiness=burst, seed=11)
    steps = np.arange(20_000, dtype=np.int32)
    got = t_arr.step_counts(t_arr.arrival_params(t_arr.ArrivalConfig(**cfg),
                                                 1), torch.from_numpy(steps))
    want = np.asarray(j_arr.step_counts(
        jnp, j_arr.arrival_params(j_arr.ArrivalConfig(**cfg), 1),
        jnp.asarray(steps)))
    got = got.numpy()
    assert got.dtype == np.int32 and got.min() >= 0
    # the gate: an OFF step draws 0 on both sides (a count of 0 from an ON
    # step is possible on both, so compare where repro's gate is off)
    b = np.float32(max(burst, 1.0))
    u_on = (j_arr.prng.hash_u32(np, np.int32(11), j_arr._L_ON, steps)
            >> np.uint32(8)).astype(np.float32) * j_arr.prng._U24
    off = ~(u_on * b < np.float32(1.0))
    assert (got[off] == 0).all()
    assert np.mean(got != want) < 1e-3


def test_arrival_statistics_and_reference_counts(jax_ref):
    """Long-run mean is ``rate`` at every burstiness (the knob moves
    variance), and the numpy reference equals repro's."""
    for b in (1.0, 6.0):
        cfg = t_arr.ArrivalConfig(rate=2.0, burstiness=b, seed=5)
        c = t_arr.step_counts(t_arr.arrival_params(cfg, 1),
                              torch.arange(20_000, dtype=torch.int32))
        assert abs(float(c.float().mean()) - 2.0) / 2.0 < 0.1
        np.testing.assert_array_equal(
            t_arr.reference_counts(cfg, 5000, seed=17),
            j_arr.reference_counts(j_arr.ArrivalConfig(
                rate=2.0, burstiness=b, seed=5), 5000, seed=17))


# ------------------------------------------------------ host scheduler

@pytest.mark.parametrize("aware", [False, True], ids=["fifo", "charge_aware"])
def test_build_scheduler_matches_repro(jax_ref, aware):
    """The host loop at a reduced size: stats, admission hot rate and the
    emitted trace bitwise (max_batch 4, so charge-aware admission ranks
    a queue through the probe)."""
    kw = dict(n_reqs=16, steps=40, max_batch=4, seed=11)
    got = t_study.build_scheduler(aware, device="cpu", **kw)
    want = j_study.build_scheduler(aware, **kw)
    assert got.stats == want.stats
    assert t_study.admission_hot_rate(got) == j_study.admission_hot_rate(want)
    if aware:
        assert got.stats["probes"] > 0
    gt, wt = got.emit_trace(), want.emit_trace()
    for f in wt._fields:
        np.testing.assert_array_equal(np.asarray(getattr(gt, f)),
                                      np.asarray(getattr(wt, f)), err_msg=f)


def test_run_host_matches_repro(jax_ref):
    """The oracle itself (hashed page ids, pinned arrivals, charge-aware
    probes of the queue) at a reduced size."""
    kw = {**_PARITY_KW, "n_reqs": 16, "n_steps": 50, "max_batch": 4}
    spec = ServingSpec(policy="charge_aware",
                       arrival=t_arr.ArrivalConfig(**_PARITY_ARR), **kw)
    counts = _parity_counts(50)
    got, occ = run_host(spec, counts, device="cpu")
    assert got.stats["probes"] > 0
    j_spec = JSpec(policy="charge_aware", arrival=j_arr.ArrivalConfig(
        **_PARITY_ARR), **kw)
    want, j_occ = j_run_host(j_spec, counts)
    assert got.stats == want.stats
    np.testing.assert_array_equal(occ, j_occ)


# ---------------------------------------------------- the batched loop

@pytest.mark.parametrize("i", range(6), ids=[f"{p}-{k}" for p in POLICIES
                                             for k in MECHS])
def test_sweep_serving_pinned_matches_repro(pinned_pair, i):
    got, want = pinned_pair
    _assert_rows_equal(got[i], want[i])


def test_pinned_grid_exercises_every_branch(pinned_pair):
    got, _ = pinned_pair
    by = {p: [got[i] for i in range(6) if i // 2 == POLICIES.index(p)]
          for p in POLICIES}
    assert all(r["dropped"] > 0 for r in got)
    assert all(r["preempted"] > 0 for r in by["preempting"])
    assert all(r["preempted"] == 0 for r in by["fifo"] + by["charge_aware"])
    assert all(0 < r["admit_hot"] < r["admit_probes"] for r in got)
    assert got[1]["hcrac_hits"] > 0 and got[0]["hcrac_hits"] == 0


def test_reduce_keys_and_drawn_counts_match_repro(jax_ref):
    """Drawn arrivals with ``reduce_keys``: where the port draws repro's
    counts (the test checks they do here) the reduced columns are equal;
    with the same keys over pinned counts they equal repro's too."""
    want = j_sim.sweep_serving(_j_grid(), reduce_keys=REDUCE)
    got = t_sim.sweep_serving(_t_grid(), reduce_keys=REDUCE, device="cpu")
    steps = np.arange(80, dtype=np.int32)
    t_counts = t_arr.step_counts(t_arr.arrival_params(
        t_arr.ArrivalConfig(**GRID_ARR), 40), torch.from_numpy(steps))
    j_counts = j_arr.step_counts(jnp, j_arr.arrival_params(
        j_arr.ArrivalConfig(**GRID_ARR), 40), jnp.asarray(steps))
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    assert got.dtype == np.int32 and got.shape == (6, len(REDUCE))
    np.testing.assert_array_equal(got, np.asarray(want))
    counts = _pinned(6)
    rows = t_sim.sweep_serving(_t_grid(), counts=counts, device="cpu")
    red = t_sim.sweep_serving(_t_grid(), counts=counts, reduce_keys=REDUCE,
                              device="cpu")
    np.testing.assert_array_equal(
        red, [[r[k] for k in REDUCE] for r in rows])


def test_reduce_keys_refuse_unknown():
    with pytest.raises(ValueError, match="reduce keys"):
        t_sim.sweep_serving(_t_grid()[:1], counts=_pinned(1),
                            reduce_keys=("n_req", "nope"), device="cpu")


# ------------------------------------- host vs batched, inside the port

_PARITY_ARR = dict(rate=1.5, burstiness=1.0, prompt_pages_min=1,
                   prompt_pages_max=2, decode_min=4, decode_max=12, seed=7)
_PARITY_KW = dict(n_reqs=48, max_batch=8, queue_cap=64, arrivals_max=4,
                  n_steps=160, cycles_per_step=4000, hot_entries=1018,
                  hot_ways=2, hot_caching_ms=0.05, hot_exact=True)


def _parity_spec(policy, decode_min=4, decode_max=12):
    arr = {**_PARITY_ARR, "decode_min": decode_min, "decode_max": decode_max}
    return ServingSpec(policy=policy, arrival=t_arr.ArrivalConfig(**arr),
                       **_PARITY_KW)


def _parity_counts(n_steps=160, seed=42):
    """Pinned arrivals that never hit queue_cap / arrivals_max (the host
    queue is unbounded)."""
    return np.random.default_rng(seed).integers(0, 4, n_steps).astype(
        np.int32)


def test_fifo_host_parity_pinned():
    """FIFO on a pinned schedule: per-step occupancy, retirement and the
    hot-probe stats of the batched loop equal the host scheduler's."""
    counts = _parity_counts()
    spec = _parity_spec("fifo")
    res = t_sim.simulate_serving(t_sim.SimConfig(serving=spec),
                                 counts=counts, device="cpu")
    sched, occ = run_host(spec, counts, device="cpu")
    assert res["arrived"] == spec.n_reqs
    assert res["retired"] == sched.stats["retired"] == spec.n_reqs
    np.testing.assert_array_equal(res["steps"]["occ"], occ)
    assert res["admit_probes"] == sched.stats["admit_probes"]
    assert res["admit_hot"] == sched.stats["admit_hot"]
    assert 0 < res["admit_hot"] < res["admit_probes"]


def test_charge_aware_host_parity_occupancy():
    """Charge-aware with a constant decode length: the admitted count per
    step does not depend on which requests are picked, so occupancy and
    retirement equal the host's."""
    counts = _parity_counts()
    spec = _parity_spec("charge_aware", decode_min=8, decode_max=8)
    res = t_sim.simulate_serving(t_sim.SimConfig(serving=spec),
                                 counts=counts, device="cpu")
    sched, occ = run_host(spec, counts, device="cpu")
    assert res["retired"] == sched.stats["retired"] == spec.n_reqs
    np.testing.assert_array_equal(res["steps"]["occ"], occ)


def test_fifo_host_parity_pinned_grid():
    """Per-point schedules in one launch against independent host
    replays; a shared ``[n_steps]`` schedule broadcasts."""
    counts = np.random.default_rng(7).integers(0, 4, (3, 160)).astype(
        np.int32)
    specs = [_parity_spec("fifo"), _parity_spec("fifo", 6, 10),
             _parity_spec("fifo", 8, 8)]
    res = t_sim.sweep_serving([t_sim.SimConfig(serving=sp) for sp in specs],
                              counts=counts, collect_steps=True, device="cpu")
    host = run_host_grid(specs, counts, device="cpu")
    for r, (sched, occ) in zip(res, host):
        assert r["retired"] == sched.stats["retired"] == 48
        np.testing.assert_array_equal(r["steps"]["occ"], occ)
        assert r["admit_probes"] == sched.stats["admit_probes"]
        assert r["admit_hot"] == sched.stats["admit_hot"]
    assert len({tuple(r["steps"]["occ"].tolist()) for r in res}) == 3
    b = run_host_grid(specs[:2], counts[0], device="cpu")
    s0, o0 = run_host(specs[0], counts[0], device="cpu")
    np.testing.assert_array_equal(b[0][1], o0)
    assert b[0][0].stats == s0.stats


def test_preempting_liveness():
    """An overloaded queue: preemption fires, every request retires, and
    requeued work is re-admitted."""
    spec = ServingSpec(
        policy="preempting",
        arrival=t_arr.ArrivalConfig(rate=4.0, burstiness=2.0,
                                    prompt_pages_min=1, prompt_pages_max=2,
                                    decode_min=8, decode_max=16, seed=3),
        n_reqs=24, max_batch=4, queue_cap=8, arrivals_max=8, n_steps=150,
        cycles_per_step=2000, hot_entries=256, hot_ways=2,
        hot_caching_ms=0.05, hot_exact=True, preempt_queue_frac=0.25)
    res = t_sim.simulate_serving(t_sim.SimConfig(serving=spec), device="cpu")
    assert res["preempted"] > 0
    assert res["arrived"] == res["retired"] == 24
    assert res["admitted"] == 24 + res["preempted"]


# ------------------------------------------------------- entry points

def test_sim_config_takes_a_serving_spec():
    spec = _t_spec("fifo")
    assert t_sim.SimConfig(serving=spec).serving is spec
    with pytest.raises(TypeError, match="ServingSpec"):
        t_sim.SimConfig(serving=object())
    with pytest.raises(ValueError, match="policy"):
        _t_spec("lifo")
    with pytest.raises(ValueError, match="arrivals_max"):
        _t_spec("fifo", arrivals_max=9)


def test_grid_errors():
    with pytest.raises(ValueError, match="empty"):
        t_sim.sweep_serving([], device="cpu")
    with pytest.raises(ValueError, match="serving"):
        t_sim.sweep_serving([t_sim.SimConfig()], device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        t_sim.sweep_serving([t_sim.SimConfig(serving=_t_spec("fifo")),
                             t_sim.SimConfig(serving=_t_spec(
                                 "fifo", max_batch=5))], device="cpu")
    with pytest.raises(ValueError, match="pinned counts"):
        t_sim.sweep_serving(_t_grid()[:1], counts=np.zeros(7, np.int32),
                            device="cpu")
    with pytest.raises(ValueError, match="horizon"):
        t_sim.sweep_serving([t_sim.SimConfig(serving=_t_spec(
            "fifo", n_steps=300_000))], device="cpu")


def test_entry_points_want_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here; the default device works")
    cfg = t_sim.SimConfig(serving=_t_spec("fifo"))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sim.sweep_serving([cfg])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sim.simulate_serving(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_host(_parity_spec("fifo"), _parity_counts())


def test_cpu_dispatch_is_the_plain_engine():
    shape, params, warm = t_engine.stage_serving(_t_grid()[:2], None, True,
                                                 torch.device("cpu"))
    counts = torch.from_numpy(_pinned(2))
    before = ops.serve_launches
    a = ops.run_serve(shape, params, warm, counts)
    b = ref.run_serve_ref(shape, params, warm, counts)
    assert ops.serve_launches == before
    for k in b[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    for x, y in zip(a[3], b[3]):
        assert torch.equal(x, y)


def test_ops_refuses_policies_without_a_kernel_body(monkeypatch):
    shape, params, warm = t_engine.stage_serving(_t_grid()[:1], None, False,
                                                 torch.device("cpu"))
    ops.check_serving_registry()
    monkeypatch.setitem(t_pol._REGISTRY, "probe_policy", t_pol.Policy())
    with pytest.raises(NotImplementedError, match="probe_policy"):
        ops.run_serve(shape, params, warm, None)


def test_kernel_refuses_cpu_tensors():
    shape, params, warm = t_engine.stage_serving(_t_grid()[:1], None, False,
                                                 torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.sim_serve(shape, params, warm)


def test_packed_serve_fields_match_the_cuda_source():
    """kernel.py's serving field and size lists equal the ones compiled
    into the kernel (read from the source here; checked again on load),
    and the packed row holds each field in its column."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "sim_step" / "csrc"
           / "sim_step.cu").read_text()
    abi = "".join(re.findall(r'"([^"]*)"', src.split("kServeAbi =")[1]
                             .split(";\n")[0]))
    assert abi == kernel.serve_abi_string()
    enum = src.split("enum ServeField {")[1].split("};")[0]
    assert len(re.findall(r"\bV_\w+", enum)) == len(kernel.SERVE_FIELDS)
    assert enum.strip().endswith("N_SERVE_FIELDS")
    dims = src.split("struct ServeDims {")[1].split("};")[0]
    assert re.findall(r"\w+", dims)[1:] == list(kernel.SERVE_DIMS)
    grid = _t_grid()
    shape, params, warm = t_engine.stage_serving(grid, None, False,
                                                 torch.device("cpu"))
    row = kernel.pack_serve(params, warm)
    at = {f: i for i, f in enumerate(kernel.SERVE_FIELDS)}
    assert row.dtype == torch.int32 and row.shape == (6, len(at))
    assert row[:, at["rate"]].view(torch.float32).tolist() == [2.0] * 6
    assert row[:, at["preempting_enable"]].tolist() == [0, 0, 0, 0, 1, 1]
    assert row[:, at["preempting_q_thresh"]].tolist() == [2] * 6
    assert row[:, at["warmup"]].tolist() == [4] * 6


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_serving.py)")
    return torch.device("cuda")


def _assert_kernel_matches_plain(dev, grid, counts):
    """The serving entry and the plain engine on ``grid`` (``counts``
    pinned, or drawn where None): every output bit for bit."""
    shape, params, warm = t_engine.stage_serving(grid, None, True, dev)
    counts = None if counts is None else torch.from_numpy(counts).to(dev)
    before = ops.serve_launches
    got = ops.run_serve(shape, params, warm, counts)
    assert ops.serve_launches == before + 1
    want = ref.run_serve_ref(shape, params, warm, counts)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    assert torch.equal(got[2], want[2])
    for x, y in zip(got[3], want[3]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True], ids=["drawn", "pinned"])
@pytest.mark.parametrize("exact", [False, True], ids=["sweep", "exact"])
def test_kernel_matches_plain_serving(cuda, pinned, exact):
    grid = _t_grid(hot_exact=exact) + _t_grid(hot_exact=exact,
                                              hot_entries=128)
    _assert_kernel_matches_plain(cuda, grid,
                                 _pinned(len(grid)) if pinned else None)


#: the scale streams' geometry and one past a warp's lanes: (slots,
#: queue, arrivals a step)
WIDE = {"32x128": (32, 128, 32), "48x200": (48, 200, 48)}


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True], ids=["drawn", "pinned"])
@pytest.mark.parametrize("exact", [False, True], ids=["sweep", "exact"])
@pytest.mark.parametrize("geometry", sorted(WIDE))
def test_kernel_matches_plain_serving_wide(cuda, geometry, pinned, exact):
    """The scheduler's strided lanes, many records a step, the queue
    filling (drops) and preemptions, at full widths."""
    SB, Q, A = WIDE[geometry]
    arr = t_arr.ArrivalConfig(rate=8.0, burstiness=2.0, prompt_pages_min=1,
                              prompt_pages_max=2, decode_min=4,
                              decode_max=8, seed=11)
    grid = [t_sim.SimConfig(serving=ServingSpec(
        policy=p, arrival=arr, n_reqs=10_000, max_batch=SB, queue_cap=Q,
        arrivals_max=A, n_steps=40, hot_entries=1024, hot_ways=2,
        hot_caching_ms=0.05, hot_exact=exact),
        mech=t_sim.MechanismConfig(kind=k)) for p in POLICIES for k in MECHS]
    counts = np.random.default_rng(5).integers(
        0, A + 8, (len(grid), 40)).astype(np.int32)
    _assert_kernel_matches_plain(cuda, grid, counts if pinned else None)


@pytest.mark.cuda
def test_host_parity_on_the_card(cuda):
    """The host scheduler probes through the probe kernel and the batched
    loop runs the serving entry; they agree as on the CPU."""
    counts = _parity_counts()
    spec = _parity_spec("fifo")
    before = (hc_ops.launches, ops.serve_launches)
    sched, occ = run_host(spec, counts)
    res = t_sim.simulate_serving(t_sim.SimConfig(serving=spec),
                                 counts=counts)
    assert hc_ops.launches > before[0]
    assert ops.serve_launches == before[1] + 1
    np.testing.assert_array_equal(res["steps"]["occ"], occ)
    assert res["retired"] == sched.stats["retired"]
    assert res["admit_probes"] == sched.stats["admit_probes"]
    assert res["admit_hot"] == sched.stats["admit_hot"]
