"""Per-function parity of the PyTorch port's core layer with ``repro``.

Each test feeds the same numpy-seeded inputs to a ``repro`` (JAX, on the
CPU) function and its ``repro_torch`` counterpart and requires exact
equality.  The one exception is the charge model's float32 nanosecond
values: XLA's and PyTorch's float32 ``exp``/``log``/``pow`` may differ in
the last bit, so those are compared to 4 ulp (relative 5e-7) while the
cycle counts derived from them must match exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aldram as j_aldram  # noqa: E402
from repro.core import charge_model as j_cm  # noqa: E402
from repro.core import dram as j_dram  # noqa: E402
from repro.core import hcrac as j_hcrac  # noqa: E402
from repro.core import metrics as j_metrics  # noqa: E402
from repro.core import simulator as j_sim  # noqa: E402
from repro.core import timing as j_timing  # noqa: E402
from repro.core import traces as j_traces  # noqa: E402
from repro.experiment import registry as j_reg  # noqa: E402

from repro_torch.core import aldram as t_aldram  # noqa: E402
from repro_torch.core import charge_model as t_cm  # noqa: E402
from repro_torch.core import dram as t_dram  # noqa: E402
from repro_torch.core import hcrac as t_hcrac  # noqa: E402
from repro_torch.core import mechanisms as t_reg  # noqa: E402
from repro_torch.core import metrics as t_metrics  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.core import timing as t_timing  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402

from repro_torch.golden import (WORKLOADS, build_batch, load,  # noqa: E402
                                load_batch, trace_sha256)

I32 = np.int32

#: timing sets: the DDR3 spec and an odd-valued variant (prime-ish tREFI,
#: tRFC and group count exercise every floor-division branch)
TIMINGS = {
    "ddr3": (j_timing.DDR3_1600, t_timing.DDR3_1600),
    "odd": (dataclasses.replace(j_timing.DDR3_1600, tREFI=6241, tRFC=211,
                                n_refresh_groups=8191),
            dataclasses.replace(t_timing.DDR3_1600, tREFI=6241, tRFC=211,
                                n_refresh_groups=8191)),
}


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(a, b):
    a, b = np.asarray(a), b.numpy() if hasattr(b, "numpy") else np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _rand(rng, lo, hi, n=4096):
    return rng.integers(lo, hi, n, dtype=np.int64).astype(I32)


# ---------------------------------------------------------------- dram.py

@pytest.mark.parametrize("geom", [(2, 1, 8, 65536), (1, 1, 4, 4096),
                                  (2, 2, 8, 1000)])
def test_fold_address_and_row_ids(geom):
    ch, rk, bk, rows = geom
    jcfg = j_dram.DRAMConfig(n_channels=ch, n_ranks=rk, n_banks=bk,
                             n_rows=rows)
    tcfg = t_dram.DRAMConfig(n_channels=ch, n_ranks=rk, n_banks=bk,
                             n_rows=rows)
    jg, tg = j_dram.geom_params(jcfg), t_dram.geom_params(tcfg)
    for f in j_dram.GeomParams._fields:
        _eq(getattr(jg, f), getattr(tg, f))
    rng = np.random.default_rng(0)
    bank = _rand(rng, -70, 70)
    row = _rand(rng, -200_000, 200_000)
    jb, jr = j_dram.fold_address(jg, _j(bank), _j(row))
    tb, tr = t_dram.fold_address(tg, _t(bank), _t(row))
    _eq(jb, tb)
    _eq(jr, tr)
    _eq(j_dram.global_row_id(jg, jb, jr), t_dram.global_row_id(tg, tb, tr))
    _eq(j_dram.channel_of(jg, jb), t_dram.channel_of(tg, tb))
    assert j_dram.envelope_of([jcfg]).__dict__ == \
        t_dram.envelope_of([tcfg]).__dict__


@pytest.mark.parametrize("tname", sorted(TIMINGS))
def test_refresh_arithmetic(tname):
    """time_since_refresh / refresh_adjust / refresh_clamp_span over
    negative and positive cycles, with and without the row's group."""
    jt, tt = TIMINGS[tname]
    jv, tv = j_timing.traced(jt), t_timing.traced(tt)
    rng = np.random.default_rng(1)
    t = _rand(rng, -2**29, 2**29)
    row = _rand(rng, -70_000, 70_000)
    span = _rand(rng, 1, 23)
    _eq(j_dram.time_since_refresh(None, jv, _j(row), _j(t)),
        t_dram.time_since_refresh(None, tv, _t(row), _t(t)))
    for r in (None, row):
        jr_ = None if r is None else _j(r)
        tr_ = None if r is None else _t(r)
        _eq(j_dram.refresh_adjust(jv, _j(t), jr_),
            t_dram.refresh_adjust(tv, _t(t), tr_))
        _eq(j_dram.refresh_clamp_span(jv, _j(t), _j(span), jr_),
            t_dram.refresh_clamp_span(tv, _t(t), _t(span), tr_))
    # concentrate on the blackout edges, where the branches switch
    k = _rand(rng, -3, 20_000)
    edge = (k * jt.tREFI + _rand(rng, -5, jt.tRFC + 30)).astype(I32)
    _eq(j_dram.refresh_adjust(jv, _j(edge), _j(row)),
        t_dram.refresh_adjust(tv, _t(edge), _t(row)))
    _eq(j_dram.refresh_clamp_span(jv, _j(edge), _j(span), _j(k)),
        t_dram.refresh_clamp_span(tv, _t(edge), _t(span), _t(k)))


# ---------------------------------------------------------------- hcrac.py

def _hcrac_case(seed, n_sets_max, ways, exact):
    """Random padded HCRAC states plus per-point params and probes, with
    a small gid range so matches, expiries and LRU ties all occur."""
    rng = np.random.default_rng(seed)
    G = 64
    n_sets = rng.integers(1, n_sets_max + 1, G).astype(I32)
    caching = rng.integers(1, 5000, G).astype(I32)
    period = np.maximum(1, caching // (n_sets * ways)).astype(I32)
    shape = (G, n_sets_max, ways)
    tags = rng.integers(-1, 40, shape).astype(I32)
    itime = rng.integers(-3000, 3000, shape).astype(I32)
    lru = rng.integers(-5, 5, shape).astype(I32)
    gid = rng.integers(0, 40, G).astype(I32)
    t = rng.integers(-4000, 6000, G).astype(I32)  # negative t - phase too
    enable = rng.random(G) < 0.8
    cfg_kw = dict(n_entries=n_sets_max * ways, n_ways=ways,
                  exact_expiry=exact)
    return (n_sets, caching, period, tags, itime, lru, gid, t, enable,
            cfg_kw)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("ways", [1, 2, 4])
def test_hcrac_insert_lookup_alive(exact, ways):
    (n_sets, caching, period, tags, itime, lru, gid, t, enable,
     cfg_kw) = _hcrac_case(7 + ways + 10 * exact, 8, ways, exact)
    jcfg = j_hcrac.HCRACConfig(**cfg_kw)
    tcfg = t_hcrac.HCRACConfig(**cfg_kw)
    tp = t_hcrac.HCRACParams(_t(n_sets), _t(caching), _t(period))
    tst = lambda: t_hcrac.HCRACState(_t(tags.copy()), _t(itime.copy()),
                                     _t(lru.copy()))
    set_idx = np.mod(gid, n_sets).astype(I32)
    t_alive = t_hcrac._alive(tcfg, _t(set_idx),
                             _t(itime[np.arange(64), set_idx]), _t(t), tp)
    t_hit, t_look = t_hcrac.lookup(tcfg, tst(), _t(gid), _t(t),
                                   _t(enable), tp)
    t_ins = t_hcrac.insert(tcfg, tst(), _t(gid), _t(t), _t(enable), tp)
    for g in range(64):
        jp = j_hcrac.HCRACParams(_j(n_sets[g]), _j(caching[g]),
                                 _j(period[g]))
        jst = j_hcrac.HCRACState(_j(tags[g]), _j(itime[g]), _j(lru[g]))
        _eq(j_hcrac._alive(jcfg, _j(set_idx[g]), _j(itime[g, set_idx[g]]),
                           _j(t[g]), jp), t_alive[g])
        hit, look = j_hcrac.lookup(jcfg, jst, _j(gid[g]), _j(t[g]),
                                   _j(enable[g]), jp)
        _eq(hit, t_hit[g])
        ins = j_hcrac.insert(jcfg, jst, _j(gid[g]), _j(t[g]), _j(enable[g]),
                             jp)
        for f in ("tags", "itime", "lru"):
            _eq(getattr(look, f), getattr(t_look, f)[g])
            _eq(getattr(ins, f), getattr(t_ins, f)[g])


def test_hcrac_shapes_and_params():
    for kw in (dict(), dict(n_entries=512, caching_cycles=12_345),
               dict(n_entries=32, n_ways=4, exact_expiry=True)):
        jc, tc = j_hcrac.HCRACConfig(**kw), t_hcrac.HCRACConfig(**kw)
        for a, b in zip(j_hcrac.params_of(jc), t_hcrac.params_of(tc)):
            _eq(a, b)
        assert dataclasses.asdict(j_hcrac.padded_shape(jc, 600)) == \
            dataclasses.asdict(t_hcrac.padded_shape(tc, 600))
        ji = j_hcrac.init(jc)
        ti = t_hcrac.init(tc, 3)
        for a, b in zip(ji, ti):
            for g in range(3):
                _eq(a, b[g])


# ------------------------------------------------- charge model / AL-DRAM

#: NUAT's bin edges and AL-DRAM's equivalent ages (55/70/85 °C and the
#: thermal presets' temperatures), plus the Table 6.1 points
DURATIONS_MS = (0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 22.627416997969522,
                32.0, 48.0, 64.0) + tuple(
    j_aldram.equivalent_idle_ms(tc) for tc in (45.0, 55.0, 62.5, 70.0,
                                               77.0, 85.0, 95.0))


@pytest.mark.parametrize("ms", DURATIONS_MS)
def test_derive_timings(ms):
    a, b = j_cm.derive_timings(ms), t_cm.derive_timings(ms)
    assert (a.tRCD_cycles, a.tRAS_cycles) == (b.tRCD_cycles, b.tRAS_cycles)
    assert b.tRCD_ns == pytest.approx(a.tRCD_ns, rel=5e-7, abs=1e-6)
    assert b.tRAS_ns == pytest.approx(a.tRAS_ns, rel=5e-7, abs=1e-6)
    assert dataclasses.asdict(j_cm.lowered_params(ms)) == \
        dataclasses.asdict(t_cm.lowered_params(ms))


def test_derive_timings_cycles_dense_sweep():
    """Cycle counts agree over a dense sweep of durations, where a
    last-bit float difference could cross a cycle boundary."""
    for ms in np.random.default_rng(3).uniform(0.0, 400.0, 300):
        a, b = j_cm.derive_timings(float(ms)), t_cm.derive_timings(float(ms))
        assert (a.tRCD_cycles, a.tRAS_cycles) == \
            (b.tRCD_cycles, b.tRAS_cycles), ms


def test_timing_tables():
    assert j_reg.default_nuat_bins() == t_reg.default_nuat_bins()
    for ms in (0.5, 1.0, 2.0, 4.0, 16.0, 64.0):
        assert dataclasses.asdict(j_timing.lowered_for_duration(ms)) == \
            dataclasses.asdict(t_timing.lowered_for_duration(ms))
        assert j_timing.ms_to_cycles(ms) == t_timing.ms_to_cycles(ms)
    for f in j_timing.TimingVec._fields:
        _eq(getattr(j_timing.traced(j_timing.DDR3_1600), f),
            getattr(t_timing.traced(t_timing.DDR3_1600), f))


@pytest.mark.parametrize("temp,seed,pen,fac,nb", [
    (55.0, 0, 2, 2, 16), (70.0, 3, 3, 1, 32), (85.0, 1, 2, 2, 8),
    (40.0, 9, 0, 2, 4)])
def test_per_bank_timings(temp, seed, pen, fac, nb):
    kw = dict(temperature_c=temp, process_seed=seed, weak_penalty_max=pen,
              weak_ras_factor=fac)
    a = j_aldram.per_bank_timings(j_aldram.ALDRAMConfig(**kw),
                                  j_timing.DDR3_1600, nb)
    b = t_aldram.per_bank_timings(t_aldram.ALDRAMConfig(**kw),
                                  t_timing.DDR3_1600, nb)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


def test_thermal_params():
    pts = ((0.0, 55.0), (0.02, 70.0), (0.04, 85.0))
    for n_segs in (3, 5):
        a = j_aldram.thermal_params_np(j_aldram.ThermalConfig(pts), n_segs)
        b = t_aldram.thermal_params_np(t_aldram.ThermalConfig(pts), n_segs)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert np.asarray(x).dtype == np.asarray(y).dtype


# ---------------------------------------------------------- mechanisms.py

def test_registry_structure():
    assert j_reg.names() == t_reg.names()
    assert [n for n, _ in j_reg.block_bearing()] == \
        [n for n, _ in t_reg.block_bearing()]
    for k in j_reg.names():
        assert j_reg.components(k) == t_reg.components(k)
        assert j_reg.get(k).consumes == t_reg.get(k).consumes
        assert j_reg.get(k).uses_hcrac == t_reg.get(k).uses_hcrac
        jm = j_sim.MechanismConfig(kind=k)
        tm = t_sim.MechanismConfig(kind=k)
        assert repr(j_reg.canonical_mech(jm)) == repr(t_reg.canonical_mech(tm))


def _select_grid(which):
    """The same mechanism grid in both packages: every kind, with the
    ramp thermal schedule on the drift-reading kinds and a 32-bank
    envelope (the 1-channel points are padded)."""
    ramp = ((0.0, 55.0), (0.02, 70.0), (0.04, 85.0))
    out = []
    for ch in (1, 2):
        for k in j_reg.names():
            pkg_sim, pkg_dram, pkg_al = which
            th = pkg_al.ThermalConfig(
                ramp if k in ("nuat", "aldram", "cc_aldram") else ())
            out.append(pkg_sim.SimConfig(
                dram=pkg_dram.DRAMConfig(n_channels=ch, n_banks=16),
                mech=pkg_sim.MechanismConfig(kind=k, thermal=th)))
    return out


@pytest.mark.parametrize("kind", j_reg.names())
def test_select_timings(kind):
    """Each policy's timing fold, batched in the port and vmapped in JAX,
    on random (tsr, tslp, hit, bank, segment) contexts."""
    jgrid = [c for c in _select_grid((j_sim, j_dram, j_aldram))
             if c.mech.kind == kind]
    tgrid = [c for c in _select_grid((t_sim, t_dram, t_aldram))
             if c.mech.kind == kind]
    _, jp = j_sim._grid_shape_and_params(jgrid)
    _, tp = t_sim._grid_shape_and_params(tgrid)
    G = len(jgrid)
    rng = np.random.default_rng(11)
    R = 512
    tsr = rng.integers(0, 60_000_000, (R, G)).astype(I32)
    tslp = np.where(rng.random((R, G)) < 0.5,
                    rng.integers(0, 2_000_000, (R, G)), 2**30).astype(I32)
    hit = rng.random((R, G)) < 0.5
    act = rng.random((R, G)) < 0.7
    bank = rng.integers(0, 32, (R, G)).astype(I32)
    seg = rng.integers(0, 3, (R, G)).astype(I32)

    jfn = jax.jit(jax.vmap(jax.vmap(
        lambda mech, timing, geom, h, ts, tl, a, b, s: j_reg.select_timings(
            mech, j_reg.SelectCtx(timing=timing, geom=geom, hcrac_hit=h,
                                  tsr=ts, tslp=tl, needs_act=a, bank=b,
                                  seg=s))),
        in_axes=(None, None, None, 0, 0, 0, 0, 0, 0)))
    j_rcd, j_ras = jfn(jp.mech, jp.timing, jp.geom, hit, tsr, tslp, act,
                       bank, seg)
    for r in range(0, R, 64):
        ctx = t_reg.SelectCtx(timing=tp.timing, geom=tp.geom,
                              hcrac_hit=_t(hit[r]), tsr=_t(tsr[r]),
                              tslp=_t(tslp[r]), needs_act=_t(act[r]),
                              bank=_t(bank[r]), seg=_t(seg[r]))
        t_rcd, t_ras = t_reg.select_timings(tp.mech, ctx)
        _eq(j_rcd[r], t_rcd)
        _eq(j_ras[r], t_ras)
    _eq(j_reg.hcrac_gate(jax.tree_util.tree_map(lambda x: x[0], jp.mech)),
        t_reg.hcrac_gate(tp.mech)[0])


# --------------------------------------------------- traces.py / metrics.py

def _batch_bytes(batch):
    return [(f, np.asarray(getattr(batch, f)).dtype.str,
             np.asarray(getattr(batch, f)).tobytes())
            for f in batch._fields]


@pytest.mark.parametrize("seed", [0, 17])
def test_trace_batches_byte_identical(seed):
    """Every workload profile, at two seeds, single-core and in a mix."""
    for w in j_traces.WORKLOADS:
        assert _batch_bytes(j_traces.single_core_batch(w.name, 300, seed)) \
            == _batch_bytes(t_traces.single_core_batch(w.name, 300, seed)), \
            w.name
    names = [w.name for w in j_traces.WORKLOADS][seed % 5::3][:6]
    assert _batch_bytes(j_traces.multicore_batch(names, 250, seed)) == \
        _batch_bytes(t_traces.multicore_batch(names, 250, seed))
    assert j_traces.random_mixes(20, 8, seed) == \
        t_traces.random_mixes(20, 8, seed)


@pytest.mark.parametrize("wname", sorted(WORKLOADS))
def test_full_size_trace_digests(wname):
    """The port's generator reproduces, with this installation's numpy,
    the full-size traces whose JAX results the golden file records; the
    stored copy (what chip_smoke.py runs) holds the same bytes."""
    golden = load()["workloads"][wname]
    assert trace_sha256(build_batch(t_traces, WORKLOADS[wname])) == \
        golden["trace_sha256"]
    for pkg in (t_traces, j_traces):
        assert trace_sha256(load_batch(pkg, wname)) == golden["trace_sha256"]


def test_metrics_registry():
    # the serving loop's metrics come with the serving slice
    assert set(t_metrics.metric_names()) < set(j_metrics.metric_names())
    rng = np.random.default_rng(5)
    stats = {k: int(v) for k, v in zip(
        ("lat_sum", "n_req", "hcrac_hits", "hcrac_lookups", "acts_lowered",
         "acts", "row_hits", "total_cycles", "ref_blocked_cycles"),
        rng.integers(0, 10**6, 9))}
    assert j_metrics.finalize_scalars(dict(stats)) == \
        t_metrics.finalize_scalars(dict(stats))
