"""Bitwise parity of the PyTorch port's engine with ``repro``'s.

The port's ``sweep(device="cpu")`` runs the plain ``[G]``-batched engine;
every exact-int stat (``tests/_parity.py::BITWISE_KEYS``), ``core_end``,
the per-bank accumulators and the RLTL histogram must equal the JAX
package's on the same trace and grid.  ``repro.controller.oracle`` (a
numpy host simulator) is a third opinion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.controller import oracle as j_oracle  # noqa: E402
from repro.core import aldram as j_aldram  # noqa: E402
from repro.core import dram as j_dram  # noqa: E402
from repro.core import hcrac as j_hcrac  # noqa: E402
from repro.core import simulator as j_sim  # noqa: E402
from repro.core import traces as j_traces  # noqa: E402
from repro.experiment import registry as j_reg  # noqa: E402

from repro_torch.core import aldram as t_aldram  # noqa: E402
from repro_torch.core import dram as t_dram  # noqa: E402
from repro_torch.core import hcrac as t_hcrac  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402
from repro_torch.kernels.sim_step import ref as t_ref  # noqa: E402

from _parity import assert_cell_matches  # noqa: E402

KINDS = j_reg.names()
RAMP = ((0.0, 55.0), (0.02, 70.0), (0.04, 85.0))
GEOMS = ((1, 8), (2, 16))          # 1 channel x 8 banks, 2 x 16 banks


def _pair(kind, ch=2, banks=8, policy="open", refresh="stateful",
          ramp=False, hcrac=None):
    """The same configuration in both packages."""
    out = []
    for sim, dram, al, hc in ((j_sim, j_dram, j_aldram, j_hcrac),
                              (t_sim, t_dram, t_aldram, t_hcrac)):
        mech = dict(kind=kind, thermal=al.ThermalConfig(RAMP if ramp else ()))
        if hcrac is not None:
            mech["hcrac"] = hc.HCRACConfig(**hcrac)
        out.append(sim.SimConfig(
            dram=dram.DRAMConfig(n_channels=ch, n_banks=banks),
            mech=sim.MechanismConfig(**mech), policy=policy,
            refresh_mode=refresh))
    return tuple(out)


def _assert_same(j, t):
    assert_cell_matches(j, t, rltl=j["rltl_hist"] is not None)
    for k in ("bank_acts", "bank_act_ras_sum"):
        np.testing.assert_array_equal(j[k], t[k])


@pytest.fixture(scope="module")
def main_sweep():
    """Every kind x 2 geometries x open/closed x stateful/legacy, 1 400
    requests, RLTL on; the 1-channel points are padded to the 32-bank
    envelope of the 2 x 16-bank ones."""
    keys = [(k, g, pol, rm) for g in GEOMS for k in KINDS
            for pol in ("open", "closed") for rm in ("stateful", "legacy")]
    pairs = [_pair(k, *g, policy=pol, refresh=rm) for k, g, pol, rm in keys]
    jb = j_traces.single_core_batch("milc_like", 1400, seed=5)
    tb = t_traces.single_core_batch("milc_like", 1400, seed=5)
    jr = j_sim.sweep(jb, [p[0] for p in pairs])
    tr = t_sim.sweep(tb, [p[1] for p in pairs], device="cpu")
    return keys, pairs, jr, tr, tb


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_matches_repro(main_sweep, kind):
    keys, _, jr, tr, _ = main_sweep
    n = 0
    for key, j, t in zip(keys, jr, tr):
        if key[0] == kind:
            _assert_same(j, t)
            n += 1
    assert n == 8


def test_padded_envelope_banks_stay_zero(main_sweep):
    keys, _, _, tr, _ = main_sweep
    for key, t in zip(keys, tr):
        nb = key[1][0] * key[1][1]
        assert t["bank_acts"].shape == (32,)
        assert int(np.abs(t["bank_acts"][nb:]).sum()) == 0
        assert int(np.abs(t["bank_act_ras_sum"][nb:]).sum()) == 0
        assert int(t["bank_acts"].sum()) == int(t["acts"])


def test_host_oracle_third_opinion(main_sweep):
    """``repro.controller.oracle.run_host`` (numpy, per request) agrees
    with the port on a spread of the main grid's points."""
    keys, pairs, _, tr, _ = main_sweep
    jb = j_traces.single_core_batch("milc_like", 1400, seed=5)
    picks = [i for i, k in enumerate(keys)
             if k[0] in ("chargecache", "cc_aldram")
             and k[1] == GEOMS[0] and k[3] == "stateful"]
    for i in picks:
        host = j_oracle.run_host(jb, pairs[i][0])
        for k in ("n_req", "lat_sum", "acts", "hcrac_hits", "row_hits",
                  "row_conflicts", "act_ras_sum", "total_cycles"):
            assert int(host[k]) == int(tr[i][k]), (keys[i], k)
        np.testing.assert_array_equal(host["core_end"], tr[i]["core_end"])


@pytest.fixture(scope="module")
def ramp_sweep():
    """A four-core mix under the ramp thermal schedule, open and closed,
    with a 4-bank point padded into a 32-bank envelope and padded
    (dead) steps."""
    keys = [(k, g, pol) for g in ((1, 4), (2, 16))
            for k in KINDS for pol in ("open", "closed")]
    pairs = [_pair(k, *g, policy=pol,
                   ramp=k in ("nuat", "aldram", "cc_aldram"))
             for k, g, pol in keys]
    names = ["milc_like", "mcf_like", "lbm_like", "hmmer_like"]
    jb = j_traces.multicore_batch(names, 350, seed=2)
    tb = t_traces.multicore_batch(names, 350, seed=2)
    jr = j_sim.sweep(jb, [p[0] for p in pairs], pad_steps=True)
    tr = t_sim.sweep(tb, [p[1] for p in pairs], pad_steps=True,
                     device="cpu")
    return keys, jr, tr


@pytest.mark.parametrize("kind", KINDS)
def test_ramp_multicore_pad_steps_matches_repro(ramp_sweep, kind):
    keys, jr, tr = ramp_sweep
    for key, j, t in zip(keys, jr, tr):
        if key[0] == kind:
            _assert_same(j, t)
            if key[1] == (1, 4):
                assert int(np.abs(t["bank_acts"][4:]).sum()) == 0


def test_exact_expiry_and_capacity_grid():
    """HCRAC exact expiry and a capacity x duration grid (padded sets)."""
    pairs = [_pair(k, policy=pol,
                   hcrac=dict(n_entries=n, caching_cycles=cyc,
                              exact_expiry=True))
             for k in ("chargecache", "cc_nuat") for n in (16, 256)
             for cyc in (80_000, 800_000) for pol in ("open", "closed")]
    jb = j_traces.single_core_batch("mcf_like", 900, seed=1)
    tb = t_traces.single_core_batch("mcf_like", 900, seed=1)
    for j, t in zip(j_sim.sweep(jb, [p[0] for p in pairs], rltl=False),
                    t_sim.sweep(tb, [p[1] for p in pairs], rltl=False,
                                device="cpu")):
        assert t["rltl_hist"] is None
        _assert_same(j, t)


def test_simulate_matches_repro_simulate():
    jc, tc = _pair("cc_nuat", ch=1, policy="closed")
    jb = j_traces.multicore_batch(["gcc_like", "lbm_like"], 400, seed=4)
    tb = t_traces.multicore_batch(["gcc_like", "lbm_like"], 400, seed=4)
    j, t = j_sim.simulate(jb, jc), t_sim.simulate(tb, tc, device="cpu")
    _assert_same(j, t)
    for k in ("avg_latency", "hcrac_hit_rate", "row_hit_rate", "rmpkc"):
        assert j[k] == t[k]
    assert j_sim.weighted_speedup(j["core_end"], j["core_end"] + 7) == \
        t_sim.weighted_speedup(t["core_end"], t["core_end"] + 7)


# --------------------------------------------------------- params and parts

def _tree_np(x):
    if hasattr(x, "_asdict"):
        return {k: _tree_np(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _tree_np(v) for k, v in x.items()}
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_grid_params_match_repro_and_round_trip(main_sweep):
    """The port's stacked params equal ``repro``'s leaf for leaf (dtype
    included), and ``params_from_numpy`` rebuilds them from ``repro``'s
    tree; running the port's engine on JAX-made params gives the port's
    own results."""
    _, pairs, _, tr, tb = main_sweep
    jgrid = [p[0] for p in pairs]
    tgrid = [p[1] for p in pairs]
    j_shape, jp = j_sim._grid_shape_and_params(jgrid)
    t_shape, tp = t_sim._grid_shape_and_params(tgrid)
    jtree = _tree_np(jp)
    jflat = _flat({k: v for k, v in jtree.items()
                   if k not in ("frfcfs", "win_cap")})
    tflat = _flat(_tree_np(tp))
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert jflat[k].dtype == tflat[k].dtype, k
        np.testing.assert_array_equal(jflat[k], tflat[k], err_msg=k)
    assert (j_shape.envelope.max_banks_total, j_shape.hcrac.n_sets,
            j_shape.mshr) == (t_shape.envelope.max_banks_total,
                              t_shape.hcrac.n_sets, t_shape.mshr)

    from_j = t_sim.params_from_numpy(jtree)
    for k, v in _flat(_tree_np(from_j)).items():
        np.testing.assert_array_equal(v, tflat[k], err_msg=k)
    # the engine on JAX-made params, first 400 steps of the main trace
    trace = t_sim._device_trace(tb)
    ns_geoms, ns_idx = t_sim._hoist_geoms(tgrid, tgrid)
    ns = t_sim._ns_tables(t_shape, trace, ns_geoms)
    a = t_ref.run_sweep_ref(t_shape, from_j, trace, ns, ns_idx, 70, 400)
    b = t_ref.run_sweep_ref(t_shape, tp, trace, ns, ns_idx, 70, 400)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert torch.equal(a[1], b[1])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)

    frf = dict(jtree, frfcfs=np.ones_like(jtree["frfcfs"]))
    with pytest.raises(NotImplementedError):
        t_sim.params_from_numpy(frf)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_next_same_folded_matches_reverse_scan(seed):
    """The vectorised lookahead equals ``repro``'s reverse scan, ragged
    lengths and folded (colliding) addresses included."""
    rng = np.random.default_rng(seed)
    C, L, nb = 5, 300, 16
    bank = rng.integers(0, 6, (C, L)).astype(np.int32)
    row = rng.integers(0, 4, (C, L)).astype(np.int32)
    length = rng.integers(0, L + 1, C).astype(np.int32)
    want = j_sim._next_same_folded(nb, jnp.asarray(bank), jnp.asarray(row),
                                   jnp.asarray(length))
    got = t_sim._next_same_folded(nb, torch.from_numpy(bank),
                                  torch.from_numpy(row),
                                  torch.from_numpy(length))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_rltl_device_matches_host_post_pass(main_sweep):
    """The batched torch RLTL pass equals the numpy reference per point on
    the engine's own event lanes."""
    _, pairs, _, _, tb = main_sweep
    grid = [p[1] for p in pairs][::7]
    shape, params = t_sim._grid_shape_and_params(grid)
    trace = t_sim._device_trace(tb)
    ns_geoms, ns_idx = t_sim._hoist_geoms(grid, grid)
    ns = t_sim._ns_tables(shape, trace, ns_geoms)
    _, _, ev = t_ref.run_sweep_ref(shape, params, trace, ns, ns_idx, 70,
                                   1400)
    hist, total = t_sim._rltl_device(ev)
    for g in range(len(grid)):
        h, n = t_sim._rltl_post_pass(t_sim.Events(*(x[g] for x in ev)))
        np.testing.assert_array_equal(h, hist[g].numpy())
        assert n == int(total[g])


def test_sim_config_rejects_unported_tiers():
    with pytest.raises(NotImplementedError, match="FR-FCFS"):
        t_sim.SimConfig(controller="frfcfs")
    with pytest.raises(NotImplementedError, match="serving"):
        t_sim.SimConfig(serving=object())
    with pytest.raises(NotImplementedError, match="synthesis"):
        t_sim.SimConfig(workload=object())
    with pytest.raises(ValueError):
        t_sim.SimConfig(policy="lifo")
    assert not hasattr(t_sim.SimConfig(), "backend")


@pytest.mark.slow
def test_golden_file_regenerates():
    """Full regeneration of the golden full-size reference (about a
    minute of JAX on the CPU) equals the committed file."""
    import _torch_golden
    from repro_torch.golden import load
    assert load() == _torch_golden.compute(_torch_golden.batches())
