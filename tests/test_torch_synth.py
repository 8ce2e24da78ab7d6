"""The port's on-device synthesis path (``sweep_synth`` /
``simulate_synth``) against ``repro``'s, and inside the port.

* Against ``repro`` on the CPU: each point's stream is compared first
  (``workloads.materialize`` in both packages); where the streams are
  equal every stat, ``core_end``, bank array and RLTL histogram must be
  bitwise equal, else the rule of ``tests/_torch_streams.py`` applies.
* Inside the port: ``sweep_synth`` equals ``sweep`` over the
  materialized stream, bitwise (the identity-fold contract).
* The CUDA synthesis entry against its plain version, marked ``cuda``:
  these skip without a CUDA device and run on the card with
  ``python -m pytest -m cuda tests/test_torch_synth.py``.  The card's
  machine has no JAX, so ``repro`` is imported where it is there and the
  tests that compare with it skip where it is not.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from repro.core import dram as j_dram
    from repro.core import simulator as j_sim
    from repro.core import traces as j_traces
    from repro.workloads import materialize as j_materialize
except ImportError:    # no JAX here: only the port-internal tests run
    j_dram = j_sim = j_traces = j_materialize = None

from repro_torch.core import dram as t_dram  # noqa: E402
from repro_torch.core import mechanisms as t_reg  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402
from repro_torch.kernels.sim_step import kernel, ops, ref  # noqa: E402
from repro_torch.workloads import materialize as t_materialize  # noqa: E402

from _parity import assert_cell_matches  # noqa: E402
from _torch_streams import (STREAM_FIELDS,  # noqa: E402
                            assert_stats_under_rule,
                            assert_streams_under_rule)

ROOT = Path(__file__).resolve().parents[1]
KINDS = t_reg.names()
MIX = ("mcf_like", "lbm_like")
GEOMS = (1, 2)                     # channels (8 banks each)
REDUCE = ("n_req", "acts", "hcrac_hits", "row_hits", "total_cycles")


@pytest.fixture(scope="module")
def jax_ref():
    if j_sim is None:
        pytest.skip("needs the JAX package (repro) to compare with")


def _pair(kind, il="bank", ch=2, policy="open", names=MIX, n_req=700,
          seed=3, phases=(), refresh="stateful", banks=8):
    """The same synthetic point in both packages (``None`` for
    ``repro``'s where it cannot be imported)."""
    out = [None]
    for sim, dram, tr in ((j_sim, j_dram, j_traces),
                          (t_sim, t_dram, t_traces)):
        if sim is None:
            continue
        out.append(sim.SimConfig(
            dram=dram.DRAMConfig(n_channels=ch, n_banks=banks),
            mech=sim.MechanismConfig(kind=kind), policy=policy,
            refresh_mode=refresh, interleave=dram.InterleaveConfig(il),
            workload=tr.WorkloadSpec(names=names, n_req=n_req, seed=seed,
                                     phases=phases)))
    return tuple(out[-2:])


@pytest.fixture(scope="module")
def main_grid(jax_ref):
    """Every kind x interleave x 2 geometries x open/closed on a 2-core
    mix, both packages, RLTL on; plus each (interleave, geometry)
    stream's difference count."""
    keys = [(k, il, ch, pol) for k in KINDS for il in t_dram.INTERLEAVE_KINDS
            for ch in GEOMS for pol in ("open", "closed")]
    pairs = [_pair(k, il, ch, pol) for k, il, ch, pol in keys]
    jr = j_sim.sweep_synth([p[0] for p in pairs])
    tr = t_sim.sweep_synth([p[1] for p in pairs], device="cpu")
    diffs = {}
    for il in t_dram.INTERLEAVE_KINDS:
        for ch in GEOMS:
            j, t = _pair("base", il, ch)
            diffs[il, ch] = assert_streams_under_rule(
                j_materialize(j.workload, j.dram, j.interleave),
                t_materialize(t.workload, t.dram, t.interleave))
    return keys, pairs, jr, tr, diffs


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_synth_matches_repro(main_grid, kind):
    keys, _, jr, tr, diffs = main_grid
    n = 0
    for (k, il, ch, _), j, t in zip(keys, jr, tr):
        if k != kind:
            continue
        assert_stats_under_rule(j, t, diffs[il, ch] == 0)
        n += 1
    assert n == 4 * len(GEOMS) * 2


def test_sweep_synth_reduce_keys_matches_repro(main_grid):
    keys, pairs, jr, tr, diffs = main_grid
    sel = [i for i, (_, il, ch, _) in enumerate(keys) if diffs[il, ch] == 0]
    assert sel, "no stream equal to repro's"
    want = j_sim.sweep_synth([pairs[i][0] for i in sel], reduce_keys=REDUCE)
    got = t_sim.sweep_synth([pairs[i][1] for i in sel], reduce_keys=REDUCE,
                            device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(sel), len(REDUCE))
    np.testing.assert_array_equal(got, np.asarray(want))
    # the reduced columns are the full stats' values
    for row, i in zip(got, sel):
        assert list(row) == [int(tr[i][k]) for k in REDUCE]


def test_sweep_synth_legacy_refresh_and_phases_match_repro(jax_ref):
    pairs = [_pair(k, il, 2, pol, refresh=rm, n_req=500,
                   phases=((0.4, ("stream_copy_like", "gcc_like")),))
             for k in ("base", "cc_aldram", "rltl") for il in ("row", "xor")
             for pol in ("open", "closed") for rm in ("legacy", "stateful")]
    jr = j_sim.sweep_synth([p[0] for p in pairs])
    tr = t_sim.sweep_synth([p[1] for p in pairs], device="cpu")
    for (j_cfg, t_cfg), j, t in zip(pairs, jr, tr):
        n = assert_streams_under_rule(
            j_materialize(j_cfg.workload, j_cfg.dram, j_cfg.interleave),
            t_materialize(t_cfg.workload, t_cfg.dram, t_cfg.interleave))
        assert_stats_under_rule(j, t, n == 0)


def test_sweep_reduce_keys_matches_repro(jax_ref):
    """``sweep(..., reduce_keys=...)`` on a trace, both packages."""
    jb = j_traces.multicore_batch(["milc_like", "gcc_like"], 400, seed=1)
    tb = t_traces.multicore_batch(["milc_like", "gcc_like"], 400, seed=1)
    jg = [j_sim.SimConfig(mech=j_sim.MechanismConfig(kind=k), policy="closed")
          for k in KINDS]
    tg = [t_sim.SimConfig(mech=t_sim.MechanismConfig(kind=k), policy="closed")
          for k in KINDS]
    want = j_sim.sweep(jb, jg, reduce_keys=REDUCE)
    got = t_sim.sweep(tb, tg, reduce_keys=REDUCE, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="reduce keys"):
        t_sim.sweep(tb, tg, reduce_keys=("bogus",), device="cpu")


def test_simulate_synth_equals_single_point_sweep():
    _, t = _pair("cc_nuat", "xor", 2, "closed", names=("omnetpp_like",
                                                       "hmmer_like",
                                                       "milc_like"))
    one = t_sim.simulate_synth(t, device="cpu")
    grid = [t, _pair("base", "row", 1, names=t.workload.names)[1]]
    swept = t_sim.sweep_synth(grid, device="cpu")[0]
    assert_cell_matches(one, swept, rltl=True)


STREAMED_CASES = {
    "open_1core_bank": dict(kind="chargecache", il="bank", ch=2,
                            policy="open", names=("mcf_like",)),
    "closed_3core_xor": dict(kind="cc_nuat", il="xor", ch=2,
                             policy="closed",
                             names=("mcf_like", "lbm_like", "hmmer_like")),
    "phased_block_16bank": dict(kind="aldram", il="block", ch=2, banks=16,
                                policy="closed", names=MIX,
                                phases=((0.5, ("stream_copy_like",
                                               "omnetpp_like")),)),
    "legacy_row_1ch": dict(kind="rltl", il="row", ch=1, policy="closed",
                           names=MIX, refresh="legacy"),
}


@pytest.mark.parametrize("case", list(STREAMED_CASES))
def test_streamed_equals_materialized(case):
    """Inside the port, bitwise: the streamed path equals the trace
    engine over the materialized stream."""
    t = _pair(**STREAMED_CASES[case], n_req=600)[1]
    streamed = t_sim.simulate_synth(t, device="cpu")
    batch = t_materialize(t.workload, t.dram, t.interleave)
    materialized = t_sim.simulate(batch, t, device="cpu")
    assert_cell_matches(streamed, materialized, rltl=True)
    for k in ("bank_acts", "bank_act_ras_sum"):
        np.testing.assert_array_equal(streamed[k], materialized[k])


def test_synth_grid_errors():
    t = _pair("base")[1]
    with pytest.raises(ValueError, match="workload"):
        t_sim.sweep_synth([t_sim.SimConfig()], device="cpu")
    other = _pair("base", names=("mcf_like",))[1]
    with pytest.raises(ValueError, match="core count"):
        t_sim.sweep_synth([t, other], device="cpu")
    with pytest.raises(ValueError):
        t_sim.simulate_synth(t_sim.SimConfig(), device="cpu")


def test_sweep_synth_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here; the default device works")
    t = _pair("base", n_req=64)[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sim.sweep_synth([t])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sim.simulate_synth(t)


def test_cpu_dispatch_is_the_plain_synth_engine():
    grid = [_pair(k, "xor", n_req=200)[1] for k in ("base", "chargecache")]
    args = t_sim._stage_synth(grid, None, torch.device("cpu"))
    before = ops.synth_launches
    a = ops.run_synth(*args, True, True)
    b = ref.run_synth_ref(*args, True, True)
    assert ops.synth_launches == before
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for k in a[3]:
        assert torch.equal(a[3][k], b[3][k]), k
    with pytest.raises(ValueError, match="CUDA"):
        kernel.sim_synth(*args)


def test_packed_synth_fields_match_the_cuda_source():
    """kernel.py's synthesis field lists equal the ones compiled into the
    kernel (read from the source; checked again on load), and the packed
    rows hold every field at its offset."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "sim_step" / "csrc"
           / "sim_step.cu").read_text()
    abi = "".join(re.findall(r'"([^"]*)"', src.split("kAbi =")[1]
                             .split(";\n")[0]))
    assert abi == kernel.abi_string()
    for enum, fields, last in (("SynthInt", kernel.SYNTH_INT_FIELDS,
                                "N_SYNTH_INT"),
                               ("SynthFloat", kernel.SYNTH_FLOAT_FIELDS,
                                "N_SYNTH_FLOAT")):
        body = src.split(f"enum {enum} {{")[1].split("};")[0]
        assert len(re.findall(r"\bW_\w+", body)) == len(fields)
        assert body.strip().endswith(last)

    grid = [_pair(k, il, ch, names=("mcf_like", "lbm_like", "gcc_like"),
                  phases=((0.5, ("lbm_like",) * 3),) if ch == 1 else (),
                  n_req=100)[1]
            for k in ("base", "chargecache") for il in ("row", "xor")
            for ch in (1, 2)]
    shape, stacked, w, il, warm, C, L, _ = t_sim._stage_synth(
        grid, None, torch.device("cpu"))
    wi, wf, off = kernel.pack_synth(stacked, w, il, warm)
    G, S = len(grid), w.seg_edge.shape[-1]
    assert S == 2 and wi.dtype == torch.int32 and wf.dtype == torch.float32
    io = dict(zip(kernel.SYNTH_INT_FIELDS, off))
    fo = dict(zip(kernel.SYNTH_FLOAT_FIELDS,
                  off[len(kernel.SYNTH_INT_FIELDS):]))
    np.testing.assert_array_equal(wi[:, io["seed"]:io["seed"] + C], w.seed)
    np.testing.assert_array_equal(
        wi[:, io["seg_edge"]:io["seg_edge"] + C * S], w.seg_edge.reshape(G, -1))
    np.testing.assert_array_equal(wi[:, io["il_kind_id"]], il.kind_id)
    np.testing.assert_array_equal(wi[:, io["n_channels"]],
                                  stacked.geom.n_channels)
    np.testing.assert_array_equal(wi[:, io["warmup"]], warm)
    assert io["warmup"] + 1 == wi.shape[1]
    np.testing.assert_array_equal(
        wf[:, fo["stack_geo"]:], w.stack_geo.reshape(G, -1))
    assert fo["stack_geo"] + C * S == wf.shape[1]


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_synth.py)")
    return torch.device("cuda")


def _kernel_vs_plain(grid, device):
    args = t_sim._stage_synth(grid, None, device)
    got = ops.run_synth(*args, True, True)
    want = ref.run_synth_ref(*args, True, True)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1])
    for k in want[3]:
        assert torch.equal(got[3][k], want[3][k]), k
    for f in ("act_gid", "pre1_gid", "pre2_gid", "pre3_gid", "act_ref8"):
        assert torch.equal(getattr(got[2], f), getattr(want[2], f)), f
    for gid_f, t_f in (("act_gid", "act_t"), ("pre1_gid", "pre1_t"),
                       ("pre2_gid", "pre2_t"), ("pre3_gid", "pre3_t")):
        live = getattr(want[2], gid_f) >= 0
        assert torch.equal(getattr(got[2], t_f)[live],
                           getattr(want[2], t_f)[live]), t_f


@pytest.mark.cuda
def test_kernel_matches_plain_synth(cuda):
    _kernel_vs_plain([_pair(k, il, ch, pol, n_req=400,
                            names=("mcf_like", "hmmer_like", "lbm_like"))[1]
                      for k in t_reg.names() for il in ("bank", "xor")
                      for ch in GEOMS for pol in ("open", "closed")], cuda)


def _point_streams(stream: dict, i: int) -> SimpleNamespace:
    """Point ``i`` of a ``[G, C, L]`` stream dict, as host arrays."""
    return SimpleNamespace(**{k: stream[k][i].cpu().numpy()
                              for k in STREAM_FIELDS})


@pytest.mark.cuda
def test_cuda_sweep_synth_matches_cpu(cuda):
    """The card's ``sweep_synth`` against the CPU's under the stream
    rule: CUDA's float32 ``log1pf``/``expf`` may sit an ulp from
    PyTorch-CPU's, so each point's two streams are compared first."""
    grid = [_pair(k, "row", 2, "closed", n_req=300,
                  phases=((0.5, ("gcc_like", "stream_copy_like")),))[1]
            for k in ("base", "chargecache", "cc_aldram")]
    before = ops.synth_launches
    on_card = t_sim.sweep_synth(grid)
    assert ops.synth_launches == before + 1
    on_cpu = t_sim.sweep_synth(grid, device="cpu")
    # the streams alone: a launch of 0 scan steps still generates them
    streams = [ops.run_synth(*t_sim._stage_synth(grid, None, dev)[:7], 0,
                             False, True)[3]
               for dev in (cuda, torch.device("cpu"))]
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        n = assert_streams_under_rule(*(_point_streams(s, i)
                                        for s in streams))
        assert_stats_under_rule(b, a, n == 0)
