"""The port's workload generator against ``repro.workloads``.

The counter-based PRNG, the interleave layer and the profile leaves are
integer or exactly rounded arithmetic and must match bitwise.  The
generated streams follow the rule of ``tests/_torch_streams.py``:
bitwise, except where a float32 ``log1p``/``exp`` result lands within an
ulp of an integer (XLA and PyTorch differ by about an ulp there).  Both
packages get the same numpy-made inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dram as j_dram  # noqa: E402
from repro.core import traces as j_traces  # noqa: E402
from repro.workloads import generate as j_generate  # noqa: E402
from repro.workloads import materialize as j_materialize  # noqa: E402
from repro.workloads import prng as j_prng  # noqa: E402
from repro.workloads import spec_params as j_spec_params  # noqa: E402

from repro_torch.core import dram as t_dram  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402
from repro_torch.workloads import generate as t_generate  # noqa: E402
from repro_torch.workloads import materialize as t_materialize  # noqa: E402
from repro_torch.workloads import prng as t_prng  # noqa: E402
from repro_torch.workloads import profiles as t_profiles  # noqa: E402
from repro_torch.workloads import spec_params as t_spec_params  # noqa: E402

from _torch_streams import assert_streams_under_rule  # noqa: E402

RNG = np.random.default_rng(1234)
GEOMS = ((1, 8), (2, 8), (2, 16), (1, 4))   # channels x banks per rank


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ PRNG

WORD_SETS = {
    "negative_seeds": (RNG.integers(-2**31, 2**31, 300, dtype=np.int32),
                       np.int32(3), 0x9E3779B9, np.arange(300, dtype=np.int32)),
    "big_lanes": (np.int32(-1), np.int32(7), *j_prng.lanes(14)[9:],
                  RNG.integers(0, 2**31, 300, dtype=np.int32)),
    "extremes": (np.array([0, 1, -1, 2**31 - 1, -2**31], np.int32),
                 0xFFFF_FFFF, np.int32(0)),
}


@pytest.mark.parametrize("name", list(WORD_SETS))
def test_hash_u32_bitwise(name):
    words = WORD_SETS[name]
    want = np.asarray(j_prng.hash_u32(jnp, *words))
    got = t_prng.hash_u32(*(w if isinstance(w, int) else _t(np.asarray(w))
                            for w in words))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_uniform_and_lanes_bitwise():
    assert t_prng.lanes(14) == j_prng.lanes(14)
    seeds = RNG.integers(-2**31, 2**31, 64, dtype=np.int32)
    steps = np.arange(4096, dtype=np.int32)
    want = np.asarray(j_prng.uniform(jnp, seeds[:, None], np.int32(5),
                                     j_prng.lanes(14)[3], steps[None]))
    got = t_prng.uniform(_t(seeds)[:, None], torch.tensor(5, dtype=torch.int32),
                         t_prng.lanes(14)[3], _t(steps)[None]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------------------------------ interleave layer

@pytest.mark.parametrize("kind", j_dram.INTERLEAVE_KINDS)
def test_compose_address_bitwise(kind):
    assert t_dram.INTERLEAVE_KINDS == j_dram.INTERLEAVE_KINDS
    for ch, nb in GEOMS:
        for block in (1, 32, 77):
            jd = j_dram.DRAMConfig(n_channels=ch, n_banks=nb)
            td = t_dram.DRAMConfig(n_channels=ch, n_banks=nb)
            lb = RNG.integers(0, jd.banks_total, 2000, dtype=np.int32)
            row = RNG.integers(0, jd.n_rows, 2000, dtype=np.int32)
            want = np.asarray(j_dram.compose_address(
                j_dram.geom_params(jd), j_dram.interleave_params(
                    j_dram.InterleaveConfig(kind, block)), lb, row))
            got = t_dram.compose_address(
                t_dram.geom_params(td), t_dram.interleave_params(
                    t_dram.InterleaveConfig(kind, block)), _t(lb), _t(row))
            np.testing.assert_array_equal(got.numpy(), want)
            assert ((0 <= want) & (want < jd.banks_total)).all()


# ------------------------------------------------------- profile leaves

SPECS = {
    "stationary": dict(names=("mcf_like", "hmmer_like", "lbm_like"),
                       n_req=1000, seed=-11),
    "phased": dict(names=("milc_like", "stream_copy_like"), n_req=900,
                   seed=4, phases=((0.25, ("mcf_like", "gcc_like")),
                                   (0.6, ("lbm_like", "omnetpp_like")))),
}


@pytest.mark.parametrize("name,n_segs", [("stationary", None),
                                         ("stationary", 3),
                                         ("phased", None), ("phased", 5)])
def test_spec_params_leaves_bitwise(name, n_segs):
    want = j_spec_params(j_traces.WorkloadSpec(**SPECS[name]), n_segs=n_segs)
    got = t_spec_params(t_traces.WorkloadSpec(**SPECS[name]), n_segs=n_segs)
    assert got._fields == want._fields
    for f, a, b in zip(want._fields, want, got):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32),
                                      err_msg=f)
    if n_segs == 5:   # padded segments never start
        assert (got.seg_edge[:, 3:] == t_profiles._EDGE_INF).all()
    assert t_profiles.n_segs_of([t_traces.WorkloadSpec(**SPECS[name])]) \
        == 1 + len(SPECS[name].get("phases", ()))


# ------------------------------------------------------------ generator

STREAMS = {
    # mcf_like's Zipf exponent 1.08 sends exp() to inf in the rank tail
    "mcf_xor_2ch": (dict(names=("mcf_like", "omnetpp_like"), n_req=2000,
                         seed=-5), "xor", (2, 8)),
    # hmmer_like issues 1 % of its share: a 20-request stream
    "hmmer_mix_block_1ch": (dict(names=("hmmer_like", "milc_like",
                                        "tpcc64_like"), n_req=2000, seed=3),
                            "block", (1, 8)),
    "phased_row_16bank": (SPECS["phased"], "row", (2, 16)),
    "stream_bank_4bank": (dict(names=("stream_copy_like",), n_req=2000,
                               seed=2**31 - 1), "bank", (1, 4)),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_materialize_matches_repro(name):
    spec, kind, (ch, nb) = STREAMS[name]
    want = j_materialize(j_traces.WorkloadSpec(**spec),
                         j_dram.DRAMConfig(n_channels=ch, n_banks=nb),
                         j_dram.InterleaveConfig(kind))
    got = t_materialize(t_traces.WorkloadSpec(**spec),
                        t_dram.DRAMConfig(n_channels=ch, n_banks=nb),
                        t_dram.InterleaveConfig(kind))
    for f in want._fields:
        assert np.asarray(getattr(want, f)).dtype == getattr(got, f).dtype
        assert np.asarray(getattr(want, f)).shape == getattr(got, f).shape
    assert_streams_under_rule(want, got)


def test_generate_trace_dict_matches_repro():
    """``generate`` itself (the trace dict the engine reads), on the
    stationary spec, both packages."""
    jspec = j_traces.WorkloadSpec(**SPECS["stationary"])
    tspec = t_traces.WorkloadSpec(**SPECS["stationary"])
    jd, td = j_dram.DRAMConfig(), t_dram.DRAMConfig()
    il = "xor"
    want = j_generate(jspec.n_cores, jspec.max_len, j_spec_params(jspec),
                      j_dram.geom_params(jd),
                      j_dram.interleave_params(j_dram.InterleaveConfig(il)))
    got = t_generate(tspec.n_cores, tspec.max_len, t_spec_params(tspec),
                     t_dram.geom_params(td),
                     t_dram.interleave_params(t_dram.InterleaveConfig(il)))
    assert set(got) == set(want)
    for k in ("is_write", "dep", "length"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    n = sum(int((got[k].numpy() != np.asarray(want[k])).sum())
            for k in ("gap", "bank", "row"))
    assert n <= 1e-3 * int(np.asarray(want["length"]).sum())


def test_batch_invariance():
    """A ``[G]`` grid of points generated together equals each point
    generated alone, bitwise (the counter-based contract)."""
    specs = [t_traces.WorkloadSpec(names=("mcf_like", "lbm_like"),
                                   n_req=500, seed=s) for s in (0, -9, 77)]
    geoms = [t_dram.DRAMConfig(n_channels=c) for c in (2, 1, 2)]
    ils = [t_dram.InterleaveConfig(k) for k in ("xor", "row", "block")]
    S = 1
    stack = lambda trees: type(trees[0])(*(torch.stack(x)
                                           for x in zip(*trees)))
    w = stack([t_spec_params(s, n_segs=S) for s in specs])
    g = stack([t_dram.geom_params(d) for d in geoms])
    il = stack([t_dram.interleave_params(i) for i in ils])
    together = t_generate(2, specs[0].max_len, w, g, il)
    for i in range(3):
        alone = t_generate(2, specs[i].max_len, t_spec_params(specs[i]),
                           t_dram.geom_params(geoms[i]),
                           t_dram.interleave_params(ils[i]))
        for k, v in alone.items():
            assert torch.equal(together[k][i], v), (i, k)


def test_generate_rejects_bad_shapes():
    spec = t_traces.WorkloadSpec(names=("mcf_like",), n_req=64)
    with pytest.raises(ValueError):
        t_generate(2, spec.max_len, t_spec_params(spec),
                   t_dram.geom_params(t_dram.DRAMConfig()),
                   t_dram.interleave_params(t_dram.InterleaveConfig()))
    with pytest.raises(ValueError, match="interleave"):
        t_dram.InterleaveConfig("diagonal")
