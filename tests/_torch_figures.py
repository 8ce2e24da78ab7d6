"""Shared set-up of the figure tests: the thesis's five figure scripts of
the port (``repro_torch.figures``) against ``repro``'s own
(``benchmarks/``) at a reduced size — three single-core workloads of
2 000 requests, two eight-core mixes of 500 requests a core — on the
same numpy-seeded traces."""

import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from repro_torch import golden
from repro_torch.figures import common as C

from _parity import assert_cell_matches

ROOT = Path(__file__).resolve().parents[1]
SINGLES = ("milc_like", "lbm_like", "mcf_like")
SIZES = C.Sizes(n_req_1c=2000, n_req_8c=500, n_mixes=2, n_sub_mixes=5,
                singles=SINGLES)


def repro_benchmarks():
    """``benchmarks.common`` (the JAX package's harness), importable from
    the root of the checkout; ``None`` where JAX is not installed."""
    try:
        import jax  # noqa: F401
    except ImportError:
        return None
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import common
    return common


@contextmanager
def repro_sizes(jc, sizes: C.Sizes = SIZES):
    """``benchmarks.common`` resized to ``sizes`` (its module globals, read
    at call time), restored on exit; the traces are checked equal to the
    port's."""
    saved = {k: getattr(jc, k) for k in ("N_REQ_1C", "N_REQ_8C",
                                          "SINGLE_NAMES", "N_MIXES", "QUICK")}
    jc.N_REQ_1C, jc.N_REQ_8C = sizes.n_req_1c, sizes.n_req_8c
    jc.SINGLE_NAMES, jc.N_MIXES = list(sizes.singles), sizes.n_mixes
    jc.QUICK = False
    try:
        for name in sizes.singles:
            assert golden.trace_sha256(jc._single_batch(
                name, sizes.n_req_1c, sizes.seed)) == golden.trace_sha256(
                C.single_batch(name, sizes.n_req_1c, sizes.seed))
        mixes = jc.eight_core_mixes()
        assert mixes == sizes.mixes()
        for m in mixes:
            assert golden.trace_sha256(jc._mix_batch(
                tuple(m), sizes.n_req_8c, sizes.seed)) == golden.trace_sha256(
                C.mix_batch(tuple(m), sizes.n_req_8c, sizes.seed))
        yield
    finally:
        for k, v in saved.items():
            setattr(jc, k, v)


def fields(rows):
    """CSV rows without their wall-time field: ``(name, derived)``."""
    out = []
    for r in rows:
        name, _, derived = r.split(",", 2)
        out.append((name, derived))
    return out


def assert_results_equal(jres, tres, rltl: bool = False):
    """Two ``Results`` grids equal cell for cell (bitwise stats, core_end,
    per-bank accumulators; RLTL histograms with ``rltl``)."""
    assert tres.dims == jres.dims and tres.coords == jres.coords
    for j, t in zip(jres.cells.flat, tres.cells.flat):
        assert_cell_matches(j, t, rltl=rltl)
        for k in ("bank_acts", "bank_act_ras_sum"):
            np.testing.assert_array_equal(np.asarray(j[k]), t[k])
