"""The comparison rule for synthetic streams and their stats between the
PyTorch port and ``repro``.

Both generators are exact integer arithmetic except two float32 draws
that go through ``log1p`` / ``exp`` (the hot-set rank and the gap).
XLA's and PyTorch's float32 transcendentals differ by about one ulp, so
where such a value lands within an ulp of an integer the two packages
can draw another rank or gap.  Hence:

* ``is_write`` and ``dep`` are always bitwise equal;
* if the streams are equal, every stat, ``core_end``, bank array and the
  RLTL histogram must be bitwise equal;
* if not, at most ``MAX_DIFF_FRACTION`` of the positions may differ, and
  the stats must agree within the tolerances ``tests/test_workloads.py``
  holds the generator to (``repro_torch.golden.STAT_TOLERANCE``:
  row-hit rate +-0.08, total cycles +-7 %, HCRAC hit rate +-0.08, RLTL
  0.125 ms CDF point +-0.08), which ``chip_smoke.py`` applies too.

Tests never choose seeds to avoid a difference.
"""

import numpy as np

from _parity import assert_cell_matches
from repro_torch.golden import tolerance_violations

STREAM_FIELDS = ("gap", "bank", "row", "is_write", "dep", "next_same",
                 "length")
MAX_DIFF_FRACTION = 1e-3


def stream_diff(a, b) -> int:
    """Positions at which two padded ``TraceBatch`` streams differ (any
    field); raises if ``is_write``/``dep``/``length`` differ at all."""
    for f in ("is_write", "dep", "length"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    differ = np.zeros(np.asarray(a.gap).shape, bool)
    for f in STREAM_FIELDS[:-1]:
        differ |= np.asarray(getattr(a, f)) != np.asarray(getattr(b, f))
    return int(differ.sum())


def assert_streams_under_rule(a, b) -> int:
    """Apply the stream half of the rule; returns the differing count
    (printed, so ``pytest -s`` shows the observed counts)."""
    n = stream_diff(a, b)
    total = int(np.asarray(a.length).sum())
    print(f"streams differ in {n} of {total} positions")
    assert n <= MAX_DIFF_FRACTION * total, (n, total)
    return n


def assert_stats_under_rule(j: dict, t: dict, streams_equal: bool) -> None:
    """Hold the port's stats ``t`` to ``repro``'s ``j``."""
    if streams_equal:
        assert_cell_matches(j, t, rltl=j["rltl_hist"] is not None)
        for k in ("bank_acts", "bank_act_ras_sum"):
            np.testing.assert_array_equal(j[k], t[k])
        return
    assert not tolerance_violations(t, j), tolerance_violations(t, j)
