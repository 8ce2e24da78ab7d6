"""The port's roofline terms and kernel work formulas
(``repro_torch.analysis.roofline``):

* ``roofline()`` and ``model_flops()`` equal ``repro.analysis.roofline``'s
  exactly, for every config x shape, once ``repro``'s v5e constants are
  monkeypatched into the port's module;
* the H100 constants are the data sheet's, and the ones ``chip_smoke.py``
  prints its bounds with;
* the kernel formulas that moved from ``chip_smoke.py`` give the bounds
  PERF.md section 6 prints (flash at S 4 096, the RG-LRU backward,
  ssm_scan at falcon-mamba-7b's chunk, tinyllama-1.1b's train step);
  ``valid_pairs``' closed form equals the brute-force mask count.
"""

import importlib.util
import itertools
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import roofline as j_rl  # noqa: E402
from repro.configs import get as j_get  # noqa: E402
from repro.models.config import SHAPES as J_SHAPES  # noqa: E402

from repro_torch.analysis import roofline as t_rl  # noqa: E402
from repro_torch.configs import ALIASES  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.models.config import SHAPES as T_SHAPES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: per-device counts, one bound each: compute, memory, collective, and
#: an ``hlo.analyze`` dict without ``bytes_min``
PER_DEVICE = [
    {"flops": 3.1e15, "bytes": 9e11, "bytes_min": 4e11,
     "collective_total": 2e9},
    {"flops": 2.0e12, "bytes": 9e11, "bytes_min": 6e11,
     "collective_total": 1e9},
    {"flops": 1.0e12, "bytes": 1e10, "bytes_min": 5e9,
     "collective_total": 8e11},
    {"flops": 0.0, "bytes": 1e9, "collective_total": 0.0},
]


@pytest.fixture
def v5e(monkeypatch):
    """``repro``'s TPU v5e constants in the port's module."""
    monkeypatch.setattr(t_rl, "PEAK_FLOPS", j_rl.PEAK_FLOPS)
    monkeypatch.setattr(t_rl, "HBM_BW", j_rl.HBM_BW)
    monkeypatch.setattr(t_rl, "NVLINK_LINK_BW", j_rl.ICI_LINK_BW)
    monkeypatch.setattr(t_rl, "NVLINK_LINKS", j_rl.ICI_LINKS)


@pytest.mark.parametrize("name", list(ALIASES))
def test_roofline_and_model_flops_match_repro(name, v5e):
    tcfg, jcfg = t_get(name), j_get(name)
    for shape, n_dev in itertools.product(T_SHAPES, (256, 512)):
        mf = t_rl.model_flops(tcfg, T_SHAPES[shape], n_dev)
        assert mf == j_rl.model_flops(jcfg, J_SHAPES[shape], n_dev), shape
        for per in PER_DEVICE:
            got = t_rl.roofline(per, mf).table_row()
            assert got == j_rl.roofline(per, mf).table_row(), (shape, per)
            assert t_rl.roofline(per, mf, n_links=2).table_row() == \
                j_rl.roofline(per, mf, n_links=2).table_row()
    bounds = {t_rl.roofline(p).bound for p in PER_DEVICE}
    assert bounds == {"compute", "memory", "collective"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_h100_constants_are_the_data_sheets_and_chip_smokes():
    assert t_rl.PEAK_FLOPS == 989e12 and t_rl.HBM_BW == 3.35e12
    assert t_rl.HBM_BYTES == 80e9
    assert (t_rl.NVLINK_LINKS, t_rl.NVLINK_LINK_BW) == (18, 25e9)
    assert t_rl.NVLINK_LINKS * t_rl.NVLINK_LINK_BW * 2 == 900e9
    cs = _chip_smoke()
    assert cs.HBM_BYTES_PER_S == t_rl.HBM_BW
    assert cs.PEAK_OPS == {"bf16": t_rl.PEAK_FLOPS, "f32": 67e12}
    # one copy of the formulas: chip_smoke's names are the module's
    for name in ("bound_of", "flash_bound", "decode_bound",
                 "flash_bwd_bound", "bwd_entry_bounds", "scan_bound_ms",
                 "ssm_bwd_bound", "rglru_bwd_bound", "train_flops"):
        assert getattr(cs, name) is getattr(t_rl, name), name


def test_bounds_perf_md_prints():
    """PERF.md section 6's bounds, from the moved formulas."""
    ms, by = t_rl.flash_bound(1, 4096, 32, 4, 64, True, 0, "bf16")
    assert (round(ms, 4), by) == (0.0695, "operations")
    ops, _ = t_rl.flash_work(1, 4096, 32, 4, 64, True, 0, "bf16")
    assert round(ops / 1e9, 1) == 68.7          # "68.7 GFLOP"
    ms, by = t_rl.flash_bound(4, 500, 32, 4, 64, True, 0, "bf16")
    assert (round(ms, 4), by) == (0.0055, "bytes")
    ms, by = t_rl.rglru_bwd_bound(2, 2048, 2560)
    assert (round(ms, 4), by) == (0.0626, "bytes")
    assert round(t_rl.rglru_work(2, 2048, 2560)[1] / 1e6, 1) == 104.9
    assert round(t_rl.scan_bound_ms(4, 256, 8192, 16), 4) == 0.3318
    assert round(t_rl.ssm_bwd_bound(2, 256, 8192, 16)[0], 4) == 0.3315
    # phase 24 (e)'s "7.46e+13 operations" for tinyllama-1.1b B 4 x 2 048
    flops = t_rl.train_flops(t_get("tinyllama-1.1b"), 4, 2048)
    assert flops == 74604353683456.0
    assert f"{flops:.3g}" == "7.46e+13"


@pytest.mark.parametrize("S,Skv,causal,window", [
    (1, 1, True, 0), (7, 7, True, 0), (64, 64, True, 16), (50, 50, False, 8),
    (33, 70, False, 0), (96, 96, True, 96), (128, 128, True, 200),
    (300, 300, False, 300)])
def test_valid_pairs_closed_form_matches_the_mask(S, Skv, causal, window):
    q = torch.arange(S)[:, None]
    k = torch.arange(Skv)[None, :]
    ok = torch.ones(S, Skv, dtype=torch.bool)
    if causal:
        ok &= q >= k
    if window:
        ok &= (q - k) < window
    assert t_rl.valid_pairs(S, Skv, causal, window) == int(ok.sum())
