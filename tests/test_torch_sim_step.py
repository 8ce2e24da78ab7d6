"""The ``sim_step`` kernel tier of the PyTorch port.

Three groups:

* the port imports nothing of JAX or of ``repro`` (an AST scan of every
  module and of ``chip_smoke.py``);
* CPU-side checks of the dispatch: the package imports without CUDA or
  ``nvcc``, the entry points refuse to fall back to the CPU, a registry
  the kernel does not carry is refused, the Python and CUDA sides agree
  on the packed-params layout and on which fields the kernel divides by,
  and a divisor that is not positive is refused;
* the kernel's divider (``kernels/include/floor_div.cuh``): a Python
  mirror of its multiplier and shift, and the header built as host C++
  where ``g++`` exists, both held to Python's ``//`` and ``%``;
* the CUDA kernel against its plain version, marked ``cuda``: these skip
  where no CUDA device exists and run on the card with
  ``python -m pytest -m cuda tests/test_torch_sim_step.py``.
"""

import ast
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import mechanisms as registry  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core import timing, traces  # noqa: E402
from repro_torch.core.dram import DRAMConfig  # noqa: E402
from repro_torch.kernels.sim_step import kernel, ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, m)


def _inputs(batch, grid, device="cpu", pad_steps=False):
    return sim._stage(batch, grid, torch.device(device), pad_steps) + (True,)


def _grid():
    return [sim.SimConfig(dram=DRAMConfig(n_channels=c),
                          mech=sim.MechanismConfig(kind=k), policy=pol)
            for c in (1, 2) for k in registry.names()
            for pol in ("open", "closed")]


# ------------------------------------------------------------- CPU side

def test_import_needs_no_cuda_and_builds_nothing(tmp_path):
    """Every module of the package imports in a process that sees no
    CUDA device and no ``nvcc``, and importing compiles nothing."""
    import os
    import subprocess
    import sys
    code = (
        "import importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels.sim_step import kernel\n"
        "assert kernel.library.cache_info().currsize == 0\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", CUDA_HOME=str(tmp_path),
               PATH=os.path.dirname(sys.executable),
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here; the default device works")
    batch = traces.single_core_batch("milc_like", 64, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.sweep(batch, [sim.SimConfig()])
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.simulate(batch, sim.SimConfig())
    assert sim.sweep(batch, [sim.SimConfig()], device="cpu")[0]["n_req"] > 0


def test_kernel_refuses_cpu_tensors():
    args = _inputs(traces.single_core_batch("mcf_like", 64, seed=0),
                   _grid()[:2])
    with pytest.raises(ValueError, match="CUDA"):
        kernel.sim_step(*args)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_ops_refuses_policies_without_a_kernel_body():
    """A registry whose block-bearing policies differ from the builtin set
    has no CUDA body: ``run_sweep`` refuses it on every device."""
    args = _inputs(traces.single_core_batch("mcf_like", 64, seed=0),
                   _grid()[:2])
    ops.check_registry()
    with registry.temporary():
        @registry.register_mechanism("probe_policy")
        class Probe(registry.MechanismPolicy):
            def block(self, mech, timing, enabled, hints):
                return {"enable": torch.tensor(bool(enabled))}

        with pytest.raises(NotImplementedError, match="probe_policy"):
            ops.run_sweep(*args)
    ops.check_registry()


def test_cpu_dispatch_is_the_plain_engine():
    args = _inputs(traces.single_core_batch("lbm_like", 300, seed=3),
                   _grid())
    before = ops.launches
    a = ops.run_sweep(*args)
    b = ref.run_sweep_ref(*args)
    assert ops.launches == before
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


def test_abi_and_packed_layout_match_the_cuda_source():
    """kernel.py's field and size lists equal the ones compiled into the
    kernel (read from the source here; checked again on load), and the
    packed row holds every field at its offset."""
    src = (PORT / "kernels" / "sim_step" / "csrc" / "sim_step.cu").read_text()
    abi = "".join(re.findall(r'"([^"]*)"', src.split("kAbi =")[1]
                             .split(";\n")[0]))
    assert abi == f"fields:{','.join(kernel.FIELDS)};dims:" \
        f"{','.join(kernel.DIMS)};synth_int:" \
        f"{','.join(kernel.SYNTH_INT_FIELDS)};synth_float:" \
        f"{','.join(kernel.SYNTH_FLOAT_FIELDS)}"
    assert abi == kernel.abi_string()
    # every entry's fields, then the window entry's own
    enum = src.split("enum Field {")[1].split("};")[0]
    win = src.split("enum WinField {")[1].split("};")[0]
    assert len(re.findall(r"\bF_\w+", enum + win)) == len(kernel.FIELDS)
    assert enum.strip().endswith("N_FIELDS")
    assert win.strip().endswith("N_WIN_FIELDS")

    ramp = sim.MechanismConfig(kind="cc_aldram", thermal=sim.aldram_lib
                               .ThermalConfig(((0.0, 55.0), (0.02, 70.0))))
    grid = _grid() + [sim.SimConfig(mech=ramp, dram=DRAMConfig(n_banks=16))]
    _, stacked, _, _, ns_idx, *_ = _inputs(
        traces.single_core_batch("mcf_like", 64, seed=0), grid)
    params, leak, offsets = kernel.pack(stacked, ns_idx)
    G = len(grid)
    assert params.dtype == torch.int32 and params.shape[0] == G
    assert leak.shape == (G, 2) and leak.dtype == torch.float32
    at = dict(zip(kernel.FIELDS, offsets))
    np.testing.assert_array_equal(params[:, at["tRCD"]],
                                  stacked.timing.tRCD)
    nb = stacked.mech["aldram"]["rcd"].shape[1]
    np.testing.assert_array_equal(
        params[:, at["al_seg_ras"]:at["al_seg_ras"] + 2 * nb],
        stacked.mech["aldram"]["seg_ras"].reshape(G, -1))
    np.testing.assert_array_equal(params[:, at["hc_gate"]],
                                  registry.hcrac_gate(stacked.mech))
    assert at["th_seg_edge"] + 2 == at["tRRD"]
    # the FR-FCFS tier's fields close the row
    for f, want in (("tRRD", stacked.timing.tRRD),
                    ("tFAW", stacked.timing.tFAW),
                    ("n_banks", stacked.geom.n_banks),
                    ("frfcfs", stacked.frfcfs),
                    ("win_cap", stacked.win_cap)):
        np.testing.assert_array_equal(params[:, at[f]], want.to(torch.int32))
    assert at["win_cap"] + 1 == params.shape[1]


def test_divisor_fields_are_the_ones_the_kernel_divides_by():
    """Every packed field the kernel builds a ``FloorDiv`` from is in
    ``DIVISOR_FIELDS`` (or ``SERVE_DIVISOR_FIELDS``), so ``pack`` refuses
    each one that is not positive, and no other."""
    src = (PORT / "kernels" / "sim_step" / "csrc" / "sim_step.cu").read_text()
    enum = [f for part in ("enum Field {", "enum WinField {")
            for f in re.findall(r"\bF_\w+", src.split(part)[1]
                                .split("};")[0])]
    serve = re.findall(r"\bV_\w+", src.split("enum ServeField {")[1]
                       .split("};")[0])[:-1]
    made = set(re.findall(r"FloorDiv::make\((?:prm\[off\[|sv\[)(\w+)\]",
                          src))
    assert made == ({enum[kernel.FIELDS.index(f)]
                     for f in kernel.DIVISOR_FIELDS}
                    | {serve[kernel.SERVE_FIELDS.index(f)]
                       for f in kernel.SERVE_DIVISOR_FIELDS})
    # every other division in the scan's request loop is gone
    scan = src.split("struct Hcrac {")[1].split("struct Stage {")[0]
    assert not re.search(r"\bfloor(div|mod)\(", scan)


#: where ``pack`` reads each divisor from a stacked grid
_DIVISOR_SOURCES = {
    "tREFI": ("timing", "tREFI"),
    "n_refresh_groups": ("timing", "n_refresh_groups"),
    "retention_cycles": ("timing", "retention_cycles"),
    "banks_total": ("geom", "banks_total"),
    "banks_per_channel": ("geom", "banks_per_channel"),
    "n_rows": ("geom", "n_rows"),
    "hc_n_sets": ("hcrac", "n_sets"),
    "hc_caching_cycles": ("hcrac", "caching_cycles"),
    "n_banks": ("geom", "n_banks"),
}


@pytest.mark.parametrize("value", (0, -3))
@pytest.mark.parametrize("field", kernel.DIVISOR_FIELDS)
def test_pack_refuses_a_divisor_that_is_not_positive(field, value):
    _, stacked, _, _, ns_idx, *_ = _inputs(
        traces.single_core_batch("mcf_like", 64, seed=0), _grid()[:3])
    kernel.pack(stacked, ns_idx)
    group, name = _DIVISOR_SOURCES[field]
    part = getattr(stacked, group)
    bad = getattr(part, name).clone()
    bad[1] = value
    stacked = stacked._replace(**{group: part._replace(**{name: bad})})
    with pytest.raises(ValueError, match=rf"{field} must be positive"):
        kernel.pack(stacked, ns_idx)


@pytest.mark.parametrize("field", ("n_sets", "caching_cycles"))
def test_pack_serve_refuses_a_hot_divisor_that_is_not_positive(field):
    from repro_torch.serving.loop import engine
    from repro_torch.serving.loop.spec import ServingSpec
    grid = [sim.SimConfig(serving=ServingSpec(n_reqs=16, n_steps=8))] * 2
    _, params, warm = engine.stage_serving(grid, device=torch.device("cpu"))
    kernel.pack_serve(params, warm)
    bad = getattr(params.hot, field).clone()
    bad[0] = 0
    params = params._replace(hot=params.hot._replace(**{field: bad}))
    with pytest.raises(ValueError, match=rf"hot_{field} must be positive"):
        kernel.pack_serve(params, warm)


def test_pack_serve_refuses_page_tokens_that_are_not_positive():
    """The scheduler grows a request's pages by a divider of page_tokens."""
    from repro_torch.serving.loop import engine
    from repro_torch.serving.loop.spec import ServingSpec
    grid = [sim.SimConfig(serving=ServingSpec(n_reqs=16, n_steps=8))] * 2
    _, params, warm = engine.stage_serving(grid, device=torch.device("cpu"))
    bad = params.page_tokens.clone()
    bad[1] = 0
    with pytest.raises(ValueError, match="page_tokens must be positive"):
        kernel.pack_serve(params._replace(page_tokens=bad), warm)


@pytest.mark.parametrize("d", (0, -1, 2**31))
def test_floor_div_refuses_a_divisor_out_of_range(d):
    with pytest.raises(ValueError, match="positive int32 divisor"):
        kernel.floor_div(torch.zeros(4, dtype=torch.int32), d)


# ------------------------------------------------------ the divider

I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _phase_divisors():
    """tREFI, retention and the HCRAC caching durations of chip_smoke's
    full-size points (phases 3-5): the default timing, 0.5-16 ms."""
    t = timing.TimingParams()
    return ([t.tREFI, t.retention_cycles]
            + [timing.ms_to_cycles(ms) for ms in (0.5, 1.0, 2.0, 4.0, 16.0)])


DIVISORS = (1, 2, 3, 7, 8, 2**30, 2**31 - 1, *_phase_divisors())


def _magic(d):
    """The divider's multiplier and shift (``FloorDiv::make``)."""
    ceil_log2 = (d - 1).bit_length()
    s = 31 + ceil_log2
    return -(-(1 << s) // d), s


def _mirror(a: np.ndarray, d: int) -> tuple[np.ndarray, np.ndarray]:
    """``FloorDiv::div`` / ``mod`` over an int32 array, step by step:
    fold the sign (u = a ^ (a >> 31) < 2**31), multiply-shift, unfold,
    remainder in wrapping uint32."""
    m, s = _magic(d)
    sgn = (a.astype(np.int64) >> 31).astype(np.uint32)  # 0 or 0xffffffff
    u = a.astype(np.uint32) ^ sgn
    q = ((u.astype(np.uint64) * np.uint64(m)) >> np.uint64(s)).astype(
        np.uint32) ^ sgn
    r = a.astype(np.uint32) - q * np.uint32(d)
    return q.view(np.int32), r.view(np.int32)


def _dividends(d: int, n_random: int = 1 << 16) -> np.ndarray:
    """Edge dividends (the int32 extremes, -1, 0, 1, multiples of ``d``
    near 0 and near both extremes, each +- 1) and a seeded sample."""
    near = [k * d + e for k in range(-3, 4) for e in (-1, 0, 1)]
    ext = [(I32_MIN // d + k) * d + e for k in range(0, 3) for e in (-1, 0, 1)]
    ext += [(I32_MAX // d - k) * d + e for k in range(0, 3) for e in (-1, 0, 1)]
    edges = [I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1, I32_MAX]
    vals = [v for v in edges + near + ext if I32_MIN <= v <= I32_MAX]
    rng = np.random.default_rng(d % (2**32))
    sample = rng.integers(I32_MIN, I32_MAX, n_random, dtype=np.int64,
                          endpoint=True)
    return np.concatenate([np.array(vals, np.int64), sample]).astype(np.int32)


@pytest.mark.parametrize("d", DIVISORS)
def test_divider_mirror_equals_floor_division(d):
    m, s = _magic(d)
    # Granlund-Montgomery's condition for 31-bit operands, and m fits
    ceil_log2 = s - 31
    assert 2**s <= m * d <= 2**s + 2**ceil_log2 and m < 2**32
    a = _dividends(d)
    q, r = _mirror(a, d)
    a64 = a.astype(np.int64)
    np.testing.assert_array_equal(q, a64 // d)
    np.testing.assert_array_equal(r, a64 % d)
    # the CPU path of the wrapper is PyTorch's floor division
    tq, tr = kernel.floor_div(torch.from_numpy(a), d)
    np.testing.assert_array_equal(tq.numpy(), a64 // d)
    np.testing.assert_array_equal(tr.numpy(), a64 % d)


_HOST_MAIN = r"""
#include <cstdio>
#include "floor_div.cuh"
int main() {
  int d, n;
  while (std::scanf("%d %d", &d, &n) == 2) {
    const FloorDiv f = FloorDiv::make(d);
    for (int i = 0; i < n; ++i) {
      int a;
      if (std::scanf("%d", &a) != 1) return 1;
      std::printf("%d %d\n", f.div(a), f.mod(a));
    }
  }
  return 0;
}
"""


def test_divider_header_built_as_host_cpp(tmp_path):
    """``floor_div.cuh`` compiled by the host compiler (it is plain C++
    outside nvcc) divides every divisor's dividends as ``//`` and ``%``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on PATH to build floor_div.cuh as host C++")
    (tmp_path / "main.cc").write_text(_HOST_MAIN)
    exe = tmp_path / "floor_div_host"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Werror",
                    f"-I{PORT / 'kernels' / 'include'}", "-o", str(exe),
                    str(tmp_path / "main.cc")], check=True, timeout=120)
    cases = {d: _dividends(d, 1 << 12) for d in DIVISORS}
    feed = "".join(f"{d} {a.size}\n" + " ".join(map(str, a.tolist())) + "\n"
                   for d, a in cases.items())
    out = subprocess.run([str(exe)], input=feed, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split()
    got = np.array(out, dtype=np.int64).reshape(-1, 2)
    want = np.concatenate([np.stack([a.astype(np.int64) // d,
                                     a.astype(np.int64) % d], axis=1)
                           for d, a in cases.items()])
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_sim_step.py)")
    return torch.device("cuda")


def _assert_kernel_matches_plain(args):
    got = ops.run_sweep(*args)
    want = ref.run_sweep_ref(*args)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1])
    for f in ("act_gid", "pre1_gid", "pre2_gid", "pre3_gid", "act_ref8"):
        assert torch.equal(getattr(got[2], f), getattr(want[2], f)), f
    for gid_f, t_f in (("act_gid", "act_t"), ("pre1_gid", "pre1_t"),
                       ("pre2_gid", "pre2_t"), ("pre3_gid", "pre3_t")):
        live = getattr(want[2], gid_f) >= 0
        assert torch.equal(getattr(got[2], t_f)[live],
                           getattr(want[2], t_f)[live]), t_f


@pytest.mark.cuda
def test_kernel_matches_plain_every_kind(cuda):
    _assert_kernel_matches_plain(_inputs(
        traces.single_core_batch("milc_like", 1400, seed=5), _grid(), cuda))


@pytest.mark.cuda
def test_kernel_matches_plain_multicore_padded_steps(cuda):
    batch = traces.multicore_batch(["mcf_like", "lbm_like", "hmmer_like"],
                                   400, seed=2)
    _assert_kernel_matches_plain(_inputs(batch, _grid(), cuda,
                                         pad_steps=True))


@pytest.mark.cuda
def test_cuda_sweep_matches_cpu_sweep(cuda):
    batch = traces.multicore_batch(["gcc_like", "mcf_like"], 500, seed=9)
    before = ops.launches
    on_card = sim.sweep(batch, _grid())
    assert ops.launches == before + 1
    on_cpu = sim.sweep(batch, _grid(), device="cpu")
    for a, b in zip(on_card, on_cpu):
        for k in ("total_cycles", "acts", "hcrac_hits", "lat_sum",
                  "rltl_total"):
            assert a[k] == b[k], k
        np.testing.assert_array_equal(a["rltl_hist"], b["rltl_hist"])
        np.testing.assert_array_equal(a["bank_acts"], b["bank_acts"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIVISORS)
def test_device_divider_matches_torch_floor_division(cuda, d):
    a = torch.from_numpy(_dividends(d, 1 << 20)).to(cuda)
    q, r = kernel.floor_div(a, d)
    assert torch.equal(q, torch.div(a, d, rounding_mode="floor"))
    assert torch.equal(r, torch.remainder(a, d))


@pytest.mark.cuda
def test_kernel_matches_plain_at_a_padded_length(cuda):
    """Cores of different lengths in an L that is no multiple of the
    staging tile, so tiles end past a stream and past L."""
    batch = traces.pad_batch_to(
        traces.multicore_batch(["mcf_like", "lbm_like", "hmmer_like"], 333,
                               seed=8), 1_061)
    _assert_kernel_matches_plain(_inputs(batch, _grid(), cuda))


@pytest.mark.cuda
def test_kernel_matches_plain_past_32_cores(cuda):
    """More cores than lanes: lane k owns cores k, k + 32, ..."""
    names = ["mcf_like", "lbm_like", "milc_like", "gcc_like"] * 10 + [
        "hmmer_like"] * 3
    batch = traces.multicore_batch(names, 90, seed=4)
    _assert_kernel_matches_plain(_inputs(batch, _grid()[:8], cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n_ways", (1, 4))
def test_kernel_matches_plain_other_way_counts(cuda, n_ways):
    """An HCRAC of other than the 2 ways the kernel compiles for."""
    from repro_torch.core.hcrac import HCRACConfig
    grid = [sim.SimConfig(mech=sim.MechanismConfig(
                kind=k, hcrac=HCRACConfig(n_entries=64, n_ways=n_ways)),
                policy=pol)
            for k in ("chargecache", "cc_nuat") for pol in ("open", "closed")]
    batch = traces.multicore_batch(["mcf_like", "lbm_like", "milc_like"], 500,
                                   seed=7)
    _assert_kernel_matches_plain(_inputs(batch, grid, cuda))


@pytest.mark.cuda
def test_synth_entry_matches_plain_at_a_padded_length(cuda):
    """The synthesis entry with points of different request counts, so
    the shared max_len pads most of them."""
    from repro_torch.core.dram import InterleaveConfig
    from repro_torch.kernels.sim_step import ref as sref
    names = ("mcf_like", "lbm_like", "milc_like")
    grid = [sim.SimConfig(mech=sim.MechanismConfig(kind=k), policy=pol,
                          interleave=InterleaveConfig(il),
                          workload=traces.WorkloadSpec(names=names, n_req=n,
                                                       seed=5))
            for k in ("base", "chargecache", "cc_nuat")
            for pol in ("open", "closed") for il in ("bank", "xor")
            for n in (250, 517)]
    args = sim._stage_synth(grid, None, cuda)
    got = ops.run_synth(*args, True, True)
    want = sref.run_synth_ref(*args, True, True)
    for k in ("gap", "bank", "row", "is_write", "dep", "next_same"):
        assert torch.equal(got[3][k], want[3][k]), k
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1])
    for f in ("act_gid", "pre1_gid", "pre2_gid", "pre3_gid", "act_ref8"):
        assert torch.equal(getattr(got[2], f), getattr(want[2], f)), f
