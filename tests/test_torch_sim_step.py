"""The ``sim_step`` kernel tier of the PyTorch port.

Three groups:

* the port imports nothing of JAX or of ``repro`` (an AST scan of every
  module and of ``chip_smoke.py``);
* CPU-side checks of the dispatch: the package imports without CUDA or
  ``nvcc``, the entry points refuse to fall back to the CPU, a registry
  the kernel does not carry is refused, and the Python and CUDA sides
  agree on the packed-params layout;
* the CUDA kernel against its plain version, marked ``cuda``: these skip
  where no CUDA device exists and run on the card with
  ``python -m pytest -m cuda tests/test_torch_sim_step.py``.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import mechanisms as registry  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core import traces  # noqa: E402
from repro_torch.core.dram import DRAMConfig  # noqa: E402
from repro_torch.kernels.sim_step import kernel, ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
        f"{','.join(kernel.DIMS)}"
    enum = src.split("enum Field {")[1].split("};")[0]
    assert len(re.findall(r"\bF_\w+", enum)) == len(kernel.FIELDS)
    assert enum.strip().endswith("N_FIELDS")

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
    assert at["th_seg_edge"] + 2 == params.shape[1]


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
