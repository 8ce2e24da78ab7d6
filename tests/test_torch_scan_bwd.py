"""The scan kernels' backward as the CPU can hold it: their plain
versions and their launchers' C interface.

On the CPU, on numpy-seeded inputs:

* ``ssm_scan.ref.ssm_scan_bwd_ref`` (the reverse loop in the backward
  kernel's op order) against autograd of ``ref.ssm_scan_ref``: ``d
  decay``, ``d dbu`` and ``dh0`` bit for bit, ``dc`` within
  ``ref.dc_limit`` (two orders of a D-term f32 sum); a padded tail (``dt``
  0: decay 1, dbu 0, no cotangent) carries ``dh_T`` through exactly; and
  against ``jax.vjp`` of ``repro.models.ssm.ssm_scan_ref`` within
  ``REPRO_RTOL`` of each tensor's largest element (XLA's f32 sums and
  products round in other places).
* ``rglru_scan.ref.rglru_gated_scan_bwd_ref`` against autograd of
  ``rglru_gated_scan_ref``, every output bit for bit, with no element on
  the gate factor's clamp tie (``1 - a a == 1e-9``, where PyTorch passes
  the whole gradient and JAX half); and the reduced RG-LRU block's
  gradients (autograd through that plain version) against ``jax.vjp`` of
  ``repro.models.rglru.rglru_block_apply``, within the training tests'
  leaf limits (``tests/_torch_train.py``: 2^-3 of the largest element,
  2^-4 of the norm); finite where bf16 ``exp(-x)`` overflows.
* ``rglru_scan.ref.rglru_gated_scan_bwd_tiled`` (the backward kernel's
  walk: tiles of 32 steps from the last back, dnsp summed in the kernel's
  order) against ``rglru_gated_scan_bwd_ref``: ``dr_pre``, ``di_pre``,
  ``du`` and ``dh0`` bit for bit, ``dnsp`` within ``ref.dnsp_limit``, at
  sequence lengths around a tile, with a channel where the sigmoid
  overflows and a batch that needs two clusters; ``ref.cluster_rows``.
* ``layers.sigmoid``'s gradient against ``jax.vjp`` of ``jax.nn.sigmoid``,
  bit for bit.
* The backward launchers' ``ctypes`` signatures against the C sources,
  and their refusal of CPU tensors; the RG-LRU backward's tile, row groups
  and cluster size in ``rglru_scan.cu`` against the tiled walk's, and each
  RG-LRU launcher's grid against its kernel's channels a block.

The kernels themselves run on the card, in ``tests/test_torch_train_cuda.py``
(no JAX there), on the same inputs (``tests/_torch_scan_cases.py``)."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_scan_cases as C  # noqa: E402
import _torch_train as T  # noqa: E402
from repro.configs import get as j_get  # noqa: E402
from repro.models import params as j_params  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as rk  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as rr  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as sr  # noqa: E402
from repro_torch.models import rglru as t_rglru  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
#: ``repro``'s scan gradients against the port's, relative to each
#: tensor's largest element: XLA rounds the same f32 products and sums
#: (it may contract a multiply-add, and its einsum sums in another
#: order), which over 12 steps moves an element by a few ulps of the
#: largest
REPRO_RTOL = 2.0 ** -18


def test_ssm_bwd_ref_is_autograd_of_the_plain_scan():
    decay, dbu, c, h0, dy, dh_t = C.ssm_case()
    leaves = [x.clone().requires_grad_(True) for x in (decay, dbu, c, h0)]
    h, y = sr.ssm_scan_ref(*leaves)
    want = torch.autograd.grad((h, y), leaves, (dh_t, dy))
    d_decay, d_dbu, dc, dh0 = sr.ssm_scan_bwd_ref(decay, dbu, c, h0, dy,
                                                  dh_t)
    assert torch.equal(d_decay, want[0])
    assert torch.equal(d_dbu, want[1])
    assert torch.equal(dh0, want[3])
    assert ((dc - want[2]).abs() <= sr.dc_limit(decay, dbu, h0, dy)).all()
    # the padded tail: decay 1, no cotangent, so lam = dh_t there exactly
    assert torch.equal(d_dbu[:, -1], dh_t) and torch.equal(d_dbu[:, -3],
                                                           dh_t)


def test_ssm_bwd_ref_matches_repro_vjp():
    decay, dbu, c, h0, dy, dh_t = C.ssm_case(seed=1)
    j = lambda x: jnp.asarray(x.numpy())
    _, vjp = jax.vjp(j_ssm.ssm_scan_ref, j(decay), j(dbu), j(c), j(h0))
    want = vjp((j(dh_t), j(dy)))
    got = sr.ssm_scan_bwd_ref(decay, dbu, c, h0, dy, dh_t)
    for name, g, w in zip(("d_decay", "d_dbu", "dc", "dh0"),
                          (got[0], got[1], got[2], got[3]),
                          (want[0], want[1], want[2], want[3])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REPRO_RTOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("S", [1, 40])
def test_rglru_bwd_ref_is_autograd_of_the_plain_scan(S):
    r_pre, i_pre, u, nsp, h0, dh_seq, dh_s = C.rglru_case(S=S, seed=S)
    leaves = [x.clone().requires_grad_(True)
              for x in (r_pre, i_pre, u, nsp, h0)]
    h_seq, h_s = rr.rglru_gated_scan_ref(*leaves)
    want = torch.autograd.grad((h_seq, h_s), leaves, (dh_seq, dh_s))
    got = rr.rglru_gated_scan_bwd_ref(r_pre, i_pre, u, nsp, h0,
                                      h_seq.detach(), dh_seq, dh_s)
    for name, g, w in zip(("dr_pre", "di_pre", "du", "dnsp", "dh0"), got,
                          want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    # no input sits on the clamp's tie, where the two conventions differ
    a, _ = rr.gate_inputs(r_pre, i_pre, u, nsp)
    one = torch.ones(())
    assert not (rr.fma_f32(-a, a, one) == torch.tensor(1e-9)).any()


def test_rglru_bwd_ref_is_finite_where_the_sigmoid_overflows():
    """A channel of r_pre and of i_pre at -120, where bf16 ``exp(-x)`` is
    inf: the sigmoid's gradient there is 0 in autograd and in the plain
    backward alike (``jax.grad`` of ``lax.logistic`` gives 0 too)."""
    r_pre, i_pre, u, nsp, h0, dh_seq, dh_s = C.rglru_case(S=12, seed=7)
    r_pre[..., 1] = -120.0
    i_pre[..., 2] = -120.0
    leaves = [x.clone().requires_grad_(True)
              for x in (r_pre, i_pre, u, nsp, h0)]
    h_seq, h_s = rr.rglru_gated_scan_ref(*leaves)
    want = torch.autograd.grad((h_seq, h_s), leaves, (dh_seq, dh_s))
    got = rr.rglru_gated_scan_bwd_ref(r_pre, i_pre, u, nsp, h0,
                                      h_seq.detach(), dh_seq, dh_s)
    for name, g, w in zip(("dr_pre", "di_pre", "du", "dnsp", "dh0"), got,
                          want):
        assert torch.equal(g, w) and g.isfinite().all(), name
    assert not got[0][..., 1].any() and not got[1][..., 2].any()


@pytest.mark.parametrize("B,S,d", [(2, S, d) for S in (1, 31, 32, 33, 100)
                                   for d in (24, 64)] + [(12, 33, 24)])
def test_rglru_bwd_tiled_is_the_plain_backward(B, S, d):
    """The kernel's walk in tiles (the first walked partial unless S is a
    multiple of 32; S 1 a single row) gives the plain backward's bits but
    for dnsp, whose sum order is the kernel's (B 12: two clusters of 6
    batch rows); channel 1 of r_pre at -120."""
    r_pre, i_pre, u, nsp, h0, dh_seq, dh_s = C.rglru_case(B, S, d,
                                                          seed=20 + S)
    r_pre[..., 1] = -120.0
    h_seq, _ = rr.rglru_gated_scan_ref(r_pre, i_pre, u, nsp, h0)
    args = (r_pre, i_pre, u, nsp, h0, h_seq, dh_seq, dh_s)
    got = rr.rglru_gated_scan_bwd_tiled(*args)
    want = rr.rglru_gated_scan_bwd_ref(*args)
    for k, name in ((0, "dr_pre"), (1, "di_pre"), (2, "du"), (4, "dh0")):
        assert got[k].dtype == want[k].dtype, name
        assert torch.equal(got[k], want[k]), name
    assert all(bool(x.isfinite().all()) for x in got)
    assert ((got[3] - want[3]).abs() <= rr.dnsp_limit(*args)).all()


def test_cluster_rows_is_the_largest_divisor_up_to_eight():
    assert [rr.cluster_rows(B) for B in range(1, 18)] == [
        1, 2, 3, 4, 5, 6, 7, 8, 3, 5, 1, 6, 1, 7, 5, 8, 1]


RGLRU_CU = KERNELS / "rglru_scan" / "csrc" / "rglru_scan.cu"


def _cu_constants(src: Path) -> dict:
    """The source's ``constexpr int`` constants, evaluated in order."""
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 src.read_text()):
        consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
    return consts


def _cu_body(text: str, start: int) -> str:
    """The text of the function defined from ``start`` on, up to its
    closing brace at the start of a line."""
    return text[start:text.index("\n}\n", start)]


def test_rglru_bwd_tiled_walk_uses_the_kernels_constants():
    """``ref.rglru_gated_scan_bwd_tiled`` sums dnsp in the order the
    backward kernel's tile, row groups and cluster size give it."""
    k = _cu_constants(RGLRU_CU)
    assert (k["TT"], k["BW_ROWS"], k["CLUSTER_MAX"]) == (
        rr.TILE, rr.ROW_GROUPS, rr.CLUSTER_MAX)


@pytest.mark.parametrize("launcher,kernel", [
    ("int rglru_scan_launch(", "rglru_scan_kernel("),
    ("int rglru_scan_bwd_launch(", "rglru_scan_bwd_kernel(")])
def test_rglru_launchers_size_grids_by_their_kernels_tiles(launcher,
                                                           kernel):
    """Each launcher's tensor maps, grid and kernel take the same channels
    a block: one constant, so no launcher starts blocks past D."""
    text = RGLRU_CU.read_text()
    body = _cu_body(text, text.index(launcher))
    boxes = set(re.findall(r"encode\([^;]*?, (\w+)\)", body))
    grids = re.findall(r"\(D \+ (\w+) - 1\) / (\w+)", body)
    k_body = _cu_body(text, re.search(
        r"__global__[^{]*?\b" + re.escape(kernel), text).start())
    c0 = re.findall(r"c0 = blockIdx\.x \* (\w+);", k_body)
    assert len(boxes) == 1 and len(grids) == 1 and len(c0) == 1
    (box,) = boxes
    assert grids[0] == (box, box) and c0[0] == box


@pytest.mark.parametrize("points", ["named", "drawn"])
def test_sigmoid_grad_matches_jax_logistic(points):
    """``layers.sigmoid``'s gradient in bf16 against ``jax.vjp`` of
    ``jax.nn.sigmoid``, bit for bit: at -120 and -89 (bf16 ``exp(-x)``
    overflows; both give 0), -10 and 0.5, and at 4 096 draws of 4 N(0, 1)
    (none near -88, where XLA on the CPU flushes a subnormal gradient to 0
    and PyTorch keeps it)."""
    from repro_torch.models.layers import sigmoid
    rng = np.random.default_rng(11)
    x = (np.array([-120.0, -89.0, -10.0, 0.5], np.float32)
         if points == "named" else
         (rng.normal(size=4096) * 4).astype(np.float32))
    g = rng.normal(size=x.shape).astype(np.float32)
    xj, gj = (jnp.asarray(v, jnp.float32).astype(jnp.bfloat16)
              for v in (x, g))
    want = np.asarray(jax.vjp(jax.nn.sigmoid, xj)[1](gj)[0].astype(
        jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    got, = torch.autograd.grad(sigmoid(xt), xt,
                               torch.from_numpy(g).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.fixture(scope="module")
def rglru_block():
    """``repro``'s random bf16 weights of one reduced RG-LRU block
    (``lam`` and ``conv_b`` off their constant inits) and the port's
    copy."""
    cfgj, cfgt = j_get("recurrentgemma_2b").reduced(), t_get(
        "recurrentgemma_2b").reduced()
    pj = j_params.init_params(j_rglru.rglru_defs(cfgj),
                              jax.random.PRNGKey(15), jnp.bfloat16)
    rng = np.random.default_rng(16)
    d = cfgj.d_model
    pj["lam"] = jnp.asarray(rng.uniform(-1, 2, d), jnp.bfloat16)
    pj["conv_b"] = jnp.asarray(rng.normal(size=d) * 0.1, jnp.bfloat16)
    pt = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16), pj)
    return cfgj, cfgt, pj, pt


def test_rglru_block_grads_match_repro_vjp(rglru_block):
    cfgj, cfgt, pj, pt = rglru_block
    rng = np.random.default_rng(17)
    shape = (2, 20, cfgj.d_model)
    xj = jnp.asarray(rng.normal(size=shape), jnp.float32).astype(
        jnp.bfloat16)
    cot = jnp.asarray(rng.normal(size=shape), jnp.float32).astype(
        jnp.bfloat16)
    # under jit, as ``repro``'s train step runs it (op by op, the vjp takes
    # several times as long to dispatch)
    f = lambda p, x: j_rglru.rglru_block_apply(p, x, cfgj, chunk=8)
    want_p, want_x = jax.jit(lambda p, x, c: jax.vjp(f, p, x)[1](c))(
        pj, xj, cot)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16)
    names = sorted(pt)
    leaves = [pt[k].clone().requires_grad_(True) for k in names]
    xt = to_t(xj).requires_grad_(True)
    yt = t_rglru.rglru_block_apply(dict(zip(names, leaves)), xt, cfgt)
    got = torch.autograd.grad(yt, leaves + [xt], to_t(cot))
    for k, g in zip(names, got):
        T.check_leaf(g, want_p[k], k)
    T.check_leaf(got[-1], want_x, "x")


def _c_params(src: Path, fn: str) -> list[str]:
    sig = re.search(rf"{fn}\(([^)]*)\)", src.read_text()).group(1)
    return ["pointer" if "*" in p else
            " ".join(p.split()[:-1]).replace("const ", "")
            for p in sig.split(",") if p.strip()]


def _kind(ctype) -> str:
    return {ctypes.c_int: "int", ctypes.c_longlong: "long long",
            ctypes.c_float: "float"}.get(ctype, "pointer")


@pytest.mark.parametrize("mod,src,fn", [
    (sk, "ssm_scan/csrc/ssm_scan.cu", "ssm_scan_launch"),
    (sk, "ssm_scan/csrc/ssm_scan.cu", "ssm_scan_bwd_blocks"),
    (sk, "ssm_scan/csrc/ssm_scan.cu", "ssm_scan_bwd_launch"),
    (sk, "ssm_scan/csrc/ssm_scan.cu", "ssm_scan_dc_sum_launch"),
    (rk, "rglru_scan/csrc/rglru_scan.cu", "rglru_scan_bwd_smem_bytes"),
    (rk, "rglru_scan/csrc/rglru_scan.cu", "rglru_scan_bwd_scratch"),
    (rk, "rglru_scan/csrc/rglru_scan.cu", "rglru_scan_bwd_launch")])
def test_backward_launch_arguments_match_the_cuda_source(mod, src, fn,
                                                         monkeypatch):
    from repro_torch import _build

    class Fake:
        def __getattr__(self, name):
            f = type("F", (), {})()
            setattr(self, name, f)
            return f

    fake = Fake()
    monkeypatch.setattr(_build, "load", lambda name, csrc: fake)
    mod.library.cache_clear()
    try:
        mod.library()
        argtypes = getattr(fake, fn).argtypes
        restype = getattr(fake, fn).restype
    finally:
        mod.library.cache_clear()
    ret = re.search(rf"(\w+(?: \w+)?) {fn}\(", (KERNELS / src).read_text())
    assert _kind(restype) == ret.group(1)
    assert [_kind(a) for a in argtypes] == _c_params(KERNELS / src, fn)


def test_backward_launchers_refuse_cpu_tensors():
    decay, dbu, c, h0, dy, dh_t = C.ssm_case()
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssm_scan_train(decay, dbu, c, h0)
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssm_scan_bwd(decay, decay, h0, c, dy, dh_t)
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssm_scan_dc_sum(torch.zeros(2, 3, 12, 4))
    r_pre, i_pre, u, nsp, h0, dh_seq, dh_s = C.rglru_case()
    with pytest.raises(ValueError, match="CUDA"):
        rk.rglru_scan_bwd(r_pre, i_pre, u, nsp, h0, dh_seq, dh_seq, dh_s)
