"""The flash kernel's training entries (the LSE forward, the three
backward entries and the group sum) and the scan kernels' backward.

On the CPU: the launchers' ctypes signatures against the C source, the
dispatch (autograd differentiates the plain version on CPU tensors; the
training launchers refuse them).  On the card (marked ``cuda``, skipped
here inside a fixture; run with ``python -m pytest -m cuda
tests/test_torch_train_cuda.py``): the backward entries against
``ref.flash_attention_bwd_ref`` within chip_smoke's limit (2^-7 of
|plain| + 2^-8 of the tensor's largest |plain|), bitwise equal when run
twice, and against their emulation ``ref.flash_attention_bwd_tiled``
(which the CPU tests hold to autograd and to ``repro``'s ``jax.grad``)
within one bf16 rounding step and a far smaller absolute term, the refusals
(hd above 256, f32), and a reduced train step through the kernels against
the same step through the plain versions.  And the scan kernels'
backward on the card: each against its plain version
(``ssm_scan_bwd_ref``, ``rglru_gated_scan_bwd_ref``, which
``tests/test_torch_scan_bwd.py`` holds to autograd and to ``repro``),
bitwise but for the sums dC and dnsp (held to ``ref.dc_limit`` /
``ref.dnsp_limit``: two orders of an f32 sum), the RG-LRU's also against
``ref.rglru_gated_scan_bwd_tiled`` (bitwise, dnsp too), bitwise when run
twice, and autograd through the dispatch launching them.  And
``examples/fault_tolerance_torch.py``'s drill at its reduced size, run
twice on the card: the same report, lines and losses, and the same final
parameters and AdamW state bit for bit.  No JAX here."""

import ctypes
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_scan_cases as C  # noqa: E402

from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fr  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as rk  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as ro  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as rr  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as so  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as sr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc"
       / "flash_attention.cu")
RTOL, ATOL = 2.0 ** -7, 2.0 ** -8


def _c_params(fn: str) -> list[str]:
    sig = re.search(rf"int {fn}\(([^)]*)\)", SRC.read_text()).group(1)
    return [" ".join(p.split()[:-1]) for p in sig.split(",")]


def _kind(ctype) -> str:
    return {ctypes.c_int: "int", ctypes.c_longlong: "long long",
            ctypes.c_float: "float"}.get(ctype, "pointer")


@pytest.mark.parametrize("fn", ["flash_attention_lse_launch",
                                "flash_bwd_dot_launch",
                                "flash_bwd_dkdv_launch",
                                "flash_bwd_sum_launch",
                                "flash_bwd_dq_launch"])
def test_training_launch_arguments_match_the_cuda_source(fn, monkeypatch):
    from repro_torch import _build

    class Fake:
        def __getattr__(self, name):
            f = type("F", (), {})()
            setattr(self, name, f)
            return f

    fake = Fake()
    monkeypatch.setattr(_build, "load", lambda name, csrc: fake)
    fk.library.cache_clear()
    try:
        fk.library()
        argtypes = getattr(fake, fn).argtypes
    finally:
        fk.library.cache_clear()
    want = ["pointer" if "*" in p else p.replace("const ", "")
            for p in _c_params(fn)]
    assert [_kind(a) for a in argtypes] == want


def _inputs(B, S, Skv, H, K, hd, seed, device="cpu", dtype=torch.bfloat16):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draw = lambda *s: torch.randn(s, generator=gen, device=device).to(dtype)
    return (draw(B, S, H, hd), draw(B, Skv, K, hd), draw(B, Skv, K, hd),
            draw(B, S, H, hd))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8),
                                           (False, 0)])
def test_cpu_autograd_of_the_plain_version_is_the_plain_backward(causal,
                                                                 window):
    q, k, v, do = _inputs(1, 24, 24, 4, 2, 16, 0, dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, do)
    want = fr.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                      window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_training_launchers_refuse_cpu_tensors():
    q, k, v, do = _inputs(1, 8, 8, 2, 1, 16, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_lse(q, k, v, causal=True, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_bwd_dot(q, q, do, 64)
    assert fk.lse_rows(1) == 64 and fk.lse_rows(1500) == 1536


# ----------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_train_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bwd(q, k, v, do, causal, window):
    o, lse, o_lo = fk.flash_attention_lse(q, k, v, causal=causal,
                                          window=window)
    dlt = fk.flash_attention_bwd_dot(o, o_lo, do, lse.shape[-1])
    dk, dv, _ = fk.flash_attention_bwd_dkdv(q, k, v, do, lse, dlt,
                                            causal=causal, window=window)
    dq = fk.flash_attention_bwd_dq(q, k, v, do, lse, dlt, causal=causal,
                                   window=window)
    return dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (2, 128, 128, 4, 2, 64, True, 0), (1, 200, 200, 6, 2, 128, True, 0),
    (2, 96, 96, 4, 4, 32, True, 40), (1, 100, 300, 4, 4, 64, False, 0),
    (3, 70, 70, 8, 1, 40, False, 0), (1, 130, 130, 10, 1, 256, True, 64),
    (2, 100, 100, 4, 2, 192, False, 0)])
def test_backward_kernel_matches_plain_and_is_deterministic(cuda, case):
    B, S, Skv, H, K, hd, causal, window = case
    q, k, v, do = _inputs(B, S, Skv, H, K, hd, 7, device=cuda)
    got = _bwd(q, k, v, do, causal, window)
    again = _bwd(q, k, v, do, causal, window)
    want = fr.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                      window=window)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        lim = RTOL * w.abs() + ATOL * w.abs().max()
        assert ((g.float() - w).abs() <= lim).all()


#: the entries against their emulation.  The two differ in f32 only
#: (wgmma's sum order, ex2.approx, the LSE and D inputs), which moves a
#: bf16 rounding of P, dS or the output now and then by one step: so most
#: elements are bitwise equal (``EMUL_EQUAL``, the least share), and every
#: element lies within one bf16 step of its own (2^-7 of it at most) plus
#: 2^-10 of the tensor's largest for the steps of P and dS, a quarter of
#: chip_smoke's absolute term (``tests/_torch_flash_bwd_emul.py`` measures
#: both at other inputs).
EMUL_RTOL, EMUL_ATOL, EMUL_EQUAL = 2.0 ** -7, 2.0 ** -10, 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 200, 200, 6, 2, 128, True, 0, 0.0),
    (2, 96, 96, 4, 4, 32, True, 40, 0.0),
    (1, 100, 300, 4, 4, 64, False, 0, 0.0),
    (2, 128, 128, 16, 2, 64, True, 0, 0.0),
    (1, 128, 128, 4, 4, 64, True, 0, 128.0)])
def test_backward_kernel_matches_its_emulation(cuda, case):
    """The wgmma entries as shipped (dS split in the dQ product) against
    ``ref.flash_attention_bwd_tiled`` on the same inputs (the last case:
    keys 16 rms units off the origin, as whisper-small's decoder)."""
    B, S, Skv, H, K, hd, causal, window, offset = case
    q, k, v, do = _inputs(B, S, Skv, H, K, hd, 11, device=cuda)
    if offset:
        gen = torch.Generator(device=cuda).manual_seed(12)
        u = torch.randn(hd, generator=gen, device=cuda)
        k = (k.float() + offset * u / u.norm()).to(k.dtype)
    got = _bwd(q, k, v, do, causal, window)
    want = fr.flash_attention_bwd_tiled(
        *(t.cpu() for t in (q, k, v, do)), causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.cpu().float(), w.float()
        lim = EMUL_RTOL * w.abs() + EMUL_ATOL * w.abs().max()
        assert ((g - w).abs() <= lim).all(), name
        assert float((g == w).float().mean()) >= EMUL_EQUAL, name


@pytest.mark.cuda
def test_autograd_through_the_kernels_counts_launches(cuda):
    q, k, v, do = _inputs(1, 64, 64, 4, 2, 64, 3, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    counts = lambda: (fops.launches, fops.bwd_dot_launches,
                      fops.bwd_dkdv_launches, fops.bwd_sum_launches,
                      fops.bwd_dq_launches)
    before = counts()
    out = fops.flash_attention(*leaves, causal=True, window=0)
    got = torch.autograd.grad(out, leaves, do)
    after = counts()
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1, 1, 1]
    for g, w in zip(got, _bwd(q, k, v, do, True, 0)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_training_entries_refuse_what_they_do_not_take(cuda):
    q, k, v, do = _inputs(1, 16, 16, 2, 1, 264, 0, device=cuda)
    with pytest.raises(ValueError, match="limit of 256"):
        fops.flash_attention(q.requires_grad_(True), k, v, causal=True)
    q, k, v, do = _inputs(1, 16, 16, 2, 1, 64, 0, device=cuda,
                          dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        fops.flash_attention(q.requires_grad_(True), k, v, causal=True)


@pytest.mark.cuda
def test_reduced_train_step_through_the_kernels_matches_plain(cuda):
    """One step of the reduced tinyllama (hd 16 pads to the kernels' 32)
    through the flash kernels and through the plain version on the card:
    the same metrics within the training tolerances."""
    from repro_torch.configs import get
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    from repro_torch.optim import adamw
    cfg = get("tinyllama-1.1b").reduced()
    batch = zoo.make_batch(cfg, zoo.ShapeConfig("t", 64, 4, "train"),
                           seed=1, device=cuda)
    out = {}
    for name in ("kernel", "plain"):
        model = zoo.init_model(cfg, seed=0, device=cuda)
        step = steps.make_train_step(cfg, adamw.AdamWConfig(),
                                     microbatches=2)
        orig = fops.flash_attention
        if name == "plain":
            fops.flash_attention = (lambda q, k, v, *, causal=True,
                                    window=0: fr.flash_attention_ref(
                                        q, k, v, causal=causal,
                                        window=window))
        try:
            _, out[name] = step(model, adamw.init(model.tree()), batch)
        finally:
            fops.flash_attention = orig
    for key, tol in (("loss", 2.0 ** -12), ("grad_norm", 2.0 ** -8)):
        a, b = float(out["kernel"][key]), float(out["plain"][key])
        assert abs(a - b) <= tol * abs(b), (key, a, b)


# ------------------------------------------- the scan kernels' backward

def _on(dev, *xs):
    return [x.to(dev) for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 12, 16, 4, 3), (1, 37, 100, 5, 0),
                                  (2, 256, 512, 16, 44),
                                  (1, 64, 600, 16, 0)])
def test_ssm_bwd_kernel_matches_plain_and_is_deterministic(cuda, case):
    """The last case's 38 block partials of dC are not a multiple of the
    sum kernel's 32 segments; the second's T N = 185 takes its scalar
    loads."""
    B, T_, D, N, tail = case
    decay, dbu, c, h0, dy, dh_t = _on(cuda, *C.ssm_case(B, T_, D, N, tail, 2))
    h_out, y, h_seq = sk.ssm_scan_train(decay, dbu, c, h0)
    assert all(torch.equal(a, b) for a, b in zip(
        (h_out, y), sk.ssm_scan(decay, dbu, c, h0)))

    def bwd():
        d_decay, d_dbu, dh0, part = sk.ssm_scan_bwd(decay, h_seq, h0, c, dy,
                                                    dh_t)
        return d_decay, d_dbu, sk.ssm_scan_dc_sum(part), dh0
    got, again = bwd(), bwd()
    want = sr.ssm_scan_bwd_ref(decay, dbu, c, h0, dy, dh_t)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i in (0, 1, 3):
        assert torch.equal(got[i], want[i]), i
    assert ((got[2] - want[2]).abs()
            <= sr.dc_limit(decay, dbu, h0, dy)).all()


def _every_bf16(B, S, d):
    """``r_pre`` through every bf16 bit pattern (NaNs as 0) and ``i_pre``
    through the same values shuffled (``B S d`` = 65 536), on the CPU."""
    import numpy as np
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32)
    nan = ((bits & 0x7F80) == 0x7F80) & ((bits & 0x7F) != 0)
    vals = torch.where(nan, 0, bits).to(torch.int16).view(torch.bfloat16)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(2**16))
    return vals.reshape(B, S, d).clone(), vals[perm].reshape(B, S, d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 40, 24, False), (3, 100, 64, False),
                                  (1, 1, 32, False), (2, 2100, 64, False),
                                  (12, 33, 24, False), (2, 1024, 32, True)])
def test_rglru_bwd_kernel_matches_plain_and_is_deterministic(cuda, case):
    """Against the plain backward (bitwise but dnsp) and its tiled walk
    (bitwise, dnsp too: the kernel's sum order): S 2 100 ends in a
    partial tile, B 3 is one cluster of 3 batch rows, B 12 two of 6 (and
    the sum of their partials); the last case puts every bf16 value into
    r_pre and i_pre."""
    B, S, d, every = case
    r_pre, i_pre, u, nsp, h0, dh_seq, dh_s = C.rglru_case(B, S, d, seed=3)
    if every:
        r_pre, i_pre = _every_bf16(B, S, d)
    else:
        # a channel each where the sigmoid's bf16 exp(-x) overflows
        r_pre[..., -1] = -120.0
        i_pre[..., 0] = -120.0
    r_pre, i_pre, u, nsp, h0, dh_seq, dh_s = _on(
        cuda, r_pre, i_pre, u, nsp, h0, dh_seq, dh_s)
    h_seq, _ = rk.rglru_scan(r_pre, i_pre, u, nsp, h0)
    args = (r_pre, i_pre, u, nsp, h0, h_seq, dh_seq, dh_s)
    got = rk.rglru_scan_bwd(*args)
    again = rk.rglru_scan_bwd(*args)
    want = rr.rglru_gated_scan_bwd_ref(*args)
    tiled = rr.rglru_gated_scan_bwd_tiled(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(x.isfinite().all() for x in got)
    for i in (0, 1, 2, 4):
        assert torch.equal(got[i], want[i]), i
    for i in range(5):
        assert torch.equal(got[i], tiled[i]), i
    assert ((got[3] - want[3]).abs() <= rr.dnsp_limit(*args)).all()


@pytest.mark.cuda
def test_autograd_through_the_scan_kernels_counts_launches(cuda):
    decay, dbu, c, h0, dy, dh_t = _on(cuda, *C.ssm_case(seed=4))
    leaves = [x.clone().requires_grad_(True) for x in (decay, dbu, c, h0)]
    count = lambda: (so.train_launches, so.bwd_launches, so.bwd_sum_launches)
    before = count()
    h, y = so.ssm_scan(*leaves)
    got = torch.autograd.grad((h, y), leaves, (dh_t, dy))
    after = count()
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
    want = sr.ssm_scan_bwd_ref(decay, dbu, c, h0, dy, dh_t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    r_pre, i_pre, u, nsp, h0, dh_seq, dh_s = _on(cuda, *C.rglru_case(seed=5))
    leaves = [x.clone().requires_grad_(True)
              for x in (r_pre, i_pre, u, nsp, h0)]
    count = lambda: (ro.launches, ro.bwd_launches, ro.bwd_nsp_launches)
    before = count()
    h_seq, h_s = ro.rglru_scan(*leaves)
    got = torch.autograd.grad((h_seq, h_s), leaves, (dh_seq, dh_s))
    assert [b - a for a, b in zip(before, count())] == [1, 1, 0]
    want = rr.rglru_gated_scan_bwd_ref(r_pre, i_pre, u, nsp, h0,
                                       h_seq.detach(), dh_seq, dh_s)
    assert all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))


@pytest.mark.cuda
def test_rglru_bwd_second_launch_follows_cluster_rows(cuda):
    """The backward adds dnsp's cluster partials in a second launch, with
    a scratch of those partials, exactly where ``ref.cluster_rows`` leaves
    more than one cluster (B > 8), and counts that launch."""
    lib = rk.library()
    for B in range(1, 41):
        groups = B // rr.cluster_rows(B)
        assert lib.rglru_scan_bwd_scratch(B, 1, 8) == (
            8 * groups if groups > 1 else 0), B
    r_pre, i_pre, u, nsp, h0, dh_seq, dh_s = _on(
        cuda, *C.rglru_case(B=12, S=33, seed=6))
    leaves = [x.clone().requires_grad_(True)
              for x in (r_pre, i_pre, u, nsp, h0)]
    before = (ro.bwd_launches, ro.bwd_nsp_launches)
    h_seq, h_s = ro.rglru_scan(*leaves)
    torch.autograd.grad((h_seq, h_s), leaves, (dh_seq, dh_s))
    count = (ro.bwd_launches, ro.bwd_nsp_launches)
    assert [b - a for a, b in zip(before, count)] == [1, 1]


@pytest.mark.cuda
def test_fault_tolerance_drill_twice_on_the_card(cuda, tmp_path):
    """``examples/fault_tolerance_torch.py`` at its reduced size on the
    card, twice: the same report and lines both times, finite losses,
    and the same final parameters and AdamW state, bit for bit."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        "_example_ft", ROOT / "examples" / "fault_tolerance_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    runs = []
    for i in range(2):
        with contextlib.redirect_stdout(io.StringIO()):
            runs.append(ex.main(["--ckpt-dir", str(tmp_path / str(i))]))
    a, b = runs
    assert a["lines"] == b["lines"] and a["losses"] == b["losses"]
    assert a["report"] == b["report"] and a["report"].restored_from == [20]
    assert all(torch.isfinite(torch.tensor(v)) for _, v in a["losses"])
    assert all(torch.equal(x, y) for x, y in zip(
        ex.state_leaves(a), ex.state_leaves(b), strict=True))
