"""The flash kernel's backward entries as the CPU can hold them: their
plain emulation ``ref.flash_attention_bwd_tiled`` (the wgmma entries'
arithmetic: the tile order, bf16 P and dS, dS split into bf16 hi + lo in
the dQ product, f32 per-head partials summed in head order, ``exp2``)
against

* ``ref.flash_attention_bwd_ref`` (autograd of the f32 reference), and
* ``jax.grad`` of ``repro.models.layers.blocked_attention`` in f32 (the
  reference the port's training is held to),

on the same numpy-seeded bf16 inputs, within phase 24 (a)'s element-wise
limit ``|emulation - reference| <= 2^-7 |reference| + 2^-8 max
|reference|`` (``chip_smoke.FLASH_BWD_RTOL`` / ``ATOL``), over head dims
32 / 64 / 128, groups of 1 / 3 / 8 query heads and causal, window, no
mask and cross attention (S != Skv) (``repro`` on a cover of those:
every head dim with every mask).  Then the case fault 7 rests on:
keys with a common offset (whisper-small's decoder self-attention), where
bf16 dS's rounding is magnified in dQ = dS K, and the split lowers dQ's
error.  The CUDA entries themselves run on the card, where
``tests/test_torch_train_cuda.py`` also holds them to this emulation
(and chip_smoke phase 24 to the plain backward); here their launchers
refuse CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as j_layers  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fr  # noqa: E402

RTOL, ATOL = 2.0 ** -7, 2.0 ** -8
#: (S, Skv, causal, window) of each mask
MASKS = {"causal": (96, 96, True, 0), "window": (128, 128, True, 24),
         "none": (80, 80, False, 0), "cross": (40, 112, False, 0)}
HDS = (32, 64, 128)
GROUPS = (1, 3, 8)


def _inputs(S, Skv, H, K, hd, seed, offset=0.0):
    """bf16 q, k, v, do (numpy-seeded normals; keys shifted by ``offset``
    along one fixed unit direction)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, S, H, hd))
    k = rng.normal(size=(2, Skv, K, hd))
    if offset:
        u = rng.normal(size=hd)
        k = k + offset * u / np.linalg.norm(u)
    v = rng.normal(size=(2, Skv, K, hd))
    do = rng.normal(size=(2, S, H, hd))
    return [torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
            for x in (q, k, v, do)]


def _share(got, want) -> float:
    """The worst element's share of the limit."""
    w = want.float()
    lim = RTOL * w.abs() + ATOL * w.abs().max()
    return float(((got.float() - w).abs() / lim).max())


def _repro_grads(q, k, v, do, causal, window):
    S, Skv = q.shape[1], k.shape[1]
    f32 = lambda t: jnp.asarray(t.float().numpy())

    def loss(q, k, v):
        out = j_layers.blocked_attention(
            q, k, v, jnp.arange(S), jnp.arange(Skv), causal, window)
        return jnp.sum(out * f32(do))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(f32(q), f32(k),
                                                       f32(v))
    return [torch.from_numpy(np.array(g)) for g in grads]


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("hd", HDS)
def test_emulation_matches_the_plain_backward(hd, G, mask):
    S, Skv, causal, window = MASKS[mask]
    q, k, v, do = _inputs(S, Skv, 2 * G, 2, hd, 10 * hd + G)
    got = fr.flash_attention_bwd_tiled(q, k, v, do, causal=causal,
                                       window=window)
    want = fr.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                      window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _share(g, w) <= 1.0, name


#: repro's cases: every head dim with every mask, the group size turning
#: through 1 / 3 / 8 (a JAX compile each: the cover, not the product)
REPRO_CASES = [(hd, GROUPS[i % len(GROUPS)], mask) for i, (hd, mask) in
               enumerate((hd, mask) for hd in HDS for mask in MASKS)]


@pytest.mark.parametrize("hd,G,mask", REPRO_CASES)
def test_emulation_matches_repro_grad(hd, G, mask):
    S, Skv, causal, window = MASKS[mask]
    q, k, v, do = _inputs(S, Skv, 2 * G, 2, hd, 10 * hd + G + 1)
    got = fr.flash_attention_bwd_tiled(q, k, v, do, causal=causal,
                                       window=window)
    want = _repro_grads(q, k, v, do, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _share(g, w) <= 1.0, name


@pytest.mark.parametrize("reference", ["plain", "repro"])
def test_emulation_at_hd_256(reference):
    """recurrentgemma-2b's attention: hd 256, two query heads over one KV
    head, a sliding window (S 48, window 32), against the plain backward
    and ``repro``'s ``jax.grad``."""
    q, k, v, do = _inputs(48, 48, 2, 1, 256, 2560)
    got = fr.flash_attention_bwd_tiled(q, k, v, do, causal=True, window=32)
    if reference == "plain":
        want = fr.flash_attention_bwd_ref(q, k, v, do, causal=True,
                                          window=32)
    else:
        want = _repro_grads(q, k, v, do, True, 32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and _share(g, w) <= 1.0, name


def test_ds_split_lowers_dq_error_under_a_common_key_offset():
    """Keys 16 rms units off the origin along one direction: dQ = dS K
    carries (sum_j dS_ij) times the offset, exactly 0 in f32 but not once
    dS is rounded to bf16.  Summed over the query rows (what a bias before
    the query projection gathers), dQ's error falls with dS = hi + lo,
    and element by element only the split holds phase 24 (a)'s limit."""
    q, k, v, do = _inputs(128, 128, 4, 4, 64, 7, offset=16.0 * 8)
    want = fr.flash_attention_bwd_ref(q, k, v, do, causal=True, window=0)[0]
    err, share = {}, {}
    for split in (False, True):
        dq = fr.flash_attention_bwd_tiled(q, k, v, do, causal=True,
                                          window=0, split_dq=split)[0]
        err[split] = float((dq.float() - want).sum(1).norm()
                           / want.sum(1).norm())
        share[split] = _share(dq, want)
    assert err[True] < 0.5 * err[False], err
    assert share[True] <= 1.0 < share[False], share


@pytest.mark.parametrize("entry", ["flash_attention_bwd_dkdv",
                                   "flash_attention_bwd_dkdv_entry",
                                   "flash_attention_bwd_dq"])
def test_backward_entries_refuse_cpu_tensors(entry):
    q, k, v, do = _inputs(64, 64, 4, 2, 32, 0)
    rows = torch.zeros(2, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fk, entry)(q, k, v, do, rows, rows, causal=True, window=0)


def test_group_sum_refuses_cpu_tensors():
    part = torch.zeros(1, 64, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_bwd_sum(part, part, 2)

