"""The plain version of the rglru_scan kernel: ``repro.models.rglru``'s
gates (``_gates``) and recurrence (an XLA scan, no Pallas kernel) as
PyTorch ops and a loop over time.

``rglru_gated_scan_ref`` is the kernel's function: the two bf16 sigmoids
(``layers.sigmoid``, one rounded op at a time), ``a = exp(nsp * r)`` and
``x = i * u`` in the order and dtypes ``repro`` uses, then
``rglru_scan_ref``, the scan of ``a`` and ``x`` that is bitwise to
``repro``'s.

XLA on the CPU contracts ``1 - a * a`` and ``a * h + g`` into fused
multiply-adds, so ``g_t = x_t * sqrt(max(1 - a_t * a_t, 1e-9))`` rounds
``1 - a * a`` once, and ``h_t`` is ``a_t * h_{t-1} + g_t`` rounded once
to f32.  PyTorch has no
f32 FMA on the CPU; ``fma_f32`` computes the correctly rounded result
from f64 parts: the product of two f32 values is exact in f64, the sum
is split into its f64 rounding ``s`` and the exact error ``e`` (Knuth's
two-sum), and ``s`` rounds to f32 once, except where ``s`` lies exactly
halfway between two f32 values and ``e`` decides the side.  Autograd
differentiates it through the f64 parts (the fix-up of a halfway case,
``nextafter``, carries no derivative).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import sigmoid

__all__ = ["fma_f32", "gated", "gate_inputs", "rglru_scan_ref",
           "rglru_gated_scan_ref", "rglru_gated_scan_bwd_ref",
           "rglru_gated_scan_bwd_tiled", "cluster_rows", "dnsp_limit"]


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (round to nearest even), as
    ``__fmaf_rn`` and XLA's contracted multiply-add give it; a, b, c f32
    (broadcast)."""
    p = a.double() * b.double()                 # exact: 24 + 24 bits
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)              # p + c == s + e exactly
    r = s.float()
    with torch.no_grad():  # the halfway fix-up has no derivative of its own
        rd = r.double()
        above = rd > s
        lo = torch.where(above,
                         torch.nextafter(r, torch.full_like(r, -torch.inf)),
                         r)
        hi = torch.where(above, r,
                         torch.nextafter(r, torch.full_like(r, torch.inf)))
        tie = (lo.double() + hi.double()) * 0.5 == s
        fix = tie & (e != 0)
        side = torch.where(e > 0, hi, lo)
    # the gradient passes through r everywhere: a * b + c's derivative does
    # not depend on how it rounds (``r - r.detach()`` adds an exact 0)
    return torch.where(fix, side + (r - r.detach()), r)


def gated(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The recurrence's input ``x * sqrt(max(1 - a * a, 1e-9))`` (f32),
    ``1 - a * a`` one rounded FMA, the square root and the product
    correctly rounded, as ``__fsqrt_rn`` and ``__fmul_rn`` give them.
    PyTorch's f32 ``sqrt`` on the CPU is not correctly rounded (~0.6 % of
    values an ulp off); the f64 root rounded to f32 is (53 >= 2 * 24 + 2
    bits: the double rounding is innocuous)."""
    one = torch.ones((), dtype=torch.float32, device=a.device)
    f = torch.sqrt(torch.clamp_min(fma_f32(-a, a, one), 1e-9).double())
    return x * f.float()


def rglru_scan_ref(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """a, x: [B, S, d] f32; h0: [B, d] f32 -> ``(h_seq [B, S, d], h_S
    [B, d])``: ``g = gated(a, x)``, each step one rounded FMA."""
    g = gated(a, x)
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = fma_f32(a[:, t], h, g[:, t])
        hs.append(h)
    return torch.stack(hs, 1), h


def gate_inputs(r_pre: torch.Tensor, i_pre: torch.Tensor, u: torch.Tensor,
                nsp: torch.Tensor):
    """``(a, x)`` [B, S, d] f32 of the gate GEMMs' outputs ``r_pre``,
    ``i_pre`` and the conv output ``u`` (bf16) and ``nsp = -c *
    softplus(Lambda)`` [d] f32: ``a = exp(nsp * sigmoid(r_pre))``, ``x =
    sigmoid(i_pre) * u``, the sigmoids and the product in bf16."""
    r = sigmoid(r_pre)
    i = sigmoid(i_pre)
    return torch.exp(nsp * r.float()), (i * u).float()


def rglru_gated_scan_ref(r_pre: torch.Tensor, i_pre: torch.Tensor,
                         u: torch.Tensor, nsp: torch.Tensor,
                         h0: torch.Tensor):
    """r_pre, i_pre, u: [B, S, d] bf16; nsp: [d] f32; h0: [B, d] f32 ->
    ``(h_seq [B, S, d], h_S [B, d])`` f32: ``gate_inputs`` then
    ``rglru_scan_ref``."""
    a, x = gate_inputs(r_pre, i_pre, u, nsp)
    return rglru_scan_ref(a, x, h0)


def _gates(r_pre, i_pre, nsp):
    """``(r, i, a)``: the bf16 sigmoids and ``a = exp(nsp r)`` (f32)."""
    r = sigmoid(r_pre)
    return r, sigmoid(i_pre), torch.exp(nsp * r.float())


def _local(r, i, u, nsp, a, lam, h_prev):
    """The element-wise part of the backward given ``lam``: ``(dr_pre,
    di_pre, du)`` bf16 and dnsp's terms ``dq r`` (f32), in the order and
    dtypes of ``rglru_gated_scan_bwd_ref``."""
    x = (i * u).float()
    one = torch.ones((), dtype=torch.float32, device=a.device)
    m = fma_f32(-a, a, one)
    fd = torch.sqrt(torch.clamp_min(m, 1e-9).double())
    dx = lam * fd.float()
    df = lam * x
    dm = torch.where(m >= 1e-9, df.double() / (2 * fd),
                     torch.zeros((), dtype=torch.float64)).float()
    dam = -(dm * a)
    dq = ((lam * h_prev + dam) + dam) * a
    dr = (dq * nsp).to(torch.bfloat16)
    dxb = dx.to(torch.bfloat16)
    return (dr * (r * (1 - r)), (dxb * u) * (i * (1 - i)), dxb * i,
            dq * r.float())


def _backward(r_pre, i_pre, u, nsp, h0, h_seq, dh_seq, dh_s):
    """``(dr_pre, di_pre, du, terms, dh0)`` of ``rglru_gated_scan_bwd_ref``,
    ``terms`` [B, S, d] the f32 terms ``dq r`` that dnsp sums."""
    r, i, a = _gates(r_pre, i_pre, nsp)
    h_prev = torch.cat([h0.float()[:, None], h_seq[:, :-1]], 1)
    lam = torch.empty_like(h_seq)
    carry = dh_s.float()
    for t in range(h_seq.shape[1] - 1, -1, -1):
        lam[:, t] = dh_seq[:, t] + carry
        carry = lam[:, t] * a[:, t]
    return (*_local(r, i, u, nsp, a, lam, h_prev), carry)


def rglru_gated_scan_bwd_ref(r_pre, i_pre, u, nsp, h0, h_seq, dh_seq, dh_s):
    """The backward of ``rglru_gated_scan_ref`` as an explicit reverse
    loop, in the order and dtypes autograd uses when it differentiates
    it: from the inputs, the forward's ``h_seq`` [B, S, d] and the
    cotangents ``dh_seq`` [B, S, d] and ``dh_s`` [B, d] (f32) ->
    ``(dr_pre, di_pre, du)`` [B, S, d] bf16, ``dnsp`` [d] and ``dh0`` [B,
    d] f32 (``du`` the gate's share of u's gradient alone).  Backwards in
    time, ``lam_t = dh_seq_t + a_{t+1} lam_{t+1}`` (``lam_{S-1} =
    dh_seq_{S-1} + dh_s``), each product rounded once; then, element-wise,
    through the gate factor ``f = sqrt(max(1 - a a, 1e-9))`` (its root and
    derivative in f64, as ``gated`` takes them; the derivative passes where
    ``1 - a a >= 1e-9``, PyTorch's ``clamp_min`` convention: JAX's
    ``maximum`` gives half at an exact tie), ``a = exp(nsp r)`` and the two
    bf16 sigmoids (``layers.sigmoid``'s backward ``g (y (1 - y))``, each
    op rounded to bf16).  ``da`` adds the recurrence's ``lam_t h_{t-1}``
    and the two equal terms of ``1 - a a``'s factors in autograd's order;
    ``dnsp`` sums ``dq r`` over batch rows and time as autograd's
    broadcast reduction does."""
    dr, di, du, terms, dh0 = _backward(r_pre, i_pre, u, nsp, h0, h_seq,
                                       dh_seq, dh_s)
    return dr, di, du, terms.sum_to_size(nsp.shape), dh0


#: the backward kernel's tile (steps) and its threads of a channel: one
#: per row group g, each adding row g of every tile (rows g, g +
#: ROW_GROUPS, .. where a tile has more rows than row groups)
TILE = 32
ROW_GROUPS = 32
#: the most batch rows one cluster of the backward kernel adds up
CLUSTER_MAX = 8


def cluster_rows(B: int) -> int:
    """The batch rows whose dnsp sums one cluster of the backward kernel
    adds, in order: the largest divisor of ``B`` up to ``CLUSTER_MAX``."""
    return max(g for g in range(1, min(B, CLUSTER_MAX) + 1) if B % g == 0)


def rglru_gated_scan_bwd_tiled(r_pre, i_pre, u, nsp, h0, h_seq, dh_seq,
                               dh_s):
    """``rglru_gated_scan_bwd_ref`` as the backward kernel walks it: tiles
    of ``TILE`` steps from the last back, the chain down a tile's rows
    (the first tile walked partial where ``S % TILE`` is not 0), then the
    tile's element-wise gradients; and dnsp summed in the kernel's order:
    each (batch row, row group g, channel) adds its terms as the tiles
    come, row g of each (rows past S skipped), a
    batch row adds its row groups 0, 1, .. in turn, a cluster of
    ``cluster_rows(B)`` batch rows its rows in order, and the clusters'
    sums are added in order.  Same arguments and results."""
    B, S, d = r_pre.shape
    r, i, a = _gates(r_pre, i_pre, nsp)
    h_prev = torch.cat([h0.float()[:, None], h_seq[:, :-1]], 1)
    dr, di, du = (torch.empty_like(r_pre) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=h_seq.device)
    part = torch.zeros((B, ROW_GROUPS, d), **f32)
    carry = dh_s.float()
    n_tiles = -(-S // TILE)
    for k in range(n_tiles):
        t0 = (n_tiles - 1 - k) * TILE
        n = min(S, t0 + TILE) - t0
        lam = torch.empty((B, n, d), **f32)
        for j in range(n - 1, -1, -1):
            lam[:, j] = dh_seq[:, t0 + j] + carry
            carry = lam[:, j] * a[:, t0 + j]
        rows = slice(t0, t0 + n)
        dr[:, rows], di[:, rows], du[:, rows], terms = _local(
            r[:, rows], i[:, rows], u[:, rows], nsp, a[:, rows], lam,
            h_prev[:, rows])
        w = torch.zeros((B, TILE, d), **f32)
        w[:, :n] = terms
        for p in range(TILE // ROW_GROUPS):
            g = torch.arange(p * ROW_GROUPS, (p + 1) * ROW_GROUPS,
                             device=h_seq.device)
            part = torch.where((g < n)[None, :, None],
                               part + w[:, p * ROW_GROUPS:(p + 1)
                                        * ROW_GROUPS], part)
    row_sum = part[:, 0]
    for g in range(1, ROW_GROUPS):
        row_sum = row_sum + part[:, g]
    cs = cluster_rows(B)
    dnsp = None
    for b0 in range(0, B, cs):
        acc = row_sum[b0]
        for b in range(b0 + 1, b0 + cs):
            acc = acc + row_sum[b]
        dnsp = acc if dnsp is None else dnsp + acc
    return dr, di, du, dnsp, carry


def dnsp_limit(r_pre, i_pre, u, nsp, h0, h_seq, dh_seq, dh_s):
    """The limit [d] of ``|dnsp - dnsp_plain|`` for a ``dnsp`` whose sum
    over the ``B S`` terms ``dq r`` of a channel is taken in another
    order: two f32 sums of n terms each lie within ``n 2^-24 sum |term|``
    of the exact sum, so within twice that of each other (plus the
    smallest normal f32)."""
    t = _backward(r_pre, i_pre, u, nsp, h0, h_seq, dh_seq, dh_s)[3]
    n = t.shape[0] * t.shape[1]
    return t.abs().sum((0, 1)) * (2 * n * 2.0 ** -24) + 2.0 ** -126
