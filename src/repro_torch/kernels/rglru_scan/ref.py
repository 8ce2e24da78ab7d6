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
halfway between two f32 values and ``e`` decides the side.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import sigmoid

__all__ = ["fma_f32", "gated", "gate_inputs", "rglru_scan_ref",
           "rglru_gated_scan_ref"]


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
    rd = r.double()
    above = rd > s
    lo = torch.where(above, torch.nextafter(r, torch.full_like(r, -torch.inf)),
                     r)
    hi = torch.where(above, r,
                     torch.nextafter(r, torch.full_like(r, torch.inf)))
    tie = (lo.double() + hi.double()) * 0.5 == s
    return torch.where(tie & (e != 0), torch.where(e > 0, hi, lo), r)


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
