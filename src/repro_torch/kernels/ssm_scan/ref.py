"""The plain version of the ssm_scan kernel (port of
``repro.kernels.ssm_scan.ref``, which is ``repro.models.ssm
.ssm_scan_ref``): a loop over time in f32."""

from __future__ import annotations

import torch

__all__ = ["ssm_scan_ref", "y_limit"]


def ssm_scan_ref(decay, dbu, c, h0):
    """Sequential selective scan: ``h_t = decay_t * h_{t-1} + dbu_t`` and
    ``y_t = sum_N c_t * h_t``.  decay / dbu: [B,T,D,N]; c: [B,T,N]; h0:
    [B,D,N] -> ``(h_T [B,D,N], y [B,T,D])``, f32 (TF32 off, the card
    computes ``y`` in full f32)."""
    h = h0.float()
    ys = []
    for t in range(decay.shape[1]):
        h = decay[:, t] * h + dbu[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return h, torch.stack(ys, 1)


def y_limit(decay, dbu, c, h0) -> torch.Tensor:
    """The limit [B,T,D] of ``|y - y_plain|`` for a ``y`` whose N-sum is
    taken in another order: each of the two f32 sums of N products lies
    within ``N * 2^-24 * sum_N |c_t * h_t|`` of the exact sum, so they
    lie within twice that of each other (plus the smallest normal f32,
    for an all-zero row)."""
    N = decay.shape[-1]
    h = h0.float()
    out = []
    for t in range(decay.shape[1]):
        h = decay[:, t] * h + dbu[:, t]
        out.append(torch.einsum("bdn,bn->bd", h.abs(), c[:, t].abs()))
    return torch.stack(out, 1) * (2 * N * 2.0 ** -24) + 2.0 ** -126
