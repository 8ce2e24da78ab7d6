"""The plain version of the ssm_scan kernel (port of
``repro.kernels.ssm_scan.ref``, which is ``repro.models.ssm
.ssm_scan_ref``): a loop over time in f32; and of its backward kernel, the
reverse loop."""

from __future__ import annotations

import torch

__all__ = ["ssm_scan_ref", "y_limit", "ssm_scan_bwd_ref", "dc_limit"]


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


def ssm_scan_bwd_ref(decay, dbu, c, h0, dy, dh_t):
    """The backward of ``ssm_scan_ref`` over one chunk, as an explicit
    reverse loop in f32 in the backward kernel's op order: from the
    cotangents ``dy`` [B,T,D] and ``dh_t`` [B,D,N] of ``(h_T, y)``,
    ``lam_t = c_t dy_t + decay_{t+1} lam_{t+1}`` (``lam_{T-1} = c dy +
    dh_t``), ``d dbu_t = lam_t``, ``d decay_t = lam_t h_{t-1}``, ``dh0 =
    decay_0 lam_0`` and ``dc_t = sum_d dy_t h_t`` (einsum's order) ->
    ``(d_decay, d_dbu, dc, dh0)``.  Each element is one rounded product or
    two-term sum, as autograd rounds it when it differentiates
    ``ssm_scan_ref``, so all but ``dc`` equal autograd's bit for bit."""
    T = decay.shape[1]
    hs = [h0.float()]
    for t in range(T):
        hs.append(decay[:, t] * hs[-1] + dbu[:, t])
    d_decay = torch.empty_like(decay)
    d_dbu = torch.empty_like(decay)
    dc = torch.empty_like(c)
    carry = dh_t.float()
    for t in range(T - 1, -1, -1):
        lam = c[:, t, None, :] * dy[:, t, :, None] + carry
        d_dbu[:, t] = lam
        d_decay[:, t] = lam * hs[t]
        dc[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hs[t + 1])
        carry = decay[:, t] * lam
    return d_decay, d_dbu, dc, carry


def dc_limit(decay, dbu, h0, dy) -> torch.Tensor:
    """The limit [B,T,N] of ``|dc - dc_plain|`` for a ``dc`` whose D-sum
    is taken in another order: two f32 sums of D products each lie within
    ``D * 2^-24 * sum_d |dy_t[d] h_t[d, n]|`` of the exact sum, so within
    twice that of each other (plus the smallest normal f32)."""
    D = decay.shape[2]
    h = h0.float()
    out = []
    for t in range(decay.shape[1]):
        h = decay[:, t] * h + dbu[:, t]
        out.append(torch.einsum("bd,bdn->bn", dy[:, t].abs(), h.abs()))
    return torch.stack(out, 1) * (2 * D * 2.0 ** -24) + 2.0 ** -126
