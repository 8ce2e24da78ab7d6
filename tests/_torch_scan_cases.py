"""Numpy-seeded inputs of the scan kernels' backward (CPU tensors), shared
by the CPU tests (``test_torch_scan_bwd.py``) and the card's
(``test_torch_train_cuda.py``)."""

import numpy as np
import torch


def ssm_case(B=2, T_=12, D=16, N=4, tail=3, seed=0):
    """``(decay, dbu, c, h0, dy, dh_t)`` f32 CPU tensors: ``decay =
    exp(dt A)`` and ``dbu = dt u B`` from numpy draws, the last ``tail``
    steps padded as ``models/ssm.py`` pads a chunk (dt 0, no cotangent
    of y), and a nonzero ``dh_t``."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.5, (B, T_, D)).astype(np.float32)
    dt[:, T_ - tail:] = 0.0
    A = -np.exp(rng.normal(size=(D, N))).astype(np.float32)
    u = rng.normal(size=(B, T_, D)).astype(np.float32)
    Bm = rng.normal(size=(B, T_, N)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    decay = torch.exp(t(dt)[..., None] * t(A))
    dbu = (t(dt) * t(u))[..., None] * t(Bm)[..., None, :]
    c = t(rng.normal(size=(B, T_, N)))
    h0 = t(rng.normal(size=(B, D, N)))
    dy = rng.normal(size=(B, T_, D)).astype(np.float32)
    dy[:, T_ - tail:] = 0.0
    return decay, dbu, c, h0, t(dy), t(rng.normal(size=(B, D, N)))


def rglru_case(B=2, S=40, d=24, seed=0):
    """The backward's inputs on the CPU: ``r_pre``, ``i_pre`` ~ 2 N(0, 1),
    ``u`` ~ N(0, 1) (bf16), ``nsp = -8 softplus(lam)``, ``h0`` and the
    cotangents (f32), numpy draws."""
    rng = np.random.default_rng(seed)
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    f32 = lambda x: torch.from_numpy(x.astype(np.float32))
    r_pre = bf(rng.normal(size=(B, S, d)) * 2)
    i_pre = bf(rng.normal(size=(B, S, d)) * 2)
    u = bf(rng.normal(size=(B, S, d)))
    nsp = -8 * torch.nn.functional.softplus(f32(rng.normal(size=d)))
    return (r_pre, i_pre, u, nsp, f32(rng.normal(size=(B, d))),
            f32(rng.normal(size=(B, S, d))), f32(rng.normal(size=(B, d))))
