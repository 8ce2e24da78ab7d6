"""Error-feedback int8 gradient compression (port of
``repro.optim.compress``): per-tensor scaled int8 quantization with the
rounding residual carried to the next step.

    q_t   = round(clip((g_t + e_t) / s_t)) in int8
    e_t+1 = (g_t + e_t) - s_t * q_t

Bitwise to ``repro``'s on the same inputs: f32 arithmetic, round half
to even.  ``cross_pod_mean`` (the compressed all-gather over the pod
axis) needs a process group and comes with the distribution substrate
(ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import torch

__all__ = ["quantize", "dequantize", "init_error"]


def quantize(g: torch.Tensor, err: torch.Tensor):
    """-> ``(q int8, scale f32 scalar, new_err f32)``."""
    g32 = g.to(torch.float32) + err
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_err = g32 - q.to(torch.float32) * scale
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error(params):
    """Zero f32 residuals shaped like ``params`` (a tree of tensors)."""
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
