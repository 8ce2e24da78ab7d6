"""Error-feedback int8 gradient compression (port of
``repro.optim.compress``): per-tensor scaled int8 quantization with the
rounding residual carried to the next step.

    q_t   = round(clip((g_t + e_t) / s_t)) in int8
    e_t+1 = (g_t + e_t) - s_t * q_t

Bitwise to ``repro``'s on the same inputs: f32 arithmetic, round half
to even.  ``cross_pod_mean`` is the compressed mean over the pods: each
rank of a ``torch.distributed`` process group (the pod axis' group of a
mesh, ``mesh.get_group("pod")``) sends its int8 payload and f32 scale
through ``all_gather`` (~4x fewer bytes than an f32 all-reduce), and
every rank takes the mean of the dequantized parts.
"""

from __future__ import annotations

import torch

__all__ = ["quantize", "dequantize", "cross_pod_mean", "init_error"]


def quantize(g: torch.Tensor, err: torch.Tensor):
    """-> ``(q int8, scale f32 scalar, new_err f32)``."""
    g32 = g.to(torch.float32) + err
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_err = g32 - q.to(torch.float32) * scale
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def cross_pod_mean(g: torch.Tensor, err: torch.Tensor, group=None):
    """The compressed mean of ``g`` over the ranks of ``group`` (default:
    the whole process group) -> ``(mean in g's dtype, new_err)``.  The
    parts are added in rank order, then divided by the rank count."""
    import torch.distributed as dist
    q, scale, new_err = quantize(g, err)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty(1, dtype=scale.dtype, device=scale.device)
          for _ in range(n)]
    dist.all_gather(qs, q.contiguous(), group=group)
    dist.all_gather(ss, scale.reshape(1), group=group)
    parts = [dequantize(qi, si.reshape(())) for qi, si in zip(qs, ss)]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return (total / n).to(g.dtype), new_err


def init_error(params):
    """Zero f32 residuals shaped like ``params`` (a tree of tensors)."""
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
