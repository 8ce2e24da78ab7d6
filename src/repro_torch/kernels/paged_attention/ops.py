"""Model-layout decode attention, dispatched by device (port of
``repro.kernels.paged_attention.ops``).

Rotates the query (RoPE at ``q_pos``, as the Pallas wrapper does), then:
CPU tensors run the plain version (``ref.decode_ref``), CUDA tensors
launch the CUDA kernel (``kernel.decode_attention``) on the cache as it
lies, and a failed build or launch raises; nothing falls back from one
to the other.  Meta tensors (the dry run) launch nothing: an empty
output of the kernel's shape, and the kernel's work
(``analysis.roofline.decode_work``, every slot of the ring counted as
valid: a full cache) added to the active op counter, on each rank's
shards where the inputs are DTensors (``sharding.local_call``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import ref
from repro_torch.models import layers as L

__all__ = ["decode_attention", "launches"]

#: CUDA launches of the decode-attention kernel made through
#: ``decode_attention``
launches = 0


def _meta_local(q, k_cache, v_cache, kv_pos, q_pos, G: int):
    """The kernel on meta tensors: an empty output and the counted work
    of the KV heads the query heads here need (``G`` query heads a KV
    head); where the cache is split along its ring, over this rank's
    slots, the output a partial sum of the ranks' (flash-decoding)."""
    from repro_torch.analysis import opcount, roofline
    B, H, hd = q.shape
    W = k_cache.shape[1]
    K = min(k_cache.shape[2], -(-H // G))
    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    opcount.add_kernel("decode_attention",
                       *roofline.decode_work(B, H, K, hd, W, W, dt))
    return torch.empty_like(q)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, q_pos: torch.Tensor,
                     kv_pos: torch.Tensor, window: int = 0,
                     rope_theta: float = 10000.0) -> torch.Tensor:
    """q: [B,1,H,hd] (before RoPE); k_cache / v_cache: [B,W,K,hd] (ring
    buffer); kv_pos: int32 [W] slot positions (-1 empty); q_pos: int32
    [1].  Returns [B,1,H,hd] in q's dtype."""
    global launches
    B, _, H, hd = q.shape
    W = k_cache.shape[1]
    q = L.rope(q, q_pos[None], rope_theta).reshape(B, H, hd).contiguous()
    kv_pos = kv_pos.to(torch.int32)
    q_pos = q_pos.reshape(-1).to(torch.int32)
    dev = q.device
    if dev.type == "cpu":
        out = ref.decode_ref(q, k_cache, v_cache,
                             kv_pos.expand(B, W), q_pos.expand(B),
                             window=window)
    elif dev.type == "cuda":
        from repro_torch.kernels.paged_attention import kernel
        out = kernel.decode_attention(q, k_cache, v_cache, kv_pos,
                                      q_pos.contiguous(), window=window)
        launches += 1
    elif dev.type == "meta":
        from repro_torch.sharding import local_call
        G = H // k_cache.shape[2]
        out = local_call(
            lambda *a: _meta_local(*a, G),
            (q, k_cache, v_cache, kv_pos, q_pos),
            ((0, 1), (0, 2, 1), (0, 2, 1), (None, None, 0), (None, None)),
            ((0, 1),))
    else:
        raise ValueError(f"decode_attention runs on CPU or CUDA, not {dev}")
    return out.reshape(B, 1, H, hd)
