"""Model-layout flash attention, dispatched by device (port of
``repro.kernels.flash_attention.ops``).

CPU tensors run the plain version (``ref.flash_attention_ref``), CUDA
tensors launch the CUDA kernel (``kernel.flash_attention``), and a
failed build or launch raises; nothing falls back from one to the
other.  Like the Pallas kernel, both mask by the positions
``arange(S)`` / ``arange(Skv)`` (self-attention, as prefill calls it);
the wrapper takes no positions, so none can say otherwise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref

__all__ = ["flash_attention", "launches"]

#: CUDA launches of the flash-attention kernel made through
#: ``flash_attention``
launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,S,H,hd]; k, v: [B,Skv,K,hd] -> [B,S,H,hd] in q's dtype.

    Query i and key j sit at positions i and j.  A causal or window mask
    needs ``S == Skv``, so that every query row keeps a valid key; other
    lengths under a mask raise."""
    global launches
    S, Skv = q.shape[1], k.shape[1]
    if (causal or window) and S != Skv:
        raise ValueError(f"flash_attention: a causal or window mask needs "
                         f"S == Skv (got {S}, {Skv})")
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA, not {dev}")
    from repro_torch.kernels.flash_attention import kernel
    out = kernel.flash_attention(q, k, v, causal=causal, window=window)
    launches += 1
    return out
