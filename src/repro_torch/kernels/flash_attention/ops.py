"""Model-layout flash attention, dispatched by device (port of
``repro.kernels.flash_attention.ops``).

CPU tensors run the plain version (``ref.flash_attention_ref``), CUDA
tensors launch the CUDA kernel (``kernel.flash_attention``), and a
failed build or launch raises; nothing falls back from one to the
other.  Like the Pallas kernel, both mask by the positions
``arange(S)`` / ``arange(Skv)`` (self-attention, as prefill calls it);
the wrapper takes no positions, so none can say otherwise.

Gradients.  On CPU tensors autograd differentiates the plain version.
On CUDA tensors, when grad mode is on and an input requires grad, the
call goes through ``FlashAttentionFn``: its forward launches the
forward kernel's LSE entry (``kernel.flash_attention_lse``, which also
writes the output's low halves, so that the backward's D comes from the
f32 output) and its backward the three backward entries, and where a
KV head serves several query heads the sum of their partials (bf16, hd
<= 256; anything else raises rather than dropping the gradient).
Otherwise the serving forward launches as before.  Counters:
``launches`` (forward, either entry; a remat recomputation counts
again), ``bwd_dot_launches``, ``bwd_dkdv_launches``, ``bwd_sum_launches``,
``bwd_dq_launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref

__all__ = ["flash_attention", "FlashAttentionFn", "launches",
           "bwd_dot_launches", "bwd_dkdv_launches", "bwd_sum_launches",
           "bwd_dq_launches"]

#: CUDA launches of the flash-attention kernel made through
#: ``flash_attention`` (the serving entry or the training entry)
launches = 0
#: CUDA launches of the backward's three entries and of the group sum
bwd_dot_launches = 0
bwd_dkdv_launches = 0
bwd_sum_launches = 0
bwd_dq_launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel with its backward kernels, on CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        global launches
        from repro_torch.kernels.flash_attention import kernel
        o, lse, o_lo = kernel.flash_attention_lse(q, k, v, causal=causal,
                                                  window=window)
        launches += 1
        ctx.save_for_backward(q, k, v, o, lse, o_lo)
        ctx.mask = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        global bwd_dot_launches, bwd_dkdv_launches, bwd_sum_launches
        global bwd_dq_launches
        from repro_torch.kernels.flash_attention import kernel
        q, k, v, o, lse, o_lo = ctx.saved_tensors
        causal, window = ctx.mask
        do = do.contiguous()
        dlt = kernel.flash_attention_bwd_dot(o, o_lo, do, lse.shape[-1])
        bwd_dot_launches += 1
        dk, dv, summed = kernel.flash_attention_bwd_dkdv(
            q, k, v, do, lse, dlt, causal=causal, window=window)
        bwd_dkdv_launches += 1
        bwd_sum_launches += summed
        dq = kernel.flash_attention_bwd_dq(q, k, v, do, lse, dlt,
                                           causal=causal, window=window)
        bwd_dq_launches += 1
        return dq, dk, dv, None, None


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    from repro_torch.kernels.flash_attention import kernel
    out = kernel.flash_attention(q, k, v, causal=causal, window=window)
    launches += 1
    return out
