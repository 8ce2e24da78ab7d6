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

Meta tensors (the dry run, ``launch/dryrun.py``) launch nothing: the
call returns an empty output of the kernel's shape and dtype and adds
the kernel's work (``analysis.roofline.flash_work``, and
``flash_bwd_work`` in its backward) to the active op counter, on each
rank's shards where the inputs are DTensors over meta shards
(``sharding.local_call``: batch and head splits kept, anything
else gathered first).
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


class _MetaFlashFn(torch.autograd.Function):
    """The kernel on meta tensors: its shapes and its counted work
    (forward, and the backward's), no launch.  ``G`` is the query heads
    a KV head serves: where only some query heads are here (a rank's
    split of them), the call reads the KV heads they need.  Saves what
    ``FlashAttentionFn`` saves (q, k, v, o and the training entry's one
    f32 buffer of the LSE and the output's low halves) so that a memory
    count sees it."""

    @staticmethod
    def _shape(q, k, G: int) -> tuple:
        B, S, H, hd = q.shape
        return B, S, k.shape[1], H, min(k.shape[2], -(-H // G)), hd

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, G: int):
        from repro_torch.analysis import opcount, roofline
        B, S, Skv, H, K, hd = _MetaFlashFn._shape(q, k, G)
        dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
        opcount.add_kernel("flash_attention", *roofline.flash_work(
            B, S, H, K, hd, causal, window, dt, Skv))
        o = torch.empty_like(q)
        if any(ctx.needs_input_grad[:3]):
            from repro_torch.kernels.flash_attention.kernel import lse_rows
            buf = q.new_empty((B * H * lse_rows(S) + B * S * H * hd // 2,),
                              dtype=torch.float32)
            ctx.save_for_backward(q, k, v, o, buf)
        ctx.mask = (causal, window, G)
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.analysis import opcount, roofline
        q, k, v, _, _ = ctx.saved_tensors
        causal, window, G = ctx.mask
        B, S, Skv, H, K, hd = _MetaFlashFn._shape(q, k, G)
        opcount.add_kernel("flash_attention_bwd", *roofline.flash_bwd_work(
            B, S, Skv, H, K, hd, causal, window))
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None, None, None)


def _meta(q, k, v, causal: bool, window: int):
    from repro_torch.sharding import local_call
    G = q.shape[2] // k.shape[2]
    return local_call(
        lambda q, k, v: _MetaFlashFn.apply(q, k, v, causal, window, G),
        (q, k, v), ((0, 2),) * 3, ((0, 2),))


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
    if dev.type == "meta":
        return _meta(q, k, v, causal, window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA, not {dev}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    from repro_torch.kernels.flash_attention import kernel
    out = kernel.flash_attention(q, k, v, causal=causal, window=window)
    launches += 1
    return out
