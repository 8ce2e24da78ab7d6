"""Step assembly (port of ``repro.launch.steps``): the train step
(microbatched loss and gradients, global-norm clipping, AdamW) and the
serving steps.

``make_train_step`` returns ``train_step(model, opt_state, batch) ->
(opt_state, metrics)``.  ``repro``'s step is pure and returns new
parameters; here the new bf16 parameters are written into the model in
place (``torch.no_grad``, ``copy_``), so that ``LM``'s parameter names
and the tensors a caller holds stay valid.  The gradients come from
``torch.autograd.grad`` over the model's parameters, whose
``requires_grad`` is on only for the backward pass.
"""

from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch.models import zoo
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adamw

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "TRAIN_PER_DEVICE_MICROBATCH", "TRAIN_ACCUM_DTYPE",
           "accum_dtype_for", "dp_degree", "microbatches_for"]


def _grads(model, batch: dict, cfg: ModelConfig, params: list):
    """``(loss, grads in params' order)``: one forward and backward pass
    of ``zoo.loss_fn``; a parameter the loss does not reach gets zeros
    (``repro``'s ``value_and_grad`` gives zeros there too)."""
    with torch.enable_grad():
        for p in params:
            p.requires_grad_(True)
        try:
            loss, _ = zoo.loss_fn(model, batch, cfg)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            for p in params:
                p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1,
                    grad_accum_dtype: torch.dtype = torch.float32):
    """-> ``train_step(model, opt_state, batch) -> (opt_state, metrics)``
    with metrics ``loss``, ``grad_norm`` and ``lr`` (f32 scalars on the
    model's device).  With ``microbatches > 1`` every batch tensor is
    split along its first dim as ``x.reshape((mb, B // mb) + ...)``, the
    microbatches' gradients are summed in ``grad_accum_dtype`` in order,
    and the step takes ``(sum / mb).to(f32)`` and the mean loss."""

    def train_step(model, opt_state: adamw.OptState, batch: dict):
        tree = model.tree(data=False)
        params = adamw.leaves(tree)
        if microbatches == 1:
            loss, grads = _grads(model, batch, cfg, params)
        else:
            mbs = {k: shd.split_leading(v, microbatches)
                   for k, v in batch.items()}
            g_acc = [torch.zeros_like(p, dtype=grad_accum_dtype)
                     for p in params]
            l_acc = torch.zeros((), dtype=torch.float32,
                                device=params[0].device)
            for i in range(microbatches):
                l, g = _grads(model, {k: v[i] for k, v in mbs.items()}, cfg,
                              params)
                g_acc = [a + b.to(grad_accum_dtype) for a, b in zip(g_acc, g)]
                l_acc = l_acc + l
            grads = [(g / microbatches).to(torch.float32) for g in g_acc]
            loss = l_acc / microbatches
        data = adamw.unflatten(tree, [p.detach() for p in params])
        new_params, new_opt, opt_metrics = adamw.update(
            opt_cfg, adamw.unflatten(tree, grads), opt_state, data)
        with torch.no_grad():
            for p, new in zip(params, adamw.leaves(new_params)):
                p.copy_(new)
        return new_opt, {"loss": loss, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(model, batch):
        return zoo.prefill_fn(model, batch, cfg, max_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: logits -> next token (argmax, ties to the
    first index) -> the cache, updated in place."""
    def serve_step(model, cache, tokens):
        logits, new_cache = zoo.decode_fn(model, cache, tokens, cfg)
        # the vocab split gathered first (a no-op off a mesh): DTensor's
        # argmax over a split dim fails on a one-row batch
        logits = shd.shard(logits, "batch", None)
        return torch.argmax(logits, -1).to(torch.int32), new_cache
    return serve_step


#: Per-arch target per-device batch per microbatch for train_4k
#: (``repro``'s table: chosen there so remat residuals fit a v5e chip's
#: HBM next to parameters and optimizer state).  The microbatch count
#: adapts to the data-parallel degree.
TRAIN_PER_DEVICE_MICROBATCH = {
    "phi4-mini-3.8b": 4,
    "granite-34b": 1,
    "phi3-medium-14b": 1,
    "tinyllama-1.1b": 8,
    "recurrentgemma-2b": 8,
    "whisper-small": 8,
    "falcon-mamba-7b": 1,
    "mixtral-8x22b": 1,
    "phi3.5-moe-42b-a6.6b": 1,
    "pixtral-12b": 1,
}

#: Archs that accumulate microbatch gradients in bf16 (``repro``'s
#: table)
TRAIN_ACCUM_DTYPE = {
    "mixtral-8x22b": torch.bfloat16,
}


def accum_dtype_for(cfg: ModelConfig) -> torch.dtype:
    return TRAIN_ACCUM_DTYPE.get(cfg.name, torch.float32)


def dp_degree(mesh=None) -> int:
    """Product of the batch-carrying mesh axes' sizes (``pod`` x
    ``data``) of ``mesh`` (default: the active mesh,
    ``sharding.get_mesh``); 1 without a mesh.  ``mesh`` is a
    ``DeviceMesh`` or anything with a ``shape`` mapping of axis names to
    sizes."""
    mesh = shd.get_mesh() if mesh is None else mesh
    if mesh is None:
        return 1
    shape = shd.axis_sizes(mesh)
    return int(shape.get("pod", 1) * shape.get("data", 1))


def microbatches_for(cfg: ModelConfig, shape: ShapeConfig,
                     mesh=None) -> int:
    if shape.kind != "train":
        return 1
    dp = dp_degree(mesh)
    per_dev = TRAIN_PER_DEVICE_MICROBATCH.get(cfg.name, 4)
    mb = max(1, shape.global_batch // max(dp * per_dev, 1))
    while shape.global_batch % (mb * dp) and mb > 1:
        mb -= 1  # keep microbatches evenly dp-shardable
    return mb
