"""Decoder-only LM: the dense, moe, ssm and hybrid families (port of
``repro.models.lm``; the encdec family is ``models/encdec.py`` on the
same ``LM`` container).

* The layers are an ``nn.ModuleList`` (``repro`` stacks them on a
  ``layers`` axis under ``lax.scan``); each layer's parameters keep
  ``repro``'s tree of names (``layer["attn"]["wq"]``, ...).
* Dense: prefill runs every layer's attention through the
  flash-attention kernel and packs the last ``W`` keys and values of
  each layer into a ring-buffer cache; decode writes one slot per layer
  and attends over the ring through the decode-attention kernel.  Slot
  positions are explicit (``kv_pos``, -1 = empty), one row per layer
  shared by the batch.
* ssm (falcon-mamba): a layer is ``norm1`` + the mamba block, no MLP.
  Prefill runs the block's selective scan through the ssm_scan kernel
  (one launch per layer and 256-step chunk) and keeps each layer's
  conv state and ``h``; decode advances them one token, in place.
* moe (mixtral, phi3.5-moe): the dense layer with ``layers.moe_apply``
  in place of the MLP; ``forward`` sums its aux loss over the layers.
* hybrid (recurrentgemma): every layer holds the union set, ``attn`` and
  ``rec`` (``repro`` selects the mixer with ``lax.cond`` on a static
  type vector; here a Python branch on ``layer_types``).  Attention
  layers use the local window ``cfg.local_window``; the cache holds a
  ring of ``min(max_len, local_window)`` slots and an RG-LRU state for
  every layer, and each layer writes only its own kind (a rec layer's
  ring stays zero with ``kv_pos = -1``, an attn layer's state stays at
  ``rglru_init_state``), as ``repro``'s two branches leave them.
* ``cache["pos"]`` is one int32 scalar for the whole batch.  On CUDA
  tensors the kernels launch, on CPU tensors their plain versions run
  (``repro``'s ``RunFlags(attn_impl="pallas", ssm_impl="pallas")``);
  there is no ``RunFlags``.  The activations are bf16 whatever the
  parameter dtype, as in ``repro``.
* Training: ``loss_fn`` (causal-LM cross entropy plus 0.01 times the
  MoE aux loss) over ``forward(..., remat=True)``, each layer under
  ``torch.utils.checkpoint`` (``repro``'s ``RunFlags(remat="layer")``:
  a layer's activations are recomputed in the backward pass), and
  ``chunked_ce``, whose 1 024-position chunks of logits are recomputed
  in backward too.  The parameters carry ``requires_grad=False``; the
  train step (``launch/steps.py``) turns it on for its backward pass.
  On the card attention's backward runs the flash kernel's backward
  entries; ``ssm_scan`` and ``rglru_scan`` have no backward kernel yet
  and refuse a gradient there.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shd
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, abstract_tensor, resolve_device

__all__ = ["LM", "layer_types", "attn_window", "lm_defs", "lookup",
           "forward", "logits_fn", "grad_cast_bf16", "chunked_ce", "loss_fn",
           "init_cache", "CACHE_AXES", "cache_leaf", "prefill",
           "decode_step", "tree_of"]


def layer_types(cfg: ModelConfig) -> tuple:
    """Static per-layer mixer type: 'attn' | 'rec' | 'ssm'."""
    if cfg.family == "ssm":
        return ("ssm",) * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.layer_pattern or ("rec",)
        return tuple(pat[i % len(pat)] for i in range(cfg.n_layers))
    return ("attn",) * cfg.n_layers


def attn_window(cfg: ModelConfig) -> int:
    """The attention window: the local window of a hybrid, else
    ``attn_window`` (0: none)."""
    return cfg.local_window if cfg.family == "hybrid" else cfg.attn_window


def lm_defs(cfg: ModelConfig):
    """Full model ParamDef tree, one tree per layer in ``layers`` (a
    hybrid's layers hold the union set, ``attn`` and ``rec``)."""
    d, v = cfg.d_model, cfg.vocab_padded
    types = set(layer_types(cfg))
    layer: dict[str, Any] = {"norm1": L.norm_defs(cfg)}
    if "attn" in types:
        layer["attn"] = L.attention_defs(cfg)
    if "rec" in types:
        layer["rec"] = R.rglru_defs(cfg)
    if "ssm" in types:
        layer["ssm"] = SSM.ssm_defs(cfg)
    if cfg.family != "ssm":
        layer["norm2"] = L.norm_defs(cfg)
        if cfg.family == "moe":
            layer["moe"] = L.moe_defs(cfg)
        else:
            layer["mlp"] = L.mlp_defs(cfg)
    out: dict[str, Any] = {
        "embed": ParamDef((v, d), ("vocab", "embed"), scale=1.0),
        "layers": [layer] * cfg.n_layers,
        "final_norm": L.norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((d, v), ("embed", "vocab"))
    return out


def _module(tree: dict) -> nn.Module:
    """Nested dict of tensors -> ``ModuleDict`` of ``ParameterDict``s."""
    if all(isinstance(t, torch.Tensor) for t in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                                 for k, t in tree.items()})
    return nn.ModuleDict({k: _module(t) for k, t in tree.items()})


def tree_of(m, data: bool = True) -> dict:
    """The nested dict of tensors a ``_module`` holds (the parameters'
    ``data``, or with ``data=False`` the ``nn.Parameter`` objects)."""
    if isinstance(m, nn.ParameterDict):
        return {k: (t.data if data else t) for k, t in m.items()}
    return {k: tree_of(t, data) for k, t in m.items()}


class LM(nn.Module):
    """The parameters of a model, one attribute per key of its ParamDef
    tree: a tensor as a parameter (``embed`` [V, d], ``head`` [d, V]), a
    list of layer trees as an ``nn.ModuleList`` of ``ModuleDict``s
    (``layers``; ``enc_layers`` / ``dec_layers`` of an encoder-decoder),
    a tree as a ``ModuleDict`` (``final_norm``).  ``head`` is None with
    tied embeddings."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self._keys = tuple(tree)
        for key, t in tree.items():
            if isinstance(t, torch.Tensor):
                setattr(self, key, nn.Parameter(t, requires_grad=False))
            elif isinstance(t, list):
                setattr(self, key, nn.ModuleList(_module(x) for x in t))
            else:
                setattr(self, key, _module(t))
        if "head" not in tree:
            self.head = None

    def tree(self, data: bool = True) -> dict:
        """The parameters as the ParamDef tree's tree of tensors (with
        ``data=False`` the ``nn.Parameter`` objects themselves, which the
        train step differentiates and updates in place)."""
        out = {}
        for key in self._keys:
            m = getattr(self, key)
            if isinstance(m, nn.Parameter):
                out[key] = m.data if data else m
            elif isinstance(m, nn.ModuleList):
                out[key] = [tree_of(x, data) for x in m]
            else:
                out[key] = tree_of(m, data)
        return out


def lookup(model: LM, tokens) -> torch.Tensor:
    """The bf16 embeddings of ``tokens``.  Under a mesh the table is
    looked up whole along its vocab and split along its width over the
    ``hidden`` axis (a lookup into a vocab-split table leaves partial
    sums whose backward DTensor cannot take, and a width split over the
    batch's axis would gather the batch)."""
    table = shd.shard(model.embed, None, "hidden")
    return F.embedding(tokens, table).to(torch.bfloat16)


def _embed(model: LM, tokens, prefix_embeds=None) -> torch.Tensor:
    x = lookup(model, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _ffn_block(lp, x, cfg: ModelConfig):
    """``x`` plus the MLP (or MoE) of ``norm2(x)``; returns ``(x, the MoE
    aux loss or None)``."""
    h = L.norm_apply(lp["norm2"], x, cfg)
    if cfg.family == "moe":
        y, aux = L.moe_apply(lp["moe"], h, cfg)
        return x + y, aux
    return x + L.mlp_apply(lp["mlp"], h, cfg), None


def _layer(lp, kind: str, x, cfg: ModelConfig):
    """One layer of the trunk: ``(x, the MoE aux loss or None)``."""
    h = L.norm_apply(lp["norm1"], x, cfg)
    if kind == "ssm":
        return x + SSM.ssm_block_apply(lp["ssm"], h, cfg), None
    if kind == "rec":
        y = R.rglru_block_apply(lp["rec"], h, cfg)
    else:
        y, _ = L.attention_apply(lp["attn"], h, cfg, causal=True,
                                 window=attn_window(cfg))
    return _ffn_block(lp, x + y, cfg)


def remat_layer(fn, x):
    """``fn(x)`` with its activations recomputed in the backward pass
    (``repro``'s ``jax.checkpoint`` of a layer)."""
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)


def forward(model: LM, tokens, cfg: ModelConfig, prefix_embeds=None,
            remat: bool = False):
    """Trunk forward.  tokens: [B, S_tok]; prefix_embeds: [B, P, d] stub
    frontend output, prepended to the token embeddings.  Returns hidden
    states [B, S, d] and the aux-loss scalar (the MoE layers' sum; 0 for
    the other families).  ``remat``: each layer under
    ``torch.utils.checkpoint``."""
    x = shd.shard(_embed(model, tokens, prefix_embeds), "batch", "seq", None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in zip(model.layers, layer_types(cfg)):
        if remat:
            def body(x, lp=lp, kind=kind):
                y, a = _layer(lp, kind, x, cfg)
                return y, (a if a is not None else torch.zeros_like(aux))
            x, a = remat_layer(body, x)
        else:
            x, a = _layer(lp, kind, x, cfg)
        x = shd.shard(x, "batch", "seq", None)
        if a is not None and cfg.family == "moe":
            aux = aux + a
    x = L.norm_apply(model.final_norm, x, cfg)
    return x, aux


def logits_fn(model: LM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    head = model.embed.T if cfg.tie_embeddings else model.head
    logits = x @ head.to(x.dtype)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab_size
        logits = logits + torch.where(pad, -1e30, 0.0).to(logits.dtype)
    return shd.shard(logits, "batch", "seq", "vocab")


class _GradCastBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def grad_cast_bf16(x: torch.Tensor) -> torch.Tensor:
    """Identity whose cotangent is cast to bf16 and back (``repro``'s
    ``custom_vjp``): the f32 cross entropy's cotangents enter the trunk's
    backward pass at bf16 precision."""
    return _GradCastBF16.apply(x)


def _chunk_nll(model: LM, cfg: ModelConfig, xc, tc, mc):
    """The masked f32 NLL sum of one chunk: logits from the head, f32
    ``logsumexp`` minus the gold logit."""
    logits = logits_fn(model, xc, cfg).float()
    logz = shd.logsumexp_last(logits)
    gold = shd.pick_last(logits, tc)
    return torch.sum((logz - gold) * mc)


def chunked_ce(model: LM, x, targets, mask, cfg: ModelConfig,
               chunk: int = 1024):
    """Mean masked cross entropy over sequence chunks of ``chunk``
    positions: each chunk's ``[B, chunk, vocab]`` logits live only while
    its sum is taken and are recomputed in backward
    (``torch.utils.checkpoint``), so the full logits tensor never exists.
    The chunk sums and token counts add up in f32 in chunk order.
    ``repro`` pads the last chunk with masked zero rows; here it is
    short (the padding adds zeros)."""
    S = x.shape[1]
    x = grad_cast_bf16(x)
    mask = mask.to(torch.float32)
    nll = n_tok = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        part = checkpoint(_chunk_nll, model, cfg, x[:, sl], targets[:, sl],
                          mask[:, sl], use_reentrant=False,
                          preserve_rng_state=False)
        nll = nll + part
        n_tok = n_tok + torch.sum(mask[:, sl])
    return nll / torch.clamp(n_tok, min=1.0)


def loss_fn(model: LM, batch: dict, cfg: ModelConfig, remat: bool = True):
    """Causal-LM cross entropy plus ``0.01 *`` the MoE aux loss; batch
    keys: ``tokens``, ``targets``, (``mask``), (``prefix_embeds``, whose
    positions are sliced off before the loss).  Returns ``(loss, {"nll",
    "aux"})``."""
    prefix = batch.get("prefix_embeds")
    x, aux = forward(model, batch["tokens"], cfg, prefix_embeds=prefix,
                     remat=remat)
    if prefix is not None:
        x = x[:, prefix.shape[1]:]
    targets = batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    loss = chunked_ce(model, x, targets, mask, cfg)
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


# ------------------------------------------------------------------ serving

#: logical axes of each decode-cache leaf, a nested leaf by its key path
#: (``repro``'s ``zoo._CACHE_AXES``; the encdec cache's too)
CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "kv_pos": ("layers", "kv_seq"),
    "xk": ("layers", "batch", "seq", "kv_heads", None),
    "xv": ("layers", "batch", "seq", "kv_heads", None),
    "pos": (),
    ("rec", "conv"): ("layers", "batch", None, "hidden"),
    ("rec", "h"): ("layers", "batch", "hidden"),
    ("ssm", "conv"): ("layers", "batch", None, "hidden"),
    ("ssm", "ssm"): ("layers", "batch", "hidden", "state"),
}


def cache_leaf(device):
    """``leaf(path, shape, dtype, fill)``: a cache leaf filled with
    ``fill`` on ``device``; on the meta device with a mesh active (the
    dry run) a DTensor over meta shards placed by ``CACHE_AXES[path]``
    (``params.abstract_tensor``), so that no global cache is made."""
    placed = device.type == "meta" and shd.get_mesh() is not None

    def leaf(path: tuple, shape: tuple, dtype, fill):
        if placed:
            axes = CACHE_AXES[path if len(path) > 1 else path[0]]
            return abstract_tensor(shape, dtype, axes)
        return torch.full(shape, fill, dtype=dtype, device=device)

    return leaf


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Decode cache on ``device`` (CUDA unless named): the int32 scalar
    ``pos`` and, with attention layers, per layer a bf16 ring buffer of
    ``W = min(max_len, window)`` slots (``max_len`` without a window) and
    ``kv_pos`` [nl, W] (-1 = empty); ssm, ``{"ssm": {"conv": [nl, B,
    kc-1, di] bf16, "ssm": [nl, B, di, N] f32}}`` (no ring); hybrid, the
    ring and ``{"rec": {"conv": [nl, B, kc-1, d] bf16, "h": [nl, B, d]
    f32}}``, both for every layer.  On the meta device under a mesh the
    leaves are DTensors (``cache_leaf``)."""
    device = resolve_device(device)
    leaf = cache_leaf(device)
    nl = cfg.n_layers
    types = set(layer_types(cfg))
    cache: dict[str, Any] = {"pos": leaf(("pos",), (), torch.int32, 0)}
    if "attn" in types:
        K, hd = cfg.n_kv_heads, cfg.hd
        window = attn_window(cfg)
        W = min(max_len, window) if window else max_len
        for name in ("k", "v"):
            cache[name] = leaf((name,), (nl, batch, W, K, hd),
                               torch.bfloat16, 0)
        cache["kv_pos"] = leaf(("kv_pos",), (nl, W), torch.int32, -1)
    # the recurrent states start at zero: each layer's, stacked
    for kind, init in (("rec", R.rglru_init_state),
                       ("ssm", SSM.ssm_init_state)):
        if kind in types:
            cache[kind] = {k: leaf((kind, k), (nl,) + tuple(v.shape),
                                   v.dtype, 0)
                           for k, v in init(cfg, batch, "meta").items()}
    return cache


def _ring_write(dst, src, shift: int, dim: int) -> None:
    """Write ``src`` into the ring ``dst`` along ``dim``: element ``j`` to
    slot ``(j + shift) mod W`` (a full ring: ``src`` rolled, one copy; a
    shorter ``src`` starts at slot 0, ``shift`` 0).  Copies, not an
    indexed scatter, so that a cache split along its slots (the dry run's
    DTensors) takes the write too."""
    n = src.shape[dim]
    if n == dst.shape[dim]:
        dst.copy_(torch.roll(src, shift, dim) if shift else src)
    else:
        dst.narrow(dim, 0, n).copy_(src)


def prefill(model: LM, tokens, cfg: ModelConfig, max_len: int,
            prefix_embeds=None):
    """Run the prompt through the trunk and build the decode cache: each
    attention layer's last ``min(W, S)`` keys and values in ring order,
    each recurrent layer's exact conv state and ``h`` after the last
    token (ssm and rec layers; the prompt needs ``ssm_conv - 1`` tokens or
    more).  Returns ``(logits of the last position [B, V], cache)``."""
    x = shd.shard(_embed(model, tokens, prefix_embeds), "batch", "seq", None)
    B, Sq = x.shape[0], x.shape[1]
    dev = x.device
    cache = init_cache(cfg, B, max_len, device=dev)
    cache["pos"] = torch.tensor(Sq, dtype=torch.int32, device=dev)
    if "k" in cache:
        W = cache["k"].shape[2]
        take = min(W, Sq)
        pos = torch.arange(Sq - take, Sq, dtype=torch.int32, device=dev)
        # position p goes to slot p mod W: the kept run, rolled by the
        # slot of its first position
        shift = (Sq - take) % W
    for i, (lp, kind) in enumerate(zip(model.layers, layer_types(cfg))):
        h = L.norm_apply(lp["norm1"], x, cfg)
        if kind == "ssm":
            y, st = SSM.ssm_block_apply(lp["ssm"], h, cfg, return_state=True)
            cache["ssm"]["conv"][i] = st["conv"]
            cache["ssm"]["ssm"][i] = st["ssm"]
            x = shd.shard(x + y, "batch", "seq", None)
            continue
        if kind == "rec":
            y, st = R.rglru_block_apply(lp["rec"], h, cfg, return_state=True)
            cache["rec"]["conv"][i] = st["conv"]
            cache["rec"]["h"][i] = st["h"]
        else:
            y, (k, v) = L.attention_apply(lp["attn"], h, cfg, causal=True,
                                          window=attn_window(cfg))
            _ring_write(cache["k"][i], k[:, Sq - take:], shift, 1)
            _ring_write(cache["v"][i], v[:, Sq - take:], shift, 1)
            _ring_write(cache["kv_pos"][i], pos, shift, 0)
        x = shd.shard(_ffn_block(lp, x + y, cfg)[0], "batch", "seq", None)
    x = L.norm_apply(model.final_norm, x, cfg)
    return logits_fn(model, x[:, -1:], cfg)[:, 0], cache


def decode_step(model: LM, cache: dict, tokens, cfg: ModelConfig):
    """One decode step.  tokens: [B] int.  Returns ``(logits [B, V], new
    cache)``.

    Writes the cache IN PLACE: each attention layer's new key, value and
    slot position go into ``cache["k"]`` / ``["v"]`` / ``["kv_pos"]``;
    each ssm or rec layer's new conv state and ``h`` overwrite its row of
    ``cache["ssm"]`` / ``cache["rec"]`` (no copy of the cache a step,
    where ``repro`` returns an updated one).  The returned dict shares
    those tensors and holds a new ``pos``.  A caller that needs the old
    cache again clones it first."""
    x = shd.shard(_embed(model, tokens)[:, None, :],       # [B, 1, d]
                  "batch", None, None)
    pos = cache["pos"]
    for i, (lp, kind) in enumerate(zip(model.layers, layer_types(cfg))):
        h = L.norm_apply(lp["norm1"], x, cfg)
        if kind == "ssm":
            conv, hs = cache["ssm"]["conv"], cache["ssm"]["ssm"]
            y, st = SSM.ssm_decode_step(lp["ssm"], h, {"conv": conv[i],
                                                       "ssm": hs[i]}, cfg)
            conv[i] = st["conv"]
            hs[i] = st["ssm"]
            x = x + y
            continue
        if kind == "rec":
            conv, hs = cache["rec"]["conv"], cache["rec"]["h"]
            y, st = R.rglru_decode_step(lp["rec"], h, {"conv": conv[i],
                                                       "h": hs[i]}, cfg)
            conv[i] = st["conv"]
            hs[i] = st["h"]
        else:
            y = _cached_attention(lp["attn"], h, cache, i, cfg, pos)
        x = _ffn_block(lp, x + y, cfg)[0]
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    x = L.norm_apply(model.final_norm, x, cfg)
    return logits_fn(model, x, cfg)[:, 0], new_cache


def _cached_attention(p, h, cache: dict, i: int, cfg: ModelConfig, pos):
    """Decode attention of layer ``i`` against its ring-buffer cache,
    after writing this step's key, value and position into slot
    ``pos mod W``.  The query is rotated once, by the decode kernel's
    dispatch (``repro``'s pallas path)."""
    B = h.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ck, cv, cpos = cache["k"][i], cache["v"][i], cache["kv_pos"][i]
    W = ck.shape[1]
    kq = shd.split_last(h @ p["wk"].to(h.dtype), (B, 1, K, hd),
                        "batch", None, "kv_heads", None)
    vq = shd.split_last(h @ p["wv"].to(h.dtype), (B, 1, K, hd),
                        "batch", None, "kv_heads", None)
    kq = L.rope(kq, pos[None, None], cfg.rope_theta)
    slot = torch.remainder(pos, W).reshape(1).long()
    shd.index_copy_(ck, 1, slot, kq.to(ck.dtype))
    shd.index_copy_(cv, 1, slot, vq.to(cv.dtype))
    shd.index_copy_(cpos, 0, slot, pos.reshape(1))
    q = shd.split_last(h @ p["wq"].to(h.dtype), (B, 1, H, hd),
                       "batch", None, "heads", None)
    out = pa_ops.decode_attention(q, ck, cv, q_pos=pos.reshape(1),
                                  kv_pos=cpos, window=attn_window(cfg),
                                  rope_theta=cfg.rope_theta)
    y = shd.merge_last(out, "batch", None, "heads", None) @ p["wo"].to(
        h.dtype)
    return shd.shard(y, "batch", None, None)
