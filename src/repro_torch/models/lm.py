"""Decoder-only LM, dense and ssm families (port of ``repro.models.lm``).

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
* ``cache["pos"]`` is one int32 scalar for the whole batch.  On CUDA
  tensors the kernels launch, on CPU tensors their plain versions run
  (``repro``'s ``RunFlags(attn_impl="pallas", ssm_impl="pallas")``);
  there is no ``RunFlags``.  The activations are bf16 whatever the
  parameter dtype, as in ``repro``.
* The other families raise ``NotImplementedError``: they come with later
  slices of the port.  So do ``loss_fn``, ``chunked_ce`` and
  ``grad_cast_bf16`` (training).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, resolve_device

__all__ = ["LM", "layer_types", "lm_defs", "forward", "logits_fn",
           "init_cache", "prefill", "decode_step", "tree_of"]

#: the families the port runs
PORTED = ("dense", "ssm")
#: where each family that is not ported yet comes in (ROADMAP.md)
LATER_SLICES = {
    "hybrid": "the recurrentgemma slice (models/rglru.py)",
    "moe": "the MoE slice (layers.moe_apply)",
    "encdec": "the whisper slice (models/encdec.py)",
}


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to "
            f"repro_torch yet; it comes with {LATER_SLICES[cfg.family]}")


def layer_types(cfg: ModelConfig) -> tuple:
    """Static per-layer mixer type: 'attn' | 'rec' | 'ssm'."""
    if cfg.family == "ssm":
        return ("ssm",) * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.layer_pattern or ("rec",)
        return tuple(pat[i % len(pat)] for i in range(cfg.n_layers))
    return ("attn",) * cfg.n_layers


def lm_defs(cfg: ModelConfig):
    """Full model ParamDef tree, one tree per layer in ``layers``."""
    require_ported(cfg)
    d, v = cfg.d_model, cfg.vocab_padded
    if cfg.family == "ssm":
        layer = {"norm1": L.norm_defs(cfg), "ssm": SSM.ssm_defs(cfg)}
    else:
        layer = {"norm1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
                 "norm2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}
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


def tree_of(m) -> dict:
    """The nested dict of tensors a ``_module`` holds."""
    if isinstance(m, nn.ParameterDict):
        return {k: t.data for k, t in m.items()}
    return {k: tree_of(t) for k, t in m.items()}


class LM(nn.Module):
    """The parameters of a decoder-only LM: ``embed`` [V, d], ``layers``
    (one ``ModuleDict`` per layer: norm1, attn, norm2, mlp; or norm1, ssm),
    ``final_norm`` and ``head`` [d, V] (None with tied embeddings)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        require_ported(cfg)
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.layers = nn.ModuleList(_module(t) for t in tree["layers"])
        self.final_norm = _module(tree["final_norm"])
        self.head = (nn.Parameter(tree["head"], requires_grad=False)
                     if "head" in tree else None)

    def tree(self) -> dict:
        """The parameters as ``lm_defs``' tree of tensors."""
        out = {"embed": self.embed.data,
               "layers": [tree_of(lp) for lp in self.layers],
               "final_norm": tree_of(self.final_norm)}
        if self.head is not None:
            out["head"] = self.head.data
        return out


def _embed(model: LM, tokens, prefix_embeds=None) -> torch.Tensor:
    x = F.embedding(tokens, model.embed).to(torch.bfloat16)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _mlp_block(lp, x, cfg: ModelConfig) -> torch.Tensor:
    return x + L.mlp_apply(lp["mlp"], L.norm_apply(lp["norm2"], x, cfg), cfg)


def forward(model: LM, tokens, cfg: ModelConfig, prefix_embeds=None):
    """Trunk forward.  tokens: [B, S_tok]; prefix_embeds: [B, P, d] stub
    frontend output, prepended to the token embeddings.  Returns hidden
    states [B, S, d] and the aux-loss scalar (0 for these families)."""
    require_ported(cfg)
    x = _embed(model, tokens, prefix_embeds)
    for lp in model.layers:
        h = L.norm_apply(lp["norm1"], x, cfg)
        if cfg.family == "ssm":
            x = x + SSM.ssm_block_apply(lp["ssm"], h, cfg)
            continue
        y, _ = L.attention_apply(lp["attn"], h, cfg, causal=True,
                                 window=cfg.attn_window)
        x = _mlp_block(lp, x + y, cfg)
    x = L.norm_apply(model.final_norm, x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(model: LM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    head = model.embed.T if cfg.tie_embeddings else model.head
    logits = x @ head.to(x.dtype)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab_size
        logits = logits + torch.where(pad, -1e30, 0.0).to(logits.dtype)
    return logits


# ------------------------------------------------------------------ serving

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Decode cache on ``device`` (CUDA unless named): the int32 scalar
    ``pos`` and, dense, per layer a bf16 ring buffer of ``W =
    min(max_len, window)`` slots (``max_len`` without a window) and
    ``kv_pos`` [nl, W] (-1 = empty); ssm, ``{"ssm": {"conv": [nl, B,
    kc-1, di] bf16, "ssm": [nl, B, di, N] f32}}`` (no ring)."""
    require_ported(cfg)
    device = resolve_device(device)
    nl = cfg.n_layers
    cache: dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family == "ssm":
        st = SSM.ssm_init_state(cfg, batch, device)
        cache["ssm"] = {k: v[None].repeat(nl, *(1,) * v.dim())
                        for k, v in st.items()}
        return cache
    K, hd = cfg.n_kv_heads, cfg.hd
    window = cfg.attn_window
    W = min(max_len, window) if window else max_len
    cache["k"] = torch.zeros((nl, batch, W, K, hd), dtype=torch.bfloat16,
                             device=device)
    cache["v"] = torch.zeros_like(cache["k"])
    cache["kv_pos"] = torch.full((nl, W), -1, dtype=torch.int32,
                                 device=device)
    return cache


def prefill(model: LM, tokens, cfg: ModelConfig, max_len: int,
            prefix_embeds=None):
    """Run the prompt through the trunk and build the decode cache: each
    layer's last ``min(W, S)`` keys and values in ring order (dense), or
    its exact conv state and ``h`` after the last token (ssm; the prompt
    needs ``ssm_conv - 1`` tokens or more).  Returns ``(logits of the
    last position [B, V], cache)``."""
    require_ported(cfg)
    x = _embed(model, tokens, prefix_embeds)
    B, Sq = x.shape[0], x.shape[1]
    dev = x.device
    cache = init_cache(cfg, B, max_len, device=dev)
    cache["pos"] = torch.tensor(Sq, dtype=torch.int32, device=dev)
    if cfg.family == "ssm":
        conv, hs = cache["ssm"]["conv"], cache["ssm"]["ssm"]
        for i, lp in enumerate(model.layers):
            y, st = SSM.ssm_block_apply(lp["ssm"],
                                        L.norm_apply(lp["norm1"], x, cfg),
                                        cfg, return_state=True)
            conv[i] = st["conv"]
            hs[i] = st["ssm"]
            x = x + y
    else:
        q_pos = torch.arange(Sq, dtype=torch.int32, device=dev)
        W = cache["k"].shape[2]
        take = min(W, Sq)
        pos = q_pos[Sq - take:]
        slots = torch.remainder(pos, W).long()
        for i, lp in enumerate(model.layers):
            y, (k, v) = L.attention_apply(
                lp["attn"], L.norm_apply(lp["norm1"], x, cfg), cfg,
                causal=True, window=cfg.attn_window)
            cache["k"][i][:, slots] = k[:, Sq - take:]
            cache["v"][i][:, slots] = v[:, Sq - take:]
            cache["kv_pos"][i][slots] = pos
            x = _mlp_block(lp, x + y, cfg)
    x = L.norm_apply(model.final_norm, x, cfg)
    return logits_fn(model, x[:, -1:], cfg)[:, 0], cache


def decode_step(model: LM, cache: dict, tokens, cfg: ModelConfig):
    """One decode step.  tokens: [B] int.  Returns ``(logits [B, V], new
    cache)``.

    Writes the cache IN PLACE: dense, each layer's new key, value and
    slot position go into ``cache["k"]`` / ``["v"]`` / ``["kv_pos"]``;
    ssm, each layer's new conv state and ``h`` overwrite
    ``cache["ssm"]["conv"][i]`` / ``["ssm"][i]`` (no copy of the cache a
    step, where ``repro`` returns an updated one).  The returned dict
    shares those tensors and holds a new ``pos``.  A caller that needs
    the old cache again clones it first."""
    require_ported(cfg)
    x = _embed(model, tokens)[:, None, :]                   # [B, 1, d]
    pos = cache["pos"]
    for i, lp in enumerate(model.layers):
        h = L.norm_apply(lp["norm1"], x, cfg)
        if cfg.family == "ssm":
            conv, hs = cache["ssm"]["conv"], cache["ssm"]["ssm"]
            y, st = SSM.ssm_decode_step(lp["ssm"], h, {"conv": conv[i],
                                                       "ssm": hs[i]}, cfg)
            conv[i] = st["conv"]
            hs[i] = st["ssm"]
            x = x + y
            continue
        y = _cached_attention(lp["attn"], h, cache, i, cfg, pos)
        x = _mlp_block(lp, x + y, cfg)
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
    kq = (h @ p["wk"].to(h.dtype)).reshape(B, 1, K, hd)
    vq = (h @ p["wv"].to(h.dtype)).reshape(B, 1, K, hd)
    kq = L.rope(kq, pos[None, None], cfg.rope_theta)
    slot = torch.remainder(pos, W).reshape(1).long()
    ck.index_copy_(1, slot, kq.to(ck.dtype))
    cv.index_copy_(1, slot, vq.to(cv.dtype))
    cpos.index_copy_(0, slot, pos.reshape(1))
    q = (h @ p["wq"].to(h.dtype)).reshape(B, 1, H, hd)
    out = pa_ops.decode_attention(q, ck, cv, q_pos=pos.reshape(1),
                                  kv_pos=cpos, window=cfg.attn_window,
                                  rope_theta=cfg.rope_theta)
    return out.reshape(B, 1, H * hd) @ p["wo"].to(h.dtype)
