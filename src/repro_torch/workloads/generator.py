"""Synthetic request-stream generation (port of
``repro.workloads.generator``).

The statistical model of ``traces.generate_trace`` (memory intensity,
row-hit runs, Zipf hot-set reuse, hot-bank concentration, streaming,
dependencies, read/write mix) over ``WorkloadParams`` / ``GeomParams`` /
``InterleaveParams`` tensors, batched over any leading grid dimensions:

* the reuse stack is a recency ring of the ``RECENT_RING`` most recent
  distinct rows plus a virtual popularity table whose entry ``j`` is
  re-derived on demand from the counter-based PRNG;
* hot banks are a strided walk ``(b0 + k * stride) mod banks_total``;
* each core owns the row slice ``[core * span, (core + 1) * span)`` of
  the point's geometry, ``span = n_rows // n_cores``;
* addresses leave the walk as logical ``(lb, row)`` pairs and are
  composed into physical banks by ``dram.compose_address``.

Every draw is vectorised over all steps up front; only the walk (the
branch sequencing and the ring updates) loops over steps, vectorised
over the batch and the cores.  The integer draws are bitwise
``repro``'s.  Two float32 draws go through ``log1p`` / ``exp``
(``_rank_pick`` and the gap); XLA's and PyTorch's float32
transcendentals differ by about one ulp, so where such a result lands
within an ulp of an integer the two packages can pick another rank or
gap.  Divisions are tensor by tensor, as the CUDA kernel computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dram as dram_lib
from repro_torch.core.dram import (DRAMConfig, DDR3_SYSTEM, GeomParams,
                                   InterleaveConfig, InterleaveParams,
                                   floordiv, geom_params, interleave_params)
from repro_torch.core.traces import Trace, TraceBatch, WorkloadSpec, _next_same
from repro_torch.workloads import prng
from repro_torch.workloads.profiles import FLOAT_LEAVES, WorkloadParams, spec_params

__all__ = ["generate", "materialize", "RECENT_RING"]

# PRNG lanes: one independent sub-stream per random quantity
(_L_HIT, _L_SEQ, _L_HOT, _L_PICK, _L_GAP, _L_WRITE, _L_DEP,
 _L_RBANK, _L_RROW, _L_HOTBANK, _L_HOTROW, _L_B0, _L_STRIDE,
 _L_PICK2) = prng.lanes(14)

_MAX_GAP = 1 << 20  # int32 cycle-horizon guard on the gap tail

#: recency-ring depth: stack ranks 1..RECENT_RING resolve to the most
#: recent distinct rows; deeper ranks fall back to the virtual table
RECENT_RING = 128

_I32 = torch.int32


def _umod(h, n):
    """uint32 hash (int64 in ``[0, 2**32)``) -> int32 uniform in
    ``[0, n)`` for a positive int32 ``n``."""
    return torch.remainder(h, torch.clamp(n, min=1).to(torch.int64)).to(_I32)


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _rank_pick(u, u_tail, w: WorkloadParams):
    """Hot-set rank from one uniform: the Pareto inverse-CDF tail of the
    Zipf exponent (``stack_zipf > 0``) or the geometric fallback; ranks
    past the table redraw uniformly over it (``u_tail``).  An ``exp``
    that overflows to ``inf`` is past the table too."""
    cap = torch.clamp(w.hot_rows - 1, min=0).to(torch.float32)
    one = _f32(1.0, u)
    a1 = torch.maximum(w.stack_zipf - one, _f32(1e-3, u))
    lu = torch.log1p(-u)
    zipf = torch.floor(torch.exp(torch.div(-lu, a1))) - one
    geo = torch.floor(torch.div(
        lu, torch.log1p(-torch.minimum(w.stack_geo, _f32(0.9999, u)))))
    j = torch.maximum(torch.where(w.stack_zipf > 0, zipf, geo),
                      _f32(0.0, u))
    uni = torch.floor(u_tail * w.hot_rows.to(torch.float32))
    j = torch.where(j > cap, uni, j)
    return torch.minimum(j, cap).to(_I32)


def _gen_cores(max_len: int, w: WorkloadParams, geom: GeomParams,
               il: InterleaveParams) -> dict:
    """Every core's stream.  ``w`` leaves are ``[..., C, S]`` /
    ``[..., C]``; ``geom`` / ``il`` leaves are ``[...]``."""
    dev = w.seed.device
    step = torch.arange(max_len, dtype=_I32, device=dev)
    col = lambda x: x[..., None]                 # [..., C] -> [..., C, 1]
    gcol = lambda x: x[..., None, None]          # [...] -> [..., 1, 1]
    geom = GeomParams(*(gcol(x) for x in geom))
    il = InterleaveParams(*(gcol(x) for x in il))
    key = (col(w.seed), col(w.core_idx))
    u = lambda lane, *extra: prng.uniform(*key, lane, *extra)
    h = lambda lane, *extra: prng.hash_u32(*key, lane, *extra)

    # active phase segment per step; padded segments start at 2**30
    seg = (step[:, None] >= w.seg_edge[..., None, :]).sum(
        dim=-1, dtype=_I32) - 1
    seg = seg.to(torch.int64)
    g = lambda leaf: leaf.gather(-1, seg)        # [..., C, S] -> [..., C, L]
    wv = w._replace(**{k: g(getattr(w, k)) for k in
                       FLOAT_LEAVES + ("hot_rows", "n_hot_banks")})

    # per-core row slice of the point's geometry
    span = torch.clamp(floordiv(geom.n_rows,
                                torch.clamp(col(w.n_cores), min=1)), min=1)
    base = col(w.core_idx) * span

    # hot-bank walk: n_hot_banks distinct-by-construction banks
    b0 = _umod(h(_L_B0), geom.banks_total)
    stride = 1 + 2 * _umod(h(_L_STRIDE),
                           torch.clamp(floordiv(geom.banks_total, 2), min=1))
    hot_lb = lambda k: torch.remainder(b0 + k * stride, geom.banks_total)
    nhb = torch.clamp(wv.n_hot_banks, min=1)
    nhb0 = torch.clamp(col(w.n_hot_banks[..., 0]), min=1)

    def hot_entry(j, nhb_k):
        lb = hot_lb(_umod(h(_L_HOTBANK, j), nhb_k))
        row = base + _umod(h(_L_HOTROW, j), span)
        return lb, row

    # candidate draws for every step
    j_pick = _rank_pick(u(_L_PICK, step), u(_L_PICK2, step), wv)
    lb_hot, row_hot = hot_entry(j_pick, nhb)
    lb_rand = hot_lb(_umod(h(_L_RBANK, step), nhb))
    row_rand = base + _umod(h(_L_RROW, step), span)
    hit_c = u(_L_HIT, step) < wv.p_rowhit
    seq_c = u(_L_SEQ, step) < wv.p_seq
    hot_c = u(_L_HOT, step) < wv.p_hot

    # intensity / mix
    p_gap = torch.div(_f32(1.0, step), wv.mean_gap)
    gap = 1 + torch.floor(torch.div(torch.log1p(-u(_L_GAP, step)),
                                    torch.log1p(-p_gap))).to(_I32)
    gap = torch.clamp(gap, 1, _MAX_GAP)
    is_write = u(_L_WRITE, step) < wv.p_write
    dep = u(_L_DEP, step) < wv.p_dep

    # the walk: the stream starts at the phase-0 hot set's entry 0
    lb, row = (x[..., 0] for x in hot_entry(torch.zeros_like(nhb0), nhb0))
    ring = torch.arange(1, RECENT_RING + 1, dtype=_I32, device=dev)
    ring_lb, ring_row = hot_entry(ring, nhb0)
    shape = lb_hot.shape
    ring_lb = ring_lb.expand(shape[:-1] + (RECENT_RING,)).contiguous()
    ring_row = ring_row.expand(shape[:-1] + (RECENT_RING,)).contiguous()
    head = torch.zeros(shape[:-1], dtype=torch.int64, device=dev)
    base_c = base[..., 0]
    span_c = span[..., 0]
    out_lb = torch.empty(shape, dtype=_I32, device=dev)
    out_row = torch.empty(shape, dtype=_I32, device=dev)
    for t in range(max_len):
        hit = hit_c[..., t]
        seq = ~hit & seq_c[..., t]
        hot = ~hit & ~seq & hot_c[..., t]
        jp = j_pick[..., t]
        row_seq = base_c + torch.remainder(row - base_c + 1, span_c)
        top = hot & (jp == 0)
        recent = hot & (jp >= 1) & (jp <= RECENT_RING)
        ridx = torch.remainder(head - (jp.to(torch.int64) - 1),
                               RECENT_RING)[..., None]
        r_lb = ring_lb.gather(-1, ridx)[..., 0]
        r_row = ring_row.gather(-1, ridx)[..., 0]
        new_lb = torch.where(hit | seq | top, lb, torch.where(
            recent, r_lb, torch.where(hot, lb_hot[..., t], lb_rand[..., t])))
        new_row = torch.where(hit | top, row, torch.where(
            seq, row_seq, torch.where(recent, r_row, torch.where(
                hot, row_hot[..., t], row_rand[..., t]))))
        moved = new_row != row  # distinct-row transition: push recency
        head = torch.remainder(head + moved.to(torch.int64), RECENT_RING)
        at = head[..., None]
        ring_lb.scatter_(-1, at, torch.where(
            moved, lb, ring_lb.gather(-1, at)[..., 0])[..., None])
        ring_row.scatter_(-1, at, torch.where(
            moved, row, ring_row.gather(-1, at)[..., 0])[..., None])
        lb, row = new_lb, new_row
        out_lb[..., t] = lb
        out_row[..., t] = row

    # physical bank via the interleave policy, zero past ``length``
    bank = dram_lib.compose_address(geom, il, out_lb, out_row)
    live = step < col(w.length)
    z = torch.zeros((), dtype=_I32, device=dev)
    return {"gap": torch.where(live, gap, z),
            "bank": torch.where(live, bank, z),
            "row": torch.where(live, out_row, z),
            "is_write": is_write & live, "dep": dep & live,
            "length": w.length}


def generate(n_cores: int, max_len: int, w: WorkloadParams,
             geom: GeomParams, il: InterleaveParams) -> dict:
    """The trace dict (``gap``/``bank``/``row``/``is_write``/``dep``
    ``[..., C, max_len]`` and ``length [..., C]``) of one point, or of a
    stacked grid of points (``w`` leaves ``[G, C, ...]``, ``geom`` and
    ``il`` leaves ``[G]``), on the device of ``w``."""
    if n_cores < 1 or max_len < 1 or w.seed.shape[-1] != n_cores:
        raise ValueError("generate needs n_cores >= 1, max_len >= 1 and "
                         "one WorkloadParams row per core")
    return _gen_cores(max_len, w, geom, il)


def materialize(spec: WorkloadSpec, dram: DRAMConfig = DDR3_SYSTEM,
                interleave: InterleaveConfig = InterleaveConfig()
                ) -> TraceBatch:
    """The host view of a generated stream: generate one (spec,
    geometry, interleave) point on the CPU and package it as a padded
    ``TraceBatch`` with its host ``next_same``.  Simulating this batch
    is bitwise the streamed path (``simulate_synth``)."""
    out = generate(spec.n_cores, spec.max_len, spec_params(spec),
                   geom_params(dram), interleave_params(interleave))
    gap, bank, row, is_write, dep = (out[k].numpy() for k in
                                     ("gap", "bank", "row", "is_write",
                                      "dep"))
    lengths = out["length"].numpy().astype(np.int32)
    ns = np.zeros(gap.shape, bool)
    for c in range(spec.n_cores):
        n = int(lengths[c])
        t = Trace(gap=gap[c, :n], bank=bank[c, :n], row=row[c, :n],
                  is_write=is_write[c, :n], dep=dep[c, :n])
        ns[c, :n] = _next_same(t)
    return TraceBatch(gap=gap, bank=bank, row=row, is_write=is_write,
                      dep=dep, next_same=ns, length=lengths)
