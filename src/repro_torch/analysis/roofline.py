"""Roofline terms for one NVIDIA H100 SXM from per-device counts (port of
``repro.analysis.roofline``), and the work formulas of the port's kernels.

    compute    = FLOPs_per_device / 989e12        (dense bf16 tensor cores)
    memory     = bytes_per_device / 3.35e12       (HBM3)
    collective = coll_bytes_per_device / (n_links * 25e9)

All inputs are per device (``opcount.analyze`` counts each rank's local
shards).  The dominant term is the step-time lower bound; MODEL_FLOPS /
counted FLOPs measures how much of the counted compute is useful (remat
and replicated work show up here).  The constants are NVIDIA's H100 SXM
data sheet's: ``repro``'s TPU v5e ones (197 TFLOP/s, 819 GB/s, 4 ICI links
of 50 GB/s) do not describe this card.  The link term keeps ``repro``'s
one link class: NVLink 4's 18 links at 25 GB/s a direction (900 GB/s both
ways), no topology model.

The kernel formulas below are each kernel's work, counted as the kernel
does it: ``*_work`` gives ``(operations, bytes)`` (every input read once,
every output written once), ``bound_of`` turns that into the least time
the card could take.  ``chip_smoke.py`` prints its bounds from them and
the meta paths of the kernels' dispatch add them to the active op counter
(``opcount.add_kernel``).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "NVLINK_LINK_BW",
           "NVLINK_LINKS", "HBM_BYTES_PER_S", "PEAK_OPS", "Roofline",
           "roofline", "model_flops", "bound_of", "valid_pairs",
           "flash_work", "flash_bound", "decode_work", "decode_bound",
           "flash_bwd_work", "flash_bwd_bound", "bwd_entry_bounds",
           "scan_work", "scan_bound_ms", "ssm_bwd_work", "ssm_bwd_bound",
           "ssm_dc_sum_work",
           "rglru_work", "rglru_bwd_work", "rglru_bwd_bound", "train_flops"]

#: dense bf16 tensor-core rate of one H100 SXM (NVIDIA data sheet, at its
#: 700 W limit)
PEAK_FLOPS = 989e12
#: its HBM3 rate, bytes/s (data sheet)
HBM_BW = 3.35e12
#: its device memory, bytes (data sheet: 80 GB), the dry run's fit check
HBM_BYTES = 80e9
#: one NVLink 4 link's rate a direction, bytes/s, and the links a card has
#: (data sheet: 18 links, 900 GB/s in all both ways)
NVLINK_LINK_BW = 25e9
NVLINK_LINKS = 18

#: the names chip_smoke's kernel bounds use: the HBM rate, and the peak
#: operations rate by input type (f32 takes the 67 TFLOP/s of the CUDA
#: cores, data sheet)
HBM_BYTES_PER_S = HBM_BW
PEAK_OPS = {"bf16": PEAK_FLOPS, "f32": 67e12}


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes: float
    coll_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops: float = 0.0
    useful_frac: float = 0.0

    def table_row(self) -> dict:
        return dataclasses.asdict(self)


def roofline(per_device: dict, model_flops_per_device: float = 0.0,
             n_links: int | None = None) -> Roofline:
    """The memory term uses the product-operand floor (``bytes_min``):
    the device-memory traffic of weights, activations and caches under
    perfect element-wise fusion.  ``bytes`` (the floor plus the outputs
    of data-movement ops) is kept as an upper-bound diagnostic.
    ``n_links`` defaults to ``NVLINK_LINKS``."""
    n_links = NVLINK_LINKS if n_links is None else n_links
    f = per_device["flops"]
    b = per_device.get("bytes_min", per_device["bytes"])
    c = per_device.get("collective_total", 0.0)
    terms = {
        "compute": f / PEAK_FLOPS,
        "memory": b / HBM_BW,
        "collective": c / (n_links * NVLINK_LINK_BW),
    }
    bound = max(terms, key=terms.get)
    return Roofline(
        flops=f, bytes=b, coll_bytes=c,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], bound=bound,
        model_flops=model_flops_per_device,
        useful_frac=(model_flops_per_device / f) if f else 0.0,
    )


def model_flops(cfg, shape, n_devices: int) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) per device; decode D = batch."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * cfg.n_active_params() * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * cfg.n_active_params() * tokens / n_devices
    # decode: one token per sequence
    return 2.0 * cfg.n_active_params() * shape.global_batch / n_devices


# ------------------------------------------------------------ the kernels

def bound_of(nbytes: float, ops: float, dtype: str = "bf16") -> tuple:
    """``(bound ms, 'bytes' | 'operations')``: the larger of ``nbytes``
    at the HBM rate and ``ops`` at ``dtype``'s peak rate
    (``PEAK_OPS``)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def valid_pairs(S, Skv, causal, window) -> int:
    """The (query, key) pairs a head's mask keeps (query i and key j at
    positions i and j): a row's keys run from ``i - window + 1`` (0
    without a window) to ``i`` (causal) or ``Skv - 1``."""
    i = torch.arange(S, dtype=torch.int64)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    hi = torch.clamp(i, max=Skv - 1) if causal else torch.full_like(i,
                                                                    Skv - 1)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def flash_work(B, S, H, K, hd, causal, window, dtype, Skv=None) -> tuple:
    """``(operations, bytes)`` of a flash-attention forward: 4 * hd
    operations a valid (query, key) pair; q, k, v read once and the
    output written once; ``Skv`` keys (default ``S``)."""
    Skv = S if Skv is None else Skv
    pairs = valid_pairs(S, Skv, causal, window) * B * H
    size = 2 if dtype == "bf16" else 4
    return 4 * hd * pairs, size * hd * (2 * B * S * H + 2 * B * Skv * K)


def flash_bound(B, S, H, K, hd, causal, window, dtype, Skv=None) -> tuple:
    """``(bound ms, 'bytes' | 'operations')`` of ``flash_work`` at
    ``dtype``'s peak."""
    ops, nbytes = flash_work(B, S, H, K, hd, causal, window, dtype, Skv)
    return bound_of(nbytes, ops, dtype)


def decode_work(B, H, K, hd, valid: int, W: int, dtype) -> tuple:
    """``(operations, bytes)`` of a decode-attention call: 4 * hd
    operations a query row and valid slot; the valid slots' keys and
    values, the queries and ``kv_pos`` read once, the output written
    once."""
    size = 2 if dtype == "bf16" else 4
    return (4 * hd * B * H * valid,
            size * hd * (2 * B * H + 2 * B * K * valid) + 4 * W)


def decode_bound(B, H, K, hd, valid: int, W: int, dtype) -> tuple:
    """``(bound ms, 'bytes' | 'operations')`` of ``decode_work``."""
    ops, nbytes = decode_work(B, H, K, hd, valid, W, dtype)
    return bound_of(nbytes, ops, dtype)


def flash_bwd_work(B, S, Skv, H, K, hd, causal, window) -> tuple:
    """``(operations, bytes)`` of one backward pass: q, o, dO, dQ (bf16
    [B, S, H, hd]), k, v, dK, dV ([B, Skv, K, hd]) and the f32 LSE moved
    once, against 10 * hd operations a valid (query, key) pair (five
    products: S, dP, dV, dK, dQ)."""
    pairs = valid_pairs(S, Skv, causal, window) * B * H
    nbytes = 2 * hd * (4 * B * S * H + 4 * B * Skv * K) + 4 * B * H * S
    return 10 * hd * pairs, nbytes


def flash_bwd_bound(B, S, Skv, H, K, hd, causal, window) -> tuple:
    """``(bound ms, 'bytes' | 'operations')`` of ``flash_bwd_work`` at
    the bf16 tensor-core rate."""
    ops, nbytes = flash_bwd_work(B, S, Skv, H, K, hd, causal, window)
    return bound_of(nbytes, ops)


def bwd_entry_bounds(B, S, Skv, H, K, hd, causal, window) -> dict:
    """Each backward entry's own ``(bound ms, by)``, the function it
    computes from its inputs: D (o, o_lo, dO read, D written); dK / dV
    (q, dO, k, v, LSE and D read, dK and dV written; S, dP, dV, dK: 8 hd
    operations a valid pair); dQ (the same inputs, dQ written; S, dP, dQ:
    6 hd); the group sum (f32 partials [B, Skv, H, hd] x 2 read, dK and
    dV written)."""
    pairs = valid_pairs(S, Skv, causal, window) * B * H
    q_bytes, kv_bytes = 2 * hd * B * S * H, 2 * hd * B * Skv * K
    rows = 4 * B * H * S
    return {
        "dot": bound_of(3 * q_bytes + rows, 0),
        "dkdv": bound_of(2 * q_bytes + 4 * kv_bytes + 2 * rows,
                         8 * hd * pairs),
        "dq": bound_of(3 * q_bytes + 2 * kv_bytes + 2 * rows,
                       6 * hd * pairs),
        "sum": bound_of(2 * 4 * hd * B * Skv * H + 2 * kv_bytes, 0)}


def scan_work(B, T, D, N, train: bool = False) -> tuple:
    """``(operations, bytes)`` of an ssm_scan forward: 2 operations a
    state element a step for h and 2 for y; decay, dbu, c and h0 read
    once, h_out and y written once, f32 (~1 operation a byte, far below
    the f32 rate); ``train``: the training instantiation, which also
    writes every step's h ([B, T, D, N] f32)."""
    nbytes = 4 * (2 * B * T * D * N + B * T * N + 2 * B * D * N + B * T * D)
    return 4 * B * T * D * N, nbytes + (4 * B * T * D * N if train else 0)


def scan_bound_ms(B, T, D, N) -> float:
    """``scan_work``'s bytes over the card's memory rate, ms."""
    return scan_work(B, T, D, N)[1] / HBM_BYTES_PER_S * 1e3


def ssm_bwd_work(B, T, D, N) -> tuple:
    """``(operations, bytes)`` of the ssm_scan backward kernel: 6
    operations a state element a step (dh's two FMAs, d decay, dc's
    partial); decay and h_seq read and d decay, d dbu written ([B, T, D,
    N] f32 each), c, dy, h0, dh_T read, dh0 and dc's block partials (16
    channels a block at N 16) written."""
    nblk = -(-D // (256 // (1 << (N - 1).bit_length())))
    nbytes = 4 * (4 * B * T * D * N + B * T * N + B * T * D + 3 * B * D * N
                  + B * nblk * T * N)
    return 6 * B * T * D * N, nbytes


def ssm_bwd_bound(B, T, D, N) -> tuple:
    """``(bound ms, 'bytes')`` of ``ssm_bwd_work``'s bytes (its
    operations are ~0.3 a byte: the bytes bound)."""
    return bound_of(ssm_bwd_work(B, T, D, N)[1], 0)


def ssm_dc_sum_work(B, T, D, N) -> tuple:
    """``(operations, bytes)`` of the sum of dc's block partials: one add
    a partial; the partials read once, dc [B, T, N] written once, f32."""
    nblk = -(-D // (256 // (1 << (N - 1).bit_length())))
    return B * nblk * T * N, 4 * (B * nblk * T * N + B * T * N)


def rglru_work(B, S, d) -> tuple:
    """``(operations, bytes)`` of an rglru_scan forward: 16 operations a
    channel-step (two sigmoids, ``a``, the gate factor's FMA, max and
    root, two products, the chain's FMA); bf16 ``r_pre``, ``i_pre``,
    ``u`` read and f32 ``h`` written (10 bytes a channel-step), ``h0``,
    ``h_S`` and ``nsp`` (f32)."""
    return 16 * B * S * d, 10 * B * S * d + 8 * B * d + 4 * d


def rglru_bwd_work(B, S, d) -> tuple:
    """``(operations, bytes)`` of the rglru_scan backward kernel: 32
    operations a channel-step (the forward's gates again and their
    gradients); r_pre, i_pre, u (bf16) and h_seq, dh_seq (f32) read,
    dr_pre, di_pre, du (bf16) written, 20 bytes a channel-step, plus h0,
    dh_S, dh0 [B, d] and nsp, dnsp [d] (f32)."""
    return 32 * B * S * d, 20 * B * S * d + 4 * (3 * B * d + 2 * d)


def rglru_bwd_bound(B, S, d) -> tuple:
    """``(bound ms, 'bytes')`` of ``rglru_bwd_work``'s bytes."""
    return bound_of(rglru_bwd_work(B, S, d)[1], 0)


def train_flops(cfg, B: int, S: int) -> float:
    """Operations of one train step of a dense decoder at B x S: 6 N
    tokens (N the parameters of its products: all but the embedding),
    the remat forward of the layers and of the chunked cross entropy's
    head (2 N tokens again), and attention, 4 hd a valid causal pair
    forward, again in the remat forward, and 10 hd backward."""
    from repro_torch.models import lm
    from repro_torch.models.params import count_params
    defs = lm.lm_defs(cfg)
    n = count_params(defs) - count_params(defs["embed"])
    tokens = B * S
    pairs = S * (S + 1) // 2 * cfg.n_heads * B * cfg.n_layers
    return 8.0 * n * tokens + 18.0 * cfg.hd * pairs
