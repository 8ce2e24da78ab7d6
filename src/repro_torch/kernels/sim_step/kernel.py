"""CUDA launcher of the ``sim_step`` kernel (``csrc/sim_step.cu``).

Replaces ``repro/kernels/sim_step/kernel.py::grid_step_call``: one sweep
point per thread block, the point's whole state in shared memory.  This
module packs a grid's stacked ``MechParams`` into one int32 ``[G, P]``
row per point (plus the float32 ``[G, S]`` thermal leak scales), builds
the kernel on first use (``repro_torch._build``), and launches it
through ``ctypes`` on PyTorch's current stream.

The packed row's fields are defined once, here (``FIELDS``): their
offsets are computed from the grid's sizes and passed to the kernel,
which addresses every field through them.  The kernel exports its own
field and size lists (``sim_step_abi``); they are checked against
``FIELDS`` and ``DIMS`` when the library is loaded, so the two sides
cannot drift apart silently.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _build
from repro_torch.core import mechanisms as registry
from repro_torch.core.simulator import BANK_STAT_KEYS, STAT_KEYS, Events

#: packed param fields, in the kernel's ``Field`` order
FIELDS = (
    "tRCD", "tRAS", "tRP", "tCL", "tCWL", "tBL", "tRTP", "tWR", "tREFI",
    "tRFC", "n_refresh_groups", "retention_cycles",
    "banks_total", "banks_per_channel", "n_rows",
    "closed_policy", "refresh_stateful", "hc_gate", "hc_n_sets",
    "hc_caching_cycles", "hc_sweep_period", "ns_idx",
    "ll_enable", "ll_tRCD", "ll_tRAS",
    "cc_enable", "cc_tRCD", "cc_tRAS",
    "nuat_enable", "nuat_edge", "nuat_rcd", "nuat_ras",
    "rltl_enable", "rltl_window", "rltl_tRCD", "rltl_tRAS",
    "al_enable", "al_drift", "al_rcd", "al_ras", "al_seg_rcd", "al_seg_ras",
    "th_enable", "th_seg_edge",
)

#: the launch sizes, in the kernel's ``Dims`` order
DIMS = ("G", "C", "L", "NB", "NCH", "HS", "W", "M", "NBINS", "S", "P",
        "n_steps", "warmup", "collect", "exact")

#: shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

#: event lanes of the kernel's int32 ``[8, G, n_steps]`` output, in order
INT_EVENT_LANES = ("act_gid", "act_t", "pre1_gid", "pre1_t", "pre2_gid",
                   "pre2_t", "pre3_gid", "pre3_t")

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; check its ABI."""
    lib = _build.load("sim_step", Path(__file__).parent / "csrc")
    lib.sim_step_abi.restype = ctypes.c_char_p
    lib.sim_step_abi.argtypes = []
    lib.sim_step_smem_bytes.restype = ctypes.c_int
    lib.sim_step_smem_bytes.argtypes = [_P]
    lib.sim_step_error_string.restype = ctypes.c_char_p
    lib.sim_step_error_string.argtypes = [ctypes.c_int]
    lib.sim_step_launch.restype = ctypes.c_int
    lib.sim_step_launch.argtypes = [_P] * 17
    abi = lib.sim_step_abi().decode()
    want = f"fields:{','.join(FIELDS)};dims:{','.join(DIMS)}"
    if abi != want:
        raise RuntimeError(f"sim_step ABI mismatch: kernel has {abi!r}, "
                           f"kernel.py expects {want!r}")
    return lib


def pack(stacked, ns_idx) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """The grid's params as ``(int32 [G, P], float32 [G, S], offsets)``;
    ``offsets[i]`` is where ``FIELDS[i]`` starts in a row."""
    T, geo, h, mech, th = (stacked.timing, stacked.geom, stacked.hcrac,
                           stacked.mech, stacked.thermal)
    G = ns_idx.shape[0]
    ll, cc, nu, rl, al = (mech[n] for n in
                          ("lldram", "chargecache", "nuat", "rltl", "aldram"))
    values = {
        "tRCD": T.tRCD, "tRAS": T.tRAS, "tRP": T.tRP, "tCL": T.tCL,
        "tCWL": T.tCWL, "tBL": T.tBL, "tRTP": T.tRTP, "tWR": T.tWR,
        "tREFI": T.tREFI, "tRFC": T.tRFC,
        "n_refresh_groups": T.n_refresh_groups,
        "retention_cycles": T.retention_cycles,
        "banks_total": geo.banks_total,
        "banks_per_channel": geo.banks_per_channel, "n_rows": geo.n_rows,
        "closed_policy": stacked.closed_policy,
        "refresh_stateful": stacked.refresh_stateful,
        "hc_gate": registry.hcrac_gate(mech).to(ns_idx.device).expand(G),
        "hc_n_sets": h.n_sets, "hc_caching_cycles": h.caching_cycles,
        "hc_sweep_period": h.sweep_period, "ns_idx": ns_idx,
        "ll_enable": ll["enable"], "ll_tRCD": ll["tRCD"],
        "ll_tRAS": ll["tRAS"],
        "cc_enable": cc["enable"], "cc_tRCD": cc["tRCD"],
        "cc_tRAS": cc["tRAS"],
        "nuat_enable": nu["enable"], "nuat_edge": nu["edge"],
        "nuat_rcd": nu["rcd"], "nuat_ras": nu["ras"],
        "rltl_enable": rl["enable"], "rltl_window": rl["window"],
        "rltl_tRCD": rl["tRCD"], "rltl_tRAS": rl["tRAS"],
        "al_enable": al["enable"], "al_drift": al["drift"],
        "al_rcd": al["rcd"], "al_ras": al["ras"],
        "al_seg_rcd": al["seg_rcd"], "al_seg_ras": al["seg_ras"],
        "th_enable": th.enable, "th_seg_edge": th.seg_edge,
    }
    cols = [values[f].reshape(G, -1).to(torch.int32) for f in FIELDS]
    offsets, at = [], 0
    for c in cols:
        offsets.append(at)
        at += c.shape[1]
    params = torch.cat(cols, dim=1).contiguous()
    leak = th.seg_leak.reshape(G, -1).to(torch.float32).contiguous()
    return params, leak, offsets


def _c_ints(xs) -> ctypes.Array:
    return (ctypes.c_int * len(xs))(*(int(x) for x in xs))


def sim_step(shape, stacked, trace: dict, ns, ns_idx, warmup: int,
             n_steps: int, collect_events: bool = True):
    """Launch the kernel over a ``[G]`` grid; returns ``(stats, core_end,
    events or None)`` laid out as ``ref.run_sweep_ref`` returns them.
    The launch is asynchronous on the current stream; a refused launch
    raises."""
    dev = trace["gap"].device
    if dev.type != "cuda":
        raise ValueError(f"sim_step launches on CUDA tensors, not {dev}")
    lib = library()
    params, leak, offsets = pack(stacked, ns_idx)
    G, P = params.shape
    C, L = trace["gap"].shape
    NB = shape.envelope.max_banks_total
    S = stacked.thermal.seg_edge.shape[-1]
    nbins = stacked.mech["nuat"]["edge"].shape[-1]
    if stacked.mech["aldram"]["rcd"].shape[-1] != NB:
        raise ValueError("aldram tables are not sized to the envelope")
    dims = {"G": G, "C": C, "L": L, "NB": NB,
            "NCH": shape.envelope.max_channels,
            "HS": shape.hcrac.n_sets, "W": shape.hcrac.n_ways,
            "M": shape.mshr, "NBINS": nbins, "S": S, "P": P,
            "n_steps": n_steps, "warmup": warmup,
            "collect": int(collect_events),
            "exact": int(shape.hcrac.exact_expiry)}
    c_dims = _c_ints([dims[k] for k in DIMS])
    smem = lib.sim_step_smem_bytes(ctypes.cast(c_dims, _P))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"sim_step needs {smem} B of shared memory per "
                         f"block; Hopper allows {MAX_SMEM_BYTES}")
    expect = {"gap": torch.int32, "bank": torch.int32, "row": torch.int32,
              "is_write": torch.bool, "dep": torch.bool,
              "length": torch.int32}
    for k, dt in expect.items():
        x = trace[k]
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"trace[{k!r}] must be a contiguous {dt} "
                             f"tensor on {dev}")
    if (ns.dtype != torch.bool or ns.device != dev or not ns.is_contiguous()
            or tuple(ns.shape[1:]) != (C, L)):
        raise ValueError("next_same must be a contiguous bool [n_geom, C, L]"
                         f" tensor on {dev}")

    stats = torch.empty((G, len(STAT_KEYS)), dtype=torch.int32, device=dev)
    bank_stats = torch.empty((G, 2, NB), dtype=torch.int32, device=dev)
    core_end = torch.empty((G, C), dtype=torch.int32, device=dev)
    ev_shape = (G, n_steps) if collect_events else (1, 1)
    ev = torch.empty((len(INT_EVENT_LANES),) + ev_shape, dtype=torch.int32,
                     device=dev)
    ref8 = torch.empty(ev_shape, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sim_step_launch(
            ctypes.cast(c_dims, _P), ctypes.cast(_c_ints(offsets), _P),
            params.data_ptr(), leak.data_ptr(), trace["gap"].data_ptr(),
            trace["bank"].data_ptr(), trace["row"].data_ptr(),
            trace["is_write"].data_ptr(), trace["dep"].data_ptr(),
            trace["length"].data_ptr(), ns.data_ptr(), stats.data_ptr(),
            bank_stats.data_ptr(), core_end.data_ptr(), ev.data_ptr(),
            ref8.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("sim_step launch failed: "
                           + lib.sim_step_error_string(err).decode())
    out = {k: stats[:, i] for i, k in enumerate(STAT_KEYS)}
    for i, k in enumerate(BANK_STAT_KEYS):
        out[k] = bank_stats[:, i]
    events = None
    if collect_events:
        lanes = dict(zip(INT_EVENT_LANES, ev))
        events = Events(act_ref8=ref8, **lanes)
    return out, core_end, events
