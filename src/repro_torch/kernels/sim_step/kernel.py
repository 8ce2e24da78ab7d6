"""CUDA launcher of the ``sim_step`` kernel (``csrc/sim_step.cu``).

Replaces ``repro/kernels/sim_step/kernel.py::grid_step_call``: one sweep
point per thread block, the point's whole state in shared memory.  This
module packs a grid's stacked ``MechParams`` into one int32 ``[G, P]``
row per point (plus the float32 ``[G, S]`` thermal leak scales), builds
the kernel on first use (``repro_torch._build``), and launches it
through ``ctypes`` on PyTorch's current stream.

The kernel has two scan entries.  ``sim_step`` scans one trace shared by
every point.  ``sim_synth`` (replacing the same launcher reached from
``repro/kernels/sim_step/ops.py::_synth_pallas``) first generates each
point's streams in the block, into a ``[G, C, L]`` scratch this module
allocates (and returns on request), then scans them; its workload and
interleave params travel as one int32 and one float32 row per point.

What bounds both is one serial chain a point: each request's arrival
waits on the previous one's completion, and its service reads the bank,
bus and HCRAC state the previous one wrote.  The kernel keeps that chain
in shared memory and registers: a block is two warps, one staging each
core's next requests into shared memory (already folded into the point's
geometry) while the other scans, a lane per core choosing the earliest
issue with a warp reduction; and every floor division by a constant of
the point is a multiply and a shift (``kernels/include/floor_div.cuh``,
built once a point).  So ``pack`` refuses a divisor that is not positive
(``DIVISOR_FIELDS``), naming the field, and ``floor_div`` runs the
kernel's divider itself.

The serving entry ``sim_serve`` (no Pallas counterpart: ``repro``'s
serving loop, ``serving/loop/engine.py::_run_serving_impl``, is an XLA
scan) runs the continuous-batching closed loop per point, its DRAM
state that of one idle core.  The scheduler reads neither the hot-page
table nor the DRAM state, so a point's block is three warps, one a
chain: the scheduler across one warp's lanes
(``kernels/include/serve_sched.cuh``) stages each step's page accesses
as records in a shared-memory ring, one warp keeps the hot-page table
(inserts on a lane, the step's probes across the lanes), and one lane
runs the DRAM service of each access.  Its serving params travel as one
int32 row per point (``SERVE_FIELDS``, the two float32 arrival knobs as
bits).

The window entry ``sim_window`` (no Pallas counterpart either:
``repro`` runs its FR-FCFS tier as an XLA scan,
``controller/engine.py::_run_window_impl``) runs the window engine per
point on a block of two warps, over a trace or, after the synthesis
entry's pre-pass, over the streams it generates: one warp stages the
streams, the other keeps the cores' issue times and the window's slot
keys in its lanes' registers (``kernels/include/window_ctl.cuh``) and
serves on lane 0 under the rank's tRRD/tFAW floor; an in-order point's
block runs the trace entry's scan instead.  Its window depth is
``DIMS``' ``WIN``; streams whose admission count could reach the
selection key's hit penalty (cores x length >= 2**26) are refused.

The packed rows' fields are defined once, here (``FIELDS``,
``SYNTH_INT_FIELDS``, ``SYNTH_FLOAT_FIELDS``, ``SERVE_FIELDS``): their
offsets are computed from the grid's sizes and passed to the kernel,
which addresses every field through them.  The kernel exports its own
field and size lists (``sim_step_abi``, ``sim_serve_abi``); they are
checked against these and ``DIMS`` / ``SERVE_DIMS`` when the library is
loaded, so the two sides cannot drift apart silently.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import _build
from repro_torch.core import mechanisms as registry
from repro_torch.core.simulator import BANK_STAT_KEYS, STAT_KEYS, Events
from repro_torch.serving.loop.engine import SERVE_STAT_KEYS

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
    "th_enable", "th_seg_edge", "tRRD", "tFAW", "n_banks", "frfcfs",
    "win_cap",
)

#: packed fields the kernel divides by (``FloorDiv``): each must be
#: positive at every point
DIVISOR_FIELDS = ("tREFI", "n_refresh_groups", "retention_cycles",
                  "banks_total", "banks_per_channel", "n_rows", "hc_n_sets",
                  "hc_caching_cycles", "n_banks")

#: serving fields the kernel divides by (the hot-page table's, and the
#: tokens a KV page the scheduler grows a request's pages by)
SERVE_DIVISOR_FIELDS = ("hot_n_sets", "hot_caching_cycles", "page_tokens")

#: the launch sizes, in the kernel's ``Dims`` order (``W``: the HCRAC's
#: ways; ``WIN``: the FR-FCFS window depth, 0 but for the window entry)
DIMS = ("G", "C", "L", "NB", "NCH", "HS", "W", "M", "NBINS", "S", "P",
        "n_steps", "warmup", "collect", "exact", "SW", "PI", "PF", "WIN")

#: int32 fields of the synthesis entry's packed workload row, in the
#: kernel's ``SynthInt`` order: ``WorkloadParams`` identity leaves
#: ``[C]`` and int leaves ``[C, SW]``, the interleave policy, the
#: point's channel count and warm-up
SYNTH_INT_FIELDS = ("seed", "core_idx", "n_cores", "length", "hot_rows",
                    "n_hot_banks", "seg_edge", "il_kind_id",
                    "il_block_rows", "n_channels", "warmup")

#: float32 fields of the packed workload row (``[C, SW]`` each), in the
#: kernel's ``SynthFloat`` order
SYNTH_FLOAT_FIELDS = ("mean_gap", "p_rowhit", "p_hot", "p_seq", "p_dep",
                      "p_write", "stack_zipf", "stack_geo")

#: the synthesis entry's stream scratch, ``[G, C, L]`` each, in order
STREAM_FIELDS = (("gap", torch.int32), ("bank", torch.int32),
                 ("row", torch.int32), ("is_write", torch.bool),
                 ("dep", torch.bool), ("next_same", torch.bool))

#: int32 fields of the serving entry's packed row, in the kernel's
#: ``ServeField`` order (``rate`` and ``burstiness`` as float32 bits)
SERVE_FIELDS = ("rate", "burstiness", "prompt_lo", "prompt_hi",
                "decode_lo", "decode_hi", "seed", "n_reqs", "hot_n_sets",
                "hot_caching_cycles", "hot_sweep_period", "cycles_per_step",
                "page_tokens", "charge_aware_enable", "preempting_enable",
                "preempting_q_thresh", "warmup")

#: the serving launch's sizes, in the kernel's ``ServeDims`` order
SERVE_DIMS = ("HHS", "HW", "hexact", "SB", "Q", "A", "Pp", "Pt", "n_steps",
              "collect", "pinned", "PS")

#: shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

#: event lanes of the kernel's int32 ``[8, G, n_steps]`` output, in order
INT_EVENT_LANES = ("act_gid", "act_t", "pre1_gid", "pre1_t", "pre2_gid",
                   "pre2_t", "pre3_gid", "pre3_t")

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; check its ABI."""
    lib = bind_window_entry(bind_serve_entry(bind_scan_entries(_build.load(
        "sim_step", Path(__file__).parent / "csrc"))))
    lib.sim_step_abi.restype = ctypes.c_char_p
    lib.sim_step_abi.argtypes = []
    lib.sim_step_floor_div.restype = ctypes.c_int
    lib.sim_step_floor_div.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P,
                                       _P, _P]
    for got, want in ((lib.sim_step_abi().decode(), abi_string()),
                      (lib.sim_serve_abi().decode(), serve_abi_string())):
        if got != want:
            raise RuntimeError(f"sim_step ABI mismatch: kernel has {got!r}, "
                               f"kernel.py expects {want!r}")
    return lib


def bind_scan_entries(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the trace and synthesis entries
    (``sim_step_launch``, ``sim_synth_launch`` and their helpers,
    unchanged since the entries were written, so a library built from
    any version of the source since then binds); returns ``lib``."""
    lib.sim_step_smem_bytes.restype = ctypes.c_int
    lib.sim_step_smem_bytes.argtypes = [_P]
    lib.sim_step_error_string.restype = ctypes.c_char_p
    lib.sim_step_error_string.argtypes = [ctypes.c_int]
    lib.sim_step_launch.restype = ctypes.c_int
    lib.sim_step_launch.argtypes = [_P] * 17
    lib.sim_synth_launch.restype = ctypes.c_int
    lib.sim_synth_launch.argtypes = [_P] * 19
    return lib


def bind_serve_entry(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the serving entry (``sim_serve_launch``
    and its helpers, unchanged since the entry was written); returns
    ``lib``."""
    lib.sim_serve_abi.restype = ctypes.c_char_p
    lib.sim_serve_abi.argtypes = []
    lib.sim_serve_smem_bytes.restype = ctypes.c_int
    lib.sim_serve_smem_bytes.argtypes = [_P, _P]
    lib.sim_serve_launch.restype = ctypes.c_int
    lib.sim_serve_launch.argtypes = [_P] * 13
    return lib


def bind_window_entry(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the window entry (``sim_window_launch``
    and its shared-memory size); returns ``lib``."""
    lib.sim_window_smem_bytes.restype = ctypes.c_int
    lib.sim_window_smem_bytes.argtypes = [_P]
    lib.sim_window_launch.restype = ctypes.c_int
    lib.sim_window_launch.argtypes = [_P] * 20
    return lib


def abi_string() -> str:
    """The field and size lists the kernel must export."""
    return (f"fields:{','.join(FIELDS)};dims:{','.join(DIMS)};"
            f"synth_int:{','.join(SYNTH_INT_FIELDS)};"
            f"synth_float:{','.join(SYNTH_FLOAT_FIELDS)}")


def serve_abi_string() -> str:
    """The serving row's fields and the serving sizes the kernel must
    export."""
    return (f"serve:{','.join(SERVE_FIELDS)};"
            f"serve_dims:{','.join(SERVE_DIMS)}")


def _concat(cols: list) -> tuple[torch.Tensor, list[int]]:
    """``[G, k_i]`` columns side by side, and where each starts."""
    offsets, at = [], 0
    for c in cols:
        offsets.append(at)
        at += c.shape[1]
    return torch.cat(cols, dim=1).contiguous(), offsets


def _check_divisors(values: dict, fields, what: str) -> None:
    """Refuse a divisor of the kernel that is not positive at some point
    (the kernel builds a ``FloorDiv`` from each), naming the field."""
    lows = torch.stack([values[f].reshape(-1).amin().to(torch.int64)
                        for f in fields]).tolist()
    for f, low in zip(fields, lows):
        if low <= 0:
            raise ValueError(f"{what}: {f} must be positive at every point "
                             f"(the kernel divides by it), got {low}")


def pack(stacked, ns_idx) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """The grid's params as ``(int32 [G, P], float32 [G, S], offsets)``;
    ``offsets[i]`` is where ``FIELDS[i]`` starts in a row.  Raises if a
    divisor (``DIVISOR_FIELDS``) is not positive."""
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
        "tRRD": T.tRRD, "tFAW": T.tFAW, "n_banks": geo.n_banks,
        "frfcfs": stacked.frfcfs, "win_cap": stacked.win_cap,
    }
    _check_divisors(values, DIVISOR_FIELDS, "sim_step")
    params, offsets = _concat([values[f].reshape(G, -1).to(torch.int32)
                               for f in FIELDS])
    leak = th.seg_leak.reshape(G, -1).to(torch.float32).contiguous()
    return params, leak, offsets


def _c_ints(xs) -> ctypes.Array:
    return (ctypes.c_int * len(xs))(*(int(x) for x in xs))


def _dims(lib, shape, stacked, G, P, C, L, n_steps, warmup,
          collect_events, SW=0, PI=0, PF=0, WIN=0):
    """The launch sizes as a C int array, after the shared-memory check
    (the window entry's when ``WIN`` > 0)."""
    NB = shape.envelope.max_banks_total
    if stacked.mech["aldram"]["rcd"].shape[-1] != NB:
        raise ValueError("aldram tables are not sized to the envelope")
    if shape.mshr < 1:
        raise ValueError(f"sim_step needs at least one MSHR, not "
                         f"{shape.mshr}")
    dims = {"G": G, "C": C, "L": L, "NB": NB,
            "NCH": shape.envelope.max_channels,
            "HS": shape.hcrac.n_sets, "W": shape.hcrac.n_ways,
            "M": shape.mshr,
            "NBINS": stacked.mech["nuat"]["edge"].shape[-1],
            "S": stacked.thermal.seg_edge.shape[-1], "P": P,
            "n_steps": n_steps, "warmup": warmup,
            "collect": int(collect_events),
            "exact": int(shape.hcrac.exact_expiry),
            "SW": SW, "PI": PI, "PF": PF, "WIN": WIN}
    c_dims = _c_ints([dims[k] for k in DIMS])
    smem = (lib.sim_window_smem_bytes if WIN > 0
            else lib.sim_step_smem_bytes)(ctypes.cast(c_dims, _P))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"sim_step needs {smem} B of shared memory per "
                         f"block; Hopper allows {MAX_SMEM_BYTES}")
    return c_dims


def _outputs(G, C, NB, n_steps, collect_events, dev):
    """``(stats, bank_stats, core_end, event lanes, act_ref8)``."""
    ev_shape = (G, n_steps) if collect_events else (1, 1)
    return (torch.empty((G, len(STAT_KEYS)), dtype=torch.int32, device=dev),
            torch.empty((G, 2, NB), dtype=torch.int32, device=dev),
            torch.empty((G, C), dtype=torch.int32, device=dev),
            torch.empty((len(INT_EVENT_LANES),) + ev_shape,
                        dtype=torch.int32, device=dev),
            torch.empty(ev_shape, dtype=torch.bool, device=dev))


def _to_launch(dev, *rows) -> tuple:
    """The packed rows on the launch device.  Rows packed on the host (a
    grid staged there, as the Experiment runner stages it) are copied
    without blocking: the host returns once the bytes are staged for the
    copy, so neither the divisor check nor the copy waits for earlier
    work on the stream."""
    return tuple(r.to(dev, non_blocking=True) for r in rows)


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.sim_step_error_string(err).decode())


def _results(outs, collect_events):
    """The launch's outputs laid out as ``ref.run_sweep_ref`` returns
    them: ``(stats, core_end, events or None)``."""
    stats, bank_stats, core_end, ev, ref8 = outs
    out = {k: stats[:, i] for i, k in enumerate(STAT_KEYS)}
    for i, k in enumerate(BANK_STAT_KEYS):
        out[k] = bank_stats[:, i]
    events = None
    if collect_events:
        events = Events(act_ref8=ref8, **dict(zip(INT_EVENT_LANES, ev)))
    return out, core_end, events


def _check_trace(trace: dict, ns, dev) -> None:
    """Raise unless the trace and its lookahead tables are contiguous
    tensors of the kernel's types on ``dev``."""
    C, L = trace["gap"].shape
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


def sim_step(shape, stacked, trace: dict, ns, ns_idx, warmup: int,
             n_steps: int, collect_events: bool = True):
    """Launch the trace entry over a ``[G]`` grid; returns ``(stats,
    core_end, events or None)`` laid out as ``ref.run_sweep_ref`` returns
    them.  The trace and lookahead tables lie on the card; ``stacked``
    and ``ns_idx`` may lie there too or on the host (``_to_launch``).
    The launch is asynchronous on the current stream; a refused launch
    raises."""
    dev = trace["gap"].device
    _build.require_cuda(dev, "sim_step")
    lib = library()
    params, leak, offsets = pack(stacked, ns_idx)
    params, leak = _to_launch(dev, params, leak)
    G, P = params.shape
    C, L = trace["gap"].shape
    c_dims = _dims(lib, shape, stacked, G, P, C, L, n_steps, warmup,
                   collect_events)
    _check_trace(trace, ns, dev)
    outs = _outputs(G, C, shape.envelope.max_banks_total, n_steps,
                    collect_events, dev)
    err = _build.launch(
        lib.sim_step_launch, dev,
        ctypes.cast(c_dims, _P), ctypes.cast(_c_ints(offsets), _P),
        params.data_ptr(), leak.data_ptr(), trace["gap"].data_ptr(),
        trace["bank"].data_ptr(), trace["row"].data_ptr(),
        trace["is_write"].data_ptr(), trace["dep"].data_ptr(),
        trace["length"].data_ptr(), ns.data_ptr(),
        *(x.data_ptr() for x in outs))
    _check(lib, err, "sim_step")
    return _results(outs, collect_events)


def pack_synth(stacked, wparams, ilparams, warmups
               ) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """A synthetic grid's workload rows as ``(int32 [G, PI], float32
    [G, PF], offsets)``: ``offsets`` holds where each of
    ``SYNTH_INT_FIELDS`` starts in the int row, then where each of
    ``SYNTH_FLOAT_FIELDS`` starts in the float row."""
    G = warmups.shape[0]
    values = {**{f: getattr(wparams, f) for f in SYNTH_INT_FIELDS[:7]},
              "il_kind_id": ilparams.kind_id,
              "il_block_rows": ilparams.block_rows,
              "n_channels": stacked.geom.n_channels, "warmup": warmups}
    wi, ioff = _concat([values[f].reshape(G, -1).to(torch.int32)
                        for f in SYNTH_INT_FIELDS])
    wf, foff = _concat([getattr(wparams, f).reshape(G, -1)
                        .to(torch.float32) for f in SYNTH_FLOAT_FIELDS])
    return wi, wf, ioff + foff


def sim_synth(shape, stacked, wparams, ilparams, warmups, n_cores: int,
              max_len: int, n_steps: int, collect_events: bool = True,
              stream: bool = False, device=None):
    """Launch the synthesis entry over a ``[G]`` grid: each block
    generates its point's streams into a ``[G, C, max_len]`` scratch and
    scans them.  Returns ``(stats, core_end, events or None)`` as
    ``ref.run_synth_ref`` does, plus the scratch streams (and ``length
    [G, C]``) when ``stream`` is set.  The pre-pass generates all
    ``max_len`` positions whatever ``n_steps`` is, so ``n_steps=0``
    generates the streams and skips the scan.  ``device`` is the card
    (default: where ``warmups`` lies); the params may lie on the host.
    Asynchronous on the current stream; a refused launch raises."""
    dev = warmups.device if device is None else torch.device(device)
    _build.require_cuda(dev, "sim_synth")
    if not 1 <= n_cores <= 32:
        raise ValueError("the synthesis entry runs one lane per core: "
                         f"1..32 cores, not {n_cores}")
    lib = library()
    G = warmups.shape[0]
    params, leak, offsets = pack(
        stacked, torch.zeros(G, dtype=torch.int32, device=warmups.device))
    wi, wf, soff = pack_synth(stacked, wparams, ilparams, warmups)
    params, leak, wi, wf = _to_launch(dev, params, leak, wi, wf)
    SW = wparams.seg_edge.shape[-1]
    c_dims = _dims(lib, shape, stacked, G, params.shape[1], n_cores,
                   max_len, n_steps, 0, collect_events, SW=SW,
                   PI=wi.shape[1], PF=wf.shape[1])
    scratch = {k: torch.empty((G, n_cores, max_len), dtype=dt, device=dev)
               for k, dt in STREAM_FIELDS}
    outs = _outputs(G, n_cores, shape.envelope.max_banks_total, n_steps,
                    collect_events, dev)
    err = _build.launch(
        lib.sim_synth_launch, dev,
        ctypes.cast(c_dims, _P), ctypes.cast(_c_ints(offsets), _P),
        ctypes.cast(_c_ints(soff), _P), params.data_ptr(),
        leak.data_ptr(), wi.data_ptr(), wf.data_ptr(),
        *(scratch[k].data_ptr() for k, _ in STREAM_FIELDS),
        *(x.data_ptr() for x in outs))
    _check(lib, err, "sim_synth")
    out = _results(outs, collect_events)
    if stream:
        return out + ({**scratch, "length": wparams.length.to(dev)},)
    return out


def sim_window(shape, W: int, stacked, trace: dict, ns, ns_idx,
               warmup: int, n_steps: int, collect_events: bool = True):
    """Launch the window entry's trace feed over a ``[G]`` grid: the
    FR-FCFS window engine of depth ``W`` at every point (in-order points
    at ``win_cap = 1``).  Returns ``(stats, core_end, events or None)``
    as ``ref.run_window_ref`` does; takes what ``sim_step`` takes.
    Asynchronous on the current stream; a refused launch raises."""
    dev = trace["gap"].device
    _build.require_cuda(dev, "sim_window")
    if W < 1:
        raise ValueError(f"the window depth must be >= 1, not {W}")
    lib = library()
    params, leak, offsets = pack(stacked, ns_idx)
    params, leak = _to_launch(dev, params, leak)
    G, P = params.shape
    C, L = trace["gap"].shape
    c_dims = _dims(lib, shape, stacked, G, P, C, L, n_steps, warmup,
                   collect_events, WIN=W)
    _check_trace(trace, ns, dev)
    outs = _outputs(G, C, shape.envelope.max_banks_total, n_steps,
                    collect_events, dev)
    err = _build.launch(
        lib.sim_window_launch, dev,
        ctypes.cast(c_dims, _P), ctypes.cast(_c_ints(offsets), _P), None,
        params.data_ptr(), leak.data_ptr(), None, None,
        *(trace[k].data_ptr() for k in ("gap", "bank", "row", "is_write",
                                         "dep", "length")),
        ns.data_ptr(), *(x.data_ptr() for x in outs))
    _check(lib, err, "sim_window")
    return _results(outs, collect_events)


def sim_window_synth(shape, W: int, stacked, wparams, ilparams, warmups,
                     n_cores: int, max_len: int, n_steps: int,
                     collect_events: bool = True, stream: bool = False,
                     device=None):
    """Launch the window entry's synthesis feed over a ``[G]`` grid: each
    block generates its point's streams (the synthesis entry's pre-pass)
    into a ``[G, C, max_len]`` scratch, then runs the window engine of
    depth ``W`` over them.  Takes and returns what ``sim_synth`` does.
    Asynchronous on the current stream; a refused launch raises."""
    dev = warmups.device if device is None else torch.device(device)
    _build.require_cuda(dev, "sim_window")
    if not 1 <= n_cores <= 32:
        raise ValueError("the synthesis pre-pass runs one lane per core: "
                         f"1..32 cores, not {n_cores}")
    if W < 1:
        raise ValueError(f"the window depth must be >= 1, not {W}")
    lib = library()
    G = warmups.shape[0]
    params, leak, offsets = pack(
        stacked, torch.zeros(G, dtype=torch.int32, device=warmups.device))
    wi, wf, soff = pack_synth(stacked, wparams, ilparams, warmups)
    params, leak, wi, wf = _to_launch(dev, params, leak, wi, wf)
    c_dims = _dims(lib, shape, stacked, G, params.shape[1], n_cores,
                   max_len, n_steps, 0, collect_events,
                   SW=wparams.seg_edge.shape[-1], PI=wi.shape[1],
                   PF=wf.shape[1], WIN=W)
    scratch = {k: torch.empty((G, n_cores, max_len), dtype=dt, device=dev)
               for k, dt in STREAM_FIELDS}
    outs = _outputs(G, n_cores, shape.envelope.max_banks_total, n_steps,
                    collect_events, dev)
    err = _build.launch(
        lib.sim_window_launch, dev,
        ctypes.cast(c_dims, _P), ctypes.cast(_c_ints(offsets), _P),
        ctypes.cast(_c_ints(soff), _P), params.data_ptr(), leak.data_ptr(),
        wi.data_ptr(), wf.data_ptr(),
        *(scratch[k].data_ptr() for k in ("gap", "bank", "row", "is_write",
                                           "dep")),
        None, scratch["next_same"].data_ptr(),
        *(x.data_ptr() for x in outs))
    _check(lib, err, "sim_window")
    out = _results(outs, collect_events)
    if stream:
        return out + ({**scratch, "length": wparams.length.to(dev)},)
    return out


def pack_serve(params, warmups) -> torch.Tensor:
    """A serving grid's non-DRAM params as one int32 ``[G, PS]`` row per
    point, in ``SERVE_FIELDS`` order (every field a scalar; ``fifo`` has
    no score and no preemption, so only the other two policies' blocks
    travel)."""
    a, h, pol = params.arrival, params.hot, params.policy
    bits = lambda x: x.to(torch.float32).contiguous().view(torch.int32)
    values = {
        "rate": bits(a.rate), "burstiness": bits(a.burstiness),
        "prompt_lo": a.prompt_lo, "prompt_hi": a.prompt_hi,
        "decode_lo": a.decode_lo, "decode_hi": a.decode_hi,
        "seed": a.seed, "n_reqs": a.n_reqs, "hot_n_sets": h.n_sets,
        "hot_caching_cycles": h.caching_cycles,
        "hot_sweep_period": h.sweep_period,
        "cycles_per_step": params.cycles_per_step,
        "page_tokens": params.page_tokens,
        "charge_aware_enable": pol["charge_aware"]["enable"],
        "preempting_enable": pol["preempting"]["enable"],
        "preempting_q_thresh": pol["preempting"]["q_thresh"],
        "warmup": warmups}
    _check_divisors(values, SERVE_DIVISOR_FIELDS, "sim_serve")
    return torch.stack([values[f].to(torch.int32) for f in SERVE_FIELDS],
                       dim=1).contiguous()


def sim_serve(shape, params, warmups, counts=None, device=None):
    """Launch the serving entry over a ``[G]`` grid (``shape`` a
    ``serving.loop.engine.ServingShape``, ``params`` its
    ``ServingParams``; ``counts`` int32 ``[G, n_steps]`` on the card
    pins the arrivals, else the kernel draws them).  Returns ``(sim
    stats, serve stats, final clock [G], (occ, qlen, arrivals) [G,
    n_steps] or None)`` laid out as ``ref.run_serve_ref`` returns them.
    ``device`` is the card (default: where ``warmups`` lies); the params
    may lie on the host.  Asynchronous on the current stream; a refused
    launch raises."""
    dev = warmups.device if device is None else torch.device(device)
    _build.require_cuda(dev, "sim_serve")
    lib = library()
    G = warmups.shape[0]
    n = shape.n_steps
    params_i, leak, offsets = pack(
        params.mech, torch.zeros(G, dtype=torch.int32,
                                 device=warmups.device))
    srow = pack_serve(params, warmups)
    params_i, leak, srow = _to_launch(dev, params_i, leak, srow)
    c_dims = _dims(lib, shape.sim, params.mech, G, params_i.shape[1], 1, 1,
                   n, 0, False)
    sdims = {"HHS": shape.hot.n_sets, "HW": shape.hot.n_ways,
             "hexact": int(shape.hot.exact_expiry), "SB": shape.max_batch,
             "Q": shape.queue_cap, "A": shape.arrivals_max,
             "Pp": shape.prompt_pages_max, "Pt": shape.pages_max,
             "n_steps": n, "collect": int(shape.collect_steps),
             "pinned": int(counts is not None), "PS": srow.shape[1]}
    c_sdims = _c_ints([sdims[k] for k in SERVE_DIMS])
    smem = lib.sim_serve_smem_bytes(ctypes.cast(c_dims, _P),
                                    ctypes.cast(c_sdims, _P))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"sim_serve needs {smem} B of shared memory per "
                         f"block; Hopper allows {MAX_SMEM_BYTES}")
    if counts is not None and (
            counts.device != dev or counts.dtype != torch.int32
            or tuple(counts.shape) != (G, n) or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous int32 [G={G}, "
                         f"n_steps={n}] tensor on {dev}")
    NB = shape.sim.envelope.max_banks_total
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    stats, bank_stats = i32(G, len(STAT_KEYS)), i32(G, 2, NB)
    serve, now = i32(G, len(SERVE_STAT_KEYS)), i32(G)
    steps = i32(3, G, n) if shape.collect_steps else i32(3, 1, 1)
    err = _build.launch(
        lib.sim_serve_launch, dev,
        ctypes.cast(c_dims, _P), ctypes.cast(_c_ints(offsets), _P),
        ctypes.cast(c_sdims, _P), params_i.data_ptr(), leak.data_ptr(),
        srow.data_ptr(), None if counts is None else counts.data_ptr(),
        stats.data_ptr(), bank_stats.data_ptr(), serve.data_ptr(),
        now.data_ptr(), steps.data_ptr())
    _check(lib, err, "sim_serve")
    sim_stats = {k: stats[:, i] for i, k in enumerate(STAT_KEYS)}
    for i, k in enumerate(BANK_STAT_KEYS):
        sim_stats[k] = bank_stats[:, i]
    serve_stats = {k: serve[:, i] for i, k in enumerate(SERVE_STAT_KEYS)}
    ys = tuple(steps) if shape.collect_steps else None
    return sim_stats, serve_stats, now, ys


def floor_div(a: torch.Tensor, d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(floor(a / d), a - d floor(a / d))`` of a contiguous int32 tensor
    by a positive divisor: on a CUDA tensor through the kernel's divider
    (``FloorDiv``, a launch of ``floor_div_kernel``), on a CPU tensor
    through PyTorch's floor division (its plain version)."""
    if not 1 <= d <= 2**31 - 1:
        raise ValueError(f"the divider takes a positive int32 divisor, "
                         f"not {d}")
    if a.dtype != torch.int32 or not a.is_contiguous():
        raise ValueError("floor_div takes a contiguous int32 tensor")
    if a.device.type == "cpu":
        return torch.div(a, d, rounding_mode="floor"), torch.remainder(a, d)
    _build.require_cuda(a.device, "floor_div")
    if a.numel() >= 2**31:
        raise ValueError("floor_div takes fewer than 2**31 values")
    q, r = torch.empty_like(a), torch.empty_like(a)
    err = _build.launch(library().sim_step_floor_div, a.device, a.data_ptr(),
                        a.numel(), d, q.data_ptr(), r.data_ptr())
    _check(library(), err, "floor_div")
    return q, r
