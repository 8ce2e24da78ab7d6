"""Workload model: statistically-matched synthetic memory-request traces.

Port of ``repro.core.traces``, kept verbatim: the same seed gives a
byte-identical ``TraceBatch`` in both packages (tested).

The thesis drives Ramulator with Pin traces of 22 SPEC CPU2006 / TPC /
STREAM workloads.  Neither Pin nor the benchmarks' inputs are available
here, so we generate synthetic traces whose *statistics* match the causal
properties the mechanism responds to:

* memory intensity (mean gap between requests, in bus cycles),
* row-buffer locality (probability the next request hits the open row),
* row-reuse behaviour (LRU-stack reuse with geometric stack distances over
  a per-workload hot set — this is what produces RLTL),
* working-set size (hot-set size; large sets thrash the 128-entry HCRAC,
  reproducing the mcf/omnetpp gap to LL-DRAM the thesis reports),
* streaming (sequential row advance; STREAM/lbm/libquantum-like),
* address dependencies (a fraction of requests cannot issue before the
  previous one completes) and read/write mix.

Profile parameters are calibrated so the reproduced aggregate statistics
(0.125 ms-RLTL ≈ 66 % single-core / 77 % eight-core, 8 ms-RLTL ≈ 86 %,
~12 % of ACTs within 8 ms of a refresh) match Section 3 of the thesis —
see benchmarks/rltl.py and EXPERIMENTS.md §Paper-validation.

Traces are generated with numpy (data preparation, not jitted) and are
fully deterministic given the seed.

This module is also the **numpy reference path** for the on-device
workload generator (``repro.workloads``, DESIGN.md §10): the profile
table below is shared by both paths, and the traced generator's
statistics are validated against ``generate_trace`` per profile within
documented tolerances (tests/test_workloads.py).  ``WorkloadSpec`` is
the host-side selection the synthetic path sweeps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.core.dram import DRAMConfig, DDR3_SYSTEM


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    name: str
    mean_gap: float        # mean bus cycles between request issues
    p_rowhit: float        # P(next request = same row; row-buffer hit run)
    hot_rows: int          # LRU reuse-stack size (per core, across banks)
    p_hot: float           # P(new row drawn from the reuse stack)
    stack_geo: float       # geometric parameter of the stack distance
    p_seq: float           # P(new row = previous row + 1) (streaming)
    p_dep: float           # P(request depends on previous completion)
    p_write: float = 0.3
    traffic: float = 1.0   # relative trace length multiplier (hmmer ~ 0)
    n_hot_banks: int = 2   # banks the hot set concentrates in (conflicts!)
    stack_zipf: float = 1.25  # >0: Zipf stack distances (heavy tail ->
                              # reuse intervals spread over decades, as the
                              # thesis's Fig 3.2 RLTL curves require);
                              # 0: geometric with ``stack_geo``


# 22 workloads, as in the thesis (SPEC CPU2006 + TPC + STREAM).  Names are
# suffixed "_like": the traces are synthetic stat-matched stand-ins,
# calibrated so the population statistics (RLTL curves, HCRAC hit rates,
# refresh-window fraction, speedup magnitudes) match Section 3 / 6 of the
# thesis — see benchmarks/rltl.py and EXPERIMENTS.md §Paper-validation.
# Fields: (name, mean_gap, p_rowhit, hot_rows, p_hot, stack_geo, p_seq,
#          p_dep, [p_write], [traffic], [n_hot_banks], [stack_zipf]).
WORKLOADS = [
    # --- memory-intensive SPEC (high RMPKC) ---
    WorkloadProfile("mcf_like", 28, 0.20, 16384, 0.90, 0.3, 0.00, 0.45,
                    n_hot_banks=3, stack_zipf=1.08),
    WorkloadProfile("lbm_like", 28, 0.62, 2048, 0.70, 0.3, 0.30, 0.10, 0.45,
                    n_hot_banks=2, stack_zipf=1.3),
    WorkloadProfile("milc_like", 36, 0.45, 8192, 0.88, 0.3, 0.10, 0.20,
                    n_hot_banks=2, stack_zipf=1.25),
    WorkloadProfile("libquantum_like", 30, 0.72, 1024, 0.75, 0.3, 0.40, 0.05,
                    n_hot_banks=2, stack_zipf=1.35),
    WorkloadProfile("omnetpp_like", 40, 0.15, 16384, 0.92, 0.3, 0.00, 0.60,
                    n_hot_banks=3, stack_zipf=1.1),
    WorkloadProfile("soplex_like", 36, 0.35, 8192, 0.90, 0.3, 0.05, 0.30,
                    n_hot_banks=2, stack_zipf=1.2),
    WorkloadProfile("GemsFDTD_like", 34, 0.55, 4096, 0.85, 0.3, 0.20, 0.15,
                    n_hot_banks=2, stack_zipf=1.3),
    WorkloadProfile("leslie3d_like", 38, 0.60, 4096, 0.85, 0.3, 0.25, 0.15,
                    n_hot_banks=2, stack_zipf=1.3),
    WorkloadProfile("sphinx3_like", 45, 0.40, 8192, 0.88, 0.3, 0.05, 0.25,
                    n_hot_banks=2, stack_zipf=1.25),
    WorkloadProfile("bwaves_like", 36, 0.60, 2048, 0.80, 0.3, 0.30, 0.10,
                    n_hot_banks=2, stack_zipf=1.3),
    # --- medium intensity ---
    WorkloadProfile("astar_like", 90, 0.25, 8192, 0.88, 0.3, 0.00, 0.50,
                    n_hot_banks=2, stack_zipf=1.2),
    WorkloadProfile("gcc_like", 110, 0.35, 8192, 0.88, 0.3, 0.05, 0.35,
                    n_hot_banks=2, stack_zipf=1.25),
    WorkloadProfile("zeusmp_like", 80, 0.55, 4096, 0.85, 0.3, 0.20, 0.15,
                    n_hot_banks=2, stack_zipf=1.3),
    WorkloadProfile("cactusADM_like", 95, 0.50, 4096, 0.85, 0.3, 0.15, 0.20,
                    n_hot_banks=2, stack_zipf=1.3),
    WorkloadProfile("wrf_like", 100, 0.55, 4096, 0.85, 0.3, 0.20, 0.15,
                    n_hot_banks=2, stack_zipf=1.3),
    WorkloadProfile("dealII_like", 140, 0.40, 8192, 0.88, 0.3, 0.05, 0.30,
                    n_hot_banks=2, stack_zipf=1.25),
    WorkloadProfile("gobmk_like", 220, 0.30, 8192, 0.85, 0.3, 0.02, 0.40,
                    n_hot_banks=2, stack_zipf=1.2),
    # --- cache-resident (the thesis notes hmmer produces no DRAM traffic) ---
    WorkloadProfile("hmmer_like", 4000, 0.30, 64, 0.50, 0.3, 0.00, 0.30,
                    traffic=0.01, n_hot_banks=2, stack_zipf=1.4),
    # --- TPC ---
    WorkloadProfile("tpcc64_like", 48, 0.25, 16384, 0.90, 0.3, 0.00, 0.50,
                    n_hot_banks=3, stack_zipf=1.12),
    WorkloadProfile("tpch2_like", 42, 0.45, 8192, 0.88, 0.3, 0.10, 0.30,
                    n_hot_banks=2, stack_zipf=1.2),
    # --- STREAM ---
    WorkloadProfile("stream_copy_like", 26, 0.75, 1024, 0.70, 0.3, 0.55,
                    0.05, 0.5, n_hot_banks=2, stack_zipf=1.35),
    WorkloadProfile("stream_triad_like", 26, 0.72, 1024, 0.70, 0.3, 0.50,
                    0.05, 0.4, n_hot_banks=2, stack_zipf=1.35),
]

# Final intensity calibration: tighter issue gaps and a higher
# address-dependency fraction bring the population's memory-latency
# *sensitivity* in line with the thesis's Fig 6.1 (validated: 8-core
# CC +7.7% vs paper +8.6%, NUAT +3.0% vs +2.5%, LL-DRAM +15.3% vs ~13%,
# single-core CC ~+2.3% vs +2.1%).
WORKLOADS = [dataclasses.replace(w,
                                 mean_gap=max(6, w.mean_gap * 0.55),
                                 p_dep=min(0.9, w.p_dep + 0.25))
             for w in WORKLOADS]

WORKLOAD_BY_NAME = {w.name: w for w in WORKLOADS}


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Host-side (hashable) selection of a *synthetic* workload: the
    profile name per core plus the stream sizing.  This is the value
    carried by ``SimConfig.workload`` for the on-device generation path
    (``repro.workloads``, DESIGN.md §10) and swept by
    ``register_axis("workload")`` — the traced-pytree view is
    ``repro.workloads.profiles.spec_params``.  It lives here (next to
    the shared profile table) so ``repro.core`` never imports upward.
    """
    names: tuple[str, ...] = ()
    n_req: int = 20_000
    seed: int = 0
    #: phase-changing profiles along the stream (DESIGN.md §14): extra
    #: ``(start_frac, names)`` segments after the base ``names`` phase —
    #: at request index ``int(start_frac * length)`` each core switches
    #: to the segment's profile.  Sizing (``lengths``) stays keyed to
    #: the base phase; empty = stationary (bitwise-identical streams).
    phases: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "names", tuple(self.names))
        for n in self.names:
            assert n in WORKLOAD_BY_NAME, (
                f"unknown workload profile {n!r}")
        assert self.n_req >= 8
        ph = tuple((float(fr), tuple(nm)) for fr, nm in self.phases)
        object.__setattr__(self, "phases", ph)
        last = 0.0
        for fr, nm in ph:
            assert 0.0 < fr < 1.0 and fr >= last, (
                "phase start fractions must be increasing in (0, 1)")
            last = fr
            assert len(nm) == len(self.names), (
                "each phase needs one profile per core")
            for n in nm:
                assert n in WORKLOAD_BY_NAME, (
                    f"unknown workload profile {n!r}")

    @property
    def n_cores(self) -> int:
        return len(self.names)

    def lengths(self) -> np.ndarray:
        """Per-core request counts (the reference ``traffic`` scaling)."""
        return np.array(
            [max(8, int(self.n_req * WORKLOAD_BY_NAME[n].traffic))
             for n in self.names], np.int32)

    @property
    def max_len(self) -> int:
        return int(self.lengths().max())


class Trace(NamedTuple):
    """One core's request stream (row-granular; columns fold into p_rowhit)."""
    gap: np.ndarray       # [L] int32 bus cycles since previous issue
    bank: np.ndarray      # [L] int32 global bank id
    row: np.ndarray       # [L] int32 row within bank
    is_write: np.ndarray  # [L] bool
    dep: np.ndarray       # [L] bool


def generate_trace(profile: WorkloadProfile, n_req: int, seed: int,
                   dram: DRAMConfig = DDR3_SYSTEM,
                   row_base: int = 0, row_span: int | None = None) -> Trace:
    """Generate one core's trace.

    ``row_base``/``row_span`` confine the workload to a row slice so that
    multiprogrammed cores use separate memory regions that conflict on
    banks but not rows (thesis §6.1's explanation of 8-core behaviour).
    """
    n_req = max(8, int(n_req * profile.traffic))
    rng = np.random.default_rng(seed)
    span = row_span or dram.n_rows
    nb = dram.banks_total

    gap = rng.geometric(1.0 / max(profile.mean_gap, 1.001), n_req).astype(np.int32)
    is_write = rng.random(n_req) < profile.p_write
    dep = rng.random(n_req) < profile.p_dep

    bank = np.zeros(n_req, np.int32)
    row = np.zeros(n_req, np.int32)
    # LRU reuse stack of (bank, row) pairs; the hot set concentrates in a
    # small bank subset so hot rows conflict (and re-activate) frequently —
    # the mechanism behind RLTL (thesis §3).
    hot_banks = rng.choice(nb, size=min(profile.n_hot_banks, nb),
                           replace=False)
    stack_b = hot_banks[rng.integers(0, len(hot_banks),
                                     profile.hot_rows)].astype(np.int32)
    stack_r = (row_base + rng.integers(0, span, profile.hot_rows)).astype(np.int32)
    cur_b, cur_r = int(stack_b[0]), int(stack_r[0])

    u = rng.random((n_req, 3))
    if profile.stack_zipf > 0:
        stack_pick = np.minimum(rng.zipf(profile.stack_zipf, n_req) - 1,
                                profile.hot_rows - 1)
    else:
        stack_pick = np.minimum(
            rng.geometric(profile.stack_geo, n_req) - 1,
            profile.hot_rows - 1)
    rand_b = hot_banks[rng.integers(0, len(hot_banks), n_req)]
    rand_r = row_base + rng.integers(0, span, n_req)

    for i in range(n_req):
        if u[i, 0] < profile.p_rowhit:
            pass  # row-buffer hit run: same (bank, row)
        elif u[i, 1] < profile.p_seq:
            cur_r = row_base + (cur_r - row_base + 1) % span  # streaming
        elif u[i, 2] < profile.p_hot:
            j = stack_pick[i]
            cur_b, cur_r = int(stack_b[j]), int(stack_r[j])
            # move-to-front
            stack_b[1:j + 1] = stack_b[:j]
            stack_r[1:j + 1] = stack_r[:j]
            stack_b[0], stack_r[0] = cur_b, cur_r
        else:
            cur_b, cur_r = int(rand_b[i]), int(rand_r[i])
            stack_b[1:] = stack_b[:-1]
            stack_r[1:] = stack_r[:-1]
            stack_b[0], stack_r[0] = cur_b, cur_r
        bank[i] = cur_b
        row[i] = cur_r

    return Trace(gap=gap, bank=bank, row=row,
                 is_write=is_write.astype(bool), dep=dep.astype(bool))


class TraceBatch(NamedTuple):
    """Padded multi-core trace batch for the simulator."""
    gap: np.ndarray        # [C, L]
    bank: np.ndarray       # [C, L]
    row: np.ndarray        # [C, L]
    is_write: np.ndarray   # [C, L]
    dep: np.ndarray        # [C, L]
    next_same: np.ndarray  # [C, L] next request (this core) to same bank
                           # targets the same row -> keep row open under
                           # the closed-row policy (queue-hit lookahead)
    length: np.ndarray     # [C]


def _next_same(trace: Trace) -> np.ndarray:
    n = len(trace.bank)
    out = np.zeros(n, bool)
    last_idx: dict[int, int] = {}
    for i in range(n - 1, -1, -1):
        b = int(trace.bank[i])
        j = last_idx.get(b)
        out[i] = j is not None and trace.row[j] == trace.row[i]
        last_idx[b] = i
    return out


def batch_traces(traces: list[Trace]) -> TraceBatch:
    c = len(traces)
    lengths = np.array([len(t.gap) for t in traces], np.int32)
    L = int(lengths.max())

    def pad(xs, dtype):
        out = np.zeros((c, L), dtype)
        for i, x in enumerate(xs):
            out[i, :len(x)] = x
        return out

    return TraceBatch(
        gap=pad([t.gap for t in traces], np.int32),
        bank=pad([t.bank for t in traces], np.int32),
        row=pad([t.row for t in traces], np.int32),
        is_write=pad([t.is_write for t in traces], bool),
        dep=pad([t.dep for t in traces], bool),
        next_same=pad([_next_same(t) for t in traces], bool),
        length=lengths,
    )


def pad_batch_to(batch: TraceBatch, max_len: int) -> TraceBatch:
    """Zero-pad a batch's request arrays to ``max_len`` (lengths unchanged).

    Padding is behaviour-neutral: the simulator treats requests past
    ``length`` as exhausted (their issue time is +inf), so a padded batch
    produces bitwise-identical stats while sharing array shapes — and
    therefore one compilation — with larger batches (DESIGN.md §4).
    """
    c, L = batch.gap.shape
    assert max_len >= L
    if max_len == L:
        return batch
    def pad(x):
        out = np.zeros((c, max_len), x.dtype)
        out[:, :L] = x
        return out
    return TraceBatch(
        gap=pad(batch.gap), bank=pad(batch.bank), row=pad(batch.row),
        is_write=pad(batch.is_write), dep=pad(batch.dep),
        next_same=pad(batch.next_same), length=batch.length)


def single_core_batch(name: str, n_req: int, seed: int = 0,
                      dram: DRAMConfig = DDR3_SYSTEM) -> TraceBatch:
    return batch_traces([generate_trace(WORKLOAD_BY_NAME[name], n_req, seed,
                                        dram)])


def multicore_batch(names: list[str], n_req: int, seed: int = 0,
                    dram: DRAMConfig = DDR3_SYSTEM) -> TraceBatch:
    """Multiprogrammed mix: each core gets its own row-address slice."""
    span = dram.n_rows // max(len(names), 1)
    traces = [
        generate_trace(WORKLOAD_BY_NAME[n], n_req, seed * 1000 + i, dram,
                       row_base=i * span, row_span=span)
        for i, n in enumerate(names)
    ]
    return batch_traces(traces)


def random_mixes(n_mixes: int, n_cores: int, seed: int = 42) -> list[list[str]]:
    """The thesis's 20 random 8-core multiprogrammed mixes."""
    rng = np.random.default_rng(seed)
    names = [w.name for w in WORKLOADS]
    return [[names[j] for j in rng.integers(0, len(names), n_cores)]
            for _ in range(n_mixes)]
