"""Workload profiles as tensors (port of ``repro.workloads.profiles``).

Every statistical knob of a ``traces.WorkloadProfile`` becomes a leaf of
``WorkloadParams`` (float32 probabilities, int32 counts), so a workload
axis stacks along the grid dimension like timing or geometry.  A
``WorkloadSpec`` with C cores gives ``[C, S]`` distributional leaves
(``S`` = phase-segment count) and ``[C]`` identity leaves; a sweep
stacks them to ``[G, C, S]`` / ``[G, C]``.

Phases: the distributional leaves carry a trailing segment axis plus a
``seg_edge [S]`` leaf of request-index boundaries.  A stationary spec is
``S == 1`` with ``seg_edge = [0]``.  Specs in one grid pad to the
grid-wide ``S`` by repeating the last real segment with a never-reached
edge (``2**30``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.traces import (WORKLOAD_BY_NAME, WorkloadProfile,
                                     WorkloadSpec)

__all__ = ["WorkloadParams", "profile_params", "spec_params", "max_len_of",
           "n_segs_of"]

#: never-reached request index padding for ``seg_edge``
_EDGE_INF = 2**30


class WorkloadParams(NamedTuple):
    """Per-core workload statistics as tensors: distributional leaves
    ``[..., S]``, identity leaves (seed, core, length) without it."""
    mean_gap: torch.Tensor     # f32 [S]: mean bus cycles between issues
    p_rowhit: torch.Tensor     # f32 [S]: row-buffer hit-run probability
    p_hot: torch.Tensor        # f32 [S]: P(new row from the hot set)
    p_seq: torch.Tensor        # f32 [S]: P(streaming row advance)
    p_dep: torch.Tensor        # f32 [S]: P(request depends on previous)
    p_write: torch.Tensor      # f32 [S]
    stack_zipf: torch.Tensor   # f32 [S]: Zipf exponent (>0) of hot ranks
    stack_geo: torch.Tensor    # f32 [S]: geometric fallback when zipf == 0
    hot_rows: torch.Tensor     # i32 [S]: hot-set size (virtual entries)
    n_hot_banks: torch.Tensor  # i32 [S]: banks the hot set concentrates in
    seg_edge: torch.Tensor     # i32 [S]: first request index of segment s
    seed: torch.Tensor         # i32: stream seed (shared by the spec)
    core_idx: torch.Tensor     # i32: this core's index (row slice + PRNG)
    n_cores: torch.Tensor      # i32: active core count (row-slice width)
    length: torch.Tensor       # i32: request count (traffic-scaled)


#: the float32 ``[S]`` leaves, in field order
FLOAT_LEAVES = ("mean_gap", "p_rowhit", "p_hot", "p_seq", "p_dep",
                "p_write", "stack_zipf", "stack_geo")


def profile_params(p: WorkloadProfile, length: int, seed: int,
                   core_idx: int, n_cores: int,
                   phases: tuple = (), n_segs: int | None = None
                   ) -> WorkloadParams:
    """One core's params from a host profile; ``phases`` is this core's
    ``(start_frac, WorkloadProfile)`` schedule after the base phase and
    ``n_segs`` pads the segment axis to a grid-wide count."""
    profs = [p] + [pp for _, pp in phases]
    edges = [0] + [int(fr * length) for fr, _ in phases]
    S = len(profs) if n_segs is None else int(n_segs)
    if S < len(profs):
        raise ValueError("n_segs smaller than the phase schedule")
    while len(profs) < S:          # position-stable padding: repeat the
        profs.append(profs[-1])    # last real segment, never reached
        edges.append(_EDGE_INF)
    f = lambda k: torch.tensor([getattr(q, k) for q in profs],
                               dtype=torch.float32)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    return WorkloadParams(
        mean_gap=torch.maximum(f("mean_gap"),
                               torch.tensor(1.001, dtype=torch.float32)),
        p_rowhit=f("p_rowhit"), p_hot=f("p_hot"), p_seq=f("p_seq"),
        p_dep=f("p_dep"), p_write=f("p_write"),
        stack_zipf=f("stack_zipf"), stack_geo=f("stack_geo"),
        hot_rows=i32([q.hot_rows for q in profs]),
        n_hot_banks=i32([q.n_hot_banks for q in profs]),
        seg_edge=i32(edges), seed=i32(seed), core_idx=i32(core_idx),
        n_cores=i32(n_cores), length=i32(length),
    )


def n_segs_of(specs: Sequence[WorkloadSpec]) -> int:
    """The grid-wide phase-segment count: the longest schedule."""
    specs = list(specs)
    if not specs:
        raise ValueError("empty workload spec set")
    return max(1 + len(s.phases) for s in specs)


def spec_params(spec: WorkloadSpec,
                n_segs: int | None = None) -> WorkloadParams:
    """The ``[C, S]``-leaved params of a ``WorkloadSpec``."""
    if not spec.names:
        raise ValueError("WorkloadSpec has no per-core profile names")
    lengths = spec.lengths()
    S = n_segs if n_segs is not None else n_segs_of([spec])
    cores = []
    for c, n in enumerate(spec.names):
        phases_c = tuple((fr, WORKLOAD_BY_NAME[nm[c]])
                         for fr, nm in spec.phases)
        cores.append(profile_params(
            WORKLOAD_BY_NAME[n], int(lengths[c]), spec.seed, c,
            spec.n_cores, phases=phases_c, n_segs=S))
    return WorkloadParams(*(torch.stack(xs) for xs in zip(*cores)))


def max_len_of(specs: Sequence[WorkloadSpec]) -> int:
    """The per-core array length a synthetic grid shares: the largest
    traffic-scaled request count over every spec."""
    specs = list(specs)
    if not specs:
        raise ValueError("empty workload spec set")
    return max(int(np.max(s.lengths())) for s in specs)
