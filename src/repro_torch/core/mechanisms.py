"""Mechanism registry: pluggable DRAM timing policies (DESIGN.md §7.2).

Port of ``repro.core.mechanisms``.  Blocks are dicts of torch tensors
(0-d or small arrays per configuration; a sweep grid stacks them along a
leading ``[G]`` axis), and every ``select`` works on the stacked form:
each ``SelectCtx`` leaf is a ``[G]`` tensor, one entry per sweep point.

A *mechanism* is a policy object that contributes (a) a block of traced
parameters and (b) the timing-selection logic that consumes them inside
the simulator's scan body.  The simulator itself knows nothing about any
particular mechanism: it builds one params block per registered policy
(every block present at every grid point, gated by a traced ``enable``
leaf) and folds ``select`` over the registry in registration order —
mechanism choice stays *data*, so one compiled scan body serves a grid
mixing every registered kind, and a new mechanism is one
``@register_mechanism`` class with **zero simulator edits**.

Registration order is semantic: it is the application order of
``select``.  The builtins register as LL-DRAM → ChargeCache → NUAT,
reproducing the thesis ordering (always-lowered base, then HCRAC-hit
override, then NUAT minimum) bit-for-bit; RLTL and AL-DRAM fold after
as elementwise minima (minima commute, but AL-DRAM *must* follow the
ChargeCache override so ``cc_aldram`` hits take min(CC, bank margin)).

A registered name is also a *kind* accepted by ``MechanismConfig``.  A
kind may be a pure composition of other policies' blocks
(``components``): ``cc_nuat`` enables the ``chargecache`` and ``nuat``
blocks and contributes none of its own; ``base`` enables nothing.

The CUDA kernel of ``repro_torch.kernels.sim_step`` carries the bodies
of the builtin policies only; a grid whose registry differs from the
builtin set runs on the CPU (see ``kernels/sim_step/ops.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import aldram as aldram_lib
from repro_torch.core import charge_model
from repro_torch.core.timing import (TimingParams, TimingVec, DDR3_1600,
                                     ms_to_cycles)

#: MechanismConfig fields a policy may consume, with the canonicalizer
#: applied when *no* active policy reads them (``canonical_mech`` dedup —
#: a ``base`` run is the same run at any HCRAC capacity).  Canonical
#: values must preserve the grid-uniformity fields sweep() validates
#: (HCRAC ``n_ways`` / ``exact_expiry``): only behaviour-irrelevant
#: capacity/duration knobs are reset.
_KNOB_CANONICAL = {
    "hcrac": lambda h: dataclasses.replace(
        h, n_entries=64 * h.n_ways, caching_cycles=800_000),
    "lowered": lambda _: DDR3_1600.with_reduction(4, 8),
    "nuat_bins": lambda _: (),
    "aldram": lambda _: aldram_lib.ALDRAMConfig(),
    "thermal": lambda _: aldram_lib.ThermalConfig(),
}


class SelectCtx(NamedTuple):
    """Per-request context handed to ``MechanismPolicy.select``.

    Every leaf is a ``[G]`` tensor (one entry per sweep point) — policies
    keep their logic data-driven (``torch.where`` on their ``enable``
    leaf), never Python-branch on it.
    """
    timing: TimingVec       # baseline timing set, [G] leaves
    geom: "GeomParams"      # DRAM geometry (repro_torch.core.dram)
    hcrac_hit: torch.Tensor  # bool: HCRAC hit at this ACT (gated)
    tsr: torch.Tensor       # cycles since the row's last refresh at t_act
    tslp: torch.Tensor      # cycles since this row's last PRE, from the
                            # per-bank last-PRE register (INF if unknown)
    needs_act: torch.Tensor  # bool: this request activates (not a row hit)
    bank: torch.Tensor      # global bank id of this request, already
                            # folded into the active geometry (< the
                            # traced banks_total — per-bank tables padded
                            # to the envelope are safe to index with it)
    seg: torch.Tensor = 0   # thermal-drift segment index at t_act, already
                            # clipped to the grid's padded segment count
                            # (0 when the grid has no drift schedules —
                            # defaulted, so drift-free callers omit it)


class MechanismPolicy:
    """Base class for registry entries.  Subclass and decorate with
    ``@register_mechanism("name")``.

    Contract (DESIGN.md §7.2):

    * ``block(mech, timing, enabled, hints)`` returns the policy's traced
      param block — a flat dict of tensor leaves with *identical
      structure* whether ``enabled`` or not (disabled blocks are inert
      padding, so a mixed grid stacks into one pytree).  ``mech`` is
      ``None`` when the registry probes for block structure.  Return
      ``None`` to contribute no block (pure compositions, ``base``).
    * ``select(block, ctx, rcd, ras)`` folds the policy into the running
      (tRCD, tRAS) selection, gated on ``block["enable"]``.
    * ``pad_hints(mechs)`` returns static padding facts computed across a
      whole grid (e.g. the NUAT bin count) so every point's block shares
      one array shape.
    * ``uses_hcrac = True`` activates the simulator's HCRAC substrate
      (insert on PRE, lookup on ACT) whenever the block's ``enable`` is
      set; the lookup result arrives as ``ctx.hcrac_hit``.
    * ``consumes`` names the ``MechanismConfig`` fields the policy reads;
      fields no active component consumes are reset to defaults by
      ``canonical_mech`` (grid-point dedup).  The conservative default is
      "everything".
    """

    #: names of registered policies whose blocks this kind enables; None
    #: means "itself if block-bearing, else nothing".
    components: tuple[str, ...] | None = None
    uses_hcrac: bool = False
    consumes: tuple[str, ...] = ("hcrac", "lowered", "nuat_bins", "aldram",
                                 "thermal")

    name: str = ""        # set by register_mechanism
    has_block: bool = False  # set by register_mechanism (structure probe)

    def pad_hints(self, mechs: Sequence) -> dict:
        return {}

    def block(self, mech, timing: TimingParams, enabled: bool,
              hints: dict) -> dict | None:
        return None

    def select(self, block: dict, ctx: SelectCtx, rcd, ras):
        return rcd, ras


__all__ = [
    "MechanismPolicy", "SelectCtx", "register_mechanism", "get", "names",
    "components", "block_bearing", "pad_hints", "build_blocks",
    "hcrac_gate", "select_timings", "canonical_mech", "temporary",
    "default_nuat_bins",
]

_REGISTRY: dict[str, MechanismPolicy] = {}


def _b(v) -> torch.Tensor:
    return torch.tensor(bool(v))


def _i32(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v), dtype=torch.int32)


def register_mechanism(name: str):
    """Class decorator: instantiate and register a ``MechanismPolicy``."""
    def deco(cls):
        policy = cls() if isinstance(cls, type) else cls
        policy.name = name
        policy.has_block = policy.block(None, DDR3_1600, False,
                                        policy.pad_hints([])) is not None
        if policy.components is None:
            policy.components = (name,) if policy.has_block else ()
        if name in _REGISTRY:
            raise ValueError(f"mechanism {name!r} already registered")
        _REGISTRY[name] = policy
        return cls
    return deco


def get(name: str) -> MechanismPolicy:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown mechanism kind {name!r}; registered: {names()}")
    return _REGISTRY[name]


def names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def components(kind: str) -> tuple[str, ...]:
    """The block names a kind enables (its active policy set)."""
    return get(kind).components


def block_bearing() -> list[tuple[str, MechanismPolicy]]:
    """Registered policies that contribute a traced block, in registration
    (= application) order."""
    return [(n, m) for n, m in _REGISTRY.items() if m.has_block]


def pad_hints(mechs: Sequence) -> dict:
    """Grid-wide static padding facts, one dict per block-bearing policy."""
    return {n: m.pad_hints(mechs) for n, m in block_bearing()}


def build_blocks(mech, timing: TimingParams, hints: dict | None = None
                 ) -> dict[str, dict]:
    """One traced block per block-bearing policy; blocks of policies not
    in ``mech.kind``'s component set are built inert (enable=False)."""
    comps = components(mech.kind)
    hints = hints if hints is not None else pad_hints([mech])
    return {n: m.block(mech, timing, n in comps, hints.get(n, {}))
            for n, m in block_bearing()}


def hcrac_gate(blocks: dict[str, dict]):
    """Traced bool: any HCRAC-using policy enabled at this grid point."""
    gate = torch.tensor(False)
    for n, m in _REGISTRY.items():
        if m.uses_hcrac and n in blocks:
            gate = gate | blocks[n]["enable"]
    return gate


def select_timings(blocks: dict[str, dict], ctx: SelectCtx):
    """Fold every registered policy over the baseline (tRCD, tRAS)."""
    rcd, ras = ctx.timing.tRCD, ctx.timing.tRAS
    for n, m in block_bearing():
        if n in blocks:
            rcd, ras = m.select(blocks[n], ctx, rcd, ras)
    return rcd, ras


def canonical_mech(mech):
    """Reset every knob no active component consumes to its default.

    Two grid points whose canonical mechs (and remaining SimConfig
    fields) are equal run the same simulation bit-for-bit, so the
    experiment runner launches only one of them.
    """
    used: set[str] = set()
    for n in components(mech.kind):
        used |= set(get(n).consumes)
    repl = {f: canon(getattr(mech, f))
            for f, canon in _KNOB_CANONICAL.items() if f not in used}
    return dataclasses.replace(mech, **repl) if repl else mech


@contextlib.contextmanager
def temporary():
    """Scope registry mutations (tests): restores the entry set on exit."""
    saved = dict(_REGISTRY)
    try:
        yield
    finally:
        _REGISTRY.clear()
        _REGISTRY.update(saved)


# --------------------------------------------------------------------------
# Builtin mechanisms (the thesis kinds).  Registration order = application
# order: LL-DRAM base, then ChargeCache hit override, then NUAT minimum —
# identical to the pre-registry where-chain.
# --------------------------------------------------------------------------

def default_nuat_bins(timing: TimingParams = DDR3_1600):
    """NUAT 5PB bins: (upper-edge cycles, tRCD, tRAS), last bin = baseline.

    Bin timings come from the charge model evaluated at each bin's upper
    edge (worst case within the bin), as NUAT's SPICE methodology does.
    """
    edges_ms = (8.0, 16.0, 32.0, 48.0, 64.0)
    bins = []
    for e in edges_ms:
        d = charge_model.derive_timings(e)
        bins.append((ms_to_cycles(e),
                     min(d.tRCD_cycles, timing.tRCD),
                     min(d.tRAS_cycles, timing.tRAS)))
    return tuple(bins)


@register_mechanism("base")
class Baseline(MechanismPolicy):
    """DDR3 spec timings; enables no blocks."""
    components = ()
    consumes = ()


class _LoweredPolicy(MechanismPolicy):
    """Shared block shape for policies keyed on ``mech.lowered``."""

    def block(self, mech, timing, enabled, hints):
        low = timing if mech is None else mech.lowered
        return {"enable": _b(enabled),
                "tRCD": _i32(low.tRCD),
                "tRAS": _i32(low.tRAS)}


@register_mechanism("lldram")
class LLDRAM(_LoweredPolicy):
    """Always-lowered tRCD/tRAS (the thesis's upper-bound comparison)."""
    consumes = ("lowered",)

    def select(self, block, ctx, rcd, ras):
        rcd = torch.where(block["enable"], block["tRCD"], rcd)
        ras = torch.where(block["enable"], block["tRAS"], ras)
        return rcd, ras


@register_mechanism("chargecache")
class ChargeCache(_LoweredPolicy):
    """HCRAC hit → lowered tRCD/tRAS within the caching duration."""
    uses_hcrac = True
    consumes = ("hcrac", "lowered")

    def select(self, block, ctx, rcd, ras):
        hit = ctx.hcrac_hit & block["enable"]
        rcd = torch.where(hit, block["tRCD"], rcd)
        ras = torch.where(hit, block["tRAS"], ras)
        return rcd, ras


@register_mechanism("nuat")
class NUAT(MechanismPolicy):
    """Closed-form time-since-refresh bins → per-ACT timing minimum.

    Consumes ``thermal`` because its bin lookup reads the drift-scaled
    leak clock (``ctx.tsr`` ages faster in hot segments, DESIGN.md §14).
    """
    consumes = ("nuat_bins", "thermal")

    def pad_hints(self, mechs):
        return {"n_bins": max((len(m.nuat_bins) for m in mechs), default=0)}

    def block(self, mech, timing, enabled, hints):
        bins = [] if mech is None else list(mech.nuat_bins)
        nb = max(hints.get("n_bins", len(bins)), len(bins))
        pad = nb - len(bins)
        # zero-edge padding is inert: time-since-refresh is always >= 0,
        # so a zero-edge bin never matches (bitwise-neutral, DESIGN.md §4)
        edges = [e for e, _, _ in bins] + [0] * pad
        rcds = [r for _, r, _ in bins] + [timing.tRCD] * pad
        rass = [s for _, _, s in bins] + [timing.tRAS] * pad
        return {"enable": _b(enabled),
                "edge": _i32(edges),
                "rcd": _i32(rcds),
                "ras": _i32(rass)}

    def select(self, block, ctx, rcd, ras):
        n_rcd = ctx.timing.tRCD
        n_ras = ctx.timing.tRAS
        # last bin first, so the lowest matching bin wins
        for i in range(block["edge"].shape[-1] - 1, -1, -1):
            inbin = ctx.tsr < block["edge"][..., i]
            n_rcd = torch.where(inbin, block["rcd"][..., i], n_rcd)
            n_ras = torch.where(inbin, block["ras"][..., i], n_ras)
        rcd = torch.where(block["enable"], torch.minimum(rcd, n_rcd), rcd)
        ras = torch.where(block["enable"], torch.minimum(ras, n_ras), ras)
        return rcd, ras


@register_mechanism("rltl")
class RLTL(MechanismPolicy):
    """Direct row-level-temporal-locality exploitation (arXiv:1805.03969).

    The HPCA'16 paper's underlying observation, turned into the cheapest
    hardware embodiment: one *last-precharged-row register* per bank
    (tag + timestamp, no SRAM table).  An ACT whose row matches its bank's
    register within the charge window uses the lowered timings — exact
    for the dominant RLTL source (conflict ping-pong re-activating a row
    right after its own PRE), a miss whenever ≥ 2 other rows precharged
    in the bank since.  Versus ChargeCache this trades the shared HCRAC's
    reach for per-bank O(1) storage; the gap between the two is the value
    of the table.  The signal arrives as ``ctx.tslp`` (the simulator's
    per-bank last-PRE registers); the window and lowered timings reuse
    the ChargeCache knobs (``hcrac.caching_cycles`` is the same physical
    quantity — how long a precharged row stays highly charged).
    """
    consumes = ("hcrac", "lowered")

    def block(self, mech, timing, enabled, hints):
        low = timing if mech is None else mech.lowered
        window = (timing.tREFI if mech is None
                  else mech.hcrac.caching_cycles)
        return {"enable": _b(enabled),
                "window": _i32(window),
                "tRCD": _i32(low.tRCD),
                "tRAS": _i32(low.tRAS)}

    def select(self, block, ctx, rcd, ras):
        hit = block["enable"] & ctx.needs_act & (ctx.tslp < block["window"])
        rcd = torch.where(hit, torch.minimum(rcd, block["tRCD"]), rcd)
        ras = torch.where(hit, torch.minimum(ras, block["tRAS"]), ras)
        return rcd, ras


@register_mechanism("cc_nuat")
class ChargeCacheNUAT(MechanismPolicy):
    """Composition: ChargeCache hit override + NUAT minimum (thesis §6.4)."""
    components = ("chargecache", "nuat")
    consumes = ()


@register_mechanism("aldram")
class ALDRAM(MechanismPolicy):
    """AL-DRAM (arXiv:1805.03047): profiled per-bank timing margins.

    The block is a per-bank (tRCD, tRAS) table sized to the grid's
    padded ``DRAMEnvelope`` (the ``n_banks_padded`` hint injected by
    ``mech_params``) and derived host-side from the module's temperature
    / process bin (``repro.core.aldram``, DESIGN.md §9).  Entries beyond
    a point's active ``banks_total`` are never indexed — ``ctx.bank`` is
    already folded into the active geometry — and the derivation is
    position-stable, so padded and exact-geometry runs agree bitwise.

    ``select`` takes the elementwise *minimum* with the running
    selection; since ChargeCache folds first (registration order), a
    ``cc_aldram`` hit uses min(ChargeCache lowered, bank margin) and a
    miss still gets the bank margin — the static and dynamic levers
    compose instead of shadowing each other.  At the 85°C reference
    temperature the table clips to the spec and the policy is a bitwise
    no-op (the guardband the spec already pays).
    """
    consumes = ("aldram", "thermal")

    def pad_hints(self, mechs):
        # the grid-wide thermal segment count: every point's drift tables
        # (and the ThermalParams leaves mech_params builds) share one [S]
        return {"n_segs": max((m.thermal.n_segs for m in mechs), default=0)}

    def block(self, mech, timing, enabled, hints):
        S = hints.get("n_segs", 0)
        if mech is None:  # structure probe: a spec-valued (inert) table
            nb = hints.get("n_banks_padded", 16)
            rcd = np.full(nb, timing.tRCD, np.int64)
            ras = np.full(nb, timing.tRAS, np.int64)
            temps = ()
        else:
            # fail loudly rather than fall back: an undersized table
            # would be read past its end for every bank beyond it
            if "n_banks_padded" not in hints:
                raise ValueError(
                    "aldram blocks must be built through mech_params, which "
                    "injects the envelope bank count as the reserved "
                    "'n_banks_padded' hint")
            nb = hints["n_banks_padded"]
            rcd, ras = aldram_lib.per_bank_timings(mech.aldram, timing, nb)
            temps = mech.thermal.temps()
        # per-segment drift tables, padded to the grid-wide S by
        # repeating the static table (position-stable; padded segments
        # are never selected — their seg_edge is past the horizon)
        seg_rcd = np.tile(np.asarray(rcd)[None, :], (max(S, 1), 1))[:S]
        seg_ras = np.tile(np.asarray(ras)[None, :], (max(S, 1), 1))[:S]
        for i, tc in enumerate(temps):
            r_i, s_i = aldram_lib.per_bank_timings(
                dataclasses.replace(mech.aldram, temperature_c=tc),
                timing, nb)
            seg_rcd[i], seg_ras[i] = r_i, s_i
        return {"enable": _b(enabled),
                "drift": _b(enabled and len(temps) > 0),
                "rcd": _i32(rcd),
                "ras": _i32(ras),
                "seg_rcd": _i32(seg_rcd),
                "seg_ras": _i32(seg_ras)}

    def select(self, block, ctx, rcd, ras):
        on = block["enable"]
        g = torch.arange(on.shape[0], device=on.device)
        b_rcd = block["rcd"][g, ctx.bank]
        b_ras = block["ras"][g, ctx.bank]
        if block["seg_rcd"].shape[-2] > 0:  # static gate: grid has drift
            d = on & block["drift"]
            b_rcd = torch.where(d, block["seg_rcd"][g, ctx.seg, ctx.bank],
                                b_rcd)
            b_ras = torch.where(d, block["seg_ras"][g, ctx.seg, ctx.bank],
                                b_ras)
        rcd = torch.where(on, torch.minimum(rcd, b_rcd), rcd)
        ras = torch.where(on, torch.minimum(ras, b_ras), ras)
        return rcd, ras


@register_mechanism("cc_aldram")
class ChargeCacheALDRAM(MechanismPolicy):
    """Composition: ChargeCache × AL-DRAM — the thesis-direction
    interaction study.  A HCRAC hit uses min(ChargeCache lowered timing,
    the bank's AL-DRAM margin); every other ACT still gets the bank
    margin (fold order: ChargeCache override, then the AL-DRAM min)."""
    components = ("chargecache", "aldram")
    consumes = ()
