"""DRAM geometry, address mapping, and refresh-phase arithmetic.

Port of ``repro.core.dram``: DDR3-1600, 1-2 channels, 1 rank/channel,
8 banks/rank, 64 K rows/bank, 8 KB row buffer (Table 5.1).  Banks are
indexed globally (``channel * banks_per_channel + bank``).

``DRAMConfig`` describes one concrete system; a sweep grid splits it
into the static ``DRAMEnvelope`` (the padded bank/channel counts that
size the state) and the per-point ``GeomParams`` tensors (the active
counts).  Address mapping is modular arithmetic over the active counts,
so banks beyond a point's active count are never addressed.

Refresh is the rolling all-bank auto-refresh: every ``tREFI`` one of
``n_refresh_groups`` row groups is refreshed, so row ``r`` is recharged
at ``(r mod G) * tREFI + k * retention`` — a closed form for
time-since-refresh.

Every function takes tensors (or Python ints for static values) and
follows JAX's integer semantics: floor division and floor modulo
wherever an operand can be negative.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple

import torch

NO_ROW = -1


def floordiv(a, b):
    """Floor division, as ``jnp.floor_divide`` on integers."""
    return torch.div(a, b, rounding_mode="floor")


@dataclasses.dataclass(frozen=True)
class DRAMConfig:
    n_channels: int = 2
    n_ranks: int = 1
    n_banks: int = 8          # per rank
    n_rows: int = 65536       # per bank
    row_buffer_bytes: int = 8192

    @property
    def banks_total(self) -> int:
        return self.n_channels * self.n_ranks * self.n_banks

    @property
    def banks_per_channel(self) -> int:
        return self.n_ranks * self.n_banks


#: Default two-channel system of Table 5.1.
DDR3_SYSTEM = DRAMConfig()


@dataclasses.dataclass(frozen=True)
class DRAMEnvelope:
    """The static half of the geometry: the padded layout every grid point
    shares.  ``max_channels`` / ``max_banks_total`` size the state."""
    max_channels: int = 2
    max_banks_total: int = 16
    max_rows: int = 65536

    def covers(self, cfg: DRAMConfig) -> bool:
        return (self.max_channels >= cfg.n_channels
                and self.max_banks_total >= cfg.banks_total
                and self.max_rows >= cfg.n_rows)


def envelope_of(cfgs: Iterable[DRAMConfig]) -> DRAMEnvelope:
    """The smallest ``DRAMEnvelope`` covering every config in ``cfgs``."""
    cfgs = list(cfgs)
    if not cfgs:
        raise ValueError("envelope of an empty geometry set")
    return DRAMEnvelope(
        max_channels=max(c.n_channels for c in cfgs),
        max_banks_total=max(c.banks_total for c in cfgs),
        max_rows=max(c.n_rows for c in cfgs),
    )


class GeomParams(NamedTuple):
    """Active DRAM geometry as int32 tensors (0-d, or ``[G]`` stacked)."""
    n_channels: torch.Tensor
    n_ranks: torch.Tensor
    n_banks: torch.Tensor            # per rank
    n_rows: torch.Tensor             # per bank
    banks_total: torch.Tensor        # n_channels * n_ranks * n_banks
    banks_per_channel: torch.Tensor  # n_ranks * n_banks
    row_buffer_bytes: torch.Tensor


def geom_params(cfg: DRAMConfig) -> GeomParams:
    """The tensor view of a concrete ``DRAMConfig``."""
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    return GeomParams(
        n_channels=i32(cfg.n_channels),
        n_ranks=i32(cfg.n_ranks),
        n_banks=i32(cfg.n_banks),
        n_rows=i32(cfg.n_rows),
        banks_total=i32(cfg.banks_total),
        banks_per_channel=i32(cfg.banks_per_channel),
        row_buffer_bytes=i32(cfg.row_buffer_bytes),
    )


def channel_of(geom: GeomParams, global_bank):
    """Channel owning a global bank id."""
    return floordiv(global_bank, geom.banks_per_channel)


def global_row_id(geom: GeomParams, global_bank, row):
    """Unique id for (bank, row) — the HCRAC tag (thesis Eq. 6.2)."""
    return global_bank * geom.n_rows + row


def fold_address(geom: GeomParams, bank, row):
    """Map a trace's (bank, row) into the active geometry: the identity
    for a trace generated against it, a contention-preserving fold onto
    fewer banks otherwise."""
    return (torch.remainder(bank, geom.banks_total),
            torch.remainder(row, geom.n_rows))


@dataclasses.dataclass(frozen=True)
class InterleaveConfig:
    """Host-side channel-interleave policy selection (see
    ``repro.core.dram.InterleaveConfig``).  Only the dataclass is carried:
    address composition belongs to the on-device synthesis path, which
    this package does not have yet."""
    kind: str = "bank"
    block_rows: int = 32

    def __post_init__(self):
        if self.kind not in ("bank", "row", "block", "xor"):
            raise ValueError(f"unknown interleave kind {self.kind!r}")
        if self.block_rows < 1:
            raise ValueError("block_rows must be >= 1")


def time_since_refresh(geom, timing, row, t):
    """Cycles since row ``row``'s group was last refreshed, at cycle ``t``
    (closed form of the rolling schedule; always in ``[0, retention)``)."""
    phase = torch.remainder(row, timing.n_refresh_groups) * timing.tREFI
    return torch.remainder(t - phase, timing.retention_cycles)


def refresh_adjust(timing, t, row=None):
    """Earliest cycle >= t at which a bank command may issue under the
    legacy closed-form refresh blackout (the first ``tRFC`` cycles of
    every ``tREFI`` window).  With ``row`` given, only the refresh group
    restored in the current window stalls."""
    r = torch.remainder(t, timing.tREFI)
    busy = r < timing.tRFC
    if row is not None:
        groups = timing.n_refresh_groups
        busy = busy & (torch.remainder(row, groups)
                       == torch.remainder(floordiv(t, timing.tREFI), groups))
    return torch.where(busy, t + (timing.tRFC - r), t)


def refresh_clamp_span(timing, t, span, row=None):
    """Earliest start >= ``t`` such that ``[start, start + span)`` avoids
    the refresh blackout (requires ``span <= tREFI - tRFC``).  With
    ``row`` given, only the window whose group matches the row stalls."""
    tREFI = timing.tREFI
    tRFC = timing.tRFC
    r = torch.remainder(t, tREFI)
    base = t - r
    in_this = r < tRFC
    into_next = r + span > tREFI
    if row is not None:
        groups = timing.n_refresh_groups
        k = floordiv(t, tREFI)
        g = torch.remainder(row, groups)
        in_this = in_this & (g == torch.remainder(k, groups))
        into_next = into_next & (g == torch.remainder(k + 1, groups))
    fixed = torch.where(in_this, base + tRFC, base + tREFI + tRFC)
    return torch.where(in_this | into_next, fixed, t)
