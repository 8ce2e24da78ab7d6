"""DRAMPower-style command-level energy model (thesis Fig 6.2 stand-in).

Port of ``repro.core.energy`` (numpy).

Energy = per-command charges (ACT/PRE pair scaled by the tRAS actually
used, RD/WR bursts, refresh) + background power x total runtime.  IDD
values follow a typical DDR3-1600 4 Gb x8 datasheet (Micron MT41J512M8),
8 devices per rank.  ChargeCache's energy saving comes from (i) shorter
execution time (background energy) and (ii) shorter tRAS windows on hits —
the same two effects the thesis reports.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.timing import TimingParams, DDR3_1600, CYCLE_NS


@dataclasses.dataclass(frozen=True)
class DDR3Power:
    vdd: float = 1.5
    idd0: float = 0.055    # ACT-PRE cycling current (A)
    idd2n: float = 0.032   # precharge standby
    idd3n: float = 0.038   # active standby
    idd4r: float = 0.155   # read burst
    idd4w: float = 0.145   # write burst
    idd5: float = 0.215    # refresh
    devices_per_rank: int = 8


def energy_nj(stats: dict, timing: TimingParams = DDR3_1600,
              power: DDR3Power = DDR3Power(), geom=None,
              n_channels: int | None = None) -> dict:
    """Total DRAM energy (nJ) from simulator stats.

    Geometry-aware device count: the rank population scaling comes from
    ``geom`` (a ``DRAMConfig``/``GeomParams``) when given, else from the
    active geometry the simulator recorded into ``stats`` (so a geometry
    sweep's cells account their own channel/rank counts), else from the
    Table 5.1 default.  ``n_channels`` remains as an explicit override.

    Per-bank offsets thread through two paths: the scalar ACT energy is
    charged over ``act_ras_sum`` — the tRAS windows *actually selected*
    per ACT, so AL-DRAM's per-bank margins (and ChargeCache's hit
    lowering) shorten the restore energy exactly as they shorten the
    timing — and, when the simulator's per-bank accumulators are present
    (``bank_act_ras_sum``), the same charge is also reported bank by
    bank as ``act_per_bank`` (summing to ``act``), which is what the
    AL-DRAM benchmark's per-bank spread reads (DESIGN.md §9).
    """
    p = power
    cyc_s = CYCLE_NS * 1e-9
    if n_channels is not None:
        n_ch, n_rk = int(n_channels), 1
    elif geom is not None:
        n_ch, n_rk = int(geom.n_channels), int(geom.n_ranks)
    else:
        n_ch = int(stats.get("n_channels", 2))
        n_rk = int(stats.get("n_ranks", 1))
    chips = p.devices_per_rank * n_ch * n_rk

    # ACT+PRE pair energy: (IDD0 - IDD3N) over the tRAS window plus
    # (IDD0 - IDD2N) over tRP, per the DRAMPower formulation.
    act_ras_cycles = float(stats["act_ras_sum"])
    acts = float(stats["acts"])
    e_act = (p.idd0 - p.idd3n) * p.vdd * act_ras_cycles * cyc_s
    e_pre = (p.idd0 - p.idd2n) * p.vdd * acts * timing.tRP * cyc_s

    e_rd = (p.idd4r - p.idd3n) * p.vdd * float(stats["reads"]) * timing.tBL * cyc_s
    e_wr = (p.idd4w - p.idd3n) * p.vdd * float(stats["writes"]) * timing.tBL * cyc_s

    total_cycles = float(stats["total_cycles"])
    # Refresh count: the wall-clock schedule rate.  The controller
    # refreshes every tREFI whether or not a request observes it, so
    # energy is charged per rank as total_cycles / tREFI — NOT the
    # stateful engine's ``refs_issued``, which counts REFs observed at
    # request arrival and undercounts trailing idle windows (DESIGN.md
    # §14 caveats); under ``with_refresh_pressure`` the shrunken tREFI
    # raises this term the way DDR4 2x/4x refresh raises IDD5 energy.
    n_ref = total_cycles / timing.tREFI
    e_ref = (p.idd5 - p.idd3n) * p.vdd * n_ref * timing.tRFC * cyc_s

    # background: assume active-standby while any row open; approximate with
    # a 50/50 active/precharge standby mix (the delta between mechanisms is
    # dominated by total_cycles, which is what matters for Fig 6.2).
    p_bg = 0.5 * (p.idd3n + p.idd2n) * p.vdd
    e_bg = p_bg * total_cycles * cyc_s

    scale = chips * 1e9  # -> nJ, all devices
    out = {k: v * scale for k, v in
           dict(act=e_act, pre=e_pre, rd=e_rd, wr=e_wr, ref=e_ref,
                background=e_bg).items()}
    out["total"] = sum(out.values())
    if stats.get("bank_act_ras_sum") is not None:
        per_bank_ras = np.asarray(stats["bank_act_ras_sum"], dtype=float)
        out["act_per_bank"] = ((p.idd0 - p.idd3n) * p.vdd * per_bank_ras
                               * cyc_s * scale)
    return out
