"""AL-DRAM temperature sensitivity: the per-bank-margin study as one grid
(port of ``benchmarks/aldram.py``).

AL-DRAM (arXiv:1805.03047) lowers timings by each module's *profiled*
margin, large when cool and zero at the 85 °C guardband: the static
complement to ChargeCache's access-recency lowering.  One Experiment
runs temperature x geometry x mechanism (55/70/85 °C x two channel
variants x base/chargecache/aldram/cc_aldram) over two eight-core mixes;
the per-bank tables are padded to the shared ``DRAMEnvelope``, so on the
card the study is one ``sim_step`` launch a mix (asserted).  Mechanisms
that ignore the temperature dedup across its axis.

The row reports the per-temperature speedups (AL-DRAM's grows as the
module cools, ChargeCache's does not move), the cc_aldram interaction,
and ``--json PATH`` writes them with the measured per-bank effective-tRAS
spread (the process-variation signature of the per-bank table).

::

    python -m repro_torch.figures.aldram [--quick] [--device cpu] [--json PATH]
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.aldram import TEMPERATURE_BINS_C
from repro_torch.core.traces import random_mixes
from repro_torch.figures import common as C

TEMPS = TEMPERATURE_BINS_C            # 55 / 70 / 85 °C
GEOMS = ("ddr3_2ch", "ddr3_1ch")
MECHS = ("base", "chargecache", "aldram", "cc_aldram")
N_MIXES = 2


def experiment(sizes: C.Sizes = C.THESIS, device=None):
    """(temperature x geometry x mechanism) over two eight-core mixes."""
    return C.mixes_experiment(
        random_mixes(N_MIXES, 8),
        {"temperature": list(TEMPS), "geometry": list(GEOMS),
         "mechanism": list(MECHS)},
        sizes.n_req_8c, sizes.seed, device=device)


def aldram_grid(sizes: C.Sizes = C.THESIS, device=None):
    """The grid's Results and the kernel launches it made."""
    return C.launch_counted(experiment(sizes, device).run)


def per_bank_spread(res, temp: float, geometry: str = "ddr3_2ch") -> dict:
    """Measured per-bank mean tRAS of the aldram cells at one bin: the
    spread across *active* banks (padded entries stay zero)."""
    row = res.sel(temperature=temp, geometry=geometry, mechanism="aldram")
    acts = ras = 0.0
    for cell in row.cells.flat:
        nb = int(cell["banks_total"])
        acts = acts + np.asarray(cell["bank_acts"][:nb], float)
        ras = ras + np.asarray(cell["bank_act_ras_sum"][:nb], float)
    per_bank = (ras / np.maximum(acts, 1))[acts > 0]  # accessed banks only
    return {"min": float(per_bank.min()), "max": float(per_bank.max()),
            "mean": float(per_bank.mean()),
            "spread": float(per_bank.max() - per_bank.min())}


def summarize(speedup: dict) -> dict:
    """The row's numbers from the per-temperature speedups, and
    ``ordering_ok``: AL-DRAM's margin (and speedup) grows as the module
    cools and vanishes at the 85 °C guardband; cc_aldram compounds
    both."""
    g0 = GEOMS[0]
    al55 = speedup["55C"][g0]["aldram"]
    al70 = speedup["70C"][g0]["aldram"]
    al85 = speedup["85C"][g0]["aldram"]
    cca55 = speedup["55C"][g0]["cc_aldram"]
    cc55 = speedup["55C"][g0]["chargecache"]
    ok = int(al55 >= al70 >= al85 and abs(al85 - 1.0) < 1e-9
             and cca55 >= max(cc55, al55) - 1e-9)
    return {"al_55": al55, "al_70": al70, "al_85": al85, "cc": cc55,
            "cc_aldram_55": cca55, "ordering_ok": ok}


def study(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    (res, launches), us = C.timed(aldram_grid, sizes, device)
    C.check_launches("the temperature x geometry x mechanism grid", res,
                     launches, N_MIXES)
    speedup = {
        f"{int(t)}C": {g: C.mech_speedups(res.sel(temperature=t, geometry=g))
                       for g in GEOMS}
        for t in TEMPS}
    return {"speedup_by_temperature": speedup,
            "per_bank_tras": {f"{int(t)}C": per_bank_spread(res, t)
                              for t in TEMPS},
            "summary": summarize(speedup), "launches": launches,
            "results": res, "us": us}


def document(out: dict) -> dict:
    """``repro``'s ``BENCH_aldram.json`` keys (``launches`` in place of its
    compile count)."""
    res = out["results"]
    return {"speedup_by_temperature": out["speedup_by_temperature"],
            "per_bank_tras": out["per_bank_tras"],
            "launches": out["launches"], "cells": res.to_table(),
            "meta": res.meta}


def rows(out: dict) -> list[str]:
    s = out["summary"]
    return [C.csv_row(
        "aldram_temperature_sensitivity", out["us"],
        f"launches={out['launches']};al_55={s['al_55']:.4f}"
        f";al_70={s['al_70']:.4f};al_85={s['al_85']:.4f};cc={s['cc']:.4f}"
        f";cc_aldram_55={s['cc_aldram_55']:.4f}"
        f";ordering_ok={s['ordering_ok']}")]


def run(sizes: C.Sizes = C.THESIS, device=None, json_path=None) -> list[str]:
    out = study(sizes, device)
    C.write_json(json_path, document(out))
    return rows(out)


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0], artifact=True)
