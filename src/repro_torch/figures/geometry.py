"""Table 5.1 geometry sensitivity: channel / bank variants as one grid
(port of ``benchmarks/geometry.py``).

The thesis evaluates ChargeCache across DRAM configurations (Table 5.1:
DDR3-1600, 1-2 channels, 8 banks a rank).  Fewer channels (and fewer
banks) concentrate the same request stream onto fewer row buffers, so
bank conflicts, and with them re-activations of highly-charged rows,
grow: ChargeCache's speedup rises as the channel count drops.

The geometry is per-point data padded into one ``DRAMEnvelope``, so the
whole geometry x mechanism matrix over two eight-core mixes is one
``sim_step`` launch a mix on the card (asserted).  ``--json PATH``
writes the labeled cells and the per-geometry speedups.

::

    python -m repro_torch.figures.geometry [--quick] [--device cpu] [--json PATH]
"""

from __future__ import annotations

from repro_torch.core.traces import random_mixes
from repro_torch.figures import common as C

#: thesis direction: ordering is over *decreasing* parallelism
GEOMS = ("ddr3_2ch", "ddr3_1ch", "ddr3_1ch_4bank")
MECHS = ("base", "chargecache", "nuat", "lldram")
N_MIXES = 2


def experiment(sizes: C.Sizes = C.THESIS, device=None):
    """(geometry x mechanism) over two eight-core mixes."""
    return C.mixes_experiment(
        random_mixes(N_MIXES, 8), {"geometry": list(GEOMS),
                                   "mechanism": list(MECHS)},
        sizes.n_req_8c, sizes.seed, device=device)


def geometry_grid(sizes: C.Sizes = C.THESIS, device=None):
    """The grid's Results and the kernel launches it made."""
    return C.launch_counted(experiment(sizes, device).run)


def study(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    (res, launches), us = C.timed(geometry_grid, sizes, device)
    C.check_launches("the geometry x mechanism grid", res, launches,
                     N_MIXES)
    # per-geometry ChargeCache weighted speedup, averaged over the mixes
    speedup = {g: C.mech_speedups(res.sel(geometry=g)) for g in GEOMS}
    return {"speedup_by_geometry": speedup, "launches": launches,
            "results": res, "us": us}


def document(out: dict) -> dict:
    """``repro``'s ``BENCH_geometry.json`` keys (``launches`` in place of
    its compile count)."""
    res = out["results"]
    return {"speedup_by_geometry": out["speedup_by_geometry"],
            "launches": out["launches"], "cells": res.to_table(),
            "meta": res.meta}


def rows(out: dict) -> list[str]:
    sp = out["speedup_by_geometry"]
    cc1 = sp["ddr3_1ch"]["chargecache"]
    cc2 = sp["ddr3_2ch"]["chargecache"]
    cc4b = sp["ddr3_1ch_4bank"]["chargecache"]
    return [C.csv_row(
        "geometry_channel_sensitivity", out["us"],
        f"launches={out['launches']};cc_2ch={cc2:.4f};cc_1ch={cc1:.4f}"
        f";cc_1ch4b={cc4b:.4f};ordering_ok={int(cc1 >= cc2)}")]


def run(sizes: C.Sizes = C.THESIS, device=None, json_path=None) -> list[str]:
    out = study(sizes, device)
    C.write_json(json_path, document(out))
    return rows(out)


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0], artifact=True)
