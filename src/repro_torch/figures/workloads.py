"""On-device workload synthesis: the host leaves the hot path (port of
``benchmarks/workloads.py``).

Three claims:

1. **One launch, four axes**: a workload x interleave x geometry x
   mechanism grid through ``Experiment(traces=None)`` generates every
   point's request stream on the device, one launch of the synthesis
   entry on the card (asserted); the grid is ``repro_torch.golden.
   SYNTH``'s 32 points.
2. **Interleave sensitivity**: ChargeCache's speedup depends on the
   channel-interleave policy (row/XOR spreading against bank homing
   shifts bank conflicts, hence re-activations of highly-charged rows).
3. **Trace-length scaling**: generation on the device (``sweep_synth``)
   against the host-materialised path (``workloads.materialize`` on the
   host, the copy to the device and a trace-driven ``sweep``) at growing
   stream lengths, both warm, without RLTL events.

``--json PATH`` writes the speedups, the scaling and every cell.

::

    python -m repro_torch.figures.workloads [--quick] [--device cpu] [--json PATH]
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.core import WorkloadSpec, sweep, sweep_synth
from repro_torch.figures import common as C
from repro_torch.golden import tolerance_violations
from repro_torch.workloads import materialize

INTERLEAVES = ("bank", "row", "block", "xor")
GEOMS = ("ddr3_2ch", "ddr3_1ch")
MECHS = ("base", "chargecache")
MIXES = {
    "mix_hot": ["mcf_like", "omnetpp_like", "tpcc64_like", "milc_like",
                "soplex_like", "sphinx3_like", "gcc_like", "astar_like"],
    "mix_stream": ["stream_copy_like", "lbm_like", "libquantum_like",
                   "bwaves_like", "stream_triad_like", "leslie3d_like",
                   "GemsFDTD_like", "wrf_like"],
}
AXES = {"workload": MIXES, "interleave": list(INTERLEAVES),
        "geometry": list(GEOMS), "mechanism": list(MECHS)}


def experiment(sizes: C.Sizes = C.THESIS, device=None):
    """The four-axis grid, every stream generated on the device."""
    return C.synth_experiment(AXES, 8, sizes.n_req_8c, sizes.seed,
                              device=device)


def synth_grid(sizes: C.Sizes = C.THESIS, device=None):
    """The grid's Results and the kernel launches it made."""
    return C.launch_counted(experiment(sizes, device).run)


def scaling_cfgs(n_req: int, seed: int = C.SEED):
    spec = WorkloadSpec(names=tuple(MIXES["mix_hot"]), n_req=n_req,
                        seed=seed)
    return [dataclasses.replace(C.sim_cfg(k, 8), workload=spec)
            for k in MECHS]


def _sync(device) -> None:
    if device is None or str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def length_scaling(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    """Warm per-run cost: streamed generation against materialise-and-
    ship.  Both arms run the same base + chargecache pair over the same
    ``WorkloadSpec`` without RLTL events, so the only difference is where
    the stream comes from: generated inside the launch (streamed), or
    generated on the host and copied each run (materialised).  Each arm
    runs once before it is timed, and each timed run is one launch on the
    card (asserted); the two arms' stats agree (asserted, within the
    generator's tolerance: ``golden.STAT_TOLERANCE``)."""
    out = {}
    for n_req in sizes.scaling_lens:
        cfgs = scaling_cfgs(n_req, sizes.seed)
        sweep_synth(cfgs, rltl=False, device=device)  # warm
        _sync(device)
        t0 = time.time()
        synth, n_synth = C.launch_counted(sweep_synth, cfgs, rltl=False,
                                          device=device)
        synth_us = (time.time() - t0) * 1e6

        spec = cfgs[0].workload
        batch = materialize(spec, cfgs[0].dram, cfgs[0].interleave)
        sweep(batch, cfgs, rltl=False, device=device)  # warm
        _sync(device)
        t0 = time.time()
        batch = materialize(spec, cfgs[0].dram, cfgs[0].interleave)
        mat, n_mat = C.launch_counted(sweep, batch, cfgs, rltl=False,
                                      device=device)
        mat_us = (time.time() - t0) * 1e6
        want = 0 if device == "cpu" else 1
        if (n_synth, n_mat) != (want, want):
            raise AssertionError(f"length scaling at {n_req}: {n_synth} / "
                                 f"{n_mat} launches, expected {want} each")
        # the host's generator may round a rare float draw otherwise than
        # the card's, so the two arms' stats agree within the generator's
        # statistical tolerance (bitwise where the device is the same)
        for a, b in zip(synth, mat):
            off = tolerance_violations(a, b)
            if off:
                raise AssertionError(f"streamed and materialised stats "
                                     f"differ at {n_req} requests: {off}")
        out[n_req] = {"synth_us": synth_us, "materialized_us": mat_us,
                      "ratio": mat_us / max(synth_us, 1e-9)}
    return out


def study(sizes: C.Sizes = C.THESIS, device=None) -> dict:
    (res, launches), us = C.timed(synth_grid, sizes, device)
    C.check_launches("the workload x interleave x geometry x mechanism "
                     "grid", res, launches, 1)
    # interleave sensitivity of the ChargeCache speedup (2ch geometry:
    # with one channel the policies coincide and dedup)
    sens = {il: C.mech_speedups(res.sel(interleave=il, geometry="ddr3_2ch"))
            for il in INTERLEAVES}
    return {"speedup_by_interleave": sens,
            "length_scaling": length_scaling(sizes, device),
            "launches": launches, "results": res, "us": us}


def document(out: dict) -> dict:
    """``repro``'s ``BENCH_workloads.json`` keys (``launches`` in place of
    its compile count)."""
    res = out["results"]
    return {"speedup_by_interleave": out["speedup_by_interleave"],
            "length_scaling": {str(k): v for k, v in
                               out["length_scaling"].items()},
            "launches": out["launches"], "cells": res.to_table(),
            "meta": res.meta}


def rows(out: dict) -> list[str]:
    sens, scaling = out["speedup_by_interleave"], out["length_scaling"]
    cc = {il: sens[il]["chargecache"] for il in INTERLEAVES}
    spread = max(cc.values()) - min(cc.values())
    big = max(scaling)
    return [
        C.csv_row(
            "workloads_synth_grid", out["us"],
            f"launches={out['launches']};" +
            ";".join(f"cc_{il}={cc[il]:.4f}" for il in INTERLEAVES) +
            f";spread={spread:.4f}"),
        C.csv_row(
            "workloads_length_scaling", scaling[big]["synth_us"],
            ";".join(f"L{k}_ratio={v['ratio']:.2f}"
                     for k, v in scaling.items())),
    ]


def run(sizes: C.Sizes = C.THESIS, device=None, json_path=None) -> list[str]:
    out = study(sizes, device)
    C.write_json(json_path, document(out))
    return rows(out)


if __name__ == "__main__":
    C.main(run, __doc__.splitlines()[0], artifact=True)
