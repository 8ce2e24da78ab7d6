"""Paper experiment driver on the PyTorch/CUDA port: one workload (or
eight-core mix) x all mechanisms (the port of ``chargecache_sim.py``).

Run:  PYTHONPATH=src python examples/chargecache_sim_torch.py [--workload mcf_like]
      PYTHONPATH=src python examples/chargecache_sim_torch.py --eight-core
      PYTHONPATH=src python examples/chargecache_sim_torch.py --heat-grid
      PYTHONPATH=src python examples/chargecache_sim_torch.py --geo-grid
      ... --device cpu   (the plain engine; the default is the card)

Everything goes through the port's Experiment layer: the mechanism table
is a one-axis spec, ``--heat-grid`` a mechanism x capacity x duration
grid, and ``--geo-grid`` DRAM geometry (channel / bank presets) x
mechanism.  The runner dedups the shared baseline and runs the rest as
one ``sim_step`` launch a chunk on the card.  Each mode's function
returns the table it prints (``main`` returns the mode's).
"""

import argparse
import time

from repro_torch.core import SimConfig, weighted_speedup
from repro_torch.core.energy import energy_nj
from repro_torch.core.rltl import rltl_fractions
from repro_torch.core.traces import (WORKLOADS, multicore_batch, random_mixes,
                                     single_core_batch)
from repro_torch.experiment import Experiment

MECHS = ("base", "chargecache", "nuat", "cc_nuat", "rltl", "lldram")

GEO_PRESETS = ("ddr3_2ch", "ddr3_1ch", "ddr3_1ch_4bank")

HEAT_CAPS = (32, 64, 128, 256, 512, 1024)
HEAT_DURATIONS_MS = (0.5, 1.0, 2.0, 4.0, 16.0)


def heat_grid(batch, policy: str, device=None) -> dict:
    """capacity x duration hit-rate / speedup heat table, one Experiment;
    returns ``{"hit": {cap: [rate a duration]}, "speedup": {cap: [...]},
    "meta": ..., "seconds": ...}``."""
    exp = Experiment(
        traces=batch,
        axes={"mechanism": ["base", "chargecache"],
              "capacity": HEAT_CAPS,
              "duration_ms": HEAT_DURATIONS_MS},
        base=SimConfig(policy=policy), device=device)
    t0 = time.time()
    res = exp.run()
    dt = time.time() - t0
    m = res.meta
    print(f"\n{m['n_points']}-point mechanism x capacity x duration grid "
          f"({m['n_unique']} unique runs after baseline dedup) in "
          f"{m['n_chunks']} chunk(s): {dt:.1f}s "
          f"({1e3 * dt / m['n_unique']:.0f} ms/run)")

    hdr = "entries".rjust(8) + "".join(f"{d:g}ms".rjust(9)
                                       for d in HEAT_DURATIONS_MS)
    cc = res.sel(mechanism="chargecache")
    hit = {cap: [cc.point(capacity=cap, duration_ms=d)["hcrac_hit_rate"]
                 for d in HEAT_DURATIONS_MS] for cap in HEAT_CAPS}
    sp = res.pairwise(
        "mechanism", "base",
        lambda b, s: weighted_speedup(b["core_end"], s["core_end"]))
    speedup = {cap: [float(sp["chargecache"][i, j])
                     for j in range(len(HEAT_DURATIONS_MS))]
               for i, cap in enumerate(HEAT_CAPS)}
    print("\nHCRAC hit rate (rows: entries; cols: caching duration)")
    print(hdr)
    for cap in HEAT_CAPS:
        print(f"{cap:8d}" + "".join(f"{h:9.2%}" for h in hit[cap]))
    print("\nspeedup over baseline")
    print(hdr)
    for cap in HEAT_CAPS:
        print(f"{cap:8d}" + "".join(f"{s:9.4f}" for s in speedup[cap]))
    return {"hit": hit, "speedup": speedup, "meta": m, "seconds": dt}


def geo_grid(batch, policy: str, device=None) -> dict:
    """geometry x mechanism in one launch a chunk (channel sensitivity);
    returns ``{geometry: {"cc": .., "lldram": .., "conflicts": ..}}``."""
    t0 = time.time()
    res = Experiment(
        traces=batch,
        axes={"geometry": list(GEO_PRESETS),
              "mechanism": ["base", "chargecache", "lldram"]},
        base=SimConfig(policy=policy), device=device).run()
    dt = time.time() - t0
    print(f"\ngeometry x mechanism grid ({res.meta['n_unique']} unique "
          f"runs, one launch a chunk) in {dt:.1f}s")
    print(f"{'geometry':>16s} {'cc speedup':>11s} {'ll speedup':>11s} "
          f"{'conflicts':>10s}")
    table = {}
    for g in GEO_PRESETS:
        b = res.point(geometry=g, mechanism="base")
        cc = res.point(geometry=g, mechanism="chargecache")
        ll = res.point(geometry=g, mechanism="lldram")
        sp = lambda r: weighted_speedup(b["core_end"], r["core_end"])
        table[g] = {"cc": sp(cc), "lldram": sp(ll),
                    "conflicts": int(b["row_conflicts"])}
        print(f"{g:>16s} {table[g]['cc']:11.4f} {table[g]['lldram']:11.4f} "
              f"{table[g]['conflicts']:10d}")
    return table


def mechanism_table(batch, policy: str, eight_core: bool,
                    device=None) -> dict:
    """Every mechanism on ``batch`` in one Experiment (RLTL on); returns
    ``{"rltl": fractions of base, "rows": {kind: {"speedup", "hit_rate",
    "lowered", "energy"}}}``: weighted speedup on eight cores, the
    cycle ratio on one."""
    res = Experiment(traces=batch, axes={"mechanism": list(MECHS)},
                     base=SimConfig(policy=policy), rltl=True,
                     device=device).run()
    base = res.point(mechanism="base")
    f = rltl_fractions(base)
    print(f"\nRLTL: 0.125ms={f['rltl_0.125ms']:.2f}  8ms={f['rltl_8.0ms']:.2f}"
          f"  refresh-8ms={f['refresh_8ms_frac']:.2f}")
    print(f"{'mechanism':>12s} {'speedup':>8s} {'hit rate':>9s} "
          f"{'lowered':>8s} {'energy':>8s}")
    e_base = energy_nj(base)["total"]
    rows = {}
    for kind in MECHS:
        r = res.point(mechanism=kind)
        if eight_core:
            sp = weighted_speedup(base["core_end"], r["core_end"])
        else:
            sp = base["total_cycles"] / r["total_cycles"]
        rows[kind] = {"speedup": float(sp),
                      "hit_rate": float(r["hcrac_hit_rate"]),
                      "lowered": float(r["acts_lowered_frac"]),
                      "energy": float(energy_nj(r)["total"] / e_base)}
        print(f"{kind:>12s} {sp:8.4f} {r['hcrac_hit_rate']:9.2%} "
              f"{r['acts_lowered_frac']:8.2%} {rows[kind]['energy']:8.3f}")
    return {"rltl": f, "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="soplex_like",
                    choices=[w.name for w in WORKLOADS])
    ap.add_argument("--eight-core", action="store_true")
    ap.add_argument("--heat-grid", action="store_true",
                    help="capacity x duration sweep in one call")
    ap.add_argument("--geo-grid", action="store_true",
                    help="DRAM geometry x mechanism sweep in one call "
                         "(implies --eight-core: channel/bank sensitivity "
                         "needs multi-bank pressure)")
    ap.add_argument("--n-req", type=int, default=60_000)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain engine (default: the card)")
    args = ap.parse_args(argv)

    if args.geo_grid:
        args.eight_core = True
    if args.eight_core:
        mix = random_mixes(1, 8)[0]
        print(f"8-core mix: {mix}")
        batch = multicore_batch(mix, args.n_req // 4)
        policy = "closed"
    else:
        print(f"workload: {args.workload}")
        batch = single_core_batch(args.workload, args.n_req)
        policy = "open"

    if args.heat_grid:
        return heat_grid(batch, policy, args.device)
    if args.geo_grid:
        return geo_grid(batch, policy, args.device)
    return mechanism_table(batch, policy, args.eight_core, args.device)


if __name__ == "__main__":
    main()
