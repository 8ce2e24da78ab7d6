"""Quickstart on the PyTorch/CUDA port: simulate a DDR3 system with and
without ChargeCache (the port of ``quickstart.py``'s
``chargecache_demo``).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``quickstart.py``'s second half, one training step, waits for the port's
optimizer and train step (ROADMAP.md, Queue 1 item 3).
"""

import argparse

from repro_torch.core.traces import single_core_batch
from repro_torch.experiment import Experiment


def chargecache_demo(device=None) -> dict:
    """Base against ChargeCache on a soplex-like workload; returns the
    two cells."""
    print("== ChargeCache on a synthetic soplex-like workload ==")
    batch = single_core_batch("soplex_like", 40_000, seed=1)
    res = Experiment(traces=batch,
                     axes={"mechanism": ["base", "chargecache"]},
                     device=device).run()
    base = res.point(mechanism="base")
    cc = res.point(mechanism="chargecache")
    print(f"  baseline cycles : {base['total_cycles']:,}")
    print(f"  chargecache     : {cc['total_cycles']:,}"
          f"  (speedup {base['total_cycles'] / cc['total_cycles']:.3f}x)")
    print(f"  HCRAC hit rate  : {cc['hcrac_hit_rate']:.1%}")
    print(f"  lowered ACTs    : {cc['acts_lowered_frac']:.1%}")
    return {"base": base, "chargecache": cc}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain engine (default: the card)")
    return chargecache_demo(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
