"""Quickstart on the PyTorch/CUDA port, the port of ``quickstart.py``:

1. The paper: simulate a DDR3 system with and without ChargeCache.
2. The framework: one training step of the reduced tinyllama.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import torch

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


def train_step_demo(device=None, model=None, batch=None) -> dict:
    """One train step (two microbatches, AdamW) of the reduced tinyllama
    on ``device`` (the card unless ``cpu``); returns its metrics as
    floats.  ``model`` / ``batch``: weights and inputs to use in place of
    the port's own random ones (``zoo.init_model`` / ``zoo.make_batch``,
    other draws than ``repro``'s)."""
    print("== One train step of reduced tinyllama ==")
    from repro_torch.configs import get
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw

    cfg = get("tinyllama-1.1b").reduced()
    if model is None:
        model = zoo.init_model(cfg, seed=0, device=device)
    if batch is None:
        batch = zoo.make_batch(cfg, ShapeConfig("demo", 64, 4, "train"),
                               device=device)
    opt = adamw.init(model.tree())
    step = steps.make_train_step(cfg, adamw.AdamWConfig(), microbatches=2)
    opt, out = step(model, opt, batch)
    out = {k: float(v) for k, v in out.items()}
    print(f"  loss={out['loss']:.3f} grad_norm={out['grad_norm']:.3f}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain engine and kernels (default: "
                         "the card)")
    device = ap.parse_args(argv).device
    cells = chargecache_demo(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"chargecache": cells, "train": train_step_demo(device)}


if __name__ == "__main__":
    main()
