"""Batched serving on the PyTorch/CUDA port: prefill + decode with the
charge-aware continuous-batching scheduler, closing the loop to the DRAM
simulator (the port of ``serve_lm.py``).

Run:  PYTHONPATH=src python examples/serve_lm_torch.py --requests 12 --new 8 [--device cpu]

The model is reduced tinyllama-1.1b with random weights (``main``'s
``cfg`` / ``model`` take another, as ``chip_smoke.py`` passes the full-
width one); prefill runs the flash-attention kernel and each decode step
the decode-attention kernel on the card.  The scheduler's hot-page
probes run the HCRAC probe kernel; its page-access trace then runs
through ``simulate`` for base and ChargeCache (``sim_step``).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.core import MechanismConfig, SimConfig, simulate
from repro_torch.launch import steps as steps_lib
from repro_torch.models import zoo
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig


def main(argv=None, cfg=None, model=None) -> dict:
    """Decode a batch, then run the scheduler and the DRAM closed loop;
    returns the decoded tokens ``[new, batch]``, the tokens a second, the
    scheduler and the two simulations' stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")

    if cfg is None:
        cfg = get("tinyllama-1.1b").reduced()
    if model is None:
        model = zoo.init_model(cfg, seed=0, device=dev)
    serve = steps_lib.make_serve_step(cfg)

    # model side: decode a batch
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (args.batch, 16))).to(dev)
    _, cache = zoo.prefill_fn(model, {"tokens": prompts}, cfg,
                              max_len=16 + args.new + 4)
    tok = torch.zeros((args.batch,), dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    outs = []
    for _ in range(args.new):
        tok, cache = serve(model, cache, tok)
        outs.append(tok.cpu())
    dt = time.time() - t0
    outs = torch.stack(outs)
    tok_s = args.new * args.batch / dt
    print(f"decoded {args.new} tokens x batch {args.batch} "
          f"in {dt:.2f}s ({tok_s:.1f} tok/s)")

    # scheduler side: charge-aware batching + DRAM closed loop
    sched = Scheduler(SchedulerConfig(max_batch=args.batch,
                                      charge_aware=True), device=dev)
    for rid in range(args.requests):
        sched.submit(Request(rid=rid,
                             prompt_len=int(rng.integers(2048, 8192)),
                             max_new=args.new))
    sched.run(200)
    trace = sched.emit_trace()
    base = simulate(trace, SimConfig(mech=MechanismConfig(kind="base")),
                    device=dev)
    cc = simulate(trace, SimConfig(
        mech=MechanismConfig(kind="chargecache")), device=dev)
    print(f"scheduler: {sched.stats}")
    print(f"DRAM closed loop: hit={cc['hcrac_hit_rate']:.1%} "
          f"speedup={base['total_cycles'] / cc['total_cycles']:.4f}x")
    return {"tokens": outs, "seconds": dt, "tok_s": tok_s, "sched": sched,
            "base": base, "chargecache": cc}


if __name__ == "__main__":
    main()
