"""Fault-tolerance drill on the PyTorch/CUDA port (the port of
``fault_tolerance.py``): train with heartbeat monitoring on a simulated
cluster; host 3 dies at step 25 -> detect, shrink the mesh, restore the
latest checkpoint, resume; a straggler at step 12 is re-dispatched.

Run:  PYTHONPATH=src python examples/fault_tolerance_torch.py [--device cpu]
      PYTHONPATH=src python examples/fault_tolerance_torch.py \\
          --full-width --layers 2 --seq 256 --batch 8

The default model is ``repro``'s reduced tinyllama at B 8 x 32;
``--full-width`` takes tinyllama-1.1b's published widths (``--layers``
cuts the depth).  It prints the lines ``repro``'s example prints;
``main(argv)`` returns them with the report, the model, the optimizer
state, the losses (in the order the steps ran) and the step, save and
restore times; ``straight(argv)`` trains the same model on the same
batches without the cluster, the run the drill must end equal to, and
``state_leaves(run)`` lists the leaves the two are compared on.
Checkpoints go to ``--ckpt-dir`` (default: a temporary directory,
removed at the end).
"""

import argparse
import dataclasses
import shutil
import tempfile
import time

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get
from repro_torch.data.pipeline import DataConfig, host_batch_at
from repro_torch.launch import steps as steps_lib
from repro_torch.models import zoo
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as ft


def model_config(full_width: bool, layers: int | None):
    cfg = get("tinyllama-1.1b")
    if not full_width:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-width", action="store_true",
                    help="tinyllama-1.1b's published widths (default: "
                         "repro's reduced tinyllama)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain kernels (default: the card)")
    return ap.parse_args(argv)


def setup(args):
    """The model (seed 0), its AdamW state, the data and the step."""
    cfg = model_config(args.full_width, args.layers)
    model = zoo.init_model(cfg, seed=0, device=args.device)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    step_fn = steps_lib.make_train_step(
        cfg, adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=5,
                               decay_steps=100))
    return model, adamw.init(model.tree()), data, step_fn


def train_step(model, opt, data, step_fn, step: int):
    """One step on ``data``'s batch ``step`` -> ``(opt, loss)``."""
    batch = {k: torch.from_numpy(v).to(model.embed.device, torch.int64)
             for k, v in host_batch_at(data, step).items()}
    opt, out = step_fn(model, opt, batch)
    return opt, float(out["loss"])


def straight(argv=None) -> dict:
    """The same training without the cluster: 40 steps in a row, no
    checkpoint.  Returns the model, the optimizer state and the
    losses."""
    args = parse(argv)
    model, opt, data, step_fn = setup(args)
    losses = []
    for step in range(40):
        opt, loss = train_step(model, opt, data, step_fn, step)
        losses.append((step, loss))
    return {"model": model, "opt": opt, "losses": losses}


def state_leaves(run: dict) -> list:
    """A run's parameters, then AdamW's step, moments and master copy:
    the leaves two runs are compared on."""
    opt = run["opt"]
    return (adamw.leaves(run["model"].tree()) + [opt.step]
            + [x for t in (opt.m, opt.v, opt.master)
               for x in adamw.leaves(t)])


def main(argv=None) -> dict:
    args = parse(argv)
    model, opt, data, step_fn = setup(args)
    dev = model.embed.device
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="ft_ckpt_")

    cluster = ft.SimulatedCluster(8)
    state = {"opt": opt}
    lines, losses = [], []
    times = {"step_s": [], "save_s": [], "restore_s": []}

    def say(line):
        print(line, flush=True)
        lines.append(line)

    def tree():
        return {"params": model.tree(), "opt": state["opt"]}

    def do_step(step, n_hosts):
        if step == 25:
            cluster.fail(3)
            say(f"  [injected] host 3 fails at step {step}")
        if step == 12:
            cluster.make_straggler(5)
            say(f"  [injected] host 5 becomes a straggler at step {step}")
        t0 = time.perf_counter()
        state["opt"], loss = train_step(model, state["opt"], data, step_fn,
                                        step)
        losses.append((step, loss))
        times["step_s"].append(time.perf_counter() - t0)
        return 1.0

    def save_ckpt(step):
        t0 = time.perf_counter()
        ckpt.save(ckpt_dir, step, tree(), extra={"data_step": step})
        times["save_s"].append(time.perf_counter() - t0)
        say(f"  checkpoint @ step {step}")

    def restore_ckpt():
        t0 = time.perf_counter()
        restored, step, extra = ckpt.restore(ckpt_dir, tree())
        with torch.no_grad():
            for dst, src in zip(adamw.leaves(model.tree()),
                                adamw.leaves(restored["params"])):
                dst.copy_(src)
        state["opt"] = restored["opt"]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times["restore_s"].append(time.perf_counter() - t0)
        say(f"  restored from step {step}")
        return extra["data_step"]

    def remesh(n_alive):
        shape = ft.elastic_mesh_shape(n_alive * 64, 16)
        say(f"  remesh: {n_alive} hosts alive -> data x model = {shape}")

    try:
        rep = ft.fault_tolerant_run(40, cluster, ft.FTConfig(),
                                    do_step, save_ckpt, restore_ckpt,
                                    remesh, ckpt_every=10)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    say(f"\nreport: steps={rep.steps_done} failures={rep.failures} "
        f"redispatches={rep.redispatches} remeshes={rep.remeshes} "
        f"restored_from={rep.restored_from}")
    return {"report": rep, "model": model, "opt": state["opt"],
            "lines": lines, "losses": losses, "ckpt_dir": ckpt_dir, **times}


if __name__ == "__main__":
    main()
