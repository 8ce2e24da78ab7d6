"""End-to-end training on the PyTorch/CUDA port (the port of
``train_lm.py``): data pipeline -> train step (two microbatches, AdamW)
-> async checkpoints -> resume.  The default preset is CPU-sized;
``--preset 100m`` is the ~100M-parameter run for the card (the code path
is identical, only the dims change).

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 40 [--device cpu]
      PYTHONPATH=src python examples/train_lm_torch.py --resume ...

Checkpoints go to ``--ckpt-dir`` (default ``build/train_ckpt`` in the
checkout).  ``main(argv)`` returns the losses it printed and the model.
"""

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get
from repro_torch.data.pipeline import DataConfig, host_batch_at
from repro_torch.launch import steps as steps_lib
from repro_torch.models import zoo
from repro_torch.optim import adamw

PRESETS = {
    # ~15M params: tractable on one CPU core
    "15m": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                head_dim=32, d_ff=1024, vocab_size=8192, seq=256, batch=8),
    # ~100M params
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab_size=32000, seq=512,
                 batch=16),
}
DEFAULT_CKPT = Path(__file__).resolve().parents[1] / "build" / "train_ckpt"


def preset_config(name: str):
    p = PRESETS[name]
    return dataclasses.replace(
        get("tinyllama-1.1b"), name=f"train-{name}",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="15m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain kernels (default: the card)")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    cfg = preset_config(args.preset)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"model: {cfg.name}  params~{cfg.n_params()/1e6:.0f}M")

    model = zoo.init_model(cfg, seed=0, device=args.device)
    dev = model.embed.device
    opt = adamw.init(model.tree())
    opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=10,
                                decay_steps=max(args.steps, 100))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=p["seq"],
                      global_batch=p["batch"], seed=0)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, microbatches=2)
    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        restored, _, extra = ckpt.restore(
            args.ckpt_dir, {"params": model.tree(), "opt": opt})
        with torch.no_grad():
            for dst, src in zip(adamw.leaves(model.tree()),
                                adamw.leaves(restored["params"])):
                dst.copy_(src)
        opt = restored["opt"]
        start = extra["data_step"]
        print(f"resumed from step {start}")

    saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
    losses = {}
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev, torch.int64)
                 for k, v in host_batch_at(data, step).items()}
        opt, out = step_fn(model, opt, batch)
        losses[step] = float(out["loss"])
        if step % 5 == 0 or step == args.steps - 1:
            dt = (time.time() - t0) / max(step - start + 1, 1)
            toks = p["seq"] * p["batch"] / dt
            print(f"step {step:4d}  loss={losses[step]:.4f}  "
                  f"lr={float(out['lr']):.2e}  "
                  f"gnorm={float(out['grad_norm']):.2f}  {toks:,.0f} tok/s")
        if (step + 1) % args.ckpt_every == 0:
            saver.save_async(step + 1, {"params": model.tree(), "opt": opt},
                             extra={"data_step": step + 1})
    saver.wait()
    print("done.")
    return {"losses": losses, "model": model, "opt": opt, "start": start}


if __name__ == "__main__":
    main()
