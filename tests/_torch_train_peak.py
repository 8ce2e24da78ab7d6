"""Peak device memory of phi3.5-moe's train step on one card, at 1 and 2
layers.

For each cut: the parameters' count, the bytes a parameter holds in each
part of the step (bf16 weight and gradient, AdamW's f32 master, m and v,
and the new master, m, v and bf16 weight that the pure ``adamw.update``
builds beside the old ones), and the kernels' train step of chip_smoke
phase 24 (g) (``golden.TRAIN_ZOO``'s batch, tokens and weights) run once:
``torch.cuda.max_memory_allocated`` after it, or at the out-of-memory
error that stops it.  Prints one JSON object; ``json=PATH`` writes it too.

Run from the root of a checkout on a machine with the card:

    python tests/_torch_train_peak.py [json=PATH]
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import golden  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

NAME = "phi3.5-moe-42b-a6.6b"
#: bytes a parameter holds: before the update (bf16 weight and gradient,
#: f32 master, m, v) and what the update adds beside them (f32 master, m,
#: v and the bf16 weight rounded from the new master)
BEFORE, UPDATE = 2 + 2 + 3 * 4, 3 * 4 + 2


def main() -> None:
    args = dict(a.split("=", 1) for a in sys.argv[1:])
    dev = torch.device("cuda")
    spec = golden.TRAIN_ZOO[NAME]
    total = torch.cuda.mem_get_info(dev)[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"device": smi,
           "device_total_gib": total / 2 ** 30, "bytes_before": BEFORE,
           "bytes_update": UPDATE, "cuts": []}
    for layers in (1, 2):
        cfg = golden.zoo_config(get(spec["config"]),
                                {**spec, "cut_layers": layers})
        n = count_params(lm.lm_defs(cfg))
        row = {"layers": layers, "params": n,
               "before_gib": n * BEFORE / 2 ** 30,
               "peak_state_gib": n * (BEFORE + UPDATE) / 2 ** 30}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            model, _ = cs.golden_train_model(golden, lm, cfg, spec["seed"],
                                             dev)
            batch = golden.train_tokens(cfg.vocab_size, dev, spec)
            step = steps.make_train_step(cfg, adamw.AdamWConfig())
            opt, res = step(model, adamw.init(model.tree()), batch)
            torch.cuda.synchronize()
            row["ok"], row["loss"] = True, float(res["loss"])
            del opt, res
        except torch.cuda.OutOfMemoryError as e:
            row["ok"], row["error"] = False, str(e).splitlines()[0][:300]
        row["max_allocated_gib"] = (torch.cuda.max_memory_allocated(dev)
                                    / 2 ** 30)
        model = batch = step = None
        torch.cuda.empty_cache()
        out["cuts"].append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    if "json" in args:
        Path(args["json"]).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
