"""How closely the flash kernel's backward entries follow their plain
emulation ``ref.flash_attention_bwd_tiled`` on the card.

For each case (B, S, Skv, H, K, hd, causal, window, key offset; inputs
numpy-seeded normals in bf16, the keys shifted along one unit direction
by the offset, as whisper-small's decoder keys are), the entries' dQ, dK
and dV (``chip_smoke.flash_bwd``) against the emulation run on the CPU
from the same inputs: the largest |d| over the largest |emulation|, the
share of elements that differ at all, and the worst element's share of
the limit ``rtol |emulation| + atol max |emulation|`` at a few (rtol,
atol) pairs, ``tests/test_torch_train_cuda.py``'s ``EMUL_RTOL`` /
``EMUL_ATOL`` among them, and at chip_smoke's ``FLASH_BWD_RTOL`` /
``ATOL``.

Run from the root of a checkout on a machine with the card:

    python tests/_torch_flash_bwd_emul.py [json=PATH]
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fr  # noqa: E402

#: (B, S, Skv, H, K, hd, causal, window, key offset)
CASES = [(2, 128, 128, 4, 2, 64, True, 0, 0.0),
         (1, 200, 200, 6, 2, 128, True, 0, 0.0),
         (2, 96, 96, 4, 4, 32, True, 40, 0.0),
         (1, 100, 300, 4, 4, 64, False, 0, 0.0),
         (3, 70, 70, 8, 1, 40, False, 0, 0.0),
         (2, 128, 128, 16, 2, 64, True, 0, 0.0),
         (1, 128, 128, 6, 2, 128, False, 0, 0.0),
         (1, 128, 128, 4, 4, 64, True, 0, 128.0)]
#: (rtol, atol) pairs the worst element is measured against, in log2
LIMITS = [(-8, -12), (-7, -12), (-7, -10), (-7, -8)]


def inputs(case, seed):
    B, S, Skv, H, K, hd, _, _, offset = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd))
    k = rng.normal(size=(B, Skv, K, hd))
    if offset:
        u = rng.normal(size=hd)
        k = k + offset * u / np.linalg.norm(u)
    v = rng.normal(size=(B, Skv, K, hd))
    do = rng.normal(size=(B, S, H, hd))
    return [torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
            for x in (q, k, v, do)]


def compare(got, want) -> dict:
    g, w = got.cpu().float(), want.float()
    d, wa = (g - w).abs(), w.abs()
    top = float(wa.max())
    out = {"rel_max": float(d.max()) / top,
           "share_unequal": float((d > 0).float().mean())}
    for r, a in LIMITS:
        lim = 2.0 ** r * wa + 2.0 ** a * top
        out[f"share_2^{r}_2^{a}"] = float((d / lim).max())
    return out


def main(argv) -> int:
    args = dict(a.split("=", 1) for a in argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rows = []
    for i, case in enumerate(CASES):
        causal, window = case[6], case[7]
        t = inputs(case, 100 + i)
        q, k, v, do = (x.cuda() for x in t)
        o, lse, o_lo = fk.flash_attention_lse(q, k, v, causal=causal,
                                              window=window)
        got = cs.flash_bwd(fk, q, k, v, o, o_lo, do, lse, causal, window)
        want = fr.flash_attention_bwd_tiled(*t, causal=causal, window=window)
        row = {"case": list(case)}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            row[name] = compare(g, w)
        rows.append(row)
        print(f"{case}: " + "; ".join(
            f"{n} " + ", ".join(f"{key} {val:.3g}"
                                for key, val in row[n].items())
            for n in ("dq", "dk", "dv")), flush=True)
    for key in rows[0]["dq"]:
        worst = max(r[n][key] for r in rows for n in ("dq", "dk", "dv"))
        print(f"worst {key}: {worst:.4g}", flush=True)
    if "json" in args:
        Path(args["json"]).parent.mkdir(parents=True, exist_ok=True)
        Path(args["json"]).write_text(json.dumps(
            {"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
