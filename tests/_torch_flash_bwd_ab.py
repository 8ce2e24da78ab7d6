"""The flash kernel's backward against an earlier source of
``flash_attention.cu`` on one card, in turns.

Builds the parent source given on the command line (its backward entries
with the ``mma.sync`` signatures: ``flash_bwd_dkdv_launch`` /
``flash_bwd_dq_launch`` without partials) beside the tree's
library and, at chip_smoke's ``FLASH_BWD`` shapes, times the whole
backward of each (D + dK/dV (+ the group sum) + dQ, a CUDA graph of 20
calls, ``chip_smoke.graph_ms``) in the order parent, tree, tree, parent,
after holding both to the plain version within ``FLASH_BWD_RTOL`` /
``ATOL``.  Prints the card, each shape's four times and the parent's
over the tree's (means of the two turns); ``json=PATH`` writes them.

Run from the root of a checkout on a machine with the card, the parent
source in a directory the copy carries (``build/`` is ignored by git):

    git show <commit>:src/repro_torch/kernels/flash_attention/csrc/\\
flash_attention.cu > build/ab/flash_parent.cu
    python tests/_torch_flash_bwd_ab.py parent=build/ab/flash_parent.cu \\
        [json=PATH]
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fr  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def parent_library(src: Path) -> ctypes.CDLL:
    """The parent source built through ``_build.build`` and bound with its
    backward entries' signatures."""
    lib = ctypes.CDLL(str(_build.build("flash_attention_parent", [src])))
    lib.flash_bwd_dot_launch.restype = _I
    lib.flash_bwd_dot_launch.argtypes = (
        [_I] * 4 + [_P, _L, _L, _L] * 3 + [_P, _L, _P])
    for name, outs in (("flash_bwd_dkdv_launch", 2),
                       ("flash_bwd_dq_launch", 1)):
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = ([_I] * 6 + [_P, _L, _L, _L] * 4 + [_P, _P, _L]
                       + [_P, _L, _L, _L] * outs
                       + [_I, _I, ctypes.c_float, _P])
    return lib


def parent_bwd(lib, q, k, v, o, o_lo, do, lse, causal, window):
    """The parent's D, dK / dV and dQ entries: ``(dq, dk, dv)``."""
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    dev, rows = q.device, lse.shape[-1]
    dlt = torch.empty((B, H, rows), dtype=torch.float32, device=dev)
    err = _build.launch(lib.flash_bwd_dot_launch, dev, B, S, H, hd,
                        o.data_ptr(), *o.stride()[:3], o_lo.data_ptr(),
                        *o_lo.stride()[:3], do.data_ptr(), *do.stride()[:3],
                        dlt.data_ptr(), rows)
    ins = (q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
           v.data_ptr(), *v.stride()[:3], do.data_ptr(), *do.stride()[:3],
           lse.data_ptr(), dlt.data_ptr(), rows)
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    mask = (int(causal), int(window), 1.0 / math.sqrt(hd))
    err |= _build.launch(lib.flash_bwd_dkdv_launch, dev, B, S, Skv, H, K,
                         hd, *ins, dk.data_ptr(), *dk.stride()[:3],
                         dv.data_ptr(), *dv.stride()[:3], *mask)
    err |= _build.launch(lib.flash_bwd_dq_launch, dev, B, S, Skv, H, K, hd,
                         *ins, dq.data_ptr(), *dq.stride()[:3], *mask)
    if err:
        raise RuntimeError(f"the parent's backward failed to launch ({err})")
    return dq, dk, dv


def main(argv) -> int:
    args = dict(a.split("=", 1) for a in argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    parent = parent_library(Path(args["parent"]))
    fk.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    rows = []
    for i, (B, S, Skv, H, K, hd, causal, window) in enumerate(cs.FLASH_BWD):
        gen.manual_seed(2600 + i)
        draw = lambda *shape: torch.randn(shape, generator=gen, device=dev
                                          ).to(torch.bfloat16)
        q, k, v, do = (draw(B, S, H, hd), draw(B, Skv, K, hd),
                       draw(B, Skv, K, hd), draw(B, S, H, hd))
        o, lse, o_lo = fk.flash_attention_lse(q, k, v, causal=causal,
                                              window=window)
        versions = {
            "parent": lambda: parent_bwd(parent, q, k, v, o, o_lo, do, lse,
                                         causal, window),
            "tree": lambda: cs.flash_bwd(fk, q, k, v, o, o_lo, do, lse,
                                         causal, window)}
        want = fr.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                          window=window)
        shares = {n: max(cs.bwd_diff(g, w)[2] for g, w in zip(fn(), want))
                  for n, fn in versions.items()}
        del want
        times = {"parent": [], "tree": []}
        for name in ("parent", "tree", "tree", "parent"):
            times[name].append(cs.graph_ms(versions[name]))
        mean = {n: sum(t) / len(t) for n, t in times.items()}
        row = {"shape": [B, S, Skv, H, K, hd, causal, window],
               "times_ms": times, "worst_share": shares,
               "parent_over_tree": mean["parent"] / mean["tree"]}
        rows.append(row)
        print(f"B{B} S{S} Skv{Skv} H{H} K{K} hd{hd} causal={causal} "
              f"window={window}: device ms parent "
              f"{times['parent'][0]:.4f} / {times['parent'][1]:.4f}, tree "
              f"{times['tree'][0]:.4f} / {times['tree'][1]:.4f}; parent / "
              f"tree {row['parent_over_tree']:.2f}x; worst share of the "
              f"limit parent {shares['parent']:.3f}, tree "
              f"{shares['tree']:.3f}", flush=True)
        del q, k, v, do, o, lse, o_lo
        torch.cuda.empty_cache()
    if "json" in args:
        Path(args["json"]).parent.mkdir(parents=True, exist_ok=True)
        Path(args["json"]).write_text(json.dumps(
            {"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
