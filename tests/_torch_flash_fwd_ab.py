"""The flash kernel's bf16 forward against an earlier checkout's on one
card, in turns.

Builds the parent's ``flash_attention.cu`` on its own ``include/`` (the
``src/repro_torch/kernels`` directory of an earlier checkout, given on
the command line; the same ``extern "C"`` signatures of
``flash_attention_launch`` and ``flash_attention_lse_launch``) beside
the tree's library and runs
``kernel.flash_attention`` / ``kernel.flash_attention_lse`` on each (the
wrappers' ``library()`` swapped for the parent's).  At chip_smoke's
``FLASH_FULL`` shapes, ``FLASH_ZOO``'s bf16 shapes, a short prompt at
phi4-mini's widths (B 4 x S 16, hd 128) and the training forward at
tinyllama's B 4 x 2 048 and hd 256 B 2 x 2 048, it holds
both to the plain version (the output within ``BF16_RTOL`` /
``BF16_ATOL`` element by element; the training forward's LSE within
1e-3 and O + O_lo within ``FLASH_O32_TOL`` of the f32 output) and
counts the elements where the two differ (O; and the LSE and O_lo of
the training forward), then times a call (device: a CUDA graph of 20 calls, ``chip_smoke.graph_ms``)
in the order parent, tree, tree, parent.  At S 16 and S 64 it also
prints the time by CUDA events around back-to-back calls, with the host
(the tensor maps' encodes) in it.  Prints the card, the tree's ptxas
registers and spills and SASS census (HGMMA: wgmma; HMMA: mma.sync) of
the forward entries, each shape's times, the parent's over the tree's
(means of the two turns), the bound and SDPA's time; ``json=PATH``
writes them.  It also builds the parent's decode library
(``paged_attention.cu``) and prints both builds' ptxas numbers and HMMA
census of the decode entries and whether their SASS is the same,
function by function.

Run from the root of a checkout on a machine with the card, the parent
in a directory the copy carries (``build/`` is ignored by git):

    mkdir -p build/ab/parent && git archive <commit> \\
        src/repro_torch/kernels | tar -x -C build/ab/parent
    python tests/_torch_flash_fwd_ab.py \\
        parent=build/ab/parent/src/repro_torch/kernels [json=PATH]
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fr  # noqa: E402

#: the training forward's shapes (B, S, Skv, H, K, hd, causal, window):
#: tinyllama-1.1b's train step and recurrentgemma-2b's widths
TRAIN = [(4, 2048, 2048, 32, 4, 64, True, 0),
         (2, 2048, 2048, 10, 1, 256, True, 2048)]
#: a short prompt at hd 128 (phi4-mini's widths), whose 16 keys fill a
#: quarter of the kernel's one 128-key tile (B, S, Skv, H, K, hd, causal,
#: window)
SHORT = [(4, 16, 16, 24, 8, 128, True, 0)]
#: shapes whose time by CUDA events (the host included) is printed too
EVENTS_S = (16, 64)


def parent_build(name: str, parent_dir: Path, kernel: str) -> str:
    """The parent's ``<kernel>/csrc/*.cu`` built through ``_build.build``
    on the parent's ``include/``; the library's path."""
    saved = _build.INCLUDE_DIR
    _build.INCLUDE_DIR = parent_dir / "include"
    try:
        return str(_build.build(name, sorted(
            (parent_dir / kernel / "csrc").glob("*.cu"))))
    finally:
        _build.INCLUDE_DIR = saved


def on(lib, fn):
    """``fn`` run by the wrappers of ``kernel`` against ``lib``."""
    def run():
        saved = fk.library
        fk.library = lambda: lib
        try:
            return fn()
        finally:
            fk.library = saved
    return run


def forward_census() -> dict:
    """The tree's bf16 forward instantiations: their SASS census and
    ptxas warnings (``chip_smoke.flash_fwd_census``) and their ptxas
    numbers."""
    regs = {k: v for k, v in cs.flash_ptxas(fk).items()
            if k.startswith(fk.MMA_ENTRY)}
    return {**cs.flash_fwd_census(fk), "ptxas": regs}


def sass_functions(lib: str, name: str) -> dict:
    """``{function: its SASS text}`` of the library's functions whose
    name holds ``name`` (one ``cuobjdump -sass``), the names without the
    anonymous namespace's build-dependent tag."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = re.sub(r"_GLOBAL__N__\w+?_\d+_", "_GLOBAL__N__",
                        line.split("Function :", 1)[1].strip())
            fn = fn if name in fn else None
            if fn:
                out[fn] = []
        elif fn:
            out[fn].append(line)
    return {f: "\n".join(v) for f, v in out.items()}


def decode_builds(parent_dir: Path) -> dict:
    """The tree's decode library beside the parent's: each's ptxas
    numbers and HMMA census of the decode entries, and the functions
    whose SASS differs."""
    from repro_torch.kernels.paged_attention import kernel as pk
    parent = parent_build("paged_attention_parent", parent_dir,
                          "paged_attention")
    out = {}
    for name, lib in (("tree", pk.library()._name), ("parent", parent)):
        log = Path(lib).with_suffix(".log").read_text()
        out[name] = {
            "ptxas": cs.ptxas_report(
                log, r"(paged_attention_(?:mma_|combine_)?kernel"
                     r"(?:I\w+?E(?=E))?)"),
            "hmma": cs.sass_census(lib, (pk.MMA_ENTRY,), ("HMMA",)),
            "sass": sass_functions(lib, "paged_attention")}
    out["sass_differs"] = sorted(
        f for f in set(out["tree"]["sass"]) | set(out["parent"]["sass"])
        if out["tree"]["sass"].get(f) != out["parent"]["sass"].get(f))
    for name in ("tree", "parent"):
        del out[name]["sass"]
    return out


def check_serving(run, q, k, v, causal, window) -> float:
    """Worst share of the element-wise bf16 limit of ``run()`` against
    the plain version."""
    want = fr.flash_attention_ref(q, k, v, causal=causal, window=window)
    return cs.kernel_diff(run(), want, "bf16")[2]


def check_train(run, q, k, v, causal, window) -> dict:
    """The training forward against the plain version: the output's
    worst share of the bf16 limit, LSE's max |d|, and O + O_lo's max
    |d| / max |O| against the f32 output."""
    o, lse, o_lo = run()
    S = q.shape[1]
    want = fr.flash_attention_ref(q.float(), k.float(), v.float(),
                                  causal=causal, window=window)
    lse_want = fr.flash_attention_lse_ref(q, k, v, causal=causal,
                                          window=window)
    return {"share": cs.kernel_diff(o, want, "bf16")[2],
            "lse_err": float((lse[..., :S] - lse_want).abs().max()),
            "o32_err": float((o.float() + o_lo.float() - want).abs().max()
                             / want.abs().max())}


def main(argv) -> int:
    args = dict(a.split("=", 1) for a in argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    parent_dir = Path(args["parent"])
    parent = fk.bind(ctypes.CDLL(parent_build(
        "flash_attention_parent", parent_dir, "flash_attention")))
    tree = fk.library()
    census = forward_census()
    for name, c in sorted(census["sass"].items()):
        print(f"  SASS {fk.MMA_ENTRY} {name}: {c}", flush=True)
    for name, r in sorted(census["ptxas"].items()):
        print(f"  ptxas {name}: {r['registers']} registers, spill stores "
              f"{r['spill_stores']} B, loads {r['spill_loads']} B",
              flush=True)
    for w in census["warnings"]:
        print(f"  ptxas: {w}", flush=True)
    decode = decode_builds(parent_dir)
    for name in ("tree", "parent"):
        for entry, r in sorted(decode[name]["ptxas"].items()):
            print(f"  decode {name} ptxas {entry}: {r['registers']} "
                  f"registers, spill stores {r['spill_stores']} B, "
                  f"loads {r['spill_loads']} B", flush=True)
        print(f"  decode {name} HMMA: " + ", ".join(
            f"{f.split('ILi')[1].split('E')[0]}: {c['HMMA']}"
            for f, c in sorted(decode[name]["hmma"].items())),
            flush=True)
    print(f"  decode functions whose SASS differs from the parent's: "
          f"{decode['sass_differs'] or 'none'}", flush=True)
    dev = torch.device("cuda")
    cases = ([("serve", (B, S, S, H, K, hd, c, w))
              for B, S, H, K, hd, c, w in cs.FLASH_FULL]
             + [("serve", z) for z in cs.FLASH_ZOO]
             + [("train", t) for t in TRAIN]
             + [("serve", z) for z in SHORT])
    rows = []
    for i, (kind, (B, S, Skv, H, K, hd, causal, window)) in enumerate(cases):
        q, k, v = (cs.seeded(sh, 3100 + 10 * i + j, torch.bfloat16, dev)
                   for j, sh in enumerate(((B, S, H, hd), (B, Skv, K, hd),
                                           (B, Skv, K, hd))))
        if kind == "serve":
            call = lambda: fk.flash_attention(q, k, v, causal=causal,
                                              window=window)
            check = check_serving
        else:
            call = lambda: fk.flash_attention_lse(q, k, v, causal=causal,
                                                  window=window)
            check = check_train
        versions = {"parent": on(parent, call), "tree": on(tree, call)}
        checks = {n: check(fn, q, k, v, causal, window)
                  for n, fn in versions.items()}
        outs = {n: fn() for n, fn in versions.items()}
        outs = {n: (o,) if kind == "serve" else (o[0], o[1][..., :S], o[2])
                for n, o in outs.items()}
        differ = [int((a != b).sum())
                  for a, b in zip(outs["parent"], outs["tree"])]
        del outs
        if kind == "serve":
            same = bool(torch.equal(versions["tree"](), on(
                tree, lambda: fk.flash_attention_lse(
                    q, k, v, causal=causal, window=window))()[0]))
        times = {"parent": [], "tree": []}
        for name in ("parent", "tree", "tree", "parent"):
            times[name].append(cs.graph_ms(versions[name]))
        mean = {n: sum(t) / len(t) for n, t in times.items()}
        events = ({n: cs.loop_ms(fn) for n, fn in versions.items()}
                  if S in EVENTS_S else None)
        mask, is_causal = cs.sdpa_mask(S, Skv, causal, window, dev)
        sdpa_ms = cs.graph_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=is_causal, enable_gqa=True))
        bound, by = cs.flash_bound(B, S, H, K, hd, causal, window, "bf16",
                                   Skv)
        row = {"kind": kind, "shape": [B, S, Skv, H, K, hd, causal, window],
               "times_ms": times, "checks": checks,
               "elements_differing": differ,
               "parent_over_tree": mean["parent"] / mean["tree"],
               "events_ms": events, "sdpa_ms": sdpa_ms, "bound_ms": bound,
               "bound_by": by, "tree_bound_share": bound / mean["tree"]}
        if kind == "serve":
            row["serving_equals_lse_o"] = same
        rows.append(row)
        ev = ("" if events is None else
              f"; events parent {events['parent']:.4f}, tree "
              f"{events['tree']:.4f}")
        print(f"{kind} B{B} S{S} Skv{Skv} H{H} K{K} hd{hd} causal={causal} "
              f"window={window}: device ms parent {times['parent'][0]:.4f} /"
              f" {times['parent'][1]:.4f}, tree {times['tree'][0]:.4f} / "
              f"{times['tree'][1]:.4f}; parent / tree "
              f"{row['parent_over_tree']:.2f}x; tree at "
              f"{100 * row['tree_bound_share']:.1f} % of its {by} bound "
              f"{bound:.4f}; SDPA {sdpa_ms:.4f}{ev}; elements differing "
              f"from the parent's (O{'' if kind == 'serve' else ', LSE, O_lo'}"
              f") {differ}; checks {checks}"
              + (f"; O equals the LSE entry's {same}"
                 if kind == "serve" else ""), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    if "json" in args:
        Path(args["json"]).parent.mkdir(parents=True, exist_ok=True)
        Path(args["json"]).write_text(json.dumps(
            {"card": card, "census": census, "decode": decode,
             "rows": rows}, indent=1))
    bad = [r["shape"] for r in rows if not tree_ok(r)]
    if bad:
        print(f"the tree disagrees with the plain version at {bad}",
              file=sys.stderr)
    return 1 if bad else 0


def tree_ok(row: dict) -> bool:
    """Whether the tree's forward met the limits at ``row``'s shape."""
    c = row["checks"]["tree"]
    if row["kind"] == "serve":
        return c <= 1.0 and row["serving_equals_lse_o"]
    return (c["share"] <= 1.0 and c["lse_err"] <= 1e-3
            and c["o32_err"] <= cs.FLASH_O32_TOL)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
