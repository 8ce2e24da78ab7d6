"""Times recurrentgemma-2b's RG-LRU path built from two ``rglru_scan.cu``
sources in one run on the card, in turns: the parent's path (the gates
as eager PyTorch ops, ``kernels/rglru_scan/ref.py::gate_inputs`` — two
bf16 sigmoids, ``exp(nsp * r)``, ``i * u``, the ops the block ran before
the kernel took them in — then the parent's kernel on f32 ``a`` and
``x``) against this tree's fused kernel on the bf16 gate inputs
``r_pre``, ``i_pre``, ``u``.

Each source is built through the port's own ``repro_torch._build.build``
(same flags, content-keyed under ``build/kernels/``), and the tree's once
more with ``-DRGLRU_NO_GATES`` (the ``skeleton``: the same pipeline with
the gate math replaced by a copy; its ``h`` is wrong and is not
compared); ptxas's registers and spills and a census of the kernel's
SASS (instructions, MUFU, branches, calls) are printed.  Then:

* the kernel path at ``chip_smoke.SCAN_RG``'s shapes (B 2 / B 4 x 2 048
  x 2 560 and a B 4 decode step), inputs drawn as in chip_smoke phase 19
  (``chip_smoke.rglru_case``, saturating channels included) and phase
  19's sweep of every bf16 gate input, every arm's ``h_seq`` and ``h_S``
  required equal to the parent's; each arm timed in the order parent,
  tree, skeleton, then back, each time a CUDA-event median of 3 (events
  around 20 calls, over 20, after a warm-up); beside them, as a measure
  of what the card's memory gives such traffic, PyTorch's ``add`` of two
  bf16 tensors into an f32 one of the same shape (reads 4, writes 4
  bytes an element; the kernel reads 6 and writes 4);
* recurrentgemma-2b at full depth (26 layers, random golden weights)
  with the model's ``ops.rglru_scan`` pointed at the parent's path and
  at the tree's kernel: prefill B 4 x
  2 048 and one decode step after it, in the same turns (CUDA-event
  medians of 3), the logits required equal, and the kernels a decode
  step launches (``torch.profiler``, copies left out).

Run from the root of a checkout on a machine with the card (the parent
source in a directory the checkout's ``.gitignore`` lists):

    mkdir -p build/ab
    git show HEAD~1:src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu \\
        > build/ab/rglru_scan_parent.cu
    python tests/_torch_rglru_ab.py parent=build/ab/rglru_scan_parent.cu \\
        [tree=src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu] \\
        [json=PATH]
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch import golden as golden_mod  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as ro  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as rr  # noqa: E402
from repro_torch.models import lm, zoo  # noqa: E402

TREE = ROOT / "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int


#: SASS mnemonics the census counts
CENSUS = (("MUFU", r"\bMUFU\."), ("branches", r"\bBRA\b"),
          ("calls", r"\bCALL\."), ("shared loads", r"\bLDS"))


def sass_census(lib: Path) -> dict:
    """Instructions of ``rglru_scan_kernel`` in a built library and the
    ``CENSUS`` counts among them (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.find_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, inside = {"instructions": 0, **{k: 0 for k, _ in CENSUS}}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "rglru_scan_kernel" in line
        elif inside and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            out["instructions"] += 1
            for key, pat in CENSUS:
                out[key] += bool(re.search(pat, line))
    return out


def build(name: str, src: Path) -> tuple[ctypes.CDLL, dict]:
    """Build ``src`` as library ``ab_<name>``; its handle and ptxas's
    report of ``rglru_scan_kernel`` with the SASS census."""
    lib = _build.build(f"ab_{name}", [src])
    regs = cs.ptxas_report(lib.with_suffix(".log").read_text(),
                           r"(rglru_scan_kernel)").get("rglru_scan_kernel",
                                                       {})
    regs.update(sass_census(lib))
    print(f"  {name}: {regs}", flush=True)
    return ctypes.CDLL(str(lib)), regs


def launch(lib, dev, *args) -> None:
    err = _build.launch(lib.rglru_scan_launch, dev, *args)
    if err:
        raise RuntimeError(f"rglru_scan launch failed: error {err}")


def parent_path(lib):
    """The parent's path as an ``ops.rglru_scan``: eager gates, then the
    parent's kernel on f32 ``a``, ``x``."""
    lib.rglru_scan_launch.restype = _I
    lib.rglru_scan_launch.argtypes = [_I] * 3 + [_P] * 6

    def run(r_pre, i_pre, u, nsp, h0):
        a, x = rr.gate_inputs(r_pre, i_pre, u, nsp)
        a, x = a.contiguous(), x.contiguous()
        B, S, d = a.shape
        hs = torch.empty_like(a)
        hn = torch.empty_like(h0)
        launch(lib, a.device, B, S, d, a.data_ptr(), x.data_ptr(),
               h0.data_ptr(), hs.data_ptr(), hn.data_ptr())
        return hs, hn
    return run


def fused_path(lib):
    """A tree build's fused kernel as an ``ops.rglru_scan``."""
    lib.rglru_scan_launch.restype = _I
    lib.rglru_scan_launch.argtypes = [_I] * 3 + [_P] * 8

    def run(r_pre, i_pre, u, nsp, h0):
        B, S, d = r_pre.shape
        hs = torch.empty((B, S, d), dtype=torch.float32, device=u.device)
        hn = torch.empty_like(h0)
        launch(lib, u.device, B, S, d, r_pre.data_ptr(), i_pre.data_ptr(),
               u.data_ptr(), nsp.data_ptr(), h0.data_ptr(), hs.data_ptr(),
               hn.data_ptr())
        return hs, hn
    return run


def events_median(fn, calls: int = 20, reps: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``calls`` back-to-back
    calls, over ``calls`` (ms), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


def in_turns(arms: dict, timer) -> dict:
    """``{arm: [ms, ms]}``: each arm timed twice, in the order of
    ``arms`` and then back."""
    order = list(arms) + list(arms)[::-1]
    got = {name: [] for name in arms}
    for name in order:
        got[name].append(timer(arms[name]))
    return got


def model_ab(arms: dict, dev) -> dict:
    """recurrentgemma-2b (full depth) prefill B 4 x 2 048 and one decode
    step with ``ops.rglru_scan`` pointed at each arm, in turns."""
    cfg = get("recurrentgemma-2b")
    model = lm.LM(cfg, golden_mod.golden_weights(zoo.model_defs(cfg), 23,
                                                 dev))
    g = torch.Generator(device=dev)
    g.manual_seed(20)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                           device=dev)
    batch, max_len = {"tokens": tokens}, 2049
    saved = ro.rglru_scan
    clone = lambda c: {k: (v.clone() if torch.is_tensor(v) else clone(v))
                       for k, v in c.items()}
    res, logits = {}, {}
    try:
        caches = {}
        for name, fn in arms.items():
            ro.rglru_scan = fn
            lg, caches[name] = zoo.prefill_fn(model, batch, cfg, max_len)
            tok = torch.argmax(lg, -1)
            step, _ = zoo.decode_fn(model, clone(caches[name]), tok, cfg)
            logits[name] = (lg, step)
        first = next(iter(arms))
        for name in arms:
            ok = all(torch.equal(a, b) for a, b in zip(logits[name],
                                                       logits[first]))
            print(f"  model: {name} logits equal to {first}'s: {ok}",
                  flush=True)
            if not ok:
                raise SystemExit(f"{name}'s logits differ from {first}'s")
        tok = torch.argmax(logits[first][0], -1)

        def prefill_timer(fn):
            ro.rglru_scan = fn
            return events_median(lambda: zoo.prefill_fn(model, batch, cfg,
                                                         max_len), calls=1)

        def step_timer(fn):
            ro.rglru_scan = fn
            cache = caches[first]
            copies = [clone(cache) for _ in range(4)]
            it = iter(copies)
            return events_median(lambda: zoo.decode_fn(model, next(it), tok,
                                                       cfg), calls=1)
        res["prefill_ms"] = in_turns(arms, prefill_timer)
        res["decode_step_ms"] = in_turns(arms, step_timer)
        res["decode_kernels"] = {}
        for name, fn in arms.items():
            ro.rglru_scan = fn
            cache = clone(caches[first])
            *_, k = cs.profile_kernels(
                lambda: zoo.decode_fn(model, cache, tok, cfg), ())
            res["decode_kernels"][name] = k["n_kernels"]
        for key in ("prefill_ms", "decode_step_ms"):
            for name, ms in res[key].items():
                print(f"  model {key} {name}: {ms[0]:.3f} / {ms[1]:.3f}",
                      flush=True)
        print(f"  model decode-step kernel launches: "
              f"{res['decode_kernels']}", flush=True)
    finally:
        ro.rglru_scan = saved
    return res


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    opts = dict(a.split("=", 1) for a in argv if "=" in a)
    if "parent" not in opts:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    tree = Path(opts.get("tree", TREE))
    libs, regs = {}, {}
    libs["parent"], regs["parent"] = build("parent", Path(opts["parent"]))
    libs["tree"], regs["tree"] = build("tree", tree)
    arms = {"parent": parent_path(libs["parent"]),
            "tree": fused_path(libs["tree"])}
    skel = ROOT / "build" / "ab" / "rglru_scan_skeleton.cu"
    skel.parent.mkdir(parents=True, exist_ok=True)
    skel.write_text("#define RGLRU_NO_GATES\n" + tree.read_text())
    libs["skeleton"], regs["skeleton"] = build("skeleton", skel)
    arms["skeleton"] = fused_path(libs["skeleton"])
    exact = {k: v for k, v in arms.items() if k != "skeleton"}
    result = {"card": smi, "ptxas": regs, "scan": []}
    every = cs.rglru_case(*cs.RG_EVERY, 499, dev, every=True)
    for name, fn in exact.items():
        hs, hn = fn(*every)
        ws, wn = rr.rglru_gated_scan_ref(*every)
        bad = int((hs != ws).sum()) + int((hn != wn).sum())
        print(f"  every bf16 gate input: {name} {bad} elements of h differing "
              f"from the plain version", flush=True)
        if bad:
            raise SystemExit(f"{name} differs from the plain version")
    for i, (B, S, d) in enumerate(cs.SCAN_RG):
        args = cs.rglru_case(B, S, d, 500 + i, dev)
        outs = {name: fn(*args) for name, fn in exact.items()}
        torch.cuda.synchronize()
        for name, (hs, hn) in outs.items():
            bad = (int((hs != outs["parent"][0]).sum())
                   + int((hn != outs["parent"][1]).sum()))
            if bad:
                raise SystemExit(f"{name}: {bad} elements of h differ from "
                                 f"the parent's at {(B, S, d)}")
        del outs
        times = in_turns(arms, lambda fn: events_median(lambda: fn(*args)))
        bound = (10 * B * S * d + 8 * B * d + 4 * d) / cs.HBM_BYTES_PER_S * 1e3
        out = torch.empty((B, S, d), dtype=torch.float32, device=dev)
        add_ms = events_median(lambda: torch.add(args[0], args[1], out=out))
        result["scan"].append({"shape": [B, S, d], "ms": times,
                               "bound_ms": bound, "torch_add_ms": add_ms})
        arms_ms = "; ".join(f"{name} {ms[0]:.4f} / {ms[1]:.4f} ms"
                            for name, ms in times.items())
        print(f"  B{B} S{S} d{d}: h of the tree equal to the parent's; "
              f"{arms_ms} (new bytes bound {bound:.4f} ms; torch.add bf16 + "
              f"bf16 -> f32 {add_ms:.4f} ms, "
              f"{8 * B * S * d / add_ms / 1e9:.2f} TB/s)", flush=True)
        del args
    result["model"] = model_ab(exact, dev)
    print(json.dumps(result))
    if "json" in opts:
        Path(opts["json"]).parent.mkdir(parents=True, exist_ok=True)
        Path(opts["json"]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
