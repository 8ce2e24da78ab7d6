"""The RG-LRU scan's backward and the ssm_scan dC sum against earlier
sources of ``rglru_scan.cu`` and ``ssm_scan.cu`` on one card, in turns.

Builds the parent's two sources (a directory given on the command line,
holding ``rglru_scan.cu`` and ``ssm_scan.cu``) and the tree's through the
port's own ``repro_torch._build.build`` (same flags, content-keyed under
``build/kernels/``), binds their backward entries (the C signatures are
the same: ``rglru_scan_bwd_scratch`` / ``rglru_scan_bwd_launch`` and
``ssm_scan_dc_sum_launch``) and prints ptxas's registers, spills and
static shared memory of every backward kernel, with the RG-LRU backward's
dynamic shared memory where the library reports it.  Then:

* the RG-LRU backward (every launch of one ``rglru_scan_bwd_launch``) at
  B 2 x 2 048 x 2 560 (recurrentgemma-2b's rec layer) and B 2 x 2 100 x
  2 560 (chip_smoke's train step: a partial last tile), inputs as
  chip_smoke phase 24 (f) draws them: ``dr_pre``, ``di_pre``, ``du`` and
  ``dh0`` required bitwise equal between the arms, each arm's ``dnsp``
  within ``ref.dnsp_limit`` of the plain version's;
* the dC sum at falcon-mamba-7b's chunk B 2 x T 256 x D 8 192 x N 16 (the
  512 block partials of the tree's ``ssm_scan_bwd``): each arm's ``dc``
  within ``ref.dc_limit`` of the plain version's;

* the RG-LRU forward (``rglru_scan_launch``, which shares the source and
  its tensor-map encoder with the backward) at chip_smoke phase 19's
  shapes (``chip_smoke.SCAN_RG``): ``h_seq`` and ``h_S`` required bitwise
  equal between the arms;

each timed as a CUDA graph of 20 calls (``chip_smoke.graph_ms``) in the
order parent, tree, tree, parent, and bitwise when run twice.  Beside the
RG-LRU arms, the tree's pipeline alone: a build of its source with each
element's gradients (``grads``) replaced by three adds (its outputs are
wrong and are not compared), timed after the turns, as what the loads,
the chain and the stores cost without the math.  Prints the card, each
arm's times, the means of the two turns and their ratio, and each arm's
share of its bytes bound; ``json=PATH`` writes them.

Run from the root of a checkout on a machine with the card, the parent's
sources in a directory the copy carries (``build/`` is ignored by git):

    mkdir -p build/ab
    for k in rglru_scan ssm_scan; do git show \\
        <commit>:src/repro_torch/kernels/$k/csrc/$k.cu > build/ab/$k.cu; done
    python tests/_torch_scan_bwd_ab.py parent=build/ab [json=PATH]
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as rk  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as rr  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as sr  # noqa: E402

KERNELS = ROOT / "src" / "repro_torch" / "kernels"
#: the RG-LRU shapes (B, S, d) and the dC sum's chunk (B, T, D, N)
RGLRU_SHAPES = [(2, 2048, 2560), (2, 2100, 2560)]
SSM_SHAPE = (2, 256, 8192, 16)
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = r"(rglru_scan_bwd_(?:chain_|gates_|nsp_)?kernel|" \
          r"ssm_scan_dc_sum_kernel(?:ILi\d+E)?)"


#: the pipeline-alone build: ``grads`` calls become ``pipeline_grads``
PIPELINE = """
__device__ __forceinline__ void pipeline_grads(float r, float i, float uu,
    float a, float l, float hp, float ns, float& dr, float& di, float& du,
    float& term) {
  dr = r + l; di = i + hp; du = uu + a; term = ns;
}
"""


def pipeline_source(tree: Path) -> Path:
    """The tree's ``rglru_scan.cu`` with the gradients' math taken out
    (``PIPELINE``), under ``build/ab/``."""
    src = tree.read_text()
    anchor = "// One element's gradients"
    if src.count("        grads(") != 2 or anchor not in src:
        raise SystemExit("the tree's rglru_scan.cu no longer has the two "
                         "grads calls the pipeline build replaces")
    src = src.replace("        grads(", "        pipeline_grads(")
    src = src.replace(anchor, PIPELINE + anchor)
    out = ROOT / "build" / "ab" / "rglru_scan_pipeline.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def build(name: str, src: Path) -> tuple[ctypes.CDLL, dict]:
    """Build ``src`` as library ``ab_<name>``; its handle, bound, and
    ptxas's report of its backward kernels."""
    path = _build.build(f"ab_{name}", [src])
    regs = cs.ptxas_report(path.with_suffix(".log").read_text(), ENTRIES)
    lib = ctypes.CDLL(str(path))
    if "rglru" in name:
        lib.rglru_scan_launch.restype = _I
        lib.rglru_scan_launch.argtypes = [_I] * 3 + [_P] * 8
        lib.rglru_scan_bwd_scratch.restype = ctypes.c_longlong
        lib.rglru_scan_bwd_scratch.argtypes = [_I] * 3
        lib.rglru_scan_bwd_launch.restype = _I
        lib.rglru_scan_bwd_launch.argtypes = [_I] * 3 + [_P] * 15
        if hasattr(lib, "rglru_scan_bwd_smem_bytes"):
            lib.rglru_scan_bwd_smem_bytes.restype = _I
            regs["dynamic_smem_bytes"] = lib.rglru_scan_bwd_smem_bytes()
    else:
        lib.ssm_scan_dc_sum_launch.restype = _I
        lib.ssm_scan_dc_sum_launch.argtypes = [_I] * 4 + [_P] * 3
    print(f"  {name}: {regs}", flush=True)
    return lib, regs


def rglru_arm(lib, args):
    """A call of ``lib``'s backward on ``args`` into outputs of its own."""
    r_pre, i_pre, u, nsp, h0, h_seq, dh_seq, dh_s = args
    B, S, d = r_pre.shape
    dev = r_pre.device
    outs = [torch.empty((B, S, d), dtype=torch.bfloat16, device=dev)
            for _ in range(3)]
    outs += [torch.empty((d,), device=dev), torch.empty((B, d), device=dev)]
    scratch = torch.empty((lib.rglru_scan_bwd_scratch(B, S, d),),
                          device=dev)

    def run():
        err = _build.launch(lib.rglru_scan_bwd_launch, dev, B, S, d,
                            *(t.data_ptr() for t in args),
                            scratch.data_ptr(),
                            *(t.data_ptr() for t in outs))
        if err:
            raise RuntimeError(f"rglru_scan_bwd launch failed ({err})")
        return outs
    return run


def rglru_fwd_arm(lib, args):
    """A call of ``lib``'s forward on ``args`` (r_pre, i_pre, u, nsp, h0)
    into outputs of its own."""
    B, S, d = args[0].shape
    dev = args[0].device
    outs = [torch.empty((B, S, d), device=dev),
            torch.empty((B, d), device=dev)]

    def run():
        err = _build.launch(lib.rglru_scan_launch, dev, B, S, d,
                            *(t.data_ptr() for t in args),
                            *(t.data_ptr() for t in outs))
        if err:
            raise RuntimeError(f"rglru_scan launch failed ({err})")
        return outs
    return run


def dc_arm(lib, part):
    """A call of ``lib``'s dC sum over the partials ``part``."""
    B, nblk, T, N = part.shape
    dc = torch.empty((B, T, N), device=part.device)

    def run():
        err = _build.launch(lib.ssm_scan_dc_sum_launch, part.device, B, T,
                            N, nblk, part.data_ptr(), dc.data_ptr())
        if err:
            raise RuntimeError(f"ssm_scan_dc_sum launch failed ({err})")
        return dc
    return run


def in_turns(arms: dict) -> dict:
    """Each arm timed (``graph_ms``) in the order parent, tree, tree,
    parent, with the means and the parent's over the tree's."""
    times = {"parent": [], "tree": []}
    for name in ("parent", "tree", "tree", "parent"):
        times[name].append(cs.graph_ms(arms[name]))
    mean = {n: sum(t) / len(t) for n, t in times.items()}
    return {"times_ms": times, "mean_ms": mean,
            "parent_over_tree": mean["parent"] / mean["tree"]}


def main(argv) -> int:
    opts = dict(a.split("=", 1) for a in argv if "=" in a)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if "parent" not in opts:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    parent = Path(opts["parent"])
    libs, ptxas = {}, {}
    for arm, kind, src in (
            ("parent", "rglru", parent / "rglru_scan.cu"),
            ("tree", "rglru", KERNELS / "rglru_scan/csrc/rglru_scan.cu"),
            ("parent", "ssm", parent / "ssm_scan.cu"),
            ("tree", "ssm", KERNELS / "ssm_scan/csrc/ssm_scan.cu")):
        libs[arm, kind], ptxas[f"{arm}_{kind}"] = build(f"{kind}_{arm}", src)
    pipeline, _ = build("rglru_pipeline", pipeline_source(
        KERNELS / "rglru_scan/csrc/rglru_scan.cu"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    result = {"card": card, "ptxas": ptxas, "rglru": [], "dc_sum": None,
              "rglru_forward": []}
    for i, (B, S, d) in enumerate(cs.SCAN_RG):
        args = cs.rglru_case(B, S, d, 500 + i, dev)
        arms = {a: rglru_fwd_arm(libs[a, "rglru"], args)
                for a in ("parent", "tree")}
        got = {a: [t.clone() for t in fn()] for a, fn in arms.items()}
        again = [t.clone() for t in arms["tree"]()]
        differ = [int((got["tree"][k] != got["parent"][k]).sum())
                  for k in (0, 1)]
        twice = all(torch.equal(a, b) for a, b in zip(got["tree"], again))
        row = {"shape": [B, S, d], "differ_from_parent": differ,
               "bitwise_twice": twice, **in_turns(arms)}
        n_bytes = 10 * B * S * d + 8 * B * d + 4 * d
        bound, _ = cs.bound_of(n_bytes, 0)
        row["bound_ms"] = bound
        row["bound_share"] = {a: bound / ms for a, ms in
                              row["mean_ms"].items()}
        result["rglru_forward"].append(row)
        print(f"  rglru_scan forward B{B} S{S} d{d}: h_seq / h_S elements of "
              f"the tree differing from the parent's {differ}; tree bitwise "
              f"twice {twice}; device ms parent {row['times_ms']['parent']},"
              f" tree {row['times_ms']['tree']}; parent / tree "
              f"{row['parent_over_tree']:.2f}x; of the bytes bound "
              f"{bound:.4f} ms: parent "
              f"{100 * row['bound_share']['parent']:.1f} %, tree "
              f"{100 * row['bound_share']['tree']:.1f} %", flush=True)
        if differ != [0, 0] or not twice:
            raise SystemExit("the RG-LRU forward's arms disagree")
        del args, arms, got, again
        torch.cuda.empty_cache()
    for i, (B, S, d) in enumerate(RGLRU_SHAPES):
        r_pre, i_pre, u, nsp, h0 = cs.rglru_case(B, S, d, 2480 + i, dev)
        g.manual_seed(2490 + i)
        dh_seq = torch.randn((B, S, d), generator=g, device=dev)
        dh_s = torch.randn((B, d), generator=g, device=dev)
        h_seq, _ = rk.rglru_scan(r_pre, i_pre, u, nsp, h0)
        args = (r_pre, i_pre, u, nsp, h0, h_seq, dh_seq, dh_s)
        arms = {a: rglru_arm(libs[a, "rglru"], args)
                for a in ("parent", "tree")}
        got = {a: [t.clone() for t in fn()] for a, fn in arms.items()}
        again = [t.clone() for t in arms["tree"]()]
        want = rr.rglru_gated_scan_bwd_ref(*args)
        lim = rr.dnsp_limit(*args)
        differ = [int((got["tree"][k] != got["parent"][k]).sum())
                  for k in (0, 1, 2, 4)]
        share = {a: float(((o[3] - want[3]).abs() / lim).max())
                 for a, o in got.items()}
        twice = all(torch.equal(a, b) for a, b in zip(got["tree"], again))
        row = {"shape": [B, S, d], "differ_from_parent": differ,
               "dnsp_share": share, "bitwise_twice": twice,
               **in_turns(arms)}
        row["pipeline_ms"] = cs.graph_ms(rglru_arm(pipeline, args))
        bound, _ = cs.rglru_bwd_bound(B, S, d)
        row["bound_ms"] = bound
        row["bound_share"] = {a: bound / ms for a, ms in
                              row["mean_ms"].items()}
        result["rglru"].append(row)
        print(f"  rglru_scan backward B{B} S{S} d{d}: dr_pre / di_pre / du / "
              f"dh0 elements of the tree differing from the parent's "
              f"{differ}; dnsp worst share of its limit {share}; tree "
              f"bitwise twice {twice}; device ms parent "
              f"{row['times_ms']['parent']}, tree {row['times_ms']['tree']};"
              f" parent / tree {row['parent_over_tree']:.2f}x; of the "
              f"bytes bound {bound:.4f} ms: parent "
              f"{100 * row['bound_share']['parent']:.1f} %, tree "
              f"{100 * row['bound_share']['tree']:.1f} %; the tree's "
              f"pipeline alone {row['pipeline_ms']:.4f} ms", flush=True)
        if differ != [0, 0, 0, 0] or max(share.values()) > 1.0 or not twice:
            raise SystemExit("the RG-LRU backward's arms disagree")
        del args, arms, got, again, want, lim, h_seq, dh_seq
        torch.cuda.empty_cache()
    B, T, D, N = SSM_SHAPE
    decay, dbu, c, h0 = cs.scan_case(B, T, D, N, 2470, dev)
    g.manual_seed(2471)
    dy = torch.randn((B, T, D), generator=g, device=dev)
    dh_t = torch.randn((B, D, N), generator=g, device=dev)
    _, _, h_seq = sk.ssm_scan_train(decay, dbu, c, h0)
    part = sk.ssm_scan_bwd(decay, h_seq, h0, c, dy, dh_t)[3]
    del h_seq
    want = sr.ssm_scan_bwd_ref(decay, dbu, c, h0, dy, dh_t)[2]
    lim = sr.dc_limit(decay, dbu, h0, dy)
    del decay, dbu
    arms = {a: dc_arm(libs[a, "ssm"], part) for a in ("parent", "tree")}
    got = {a: fn().clone() for a, fn in arms.items()}
    twice = torch.equal(got["tree"], arms["tree"]())
    share = {a: float(((o - want).abs() / lim).max()) for a, o in got.items()}
    row = {"shape": [B, T, D, N], "partials": list(part.shape),
           "dc_share": share, "bitwise_twice": twice, **in_turns(arms)}
    bound, _ = cs.bound_of(4 * (part.numel() + B * T * N), 0)
    row["bound_ms"] = bound
    row["bound_share"] = {a: bound / ms for a, ms in row["mean_ms"].items()}
    result["dc_sum"] = row
    print(f"  ssm_scan dC sum B{B} T{T} D{D} N{N} ({part.shape[1]} block "
          f"partials): dc worst share of its limit {share}; tree bitwise "
          f"twice {twice}; device ms parent {row['times_ms']['parent']}, "
          f"tree {row['times_ms']['tree']}; parent / tree "
          f"{row['parent_over_tree']:.2f}x; of the bytes bound "
          f"{bound:.4f} ms: parent "
          f"{100 * row['bound_share']['parent']:.1f} %, tree "
          f"{100 * row['bound_share']['tree']:.1f} %", flush=True)
    if max(share.values()) > 1.0 or not twice:
        raise SystemExit("the dC sum's arms disagree")
    print(json.dumps(result))
    if "json" in opts:
        Path(opts["json"]).parent.mkdir(parents=True, exist_ok=True)
        Path(opts["json"]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
