"""Where whisper-small's train step on the card parts from its plain
version: chip_smoke phase 24 (c)'s step (published widths, 12 + 12
layers, B 2 x 64 tokens over 1 500 frames, golden weights) run with the
model's attention pointed at one backward after another, each step's
per-leaf gradient norms held against the plain versions' step
(``golden.train_record_distance``):

* ``plain``: ``ref.flash_attention_ref`` differentiated by autograd in
  f32 (chip_smoke's reference), and ``plain_mb2``, the same at two
  microbatches (the noise floor chip_smoke also measures);
* ``emul``: the same f32 forward with a plain backward written out (P,
  dP, D, dS, then dV, dK, dQ as f32 einsums) that can round, one at a
  time, what the kernel rounds: ``D(bf16 O)`` takes D as rowsum(dO o O)
  of the bf16 output (the dot entry's input), ``bf16 dS`` and ``bf16 P``
  round dS and P to bf16 before the second products (the mma A
  operands); ``emul all`` rounds the three, ``emul dS, P`` the last two
  (what the kernel rounds once D is taken from its f32 output);
* ``kernel``: the port's ``FlashAttentionFn`` (the kernels; dS enters
  the dQ product as bf16 hi + lo, the dK product as bf16);
* ``sdpa``: PyTorch's ``scaled_dot_product_attention`` forward and
  backward, as a yardstick only.

Then, in place: every attention call of the kernel step's backward is
captured (q, k, v, O and its low halves, LSE and the incoming dO); for
each, the kernel entries' dQ, dK, dV against the plain version's under
chip_smoke's ``FLASH_BWD_RTOL`` / ``FLASH_BWD_ATOL`` (worst share of the
limit), and the relative error of the sum of dQ
over the call's tokens
(what a bias before the query projection gathers, up to that
projection), the same for the emulated roundings, beside the keys'
common offset: |mean over keys of k| against the rms of k about it, per
head, the factor by which an error in D or dS that leaves sum_j dS != 0
is magnified in dQ = dS K.

Run from the root of a checkout on a machine with the card:

    python tests/_torch_whisper_bwd.py [json=PATH] [modes=a,b,...]

(``modes`` picks steps by name; the per-call report always runs.)
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import golden as golden_mod  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fr  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm, zoo  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

LEAF = "['dec_layers'][10]['normx']['bias']"


def _scores(q, k, causal, window):
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) / math.sqrt(hd)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= (qp - kp) < window
    return torch.where(ok, s, torch.full_like(s, fr.NEG_INF))


def emul_bwd(q, k, v, o, do, causal, window, d_bf16_o, round_ds, round_p):
    """``(dq, dk, dv)`` f32 of the plain backward written out, with the
    kernel's roundings switched on one by one."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    p = torch.softmax(_scores(q, k, causal, window), -1)  # [B,K,G,S,Skv]
    do5 = do.float().reshape(B, S, K, G, hd)
    dp = torch.einsum("bqkgh,bskh->bkgqs", do5, v.float())
    if d_bf16_o:
        dd = (do.float() * o.float()).sum(-1).reshape(B, S, K, G)
        dd = dd.permute(0, 2, 3, 1)[..., None]
    else:
        dd = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - dd)
    rb = lambda t: t.to(torch.bfloat16).float()
    pm = rb(p) if round_p else p
    dsm = rb(ds) if round_ds else ds
    dv = torch.einsum("bkgqs,bqkgh->bskh", pm, do5)
    dk = torch.einsum("bkgqs,bqkgh->bskh", dsm,
                      q.float().reshape(B, S, K, G, hd)) / math.sqrt(hd)
    dq = torch.einsum("bkgqs,bskh->bqkgh", dsm, k.float()) / math.sqrt(hd)
    return dq.reshape(B, S, H, hd), dk, dv


def emul_fn(**flags):
    class Emul(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            o = fr.flash_attention_ref(q, k, v, causal=causal, window=window)
            ctx.save_for_backward(q, k, v, o)
            ctx.mask = (causal, window)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o = ctx.saved_tensors
            g = emul_bwd(q, k, v, o, do, *ctx.mask, **flags)
            return (g[0].to(q.dtype), g[1].to(k.dtype), g[2].to(v.dtype),
                    None, None)

    def attn(q, k, v, *, causal=True, window=0):
        return Emul.apply(q, k, v, causal, window)
    return attn


def sdpa(q, k, v, *, causal=True, window=0):
    import torch.nn.functional as F
    assert not window
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True)
    return o.transpose(1, 2)


def plain(q, k, v, *, causal=True, window=0):
    return fr.flash_attention_ref(q, k, v, causal=causal, window=window)


def whisper_step(attn, microbatches=1, dev="cuda"):
    W = cs.WHISPER_TRAIN
    wcfg = get("whisper-small")
    tree = golden_mod.golden_weights(zoo.model_defs(wcfg), W["seed"], dev)
    model = lm.LM(wcfg, tree)
    batch = golden_mod.train_tokens(wcfg.vocab_size, dev, {
        "batch": W["batch"], "seq": W["seq"], "seed": W["seed"]})
    batch["frames"] = golden_mod._embeds(
        W["seed"], golden_mod._LANE_FRAMES,
        (W["batch"], W["frames"], wcfg.d_model), dev)
    saved = fops.flash_attention
    if attn is not None:
        fops.flash_attention = attn
    try:
        rec = cs.train_step_record(golden_mod, steps, adamw, model, wcfg,
                                   batch, microbatches)
    finally:
        fops.flash_attention = saved
    del model, tree
    torch.cuda.empty_cache()
    return rec


def leaf_dist(got, want) -> dict:
    return {p: abs(got["leaf_grad_norms"][p] - n) / max(abs(n), 1e-30)
            for p, n in want["leaf_grad_norms"].items()}


def capture_calls():
    """Runs the kernel step with the dot and dQ launchers wrapped to keep
    each attention call's inputs (backward order)."""
    calls, pending = [], {}
    dot, dq = fk.flash_attention_bwd_dot, fk.flash_attention_bwd_dq

    def dot_kept(o, o_lo, do, rows):
        pending.update(o=o, o_lo=o_lo, do=do)
        return dot(o, o_lo, do, rows)

    def dq_kept(q, k, v, do, lse, dlt, *, causal, window):
        calls.append({**pending, "q": q, "k": k, "v": v, "lse": lse,
                      "mask": (causal, window)})
        return dq(q, k, v, do, lse, dlt, causal=causal, window=window)
    fk.flash_attention_bwd_dot, fk.flash_attention_bwd_dq = dot_kept, dq_kept
    try:
        whisper_step(None)
    finally:
        fk.flash_attention_bwd_dot, fk.flash_attention_bwd_dq = dot, dq
    return calls


def call_report(c) -> dict:
    q, k, v, o, lse, do = c["q"], c["k"], c["v"], c["o"], c["lse"], c["do"]
    causal, window = c["mask"]
    want = fr.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                      window=window)
    dq, dk, dv = cs.flash_bwd(fk, q, k, v, o, c["o_lo"], do, lse, causal,
                              window)
    shares = {n: cs.bwd_diff(g, w)[2]
              for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    out = {"S": q.shape[1], "Skv": k.shape[1], "causal": causal,
           "shares": shares}
    # the sum of dQ over tokens, per head, and its error
    sq_w = want[0].float().sum(1)
    sq_err = (dq.float() - want[0].float()).sum(1)
    out["dq_sum_rel_err"] = float(sq_err.norm() / sq_w.norm())
    out["dq_sum_cancel"] = float(sq_w.norm() / want[0].float().abs()
                                 .sum(1).norm())
    # emulated: which rounding moves the sum of dQ
    for name, fl in (("D(bf16 O)", (True, False, False)),
                     ("bf16 dS", (False, True, False)),
                     ("all", (True, True, False))):
        g = emul_bwd(q, k, v, o, do, causal, window, *fl)
        e = (g[0].to(torch.bfloat16).float() - want[0].float()).sum(1)
        out[f"dq_sum_rel_err_emul {name}"] = float(e.norm() / sq_w.norm())
    kf = k.float()
    mean = kf.mean(1, keepdim=True)
    out["key_offset"] = float(((mean.squeeze(1).norm(dim=-1))
                               / (kf - mean).pow(2).sum(-1).mean(1).sqrt())
                              .max())
    return out


def main(argv) -> int:
    args = dict(a.split("=", 1) for a in argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    fk.library()
    step = lambda attn, mb=1: (lambda: whisper_step(attn, mb))
    emul = lambda **fl: step(emul_fn(**fl))
    modes = {
        "plain": step(plain),
        "emul none": emul(d_bf16_o=False, round_ds=False, round_p=False),
        "emul D(bf16 O)": emul(d_bf16_o=True, round_ds=False, round_p=False),
        "emul bf16 dS": emul(d_bf16_o=False, round_ds=True, round_p=False),
        "emul bf16 P": emul(d_bf16_o=False, round_ds=False, round_p=True),
        "emul all": emul(d_bf16_o=True, round_ds=True, round_p=True),
        "emul dS, P": emul(d_bf16_o=False, round_ds=True, round_p=True),
        "kernel": step(None),
        "sdpa": step(sdpa),
        "plain_mb2": step(plain, 2),
    }
    if "modes" in args:
        pick = ["plain", *args["modes"].split(",")]
        modes = {m: modes[m] for m in dict.fromkeys(pick)}
    recs = {m: run() for m, run in modes.items()}
    ref_rec = recs["plain"]
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    report = {"card": card, "steps": {}}
    for m, r in recs.items():
        d = leaf_dist(r, ref_rec)
        top = sorted(d, key=d.get, reverse=True)[:5]
        row = {"loss": r["loss"], "grad_norm": r["grad_norm"],
               "dist": golden_mod.train_record_distance(r, ref_rec),
               "leaf": d[LEAF], "top": {p: d[p] for p in top},
               "over_2^-8": sum(x > 2 ** -8 for x in d.values())}
        report["steps"][m] = row
        print(f"{m:16s} loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f}"
              f" leaf {LEAF} {d[LEAF]:.3e}; worst {top[0]} "
              f"{d[top[0]]:.3e}; leaves over 2^-8: {row['over_2^-8']}",
              flush=True)
    calls = capture_calls()
    rows = []
    n_cross = 0
    for i, c in enumerate(calls):
        r = call_report(c)
        kind = ("cross" if r["S"] != r["Skv"] else
                "dec self" if r["causal"] else "enc self")
        if kind == "cross":
            r["layer"] = 11 - n_cross
            n_cross += 1
        r["kind"] = kind
        rows.append(r)
        print(f"call {i:2d} {kind:8s} layer {r.get('layer', '-')}: shares "
              + ", ".join(f"{n} {s:.3f}" for n, s in r["shares"].items())
              + f"; sum of dQ rel err {r['dq_sum_rel_err']:.3e} (emul "
              + ", ".join(f"{n.split(' ', 1)[1]} {r[n]:.3e}" for n in r
                          if n.startswith("dq_sum_rel_err_emul"))
              + f"), |sum dQ| / sum |dQ| {r['dq_sum_cancel']:.3e}, key "
              f"offset {r['key_offset']:.2f}", flush=True)
        del c
    report["calls"] = rows
    if "json" in args:
        Path(args["json"]).parent.mkdir(parents=True, exist_ok=True)
        Path(args["json"]).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
