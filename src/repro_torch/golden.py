"""The golden full-size reference: what the JAX package computes for the
thesis experiment's two full-size workloads, recorded in
``data/golden_fullwidth.json``, for the full-size synthetic grid
(``SYNTH``), recorded in ``data/golden_synth.json`` with a digest of
every generated stream, and for the serving loop's full-size cells
(``SERVING``), recorded in ``data/golden_serving.json`` with each
point's drawn arrival counts, for dense-LM serving (``LM``:
tinyllama-1.1b at its published widths, prefill then teacher-forced
decode), recorded in ``data/golden_lm.json``, and for SSM serving
(``LM_SSM``: falcon-mamba-7b likewise), recorded in
``data/golden_lm_ssm.json``, and for the rest of the model zoo
(``LM_ZOO``: recurrentgemma-2b, whisper-small, phi3.5-moe,
granite-34b, pixtral-12b and phi3-medium-14b at published widths, most
cut in depth), recorded in ``data/golden_lm_zoo.json`` with the MoE
layer's expert choices, and for one train step (``TRAIN``:
tinyllama-1.1b at its published widths, cut in depth), recorded in
``data/golden_train.json`` (all written by ``tests/_torch_golden.py``).

This module names the workloads, rebuilds their traces with either
package's ``traces`` module (``build_batch``), and loads the traces the
golden results were computed on (``load_batch``, from
``data/golden_traces.npz``).  The stored traces are needed because the
generator draws from numpy's ``Generator`` distributions, whose streams
differ between numpy versions: on another installation the same seed can
give other bytes.  ``trace_sha256`` is the digest the JSON records for
each trace.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"
GOLDEN_PATH = DATA / "golden_fullwidth.json"
TRACES_PATH = DATA / "golden_traces.npz"

#: the two full-size workloads (benchmarks/common.py sizes, Table 5.1)
WORKLOADS = {
    "eight_core": {"mix_seed": 42, "mix_index": 0, "n_cores": 8,
                   "n_req": 40_000, "seed": 3, "policy": "closed"},
    "single_core": {"name": "milc_like", "n_req": 150_000, "seed": 3,
                    "policy": "open"},
}

TRACE_FIELDS = ("gap", "bank", "row", "is_write", "dep", "next_same",
                "length")
#: the per-core request arrays stored for each workload (``next_same`` and
#: the padding are rebuilt by ``batch_traces``)
STORED_FIELDS = ("gap", "bank", "row", "is_write", "dep", "length")


def trace_sha256(batch) -> str:
    """Digest of a ``TraceBatch``'s arrays (field order, native bytes)."""
    h = hashlib.sha256()
    for f in TRACE_FIELDS:
        a = np.ascontiguousarray(getattr(batch, f))
        h.update(f"{f}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def build_batch(traces_mod, spec: dict):
    """The workload's ``TraceBatch`` from either package's ``traces``."""
    if "name" in spec:
        return traces_mod.single_core_batch(spec["name"], spec["n_req"],
                                            seed=spec["seed"])
    names = traces_mod.random_mixes(20, spec["n_cores"],
                                    seed=spec["mix_seed"])[spec["mix_index"]]
    return traces_mod.multicore_batch(names, spec["n_req"], seed=spec["seed"])


SYNTH_PATH = DATA / "golden_synth.json"

#: the full-size synthetic grid (benchmarks/workloads.py::synth_grid): two
#: 8-core mixes x 4 interleaves x 2 geometries x {base, chargecache},
#: each point as benchmarks/common.py::sim_cfg(kind, 8) builds it (closed
#: policy; 128 HCRAC entries per core, 1 ms caching duration)
SYNTH = {
    "mixes": {
        "mix_hot": ["mcf_like", "omnetpp_like", "tpcc64_like", "milc_like",
                    "soplex_like", "sphinx3_like", "gcc_like", "astar_like"],
        "mix_stream": ["stream_copy_like", "lbm_like", "libquantum_like",
                       "bwaves_like", "stream_triad_like", "leslie3d_like",
                       "GemsFDTD_like", "wrf_like"],
    },
    "interleaves": ["bank", "row", "block", "xor"],
    "geometries": {"ddr3_2ch": 2, "ddr3_1ch": 1},   # channels, 8 banks each
    "mechanisms": ["base", "chargecache"],
    "n_req": 40_000, "seed": 3, "policy": "closed",
    "hcrac_entries": 128 * 8, "caching_ms": 1.0,
}

#: positions per block digest of a stored stream
STREAM_BLOCK = 1000


def synth_points() -> list[dict]:
    """The synthetic grid's points, in launch order, as plain labels."""
    return [{"mix": m, "interleave": il, "geometry": g, "mechanism": k}
            for m in SYNTH["mixes"] for il in SYNTH["interleaves"]
            for g in SYNTH["geometries"] for k in SYNTH["mechanisms"]]


def stream_key(point: dict) -> str:
    return f"{point['mix']}/{point['interleave']}/{point['geometry']}"


def stream_block_digests(batch, block: int = STREAM_BLOCK) -> list:
    """Per core, one short digest of every ``block`` positions of a
    ``TraceBatch``'s request arrays (``TRACE_FIELDS`` but ``length``), so
    that two streams whose ``trace_sha256`` differ can be told apart
    block by block."""
    fields = [np.ascontiguousarray(getattr(batch, f))
              for f in TRACE_FIELDS if f != "length"]
    C, L = fields[0].shape
    out = []
    for c in range(C):
        row = []
        for b0 in range(0, L, block):
            h = hashlib.sha256()
            for a in fields:
                h.update(np.ascontiguousarray(a[c, b0:b0 + block]).tobytes())
            row.append(h.hexdigest()[:12])
        out.append(row)
    return out


#: the generator's statistical tolerance (``tests/test_workloads.py``),
#: which holds two streams that differ in a few draws: row-hit rate and
#: RLTL 0.125 ms CDF point within 0.08, total cycles within 7 %, HCRAC
#: hit rate within 0.08 where both sides made enough lookups
STAT_TOLERANCE = {"row_hit_rate": 0.08, "total_cycles_rel": 0.07,
                  "hcrac_hit_rate": 0.08, "hcrac_min_lookups": 500,
                  "rltl_cdf": 0.08}


def tolerance_violations(got: dict, want: dict) -> list[str]:
    """The limits of ``STAT_TOLERANCE`` that ``got``'s stats break
    against ``want``'s (empty when they agree); the RLTL limit applies
    where both carry a histogram."""
    tol = STAT_TOLERANCE
    rate = lambda s, num, den: int(s[num]) / max(int(s[den]), 1)
    bad = []
    d = abs(rate(got, "row_hits", "n_req") - rate(want, "row_hits", "n_req"))
    if d > tol["row_hit_rate"]:
        bad.append(f"row_hit_rate off by {d:.4f}")
    d = abs(int(got["total_cycles"]) / max(int(want["total_cycles"]), 1) - 1)
    if d > tol["total_cycles_rel"]:
        bad.append(f"total_cycles off by {100 * d:.2f} %")
    if min(int(got["hcrac_lookups"]),
           int(want["hcrac_lookups"])) >= tol["hcrac_min_lookups"]:
        d = abs(rate(got, "hcrac_hits", "hcrac_lookups")
                - rate(want, "hcrac_hits", "hcrac_lookups"))
        if d > tol["hcrac_hit_rate"]:
            bad.append(f"hcrac_hit_rate off by {d:.4f}")
    if got.get("rltl_hist") is not None and want.get("rltl_hist") is not None:
        cdf = lambda s: (int(s["rltl_hist"][0])
                         / max(int(np.asarray(s["rltl_hist"]).sum()), 1))
        d = abs(cdf(got) - cdf(want))
        if d > tol["rltl_cdf"]:
            bad.append(f"RLTL 0.125 ms CDF point off by {d:.4f}")
    return bad


SERVING_PATH = DATA / "golden_serving.json"

#: the serving loop's full-size cells (benchmarks/serving_loop.py): the
#: 24-point policy x arrival rate x burstiness x mechanism grid, each point
#: 256 requests (``grid``), and the 10**4-request scale point
#: (``scale_points``); the ``_spec`` there gives every other field
SERVING = {
    "policies": ["fifo", "charge_aware", "preempting"],
    "rates": [1.0, 3.0],
    "bursts": [1.0, 4.0],
    "mechanisms": ["base", "chargecache"],
    "grid_reqs": 256,
    "arrival": {"prompt_pages_min": 1, "prompt_pages_max": 2,
                "decode_min": 4, "decode_max": 8, "seed": 11},
    "spec": {"cycles_per_step": 4000, "hot_entries": 1024, "hot_ways": 2,
             "hot_caching_ms": 0.05, "hot_exact": True},
    "grid_batch": 8,
    #: the grid's mechanisms as ``benchmarks/common.py::mech_config``
    #: builds them: 128 HCRAC entries, 1 ms caching duration
    "mech_entries": 128, "mech_caching_ms": 1.0,
    "scale": {"n_reqs": 10_000, "rate": 8.0, "burstiness": 2.0,
              "max_batch": 32, "policy": "charge_aware"},
}


def serving_points() -> list[dict]:
    """The serving grid's points, in launch order, as plain labels."""
    S = SERVING
    return [{"policy": p, "rate": r, "burstiness": b, "mechanism": k}
            for p in S["policies"] for r in S["rates"] for b in S["bursts"]
            for k in S["mechanisms"]]


def serving_spec_kwargs(n_reqs: int, rate: float, burstiness: float,
                        max_batch: int, policy: str) -> tuple[dict, dict]:
    """``(ArrivalConfig kwargs, ServingSpec kwargs but arrival)`` of a
    ``benchmarks/serving_loop.py::_spec`` point, for either package."""
    S = SERVING
    arrival = {"rate": rate, "burstiness": burstiness, **S["arrival"]}
    spec = {"policy": policy, "n_reqs": n_reqs, "max_batch": max_batch,
            "queue_cap": 4 * max_batch, "arrivals_max": max_batch,
            **S["spec"]}
    return arrival, spec


def load_serving() -> dict:
    with open(SERVING_PATH) as f:
        return json.load(f)


def load_synth() -> dict:
    with open(SYNTH_PATH) as f:
        return json.load(f)


def load() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def save_batches(batches: dict) -> None:
    """Store ``{workload: TraceBatch}`` as the golden traces."""
    np.savez_compressed(TRACES_PATH, **{
        f"{w}.{f}": np.asarray(getattr(b, f))
        for w, b in batches.items() for f in STORED_FIELDS})


def load_batch(traces_mod, wname: str):
    """The stored trace of workload ``wname`` as ``traces_mod``'s
    ``TraceBatch``; raises if its digest is not the recorded one."""
    with np.load(TRACES_PATH) as z:
        a = {f: z[f"{wname}.{f}"] for f in STORED_FIELDS}
    batch = traces_mod.batch_traces([
        traces_mod.Trace(*(a[f][c, :n] for f in STORED_FIELDS[:-1]))
        for c, n in enumerate(a["length"])])
    want = load()["workloads"][wname]["trace_sha256"]
    if trace_sha256(batch) != want:
        raise ValueError(f"stored {wname} trace does not match its digest")
    return batch


FRFCFS_PATH = DATA / "golden_frfcfs.json"

#: the FR-FCFS tier at full size: the eight-core golden trace under
#: {base, chargecache} x frfcfs windows (default configurations, as the
#: golden in-order numbers), recorded from ``repro``'s window engine
FRFCFS = {"workload": "eight_core", "kinds": ("base", "chargecache"),
          "windows": (8, 16)}


def frfcfs_points() -> list[dict]:
    """The FR-FCFS golden points, in record order."""
    return [{"kind": k, "window": w} for k in FRFCFS["kinds"]
            for w in FRFCFS["windows"]]


def load_frfcfs() -> dict:
    with open(FRFCFS_PATH) as f:
        return json.load(f)


DRIVERS_PATH = DATA / "golden_drivers.json"

#: the simulator-side studies recorded from ``repro`` at full size:
#: ``benchmarks/refresh.py``'s grid (its four-core ``milc_like`` stream is
#: generated on the device, so it does not depend on numpy's version)
DRIVERS = {"refresh": {"n_cores": 4, "n_req": 40_000, "seed": 3}}


def load_drivers() -> dict:
    with open(DRIVERS_PATH) as f:
        return json.load(f)


LM_PATH = DATA / "golden_lm.json"

#: dense-LM serving at full width: ``repro``'s ``prefill_fn`` on ``batch``
#: rows of ``prompt`` tokens (cache ``max_len``), then ``steps``
#: teacher-forced ``decode_fn`` steps, weights from ``golden_weights``
LM = {"config": "tinyllama-1.1b", "batch": 4, "prompt": 500,
      "max_len": 520, "steps": 16, "seed": 14, "top_k": 8}

#: lanes of the counter-based draws (weights take the leaf's path id)
_LANE_PROMPT = 0x7072_6F6D
_LANE_DECODE = 0x6465_636F
#: elements a chunk of the weight draw
_CHUNK = 1 << 24


def golden_leaf(path: str, d, seed: int, device="cpu", out=None):
    """The golden value of one ParamDef ``d`` at ``path`` (see
    ``golden_weights``), in bf16 on ``device``, written into ``out`` (a
    bf16 tensor of the leaf's shape) when one is given."""
    import math

    import torch
    if out is None:
        out = torch.empty(d.shape, dtype=torch.bfloat16, device=device)
    if d.init in ("zeros", "ones"):
        return out.fill_(0.0 if d.init == "zeros" else 1.0)
    n = math.prod(d.shape)
    flat = out.view(n)
    for i0 in range(0, n, _CHUNK):
        idx = torch.arange(i0, min(n, i0 + _CHUNK), dtype=torch.int64,
                           device=out.device)
        flat[i0:i0 + idx.numel()] = _leaf_values(path, d, seed, idx)
    return out


def _leaf_values(path: str, d, seed: int, idx):
    """Elements ``idx`` (flat) of the golden value of ParamDef ``d`` at
    ``path``, bf16 (``golden_weights``' draw)."""
    import math

    import torch

    from repro_torch.models.params import path_id
    from repro_torch.workloads import prng
    if d.init in ("zeros", "ones"):
        return torch.full(idx.shape, 0.0 if d.init == "zeros" else 1.0,
                          dtype=torch.bfloat16, device=idx.device)
    c = torch.tensor(math.sqrt(3.0) * d.std, dtype=torch.float32,
                     device=idx.device)
    u = prng.uniform(seed, path_id(path), idx)
    return ((u * 2 - 1) * c).to(torch.bfloat16)


def golden_weights(defs, seed: int, device="cpu"):
    """The golden weights of a ParamDef tree (``repro_torch.models
    .params``), in bf16 on ``device``: a ``normal`` leaf draws element
    ``i`` as ``(2 u - 1) * sqrt(3) * std`` with ``u = prng.uniform(seed,
    path id, i)`` (uniform with the leaf's fan-in std), in float32 and
    then rounded to bf16; ``ones`` / ``zeros`` as declared.  Integer
    hashing and correctly rounded float32 products give the same bits on
    every device and library version (numpy's and ``jax.random``'s
    streams do not), so the card rebuilds the weights ``repro`` ran with.
    Drawn in chunks of ``_CHUNK`` elements."""
    from repro_torch.models.params import map_defs
    return map_defs(lambda path, d: golden_leaf(path, d, seed, device),
                    defs)


def weights_digest(tree) -> str:
    """sha256 over every leaf's path, shape and its first and last 4 096
    elements' bf16 bits (leaves in path order): a check that a device
    rebuilt the golden weights without moving them all to the host."""
    import torch

    from repro_torch.models.params import leaf_paths
    h = hashlib.sha256()
    for path, t in leaf_paths(tree):
        flat = t.reshape(-1)
        h.update(f"{path}:{tuple(t.shape)}".encode())
        for part in (flat[:4096], flat[-4096:]):
            h.update(part.to(torch.bfloat16).view(torch.int16).cpu()
                     .numpy().tobytes())
    return h.hexdigest()


def defs_digest(defs, seed: int) -> str:
    """``weights_digest(golden_weights(defs, seed))`` without building the
    weights: only the first and last 4 096 elements of each leaf are
    drawn."""
    import math

    import torch

    from repro_torch.models.params import leaf_paths
    h = hashlib.sha256()
    for path, d in leaf_paths(defs):
        n = math.prod(d.shape)
        h.update(f"{path}:{tuple(d.shape)}".encode())
        for lo, hi in ((0, min(n, 4096)), (max(0, n - 4096), n)):
            idx = torch.arange(lo, hi, dtype=torch.int64)
            h.update(_leaf_values(path, d, seed, idx).view(torch.int16)
                     .numpy().tobytes())
    return h.hexdigest()


def lm_tokens(vocab: int, device="cpu", spec: dict = LM):
    """``(prompt [batch, prompt], decode inputs [steps, batch])`` int64
    token ids of ``spec`` (``LM`` or ``LM_SSM``), counter-based like the
    weights."""
    import torch

    from repro_torch.workloads import prng
    B, P, T = spec["batch"], spec["prompt"], spec["steps"]
    draw = lambda lane, n: torch.remainder(prng.hash_u32(
        spec["seed"], lane, torch.arange(n, dtype=torch.int64,
                                         device=device)), vocab)
    return (draw(_LANE_PROMPT, B * P).view(B, P),
            draw(_LANE_DECODE, T * B).view(T, B))


def tokens_digest(prompt, decode) -> str:
    h = hashlib.sha256()
    for t in (prompt, decode):
        h.update(t.to("cpu").numpy().astype(np.int32).tobytes())
    return h.hexdigest()


def logits_record(logits, k: int) -> dict:
    """Per row of ``logits [B, V]``: the ``k`` largest values (sorted
    down) and their ids, the logsumexp and the argmax (first index), all
    from the logits as float32."""
    import torch
    x = torch.as_tensor(logits).float()
    top = torch.topk(x, k, dim=-1)
    return {"top_ids": top.indices.tolist(),
            "top_logits": top.values.tolist(),
            "logsumexp": torch.logsumexp(x, -1).tolist(),
            "argmax": torch.argmax(x, -1).tolist()}


def load_lm(path: Path = LM_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


LM_SSM_PATH = DATA / "golden_lm_ssm.json"

#: SSM serving at full width: ``repro``'s ``prefill_fn`` on ``batch``
#: rows of ``prompt`` tokens (two 256-step scan chunks, the second
#: padded), then ``steps`` teacher-forced ``decode_fn`` steps, weights
#: from ``golden_weights``; recorded at full depth and for the model cut
#: to its first ``cut_layers`` layers (random weights make 64 layers
#: chaotic: rounding moves the full-depth logits by ~1)
LM_SSM = {"config": "falcon-mamba-7b", "batch": 2, "prompt": 300,
          "steps": 8, "seed": 15, "top_k": 8, "cut_layers": 2}


LM_ZOO_PATH = DATA / "golden_lm_zoo.json"

#: the rest of the model zoo at published widths: ``repro``'s
#: ``prefill_fn`` (blocked attention) on ``batch`` rows of ``prompt``
#: tokens (after ``patches`` stub patch embeddings; with ``frames`` stub
#: encoder frames), cache ``max_len``, then ``steps`` teacher-forced
#: ``decode_fn`` steps, weights from ``golden_weights`` and inputs
#: counter-based, each model cut to its first ``cut_layers`` layers
#: (None: full depth).  The cuts keep each run's footprint on the CPU that
#: records it near 10 GB: recurrentgemma-2b to one rec, rec, attn period,
#: at a prompt past its 2 048-token window (its ring wraps); phi3.5-moe
#: to 2 layers at one row, so that the first MoE layer's output for every
#: prompt token reaches the compared logits through the second layer's
#: attention; granite-34b and pixtral-12b (whose 1.3 G embedding and
#: head parameters dominate) to 2 layers, phi3-medium-14b to 4.
#: mixtral-8x22b has no entry: one of its layers holds 2.4 G parameters,
#: and ``repro`` on the CPU would need ~18 GB for it.
LM_ZOO = {
    "recurrentgemma-2b": {"config": "recurrentgemma-2b", "cut_layers": 3,
                          "batch": 1, "prompt": 2100, "max_len": 2116,
                          "steps": 8, "seed": 23, "top_k": 8},
    "whisper-small": {"config": "whisper-small", "cut_layers": None,
                      "batch": 2, "prompt": 64, "frames": 1500,
                      "max_len": 80, "steps": 8, "seed": 24, "top_k": 8},
    "phi3.5-moe-42b-a6.6b": {"config": "phi3.5-moe-42b-a6.6b",
                             "cut_layers": 2, "batch": 1, "prompt": 300,
                             "max_len": 308, "steps": 8, "seed": 26,
                             "top_k": 8},
    "granite-34b": {"config": "granite-34b", "cut_layers": 2, "batch": 2,
                    "prompt": 300, "max_len": 308, "steps": 8, "seed": 27,
                    "top_k": 8},
    "pixtral-12b": {"config": "pixtral-12b", "cut_layers": 2, "batch": 2,
                    "prompt": 300, "patches": 256, "max_len": 564,
                    "steps": 8, "seed": 28, "top_k": 8},
    "phi3-medium-14b": {"config": "phi3-medium-14b", "cut_layers": 4,
                        "batch": 2, "prompt": 300, "max_len": 308,
                        "steps": 8, "seed": 29, "top_k": 8},
}

#: lanes of the counter-based stub frames and patch embeddings
_LANE_FRAMES = 0x6672_616D
_LANE_PATCHES = 0x7061_7463
#: how far the port's router logits (bf16) may lie from ``repro``'s on
#: the same golden weights and inputs, in bf16 ulps at the magnitude of
#: the token's largest logit: the two round sums of other orders, over
#: inputs that differ by the upstream layers' rounding.  Measured: 3 for
#: phi3.5-moe's 2 layers against ``repro``, on the CPU
#: (``tests/_torch_golden.py lm_zoo --port``) and on the H100
#: (chip_smoke phase 21); 4 for mixtral's 2 layers against its plain
#: kernels on the H100
ROUTE_LOGIT_ULPS = 4
#: a MoE token is near a tie when two of its first ``top_k + 1`` sorted
#: router logits lie within this many bf16 ulps (at the token's largest
#: logit) of each other: two logits that each move by
#: ``ROUTE_LOGIT_ULPS`` can swap them
ROUTE_NEAR_TIE_ULPS = 2 * ROUTE_LOGIT_ULPS


def zoo_config(cfg, spec: dict):
    """``cfg`` cut to ``spec``'s ``cut_layers`` (unchanged at None)."""
    import dataclasses
    n = spec.get("cut_layers")
    return cfg if n is None else dataclasses.replace(cfg, n_layers=n)


def _embeds(seed: int, lane: int, shape, device):
    """Counter-based bf16 values of unit variance: ``(2 u - 1) sqrt(3)``."""
    import math

    import torch

    from repro_torch.workloads import prng
    n = math.prod(shape)
    u = prng.uniform(seed, lane, torch.arange(n, dtype=torch.int64,
                                              device=device))
    return ((u * 2 - 1) * math.sqrt(3.0)).to(torch.bfloat16).view(shape)


def zoo_inputs(cfg, spec: dict, device="cpu") -> tuple[dict, object]:
    """``(prefill batch, decode tokens [steps, batch])`` of a ``LM_ZOO``
    entry on ``device``: counter-based token ids (``lm_tokens``), and the
    stub encoder ``frames`` [B, frames, d] or ``prefix_embeds`` [B,
    patches, d] (bf16) where the entry has them."""
    prompt, dec = lm_tokens(cfg.vocab_size, device, spec)
    batch = {"tokens": prompt}
    B, d = spec["batch"], cfg.d_model
    if spec.get("frames"):
        batch["frames"] = _embeds(spec["seed"], _LANE_FRAMES,
                                  (B, spec["frames"], d), device)
    if spec.get("patches"):
        batch["prefix_embeds"] = _embeds(spec["seed"], _LANE_PATCHES,
                                         (B, spec["patches"], d), device)
    return batch, dec


def inputs_digest(batch: dict, dec) -> str:
    """sha256 of the token ids (int32) and the stub embeddings' bf16
    bits, in key order."""
    import torch
    h = hashlib.sha256(tokens_digest(batch["tokens"], dec).encode())
    for key in sorted(batch):
        if key != "tokens":
            h.update(key.encode())
            h.update(batch[key].to(torch.bfloat16).view(torch.int16).cpu()
                     .numpy().tobytes())
    return h.hexdigest()


def _token_ulp(logits):
    """[..., 1] the bf16 ulp at each token's largest |router logit|."""
    import torch
    top = torch.as_tensor(logits).float().abs().amax(-1, keepdim=True)
    return torch.exp2(torch.floor(torch.log2(top.clamp_min(2.0 ** -126)))
                      - 7)


def route_near_ties(logits, k: int):
    """[...] bool: the tokens of router ``logits`` [..., E] (f32) whose
    first ``k + 1`` sorted values hold a gap within
    ``ROUTE_NEAR_TIE_ULPS`` bf16 ulps at the token's largest logit."""
    import torch
    lg = torch.as_tensor(logits).float()
    s = torch.sort(lg, -1, descending=True).values[..., :k + 1]
    gaps = s[..., :-1] - s[..., 1:]
    return (gaps <= ROUTE_NEAR_TIE_ULPS * _token_ulp(lg)).any(-1)


def route_logit_ulps(got, want):
    """[...] each token's largest distance of router logits ``got`` from
    ``want`` ([..., E]), in bf16 ulps at ``want``'s largest logit."""
    import torch
    w = torch.as_tensor(want).float()
    return ((torch.as_tensor(got).float() - w).abs()
            / _token_ulp(w)).amax(-1)


def routing_record(eidx, logits, k: int) -> dict:
    """One MoE layer call's routing: the expert ids [B, S, k] (int),
    their sha256 (int32 bytes), the router logits [B, S, E] (bf16 values)
    and the near-tie tokens' flat indices."""
    import torch
    e = torch.as_tensor(eidx).to(torch.int32).cpu()
    lg = torch.as_tensor(logits).float().cpu()
    near = route_near_ties(lg, k).reshape(-1)
    return {"digest": hashlib.sha256(e.numpy().tobytes()).hexdigest(),
            "eidx": e.tolist(), "logits": lg.tolist(),
            "near_ties": torch.nonzero(near).reshape(-1).tolist()}


def load_lm_zoo() -> dict:
    with open(LM_ZOO_PATH) as f:
        return json.load(f)


TRAIN_PATH = DATA / "golden_train.json"

#: one train step at published width: ``repro``'s ``make_train_step(cfg,
#: AdamWConfig(), microbatches=2)`` (default ``RunFlags``: blocked
#: attention, layer remat) on tinyllama-1.1b cut to its first
#: ``cut_layers`` layers (d 2 048, H 32 over K 4, hd 64, d_ff 5 632,
#: vocab 32 000: 0.40 G parameters; the deepest even cut whose recording
#: run, ``repro``'s three steps and the port's on the CPU in one process,
#: stays under 17 GiB of a 62 GB host that others share: peak RSS 16.4
#: GiB at 6 layers, 19.9 at 8, ~1.75 GiB a layer, so ~44 GiB for the 22
#: layers), weights from ``golden_weights``, ``batch`` rows of ``seq``
#: counter-based tokens (``train_tokens``)
TRAIN = {"config": "tinyllama-1.1b", "cut_layers": 6, "batch": 2,
         "seq": 256, "microbatches": 2, "seed": 25}
#: lane of the counter-based training tokens
_LANE_TRAIN = 0x7472_6169


def train_tokens(vocab: int, device="cpu", spec: dict = TRAIN) -> dict:
    """``{"tokens", "targets"}`` int64 [batch, seq] of ``spec``: ``seq +
    1`` counter-hashed ids a row, the targets the tokens shifted by
    one."""
    import torch

    from repro_torch.workloads import prng
    B, S = spec["batch"], spec["seq"]
    ids = torch.remainder(prng.hash_u32(
        spec["seed"], _LANE_TRAIN, torch.arange(B * (S + 1),
                                                dtype=torch.int64,
                                                device=device)),
        vocab).view(B, S + 1)
    return {"tokens": ids[:, :-1].contiguous(),
            "targets": ids[:, 1:].contiguous()}


def leaf_grad_norms(m_tree, b1: float, scale: float) -> dict:
    """``{port leaf path: f32 norm of its gradient}`` after the first
    AdamW step from zero moments, where ``m = (1 - b1) * scale * g``
    (``scale`` the clip factor ``min(1, clip_norm / grad_norm)``): each
    leaf's norm as ``|m| / ((1 - b1) scale)``.  ``m_tree`` is the port's
    tree (layer lists) of tensors."""
    import torch

    from repro_torch.models.params import leaf_paths
    return {path: float(torch.linalg.vector_norm(t.float()))
            / ((1 - b1) * scale) for path, t in leaf_paths(m_tree)}


#: how far a train step on the card may lie from ``golden_train.json``'s
#: ``blocked`` run, relative (``train_record_distance``).  Set from the
#: record's noise floors before the first card run: ``repro``'s naive
#: attention gives the recorded step bit for bit (S 256 is one KV block);
#: its one-microbatch step lies 2.3e-6 (grad_norm) and 4.9e-4 (a leaf's
#: gradient norm) away, 0 in the loss; the port on the CPU (plain
#: kernels) 1.1e-5 (loss), 1.0e-4 (grad_norm), 9.4e-4 (leaf norms)
#: (``tests/_torch_golden.py train --port``).  The card adds the
#: kernels' bf16 roundings (P and dS as mma operands): limits of at least
#: 4x every distance measured, 2^-12 (loss), 2^-10 (grad_norm), 2^-8
#: (leaf norms), and the f32 schedule's few ulps (lr).  Those floors were
#: read on the 2-layer record; on the 6-layer one (kept unchanged) the
#: one-microbatch step lies 1.7e-7 / 2.4e-6 / 8.4e-4 away and the port on
#: the CPU 2.4e-5 / 2.9e-5 / 1.6e-3, so the leaf limit is 2.5x the
#: port's distance there
TRAIN_TOL = {"loss": 2.0 ** -12, "grad_norm": 2.0 ** -10,
             "leaf_grad_norms": 2.0 ** -8, "lr": 1e-6}


#: train steps of the recurrent and MoE families on the card, each held
#: to the same step through the plain versions (no ``repro`` record):
#: published widths, cut in depth as ``LM_ZOO`` cuts them, weights from
#: ``golden_weights`` and ``train_tokens``' counter-based tokens.
#: falcon-mamba-7b's 600 tokens are three scan chunks of 256, the last
#: padded, so gradients cross two chunk boundaries; recurrentgemma-2b's
#: rec, rec, attn period at 2 100 tokens, past its 2 048-token window;
#: phi3.5-moe cut to 1 layer (no kernel of its own: its attention's).  A
#: parameter holds 16 bytes before the update (bf16 weight and gradient,
#: f32 master, m and v) and 14 more while the pure ``adamw.update`` builds
#: the new master, m, v and bf16 weight beside the old: 30 bytes.  The
#: 2-layer cut's 2.86 G parameters need 42.7 GiB, then 80.0 GiB, above
#: the 79.2 GiB an H100 80GB HBM3 offers; its step ran out of memory with
#: 73.9 GiB allocated (``tests/_torch_train_peak.py``).  1 layer: 1.56 G
#: parameters, 43.7 GiB of state at the update, 52.4 GiB peak
TRAIN_ZOO = {
    "falcon-mamba-7b": {"config": "falcon-mamba-7b", "cut_layers": 2,
                        "batch": 2, "seq": 600, "seed": 27},
    "recurrentgemma-2b": {"config": "recurrentgemma-2b", "cut_layers": 3,
                          "batch": 2, "seq": 2100, "seed": 28},
    "phi3.5-moe-42b-a6.6b": {"config": "phi3.5-moe-42b-a6.6b",
                             "cut_layers": 1, "batch": 2, "seq": 300,
                             "seed": 29},
}


def train_limits(floor: dict) -> dict:
    """The limits of a kernels' train step against its plain-version step,
    from the plain step's own distance from itself split into two
    microbatches (``floor``, a ``train_record_distance``): the leaves take
    the larger of ``TRAIN_TOL``'s and 4x the floor rounded down to a power
    of two (the rule that set whisper-small's), the loss, grad_norm and lr
    keep ``TRAIN_TOL``."""
    import math
    four = 4 * floor["leaf_grad_norms"]
    leaf = 2.0 ** math.floor(math.log2(four)) if four > 0 else 0.0
    return {**TRAIN_TOL,
            "leaf_grad_norms": max(TRAIN_TOL["leaf_grad_norms"], leaf)}


def train_record_distance(got: dict, want: dict) -> dict:
    """The largest relative distances of a train-step record from
    another: ``loss``, ``grad_norm``, ``lr`` and the per-leaf gradient
    norms (over the leaves of ``want``; ``worst_leaf`` names the
    farthest)."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    out = {k: rel(got[k], want[k]) for k in ("loss", "grad_norm", "lr")}
    leaf = {p: rel(got["leaf_grad_norms"][p], n)
            for p, n in want["leaf_grad_norms"].items()}
    worst = max(leaf, key=leaf.get)
    out["leaf_grad_norms"] = leaf[worst]
    out["worst_leaf"] = worst
    return out


def load_train() -> dict:
    with open(TRAIN_PATH) as f:
        return json.load(f)


FT_PATH = DATA / "golden_ft.json"

#: the fault-tolerance drill (``examples/fault_tolerance.py``'s schedule:
#: 40 steps, host 3 fails at 25, host 5 straggles from 12, a checkpoint
#: every 10): ``repro``'s example's report and printed lines, recorded on
#: the CPU by ``tests/_torch_golden.py ft``.  They depend on the schedule
#: alone, not on the weights, so the port's drill at any model size must
#: print the same.  On the card the drill runs tinyllama-1.1b at its
#: published widths cut to ``layers`` layers, B ``batch`` x ``seq``.
FT = {"layers": 2, "batch": 8, "seq": 256}


def load_ft() -> dict:
    with open(FT_PATH) as f:
        return json.load(f)
