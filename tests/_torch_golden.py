"""Writes the golden full-size reference of the PyTorch/CUDA port.

Runs the JAX package (``repro``) on the CPU over the two full-size
workloads of ``repro_torch.golden.WORKLOADS`` and records, per mechanism
kind (default ``MechanismConfig``, ``rltl=True``), the exact-int stats
the port must reproduce bit for bit: ``BITWISE_KEYS``, ``core_end`` and
the RLTL histogram, plus a sha256 of each trace's arrays.
It also stores the traces themselves (``golden_traces.npz``), since numpy's
random streams differ between numpy versions.

For the full-size synthetic grid (``repro_torch.golden.SYNTH``, 32 points)
it runs ``repro.core.sweep_synth`` and records the same values per point
in ``golden_synth.json``, plus, per (mix, interleave, geometry), the
sha256 of the stream ``repro.workloads.materialize`` generates and one
short digest per 1 000 positions of each core.  No stream is stored:
this generator is counter-based, so numpy's version does not change it.
``chip_smoke.py`` reads only these files (``src/repro_torch/data/``).

For the serving loop's full-size cells (``repro_torch.golden.SERVING``:
the 24-point grid of ``benchmarks/serving_loop.py`` and its 10**4-request
scale point) it runs ``repro.core.simulator.sweep_serving`` over an
explicit list of configurations, arrivals drawn, and records every
counter, the bank arrays, the per-step counts drawn and the per-step
accepted arrivals, occupancy and queue length in
``golden_serving.json``.

For dense-LM serving (``repro_torch.golden.LM``: tinyllama-1.1b at its
published widths) it builds the golden weights with the port on the CPU
(``golden.golden_weights``), carries them into ``repro`` with
``convert.to_repro``, runs ``repro``'s ``prefill_fn`` and teacher-forced
``decode_fn`` (``attn_impl="blocked"``) and records per step and row the
top-8 logits and ids, the logsumexp and the argmax, with digests of the
weights and the token inputs, in ``golden_lm.json``.  It then runs the
port on the CPU on the same inputs and prints how far its logits are
from ``repro``'s (not recorded).

For SSM serving (``repro_torch.golden.LM_SSM``: falcon-mamba-7b at its
published widths) it does the same with ``ssm_impl="xla"`` (``repro``'s
own ``test_ssm_scan`` holds its Pallas kernel to that scan) into
``golden_lm_ssm.json``, at full depth and again on its first
``cut_layers`` layers: with random weights the 64-layer model is chaotic
(an ulp in 0.1 % of the weights moves ``repro``'s own logits by ~1), so
only the cut run can hold the port to bf16 rounding.  The 14.5 GB of weights are drawn once, layer by
layer into stacked bf16 tensors that the port's model views and JAX
reads through DLPack without a copy; XLA's while-loop invariant code
motion is switched off for this run, since on the CPU it hoists an f32
copy of every stacked weight (29 GB) out of the layer scan, a move that
changes no value.  The run then stays near 20 GB.  It is written only
on request (``lm_ssm``, not ``all``): ~8 minutes for the weights and
~10 for the two runs on eight cores.

For the FR-FCFS tier (``repro_torch.golden.FRFCFS``) it runs
``repro.core.simulate`` over the stored eight-core trace with frfcfs
windows 8 and 16 for base and ChargeCache and records the same values
plus the per-bank accumulators in ``golden_frfcfs.json``, then
``benchmarks/frfcfs.py``'s grid at full size (every cell's stats and
the digests of its stream; argument ``frfcfs``, ~6 minutes).

For the simulator-side studies (``repro_torch.golden.DRIVERS``) it runs
``benchmarks/refresh.py`` at its full size (its ``run()``, then its grid)
and records every cell's stats with the per-bank accumulators, the row,
the headline numbers of its document and the digests of its stream in
``golden_drivers.json`` (argument ``drivers``, about half a minute).

For the rest of the model zoo (``repro_torch.golden.LM_ZOO``:
recurrentgemma-2b, whisper-small, phi3.5-moe, granite-34b, pixtral-12b,
phi3-medium-14b at published widths, cut in depth as each entry says) it
runs ``repro``'s ``prefill_fn`` and teacher-forced ``decode_fn``
(blocked attention) on the golden weights and counter-based inputs (the
stub frames and patch embeddings too) and records per step the top-k
logits as for ``lm``, the weights' and inputs' digests, and for the MoE
entry every layer call's expert choices, router logits and near-tie
tokens (read through a host callback around ``repro``'s ``moe_apply``)
in ``golden_lm_zoo.json``.  Argument ``lm_zoo`` (only on request), then
optionally a comma-separated subset of the entries, whose records merge
into the file, and ``--port`` to print the port's CPU distance to each
(for the MoE entry also its router logits' distance, in the units of
``golden.ROUTE_LOGIT_ULPS``): up to ~9 minutes and 12.8 GiB peak RSS an
entry on eight cores (printed after each entry).

Run from the repo root (a few minutes on two CPU cores; ``lm`` about
five minutes on eight); the argument ``synth``, ``traces``, ``serving``,
``frfcfs``, ``drivers``, ``lm``, ``lm_ssm``, ``lm_zoo``, ``train`` or
``ft`` writes only that part:

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python tests/_torch_golden.py

For the fault-tolerance drill (``repro_torch.golden.FT``) it runs
``examples/fault_tolerance.py`` (reduced tinyllama) and records its
``RunReport`` and its printed lines in ``golden_ft.json`` (argument
``ft``, ~15 s): they depend on the schedule alone, so the port's drill
at full width must give the same.

The argument ``streams`` writes nothing: it generates each distinct
stream of the synthetic grid with the port on the CPU and prints, per
stream, the positions (and 1 000-position blocks) where it differs from
``repro``'s.
"""

from __future__ import annotations

import json
import sys

from repro_torch.golden import (DRIVERS_PATH, FRFCFS, FRFCFS_PATH,
                                GOLDEN_PATH, SERVING,
                                SERVING_PATH, SYNTH, SYNTH_PATH, WORKLOADS,
                                build_batch, frfcfs_points,
                                save_batches, serving_points,
                                serving_spec_kwargs, stream_block_digests,
                                stream_key, synth_points, trace_sha256)


def cell_record(stats: dict, keys) -> dict:
    rec = {k: int(stats[k]) for k in keys}
    rec["core_end"] = [int(x) for x in stats["core_end"]]
    rec["rltl_hist"] = [int(x) for x in stats["rltl_hist"]]
    rec["rltl_total"] = int(stats["rltl_total"])
    return rec


def batches() -> dict:
    """The full-size traces, from ``repro``'s generator."""
    from repro.core import traces
    return {w: build_batch(traces, spec) for w, spec in WORKLOADS.items()}


def compute(trace_batches: dict) -> dict:
    from _parity import BITWISE_KEYS
    from repro.core import MechanismConfig, SimConfig, sweep
    from repro.experiment import registry

    out = {"bitwise_keys": list(BITWISE_KEYS), "kinds": list(registry.names()),
           "workloads": {}}
    for wname, spec in WORKLOADS.items():
        batch = trace_batches[wname]
        grid = [SimConfig(mech=MechanismConfig(kind=k), policy=spec["policy"])
                for k in registry.names()]
        res = sweep(batch, grid, rltl=True)
        out["workloads"][wname] = {
            **spec,
            "n_steps": int(batch.length.sum()),
            "trace_sha256": trace_sha256(batch),
            "results": {k: cell_record(r, BITWISE_KEYS)
                        for k, r in zip(registry.names(), res)},
        }
    return out


def compute_frfcfs() -> dict:
    """``repro``'s window engine over the stored eight-core trace, a
    ``simulate`` a point (``repro``'s ``sweep`` of an frfcfs grid does
    not run: ROADMAP.md, Queue 3)."""
    from _parity import BITWISE_KEYS
    from repro.core import MechanismConfig, SimConfig, simulate, traces
    from repro_torch.golden import load, load_batch
    wname = FRFCFS["workload"]
    batch = load_batch(traces, wname)
    spec = load()["workloads"][wname]
    grid = [SimConfig(mech=MechanismConfig(kind=p["kind"]),
                      policy=spec["policy"], controller="frfcfs",
                      window=p["window"]) for p in frfcfs_points()]
    res = [simulate(batch, cfg) for cfg in grid]
    points = []
    for p, r in zip(frfcfs_points(), res):
        rec = cell_record(r, BITWISE_KEYS)
        rec.update({k: [int(x) for x in r[k]]
                    for k in ("bank_acts", "bank_act_ras_sum")})
        points.append({**p, **rec})
    return {"workload": wname, "policy": spec["policy"],
            "n_steps": int(batch.length.sum()),
            "trace_sha256": spec["trace_sha256"],
            "bitwise_keys": list(BITWISE_KEYS), "points": points,
            "study": compute_frfcfs_study(BITWISE_KEYS)}


def compute_frfcfs_study(keys) -> dict:
    """``benchmarks/frfcfs.py``'s grid at its full size (40 000 requests
    a core), through ``repro``'s Experiment: every cell's stats, and the
    digests of the stream all its points share."""
    import os
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    if os.environ.get("REPRO_BENCH_QUICK", "0") == "1":
        raise RuntimeError("the study is recorded at its full size")
    from benchmarks import frfcfs as F
    from repro.core import WorkloadSpec
    from repro.workloads import materialize
    res = F.frfcfs_grid()[0]
    spec = WorkloadSpec(names=F.LOCALITY_MIX, n_req=F.C.N_REQ_8C, seed=7)
    stream = materialize(spec)
    cells = []
    for m in res.coords["mechanism"]:
        for c in res.coords["controller"]:
            for w in res.coords["window"]:
                r = res.sel(mechanism=m, controller=c, window=w).cells.flat[0]
                rec = {k: int(r[k]) for k in keys}
                rec["core_end"] = [int(x) for x in r["core_end"]]
                cells.append({"mechanism": m, "controller": c, "window": w,
                              **rec})
    return {"n_req": F.C.N_REQ_8C, "names": list(F.LOCALITY_MIX),
            "seed": 7, "stream_sha256": trace_sha256(stream),
            "stream_blocks": stream_block_digests(stream), "cells": cells}


def compute_drivers() -> dict:
    """``benchmarks/refresh.py``'s grid at its full size (four cores x
    40 000 requests) through ``repro``'s Experiment: every cell's stats
    (with the per-bank accumulators), the study's row and headline
    numbers (its own ``run()``, its document written to a temporary
    directory) and the digests of the stream all its points share."""
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    if os.environ.get("REPRO_BENCH_QUICK", "0") == "1":
        raise RuntimeError("the studies are recorded at their full size")
    from _parity import BITWISE_KEYS
    from benchmarks import refresh as R
    from repro.core import WorkloadSpec
    from repro.workloads import materialize
    from repro_torch.golden import DRIVERS
    spec = DRIVERS["refresh"]
    assert R.C.N_REQ_8C == spec["n_req"]
    with tempfile.TemporaryDirectory() as d:
        R.REFRESH_JSON = os.path.join(d, "refresh.json")
        rows = R.run()  # first, so that its one-compile assertion holds
        with open(R.REFRESH_JSON) as f:
            doc = json.load(f)
    res = R.refresh_grid()[0]
    cells = []
    for idx in np.ndindex(*res.shape):
        r = res.cells[idx]
        rec = {d: res.coords[d][i] for d, i in zip(res.dims, idx)}
        rec.update({k: int(r[k]) for k in BITWISE_KEYS})
        rec.update({k: [int(x) for x in r[k]]
                    for k in ("core_end", "bank_acts", "bank_act_ras_sum")})
        cells.append(rec)
    wspec = WorkloadSpec(names=("milc_like",) * spec["n_cores"],
                         n_req=spec["n_req"], seed=spec["seed"])
    base = R.C.sim_cfg("base", spec["n_cores"])
    stream = materialize(wspec, base.dram, base.interleave)
    headline = {k: v for k, v in doc.items()
                if isinstance(v, (int, float)) and k != "compiles"}
    return {"refresh": {**spec, "compiles": doc["compiles"],
                        "dims": list(res.dims),
                        "meta": {k: res.meta[k] for k in
                                 ("n_points", "n_unique", "n_chunks")},
                        "bitwise_keys": list(BITWISE_KEYS),
                        "stream_sha256": trace_sha256(stream),
                        "stream_blocks": stream_block_digests(stream),
                        "headline": headline, "row": rows[0],
                        "cells": cells}}


def synth_configs() -> list:
    """The synthetic grid's ``repro`` configurations, in launch order."""
    from repro.core import (DRAMConfig, HCRACConfig, InterleaveConfig,
                            MechanismConfig, SimConfig, WorkloadSpec,
                            lowered_for_duration, ms_to_cycles)
    ms = SYNTH["caching_ms"]
    return [SimConfig(
        dram=DRAMConfig(n_channels=SYNTH["geometries"][p["geometry"]]),
        mech=MechanismConfig(
            kind=p["mechanism"],
            hcrac=HCRACConfig(n_entries=SYNTH["hcrac_entries"],
                              caching_cycles=ms_to_cycles(ms)),
            lowered=lowered_for_duration(ms)),
        policy=SYNTH["policy"], interleave=InterleaveConfig(p["interleave"]),
        workload=WorkloadSpec(names=tuple(SYNTH["mixes"][p["mix"]]),
                              n_req=SYNTH["n_req"], seed=SYNTH["seed"]))
        for p in synth_points()]


def compute_synth() -> dict:
    from _parity import BITWISE_KEYS
    from repro.core import sweep_synth
    from repro.workloads import materialize

    grid = synth_configs()
    res = sweep_synth(grid, rltl=True)
    points = [{**p, **cell_record(r, BITWISE_KEYS)}
              for p, r in zip(synth_points(), res)]
    streams = {}
    for p, cfg in zip(synth_points(), grid):
        key = stream_key(p)
        if key not in streams:
            batch = materialize(cfg.workload, cfg.dram, cfg.interleave)
            streams[key] = {"sha256": trace_sha256(batch),
                            "blocks": stream_block_digests(batch)}
    return {"grid": SYNTH, "bitwise_keys": list(BITWISE_KEYS),
            "n_steps": 8 * grid[0].workload.max_len,
            "points": points, "streams": streams}


def compare_streams() -> None:
    """Print where the port's CPU streams differ from ``repro``'s."""
    import numpy as np
    from repro.workloads import materialize
    from repro_torch.core import dram, traces
    from repro_torch.workloads import materialize as t_materialize
    seen = set()
    for p, cfg in zip(synth_points(), synth_configs()):
        key = stream_key(p)
        if key in seen:
            continue
        seen.add(key)
        want = materialize(cfg.workload, cfg.dram, cfg.interleave)
        got = t_materialize(
            traces.WorkloadSpec(names=cfg.workload.names,
                                n_req=cfg.workload.n_req,
                                seed=cfg.workload.seed),
            dram.DRAMConfig(n_channels=cfg.dram.n_channels),
            dram.InterleaveConfig(cfg.interleave.kind))
        differ = np.zeros(got.gap.shape, bool)
        for f in ("gap", "bank", "row", "is_write", "dep", "next_same"):
            differ |= np.asarray(getattr(want, f)) != getattr(got, f)
        blocks = {(c, i // 1000) for c, i in zip(*np.nonzero(differ))}
        print(f"{key}: {int(differ.sum())} of {int(got.length.sum())} "
              f"positions differ, in {len(blocks)} blocks of 1000")


def serving_configs() -> tuple[list, object]:
    """The serving grid's ``repro`` configurations in launch order, and
    the 10**4-request scale point's."""
    from repro.core import (HCRACConfig, MechanismConfig, SimConfig,
                            lowered_for_duration, ms_to_cycles)
    from repro.serving.loop import ServingSpec
    from repro.workloads.arrivals import ArrivalConfig
    S = SERVING

    def cfg(n, rate, burst, batch, policy, mech):
        arr, spec = serving_spec_kwargs(n, rate, burst, batch, policy)
        return SimConfig(mech=mech, serving=ServingSpec(
            arrival=ArrivalConfig(**arr), **spec))

    ms = S["mech_caching_ms"]
    grid = [cfg(S["grid_reqs"], p["rate"], p["burstiness"], S["grid_batch"],
                p["policy"], MechanismConfig(
                    kind=p["mechanism"],
                    hcrac=HCRACConfig(n_entries=S["mech_entries"],
                                      caching_cycles=ms_to_cycles(ms)),
                    lowered=lowered_for_duration(ms)))
            for p in serving_points()]
    sc = S["scale"]
    scale = cfg(sc["n_reqs"], sc["rate"], sc["burstiness"], sc["max_batch"],
                sc["policy"], MechanismConfig())
    return grid, scale


def serving_record(cfg, res: dict) -> dict:
    """A serving point's exact-int results: every scalar counter, the
    bank arrays, the per-step arrival counts ``repro`` draws
    (``counts``) and the per-step accepted arrivals / occupancy / queue
    length."""
    import jax.numpy as jnp
    import numpy as np
    from repro.core.simulator import BANK_STAT_KEYS, STAT_KEYS
    from repro.serving.loop.engine import SERVE_STAT_KEYS
    from repro.workloads.arrivals import arrival_params, step_counts
    counts = step_counts(jnp, arrival_params(cfg.serving.arrival,
                                             cfg.serving.n_reqs),
                         jnp.arange(int(res["n_steps"]), dtype=jnp.int32))
    rec = {k: int(res[k]) for k in STAT_KEYS + SERVE_STAT_KEYS
           + ("total_cycles", "n_steps")}
    rec["counts"] = [int(x) for x in np.asarray(counts)]
    for k in BANK_STAT_KEYS:
        rec[k] = [int(x) for x in res[k]]
    for k in ("arrivals", "occ", "qlen"):
        rec[k] = [int(x) for x in res["steps"][k]]
    return rec


def compute_serving() -> dict:
    """``repro.core.simulator.sweep_serving`` over the grid and the scale
    point, arrivals drawn (``collect_steps`` records the counts drawn)."""
    from repro.core.simulator import sweep_serving
    grid, scale = serving_configs()
    res = sweep_serving(grid, collect_steps=True)
    big = sweep_serving([scale], collect_steps=True)[0]
    return {"grid": SERVING, "n_steps": int(res[0]["n_steps"]),
            "points": [{**p, **serving_record(c, r)}
                       for p, c, r in zip(serving_points(), grid, res)],
            "scale": serving_record(scale, big)}


def compute_lm() -> tuple[dict, dict]:
    """``repro`` at full width on the golden weights and tokens; returns
    the record and the per-step logits (numpy float32)."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get
    from repro.models import lm as jlm, zoo
    from repro_torch import golden
    from repro_torch.models import convert, lm

    from repro_torch.configs import get as t_get
    L = golden.LM
    cfg, t_cfg = get(L["config"]), t_get(L["config"])
    t0 = time.time()
    tree = golden.golden_weights(lm.lm_defs(t_cfg), L["seed"])
    model = lm.LM(t_cfg, tree)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), convert.to_repro(model))
    prompt, dec = golden.lm_tokens(cfg.vocab_size)
    print(f"weights and tokens: {time.time() - t0:.0f} s", flush=True)
    flags = jlm.RunFlags(attn_impl="blocked")
    prefill = jax.jit(lambda p, t: zoo.prefill_fn(p, {"tokens": t}, cfg,
                                                  L["max_len"], flags))
    decode = jax.jit(lambda p, c, t: zoo.decode_fn(p, c, t, cfg, flags))
    logits, cache = prefill(params, jnp.asarray(prompt.numpy(), jnp.int32))
    steps = [np.asarray(logits, np.float32)]
    for t in range(L["steps"]):
        logits, cache = decode(params, cache,
                               jnp.asarray(dec[t].numpy(), jnp.int32))
        steps.append(np.asarray(logits, np.float32))
    print(f"repro prefill + {L['steps']} decode steps: "
          f"{time.time() - t0:.0f} s", flush=True)
    rec = {"lm": L, "attn_impl": "blocked",
           "weights_digest": golden.weights_digest(tree),
           "tokens_digest": golden.tokens_digest(prompt, dec),
           "steps": [golden.logits_record(x, L["top_k"]) for x in steps]}
    return rec, {"model": model, "cfg": t_cfg, "prompt": prompt, "dec": dec,
                 "logits": steps}


def port_vs_repro(run: dict, L: dict, max_len: int) -> tuple[float, float]:
    """Print how far the port's CPU logits are from ``repro``'s; returns
    the largest top-k and logsumexp distances over the steps."""
    import numpy as np
    from repro_torch.models import zoo
    cfg, model = run["cfg"], run["model"]
    logits, cache = zoo.prefill_fn(model, {"tokens": run["prompt"]}, cfg,
                                   max_len)
    got = [logits.float().numpy()]
    for t in range(L["steps"]):
        logits, cache = zoo.decode_fn(model, cache, run["dec"][t], cfg)
        got.append(logits.float().numpy())
    lse = lambda x: np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1)) \
        + x.max(-1)
    worst_top = worst_lse = 0.0
    for t, (g, w) in enumerate(zip(got, run["logits"])):
        top = np.sort(w, -1)[:, ::-1][:, :L["top_k"]]
        gtop = np.sort(g, -1)[:, ::-1][:, :L["top_k"]]
        d_top = float(np.abs(gtop - top).max())
        d_lse = float(np.abs(lse(g.astype(np.float64))
                             - lse(w.astype(np.float64))).max())
        worst_top, worst_lse = max(worst_top, d_top), max(worst_lse, d_lse)
        print(f"  step {t}: port (CPU) vs repro: max |d| all logits "
              f"{np.abs(g - w).max():.4f}, top-{L['top_k']} {d_top:.4f}, "
              f"logsumexp {d_lse:.4f}, argmax equal "
              f"{int((g.argmax(-1) == w.argmax(-1)).sum())}/{len(g)}")
    return worst_top, worst_lse


def stacked_golden_model(t_cfg, seed: int):
    """The golden weights of ``t_cfg`` as ``(port model, its tree,
    repro's tree)`` sharing one copy: each layer leaf (of ``layers``, or
    ``enc_layers`` / ``dec_layers``) is drawn into row ``i`` of a stacked
    ``[n, ...]`` bf16 tensor, the port's layers view those rows, and
    ``repro``'s tree reads the stacked tensors through DLPack (no copy on
    the CPU)."""
    import jax
    import torch
    from repro_torch import golden
    from repro_torch.models import lm, zoo
    from repro_torch.models.params import map_defs
    defs = zoo.model_defs(t_cfg)

    def empty(d_tree, n):
        if isinstance(d_tree, dict):
            return {k: empty(v, n) for k, v in d_tree.items()}
        return torch.empty((n,) + d_tree.shape, dtype=torch.bfloat16)

    def fill(stk, d_tree, path, i):
        if isinstance(d_tree, dict):
            for k, v in d_tree.items():
                fill(stk[k], v, f"{path}[{k!r}]", i)
        else:
            golden.golden_leaf(path, d_tree, seed, out=stk[i])

    def rows(stk, i):
        if isinstance(stk, dict):
            return {k: rows(v, i) for k, v in stk.items()}
        return stk[i]

    def jx(t):
        if isinstance(t, dict):
            return {k: jx(v) for k, v in t.items()}
        return jax.dlpack.from_dlpack(t)

    stacked = {}
    for key, layers in defs.items():
        if isinstance(layers, list):
            stacked[key] = empty(layers[0], len(layers))
            for i, layer in enumerate(layers):
                fill(stacked[key], layer, f"[{key!r}][{i}]", i)
    top = map_defs(lambda path, d: golden.golden_leaf(path, d, seed),
                   {k: v for k, v in defs.items() if k not in stacked})
    tree = dict(top, **{k: [rows(stk, i) for i in range(len(defs[k]))]
                        for k, stk in stacked.items()})
    model = lm.LM(t_cfg, tree)
    return model, tree, jx(dict(top, **stacked))


def compute_lm_ssm() -> tuple[dict, list]:
    """``repro`` (``ssm_impl="xla"``) at full width on the golden weights
    and tokens of ``LM_SSM``, at full depth and cut to its first
    ``cut_layers`` layers (the same weights); returns the record and the
    port's two runs."""
    import dataclasses
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get
    from repro.models import lm as jlm, zoo
    from repro_torch import golden
    from repro_torch.configs import get as t_get
    from repro_torch.models import lm
    L = golden.LM_SSM
    cfg, t_cfg = get(L["config"]), t_get(L["config"])
    t0 = time.time()
    model, tree, params = stacked_golden_model(t_cfg, L["seed"])
    prompt, dec = golden.lm_tokens(cfg.vocab_size, spec=L)
    print(f"weights and tokens: {time.time() - t0:.0f} s", flush=True)
    flags = jlm.RunFlags(ssm_impl="xla")
    max_len = L["prompt"] + L["steps"]

    def run_repro(p, c):
        prefill = jax.jit(lambda p, t: zoo.prefill_fn(p, {"tokens": t}, c,
                                                      max_len, flags))
        decode = jax.jit(lambda p, ca, t: zoo.decode_fn(p, ca, t, c, flags))
        logits, cache = prefill(p, jnp.asarray(prompt.numpy(), jnp.int32))
        out = [np.asarray(logits, np.float32)]
        for t in range(L["steps"]):
            logits, cache = decode(p, cache,
                                   jnp.asarray(dec[t].numpy(), jnp.int32))
            out.append(np.asarray(logits, np.float32))
        return out

    steps = run_repro(params, cfg)
    print(f"repro prefill + {L['steps']} decode steps: "
          f"{time.time() - t0:.0f} s", flush=True)
    n_cut = L["cut_layers"]
    cut_cfg = dataclasses.replace(cfg, n_layers=n_cut)
    cut_params = dict(params, layers=jax.tree_util.tree_map(
        lambda a: a[:n_cut], params["layers"]))
    cut_steps = run_repro(cut_params, cut_cfg)
    cut_tree = dict(tree, layers=tree["layers"][:n_cut])
    t_cut_cfg = dataclasses.replace(t_cfg, n_layers=n_cut)
    rec = {"lm": L, "ssm_impl": "xla",
           "weights_digest": golden.weights_digest(tree),
           "tokens_digest": golden.tokens_digest(prompt, dec),
           "steps": [golden.logits_record(x, L["top_k"]) for x in steps],
           "cut": {"n_layers": n_cut,
                   "weights_digest": golden.weights_digest(cut_tree),
                   "steps": [golden.logits_record(x, L["top_k"])
                             for x in cut_steps]}}
    runs = [{"model": m, "cfg": c, "prompt": prompt, "dec": dec,
             "logits": x}
            for m, c, x in ((model, t_cfg, steps),
                            (lm.LM(t_cut_cfg, cut_tree), t_cut_cfg,
                             cut_steps))]
    return rec, runs


def compute_lm_zoo(names=None) -> dict:
    """``repro`` (blocked attention) at published widths on the golden
    weights and inputs of each ``LM_ZOO`` entry (``names``: a subset),
    cut in depth as the entry says; for MoE entries also every layer
    call's expert choices (``golden.routing_record``), read through a
    host callback around ``repro``'s ``moe_apply``.  Returns the record
    and the port's runs (for ``port_vs_repro``)."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get
    from repro.models import layers as jlayers, lm as jlm, zoo
    from repro_torch import golden
    from repro_torch.configs import get as t_get
    flags = jlm.RunFlags(attn_impl="blocked")
    out, runs = {}, {}
    calls = []
    orig_moe = jlayers.moe_apply

    def moe_recorded(p, x, cfg):
        y, aux = orig_moe(p, x, cfg)
        logits = (x @ p["router"].astype(x.dtype)).astype(jnp.float32)
        _, eidx = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)
        jax.debug.callback(lambda e, lg: calls.append(
            golden.routing_record(np.asarray(e), np.asarray(lg),
                                  cfg.top_k)), eidx, logits, ordered=True)
        return y, aux

    jlayers.moe_apply = moe_recorded
    try:
        for name, spec in golden.LM_ZOO.items():
            if names and name not in names:
                continue
            t0 = time.time()
            cfg = golden.zoo_config(get(spec["config"]), spec)
            t_cfg = golden.zoo_config(t_get(spec["config"]), spec)
            model, tree, params = stacked_golden_model(t_cfg, spec["seed"])
            batch, dec = golden.zoo_inputs(t_cfg, spec)
            jbatch = {k: (jnp.asarray(v.numpy(), jnp.int32)
                          if k == "tokens" else jax.dlpack.from_dlpack(v))
                      for k, v in batch.items()}
            prefill = jax.jit(lambda p, b: zoo.prefill_fn(
                p, b, cfg, spec["max_len"], flags))
            decode = jax.jit(lambda p, c, t: zoo.decode_fn(p, c, t, cfg,
                                                           flags))
            calls.clear()
            logits, cache = prefill(params, jbatch)
            steps = [np.asarray(logits, np.float32)]
            routing = [list(calls)]
            for t in range(spec["steps"]):
                calls.clear()
                logits, cache = decode(params, cache,
                                       jnp.asarray(dec[t].numpy(), jnp.int32))
                steps.append(np.asarray(logits, np.float32))
                routing.append(list(calls))
            del cache
            rec = {"spec": spec, "n_layers": cfg.n_layers,
                   "attn_impl": "blocked",
                   "weights_digest": golden.weights_digest(tree),
                   "inputs_digest": golden.inputs_digest(batch, dec),
                   "steps": [golden.logits_record(x, spec["top_k"])
                             for x in steps]}
            if cfg.family == "moe":
                jax.effects_barrier()
                rec["routing"] = routing
                ties = sum(len(c["near_ties"]) for r in routing for c in r)
                print(f"  {name}: {ties} near-tie router tokens over "
                      f"{sum(len(r) for r in routing)} layer calls")
            out[name] = rec
            runs[name] = {"model": model, "cfg": t_cfg, "batch": batch,
                          "dec": dec, "logits": steps, "spec": spec}
            print(f"{name}: {cfg.n_layers} layers, repro prefill + "
                  f"{spec['steps']} decode steps: {time.time() - t0:.0f} s, "
                  f"peak RSS so far {peak_rss_gib():.1f} GiB", flush=True)
            del params
    finally:
        jlayers.moe_apply = orig_moe
    return out, runs


def compute_train(port: bool = False) -> dict:
    """``repro``'s train step of ``golden.TRAIN`` on the golden weights and
    tokens: the recorded run (``make_train_step(cfg, AdamWConfig(),
    microbatches=2)``, default ``RunFlags``), the same step with
    ``attn_impl="naive"`` and with one microbatch (the noise floors), and
    with ``port`` the port's own step on the CPU beside them."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.configs import get
    from repro.launch import steps
    from repro.models import lm as jlm
    from repro.optim import adamw
    from repro_torch import golden
    from repro_torch.configs import get as t_get
    from repro_torch.launch import steps as t_steps
    from repro_torch.models import convert, lm
    from repro_torch.optim import adamw as t_adamw

    T = golden.TRAIN
    cfg = golden.zoo_config(get(T["config"]), T)
    t_cfg = golden.zoo_config(t_get(T["config"]), T)
    t0 = time.time()
    tree = golden.golden_weights(lm.lm_defs(t_cfg), T["seed"])
    model = lm.LM(t_cfg, tree)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    convert.to_repro(model))
    tokens = golden.train_tokens(cfg.vocab_size)
    batch = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in tokens.items()}
    opt_cfg = adamw.AdamWConfig()
    print(f"weights and tokens: {time.time() - t0:.0f} s", flush=True)

    def record(out, m_port):
        gn = float(out["grad_norm"])
        scale = min(1.0, opt_cfg.clip_norm / max(gn, 1e-9))
        return {"loss": float(out["loss"]), "grad_norm": gn,
                "lr": float(out["lr"]),
                "leaf_grad_norms": golden.leaf_grad_norms(m_port, opt_cfg.b1,
                                                          scale)}

    def run(attn_impl, mb):
        t1 = time.time()
        step = jax.jit(steps.make_train_step(
            cfg, opt_cfg, flags=jlm.RunFlags(attn_impl=attn_impl),
            microbatches=mb))
        _, opt, out = step(params, adamw.init(params), batch)
        m = convert.tree_from_repro(
            jax.tree_util.tree_map(np.asarray, opt.m), "cpu", torch.float32)
        rec = record(out, m)
        print(f"repro {attn_impl} microbatches={mb}: loss {rec['loss']:.6f} "
              f"grad_norm {rec['grad_norm']:.6f} lr {rec['lr']:.3e} "
              f"({time.time() - t1:.0f} s, peak RSS {peak_rss_gib():.1f} "
              f"GiB)", flush=True)
        return rec

    rec = {"train": T, "weights_digest": golden.weights_digest(tree),
           "tokens_digest": golden.tokens_digest(tokens["tokens"],
                                                 tokens["targets"]),
           "blocked": run("blocked", T["microbatches"]),
           "naive": run("naive", T["microbatches"]),
           "blocked_mb1": run("blocked", 1)}
    for key in ("naive", "blocked_mb1"):
        print(f"distance of repro's {key} run from the recorded one: "
              f"{golden.train_record_distance(rec[key], rec['blocked'])}",
              flush=True)
    if port:
        t1 = time.time()
        step = t_steps.make_train_step(t_cfg, t_adamw.AdamWConfig(),
                                       microbatches=T["microbatches"])
        opt, out = step(model, t_adamw.init(model.tree()), tokens)
        got = record(out, opt.m)
        print(f"port (CPU, plain kernels): loss {got['loss']:.6f} grad_norm "
              f"{got['grad_norm']:.6f} ({time.time() - t1:.0f} s): distance "
              f"{golden.train_record_distance(got, rec['blocked'])}; "
              f"peak RSS {peak_rss_gib():.1f} GiB", flush=True)
    return rec


def compute_ft() -> dict:
    """``repro``'s fault-tolerance example: its report and its printed
    lines (checkpoints in a temporary directory, removed)."""
    import contextlib
    import importlib.util
    import io
    import shutil
    import tempfile
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "fault_tolerance.py"
    spec = importlib.util.spec_from_file_location("repro_ft_example", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    import types
    tmp = tempfile.mkdtemp()
    ex.tempfile = types.SimpleNamespace(
        mkdtemp=lambda prefix="": tempfile.mkdtemp(prefix=prefix, dir=tmp))
    reports = []
    run = ex.ft.fault_tolerant_run

    def recorded(*a, **k):
        reports.append(run(*a, **k))
        return reports[-1]
    out = io.StringIO()
    ex.ft.fault_tolerant_run = recorded
    try:
        with contextlib.redirect_stdout(out):
            ex.main()
    finally:
        ex.ft.fault_tolerant_run = run
        shutil.rmtree(tmp, ignore_errors=True)
    rep = reports[0]
    return {"report": {"steps_done": rep.steps_done,
                       "failures": list(rep.failures),
                       "redispatches": rep.redispatches,
                       "remeshes": [list(r) for r in rep.remeshes],
                       "restored_from": list(rep.restored_from)},
            "lines": out.getvalue().splitlines()}


def peak_rss_gib() -> float:
    """This process's peak resident set size (Linux: ``ru_maxrss`` in
    KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def zoo_port_vs_repro(run: dict, rec: dict) -> tuple[float, float, float]:
    """``port_vs_repro`` for a ``compute_lm_zoo`` run (stub inputs
    included), and for a MoE entry the largest distance of the port's
    router logits from the record's (``golden.route_logit_ulps``; else
    0)."""
    import numpy as np
    from repro_torch import golden
    from repro_torch.models import layers, zoo
    cfg, model, spec = run["cfg"], run["model"], run["spec"]
    routed, orig = [], layers.moe_route

    def hooked(p, x, c):
        routed.append((x @ p["router"].to(x.dtype)).float())
        return orig(p, x, c)
    layers.moe_route = hooked
    try:
        logits, cache = zoo.prefill_fn(model, run["batch"], cfg,
                                       spec["max_len"])
        got = [logits.float().numpy()]
        for t in range(spec["steps"]):
            logits, cache = zoo.decode_fn(model, cache, run["dec"][t], cfg)
            got.append(logits.float().numpy())
    finally:
        layers.moe_route = orig
    calls = [c for step in rec.get("routing", []) for c in step]
    worst_route = max((float(golden.route_logit_ulps(g, c["logits"]).max())
                       for g, c in zip(routed, calls)), default=0.0)
    worst_top = worst_lse = 0.0
    lse = lambda x: np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1)) \
        + x.max(-1)
    for g, w in zip(got, run["logits"]):
        k = spec["top_k"]
        top = np.sort(w, -1)[:, ::-1][:, :k]
        gtop = np.sort(g, -1)[:, ::-1][:, :k]
        worst_top = max(worst_top, float(np.abs(gtop - top).max()))
        worst_lse = max(worst_lse, float(np.abs(
            lse(g.astype(np.float64)) - lse(w.astype(np.float64))).max()))
    return worst_top, worst_lse, worst_route


def main(argv) -> int:
    what = argv[1] if len(argv) > 1 else "all"
    if what == "streams":
        compare_streams()
        return 0
    if what in ("all", "traces"):
        tb = batches()
        data = compute(tb)
        GOLDEN_PATH.parent.mkdir(parents=True, exist_ok=True)
        with open(GOLDEN_PATH, "w") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        save_batches(tb)
        for wname, w in data["workloads"].items():
            print(wname, {k: r["total_cycles"]
                          for k, r in w["results"].items()})
    if what in ("all", "synth"):
        data = compute_synth()
        with open(SYNTH_PATH, "w") as f:
            json.dump(data, f, indent=None, separators=(",", ":"))
            f.write("\n")
        for p in data["points"]:
            print(stream_key(p), p["mechanism"], p["total_cycles"])
    if what in ("all", "serving"):
        data = compute_serving()
        with open(SERVING_PATH, "w") as f:
            json.dump(data, f, indent=None, separators=(",", ":"))
            f.write("\n")
        for p in data["points"]:
            print(p["policy"], p["rate"], p["burstiness"], p["mechanism"],
                  p["retired"], p["admit_hot"], p["lat_sum"])
        s = data["scale"]
        print("scale", s["n_steps"], s["retired"], s["lat_sum"])
    if what in ("all", "drivers"):
        data = compute_drivers()
        with open(DRIVERS_PATH, "w") as f:
            json.dump(data, f, indent=None, separators=(",", ":"))
            f.write("\n")
        r = data["refresh"]
        print(r["row"])
        print(r["meta"], r["stream_sha256"])
    if what in ("all", "frfcfs"):
        data = compute_frfcfs()
        with open(FRFCFS_PATH, "w") as f:
            json.dump(data, f, indent=None, separators=(",", ":"))
            f.write("\n")
        for p in data["points"]:
            print(p["kind"], p["window"], p["total_cycles"], p["row_hits"])
    from repro_torch import golden
    if what in ("all", "lm"):
        data, run = compute_lm()
        with open(golden.LM_PATH, "w") as f:
            json.dump(data, f, indent=None, separators=(",", ":"))
            f.write("\n")
        for t, r in enumerate(data["steps"]):
            print(t, r["argmax"], [round(x[0], 4) for x in r["top_logits"]])
        port_vs_repro(run, golden.LM, golden.LM["max_len"])
    if what in ("all", "ft"):
        data = compute_ft()
        with open(golden.FT_PATH, "w") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        print(data["report"])
    if what == "train":
        data = compute_train(port="--port" in argv)
        with open(golden.TRAIN_PATH, "w") as f:
            json.dump(data, f, indent=None, separators=(",", ":"))
            f.write("\n")
    if what == "lm_zoo":
        import os
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                                   "disable_hlo_passes=while-loop-invariant-"
                                   "code-motion")
        names = argv[2].split(",") if len(argv) > 2 else None
        data, runs = compute_lm_zoo(names)
        if golden.LM_ZOO_PATH.exists():
            data = {**golden.load_lm_zoo(), **data}
        with open(golden.LM_ZOO_PATH, "w") as f:
            json.dump({k: data[k] for k in golden.LM_ZOO if k in data}, f,
                      indent=None, separators=(",", ":"))
            f.write("\n")
        for name, run in runs.items():
            if "--port" in argv:
                top, lse, route = zoo_port_vs_repro(run, data[name])
                print(f"{name}: port (CPU) vs repro: max |d| top-k "
                      f"{top:.4f}, logsumexp {lse:.4f}, router logits "
                      f"{route:g} bf16 ulps")
    if what == "lm_ssm":
        import os
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                                   "disable_hlo_passes=while-loop-invariant-"
                                   "code-motion")
        data, run = compute_lm_ssm()
        with open(golden.LM_SSM_PATH, "w") as f:
            json.dump(data, f, indent=None, separators=(",", ":"))
            f.write("\n")
        for t, r in enumerate(data["steps"]):
            print(t, r["argmax"], [round(x[0], 4) for x in r["top_logits"]])
        L = golden.LM_SSM
        for name, r in zip(("full depth", f"first {L['cut_layers']} layers"),
                           run):
            print(f"port (CPU) vs repro, {name}:")
            top, lse = port_vs_repro(r, L, L["prompt"] + L["steps"])
            print(f"  largest distance: top-{L['top_k']} {top:.4f}, "
                  f"logsumexp {lse:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
