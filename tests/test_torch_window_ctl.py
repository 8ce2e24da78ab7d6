"""The window entry's controller warp (``kernels/include/window_ctl.cuh``)
built as host C++, against the port's plain window engine on the CPU.

The header is the code warp 0 of ``sim_step.cu``'s window entry runs: the
admission attempts (each core's issue time in its owner lane's
registers, recomputed only when its own state changes) and the FR-FCFS
selection (each slot's key in its lane's registers, the hit bits of the
served bank's slots recomputed after each service), in two controllers:
``FastCtl`` for launches of at most 32 cores and 32 slots, ``Ctl`` for
any other.  Both run every case they take.  Built by ``g++`` its
lane abstraction is a sequential emulation of the 32 lanes, so the same
text runs here.  A small host program feeds it each core's stream as the
staged records the kernel's producer warp writes, and stands in for the
service with a stub that returns the plain engine's own completion time,
the bank's new open row and the controller clock of the same step.

Held against ``controller/engine.py`` run step by step on the same grid:
every admission (step, core, position, issue time, window slot,
admission sequence) and every selection (step, slot, core, position), in
order, exactly.  The stub also counts any service whose core and
position differ from the plain engine's.  Windows 1, 4, 16 and 40 (past
one warp's lanes), 8 and 40 cores (past one warp), MSHR 1, 2 and 4, streams
with dependent requests, both row policies, and 2 channels x 2 ranks,
where tRRD and tFAW bind; an in-order rider at a window cap of 1.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.controller import engine
from repro_torch.core import simulator as sim
from repro_torch.core import traces
from repro_torch.core.dram import DRAMConfig

INCLUDE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "kernels" / "include")
D2 = DRAMConfig(n_channels=2, n_ranks=2, n_banks=8)
NAMES = ("mcf_like", "stream_copy_like", "omnetpp_like", "lbm_like")

#: launches: (cores, requests a core, MSHR, points (kind, controller,
#: window, 2 x 2 geometry?, row policy))
GROUPS = {
    "8c_mshr4": (8, 30, 4, (("base", "frfcfs", 1, False, "open"),
                            ("chargecache", "frfcfs", 4, False, "closed"),
                            ("base", "frfcfs", 16, False, "open"),
                            ("base", "frfcfs", 8, True, "closed"),
                            ("chargecache", "frfcfs", 16, True, "open"),
                            ("base", "inorder", 1, True, "open"))),
    "8c_mshr1": (8, 24, 1, (("base", "frfcfs", 4, False, "open"),
                            ("chargecache", "frfcfs", 16, False, "closed"),
                            ("base", "frfcfs", 8, True, "open"))),
    "8c_mshr2": (8, 30, 2, (("base", "frfcfs", 4, False, "open"),
                            ("chargecache", "frfcfs", 16, True, "closed"))),
    "8c_w40": (8, 30, 4, (("rltl", "frfcfs", 40, False, "closed"),
                          ("base", "frfcfs", 40, True, "open"))),
    "40c_mshr4": (40, 6, 4, (("base", "frfcfs", 4, False, "closed"),
                             ("chargecache", "frfcfs", 16, False, "open"),
                             ("base", "frfcfs", 40, False, "open"),
                             ("base", "frfcfs", 40, True, "closed"))),
    "40c_mshr1": (40, 5, 1, (("base", "frfcfs", 16, False, "open"),
                             ("chargecache", "frfcfs", 40, True, "closed"))),
}
#: the fast controller takes launches of at most 32 cores and 32 slots
FAST = ("8c_mshr4", "8c_mshr1", "8c_mshr2")
CASES = [(g, i, ctl) for g, (_, _, _, pts) in GROUPS.items()
         for i in range(len(pts))
         for ctl in (("fast", "generic") if g in FAST else ("generic",))]

_MAIN = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include "window_ctl.cuh"
using namespace winctl;

// Core c's staged records, L a core (two past the longest stream).
struct ArraySrc {
  const Rec* recs;
  int L;
  Rec first(int c, int i) const { return recs[c * L + i]; }
  Rec record(int c, int p) const { return recs[c * L + p]; }
};

struct Input {
  int C, M, WN, cap, n_steps, NB, L;
  std::vector<int> len;
  std::vector<Rec> recs;
  // the plain engine's service of each step: live, core, position, its
  // completion, the bank's open row after it, the clock after the step
  std::vector<int> svc;
};

// Run controller ``Ctl_`` over the input, the stub serving each selected
// slot with the plain engine's numbers; print its admissions and
// selections.
template <class Ctl_>
int run(const Input& in) {
  const int C = in.C, M = in.M, WN = in.WN;
  std::vector<int> len = in.len;
  std::vector<int> ring(C * M, 0), ring_served(C * M, 1), pk_p(C, 0),
      pk_ri(C, 0), pk_iss(C, 0), pk_last(C, 0), pk_ys(C, 0), pk_yd(C, 0),
      skey(WN, NO_KEY), open_row(in.NB, -1);
  std::vector<Rec> pk_front(C), pk_next(C);
  std::vector<Slot> slots(WN);
  Ctl_ ctl;
  ctl.m = Mem{ring.data(),     ring_served.data(), len.data(),
              pk_p.data(),     pk_ri.data(),       pk_iss.data(),
              pk_last.data(),  pk_ys.data(),       pk_yd.data(),
              pk_front.data(), pk_next.data(),     slots.data(),
              skey.data(),     open_row.data()};
  ctl.src = ArraySrc{in.recs.data(), in.L};
  const Warp w{};
  ctl.init(w, C, M, WN, in.cap);
  auto live = [&](int j) {
    return j < 32 ? ctl.key0[j] != NO_KEY : skey[j] != NO_KEY;
  };
  int errors = 0, s = 0;
  std::vector<char> was(WN);
  std::vector<int> adm;
  for (; s < in.n_steps; ++s) {
    for (int a = 0; a < WN; ++a) {
      for (int j = 0; j < WN; ++j) was[j] = live(j);
      const int seq0 = ctl.seq;
      if (!ctl.admit(w)) break;
      int j = -1, n_new = 0;
      for (int i = 0; i < WN; ++i)
        if (live(i) && !was[i]) {
          j = i;
          ++n_new;
        }
      errors += n_new != 1;
      if (j < 0) break;
      adm.insert(adm.end(), {s, j, seq0});
    }
    const int e = ctl.select(w);
    // the admissions' records are in shared memory now
    for (size_t i = 0; i < adm.size(); i += 3) {
      const Rec& x = slots[adm[i + 1]].aux;
      std::printf("A %d %d %d %d %d %d\n", adm[i], x.x, x.y, x.w, adm[i + 1],
                  adm[i + 2]);
    }
    adm.clear();
    const int* r = &in.svc[6 * s];
    if (e < 0) {
      errors += r[0] != 0;
      break;
    }
    const Slot sl = slots[e];
    std::printf("S %d %d %d %d\n", s, e, sl.aux.x, sl.aux.y);
    if (!r[0] || r[1] != sl.aux.x || r[2] != sl.aux.y) {
      ++errors;
      break;
    }
    open_row[sl.rec.z & 0xffff] = r[4];
    ctl.served(w, e, sl, r[3], r[4], r[5]);
  }
  std::printf("E %d %d\n", errors, s);
  return 0;
}

int main(int argc, char** argv) {
  Input in;
  if (std::scanf("%d %d %d %d %d %d %d", &in.C, &in.M, &in.WN, &in.cap,
                 &in.n_steps, &in.NB, &in.L) != 7)
    return 2;
  in.len.resize(in.C);
  in.recs.resize(in.C * in.L);
  for (int c = 0; c < in.C; ++c) {
    if (std::scanf("%d", &in.len[c]) != 1) return 2;
    for (int p = 0; p < in.L; ++p) {
      Rec& r = in.recs[c * in.L + p];
      if (std::scanf("%d %d %d %d", &r.x, &r.y, &r.z, &r.w) != 4) return 2;
    }
  }
  in.svc.resize(6 * in.n_steps);
  for (int& v : in.svc)
    if (std::scanf("%d", &v) != 1) return 2;
  if (argc > 1 && !std::strcmp(argv[1], "fast")) {
    if (in.C > 32 || in.WN > 32) return 3;
    return run<FastCtl<ArraySrc>>(in);
  }
  return run<Ctl<ArraySrc>>(in);
}
"""


@pytest.fixture(scope="module")
def host_ctl(tmp_path_factory):
    """The host program above, built with the host compiler."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on PATH to build window_ctl.cuh as host C++")
    d = tmp_path_factory.mktemp("window_ctl")
    (d / "main.cc").write_text(_MAIN)
    exe = d / "window_ctl_host"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Werror",
                    "-ffp-contract=off", f"-I{INCLUDE}", "-o", str(exe),
                    str(d / "main.cc")], check=True, timeout=300)
    return exe


def _grid(points, mshr):
    grid = []
    for kind, ctrl, win, two, pol in points:
        kw = {"dram": D2} if two else {}
        grid.append(sim.SimConfig(mech=sim.MechanismConfig(kind=kind),
                                  controller=ctrl, window=win, policy=pol,
                                  mshr=mshr, **kw))
    return grid


def _plain_run(group: str):
    """The plain engine over the group's launch, step by step: per point
    its admissions, its services and the staged inputs of the host
    program."""
    C, n_req, mshr, points = GROUPS[group]
    batch = traces.multicore_batch([NAMES[c % len(NAMES)] for c in range(C)],
                                   n_req, seed=C + mshr)
    if mshr == 2:
        # one cycle between a core's requests: the MSHR slot's occupant
        # completes after the next request's gap, so its completion
        # sets the issue time right after an admission
        batch = batch._replace(gap=np.ones_like(batch.gap))
    grid = _grid(points, mshr)
    shape, p, trace, ns, ns_idx, warmup, n_steps = sim._stage(
        batch, grid, torch.device("cpu"))
    G = len(grid)
    W = max(cfg.window for cfg in grid if cfg.controller == "frfcfs")
    ws = engine._init_window(shape, G, C, W)
    # invalid slots' sequence is never read; -1 marks a slot never used
    ws.w_seq.fill_(-1)
    step = engine._make_window_step(shape, W, p, trace, ns, ns_idx, warmup)
    adm = [[] for _ in range(G)]
    svc = [np.zeros((n_steps, 6), dtype=np.int64) for _ in range(G)]
    sel = [[] for _ in range(G)]
    for s in range(n_steps):
        seq0 = ws.seq.clone()
        valid0 = ws.w_valid.clone()
        step(ws, s)
        st = ws.sim
        for g in range(G):
            new = torch.zeros_like(valid0[g])
            for q in range(int(seq0[g]), int(ws.seq[g])):
                j = int(torch.nonzero(ws.w_seq[g] == q)[0, 0])
                new[j] = True
                adm[g].append((s, int(ws.w_core[g, j]), int(ws.w_idx[g, j]),
                               int(ws.w_arr[g, j]), j, q))
            gone = torch.nonzero((valid0[g] | new) & ~ws.w_valid[g])
            if len(gone):
                e = int(gone[0, 0])
                c, i = int(ws.w_core[g, e]), int(ws.w_idx[g, e])
                svc[g][s] = (1, c, i, int(st.mshr_ring[g, c, i % mshr]),
                             int(st.open_row[g, ws.w_bank[g, e]]),
                             int(ws.now[g]))
                sel[g].append((s, e, c, i))
    geom = p.geom
    length = trace["length"].numpy()
    L = int(length.max()) + 2
    inputs = []
    for g in range(G):
        nb, nr = int(geom.banks_total[g]), int(geom.n_rows[g])
        rows = []
        for c in range(C):
            recs = np.zeros((L, 4), dtype=np.int64)
            n = int(length[c])
            ix = np.arange(n)
            recs[:n, 0] = trace["gap"][c, :n].numpy()
            recs[:n, 1] = np.mod(trace["row"][c, :n].numpy(), nr)
            recs[:n, 2] = np.mod(trace["bank"][c, :n].numpy(), nb)
            recs[:n, 3] = (trace["is_write"][c, :n].numpy().astype(int)
                           | trace["dep"][c, :n].numpy().astype(int) << 1
                           | ns[int(ns_idx[g]), c, ix].numpy().astype(int)
                           << 2)
            rows.append(f"{n} " + " ".join(map(str, recs.ravel())))
        cap = int(p.win_cap[g])
        head = (f"{C} {mshr} {W} {cap} {n_steps} "
                f"{shape.envelope.max_banks_total} {L}")
        inputs.append("\n".join([head, *rows,
                                 " ".join(map(str, svc[g].ravel()))]))
    return {"adm": adm, "sel": sel, "inputs": inputs,
            "dep": bool(trace["dep"].any())}


@pytest.fixture(scope="module")
def plain_runs():
    cache = {}

    def get(group):
        if group not in cache:
            cache[group] = _plain_run(group)
        return cache[group]
    return get


@pytest.mark.parametrize("group,point,ctl", CASES)
def test_controller_header_matches_plain_engine(host_ctl, plain_runs, group,
                                                point, ctl):
    run = plain_runs(group)
    out = subprocess.run([str(host_ctl), ctl], input=run["inputs"][point],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split("\n")
    adm = [tuple(map(int, ln.split()[1:])) for ln in out
           if ln.startswith("A ")]
    sel = [tuple(map(int, ln.split()[1:])) for ln in out
           if ln.startswith("S ")]
    errors, steps = map(int, next(ln for ln in out
                                  if ln.startswith("E ")).split()[1:])
    want_adm, want_sel = run["adm"][point], run["sel"][point]
    assert errors == 0
    assert adm == want_adm
    assert sel == want_sel
    # every request went through: as many admissions and selections as
    # requests, and the streams hold dependent requests
    assert len(want_adm) == len(want_sel) == steps
    assert run["dep"]


def test_cases_reorder_and_fill_past_one_warp(plain_runs):
    """The cases are discriminative: an FR-FCFS window serves out of
    admission order, and the 40-deep windows use slots past 32."""
    run = plain_runs("8c_mshr4")
    w16 = run["sel"][2]
    order = [q for (_, j, c, i) in w16
             for (_, c2, i2, _, _, q) in run["adm"][2] if (c2, i2) == (c, i)]
    assert order != sorted(order)
    run40 = plain_runs("40c_mshr4")
    assert max(j for (_, _, _, _, j, _) in run40["adm"][2]) >= 32
