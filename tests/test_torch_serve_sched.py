"""The serving entry's scheduler warp (``kernels/include/serve_sched.cuh``)
built as host C++, against the port's plain serving engine on the CPU.

The header is the code the scheduler warp of ``sim_step.cu``'s serving
entry runs: admission, preemption, arrivals and retirement across a
warp's lanes, and the ordered list of each step's page accesses.  Built by
``g++`` its lane abstraction is a sequential emulation of the 32 lanes
(ballot, shuffle, reduce and scan as loops), so the same text runs here.
A small host program feeds it a point's packed serving row (``kernel.
pack_serve``) and pinned arrival counts, and takes the records through a
sink that checks their order (per step the header's counts, then
prefill, probe and decode records, accesses ``4`` cycles apart from the
step's clock, each request's pages in order) and keeps each access's
arrival time, hot-table key, bank, row and direction.

Held against ``sweep_serving(device="cpu")`` on the same pinned counts:
the per-step occupancy, queue length and arrivals, the eight scheduler
counters (all of ``SERVE_STAT_KEYS`` but ``admit_hot``, which the hot
table's chain counts), the measured page accesses (the DRAM simulator's
``n_req``), and the whole stream of page accesses, in order, as the
plain engine hands them to the hot table's inserts and to the DRAM
service.  Exact.  At the scale streams' geometry (32
slots, a 128-entry queue, 32 arrivals a step) and at 48 slots, a
200-entry queue and 48 arrivals (past one warp), under every policy; the
pinned counts fill the queue (drops), keep it past the preemption
threshold, then drain it.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import simulator as sim
from repro_torch.kernels.sim_step import kernel
from repro_torch.serving.loop import engine
from repro_torch.serving.loop.spec import ServingSpec
from repro_torch.workloads.arrivals import ArrivalConfig

INCLUDE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "kernels" / "include")
POLICIES = ("fifo", "charge_aware", "preempting")
#: (slots, queue, arrivals a step, tokens a KV page, steps)
GEOMETRIES = {"32x128": (32, 128, 32, 2048, 48),
              "48x200": (48, 200, 48, 3, 40)}
#: the host program's input, after the sizes: these packed serving fields
FIELDS = ("seed", "prompt_lo", "prompt_hi", "decode_lo", "decode_hi",
          "n_reqs", "cycles_per_step", "warmup", "preempting_q_thresh",
          "preempting_enable", "charge_aware_enable", "hot_caching_cycles",
          "page_tokens")
#: an access: arrival cycle, hot-table key, bank, row, write
ACCESS = ("t_arr", "gid", "bank", "row", "write")

_MAIN = r"""
#include <cstdio>
#include <vector>
#include "serve_sched.cuh"
using namespace sched;

// Takes a step's records and checks their order: the header's counts,
// prefill writes arrival-major (rids consecutive, pages from 0), probes,
// then decode reads; accesses at t + 4 cnt.
struct CheckSink {
  int banks_total = 1, n_rows = 1;
  std::vector<int> acc;  // t_arr, gid, bank, row, write of each access
  int t = 0, n[3] = {0, 0, 0}, seen[3] = {0, 0, 0}, kind = 0, cnt = 0;
  int last_rid = -1, last_k = -1;
  bool measure = false;
  long measured = 0;
  int errors = 0;
  void header(const Warp&, int t_, int n_pre, int n_probe, int n_dec,
              bool m) {
    done();
    t = t_;
    n[0] = n_pre;
    n[1] = n_probe;
    n[2] = n_dec;
    seen[0] = seen[1] = seen[2] = 0;
    kind = cnt = 0;
    last_rid = last_k = -1;
    measure = m;
    if (m) measured += n_pre + n_dec;
  }
  void reserve(const Warp&, int) {}
  void put(int, int rid, int k, int kd, int t_arr) {
    errors += kd < kind;  // kinds in order
    if (kd != kind) last_rid = last_k = -1;
    kind = kd;
    ++seen[kd];
    if (kd == K_PROBE) {
      errors += t_arr != t;
    } else {
      errors += t_arr != wadd(t, wmul(4, cnt));
      ++cnt;
      const unsigned r = (unsigned)rid, kk = (unsigned)k;
      acc.insert(acc.end(), {t_arr, page_gid(rid, k),
                             (int)(hash_w3(r, kk, lane_const(P_BANK)) %
                                   (unsigned)banks_total),
                             (int)(hash_w3(r, kk, lane_const(P_ROW)) %
                                   (unsigned)n_rows),
                             kd == K_PREFILL});
    }
    // a request's pages in order from 0, each request once
    const bool next_page = rid == last_rid && k == last_k + 1;
    const bool new_req = rid != last_rid && k == 0;
    errors += !(next_page || new_req);
    if (kd == K_PREFILL) errors += new_req && last_rid >= 0 &&
                                   rid != last_rid + 1;
    last_rid = rid;
    last_k = k;
  }
  void advance(int) {}
  void done() {
    for (int i = 0; i < 3; ++i) errors += seen[i] != n[i];
  }
};

int main() {
  int SB, Q, A, Pp, Pt, n_steps, banks_total, n_rows;
  int seed, p_lo, p_hi, d_lo, d_hi, n_reqs, cps, warmup, q_thresh, pre_en,
      ca_en, caching, ptok;
  if (std::scanf("%d %d %d %d %d %d %d %d", &SB, &Q, &A, &Pp, &Pt, &n_steps,
                 &banks_total, &n_rows) != 8)
    return 2;
  if (std::scanf("%d %d %d %d %d %d %d %d %d %d %d %d %d", &seed, &p_lo,
                 &p_hi, &d_lo, &d_hi, &n_reqs, &cps, &warmup, &q_thresh,
                 &pre_en, &ca_en, &caching, &ptok) != 13)
    return 2;
  std::vector<int> ints(4 * SB + 6 * Q);
  std::vector<float> score(Q);
  int* b = ints.data();
  Sched<CheckSink> sc;
  sc.p = Params{(unsigned)seed, p_lo, p_hi, d_lo, d_hi, n_reqs, cps, warmup,
                q_thresh, pre_en != 0, ca_en != 0 || pre_en != 0,
                fmax_nan((float)caching, 1.0f), FloorDiv::make(ptok), SB, Q,
                A, Pp, Pt};
  sc.st = State{b, b + SB, b + 2 * SB, b + 3 * SB, b + 4 * SB,
                b + 4 * SB + Q, b + 4 * SB + 2 * Q, b + 4 * SB + 3 * Q,
                b + 4 * SB + 4 * Q, b + 4 * SB + 5 * Q, score.data()};
  sc.reset(0, 1);
  const Warp w{};
  CheckSink sink;
  sink.banks_total = banks_total;
  sink.n_rows = n_rows;
  for (int s = 0; s < n_steps; ++s) {
    int drawn;
    if (std::scanf("%d", &drawn) != 1) return 2;
    const StepOut o = sc.step(w, sink, s, drawn);
    std::printf("%d %d %d\n", o.occ, o.qlen, o.n_new);
  }
  sink.done();
  for (int i = 0; i < N_SERVE_STATS; ++i) std::printf("%d ", (int)sc.sv[i]);
  std::printf("\n%ld %d %d\n", sink.measured, sink.errors,
              (int)sink.acc.size() / 5);
  for (size_t i = 0; i < sink.acc.size(); ++i)
    std::printf("%d%c", sink.acc[i], i % 5 == 4 ? '\n' : ' ');
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_sched(tmp_path_factory):
    """The host program above, built with the host compiler."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on PATH to build serve_sched.cuh as host C++")
    d = tmp_path_factory.mktemp("serve_sched")
    (d / "main.cc").write_text(_MAIN)
    exe = d / "serve_sched_host"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Werror",
                    "-ffp-contract=off", f"-I{INCLUDE}", "-o", str(exe),
                    str(d / "main.cc")], check=True, timeout=300)
    return exe


def _grid(geometry: str):
    SB, Q, A, ptok, n_steps = GEOMETRIES[geometry]
    arr = ArrivalConfig(rate=8.0, burstiness=2.0, prompt_pages_min=1,
                        prompt_pages_max=2, decode_min=4, decode_max=8,
                        seed=11)
    return [sim.SimConfig(
        mech=sim.MechanismConfig(kind="chargecache"),
        serving=ServingSpec(
            policy=p, arrival=arr, n_reqs=10_000, max_batch=SB, queue_cap=Q,
            arrivals_max=A, n_steps=n_steps, cycles_per_step=4000,
            page_tokens=ptok, hot_entries=1024, hot_ways=2,
            hot_caching_ms=0.05, hot_exact=True))
        for p in POLICIES]


def _counts(geometry: str) -> np.ndarray:
    """A burst that fills the queue and drops, then fewer arrivals than
    the slots retire, so the queue drains past the preemption threshold."""
    SB, _, A, _, n_steps = GEOMETRIES[geometry]
    rng = np.random.default_rng(1)
    burst = n_steps // 4
    return np.concatenate([rng.integers(SB // 3, A + 8, burst),
                           rng.integers(0, SB // 4 + 1, n_steps - burst)]
                          ).astype(np.int32)


def _recorded_accesses(grid, counts):
    """The plain engine's results on pinned counts, and each point's page
    accesses ``[n, len(ACCESS)]`` in the order its hot-table inserts and
    DRAM services ran them."""
    calls, in_service = [], [False]
    service, insert = engine.sim_mod._service, engine.hcl.insert

    def rec_insert(shape, st, gids, t, en, p):
        if not in_service[0]:  # the hot table's, not the DRAM HCRAC's
            calls.append([gids.clone()])
        return insert(shape, st, gids, t, en, p)

    def rec_service(shape, mech, st, t_arr, banks, rows, wr, ns, meas, en):
        calls[-1] += [t_arr.clone(), banks.clone(), rows.clone(),
                      wr.clone(), en.clone()]
        in_service[0] = True
        try:
            return service(shape, mech, st, t_arr, banks, rows, wr, ns,
                           meas, en)
        finally:
            in_service[0] = False

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine.hcl, "insert", rec_insert)
        mp.setattr(engine.sim_mod, "_service", rec_service)
        res = sim.sweep_serving(grid, counts=np.broadcast_to(
            counts, (len(grid), counts.size)), collect_steps=True,
            device="cpu")
    streams = []
    for g in range(len(grid)):
        streams.append(np.array(
            [[int(t[g]), int(gid[g]), int(b[g]), int(r[g]), int(w[g])]
             for gid, t, b, r, w, en in calls if en[g]],
            dtype=np.int64).reshape(-1, len(ACCESS)))
    return res, streams


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def plain(request):
    """``(geometry, counts, packed rows, shape, geometry rows, plain
    results, access streams)``: the plain engine over the three policies
    on pinned counts."""
    geometry = request.param
    grid, counts = _grid(geometry), _counts(geometry)
    shape, params, warm = engine.stage_serving(grid, None, False,
                                               torch.device("cpu"))
    rows = kernel.pack_serve(params, warm)
    geom = params.mech.geom
    res, streams = _recorded_accesses(grid, counts)
    return (geometry, counts, rows, shape,
            (geom.banks_total.tolist(), geom.n_rows.tolist()), res, streams)


@pytest.mark.parametrize("policy", POLICIES)
def test_scheduler_header_matches_plain_engine(host_sched, plain, policy):
    geometry, counts, rows, shape, geom, res, streams = plain
    i = POLICIES.index(policy)
    at = {f: k for k, f in enumerate(kernel.SERVE_FIELDS)}
    row = rows[i].tolist()
    feed = " ".join(map(str, (
        shape.max_batch, shape.queue_cap, shape.arrivals_max,
        shape.prompt_pages_max, shape.pages_max, shape.n_steps,
        geom[0][i], geom[1][i], *(row[at[f]] for f in FIELDS),
        *counts.tolist())))
    out = subprocess.run([str(host_sched)], input=feed, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    lines = out.strip().splitlines()
    per_step = np.array([ln.split() for ln in lines[:shape.n_steps]],
                        dtype=np.int64)
    sv = [int(x) for x in lines[shape.n_steps].split()]
    measured, errors, n_acc = map(int, lines[shape.n_steps + 1].split())
    got_acc = np.array([ln.split() for ln in lines[shape.n_steps + 2:]],
                       dtype=np.int64).reshape(n_acc, len(ACCESS))
    want = res[i]
    assert errors == 0, "the step's records are out of order"
    for col, key in enumerate(("occ", "qlen", "arrivals")):
        np.testing.assert_array_equal(per_step[:, col], want["steps"][key],
                                      err_msg=f"{geometry}/{policy} {key}")
    for key, got in zip(engine.SERVE_STAT_KEYS, sv):
        if key != "admit_hot":
            assert got == want[key], (geometry, policy, key, got, want[key])
    assert measured == int(want["n_req"])
    np.testing.assert_array_equal(got_acc, streams[i],
                                  err_msg=f"{geometry}/{policy} accesses")
    # the case is discriminative: the queue filled and every scheduler
    # branch ran where its policy has it
    assert want["dropped"] > 0 and want["admitted"] > 0
    assert want["retired"] > 0 and want["admit_probes"] > 0
    assert (want["preempted"] > 0) == (policy == "preempting")
