// sim_step.cu — the DRAM simulator scan as a CUDA kernel, over a trace,
// over streams it synthesises itself, or driven by the serving closed loop,
// and the FR-FCFS window engine over a trace or synthesised streams.
//
// Replaces repro/kernels/sim_step/kernel.py::grid_step_call (the Pallas
// grid launcher, reached from ops.py::_sweep_pallas), which runs one
// sweep point's whole in-order request scan (simulator._run_impl) per
// grid step.  Here each sweep point is one thread block of two warps.
// The point's whole state (cores, MSHR rings, banks, buses, the padded
// HCRAC table, its copy of the packed params) lives in shared memory,
// sized by the envelope; the trace arrays and the per-geometry next_same
// tables are read from global memory (a few MB, resident in L2) and
// shared by every block.
//
// What bounds it: not bytes and not operations, but a serial dependency
// chain of n_steps requests per block.  A request's arrival depends on
// the previous one's completion (its core's issue time), and its service
// reads the bank, bus and HCRAC state the previous one wrote.  G blocks
// run side by side on the 132 SMs, so a sweep takes about as long as one
// point's chain, whatever G is up to 132.  The design keeps that chain to
// shared-memory loads, integer adds and compare-selects:
//  - every floor division or modulo by a constant of the point (tREFI,
//    refresh groups, retention, HCRAC sets and caching duration, banks,
//    rows, banks per channel) is a multiply and a shift (FloorDiv,
//    kernels/include/floor_div.cuh), built once when the point starts;
//  - warp 1 stages each core's next requests into shared memory ahead of
//    the scan: a ring of NBUF tiles of TILE 16-byte records a core (gap,
//    row and bank folded into the point's geometry, the bank's channel,
//    write / dep / next_same flags).  No stream field is read from global
//    memory on the chain, and the scan waits on a tile's counter only
//    when a core crosses a tile boundary;
//  - warp 0 runs the scan.  Lane k owns core k (cores k, k + 32, ... past
//    32 cores) and holds its head request, its issue time and, loaded a
//    request ahead, its next record and MSHR slot in registers; the
//    earliest issue, first core on ties, is a warp min-reduce and a
//    ballot, and the record reaches lane 0 by shuffles.  Lane 0 runs the
//    service (Dram::service) and shuffles the completion time back; the
//    owner then needs only compare-selects for its next issue time;
//  - the HCRAC keeps, per entry, the index of its slot's sweep window
//    instead of its insertion time (one division a check, not two), each
//    open row's set beside it, and the 2-way table of the thesis is
//    compiled for its way count.
//
// What is left in the two scan entries: the service's own dependent chain
// (bank and HCRAC state, the refresh and leak clocks, the mechanism fold)
// and the warp's collectives, ~2 300 SM cycles a request against a
// dependent-chain bound of 170 (PERF.md section 6; NVIDIA H100 80GB HBM3,
// 700 W).
//
// The synthesis entry (sim_synth_kernel) replaces the same launcher
// reached from ops.py::_synth_pallas, which generates each point's
// request stream in-kernel (simulator._run_synth_impl) and scans it.
// Here thread c of the point's block first generates core c's stream
// (workloads/generator.py::_gen_core: counter-based hashes, the recency
// ring in shared memory) into a [G, C, L] global scratch together with
// its next_same lookahead, then the block scans it as above.  The
// pre-pass is parallel over cores and adds ~15 B per request of scratch
// traffic.
//
// The serving entry (sim_serve_kernel, below) has no Pallas counterpart:
// repro's serving loop is an XLA scan.  A point is a block of three
// warps, one a chain: the scheduler across warp 0's lanes
// (kernels/include/serve_sched.cuh) stages each step's page accesses as
// records in a shared-memory ring; warp 1 runs the hot-page table's
// inserts on lane 0 and the step's probes across its lanes; lane 0 of
// warp 2 runs the same per-request service (Dram::service, with the same
// dividers) once per access record, and nothing else.
//
// The window entry (sim_window_kernel, below) has no Pallas counterpart
// either: repro's FR-FCFS controller tier is an XLA scan.  A point is a
// block of two warps: warp 1 stages the streams as above, warp 0 runs the
// controller of kernels/include/window_ctl.cuh (issue times and slot keys
// in lane registers) and, on lane 0, the same service under the rank's
// ACT floor; an in-order point's block runs the scan instead.
//
// Semantics follow repro.core.simulator bit for bit: int32 arithmetic
// wraps (done in uint32, since signed overflow is undefined in C++),
// division and modulo are floor division and floor modulo where an
// operand can be negative, argmin/argmax ties go to the first index, and
// the thermal leak is a float32 multiply rounded half to even.
//
// Built by repro_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "floor_div.cuh"
#include "serve_sched.cuh"
#include "window_ctl.cuh"

namespace {

// the shared arithmetic and hashes (kernels/include/serve_sched.cuh)
using sched::fmax_nan;
using sched::fmin_nan;
using sched::fmix;
using sched::hash_w3;
using sched::imax;
using sched::imin;
using sched::kGold;
using sched::lane_const;
using sched::mix;
using sched::wadd;
using sched::wmul;
using sched::wsub;

constexpr int INF = 1 << 30;
constexpr int NO_ROW = -1;
constexpr int NO_TAG = -1;
constexpr int I32_MAX = 0x7fffffff;
constexpr int MS8_CYCLES = 6400000;  // ms_to_cycles(8.0)
constexpr int N_STATS = 16;          // simulator.STAT_KEYS, in order

// Field indices of the packed per-point int32 param row.  Their offsets
// are computed in kernel.py and passed in (Layout); the names, in this
// order, are exported by sim_step_abi() and checked by kernel.py.
enum Field {
  F_tRCD, F_tRAS, F_tRP, F_tCL, F_tCWL, F_tBL, F_tRTP, F_tWR, F_tREFI,
  F_tRFC, F_GROUPS, F_RETENTION,
  F_BANKS_TOTAL, F_BANKS_PER_CH, F_N_ROWS,
  F_CLOSED, F_STATEFUL, F_HC_GATE, F_HC_SETS, F_HC_CACHING, F_HC_PERIOD,
  F_NS_IDX,
  F_LL_EN, F_LL_RCD, F_LL_RAS,
  F_CC_EN, F_CC_RCD, F_CC_RAS,
  F_NUAT_EN, F_NUAT_EDGE, F_NUAT_RCD, F_NUAT_RAS,
  F_RLTL_EN, F_RLTL_WINDOW, F_RLTL_RCD, F_RLTL_RAS,
  F_AL_EN, F_AL_DRIFT, F_AL_RCD, F_AL_RAS, F_AL_SEG_RCD, F_AL_SEG_RAS,
  F_TH_EN, F_TH_EDGE,
  N_FIELDS
};

// The window entry's own fields, after those in the packed row.  They
// and its window depth travel in parameters of its own (WinLayout, WIN),
// so the other entries' kernel parameters stay as they were.
enum WinField { F_tRRD, F_tFAW, F_N_BANKS, F_FRFCFS, F_WIN_CAP, N_WIN_FIELDS };

const char* const kAbi =
    "fields:tRCD,tRAS,tRP,tCL,tCWL,tBL,tRTP,tWR,tREFI,tRFC,"
    "n_refresh_groups,retention_cycles,banks_total,banks_per_channel,"
    "n_rows,closed_policy,refresh_stateful,hc_gate,hc_n_sets,"
    "hc_caching_cycles,hc_sweep_period,ns_idx,ll_enable,ll_tRCD,ll_tRAS,"
    "cc_enable,cc_tRCD,cc_tRAS,nuat_enable,nuat_edge,nuat_rcd,nuat_ras,"
    "rltl_enable,rltl_window,rltl_tRCD,rltl_tRAS,al_enable,al_drift,al_rcd,"
    "al_ras,al_seg_rcd,al_seg_ras,th_enable,th_seg_edge,tRRD,tFAW,n_banks,"
    "frfcfs,win_cap;"
    "dims:G,C,L,NB,NCH,HS,W,M,NBINS,S,P,n_steps,warmup,collect,exact,"
    "SW,PI,PF,WIN;"
    "synth_int:seed,core_idx,n_cores,length,hot_rows,n_hot_banks,seg_edge,"
    "il_kind_id,il_block_rows,n_channels,warmup;"
    "synth_float:mean_gap,p_rowhit,p_hot,p_seq,p_dep,p_write,stack_zipf,"
    "stack_geo";

// Static sizes of one launch, in the order of kAbi's "dims".  SW, PI and
// PF (workload segments, int and float synth row widths) are 0 for a
// trace launch.  W is the HCRAC's way count.  The last of kAbi's dims,
// WIN (the FR-FCFS window depth, 0 but for the window entry), is read by
// the window entry's launcher alone.
struct Dims {
  int G, C, L, NB, NCH, HS, W, M, NBINS, S, P, n_steps, warmup, collect,
      exact, SW, PI, PF;
};

struct Layout {
  int off[N_FIELDS];
};

struct WinLayout {
  int off[N_WIN_FIELDS];
};

// Field indices of the packed per-point synthesis rows: int32 [G, PI]
// and float32 [G, PF] (per-core leaves [C], per-segment leaves [C, SW]).
// Offsets come from kernel.py (SynthLayout), names as kAbi's synth_*.
enum SynthInt {
  W_SEED, W_CORE, W_NCORES, W_LENGTH, W_HOT_ROWS, W_NHB, W_SEG_EDGE,
  W_IL_KIND, W_IL_BLOCK, W_NCH, W_WARMUP, N_SYNTH_INT
};
enum SynthFloat {
  W_MEAN_GAP, W_P_ROWHIT, W_P_HOT, W_P_SEQ, W_P_DEP, W_P_WRITE, W_ZIPF,
  W_GEO, N_SYNTH_FLOAT
};

struct SynthLayout {
  int ioff[N_SYNTH_INT];
  int foff[N_SYNTH_FLOAT];
};

constexpr int RING = 128;  // generator.RECENT_RING

// The staged stream: each core's ring of NBUF tiles of TILE records.
// A tile is what the producer warp fills in one pass, a record per lane.
constexpr int TILE = 32;
constexpr int TILE_SHIFT = 5;
constexpr int NBUF = 2;
// Threads of a trace or synthesis block: the scan warp and the producer.
constexpr int SCAN_THREADS = 64;

// Shared-memory words of the scan state; must match run_point's carve.
__host__ __device__ inline int scan_words(const Dims& d) {
  return d.P + 5 * d.C + d.C * d.M + 11 * d.NB + 2 * d.NCH +
         3 * d.HS * d.W + N_STATS + 1 + d.S;
}

// Shared-memory words of the staged stream (a multiple of 4, so what
// follows stays 16-byte aligned): the tiles, each core's head record and
// the one after it, its filled / released tile counters, and the stop
// flag.
__host__ __device__ inline int stage_words(const Dims& d) {
  return (d.C * (NBUF * TILE * 4 + 8 + 2) + 1 + 3) & ~3;
}

// Shared-memory words of a trace or synthesis block: the staged stream,
// the scan state, then (synthesis launches) the point's workload rows,
// each core's recency ring and its next_same last-row file.
__host__ __device__ inline int smem_words(const Dims& d) {
  int w = stage_words(d) + scan_words(d);
  if (d.SW > 0) w += d.PI + d.PF + d.C * (2 * RING + d.NB);
  return w;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// A shared-memory word another warp or lane writes (the staging counters)
__device__ __forceinline__ int ld_volatile(const int* p) {
  return *(const volatile int*)p;
}
__device__ __forceinline__ void st_volatile(int* p, int v) {
  *(volatile int*)p = v;
}
// ... read with acquire, written with release semantics (block scope):
// what the writer stored before the release is visible after the acquire
__device__ __forceinline__ int ld_acquire(const int* p) {
#ifdef __CUDA_ARCH__
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#endif
}
__device__ __forceinline__ void st_release(int* p, int v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.release.cta.shared::cta.b32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
#else
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
#endif
}

// The point's HCRAC: [HS, W] tables in shared memory; the set count,
// caching duration and period are the point's active values (never the
// padded shape's), the first two as dividers.  ``stamps`` holds what
// aliveness needs of an entry's insertion time t_i: t_i itself under
// exact expiry, else the index of the slot's sweep window that holds it,
// floor((t_i - phase) / C), so a check divides once.  ``WAYS`` is the way
// count when the launch fixes it at compile time (the ways' loads and
// checks then issue together), else 0 and ``W`` holds it.
template <int WAYS>
struct Hcrac {
  int* tags;
  int* stamps;
  int* lru;
  int W, period;
  FloorDiv sets, caching;
  bool exact;

  __device__ __forceinline__ int ways() const { return WAYS ? WAYS : W; }

  __device__ int stamp(int set, int way, int t) const {
    if (exact) return t;
    return caching.div(wsub(t, wmul(set * ways() + way + 1, period)));
  }

  __device__ bool alive(int set, int way, int st, int t) const {
    if (exact) return wsub(t, st) <= caching.d;
    // same sweep window <=> no invalidation of this slot in (t_i, t]
    return stamp(set, way, t) == st;
  }

  // hcrac.insert into ``set`` (gid's): the first matching way, else the
  // first invalid way, else the least recently used valid way (first on
  // ties).
  __device__ void insert(int gid, int set, int t) {
    int base = set * ways();
    int match_way = -1, inv_way = -1, lru_way = 0, lru_best = 0;
    for (int w = 0; w < ways(); ++w) {
      int tag = tags[base + w];
      bool valid = tag != NO_TAG && alive(set, w, stamps[base + w], t);
      if (valid && tag == gid && match_way < 0) match_way = w;
      if (!valid && inv_way < 0) inv_way = w;
      int key = valid ? lru[base + w] : I32_MAX;
      if (w == 0 || key < lru_best) {
        lru_best = key;
        lru_way = w;
      }
    }
    int way = match_way >= 0 ? match_way : (inv_way >= 0 ? inv_way : lru_way);
    tags[base + way] = gid;
    stamps[base + way] = stamp(set, way, t);
    lru[base + way] = t;
  }
  __device__ void insert(int gid, int t) { insert(gid, sets.mod(gid), t); }

  // The read-only probe (kernels/hcrac, serving/loop/engine._probe_many):
  // a live way holds the gid; no LRU side effect.
  __device__ bool probe(int gid, int t) const {
    int set = sets.mod(gid);
    int base = set * ways();
    for (int w = 0; w < ways(); ++w) {
      int tag = tags[base + w];
      if (tag != NO_TAG && tag == gid && alive(set, w, stamps[base + w], t))
        return true;
    }
    return false;
  }

  // hcrac.lookup in ``set`` (gid's): a hit refreshes the matching ways'
  // LRU stamps only.
  __device__ bool lookup(int gid, int set, int t) {
    int base = set * ways();
    bool hit = false;
    for (int w = 0; w < ways(); ++w) {
      int tag = tags[base + w];
      if (tag != NO_TAG && tag == gid && alive(set, w, stamps[base + w], t)) {
        lru[base + w] = t;
        hit = true;
      }
    }
    return hit;
  }
};

// dram.refresh_adjust with the row's refresh group ``rgrp`` (legacy tier)
__device__ __forceinline__ int refresh_adjust(int t, int rgrp,
                                              const FloorDiv& trefi,
                                              int tRFC,
                                              const FloorDiv& groups) {
  const int k = trefi.div(t);
  const int r = wsub(t, wmul(k, trefi.d));
  bool busy = r < tRFC && rgrp == groups.mod(k);
  return busy ? wadd(t, wsub(tRFC, r)) : t;
}

// dram.refresh_clamp_span with the row's refresh group (legacy tier)
__device__ __forceinline__ int refresh_clamp_span(int t, int span, int rgrp,
                                                  const FloorDiv& trefi,
                                                  int tRFC,
                                                  const FloorDiv& groups) {
  const int k = trefi.div(t);
  const int r = wsub(t, wmul(k, trefi.d));
  int base = wsub(t, r);
  bool in_this = r < tRFC && rgrp == groups.mod(k);
  bool into_next =
      wadd(r, span) > trefi.d && rgrp == groups.mod(wadd(k, 1));
  int fixed = in_this ? wadd(base, tRFC) : wadd(wadd(base, trefi.d), tRFC);
  return (in_this || into_next) ? fixed : t;
}

struct Trace {
  const int* gap;
  const int* bank;
  const int* row;
  const uint8_t* is_write;
  const uint8_t* dep;
  const int* length;
  const uint8_t* next_same;  // [n_geom, C, L]
};

struct Out {
  int* stats;        // [G, N_STATS]
  int* bank_stats;   // [G, 2, NB]
  int* core_end;     // [G, C]
  int* events;       // [8, G, n_steps]: act_gid, act_t, pre1_gid, pre1_t,
                     // pre2_gid, pre2_t, pre3_gid, pre3_t
  uint8_t* act_ref8; // [G, n_steps]
};

// The scan state of one point in shared memory (order must match
// scan_words).  Once the scan runs, the per-core arrays (position, stream
// length, issue time, MSHR ring index, completion, MSHR ring) are written
// by the core's owner lane alone.  The serving entry uses the state with
// one idle core.
struct Carve {
  int* prm;
  int *ptr, *len, *iss, *ring_idx, *core_end, *ring;
  int *open_row, *open_set, *ready_act, *ready_rdwr, *ready_pre,
      *last_pre_gid, *last_pre_t, *ref_k, *last_ref_t, *bank_acts, *bank_ras;
  int *cmd_free, *data_free;
  int *tags, *stamps, *lru;
  int* stats;
  int* s_end;
  float* leak;
};

__device__ __forceinline__ Carve carve(const Dims& d, int* sm) {
  const int C = d.C, NB = d.NB, NCH = d.NCH;
  Carve c;
  c.prm = sm;
  c.ptr = c.prm + d.P;
  c.len = c.ptr + C;
  c.iss = c.len + C;
  c.ring_idx = c.iss + C;
  c.core_end = c.ring_idx + C;
  c.ring = c.core_end + C;
  c.open_row = c.ring + C * d.M;
  c.open_set = c.open_row + NB;
  c.ready_act = c.open_set + NB;
  c.ready_rdwr = c.ready_act + NB;
  c.ready_pre = c.ready_rdwr + NB;
  c.last_pre_gid = c.ready_pre + NB;
  c.last_pre_t = c.last_pre_gid + NB;
  c.ref_k = c.last_pre_t + NB;
  c.last_ref_t = c.ref_k + NB;
  c.bank_acts = c.last_ref_t + NB;
  c.bank_ras = c.bank_acts + NB;
  c.cmd_free = c.bank_ras + NB;
  c.data_free = c.cmd_free + NCH;
  c.tags = c.data_free + NCH;
  c.stamps = c.tags + d.HS * d.W;
  c.lru = c.stamps + d.HS * d.W;
  c.stats = c.lru + d.HS * d.W;
  c.s_end = c.stats + N_STATS;
  c.leak = reinterpret_cast<float*>(c.s_end + 1);
  return c;
}

// Thread ``tid`` of ``nt``: copy the point's params and leak scales in
// and reset the scan state (simulator._init_state).
__device__ __forceinline__ void init_scan(const Dims& d, const Carve& c,
                                          const int* __restrict__ params,
                                          const float* __restrict__ seg_leak,
                                          int gp, int tid, int nt) {
  const int C = d.C, NB = d.NB, NCH = d.NCH, M = d.M;
  for (int i = tid; i < d.P; i += nt) c.prm[i] = params[(size_t)gp * d.P + i];
  for (int i = tid; i < 5 * C + C * M; i += nt) c.ptr[i] = 0;
  for (int i = tid; i < NB; i += nt) {
    c.open_row[i] = NO_ROW;
    c.open_set[i] = 0;
    c.ready_act[i] = 0;
    c.ready_rdwr[i] = 0;
    c.ready_pre[i] = 0;
    c.last_pre_gid[i] = -1;
    c.last_pre_t[i] = 0;
    c.ref_k[i] = 0;
    c.last_ref_t[i] = 0;
    c.bank_acts[i] = 0;
    c.bank_ras[i] = 0;
  }
  for (int i = tid; i < 2 * NCH; i += nt) c.cmd_free[i] = 0;
  for (int i = tid; i < d.HS * d.W; i += nt) {
    c.tags[i] = NO_TAG;
    c.stamps[i] = 0;
    c.lru[i] = -1;
  }
  for (int i = tid; i < N_STATS; i += nt) c.stats[i] = 0;
  for (int i = tid; i < d.S; i += nt) c.leak[i] = seg_leak[(size_t)gp * d.S + i];
  if (tid == 0) *c.s_end = d.n_steps;
}

// Thread ``tid`` of ``nt``: write the point's stats and bank arrays.
__device__ __forceinline__ void write_scan(const Dims& d, const Carve& c,
                                           int* stats, int* bank_stats,
                                           int gp, int tid, int nt) {
  for (int i = tid; i < N_STATS; i += nt)
    stats[(size_t)gp * N_STATS + i] = c.stats[i];
  for (int i = tid; i < d.NB; i += nt) {
    bank_stats[((size_t)gp * 2 + 0) * d.NB + i] = c.bank_acts[i];
    bank_stats[((size_t)gp * 2 + 1) * d.NB + i] = c.bank_ras[i];
  }
}

// simulator.STAT_KEYS, in order: lane 0's accumulators
enum { N_REQ, LAT_SUM, ACTS, ACTS_LOWERED, HC_HITS, HC_LOOKUPS, ROW_HITS,
       ROW_CLOSED, ROW_CONFLICTS, READS, WRITES, PRES, ACT_RAS_SUM,
       REF8_ACTS, REFS_ISSUED, REF_BLOCKED };

// One request's event record (simulator.Events): a gid of -1 means none.
struct Ev {
  int act_gid, act_t, pre1_gid, pre1_t, pre2_gid, pre2_t, pre3_gid, pre3_t;
  bool ref8;
};

// A point's DRAM system on lane 0: its params, read once from the packed
// row (its divisors as dividers), and its bank, bus and HCRAC state in
// shared memory.  ``service`` is simulator._service for one live request.
// Neither it nor Hcrac uses a warp collective: the serving entry calls
// the service from one lane and the inserts from another, alone.
template <int WAYS>
struct Dram {
  int tRCD, tRAS, tRP, tCL, tCWL, tBL, tRTP, tWR, tREFI, tRFC;
  int banks_total, n_rows;
  FloorDiv trefi, groups, retention, bpc;
  bool closed, stateful, hc_gate;
  bool ll_en, cc_en, nuat_en, rltl_en, al_en, al_drift, th_en;
  int ll_rcd, ll_ras, cc_rcd, cc_ras, rltl_window, rltl_rcd, rltl_ras;
  const int *nuat_edge, *nuat_rcd, *nuat_ras;
  const int *al_rcd, *al_ras, *al_seg_rcd, *al_seg_ras, *th_edge;
  int NB, NBINS, S;
  Carve c;
  Hcrac<WAYS> hc;

  __device__ __forceinline__ Dram(const Dims& d, const Layout& lay,
                                  const Carve& cv)
      : c(cv) {
    const int* prm = cv.prm;
    const int* off = lay.off;
    tRCD = prm[off[F_tRCD]];
    tRAS = prm[off[F_tRAS]];
    tRP = prm[off[F_tRP]];
    tCL = prm[off[F_tCL]];
    tCWL = prm[off[F_tCWL]];
    tBL = prm[off[F_tBL]];
    tRTP = prm[off[F_tRTP]];
    tWR = prm[off[F_tWR]];
    trefi = FloorDiv::make(prm[off[F_tREFI]]);
    tREFI = trefi.d;
    tRFC = prm[off[F_tRFC]];
    groups = FloorDiv::make(prm[off[F_GROUPS]]);
    retention = FloorDiv::make(prm[off[F_RETENTION]]);
    banks_total = prm[off[F_BANKS_TOTAL]];
    bpc = FloorDiv::make(prm[off[F_BANKS_PER_CH]]);
    n_rows = prm[off[F_N_ROWS]];
    closed = prm[off[F_CLOSED]] != 0;
    stateful = prm[off[F_STATEFUL]] != 0;
    hc_gate = prm[off[F_HC_GATE]] != 0;
    ll_en = prm[off[F_LL_EN]] != 0;
    ll_rcd = prm[off[F_LL_RCD]];
    ll_ras = prm[off[F_LL_RAS]];
    cc_en = prm[off[F_CC_EN]] != 0;
    cc_rcd = prm[off[F_CC_RCD]];
    cc_ras = prm[off[F_CC_RAS]];
    nuat_en = prm[off[F_NUAT_EN]] != 0;
    nuat_edge = prm + off[F_NUAT_EDGE];
    nuat_rcd = prm + off[F_NUAT_RCD];
    nuat_ras = prm + off[F_NUAT_RAS];
    rltl_en = prm[off[F_RLTL_EN]] != 0;
    rltl_window = prm[off[F_RLTL_WINDOW]];
    rltl_rcd = prm[off[F_RLTL_RCD]];
    rltl_ras = prm[off[F_RLTL_RAS]];
    al_en = prm[off[F_AL_EN]] != 0;
    al_drift = prm[off[F_AL_DRIFT]] != 0;
    al_rcd = prm + off[F_AL_RCD];
    al_ras = prm + off[F_AL_RAS];
    al_seg_rcd = prm + off[F_AL_SEG_RCD];
    al_seg_ras = prm + off[F_AL_SEG_RAS];
    th_en = prm[off[F_TH_EN]] != 0;
    th_edge = prm + off[F_TH_EDGE];
    NB = d.NB;
    NBINS = d.NBINS;
    S = d.S;
    hc = Hcrac<WAYS>{cv.tags, cv.stamps, cv.lru, d.W, prm[off[F_HC_PERIOD]],
               FloorDiv::make(prm[off[F_HC_SETS]]),
               FloorDiv::make(prm[off[F_HC_CACHING]]), d.exact != 0};
  }

  // Serve one live request arriving at ``t_arr`` (the bank and row
  // already folded, ``ch`` the bank's channel, ``set`` the HCRAC set of
  // its row); updates the state, adds to ``acc`` and ``ev`` and returns
  // its completion time.  ``FLOOR`` is the FR-FCFS tier's rank window
  // (the window entry's alone; the other entries compile it away): an
  // ACT issues no earlier than ``act_floor``, and the ACT's cycle and
  // whether there was one go to ``t_act_out`` / ``needs_out``.
  template <bool FLOOR = false>
  __device__ __forceinline__ int service(int t_arr, int bank, int ch,
                                         int row, int set, bool is_write,
                                         bool ns, bool measure,
                                         unsigned* acc, Ev& ev,
                                         int act_floor = 0,
                                         int* t_act_out = nullptr,
                                         bool* needs_out = nullptr) {
    const unsigned m = measure ? 1u : 0u;
    const bool legacy = !stateful;
    const int rgrp = groups.mod(row);
    const int t0 = imax(t_arr, c.cmd_free[ch]);

    // rolling refresh: catch the bank's REF counter up (stateful tier)
    const int ref_due = wadd(trefi.div(t0), 1);
    const int n_pend = imax(wsub(ref_due, c.ref_k[bank]), 0);
    const bool do_ref = stateful && n_pend > 0;
    const int busy0 =
        imax(imax(c.ready_act[bank], c.ready_pre[bank]), c.ready_rdwr[bank]);
    const int ref_t = imax(wmul(wsub(ref_due, 1), tREFI), c.ready_pre[bank]);
    const int ref_done = wadd(ref_t, tRFC);
    const int openr0 = c.open_row[bank];
    const int open_set = c.open_set[bank];  // the open row's HCRAC set
    const bool ref_pre = do_ref && openr0 != NO_ROW;
    const int openr = do_ref ? NO_ROW : openr0;
    const int r_act_b = do_ref ? imax(c.ready_act[bank], ref_done)
                               : c.ready_act[bank];
    const int r_pre_b = do_ref ? imax(c.ready_pre[bank], ref_done)
                               : c.ready_pre[bank];
    const int r_rdwr_b = do_ref ? imax(c.ready_rdwr[bank], ref_done)
                                : c.ready_rdwr[bank];
    const int gid_ref = wadd(wmul(bank, n_rows), ref_pre ? openr0 : 0);
    if (ref_pre && hc_gate) hc.insert(gid_ref, open_set, ref_t);

    const bool is_hit = openr == row;
    const bool is_closed = openr == NO_ROW;
    const bool is_conflict = !is_hit && !is_closed;

    // conflict path: PRE the open row (insert it into the HCRAC)
    int t_pre = imax(t0, r_pre_b);
    if (legacy) t_pre = refresh_adjust(t_pre, rgrp, trefi, tRFC, groups);
    const int gid_old = wadd(wmul(bank, n_rows), is_conflict ? openr : 0);
    if (is_conflict && hc_gate) hc.insert(gid_old, open_set, t_pre);

    // ACT
    int t_act = is_conflict ? wadd(t_pre, tRP) : imax(t0, r_act_b);
    if (legacy) t_act = refresh_adjust(t_act, rgrp, trefi, tRFC, groups);
    const bool needs_act = !is_hit;
    if constexpr (FLOOR) {
      // only a real ACT is held back; a row hit's t_act is a clock read
      if (needs_act) t_act = imax(t_act, act_floor);
      *t_act_out = t_act;
      *needs_out = needs_act;
    }
    const int gid = wadd(wmul(bank, n_rows), row);
    // the lookup runs on row hits too (LRU refresh); with the gate off
    // the table stays empty, so skipping it changes nothing
    bool cc_hit = hc_gate ? hc.lookup(gid, set, t_act) : false;
    cc_hit = cc_hit && needs_act && hc_gate;

    const int tslp =
        c.last_pre_gid[bank] == gid ? wsub(t_act, c.last_pre_t[bank]) : INF;

    // leak clock (dram.time_since_refresh / the stateful REF registers)
    const int tsr_closed = retention.mod(wsub(t_act, wmul(rgrp, tREFI)));
    const int kw = wsub(ref_due, 1);
    const int j_g = wsub(kw, groups.mod(wsub(kw, rgrp)));
    const int new_last_ref_t = do_ref ? ref_t : c.last_ref_t[bank];
    const int t_ref = j_g == kw ? new_last_ref_t : wmul(j_g, tREFI);
    const int tsr = (stateful && j_g >= 0) ? imax(wsub(t_act, t_ref), 0)
                                           : tsr_closed;
    int seg = 0;
    int tsr_eff = tsr;
    if (S > 0) {
      int cnt = 0;
      for (int i = 0; i < S; ++i) cnt += t_act >= th_edge[i];
      seg = imin(imax(cnt - 1, 0), S - 1);
      if (th_en) tsr_eff = __float2int_rn(__fmul_rn((float)tsr, c.leak[seg]));
    }

    // mechanism fold, registration order: lldram, chargecache, nuat,
    // rltl, aldram
    int rcd = tRCD, ras = tRAS;
    if (ll_en) {
      rcd = ll_rcd;
      ras = ll_ras;
    }
    if (cc_hit && cc_en) {
      rcd = cc_rcd;
      ras = cc_ras;
    }
    if (nuat_en) {
      int n_rcd = tRCD, n_ras = tRAS;
      for (int i = NBINS - 1; i >= 0; --i) {
        if (tsr_eff < nuat_edge[i]) {
          n_rcd = nuat_rcd[i];
          n_ras = nuat_ras[i];
        }
      }
      rcd = imin(rcd, n_rcd);
      ras = imin(ras, n_ras);
    }
    if (rltl_en && needs_act && tslp < rltl_window) {
      rcd = imin(rcd, rltl_rcd);
      ras = imin(ras, rltl_ras);
    }
    if (al_en) {
      int b_rcd = al_rcd[bank], b_ras = al_ras[bank];
      if (S > 0 && al_drift) {
        b_rcd = al_seg_rcd[seg * NB + bank];
        b_ras = al_seg_ras[seg * NB + bank];
      }
      rcd = imin(rcd, b_rcd);
      ras = imin(ras, b_ras);
    }
    const bool lowered_used = needs_act && (rcd < tRCD || ras < tRAS);

    // READ / WRITE
    int t_rdwr = is_hit ? imax(t0, r_rdwr_b) : wadd(t_act, rcd);
    const int cas = is_write ? tCWL : tCL;
    t_rdwr = imax(t_rdwr, wsub(c.data_free[ch], cas));
    if (legacy)
      t_rdwr = refresh_clamp_span(t_rdwr, wadd(cas, tBL), rgrp, trefi, tRFC,
                                  groups);
    const int done = wadd(wadd(t_rdwr, cas), tBL);

    // bank state updates
    const int new_ready_rdwr = needs_act ? wadd(t_act, rcd) : r_rdwr_b;
    const int after_rw = is_write ? wadd(done, tWR) : wadd(t_rdwr, tRTP);
    const int new_ready_pre =
        imax(needs_act ? wadd(t_act, ras) : r_pre_b, after_rw);
    const bool auto_pre = closed && !ns;
    const int t_autopre = new_ready_pre;
    if (auto_pre && hc_gate) hc.insert(gid, set, t_autopre);
    const int new_open = auto_pre ? NO_ROW : row;
    const int new_ready_act =
        auto_pre ? wadd(t_autopre, tRP)
                 : (is_conflict ? wadd(t_pre, tRP) : r_act_b);
    const int n_cmds = 1 + (int)needs_act + (int)is_conflict + (int)auto_pre;
    const int new_cmd_free = wadd(imax(c.cmd_free[ch], t_arr), n_cmds);

    const int lp_gid0 = ref_pre ? gid_ref : c.last_pre_gid[bank];
    const int lp_t0 = ref_pre ? ref_t : c.last_pre_t[bank];
    const int new_lp_gid = auto_pre ? gid : (is_conflict ? gid_old : lp_gid0);
    const int new_lp_t = auto_pre ? t_autopre : (is_conflict ? t_pre : lp_t0);

    // stats
    const unsigned a = m * (unsigned)needs_act;
    const bool ref8 = needs_act && measure && tsr < MS8_CYCLES;
    acc[N_REQ] += m;
    acc[LAT_SUM] += m * (unsigned)wsub(done, t_arr);
    acc[ACTS] += a;
    acc[ACTS_LOWERED] += m * (unsigned)lowered_used;
    acc[HC_LOOKUPS] += m * (unsigned)(needs_act && hc_gate);
    acc[HC_HITS] += m * (unsigned)cc_hit;
    acc[ROW_HITS] += m * (unsigned)is_hit;
    acc[ROW_CLOSED] += m * (unsigned)is_closed;
    acc[ROW_CONFLICTS] += m * (unsigned)is_conflict;
    acc[READS] += m * (unsigned)!is_write;
    acc[WRITES] += m * (unsigned)is_write;
    acc[PRES] += m * ((unsigned)is_conflict + (unsigned)auto_pre);
    acc[ACT_RAS_SUM] += a * (unsigned)ras;
    acc[REF8_ACTS] += (unsigned)ref8;
    acc[REFS_ISSUED] += m * (unsigned)stateful * (unsigned)n_pend;
    if (do_ref && measure)
      acc[REF_BLOCKED] += (unsigned)imax(wsub(ref_done, imax(t0, busy0)), 0);
    c.bank_acts[bank] = (int)((unsigned)c.bank_acts[bank] + a);
    c.bank_ras[bank] = (int)((unsigned)c.bank_ras[bank] + a * (unsigned)ras);

    ev.act_gid = (needs_act && measure) ? gid : -1;
    ev.act_t = t_act;
    ev.pre1_gid = is_conflict ? gid_old : -1;
    ev.pre1_t = t_pre;
    ev.pre2_gid = auto_pre ? gid : -1;
    ev.pre2_t = t_autopre;
    ev.pre3_gid = ref_pre ? gid_ref : -1;
    ev.pre3_t = ref_t;
    ev.ref8 = ref8;

    // state writes
    c.open_row[bank] = new_open;
    c.open_set[bank] = set;
    c.ready_act[bank] = new_ready_act;
    c.ready_rdwr[bank] = new_ready_rdwr;
    c.ready_pre[bank] = new_ready_pre;
    c.last_pre_gid[bank] = new_lp_gid;
    c.last_pre_t[bank] = new_lp_t;
    if (do_ref) c.ref_k[bank] = ref_due;
    c.last_ref_t[bank] = new_last_ref_t;
    c.cmd_free[ch] = new_cmd_free;
    c.data_free[ch] = done;
    return done;
  }
};

// The staged stream of one point in shared memory (stage_words): core
// c's tile j, positions [j TILE, (j + 1) TILE), lives in buffer j % NBUF.
struct Stage {
  int4* tiles;    // [C, NBUF, TILE] records
  int4* head;     // [C] each core's head record (past 32 cores)
  int4* next;     // [C] the record after it (past 32 cores)
  int* filled;    // [C] tiles the producer has written (warp 1 writes)
  int* released;  // [C] tiles the scan is done with (owner lanes write)
  int* stop;      // set by the scan when it ends
};

__device__ __forceinline__ Stage stage_carve(const Dims& d, int* sm) {
  Stage g;
  g.tiles = reinterpret_cast<int4*>(sm);
  g.head = g.tiles + d.C * NBUF * TILE;
  g.next = g.head + d.C;
  g.filled = reinterpret_cast<int*>(g.next + d.C);
  g.released = g.filled + d.C;
  g.stop = g.released + d.C;
  return g;
}

// A bank and an HCRAC set share a record's word
__host__ __device__ inline bool record_fits(const Dims& d) {
  return d.NB <= 0xffff && d.HS <= 0x7fff;
}

// A staged record: x the gap, y the row folded into the point's
// geometry, z the folded bank (low 16 bits) and the HCRAC set of its row
// (high), w the flags below and the bank's channel above them.
enum { R_WRITE = 1, R_DEP = 2, R_NS = 4, R_CH_SHIFT = 3 };

// The producer's view of a point's stream: the stream arrays, the point's
// next_same table and the dividers that fold a request into its geometry.
struct Feed {
  Trace tr;
  const uint8_t* ns;
  int L, n_rows;
  FloorDiv banks, rows, bpc, sets;

  __device__ Feed(const Dims& d, const Layout& lay, const Carve& cv,
                  const Trace& t)
      : tr(t), L(d.L) {
    const int* prm = cv.prm;
    const int* off = lay.off;
    ns = t.next_same + (size_t)prm[off[F_NS_IDX]] * d.C * d.L;
    banks = FloorDiv::make(prm[off[F_BANKS_TOTAL]]);
    rows = FloorDiv::make(prm[off[F_N_ROWS]]);
    bpc = FloorDiv::make(prm[off[F_BANKS_PER_CH]]);
    sets = FloorDiv::make(prm[off[F_HC_SETS]]);
    n_rows = rows.d;
  }

  // Core k's record at position p (clipped to the stream's last
  // position, as the engines clip a read past the end).
  __device__ int4 record(int k, int p) const {
    const size_t ix = (size_t)k * L + imin(p, L - 1);
    const int bank = banks.mod(tr.bank[ix]);
    const int row = rows.mod(tr.row[ix]);
    int4 r;
    r.x = tr.gap[ix];
    r.y = row;
    r.z = bank | sets.mod(wadd(wmul(bank, n_rows), row)) << 16;
    r.w = (bpc.div(bank) << R_CH_SHIFT) | (ns[ix] ? R_NS : 0) |
          (tr.dep[ix] ? R_DEP : 0) | (tr.is_write[ix] ? R_WRITE : 0);
    return r;
  }

  // Lane ``lane``'s record of core k's tile j; positions at or past the
  // stream's length ``len`` are never read and stay unwritten.
  __device__ void fill(const Stage& g, int k, int j, int len,
                       int lane) const {
    const int p = j * TILE + lane;
    if (p >= len) return;
    g.tiles[(k * NBUF + (j & (NBUF - 1))) * TILE + lane] = record(k, p);
  }
};

// Warp 1: keep every core's ring of tiles ahead of the scan until the
// scan sets the stop flag.  Tile j of core k may be written once the scan
// has released tile j - NBUF.  Every decision is lane 0's reading of the
// counters, so the warp stays converged.
__device__ void produce(const Stage& g, const Feed& f, const Carve& cv,
                        int C, int lane) {
  const unsigned FULL = 0xffffffffu;
  while (!__shfl_sync(FULL, ld_volatile(g.stop), 0)) {
    bool busy = false;
    for (int k = 0; k < C; ++k) {
      const int j = ld_volatile(&g.filled[k]);
      const int rel = __shfl_sync(FULL, ld_volatile(&g.released[k]), 0);
      if (j >= rel + NBUF || j * TILE >= cv.len[k]) continue;
      f.fill(g, k, j, cv.len[k], lane);
      __syncwarp();
      if (lane == 0) st_release(&g.filled[k], j + 1);
      __syncwarp();
      busy = true;
    }
    if (!busy) __nanosleep(200);
  }
}

// Core c's record at position p > 0, on an owner lane.  Crossing into a
// new tile releases the previous one and waits until the producer has
// filled this one (it normally has, a tile ahead).
__device__ __forceinline__ int4 fetch(const Stage& g, int c, int p) {
  const int j = p >> TILE_SHIFT;
  if ((p & (TILE - 1)) == 0) {
    st_volatile(&g.released[c], j);
    while (ld_acquire(&g.filled[c]) <= j) __nanosleep(32);
  }
  return g.tiles[(c * NBUF + (j & (NBUF - 1))) * TILE + (p & (TILE - 1))];
}

// A lane's core in registers: its position, stream length, MSHR ring
// index, latest completion, head request and its issue time, and, loaded
// ahead so the chain never waits on them, the request after the head and
// the MSHR slot the head's successor will wait on.
struct CoreRegs {
  int k, p, len, ri, end, issue, ring_next;
  int4 head, next;
};

// One sweep point on a block of two warps (SCAN_THREADS): every thread
// initialises the state, then ``pre(prm)`` runs on every thread (the
// synthesis pre-pass; nothing for a trace launch).  Warp 1 then stages
// the streams of ``tr`` (the point's view of its stream) while warp 0
// runs the scan, and every thread writes the results out.
//
// The scan: lane k owns core k (with more than 32 cores, cores k, k + 32,
// ... whose state lives in shared memory, the earliest of them in the
// lane's registers).  A warp min-reduce of the lanes' issue times and a
// ballot pick the earliest (the first core on ties), its record reaches
// lane 0 by shuffles, lane 0 runs the service and shuffles the completion
// time back, and the owner advances its core and loads what its next
// issue time will need.  With one core, lane 0 runs the scan alone.
template <int WAYS, class Pre>
__device__ __forceinline__ void run_point(const Dims& d, const Layout& lay,
                                          const int* __restrict__ params,
                                          const float* __restrict__ seg_leak,
                                          const Trace& tr, int warmup,
                                          const Out& out, int* sm, Pre pre) {
  const int gp = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int C = d.C, M = d.M;
  const Stage g = stage_carve(d, sm);
  const Carve cv = carve(d, sm + stage_words(d));
  init_scan(d, cv, params, seg_leak, gp, tid, SCAN_THREADS);
  for (int k = tid; k < C; k += SCAN_THREADS) g.filled[k] = g.released[k] = 0;
  if (tid == 0) *g.stop = 0;
  __syncthreads();
  pre(cv.prm);
  __syncthreads();
  for (int k = tid; k < C; k += SCAN_THREADS) cv.len[k] = tr.length[k];
  __syncthreads();
  // warp 1 fills the first NBUF tiles of every core before the scan
  if (tid >= 32) {
    const Feed f(d, lay, cv, tr);
    for (int k = 0; k < C; ++k) {
      int j = 0;
      for (; j < NBUF && j * TILE < cv.len[k]; ++j)
        f.fill(g, k, j, cv.len[k], lane);
      if (lane == 0) g.filled[k] = j;
    }
  }
  __syncthreads();

  const size_t ev_plane = (size_t)d.G * d.n_steps;
  int* ev = out.events + (size_t)gp * d.n_steps;
  uint8_t* ev_ref8 = out.act_ref8 + (size_t)gp * d.n_steps;

  if (tid >= 32) {
    produce(g, Feed(d, lay, cv, tr), cv, C, lane);
  } else {
    const unsigned FULL = 0xffffffffu;
    const bool many = C > 32;
    Dram<WAYS> dr(d, lay, cv);
    // lane 0's accumulators; every one wraps like JAX's int32 adds
    unsigned acc[N_STATS] = {0};
    // position 0 of every core: last issue, last completion and MSHR ring
    // all 0, so its issue time is max(gap, 0); a lane without a core
    // stays at INF
    CoreRegs me{};
    me.k = -1;
    me.issue = INF;
    for (int k = lane; k < C; k += 32) {
      const int len = cv.len[k];
      const int4 head = g.tiles[k * NBUF * TILE];
      const int4 next = g.tiles[k * NBUF * TILE + 1];
      const int issue = len > 0 ? imax(head.x, 0) : INF;
      if (many) {
        cv.iss[k] = issue;
        g.head[k] = head;
        g.next[k] = next;
      }
      if (k == lane || issue < me.issue) {
        me = CoreRegs{k, 0, len, 0, 0, issue, 0, head, next};
      }
    }

    int s = 0;
    for (; s < d.n_steps; ++s) {
      // 1. earliest-issue core selection (ties to the lowest index)
      const int t_arr = C == 1 ? me.issue : __reduce_min_sync(FULL, me.issue);
      // a dead step changes nothing, so neither does any later one (with
      // one core, lanes 1..31 leave here at once)
      if (t_arr >= INF) break;
      int c = 0;
      int4 rec = me.head;
      if (C > 1) {
        const bool tie = me.issue == t_arr;
        c = many ? __reduce_min_sync(FULL, tie ? me.k : I32_MAX)
                 : __ffs(__ballot_sync(FULL, tie)) - 1;
        const int o = c & 31;
        rec.y = __shfl_sync(FULL, rec.y, o);
        rec.z = __shfl_sync(FULL, rec.z, o);
        rec.w = __shfl_sync(FULL, rec.w, o);
      }

      // 2. service (simulator._service)
      int done = 0;
      if (lane == 0) {
        Ev e;
        done = dr.service(t_arr, rec.z & 0xffff, rec.w >> R_CH_SHIFT, rec.y,
                          rec.z >> 16, (rec.w & R_WRITE) != 0,
                          (rec.w & R_NS) != 0, s >= warmup, acc, e);
        if (d.collect) {
          ev[0 * ev_plane + s] = e.act_gid;
          ev[1 * ev_plane + s] = e.act_t;
          ev[2 * ev_plane + s] = e.pre1_gid;
          ev[3 * ev_plane + s] = e.pre1_t;
          ev[4 * ev_plane + s] = e.pre2_gid;
          ev[5 * ev_plane + s] = e.pre2_t;
          ev[6 * ev_plane + s] = e.pre3_gid;
          ev[7 * ev_plane + s] = e.pre3_t;
          ev_ref8[s] = e.ref8 ? 1 : 0;
        }
      }
      if (C > 1) done = __shfl_sync(FULL, done, 0);

      // 3. core bookkeeping on the owner lane: the next request's issue
      //    time is max(last issue + gap, oldest MSHR slot, completion if
      //    dependent), INF past the stream
      if (me.k == c) {
        cv.ring[c * M + me.ri] = done;
        me.ri = me.ri + 1 == M ? 0 : me.ri + 1;
        me.end = imax(me.end, done);
        me.p += 1;
        me.issue = INF;
        if (me.p < me.len) {
          me.issue = imax(wadd(t_arr, me.next.x),
                          M == 1 ? done : me.ring_next);
          me.issue = imax(me.issue, (me.next.w & R_DEP) ? done : 0);
        }
        me.head = me.next;
        // what the issue time after this one will need
        me.ring_next = cv.ring[c * M + (me.ri + 1 == M ? 0 : me.ri + 1)];
        if (me.p + 1 < me.len) me.next = fetch(g, c, me.p + 1);
        if (many) {
          // park this core, then take up the lane's earliest one
          cv.ptr[c] = me.p;
          cv.ring_idx[c] = me.ri;
          cv.core_end[c] = me.end;
          cv.iss[c] = me.issue;
          g.head[c] = me.head;
          g.next[c] = me.next;
          int best = lane;
          for (int k = lane; k < C; k += 32)
            if (cv.iss[k] < cv.iss[best]) best = k;
          me = CoreRegs{best, cv.ptr[best], cv.len[best], cv.ring_idx[best],
                        cv.core_end[best], cv.iss[best], 0, g.head[best],
                        g.next[best]};
          me.ring_next =
              cv.ring[best * M + (me.ri + 1 == M ? 0 : me.ri + 1)];
        }
      }
    }
    if (!many && lane < C) cv.core_end[lane] = me.end;
    __syncwarp();

    if (lane == 0) {
      *cv.s_end = s;
      st_volatile(g.stop, 1);
      // simulator._retire_trailing_refs (stateful tier)
      if (dr.stateful) {
        int total = cv.core_end[0];
        for (int k = 1; k < C; ++k) total = imax(total, cv.core_end[k]);
        acc[REFS_ISSUED] =
            (unsigned)wmul(wadd(dr.trefi.div(total), 1), dr.banks_total);
      }
      for (int i = 0; i < N_STATS; ++i) cv.stats[i] = (int)acc[i];
    }
  }
  __syncthreads();

  write_scan(d, cv, out.stats, out.bank_stats, gp, tid, SCAN_THREADS);
  for (int i = tid; i < C; i += SCAN_THREADS)
    out.core_end[(size_t)gp * C + i] = cv.core_end[i];
  // dead tail steps: no events (time lanes zeroed for determinism)
  if (d.collect) {
    for (int s = *cv.s_end + tid; s < d.n_steps; s += SCAN_THREADS) {
      for (int lane_i = 0; lane_i < 8; ++lane_i)
        ev[lane_i * ev_plane + s] = (lane_i % 2 == 0) ? -1 : 0;
      ev_ref8[s] = 0;
    }
  }
}

// __maxnreg__: left to itself ptxas stops at 128 registers and spills in
// the shared Dram::service; 200 lets it keep the scan's state and the
// point's dividers in registers (ptxas for sm_90a: 193 registers here,
// 189 in the synthesis entry, no spill; chip_smoke prints its report).
// 255 was no faster.
__global__ void __maxnreg__(200)
sim_step_kernel(Dims d, Layout lay, const int* __restrict__ params,
                const float* __restrict__ seg_leak, Trace tr, Out out) {
  extern __shared__ int4 sm4[];
  // the thesis's 2-way HCRAC compiled for its way count, so a set's two
  // ways are loaded and checked together
  auto none = [](const int*) {};
  int* sm = reinterpret_cast<int*>(sm4);
  if (d.W == 2)
    run_point<2>(d, lay, params, seg_leak, tr, d.warmup, out, sm, none);
  else
    run_point<0>(d, lay, params, seg_leak, tr, d.warmup, out, sm, none);
}

// ---------------------------------------------------------------------------
// The synthesis entry: repro/workloads/generator.py::_gen_core per core,
// then the scan.  Replaces repro/kernels/sim_step/ops.py::_synth_pallas.
// ---------------------------------------------------------------------------

constexpr int MAX_GAP = 1 << 20;

// prng.lanes(14), in generator.py's order
enum {
  L_HIT, L_SEQ, L_HOT, L_PICK, L_GAP, L_WRITE, L_DEP, L_RBANK, L_RROW,
  L_HOTBANK, L_HOTROW, L_B0, L_STRIDE, L_PICK2
};

// prng.hash_u32 over (seed, core, lane) and (seed, core, lane, x)
__device__ __forceinline__ unsigned hash3(unsigned a, unsigned b, int ln) {
  return fmix(mix(mix(mix(kGold * 4u, a), b), lane_const(ln)));
}
__device__ __forceinline__ unsigned hash4(unsigned a, unsigned b, int ln,
                                          int x) {
  return fmix(mix(mix(mix(mix(kGold * 5u, a), b), lane_const(ln)),
                  (unsigned)x));
}
// prng.uniform: the top 24 bits times 2**-24 (exact)
__device__ __forceinline__ float uniform4(unsigned a, unsigned b, int ln,
                                          int x) {
  return __fmul_rn((float)(hash4(a, b, ln, x) >> 8), 5.9604645e-08f);
}
// generator._umod: uint32 hash mod a positive count
__device__ __forceinline__ int umod(unsigned h, int n) {
  return (int)(h % (unsigned)imax(n, 1));
}

// generator._rank_pick.  The same CUDA math functions (log1pf, expf) and
// correctly rounded operations as PyTorch's eager kernels on the card,
// no fast-math: bitwise the plain generator on CUDA tensors.  An expf
// that overflows to inf is past the table and redraws uniformly.
__device__ __forceinline__ int rank_pick(float u, float u_tail, float zipf_s,
                                         float geo_s, int hot_rows) {
  const float cap = (float)imax(hot_rows - 1, 0);
  const float a1 = fmax_nan(__fsub_rn(zipf_s, 1.0f), 1e-3f);
  const float lu = log1pf(-u);
  const float zipf = __fsub_rn(floorf(expf(__fdiv_rn(-lu, a1))), 1.0f);
  const float geo =
      floorf(__fdiv_rn(lu, log1pf(-fmin_nan(geo_s, 0.9999f))));
  float j = fmax_nan(zipf_s > 0.0f ? zipf : geo, 0.0f);
  const float uni = floorf(__fmul_rn(u_tail, (float)hot_rows));
  j = j > cap ? uni : j;
  return (int)fmin_nan(j, cap);
}

// Device pointers of a synthesis launch's stream scratch, [G, C, L] each.
struct Stream {
  int* gap;
  int* bank;
  int* row;
  uint8_t* is_write;
  uint8_t* dep;
  uint8_t* next_same;
};

// One core's stream (generator._gen_core) into the point's scratch, then
// its queue-hit lookahead over the folded stream (a reverse pass with
// one [NB] last-row file, as simulator._next_same_folded).  Runs on thread
// ``c``; ``wi``/``wf`` are the point's workload rows in shared memory.
__device__ void gen_core(const Dims& d, const SynthLayout& sl, int c,
                         const int* wi, const float* wf, int banks_total,
                         int bpc, int n_rows, int* ring_lb, int* ring_row,
                         int* last_row, const Stream& st) {
  const int L = d.L, SW = d.SW;
  const int* io = sl.ioff;
  const int* fo = sl.foff;
  const unsigned seed = (unsigned)wi[io[W_SEED] + c];
  const int core = wi[io[W_CORE] + c];
  const unsigned ucore = (unsigned)core;
  const int length = wi[io[W_LENGTH] + c];
  const int nch = wi[io[W_NCH]];
  const int il_kind = wi[io[W_IL_KIND]];
  const int il_block = imax(wi[io[W_IL_BLOCK]], 1);
  const int* seg_edge = wi + io[W_SEG_EDGE] + c * SW;
  const int* hot_rows = wi + io[W_HOT_ROWS] + c * SW;
  const int* n_hot_banks = wi + io[W_NHB] + c * SW;
  const int cs = c * SW;

  const int span =
      imax(floordiv(n_rows, imax(wi[io[W_NCORES] + c], 1)), 1);
  const int base = wmul(core, span);
  const int b0 = umod(hash3(seed, ucore, L_B0), banks_total);
  const int stride =
      1 + 2 * umod(hash3(seed, ucore, L_STRIDE),
                   imax(floordiv(banks_total, 2), 1));
  auto hot_lb = [&](int k) {
    return floormod(wadd(b0, wmul(k, stride)), banks_total);
  };
  auto hot_lb_of = [&](int j, int nhb) {
    return hot_lb(umod(hash4(seed, ucore, L_HOTBANK, j), nhb));
  };
  auto hot_row_of = [&](int j) {
    return wadd(base, umod(hash4(seed, ucore, L_HOTROW, j), span));
  };

  // the walk starts at the phase-0 hot set's entry 0; the ring holds
  // entries 1..RING
  const int nhb0 = imax(n_hot_banks[0], 1);
  int lb = hot_lb_of(0, nhb0);
  int row = hot_row_of(0);
  for (int i = 0; i < RING; ++i) {
    ring_lb[i] = hot_lb_of(1 + i, nhb0);
    ring_row[i] = hot_row_of(1 + i);
  }
  int head = 0;

  const size_t at0 = ((size_t)blockIdx.x * d.C + c) * L;
  for (int t = 0; t < L; ++t) {
    const size_t at = at0 + t;
    if (t >= length) {
      st.gap[at] = 0;
      st.bank[at] = 0;
      st.row[at] = 0;
      st.is_write[at] = 0;
      st.dep[at] = 0;
      continue;
    }
    int cnt = 0;
    for (int s = 0; s < SW; ++s) cnt += t >= seg_edge[s];
    const int seg = imax(cnt - 1, 0);
    const float* f = wf + cs + seg;
    const int nhb = imax(n_hot_banks[seg], 1);

    const bool hit = uniform4(seed, ucore, L_HIT, t) < f[fo[W_P_ROWHIT]];
    const bool seq =
        !hit && uniform4(seed, ucore, L_SEQ, t) < f[fo[W_P_SEQ]];
    const bool hot = !hit && !seq &&
                     uniform4(seed, ucore, L_HOT, t) < f[fo[W_P_HOT]];
    int new_lb = lb, new_row = row;
    if (seq) {
      new_row = wadd(base, floormod(wadd(wsub(row, base), 1), span));
    } else if (hot) {
      const int jp = rank_pick(uniform4(seed, ucore, L_PICK, t),
                               uniform4(seed, ucore, L_PICK2, t),
                               f[fo[W_ZIPF]], f[fo[W_GEO]], hot_rows[seg]);
      if (jp >= 1 && jp <= RING) {
        const int ridx = floormod(head - (jp - 1), RING);
        new_lb = ring_lb[ridx];
        new_row = ring_row[ridx];
      } else if (jp > RING) {
        new_lb = hot_lb_of(jp, nhb);
        new_row = hot_row_of(jp);
      }
    } else if (!hit) {
      new_lb = hot_lb(umod(hash4(seed, ucore, L_RBANK, t), nhb));
      new_row = wadd(base, umod(hash4(seed, ucore, L_RROW, t), span));
    }
    if (new_row != row) {  // distinct-row transition: push recency
      head = (head + 1) % RING;
      ring_lb[head] = lb;
      ring_row[head] = row;
    }
    lb = new_lb;
    row = new_row;

    // intensity and mix
    const float p_gap = __fdiv_rn(1.0f, f[fo[W_MEAN_GAP]]);
    const float q = __fdiv_rn(log1pf(-uniform4(seed, ucore, L_GAP, t)),
                              log1pf(-p_gap));
    const int gap = wadd(1, (int)floorf(q));
    // physical bank: dram.compose_address
    const int ch_home = floordiv(lb, bpc);
    const int ch_row = floormod(row, nch);
    const int ch_blk = floormod(floordiv(row, il_block), nch);
    const int ch_xor = floormod(row ^ lb, nch);
    const int ch = il_kind == 1 ? ch_row
                 : il_kind == 2 ? ch_blk
                 : il_kind == 3 ? ch_xor : ch_home;
    st.gap[at] = imin(imax(gap, 1), MAX_GAP);
    st.bank[at] = wadd(wmul(ch, bpc), floormod(lb, bpc));
    st.row[at] = row;
    st.is_write[at] =
        uniform4(seed, ucore, L_WRITE, t) < f[fo[W_P_WRITE]] ? 1 : 0;
    st.dep[at] = uniform4(seed, ucore, L_DEP, t) < f[fo[W_P_DEP]] ? 1 : 0;
  }

  // queue-hit lookahead over the folded stream, as the scan folds it
  for (int b = 0; b < d.NB; ++b) last_row[b] = NO_ROW;
  for (int t = L - 1; t >= 0; --t) {
    const size_t at = at0 + t;
    uint8_t ns = 0;
    if (t < length) {
      const int b = floormod(st.bank[at], banks_total);
      const int r = floormod(st.row[at], n_rows);
      ns = last_row[b] == r ? 1 : 0;
      last_row[b] = r;
    }
    st.next_same[at] = ns;
  }
}

__global__ void __maxnreg__(200)
sim_synth_kernel(Dims d, Layout lay, SynthLayout sl,
                 const int* __restrict__ params,
                 const float* __restrict__ seg_leak,
                 const int* __restrict__ wparams_i,
                 const float* __restrict__ wparams_f, Stream st, Out out) {
  extern __shared__ int4 sm4[];
  int* sm = reinterpret_cast<int*>(sm4);
  const int gp = blockIdx.x;
  const int tid = threadIdx.x;
  int* wi = sm + stage_words(d) + scan_words(d);
  float* wf = reinterpret_cast<float*>(wi + d.PI);
  int* rings = reinterpret_cast<int*>(wf + d.PF);
  int* last_rows = rings + 2 * RING * d.C;
  for (int i = tid; i < d.PI; i += SCAN_THREADS)
    wi[i] = wparams_i[(size_t)gp * d.PI + i];
  for (int i = tid; i < d.PF; i += SCAN_THREADS)
    wf[i] = wparams_f[(size_t)gp * d.PF + i];
  __syncthreads();

  const size_t pt = (size_t)gp * d.C * d.L;
  Trace tr{st.gap + pt, st.bank + pt, st.row + pt, st.is_write + pt,
           st.dep + pt, wi + sl.ioff[W_LENGTH], st.next_same + pt};
  auto pre = [&](const int* prm) {
    const int c = tid;
    if (c < d.C)
      gen_core(d, sl, c, wi, wf, prm[lay.off[F_BANKS_TOTAL]],
               prm[lay.off[F_BANKS_PER_CH]], prm[lay.off[F_N_ROWS]],
               rings + 2 * RING * c, rings + 2 * RING * c + RING,
               last_rows + d.NB * c, st);
  };
  const int warmup = wi[sl.ioff[W_WARMUP]];
  if (d.W == 2)
    run_point<2>(d, lay, params, seg_leak, tr, warmup, out, sm, pre);
  else
    run_point<0>(d, lay, params, seg_leak, tr, warmup, out, sm, pre);
}

// ---------------------------------------------------------------------------
// The serving entry: the continuous-batching closed loop
// (serving/loop/engine.py::_run_serving_impl; in repro an XLA scan,
// serving/loop/engine.py:342, with no Pallas kernel).  One point a block
// of three warps (SERVE_THREADS).
//
// The scheduler never reads the hot-page table or the DRAM state: an
// access arrives at t + 4 cnt, which the scheduler alone fixes, and no
// completion time is fed back; the probes' hits feed only a counter.  So
// a point is three chains that only the ordered list of page accesses
// joins, each on a warp of its own:
//  - warp 0, the scheduler (kernels/include/serve_sched.cuh): arrivals,
//    preemption, admission and retirement across its lanes, slot j and
//    queue entry q on lanes j % 32 and q % 32.  It writes each step's
//    accesses, in the plain engine's order, as 16-byte records into a
//    ring of SERVE_RING in shared memory: a header (the step's clock, its
//    prefill, probe and decode counts, the measure flag), then per access
//    the hot-table key, the row, the bank and the DRAM HCRAC set of its
//    row, and its arrival t + 4 cnt; a probe's record holds its key.  The
//    lane owning (request, page) hashes it and folds it into the point's
//    geometry, off both chains;
//  - warp 1, the hot table: lane 0 inserts each access's key in order
//    (the thesis's 2-way table compiled for its way count); a step's
//    probes, which come after its prefill inserts and before its decode
//    inserts, run across the lanes and are counted by ballot;
//  - warp 2, lane 0: Dram::service over the access records, loaded a
//    record ahead; nothing else runs on its path (the bank's channel is
//    a multiply and a shift of the prefetched bank).
// The ring's counters are a release store and acquire loads in shared
// memory: `filled` (the scheduler's), `hot_pos` and `dram_pos` (the
// chains'); a record is overwritten only once both chains have passed
// it.  Each side publishes its position before it waits on the other, so
// a step with more records than the ring still runs.
// ---------------------------------------------------------------------------

// Fields of the packed per-point serving row (int32 [G, PS]; rate and
// burstiness are float32 bits), in kServeAbi's order.
enum ServeField {
  V_RATE, V_BURST, V_PROMPT_LO, V_PROMPT_HI, V_DECODE_LO, V_DECODE_HI,
  V_SEED, V_NREQS, V_HOT_SETS, V_HOT_CACHING, V_HOT_PERIOD, V_CPS,
  V_PAGE_TOKENS, V_CA_EN, V_PRE_EN, V_PRE_THRESH, V_WARMUP, N_SERVE_FIELDS
};

const char* const kServeAbi =
    "serve:rate,burstiness,prompt_lo,prompt_hi,decode_lo,decode_hi,seed,"
    "n_reqs,hot_n_sets,hot_caching_cycles,hot_sweep_period,cycles_per_step,"
    "page_tokens,charge_aware_enable,preempting_enable,preempting_q_thresh,"
    "warmup;"
    "serve_dims:HHS,HW,hexact,SB,Q,A,Pp,Pt,n_steps,collect,pinned,PS";

// Static sizes of a serving launch: the padded hot table (sets, ways,
// expiry flavour), slots, queue, arrivals and page bounds a step, the
// step count, per-step outputs, pinned counts, the serving row width.
struct ServeDims {
  int HHS, HW, hexact, SB, Q, A, Pp, Pt, n_steps, collect, pinned, PS;
};

using sched::N_SERVE_STATS;
using sched::SV_HOT;

// Threads of a serving block: the scheduler, the hot table, the DRAM
constexpr int SERVE_THREADS = 96;
// Records of the ring (a power of two; several steps at the scale
// streams' ~40-260 records a step)
constexpr int SERVE_RING = 4096;

// Shared-memory words of a serving block: the ring and its counters, the
// scan state (one core), the serving row, the hot table, the slots (4
// arrays), the queue (6 arrays) and the queue's scores.
__host__ __device__ inline int serve_words(const Dims& d,
                                           const ServeDims& sd) {
  return 4 * SERVE_RING + 4 + scan_words(d) + sd.PS +
         3 * sd.HHS * sd.HW + 4 * sd.SB + 7 * sd.Q;
}

struct ServeOut {
  int* stats;       // [G, N_STATS]
  int* bank_stats;  // [G, 2, NB]
  int* serve;       // [G, N_SERVE_STATS]
  int* now;         // [G]
  int* steps;       // [3, G, n_steps]: occ, qlen, arrivals
};

// prng.uniform over three words
__device__ __forceinline__ float uniform_w3(unsigned a, unsigned b,
                                            unsigned c) {
  return __fmul_rn((float)(hash_w3(a, b, c) >> 8), 5.9604645e-08f);
}

// arrivals.step_counts at step s: the ON/OFF gate, then a geometric
// count floor(log1p(-u) / log(q)) — log1pf/logf as PyTorch's eager CUDA
// kernels call them, every other operation correctly rounded
__device__ __forceinline__ int step_count(float rate, float burst,
                                          unsigned seed, int s) {
  const float b = fmax_nan(burst, 1.0f);
  const bool on = __fmul_rn(uniform_w3(seed, lane_const(sched::A_ON),
                                       (unsigned)s),
                            b) < 1.0f;
  const float m = __fmul_rn(rate, b);
  float q = __fdiv_rn(m, __fadd_rn(1.0f, m));
  q = fmin_nan(fmax_nan(q, (float)1e-9), (float)(1.0 - 1e-6));
  const float u =
      uniform_w3(seed, lane_const(sched::A_COUNT), (unsigned)s);
  const int n = (int)floorf(__fdiv_rn(log1pf(-u), logf(q)));
  return on ? n : 0;
}

constexpr unsigned RING_MASK = SERVE_RING - 1;
// a header record's measure flag, above its decode count
constexpr unsigned H_MEASURE = 0x80000000u;

// a position at or past another (ring positions wrap as uint32)
__device__ __forceinline__ bool reached(unsigned pos, unsigned need) {
  return (int)(pos - need) >= 0;
}

// The scheduler's end of the ring (serve_sched.cuh's Sink): records are
// written from ``pos`` on and published with ``filled``; ``limit`` is
// the first position not yet known to be free.
struct RingSink {
  int4* ring;
  int *filled, *hot_pos, *dram_pos;
  int lane;
  unsigned pos, limit;
  int banks_total, n_rows;
  FloorDiv dsets;  // the DRAM HCRAC's set count

  // make the records written so far visible to the chains
  __device__ void publish() {
    __syncwarp();
    if (lane == 0) st_release(filled, (int)pos);
  }
  __device__ void reserve(const sched::Warp&, int n) {
    if (reached(limit, pos + n)) return;
    publish();
    unsigned lim = 0;
    if (lane == 0) {
      for (;;) {
        const unsigned h = (unsigned)ld_acquire(hot_pos);
        const unsigned d = (unsigned)ld_acquire(dram_pos);
        lim = (reached(h, d) ? d : h) + SERVE_RING;
        if (reached(lim, pos + n)) break;
        __nanosleep(100);
      }
    }
    limit = __shfl_sync(0xffffffffu, lim, 0);
  }
  __device__ void header(const sched::Warp& w, int t, int n_pre,
                         int n_probe, int n_dec, bool measure) {
    reserve(w, 1);
    if (lane == 0)
      ring[pos & RING_MASK] =
          make_int4(t, n_pre, n_probe,
                    (int)((unsigned)n_dec | (measure ? H_MEASURE : 0u)));
    __syncwarp();
    pos += 1;
  }
  // lane l's record of the chunk: page k of request rid
  __device__ void put(int l, int rid, int k, int kind, int t_arr) {
    int4 r;
    r.x = sched::page_gid(rid, k);
    r.y = r.z = 0;
    r.w = t_arr;
    if (kind != sched::K_PROBE) {
      const unsigned ur = (unsigned)rid, uk = (unsigned)k;
      const int bank =
          (int)(hash_w3(ur, uk, lane_const(sched::P_BANK)) %
                (unsigned)banks_total);
      const int row = (int)(hash_w3(ur, uk, lane_const(sched::P_ROW)) %
                            (unsigned)n_rows);
      r.y = row;
      r.z = bank | dsets.mod(wadd(wmul(bank, n_rows), row)) << 16;
    }
    ring[(pos + l) & RING_MASK] = r;
  }
  __device__ void advance(int n) { pos += n; }
};

// A chain's end of the ring: ``wait`` returns once record ``need - 1``
// is published, and before it waits, publishes ``done`` (the records
// this chain is finished with) as its position.
struct RingReader {
  const int4* ring;
  const int* filled;
  int* mine;
  unsigned avail;

  __device__ void wait(unsigned need, unsigned done) {
    if (reached(avail, need)) return;
    st_release(mine, (int)done);
    while (!reached(avail = (unsigned)ld_acquire(filled), need))
      __nanosleep(20);
  }
  __device__ int4 at(unsigned p) const { return ring[p & RING_MASK]; }
};

// A step's header record
struct StepHead {
  int t, n_pre, n_probe, n_dec;
  bool measure;
  __device__ explicit StepHead(int4 h)
      : t(h.x), n_pre(h.y), n_probe(h.z),
        n_dec((int)((unsigned)h.w & ~H_MEASURE)),
        measure(((unsigned)h.w & H_MEASURE) != 0) {}
};

// Warp 0: the scheduler's steps, arrivals drawn (or read, pinned) for 32
// steps at a time, a step on each lane.
__device__ void serve_schedule(const ServeDims& sd, const int* sv,
                               const sched::State& st, RingSink& sink,
                               const int* __restrict__ counts,
                               const ServeOut& out, int G, int gp,
                               int lane) {
  const int n = sd.n_steps;
  sched::Sched<RingSink> sc;
  // the registry fold: charge_aware and preempting both score by the
  // predicted charge, fifo by arrival order alone
  sc.p = sched::Params{
      (unsigned)sv[V_SEED], sv[V_PROMPT_LO], sv[V_PROMPT_HI],
      sv[V_DECODE_LO], sv[V_DECODE_HI], sv[V_NREQS], sv[V_CPS],
      sv[V_WARMUP], sv[V_PRE_THRESH], sv[V_PRE_EN] != 0,
      sv[V_CA_EN] != 0 || sv[V_PRE_EN] != 0,
      fmax_nan(__int2float_rn(sv[V_HOT_CACHING]), 1.0f),
      FloorDiv::make(sv[V_PAGE_TOKENS]), sd.SB, sd.Q, sd.A, sd.Pp, sd.Pt};
  sc.st = st;
  sc.reset(lane, 32);
  __syncwarp();
  const sched::Warp w{lane};
  const float rate = __int_as_float(sv[V_RATE]);
  const float burst = __int_as_float(sv[V_BURST]);
  const size_t plane = (size_t)G * n;
  int* steps_out = out.steps + (size_t)gp * n;
  int drawn = 0;  // this lane's step of the current 32
  for (int s = 0; s < n; ++s) {
    if ((s & 31) == 0) {
      const int sl = s + lane;
      drawn = sl >= n ? 0
              : sd.pinned ? counts[(size_t)gp * n + sl]
                          : step_count(rate, burst, sc.p.seed, sl);
    }
    const int n_drawn = __shfl_sync(0xffffffffu, drawn, s & 31);
    const sched::StepOut o = sc.step(w, sink, s, n_drawn);
    sink.publish();
    if (sd.collect && lane == 0) {
      steps_out[0 * plane + s] = o.occ;
      steps_out[1 * plane + s] = o.qlen;
      steps_out[2 * plane + s] = o.n_new;
    }
  }
  if (lane == 0) {
    for (int i = 0; i < N_SERVE_STATS; ++i)
      if (i != SV_HOT) out.serve[(size_t)gp * N_SERVE_STATS + i] = (int)sc.sv[i];
    out.now[gp] = sc.now;
  }
}

// Warp 1: the hot-page table.  Lane 0 inserts every access's key at its
// step's clock; a step's probes run across the lanes between its prefill
// and its decode inserts.  Returns the probes' hits (on every lane).
template <int HW>
__device__ unsigned serve_hot(const ServeDims& sd, const int* sv,
                              int* htags, int* hstamps, int* hlru,
                              RingReader rd, int lane) {
  Hcrac<HW> hot{htags, hstamps, hlru, sd.HW, sv[V_HOT_PERIOD],
                FloorDiv::make(sv[V_HOT_SETS]),
                FloorDiv::make(sv[V_HOT_CACHING]), sd.hexact != 0};
  unsigned hits = 0, pos = 0;
  // lane 0: insert the keys of records [p, p + n) at cycle t, each key
  // loaded a record ahead
  auto inserts = [&](unsigned p, int n, int t) {
    if (n == 0) return;
    rd.wait(p + 1, p);
    int gid = rd.at(p).x;
    for (int i = 0; i < n; ++i) {
      const int cur = gid;
      if (i + 1 < n) {
        rd.wait(p + i + 2, p + i + 1);
        gid = rd.at(p + i + 1).x;
      }
      hot.insert(cur, t);
    }
  };
  for (int s = 0; s < sd.n_steps; ++s) {
    if (lane == 0) rd.wait(pos + 1, pos);
    __syncwarp();
    const StepHead h(rd.at(pos));
    pos += 1;
    if (lane == 0) inserts(pos, h.n_pre, h.t);
    pos += h.n_pre;
    for (int c = 0; c < h.n_probe; c += 32) {
      const int m = imin(32, h.n_probe - c);
      if (lane == 0) rd.wait(pos + c + m, pos + c);
      __syncwarp();
      const bool hit = lane < m && hot.probe(rd.at(pos + c + lane).x, h.t);
      hits += __popc(__ballot_sync(0xffffffffu, hit));
    }
    pos += h.n_probe;
    if (lane == 0) {
      inserts(pos, h.n_dec, h.t);
      st_release(rd.mine, (int)(pos + h.n_dec));
    }
    pos += h.n_dec;
    __syncwarp();
  }
  return hits;
}

// Warp 2, lane 0: the DRAM service of every access record, in order, each
// record loaded a record ahead; the stats end in shared memory.
template <int WAYS>
__device__ void serve_dram(const Dims& d, const Layout& lay, const Carve& cv,
                           const ServeDims& sd, RingReader rd) {
  Dram<WAYS> dr(d, lay, cv);
  unsigned acc[N_STATS] = {0};
  Ev ev;
  unsigned pos = 0;
  auto serve = [&](unsigned p, int n, bool is_write, bool measure) {
    if (n == 0) return;
    rd.wait(p + 1, p);
    int4 nx = rd.at(p);
    for (int i = 0; i < n; ++i) {
      const int4 r = nx;
      if (i + 1 < n) {
        rd.wait(p + i + 2, p + i + 1);
        nx = rd.at(p + i + 1);
      }
      const int bank = r.z & 0xffff;
      dr.service(r.w, bank, dr.bpc.div(bank), r.y, r.z >> 16, is_write,
                 false, measure, acc, ev);
    }
  };
  for (int s = 0; s < sd.n_steps; ++s) {
    rd.wait(pos + 1, pos);
    const StepHead h(rd.at(pos));
    pos += 1;
    serve(pos, h.n_pre, true, h.measure);
    pos += h.n_pre + h.n_probe;
    serve(pos, h.n_dec, false, h.measure);
    pos += h.n_dec;
    st_release(rd.mine, (int)pos);
  }
  for (int i = 0; i < N_STATS; ++i) cv.stats[i] = (int)acc[i];
}

// __maxnreg__: the DRAM lane holds the point's params and dividers and
// the service's state in registers, as the scan entries do.
__global__ void __maxnreg__(255)
sim_serve_kernel(Dims d, Layout lay, ServeDims sd,
                 const int* __restrict__ params,
                 const float* __restrict__ seg_leak,
                 const int* __restrict__ sparams,
                 const int* __restrict__ counts, ServeOut out) {
  extern __shared__ int4 sm4[];
  const int gp = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int SB = sd.SB, Q = sd.Q, HT = sd.HHS * sd.HW;
  int4* ring = sm4;
  int* ctr = reinterpret_cast<int*>(ring + SERVE_RING);  // filled, hot, dram
  int* sm = ctr + 4;
  const Carve cv = carve(d, sm);
  init_scan(d, cv, params, seg_leak, gp, tid, SERVE_THREADS);
  int* sv = sm + scan_words(d);
  int* htags = sv + sd.PS;
  int* hstamps = htags + HT;
  int* hlru = hstamps + HT;
  int* slots = hlru + HT;
  int* queue = slots + 4 * SB;
  const sched::State st{slots,          slots + SB,     slots + 2 * SB,
                        slots + 3 * SB, queue,          queue + Q,
                        queue + 2 * Q,  queue + 3 * Q,  queue + 4 * Q,
                        queue + 5 * Q,
                        reinterpret_cast<float*>(queue + 6 * Q)};
  for (int i = tid; i < sd.PS; i += SERVE_THREADS)
    sv[i] = sparams[(size_t)gp * sd.PS + i];
  for (int i = tid; i < HT; i += SERVE_THREADS) {
    htags[i] = NO_TAG;
    hstamps[i] = 0;
    hlru[i] = -1;
  }
  if (tid < 3) ctr[tid] = 0;
  __syncthreads();

  const RingReader rd0{ring, ctr, nullptr, 0u};
  if (warp == 0) {
    const int* prm = cv.prm;
    RingSink sink{ring, ctr, ctr + 1, ctr + 2, lane, 0u, (unsigned)SERVE_RING,
                  prm[lay.off[F_BANKS_TOTAL]], prm[lay.off[F_N_ROWS]],
                  FloorDiv::make(prm[lay.off[F_HC_SETS]])};
    serve_schedule(sd, sv, st, sink, counts, out, d.G, gp, lane);
  } else if (warp == 1) {
    RingReader rd = rd0;
    rd.mine = ctr + 1;
    const unsigned hits =
        sd.HW == 2 ? serve_hot<2>(sd, sv, htags, hstamps, hlru, rd, lane)
                   : serve_hot<0>(sd, sv, htags, hstamps, hlru, rd, lane);
    if (lane == 0) out.serve[(size_t)gp * N_SERVE_STATS + SV_HOT] = (int)hits;
  } else if (lane == 0) {
    RingReader rd = rd0;
    rd.mine = ctr + 2;
    if (d.W == 2)
      serve_dram<2>(d, lay, cv, sd, rd);
    else
      serve_dram<0>(d, lay, cv, sd, rd);
  }
  __syncwarp();
  __syncthreads();
  write_scan(d, cv, out.stats, out.bank_stats, gp, tid, SERVE_THREADS);
}

// ---------------------------------------------------------------------------
// The window entry: the FR-FCFS controller tier
// (controller/engine.py::_run_window_impl; in repro an XLA scan,
// controller/engine.py:264, with no Pallas kernel), over a trace or, with
// the synthesis pre-pass (gen_core) first, over streams it generates
// itself.  One point a block of two warps (SCAN_THREADS).
//
// A block whose point is in-order (a rider of an FR-FCFS grid, at a
// window cap of 1) runs the trace or synthesis entry's scan, run_point:
// the window engine at a cap of 1 serves the in-order engine's requests
// in its order with its timings, bit for bit, and the scan does it in
// half the time a step.  An FR-FCFS block:
//  - warp 1 stages each core's stream as the scan entries do (Feed,
//    produce): no stream field is read from global memory on the chain;
//  - warp 0 is the controller (kernels/include/window_ctl.cuh): each
//    core's issue time and each window slot's key live in its owner
//    lane's registers and change only with what they depend on; an
//    admission attempt is a reduction, a successful one a ballot and
//    three shuffles more; the selection's best key is carried across the
//    step (a reduction after each service).  Lane 0 serves the selected
//    request with Dram::service under the rank's tRRD / tFAW floor
//    (precomputed a rank), keeps the rank registers and the events, and
//    hands the completion, the bank's new open row and the clock back by
//    shuffles.
//
// What bounds it: the same serial chain as the scan entries, one request
// a step, plus the controller's work of a step, all on one warp's
// in-order instruction stream: ~1 200 SM cycles of Dram::service and
// ~120 controller instructions (PERF.md section 6, PR 21).
// ---------------------------------------------------------------------------

// rank registers' start (NEG); tFAW's ACT count
constexpr int NEG = -(1 << 28);
constexpr int FAW_DEPTH = 4;
static_assert((int)winctl::R_WRITE == (int)R_WRITE &&
                  (int)winctl::R_DEP == (int)R_DEP &&
                  (int)winctl::R_NS == (int)R_NS &&
                  (int)winctl::R_CH_SHIFT == (int)R_CH_SHIFT,
              "the controller reads the staged records");

// Shared-memory words of the window state, in win_carve's order (a
// multiple of 4: the slots' records come first, 16-byte aligned).
__host__ __device__ inline int window_words(const Dims& d, int WN) {
  return (8 * WN + WN + d.C * d.M + 3 * d.C + (3 + FAW_DEPTH) * d.NB + 3) &
         ~3;
}

// Shared-memory words of a window block: the staged stream, the window
// state and the scan state (an in-order block uses the first and the
// last, as run_point carves them), then (synthesis feed) the point's
// workload rows, each core's recency ring and its next_same last-row
// file.
__host__ __device__ inline int window_block_words(const Dims& d, int WN) {
  return stage_words(d) + window_words(d, WN) + scan_words(d);
}
__host__ __device__ inline int window_smem_words(const Dims& d, int WN) {
  int w = window_block_words(d, WN);
  if (d.SW > 0) w += d.PI + d.PF + d.C * (2 * RING + d.NB);
  return w;
}

// The window engine's own state in shared memory (window_words): the WN
// slots' records and the keys of those past 32; per core its MSHR ring's
// served flags and, parked past 32 cores, its last issue and youngest's
// state; per rank (bank / n_banks, below the envelope's bank count) its
// newest ACT, its ring of the last FAW_DEPTH ACTs, the ring's oldest slot
// and the floor they set on its next ACT.
struct WinCarve {
  winctl::Slot* slots;
  int *skey, *ring_served, *last, *ys, *yd;
  int *rank_last, *faw, *faw_ptr, *act_floor;
};

__device__ __forceinline__ WinCarve win_carve(const Dims& d, int WN,
                                              int* sm) {
  WinCarve w;
  w.slots = reinterpret_cast<winctl::Slot*>(sm);
  w.skey = sm + 8 * WN;
  w.ring_served = w.skey + WN;
  w.last = w.ring_served + d.C * d.M;
  w.ys = w.last + d.C;
  w.yd = w.ys + d.C;
  w.rank_last = w.yd + d.C;
  w.faw = w.rank_last + d.NB;
  w.faw_ptr = w.faw + FAW_DEPTH * d.NB;
  w.act_floor = w.faw_ptr + d.NB;
  return w;
}

// Clock stamps of the window entry, compiled in only by a measurement
// build (-DWINDOW_STAMPS; tests/_torch_window_stamps.py reads them): per
// point, SM cycles of the step loop, the successful and the failed
// admission attempts, the selection, the service with its bookkeeping,
// the record fetches (on the owner lanes) and the event stores, then the
// attempts' and the steps' counts.
enum {
  ST_LOOP, ST_ADMIT_OK, ST_ADMIT_FAIL, ST_SELECT, ST_SERVICE, ST_FETCH,
  ST_EVENTS, ST_N_OK, ST_N_FAIL, ST_STEPS, N_STAMP
};
#ifdef WINDOW_STAMPS
constexpr int MAX_STAMP_G = 64;
__device__ unsigned long long g_stamps[MAX_STAMP_G * N_STAMP];
#endif
struct Stamps {
#ifdef WINDOW_STAMPS
  unsigned long long v[N_STAMP] = {};
  __device__ static long long clock() {
    asm volatile("" ::: "memory");
    const long long t = clock64();
    asm volatile("" ::: "memory");
    return t;
  }
  __device__ void since(int i, long long t0) { v[i] += clock() - t0; }
  __device__ void count(int i, int n = 1) { v[i] += n; }
  __device__ void flush(int gp, int lane) const {
    if (gp >= MAX_STAMP_G) return;
    atomicAdd(&g_stamps[gp * N_STAMP + ST_FETCH], v[ST_FETCH]);
    if (lane == 0)
      for (int i = 0; i < N_STAMP; ++i)
        if (i != ST_FETCH) g_stamps[gp * N_STAMP + i] = v[i];
  }
#else
  __device__ static long long clock() { return 0; }
  __device__ void since(int, long long) {}
  __device__ void count(int, int = 1) {}
  __device__ void flush(int, int) const {}
#endif
};

// The controller's view of the staged streams: positions 0 and 1 are in
// the first tile before the loop starts, later ones come through fetch.
struct StagedSrc {
  Stage g;
  Stamps* st;
  __device__ int4 first(int c, int i) const {
    return g.tiles[c * NBUF * TILE + i];
  }
  __device__ int4 record(int c, int p) const {
    const long long t0 = Stamps::clock();
    const int4 r = fetch(g, c, p);
#ifdef WINDOW_STAMPS
    asm volatile("" ::"r"(r.x), "r"(r.y), "r"(r.z), "r"(r.w));
#endif
    st->since(ST_FETCH, t0);
    return r;
  }
};

// One FR-FCFS point's window scan of depth WN on a block of two warps:
// every thread initialises the state, ``pre(prm)`` runs (the synthesis
// pre-pass; nothing for a trace), warp 1 stages the streams of ``tr``
// while warp 0 runs the steps with the controller ``Ctl``
// (window_ctl.cuh: FastCtl up to 32 cores and 32 slots, else Ctl), then
// every thread writes the results.
template <int WAYS, template <class> class Ctl, class Pre>
__device__ __forceinline__ void run_window(const Dims& d, const Layout& lay,
                                           const WinLayout& wl, int WN,
                                           const int* __restrict__ params,
                                           const float* __restrict__ seg_leak,
                                           const Trace& tr, int warmup,
                                           const Out& out, int* sm, Pre pre) {
  const int gp = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int C = d.C, M = d.M, NB = d.NB;
  const Stage g = stage_carve(d, sm);
  const WinCarve wv = win_carve(d, WN, sm + stage_words(d));
  const Carve cv = carve(d, sm + stage_words(d) + window_words(d, WN));
  init_scan(d, cv, params, seg_leak, gp, tid, SCAN_THREADS);
  for (int k = tid; k < C; k += SCAN_THREADS) g.filled[k] = g.released[k] = 0;
  if (tid == 0) *g.stop = 0;
  for (int i = tid; i < C * M; i += SCAN_THREADS) wv.ring_served[i] = 1;
  for (int i = tid; i < NB; i += SCAN_THREADS) {
    wv.rank_last[i] = NEG;
    wv.faw_ptr[i] = 0;
  }
  for (int i = tid; i < FAW_DEPTH * NB; i += SCAN_THREADS) wv.faw[i] = NEG;
  __syncthreads();
  pre(cv.prm);
  __syncthreads();
  for (int k = tid; k < C; k += SCAN_THREADS) cv.len[k] = tr.length[k];
  __syncthreads();
  // warp 1 fills the first NBUF tiles of every core before the steps
  if (tid >= 32) {
    const Feed f(d, lay, cv, tr);
    for (int k = 0; k < C; ++k) {
      int j = 0;
      for (; j < NBUF && j * TILE < cv.len[k]; ++j)
        f.fill(g, k, j, cv.len[k], lane);
      if (lane == 0) g.filled[k] = j;
    }
  }
  __syncthreads();

  const size_t ev_plane = (size_t)d.G * d.n_steps;
  int* ev = out.events + (size_t)gp * d.n_steps;
  uint8_t* ev_ref8 = out.act_ref8 + (size_t)gp * d.n_steps;

  if (tid >= 32) {
    produce(g, Feed(d, lay, cv, tr), cv, C, lane);
  } else {
    const unsigned FULL = 0xffffffffu;
    const int* prm = cv.prm;
    const int* off = wl.off;
    const int tRRD = prm[off[F_tRRD]];
    const int tFAW = prm[off[F_tFAW]];
    const FloorDiv rank_of = FloorDiv::make(prm[off[F_N_BANKS]]);
    for (int i = lane; i < NB; i += 32)
      wv.act_floor[i] = imax(wadd(NEG, tRRD), wadd(NEG, tFAW));
    __syncwarp();
    Stamps st;
    const sched::Warp w{lane};
    Ctl<StagedSrc> ctl;
    ctl.m = winctl::Mem{cv.ring,   wv.ring_served, cv.len,   cv.ptr,
                        cv.ring_idx, cv.iss,       wv.last,  wv.ys,
                        wv.yd,     g.head,         g.next,   wv.slots,
                        wv.skey,   cv.open_row};
    ctl.src = StagedSrc{g, &st};
    ctl.init(w, C, M, WN, prm[off[F_WIN_CAP]]);
    Dram<WAYS> dr(d, lay, cv);
    // lane 0's accumulators; every one wraps like JAX's int32 adds
    unsigned acc[N_STATS] = {0};

    const long long t_loop = Stamps::clock();
    int s = 0;
    for (; s < d.n_steps; ++s) {
      // 1. admission: at most WN attempts; a failed one changes nothing,
      //    so neither would any later one of the step
      for (int a = 0; a < WN; ++a) {
        const long long ta = Stamps::clock();
        if (!ctl.admit(w)) {
          st.since(ST_ADMIT_FAIL, ta);
          st.count(ST_N_FAIL);
          break;
        }
        st.since(ST_ADMIT_OK, ta);
        st.count(ST_N_OK);
      }

      // 2. selection: row hits first, then the oldest admission; an
      //    empty window after admission means every core is done, and so
      //    is every later step
      const long long tsel = Stamps::clock();
      const int e = ctl.select(w);
      if (e < 0) break;
      const winctl::Slot sl = wv.slots[e];
      const long long tsv = Stamps::clock();
      st.since(ST_SELECT, tsel);

      // 3. service under the rank's ACT floor, on lane 0
      const int bank = sl.rec.z & 0xffff, ch = sl.rec.w >> R_CH_SHIFT;
      int done = 0, open = 0, next_now = 0;
      if (lane == 0) {
        const int rank = rank_of.div(bank);
        const int act_floor = wv.act_floor[rank];
        Ev evr;
        int t_act = 0;
        bool needs_act = false;
        done = dr.template service<true>(
            sl.aux.w, bank, ch, sl.rec.y, sl.rec.z >> 16,
            (sl.rec.w & R_WRITE) != 0, (sl.rec.w & R_NS) != 0, s >= warmup,
            acc, evr, act_floor, &t_act, &needs_act);
        open = cv.open_row[bank];
        // the next decision waits for this service's commands on its
        // channel's command bus
        next_now = imax(ctl.now, cv.cmd_free[ch]);
        const long long tev = Stamps::clock();
        if (d.collect) {
          ev[0 * ev_plane + s] = evr.act_gid;
          ev[1 * ev_plane + s] = evr.act_t;
          ev[2 * ev_plane + s] = evr.pre1_gid;
          ev[3 * ev_plane + s] = evr.pre1_t;
          ev[4 * ev_plane + s] = evr.pre2_gid;
          ev[5 * ev_plane + s] = evr.pre2_t;
          ev[6 * ev_plane + s] = evr.pre3_gid;
          ev[7 * ev_plane + s] = evr.pre3_t;
          ev_ref8[s] = evr.ref8 ? 1 : 0;
        }
        st.since(ST_EVENTS, tev);
        // the rank window, on a real ACT; the running max keeps the
        // register monotone when an old miss is served after a younger
        // request activated later; then the floor on the rank's next ACT
        if (needs_act) {
          int* faw = wv.faw + rank * FAW_DEPTH;
          const int fslot = wv.faw_ptr[rank];
          const int last = imax(wv.rank_last[rank], t_act);
          const int nslot = (fslot + 1) & (FAW_DEPTH - 1);
          wv.rank_last[rank] = last;
          faw[fslot] = t_act;
          wv.faw_ptr[rank] = nslot;
          wv.act_floor[rank] =
              imax(wadd(last, tRRD), wadd(faw[nslot], tFAW));
        }
        cv.core_end[sl.aux.x] = imax(cv.core_end[sl.aux.x], done);
      }
      done = __shfl_sync(FULL, done, 0);
      open = __shfl_sync(FULL, open, 0);
      next_now = __shfl_sync(FULL, next_now, 0);
      ctl.served(w, e, sl, done, open, next_now);
      st.since(ST_SERVICE, tsv);
    }
    st.since(ST_LOOP, t_loop);
    st.count(ST_STEPS, s);
    st.flush(gp, lane);

    if (lane == 0) {
      *cv.s_end = s;
      st_volatile(g.stop, 1);
      // simulator._retire_trailing_refs (stateful tier)
      if (dr.stateful) {
        int total = cv.core_end[0];
        for (int k = 1; k < C; ++k) total = imax(total, cv.core_end[k]);
        acc[REFS_ISSUED] =
            (unsigned)wmul(wadd(dr.trefi.div(total), 1), dr.banks_total);
      }
      for (int i = 0; i < N_STATS; ++i) cv.stats[i] = (int)acc[i];
    }
  }
  __syncthreads();

  write_scan(d, cv, out.stats, out.bank_stats, gp, tid, SCAN_THREADS);
  for (int i = tid; i < C; i += SCAN_THREADS)
    out.core_end[(size_t)gp * C + i] = cv.core_end[i];
  // dead tail steps: no events (time lanes zeroed for determinism)
  if (d.collect) {
    for (int t = *cv.s_end + tid; t < d.n_steps; t += SCAN_THREADS) {
      for (int lane_i = 0; lane_i < 8; ++lane_i)
        ev[lane_i * ev_plane + t] = (lane_i % 2 == 0) ? -1 : 0;
      ev_ref8[t] = 0;
    }
  }
}

// The window entry: a trace feed (SW == 0) or the synthesis feed, whose
// pre-pass generates each core's stream (thread c, core c: C <= 32) into
// the [G, C, L] scratch ``st`` as sim_synth_kernel's does.  A block whose
// point is in-order runs run_point (the trace and synthesis entries' scan)
// instead of the window engine.
template <int WAYS, class Pre>
__device__ __forceinline__ void window_or_scan(
    bool frfcfs, const Dims& d, const Layout& lay, const WinLayout& wl,
    int WN, const int* __restrict__ params,
    const float* __restrict__ seg_leak, const Trace& tr, int warmup,
    const Out& out, int* sm, Pre pre) {
  if (frfcfs && d.C <= 32 && WN <= 32)
    run_window<WAYS, winctl::FastCtl>(d, lay, wl, WN, params, seg_leak, tr,
                                      warmup, out, sm, pre);
  else if (frfcfs)
    run_window<WAYS, winctl::Ctl>(d, lay, wl, WN, params, seg_leak, tr,
                                  warmup, out, sm, pre);
  else
    run_point<WAYS>(d, lay, params, seg_leak, tr, warmup, out, sm, pre);
}

__global__ void __maxnreg__(255)
sim_window_kernel(Dims d, Layout lay, WinLayout wl, int WN, SynthLayout sl,
                  const int* __restrict__ params,
                  const float* __restrict__ seg_leak,
                  const int* __restrict__ wparams_i,
                  const float* __restrict__ wparams_f, Trace tr, Stream st,
                  Out out) {
  extern __shared__ int4 sm4[];
  int* sm = reinterpret_cast<int*>(sm4);
  const int gp = blockIdx.x;
  const int tid = threadIdx.x;
  const bool frfcfs = params[(size_t)gp * d.P + wl.off[F_FRFCFS]] != 0;
  if (d.SW == 0) {
    auto none = [](const int*) {};
    if (d.W == 2)
      window_or_scan<2>(frfcfs, d, lay, wl, WN, params, seg_leak, tr,
                        d.warmup, out, sm, none);
    else
      window_or_scan<0>(frfcfs, d, lay, wl, WN, params, seg_leak, tr,
                        d.warmup, out, sm, none);
    return;
  }
  int* wi = sm + window_block_words(d, WN);
  float* wf = reinterpret_cast<float*>(wi + d.PI);
  int* rings = reinterpret_cast<int*>(wf + d.PF);
  int* last_rows = rings + 2 * RING * d.C;
  for (int i = tid; i < d.PI; i += SCAN_THREADS)
    wi[i] = wparams_i[(size_t)gp * d.PI + i];
  for (int i = tid; i < d.PF; i += SCAN_THREADS)
    wf[i] = wparams_f[(size_t)gp * d.PF + i];
  __syncthreads();
  const size_t pt = (size_t)gp * d.C * d.L;
  const Trace gen{st.gap + pt, st.bank + pt, st.row + pt, st.is_write + pt,
                  st.dep + pt, wi + sl.ioff[W_LENGTH], st.next_same + pt};
  auto pre = [&](const int* prm) {
    const int c = tid;
    if (c < d.C)
      gen_core(d, sl, c, wi, wf, prm[lay.off[F_BANKS_TOTAL]],
               prm[lay.off[F_BANKS_PER_CH]], prm[lay.off[F_N_ROWS]],
               rings + 2 * RING * c, rings + 2 * RING * c + RING,
               last_rows + d.NB * c, st);
  };
  const int warmup = wi[sl.ioff[W_WARMUP]];
  if (d.W == 2)
    window_or_scan<2>(frfcfs, d, lay, wl, WN, params, seg_leak, gen, warmup,
                      out, sm, pre);
  else
    window_or_scan<0>(frfcfs, d, lay, wl, WN, params, seg_leak, gen, warmup,
                      out, sm, pre);
}

// The dividers themselves: q[i], r[i] = floor(a[i] / d), a[i] - d q[i]
// (chip_smoke and the tests hold them against PyTorch's floor division).
__global__ void floor_div_kernel(const int* __restrict__ a, int n, int d,
                                 int* __restrict__ q, int* __restrict__ r) {
  const FloorDiv f = FloorDiv::make(d);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    q[i] = f.div(a[i]);
    r[i] = f.mod(a[i]);
  }
}

}  // namespace

extern "C" {

const char* sim_step_abi() { return kAbi; }

int sim_step_smem_bytes(const int* dims) {
  Dims d;
  static_assert(sizeof(Dims) == 18 * sizeof(int), "Dims layout");
  memcpy(&d, dims, sizeof(Dims));
  return 4 * smem_words(d);
}

const char* sim_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch one block per sweep point on ``stream``; returns the CUDA error
// code of the launch (0 on success).  Every pointer is device memory
// except ``dims`` and ``layout`` (host int arrays).
int sim_step_launch(const int* dims, const int* layout, const int* params,
                    const float* seg_leak, const int* gap, const int* bank,
                    const int* row, const uint8_t* is_write,
                    const uint8_t* dep, const int* length,
                    const uint8_t* next_same, int* stats, int* bank_stats,
                    int* core_end, int* events, uint8_t* act_ref8,
                    void* stream) {
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  if (!record_fits(d)) return (int)cudaErrorInvalidValue;
  Layout lay;
  memcpy(lay.off, layout, sizeof(lay.off));
  const int smem = 4 * smem_words(d);
  cudaError_t err = cudaFuncSetAttribute(
      sim_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Trace tr{gap, bank, row, is_write, dep, length, next_same};
  Out out{stats, bank_stats, core_end, events, act_ref8};
  sim_step_kernel<<<d.G, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      d, lay, params, seg_leak, tr, out);
  return (int)cudaGetLastError();
}

// Launch the synthesis entry: one block per sweep point generates its
// cores' streams into the [G, C, L] scratch (gap .. next_same), then
// scans them.  ``synth_layout`` holds the int then the float field
// offsets of the workload rows.  Returns the launch's CUDA error code.
int sim_synth_launch(const int* dims, const int* layout,
                     const int* synth_layout, const int* params,
                     const float* seg_leak, const int* wparams_i,
                     const float* wparams_f, int* gap, int* bank, int* row,
                     uint8_t* is_write, uint8_t* dep, uint8_t* next_same,
                     int* stats, int* bank_stats, int* core_end,
                     int* events, uint8_t* act_ref8, void* stream) {
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  if (d.C > 32 || d.SW < 1 || !record_fits(d))
    return (int)cudaErrorInvalidValue;
  Layout lay;
  memcpy(lay.off, layout, sizeof(lay.off));
  SynthLayout sl;
  memcpy(sl.ioff, synth_layout, sizeof(sl.ioff));
  memcpy(sl.foff, synth_layout + N_SYNTH_INT, sizeof(sl.foff));
  const int smem = 4 * smem_words(d);
  cudaError_t err = cudaFuncSetAttribute(
      sim_synth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Stream st{gap, bank, row, is_write, dep, next_same};
  Out out{stats, bank_stats, core_end, events, act_ref8};
  sim_synth_kernel<<<d.G, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      d, lay, sl, params, seg_leak, wparams_i, wparams_f, st, out);
  return (int)cudaGetLastError();
}

// Divide ``n`` int32 values by the positive divisor ``d`` on ``stream``
// (floor_div_kernel); returns the launch's CUDA error code.
int sim_step_floor_div(const int* a, int n, int d, int* q, int* r,
                       void* stream) {
  if (d < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = n / 256 + 1 < 2048 ? n / 256 + 1 : 2048;
  floor_div_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(a, n, d, q, r);
  return (int)cudaGetLastError();
}

int sim_window_smem_bytes(const int* dims) {
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  return 4 * window_smem_words(d, dims[18]);
}

// Launch the window entry: one block (two warps) per sweep point runs the
// FR-FCFS window engine of depth dims' WIN (its 19th entry; ``layout``
// holds the N_FIELDS offsets, then the N_WIN_FIELDS), or the in-order scan
// for a point whose frfcfs field is 0, over a trace (``synth_layout``,
// ``wparams_i`` and ``wparams_f`` null, dims' SW 0: gap .. next_same are
// the trace and its lookahead tables) or, with SW > 0, over the streams it
// generates into the [G, C, L] scratch gap .. next_same (``length`` then
// unused).  Refuses a window of depth < 1, a geometry whose bank or HCRAC
// set does not fit a record, a synthesis feed of more than 32 cores and
// streams whose admission count could reach the selection key's hit
// penalty (C L >= 2**26).  Returns the launch's CUDA error code.
int sim_window_launch(const int* dims, const int* layout,
                      const int* synth_layout, const int* params,
                      const float* seg_leak, const int* wparams_i,
                      const float* wparams_f, int* gap, int* bank, int* row,
                      uint8_t* is_write, uint8_t* dep, const int* length,
                      uint8_t* next_same, int* stats, int* bank_stats,
                      int* core_end, int* events, uint8_t* act_ref8,
                      void* stream) {
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  const int WN = dims[18];
  // every admission sequence stays below the key's hit penalty
  if (WN < 1 || !record_fits(d) || (d.SW > 0 && d.C > 32) ||
      (long long)d.C * d.L >= winctl::HIT_PENALTY)
    return (int)cudaErrorInvalidValue;
  Layout lay;
  memcpy(lay.off, layout, sizeof(lay.off));
  WinLayout wl;
  memcpy(wl.off, layout + N_FIELDS, sizeof(wl.off));
  SynthLayout sl{};
  if (d.SW > 0) {
    memcpy(sl.ioff, synth_layout, sizeof(sl.ioff));
    memcpy(sl.foff, synth_layout + N_SYNTH_INT, sizeof(sl.foff));
  }
  const int smem = 4 * window_smem_words(d, WN);
  cudaError_t err = cudaFuncSetAttribute(
      sim_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Trace tr{gap, bank, row, is_write, dep, length, next_same};
  Stream st{gap, bank, row, is_write, dep, next_same};
  Out out{stats, bank_stats, core_end, events, act_ref8};
  sim_window_kernel<<<d.G, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      d, lay, wl, WN, sl, params, seg_leak, wparams_i, wparams_f, tr, st,
      out);
  return (int)cudaGetLastError();
}

#ifdef WINDOW_STAMPS
// A measurement build's stamps of the last window launch: copy n values
// (N_STAMP a point) to ``out`` and zero them.
int sim_window_stamps(unsigned long long* out, int n) {
  if (n > MAX_STAMP_G * N_STAMP) n = MAX_STAMP_G * N_STAMP;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamps, n * sizeof(*out));
  if (err != cudaSuccess) return (int)err;
  static unsigned long long zero[MAX_STAMP_G * N_STAMP];
  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
}
#endif

const char* sim_serve_abi() { return kServeAbi; }

int sim_serve_smem_bytes(const int* dims, const int* serve_dims) {
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  ServeDims sd;
  static_assert(sizeof(ServeDims) == 12 * sizeof(int), "ServeDims layout");
  memcpy(&sd, serve_dims, sizeof(ServeDims));
  return 4 * serve_words(d, sd);
}

// Launch the serving entry: one block per grid point runs the serving
// closed loop for ``serve_dims``' n_steps steps, its arrivals drawn in
// the kernel or, with ``pinned``, read from ``counts`` [G, n_steps].
// Refuses a geometry whose bank or HCRAC set does not fit a record.
// Returns the launch's CUDA error code.
int sim_serve_launch(const int* dims, const int* layout,
                     const int* serve_dims, const int* params,
                     const float* seg_leak, const int* sparams,
                     const int* counts, int* stats, int* bank_stats,
                     int* serve, int* now, int* steps, void* stream) {
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  ServeDims sd;
  memcpy(&sd, serve_dims, sizeof(ServeDims));
  if (d.C != 1 || sd.PS != N_SERVE_FIELDS || sd.SB < 1 || sd.Q < 1 ||
      !record_fits(d))
    return (int)cudaErrorInvalidValue;
  Layout lay;
  memcpy(lay.off, layout, sizeof(lay.off));
  const int smem = 4 * serve_words(d, sd);
  cudaError_t err = cudaFuncSetAttribute(
      sim_serve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ServeOut out{stats, bank_stats, serve, now, steps};
  sim_serve_kernel<<<d.G, SERVE_THREADS, smem, (cudaStream_t)stream>>>(
      d, lay, sd, params, seg_leak, sparams, counts, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
