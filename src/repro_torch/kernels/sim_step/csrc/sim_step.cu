// sim_step.cu — the trace-driven DRAM simulator scan as a CUDA kernel.
//
// Replaces repro/kernels/sim_step/kernel.py::grid_step_call (the Pallas
// grid launcher, reached from ops.py::_sweep_pallas), which runs one
// sweep point's whole in-order request scan (simulator._run_impl) per
// grid step.  Here each sweep point is one thread block of one warp:
// lane 0 runs the scan, the other lanes help initialise the state and
// write the results out.  The point's whole state (cores, MSHR rings,
// banks, buses, the padded HCRAC table, its copy of the packed params)
// lives in shared memory, sized by the envelope; the trace arrays and
// the per-geometry next_same tables are read from global memory (a few
// MB, resident in L2) and shared by every block.
//
// What bounds it: not bytes and not operations, but a serial dependency
// chain of n_steps requests per block — every request reads the bank,
// bus and HCRAC state the previous one wrote.  G blocks run side by
// side on the 132 SMs, so a sweep takes about as long as one point's
// chain, whatever G is up to 132 (more points than SMs queue in waves).
// A faster design (several lanes per step, prefetching the next
// requests, more points per SM) is later work.
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

namespace {

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

const char* const kAbi =
    "fields:tRCD,tRAS,tRP,tCL,tCWL,tBL,tRTP,tWR,tREFI,tRFC,"
    "n_refresh_groups,retention_cycles,banks_total,banks_per_channel,"
    "n_rows,closed_policy,refresh_stateful,hc_gate,hc_n_sets,"
    "hc_caching_cycles,hc_sweep_period,ns_idx,ll_enable,ll_tRCD,ll_tRAS,"
    "cc_enable,cc_tRCD,cc_tRAS,nuat_enable,nuat_edge,nuat_rcd,nuat_ras,"
    "rltl_enable,rltl_window,rltl_tRCD,rltl_tRAS,al_enable,al_drift,al_rcd,"
    "al_ras,al_seg_rcd,al_seg_ras,th_enable,th_seg_edge;"
    "dims:G,C,L,NB,NCH,HS,W,M,NBINS,S,P,n_steps,warmup,collect,exact";

// Static sizes of one launch, in the order of kAbi's "dims".
struct Dims {
  int G, C, L, NB, NCH, HS, W, M, NBINS, S, P, n_steps, warmup, collect,
      exact;
};

struct Layout {
  int off[N_FIELDS];
};

// Shared-memory words of one block; must match the carve in the kernel.
__host__ __device__ inline int smem_words(const Dims& d) {
  return d.P + 5 * d.C + d.C * d.M + 10 * d.NB + 2 * d.NCH +
         3 * d.HS * d.W + N_STATS + 1 + d.S;
}

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
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
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// The point's HCRAC: [HS, W] tables in shared memory; n_sets, caching
// and period are the point's active values (never the padded shape's).
struct Hcrac {
  int* tags;
  int* itime;
  int* lru;
  int W, n_sets, caching, period;
  bool exact;

  __device__ bool alive(int set, int way, int it, int t) const {
    if (exact) return wsub(t, it) <= caching;
    int phase = wmul(set * W + way + 1, period);
    // same sweep window <=> no invalidation of this slot in (it, t]
    return floordiv(wsub(t, phase), caching) ==
           floordiv(wsub(it, phase), caching);
  }

  // hcrac.insert: the first matching way, else the first invalid way,
  // else the least recently used valid way (first on ties).
  __device__ void insert(int gid, int t) {
    int set = floormod(gid, n_sets);
    int base = set * W;
    int match_way = -1, inv_way = -1, lru_way = 0, lru_best = 0;
    for (int w = 0; w < W; ++w) {
      int tag = tags[base + w];
      bool valid = tag != NO_TAG && alive(set, w, itime[base + w], t);
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
    itime[base + way] = t;
    lru[base + way] = t;
  }

  // hcrac.lookup: a hit refreshes the matching ways' LRU stamps only.
  __device__ bool lookup(int gid, int t) {
    int set = floormod(gid, n_sets);
    int base = set * W;
    bool hit = false;
    for (int w = 0; w < W; ++w) {
      int tag = tags[base + w];
      if (tag != NO_TAG && tag == gid && alive(set, w, itime[base + w], t)) {
        lru[base + w] = t;
        hit = true;
      }
    }
    return hit;
  }
};

// dram.refresh_adjust with the row's refresh group (legacy tier).
__device__ __forceinline__ int refresh_adjust(int t, int row, int tREFI,
                                              int tRFC, int groups) {
  int r = floormod(t, tREFI);
  bool busy = r < tRFC &&
              floormod(row, groups) == floormod(floordiv(t, tREFI), groups);
  return busy ? wadd(t, wsub(tRFC, r)) : t;
}

// dram.refresh_clamp_span with the row's refresh group (legacy tier).
__device__ __forceinline__ int refresh_clamp_span(int t, int span, int row,
                                                  int tREFI, int tRFC,
                                                  int groups) {
  int r = floormod(t, tREFI);
  int base = wsub(t, r);
  int k = floordiv(t, tREFI);
  int g = floormod(row, groups);
  bool in_this = r < tRFC && g == floormod(k, groups);
  bool into_next = wadd(r, span) > tREFI && g == floormod(wadd(k, 1), groups);
  int fixed = in_this ? wadd(base, tRFC) : wadd(wadd(base, tREFI), tRFC);
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

__global__ void __launch_bounds__(32)
sim_step_kernel(Dims d, Layout lay, const int* __restrict__ params,
                const float* __restrict__ seg_leak, Trace tr, Out out) {
  extern __shared__ int sm[];
  const int gp = blockIdx.x;
  const int lane = threadIdx.x;
  const int C = d.C, L = d.L, NB = d.NB, NCH = d.NCH, M = d.M;

  // carve (order must match smem_words)
  int* prm = sm;
  int* ptr = prm + d.P;
  int* last_issue = ptr + C;
  int* last_complete = last_issue + C;
  int* ring_idx = last_complete + C;
  int* core_end = ring_idx + C;
  int* ring = core_end + C;
  int* open_row = ring + C * M;
  int* ready_act = open_row + NB;
  int* ready_rdwr = ready_act + NB;
  int* ready_pre = ready_rdwr + NB;
  int* last_pre_gid = ready_pre + NB;
  int* last_pre_t = last_pre_gid + NB;
  int* ref_k = last_pre_t + NB;
  int* last_ref_t = ref_k + NB;
  int* bank_acts = last_ref_t + NB;
  int* bank_ras = bank_acts + NB;
  int* cmd_free = bank_ras + NB;
  int* data_free = cmd_free + NCH;
  int* tags = data_free + NCH;
  int* itime = tags + d.HS * d.W;
  int* lru = itime + d.HS * d.W;
  int* stats = lru + d.HS * d.W;
  int* s_end = stats + N_STATS;
  float* leak = reinterpret_cast<float*>(s_end + 1);

  for (int i = lane; i < d.P; i += 32) prm[i] = params[(size_t)gp * d.P + i];
  for (int i = lane; i < 5 * C + C * M; i += 32) ptr[i] = 0;
  for (int i = lane; i < NB; i += 32) {
    open_row[i] = NO_ROW;
    ready_act[i] = 0;
    ready_rdwr[i] = 0;
    ready_pre[i] = 0;
    last_pre_gid[i] = -1;
    last_pre_t[i] = 0;
    ref_k[i] = 0;
    last_ref_t[i] = 0;
    bank_acts[i] = 0;
    bank_ras[i] = 0;
  }
  for (int i = lane; i < 2 * NCH; i += 32) cmd_free[i] = 0;
  for (int i = lane; i < d.HS * d.W; i += 32) {
    tags[i] = NO_TAG;
    itime[i] = 0;
    lru[i] = -1;
  }
  for (int i = lane; i < N_STATS; i += 32) stats[i] = 0;
  for (int i = lane; i < d.S; i += 32) leak[i] = seg_leak[(size_t)gp * d.S + i];
  if (lane == 0) *s_end = d.n_steps;
  __syncwarp();

  const size_t ev_plane = (size_t)d.G * d.n_steps;
  int* ev = out.events + (size_t)gp * d.n_steps;
  uint8_t* ev_ref8 = out.act_ref8 + (size_t)gp * d.n_steps;

  if (lane == 0) {
    const int* off = lay.off;
    const int tRCD = prm[off[F_tRCD]], tRAS = prm[off[F_tRAS]];
    const int tRP = prm[off[F_tRP]], tCL = prm[off[F_tCL]];
    const int tCWL = prm[off[F_tCWL]], tBL = prm[off[F_tBL]];
    const int tRTP = prm[off[F_tRTP]], tWR = prm[off[F_tWR]];
    const int tREFI = prm[off[F_tREFI]], tRFC = prm[off[F_tRFC]];
    const int groups = prm[off[F_GROUPS]];
    const int retention = prm[off[F_RETENTION]];
    const int banks_total = prm[off[F_BANKS_TOTAL]];
    const int bpc = prm[off[F_BANKS_PER_CH]];
    const int n_rows = prm[off[F_N_ROWS]];
    const bool closed = prm[off[F_CLOSED]] != 0;
    const bool stateful = prm[off[F_STATEFUL]] != 0;
    const bool legacy = !stateful;
    const bool hc_gate = prm[off[F_HC_GATE]] != 0;
    const bool ll_en = prm[off[F_LL_EN]] != 0;
    const int ll_rcd = prm[off[F_LL_RCD]], ll_ras = prm[off[F_LL_RAS]];
    const bool cc_en = prm[off[F_CC_EN]] != 0;
    const int cc_rcd = prm[off[F_CC_RCD]], cc_ras = prm[off[F_CC_RAS]];
    const bool nuat_en = prm[off[F_NUAT_EN]] != 0;
    const int* nuat_edge = prm + off[F_NUAT_EDGE];
    const int* nuat_rcd = prm + off[F_NUAT_RCD];
    const int* nuat_ras = prm + off[F_NUAT_RAS];
    const bool rltl_en = prm[off[F_RLTL_EN]] != 0;
    const int rltl_window = prm[off[F_RLTL_WINDOW]];
    const int rltl_rcd = prm[off[F_RLTL_RCD]];
    const int rltl_ras = prm[off[F_RLTL_RAS]];
    const bool al_en = prm[off[F_AL_EN]] != 0;
    const bool al_drift = prm[off[F_AL_DRIFT]] != 0;
    const int* al_rcd = prm + off[F_AL_RCD];
    const int* al_ras = prm + off[F_AL_RAS];
    const int* al_seg_rcd = prm + off[F_AL_SEG_RCD];
    const int* al_seg_ras = prm + off[F_AL_SEG_RAS];
    const bool th_en = prm[off[F_TH_EN]] != 0;
    const int* th_edge = prm + off[F_TH_EDGE];
    const uint8_t* next_same =
        tr.next_same + (size_t)prm[off[F_NS_IDX]] * C * L;

    Hcrac hc{tags, itime, lru, d.W, prm[off[F_HC_SETS]],
             prm[off[F_HC_CACHING]], prm[off[F_HC_PERIOD]], d.exact != 0};

    // every accumulator wraps like JAX's int32 adds
    unsigned acc[N_STATS] = {0};
    enum { N_REQ, LAT_SUM, ACTS, ACTS_LOWERED, HC_HITS, HC_LOOKUPS,
           ROW_HITS, ROW_CLOSED, ROW_CONFLICTS, READS, WRITES, PRES,
           ACT_RAS_SUM, REF8_ACTS, REFS_ISSUED, REF_BLOCKED };

    int s = 0;
    for (; s < d.n_steps; ++s) {
      // 1. earliest-issue core selection (ties to the lowest index)
      int c = 0, t_arr = 0;
      for (int k = 0; k < C; ++k) {
        int p = ptr[k];
        int issue = INF;
        if (p < tr.length[k]) {
          int pc = imin(imax(p, 0), L - 1);
          issue = imax(wadd(last_issue[k], tr.gap[k * L + pc]),
                       ring[k * M + ring_idx[k]]);
          issue = imax(issue, tr.dep[k * L + pc] ? last_complete[k] : 0);
        }
        if (k == 0 || issue < t_arr) {
          t_arr = issue;
          c = k;
        }
      }
      // a dead step changes nothing, so neither does any later one
      if (t_arr >= INF) break;
      const bool measure = s >= d.warmup;
      const unsigned m = measure ? 1u : 0u;
      const int pc = imin(imax(ptr[c], 0), L - 1);
      const int tix = c * L + pc;
      const int bank = floormod(tr.bank[tix], banks_total);
      const int row = floormod(tr.row[tix], n_rows);
      const bool is_write = tr.is_write[tix] != 0;
      const bool ns = next_same[tix] != 0;

      // 2. service (simulator._service)
      const int ch = floordiv(bank, bpc);
      const int t0 = imax(t_arr, cmd_free[ch]);

      // rolling refresh: catch the bank's REF counter up (stateful tier)
      const int ref_due = wadd(floordiv(t0, tREFI), 1);
      const int n_pend = imax(wsub(ref_due, ref_k[bank]), 0);
      const bool do_ref = stateful && n_pend > 0;
      const int busy0 =
          imax(imax(ready_act[bank], ready_pre[bank]), ready_rdwr[bank]);
      const int ref_t = imax(wmul(wsub(ref_due, 1), tREFI), ready_pre[bank]);
      const int ref_done = wadd(ref_t, tRFC);
      const int openr0 = open_row[bank];
      const bool ref_pre = do_ref && openr0 != NO_ROW;
      const int openr = do_ref ? NO_ROW : openr0;
      const int r_act_b = do_ref ? imax(ready_act[bank], ref_done)
                                 : ready_act[bank];
      const int r_pre_b = do_ref ? imax(ready_pre[bank], ref_done)
                                 : ready_pre[bank];
      const int r_rdwr_b = do_ref ? imax(ready_rdwr[bank], ref_done)
                                  : ready_rdwr[bank];
      const int gid_ref = wadd(wmul(bank, n_rows), ref_pre ? openr0 : 0);
      if (ref_pre && hc_gate) hc.insert(gid_ref, ref_t);

      const bool is_hit = openr == row;
      const bool is_closed = openr == NO_ROW;
      const bool is_conflict = !is_hit && !is_closed;

      // conflict path: PRE the open row (insert it into the HCRAC)
      int t_pre = imax(t0, r_pre_b);
      if (legacy) t_pre = refresh_adjust(t_pre, row, tREFI, tRFC, groups);
      const int gid_old = wadd(wmul(bank, n_rows), is_conflict ? openr : 0);
      if (is_conflict && hc_gate) hc.insert(gid_old, t_pre);

      // ACT
      int t_act = is_conflict ? wadd(t_pre, tRP) : imax(t0, r_act_b);
      if (legacy) t_act = refresh_adjust(t_act, row, tREFI, tRFC, groups);
      const bool needs_act = !is_hit;
      const int gid = wadd(wmul(bank, n_rows), row);
      // the lookup runs on row hits too (LRU refresh); with the gate off
      // the table stays empty, so skipping it changes nothing
      bool cc_hit = hc_gate ? hc.lookup(gid, t_act) : false;
      cc_hit = cc_hit && needs_act && hc_gate;

      const int tslp =
          last_pre_gid[bank] == gid ? wsub(t_act, last_pre_t[bank]) : INF;

      // leak clock (dram.time_since_refresh / the stateful REF registers)
      const int tsr_closed = floormod(
          wsub(t_act, wmul(floormod(row, groups), tREFI)), retention);
      const int kw = wsub(ref_due, 1);
      const int j_g = wsub(kw, floormod(wsub(kw, floormod(row, groups)),
                                        groups));
      const int new_last_ref_t = do_ref ? ref_t : last_ref_t[bank];
      const int t_ref = j_g == kw ? new_last_ref_t : wmul(j_g, tREFI);
      const int tsr = (stateful && j_g >= 0) ? imax(wsub(t_act, t_ref), 0)
                                             : tsr_closed;
      int seg = 0;
      int tsr_eff = tsr;
      if (d.S > 0) {
        int cnt = 0;
        for (int i = 0; i < d.S; ++i) cnt += t_act >= th_edge[i];
        seg = imin(imax(cnt - 1, 0), d.S - 1);
        if (th_en) tsr_eff = __float2int_rn(__fmul_rn((float)tsr, leak[seg]));
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
        for (int i = d.NBINS - 1; i >= 0; --i) {
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
        if (d.S > 0 && al_drift) {
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
      t_rdwr = imax(t_rdwr, wsub(data_free[ch], cas));
      if (legacy)
        t_rdwr = refresh_clamp_span(t_rdwr, wadd(cas, tBL), row, tREFI, tRFC,
                                    groups);
      const int done = wadd(wadd(t_rdwr, cas), tBL);

      // bank state updates
      const int new_ready_rdwr = needs_act ? wadd(t_act, rcd) : r_rdwr_b;
      const int after_rw =
          is_write ? wadd(done, tWR) : wadd(t_rdwr, tRTP);
      const int new_ready_pre =
          imax(needs_act ? wadd(t_act, ras) : r_pre_b, after_rw);
      const bool auto_pre = closed && !ns;
      const int t_autopre = new_ready_pre;
      if (auto_pre && hc_gate) hc.insert(gid, t_autopre);
      const int new_open = auto_pre ? NO_ROW : row;
      const int new_ready_act =
          auto_pre ? wadd(t_autopre, tRP)
                   : (is_conflict ? wadd(t_pre, tRP) : r_act_b);
      const int n_cmds = 1 + (int)needs_act + (int)is_conflict + (int)auto_pre;
      const int new_cmd_free = wadd(imax(cmd_free[ch], t_arr), n_cmds);

      const int lp_gid0 = ref_pre ? gid_ref : last_pre_gid[bank];
      const int lp_t0 = ref_pre ? ref_t : last_pre_t[bank];
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
        acc[REF_BLOCKED] +=
            (unsigned)imax(wsub(ref_done, imax(t0, busy0)), 0);
      bank_acts[bank] = (int)((unsigned)bank_acts[bank] + a);
      bank_ras[bank] = (int)((unsigned)bank_ras[bank] + a * (unsigned)ras);

      if (d.collect) {
        ev[0 * ev_plane + s] = (needs_act && measure) ? gid : -1;
        ev[1 * ev_plane + s] = t_act;
        ev[2 * ev_plane + s] = is_conflict ? gid_old : -1;
        ev[3 * ev_plane + s] = t_pre;
        ev[4 * ev_plane + s] = auto_pre ? gid : -1;
        ev[5 * ev_plane + s] = t_autopre;
        ev[6 * ev_plane + s] = ref_pre ? gid_ref : -1;
        ev[7 * ev_plane + s] = ref_t;
        ev_ref8[s] = ref8 ? 1 : 0;
      }

      // state writes
      open_row[bank] = new_open;
      ready_act[bank] = new_ready_act;
      ready_rdwr[bank] = new_ready_rdwr;
      ready_pre[bank] = new_ready_pre;
      last_pre_gid[bank] = new_lp_gid;
      last_pre_t[bank] = new_lp_t;
      if (do_ref) ref_k[bank] = ref_due;
      last_ref_t[bank] = new_last_ref_t;
      cmd_free[ch] = new_cmd_free;
      data_free[ch] = done;

      // 3. core bookkeeping
      const int ri = ring_idx[c];
      ptr[c] = ptr[c] + 1;
      last_issue[c] = t_arr;
      last_complete[c] = done;
      ring[c * M + ri] = done;
      ring_idx[c] = floormod(ri + 1, M);
      core_end[c] = imax(core_end[c], done);
    }
    *s_end = s;

    // simulator._retire_trailing_refs (stateful tier)
    if (stateful) {
      int total = core_end[0];
      for (int k = 1; k < C; ++k) total = imax(total, core_end[k]);
      acc[REFS_ISSUED] =
          (unsigned)wmul(wadd(floordiv(total, tREFI), 1), banks_total);
    }
    for (int i = 0; i < N_STATS; ++i) stats[i] = (int)acc[i];
  }
  __syncwarp();

  for (int i = lane; i < N_STATS; i += 32)
    out.stats[(size_t)gp * N_STATS + i] = stats[i];
  for (int i = lane; i < NB; i += 32) {
    out.bank_stats[((size_t)gp * 2 + 0) * NB + i] = bank_acts[i];
    out.bank_stats[((size_t)gp * 2 + 1) * NB + i] = bank_ras[i];
  }
  for (int i = lane; i < C; i += 32)
    out.core_end[(size_t)gp * C + i] = core_end[i];
  // dead tail steps: no events (time lanes zeroed for determinism)
  if (d.collect) {
    for (int s = *s_end + lane; s < d.n_steps; s += 32) {
      for (int lane_i = 0; lane_i < 8; ++lane_i)
        ev[lane_i * ev_plane + s] = (lane_i % 2 == 0) ? -1 : 0;
      ev_ref8[s] = 0;
    }
  }
}

}  // namespace

extern "C" {

const char* sim_step_abi() { return kAbi; }

int sim_step_smem_bytes(const int* dims) {
  Dims d;
  static_assert(sizeof(Dims) == 15 * sizeof(int), "Dims layout");
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
  Layout lay;
  memcpy(lay.off, layout, sizeof(lay.off));
  const int smem = 4 * smem_words(d);
  cudaError_t err = cudaFuncSetAttribute(
      sim_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Trace tr{gap, bank, row, is_write, dep, length, next_same};
  Out out{stats, bank_stats, core_end, events, act_ref8};
  sim_step_kernel<<<d.G, 32, smem, (cudaStream_t)stream>>>(d, lay, params,
                                                           seg_leak, tr, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
