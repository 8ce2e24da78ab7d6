// serve_sched.cuh — the serving closed loop's scheduler step
// (serving/loop/engine.py::_make_step, steps 1-3 and 6, and the ordered
// list of the step's page accesses) over the 32 lanes of one warp.
//
// The scheduler never reads the hot-page table or the DRAM state: an
// access arrives at t + 4 cnt, which it alone fixes, and no completion
// time is fed back.  So the serving entry of sim_step.cu runs it on a
// warp of its own, which hands each step's accesses on as records to the
// two chains that do read that state (the hot table and the DRAM
// service); this header is that warp's code.
//
// Slot j and queue entry q belong to lanes j % 32 and q % 32, so the
// per-step scans are strided over the lanes and joined by warp
// collectives: ballots and a popc prefix place arrivals in position
// order, an argmax with first-index ties picks the preemption victim,
// and each admission is three reductions (the best score, the smallest
// (q_seq, q) among the entries that reach it, the first free slot).  A
// lane owning (request, page) computes that access's record.
//
// The code is written over a small lane abstraction, so that the same
// text runs on the card and, built by a host compiler, as a sequential
// emulation of the 32 lanes (the tests hold it against the plain engine
// that way):
//   Lane<T>      a value per lane: one register on the card, an array of
//                32 on the host;
//   w.each(f)    f(l) for this lane (the card, then __syncwarp) or for
//                every lane in turn (the host).  Inside f a lane reads and
//                writes its own entries only, or lane 0 acts alone;
//   collectives  ballot, sum / max / min, fmax (NaN propagates), an
//                inclusive scan, get (one lane's value) and gather (each
//                lane's from a lane it names), called outside each.
//
// Semantics follow repro.serving.loop.engine bit for bit: int32 wraps,
// float32 operations are rounded once each, ties go to the first index.

#pragma once

#include <stdint.h>

#include "floor_div.cuh"

#ifdef __CUDACC__
#define SCHED_HD __host__ __device__ __forceinline__
#define SCHED_DEV __device__ __forceinline__
#else
#define SCHED_HD inline
#define SCHED_DEV inline
#endif

namespace sched {

constexpr int INF = 1 << 30;
constexpr int I32_MAX = 0x7fffffff;
constexpr int I32_MIN = -I32_MAX - 1;

// int32 arithmetic that wraps, in uint32 (signed overflow is undefined)
SCHED_HD int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
SCHED_HD int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
SCHED_HD int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
SCHED_HD int imax(int a, int b) { return a > b ? a : b; }
SCHED_HD int imin(int a, int b) { return a < b ? a : b; }

// jnp.maximum / jnp.minimum on float32: NaN propagates
SCHED_HD float fmax_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
SCHED_HD float fmin_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// float32 operations rounded once each (the host's default rounding is
// to nearest, and the host build does not contract them)
SCHED_HD float f_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
SCHED_HD float f_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
SCHED_HD float neg_inf() {
#ifdef __CUDA_ARCH__
  return -__int_as_float(0x7f800000);
#else
  return -__builtin_huge_valf();
#endif
}
SCHED_HD float i2f(int a) {
#ifdef __CUDA_ARCH__
  return __int2float_rn(a);
#else
  return (float)a;
#endif
}

// prng.hash_u32: the counter hash of workloads/prng.py
constexpr unsigned kM1 = 0x85EBCA6Bu, kM2 = 0xC2B2AE35u, kGold = 0x9E3779B9u;

// prng.lanes(n)[i]
SCHED_HD constexpr unsigned lane_const(int i) {
  return kGold * (unsigned)(i + 1);
}
SCHED_HD unsigned mix(unsigned h, unsigned w) {
  h = (h ^ w) * kM1;
  return (h ^ (h >> 15)) * kM2;
}
SCHED_HD unsigned fmix(unsigned h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  return h ^ (h >> 16);
}
// prng.hash_u32 over three words
SCHED_HD unsigned hash_w3(unsigned a, unsigned b, unsigned c) {
  return fmix(mix(mix(mix(kGold * 4u, a), b), c));
}

// arrivals.py lanes (on, count, prompt, decode) and engine.py lanes
// (gid, bank, row): prng.lanes(4) and prng.lanes(3)
enum { A_ON, A_COUNT, A_PROMPT, A_DECODE };
enum { P_GID, P_BANK, P_ROW };

// arrivals.request_attrs: lo + uint32 hash mod the inclusive span
SCHED_HD int request_attr(unsigned seed, int ln, int rid, int lo, int hi) {
  const unsigned span = (unsigned)wadd(wsub(hi, lo), 1);
  return wadd(lo, (int)(hash_w3(seed, lane_const(ln), (unsigned)rid) % span));
}

// engine.page_gid: the 31-bit hot-table key of (request, page)
SCHED_HD int page_gid(int rid, int k) {
  return (int)(hash_w3((unsigned)rid, (unsigned)k, lane_const(P_GID)) &
               0x7FFFFFFFu);
}

// policies._charge_score: clip(1 - age / C, 0, 1) in float32
SCHED_HD float charge_score(int now, int touch, float c) {
  const float age = i2f(wsub(now, touch));
  return fmin_nan(fmax_nan(f_sub(1.0f, f_div(age, c)), 0.0f), 1.0f);
}

// engine.SERVE_STAT_KEYS, in order
enum { SV_ARRIVED, SV_DROPPED, SV_ADMITTED, SV_RETIRED, SV_PREEMPTED,
       SV_PROBES, SV_HOT, SV_OCC, SV_QLEN, N_SERVE_STATS };

// The kinds of a step's records, in the order the step hands them on:
// prefill writes (arrival-major, then page), the read-only probes of
// first-decode requests, decode reads (slot-major, then page).
enum { K_PREFILL, K_PROBE, K_DECODE };

// ---------------------------------------------------------------------------
// The lane abstraction
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

template <class T>
struct Lane {
  T v;
  SCHED_DEV T& operator[](int) { return v; }
  SCHED_DEV const T& operator[](int) const { return v; }
};

SCHED_DEV int popc(unsigned b) { return __popc(b); }
SCHED_DEV int ffs(unsigned b) { return __ffs(b); }

struct Warp {
  static constexpr unsigned FULL = 0xffffffffu;
  int lane;

  template <class F>
  SCHED_DEV void each(F f) const {
    f(lane);
    __syncwarp();
  }
  SCHED_DEV unsigned ballot(const Lane<bool>& p) const {
    return __ballot_sync(FULL, p.v);
  }
  SCHED_DEV int sum(const Lane<int>& x) const {
    return (int)__reduce_add_sync(FULL, (unsigned)x.v);
  }
  SCHED_DEV int max(const Lane<int>& x) const {
    return __reduce_max_sync(FULL, x.v);
  }
  SCHED_DEV int min(const Lane<int>& x) const {
    return __reduce_min_sync(FULL, x.v);
  }
  SCHED_DEV float fmax(const Lane<float>& x) const {
    float v = x.v;
    for (int o = 16; o > 0; o >>= 1)
      v = fmax_nan(v, __shfl_xor_sync(FULL, v, o));
    return v;
  }
  SCHED_DEV Lane<int> incl_scan(Lane<int> x) const {
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x.v, o);
      if (lane >= o) x.v = wadd(x.v, y);
    }
    return x;
  }
  template <class T>
  SCHED_DEV T get(const Lane<T>& x, int src) const {
    return __shfl_sync(FULL, x.v, src);
  }
  SCHED_DEV Lane<int> gather(const Lane<int>& x,
                             const Lane<int>& src) const {
    return Lane<int>{__shfl_sync(FULL, x.v, src.v)};
  }
};

#else  // the host's sequential emulation of the 32 lanes

template <class T>
struct Lane {
  T v[32];
  T& operator[](int l) { return v[l]; }
  const T& operator[](int l) const { return v[l]; }
};

inline int popc(unsigned b) { return __builtin_popcount(b); }
inline int ffs(unsigned b) { return __builtin_ffs((int)b); }

struct Warp {
  template <class F>
  void each(F f) const {
    for (int l = 0; l < 32; ++l) f(l);
  }
  unsigned ballot(const Lane<bool>& p) const {
    unsigned b = 0;
    for (int l = 0; l < 32; ++l) b |= (p[l] ? 1u : 0u) << l;
    return b;
  }
  int sum(const Lane<int>& x) const {
    int s = 0;
    for (int l = 0; l < 32; ++l) s = wadd(s, x[l]);
    return s;
  }
  int max(const Lane<int>& x) const {
    int m = x[0];
    for (int l = 1; l < 32; ++l) m = imax(m, x[l]);
    return m;
  }
  int min(const Lane<int>& x) const {
    int m = x[0];
    for (int l = 1; l < 32; ++l) m = imin(m, x[l]);
    return m;
  }
  float fmax(const Lane<float>& x) const {
    float m = x[0];
    for (int l = 1; l < 32; ++l) m = fmax_nan(m, x[l]);
    return m;
  }
  Lane<int> incl_scan(Lane<int> x) const {
    for (int l = 1; l < 32; ++l) x[l] = wadd(x[l], x[l - 1]);
    return x;
  }
  template <class T>
  T get(const Lane<T>& x, int src) const {
    return x[src];
  }
  Lane<int> gather(const Lane<int>& x, const Lane<int>& src) const {
    Lane<int> y;
    for (int l = 0; l < 32; ++l) y[l] = x[src[l]];
    return y;
  }
};

#endif

SCHED_HD unsigned lanes_below(int l) { return (1u << l) - 1u; }

// The first index i < n with rid[i] < 0 (a free slot or queue entry),
// or -1.
SCHED_DEV int first_free(const Warp& w, const int* rid, int n) {
  for (int i0 = 0; i0 < n; i0 += 32) {
    Lane<bool> f;
    w.each([&](int l) { f[l] = i0 + l < n && rid[i0 + l] < 0; });
    const unsigned b = w.ballot(f);
    if (b) return i0 + ffs(b) - 1;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// The scheduler
// ---------------------------------------------------------------------------

// A point's serving params as the scheduler reads them.
struct Params {
  unsigned seed;
  int p_lo, p_hi, d_lo, d_hi, n_reqs, cps, warmup, q_thresh;
  bool pre_en, use_charge;  // preempting; charge-ordered admission
  float cfl;                // the hot table's caching duration, >= 1
  FloorDiv ptok;            // tokens a KV page
  int SB, Q, A, Pp, Pt;     // slots, queue, arrivals and pages bounds
};

// The decode slots [SB] and the admission queue [Q] (with its scores),
// in shared memory.
struct State {
  int *s_rid, *s_done, *s_max, *s_pages;
  int *q_rid, *q_done, *q_max, *q_pages, *q_touch, *q_seq;
  float* score;
};

// What one step reports: post-admission occupancy, queue length after
// the step, accepted arrivals.
struct StepOut {
  int occ, qlen, n_new;
};

// One point's scheduler on a warp.  ``Sink`` takes the step's records:
//   header(w, t, n_pre, n_probe, n_dec, measure)  the step's counts;
//   reserve(w, n)                room for n more records (every lane);
//   put(l, rid, k, kind, t_arr)  lane l's record, record l of the
//                                chunk: page k of request rid;
//   advance(n)                   the chunk's n records are written.
template <class Sink>
struct Sched {
  Params p;
  State st;
  int n_arrived, next_seq, now;
  unsigned sv[N_SERVE_STATS];  // every counter but SV_HOT

  // engine._init_loop_state's slots and queue, on thread tid of nt
  SCHED_DEV void reset(int tid, int nt) {
    for (int i = tid; i < p.SB; i += nt) {
      st.s_rid[i] = -1;
      st.s_done[i] = st.s_max[i] = st.s_pages[i] = 0;
    }
    for (int i = tid; i < p.Q; i += nt) {
      st.q_rid[i] = -1;
      st.q_done[i] = st.q_max[i] = st.q_pages[i] = st.q_touch[i] =
          st.q_seq[i] = 0;
      st.score[i] = 0.0f;
    }
    n_arrived = next_seq = now = 0;
    for (int i = 0; i < N_SERVE_STATS; ++i) sv[i] = 0;
  }

  // Lane l's records of one round of 32 requests: rid[l]'s pages 0 ..
  // n[l] - 1, after those of the lanes below l; accesses arrive at t + 4
  // cnt, cnt running on from cnt0.  Chunks of 32 records, record c + l on
  // lane l, which finds its request by a binary search of the prefix sums
  // across the lanes.  Returns the round's record count.
  SCHED_DEV int emit(const Warp& w, Sink& sink, const Lane<int>& rid,
                     const Lane<int>& n, int kind, int cnt0) {
    const Lane<int> end = w.incl_scan(n);
    const int total = w.get(end, 31);
    for (int c = 0; c < total; c += 32) {
      const int m = imin(32, total - c);
      sink.reserve(w, m);
      Lane<int> lo, hi;
      w.each([&](int l) {
        lo[l] = 0;
        hi[l] = 31;
      });
      for (int b = 0; b < 5; ++b) {  // the first lane whose end > c + l
        Lane<int> mid;
        w.each([&](int l) { mid[l] = (lo[l] + hi[l]) >> 1; });
        const Lane<int> e = w.gather(end, mid);
        w.each([&](int l) {
          if (e[l] > c + l)
            hi[l] = mid[l];
          else
            lo[l] = mid[l] + 1;
        });
      }
      const Lane<int> o_rid = w.gather(rid, lo);
      const Lane<int> o_end = w.gather(end, lo);
      const Lane<int> o_n = w.gather(n, lo);
      w.each([&](int l) {
        const int i = c + l;
        if (i < total) {
          const int k = i - (o_end[l] - o_n[l]);
          const int t_arr =
              kind == K_PROBE ? now : wadd(now, wmul(4, wadd(cnt0, i)));
          sink.put(l, o_rid[l], k, kind, t_arr);
        }
      });
      sink.advance(m);
    }
    return total;
  }

  // The pages of a request that streams ``n`` of them: at most ``bound``
  // (the engine's access slots), none if n is not positive.
  SCHED_HD static int pages(int n, int bound) {
    return imax(imin(n, bound), 0);
  }
  // Slot j's decode pages this step (0 if free): the prompt pages plus
  // the pages its decoded tokens have grown into.
  SCHED_DEV int decode_pages(int j) const {
    return st.s_rid[j] < 0
               ? 0
               : pages(wadd(st.s_pages[j], p.ptok.div(wadd(
                                               st.s_done[j],
                                               wsub(p.ptok.d, 1)))),
                       p.Pt);
  }
  // Slot j's read-only probes this step: its prompt pages on its first
  // decode.
  SCHED_DEV int probe_pages(int j) const {
    return st.s_rid[j] >= 0 && st.s_done[j] == 0
               ? pages(st.s_pages[j], p.Pt)
               : 0;
  }
  // Arrival a's prefill pages (0 past the step's n_new arrivals)
  SCHED_DEV int prefill_pages(int a, int n_new, int rid0) const {
    return a < n_new ? pages(request_attr(p.seed, A_PROMPT, wadd(rid0, a),
                                          p.p_lo, p.p_hi),
                             p.Pp)
                     : 0;
  }

  // One scheduler step (step s, ``n_drawn`` requests drawn for it).
  SCHED_DEV StepOut step(const Warp& w, Sink& sink, int s, int n_drawn) {
    const int t = now;
    const int SB = p.SB, Q = p.Q;

    // 1. arrivals into free queue slots in position order: free slot
    //    number r (counted from the first) takes arrival r
    const int want = imin(n_drawn, wsub(p.n_reqs, n_arrived));
    const int take = imin(want, p.A);
    const int rid0 = n_arrived, seq0 = next_seq;
    int free_q = 0;
    for (int q0 = 0; q0 < Q; q0 += 32) {
      Lane<bool> fr;
      w.each([&](int l) { fr[l] = q0 + l < Q && st.q_rid[q0 + l] < 0; });
      const unsigned b = w.ballot(fr);
      w.each([&](int l) {
        const int r = free_q + popc(b & lanes_below(l));
        const int q = q0 + l;
        if (fr[l] && r < take) {
          const int rid = wadd(rid0, r);
          st.q_rid[q] = rid;
          st.q_done[q] = 0;
          st.q_pages[q] = request_attr(p.seed, A_PROMPT, rid, p.p_lo, p.p_hi);
          st.q_max[q] = request_attr(p.seed, A_DECODE, rid, p.d_lo, p.d_hi);
          st.q_touch[q] = t;
          st.q_seq[q] = wadd(seq0, r);
        }
      });
      free_q += popc(b);
    }
    const int n_new = imin(take, free_q);
    n_arrived = wadd(n_arrived, n_new);
    next_seq = wadd(next_seq, n_new);

    // 2. preemption: the first slot with the most remaining work (>= 2)
    //    goes back to the first free queue slot
    const int q_len = wadd(wsub(Q, free_q), n_new);
    Lane<int> key, at;
    w.each([&](int l) {
      int k = I32_MIN, a = 0;
      for (int j = l; j < SB; j += 32) {
        const int rem = wsub(st.s_max[j], st.s_done[j]);
        const int kj = st.s_rid[j] >= 0 && rem >= 2 ? rem : -1;
        if (kj > k) {
          k = kj;
          a = j;
        }
      }
      key[l] = k;
      at[l] = a;
    });
    const int v_key = w.max(key);
    Lane<int> vj;
    w.each([&](int l) { vj[l] = key[l] == v_key ? at[l] : I32_MAX; });
    const int victim = w.min(vj);
    const bool pe = p.pre_en && q_len > p.q_thresh &&
                    wsub(free_q, n_new) > 0 && v_key >= 0;
    if (pe) {
      const int qd = first_free(w, st.q_rid, Q);
      const int seq = next_seq;
      w.each([&](int l) {
        if (l != 0) return;
        st.q_rid[qd] = st.s_rid[victim];
        st.q_done[qd] = st.s_done[victim];
        st.q_max[qd] = st.s_max[victim];
        st.q_pages[qd] = st.s_pages[victim];
        st.q_touch[qd] = wsub(t, p.cps);  // its last decode step
        st.q_seq[qd] = seq;               // back of the line
        st.s_rid[victim] = -1;
      });
      next_seq = wadd(next_seq, 1);
    }

    // 3. admission: best score first, the smallest q_seq on ties, into
    //    the first free slot, while a slot and a request are left (so
    //    min(free slots, queued requests) times)
    Lane<int> nf, nq;
    w.each([&](int l) {
      int f = 0, v = 0;
      for (int j = l; j < SB; j += 32) f += st.s_rid[j] < 0;
      for (int q = l; q < Q; q += 32) {
        v += st.q_rid[q] >= 0;
        st.score[q] =
            p.use_charge ? charge_score(t, st.q_touch[q], p.cfl) : 0.0f;
      }
      nf[l] = f;
      nq[l] = v;
    });
    const int n_adm = imin(w.sum(nf), w.sum(nq));
    for (int it = 0; it < n_adm; ++it) {
      Lane<float> bl;
      w.each([&](int l) {
        float b = neg_inf();
        for (int q = l; q < Q; q += 32)
          if (st.q_rid[q] >= 0) b = fmax_nan(b, st.score[q]);
        bl[l] = b;
      });
      const float best = w.fmax(bl);
      Lane<int> ps, pq;
      w.each([&](int l) {
        int sq = INF, at_q = 0;
        for (int q = l; q < Q; q += 32) {
          if (st.q_rid[q] >= 0 && st.score[q] >= best && st.q_seq[q] < sq) {
            sq = st.q_seq[q];
            at_q = q;
          }
        }
        ps[l] = sq;
        pq[l] = at_q;
      });
      const int m_seq = w.min(ps);
      Lane<int> pc;
      w.each([&](int l) {
        pc[l] = ps[l] == m_seq && ps[l] < INF ? pq[l] : I32_MAX;
      });
      int pick = w.min(pc);
      if (pick == I32_MAX) pick = 0;
      const int dest = first_free(w, st.s_rid, SB);
      w.each([&](int l) {
        if (l != 0) return;
        st.s_rid[dest] = st.q_rid[pick];
        st.s_done[dest] = st.q_done[pick];
        st.s_max[dest] = st.q_max[pick];
        st.s_pages[dest] = st.q_pages[pick];
        st.q_rid[pick] = -1;
      });
    }

    // 4-5. the step's records: its counts, then prefill writes, probes
    //      and decode reads, each round of 32 arrivals or slots in turn
    Lane<int> c_pre, c_pr, c_dec;
    w.each([&](int l) {
      int a = 0, pr = 0, dc = 0;
      for (int i = l; i < p.A; i += 32) a += prefill_pages(i, n_new, rid0);
      for (int j = l; j < SB; j += 32) {
        pr += probe_pages(j);
        dc += decode_pages(j);
      }
      c_pre[l] = a;
      c_pr[l] = pr;
      c_dec[l] = dc;
    });
    const int n_pre = w.sum(c_pre), n_probe = w.sum(c_pr);
    const int n_dec = w.sum(c_dec);
    sink.header(w, t, n_pre, n_probe, n_dec, s >= p.warmup);
    int cnt = 0;
    for (int a0 = 0; a0 < n_new; a0 += 32) {
      Lane<int> rid, n;
      w.each([&](int l) {
        rid[l] = wadd(rid0, a0 + l);
        n[l] = prefill_pages(a0 + l, n_new, rid0);
      });
      cnt += emit(w, sink, rid, n, K_PREFILL, cnt);
    }
    for (int j0 = 0; j0 < SB; j0 += 32) {
      Lane<int> rid, n;
      w.each([&](int l) {
        const int j = j0 + l;
        rid[l] = j < SB ? st.s_rid[j] : -1;
        n[l] = j < SB ? probe_pages(j) : 0;
      });
      emit(w, sink, rid, n, K_PROBE, 0);
    }
    for (int j0 = 0; j0 < SB; j0 += 32) {
      Lane<int> rid, n;
      w.each([&](int l) {
        const int j = j0 + l;
        rid[l] = j < SB ? st.s_rid[j] : -1;
        n[l] = j < SB ? decode_pages(j) : 0;
      });
      cnt += emit(w, sink, rid, n, K_DECODE, cnt);
    }

    // 6. advance one token, retire the finished, count occupancy
    Lane<int> c_occ, c_ret, c_q;
    w.each([&](int l) {
      int o = 0, r = 0, v = 0;
      for (int j = l; j < SB; j += 32) {
        if (st.s_rid[j] < 0) continue;
        ++o;
        st.s_done[j] = wadd(st.s_done[j], 1);
        if (st.s_done[j] >= st.s_max[j]) {
          st.s_rid[j] = -1;
          ++r;
        }
      }
      for (int q = l; q < Q; q += 32) v += st.q_rid[q] >= 0;
      c_occ[l] = o;
      c_ret[l] = r;
      c_q[l] = v;
    });
    const int occ = w.sum(c_occ), qlen = w.sum(c_q);
    sv[SV_ARRIVED] += (unsigned)n_new;
    sv[SV_DROPPED] += (unsigned)wsub(want, n_new);
    sv[SV_ADMITTED] += (unsigned)n_adm;
    sv[SV_RETIRED] += (unsigned)w.sum(c_ret);
    sv[SV_PREEMPTED] += pe ? 1u : 0u;
    sv[SV_PROBES] += (unsigned)n_probe;
    sv[SV_OCC] += (unsigned)occ;
    sv[SV_QLEN] += (unsigned)qlen;
    now = wadd(now, p.cps);
    return StepOut{occ, qlen, n_new};
  }
};

}  // namespace sched

#undef SCHED_HD
#undef SCHED_DEV
