// window_ctl.cuh — the FR-FCFS window engine's admission and selection
// (controller/engine.py::_make_window_step, steps 1 and 2, and the core
// and window bookkeeping of step 5) over the 32 lanes of one warp.
//
// The window entry of sim_step.cu runs a point's window engine on one
// warp (another stages its streams); this header is that warp's
// controller, and the service (lane 0's Dram::service under the rank's
// ACT floor) stays in the kernel.  Two controllers make the same
// decisions: Ctl, below, for any size, and FastCtl, after it, for at most
// 32 cores and 32 slots, in fewer instructions on the step's chain.  Every
// quantity a decision reads lives in the lanes' registers and changes
// only when what it depends on changes:
//  - cores: lane k owns core k (with more than 32 cores, cores k, k + 32,
//    ... whose state is parked in shared memory, the earliest of them in
//    the lane's registers, as the scan entries' run_point keeps them).
//    The lane keeps its core's front request and the one after it, its
//    last issue, the MSHR slot the front waits on and the one after it,
//    whether its youngest admitted request is served and when it
//    completes, and the front's issue time, INF when it is ineligible.
//    Only the core's own admission and the service of one of its own
//    requests change any of them (engine.admit_one reads nothing else of
//    the point), so the issue time is recomputed then and nowhere else;
//  - slots: slot j lives on lane j % 32 (slots past 32 in shared memory,
//    strided).  A lane keeps its slot's key, (hit ? 0 : HIT_PENALTY) +
//    its admission sequence, and the slot's bank and row.  Only the
//    served bank's open row changes in a step, so after a service only
//    the slots on that bank recompute their hit bit;
//  - the clock, the occupancy, the admission count and the first 32
//    slots' occupancy mask are the same on every lane.
// In Ctl an admission attempt is one reduction of the lanes' issue times
// and the clock / occupancy test; a successful one adds a ballot for the
// first tied core (a reduction past 32 cores) and two shuffles that hand
// the front's bank and row to the slot's lane; the first free slot is the
// mask's lowest clear bit.  The selection is one reduction of the keys
// and a ballot for the winner: every key holds a distinct admission
// sequence, so two never tie.
//
// Written over serve_sched.cuh's lane abstraction (Lane<T>, w.each and
// the collectives), so the same text builds as host C++, where it runs as
// a sequential emulation of the lanes (tests/test_torch_window_ctl.py).
//
// Semantics follow repro.controller.engine bit for bit: int32 wraps,
// argmin ties go to the first index.

#pragma once

#include "serve_sched.cuh"

#ifdef __CUDACC__
#define WCTL_HD __host__ __device__ __forceinline__
#define WCTL_DEV __device__ __forceinline__
#else
#define WCTL_HD inline
#define WCTL_DEV inline
#endif

namespace winctl {

using sched::I32_MAX;
using sched::imax;
using sched::INF;
using sched::Lane;
using sched::wadd;
using sched::Warp;

#ifdef __CUDACC__
using Rec = int4;
#else
struct Rec {
  int x, y, z, w;
};
#endif

// The selection key of a window entry that is not a row hit
// (controller/engine.py HIT_PENALTY); the admission sequence must stay
// below it (the launcher refuses streams that could reach it), so
// key & (HIT_PENALTY - 1) is the sequence and a miss never meets a hit.
constexpr int HIT_PENALTY = 1 << 26;
constexpr int SEQ_MASK = HIT_PENALTY - 1;
// The key of a free slot
constexpr int NO_KEY = I32_MAX;

// A staged request's record, as sim_step.cu's Feed makes it: x the gap,
// y the folded row, z the folded bank (low 16 bits) and its row's HCRAC
// set (high), w the flags below and the bank's channel above them.
enum { R_WRITE = 1, R_DEP = 2, R_NS = 4, R_CH_SHIFT = 3 };

// A core on its owner lane.
struct Core {
  int k;                  // the core, -1 for none
  int p, len;             // the front's position, the stream's length
  int ri;                 // the front's MSHR slot, p mod M
  int last;               // the last issue
  int yg_served, yg_done;  // the youngest admitted request: served?, done
  int cur_done, cur_served;  // the front's MSHR slot: occupant's done, served
  int nxt_done, nxt_served;  // the slot after it (M > 1)
  int issue;              // the front's issue time, INF when ineligible
  Rec front, next;        // the front request and the one after it
};

// engine.admit_one's issue time of a core's front: max(last issue + gap,
// its MSHR slot's completion, the youngest's completion if dependent);
// INF past the stream, while the slot's occupant is unserved, or while a
// dependent front's youngest is unserved.
WCTL_HD int issue_of(const Core& c) {
  const bool dep = (c.front.w & R_DEP) != 0;
  const bool elig =
      c.p < c.len && c.cur_served != 0 && (!dep || c.yg_served != 0);
  int t = imax(wadd(c.last, c.front.x), c.cur_done);
  t = imax(t, dep ? c.yg_done : 0);
  return elig ? t : INF;
}

// A slot's selection key: row hits first, then the admission sequence.
WCTL_HD int key_of(bool hit, int seq) { return (hit ? 0 : HIT_PENALTY) + seq; }

// The service's inputs and what the owner needs back, of a slot: the
// request's record, then its core, position, MSHR slot and arrival.
struct Slot {
  Rec rec;
  Rec aux;  // x core, y position, z MSHR slot, w arrival
};

// Shared memory the controller reads and writes.  Per core (the owner
// lane alone writes): the MSHR ring's completions and served flags [C, M],
// and, parked past 32 cores, its position, MSHR slot, issue time, last
// issue, youngest's state and its two records.  Per slot: its record and
// aux (the owner of its core writes them at admission, every lane reads
// them at selection) and, for slots past the first 32, the key.
struct Mem {
  int *ring, *ring_served;
  const int* len;
  int *pk_p, *pk_ri, *pk_iss, *pk_last, *pk_ys, *pk_yd;
  Rec *pk_front, *pk_next;
  Slot* slots;
  int* skey;
  const int* open_row;  // the banks' open rows (lane 0's service writes)
};

// One point's controller on a warp.  ``Src`` hands over core c's records:
//   first(c, i)  the record at position i < 2 (already staged);
//   record(c, p) the record at position p >= 2, p below the stream's
//                length (on the core's owner lane, in increasing p).
template <class Src>
struct Ctl {
  int C, M, WN, cap;
  bool many;
  Mem m;
  Src src;
  Lane<Core> me;
  // the lane's first slot (j = lane): key, bank, row; the lane's least
  // key over its slots and that slot
  Lane<int> key0, bank0, row0, bkey, bslot;
  // the same on every lane
  int now, occ, seq;
  unsigned used0;  // slots 0..31 occupied

  WCTL_HD int next_ri(int r) const { return r + 1 == M ? 0 : r + 1; }

  // ----- cores -------------------------------------------------------

  WCTL_DEV Core load(int k) const {
    Core c;
    c.k = k;
    c.p = m.pk_p[k];
    c.len = m.len[k];
    c.ri = m.pk_ri[k];
    c.last = m.pk_last[k];
    c.yg_served = m.pk_ys[k];
    c.yg_done = m.pk_yd[k];
    c.cur_done = m.ring[k * M + c.ri];
    c.cur_served = m.ring_served[k * M + c.ri];
    const int r2 = next_ri(c.ri);
    c.nxt_done = m.ring[k * M + r2];
    c.nxt_served = m.ring_served[k * M + r2];
    c.issue = m.pk_iss[k];
    c.front = m.pk_front[k];
    c.next = m.pk_next[k];
    return c;
  }
  WCTL_DEV void park(const Core& c) const {
    const int k = c.k;
    m.pk_p[k] = c.p;
    m.pk_ri[k] = c.ri;
    m.pk_last[k] = c.last;
    m.pk_ys[k] = c.yg_served;
    m.pk_yd[k] = c.yg_done;
    m.pk_iss[k] = c.issue;
    m.pk_front[k] = c.front;
    m.pk_next[k] = c.next;
  }
  // The lane's earliest core (the first on ties), from the parked issue
  // times.
  WCTL_DEV Core earliest(int l) const {
    int best = l;
    for (int k = l + 32; k < C; k += 32)
      if (m.pk_iss[k] < m.pk_iss[best]) best = k;
    return load(best);
  }

  // Every lane: the cores' position 0 (the engines' initial state: no
  // issue, every MSHR slot served at cycle 0), the empty window.  The
  // ring arrays are zeroed / set by the caller.
  WCTL_DEV void init(const Warp& w, int C_, int M_, int WN_, int cap_) {
    C = C_;
    M = M_;
    WN = WN_;
    cap = cap_;
    many = C > 32;
    now = occ = seq = 0;
    used0 = 0u;
    w.each([&](int l) {
      Core c{};
      c.k = -1;
      c.issue = INF;
      for (int k = l; k < C; k += 32) {
        Core n{};
        n.k = k;
        n.len = m.len[k];
        n.yg_served = n.cur_served = n.nxt_served = 1;
        n.front = src.first(k, 0);
        n.next = src.first(k, 1);
        n.issue = issue_of(n);
        if (many) park(n);
        if (k == l) c = n;
      }
      if (many) c = earliest(l);
      me[l] = c;
      key0[l] = bkey[l] = NO_KEY;
      bank0[l] = row0[l] = 0;
      bslot[l] = l;
    });
    for (int j = 32; j < WN; ++j) m.skey[j] = NO_KEY;
  }

  // The owner of core c admits its front at time t into slot j: the
  // slot's record, then the core's position, last issue, youngest and
  // MSHR slot move on, the next record is fetched a position ahead, and
  // the issue time is recomputed (past 32 cores: the core is parked and
  // the lane takes up its earliest one).
  WCTL_DEV void advance(Core& c, int j, int t) {
    m.slots[j].rec = c.front;
    m.slots[j].aux = Rec{c.k, c.p, c.ri, t};
    const int at = c.k * M;
    m.ring_served[at + c.ri] = 0;
    c.last = t;
    c.yg_served = 0;
    c.p += 1;
    if (M == 1) {
      c.cur_served = 0;
    } else {
      c.ri = next_ri(c.ri);
      c.cur_done = c.nxt_done;
      c.cur_served = c.nxt_served;
      const int r2 = next_ri(c.ri);
      c.nxt_done = m.ring[at + r2];
      c.nxt_served = m.ring_served[at + r2];
    }
    c.front = c.next;
    if (c.p + 1 < c.len) c.next = src.record(c.k, c.p + 1);
    c.issue = issue_of(c);
  }

  // The service of core c's request at position idx, MSHR slot q,
  // completing at done: the slot's ring entry and, if it is the youngest
  // admitted, the youngest's state; the issue time is recomputed.
  WCTL_DEV void notify(Core& c, int idx, int q, int done) const {
    if (q == c.ri) {
      c.cur_done = done;
      c.cur_served = 1;
    } else if (M > 1 && q == next_ri(c.ri)) {
      c.nxt_done = done;
      c.nxt_served = 1;
    }
    if (idx == c.p - 1) {
      c.yg_served = 1;
      c.yg_done = done;
    }
    c.issue = issue_of(c);
  }

  // ----- slots -------------------------------------------------------

  // Lane l's least key over its slots (the first slot on ties; keys of
  // live slots never tie).
  WCTL_DEV void rekey(int l) {
    int k = key0[l], s = l;
    for (int j = l + 32; j < WN; j += 32)
      if (m.skey[j] < k) {
        k = m.skey[j];
        s = j;
      }
    bkey[l] = k;
    bslot[l] = s;
  }
  // The first free slot (there is one: occ < cap <= WN).
  WCTL_DEV int first_free(const Warp& w) const {
    const unsigned span = WN >= 32 ? 0xffffffffu : (1u << WN) - 1u;
    const unsigned f = ~used0 & span;
    if (f) return sched::ffs(f) - 1;
    for (int j0 = 32; j0 < WN; j0 += 32) {
      Lane<bool> fr;
      w.each([&](int l) {
        fr[l] = j0 + l < WN && m.skey[j0 + l] == NO_KEY;
      });
      const unsigned b = w.ballot(fr);
      if (b) return j0 + sched::ffs(b) - 1;
    }
    return -1;
  }

  // ----- a step ------------------------------------------------------

  // One admission attempt (engine.admit_one): the earliest-issue eligible
  // core's front enters the first free slot if the window has room and
  // the request has arrived (an empty window instead moves the clock up
  // to it).  Returns whether it admitted; a failed attempt changes
  // nothing, so the step's later attempts would fail too.
  WCTL_DEV bool admit(const Warp& w) {
    Lane<int> iss;
    w.each([&](int l) { iss[l] = me[l].issue; });
    const int t = w.min(iss);
    if (!(occ < cap && t < INF && (t <= now || occ == 0))) return false;
    int c;
    if (many) {
      Lane<int> kk;
      w.each([&](int l) { kk[l] = me[l].issue == t ? me[l].k : I32_MAX; });
      c = w.min(kk);
    } else {
      Lane<bool> tie;
      w.each([&](int l) { tie[l] = me[l].issue == t; });
      c = sched::ffs(w.ballot(tie)) - 1;
    }
    const int o = c & 31;
    const int j = first_free(w);
    // the front's bank and row reach the slot's lane
    Lane<int> zb, yr;
    w.each([&](int l) {
      zb[l] = me[l].front.z;
      yr[l] = me[l].front.y;
    });
    const int bank = w.get(zb, o) & 0xffff;
    const int row = w.get(yr, o);
    const int q = seq;
    w.each([&](int l) {
      if (l == o) {
        advance(me[l], j, t);
        if (many) {
          park(me[l]);
          me[l] = earliest(l);
        }
      }
      if (l == (j & 31)) {
        const int key = key_of(m.open_row[bank] == row, q);
        if (j < 32) {
          key0[l] = key;
          bank0[l] = bank;
          row0[l] = row;
        } else {
          m.skey[j] = key;
        }
        rekey(l);
      }
    });
    if (j < 32) used0 |= 1u << j;
    if (occ == 0) now = imax(now, t);
    ++occ;
    ++seq;
    return true;
  }

  // The FR-FCFS selection: the slot of the least key (row hits first,
  // then the oldest admission), or -1 when the window is empty.
  WCTL_DEV int select(const Warp& w) const {
    const int g = w.min(bkey);
    if (g == NO_KEY) return -1;
    Lane<bool> win;
    w.each([&](int l) { win[l] = bkey[l] == g; });
    const int L = sched::ffs(w.ballot(win)) - 1;
    return WN <= 32 ? L : w.get(bslot, L);
  }

  // After slot e's service (``s``: its record and aux, as every lane read
  // them) completed at ``done`` and left its bank's open row at
  // ``open``, with the clock moved to ``now_``: the slot is freed, the
  // other slots on that bank recompute their hit bit, and the owner of
  // the request's core takes the completion.
  WCTL_DEV void served(const Warp& w, int e, const Slot& s, int done,
                        int open, int now_) {
    const int bank = s.rec.z & 0xffff;
    const int cc = s.aux.x;
    w.each([&](int l) {
      if (l == (e & 31)) {
        if (e < 32)
          key0[l] = NO_KEY;
        else
          m.skey[e] = NO_KEY;
      }
      if (key0[l] != NO_KEY && bank0[l] == bank)
        key0[l] = key_of(row0[l] == open, key0[l] & SEQ_MASK);
      for (int j = l + 32; j < WN; j += 32) {
        const int k = m.skey[j];
        if (k != NO_KEY && (m.slots[j].rec.z & 0xffff) == bank)
          m.skey[j] = key_of(m.slots[j].rec.y == open, k & SEQ_MASK);
      }
      rekey(l);
      if (l == (cc & 31)) {
        const int at = cc * M + s.aux.z;
        m.ring[at] = done;
        m.ring_served[at] = 1;
        if (me[l].k == cc) {
          notify(me[l], s.aux.y, s.aux.z, done);
          if (many) park(me[l]);
        } else {
          // a parked core: an issue time only falls when its request is
          // served, so it may take over the lane
          Core o = load(cc);
          notify(o, s.aux.y, s.aux.z, done);
          park(o);
          if (o.issue < me[l].issue ||
              (o.issue == me[l].issue && cc < me[l].k))
            me[l] = o;
        }
      }
    });
    if (e < 32) used0 &= ~(1u << e);
    --occ;
    now = now_;
  }
};

// The controller of a point with at most 32 cores and 32 window slots,
// the common case: core k and slot k on lane k.  The same decisions as
// Ctl, in fewer instructions on the step's serial chain:
//  - every lane runs one instruction stream; the owner's and the slot
//    lane's updates are selects on their lane, not branches of their own;
//  - an admission sets the owner's next issue time straight from its
//    registers (the front after it, the MSHR slot after it), and the rest
//    of the owner's bookkeeping (the slot's record, the staged record
//    after it, the MSHR prefetch) waits until the next reduction is in
//    flight;
//  - each lane keeps whether its core's front is a row hit now, so an
//    admitted request's key is one shuffle from its owner;
//  - the selection's best key is carried across the step: after a
//    service one reduction finds the best remaining key, and each
//    admission compares its own key with it (a ballot names the older
//    slot only when it wins).
template <class Src>
struct FastCtl {
  int C, M, WN, cap;
  Mem m;
  Src src;
  Lane<Core> me;
  // the lane's slot: its key, bank and row; its core's front: 0 if it is
  // a row hit on its bank's open row, else HIT_PENALTY
  Lane<int> key0, bank0, row0, fhit;
  // the same on every lane
  int now, occ, seq;
  unsigned used0;
  int best, best_slot;  // the window's least key; its slot, -1 for ballot
  int pend_c, pend_j, pend_t;  // an admission whose bookkeeping waits

  WCTL_HD int next_ri(int r) const { return r + 1 == M ? 0 : r + 1; }
  WCTL_DEV int hit_base(const Rec& r) const {
    return m.open_row[r.z & 0xffff] == r.y ? 0 : HIT_PENALTY;
  }

  WCTL_DEV void init(const Warp& w, int C_, int M_, int WN_, int cap_) {
    C = C_;
    M = M_;
    WN = WN_;
    cap = cap_;
    now = occ = seq = 0;
    used0 = 0u;
    best = NO_KEY;
    best_slot = pend_c = -1;
    pend_j = pend_t = 0;
    w.each([&](int l) {
      Core n{};
      n.k = -1;
      n.issue = INF;
      fhit[l] = HIT_PENALTY;
      if (l < C) {
        n.k = l;
        n.len = m.len[l];
        n.yg_served = n.cur_served = n.nxt_served = 1;
        n.front = src.first(l, 0);
        n.next = src.first(l, 1);
        n.issue = issue_of(n);
        fhit[l] = hit_base(n.front);
      }
      me[l] = n;
      key0[l] = NO_KEY;
      bank0[l] = row0[l] = 0;
    });
  }

  // The waiting bookkeeping of the last admission, on its owner: the
  // slot's record, the MSHR slot's occupant, the core's position and its
  // staged records, the MSHR prefetch and the front's hit.  Its issue
  // time is already set.
  WCTL_DEV void flush(const Warp& w) {
    if (pend_c < 0) return;
    w.each([&](int l) {
      if (l != pend_c) return;
      Core& c = me[l];
      m.slots[pend_j].rec = c.front;
      m.slots[pend_j].aux = Rec{c.k, c.p, c.ri, pend_t};
      const int at = c.k * M;
      m.ring_served[at + c.ri] = 0;
      c.last = pend_t;
      c.yg_served = 0;
      c.p += 1;
      if (M == 1) {
        c.cur_served = 0;
      } else {
        c.ri = next_ri(c.ri);
        c.cur_done = c.nxt_done;
        c.cur_served = c.nxt_served;
        const int r2 = next_ri(c.ri);
        c.nxt_done = m.ring[at + r2];
        c.nxt_served = m.ring_served[at + r2];
      }
      c.front = c.next;
      if (c.p + 1 < c.len) c.next = src.record(c.k, c.p + 1);
      fhit[l] = hit_base(c.front);
    });
    pend_c = -1;
  }

  // One admission attempt, as Ctl::admit.
  WCTL_DEV bool admit(const Warp& w) {
    Lane<int> iss;
    w.each([&](int l) { iss[l] = me[l].issue; });
    const int t = w.min(iss);
    flush(w);
    if (!(occ < cap && t < INF && (t <= now || occ == 0))) return false;
    Lane<bool> tie;
    w.each([&](int l) { tie[l] = me[l].issue == t; });
    const int c = sched::ffs(w.ballot(tie)) - 1;
    const unsigned span = WN >= 32 ? 0xffffffffu : (1u << WN) - 1u;
    const int j = sched::ffs(~used0 & span) - 1;
    Lane<int> kb, zb, yr;
    w.each([&](int l) {
      kb[l] = fhit[l];
      zb[l] = me[l].front.z;
      yr[l] = me[l].front.y;
    });
    const int key = w.get(kb, c) + seq;
    const int bank = w.get(zb, c) & 0xffff;
    const int row = w.get(yr, c);
    w.each([&](int l) {
      Core& o = me[l];
      // the owner's issue time after the admission (issue_of of the
      // state flush leaves: no issue, its youngest unserved)
      const bool ok = o.p + 1 < o.len && M > 1 && o.nxt_served != 0 &&
                      (o.next.w & R_DEP) == 0;
      const int na = ok ? imax(imax(wadd(t, o.next.x), o.nxt_done), 0) : INF;
      if (l == c) o.issue = na;
      if (l == j) {
        key0[l] = key;
        bank0[l] = bank;
        row0[l] = row;
      }
    });
    if (key < best) {
      best = key;
      best_slot = j;
    }
    pend_c = c;
    pend_j = j;
    pend_t = t;
    used0 |= 1u << j;
    if (occ == 0) now = imax(now, t);
    ++occ;
    ++seq;
    return true;
  }

  // The FR-FCFS selection, as Ctl::select; the admissions' bookkeeping is
  // done (the slots' records are in shared memory) when it returns.
  WCTL_DEV int select(const Warp& w) {
    flush(w);
    if (best == NO_KEY) return -1;
    if (best_slot >= 0) return best_slot;
    Lane<bool> win;
    w.each([&](int l) { win[l] = key0[l] == best; });
    return sched::ffs(w.ballot(win)) - 1;
  }

  // After slot e's service, as Ctl::served; then the best remaining key.
  WCTL_DEV void served(const Warp& w, int e, const Slot& s, int done,
                       int open, int now_) {
    const int bank = s.rec.z & 0xffff;
    const int cc = s.aux.x;
    w.each([&](int l) {
      if (l == e) key0[l] = NO_KEY;
      if (key0[l] != NO_KEY && bank0[l] == bank)
        key0[l] = key_of(row0[l] == open, key0[l] & SEQ_MASK);
      Core& o = me[l];
      if ((o.front.z & 0xffff) == bank)
        fhit[l] = o.front.y == open ? 0 : HIT_PENALTY;
      if (l == cc) {
        const int at = cc * M + s.aux.z;
        m.ring[at] = done;
        m.ring_served[at] = 1;
        if (s.aux.z == o.ri) {
          o.cur_done = done;
          o.cur_served = 1;
        } else if (M > 1 && s.aux.z == next_ri(o.ri)) {
          o.nxt_done = done;
          o.nxt_served = 1;
        }
        if (s.aux.y == o.p - 1) {
          o.yg_served = 1;
          o.yg_done = done;
        }
        o.issue = issue_of(o);
      }
    });
    used0 &= ~(1u << e);
    --occ;
    now = now_;
    best = w.min(key0);
    best_slot = -1;
  }
};

}  // namespace winctl

#undef WCTL_HD
#undef WCTL_DEV
