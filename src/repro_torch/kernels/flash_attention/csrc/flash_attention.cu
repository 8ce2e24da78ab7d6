// flash_attention.cu — causal / sliding-window GQA prefill attention.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (the Pallas kernel _attn_kernel): for every query row of every head, an
// online softmax in f32 over KV tiles, with the kernel's own positions
// (query i and key j at i and j), the masks j < Skv, i >= j (causal) and
// i - j < window, the finite mask value -1e30, scale 1/sqrt(hd), query
// head h = k * G + g under KV head k, and the output acc / max(l, 1e-30)
// cast to the input type (bf16 or f32).
//
// Bound on the card.  The work is 4 * hd operations per valid (query,
// key) pair against 2 * hd * 2 bytes per query and key row read once.
// At hd 64 a B 1 x S 4 096 causal prefill is bound by operations (68.7
// GFLOP, 0.069 ms at the 989 TFLOP/s of the bf16 tensor cores), a B 4 x
// S 500 one by bytes (18.4 MB, 0.0055 ms at 3.35 TB/s): short prompts are
// launch- and latency-bound, long ones need the tensor cores.  The Pallas
// kernel keeps p in f32, and the f32 limits against the plain version
// hold only if P V does too: P enters the product as two bf16 operands,
// p_hi = bf16(p) and p_lo = bf16(p - p_hi) (|p - p_hi - p_lo| <= 2^-16
// |p|), so the kernel makes 6 hd operations a valid pair and two thirds
// of the bound is its ceiling.  Beside the products each pair costs an
// exp2 on the SFU and about seven other operations (the scale, the max,
// the sum, the split): at hd 64 these take about as long as the
// products.
//
// bf16 inputs: FlashAttention-3's shape on Hopper's wgmma fed by TMA
// (flash_fwd_wgmma_kernel<HDP, NK, LSE>, parts in wgmma_tma.cuh, shared
// with the backward entries below).  A block owns 128 query rows of one
// (batch, head); the grid is (ceil(S / 128), B * H), the last query
// tiles (the most keys under a causal mask) scheduled first.  Two
// consumer warpgroups own 64 rows each; thread 0 also issues the TMA
// loads: Q once (128-byte swizzle, HDP / 64 subtiles of 64 dims, HDP = hd
// rounded up to 64), then K and V tiles of NK chunks of 64 keys into a
// ring of mbarrier-guarded stages kept ahead of the consumers.  Rows past
// S or Skv and dims past hd arrive as zeros.  Per tile a warpgroup makes
// S = Q K^T (wgmma, both operands in shared memory, K K-major; one
// m64n128k16 a k-step over a two-chunk tile) into f32 accumulators, then
// takes one chunk at a time as the mma.sync kernel this one replaced took
// a tile of 64 keys: the scale to log2 units, the masks where the tile
// meets a mask's edge or the ragged end of Skv (two compares a pair
// against its row's key limits; tiles inside the masks test none), the
// online softmax in registers (a quad of lanes shares a row), O's
// correction, and O += P V, P's hi and lo halves taken from the S
// accumulators as register A operands, V read MN-major from the same
// stage.  The second chunk's softmax runs under the first's P V.  Every
// sum is taken in that kernel's order (k-steps of 16, chunks of 64 keys,
// p added to l two at a time), and wgmma rounds as mma.sync does, so the
// outputs are that kernel's, bit for bit, and everything downstream (the
// LM and training gates) is unmoved.  Tiles that every row of the block
// masks (above the causal diagonal, before the window) are skipped: for a
// row with a valid key the Pallas kernel's result does not depend on them
// (their p is 0, or is cleared by the correction exp(-1e30 - m) = 0 once
// a valid chunk arrives), and the chunks a 128-row block visits beyond a
// 64-row block's change no bit.  A warpgroup whose rows all lie past S
// does nothing.  The host picks NK (fwd_chunks): 2 at HDP 128, 1 above
// (a thread's 96 or 128 O accumulators; hd 256 runs in one block a query
// tile, so Q K^T is made once).  At hd 64, where the softmax costs about
// what the products do, NK is 1 where Skv fits a chunk, and a grid of
// more blocks than SMs also takes NK 1 at 121 registers, so that two
// blocks share an SM, one's softmax under the other's products.  The LSE instantiation
// is the same body with two more writes at the end, so its O is the
// serving instantiation's, bit for bit.  The model's [B, S, H, hd] layout
// is read through strides (rows 16-byte aligned) by the tensor maps,
// encoded on the host at every launch.
//
// f32 inputs keep the CUDA-core kernel (flash_attention_kernel): R = HDP
// / 32 threads share one query row (HDP = hd rounded up to 32, 64, 128 or
// 256), each owning 32 of its dims as 8 float4 groups, dims 4 * (c + R *
// i) + t for lane c of the row, so the R lanes read neighbouring 16-byte
// words of a shared-memory row.  The query rows and the running m, l and
// acc live in registers.  K and V tiles of 32 keys are staged in shared
// memory as f32 (8 loads a thread in flight before any store; 16 keys a
// tile at HDP 256, so that the two tiles stay within 48 KB).  A
// tile's scores are formed first (an R-lane shuffle sum per key),
// then the tile max, the correction and the p * V update, with the same
// tile skipping.
//
// Training (flash_attention_lse_launch and the flash_bwd_* entries below):
// the bf16 forward also writes each row's log-sum-exp, and a
// FlashAttention-2 backward on wgmma and TMA recomputes P from it; no
// Pallas kernel has a backward, these stand in for XLA's differentiation
// of repro's layers.blocked_attention (repro's training path).
//
// Built by repro_torch/_build.py with nvcc for sm_90a, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"
#include "wgmma_tma.cuh"

namespace {

// ------------------------------------------------ f32 path on the CUDA cores

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int BKV = 32;
constexpr int LOADS = 8;

// keys a tile of the f32 kernel: 32, or 16 at HDP 256 (2 x 32 KB of f32
// K and V tiles)
template <int HDP>
__host__ __device__ constexpr int f32_tile_keys() {
  return HDP > 128 ? BKV / 2 : BKV;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

struct Strides {
  long long b, s, h;  // in elements; the head dim is contiguous
};

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int Skv, int H, int K, int hd, Strides qs,
                           Strides ks, Strides vs, Strides os, int causal,
                           int window, float scale) {
  constexpr int R = HDP / 32;       // threads per query row
  constexpr int BQ = THREADS / R;   // query rows per block
  constexpr int NG = 8;             // float4 groups per thread
  constexpr int TK = f32_tile_keys<HDP>();
  __shared__ __align__(16) float kt[TK * HDP];
  __shared__ __align__(16) float vt[TK * HDP];

  const int tid = threadIdx.x;
  const int c = tid % R;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + tid / R;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / K);
  const bool live = qi < S;

  float qr[4 * NG], acc[4 * NG];
  const T* qp = q + b * qs.b + (long long)(live ? qi : 0) * qs.s + h * qs.h;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 4 * (c + R * i) + t;
      qr[4 * i + t] = (live && d < hd) ? to_f32(qp[d]) : 0.f;
      acc[4 * i + t] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  // keys past the block's last query row are all masked (causal), keys
  // at or before its first row minus the window too
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int kv_start = window ? (max(0, q0 - window + 1) / TK) * TK : 0;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int t0 = kv_start; t0 < kv_end; t0 += TK) {
    __syncthreads();
    // LOADS elements of K and V a thread in flight before any is stored
    for (int base = tid; base < TK * HDP; base += LOADS * THREADS) {
      float kx[LOADS], vx[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int idx = base + u * THREADS;
        const int j = t0 + idx / HDP;
        const int d = idx % HDP;
        const bool in = idx < TK * HDP && j < Skv && d < hd;
        kx[u] = in ? to_f32(kb[(long long)j * ks.s + d]) : 0.f;
        vx[u] = in ? to_f32(vb[(long long)j * vs.s + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int idx = base + u * THREADS;
        if (idx < TK * HDP) {
          kt[idx] = kx[u];
          vt[idx] = vx[u];
        }
      }
    }
    __syncthreads();

    float s[TK];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(kt + j * HDP);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float4 kk = kr[c + R * i];
        dot += qr[4 * i] * kk.x + qr[4 * i + 1] * kk.y +
               qr[4 * i + 2] * kk.z + qr[4 * i + 3] * kk.w;
      }
#pragma unroll
      for (int off = R / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kj = t0 + j;
      bool ok = kj < Skv;
      if (causal) ok = ok && qi >= kj;
      if (window) ok = ok && (qi - kj) < window;
      s[j] = ok ? dot * scale : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < 4 * NG; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vt + j * HDP);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float4 vv = vr[c + R * i];
        acc[4 * i] += p * vv.x;
        acc[4 * i + 1] += p * vv.y;
        acc[4 * i + 2] += p * vv.z;
        acc[4 * i + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* op = o + b * os.b + (long long)qi * os.s + h * os.h;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 4 * (c + R * i) + t;
      if (d < hd) op[d] = from_f32<T>(acc[4 * i + t] * inv);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Skv, int H, int K, int hd, Strides qs, Strides ks,
           Strides vs, Strides os, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int BQ = THREADS / (HDP / 32);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, HDP><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Skv, H, K, hd, qs, ks,
      vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int S, int Skv, int H, int K, Strides qs, Strides ks,
              Strides vs, Strides os, int causal, int window, float scale,
              cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, B, S, Skv, H, K, hd, qs, ks, vs, os,
                         causal, window, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, S, Skv, H, K, hd, qs, ks, vs, os,
                         causal, window, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, S, Skv, H, K, hd, qs, ks, vs, os,
                          causal, window, scale, stream);
  return launch<T, 256>(q, k, v, o, B, S, Skv, H, K, hd, qs, ks, vs, os,
                        causal, window, scale, stream);
}


// ------------------------------------------------ shared by the bf16 entries

using mma_tile::bf16;

constexpr int DOT_WARPS = 4;  // warps a block of the D entry
constexpr int DOT_THREADS = 32 * DOT_WARPS;
constexpr float LN2 = 0.6931471805599453f;

// The backward pass, bf16 in, f32 sums, no atomics: every gradient element
// is written by one thread, its sums taken in a fixed order (a group's
// heads summed in head order by flash_bwd_sum_kernel), so two runs give the
// same bits.
//
//   D    = rowsum(dO o O)                       (flash_bwd_dot_kernel)
//          O the f32 output as the LSE forward's bf16 output plus its
//          low halves: with the bf16 output alone, D's rounding
//          (2^-9 of each term) is magnified in dS = P o (dP - D) where
//          dP - D is small against dP (the keys' common offset), and a
//          bias gathering dQ over tokens (whisper-small's cross
//          attention) moved by over 1 %
//   P    = exp(S - LSE), S = Q K^T / sqrt(hd)   (recomputed, both below)
//   dV   = P^T dO,  dS = P o (dO V^T - D)
//   dK   = dS^T Q / sqrt(hd)                    (flash_bwd_dkdv_wgmma_kernel)
//   dQ   = dS K / sqrt(hd)                      (flash_bwd_dq_wgmma_kernel)
//
// Bound: 10 hd operations a valid (query, key) pair (five products: 2.5x
// the forward's).  The dQ entry makes S and dP again (no atomics), 14 hd
// in all: the ceiling is 5 / 7 of the bound.
//
// Design for Hopper (wgmma_tma.cuh).  A block is two consumer
// warpgroups.  Each owns 64 rows of the block's fixed tiles and runs its
// products on wgmma (m64n64k16, f32 accumulators): the first two with both
// operands in shared memory, each in its own commit group, so that the
// second runs on while P is formed from the first; then the products that
// take P^T or dS (dS^T) from registers as bf16 A operands, converted from
// the first products' accumulators, the first of them running on while dS
// is formed.  Thread 0 is also the producer: it issues the TMA loads of
// the fixed tiles and, at the top of each tile (no product in flight),
// keeps the ring BWD_AHEAD tiles ahead in BWD_STAGES stages, each guarded
// by a full and an empty mbarrier; warp 0 waits for it, so its lanes stay
// converged for wgmma, and with two stages of slack a warpgroup one tile
// behind the other does not hold it up.  No warp is a producer alone:
// with setmaxnreg (a third warpgroup giving up its registers to two
// consumers of 240) ptxas still held every thread to the launch's 168
// registers (three warps on each of the SM's four register files), spilled
// 2 956 bytes at hd 128 and serialised the wgmma products; a producer warp
// beside 256 threads costs the same.  Two warpgroups have 255 registers a
// thread.  Every stage is computed, masked pairs as zeros: a branch around
// the products, or producer work while products are in flight, made
// ptxas serialise them.  The element-wise passes come in two forms: tiles
// that meet a mask's edge (or the ends of S and Skv) test every pair, the
// others none (the mask's integer work was most of their cost).  Rows past
// S or Skv and dims past hd load as zeros (TMA's bounds).
//
// dK / dV (flash_bwd_dkdv_wgmma_kernel): a block per (batch, query head,
// 128 keys), K and V fixed, walking the 64-row Q / dO tiles (and their
// LSE and D rows) that see its keys; per tile a consumer makes S^T = K Q^T,
// dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.  A group of G > 1
// query heads shares its KV head's dK / dV: each block writes its head's
// f32 sums as partials and flash_bwd_sum_kernel adds a group's G partials
// in head order 0 .. G - 1 and rounds once to bf16 (G = 1 writes bf16
// directly).  The grid's slow dim is the key block, so under a causal mask
// the heaviest blocks (the first keys: every query tile) start first.
// dQ (flash_bwd_dq_wgmma_kernel): a block per (batch, head, 128 query
// rows), Q and dO fixed, walking the 64-key K / V tiles; per tile S = Q
// K^T, dP = dO V^T, dQ += dS K; the last query rows (the most keys) first.
// P and dS enter the second products as bf16 A operands; in the dQ
// product dS enters as two, hi = bf16(dS) and lo = bf16(dS - hi), both
// multiplied (one more product a k-step), as the forward splits P: keys
// with a common offset (whisper-small's decoder self-attention) magnify
// bf16 dS's rounding in dQ = dS K.  In the dK product the split moved
// whisper's train step further from its plain step, so dK takes bf16 dS.
// At hd 128 a thread holds 64 + 64 accumulators of dK and dV and 32 + 32
// of S^T and dP^T, so the query step stays at 64 rows; a head dim is
// HDP / 64 subtiles of 64 dims, so hd 256 adds subtiles, not new
// descriptors: there the two warpgroups share a block's 64 fixed rows and
// split the output dims (BwdSmem's SPLIT), each making the whole first
// products, in a ring of two stages.

constexpr int BWD_WG = 128;              // threads of a warpgroup
constexpr int BWD_THREADS = 2 * BWD_WG;  // two consumer warpgroups
constexpr int BWD_ROWS = 64;             // a consumer's rows; a tile's
constexpr int BWD_BLOCK = 2 * BWD_ROWS;  // a block's fixed rows
constexpr int BWD_STAGES = 4;
constexpr int BWD_AHEAD = 2;  // tiles the producer keeps ahead

// The shape of a backward block and its shared memory (bytes from a
// 1024-aligned base): the two fixed tensors (K and V, or Q and dO), each NB
// tiles of 64 rows of HDP / 64 subtiles; the ring's stages (two tiles of 64
// rows each); the stages' LSE and D rows (dK / dV); the barriers (fixed,
// full[s], empty[s]).  Up to HDP 128 a block's fixed rows are 128, 64 a
// warpgroup, each warpgroup making every output dim of its rows, with a
// 4-stage ring two tiles ahead.  At HDP 256 (SPLIT) the two warpgroups
// share one tile of 64 fixed rows and split the output dims, OC = 2
// subtiles each: both make the same first products S (S^T) and dP (dP^T)
// over all 256 dims, then each its 128 dims of the second products, so a
// thread holds 2 x 64 accumulators of dK and dV (or 64 of dQ) as at HDP
// 128.  The fixed tiles take 64 KB and a stage 64 KB, so the ring has two
// stages, one tile ahead: 194 KB of the SM's 227 KB.
template <int HDP>
struct BwdSmem {
  static constexpr bool SPLIT = HDP > 128;
  static constexpr int CB = HDP / 64;
  static constexpr int OC = SPLIT ? CB / 2 : CB;  // a warpgroup's out dims
  static constexpr int BLOCK = SPLIT ? BWD_ROWS : BWD_BLOCK;  // fixed rows
  static constexpr int NB = BLOCK / BWD_ROWS;  // fixed tiles a tensor
  static constexpr int STAGES = SPLIT ? 2 : BWD_STAGES;
  static constexpr int AHEAD = SPLIT ? 1 : BWD_AHEAD;
  static constexpr int SUB = hopper::SUBTILE;
  static constexpr int FIXED = 2 * NB * CB * SUB;
  static constexpr int STAGE = 2 * CB * SUB;
  static constexpr int ROWS = FIXED + STAGES * STAGE;
  static constexpr int BARS = ROWS + STAGES * 2 * BWD_ROWS * 4;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
  // a warpgroup's fixed tile and first output subtile
  __device__ static constexpr int tile(int wg) { return SPLIT ? 0 : wg; }
  __device__ static constexpr int out0(int wg) { return SPLIT ? wg * OC : 0; }
};

// the CB subtiles of one 64-row tile of a [B, S, H, hd] tensor map (rows
// row0.., head h, batch b) into shared memory at dst
template <int CB>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int row0,
                                         int b) {
#pragma unroll
  for (int c = 0; c < CB; ++c)
    hopper::tma_load_4d(dst + c * hopper::SUBTILE, map, bar, 64 * c, h, row0,
                        b);
}

// the warpgroup's 128 threads meet (named barrier 1 + warpgroup)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(BWD_WG) : "memory");
}

// acc (+)= A B^T over the k dim HDP: A and B 64-row K-major tiles of HDP / 64
// subtiles at shared addresses a and b
template <int HDP>
__device__ __forceinline__ void mma_rows(float (&acc)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int s = 0; s < HDP / 16; ++s) {
    const uint32_t off = (s / 4) * hopper::SUBTILE + (s % 4) * 32;
    hopper::mma_ss(acc, hopper::desc_sw128(a + off),
                   hopper::desc_sw128(b + off), s);
  }
}

// out[c] += X T over 64 rows of T (its k dim, 4 k-steps): X as the sum of
// N bf16 A operands a[0] (+ a[1]), each k-step's in that order; T a
// 64-row tile of HDP / 64 subtiles at shared address t, read MN-major;
// out[c] its dims 64 c .. 64 c + 63
template <int HDP, int N>
__device__ __forceinline__ void mma_cols(float (&out)[HDP / 64][32],
                                         const uint32_t (&a)[N][4][4],
                                         uint32_t t) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < HDP / 64; ++c) {
      const uint64_t d =
          hopper::desc_sw128(t + c * hopper::SUBTILE + s * 2048);
#pragma unroll
      for (int n = 0; n < N; ++n) hopper::mma_rs(out[c], a[n][s], d);
    }
  }
}

// a 64 x 64 product's accumulators x (4 k-steps) as N bf16 A operands:
// bf16(x), or (N 2) hi = bf16(x) and lo = bf16(x - hi)
template <int N>
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[N][4][4]) {
  static_assert(N == 1 || N == 2, "one operand, or hi and lo");
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if constexpr (N == 2)
      hopper::acc_to_a_split(x, s, a[0][s], a[1][s]);
    else
      hopper::acc_to_a(x, s, a[0][s]);
  }
}

// D of one query row is a sum over hd dims: LP lanes share a row (hd / 8
// rounded up to a power of two), each loading 16 bytes (8 bf16) of O, O_lo
// and dO, so a warp takes 32 / LP rows (256 / hd at a power-of-two hd);
// lanes past hd / 8 load nothing and add 0.  A lane sums its 8 products
// (O + O_lo) dO in dim order; the row's LP lanes then add their sums by a
// fixed butterfly of shuffles, offsets LP / 2, LP / 4, .., 1 (lane j adds
// lane j ^ off's sum at each), so two runs give the same bits.  Bound:
// bytes (three bf16 rows read, one f32 written).
template <int LP>
__global__ void __launch_bounds__(DOT_THREADS)
    flash_bwd_dot_kernel(const bf16* __restrict__ o,
                         const bf16* __restrict__ o_lo,
                         const bf16* __restrict__ dout,
                         float* __restrict__ dlt, int S, int H, int hd,
                         Strides os, Strides ls, Strides ds,
                         long long lse_row, long long rows) {
  constexpr int RPW = 32 / LP;  // rows a warp
  const int lane = threadIdx.x % 32, j = lane % LP;
  const long long row =
      ((long long)blockIdx.x * DOT_WARPS + threadIdx.x / 32) * RPW + lane / LP;
  const int s = (int)(row % S);
  const long long bh = row / S;
  float acc = 0.f;
  if (row < rows && 8 * j < hd) {
    const int b = (int)(bh / H), h = (int)(bh % H);
    const uint4 a = *reinterpret_cast<const uint4*>(
        o + b * os.b + s * os.s + h * os.h + 8 * j);
    const uint4 l = *reinterpret_cast<const uint4*>(
        o_lo + b * ls.b + s * ls.s + h * ls.h + 8 * j);
    const uint4 c = *reinterpret_cast<const uint4*>(
        dout + b * ds.b + s * ds.s + h * ds.h + 8 * j);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pl = reinterpret_cast<const __nv_bfloat162*>(&l);
    const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(pa[e]);
      const float2 y = __bfloat1622float2(pl[e]);
      const float2 z = __bfloat1622float2(pc[e]);
      acc += (x.x + y.x) * z.x + (x.y + y.y) * z.y;
    }
  }
#pragma unroll
  for (int off = LP / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (j == 0 && row < rows) dlt[bh * lse_row + s] = acc;
}

// Which (query, key) pairs a tile keeps: query i and key j at positions i
// and j, both in range, j <= i under a causal mask, i - j < window.
struct PairMask {
  int S, Skv, causal, window;
  __device__ __forceinline__ bool kept(int query, int key) const {
    bool ok = query < S && key < Skv;
    if (causal) ok = ok && query >= key;
    if (window) ok = ok && query - key < window;
    return ok;
  }
};

// P^T in place of a dK / dV tile's S^T accumulators (rows: keys key0 and
// key1 = key0 + 8, columns: queries q0 + 8 n + 2 t + {0, 1}), exp2 of the
// scaled score less the query's LSE (rows of shared memory); with MASK, 0
// where the pair is masked.  Then dS^T in place of dP^T: P (dP - D).
template <bool MASK>
__device__ __forceinline__ void p_cols(float (&sc)[32], const float* ls,
                                       float scale_log2, int q0, int key0,
                                       int t, const PairMask& m) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(ls + col);
    const float lo[2] = {l.x * mma_tile::LOG2E, l.y * mma_tile::LOG2E};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      const float p = mma_tile::fast_exp2(sc[i] * scale_log2 - lo[e & 1]);
      sc[i] = !MASK || m.kept(q0 + col + (e & 1), key0 + 8 * (e >> 1))
                  ? p : 0.f;
    }
  }
}
template <bool MASK>
__device__ __forceinline__ void ds_cols(float (&dp)[32], const float (&p)[32],
                                        const float* dd, int q0, int key0,
                                        int t, const PairMask& m) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * t;
    const float2 d = *reinterpret_cast<const float2*>(dd + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      const float ds = p[i] * (dp[i] - ((e & 1) ? d.y : d.x));
      dp[i] = !MASK || m.kept(q0 + col + (e & 1), key0 + 8 * (e >> 1))
                  ? ds : 0.f;
    }
  }
}

// P in place of a dQ tile's S accumulators (rows r0, r0 + 8 with their
// LSE in log2 units lse[2] and D d[2], columns: keys t0 + 8 n + 2 t +
// {0, 1}), then dS in place of dP
template <bool MASK>
__device__ __forceinline__ void p_rows(float (&sc)[32], float scale_log2,
                                       const float (&lse)[2], int r0, int t0,
                                       int t, const PairMask& m) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = mma_tile::fast_exp2(sc[i] * scale_log2 - lse[(i >> 1) & 1]);
    sc[i] = !MASK || m.kept(r0 + 8 * ((i >> 1) & 1),
                            t0 + 8 * (i >> 2) + 2 * t + (i & 1))
                ? p : 0.f;
  }
}
template <bool MASK>
__device__ __forceinline__ void ds_rows(float (&dp)[32], const float (&p)[32],
                                        const float (&d)[2], int r0, int t0,
                                        int t, const PairMask& m) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float ds = p[i] * (dp[i] - d[(i >> 1) & 1]);
    dp[i] = !MASK || m.kept(r0 + 8 * ((i >> 1) & 1),
                            t0 + 8 * (i >> 2) + 2 * t + (i & 1))
                ? ds : 0.f;
  }
}

template <int HDP>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_do,
                                const float* __restrict__ lse,
                                const float* __restrict__ dlt,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                float* __restrict__ dk_part,
                                float* __restrict__ dv_part, int S, int Skv,
                                int H, int K, int hd, Strides dks,
                                Strides dvs, long long lse_row, int causal,
                                int window, float scale_log2,
                                float scale) {
  using L = BwdSmem<HDP>;
  constexpr int CB = L::CB, SUB = L::SUB, OC = L::OC, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t fixed = base + L::BARS;
  const auto full = [&](int s) { return base + L::BARS + 8 * (1 + s); };
  const auto empty = [&](int s) {
    return base + L::BARS + 8 * (1 + STAGES + s);
  };
  const PairMask mask{S, Skv, causal, window};

  const int b = blockIdx.x / H, h = blockIdx.x % H, G = H / K, kh = h / G;
  const int k0 = blockIdx.y * L::BLOCK;
  // the query tiles that see a key of this block
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(S, k0 + L::BLOCK - 1 + window) : S;
  const int n_qt =
      q_end > q_begin ? (q_end - q_begin + BWD_ROWS - 1) / BWD_ROWS : 0;

  // the producer (thread 0): Q, dO, LSE and D of query tile j into stage
  // j % STAGES once both consumers have released its last tile
  const auto produce = [&](int j) {
    const int s = j % STAGES, q0 = q_begin + j * BWD_ROWS;
    hopper::mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
    hopper::mbar_expect_tx(full(s), L::STAGE + 2 * BWD_ROWS * 4);
    const uint32_t st = base + L::FIXED + s * L::STAGE;
    tma_tile<CB>(st, &map_q, full(s), h, q0, b);
    tma_tile<CB>(st + CB * SUB, &map_do, full(s), h, q0, b);
    const long long r = ((long long)b * H + h) * lse_row + q0;
    const uint32_t rows = base + L::ROWS + s * 2 * BWD_ROWS * 4;
    hopper::bulk_load(rows, lse + r, BWD_ROWS * 4, full(s));
    hopper::bulk_load(rows + BWD_ROWS * 4, dlt + r, BWD_ROWS * 4, full(s));
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(fixed, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 2);
    }
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(fixed, L::FIXED);
    for (int w = 0; w < L::NB; ++w) {
      tma_tile<CB>(base + w * CB * SUB, &map_k, fixed, kh, k0 + w * BWD_ROWS,
                   b);
      tma_tile<CB>(base + (L::NB + w) * CB * SUB, &map_v, fixed, kh,
                   k0 + w * BWD_ROWS, b);
    }
    for (int j = 0; j < L::AHEAD && j < n_qt; ++j) produce(j);
  }
  __syncthreads();

  // ---- the two consumer warpgroups: 64 keys each (SPLIT: the same 64
  // keys, the output dims split)
  const int wg = threadIdx.x / BWD_WG;
  const int tid = threadIdx.x % BWD_WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wk0 = k0 + L::tile(wg) * BWD_ROWS;
  const int key0 = wk0 + warp * 16 + g, key1 = key0 + 8;  // a thread's rows
  const uint32_t kt = base + L::tile(wg) * CB * SUB;
  const uint32_t vt = base + (L::NB + L::tile(wg)) * CB * SUB;
  const int c0 = L::out0(wg);  // this warpgroup's first output subtile

  float dka[OC][32], dva[OC][32];
#pragma unroll
  for (int c = 0; c < OC; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;
  }
  hopper::mbar_wait(fixed, 0);
  for (int it = 0; it < n_qt; ++it) {
    // no product in flight: warp 0 (its lane 0) keeps the ring BWD_AHEAD
    // tiles ahead, and stays converged for the products
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0 && it + L::AHEAD < n_qt)
        produce(it + L::AHEAD);
      __syncwarp();
    }
    const int s = it % STAGES, q0 = q_begin + it * BWD_ROWS;
    hopper::mbar_wait(full(s), (it / STAGES) & 1);
    const uint32_t qt = base + L::FIXED + s * L::STAGE;
    const uint32_t dt = qt + CB * SUB;
    const float* ls = reinterpret_cast<const float*>(
        smem + L::ROWS + s * 2 * BWD_ROWS * 4);
    const bool edge = (causal && q0 < wk0 + BWD_ROWS - 1) ||
                      (window && q0 + BWD_ROWS - 1 - wk0 >= window) ||
                      q0 + BWD_ROWS > S || wk0 + BWD_ROWS > Skv;
    float sc[32], dp[32];
    hopper::wg_fence();
    mma_rows<HDP>(sc, kt, qt);  // S^T: keys x queries
    hopper::wg_commit();
    mma_rows<HDP>(dp, vt, dt);  // dP^T = V dO^T
    hopper::wg_commit();
    hopper::wg_wait<1>();  // S^T is in; dP^T runs on under P
    hopper::fence_regs(sc);
    if (edge)
      p_cols<true>(sc, ls, scale_log2, q0, key0, t, mask);
    else
      p_cols<false>(sc, ls, scale_log2, q0, key0, t, mask);
    uint32_t pa[1][4][4], da[1][4][4];
    to_a(sc, pa);
    hopper::wg_fence();
    mma_cols<64 * OC>(dva, pa, dt + c0 * SUB);  // dV += P^T dO
    hopper::wg_commit();
    hopper::wg_wait<1>();  // dP^T is in; dV runs on under dS
    hopper::fence_regs(dp);
    if (edge)
      ds_cols<true>(dp, sc, ls + BWD_ROWS, q0, key0, t, mask);
    else
      ds_cols<false>(dp, sc, ls + BWD_ROWS, q0, key0, t, mask);
    to_a(dp, da);
    hopper::wg_fence();
    mma_cols<64 * OC>(dka, da, qt + c0 * SUB);  // dK += dS^T Q
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      hopper::fence_regs(dka[c]);
      hopper::fence_regs(dva[c]);
    }
    wg_sync(wg);  // every warp is past this stage's wait and reads
    if (tid == 0) hopper::mbar_arrive(empty(s));
  }

  // bf16 dK (scaled) and dV where the group is one head, else this head's
  // f32 partials
#pragma unroll
  for (int c = 0; c < OC; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = 64 * (c0 + c) + 8 * n + 2 * t;
      if (d >= hd) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = half ? key1 : key0;
        if (key >= Skv) continue;
        const float* x = dka[c] + 4 * n + 2 * half;
        const float* y = dva[c] + 4 * n + 2 * half;
        if (G == 1) {
          *reinterpret_cast<__nv_bfloat162*>(
              dk + b * dks.b + key * dks.s + kh * dks.h + d) =
              __floats2bfloat162_rn(x[0] * scale, x[1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(
              dv + b * dvs.b + key * dvs.s + kh * dvs.h + d) =
              __floats2bfloat162_rn(y[0], y[1]);
        } else {
          const long long o = (((long long)b * Skv + key) * H + h) * hd + d;
          *reinterpret_cast<float2*>(dk_part + o) = make_float2(x[0], x[1]);
          *reinterpret_cast<float2*>(dv_part + o) = make_float2(y[0], y[1]);
        }
      }
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ dlt,
                              bf16* __restrict__ dq, int S, int Skv, int H,
                              int K, int hd, Strides dqs, long long lse_row,
                              int causal, int window, float scale_log2,
                              float scale) {
  using L = BwdSmem<HDP>;
  constexpr int CB = L::CB, SUB = L::SUB, OC = L::OC, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t fixed = base + L::BARS;
  const auto full = [&](int s) { return base + L::BARS + 8 * (1 + s); };
  const auto empty = [&](int s) {
    return base + L::BARS + 8 * (1 + STAGES + s);
  };
  const PairMask mask{S, Skv, causal, window};

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BLOCK;
  // keys past the block's last row are all masked (causal), keys at or
  // before its first row minus the window too
  const int kv_end = causal ? min(Skv, q0 + L::BLOCK) : Skv;
  const int kv_start =
      window ? max(0, q0 - window + 1) / BWD_ROWS * BWD_ROWS : 0;
  const int n_kt =
      kv_end > kv_start ? (kv_end - kv_start + BWD_ROWS - 1) / BWD_ROWS : 0;

  // the producer (thread 0): K and V of key tile j into stage
  // j % STAGES once both consumers have released its last tile
  const auto produce = [&](int j) {
    const int s = j % STAGES, t0 = kv_start + j * BWD_ROWS;
    hopper::mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
    hopper::mbar_expect_tx(full(s), L::STAGE);
    const uint32_t st = base + L::FIXED + s * L::STAGE;
    tma_tile<CB>(st, &map_k, full(s), kh, t0, b);
    tma_tile<CB>(st + CB * SUB, &map_v, full(s), kh, t0, b);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(fixed, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 2);
    }
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(fixed, L::FIXED);
    for (int w = 0; w < L::NB; ++w) {
      tma_tile<CB>(base + w * CB * SUB, &map_q, fixed, h, q0 + w * BWD_ROWS,
                   b);
      tma_tile<CB>(base + (L::NB + w) * CB * SUB, &map_do, fixed, h,
                   q0 + w * BWD_ROWS, b);
    }
    for (int j = 0; j < L::AHEAD && j < n_kt; ++j) produce(j);
  }
  __syncthreads();

  // ---- the two consumer warpgroups: 64 query rows each (SPLIT: the same
  // 64 rows, the output dims split)
  const int wg = threadIdx.x / BWD_WG;
  const int tid = threadIdx.x % BWD_WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wq0 = q0 + L::tile(wg) * BWD_ROWS;
  const int r0 = wq0 + warp * 16 + g, r1 = r0 + 8;  // a thread's rows
  const uint32_t qt = base + L::tile(wg) * CB * SUB;
  const uint32_t dt = base + (L::NB + L::tile(wg)) * CB * SUB;
  const int c0 = L::out0(wg);  // this warpgroup's first output subtile
  const float* lb = lse + ((long long)b * H + h) * lse_row;
  const float* db = dlt + ((long long)b * H + h) * lse_row;
  const float lr[2] = {r0 < S ? lb[r0] * mma_tile::LOG2E : 0.f,
                       r1 < S ? lb[r1] * mma_tile::LOG2E : 0.f};
  const float dr[2] = {r0 < S ? db[r0] : 0.f, r1 < S ? db[r1] : 0.f};

  float dqa[OC][32];
#pragma unroll
  for (int c = 0; c < OC; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[c][i] = 0.f;
  }
  hopper::mbar_wait(fixed, 0);
  for (int it = 0; it < n_kt; ++it) {
    // no product in flight: warp 0 (its lane 0) keeps the ring BWD_AHEAD
    // tiles ahead, and stays converged for the products
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0 && it + L::AHEAD < n_kt)
        produce(it + L::AHEAD);
      __syncwarp();
    }
    const int s = it % STAGES, t0 = kv_start + it * BWD_ROWS;
    hopper::mbar_wait(full(s), (it / STAGES) & 1);
    const uint32_t kst = base + L::FIXED + s * L::STAGE;
    const uint32_t vst = kst + CB * SUB;
    const bool edge = (causal && t0 + BWD_ROWS - 1 > wq0) ||
                      (window && wq0 + BWD_ROWS - 1 - t0 >= window) ||
                      wq0 + BWD_ROWS > S || t0 + BWD_ROWS > Skv;
    float sc[32], dp[32];
    hopper::wg_fence();
    mma_rows<HDP>(sc, qt, kst);  // S = Q K^T
    hopper::wg_commit();
    mma_rows<HDP>(dp, dt, vst);  // dP = dO V^T
    hopper::wg_commit();
    hopper::wg_wait<1>();  // S is in; dP runs on under P
    hopper::fence_regs(sc);
    if (edge)
      p_rows<true>(sc, scale_log2, lr, r0, t0, t, mask);
    else
      p_rows<false>(sc, scale_log2, lr, r0, t0, t, mask);
    hopper::wg_wait<0>();
    hopper::fence_regs(dp);
    if (edge)
      ds_rows<true>(dp, sc, dr, r0, t0, t, mask);
    else
      ds_rows<false>(dp, sc, dr, r0, t0, t, mask);
    uint32_t da[2][4][4];  // dS as hi + lo
    to_a(dp, da);
    hopper::wg_fence();
    mma_cols<64 * OC>(dqa, da, kst + c0 * SUB);  // dQ += dS K
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int c = 0; c < OC; ++c) hopper::fence_regs(dqa[c]);
    wg_sync(wg);  // every warp is past this stage's wait
    if (tid == 0) hopper::mbar_arrive(empty(s));
  }

  bf16* qb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int c = 0; c < OC; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = 64 * (c0 + c) + 8 * n + 2 * t;
      if (d >= hd) continue;
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(qb + r0 * dqs.s + d) =
            __floats2bfloat162_rn(dqa[c][4 * n] * scale,
                                  dqa[c][4 * n + 1] * scale);
      if (r1 < S)
        *reinterpret_cast<__nv_bfloat162*>(qb + r1 * dqs.s + d) =
            __floats2bfloat162_rn(dqa[c][4 * n + 2] * scale,
                                  dqa[c][4 * n + 3] * scale);
    }
  }
}

// dK, dV of every KV head from its group's f32 partials dk_part / dv_part
// ([B, Skv, H, hd] contiguous, H = K G): a thread sums 4 dims over heads
// k G + 0 .. k G + G - 1 in that order, scales dK, rounds once to bf16.
// Bound: bytes (the partials read once, dK and dV written once).
__global__ void __launch_bounds__(256)
    flash_bwd_sum_kernel(const float* __restrict__ dk_part,
                         const float* __restrict__ dv_part,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int Skv, int K, int G, int hd, Strides dks,
                         Strides dvs, float scale, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int n4 = hd / 4;
  const long long row = i / n4;  // (b, key, kh)
  const int d = 4 * (int)(i % n4);
  const int kh = (int)(row % K);
  const long long bs = row / K;  // b Skv + key
  const int key = (int)(bs % Skv), b = (int)(bs / Skv);
  const long long src = (bs * K * G + (long long)kh * G) * hd + d;
  float4 x = *reinterpret_cast<const float4*>(dk_part + src);
  float4 y = *reinterpret_cast<const float4*>(dv_part + src);
  for (int gi = 1; gi < G; ++gi) {
    const float4 a = *reinterpret_cast<const float4*>(dk_part + src + gi * hd);
    const float4 c = *reinterpret_cast<const float4*>(dv_part + src + gi * hd);
    x.x += a.x; x.y += a.y; x.z += a.z; x.w += a.w;
    y.x += c.x; y.y += c.y; y.z += c.z; y.w += c.w;
  }
  __nv_bfloat162* ko = reinterpret_cast<__nv_bfloat162*>(
      dk + b * dks.b + key * dks.s + kh * dks.h + d);
  __nv_bfloat162* vo = reinterpret_cast<__nv_bfloat162*>(
      dv + b * dvs.b + key * dvs.s + kh * dvs.h + d);
  ko[0] = __floats2bfloat162_rn(x.x * scale, x.y * scale);
  ko[1] = __floats2bfloat162_rn(x.z * scale, x.w * scale);
  vo[0] = __floats2bfloat162_rn(y.x, y.y);
  vo[1] = __floats2bfloat162_rn(y.z, y.w);
}

// ------------------------------- the bf16 forward on wgmma (see the top)

constexpr int FWD_ROWS = 64;             // a consumer warpgroup's query rows
constexpr int FWD_BQ = 128;              // a block's query rows
constexpr int FWD_THREADS = 2 * BWD_WG;  // two consumer warpgroups
// dynamic shared memory a block may use (227 KB)
constexpr int SMEM_LIMIT = 232448;

// blocks of the forward an SM holds: two at HDP 64 with 64-key tiles (at
// most 128 registers a thread, 81 KB of shared memory each), so that one
// block's softmax runs under the other's products; else one
__host__ __device__ constexpr int fwd_blocks(int HDP, int NK) {
  return HDP == 64 && NK == 1 ? 2 : 1;
}

// The shape of a forward block and its shared memory (bytes from a
// 1024-aligned base): Q, 128 rows of CB = HDP / 64 subtiles (warpgroup
// w's 64 rows at subtile w CB); the ring's stages, each a K tile and a V
// tile of BKV = 64 NK keys in subtiles of 64 keys x 64 dims, K's dims
// subtile c of chunk n at c NK + n (a dims subtile's 128 keys one after
// the other, as one m64n128k16 reads them), V's at n CB + c; the
// barriers (Q, full[s], empty[s]).  As many stages as fit, at most 4: 4
// at HDP 64, 3 at 128 and at 192, 2 at 256.  The producer keeps the ring
// AHEAD tiles ahead, so that one warpgroup may fall STAGES - AHEAD tiles
// behind the other before it holds the producer up.
template <int HDP, int NK>
struct FwdSmem {
  static constexpr int CB = HDP / 64;
  static constexpr int BKV = 64 * NK;  // keys a tile
  static constexpr int SUB = hopper::SUBTILE;
  static constexpr int Q = 2 * CB * SUB;
  static constexpr int KV = NK * CB * SUB;  // one of a stage's two tiles
  static constexpr int STAGE = 2 * KV;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 8 * 9 - Q) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int AHEAD = STAGES > 2 ? STAGES - 2 : 1;
  static constexpr int BARS = Q + STAGES * STAGE;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(STAGES >= 2 && BYTES <= SMEM_LIMIT, "two stages fit");
};

// One 64-key chunk's scores in place, scaled to log2 units, and with
// MASK NEG_INF where the pair is masked (rows r0 and r0 + 8; keys k0 + 8
// (i >> 2) + (i & 1), k0 this thread's first): row r keeps the keys from
// r - window + 1 (a window) to min(r, Skv - 1) (causal) or Skv - 1, two
// compares a pair against the row's limits (rows past S, never written,
// keep theirs)
template <bool MASK>
__device__ __forceinline__ void scale_scores(float (&sc)[32],
                                             float scale_log2, int r0,
                                             int k0, const PairMask& m) {
  int lo[2], hi[2];  // the kept keys' offsets from k0, per row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    hi[r] = (m.causal ? min(row, m.Skv - 1) : m.Skv - 1) - k0;
    lo[r] = m.window ? row - m.window + 1 - k0 : -(1 << 30);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1, off = 8 * (i >> 2) + (i & 1);
    const float x = sc[i] * scale_log2;
    sc[i] = MASK && (off > hi[r] || off < lo[r]) ? NEG_INF : x;
  }
}

// The online softmax over one 64-key chunk's scaled scores for rows r0
// (m[0] and this thread's part of l[0]) and r0 + 8 (m[1], l[1]): the
// running max over the quad of lanes that shares the rows, the correction
// c = exp2(m_old - m) of the earlier terms (l times c here, O by the
// caller), and p = exp2(s - m) in place of the scores, added to l two at
// a time: the mma.sync kernel's tile step for step, so that the outputs
// are its own, bit for bit.
__device__ __forceinline__ void chunk_softmax(float (&sc)[32], float (&m)[2],
                                              float (&l)[2], float (&c)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], fmaxf(sc[i], sc[i + 1]));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    c[r] = mma_tile::fast_exp2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= c[r];
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i >> 1) & 1;
    const float p0 = mma_tile::fast_exp2(sc[i] - m[r]);
    const float p1 = mma_tile::fast_exp2(sc[i + 1] - m[r]);
    l[r] += p0 + p1;
    sc[i] = p0;
    sc[i + 1] = p1;
  }
}

// O times each row's correction
template <int CB>
__device__ __forceinline__ void rescale(float (&o)[CB][32],
                                        const float (&c)[2]) {
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] *= c[(i >> 1) & 1];
  }
}

// LSE: also write each query row's log-sum-exp (natural log, f32) at
// lse[(b * H + h) * lse_row + row], and after those B H lse_row floats the
// output's low halves, bf16(x - bf16(x)) of each f32 output x, [B, S, H,
// hd] contiguous, for the backward entries (D from the f32 output: the
// dot entry).  The low halves ride in the LSE buffer so that the entry's
// parameters stay the serving instantiation's.
template <int HDP, int NK, bool LSE>
__global__ void __launch_bounds__(FWD_THREADS, fwd_blocks(HDP, NK))
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           bf16* __restrict__ o, int S, int Skv, int H,
                           int K, int hd, Strides os, int causal,
                           int window, float scale_log2,
                           float* __restrict__ lse, long long lse_row) {
  using L = FwdSmem<HDP, NK>;
  constexpr int CB = L::CB, SUB = L::SUB, BKV = L::BKV;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t qbar = base + L::BARS;
  const auto full = [&](int s) { return base + L::BARS + 8 * (1 + s); };
  const auto empty = [&](int s) {
    return base + L::BARS + 8 * (1 + STAGES + s);
  };
  const PairMask mask{S, Skv, causal, window};

  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FWD_BQ;
  // the warpgroups that own a row below S
  const int n_wg = q0 + FWD_ROWS < S ? 2 : 1;
  // keys past the block's last row are all masked (causal), keys at or
  // before its first row minus the window too
  const int kv_end = causal ? min(Skv, q0 + FWD_BQ) : Skv;
  const int kv_start = window ? max(0, q0 - window + 1) / BKV * BKV : 0;
  const int n_kt =
      kv_end > kv_start ? (kv_end - kv_start + BKV - 1) / BKV : 0;

  // the producer (thread 0): K and V of key tile j into stage j % STAGES
  // once the consumers have released its last tile
  const auto produce = [&](int j) {
    const int s = j % STAGES, t0 = kv_start + j * BKV;
    hopper::mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
    hopper::mbar_expect_tx(full(s), L::STAGE);
    const uint32_t st = base + L::Q + s * L::STAGE;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int c = 0; c < CB; ++c)  // K: a dims subtile's chunks in turn
        hopper::tma_load_4d(st + (c * NK + n) * SUB, &map_k, full(s),
                            64 * c, kh, t0 + 64 * n, b);
      tma_tile<CB>(st + L::KV + n * CB * SUB, &map_v, full(s), kh,
                   t0 + 64 * n, b);
    }
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), n_wg);
    }
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(qbar, n_wg * CB * SUB);
    for (int w = 0; w < n_wg; ++w)
      tma_tile<CB>(base + w * CB * SUB, &map_q, qbar, h, q0 + w * FWD_ROWS,
                   b);
    for (int j = 0; j < L::AHEAD && j < n_kt; ++j) produce(j);
  }
  __syncthreads();

  // ---- the consumer warpgroups: 64 query rows each
  const int wg = threadIdx.x / BWD_WG;
  if (wg >= n_wg) return;
  const int tid = threadIdx.x % BWD_WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wq0 = q0 + wg * FWD_ROWS;
  const int rows[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};
  const uint32_t qt = base + wg * CB * SUB;

  float oacc[CB][32];
#pragma unroll
  for (int c = 0; c < CB; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[c][i] = 0.f;
  }
  // running max (log2 units) and this thread's part of the sum, per row
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(qbar, 0);
  for (int it = 0; it < n_kt; ++it) {
    // no product in flight: warp 0 (its lane 0) keeps the ring AHEAD
    // tiles ahead, and stays converged for the products
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0 && it + L::AHEAD < n_kt) produce(it + L::AHEAD);
      __syncwarp();
    }
    const int s = it % STAGES, t0 = kv_start + it * BKV;
    hopper::mbar_wait(full(s), (it / STAGES) & 1);
    const uint32_t kst = base + L::Q + s * L::STAGE, vst = kst + L::KV;
    const bool edge = (causal && t0 + BKV - 1 > wq0) ||
                      (window && wq0 + FWD_ROWS - 1 - t0 >= window) ||
                      t0 + BKV > Skv;
    float sc[NK][32];
    hopper::wg_fence();
    // S = Q K^T, one product a 16-dim k-step
#pragma unroll
    for (int ks = 0; ks < HDP / 16; ++ks) {
      const uint64_t a =
          hopper::desc_sw128(qt + (ks / 4) * SUB + (ks % 4) * 32);
      const uint64_t k =
          hopper::desc_sw128(kst + (ks / 4) * NK * SUB + (ks % 4) * 32);
      if constexpr (NK == 2)
        hopper::mma_ss_n128(sc, a, k, ks);
      else
        hopper::mma_ss(sc[0], a, k, ks);
    }
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int n = 0; n < NK; ++n) hopper::fence_regs(sc[n]);
    // each chunk of 64 keys as the mma.sync kernel's tile: its softmax, O's
    // correction, O += P V; the second's softmax runs under the first's
    // P V, and O is corrected once that has landed
    const int k0 = t0 + 2 * t;  // this thread's first key
    float c[2];
    uint32_t pa[NK][2][4][4];  // P as hi + lo, 16 keys a k-step
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      if (edge)
        scale_scores<true>(sc[n], scale_log2, rows[0], k0 + 64 * n, mask);
      else
        scale_scores<false>(sc[n], scale_log2, rows[0], k0 + 64 * n, mask);
      chunk_softmax(sc[n], m, l, c);
      to_a(sc[n], pa[n]);
      if (n > 0) {
        hopper::wg_wait<0>();
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) hopper::fence_regs(oacc[cb]);
      }
      rescale(oacc, c);
      hopper::wg_fence();
      mma_cols<HDP>(oacc, pa[n], vst + n * CB * SUB);  // O += P V
      hopper::wg_commit();
    }
    hopper::wg_wait<0>();
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) hopper::fence_regs(oacc[cb]);
    wg_sync(wg);  // every warp is past this stage's wait
    if (tid == 0) hopper::mbar_arrive(empty(s));
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = mma_tile::quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(sum, 1e-30f);
    // ln sum exp = ln 2 * (m + log2 l), m in log2 units
    if constexpr (LSE) {
      if (t == 0 && rows[r] < S)
        lse[blockIdx.y * lse_row + rows[r]] = (m[r] + log2f(sum)) * LN2;
    }
  }
  bf16* ob = o + b * os.b + h * os.h;
  bf16* lo = nullptr;  // LSE: the low halves, a row H hd apart
  if constexpr (LSE)
    lo = reinterpret_cast<bf16*>(lse + gridDim.y * lse_row) +
         ((long long)b * S * H + h) * hd;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = 64 * c + 8 * n + 2 * t;
      if (d >= hd) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rows[half];
        if (r >= S) continue;
        const float x0 = oacc[c][4 * n + 2 * half] * inv[half];
        const float x1 = oacc[c][4 * n + 2 * half + 1] * inv[half];
        const __nv_bfloat162 y = __floats2bfloat162_rn(x0, x1);
        *reinterpret_cast<__nv_bfloat162*>(ob + r * os.s + d) = y;
        if constexpr (LSE) {
          const float2 hi = __bfloat1622float2(y);
          *reinterpret_cast<__nv_bfloat162*>(lo + r * (long long)H * hd +
                                             d) =
              __floats2bfloat162_rn(x0 - hi.x, x1 - hi.y);
        }
      }
    }
  }
}

template <class Kernel>
int allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// the tensor maps of q, k, v, dout (in that order); false if one fails
bool bwd_maps(CUtensorMap (&maps)[4], int B, int S, int Skv, int H, int K,
              int hd, const void* q, Strides qs, const void* k, Strides ks,
              const void* v, Strides vs, const void* dout, Strides ds) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  return fn != nullptr &&
         hopper::encode_rows(fn, &maps[0], q, B, S, H, hd, qs.b, qs.s,
                             qs.h) &&
         hopper::encode_rows(fn, &maps[1], k, B, Skv, K, hd, ks.b, ks.s,
                             ks.h) &&
         hopper::encode_rows(fn, &maps[2], v, B, Skv, K, hd, vs.b, vs.s,
                             vs.h) &&
         hopper::encode_rows(fn, &maps[3], dout, B, S, H, hd, ds.b, ds.s,
                             ds.h);
}

template <int HDP>
int launch_dkdv(const CUtensorMap (&m)[4], const float* lse,
                const float* dlt, void* dk, void* dv, float* dk_part,
                float* dv_part, int B, int S, int Skv, int H, int K, int hd,
                Strides dks, Strides dvs, long long lse_row, int causal,
                int window, float scale, cudaStream_t stream) {
  constexpr int smem = BwdSmem<HDP>::BYTES;
  const int e = allow_smem(flash_bwd_dkdv_wgmma_kernel<HDP>, smem);
  if (e) return e;
  constexpr int rows = BwdSmem<HDP>::BLOCK;
  const dim3 grid(B * H, (Skv + rows - 1) / rows);
  flash_bwd_dkdv_wgmma_kernel<HDP><<<grid, BWD_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, dlt, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dk_part, dv_part, S, Skv, H, K, hd, dks, dvs,
      lse_row, causal, window, scale * mma_tile::LOG2E, scale);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_dq(const CUtensorMap (&m)[4], const float* lse, const float* dlt,
              void* dq, int B, int S, int Skv, int H, int K, int hd,
              Strides dqs, long long lse_row, int causal, int window,
              float scale, cudaStream_t stream) {
  constexpr int smem = BwdSmem<HDP>::BYTES;
  const int e = allow_smem(flash_bwd_dq_wgmma_kernel<HDP>, smem);
  if (e) return e;
  constexpr int rows = BwdSmem<HDP>::BLOCK;
  const dim3 grid(B * H, (S + rows - 1) / rows);
  flash_bwd_dq_wgmma_kernel<HDP><<<grid, BWD_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, dlt, static_cast<bf16*>(dq), S, Skv, H,
      K, hd, dqs, lse_row, causal, window, scale * mma_tile::LOG2E, scale);
  return (int)cudaGetLastError();
}

// the forward's tensor maps of q, k, v (in that order); false if one fails
bool fwd_maps(CUtensorMap (&maps)[3], int B, int S, int Skv, int H, int K,
              int hd, const void* q, Strides qs, const void* k, Strides ks,
              const void* v, Strides vs) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  return fn != nullptr &&
         hopper::encode_rows(fn, &maps[0], q, B, S, H, hd, qs.b, qs.s,
                             qs.h) &&
         hopper::encode_rows(fn, &maps[1], k, B, Skv, K, hd, ks.b, ks.s,
                             ks.h) &&
         hopper::encode_rows(fn, &maps[2], v, B, Skv, K, hd, vs.b, vs.s,
                             vs.h);
}

// 64-key chunks a tile of the forward: 1 above HDP 128 (a thread's O, 96
// or 128 registers, leaves no room for 64 scores), 2 at HDP 128; at HDP
// 64, 1 where Skv fits one chunk (a short prompt: a second would hold no
// key, and only lengthen the block) or where the grid has more blocks
// than the card's sms SMs (two blocks of 64-key tiles then share an SM),
// else 2 (a cross attention's few query tiles over many keys)
int fwd_chunks(int hd, int Skv, long long blocks, int sms) {
  if (hd > 128) return 1;
  if (hd > 64) return 2;
  return Skv <= 64 || blocks > sms ? 1 : 2;
}

template <int HDP, int NK, bool LSE>
int launch_fwd(const CUtensorMap (&m)[3], void* o, int B, int S, int Skv,
               int H, int K, int hd, Strides os, int causal, int window,
               float scale, float* lse, long long lse_row,
               cudaStream_t stream) {
  constexpr int smem = FwdSmem<HDP, NK>::BYTES;
  const int e = allow_smem(flash_fwd_wgmma_kernel<HDP, NK, LSE>, smem);
  if (e) return e;
  const dim3 grid((S + FWD_BQ - 1) / FWD_BQ, B * H);
  flash_fwd_wgmma_kernel<HDP, NK, LSE><<<grid, FWD_THREADS, smem, stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(o), S, Skv, H, K, hd, os, causal,
      window, scale * mma_tile::LOG2E, lse, lse_row);
  return (int)cudaGetLastError();
}

// the bf16 forward at HDP = hd rounded up to whole 64-dim subtiles (hd a
// multiple of 8 up to 256, 16-byte rows: checked by the caller), with
// tiles of fwd_chunks 64-key chunks
template <bool LSE>
int launch_fwd_hd(int B, int S, int Skv, int H, int K, int hd, const void* q,
                  Strides qs, const void* k, Strides ks, const void* v,
                  Strides vs, void* o, Strides os, int causal, int window,
                  float scale, float* lse, long long lse_row,
                  cudaStream_t st) {
  CUtensorMap m[3];
  if (!fwd_maps(m, B, S, Skv, H, K, hd, q, qs, k, ks, v, vs))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int nk = fwd_chunks(
      hd, Skv, (long long)(S + FWD_BQ - 1) / FWD_BQ * B * H, sms);
#define FLASH_FWD_CASE(n, nk_)                                              \
  if ((hd + 63) / 64 == n && nk == nk_)                                     \
    return launch_fwd<64 * n, nk_, LSE>(m, o, B, S, Skv, H, K, hd, os,      \
                                       causal, window, scale, lse, lse_row, \
                                       st);
  FLASH_FWD_CASE(1, 1)
  FLASH_FWD_CASE(1, 2)
  FLASH_FWD_CASE(2, 2)
  FLASH_FWD_CASE(3, 1)
  FLASH_FWD_CASE(4, 1)
#undef FLASH_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

// the backward entries' head dims, rounded up to whole 64-dim subtiles: 64,
// 128 or 256 (0: refused)
int wgmma_hdp(int hd) {
  return hd <= 64 ? 64 : hd <= 128 ? 128 : hd <= 256 ? 256 : 0;
}


// 16-byte rows: the pointer and every stride a multiple of 8 elements
bool rows_aligned(const void* p, long long sb, long long ss, long long sh) {
  return ((uintptr_t)p % 16) == 0 && sb % 8 == 0 && ss % 8 == 0 &&
         sh % 8 == 0;
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [B, S, H, hd], k / v [B, Skv, K, hd], o [B, S, H, hd], each with the
// given element strides of its first three dims (the last is contiguous);
// dtype 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma: hd a multiple of
// 8, pointers 16-byte aligned and strides multiples of 8).
// Returns the launch's CUDA error code.
int flash_attention_launch(int dtype, int B, int S, int Skv, int H, int K,
                           int hd, const void* q, long long qsb,
                           long long qss, long long qsh, const void* k,
                           long long ksb, long long kss, long long ksh,
                           const void* v, long long vsb, long long vss,
                           long long vsh, void* o, long long osb,
                           long long oss, long long osh, int causal,
                           int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || hd <= 0 ||
      hd > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, S, Skv, H, K, qs, ks, vs, os,
                            causal, window, scale, st);
  if (dtype == 1) {
    if (hd % 8 != 0 || !rows_aligned(q, qsb, qss, qsh) ||
        !rows_aligned(k, ksb, kss, ksh) || !rows_aligned(v, vsb, vss, vsh) ||
        !rows_aligned(o, osb, oss, osh))
      return (int)cudaErrorInvalidValue;
    return launch_fwd_hd<false>(B, S, Skv, H, K, hd, q, qs, k, ks, v, vs, o,
                                os, causal, window, scale, nullptr, 0, st);
  }
  return (int)cudaErrorInvalidValue;
}


// The training forward: flash_attention_launch's bf16 path (hd <= 256),
// also writing each query row's log-sum-exp, f32, at lse[(b * H + h) *
// lse_row + row] (lse_row >= S, a multiple of 4: the backward reads the
// rows in 16-byte groups), and the output's low halves o_lo, bf16 [B, S,
// H, hd] contiguous, which must start where the B H lse_row floats end.
int flash_attention_lse_launch(int B, int S, int Skv, int H, int K, int hd,
                               const void* q, long long qsb, long long qss,
                               long long qsh, const void* k, long long ksb,
                               long long kss, long long ksh, const void* v,
                               long long vsb, long long vss, long long vsh,
                               void* o, long long osb, long long oss,
                               long long osh, int causal, int window,
                               float scale, void* lse, long long lse_row,
                               void* o_lo, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || hd <= 0 ||
      hd % 8 != 0 || hd > 256 || B * H > 65535 || lse_row < S ||
      lse_row % 4 != 0 ||
      o_lo != static_cast<float*>(lse) + (long long)B * H * lse_row ||
      !rows_aligned(q, qsb, qss, qsh) ||
      !rows_aligned(k, ksb, kss, ksh) || !rows_aligned(v, vsb, vss, vsh) ||
      !rows_aligned(o, osb, oss, osh))
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t st = (cudaStream_t)stream;
  return launch_fwd_hd<true>(B, S, Skv, H, K, hd, q, qs, k, ks, v, vs, o, os,
                             causal, window, scale, static_cast<float*>(lse),
                             lse_row, st);
}

// D = rowsum(dO o (O + O_lo)), f32, at dlt[(b * H + h) * lse_row + s];
// o, its low halves o_lo and dout [B, S, H, hd] bf16 with 16-byte rows,
// hd a multiple of 8 up to 256.
int flash_bwd_dot_launch(int B, int S, int H, int hd, const void* o,
                         long long osb, long long oss, long long osh,
                         const void* o_lo, long long lsb, long long lss,
                         long long lsh, const void* dout, long long dsb,
                         long long dss, long long dsh, void* dlt,
                         long long lse_row, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd % 8 != 0 || hd > 256 ||
      lse_row < S || !rows_aligned(o, osb, oss, osh) ||
      !rows_aligned(o_lo, lsb, lss, lsh) || !rows_aligned(dout, dsb, dss, dsh))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * S;
  const int lanes = hd / 8;  // lanes a row, rounded up to a power of two
  const int lp = lanes <= 1 ? 1 : lanes <= 2 ? 2 : lanes <= 4 ? 4
               : lanes <= 8 ? 8 : lanes <= 16 ? 16 : lanes <= 32 ? 32 : 0;
  if (lp == 0) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)DOT_WARPS * (32 / lp);
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bf16* op = static_cast<const bf16*>(o);
  const bf16* lo = static_cast<const bf16*>(o_lo);
  const bf16* dp = static_cast<const bf16*>(dout);
  float* dl = static_cast<float*>(dlt);
  const Strides os{osb, oss, osh}, ls{lsb, lss, lsh}, ds{dsb, dss, dsh};
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_DOT_CASE(n)                                                    \
  case n:                                                                    \
    flash_bwd_dot_kernel<n><<<(unsigned)blocks, DOT_THREADS, 0, st>>>(       \
        op, lo, dp, dl, S, H, hd, os, ls, ds, lse_row, rows);                \
    break;
  switch (lp) {
    FLASH_DOT_CASE(1)
    FLASH_DOT_CASE(2)
    FLASH_DOT_CASE(4)
    FLASH_DOT_CASE(8)
    FLASH_DOT_CASE(16)
    FLASH_DOT_CASE(32)
  }
#undef FLASH_DOT_CASE
  return (int)cudaGetLastError();
}

// dK, dV [B, Skv, K, hd] bf16 from q [B, S, H, hd], k / v [B, Skv, K, hd],
// dout [B, S, H, hd] (bf16, 16-byte rows, hd <= 256) and the forward's
// LSE and D rows (f32, row stride lse_row, a multiple of 64 >= S).  Where
// H > K the entry writes each query head's f32 sums (dK unscaled) into
// dk_part / dv_part ([B, Skv, H, hd] contiguous, 16-byte aligned) instead,
// for flash_bwd_sum_launch; dk / dv are then not touched.
int flash_bwd_dkdv_launch(int B, int S, int Skv, int H, int K, int hd,
                          const void* q, long long qsb, long long qss,
                          long long qsh, const void* k, long long ksb,
                          long long kss, long long ksh, const void* v,
                          long long vsb, long long vss, long long vsh,
                          const void* dout, long long dsb, long long dss,
                          long long dsh, const void* lse, const void* dlt,
                          long long lse_row, void* dk, long long dksb,
                          long long dkss, long long dksh, void* dv,
                          long long dvsb, long long dvss, long long dvsh,
                          void* dk_part, void* dv_part, int causal,
                          int window, float scale, void* stream) {
  const bool parts = H != K;
  if (B <= 0 || S <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || hd <= 0 ||
      hd % 8 != 0 || wgmma_hdp(hd) == 0 || (long long)B * H > 2147483647LL ||
      (Skv + BWD_ROWS - 1) / BWD_ROWS > 65535 || lse_row < S ||
      lse_row % 64 != 0 || !rows_aligned(q, qsb, qss, qsh) ||
      !rows_aligned(k, ksb, kss, ksh) || !rows_aligned(v, vsb, vss, vsh) ||
      !rows_aligned(dout, dsb, dss, dsh) ||
      !rows_aligned(dk, dksb, dkss, dksh) ||
      !rows_aligned(dv, dvsb, dvss, dvsh) || (uintptr_t)lse % 16 != 0 ||
      (uintptr_t)dlt % 16 != 0 ||
      (parts && (dk_part == nullptr || dv_part == nullptr ||
                 (uintptr_t)dk_part % 16 != 0 ||
                 (uintptr_t)dv_part % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      ds{dsb, dss, dsh}, dks{dksb, dkss, dksh}, dvs{dvsb, dvss, dvsh};
  CUtensorMap m[4];
  if (!bwd_maps(m, B, S, Skv, H, K, hd, q, qs, k, ks, v, vs, dout, ds))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dlt);
  float* pk = static_cast<float*>(dk_part);
  float* pv = static_cast<float*>(dv_part);
  const cudaStream_t st = (cudaStream_t)stream;
  if (wgmma_hdp(hd) == 64)
    return launch_dkdv<64>(m, l, d, dk, dv, pk, pv, B, S, Skv, H, K, hd, dks,
                           dvs, lse_row, causal, window, scale, st);
  if (wgmma_hdp(hd) == 128)
    return launch_dkdv<128>(m, l, d, dk, dv, pk, pv, B, S, Skv, H, K, hd,
                            dks, dvs, lse_row, causal, window, scale, st);
  return launch_dkdv<256>(m, l, d, dk, dv, pk, pv, B, S, Skv, H, K, hd, dks,
                          dvs, lse_row, causal, window, scale, st);
}

// dK, dV [B, Skv, K, hd] bf16 (16-byte rows) from flash_bwd_dkdv_launch's
// partials ([B, Skv, H, hd] f32, contiguous, 16-byte aligned): the sum
// over each group's H / K heads in head order, dK times scale.
int flash_bwd_sum_launch(int B, int Skv, int H, int K, int hd,
                         const void* dk_part, const void* dv_part, void* dk,
                         long long dksb, long long dkss, long long dksh,
                         void* dv, long long dvsb, long long dvss,
                         long long dvsh, float scale, void* stream) {
  if (B <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || hd <= 0 ||
      hd % 8 != 0 || (uintptr_t)dk_part % 16 != 0 ||
      (uintptr_t)dv_part % 16 != 0 || !rows_aligned(dk, dksb, dkss, dksh) ||
      !rows_aligned(dv, dvsb, dvss, dvsh))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * Skv * K * (hd / 4);
  const long long blocks = (n + 255) / 256;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_bwd_sum_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Skv, K, H / K, hd,
      Strides{dksb, dkss, dksh}, Strides{dvsb, dvss, dvsh}, scale, n);
  return (int)cudaGetLastError();
}

// dQ [B, S, H, hd] bf16, from the same inputs as flash_bwd_dkdv_launch
// (dS enters the dQ product as bf16 hi + lo).
int flash_bwd_dq_launch(int B, int S, int Skv, int H, int K, int hd,
                        const void* q, long long qsb, long long qss,
                        long long qsh, const void* k, long long ksb,
                        long long kss, long long ksh, const void* v,
                        long long vsb, long long vss, long long vsh,
                        const void* dout, long long dsb, long long dss,
                        long long dsh, const void* lse, const void* dlt,
                        long long lse_row, void* dq, long long dqsb,
                        long long dqss, long long dqsh, int causal,
                        int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || hd <= 0 ||
      hd % 8 != 0 || wgmma_hdp(hd) == 0 || (long long)B * H > 2147483647LL ||
      (S + BWD_ROWS - 1) / BWD_ROWS > 65535 || lse_row < S ||
      !rows_aligned(q, qsb, qss, qsh) || !rows_aligned(k, ksb, kss, ksh) ||
      !rows_aligned(v, vsb, vss, vsh) ||
      !rows_aligned(dout, dsb, dss, dsh) ||
      !rows_aligned(dq, dqsb, dqss, dqsh))
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      ds{dsb, dss, dsh}, dqs{dqsb, dqss, dqsh};
  CUtensorMap m[4];
  if (!bwd_maps(m, B, S, Skv, H, K, hd, q, qs, k, ks, v, vs, dout, ds))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dlt);
  const cudaStream_t st = (cudaStream_t)stream;
  if (wgmma_hdp(hd) == 64)
    return launch_dq<64>(m, l, d, dq, B, S, Skv, H, K, hd, dqs, lse_row,
                         causal, window, scale, st);
  if (wgmma_hdp(hd) == 128)
    return launch_dq<128>(m, l, d, dq, B, S, Skv, H, K, hd, dqs, lse_row,
                          causal, window, scale, st);
  return launch_dq<256>(m, l, d, dq, B, S, Skv, H, K, hd, dqs, lse_row,
                        causal, window, scale, st);
}

}  // extern "C"
