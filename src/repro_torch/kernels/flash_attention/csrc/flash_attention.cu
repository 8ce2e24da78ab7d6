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
// launch- and latency-bound, long ones need the tensor cores.
//
// bf16 inputs: the FlashAttention-2 shape on mma.sync
// (flash_attention_mma_kernel).  A block of 4 warps owns 64 query rows (16
// a warp) of one (batch, head); the grid is (ceil(S / 64), B * H), the last
// query tiles (the most keys under a causal mask) scheduled first.  Each
// warp keeps its 16 rows of Q in registers as mma A fragments, read once
// from device memory.  K and V tiles of 64 keys stay bf16 in shared
// memory, in a two-stage ring filled by 16-byte cp.async copies (the next
// tile's copy runs under this tile's arithmetic).  Per tile, mma_tile.cuh
// (shared with the decode kernel) forms S = Q K^T on the tensor cores,
// this kernel masks it, and mma_tile.cuh runs the online softmax and P V
// with p = p_hi + p_lo, both summed in f32, so that the f32 limits against
// the plain version hold unchanged.  Tiles that every row of the block
// masks (above the causal diagonal, before the window) are skipped: for a
// row with a valid key the Pallas kernel's result does not depend on them
// (their p is 0, or is cleared by the correction exp(-1e30 - m) = 0 once
// a valid tile arrives); only tiles on a mask's edge evaluate the mask.
// hd is any multiple of 8 up to 256: the kernel is built for hd rounded up
// to 16 (HDP) and loads zeros past hd.  Above 128 the output's dims are
// split over the grid's z (mma_tile::out_split): each of NZ blocks of a
// query tile forms the whole S = Q K^T and the same online softmax, and
// keeps P V for its own DV <= 128 output dims only, so a thread holds
// HDP / 4 Q registers and DV / 2 accumulators (64 + 64 at hd 256) where
// one block owning all dims would need 64 + 128.  The QK^T products are
// made twice; the blocks share nothing, so nothing waits.  A stage of the
// ring holds the K tile at HDP dims and the V tile at DV dims (100 KB of
// dynamic shared memory at hd 256).  The model's [B, S, H, hd] layout is
// read through strides (rows 16-byte aligned).  wgmma and TMA
// (FlashAttention-3's shape) are the next step.
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
// Training (flash_attention_lse_launch and the three flash_bwd_* entries
// below): the bf16 forward also writes each row's log-sum-exp, and a
// FlashAttention-2 backward recomputes P from it; no Pallas kernel has a
// backward, these stand in for XLA's differentiation of repro's
// layers.blocked_attention (repro's training path).
//
// Built by repro_torch/_build.py with nvcc for sm_90a, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

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


// ------------------------------------------- bf16 path on the tensor cores

using mma_tile::bf16;

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_BQ = 16 * MMA_WARPS;  // query rows a block
constexpr int MMA_BKV = mma_tile::TILE_KEYS;
constexpr float LN2 = 0.6931471805599453f;

// bf16 elements of one stage of the K / V ring: the K tile at HDP dims,
// the V tile at the block's DV output dims
template <int HDP>
__host__ __device__ constexpr int stage_elems() {
  return mma_tile::tile_elems<HDP>() +
         mma_tile::tile_elems<mma_tile::out_dims<HDP>()>();
}

// shared memory of the two-stage K / V ring, in bytes
template <int HDP>
constexpr int mma_smem_bytes() {
  return 2 * stage_elems<HDP>() * (int)sizeof(bf16);
}

// one 64-key tile of K (all dims) and of V (the DV dims from d0) into a
// stage of the ring (keys past Skv zero-filled) as one cp.async group
template <int HDP>
__device__ __forceinline__ void load_kv(bf16* stage, const bf16* kb,
                                        const bf16* vb, long long kss,
                                        long long vss, int t0, int Skv,
                                        int hd, int d0, int tid) {
  constexpr int DV = mma_tile::out_dims<HDP>();
  mma_tile::load_tile<HDP, MMA_THREADS>(stage, kb + t0 * kss, kss,
                                        Skv - t0, hd, tid);
  mma_tile::load_tile<DV, MMA_THREADS>(
      stage + mma_tile::tile_elems<HDP>(), vb + t0 * vss + d0, vss,
      Skv - t0, hd - d0, tid);
  mma_tile::cp_async_commit();
}

// LSE: also write each query row's log-sum-exp (natural log, f32) at
// lse[(b * H + h) * lse_row + row], and after those B H lse_row floats the
// output's low halves, bf16(x - bf16(x)) of each f32 output x, [B, S, H,
// hd] contiguous, for the backward entries (D from the f32 output: the
// dot entry).  The low halves ride in the LSE buffer so that the entry's
// parameters, and with them the serving instantiation, stay as they were.
template <int HDP, bool LSE>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_attention_mma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o, int S, int Skv, int H,
                               int K, int hd, Strides qs, Strides ks,
                               Strides vs, Strides os, int causal,
                               int window, float scale_log2,
                               float* __restrict__ lse, long long lse_row) {
  constexpr int TILE = mma_tile::tile_elems<HDP>();
  constexpr int STAGE = stage_elems<HDP>();
  constexpr int DV = mma_tile::out_dims<HDP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [2][K tile, V tile]
  const int d0 = blockIdx.z * DV;  // this block's output dims d0 + [0, DV)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / K);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this lane's two rows

  const mma_tile::QRegs<HDP> qa(
      q + b * qs.b + h * qs.h + (long long)q0 * qs.s, qs.s, warp * 16 + g,
      S - q0, hd, t);
  float oacc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // running max (log2 units) and this lane's part of the sum, rows r0, r1
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // keys past the block's last query row are all masked (causal), keys
  // at or before its first row minus the window too
  const int kv_end = causal ? min(Skv, q0 + MMA_BQ) : Skv;
  const int kv_start =
      window ? (max(0, q0 - window + 1) / MMA_BKV) * MMA_BKV : 0;
  const int n_tiles = (kv_end - kv_start + MMA_BKV - 1) / MMA_BKV;
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;

  load_kv<HDP>(ring, kb, vb, ks.s, vs.s, kv_start, Skv, hd, d0, tid);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = kv_start + it * MMA_BKV;
    const bf16* kt = ring + (it & 1) * STAGE;
    if (it + 1 < n_tiles) {  // the next tile's copy runs under this one
      load_kv<HDP>(ring + ((it + 1) & 1) * STAGE, kb, vb, ks.s, vs.s,
                   t0 + MMA_BKV, Skv, hd, d0, tid);
      mma_tile::cp_async_wait<1>();
    } else {
      mma_tile::cp_async_wait<0>();
    }
    __syncthreads();

    float sc[8][4];
    mma_tile::qk_tile<HDP>(sc, qa, kt, lane);
    // scale, and mask where the tile meets a mask's edge
    const bool edge = (causal && t0 + MMA_BKV - 1 > q0) ||
                      (window && t0 < q0 + MMA_BQ - window) ||
                      t0 + MMA_BKV > Skv;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (edge) {
          const int row = e < 2 ? r0 : r1;
          const int key = t0 + 8 * n + 2 * t + (e & 1);
          bool ok = key < Skv;
          if (causal) ok = ok && row >= key;
          if (window) ok = ok && row - key < window;
          x = ok ? x : NEG_INF;
        }
        sc[n][e] = x;
      }
    }
    mma_tile::softmax_pv_tile<DV>(sc, m0, m1, l0, l1, oacc, kt + TILE,
                                  lane);
    __syncthreads();  // the stage is refilled at the next iteration
  }

  const float l0s = mma_tile::quad_sum(l0), l1s = mma_tile::quad_sum(l1);
  const float inv0 = 1.f / fmaxf(l0s, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1s, 1e-30f);
  if constexpr (LSE) {
    // ln sum exp = ln 2 * (m + log2 l), m in log2 units
    if (t == 0 && blockIdx.z == 0) {
      float* lb = lse + blockIdx.y * lse_row;
      if (r0 < S) lb[r0] = (m0 + log2f(l0s)) * LN2;
      if (r1 < S) lb[r1] = (m1 + log2f(l1s)) * LN2;
    }
  }
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int d = d0 + 8 * n + 2 * t;
    if (d >= hd) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * os.s + d) =
          __floats2bfloat162_rn(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * os.s + d) =
          __floats2bfloat162_rn(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
  if constexpr (LSE) {
    bf16* lo = reinterpret_cast<bf16*>(lse + gridDim.y * lse_row) +
               ((long long)b * S * H + h) * hd;
    const long long rs = (long long)H * hd;  // a row of the low halves
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int d = d0 + 8 * n + 2 * t;
      if (d >= hd) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= S) continue;
        const float inv = half ? inv1 : inv0;
        const float x0 = oacc[n][2 * half] * inv;
        const float x1 = oacc[n][2 * half + 1] * inv;
        const float2 hi =
            __bfloat1622float2(__floats2bfloat162_rn(x0, x1));
        *reinterpret_cast<__nv_bfloat162*>(lo + r * rs + d) =
            __floats2bfloat162_rn(x0 - hi.x, x1 - hi.y);
      }
    }
  }
}

template <int HDP>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Skv, int H, int K, int hd, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<HDP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_mma_kernel<HDP, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, B * H,
                  mma_tile::out_split<HDP>());
  flash_attention_mma_kernel<HDP, false><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Skv, H, K, hd,
      qs, ks, vs, os, causal, window, scale * mma_tile::LOG2E, nullptr, 0);
  return (int)cudaGetLastError();
}

int launch_mma_hd(int hd, const void* q, const void* k, const void* v,
                  void* o, int B, int S, int Skv, int H, int K, Strides qs,
                  Strides ks, Strides vs, Strides os, int causal, int window,
                  float scale, cudaStream_t st) {
#define FLASH_MMA_CASE(n)                                                  \
  case n:                                                                  \
    return launch_mma<16 * n>(q, k, v, o, B, S, Skv, H, K, hd, qs, ks, vs, \
                              os, causal, window, scale, st);
  switch ((hd + 15) / 16) {
    FLASH_MMA_CASE(1)
    FLASH_MMA_CASE(2)
    FLASH_MMA_CASE(3)
    FLASH_MMA_CASE(4)
    FLASH_MMA_CASE(5)
    FLASH_MMA_CASE(6)
    FLASH_MMA_CASE(7)
    FLASH_MMA_CASE(8)
    FLASH_MMA_CASE(9)
    FLASH_MMA_CASE(10)
    FLASH_MMA_CASE(11)
    FLASH_MMA_CASE(12)
    FLASH_MMA_CASE(13)
    FLASH_MMA_CASE(14)
    FLASH_MMA_CASE(15)
    FLASH_MMA_CASE(16)
  }
#undef FLASH_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------- training: LSE forward and backward

// the LSE forward at HDP 32, 64 or 128 (the backward's head dims)
template <int HDP>
int launch_mma_lse(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Skv, int H, int K, int hd, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal,
                   int window, float scale, float* lse, long long lse_row,
                   cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<HDP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_mma_kernel<HDP, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, B * H, 1);
  flash_attention_mma_kernel<HDP, true><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Skv, H, K, hd,
      qs, ks, vs, os, causal, window, scale * mma_tile::LOG2E, lse,
      lse_row);
  return (int)cudaGetLastError();
}

// The backward pass, FlashAttention-2's shape on the same mma.sync tile,
// bf16 in, f32 sums, no atomics: every gradient element is written by one
// block, its sum taken in a fixed order, so two runs give the same bits.
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
//   dK   = dS^T Q / sqrt(hd)                    (flash_bwd_dkdv_kernel)
//   dQ   = dS K / sqrt(hd)                      (flash_bwd_dq_kernel)
//
// The dK / dV entry: a block per (batch, KV head, 64 keys), a warp per 16
// keys; K and V stay in shared memory, and the block walks the query
// tiles of all G = H / K query heads of its group (so GQA's sum over the
// group's heads stays in the block's registers), Q, dO and their rows'
// LSE and D in a two-stage cp.async ring.  The dQ entry: a block per
// (batch, head, 64 query rows), a warp per 16 rows, Q and dO in shared
// memory, walking the key tiles (K and V in a two-stage ring).  P^T and
// dS^T (dK / dV) and dS (dQ) are rounded to bf16 as the A operand of the
// second product.  A step takes 64 rows of the walked operand at hd <= 64;
// at hd 128 16 query rows (dK / dV) and 32 keys (dQ), so that the f32
// accumulators (dK and dV: 2 x hd / 2 a thread) stay in registers.  Rows past S or Skv load as zeros and are
// masked; masked pairs (causal, window) contribute P = dS = 0.  Bound:
// 10 hd operations a valid (query, key) pair (five products: 2.5x the
// forward's).

// rows of the walked operand a step: 64 up to HDP 64; at HDP 128, 16
// query rows (dK / dV, whose two accumulators take 128 registers) and 32
// keys (dQ)
template <int HDP>
__host__ __device__ constexpr int dkdv_tile() {
  return HDP > 64 ? 16 : 64;
}
template <int HDP>
__host__ __device__ constexpr int dq_tile() {
  return HDP > 64 ? 32 : 64;
}

// acc = A (16 rows of HDP dims) x T^T, T an NR-row padded tile in shared
// memory (the n dim is T's rows)
template <int HDP, int NR, class A>
__device__ __forceinline__ void mma_abt(float (&acc)[NR / 8][4], const A& a,
                                        const bf16* tile, int lane) {
#pragma unroll
  for (int n = 0; n < NR / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;
#pragma unroll
  for (int s = 0; s < HDP / 16; ++s) {
    uint32_t af[4];
    a.get(s, af, lane);
#pragma unroll
    for (int np = 0; np < NR / 16; ++np) {
      uint32_t bt[4];
      const int row = 16 * np + (lane & 7) + 8 * (lane >> 4);
      const int d = 16 * s + 8 * ((lane >> 3) & 1);
      mma_tile::ldmatrix_x4(bt, mma_tile::smem_u32(tile + row * (HDP + 8) +
                                                   d));
      mma_tile::mma_bf16(acc[2 * np], af, bt[0], bt[1]);
      mma_tile::mma_bf16(acc[2 * np + 1], af, bt[2], bt[3]);
    }
  }
}

// out (16 rows x HDP) += bf16(X) T, X the f32 accumulators of a 16 x NR
// product (its n dim becomes the k dim), T an NR-row padded tile
template <int HDP, int NR>
__device__ __forceinline__ void mma_xt(float (&out)[HDP / 8][4],
                                       const float (&x)[NR / 8][4],
                                       const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < NR / 16; ++kk) {
    uint32_t a[4];
    a[0] = mma_tile::bits(__floats2bfloat162_rn(x[2 * kk][0], x[2 * kk][1]));
    a[1] = mma_tile::bits(__floats2bfloat162_rn(x[2 * kk][2], x[2 * kk][3]));
    a[2] = mma_tile::bits(
        __floats2bfloat162_rn(x[2 * kk + 1][0], x[2 * kk + 1][1]));
    a[3] = mma_tile::bits(
        __floats2bfloat162_rn(x[2 * kk + 1][2], x[2 * kk + 1][3]));
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      uint32_t bt[4];
      const int row = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
      const int d = 16 * dp + 8 * (lane >> 4);
      mma_tile::ldmatrix_x4_trans(
          bt, mma_tile::smem_u32(tile + row * (HDP + 8) + d));
      mma_tile::mma_bf16(out[2 * dp], a, bt[0], bt[1]);
      mma_tile::mma_bf16(out[2 * dp + 1], a, bt[2], bt[3]);
    }
  }
}

// group c (0 <= c < n4) of 4 f32 values as a 16-byte cp.async copy
__device__ __forceinline__ void load_f32_rows(float* dst, const float* src,
                                              int n4, int c) {
  if (c >= 0 && c < n4)
    mma_tile::cp_async16(mma_tile::smem_u32(dst + 4 * c), src + 4 * c, 16);
}

__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dot_kernel(const bf16* __restrict__ o,
                         const bf16* __restrict__ o_lo,
                         const bf16* __restrict__ dout,
                         float* __restrict__ dlt, int S, int H, int hd,
                         Strides os, Strides ls, Strides ds,
                         long long lse_row, long long rows) {
  const long long row = (long long)blockIdx.x * MMA_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int s = (int)(row % S);
  const long long bh = row / S;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const bf16* op = o + b * os.b + s * os.s + h * os.h;
  const bf16* lp = o_lo + b * ls.b + s * ls.s + h * ls.h;
  const bf16* dp = dout + b * ds.b + s * ds.s + h * ds.h;
  float acc = 0.f;
  for (int d = 2 * lane; d < hd; d += 64) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + d));
    const float2 l =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lp + d));
    const float2 c =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dp + d));
    acc += (a.x + l.x) * c.x + (a.y + l.y) * c.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dlt[bh * lse_row + s] = acc;
}

// bytes of one stage of the dK / dV entry's ring: the Q and dO tiles
// (dkdv_tile rows each) and their rows' LSE and D
template <int HDP>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  return 2 * dkdv_tile<HDP>() * (HDP + 8) * (int)sizeof(bf16) +
         2 * dkdv_tile<HDP>() * (int)sizeof(float);
}
template <int HDP>
constexpr int dkdv_smem_bytes() {
  return 2 * mma_tile::tile_elems<HDP>() * (int)sizeof(bf16) +
         2 * dkdv_stage_bytes<HDP>();
}

template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dkdv_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dlt,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int S, int Skv, int H, int K, int hd, Strides qs,
                          Strides ks, Strides vs, Strides ds, Strides dks,
                          Strides dvs, long long lse_row, int causal,
                          int window, float scale_log2, float scale) {
  constexpr int BQ = dkdv_tile<HDP>(), LD = HDP + 8, TILE =
      mma_tile::tile_elems<HDP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kt = reinterpret_cast<bf16*>(smem_raw);
  bf16* vt = kt + TILE;
  unsigned char* ring = reinterpret_cast<unsigned char*>(vt + TILE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * MMA_BKV;
  const int b = blockIdx.y / K, kh = blockIdx.y % K, G = H / K;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;

  mma_tile::load_tile<HDP, MMA_THREADS>(
      kt, k + b * ks.b + kh * ks.h + (long long)k0 * ks.s, ks.s, Skv - k0,
      hd, tid);
  mma_tile::load_tile<HDP, MMA_THREADS>(
      vt, v + b * vs.b + kh * vs.h + (long long)k0 * vs.s, vs.s, Skv - k0,
      hd, tid);
  mma_tile::cp_async_commit();

  // the query rows that see a key of this tile
  const int q_begin = (causal ? k0 : 0) / BQ * BQ;
  const int q_end = window ? min(S, k0 + MMA_BKV - 1 + window) : S;
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int n_it = G * n_qt;

  // a stage: Q tile, dO tile, LSE, D of query tile `it`
  const auto issue = [&](int it) {
    const int h = kh * G + it / n_qt, q0 = q_begin + (it % n_qt) * BQ;
    unsigned char* st = ring + (it & 1) * dkdv_stage_bytes<HDP>();
    bf16* qt = reinterpret_cast<bf16*>(st);
    bf16* dt = qt + BQ * LD;
    float* ls = reinterpret_cast<float*>(dt + BQ * LD);
    mma_tile::load_tile<HDP, MMA_THREADS, BQ>(
        qt, q + b * qs.b + h * qs.h + (long long)q0 * qs.s, qs.s, S - q0,
        hd, tid);
    mma_tile::load_tile<HDP, MMA_THREADS, BQ>(
        dt, dout + b * ds.b + h * ds.h + (long long)q0 * ds.s, ds.s,
        S - q0, hd, tid);
    const long long r = ((long long)b * H + h) * lse_row + q0;
    load_f32_rows(ls, lse + r, BQ / 4, tid);
    load_f32_rows(ls + BQ, dlt + r, BQ / 4, tid - BQ / 4);
    mma_tile::cp_async_commit();
  };

  float dka[HDP / 8][4], dva[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const mma_tile::QSmem<HDP> ka{kt + warp * 16 * LD};
  const mma_tile::QSmem<HDP> va{vt + warp * 16 * LD};

  if (n_it > 0) issue(0);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = q_begin + (it % n_qt) * BQ;
    if (it + 1 < n_it) {  // the next tile's copy runs under this one
      issue(it + 1);
      mma_tile::cp_async_wait<1>();
    } else {
      mma_tile::cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* st = ring + (it & 1) * dkdv_stage_bytes<HDP>();
    const bf16* qt = reinterpret_cast<const bf16*>(st);
    const bf16* dt = qt + BQ * LD;
    const float* ls = reinterpret_cast<const float*>(dt + BQ * LD);
    const float* dd = ls + BQ;

    float sc[BQ / 8][4], dp[BQ / 8][4];
    mma_abt<HDP, BQ>(sc, ka, qt, lane);  // S^T: keys x queries
    mma_abt<HDP, BQ>(dp, va, dt, lane);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const int query = q0 + col, key = e < 2 ? key0 : key1;
        bool ok = query < S && key < Skv;
        if (causal) ok = ok && query >= key;
        if (window) ok = ok && query - key < window;
        const float p =
            ok ? mma_tile::fast_exp2(sc[n][e] * scale_log2 -
                                     ls[col] * mma_tile::LOG2E)
               : 0.f;
        dp[n][e] = ok ? p * (dp[n][e] - dd[col]) : 0.f;
        sc[n][e] = p;
      }
    }
    mma_xt<HDP, BQ>(dva, sc, dt, lane);  // dV += P^T dO
    mma_xt<HDP, BQ>(dka, dp, qt, lane);  // dK += dS^T Q
    __syncthreads();  // the stage is refilled at the next iteration
  }
  mma_tile::cp_async_wait<0>();

  bf16* dkb = dk + b * dks.b + kh * dks.h;
  bf16* dvb = dv + b * dvs.b + kh * dvs.h;
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= hd) continue;
    if (key0 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key0 * dks.s + d) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key0 * dvs.s + d) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (key1 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key1 * dks.s + d) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key1 * dvs.s + d) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

// bf16 elements of one stage of the dQ entry's ring: a K and a V tile of
// dq_tile keys
template <int HDP>
__host__ __device__ constexpr int dq_stage_elems() {
  return 2 * dq_tile<HDP>() * (HDP + 8);
}
template <int HDP>
constexpr int dq_smem_bytes() {
  return (2 * MMA_BQ * (HDP + 8) + 2 * dq_stage_elems<HDP>()) *
         (int)sizeof(bf16);
}

template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dlt, bf16* __restrict__ dq,
                        int S, int Skv, int H, int K, int hd, Strides qs,
                        Strides ks, Strides vs, Strides ds, Strides dqs,
                        long long lse_row, int causal, int window,
                        float scale_log2, float scale) {
  constexpr int TK = dq_tile<HDP>(), LD = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qt = reinterpret_cast<bf16*>(smem_raw);
  bf16* dt = qt + MMA_BQ * LD;
  bf16* ring = dt + MMA_BQ * LD;  // [2][K tile, V tile]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / K);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this lane's two rows

  mma_tile::load_tile<HDP, MMA_THREADS>(
      qt, q + b * qs.b + h * qs.h + (long long)q0 * qs.s, qs.s, S - q0, hd,
      tid);
  mma_tile::load_tile<HDP, MMA_THREADS>(
      dt, dout + b * ds.b + h * ds.h + (long long)q0 * ds.s, ds.s, S - q0,
      hd, tid);
  mma_tile::cp_async_commit();

  const int kv_end = causal ? min(Skv, q0 + MMA_BQ) : Skv;
  const int kv_start = window ? (max(0, q0 - window + 1) / TK) * TK : 0;
  const int n_tiles = (kv_end - kv_start + TK - 1) / TK;
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;
  const auto issue = [&](int it) {
    const int t0 = kv_start + it * TK;
    bf16* st = ring + (it & 1) * dq_stage_elems<HDP>();
    mma_tile::load_tile<HDP, MMA_THREADS, TK>(st, kb + t0 * ks.s, ks.s,
                                              Skv - t0, hd, tid);
    mma_tile::load_tile<HDP, MMA_THREADS, TK>(st + TK * LD, vb + t0 * vs.s,
                                              vs.s, Skv - t0, hd, tid);
    mma_tile::cp_async_commit();
  };

  const float* lb = lse + blockIdx.y * lse_row;
  const float* db = dlt + blockIdx.y * lse_row;
  const float lse0 = r0 < S ? lb[r0] * mma_tile::LOG2E : 0.f;
  const float lse1 = r1 < S ? lb[r1] * mma_tile::LOG2E : 0.f;
  const float d0 = r0 < S ? db[r0] : 0.f, d1 = r1 < S ? db[r1] : 0.f;

  float dqa[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const mma_tile::QSmem<HDP> qa{qt + warp * 16 * LD};
  const mma_tile::QSmem<HDP> da{dt + warp * 16 * LD};

  if (n_tiles > 0) issue(0);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = kv_start + it * TK;
    if (it + 1 < n_tiles) {
      issue(it + 1);
      mma_tile::cp_async_wait<1>();
    } else {
      mma_tile::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ring + (it & 1) * dq_stage_elems<HDP>();
    const bf16* vt = kt + TK * LD;

    float sc[TK / 8][4], dp[TK / 8][4];
    mma_abt<HDP, TK>(sc, qa, kt, lane);  // S = Q K^T
    mma_abt<HDP, TK>(dp, da, vt, lane);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = t0 + 8 * n + 2 * t + (e & 1);
        bool ok = key < Skv && row < S;
        if (causal) ok = ok && row >= key;
        if (window) ok = ok && row - key < window;
        const float p = ok ? mma_tile::fast_exp2(sc[n][e] * scale_log2 -
                                                 (e < 2 ? lse0 : lse1))
                           : 0.f;
        dp[n][e] = ok ? p * (dp[n][e] - (e < 2 ? d0 : d1)) : 0.f;
      }
    }
    mma_xt<HDP, TK>(dqa, dp, kt, lane);  // dQ += dS K
    __syncthreads();  // the stage is refilled at the next iteration
  }
  mma_tile::cp_async_wait<0>();

  bf16* qb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= hd) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(qb + r0 * dqs.s + d) =
          __floats2bfloat162_rn(dqa[n][0] * scale, dqa[n][1] * scale);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(qb + r1 * dqs.s + d) =
          __floats2bfloat162_rn(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

template <class Kernel>
int allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HDP>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* dlt,
                void* dk, void* dv, int B, int S, int Skv, int H, int K,
                int hd, Strides qs, Strides ks, Strides vs, Strides ds,
                Strides dks, Strides dvs, long long lse_row, int causal,
                int window, float scale, cudaStream_t stream) {
  constexpr int smem = dkdv_smem_bytes<HDP>();
  const int e = allow_smem(flash_bwd_dkdv_kernel<HDP>, smem);
  if (e) return e;
  const dim3 grid((Skv + MMA_BKV - 1) / MMA_BKV, B * K);
  flash_bwd_dkdv_kernel<HDP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dlt,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Skv, H, K, hd, qs,
      ks, vs, ds, dks, dvs, lse_row, causal, window,
      scale * mma_tile::LOG2E, scale);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_dq(const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* dlt, void* dq,
              int B, int S, int Skv, int H, int K, int hd, Strides qs,
              Strides ks, Strides vs, Strides ds, Strides dqs,
              long long lse_row, int causal, int window, float scale,
              cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<HDP>();
  const int e = allow_smem(flash_bwd_dq_kernel<HDP>, smem);
  if (e) return e;
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, B * H);
  flash_bwd_dq_kernel<HDP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dlt,
      static_cast<bf16*>(dq), S, Skv, H, K, hd, qs, ks, vs, ds, dqs,
      lse_row, causal, window, scale * mma_tile::LOG2E, scale);
  return (int)cudaGetLastError();
}

// the backward's head dims, rounded up: 32, 64 or 128 (0: refused)
int bwd_hdp(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 0;
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
// dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores: hd a
// multiple of 8, pointers 16-byte aligned and strides multiples of 8).
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
    return launch_mma_hd(hd, q, k, v, o, B, S, Skv, H, K, qs, ks, vs, os,
                         causal, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}


// The training forward: flash_attention_launch's bf16 path (hd <= 128),
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
      hd % 8 != 0 || bwd_hdp(hd) == 0 || B * H > 65535 || lse_row < S ||
      lse_row % 4 != 0 ||
      o_lo != static_cast<float*>(lse) + (long long)B * H * lse_row ||
      !rows_aligned(q, qsb, qss, qsh) ||
      !rows_aligned(k, ksb, kss, ksh) || !rows_aligned(v, vsb, vss, vsh) ||
      !rows_aligned(o, osb, oss, osh))
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  switch (bwd_hdp(hd)) {
    case 32:
      return launch_mma_lse<32>(q, k, v, o, B, S, Skv, H, K, hd, qs, ks, vs,
                                os, causal, window, scale, l, lse_row, st);
    case 64:
      return launch_mma_lse<64>(q, k, v, o, B, S, Skv, H, K, hd, qs, ks, vs,
                                os, causal, window, scale, l, lse_row, st);
    default:
      return launch_mma_lse<128>(q, k, v, o, B, S, Skv, H, K, hd, qs, ks,
                                 vs, os, causal, window, scale, l, lse_row,
                                 st);
  }
}

// D = rowsum(dO o (O + O_lo)), f32, at dlt[(b * H + h) * lse_row + s];
// o, its low halves o_lo and dout [B, S, H, hd] bf16 with 16-byte rows.
int flash_bwd_dot_launch(int B, int S, int H, int hd, const void* o,
                         long long osb, long long oss, long long osh,
                         const void* o_lo, long long lsb, long long lss,
                         long long lsh, const void* dout, long long dsb,
                         long long dss, long long dsh, void* dlt,
                         long long lse_row, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd % 8 != 0 || lse_row < S ||
      !rows_aligned(o, osb, oss, osh) || !rows_aligned(o_lo, lsb, lss, lsh) ||
      !rows_aligned(dout, dsb, dss, dsh))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * S;
  const long long blocks = (rows + MMA_WARPS - 1) / MMA_WARPS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_bwd_dot_kernel<<<(unsigned)blocks, MMA_THREADS, 0,
                         (cudaStream_t)stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(o_lo),
      static_cast<const bf16*>(dout), static_cast<float*>(dlt), S, H, hd,
      Strides{osb, oss, osh}, Strides{lsb, lss, lsh}, Strides{dsb, dss, dsh},
      lse_row, rows);
  return (int)cudaGetLastError();
}

// dK, dV [B, Skv, K, hd] bf16 from q [B, S, H, hd], k / v [B, Skv, K, hd],
// dout [B, S, H, hd] (bf16, 16-byte rows, hd <= 128) and the forward's
// LSE and D rows (f32, row stride lse_row, a multiple of 64 >= S).
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
                          int causal, int window, float scale,
                          void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || hd <= 0 ||
      hd % 8 != 0 || bwd_hdp(hd) == 0 || B * K > 65535 || lse_row < S ||
      lse_row % 64 != 0 || !rows_aligned(q, qsb, qss, qsh) ||
      !rows_aligned(k, ksb, kss, ksh) || !rows_aligned(v, vsb, vss, vsh) ||
      !rows_aligned(dout, dsb, dss, dsh) ||
      !rows_aligned(dk, dksb, dkss, dksh) ||
      !rows_aligned(dv, dvsb, dvss, dvsh) || (uintptr_t)lse % 16 != 0 ||
      (uintptr_t)dlt % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      ds{dsb, dss, dsh}, dks{dksb, dkss, dksh}, dvs{dvsb, dvss, dvsh};
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dlt);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (bwd_hdp(hd)) {
    case 32:
      return launch_dkdv<32>(q, k, v, dout, l, d, dk, dv, B, S, Skv, H, K,
                             hd, qs, ks, vs, ds, dks, dvs, lse_row, causal,
                             window, scale, st);
    case 64:
      return launch_dkdv<64>(q, k, v, dout, l, d, dk, dv, B, S, Skv, H, K,
                             hd, qs, ks, vs, ds, dks, dvs, lse_row, causal,
                             window, scale, st);
    default:
      return launch_dkdv<128>(q, k, v, dout, l, d, dk, dv, B, S, Skv, H, K,
                              hd, qs, ks, vs, ds, dks, dvs, lse_row, causal,
                              window, scale, st);
  }
}

// dQ [B, S, H, hd] bf16, from the same inputs as flash_bwd_dkdv_launch.
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
      hd % 8 != 0 || bwd_hdp(hd) == 0 || B * H > 65535 || lse_row < S ||
      !rows_aligned(q, qsb, qss, qsh) || !rows_aligned(k, ksb, kss, ksh) ||
      !rows_aligned(v, vsb, vss, vsh) ||
      !rows_aligned(dout, dsb, dss, dsh) ||
      !rows_aligned(dq, dqsb, dqss, dqsh))
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      ds{dsb, dss, dsh}, dqs{dqsb, dqss, dqsh};
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dlt);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (bwd_hdp(hd)) {
    case 32:
      return launch_dq<32>(q, k, v, dout, l, d, dq, B, S, Skv, H, K, hd, qs,
                           ks, vs, ds, dqs, lse_row, causal, window, scale,
                           st);
    case 64:
      return launch_dq<64>(q, k, v, dout, l, d, dq, B, S, Skv, H, K, hd, qs,
                           ks, vs, ds, dqs, lse_row, causal, window, scale,
                           st);
    default:
      return launch_dq<128>(q, k, v, dout, l, d, dq, B, S, Skv, H, K, hd,
                            qs, ks, vs, ds, dqs, lse_row, causal, window,
                            scale, st);
  }
}

}  // extern "C"
