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

template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_attention_mma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o, int S, int Skv, int H,
                               int K, int hd, Strides qs, Strides ks,
                               Strides vs, Strides os, int causal,
                               int window, float scale_log2) {
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

  const float inv0 = 1.f / fmaxf(mma_tile::quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(mma_tile::quad_sum(l1), 1e-30f);
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
}

template <int HDP>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Skv, int H, int K, int hd, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<HDP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_mma_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, B * H,
                  mma_tile::out_split<HDP>());
  flash_attention_mma_kernel<HDP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Skv, H, K, hd,
      qs, ks, vs, os, causal, window, scale * mma_tile::LOG2E);
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

}  // extern "C"
