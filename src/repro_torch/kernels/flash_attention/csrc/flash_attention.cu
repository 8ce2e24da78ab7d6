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
// Bound on the card: at the model's shapes (hd 64, S up to a few
// thousand) the work is 4 * hd operations per (query, key) pair, against
// 2 * hd * 2 bytes per key and query row read once, so operations bound
// it.  This first kernel does them in f32 on the CUDA cores, as the Pallas
// kernel's f32 dots do, not on the tensor cores (wgmma is later work).
//
// Design.  One block of 128 threads per (query tile, batch, head): R =
// HDP / 32 threads share one query row (HDP = hd rounded up to 32, 64 or
// 128), each owning 32 of its dims as 8 float4 groups, dims 4 * (c + R *
// i) + t for lane c of the row, so the R lanes read neighbouring 16-byte
// words of a shared-memory row.  The query rows and the running m, l and
// acc live in registers.  K and V tiles of 32 keys are staged in shared
// memory as f32 (8 loads a thread in flight before any store).  A
// tile's 32 scores are formed first (an R-lane shuffle sum per key),
// then the tile max, the correction and the p * V update.
// Tiles that every row of the block masks (above the causal diagonal,
// before the window) are skipped: for a row with a valid key the Pallas
// kernel's result does not depend on them (their p is 0, or is cleared by
// the correction exp(-1e30 - m) = 0 once a valid tile arrives).  The
// model's [B, S, H, hd] layout is read through strides, with bounds
// checks in place of ops.py's padding.
//
// Built by repro_torch/_build.py with nvcc for sm_90a, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int BKV = 32;
constexpr int LOADS = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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
  __shared__ __align__(16) float kt[BKV * HDP];
  __shared__ __align__(16) float vt[BKV * HDP];

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
  const int kv_start = window ? (max(0, q0 - window + 1) / BKV) * BKV : 0;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int t0 = kv_start; t0 < kv_end; t0 += BKV) {
    __syncthreads();
    // LOADS elements of K and V a thread in flight before any is stored
    for (int base = tid; base < BKV * HDP; base += LOADS * THREADS) {
      float kx[LOADS], vx[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int idx = base + u * THREADS;
        const int j = t0 + idx / HDP;
        const int d = idx % HDP;
        const bool in = idx < BKV * HDP && j < Skv && d < hd;
        kx[u] = in ? to_f32(kb[(long long)j * ks.s + d]) : 0.f;
        vx[u] = in ? to_f32(vb[(long long)j * vs.s + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int idx = base + u * THREADS;
        if (idx < BKV * HDP) {
          kt[idx] = kx[u];
          vt[idx] = vx[u];
        }
      }
    }
    __syncthreads();

    float s[BKV];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
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
    for (int j = 0; j < BKV; ++j) {
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
  return launch<T, 128>(q, k, v, o, B, S, Skv, H, K, hd, qs, ks, vs, os,
                        causal, window, scale, stream);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [B, S, H, hd], k / v [B, Skv, K, hd], o [B, S, H, hd], each with the
// given element strides of its first three dims (the last is contiguous);
// dtype 0 = float32, 1 = bfloat16.  Returns the launch's CUDA error code.
int flash_attention_launch(int dtype, int B, int S, int Skv, int H, int K,
                           int hd, const void* q, long long qsb,
                           long long qss, long long qsh, const void* k,
                           long long ksb, long long kss, long long ksh,
                           const void* v, long long vsb, long long vss,
                           long long vsh, void* o, long long osb,
                           long long oss, long long osh, int causal,
                           int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || hd <= 0 ||
      hd > 128 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, S, Skv, H, K, qs, ks, vs, os,
                            causal, window, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, Skv, H, K, qs, ks,
                                    vs, os, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
