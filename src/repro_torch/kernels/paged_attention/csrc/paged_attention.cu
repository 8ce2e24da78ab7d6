// paged_attention.cu — one-token decode attention over a ring-buffer cache.
//
// Replaces repro/kernels/paged_attention/kernel.py::decode_attention_kernel
// (the Pallas kernel _decode_kernel): each query row (one token, already
// rotated) attends to the W slots of its KV head's ring cache; a slot is
// valid when 0 <= kv_pos <= q_pos, and q_pos - kv_pos < window when a
// window is set; f32 online softmax with the finite mask value -1e30,
// scale 1/sqrt(hd), query head h = k * G + g under KV head k, output
// acc / max(l, 1e-30) cast to the input type (bf16 or f32).
//
// Bound on the card: bytes.  Every valid slot's key and value are read
// once (2 * hd * 2 bytes a slot and KV head in bf16) for 4 * hd * G
// operations, a few operations a byte, far below the card's ratio.
//
// Design.  One block per (batch row, KV head), one warp per query head
// of its group (G warps), so the block reads each key and value once
// for all G query rows.  The block walks the cache in tiles of 32 slots:
// the tile's keys and values are staged in shared memory as f32, each
// thread with 8 loads in flight before it stores any (keys in rows
// padded to HDP + 1 floats, so that 32 lanes reading 32 keys' same dim
// hit 32 banks); lane j scores slot j of the tile for its warp's
// query, the warp takes the tile max and sum by shuffles, and each lane
// then accumulates dims lane, lane + 32, ... of p * V.  The cache is read
// in the model's [B, W, K, hd] layout through strides (no transposed
// copy), kv_pos through a batch stride (0: one row of positions shared
// by the batch, as the model's cache keeps it), and the ragged last tile
// is masked by a bounds check (no padding of W).  Split-KV over more
// blocks, for more than B * K blocks in flight, is later work.
//
// Built by repro_torch/_build.py with nvcc for sm_90a, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HDP>
constexpr int smem_floats(int G) {
  return BKV * (HDP + 1) + BKV * HDP + G * HDP;
}

template <typename T, int HDP>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ kv_pos,
    const int* __restrict__ q_pos, T* __restrict__ o, int W, int K, int G,
    int hd, long long ksb, long long ksw, long long ksh, long long vsb,
    long long vsw, long long vsh, long long pos_sb, long long qpos_sb,
    int window, float scale) {
  constexpr int KS = HDP + 1;       // padded key row
  constexpr int DPL = HDP / 32;     // dims per lane
  extern __shared__ float smem[];
  float* kt = smem;                  // [BKV][KS]
  float* vt = kt + BKV * KS;         // [BKV][HDP]
  float* qs = vt + BKV * HDP;        // [G][HDP]

  const int lane = threadIdx.x % 32;
  const int g = threadIdx.x / 32;
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const long long row = ((long long)b * K + kh) * G + g;  // [B, H] row

  for (int d = lane; d < HDP; d += 32)
    qs[g * HDP + d] = d < hd ? to_f32(q[row * hd + d]) : 0.f;
  const int qp = q_pos[b * qpos_sb];
  const int* pos = kv_pos + b * pos_sb;
  const T* kb = kc + b * ksb + kh * ksh;
  const T* vb = vc + b * vsb + kh * vsh;

  float m = NEG_INF, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < W; t0 += BKV) {
    __syncthreads();
    // LOADS elements of K and V a thread in flight before any is stored
    for (int base = threadIdx.x; base < BKV * HDP;
         base += LOADS * blockDim.x) {
      float kx[LOADS], vx[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int idx = base + u * blockDim.x;
        const int w = t0 + idx / HDP;
        const int d = idx % HDP;
        const bool in = idx < BKV * HDP && w < W && d < hd;
        kx[u] = in ? to_f32(kb[(long long)w * ksw + d]) : 0.f;
        vx[u] = in ? to_f32(vb[(long long)w * vsw + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx < BKV * HDP) {
          kt[(idx / HDP) * KS + idx % HDP] = kx[u];
          vt[idx] = vx[u];
        }
      }
    }
    __syncthreads();

    const float* qg = qs + g * HDP;
    const float* kr = kt + lane * KS;
    float dot = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) dot += qg[d] * kr[d];
    const int w = t0 + lane;
    bool ok = false;
    if (w < W) {
      const int kp = pos[w];
      ok = kp >= 0 && kp <= qp;
      if (window) ok = ok && (qp - kp) < window;
    }
    const float s = ok ? dot * scale : NEG_INF;
    const float m_new = fmaxf(m, warp_max(s));
    const float p = expf(s - m_new);
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const float* vr = vt + j * HDP + lane;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += pj * vr[32 * i];
    }
    m = m_new;
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) o[row * hd + d] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int HDP>
int launch(int B, int W, int K, int G, int hd, const void* q,
           const void* kc, long long ksb, long long ksw, long long ksh,
           const void* vc, long long vsb, long long vsw, long long vsh,
           const int* kv_pos, long long pos_sb, const int* q_pos,
           long long qpos_sb, void* o, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HDP>(G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<T, HDP><<<B * K, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), kv_pos, q_pos, static_cast<T*>(o), W, K, G,
      hd, ksb, ksw, ksh, vsb, vsw, vsh, pos_sb, qpos_sb, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int B, int W, int K, int G, int hd, const void* q,
              const void* kc, long long ksb, long long ksw, long long ksh,
              const void* vc, long long vsb, long long vsw, long long vsh,
              const int* kv_pos, long long pos_sb, const int* q_pos,
              long long qpos_sb, void* o, int window, float scale,
              cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 32>(B, W, K, G, hd, q, kc, ksb, ksw, ksh, vc, vsb, vsw,
                         vsh, kv_pos, pos_sb, q_pos, qpos_sb, o, window,
                         scale, st);
  if (hd <= 64)
    return launch<T, 64>(B, W, K, G, hd, q, kc, ksb, ksw, ksh, vc, vsb, vsw,
                         vsh, kv_pos, pos_sb, q_pos, qpos_sb, o, window,
                         scale, st);
  return launch<T, 128>(B, W, K, G, hd, q, kc, ksb, ksw, ksh, vc, vsb, vsw,
                        vsh, kv_pos, pos_sb, q_pos, qpos_sb, o, window,
                        scale, st);
}

}  // namespace

extern "C" {

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [B, K * G, hd] contiguous (rotated); caches [B, W, K, hd] with the
// given element strides of their first three dims (the last is
// contiguous); kv_pos int32 [.., W] with batch stride pos_sb, q_pos int32
// with batch stride qpos_sb; o [B, K * G, hd] contiguous; dtype 0 =
// float32, 1 = bfloat16.  Returns the launch's CUDA error code.
int paged_attention_launch(int dtype, int B, int W, int K, int G, int hd,
                           const void* q, const void* kc, long long ksb,
                           long long ksw, long long ksh, const void* vc,
                           long long vsb, long long vsw, long long vsh,
                           const int* kv_pos, long long pos_sb,
                           const int* q_pos, long long qpos_sb, void* o,
                           int window, float scale, void* stream) {
  if (B <= 0 || W <= 0 || K <= 0 || G <= 0 || G > 32 || hd <= 0 ||
      hd > 128)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(B, W, K, G, hd, q, kc, ksb, ksw, ksh, vc, vsb,
                            vsw, vsh, kv_pos, pos_sb, q_pos, qpos_sb, o,
                            window, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(B, W, K, G, hd, q, kc, ksb, ksw, ksh, vc,
                                    vsb, vsw, vsh, kv_pos, pos_sb, q_pos,
                                    qpos_sb, o, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
