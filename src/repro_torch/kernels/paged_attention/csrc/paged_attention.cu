// paged_attention.cu — one-token decode attention over a ring-buffer cache.
//
// Replaces repro/kernels/paged_attention/kernel.py::decode_attention_kernel
// (the Pallas kernel _decode_kernel): each query row (one token, already
// rotated) attends to the W slots of its KV head's ring cache; a slot is
// valid when 0 <= kv_pos <= q_pos, and q_pos - kv_pos < window when a
// window is set; f32 online softmax with the finite mask value -1e30,
// scale 1/sqrt(hd), query head h = k * G + g under KV head k, any group
// size G, output acc / max(l, 1e-30) cast to the input type (bf16 or f32).
//
// Bound on the card: bytes.  Every slot's key and value are read once
// (2 * hd * 2 bytes a slot and KV head in bf16) for 4 * hd * G
// operations, a few operations a byte at tinyllama's G 8, ~24 at
// granite's G 48: both below the card's ratio.  At a batch of 4 there are
// only B * K = 16 (tinyllama) or 4 (granite) KV rows, so the cache must be
// split along W to put enough blocks on the 132 SMs.
//
// Design (bf16): split-KV.  kernel.py cuts the ring into n_split chunks of whole
// 64-slot tiles (enough blocks to cover the SMs several times over, one
// chunk at W <= 64) and tiles G into n_gt blocks of up to GT = 16 query
// heads, so any G runs; the grid is (B * K * n_gt, n_split).  A block
// walks its chunk a tile at a time; slots outside the chunk score -inf,
// so they add nothing even to a chunk whose slots are all masked (m =
// -1e30, every p = 1, as in the Pallas kernel's single pass).  With one
// chunk the block writes the output; otherwise it writes its f32 partial
// (m, l, acc[hd]) to scratch that the wrapper allocates, and
// paged_attention_combine_kernel (one block a query row) rescales each
// split by 2^(m_s - m) (m in log2 units) and divides by max(sum l,
// 1e-30): a split with no valid slot has m_s = -1e30 and weight 0 beside
// a valid one, and no split can turn the result into NaN.
//
// bf16 caches (paged_attention_mma_kernel): one warp a block, its 16
// heads the rows of mma_tile.cuh's tensor-core tile (rows past the group
// are zeros, never written): the queries, then each 64-slot tile of K and
// V, land in shared memory by 16-byte cp.async copies, bf16 (no f32 copy),
// while the warp reads the slots' positions; then Q K^T, the online softmax and P V with
// p = p_hi + p_lo, as the prefill kernel does (the limits hold unchanged,
// mma_tile.cuh).  Blocks of one warp and 18-35 KB of shared memory let
// 6-12 tiles' loads be in flight on an SM.  Above hd 128 the output's
// dims are split over the grid's z as in the prefill kernel
// (mma_tile::out_split): at hd 256 two blocks of 128 dims each form the
// whole Q K^T and the same softmax, each keeping P V for its dims (64
// accumulator registers a lane, not 128); 58 KB of shared memory a block.
//
// f32 caches (paged_attention_kernel, on the CUDA cores): one pass over
// the ring, with G tiled across blocks the same way and no split (no
// served model decodes in f32; the cuda tests hold it to the f32 limit).  A block of gts warps, one per query head of its tile,
// reads each key and value of the ring once for them all, 32 slots a
// tile staged as f32 in shared memory (keys in rows padded to HDP + 1
// floats, so that 32 lanes reading 32 keys' same dim hit 32 banks), each
// thread with LOADS loads in flight before it stores any; lane j scores
// slot j for its warp's head, the warp takes the tile's max and sum by
// shuffles, and each lane accumulates dims lane, lane + 32, ... of p V.
//
// The launcher counts each kernel's launches where it makes them
// (paged_attention_counts), and the chunks of the bf16 kernel's.
//
// The cache is read in the model's [B, W, K, hd] layout through strides
// (rows 16-byte aligned), kv_pos through a batch stride (0: one row of
// positions shared by the batch, as the model's cache keeps it).
//
// Built by repro_torch/_build.py with nvcc for sm_90a, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;  // the combine: 4 warps
constexpr int GT = 16;        // query heads a block, at most
constexpr int BKV = 32;       // slots a tile of the f32 kernel
constexpr int LOADS = 8;      // its loads a thread in flight
// the score of a slot outside the block's chunk: -inf, so that its p is 0
// even while every slot of the chunk is masked (m = -1e30)
__device__ __forceinline__ float out_of_chunk() {
  return __int_as_float(0xff800000);
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

// launches made since the last reset (paged_attention_counts)
enum Counter { F32_LAUNCHES, MMA_LAUNCHES, MMA_CHUNKS, COMBINE_LAUNCHES,
               N_COUNTERS };
long long counts[N_COUNTERS];

// ------------------------------------------- f32 path on the CUDA cores

template <int HDP>
constexpr int smem_floats(int gts) {
  return BKV * (HDP + 1) + BKV * HDP + gts * HDP;
}
static_assert(4 * smem_floats<128>(GT) <= 48 * 1024, "f32 shared memory");
// HDP 256 takes up to 82 KB, as dynamic shared memory past 48 KB

template <int HDP>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ kc,
    const float* __restrict__ vc, const int* __restrict__ kv_pos,
    const int* __restrict__ q_pos, float* __restrict__ o, int W, int K,
    int G, int hd, int n_gt, int gts, long long ksb, long long ksw,
    long long ksh, long long vsb, long long vsw, long long vsh,
    long long pos_sb, long long qpos_sb, int window, float scale) {
  constexpr int KS = HDP + 1;       // padded key row
  constexpr int DPL = HDP / 32;     // dims per lane
  extern __shared__ float smem[];
  float* kt = smem;                  // [BKV][KS]
  float* vt = kt + BKV * KS;         // [BKV][HDP]
  float* qs = vt + BKV * HDP;        // [gts][HDP]

  const int lane = threadIdx.x % 32;
  const int g = threadIdx.x / 32;
  const int bk = blockIdx.x / n_gt;
  const int gi = (blockIdx.x % n_gt) * gts + g;  // head in the group
  const bool live = gi < G;  // the last head tile may be short
  const int b = bk / K;
  const int kh = bk % K;
  const long long row = ((long long)b * K + kh) * G + gi;  // [B, H] row

  for (int d = lane; d < HDP; d += 32)
    qs[g * HDP + d] = live && d < hd ? q[row * hd + d] : 0.f;
  const int qp = q_pos[b * qpos_sb];
  const int* pos = kv_pos + b * pos_sb;
  const float* kb = kc + b * ksb + kh * ksh;
  const float* vb = vc + b * vsb + kh * vsh;

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
        kx[u] = in ? kb[(long long)w * ksw + d] : 0.f;
        vx[u] = in ? vb[(long long)w * vsw + d] : 0.f;
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

  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) o[row * hd + d] = acc[i] * inv;
  }
}

// ------------------------------------------- bf16 path on the tensor cores

using mma_tile::bf16;

// One warp a block: up to 16 query heads of one KV head (the A rows of
// the mma tile; rows past the group's heads are zeros and never written)
// over one chunk of the ring, a 64-slot tile at a time (one cp.async
// group; the slots' validity is read while it lands), the online softmax
// and P V of mma_tile.cuh.
template <int HDP>
__global__ void __launch_bounds__(32) paged_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kc,
    const bf16* __restrict__ vc, const int* __restrict__ kv_pos,
    const int* __restrict__ q_pos, bf16* __restrict__ o,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int W, int K,
    int G, int hd, int n_gt, int gts, int chunk, long long ksb,
    long long ksw, long long ksh, long long vsb, long long vsw,
    long long vsh, long long pos_sb, long long qpos_sb, int window,
    float scale_log2) {
  constexpr int DV = mma_tile::out_dims<HDP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kt = reinterpret_cast<bf16*>(smem_raw);
  bf16* vt = kt + mma_tile::tile_elems<HDP>();  // the DV dims from d0
  bf16* qt = vt + mma_tile::tile_elems<DV>();   // 16 rows
  const int d0 = blockIdx.z * DV;  // this block's output dims d0 + [0, DV)

  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  const int bk = blockIdx.x / n_gt;
  const int g0 = (blockIdx.x % n_gt) * gts;
  const int gt = min(gts, G - g0);
  const int b = bk / K, kh = bk % K;
  const long long row0 = (long long)b * K * G + kh * G + g0;  // [B, H] row

  // the block's queries land with the first tile (one cp.async group)
  mma_tile::load_tile<HDP, 32, 16>(qt, q + row0 * hd, hd, gt, hd, lane);
  float oacc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const int qp = q_pos[b * qpos_sb];
  const int* pos = kv_pos + b * pos_sb;
  const bf16* kb = kc + b * ksb + kh * ksh;
  const bf16* vb = vc + b * vsb + kh * vsh;
  const int start = blockIdx.y * chunk;
  const int end = min(W, start + chunk);
  for (int t0 = start; t0 < end; t0 += mma_tile::TILE_KEYS) {
    __syncwarp();  // the previous tile's readers are done
    mma_tile::load_tile<HDP, 32>(kt, kb + t0 * ksw, ksw, end - t0, hd, lane);
    mma_tile::load_tile<DV, 32>(vt, vb + t0 * vsw + d0, vsw, end - t0,
                                hd - d0, lane);
    mma_tile::cp_async_commit();
    // this lane's 16 slots 8 n + 2 t + c: in the chunk, and valid
    uint32_t in = 0, ok = 0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int w = t0 + 8 * n + 2 * t + c;
        if (w < end) {
          const int kp = pos[w];
          bool valid = kp >= 0 && kp <= qp;
          if (window) valid = valid && (qp - kp) < window;
          in |= 1u << (2 * n + c);
          ok |= (uint32_t)valid << (2 * n + c);
        }
      }
    }
    mma_tile::cp_async_wait<0>();
    __syncwarp();

    float sc[8][4];
    mma_tile::qk_tile<HDP>(sc, mma_tile::QSmem<HDP>{qt}, kt, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t bit = 1u << (2 * n + (e & 1));
        sc[n][e] = (ok & bit)   ? sc[n][e] * scale_log2
                   : (in & bit) ? NEG_INF
                                : out_of_chunk();
      }
    }
    mma_tile::softmax_pv_tile<DV>(sc, m0, m1, l0, l1, oacc, vt, lane);
  }

  l0 = mma_tile::quad_sum(l0);
  l1 = mma_tile::quad_sum(l1);
  const int n_split = gridDim.y;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gi = g + 8 * half;
    if (gi >= gt) continue;
    const float m = half ? m1 : m0, l = half ? l1 : l0;
    const long long row = row0 + gi;
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        const int d = d0 + 8 * n + 2 * t;
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(o + row * hd + d) =
              __floats2bfloat162_rn(oacc[n][2 * half] * inv,
                                    oacc[n][2 * half + 1] * inv);
      }
    } else {
      const long long part = row * n_split + blockIdx.y;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        const int d = d0 + 8 * n + 2 * t;
        if (d < hd)
          *reinterpret_cast<float2*>(part_acc + part * hd + d) =
              make_float2(oacc[n][2 * half], oacc[n][2 * half + 1]);
      }
      if (t == 0 && blockIdx.z == 0) {  // every z has the same (m, l)
        part_ml[2 * part] = m;
        part_ml[2 * part + 1] = l;
      }
    }
  }
}

// one block a query row: out = sum_s e_s acc_s / max(sum_s e_s l_s,
// 1e-30), e_s = 2^(m_s - max_s m_s).  Each warp finds the max and the sum
// (its lanes over the splits), then sums the acc of every fourth split
// (its lanes over the dims, the splits' loads unrolled so that several are
// in flight); the four warps' sums are added in shared memory.  Dims
// lane + 32 i, i < CD (hd <= 256).
__global__ void __launch_bounds__(THREADS) paged_attention_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    bf16* __restrict__ o, int n_split, int hd) {
  constexpr int WARPS = THREADS / 32;
  constexpr int CD = 8;
  __shared__ float red[WARPS][32 * CD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = blockIdx.x;
  const float* ml = part_ml + 2 * row * n_split;
  float m = NEG_INF;
  for (int s = lane; s < n_split; s += 32) m = fmaxf(m, ml[2 * s]);
  m = warp_max(m);
  float l = 0.f;
  for (int s = lane; s < n_split; s += 32)
    l += exp2f(ml[2 * s] - m) * ml[2 * s + 1];
  l = warp_sum(l);
  const float* pa = part_acc + row * n_split * hd;
  float acc[CD];
#pragma unroll
  for (int i = 0; i < CD; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int s = warp; s < n_split; s += WARPS) {
    const float e = exp2f(ml[2 * s] - m);
#pragma unroll
    for (int i = 0; i < CD; ++i)
      if (lane + 32 * i < hd)
        acc[i] += e * pa[(long long)s * hd + lane + 32 * i];
  }
#pragma unroll
  for (int i = 0; i < CD; ++i) red[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  if (warp != 0) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < CD; ++i) {
    const int d = lane + 32 * i;
    if (d >= hd) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w][d];
    o[row * hd + d] = __float2bfloat16_rn(sum * inv);
  }
}

// -------------------------------------------------------------- launches

struct Args {
  int B, W, K, G, hd, n_gt, gts, chunk, n_split;
  const void *q, *kc, *vc;
  long long ksb, ksw, ksh, vsb, vsw, vsh;
  const int* kv_pos;
  long long pos_sb;
  const int* q_pos;
  long long qpos_sb;
  void* o;
  float *part_acc, *part_ml;
  int window;
  float scale;
};

// counts one launch of `counter` (and `chunks` into MMA_CHUNKS) if the
// launch just made succeeded; returns its error code
int launched(Counter counter, int chunks = 0) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) {
    ++counts[counter];
    counts[MMA_CHUNKS] += chunks;
  }
  return (int)e;
}

template <int HDP>
int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HDP>(a.gts);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<HDP><<<a.B * a.K * a.n_gt, 32 * a.gts, smem,
                                stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kc),
      static_cast<const float*>(a.vc), a.kv_pos, a.q_pos,
      static_cast<float*>(a.o), a.W, a.K, a.G, a.hd, a.n_gt, a.gts, a.ksb,
      a.ksw, a.ksh, a.vsb, a.vsw, a.vsh, a.pos_sb, a.qpos_sb, a.window,
      a.scale);
  return launched(F32_LAUNCHES);
}

template <int HDP>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int smem =
      (mma_tile::tile_elems<HDP>() +
       mma_tile::tile_elems<mma_tile::out_dims<HDP>()>() + 16 * (HDP + 8)) *
      (int)sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_mma_kernel<HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.B * a.K * a.n_gt, a.n_split, mma_tile::out_split<HDP>());
  paged_attention_mma_kernel<HDP><<<grid, 32, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kc),
      static_cast<const bf16*>(a.vc), a.kv_pos, a.q_pos,
      static_cast<bf16*>(a.o), a.part_acc, a.part_ml, a.W, a.K, a.G, a.hd,
      a.n_gt, a.gts, a.chunk, a.ksb, a.ksw, a.ksh, a.vsb, a.vsw, a.vsh,
      a.pos_sb, a.qpos_sb, a.window, a.scale * mma_tile::LOG2E);
  const int e = launched(MMA_LAUNCHES, a.n_split);
  if (e != 0 || a.n_split == 1) return e;
  paged_attention_combine_kernel<<<a.B * a.K * a.G, THREADS, 0, stream>>>(
      a.part_acc, a.part_ml, static_cast<bf16*>(a.o), a.n_split, a.hd);
  return launched(COMBINE_LAUNCHES);
}

int launch_mma_hd(const Args& a, cudaStream_t st) {
#define DECODE_MMA_CASE(n) \
  case n:                  \
    return launch_mma<16 * n>(a, st);
  switch ((a.hd + 15) / 16) {
    DECODE_MMA_CASE(1)
    DECODE_MMA_CASE(2)
    DECODE_MMA_CASE(3)
    DECODE_MMA_CASE(4)
    DECODE_MMA_CASE(5)
    DECODE_MMA_CASE(6)
    DECODE_MMA_CASE(7)
    DECODE_MMA_CASE(8)
    DECODE_MMA_CASE(9)
    DECODE_MMA_CASE(10)
    DECODE_MMA_CASE(11)
    DECODE_MMA_CASE(12)
    DECODE_MMA_CASE(13)
    DECODE_MMA_CASE(14)
    DECODE_MMA_CASE(15)
    DECODE_MMA_CASE(16)
  }
#undef DECODE_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The launches made since the last reset: out[0] of the f32 kernel,
// out[1] of the bf16 kernel, out[2] the chunks (grid.y) of those bf16
// launches summed, out[3] of the combine; then zeroes them if `reset`.
void paged_attention_counts(long long* out, int reset) {
  for (int i = 0; i < N_COUNTERS; ++i) {
    out[i] = counts[i];
    if (reset) counts[i] = 0;
  }
}

// q [B, K * G, hd] contiguous (rotated); caches [B, W, K, hd] with the
// given element strides of their first three dims (the last is
// contiguous; rows 16-byte aligned); kv_pos int32 [.., W] with batch
// stride pos_sb, q_pos int32 with batch stride qpos_sb; o [B, K * G, hd]
// contiguous; dtype 0 = float32 (CUDA cores; one chunk), 1 = bfloat16
// (tensor cores).  G is tiled into n_gt blocks of gts <= 16 heads, W into
// n_split chunks of `chunk` slots; with n_split > 1, part_acc (f32
// [B * K * G, n_split, hd]) and part_ml (f32 [B * K * G, n_split, 2]) are
// scratch for the partials.  Returns the launches' CUDA error code.
int paged_attention_launch(int dtype, int B, int W, int K, int G, int hd,
                           int n_gt, int gts, int chunk, int n_split,
                           const void* q, const void* kc, long long ksb,
                           long long ksw, long long ksh, const void* vc,
                           long long vsb, long long vsw, long long vsh,
                           const int* kv_pos, long long pos_sb,
                           const int* q_pos, long long qpos_sb, void* o,
                           float* part_acc, float* part_ml, int window,
                           float scale, void* stream) {
  const long long size = dtype == 0 ? 4 : 2;
  const bool aligned = ((uintptr_t)q % 16) == 0 &&
                       ((uintptr_t)kc % 16) == 0 &&
                       ((uintptr_t)vc % 16) == 0 &&
                       (hd * size) % 16 == 0 && (ksb * size) % 16 == 0 &&
                       (ksw * size) % 16 == 0 && (ksh * size) % 16 == 0 &&
                       (vsb * size) % 16 == 0 && (vsw * size) % 16 == 0 &&
                       (vsh * size) % 16 == 0;
  if (B <= 0 || W <= 0 || K <= 0 || G <= 0 || hd <= 0 || hd > 256 ||
      !aligned || n_gt <= 0 || gts <= 0 || gts > GT ||
      (long long)n_gt * gts < G || chunk <= 0 ||
      (long long)chunk * n_split < W ||
      (long long)chunk * (n_split - 1) >= W || n_split > 65535 ||
      (dtype == 0 && n_split != 1) ||
      (long long)B * K * n_gt > 2147483647LL ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{B,      W,      K,      G,      hd,       n_gt,
               gts,    chunk,  n_split, q,     kc,       vc,
               ksb,    ksw,    ksh,    vsb,    vsw,      vsh,
               kv_pos, pos_sb, q_pos,  qpos_sb, o,       part_acc,
               part_ml, window, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    if (hd <= 32) return launch_f32<32>(a, st);
    if (hd <= 64) return launch_f32<64>(a, st);
    if (hd <= 128) return launch_f32<128>(a, st);
    return launch_f32<256>(a, st);
  }
  if (dtype == 1) return launch_mma_hd(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
