// ssm_scan.cu — chunk-local Mamba-1 selective scan.
//
// Replaces repro/kernels/ssm_scan/kernel.py::ssm_scan_kernel (the Pallas
// kernel _ssm_kernel): over a chunk of T steps, for every batch row b,
// channel d and state n,
//
//     h_t = decay_t * h_{t-1} + dbu_t          h_0 = h0
//     y_t = sum_n c_t[n] * h_t[n]
//
// all in f32, returning h_T and y.  The recurrence is written as
// __fadd_rn(__fmul_rn(decay, h), dbu): two rounded operations and no FMA
// contraction, as PyTorch computes `decay * h + dbu`, so h matches the
// plain version bit for bit.  y's N-sum is a fixed butterfly of shuffles,
// another order than einsum's; it is held to the plain y within
// 2 * N * 2^-24 * sum_n |c_t[n] * h_t[n]| (ref.py::y_limit).
//
// Bound on the card: bytes.  Each step reads decay and dbu (8 bytes a
// state element) and does 2 operations on them, plus 2 for y, so the
// least time is the bytes over 3.35 TB/s: 4 * (2 B T D N + B T N + 2 B D N
// + B T D) bytes, 0.32 ms for the full-width chunk B 4 x T 256 x D 8192 x
// N 16 (1.07 GB).
//
// Design.  One thread per state element (b, d, n): a warp holds 32 / NP
// channels' NP = next power of two >= N lanes each, so at N 16 a warp's
// loads of decay[b, t] and dbu[b, t] are two channels' contiguous 128-byte
// rows, and the 16x more threads in flight than one per channel (B D N =
// 524 288 at full width) keep the memory system busy.  Only time is
// serial, and it is a loop inside the thread: the loads of a step do not
// depend on h, so each thread keeps the next U steps' decay, dbu and c in
// registers (loaded before the current U steps' arithmetic), 2 U loads in
// flight a thread.  The N lanes of a channel sum y with __shfl_xor_sync;
// lane n = 0 writes it.  Lanes past N (N not a power of two) hold 0 and
// add 0; channels past D (a bounds check, no padding) load nothing and
// write nothing but take part in the shuffles.  Blocks are independent:
// grid (ceil(D / (256 / NP)), B).
//
// Training.  ssm_scan_launch given hseq runs the same kernel and writes
// every h_t ([B, T, D, N] f32, 4 B T D N more bytes), so that the backward
// reads h_{t-1} instead of recomputing it: of the two ways, writing h costs
// one [B, T, D, N] array more in the forward and none in the backward,
// where recomputing it from the chunk's h0 (every U-th h kept in
// registers, each segment replayed before it is reversed) reads decay and
// dbu a second time, two arrays more.  Autograd keeps h for the backward
// in place of dbu (the backward needs no dbu), so the peak memory is that
// of the plain version's saved decay and dbu.
//
// The backward (ssm_scan_bwd_kernel), for one chunk, from the cotangents
// dy [B, T, D] and dh_T [B, D, N], backwards in time:
//
//     lam_{T-1} = c_{T-1}[n] dy_{T-1}[d] + dh_T
//     lam_t     = c_t[n] dy_t[d] + decay_{t+1} lam_{t+1}
//     d dbu_t   = lam_t         d decay_t = lam_t h_{t-1}   (h_{-1} = h0)
//     dh0       = decay_0 lam_0
//     dc_t[n]   = sum_d dy_t[d] h_t[d, n]
//
// each product and sum one _rn operation, as autograd rounds them when it
// differentiates the plain version (every sum there has two terms, so its
// order does not matter): d decay, d dbu and dh0 equal the plain
// version's bit for bit.  dc sums over all D channels, across blocks: a
// block sums its CH channels for each (t, n) in a fixed order (the xor
// butterfly over the channels of a warp, offsets NP, 2 NP, .., 16, then
// the warps 0 .. 7 in turn) and writes the partial dc_part[b, block, t, n];
// ssm_scan_dc_sum_kernel adds the blocks' partials in a fixed order
// (contiguous segments of blocks in block order, then the segments).  No
// atomics: two runs give the same bits.  dc is held to the plain version
// within 2 D 2^-24 sum_d |dy_t[d] h_t[d, n]| (ref.py::dc_limit), the
// bound of two f32 sums of D terms taken in different orders.
//
// Its layout is the forward's (a thread per (b, d, n), the next U steps'
// loads in flight), walking t from T - 1 down.  Bound: bytes.  It reads
// decay and h_seq and writes d decay and d dbu, 4 B T D N f32, plus c, dy
// and the partials: 4 (4 B T D N + B T N + B T D + 3 B D N + B T N D / CH)
// bytes, 1.09 GB for falcon-mamba-7b's chunk B 2 x T 256 x D 8 192 x N 16,
// 0.33 ms at 3.35 TB/s.
//
// Built by repro_torch/_build.py with nvcc for sm_90a, bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;  // steps loaded ahead

// SAVE: also write every h_t at hseq (training)
template <int NP, bool SAVE>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_kernel(const float* __restrict__ decay,
                    const float* __restrict__ dbu,
                    const float* __restrict__ c,
                    const float* __restrict__ h0, float* __restrict__ hout,
                    float* __restrict__ y, float* __restrict__ hseq, int T,
                    int D, int N) {
  constexpr int CH = THREADS / NP;  // channels a block
  const int n = threadIdx.x % NP;
  const int d = blockIdx.x * CH + threadIdx.x / NP;
  const int b = blockIdx.y;
  const bool live = d < D && n < N;

  // element (b, t, d, n) of decay / dbu is at base + t * step
  const long long step = (long long)D * N;
  const long long base = (long long)b * T * step + (long long)d * N + n;
  const float* cb = c + (long long)b * T * N + n;
  const long long hidx = ((long long)b * D + d) * N + n;
  float* yb = y + (long long)b * T * D + d;

  float h = live ? h0[hidx] : 0.f;
  float dc[U], bc[U], cc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = live && u < T;
    dc[u] = in ? decay[base + u * step] : 0.f;
    bc[u] = in ? dbu[base + u * step] : 0.f;
    cc[u] = in ? cb[(long long)u * N] : 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += U) {
    // the next U steps' loads, issued before this group's arithmetic
    float dn[U], bn[U], cn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + U + u;
      const bool in = live && t < T;
      dn[u] = in ? decay[base + t * step] : 0.f;
      bn[u] = in ? dbu[base + t * step] : 0.f;
      cn[u] = in ? cb[(long long)t * N] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < T) {  // the same t on every lane: the shuffles stay whole
        h = __fadd_rn(__fmul_rn(dc[u], h), bc[u]);
        if constexpr (SAVE) {
          if (live) hseq[base + t * step] = h;
        }
        float p = __fmul_rn(cc[u], h);
#pragma unroll
        for (int off = NP / 2; off > 0; off >>= 1)
          p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
        if (n == 0 && d < D) yb[(long long)t * D] = p;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dc[u] = dn[u];
      bc[u] = bn[u];
      cc[u] = cn[u];
    }
  }
  if (live) hout[hidx] = h;
}

template <int NP>
int launch(const float* decay, const float* dbu, const float* c,
           const float* h0, float* hout, float* y, float* hseq, int B, int T,
           int D, int N, cudaStream_t stream) {
  constexpr int CH = THREADS / NP;
  const dim3 grid((D + CH - 1) / CH, B);
  if (hseq != nullptr)
    ssm_scan_kernel<NP, true><<<grid, THREADS, 0, stream>>>(
        decay, dbu, c, h0, hout, y, hseq, T, D, N);
  else
    ssm_scan_kernel<NP, false><<<grid, THREADS, 0, stream>>>(
        decay, dbu, c, h0, hout, y, nullptr, T, D, N);
  return (int)cudaGetLastError();
}

int launch_np(const float* decay, const float* dbu, const float* c,
              const float* h0, float* hout, float* y, float* hseq, int B,
              int T, int D, int N, cudaStream_t st) {
#define SSM_FWD_CASE(np)                                                    \
  if (N <= np)                                                              \
    return launch<np>(decay, dbu, c, h0, hout, y, hseq, B, T, D, N, st);
  SSM_FWD_CASE(1)
  SSM_FWD_CASE(2)
  SSM_FWD_CASE(4)
  SSM_FWD_CASE(8)
  SSM_FWD_CASE(16)
  SSM_FWD_CASE(32)
#undef SSM_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

// The backward of one chunk (see the note at the top): a thread per
// (b, d, n), t from T - 1 down, the next U steps' loads (decay_t, h_{t-1},
// c_t[n], dy_t[d]) issued before the current U steps' arithmetic; dc's
// block partials through shared memory once every U steps.
template <int NP>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_bwd_kernel(const float* __restrict__ decay,
                        const float* __restrict__ hseq,
                        const float* __restrict__ h0,
                        const float* __restrict__ c,
                        const float* __restrict__ dy,
                        const float* __restrict__ dht,
                        float* __restrict__ ddecay, float* __restrict__ ddbu,
                        float* __restrict__ dh0,
                        float* __restrict__ dc_part, int T, int D, int N) {
  constexpr int CH = THREADS / NP;  // channels a block
  constexpr int WARPS = THREADS / 32;
  __shared__ float red[U][WARPS][NP];  // a group's warp sums of dc
  const int n = threadIdx.x % NP, lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int d = blockIdx.x * CH + threadIdx.x / NP;
  const int b = blockIdx.y;
  const bool live = d < D && n < N;

  const long long step = (long long)D * N;
  const long long base = (long long)b * T * step + (long long)d * N + n;
  const float* cb = c + (long long)b * T * N + n;
  const float* yb = dy + (long long)b * T * D + d;
  const long long hidx = ((long long)b * D + d) * N + n;
  float* part = dc_part + ((long long)b * gridDim.x + blockIdx.x) * T * N;

  // step t's loads: decay_t, h_{t-1} (h0 at t = 0), c_t[n], dy_t[d]
  float dc[U], hp[U], cc[U], gy[U];
  const auto load = [&](int t, float& a, float& h, float& e, float& g) {
    const bool in = live && t >= 0;
    a = in ? decay[base + t * step] : 0.f;
    h = in ? (t > 0 ? hseq[base + (t - 1) * step] : h0[hidx]) : 0.f;
    e = in ? cb[(long long)t * N] : 0.f;
    g = in ? yb[(long long)t * D] : 0.f;
  };
#pragma unroll
  for (int u = 0; u < U; ++u) load(T - 1 - u, dc[u], hp[u], cc[u], gy[u]);
  float carry = live ? dht[hidx] : 0.f;  // decay_{t+1} lam_{t+1}, dh_T
  float ht = live ? hseq[base + (T - 1) * step] : 0.f;  // h_t
  for (int t0 = T - 1; t0 >= 0; t0 -= U) {
    float dn[U], hn[U], cn[U], gn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) load(t0 - U - u, dn[u], hn[u], cn[u], gn[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {  // the same t on every lane: the shuffles stay whole
        const float lam = __fadd_rn(__fmul_rn(cc[u], gy[u]), carry);
        if (live) {
          ddbu[base + t * step] = lam;
          ddecay[base + t * step] = __fmul_rn(lam, hp[u]);
        }
        carry = __fmul_rn(dc[u], lam);
        float p = __fmul_rn(gy[u], ht);
#pragma unroll
        for (int off = NP; off < 32; off <<= 1)
          p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
        if (lane < NP) red[u][warp][lane] = p;
        ht = hp[u];
      }
    }
    __syncthreads();
    if (threadIdx.x < U * NP) {
      const int u = threadIdx.x / NP, m = threadIdx.x % NP, t = t0 - u;
      if (t >= 0 && m < N) {
        float sum = red[u][0][m];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum = __fadd_rn(sum, red[u][w][m]);
        part[(long long)t * N + m] = sum;
      }
    }
    __syncthreads();  // red is rewritten by the next group
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dc[u] = dn[u];
      hp[u] = hn[u];
      cc[u] = cn[u];
      gy[u] = gn[u];
    }
  }
  if (live) dh0[hidx] = carry;
}

// dc[b, t, n] = the sum over the nblk blocks' partials, spread over the
// card: a block takes DC_COLS vectors of V consecutive outputs (16-byte
// loads along t n at V = 4) and splits each output's partials into DC_SEG
// contiguous segments of blocks, a thread a (segment, vector).  A thread
// adds its segment in block order; then a thread an output adds the
// non-empty segments' sums in segment order through shared memory.  No
// atomics: the order is fixed.  At falcon-mamba-7b's chunk (B 2 x T 256 x
// N 16, 512 partials) that is 256 blocks for 132 SMs, 16 loads a thread;
// one thread an output adding all 512 in turn made 32 blocks.
constexpr int DC_SEG = 32;
constexpr int DC_COLS = THREADS / DC_SEG;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  float v[1];
  __device__ __forceinline__ static Vec load(const float* p) {
    return Vec{{*p}};
  }
};
template <>
struct Vec<4> {
  float v[4];
  __device__ __forceinline__ static Vec load(const float* p) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    return Vec{{f.x, f.y, f.z, f.w}};
  }
};

template <int V>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_dc_sum_kernel(const float* __restrict__ dc_part,
                           float* __restrict__ dc, int nblk, int TN,
                           long long n_vec) {
  __shared__ float red[DC_SEG][DC_COLS * V];
  const int col = threadIdx.x % DC_COLS, seg = threadIdx.x / DC_COLS;
  // segment seg: blocks k0 .. k1 - 1 (empty where nblk < DC_SEG)
  const auto first = [&](int s) {
    return (int)((long long)s * nblk / DC_SEG);
  };
  const long long iv = (long long)blockIdx.x * DC_COLS + col;
  const int k0 = first(seg), k1 = first(seg + 1);
  if (iv < n_vec && k1 > k0) {
    const long long i = iv * V;
    const float* p = dc_part + (i / TN * nblk + k0) * TN + i % TN;
    Vec<V> sum = Vec<V>::load(p);
#pragma unroll 8
    for (int k = 1; k < k1 - k0; ++k) {
      const Vec<V> x = Vec<V>::load(p + (long long)k * TN);
#pragma unroll
      for (int e = 0; e < V; ++e) sum.v[e] = __fadd_rn(sum.v[e], x.v[e]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) red[seg][col * V + e] = sum.v[e];
  }
  __syncthreads();
  if (threadIdx.x < DC_COLS * V) {
    const long long o = (long long)blockIdx.x * DC_COLS * V + threadIdx.x;
    if (o < n_vec * V) {
      float sum = 0.f;
      bool any = false;
      for (int s = 0; s < DC_SEG; ++s) {
        if (first(s + 1) == first(s)) continue;
        sum = any ? __fadd_rn(sum, red[s][threadIdx.x]) : red[s][threadIdx.x];
        any = true;
      }
      dc[o] = sum;
    }
  }
}

template <int NP>
int launch_bwd(const float* decay, const float* hseq, const float* h0,
               const float* c, const float* dy, const float* dht,
               float* ddecay, float* ddbu, float* dh0, float* dc_part, int B,
               int T, int D, int N, cudaStream_t stream) {
  constexpr int CH = THREADS / NP;
  const dim3 grid((D + CH - 1) / CH, B);
  ssm_scan_bwd_kernel<NP><<<grid, THREADS, 0, stream>>>(
      decay, hseq, h0, c, dy, dht, ddecay, ddbu, dh0, dc_part, T, D, N);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int T, int D, int N) {
  return B > 0 && B <= 65535 && T > 0 && D > 0 && N > 0 && N <= 32;
}

}  // namespace

extern "C" {

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// decay / dbu [B, T, D, N], c [B, T, N], h0 / hout [B, D, N], y [B, T, D],
// all contiguous float32; 1 <= N <= 32.  hseq: null to serve, or [B, T, D,
// N] f32 where the training forward writes every h_t.  Returns the
// launch's CUDA error code.
int ssm_scan_launch(int B, int T, int D, int N, const void* decay,
                    const void* dbu, const void* c, const void* h0,
                    void* hout, void* y, void* hseq, void* stream) {
  if (!shape_ok(B, T, D, N)) return (int)cudaErrorInvalidValue;
  return launch_np(static_cast<const float*>(decay),
                   static_cast<const float*>(dbu),
                   static_cast<const float*>(c),
                   static_cast<const float*>(h0), static_cast<float*>(hout),
                   static_cast<float*>(y), static_cast<float*>(hseq), B, T, D,
                   N, (cudaStream_t)stream);
}

// The number of blocks along D of the backward (the partials' second dim).
int ssm_scan_bwd_blocks(int D, int N) {
  if (D <= 0 || N <= 0 || N > 32) return 0;
  int np = 1;
  while (np < N) np *= 2;
  const int ch = THREADS / np;
  return (D + ch - 1) / ch;
}

// The backward of one chunk: decay, hseq (the training forward's h) [B, T,
// D, N], h0 [B, D, N], c [B, T, N], dy [B, T, D], dht [B, D, N] ->
// ddecay, ddbu [B, T, D, N], dh0 [B, D, N] and dc_part [B, nblk, T, N]
// (nblk = ssm_scan_bwd_blocks(D, N)), all contiguous f32.
int ssm_scan_bwd_launch(int B, int T, int D, int N, const void* decay,
                        const void* hseq, const void* h0, const void* c,
                        const void* dy, const void* dht, void* ddecay,
                        void* ddbu, void* dh0, void* dc_part, void* stream) {
  if (!shape_ok(B, T, D, N)) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(decay);
  const float* hs = static_cast<const float*>(hseq);
  const float* hi = static_cast<const float*>(h0);
  const float* cp = static_cast<const float*>(c);
  const float* gp = static_cast<const float*>(dy);
  const float* dt = static_cast<const float*>(dht);
  float* o1 = static_cast<float*>(ddecay);
  float* o2 = static_cast<float*>(ddbu);
  float* o3 = static_cast<float*>(dh0);
  float* o4 = static_cast<float*>(dc_part);
  const cudaStream_t st = (cudaStream_t)stream;
#define SSM_BWD_CASE(np)                                                    \
  if (N <= np)                                                              \
    return launch_bwd<np>(a, hs, hi, cp, gp, dt, o1, o2, o3, o4, B, T, D, N, \
                          st);
  SSM_BWD_CASE(1)
  SSM_BWD_CASE(2)
  SSM_BWD_CASE(4)
  SSM_BWD_CASE(8)
  SSM_BWD_CASE(16)
  SSM_BWD_CASE(32)
#undef SSM_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// dc [B, T, N] = the sum of dc_part [B, nblk, T, N] over its blocks
// (contiguous f32): each output's blocks in DC_SEG contiguous segments,
// each in block order, the segments in order.
int ssm_scan_dc_sum_launch(int B, int T, int N, int nblk,
                           const void* dc_part, void* dc, void* stream) {
  if (B <= 0 || T <= 0 || N <= 0 || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  const long long tn = (long long)T * N;
  if (tn > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool wide =
      tn % 4 == 0 && reinterpret_cast<uintptr_t>(dc_part) % 16 == 0;
  const int V = wide ? 4 : 1;
  const long long n_vec = (long long)B * tn / V;
  const long long blocks = (n_vec + DC_COLS - 1) / DC_COLS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const float* part = static_cast<const float*>(dc_part);
  float* out = static_cast<float*>(dc);
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    ssm_scan_dc_sum_kernel<4><<<(unsigned)blocks, THREADS, 0, st>>>(
        part, out, nblk, (int)tn, n_vec);
  else
    ssm_scan_dc_sum_kernel<1><<<(unsigned)blocks, THREADS, 0, st>>>(
        part, out, nblk, (int)tn, n_vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
