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
// Built by repro_torch/_build.py with nvcc for sm_90a, bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;  // steps loaded ahead

template <int NP>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_kernel(const float* __restrict__ decay,
                    const float* __restrict__ dbu,
                    const float* __restrict__ c,
                    const float* __restrict__ h0, float* __restrict__ hout,
                    float* __restrict__ y, int T, int D, int N) {
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
           const float* h0, float* hout, float* y, int B, int T, int D, int N,
           cudaStream_t stream) {
  constexpr int CH = THREADS / NP;
  const dim3 grid((D + CH - 1) / CH, B);
  ssm_scan_kernel<NP><<<grid, THREADS, 0, stream>>>(decay, dbu, c, h0, hout,
                                                    y, T, D, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// decay / dbu [B, T, D, N], c [B, T, N], h0 / hout [B, D, N], y [B, T, D],
// all contiguous float32; 1 <= N <= 32.  Returns the launch's CUDA error
// code.
int ssm_scan_launch(int B, int T, int D, int N, const void* decay,
                    const void* dbu, const void* c, const void* h0,
                    void* hout, void* y, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || D <= 0 || N <= 0 || N > 32)
    return (int)cudaErrorInvalidValue;
  const float* dp = static_cast<const float*>(decay);
  const float* bp = static_cast<const float*>(dbu);
  const float* cp = static_cast<const float*>(c);
  const float* hp = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(hout);
  float* yo = static_cast<float*>(y);
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 1) return launch<1>(dp, bp, cp, hp, ho, yo, B, T, D, N, st);
  if (N <= 2) return launch<2>(dp, bp, cp, hp, ho, yo, B, T, D, N, st);
  if (N <= 4) return launch<4>(dp, bp, cp, hp, ho, yo, B, T, D, N, st);
  if (N <= 8) return launch<8>(dp, bp, cp, hp, ho, yo, B, T, D, N, st);
  if (N <= 16) return launch<16>(dp, bp, cp, hp, ho, yo, B, T, D, N, st);
  return launch<32>(dp, bp, cp, hp, ho, yo, B, T, D, N, st);
}

}  // extern "C"
