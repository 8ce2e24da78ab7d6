// mma_tile.cuh — the tensor-core tile of the decode-attention kernel
// (paged_attention.cu), on mma.sync; flash_attention.cu takes its
// constants and small helpers (fast_exp2, quad_sum), its bf16 forward
// being on wgmma (wgmma_tma.cuh).
//
// One warp owns 16 query rows (the A operand of mma.sync.m16n8k16, bf16
// in, f32 accumulators) and walks tiles of 64 keys that stay bf16 in
// shared memory, rows padded by 16 bytes (HDP + 8 elements) so that the 8
// rows an ldmatrix reads fall in 32 distinct banks.  Per tile:
// qk_tile forms S = Q K^T (the products of bf16 inputs are exact in f32;
// only the summation order differs from an f32 dot); the caller scales
// S by log2(e) / sqrt(hd) and writes its masks (-1e30 for a masked key,
// -inf for a key outside its range); softmax_pv_tile runs the online
// softmax in f32 registers (row max and sum over the 4 lanes of a quad,
// the SFU's exp2) and O += P V.  P V needs P as a bf16 A fragment where
// the Pallas kernels keep p in f32, so p is split p = p_hi + p_lo (p_hi =
// bf16(p), p_lo = bf16(p - p_hi)) and both products are accumulated in
// f32: |p - p_hi - p_lo| <= 2^-16 |p|, far below an output's bf16 ulp.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4 g + t; A
// a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
// B b0 (k 2t.., n g), b1 (k 2t + 8.., n g); C c0, c1 (g, 2t..), c2, c3
// (g + 8, 2t..).  So a lane holds rows g and g + 8 of the output.
//
// Included by the kernels' sources (repro_torch/_build.py passes this
// directory to nvcc and hashes it with them).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tile {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE_KEYS = 64;  // keys a tile

// bf16 elements of one padded K or V tile
template <int HDP>
__host__ __device__ constexpr int tile_elems() {
  return TILE_KEYS * (HDP + 8);
}

// The output's dims a block keeps accumulators for: all HDP up to
// MAX_OUT_DIMS; above it the dims are split over out_split() blocks of
// out_dims() each (a multiple of 16), every block forming the whole Q K^T
// and the same online softmax but P V for its own dims only.  At HDP 256
// that is two blocks of 128 dims: 64 accumulator registers a thread
// instead of 128.
constexpr int MAX_OUT_DIMS = 128;
template <int HDP>
__host__ __device__ constexpr int out_split() {
  return (HDP + MAX_OUT_DIMS - 1) / MAX_OUT_DIMS;
}
template <int HDP>
__host__ __device__ constexpr int out_dims() {
  return (HDP / out_split<HDP>() + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a * b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi, y - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// 2^x by the SFU (ex2.approx, a few ulps: far below the output's bf16 ulp)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ROWS rows of a tile from src (row r at src + r * stride) into a padded
// tile by THREADS threads, 16-byte cp.async copies; rows >= n and dims
// >= hd zero-filled (their addresses kept in bounds)
template <int HDP, int THREADS, int ROWS = TILE_KEYS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int n, int hd,
                                          int tid) {
  constexpr int CH = HDP / 8;  // 16-byte chunks a row
  static_assert(ROWS * CH % THREADS == 0, "chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CH, d = (c % CH) * 8;
    const bool in = r < n && d < hd;
    cp_async16(smem_u32(dst + r * (HDP + 8) + d),
               src + (in ? r * stride + d : 0), in ? 16 : 0);
  }
}

// A warp's 16 query rows as the A operand, one 16-dim k-step at a time,
// read from a padded tile in shared memory by ldmatrix (matrix m at rows
// + 8 (m % 2), dims + 8 (m / 2)) at every k-step: the queries land with
// the first tile's cp.async copies.
template <int HDP>
struct QSmem {
  const bf16* tile;  // 16 padded rows
  __device__ __forceinline__ void get(int s, uint32_t (&r)[4],
                                      int lane) const {
    ldmatrix_x4(r, smem_u32(tile +
                            ((lane & 7) + 8 * ((lane >> 3) & 1)) * (HDP + 8) +
                            16 * s + 8 * (lane >> 4)));
  }
};

// S = Q K^T over one tile of 64 keys (a padded tile in shared memory):
// 8 accumulator tiles of 8 keys; K's B fragments by ldmatrix, matrix m at
// keys + 8 (m / 2), dims + 8 (m % 2)
template <int HDP, class Q>
__device__ __forceinline__ void qk_tile(float (&sc)[8][4], const Q& q,
                                        const bf16* kt, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
  for (int s = 0; s < HDP / 16; ++s) {
    uint32_t qa[4];
    q.get(s, qa, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bk[4];
      const int key = 16 * np + (lane & 7) + 8 * (lane >> 4);
      const int d = 16 * s + 8 * ((lane >> 3) & 1);
      ldmatrix_x4(bk, smem_u32(kt + key * (HDP + 8) + d));
      mma_bf16(sc[2 * np], qa, bk[0], bk[1]);
      mma_bf16(sc[2 * np + 1], qa, bk[2], bk[3]);
    }
  }
}

// The online softmax over one tile's scaled, masked scores sc (log2
// units), then O += P V: m0 / m1 the running max of rows g / g + 8, l0 /
// l1 this lane's part of their sums (the quad's parts add up at the end).
// P's accumulators are its A fragments (a0 / a1 from key tile 2 kk, a2 /
// a3 from 2 kk + 1); V's B fragments by ldmatrix.trans, matrix m at keys
// + 8 (m % 2), dims + 8 (m / 2).
template <int HDP>
__device__ __forceinline__ void softmax_pv_tile(float (&sc)[8][4],
                                                float& m0, float& m1,
                                                float& l0, float& l1,
                                                float (&oacc)[HDP / 8][4],
                                                const bf16* vt, int lane) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
    mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float c0 = fast_exp2(m0 - mx0), c1 = fast_exp2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  l0 *= c0;
  l1 *= c1;
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
    oacc[n][0] *= c0;
    oacc[n][1] *= c0;
    oacc[n][2] *= c1;
    oacc[n][3] *= c1;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* x = sc[2 * kk + half];
      x[0] = fast_exp2(x[0] - m0);
      x[1] = fast_exp2(x[1] - m0);
      x[2] = fast_exp2(x[2] - m1);
      x[3] = fast_exp2(x[3] - m1);
      l0 += x[0] + x[1];
      l1 += x[2] + x[3];
      split_bf16(x[0], x[1], ahi[2 * half], alo[2 * half]);
      split_bf16(x[2], x[3], ahi[2 * half + 1], alo[2 * half + 1]);
    }
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      uint32_t bv[4];
      const int key = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
      const int d = 16 * dp + 8 * (lane >> 4);
      ldmatrix_x4_trans(bv, smem_u32(vt + key * (HDP + 8) + d));
      mma_bf16(oacc[2 * dp], ahi, bv[0], bv[1]);
      mma_bf16(oacc[2 * dp], alo, bv[0], bv[1]);
      mma_bf16(oacc[2 * dp + 1], ahi, bv[2], bv[3]);
      mma_bf16(oacc[2 * dp + 1], alo, bv[2], bv[3]);
    }
  }
}

// the quad's sum of l (rows g, g + 8)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma_tile
