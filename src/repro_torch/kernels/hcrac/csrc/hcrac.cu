// hcrac.cu — the batched, read-only HCRAC probe as a CUDA kernel.
//
// Replaces repro/kernels/hcrac/kernel.py::hcrac_lookup_kernel (Pallas,
// pallas_call in _hcrac_kernel's launcher): for each query gid at cycle
// t, the set is floormod(gid, n_sets), and the query hits if one of the
// set's ways holds the gid (not -1) and is still alive — the idealised
// timer t - itime <= C, or the IIC/EC sweep test (same sweep window of
// the slot's phase (set * W + way + 1) * sweep_period).  No LRU side
// effect: the serving scheduler's probe.
//
// The Pallas kernel keeps the whole tag/itime table in VMEM and tiles the
// queries 256 a program.  Here one thread takes one query and reads its
// set's W ways from global memory; the table (16 KB at 1 024 entries x 2
// ways, 512 KB at 64 Ki entries) stays resident in the 50 MB L2, so the
// kernel is bound by the bytes of the query stream — 12 B a query (gid,
// time, hit) — and, at the serving scheduler's batches of a few queries,
// by the launch itself.  The ragged last block is masked with q < Q (the
// Pallas wrapper pads with gid -1 instead).  The set is a floor modulo,
// so a negative gid (the host scheduler's int32-wrapped page ids) lands
// where hcrac.insert put it.
//
// Built by repro_torch/_build.py with nvcc for sm_90a, bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NO_TAG = -1;

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__global__ void hcrac_lookup_kernel(int Q, int n_sets, int W, int caching,
                                    int period, int exact,
                                    const int* __restrict__ gids,
                                    const int* __restrict__ times,
                                    const int* __restrict__ tags,
                                    const int* __restrict__ itime,
                                    int* __restrict__ hits) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const int gid = gids[q];
  const int t = times[q];
  const int set = floormod(gid, n_sets);
  const int base = set * W;
  int hit = 0;
  for (int w = 0; w < W; ++w) {
    const int tag = tags[base + w];
    if (tag == NO_TAG || tag != gid) continue;
    const int it = itime[base + w];
    bool alive;
    if (exact) {
      alive = wsub(t, it) <= caching;
    } else {
      const int phase = wmul(base + w + 1, period);
      alive = floordiv(wsub(t, phase), caching) ==
              floordiv(wsub(it, phase), caching);
    }
    hit |= alive ? 1 : 0;
  }
  hits[q] = hit;
}

}  // namespace

extern "C" {

const char* hcrac_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch ceil(Q / block) blocks of ``block`` threads on ``stream``;
// returns the launch's CUDA error code (0 on success).  Every pointer is
// device memory.
int hcrac_lookup_launch(int Q, int n_sets, int W, int caching, int period,
                        int exact, int block, const int* gids,
                        const int* times, const int* tags, const int* itime,
                        int* hits, void* stream) {
  if (Q <= 0 || n_sets <= 0 || W <= 0 || caching <= 0 || block <= 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (Q + block - 1) / block;
  hcrac_lookup_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      Q, n_sets, W, caching, period, exact, gids, times, tags, itime, hits);
  return (int)cudaGetLastError();
}

}  // extern "C"
