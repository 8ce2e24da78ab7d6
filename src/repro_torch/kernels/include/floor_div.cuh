// floor_div.cuh — floor division and floor modulo by a positive int32
// divisor that is fixed for a whole sweep point, as a multiply and a
// shift (Granlund & Montgomery, "Division by invariant integers using
// multiplication", PLDI 1994).
//
// The GPU has no integer divide: `a / b` by a run-time `b` is some twenty
// instructions through the SFU's reciprocal.  A FloorDiv is built once
// from its divisor d (1 <= d <= 2^31 - 1) and then divides with a 32 x 32
// -> 64-bit multiply, a shift and two xors.
//
// The dividend's sign is folded first: floor(a / d) = ~floor(~a / d) for
// a < 0 (~a = -a - 1), so the unsigned operand u = a ^ (a >> 31) stays
// below 2^31, INT32_MIN included.  For N = 31-bit operands, l =
// ceil(log2 d) and m = ceil(2^(31 + l) / d) satisfy 2^(31+l) <= m d <=
// 2^(31+l) + 2^l, so floor(u / d) = floor(u m / 2^(31 + l)) exactly
// (their Theorem 4.2), and m < 2^32.  The remainder is a - q d in
// wrapping uint32 arithmetic, always in [0, d).
//
// Included by sim_step.cu (repro_torch/_build.py passes this directory
// to nvcc and hashes it with the sources); it is plain C++ outside nvcc,
// so a host compiler can build it too.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FLOOR_DIV_HD __host__ __device__ __forceinline__
#else
#define FLOOR_DIV_HD inline
#endif

struct FloorDiv {
  uint32_t m;  // ceil(2^s / d)
  int s;       // 31 + ceil(log2 d)
  int d;       // the divisor

  // d must be positive (the launchers refuse any other divisor)
  static FLOOR_DIV_HD FloorDiv make(int d) {
    int l = 0;
    while ((1u << l) < (uint32_t)d) ++l;
    const uint64_t p = (uint64_t)1 << (31 + l);
    return FloorDiv{(uint32_t)((p + (uint32_t)d - 1) / (uint32_t)d), 31 + l,
                    d};
  }

  // floor(a / d)
  FLOOR_DIV_HD int div(int a) const {
    const uint32_t sgn = (uint32_t)(a >> 31);
    const uint32_t u = (uint32_t)a ^ sgn;
    return (int)((uint32_t)(((uint64_t)u * m) >> s) ^ sgn);
  }

  // a - d * floor(a / d), in [0, d)
  FLOOR_DIV_HD int mod(int a) const {
    return (int)((uint32_t)a - (uint32_t)div(a) * (uint32_t)d);
  }
};

#undef FLOOR_DIV_HD
