// Pieces of the strip kernels shared by the banded profile DP (K10/K11,
// csrc/banded.cu) and the full-width one (K3/K9, csrc/profile.cu): a
// window's columns are cut into strips of 32 lanes x K columns, one warp a
// strip, and strips run the rows as a pipeline, handing each other one
// row-tagged 64-bit word per value through a ring in shared memory.
#pragma once

#include "common.cuh"

namespace lm_strip {

constexpr int kRing = 16;   // rows a strip may run ahead of the next
constexpr int kSlot = 3;    // words a hand-off slot holds
constexpr unsigned kFull = 0xffffffffu;
// Warps an SM issues from at once (four schedulers): below this many
// strips an SM, a row takes one strip's latency.
constexpr int kIssueWarps = 4;

// qw[y] of one q column: ((q0 w_y0 + q1 w_y1) + (q2 w_y2 + q3 w_y3)) +
// q4 w_y4, as lm::profile_q_setup forms it.
__device__ __forceinline__ float qw_of(const float* qv, const lm::W5& w5,
                                       int y) {
  const float* wy = w5.w + y * 5;
  const float t01 =
      __fadd_rn(__fmul_rn(qv[0], wy[0]), __fmul_rn(qv[1], wy[1]));
  const float t23 =
      __fadd_rn(__fmul_rn(qv[2], wy[2]), __fmul_rn(qv[3], wy[3]));
  return __fadd_rn(__fadd_rn(t01, t23), __fmul_rn(qv[4], wy[4]));
}

// A hand-off word: a float and the row it belongs to, stored as one
// 64-bit word, so that a reader that sees the row sees the value and
// neither side needs a memory fence.
__device__ __forceinline__ unsigned long long row_word(float v, int row) {
  return ((unsigned long long)(unsigned)row << 32) | __float_as_uint(v);
}

__device__ __forceinline__ float await_row_word(
    const volatile unsigned long long* w, int row) {
  unsigned long long x;
  do {
    x = *w;
  } while ((int)(x >> 32) != row);
  return __uint_as_float((unsigned)x);
}

inline cudaError_t sm_count(int* n_sm) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace lm_strip
