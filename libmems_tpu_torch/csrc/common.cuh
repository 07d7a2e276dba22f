// Helpers shared by the hand-written kernels of libmems_tpu_torch.
//
// Every kernel launches through LM_LAUNCH so the launch syntax lives in
// one place; every C entry point returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#ifndef LM_LAUNCH
#define LM_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace lm {

// Index helpers of the one-pass table kernels (pairwise.cu, mums.cu,
// seedocc.cu, pair.cu): 256 threads a block, grid-stride loops over int64
// row counts.
constexpr int kTableThreads = 256;

__device__ __forceinline__ int64_t grid_stride() {
  return (int64_t)blockDim.x * gridDim.x;
}

__device__ __forceinline__ int64_t first_index() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

inline unsigned blocks_for(int64_t n) {
  int64_t b = (n + kTableThreads - 1) / kTableThreads;
  if (b < 1) b = 1;
  if (b > 65535 * 8) b = 65535 * 8;
  return (unsigned)b;
}

struct MaxOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a > b ? a : b;
  }
};

struct MinOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a < b ? a : b;
  }
};

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a + b;
  }
};

// Shared scratch block_scan takes: two slots per warp.
constexpr int kScanTmp = 64;

template <typename T>
struct ScanResult {
  T incl;       // op over this thread's value and every earlier thread's
  T excl;       // op over every earlier thread's value (identity for thread 0)
  T prev_excl;  // the previous thread's excl (identity for thread 0)
  T last_excl;  // the block's last thread's excl
  T total;      // op over the whole block
};

// Block-wide scan of one value per thread, in thread order.  Every
// thread of the block must call it; blockDim.x is a multiple of 32 and at
// most 1024.  `tmp` is shared scratch of kScanTmp elements.  Ends with a
// barrier, so `tmp` may be reused by the next call.
template <typename T, typename Op>
__device__ ScanResult<T> block_scan(T v, T identity, Op op, T* tmp) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(full, x, o);
    if (lane >= o) x = op(n, x);
  }
  T ex = __shfl_up_sync(full, x, 1);
  if (lane == 0) ex = identity;
  T ex_prev = __shfl_up_sync(full, ex, 1);
  if (lane == 0) ex_prev = identity;
  if (lane == 31) {
    tmp[warp] = x;        // the warp's total
    tmp[32 + warp] = ex;  // its last lane's exclusive prefix
  }
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? tmp[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T n = __shfl_up_sync(full, w, o);
      if (lane >= o) w = op(n, w);
    }
    tmp[lane] = w;  // op over warps 0..lane
  }
  __syncthreads();
  const T pre = warp > 0 ? tmp[warp - 1] : identity;
  ScanResult<T> r;
  r.incl = op(pre, x);
  r.excl = op(pre, ex);
  if (lane > 0) {
    r.prev_excl = op(pre, ex_prev);
  } else if (warp > 0) {
    r.prev_excl = op(warp > 1 ? tmp[warp - 2] : identity, tmp[32 + warp - 1]);
  } else {
    r.prev_excl = identity;
  }
  r.last_excl = op(nwarps > 1 ? tmp[nwarps - 2] : identity,
                   tmp[32 + nwarps - 1]);
  r.total = tmp[nwarps - 1];
  __syncthreads();
  return r;
}

// Ask L2 for the 128-byte line at p (no register held, no wait).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Dynamic shared memory a block of `kernel` may opt into on the current
// device: the card's per-block opt-in limit less the kernel's static
// shared memory, or -1 when the runtime cannot say.
template <typename Kernel>
inline int64_t max_dyn_smem(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    return -1;
  }
  return (int64_t)optin - (int64_t)attr.sharedSizeBytes;
}

// Lets `kernel` launch with `smem` bytes of dynamic shared memory: an
// error when that exceeds max_dyn_smem, else the opt-in.
template <typename Kernel>
inline cudaError_t allow_dyn_smem(Kernel kernel, int64_t smem) {
  if (smem == 0) return cudaSuccess;
  if (smem > max_dyn_smem(kernel)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr int kCumBlock = 16;
constexpr int kMaxLevels = 8;

// Floats of level scratch blocked_cumsum needs for n elements.
__host__ __device__ inline int64_t cum_scratch(int64_t n) {
  int64_t used = 0;
  for (int l = 0; l < kMaxLevels && n > kCumBlock; ++l) {
    n = (n + kCumBlock - 1) / kCumBlock;
    used += n;
  }
  return used > 0 ? used : 1;
}

// Inclusive prefix sum of x[0..n) into out[0..n) (out may be x) by a
// group of nt threads (tid: this thread's index in it; sync: a barrier of
// the group), in the JAX package's CPU cumsum order: sequential within
// blocks of 16, the block totals' prefix (the same, recursively) added to
// every later block.  lv is scratch for the block totals of every level
// (cum_scratch(n) floats), global or shared.
template <typename Sync>
__device__ inline void blocked_cumsum_in(const float* x, float* out, int n,
                                         float* lv, int tid, int nt,
                                         Sync sync) {
  int len[kMaxLevels + 1];
  int off[kMaxLevels + 1];
  int top = 0;
  len[0] = n;
  off[0] = 0;
  int used = 0;
  while (len[top] > kCumBlock && top < kMaxLevels) {
    len[top + 1] = (len[top] + kCumBlock - 1) / kCumBlock;
    off[top + 1] = used;
    used += len[top + 1];
    ++top;
  }
  // up: sequential prefix inside each block; block totals feed the level
  // above
  for (int l = 0; l <= top; ++l) {
    const float* in = l == 0 ? x : lv + off[l];
    float* o = l == 0 ? out : lv + off[l];
    const int nbk = (len[l] + kCumBlock - 1) / kCumBlock;
    for (int bk = tid; bk < nbk; bk += nt) {
      const int lo = bk * kCumBlock;
      const int hi = min(lo + kCumBlock, len[l]);
      float acc = in[lo];
      o[lo] = acc;
      for (int k = lo + 1; k < hi; ++k) {
        acc = __fadd_rn(acc, in[k]);
        o[k] = acc;
      }
      if (l < top) lv[off[l + 1] + bk] = acc;
    }
    sync();
  }
  // down: every block of a level adds the prefix of the totals before it
  for (int l = top - 1; l >= 0; --l) {
    float* o = l == 0 ? out : lv + off[l];
    const float* up = lv + off[l + 1];
    for (int k = tid; k < len[l]; k += nt) {
      const int bk = k / kCumBlock;
      o[k] = __fadd_rn(o[k], bk > 0 ? up[bk - 1] : 0.0f);
    }
    sync();
  }
}

// blocked_cumsum_in by the whole thread block.
__device__ inline void blocked_cumsum(const float* x, float* out, int n,
                                      float* lv) {
  blocked_cumsum_in(x, out, n, lv, threadIdx.x, blockDim.x,
                    [] { __syncthreads(); });
}

// The 5x5 expected-score matrix W5, passed by value.
struct W5 {
  float w[25];
};

// qw[y][j] = ((q0 w_y0 + q1 w_y1) + (q2 w_y2 + q3 w_y3)) + q4 w_y4 and
// ext_q[j] = gap_extend * (1 - q4) for the columns j < ql of one window,
// by the whole thread block (qwb: [5][N], eq: [N]).
__device__ inline void profile_q_setup(const float* qb, float* qwb, float* eq,
                                       int ql, int N, float gap_extend,
                                       const W5& w5) {
  for (int j = threadIdx.x; j < ql; j += blockDim.x) {
    float qv[5];
    for (int x = 0; x < 5; ++x) qv[x] = qb[j * 5 + x];
    for (int y = 0; y < 5; ++y) {
      const float* wy = w5.w + y * 5;
      const float t01 =
          __fadd_rn(__fmul_rn(qv[0], wy[0]), __fmul_rn(qv[1], wy[1]));
      const float t23 =
          __fadd_rn(__fmul_rn(qv[2], wy[2]), __fmul_rn(qv[3], wy[3]));
      qwb[y * N + j] = __fadd_rn(__fadd_rn(t01, t23), __fmul_rn(qv[4], wy[4]));
    }
    eq[j] = __fmul_rn(gap_extend, __fsub_rn(1.0f, qv[4]));
  }
}

// The row score p_i . qw[j] as an FMA chain over x = 0..4.
__device__ __forceinline__ float profile_row_score(const float* p,
                                                   const float* qwb, int N,
                                                   int j) {
  float s = __fmul_rn(p[0], qwb[j]);
  s = __fmaf_rn(p[1], qwb[N + j], s);
  s = __fmaf_rn(p[2], qwb[2 * N + j], s);
  s = __fmaf_rn(p[3], qwb[3 * N + j], s);
  return __fmaf_rn(p[4], qwb[4 * N + j], s);
}

}  // namespace lm
