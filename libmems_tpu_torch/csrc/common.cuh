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

template <typename T>
struct ScanResult {
  T incl;   // op over this thread's value and every earlier thread's
  T excl;   // op over every earlier thread's value (identity for thread 0)
  T total;  // op over the whole block
};

// Block-wide scan of one value per thread, in thread order.  Every
// thread of the block must call it; blockDim.x is a multiple of 32 and at
// most 1024.  `tmp` is shared scratch of 32 elements.  Ends with a
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
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? tmp[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T n = __shfl_up_sync(full, w, o);
      if (lane >= o) w = op(n, w);
    }
    tmp[lane] = w;
  }
  __syncthreads();
  const T pre = warp > 0 ? tmp[warp - 1] : identity;
  ScanResult<T> r;
  r.incl = op(pre, x);
  r.excl = op(pre, ex);
  r.total = tmp[nwarps - 1];
  __syncthreads();
  return r;
}

}  // namespace lm
