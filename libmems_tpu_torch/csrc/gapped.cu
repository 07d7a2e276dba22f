// K4: affine traceback walk over full pointer rows, one warp a window.
//
// Replaces libmems_tpu/ops/gapped.py _device_tb_scan (a lax.scan of T
// lockstep steps over the whole batch, bit-packed with packbits for the
// transfer to the host).
//
// Bound: latency (one dependent pointer byte a step).  Design: the walk
// of csrc/walk.cuh with DP cell (i, j) at byte (i-1)*(N+1) + j of the
// window's rows: a ring of whole-row slabs in shared memory where rows
// of N+1 bytes fit it, else slabs of 512 columns; the output is the
// window's 2-bit column codes, so the host copies at most two bits a
// column instead of the JAX scan's three bit rows of T steps.
#include "walk.cuh"

namespace {

// The column of DP cell (r+1, j) in pointer row r: j, the same for
// every row.
struct FullCol {
  __device__ __forceinline__ void enter(int) {}
  __device__ __forceinline__ int at(int j) const { return j; }
  __device__ __forceinline__ int first_row(int) const { return 0; }
};

struct FullColOf {
  __device__ FullCol operator()(int) const { return FullCol(); }
};

template <bool kWhole>
__global__ void traceback_kernel(const unsigned char* __restrict__ ptr,
                                 int64_t total, const int* __restrict__ p_len,
                                 const int* __restrict__ q_len, int B, int M,
                                 int N, int T, int C16, lm_walk::Plan pl,
                                 uint32_t* __restrict__ words,
                                 int* __restrict__ counts,
                                 int* __restrict__ steps) {
  lm_walk::walk_kernel_body<kWhole>(ptr, total, p_len, q_len, B, M, N + 1, T,
                                    C16, pl, words, counts, steps,
                                    FullColOf());
}

using Kernel = decltype(&traceback_kernel<true>);
const Kernel kKernels[2] = {traceback_kernel<false>,
                            traceback_kernel<true>};
lm_walk::Card cards[lm_walk::kMaxCards];

}  // namespace

// ptr: uint8[B, M, N+1] (16-byte aligned); p_len, q_len: int32[B]; words:
// int32[B, C16] with 16 * C16 >= M + N; counts, steps: int32[B];
// geometry: an index of lm_walk::kGeometries to force, or -1 for the
// launcher's pick.  No buffer needs a fill.
extern "C" int lm_traceback(const void* ptr, const void* p_len,
                            const void* q_len, int B, int M, int N, int T,
                            int C16, void* words, void* counts, void* steps,
                            int geometry, void* stream) {
  if (16 * (int64_t)C16 < (int64_t)M + N || (int64_t)M * (N + 1) >= INT_MAX ||
      ((uintptr_t)ptr & 15) != 0)
    return (int)cudaErrorInvalidValue;
  lm_walk::Plan pl;
  const cudaError_t err =
      lm_walk::plan_launch(kKernels, cards, B, M, N + 1, geometry, &pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.warps <= 0) return (int)cudaErrorInvalidConfiguration;
  const auto kernel = kKernels[pl.cols == 0 ? 1 : 0];
  if (B > 0) {
    const unsigned blocks = (unsigned)((B + pl.warps - 1) / pl.warps);
    LM_LAUNCH(kernel, blocks, 32 * pl.warps, (size_t)pl.smem,
              (cudaStream_t)stream, (const unsigned char*)ptr,
              (int64_t)B * M * (N + 1), (const int*)p_len, (const int*)q_len,
              B, M, N, T, C16, pl, (uint32_t*)words, (int*)counts,
              (int*)steps);
  }
  return (int)cudaGetLastError();
}

// The geometry of a K4 launch of B windows of M rows and N+1 columns on
// the current card: geometry g, or the launcher's pick for g < 0.  out:
// int[6] as lm_walk::describe.  Returns -1 for g past the last geometry,
// else a cudaError_t.
extern "C" int lm_traceback_geometry(int B, int M, int N, int g, int* out) {
  if (g >= lm_walk::kGeometryCount) return -1;
  lm_walk::Plan pl;
  const cudaError_t err =
      lm_walk::plan_launch(kKernels, cards, B, M, N + 1, g, &pl);
  if (err != cudaSuccess) return (int)err;
  lm_walk::describe(pl, out);
  return 0;
}
