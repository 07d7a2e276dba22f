// Pieces of the strip kernels shared by the banded profile DP (K10/K11,
// csrc/banded.cu), the full-width one (K3/K9 and K24/K25,
// csrc/profile.cu) and the pairwise Gotoh forward (K22, csrc/gotoh.cu):
// a window's columns are cut into strips of 32 lanes x K columns, one
// warp a strip, and strips run the rows as a pipeline, handing each other
// one row-tagged 64-bit word per value through a ring in shared memory,
// or through global memory between blocks.
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

// The int32 form (K22, csrc/gotoh.cu): the value's bits in the low word.
__device__ __forceinline__ unsigned long long row_word(int v, int row) {
  return ((unsigned long long)(unsigned)row << 32) | (unsigned)v;
}

__device__ __forceinline__ int await_row_int(
    const volatile unsigned long long* w, int row) {
  unsigned long long x;
  do {
    x = *w;
  } while ((int)(x >> 32) != row);
  return (int)(unsigned)x;
}

// ---------------------------------------------------------------------------
// Strips over several blocks (K24/K25, csrc/profile.cu span_kernel; K22,
// csrc/gotoh.cu gotoh_span_kernel).  A window's S strips go W to a
// block, C = ceil(S / W) blocks a window.
// Inside a block the strips hand rows on through the shared ring as
// above; at a block's edge the last strip writes the same row-tagged
// words into a column in global memory, [rows][kWords] words an edge
// (kWords <= kSlot, the words a kernel hands on) and
// zeroed by the launcher (row tags start at 1, so a zero never reads as
// ready), with no back-pressure: the column holds every row.  The next
// block's warp 0 (the receiver) copies them into ring set 0, where the
// block's first strip reads them as from a strip of its own block.
//
// Forward progress: a block takes (window, segment) from an atomic
// ticket, numbered segment-major within a window, so it waits only on
// the block of the ticket before it, which already runs.  No block count
// needs to be resident at once, and a window's width has no cap.

// Rows a receiver's poll loads at once (half the ring).
constexpr int kBatch = kRing / 2;

// The block's ticket; every thread of the block must call it.
__device__ __forceinline__ int take_ticket(unsigned* counter) {
  __shared__ unsigned ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  __syncthreads();
  return (int)ticket;
}

// The receiver: rows 1..rows of kWords hand-off words from the global
// column src (src[(i-1)*kWords + k], tagged with row i) into ring set 0
// (ring[(i % kRing)*kSlot + k]), a word a lane: each poll loads the next
// kBatch rows at once (one coalesced load) and passes on the rows that
// have arrived before the first that has not, so a row waits for no
// later one.  A row's slot is free once the block's first strip has
// read the row kRing before it (used[1]).  Called by the 32 lanes of one
// warp.
template <int kWords>
__device__ void receive_rows(const unsigned long long* src,
                             volatile unsigned long long* ring,
                             volatile int* used, int rows, int lane) {
  static_assert(kBatch * kWords <= 32, "a batch is a word a lane");
  const volatile unsigned long long* vs = src;
  const int r = lane / kWords;
  const int k = lane - r * kWords;
  for (int base = 1; base <= rows;) {
    const int i = base + r;
    const bool mine = r < kBatch && i <= rows;
    unsigned long long x = 0;
    if (mine) x = vs[(int64_t)(i - 1) * kWords + k];
    // rows base .. base+n-1 have arrived: n whole rows before the first
    // lane whose word has not (lanes past the batch count as arrived)
    const unsigned late = __ballot_sync(kFull, mine && (int)(x >> 32) != i);
    const int first_late = late ? __ffs(late) - 1 : 32;
    const int n = min(first_late / kWords, min(kBatch, rows - base + 1));
    if (n == 0) continue;
    if (lane == 0) {
      while (used[1] < base + n - 1 - kRing) {
      }
    }
    __syncwarp();
    if (r < n) ring[(i % kRing) * kSlot + k] = x;
    base += n;
  }
}

inline cudaError_t sm_count(int* n_sm) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

// The geometries of the span kernels (K24/K25 in csrc/profile.cu, K22 in
// csrc/gotoh.cu), which the host prices alike (ops.profile.span_pick):
// kSpanK[g] columns a lane, W <= kSpanMaxW strips a block.  Odd and even
// widths: at an odd K a cell pair straddles two lanes, at an even K none
// does.
constexpr int kSpanK[] = {17, 16, 13, 9, 8, 5, 3, 1};
constexpr int kSpanGeometryCount = 8;
constexpr int kSpanMaxW = 8;

// The strips of K columns a lane that cover an N-column bucket's N+1
// columns.
__host__ __device__ inline int span_strips(int N, int K) {
  return (N + 1 + 32 * K - 1) / (32 * K);
}

// A span kernel's fits on the current card, for the host's pick: out:
// int[1 + 8 + 8 * 8], the SM count, kSpanK, then at 9 + g*8 + W-1 the
// blocks an SM holds of geometry g with W strips a block of W + 1 warps
// (0: the block does not fit the kernel's registers).  kernel_of(g) is
// geometry g's kernel, smem_of(g, W) its dynamic shared memory, which
// does not depend on the bucket, so one query a card serves every launch.
template <typename KernelOf, typename SmemOf>
int span_fits(int* out, KernelOf kernel_of, SmemOf smem_of) {
  int n_sm = 0;
  cudaError_t err = sm_count(&n_sm);
  if (err != cudaSuccess) return (int)err;
  out[0] = n_sm;
  for (int g = 0; g < kSpanGeometryCount; ++g) out[1 + g] = kSpanK[g];
  int* fits = out + 1 + kSpanGeometryCount;
  for (int g = 0; g < kSpanGeometryCount; ++g) {
    const void* fn = kernel_of(g);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    for (int W = 1; W <= kSpanMaxW; ++W) {
      const int threads = 32 * (W + 1);
      int blocks = 0;
      if (threads <= attr.maxThreadsPerBlock) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, fn, threads, (size_t)smem_of(g, W));
        if (err != cudaSuccess) return (int)err;
      }
      fits[g * kSpanMaxW + W - 1] = blocks;
    }
  }
  return 0;
}

}  // namespace lm_strip
