// The representatives of sorted cluster words in one compacting scan
// (scan.cuh), shared by K7 (pairwise.cu) and K19 (pair.cu): both word
// layouts end in `head | posA`, posA in the low pos_bits bits, with -1
// for an invalid word, and the invalid words sort last.  A word starts a
// representative when its head differs from its predecessor's or its
// posA is more than seed_len past the predecessor's (matchfind.py
// :1163-1178 for K7, :546-560 for K19).  Rep r's word index goes to
// index[r], in word order (the JAX searchsorted over the monotone ranks
// picks the same words); the last valid word leaves n_cands (scratch
// word 1) and n_reps (word 2), which the wrapper reads once.
#pragma once

#include "common.cuh"
#include "scan.cuh"

namespace lm {

static __global__ void __launch_bounds__(kScanThreads)
    rep_index_kernel(const int64_t* __restrict__ cw, int64_t m, int pos_bits,
                     int seed_len, int* __restrict__ index,
                     unsigned long long* __restrict__ scratch) {
  // the words sort -1 last, so a block whose own tile starts at -1 has
  // nothing to do and takes no ticket: the tickets then number exactly
  // the tiles that hold a valid word
  if (cw[(int64_t)blockIdx.x * kScanTile] == -1) return;
  const int64_t tile = take_tile(scratch);
  const int64_t t0 = tile * kScanTile;
  const int lane = threadIdx.x & 31;
  const int64_t wbase = t0 + (threadIdx.x >> 5) * kWarpSpan;
  const int64_t pmask = ((int64_t)1 << pos_bits) - 1;
  int64_t w[kScanItems];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t i = wbase + j * 32 + lane;
    w[j] = i < m ? cw[i] : -1;
  }
  // the words before lane 0's and after lane 31's first and last items
  const int64_t before = wbase > 0 && wbase <= m ? cw[wbase - 1] : -1;
  const int64_t after = wbase + kWarpSpan < m ? cw[wbase + kWarpSpan] : -1;
  unsigned ballot[kScanItems];
  unsigned last = 0;   // bit j: item j is the last valid word
  unsigned count = 0;
  int64_t prev_lane0 = before;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t i = wbase + j * 32 + lane;
    int64_t prev = __shfl_up_sync(0xffffffffu, w[j], 1);
    if (lane == 0) prev = prev_lane0;
    prev_lane0 = __shfl_sync(0xffffffffu, w[j], 31);
    int64_t next = __shfl_down_sync(0xffffffffu, w[j], 1);
    const int64_t next_lane31 =
        j + 1 < kScanItems ? __shfl_sync(0xffffffffu, w[j + 1 < kScanItems
                                                           ? j + 1 : j], 0)
                           : after;
    if (lane == 31) next = next_lane31;
    const bool valid = w[j] != -1;
    bool rep = false;
    if (valid) {
      const unsigned long long head = (unsigned long long)w[j] >> pos_bits;
      const unsigned long long prev_head =
          i == 0 ? ~0ull : (unsigned long long)prev >> pos_bits;
      const int pos_a = (int)(w[j] & pmask);
      const int prev_pos = i == 0 ? 0 : (int)(prev & pmask);
      rep = head != prev_head || pos_a - prev_pos > seed_len;
      if (i == m - 1 || next == -1) last |= 1u << j;
    }
    ballot[j] = __ballot_sync(0xffffffffu, rep);
    count += __popc(ballot[j]);
  }
  unsigned warp_off, total;
  const unsigned long long off =
      block_offsets(scratch, tile, count, &warp_off, &total);
  unsigned long long at = off + warp_off;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const unsigned long long rank = at + __popc(ballot[j] & lanes_below());
    if ((ballot[j] >> lane) & 1) index[rank] = (int)(wbase + j * 32 + lane);
    if ((last >> j) & 1) {
      scratch[1] = wbase + j * 32 + lane + 1;
      scratch[2] = rank + ((ballot[j] >> lane) & 1);
    }
    at += __popc(ballot[j]);
  }
}

// The scan's launch on `stream`: cw int64[m] sorted (unsigned order, -1
// last); index int32[m] (the first n_reps are written); scratch
// int64[scan_scratch_words(m)], zeroed here.
static inline int launch_rep_index(const void* cw, int64_t m, int pos_bits,
                                   int seed_len, void* index, void* scratch,
                                   cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, scan_scratch_words(m) * sizeof(int64_t), stream);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    LM_LAUNCH(rep_index_kernel, (unsigned)scan_tiles(m), kScanThreads, 0,
              stream, (const int64_t*)cw, m, pos_bits, seed_len, (int*)index,
              (unsigned long long*)scratch);
  }
  return (int)cudaGetLastError();
}

}  // namespace lm
