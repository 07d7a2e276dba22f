// Representative flags and their compaction over sorted cluster words,
// K19's (pair.cu) two passes around a cumsum.  The word layout ends in
// `head | posA` with posA in the low pos_bits bits and -1 for an invalid
// word, and the invalid words sort last.  (K7, pairwise.cu, finds its
// representatives in one scan, scan.cuh.)
#pragma once

#include "common.cuh"

namespace lm {

// Pass 1: a sorted word starts a representative when its (fwd, pair,
// delta) head differs from the previous word's or its posA is more than
// seed_len past the previous posA.  The -1 words sort last; the last
// valid row writes the candidate count.
static __global__ void rep_flags_kernel(const int64_t* __restrict__ cw,
                                        int64_t m, int pos_bits, int seed_len,
                                        int* __restrict__ rep,
                                        int64_t* __restrict__ n_cands) {
  const int64_t pmask = ((int64_t)1 << pos_bits) - 1;
  for (int64_t i = first_index(); i < m; i += grid_stride()) {
    const int64_t w = cw[i];
    const bool valid = w != -1;
    int r = 0;
    if (valid) {
      const uint64_t head = (uint64_t)w >> pos_bits;
      const uint64_t prev_head =
          i == 0 ? ~(uint64_t)0 : (uint64_t)cw[i - 1] >> pos_bits;
      const int pos_a = (int)(w & pmask);
      const int prev_pos = i == 0 ? 0 : (int)(cw[i - 1] & pmask);
      r = (head != prev_head || pos_a - prev_pos > seed_len) ? 1 : 0;
      if (i == m - 1 || cw[i + 1] == -1) *n_cands = i + 1;
    }
    rep[i] = r;
  }
}

// Pass 2: rep of rank r (1-based) goes to slot r-1.
static __global__ void rep_scatter_kernel(const int* __restrict__ rep,
                                          const int* __restrict__ rank,
                                          int64_t m, int64_t ec,
                                          int64_t* __restrict__ src) {
  for (int64_t i = first_index(); i < m; i += grid_stride()) {
    if (rep[i] && rank[i] <= ec) src[rank[i] - 1] = i;
  }
}

}  // namespace lm
