// K18-K19: the pair fast path of find_mums (G = 2, unique MUMs), the
// passes of libmems_tpu/matchfind.py _fused_pair_pipeline between its two
// library sorts.
//
// K18, cluster words, replaces :499-543.  Pass 1 packs every window of
// both genomes into one word content | gid | pos | strand (:499-507); the
// wrapper sorts the words (a library sort there too).  Pass 2 reads rows
// i-1, i, i+1, i+2 of the sorted words, decides the exact-pair flag (a
// content run of length two, genome 0 then genome 1, not the sentinel
// content; past the table's end the content reads as the all-ones fill and
// before it as no content at all) and writes the pair's cluster word
// fwd | biased diagonal | posA, or -1; it also counts the candidates (a
// warp shuffle sum, one atomic add a warp: integers, so the count does not
// depend on the order).
//
// K19, representatives, replaces :546-594 on the sorted cluster words: the
// representative flags (reps.cuh), their compaction to the
// cumsum rank (the JAX binary search over the ranks picks the same rows in
// the same order) and per representative the extension row K2 takes: both
// left ends, the strand of genome 1, and a length seeded with the
// cluster's extent.  A cluster's last member is the row before the next
// representative, or the last candidate, so no thread walks a cluster.
// Rows past the representative count are absent: zero left ends, forward,
// length seed_len.
//
// Bound: memory traffic.  Each pass reads one int64 word a row (the
// neighbour rows come from cache) and writes one; the two sorts between
// them cost more than the passes.
//
// 64-bit words are int64 holding unsigned patterns (bit 63 is set when
// 2 * weight + 3 + pos_bits reaches 64): shifts go through uint64, and
// the -1 sentinel is all ones.
#include "common.cuh"
#include "reps.cuh"

namespace {

constexpr int kThreads = lm::kTableThreads;
using lm::blocks_for;
using lm::first_index;
using lm::grid_stride;
using lm::rep_flags_kernel;
using lm::rep_scatter_kernel;

// K18 pass 1: word of window i of genome gid (rows [0, na) are genome 0,
// rows [na, na + nb) genome 1).
__global__ void pair_pack_kernel(const int64_t* __restrict__ keys_a,
                                 int64_t na,
                                 const int64_t* __restrict__ keys_b,
                                 int64_t nb, int pos_bits,
                                 int64_t* __restrict__ out) {
  const int64_t n = na + nb;
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const uint64_t gid = i < na ? 0 : 1;
    const uint64_t pos = (uint64_t)(i < na ? i : i - na);
    const uint64_t key = (uint64_t)(i < na ? keys_a[i] : keys_b[i - na]);
    out[i] = (int64_t)(((key >> 1) << (pos_bits + 2)) |
                       (gid << (pos_bits + 1)) | (pos << 1) | (key & 1));
  }
}

// K18 pass 2: exact-pair flag and cluster word of each sorted row.
__global__ void pair_cluster_words_kernel(const int64_t* __restrict__ w,
                                          int64_t n, int pos_bits,
                                          int64_t sent_content,
                                          int64_t* __restrict__ cw,
                                          unsigned long long* n_cands) {
  const uint64_t cmax = ~(uint64_t)0 >> (pos_bits + 2);
  const uint64_t pmask = ((uint64_t)1 << pos_bits) - 1;
  unsigned int mine = 0;
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const uint64_t w0 = (uint64_t)w[i];
    const uint64_t c = w0 >> (pos_bits + 2);
    const bool has1 = i + 1 < n, has2 = i + 2 < n;
    const uint64_t w1 = has1 ? (uint64_t)w[i + 1] : 0;
    const uint64_t c1 = has1 ? w1 >> (pos_bits + 2) : cmax;
    const uint64_t c2 = has2 ? (uint64_t)w[i + 2] >> (pos_bits + 2) : cmax;
    // row 0 has no previous content: nothing equals it
    const bool new_run = i == 0 || ((uint64_t)w[i - 1] >> (pos_bits + 2)) != c;
    const uint64_t gid = (w0 >> (pos_bits + 1)) & 1;
    const uint64_t g1 = has1 ? (w1 >> (pos_bits + 1)) & 1 : 0;
    const bool surv = c == c1 && new_run && c1 != c2 && gid == 0 && g1 == 1 &&
                      c != (uint64_t)sent_content;
    int64_t word = -1;
    if (surv) {
      const int64_t pos_a = (int64_t)((w0 >> 1) & pmask);
      const int64_t pos_b = (int64_t)((w1 >> 1) & pmask);
      const bool fwd = (w0 & 1) == (w1 & 1);
      const int64_t delta =
          fwd ? pos_b - pos_a + ((int64_t)1 << pos_bits) : pos_b + pos_a;
      word = ((int64_t)fwd << (2 * pos_bits + 2)) | (delta << pos_bits) | pos_a;
      ++mine;
    }
    cw[i] = word;
  }
  // every thread of the block reaches this point
  for (int o = 16; o > 0; o >>= 1) {
    mine += __shfl_down_sync(0xffffffffu, mine, o);
  }
  if ((threadIdx.x & 31) == 0 && mine) {
    atomicAdd(n_cands, (unsigned long long)mine);
  }
}

// K19 pass 3: per slot j < EC the representative's extension row
// (matchfind.py:568-594).  Rows past n_valid are absent.
__global__ void pair_reps_kernel(const int64_t* __restrict__ cw,
                                 const int64_t* __restrict__ src,
                                 int64_t n_valid, int64_t ec,
                                 const int64_t* __restrict__ n_cands,
                                 int pos_bits, int seed_len,
                                 int* __restrict__ lefts,
                                 unsigned char* __restrict__ present,
                                 unsigned char* __restrict__ is_fwd,
                                 int* __restrict__ lengths0) {
  const int64_t pmask = ((int64_t)1 << pos_bits) - 1;
  const int64_t bias = (int64_t)1 << pos_bits;
  for (int64_t j = first_index(); j < ec; j += grid_stride()) {
    if (j >= n_valid) {
      lefts[2 * j] = lefts[2 * j + 1] = 0;
      present[2 * j] = present[2 * j + 1] = 0;
      is_fwd[2 * j] = is_fwd[2 * j + 1] = 1;
      lengths0[j] = seed_len;
      continue;
    }
    const int64_t w = cw[src[j]];
    const int64_t end_row = (j + 1 < n_valid ? src[j + 1] : *n_cands) - 1;
    const uint64_t uw = (uint64_t)w;
    const int64_t pos_a = w & pmask;
    const int64_t delta =
        (int64_t)((uw >> pos_bits) & (((uint64_t)1 << (pos_bits + 2)) - 1));
    const bool fwd = ((uw >> (2 * pos_bits + 2)) & 1) != 0;
    int64_t last = cw[end_row] & pmask;
    if (last < pos_a) last = pos_a;
    // genome-1 left end of the match that covers the cluster
    int64_t left_b = fwd ? delta - bias + pos_a : delta - last;
    if (left_b < 0) left_b = 0;
    lefts[2 * j] = (int)pos_a;
    lefts[2 * j + 1] = (int)left_b;
    present[2 * j] = present[2 * j + 1] = 1;
    is_fwd[2 * j] = 1;
    is_fwd[2 * j + 1] = fwd ? 1 : 0;
    lengths0[j] = (int)(last - pos_a + seed_len);
  }
}

}  // namespace

// K18, before the sort: keys_a int64[na], keys_b int64[nb] in position
// order; out int64[na + nb].
extern "C" int lm_pair_pack(const void* keys_a, int64_t na, const void* keys_b,
                            int64_t nb, int pos_bits, void* out,
                            void* stream) {
  if (na + nb > 0) {
    LM_LAUNCH(pair_pack_kernel, blocks_for(na + nb), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)keys_a, na,
              (const int64_t*)keys_b, nb, pos_bits, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

// K18, after the sort: w int64[n] in unsigned order; cw int64[n]; n_cands
// int64[1], zeroed by the caller.
extern "C" int lm_pair_cluster_words(const void* w, int64_t n, int pos_bits,
                                     int64_t sent_content, void* cw,
                                     void* n_cands, void* stream) {
  if (n > 0) {
    LM_LAUNCH(pair_cluster_words_kernel, blocks_for(n), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)w, n, pos_bits,
              sent_content, (int64_t*)cw, (unsigned long long*)n_cands);
  }
  return (int)cudaGetLastError();
}

// K19, before the cumsum of rep: cw int64[m] sorted (unsigned order); rep
// int32[m]; n_cands int64[1], zeroed by the caller.
extern "C" int lm_pair_rep_flags(const void* cw, int64_t m, int pos_bits,
                                 int seed_len, void* rep, void* n_cands,
                                 void* stream) {
  if (m > 0) {
    LM_LAUNCH(rep_flags_kernel, blocks_for(m), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)cw, m, pos_bits,
              seed_len, (int*)rep, (int64_t*)n_cands);
  }
  return (int)cudaGetLastError();
}

// K19, after the cumsum: rank int32[m]; src int64[EC] scratch; outputs
// lefts int32[EC, 2], present and is_fwd uint8[EC, 2], lengths0 int32[EC].
// n_valid = min(n_reps, EC).
extern "C" int lm_pair_reps(const void* cw, const void* rep, const void* rank,
                            int64_t m, int64_t ec, int64_t n_valid,
                            const void* n_cands, int pos_bits, int seed_len,
                            void* src, void* lefts, void* present,
                            void* is_fwd, void* lengths0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m > 0) {
    LM_LAUNCH(rep_scatter_kernel, blocks_for(m), kThreads, 0, s,
              (const int*)rep, (const int*)rank, m, ec, (int64_t*)src);
  }
  if (ec > 0) {
    LM_LAUNCH(pair_reps_kernel, blocks_for(ec), kThreads, 0, s,
              (const int64_t*)cw, (const int64_t*)src, n_valid, ec,
              (const int64_t*)n_cands, pos_bits, seed_len, (int*)lefts,
              (unsigned char*)present, (unsigned char*)is_fwd,
              (int*)lengths0);
  }
  return (int)cudaGetLastError();
}
