// K5-K7: the pairwise seeder of progressive alignment
// (PairwiseMatchFinder semantics, libMems/PairwiseMatchFinder.cpp:37-71).
//
// K5, run flags, replaces libmems_tpu/matchfind.py _unique_occ_flags
// (:99-110) with the ops/segments.py run helpers it calls and
// _padded_table_meta (:1264).  Input: the (content, gid, pos)-sorted seed
// table as sorted content plus each row's source index into the
// position-order concatenation of the genomes' keys (a stable sort on
// content of that concatenation is exactly the (content, gid, pos) order).
// A row's gid and pos come from its source index and the G+1 segment
// bounds.  Run lengths are run-start flags -> cumsum (torch) -> a scatter
// of run starts -> a difference, so no row ever walks its run: the
// sentinel run of ambiguous windows can be a million rows long.
//
// K6, cluster words, replaces the kept-row payload decode and the G-1
// shifted compares of _pairwise_core (:1127-1160): kept rows are compacted
// in table order by a scatter to their cumsum rank, then one thread per
// (kept row, shift) writes fwd | pair_id | delta | posA, or -1 where the
// shifted row is not in the same run.  Only kept_count words per shift
// are written (the JAX table also carried the non-kept rows, all -1,
// which sort last and are never read).
//
// K7, representatives, replaces _pairwise_core :1163-1214: rep flags on
// the sorted cluster words, the compaction of reps to their cumsum rank
// (equal to the JAX searchsorted over the monotone ranks), and per rep
// the decode into the compact [EC, 2] extension rows that K2 takes.
//
// Bound: memory traffic.  Every kernel is one pass over int64 words (the
// 9 x 1 Mbp table holds 9.1 M rows, its cluster words ~8 x the kept
// rows) with coalesced reads, so each runs at a few percent of a sort of
// the same table; the sorts and cumsums around them stay library calls.
//
// 64-bit words are int64 holding unsigned patterns: right shifts go
// through uint64, and the -1 sentinel is all ones.
#include "common.cuh"
#include "reps.cuh"

namespace {

constexpr int kThreads = lm::kTableThreads;
using lm::blocks_for;
using lm::first_index;
using lm::grid_stride;
using lm::rep_flags_kernel;
using lm::rep_scatter_kernel;

// genome of a position-order row: the largest g with seg_off[g] <= src
__device__ __forceinline__ int gid_of(int64_t src, const int64_t* seg_off,
                                      int G) {
  int lo = 0, hi = G;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg_off[mid] <= src) lo = mid; else hi = mid;
  }
  return lo;
}

// K5 pass 1: per sorted row its genome, position, strand and run-start
// flag (content differs from the previous row).
__global__ void run_start_kernel(const int64_t* __restrict__ content,
                                 const int64_t* __restrict__ src,
                                 const int64_t* __restrict__ keys,
                                 int by_row,
                                 const int64_t* __restrict__ seg_off, int G,
                                 int64_t n, int* __restrict__ sc,
                                 int* __restrict__ gid, int* __restrict__ pos,
                                 unsigned char* __restrict__ strand) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const int64_t s = src[i];
    const int g = gid_of(s, seg_off, G);
    gid[i] = g;
    pos[i] = (int)(s - seg_off[g]);
    strand[i] = (unsigned char)(keys[by_row ? i : s] & 1);
    sc[i] = (i == 0 || content[i] != content[i - 1]) ? 1 : 0;
  }
}

// K5 pass 2: run r starts at run_start[r]; run_start[n_runs] = n.
// rid1 is the inclusive cumsum of the run-start flags.
__global__ void run_bounds_kernel(const int* __restrict__ sc,
                                  const int* __restrict__ rid1, int64_t n,
                                  int64_t* __restrict__ run_start) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    if (sc[i]) run_start[rid1[i] - 1] = i;
    if (i == n - 1) run_start[rid1[i]] = n;
  }
}

// K5 pass 3: unique_occ = (subrun_len == 1) & (runlen <= repeat_limit) &
// not_sent, run_id = rid1 - 1.  A (content, gid) subrun has length one
// iff the row starts a subrun and the next row starts one too.
__global__ void run_flags_kernel(const int64_t* __restrict__ content,
                                 const int* __restrict__ gid,
                                 const int* __restrict__ rid1,
                                 const int64_t* __restrict__ run_start,
                                 int64_t n, int repeat_limit,
                                 int64_t sent_content,
                                 unsigned char* __restrict__ unique_occ,
                                 int* __restrict__ run_id) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const int64_t c = content[i];
    const int g = gid[i];
    const int r = rid1[i] - 1;
    const int64_t runlen = run_start[r + 1] - run_start[r];
    const bool sub_start = i == 0 || content[i - 1] != c || gid[i - 1] != g;
    const bool sub_end = i == n - 1 || content[i + 1] != c || gid[i + 1] != g;
    unique_occ[i] = (sub_start && sub_end && runlen <= repeat_limit &&
                     c != sent_content) ? 1 : 0;
    run_id[i] = r;
  }
}

// K6 pass 1: kept rows to the front, in table order.
__global__ void compact_kept_kernel(const unsigned char* __restrict__ keep,
                                    const int* __restrict__ rank, int64_t n,
                                    const int* __restrict__ run_id,
                                    const int* __restrict__ gid,
                                    const int* __restrict__ pos,
                                    const unsigned char* __restrict__ strand,
                                    int* __restrict__ k_rid,
                                    int* __restrict__ k_gid,
                                    int* __restrict__ k_pos,
                                    unsigned char* __restrict__ k_str) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    if (!keep[i]) continue;
    const int k = rank[i] - 1;
    k_rid[k] = run_id[i];
    k_gid[k] = gid[i];
    k_pos[k] = pos[i];
    k_str[k] = strand[i];
  }
}

// K6 pass 2: word (s-1)*kept + k pairs kept row k with kept row k+s.
// Within a surviving run the kept rows are contiguous and gid-sorted
// (at most one per genome), so every genome pair of a run appears at
// exactly one shift.
__global__ void cluster_words_kernel(const int* __restrict__ k_rid,
                                     const int* __restrict__ k_gid,
                                     const int* __restrict__ k_pos,
                                     const unsigned char* __restrict__ k_str,
                                     int64_t kept, int G, int pos_bits,
                                     int pair_bits, int64_t* __restrict__ out) {
  const int64_t total = kept * (int64_t)(G - 1);
  const int64_t bias = (int64_t)1 << pos_bits;
  for (int64_t idx = first_index(); idx < total; idx += grid_stride()) {
    const int64_t s = idx / kept + 1;
    const int64_t k = idx - (s - 1) * kept;
    int64_t word = -1;
    if (k + s < kept && k_rid[k] == k_rid[k + s]) {
      const int64_t pa = k_pos[k];
      const int64_t pb = k_pos[k + s];
      const bool fwd = k_str[k] == k_str[k + s];
      const int64_t pair = (int64_t)k_gid[k] * G + k_gid[k + s];
      const int64_t delta = fwd ? pb - pa + bias : pb + pa;
      word = ((int64_t)fwd << (pair_bits + 2 * pos_bits + 2)) |
             (pair << (2 * pos_bits + 2)) | (delta << pos_bits) | pa;
    }
    out[idx] = word;
  }
}

// K7 passes 1 and 2 (rep_flags_kernel, rep_scatter_kernel) are shared with
// the pair pipeline: reps.cuh.

// K7 pass 3: per slot j < EC the rep's extension row in the compact pair
// layout (matchfind.py:1180-1215).  Rows past n_reps are absent.
__global__ void reps_kernel(const int64_t* __restrict__ cw,
                            const int64_t* __restrict__ src, int64_t n_valid,
                            int64_t ec, const int64_t* __restrict__ n_cands,
                            int G, int pos_bits, int pair_bits, int seed_len,
                            const int* __restrict__ gen_off,
                            const int* __restrict__ gen_cnt,
                            int* __restrict__ lefts,
                            unsigned char* __restrict__ present,
                            unsigned char* __restrict__ is_fwd,
                            int* __restrict__ off2, int* __restrict__ cnt2,
                            int* __restrict__ lengths0,
                            int* __restrict__ r_a, int* __restrict__ r_b) {
  const int64_t pmask = ((int64_t)1 << pos_bits) - 1;
  const int64_t bias = (int64_t)1 << pos_bits;
  for (int64_t j = first_index(); j < ec; j += grid_stride()) {
    if (j >= n_valid) {
      lefts[2 * j] = lefts[2 * j + 1] = 0;
      present[2 * j] = present[2 * j + 1] = 0;
      is_fwd[2 * j] = is_fwd[2 * j + 1] = 1;
      off2[2 * j] = off2[2 * j + 1] = gen_off[0];
      cnt2[2 * j] = cnt2[2 * j + 1] = gen_cnt[0];
      lengths0[j] = seed_len;
      r_a[j] = r_b[j] = 0;
      continue;
    }
    const int64_t w = cw[src[j]];
    const int64_t end_row = (j + 1 < n_valid ? src[j + 1] : *n_cands) - 1;
    const uint64_t uw = (uint64_t)w;
    const int64_t pos_a = w & pmask;
    const int64_t delta =
        (int64_t)((uw >> pos_bits) & (((uint64_t)1 << (pos_bits + 2)) - 1));
    const int pair =
        (int)((uw >> (2 * pos_bits + 2)) & (((uint64_t)1 << pair_bits) - 1));
    const bool fwd = ((uw >> (pair_bits + 2 * pos_bits + 2)) & 1) != 0;
    int a = pair / G, b = pair % G;
    a = a < G - 1 ? a : G - 1;
    b = b < G - 1 ? b : G - 1;
    int64_t last = cw[end_row] & pmask;
    if (last < pos_a) last = pos_a;
    const int64_t span = last - pos_a;
    const int64_t pos_b_rep = fwd ? delta - bias + pos_a : delta - pos_a;
    int64_t left_b = fwd ? pos_b_rep : delta - last;
    if (left_b < 0) left_b = 0;
    lefts[2 * j] = (int)pos_a;
    lefts[2 * j + 1] = (int)left_b;
    present[2 * j] = present[2 * j + 1] = 1;
    is_fwd[2 * j] = 1;
    is_fwd[2 * j + 1] = fwd ? 1 : 0;
    off2[2 * j] = gen_off[a];
    off2[2 * j + 1] = gen_off[b];
    cnt2[2 * j] = gen_cnt[a];
    cnt2[2 * j + 1] = gen_cnt[b];
    lengths0[j] = (int)(span + seed_len);
    r_a[j] = a;
    r_b[j] = b;
  }
}

}  // namespace

// K5, before the cumsum of sc.  content/src/keys/seg_off: int64; sc, gid,
// pos: int32[n]; strand: uint8[n].  The strand is keys[src[i]] & 1, or
// keys[i] & 1 with by_row (keys then the sorted rows' own keys, int64[n]).
extern "C" int lm_run_starts(const void* content, const void* src,
                             const void* keys, int by_row,
                             const void* seg_off, int G, int64_t n, void* sc,
                             void* gid, void* pos, void* strand,
                             void* stream) {
  if (n > 0) {
    LM_LAUNCH(run_start_kernel, blocks_for(n), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)content,
              (const int64_t*)src, (const int64_t*)keys, by_row,
              (const int64_t*)seg_off, G, n, (int*)sc, (int*)gid, (int*)pos,
              (unsigned char*)strand);
  }
  return (int)cudaGetLastError();
}

// K5, after the cumsum: rid1 int32[n] inclusive cumsum of sc; run_start
// int64[n+1] scratch; unique_occ uint8[n]; run_id int32[n].
extern "C" int lm_run_flags(const void* content, const void* sc,
                            const void* gid, const void* rid1,
                            void* run_start, int64_t n, int repeat_limit,
                            int64_t sent_content, void* unique_occ,
                            void* run_id, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    LM_LAUNCH(run_bounds_kernel, blocks_for(n), kThreads, 0, s,
              (const int*)sc, (const int*)rid1, n, (int64_t*)run_start);
    LM_LAUNCH(run_flags_kernel, blocks_for(n), kThreads, 0, s,
              (const int64_t*)content, (const int*)gid, (const int*)rid1,
              (const int64_t*)run_start, n, repeat_limit, sent_content,
              (unsigned char*)unique_occ, (int*)run_id);
  }
  return (int)cudaGetLastError();
}

// K6: keep uint8[n], rank int32[n] (inclusive cumsum of keep); k_* are
// scratch of kept rows; out int64[(G-1) * kept].
extern "C" int lm_cluster_words(const void* keep, const void* rank, int64_t n,
                                const void* run_id, const void* gid,
                                const void* pos, const void* strand,
                                void* k_rid, void* k_gid, void* k_pos,
                                void* k_str, int64_t kept, int G,
                                int pos_bits, int pair_bits, void* out,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    LM_LAUNCH(compact_kept_kernel, blocks_for(n), kThreads, 0, s,
              (const unsigned char*)keep, (const int*)rank, n,
              (const int*)run_id, (const int*)gid, (const int*)pos,
              (const unsigned char*)strand, (int*)k_rid, (int*)k_gid,
              (int*)k_pos, (unsigned char*)k_str);
  }
  const int64_t total = kept * (int64_t)(G - 1);
  if (total > 0) {
    LM_LAUNCH(cluster_words_kernel, blocks_for(total), kThreads, 0, s,
              (const int*)k_rid, (const int*)k_gid, (const int*)k_pos,
              (const unsigned char*)k_str, kept, G, pos_bits, pair_bits,
              (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

// K7, before the cumsum of rep: cw int64[m] sorted (unsigned order);
// rep int32[m]; n_cands int64[1], zeroed by the caller.
extern "C" int lm_rep_flags(const void* cw, int64_t m, int pos_bits,
                            int seed_len, void* rep, void* n_cands,
                            void* stream) {
  if (m > 0) {
    LM_LAUNCH(rep_flags_kernel, blocks_for(m), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)cw, m, pos_bits,
              seed_len, (int*)rep, (int64_t*)n_cands);
  }
  return (int)cudaGetLastError();
}

// K7, after the cumsum: rank int32[m]; src int64[EC] scratch; outputs of
// [EC, 2] (int32 lefts/off2/cnt2, uint8 present/is_fwd) and [EC] int32
// lengths0, r_a, r_b.  n_valid = min(n_reps, EC).
extern "C" int lm_reps(const void* cw, const void* rep, const void* rank,
                       int64_t m, int64_t ec, int64_t n_valid,
                       const void* n_cands, int G, int pos_bits,
                       int pair_bits, int seed_len, const void* gen_off,
                       const void* gen_cnt, void* src, void* lefts,
                       void* present, void* is_fwd, void* off2, void* cnt2,
                       void* lengths0, void* r_a, void* r_b, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m > 0) {
    LM_LAUNCH(rep_scatter_kernel, blocks_for(m), kThreads, 0, s,
              (const int*)rep, (const int*)rank, m, ec, (int64_t*)src);
  }
  if (ec > 0) {
    LM_LAUNCH(reps_kernel, blocks_for(ec), kThreads, 0, s,
              (const int64_t*)cw, (const int64_t*)src, n_valid, ec,
              (const int64_t*)n_cands, G, pos_bits, pair_bits, seed_len,
              (const int*)gen_off, (const int*)gen_cnt, (int*)lefts,
              (unsigned char*)present, (unsigned char*)is_fwd, (int*)off2,
              (int*)cnt2, (int*)lengths0, (int*)r_a, (int*)r_b);
  }
  return (int)cudaGetLastError();
}
