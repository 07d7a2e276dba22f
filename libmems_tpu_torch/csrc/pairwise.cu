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
// shifted compares of _pairwise_core (:1127-1160), in two kernels around
// one host read:
//  * compact_kept_kernel, one pass over the n table rows (scan.cuh): each
//    kept row's (run id, genome, position, strand) as one packed 8-byte
//    record, stored in table order at its rank among the kept rows; the
//    last tile leaves the kept count in device memory;
//  * the wrapper reads that count to allocate the words;
//  * cluster_words_kernel, one thread a kept row k: the block stages its
//    blockDim + G - 1 records in shared memory, then for s = 1..G-1 writes
//    word (s-1)*kept + k, fwd | pair_id | delta | posA, or -1 where row
//    k+s is not in the same run.  For each s a warp's stores are 32
//    consecutive words.  Only kept words per shift are written (the JAX
//    table also carried the non-kept rows, all -1, which sort last and
//    are never read).
// A record is run_id << 32 | strand << (pos_bits + gid_bits) |
// gid << pos_bits | pos: the cluster word's budget (1 + 2 gid_bits +
// 2 pos_bits + 2 <= 64) leaves pos_bits + gid_bits + 1 <= 31, and the run
// id is below 2^31 under the expansion-table budget.
//
// K7, representatives, replaces _pairwise_core :1163-1214, in two kernels
// around one host read:
//  * rep_index_kernel, one pass over the sorted cluster words (scan.cuh):
//    each word's rep flag from its predecessor's head and posA, the reps'
//    word indices stored in order at their rank (the JAX searchsorted over
//    the monotone ranks gives the same), and n_cands and n_reps left in
//    device memory.  The words sort -1 last, so a block whose tile starts
//    at -1 reads nothing more: about 60% of the words are -1;
//  * the wrapper reads n_reps, chooses the capacity EC and allocates;
//  * reps_kernel, per slot j < EC the rep's decode into the compact
//    [EC, 2] extension rows that K2 takes.  EC comes from n_reps, so the
//    words are scanned once a call.
//
// Bound: memory traffic.  Every pass reads or writes each of its bytes
// once, coalesced, with no library cumsum between passes; the sorts
// around them stay library calls.
//
// 64-bit words are int64 holding unsigned patterns: right shifts go
// through uint64, and the -1 sentinel is all ones.
#include "common.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = lm::kTableThreads;
using lm::blocks_for;
using lm::first_index;
using lm::grid_stride;
using lm::kScanItems;
using lm::kScanThreads;
using lm::kWarpSpan;

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

// K6 pass 1: the kept rows' records to the front, in table order.
// scratch word 1: the kept count.
__global__ void __launch_bounds__(kScanThreads)
    compact_kept_kernel(const unsigned char* __restrict__ keep,
                        const int* __restrict__ run_id,
                        const int* __restrict__ gid,
                        const int* __restrict__ pos,
                        const unsigned char* __restrict__ strand, int64_t n,
                        int pos_bits, int gid_bits,
                        unsigned long long* __restrict__ rec,
                        unsigned long long* __restrict__ scratch) {
  const int64_t tile = lm::take_tile(scratch);
  const int64_t base = tile * lm::kScanTile + (threadIdx.x >> 5) * kWarpSpan +
                       (threadIdx.x & 31);
  unsigned long long r[kScanItems];
  unsigned ballot[kScanItems];
  unsigned count = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t i = base + j * 32;
    bool kept = false;
    r[j] = 0;
    if (i < n) {
      kept = keep[i] != 0;
      r[j] = ((unsigned long long)(unsigned)run_id[i] << 32) |
             ((unsigned long long)strand[i] << (pos_bits + gid_bits)) |
             ((unsigned long long)gid[i] << pos_bits) | (unsigned)pos[i];
    }
    ballot[j] = __ballot_sync(0xffffffffu, kept);
    count += __popc(ballot[j]);
  }
  unsigned warp_off, total;
  const unsigned long long off =
      lm::block_offsets(scratch, tile, count, &warp_off, &total);
  unsigned long long at = off + warp_off;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if ((ballot[j] >> (threadIdx.x & 31)) & 1) {
      rec[at + __popc(ballot[j] & lm::lanes_below())] = r[j];
    }
    at += __popc(ballot[j]);
  }
  if (tile == (int64_t)gridDim.x - 1 && threadIdx.x == 0) {
    scratch[1] = off + total;
  }
}

// K6 pass 2: word (s-1)*kept + k pairs kept row k with kept row k+s.
// Within a surviving run the kept rows are contiguous and gid-sorted
// (at most one per genome), so every genome pair of a run appears at
// exactly one shift.
constexpr int kWordThreads = 256;
constexpr int kMaxShift = 61;   // G <= 62

__global__ void __launch_bounds__(kWordThreads)
    cluster_words_kernel(const unsigned long long* __restrict__ rec,
                         int64_t kept, int G, int pos_bits, int gid_bits,
                         int pair_bits, int64_t* __restrict__ out) {
  __shared__ unsigned long long s_rec[kWordThreads + kMaxShift];
  const int64_t k0 = (int64_t)blockIdx.x * kWordThreads;
  for (int t = threadIdx.x; t < kWordThreads + G - 1; t += kWordThreads) {
    s_rec[t] = k0 + t < kept ? rec[k0 + t] : 0;
  }
  __syncthreads();
  const int64_t k = k0 + threadIdx.x;
  if (k >= kept) return;
  const unsigned long long pmask = (1ull << pos_bits) - 1;
  const unsigned long long gmask = (1ull << gid_bits) - 1;
  const int64_t bias = (int64_t)1 << pos_bits;
  const unsigned long long a = s_rec[threadIdx.x];
  const int64_t pa = (int64_t)(a & pmask);
  const int64_t ga = (int64_t)((a >> pos_bits) & gmask);
  const unsigned sa = (unsigned)(a >> (pos_bits + gid_bits)) & 1u;
  for (int s = 1; s < G; ++s) {
    int64_t word = -1;
    const unsigned long long b = s_rec[threadIdx.x + s];
    if (k + s < kept && (b >> 32) == (a >> 32)) {
      const int64_t pb = (int64_t)(b & pmask);
      const bool fwd = ((unsigned)(b >> (pos_bits + gid_bits)) & 1u) == sa;
      const int64_t pair = ga * G + (int64_t)((b >> pos_bits) & gmask);
      const int64_t delta = fwd ? pb - pa + bias : pb + pa;
      word = ((int64_t)fwd << (pair_bits + 2 * pos_bits + 2)) |
             (pair << (2 * pos_bits + 2)) | (delta << pos_bits) | pa;
    }
    out[(int64_t)(s - 1) * kept + k] = word;
  }
}

// K7 pass 1: a sorted word starts a representative when its (fwd, pair,
// delta) head differs from the previous word's or its posA is more than
// seed_len past the previous posA (matchfind.py:1163-1178); rep r's word
// index goes to index[r].  The last valid word leaves n_cands (scratch
// word 1) and n_reps (word 2).
__global__ void __launch_bounds__(kScanThreads)
    rep_index_kernel(const int64_t* __restrict__ cw, int64_t m, int pos_bits,
                     int seed_len, int* __restrict__ index,
                     unsigned long long* __restrict__ scratch) {
  // the words sort -1 last, so a block whose own tile starts at -1 has
  // nothing to do and takes no ticket: the tickets then number exactly
  // the tiles that hold a valid word
  if (cw[(int64_t)blockIdx.x * lm::kScanTile] == -1) return;
  const int64_t tile = lm::take_tile(scratch);
  const int64_t t0 = tile * lm::kScanTile;
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
      lm::block_offsets(scratch, tile, count, &warp_off, &total);
  unsigned long long at = off + warp_off;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const unsigned long long rank =
        at + __popc(ballot[j] & lm::lanes_below());
    if ((ballot[j] >> lane) & 1) index[rank] = (int)(wbase + j * 32 + lane);
    if ((last >> j) & 1) {
      scratch[1] = wbase + j * 32 + lane + 1;
      scratch[2] = rank + ((ballot[j] >> lane) & 1);
    }
    at += __popc(ballot[j]);
  }
}

// K7 pass 2: per slot j < EC the rep's extension row in the compact pair
// layout (matchfind.py:1180-1215).  Rows past n_valid = min(n_reps, EC)
// are absent; the last valid row's cluster ends at n_cands.
__global__ void reps_kernel(const int64_t* __restrict__ cw,
                            const int* __restrict__ index, int64_t n_valid,
                            int64_t ec,
                            const unsigned long long* __restrict__ counts,
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
    const int64_t w = cw[index[j]];
    const int64_t end_row =
        (j + 1 < n_valid ? (int64_t)index[j + 1] : (int64_t)counts[0]) - 1;
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

// Words of the compaction scratch over n items (scan.cuh): the ticket,
// the kernel's counts, a status word a tile.
extern "C" int64_t lm_scan_scratch_words(int64_t n) {
  return lm::scan_scratch_words(n);
}

// K6 pass 1: keep uint8[n]; run_id, gid, pos int32[n]; strand uint8[n];
// rec int64[n] (the first kept are written); scratch
// int64[lm_scan_scratch_words(n)], word 1 the kept count after the launch.
extern "C" int lm_compact_kept(const void* keep, const void* run_id,
                               const void* gid, const void* pos,
                               const void* strand, int64_t n, int pos_bits,
                               int gid_bits, void* rec, void* scratch,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, lm::scan_scratch_words(n) * sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    LM_LAUNCH(compact_kept_kernel, (unsigned)lm::scan_tiles(n), kScanThreads,
              0, s, (const unsigned char*)keep, (const int*)run_id,
              (const int*)gid, (const int*)pos, (const unsigned char*)strand,
              n, pos_bits, gid_bits, (unsigned long long*)rec,
              (unsigned long long*)scratch);
  }
  return (int)cudaGetLastError();
}

// K6 pass 2: rec int64[kept] from pass 1; out int64[(G-1) * kept].
extern "C" int lm_cluster_words(const void* rec, int64_t kept, int G,
                                int pos_bits, int gid_bits, int pair_bits,
                                void* out, void* stream) {
  if (G > kMaxShift + 1) return (int)cudaErrorInvalidValue;
  if (kept > 0 && G > 1) {
    LM_LAUNCH(cluster_words_kernel,
              (unsigned)((kept + kWordThreads - 1) / kWordThreads),
              kWordThreads, 0, (cudaStream_t)stream,
              (const unsigned long long*)rec, kept, G, pos_bits, gid_bits,
              pair_bits, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

// K7 pass 1: cw int64[m] sorted (unsigned order, -1 last); index
// int32[m] (the first n_reps are written); scratch
// int64[lm_scan_scratch_words(m)], words 1 and 2 n_cands and n_reps
// after the launch.
extern "C" int lm_rep_index(const void* cw, int64_t m, int pos_bits,
                            int seed_len, void* index, void* scratch,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, lm::scan_scratch_words(m) * sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    LM_LAUNCH(rep_index_kernel, (unsigned)lm::scan_tiles(m), kScanThreads, 0,
              s, (const int64_t*)cw, m, pos_bits, seed_len, (int*)index,
              (unsigned long long*)scratch);
  }
  return (int)cudaGetLastError();
}

// K7 pass 2: index int32 from pass 1; counts int64[2] (n_cands, n_reps;
// scratch words 1-2 of pass 1); outputs of [EC, 2] (int32 lefts/off2/cnt2,
// uint8 present/is_fwd) and [EC] int32 lengths0, r_a, r_b.
// n_valid = min(n_reps, EC).
extern "C" int lm_reps(const void* cw, const void* index, const void* counts,
                       int64_t n_valid, int64_t ec, int G, int pos_bits,
                       int pair_bits, int seed_len, const void* gen_off,
                       const void* gen_cnt, void* lefts, void* present,
                       void* is_fwd, void* off2, void* cnt2, void* lengths0,
                       void* r_a, void* r_b, void* stream) {
  if (ec > 0) {
    LM_LAUNCH(reps_kernel, blocks_for(ec), kThreads, 0, (cudaStream_t)stream,
              (const int64_t*)cw, (const int*)index, n_valid, ec,
              (const unsigned long long*)counts, G, pos_bits, pair_bits,
              seed_len, (const int*)gen_off, (const int*)gen_cnt, (int*)lefts,
              (unsigned char*)present, (unsigned char*)is_fwd, (int*)off2,
              (int*)cnt2, (int*)lengths0, (int*)r_a, (int*)r_b);
  }
  return (int)cudaGetLastError();
}
