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
// bounds.  K5 is two launches over tiles of lm::kRunTile rows (runs.cuh),
// with no cumsum and no O(n) scratch:
//  1. run_summaries_kernel, one warp a tile: the tile's first and last run
//     start (and, for K13, whose launch 1 it is too, whether a big row
//     lies before the first or at or after the last); it also zeroes the
//     look-back scratch of launch 2;
//  2. run_tile_flags_kernel, one block a tile (taken from a ticket,
//     scan.cuh): each row's genome, position and strand; run and subrun
//     starts as ballot words; each row's run bounds from bit scans in the
//     tile and from the summaries across its edges, so no row walks its
//     run; unique_occ = (subrun_len == 1) & (runlen <= repeat_limit) &
//     not_sent, the subrun's length one where the row and the next both
//     start a subrun (one row past the tile's end read); run_id = the run
//     starts of the earlier tiles (the decoupled look-back) + the row's
//     run start's rank in the tile - 1.
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
//  * rep_index_kernel (repscan.cuh, shared with K19), one pass over the
//    sorted cluster words (scan.cuh): each word's rep flag from its
//    predecessor's head and posA, the reps' word indices stored in order
//    at their rank (the JAX searchsorted over the monotone ranks gives the
//    same), and n_cands and n_reps left in device memory.  The words sort
//    -1 last, so a block whose tile starts at -1 reads nothing more:
//    about 60% of the words are -1;
//  * the wrapper reads n_reps, chooses the capacity EC and allocates;
//  * reps_kernel, per slot j < EC the rep's decode into the compact
//    [EC, 2] extension rows that K2 takes.  EC comes from n_reps, so the
//    words are scanned once a call.
//
// Bound: memory traffic.  Every pass reads or writes each of its bytes
// once, coalesced, with no library cumsum between passes (K5's random
// gather of keys[src] for the strand aside); the sorts around them stay
// library calls.
//
// 64-bit words are int64 holding unsigned patterns: right shifts go
// through uint64, and the -1 sentinel is all ones.
#include "common.cuh"
#include "repscan.cuh"
#include "runs.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = lm::kTableThreads;
using lm::blocks_for;
using lm::first_index;
using lm::grid_stride;
using lm::kScanItems;
using lm::kScanThreads;
using lm::kWarpSpan;

constexpr int kWarps = kThreads / 32;
using lm::kRunRowsPerLane;
using lm::kRunTile;
using lm::kRunWarpRows;

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// K5's and K13's launch 1: words[t] = tile t's first run start * 2 + (a
// big row lies before it), words[tiles + t] = its last * 2 + (one lies at
// or after it); -2 + (one lies in the tile) where it holds no start (no
// row is big unless rows.big).  The look-back scratch `scan` of launch 2
// zeroed.  One warp a tile.
__global__ void __launch_bounds__(kThreads)
    run_summaries_kernel(lm::TableRows rows, int64_t n, int64_t tiles,
                         long long* __restrict__ words,
                         unsigned long long* __restrict__ scan) {
  if (blockIdx.x == 0 && threadIdx.x < lm::kScanHeader) scan[threadIdx.x] = 0;
  const int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tiles) return;
  const int64_t a = t * kRunTile;
  const lm::TileEdges e = lm::tile_edges(rows, a, min64(a + kRunTile, n));
  if ((threadIdx.x & 31) == 0) {
    scan[lm::kScanHeader + t] = 0;
    words[t] = e.first * 2 + (e.flag_first ? 1 : 0);
    words[tiles + t] = e.last * 2 + (e.flag_last ? 1 : 0);
  }
}

// K5's launch 2 on the tile of the block's ticket.
__global__ void __launch_bounds__(kThreads, lm::kRunMinBlocks)
    run_tile_flags_kernel(lm::SeedTable t, int64_t repeat_limit,
                          int64_t sent_content,
                          unsigned char* __restrict__ unique_occ,
                          int* __restrict__ run_id) {
  __shared__ lm::RowWords rw;
  __shared__ int warp_first[kWarps], warp_last[kWarps];
  __shared__ int64_t carry[2];
  __shared__ bool scg_b;
  const int64_t tile = lm::take_tile(t.scan);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ws0 = warp * kRunRowsPerLane;
  const int64_t a = tile * kRunTile;
  const int64_t b = min64(a + kRunTile, t.n);
  const int64_t w0 = a + warp * kRunWarpRows;

  unsigned starts;
  const unsigned sent = lm::load_tile_rows<false>(t, 0, w0, a, b, sent_content,
                                                  rw, nullptr, starts);
  lm::step_carries(rw.sc, rw.before, rw.after, w0, a);
  if (lane == 0) {
    warp_first[warp] = lm::warp_first_bit(rw.sc, rw.after, ws0, w0, a);
    warp_last[warp] = lm::warp_last_bit(rw.sc, rw.before, ws0, w0, a);
  }
  // the run across the tile's left edge starts in the nearest earlier
  // tile with a start; the run across its right edge ends at the nearest
  // later tile's first start, or n
  if (warp == 0) {
    const int64_t left =
        rw.sc[0] & 1u ? -1
                      : lm::walk_summaries(t.words + t.tiles, tile, t.tiles, -1)
                            .at;
    if (lane == 0) carry[0] = left;
  } else if (warp == 1) {
    const int64_t right = lm::walk_summaries(t.words, tile, t.tiles, 1).at;
    if (lane == 0) {
      carry[1] = right >= 0 ? right : t.n;
      scg_b = lm::subrun_starts_at(t, b);
    }
  }
  // the run starts of the earlier tiles (its barriers publish the above)
  unsigned warp_off, total;
  const unsigned long long excl =
      lm::block_offsets(t.scan, tile, starts, &warp_off, &total);
  // tile-relative from here on
  int64_t start_in = carry[0] - a;
  int64_t end_in = carry[1] - a;
  for (int w = 0; w < warp; ++w) {
    if (warp_last[w] >= 0) start_in = warp_last[w];
  }
  for (int w = kWarps - 1; w > warp; --w) {
    if (warp_first[w] >= 0) end_in = warp_first[w];
  }
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
  int64_t at = (int64_t)excl + warp_off;
  for (int s = 0; s < kRunRowsPerLane; ++s) {
    const int ws = ws0 + s;
    const int r = ws * 32 + lane;
    const unsigned m = rw.sc[ws];
    if (a + r < b) {
      run_id[a + r] = (int)(at + __popc(m & upto) - 1);
      const int64_t start =
          lm::bit_at_or_before(m, upto, ws * 32, rw.before[ws], start_in);
      const int64_t end = lm::bit_after(m, upto, ws * 32, rw.after[ws], end_in);
      // the subrun has one row: it starts here and the next row starts one
      const bool next = a + r + 1 == b
                            ? scg_b
                            : (rw.scg[(r + 1) >> 5] >> ((r + 1) & 31)) & 1u;
      const bool single = ((rw.scg[ws] >> lane) & 1u) && next;
      unique_occ[a + r] = single && end - start <= repeat_limit &&
                                  !((sent >> s) & 1u)
                              ? 1
                              : 0;
    }
    at += __popc(m);
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

// Words of K5's and K13's scratch over n rows: the look-back of launch 2
// (scan.cuh: its header, a status word a tile), then the tiles' summary
// words (two a tile).
extern "C" int64_t lm_run_scratch_words(int64_t n) {
  return lm::kScanHeader + 3 * lm::run_tiles(n);
}

// K5's and K13's launch 1.  content, src: int64[n] the sorted table;
// seg_off: int64[G+1]; big: flag K13's big rows (span = repeat_tolerance +
// 1); scratch: int64[lm_run_scratch_words(n)].
extern "C" int lm_run_summaries(const void* content, const void* src,
                                const void* seg_off, int G, int64_t n,
                                int big, int span, void* scratch,
                                void* stream) {
  if (n > 0) {
    const int64_t tiles = lm::run_tiles(n);
    unsigned long long* scan = (unsigned long long*)scratch;
    const lm::TableRows rows{(const int64_t*)content, (const int64_t*)src,
                             (const int64_t*)seg_off, G, span, big != 0};
    LM_LAUNCH(run_summaries_kernel, (unsigned)((tiles + kWarps - 1) / kWarps),
              kThreads, 0, (cudaStream_t)stream, rows, n, tiles,
              (long long*)(scan + lm::kScanHeader + tiles), scan);
  }
  return (int)cudaGetLastError();
}

// K5's launch 2, after lm_run_summaries on the same scratch.  keys:
// int64 the position-order keys; unique_occ, strand uint8[n]; run_id,
// gid, pos int32[n].
extern "C" int lm_run_tile_flags(const void* content, const void* src,
                                 const void* keys, const void* seg_off, int G,
                                 int64_t n, int64_t repeat_limit,
                                 int64_t sent_content, void* scratch,
                                 void* unique_occ, void* run_id, void* gid,
                                 void* pos, void* strand, void* stream) {
  if (n > 0) {
    const lm::SeedTable t = lm::seed_table(content, src, keys, 0, seg_off, G,
                                           n, scratch, gid, pos, strand);
    LM_LAUNCH(run_tile_flags_kernel, (unsigned)t.tiles, kThreads, 0,
              (cudaStream_t)stream, t, repeat_limit, sent_content,
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
  return lm::launch_rep_index(cw, m, pos_bits, seed_len, index, scratch,
                              (cudaStream_t)stream);
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
