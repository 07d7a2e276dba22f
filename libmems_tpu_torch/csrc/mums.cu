// K13-K15: the multi-MUM pipeline of find_mums for any G (MemHash::
// FindMatches semantics, libMems/MemHash.cpp:109-251).
//
// K13, seed-enumeration flags, replaces libmems_tpu/matchfind.py
// _mum_seed_flags (:67-95) with the ops/segments.py run helpers it calls.
// Input: the (content, gid, pos)-sorted seed table as K5 takes it (sorted
// content, each row's source index into the position-order keys, the
// genome bounds).  A run is kept when its first and last rows' genomes
// differ (rows are gid-sorted within a run, so it holds two genomes), no
// row of it is big (a (content, gid) subrun longer than repeat_tolerance +
// 1 holds a row whose row span = repeat_tolerance + 1 places back is in
// its subrun), it has at most repeat_limit rows and its content is not the
// masked-window sentinel.  Two launches over tiles of lm::kRunTile rows
// (runs.cuh), with no cumsum, no O(n) scratch and no row walking its run
// (the sentinel run and repeats past the limit can be a million rows):
//  1. K5's run_summaries_kernel with the big rows flagged: each tile's
//     first and last run start, whether a big row lies before the first
//     or at or after the last;
//  2. mum_tile_flags_kernel, one block a tile: each row's genome, position
//     and strand, the run, subrun and big rows as ballot words, each row's
//     run bounds as K5 finds them; the row that ends a run in the tile (or
//     the tile's last row) decides the run: the first row's genome and
//     strand from shared memory (or, for a run across the left edge, from
//     its start row), big rows from the nearest big row at or before it
//     and, across the edges, the summaries' flags the walks passed.  Its
//     verdict goes through shared memory to the run's rows: kept_occ
//     (subrun start and kept), ref_strand (the strand of the run's first
//     row), row_id = the kept runs of the earlier tiles (decoupled
//     look-back, scan.cuh) + the rank of the row's run start among the
//     tile's kept starts - 1; the last tile leaves n_rows in the scratch,
//     the call's one host read.
//
// K14, candidates, replaces _fused_mum_pipeline :355-380 and
// _packed_diagonal_words (:283-311) in one pass, with no zero fill and no
// scatter.  Its one caller takes K13's flags at repeat_tolerance 0, so a
// kept run holds each genome at most once: every row of it is kept, and
// a candidate's rows are one group of at most G consecutive table rows,
// in gid order, from its run's start.  One thread a table row; the row
// that starts a group (kept, and the first row, or its predecessor not
// kept or of another row_id) builds the candidate from the group: it
// applies seq_mask (bit G-1-g is genome g), writes the whole starts row,
// zeros included, and the row's packed signature words invalid(1) |
// mask(G) | signs(G) | G biased diagonals of pos_bits + 2 bits, 63
// payload bits a word (MSB-first, so the word tuple orders like the
// fields), columnar, so a warp's candidates store side by side, and
// posref (1 << 62 when invalid).  Every word is below 2^63: a signed
// int64 sort orders it.  The mask and sign fields are streamed a bit at a
// time (genome G-1 first, as the JAX package's G-bit integers place
// them), so a row takes any number of genomes: the words simply grow.
// Bound: bytes: every table row's kept flag and row id, the kept rows'
// genome, position and strand, the candidates' outputs.
//
// K15, representatives, replaces :381-423 and _recover_starts (:314-332)
// on the sorted signature rows, in two kernels around one host read:
//  * mum_rep_index_kernel, one pass over the rows in tiles taken by ticket
//    (scan.cuh): a row is a representative when it is valid (its invalid
//    bit clear and a bit of its G-bit mask field set, read from the words
//    alone) and it is the first row, a word differs from its
//    predecessor's or posref jumps by more than seed_len.  The pass walks
//    the word columns and posref one at a time, each lane holding one
//    change bit and one mask bit an item, so any n_words fits in
//    registers; each column's loads are coalesced, the predecessor comes
//    from the lane before (lane 0 reads the row before the warp's span).
//    The reps' row indices are stored at their rank in row order (the JAX
//    payload sort gives the same rows in the same order), and the last
//    tile leaves n_reps in the scratch;
//  * the wrapper reads n_reps; the call site picks the capacity EC from
//    it (the first guess where the reps fit, else the next power of two
//    above their count), so the rows are scanned once a call;
//  * mum_decode_reps_kernel, one thread a slot j < EC: row index[j]'s G
//    starts rebuilt from its fields as K2's [EC, G] extension row; slots
//    past min(n_reps, EC) write the absent row.
//
// Bound: memory traffic.  Each pass reads a few int32/int64 columns of
// the table once, coalesced, and writes one or two (K13's gather of the
// rows' strands aside); no library cumsum runs between them, and the
// sorts between the passes stay library calls and cost more than the
// passes.
#include "common.cuh"
#include "runs.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = lm::kTableThreads;
using lm::blocks_for;
using lm::first_index;
using lm::grid_stride;
constexpr int kWordBits = 63;

// Appends MSB-first fields to the 63-bit payload words of one row, as
// _pack_sort_words lays them out: words[w * stride] is word w.
struct WordWriter {
  int64_t* out;
  int64_t stride;
  int w = 0;
  int used = 0;  // payload bits already in `cur`
  uint64_t cur = 0;

  __device__ WordWriter(int64_t* o, int64_t s) : out(o), stride(s) {}

  // the low nb bits of val, nb <= 63
  __device__ void put(uint64_t val, int nb) {
    while (nb > 0) {
      const int take = nb < kWordBits - used ? nb : kWordBits - used;
      const uint64_t seg = (val >> (nb - take)) & (((uint64_t)1 << take) - 1);
      cur |= seg << (kWordBits - used - take);
      used += take;
      nb -= take;
      if (used == kWordBits) {
        out[(int64_t)w++ * stride] = (int64_t)cur;
        cur = 0;
        used = 0;
      }
    }
  }

  // writes the partial word and zero words up to n_words
  __device__ void finish(int n_words) {
    while (w < n_words) {
      out[(int64_t)w++ * stride] = (int64_t)cur;
      cur = 0;
    }
  }
};

// Field [start, start + nb) of row i of the word columns words[w * m + i]
// (_unpack_sort_words), nb <= 64.
__device__ uint64_t unpack_field(const int64_t* __restrict__ words, int64_t m,
                                 int64_t i, int start, int nb) {
  const int end = start + nb;
  uint64_t val = 0;
  for (int w = start / kWordBits; w * kWordBits < end; ++w) {
    const int ws = w * kWordBits, we = ws + kWordBits;
    const int lo = start > ws ? start : ws;
    const int hi = end < we ? end : we;
    if (lo >= hi) continue;
    uint64_t seg = (uint64_t)words[w * m + i] >> (we - hi);
    if (hi - lo < 64) seg &= ((uint64_t)1 << (hi - lo)) - 1;
    val |= seg << (end - hi);
  }
  return val;
}

// Signed start of genome g of sorted row i (_recover_starts): genome g's
// mask bit is field bit 1 + (G-1-g), its sign bit G places later.
__device__ __forceinline__ int recover_start(const int64_t* __restrict__ words,
                                             const int64_t* __restrict__ posref,
                                             int64_t m, int64_t i, int G,
                                             int pos_bits, int g) {
  const bool invalid = unpack_field(words, m, i, 0, 1) != 0;
  if (invalid || !unpack_field(words, m, i, G - g, 1)) return 0;
  const bool neg = unpack_field(words, m, i, 2 * G - g, 1) != 0;
  const int64_t db = (int64_t)unpack_field(words, m, i,
                                           1 + 2 * G + g * (pos_bits + 2),
                                           pos_bits + 2);
  const int64_t delta = db - ((int64_t)1 << (pos_bits + 1));
  const int64_t pos_ref = posref[i];
  const int64_t pos = neg ? delta - pos_ref : delta + pos_ref;
  return (int)(neg ? -(pos + 1) : pos + 1);
}

constexpr int kWarps = kThreads / 32;
using lm::kRunRowsPerLane;
using lm::kRunTile;
using lm::kRunWarpRows;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// K13's launch 2 on the tile of the block's ticket (span = repeat_tolerance
// + 1); t.scan word 1 holds n_rows after the launch.
__global__ void __launch_bounds__(kThreads, lm::kRunMinBlocks)
    mum_tile_flags_kernel(lm::SeedTable t, int span, int64_t repeat_limit,
                          int64_t sent_content,
                          unsigned char* __restrict__ kept_occ,
                          int* __restrict__ row_id,
                          unsigned char* __restrict__ ref_strand) {
  __shared__ lm::RowWords rw;
  __shared__ lm::BigWords bw;
  __shared__ int warp_first[kWarps], warp_last[kWarps], warp_big[kWarps];
  // the runs across the left and the right edge: start, end, genome of
  // the first and of the last row, big rows outside the tile, the first
  // row's strand; whether row b starts a subrun
  __shared__ int64_t start_in, end_out;
  __shared__ int gid_in, gid_out;
  __shared__ bool big_in, big_out, strand_in, scg_b;
  const int64_t tile = lm::take_tile(t.scan);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ws0 = warp * kRunRowsPerLane;
  const int64_t a = tile * kRunTile;
  const int64_t b = min64(a + kRunTile, t.n);
  const int64_t w0 = a + warp * kRunWarpRows;

  unsigned starts;
  const unsigned sent = lm::load_tile_rows<true>(t, span, w0, a, b,
                                                 sent_content, rw, &bw,
                                                 starts);
  lm::step_carries(rw.sc, rw.before, rw.after, w0, a);
  lm::step_carries(bw.big, bw.big_before, nullptr, w0, a);
  if (lane == 0) {
    warp_first[warp] = lm::warp_first_bit(rw.sc, rw.after, ws0, w0, a);
    warp_last[warp] = lm::warp_last_bit(rw.sc, rw.before, ws0, w0, a);
    warp_big[warp] = lm::warp_last_bit(bw.big, bw.big_before, ws0, w0, a);
  }
  if (warp == 0) {
    if (rw.sc[0] & 1u) {
      if (lane == 0) start_in = -1;
    } else {
      const lm::RunEdge left =
          lm::walk_summaries(t.words + t.tiles, tile, t.tiles, -1);
      if (lane == 0) {
        const int64_t s0 = t.src[left.at];
        start_in = left.at;
        big_in = left.flag;
        gid_in = lm::gid_of(s0, t.seg_off, t.G);
        strand_in = t.keys[t.by_row ? left.at : s0] & 1;
      }
    }
  } else if (warp == 1) {
    const lm::RunEdge right = lm::walk_summaries(t.words, tile, t.tiles, 1);
    if (lane == 0) {
      const int64_t e = right.at >= 0 ? right.at : t.n;
      end_out = e;
      big_out = right.flag;
      gid_out = lm::gid_of(t.src[e - 1], t.seg_off, t.G);
      scg_b = lm::subrun_starts_at(t, b);
    }
  }
  __syncthreads();
  // tile-relative from here on
  const int n_tile = (int)(b - a);
  int64_t first_in = start_in - a;
  int64_t end_in = end_out - a;
  int64_t big_before = -1;
  for (int w = 0; w < warp; ++w) {
    if (warp_last[w] >= 0) first_in = warp_last[w];
    if (warp_big[w] >= 0) big_before = warp_big[w];
  }
  for (int w = kWarps - 1; w > warp; --w) {
    if (warp_first[w] >= 0) end_in = warp_first[w];
  }

  // the verdict of each run, at the row that decides it: its last row in
  // the tile
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
  for (int s = 0; s < kRunRowsPerLane; ++s) {
    const int ws = ws0 + s;
    const int r = ws * 32 + lane;
    const unsigned m = rw.sc[ws];
    bool keep = false;
    if (r < n_tile) {
      const int64_t end = lm::bit_after(m, upto, ws * 32, rw.after[ws], end_in);
      if (end == r + 1 || r == n_tile - 1) {
        const int64_t first =
            lm::bit_at_or_before(m, upto, ws * 32, rw.before[ws], first_in);
        const int64_t near_big = lm::bit_at_or_before(
            bw.big[ws], upto, ws * 32, bw.big_before[ws], big_before);
        const int g_first = first >= 0 ? bw.gid[first] : gid_in;
        const int g_last = end == r + 1 ? bw.gid[r] : gid_out;
        const bool big = near_big >= (first > 0 ? first : 0) ||
                         (first < 0 && big_in) || (end > n_tile && big_out);
        keep = g_first != g_last && !big && end - first <= repeat_limit &&
               !((sent >> s) & 1u);
      }
    }
    const unsigned kw = __ballot_sync(lm::kRunFull, keep);
    if (lane == 0) bw.kept[ws] = kw;
  }
  __syncthreads();

  // each row's verdict from its run's deciding row; the kept runs' starts
  unsigned count = 0;
  for (int s = 0; s < kRunRowsPerLane; ++s) {
    const int ws = ws0 + s;
    const int r = ws * 32 + lane;
    const unsigned m = rw.sc[ws];
    bool kept = false;
    if (r < n_tile) {
      const int64_t end = lm::bit_after(m, upto, ws * 32, rw.after[ws], end_in);
      const int64_t first =
          lm::bit_at_or_before(m, upto, ws * 32, rw.before[ws], first_in);
      const int d = (int)min64(end, n_tile) - 1;
      kept = (bw.kept[d >> 5] >> (d & 31)) & 1u;
      ref_strand[a + r] =
          first >= 0 ? (bw.strand[first >> 5] >> (first & 31)) & 1u
                     : (unsigned)strand_in;
      kept_occ[a + r] = kept && ((rw.scg[ws] >> lane) & 1u) ? 1 : 0;
    }
    const unsigned km = __ballot_sync(lm::kRunFull, kept && ((m >> lane) & 1u));
    if (lane == 0) bw.kept_start[ws] = km;
    count += __popc(km);
  }
  unsigned warp_off, total;
  const unsigned long long excl =
      lm::block_offsets(t.scan, tile, count, &warp_off, &total);
  int64_t at = (int64_t)excl + warp_off;
  for (int s = 0; s < kRunRowsPerLane; ++s) {
    const int ws = ws0 + s;
    const int r = ws * 32 + lane;
    const unsigned km = bw.kept_start[ws];
    if (r < n_tile) row_id[a + r] = (int)(at + __popc(km & upto) - 1);
    at += __popc(km);
  }
  if (tile == t.tiles - 1 && threadIdx.x == 0) t.scan[1] = excl + total;
}

// Whether seq_mask wants genome g of G (bit G-1-g).
__device__ __forceinline__ bool wanted(uint64_t seq_mask, int G, int g) {
  const int b = G - 1 - g;
  return b < 64 && ((seq_mask >> b) & 1);
}

// The K14 candidate whose group starts at table row i: its rows i ..
// i + k - 1 (kept, one row_id, at most G, gid ascending) into starts,
// words and posref at its row_id.
__device__ __forceinline__ void build_candidate(
    int64_t i, const unsigned char* __restrict__ kept_occ,
    const int* __restrict__ row_id, const int* __restrict__ gid,
    const int* __restrict__ pos, const unsigned char* __restrict__ strand,
    const unsigned char* __restrict__ ref_strand, int64_t n, int G,
    uint64_t seq_mask, int n_want, int pos_bits, int n_words, int64_t n_rows,
    int* __restrict__ starts, int64_t* __restrict__ words,
    int64_t* __restrict__ posref) {
  const int rid = row_id[i];
  int k = 1;
  while (k < G && i + k < n && kept_occ[i + k] && row_id[i + k] == rid) ++k;
  bool valid = true;
  if (seq_mask) {
    valid = k == n_want;
    for (int t = 0; t < k && valid; ++t) valid = wanted(seq_mask, G, gid[i + t]);
  }
  const unsigned char rs = ref_strand[i];
  const int64_t pos_ref = pos[i];  // the first present genome's
  const int64_t bias = (int64_t)1 << (pos_bits + 1);
  // the whole starts row, zeros included, the group walked in gid order
  // (t)
  int* row = starts + (int64_t)rid * G;
  for (int g = 0, t = 0; g < G; ++g) {
    int v = 0;
    if (valid && t < k && gid[i + t] == g) {
      v = (strand[i + t] != rs ? -1 : 1) * (pos[i + t] + 1);
      ++t;
    }
    row[g] = v;
  }
  // the mask and sign fields, genome G-1 first, a bit at a time; then the
  // biased diagonals
  WordWriter out(words + rid, n_rows);
  out.put(valid ? 0 : 1, 1);
  for (int g = G - 1, t = k - 1; g >= 0; --g) {
    const bool here = valid && t >= 0 && gid[i + t] == g;
    out.put(here, 1);
    if (here) --t;
  }
  for (int g = G - 1, t = k - 1; g >= 0; --g) {
    const bool here = valid && t >= 0 && gid[i + t] == g;
    out.put(here && strand[i + t] != rs, 1);
    if (here) --t;
  }
  for (int g = 0, t = 0; g < G; ++g) {
    uint64_t db = 0;
    if (valid && t < k && gid[i + t] == g) {
      const int64_t p = pos[i + t];
      db = (uint64_t)((strand[i + t] != rs ? p + pos_ref : p - pos_ref) +
                      bias);
      ++t;
    }
    out.put(db, pos_bits + 2);
  }
  out.finish(n_words);
  posref[rid] = valid ? pos_ref : ((int64_t)1 << 62);
}

// K14 over tiles of kThreads * rows_per_thread table rows: each block
// flags its tile's group starts (kept, and the first row, or the row
// before not kept or of another row_id), gathers them in shared memory
// (a warp's starts in row order, so neighbouring threads build
// neighbouring candidates and store side by side), then builds one
// candidate a thread: every thread busy, where a thread a table row
// leaves the rows inside groups idle.
constexpr int kCandRowsMax = 8;  // table rows a thread flags a tile at most

__global__ void __launch_bounds__(kThreads) mum_candidates_kernel(
    const unsigned char* __restrict__ kept_occ, const int* __restrict__ row_id,
    const int* __restrict__ gid, const int* __restrict__ pos,
    const unsigned char* __restrict__ strand,
    const unsigned char* __restrict__ ref_strand, int64_t n, int G,
    int64_t seq_mask, int pos_bits, int n_words, int64_t n_rows,
    int rows_per_thread, int* __restrict__ starts,
    int64_t* __restrict__ words, int64_t* __restrict__ posref) {
  __shared__ int s_first[kThreads * kCandRowsMax];
  __shared__ int s_count;
  const int lane = threadIdx.x & 31;
  const uint64_t sm = (uint64_t)seq_mask;
  const int n_want = __popcll(G >= 64 ? sm : sm & ((1ull << G) - 1));
  const int64_t tile = (int64_t)kThreads * rows_per_thread;
  for (int64_t t0 = (int64_t)blockIdx.x * tile; t0 < n;
       t0 += (int64_t)gridDim.x * tile) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    for (int j = 0; j < rows_per_thread; ++j) {
      const int64_t i = t0 + (int64_t)j * kThreads + threadIdx.x;
      const bool first = i < n && kept_occ[i] &&
                         (i == 0 || !kept_occ[i - 1] ||
                          row_id[i - 1] != row_id[i]);
      const unsigned b = __ballot_sync(0xffffffffu, first);
      int at = 0;
      if (lane == 0 && b) at = atomicAdd(&s_count, __popc(b));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (first) s_first[at + __popc(b & ((1u << lane) - 1u))] = (int)(i - t0);
    }
    __syncthreads();
    const int count = s_count;
    for (int c = threadIdx.x; c < count; c += kThreads) {
      build_candidate(t0 + s_first[c], kept_occ, row_id, gid, pos, strand,
                      ref_strand, n, G, sm, n_want, pos_bits, n_words, n_rows,
                      starts, words, posref);
    }
    __syncthreads();
  }
}

// K15's scan: rep r's row index to index[r]; the last tile leaves n_reps
// in scratch word 1.
__global__ void __launch_bounds__(lm::kScanThreads)
    mum_rep_index_kernel(const int64_t* __restrict__ words,
                         const int64_t* __restrict__ posref, int64_t m,
                         int G, int n_words, int seed_len,
                         int* __restrict__ index,
                         unsigned long long* __restrict__ scratch) {
  const int64_t tile = lm::take_tile(scratch);
  const int lane = threadIdx.x & 31;
  const int64_t wbase =
      tile * lm::kScanTile + (threadIdx.x >> 5) * lm::kWarpSpan;
  // bit j of each: item j's row changed against its predecessor, holds a
  // mask bit, has its invalid bit set
  unsigned change = 0, mask = 0, invalid = 0;
  // the word columns, then posref (c == n_words)
  for (int c = 0; c <= n_words; ++c) {
    const int64_t* col = c < n_words ? words + (int64_t)c * m : posref;
    // the mask field's bits [1, G + 1) that lie in word c
    const int lo = c * kWordBits > 1 ? c * kWordBits : 1;
    const int hi = (c + 1) * kWordBits < G + 1 ? (c + 1) * kWordBits : G + 1;
    const uint64_t fmask =
        c < n_words && lo < hi
            ? (((uint64_t)1 << (hi - lo)) - 1) << ((c + 1) * kWordBits - hi)
            : 0;
    int64_t prev_lane0 = wbase > 0 && wbase <= m ? col[wbase - 1] : 0;
#pragma unroll
    for (int j = 0; j < lm::kScanItems; ++j) {
      const int64_t i = wbase + j * 32 + lane;
      const int64_t v = i < m ? col[i] : 0;
      int64_t prev = __shfl_up_sync(0xffffffffu, v, 1);
      if (lane == 0) prev = prev_lane0;
      prev_lane0 = __shfl_sync(0xffffffffu, v, 31);
      if (c < n_words) {
        if (v != prev) change |= 1u << j;
        if ((uint64_t)v & fmask) mask |= 1u << j;
        if (c == 0 && (((uint64_t)v >> (kWordBits - 1)) & 1)) {
          invalid |= 1u << j;
        }
      } else if (v - prev > seed_len) {
        change |= 1u << j;
      }
    }
  }
  unsigned ballot[lm::kScanItems];
  unsigned count = 0;
#pragma unroll
  for (int j = 0; j < lm::kScanItems; ++j) {
    const int64_t i = wbase + j * 32 + lane;
    const bool valid = (((mask & ~invalid) >> j) & 1u) != 0;
    const bool rep =
        i < m && valid && (i == 0 || ((change >> j) & 1u) != 0);
    ballot[j] = __ballot_sync(0xffffffffu, rep);
    count += __popc(ballot[j]);
  }
  unsigned warp_off, total;
  const unsigned long long off =
      lm::block_offsets(scratch, tile, count, &warp_off, &total);
  unsigned long long at = off + warp_off;
#pragma unroll
  for (int j = 0; j < lm::kScanItems; ++j) {
    if ((ballot[j] >> lane) & 1) {
      index[at + __popc(ballot[j] & lm::lanes_below())] =
          (int)(wbase + j * 32 + lane);
    }
    at += __popc(ballot[j]);
  }
  if (tile == (int64_t)gridDim.x - 1 && threadIdx.x == 0) {
    scratch[1] = off + total;
  }
}

// K15's decode: slot j < n_valid = min(n_reps, EC) takes row index[j] as
// extension row j; the slots after it are absent (zeros, not forward).
__global__ void mum_decode_reps_kernel(const int64_t* __restrict__ words,
                                       const int64_t* __restrict__ posref,
                                       const int* __restrict__ index,
                                       int64_t m, int64_t n_valid,
                                       int64_t ec, int G, int pos_bits,
                                       int* __restrict__ lefts,
                                       unsigned char* __restrict__ present,
                                       unsigned char* __restrict__ is_fwd) {
  for (int64_t j = first_index(); j < ec; j += grid_stride()) {
    const int64_t i = j < n_valid ? index[j] : -1;
    for (int g = 0; g < G; ++g) {
      const int s =
          i >= 0 ? recover_start(words, posref, m, i, G, pos_bits, g) : 0;
      lefts[j * G + g] = s != 0 ? (s < 0 ? -s : s) - 1 : 0;
      present[j * G + g] = s != 0 ? 1 : 0;
      is_fwd[j * G + g] = s > 0 ? 1 : 0;
    }
  }
}

}  // namespace

// K13's launch 2, after lm_run_summaries (big, span) on the same
// scratch: keys int64 the position-order keys, or with by_row the rows'
// own (int64[n]); kept_occ, ref_strand, strand uint8[n]; row_id, gid, pos
// int32[n]; scratch word 1 n_rows after the launch.
extern "C" int lm_mum_tile_flags(const void* content, const void* src,
                                 const void* keys, int by_row,
                                 const void* seg_off, int G, int64_t n,
                                 int span, int64_t repeat_limit,
                                 int64_t sent_content, void* scratch,
                                 void* kept_occ, void* row_id,
                                 void* ref_strand, void* gid, void* pos,
                                 void* strand, void* stream) {
  if (n > 0) {
    const lm::SeedTable t = lm::seed_table(content, src, keys, by_row,
                                           seg_off, G, n, scratch, gid, pos,
                                           strand);
    LM_LAUNCH(mum_tile_flags_kernel, (unsigned)t.tiles, kThreads, 0,
              (cudaStream_t)stream, t, span, repeat_limit, sent_content,
              (unsigned char*)kept_occ, (int*)row_id,
              (unsigned char*)ref_strand);
  }
  return (int)cudaGetLastError();
}

// K14: the flags of K13 at repeat_tolerance 0 (n rows); starts
// int32[n_rows, G], words int64[n_words, n_rows] and posref int64[n_rows]
// written whole (seq_mask's rejected rows zero and invalid).  seq_mask 0
// keeps every row.
extern "C" int lm_mum_candidates(const void* kept_occ, const void* row_id,
                                 const void* gid, const void* pos,
                                 const void* strand, const void* ref_strand,
                                 int64_t n, int G, int64_t n_rows,
                                 int64_t seq_mask, int pos_bits, int n_words,
                                 void* starts, void* words, void* posref,
                                 void* stream) {
  if (G < 1 || pos_bits + 2 > kWordBits ||
      n_words * kWordBits < 1 + G * (pos_bits + 4))
    return (int)cudaErrorInvalidValue;
  if (n > 0 && n_rows > 0) {
    // about a group's rows a thread, so a tile holds about a candidate a
    // thread
    const int per = G < kCandRowsMax ? G : kCandRowsMax;
    const int64_t tile = (int64_t)kThreads * per;
    int64_t tiles = (n + tile - 1) / tile;
    if (tiles > 65535 * 8) tiles = 65535 * 8;
    LM_LAUNCH(mum_candidates_kernel, (unsigned)tiles, kThreads, 0,
              (cudaStream_t)stream, (const unsigned char*)kept_occ,
              (const int*)row_id, (const int*)gid, (const int*)pos,
              (const unsigned char*)strand, (const unsigned char*)ref_strand,
              n, G, seq_mask, pos_bits, n_words, n_rows, per, (int*)starts,
              (int64_t*)words, (int64_t*)posref);
  }
  return (int)cudaGetLastError();
}

// K15's scan: words int64[n_words, m] and posref int64[m] in sorted
// order; index int32[m] (the first n_reps are written); scratch
// int64[lm_scan_scratch_words(m)], zeroed here, word 1 n_reps after the
// launch.
extern "C" int lm_mum_rep_index(const void* words, const void* posref,
                                int64_t m, int G, int n_words, int seed_len,
                                void* index, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, lm::scan_scratch_words(m) * sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    LM_LAUNCH(mum_rep_index_kernel, (unsigned)lm::scan_tiles(m),
              lm::kScanThreads, 0, s, (const int64_t*)words,
              (const int64_t*)posref, m, G, n_words, seed_len, (int*)index,
              (unsigned long long*)scratch);
  }
  return (int)cudaGetLastError();
}

// K15's decode: index int32 of the scan; lefts int32[ec, G], present and
// is_fwd uint8[ec, G], every slot written.  n_valid = min(n_reps, ec).
extern "C" int lm_mum_decode_reps(const void* words, const void* posref,
                                  const void* index, int64_t m,
                                  int64_t n_valid, int64_t ec, int G,
                                  int pos_bits, void* lefts, void* present,
                                  void* is_fwd, void* stream) {
  if (ec > 0) {
    LM_LAUNCH(mum_decode_reps_kernel, blocks_for(ec), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)words,
              (const int64_t*)posref, (const int*)index, m, n_valid, ec, G,
              pos_bits, (int*)lefts, (unsigned char*)present,
              (unsigned char*)is_fwd);
  }
  return (int)cudaGetLastError();
}
