// The run structure of a sorted table, in tiles: K5 (pairwise.cu), K13
// (mums.cu) and K16 (seedocc.cu).
//
// A run is a maximal block of rows of equal content in the sorted table:
// it starts at row 0 and wherever the content differs from the row
// before.  No thread ever walks a run (the sentinel run of N-masked
// windows can be 10^6 rows long).  The table is cut into tiles of
// kRunTile rows, and a kernel pair works over them:
//  1. a summary pass, one warp a tile (tile_edges): the tile's first and
//     last run start, or -1, found by comparing 32 rows, then 256 a step,
//     inward from each edge and stopping at the first start (typical runs
//     are a few rows, so a tile reads a few hundred bytes).  A table may
//     flag rows (K13's "big" rows); the summary then also says whether a
//     flagged row lies before the tile's first start, and whether one lies
//     at or after its last start (for a tile without a start, both say it
//     of the whole tile);
//  2. a row pass, one block a tile, where lane l of warp w holds rows
//     w * kRunWarpRows + 32 s + l of the tile, s < kRunRowsPerLane, and
//     forms the run starts as one ballot word a warp step.  A row's run
//     start is the nearest set bit at or before it, its end the nearest
//     one after it: bit scans inside a warp, the warps' first and last
//     starts through shared memory across the block, and across the
//     tile's edges the nearest earlier and later summaries that hold a
//     start (walk_summaries: one warp reads 32 * kRunWalkSpan summaries a
//     step, OR-ing the flags of the tiles it passes).
// Every summary is written before the row pass starts, so no block waits
// on another there, and a run of R rows costs each tile it spans
// O(R / kRunTile / 128) steps over summaries.
#pragma once

#include "common.cuh"
#include "scan.cuh"

namespace lm {

constexpr int kRunRowsPerLane = 16;
constexpr int kRunWarpRows = 32 * kRunRowsPerLane;
constexpr int64_t kRunTile = (int64_t)kTableThreads * kRunRowsPerLane;
// groups of 32 rows a step of the edge scans after the first; summaries a
// lane reads a step of the walks
constexpr int kRunEdgeGroups = 8;
constexpr int kRunWalkSpan = 4;
constexpr unsigned kRunFull = 0xffffffffu;

inline int64_t run_tiles(int64_t n) { return (n + kRunTile - 1) / kRunTile; }

// genome of a position-order row: the largest g < G with seg_off[g] <= src
__device__ __forceinline__ int gid_of(int64_t src,
                                      const int64_t* __restrict__ seg_off,
                                      int G) {
  int lo = 0, hi = G;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg_off[mid] <= src) lo = mid; else hi = mid;
  }
  return lo;
}

// K16's rows: sorted keys, content key >> 1, no flag.
struct KeyRows {
  const int64_t* __restrict__ keys;

  __device__ __forceinline__ uint64_t at(int64_t i) const {
    return (uint64_t)keys[i] >> 1;
  }
  __device__ __forceinline__ bool flag(int64_t, uint64_t) const {
    return false;
  }
};

// Row i of a (content, gid, pos)-sorted seed table is big when row
// i - span lies in its (content, genome) subrun (span = repeat_tolerance +
// 1; the rows between then share both, the table being sorted); g is row
// i's genome.  span <= 0 makes every row big, as no subrun is that short.
__device__ __forceinline__ bool big_row(const int64_t* __restrict__ content,
                                        const int64_t* __restrict__ src,
                                        const int64_t* __restrict__ seg_off,
                                        int span, int64_t i, int64_t c,
                                        int g) {
  if (span <= 0) return true;
  const int64_t j = i - span;
  if (j < 0 || content[j] != c) return false;
  const int64_t sj = src[j];
  return seg_off[g] <= sj && sj < seg_off[g + 1];
}

// K5's and K13's rows: the sorted contents and each row's source index
// into the position-order keys (seg_off: int64[G+1] the genome bounds);
// flagged rows are big_row's where `big`, none otherwise.
struct TableRows {
  const int64_t* __restrict__ content;
  const int64_t* __restrict__ src;
  const int64_t* __restrict__ seg_off;
  int G;
  int span;
  bool big;

  __device__ __forceinline__ uint64_t at(int64_t i) const {
    return (uint64_t)content[i];
  }
  __device__ __forceinline__ bool flag(int64_t i, uint64_t c) const {
    if (!big) return false;
    // the content first: the genome's search only where it matches
    if (span > 0 && (i < span || (uint64_t)content[i - span] != c)) {
      return false;
    }
    return big_row(content, src, seg_off, span, i, (int64_t)c,
                   gid_of(src[i], seg_off, G));
  }
};

// A start found by an edge scan (-1: none) and whether a flagged row lies
// among the rows it passed before reaching it (up) or at or after it
// (down; every row it read where it found none), or the scan was told one
// already did (its `flag` argument).
struct RunEdge {
  int64_t at;
  bool flag;
};

// The first run start among rows [lo, min(lo + 32 * G, hi)).  One warp;
// lane l reads rows lo + 32 g + l.
template <int G, class Rows>
__device__ __forceinline__ RunEdge first_start_up(const Rows& rows, int64_t lo,
                                                  int64_t hi, bool flag) {
  const int lane = threadIdx.x & 31;
  uint64_t c[G], before[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t i = lo + g * 32 + lane;
    c[g] = i < hi ? rows.at(i) : 0;
    before[g] = lane == 0 && i < hi && i > 0 ? rows.at(i - 1) : 0;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t i = lo + g * 32 + lane;
    uint64_t prev = __shfl_up_sync(kRunFull, c[g], 1);
    if (lane == 0) prev = before[g];
    const bool start = i < hi && (i == 0 || c[g] != prev);
    const unsigned b = __ballot_sync(kRunFull, start);
    // once a flagged row is found the rest need no test
    const unsigned f =
        flag ? 0u : __ballot_sync(kRunFull, i < hi && rows.flag(i, c[g]));
    flag |= (f & (b ? (1u << (__ffs(b) - 1)) - 1u : kRunFull)) != 0;
    if (b) return {lo + g * 32 + __ffs(b) - 1, flag};
  }
  return {-1, flag};
}

// The last run start among rows [max(lo, top - 32 * G + 1), top].  One
// warp; lane l reads rows top - 32 g - l.
template <int G, class Rows>
__device__ __forceinline__ RunEdge last_start_down(const Rows& rows,
                                                   int64_t lo, int64_t top,
                                                   bool flag) {
  const int lane = threadIdx.x & 31;
  uint64_t c[G], before[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t i = top - g * 32 - lane;
    c[g] = i >= lo ? rows.at(i) : 0;
    before[g] = lane == 31 && i >= lo && i > 0 ? rows.at(i - 1) : 0;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t i = top - g * 32 - lane;
    uint64_t prev = __shfl_down_sync(kRunFull, c[g], 1);
    if (lane == 31) prev = before[g];
    const bool start = i >= lo && (i == 0 || c[g] != prev);
    const unsigned b = __ballot_sync(kRunFull, start);
    const unsigned f =
        flag ? 0u : __ballot_sync(kRunFull, i >= lo && rows.flag(i, c[g]));
    // lanes 0 .. the start's read the rows at or after it
    flag |= (f & (b ? (2u << (__ffs(b) - 1)) - 1u : kRunFull)) != 0;
    if (b) return {top - g * 32 - (__ffs(b) - 1), flag};
  }
  return {-1, flag};
}

// A tile's summary: its first and last run start (-1 where it holds none)
// and whether a flagged row lies before the first, and at or after the
// last (both: anywhere in the tile, where it holds no start).
struct TileEdges {
  int64_t first, last;
  bool flag_first, flag_last;
};

// The summary of rows [a, b), b > a.  One warp.
template <class Rows>
__device__ TileEdges tile_edges(const Rows& rows, int64_t a, int64_t b) {
  RunEdge up = first_start_up<1>(rows, a, b, false);
  for (int64_t lo = a + 32; up.at < 0 && lo < b; lo += 32 * kRunEdgeGroups) {
    up = first_start_up<kRunEdgeGroups>(rows, lo, b, up.flag);
  }
  TileEdges e{up.at, -1, up.flag, up.flag};
  if (up.at >= 0) {
    // row `up.at` starts a run, so the downward scan stops by it
    RunEdge down = last_start_down<1>(rows, up.at, b - 1, false);
    for (int64_t top = b - 33; down.at < 0; top -= 32 * kRunEdgeGroups) {
      down = last_start_down<kRunEdgeGroups>(rows, up.at, top, down.flag);
    }
    e.last = down.at;
    e.flag_last = down.flag;
  }
  return e;
}

// Summary words: K16's are a start (int, -1: none); K5's and K13's a start
// and a flag as start * 2 + flag in a long long (-2 | flag: none).
__device__ __forceinline__ int64_t word_start(int v) { return v; }
__device__ __forceinline__ bool word_flag(int) { return false; }
__device__ __forceinline__ int64_t word_start(long long v) { return v >> 1; }
__device__ __forceinline__ bool word_flag(long long v) { return v & 1; }

// The nearest start >= 0 in s[t + dir], s[t + 2 dir], ... inside [0,
// tiles), or -1 where none is, and whether any word up to and including
// it (all of them, where none) is flagged.  One warp; a step reads 32 *
// kRunWalkSpan words.
template <class Word>
__device__ RunEdge walk_summaries(const Word* __restrict__ s, int64_t t,
                                  int64_t tiles, int dir) {
  const int lane = threadIdx.x & 31;
  bool flag = false;
  for (int64_t d = 1;; d += 32 * kRunWalkSpan) {
    Word v[kRunWalkSpan];
#pragma unroll
    for (int u = 0; u < kRunWalkSpan; ++u) {
      const int64_t tt = t + dir * (d + u * 32 + lane);
      v[u] = tt >= 0 && tt < tiles ? s[tt] : (Word)-2;
    }
#pragma unroll
    for (int u = 0; u < kRunWalkSpan; ++u) {
      const unsigned b = __ballot_sync(kRunFull, word_start(v[u]) >= 0);
      const unsigned f = __ballot_sync(kRunFull, word_flag(v[u]));
      flag |= (f & (b ? (2u << (__ffs(b) - 1)) - 1u : kRunFull)) != 0;
      if (b) {
        return {__shfl_sync(kRunFull, word_start(v[u]), __ffs(b) - 1), flag};
      }
    }
    const int64_t far = t + dir * (d + 32 * kRunWalkSpan - 1);
    if (far < 0 || far >= tiles) return {-1, flag};
  }
}

// Rows a lane loads at once in the row pass, and the row pass's blocks an
// SM: a chunk of 4 rows keeps a thread in 64 registers, 4 blocks an SM
// (on an H100, chunks of 8 and 16 rows at 1-3 blocks an SM were slower).
constexpr int kRunChunk = 4;
constexpr int kRunMinBlocks = 4;
// ballot words of a tile: one a (warp w, step s), at w * kRunRowsPerLane +
// s, for the rows w * kRunWarpRows + 32 s .. + 31 (tile-relative)
constexpr int kRunWords = (int)(kRunTile / 32);

// A seed table as the row pass reads and writes it.
struct SeedTable {
  const int64_t* __restrict__ content;
  const int64_t* __restrict__ src;
  const int64_t* __restrict__ keys;
  int by_row;
  const int64_t* __restrict__ seg_off;
  int G;
  int64_t n;
  int64_t tiles;
  // the summaries of the tiles: their first starts' words, then their
  // last starts' (tiles each)
  const long long* __restrict__ words;
  // the row pass's decoupled look-back (scan.cuh), zeroed by the summaries
  unsigned long long* __restrict__ scan;
  int* __restrict__ gid;
  int* __restrict__ pos;
  unsigned char* __restrict__ strand;
};

// The row pass's shared words: run and subrun starts, and for each step
// the last run start in the warp's earlier steps and the first in its
// later ones (tile-relative; -1: none).
struct RowWords {
  unsigned sc[kRunWords];
  unsigned scg[kRunWords];
  int before[kRunWords];
  int after[kRunWords];
};

// K13's besides: big rows and the last big row in a warp's earlier steps,
// strands, the rows that decide kept runs, kept runs' starts, and the
// rows' genomes.
struct BigWords {
  unsigned big[kRunWords];
  int big_before[kRunWords];
  unsigned strand[kRunWords];
  unsigned kept[kRunWords];
  unsigned kept_start[kRunWords];
  int gid[kRunTile];
};

// The row pass's rows of warp w of tile [a, b) (w0 its first): each row's
// genome, position and strand written (the strand is keys[src[i]] & 1, or
// keys[i] & 1 with by_row), the run and subrun starts' ballot words into
// rw and, with kBig, the big rows', the strands' and the genomes into bw.
// Returns the lane's rows whose content is the sentinel as bits s;
// `starts` the warp's run starts.  The loads of a chunk of steps all come
// before its stores, so that they are in flight at once (a search of
// seg_off for the genome, a random gather for the strand: the pass's
// floor).
template <bool kBig>
__device__ __forceinline__ unsigned load_tile_rows(
    const SeedTable& t, int span, int64_t w0, int64_t a, int64_t b,
    int64_t sent_content, RowWords& rw, BigWords* bw, unsigned& starts) {
  const int lane = threadIdx.x & 31;
  const int ws0 = (threadIdx.x >> 5) * kRunRowsPerLane;
  // the row before the chunk's first (lane 0's neighbour): content, genome
  int64_t c_prev = 0;
  int g_prev = 0;
  if (lane == 0 && w0 > 0 && w0 < b) {
    c_prev = t.content[w0 - 1];
    g_prev = gid_of(t.src[w0 - 1], t.seg_off, t.G);
  }
  unsigned sent = 0;
  starts = 0;
#pragma unroll
  for (int h = 0; h < kRunRowsPerLane; h += kRunChunk) {
    int64_t c[kRunChunk], sv[kRunChunk];
    int g[kRunChunk], p[kRunChunk];
    unsigned st = 0, big = 0;
#pragma unroll
    for (int k = 0; k < kRunChunk; ++k) {
      const int64_t i = w0 + (h + k) * 32 + lane;
      c[k] = i < b ? t.content[i] : 0;
      sv[k] = i < b ? t.src[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < kRunChunk; ++k) {
      const int64_t i = w0 + (h + k) * 32 + lane;
      g[k] = i < b ? gid_of(sv[k], t.seg_off, t.G) : 0;
      p[k] = i < b ? (int)(sv[k] - t.seg_off[g[k]]) : 0;
      if (i < b && c[k] == sent_content) sent |= 1u << (h + k);
    }
#pragma unroll
    for (int k = 0; k < kRunChunk; ++k) {
      const int64_t i = w0 + (h + k) * 32 + lane;
      if (i < b) st |= (unsigned)(t.keys[t.by_row ? i : sv[k]] & 1) << k;
    }
    if (kBig) {
#pragma unroll
      for (int k = 0; k < kRunChunk; ++k) {
        const int64_t i = w0 + (h + k) * 32 + lane;
        if (i < b && big_row(t.content, t.src, t.seg_off, span, i, c[k], g[k]))
          big |= 1u << k;
      }
    }
#pragma unroll
    for (int k = 0; k < kRunChunk; ++k) {
      const int s = h + k;
      const int64_t i = w0 + s * 32 + lane;
      const bool valid = i < b;
      if (valid) {
        t.gid[i] = g[k];
        t.pos[i] = p[k];
        t.strand[i] = (unsigned char)((st >> k) & 1u);
        if (kBig) bw->gid[i - a] = g[k];
      }
      int64_t cp = __shfl_up_sync(kRunFull, c[k], 1);
      int gp = __shfl_up_sync(kRunFull, g[k], 1);
      const int64_t c_step = __shfl_sync(kRunFull, c[k > 0 ? k - 1 : 0], 31);
      const int g_step = __shfl_sync(kRunFull, g[k > 0 ? k - 1 : 0], 31);
      if (lane == 0) {
        cp = k > 0 ? c_step : c_prev;
        gp = k > 0 ? g_step : g_prev;
      }
      const bool run_start = valid && (i == 0 || c[k] != cp);
      const unsigned m = __ballot_sync(kRunFull, run_start);
      const unsigned mg =
          __ballot_sync(kRunFull, run_start || (valid && g[k] != gp));
      starts += __popc(m);
      if (lane == 0) {
        rw.sc[ws0 + s] = m;
        rw.scg[ws0 + s] = mg;
      }
      if (kBig) {
        const unsigned mb = __ballot_sync(kRunFull, (big >> k) & 1u);
        const unsigned ms = __ballot_sync(kRunFull, (st >> k) & 1u);
        if (lane == 0) {
          bw->big[ws0 + s] = mb;
          bw->strand[ws0 + s] = ms;
        }
      }
    }
    const int64_t c_last = __shfl_sync(kRunFull, c[kRunChunk - 1], 31);
    const int g_last = __shfl_sync(kRunFull, g[kRunChunk - 1], 31);
    if (lane == 0) {
      c_prev = c_last;
      g_prev = g_last;
    }
  }
  return sent;
}

// For each step of the warp, the last set bit of its words m in the
// earlier steps (before) and, where `after`, the first in the later ones,
// tile-relative (-1: none); w0 - a is the warp's first row.  Every lane of
// the warp calls it once the words are written.
__device__ __forceinline__ void step_carries(const unsigned* m, int* before,
                                             int* after, int64_t w0,
                                             int64_t a) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int ws0 = (threadIdx.x >> 5) * kRunRowsPerLane;
  if (lane < kRunRowsPerLane) {
    const int base = (int)(w0 - a);
    int p = -1, q = -1;
    for (int k = 0; k < lane; ++k) {
      if (m[ws0 + k]) p = base + k * 32 + 31 - __clz(m[ws0 + k]);
    }
    for (int k = kRunRowsPerLane - 1; k > lane; --k) {
      if (m[ws0 + k]) q = base + k * 32 + __ffs(m[ws0 + k]) - 1;
    }
    before[ws0 + lane] = p;
    if (after) after[ws0 + lane] = q;
  }
  __syncwarp();
}

// The warp's first and last set bits of its words m (tile-relative; -1:
// none), from step_carries' results.
__device__ __forceinline__ int warp_first_bit(const unsigned* m,
                                              const int* after, int ws0,
                                              int64_t w0, int64_t a) {
  return m[ws0] ? (int)(w0 - a) + __ffs(m[ws0]) - 1 : after[ws0];
}

__device__ __forceinline__ int warp_last_bit(const unsigned* m,
                                             const int* before, int ws0,
                                             int64_t w0, int64_t a) {
  const int ws = ws0 + kRunRowsPerLane - 1;
  return m[ws] ? (int)(w0 - a) + (kRunRowsPerLane - 1) * 32 + 31 -
                     __clz(m[ws])
               : before[ws];
}

// Tile-relative row r of word ws (r0 = 32 ws its first; upto: the lanes
// at or below its own): the nearest set bit of m at or before it, else the
// step's `before`, else `carry`; and the nearest one after it, else the
// step's `after`, else `carry`.
__device__ __forceinline__ int64_t bit_at_or_before(unsigned m, unsigned upto,
                                                    int r0, int before,
                                                    int64_t carry) {
  const unsigned x = m & upto;
  return x ? r0 + 31 - __clz(x) : before >= 0 ? before : carry;
}

__device__ __forceinline__ int64_t bit_after(unsigned m, unsigned upto,
                                             int r0, int after,
                                             int64_t carry) {
  const unsigned x = m & ~upto;
  return x ? r0 + __ffs(x) - 1 : after >= 0 ? after : carry;
}

// The SeedTable of a row pass over n rows with its scratch (int64[
// kScanHeader + 3 * run_tiles(n)]: the look-back, then the summaries).
inline SeedTable seed_table(const void* content, const void* src,
                            const void* keys, int by_row, const void* seg_off,
                            int G, int64_t n, void* scratch, void* gid,
                            void* pos, void* strand) {
  const int64_t tiles = run_tiles(n);
  unsigned long long* scan = (unsigned long long*)scratch;
  return SeedTable{(const int64_t*)content,
                   (const int64_t*)src,
                   (const int64_t*)keys,
                   by_row,
                   (const int64_t*)seg_off,
                   G,
                   n,
                   tiles,
                   (const long long*)(scan + kScanHeader + tiles),
                   scan,
                   (int*)gid,
                   (int*)pos,
                   (unsigned char*)strand};
}

// Whether row b (the first after tile [a, b)) starts a subrun: true at
// the table's end.
__device__ __forceinline__ bool subrun_starts_at(const SeedTable& t,
                                                 int64_t b) {
  if (b >= t.n) return true;
  return t.content[b] != t.content[b - 1] ||
         gid_of(t.src[b], t.seg_off, t.G) !=
             gid_of(t.src[b - 1], t.seg_off, t.G);
}

}  // namespace lm
