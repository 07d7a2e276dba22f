// Order-preserving compaction in one pass: block tiles, a ballot scan
// inside each warp and a decoupled look-back between tiles.
//
// A kernel built on it launches scan_tiles(n) blocks of kScanThreads.
// Each block takes its tile from an atomic ticket, so tiles are numbered
// in the order their blocks start and a tile only ever waits on tiles
// whose blocks are already running (blocks run in no fixed order).  A
// block may leave before it takes a ticket where the tiles such blocks
// own are the last ones (K7's tiles of -1 words): the tickets then number
// the other tiles from 0, in start order as before.  Warp
// w of a tile owns items [tile * kScanTile + w * kWarpSpan, + kWarpSpan):
// item j of lane l is base + j * 32 + l, so each of a warp's kScanItems
// loads is coalesced, and one ballot a load gives the warp's survivors in
// item order.  The block adds its warps' counts, publishes the sum in its
// tile's status word, and warp 0 looks back over its predecessors'
// status words for the tile's exclusive offset (the look-back of Merrill
// and Garland's single-pass prefix scan).  Survivors are then stored at
// offset + rank, in item order, with no cumsum pass and no host stall.
//
// Scratch (int64[scan_scratch_words(n)], zeroed by the launcher before
// each launch): word 0 the ticket counter, words 1..kScanHeader-1 the
// kernel's own counts, then one status word a tile.  A status word holds
// its state in bits 62-63 (0 not yet published, 1 the tile's own count,
// 2 its inclusive prefix) and the count in bits 0-61, in one 64-bit
// store, so a reader never sees a state without its count.
#pragma once

#include "common.cuh"

namespace lm {

constexpr int kScanWarps = 8;
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kScanItems = 16;
constexpr int kWarpSpan = 32 * kScanItems;
constexpr int64_t kScanTile = (int64_t)kScanThreads * kScanItems;
constexpr int kScanHeader = 4;

constexpr unsigned long long kTileOwn = 1ull << 62;
constexpr unsigned long long kTileInclusive = 2ull << 62;
constexpr unsigned long long kTileCount = (1ull << 62) - 1;

inline int64_t scan_tiles(int64_t n) {
  return (n + kScanTile - 1) / kScanTile;
}

inline int64_t scan_scratch_words(int64_t n) {
  return kScanHeader + scan_tiles(n);
}

// The block's tile, from the ticket in scratch word 0.  Every thread of
// the block must call it.
__device__ __forceinline__ int64_t take_tile(unsigned long long* scratch) {
  __shared__ int64_t tile;
  if (threadIdx.x == 0) tile = (int64_t)atomicAdd(scratch, 1ull);
  __syncthreads();
  return tile;
}

// Exclusive offset of `tile`, whose own count is `count`, from the
// tiles before it; publishes the tile's inclusive prefix.  Called by all
// 32 lanes of one warp; every lane returns the offset.  Several counts
// a tile scan side by side with `stride` status words a tile: count
// `slot`'s status word of tile t is stride * t + slot.
__device__ inline unsigned long long tile_lookback(
    unsigned long long* scratch, int64_t tile, unsigned long long count,
    int64_t stride = 1, int64_t slot = 0) {
  volatile unsigned long long* status = scratch + kScanHeader + slot;
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) status[0] = kTileInclusive | count;
    return 0;
  }
  if (lane == 0) status[stride * tile] = kTileOwn | count;
  unsigned long long excl = 0;
  for (int64_t top = tile - 1;; top -= 32) {
    // lane l reads tile top - l; before tile 0 the prefix is 0
    const int64_t t = top - lane;
    unsigned long long s = kTileInclusive;
    if (t >= 0) {
      do {
        s = status[stride * t];
      } while ((s >> 62) == 0);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (s >> 62) == 2);
    // the nearest inclusive tile ends the walk: add it and the own
    // counts of the tiles after it
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned long long v = lane <= stop ? (s & kTileCount) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (incl) break;
  }
  if (lane == 0) status[stride * tile] = kTileInclusive | (excl + count);
  return excl;
}

// The block's offsets from each warp's survivor count: every thread gets
// its warp's offset within the tile and the tile's exclusive offset, and
// `total` the tile's count.  Every thread of the block must call it.
__device__ __forceinline__ unsigned long long block_offsets(
    unsigned long long* scratch, int64_t tile, unsigned warp_count,
    unsigned* warp_off, unsigned* total) {
  __shared__ unsigned counts[kScanWarps];
  __shared__ unsigned long long tile_off;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) counts[warp] = warp_count;
  __syncthreads();
  unsigned before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) {
    before += w < warp ? counts[w] : 0;
    sum += counts[w];
  }
  if (warp == 0) {
    const unsigned long long off = tile_lookback(scratch, tile, sum);
    if (lane == 0) tile_off = off;
  }
  __syncthreads();
  *warp_off = before;
  *total = sum;
  return tile_off;
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1;
}

}  // namespace lm
