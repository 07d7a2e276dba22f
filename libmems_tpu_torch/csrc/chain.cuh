// The warp route's probe pieces shared by K2 (csrc/extend.cu, keys read
// from the position-order table) and K31 (csrc/tiled.cu, keys read from
// spans fetched from the owners of position tiles): a warp a row, lane g
// genome g, 32 consecutive probe offsets a ballot word, and the chain of
// ops/extend.py:270-279 followed on those words by bit operations.
#pragma once

#include "common.cuh"

namespace lm_chain {

constexpr unsigned kFull = 0xffffffffu;
// genomes a row at most on a warp route (lane g holds genome g)
constexpr int kWarpGenomes = 32;
// ballot words a step at most
constexpr int kMaxWords = 8;

// The chain of one side followed over its ballot words, in offset order.
struct Chain {
  int p;      // the chain's last match (offset; 0 is the side's start)
  int first;  // the first match taken (segment summaries)
  bool have;  // p holds a match (offset 0 counts on a side's own walk)
  bool brk;   // the chain ended at p
};

// Takes word w, whose bit i is the match bit of offset b + i + 1: the
// first match more than seed_len past the one before it ends the chain.
// Every lane of the warp calls it with the same arguments.
__device__ __forceinline__ void chain_word(unsigned w, int b, int seed_len,
                                           Chain& c) {
  if (c.brk) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = w & ((1u << lane) - 1u);
  const int prev = below ? b + 32 - __clz(below) : c.p;
  const bool bad = ((w >> lane) & 1u) && (below != 0u || c.have) &&
                   b + lane + 1 - prev > seed_len;
  const unsigned bw = __ballot_sync(kFull, bad);
  unsigned upto = w;
  if (bw) {
    upto = w & ((1u << (__ffs(bw) - 1)) - 1u);
    c.brk = true;
  }
  if (upto) {
    if (!c.have) c.first = b + __ffs(upto);
    c.have = true;
    c.p = b + 32 - __clz(upto);
  }
}

__device__ __forceinline__ long long min64(long long a, long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ long long max64(long long a, long long b) {
  return a > b ? a : b;
}

// One side's probe geometry: this lane's genome's key at offset d is
// keys[at + dir * d], XORed with flip; every present genome's window lies
// in its genome (and its key in the array read) exactly for d in [lo, hi]
// (the same in every lane).
struct SideGeom {
  long long at, flip;
  int dir, lo, hi;
};

// Match words w[j] of offsets base + 32 j + lane + 1, j < u (zero for j
// >= u): for each present genome (pmask, reference first) the lanes read
// 32 consecutive keys a word.  Every lane of the warp calls it with the
// same arguments.
__device__ __forceinline__ void probe_words(
    const long long* __restrict__ keys, long long fill, unsigned pmask,
    const SideGeom& sg, int base, int u, unsigned (&w)[kMaxWords]) {
  const int lane = threadIdx.x & 31;
  const int ref = __ffs(pmask) - 1;
  bool ok[kMaxWords];
  long long rk[kMaxWords];
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    const int d = base + 32 * j + lane + 1;
    ok[j] = j < u && d >= sg.lo && d <= sg.hi;
    rk[j] = 0;
  }
  for (unsigned m = pmask; m; m &= m - 1) {
    const int g = __ffs(m) - 1;
    const long long at = __shfl_sync(kFull, sg.at, g);
    const long long flip = __shfl_sync(kFull, sg.flip, g);
    const int dir = __shfl_sync(kFull, sg.dir, g);
#pragma unroll
    for (int j = 0; j < kMaxWords; ++j) {
      const int d = base + 32 * j + lane + 1;
      const long long k = ok[j] ? keys[at + (long long)dir * d] : fill;
      const bool live = ok[j] && (k | 1LL) != fill;
      if (g == ref) {
        rk[j] = k ^ flip;
        ok[j] = live;
      } else {
        ok[j] = live && (k ^ flip) == rk[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) w[j] = __ballot_sync(kFull, ok[j]);
}

}  // namespace lm_chain
