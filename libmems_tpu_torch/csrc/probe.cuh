// One probe round of ungapped extension for one row, by one thread block:
// shared by K2 (csrc/extend.cu, keys read from the position-order table)
// and K31 (csrc/tiled.cu, keys read from spans fetched from the owners of
// position tiles).  The round is ops/extend.py:241-294 of the JAX package.
//
// The row's per-genome state lives in arrays the block shares (shared
// memory or global scratch): left end, window count, presence and strand.
// Each thread owns `per` consecutive probe offsets d0 .. d0 + per - 1 of
// 1 .. C and keeps their matches as a bitmask (per <= 32).
#pragma once

#include "common.cuh"

namespace lm {

// Match bits of one thread's probe offsets: bit k is set when, at offset
// d = d0 + k, every present genome's probe position q lies in [0, count),
// no key is the sentinel (its low bit may be either), and every key XORed
// with its strand flag equals the reference genome's (`ref`, the first
// present one).  fetch(g, q, d, back) returns genome g's key at probe
// position q (offset d; back: the genome moves left on this side).
template <typename Fetch>
__device__ __forceinline__ unsigned probe_bits(
    int d0, int per, int C, int G, int ref, int side, int len, int seed_len,
    const int* s_left, const int* s_cnt, const int* s_pres, const int* s_fwd,
    long long fill, const Fetch& fetch) {
  unsigned mbits = 0u;
  for (int k = 0; k < per; ++k) {
    const int d = d0 + k;
    if (d > C) break;
    bool ok = true;
    long long ref_key = 0;
    // genomes before `ref` are absent by definition of ref
    for (int g = ref; g < G && ok; ++g) {
      if (!s_pres[g]) continue;
      const int l = s_left[g];
      const bool back = side == 0 ? s_fwd[g] != 0 : s_fwd[g] == 0;
      const int q = back ? l - d : l + len - seed_len + d;
      if (q < 0 || q >= s_cnt[g]) {
        ok = false;
        break;
      }
      long long kq = fetch(g, q, d, back);
      if ((kq | 1LL) == fill) {
        ok = false;
        break;
      }
      kq ^= (long long)s_fwd[g];
      if (g == ref) {
        ref_key = kq;
      } else if (kq != ref_key) {
        ok = false;
      }
    }
    if (ok) mbits |= 1u << k;
  }
  return mbits;
}

// The furthest offset reachable from 0 with gaps <= seed_len between
// matching offsets (ops/extend.py:270-279), from every thread's match
// bits; the same value in every thread.  Every thread of the block calls
// it.  s_tmp: kScanTmp ints of shared scratch.
__device__ __forceinline__ int probe_reach(unsigned mbits, int d0, int per,
                                           int seed_len, int* s_tmp) {
  const int last_local = mbits ? d0 + (31 - __clz(mbits)) : 0;
  const int prev = block_scan(last_local, 0, MaxOp(), s_tmp).excl;
  int bad = INT_MAX;
  {
    int p = prev;
    for (int k = 0; k < per; ++k) {
      if (!((mbits >> k) & 1u)) continue;
      const int d = d0 + k;
      if (d - p > seed_len) {
        bad = d;
        break;
      }
      p = d;
    }
  }
  const int first_bad = block_scan(bad, INT_MAX, MinOp(), s_tmp).total;
  int rloc = 0;
  for (int k = 0; k < per; ++k) {
    if (((mbits >> k) & 1u) && d0 + k < first_bad) rloc = d0 + k;
  }
  return block_scan(rloc, 0, MaxOp(), s_tmp).total;
}

// Advance the row by `reach` (ops/extend.py:281-293): the side's moving
// genomes' left ends shift left by reach, the length grows by it, and the
// row stays active while the chain may continue past C: reach + seed_len
// > C and the least room left + reach > C.  Every thread of the block
// calls it and gets the same length and continue test; genome g's state
// is updated by thread g mod blockDim.x.
__device__ __forceinline__ bool probe_advance(int reach, int& len, int C,
                                              int G, int side, int seed_len,
                                              int* s_left, const int* s_cnt,
                                              const int* s_pres,
                                              const int* s_fwd, int* s_tmp) {
  const int newlen = len + reach;
  int room = 1 << 30;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    if (!s_pres[g]) continue;
    const bool back = side == 0 ? s_fwd[g] != 0 : s_fwd[g] == 0;
    if (back) s_left[g] -= reach;
    const int back_room = s_left[g];
    const int ahead_room = (s_cnt[g] - 1) - (s_left[g] + newlen - seed_len);
    const int rm = back ? back_room : ahead_room;
    room = rm < room ? rm : room;
  }
  room = block_scan(room, 1 << 30, MinOp(), s_tmp).total;
  len = newlen;
  return (reach + seed_len > C) && (room + reach > C);
}

}  // namespace lm
