// K1: canonical spaced-seed keys over tiles of 2-bit words in shared
// memory.
//
// Replaces libmems_tpu/ops/mers.py _canonical_seed_keys_jit and
// _canonical_seed_keys_masked_jit (XLA: `weight` strided slices summed
// into forward and reverse-complement words, plus a cumsum window test
// for ambiguous bases; built from _keys_core and _window_bad).
//
// Bound: memory.  A window reads one code byte (and one flag byte when a
// mask is given) and writes one 8-byte key.  Design: a block takes a tile
// of kTile windows and their length - 1 halo, reads the code bytes with
// 16-byte loads and packs them 16 bases to a 32-bit word in shared memory
// (first base in the top bits); the flags are packed the same way, one
// bit a base, 16 a lane from one 16-byte load and two lanes' halves
// joined by a shuffle: one load instruction per 16 bases where a ballot
// over byte loads takes 16.  A window's 64-bit word W (base k at bits
// 63-2k) is a funnel shift of three neighbouring shared words, so no
// thread re-reads bytes at the seed's offsets and none walks a warm-up.
// fwd is the OR over the pattern's runs of consecutive sampled positions
// of (W >> shift_r) & mask_r (the run table, built once a seed by the
// wrapper), taken run by run over kBatch windows a thread held in
// registers, so a run's shift and mask are read once a batch and the
// shifts need no per-window operand; rc is the complemented fwd with its
// 2-bit groups reversed
// (brev, then swap the two bits of each group), and a window touches an
// ambiguous base exactly when its `length` flag bits are not all zero.
// Consecutive threads store consecutive keys.
//
// Codes are in [0, 3] (sequence.translate_dna's contract): the packing
// keeps each code's low two bits.  A window holds at most 32 bases (the
// longest spaced pattern spans 29, a solid seed at most 32), so W always
// fits 64 bits.  Keys are int64 holding the unsigned key: min(fwd << 1,
// rc << 1 | 1) in unsigned order, which wraps at weight 32 as the plain
// version's 64-bit shift does.  A window touching an ambiguous base gets
// `sentinel`, the all-ones value of the JAX key width (0xFFFFFFFF for u32
// keys, -1 for u64).
#include "common.cuh"

namespace {

constexpr int kMaxRuns = 32;
constexpr int kThreads = 256;
constexpr int kTile = 4096;                 // windows a block
constexpr int kBatch = 8;                   // windows a thread at a time
constexpr int kHalo = 32;                   // >= length - 1, a whole word
constexpr int kCodeWords = kTile / 16 + 2;  // 16 bases a word
constexpr int kFlagWords = kCodeWords / 2;  // 32 bases a word

// The seed's run table (ops/mers.py seed_runs): run r contributes
// (W >> shift[r]) & mask[r] to fwd.
struct SeedRuns {
  int n_runs;
  int weight;
  int length;
  int pad;
  int shift[kMaxRuns];
  unsigned long long mask[kMaxRuns];
};

// 16 code bytes (one per base, in [0, 3]) as a 32-bit word, the first
// base in bits 31-30.
__device__ __forceinline__ unsigned pack_codes(uint4 v) {
  const unsigned q[4] = {v.x, v.y, v.z, v.w};
  unsigned out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned g = ((q[k] & 3u) << 6) | ((q[k] >> 4) & 0x30u) |
                       ((q[k] >> 14) & 0xCu) | ((q[k] >> 24) & 3u);
    out |= g << (24 - 8 * k);
  }
  return out;
}

// 16 flag bytes (0 or 1) as 16 bits, the first base in bit 0.
__device__ __forceinline__ unsigned pack_flags(uint4 v) {
  const unsigned q[4] = {v.x, v.y, v.z, v.w};
  unsigned out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned g = (q[k] & 1u) | ((q[k] >> 7) & 2u) |
                       ((q[k] >> 14) & 4u) | ((q[k] >> 21) & 8u);
    out |= g << (4 * k);
  }
  return out;
}

// Bytes [at, at + 16) of src, zero past `len`: one 16-byte load where the
// address is aligned and the bytes lie inside, else byte loads.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ src,
                                        int64_t at, int64_t len) {
  if (at + 16 <= len && (((uintptr_t)(src + at)) & 15) == 0) {
    return __ldcs((const uint4*)(src + at));
  }
  unsigned q[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (at + k < len) q[k >> 2] |= (unsigned)src[at + k] << (8 * (k & 3));
  }
  return make_uint4(q[0], q[1], q[2], q[3]);
}

__device__ __forceinline__ unsigned long long pairswap(unsigned long long x) {
  const unsigned long long lo = 0x5555555555555555ull;
  return ((x >> 1) & lo) | ((x & lo) << 1);
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    seed_keys_kernel(const uint8_t* __restrict__ codes,
                     const uint8_t* __restrict__ ambig, int64_t n,
                     SeedRuns sr, long long sentinel,
                     long long* __restrict__ out) {
  __shared__ unsigned cw[kCodeWords];
  __shared__ unsigned fw[kFlagWords];
  const int64_t t0 = (int64_t)blockIdx.x * kTile;
  const int64_t len = n + sr.length - 1;   // bases of the genome
  // stage: half-word h holds bases t0 + 16h .. + 15
  for (int h0 = 0; h0 < kCodeWords; h0 += kThreads) {
    const int h = h0 + threadIdx.x;
    const int64_t at = t0 + 16 * (int64_t)h;
    if (h < kCodeWords) cw[h] = pack_codes(load16(codes, at, len));
    if (kMasked) {
      const unsigned f = h < kCodeWords ? pack_flags(load16(ambig, at, len))
                                        : 0u;
      const unsigned hi = __shfl_down_sync(0xffffffffu, f, 1);
      if ((h & 1) == 0 && h < kCodeWords) fw[h >> 1] = f | (hi << 16);
    }
  }
  __syncthreads();
  const int wshift = 64 - 2 * sr.weight;
  const unsigned long long wmask = ~0ull >> wshift;
  const unsigned long long lmask = ~0ull >> (64 - sr.length);
  for (int k0 = 0; k0 < kTile / kThreads; k0 += kBatch) {
    // W of kBatch windows: bases p .. p + 31 of the tile, base p in bits
    // 63-62 (past the tile's windows the staged zeros; never stored)
    unsigned long long W[kBatch], fwd[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int p = (k0 + b) * kThreads + threadIdx.x;
      const int wi = p >> 4, r2 = 2 * (p & 15);
      const unsigned long long hi =
          ((unsigned long long)cw[wi] << 32) | cw[wi + 1];
      const unsigned long long lo = (unsigned long long)cw[wi + 2] << 32;
      W[b] = (hi << r2) | ((lo >> 1) >> (63 - r2));
      fwd[b] = 0;
    }
    // a run's shift and mask are read once for the batch
    for (int r = 0; r < sr.n_runs; ++r) {
      const int sh = sr.shift[r];
      const unsigned long long m = sr.mask[r];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) fwd[b] |= (W[b] >> sh) & m;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int p = (k0 + b) * kThreads + threadIdx.x;
      const int64_t i = t0 + p;
      const unsigned long long rc =
          pairswap(__brevll(fwd[b] ^ wmask)) >> wshift;
      const unsigned long long x = fwd[b] << 1;
      const unsigned long long y = (rc << 1) | 1ull;
      long long key = (long long)(x < y ? x : y);
      if (kMasked) {
        const int fi = p >> 5;
        const unsigned long long A =
            fw[fi] | ((unsigned long long)fw[fi + 1] << 32);
        if ((A >> (p & 31)) & lmask) key = sentinel;
      }
      if (i < n) __stcs(out + i, key);
    }
  }
}

}  // namespace

// codes: uint8[n + length - 1]; ambig: uint8[n + length - 1] or null;
// runs: HOST SeedRuns (the wrapper's cached table); out: int64[n].
extern "C" int lm_seed_keys(const void* codes, const void* ambig, int64_t n,
                            const void* runs, int64_t sentinel, void* out,
                            void* stream) {
  const SeedRuns& sr = *(const SeedRuns*)runs;
  if (sr.n_runs < 1 || sr.n_runs > kMaxRuns || sr.weight < 1 ||
      sr.length > kHalo || sr.weight > sr.length) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kTile - 1) / kTile);
    cudaStream_t s = (cudaStream_t)stream;
    if (ambig != nullptr) {
      LM_LAUNCH(seed_keys_kernel<true>, blocks, kThreads, 0, s,
                (const uint8_t*)codes, (const uint8_t*)ambig, n, sr,
                (long long)sentinel, (long long*)out);
    } else {
      LM_LAUNCH(seed_keys_kernel<false>, blocks, kThreads, 0, s,
                (const uint8_t*)codes, nullptr, n, sr, (long long)sentinel,
                (long long*)out);
    }
  }
  return (int)cudaGetLastError();
}
