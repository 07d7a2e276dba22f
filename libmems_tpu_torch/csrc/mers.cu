// K1: canonical spaced-seed keys, one thread per seed window.
//
// Replaces libmems_tpu/ops/mers.py _canonical_seed_keys_jit and
// _canonical_seed_keys_masked_jit (XLA: `weight` strided slices summed
// into forward and reverse-complement words, plus a cumsum window test
// for ambiguous bases).
//
// Bound: memory.  A window reads `weight` code bytes and at most
// `length` (<= ~31) ambiguity bytes and writes one 8-byte key; the
// neighbouring threads of a warp read overlapping bytes, so the reads are
// served from L1 and the kernel moves about 9-10 bytes of device memory
// per window.  Design: no shared memory and no cumsum pass; the
// ambiguity test is a direct loop over the window, which is cheaper than
// a separate prefix-sum launch at these widths.
//
// Keys are int64: min(fwd << 1, rc << 1 | 1) has 2*weight+1 <= 63 bits.
// A window touching an ambiguous base gets `sentinel`, the all-ones
// value of the JAX key width (0xFFFFFFFF for u32 keys, -1 for u64).
#include "common.cuh"

namespace {

constexpr int kMaxWeight = 64;

struct SeedOffsets {
  int off[kMaxWeight];
};

__global__ void seed_keys_kernel(const uint8_t* __restrict__ codes,
                                 const uint8_t* __restrict__ ambig,
                                 int64_t n, SeedOffsets so, int weight,
                                 int length, long long sentinel,
                                 long long* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long fwd = 0ull, rc = 0ull;
  for (int j = 0; j < weight; ++j) {
    const unsigned long long ch = codes[i + so.off[j]];
    fwd |= ch << (2 * (weight - 1 - j));
    rc |= (3ull - ch) << (2 * j);
  }
  const unsigned long long a = fwd << 1;
  const unsigned long long b = (rc << 1) | 1ull;
  long long key = (long long)(a < b ? a : b);
  if (ambig != nullptr) {
    for (int k = 0; k < length; ++k) {
      if (ambig[i + k]) {
        key = sentinel;
        break;
      }
    }
  }
  out[i] = key;
}

}  // namespace

// codes: uint8[n + length - 1]; ambig: uint8[n + length - 1] or null;
// offsets: HOST int[weight]; out: int64[n].
extern "C" int lm_seed_keys(const void* codes, const void* ambig, int64_t n,
                            const int* offsets, int weight, int length,
                            int64_t sentinel, void* out, void* stream) {
  if (weight < 1 || weight > kMaxWeight) return (int)cudaErrorInvalidValue;
  SeedOffsets so;
  for (int j = 0; j < weight; ++j) so.off[j] = offsets[j];
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    LM_LAUNCH(seed_keys_kernel, blocks, threads, 0, (cudaStream_t)stream,
              (const uint8_t*)codes, (const uint8_t*)ambig, n, so, weight,
              length, (long long)sentinel, (long long*)out);
  }
  return (int)cudaGetLastError();
}
