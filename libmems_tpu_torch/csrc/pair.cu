// K18-K19: the pair fast path of find_mums (G = 2, unique MUMs), the
// passes of libmems_tpu/matchfind.py _fused_pair_pipeline between its two
// library sorts.
//
// K18, cluster words, replaces :499-543.  Pass 1 packs every window of
// both genomes into one word content | gid | pos | strand (:499-507): a
// streaming pass, two rows a thread through 16-byte loads and stores, the
// genome of each row picked by a pointer select.  The wrapper sorts the
// words (a library sort there too).  Pass 2 takes tiles of kScanTile
// sorted words by ticket (scan.cuh), stages each tile with its halo (one
// row before, two after) in shared memory through 16-byte loads, and
// decides each row's exact-pair flag there (a content run of length two,
// genome 0 then genome 1, not the sentinel content; past the table's end
// the content reads as the all-ones fill and before row 0 as no content
// at all).  The survivors' cluster words fwd | biased diagonal | posA are
// compacted in row order: a ballot a warp, block_offsets and the
// decoupled look-back between tiles.  The last tile's block writes the
// candidate count (scratch word 1), which the wrapper reads once; no
// atomic counts the candidates, and no -1 word is written.
//
// K19, representatives, replaces :546-594 on the sorted cluster words, in
// two kernels around one host read:
//  * K7's scan (repscan.cuh: the same head and posA test on the same word
//    tail): each representative's word index stored in order at its rank
//    (the JAX binary search over the cumsum ranks picks the same words),
//    n_cands and n_reps left in the scan's scratch;
//  * the wrapper reads n_reps;
//  * pair_reps_kernel, one thread a slot j < EC: the representative's
//    extension row K2 takes, both left ends, the strand of genome 1, and a
//    length seeded with the cluster's extent.  A cluster's last member is
//    the word before the next representative's, or at the last valid slot
//    the last candidate (also when n_reps > EC, as the JAX next_src makes
//    it), so no thread walks a cluster.  Slots past min(n_reps, EC) are
//    absent: zero left ends, forward, length seed_len.
//
// Bound: memory traffic.  The pack reads one key and writes one word a
// row (16 bytes), pass 2 reads one sorted word a row and writes one word
// a candidate; K19's scan reads a word a candidate and writes an index a
// representative, its decode writes 14 bytes a slot.  No library cumsum
// runs between the passes; the two sorts beside them cost more.
//
// 64-bit words are int64 holding unsigned patterns (bit 63 is set when
// 2 * weight + 3 + pos_bits reaches 64): shifts go through uint64, and
// the -1 sentinel is all ones.
#include "common.cuh"
#include "repscan.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = lm::kTableThreads;
using lm::blocks_for;
using lm::first_index;
using lm::grid_stride;
using lm::kScanItems;
using lm::kScanThreads;
using lm::kScanTile;
using lm::kWarpSpan;

__device__ __forceinline__ uint64_t pack_word(uint64_t key, uint64_t gid,
                                              uint64_t pos, int pos_bits) {
  return ((key >> 1) << (pos_bits + 2)) | (gid << (pos_bits + 1)) |
         (pos << 1) | (key & 1);
}

// K18 pass 1: words of rows 2t and 2t + 1 (rows [0, na) are genome 0,
// rows [na, na + nb) genome 1).  The output is 16-byte aligned; an input
// pair is one 16-byte load where both rows lie in one genome at an
// aligned address (everywhere when na is even), else two 8-byte loads.
__global__ void pair_pack_kernel(const int64_t* __restrict__ keys_a,
                                 int64_t na,
                                 const int64_t* __restrict__ keys_b,
                                 int64_t nb, int pos_bits,
                                 int64_t* __restrict__ out) {
  const int64_t n = na + nb;
  for (int64_t t = first_index(); 2 * t < n; t += grid_stride()) {
    const int64_t i = 2 * t;
    const bool a0 = i < na, a1 = i + 1 < na;
    const int64_t* p0 = a0 ? keys_a + i : keys_b + (i - na);
    const int64_t* p1 = a1 ? keys_a + i + 1 : keys_b + (i + 1 - na);
    const bool pair = i + 1 < n;
    longlong2 k;
    if (pair && a0 == a1 && ((uintptr_t)p0 & 15) == 0) {
      k = __ldcs((const longlong2*)p0);
    } else {
      k.x = __ldcs((const long long*)p0);
      k.y = pair ? __ldcs((const long long*)p1) : 0;
    }
    const uint64_t pos0 = (uint64_t)(a0 ? i : i - na);
    const uint64_t pos1 = (uint64_t)(a1 ? i + 1 : i + 1 - na);
    longlong2 w;
    w.x = (long long)pack_word((uint64_t)k.x, a0 ? 0 : 1, pos0, pos_bits);
    w.y = (long long)pack_word((uint64_t)k.y, a1 ? 0 : 1, pos1, pos_bits);
    if (pair) {
      __stcs((longlong2*)(out + i), w);
    } else {
      __stcs((long long*)out + i, w.x);
    }
  }
}

// K18 pass 2: the exact-pair flags of one tile of sorted words and the
// survivors' cluster words, compacted in row order.  s[k + 2] holds row
// t0 + k for k in [-1, kScanTile + 2) where the row exists.
__global__ void __launch_bounds__(kScanThreads)
    pair_cluster_words_kernel(const int64_t* __restrict__ w, int64_t n,
                              int pos_bits, int64_t sent_content,
                              int64_t* __restrict__ cw,
                              unsigned long long* __restrict__ scratch) {
  __shared__ __align__(16) uint64_t s[kScanTile + 4];
  const int64_t tile = lm::take_tile(scratch);
  const int64_t t0 = tile * kScanTile;
#pragma unroll
  for (int m = threadIdx.x; m < kScanTile / 2; m += kScanThreads) {
    const int64_t i = t0 + 2 * m;
    longlong2 v = make_longlong2(0, 0);
    if (i + 1 < n) {
      v = __ldcs((const longlong2*)(w + i));
    } else if (i < n) {
      v.x = __ldcs((const long long*)w + i);
    }
    *(longlong2*)(s + 2 + 2 * m) = v;
  }
  if (threadIdx.x < 3) {
    // the halo: row t0 - 1, rows t0 + kScanTile and t0 + kScanTile + 1
    const int64_t i = threadIdx.x == 0 ? t0 - 1 : t0 + kScanTile - 1 +
                                                      threadIdx.x;
    const int k = threadIdx.x == 0 ? 1 : kScanTile + 1 + threadIdx.x;
    s[k] = i >= 0 && i < n ? (uint64_t)w[i] : 0;
  }
  __syncthreads();
  const int cshift = pos_bits + 2;
  const uint64_t cmax = ~(uint64_t)0 >> cshift;
  const uint64_t pmask = ((uint64_t)1 << pos_bits) - 1;
  const int lane = threadIdx.x & 31;
  const int k0 = (threadIdx.x >> 5) * kWarpSpan + lane;
  unsigned ballot[kScanItems];
  unsigned count = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int k = k0 + j * 32;
    const int64_t i = t0 + k;
    bool surv = false;
    if (i < n) {
      const uint64_t w0 = s[k + 2], w1 = s[k + 3];
      const uint64_t c = w0 >> cshift;
      const uint64_t c1 = i + 1 < n ? w1 >> cshift : cmax;
      const uint64_t c2 = i + 2 < n ? s[k + 4] >> cshift : cmax;
      // row 0 has no previous content: nothing equals it
      const bool new_run = i == 0 || (s[k + 1] >> cshift) != c;
      const uint64_t gid = (w0 >> (pos_bits + 1)) & 1;
      const uint64_t g1 = i + 1 < n ? (w1 >> (pos_bits + 1)) & 1 : 0;
      surv = c == c1 && new_run && c1 != c2 && gid == 0 && g1 == 1 &&
             c != (uint64_t)sent_content;
    }
    ballot[j] = __ballot_sync(0xffffffffu, surv);
    count += __popc(ballot[j]);
  }
  unsigned warp_off, total;
  const unsigned long long off =
      lm::block_offsets(scratch, tile, count, &warp_off, &total);
  unsigned long long at = off + warp_off;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if ((ballot[j] >> lane) & 1) {
      // a survivor's next row exists: its flag needs it
      const int k = k0 + j * 32;
      const uint64_t w0 = s[k + 2], w1 = s[k + 3];
      const int64_t pos_a = (int64_t)((w0 >> 1) & pmask);
      const int64_t pos_b = (int64_t)((w1 >> 1) & pmask);
      const bool fwd = (w0 & 1) == (w1 & 1);
      const int64_t delta =
          fwd ? pos_b - pos_a + ((int64_t)1 << pos_bits) : pos_b + pos_a;
      __stcs((long long*)cw + at + __popc(ballot[j] & lm::lanes_below()),
             (long long)(((int64_t)fwd << (2 * pos_bits + 2)) |
                         (delta << pos_bits) | pos_a));
    }
    at += __popc(ballot[j]);
  }
  if (tile == (int64_t)gridDim.x - 1 && threadIdx.x == 0) {
    scratch[1] = off + total;
  }
}

// K19's decode: per slot j < EC the representative's extension row
// (matchfind.py:568-594).  index: the scan's word indices; counts: its
// n_cands and n_reps.  Slots past n_valid = min(n_reps, EC) are absent.
__global__ void pair_reps_kernel(const int64_t* __restrict__ cw,
                                 const int* __restrict__ index,
                                 int64_t n_valid, int64_t ec,
                                 const unsigned long long* __restrict__ counts,
                                 int pos_bits, int seed_len,
                                 int* __restrict__ lefts,
                                 unsigned char* __restrict__ present,
                                 unsigned char* __restrict__ is_fwd,
                                 int* __restrict__ lengths0) {
  const int64_t pmask = ((int64_t)1 << pos_bits) - 1;
  const int64_t bias = (int64_t)1 << pos_bits;
  for (int64_t j = first_index(); j < ec; j += grid_stride()) {
    if (j >= n_valid) {
      lefts[2 * j] = lefts[2 * j + 1] = 0;
      present[2 * j] = present[2 * j + 1] = 0;
      is_fwd[2 * j] = is_fwd[2 * j + 1] = 1;
      lengths0[j] = seed_len;
      continue;
    }
    const int64_t w = cw[index[j]];
    const int64_t end_row =
        (j + 1 < n_valid ? (int64_t)index[j + 1] : (int64_t)counts[0]) - 1;
    const uint64_t uw = (uint64_t)w;
    const int64_t pos_a = w & pmask;
    const int64_t delta =
        (int64_t)((uw >> pos_bits) & (((uint64_t)1 << (pos_bits + 2)) - 1));
    const bool fwd = ((uw >> (2 * pos_bits + 2)) & 1) != 0;
    int64_t last = cw[end_row] & pmask;
    if (last < pos_a) last = pos_a;
    // genome-1 left end of the match that covers the cluster
    int64_t left_b = fwd ? delta - bias + pos_a : delta - last;
    if (left_b < 0) left_b = 0;
    lefts[2 * j] = (int)pos_a;
    lefts[2 * j + 1] = (int)left_b;
    present[2 * j] = present[2 * j + 1] = 1;
    is_fwd[2 * j] = 1;
    is_fwd[2 * j + 1] = fwd ? 1 : 0;
    lengths0[j] = (int)(last - pos_a + seed_len);
  }
}

}  // namespace

// K18, before the sort: keys_a int64[na], keys_b int64[nb] in position
// order; out int64[na + nb].
extern "C" int lm_pair_pack(const void* keys_a, int64_t na, const void* keys_b,
                            int64_t nb, int pos_bits, void* out,
                            void* stream) {
  if (na + nb > 0) {
    LM_LAUNCH(pair_pack_kernel, blocks_for((na + nb + 1) / 2), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)keys_a, na,
              (const int64_t*)keys_b, nb, pos_bits, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

// K18, after the sort: w int64[n] in unsigned order; cw int64[n] (the
// first n_cands are written, in row order); scratch
// int64[lm_scan_scratch_words(n)], word 1 n_cands after the launch.
extern "C" int lm_pair_cluster_words(const void* w, int64_t n, int pos_bits,
                                     int64_t sent_content, void* cw,
                                     void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, lm::scan_scratch_words(n) * sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    LM_LAUNCH(pair_cluster_words_kernel, (unsigned)lm::scan_tiles(n),
              kScanThreads, 0, s, (const int64_t*)w, n, pos_bits,
              sent_content, (int64_t*)cw, (unsigned long long*)scratch);
  }
  return (int)cudaGetLastError();
}

// K19's scan: cw int64[m] sorted (unsigned order, -1 last); index
// int32[m] (the first n_reps are written); scratch
// int64[lm_scan_scratch_words(m)], words 1 and 2 n_cands and n_reps
// after the launch.
extern "C" int lm_pair_rep_index(const void* cw, int64_t m, int pos_bits,
                                 int seed_len, void* index, void* scratch,
                                 void* stream) {
  return lm::launch_rep_index(cw, m, pos_bits, seed_len, index, scratch,
                              (cudaStream_t)stream);
}

// K19's decode: index int32 and counts int64[2] (n_cands, n_reps; scratch
// words 1-2) of the scan; outputs lefts int32[EC, 2], present and is_fwd
// uint8[EC, 2], lengths0 int32[EC].  n_valid = min(n_reps, EC).
extern "C" int lm_pair_reps(const void* cw, const void* index,
                            const void* counts, int64_t n_valid, int64_t ec,
                            int pos_bits, int seed_len, void* lefts,
                            void* present, void* is_fwd, void* lengths0,
                            void* stream) {
  if (ec > 0) {
    LM_LAUNCH(pair_reps_kernel, blocks_for(ec), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)cw, (const int*)index,
              n_valid, ec, (const unsigned long long*)counts, pos_bits,
              seed_len, (int*)lefts, (unsigned char*)present,
              (unsigned char*)is_fwd, (int*)lengths0);
  }
  return (int)cudaGetLastError();
}
