// K16-K17: the seed occurrence list of one genome (SeedOccurrenceList::
// construct + smoothFrequencies, libMems/SeedOccurrenceList.h:22-92).
//
// K16, run counts, replaces the first half of libmems_tpu/anchorscore.py
// _seed_occurrence_device (:46-59): over the SML's sorted keys, the length
// of each row's run of equal content (key >> 1), 1 for the masked-window
// sentinel key, written to the row's window position.  The JAX payload
// sort to position order is a scatter here: the sorted positions are a
// permutation of the windows, so every slot is written exactly once.
// Positions past the last window (the seed_len - 1 tail of a linear
// genome) get 1.
//
// K16 runs in two launches over tiles of kSeedTile sorted rows, with no
// cumsum and no O(n) scratch.  A run starts at row 0 and wherever the
// content differs from the row before.
//   1. seed_tile_edges_kernel: one warp a tile writes the tile's first
//      and last run start (or -1), comparing 32 rows, then 256 a step,
//      inward from each edge and stopping at the first start; typical
//      runs are a few rows, so a tile reads a few hundred bytes.
//   2. seed_run_counts_kernel: one block a tile loads its keys and
//      positions once, coalesced and evict-first (__ldcs: the scattered
//      counts' lines then stay in L2, 0.30 -> 0.21 ms at 8.7 M rows on an
//      H100), and forms the run-start flags as one ballot word a warp
//      step.  Each row's run start is the nearest set
//      flag at or before it, its end the nearest one after it: bit scans
//      of the ballot words inside a warp, the warps' first and last starts
//      through shared memory across the block.  A run crossing the tile's
//      left edge takes its start from the nearest earlier tile whose
//      summary holds one, a run crossing the right edge its end from the
//      nearest later one (or n): one warp reads 128 summaries a step
//      (runs.cuh's walk_summaries).
//   Every summary is written before launch 2 starts, so no block waits on
//   another, and no thread walks a run's rows: a run of R rows (a poly-A
//   run, the sentinel run of N-masked windows) costs each tile it spans
//   O(R / kSeedTile / 128) steps over summaries.
//
// K17, smoothing, replaces the second half (:61-86): the trailing mean of
// the counts over seed_len positions, positions left of 0 counting 1, the
// genome's last position keeping its raw count, floor 1.  Each thread
// loads its kSmoothItems counts into registers with 16-byte loads; a
// block stages its tile of counts and the seed_len positions before it
// (up to kSmoothHalo of them; the rest of a longer window is read from
// device memory) in shared memory, the window sum before the tile is a
// block reduction, each thread's offset inside the tile a block scan of
// its positions' differences count[p] - count[p - seed_len], and the
// thread then slides the sum over its positions.  Blocks loop over
// tiles, as many as the card holds at once.  Every
// sum is exact int64 arithmetic (equal to the JAX int64 cumsum
// difference); the float is one __ll2float_rn and one __fdiv_rn, so the
// result is the bits of `float32(sum) / float32(seed_len)` and the
// compiler cannot turn the division into a reciprocal multiply.
//
// Bound: memory traffic.  K16 reads 12 bytes a row and writes 4 by a
// scatter (the tile summaries are 8 bytes per 4,096 rows); its random
// 4-byte writes reach memory as sectors and set its floor.  K17 reads
// each count from device memory about once a block and writes 4 bytes a
// position.
#include "common.cuh"
#include "runs.cuh"

namespace {

constexpr int kThreads = lm::kTableThreads;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// K16: rows a lane takes in launch 2, rows a tile (runs.cuh's).
constexpr int kRowsPerLane = lm::kRunRowsPerLane;
constexpr int kWarpRows = lm::kRunWarpRows;
constexpr int64_t kSeedTile = lm::kRunTile;

// K17: positions a thread slides over, positions a tile, and the most
// window positions before a tile that a block stages.
constexpr int kSmoothItems = 8;
constexpr int64_t kSmoothTile = (int64_t)kThreads * kSmoothItems;
constexpr int64_t kSmoothHalo = 4096;

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint64_t content_of(int64_t key) {
  return (uint64_t)key >> 1;
}

// K16 launch 1: edges[t] the first and edges[tiles + t] the last run
// start of tile t (rows [t * kSeedTile, +kSeedTile) of n), -1 where the
// tile holds none.  One warp a tile.
__global__ void __launch_bounds__(kThreads)
    seed_tile_edges_kernel(const int64_t* __restrict__ keys, int64_t n,
                           int64_t tiles, int* __restrict__ edges) {
  const int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tiles) return;
  const int64_t a = t * kSeedTile;
  const lm::TileEdges e =
      lm::tile_edges(lm::KeyRows{keys}, a, min64(a + kSeedTile, n));
  if ((threadIdx.x & 31) == 0) {
    edges[t] = (int)e.first;
    edges[tiles + t] = (int)e.last;
  }
}

// K16 launch 2: count[pos[i]] = the length of row i's run (1 for the
// sentinel key) for the rows of tile blockIdx.x, and count[j] = 1 for the
// positions j in [n, length) of the block's share of them.  Warp w of a
// tile takes rows [w * kWarpRows, +kWarpRows), lane l row 32 s + l of
// them at step s.
__global__ void __launch_bounds__(kThreads)
    seed_run_counts_kernel(const int64_t* __restrict__ keys,
                           const int* __restrict__ pos,
                           const int* __restrict__ edges, int64_t n,
                           int64_t tiles, int64_t length, int64_t sentinel,
                           int* __restrict__ count) {
  __shared__ int64_t warp_first[kWarps], warp_last[kWarps], carry[2];
  const int64_t t = blockIdx.x;
  const int64_t tail_hi = min64(length, n + (t + 1) * kSeedTile);
  for (int64_t j = n + t * kSeedTile + threadIdx.x; j < tail_hi;
       j += kThreads) {
    count[j] = 1;
  }
  if (t >= tiles) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t a = t * kSeedTile;
  const int64_t b = min64(a + kSeedTile, n);
  const int64_t w0 = a + warp * kWarpRows;

  int64_t key[kRowsPerLane];
  int p[kRowsPerLane];
#pragma unroll
  for (int s = 0; s < kRowsPerLane; ++s) {
    const int64_t i = w0 + s * 32 + lane;
    key[s] = i < b ? (int64_t)__ldcs((const long long*)keys + i) : 0;
  }
  const int64_t before = lane == 0 && w0 > 0 && w0 < b ? keys[w0 - 1] : 0;
#pragma unroll
  for (int s = 0; s < kRowsPerLane; ++s) {
    const int64_t i = w0 + s * 32 + lane;
    p[s] = i < b ? __ldcs(pos + i) : 0;
  }
  // run-start flags, one ballot word a step; the lane's sentinel rows
  unsigned mask[kRowsPerLane];
  unsigned sent = 0;
#pragma unroll
  for (int s = 0; s < kRowsPerLane; ++s) {
    const int64_t i = w0 + s * 32 + lane;
    int64_t prev = __shfl_up_sync(kFull, key[s], 1);
    const int64_t prev_step = __shfl_sync(kFull, key[s > 0 ? s - 1 : 0], 31);
    if (lane == 0) prev = s > 0 ? prev_step : before;
    const bool valid = i < b;
    mask[s] = __ballot_sync(
        kFull, valid && (i == 0 || content_of(key[s]) != content_of(prev)));
    if (valid && key[s] == sentinel) sent |= 1u << s;
  }
  int64_t wf = -1, wl = -1;
#pragma unroll
  for (int s = kRowsPerLane - 1; s >= 0; --s) {
    if (mask[s]) wf = w0 + s * 32 + __ffs(mask[s]) - 1;
  }
#pragma unroll
  for (int s = 0; s < kRowsPerLane; ++s) {
    if (mask[s]) wl = w0 + s * 32 + 31 - __clz(mask[s]);
  }
  if (lane == 0) {
    warp_first[warp] = wf;
    warp_last[warp] = wl;
  }
  // the run across the tile's left edge starts in the nearest earlier
  // tile with a start (row 0 starts a run, so one exists when the tile's
  // first row does not start one); the run across its right edge ends at
  // the nearest later tile's first start, or n
  if (warp == 0) {
    const int64_t left =
        mask[0] & 1u ? -1
                     : lm::walk_summaries(edges + tiles, t, tiles, -1).at;
    if (lane == 0) carry[0] = left;
  } else if (warp == 1) {
    const int64_t right = lm::walk_summaries(edges, t, tiles, 1).at;
    if (lane == 0) carry[1] = right >= 0 ? right : n;
  }
  __syncthreads();
  int64_t start_in = carry[0];
  int64_t end_in = carry[1];
  for (int w = 0; w < warp; ++w) start_in = max64(start_in, warp_last[w]);
  for (int w = kWarps - 1; w > warp; --w) {
    if (warp_first[w] >= 0) end_in = warp_first[w];
  }

  // forward: each row's run start (tile-relative); backward: its end,
  // then the scatter
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
  int start[kRowsPerLane];
  int64_t c = start_in;
#pragma unroll
  for (int s = 0; s < kRowsPerLane; ++s) {
    const int64_t r0 = w0 + s * 32;
    const unsigned m = mask[s];
    const unsigned at_or_before = m & upto;
    start[s] = (int)((at_or_before ? r0 + 31 - __clz(at_or_before) : c) - a);
    if (m) c = r0 + 31 - __clz(m);
  }
  c = end_in;
#pragma unroll
  for (int s = kRowsPerLane - 1; s >= 0; --s) {
    const int64_t r0 = w0 + s * 32;
    const unsigned m = mask[s];
    const unsigned after = m & ~upto;
    const int64_t end = after ? r0 + __ffs(after) - 1 : c;
    if (m) c = r0 + __ffs(m) - 1;
    if (r0 + lane < b) {
      count[p[s]] = (sent >> s) & 1u ? 1 : (int)(end - (a + start[s]));
    }
  }
}

__device__ __forceinline__ int64_t padded(int64_t k) {
  // one pad word every kSmoothItems: a thread's run of positions starts
  // kSmoothItems + 1 words after its neighbour's, so the 32 lanes hit 32
  // banks
  return k + k / kSmoothItems;
}

// K17: out[i] = max(1, float(sum of count[i-seed_len+1 .. i]) / seed_len),
// entries left of 0 counted as 1; the last position keeps its raw count;
// length <= 1 or seed_len == 0 passes the counts through.  A block takes
// tiles blockIdx.x, + gridDim.x, ...: positions [tile * kSmoothTile,
// +kSmoothTile), thread x the kSmoothItems from tile * kSmoothTile + x *
// kSmoothItems, which it loads into registers; s_dyn stages positions
// [tile * kSmoothTile - halo, min(+kSmoothTile, length)), halo a multiple
// of kSmoothItems.  vec: count and out are 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
    seed_smooth_kernel(const int* __restrict__ count, int64_t length,
                       int seed_len, int64_t halo, bool vec,
                       float* __restrict__ out) {
  extern __shared__ int s_dyn[];
  __shared__ long long scan_tmp[lm::kScanTmp];
  const bool smooth = length > 1 && seed_len > 0;
  for (int64_t tile = blockIdx.x; tile * kSmoothTile < length;
       tile += gridDim.x) {
    const int64_t base = tile * kSmoothTile;
    const int64_t p0 = base + (int64_t)threadIdx.x * kSmoothItems;
    const int64_t lo = base - halo;
    int c[kSmoothItems];
    if (vec && p0 + kSmoothItems <= length) {
#pragma unroll
      for (int k = 0; k < kSmoothItems; k += 4) {
        const int4 x = *reinterpret_cast<const int4*>(count + p0 + k);
        c[k] = x.x;
        c[k + 1] = x.y;
        c[k + 2] = x.z;
        c[k + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSmoothItems; ++k) {
        c[k] = p0 + k < length ? count[p0 + k] : 0;
      }
    }
    float o[kSmoothItems];
    if (!smooth) {
#pragma unroll
      for (int k = 0; k < kSmoothItems; ++k) {
        o[k] = fmaxf(__int2float_rn(c[k]), 1.0f);
      }
    } else {
      // stage the halo and the tile; the previous tile's reads of s_dyn
      // all came before its block scans' closing barriers
      for (int64_t q = threadIdx.x; 4 * q < halo; q += kThreads) {
        const int64_t g = lo + 4 * q;  // lo and 0 are multiples of 4
        int v[4];
        if (vec && g >= 0) {
          const int4 x = *reinterpret_cast<const int4*>(count + g);
          v[0] = x.x;
          v[1] = x.y;
          v[2] = x.z;
          v[3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = g + e < 0 ? 1 : count[g + e];
        }
        const int64_t k = padded(4 * q);  // 4 q .. 4 q + 3 share a group
#pragma unroll
        for (int e = 0; e < 4; ++e) s_dyn[k + e] = v[e];
      }
#pragma unroll
      for (int k = 0; k < kSmoothItems; ++k) s_dyn[padded(p0 - lo + k)] = c[k];
      __syncthreads();
      // count at position g < length: 1 left of 0, staged from lo on,
      // else (a window longer than the halo) from device memory
      auto at = [&](int64_t g) -> long long {
        if (g < 0) return 1;
        if (g >= lo) return s_dyn[padded(g - lo)];
        return count[g];
      };
      // the window sum ending just before the tile: its positions left
      // of 0 counted at once
      long long part = 0;
      int64_t from = base - seed_len;
      if (from < 0) {
        if (threadIdx.x == 0) part = -from;
        from = 0;
      }
      for (int64_t g = from + threadIdx.x; g < base; g += kThreads) {
        part += at(g);
      }
      long long d[kSmoothItems];
      long long dsum = 0;
#pragma unroll
      for (int k = 0; k < kSmoothItems; ++k) {
        const int64_t p = p0 + k;
        d[k] = p < length ? c[k] - at(p - seed_len) : 0;
        dsum += d[k];
      }
      const long long before_tile =
          lm::block_scan(part, 0LL, lm::SumOp(), scan_tmp).total;
      long long sum =
          before_tile + lm::block_scan(dsum, 0LL, lm::SumOp(), scan_tmp).excl;
      const float divisor = (float)seed_len;
#pragma unroll
      for (int k = 0; k < kSmoothItems; ++k) {
        sum += d[k];
        const float v = p0 + k == length - 1
                            ? __int2float_rn(c[k])
                            : __fdiv_rn(__ll2float_rn(sum), divisor);
        o[k] = fmaxf(v, 1.0f);
      }
    }
    if (vec && p0 + kSmoothItems <= length) {
      float4* dst = reinterpret_cast<float4*>(out + p0);
#pragma unroll
      for (int k = 0; k < kSmoothItems / 4; ++k) {
        dst[k] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2],
                             o[4 * k + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSmoothItems; ++k) {
        if (p0 + k < length) out[p0 + k] = o[k];
      }
    }
  }
}

inline int64_t seed_tiles(int64_t n) {
  return (n + kSeedTile - 1) / kSeedTile;
}

}  // namespace

// K16 launch 1.  keys: int64[n] sorted keys; edges: int32[2 * tiles],
// tiles = ceil(n / 4096) (any other count is refused).
extern "C" int lm_seed_tile_edges(const void* keys, int64_t n, int64_t tiles,
                                  void* edges, void* stream) {
  if (n < 0 || tiles != seed_tiles(n)) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    LM_LAUNCH(seed_tile_edges_kernel, (unsigned)((tiles + kWarps - 1) / kWarps),
              kThreads, 0, (cudaStream_t)stream, (const int64_t*)keys, n,
              tiles, (int*)edges);
  }
  return (int)cudaGetLastError();
}

// K16 launch 2.  pos: int32[n] the sorted rows' window positions; edges:
// launch 1's summaries; count: int32[length], length >= n.
extern "C" int lm_seed_run_counts(const void* keys, const void* pos,
                                  const void* edges, int64_t n, int64_t tiles,
                                  int64_t length, int64_t sentinel,
                                  void* count, void* stream) {
  if (n < 0 || length < n || tiles != seed_tiles(n)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t grid = max64(tiles, seed_tiles(length - n));
  if (grid > 0) {
    LM_LAUNCH(seed_run_counts_kernel, (unsigned)grid, kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)keys, (const int*)pos,
              (const int*)edges, n, tiles, length, sentinel, (int*)count);
  }
  return (int)cudaGetLastError();
}

// K17: count int32[length] -> out float32[length].
extern "C" int lm_seed_smooth(const void* count, int64_t length, int seed_len,
                              void* out, void* stream) {
  if (length > 0) {
    // the window positions staged before a tile, a multiple of
    // kSmoothItems (so the threads' runs start a pad group each)
    const int64_t halo =
        seed_len > 0 ? min64(((int64_t)seed_len + kSmoothItems - 1) /
                                 kSmoothItems * kSmoothItems,
                             kSmoothHalo)
                     : 0;
    const int64_t words = halo + kSmoothTile;
    const size_t smem =
        (size_t)(words + words / kSmoothItems + 1) * sizeof(int);
    const bool vec = ((uintptr_t)count % 16 == 0) && ((uintptr_t)out % 16 == 0);
    // as many blocks as the card holds at once, each looping over tiles
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seed_smooth_kernel,
                                                  kThreads, smem);
    const int64_t tiles = (length + kSmoothTile - 1) / kSmoothTile;
    LM_LAUNCH(seed_smooth_kernel,
              (unsigned)min64(tiles, max64((int64_t)sms * per_sm, 1)),
              kThreads, smem, (cudaStream_t)stream, (const int*)count,
              length, seed_len, halo, vec, (float*)out);
  }
  return (int)cudaGetLastError();
}
