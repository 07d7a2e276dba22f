// K26-K28: the seed-prefix-sharded seeder of parallel/shard.py (dmSML's
// key-prefix binning promoted to devices, ParallelMemHash's fan-out,
// libMems/ParallelMemHash.cpp:42-121).
//
// K26, route fill, replaces libmems_tpu/parallel/shard.py _route_local
// (:208-249) with _bucket_of (:82-94): every row of a shard's slice of the
// position-order key table is sent to the shard that owns its seed content.
// Pass 1, one thread a row: content = key >> 1 (logical), the Fibonacci
// mix content * 0x9E3779B97F4A7C15 mod 2^64, bucket = min(mix >> (64 -
// bits), n_dev - 1); the masked-window sentinel goes to bucket n_dev (never
// sent).  Block histograms of the buckets go to global counts.  A stable
// library sort by bucket follows, so a row's slot in its destination's
// send buffer is its rank in row order (sorted index - bucket start).
// Pass 2, one thread a sorted row: writes the key and the row's index into
// the position-order concatenation (src = base + row) to send[bucket,
// slot] and counts the rows past the capacity C.  Row order inside a
// bucket is the slice's order, so a receiver's rows arrive in ascending
// src, and one stable sort by content orders them as (content, gid, pos).
// Which rows overflow never reaches a result: any drop makes the caller
// retry with a larger C.
//
// K27, shard-local candidate rows, replaces _sharded_find_mums_once
// :363-378: one thread per received row scatters sign * (pos + 1) of each
// kept occurrence (K13's kept_occ, row_id, ref_strand) into starts[row_id,
// gid] of a zeroed [R + 1, G] table, R = min(n_rows, capacity), rows past
// R to the dump row R; (row, gid) is unique among kept rows, so no atomics.
// Pass 2, one thread per (row, genome) of the R rows: present, lefts =
// |start| - 1 and is_fwd, K2's extension rows.
//
// K28, dedup flags, replaces :384-396: pass 1 forms out_starts = sign *
// (lefts + 1) where present; a library lexsort orders the rows by the G
// starts, the length and ~valid; pass 2, one thread a sorted row, gathers
// it and flags it unique when it is valid and differs from the previous
// sorted row in a start or the length.
//
// Bound: memory traffic.  Each pass reads and writes a few int32/int64
// columns once, coalesced except the scatters (K26's send buffers are
// written bucket by bucket in row order, K27's table at random rows); the
// sorts between the passes stay library calls and cost more than the
// passes.
#include "common.cuh"

namespace {

constexpr int kThreads = lm::kTableThreads;
constexpr int kMaxBins = 1024;  // n_dev + 1 histogram bins in shared memory
using lm::blocks_for;
using lm::first_index;
using lm::grid_stride;

__device__ __forceinline__ int route_bucket(int64_t key, int64_t sentinel,
                                            int bits, int n_dev) {
  if (key == sentinel) return n_dev;
  const uint64_t content = (uint64_t)key >> 1;
  const uint64_t mixed = content * 0x9E3779B97F4A7C15ull;
  const int b = (int)(mixed >> (64 - bits));
  return b < n_dev - 1 ? b : n_dev - 1;
}

__global__ void route_bucket_kernel(const int64_t* __restrict__ keys,
                                    int64_t n, int64_t sentinel, int bits,
                                    int n_dev, int* __restrict__ bucket,
                                    unsigned long long* __restrict__ counts) {
  __shared__ unsigned int hist[kMaxBins];
  for (int b = threadIdx.x; b <= n_dev; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const int b = route_bucket(keys[i], sentinel, bits, n_dev);
    bucket[i] = b;
    atomicAdd(&hist[b], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b <= n_dev; b += blockDim.x) {
    if (hist[b]) atomicAdd(&counts[b], (unsigned long long)hist[b]);
  }
}

__global__ void route_fill_kernel(const int64_t* __restrict__ keys,
                                  const int* __restrict__ sorted_bucket,
                                  const int64_t* __restrict__ perm,
                                  const int64_t* __restrict__ start,
                                  int64_t n, int64_t base, int n_dev,
                                  int64_t cap, int64_t* __restrict__ send_k,
                                  int64_t* __restrict__ send_src,
                                  unsigned long long* __restrict__ dropped) {
  for (int64_t j = first_index(); j < n; j += grid_stride()) {
    const int b = sorted_bucket[j];
    if (b >= n_dev) continue;
    const int64_t slot = j - start[b];
    if (slot >= cap) {
      atomicAdd(dropped, 1ull);
      continue;
    }
    const int64_t r = perm[j];
    send_k[(int64_t)b * cap + slot] = keys[r];
    send_src[(int64_t)b * cap + slot] = base + r;
  }
}

__global__ void cand_scatter_kernel(const unsigned char* __restrict__ kept_occ,
                                    const int* __restrict__ row_id,
                                    const int* __restrict__ gid,
                                    const int* __restrict__ pos,
                                    const unsigned char* __restrict__ strand,
                                    const unsigned char* __restrict__ ref_st,
                                    int64_t n, int64_t rows, int G,
                                    int* __restrict__ starts) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    if (!kept_occ[i]) continue;
    const int64_t r = row_id[i] < rows ? (int64_t)row_id[i] : rows;
    const int sign = strand[i] == ref_st[i] ? 1 : -1;
    starts[r * G + gid[i]] = sign * (pos[i] + 1);
  }
}

__global__ void cand_rows_kernel(const int* __restrict__ starts, int64_t cells,
                                 int* __restrict__ lefts,
                                 unsigned char* __restrict__ present,
                                 unsigned char* __restrict__ is_fwd) {
  for (int64_t c = first_index(); c < cells; c += grid_stride()) {
    const int s = starts[c];
    present[c] = s != 0;
    lefts[c] = s > 0 ? s - 1 : (s < 0 ? -s - 1 : 0);
    is_fwd[c] = s > 0;
  }
}

__global__ void dedup_starts_kernel(const int* __restrict__ lefts,
                                    const unsigned char* __restrict__ present,
                                    const unsigned char* __restrict__ is_fwd,
                                    int64_t cells, int* __restrict__ out) {
  for (int64_t c = first_index(); c < cells; c += grid_stride()) {
    const int v = lefts[c] + 1;
    out[c] = present[c] ? (is_fwd[c] ? v : -v) : 0;
  }
}

__global__ void dedup_flags_kernel(const int* __restrict__ starts,
                                   const int* __restrict__ lengths,
                                   const unsigned char* __restrict__ valid,
                                   const int64_t* __restrict__ order,
                                   int64_t m, int G, int* __restrict__ srows,
                                   int* __restrict__ slens,
                                   unsigned char* __restrict__ uniq) {
  for (int64_t i = first_index(); i < m; i += grid_stride()) {
    const int64_t r = order[i];
    const int* row = starts + r * G;
    bool first = i == 0;
    const int64_t p = i > 0 ? order[i - 1] : r;
    const int* prev = starts + p * G;
    for (int g = 0; g < G; ++g) {
      srows[i * G + g] = row[g];
      first |= row[g] != prev[g];
    }
    slens[i] = lengths[r];
    first |= lengths[r] != lengths[p];
    uniq[i] = valid[r] && first;
  }
}

}  // namespace

// K26 pass 1: keys int64[n]; bucket int32[n]; counts uint64[n_dev + 1],
// zeroed by the caller.
extern "C" int lm_route_buckets(const void* keys, int64_t n, int64_t sentinel,
                                int bits, int n_dev, void* bucket,
                                void* counts, void* stream) {
  if (n_dev < 1 || n_dev + 1 > kMaxBins || bits < 1 || bits > 31)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    LM_LAUNCH(route_bucket_kernel, blocks_for(n), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)keys, n, sentinel, bits,
              n_dev, (int*)bucket, (unsigned long long*)counts);
  }
  return (int)cudaGetLastError();
}

// K26 pass 2, after the stable sort by bucket: sorted_bucket int32[n],
// perm int64[n] (the sort's source rows), start int64[n_dev + 1] (each
// bucket's first sorted index); send_k, send_src int64[n_dev, cap], filled
// with the sentinel and 0 by the caller; dropped uint64[1], zeroed.
extern "C" int lm_route_fill(const void* keys, const void* sorted_bucket,
                             const void* perm, const void* start, int64_t n,
                             int64_t base, int n_dev, int64_t cap,
                             void* send_k, void* send_src, void* dropped,
                             void* stream) {
  if (n > 0) {
    LM_LAUNCH(route_fill_kernel, blocks_for(n), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)keys,
              (const int*)sorted_bucket, (const int64_t*)perm,
              (const int64_t*)start, n, base, n_dev, cap, (int64_t*)send_k,
              (int64_t*)send_src, (unsigned long long*)dropped);
  }
  return (int)cudaGetLastError();
}

// K27: K13's flags of n received rows; starts int32[rows + 1, G] zeroed by
// the caller (row `rows` is the dump row); lefts int32[rows, G], present
// and is_fwd uint8[rows, G].
extern "C" int lm_shard_candidates(const void* kept_occ, const void* row_id,
                                   const void* gid, const void* pos,
                                   const void* strand, const void* ref_strand,
                                   int64_t n, int64_t rows, int G,
                                   void* starts, void* lefts, void* present,
                                   void* is_fwd, void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    LM_LAUNCH(cand_scatter_kernel, blocks_for(n), kThreads, 0, s,
              (const unsigned char*)kept_occ, (const int*)row_id,
              (const int*)gid, (const int*)pos, (const unsigned char*)strand,
              (const unsigned char*)ref_strand, n, rows, G, (int*)starts);
  }
  const int64_t cells = rows * G;
  if (cells > 0) {
    LM_LAUNCH(cand_rows_kernel, blocks_for(cells), kThreads, 0, s,
              (const int*)starts, cells, (int*)lefts,
              (unsigned char*)present, (unsigned char*)is_fwd);
  }
  return (int)cudaGetLastError();
}

// K28 pass 1: lefts int32[m, G], present and is_fwd uint8[m, G] -> signed
// 1-based starts int32[m, G].
extern "C" int lm_dedup_starts(const void* lefts, const void* present,
                               const void* is_fwd, int64_t m, int G,
                               void* out, void* stream) {
  const int64_t cells = m * G;
  if (cells > 0) {
    LM_LAUNCH(dedup_starts_kernel, blocks_for(cells), kThreads, 0,
              (cudaStream_t)stream, (const int*)lefts,
              (const unsigned char*)present, (const unsigned char*)is_fwd,
              cells, (int*)out);
  }
  return (int)cudaGetLastError();
}

// K28 pass 2, after the lexsort: starts int32[m, G], lengths int32[m],
// valid uint8[m], order int64[m]; srows int32[m, G], slens int32[m], uniq
// uint8[m] in sorted order.
extern "C" int lm_dedup_flags(const void* starts, const void* lengths,
                              const void* valid, const void* order,
                              int64_t m, int G, void* srows, void* slens,
                              void* uniq, void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    LM_LAUNCH(dedup_flags_kernel, blocks_for(m), kThreads, 0,
              (cudaStream_t)stream, (const int*)starts, (const int*)lengths,
              (const unsigned char*)valid, (const int64_t*)order, m, G,
              (int*)srows, (int*)slens, (unsigned char*)uniq);
  }
  return (int)cudaGetLastError();
}
