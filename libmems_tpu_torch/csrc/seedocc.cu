// K16-K17: the seed occurrence list of one genome (SeedOccurrenceList::
// construct + smoothFrequencies, libMems/SeedOccurrenceList.h:22-92).
//
// K16, run counts, replaces the first half of libmems_tpu/anchorscore.py
// _seed_occurrence_device (:46-59): over the SML's sorted keys, the length
// of each row's run of equal content (key >> 1), 1 for the masked-window
// sentinel key, written to the row's window position.  The JAX payload
// sort to position order is a scatter here: the sorted positions are a
// permutation of the windows, so every slot is written exactly once.  No
// thread walks a run (a poly-A run or the sentinel run of N-masked windows
// can hold millions of rows): run-start flags -> cumsum (torch) -> a
// scatter of the run starts to their run id -> a difference, as K5 does.
// Positions past the last window (the seed_len - 1 tail of a linear
// genome) get 1.
//
// K17, smoothing, replaces the second half (:61-86): the trailing mean of
// the counts over seed_len positions, positions left of 0 counting 1, the
// genome's last position keeping its raw count, floor 1.  The window sum
// is an exact int64 sum of seed_len int32 counts (equal to the JAX int64
// cumsum difference); the float is one __ll2float_rn and one __fdiv_rn, so
// the result is the bits of `float32(sum) / float32(seed_len)` and the
// compiler cannot turn the division into a reciprocal multiply.
//
// Bound: memory traffic.  K16 reads 12 bytes a row and writes 4, with one
// 4-byte scatter; K17 reads each count once from device memory (the
// seed_len-wide window of neighbouring threads overlaps in L1/L2) and
// writes 4 bytes a position.
#include "common.cuh"

namespace {

constexpr int kThreads = lm::kTableThreads;
using lm::blocks_for;
using lm::first_index;
using lm::grid_stride;

__device__ __forceinline__ uint64_t content_of(int64_t key) {
  return (uint64_t)key >> 1;
}

// K16 pass 1: run-start flag of each sorted row.
__global__ void seed_run_start_kernel(const int64_t* __restrict__ keys,
                                      int64_t n, int* __restrict__ sc) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    sc[i] = (i == 0 || content_of(keys[i]) != content_of(keys[i - 1])) ? 1 : 0;
  }
}

// K16 pass 2: run r starts at run_start[r]; run_start[n_runs] = n.  rid1
// is the inclusive cumsum of the run-start flags.
__global__ void seed_run_bounds_kernel(const int* __restrict__ sc,
                                       const int* __restrict__ rid1, int64_t n,
                                       int64_t* __restrict__ run_start) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    if (sc[i]) run_start[rid1[i] - 1] = i;
    if (i == n - 1) run_start[rid1[i]] = n;
  }
}

// K16 pass 3: count[pos[i]] = run length of row i (1 for the sentinel
// key); count[j] = 1 for the positions j >= n that hold no window.
__global__ void seed_run_counts_kernel(const int64_t* __restrict__ keys,
                                       const int* __restrict__ pos,
                                       const int* __restrict__ rid1,
                                       const int64_t* __restrict__ run_start,
                                       int64_t n, int64_t length,
                                       int64_t sentinel,
                                       int* __restrict__ count) {
  for (int64_t i = first_index(); i < length; i += grid_stride()) {
    if (i >= n) {
      count[i] = 1;
      continue;
    }
    const int r = rid1[i] - 1;
    const int64_t runlen = run_start[r + 1] - run_start[r];
    count[pos[i]] = keys[i] == sentinel ? 1 : (int)runlen;
  }
}

// K17: out[i] = max(1, float(sum of count[i-seed_len+1 .. i]) / seed_len),
// entries left of 0 counted as 1; the last position keeps its raw count;
// length <= 1 or seed_len == 0 passes the counts through.
__global__ void seed_smooth_kernel(const int* __restrict__ count,
                                   int64_t length, int seed_len,
                                   float* __restrict__ out) {
  const bool smooth = length > 1 && seed_len > 0;
  const float divisor = (float)seed_len;
  for (int64_t i = first_index(); i < length; i += grid_stride()) {
    float v;
    if (!smooth || i == length - 1) {
      v = __int2float_rn(count[i]);
    } else {
      int64_t sum = 0;
      for (int64_t j = i - seed_len + 1; j <= i; ++j) {
        sum += j < 0 ? 1 : (int64_t)count[j];
      }
      v = __fdiv_rn(__ll2float_rn(sum), divisor);
    }
    out[i] = fmaxf(v, 1.0f);
  }
}

}  // namespace

// K16, before the cumsum of sc.  keys: int64[n] sorted keys; sc: int32[n].
extern "C" int lm_seed_run_starts(const void* keys, int64_t n, void* sc,
                                  void* stream) {
  if (n > 0) {
    LM_LAUNCH(seed_run_start_kernel, blocks_for(n), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)keys, n, (int*)sc);
  }
  return (int)cudaGetLastError();
}

// K16, after the cumsum: pos int32[n] the sorted rows' window positions;
// rid1 int32[n] inclusive cumsum of sc; run_start int64[n+1] scratch;
// count int32[length], length >= n.
extern "C" int lm_seed_run_counts(const void* keys, const void* pos,
                                  const void* sc, const void* rid1,
                                  void* run_start, int64_t n, int64_t length,
                                  int64_t sentinel, void* count,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    LM_LAUNCH(seed_run_bounds_kernel, blocks_for(n), kThreads, 0, s,
              (const int*)sc, (const int*)rid1, n, (int64_t*)run_start);
  }
  if (length > 0) {
    LM_LAUNCH(seed_run_counts_kernel, blocks_for(length), kThreads, 0, s,
              (const int64_t*)keys, (const int*)pos, (const int*)rid1,
              (const int64_t*)run_start, n, length, sentinel, (int*)count);
  }
  return (int)cudaGetLastError();
}

// K17: count int32[length] -> out float32[length].
extern "C" int lm_seed_smooth(const void* count, int64_t length, int seed_len,
                              void* out, void* stream) {
  if (length > 0) {
    LM_LAUNCH(seed_smooth_kernel, blocks_for(length), kThreads, 0,
              (cudaStream_t)stream, (const int*)count, length, seed_len,
              (float*)out);
  }
  return (int)cudaGetLastError();
}
