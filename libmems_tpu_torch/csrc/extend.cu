// K2: batched ungapped maximal extension, one thread block per candidate.
//
// Replaces libmems_tpu/ops/extend.py extend_matches (extend_core and
// make_probe_round: XLA probe rounds over every candidate at once inside
// a lax.while_loop, with a ROW_BLOCK lax.map and a 128-lane barrel-shift
// span fetch laid out for the TPU's vector unit).
//
// Bound: latency of dependent probe rounds.  A round reads C contiguous
// keys per genome (C = chunk, then 8*chunk) and reduces them with three
// block scans; a row runs its rounds until its chain stops, so long
// matches cost many rounds while short ones retire after one.  Design:
// one block of 256 threads per row, each thread owning a contiguous run
// of at most 32 probe offsets held as a bitmask, so a round is one pass
// over the keys and four block scans (previous match, first bad gap,
// reach, room left).  Rows never wait for each other: a row's own loop of
// rounds gives exactly the result of the global while_loop, because rows are
// independent and a finished row's state no longer changes there.  The
// TPU-specific ROW_BLOCK map and barrel-shift fetch are not needed.
//
// Match rule per probe offset d (ops/extend.py:241-268): every present
// genome's window key, XORed with its strand flag, equals the reference
// genome's (first present genome); no key is the sentinel; every probe
// position lies in [0, gen_cnt).  Reach and the continue test copy
// ops/extend.py:270-293, including `room + reach > C`.  The round's three
// steps are csrc/probe.cuh's, which K31 shares.
//
// A row's per-genome state (left end, offset, count, presence, strand)
// lives in dynamic shared memory sized 5 * G ints at launch, so a row
// takes any number of genomes: up to about 11,600 in what a block may
// opt into on Hopper (lm_extend_smem_limit), and beyond that in global
// scratch the wrapper allocates
// (5 * G ints a row).  The block's threads load, update and store the
// state together, genome g on thread g mod 256; the reference genome (the
// first present one) and the room left are block-wide min reductions.
#include "common.cuh"
#include "probe.cuh"

namespace {

constexpr int kThreads = 256;

// A probe key from the position-order table: genome g's window q, the
// sentinel outside the table.
struct TableFetch {
  const long long* keys;
  int64_t n_keys;
  long long fill;
  const int* s_off;
  __device__ long long operator()(int g, int q, int, bool) const {
    const int64_t idx = (int64_t)s_off[g] + q;
    return (idx >= 0 && idx < n_keys) ? keys[idx] : fill;
  }
};

__global__ void __launch_bounds__(kThreads) extend_kernel(
    const long long* __restrict__ keys, int64_t n_keys, long long fill,
    int seed_len, int chunk, int big, int G,
    const int* __restrict__ gen_off, const int* __restrict__ gen_cnt,
    int* __restrict__ lefts, const uint8_t* __restrict__ present,
    const uint8_t* __restrict__ is_fwd, int* __restrict__ lengths,
    int* __restrict__ rows) {
  extern __shared__ int s_dyn[];
  __shared__ int s_tmp[lm::kScanTmp];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* s_rows = rows != nullptr ? rows + (int64_t)r * 5 * G : s_dyn;
  int* s_left = s_rows;
  int* s_off = s_rows + G;
  int* s_cnt = s_rows + 2 * G;
  int* s_pres = s_rows + 3 * G;
  int* s_fwd = s_rows + 4 * G;

  int first = G;
  for (int g = tid; g < G; g += nt) {
    const int64_t k = (int64_t)r * G + g;
    s_left[g] = lefts[k];
    s_off[g] = gen_off[k];
    s_cnt[g] = gen_cnt[k];
    s_pres[g] = present[k] != 0;
    s_fwd[g] = is_fwd[k] != 0;
    if (s_pres[g] && g < first) first = g;
  }
  // the block scan's barriers also publish the state written above
  const int ref = lm::block_scan(first, G, lm::MinOp(), s_tmp).total;
  if (ref >= G) return;  // no genome present: the row never extends
  int len = lengths[r];

  for (int side = 0; side < 2; ++side) {
    int C = chunk;
    int active = 1;
    while (active) {
      const int per = (C + nt - 1) / nt;
      const int d0 = tid * per + 1;
      const unsigned mbits = lm::probe_bits(
          d0, per, C, G, ref, side, len, seed_len, s_left, s_cnt, s_pres,
          s_fwd, fill, TableFetch{keys, n_keys, fill, s_off});
      const int reach = lm::probe_reach(mbits, d0, per, seed_len, s_tmp);
      active = lm::probe_advance(reach, len, C, G, side, seed_len, s_left,
                                 s_cnt, s_pres, s_fwd, s_tmp);
      C = big;
    }
  }
  for (int g = tid; g < G; g += nt) lefts[(int64_t)r * G + g] = s_left[g];
  if (tid == 0) lengths[r] = len;
}

}  // namespace

// Bytes of shared memory the row state of G genomes takes.
extern "C" int64_t lm_extend_row_bytes(int G) {
  return (int64_t)5 * G * (int64_t)sizeof(int);
}

// Bytes of dynamic shared memory K2 may opt into on the current device
// (-1 when the runtime cannot say): wider rows need global scratch.
extern "C" int64_t lm_extend_smem_limit() {
  return lm::max_dyn_smem(extend_kernel);
}

// keys: int64[n_keys]; gen_off, gen_cnt, lefts: int32[R, G];
// present, is_fwd: uint8[R, G]; lengths: int32[R]; rows: int32[R, 5, G]
// global scratch for the row state, or null to keep it in shared memory
// (at most lm_extend_smem_limit() bytes).  lefts and lengths are updated
// in place.
extern "C" int lm_extend(const void* keys, int64_t n_keys, int64_t fill,
                         int seed_len, int chunk, int big, int G, int R,
                         const void* gen_off, const void* gen_cnt,
                         void* lefts, const void* present, const void* is_fwd,
                         void* lengths, void* rows, void* stream) {
  if (G < 1 || big > 32 * kThreads || chunk > big)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = rows != nullptr ? 0 : lm_extend_row_bytes(G);
  const cudaError_t err = lm::allow_dyn_smem(extend_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (R > 0) {
    LM_LAUNCH(extend_kernel, (unsigned)R, kThreads, (size_t)smem,
              (cudaStream_t)stream,
              (const long long*)keys, n_keys, (long long)fill, seed_len,
              chunk, big, G, (const int*)gen_off, (const int*)gen_cnt,
              (int*)lefts, (const uint8_t*)present, (const uint8_t*)is_fwd,
              (int*)lengths, (int*)rows);
  }
  return (int)cudaGetLastError();
}
