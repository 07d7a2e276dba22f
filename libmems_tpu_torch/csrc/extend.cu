// K2: batched ungapped maximal extension.
//
// Replaces libmems_tpu/ops/extend.py extend_matches (extend_core and
// make_probe_round: XLA probe rounds over every candidate at once inside
// a lax.while_loop, with a ROW_BLOCK lax.map and a 128-lane barrel-shift
// span fetch laid out for the TPU's vector unit).
//
// Match rule per probe offset d (ops/extend.py:241-268): every present
// genome's window key, XORed with its strand flag, equals the reference
// genome's (first present genome); no key is the sentinel (its low bit
// may be either); every probe position lies in [0, gen_cnt).
//
// What the result depends on.  A JAX probe round of width C reaches the
// furthest match from the current end with gaps <= seed_len, and the row
// goes on only while the round could not see the chain's end or the
// sequence's edge (reach + seed_len > C and room + reach > C,
// ops/extend.py:270-293).  So a side ends at its maximal chain: the last
// match before the first run of seed_len offsets with no match (offset 0,
// the current end, counts as a match), or before the sequence's edge,
// whatever the round widths.  K2 picks its own; the CPU tests hold the
// plain version's result equal at chunk = seed_len, 128, 256 and a chunk
// wide enough for one round.
//
// Bound: latency of dependent probe steps on the longest rows; the keys
// read are a few MB.  Two routes:
//
// Warp route (G <= kWarpGenomes): a warp a row, kRowWarps rows a block, launched over the
// caller's live rows only.  Lane g holds genome g's state (left end,
// offset, count, presence, strand) in registers; the reference genome is
// the first set bit of a ballot of presence, and the offsets where every
// present genome's window lies in its genome and in the table come from a
// warp min/max.  A step probes u words of 32 consecutive offsets (u = 1,
// 2, 4, then kMaxWords): for each present genome the lanes read 32
// consecutive keys a word (one 256-byte read), and one __ballot_sync
// gives a word's match bits.  The chain is followed on those words by bit
// operations (chain_word, csrc/chain.cuh, which K31 shares with the
// word reads of probe_words): each lane tests whether its offset is a match
// more than seed_len past the previous one (the highest set bit below it,
// or the chain's end so far), and one ballot finds the first such break.
// A step has no __syncthreads.  A row still going after kHandoff offsets
// of a side is handed to the whole block once every warp is through its
// own row: the block's warps probe kRowWarps consecutive segments of
// kMaxWords words a step, each summarises its segment (first and last
// match, a break inside), and every warp combines the summaries in order
// after one barrier, so a long row advances 8x as far a step as one warp
// takes it.
//
// Wide route (more genomes): one block of
// 256 threads a row in rounds of C = chunk, then 8 * chunk, each thread
// owning at most 32 consecutive probe offsets as a bitmask, a round one
// pass over the keys and four block scans (csrc/probe.cuh, which K31
// shares).  The row's state lives in dynamic shared memory sized 5 * G
// ints at launch: up to about 11,600 genomes in what a block may opt into
// on Hopper (lm_extend_smem_limit), and beyond that in global scratch the
// wrapper allocates (5 * G ints a row); genome g is on thread g mod 256,
// the reference genome and the room left are block-wide min reductions.
#include "chain.cuh"
#include "common.cuh"
#include "probe.cuh"

namespace {

using lm_chain::Chain;
using lm_chain::chain_word;
using lm_chain::kFull;
using lm_chain::kMaxWords;
using lm_chain::kWarpGenomes;
using lm_chain::max64;
using lm_chain::min64;
using lm_chain::probe_words;
using lm_chain::SideGeom;

constexpr int kThreads = 256;
// warp route (lm_chain::kWarpGenomes genomes a row at most): rows a
// block, offsets a warp probes on a side before the block takes the row
// (lm_chain::kMaxWords ballot words a step at most)
constexpr int kRowWarps = kThreads / 32;
constexpr int kHandoff = 2048;
// the largest probe offset: below INT_MAX by more than a block's step
constexpr int kMaxOffset = INT_MAX - 2 * kThreads * kMaxWords;

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

// Genome `lane` of a warp's row.
struct RowLane {
  int left, off, cnt;
  bool pres, fwd;
};

__device__ __forceinline__ SideGeom side_geometry(const RowLane& s, int len,
                                                  int side, int seed_len,
                                                  int64_t n_keys) {
  SideGeom sg;
  const bool back = side == 0 ? s.fwd : !s.fwd;
  const long long q0 = back ? s.left : (long long)s.left + len - seed_len;
  sg.at = (long long)s.off + q0;
  sg.dir = back ? -1 : 1;
  sg.flip = s.fwd ? 1 : 0;
  long long lo = 1, hi = kMaxOffset;
  if (s.pres) {
    // q = q0 + dir * d in [0, cnt) and at + dir * d in [0, n_keys)
    if (back) {
      lo = max64(lo, max64(q0 - s.cnt + 1, sg.at - n_keys + 1));
      hi = min64(hi, min64(q0, sg.at));
    } else {
      lo = max64(lo, max64(-q0, -sg.at));
      hi = min64(hi, min64(s.cnt - 1 - q0, n_keys - 1 - sg.at));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = max64(lo, __shfl_xor_sync(kFull, lo, o));
    hi = min64(hi, __shfl_xor_sync(kFull, hi, o));
  }
  sg.lo = (int)min64(lo, kMaxOffset);
  sg.hi = (int)max64(hi, 0);
  return sg;
}

// The side's moving genomes shift left by reach, the length grows by it
// (ops/extend.py:281-286).
__device__ __forceinline__ void advance(RowLane& s, int& len, int side,
                                        int reach) {
  const bool back = side == 0 ? s.fwd : !s.fwd;
  if (s.pres && back) s.left -= reach;
  len += reach;
}

// A segment's summary for the block's combine.
struct Summary {
  int p, first, have, brk;
};

__global__ void __launch_bounds__(kThreads) extend_warp_kernel(
    const long long* __restrict__ keys, int64_t n_keys, long long fill,
    int seed_len, int G, const int* __restrict__ gen_off,
    const int* __restrict__ gen_cnt, int* __restrict__ lefts,
    const uint8_t* __restrict__ present, const uint8_t* __restrict__ is_fwd,
    int* __restrict__ lengths, int n_live) {
  // rows handed to the block: their state, length and side (-1: none)
  __shared__ int s_left[kRowWarps][32], s_off[kRowWarps][32],
      s_cnt[kRowWarps][32], s_flags[kRowWarps][32];
  __shared__ int s_len[kRowWarps], s_side[kRowWarps];
  __shared__ Summary s_sum[2][kRowWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kRowWarps + warp;
  unsigned w[kMaxWords];
  int handed = -1;
  if (r < n_live) {
    RowLane s{0, 0, 0, false, false};
    if (lane < G) {
      const int64_t k = (int64_t)r * G + lane;
      s = RowLane{lefts[k], gen_off[k], gen_cnt[k], present[k] != 0,
                  is_fwd[k] != 0};
    }
    const unsigned pmask = __ballot_sync(kFull, s.pres);
    int len = lengths[r];
    for (int side = 0; pmask && side < 2 && handed < 0; ++side) {
      const SideGeom sg = side_geometry(s, len, side, seed_len, n_keys);
      Chain c{0, 0, true, false};
      int base = 0, u = 1;
      while (true) {
        probe_words(keys, fill, pmask, sg, base, u, w);
#pragma unroll
        for (int j = 0; j < kMaxWords; ++j) {
          if (j < u) chain_word(w[j], base + 32 * j, seed_len, c);
        }
        base += 32 * u;
        if (c.brk || base - c.p >= seed_len || base >= sg.hi) break;
        if (base >= kHandoff) {
          handed = side;
          break;
        }
        u = min(2 * u, kMaxWords);
      }
      advance(s, len, side, c.p);
    }
    if (handed >= 0) {
      s_left[warp][lane] = s.left;
      s_off[warp][lane] = s.off;
      s_cnt[warp][lane] = s.cnt;
      s_flags[warp][lane] = (s.pres ? 1 : 0) | (s.fwd ? 2 : 0);
      if (lane == 0) s_len[warp] = len;
    } else if (pmask) {
      if (s.pres) lefts[(int64_t)r * G + lane] = s.left;
      if (lane == 0) lengths[r] = len;
    }
  }
  if (lane == 0) s_side[warp] = handed;
  __syncthreads();

  // the handed rows, one after another, on every warp of the block
  constexpr int kSeg = 32 * kMaxWords;
  int buf = 0;
  for (int v = 0; v < kRowWarps; ++v) {
    const int first_side = s_side[v];
    if (first_side < 0) continue;
    const int fl = s_flags[v][lane];
    RowLane s{s_left[v][lane], s_off[v][lane], s_cnt[v][lane],
              (fl & 1) != 0, (fl & 2) != 0};
    const unsigned pmask = __ballot_sync(kFull, s.pres);
    int len = s_len[v];
    for (int side = first_side; side < 2; ++side) {
      const SideGeom sg = side_geometry(s, len, side, seed_len, n_keys);
      int P = 0, base = 0;
      bool ended = false;
      while (!ended) {
        const int seg = base + warp * kSeg;
        probe_words(keys, fill, pmask, sg, seg, kMaxWords, w);
        Chain c{0, 0, false, false};
#pragma unroll
        for (int j = 0; j < kMaxWords; ++j)
          chain_word(w[j], seg + 32 * j, seed_len, c);
        if (lane == 0) s_sum[buf][warp] = Summary{c.p, c.first, c.have, c.brk};
        __syncthreads();
        // the segments in order, from the chain's end so far (every warp
        // the same); s_sum[buf] is rewritten two barriers later, after
        // every warp has read it
        for (int k = 0; k < kRowWarps && !ended; ++k) {
          const Summary S = s_sum[buf][k];
          const int end = base + (k + 1) * kSeg;
          if (S.have) {
            if (S.first - P > seed_len) {
              ended = true;
              break;
            }
            P = S.p;
            ended = S.brk != 0;
          }
          ended = ended || end - P >= seed_len;
        }
        buf ^= 1;
        base += kRowWarps * kSeg;
        ended = ended || base >= sg.hi;
      }
      advance(s, len, side, P);
    }
    if (warp == v) {
      const int rv = blockIdx.x * kRowWarps + v;
      if (s.pres) lefts[(int64_t)rv * G + lane] = s.left;
      if (lane == 0) lengths[rv] = len;
    }
  }
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

// Genomes a row at most that the warp routes of K2 and K31 take.
extern "C" int lm_extend_warp_genomes() { return kWarpGenomes; }

// keys: int64[n_keys]; gen_off, gen_cnt, lefts: int32[>= R, G];
// present, is_fwd: uint8[>= R, G]; lengths: int32[>= R], of which the
// first R rows are extended (rows after them are left as they are);
// rows: int32[R, 5, G] global scratch for the wide route's row state, or
// null.  Rows of at most lm_extend_warp_genomes() genomes take the warp
// route (rows is not read); wider rows keep their state in shared memory
// (at most lm_extend_smem_limit() bytes) or, given rows, in that
// scratch.  lefts and lengths are updated in place.
extern "C" int lm_extend(const void* keys, int64_t n_keys, int64_t fill,
                         int seed_len, int chunk, int big, int G, int R,
                         const void* gen_off, const void* gen_cnt,
                         void* lefts, const void* present, const void* is_fwd,
                         void* lengths, void* rows, void* stream) {
  if (G < 1 || big > 32 * kThreads || chunk > big)
    return (int)cudaErrorInvalidValue;
  if (G <= kWarpGenomes) {
    if (R > 0) {
      LM_LAUNCH(extend_warp_kernel, (unsigned)((R + kRowWarps - 1) / kRowWarps),
                kThreads, 0, (cudaStream_t)stream, (const long long*)keys,
                n_keys, (long long)fill, seed_len, G, (const int*)gen_off,
                (const int*)gen_cnt, (int*)lefts, (const uint8_t*)present,
                (const uint8_t*)is_fwd, (int*)lengths, R);
    }
    return (int)cudaGetLastError();
  }
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
