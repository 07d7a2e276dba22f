// K8: HomologyHMM forward/backward -> posterior P(homologous) and calls.
//
// Replaces libmems_tpu/ops/hmm.py _fb_posterior (:139), _fb_posterior_ckpt
// (:186), _fb_calls_small (:479), _fb_calls_ckpt (:465) and
// _fb_calls_assoc (:295).  The JAX package ran three tiers by length (an
// f64 scan, a checkpointed f64 scan, and an f32 associative scan from
// 2^17 columns on); here every length runs in f64, on two routes that
// a row's padded width chooses (ops/hmm.py plan_launches; lm_hmm_fb_rows
// below kScanMinT, lm_hmm_fb with the scan's scratch from it on):
//
// The sequential route (rows padded below kScanMinT = 2^17 columns).
// Bound: latency.  The 2-state log-space recurrence is sequential along a
// row, one step costing two log-sum-exps (two exps and a log each) of
// f64.  libdevice's f64 exp and log branch on their special cases, so one
// thread runs a step's two log-sum-exps one after the other.  Here a
// chain runs on a pair of lanes, lane s computing state s's
// log-sum-exp and taking the other state's from its partner by a shuffle
// each step.  Every row of a call goes into one ragged launch (rows
// concatenated at 16-byte aligned offsets, longest first so a warp holds
// rows of like length).  fb_chain_kernel: one warp a block, kChainRows
// rows a warp, blocks 2k and 2k + 1 the forward (F of state 0 and logP)
// and the backward (B of state 0) chains of the same rows, so the launch
// costs one chain of its longest row, not two, and the longest rows'
// chains spread over as many SMs as they have warps (two chains on one
// SM slow each other's steps).  The live lanes of a warp all run its
// longest row's steps, those past their own row idling, so each shuffle
// names lanes that run it.  Nothing but the
// log-sum-exps and the shuffle is on a chain: the symbols come 16 at a
// time (uint4) a group ahead, a column's emission pair from a table in
// shared memory a column ahead, and F and B are stored and never read
// back there.  fb_post_kernel then forms every column's posterior and
// call, one thread a column, coalesced.  The scratch is 16 bytes a column
// (F0, B0): only state 0's posterior is asked for.
//
// Arithmetic copies ops/hmm.py:_fb_posterior, including jax.nn.logsumexp's
// form max + log(sum(exp(x - max))) with a non-finite max replaced by 0,
// and its association order:
//   F_0[k]   = ls[k] + le[k][o_0]
//   F_i[j]   = LSE_k(F_{i-1}[k] + lt[k][j]) + le[j][o_i]
//   logP     = LSE_k(F_{L-1}[k] + lstop[k])
//   B_{L-1}  = lstop
//   B_i[k]   = LSE_j(lt[k][j] + (le[j][o_{i+1}] + B_{i+1}[j]))
//   post_i   = exp((F_i[0] + B_i[0]) - logP),  call_i = post_i >= threshold
// There is no multiply, so no contraction into fused multiply-adds.
// The chains and the posterior pass do exactly these operations in this
// order, so they give the bits of the one-thread walk they replaced.
//
// The chunked scan (T >= kScanMinT).  One thread walking 8.7 M columns
// leaves 131 of 132 SMs idle, and its f64 values grow to |F| ~ 1e7, where
// every add rounds at 1e-9 (R16).  A row is cut into chunks of
// kScanCols columns, and the same steps run in three launches:
//   1. scan_transfer_kernel, one thread a (row, chunk, direction): the
//      chunk's 2x2 transfer, walked from the unit vectors (0, -inf) and
//      (-inf, 0).  Forward it maps g (log P of the prefix, entering a
//      column) at the chunk's first column to g at the next chunk's, or,
//      in the row's last chunk, to F_{L-1} + lstop.  Backward it maps
//      beta = le(o_i) + B_i at the next chunk's first column (or B at the
//      row's last column) to beta at the chunk's first column.
//   2. scan_fold_kernel, one thread a (row, direction): folds the
//      transfers from ls left to right and from lstop right to left.  A
//      carry is a pair less its max plus an offset summed as a
//      double-double (two-sum), so no value or sum grows with the row;
//      the forward fold ends in logP (hi, lo).
//   3. scan_post_kernel, one thread a (row, chunk): the forward values
//      from the left carry (kept in scratch), then the backward walk from
//      the right carry, writing
//        post = exp((F + B) + ((off_f + off_b) - logP))
//      with the bracket taken in double-double and rounded once.
// Bound: f64 operations (phases 1 and 3 do about three times K8's
// log-sum-exps a column, on B x T / kScanCols threads) and the fold's
// dependent chain of T / kScanCols steps a row.  Each thread reads its
// chunk's symbols 16 bytes at a time, and the forward scratch is laid out
// so that a warp's 32 chunks write one 256-byte line a column.  It cannot
// give the sequential route's bits: it is the more accurate of the two
// (1.5e-10 against an 80-bit run at 2^17 + 5 columns, where the
// sequential walk is off by 3.3e-7).
//
// K20 (viterbi_rows_kernel) replaces _viterbi_path (ops/hmm.py:531) and
// K21 replaces _bw_counts (ops/hmm.py:603).
//   K20: one ragged launch a call over fb_ragged's layout (rows at 16-byte
//        aligned offsets, longest first, so a warp holds rows of like
//        length), a thread a row, f64 at every length: max-plus has no
//        exp or log, so no precision tier (R15, R16).  Bound: latency,
//        the longest row's column chain, forward then walk.  Forward, for
//        each state `to`: cand[k] = v[k] + lt[k][to], ptr = the first
//        argmax (cand[1] > cand[0]), v[to] = max + le[to][o_i]; both
//        candidates take le beside the compare, which then picks a sum
//        (the same bits), so a column's chain is an add, a compare and a
//        select.  A pair of lanes a row (a state a lane, the other's value
//        by shuffle) measured about twice one thread's step, so one thread
//        it is (PERF.md row 14b).  The
//        symbols come 16 bytes at a time a group ahead, a column's
//        emission pair from shared memory a column ahead.  A column's two
//        pointer bits are packed 16 columns to a 32-bit word in a register
//        and stored once a word: 1/4 byte a column of scratch (the parent
//        kept a byte a column).  Row r's words lie at word offsets[r] / 16,
//        inside its own extent: words interleaved across a warp's rows
//        would need each warp's base, a prefix over the warps' longest
//        rows that the ragged layout does not carry.  The end state is the
//        first argmax of v + lstop; the walk back reads kWalkAhead words
//        ahead into a ring whose slots are reloaded in place, follows the
//        state by a shift and a mask a column with no branch (R17), and
//        writes the path (1 where the state is 0) 16 bytes at a time,
//        every byte of the row's extent up to the next row's offset, zeros
//        past its length: no zero fill and no bool copy, and obs and path
//        are __restrict__, so no load waits behind a store.
//        viterbi_path's padded batches are this launch with offsets r x S.
//   K21: K8's two routes.  Sequential (bw_kernel): the forward (kept in
//        scratch, as K8), the backward (kept in scratch too), logP; then,
//        in column order, the expected counts:
//          gamma_t[k]    = exp((F_t[k] + B_t[k]) - logP)
//          xi_t[k][j]    = exp(((F_t[k] + lt[k][j])
//                               + (le[j][o_{t+1}] + B_{t+1}[j])) - logP)
//        into start (gamma_0), emission (gamma_t by o_t) and transition
//        (xi_t, t < L-1) counts: one row of 23 partial sums a sequence
//        (start[2], trans[4], emit[16], logP), which the wrapper sums over
//        sequences in index order on the host (no atomics).  Chunked:
//        phases 1 and 2 as K8, then scan_bw_kernel (the same walks, both
//        states kept; each chunk's counts in column order, with
//        ((off_f + off_b) - logP) for - logP and, for a transition out of
//        the chunk's last column, beta of the next column from the right
//        carry) and scan_bw_reduce_kernel (a row's chunks in chunk order).
#include "common.cuh"

namespace {

struct HmmMats {
  double ls[2];
  double lt[4];      // lt[k * 2 + j]: from state k to state j
  double lstop[2];
  double le[16];     // le[k * 8 + symbol]
};

__device__ __forceinline__ double lse2(double a, double b) {
  double m = a > b ? a : b;
  if (!isfinite(m)) m = 0.0;
  return log(exp(a - m) + exp(b - m)) + m;
}

constexpr int kBwCounts = 23;  // start[2], trans[4], emit[16], logP

__global__ void bw_kernel(const unsigned char* __restrict__ obs,
                          const int* __restrict__ lengths, int B, int T,
                          HmmMats mt, double* __restrict__ fwd,
                          double* __restrict__ bwd,
                          double* __restrict__ part) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  double* out = part + (int64_t)b * kBwCounts;
  const int L = lengths[b];
  if (L <= 0) {
    for (int k = 0; k < kBwCounts; ++k) out[k] = 0.0;
    return;
  }
  const unsigned char* o = obs + (int64_t)b * T;
  double* F = fwd + (int64_t)b * T * 2;
  double* Bk = bwd + (int64_t)b * T * 2;

  int sym = o[0];
  double f0 = mt.ls[0] + mt.le[sym];
  double f1 = mt.ls[1] + mt.le[8 + sym];
  F[0] = f0;
  F[1] = f1;
  for (int i = 1; i < L; ++i) {
    sym = o[i];
    const double g0 = lse2(f0 + mt.lt[0], f1 + mt.lt[2]) + mt.le[sym];
    const double g1 = lse2(f0 + mt.lt[1], f1 + mt.lt[3]) + mt.le[8 + sym];
    f0 = g0;
    f1 = g1;
    F[2 * i] = f0;
    F[2 * i + 1] = f1;
  }
  const double logp = lse2(f0 + mt.lstop[0], f1 + mt.lstop[1]);

  double b0 = mt.lstop[0];
  double b1 = mt.lstop[1];
  Bk[2 * (L - 1)] = b0;
  Bk[2 * (L - 1) + 1] = b1;
  for (int i = L - 2; i >= 0; --i) {
    sym = o[i + 1];
    const double t0 = mt.le[sym] + b0;
    const double t1 = mt.le[8 + sym] + b1;
    const double n0 = lse2(mt.lt[0] + t0, mt.lt[1] + t1);
    const double n1 = lse2(mt.lt[2] + t0, mt.lt[3] + t1);
    b0 = n0;
    b1 = n1;
    Bk[2 * i] = b0;
    Bk[2 * i + 1] = b1;
  }

  double start[2] = {0.0, 0.0};
  double trans[4] = {0.0, 0.0, 0.0, 0.0};
  double emit[16];
  for (int k = 0; k < 16; ++k) emit[k] = 0.0;
  for (int t = 0; t < L; ++t) {
    sym = o[t];
    const double ft0 = F[2 * t], ft1 = F[2 * t + 1];
    const double g0 = exp((ft0 + Bk[2 * t]) - logp);
    const double g1 = exp((ft1 + Bk[2 * t + 1]) - logp);
    if (t == 0) {
      start[0] = g0;
      start[1] = g1;
    }
    emit[sym] += g0;
    emit[8 + sym] += g1;
    if (t + 1 < L) {
      const int ns = o[t + 1];
      const double nb0 = mt.le[ns] + Bk[2 * t + 2];
      const double nb1 = mt.le[8 + ns] + Bk[2 * t + 3];
      trans[0] += exp(((ft0 + mt.lt[0]) + nb0) - logp);
      trans[1] += exp(((ft0 + mt.lt[1]) + nb1) - logp);
      trans[2] += exp(((ft1 + mt.lt[2]) + nb0) - logp);
      trans[3] += exp(((ft1 + mt.lt[3]) + nb1) - logp);
    }
  }
  out[0] = start[0];
  out[1] = start[1];
  for (int k = 0; k < 4; ++k) out[2 + k] = trans[k];
  for (int k = 0; k < 16; ++k) out[6 + k] = emit[k];
  out[22] = logp;
}

// ---------------------------------------------------------------------
// The chunked scan (T >= kScanMinT): K8's and K21's long route.
// ---------------------------------------------------------------------

constexpr int kScanCols = 1024;       // ops/hmm.py FB_SCAN_COLS
constexpr int kScanMinT = 1 << 17;    // ops/hmm.py FB_SCAN_MIN_T
constexpr int kScanThreads = 128;     // divides T / kScanCols
constexpr int kCarry = 8;             // forward (p0, p1, hi, lo), backward
constexpr int kChunkCounts = 22;      // trans[4], emit[16], start[2]

__device__ __forceinline__ double finite_or_zero(double m) {
  return isfinite(m) ? m : 0.0;
}

// (a + b rounded, its rounding error), exactly (Knuth's two-sum)
__device__ __forceinline__ double two_sum(double a, double b, double& err) {
  const double s = a + b;
  const double bp = s - a;
  err = (a - (s - bp)) + (b - bp);
  return s;
}

// A fold step: the pair less its finite max, the max into (hi, lo).
__device__ __forceinline__ void normalise(double& n0, double& n1, double& hi,
                                          double& lo) {
  const double m = finite_or_zero(n0 > n1 ? n0 : n1);
  double e;
  hi = two_sum(hi, m, e);
  lo = lo + e;
  n0 = n0 - m;
  n1 = n1 - m;
}

// A row's columns [c0, c0 + n) of one chunk, 16 symbols a load (o + c0 is
// 16-byte aligned: the wrapper checks obs, T and kScanCols are multiples
// of 16), in column order or in reverse; visit(i, symbol), i from 0.
__device__ __forceinline__ int symbol_of(const uint4& v, int k) {
  const unsigned w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return (int)((w >> ((k & 3) * 8)) & 0xffu);
}

template <class Visit>
__device__ __forceinline__ void chunk_forward(const unsigned char* o, int n,
                                              Visit visit) {
  for (int base = 0; base < n; base += 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(o + base);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (base + k < n) visit(base + k, symbol_of(v, k));
    }
  }
}

template <class Visit>
__device__ __forceinline__ void chunk_backward(const unsigned char* o, int n,
                                               Visit visit) {
  for (int base = (n - 1) & ~15; base >= 0; base -= 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(o + base);
#pragma unroll
    for (int k = 15; k >= 0; --k) {
      if (base + k < n) visit(base + k, symbol_of(v, k));
    }
  }
}

// One chunk of one row as a thread of phases 1 and 3 sees it.
struct ScanChunk {
  int b, c, L, n;      // row, chunk, row length, the chunk's columns
  bool ends;           // the row's last column lies in this chunk
  int64_t g;           // b * nct + c
};

__device__ __forceinline__ bool scan_chunk(const int* lengths, int B, int T,
                                           ScanChunk& ch) {
  const int nct = T / kScanCols;
  ch.g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ch.b = (int)(ch.g / nct);
  ch.c = (int)(ch.g % nct);
  if (ch.b >= B) return false;
  ch.L = lengths[ch.b];
  const int c0 = ch.c * kScanCols;
  if (c0 >= ch.L) return false;
  ch.n = min(kScanCols, ch.L - c0);
  ch.ends = c0 + kScanCols >= ch.L;
  return true;
}

// The chunk-major scratch index of column i of chunk g: a warp's 32
// chunks lie side by side, column after column.
__device__ __forceinline__ int64_t scratch_at(int64_t g, int i) {
  return ((g >> 5) * kScanCols + i) * 32 + (g & 31);
}

// ((off_f + off_b) - logP) of a chunk in double-double, rounded once
__device__ __forceinline__ double scan_offset(const double* C,
                                              const double* lp) {
  double e, e2;
  const double s = two_sum(C[2], C[6], e);
  const double t = (C[3] + C[7]) + e;
  const double s2 = two_sum(s, -lp[0], e2);
  return s2 + ((t - lp[1]) + e2);
}

// Phase 1: the chunk's transfers from the unit vectors; xfer[g * 8 + ...]
// forward Tf[s][j] at s * 2 + j, backward Tb[s][k] at 4 + s * 2 + k.
__global__ void scan_transfer_kernel(const unsigned char* __restrict__ obs,
                                     const int* __restrict__ lengths, int B,
                                     int T, HmmMats mt,
                                     double* __restrict__ xfer) {
  ScanChunk ch;
  if (!scan_chunk(lengths, B, T, ch)) return;
  const unsigned char* o =
      obs + (int64_t)ch.b * T + (int64_t)ch.c * kScanCols;
  double* X = xfer + ch.g * kCarry;
  const double ninf = -INFINITY;
  const int n = ch.n;
  const bool ends = ch.ends;
  if (blockIdx.y == 0) {
    double g00 = 0.0, g01 = ninf, g10 = ninf, g11 = 0.0;   // g[s][j]
    chunk_forward(o, n, [&](int i, int sym) {
      const double e0 = mt.le[sym], e1 = mt.le[8 + sym];
      const double f00 = g00 + e0, f01 = g01 + e1;
      const double f10 = g10 + e0, f11 = g11 + e1;
      if (ends && i == n - 1) {
        g00 = f00 + mt.lstop[0];
        g01 = f01 + mt.lstop[1];
        g10 = f10 + mt.lstop[0];
        g11 = f11 + mt.lstop[1];
      } else {
        g00 = lse2(f00 + mt.lt[0], f01 + mt.lt[2]);
        g01 = lse2(f00 + mt.lt[1], f01 + mt.lt[3]);
        g10 = lse2(f10 + mt.lt[0], f11 + mt.lt[2]);
        g11 = lse2(f10 + mt.lt[1], f11 + mt.lt[3]);
      }
    });
    X[0] = g00;
    X[1] = g01;
    X[2] = g10;
    X[3] = g11;
  } else {
    double a00 = 0.0, a01 = ninf, a10 = ninf, a11 = 0.0;   // beta[s][k]
    chunk_backward(o, n, [&](int i, int sym) {
      double b00, b01, b10, b11;
      if (ends && i == n - 1) {
        b00 = 0.0;
        b01 = ninf;
        b10 = ninf;
        b11 = 0.0;
      } else {
        b00 = lse2(mt.lt[0] + a00, mt.lt[1] + a01);
        b01 = lse2(mt.lt[2] + a00, mt.lt[3] + a01);
        b10 = lse2(mt.lt[0] + a10, mt.lt[1] + a11);
        b11 = lse2(mt.lt[2] + a10, mt.lt[3] + a11);
      }
      a00 = mt.le[sym] + b00;
      a01 = mt.le[8 + sym] + b01;
      a10 = mt.le[sym] + b10;
      a11 = mt.le[8 + sym] + b11;
    });
    X[4] = a00;
    X[5] = a01;
    X[6] = a10;
    X[7] = a11;
  }
}

// Phase 2: one thread a (row, direction) folds the row's transfers.
// carry[g * 8 + ...]: forward (p0, p1, hi, lo) entering the chunk from the
// left, backward (p0, p1, hi, lo) entering it from the right; logp[b * 2]:
// logP as (hi, lo).
__global__ void scan_fold_kernel(const int* __restrict__ lengths, int B,
                                 int nct, HmmMats mt,
                                 const double* __restrict__ xfer,
                                 double* __restrict__ carry,
                                 double* __restrict__ logp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int L = lengths[b];
  if (L <= 0) return;
  const int nc = (L + kScanCols - 1) / kScanCols;
  const double* X = xfer + (int64_t)b * nct * kCarry;
  double* C = carry + (int64_t)b * nct * kCarry;
  double hi = 0.0, lo = 0.0;
  if (blockIdx.y == 0) {
    double p0 = mt.ls[0], p1 = mt.ls[1];
    normalise(p0, p1, hi, lo);
    for (int c = 0; c < nc; ++c) {
      double* Cc = C + (int64_t)c * kCarry;
      const double* Tc = X + (int64_t)c * kCarry;
      Cc[0] = p0;
      Cc[1] = p1;
      Cc[2] = hi;
      Cc[3] = lo;
      double n0 = lse2(p0 + Tc[0], p1 + Tc[2]);
      double n1 = lse2(p0 + Tc[1], p1 + Tc[3]);
      if (c < nc - 1) {
        normalise(n0, n1, hi, lo);
        p0 = n0;
        p1 = n1;
      } else {
        double e;
        const double h = two_sum(hi, lse2(n0, n1), e);
        logp[2 * b] = h;
        logp[2 * b + 1] = lo + e;
      }
    }
  } else {
    double p0 = mt.lstop[0], p1 = mt.lstop[1];
    normalise(p0, p1, hi, lo);
    for (int c = nc - 1; c >= 0; --c) {
      double* Cc = C + (int64_t)c * kCarry + 4;
      Cc[0] = p0;
      Cc[1] = p1;
      Cc[2] = hi;
      Cc[3] = lo;
      if (c == 0) break;
      const double* Tc = X + (int64_t)c * kCarry + 4;
      double n0 = lse2(p0 + Tc[0], p1 + Tc[2]);
      double n1 = lse2(p0 + Tc[1], p1 + Tc[3]);
      normalise(n0, n1, hi, lo);
      p0 = n0;
      p1 = n1;
    }
  }
}

// Phase 3's forward walk: values relative to the left carry, one visit a
// column with (i, f0, f1).
template <class Visit>
__device__ __forceinline__ void scan_forward(const unsigned char* o,
                                             const ScanChunk& ch,
                                             const HmmMats& mt,
                                             const double* C, Visit visit) {
  double g0 = C[0], g1 = C[1];
  chunk_forward(o, ch.n, [&](int i, int sym) {
    const double f0 = g0 + mt.le[sym];
    const double f1 = g1 + mt.le[8 + sym];
    visit(i, f0, f1);
    g0 = lse2(f0 + mt.lt[0], f1 + mt.lt[2]);
    g1 = lse2(f0 + mt.lt[1], f1 + mt.lt[3]);
  });
}

// Phase 3's backward walk: B relative to the right carry, one visit a
// column with (i, b0, b1).
template <class Visit>
__device__ __forceinline__ void scan_backward(const unsigned char* o,
                                              const ScanChunk& ch,
                                              const HmmMats& mt,
                                              const double* C, Visit visit) {
  double a0 = C[4], a1 = C[5];
  chunk_backward(o, ch.n, [&](int i, int sym) {
    double b0, b1;
    if (ch.ends && i == ch.n - 1) {
      b0 = C[4];
      b1 = C[5];
    } else {
      b0 = lse2(mt.lt[0] + a0, mt.lt[1] + a1);
      b1 = lse2(mt.lt[2] + a0, mt.lt[3] + a1);
    }
    visit(i, b0, b1);
    a0 = mt.le[sym] + b0;
    a1 = mt.le[8 + sym] + b1;
  });
}

// Phase 3 of K8: posteriors and calls of one chunk.  fwd: f64 scratch of
// B * T (state 0's forward values, chunk-major).
__global__ void scan_post_kernel(const unsigned char* __restrict__ obs,
                                 const int* __restrict__ lengths, int B,
                                 int T, HmmMats mt, double threshold,
                                 const double* __restrict__ carry,
                                 const double* __restrict__ logp,
                                 double* __restrict__ fwd,
                                 double* __restrict__ post,
                                 unsigned char* __restrict__ calls) {
  ScanChunk ch;
  if (!scan_chunk(lengths, B, T, ch)) return;
  const int64_t c0 = (int64_t)ch.b * T + (int64_t)ch.c * kScanCols;
  const unsigned char* o = obs + c0;
  const double* C = carry + ch.g * kCarry;
  const double D = scan_offset(C, logp + 2 * ch.b);
  scan_forward(o, ch, mt, C, [&](int i, double f0, double) {
    fwd[scratch_at(ch.g, i)] = f0;
  });
  scan_backward(o, ch, mt, C, [&](int i, double b0, double) {
    const double p = exp((fwd[scratch_at(ch.g, i)] + b0) + D);
    if (post != nullptr) post[c0 + i] = p;
    calls[c0 + i] = p >= threshold ? 1 : 0;
  });
}

// Phase 3 of K21: both states' values of one chunk (chunk-major double2
// scratch), then its counts in column order into cpart[g * 22 + ...]:
// trans[4], emit[16], start[2] (gamma of column 0; zero in other chunks).
__global__ void scan_bw_kernel(const unsigned char* __restrict__ obs,
                               const int* __restrict__ lengths, int B, int T,
                               HmmMats mt, const double* __restrict__ carry,
                               const double* __restrict__ logp,
                               double2* __restrict__ fwd,
                               double2* __restrict__ bwd,
                               double* __restrict__ cpart) {
  ScanChunk ch;
  if (!scan_chunk(lengths, B, T, ch)) return;
  const unsigned char* o =
      obs + (int64_t)ch.b * T + (int64_t)ch.c * kScanCols;
  const double* C = carry + ch.g * kCarry;
  const double D = scan_offset(C, logp + 2 * ch.b);
  scan_forward(o, ch, mt, C, [&](int i, double f0, double f1) {
    fwd[scratch_at(ch.g, i)] = make_double2(f0, f1);
  });
  scan_backward(o, ch, mt, C, [&](int i, double b0, double b1) {
    bwd[scratch_at(ch.g, i)] = make_double2(b0, b1);
  });
  double trans[4] = {0.0, 0.0, 0.0, 0.0};
  double e0[8], e1[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) e0[k] = e1[k] = 0.0;
  double start0 = 0.0, start1 = 0.0;
  double pf0 = 0.0, pf1 = 0.0;   // the previous column's forward values
  const bool first = ch.c == 0;
  // a transition out of column i - 1 is added at column i, in column
  // order all the same
  auto add_trans = [&](double nb0, double nb1) {
    trans[0] += exp(((pf0 + mt.lt[0]) + nb0) + D);
    trans[1] += exp(((pf0 + mt.lt[1]) + nb1) + D);
    trans[2] += exp(((pf1 + mt.lt[2]) + nb0) + D);
    trans[3] += exp(((pf1 + mt.lt[3]) + nb1) + D);
  };
  chunk_forward(o, ch.n, [&](int i, int sym) {
    const double2 ft = fwd[scratch_at(ch.g, i)];
    const double2 bt = bwd[scratch_at(ch.g, i)];
    if (i > 0) add_trans(mt.le[sym] + bt.x, mt.le[8 + sym] + bt.y);
    const double g0 = exp((ft.x + bt.x) + D);
    const double g1 = exp((ft.y + bt.y) + D);
    if (first && i == 0) {
      start0 = g0;
      start1 = g1;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k == sym) {
        e0[k] += g0;
        e1[k] += g1;
      }
    }
    pf0 = ft.x;
    pf1 = ft.y;
  });
  if (ch.c * kScanCols + ch.n < ch.L) add_trans(C[4], C[5]);
  double* out = cpart + ch.g * kChunkCounts;
  for (int k = 0; k < 4; ++k) out[k] = trans[k];
  for (int k = 0; k < 8; ++k) {
    out[4 + k] = e0[k];
    out[12 + k] = e1[k];
  }
  out[20] = start0;
  out[21] = start1;
}

// K21's last step: a row's chunk counts in chunk order, one thread a
// (row, count); part[b * 23 + ...] as the sequential route's.
__global__ void scan_bw_reduce_kernel(const int* __restrict__ lengths, int B,
                                      int nct,
                                      const double* __restrict__ cpart,
                                      const double* __restrict__ logp,
                                      double* __restrict__ part) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * kBwCounts) return;
  const int b = (int)(t / kBwCounts);
  const int k = (int)(t % kBwCounts);
  const int L = lengths[b];
  double v = 0.0;
  if (L > 0) {
    const double* P = cpart + (int64_t)b * nct * kChunkCounts;
    if (k < 2) {
      v = P[20 + k];
    } else if (k < 22) {
      const int nc = (L + kScanCols - 1) / kScanCols;
      for (int c = 0; c < nc; ++c) v += P[(int64_t)c * kChunkCounts + k - 2];
    } else {
      v = logp[2 * b] + logp[2 * b + 1];
    }
  }
  part[t] = v;
}

// ---------------------------------------------------------------------
// The sequential route (rows padded below kScanMinT): K8's short rows,
// one ragged launch a call.
// ---------------------------------------------------------------------

constexpr int kChainRows = 8;   // rows a warp, two lanes a row

// A block's shared table of each symbol's emission pair (le[0][s],
// le[1][s]).
__device__ __forceinline__ void fill_emissions(const HmmMats& mt,
                                               double2* le) {
  for (int t = threadIdx.x; t < 8; t += blockDim.x) {
    le[t] = make_double2(mt.le[t], mt.le[8 + t]);
  }
  __syncthreads();
}

// The emission pair of symbol k of a group of 16 (symbols are 0..7: the
// mask keeps a symbol read past a row's end inside the table).
__device__ __forceinline__ double2 emission(const double2* le,
                                            const uint4& v, int k) {
  return le[symbol_of(v, k) & 7];
}

// A row's forward chain on a pair of lanes, lane s computing state s and
// taking the other state from its partner by a shuffle over `mask` (every
// live lane of the warp: all of them run Lw - 1 steps, the warp's longest
// row, so that each shuffle names lanes that run it): F[i] = F_i[0] for i
// < L, then logP, stored by lane 0.  o: the row's symbols, 16-byte
// aligned and readable up to the next multiple of 16; a group is loaded
// 16 columns ahead and a column's emission pair one column ahead, never
// past the row's last group.
__device__ __forceinline__ void forward_chain(const unsigned char* o, int L,
                                              int Lw, const HmmMats& mt,
                                              const double2* le, int s,
                                              unsigned mask, double* F,
                                              double* logp) {
  const uint4* o4 = reinterpret_cast<const uint4*>(o);
  const int groups = (L + 15) >> 4;
  uint4 v = o4[0];
  uint4 nv = groups > 1 ? o4[1] : v;
  double2 e = emission(le, v, 0);
  double f0 = mt.ls[0] + e.x;
  double f1 = mt.ls[1] + e.y;
  if (s == 0) F[0] = f0;
  const double la = s ? mt.lt[1] : mt.lt[0];   // lt[0][s]
  const double lb = s ? mt.lt[3] : mt.lt[2];   // lt[1][s]
  double l0 = f0, l1 = f1;                     // F_{L-1}
  e = emission(le, v, 1);
  for (int i = 1; i < Lw; ++i) {
    const double es = s ? e.y : e.x;
    const int n = i + 1;
    if ((n & 15) == 0) {
      v = nv;
      nv = (n >> 4) + 1 < groups ? o4[(n >> 4) + 1] : v;
    }
    e = emission(le, v, n & 15);
    const double g = lse2(f0 + la, f1 + lb) + es;
    const double h = __shfl_xor_sync(mask, g, 1);
    f0 = s ? h : g;
    f1 = s ? g : h;
    if (s == 0 && i < L) F[i] = f0;
    l0 = i < L ? f0 : l0;
    l1 = i < L ? f1 : l1;
  }
  if (s == 0) *logp = lse2(l0 + mt.lstop[0], l1 + mt.lstop[1]);
}

// A row's backward chain from lstop on a pair of lanes, lane s computing
// state s: Bk[i] = B_i[0] for i < L, stored by lane 0.  The warp walks
// the columns c = Lw - 1 down to 1 together (symbol o[c] takes B_c to
// B_{c-1}), a lane joining at its row's last column, so the groups (each
// loaded 16 columns ahead, none past the row's last) change for every
// lane at once.
__device__ __forceinline__ void backward_chain(const unsigned char* o, int L,
                                               int Lw, const HmmMats& mt,
                                               const double2* le, int s,
                                               unsigned mask, double* Bk) {
  const uint4* o4 = reinterpret_cast<const uint4*>(o);
  const int groups = (L + 15) >> 4;
  double b0 = mt.lstop[0];
  double b1 = mt.lstop[1];
  if (s == 0) Bk[L - 1] = b0;
  const int q = (Lw - 1) >> 4;
  uint4 v = q < groups ? o4[q] : make_uint4(0, 0, 0, 0);
  uint4 nv = q > 0 && q - 1 < groups ? o4[q - 1] : v;
  const double la = s ? mt.lt[2] : mt.lt[0];   // lt[s][0]
  const double lb = s ? mt.lt[3] : mt.lt[1];   // lt[s][1]
  double2 e = emission(le, v, (Lw - 1) & 15);
  for (int c = Lw - 1; c >= 1; --c) {
    const int n = c - 1;
    if ((n & 15) == 15) {
      v = nv;
      const int qn = (n >> 4) - 1;
      nv = qn >= 0 && qn < groups ? o4[qn] : v;
    }
    const double2 en = emission(le, v, n & 15);
    const double t0 = e.x + b0;
    const double t1 = e.y + b1;
    const double g = lse2(la + t0, lb + t1);
    const double h = __shfl_xor_sync(mask, g, 1);
    if (c < L) {
      b0 = s ? h : g;
      b1 = s ? g : h;
      if (s == 0) Bk[n] = b0;
    }
    e = en;
  }
}

// One warp a block: block 2k + d runs direction d (0 forward into
// fb[off + i] and logp, 1 backward into fb[total + off + i]) of rows
// kChainRows k.., lanes 2j and 2j + 1 row j's two states.  Lanes past the
// rows, and rows of length 0, exit; the rest run the warp's longest row.
__global__ void __launch_bounds__(32)
    fb_chain_kernel(const unsigned char* __restrict__ obs,
                    const int64_t* __restrict__ offsets,
                    const int* __restrict__ lengths, int N, int64_t total,
                    HmmMats mt, double* __restrict__ fb,
                    double* __restrict__ logp) {
  __shared__ double2 le[8];
  fill_emissions(mt, le);
  const int lane = threadIdx.x;
  const int j = lane >> 1;
  const int r = (blockIdx.x >> 1) * kChainRows + j;
  const int L = j < kChainRows && r < N ? lengths[r] : 0;
  const int Lw = (int)__reduce_max_sync(0xffffffffu, (unsigned)max(L, 0));
  if (L <= 0) return;
  const unsigned mask = (1u << (2 * kChainRows)) - 1;
  const int64_t off = offsets[r];
  const int s = lane & 1;
  if ((blockIdx.x & 1) == 0) {
    forward_chain(obs + off, L, Lw, mt, le, s, mask, fb + off, logp + r);
  } else {
    backward_chain(obs + off, L, Lw, mt, le, s, mask, fb + total + off);
  }
}

// One thread a column of the layout: the row is the last whose offset is
// at or below it; below the row's length the posterior and the call,
// elsewhere 0.
__global__ void fb_post_kernel(const int64_t* __restrict__ offsets,
                               const int* __restrict__ lengths, int N,
                               int64_t total, const double* __restrict__ fb,
                               const double* __restrict__ logp,
                               double threshold, double* __restrict__ post,
                               unsigned char* __restrict__ calls) {
  for (int64_t g = lm::first_index(); g < total; g += lm::grid_stride()) {
    int lo = 0, hi = N - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (offsets[mid] <= g) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const bool valid = g - offsets[lo] < lengths[lo];
    const double p = valid ? exp((fb[g] + fb[total + g]) - logp[lo]) : 0.0;
    if (post != nullptr) post[g] = p;
    calls[g] = valid && p >= threshold ? 1 : 0;
  }
}

// The chains' step measured on one pair of lanes: clock64 around a row's
// forward chain, then around its backward chain.
__global__ void fb_step_cycles_kernel(const unsigned char* __restrict__ o,
                                      int L, int64_t stride, HmmMats mt,
                                      double* __restrict__ fb,
                                      long long* __restrict__ cycles) {
  __shared__ double2 le[8];
  fill_emissions(mt, le);
  const int s = threadIdx.x & 1;
  double logp = 0.0;
  const long long t0 = clock64();
  forward_chain(o, L, L, mt, le, s, 3u, fb, &logp);
  const long long t1 = clock64();
  backward_chain(o, L, L, mt, le, s, 3u, fb + stride);
  const long long t2 = clock64();
  if (s == 0) {
    fb[2 * stride] = logp;
    cycles[0] = t1 - t0;
    cycles[1] = t2 - t1;
  }
}

// ---------------------------------------------------------------------
// K20: Viterbi decoding, one ragged launch a call, a thread a row.
// ---------------------------------------------------------------------

constexpr int kViterbiRows = 32;   // rows a block (one warp)
constexpr int kWalkAhead = 8;      // pointer words the walk loads ahead

// One column of the max-plus recurrence from (v0, v1) with the column's
// emission pair e: the new values and the column's pointer pair (p0 | p1
// << 1), the first argmax of each state's two candidates.  Both
// candidates take e beside the compare and the compare picks one sum:
// the picked candidate plus e, the same bits, with the chain an add, the
// compare and a select.
__device__ __forceinline__ unsigned viterbi_step(double& v0, double& v1,
                                                 const HmmMats& mt,
                                                 const double2& e) {
  const double c00 = __dadd_rn(v0, mt.lt[0]);
  const double c10 = __dadd_rn(v1, mt.lt[2]);
  const double c01 = __dadd_rn(v0, mt.lt[1]);
  const double c11 = __dadd_rn(v1, mt.lt[3]);
  const bool p0 = c10 > c00;
  const bool p1 = c11 > c01;
  const double s00 = __dadd_rn(c00, e.x);
  const double s10 = __dadd_rn(c10, e.x);
  const double s01 = __dadd_rn(c01, e.y);
  const double s11 = __dadd_rn(c11, e.y);
  v0 = p0 ? s10 : s00;
  v1 = p1 ? s11 : s01;
  return (p0 ? 1u : 0u) | (p1 ? 2u : 0u);
}

// A row's forward pass over its L >= 1 columns (symbols o, 16-byte
// aligned, readable up to the next multiple of 16): pointer word g
// (columns 16g..16g+15, two bits a column, column 0 the identity pair
// 0b10) stored to P[g].  A group of symbols is loaded a group ahead and a
// column's emission pair a column ahead; the groups after the first that
// the row fills run with no test a column.  Returns the end state, the
// first argmax of v + lstop.
__device__ __forceinline__ int viterbi_forward(
    const unsigned char* __restrict__ o, int L, const HmmMats& mt,
    const double2* le, unsigned* __restrict__ P) {
  const uint4* o4 = reinterpret_cast<const uint4*>(o);
  const int groups = (L + 15) >> 4;
  uint4 v = o4[0];
  uint4 nv = groups > 1 ? o4[1] : v;
  double2 e = emission(le, v, 0);
  double v0 = __dadd_rn(mt.ls[0], e.x);
  double v1 = __dadd_rn(mt.ls[1], e.y);
  unsigned word = 2u;
  for (int g = 0;;) {
    if (g > 0 && 16 * g + 16 <= L) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const double2 en = k < 15 ? emission(le, v, k + 1)
                                  : emission(le, nv, 0);
        word |= viterbi_step(v0, v1, mt, e) << (2 * k);
        e = en;
      }
    } else {
      // e holds column 16g + k's pair at step k (column 0's pair is
      // spent on v's start)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const double2 en = k < 15 ? emission(le, v, k + 1)
                                  : emission(le, nv, 0);
        if ((g > 0 || k > 0) && 16 * g + k < L) {
          word |= viterbi_step(v0, v1, mt, e) << (2 * k);
        }
        e = en;
      }
    }
    P[g] = word;
    word = 0u;
    if (++g == groups) break;
    v = nv;
    nv = g + 1 < groups ? o4[g + 1] : v;
  }
  return __dadd_rn(v1, mt.lstop[1]) > __dadd_rn(v0, mt.lstop[0]) ? 1 : 0;
}

// The path bytes of one group of 16 columns (1 where the state is 0),
// from state s at its column k = n - 1 down to column 0 over its pointer
// word w: a shift and a mask a column to the column before, no branch.
// Returns the bytes and leaves s at the column before the group.
__device__ __forceinline__ uint4 walk_group(unsigned w, int n, int& s) {
  unsigned b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 15; k >= 0; --k) {
    if (k < n) {
      b[k >> 2] |= (unsigned)(s ^ 1) << (8 * (k & 3));
      s = (int)(((w >> (2 * k)) >> s) & 1u);
    }
  }
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// The walk back of a row of L >= 1 columns from state s at column L - 1
// over its pointer words P: path bytes written 16 at a time to out for
// every group of the row, zeros past L.  The row's last group first
// (the only one it may not fill), then the full groups kWalkAhead at a
// time: slot j of the word ring holds the word of the group j below the
// round's first and is reloaded in place with the word kWalkAhead
// groups further down, so no register waits on a load issued a group
// earlier.  P was written in this launch, so it is read by plain
// (coherent) loads, not through the read-only path a const __restrict__
// pointer may take.
__device__ __forceinline__ void viterbi_walk(const unsigned* P, int L, int s,
                                             unsigned char* __restrict__ out) {
  const int last = (L - 1) >> 4;
  uint4* out4 = reinterpret_cast<uint4*>(out);
  unsigned q[kWalkAhead];
#pragma unroll
  for (int j = 0; j < kWalkAhead; ++j) {
    q[j] = last - 1 - j >= 0 ? P[last - 1 - j] : 0u;
  }
  out4[last] = walk_group(P[last], L - 16 * last, s);
  for (int g = last - 1; g >= 0; g -= kWalkAhead) {
#pragma unroll
    for (int j = 0; j < kWalkAhead; ++j) {
      if (g - j >= 0) {
        const unsigned w = q[j];
        q[j] = g - j - kWalkAhead >= 0 ? P[g - j - kWalkAhead] : 0u;
        out4[g - j] = walk_group(w, 16, s);
      }
    }
  }
}

// K20: row r = blockIdx.x * kViterbiRows + threadIdx.x of the ragged
// layout (offsets ascending, each row's extent up to the next row's
// offset, the last row's up to total); every byte of the extent written.
__global__ void __launch_bounds__(kViterbiRows)
    viterbi_rows_kernel(const unsigned char* __restrict__ obs,
                        const int64_t* __restrict__ offsets,
                        const int* __restrict__ lengths, int N,
                        int64_t total, HmmMats mt,
                        unsigned* __restrict__ ptr,
                        unsigned char* __restrict__ path) {
  __shared__ double2 le[8];
  fill_emissions(mt, le);
  const int r = blockIdx.x * kViterbiRows + threadIdx.x;
  if (r >= N) return;
  const int64_t off = offsets[r];
  const int64_t end = r + 1 < N ? offsets[r + 1] : total;
  const int L = lengths[r];
  const int groups = L > 0 ? (L + 15) >> 4 : 0;
  uint4* out4 = reinterpret_cast<uint4*>(path + off);
  for (int64_t g = groups; g < ((end - off) >> 4); ++g) {
    out4[g] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (L <= 0) return;
  unsigned* P = ptr + (off >> 4);
  const int s = viterbi_forward(obs + off, L, mt, le, P);
  viterbi_walk(P, L, s, path + off);
}

// K20's step measured on one row: clock64 around its forward pass on one
// thread and around its walk.
__global__ void viterbi_step_cycles_kernel(const unsigned char* __restrict__ o,
                                           int L, HmmMats mt,
                                           unsigned* __restrict__ P,
                                           unsigned char* __restrict__ out,
                                           long long* __restrict__ cycles) {
  __shared__ double2 le[8];
  fill_emissions(mt, le);
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    const int s = viterbi_forward(o, L, mt, le, P);
    const long long t1 = clock64();
    viterbi_walk(P, L, s, out);
    const long long t2 = clock64();
    cycles[0] = t1 - t0;
    cycles[1] = t2 - t1;
  }
}

HmmMats make_mats(const double* mats) {
  HmmMats mt;
  for (int k = 0; k < 2; ++k) mt.ls[k] = mats[k];
  for (int k = 0; k < 4; ++k) mt.lt[k] = mats[2 + k];
  for (int k = 0; k < 2; ++k) mt.lstop[k] = mats[6 + k];
  for (int k = 0; k < 16; ++k) mt.le[k] = mats[8 + k];
  return mt;
}

constexpr int kHmmThreads = 64;

inline unsigned hmm_blocks(int B) {
  return (unsigned)((B + kHmmThreads - 1) / kHmmThreads);
}

// Phases 1 and 2 of the chunked route; returns the carries and logP
// inside scan (transfers, then carries, then logP).
void launch_scan_fold(const void* obs, const void* lengths, int B, int T,
                      const HmmMats& mt, double* scan, cudaStream_t st,
                      double** carry, double** logp) {
  const int nct = T / kScanCols;
  double* xfer = scan;
  *carry = scan + (int64_t)B * nct * kCarry;
  *logp = *carry + (int64_t)B * nct * kCarry;
  const unsigned chunks = (unsigned)((int64_t)B * nct / kScanThreads);
  LM_LAUNCH(scan_transfer_kernel, dim3(chunks, 2), kScanThreads, 0, st,
            (const unsigned char*)obs, (const int*)lengths, B, T, mt, xfer);
  LM_LAUNCH(scan_fold_kernel, dim3(hmm_blocks(B), 2), kHmmThreads, 0, st,
            (const int*)lengths, B, nct, mt, xfer, *carry, *logp);
}

}  // namespace

// Doubles of the chunked route's scratch: transfers and carries (8 a
// chunk each), logP (2 a row), and `counts` a chunk (K21: 22, K8: 0).
extern "C" int64_t lm_hmm_scan_doubles(int B, int T, int counts) {
  return (int64_t)B * (T / kScanCols) * (2 * kCarry + counts) +
         2 * (int64_t)B;
}

// K8's chunked route.  obs: uint8[B, T] symbols 0..7 (16-byte
// aligned; T >= kScanMinT, a multiple of kScanCols * kScanThreads);
// lengths: int32[B] (<= T); mats: HOST doubles ls[2], lt[4], lstop[2],
// le[16]; post: f64[B, T] or null; calls: uint8[B, T]; fwd: f64[B, T]
// scratch; scan: f64 scratch of lm_hmm_scan_doubles(B, T, 0).  Columns at
// or past a row's length are left as they are.
extern "C" int lm_hmm_fb(const void* obs, const void* lengths, int B, int T,
                         const double* mats, double threshold, void* fwd,
                         void* post, void* calls, void* scan, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (scan == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const HmmMats mt = make_mats(mats);
  double *carry, *logp;
  launch_scan_fold(obs, lengths, B, T, mt, (double*)scan, st, &carry, &logp);
  const unsigned chunks = (unsigned)((int64_t)B * (T / kScanCols) /
                                     kScanThreads);
  LM_LAUNCH(scan_post_kernel, chunks, kScanThreads, 0, st,
            (const unsigned char*)obs, (const int*)lengths, B, T, mt,
            threshold, carry, logp, (double*)fwd, (double*)post,
            (unsigned char*)calls);
  return (int)cudaGetLastError();
}

// K8's sequential route, N rows in one launch.  obs: uint8 symbols 0..7,
// row r at obs + offsets[r] (int64, ascending, multiples of 16 from a
// 16-byte aligned obs) with lengths[r] (int32) columns, readable up to
// the next multiple of 16; total: the layout's columns, every row's span
// inside them.  mats as for lm_hmm_fb; fb: f64[2 * total] scratch; logp:
// f64[N] scratch; post: f64[total] or null; calls: uint8[total].  Every
// column of the layout is written: a row's posterior and call below its
// length, 0 elsewhere.
extern "C" int lm_hmm_fb_rows(const void* obs, const void* offsets,
                              const void* lengths, int N, int64_t total,
                              const double* mats, double threshold, void* fb,
                              void* logp, void* post, void* calls,
                              void* stream) {
  if (N <= 0 || total <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  LM_LAUNCH(fb_chain_kernel,
            2u * (unsigned)((N + kChainRows - 1) / kChainRows), 32, 0, st,
            (const unsigned char*)obs, (const int64_t*)offsets, (const int*)lengths, N, total,
            make_mats(mats), (double*)fb, (double*)logp);
  LM_LAUNCH(fb_post_kernel, lm::blocks_for(total), lm::kTableThreads, 0, st,
            (const int64_t*)offsets, (const int*)lengths, N, total,
            (const double*)fb, (const double*)logp, threshold,
            (double*)post, (unsigned char*)calls);
  return (int)cudaGetLastError();
}

// The sequential chains' cycles on one pair of lanes: obs a row of L >= 2
// symbols as lm_hmm_fb_rows reads one; fb: f64[2 * stride + 1] scratch,
// stride >= L; cycles: int64[2], the forward chain's and the backward
// chain's (L - 1 steps each).
extern "C" int lm_hmm_step_cycles(const void* obs, int L, int64_t stride,
                                  const double* mats, void* fb, void* cycles,
                                  void* stream) {
  LM_LAUNCH(fb_step_cycles_kernel, 1, 2, 0, (cudaStream_t)stream,
            (const unsigned char*)obs, L, stride, make_mats(mats),
            (double*)fb, (long long*)cycles);
  return (int)cudaGetLastError();
}

// K20, N rows in one launch.  obs: uint8 symbols 0..7, row r at obs +
// offsets[r] (int64, ascending, multiples of 16 from a 16-byte aligned
// obs) with lengths[r] (int32, 0 allowed) columns, readable up to the
// next multiple of 16; each row's extent, its columns rounded up to 16,
// lies below the next row's offset, the last row's below total (a
// multiple of 16).  mats as for lm_hmm_fb; ptr: uint32[total / 16]
// scratch; path: uint8[total], every byte of the rows' extents written
// (1 = homologous, 0 past a row's length).
extern "C" int lm_hmm_viterbi_rows(const void* obs, const void* offsets,
                                   const void* lengths, int N, int64_t total,
                                   const double* mats, void* ptr, void* path,
                                   void* stream) {
  if (N > 0) {
    LM_LAUNCH(viterbi_rows_kernel,
              (unsigned)((N + kViterbiRows - 1) / kViterbiRows),
              kViterbiRows, 0, (cudaStream_t)stream,
              (const unsigned char*)obs, (const int64_t*)offsets,
              (const int*)lengths, N, total, make_mats(mats),
              (unsigned*)ptr, (unsigned char*)path);
  }
  return (int)cudaGetLastError();
}

// K20's step on one row: obs a row of L >= 2 symbols as
// lm_hmm_viterbi_rows reads one; ptr: uint32[ceil(L / 16)] and path:
// uint8[16 ceil(L / 16)] scratch; cycles: int64[2], the forward pass and
// the walk on one thread (L - 1 steps each).
extern "C" int lm_hmm_viterbi_step_cycles(const void* obs, int L,
                                          const double* mats, void* ptr,
                                          void* path, void* cycles,
                                          void* stream) {
  LM_LAUNCH(viterbi_step_cycles_kernel, 1, 1, 0, (cudaStream_t)stream,
            (const unsigned char*)obs, L, make_mats(mats), (unsigned*)ptr,
            (unsigned char*)path, (long long*)cycles);
  return (int)cudaGetLastError();
}

// K21.  obs, lengths, mats as for lm_hmm_fb; fwd, bwd: f64[B, T, 2]
// scratch; part: f64[B, 23] per-sequence counts (start[2], trans[2][2],
// emit[2][8], logP; zero for a row of length 0).  scan null: the
// sequential route, at any T; non-null: the chunked route (T as for
// lm_hmm_fb), scan f64 scratch of lm_hmm_scan_doubles(B, T, 22).
extern "C" int lm_hmm_bw(const void* obs, const void* lengths, int B, int T,
                         const double* mats, void* fwd, void* bwd,
                         void* part, void* scan, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const HmmMats mt = make_mats(mats);
  if (scan == nullptr) {
    LM_LAUNCH(bw_kernel, hmm_blocks(B), kHmmThreads, 0, st,
              (const unsigned char*)obs, (const int*)lengths, B, T, mt,
              (double*)fwd, (double*)bwd, (double*)part);
    return (int)cudaGetLastError();
  }
  double *carry, *logp;
  launch_scan_fold(obs, lengths, B, T, mt, (double*)scan, st, &carry, &logp);
  const int nct = T / kScanCols;
  double* cpart = logp + 2 * (int64_t)B;
  const unsigned chunks = (unsigned)((int64_t)B * nct / kScanThreads);
  LM_LAUNCH(scan_bw_kernel, chunks, kScanThreads, 0, st,
            (const unsigned char*)obs, (const int*)lengths, B, T, mt, carry,
            logp, (double2*)fwd, (double2*)bwd, cpart);
  const int64_t outs = (int64_t)B * kBwCounts;
  LM_LAUNCH(scan_bw_reduce_kernel,
            (unsigned)((outs + kScanThreads - 1) / kScanThreads),
            kScanThreads, 0, st, (const int*)lengths, B, nct, cpart, logp,
            (double*)part);
  return (int)cudaGetLastError();
}
