// K8: HomologyHMM forward/backward -> posterior P(homologous) and calls.
//
// Replaces libmems_tpu/ops/hmm.py _fb_posterior (:139), _fb_posterior_ckpt
// (:186), _fb_calls_small (:479), _fb_calls_ckpt (:465) and
// _fb_calls_assoc (:295).  The JAX package ran three tiers by length (an
// f64 scan, a checkpointed f64 scan, and an f32 associative scan from
// 2^17 columns on); here every length runs in f64, on two routes that
// the launch's padded width T chooses (the wrapper passes the scan's
// scratch from T >= kScanMinT on):
//
// The sequential route (T < kScanMinT = 2^17, fb_kernel).  Bound:
// latency.  The 2-state log-space recurrence is sequential along a
// sequence, one step costing two log-sum-exps (an exp and a log each) of
// f64, so a sequence runs in one thread, column after column; many
// sequences (every genome pair of every interval) run side by side.  The
// forward values of a sequence are kept in global memory (16 bytes per
// column) and read back by the backward sweep, which writes the
// posterior and the call; the wrapper splits a batch so that this
// scratch stays under a byte budget.
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
// K20 (viterbi_kernel) replaces _viterbi_path (ops/hmm.py:531) and K21
// replaces _bw_counts (ops/hmm.py:603).  K20 takes K8's sequential shape
// at every length: one thread a sequence, f64, the same HmmMats, bound by
// the latency of the column recurrence.
//   K20: for each state `to`, cand[k] = v[k] + lt[k][to], ptr = the first
//        argmax, v[to] = max + le[to][o_i]; the two pointer bits of a
//        column go to a byte of scratch; the end state is the first argmax
//        of v + lstop and the walk back writes True (homologous) where the
//        state is 0.  Columns at or past the length stay as the caller
//        zero-filled them.
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

__global__ void fb_kernel(const unsigned char* __restrict__ obs,
                          const int* __restrict__ lengths, int B, int T,
                          HmmMats mt, double threshold,
                          double* __restrict__ fwd,
                          double* __restrict__ post,
                          unsigned char* __restrict__ calls) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int L = lengths[b];
  if (L <= 0) return;
  const unsigned char* o = obs + (int64_t)b * T;
  double* F = fwd + (int64_t)b * T * 2;
  double* P = post != nullptr ? post + (int64_t)b * T : nullptr;
  unsigned char* C = calls + (int64_t)b * T;

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
  double p = exp((F[2 * (L - 1)] + b0) - logp);
  if (P != nullptr) P[L - 1] = p;
  C[L - 1] = p >= threshold ? 1 : 0;
  for (int i = L - 2; i >= 0; --i) {
    sym = o[i + 1];
    const double t0 = mt.le[sym] + b0;
    const double t1 = mt.le[8 + sym] + b1;
    const double n0 = lse2(mt.lt[0] + t0, mt.lt[1] + t1);
    const double n1 = lse2(mt.lt[2] + t0, mt.lt[3] + t1);
    b0 = n0;
    b1 = n1;
    p = exp((F[2 * i] + b0) - logp);
    if (P != nullptr) P[i] = p;
    C[i] = p >= threshold ? 1 : 0;
  }
}

__global__ void viterbi_kernel(const unsigned char* __restrict__ obs,
                               const int* __restrict__ lengths, int B, int T,
                               HmmMats mt, unsigned char* __restrict__ ptr,
                               unsigned char* __restrict__ path) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int L = lengths[b];
  if (L <= 0) return;
  const unsigned char* o = obs + (int64_t)b * T;
  unsigned char* P = ptr + (int64_t)b * T;
  unsigned char* out = path + (int64_t)b * T;

  int sym = o[0];
  double v0 = mt.ls[0] + mt.le[sym];
  double v1 = mt.ls[1] + mt.le[8 + sym];
  for (int i = 1; i < L; ++i) {
    sym = o[i];
    const double c00 = v0 + mt.lt[0];
    const double c10 = v1 + mt.lt[2];
    const double c01 = v0 + mt.lt[1];
    const double c11 = v1 + mt.lt[3];
    const int p0 = c10 > c00 ? 1 : 0;
    const int p1 = c11 > c01 ? 1 : 0;
    v0 = (p0 ? c10 : c00) + mt.le[sym];
    v1 = (p1 ? c11 : c01) + mt.le[8 + sym];
    P[i] = (unsigned char)(p0 | (p1 << 1));
  }
  int s = (v1 + mt.lstop[1]) > (v0 + mt.lstop[0]) ? 1 : 0;
  out[L - 1] = s == 0;
  for (int i = L - 1; i >= 1; --i) {
    s = (P[i] >> s) & 1;
    out[i - 1] = s == 0;
  }
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

// obs: uint8[B, T] symbols 0..7 (16-byte aligned); lengths: int32[B]
// (<= T); mats: HOST doubles ls[2], lt[4], lstop[2], le[16]; post: f64[B,
// T] or null; calls: uint8[B, T].  Columns at or past a row's length are
// left as they are.  scan null: the sequential route, fwd f64[B, T, 2]
// scratch.  scan non-null (T >= kScanMinT, T a multiple of kScanCols *
// kScanThreads): the chunked route, fwd f64[B, T] scratch and scan f64
// scratch of lm_hmm_scan_doubles(B, T, 0).
extern "C" int lm_hmm_fb(const void* obs, const void* lengths, int B, int T,
                         const double* mats, double threshold, void* fwd,
                         void* post, void* calls, void* scan, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const HmmMats mt = make_mats(mats);
  if (scan == nullptr) {
    LM_LAUNCH(fb_kernel, hmm_blocks(B), kHmmThreads, 0, st,
              (const unsigned char*)obs, (const int*)lengths, B, T, mt,
              threshold, (double*)fwd, (double*)post, (unsigned char*)calls);
    return (int)cudaGetLastError();
  }
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

// K20.  obs, lengths, mats as for lm_hmm_fb; ptr: uint8[B, T] scratch;
// path: uint8[B, T], zero-filled by the caller (1 = homologous).
extern "C" int lm_hmm_viterbi(const void* obs, const void* lengths, int B,
                              int T, const double* mats, void* ptr,
                              void* path, void* stream) {
  if (B > 0) {
    LM_LAUNCH(viterbi_kernel, hmm_blocks(B), kHmmThreads, 0,
              (cudaStream_t)stream, (const unsigned char*)obs,
              (const int*)lengths, B, T, make_mats(mats),
              (unsigned char*)ptr, (unsigned char*)path);
  }
  return (int)cudaGetLastError();
}

// K21.  obs, lengths, mats as for lm_hmm_fb; fwd, bwd: f64[B, T, 2]
// scratch; part: f64[B, 23] per-sequence counts (start[2], trans[2][2],
// emit[2][8], logP; zero for a row of length 0).  scan null: the
// sequential route; non-null: the chunked route (as for lm_hmm_fb), scan
// f64 scratch of lm_hmm_scan_doubles(B, T, 22).
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
