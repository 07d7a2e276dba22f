// K8: HomologyHMM forward/backward -> posterior P(homologous) and calls.
//
// Replaces libmems_tpu/ops/hmm.py _fb_posterior (:139), _fb_posterior_ckpt
// (:186), _fb_calls_small (:479), _fb_calls_ckpt (:465) and
// _fb_calls_assoc (:295).  The JAX package ran three tiers by length (an
// f64 scan, a checkpointed f64 scan, and an f32 associative scan from
// 2^17 columns on); here one kernel serves every length in f64.
//
// Bound: latency.  The 2-state log-space recurrence is sequential along a
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
// K20 (viterbi_kernel) replaces _viterbi_path (ops/hmm.py:531) and K21
// (bw_kernel) replaces _bw_counts (ops/hmm.py:603).  Both take K8's shape:
// one thread a sequence, f64, the same HmmMats, bound by the latency of
// the column recurrence.
//   K20: for each state `to`, cand[k] = v[k] + lt[k][to], ptr = the first
//        argmax, v[to] = max + le[to][o_i]; the two pointer bits of a
//        column go to a byte of scratch; the end state is the first argmax
//        of v + lstop and the walk back writes True (homologous) where the
//        state is 0.  Columns at or past the length stay as the caller
//        zero-filled them.
//   K21: the forward (kept in scratch, as K8), the backward (kept in
//        scratch too), logP; then, in column order, the expected counts:
//          gamma_t[k]    = exp((F_t[k] + B_t[k]) - logP)
//          xi_t[k][j]    = exp(((F_t[k] + lt[k][j])
//                               + (le[j][o_{t+1}] + B_{t+1}[j])) - logP)
//        into start (gamma_0), emission (gamma_t by o_t) and transition
//        (xi_t, t < L-1) counts: one row of 23 partial sums a sequence
//        (start[2], trans[4], emit[16], logP), which the wrapper sums over
//        sequences in index order on the host (no atomics).
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

}  // namespace

// obs: uint8[B, T] symbols 0..7; lengths: int32[B] (<= T); mats: HOST
// doubles ls[2], lt[4], lstop[2], le[16]; fwd: f64[B, T, 2] scratch;
// post: f64[B, T] or null; calls: uint8[B, T].  Columns at or past a
// row's length are left as they are.
extern "C" int lm_hmm_fb(const void* obs, const void* lengths, int B, int T,
                         const double* mats, double threshold, void* fwd,
                         void* post, void* calls, void* stream) {
  if (B > 0) {
    LM_LAUNCH(fb_kernel, hmm_blocks(B), kHmmThreads, 0, (cudaStream_t)stream,
              (const unsigned char*)obs, (const int*)lengths, B, T,
              make_mats(mats), threshold, (double*)fwd, (double*)post,
              (unsigned char*)calls);
  }
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
// emit[2][8], logP; zero for a row of length 0).
extern "C" int lm_hmm_bw(const void* obs, const void* lengths, int B, int T,
                         const double* mats, void* fwd, void* bwd,
                         void* part, void* stream) {
  if (B > 0) {
    LM_LAUNCH(bw_kernel, hmm_blocks(B), kHmmThreads, 0, (cudaStream_t)stream,
              (const unsigned char*)obs, (const int*)lengths, B, T,
              make_mats(mats), (double*)fwd, (double*)bwd, (double*)part);
  }
  return (int)cudaGetLastError();
}
