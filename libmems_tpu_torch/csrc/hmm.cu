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

}  // namespace

// obs: uint8[B, T] symbols 0..7; lengths: int32[B] (<= T); mats: HOST
// doubles ls[2], lt[4], lstop[2], le[16]; fwd: f64[B, T, 2] scratch;
// post: f64[B, T] or null; calls: uint8[B, T].  Columns at or past a
// row's length are left as they are.
extern "C" int lm_hmm_fb(const void* obs, const void* lengths, int B, int T,
                         const double* mats, double threshold, void* fwd,
                         void* post, void* calls, void* stream) {
  HmmMats mt;
  for (int k = 0; k < 2; ++k) mt.ls[k] = mats[k];
  for (int k = 0; k < 4; ++k) mt.lt[k] = mats[2 + k];
  for (int k = 0; k < 2; ++k) mt.lstop[k] = mats[6 + k];
  for (int k = 0; k < 16; ++k) mt.le[k] = mats[8 + k];
  const int threads = 64;
  if (B > 0) {
    LM_LAUNCH(fb_kernel, (unsigned)((B + threads - 1) / threads), threads, 0,
              (cudaStream_t)stream, (const unsigned char*)obs,
              (const int*)lengths, B, T, mt, threshold, (double*)fwd,
              (double*)post, (unsigned char*)calls);
  }
  return (int)cudaGetLastError();
}
