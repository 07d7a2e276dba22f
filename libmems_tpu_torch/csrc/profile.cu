// K3: profile-profile Gotoh forward DP with pointer bytes, and K9: the
// same forward without pointers (the score only), one thread block per
// window.
//
// K3 replaces libmems_tpu/ops/profile.py _full_ptr_tb / _full_ptr_tb_jit
// (the lax.scan over rows of _profile_row_fn with emit_ptr=True, which
// materialises uint8[B, M, N+1] pointers on the TPU).  K9 replaces
// profile_forward_ckpt in the form profile_scores_batch calls it (K = Mp:
// the checkpoints are discarded, only the score float32[B] is fetched).
// Both are one template: K9 compiles the pointer and flag writes out, so
// its score equals K3's bit for bit.
//
// Bound: the row recurrence.  Each of a window's p_len rows depends on
// the previous one, and within a row E needs a prefix maximum over the
// columns, so a row costs three barriers and one block scan whatever its
// width; per cell it reads 5 qw floats and K3 writes one pointer byte.
// Design: threads across columns j, a loop over rows i.  The window's
// H (double-buffered), F, scan and flag rows live in shared memory when
// 17*(N+1) bytes fit (every window up to the 10,000-column cap does),
// otherwise in global scratch the wrapper allocates.  qw = q.W5^T,
// ext_q and ext_cum are computed once per window into global scratch.
//
// Arithmetic and tie order copy ops/profile.py:49-93 exactly:
//   F = max((H_prev + open) + ext_p, F_prev + ext_p)
//   g = max(H_prev[j-1] + p.qw[j-1], F)            (column 0: g = F)
//   E[j] = ext_cum[j] + max_{k<j}((g[k] + open) - ext_cum[k])
//   H = max(g, E);  pointer: H_DIAG before H_E before H_F,
//   F extend bit iff F == F_prev + ext_p and F_prev > NEG_BIG/2,
//   E extend bit iff E[j] == E[j-1] + ext_q[j-1]   (j >= 2).
// E is the same max-scan formula as the JAX code, not a left-to-right E
// recurrence, so fractional profiles keep the same structure of float
// operations.  Only rows 1..p_len and columns 0..q_len are written: the
// traceback never reads past them (the wrapper zero-fills the rest).
//
// Rounding: multi-row profiles hold fractions (1/3, 1/7), so the order
// of float operations decides ties in the pointer choice.  Every product
// and sum below is an explicit round-to-nearest intrinsic, never
// contracted by the compiler, in the order of the plain version
// (ops/profile.py):
//   qw[y][j] = ((q0 w_y0 + q1 w_y1) + (q2 w_y2 + q3 w_y3)) + q4 w_y4
//   s        = fma(p4, qw4, fma(p3, qw3, fma(p2, qw2, fma(p1, qw1, p0 qw0))))
//   ext_cum  = the JAX CPU cumsum order: sequential within blocks of 16,
//              the block totals' prefix (the same, recursively) added on.
#include "common.cuh"

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned char kHDiag = 0, kHE = 1, kHF = 2, kEExt = 4, kFExt = 8;
constexpr unsigned char kIsDiag = 1;  // flag: g came from the diagonal

template <bool kPtr>
__global__ void profile_fwd_kernel(
    const float* __restrict__ p, const float* __restrict__ q,
    const int* __restrict__ p_len, const int* __restrict__ q_len,
    float* __restrict__ qw, float* __restrict__ ext_q,
    float* __restrict__ ext_cum, float* __restrict__ cum_lv,
    int64_t cum_lv_stride, float* __restrict__ rows,
    unsigned char* __restrict__ flags, unsigned char* __restrict__ ptr,
    float* __restrict__ score, int M, int N, float gap_open,
    float gap_extend, lm::W5 w5) {
  extern __shared__ float lm_smem[];
  __shared__ float s_tmp[lm::kScanTmp];
  __shared__ float s_p[5];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n1 = N + 1;
  const int pl = p_len[b];
  const int ql = q_len[b];

  float* row_base = rows != nullptr ? rows + (int64_t)b * 4 * n1 : lm_smem;
  unsigned char* fl =
      rows != nullptr ? flags + (int64_t)b * n1
                      : reinterpret_cast<unsigned char*>(lm_smem + 4 * n1);
  float* Hp = row_base;
  float* Hc = row_base + n1;
  float* F = row_base + 2 * n1;
  float* Wv = row_base + 3 * n1;

  const float* qb = q + (int64_t)b * N * 5;
  float* qwb = qw + (int64_t)b * 5 * N;
  float* eq = ext_q + (int64_t)b * N;
  float* ec = ext_cum + (int64_t)b * n1;

  // per-window setup: qw[y][j] = sum_x q[j][x] * W5[y][x], ext_q, ext_cum
  lm::profile_q_setup(qb, qwb, eq, ql, N, gap_extend, w5);
  __syncthreads();
  lm::blocked_cumsum(eq, ec + 1, ql, cum_lv + (int64_t)b * cum_lv_stride);
  if (tid == 0) ec[0] = 0.f;
  __syncthreads();
  for (int c = tid; c <= ql; c += nt) {
    Hp[c] = c == 0 ? 0.f : gap_open + ec[c];
    F[c] = kNegBig;
  }
  __syncthreads();

  // contiguous column chunk per thread for the row's max-scan
  const int per = (ql + 1 + nt - 1) / nt;
  const int c_lo = tid * per;
  const int c_hi = min(c_lo + per, ql + 1);

  for (int i = 1; i <= pl; ++i) {
    if (tid < 5) s_p[tid] = p[((int64_t)b * M + (i - 1)) * 5 + tid];
    __syncthreads();
    const float ext_pi = __fmul_rn(gap_extend, __fsub_rn(1.0f, s_p[4]));

    // pass 1: F, the non-E candidate g, and the scan input W
    for (int c = tid; c <= ql; c += nt) {
      const float hp = Hp[c];
      const float fp = F[c];
      const float fo = (hp + gap_open) + ext_pi;
      const float fe = fp + ext_pi;
      const float f = fmaxf(fo, fe);
      unsigned char fc = (f == fe && fp > kNegBig / 2) ? kFExt : 0;
      F[c] = f;
      float g = f;
      if (c > 0) {
        const float diag = Hp[c - 1] + lm::profile_row_score(s_p, qwb, N,
                                                             c - 1);
        g = fmaxf(diag, f);
        if (g == diag) fc |= kIsDiag;
      }
      Hc[c] = g;
      Wv[c] = (g + gap_open) - ec[c];
      if (kPtr) fl[c] = fc;
    }
    __syncthreads();

    // exclusive running max of W over columns 0..ql, in place
    float run = -INFINITY;
    for (int c = c_lo; c < c_hi; ++c) run = fmaxf(run, Wv[c]);
    float pre = lm::block_scan(run, -INFINITY, lm::MaxOp(), s_tmp).excl;
    for (int c = c_lo; c < c_hi; ++c) {
      const float w = Wv[c];
      Wv[c] = pre;
      pre = fmaxf(pre, w);
    }
    __syncthreads();

    // pass 2: E, H and (K3) the pointer byte
    unsigned char* prow = kPtr ? ptr + ((int64_t)b * M + (i - 1)) * n1
                               : nullptr;
    for (int c = tid; c <= ql; c += nt) {
      if (c == 0) {
        // H[i][0] = F[i][0], already in Hc
        if (kPtr) prow[0] = kHF | (fl[0] & kFExt);
        continue;
      }
      const float e = ec[c] + Wv[c];
      const float g = Hc[c];
      const float h = fmaxf(g, e);
      if (kPtr) {
        const unsigned char fc = fl[c];
        const unsigned char src =
            ((fc & kIsDiag) && h == g) ? kHDiag : (h == e ? kHE : kHF);
        unsigned char out = src | (fc & kFExt);
        if (c >= 2 && e == (ec[c - 1] + Wv[c - 1]) + eq[c - 1]) out |= kEExt;
        prow[c] = out;
      }
      Hc[c] = h;
    }
    __syncthreads();
    float* t = Hp;
    Hp = Hc;
    Hc = t;
  }
  if (tid == 0) score[b] = Hp[ql];
}

template <bool kPtr>
int launch_profile(const void* p, const void* q, const void* p_len,
                   const void* q_len, void* qw, void* ext_q, void* ext_cum,
                   void* cum_lv, void* rows, void* flags, void* ptr,
                   void* score, int B, int M, int N, float gap_open,
                   float gap_extend, const float* w5, void* stream) {
  lm::W5 w;
  for (int k = 0; k < 25; ++k) w.w[k] = w5[k];
  int threads = ((N + 1 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const int64_t smem = rows != nullptr ? 0 : (int64_t)17 * (N + 1);
  const cudaError_t err = lm::allow_dyn_smem(profile_fwd_kernel<kPtr>, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    LM_LAUNCH(profile_fwd_kernel<kPtr>, (unsigned)B, threads, (size_t)smem,
              (cudaStream_t)stream, (const float*)p, (const float*)q,
              (const int*)p_len, (const int*)q_len, (float*)qw,
              (float*)ext_q, (float*)ext_cum, (float*)cum_lv,
              lm::cum_scratch(N), (float*)rows, (unsigned char*)flags,
              (unsigned char*)ptr, (float*)score, M, N, gap_open, gap_extend,
              w);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory one window's rows need at N columns.
extern "C" int64_t lm_profile_row_bytes(int N) {
  return (int64_t)17 * (N + 1);
}

// Floats of cumsum scratch one window needs for n elements.
extern "C" int64_t lm_profile_cum_scratch(int n) { return lm::cum_scratch(n); }

// K3.  p: f32[B, M, 5]; q: f32[B, N, 5]; p_len, q_len: int32[B];
// qw: f32[B, 5, N], ext_q: f32[B, N], ext_cum: f32[B, N+1], cum_lv:
// f32[B, lm_profile_cum_scratch(N)] (scratch);
// rows: f32[B, 4, N+1] and flags: uint8[B, N+1] global row scratch, or
// both null to keep the rows in shared memory; ptr: uint8[B, M, N+1]
// (zero-filled by the caller); score: f32[B]; w5: HOST float[25].
extern "C" int lm_profile_fwd(const void* p, const void* q, const void* p_len,
                              const void* q_len, void* qw, void* ext_q,
                              void* ext_cum, void* cum_lv, void* rows,
                              void* flags, void* ptr, void* score, int B,
                              int M, int N, float gap_open, float gap_extend,
                              const float* w5, void* stream) {
  return launch_profile<true>(p, q, p_len, q_len, qw, ext_q, ext_cum, cum_lv,
                              rows, flags, ptr, score, B, M, N, gap_open,
                              gap_extend, w5, stream);
}

// K9: the arguments of lm_profile_fwd without flags and ptr; rows:
// f32[B, 4, N+1] or null.
extern "C" int lm_profile_score(const void* p, const void* q,
                                const void* p_len, const void* q_len,
                                void* qw, void* ext_q, void* ext_cum,
                                void* cum_lv, void* rows, void* score, int B,
                                int M, int N, float gap_open,
                                float gap_extend, const float* w5,
                                void* stream) {
  return launch_profile<false>(p, q, p_len, q_len, qw, ext_q, ext_cum,
                               cum_lv, rows, nullptr, nullptr, score, B, M, N,
                               gap_open, gap_extend, w5, stream);
}
