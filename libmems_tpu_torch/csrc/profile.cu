// K3: profile-profile Gotoh forward DP with pointer bytes, one thread
// block per window.
//
// Replaces libmems_tpu/ops/profile.py _full_ptr_tb / _full_ptr_tb_jit
// (the lax.scan over rows of _profile_row_fn with emit_ptr=True, which
// materialises uint8[B, M, N+1] pointers on the TPU).
//
// Bound: the row recurrence.  Each of a window's p_len rows depends on
// the previous one, and within a row E needs a prefix maximum over the
// columns, so a row costs three barriers and one block scan whatever its
// width; per cell it reads 5 qw floats and writes one pointer byte.
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
#include "common.cuh"

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned char kHDiag = 0, kHE = 1, kHF = 2, kEExt = 4, kFExt = 8;
constexpr unsigned char kIsDiag = 1;  // flag: g came from the diagonal
constexpr int kMaxDynSmem = 227 * 1024;

struct W5 {
  float w[25];
};

__global__ void profile_fwd_kernel(
    const float* __restrict__ p, const float* __restrict__ q,
    const int* __restrict__ p_len, const int* __restrict__ q_len,
    float* __restrict__ qw, float* __restrict__ ext_q,
    float* __restrict__ ext_cum, float* __restrict__ rows,
    unsigned char* __restrict__ flags, unsigned char* __restrict__ ptr,
    float* __restrict__ score, int M, int N, float gap_open,
    float gap_extend, W5 w5) {
  extern __shared__ float lm_smem[];
  __shared__ float s_tmp[32];
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
  for (int j = tid; j < ql; j += nt) {
    float qv[5];
    for (int x = 0; x < 5; ++x) qv[x] = qb[j * 5 + x];
    for (int y = 0; y < 5; ++y) {
      float s = 0.f;
      for (int x = 0; x < 5; ++x) s += qv[x] * w5.w[y * 5 + x];
      qwb[y * N + j] = s;
    }
    eq[j] = gap_extend * (1.0f - qv[4]);
  }
  __syncthreads();
  float carry = 0.f;
  for (int j0 = 0; j0 < ql; j0 += nt) {
    const int j = j0 + tid;
    const float v = j < ql ? eq[j] : 0.f;
    const lm::ScanResult<float> r = lm::block_scan(v, 0.f, lm::SumOp(), s_tmp);
    if (j < ql) ec[j + 1] = carry + r.incl;
    carry += r.total;
  }
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
    const float p0 = s_p[0], p1 = s_p[1], p2 = s_p[2], p3 = s_p[3],
                p4 = s_p[4];
    const float ext_pi = gap_extend * (1.0f - p4);

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
        const int j = c - 1;
        const float s = p0 * qwb[j] + p1 * qwb[N + j] + p2 * qwb[2 * N + j] +
                        p3 * qwb[3 * N + j] + p4 * qwb[4 * N + j];
        const float diag = Hp[c - 1] + s;
        g = fmaxf(diag, f);
        if (g == diag) fc |= kIsDiag;
      }
      Hc[c] = g;
      Wv[c] = (g + gap_open) - ec[c];
      fl[c] = fc;
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

    // pass 2: E, H and the pointer byte
    unsigned char* prow = ptr + ((int64_t)b * M + (i - 1)) * n1;
    for (int c = tid; c <= ql; c += nt) {
      const unsigned char fc = fl[c];
      if (c == 0) {
        prow[0] = kHF | (fc & kFExt);  // H[i][0] = F[i][0], already in Hc
        continue;
      }
      const float e = ec[c] + Wv[c];
      const float g = Hc[c];
      const float h = fmaxf(g, e);
      const unsigned char src =
          ((fc & kIsDiag) && h == g) ? kHDiag : (h == e ? kHE : kHF);
      unsigned char out = src | (fc & kFExt);
      if (c >= 2 && e == (ec[c - 1] + Wv[c - 1]) + eq[c - 1]) out |= kEExt;
      Hc[c] = h;
      prow[c] = out;
    }
    __syncthreads();
    float* t = Hp;
    Hp = Hc;
    Hc = t;
  }
  if (tid == 0) score[b] = Hp[ql];
}

}  // namespace

// Bytes of shared memory one window's rows need at N columns.
extern "C" int64_t lm_profile_row_bytes(int N) {
  return (int64_t)17 * (N + 1);
}

// p: f32[B, M, 5]; q: f32[B, N, 5]; p_len, q_len: int32[B];
// qw: f32[B, 5, N], ext_q: f32[B, N], ext_cum: f32[B, N+1] (scratch);
// rows: f32[B, 4, N+1] and flags: uint8[B, N+1] global row scratch, or
// both null to keep the rows in shared memory; ptr: uint8[B, M, N+1]
// (zero-filled by the caller); score: f32[B]; w5: HOST float[25].
extern "C" int lm_profile_fwd(const void* p, const void* q, const void* p_len,
                              const void* q_len, void* qw, void* ext_q,
                              void* ext_cum, void* rows, void* flags,
                              void* ptr, void* score, int B, int M, int N,
                              float gap_open, float gap_extend,
                              const float* w5, void* stream) {
  W5 w;
  for (int k = 0; k < 25; ++k) w.w[k] = w5[k];
  int threads = ((N + 1 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const int64_t smem = rows != nullptr ? 0 : lm_profile_row_bytes(N);
  if (smem > kMaxDynSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        profile_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0) {
    LM_LAUNCH(profile_fwd_kernel, (unsigned)B, threads, (size_t)smem,
              (cudaStream_t)stream, (const float*)p, (const float*)q,
              (const int*)p_len, (const int*)q_len, (float*)qw,
              (float*)ext_q, (float*)ext_cum, (float*)rows,
              (unsigned char*)flags, (unsigned char*)ptr, (float*)score, M,
              N, gap_open, gap_extend, w);
  }
  return (int)cudaGetLastError();
}
