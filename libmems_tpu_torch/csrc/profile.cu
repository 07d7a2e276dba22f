// K3: profile-profile Gotoh forward DP with pointer bytes, K9: the same
// forward without pointers (the score only), K24: the forward with the
// (H, F) carry every K rows, and K25: the pointer bytes of a block of rows
// from such a carry; one thread block per window.
//
// K3 replaces libmems_tpu/ops/profile.py _full_ptr_tb / _full_ptr_tb_jit
// (the lax.scan over rows of _profile_row_fn with emit_ptr=True, which
// materialises uint8[B, M, N+1] pointers on the TPU).  K9 replaces
// profile_forward_ckpt in the form profile_scores_batch calls it (K = Mp:
// the checkpoints are discarded, only the score float32[B] is fetched).
// K24 replaces profile_forward_ckpt at K = 128 (ops/profile.py:116), the
// route of a bucket whose full pointer tensor exceeds the budget, and K25
// replaces profile_block_ptrs (:142) followed by pack_ptrs (ops/gapped.py
// :188): two 4-bit cells a byte, cell 2k in the low nibble.  All four are
// one template: K9 and K24 compile the pointer and flag writes out, so
// their scores equal K3's bit for bit, and K25 started from K24's carry
// at row bi*K gives K3's pointer bytes of rows bi*K+1 .. (bi+1)*K.
//
// Bound: the row recurrence.  Each of a window's rows depends on the
// previous one, and within a row E needs a prefix maximum over the
// columns, so a row costs three barriers and one block scan whatever its
// width; per cell it reads 5 qw floats, K3 and K25 write a pointer byte
// (K25 half of one) and K24 writes 8 bytes of carry every K rows.
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
// operations.  K3 and K9 compute rows 1..p_len and columns 0..q_len only:
// the traceback never reads past them (K3's wrapper zero-fills the
// rest).  K24 and K25 compute every row and column of the padded
// [M, N+1] matrix, as the JAX scan does, so the carries and pointer bytes
// equal the JAX arrays whole; a column's values never depend on a later
// column, so those inside the window are K3's.
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

struct ProfileArgs {
  const float* p;        // [B, M, 5] the profile rows computed
  const float* q;        // [B, N, 5]
  const int* p_len;      // [B], or null (K25)
  const int* q_len;      // [B]
  const float* h_in;     // K25: [B, N+1] carry at the rows' top; null:
  const float* f_in;     //   the DP's first row
  float* qw;             // [B, 5, N] scratch
  float* ext_q;          // [B, N] scratch
  float* ext_cum;        // [B, N+1] scratch
  float* cum_lv;         // [B, cum_scratch(N)] scratch
  float* rows;           // [B, 4, N+1] global row scratch, or null
  unsigned char* flags;  // [B, N+1] with rows when pointers are written
  unsigned char* ptr;    // K3: [B, M, N+1]; K25: [B, M, (N+2)/2]
  float* score;          // [B] H at (p_len, q_len), or null
  float* ck_h;           // K24: [M / K, B, N+1] carries, or null
  float* ck_f;
  int B, M, N, K;
  int full;              // every row 1..M and column 0..N (K24, K25)
  int packed;            // two pointer cells a byte (K25)
  float gap_open, gap_extend;
  lm::W5 w5;
};

template <bool kPtr>
__global__ void profile_fwd_kernel(ProfileArgs a) {
  extern __shared__ float lm_smem[];
  __shared__ float s_tmp[lm::kScanTmp];
  __shared__ float s_p[5];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int N = a.N;
  const int n1 = N + 1;
  const int pl = a.p_len != nullptr ? a.p_len[b] : 0;
  const int ql = a.q_len[b];
  // rows 1..row_hi and columns 0..chi are computed
  const int row_hi = a.full ? a.M : pl;
  const int chi = a.full ? N : ql;
  const float gap_open = a.gap_open;
  const float gap_extend = a.gap_extend;

  float* row_base = a.rows != nullptr ? a.rows + (int64_t)b * 4 * n1
                                      : lm_smem;
  unsigned char* fl =
      a.rows == nullptr ? reinterpret_cast<unsigned char*>(lm_smem + 4 * n1)
                        : (a.flags != nullptr ? a.flags + (int64_t)b * n1
                                              : nullptr);
  float* Hp = row_base;
  float* Hc = row_base + n1;
  float* F = row_base + 2 * n1;
  float* Wv = row_base + 3 * n1;

  const float* qb = a.q + (int64_t)b * N * 5;
  float* qwb = a.qw + (int64_t)b * 5 * N;
  float* eq = a.ext_q + (int64_t)b * N;
  float* ec = a.ext_cum + (int64_t)b * n1;

  // per-window setup: qw[y][j] = sum_x q[j][x] * W5[y][x], ext_q, ext_cum
  lm::profile_q_setup(qb, qwb, eq, chi, N, gap_extend, a.w5);
  __syncthreads();
  lm::blocked_cumsum(eq, ec + 1, chi,
                     a.cum_lv + (int64_t)b * lm::cum_scratch(N));
  if (tid == 0) ec[0] = 0.f;
  __syncthreads();
  for (int c = tid; c <= chi; c += nt) {
    if (a.h_in != nullptr) {
      Hp[c] = a.h_in[(int64_t)b * n1 + c];
      F[c] = a.f_in[(int64_t)b * n1 + c];
    } else {
      Hp[c] = c == 0 ? 0.f : gap_open + ec[c];
      F[c] = kNegBig;
    }
  }
  __syncthreads();
  if (a.full && a.score != nullptr && pl == 0 && tid == 0) {
    a.score[b] = Hp[ql];
  }

  // contiguous column chunk per thread for the row's max-scan
  const int per = (chi + 1 + nt - 1) / nt;
  const int c_lo = tid * per;
  const int c_hi = min(c_lo + per, chi + 1);
  const int64_t width = a.packed ? (N + 2) / 2 : n1;

  for (int i = 1; i <= row_hi; ++i) {
    if (a.ck_h != nullptr && (i - 1) % a.K == 0) {
      // K24: the carry at the top of block (i-1)/K; each thread stores
      // the columns it overwrites in pass 1 below
      const int64_t off = ((int64_t)((i - 1) / a.K) * a.B + b) * n1;
      for (int c = tid; c <= chi; c += nt) {
        a.ck_h[off + c] = Hp[c];
        a.ck_f[off + c] = F[c];
      }
    }
    if (tid < 5) s_p[tid] = a.p[((int64_t)b * a.M + (i - 1)) * 5 + tid];
    __syncthreads();
    const float ext_pi = __fmul_rn(gap_extend, __fsub_rn(1.0f, s_p[4]));

    // pass 1: F, the non-E candidate g, and the scan input W
    for (int c = tid; c <= chi; c += nt) {
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

    // exclusive running max of W over columns 0..chi, in place
    float run = -INFINITY;
    for (int c = c_lo; c < c_hi; ++c) run = fmaxf(run, Wv[c]);
    float pre = lm::block_scan(run, -INFINITY, lm::MaxOp(), s_tmp).excl;
    for (int c = c_lo; c < c_hi; ++c) {
      const float w = Wv[c];
      Wv[c] = pre;
      pre = fmaxf(pre, w);
    }
    __syncthreads();

    // pass 2: E, H and (K3, K25) the pointer byte.  Every thread runs the
    // same number of iterations, so a warp's lanes can pair their bytes.
    unsigned char* prow =
        kPtr ? a.ptr + ((int64_t)b * a.M + (i - 1)) * width : nullptr;
    for (int base = 0; base <= chi; base += nt) {
      const int c = base + tid;
      unsigned char out = 0;
      if (c == 0) {
        // H[i][0] = F[i][0], already in Hc
        if (kPtr) out = kHF | (fl[0] & kFExt);
      } else if (c <= chi) {
        const float e = ec[c] + Wv[c];
        const float g = Hc[c];
        const float h = fmaxf(g, e);
        if (kPtr) {
          const unsigned char fc = fl[c];
          const unsigned char src =
              ((fc & kIsDiag) && h == g) ? kHDiag : (h == e ? kHE : kHF);
          out = src | (fc & kFExt);
          if (c >= 2 && e == (ec[c - 1] + Wv[c - 1]) + eq[c - 1]) {
            out |= kEExt;
          }
        }
        Hc[c] = h;
      }
      if (kPtr) {
        if (a.packed) {
          // lane+1 holds column c+1 (blockDim is a multiple of 32, so
          // even columns sit on even lanes); past chi its byte is the
          // zero pad cell
          const unsigned hi = __shfl_down_sync(0xffffffffu, (unsigned)out, 1);
          if (c <= chi && !(c & 1)) {
            prow[c >> 1] = (unsigned char)(out | (hi << 4));
          }
        } else if (c <= chi) {
          prow[c] = out;
        }
      }
    }
    __syncthreads();
    float* t = Hp;
    Hp = Hc;
    Hc = t;
    if (a.full && a.score != nullptr && i == pl && tid == 0) {
      a.score[b] = Hp[ql];
    }
  }
  if (!a.full && a.score != nullptr && tid == 0) a.score[b] = Hp[ql];
}

template <bool kPtr>
int launch_profile(const ProfileArgs& a, void* stream) {
  int threads = ((a.N + 1 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const int64_t smem = a.rows != nullptr ? 0 : (int64_t)17 * (a.N + 1);
  const cudaError_t err = lm::allow_dyn_smem(profile_fwd_kernel<kPtr>, smem);
  if (err != cudaSuccess) return (int)err;
  if (a.B > 0) {
    LM_LAUNCH(profile_fwd_kernel<kPtr>, (unsigned)a.B, threads, (size_t)smem,
              (cudaStream_t)stream, a);
  }
  return (int)cudaGetLastError();
}

ProfileArgs make_args(const void* p, const void* q, const void* q_len,
                      void* qw, void* ext_q, void* ext_cum, void* cum_lv,
                      void* rows, int B, int M, int N, float gap_open,
                      float gap_extend, const float* w5) {
  ProfileArgs a = {};
  a.p = (const float*)p;
  a.q = (const float*)q;
  a.q_len = (const int*)q_len;
  a.qw = (float*)qw;
  a.ext_q = (float*)ext_q;
  a.ext_cum = (float*)ext_cum;
  a.cum_lv = (float*)cum_lv;
  a.rows = (float*)rows;
  a.B = B;
  a.M = M;
  a.N = N;
  a.K = 1;
  a.gap_open = gap_open;
  a.gap_extend = gap_extend;
  for (int k = 0; k < 25; ++k) a.w5.w[k] = w5[k];
  return a;
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
  ProfileArgs a = make_args(p, q, q_len, qw, ext_q, ext_cum, cum_lv, rows, B,
                            M, N, gap_open, gap_extend, w5);
  a.p_len = (const int*)p_len;
  a.flags = (unsigned char*)flags;
  a.ptr = (unsigned char*)ptr;
  a.score = (float*)score;
  return launch_profile<true>(a, stream);
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
  ProfileArgs a = make_args(p, q, q_len, qw, ext_q, ext_cum, cum_lv, rows, B,
                            M, N, gap_open, gap_extend, w5);
  a.p_len = (const int*)p_len;
  a.score = (float*)score;
  return launch_profile<false>(a, stream);
}

// K24: the arguments of lm_profile_score (M a multiple of K) and ck_h,
// ck_f: f32[M / K, B, N+1], the (H, F) carry at the top of every K-row
// block (block 0: the DP's first row).  Every row and column is computed.
extern "C" int lm_profile_ckpt(const void* p, const void* q,
                               const void* p_len, const void* q_len,
                               void* qw, void* ext_q, void* ext_cum,
                               void* cum_lv, void* rows, void* score,
                               void* ck_h, void* ck_f, int B, int M, int N,
                               int K, float gap_open, float gap_extend,
                               const float* w5, void* stream) {
  if (K < 1 || M % K != 0) return (int)cudaErrorInvalidValue;
  ProfileArgs a = make_args(p, q, q_len, qw, ext_q, ext_cum, cum_lv, rows, B,
                            M, N, gap_open, gap_extend, w5);
  a.p_len = (const int*)p_len;
  a.score = (float*)score;
  a.ck_h = (float*)ck_h;
  a.ck_f = (float*)ck_f;
  a.K = K;
  a.full = 1;
  return launch_profile<false>(a, stream);
}

// K25.  p_blk: f32[B, R, 5] the block's profile rows; q: f32[B, N, 5];
// q_len: int32[B]; h_in, f_in: f32[B, N+1] the carry at the block's top;
// scratch as for lm_profile_fwd (flags with rows); ptr: uint8[B, R,
// (N+2)/2], two cells a byte.  Every row and column is written.
extern "C" int lm_profile_block_ptrs(const void* p_blk, const void* q,
                                     const void* q_len, const void* h_in,
                                     const void* f_in, void* qw, void* ext_q,
                                     void* ext_cum, void* cum_lv, void* rows,
                                     void* flags, void* ptr, int B, int R,
                                     int N, float gap_open, float gap_extend,
                                     const float* w5, void* stream) {
  ProfileArgs a = make_args(p_blk, q, q_len, qw, ext_q, ext_cum, cum_lv,
                            rows, B, R, N, gap_open, gap_extend, w5);
  a.h_in = (const float*)h_in;
  a.f_in = (const float*)f_in;
  a.flags = (unsigned char*)flags;
  a.ptr = (unsigned char*)ptr;
  a.packed = 1;
  a.full = 1;
  return launch_profile<true>(a, stream);
}
