// K10: banded profile DP forward with the optimality certificate, and
// K11: the same forward with banded pointer bytes; K12: the traceback
// walk over the banded pointers.
//
// K10 replaces libmems_tpu/ops/profile.py _banded_block_scan(emit_ptr=
// False) + _banded_forward_scores (the refine gate); K11 replaces
// _banded_block_scan(emit_ptr=True), the forward half of _banded_fwd_tb;
// K12 replaces the `step` scan of _banded_fwd_tb.
//
// Bound: as K3, the row recurrence (three barriers and a block scan per
// row), over WB+1 = 256 + 2*H_W + 3 columns instead of N+1 (H_W =
// max(127, N/16-1): 513 of 1025 at N = 1024).  K11 writes WB+1 pointer
// bytes a row; K12 is latency-bound as K4 (one dependent byte a step).
//
// Design: one thread block per window, threads across the band's local
// columns, a loop over 128-row blocks.  Block bi covers global columns
// lo..lo+WB with
//   lo = clip((bi*128*q_len) // max(p_len,1) - (H_W+1), 0, N-WB);
// at a block boundary the carried H and F rows shift left by the change
// of lo, and a source column beyond WB becomes NEG_BIG
// (ops/profile.py:334-341).  Local column w behaves as column 0 of K3 at
// w = 0 (H = F there) and reads q column lo+w-1, ext_cum[lo+w] (clamped
// to N-1 and N, :344-349).  A row's score is H at qlen_loc = clip(q_len -
// lo, 0, WB), picked at row p_len (:375-379).  As in K3 only columns
// 0..qlen_loc and rows 1..p_len are computed and written: no later value
// the score or the walk reads depends on the others.  The rows live in
// shared memory (17*(WB+1) bytes: 29 KB at the 11,664 bucket).  Float
// operations and tie order are K3's (qw, the FMA row score, ext_cum by
// blocked_cumsum over the whole row, then gathered; the E scan runs over
// the band only, as in the JAX code).
//
// Certificate (ops/profile.py:381-406), in the epilogue: the wrapper
// sorts the window's gap costs (gap_extend * occupancy over the p_len
// rows and q_len columns, -inf elsewhere) descending with torch.sort, as
// the JAX code used lax.sort; the kernel zeroes the -inf entries, takes
// their prefix sum in the blocked order and reads it at g_lb - 1, g_lb =
// max(2*H_W - 3*|q_len - p_len|, 0); sumcap is the last element of the
// blocked prefix sum of max(max_y qw[y][j], 0) over the columns j <
// q_len (0 beyond); cert = score > ((sumcap + open) + gap_bound) + 64.
#include "common.cuh"

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned char kHDiag = 0, kHE = 1, kHF = 2, kEExt = 4, kFExt = 8;
constexpr unsigned char kIsDiag = 1;
constexpr int kBandK = 128;

__device__ __forceinline__ int band_lo(int bi, int ql, int plc, int H_W,
                                       int lo_cap) {
  const long long t =
      ((long long)bi * kBandK * ql) / plc - (long long)(H_W + 1);
  return (int)(t < 0 ? 0 : (t > lo_cap ? lo_cap : t));
}

template <bool kPtr>
__global__ void banded_kernel(
    const float* __restrict__ p, const float* __restrict__ q,
    const int* __restrict__ p_len, const int* __restrict__ q_len,
    float* __restrict__ qw, float* __restrict__ ext_q,
    float* __restrict__ ext_cum, float* __restrict__ cum_lv,
    int64_t cum_lv_stride, float* __restrict__ costs,
    float* __restrict__ capbuf, unsigned char* __restrict__ ptr,
    float* __restrict__ score, unsigned char* __restrict__ cert, int Mp,
    int N, int H_W, float gap_open, float gap_extend, lm::W5 w5) {
  extern __shared__ float lm_smem[];
  __shared__ float s_tmp[lm::kScanTmp];
  __shared__ float s_p[5];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int WB = kBandK * 2 + 2 * H_W + 2;
  const int w1 = WB + 1;
  const int lo_cap = N - WB > 0 ? N - WB : 0;
  const int pl = p_len[b];
  const int ql = q_len[b];
  const int plc = pl > 1 ? pl : 1;

  float* Hp = lm_smem;
  float* Hc = lm_smem + w1;
  float* F = lm_smem + 2 * w1;
  float* Wv = lm_smem + 3 * w1;
  unsigned char* fl = reinterpret_cast<unsigned char*>(lm_smem + 4 * w1);

  const float* qb = q + (int64_t)b * N * 5;
  float* qwb = qw + (int64_t)b * 5 * N;
  float* eq = ext_q + (int64_t)b * N;
  float* ec = ext_cum + (int64_t)b * (N + 1);
  float* lv = cum_lv + (int64_t)b * cum_lv_stride;

  lm::profile_q_setup(qb, qwb, eq, ql, N, gap_extend, w5);
  __syncthreads();
  lm::blocked_cumsum(eq, ec + 1, ql, lv);
  if (tid == 0) ec[0] = 0.f;
  __syncthreads();

  // block 0: lo == 0, the global first row
  int lo = 0;
  int qlen_loc = ql < WB ? ql : WB;
  for (int c = tid; c <= qlen_loc; c += nt) {
    Hp[c] = c == 0 ? 0.f : gap_open + ec[c];
    F[c] = kNegBig;
  }
  __syncthreads();
  float sc = ql == 0 ? 0.f : gap_open + ec[ql];  // H[0][q_len]

  for (int bi = 0; bi * kBandK < pl; ++bi) {
    if (bi > 0) {
      const int lo_new = band_lo(bi, ql, plc, H_W, lo_cap);
      const int d = lo_new - lo;
      lo = lo_new;
      int ql_new = ql - lo;
      ql_new = ql_new < 0 ? 0 : (ql_new > WB ? WB : ql_new);
      if (d != 0) {
        // shift the carried rows into the scratch rows, then swap
        for (int c = tid; c <= ql_new; c += nt) {
          const int src = c + d;
          Hc[c] = src <= WB ? Hp[src] : kNegBig;
          Wv[c] = src <= WB ? F[src] : kNegBig;
        }
        __syncthreads();
        float* t = Hp;
        Hp = Hc;
        Hc = t;
        t = F;
        F = Wv;
        Wv = t;
      }
      qlen_loc = ql_new;
    }
    const int per = (qlen_loc + 1 + nt - 1) / nt;
    const int c_lo = tid * per;
    const int c_hi = min(c_lo + per, qlen_loc + 1);
    const int i_end = min((bi + 1) * kBandK, pl);
    for (int i = bi * kBandK + 1; i <= i_end; ++i) {
      if (tid < 5) s_p[tid] = p[((int64_t)b * Mp + (i - 1)) * 5 + tid];
      __syncthreads();
      const float ext_pi = __fmul_rn(gap_extend, __fsub_rn(1.0f, s_p[4]));

      for (int c = tid; c <= qlen_loc; c += nt) {
        const float hp = Hp[c];
        const float fp = F[c];
        const float fo = (hp + gap_open) + ext_pi;
        const float fe = fp + ext_pi;
        const float f = fmaxf(fo, fe);
        unsigned char fc = (f == fe && fp > kNegBig / 2) ? kFExt : 0;
        F[c] = f;
        float g = f;
        if (c > 0) {
          const int j = min(lo + c - 1, N - 1);
          const float diag = Hp[c - 1] + lm::profile_row_score(s_p, qwb, N, j);
          g = fmaxf(diag, f);
          if (g == diag) fc |= kIsDiag;
        }
        Hc[c] = g;
        Wv[c] = (g + gap_open) - ec[min(lo + c, N)];
        if (kPtr) fl[c] = fc;
      }
      __syncthreads();

      float run = -INFINITY;
      for (int c = c_lo; c < c_hi; ++c) run = fmaxf(run, Wv[c]);
      float pre = lm::block_scan(run, -INFINITY, lm::MaxOp(), s_tmp).excl;
      for (int c = c_lo; c < c_hi; ++c) {
        const float w = Wv[c];
        Wv[c] = pre;
        pre = fmaxf(pre, w);
      }
      __syncthreads();

      unsigned char* prow =
          kPtr ? ptr + ((int64_t)b * Mp + (i - 1)) * w1 : nullptr;
      for (int c = tid; c <= qlen_loc; c += nt) {
        if (c == 0) {
          if (kPtr) prow[0] = kHF | (fl[0] & kFExt);
          continue;
        }
        const float e = ec[min(lo + c, N)] + Wv[c];
        const float g = Hc[c];
        const float h = fmaxf(g, e);
        if (kPtr) {
          const unsigned char fc = fl[c];
          const unsigned char src =
              ((fc & kIsDiag) && h == g) ? kHDiag : (h == e ? kHE : kHF);
          unsigned char out = src | (fc & kFExt);
          if (c >= 2 &&
              e == (ec[min(lo + c - 1, N)] + Wv[c - 1]) +
                       eq[min(lo + c - 1, N - 1)])
            out |= kEExt;
          prow[c] = out;
        }
        Hc[c] = h;
      }
      __syncthreads();
      float* t = Hp;
      Hp = Hc;
      Hc = t;
      if (i == pl) sc = Hp[qlen_loc];
    }
  }

  // certificate epilogue
  const int L = Mp + N;
  float* cb = costs + (int64_t)b * L;
  for (int k = tid; k < L; k += nt) {
    if (!isfinite(cb[k])) cb[k] = 0.f;
  }
  float* cap = capbuf + (int64_t)b * N;
  for (int j = tid; j < N; j += nt) {
    float m = 0.f;
    if (j < ql) {
      m = qwb[j];
      for (int y = 1; y < 5; ++y) m = fmaxf(m, qwb[y * N + j]);
      m = fmaxf(m, 0.f);
    }
    cap[j] = m;
  }
  __syncthreads();
  lm::blocked_cumsum(cb, cb, L, lv);
  lm::blocked_cumsum(cap, cap, N, lv);
  if (tid == 0) {
    const int dl = ql > pl ? ql - pl : pl - ql;
    int g_lb = 2 * H_W - 3 * dl;
    g_lb = g_lb > 0 ? g_lb : 0;
    int gidx = g_lb - 1;
    gidx = gidx < 0 ? 0 : (gidx > L - 1 ? L - 1 : gidx);
    const float gap_bound = g_lb > 0 ? cb[gidx] : 0.f;
    const float rhs = __fadd_rn(__fadd_rn(cap[N - 1], gap_open), gap_bound);
    score[b] = sc;
    cert[b] = sc > __fadd_rn(rhs, 64.0f) ? 1 : 0;
  }
}

__global__ void banded_walk_kernel(const unsigned char* __restrict__ ptr,
                                   const int* __restrict__ p_len,
                                   const int* __restrict__ q_len, int B,
                                   int Mp, int N, int H_W, int T,
                                   unsigned char* __restrict__ steps,
                                   unsigned char* __restrict__ agaps,
                                   unsigned char* __restrict__ bgaps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int WB = kBandK * 2 + 2 * H_W + 2;
  const int64_t w1 = WB + 1;
  const int lo_cap = N - WB > 0 ? N - WB : 0;
  const unsigned char* pb = ptr + (int64_t)b * Mp * w1;
  const int ql = q_len[b];
  const int plc = p_len[b] > 1 ? p_len[b] : 1;
  int i = p_len[b];
  int j = ql;
  int st = 0;
  for (int t = 0; t < T; ++t) {
    if (i <= 0 && j <= 0) break;
    const bool c0 = i == 0;
    const bool c1 = i > 0 && j == 0;
    const bool c2 = i > 0 && j > 0;
    int byte = 0;
    if (c2) {
      const int lo = band_lo((i - 1) / kBandK, ql, plc, H_W, lo_cap);
      int w = j - lo;
      w = w < 0 ? 0 : (w > WB ? WB : w);
      byte = pb[(int64_t)(i - 1) * w1 + w];
    }
    const bool was_h = c2 && st == 0;
    const bool was_e = c2 && st == 1;
    const bool was_f = c2 && st == 2;
    const int newst = byte & 3;
    const bool dm = was_h && newst == 0;
    const int64_t o = (int64_t)t * B + b;
    steps[o] = (c0 || c1 || dm || was_e || was_f) ? 1 : 0;
    agaps[o] = (c0 || was_e) ? 1 : 0;
    bgaps[o] = (c1 || was_f) ? 1 : 0;
    i -= (c1 || dm || was_f) ? 1 : 0;
    j -= (c0 || dm || was_e) ? 1 : 0;
    if (was_h) {
      st = newst;
    } else if (was_e) {
      st = (byte & kEExt) ? 1 : 0;
    } else if (was_f) {
      st = (byte & kFExt) ? 2 : 0;
    }
  }
}

template <bool kPtr>
int launch_banded(const void* p, const void* q, const void* p_len,
                  const void* q_len, void* qw, void* ext_q, void* ext_cum,
                  void* cum_lv, int64_t cum_lv_stride, void* costs,
                  void* capbuf, void* ptr, void* score, void* cert, int B,
                  int Mp, int N, int H_W, float gap_open, float gap_extend,
                  const float* w5, void* stream) {
  lm::W5 w;
  for (int k = 0; k < 25; ++k) w.w[k] = w5[k];
  const int w1 = kBandK * 2 + 2 * H_W + 3;
  int threads = ((w1 + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  const int64_t smem = (int64_t)17 * w1;
  const cudaError_t err = lm::allow_dyn_smem(banded_kernel<kPtr>, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    LM_LAUNCH(banded_kernel<kPtr>, (unsigned)B, threads, (size_t)smem,
              (cudaStream_t)stream, (const float*)p, (const float*)q,
              (const int*)p_len, (const int*)q_len, (float*)qw,
              (float*)ext_q, (float*)ext_cum, (float*)cum_lv, cum_lv_stride,
              (float*)costs, (float*)capbuf, (unsigned char*)ptr,
              (float*)score, (unsigned char*)cert, Mp, N, H_W, gap_open,
              gap_extend, w);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K10 (ptr null) / K11.  p: f32[B, Mp, 5] (Mp a multiple of 128); q:
// f32[B, N, 5]; p_len, q_len: int32[B]; qw: f32[B, 5, N], ext_q: f32[B,
// N], ext_cum: f32[B, N+1], cum_lv: f32[B, cum_lv_stride] with
// cum_lv_stride >= lm_profile_cum_scratch(Mp + N) (scratch); costs:
// f32[B, Mp+N], the sorted gap costs, overwritten with their prefix sums;
// capbuf: f32[B, N] (scratch); ptr: uint8[B, Mp, WB+1] zero-filled by the
// caller, or null; score: f32[B]; cert: uint8[B]; w5: HOST float[25].
// N must exceed WB + 1 (the JAX eligibility rule).
extern "C" int lm_banded_fwd(const void* p, const void* q, const void* p_len,
                             const void* q_len, void* qw, void* ext_q,
                             void* ext_cum, void* cum_lv,
                             int64_t cum_lv_stride, void* costs, void* capbuf,
                             void* ptr, void* score, void* cert, int B, int Mp,
                             int N, int H_W, float gap_open, float gap_extend,
                             const float* w5, void* stream) {
  if (Mp % kBandK != 0 || kBandK * 2 + 2 * H_W + 3 >= N)
    return (int)cudaErrorInvalidValue;
  if (ptr != nullptr)
    return launch_banded<true>(p, q, p_len, q_len, qw, ext_q, ext_cum, cum_lv,
                               cum_lv_stride, costs, capbuf, ptr, score, cert,
                               B, Mp, N, H_W, gap_open, gap_extend, w5, stream);
  return launch_banded<false>(p, q, p_len, q_len, qw, ext_q, ext_cum, cum_lv,
                              cum_lv_stride, costs, capbuf, ptr, score, cert,
                              B, Mp, N, H_W, gap_open, gap_extend, w5, stream);
}

// K12.  ptr: uint8[B, Mp, WB+1]; p_len, q_len: int32[B]; steps, agaps,
// bgaps: uint8[T, B], zero-filled by the caller.
extern "C" int lm_banded_walk(const void* ptr, const void* p_len,
                              const void* q_len, int B, int Mp, int N,
                              int H_W, int T, void* steps, void* agaps,
                              void* bgaps, void* stream) {
  if (B > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((B + threads - 1) / threads);
    LM_LAUNCH(banded_walk_kernel, blocks, threads, 0, (cudaStream_t)stream,
              (const unsigned char*)ptr, (const int*)p_len,
              (const int*)q_len, B, Mp, N, H_W, T, (unsigned char*)steps,
              (unsigned char*)agaps, (unsigned char*)bgaps);
  }
  return (int)cudaGetLastError();
}
