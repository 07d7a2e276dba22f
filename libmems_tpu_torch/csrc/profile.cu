// K3: profile-profile Gotoh forward DP with pointer bytes, K9: the same
// forward without pointers (the score only), K24: the forward with the
// (H, F) carry every K rows, and K25: the pointer bytes of a block of rows
// from such a carry.
//
// K3 replaces libmems_tpu/ops/profile.py _full_ptr_tb / _full_ptr_tb_jit
// (the lax.scan over rows of _profile_row_fn with emit_ptr=True, which
// materialises uint8[B, M, N+1] pointers on the TPU).  K9 replaces
// profile_forward_ckpt in the form profile_scores_batch calls it (K = Mp:
// the checkpoints are discarded, only the score float32[B] is fetched).
// K24 replaces profile_forward_ckpt at K = 128 (ops/profile.py:116), the
// route of a bucket whose full pointer tensor exceeds the budget, and K25
// replaces profile_block_ptrs (:142) followed by pack_ptrs (ops/gapped.py
// :188): two 4-bit cells a byte, cell 2k in the low nibble.
//
// Bound: the row recurrence.  Each of a window's rows depends on the
// previous one, and within a row E needs a prefix maximum over the
// columns; per cell the DP reads 5 qw floats, K3 writes a pointer byte
// (K25 half of one) and K24 writes 8 bytes of carry every K rows.  At the
// path's shapes the bytes are tiny, so a launch costs its longest
// window's rows times the latency of a row.
//
// Two routes, chosen by the launch's column bucket N alone:
//
// Strips (K3, K9 with N <= kStripMaxN; strip_kernel).  The design of
// K10/K11 (csrc/banded.cu, csrc/strip.cuh) with the band's lo fixed at 0
// and no band blocks: lane l of warp s holds the K consecutive columns
// from (32*s + l)*K in registers (H, F, ext_cum, ext_q and the five qw
// values of each), a warp is a strip of 32*K columns and a window takes
// S = ceil((N+1) / (32*K)) strips.  A row has no block barrier: F and G
// for each held column, the diagonal neighbour by __shfl_up_sync (from
// the strip to the left at the strip's first column); E from each lane's
// running maximum, a shuffle max-scan over the warp and the maximum
// carried in from the strip to the left; then H and the pointer bytes.
// Strips run the rows as a pipeline, handing on H of their last column,
// the running maximum and the last e + ext_q in row-tagged 64-bit words
// through a ring in shared memory.  Windows of one strip (S == 1) are
// packed kStripPack to a block, one warp each.  Each warp loads its
// window's profile rows 32 at a time, a row a lane, and broadcasts row
// i's five values by shuffles.  Per window, once: each lane forms its
// columns' qw and ext_q from q in registers (no global scratch), and the
// window's ext_cum is the blocked cumsum (lm::blocked_cumsum_in) in
// shared memory.  The kernel writes every byte of its [B, M, N+1]
// pointer tensor (zeros outside rows 1..p_len and columns 0..q_len; the
// rows past p_len, and at K = 17 every row, through a staging row in
// shared memory as 4-byte words), so the wrapper allocates it without a
// fill.  The launcher picks K (kStripK) by the price of a row of the
// launch (StripCost), as band_pick does.
//
// Where strips stop: a block of 256 threads always gets its registers
// (255 a thread is the most, and 256 x 256 fills an SM's 65,536), while
// wider blocks fit only with fewer registers than K = 13 or 17 need (the
// pointer kernels take 207 and 243 by ptxas; K11's K = 17 already spills
// at 255), and more columns a lane would spill.  So the widest strip
// window is 8 warps x 32 lanes x 17 columns, 4,352 columns: kStripMaxN =
// 4,351.  Wider buckets (5,184 and up, the
// 11,664 bucket of the default 10,000-column cap, the 39,366 of a raised
// one) take the wide route.
//
// Wide (profile_fwd_kernel): one thread block a window, threads across
// columns j, a loop over rows i with three barriers and one block scan a
// row.  The window's H (double-buffered), F, scan and flag rows live in
// shared memory when 17*(N+1) bytes fit, otherwise in global scratch.
// qw = q.W5^T, ext_q and ext_cum are computed once per window into global
// scratch (one allocation, carved by the launcher).  K3 writes rows
// 1..p_len, columns 0..q_len, and its caller zero-fills the pointer
// tensor first: writing the rest in the kernel, a byte a thread from the
// one block a window, cost 118.1 ms against 103.5 ms at B = 2 in the
// 11,664 bucket on an H100 (chip_smoke.py wide), where the fill is one
// launch at the memory's rate.  K9 compiles the pointer and flag writes
// out, so its score equals K3's bit for bit.
//
// Spans (K24, K25; span_kernel): the strips over several blocks, at any
// width (csrc/strip.cuh).  A window's S strips go W to a block of W + 1
// warps, C = ceil(S / W) blocks a window: inside a block the strips hand
// rows on through the shared ring, at a block's edge through a column of
// row-tagged words in global memory that holds every row (no
// back-pressure), which the next block's warp 0 copies into its ring.  A
// block takes its (instance, segment) from an atomic ticket, so it only
// waits on blocks already running.  An instance is K24's window (rows
// 1..M, the (H, F) carry stored every KR rows, the score at p_len) or
// one of K25's G x B row blocks (R rows from its carry; the G blocks of a
// window that the host walk needs next are independent given K24's
// carries, so they run side by side in one launch).  ext_cum is formed
// once a window into global scratch (span_ext_cum_kernel), qw and ext_q
// per lane from q.  K25 packs two cells a byte in the store (at an odd
// K the odd lanes' first cell goes to the left lane's last byte by
// shuffle), through a staging row at K >= 16.  The host picks K and W
// (ops.profile.span_pick, from the card's fits, lm_span_fits) and G.
// K24's score equals K3's bit for bit, and K25 started from K24's carry
// at row bi*K gives K3's pointer bytes of rows bi*K+1 .. (bi+1)*K.
//
// Arithmetic and tie order copy ops/profile.py:49-93 exactly, on both
// routes:
//   F = max((H_prev + open) + ext_p, F_prev + ext_p)
//   g = max(H_prev[j-1] + p.qw[j-1], F)            (column 0: g = F)
//   E[j] = ext_cum[j] + max_{k<j}((g[k] + open) - ext_cum[k])
//   H = max(g, E);  pointer: H_DIAG before H_E before H_F,
//   F extend bit iff F == F_prev + ext_p and F_prev > NEG_BIG/2,
//   E extend bit iff E[j] == E[j-1] + ext_q[j-1]   (j >= 2).
// E is the same max-scan formula as the JAX code, not a left-to-right E
// recurrence, so fractional profiles keep the same structure of float
// operations; the strips associate its maximum differently (lanes, then
// strips), and a maximum of floats is exact in any association.  K3 and
// K9 compute rows 1..p_len and columns 0..q_len only: no value the score
// or the walk reads depends on the others.  K24 and K25 compute every row
// and column of the padded [M, N+1] matrix, as the JAX scan does, so the
// carries and pointer bytes equal the JAX arrays whole; a column's values
// never depend on a later column, so those inside the window are K3's.
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
#include <mutex>

#include "common.cuh"
#include "strip.cuh"

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned char kHDiag = 0, kHE = 1, kHF = 2, kEExt = 4, kFExt = 8;
constexpr unsigned char kIsDiag = 1;  // flag: g came from the diagonal

struct ProfileArgs {
  const float* p;        // [B, M, 5] the profile rows computed
  const float* q;        // [B, N, 5]
  const int* p_len;      // [B]
  const int* q_len;      // [B]
  float* qw;             // [B, 5, N] scratch
  float* ext_q;          // [B, N] scratch
  float* ext_cum;        // [B, N+1] scratch
  float* cum_lv;         // [B, cum_scratch(N)] scratch
  float* rows;           // [B, 4, N+1] global row scratch, or null
  unsigned char* flags;  // [B, N+1] with rows when pointers are written
  unsigned char* ptr;    // K3: [B, M, N+1], or null (K9)
  float* score;          // [B] H at (p_len, q_len)
  int B, M, N;
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
  const int pl = a.p_len[b];
  const int ql = a.q_len[b];
  // rows 1..row_hi and columns 0..chi are computed
  const int row_hi = pl;
  const int chi = ql;
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
    Hp[c] = c == 0 ? 0.f : gap_open + ec[c];
    F[c] = kNegBig;
  }
  __syncthreads();

  // contiguous column chunk per thread for the row's max-scan
  const int per = (chi + 1 + nt - 1) / nt;
  const int c_lo = tid * per;
  const int c_hi = min(c_lo + per, chi + 1);

  for (int i = 1; i <= row_hi; ++i) {
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

    // pass 2: E, H and (K3) the pointer byte
    unsigned char* prow =
        kPtr ? a.ptr + ((int64_t)b * a.M + (i - 1)) * n1 : nullptr;
    for (int c = tid; c <= chi; c += nt) {
      unsigned char out = 0;
      if (c == 0) {
        // H[i][0] = F[i][0], already in Hc
        if (kPtr) out = kHF | (fl[0] & kFExt);
      } else {
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
      if (kPtr) prow[c] = out;
    }
    __syncthreads();
    float* t = Hp;
    Hp = Hc;
    Hc = t;
  }
  if (tid == 0) a.score[b] = Hp[ql];
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
  a.gap_open = gap_open;
  a.gap_extend = gap_extend;
  for (int k = 0; k < 25; ++k) a.w5.w[k] = w5[k];
  return a;
}

// ---------------------------------------------------------------------------
// The strip route of K3 and K9 (see the top of the file).

using lm_strip::await_row_word;
using lm_strip::kFull;
using lm_strip::kRing;
using lm_strip::kSlot;
using lm_strip::qw_of;
using lm_strip::row_word;

// The widest bucket the strips take: 8 warps x 32 lanes x 17 columns - 1.
constexpr int kStripMaxN = 4351;
// Windows of one strip a block (one warp each).
constexpr int kStripPack = 4;

struct StripArgs {
  const float* p;        // [B, M, 5]
  const float* q;        // [B, N, 5]
  const int* p_len;      // [B]
  const int* q_len;      // [B]
  unsigned char* ptr;    // K3: [B, M, N+1]; K9: null
  float* score;          // [B]
  int B, M, N;
  int S, W;              // warps a window, windows a block
  float gap_open, gap_extend;
  lm::W5 w5;
};

// Floats of shared memory a window takes: its ext_cum (N+1) and the
// cumsum's levels, an even count so that the ring after the block's
// windows is 8-byte aligned.
__host__ __device__ inline int64_t strip_window_floats(int N) {
  return (N + 1 + lm::cum_scratch(N) + 1) & ~(int64_t)1;
}

// Floats of the hand-off ring and its flags a window of S strips takes
// (none for one strip).
__host__ __device__ inline int64_t strip_ring_floats(int S) {
  return S > 1 ? (int64_t)2 * kSlot * S * kRing + S : 0;
}

// Floats of a strip's staging row for its pointer bytes: 32*K bytes and
// a word of slack for the unaligned word reads.
__host__ __device__ inline int64_t strip_stage_floats(int K) {
  return 8 * K + 2;
}

// Bytes of dynamic shared memory a block takes: W windows, for windows of
// several strips the hand-off ring and a flag a strip, and with pointers
// a staging row a strip.
__host__ __device__ inline int64_t strip_smem_bytes(int N, int K, int S,
                                                    int W, bool ptr) {
  return 4 * (W * strip_window_floats(N) + strip_ring_floats(S) +
              (ptr ? W * S * strip_stage_floats(K) : 0));
}

// Writes a strip's pointer bytes of one row, staged at stg (32*K bytes,
// 4-byte aligned, every lane's K bytes stored), to dst[0..len): the bytes
// before dst's first 4-byte boundary and after its last one singly, the
// rest as 4-byte words, a lane a word, read from the staging row by a
// funnel shift of the two aligned words that hold it.
__device__ __forceinline__ void store_stage(const unsigned char* stg,
                                            unsigned char* dst, int len,
                                            int lane) {
  const int head = min((int)((4 - ((uintptr_t)dst & 3)) & 3), len);
  const int words = (len - head) >> 2;
  const int tail = head + 4 * words;
  const unsigned* s32 = reinterpret_cast<const unsigned*>(stg);
  if (lane < head) dst[lane] = stg[lane];
  for (int w = lane; w < words; w += 32) {
    const int o = head + 4 * w;
    const unsigned lo = s32[o >> 2];
    const unsigned hi = s32[(o >> 2) + 1];
    reinterpret_cast<unsigned*>(dst + head)[w] =
        __funnelshift_r(lo, hi, 8 * (o & 3));
  }
  if (tail + lane < len) dst[tail + lane] = stg[tail + lane];
}

// One window a group of S warps (S > 1: the block; S == 1: one warp of a
// block of W windows).  K columns a lane; no block barrier in the row loop.
template <int K, bool kPtr>
__global__ void strip_kernel(StripArgs a) {
  // A lane's K pointer bytes of a row lie K apart from the next lane's, so
  // a warp's byte store touches up to K sectors.  At K = 17 (up to 8
  // strips a block) that saturates the load/store unit, and the row goes
  // through the staging row as words (4096 x 4096: 8.3 -> 6.4 ms on an
  // H100); narrower lanes store bytes directly, since the staging's
  // shared-memory round trip lies on the row's latency chain (1024 x
  // 1024 at K <= 13: 0.77-1.09 ms direct, 0.95-1.24 staged).
  constexpr bool kStage = K == 17;
  extern __shared__ float lm_smem[];
  const int S = a.S;
  const int N = a.N, M = a.M, n1 = N + 1;
  const int lane = threadIdx.x & 31;
  const int slot = (threadIdx.x >> 5) / S;         // the block's window
  const int warp = (threadIdx.x >> 5) - slot * S;  // the window's strip
  const int b = blockIdx.x * a.W + slot;
  if (b >= a.B) return;   // only where S == 1: no block barrier follows
  const float gap_open = a.gap_open, gap_extend = a.gap_extend;
  const int pl = a.p_len[b];
  const int ql = a.q_len[b];
  const int c0 = warp * 32 * K;         // the strip's first column
  const int cb = c0 + lane * K;         // this lane's first column
  const bool col0 = warp == 0 && lane == 0;
  const int gt = warp * 32 + lane;      // the thread in the window's group
  const int gn = 32 * S;
  auto sync = [S] {
    if (S > 1) {
      __syncthreads();
    } else {
      __syncwarp();
    }
  };

  // shared memory: the window's ext_cum and cumsum levels; then the ring:
  // slot r of strip s holds {H[i][last], running max, e + ext_q of its
  // last column} of row i = r (mod kRing)
  const int64_t wf = strip_window_floats(N);
  float* ecs = lm_smem + slot * wf;
  float* lv = ecs + n1;
  volatile unsigned long long* ring =
      reinterpret_cast<volatile unsigned long long*>(lm_smem + a.W * wf);
  volatile int* used =   // rows a strip has read from the one before
      reinterpret_cast<volatile int*>(ring + kSlot * S * kRing);
  // the strip's staging row of pointer bytes
  unsigned char* stg = reinterpret_cast<unsigned char*>(
      lm_smem + a.W * wf + strip_ring_floats(S) +
      (slot * S + warp) * strip_stage_floats(K));
  const int seg = min(32 * K, n1 - c0);   // the strip's bytes of a row

  // per window, once: the held columns' qw (of q column c-1) and ext_q
  // (of q column c, the next column's kEExt test) in registers; ext_q
  // also into shared memory for the window's ext_cum
  const float* qb = a.q + (int64_t)b * N * 5;
  float H[K], F[K], EC[K];
  float EQ[kPtr ? K : 1];
  float QW[5 * K];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const int c = cb + m;
    float qv[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (c >= 1 && c - 1 < ql) {
#pragma unroll
      for (int x = 0; x < 5; ++x) qv[x] = qb[(c - 1) * 5 + x];
    }
#pragma unroll
    for (int y = 0; y < 5; ++y) QW[m * 5 + y] = qw_of(qv, a.w5, y);
    const float eq =
        c < ql ? __fmul_rn(gap_extend, __fsub_rn(1.0f, qb[c * 5 + 4])) : 0.f;
    if (kPtr) EQ[m] = eq;
    if (c < ql) ecs[c + 1] = eq;
  }
  if (S > 1) {
    for (int k = gt; k < kSlot * S * kRing; k += gn) ring[k] = 0;
    if (gt < S) used[gt] = 0;
  }
  if (gt == 0) ecs[0] = 0.f;
  sync();
  lm::blocked_cumsum_in(ecs + 1, ecs + 1, ql, lv, gt, gn, sync);
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const int c = cb + m;
    EC[m] = c <= ql ? ecs[c] : 0.f;
    H[m] = c == 0 ? 0.f : (c <= ql ? gap_open + EC[m] : kNegBig);
    F[m] = kNegBig;
  }
  // H[i-1][c0-1] for the strip's first column (strips after the first)
  float h_left = c0 >= 1 && c0 - 1 <= ql ? gap_open + ecs[c0 - 1] : kNegBig;

  // a strip takes part while its first column is computed, and hands
  // rows on while the next strip's is
  const bool active = c0 <= ql;
  const bool feeds = c0 + 32 * K <= ql;
  if (active) {
    // the profile rows, 32 at a time, a row a lane; row i's five values
    // reach every lane by shuffles
    const float* pb = a.p + (int64_t)b * M * 5;
    float P[5], PN[5];
    auto load_rows = [&](int first) {
      const int r = first + lane;
#pragma unroll
      for (int x = 0; x < 5; ++x) PN[x] = r < pl ? pb[r * 5 + x] : 0.f;
    };
    load_rows(0);
    for (int i = 1; i <= pl; ++i) {
      const int r = (i - 1) & 31;
      if (r == 0) {
#pragma unroll
        for (int x = 0; x < 5; ++x) P[x] = PN[x];
        load_rows(i + 31);
      }
      float pc[5];
#pragma unroll
      for (int x = 0; x < 5; ++x) pc[x] = __shfl_sync(kFull, P[x], r);
      const float ext_pi = __fmul_rn(gap_extend, __fsub_rn(1.0f, pc[4]));

      // 1. F and G; the running max of Wv over the lane's columns
      float hl = __shfl_up_sync(kFull, H[K - 1], 1);
      if (lane == 0) hl = h_left;
      float run = -INFINITY;
      unsigned dmask = 0, fmask = 0;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const float hp = H[m];
        const float fp = F[m];
        const float fo = (hp + gap_open) + ext_pi;
        const float fe = fp + ext_pi;
        const float f = fmaxf(fo, fe);
        if (kPtr && f == fe && fp > kNegBig / 2) fmask |= 1u << m;
        F[m] = f;
        float g = f;
        if (m > 0 || !col0) {
          float s = __fmul_rn(pc[0], QW[m * 5]);
          s = __fmaf_rn(pc[1], QW[m * 5 + 1], s);
          s = __fmaf_rn(pc[2], QW[m * 5 + 2], s);
          s = __fmaf_rn(pc[3], QW[m * 5 + 3], s);
          s = __fmaf_rn(pc[4], QW[m * 5 + 4], s);
          const float diag = hl + s;
          g = fmaxf(diag, f);
          if (kPtr && g == diag) dmask |= 1u << m;
        }
        hl = hp;   // column m's H[i-1] is column m+1's diagonal
        H[m] = g;
        run = fmaxf(run, (g + gap_open) - EC[m]);
      }

      // 2. the exclusive max-scan over the lanes, then the strip's carry
      float x = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x = fmaxf(n, x);
      }
      float pre = __shfl_up_sync(kFull, x, 1);
      if (lane == 0) pre = -INFINITY;
      float eeq_in = 0.f;
      if (warp > 0) {
        const volatile unsigned long long* sl =
            ring + ((warp - 1) * kRing + i % kRing) * kSlot;
        h_left = await_row_word(sl, i);   // H[i][c0-1], next row's diagonal
        pre = fmaxf(pre, await_row_word(sl + 1, i));
        if (kPtr) eeq_in = await_row_word(sl + 2, i);
        __syncwarp();
        if (lane == 0) used[warp] = i;
      }

      // 3. H = max(G, E) and the pointer bytes (zero past q_len)
      unsigned char* prow =
          kPtr ? a.ptr + ((int64_t)b * M + (i - 1)) * n1 : nullptr;
      float e0 = 0.f, eeq = 0.f;   // eeq: the previous column's e + ext_q
      unsigned char byte0 = 0;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int c = cb + m;
        const float g = H[m];
        const float wv = (g + gap_open) - EC[m];
        if (m == 0 && col0) {   // column 0: H = G, the pointer F
          pre = fmaxf(pre, wv);
          if (kPtr) byte0 = kHF | ((fmask & 1u) ? kFExt : 0);
          continue;
        }
        const float e = EC[m] + pre;
        pre = fmaxf(pre, wv);
        const float h = fmaxf(g, e);
        H[m] = h;
        if (kPtr) {
          const unsigned char src = (((dmask >> m) & 1u) && h == g)
                                        ? kHDiag
                                        : (h == e ? kHE : kHF);
          unsigned char out = src | (((fmask >> m) & 1u) ? kFExt : 0);
          if (m == 0) {
            e0 = e;
            byte0 = out;
          } else {
            if (c >= 2 && e == eeq) out |= kEExt;
            if (kStage) {
              stg[lane * K + m] = c <= ql ? out : 0;
            } else if (c <= N) {
              prow[c] = c <= ql ? out : 0;
            }
          }
          eeq = e + EQ[m];
        }
      }
      if (kPtr) {
        float eeq_left = __shfl_up_sync(kFull, eeq, 1);
        if (lane == 0) eeq_left = eeq_in;
        if (!col0 && cb >= 2 && e0 == eeq_left) byte0 |= kEExt;
        if (kStage) {
          stg[lane * K] = cb <= ql ? byte0 : 0;
          __syncwarp();
          store_stage(stg, prow + c0, seg, lane);
          __syncwarp();   // the next row's bytes overwrite the staging row
        } else if (cb <= N) {
          prow[cb] = cb <= ql ? byte0 : 0;
        }
      }

      // hand the row to the next strip
      if (feeds) {
        if (i > kRing) {
          while (used[warp + 1] < i - kRing) {
          }
        }
        if (lane == 31) {
          volatile unsigned long long* sl =
              ring + (warp * kRing + i % kRing) * kSlot;
          sl[0] = row_word(H[K - 1], i);
          sl[1] = row_word(pre, i);
          if (kPtr) sl[2] = row_word(eeq, i);
        }
      }
    }
    // H at (p_len, q_len); row 0's where p_len is 0
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (cb + m == ql) a.score[b] = H[m];
    }
  }
  if (kPtr) {   // the strip's columns of the rows past p_len are zero
    for (int k = lane; k < 32 * K; k += 32) stg[k] = 0;
    __syncwarp();
    for (int r = active ? pl : 0; r < M; ++r) {
      store_stage(stg, a.ptr + ((int64_t)b * M + r) * n1 + c0, seg, lane);
    }
  }
}

// The geometries the launcher chooses from: K columns a lane.  A
// geometry's S is ceil((N+1) / (32*K)); windows of one strip go
// kStripPack to a block.
constexpr int kStripK[] = {17, 13, 9, 5, 3, 1};
constexpr int kStripGeometryCount = 6;

// The launcher's price of a row of a launch, in ns: the larger of a
// strip's row latency, A + Bk*K + Cs*S, plus H where strips hand rows on
// (a chain longer with more strips), and the issue time where an SM's
// strips need more than its four schedulers give, strips an SM x (K*I +
// J) instructions at 4 x 1.98 a ns.  Fitted to the forced-geometry times
// of chip_smoke.py fullwidth on an H100 (windows of 16 to 4,096 columns;
// K9's row takes 0.33-0.52 us almost whatever K, K3's grows with K
// through its pointer bytes).
struct StripCost {
  int A, Bk, Cs, H, I, J;
};
constexpr StripCost kCostScores = {200, 15, 30, 60, 20, 60};
constexpr StripCost kCostPtrs = {300, 50, 30, 60, 40, 60};

template <bool kPtr>
const void* strip_kernel_of(int g) {
  switch (g) {
    case 0: return (const void*)strip_kernel<17, kPtr>;
    case 1: return (const void*)strip_kernel<13, kPtr>;
    case 2: return (const void*)strip_kernel<9, kPtr>;
    case 3: return (const void*)strip_kernel<5, kPtr>;
    case 4: return (const void*)strip_kernel<3, kPtr>;
    default: return (const void*)strip_kernel<1, kPtr>;
  }
}

struct StripPlan {
  int g = -1;      // geometry index
  int S = 0;       // warps a window
  int W = 0;       // windows a block
  int per_sm = 0;  // windows an SM holds at once
  int64_t smem = 0;
  int64_t cost = 0;
};

// Geometry g for windows of N+1 columns: S, W, the shared memory and the
// windows an SM holds; per_sm == 0 where the block does not fit (threads
// beyond what the kernel's registers allow, or shared memory beyond the
// opt-in).  A kernel that fits may opt into all the shared memory the card
// allows, so that any bucket's launch is within its limit.
inline cudaError_t strip_fit(int g, int N, bool ptr, StripPlan* out) {
  const int K = kStripK[g];
  StripPlan pl;
  pl.g = g;
  pl.S = (N + 1 + 32 * K - 1) / (32 * K);
  pl.W = pl.S == 1 ? kStripPack : 1;
  pl.smem = strip_smem_bytes(N, K, pl.S, pl.W, ptr);
  const void* fn = ptr ? strip_kernel_of<true>(g) : strip_kernel_of<false>(g);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  const int threads = 32 * pl.S * pl.W;
  const int64_t optin = lm::max_dyn_smem(fn);
  if (threads <= attr.maxThreadsPerBlock && threads <= 1024 &&
      pl.smem <= optin) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)optin);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        pl.smem);
    if (err != cudaSuccess) return err;
    pl.per_sm = blocks * pl.W;
  }
  *out = pl;
  return cudaSuccess;
}

// Every geometry's fit for an N-column bucket on one card, kept so that
// a launch asks the runtime nothing (the queries cost more host time than
// a small launch's kernel).
struct StripFits {
  int dev = -1, N = -1;
  bool ptr = false;
  int n_sm = 0;
  StripPlan plans[kStripGeometryCount];
};
constexpr int kFitCache = 64;
StripFits fit_cache[kFitCache];
int fit_next = 0;
std::mutex fit_mutex;

inline cudaError_t strip_fits(int N, bool ptr, StripFits* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(fit_mutex);
  for (const StripFits& f : fit_cache) {
    if (f.dev == dev && f.N == N && f.ptr == ptr) {
      *out = f;
      return cudaSuccess;
    }
  }
  StripFits f;
  f.dev = dev;
  f.N = N;
  f.ptr = ptr;
  err = lm_strip::sm_count(&f.n_sm);
  for (int g = 0; g < kStripGeometryCount && err == cudaSuccess; ++g)
    err = strip_fit(g, N, ptr, &f.plans[g]);
  if (err != cudaSuccess) return err;
  fit_cache[fit_next] = f;
  fit_next = (fit_next + 1) % kFitCache;
  *out = f;
  return cudaSuccess;
}

// The price of a row of a launch of B windows in geometry pl on n_sm SMs
// (StripCost).
inline int64_t strip_cost(const StripPlan& pl, int B, int n_sm, bool ptr) {
  const StripCost c = ptr ? kCostPtrs : kCostScores;
  const int K = kStripK[pl.g];
  const int64_t latency =
      c.A + c.Bk * K + c.Cs * pl.S + (pl.S > 1 ? c.H : 0);
  const int64_t strips = (int64_t)(B + n_sm - 1) / n_sm * pl.S;
  const int64_t issue = strips * (K * c.I + c.J) * 100 / (4 * 198);
  return latency > issue ? latency : issue;
}

// Geometry g (g >= 0) or the cheapest that fits (g < 0) for B windows of
// N+1 columns; cudaErrorInvalidConfiguration where none does.
inline cudaError_t strip_pick(int B, int N, bool ptr, int g, StripPlan* out) {
  StripFits f;
  const cudaError_t err = strip_fits(N, ptr, &f);
  if (err != cudaSuccess) return err;
  if (g >= 0) {
    *out = f.plans[g];
    out->cost = strip_cost(*out, B, f.n_sm, ptr);
    return cudaSuccess;
  }
  StripPlan best;
  for (StripPlan pl : f.plans) {
    pl.cost = strip_cost(pl, B, f.n_sm, ptr);
    if (pl.per_sm > 0 && (best.g < 0 || pl.cost < best.cost)) best = pl;
  }
  if (best.g < 0) return cudaErrorInvalidConfiguration;
  *out = best;
  return cudaSuccess;
}

// out: int[6] = {route (0 strips, 1 wide), geometry, K, warps a window,
// windows a block, windows an SM} of a strip plan.
inline void describe_strips(const StripPlan& pl, int* out) {
  const int v[6] = {0, pl.g, kStripK[pl.g], pl.S, pl.W, pl.per_sm};
  for (int k = 0; k < 6; ++k) out[k] = v[k];
}

// The same for the wide route of an N-column bucket: one block a window
// of up to 1,024 threads, with the rows in shared memory unless
// rows_global, and the blocks an SM holds; kept per card and bucket as
// the strips' fits are, so that a launch asks the runtime nothing past
// its bucket's first.  The queries are launch_profile's own and the
// occupancy of the same block, so they fail only where the launch would.
struct WideFit {
  int dev = -1, N = -1;
  bool ptr = false, rows_global = false;
  int out[6] = {};
};
WideFit wide_cache[kFitCache];
int wide_next = 0;

inline cudaError_t describe_wide(int N, bool ptr, bool rows_global,
                                 int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(fit_mutex);
  for (const WideFit& f : wide_cache) {
    if (f.dev == dev && f.N == N && f.ptr == ptr &&
        f.rows_global == rows_global) {
      for (int k = 0; k < 6; ++k) out[k] = f.out[k];
      return cudaSuccess;
    }
  }
  int threads = ((N + 1 + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  const void* fn = ptr ? (const void*)profile_fwd_kernel<true>
                       : (const void*)profile_fwd_kernel<false>;
  const int64_t smem = rows_global ? 0 : (int64_t)17 * (N + 1);
  int blocks = 0;
  err = lm::allow_dyn_smem(fn, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  WideFit f;
  f.dev = dev;
  f.N = N;
  f.ptr = ptr;
  f.rows_global = rows_global;
  const int v[6] = {1, -1, 0, threads / 32, 1, blocks};
  for (int k = 0; k < 6; ++k) out[k] = f.out[k] = v[k];
  wide_cache[wide_next] = f;
  wide_next = (wide_next + 1) % kFitCache;
  return cudaSuccess;
}

template <int K, bool kPtr>
void launch_strip_geometry(const StripPlan& pl, const StripArgs& a,
                           void* stream) {
  const auto kernel = strip_kernel<K, kPtr>;
  LM_LAUNCH(kernel, (unsigned)((a.B + pl.W - 1) / pl.W), 32 * pl.S * pl.W,
            (size_t)pl.smem, (cudaStream_t)stream, a);
}

template <bool kPtr>
int launch_strips(int force, StripArgs a, void* stream, int* taken) {
  StripPlan pl;
  const cudaError_t err = strip_pick(a.B, a.N, kPtr, force, &pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  if (taken != nullptr) describe_strips(pl, taken);
  a.S = pl.S;
  a.W = pl.W;
  if (a.B > 0) {
    switch (pl.g) {
      case 0: launch_strip_geometry<17, kPtr>(pl, a, stream); break;
      case 1: launch_strip_geometry<13, kPtr>(pl, a, stream); break;
      case 2: launch_strip_geometry<9, kPtr>(pl, a, stream); break;
      case 3: launch_strip_geometry<5, kPtr>(pl, a, stream); break;
      case 4: launch_strip_geometry<3, kPtr>(pl, a, stream); break;
      default: launch_strip_geometry<1, kPtr>(pl, a, stream); break;
    }
  }
  return (int)cudaGetLastError();
}

// The wide route's scratch, carved from one allocation: byte offsets of
// qw [B, 5, N], ext_q [B, N], ext_cum [B, N+1] and the cumsum levels,
// then (rows in global memory) the rows [B, 4, N+1] and, with pointers,
// the flags [B, N+1]; -1 where absent.
struct WideScratch {
  int64_t qw, ext_q, ext_cum, cum_lv, rows, flags, total;
};

inline WideScratch wide_scratch(int B, int N, bool ptr, bool rows_global) {
  auto up = [](int64_t x) { return (x + 15) & ~(int64_t)15; };
  WideScratch w;
  int64_t o = 0;
  w.qw = o;
  o += up(4LL * B * 5 * N);
  w.ext_q = o;
  o += up(4LL * B * N);
  w.ext_cum = o;
  o += up(4LL * B * (N + 1));
  w.cum_lv = o;
  o += up(4LL * B * lm::cum_scratch(N));
  w.rows = rows_global ? o : -1;
  if (rows_global) o += up(16LL * B * (N + 1));
  w.flags = rows_global && ptr ? o : -1;
  if (rows_global && ptr) o += up((int64_t)B * (N + 1));
  w.total = o;
  return w;
}

// ---------------------------------------------------------------------------
// K24 and K25: strips over several blocks (see the top of the file).

using lm_strip::kBatch;

// The geometries (csrc/strip.cuh, shared with K22): kSpanK[g] columns a
// lane, W strips a block.
using lm_strip::kSpanGeometryCount;
using lm_strip::kSpanK;
using lm_strip::kSpanMaxW;
using lm_strip::span_strips;

struct SpanArgs {
  const float* p;          // [B, M, 5] the window's profile rows
  const float* q;          // [B, N, 5]
  const int* p_len;        // K24: [B] (the score's row); K25: null
  const int* q_len;        // [B]
  const float* ext_cum;    // [B, N+1] scratch (span_ext_cum_kernel)
  const float* h_in;       // K25: [G, B, N+1] the carries the blocks
  const float* f_in;       //   start from; K24: null (the DP's row 0)
  unsigned long long* edges;   // [G*B, C-1, R, words], zeroed
  unsigned* ticket;            // zeroed
  unsigned char* ptr;      // K25: [G, B, R, (N+2)/2]
  float* score;            // K24: [B]
  float* ck_h;             // K24: [M / KR, B, N+1]
  float* ck_f;
  int B, M, N;
  int R;                   // rows an instance computes (K24: M)
  int first;               // K25: the first row block's index
  int KR;                  // K24: rows between carries
  int S, W, C;             // strips a window, strips a block, blocks
  float gap_open, gap_extend;
  lm::W5 w5;
};

// Bytes of a K25 strip's staging row (K >= 16): 16*K packed bytes and a
// word of slack for store_stage's unaligned word reads.
__host__ __device__ inline int64_t span_stage_bytes(int K) {
  return (16 * K + 8 + 7) & ~(int64_t)7;
}

// Dynamic shared memory of a block of W strips: W + 1 ring sets (set 0
// the receiver's), a used count a strip, and for K25 at K >= 16 a
// staging row a strip.
__host__ __device__ inline int64_t span_smem_bytes(int K, int W, bool ptr) {
  return (int64_t)8 * kSlot * kRing * (W + 1) + 8 * ((W + 2) / 2) +
         (ptr && K >= 16 ? W * span_stage_bytes(K) : 0);
}

// ext_cum of each window (one block a window): ext_q of every q column
// (padding included, as every column is computed), then the blocked
// cumsum in place, in the JAX CPU order.
__global__ void span_ext_cum_kernel(const float* q, float* ext_cum,
                                    float* cum_lv, int N, float gap_extend) {
  const int b = blockIdx.x;
  const float* qb = q + (int64_t)b * N * 5;
  float* ec = ext_cum + (int64_t)b * (N + 1);
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    ec[j + 1] = __fmul_rn(gap_extend, __fsub_rn(1.0f, qb[j * 5 + 4]));
  if (threadIdx.x == 0) ec[0] = 0.f;
  __syncthreads();
  lm::blocked_cumsum(ec + 1, ec + 1, N, cum_lv + (int64_t)b *
                                            lm::cum_scratch(N));
}

// One instance (K24: a window's rows 1..M; K25: row block first+g of
// window b) is C blocks of up to W strips; warp 0 of a block is its
// receiver, warps 1..W its strips.  Every row and column of the padded
// matrix is computed.  No block barrier after the setup.
template <int K, bool kPtr>
__global__ void span_kernel(SpanArgs a) {
  // K25's row of packed bytes goes through a staging row at K >= 16, as
  // K3's does at 17 (a lane's bytes lie K/2 apart from the next lane's)
  constexpr bool kStage = kPtr && K >= 16;
  constexpr int kWords = kPtr ? 3 : 2;   // h, the running max, e + ext_q
  extern __shared__ unsigned long long lm_span_smem[];
  const int W = a.W;
  volatile unsigned long long* ring = lm_span_smem;
  volatile int* used =   // rows strip w has read from set w-1
      reinterpret_cast<volatile int*>(lm_span_smem + kSlot * kRing * (W + 1));
  for (int k = threadIdx.x; k < kSlot * kRing * (W + 1); k += blockDim.x)
    ring[k] = 0;
  if ((int)threadIdx.x <= W) used[threadIdx.x] = 0;
  const int t = lm_strip::take_ticket(a.ticket);   // a barrier
  const int inst = t / a.C;
  const int seg = t - inst * a.C;
  const int g = inst / a.B;
  const int b = inst - g * a.B;
  const int R = a.R;
  const int nw = min(W, a.S - seg * W);   // strips of this block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned long long* edges =
      a.edges + (int64_t)inst * (a.C - 1) * R * kWords;
  if (warp == 0) {
    if (seg > 0) {
      lm_strip::receive_rows<kWords>(
          edges + (int64_t)(seg - 1) * R * kWords, ring, used, R, lane);
    }
    return;
  }
  if (warp > nw) return;

  const int N = a.N, n1 = N + 1;
  const int s = seg * W + warp - 1;       // the window's strip
  const int c0 = s * 32 * K;              // the strip's first column
  const int cb = c0 + lane * K;           // this lane's first column
  const bool col0 = s == 0 && lane == 0;
  const bool feeds = s + 1 < a.S;
  const float gap_open = a.gap_open, gap_extend = a.gap_extend;
  const float* qb = a.q + (int64_t)b * N * 5;
  const float* ec = a.ext_cum + (int64_t)b * n1;
  const float* h0 = kPtr ? a.h_in + ((int64_t)g * a.B + b) * n1 : nullptr;
  const float* f0 = kPtr ? a.f_in + ((int64_t)g * a.B + b) * n1 : nullptr;
  const int pl = kPtr ? 0 : a.p_len[b];
  const int ql = a.q_len[b];

  // per instance, once: the held columns' qw (of q column c-1), ext_q (of
  // q column c, the next column's kEExt test), ext_cum and the carry
  float H[K], F[K], EC[K];
  float EQ[kPtr ? K : 1];
  float QW[5 * K];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const int c = cb + m;
    float qv[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (c >= 1 && c <= N) {
#pragma unroll
      for (int x = 0; x < 5; ++x) qv[x] = qb[(c - 1) * 5 + x];
    }
#pragma unroll
    for (int y = 0; y < 5; ++y) QW[m * 5 + y] = qw_of(qv, a.w5, y);
    if (kPtr) {
      EQ[m] = c < N ? __fmul_rn(gap_extend, __fsub_rn(1.0f, qb[c * 5 + 4]))
                    : 0.f;
    }
    EC[m] = c <= N ? ec[c] : 0.f;
    if (kPtr) {
      H[m] = c <= N ? h0[c] : kNegBig;
      F[m] = c <= N ? f0[c] : kNegBig;
    } else {
      H[m] = c == 0 ? 0.f : (c <= N ? gap_open + EC[m] : kNegBig);
      F[m] = kNegBig;
    }
  }
  // H[i-1][c0-1], the first column's diagonal (strips after the first)
  float h_left = kNegBig;
  if (s > 0) h_left = kPtr ? h0[c0 - 1] : gap_open + ec[c0 - 1];
  if (!kPtr && pl == 0) {   // the score of a window of no rows: row 0's
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (cb + m == ql) a.score[b] = H[m];
    }
  }

  // where the strip reads its row words from and hands its own on
  const volatile unsigned long long* in_ring =
      ring + (int64_t)(warp - 1) * kRing * kSlot;
  volatile unsigned long long* out_ring =
      ring + (int64_t)warp * kRing * kSlot;
  volatile unsigned long long* out_edge =
      edges + (int64_t)seg * R * kWords;
  const bool to_edge = warp == nw;
  // K25: the instance's packed rows and the strip's staging row
  const int64_t width = (N + 2) / 2;
  unsigned char* prows =
      kPtr ? a.ptr + ((int64_t)g * a.B + b) * R * width : nullptr;
  unsigned char* stg =
      reinterpret_cast<unsigned char*>(
          lm_span_smem + kSlot * kRing * (W + 1) + (W + 2) / 2) +
      (warp - 1) * span_stage_bytes(K);
  const int seg_bytes =
      (int)(width - c0 / 2 < 16 * K ? width - c0 / 2 : 16 * K);

  // the instance's profile rows, 32 at a time, a row a lane; row i's
  // five values reach every lane by shuffles
  const float* pb =
      a.p + ((int64_t)b * a.M + (int64_t)(a.first + g) * R) * 5;
  float P[5], PN[5];
  auto load_rows = [&](int first) {
    const int r = first + lane;
#pragma unroll
    for (int x = 0; x < 5; ++x) PN[x] = r < R ? pb[r * 5 + x] : 0.f;
  };
  load_rows(0);
  int ck = 0;   // K24: the next carry, at the top of row ck * KR + 1
  for (int i = 1; i <= R; ++i) {
    if (!kPtr && i - 1 == ck * a.KR) {
      const int64_t off = ((int64_t)ck++ * a.B + b) * n1;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (cb + m <= N) {
          a.ck_h[off + cb + m] = H[m];
          a.ck_f[off + cb + m] = F[m];
        }
      }
    }
    const int r = (i - 1) & 31;
    if (r == 0) {
#pragma unroll
      for (int x = 0; x < 5; ++x) P[x] = PN[x];
      load_rows(i + 31);
    }
    float pc[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) pc[x] = __shfl_sync(kFull, P[x], r);
    const float ext_pi = __fmul_rn(gap_extend, __fsub_rn(1.0f, pc[4]));

    // 1. F and G; the running max of Wv over the lane's columns
    float hl = __shfl_up_sync(kFull, H[K - 1], 1);
    if (lane == 0) hl = h_left;
    float run = -INFINITY;
    unsigned dmask = 0, fmask = 0;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const float hp = H[m];
      const float fp = F[m];
      const float fo = (hp + gap_open) + ext_pi;
      const float fe = fp + ext_pi;
      const float f = fmaxf(fo, fe);
      if (kPtr && f == fe && fp > kNegBig / 2) fmask |= 1u << m;
      F[m] = f;
      float g2 = f;
      if (m > 0 || !col0) {
        float sc = __fmul_rn(pc[0], QW[m * 5]);
        sc = __fmaf_rn(pc[1], QW[m * 5 + 1], sc);
        sc = __fmaf_rn(pc[2], QW[m * 5 + 2], sc);
        sc = __fmaf_rn(pc[3], QW[m * 5 + 3], sc);
        sc = __fmaf_rn(pc[4], QW[m * 5 + 4], sc);
        const float diag = hl + sc;
        g2 = fmaxf(diag, f);
        if (kPtr && g2 == diag) dmask |= 1u << m;
      }
      hl = hp;   // column m's H[i-1] is column m+1's diagonal
      H[m] = g2;
      run = fmaxf(run, (g2 + gap_open) - EC[m]);
    }

    // 2. the exclusive max-scan over the lanes, then the strip's carry
    float x = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x = fmaxf(n, x);
    }
    float pre = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) pre = -INFINITY;
    float eeq_in = 0.f;
    if (s > 0) {
      const volatile unsigned long long* sl =
          in_ring + (i % kRing) * kSlot;
      h_left = await_row_word(sl, i);   // H[i][c0-1], next row's diagonal
      pre = fmaxf(pre, await_row_word(sl + 1, i));
      if (kPtr) eeq_in = await_row_word(sl + 2, i);
      __syncwarp();
      if (lane == 0) used[warp] = i;
    }

    // 3. H = max(G, E) and (K25) the pointer nibbles: nibble m of the
    // lane at bits 4m of nib, from m = 16 on at bits 4(m-16) of nib_hi
    float e0 = 0.f, eeq = 0.f;   // eeq: the previous column's e + ext_q
    unsigned long long nib = 0;
    unsigned nib_hi = 0;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int c = cb + m;
      const float g2 = H[m];
      const float wv = (g2 + gap_open) - EC[m];
      if (m == 0 && col0) {   // column 0: H = G, the pointer F
        pre = fmaxf(pre, wv);
        if (kPtr) nib = kHF | ((fmask & 1u) ? kFExt : 0);
        continue;
      }
      const float e = EC[m] + pre;
      pre = fmaxf(pre, wv);
      const float h = fmaxf(g2, e);
      H[m] = h;
      if (kPtr) {
        const unsigned src = (((dmask >> m) & 1u) && h == g2)
                                 ? kHDiag
                                 : (h == e ? kHE : kHF);
        unsigned out = src | (((fmask >> m) & 1u) ? kFExt : 0);
        if (m == 0) {
          e0 = e;
        } else if (c >= 2 && e == eeq) {
          out |= kEExt;
        }
        if (c <= N) {
          if (m < 16) {
            nib |= (unsigned long long)out << (4 * m);
          } else {
            nib_hi |= out << (4 * (m - 16));
          }
        }
        eeq = e + EQ[m];
      }
    }

    // hand the row to the next strip, before the pointer stores
    if (feeds) {
      if (!to_edge) {
        if (i > kRing) {
          while (used[warp + 1] < i - kRing) {
          }
        }
        if (lane == 31) {
          volatile unsigned long long* sl = out_ring + (i % kRing) * kSlot;
          sl[0] = row_word(H[K - 1], i);
          sl[1] = row_word(pre, i);
          if (kPtr) sl[2] = row_word(eeq, i);
        }
      } else if (lane == 31) {
        volatile unsigned long long* d = out_edge + (int64_t)(i - 1) * kWords;
        d[0] = row_word(H[K - 1], i);
        d[1] = row_word(pre, i);
        if (kPtr) d[2] = row_word(eeq, i);
      }
    }
    if (!kPtr && i == pl) {   // K24: H at (p_len, q_len)
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (cb + m == ql) a.score[b] = H[m];
      }
    }

    if (kPtr) {
      float eeq_left = __shfl_up_sync(kFull, eeq, 1);
      if (lane == 0) eeq_left = eeq_in;
      if (!col0 && cb >= 2 && cb <= N && e0 == eeq_left) nib |= kEExt;
      // Pack: cell 2k in the low nibble of byte k.  c0 is even; at an odd
      // K a lane's first column is odd on odd lanes: that cell is the
      // high nibble of the left lane's last byte, taken by shuffle.
      const unsigned right =
          __shfl_down_sync(kFull, (unsigned)(nib & 0xF), 1);
      auto cell = [&](int j) -> unsigned {   // nibble j, right at j = K
        if (j == K) return right;
        return j < 16 ? (unsigned)(nib >> (4 * j)) & 0xF
                      : (nib_hi >> (4 * (j - 16))) & 0xF;
      };
      const bool odd = cb & 1;
      const int c_first = cb + (odd ? 1 : 0);   // an even column
      unsigned char* prow = prows + (int64_t)(i - 1) * width;
#pragma unroll
      for (int k = 0; k < (K + 1) / 2; ++k) {
        const int c = c_first + 2 * k;
        // at an odd K odd lanes hold (K - 1) / 2 whole bytes, even lanes
        // (K + 1) / 2; at an even K every lane K / 2
        if ((!odd || k < (K - 1) / 2) && c <= N) {
          const unsigned v = odd ? cell(2 * k + 1) | (cell(2 * k + 2) << 4)
                                 : cell(2 * k) | (cell(2 * k + 1) << 4);
          if (kStage) {
            stg[(c - c0) >> 1] = (unsigned char)v;
          } else {
            prow[c >> 1] = (unsigned char)v;
          }
        }
      }
      if (kStage) {
        __syncwarp();
        store_stage(stg, prow + c0 / 2, seg_bytes, lane);
        __syncwarp();   // the next row's bytes overwrite the staging row
      }
    }
  }
}

template <bool kPtr>
const void* span_kernel_of(int g) {
  switch (g) {
    case 0: return (const void*)span_kernel<17, kPtr>;
    case 1: return (const void*)span_kernel<16, kPtr>;
    case 2: return (const void*)span_kernel<13, kPtr>;
    case 3: return (const void*)span_kernel<9, kPtr>;
    case 4: return (const void*)span_kernel<8, kPtr>;
    case 5: return (const void*)span_kernel<5, kPtr>;
    case 6: return (const void*)span_kernel<3, kPtr>;
    default: return (const void*)span_kernel<1, kPtr>;
  }
}

// Scratch of a K24 (R = M, G = 1) or K25 launch, carved from one
// allocation: ext_cum [B, N+1] and its cumsum levels, then the hand-off
// columns [G*B, C-1, R, words] (2 words a row for K24, 3 for K25) and the
// ticket, which the launcher zeroes.
struct SpanScratch {
  int64_t ext_cum, cum_lv, edges, ticket, total;
};

inline SpanScratch span_scratch(int B, int G, int R, int N, int C,
                                bool ptr) {
  auto up = [](int64_t x) { return (x + 15) & ~(int64_t)15; };
  SpanScratch w;
  int64_t o = 0;
  w.ext_cum = o;
  o += up(4LL * B * (N + 1));
  w.cum_lv = o;
  o += up(4LL * B * lm::cum_scratch(N));
  w.edges = o;
  o += 8LL * G * B * (C - 1) * R * (ptr ? 3 : 2);
  w.ticket = o;
  o += 16;
  w.total = o;
  return w;
}

template <int K, bool kPtr>
void launch_span_k(unsigned grid, int threads, int64_t smem, void* stream,
                   const SpanArgs& a) {
  const auto kernel = span_kernel<K, kPtr>;
  LM_LAUNCH(kernel, grid, threads, (size_t)smem, (cudaStream_t)stream, a);
}

// The launch of a K24 (kPtr false) or K25 geometry: zero the hand-off
// columns and the ticket, ext_cum, then the strips.  `instances`: G*B.
template <bool kPtr>
int launch_span(SpanArgs a, int g, int W, int instances, char* scratch,
                void* stream) {
  if (g < 0 || g >= kSpanGeometryCount || W < 1 || W > kSpanMaxW)
    return (int)cudaErrorInvalidValue;
  const int K = kSpanK[g];
  a.S = span_strips(a.N, K);
  a.W = W;
  a.C = (a.S + W - 1) / W;
  const SpanScratch w =
      span_scratch(a.B, a.B > 0 ? instances / a.B : 0, a.R, a.N, a.C, kPtr);
  a.ext_cum = (const float*)(scratch + w.ext_cum);
  a.edges = (unsigned long long*)(scratch + w.edges);
  a.ticket = (unsigned*)(scratch + w.ticket);
  if (instances == 0 || a.R == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(scratch + w.edges, 0,
                                    (size_t)(w.total - w.edges),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  LM_LAUNCH(span_ext_cum_kernel, (unsigned)a.B, 1024, 0,
            (cudaStream_t)stream, a.q, (float*)(scratch + w.ext_cum),
            (float*)(scratch + w.cum_lv), a.N, a.gap_extend);
  const int64_t smem = span_smem_bytes(K, W, kPtr);
  const unsigned grid = (unsigned)((int64_t)instances * a.C);
  const int threads = 32 * (W + 1);
  switch (g) {
    case 0: launch_span_k<17, kPtr>(grid, threads, smem, stream, a); break;
    case 1: launch_span_k<16, kPtr>(grid, threads, smem, stream, a); break;
    case 2: launch_span_k<13, kPtr>(grid, threads, smem, stream, a); break;
    case 3: launch_span_k<9, kPtr>(grid, threads, smem, stream, a); break;
    case 4: launch_span_k<8, kPtr>(grid, threads, smem, stream, a); break;
    case 5: launch_span_k<5, kPtr>(grid, threads, smem, stream, a); break;
    case 6: launch_span_k<3, kPtr>(grid, threads, smem, stream, a); break;
    default: launch_span_k<1, kPtr>(grid, threads, smem, stream, a); break;
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

// Bytes of scratch a K3 (ptr != 0) or K9 launch of B windows in an N-column
// bucket takes, in one allocation: 0 on the strip route (N <= kStripMaxN);
// on the wide route its qw, ext_q, ext_cum, cumsum levels and, with
// rows_global, the rows and flags.
extern "C" int64_t lm_profile_scratch_bytes(int B, int N, int ptr,
                                            int rows_global) {
  if (N <= kStripMaxN) return 0;
  return wide_scratch(B, N, ptr != 0, rows_global != 0).total;
}

// K3 (ptr non-null) and K9 (ptr null).  p: f32[B, M, 5]; q: f32[B, N, 5];
// p_len, q_len: int32[B]; scratch: lm_profile_scratch_bytes(B, N, ptr,
// rows_global) bytes, 16-byte aligned, or null where that is 0; ptr:
// uint8[B, M, N+1] (zero outside rows 1..p_len and columns 0..q_len: the
// strip route writes every byte, the wide route, N > kStripMaxN, only
// the window's, so the caller zero-fills it there), or null; score:
// f32[B]; rows_global: the wide
// route's rows in global scratch instead of shared memory; w5: HOST
// float[25]; geometry: an index of kStripK to force (strip route
// only), or -1 for the launcher's pick; taken: HOST int[6], the geometry
// the launch took as lm_profile_geometry describes it, or null.  The
// route is N's alone.
extern "C" int lm_profile_fwd(const void* p, const void* q, const void* p_len,
                              const void* q_len, void* scratch, void* ptr,
                              void* score, int B, int M, int N,
                              int rows_global, float gap_open,
                              float gap_extend, const float* w5,
                              int geometry, int* taken, void* stream) {
  if (geometry >= kStripGeometryCount || (N > kStripMaxN && geometry >= 0))
    return (int)cudaErrorInvalidValue;
  if (N <= kStripMaxN) {
    StripArgs a = {(const float*)p, (const float*)q, (const int*)p_len,
                   (const int*)q_len, (unsigned char*)ptr, (float*)score,
                   B, M, N, 0, 0, gap_open, gap_extend, {}};
    for (int k = 0; k < 25; ++k) a.w5.w[k] = w5[k];
    return ptr != nullptr ? launch_strips<true>(geometry, a, stream, taken)
                          : launch_strips<false>(geometry, a, stream, taken);
  }
  const WideScratch w = wide_scratch(B, N, ptr != nullptr, rows_global != 0);
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (taken != nullptr) {
    const cudaError_t err =
        describe_wide(N, ptr != nullptr, rows_global != 0, taken);
    if (err != cudaSuccess) return (int)err;
  }
  char* s = (char*)scratch;
  ProfileArgs a = make_args(p, q, q_len, s + w.qw, s + w.ext_q,
                            s + w.ext_cum, s + w.cum_lv,
                            w.rows >= 0 ? s + w.rows : nullptr, B, M, N,
                            gap_open, gap_extend, w5);
  a.p_len = (const int*)p_len;
  a.flags = w.flags >= 0 ? (unsigned char*)(s + w.flags) : nullptr;
  a.ptr = (unsigned char*)ptr;
  a.score = (float*)score;
  return ptr != nullptr ? launch_profile<true>(a, stream)
                        : launch_profile<false>(a, stream);
}

// The geometry of a K3 (ptr != 0) or K9 launch of B windows in an
// N-column bucket on the current card: strip geometry g, or for g < 0 the
// launcher's pick.  out: int[6] = {route (0 strips, 1 wide), geometry, K,
// warps a window, windows a block, windows an SM}; on the strip route
// out[5] is 0 where g does not fit the bucket, on the wide route it is
// the blocks an SM holds with the rows where rows_global puts them (as
// for lm_profile_fwd; the strips ignore it).  Returns -1 for
// g past the table's end or g >= 0 on the wide route, else a cudaError_t.
extern "C" int lm_profile_geometry(int B, int N, int ptr, int g,
                                   int rows_global, int* out) {
  if (g >= kStripGeometryCount || (N > kStripMaxN && g >= 0)) return -1;
  if (N > kStripMaxN)
    return (int)describe_wide(N, ptr != 0, rows_global != 0, out);
  StripPlan pl;
  const cudaError_t err = strip_pick(B, N, ptr != 0, g, &pl);
  if (err != cudaSuccess) return (int)err;
  describe_strips(pl, out);
  return 0;
}

// Bytes of scratch a K24 (ptr 0, G = 1, R = M) or K25 launch of G row
// blocks of R rows for B windows in an N-column bucket takes in geometry
// (g, W): ext_cum, its cumsum levels, the hand-off columns and the
// ticket; -1 for a geometry past the table.
extern "C" int64_t lm_span_scratch_bytes(int B, int G, int R, int N, int g,
                                         int W, int ptr) {
  if (g < 0 || g >= kSpanGeometryCount || W < 1 || W > kSpanMaxW) return -1;
  const int S = span_strips(N, kSpanK[g]);
  return span_scratch(B, G, R, N, (S + W - 1) / W, ptr != 0).total;
}

// The fits of K24 (ptr 0) or K25 on the current card, for the host's
// pick (lm_strip::span_fits).
extern "C" int lm_span_fits(int ptr, int* out) {
  return lm_strip::span_fits(
      out,
      [ptr](int g) {
        return ptr ? span_kernel_of<true>(g) : span_kernel_of<false>(g);
      },
      [ptr](int g, int W) { return span_smem_bytes(kSpanK[g], W, ptr != 0); });
}

// K24.  p: f32[B, M, 5] (M a multiple of K), q: f32[B, N, 5]; p_len,
// q_len: int32[B]; scratch: lm_span_scratch_bytes(B, 1, M, N, g, W)
// bytes, 16-byte aligned; score: f32[B]; ck_h, ck_f: f32[M / K, B, N+1],
// the (H, F) carry at the top of every K-row block (block 0: the DP's
// first row); w5: HOST float[25]; (g, W): the geometry.  Every row and
// column is computed.
extern "C" int lm_profile_ckpt(const void* p, const void* q,
                               const void* p_len, const void* q_len,
                               void* scratch, void* score, void* ck_h,
                               void* ck_f, int B, int M, int N, int K,
                               float gap_open, float gap_extend,
                               const float* w5, int g, int W, void* stream) {
  if (K < 1 || M % K != 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  SpanArgs a = {};
  a.p = (const float*)p;
  a.q = (const float*)q;
  a.p_len = (const int*)p_len;
  a.q_len = (const int*)q_len;
  a.score = (float*)score;
  a.ck_h = (float*)ck_h;
  a.ck_f = (float*)ck_f;
  a.B = B;
  a.M = M;
  a.N = N;
  a.R = M;
  a.KR = K;
  a.gap_open = gap_open;
  a.gap_extend = gap_extend;
  for (int k = 0; k < 25; ++k) a.w5.w[k] = w5[k];
  return launch_span<false>(a, g, W, B, (char*)scratch, stream);
}

// K25 over G row blocks at once.  p: f32[B, M, 5] the windows' rows (M
// >= (first + G) * R), q: f32[B, N, 5]; q_len: int32[B]; h_in, f_in:
// f32[G, B, N+1], the carries at the tops of blocks first .. first+G-1
// (rows of K24's ck_h / ck_f); scratch: lm_span_scratch_bytes(B, G, R,
// N, g, W) bytes; ptr: uint8[G, B, R, (N+2)/2], two cells a byte, every
// row and column written (a zero pad cell at an odd N+1).
extern "C" int lm_profile_block_ptrs(const void* p, const void* q,
                                     const void* q_len, const void* h_in,
                                     const void* f_in, void* scratch,
                                     void* ptr, int B, int M, int N, int R,
                                     int first, int G, float gap_open,
                                     float gap_extend, const float* w5,
                                     int g, int W, void* stream) {
  if (R < 1 || first < 0 || G < 0 || (int64_t)(first + G) * R > M ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  SpanArgs a = {};
  a.p = (const float*)p;
  a.q = (const float*)q;
  a.q_len = (const int*)q_len;
  a.h_in = (const float*)h_in;
  a.f_in = (const float*)f_in;
  a.ptr = (unsigned char*)ptr;
  a.B = B;
  a.M = M;
  a.N = N;
  a.R = R;
  a.first = first;
  a.KR = R;
  a.gap_open = gap_open;
  a.gap_extend = gap_extend;
  for (int k = 0; k < 25; ++k) a.w5.w[k] = w5[k];
  return launch_span<true>(a, g, W, G * B, (char*)scratch, stream);
}
