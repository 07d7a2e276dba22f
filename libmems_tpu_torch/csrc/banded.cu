// K10: banded profile DP forward with the optimality certificate, and
// K11: the same forward with banded pointer bytes; K12: the traceback
// walk over the banded pointers.
//
// K10 replaces libmems_tpu/ops/profile.py _banded_block_scan(emit_ptr=
// False) + _banded_forward_scores (the refine gate); K11 replaces
// _banded_block_scan(emit_ptr=True), the forward half of _banded_fwd_tb;
// K12 replaces the `step` scan of _banded_fwd_tb.
//
// The band.  Block bi of 128 rows covers global columns lo..lo+WB with
//   lo = clip((bi*128*q_len) // max(p_len,1) - (H_W+1), 0, N-WB),
// WB = 256 + 2*H_W + 2 and H_W = max(127, N/16-1): w1 = WB+1 = 513 local
// columns in the 1024-2048 buckets, 1,715 at 11,664.  At a block boundary
// the carried H and F rows shift left by the change of lo, and a source
// column beyond WB becomes NEG_BIG (ops/profile.py:334-341).  Local column
// w reads q column lo+w-1 and ext_cum[lo+w]; w = 0 behaves as column 0 of
// K3 (H = F there).  A window's score is H at qlen_loc = clip(q_len - lo,
// 0, WB), picked at row p_len (:375-379).  Only columns 0..qlen_loc and
// rows 1..p_len are computed and written: no value the score or the walk
// reads depends on the others.
//
// Geometry (K10 and K11 alike).  One thread block a window, S warps a
// block; lane l of warp s holds the K consecutive band columns from
// (32*s + l)*K in registers (H, F, ext_cum, ext_q and, in the register
// geometries, the five qw values of each column).  A warp is a strip of
// 32*K columns, and S = ceil(w1 / (32*K)).  The launcher picks K from
// {17, 13, 9, 5} (qw in registers) or 17 with qw in shared memory (bands
// too wide for the register geometries) by the cost of a row of the
// launch (kGeometries, band_plan): an SM's strips times a strip's row,
// and no fewer strips than an SM's four schedulers issue from.  Many
// windows at w1 = 513 take one warp of 17 for K10 (8 windows an SM) and
// two of 9 for K11, whose pointer bytes push K = 17 past 255 registers;
// a lone window takes strips of 5 (11 warps at w1 = 1,715).
// lm_banded_geometry says which.
//
// A row in a strip, with no block-wide barrier:
//  1. F and G for each held column; the diagonal neighbour H[i-1][c-1]
//     comes from the lane to the left by one __shfl_up_sync (from the
//     strip to the left at the strip's first column).
//  2. The E running maximum: each lane's max of Wv[c] = (g + open) -
//     ext_cum[lo+c] over its columns, a __shfl_up_sync max-scan over the
//     lanes, then the maximum carried in from the strip to the left.
//  3. H = max(G, E) and the pointer bytes, carrying the prefix along the
//     lane's columns; the kEExt test of the lane's first column reads
//     column c-1's e + ext_q from the lane (or strip) to the left.
// Strips run the rows as a pipeline: strip s does row i while strip s-1
// is already on a later row.  Strip s-1 hands strip s, through a ring of
// kRing rows in shared memory, its last column's H, its running maximum
// and its last e + ext_q, each stored with its row number in one 64-bit
// word (a reader that sees the row sees the value: no memory fence on
// either side); strip s publishes in a per-strip flag the rows it has
// read, so that strip s-1 never overwrites a slot not yet read.  The
// 128-row block boundary is the one block-level exchange: every strip's
// H and F go to shared memory and come back shifted by the change of lo
// (two or three __syncthreads per 128 rows), the block's 128 profile
// rows are staged, and each lane rebuilds its columns' qw, ext_cum and
// ext_q for the new lo from q and the window's ext_cum (no qw scratch in
// global memory).
//
// Why the bits are the plain version's.  Every per-cell expression is
// K3's, in its order: fo = (hp + open) + ext_pi, fe = fp + ext_pi, the
// FMA chain of the row score over qw formed as ((t0+t1)+(t2+t3))+t4, Wv
// = (g + open) - ext_cum, e = ext_cum + prefix max, the kEExt test
// against column c-1's e + ext_q, ext_cum the blocked cumsum of the whole
// row from column 0, gathered at lo+c.  Only the E maximum is associated
// differently (lanes, then strips), and a maximum of floats is exact in
// any association; so scores, certificates and pointer bytes are those
// of banded_forward_plain, the goldens and the JAX package.
//
// Bound.  Operations: about 20 a cell (ops/profile.py DP_CELL_OPS in
// chip_smoke.py), 4.27 G cells for the refine gate of 9 x 1 Mbp.  The
// issue floor is tighter: about 16-20 warp instructions a cell in the
// register geometries, so 4.27 G cells need 4-5 ms on 132 SMs at four
// warp instructions a clock.  K11 also writes w1 pointer bytes a row; K12
// is latency-bound as K4 (one dependent byte a step): the walk of
// csrc/walk.cuh, one warp a window over a ring of band rows in shared
// memory.
//
// Certificate (ops/profile.py:381-406), in the epilogue: gap_bound is
// the blocked prefix sum, read at g_lb - 1 with g_lb = max(2*H_W -
// 3*|q_len - p_len|, 0), of the window's gap costs (gap_extend *
// occupancy over the p_len rows and q_len columns, -inf elsewhere and
// summed as 0) sorted descending, as the JAX code sorted them with
// lax.sort.  A blocked prefix sum at an index depends only on the
// entries up to it, so the kernel selects the g_lb largest costs
// (band_gap_bound: a radix select, a bitonic sort of those) instead of
// sorting all Mp + N; the same values in the same order give the same
// bits.  sumcap is the last element of the blocked prefix sum of
// max(max_y qw[y][j], 0) over the columns j < q_len (0 beyond); cert =
// score > ((sumcap + open) + gap_bound) + 64.
#include "common.cuh"
#include "strip.cuh"
#include "walk.cuh"

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned char kHDiag = 0, kHE = 1, kHF = 2, kEExt = 4, kFExt = 8;
constexpr int kBandK = 128;
using lm_strip::await_row_word;
using lm_strip::kFull;
using lm_strip::kIssueWarps;
using lm_strip::kRing;
using lm_strip::kSlot;
using lm_strip::qw_of;
using lm_strip::row_word;
using lm_strip::sm_count;

__device__ __forceinline__ int band_lo(int bi, int ql, int plc, int H_W,
                                       int lo_cap) {
  const long long t =
      ((long long)bi * kBandK * ql) / plc - (long long)(H_W + 1);
  return (int)(t < 0 ? 0 : (t > lo_cap ? lo_cap : t));
}

// Floats of dynamic shared memory a block of S warps takes: the exchange
// rows (2 per column; 5 when they share the region with qw), the hand-off
// ring of 64-bit words and a flag a strip.
__host__ __device__ inline int64_t band_smem_floats(int K, int S,
                                                    bool qw_reg) {
  return (int64_t)(qw_reg ? 2 : 5) * 32 * S * K +
         (int64_t)2 * kSlot * S * kRing + S;
}

// Order-preserving 32-bit key of a float (larger float, larger key) and
// its inverse.
__device__ __forceinline__ unsigned float_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The certificate's gap bound (ops/profile.py:388-398), by the whole
// block: the window's gap costs sorted descending, their -inf entries
// summed as 0, the blocked prefix sum read at n - 1.  The costs are
// gap_extend * (1 - p[i][4]) over rows i < pl and ext_q[j] over columns
// j < ql (f = pl + ql finite ones; the rest of the Mp + N are -inf), and
// n = min(g_lb, Mp + N) > 0.  The blocked prefix sum at n - 1 depends on
// the n largest only: a radix select (8 bits a pass) finds the m-th
// largest key, m = min(n, f); the m largest are gathered, sorted by a
// bitonic network, padded with n - m zeros and summed in the blocked
// order.  sel: shared, at least max(n, 2^ceil(log2 m)) floats; hist:
// shared, 256 ints.
__device__ float band_gap_bound(const float* pb, const float* eq, int pl,
                                int ql, int n, float gap_extend, float* sel,
                                int* hist, float* lv) {
  __shared__ int s_pick[3];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int f = pl + ql;
  const int m = n < f ? n : f;
  auto cost = [&](int k) {
    return k < pl ? __fmul_rn(gap_extend, __fsub_rn(1.0f, pb[k * 5 + 4]))
                  : eq[k - pl];
  };
  unsigned prefix = 0, mask = 0;
  int need = m;   // of the m largest, those equal to the key found so far
  for (int shift = 24; m > 0 && shift >= 0; shift -= 8) {
    for (int d = tid; d < 256; d += T) hist[d] = 0;
    __syncthreads();
    for (int k = tid; k < f; k += T) {
      const unsigned u = float_key(cost(k));
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0, d = 255;
      for (; d > 0 && acc + hist[d] < need; --d) acc += hist[d];
      s_pick[0] = d;
      s_pick[1] = need - acc;
    }
    __syncthreads();
    prefix |= (unsigned)s_pick[0] << shift;
    mask |= 255u << shift;
    need = s_pick[1];
    __syncthreads();
  }
  int P = 1;
  while (P < m) P <<= 1;
  if (tid == 0) s_pick[2] = 0;
  __syncthreads();
  for (int k = tid; k < f && m > 0; k += T) {
    const float v = cost(k);
    if (float_key(v) > prefix) sel[atomicAdd(&s_pick[2], 1)] = v;
  }
  __syncthreads();
  const float v_m = key_float(prefix);   // the m-th largest
  for (int k = m - need + tid; k < P; k += T) sel[k] = k < m ? v_m : -INFINITY;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {   // descending
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += T) {
        const int lo = 2 * t - (t & (stride - 1));
        const float x = sel[lo], y = sel[lo + stride];
        if ((x < y) == ((lo & size) == 0)) {
          sel[lo] = y;
          sel[lo + stride] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int k = m + tid; k < n; k += T) sel[k] = 0.f;
  __syncthreads();
  lm::blocked_cumsum(sel, sel, n, lv);
  return sel[n - 1];
}

// A launch's arguments (lm_banded_fwd).
struct BandArgs {
  const float* p;
  const float* q;
  const int* p_len;
  const int* q_len;
  float* ext_q;
  float* ext_cum;
  float* cum_lv;
  int64_t cum_lv_stride;
  float* capbuf;
  unsigned char* ptr;
  float* score;
  unsigned char* cert;
  float* bound;
  int Mp, N, H_W;
  float gap_open, gap_extend;
  lm::W5 w5;
};

// One window (block b) in a geometry: K band columns a lane, qw in
// registers or in shared memory.
template <int K, bool kPtr, bool kQwReg>
__device__ __forceinline__ void banded_window(const BandArgs& a) {
  const float* __restrict__ p = a.p;
  const float* __restrict__ q = a.q;
  float* __restrict__ ext_q = a.ext_q;
  float* __restrict__ ext_cum = a.ext_cum;
  unsigned char* __restrict__ ptr = a.ptr;
  const int Mp = a.Mp, N = a.N, H_W = a.H_W;
  const float gap_open = a.gap_open, gap_extend = a.gap_extend;
  const lm::W5& w5 = a.w5;
  extern __shared__ float lm_smem[];
  __shared__ float s_score;
  __shared__ float s_prow[kBandK * 5];   // the band block's profile rows

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int S = T >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int WB = kBandK * 2 + 2 * H_W + 2;
  const int C = T * K;                  // columns the block holds
  const int lo_cap = N - WB > 0 ? N - WB : 0;
  const int pl = a.p_len[b];
  const int ql = a.q_len[b];
  const int plc = pl > 1 ? pl : 1;
  const int c0 = warp * 32 * K;         // the strip's first column
  const int cb = c0 + lane * K;         // this lane's first column
  const bool col0 = tid == 0;           // the lane holding column 0

  // exchange rows [H | F], and qw [5][K][T] where it is not in registers;
  // then the ring: slot r of strip s holds {H[i][last], running max,
  // e + ext_q of its last column} of row i = r (mod kRing)
  float* region = lm_smem;
  volatile unsigned long long* ring =
      reinterpret_cast<volatile unsigned long long*>(lm_smem +
                                                     (kQwReg ? 2 : 5) * C);
  volatile int* used =   // rows a strip has read from the one before
      reinterpret_cast<volatile int*>(ring + kSlot * S * kRing);

  const float* qb = q + (int64_t)b * N * 5;
  const float* pb = p + (int64_t)b * Mp * 5;
  float* eq = ext_q + (int64_t)b * N;
  float* ec = ext_cum + (int64_t)b * (N + 1);
  float* lv = a.cum_lv + (int64_t)b * a.cum_lv_stride;

  for (int j = tid; j < ql; j += T)
    eq[j] = __fmul_rn(gap_extend, __fsub_rn(1.0f, qb[j * 5 + 4]));
  for (int k = tid; k < kSlot * S * kRing; k += T) ring[k] = 0;
  if (tid < S) used[tid] = 0;
  __syncthreads();
  lm::blocked_cumsum(eq, ec + 1, ql, lv);
  if (tid == 0) {
    ec[0] = 0.f;
    s_score = ql == 0 ? 0.f : gap_open + ec[ql];   // H[0][q_len]
  }
  // the profile rows of a band block, staged in shared memory
  auto stage_rows = [&](int bi) {
    const int n = (pl - bi * kBandK < kBandK ? pl - bi * kBandK : kBandK) * 5;
    for (int k = tid; k < n; k += T) s_prow[k] = pb[bi * kBandK * 5 + k];
  };
  stage_rows(0);
  __syncthreads();

  float H[K], F[K], EC[K];
  float EQ[kPtr ? K : 1];
  float QW[kQwReg ? 5 * K : 1];
  float* qws = region + tid;   // this thread's qw: qws[(y*K + m)*T]

  // the held columns' ext_cum[lo+c], ext_q[lo+c] (column c+1's kEExt
  // test) and qw of q column lo+c-1; 0 beyond q_len, never read there
  auto load_cols = [&](int lo) {
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int g = lo + cb + m;
      EC[m] = g <= ql ? ec[g] : 0.f;
      if (kPtr) EQ[m] = g < ql ? eq[g] : 0.f;
      float qv[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (cb + m >= 1 && g - 1 < ql) {
#pragma unroll
        for (int x = 0; x < 5; ++x) qv[x] = qb[(g - 1) * 5 + x];
      }
#pragma unroll
      for (int y = 0; y < 5; ++y) {
        const float v = qw_of(qv, w5, y);
        if (kQwReg) {
          QW[m * 5 + y] = v;
        } else {
          qws[(y * K + m) * T] = v;
        }
      }
    }
  };

  // block 0: lo == 0, the global first row
  int lo = 0;
  int qlen_loc = ql < WB ? ql : WB;
  load_cols(0);
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const int c = cb + m;
    H[m] = c == 0 ? 0.f : (c <= qlen_loc ? gap_open + ec[c] : kNegBig);
    F[m] = kNegBig;
  }
  // H[i-1][c0-1] for the strip's first column (strips after the first)
  float h_left = c0 >= 1 && c0 - 1 <= qlen_loc ? gap_open + ec[c0 - 1]
                                               : kNegBig;

  for (int bi = 0; bi * kBandK < pl; ++bi) {
    if (bi > 0) {
      // the one block-level exchange of a 128-row block: shift the
      // carried rows left by the change of lo
      const int lo_new = band_lo(bi, ql, plc, H_W, lo_cap);
      const int d = lo_new - lo;
      __syncthreads();
#pragma unroll
      for (int m = 0; m < K; ++m) {
        region[cb + m] = H[m];
        region[C + cb + m] = F[m];
      }
      stage_rows(bi);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int src = cb + m + d;
        H[m] = src <= WB ? region[src] : kNegBig;
        F[m] = src <= WB ? region[C + src] : kNegBig;
      }
      h_left = c0 >= 1 && c0 - 1 + d <= WB ? region[c0 - 1 + d] : kNegBig;
      lo = lo_new;
      int ql_new = ql - lo;
      qlen_loc = ql_new < 0 ? 0 : (ql_new > WB ? WB : ql_new);
      if (!kQwReg) __syncthreads();   // qw overwrites the exchange rows
      load_cols(lo);
    }
    // a strip takes part while its first column is computed, and hands
    // rows on while the next strip's is
    const bool active = c0 <= qlen_loc;
    const bool feeds = c0 + 32 * K <= qlen_loc;
    const int i_end = min((bi + 1) * kBandK, pl);
    if (!active) continue;

    for (int i = bi * kBandK + 1; i <= i_end; ++i) {
      const float* prow_i = s_prow + (i - 1 - bi * kBandK) * 5;
      float pc[5];
#pragma unroll
      for (int x = 0; x < 5; ++x) pc[x] = prow_i[x];
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
          float s;
          if (kQwReg) {
            s = __fmul_rn(pc[0], QW[m * 5]);
            s = __fmaf_rn(pc[1], QW[m * 5 + 1], s);
            s = __fmaf_rn(pc[2], QW[m * 5 + 2], s);
            s = __fmaf_rn(pc[3], QW[m * 5 + 3], s);
            s = __fmaf_rn(pc[4], QW[m * 5 + 4], s);
          } else {
            s = __fmul_rn(pc[0], qws[m * T]);
            s = __fmaf_rn(pc[1], qws[(K + m) * T], s);
            s = __fmaf_rn(pc[2], qws[(2 * K + m) * T], s);
            s = __fmaf_rn(pc[3], qws[(3 * K + m) * T], s);
            s = __fmaf_rn(pc[4], qws[(4 * K + m) * T], s);
          }
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

      // 3. H = max(G, E) and the pointer bytes
      unsigned char* prow =
          kPtr ? ptr + ((int64_t)b * Mp + (i - 1)) * (WB + 1) : nullptr;
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
            if (c <= qlen_loc) prow[c] = out;
          }
          eeq = e + EQ[m];
        }
      }
      if (kPtr) {
        float eeq_left = __shfl_up_sync(kFull, eeq, 1);
        if (lane == 0) eeq_left = eeq_in;
        if (!col0 && cb >= 2 && e0 == eeq_left) byte0 |= kEExt;
        if (cb <= qlen_loc) prow[cb] = byte0;
      }
      if (i == pl) {
#pragma unroll
        for (int m = 0; m < K; ++m) {
          if (cb + m == qlen_loc) s_score = H[m];
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
  }
  __syncthreads();

  // certificate epilogue
  const int L = Mp + N;
  const int dl = ql > pl ? ql - pl : pl - ql;
  int g_lb = 2 * H_W - 3 * dl;
  g_lb = g_lb > 0 ? g_lb : 0;
  const float gap_bound =
      g_lb > 0 ? band_gap_bound(pb, eq, pl, ql, g_lb < L ? g_lb : L,
                                gap_extend, region + 256,
                                reinterpret_cast<int*>(region), lv)
               : 0.f;
  float* cap = a.capbuf + (int64_t)b * N;
  for (int j = tid; j < N; j += T) {
    float m = 0.f;
    if (j < ql) {
      float qv[5];
      for (int x = 0; x < 5; ++x) qv[x] = qb[j * 5 + x];
      m = qw_of(qv, w5, 0);
      for (int y = 1; y < 5; ++y) m = fmaxf(m, qw_of(qv, w5, y));
      m = fmaxf(m, 0.f);
    }
    cap[j] = m;
  }
  __syncthreads();
  lm::blocked_cumsum(cap, cap, N, lv);
  if (tid == 0) {
    if (a.bound != nullptr) a.bound[b] = gap_bound;
    const float rhs = __fadd_rn(__fadd_rn(cap[N - 1], gap_open), gap_bound);
    const float sc = s_score;
    a.score[b] = sc;
    a.cert[b] = sc > __fadd_rn(rhs, 64.0f) ? 1 : 0;
  }
}

template <int K, bool kPtr>
__global__ void banded_kernel(BandArgs a) {
  banded_window<K, kPtr, true>(a);
}

// qw in shared memory, for bands too wide for the register geometries:
// at most 512 threads a block, so that the compiler keeps it to 128
// registers (16 strips a window, or 16 one-warp windows an SM).
template <int K, bool kPtr>
__global__ void __launch_bounds__(512) banded_kernel_smem(BandArgs a) {
  banded_window<K, kPtr, false>(a);
}

// K12's column of DP cell (r+1, j) in banded pointer row r: clip(j -
// lo, 0, WB), lo of r's 128-row block, computed when the walk enters the
// block (band_lo divides in 64 bits).
struct BandCol {
  int ql, plc, H_W, lo_cap, WB;
  int bi = -1, lo = 0;
  __device__ __forceinline__ void enter(int r) {
    const int b = r / kBandK;
    if (b != bi) {
      bi = b;
      lo = band_lo(b, ql, plc, H_W, lo_cap);
    }
  }
  __device__ __forceinline__ int at(int j) const {
    const int w = j - lo;
    return w < 0 ? 0 : (w > WB ? WB : w);
  }
  __device__ __forceinline__ int first_row(int r) const {
    return r / kBandK * kBandK;
  }
};

struct BandColOf {
  const int* p_len;
  const int* q_len;
  int H_W, lo_cap, WB;
  __device__ BandCol operator()(int b) const {
    BandCol c;
    c.ql = q_len[b];
    c.plc = p_len[b] > 1 ? p_len[b] : 1;
    c.H_W = H_W;
    c.lo_cap = lo_cap;
    c.WB = WB;
    return c;
  }
};

template <bool kWhole>
__global__ void banded_walk_kernel(const unsigned char* __restrict__ ptr,
                                   int64_t total,
                                   const int* __restrict__ p_len,
                                   const int* __restrict__ q_len, int B,
                                   int Mp, int N, int H_W, int T, int C16,
                                   lm_walk::Plan pl,
                                   uint32_t* __restrict__ words,
                                   int* __restrict__ counts,
                                   int* __restrict__ steps) {
  const int WB = kBandK * 2 + 2 * H_W + 2;
  const int lo_cap = N - WB > 0 ? N - WB : 0;
  lm_walk::walk_kernel_body<kWhole>(ptr, total, p_len, q_len, B, Mp, WB + 1,
                                    T, C16, pl, words, counts, steps,
                                    BandColOf{p_len, q_len, H_W, lo_cap, WB});
}

using WalkKernel = decltype(&banded_walk_kernel<true>);
const WalkKernel kWalkKernels[2] = {banded_walk_kernel<false>,
                                    banded_walk_kernel<true>};
lm_walk::Card walk_cards[lm_walk::kMaxCards];

// The geometries the launcher chooses from: K band columns a lane, qw in
// registers or in shared memory, and the cost of a held column relative
// to a strip's per-row overhead (100) for K10 and for K11, as measured on
// an H100 (chip_smoke.py profile_dp prints every geometry's time): K11's
// pointer bytes push K = 17 past 255 registers and K = 13 near them, the
// shared-memory geometry spills at its 128, and K = 5's short rows
// overlap best.  A geometry's S is ceil(w1 / (32*K)).
struct Geometry {
  int K;
  bool qw_reg;
  int cost_scores, cost_ptrs;
};
constexpr Geometry kGeometries[] = {{17, true, 100, 170},
                                    {13, true, 100, 115},
                                    {9, true, 100, 100},
                                    {5, true, 85, 85},
                                    {17, false, 130, 250}};
constexpr int kGeometryCount = 5;

template <bool kPtr>
const void* band_kernel_of(int g) {
  switch (g) {
    case 0: return (const void*)banded_kernel<17, kPtr>;
    case 1: return (const void*)banded_kernel<13, kPtr>;
    case 2: return (const void*)banded_kernel<9, kPtr>;
    case 3: return (const void*)banded_kernel<5, kPtr>;
    default: return (const void*)banded_kernel_smem<17, kPtr>;
  }
}

struct Plan {
  int g = -1;      // geometry index
  int S = 0;       // warps a window
  int per_sm = 0;  // windows an SM holds at once
  int64_t smem = 0;
  int64_t cost = 0;
};

// Geometry g for B windows of a band of w1 columns on n_sm SMs: S, the
// shared memory, the windows an SM holds, and the cost of a row of the
// launch, max(ceil(B / n_sm) * S, kIssueWarps) * (K * cost + 100): the
// strips an SM runs (fewer than the schedulers run as fast as one) times
// a strip's row; per_sm == 0 where the block does not fit (threads beyond
// what the kernel's registers allow, or shared memory beyond the opt-in).
inline cudaError_t band_plan(int g, int B, int n_sm, int w1, bool ptr,
                             Plan* out) {
  const Geometry geo = kGeometries[g];
  Plan pl;
  pl.g = g;
  pl.S = (w1 + 32 * geo.K - 1) / (32 * geo.K);
  pl.smem = 4 * band_smem_floats(geo.K, pl.S, geo.qw_reg);
  const int64_t strips = (int64_t)(B + n_sm - 1) / n_sm * pl.S;
  pl.cost = (strips > kIssueWarps ? strips : kIssueWarps) *
            (geo.K * (ptr ? geo.cost_ptrs : geo.cost_scores) + 100);
  const void* fn = ptr ? band_kernel_of<true>(g) : band_kernel_of<false>(g);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  const int threads = 32 * pl.S;
  if (threads <= attr.maxThreadsPerBlock && threads <= 1024 &&
      pl.smem <= lm::max_dyn_smem(fn)) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl.per_sm, fn,
                                                        threads, pl.smem);
    if (err != cudaSuccess) return err;
  }
  *out = pl;
  return cudaSuccess;
}

// The geometry for B windows of a band of w1 columns: the cheapest that
// fits (force >= 0 takes that one where it fits).
inline cudaError_t band_pick(int B, int w1, bool ptr, int force,
                             Plan* out) {
  int n_sm = 0;
  cudaError_t err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  Plan best;
  for (int g = 0; g < kGeometryCount; ++g) {
    if (force >= 0 && g != force) continue;
    Plan pl;
    err = band_plan(g, B, n_sm, w1, ptr, &pl);
    if (err != cudaSuccess) return err;
    if (pl.per_sm > 0 && (best.g < 0 || pl.cost < best.cost)) best = pl;
  }
  if (best.g < 0) return cudaErrorInvalidConfiguration;
  *out = best;
  return cudaSuccess;
}

template <int K, bool kPtr, bool kQwReg>
void launch_geometry(const Plan& pl, const BandArgs& a, int B,
                     void* stream) {
  if constexpr (kQwReg) {
    const auto kernel = banded_kernel<K, kPtr>;
    LM_LAUNCH(kernel, (unsigned)B, 32 * pl.S, (size_t)pl.smem,
              (cudaStream_t)stream, a);
  } else {
    const auto kernel = banded_kernel_smem<K, kPtr>;
    LM_LAUNCH(kernel, (unsigned)B, 32 * pl.S, (size_t)pl.smem,
              (cudaStream_t)stream, a);
  }
}

template <bool kPtr>
int launch_banded(int force, const BandArgs& a, int B, void* stream) {
  const int w1 = kBandK * 2 + 2 * a.H_W + 3;
  Plan pl;
  const cudaError_t err = band_pick(B, w1, kPtr, force, &pl);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    switch (pl.g) {
      case 0: launch_geometry<17, kPtr, true>(pl, a, B, stream); break;
      case 1: launch_geometry<13, kPtr, true>(pl, a, B, stream); break;
      case 2: launch_geometry<9, kPtr, true>(pl, a, B, stream); break;
      case 3: launch_geometry<5, kPtr, true>(pl, a, B, stream); break;
      default: launch_geometry<17, kPtr, false>(pl, a, B, stream); break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K10 (ptr null) / K11.  p: f32[B, Mp, 5] (Mp a multiple of 128); q:
// f32[B, N, 5]; p_len, q_len: int32[B]; ext_q: f32[B, N], ext_cum: f32[B,
// N+1], cum_lv: f32[B, cum_lv_stride] with cum_lv_stride >=
// lm_profile_cum_scratch(Mp + N), capbuf: f32[B, N] (scratch); ptr:
// uint8[B, Mp, WB+1] zero-filled by the caller, or null; score: f32[B];
// cert: uint8[B]; bound: f32[B], each window's certificate gap bound, or
// null; w5: HOST float[25]; geometry: an index of kGeometries to force,
// or -1 for the launcher's pick.  N must exceed WB + 1 (the JAX
// eligibility rule).
extern "C" int lm_banded_fwd(const void* p, const void* q, const void* p_len,
                             const void* q_len, void* ext_q, void* ext_cum,
                             void* cum_lv, int64_t cum_lv_stride,
                             void* capbuf, void* ptr, void* score, void* cert,
                             void* bound, int B, int Mp, int N, int H_W,
                             float gap_open, float gap_extend,
                             const float* w5, int geometry, void* stream) {
  if (Mp % kBandK != 0 || kBandK * 2 + 2 * H_W + 3 >= N ||
      geometry >= kGeometryCount)
    return (int)cudaErrorInvalidValue;
  BandArgs a = {(const float*)p, (const float*)q, (const int*)p_len,
                (const int*)q_len, (float*)ext_q, (float*)ext_cum,
                (float*)cum_lv, cum_lv_stride, (float*)capbuf,
                (unsigned char*)ptr, (float*)score, (unsigned char*)cert,
                (float*)bound, Mp, N, H_W, gap_open, gap_extend, {}};
  for (int k = 0; k < 25; ++k) a.w5.w[k] = w5[k];
  return ptr != nullptr ? launch_banded<true>(geometry, a, B, stream)
                        : launch_banded<false>(geometry, a, B, stream);
}

// The geometry of a K10 (ptr 0) or K11 launch of B windows at half band
// H_W on the current card: geometry g, or the launcher's pick for g < 0.
// out: int[5] = {geometry, K, S (warps a window), qw in registers,
// windows an SM}; out[4] is 0 where g does not fit this band.  Returns
// -1 for g past the last geometry, else a cudaError_t.
extern "C" int lm_banded_geometry(int B, int H_W, int ptr, int g, int* out) {
  if (g >= kGeometryCount) return -1;
  const int w1 = kBandK * 2 + 2 * H_W + 3;
  Plan pl;
  int n_sm = 0;
  cudaError_t err = sm_count(&n_sm);
  if (err == cudaSuccess)
    err = g < 0 ? band_pick(B, w1, ptr != 0, -1, &pl)
                : band_plan(g, B, n_sm, w1, ptr != 0, &pl);
  if (err != cudaSuccess) return (int)err;
  out[0] = pl.g;
  out[1] = kGeometries[pl.g].K;
  out[2] = pl.S;
  out[3] = kGeometries[pl.g].qw_reg ? 1 : 0;
  out[4] = pl.per_sm;
  return 0;
}

// K12.  ptr: uint8[B, Mp, WB+1] (16-byte aligned); p_len, q_len:
// int32[B]; words: int32[B, C16] with 16 * C16 >= Mp + N; counts, steps:
// int32[B]; geometry: an index of lm_walk::kGeometries to force, or -1
// for the launcher's pick.  No buffer needs a fill.
extern "C" int lm_banded_walk(const void* ptr, const void* p_len,
                              const void* q_len, int B, int Mp, int N,
                              int H_W, int T, int C16, void* words,
                              void* counts, void* steps, int geometry,
                              void* stream) {
  const int64_t w1 = kBandK * 2 + 2 * H_W + 3;
  if (16 * (int64_t)C16 < (int64_t)Mp + N || Mp * w1 >= INT_MAX ||
      ((uintptr_t)ptr & 15) != 0)
    return (int)cudaErrorInvalidValue;
  lm_walk::Plan pl;
  const cudaError_t err =
      lm_walk::plan_launch(kWalkKernels, walk_cards, B, Mp, w1, geometry, &pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.warps <= 0) return (int)cudaErrorInvalidConfiguration;
  const auto kernel = kWalkKernels[pl.cols == 0 ? 1 : 0];
  if (B > 0) {
    const unsigned blocks = (unsigned)((B + pl.warps - 1) / pl.warps);
    LM_LAUNCH(kernel, blocks, 32 * pl.warps, (size_t)pl.smem,
              (cudaStream_t)stream, (const unsigned char*)ptr,
              (int64_t)B * Mp * w1, (const int*)p_len, (const int*)q_len, B,
              Mp, N, H_W, T, C16, pl, (uint32_t*)words, (int*)counts,
              (int*)steps);
  }
  return (int)cudaGetLastError();
}

// The geometry of a K12 launch of B windows of Mp rows at half band H_W
// on the current card: geometry g, or the launcher's pick for g < 0.
// out: int[6] as lm_walk::describe.  Returns -1 for g past the last
// geometry, else a cudaError_t.
extern "C" int lm_banded_walk_geometry(int B, int Mp, int H_W, int g,
                                       int* out) {
  if (g >= lm_walk::kGeometryCount) return -1;
  lm_walk::Plan pl;
  const cudaError_t err =
      lm_walk::plan_launch(kWalkKernels, walk_cards, B, Mp,
                           kBandK * 2 + 2 * H_W + 3, g, &pl);
  if (err != cudaSuccess) return (int)err;
  lm_walk::describe(pl, out);
  return 0;
}
