// K22: pairwise int32 Gotoh forward with (H, F) carries every K rows, as
// strips over several blocks, and K23: the pointer bytes of a block of
// rows from a carry, one thread block per pair.
//
// K22 replaces libmems_tpu/ops/gapped.py _gotoh_forward_ckpt (:151, a
// lax.scan over blocks of K = CKPT_ROWS rows of _gotoh_row_fn with
// emit_ptr=False, from _gotoh_h0f0).  K23 replaces _gotoh_block_ptrs
// (:178, the same rows with emit_ptr=True) and, when asked to pack,
// pack_ptrs (:188): two 4-bit cells a byte, cell 2k in the low nibble.
//
// The recurrence (ops/gapped.py:98-137, int32, exact: no order to fix):
//   F[c] = max(H'[c] + open + ext, F'[c] + ext)
//   g[c] = max(H'[c-1] + sub[a_i][b_{c-1}], F[c])   (column 0: g = F)
//   E[c] = ext * c + max_{k<c} w[k],  w[k] = (g[k] + open) - ext * k
//   H[c] = max(g[c], E[c])                           (column 0: H = g)
// Row i depends on row i-1, and within a row E is a prefix maximum over
// the columns, so both kernels are bound by the rows' chain of
// dependent steps, not by their bytes.
//
// K22 (gotoh_span_kernel): the design of K24 (csrc/profile.cu
// span_kernel, csrc/strip.cuh) on this recurrence.  Lane l of strip s
// holds the K consecutive columns from (32 s + l) K in registers: their
// H, F and b's symbols (2 bits a column); a warp is a strip of 32 K
// columns and a pair takes S = ceil((N+1) / (32 K)) strips.  A warp
// loads 32 rows of a at a time, a row a lane, and broadcasts row i's
// symbol by shuffle; the row's four substitution scores come from shared
// memory.  A row: F, g and each lane's running maximum of w over its
// columns, the diagonal's left neighbour by __shfl_up_sync (from the
// strip to the left at the strip's first column); a shuffle max-scan
// over the warp; the maximum carried in from the strip to the left; then
// E and H column by column.  Strips hand each row on as two row-tagged
// int32 words (H of their last column, the running maximum): through the
// shared ring inside a block of W strips and one receiver warp, through
// a global column that holds every row between blocks; a block takes
// (pair, segment) from an atomic ticket, so it waits only on blocks
// already running.  Each lane stores its own columns of the carries at
// the top of every K-th row, and the score where (a_len, b_len) falls.
// The host picks K and W by ops.profile.span_pick from the card's fits
// (lm_gotoh_fits), as for K24.  The hand-off columns hold every row of a
// launch, 16 bytes a row at each of a pair's C - 1 block edges, zeroed
// before the launch; where B (C - 1) 16 bytes a row for all Mp rows pass
// the host's cap (ops.gapped.gotoh_band_rows), the host launches the
// rows in bands, each band starting from the (H, F) row that the one
// before it wrote (h_in, h_out: 8 B (N+1) bytes each).  Every row and
// column of the padded [Mp, N+1] matrix is computed, so the carries
// equal the JAX arrays whole.  At 8 pairs of 16,384 x 16,385 cells the row chain is
// the floor: 16,384 rows of a few hundred cycles each.
//
// K23 (gotoh_ptrs_kernel): threads stripe the columns in tiles of
// blockDim; a tile reads its cells' (H, F) of the previous row, computes
// F, the diagonal and g, and runs a block-wide inclusive max scan of w,
// carrying the running maximum across tiles.  Each thread keeps its
// column's values in registers through the tile, so the row's (H, F)
// live in 8 * (N+1) bytes of shared memory (global scratch when that
// exceeds what a block may opt into): the one value a tile overwrites
// that the next tile still reads, the old H of its last column, passes
// through a two-slot shared register.  The pointer byte is the H source
// (0 diagonal, 1 E, 2 F; ties in that order), bit 4 E-extend (E[c] ==
// E[c-1] + ext, c >= 2), bit 8 F-extend (F == F_prev + ext and F_prev >
// NEG_INF / 2); column 0 is H_F | F-extend.  Every row and column of the
// padded matrix is computed, so the pointer bytes equal the JAX arrays
// whole.
#include "common.cuh"
#include "strip.cuh"

namespace {

using lm_strip::await_row_int;
using lm_strip::kFull;
using lm_strip::kRing;
using lm_strip::kSlot;
using lm_strip::kSpanGeometryCount;
using lm_strip::kSpanK;
using lm_strip::kSpanMaxW;
using lm_strip::row_word;
using lm_strip::span_strips;

constexpr int kNegInf = -(1 << 30);
constexpr int kNegHalf = -(1 << 29);  // NEG_INF // 2
constexpr unsigned char kHDiag = 0, kHE = 1, kHF = 2, kEExt = 4, kFExt = 8;

// ---------------------------------------------------------------------------
// K23.

struct GotohArgs {
  const unsigned char* a;  // [B, R] the symbols of the rows computed
  const unsigned char* b;  // [B, N]
  const int* h_in;         // [B, N+1] carry at the top of the rows, or
  const int* f_in;         //   null for the DP's first row (_gotoh_h0f0)
  unsigned char* ptr;      // [B, R, N+1], or [B, R, (N+2)/2] packed
  int* rows;               // [B, 2, N+1] global row scratch, or null
  int B, R, N, gap_open, gap_extend, packed;
  int sub[16];             // substitution scores, sub[x * 4 + y]
};

__global__ void gotoh_ptrs_kernel(GotohArgs g) {
  extern __shared__ int s_dyn[];
  __shared__ int s_tmp[lm::kScanTmp];
  __shared__ int s_sub[16];
  __shared__ int s_hold[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int N = g.N;
  const int n1 = N + 1;
  const int ext = g.gap_extend;
  const int oe = g.gap_open + g.gap_extend;
  int* H = g.rows != nullptr ? g.rows + (int64_t)b * 2 * n1 : s_dyn;
  int* F = H + n1;
  const unsigned char* arow = g.a + (int64_t)b * g.R;
  const unsigned char* brow = g.b + (int64_t)b * N;
  if (tid < 16) s_sub[tid] = g.sub[tid];

  // the carry at the top of the rows
  for (int c = tid; c < n1; c += nt) {
    if (g.h_in != nullptr) {
      H[c] = g.h_in[(int64_t)b * n1 + c];
      F[c] = g.f_in[(int64_t)b * n1 + c];
    } else {
      H[c] = c == 0 ? 0 : g.gap_open + ext * c;
      F[c] = kNegInf;
    }
  }
  __syncthreads();

  const int ntiles = (n1 + nt - 1) / nt;
  const int64_t width = g.packed ? (N + 2) / 2 : n1;
  for (int r = 0; r < g.R; ++r) {
    const int* srow = s_sub + min((int)arow[r], 3) * 4;
    unsigned char* prow = g.ptr + ((int64_t)b * g.R + r) * width;
    int carry = INT_MIN;      // max of w over the earlier tiles
    int prev_last = INT_MIN;  // prefix max before the previous tile's last
                              // column
    for (int t = 0; t < ntiles; ++t) {
      const int c = t * nt + tid;
      const bool valid = c < n1;
      int hp = 0, fp = kNegInf, hl = 0;
      if (valid) {
        hp = H[c];
        fp = F[c];
        if (c > 0) hl = tid > 0 ? H[c - 1] : s_hold[(t - 1) & 1];
      }
      if (tid == nt - 1) s_hold[t & 1] = hp;
      int f = kNegInf, gv = 0, diag = 0, w = INT_MIN;
      bool fext = false;
      if (valid) {
        const int fe = fp + ext;
        f = max(hp + oe, fe);
        fext = f == fe && fp > kNegHalf;
        if (c == 0) {
          gv = f;
        } else {
          diag = hl + srow[min((int)brow[c - 1], 3)];
          gv = max(diag, f);
        }
        if (c < N) w = (gv + g.gap_open) - ext * c;
      }
      const lm::ScanResult<int> sc =
          lm::block_scan(w, INT_MIN, lm::MaxOp(), s_tmp);
      const int ex = max(carry, sc.excl);
      const int ex_prev = tid > 0 ? max(carry, sc.prev_excl) : prev_last;
      prev_last = max(carry, sc.last_excl);
      carry = max(carry, sc.total);

      int h = f;
      unsigned char p = kHF | (fext ? kFExt : 0);
      if (valid && c > 0) {
        const int e = ext * c + ex;
        h = max(gv, e);
        p = h == diag ? kHDiag : (h == e ? kHE : kHF);
        if (c >= 2 && e == (ext * (c - 1) + ex_prev) + ext) p |= kEExt;
        if (fext) p |= kFExt;
      }
      if (valid) {
        H[c] = h;
        F[c] = f;
      }
      if (!valid) p = 0;  // the zero pad cell of an odd width
      if (g.packed) {
        const unsigned hi = __shfl_down_sync(kFull, (unsigned)p, 1);
        if (valid && !(c & 1)) prow[c >> 1] = (unsigned char)(p | (hi << 4));
      } else if (valid) {
        prow[c] = p;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K22 (see the top of the file).

// A geometry is an index g of lm_strip::kSpanK (kSpanK[g] columns a lane,
// as K24/K25 take, so the host prices the kernels alike) and W, the
// strips a block.  Words a hand-off: H of the strip's last column, the running max of w
constexpr int kWords = 2;

struct GotohSpanArgs {
  const unsigned char* a;  // [B, M]
  const unsigned char* b;  // [B, N]
  const int* a_len;        // [B]
  const int* b_len;        // [B]
  int* score;              // [B] H at (a_len, b_len)
  int* ck_h;               // [M / KR, B, N+1] carries, or null
  int* ck_f;
  const int* h_in;         // [B, N+1] (H, F) of row r0, or null for row 0
  const int* f_in;         //   (_gotoh_h0f0)
  int* h_out;              // [B, N+1] (H, F) of row r0 + R, or null
  int* f_out;
  unsigned long long* edges;   // [B, C-1, R, kWords], zeroed
  unsigned* ticket;            // zeroed
  int B, M, N;
  int r0, R;               // the launch's rows: r0 + 1 .. r0 + R
  int KR;                  // rows between carries
  int S, W, C;             // strips a pair, strips a block, blocks a pair
  int gap_open, gap_extend;
  int sub[16];             // substitution scores, sub[x * 4 + y]
};

// Dynamic shared memory of a block of W strips: W + 1 ring sets (set 0
// the receiver's) and a used count a strip.
inline int64_t gotoh_smem_bytes(int W) {
  return (int64_t)8 * kSlot * kRing * (W + 1) + 8 * ((W + 2) / 2);
}

// One pair is C blocks of up to W strips; warp 0 of a block is its
// receiver, warps 1..W its strips.  No block barrier after the setup.
template <int K>
__global__ void gotoh_span_kernel(GotohSpanArgs a) {
  extern __shared__ unsigned long long lm_gotoh_smem[];
  __shared__ int s_sub[16];
  const int W = a.W;
  volatile unsigned long long* ring = lm_gotoh_smem;
  volatile int* used =   // rows strip w has read from set w-1
      reinterpret_cast<volatile int*>(lm_gotoh_smem + kSlot * kRing * (W + 1));
  for (int k = threadIdx.x; k < kSlot * kRing * (W + 1); k += blockDim.x)
    ring[k] = 0;
  if ((int)threadIdx.x <= W) used[threadIdx.x] = 0;
  if (threadIdx.x < 16) s_sub[threadIdx.x] = a.sub[threadIdx.x];
  const int t = lm_strip::take_ticket(a.ticket);   // a barrier
  const int b = t / a.C;
  const int seg = t - b * a.C;
  const int R = a.R;
  const int nw = min(W, a.S - seg * W);   // strips of this block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned long long* edges = a.edges + (int64_t)b * (a.C - 1) * R * kWords;
  if (warp == 0) {
    if (seg > 0) {
      lm_strip::receive_rows<kWords>(
          edges + (int64_t)(seg - 1) * R * kWords, ring, used, R, lane);
    }
    return;
  }
  if (warp > nw) return;

  const int N = a.N, n1 = N + 1;
  const int s = seg * W + warp - 1;       // the pair's strip
  const int c0 = s * 32 * K;              // the strip's first column
  const int cb = c0 + lane * K;           // this lane's first column
  const bool col0 = s == 0 && lane == 0;
  const bool feeds = s + 1 < a.S;
  const int open = a.gap_open, ext = a.gap_extend, oe = open + ext;
  const unsigned char* ab = a.a + (int64_t)b * a.M + a.r0;
  const unsigned char* bb = a.b + (int64_t)b * N;
  const int al = a.a_len[b] - a.r0;   // the score's row, counted from r0
  const int bl = a.b_len[b];
  const int64_t rb = (int64_t)b * n1;
  const bool top = a.h_in == nullptr;

  // row r0 (row 0: _gotoh_h0f0) and b's symbols of the held columns
  // (column c scores b[c-1]); padding columns past N start at NEG_INF
  int H[K], F[K];
  unsigned long long codes = 0;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const int c = cb + m;
    H[m] = kNegInf;
    F[m] = kNegInf;
    if (c <= N) {
      H[m] = top ? (c == 0 ? 0 : open + ext * c) : a.h_in[rb + c];
      if (!top) F[m] = a.f_in[rb + c];
    }
    if (c >= 1 && c <= N) {
      codes |= (unsigned long long)min((int)bb[c - 1], 3) << (2 * m);
    }
  }
  // H[i-1][c0-1], the first column's diagonal (strips after the first)
  int h_left = kNegInf;
  if (s > 0) h_left = top ? open + ext * (c0 - 1) : a.h_in[rb + c0 - 1];
  if (top && al == 0) {   // the score of a pair of no rows: row 0's
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (cb + m == bl) a.score[b] = H[m];
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

  // a's symbols, 32 rows at a time, a row a lane
  int A = 0;
  int AN = lane < R ? min((int)ab[lane], 3) : 0;
  // the next carry, at the top of row ck * KR + 1 (rows counted from 1)
  int ck = (a.r0 + a.KR - 1) / a.KR;
  for (int i = 1; i <= R; ++i) {
    if (a.ck_h != nullptr && a.r0 + i - 1 == ck * a.KR) {
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
      A = AN;
      const int next = i + 31 + lane;   // 0-based row of the next batch
      AN = next < R ? min((int)ab[next], 3) : 0;
    }
    const int* srow = s_sub + 4 * __shfl_sync(kFull, A, r);
    const int s0 = srow[0], s1 = srow[1], s2 = srow[2], s3 = srow[3];

    // 1. F and g; the running max of w over the lane's columns
    int hl = __shfl_up_sync(kFull, H[K - 1], 1);
    if (lane == 0) hl = h_left;
    int run = INT_MIN;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int hp = H[m];
      const int f = max(hp + oe, F[m] + ext);
      F[m] = f;
      int g = f;
      if (m > 0 || !col0) {
        const unsigned x = (unsigned)(codes >> (2 * m)) & 3u;
        const int sc = (x & 2u) ? ((x & 1u) ? s3 : s2) : ((x & 1u) ? s1 : s0);
        g = max(hl + sc, f);
      }
      hl = hp;   // column m's H[i-1] is column m+1's diagonal
      H[m] = g;
      run = max(run, (g + open) - ext * (cb + m));
    }

    // 2. the exclusive max-scan over the lanes, then the strip's carry
    int x = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x = max(n, x);
    }
    int pre = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) pre = INT_MIN;   // lane 0 of strip 0 starts at column 0
    if (s > 0) {
      const volatile unsigned long long* sl = in_ring + (i % kRing) * kSlot;
      h_left = await_row_int(sl, i);   // H[i][c0-1], next row's diagonal
      pre = max(pre, await_row_int(sl + 1, i));
      __syncwarp();
      if (lane == 0) used[warp] = i;
    }

    // 3. E and H = max(g, E)
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int c = cb + m;
      const int g = H[m];
      const int wv = (g + open) - ext * c;
      if (m == 0 && col0) {   // column 0: H = g
        pre = max(pre, wv);
        continue;
      }
      const int e = ext * c + pre;
      pre = max(pre, wv);
      H[m] = max(g, e);
    }

    // hand the row to the next strip
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
        }
      } else if (lane == 31) {
        volatile unsigned long long* d = out_edge + (int64_t)(i - 1) * kWords;
        d[0] = row_word(H[K - 1], i);
        d[1] = row_word(pre, i);
      }
    }
    if (i == al) {   // H at (a_len, b_len)
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (cb + m == bl) a.score[b] = H[m];
      }
    }
  }
  if (a.h_out != nullptr) {   // row r0 + R, where the next launch starts
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (cb + m <= N) {
        a.h_out[rb + cb + m] = H[m];
        a.f_out[rb + cb + m] = F[m];
      }
    }
  }
}

const void* gotoh_span_kernel_of(int g) {
  switch (g) {
    case 0: return (const void*)gotoh_span_kernel<17>;
    case 1: return (const void*)gotoh_span_kernel<16>;
    case 2: return (const void*)gotoh_span_kernel<13>;
    case 3: return (const void*)gotoh_span_kernel<9>;
    case 4: return (const void*)gotoh_span_kernel<8>;
    case 5: return (const void*)gotoh_span_kernel<5>;
    case 6: return (const void*)gotoh_span_kernel<3>;
    default: return (const void*)gotoh_span_kernel<1>;
  }
}

// Scratch of a K22 launch of R rows: the hand-off columns [B, C-1, R,
// kWords] and the ticket, all zeroed by the launcher.
inline int64_t gotoh_scratch_bytes(int B, int R, int C) {
  return 8LL * B * (C - 1) * R * kWords + 16;
}

template <int K>
void launch_gotoh_k(unsigned grid, int threads, int64_t smem, void* stream,
                    const GotohSpanArgs& a) {
  LM_LAUNCH(gotoh_span_kernel<K>, grid, threads, (size_t)smem,
            (cudaStream_t)stream, a);
}

}  // namespace

// Bytes of shared memory one pair's (H, F) rows take at N columns (K23).
extern "C" int64_t lm_gotoh_row_bytes(int N) { return (int64_t)8 * (N + 1); }

// Bytes of dynamic shared memory K23 may opt into on the current device
// (-1 when the runtime cannot say): wider rows need global scratch.
extern "C" int64_t lm_gotoh_smem_limit() {
  return lm::max_dyn_smem(gotoh_ptrs_kernel);
}

// Bytes of scratch a K22 launch of B pairs of R rows in an N-column
// bucket takes in geometry (g, W): the hand-off columns and the ticket;
// -1 for a geometry past the table.
extern "C" int64_t lm_gotoh_scratch_bytes(int B, int R, int N, int g,
                                          int W) {
  if (g < 0 || g >= kSpanGeometryCount || W < 1 || W > kSpanMaxW) return -1;
  const int S = span_strips(N, kSpanK[g]);
  return gotoh_scratch_bytes(B, R, (S + W - 1) / W);
}

// K22's fits on the current card, for the host's pick
// (lm_strip::span_fits).
extern "C" int lm_gotoh_fits(int* out) {
  return lm_strip::span_fits(
      out, [](int g) { return gotoh_span_kernel_of(g); },
      [](int, int W) { return gotoh_smem_bytes(W); });
}

// K22 over rows r0 + 1 .. r0 + R of the padded DP (R >= 1 unless M is
// 0).  a: uint8[B, M] (M a multiple of K); b: uint8[B, N]; a_len, b_len: int32[B]; sub: HOST
// int[16]; score: int32[B], written where a_len falls in the rows (a_len
// 0 by the launch with r0 = 0); ck_h, ck_f: int32[M / K, B, N+1] or both
// null (score only), the carries that fall in the rows; h_in, f_in:
// int32[B, N+1] the (H, F) of row r0, or null when r0 = 0; h_out, f_out:
// int32[B, N+1] where row r0 + R's go, or null; scratch:
// lm_gotoh_scratch_bytes(B, R, N, g, W) bytes, 16-byte aligned; (g, W):
// the geometry.  Every row and column is computed.
extern "C" int lm_gotoh_fwd(const void* a, const void* b, const void* a_len,
                            const void* b_len, int B, int M, int N, int K,
                            int r0, int R, int gap_open, int gap_extend,
                            const int* sub, void* score, void* ck_h,
                            void* ck_f, const void* h_in, const void* f_in,
                            void* h_out, void* f_out, void* scratch, int g,
                            int W, void* stream) {
  if (K < 1 || M % K != 0 || r0 < 0 || R < (M > 0) || r0 + R > M ||
      (r0 > 0) != (h_in != nullptr) || g < 0 || g >= kSpanGeometryCount ||
      W < 1 || W > kSpanMaxW || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  GotohSpanArgs s = {};
  s.a = (const unsigned char*)a;
  s.b = (const unsigned char*)b;
  s.a_len = (const int*)a_len;
  s.b_len = (const int*)b_len;
  s.score = (int*)score;
  s.ck_h = (int*)ck_h;
  s.ck_f = (int*)ck_f;
  s.h_in = (const int*)h_in;
  s.f_in = (const int*)f_in;
  s.h_out = (int*)h_out;
  s.f_out = (int*)f_out;
  s.B = B;
  s.M = M;
  s.N = N;
  s.r0 = r0;
  s.R = R;
  s.KR = K;
  s.S = span_strips(N, kSpanK[g]);
  s.W = W;
  s.C = (s.S + W - 1) / W;
  s.gap_open = gap_open;
  s.gap_extend = gap_extend;
  for (int k = 0; k < 16; ++k) s.sub[k] = sub[k];
  const int64_t total = gotoh_scratch_bytes(B, R, s.C);
  s.edges = (unsigned long long*)scratch;
  s.ticket = (unsigned*)((char*)scratch + total - 16);
  if (B == 0) return (int)cudaGetLastError();
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, (size_t)total, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((int64_t)B * s.C);
  const int threads = 32 * (W + 1);
  const int64_t smem = gotoh_smem_bytes(W);
  switch (g) {
    case 0: launch_gotoh_k<17>(grid, threads, smem, stream, s); break;
    case 1: launch_gotoh_k<16>(grid, threads, smem, stream, s); break;
    case 2: launch_gotoh_k<13>(grid, threads, smem, stream, s); break;
    case 3: launch_gotoh_k<9>(grid, threads, smem, stream, s); break;
    case 4: launch_gotoh_k<8>(grid, threads, smem, stream, s); break;
    case 5: launch_gotoh_k<5>(grid, threads, smem, stream, s); break;
    case 6: launch_gotoh_k<3>(grid, threads, smem, stream, s); break;
    default: launch_gotoh_k<1>(grid, threads, smem, stream, s); break;
  }
  return (int)cudaGetLastError();
}

// K23.  a: uint8[B, R] the block's symbols; h_in, f_in: int32[B, N+1] the
// carry at the block's top, or both null for the DP's first row; b:
// uint8[B, N]; ptr: uint8[B, R, N+1], or uint8[B, R, (N+2)/2] when
// packed; rows: int32[B, 2, N+1] or null to keep the rows in shared
// memory.
extern "C" int lm_gotoh_ptrs(const void* a, const void* h_in,
                             const void* f_in, const void* b, int B, int R,
                             int N, int gap_open, int gap_extend,
                             const int* sub, int packed, void* ptr,
                             void* rows, void* stream) {
  GotohArgs g = {};
  g.a = (const unsigned char*)a;
  g.b = (const unsigned char*)b;
  g.h_in = (const int*)h_in;
  g.f_in = (const int*)f_in;
  g.ptr = (unsigned char*)ptr;
  g.rows = (int*)rows;
  g.B = B;
  g.R = R;
  g.N = N;
  g.gap_open = gap_open;
  g.gap_extend = gap_extend;
  g.packed = packed;
  for (int k = 0; k < 16; ++k) g.sub[k] = sub[k];
  int threads = ((N + 1 + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  const int64_t smem = rows != nullptr ? 0 : (int64_t)8 * (N + 1);
  const cudaError_t err = lm::allow_dyn_smem(gotoh_ptrs_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    LM_LAUNCH(gotoh_ptrs_kernel, (unsigned)B, threads, (size_t)smem,
              (cudaStream_t)stream, g);
  }
  return (int)cudaGetLastError();
}
