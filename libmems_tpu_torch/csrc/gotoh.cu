// K22: pairwise int32 Gotoh forward with (H, F) carries every K rows, and
// K23: the pointer bytes of row blocks re-derived from their carries; one
// kernel, strips over several blocks, with and without the pointers.
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
// gotoh_span_kernel<K, kPtr>: the design of K24/K25 (csrc/profile.cu
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
// E and H column by column.  Strips hand each row on as row-tagged int32
// words (H of their last column, the running maximum, and for K23 the
// last column's E + ext): through the shared ring inside a block of W
// strips and one receiver warp, through a global column that holds every
// row between blocks; a block takes (instance, segment) from an atomic
// ticket, so it waits only on blocks already running.  The host picks K
// and W by ops.profile.span_pick from the card's fits (lm_gotoh_fits), as
// for K24 (K22) and K25 (K23).
//
// An instance is a pair's run of R rows from an (H, F) row: K22's pair
// (rows r0 + 1 .. r0 + R of the forward, storing the carry at the top of
// every K-th row and the score where (a_len, b_len) falls), or one of
// K23's G x B row blocks side by side (block k of pair b starts from its
// carry, the launch's first block from _gotoh_h0f0's row, made in the
// kernel, when it is the DP's first).  K23's lane writes its columns'
// pointer bytes every row: the H source (0 diagonal, 1 E, 2 F; ties in
// that order), bit 4 E-extend (E[c] == E[c-1] + ext, c >= 2; E[c-1] + ext
// from the lane to the left by shuffle, from the strip to the left in
// the third hand-off word), bit 8 F-extend (F == F_prev + ext and F_prev
// > NEG_INF / 2); column 0 is H_F | F-extend.  Packed, two cells a byte:
// at an odd K the odd lanes' first cell is the high nibble of the left
// lane's last byte, taken by shuffle; the lane of an odd width's last
// column writes the last byte with a zero high nibble.  The stores are
// single bytes, K / 2 apart across the lanes: a row's bytes are a few
// sectors a warp, and the rows' chain, not the stores, sets the time.
//
// The hand-off columns hold every row of a launch, words x 8 bytes a row
// at each of an instance's C - 1 block edges, zeroed before the launch;
// where they would pass the host's cap (ops.gapped.gotoh_band_rows), the
// host launches the rows in bands, each band starting from the (H, F)
// rows that the one before it wrote (h_out, f_out: one row an instance).
// Every row and column of the padded matrix is computed, so the carries
// and pointer bytes equal the JAX arrays whole.  At 8 pairs of 16,384 x
// 16,385 cells the row chain is the floor: 16,384 rows of a few hundred
// cycles each; K23's blocks of 128 rows run G x 8 side by side.
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
constexpr unsigned kHDiag = 0, kHE = 1, kHF = 2, kEExt = 4, kFExt = 8;

// A geometry is an index g of lm_strip::kSpanK (kSpanK[g] columns a lane,
// as K24/K25 take, so the host prices the kernels alike) and W, the
// strips a block.
struct GotohSpanArgs {
  const unsigned char* a;  // [B, M]
  const unsigned char* b;  // [B, N]
  const int* a_len;        // K22: [B]
  const int* b_len;        // K22: [B]
  int* score;              // K22: [B] H at (a_len, b_len)
  int* ck_h;               // K22: [M / KR, B, N+1] carries, or null
  int* ck_f;
  const int* h_in;         // [G, B, N+1] (H, F) at the instances' tops,
  const int* f_in;         //   or null (from_top with G = 1)
  int* h_out;              // [G, B, N+1] (H, F) after the instances'
  int* f_out;              //   rows, or null
  unsigned char* ptr;      // K23: instance (k, b)'s rows from
                           //   ptr + (k B + b) out_rows width
  unsigned long long* edges;   // [G*B, C-1, R, words], zeroed
  unsigned* ticket;            // zeroed
  int B, M, N, G;
  int r0, RS, R;           // instance k: rows r0 + k RS + 1 .. + R
  int from_top;            // block 0 starts at _gotoh_h0f0's row
  int KR;                  // K22: rows between carries
  int S, W, C;             // strips a pair, strips a block, blocks
  int packed;              // K23: two cells a byte
  int64_t out_rows;        // K23: rows an instance's output holds
  int gap_open, gap_extend;
  int sub[16];             // substitution scores, sub[x * 4 + y]
};

// Words a hand-off: H of the strip's last column, the running max of w,
// and for K23 the last column's E + ext.
__host__ __device__ constexpr int words_of(bool ptr) { return ptr ? 3 : 2; }

// Dynamic shared memory of a block of W strips: W + 1 ring sets (set 0
// the receiver's) and a used count a strip.
inline int64_t gotoh_smem_bytes(int W) {
  return (int64_t)8 * kSlot * kRing * (W + 1) + 8 * ((W + 2) / 2);
}

// One instance is C blocks of up to W strips; warp 0 of a block is its
// receiver, warps 1..W its strips.  No block barrier after the setup.
template <int K, bool kPtr>
__global__ void gotoh_span_kernel(GotohSpanArgs a) {
  constexpr int kWords = words_of(kPtr);
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
  const int inst = t / a.C;
  const int seg = t - inst * a.C;
  const int kb = inst / a.B;       // the launch's row block (K22: 0)
  const int b = inst - kb * a.B;
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
  const int s = seg * W + warp - 1;       // the pair's strip
  const int c0 = s * 32 * K;              // the strip's first column
  const int cb = c0 + lane * K;           // this lane's first column
  const bool col0 = s == 0 && lane == 0;
  const bool feeds = s + 1 < a.S;
  const int open = a.gap_open, ext = a.gap_extend, oe = open + ext;
  const int rs = a.r0 + kb * a.RS;        // rows above the instance's first
  const unsigned char* ab = a.a + (int64_t)b * a.M + rs;
  const unsigned char* bb = a.b + (int64_t)b * N;
  const int al = kPtr ? -1 : a.a_len[b] - rs;   // the score's row, from rs
  const int bl = kPtr ? -1 : a.b_len[b];
  const bool top = kb == 0 && a.from_top;
  const int64_t rb = (int64_t)inst * n1;
  const int* h_in = top ? nullptr : a.h_in + rb;
  const int* f_in = top ? nullptr : a.f_in + rb;

  // the instance's first row (row 0: _gotoh_h0f0) and b's symbols of the
  // held columns (column c scores b[c-1]); padding columns past N start
  // at NEG_INF
  int H[K], F[K];
  unsigned long long codes = 0;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const int c = cb + m;
    H[m] = kNegInf;
    F[m] = kNegInf;
    if (c <= N) {
      H[m] = top ? (c == 0 ? 0 : open + ext * c) : h_in[c];
      if (!top) F[m] = f_in[c];
    }
    if (c >= 1 && c <= N) {
      codes |= (unsigned long long)min((int)bb[c - 1], 3) << (2 * m);
    }
  }
  // H[i-1][c0-1], the first column's diagonal (strips after the first)
  int h_left = kNegInf;
  if (s > 0) h_left = top ? open + ext * (c0 - 1) : h_in[c0 - 1];
  if (!kPtr && top && al == 0) {   // the score of a pair of no rows
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
  // K23: the instance's pointer rows
  const int64_t width = a.packed ? (N + 2) / 2 : n1;
  unsigned char* prows =
      kPtr ? a.ptr + (int64_t)inst * a.out_rows * width : nullptr;

  // a's symbols, 32 rows at a time, a row a lane
  int A = 0;
  int AN = lane < R ? min((int)ab[lane], 3) : 0;
  // K22: the next carry, at the top of row ck * KR + 1 (rows counted
  // from 1)
  int ck = kPtr ? 0 : (rs + a.KR - 1) / a.KR;
  for (int i = 1; i <= R; ++i) {
    if (!kPtr && a.ck_h != nullptr && rs + i - 1 == ck * a.KR) {
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

    // 1. F and g; the running max of w over the lane's columns; K23's
    // masks of the columns whose g is the diagonal and whose F extends
    int hl = __shfl_up_sync(kFull, H[K - 1], 1);
    if (lane == 0) hl = h_left;
    int run = INT_MIN;
    unsigned dmask = 0, fmask = 0;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int hp = H[m];
      const int fe = F[m] + ext;
      const int f = max(hp + oe, fe);
      if (kPtr && f == fe && F[m] > kNegHalf) fmask |= 1u << m;
      F[m] = f;
      int g = f;
      if (m > 0 || !col0) {
        const unsigned x = (unsigned)(codes >> (2 * m)) & 3u;
        const int sc = (x & 2u) ? ((x & 1u) ? s3 : s2) : ((x & 1u) ? s1 : s0);
        const int diag = hl + sc;
        g = max(diag, f);
        if (kPtr && g == diag) dmask |= 1u << m;
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
    int eeq_in = 0;                 // K23: E + ext of column c0 - 1
    if (s > 0) {
      const volatile unsigned long long* sl = in_ring + (i % kRing) * kSlot;
      h_left = await_row_int(sl, i);   // H[i][c0-1], next row's diagonal
      pre = max(pre, await_row_int(sl + 1, i));
      if (kPtr) eeq_in = await_row_int(sl + 2, i);
      __syncwarp();
      if (lane == 0) used[warp] = i;
    }

    // 3. E and H = max(g, E); K23's cell m at bits 4m of nib, from m = 16
    // on at bits 4 (m - 16) of nib_hi
    int eeq = 0, e0 = 0;   // the previous column's E + ext; column cb's E
    unsigned long long nib = 0;
    unsigned nib_hi = 0;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int c = cb + m;
      const int g = H[m];
      const int wv = (g + open) - ext * c;
      if (m == 0 && col0) {   // column 0: H = g, the pointer F
        pre = max(pre, wv);
        if (kPtr) nib = kHF | ((fmask & 1u) ? kFExt : 0);
        continue;
      }
      const int e = ext * c + pre;
      pre = max(pre, wv);
      const int h = max(g, e);
      H[m] = h;
      if (kPtr) {
        unsigned out = (((dmask >> m) & 1u) && h == g) ? kHDiag
                                                       : (h == e ? kHE : kHF);
        if ((fmask >> m) & 1u) out |= kFExt;
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
        eeq = e + ext;
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
    if (!kPtr && i == al) {   // H at (a_len, b_len)
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (cb + m == bl) a.score[b] = H[m];
      }
    }

    if (kPtr) {
      // column cb's E-extend bit: E[cb] == E[cb-1] + ext
      int eeq_left = __shfl_up_sync(kFull, eeq, 1);
      if (lane == 0) eeq_left = eeq_in;
      if (!col0 && cb >= 2 && cb <= N && e0 == eeq_left) nib |= kEExt;
      auto cell = [&](int j) -> unsigned {   // nibble j of the lane
        return j < 16 ? (unsigned)(nib >> (4 * j)) & 0xF
                      : (nib_hi >> (4 * (j - 16))) & 0xF;
      };
      unsigned char* prow = prows + (int64_t)(i - 1) * width;
      if (a.packed) {
        // cell 2k in the low nibble of byte k.  c0 is even; at an odd K a
        // lane's first column is odd on odd lanes: that cell is the high
        // nibble of the left lane's last byte, taken by shuffle
        const unsigned right =
            __shfl_down_sync(kFull, (unsigned)(nib & 0xF), 1);
        const bool odd = cb & 1;
        const int c_first = cb + (odd ? 1 : 0);   // an even column
#pragma unroll
        for (int k = 0; k < (K + 1) / 2; ++k) {
          const int c = c_first + 2 * k;
          // at an odd K odd lanes hold (K - 1) / 2 whole bytes, even
          // lanes (K + 1) / 2; at an even K every lane K / 2
          if ((!odd || k < (K - 1) / 2) && c <= N) {
            const int j = c - cb;   // the byte's low cell
            const unsigned hi = j + 1 == K ? right : cell(j + 1);
            prow[c >> 1] = (unsigned char)(cell(j) | (hi << 4));
          }
        }
      } else {
#pragma unroll
        for (int m = 0; m < K; ++m) {
          if (cb + m <= N) prow[cb + m] = (unsigned char)cell(m);
        }
      }
    }
  }
  if (a.h_out != nullptr) {   // the row the next band starts from
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (cb + m <= N) {
        a.h_out[rb + cb + m] = H[m];
        a.f_out[rb + cb + m] = F[m];
      }
    }
  }
}

template <bool kPtr>
const void* gotoh_span_kernel_of(int g) {
  switch (g) {
    case 0: return (const void*)gotoh_span_kernel<17, kPtr>;
    case 1: return (const void*)gotoh_span_kernel<16, kPtr>;
    case 2: return (const void*)gotoh_span_kernel<13, kPtr>;
    case 3: return (const void*)gotoh_span_kernel<9, kPtr>;
    case 4: return (const void*)gotoh_span_kernel<8, kPtr>;
    case 5: return (const void*)gotoh_span_kernel<5, kPtr>;
    case 6: return (const void*)gotoh_span_kernel<3, kPtr>;
    default: return (const void*)gotoh_span_kernel<1, kPtr>;
  }
}

// Scratch of a launch of n_inst instances of R rows: the hand-off columns
// [n_inst, C-1, R, words] and the ticket, all zeroed by the launcher.
inline int64_t gotoh_scratch_bytes(int64_t n_inst, int R, int C, bool ptr) {
  return 8LL * n_inst * (C - 1) * R * words_of(ptr) + 16;
}

template <int K, bool kPtr>
void launch_gotoh_k(unsigned grid, int threads, int64_t smem, void* stream,
                    const GotohSpanArgs& a) {
  const auto kernel = gotoh_span_kernel<K, kPtr>;
  LM_LAUNCH(kernel, grid, threads, (size_t)smem, (cudaStream_t)stream, a);
}

// The launch of geometry (g, W): zero the hand-off columns and the
// ticket, then the strips over G * B instances.
template <bool kPtr>
int launch_gotoh(GotohSpanArgs s, int g, int W, void* scratch,
                 void* stream) {
  s.S = span_strips(s.N, kSpanK[g]);
  s.W = W;
  s.C = (s.S + W - 1) / W;
  const int64_t n_inst = (int64_t)s.G * s.B;
  const int64_t total = gotoh_scratch_bytes(n_inst, s.R, s.C, kPtr);
  s.edges = (unsigned long long*)scratch;
  s.ticket = (unsigned*)((char*)scratch + total - 16);
  if (n_inst == 0) return (int)cudaGetLastError();
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, (size_t)total, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(n_inst * s.C);
  const int threads = 32 * (W + 1);
  const int64_t smem = gotoh_smem_bytes(W);
  switch (g) {
    case 0: launch_gotoh_k<17, kPtr>(grid, threads, smem, stream, s); break;
    case 1: launch_gotoh_k<16, kPtr>(grid, threads, smem, stream, s); break;
    case 2: launch_gotoh_k<13, kPtr>(grid, threads, smem, stream, s); break;
    case 3: launch_gotoh_k<9, kPtr>(grid, threads, smem, stream, s); break;
    case 4: launch_gotoh_k<8, kPtr>(grid, threads, smem, stream, s); break;
    case 5: launch_gotoh_k<5, kPtr>(grid, threads, smem, stream, s); break;
    case 6: launch_gotoh_k<3, kPtr>(grid, threads, smem, stream, s); break;
    default: launch_gotoh_k<1, kPtr>(grid, threads, smem, stream, s); break;
  }
  return (int)cudaGetLastError();
}

bool bad_geometry(int g, int W) {
  return g < 0 || g >= kSpanGeometryCount || W < 1 || W > kSpanMaxW;
}

}  // namespace

// Bytes of scratch a launch of n_inst instances (K22: B pairs; K23: G x
// B row blocks) of R rows in an N-column bucket takes in geometry (g, W)
// of K22 (ptr 0) or K23: the hand-off columns and the ticket; -1 for a
// geometry past the table.
extern "C" int64_t lm_gotoh_scratch_bytes(int n_inst, int R, int N, int g,
                                          int W, int ptr) {
  if (bad_geometry(g, W)) return -1;
  const int S = span_strips(N, kSpanK[g]);
  return gotoh_scratch_bytes(n_inst, R, (S + W - 1) / W, ptr != 0);
}

// The fits of K22 (ptr 0) or K23 on the current card, for the host's
// pick (lm_strip::span_fits).
extern "C" int lm_gotoh_fits(int ptr, int* out) {
  return lm_strip::span_fits(
      out,
      [ptr](int g) {
        return ptr ? gotoh_span_kernel_of<true>(g)
                   : gotoh_span_kernel_of<false>(g);
      },
      [](int, int W) { return gotoh_smem_bytes(W); });
}

// K22 over rows r0 + 1 .. r0 + R of the padded DP (R >= 1 unless M is
// 0).  a: uint8[B, M] (M a multiple of K); b: uint8[B, N]; a_len, b_len:
// int32[B]; sub: HOST int[16]; score: int32[B], written where a_len falls
// in the rows (a_len 0 by the launch with r0 = 0); ck_h, ck_f: int32[M /
// K, B, N+1] or both null (score only), the carries that fall in the
// rows; h_in, f_in: int32[B, N+1] the (H, F) of row r0, or null when r0 =
// 0; h_out, f_out: int32[B, N+1] where row r0 + R's go, or null; scratch:
// lm_gotoh_scratch_bytes(B, R, N, g, W, 0) bytes, 16-byte aligned; (g,
// W): the geometry.  Every row and column is computed.
extern "C" int lm_gotoh_fwd(const void* a, const void* b, const void* a_len,
                            const void* b_len, int B, int M, int N, int K,
                            int r0, int R, int gap_open, int gap_extend,
                            const int* sub, void* score, void* ck_h,
                            void* ck_f, const void* h_in, const void* f_in,
                            void* h_out, void* f_out, void* scratch, int g,
                            int W, void* stream) {
  if (K < 1 || M % K != 0 || r0 < 0 || R < (M > 0) || r0 + R > M ||
      (r0 > 0) != (h_in != nullptr) || bad_geometry(g, W) ||
      scratch == nullptr)
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
  s.G = 1;
  s.r0 = r0;
  s.RS = R;
  s.R = R;
  s.from_top = r0 == 0;
  s.KR = K;
  s.gap_open = gap_open;
  s.gap_extend = gap_extend;
  for (int k = 0; k < 16; ++k) s.sub[k] = sub[k];
  return launch_gotoh<false>(s, g, W, scratch, stream);
}

// K23 over G row blocks of B pairs side by side: block k of pair b is
// rows r0 + k RS + 1 .. r0 + k RS + R of the padded DP (R <= RS), from
// the (H, F) row h_in[k, b], f_in[k, b] (int32[G, B, N+1]) or, for block
// 0 when from_top, from the DP's first row (h_in, f_in may then be null
// when G = 1).  a: uint8[B, M]; b: uint8[B, N]; sub: HOST int[16]; ptr:
// block (k, b)'s R rows at ptr + (k B + b) out_rows width bytes (width
// N+1, or (N+2)/2 when packed: two cells a byte, a zero pad cell at an
// odd N+1); h_out, f_out: int32[G, B, N+1] where each block's last row
// goes, or null; scratch: lm_gotoh_scratch_bytes(G * B, R, N, g, W, 1)
// bytes, 16-byte aligned; (g, W): the geometry.  Every row and column is
// computed and written.
extern "C" int lm_gotoh_block_ptrs(
    const void* a, const void* b, int B, int M, int N, int r0, int RS, int R,
    int G, int from_top, const void* h_in, const void* f_in, void* h_out,
    void* f_out, int gap_open, int gap_extend, const int* sub, int packed,
    void* ptr, int64_t out_rows, void* scratch, int g, int W, void* stream) {
  if (R < 1 || G < 1 || RS < R || r0 < 0 ||
      (int64_t)r0 + (int64_t)(G - 1) * RS + R > M || out_rows < R ||
      (h_in == nullptr) != (f_in == nullptr) ||
      (h_out == nullptr) != (f_out == nullptr) ||
      (h_in == nullptr && (!from_top || G > 1)) || bad_geometry(g, W) ||
      ptr == nullptr || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  GotohSpanArgs s = {};
  s.a = (const unsigned char*)a;
  s.b = (const unsigned char*)b;
  s.h_in = (const int*)h_in;
  s.f_in = (const int*)f_in;
  s.h_out = (int*)h_out;
  s.f_out = (int*)f_out;
  s.ptr = (unsigned char*)ptr;
  s.B = B;
  s.M = M;
  s.N = N;
  s.G = G;
  s.r0 = r0;
  s.RS = RS;
  s.R = R;
  s.from_top = from_top != 0;
  s.packed = packed != 0;
  s.out_rows = out_rows;
  s.gap_open = gap_open;
  s.gap_extend = gap_extend;
  for (int k = 0; k < 16; ++k) s.sub[k] = sub[k];
  return launch_gotoh<true>(s, g, W, scratch, stream);
}
