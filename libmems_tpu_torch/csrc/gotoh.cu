// K22: pairwise int32 Gotoh forward with (H, F) carries every K rows, and
// K23: the pointer bytes of a block of rows from a carry, one thread block
// per pair.
//
// K22 replaces libmems_tpu/ops/gapped.py _gotoh_forward_ckpt (:151, a
// lax.scan over blocks of K = CKPT_ROWS rows of _gotoh_row_fn with
// emit_ptr=False, from _gotoh_h0f0).  K23 replaces _gotoh_block_ptrs
// (:178, the same rows with emit_ptr=True) and, when asked to pack,
// pack_ptrs (:188): two 4-bit cells a byte, cell 2k in the low nibble.
//
// Bound: the row recurrence.  Row i depends on row i-1, and within a row
// E needs a prefix maximum over the columns, so a row costs one block
// scan per tile of blockDim columns whatever the work per cell (three
// integer operations for F, the diagonal and g; K23 adds a pointer byte).
// Design: threads stripe the columns in tiles of blockDim; a tile reads
// its cells' (H, F) of the previous row, computes F, the diagonal and the
// non-E candidate g, and runs a block-wide inclusive max scan of
//   w[c] = (G'[c] + open) - ext * c      (G'[0] = F[i][0], G'[c] = g[c])
// carrying the running maximum across tiles, so that
//   E[c] = ext * c + max_{k<c} w[k],  H[c] = max(g[c], E[c]).
// Each thread keeps its column's values in registers through the tile,
// so the row's (H, F) live in 8 * (N+1) bytes of shared memory (global
// scratch when that exceeds what a block may opt into): the one value a
// tile overwrites that the next tile still reads, the old H of its last
// column, passes through a two-slot shared register.
//
// Arithmetic copies ops/gapped.py:98-137 in int32 (exact, no order to
// fix); the pointer byte is the H source (0 diagonal, 1 E, 2 F; ties in
// that order), bit 4 E-extend (E[c] == E[c-1] + ext, c >= 2), bit 8
// F-extend (F == F_prev + ext and F_prev > NEG_INF / 2); column 0 is
// H_F | F-extend.  Every row and column of the padded [Mp, N+1] matrix is
// computed, so carries and pointer bytes equal the JAX arrays whole.
#include "common.cuh"

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kNegHalf = -(1 << 29);  // NEG_INF // 2
constexpr unsigned char kHDiag = 0, kHE = 1, kHF = 2, kEExt = 4, kFExt = 8;

struct GotohArgs {
  const unsigned char* a;  // [B, R] the symbols of the rows computed
  const unsigned char* b;  // [B, N]
  const int* a_len;        // [B] (K22) or null
  const int* b_len;        // [B] (K22) or null
  const int* h_in;         // [B, N+1] carry at the top of the rows, or
  const int* f_in;         //   null for the DP's first row (_gotoh_h0f0)
  int* score;              // [B] H at (a_len, b_len), or null
  int* ck_h;               // [R / K, B, N+1] carries, or null
  int* ck_f;
  unsigned char* ptr;      // K23: [B, R, N+1], or [B, R, (N+2)/2] packed
  int* rows;               // [B, 2, N+1] global row scratch, or null
  int B, R, N, K, gap_open, gap_extend, packed;
  int sub[16];             // substitution scores, sub[x * 4 + y]
};

template <bool kPtr>
__global__ void gotoh_kernel(GotohArgs g) {
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
  const int al = g.a_len != nullptr ? g.a_len[b] : -1;
  const int bl = g.b_len != nullptr ? g.b_len[b] : -1;
  if (tid < 16) s_sub[tid] = g.sub[tid];

  // the carry at the top of the rows (block 0's checkpoint for K22)
  for (int c = tid; c < n1; c += nt) {
    int h, f;
    if (g.h_in != nullptr) {
      h = g.h_in[(int64_t)b * n1 + c];
      f = g.f_in[(int64_t)b * n1 + c];
    } else {
      h = c == 0 ? 0 : g.gap_open + ext * c;
      f = kNegInf;
    }
    H[c] = h;
    F[c] = f;
    if (g.ck_h != nullptr) {
      g.ck_h[(int64_t)b * n1 + c] = h;
      g.ck_f[(int64_t)b * n1 + c] = f;
    }
    if (g.score != nullptr && al == 0 && c == bl) g.score[b] = h;
  }
  __syncthreads();

  const int ntiles = (n1 + nt - 1) / nt;
  const int64_t width = g.packed ? (N + 2) / 2 : n1;
  for (int r = 0; r < g.R; ++r) {
    const int* srow = s_sub + min((int)arow[r], 3) * 4;
    const bool ck_now = g.ck_h != nullptr && (r + 1) % g.K == 0 && r + 1 < g.R;
    const int64_t ck_off =
        ck_now ? ((int64_t)((r + 1) / g.K) * g.B + b) * n1 : 0;
    unsigned char* prow =
        kPtr ? g.ptr + ((int64_t)b * g.R + r) * width : nullptr;
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
        if (ck_now) {
          g.ck_h[ck_off + c] = h;
          g.ck_f[ck_off + c] = f;
        }
        if (g.score != nullptr && r + 1 == al && c == bl) g.score[b] = h;
      }
      if (kPtr) {
        if (!valid) p = 0;  // the zero pad cell of an odd width
        if (g.packed) {
          const unsigned hi = __shfl_down_sync(0xffffffffu, (unsigned)p, 1);
          if (valid && !(c & 1)) prow[c >> 1] = (unsigned char)(p | (hi << 4));
        } else if (valid) {
          prow[c] = p;
        }
      }
    }
    __syncthreads();
  }
}

template <bool kPtr>
int launch_gotoh(GotohArgs& g, void* stream) {
  int threads = ((g.N + 1 + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  const int64_t smem = g.rows != nullptr ? 0 : (int64_t)8 * (g.N + 1);
  const cudaError_t err = lm::allow_dyn_smem(gotoh_kernel<kPtr>, smem);
  if (err != cudaSuccess) return (int)err;
  if (g.B > 0) {
    LM_LAUNCH(gotoh_kernel<kPtr>, (unsigned)g.B, threads, (size_t)smem,
              (cudaStream_t)stream, g);
  }
  return (int)cudaGetLastError();
}

GotohArgs make_args(const void* a, const void* b, int B, int R, int N,
                    int gap_open, int gap_extend, const int* sub,
                    void* rows) {
  GotohArgs g = {};
  g.a = (const unsigned char*)a;
  g.b = (const unsigned char*)b;
  g.rows = (int*)rows;
  g.B = B;
  g.R = R;
  g.N = N;
  g.K = 1;
  g.gap_open = gap_open;
  g.gap_extend = gap_extend;
  for (int k = 0; k < 16; ++k) g.sub[k] = sub[k];
  return g;
}

}  // namespace

// Bytes of shared memory one pair's (H, F) rows take at N columns.
extern "C" int64_t lm_gotoh_row_bytes(int N) { return (int64_t)8 * (N + 1); }

// Bytes of dynamic shared memory K22 and K23 may opt into on the current
// device (-1 when the runtime cannot say): wider rows need global scratch.
extern "C" int64_t lm_gotoh_smem_limit() {
  const int64_t f = lm::max_dyn_smem(gotoh_kernel<false>);
  const int64_t p = lm::max_dyn_smem(gotoh_kernel<true>);
  return f < p ? f : p;
}

// K22.  a: uint8[B, M] (M a multiple of K); b: uint8[B, N]; a_len, b_len:
// int32[B]; sub: HOST int[16]; score: int32[B]; ck_h, ck_f:
// int32[M / K, B, N+1] or both null (score only); rows: int32[B, 2, N+1]
// or null to keep the rows in shared memory.
extern "C" int lm_gotoh_fwd(const void* a, const void* b, const void* a_len,
                            const void* b_len, int B, int M, int N, int K,
                            int gap_open, int gap_extend, const int* sub,
                            void* score, void* ck_h, void* ck_f, void* rows,
                            void* stream) {
  if (K < 1 || M % K != 0) return (int)cudaErrorInvalidValue;
  GotohArgs g = make_args(a, b, B, M, N, gap_open, gap_extend, sub, rows);
  g.a_len = (const int*)a_len;
  g.b_len = (const int*)b_len;
  g.score = (int*)score;
  g.ck_h = (int*)ck_h;
  g.ck_f = (int*)ck_f;
  g.K = K;
  return launch_gotoh<false>(g, stream);
}

// K23.  a: uint8[B, R] the block's symbols; h_in, f_in: int32[B, N+1] the
// carry at the block's top, or both null for the DP's first row; b:
// uint8[B, N]; ptr: uint8[B, R, N+1], or uint8[B, R, (N+2)/2] when
// packed; rows as for lm_gotoh_fwd.
extern "C" int lm_gotoh_ptrs(const void* a, const void* h_in,
                             const void* f_in, const void* b, int B, int R,
                             int N, int gap_open, int gap_extend,
                             const int* sub, int packed, void* ptr,
                             void* rows, void* stream) {
  GotohArgs g = make_args(a, b, B, R, N, gap_open, gap_extend, sub, rows);
  g.h_in = (const int*)h_in;
  g.f_in = (const int*)f_in;
  g.ptr = (unsigned char*)ptr;
  g.packed = packed;
  return launch_gotoh<true>(g, stream);
}
