// The affine traceback walk shared by K4 (csrc/gapped.cu, full pointer
// rows) and K12 (csrc/banded.cu, banded pointer rows).
//
// Replaces the `step` scans of libmems_tpu/ops/gapped.py _device_tb_scan
// (:213-265) and libmems_tpu/ops/profile.py _banded_fwd_tb (:445-477).
//
// Bound: latency.  A step reads one pointer byte whose address depends on
// the step before, so a window's walk is a chain of p_len + q_len (+ one
// per entry into E or F) dependent loads; the longest window's chain is
// the launch's floor.  Read from global memory each load waits out an L2
// round trip (hundreds of cycles); read from shared memory, tens.
//
// Design.  One warp a window, several windows a block.  All 32 lanes run
// the state machine in lockstep on the same values (every branch is
// warp-uniform and every shared-memory read a broadcast); lane 0 stores
// the output.  The walker reads shared memory only: the window's pointer
// rows are staged in a ring of `depth` slabs of `rows` rows, filled by
// the whole warp with 16-byte cp.async copies.  A walk only moves up (the
// row never grows), so in the whole-row geometries the slabs are the
// consecutive row ranges above the current one: when the walk leaves a
// slab, the next one has been in flight for (depth - 1) slabs' worth of
// steps, and the freed slot takes the slab `depth` ahead.  A row of
// N+1 (K4) or WB+1 (K12) bytes is not a multiple of 16, so a whole-row
// slab is copied as one contiguous byte range rounded out to 16 bytes
// (cp.async's src-size zero-fills past the tensor's end) and read at the
// range's offset.  Rows of more than 2 KB take the slab geometry:
// `rows` x `cols` columns to the left of the current column (plus a
// margin of `rows` to its right), each row rounded out to 16 bytes; the
// next slab is the one diagonally above, and a walk that leaves a slab
// elsewhere drains the ring and re-anchors it where it stands.
//
// Output: 2-bit codes (0 aligned, 1 gap in a, 2 gap in b), one per
// emitted column, in column order, right-aligned in the window's row of
// C16 words: the first column the walk emits (the last of the alignment)
// is code 15 of word C16 - 1.  Lane 0 packs 16 codes in a register and
// stores whole words backwards; the warp zeroes the words left of the
// alignment, so the buffer needs no fill.  counts[b] = columns emitted,
// steps[b] = steps taken (at most T, the JAX scan's length).
#pragma once

#include "common.cuh"

namespace lm_walk {

// The pointer byte's extend bits (ops/gapped.py E_EXT_BIT, F_EXT_BIT);
// bits 0-1 hold the H source.
constexpr unsigned char kEExt = 4, kFExt = 8;

// rows a slab, slabs in the ring, columns a slab (0: whole rows)
struct Geometry {
  int rows, depth, cols;
};
constexpr Geometry kGeometries[] = {
    {32, 4, 0}, {16, 3, 0}, {8, 3, 0}, {4, 3, 0}, {32, 2, 512}};
constexpr int kGeometryCount = 5;
constexpr int kMaxWarps = 16;  // windows a block

__host__ __device__ inline int64_t ceil16(int64_t x) {
  return (x + 15) & ~(int64_t)15;
}

// A geometry resolved for one launch.
struct Plan {
  int g = -1;
  int rows = 0, depth = 0, cols = 0;  // cols 0: whole rows
  int pitch = 0;                      // slab geometry: bytes a staged row
  int slot = 0;                       // bytes a ring slot
  int warps = 0;                      // windows a block; 0: does not fit
  int64_t smem = 0;                   // bytes a block
};

// Geometry g for B windows of Mp rows of S bytes on n_sm SMs with
// max_smem bytes of shared memory a block: the ring of a window, and as
// many windows a block as the launch spreads over an SM (at most
// kMaxWarps) and the shared memory holds.
inline Plan plan(int g, int B, int Mp, int64_t S, int n_sm,
                 int64_t max_smem) {
  const Geometry geo = kGeometries[g];
  Plan pl;
  pl.g = g;
  pl.rows = geo.rows < Mp ? geo.rows : (Mp > 0 ? Mp : 1);
  pl.cols = geo.cols == 0 ? 0 : (geo.cols < S ? geo.cols : (int)S);
  const int slabs = (Mp + pl.rows - 1) / pl.rows;
  pl.depth = geo.depth;
  if (geo.cols == 0 && slabs <= 1) pl.depth = 1;  // one slab holds all
  if (geo.cols == 0) {
    pl.slot = (int)(ceil16((int64_t)pl.rows * S) + 16);
  } else {
    pl.pitch = (int)(ceil16(pl.cols) + 16);
    pl.slot = pl.rows * pl.pitch;
  }
  const int64_t ring = (int64_t)pl.depth * pl.slot;
  int want = n_sm > 0 ? (B + n_sm - 1) / n_sm : 1;
  want = want < 1 ? 1 : (want > kMaxWarps ? kMaxWarps : want);
  const int64_t fit = ring > 0 ? max_smem / ring : 0;
  pl.warps = (int)(fit < want ? fit : want);
  pl.smem = pl.warps * ring;
  return pl;
}

// The launch's geometry.  Rows of up to kWholeRowMax bytes: the first
// whole-row geometry (deepest ring first) that holds as many windows a
// block as the launch wants, else the one holding the most.  Wider rows,
// or rows no whole-row ring holds, take the slab geometry: a whole row a
// step would need more bytes a step than an SM's share of L2 bandwidth
// delivers in the tens of cycles a step takes.  `force` >= 0 takes that
// geometry.  warps == 0 where nothing fits.
constexpr int64_t kWholeRowMax = 2048;

inline Plan pick(int B, int Mp, int64_t S, int n_sm, int64_t max_smem,
                 int force) {
  if (force >= 0) return plan(force, B, Mp, S, n_sm, max_smem);
  int want = n_sm > 0 ? (B + n_sm - 1) / n_sm : 1;
  want = want < 1 ? 1 : (want > kMaxWarps ? kMaxWarps : want);
  Plan best;
  for (int g = 0; g < kGeometryCount && S <= kWholeRowMax; ++g) {
    if (kGeometries[g].cols != 0) continue;
    const Plan pl = plan(g, B, Mp, S, n_sm, max_smem);
    if (pl.warps >= want) return pl;
    if (pl.warps > best.warps) best = pl;
  }
  if (best.warps > 0) return best;
  return plan(kGeometryCount - 1, B, Mp, S, n_sm, max_smem);
}

__device__ __forceinline__ void cp16(uint32_t dst, const unsigned char* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this lane's copy groups are pending, then make
// every lane's copies visible to the warp.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
  __syncwarp();
}

// Copy the bytes [a, a + n) of the pointer tensor (which ends at gend)
// to shared address dst, rounded out to 16 bytes: byte a lands at dst +
// (a & 15).  The whole warp calls it.
__device__ __forceinline__ void stage(uint32_t dst, const unsigned char* a,
                                      int64_t n, const unsigned char* gend,
                                      int lane) {
  const unsigned char* a0 =
      (const unsigned char*)((uintptr_t)a & ~(uintptr_t)15);
  const int64_t span = ceil16((int64_t)(a - a0) + n);
  for (int64_t off = 16 * lane; off < span; off += 16 * 32) {
    const int64_t left = gend - (a0 + off);
    if (left > 0) cp16(dst + (uint32_t)off, a0 + off, left < 16 ? (int)left : 16);
  }
}

extern __shared__ __align__(16) unsigned char walk_smem[];

// The ring of one window.  Slab k of an anchor (ra, ca) holds rows
// [ra + 1 - (k+1)*rows, ra + 1 - k*rows) (clipped at 0) and, in the slab
// geometry, columns [c_hi - cols, c_hi) with c_hi = ca + 1 + rows -
// k*rows kept within [min(cols, S), S]: the diagonal above.  Offsets are
// bytes into walk_smem.
struct Ring {
  const unsigned char* gwin;  // the window's pointer rows
  const unsigned char* gend;  // the pointer tensor's end
  uint32_t sbase;             // shared address of walk_smem
  int soff;                   // the warp's ring in walk_smem
  int S, rows, depth, cols, pitch, slot, lane;
  int ra = 0, ca = 0, k = 0;  // anchor and current slab
  int r_lo = 0, r_hi = 0, c_lo = 0, c_hi = 0;
  int base = 0;  // whole rows: offset of byte (0, 0); slab: of the slot
  int gmod = 0;  // slab: (address of column c_lo of row 0) & 15

  __device__ void bounds(int kk, int* lo, int* hi, int* clo, int* chi) const {
    *hi = ra + 1 - kk * rows;
    *lo = *hi - rows > 0 ? *hi - rows : 0;
    if (cols == 0) {
      *clo = 0;
      *chi = S;
    } else {
      const int cmin = cols < S ? cols : S;
      int c = ca + 1 + rows - kk * rows;
      c = c < cmin ? cmin : (c > S ? S : c);
      *chi = c;
      *clo = c - cols > 0 ? c - cols : 0;
    }
  }

  __device__ void issue(int kk) const {
    int lo, hi, clo, chi;
    bounds(kk, &lo, &hi, &clo, &chi);
    const uint32_t dst = sbase + (uint32_t)(soff + (kk % depth) * slot);
    if (hi > 0) {
      if (cols == 0) {
        stage(dst, gwin + (int64_t)lo * S, (int64_t)(hi - lo) * S, gend, lane);
      } else {
        for (int r = lo; r < hi; ++r)
          stage(dst + (uint32_t)((r - lo) * pitch), gwin + (int64_t)r * S + clo,
                chi - clo, gend, lane);
      }
    }
    commit();
  }

  __device__ void enter(int kk) {
    k = kk;
    int lo;
    bounds(kk, &lo, &r_hi, &c_lo, &c_hi);
    r_lo = lo;
    const int slot_off = soff + (kk % depth) * slot;
    if (cols == 0) {
      base = slot_off + (int)(((uintptr_t)(gwin + (int64_t)lo * S)) & 15) -
             lo * S;
    } else {
      base = slot_off;
      gmod = (int)(((uintptr_t)gwin + c_lo) & 15);
    }
  }

  // Drain the ring and fill it from the anchor (r, c).
  __device__ void reset(int r, int c) {
    wait_pending(0);
    ra = r;
    ca = c;
    for (int kk = 0; kk < depth; ++kk) issue(kk);
    wait_pending(depth - 1);
    enter(0);
  }

  // Move to the next slab; the freed slot takes the slab depth ahead.
  __device__ void advance() {
    wait_pending(depth - 2);
    const int done = k;
    enter(k + 1);
    issue(done + depth);
  }

  __device__ bool holds(int r, int c) const {
    return r >= r_lo && r < r_hi && c >= c_lo && c < c_hi;
  }

  // Offset of column 0 of row r in the current slab: byte (r, c) is
  // walk_smem[row(r) + c].
  template <bool kWhole>
  __device__ __forceinline__ int row(int r) const {
    if (kWhole) return base + r * S;
    return base + (r - r_lo) * pitch + ((gmod + r * S) & 15) - c_lo;
  }
};

// Walk one window (the whole warp calls it).  col.enter(r) readies the
// columns of pointer row r (K12: its band's lo), col.at(j) is the column
// of DP cell (r+1, j), col.first_row(r) the first row that shares r's
// columns.  kWhole: the ring holds whole rows.  words: the window's C16
// words.
//
// The inner loop takes the steps that read a byte of the current slab.
// A GPU does not predict branches, so a step has none but the loop's
// own, and its dependent chain is short: the shared load, x = the byte's
// H source | state << 2, the moves of i and j read from bit x of a mask
// (diagonal: x = 0; E: x = 4-7; F: x = 8-11), the next column.  It
// leaves for the row slab's or band block's first row, for column 0 (or
// the slab's first column), for the bound T and for x = 3 (H with no
// source: the walk never moves again, and the JAX scan runs its
// remaining steps emitting nothing).  The outer loop takes the steps
// along row 0 or column 0, which read nothing, and moves the ring.
constexpr int kMoveI = 0xF01, kMoveJ = 0x0F1, kEmits = 0xFF1;

template <bool kWhole, class Col>
__device__ void walk_window(Ring& ring, Col& col, int p_len, int q_len, int T,
                            int C16, uint32_t* words, int* count_out,
                            int* steps_out) {
  const int lane = ring.lane;
  int i = p_len, j = q_len, st = 0, t = 0;
  bool have = false;
  uint32_t acc = 0;
  int nacc = 0;
  uint32_t* wp = words + C16 - 1;  // the next full word's place
  // append a column's code (0 where emit is 0): a full word goes to the
  // row, right to left, stored by every lane (the same value); its codes
  // leave acc as the next 16 come in
  auto push = [&](int emit, uint32_t code) {
    acc = (acc << (emit << 1)) | code;
    nacc += emit;
    if (nacc == 16) *wp = acc;
    wp -= nacc >> 4;
    nacc &= 15;
  };
  while (t < T && (i > 0 || j > 0)) {
    if (i == 0 || j == 0) {  // along row 0 (gaps in a) or column 0 (in b)
      ++t;
      push(1, i == 0 ? 1u : 2u);
      j -= i == 0 ? 1 : 0;
      i -= i == 0 ? 0 : 1;
      continue;
    }
    const int r = i - 1;
    col.enter(r);
    int c = col.at(j);
    if (!have) {
      ring.reset(r, c);
      have = true;
    } else if (!ring.holds(r, c)) {
      ring.advance();
      if (!ring.holds(r, c)) ring.reset(r, c);
    }
    const int r_stop = max(ring.r_lo, col.first_row(r));
    const int c_lo = kWhole ? 0 : ring.c_lo;
    int rp = ring.template row<kWhole>(r);
    bool stuck = false;
#pragma unroll 1
    for (;;) {
      const int b = walk_smem[rp + c];
      const int x = (b & 3) | (st << 2);
      const int di = (kMoveI >> x) & 1, dj = (kMoveJ >> x) & 1;
      i -= di;
      j -= dj;
      if (kWhole) {
        rp -= di * ring.S;
      } else {
        rp = ring.template row<kWhole>(i - 1);
      }
      c = col.at(j);
      push((kEmits >> x) & 1, (uint32_t)(x >> 2));
      stuck = x == 3;
      st = st == 0 ? (b & 3) : (b >> 2) & st;
      ++t;
      if (i <= r_stop || j == 0 || t >= T || stuck || c < c_lo) break;
    }
    if (stuck) t = T;
  }
  const int widx = (int)(wp - words);
  const int emitted = 16 * (C16 - 1 - widx) + nacc;
  if (nacc > 0) *wp = acc << (2 * (16 - nacc));
  for (int w = lane; w <= widx - (nacc > 0 ? 1 : 0); w += 32) words[w] = 0;
  if (lane == 0) {
    *count_out = emitted;
    *steps_out = t;
  }
  if (have) wait_pending(0);
}

// One window a warp: window b = blockIdx.x * warps + warp.  S: bytes a
// pointer row; the kernel's Col is made from the window index.
template <bool kWhole, class MakeCol>
__device__ void walk_kernel_body(const unsigned char* ptr, int64_t total,
                                 const int* p_len, const int* q_len, int B,
                                 int Mp, int S, int T, int C16, Plan pl,
                                 uint32_t* words, int* counts, int* steps,
                                 MakeCol make_col) {
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * pl.warps + warp;
  if (b >= B) return;
  Ring ring;
  ring.gwin = ptr + (int64_t)b * Mp * S;
  ring.gend = ptr + total;
  ring.sbase = (uint32_t)__cvta_generic_to_shared(walk_smem);
  ring.soff = warp * pl.depth * pl.slot;
  ring.S = S;
  ring.rows = pl.rows;
  ring.depth = pl.depth;
  ring.cols = pl.cols;
  ring.pitch = pl.pitch;
  ring.slot = pl.slot;
  ring.lane = threadIdx.x & 31;
  auto col = make_col(b);
  walk_window<kWhole>(ring, col, p_len[b], q_len[b], T, C16,
                      words + (int64_t)b * C16, counts + b, steps + b);
}

// What a launch asks of its card: its SM count, the walk kernels' shared
// memory limit (the two instantiations take the same) and the dynamic
// shared memory each instantiation has been allowed.  Asked once a card:
// the path's walks are many short launches.
struct Card {
  int n_sm = 0;
  int64_t max_smem = -1;
  int64_t allowed[2] = {0, 0};  // slab, whole-row instantiation
};
constexpr int kMaxCards = 64;

template <typename Kernel>
inline cudaError_t card_of(Kernel kernel, Card* cards, Card** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxCards) return cudaErrorInvalidDevice;
  Card& c = cards[dev];
  if (c.max_smem < 0) {
    err = cudaDeviceGetAttribute(&c.n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int64_t m = lm::max_dyn_smem(kernel);
    if (m < 0) return cudaErrorUnknown;
    c.max_smem = m;
  }
  *out = &c;
  return cudaSuccess;
}

// The plan of a launch (geometry `force`, or the pick for force < 0) on
// the current card; `kernels` are the slab and whole-row instantiations,
// the chosen one allowed its shared memory.
template <typename Kernel>
inline cudaError_t plan_launch(const Kernel (&kernels)[2], Card* cards,
                               int B, int Mp, int64_t S, int force,
                               Plan* out) {
  if (force >= kGeometryCount) return cudaErrorInvalidValue;
  Card* card = nullptr;
  cudaError_t err = card_of(kernels[1], cards, &card);
  if (err != cudaSuccess) return err;
  *out = pick(B, Mp, S, card->n_sm, card->max_smem, force);
  const int v = out->cols == 0 ? 1 : 0;
  if (out->warps > 0 && out->smem > card->allowed[v]) {
    err = lm::allow_dyn_smem(kernels[v], out->smem);
    if (err != cudaSuccess) return err;
    card->allowed[v] = out->smem;
  }
  return cudaSuccess;
}

// out: int[6] = {geometry, rows, depth, cols (0: whole rows), windows a
// block (0: does not fit), shared bytes a block}.
inline void describe(const Plan& pl, int* out) {
  out[0] = pl.g;
  out[1] = pl.rows;
  out[2] = pl.depth;
  out[3] = pl.cols;
  out[4] = pl.warps;
  out[5] = (int)pl.smem;
}

}  // namespace lm_walk
