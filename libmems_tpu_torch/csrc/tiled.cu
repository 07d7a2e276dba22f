// K29-K31: the position-tiled extension's probe round.
//
// Replace libmems_tpu/parallel/shard.py:538 _dist_fetch_factory (with
// ops/extend.py:66 _fetch_spans) and the probe of ops/extend.py:210
// make_probe_round on fetched spans, as _sharded_tiled_once (:663) drives
// them: no shard holds the whole position-order key table, only its tile
// of S keys plus a halo; a probe round asks the owner of each span start
// for the span's C keys.
//
// The JAX fetch sorts every (row, genome) request of every row, valid or
// not, by owner, sends a [n_dev, req_cap] buffer each way and answers
// with [n_dev, req_cap, C] spans: 68.7 GB a shard at the 2 x 4.6 Mbp
// pair's defaults.  Here only the active rows' present genomes ask, the
// buffers hold the real counts, and the caller cuts the rows into blocks
// whose responses stay under a bound.
//
// K29 (lm_tiled_count + lm_tiled_requests): each request's span start in
// the padded global space (ops/extend.py:235-239), its owner clip(start /
// S, 0, n_dev - 1) and its slot, the rank among the requests to that owner
// in (row, genome) order.  Bound: bytes (the rows' state read, the send
// buffer written); the ranks make it two passes around a cumsum of the
// per-tile counts: a tile of 256 requests counts its requests per owner
// (pass 1), then ranks them within the tile with __match_any_sync and the
// warps' counts (pass 2), so the rank is deterministic and no sort runs.
// Requests past req_cap for one owner are not sent (the caller counts
// them for a retry).
//
// K30 (lm_tiled_serve): the owner copies tile[s : s + C] for each received
// tile-local offset s, a sentinel row for an offset outside its tile
// (parallel/shard.py:572-577).  Bound: the answer's bytes written (about
// 1 GB at the tiled pair's first fetch); a shard's tile (S + halo keys,
// about 18 MB there) stays in the 50 MB L2 for the spans that requests
// share.  A warp owns whole spans, 8 warps a block, a grid stride over
// the requests sized to the card's resident blocks: one lane reads the
// start and a shuffle shares it, the in-tile test is made once a span,
// and the span index is the loop variable, so no 64-bit division is
// left.  Every store carries the evict-first hint (st.global.cs): the
// answer is read again only by the exchange, and the tile keeps L2.  The
// loop is unrolled so that a lane has four stores in flight, a key a
// store: two keys a 16-byte store (pairs from the row's first 16-byte
// boundary) took 0.6-1.0% more card time at the tiled pair's first fetch
// on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md row 15d-2).  The
// time is the tile's reads through L2 beside the writes: the same starts
// sorted, so that neighbouring warps share tile lines, run about a fifth
// faster.
// No TMA or cp.async.bulk: a span starts at any key, so its source is
// 16-byte aligned only for half the starts, and bulk copies need 16-byte
// aligned addresses and sizes.
//
// K31 (lm_tiled_probe): the probe round of ops/extend.py:241-294 on the
// fetched spans (the key of a backward genome at offset d is span[C - d],
// of an ahead genome span[d - 1]; a dropped request reads the sentinel,
// so its row matches at no offset), updating each row's left ends,
// length and activity in place.  Two routes, picked by G alone as K2's:
//
// Warp route (G <= lm_chain::kWarpGenomes): a warp a row, kRowWarps rows a block.
// Lane g holds genome g's state in registers (left end, window count,
// presence, strand, its span's row of resp); the reference genome is the
// first set bit of a ballot of presence.  The test that a probe position
// lies in [0, count) is one offset range [lo, hi] (a warp min/max, hi <=
// C; empty for a dropped request).  A step reads u ballot words of 32
// offsets (u = 1, 2, 4, then lm_chain::kMaxWords): for each present genome
// the lanes read 32 consecutive keys of its span (one 256-byte load,
// descending for a genome that moves left), and chain_word follows the
// chain on the words (csrc/chain.cuh, shared with K2); reading stops at
// the chain's break, at seed_len offsets past its last match, or at hi.
// Then the advance and the room by a warp min: no __syncthreads and no
// block scan.  A row that breaks within its first word reads 32 keys a
// genome rather than C.  But on the tiled pair most rows of a round read
// all of C (the least probe is 89% of the whole spans), so a row's time
// is its chain of dependent loads, five steps a genome at C = 512: a row
// whose chain outlives its first word therefore asks L2 for the rest of
// its spans up to hi at once (prefetch.global.L2, a line a lane, no
// register held), and the later steps hit L2.
//
// Block route (more genomes): one block of 256 threads a row over
// csrc/probe.cuh (K2's wide route shares it), the row state in dynamic
// shared memory: match bits of every offset 1..C, then block scans for
// the reference genome, the reach and the room.
//
// Bound: bytes, the keys a round must read (each answered span's up to
// the round's break: its last match plus seed_len offsets, or the span's
// valid offsets where fewer) and the rows' state; the warp route's time
// is its rows' chains of dependent word steps.
#include "chain.cuh"
#include "common.cuh"
#include "probe.cuh"

namespace {

using lm_chain::Chain;
using lm_chain::chain_word;
using lm_chain::kFull;
using lm_chain::kMaxWords;
using lm_chain::kWarpGenomes;
using lm_chain::max64;
using lm_chain::min64;
using lm_chain::probe_words;
using lm_chain::SideGeom;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// K31's warp route (lm_chain::kWarpGenomes genomes a row at most): rows a
// block, a warp each
constexpr int kRowWarps = kWarps;

// Owner of request i = (row rows[i / G], genome i % G) and its tile-local
// span start; owner -1 where the genome is absent from the row.
struct Request {
  int owner;
  int64_t local;
};

__device__ __forceinline__ Request request_of(
    int64_t i, int G, const int64_t* rows, const int* lefts,
    const int* lengths, const uint8_t* present, const uint8_t* is_fwd,
    const int* gen_off, int side, int C, int seed_len, int64_t big,
    int64_t S, int n_dev) {
  const int64_t r = rows[i / G];
  const int g = (int)(i % G);
  const int64_t k = r * G + g;
  Request q{-1, 0};
  if (!present[k]) return q;
  const bool back = side == 0 ? is_fwd[k] != 0 : is_fwd[k] == 0;
  const int64_t l = lefts[k];
  const int64_t start =
      (back ? l - C : l + lengths[r] - seed_len + 1) + gen_off[g] + big;
  int64_t o = start >= 0 ? start / S : -((-start + S - 1) / S);
  o = o < 0 ? 0 : (o > n_dev - 1 ? n_dev - 1 : o);
  q.owner = (int)o;
  q.local = start - o * S;
  return q;
}

// Pass 1: requests per owner of each tile of kThreads requests.
__global__ void __launch_bounds__(kThreads) tiled_count_kernel(
    int64_t n, int G, const int64_t* __restrict__ rows,
    const int* __restrict__ lefts, const int* __restrict__ lengths,
    const uint8_t* __restrict__ present, const uint8_t* __restrict__ is_fwd,
    const int* __restrict__ gen_off, int side, int C, int seed_len,
    int64_t big, int64_t S, int n_dev, int* __restrict__ tile_counts) {
  extern __shared__ int s_cnt[];
  for (int o = threadIdx.x; o < n_dev; o += blockDim.x) s_cnt[o] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const Request q = request_of(i, G, rows, lefts, lengths, present, is_fwd,
                                 gen_off, side, C, seed_len, big, S, n_dev);
    if (q.owner >= 0) atomicAdd(&s_cnt[q.owner], 1);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < n_dev; o += blockDim.x) {
    tile_counts[(int64_t)blockIdx.x * n_dev + o] = s_cnt[o];
  }
}

// Pass 2: slot = the tile's base for the owner (requests to it in earlier
// tiles) + the rank within the tile; slots below req_cap are written to
// the owner's segment of the send buffer (send_off[owner] + slot), and
// where[i] points there; -1 for an absent genome or a request past
// req_cap.
__global__ void __launch_bounds__(kThreads) tiled_requests_kernel(
    int64_t n, int G, const int64_t* __restrict__ rows,
    const int* __restrict__ lefts, const int* __restrict__ lengths,
    const uint8_t* __restrict__ present, const uint8_t* __restrict__ is_fwd,
    const int* __restrict__ gen_off, int side, int C, int seed_len,
    int64_t big, int64_t S, int n_dev, const int64_t* __restrict__ tile_base,
    const int64_t* __restrict__ send_off, int64_t req_cap,
    int64_t* __restrict__ send, int64_t* __restrict__ where) {
  extern __shared__ int s_warp[];  // [kWarps][n_dev]
  for (int k = threadIdx.x; k < kWarps * n_dev; k += blockDim.x) s_warp[k] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  Request q{-1, 0};
  if (i < n) {
    q = request_of(i, G, rows, lefts, lengths, present, is_fwd, gen_off, side,
                   C, seed_len, big, S, n_dev);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned same = __match_any_sync(0xffffffffu, q.owner);
  const int in_warp = __popc(same & ((1u << lane) - 1u));
  if (q.owner >= 0 && in_warp == 0) s_warp[warp * n_dev + q.owner] = __popc(same);
  __syncthreads();
  if (i >= n) return;
  if (q.owner < 0) {
    where[i] = -1;
    return;
  }
  int64_t slot = tile_base[(int64_t)blockIdx.x * n_dev + q.owner] + in_warp;
  for (int w = 0; w < warp; ++w) slot += s_warp[w * n_dev + q.owner];
  if (slot >= req_cap) {
    where[i] = -1;
    return;
  }
  const int64_t at = send_off[q.owner] + slot;
  send[at] = q.local;
  where[i] = at;
}

// K30: out[j, c] = tile[offs[j] + c] for 0 <= offs[j] < S, else fill; a
// warp a span j.
__global__ void __launch_bounds__(kThreads) tiled_serve_kernel(
    const long long* __restrict__ tile, int64_t S,
    const int64_t* __restrict__ offs, int64_t n, int C, long long fill,
    long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  for (int64_t j = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); j < n;
       j += step) {
    int64_t s = 0;
    if (lane == 0) s = offs[j];
    s = __shfl_sync(kFull, s, 0);
    const bool in = s >= 0 && s < S;
    const long long* src = tile + (in ? s : 0);
    long long* row = out + j * C;
#pragma unroll 4
    for (int c = lane; c < C; c += 32) __stcs(row + c, in ? src[c] : fill);
  }
}

// K30's grid: the blocks the card holds at once, at most one warp a span.
cudaError_t serve_grid(int64_t n, unsigned* grid) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tiled_serve_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = n_sm * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t need = (n + kWarps - 1) / kWarps;
  *grid = (unsigned)(need < resident ? need : resident);
  return cudaSuccess;
}

// A probe key from a fetched span: genome g's span of the block row b.
struct SpanFetch {
  const long long* resp;
  const int64_t* where;  // the row's [G] indices into resp, -1: none
  int C;
  long long fill;
  __device__ long long operator()(int g, int, int d, bool back) const {
    const int64_t w = where[g];
    if (w < 0) return fill;
    return resp[w * C + (back ? C - d : d - 1)];
  }
};

// Asks L2 for the keys of offsets base + 1 .. sg.hi of every present
// genome's span (pmask), a 128-byte line a lane, so that the chain's later
// word steps find them there.  Every lane of the warp calls it.
__device__ __forceinline__ void prefetch_spans(const long long* resp,
                                               unsigned pmask,
                                               const SideGeom& sg, int base) {
  const int lane = threadIdx.x & 31;
  for (unsigned m = pmask; m; m &= m - 1) {
    const int g = __ffs(m) - 1;
    const long long at = __shfl_sync(kFull, sg.at, g);
    const int dir = __shfl_sync(kFull, sg.dir, g);
    const long long i0 = at + (long long)dir * (base + 1);
    const long long i1 = at + (long long)dir * sg.hi;
    const uintptr_t a0 =
        reinterpret_cast<uintptr_t>(resp + min64(i0, i1)) & ~(uintptr_t)127;
    const uintptr_t a1 = reinterpret_cast<uintptr_t>(resp + max64(i0, i1));
    for (uintptr_t p = a0 + 128 * (uintptr_t)lane; p <= a1; p += 32 * 128) {
      lm::prefetch_l2(reinterpret_cast<const void*>(p));
    }
  }
}

// K31's warp route: one probe round of block row b = blockIdx.x *
// kRowWarps + warp (row rows[b], active), genome g on lane g.
__global__ void __launch_bounds__(kThreads) tiled_probe_warp_kernel(
    const long long* __restrict__ resp, const int64_t* __restrict__ where,
    const int64_t* __restrict__ rows, int64_t Rb, int G,
    int* __restrict__ lefts, int* __restrict__ lengths,
    const uint8_t* __restrict__ present, const uint8_t* __restrict__ is_fwd,
    const int* __restrict__ gen_cnt, uint8_t* __restrict__ active, int side,
    int C, int seed_len, long long fill) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (b >= Rb) return;   // the whole warp
  const int64_t r = rows[b];
  const int64_t k = r * G + lane;
  bool pres = false, fwd = false;
  int left = 0, cnt = 0;
  int64_t wh = -1;
  if (lane < G) {
    pres = present[k] != 0;
    fwd = is_fwd[k] != 0;
    left = lefts[k];
    cnt = gen_cnt[lane];
    wh = where[b * G + lane];
  }
  const unsigned pmask = __ballot_sync(kFull, pres);
  if (!pmask) {
    if (lane == 0) active[r] = 0;
    return;
  }
  int len = lengths[r];
  // the span's geometry: key at offset d is resp[at + dir * d]; the probe
  // position q = q0 + dir * d lies in [0, cnt) exactly for d in [lo, hi]
  const bool back = side == 0 ? fwd : !fwd;
  const long long q0 = back ? left : (long long)left + len - seed_len;
  SideGeom sg;
  sg.at = (long long)wh * C + (back ? C : -1);
  sg.dir = back ? -1 : 1;
  sg.flip = fwd ? 1 : 0;
  long long lo = 1, hi = C;
  if (pres) {
    if (wh < 0) {
      hi = 0;   // no span answered: sentinel keys, a match nowhere
    } else if (back) {
      lo = max64(lo, q0 - cnt + 1);
      hi = min64(hi, q0);
    } else {
      lo = max64(lo, -q0);
      hi = min64(hi, cnt - 1 - q0);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = max64(lo, __shfl_xor_sync(kFull, lo, o));
    hi = min64(hi, __shfl_xor_sync(kFull, hi, o));
  }
  sg.lo = (int)min64(lo, (long long)C + 1);
  sg.hi = (int)max64(hi, 0);

  // the chain over words of 32 offsets, 1, 2, 4, then kMaxWords a step,
  // until it breaks or no later offset can continue it; a row that
  // outlives its first word asks L2 for the rest of its spans at once
  unsigned w[kMaxWords];
  Chain c{0, 0, true, false};
  int base = 0, u = 1;
  while (base < sg.hi) {
    probe_words(resp, fill, pmask, sg, base, u, w);
#pragma unroll
    for (int j = 0; j < kMaxWords; ++j) {
      if (j < u) chain_word(w[j], base + 32 * j, seed_len, c);
    }
    base += 32 * u;
    if (c.brk || base - c.p >= seed_len) break;
    if (u == 1) prefetch_spans(resp, pmask, sg, base);
    u = min(2 * u, kMaxWords);
  }

  // the advance (ops/extend.py:281-293): the moving genomes' left ends,
  // the length, and the least room left
  const int reach = c.p;
  if (pres && back) left -= reach;
  len += reach;
  int room = 1 << 30;
  if (pres) room = back ? left : (cnt - 1) - (left + len - seed_len);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    room = min(room, __shfl_xor_sync(kFull, room, o));
  }
  if (pres && back) lefts[k] = left;
  if (lane == 0) {
    lengths[r] = len;
    active[r] = (reach + seed_len > C) && (room + reach > C) ? 1 : 0;
  }
}

// K31's block route: one probe round of block row b = blockIdx.x (row
// rows[b], active).
__global__ void __launch_bounds__(kThreads) tiled_probe_kernel(
    const long long* __restrict__ resp, const int64_t* __restrict__ where,
    const int64_t* __restrict__ rows, int G, int* __restrict__ lefts,
    int* __restrict__ lengths, const uint8_t* __restrict__ present,
    const uint8_t* __restrict__ is_fwd, const int* __restrict__ gen_cnt,
    uint8_t* __restrict__ active, int side, int C, int seed_len,
    long long fill) {
  extern __shared__ int s_dyn[];
  __shared__ int s_tmp[lm::kScanTmp];
  const int b = blockIdx.x;
  const int64_t r = rows[b];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* s_left = s_dyn;
  int* s_cnt = s_dyn + G;
  int* s_pres = s_dyn + 2 * G;
  int* s_fwd = s_dyn + 3 * G;
  int first = G;
  for (int g = tid; g < G; g += nt) {
    const int64_t k = r * G + g;
    s_left[g] = lefts[k];
    s_cnt[g] = gen_cnt[g];
    s_pres[g] = present[k] != 0;
    s_fwd[g] = is_fwd[k] != 0;
    if (s_pres[g] && g < first) first = g;
  }
  // the block scan's barriers also publish the state written above
  const int ref = lm::block_scan(first, G, lm::MinOp(), s_tmp).total;
  if (ref >= G) {
    if (tid == 0) active[r] = 0;
    return;
  }
  int len = lengths[r];
  const int per = (C + nt - 1) / nt;
  const int d0 = tid * per + 1;
  const unsigned mbits = lm::probe_bits(
      d0, per, C, G, ref, side, len, seed_len, s_left, s_cnt, s_pres, s_fwd,
      fill, SpanFetch{resp, where + (int64_t)b * G, C, fill});
  const int reach = lm::probe_reach(mbits, d0, per, seed_len, s_tmp);
  const bool more = lm::probe_advance(reach, len, C, G, side, seed_len,
                                      s_left, s_cnt, s_pres, s_fwd, s_tmp);
  for (int g = tid; g < G; g += nt) lefts[r * G + g] = s_left[g];
  if (tid == 0) {
    lengths[r] = len;
    active[r] = more ? 1 : 0;
  }
}

}  // namespace

// K29 pass 1.  rows: int64[Rb] rows of the block (into lefts etc.);
// lefts: int32[R, G]; lengths: int32[R]; present, is_fwd: uint8[R, G];
// gen_off: int32[G]; tile_counts: int32[ceil(Rb * G / 256), n_dev].
extern "C" int lm_tiled_count(const void* rows, int64_t Rb, int G,
                              const void* lefts, const void* lengths,
                              const void* present, const void* is_fwd,
                              const void* gen_off, int side, int C,
                              int seed_len, int64_t big, int64_t S, int n_dev,
                              void* tile_counts, void* stream) {
  const int64_t n = Rb * G;
  if (G < 1 || n_dev < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const size_t smem = (size_t)n_dev * sizeof(int);
    const cudaError_t err = lm::allow_dyn_smem(tiled_count_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    LM_LAUNCH(tiled_count_kernel, (unsigned)((n + kThreads - 1) / kThreads),
              kThreads, smem, (cudaStream_t)stream, n, G,
              (const int64_t*)rows, (const int*)lefts, (const int*)lengths,
              (const uint8_t*)present, (const uint8_t*)is_fwd,
              (const int*)gen_off, side, C, seed_len, big, S, n_dev,
              (int*)tile_counts);
  }
  return (int)cudaGetLastError();
}

// K29 pass 2.  tile_base: int64[tiles, n_dev] exclusive prefix over tiles
// of tile_counts; send_off: int64[n_dev] each owner's first slot in send
// (exclusive prefix of min(count, req_cap)); send: int64[sum of those];
// where: int64[Rb, G].
extern "C" int lm_tiled_requests(const void* rows, int64_t Rb, int G,
                                 const void* lefts, const void* lengths,
                                 const void* present, const void* is_fwd,
                                 const void* gen_off, int side, int C,
                                 int seed_len, int64_t big, int64_t S,
                                 int n_dev, const void* tile_base,
                                 const void* send_off, int64_t req_cap,
                                 void* send, void* where, void* stream) {
  const int64_t n = Rb * G;
  if (G < 1 || n_dev < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const size_t smem = (size_t)kWarps * n_dev * sizeof(int);
    const cudaError_t err = lm::allow_dyn_smem(tiled_requests_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    LM_LAUNCH(tiled_requests_kernel,
              (unsigned)((n + kThreads - 1) / kThreads), kThreads, smem,
              (cudaStream_t)stream, n, G, (const int64_t*)rows,
              (const int*)lefts, (const int*)lengths, (const uint8_t*)present,
              (const uint8_t*)is_fwd, (const int*)gen_off, side, C, seed_len,
              big, S, n_dev, (const int64_t*)tile_base,
              (const int64_t*)send_off, req_cap, (int64_t*)send,
              (int64_t*)where);
  }
  return (int)cudaGetLastError();
}

// K30.  tile: int64[S + halo]; offs: int64[n]; out: int64[n, C].
extern "C" int lm_tiled_serve(const void* tile, int64_t S, const void* offs,
                              int64_t n, int C, int64_t fill, void* out,
                              void* stream) {
  if (n > 0 && C > 0) {
    unsigned grid = 0;
    const cudaError_t err = serve_grid(n, &grid);
    if (err != cudaSuccess) return (int)err;
    LM_LAUNCH(tiled_serve_kernel, grid, kThreads, 0, (cudaStream_t)stream,
              (const long long*)tile, S, (const int64_t*)offs, n, C,
              (long long)fill, (long long*)out);
  }
  return (int)cudaGetLastError();
}

// Bytes of shared memory the row state of G genomes takes on K31's block
// route (more than lm_extend_warp_genomes() genomes), and what the card
// lets a block of it opt into.
extern "C" int64_t lm_tiled_probe_row_bytes(int G) {
  return (int64_t)4 * G * (int64_t)sizeof(int);
}

extern "C" int64_t lm_tiled_probe_smem_limit() {
  return lm::max_dyn_smem(tiled_probe_kernel);
}

// K31.  resp: int64[n_resp, C]; where: int64[Rb, G]; rows: int64[Rb];
// lefts: int32[R, G], lengths: int32[R], active: uint8[R] updated in
// place for the block's rows; present, is_fwd: uint8[R, G]; gen_cnt:
// int32[G].  C <= 32 * 256.  Rows of at most lm_extend_warp_genomes()
// genomes take the warp route, wider rows the block route (row state in
// shared memory, at most lm_tiled_probe_smem_limit() bytes).
extern "C" int lm_tiled_probe(const void* resp, const void* where,
                              const void* rows, int64_t Rb, int G,
                              void* lefts, void* lengths, const void* present,
                              const void* is_fwd, const void* gen_cnt,
                              void* active, int side, int C, int seed_len,
                              int64_t fill, void* stream) {
  if (G < 1 || C < 1 || C > 32 * kThreads) return (int)cudaErrorInvalidValue;
  if (Rb > 0 && G <= kWarpGenomes) {
    LM_LAUNCH(tiled_probe_warp_kernel,
              (unsigned)((Rb + kRowWarps - 1) / kRowWarps), kThreads, 0,
              (cudaStream_t)stream, (const long long*)resp,
              (const int64_t*)where, (const int64_t*)rows, Rb, G, (int*)lefts,
              (int*)lengths, (const uint8_t*)present, (const uint8_t*)is_fwd,
              (const int*)gen_cnt, (uint8_t*)active, side, C, seed_len,
              (long long)fill);
  } else if (Rb > 0) {
    const int64_t smem = lm_tiled_probe_row_bytes(G);
    const cudaError_t err = lm::allow_dyn_smem(tiled_probe_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    LM_LAUNCH(tiled_probe_kernel, (unsigned)Rb, kThreads, (size_t)smem,
              (cudaStream_t)stream, (const long long*)resp,
              (const int64_t*)where, (const int64_t*)rows, G, (int*)lefts,
              (int*)lengths, (const uint8_t*)present, (const uint8_t*)is_fwd,
              (const int*)gen_cnt, (uint8_t*)active, side, C, seed_len,
              (long long)fill);
  }
  return (int)cudaGetLastError();
}
