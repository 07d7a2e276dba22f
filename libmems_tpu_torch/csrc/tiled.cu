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
// K29 (lm_tiled_requests): each request's span start in the padded
// global space (ops/extend.py:235-239), its owner clip(floor(start / S),
// 0, n_dev - 1) and its slot, the rank among the requests to that owner
// in (row, genome) order, in one pass.  Bound: bytes (the rows' state
// read, the send buffer, `where` and the tally written).  The parent ran
// two passes around a library cumsum of per-tile counts and read the
// counts to the host between them and again after, per shard: two
// stream syncs a shard a fetch.  Here a block takes a tile of kReqTile
// requests by ticket, computes each request's owner and tile-local start
// once (the owner from a reciprocal of S and one correction each way, no
// 64-bit division), ranks them within the tile with __match_any_sync and
// the warps' counts, and takes each owner's base from the earlier tiles
// by a decoupled look-back over the n_dev per-owner counts
// (csrc/scan.cuh, a warp an owner), so no pass waits on the host.  As
// each owner's base is known before the totals of all owners, the send
// buffer is owner-major, [n_dev, cap] with cap = min(req_cap, Rb * G)
// (the JAX fetch's [n_dev, req_cap] buffer, bounded by the block's
// requests); `where` holds (owner << 32) | slot.  The last tile writes
// the tally: each owner's count (clamped to req_cap), the exclusive
// offsets of those counts (where each owner's answer starts in the
// concatenated answer, which K31 reads) and the requests past req_cap,
// so one read of the tally a fetch serves the exchange, the owners'
// answers and the retry.

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
#include "scan.cuh"

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

// K29's tile: kReqItems requests a thread, warp w of a tile owning
// kReqWarpSpan consecutive requests, item j of lane l the request base +
// 32 j + l (coalesced loads, one __match_any_sync a load, item order).
constexpr int kReqItems = 8;
constexpr int kReqWarpSpan = 32 * kReqItems;
constexpr int kReqTile = kThreads * kReqItems;

// Owner of request i = (row rows[i / G], genome i % G) and its tile-local
// span start; owner -1 where the genome is absent from the row.  inv_S =
// 1 / S rounded: the owner's estimate is off by at most one either way
// for |start| below 2^52, and the corrections make it exact.
struct Request {
  int owner;
  int64_t local;
};

__device__ __forceinline__ Request request_of(
    unsigned i, int G, const int64_t* rows, const int* lefts,
    const int* lengths, const uint8_t* present, const uint8_t* is_fwd,
    const int* gen_off, int side, int C, int seed_len, int64_t big,
    int64_t S, double inv_S, int n_dev) {
  const unsigned q = i / (unsigned)G;
  const int g = (int)(i - q * (unsigned)G);
  const int64_t r = rows[q];
  const int64_t k = r * G + g;
  Request out{-1, 0};
  if (!present[k]) return out;
  const bool back = side == 0 ? is_fwd[k] != 0 : is_fwd[k] == 0;
  const int64_t l = lefts[k];
  const int64_t start =
      (back ? l - C : l + lengths[r] - seed_len + 1) + gen_off[g] + big;
  int64_t o = (int64_t)floor((double)start * inv_S);
  if (o * S > start) --o;
  if ((o + 1) * S <= start) ++o;
  o = o < 0 ? 0 : (o > n_dev - 1 ? n_dev - 1 : o);
  out.owner = (int)o;
  out.local = start - o * S;
  return out;
}

// K29: a tile of kReqTile requests a block.  Dynamic shared memory:
// int64 base[n_dev] (the tile's first slot for each owner) and int
// count[kWarps][n_dev] (each warp's requests to each owner).  scratch:
// lm::kScanHeader + tiles * n_dev words, zeroed before the launch (the
// ticket, then a status word a (tile, owner)).  tally: int64[2 n_dev +
// 1], written by the last tile: min(total_o, req_cap) for each owner o,
// their exclusive prefix, and the requests past req_cap.
__global__ void __launch_bounds__(kThreads) tiled_requests_kernel(
    unsigned n, int G, const int64_t* __restrict__ rows,
    const int* __restrict__ lefts, const int* __restrict__ lengths,
    const uint8_t* __restrict__ present, const uint8_t* __restrict__ is_fwd,
    const int* __restrict__ gen_off, int side, int C, int seed_len,
    int64_t big, int64_t S, double inv_S, int n_dev, int64_t req_cap,
    int64_t cap, int64_t* __restrict__ send, int64_t* __restrict__ where,
    unsigned long long* __restrict__ scratch, int64_t* __restrict__ tally) {
  extern __shared__ int64_t s_base[];
  int* s_cnt = reinterpret_cast<int*>(s_base + n_dev);  // [kWarps][n_dev]
  for (int k = threadIdx.x; k < kWarps * n_dev; k += kThreads) s_cnt[k] = 0;
  // the ticket's barrier also publishes the zeroed counts
  const int64_t tile = lm::take_tile(scratch);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* cnt = s_cnt + warp * n_dev;
  const int64_t first = tile * kReqTile + (int64_t)warp * kReqWarpSpan + lane;
  int owner[kReqItems];
  int64_t local[kReqItems];
  int rank[kReqItems];
  // every item's loads first, all in flight together
#pragma unroll
  for (int j = 0; j < kReqItems; ++j) {
    const int64_t i = first + 32 * j;
    Request q{-1, 0};
    if (i < n) {
      q = request_of((unsigned)i, G, rows, lefts, lengths, present, is_fwd,
                     gen_off, side, C, seed_len, big, S, inv_S, n_dev);
    }
    owner[j] = q.owner;
    local[j] = q.local;
  }
  // the rank among this warp's requests to the owner so far: its earlier
  // loads' count, then the lanes below in this one
#pragma unroll
  for (int j = 0; j < kReqItems; ++j) {
    const int o = owner[j];
    const unsigned same = __match_any_sync(lm_chain::kFull, o);
    const int below = __popc(same & lm::lanes_below());
    rank[j] = (o >= 0 ? cnt[o] : 0) + below;
    __syncwarp();
    if (o >= 0 && below == 0) cnt[o] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  // each owner's base from the earlier tiles, a warp an owner
  const int64_t tiles = ((int64_t)n + kReqTile - 1) / kReqTile;
  for (int o = warp; o < n_dev; o += kWarps) {
    unsigned long long own = 0;
    for (int w = 0; w < kWarps; ++w) own += s_cnt[w * n_dev + o];
    const unsigned long long excl =
        lm::tile_lookback(scratch, tile, own, n_dev, o);
    if (lane == 0) {
      s_base[o] = (int64_t)excl;
      if (tile == tiles - 1) tally[o] = (int64_t)(excl + own);
    }
  }
  __syncthreads();
  if (tile == tiles - 1 && threadIdx.x == 0) {
    int64_t off = 0, over = 0;
    for (int o = 0; o < n_dev; ++o) {
      const int64_t total = tally[o];
      const int64_t sent = total < req_cap ? total : req_cap;
      tally[o] = sent;
      tally[n_dev + o] = off;
      off += sent;
      over += total - sent;
    }
    tally[2 * n_dev] = over;
  }
#pragma unroll
  for (int j = 0; j < kReqItems; ++j) {
    const int64_t i = first + 32 * j;
    if (i >= n) break;
    const int o = owner[j];
    int64_t w = -1;
    if (o >= 0) {
      int64_t slot = s_base[o] + rank[j];
      for (int v = 0; v < warp; ++v) slot += s_cnt[v * n_dev + o];
      if (slot < req_cap) {
        send[o * cap + slot] = local[j];
        w = ((int64_t)o << 32) | slot;
      }
    }
    where[i] = w;
  }
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

// A request's row of resp: resp_off[owner] + slot of w = (owner << 32) |
// slot (K29's layout); -1 stays -1.
__device__ __forceinline__ int64_t answer_row(int64_t w,
                                              const int64_t* resp_off) {
  if (w < 0) return w;
  return resp_off[w >> 32] + (w & 0xffffffffll);
}

// A probe key from a fetched span: genome g's span of the block row b.
struct SpanFetch {
  const long long* resp;
  const int64_t* where;  // the row's [G] requests, -1: none
  const int64_t* resp_off;
  int C;
  long long fill;
  __device__ long long operator()(int g, int, int d, bool back) const {
    const int64_t w = answer_row(where[g], resp_off);
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
    const int64_t* __restrict__ resp_off, const int64_t* __restrict__ rows,
    int64_t Rb, int G,
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
    wh = answer_row(where[b * G + lane], resp_off);
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
    const int64_t* __restrict__ resp_off, const int64_t* __restrict__ rows,
    int G, int* __restrict__ lefts,
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
      fill, SpanFetch{resp, where + (int64_t)b * G, resp_off, C, fill});
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

// int64 words of K29's scratch for Rb * G = n requests to n_dev owners.
extern "C" int64_t lm_tiled_request_scratch_words(int64_t n, int n_dev) {
  return lm::kScanHeader + (n + kReqTile - 1) / kReqTile * n_dev;
}

// K29.  rows: int64[Rb] rows of the block (into lefts etc.); lefts:
// int32[R, G]; lengths: int32[R]; present, is_fwd: uint8[R, G]; gen_off:
// int32[G]; send: int64[n_dev, cap], cap = min(req_cap, Rb * G), owner
// o's first tally[o] entries written; where: int64[Rb, G], (owner << 32)
// | slot, -1 for an absent genome or a request past req_cap; scratch:
// int64[lm_tiled_request_scratch_words(Rb * G, n_dev)], zeroed here;
// tally: int64[2 n_dev + 1] (counts, their exclusive offsets, the
// requests past req_cap).  Rb * G below 2^31, Rb > 0.
extern "C" int lm_tiled_requests(const void* rows, int64_t Rb, int G,
                                 const void* lefts, const void* lengths,
                                 const void* present, const void* is_fwd,
                                 const void* gen_off, int side, int C,
                                 int seed_len, int64_t big, int64_t S,
                                 int n_dev, int64_t req_cap, int64_t cap,
                                 void* send, void* where, void* scratch,
                                 void* tally, void* stream) {
  const int64_t n = Rb * G;
  if (G < 1 || n_dev < 1 || S < 1 || n < 1 || n > INT_MAX || req_cap < 0 ||
      cap < (n < req_cap ? n : req_cap)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)n_dev * (sizeof(int64_t) + kWarps * sizeof(int));
  cudaError_t err = cudaSuccess;
  // past the 48 KB a block takes without asking (n_dev above 1,200)
  if (smem > 48 * 1024) err = lm::allow_dyn_smem(tiled_requests_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(
      scratch, 0,
      (size_t)lm_tiled_request_scratch_words(n, n_dev) * sizeof(int64_t),
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  LM_LAUNCH(tiled_requests_kernel, (unsigned)((n + kReqTile - 1) / kReqTile),
            kThreads, smem, (cudaStream_t)stream, (unsigned)n, G,
            (const int64_t*)rows, (const int*)lefts, (const int*)lengths,
            (const uint8_t*)present, (const uint8_t*)is_fwd,
            (const int*)gen_off, side, C, seed_len, big, S, 1.0 / (double)S,
            n_dev, req_cap, cap, (int64_t*)send, (int64_t*)where,
            (unsigned long long*)scratch, (int64_t*)tally);
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

// K31.  resp: int64[n_resp, C]; where: int64[Rb, G], a request's row of
// resp resp_off[where >> 32] + (where & 0xffffffff) (K29's layout), -1
// for none; resp_off: int64[n_dev]; rows: int64[Rb];
// lefts: int32[R, G], lengths: int32[R], active: uint8[R] updated in
// place for the block's rows; present, is_fwd: uint8[R, G]; gen_cnt:
// int32[G].  C <= 32 * 256.  Rows of at most lm_extend_warp_genomes()
// genomes take the warp route, wider rows the block route (row state in
// shared memory, at most lm_tiled_probe_smem_limit() bytes).
extern "C" int lm_tiled_probe(const void* resp, const void* where,
                              const void* resp_off, const void* rows,
                              int64_t Rb, int G,
                              void* lefts, void* lengths, const void* present,
                              const void* is_fwd, const void* gen_cnt,
                              void* active, int side, int C, int seed_len,
                              int64_t fill, void* stream) {
  if (G < 1 || C < 1 || C > 32 * kThreads) return (int)cudaErrorInvalidValue;
  if (Rb > 0 && G <= kWarpGenomes) {
    LM_LAUNCH(tiled_probe_warp_kernel,
              (unsigned)((Rb + kRowWarps - 1) / kRowWarps), kThreads, 0,
              (cudaStream_t)stream, (const long long*)resp,
              (const int64_t*)where, (const int64_t*)resp_off,
              (const int64_t*)rows, Rb, G, (int*)lefts,
              (int*)lengths, (const uint8_t*)present, (const uint8_t*)is_fwd,
              (const int*)gen_cnt, (uint8_t*)active, side, C, seed_len,
              (long long)fill);
  } else if (Rb > 0) {
    const int64_t smem = lm_tiled_probe_row_bytes(G);
    const cudaError_t err = lm::allow_dyn_smem(tiled_probe_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    LM_LAUNCH(tiled_probe_kernel, (unsigned)Rb, kThreads, (size_t)smem,
              (cudaStream_t)stream, (const long long*)resp,
              (const int64_t*)where, (const int64_t*)resp_off,
              (const int64_t*)rows, G, (int*)lefts,
              (int*)lengths, (const uint8_t*)present, (const uint8_t*)is_fwd,
              (const int*)gen_cnt, (uint8_t*)active, side, C, seed_len,
              (long long)fill);
  }
  return (int)cudaGetLastError();
}
