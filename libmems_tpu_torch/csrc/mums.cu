// K13-K15: the multi-MUM pipeline of find_mums for any G (MemHash::
// FindMatches semantics, libMems/MemHash.cpp:109-251).
//
// K13, seed-enumeration flags, replaces libmems_tpu/matchfind.py
// _mum_seed_flags (:67-95) with the ops/segments.py run helpers it calls.
// Input: the (content, gid, pos)-sorted seed table, as the sorted content
// plus each row's genome, position and strand (K5's lm_run_starts derives
// them from the sort's source index) and the inclusive cumsum of the
// run-start flags.  A run is kept when it holds at least two genomes, no
// (content, gid) subrun is longer than repeat_tolerance + 1, it has at
// most repeat_limit rows and its content is not the masked-window
// sentinel.  No thread walks a run (the sentinel run and repeats past the
// limit can be a million rows long): run bounds are a scatter of the run
// starts to their run id, the genome count is a compare of the run's
// first and last gid (rows are gid-sorted within a run), and a subrun is
// too long exactly when some row has the row tolerance + 1 places before
// it in the same subrun, so those flags are counted over the run with a
// cumsum difference.  Kept runs are numbered by a cumsum of their start
// flags.
//
// K14, candidates, replaces _fused_mum_pipeline :355-380 and
// _packed_diagonal_words (:283-311): one thread per kept row scatters
// sign * (pos + 1) into starts[row_id, gid]; then one thread per
// candidate row applies seq_mask (bit G-1-g is genome g) and writes the
// row's packed signature words invalid(1) | mask(G) | signs(G) | G biased
// diagonals of pos_bits + 2 bits, 63 payload bits a word (MSB-first, so
// the word tuple orders like the fields), and posref (1 << 62 when
// invalid).  Every word is below 2^63: a signed int64 sort orders it.
// The mask and sign fields are streamed a bit at a time (genome G-1
// first, as the JAX package's G-bit integers place them), so a row takes
// any number of genomes: the words simply grow.
//
// K15, representatives, replaces :381-423 and _recover_starts (:314-332)
// on the sorted signature rows: the starts are rebuilt from the words, a
// row is a representative when it is valid and it is the first row, a
// word changed or posref jumped by more than seed_len; representatives
// are compacted to their cumsum rank (the JAX payload sort gives the same
// rows in the same order) as K2's [EC, G] extension rows.
//
// Bound: memory traffic.  Each pass reads a few int32/int64 columns of
// the table once, coalesced, and writes one or two; the sorts and cumsums
// between the passes stay library calls and cost more than the passes.
#include "common.cuh"

namespace {

constexpr int kThreads = lm::kTableThreads;
using lm::blocks_for;
using lm::first_index;
using lm::grid_stride;
constexpr int kWordBits = 63;

// Appends MSB-first fields to the 63-bit payload words of one row, as
// _pack_sort_words lays them out: words[w * stride] is word w.
struct WordWriter {
  int64_t* out;
  int64_t stride;
  int w = 0;
  int used = 0;  // payload bits already in `cur`
  uint64_t cur = 0;

  __device__ WordWriter(int64_t* o, int64_t s) : out(o), stride(s) {}

  // the low nb bits of val, nb <= 63
  __device__ void put(uint64_t val, int nb) {
    while (nb > 0) {
      const int take = nb < kWordBits - used ? nb : kWordBits - used;
      const uint64_t seg = (val >> (nb - take)) & (((uint64_t)1 << take) - 1);
      cur |= seg << (kWordBits - used - take);
      used += take;
      nb -= take;
      if (used == kWordBits) {
        out[(int64_t)w++ * stride] = (int64_t)cur;
        cur = 0;
        used = 0;
      }
    }
  }

  // writes the partial word and zero words up to n_words
  __device__ void finish(int n_words) {
    while (w < n_words) {
      out[(int64_t)w++ * stride] = (int64_t)cur;
      cur = 0;
    }
  }
};

// Field [start, start + nb) of row i of the word columns words[w * m + i]
// (_unpack_sort_words), nb <= 64.
__device__ uint64_t unpack_field(const int64_t* __restrict__ words, int64_t m,
                                 int64_t i, int start, int nb) {
  const int end = start + nb;
  uint64_t val = 0;
  for (int w = start / kWordBits; w * kWordBits < end; ++w) {
    const int ws = w * kWordBits, we = ws + kWordBits;
    const int lo = start > ws ? start : ws;
    const int hi = end < we ? end : we;
    if (lo >= hi) continue;
    uint64_t seg = (uint64_t)words[w * m + i] >> (we - hi);
    if (hi - lo < 64) seg &= ((uint64_t)1 << (hi - lo)) - 1;
    val |= seg << (end - hi);
  }
  return val;
}

// Signed start of genome g of sorted row i (_recover_starts): genome g's
// mask bit is field bit 1 + (G-1-g), its sign bit G places later.
__device__ __forceinline__ int recover_start(const int64_t* __restrict__ words,
                                             const int64_t* __restrict__ posref,
                                             int64_t m, int64_t i, int G,
                                             int pos_bits, int g) {
  const bool invalid = unpack_field(words, m, i, 0, 1) != 0;
  if (invalid || !unpack_field(words, m, i, G - g, 1)) return 0;
  const bool neg = unpack_field(words, m, i, 2 * G - g, 1) != 0;
  const int64_t db = (int64_t)unpack_field(words, m, i,
                                           1 + 2 * G + g * (pos_bits + 2),
                                           pos_bits + 2);
  const int64_t delta = db - ((int64_t)1 << (pos_bits + 1));
  const int64_t pos_ref = posref[i];
  const int64_t pos = neg ? delta - pos_ref : delta + pos_ref;
  return (int)(neg ? -(pos + 1) : pos + 1);
}

// K13 pass 1: run r starts at run_start[r], run_start[n_runs] = n; big
// flags the rows whose (content, gid) subrun holds the row `span` places
// before them (span = repeat_tolerance + 1).
__global__ void mum_bounds_kernel(const int64_t* __restrict__ content,
                                  const int* __restrict__ gid,
                                  const int* __restrict__ sc,
                                  const int* __restrict__ rid1, int64_t n,
                                  int span, int64_t* __restrict__ run_start,
                                  int* __restrict__ big) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    if (sc[i]) run_start[rid1[i] - 1] = i;
    if (i == n - 1) run_start[rid1[i]] = n;
    const int64_t j = i - span;
    big[i] = (j >= 0 && content[j] == content[i] && gid[j] == gid[i]) ? 1 : 0;
  }
}

// K13 pass 2: the run test, kept_occ (first row of a (content, gid)
// subrun of a kept run), ref_strand (the strand of the run's first row)
// and the kept runs' start flags.  big_cum is the inclusive cumsum of big.
__global__ void mum_keep_kernel(const int64_t* __restrict__ content,
                                const int* __restrict__ gid,
                                const unsigned char* __restrict__ strand,
                                const int* __restrict__ rid1,
                                const int64_t* __restrict__ run_start,
                                const int* __restrict__ big_cum, int64_t n,
                                int repeat_limit, int64_t sent_content,
                                unsigned char* __restrict__ kept_occ,
                                unsigned char* __restrict__ ref_strand,
                                int* __restrict__ keep_start) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    const int r = rid1[i] - 1;
    const int64_t s = run_start[r];
    const int64_t e = run_start[r + 1];
    const int big_in_run = big_cum[e - 1] - (s > 0 ? big_cum[s - 1] : 0);
    const bool keep = gid[s] != gid[e - 1] && big_in_run == 0 &&
                      e - s <= repeat_limit && content[i] != sent_content;
    const bool sub_start =
        i == 0 || content[i - 1] != content[i] || gid[i - 1] != gid[i];
    kept_occ[i] = (sub_start && keep) ? 1 : 0;
    ref_strand[i] = strand[s];
    keep_start[i] = (i == s && keep) ? 1 : 0;
  }
}

// K13 pass 3: row_id = (kept runs up to and including the row's run) - 1.
__global__ void mum_row_id_kernel(const int* __restrict__ rid1,
                                  const int64_t* __restrict__ run_start,
                                  const int* __restrict__ keep_cum, int64_t n,
                                  int* __restrict__ row_id) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    row_id[i] = keep_cum[run_start[rid1[i] - 1]] - 1;
  }
}

// K14 pass 1: the kept rows into the zeroed candidate table [n_rows, G].
__global__ void mum_scatter_kernel(const unsigned char* __restrict__ kept_occ,
                                   const int* __restrict__ row_id,
                                   const int* __restrict__ gid,
                                   const int* __restrict__ pos,
                                   const unsigned char* __restrict__ strand,
                                   const unsigned char* __restrict__ ref_strand,
                                   int64_t n, int G, int* __restrict__ starts) {
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    if (!kept_occ[i]) continue;
    const int sign = strand[i] == ref_strand[i] ? 1 : -1;
    starts[(int64_t)row_id[i] * G + gid[i]] = sign * (pos[i] + 1);
  }
}

// K14 pass 2: seq_mask (rejected rows are zeroed and invalid), then the
// signature words [n_words, n_rows] and posref of every candidate row.
__global__ void mum_words_kernel(int* __restrict__ starts, int64_t n_rows,
                                 int G, int64_t seq_mask, int pos_bits,
                                 int n_words, int64_t* __restrict__ words,
                                 int64_t* __restrict__ posref) {
  const int64_t bias = (int64_t)1 << (pos_bits + 1);
  const int dbits = pos_bits + 2;
  for (int64_t j = first_index(); j < n_rows; j += grid_stride()) {
    int* row = starts + j * G;
    bool valid = true;
    if (seq_mask) {
      for (int g = 0; g < G; ++g) {
        const bool want = (seq_mask >> (G - 1 - g)) & 1;
        if ((row[g] != 0) != want) valid = false;
      }
      if (!valid) {
        for (int g = 0; g < G; ++g) row[g] = 0;
      }
    }
    int64_t pos_ref = -1;  // the first present genome's position
    for (int g = G - 1; g >= 0; --g) {
      if (row[g] != 0) pos_ref = (int64_t)(row[g] < 0 ? -row[g] : row[g]) - 1;
    }
    WordWriter out(words + j, n_rows);
    out.put(valid ? 0 : 1, 1);
    for (int g = G - 1; g >= 0; --g) out.put(row[g] != 0, 1);
    for (int g = G - 1; g >= 0; --g) out.put(row[g] < 0, 1);
    for (int g = 0; g < G; ++g) {
      const int v = row[g];
      uint64_t db = 0;
      if (v != 0) {
        const int64_t p = (int64_t)(v < 0 ? -v : v) - 1;
        db = (uint64_t)((v < 0 ? p + pos_ref : p - pos_ref) + bias);
      }
      out.put(db, dbits);
    }
    out.finish(n_words);
    posref[j] = valid ? pos_ref : ((int64_t)1 << 62);
  }
}

// K15 pass 1: representative flags of the sorted rows.
__global__ void mum_rep_flags_kernel(const int64_t* __restrict__ words,
                                     const int64_t* __restrict__ posref,
                                     int64_t m, int G, int pos_bits,
                                     int n_words, int seed_len,
                                     int* __restrict__ rep) {
  for (int64_t i = first_index(); i < m; i += grid_stride()) {
    bool valid = false;
    for (int g = 0; g < G && !valid; ++g) {
      valid = recover_start(words, posref, m, i, G, pos_bits, g) != 0;
    }
    bool change = i == 0;
    if (!change) {
      for (int w = 0; w < n_words; ++w) {
        if (words[w * m + i] != words[w * m + i - 1]) change = true;
      }
      if (posref[i] - posref[i - 1] > seed_len) change = true;
    }
    rep[i] = (valid && change) ? 1 : 0;
  }
}

// K15 pass 2: the representative of rank r (1-based, r <= ec) becomes
// extension row r - 1; the rows were zeroed by the caller.
__global__ void mum_reps_kernel(const int64_t* __restrict__ words,
                                const int64_t* __restrict__ posref,
                                const int* __restrict__ rep,
                                const int* __restrict__ rank, int64_t m,
                                int64_t ec, int G, int pos_bits,
                                int* __restrict__ lefts,
                                unsigned char* __restrict__ present,
                                unsigned char* __restrict__ is_fwd) {
  for (int64_t i = first_index(); i < m; i += grid_stride()) {
    if (!rep[i] || rank[i] > ec) continue;
    const int64_t j = rank[i] - 1;
    for (int g = 0; g < G; ++g) {
      const int s = recover_start(words, posref, m, i, G, pos_bits, g);
      lefts[j * G + g] = s != 0 ? (s < 0 ? -s : s) - 1 : 0;
      present[j * G + g] = s != 0 ? 1 : 0;
      is_fwd[j * G + g] = s > 0 ? 1 : 0;
    }
  }
}

}  // namespace

// K13, after lm_run_starts and the cumsum of its run-start flags:
// content int64[n] sorted; gid, sc, rid1 int32[n]; run_start int64[n+1]
// and big int32[n] are outputs (scratch of the next passes).
extern "C" int lm_mum_bounds(const void* content, const void* gid,
                             const void* sc, const void* rid1, int64_t n,
                             int span, void* run_start, void* big,
                             void* stream) {
  if (n > 0) {
    LM_LAUNCH(mum_bounds_kernel, blocks_for(n), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)content, (const int*)gid,
              (const int*)sc, (const int*)rid1, n, span, (int64_t*)run_start,
              (int*)big);
  }
  return (int)cudaGetLastError();
}

// K13, after the cumsum of big: kept_occ, ref_strand uint8[n];
// keep_start int32[n] (its cumsum numbers the kept runs).
extern "C" int lm_mum_keep(const void* content, const void* gid,
                           const void* strand, const void* rid1,
                           const void* run_start, const void* big_cum,
                           int64_t n, int repeat_limit, int64_t sent_content,
                           void* kept_occ, void* ref_strand, void* keep_start,
                           void* stream) {
  if (n > 0) {
    LM_LAUNCH(mum_keep_kernel, blocks_for(n), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)content, (const int*)gid,
              (const unsigned char*)strand, (const int*)rid1,
              (const int64_t*)run_start, (const int*)big_cum, n, repeat_limit,
              sent_content, (unsigned char*)kept_occ,
              (unsigned char*)ref_strand, (int*)keep_start);
  }
  return (int)cudaGetLastError();
}

// K13, after the cumsum of keep_start: row_id int32[n].
extern "C" int lm_mum_row_ids(const void* rid1, const void* run_start,
                              const void* keep_cum, int64_t n, void* row_id,
                              void* stream) {
  if (n > 0) {
    LM_LAUNCH(mum_row_id_kernel, blocks_for(n), kThreads, 0,
              (cudaStream_t)stream, (const int*)rid1,
              (const int64_t*)run_start, (const int*)keep_cum, n,
              (int*)row_id);
  }
  return (int)cudaGetLastError();
}

// K14: the flags of K13 (n rows), starts int32[n_rows, G] zeroed by the
// caller and updated in place (seq_mask zeroes rejected rows); words
// int64[n_words, n_rows]; posref int64[n_rows].  seq_mask 0 keeps every
// row.
extern "C" int lm_mum_candidates(const void* kept_occ, const void* row_id,
                                 const void* gid, const void* pos,
                                 const void* strand, const void* ref_strand,
                                 int64_t n, int G, int64_t n_rows,
                                 int64_t seq_mask, int pos_bits, int n_words,
                                 void* starts, void* words, void* posref,
                                 void* stream) {
  if (G < 1 || pos_bits + 2 > kWordBits ||
      n_words * kWordBits < 1 + G * (pos_bits + 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    LM_LAUNCH(mum_scatter_kernel, blocks_for(n), kThreads, 0, s,
              (const unsigned char*)kept_occ, (const int*)row_id,
              (const int*)gid, (const int*)pos, (const unsigned char*)strand,
              (const unsigned char*)ref_strand, n, G, (int*)starts);
  }
  if (n_rows > 0) {
    LM_LAUNCH(mum_words_kernel, blocks_for(n_rows), kThreads, 0, s,
              (int*)starts, n_rows, G, seq_mask, pos_bits, n_words,
              (int64_t*)words, (int64_t*)posref);
  }
  return (int)cudaGetLastError();
}

// K15, before the cumsum of rep: words int64[n_words, m] and posref
// int64[m] in sorted order; rep int32[m].
extern "C" int lm_mum_rep_flags(const void* words, const void* posref,
                                int64_t m, int G, int pos_bits, int n_words,
                                int seed_len, void* rep, void* stream) {
  if (m > 0) {
    LM_LAUNCH(mum_rep_flags_kernel, blocks_for(m), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)words,
              (const int64_t*)posref, m, G, pos_bits, n_words, seed_len,
              (int*)rep);
  }
  return (int)cudaGetLastError();
}

// K15, after the cumsum: rank int32[m]; lefts int32[ec, G] and present,
// is_fwd uint8[ec, G], zeroed by the caller.
extern "C" int lm_mum_reps(const void* words, const void* posref,
                           const void* rep, const void* rank, int64_t m,
                           int64_t ec, int G, int pos_bits, void* lefts,
                           void* present, void* is_fwd, void* stream) {
  if (m > 0 && ec > 0) {
    LM_LAUNCH(mum_reps_kernel, blocks_for(m), kThreads, 0,
              (cudaStream_t)stream, (const int64_t*)words,
              (const int64_t*)posref, (const int*)rep, (const int*)rank, m,
              ec, G, pos_bits, (int*)lefts, (unsigned char*)present,
              (unsigned char*)is_fwd);
  }
  return (int)cudaGetLastError();
}
