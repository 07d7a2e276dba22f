"""The pairwise seeder's table passes (kernels K5-K7, csrc/pairwise.cu).

Port of the device stages of libmems_tpu/matchfind.py's
_fused_pairwise_pipeline / _pairwise_core and of the ops/segments.py run
helpers they use (PairwiseMatchFinder::EnumerateMatches,
libMems/PairwiseMatchFinder.cpp:37-71):

* ``run_flags`` (K5): per row of the (content, gid, pos)-sorted seed
  table its genome, position, strand, run id and the unique-occurrence
  flag ``(subrun_len == 1) & (runlen <= repeat_limit) & not_sent``
  (``_unique_occ_flags``; gid and pos replace ``_padded_table_meta``), in
  two launches over tiles of RUN_TILE rows: the tiles' run summaries
  (``_summaries``, shared with K13), then the flags (``_flag_pass``), each
  with a plain version (``run_summaries_plain``,
  ``run_flags_from_summaries_plain``) that compose to ``run_flags_plain``;
* ``cluster_words`` (K6): the kept rows' G-1 shifted compares as packed
  cluster words ``fwd | pair_id | delta | posA`` (-1 where invalid);
* ``rep_index`` then ``decode_reps`` (K7): the diagonal-cluster
  representatives of the sorted words, found in one scan, then decoded
  into compact [EC, 2] extension rows for K2 at a capacity EC chosen from
  their count; ``cluster_reps`` is the two in one call.

64-bit words are int64 tensors holding unsigned patterns (right shifts
mask the sign fill, sorts flip bit 63); -1 is the all-ones sentinel.
Each wrapper takes its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libmems_tpu_torch import cuda

_I64_MIN = -(1 << 63)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of 64-bit patterns held in int64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def usort(x: torch.Tensor) -> torch.Tensor:
    """Sort 64-bit patterns held in int64 in unsigned order."""
    return torch.sort(x ^ _I64_MIN).values ^ _I64_MIN


def cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


class RunFlags(NamedTuple):
    unique_occ: torch.Tensor   # bool[n]
    run_id: torch.Tensor       # int32[n]
    gid: torch.Tensor          # int32[n]
    pos: torch.Tensor          # int32[n]
    strand: torch.Tensor       # uint8[n]


def seed_table_meta(src, keys, seg_off, row_keys: bool = False):
    """Genome, position and strand of each sorted row from its source
    index into keys (the position-order concatenation; seg_off int64[G+1]
    the genome bounds).  With row_keys, keys are the rows' own keys
    (int64[n]) and give the strand row by row."""
    gid = torch.searchsorted(seg_off, src, right=True) - 1
    pos = (src - seg_off[gid]).to(torch.int32)
    strand = ((keys if row_keys else keys[src]) & 1).to(torch.uint8)
    return gid.to(torch.int32), pos, strand


def run_flags_plain(content, src, keys, seg_off, repeat_limit: int,
                    sent_content: int) -> RunFlags:
    """Plain PyTorch version of K5."""
    n = content.shape[0]
    dev = content.device
    gid, pos, strand = seed_table_meta(src, keys, seg_off)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    sc = torch.cat([one, content[1:] != content[:-1]])
    scg = sc | torch.cat([one, gid[1:] != gid[:-1]])
    rid1 = cumsum32(sc)
    starts = torch.nonzero(sc).flatten()
    bounds = torch.cat([starts, torch.full((1,), n, dtype=starts.dtype,
                                           device=dev)])
    r = (rid1 - 1).to(torch.int64)
    runlen = bounds[r + 1] - bounds[r]
    sub1 = scg & torch.cat([scg[1:], one])
    unique_occ = sub1 & (runlen <= repeat_limit) & (content != sent_content)
    return RunFlags(unique_occ, (rid1 - 1).to(torch.int32), gid, pos, strand)


# rows a tile of K5's and K13's launches (lm::kRunTile, csrc/runs.cuh);
# words of their scratch before the tiles' look-back status words
# (lm::kScanHeader, csrc/scan.cuh)
RUN_TILE = 4096
SCAN_HEADER = 4


def run_tiles(n: int) -> int:
    """Tiles of K5's and K13's launches over n sorted rows."""
    return -(-n // RUN_TILE)


def _tile_view(x: torch.Tensor, fill) -> torch.Tensor:
    """x[n] as [tiles, RUN_TILE], the last tile padded with fill."""
    tiles = run_tiles(x.shape[0])
    return torch.nn.functional.pad(
        x, (0, tiles * RUN_TILE - x.shape[0]), value=fill).view(
            tiles, RUN_TILE)


def run_starts(*cols: torch.Tensor) -> torch.Tensor:
    """bool[n]: row i starts a run (row 0, or a column differs from the
    row before)."""
    n = cols[0].shape[0]
    flag = torch.zeros(n, dtype=torch.bool, device=cols[0].device)
    flag[:1] = True
    for c in cols:
        flag[1:] |= c[1:] != c[:-1]
    return flag


def big_rows(content, gid, span: int) -> torch.Tensor:
    """bool[n]: row i - span lies in row i's (content, genome) subrun (K13's
    test of a subrun longer than span = repeat_tolerance + 1); every row
    where span <= 0."""
    n = content.shape[0]
    if span <= 0:
        return torch.ones(n, dtype=torch.bool, device=content.device)
    big = torch.zeros(n, dtype=torch.bool, device=content.device)
    if span < n:
        big[span:] = (content[span:] == content[:-span]) \
            & (gid[span:] == gid[:-span])
    return big


def run_summaries_plain(content, src, seg_off, span: int | None = None
                        ) -> torch.Tensor:
    """Plain version of K5's and K13's first launch: int64[2 * tiles], each
    tile's first run start * 2 + (a big row lies before it), then its last
    * 2 + (one lies at or after it); -2 + (one lies in the tile) where it
    holds no start.  span None flags no row (K5); else big_rows(span)."""
    n = content.shape[0]
    dev = content.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    sc = run_starts(content)
    first = _tile_view(torch.where(sc, idx, n), n).amin(1)
    first = torch.where(first == n, -1, first)
    last = _tile_view(torch.where(sc, idx, -1), -1).amax(1)
    if span is None:
        flag_first = flag_last = torch.zeros_like(first)
    else:
        gid = torch.searchsorted(seg_off, src, right=True) - 1
        big = _tile_view(big_rows(content, gid, span), False)
        rows = _tile_view(idx, n)
        before = torch.where(first < 0, n, first)
        flag_first = (big & (rows < before[:, None])).any(1).long()
        flag_last = (big & (rows >= last[:, None])).any(1).long()
    return torch.cat([first * 2 + flag_first, last * 2 + flag_last])


class TileRuns(NamedTuple):
    """Each row's run bounds as the row pass finds them: in its tile, and
    across the tile's edges from the summaries."""
    start: torch.Tensor      # int64[n] the row's run's first row
    end: torch.Tensor        # int64[n] one past its last row
    flag_in: torch.Tensor    # bool[tiles] a flagged row of the run across
                             # the tile's left edge lies before the tile
    flag_out: torch.Tensor   # bool[tiles] ... across its right edge, after


def tile_runs_plain(sc, words) -> TileRuns:
    """The run bounds of the rows whose run-start flags are sc (bool[n]),
    from their tiles and the summary words (run_summaries_plain): a run
    across a tile's left edge starts at the last start of the nearest
    earlier tile with one, a run across its right edge ends at the first
    start of the nearest later tile with one, or n; the flags of the
    tiles passed on the way, and of the one reached, OR-ed."""
    n = sc.shape[0]
    dev = sc.device
    tiles = run_tiles(n)
    first, last = words[:tiles] >> 1, words[tiles:] >> 1
    f_first, f_last = words[:tiles] & 1, words[tiles:] & 1
    k = torch.arange(tiles, device=dev)
    none = torch.full((1,), -1, dtype=torch.int64, device=dev)
    # left: the nearest earlier tile holding a start, its flags to t - 1
    at = torch.cummax(torch.where(last >= 0, k, -1), 0).values
    left = torch.cat([none, at[:-1]])
    left_start = torch.where(left >= 0, last[left.clamp(min=0)], -1)
    c_last = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(f_last, 0)])
    flag_in = c_last[k] - c_last[left.clamp(min=0)] > 0
    # right: the nearest later one, its flags from t + 1
    nxt = torch.cummin(torch.where(first >= 0, k, tiles).flip(0),
                       0).values.flip(0)
    right = torch.cat([nxt[1:], torch.full((1,), tiles, device=dev)])
    right_end = torch.where(right < tiles, first[right.clamp(max=tiles - 1)],
                            n)
    c_first = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(f_first, 0)])
    flag_out = c_first[right.clamp(max=tiles - 1) + 1] - c_first[k + 1] > 0
    idx = torch.arange(n, device=dev)
    start = torch.cummax(_tile_view(torch.where(sc, idx, -1), -1),
                         1).values
    start = torch.where(start < 0, left_start[:, None], start)
    after = torch.cummin(_tile_view(torch.where(sc, idx, n), n).flip(1),
                         1).values.flip(1)
    end = torch.cat([after[:, 1:], torch.full((tiles, 1), n, device=dev)],
                    1)
    end = torch.where(end == n, right_end[:, None], end)
    return TileRuns(start.flatten()[:n], end.flatten()[:n], flag_in,
                    flag_out)


def tile_ranks_plain(flags) -> torch.Tensor:
    """int32[n]: the set flags of the earlier tiles (the look-back) + the
    set flags at or before each row in its tile - 1."""
    t = _tile_view(flags.to(torch.int64), 0)
    counts = t.sum(1)
    excl = torch.cumsum(counts, 0) - counts
    rank = excl[:, None] + torch.cumsum(t, 1) - 1
    return rank.flatten()[:flags.shape[0]].to(torch.int32)


def run_flags_from_summaries_plain(content, src, keys, seg_off, words,
                                   repeat_limit: int,
                                   sent_content: int) -> RunFlags:
    """Plain version of K5's second launch: run_flags_plain's flags, each
    run's bounds found in its row's tile and, across the tile's edges,
    from the summary words (run_summaries_plain)."""
    n = content.shape[0]
    gid, pos, strand = seed_table_meta(src, keys, seg_off)
    if n == 0:
        return RunFlags(torch.zeros(0, dtype=torch.bool,
                                    device=content.device),
                        gid.clone(), gid, pos, strand)
    sc = run_starts(content)
    scg = run_starts(content, gid)
    b = tile_runs_plain(sc, words)
    one = torch.ones(1, dtype=torch.bool, device=content.device)
    single = scg & torch.cat([scg[1:], one])
    unique_occ = single & (b.end - b.start <= repeat_limit) \
        & (content != sent_content)
    return RunFlags(unique_occ, tile_ranks_plain(sc), gid, pos, strand)


def run_scratch(n: int, dev) -> torch.Tensor:
    """Scratch of K5's and K13's launches over n rows, unfilled (launch 1
    zeroes what launch 2 needs zeroed): the look-back's header and status
    words, then the tiles' summary words (run_summary_words)."""
    return torch.empty(cuda.library().lm_run_scratch_words(n),
                       dtype=torch.int64, device=dev)


def run_summary_words(scratch: torch.Tensor, n: int) -> torch.Tensor:
    """The summary words of a run_scratch over n rows (launch 1's output,
    laid out as run_summaries_plain's)."""
    return scratch[SCAN_HEADER + run_tiles(n):]


def _summaries(content, src, seg_off, span: int | None, scratch) -> None:
    """K5's and K13's first launch: the tile summaries of the sorted table
    into scratch (run_scratch), K13's big rows flagged where span is not
    None; the look-back words of the second launch zeroed."""
    n = content.shape[0]
    cuda.check(cuda.library().lm_run_summaries(
        content.data_ptr(), src.data_ptr(), seg_off.data_ptr(),
        seg_off.shape[0] - 1, n, int(span is not None), span or 0,
        scratch.data_ptr(), cuda.stream(content)), "lm_run_summaries")


def _flag_pass(content, src, keys, seg_off, repeat_limit: int,
               sent_content: int, scratch, out: RunFlags) -> None:
    """K5's second launch into out's tensors, after _summaries (or with
    scratch's look-back words zeroed and its summary words filled)."""
    cuda.check(cuda.library().lm_run_tile_flags(
        content.data_ptr(), src.data_ptr(), keys.data_ptr(),
        seg_off.data_ptr(), seg_off.shape[0] - 1, content.shape[0],
        repeat_limit, sent_content, scratch.data_ptr(),
        out.unique_occ.data_ptr(), out.run_id.data_ptr(),
        out.gid.data_ptr(), out.pos.data_ptr(), out.strand.data_ptr(),
        cuda.stream(content)), "lm_run_tile_flags")


@cuda.launcher
def run_flags(content, src, keys, seg_off, repeat_limit: int,
              sent_content: int) -> RunFlags:
    """Run flags of the sorted seed table.

    content: int64[n] sorted contents (key >> 1); src: int64[n] each
    row's index into keys, the int64 position-order concatenation of the
    genomes' keys; seg_off: int64[G+1] genome bounds in keys.  CPU
    tensors take the plain version; CUDA tensors launch K5: the tile
    summaries, then the flags."""
    if content.device.type == "cpu":
        return run_flags_plain(content, src, keys, seg_off, repeat_limit,
                               sent_content)
    dev = content.device
    n = content.shape[0]
    G = seg_off.shape[0] - 1
    cuda.require(content, "content", torch.int64, dev, (n,))
    cuda.require(src, "src", torch.int64, dev, (n,))
    cuda.require(keys, "keys", torch.int64, dev, (keys.shape[0],))
    cuda.require(seg_off, "seg_off", torch.int64, dev, (G + 1,))
    i32 = dict(dtype=torch.int32, device=dev)
    out = RunFlags(torch.empty(n, dtype=torch.bool, device=dev),
                   torch.empty(n, **i32), torch.empty(n, **i32),
                   torch.empty(n, **i32),
                   torch.empty(n, dtype=torch.uint8, device=dev))
    if n:
        scratch = run_scratch(n, dev)
        _summaries(content, src, seg_off, None, scratch)
        _flag_pass(content, src, keys, seg_off, repeat_limit, sent_content,
                   scratch, out)
        run_flags.launches += 1
    return out


run_flags.launches = 0


# K6's records hold a genome id in 6 bits (the word budget's G <= 62)
MAX_GENOMES = 62


def gid_bits_for(G: int) -> int:
    """Bits of a genome id in K6's records: ceil(log2(G-1))."""
    return max(G - 1, 1).bit_length()


def pair_bits_for(G: int) -> int:
    """Bits of the pair id field: 2 * ceil(log2(G-1)) as the JAX word."""
    return 2 * gid_bits_for(G)


def cluster_words_plain(flags: RunFlags, G: int, pos_bits: int
                        ) -> torch.Tensor:
    """Plain PyTorch version of K6."""
    keep = flags.unique_occ
    rid = flags.run_id[keep].to(torch.int64)
    gid = flags.gid[keep].to(torch.int64)
    pos = flags.pos[keep].to(torch.int64)
    st = flags.strand[keep]
    kept = rid.shape[0]
    pair_bits = pair_bits_for(G)
    bias = 1 << pos_bits
    out = []
    for s in range(1, G):
        n_ok = max(kept - s, 0)
        w = torch.full((kept,), -1, dtype=torch.int64, device=rid.device)
        a = slice(0, n_ok)
        b = slice(s, s + n_ok)
        fwd = st[a] == st[b]
        pair = gid[a] * G + gid[b]
        delta = torch.where(fwd, pos[b] - pos[a] + bias, pos[b] + pos[a])
        word = (fwd.to(torch.int64) << (pair_bits + 2 * pos_bits + 2)) \
            | (pair << (2 * pos_bits + 2)) | (delta << pos_bits) | pos[a]
        w[:n_ok] = torch.where(rid[a] == rid[b], word, -1)
        out.append(w)
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=rid.device)
    return torch.cat(out)


def scan_scratch(n: int, dev) -> torch.Tensor:
    """Scratch of a compacting scan over n items (csrc/scan.cuh), unfilled:
    its launcher zeroes it."""
    return torch.empty(cuda.library().lm_scan_scratch_words(n),
                       dtype=torch.int64, device=dev)


def scan_tiles(n: int) -> int:
    """Tiles (blocks) of a compacting scan over n items."""
    lib = cuda.library()
    return lib.lm_scan_scratch_words(n) - lib.lm_scan_scratch_words(0)


def _compact_kept(flags: RunFlags, pos_bits: int, gid_bits: int, rec,
                  scratch) -> torch.Tensor:
    """K6's compaction pass: the kept rows' records into rec's first
    entries; returns their count (int64 on the card)."""
    keep = flags.unique_occ
    cuda.check(cuda.library().lm_compact_kept(
        keep.data_ptr(), flags.run_id.data_ptr(), flags.gid.data_ptr(),
        flags.pos.data_ptr(), flags.strand.data_ptr(), keep.shape[0],
        pos_bits, gid_bits, rec.data_ptr(), scratch.data_ptr(),
        cuda.stream(keep)), "lm_compact_kept")
    return scratch[1]


def _word_pass(rec, kept: int, G: int, pos_bits: int, gid_bits: int,
               out) -> None:
    """K6's word pass: the (G-1) * kept words of rec's first kept
    records into out."""
    cuda.check(cuda.library().lm_cluster_words(
        rec.data_ptr(), kept, G, pos_bits, gid_bits, pair_bits_for(G),
        out.data_ptr(), cuda.stream(rec)), "lm_cluster_words")


@cuda.launcher
def cluster_words(flags: RunFlags, G: int, pos_bits: int) -> torch.Tensor:
    """Unsorted cluster words int64[(G-1) * kept_count]: the word of
    shift s and kept row k pairs k with kept row k+s of the same run.
    CPU tensors take the plain version; CUDA tensors launch K6: the kept
    rows' records compacted in one pass, one host read of their count,
    then the words."""
    keep = flags.unique_occ
    if keep.device.type == "cpu":
        return cluster_words_plain(flags, G, pos_bits)
    dev = keep.device
    n = keep.shape[0]
    for name, t, dt in (("unique_occ", keep, torch.bool),
                        ("run_id", flags.run_id, torch.int32),
                        ("gid", flags.gid, torch.int32),
                        ("pos", flags.pos, torch.int32),
                        ("strand", flags.strand, torch.uint8)):
        cuda.require(t, name, dt, dev, (n,))
    gid_bits = gid_bits_for(G)
    if G > MAX_GENOMES or pos_bits + gid_bits + 1 > 32:
        raise ValueError(f"K6 records hold G <= {MAX_GENOMES} genomes and "
                         f"pos_bits + gid_bits + 1 <= 32 bits (G={G}, "
                         f"pos_bits={pos_bits})")
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    rec = torch.empty(n, dtype=torch.int64, device=dev)
    scratch = scan_scratch(n, dev)
    # the one host read: the words' count
    kept = int(_compact_kept(flags, pos_bits, gid_bits, rec, scratch))
    out = torch.empty(kept * (G - 1), dtype=torch.int64, device=dev)
    _word_pass(rec, kept, G, pos_bits, gid_bits, out)
    cluster_words.launches += 1
    return out


cluster_words.launches = 0


class Reps(NamedTuple):
    lefts: torch.Tensor      # int32[EC, 2]
    present: torch.Tensor    # bool[EC, 2]
    is_fwd: torch.Tensor     # bool[EC, 2]
    gen_off: torch.Tensor    # int32[EC, 2]
    gen_cnt: torch.Tensor    # int32[EC, 2]
    lengths0: torch.Tensor   # int32[EC]
    r_a: torch.Tensor        # int32[EC] genome of column 0
    r_b: torch.Tensor        # int32[EC] genome of column 1
    n_reps: int


class RepIndex(NamedTuple):
    index: torch.Tensor      # int32: entries [0, n_reps) the reps' words
    counts: torch.Tensor     # int64[2]: n_cands (valid words), n_reps
    n_reps: int


def rep_index_plain(cw, pos_bits: int, seed_len: int) -> RepIndex:
    """Plain PyTorch version of K7's scan (matchfind.py:1163-1178)."""
    valid = cw != -1
    s_pos = cw & ((1 << pos_bits) - 1)
    head = shr(cw, pos_bits)
    prev_head = torch.cat([torch.full((1,), -1, dtype=cw.dtype,
                                      device=cw.device), head[:-1]])
    prev_pos = torch.cat([torch.zeros(1, dtype=cw.dtype, device=cw.device),
                          s_pos[:-1]])
    rep = valid & ((head != prev_head) | (s_pos - prev_pos > seed_len))
    index = torch.nonzero(rep).flatten().to(torch.int32)
    counts = torch.stack([valid.sum(), rep.sum()]).to(torch.int64)
    return RepIndex(index, counts, index.shape[0])


def rep_capacity(ec0: int, n_reps: int) -> int:
    """The extension capacity of a call whose first guess is ec0: ec0
    where the n_reps representatives fit, else the next power of two
    above their count (the last capacity of the JAX package's growing
    loop), so the representatives are found once a call."""
    return ec0 if n_reps <= ec0 else 1 << (n_reps - 1).bit_length()


def _rep_scan(cw, pos_bits: int, seed_len: int, index, scratch
              ) -> torch.Tensor:
    """K7's scan: the reps' word indices into index's first entries;
    returns (n_cands, n_reps) as int64[2] on the card."""
    cuda.check(cuda.library().lm_rep_index(
        cw.data_ptr(), cw.shape[0], pos_bits, seed_len, index.data_ptr(),
        scratch.data_ptr(), cuda.stream(cw)), "lm_rep_index")
    return scratch[1:3]


@cuda.launcher
def rep_index(cw, pos_bits: int, seed_len: int) -> RepIndex:
    """The representatives of the sorted cluster words: their word
    indices in order, the valid-word and rep counts (on cw's device),
    and n_reps read to the host.

    cw: int64[m] cluster words in unsigned order (-1 last).  CPU tensors
    take the plain version; CUDA tensors launch K7's scan."""
    if cw.device.type == "cpu":
        return rep_index_plain(cw, pos_bits, seed_len)
    dev = cw.device
    m = cw.shape[0]
    cuda.require(cw, "cw", torch.int64, dev, (m,))
    if m >= 1 << 31:
        raise ValueError(f"K7 indexes words with int32: {m} words")
    if m == 0:
        return RepIndex(torch.zeros(0, dtype=torch.int32, device=dev),
                        torch.zeros(2, dtype=torch.int64, device=dev), 0)
    index = torch.empty(m, dtype=torch.int32, device=dev)
    scratch = scan_scratch(m, dev)
    counts = _rep_scan(cw, pos_bits, seed_len, index, scratch)
    rep_index.launches += 1
    return RepIndex(index, counts, int(counts[1]))


rep_index.launches = 0


def decode_reps_plain(cw, idx: RepIndex, ec: int, G: int, pos_bits: int,
                      seed_len: int, gen_off, gen_cnt) -> Reps:
    """Plain PyTorch version of K7's decode (matchfind.py:1180-1215):
    the reps at word indices src, each cluster ending before word nxt,
    in EC slots."""
    src = idx.index[:min(idx.n_reps, ec)].to(torch.int64)
    nxt = torch.cat([src[1:], idx.counts[:1]])[:src.shape[0]]
    dev = cw.device
    n_valid = src.shape[0]
    pmask = (1 << pos_bits) - 1
    pair_bits = pair_bits_for(G)
    bias = 1 << pos_bits
    w = cw[src]
    r_pos = w & pmask
    r_delta = shr(w, pos_bits) & ((1 << (pos_bits + 2)) - 1)
    r_pair = shr(w, 2 * pos_bits + 2) & ((1 << pair_bits) - 1)
    r_fwd = (shr(w, pair_bits + 2 * pos_bits + 2) & 1) == 1
    r_a = (r_pair // G).clamp(max=G - 1)
    r_b = (r_pair % G).clamp(max=G - 1)
    last = torch.maximum(cw[nxt - 1] & pmask, r_pos)
    span = last - r_pos
    pos_b = torch.where(r_fwd, r_delta - bias + r_pos, r_delta - r_pos)
    left_b = torch.where(r_fwd, pos_b, r_delta - last).clamp(min=0)

    def full(shape, val, dt):
        return torch.full(shape, val, dtype=dt, device=dev)

    lefts = full((ec, 2), 0, torch.int32)
    present = full((ec, 2), False, torch.bool)
    is_fwd = full((ec, 2), True, torch.bool)
    off2 = full((ec, 2), int(gen_off[0]), torch.int32)
    cnt2 = full((ec, 2), int(gen_cnt[0]), torch.int32)
    lengths0 = full((ec,), seed_len, torch.int32)
    ra = full((ec,), 0, torch.int32)
    rb = full((ec,), 0, torch.int32)
    v = slice(0, n_valid)
    lefts[v] = torch.stack([r_pos, left_b], 1).to(torch.int32)
    present[v] = True
    is_fwd[v, 1] = r_fwd
    off2[v] = torch.stack([gen_off[r_a], gen_off[r_b]], 1)
    cnt2[v] = torch.stack([gen_cnt[r_a], gen_cnt[r_b]], 1)
    lengths0[v] = (span + seed_len).to(torch.int32)
    ra[v] = r_a.to(torch.int32)
    rb[v] = r_b.to(torch.int32)
    return Reps(lefts, present, is_fwd, off2, cnt2, lengths0, ra, rb,
                idx.n_reps)


def cluster_reps_plain(cw, ec: int, G: int, pos_bits: int, seed_len: int,
                       gen_off, gen_cnt) -> Reps:
    """Plain PyTorch version of K7 in one call (matchfind.py:1163-1214)."""
    return decode_reps_plain(cw, rep_index_plain(cw, pos_bits, seed_len), ec,
                             G, pos_bits, seed_len, gen_off, gen_cnt)


@cuda.launcher
def decode_reps(cw, idx: RepIndex, ec: int, G: int, pos_bits: int,
                seed_len: int, gen_off, gen_cnt) -> Reps:
    """The first min(n_reps, EC) representatives of rep_index(cw) as EC
    compact extension rows (rows past it are absent).

    gen_off, gen_cnt: int32[G] genome offsets and window counts in the
    keys that K2 probes.  CPU tensors take the plain version; CUDA
    tensors launch K7's decode."""
    if cw.device.type == "cpu":
        return decode_reps_plain(cw, idx, ec, G, pos_bits, seed_len,
                                 gen_off, gen_cnt)
    dev = cw.device
    cuda.require(cw, "cw", torch.int64, dev, (cw.shape[0],))
    cuda.require(idx.index, "index", torch.int32, dev)
    cuda.require(idx.counts, "counts", torch.int64, dev, (2,))
    cuda.require(gen_off, "gen_off", torch.int32, dev, (G,))
    cuda.require(gen_cnt, "gen_cnt", torch.int32, dev, (G,))
    i32 = dict(dtype=torch.int32, device=dev)
    lefts = torch.empty((ec, 2), **i32)
    present = torch.empty((ec, 2), dtype=torch.bool, device=dev)
    is_fwd = torch.empty((ec, 2), dtype=torch.bool, device=dev)
    off2 = torch.empty((ec, 2), **i32)
    cnt2 = torch.empty((ec, 2), **i32)
    lengths0 = torch.empty(ec, **i32)
    r_a = torch.empty(ec, **i32)
    r_b = torch.empty(ec, **i32)
    if ec > 0:
        cuda.check(cuda.library().lm_reps(
            cw.data_ptr(), idx.index.data_ptr(), idx.counts.data_ptr(),
            min(idx.n_reps, ec), ec, G, pos_bits, pair_bits_for(G), seed_len,
            gen_off.data_ptr(), gen_cnt.data_ptr(), lefts.data_ptr(),
            present.data_ptr(), is_fwd.data_ptr(), off2.data_ptr(),
            cnt2.data_ptr(), lengths0.data_ptr(), r_a.data_ptr(),
            r_b.data_ptr(), cuda.stream(cw)), "lm_reps")
        decode_reps.launches += 1
    return Reps(lefts, present, is_fwd, off2, cnt2, lengths0, r_a, r_b,
                idx.n_reps)


decode_reps.launches = 0


def cluster_reps(cw, ec: int, G: int, pos_bits: int, seed_len: int,
                 gen_off, gen_cnt) -> Reps:
    """Representatives of the sorted cluster words as EC compact
    extension rows (rows past min(n_reps, EC) are absent): rep_index then
    decode_reps at EC.

    cw: int64[m] cluster words in unsigned order (-1 last); gen_off,
    gen_cnt: int32[G] genome offsets and window counts in the keys that
    K2 probes."""
    return decode_reps(cw, rep_index(cw, pos_bits, seed_len), ec, G,
                       pos_bits, seed_len, gen_off, gen_cnt)
