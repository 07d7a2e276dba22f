"""The multi-MUM pipeline's table passes (kernels K13-K15, csrc/mums.cu).

Port of the device stages of libmems_tpu/matchfind.py's
_fused_mum_pipeline and of the helpers it uses (MemHash::FindMatches,
libMems/MemHash.cpp:109-251):

* ``mum_seed_flags`` (K13): ``_mum_seed_flags`` with the ops/segments.py
  run helpers: per row of the (content, gid, pos)-sorted seed table its
  genome, position and strand, ``kept_occ`` (the first occurrence of each
  (content, genome) in a surviving run), ``row_id`` (surviving runs
  numbered densely), ``ref_strand`` (the strand of the run's first row)
  and ``n_rows``, in two launches over tiles of ``pairwise.RUN_TILE``
  rows: K5's run summaries with K13's big rows flagged
  (``pairwise._summaries``), then the flags (``_flag_pass``), each with a
  plain version (``pairwise.run_summaries_plain``,
  ``mum_flags_from_summaries_plain``) that compose to
  ``mum_seed_flags_plain``;
* ``mum_candidates`` (K14): the candidate rows, the ``seq_mask`` filter
  and ``_packed_diagonal_words`` in one pass over K13's flags at
  repeat_tolerance 0: starts int32[n_rows, G], the packed signature
  words int64[n_words, n_rows] and posref int64[n_rows];
* ``mum_rep_index`` then ``mum_decode_reps`` (K15): the representatives
  of the sorted signature rows, found in one scan (their row indices and
  count, the count read once), then decoded by ``_recover_starts`` into
  K2's [EC, G] extension rows at a capacity EC that the caller picks from
  the count (``pairwise.rep_capacity``); ``mum_reps`` is the two in one call.

Words are int64 tensors below 2^63 (63 payload bits a word), so their
signed order is the JAX package's unsigned one.  The G-bit mask and sign
fields are packed a bit at a time, genome G-1 first, where the JAX
package packs G-bit integers: the same words, at any G.  Each wrapper takes its
plain PyTorch version for CPU tensors and launches its kernel for CUDA
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch.ops import pairwise
from libmems_tpu_torch.ops.pairwise import (cumsum32, run_starts,
                                            scan_scratch, seed_table_meta,
                                            shr)

WORD_BITS = 63      # payload bits of a signature word (matchfind._WORD_BITS)


def n_words_for(G: int, pos_bits: int) -> int:
    """Signature words of a row: invalid(1) | mask(G) | signs(G) | G
    diagonals of pos_bits + 2 bits."""
    return max(1, -(-(1 + G * (pos_bits + 4)) // WORD_BITS))


class MumFlags(NamedTuple):
    kept_occ: torch.Tensor     # bool[n]
    row_id: torch.Tensor       # int32[n]
    ref_strand: torch.Tensor   # uint8[n]
    n_rows: int
    gid: torch.Tensor          # int32[n]
    pos: torch.Tensor          # int32[n]
    strand: torch.Tensor       # uint8[n]
    repeat_tolerance: int      # the tolerance K13 flagged the runs at


# ops/segments.py, in torch ----------------------------------------------

def _start_index(starts: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(starts.shape[0], device=starts.device)
    return torch.cummax(torch.where(starts, idx, 0), 0).values


def _end_index(starts: torch.Tensor) -> torch.Tensor:
    n = starts.shape[0]
    idx = torch.arange(n, device=starts.device)
    ends = torch.cat([starts[1:], torch.ones(1, dtype=torch.bool,
                                             device=starts.device)])
    rev = torch.cummin(torch.where(ends, idx, n).flip(0), 0).values.flip(0)
    return rev + 1


def _run_lengths(starts: torch.Tensor) -> torch.Tensor:
    return _end_index(starts) - _start_index(starts)


def _segment_max_broadcast(values, seg_starts):
    seg_id = torch.cumsum(seg_starts.to(torch.int64), 0) - 1
    packed = (seg_id << 32) | values.to(torch.int64)
    cm = torch.cummax(packed, 0).values & 0xFFFFFFFF
    return cm[_end_index(seg_starts) - 1]


def _segment_sum_broadcast(values, seg_starts):
    cs = torch.cumsum(values, 0)
    cs = cs - (cs - values)[_start_index(seg_starts)]
    return cs[_end_index(seg_starts) - 1]


def mum_seed_flags_plain(content, src, keys, seg_off, repeat_tolerance: int,
                         repeat_limit: int, sent_content: int,
                         row_keys: bool = False) -> MumFlags:
    """Plain PyTorch version of K13: _mum_seed_flags as the JAX module
    computes it."""
    gid, pos, strand = seed_table_meta(src, keys, seg_off, row_keys)
    n = content.shape[0]
    if n == 0:
        e = torch.zeros(0, dtype=torch.int32, device=content.device)
        return MumFlags(e.bool(), e, e.to(torch.uint8), 0, gid, pos, strand,
                        repeat_tolerance)
    sc = run_starts(content)
    scg = run_starts(content, gid)
    max_subrun = _segment_max_broadcast(_run_lengths(scg), sc)
    ngids = _segment_sum_broadcast(scg.to(torch.int64), sc)
    runlen = _run_lengths(sc)
    keep_run = (ngids >= 2) & (max_subrun <= repeat_tolerance + 1) \
        & (runlen <= repeat_limit) & (content != sent_content)
    kept_occ = scg & keep_run
    rid_at_start = cumsum32(sc & keep_run) - 1
    first = _start_index(sc)
    row_id = rid_at_start[first]
    ref_strand = strand[first]
    n_rows = int(rid_at_start[-1]) + 1 if bool(keep_run.any()) else 0
    return MumFlags(kept_occ, row_id, ref_strand, n_rows, gid, pos, strand,
                    repeat_tolerance)


def mum_flags_from_summaries_plain(content, src, keys, seg_off, words,
                                   repeat_tolerance: int, repeat_limit: int,
                                   sent_content: int,
                                   row_keys: bool = False) -> MumFlags:
    """Plain version of K13's second launch: mum_seed_flags_plain's flags,
    each run decided at its last row in a tile (its end's row, or the
    tile's last): run bounds and big rows in the tile and, across its
    edges, from the summary words (pairwise.run_summaries_plain with span
    repeat_tolerance + 1); the genomes of the run's first and last rows;
    kept runs numbered by tile (pairwise.tile_ranks_plain)."""
    gid, pos, strand = seed_table_meta(src, keys, seg_off, row_keys)
    n = content.shape[0]
    dev = content.device
    if n == 0:
        e = torch.zeros(0, dtype=torch.int32, device=dev)
        return MumFlags(e.bool(), e, e.to(torch.uint8), 0, gid, pos, strand,
                        repeat_tolerance)
    sc = run_starts(content)
    scg = run_starts(content, gid)
    b = pairwise.tile_runs_plain(sc, words)
    idx = torch.arange(n, device=dev)
    tile = idx // pairwise.RUN_TILE
    lo = tile * pairwise.RUN_TILE
    hi = torch.clamp(lo + pairwise.RUN_TILE, max=n)
    big = pairwise.big_rows(content, gid, repeat_tolerance + 1)
    near_big = torch.cummax(pairwise._tile_view(torch.where(big, idx, -1),
                                                -1), 1).values
    near_big = torch.maximum(near_big.flatten()[:n], lo - 1)
    decider = torch.minimum(b.end, hi) - 1
    has_big = (near_big[decider] >= torch.maximum(b.start, lo)) \
        | ((b.start < lo) & b.flag_in[tile]) \
        | ((b.end > hi) & b.flag_out[tile])
    keep = (gid[b.start] != gid[b.end - 1]) & ~has_big \
        & (b.end - b.start <= repeat_limit) & (content != sent_content)
    kept_start = sc & keep
    return MumFlags(scg & keep, pairwise.tile_ranks_plain(kept_start),
                    strand[b.start], int(kept_start.sum()), gid, pos,
                    strand, repeat_tolerance)


def _flag_pass(content, src, keys, seg_off, repeat_tolerance: int,
               repeat_limit: int, sent_content: int, row_keys: bool,
               scratch, out: MumFlags) -> None:
    """K13's second launch into out's tensors (its n_rows ignored), after
    pairwise._summaries with span repeat_tolerance + 1 (or with scratch's
    look-back words zeroed and its summary words filled); scratch word 1
    then holds n_rows."""
    cuda.check(cuda.library().lm_mum_tile_flags(
        content.data_ptr(), src.data_ptr(), keys.data_ptr(), int(row_keys),
        seg_off.data_ptr(), seg_off.shape[0] - 1, content.shape[0],
        repeat_tolerance + 1, repeat_limit, sent_content, scratch.data_ptr(),
        out.kept_occ.data_ptr(), out.row_id.data_ptr(),
        out.ref_strand.data_ptr(), out.gid.data_ptr(), out.pos.data_ptr(),
        out.strand.data_ptr(), cuda.stream(content)), "lm_mum_tile_flags")


@cuda.launcher
def mum_seed_flags(content, src, keys, seg_off, repeat_tolerance: int,
                   repeat_limit: int, sent_content: int,
                   row_keys: bool = False) -> MumFlags:
    """MemHash seed-enumeration flags of the sorted seed table.

    content: int64[n] sorted contents (key >> 1, logical); src: int64[n]
    each row's index into keys, the int64 position-order concatenation of
    the genomes' keys (with row_keys: keys int64[n], the rows' own keys,
    which a routed table carries so that no shard needs the whole table);
    seg_off: int64[G+1] genome bounds in keys.  CPU tensors take the plain
    version; CUDA tensors launch K13: the tile summaries (K5's launch,
    big rows flagged), then the flags, and read n_rows once."""
    if content.device.type == "cpu":
        return mum_seed_flags_plain(content, src, keys, seg_off,
                                    repeat_tolerance, repeat_limit,
                                    sent_content, row_keys)
    dev = content.device
    n = content.shape[0]
    G = seg_off.shape[0] - 1
    cuda.require(content, "content", torch.int64, dev, (n,))
    cuda.require(src, "src", torch.int64, dev, (n,))
    cuda.require(keys, "keys", torch.int64, dev,
                 (n,) if row_keys else (keys.shape[0],))
    cuda.require(seg_off, "seg_off", torch.int64, dev, (G + 1,))
    i32 = dict(dtype=torch.int32, device=dev)
    u8 = dict(dtype=torch.uint8, device=dev)
    out = MumFlags(torch.empty(n, dtype=torch.bool, device=dev),
                   torch.empty(n, **i32), torch.empty(n, **u8), 0,
                   torch.empty(n, **i32), torch.empty(n, **i32),
                   torch.empty(n, **u8), repeat_tolerance)
    if not n:
        return out
    scratch = pairwise.run_scratch(n, dev)
    pairwise._summaries(content, src, seg_off, repeat_tolerance + 1, scratch)
    _flag_pass(content, src, keys, seg_off, repeat_tolerance, repeat_limit,
               sent_content, row_keys, scratch, out)
    mum_seed_flags.launches += 1
    # the one host read: the kept runs' count
    return out._replace(n_rows=int(scratch[1]))


mum_seed_flags.launches = 0


class Candidates(NamedTuple):
    starts: torch.Tensor   # int32[n_rows, G], rows seq_mask rejected zeroed
    words: torch.Tensor    # int64[n_words, n_rows] signature words
    posref: torch.Tensor   # int64[n_rows]; 1 << 62 where invalid


def _field_words(start: int, end: int):
    """(w, lo, hi) for each word w that field bits [start, end) touch."""
    for w in range(start // WORD_BITS, -(-end // WORD_BITS)):
        ws, we = w * WORD_BITS, (w + 1) * WORD_BITS
        yield w, max(start, ws), min(end, we)


def _pack_words(fields, n_words: int, n: int, dev) -> torch.Tensor:
    """matchfind._pack_sort_words on int64: fields (value >= 0, nbits),
    MSB-first, into n_words words of 63 payload bits."""
    words = torch.zeros((n_words, n), dtype=torch.int64, device=dev)
    off = 0
    for arr, nb in fields:
        start, end = off, off + nb
        for w, lo, hi in _field_words(start, end):
            seg = shr(arr, end - hi) & ((1 << (hi - lo)) - 1)
            words[w] |= seg << ((w + 1) * WORD_BITS - hi)
        off = end
    return words


def _unpack_words(words: torch.Tensor, fields_bits) -> list[torch.Tensor]:
    """matchfind._unpack_sort_words on int64."""
    out = []
    off = 0
    for nb in fields_bits:
        start, end = off, off + nb
        val = torch.zeros_like(words[0])
        for w, lo, hi in _field_words(start, end):
            seg = shr(words[w], (w + 1) * WORD_BITS - hi) \
                & ((1 << (hi - lo)) - 1)
            val = val | (seg << (end - hi))
        out.append(val)
        off = end
    return out


def _sig_fields_bits(G: int, pos_bits: int) -> list[int]:
    """Field widths of a signature row: invalid, the mask and sign bits
    (genome G-1 first), the G biased diagonals."""
    return [1] + [1] * (2 * G) + [pos_bits + 2] * G


def mum_candidates_plain(flags: MumFlags, G: int, seq_mask: int,
                         pos_bits: int) -> Candidates:
    """Plain PyTorch version of K14."""
    dev = flags.kept_occ.device
    n_rows = flags.n_rows
    keep = flags.kept_occ
    starts = torch.zeros((n_rows, G), dtype=torch.int32, device=dev)
    sign = torch.where(flags.strand[keep] == flags.ref_strand[keep], 1, -1)
    starts[flags.row_id[keep].long(), flags.gid[keep].long()] = \
        (sign * (flags.pos[keep] + 1)).to(torch.int32)
    valid = torch.ones(n_rows, dtype=torch.bool, device=dev)
    if seq_mask:
        want = torch.tensor([(seq_mask >> (G - 1 - g)) & 1 for g in range(G)],
                            dtype=torch.bool, device=dev)
        row_ok = ((starts != 0) == want[None, :]).all(dim=1)
        starts = torch.where(row_ok[:, None], starts, 0)
        valid &= row_ok
    # _packed_diagonal_words
    present = starts != 0
    pos = starts.abs().to(torch.int64) - 1
    ref_idx = torch.argmax(present.to(torch.int8), dim=1)
    pos_ref = torch.gather(pos, 1, ref_idx[:, None])[:, 0]
    neg = starts < 0
    delta = torch.where(neg, pos + pos_ref[:, None], pos - pos_ref[:, None])
    delta_b = torch.where(present, delta + (1 << (pos_bits + 1)), 0)
    bits = [(~valid).to(torch.int64)] \
        + [present[:, g].to(torch.int64) for g in range(G - 1, -1, -1)] \
        + [neg[:, g].to(torch.int64) for g in range(G - 1, -1, -1)] \
        + [delta_b[:, g] for g in range(G)]
    words = _pack_words(zip(bits, _sig_fields_bits(G, pos_bits)),
                        n_words_for(G, pos_bits), n_rows, dev)
    posref = torch.where(valid, pos_ref, 1 << 62)
    return Candidates(starts, words, posref)


@cuda.launcher
def mum_candidates(flags: MumFlags, G: int, seq_mask: int,
                   pos_bits: int) -> Candidates:
    """Candidate rows of the surviving runs, filtered by seq_mask (bit
    G-1-g is genome g; 0 keeps every row), with their packed diagonal
    signatures.  The flags must be K13's at repeat_tolerance 0 (its one
    caller's; anything else raises): a kept run then holds each genome at
    most once and its rows are one group of at most G consecutive kept
    table rows in gid order (the CPU tests hold the fused path's flags to
    this).  CPU tensors take the plain version; CUDA tensors launch K14,
    where the thread of a group's first row builds the candidate."""
    if G < 1:
        raise ValueError("the signature words need at least one genome")
    if flags.repeat_tolerance != 0:
        raise ValueError("mum_candidates takes K13's flags at "
                         f"repeat_tolerance 0, not {flags.repeat_tolerance}")
    keep = flags.kept_occ
    if keep.device.type == "cpu":
        return mum_candidates_plain(flags, G, seq_mask, pos_bits)
    dev = keep.device
    n = keep.shape[0]
    for name, t, dt in (("kept_occ", keep, torch.bool),
                        ("row_id", flags.row_id, torch.int32),
                        ("ref_strand", flags.ref_strand, torch.uint8),
                        ("gid", flags.gid, torch.int32),
                        ("pos", flags.pos, torch.int32),
                        ("strand", flags.strand, torch.uint8)):
        cuda.require(t, name, dt, dev, (n,))
    n_rows = flags.n_rows
    n_words = n_words_for(G, pos_bits)
    starts = torch.empty((n_rows, G), dtype=torch.int32, device=dev)
    words = torch.empty((n_words, n_rows), dtype=torch.int64, device=dev)
    posref = torch.empty(n_rows, dtype=torch.int64, device=dev)
    lib = cuda.library()
    cuda.check(lib.lm_mum_candidates(
        keep.data_ptr(), flags.row_id.data_ptr(), flags.gid.data_ptr(),
        flags.pos.data_ptr(), flags.strand.data_ptr(),
        flags.ref_strand.data_ptr(), n, G, n_rows, seq_mask, pos_bits,
        n_words, starts.data_ptr(), words.data_ptr(), posref.data_ptr(),
        cuda.stream(keep)), "lm_mum_candidates")
    mum_candidates.launches += 1
    return Candidates(starts, words, posref)


mum_candidates.launches = 0


class MumReps(NamedTuple):
    lefts: torch.Tensor     # int32[EC, G]
    present: torch.Tensor   # bool[EC, G]
    is_fwd: torch.Tensor    # bool[EC, G]
    n_reps: int


class MumRepIndex(NamedTuple):
    index: torch.Tensor     # int32: entries [0, n_reps) the reps' rows
    n_reps: int


def recover_starts(words, posref, G: int, pos_bits: int) -> torch.Tensor:
    """matchfind._recover_starts: signed int32 starts [m, G] of signature
    rows."""
    vals = _unpack_words(words, _sig_fields_bits(G, pos_bits))
    invalid = vals[0] != 0
    cols = []
    for g in range(G):
        present = vals[G - g] == 1
        neg = vals[2 * G - g] == 1
        delta = vals[1 + 2 * G + g] - (1 << (pos_bits + 1))
        posg = torch.where(neg, delta - posref, delta + posref)
        col = torch.where(present & ~invalid,
                          torch.where(neg, -1, 1) * (posg + 1), 0)
        cols.append(col.to(torch.int32))
    return torch.stack(cols, dim=1)


def rows_valid(words, G: int) -> torch.Tensor:
    """Whether each signature row holds a start, from its fields alone:
    its invalid bit (field bit 0) is clear and a bit of its G-bit mask
    field (field bits [1, G + 1)) is set.  On K14's rows it equals
    ``(recover_starts(...) != 0).any(1)``: a present genome's start is
    its position + 1."""
    valid = (shr(words[0], WORD_BITS - 1) & 1) == 0
    present = torch.zeros_like(valid)
    for w, lo, hi in _field_words(1, G + 1):
        seg = shr(words[w], (w + 1) * WORD_BITS - hi) & ((1 << (hi - lo)) - 1)
        present |= seg != 0
    return valid & present


def mum_rep_index_plain(words, posref, G: int, pos_bits: int,
                        seed_len: int) -> MumRepIndex:
    """Plain PyTorch version of K15's scan (matchfind.py:381-397): the
    valid rows that are the first row, whose words differ from the row
    before, or whose posref is more than seed_len past it."""
    m = posref.shape[0]
    change = torch.zeros(m, dtype=torch.bool, device=posref.device)
    change[:1] = True
    for w in words:
        change[1:] |= w[1:] != w[:-1]
    change[1:] |= posref[1:] - posref[:-1] > seed_len
    index = torch.nonzero(change & rows_valid(words, G)).flatten()
    return MumRepIndex(index.to(torch.int32), index.shape[0])


def mum_decode_reps_plain(words, posref, idx: MumRepIndex, ec: int, G: int,
                          pos_bits: int) -> MumReps:
    """Plain PyTorch version of K15's decode (matchfind.py:399-423): the
    first min(n_reps, EC) representatives' starts as [EC, G] extension
    rows; the rows after them absent."""
    dev = posref.device
    rows = idx.index[:min(idx.n_reps, ec)].to(torch.int64)
    e = recover_starts(words[:, rows], posref[rows], G, pos_bits)
    lefts = torch.zeros((ec, G), dtype=torch.int32, device=dev)
    present = torch.zeros((ec, G), dtype=torch.bool, device=dev)
    is_fwd = torch.zeros((ec, G), dtype=torch.bool, device=dev)
    k = e.shape[0]
    present[:k] = e != 0
    lefts[:k] = torch.where(e != 0, e.abs() - 1, 0)
    is_fwd[:k] = e > 0
    return MumReps(lefts, present, is_fwd, idx.n_reps)


def mum_reps_plain(words, posref, ec: int, G: int, pos_bits: int,
                   seed_len: int) -> MumReps:
    """Plain PyTorch version of K15 in one call."""
    return mum_decode_reps_plain(
        words, posref, mum_rep_index_plain(words, posref, G, pos_bits,
                                           seed_len), ec, G, pos_bits)


@cuda.launcher
def mum_rep_index(words, posref, G: int, pos_bits: int,
                  seed_len: int) -> MumRepIndex:
    """The representatives of the sorted signature rows: their row
    indices in order and their count, read to the host.

    words: int64[n_words, m], posref: int64[m], both in the rows' sorted
    order.  CPU tensors take the plain version; CUDA tensors launch K15's
    scan."""
    if posref.device.type == "cpu":
        return mum_rep_index_plain(words, posref, G, pos_bits, seed_len)
    dev = posref.device
    m = posref.shape[0]
    cuda.require(words, "words", torch.int64, dev,
                 (n_words_for(G, pos_bits), m))
    cuda.require(posref, "posref", torch.int64, dev, (m,))
    if m >= 1 << 31:
        raise ValueError(f"K15 indexes rows with int32: {m} rows")
    if m == 0:
        return MumRepIndex(torch.zeros(0, dtype=torch.int32, device=dev), 0)
    index = torch.empty(m, dtype=torch.int32, device=dev)
    scratch = scan_scratch(m, dev)
    cuda.check(cuda.library().lm_mum_rep_index(
        words.data_ptr(), posref.data_ptr(), m, G, words.shape[0], seed_len,
        index.data_ptr(), scratch.data_ptr(), cuda.stream(posref)),
        "lm_mum_rep_index")
    mum_rep_index.launches += 1
    # the one host read: the representatives' count
    return MumRepIndex(index, int(scratch[1]))


mum_rep_index.launches = 0


@cuda.launcher
def mum_decode_reps(words, posref, idx: MumRepIndex, ec: int, G: int,
                    pos_bits: int) -> MumReps:
    """The first min(n_reps, EC) representatives of mum_rep_index as EC
    compact [EC, G] extension rows (rows past them are absent).  CPU
    tensors take the plain version; CUDA tensors launch K15's decode."""
    if posref.device.type == "cpu":
        return mum_decode_reps_plain(words, posref, idx, ec, G, pos_bits)
    dev = posref.device
    m = posref.shape[0]
    cuda.require(words, "words", torch.int64, dev,
                 (n_words_for(G, pos_bits), m))
    cuda.require(posref, "posref", torch.int64, dev, (m,))
    cuda.require(idx.index, "index", torch.int32, dev)
    lefts = torch.empty((ec, G), dtype=torch.int32, device=dev)
    present = torch.empty((ec, G), dtype=torch.bool, device=dev)
    is_fwd = torch.empty((ec, G), dtype=torch.bool, device=dev)
    if ec > 0:
        cuda.check(cuda.library().lm_mum_decode_reps(
            words.data_ptr(), posref.data_ptr(), idx.index.data_ptr(), m,
            min(idx.n_reps, ec), ec, G, pos_bits, lefts.data_ptr(),
            present.data_ptr(), is_fwd.data_ptr(), cuda.stream(posref)),
            "lm_mum_decode_reps")
        mum_decode_reps.launches += 1
    return MumReps(lefts, present, is_fwd, idx.n_reps)


mum_decode_reps.launches = 0


def mum_reps(words, posref, ec: int, G: int, pos_bits: int,
             seed_len: int) -> MumReps:
    """Diagonal-cluster representatives of the sorted signature rows as
    EC compact [EC, G] extension rows (rows past min(n_reps, EC) are
    absent): mum_rep_index then mum_decode_reps at EC.  words:
    int64[n_words, m], posref: int64[m], both in the rows' sorted
    order."""
    return mum_decode_reps(words, posref,
                           mum_rep_index(words, posref, G, pos_bits,
                                         seed_len), ec, G, pos_bits)
