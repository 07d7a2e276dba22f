"""Multi-MUM discovery: global sort + run flags + diagonal clustering +
batched extension.

Port of libmems_tpu/matchfind.py (MemHash::FindMatches / EnumerateMatches,
libMems/MemHash.cpp:109-251; MatchFinder::ExtendMatch).  ``find_mums``
takes any number of genomes and every mode of the JAX module:

* the general device pipeline (``find_mums_device``; any G, or a pair
  whose packed words do not fit 64 bits): one stable ``torch.sort`` of
  the contents of the position-order concatenation (the (content, gid,
  pos) order) -> MemHash enumeration flags (K13) -> candidate rows, the
  ``seq_mask`` filter and packed diagonal signatures (K14) -> successive
  stable sorts of the signature words -> cluster representatives
  compacted to extension rows (K15) -> extension (K2) -> dedup on the
  host;
* the pair fast path (G = 2, default mode, words within 64 bits): one
  word per window (content | gid | pos | strand), sorted; exact-pair runs
  by neighbour compares and their cluster words (fwd | diagonal | posA;
  K18), sorted; representatives compacted to extension rows (K19);
  extension from the cluster extent (K2);
* the host orchestrations of ``repeat_tolerance > 0`` and
  ``extend=False`` (K13 with the tolerance, then numpy clustering and K2)
  and of ``enumeration_tolerance > 1`` (the vectorised odometer);
* the resumable search ``find_mums_checkpointed``: the device seed table
  cut into content ranges, each through K13, numpy clustering and K2,
  with the match list and a cursor written after each range.

The progressive aligner's seeder, ``find_pairwise_mums`` (any G), runs
its own stages on per-genome-unique seeds with kernels K5-K7
(libmems_tpu_torch.ops.pairwise); layouts beyond the fused pipeline's
word or row budget, and ``extend=False``, take the host orchestration
(``_find_pairwise_mums_host``: K5, numpy pair expansion and clustering,
K2).  The JAX package pads tables to length
buckets for compile-cache reuse; the port works on the exact windows
(the padding only added rows to the never-kept sentinel run).

Words are int64 tensors holding the JAX pipeline's unsigned 64-bit
patterns: sorts flip bit 63 and right shifts mask the sign fill
(``_usort``, ``_shr``), so every comparison sees the unsigned order.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from libmems_tpu_torch import seeds as seedlib
from libmems_tpu_torch import cuda
from libmems_tpu_torch.match import (MatchArray, read_match_list,
                                     write_match_list)
from libmems_tpu_torch.ops import mums as ops_mums
from libmems_tpu_torch.ops import pair as ops_pair
from libmems_tpu_torch.ops import pairwise as ops_pairwise
from libmems_tpu_torch.ops.extend import extend_matches
from libmems_tpu_torch.ops.mers import sentinel_content, key_sentinel
from libmems_tpu_torch.ops.pairwise import shr as _shr, usort as _usort
from libmems_tpu_torch.sequence import Genome
from libmems_tpu_torch.sml import SortedMerList

MER_REPEAT_LIMIT = 1000  # MatchFinder.cpp:166

def _pair_pos_bits(total_windows: int) -> int:
    return max(int(total_windows).bit_length(), 8)


def pair_fast_path_ok(smls) -> bool:
    """The pair path needs the packed seed word (2*weight + 3 + pos_bits
    bits) and the cluster word (2*pos_bits + 3 bits) to fit 64 bits."""
    if len(smls) != 2:
        return False
    pb = _pair_pos_bits(max(s.n_windows for s in smls))
    return 2 * smls[0].seed_weight + 3 + pb <= 64 and pb <= 30


def _lexsort_rows(cols: list[torch.Tensor]) -> torch.Tensor:
    """Permutation ordering rows lexicographically by cols[0], cols[1],
    ... (successive stable sorts from the last key)."""
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for col in reversed(cols):
        order = order[torch.sort(col[order], stable=True).indices]
    return order


def pair_candidates(seed_len: int, pos_bits: int, extend_capacity: int,
                    keys_a, keys_b, seed: int):
    """Stages before extension of the G=2 pipeline
    (libmems_tpu/matchfind.py:495-594): seed words, sort, exact-pair
    cluster words (K18, the n_cands candidates only), their sort, cluster
    representatives as extension rows (K19: K7's compacting scan, one
    host read of their count, a slot decode at EC).  Returns (lefts
    int32[EC, 2], present, is_fwd bool[EC, 2], lengths int32[EC],
    n_cands, n_reps); rows past n_reps are absent."""
    cw, n_cands = ops_pair.pair_cluster_words(keys_a, keys_b, pos_bits,
                                              sentinel_content(seed))
    reps = ops_pair.pair_reps(_usort(cw), extend_capacity, pos_bits,
                              seed_len)
    return (reps.lefts, reps.present, reps.is_fwd, reps.lengths0, n_cands,
            reps.n_reps)


def _fused_pair_pipeline(seed_len: int, chunk: int, pos_bits: int,
                         extend_capacity: int, keys_posorder, keys_a,
                         keys_b, gen_off, gen_cnt, seed: int):
    """G=2 unique-MUM pipeline (libmems_tpu/matchfind.py:482-615).
    Returns (starts int32[EC, 2], lengths int32[EC], valid bool[EC],
    n_cands, n_reps) on the keys' device."""
    EC = extend_capacity
    dev = keys_a.device
    lefts, present, is_fwd, lengths0, n_cands, n_reps = pair_candidates(
        seed_len, pos_bits, EC, keys_a, keys_b, seed)
    e_valid = present[:, 0]
    r_fwd = is_fwd[:, 1]
    # the rows past the representatives are absent: only theirs launch
    lefts, lengths = extend_matches(
        keys_posorder, seed_len, chunk,
        gen_off[None, :].expand(EC, 2).contiguous(),
        gen_cnt[None, :].expand(EC, 2).contiguous(),
        lefts, present, is_fwd, lengths0, key_sentinel(seed),
        n_live=min(n_reps, EC))
    signB = torch.where(r_fwd, 1, -1).to(torch.int32)
    out_starts = torch.stack([
        torch.where(e_valid, lefts[:, 0] + 1, 0),
        torch.where(e_valid, signB * (lefts[:, 1] + 1), 0)], dim=1)

    # dedup: lexicographic sort of (starts, length), mark first of run
    invalid = (~e_valid).to(torch.int32)
    order = _lexsort_rows([out_starts[:, 0], out_starts[:, 1], lengths,
                           invalid])
    srows = torch.stack([out_starts[:, 0], out_starts[:, 1], lengths],
                        dim=1)[order]
    svalid = invalid[order] == 0
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       (srows[1:] != srows[:-1]).any(dim=1)])
    uniq = svalid & first
    return srows[:, :2], srows[:, 2], uniq, n_cands, n_reps


def _seed_table(smls: list[SortedMerList]):
    """The (content, gid, pos)-sorted seed table (_seed_table /
    _sorted_seed_table): one stable sort of the logical contents of the
    position-order concatenation of the genomes' keys.  Returns (keys,
    seg_off int64[G+1] genome bounds in keys, sorted contents, each sorted
    row's index into keys)."""
    dev = smls[0].device
    keys = torch.cat([s.keys for s in smls])
    cnts = [s.n_windows for s in smls]
    seg_off = torch.from_numpy(np.concatenate([[0], np.cumsum(cnts)]
                                              ).astype(np.int64)).to(dev)
    content, src = torch.sort(_shr(keys, 1), stable=True)
    return keys, seg_off, content, src


def _fused_mum_pipeline(smls: list[SortedMerList], chunk: int,
                        extend_capacity: int, repeat_limit: int,
                        seq_mask: int):
    """Any-G unique-MUM pipeline (libmems_tpu/matchfind.py:336-442):
    sort -> K13 -> K14 -> signature sort -> K15 -> K2.  Returns (starts
    int32[EC, G], lengths int32[EC], valid bool[EC], n_rows, n_reps);
    EC is the JAX package's growing capacity at its end, picked once from
    the representatives' count, so every representative has an extension
    row."""
    G = len(smls)
    seed = smls[0].seed
    seed_len = smls[0].seed_length
    keys, seg_off, content, src = _seed_table(smls)
    dev = keys.device
    flags = ops_mums.mum_seed_flags(content, src, keys, seg_off, 0,
                                    repeat_limit, sentinel_content(seed))
    del content, src
    n_rows = flags.n_rows
    if n_rows == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z.reshape(0, G), z, z.bool(), 0, 0
    pos_bits = keys.shape[0].bit_length()
    cand = ops_mums.mum_candidates(flags, G, seq_mask, pos_bits)
    del flags
    # the lexicographic (words..., posref) order: successive stable sorts
    # from the least significant key (the JAX lax.sort over the tuple)
    order = _lexsort_rows(list(cand.words) + [cand.posref])
    words = torch.index_select(cand.words, 1, order)
    posref = cand.posref[order]
    del cand, order
    # K15 finds the representatives in one scan, the capacity follows
    idx = ops_mums.mum_rep_index(words, posref, G, pos_bits, seed_len)
    ec = ops_pairwise.rep_capacity(
        min(extend_capacity, 1 << (n_rows - 1).bit_length()), idx.n_reps)
    reps = ops_mums.mum_decode_reps(words, posref, idx, ec, G, pos_bits)
    gen_off = seg_off[:-1].to(torch.int32)
    gen_cnt = (seg_off[1:] - seg_off[:-1]).to(torch.int32)
    lefts, lengths = extend_matches(
        keys, seed_len, chunk, gen_off[None].expand(ec, G).contiguous(),
        gen_cnt[None].expand(ec, G).contiguous(), reps.lefts, reps.present,
        reps.is_fwd, torch.full((ec,), seed_len, dtype=torch.int32,
                                device=dev), key_sentinel(seed),
        n_live=min(reps.n_reps, ec))
    sign = torch.where(reps.is_fwd, 1, -1).to(torch.int32)
    starts = torch.where(reps.present, sign * (lefts + 1), 0)
    valid = torch.arange(ec, device=dev) < reps.n_reps
    return starts, lengths, valid, n_rows, reps.n_reps



def _smls_device(arguments):
    """cuda.entry's pick: the device the SMLs lie on."""
    return arguments["smls"][0].device


def _run_device(arguments):
    """cuda.entry's pick: the device the SMLs lie on, or `device` where
    genomes are given."""
    x = arguments["genomes_or_smls"]
    if x and all(isinstance(s, SortedMerList) for s in x):
        return x[0].device
    return arguments["device"]


@cuda.entry(_smls_device)
def find_mums_device(smls: list[SortedMerList], capacity: int | None = None,
                     extend_capacity: int = 1 << 14,
                     chunk: int | None = None,
                     repeat_limit: int = MER_REPEAT_LIMIT,
                     seq_mask: int = 0):
    """Device MUM pipeline (default unique-MUM semantics): the pair fast
    path for two genomes whose packed words fit 64 bits (seq_mask 0 or
    0b11, the only pair masks a match can satisfy), else the general
    pipeline.  Returns (starts, lengths, valid, n_rows, n_reps) tensors
    on the SMLs' device; extend_capacity bounds the diagonal-cluster
    representatives (the general pipeline grows it itself).  `capacity`
    keeps the JAX package's signature and is ignored: that package
    bounded candidate seed runs with it, while the port's pipelines size
    their own tables from the data."""
    seed_len = smls[0].seed_length
    if chunk is None:
        chunk = max(seed_len, 256)
    if not (pair_fast_path_ok(smls) and seq_mask in (0, 0b11)):
        return _fused_mum_pipeline(smls, chunk, extend_capacity,
                                   repeat_limit, seq_mask)
    total = sum(s.n_windows for s in smls)
    extend_capacity = min(extend_capacity,
                          1 << max((total - 1).bit_length() - 1, 1))
    dev = smls[0].device
    keys_posorder = torch.cat([s.keys for s in smls])
    cnts = torch.tensor([s.n_windows for s in smls], dtype=torch.int32,
                        device=dev)
    offs = torch.tensor([0, smls[0].n_windows], dtype=torch.int32,
                        device=dev)
    pb = _pair_pos_bits(max(s.n_windows for s in smls))
    return _fused_pair_pipeline(seed_len, chunk, pb, extend_capacity,
                                keys_posorder, smls[0].keys, smls[1].keys,
                                offs, cnts, smls[0].seed)


def _as_smls(genomes_or_smls, seed: int | None, device):
    if all(isinstance(x, SortedMerList) for x in genomes_or_smls):
        smls = list(genomes_or_smls)
        return smls, smls[0].seed
    from libmems_tpu_torch.sml import create_smls
    genomes = [g if isinstance(g, Genome) else Genome.from_string(g)
               for g in genomes_or_smls]
    return create_smls(genomes, seed, device=device)


def _cluster_reduce_np(starts: np.ndarray, lengths: np.ndarray,
                       seed_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of the device diagonal clustering: keep one candidate
    per (participation, strand pattern, diagonal) cluster whose seeds
    are chain-connected (ref-position gaps <= seed_len).  All members of
    a cluster extend to the same maximal match, so dropping non-
    representatives cannot change the deduplicated result set."""
    R, G = starts.shape
    if R == 0:
        return starts, lengths
    present = starts != 0
    pos = np.abs(starts) - 1
    ref_idx = np.argmax(present, axis=1)
    pos_ref = pos[np.arange(R), ref_idx]
    neg = starts < 0
    delta = np.where(present,
                     np.where(neg, pos + pos_ref[:, None],
                              pos - pos_ref[:, None]),
                     np.int64(1) << 62)
    w = np.int64(1) << np.arange(G, dtype=np.int64)
    maskbits = (present * w).sum(axis=1)
    signbits = (neg * w).sum(axis=1)
    order = np.lexsort((pos_ref,) + tuple(
        delta[:, g] for g in range(G - 1, -1, -1)) + (signbits, maskbits))
    sm, ss = maskbits[order], signbits[order]
    sd, sp = delta[order], pos_ref[order]
    sig_change = np.concatenate([[True],
                                 (sm[1:] != sm[:-1]) | (ss[1:] != ss[:-1])
                                 | (sd[1:] != sd[:-1]).any(axis=1)
                                 | (sp[1:] - sp[:-1] > seed_len)])
    reps = order[sig_change]
    return starts[reps], lengths[reps]


def _extend_rows(smls: list[SortedMerList], starts: np.ndarray,
                 lengths: np.ndarray, chunk: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Extend signed candidate rows to maximal matches with K2 on the
    SMLs' device (the JAX row padding only added absent rows)."""
    R, G = starts.shape
    if R == 0:
        return starts, lengths
    seed_len = smls[0].seed_length
    if chunk is None:
        chunk = max(seed_len, 128)
    dev = smls[0].device
    keys_concat = torch.cat([s.keys for s in smls])
    cnts = np.array([s.n_windows for s in smls], dtype=np.int32)
    offs = np.concatenate([[0], np.cumsum(cnts)[:-1]]).astype(np.int32)
    present = starts != 0
    lefts = (np.abs(starts) - 1).astype(np.int32)
    lefts[~present] = 0

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out_lefts, out_lengths = extend_matches(
        keys_concat, seed_len, chunk, put(np.broadcast_to(offs, (R, G))),
        put(np.broadcast_to(cnts, (R, G))), put(lefts), put(present),
        put(starts > 0), put(lengths.astype(np.int32)),
        key_sentinel(smls[0].seed))
    out_lefts = out_lefts.cpu().numpy().astype(np.int64)
    out_lengths = out_lengths.cpu().numpy().astype(np.int64)
    return np.sign(starts) * (out_lefts + 1), out_lengths


def _containment_filter(starts: np.ndarray, lengths: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Drop matches contained in another match with the same diagonal
    signature (the MemHash offset-bucket containment test,
    MemHash::AddHashEntry / MatchHashEntry::Contains,
    libMems/MemHash.cpp:209-251): for ungapped matches, containment
    implies identical (participation, strand pattern, per-genome
    diagonals), so buckets are the diagonal clusters and containment is
    an interval-cover scan within each."""
    R, G = starts.shape
    if R < 2:
        return starts, lengths
    present = starts != 0
    pos = np.abs(starts) - 1
    ref_idx = np.argmax(present, axis=1)
    pos_ref = pos[np.arange(R), ref_idx]
    neg = starts < 0
    delta = np.where(present,
                     np.where(neg, pos + pos_ref[:, None],
                              pos - pos_ref[:, None]),
                     np.int64(1) << 62)
    w = np.int64(1) << np.arange(G, dtype=np.int64)
    sig = [(present * w).sum(axis=1), (neg * w).sum(axis=1)] \
        + [delta[:, g] for g in range(G)]
    order = np.lexsort((-lengths, pos_ref) + tuple(sig[::-1]))
    s_sig = np.stack(sig, axis=1)[order]
    s_start = pos_ref[order]
    s_end = s_start + lengths[order] - 1
    # within a signature run, sorted by (start asc, length desc): a row
    # is contained iff some earlier row's end reaches its end.  The
    # per-run prefix max is one global maximum.accumulate over
    # seg_id-offset ends (rows of earlier runs can never dominate).
    seg_start = np.concatenate([[True],
                                (s_sig[1:] != s_sig[:-1]).any(axis=1)])
    seg_id = np.cumsum(seg_start) - 1
    offset = np.int64(s_end.max()) + 1
    e = seg_id * offset + s_end
    prev_max = np.concatenate([[np.int64(-1)],
                               np.maximum.accumulate(e)[:-1]])
    contained = (prev_max - seg_id * offset) >= s_end
    keep = np.ones(R, dtype=bool)
    keep[order[contained]] = False
    return starts[keep], lengths[keep]


@cuda.entry(_run_device)
def find_mums(genomes_or_smls, seed: int | None = None,
              repeat_tolerance: int = 0,
              repeat_limit: int = MER_REPEAT_LIMIT,
              min_multiplicity: int = 2,
              extend: bool = True,
              enumeration_tolerance: int = 1,
              seq_mask: int = 0, device="cuda") -> MatchArray:
    """Find multi-MUMs across N genomes (MemHash::FindMatches
    equivalent).  Genomes are indexed on `device`; SMLs are used where
    they lie.

    Default semantics match MemHash with repeat_tolerance=0 /
    enumeration_tolerance=1: only seeds unique within every participating
    genome generate matches (unique multi-MUMs); that mode runs the device
    pipeline (find_mums_device) at any G.  repeat_tolerance > 0 and
    extend=False take K13 with the tolerance, then the host clustering and
    K2.
    enumeration_tolerance > 1 emits every cross-genome combination of each
    surviving seed's first `enumeration_tolerance` occurrences per genome
    (the odometer loop of MatchFinder::EnumerateMatches,
    libMems/MatchFinder.cpp:342-393, driven by MemHash::EnumerateMatches,
    MemHash.cpp:139-162).

    seq_mask != 0 keeps only seeds whose genome-participation bitmask
    equals seq_mask, rejected BEFORE extension — MaskedMemHash::HashMatch
    (libMems/MaskedMemHash.cpp:38-63), the n-way-only searcher of
    SearchLCBGaps (Aligner.cpp:2208-2212).  Bit (G-1-seqI) <-> genome
    seqI.
    """
    smls, seed = _as_smls(genomes_or_smls, seed, device)
    G = len(smls)
    if seq_mask and bin(seq_mask).count("1") < max(2, min_multiplicity):
        return MatchArray.empty(G)
    if enumeration_tolerance > 1:
        return _find_mums_enumerated(
            smls, repeat_tolerance, enumeration_tolerance, repeat_limit,
            min_multiplicity, extend, seq_mask)
    if repeat_tolerance == 0 and extend:
        starts, lengths, valid, n_rows, n_reps = find_mums_device(
            smls, repeat_limit=repeat_limit, seq_mask=seq_mask)
        n_reps = int(n_reps)
        if n_reps > valid.shape[0]:
            # rare: more diagonal-cluster representatives than the default
            # extension capacity — rerun with the exact requirement
            starts, lengths, valid, n_rows, n_reps = find_mums_device(
                smls, repeat_limit=repeat_limit, seq_mask=seq_mask,
                extend_capacity=1 << (n_reps - 1).bit_length())
        v = valid.cpu().numpy()
        out = MatchArray(starts.cpu().numpy()[v].astype(np.int64),
                         lengths.cpu().numpy()[v].astype(np.int64)).dedup()
        if min_multiplicity > 2:
            keep = out.multiplicity() >= min_multiplicity
            out = MatchArray(out.starts[keep], out.lengths[keep])
        return out.canonical_sort()
    keys, seg_off, content, src = _seed_table(smls)
    flags = ops_mums.mum_seed_flags(content, src, keys, seg_off,
                                    repeat_tolerance, repeat_limit,
                                    sentinel_content(seed))

    n_rows = flags.n_rows
    kept = flags.kept_occ.cpu().numpy()
    if n_rows == 0 or not kept.any():
        return MatchArray.empty(G)

    rid = flags.row_id.cpu().numpy()[kept]
    g = flags.gid.cpu().numpy()[kept]
    p = flags.pos.cpu().numpy()[kept].astype(np.int64)
    st = flags.strand.cpu().numpy()[kept]
    ref_st = flags.ref_strand.cpu().numpy()[kept]

    starts = np.zeros((n_rows, G), dtype=np.int64)
    sign = np.where(st == ref_st, 1, -1).astype(np.int64)
    starts[rid, g] = sign * (p + 1)

    if seq_mask:
        want = np.array([(seq_mask >> (G - 1 - gi)) & 1 for gi in range(G)],
                        dtype=bool)
        starts = starts[((starts != 0) == want[None, :]).all(axis=1)]
        n_rows = len(starts)
        if n_rows == 0:
            return MatchArray.empty(G)

    seed_len = smls[0].seed_length
    lengths = np.full((n_rows,), seed_len, dtype=np.int64)
    if extend:
        starts, lengths = _cluster_reduce_np(starts, lengths, seed_len)
        starts, lengths = _extend_rows(smls, starts, lengths)
    out = MatchArray(starts, lengths).dedup()
    if min_multiplicity > 2:
        out = MatchArray(out.starts[out.multiplicity() >= min_multiplicity],
                         out.lengths[out.multiplicity() >= min_multiplicity])
    return out.canonical_sort()


def _chunk_rows_to_matches(smls, keys, seg_off, content, src,
                           repeat_limit: int) -> MatchArray:
    """Seed enumeration (K13), host clustering and extension (K2) of one
    content-range slice (content, src) of the device seed table
    (libmems_tpu/matchfind.py:956-984)."""
    G = len(smls)
    flags = ops_mums.mum_seed_flags(content, src, keys, seg_off, 0,
                                    repeat_limit,
                                    sentinel_content(smls[0].seed))
    n_rows = flags.n_rows
    kept = flags.kept_occ.cpu().numpy()
    if n_rows == 0 or not kept.any():
        return MatchArray.empty(G)
    rid = flags.row_id.cpu().numpy()[kept]
    g = flags.gid.cpu().numpy()[kept]
    p = flags.pos.cpu().numpy()[kept].astype(np.int64)
    st = flags.strand.cpu().numpy()[kept]
    ref_st = flags.ref_strand.cpu().numpy()[kept]
    starts = np.zeros((n_rows, G), dtype=np.int64)
    starts[rid, g] = np.where(st == ref_st, 1, -1).astype(np.int64) * (p + 1)
    seed_len = smls[0].seed_length
    lengths = np.full((n_rows,), seed_len, dtype=np.int64)
    starts, lengths = _cluster_reduce_np(starts, lengths, seed_len)
    starts, lengths = _extend_rows(smls, starts, lengths)
    return MatchArray(starts, lengths)


@cuda.entry(_run_device)
def find_mums_checkpointed(genomes_or_smls, state_path: str,
                           seed: int | None = None, n_chunks: int = 8,
                           repeat_limit: int = MER_REPEAT_LIMIT,
                           min_multiplicity: int = 2,
                           device="cuda") -> MatchArray:
    """Resumable multi-MUM search (libmems_tpu/matchfind.py:987-1065):
    the analog of the reference's match-search checkpointing
    (MemHash::FindMatchesFromPosition + the SML offset log,
    libMems/MemHash.cpp:109-127, MatchFinder.h:75-81, and
    MemHash::WriteFile/LoadFile, cpp:266-327).

    The sorted seed table stays on `device` (the SMLs' device when SMLs
    are given).  Its canonical-content order is cut at run starts into
    n_chunks ranges, exactly where the JAX package cuts it, and the
    ranges run in order, each through K13, the host clustering and K2.
    After each range the partial match list (match-list v3) is written to
    state_path + ".matches" and the cursor {seed, n_chunks, next_chunk,
    total_windows} to state_path + ".json", each replaced atomically and
    byte for byte as the JAX package writes them, so a state written by
    either package resumes in the other.  A state for another seed,
    window total or n_chunks restarts; a completed one returns its list
    without searching.  The result equals find_mums (no equal-content
    run straddles a cut, and extension probes the whole genomes)."""
    smls, seed_pat = _as_smls(genomes_or_smls, seed, device)
    G = len(smls)
    meta_path = state_path + ".json"
    matches_path = state_path + ".matches"
    total = sum(s.n_windows for s in smls)

    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
        if meta.get("seed") != int(seed_pat) or \
                meta.get("total_windows") != total or \
                meta.get("n_chunks") != n_chunks:
            meta = None  # stale state for other inputs: restart
    acc = MatchArray.empty(G)
    next_chunk = 0
    if meta is not None:
        next_chunk = int(meta["next_chunk"])
        if os.path.exists(matches_path):
            acc, _, _ = read_match_list(matches_path)

    def finalize(m: MatchArray) -> MatchArray:
        m = m.dedup()
        if min_multiplicity > 2:
            keep = m.multiplicity() >= min_multiplicity
            m = MatchArray(m.starts[keep], m.lengths[keep])
        return m.canonical_sort()

    if meta is not None and next_chunk >= n_chunks:
        return finalize(acc)

    keys, seg_off, content, src = _seed_table(smls)
    # cuts at run starts, so no equal-content run straddles two ranges
    cuts = [0]
    for c in range(1, n_chunks):
        b = 0
        if total:
            at = min(c * total // n_chunks, total - 1)
            b = int(torch.searchsorted(content, content[at:at + 1]))
        cuts.append(max(b, cuts[-1]))
    cuts.append(total)

    filenames = [getattr(s, "filename", "") or "null" for s in smls]
    seq_lengths = [int(s.length) for s in smls]
    for c in range(next_chunk, n_chunks):
        lo, hi = cuts[c], cuts[c + 1]
        if hi > lo:
            part = _chunk_rows_to_matches(smls, keys, seg_off,
                                          content[lo:hi], src[lo:hi],
                                          repeat_limit)
            if part.n_matches:
                acc = MatchArray.concat([acc, part])
        write_match_list(matches_path + ".tmp", acc, filenames, seq_lengths)
        os.replace(matches_path + ".tmp", matches_path)
        with open(meta_path + ".tmp", "w") as fh:
            json.dump({"seed": int(seed_pat), "n_chunks": n_chunks,
                       "next_chunk": c + 1, "total_windows": total}, fh)
        os.replace(meta_path + ".tmp", meta_path)
    return finalize(acc)


def _find_mums_enumerated(smls, repeat_tolerance: int,
                          enumeration_tolerance: int, repeat_limit: int,
                          min_multiplicity: int, extend: bool,
                          seq_mask: int = 0
                          ) -> MatchArray:
    """Host orchestration of the enumeration_tolerance>1 semantics:
    per surviving seed run, emit every cross-genome combination of each
    genome's first `enumeration_tolerance` occurrences (position order),
    with per-combination strand reference = the combination's first
    occurrence (MemHash::EnumerateMatches -> MatchFinder::
    EnumerateMatches odometer + SetDirection, MemHash.cpp:139-203).

    The odometer is fully vectorized: per-run mixed-radix strides turn
    the cross product into one flat index calculation over all
    combinations of all runs at once (the array generalization of the
    fori_loop pair expansion; no per-run interpreter loop)."""
    G = len(smls)
    et = enumeration_tolerance
    keys, seg_off, content, src = _seed_table(smls)
    gid, pos, strand = ops_pairwise.seed_table_meta(src, keys, seg_off)
    content, gid, pos, strand = (x.cpu().numpy() for x in
                                 (content, gid, pos, strand))
    n = len(content)
    if n == 0:
        return MatchArray.empty(G)
    # reference arrival order within a genome's run is SML order =
    # (canonical key, pos) = (strand bit, pos) within equal content
    order = np.lexsort((pos, strand, gid, content))
    content, gid, pos, strand = (x[order] for x in
                                 (content, gid, pos, strand))
    # masked-window sentinel runs never enumerate
    sent_c = sentinel_content(smls[0].seed)
    run_start = np.concatenate([[True], content[1:] != content[:-1]])
    sub_start = run_start | np.concatenate(
        [[True], gid[1:] != gid[:-1]])
    run_id = np.cumsum(run_start) - 1
    # per-(run, gid) occurrence rank
    idx = np.arange(n)
    sub_first = idx[sub_start][np.cumsum(sub_start) - 1]
    occ_rank = idx - sub_first
    # per-run per-genome counts + run survival
    counts = np.zeros((run_id[-1] + 1, G), dtype=np.int64)
    np.add.at(counts, (run_id, gid), 1)
    run_len = counts.sum(axis=1)
    survive = (counts.max(axis=1) <= repeat_tolerance + 1) \
        & ((counts > 0).sum(axis=1) >= 2) & (run_len <= repeat_limit) \
        & (content[np.flatnonzero(run_start)] != sent_c)
    if seq_mask:
        want = np.array([(seq_mask >> (G - 1 - gi)) & 1
                         for gi in range(G)], dtype=bool)
        survive &= ((counts > 0) == want[None, :]).all(axis=1)

    seed_len = smls[0].seed_length
    sel_runs = np.flatnonzero(survive)
    if len(sel_runs) == 0:
        return MatchArray.empty(G)
    Rn = len(sel_runs)
    run_map = np.full(counts.shape[0], -1, dtype=np.int64)
    run_map[sel_runs] = np.arange(Rn)

    kept = survive[run_id] & (occ_rank < et)
    k = np.flatnonzero(kept)
    rix = run_map[run_id[k]]
    pos_tab = np.zeros((Rn, G, et), dtype=np.int64)
    str_tab = np.zeros((Rn, G, et), dtype=np.uint8)
    pos_tab[rix, gid[k], occ_rank[k]] = pos[k]
    str_tab[rix, gid[k], occ_rank[k]] = strand[k]

    kc = np.minimum(counts[sel_runs], et)            # [Rn, G]
    kc1 = np.maximum(kc, 1)
    # mixed-radix strides: stride[:, g] = prod_{g' > g} kc1[:, g']
    rev_cp = np.cumprod(kc1[:, ::-1], axis=1)[:, ::-1]
    n_combos = rev_cp[:, 0]
    stride = np.concatenate(
        [rev_cp[:, 1:], np.ones((Rn, 1), dtype=np.int64)], axis=1)
    offs = np.concatenate([[0], np.cumsum(n_combos)[:-1]])
    T = int(n_combos.sum())
    t_run = np.repeat(np.arange(Rn), n_combos)
    t_loc = np.arange(T, dtype=np.int64) - offs[t_run]
    occ_sel = (t_loc[:, None] // stride[t_run]) % kc1[t_run]  # [T, G]
    present = kc[t_run] > 0
    t_ar = np.arange(T)
    pos_sel = pos_tab[t_run[:, None], np.arange(G)[None, :], occ_sel]
    str_sel = str_tab[t_run[:, None], np.arange(G)[None, :], occ_sel]
    first_g = np.argmax(kc > 0, axis=1)[t_run]
    ref_st = str_sel[t_ar, first_g]
    sign = np.where(str_sel == ref_st[:, None], 1, -1)
    starts = np.where(present, sign * (pos_sel + 1), 0)
    lengths = np.full((T,), seed_len, dtype=np.int64)
    if extend:
        starts, lengths = _cluster_reduce_np(starts, lengths, seed_len)
        starts, lengths = _extend_rows(smls, starts, lengths)
    out = MatchArray(starts, lengths).dedup()
    s2, l2 = _containment_filter(out.starts, out.lengths)
    out = MatchArray(s2, l2)
    if min_multiplicity > 2:
        keep = out.multiplicity() >= min_multiplicity
        out = MatchArray(out.starts[keep], out.lengths[keep])
    return out.canonical_sort()


# --------------------------------------------------------------------------
# pairwise seeder (progressive alignment)
# --------------------------------------------------------------------------

# expansion-table budget of the pairwise seeder: (G-1) * n rows
_PAIRWISE_FUSED_MAX_ROWS = 1 << 28


def pairwise_fused_fits(G: int, pos_bits: int) -> bool:
    """Word-budget test of the pairwise seeder: the cluster word
    fwd(1) | pair_id(2*ceil(log2(G-1))) | delta(pos_bits+2) |
    posA(pos_bits) must fit 64 bits (libmems_tpu/matchfind.py:1245; the
    port derives gid and pos per row, so it packs no kept-row word)."""
    return 1 + ops_pairwise.pair_bits_for(G) + 2 * pos_bits + 2 <= 64 \
        and G <= 62


@cuda.entry(_run_device)
def find_pairwise_mums(genomes_or_smls, seed: int | None = None,
                       repeat_limit: int = MER_REPEAT_LIMIT,
                       extend: bool = True,
                       extend_capacity: int = 1 << 14,
                       device="cuda") -> MatchArray:
    """Find all pairwise MUMs from per-genome-unique seeds
    (PairwiseMatchFinder::EnumerateMatches equivalent,
    libMems/PairwiseMatchFinder.cpp:37-71) — the progressiveMauve seeder.

    Port of the fused device pipeline of libmems_tpu/matchfind.py
    (find_pairwise_mums -> _fused_pairwise_pipeline -> _pairwise_core):
    stable sort of the concatenated contents (the (content, gid, pos)
    order) -> run flags (K5) -> shifted-compare cluster words (K6) ->
    unsigned sort -> representatives (K7: one scan, then the decode at
    the capacity their count asks for) -> span-seeded extension (K2).
    Genomes are indexed on `device`; SMLs are used where they lie.  The
    JAX package's bucket padding only added sentinel rows to the masked
    run, so the port works on the exact windows.  ``extend=False``, a
    cluster word beyond 64 bits and an expansion table beyond
    _PAIRWISE_FUSED_MAX_ROWS take the host orchestration
    (_find_pairwise_mums_host), as in the JAX package."""
    smls, seed = _as_smls(genomes_or_smls, seed, device)
    G = len(smls)
    cnts = [s.n_windows for s in smls]
    total = sum(cnts)
    if total == 0:
        return MatchArray.empty(G)
    pos_bits = _pair_pos_bits(max(cnts))
    if not (extend and pairwise_fused_fits(G, pos_bits)
            and (G - 1) * total <= _PAIRWISE_FUSED_MAX_ROWS):
        return _find_pairwise_mums_host(smls, repeat_limit, extend)
    seed_len = smls[0].seed_length
    chunk = max(seed_len, 256)
    keys, seg_off, content_sorted, src = _seed_table(smls)
    gen_off = seg_off[:-1].to(torch.int32)
    gen_cnt = (seg_off[1:] - seg_off[:-1]).to(torch.int32)
    flags = ops_pairwise.run_flags(content_sorted, src, keys, seg_off,
                                   repeat_limit, sentinel_content(seed))
    del content_sorted, src
    cw = _usort(ops_pairwise.cluster_words(flags, G, pos_bits))
    del flags

    # K7 finds the representatives in one scan, the capacity follows
    idx = ops_pairwise.rep_index(cw, pos_bits, seed_len)
    ec = ops_pairwise.rep_capacity(
        min(extend_capacity, 1 << (max(total, 2) - 1).bit_length()),
        idx.n_reps)
    reps = ops_pairwise.decode_reps(cw, idx, ec, G, pos_bits, seed_len,
                                    gen_off, gen_cnt)
    del cw, idx
    if reps.n_reps == 0:
        return MatchArray.empty(G)
    # the exact-row dedup of the JAX pipeline is MatchArray.dedup here
    return pairwise_rows(keys, seed_len, chunk, reps, G,
                         seed).dedup().canonical_sort()


def pairwise_rows(keys, seed_len: int, chunk: int, reps, G: int,
                  seed: int) -> MatchArray:
    """K7's first n_reps representatives extended (K2) against keys, the
    position-order concatenation of the genomes' keys, as [n, G] rows
    (matchfind.py:1219-1225), not deduplicated."""
    n = reps.n_reps
    lefts, lengths = extend_matches(
        keys, seed_len, chunk, reps.gen_off[:n], reps.gen_cnt[:n],
        reps.lefts[:n], reps.present[:n], reps.is_fwd[:n],
        reps.lengths0[:n], key_sentinel(seed))
    sign_b = torch.where(reps.is_fwd[:n, 1], 1, -1).to(torch.int32)
    starts = torch.zeros((n, G), dtype=torch.int32, device=keys.device)
    starts.scatter_(1, reps.r_a[:n, None].to(torch.int64), lefts[:, :1] + 1)
    starts.scatter_(1, reps.r_b[:n, None].to(torch.int64),
                    (sign_b * (lefts[:, 1] + 1))[:, None])
    return MatchArray(starts.cpu().numpy().astype(np.int64),
                      lengths.cpu().numpy().astype(np.int64))


def _find_pairwise_mums_host(smls, repeat_limit: int = MER_REPEAT_LIMIT,
                             extend: bool = True) -> MatchArray:
    """Host-orchestrated PairwiseMatchFinder
    (libmems_tpu/matchfind.py:1344-1394): run flags on the SMLs' device
    (K5), the per-genome-unique rows fetched to the host, every genome
    pair of each run expanded in numpy, clustered, and extended on the
    device (K2).  The fused path's fallback and its parity oracle."""
    G = len(smls)
    keys, seg_off, content, src = _seed_table(smls)
    if keys.shape[0] == 0:
        return MatchArray.empty(G)
    flags = ops_pairwise.run_flags(content, src, keys, seg_off, repeat_limit,
                                   sentinel_content(smls[0].seed))
    del content, src
    uo = flags.unique_occ
    if not bool(uo.any()):
        return MatchArray.empty(G)
    # only the kept rows leave the device
    runs = flags.run_id[uo].cpu().numpy()
    g = flags.gid[uo].cpu().numpy()
    p = flags.pos[uo].cpu().numpy().astype(np.int64)
    st = flags.strand[uo].cpu().numpy()
    del flags, uo

    # expand each run's unique occurrences into all genome pairs
    run_change = np.concatenate([[True], runs[1:] != runs[:-1]])
    run_first = np.flatnonzero(run_change)
    run_count = np.diff(np.concatenate([run_first, [len(runs)]]))
    # pair index construction: for each run with k>=2 occurrences, emit
    # all (i, j) with i<j, as global indices into the kept-occurrence list
    ks = run_count
    total = int(((ks * (ks - 1)) // 2).sum())
    if total == 0:
        return MatchArray.empty(G)
    # expand per distinct occurrence-count k (k <= G, so few iterations)
    ai_parts, bi_parts = [], []
    for k in np.unique(ks):
        if k < 2:
            continue
        base = run_first[ks == k]
        ii, jj = np.triu_indices(int(k), 1)
        ai_parts.append((base[:, None] + ii[None, :]).ravel())
        bi_parts.append((base[:, None] + jj[None, :]).ravel())
    a_idx = np.concatenate(ai_parts)
    b_idx = np.concatenate(bi_parts)
    total = len(a_idx)

    starts = np.zeros((total, G), dtype=np.int64)
    sign_b = np.where(st[b_idx] == st[a_idx], 1, -1).astype(np.int64)
    starts[np.arange(total), g[a_idx]] = p[a_idx] + 1
    starts[np.arange(total), g[b_idx]] = sign_b * (p[b_idx] + 1)

    seed_len = smls[0].seed_length
    lengths = np.full((total,), seed_len, dtype=np.int64)
    if extend:
        starts, lengths = _cluster_reduce_np(starts, lengths, seed_len)
        starts, lengths = _extend_rows(smls, starts, lengths)
    return MatchArray(starts, lengths).dedup().canonical_sort()


# --------------------------------------------------------------------------
# host (numpy) pair path — exact twin of the pair pipeline
# --------------------------------------------------------------------------

# below this many total seed windows a single-core numpy run beats a
# device round trip (the gap-search workloads are thousands of small
# fragment pairs)
HOST_PAIR_CUTOFF = int(os.environ.get("LIBMEMS_TPU_HOST_PAIR_CUTOFF",
                                      1 << 16))


def _find_mums_cpu_one_thread(codes_a, codes_b, seed, ambig_a, ambig_b):
    """find_mums of a pair on CPU tensors with one intra-op thread (an
    OpenMP pool inherited through fork may not run in the child)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return find_mums([
            SortedMerList.create(codes_a, seed, ambig=ambig_a, device="cpu"),
            SortedMerList.create(codes_b, seed, ambig=ambig_b,
                                 device="cpu")])
    finally:
        torch.set_num_threads(threads)


def find_pair_mums_np(codes_a: np.ndarray, codes_b: np.ndarray,
                      seed: int, ambig_a: np.ndarray | None = None,
                      ambig_b: np.ndarray | None = None) -> MatchArray:
    """Single-core numpy twin of the pair pipeline (identical algorithm:
    pack -> sort -> exact-pair neighbour flags -> diagonal cluster sort
    -> representative compaction -> span-seeded extension -> dedup).
    It runs in recursion's fork pool, so it never touches CUDA: where the
    packed pair word would exceed 64 bits it runs the general pipeline of
    ``find_mums`` on CPU tensors, as the JAX twin runs its device one."""
    from libmems_tpu_torch.ops.mers import canonical_seed_keys_np

    seed_len = seedlib.seed_length(seed)
    km_a = canonical_seed_keys_np(codes_a, seed, ambig_a)
    km_b = canonical_seed_keys_np(codes_b, seed, ambig_b)
    key_sent = np.uint64(~km_a.dtype.type(0))  # masked-window sentinel
    ka = km_a.astype(np.uint64)
    kb = km_b.astype(np.uint64)
    na, nb = len(ka), len(kb)
    if na == 0 or nb == 0:
        return MatchArray.empty(2)
    pb = max(int(max(na, nb)).bit_length(), 8)
    if 2 * seedlib.seed_weight(seed) + 2 + pb > 64:
        # the packed word would overflow (distinct seeds would collide):
        # run the general pipeline as the JAX twin does, on CPU tensors
        # and in one thread, since a forked pool worker may run this
        return _find_mums_cpu_one_thread(codes_a, codes_b, seed, ambig_a,
                                         ambig_b)

    def pack(keys, gid):
        content = keys >> np.uint64(1)
        strand = keys & np.uint64(1)
        pos = np.arange(len(keys), dtype=np.uint64)
        return (content << np.uint64(pb + 2)) \
            | (np.uint64(gid) << np.uint64(pb + 1)) \
            | (pos << np.uint64(1)) | strand

    w = np.sort(np.concatenate([pack(ka, 0), pack(kb, 1)]))
    c = w >> np.uint64(pb + 2)
    gid = (w >> np.uint64(pb + 1)) & np.uint64(1)
    pos = ((w >> np.uint64(1)) & np.uint64((1 << pb) - 1)).astype(np.int64)
    strand = w & np.uint64(1)
    c1 = np.concatenate([c[1:], [~np.uint64(0)]])
    c2 = np.concatenate([c[2:], [~np.uint64(0)] * 2])
    cp = np.concatenate([[~np.uint64(0)], c[:-1]])
    g1 = np.concatenate([gid[1:], [np.uint64(0)]])
    sent_c = key_sent >> np.uint64(1)
    surv = (c == c1) & (c != cp) & (c1 != c2) & (gid == 0) & (g1 == 1) \
        & (c != sent_c)
    if not surv.any():
        return MatchArray.empty(2)
    posA = pos[surv]
    posB = np.concatenate([pos[1:], [0]])[surv]
    fwd = (strand == np.concatenate([strand[1:], [np.uint64(0)]]))[surv]

    delta = np.where(fwd, posB - posA + (1 << pb), posB + posA)
    order = np.lexsort((posA, delta, ~fwd))
    pA, dl, fw, pB = posA[order], delta[order], fwd[order], posB[order]
    same = np.concatenate([[False], (dl[1:] == dl[:-1])
                           & (fw[1:] == fw[:-1])])
    gap_ok = np.concatenate([[False], pA[1:] - pA[:-1] <= seed_len])
    rep = ~(same & gap_ok)
    rep_idx = np.flatnonzero(rep)
    ends = np.concatenate([rep_idx[1:] - 1, [len(pA) - 1]])
    r_pA, r_pB, r_fw = pA[rep_idx], pB[rep_idx], fw[rep_idx]
    last_pA = pA[ends]
    span = last_pA - r_pA
    lengths = span + seed_len
    leftB = np.where(r_fw, r_pB, dl[rep_idx] - last_pA)

    keys_all = [ka, kb]
    cnts = np.array([na, nb])

    def extend_side(lefts, lengths, side):
        active = np.ones(len(lengths), dtype=bool)
        C0 = 4 * seed_len
        C = C0
        while active.any():
            d = np.arange(1, C + 1)
            ai = np.flatnonzero(active)
            matchm = np.ones((len(ai), C), dtype=bool)
            for g in range(2):
                fwd_g = np.ones(len(ai), bool) if g == 0 else r_fw[ai]
                l = lefts[ai, g]
                back_q = l[:, None] - d[None, :]
                ahead_q = l[:, None] + lengths[ai, None] - seed_len \
                    + d[None, :]
                q = np.where(fwd_g[:, None],
                             back_q if side == 0 else ahead_q,
                             ahead_q if side == 0 else back_q)
                validq = (q >= 0) & (q < cnts[g])
                kq = keys_all[g][np.clip(q, 0, cnts[g] - 1)]
                # masked windows (sentinel ~0, low bit may be parity-
                # flipped below) never match
                validq &= (kq | np.uint64(1)) != (key_sent | np.uint64(1))
                kq = kq ^ fwd_g[:, None].astype(kq.dtype)
                if g == 0:
                    refk = kq
                    refv = validq
                else:
                    matchm &= validq & refv & (kq == refk)
            dm = np.where(matchm, d[None, :], 0)
            pm = np.maximum.accumulate(dm, axis=1)
            pm_excl = np.concatenate(
                [np.zeros((len(ai), 1), np.int64), pm[:, :-1]], axis=1)
            bad = matchm & (d[None, :] - pm_excl > seed_len)
            first_bad = np.where(bad.any(axis=1),
                                 np.argmax(bad, axis=1) + 1, C + 1)
            reach = np.max(np.where(matchm & (d[None, :]
                                              < first_bad[:, None]),
                                    d[None, :], 0), axis=1)
            for g in range(2):
                fwd_g = np.ones(len(ai), bool) if g == 0 else r_fw[ai]
                mv = fwd_g if side == 0 else ~fwd_g
                lefts[ai[mv], g] -= reach[mv]
            lengths[ai] += reach
            active[ai] = reach + seed_len > C
            C = 8 * C0  # survivors are long: escalate the probe window
        return lefts, lengths

    lefts = np.stack([r_pA, leftB], axis=1).astype(np.int64)
    lengths = lengths.astype(np.int64)
    lefts, lengths = extend_side(lefts, lengths, 0)
    lefts, lengths = extend_side(lefts, lengths, 1)
    starts = np.stack([lefts[:, 0] + 1,
                       np.where(r_fw, 1, -1) * (lefts[:, 1] + 1)], axis=1)
    return MatchArray(starts, lengths).dedup().canonical_sort()
