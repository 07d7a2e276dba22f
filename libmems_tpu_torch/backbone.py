"""Backbone detection: merge pairwise homology predictions into
multi-genome backbone segments and write the backbone file formats.

Port of libmems_tpu/backbone.py (imports renamed; the pairwise HMM runs
on an explicit `device`, kernel K8).  Equivalent of
libMems/Backbone.{h,cpp}:

* detect_backbone — detectAndApplyBackbone (Backbone.h:65-71): per
  interval, per genome pair, HMM HSS detection (HomologyHmmDetector,
  batched on device via libmems_tpu_torch.islands/ops.hmm) →
  makeAllPairwiseGenomeHSS (Backbone.cpp:315);
* merge across pairs — mergePairwiseHomologyPredictions
  (Backbone.cpp:465): a genome participates in a backbone column iff it
  is HMM-homologous to at least one other genome there; maximal column
  runs with identical participation sets become backbone segments;
* compute_gc — computeGC (Backbone.cpp:298), feeding the GC-adapted HMM
  emission parameters;
* write_backbone_columns / write_backbone_seq_coordinates — the bbcols
  and bbseq file formats (Backbone.h:183-231);
* unaligning of non-homologous rows (unalignIslands, Backbone.cpp:672)
  is applied at render time via the participation masks rather than by
  rewriting interval objects — the XMFA content is identical (islands
  become gap rows in backbone output and separate unaligned segments).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from libmems_tpu_torch import cuda
from libmems_tpu_torch.interval import IntervalList
from libmems_tpu_torch.islands import (HssCols, find_big_gaps,
                                 find_hss_homology_batch)
from libmems_tpu_torch.ops.hmm import HmmParams, adapted_hoxd_params
from libmems_tpu_torch.scoring import GAP
from libmems_tpu_torch.sequence import Genome


@dataclass
class BackboneSegment:
    """One multi-genome backbone segment."""

    interval: int               # interval index in the IntervalList
    left_col: int               # inclusive column range
    right_col: int
    genomes: list[int]          # participating genome indices
    seq_ranges: np.ndarray      # int64[G, 2] signed (left, right), 0 = absent


def compute_gc(genomes: list[Genome]) -> float:
    """Fraction G/C over all genomes (computeGC, Backbone.cpp:298)."""
    gc = 0
    total = 0
    for g in genomes:
        codes = g.codes
        gc += int(((codes == 1) | (codes == 2)).sum())
        total += len(codes)
    return gc / max(total, 1)


def _interval_participation(ivs: IntervalList, params: HmmParams | None,
                            big_gap_size: int = 10000, device="cuda"
                            ) -> tuple[list[np.ndarray],
                                       dict[int, np.ndarray]]:
    """Batched per-interval pairwise HMM homology -> per-column
    participation masks (makeAllPairwiseGenomeHSS +
    mergePairwiseHomologyPredictions, Backbone.cpp:315,465: a genome
    participates in a column iff it is HMM-homologous to >=1 partner
    there; ULA boundaries fall where any participation bit changes —
    the column-mask union is the partition-refinement the reference's
    applyBreakpoints loop computes with ULA lists).

    The HMM composes with the BigGapsDetector exactly like the
    reference's detector stack (Backbone.h:88-126, Islands.h:363-412):
    each pairwise projection is first split at single-genome gap runs
    longer than `big_gap_size`, the HMM scores each sub-segment
    independently, and the big gaps themselves are never homologous —
    a megabase indel no longer reaches (or stalls) the HMM scan.

    Returns (rendered rows per interval, {ivI: bool[G, C]})."""
    genomes = ivs.genomes
    G = len(genomes)
    if params is None:
        params = adapted_hoxd_params(compute_gc(genomes))

    from libmems_tpu_torch import trace
    jobs = []
    job_meta = []
    rendered = []
    with trace.stage("bb_encode"):
        for ivI, iv in enumerate(ivs.intervals):
            rows = iv.render(genomes)
            rendered.append(rows)
            present = [g for g in range(G)
                       if int(iv.left_ends()[g]) != 0]
            if len(present) < 2:
                continue
            for a in range(len(present)):
                for b in range(a + 1, len(present)):
                    pa, pb = present[a], present[b]
                    for seg in find_big_gaps(rows[pa], rows[pb], pa, pb,
                                             big_gap_size):
                        lo, hi = seg.left_col, seg.right_col + 1
                        jobs.append((rows[pa][lo:hi], rows[pb][lo:hi],
                                     pa, pb))
                        job_meta.append((ivI, lo))
    with trace.stage("bb_hmm"):
        all_hss = find_hss_homology_batch(jobs, params, device=device)

    per_iv_part: dict[int, np.ndarray] = {}
    for hss_list, (ivI, off) in zip(all_hss, job_meta):
        rows = rendered[ivI]
        part = per_iv_part.setdefault(
            ivI, np.zeros((G, rows.shape[1]), dtype=bool))
        for h in hss_list:
            part[h.seqI, off + h.left_col:off + h.right_col + 1] = True
            part[h.seqJ, off + h.left_col:off + h.right_col + 1] = True
    return rendered, per_iv_part


@cuda.entry(cuda.device_arg)
def detect_backbone(ivs: IntervalList,
                    params: HmmParams | None = None,
                    min_bb_length: int = 0,
                    big_gap_size: int = 10000,
                    device="cuda") -> list[BackboneSegment]:
    """Per-interval pairwise HMM homology → transitive merge →
    backbone segments (detectAndApplyBackbone minus interval rewriting).
    """
    genomes = ivs.genomes
    G = len(genomes)
    segments: list[BackboneSegment] = []
    rendered, per_iv_part = _interval_participation(ivs, params,
                                                    big_gap_size, device)

    for ivI, part in sorted(per_iv_part.items()):
        iv = ivs.intervals[ivI]
        rows = rendered[ivI]
        nongap = rows != GAP
        cum = _chars_before(nongap)
        part = part & nongap
        # maximal runs of identical participation sets with >=2 members
        C = part.shape[1]
        counts = part.sum(axis=0)
        ok = counts >= 2
        change = np.ones(C, dtype=bool)
        change[1:] = (part[:, 1:] != part[:, :-1]).any(axis=0)
        run_starts = np.flatnonzero(change)
        run_ends = np.concatenate([run_starts[1:] - 1, [C - 1]])
        for lo, hi in zip(run_starts, run_ends):
            if not ok[lo]:
                continue
            members = np.flatnonzero(part[:, lo])
            if hi - lo + 1 < min_bb_length:
                continue
            seq_ranges = _segment_seq_ranges(iv, cum, int(lo), int(hi),
                                             members)
            segments.append(BackboneSegment(
                interval=ivI, left_col=int(lo), right_col=int(hi),
                genomes=[int(m) for m in members],
                seq_ranges=seq_ranges))
    return segments


def _chars_before(nongap: np.ndarray) -> np.ndarray:
    """int64[G, C + 1]: per row, the characters left of each column (one
    prefix sum an interval, so a column range's coordinates cost O(1):
    an interval of a large genome holds thousands of ranges)."""
    cum = np.zeros((nongap.shape[0], nongap.shape[1] + 1), dtype=np.int64)
    np.cumsum(nongap, axis=1, out=cum[:, 1:])
    return cum


def _segment_seq_ranges(iv, cum, lo: int, hi: int,
                        members: np.ndarray) -> np.ndarray:
    """Signed per-genome sequence coordinates of a column range; cum is
    _chars_before of the interval's rows."""
    G = cum.shape[0]
    out = np.zeros((G, 2), dtype=np.int64)
    starts = iv.starts()
    for g in members:
        chars_before = int(cum[g, lo])
        chars_in = int(cum[g, hi + 1]) - chars_before
        if chars_in == 0:
            continue
        s = int(starts[g])
        L = int(cum[g, -1])
        if s > 0:
            left = s + chars_before
            right = left + chars_in - 1
            out[g] = (left, right)
        else:
            right = (-s + L - 1) - chars_before
            left = right - chars_in + 1
            out[g] = (-left, -right)
    return out


def _row_block_coords(iv, cum, lo: int, hi: int,
                      members: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts, lengths) of a column range's member rows (signed)."""
    G = cum.shape[0]
    starts = np.zeros(G, dtype=np.int64)
    lengths = np.zeros(G, dtype=np.int64)
    ranges = _segment_seq_ranges(iv, cum, lo, hi, members)
    for g in members:
        l, r = int(ranges[g, 0]), int(ranges[g, 1])
        if l == 0 and r == 0:
            continue
        if l > 0:
            starts[g] = l
            lengths[g] = r - l + 1
        else:
            # reverse row: ranges are (-left, -right) with left <= right
            starts[g] = l
            lengths[g] = l - r + 1
    return starts, lengths


@cuda.entry(cuda.device_arg)
def apply_backbone(ivs: IntervalList,
                   params: HmmParams | None = None,
                   min_bb_length: int = 0,
                   big_gap_size: int = 10000,
                   device="cuda"
                   ) -> tuple[IntervalList, list[BackboneSegment]]:
    """detectAndApplyBackbone with interval rewriting (Backbone.h:65-71,
    unalignIslands Backbone.cpp:672-824): island characters — columns
    where a genome is homologous to NO partner — are pulled out of the
    shared columns into their own single-genome staircase blocks, so the
    written XMFA no longer claims alignment for non-homologous rows.
    Genome groups left with no shared blocks split into separate
    intervals (the reference's union-find + topological re-sort).

    Returns (rewritten IntervalList, backbone segments in rewritten
    column coordinates)."""
    from libmems_tpu_torch.interval import Block, Interval

    genomes = ivs.genomes
    G = len(genomes)
    rendered, per_iv_part = _interval_participation(ivs, params,
                                                    big_gap_size, device)

    new_intervals: list = []
    segments: list[BackboneSegment] = []
    for ivI, iv in enumerate(ivs.intervals):
        if ivI not in per_iv_part:
            new_intervals.append(iv)
            continue
        rows = rendered[ivI]
        part = per_iv_part[ivI] & (rows != GAP)
        C = part.shape[1]
        counts = part.sum(axis=0)
        # drop single-genome "participation" (no partner in the column)
        part[:, counts < 2] = False

        change = np.ones(C, dtype=bool)
        change[1:] = (part[:, 1:] != part[:, :-1]).any(axis=0)
        run_starts = np.flatnonzero(change)
        run_ends = np.concatenate([run_starts[1:] - 1, [C - 1]])

        blocks: list[tuple[Block, list[int]]] = []  # (block, members)
        seg_plans: list[tuple[int, list[int], np.ndarray]] = []
        nongap = rows != GAP
        cum = _chars_before(nongap)
        for lo, hi in zip(run_starts, run_ends):
            lo, hi = int(lo), int(hi)
            members = np.flatnonzero(part[:, lo])
            islanders = np.flatnonzero(nongap[:, lo:hi + 1].any(axis=1)
                                       & ~part[:, lo])
            if members.size >= 2:
                # aligned sub-block: member rows keep their columns
                sub = rows[:, lo:hi + 1].copy()
                sub[[g for g in range(G) if g not in set(members)]] = GAP
                keep_cols = (sub != GAP).any(axis=0)
                sub = sub[:, keep_cols]
                if sub.shape[1]:
                    starts, lens = _row_block_coords(iv, cum, lo, hi,
                                                     members)
                    blocks.append((Block(starts=starts, lengths=lens,
                                         rows=sub),
                                   [int(g) for g in members]))
                    if hi - lo + 1 >= min_bb_length:
                        seg_plans.append(
                            (len(blocks) - 1, [int(g) for g in members],
                             _segment_seq_ranges(iv, cum, lo, hi,
                                                 members)))
            # island rows: one single-genome staircase block each
            for g in islanders:
                starts, lens = _row_block_coords(iv, cum, lo, hi,
                                                 np.array([g]))
                if lens[g] == 0:
                    continue
                blocks.append((Block(starts=starts, lengths=lens,
                                     rows=None), [int(g)]))

        if not blocks:
            new_intervals.append(iv)
            continue

        # union-find split into disjoint genome groups
        parent = list(range(G))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for _, mem in blocks:
            for g in mem[1:]:
                parent[find(g)] = find(mem[0])
        group_of: dict[int, list[int]] = {}
        for bi, (_, mem) in enumerate(blocks):
            group_of.setdefault(find(mem[0]), []).append(bi)

        base = len(new_intervals)
        roots = sorted(group_of)
        for gi, root in enumerate(roots):
            sel = group_of[root]
            col_off = 0
            seg_lookup = {}
            for order, bi in enumerate(sel):
                blk = blocks[bi][0]
                seg_lookup[bi] = col_off
                col_off += blk.n_columns
            new_intervals.append(Interval(
                blocks=[blocks[bi][0] for bi in sel], seq_count=G))
            for bi, mem, ranges in seg_plans:
                if bi in seg_lookup:
                    lo = seg_lookup[bi]
                    ncols = blocks[bi][0].n_columns
                    segments.append(BackboneSegment(
                        interval=base + gi, left_col=lo,
                        right_col=lo + ncols - 1, genomes=mem,
                        seq_ranges=ranges))
    return IntervalList(new_intervals, list(genomes)), segments


# --------------------------------------------------------------------------
# file formats (Backbone.h:183-231)
# --------------------------------------------------------------------------

def write_backbone_seq_coordinates(path_or_fh,
                                   segments: list[BackboneSegment],
                                   seq_count: int):
    """bbseq format: header seqN_leftend/seqN_rightend, one line per
    backbone segment with signed coordinates, 0 0 when absent
    (writeBackboneSeqFile, Backbone.h:184-207)."""
    import os
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "w") if own else path_or_fh
    try:
        fh.write("\t".join(
            f"seq{g}_leftend\tseq{g}_rightend" for g in range(seq_count)))
        fh.write("\n")
        for seg in segments:
            cols = []
            for g in range(seq_count):
                cols.append(str(int(seg.seq_ranges[g, 0])))
                cols.append(str(int(seg.seq_ranges[g, 1])))
            fh.write("\t".join(cols) + "\n")
    finally:
        if own:
            fh.close()


def read_backbone_seq_coordinates(path_or_fh) -> np.ndarray:
    """Read bbseq; returns int64[n_segments, G, 2]."""
    import os
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "r") if own else path_or_fh
    try:
        header = fh.readline()
        G = len(header.split("\t")) // 2
        rows = []
        for line in fh:
            vals = [int(v) for v in line.split()]
            rows.append(np.array(vals, dtype=np.int64).reshape(G, 2))
        return np.stack(rows) if rows else np.zeros((0, G, 2), np.int64)
    finally:
        if own:
            fh.close()


def write_backbone_columns(path_or_fh, segments: list[BackboneSegment]):
    """bbcols format: `ivI left_col len seq...` one line per segment
    (writeBackboneColsFile counterpart of Backbone.h:209-231)."""
    import os
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "w") if own else path_or_fh
    try:
        for seg in segments:
            fh.write(f"{seg.interval}\t{seg.left_col}\t"
                     f"{seg.right_col - seg.left_col + 1}\t")
            fh.write("\t".join(str(g) for g in seg.genomes))
            fh.write("\n")
    finally:
        if own:
            fh.close()
