"""Runtime self-validation checks.

Library equivalents of the reference's debug_aligner-gated invariant
checkers (SURVEY §4.1), usable both as assertions in tests and as
opt-in runtime guards:

* validate_lcb            — validateLCB (libMems/Aligner.cpp:29-60):
  an LCB's matches must be collinear and non-overlapping in every
  participating genome, with consistent relative orientation;
* check_no_all_gap_columns — checkForAllGapColumns
  (libMems/Backbone.cpp:249-271);
* validate_interval       — Interval::ValidateMatches analog
  (libMems/Interval.h:169): rendered character counts must equal the
  declared per-genome lengths, and block coordinates must be contiguous
  per genome in column order;
* validate_partition      — validateSuperIntervals-style coverage check
  (libMems/ProgressiveAligner.cpp:2771-2842): an IntervalList written
  as a full alignment must cover every base of every genome exactly
  once.

Each function raises ValidationError with a specific message.
"""

from __future__ import annotations

import numpy as np

from libmems_tpu_torch.interval import GAP, IntervalList
from libmems_tpu_torch.match import MatchArray, NO_MATCH


class ValidationError(AssertionError):
    pass


def validate_lcb(starts: np.ndarray, lengths: np.ndarray) -> None:
    """Matches of one LCB (genome-0 order): collinear, non-overlapping,
    orientation-consistent per genome (validateLCB, Aligner.cpp:29-60)."""
    n, G = starts.shape
    if n == 0:
        return
    for g in range(G):
        rows = np.flatnonzero(starts[:, g] != NO_MATCH)
        if rows.size < 2:
            continue
        s = starts[rows, g]
        fwd = s > 0
        if not (fwd.all() or (~fwd).all()):
            raise ValidationError(
                f"LCB orientation flips within genome {g}")
        le = np.abs(s)
        re = le + lengths[rows] - 1
        order = le if fwd[0] else -le
        if not (order[1:] > order[:-1]).all():
            raise ValidationError(
                f"LCB matches out of order in genome {g}")
        if fwd[0]:
            if not (le[1:] > re[:-1]).all():
                raise ValidationError(
                    f"LCB matches overlap in genome {g}")
        else:
            if not (re[1:] < le[:-1]).all():
                raise ValidationError(
                    f"LCB matches overlap in genome {g}")


def check_no_all_gap_columns(rows: np.ndarray) -> None:
    """(checkForAllGapColumns, Backbone.cpp:249-271)."""
    if rows.size == 0:
        return
    allgap = (rows == GAP).all(axis=0)
    if allgap.any():
        raise ValidationError(
            f"{int(allgap.sum())} all-gap columns "
            f"(first at {int(np.argmax(allgap))})")


def validate_interval(iv, genomes) -> None:
    """Character counts and per-genome coordinate contiguity of one
    interval (Interval::ValidateMatches analog, Interval.h:169)."""
    G = iv.seq_count
    rows = iv.render(genomes)
    nongap = (rows != GAP).sum(axis=1)
    covered = [[] for _ in range(G)]
    declared = np.zeros(G, dtype=np.int64)
    for blk in iv.blocks:
        for g in range(G):
            if blk.starts[g] == 0:
                continue
            declared[g] += int(blk.lengths[g])
            le = abs(int(blk.starts[g]))
            covered[g].append((le, le + int(blk.lengths[g]) - 1))
    for g in range(G):
        if nongap[g] != declared[g]:
            raise ValidationError(
                f"genome {g}: rendered {int(nongap[g])} chars, blocks "
                f"declare {int(declared[g])}")
        ranges = sorted(covered[g])
        for (a1, b1), (a2, b2) in zip(ranges, ranges[1:]):
            if a2 != b1 + 1:
                raise ValidationError(
                    f"genome {g}: blocks not contiguous "
                    f"({a1}-{b1} then {a2}-{b2})")


def validate_partition(ivs: IntervalList) -> None:
    """Every base of every genome covered exactly once across the
    interval list (validateSuperIntervals coverage analog,
    ProgressiveAligner.cpp:2771-2842)."""
    genomes = ivs.genomes
    G = len(genomes)
    for g in range(G):
        ranges = []
        for iv in ivs.intervals:
            le = int(iv.left_ends()[g])
            if le == 0:
                continue
            ranges.append((le, int(iv.right_ends()[g])))
        ranges.sort()
        cursor = 1
        for a, b in ranges:
            if a != cursor:
                raise ValidationError(
                    f"genome {g}: coverage gap/overlap at {cursor}.."
                    f"{a - 1}")
            cursor = b + 1
        if cursor != len(genomes[g]) + 1:
            raise ValidationError(
                f"genome {g}: covered to {cursor - 1}, length "
                f"{len(genomes[g])}")


def validate_interval_list(ivs: IntervalList,
                           full_partition: bool = True) -> None:
    """All interval checks + (optionally) the whole-genome partition."""
    for iv in ivs.intervals:
        validate_interval(iv, ivs.genomes)
    if full_partition:
        validate_partition(ivs)


def validate_node_alignment(aln, genomes) -> None:
    """Progressive-node invariants — validateSuperIntervals /
    validatePairwiseIntervals analog (libMems/ProgressiveAligner.cpp:
    2771-2940) on a NodeAlignment:

    * every descendant leaf's present blocks partition [1, len(genome)]
      exactly (no gaps, no overlaps, nothing past the end);
    * a row marked absent (start == 0) carries no characters;
    * no block has an all-gap column (checkForAllGapColumns,
      libMems/Backbone.cpp:249-271).
    """
    for row, gid in enumerate(aln.leaf_ids):
        L = len(genomes[gid])
        segs = []
        for bi, blk in enumerate(aln.blocks):
            le = int(blk.left_ends()[row])
            ln = int(blk.lengths()[row])
            if le == 0:
                if ln:
                    raise ValidationError(
                        f"leaf {gid}: block {bi} marked absent but has "
                        f"{ln} characters")
                continue
            if ln == 0:
                raise ValidationError(
                    f"leaf {gid}: block {bi} present at {le} but empty")
            segs.append((le, le + ln - 1, bi))
        segs.sort()
        cur = 0
        for le, re_, bi in segs:
            if le != cur + 1:
                raise ValidationError(
                    f"leaf {gid}: coverage {'gap' if le > cur + 1 else 'overlap'}"
                    f" at {le} (expected {cur + 1}) entering block {bi}")
            cur = re_
        if cur != L:
            raise ValidationError(
                f"leaf {gid}: coverage ends at {cur}, genome length {L}")
    for bi, blk in enumerate(aln.blocks):
        if blk.n_columns and not blk.bits.any(axis=0).all():
            col = int(np.flatnonzero(~blk.bits.any(axis=0))[0])
            raise ValidationError(f"block {bi}: all-gap column {col}")
