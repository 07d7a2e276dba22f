"""Locally Collinear Block (LCB) formation.

Host-side port of the reference's breakpoint analysis: matches are sorted
per genome and runs of matches that stay adjacent with consistent relative
orientation in *every* genome form one LCB.  Mirrors:

* IdentifyBreakpoints (libMems/GreedyBreakpointElimination.h:161-226):
  label-sort collinearity scan including inversions;
* ComputeLCBs_v2 (GreedyBreakpointElimination.h:229-248);
* FindBoundaries (libMems/Interval.h:704-760);
* computeLCBAdjacencies_v3 (GreedyBreakpointElimination.h:251-311):
  per-genome doubly-linked adjacency lists over LCBs;
* GetLCBCoverage weight = sum(length x multiplicity)
  (libMems/Aligner.cpp:599-625; the N-base discount is not modeled —
  inputs here are 2-bit coded and N-free by construction);
* EliminateOverlaps (libMems/Aligner.cpp:62-178): per-genome trimming of
  overlapping matches before breakpoint analysis.

These are O(n log n) sorts + linear scans over at most a few million
matches — they stay on host (numpy) by design; the expensive scoring
passes they gate run on device (see gbe.py / scoring).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from libmems_tpu_torch.match import MatchArray, NO_MATCH

UNASSIGNED = -1


# --------------------------------------------------------------------------
# match overlap elimination (Aligner.cpp:62-178)
# --------------------------------------------------------------------------

def _crop_start(starts: np.ndarray, length: int, d: int):
    """CropStart(d): drop d columns at match start — forward starts += d
    (UngappedLocalAlignment.h:138-144, HybridAbstractMatch::MoveStart)."""
    s = starts.copy()
    s[s > 0] += d
    return s, length - d


def _crop_end(starts: np.ndarray, length: int, d: int):
    """CropEnd(d): drop d columns at match end — reverse starts -= d
    (UngappedLocalAlignment.h:147-152, HybridAbstractMatch::MoveEnd)."""
    s = starts.copy()
    s[s < 0] -= d
    return s, length - d


def eliminate_overlaps(matches: MatchArray) -> MatchArray:
    """Trim matches so no two overlap in any genome
    (EliminateOverlaps, libMems/Aligner.cpp:62-178).

    When two matches overlap in a genome, bases are deleted from the one
    with lower multiplicity (ties: shorter length); the trimmed-off piece
    survives as a new match without that genome if it still has
    multiplicity >= 2.

    The per-genome pass is decomposed vectorized: rows are sorted by
    |start| (numpy, stable), consecutive rows are grouped into overlap
    clusters with a running-max end scan, and the reference's sequential
    trim sweep runs only inside clusters of size >= 2 — non-overlapping
    rows (the vast majority at genome scale) never touch Python lists.
    """
    if len(matches) < 2:
        return matches
    seq_count = matches.seq_count
    starts = matches.starts.astype(np.int64, copy=True)      # [N, G]
    lengths = matches.lengths.astype(np.int64, copy=True)    # [N]

    for seqI in range(seq_count):
        n = len(lengths)
        if n < 2:
            break
        col = starts[:, seqI]
        has = col != NO_MATCH
        # sort by |start| in seqI, NO_MATCH first (SingleStartComparator)
        order = np.argsort(np.where(has, np.abs(col), -1), kind="stable")
        starts = starts[order]
        lengths = lengths[order]
        col = starts[:, seqI]
        k = int(np.count_nonzero(col == NO_MATCH))
        if n - k < 2:
            continue
        a = np.abs(col[k:])
        run_max_end = np.maximum.accumulate(a + lengths[k:])
        brk = np.empty(n - k, dtype=bool)
        brk[0] = True
        brk[1:] = a[1:] >= run_max_end[:-1]     # no overlap with anything before
        sizes = np.diff(np.append(np.flatnonzero(brk), n - k))
        if int(sizes.max()) < 2:
            continue
        out_s = [starts[:k]]
        out_l = [lengths[:k]]
        new_matches: list = []
        row0 = k
        for size in sizes:
            size = int(size)
            if size < 2:
                out_s.append(starts[row0:row0 + size])
                out_l.append(lengths[row0:row0 + size])
            else:
                cluster = [[starts[j].copy(), int(lengths[j])]
                           for j in range(row0, row0 + size)]
                survivors, news = _sweep_overlap_cluster(cluster, seqI)
                if survivors:
                    out_s.append(np.stack([m[0] for m in survivors]))
                    out_l.append(np.array([m[1] for m in survivors],
                                          dtype=np.int64))
                new_matches.extend(news)
            row0 += size
        if new_matches:
            out_s.append(np.stack([m[0] for m in new_matches]))
            out_l.append(np.array([m[1] for m in new_matches],
                                  dtype=np.int64))
        starts = np.concatenate(out_s)
        lengths = np.concatenate(out_l)

    if len(lengths) == 0:
        return MatchArray.empty(seq_count)
    return MatchArray(starts, lengths)


def _sweep_overlap_cluster(work: list, seqI: int):
    """Reference trim sweep (Aligner.cpp:78-170) over one overlap cluster,
    already sorted by |start| in seqI.  Returns (survivors in order,
    new trimmed-off matches)."""
    new_matches: list = []
    matchI = 0
    while matchI < len(work):
            if work[matchI] is None:
                matchI += 1
                continue
            nextI = matchI + 1
            deleted_matchI = False
            while nextI < len(work):
                if work[nextI] is None:
                    nextI += 1
                    continue
                startI = int(work[matchI][0][seqI])
                lenI = work[matchI][1]
                startJ = int(work[nextI][0][seqI])
                diff = abs(startJ) - abs(startI) - lenI
                if diff >= 0:
                    break  # no more overlaps with matchI
                diff = -diff
                multI = int((work[matchI][0] != NO_MATCH).sum())
                multJ = int((work[nextI][0] != NO_MATCH).sum())
                lenJ = work[nextI][1]
                if (multJ > multI) or (multJ == multI and lenJ > lenI):
                    # matchI is smaller: trim it
                    new_s, new_l = work[matchI][0].copy(), lenI
                    if diff >= lenI:
                        # whole match eaten; the copy (minus seqI) survives
                        work[matchI] = None
                        deleted_matchI = True
                    else:
                        if startI > 0:
                            work[matchI][0], work[matchI][1] = _crop_end(
                                work[matchI][0], lenI, diff)
                            new_s, new_l = _crop_start(new_s, new_l,
                                                       new_l - diff)
                        else:
                            work[matchI][0], work[matchI][1] = _crop_start(
                                work[matchI][0], lenI, diff)
                            new_s, new_l = _crop_end(new_s, new_l,
                                                     new_l - diff)
                else:
                    # nextI is smaller: trim it
                    new_s, new_l = work[nextI][0].copy(), lenJ
                    if diff >= lenJ:
                        # whole match eaten; the copy (minus seqI) survives
                        work[nextI] = None
                    else:
                        if startJ > 0:
                            work[nextI][0], work[nextI][1] = _crop_start(
                                work[nextI][0], lenJ, diff)
                            new_s, new_l = _crop_end(new_s, new_l,
                                                     new_l - diff)
                        else:
                            work[nextI][0], work[nextI][1] = _crop_end(
                                work[nextI][0], lenJ, diff)
                            new_s, new_l = _crop_start(new_s, new_l,
                                                      new_l - diff)
                new_s[seqI] = NO_MATCH
                if new_l > 0 and (new_s != NO_MATCH).sum() > 1:
                    new_matches.append([new_s, new_l])
                if deleted_matchI:
                    break
                nextI += 1
            matchI += 1
    return [m for m in work if m is not None], new_matches


# --------------------------------------------------------------------------
# breakpoint identification (GreedyBreakpointElimination.h:161-226)
# --------------------------------------------------------------------------

def _ssc_order(starts: np.ndarray, seqI: int) -> np.ndarray:
    """Sort order by LeftEnd in seqI, undefined (NO_MATCH) first
    (SSC, libMems/AbstractMatch.h:355-385)."""
    le = np.abs(starts[:, seqI])
    return np.lexsort((le, le != NO_MATCH))


def identify_breakpoints(matches: MatchArray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Return (order, breakpoints): `order` sorts matches by genome-0
    left end; `breakpoints` are indices (into the ordered list) of the
    last match of each LCB (IdentifyBreakpoints)."""
    n = len(matches)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = _ssc_order(matches.starts, 0)
    s = matches.starts[order]
    breakpoints = {n - 1}
    orient0 = s[:, 0] >= 0  # genome-0 orientation (True = forward)

    for seqI in range(1, matches.seq_count):
        lab_order = _ssc_order(s, seqI)
        labels = lab_order  # label = position in genome-0 order
        ori = (s[lab_order, seqI] >= 0) == orient0[lab_order]
        prev = 0
        prev_orient = bool(ori[0])
        if not prev_orient:
            breakpoints.add(int(labels[0]))
        for it in range(1, n):
            cur_orient = bool(ori[it])
            if prev_orient == cur_orient and (
                (prev_orient and labels[prev] + 1 == labels[it]) or
                (not prev_orient and labels[prev] - 1 == labels[it])):
                prev = it
                continue
            if prev_orient:
                breakpoints.add(int(labels[prev]))
            if not cur_orient:
                breakpoints.add(int(labels[it]))
            prev_orient = cur_orient
            prev = it
        if prev_orient:
            breakpoints.add(int(labels[prev]))
    return order, np.array(sorted(breakpoints), dtype=np.int64)


def compute_lcbs(matches: MatchArray, order: np.ndarray,
                 breakpoints: np.ndarray) -> list[np.ndarray]:
    """Partition ordered matches into LCB member index lists
    (ComputeLCBs_v2, GreedyBreakpointElimination.h:229-248).  Returned
    indices are into the original MatchArray."""
    lcbs = []
    prev = 0
    for bp in breakpoints:
        lcbs.append(order[prev: int(bp) + 1])
        prev = int(bp) + 1
    return lcbs


# --------------------------------------------------------------------------
# LCB struct + adjacencies (LCB.h, computeLCBAdjacencies_v3)
# --------------------------------------------------------------------------

@dataclass
class LCBSet:
    """All LCBs of one anchoring, struct-of-arrays (libMems/LCB.h:16-27).

    left_end/right_end are signed per genome (sign = orientation,
    right_end = left_end + span, i.e. one past the inclusive end);
    left_adjacency/right_adjacency are LCB ids forming a doubly-linked
    list per genome; lcb_id == row index while alive, -2 when removed,
    other => coalesced into that id.
    """

    left_end: np.ndarray        # int64[n, G] signed
    right_end: np.ndarray       # int64[n, G] signed
    left_adjacency: np.ndarray  # int64[n, G]
    right_adjacency: np.ndarray  # int64[n, G]
    lcb_id: np.ndarray          # int64[n]
    weight: np.ndarray          # float64[n]
    members: list = field(default_factory=list)  # per-LCB match indices
    to_be_deleted: np.ndarray = None  # bool[n]

    def __post_init__(self):
        if self.to_be_deleted is None:
            self.to_be_deleted = np.zeros(len(self.lcb_id), dtype=bool)

    @property
    def n(self) -> int:
        return len(self.lcb_id)

    def alive(self) -> np.ndarray:
        return np.flatnonzero(self.lcb_id == np.arange(self.n))

    def n_alive(self) -> int:
        return int((self.lcb_id == np.arange(self.n)).sum())


def find_boundaries(starts: np.ndarray, lengths: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-genome (left_end, span, orientation) of one LCB's matches
    (FindBoundaries, libMems/Interval.h:704-760).  left_end==0 where the
    LCB has no match in that genome ("ragged edges")."""
    G = starts.shape[1]
    left = np.zeros(G, dtype=np.int64)
    span = np.zeros(G, dtype=np.int64)
    orient = np.zeros(G, dtype=bool)
    present = starts != NO_MATCH
    le = np.abs(starts)
    re = np.where(present, le + lengths[:, None], 0)
    for g in range(G):
        rows = np.flatnonzero(present[:, g])
        if rows.size == 0:
            continue
        left[g] = le[rows, g].min()
        span[g] = re[rows, g].max() - left[g]
        # orientation: genome-0-order scan — first match present in g
        orient[g] = starts[rows[0], g] > 0
    return left, span, orient


def compute_adjacencies(matches: MatchArray, lcb_members: list[np.ndarray],
                        weights: np.ndarray | None = None) -> LCBSet:
    """Build the LCBSet with per-genome adjacency links
    (computeLCBAdjacencies_v3, GreedyBreakpointElimination.h:251-311)."""
    n = len(lcb_members)
    G = matches.seq_count
    left_end = np.zeros((n, G), dtype=np.int64)
    right_end = np.zeros((n, G), dtype=np.int64)
    for i, idx in enumerate(lcb_members):
        le, span, ori = find_boundaries(matches.starts[idx],
                                        matches.lengths[idx])
        sign = np.where(ori, 1, -1)
        present = le != NO_MATCH
        left_end[i] = np.where(present, sign * le, 0)
        right_end[i] = np.where(present, sign * (le + span), 0)

    if weights is None:
        weights = np.array([
            (matches.lengths[idx] * matches.multiplicity()[idx]).sum()
            for idx in lcb_members], dtype=np.float64)

    la = np.full((n, G), UNASSIGNED, dtype=np.int64)
    ra = np.full((n, G), UNASSIGNED, dtype=np.int64)
    for g in range(G):
        le = np.abs(left_end[:, g])
        order = np.lexsort((le, le != NO_MATCH))  # LCBLeftComparator
        la[order[1:], g] = order[:-1]
        ra[order[:-1], g] = order[1:]
    return LCBSet(left_end=left_end, right_end=right_end,
                  left_adjacency=la, right_adjacency=ra,
                  lcb_id=np.arange(n, dtype=np.int64),
                  weight=np.asarray(weights, dtype=np.float64),
                  members=list(lcb_members))


def compute_lcb_set(matches: MatchArray,
                    weights: np.ndarray | None = None) -> LCBSet:
    """identify_breakpoints + compute_lcbs + compute_adjacencies
    (ComputeLCBs_v2 pipeline)."""
    order, bps = identify_breakpoints(matches)
    members = compute_lcbs(matches, order, bps)
    return compute_adjacencies(matches, members, weights)
