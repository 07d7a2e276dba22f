"""Genome distance matrices for guide-tree construction.

Array-native equivalents of libMems/DistanceMatrix.h:

* identity_matrix — IdentityMatrix over a match list (h:48-105):
  identity[i,j] = Σ match lengths where both genomes participate,
  divided by min(len_i, len_j);
* distance_matrix — DistanceMatrix (h:269-273): 1 − identity
  (TransformDistanceIdentity, h:276-282);
* single_copy_distance — SingleCopyDistanceMatrix (h:194-267): per
  genome pair, the fraction of each genome's positions covered by
  columns aligned to the partner, averaged over the two genomes, then
  1 − identity.  For ungapped multi-MUM inputs the covered positions of
  a match are exactly its [left, left+len) range in each genome, so the
  bitset walk of the reference collapses to interval accumulation.

All of these are O(n·G²) vector reductions on at most a few million
matches — they run as numpy host code feeding the (tiny) NJ solve; there
is no device win at G ≤ dozens of genomes.
"""

from __future__ import annotations

import numpy as np

from libmems_tpu_torch.match import MatchArray, NO_MATCH


def identity_matrix(matches: MatchArray,
                    seq_lengths: list[int] | np.ndarray) -> np.ndarray:
    """IdentityMatrix (libMems/DistanceMatrix.h:48-69): pairwise shared
    anchor coverage / min(genome lengths)."""
    G = matches.seq_count
    seq_lengths = np.asarray(seq_lengths, dtype=np.float64)
    present = (matches.starts != NO_MATCH).astype(np.float64)  # [n, G]
    # Σ_m len_m * present_i * present_j  ==  (present*len)^T @ present
    weighted = present * matches.lengths[:, None].astype(np.float64)
    ident = weighted.T @ present                                # [G, G]
    possible = np.minimum(seq_lengths[:, None], seq_lengths[None, :])
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(possible > 0, ident / possible, 0.0)
    return out


def distance_matrix(matches: MatchArray,
                    seq_lengths: list[int] | np.ndarray) -> np.ndarray:
    """DistanceMatrix = 1 − IdentityMatrix (DistanceMatrix.h:269-282),
    the flat aligner's guide-tree input (Aligner.cpp:2230-2240)."""
    return 1.0 - identity_matrix(matches, seq_lengths)


def _pair_coverage(starts_g: np.ndarray, lengths: np.ndarray,
                   genome_len: int) -> float:
    """Fraction of genome positions covered by the given signed starts
    (union of [|s|, |s|+len) intervals)."""
    sel = starts_g != NO_MATCH
    if not sel.any() or genome_len == 0:
        return 0.0
    lo = np.abs(starts_g[sel])
    hi = lo + lengths[sel]
    order = np.argsort(lo)
    lo, hi = lo[order], hi[order]
    # union length of sorted intervals
    run_hi = np.maximum.accumulate(hi)
    new_run = np.concatenate([[True], lo[1:] > run_hi[:-1]])
    starts_u = lo[new_run]
    ends_u = run_hi[np.concatenate([new_run[1:], [True]])]
    covered = int((ends_u - starts_u).sum())
    return covered / float(genome_len)


def default_bp_dist_estimate_min_score(seq_lengths) -> float:
    """3 x the default breakpoint penalty
    (getDefaultBpDistEstimateMinScore, ProgressiveAligner.cpp:120-126)."""
    avg = float(np.mean(np.asarray(seq_lengths, dtype=np.float64)))
    return 3.0 * np.log2(max(avg, 2.0)) * 7000.0


def default_breakpoint_max(seq_lengths) -> float:
    """Expected rearrangement count for heavily rearranged genomes:
    15 breakpoints per megabase of average genome length
    (getDefaultBreakpointMax, ProgressiveAligner.cpp:3359-3369)."""
    avg = float(np.mean(np.asarray(seq_lengths, dtype=np.float64)))
    return avg / 1_000_000.0 * 15.0


def breakpoint_distance_matrix(matches: MatchArray,
                               genomes,
                               conservation: np.ndarray | None = None,
                               occurrences: list[np.ndarray] | None = None,
                               bp_dist_estimate: float | None = None,
                               min_penalty: float = 4000.0,
                               scale: float = 0.9) -> np.ndarray:
    """Pairwise breakpoint (rearrangement) distance
    (ProgressiveAligner::CreatePairwiseBPDistance, PA.cpp:3372-3467).

    Per genome pair: project the match list onto the pair, eliminate
    overlaps, chain into LCBs, score each LCB with the pairwise anchor
    score, then greedily discard LCBs below a conservation-scaled
    stringent penalty max(bp_dist_estimate * cons_id^4, min_penalty).
    The distance entry is the surviving LCB count, normalized by
    max(observed max, 15 rearrangements per avg Mbp) and multiplied by
    `scale` (bp_dist_scale = 0.9, PA.cpp:144).

    genomes: list of Genome (for lengths and anchor scoring codes).
    conservation: optional [G, G] conservation distance (defaults 0).
    occurrences: optional per-genome seed-occurrence arrays for
      uniqueness-scaled anchor scores (SeedOccurrenceList analog).
    """
    from libmems_tpu_torch.anchorscore import pairwise_anchor_scores
    from libmems_tpu_torch.gbe import (GreedyRemovalScorer,
                                 greedy_breakpoint_elimination,
                                 surviving_members)
    from libmems_tpu_torch.lcb import (compute_adjacencies, compute_lcbs,
                                 eliminate_overlaps, identify_breakpoints)

    G = matches.seq_count
    seq_lengths = [len(g.codes) for g in genomes]
    if bp_dist_estimate is None:
        bp_dist_estimate = default_bp_dist_estimate_min_score(seq_lengths)
    if conservation is None:
        conservation = np.zeros((G, G))
    bp = np.ones((G, G), dtype=np.float64)
    for i in range(G):
        for j in range(i + 1, G):
            pair = matches.project([i, j], min_multiplicity=2)
            pair = eliminate_overlaps(pair)
            pair = pair.multiplicity_filter(2)
            if pair.n_matches == 0:
                bp[i, j] = bp[j, i] = 1.0
                continue
            order, bps = identify_breakpoints(pair)
            members = compute_lcbs(pair, order, bps)
            codes = [genomes[i].codes, genomes[j].codes]
            if occurrences is not None:
                sols = [occurrences[i], occurrences[j]]
            else:
                sols = [np.ones(len(c), dtype=np.float32) for c in codes]
            scores = pairwise_anchor_scores(pair, 0, 1, codes, sols)
            weights = np.array([float(scores[idx].sum())
                                for idx in members])
            lcbs = compute_adjacencies(pair, members, weights)
            cons_id = 1.0 - float(conservation[i, j])
            penalty = max(bp_dist_estimate * cons_id ** 4, min_penalty)
            greedy_breakpoint_elimination(
                lcbs, GreedyRemovalScorer(lcbs, penalty))
            n_lcbs = len(surviving_members(lcbs))
            bp[i, j] = bp[j, i] = float(n_lcbs)
    bp_max = max(float(bp.max()), default_breakpoint_max(seq_lengths))
    out = bp / bp_max * scale
    np.fill_diagonal(out, bp.diagonal() / bp_max * scale)
    return out


def single_copy_distance(matches: MatchArray,
                         seq_lengths: list[int] | np.ndarray) -> np.ndarray:
    """SingleCopyDistanceMatrix (DistanceMatrix.h:194-267) over ungapped
    matches: distance[i,j] = 1 − (coverage_i + coverage_j)/2, where
    coverage_g is the fraction of genome g's positions inside matches
    that also include the partner genome.  This is the progressive
    aligner's genome-content distance (ProgressiveAligner.cpp:3821)."""
    G = matches.seq_count
    seq_lengths = np.asarray(seq_lengths)
    dist = np.zeros((G, G), dtype=np.float64)
    present = matches.starts != NO_MATCH
    for i in range(G):
        for j in range(i + 1, G):
            both = present[:, i] & present[:, j]
            pi = _pair_coverage(matches.starts[both, i],
                                matches.lengths[both], int(seq_lengths[i]))
            pj = _pair_coverage(matches.starts[both, j],
                                matches.lengths[both], int(seq_lengths[j]))
            ident = (pi + pj) / 2.0
            dist[i, j] = dist[j, i] = 1.0 - ident
    return dist
