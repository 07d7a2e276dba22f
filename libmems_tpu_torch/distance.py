"""Genome distance matrices for guide-tree construction.

Port of the flat aligner's part of libmems_tpu/distance.py
(libMems/DistanceMatrix.h): identity_matrix, distance_matrix and the
_pair_coverage helper, all numpy host code feeding the NJ solve.  The
breakpoint distance needs the anchor scorer and is not ported yet
(ROADMAP queue 2: pairwise seeding with seed occurrence).
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
