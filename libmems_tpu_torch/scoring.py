"""Pairwise / sum-of-pairs alignment scoring.

Equivalent of libMems/Scoring.h + SubstitutionMatrix.h: HOXD70
substitution scores with affine gap penalties (gap open −400, extend
−30; SubstitutionMatrix.h:23-35), scored per genome pair over alignment
columns and summed (computeSPScore, computeMatchScores,
computeGapScores — Scoring.h:115-260).

Semantics notes (matched to the reference):

* columns where either row has a gap score INVALID for the substitution
  part (computeMatchScores, Scoring.h:122-139);
* gap scoring skips columns where BOTH rows gap (they belong to other
  pairs); over the remaining projection, each maximal run of single-gap
  columns costs open + (len−1)·extend.  Terminal runs cost the same —
  the reference's term_gap_score is initialized to gap_open
  (Scoring.h:149-150);
* characters are translated through the BasicDNATable (ambiguity codes
  collapse onto A/C/G/T exactly like sequence.translate_dna).

These run as vectorized numpy on (G, C) ASCII row matrices — scoring is
O(G²·C) bookkeeping that feeds host-side decisions (refinement accept,
backbone scoring); the device-side analog used inside DP kernels is the
expected-score matmul in ops/profile.py.
"""

from __future__ import annotations

import numpy as np

from libmems_tpu_torch.ops.gapped import GAP_EXTEND, GAP_OPEN, HOXD70
from libmems_tpu_torch.sequence import _TRANSLATION

GAP = ord("-")


def _codes(row_ascii: np.ndarray) -> np.ndarray:
    """ASCII row -> 2-bit codes (gaps map to 0 but are masked separately)."""
    return _TRANSLATION[row_ascii]


def pairwise_match_score(row1: np.ndarray, row2: np.ndarray,
                         matrix: np.ndarray | None = None) -> int:
    """Σ substitution scores over columns where both rows are non-gap
    (computeMatchScores, Scoring.h:122-139)."""
    m = HOXD70 if matrix is None else matrix
    both = (row1 != GAP) & (row2 != GAP)
    if not both.any():
        return 0
    return int(m[_codes(row1[both]), _codes(row2[both])].sum(dtype=np.int64))


def pairwise_gap_score(row1: np.ndarray, row2: np.ndarray,
                       gap_open: int = GAP_OPEN,
                       gap_extend: int = GAP_EXTEND) -> int:
    """Σ affine gap penalties over the pair projection
    (computeGapScores, Scoring.h:141-260): both-gap columns are skipped;
    each maximal run of single-gap columns (constant gapping side) costs
    open + (len−1)·extend; terminal gap runs cost the same because
    term_gap_score == gap_open in the reference (Scoring.h:149-150)."""
    g1 = row1 == GAP
    g2 = row2 == GAP
    keep = ~(g1 & g2)
    if not keep.any():
        return 0
    s1, s2 = g1[keep], g2[keep]
    single = s1 | s2
    if not single.any():
        return 0
    side = np.where(s1, 1, np.where(s2, 2, 0)).astype(np.int8)
    prev = np.concatenate([[0], side[:-1]])
    opens = single & (side != prev)
    n_open = int(opens.sum())
    n_cols = int(single.sum())
    return n_open * gap_open + (n_cols - n_open) * gap_extend


def sp_score(rows: np.ndarray, gap_open: int = GAP_OPEN,
             gap_extend: int = GAP_EXTEND,
             matrix: np.ndarray | None = None) -> int:
    """Sum-of-pairs score of an alignment (computeSPScore equivalent):
    Σ over genome pairs of substitution + affine gap scores.
    rows: uint8[G, C] ASCII with '-' gaps."""
    G = rows.shape[0]
    total = 0
    for i in range(G):
        for j in range(i + 1, G):
            total += pairwise_match_score(rows[i], rows[j], matrix)
            total += pairwise_gap_score(rows[i], rows[j], gap_open,
                                        gap_extend)
    return total


def consensus_score(rows: np.ndarray,
                    matrix: np.ndarray | None = None
                    ) -> tuple[int, np.ndarray]:
    """Consensus column score + consensus sequence
    (computeConsensusScore, Scoring.h:33-118): per column, the best
    total substitution score of any single nucleotide against all
    non-gap characters; consensus is that argmax nucleotide.
    Returns (total_score, consensus ASCII uint8[C])."""
    m = (HOXD70 if matrix is None else matrix).astype(np.int64)
    G, C = rows.shape
    codes = _codes(rows)
    nongap = rows != GAP
    # counts[x, c] = number of rows with code x (non-gap) in column c
    counts = np.zeros((4, C), dtype=np.int64)
    for x in range(4):
        counts[x] = ((codes == x) & nongap).sum(axis=0)
    col_scores = m @ counts                     # [4(candidate), C]
    # reference candidate order is A,G,C,T (Scoring.h:47-50); ties keep
    # the earlier candidate
    order = np.array([0, 2, 1, 3])              # A,G,C,T as code indices
    reordered = col_scores[order]
    best = reordered.argmax(axis=0)
    total = int(reordered.max(axis=0).sum())
    letters = np.frombuffer(b"AGCT", dtype=np.uint8)
    return total, letters[best]


def alignment_quality_stats(ivs) -> dict:
    """SP score + coverage/column stats of a final IntervalList — the
    content-quality metrics tracked independently of byte-golden
    stability (SURVEY §4.4's external-validation role; computeSPScore,
    Scoring.h).  Used by bench_e2e.py's JSON and the tolerant-threshold
    quality gate (tests/test_quality_gate.py)."""
    total_sp = 0.0
    aligned_cols = 0
    core_cols = 0          # columns where every genome has a char
    aligned_bases = 0
    for iv in ivs.intervals:
        rows = iv.render(ivs.genomes)
        present = rows != GAP
        if int(present.any(axis=1).sum()) < 2:
            continue
        total_sp += float(sp_score(rows))
        occ = present.sum(axis=0)
        aligned_cols += int(rows.shape[1])
        core_cols += int((occ == rows.shape[0]).sum())
        aligned_bases += int(present.sum())
    total_bases = sum(len(g) for g in ivs.genomes)
    return {
        "sp_score": round(total_sp, 1),
        "aligned_columns": aligned_cols,
        "core_columns": core_cols,
        "multi_aligned_base_frac": round(
            aligned_bases / max(total_bases, 1), 4),
    }


def codes_rows_to_ascii(rows: np.ndarray) -> np.ndarray:
    """uint8 code rows (0-3, 4=gap) -> ASCII rows with '-'."""
    table = np.frombuffer(b"ACGT-", dtype=np.uint8)
    return table[rows]


def ascii_rows_to_codes(rows: np.ndarray) -> np.ndarray:
    """ASCII rows with '-' -> uint8 code rows (0-3, 4=gap)."""
    out = _TRANSLATION[rows].astype(np.uint8)
    out[rows == GAP] = 4
    return out
