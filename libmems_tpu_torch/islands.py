"""Column-class encoding, HSS detection, islands.

Port of libmems_tpu/islands.py (imports renamed; the HMM batch runs on
an explicit `device`).  Equivalent of libMems/Islands.{h,cpp}: encode a
pairwise projection of an alignment into the HomologyHMM's 8 emission
classes (charmap/colmap,
Islands.h:90-120), rewrite interior gap runs to gap-extend symbols
(Islands.h:145-155), run the homology HMM, and harvest maximal
homologous column runs (HSS = "high-scoring segments"); islands are the
complement (ComplementHss, Islands.h:242-275).  findBigGaps
(Islands.h:363-412) flags long indels as HSS breaks without the HMM.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from libmems_tpu_torch.ops.hmm import HmmParams, predict_homologous
from libmems_tpu_torch.scoring import GAP
from libmems_tpu_torch.sequence import _TRANSLATION

# colmap (Islands.h:113-120): symbol for (char_i, char_j), chars coded
# A=0 C=1 G=2 T=3 gap=4; symbols here are 0-based HMM emission codes
# (reference ASCII '1'..'8' minus one).
COLMAP = np.array([
    # A  C  G  T  -
    [0, 2, 3, 4, 6],   # A
    [2, 1, 5, 3, 6],   # C
    [3, 5, 1, 2, 6],   # G
    [4, 3, 2, 0, 6],   # T
    [6, 6, 6, 6, 255],  # -  (gap/gap = removed)
], dtype=np.uint8)

GAP_OPEN_SYM = 6
GAP_EXTEND_SYM = 7
BOTH_GAP = 255


@dataclass
class HssCols:
    """A homologous column segment of one pairwise projection
    (Islands.h HssCols)."""

    seqI: int
    seqJ: int
    left_col: int
    right_col: int


def _char5(row_ascii: np.ndarray) -> np.ndarray:
    """ASCII row -> 5-code (ACGT- = 01234), ambiguity codes collapse
    like the BasicDNATable (charmap, Islands.h:90-110)."""
    out = _TRANSLATION[row_ascii].astype(np.uint8)
    out[row_ascii == GAP] = 4
    return out


def encode_column_states(row_i: np.ndarray, row_j: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Column symbols for a pairwise projection.

    Returns (symbols uint8[K], col_reference int64[K]): gap/gap columns
    are removed; interior single-gap runs become gap-extend symbols
    (the reference's sequential rewrite, Islands.h:145-155: a gap-open
    column turns into gap-extend when both neighbors in the filtered
    sequence are gap columns, plus the run-boundary special cases)."""
    sym_all = COLMAP[_char5(row_i), _char5(row_j)]
    keep = sym_all != BOTH_GAP
    col_reference = np.flatnonzero(keep)
    s = sym_all[keep].copy()
    K = len(s)
    if K > 1:
        g = s == GAP_OPEN_SYM
        interior = np.zeros(K, dtype=bool)
        if K > 2:
            interior[1:-1] = g[1:-1] & g[2:] & g[:-2]
        first = g[0] & g[1]
        last = g[-1] & g[-2]
        s[interior] = GAP_EXTEND_SYM
        if first:
            s[0] = GAP_EXTEND_SYM
        if last:
            s[-1] = GAP_EXTEND_SYM
    return s, col_reference


def hss_from_prediction(pred: np.ndarray, col_reference: np.ndarray,
                        seqI: int, seqJ: int) -> list[HssCols]:
    """Maximal homologous runs -> HSS column segments
    (findHssHomologyHMM harvest loop, Islands.h:168-196)."""
    out: list[HssCols] = []
    if len(pred) == 0:
        return out
    p = pred.astype(np.int8)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], p, [0]])))
    for lo, hi in zip(edges[::2], edges[1::2]):
        out.append(HssCols(seqI=seqI, seqJ=seqJ,
                           left_col=int(col_reference[lo]),
                           right_col=int(col_reference[hi - 1])))
    return out


def find_hss_homology_batch(jobs: list[tuple[np.ndarray, np.ndarray,
                                             int, int]],
                            params: HmmParams | None = None,
                            device="cuda") -> list[list[HssCols]]:
    """Batched findHssHomologyHMM over many (row_i, row_j, seqI, seqJ)
    pairwise projections: one HMM launch per size bucket on `device`."""
    encoded = []
    refs = []
    for row_i, row_j, _, _ in jobs:
        s, ref = encode_column_states(row_i, row_j)
        encoded.append(s)
        refs.append(ref)
    preds = predict_homologous(encoded, params, device=device)
    return [hss_from_prediction(p, refs[k], jobs[k][2], jobs[k][3])
            for k, p in enumerate(preds)]


def complement_hss(hss_list: list[HssCols], n_columns: int,
                   seqI: int = 0, seqJ: int = 0) -> list[HssCols]:
    """Islands = complement of the HSS segments over [0, n_columns)
    (ComplementHss, Islands.h:242-275)."""
    out: list[HssCols] = []
    cursor = 0
    for h in sorted(hss_list, key=lambda x: x.left_col):
        if h.left_col > cursor:
            out.append(HssCols(seqI, seqJ, cursor, h.left_col - 1))
        cursor = max(cursor, h.right_col + 1)
    if cursor < n_columns:
        out.append(HssCols(seqI, seqJ, cursor, n_columns - 1))
    return out


def find_big_gaps(row_i: np.ndarray, row_j: np.ndarray, seqI: int,
                  seqJ: int, big_gap_size: int = 10000) -> list[HssCols]:
    """Segments split at gaps longer than big_gap_size (findBigGaps,
    Islands.h:363-412) — the BigGapsDetector used before HMM scoring."""
    gap_i = row_i == GAP
    gap_j = row_j == GAP
    single = gap_i ^ gap_j
    C = len(row_i)
    # maximal single-gap runs of length > big_gap_size break the interval
    edges = np.flatnonzero(np.diff(np.concatenate(
        [[0], single.astype(np.int8), [0]])))
    breaks = [(int(lo), int(hi - 1))
              for lo, hi in zip(edges[::2], edges[1::2])
              if hi - lo > big_gap_size]
    out: list[HssCols] = []
    cursor = 0
    for lo, hi in breaks:
        if lo > cursor:
            out.append(HssCols(seqI, seqJ, cursor, lo - 1))
        cursor = hi + 1
    if cursor < C:
        out.append(HssCols(seqI, seqJ, cursor, C - 1))
    return out
