"""Compact gapped alignments: one bit per (row, column).

Array-native equivalent of the reference's CompactGappedAlignment
(libMems/CompactGappedAlignment.h): an alignment over G sequences is a
boolean matrix ``bits[G, C]`` (True = the row consumes one character in
that column) plus signed per-sequence starts.  Character content is
never stored — it is materialized on demand from the source genomes.

The coordinate machinery the progressive aligner lives on —
``translate`` (h:94), ``copyRange`` (h:96), ``CondenseGapColumns``
(h:103), SeqPosToColumn/ColumnToSeqPos — is all cumulative-sum algebra
over the bit matrix here, which is exactly the layout a TPU wants
(vector scans instead of per-column loops).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from libmems_tpu_torch.match import NO_MATCH
from libmems_tpu_torch.sequence import Genome, revcomp_ascii

GAP = ord("-")


@dataclass
class CompactAlignment:
    """starts: int64[G] signed 1-based left ends (0 = row absent);
    bits: bool[G, C] — True where the row has a character."""

    starts: np.ndarray
    bits: np.ndarray

    def __post_init__(self):
        self.starts = np.asarray(self.starts, dtype=np.int64)
        self.bits = np.asarray(self.bits, dtype=bool)
        if self.bits.ndim != 2 or self.bits.shape[0] != self.starts.shape[0]:
            raise ValueError("CompactAlignment shape mismatch")
        # lazy per-row prefix-sum cache (bits are never mutated after
        # construction; the anchor-projection inner loop queries
        # coordinates thousands of times per node merge, and
        # recomputing the O(C) cumsum per query made projection
        # quadratic — the reference caches the same index as
        # CompactGappedAlignment's per-seq bit-count prefix)
        self._cum_cache: dict = {}
        self._lengths_cache = None

    @property
    def seq_count(self) -> int:
        return int(self.bits.shape[0])

    @property
    def n_columns(self) -> int:
        return int(self.bits.shape[1])

    def lengths(self) -> np.ndarray:
        """Characters consumed per row (Length(seqI))."""
        if self._lengths_cache is None:
            self._lengths_cache = self.bits.sum(axis=1).astype(np.int64)
        return self._lengths_cache

    def left_ends(self) -> np.ndarray:
        return np.abs(self.starts)

    def right_ends(self) -> np.ndarray:
        le = self.left_ends()
        return np.where(le == 0, 0, le + self.lengths() - 1)

    def orientations(self) -> np.ndarray:
        """True = forward."""
        return self.starts >= 0

    # -- coordinate translation (SeqPosToColumn / ColumnToSeqPos) --------

    def _cum(self, g: int) -> np.ndarray:
        cum = self._cum_cache.get(g)
        if cum is None:
            cum = np.cumsum(self.bits[g])
            self._cum_cache[g] = cum
        return cum

    def seq_pos_to_column(self, g: int, pos: np.ndarray) -> np.ndarray:
        """Sequence offsets (0-based, in row-reading order: left-to-right
        for forward rows, right-to-left complement order for reverse
        rows) -> column indices."""
        cum = self._cum(g)
        return np.searchsorted(cum, np.asarray(pos) + 1, side="left")

    def column_to_seq_pos(self, g: int, cols: np.ndarray) -> np.ndarray:
        """Column indices -> sequence offsets (0-based, row-reading
        order).  Columns where the row gaps map to the previous offset;
        columns before the first character map to -1."""
        cum = self._cum(g)
        return cum[np.asarray(cols)] - 1

    def genome_pos_to_column(self, g: int, gpos: np.ndarray) -> np.ndarray:
        """Absolute 1-based forward-strand genome positions -> columns
        (handles reverse-oriented rows)."""
        gpos = np.asarray(gpos, dtype=np.int64)
        s = int(self.starts[g])
        if s == NO_MATCH:
            raise ValueError("row absent")
        L = int(self.lengths()[g])
        if s > 0:
            off = gpos - s
        else:
            off = (-s + L - 1) - gpos
        return self.seq_pos_to_column(g, off)

    def column_to_genome_pos(self, g: int, cols: np.ndarray) -> np.ndarray:
        """Columns -> absolute 1-based forward-strand genome positions
        of the row's character at/most recently before each column."""
        off = self.column_to_seq_pos(g, cols)
        s = int(self.starts[g])
        L = int(self.lengths()[g])
        if s > 0:
            return s + off
        return (-s + L - 1) - off

    # -- builders ---------------------------------------------------------

    @staticmethod
    def from_rows(rows: np.ndarray, starts: np.ndarray
                  ) -> "CompactAlignment":
        """From explicit ASCII rows ('-' = gap)."""
        return CompactAlignment(starts=np.asarray(starts, np.int64),
                                bits=np.asarray(rows) != GAP)

    @staticmethod
    def ungapped(starts: np.ndarray, length: int) -> "CompactAlignment":
        """From an ungapped match row (all present rows full)."""
        starts = np.asarray(starts, np.int64)
        bits = np.broadcast_to((starts != 0)[:, None],
                               (len(starts), length)).copy()
        return CompactAlignment(starts=starts, bits=bits)

    # -- edits (copyRange / CondenseGapColumns / Invert) -------------------

    def slice_columns(self, lo: int, hi: int) -> "CompactAlignment":
        """Columns [lo, hi) as a new alignment with recomputed starts
        (CompactGappedAlignment::copyRange, h:96)."""
        sub = self.bits[:, lo:hi]
        lo, hi, _ = slice(lo, hi).indices(self.n_columns)
        L = self.lengths()
        new_starts = np.zeros_like(self.starts)
        for g in range(self.seq_count):
            if self.starts[g] == NO_MATCH or hi <= lo:
                continue
            # characters before and inside the slice from the row's cached
            # prefix sum: a node merge slices one block once per anchor
            cum = self._cum(g)
            consumed_before = int(cum[lo - 1]) if lo else 0
            consumed_in = int(cum[hi - 1]) - consumed_before
            if consumed_in == 0:
                continue
            s = int(self.starts[g])
            if s > 0:
                new_starts[g] = s + consumed_before
            else:
                # reverse row: reading order is right-to-left on the
                # forward strand; the slice's forward left end comes from
                # the characters after it in reading order
                right = (-s + L[g] - 1) - consumed_before
                new_starts[g] = -(right - consumed_in + 1)
        return CompactAlignment(starts=new_starts, bits=sub.copy())

    def condense_gap_columns(self) -> "CompactAlignment":
        """Drop all-gap columns (CondenseGapColumns, h:103)."""
        keep = self.bits.any(axis=0)
        return CompactAlignment(starts=self.starts.copy(),
                                bits=self.bits[:, keep])

    def invert(self) -> "CompactAlignment":
        """Reverse-complement the whole alignment (AbstractMatch::Invert):
        flip column order and every row's sign."""
        return CompactAlignment(starts=-self.starts,
                                bits=self.bits[:, ::-1].copy())

    def concat(self, other: "CompactAlignment") -> "CompactAlignment":
        """Column-wise concatenation of two collinear alignments; row
        starts come from whichever side has the row, preferring self for
        forward rows / other for reverse rows (reading order)."""
        starts = np.zeros_like(self.starts)
        for g in range(self.seq_count):
            a, b = int(self.starts[g]), int(other.starts[g])
            if a == NO_MATCH:
                starts[g] = b
            elif b == NO_MATCH:
                starts[g] = a
            else:
                starts[g] = a if a > 0 else b
        return CompactAlignment(
            starts=starts,
            bits=np.concatenate([self.bits, other.bits], axis=1))

    # -- materialization ---------------------------------------------------

    def render(self, genomes: list[Genome]) -> np.ndarray:
        """uint8[G, C] ASCII rows with '-' (GetAlignedSequences analog)."""
        G, C = self.bits.shape
        out = np.full((G, C), GAP, dtype=np.uint8)
        L = self.lengths()
        for g in range(G):
            s = int(self.starts[g])
            if s == NO_MATCH or L[g] == 0:
                continue
            le = abs(s)
            seg = genomes[g].ascii[le - 1: le - 1 + int(L[g])]
            if s < 0:
                seg = revcomp_ascii(seg)
            out[g, self.bits[g]] = seg
        return out


def merge_with_gap_masks(a: CompactAlignment, b: CompactAlignment,
                         a_gaps: np.ndarray, b_gaps: np.ndarray
                         ) -> CompactAlignment:
    """Stack two alignments along the row axis after a profile DP: a_gaps
    and b_gaps are the DP's per-side gap masks over merged columns."""
    C = len(a_gaps)
    Ga, Gb = a.seq_count, b.seq_count
    bits = np.zeros((Ga + Gb, C), dtype=bool)
    bits[:Ga, ~a_gaps] = a.bits
    bits[Ga:, ~b_gaps] = b.bits
    return CompactAlignment(
        starts=np.concatenate([a.starts, b.starts]), bits=bits)
