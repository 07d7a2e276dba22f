"""Array-native match data model (struct-of-arrays).

TPU-first equivalent of the reference's Match / MatchList object graph
(libMems/Match.h, UngappedLocalAlignment.h, HybridAbstractMatch.h,
MatchList.h).  Instead of millions of heap-allocated Match objects chained
through a SlotAllocator, a MatchArray stores all matches of one search as
two numpy/JAX arrays:

* ``starts``: int64[n, G] — signed 1-based left-ends per genome; 0 means
  the match does not include that genome (NO_MATCH, AbstractMatch.h:27);
  a negative value means reverse-complement orientation, |start| is still
  the forward-strand left end (HybridAbstractMatch.h LeftEnd/Orientation).
* ``lengths``: int64[n] — match length in columns.

Also implements the reference's match-list text format v3
(MatchList::ReadList/WriteList, libMems/MatchList.h:497-634) for
golden-file interchange.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field

import numpy as np

NO_MATCH = 0


@dataclass
class MatchArray:
    """All matches of one search over G genomes, as arrays."""

    starts: np.ndarray  # int64[n, G], signed 1-based, 0 = absent
    lengths: np.ndarray  # int64[n]

    def __post_init__(self):
        self.starts = np.asarray(self.starts, dtype=np.int64)
        self.lengths = np.asarray(self.lengths, dtype=np.int64)
        if self.starts.ndim != 2 or self.lengths.shape != (self.starts.shape[0],):
            raise ValueError("MatchArray shape mismatch")

    @property
    def n_matches(self) -> int:
        return int(self.starts.shape[0])

    @property
    def seq_count(self) -> int:
        return int(self.starts.shape[1])

    def __len__(self) -> int:
        return self.n_matches

    def multiplicity(self) -> np.ndarray:
        """Number of genomes participating in each match."""
        return (self.starts != NO_MATCH).sum(axis=1)

    def left_ends(self) -> np.ndarray:
        """|starts| — unsigned 1-based left ends (0 = absent)."""
        return np.abs(self.starts)

    def right_ends(self) -> np.ndarray:
        """1-based inclusive right ends (0 = absent)."""
        le = self.left_ends()
        return np.where(le == 0, 0, le + self.lengths[:, None] - 1)

    def multiplicity_filter(self, multiplicity: int) -> "MatchArray":
        """Keep only matches in exactly `multiplicity` genomes
        (MatchList::MultiplicityFilter, MatchList.h:636-649)."""
        keep = self.multiplicity() == multiplicity
        return MatchArray(self.starts[keep], self.lengths[keep])

    def length_filter(self, min_length: int) -> "MatchArray":
        """Keep only matches of at least `min_length` columns
        (MatchList::LengthFilter, MatchList.h:651-664)."""
        keep = self.lengths >= min_length
        return MatchArray(self.starts[keep], self.lengths[keep])

    def mask_filter(self, seq_mask: int) -> "MatchArray":
        """Keep only matches whose genome-participation bitmask equals
        seq_mask, bit g = genome g (MaskedMemHash semantics,
        libMems/MaskedMemHash.cpp:38-63)."""
        present = self.starts != NO_MATCH
        weights = (1 << np.arange(self.seq_count, dtype=np.int64))
        masks = (present * weights).sum(axis=1)
        keep = masks == seq_mask
        return MatchArray(self.starts[keep], self.lengths[keep])

    def project(self, seq_idx, min_multiplicity: int = 2,
                normalize: bool = True) -> "MatchArray":
        """Project onto a subset of genomes (MatchProjectionAdapter,
        libMems/MatchProjectionAdapter.h:21-60; pairwise case =
        PairwiseMatchAdapter, PairwiseMatchAdapter.h).

        Keeps matches present in >= min_multiplicity of the selected
        genomes.  With normalize=True the projected match is inverted
        when its first present genome is on the reverse strand, so the
        leading genome always reads forward (the reference's pairwise
        convention for seeding profile alignment).
        """
        seq_idx = np.asarray(seq_idx, dtype=np.int64)
        starts = self.starts[:, seq_idx].copy()
        keep = (starts != NO_MATCH).sum(axis=1) >= min_multiplicity
        starts = starts[keep]
        lengths = self.lengths[keep].copy()
        if normalize and len(starts):
            present = starts != NO_MATCH
            first = np.argmax(present, axis=1)
            lead = starts[np.arange(len(starts)), first]
            flip = lead < 0
            starts[flip] = -starts[flip]
        return MatchArray(starts, lengths)

    def canonical_sort(self) -> "MatchArray":
        """Deterministic order: lexicographic by (starts..., length)."""
        keys = np.concatenate([self.starts, self.lengths[:, None]], axis=1)
        order = np.lexsort(keys.T[::-1])
        return MatchArray(self.starts[order], self.lengths[order])

    def dedup(self) -> "MatchArray":
        """Remove exact duplicates (same starts and length)."""
        keys = np.concatenate([self.starts, self.lengths[:, None]], axis=1)
        _, idx = np.unique(keys, axis=0, return_index=True)
        return MatchArray(self.starts[np.sort(idx)], self.lengths[np.sort(idx)])

    def key_set(self) -> set:
        """Set of (starts tuple, length) — for parity comparisons."""
        return {(tuple(int(x) for x in row), int(l))
                for row, l in zip(self.starts, self.lengths)}

    @staticmethod
    def empty(seq_count: int) -> "MatchArray":
        return MatchArray(np.zeros((0, seq_count), dtype=np.int64),
                          np.zeros((0,), dtype=np.int64))

    @staticmethod
    def concat(arrays: list["MatchArray"]) -> "MatchArray":
        if not arrays:
            raise ValueError("empty concat")
        return MatchArray(np.concatenate([a.starts for a in arrays]),
                          np.concatenate([a.lengths for a in arrays]))


def write_match_list(path_or_fh, matches: MatchArray, seq_filenames: list[str],
                     seq_lengths: list[int]):
    """Write the reference's match-list text format v3
    (MatchList::WriteList, libMems/MatchList.h:589-634)."""
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "w") if own else path_or_fh
    try:
        fh.write("FormatVersion\t3\n")
        fh.write(f"SequenceCount\t{matches.seq_count}\n")
        for i, (fn, ln) in enumerate(zip(seq_filenames, seq_lengths)):
            fh.write(f"Sequence{i}File\t{fn or 'null'}\n")
            fh.write(f"Sequence{i}Length\t{ln}\n")
        fh.write(f"MatchCount\t{matches.n_matches}\n")
        for row, length in zip(matches.starts, matches.lengths):
            fh.write(str(int(length)))
            for s in row:
                fh.write(f"\t{int(s)}")
            fh.write("\n")
    finally:
        if own:
            fh.close()


def read_match_list(path_or_fh) -> tuple[MatchArray, list[str], list[int]]:
    """Read match-list text format v3 (MatchList::ReadList,
    libMems/MatchList.h:497-587)."""
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "r") if own else path_or_fh
    try:
        header: dict[str, str] = {}
        line = fh.readline()
        while line:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 2 and not parts[0][:1].isdigit():
                header[parts[0]] = parts[1]
                if parts[0] == "MatchCount":
                    break
            line = fh.readline()
        seq_count = int(header["SequenceCount"])
        n = int(header["MatchCount"])
        filenames = [header.get(f"Sequence{i}File", "null") for i in range(seq_count)]
        lengths = [int(header.get(f"Sequence{i}Length", 0)) for i in range(seq_count)]
        starts = np.zeros((n, seq_count), dtype=np.int64)
        lens = np.zeros((n,), dtype=np.int64)
        for i in range(n):
            vals = fh.readline().split()
            lens[i] = int(vals[0])
            starts[i] = [int(v) for v in vals[1 : 1 + seq_count]]
        return MatchArray(starts, lens), filenames, lengths
    finally:
        if own:
            fh.close()
