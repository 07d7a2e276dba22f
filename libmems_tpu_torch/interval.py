"""Intervals (aligned LCB segments) and XMFA serialization.

Array-native equivalent of the reference's Interval / GenericIntervalList
(libMems/Interval.h, IntervalList.h).  An Interval is an ordered list of
blocks along the alignment-column axis:

* anchor blocks — ungapped matches present in >=2 genomes (the Match
  anchors of an LCB);
* gap blocks — one genome's intervening sequence, unaligned ("staircase"
  columns), mirroring Interval::addUnalignedRegions / AddGapMatches
  (libMems/Interval.h:181, :76-98);
* gapped blocks — an explicit alignment matrix produced by the gapped
  aligner (replaces the reference's MUSCLE-produced GappedAlignment).

Serialization implements the reference's XMFA dialect
(IntervalList::WriteStandardAlignment, libMems/IntervalList.h:352-443:
``#FormatVersion Mauve1``, ``> seq:start-end ± name`` headers, 80-column
wrap, ``=`` block separators) and an XMFA reader for round-trip tests
(IntervalList.h:445-616).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field

import numpy as np

from libmems_tpu_torch.match import MatchArray, NO_MATCH
from libmems_tpu_torch.sequence import Genome, revcomp_ascii

GAP = ord("-")


@dataclass
class Block:
    """One chunk of interval columns.

    starts: int64[G] signed 1-based left ends (0 = absent).
    lengths: int64[G] characters of each genome in this block.
    rows: optional uint8[G, C] explicit alignment (ASCII + '-'); when
      None the block is either an ungapped anchor (all present lengths
      equal; columns = characters) or a single-genome gap block
      (staircase columns).
    """

    starts: np.ndarray
    lengths: np.ndarray
    rows: np.ndarray | None = None

    @property
    def n_columns(self) -> int:
        if self.rows is not None:
            return int(self.rows.shape[1])
        return int(self.lengths.max())

    def render(self, genomes: list[Genome]) -> np.ndarray:
        """uint8[G, C] ASCII rows (with '-') for this block."""
        if self.rows is not None:
            return self.rows
        G = len(self.starts)
        present = self.starts != NO_MATCH
        if present.sum() == 1 or len(set(
                self.lengths[present].tolist())) > 1:
            # staircase: each present genome gets its own column range
            C = int(self.lengths[present].sum())
            out = np.full((G, C), GAP, dtype=np.uint8)
            col = 0
            for g in np.flatnonzero(present):
                seg = _genome_chars(genomes[g], int(self.starts[g]),
                                    int(self.lengths[g]))
                out[g, col: col + len(seg)] = seg
                col += len(seg)
            return out
        C = int(self.lengths[present][0])
        out = np.full((G, C), GAP, dtype=np.uint8)
        for g in np.flatnonzero(present):
            out[g] = _genome_chars(genomes[g], int(self.starts[g]), C)
        return out


def _genome_chars(genome: Genome, start: int, length: int) -> np.ndarray:
    """ASCII characters of a signed 1-based region (revcomp if start<0)."""
    le = abs(start)
    seg = genome.ascii[le - 1: le - 1 + length]
    if start < 0:
        seg = revcomp_ascii(seg)
    return seg


@dataclass
class Interval:
    """An LCB's alignment: ordered blocks along the column axis
    (libMems/Interval.h GenericInterval)."""

    blocks: list[Block]
    seq_count: int

    def left_ends(self) -> np.ndarray:
        """Unsigned per-genome left end (0 = absent)."""
        le = np.zeros(self.seq_count, dtype=np.int64)
        for b in self.blocks:
            cur = np.abs(b.starts)
            le = np.where((le == 0) | ((cur > 0) & (cur < le)), cur, le)
        return le

    def right_ends(self) -> np.ndarray:
        re = np.zeros(self.seq_count, dtype=np.int64)
        for b in self.blocks:
            cur = np.where(b.starts != 0, np.abs(b.starts) + b.lengths - 1, 0)
            re = np.maximum(re, cur)
        return re

    def orientations(self) -> np.ndarray:
        """Per-genome orientation: True = forward (first present block)."""
        ori = np.ones(self.seq_count, dtype=bool)
        seen = np.zeros(self.seq_count, dtype=bool)
        for b in self.blocks:
            present = b.starts != 0
            new = present & ~seen
            ori[new] = b.starts[new] > 0
            seen |= present
        return ori

    def starts(self) -> np.ndarray:
        """Signed per-genome starts (sign = orientation)."""
        le = self.left_ends()
        return np.where(self.orientations(), le, -le)

    def lengths(self) -> np.ndarray:
        le, re = self.left_ends(), self.right_ends()
        return np.where(le == 0, 0, re - le + 1)

    @property
    def alignment_length(self) -> int:
        return sum(b.n_columns for b in self.blocks)

    def render(self, genomes: list[Genome]) -> np.ndarray:
        """uint8[G, C] full alignment rows."""
        if not self.blocks:
            return np.zeros((self.seq_count, 0), dtype=np.uint8)
        return np.concatenate([b.render(genomes) for b in self.blocks],
                              axis=1)


def interval_from_matches(matches: MatchArray, member_idx: np.ndarray,
                          add_unaligned: bool = True) -> Interval:
    """Build an Interval from an LCB's anchor matches, inserting
    single-genome gap blocks between consecutive anchors per genome
    (Interval::SetMatches + addUnalignedRegions, Interval.h:76-98,:181).

    Anchors are ordered along genome 0 (ascending left end) — the
    convention of ComputeLCBs_v2's genome-0-sorted match order.
    """
    starts = matches.starts[member_idx]
    lengths = matches.lengths[member_idx]
    G = matches.seq_count
    order = np.argsort(np.abs(starts[:, 0]), kind="stable")
    starts, lengths = starts[order], lengths[order]
    n = len(order)

    blocks: list[Block] = []
    for i in range(n):
        if add_unaligned and i > 0:
            # per-genome gaps between anchor i-1 and anchor i
            for g in range(G):
                sp, sc = int(starts[i - 1, g]), int(starts[i, g])
                if sp == NO_MATCH or sc == NO_MATCH:
                    continue
                lp = int(lengths[i - 1])
                lc = int(lengths[i])
                if sp > 0 and sc > 0:
                    gap_l, gap_r = abs(sp) + lp, abs(sc) - 1
                    gsign = 1
                elif sp < 0 and sc < 0:
                    # reverse: reading direction is right-to-left
                    gap_l, gap_r = abs(sc) + lc, abs(sp) - 1
                    gsign = -1
                else:
                    continue
                if gap_r >= gap_l:
                    gs = np.zeros(G, dtype=np.int64)
                    gl = np.zeros(G, dtype=np.int64)
                    gs[g] = gsign * gap_l
                    gl[g] = gap_r - gap_l + 1
                    blocks.append(Block(gs, gl))
        al = np.where(starts[i] != 0, lengths[i], 0)
        blocks.append(Block(starts[i].copy(), al))
    return Interval(blocks=blocks, seq_count=G)


def _split_gap_block(b: Block, size: int) -> list[Block]:
    """Split a single-genome gap block into <=size-column pieces, in
    alignment-column order (Interval::Marble's CropEnd/CropStart loop,
    Interval.h:421-438).  Reverse-strand blocks read right-to-left, so
    their leading columns are the highest genome coordinates."""
    g = int(np.flatnonzero(b.starts != NO_MATCH)[0])
    s, L = int(b.starts[g]), int(b.lengths[g])
    if L <= size:
        return [b]
    G = len(b.starts)
    pieces = []
    off = 0
    while off < L:
        ln = min(size, L - off)
        gs = np.zeros(G, dtype=np.int64)
        gl = np.zeros(G, dtype=np.int64)
        if s > 0:
            gs[g] = s + off
        else:
            gs[g] = -(abs(s) + L - off - ln)
        gl[g] = ln
        pieces.append(Block(gs, gl))
        off += ln
    return pieces


def marble(iv: Interval, size: int, rng_seed: int = 0) -> Interval:
    """Interval::Marble (libMems/Interval.h:410-480): bound the
    unaligned chunk size the gapped aligner sees by splitting
    single-genome gap blocks into <=size pieces and interleaving the
    pieces from different genomes between consecutive anchors, choosing
    sides by Mersenne-twister draws (the reference's RandTwisterDouble;
    np.random.MT19937 is the same generator family).

    Multi-genome blocks (anchors / gapped chunks) keep their positions;
    only the runs of gap blocks between them are re-ordered.
    """
    rng = np.random.Generator(np.random.MT19937(rng_seed))
    out: list[Block] = []
    pending: dict[int, list[Block]] = {}

    def flush():
        queues = [q for q in pending.values() if q]
        while queues:
            if len(queues) == 1:
                pick = queues[0]
            else:
                pick = queues[int(rng.random() * len(queues))]
            out.append(pick.pop(0))
            queues = [q for q in queues if q]
        pending.clear()

    for b in iv.blocks:
        present = b.starts != NO_MATCH
        if b.rows is None and int(present.sum()) == 1:
            g = int(np.flatnonzero(present)[0])
            pending.setdefault(g, []).extend(_split_gap_block(b, size))
        else:
            flush()
            out.append(b)
    flush()
    return Interval(blocks=out, seq_count=iv.seq_count)


@dataclass
class IntervalList:
    """All intervals of one alignment + source genome metadata
    (libMems/IntervalList.h GenericIntervalList)."""

    intervals: list[Interval]
    genomes: list[Genome] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.intervals)

    def __getitem__(self, i: int) -> Interval:
        return self.intervals[i]


# --------------------------------------------------------------------------
# XMFA
# --------------------------------------------------------------------------

def write_xmfa(path_or_fh, ivs: IntervalList, line_width: int = 80):
    """Write the Mauve XMFA dialect
    (IntervalList::WriteStandardAlignment, IntervalList.h:352-443)."""
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "w") if own else path_or_fh
    genomes = ivs.genomes
    try:
        fh.write("#FormatVersion Mauve1\n")
        filenames = [g.filename or g.name for g in genomes]
        single_input = len(set(filenames)) <= 1
        for i, fn in enumerate(filenames):
            fh.write(f"#Sequence{i + 1}File\t{fn}\n")
            if single_input:
                fh.write(f"#Sequence{i + 1}Entry\t{i + 1}\n")
            fh.write(f"#Sequence{i + 1}Format\tFastA\n")
        for ivI, iv in enumerate(ivs.intervals):
            if iv.alignment_length == 0:
                continue
            rows = iv.render(genomes)
            sts = iv.starts()
            lens = iv.lengths()
            for g in range(len(genomes)):
                st, ln = int(sts[g]), int(lens[g])
                if st == 0 and ivI > 0:
                    # kludge kept from the reference: all seqs appear in
                    # the first interval so downstream parsers cope
                    continue
                if st == 0:
                    fh.write(f"> {g + 1}:0-0 + ")
                elif st > 0:
                    fh.write(f"> {g + 1}:{st}-{st + ln - 1} + ")
                else:
                    fh.write(f"> {g + 1}:{-st}-{-st + ln - 1} - ")
                fh.write(filenames[0] if single_input else filenames[g])
                fh.write("\n")
                row = rows[g].tobytes().decode("ascii")
                for c in range(0, len(row), line_width):
                    fh.write(row[c: c + line_width] + "\n")
            fh.write("=\n")
    finally:
        if own:
            fh.close()


def read_xmfa_intervals(path_or_fh, genomes: list[Genome] | None = None
                        ) -> IntervalList:
    """Parse an XMFA file back into the object model: one Interval per
    XMFA block, each holding a single explicit-rows Block
    (IntervalList's XMFA reader, libMems/IntervalList.h:445-616).

    Re-entering an alignment from its XMFA serialization enables
    restart-from-XMFA workflows (refinement, backbone detection,
    reformatting) and interop with external Mauve tooling.  ``genomes``
    optionally attaches sequence backing (and is used for the genome
    count); otherwise placeholder Genomes are synthesized from the
    alignment rows themselves.
    """
    blocks = read_xmfa(path_or_fh)
    G = len(genomes) if genomes is not None else (
        1 + max((max(b["seqs"]) for b in blocks if b["seqs"]),
                default=-1))
    intervals: list[Interval] = []
    # reconstruct sequence backing when none is provided
    recon: list[dict[int, np.ndarray]] = [{} for _ in range(G)]
    for b in blocks:
        starts = np.zeros(G, dtype=np.int64)
        lengths = np.zeros(G, dtype=np.int64)
        texts = {}
        C = 0
        for g, rec in b["seqs"].items():
            lo, hi, strand, text = rec
            texts[g] = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
            C = max(C, len(texts[g]))
            if lo == 0 and hi == 0:
                continue
            starts[g] = -lo if strand == "-" else lo
            lengths[g] = hi - lo + 1
        if C == 0:
            continue
        rows = np.full((G, C), GAP, dtype=np.uint8)
        for g, t in texts.items():
            rows[g, : len(t)] = t
        # drop header-only blocks with no aligned content
        if not (starts != 0).any():
            continue
        for g in range(G):
            if starts[g] != 0 and genomes is None:
                chars = rows[g][rows[g] != GAP]
                if starts[g] < 0:
                    chars = revcomp_ascii(chars)
                recon[g][abs(int(starts[g]))] = chars
        intervals.append(Interval(blocks=[Block(starts, lengths,
                                                rows=rows)], seq_count=G))
    if genomes is None:
        genomes = []
        for g in range(G):
            length = max((lo + len(ch) - 1
                          for lo, ch in recon[g].items()), default=0)
            arr = np.full(length, ord("N"), dtype=np.uint8)
            for lo, ch in recon[g].items():
                arr[lo - 1: lo - 1 + len(ch)] = ch
            genomes.append(Genome(name=f"seq{g + 1}", ascii=arr))
    return IntervalList(intervals, list(genomes))


def read_xmfa(path_or_fh) -> list[dict]:
    """Parse an XMFA file into a list of blocks:
    [{"seqs": {seq_index: (start, end, strand, text)}, ...}]
    (reader counterpart of IntervalList.h:445-616, for tests/round-trip).
    """
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "r") if own else path_or_fh
    try:
        blocks = []
        cur: dict = {}
        cur_id = None
        cur_text: list[str] = []

        def flush_seq():
            nonlocal cur_id, cur_text
            if cur_id is not None:
                cur[cur_id] = (*cur[cur_id], "".join(cur_text))
                cur_id, cur_text = None, []

        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("#") or not line:
                continue
            if line.startswith(">"):
                flush_seq()
                head = line[1:].strip().split()
                idx_s, rng = head[0].split(":")  # "<idx>:<start>-<end>"
                lo, hi = rng.split("-")
                cur_id = int(idx_s) - 1
                cur[cur_id] = (int(lo), int(hi), head[1])
                cur_text = []
            elif line.startswith("="):
                flush_seq()
                if cur:
                    blocks.append({"seqs": cur})
                cur = {}
            else:
                cur_text.append(line)
        flush_seq()
        if cur:
            blocks.append({"seqs": cur})
        return blocks
    finally:
        if own:
            fh.close()
