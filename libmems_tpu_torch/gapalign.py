"""Inter-anchor gapped alignment of LCB intervals.

Equivalent of the reference's AlignLCBInParallel + MuscleInterface::Align
(libMems/Aligner.cpp:1293-1367, MuscleInterface.cpp:428-521): for every
pair of consecutive anchors inside an LCB, extract each genome's
intervening sequence (getInterveningCoordinates semantics,
libMems/GappedAligner.h:46-80), align the fragments, and splice the
result back as an explicit alignment block.  Windows longer than
``max_alignment_length`` (GappedAligner.h:25, default 10000) are left
unaligned as staircase blocks, exactly like the reference's refusal path.

Where the reference serializes one MUSCLE subprocess-equivalent call per
window, every window of every LCB here is batched into the device MSA
engine (libmems_tpu_torch.msa.align_window_group) on the run's device —
one DP and one traceback launch per guide-tree merge level per size
bucket.
"""

from __future__ import annotations

import numpy as np

from libmems_tpu_torch.interval import Block, Interval, IntervalList
from libmems_tpu_torch.match import MatchArray, NO_MATCH
from libmems_tpu_torch.msa import MAX_ALIGNMENT_LENGTH, align_window_group
from libmems_tpu_torch.ops.profile import GAP_CODE
from libmems_tpu_torch.sequence import Genome, revcomp_ascii, translate_dna
from libmems_tpu_torch.tree import TreeNode


def _gap_region(sp: int, lp: int, sc: int, lc: int) -> tuple[int, int]:
    """Signed start + length of the region between consecutive anchors in
    one genome (both anchors present, same sign).  Returns (0, 0) when
    the anchors abut or overlap."""
    if sp > 0:
        gap_l, gap_r = sp + lp, sc - 1
        if gap_r < gap_l:
            return 0, 0
        return gap_l, gap_r - gap_l + 1
    gap_l, gap_r = -sc + lc, -sp - 1
    if gap_r < gap_l:
        return 0, 0
    return -gap_l, gap_r - gap_l + 1


def _fragment_ascii(genome: Genome, start: int, length: int) -> np.ndarray:
    le = abs(start)
    seg = genome.ascii[le - 1: le - 1 + length]
    if start < 0:
        seg = revcomp_ascii(seg)
    return seg


def _rows_to_ascii_block(rows: np.ndarray, frags: list[np.ndarray]
                         ) -> np.ndarray:
    """Replace each row's non-gap cells with the fragment's true ASCII
    characters (the DP ran on 2-bit codes; output keeps IUPAC input)."""
    G, C = rows.shape
    out = np.full((G, C), ord("-"), dtype=np.uint8)
    for g in range(G):
        sel = rows[g] != GAP_CODE
        out[g, sel] = frags[g]
    return out


def gapped_interval_from_matches(matches: MatchArray,
                                 member_idx: np.ndarray,
                                 genomes: list[Genome],
                                 tree: TreeNode,
                                 max_window: int = MAX_ALIGNMENT_LENGTH
                                 ) -> tuple[list, list]:
    """Plan one LCB: returns (segments, windows).

    segments is the interval's block list where each inter-anchor gap is
    either a placeholder ('window', window_id-relative index) to be
    filled by the batched MSA, or ready-made staircase/anchor Blocks.
    windows collects (starts int64[G], frag_codes list, frag_ascii list)
    for the batched aligner.
    """
    starts = matches.starts[member_idx]
    lengths = matches.lengths[member_idx]
    G = matches.seq_count
    order = np.argsort(np.abs(starts[:, 0]), kind="stable")
    starts, lengths = starts[order], lengths[order]
    n = len(order)

    segments: list = []
    windows: list = []
    for i in range(n):
        if i > 0:
            gap_starts = np.zeros(G, dtype=np.int64)
            gap_lens = np.zeros(G, dtype=np.int64)
            for g in range(G):
                sp, sc = int(starts[i - 1, g]), int(starts[i, g])
                if sp == NO_MATCH or sc == NO_MATCH:
                    continue
                gs, gl = _gap_region(sp, int(lengths[i - 1]),
                                     sc, int(lengths[i]))
                gap_starts[g], gap_lens[g] = gs, gl
            total = int(gap_lens.max()) if G else 0
            if total == 0:
                pass  # anchors abut in every genome
            elif total > max_window or (gap_lens > 0).sum() < 2:
                # too long, or only one genome has sequence here:
                # staircase blocks (the reference's unaligned fallback)
                for g in np.flatnonzero(gap_lens > 0):
                    gs = np.zeros(G, dtype=np.int64)
                    gl = np.zeros(G, dtype=np.int64)
                    gs[g], gl[g] = gap_starts[g], gap_lens[g]
                    segments.append(Block(gs, gl))
            else:
                frag_ascii = [
                    _fragment_ascii(genomes[g], int(gap_starts[g]),
                                    int(gap_lens[g]))
                    if gap_lens[g] > 0 else
                    np.zeros(0, dtype=np.uint8)
                    for g in range(G)]
                frag_codes = [translate_dna(f) for f in frag_ascii]
                segments.append(("window", len(windows)))
                windows.append((gap_starts, gap_lens, frag_codes,
                                frag_ascii))
        al = np.where(starts[i] != 0, lengths[i], 0)
        segments.append(Block(starts[i].copy(), al))
    return segments, windows


def align_lcbs(matches: MatchArray, members: list[np.ndarray],
               genomes: list[Genome], tree: TreeNode,
               max_window: int = MAX_ALIGNMENT_LENGTH,
               device="cuda") -> list[Interval]:
    """Gapped-align every LCB's inter-anchor windows in one batch
    (AlignLCBInParallel equivalent)."""
    from libmems_tpu_torch import trace
    G = len(genomes)
    with trace.stage("gap_plan"):
        planned = [gapped_interval_from_matches(matches, idx, genomes,
                                                tree, max_window)
                   for idx in members]
    all_windows = [w for _, ws in planned for w in ws]
    if all_windows:
        code_lists = [[w[2][g] for g in range(G)] for w in all_windows]
        with trace.stage("gap_dp"):
            aligned = align_window_group(code_lists, tree, device)
    else:
        aligned = []

    with trace.stage("gap_splice"):
        intervals = []
        w_base = 0
        for segments, ws in planned:
            blocks: list[Block] = []
            for seg in segments:
                if isinstance(seg, Block):
                    blocks.append(seg)
                    continue
                _, wi = seg
                gap_starts, gap_lens, _, frag_ascii = ws[wi]
                rows = aligned[w_base + wi]
                ascii_rows = _rows_to_ascii_block(rows, frag_ascii)
                blocks.append(Block(gap_starts, gap_lens, rows=ascii_rows))
            w_base += len(ws)
            intervals.append(Interval(blocks=blocks, seq_count=G))
    return intervals
