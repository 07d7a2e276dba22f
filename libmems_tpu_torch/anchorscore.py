"""Seed occurrence frequencies + uniqueness-scaled anchor scoring.

Equivalents of:

* SeedOccurrenceList (libMems/SeedOccurrenceList.h:22-92): per-position
  seed frequency = the SML run length of the seed starting at that
  position, then a trailing-window mean over seed_length positions
  ("average frequency of all k-mers containing the position"), floor 1;
* GetPairwiseAnchorScore (libMems/GreedyBreakpointElimination.h:403-474)
  with the reference defaults (penalize_gaps for gapped chunks only,
  penalize_repeats=false, GBE.cpp:37): per column, HOXD70 substitution
  score between the oriented characters, positive scores divided by the
  product of the two genomes' seed frequencies at the column's
  forward-strand offsets from the match left ends.

Both are flat vector passes (run-length scatter + sliding mean; gather +
segment-sum), computed here with numpy over the whole match set at once —
the shapes are data-dependent and the arithmetic is memory-bound, so the
win comes from vectorization, not the MXU.

Port of libmems_tpu/anchorscore.py: the host twin and the scorer are
copied with imports renamed.  The JAX package's device construction
(_seed_occurrence_device), which runs for genomes above SOL_HOST_MAX seed
windows, is kernels K16 and K17 (libmems_tpu_torch.ops.seedocc) on the
SML's device, one pair of launches a genome (the JAX bucket grouping and
vmap only served compile reuse).
"""

from __future__ import annotations

import numpy as np

from libmems_tpu_torch import seeds as seedlib
from libmems_tpu_torch.match import MatchArray, NO_MATCH
from libmems_tpu_torch.ops import seedocc
from libmems_tpu_torch.ops.gapped import HOXD70
from libmems_tpu_torch.ops.mers import key_sentinel
from libmems_tpu_torch.sml import SortedMerList


def _smooth_counts_np(count: np.ndarray, seed_len: int) -> np.ndarray:
    """Trailing-mean smoothing of the seed counts (the op order of the
    JAX package's device construction, so float32 results are bit-equal
    to it)."""
    total_len = count.shape[0]
    if total_len > 1 and seed_len > 0:
        padded = np.concatenate(
            [np.ones(seed_len - 1, np.int32), count])
        csum = np.concatenate([np.zeros(1, np.int64),
                               np.cumsum(padded, dtype=np.int64)])
        smoothed = ((csum[seed_len:] - csum[:-seed_len])
                    .astype(np.float32) / seed_len)
        countf = np.concatenate([smoothed[:-1],
                                 count[-1:].astype(np.float32)])
    else:
        countf = count.astype(np.float32)
    return np.maximum(countf, np.float32(1.0))


def seed_occurrence_list_np(genome, seed: int) -> np.ndarray:
    """Host numpy twin of the JAX package's seed_occurrence_list,
    computed from the genome itself (no SML fetch).  Bit-equal to the
    device construction: same run-length counts, same int64 prefix-sum
    smoothing, same float32 division."""
    from libmems_tpu_torch.ops.mers import canonical_seed_keys_np
    from libmems_tpu_torch.sequence import Genome

    seed_len = seedlib.seed_length(seed)
    if isinstance(genome, Genome):
        codes = genome.codes
        a = genome.ambig
        ambig = a if a.any() else None
        if genome.circular:
            # circular wrap, as SortedMerList.create (SortedMerList
            # .cpp:797-800)
            codes = np.concatenate([codes, codes[: seed_len - 1]])
            if ambig is not None:
                ambig = np.concatenate([ambig, ambig[: seed_len - 1]])
            length = len(codes) - (seed_len - 1)
        else:
            length = len(codes)
    else:
        codes = np.asarray(genome, dtype=np.uint8)
        ambig = None
        length = len(codes)

    keys = canonical_seed_keys_np(codes, seed, ambig)
    n = keys.shape[0]
    if n == 0:
        return np.ones(length, dtype=np.float32)
    content = keys >> np.uint8(1)
    order = np.argsort(content, kind="stable")
    sc = content[order]
    run_start = np.empty(n, dtype=bool)
    run_start[0] = True
    np.not_equal(sc[1:], sc[:-1], out=run_start[1:])
    run_id = np.cumsum(run_start) - 1
    runlen = np.bincount(run_id).astype(np.int32)
    cnt_sorted = runlen[run_id]
    sentinel = ~keys.dtype.type(0)
    cnt_sorted = np.where(keys[order] == sentinel, np.int32(1),
                          cnt_sorted)
    count = np.ones(length, dtype=np.int32)
    count_pos = np.empty(n, dtype=np.int32)
    count_pos[order] = cnt_sorted
    count[:n] = count_pos
    return _smooth_counts_np(count, seed_len)


# device-path threshold of the JAX package: up to this many seed windows
# per genome the host twin runs (one argsort) when the genome is at hand;
# the two routes are bit-equal
SOL_HOST_MAX = 8_000_000


def seed_occurrence_list(sml: SortedMerList) -> np.ndarray:
    """float32[genome_length] smoothed per-position seed frequency
    (SeedOccurrenceList::construct + smoothFrequencies,
    libMems/SeedOccurrenceList.h:22-92), built on the SML's device (K16,
    K17); only the float32 list leaves the device."""
    if sml.n_windows == 0:
        return np.ones(sml.length, dtype=np.float32)
    count = seedocc.seed_run_counts(sml.sorted_keys, sml.sorted_positions,
                                    sml.length, key_sentinel(sml.seed))
    return seedocc.seed_smooth(count, sml.seed_length).cpu().numpy()


def seed_occurrence_lists(smls: list[SortedMerList],
                          genomes: list | None = None
                          ) -> list[np.ndarray]:
    """Seed occurrence lists of many genomes.  When `genomes` is given,
    genomes with at most SOL_HOST_MAX seed windows run the bit-equal host
    twin (seed_occurrence_list_np), as the JAX package does; larger
    genomes, and every genome of a call without `genomes`, run the device
    construction (seed_occurrence_list)."""
    out = []
    for i, s in enumerate(smls):
        if genomes is not None and 0 < s.n_windows <= SOL_HOST_MAX:
            out.append(seed_occurrence_list_np(genomes[i], s.seed))
        else:
            out.append(seed_occurrence_list(s))
    return out


def pairwise_anchor_scores(matches: MatchArray, gi: int, gj: int,
                           codes: list[np.ndarray],
                           sols: list[np.ndarray]) -> np.ndarray:
    """Per-match uniqueness-scaled substitution score between genomes
    gi and gj (GetPairwiseAnchorScore over ungapped matches).

    Matches not including both genomes score 0.  codes[g] are 2-bit
    genome codes; sols[g] the seed-occurrence arrays.
    """
    n = len(matches)
    out = np.zeros(n, dtype=np.float64)
    si = matches.starts[:, gi]
    sj = matches.starts[:, gj]
    sel = (si != NO_MATCH) & (sj != NO_MATCH)
    if not sel.any():
        return out
    idx = np.flatnonzero(sel)
    L = matches.lengths[idx]
    si, sj = si[idx], sj[idx]

    total = int(L.sum())
    mid = np.repeat(np.arange(len(idx)), L)
    starts_flat = np.concatenate([[0], np.cumsum(L)[:-1]])
    col = np.arange(total) - starts_flat[mid]

    def oriented(codes_g, s, lens):
        le = np.abs(s) - 1
        fwd = s > 0
        pos = np.where(fwd[mid], le[mid] + col,
                       le[mid] + lens[mid] - 1 - col)
        c = codes_g[pos]
        return np.where(fwd[mid], c, 3 - c)

    ci = oriented(codes[gi], si, L)
    cj = oriented(codes[gj], sj, L)
    sub = HOXD70[ci, cj].astype(np.float64)

    lei = (np.abs(si) - 1)[mid] + col
    lej = (np.abs(sj) - 1)[mid] + col
    uni = sols[gi][np.minimum(lei, len(sols[gi]) - 1)].astype(np.float64) \
        * sols[gj][np.minimum(lej, len(sols[gj]) - 1)].astype(np.float64)
    uni = np.maximum(uni, 1.0)
    scaled = np.where(sub > 0, sub / uni, sub)
    np.add.at(out, idx[mid], scaled)
    return out


def sum_of_pairs_anchor_scores(matches: MatchArray,
                               codes: list[np.ndarray],
                               sols: list[np.ndarray],
                               pairs: list[tuple[int, int]] | None = None
                               ) -> np.ndarray:
    """Σ over genome pairs of pairwise anchor scores (the progressive
    aligner's tm_score_array collapsed over its pair axes,
    ProgressiveAligner::pairwiseScoreTrackingMatches, PA.cpp:1790)."""
    G = matches.seq_count
    if pairs is None:
        pairs = [(i, j) for i in range(G) for j in range(i + 1, G)]
    total = np.zeros(len(matches), dtype=np.float64)
    for i, j in pairs:
        total += pairwise_anchor_scores(matches, i, j, codes, sols)
    return total
