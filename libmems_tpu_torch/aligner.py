"""Flat N-way aligner orchestration (Mauve 1.x pipeline).

Port of libmems_tpu/aligner.py (Aligner::align,
libMems/Aligner.cpp:2193-2286), for any number of genomes:

  SML build -> multi-MUM discovery -> EliminateOverlaps ->
  MultiplicityFilter(n) -> LCBs with the LCB-extension loop -> NJ guide
  tree -> recursive anchor fill -> batched gapped alignment of the
  inter-anchor windows -> unaligned intervals (-> XMFA).

Every tensor lives on ``AlignerConfig.device``; with
``AlignerConfig.mesh`` set, seeding runs through the seed-prefix-sharded
pipeline over the mesh's devices (parallel.shard.sharded_find_mums),
which finds the same MUMs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from libmems_tpu_torch import cuda
from libmems_tpu_torch import seeds as seedlib
from libmems_tpu_torch import trace
from libmems_tpu_torch.distance import distance_matrix
from libmems_tpu_torch.gbe import eliminate_below_weight, surviving_members
from libmems_tpu_torch.interval import Interval, Block, IntervalList, \
    interval_from_matches
from libmems_tpu_torch.lcb import compute_lcb_set, eliminate_overlaps
from libmems_tpu_torch.match import MatchArray
from libmems_tpu_torch.matchfind import find_mums
from libmems_tpu_torch.sequence import Genome
from libmems_tpu_torch.sml import create_smls
from libmems_tpu_torch.tree import midpoint_root, neighbor_joining


@dataclass
class AlignerConfig:
    """Typed configuration for the flat aligner (replaces the setter
    methods on Aligner, libMems/Aligner.h:180-196)."""

    seed: int | None = None           # spaced seed pattern; None = default
    seed_rank: int = 0
    min_lcb_weight: float | None = None  # None = 3 * seed_weight * n
    repeat_tolerance: int = 0
    gapped_alignment: bool = False    # anchors-only when False
    max_gapped_window: int = 10000    # GappedAligner.h:25
    recursive: bool = True            # re-seed inter-anchor gaps
                                      # (Aligner::Recursion, Aligner.cpp:1078)
    min_recursive_gap: int = 32       # skip tiny gaps (DP handles them)
    lcb_extension: bool = True        # search collinear inter-LCB gaps
                                      # (SearchLCBGaps, Aligner.cpp:784)
    collinear: bool = False           # assume no rearrangements: remove
                                      # breakpoints until one LCB remains
                                      # (SimpleBreakpointScorer collinear
                                      # mode, GBE.cpp:877)
    seed_families: int = 1            # >1: union gap-search MUMs over this
                                      # many same-weight seed patterns
                                      # (pairwiseAnchorSearch seed_count=3,
                                      # ProgressiveAligner.cpp:619-651)
    mesh: object | None = None        # parallel.Mesh or a shard count:
                                      # seed-prefix-sharded seeding
    device: str = "cuda"              # every tensor of the run lives here


def add_unaligned_intervals(intervals: list[Interval],
                            genomes: list[Genome]) -> list[Interval]:
    """Append single-genome intervals covering every base outside all
    LCBs, so the output is a full partition of every genome
    (addUnalignedIntervals, libMems/Aligner.cpp:2284 / Islands.h:318)."""
    G = len(genomes)
    out = list(intervals)
    for g in range(G):
        covered = []
        for iv in intervals:
            le = int(iv.left_ends()[g])
            if le == 0:
                continue
            covered.append((le, int(iv.right_ends()[g])))
        covered.sort()
        cursor = 1
        ranges = []
        for lo, hi in covered:
            if lo > cursor:
                ranges.append((cursor, lo - 1))
            cursor = max(cursor, hi + 1)
        if cursor <= len(genomes[g]):
            ranges.append((cursor, len(genomes[g])))
        for lo, hi in ranges:
            s = np.zeros(G, dtype=np.int64)
            l = np.zeros(G, dtype=np.int64)
            s[g], l[g] = lo, hi - lo + 1
            out.append(Interval(blocks=[Block(s, l)], seq_count=G))
    return out


def _collinear_gap_windows(lcbs, members, mums, genomes):
    """Windows between LCBs that are adjacent in every genome with
    consistent orientation (the search regions of SearchLCBGaps /
    CreateGapSearchList, Aligner.cpp:720-970), plus leading/trailing
    flanks when all genomes agree on their first/last LCB."""
    from libmems_tpu_torch.lcb import find_boundaries
    G = len(genomes)
    bounds = []
    for idx in members:
        le, span, ori = find_boundaries(mums.starts[idx],
                                        mums.lengths[idx])
        bounds.append((le, le + span - 1, ori))
    order = np.argsort([b[0][0] for b in bounds])
    windows = []

    def add_window(gs, gl):
        if (gl > 0).sum() >= 2:
            windows.append((gs, gl))

    # leading flank: before the first LCB of every genome (if consistent)
    for g_end in (False, True):
        gs = np.zeros(G, dtype=np.int64)
        gl = np.zeros(G, dtype=np.int64)
        for g in range(G):
            firsts = sorted(range(len(bounds)),
                            key=lambda i: bounds[i][0][g])
            i = firsts[-1] if g_end else firsts[0]
            le, re, ori = bounds[i]
            if g_end:
                lo, hi = re[g] + 1, len(genomes[g])
            else:
                lo, hi = 1, le[g] - 1
            if hi >= lo:
                gs[g] = lo   # flank frames are forward; inverted flank
                gl[g] = hi - lo + 1  # matches re-enter via new LCBs
        add_window(gs, gl)

    # between genome-0-consecutive LCB pairs adjacent in all genomes
    for a, b in zip(order[:-1], order[1:]):
        le_a, re_a, ori_a = bounds[a]
        le_b, re_b, ori_b = bounds[b]
        gs = np.zeros(G, dtype=np.int64)
        gl = np.zeros(G, dtype=np.int64)
        consistent = True
        rel0 = ori_a[0] == ori_b[0]
        for g in range(G):
            if (ori_a[g] == ori_b[g]) != rel0:
                consistent = False
                break
            lo = min(re_a[g], re_b[g]) + 1
            hi = max(le_a[g], le_b[g]) - 1
            if hi >= lo:
                sign = 1 if ori_a[0] == ori_a[g] else -1
                gs[g] = sign * lo
                gl[g] = hi - lo + 1
        if consistent:
            add_window(gs, gl)
    return windows


def _extend_lcb_anchors(mums: MatchArray, genomes: list[Genome],
                        seed: int, min_weight: float, max_rounds: int = 3,
                        seed_families: int = 1, device="cuda"):
    """LCB extension loop (RecursiveAnchorSearch extension rounds,
    Aligner.cpp:1951-2190): search collinear inter-LCB gaps for new
    full-n-way matches, then recompute LCBs + GBE; repeat until no gap
    yields anchors."""
    from libmems_tpu_torch.recursion import search_gaps_batch
    seq_count = len(genomes)
    lcbs = compute_lcb_set(mums)
    eliminate_below_weight(lcbs, min_weight)
    members = surviving_members(lcbs)
    for _ in range(max_rounds):
        # n-way-only masked searches (MaskedMemHash via seq_mask;
        # SearchLCBGaps, Aligner.cpp:2208-2212), batched per round
        jobs = [(gs, gl, seed) for gs, gl in
                _collinear_gap_windows(lcbs, members, mums, genomes)]
        new = []
        for found in search_gaps_batch(genomes, jobs,
                                       seed_families=seed_families,
                                       nway=True, device=device):
            found = found.multiplicity_filter(seq_count)
            if len(found):
                new.append(found)
        if not new:
            break
        mums = MatchArray.concat([mums] + new).dedup().canonical_sort()
        lcbs = compute_lcb_set(mums)
        eliminate_below_weight(lcbs, min_weight)
        members = surviving_members(lcbs)
    return mums, members


def resolve_mesh(mesh, device="cuda"):
    """A Mesh as given; a shard count as that many devices of the run's
    device type (make_mesh's first n cards, or n CPU shards where the run
    asked for the CPU); None passes through."""
    if mesh is None:
        return None
    from libmems_tpu_torch.parallel.shard import Mesh, make_mesh
    if isinstance(mesh, Mesh):
        return mesh
    if cuda.resolve_device(device).type == "cpu":
        return Mesh([device] * int(mesh))
    return make_mesh(int(mesh))


def _build_index_maybe_multihost(genomes, cfg: AlignerConfig, device):
    """SML construction, host-sharded under multi-process execution: with
    cfg.mesh set and torch.distributed spanning two or more processes,
    each process builds only the indexes of the genomes it owns and the
    position-order key tables are exchanged once (parallel.multihost;
    dmSML bin ownership promoted to processes).  Otherwise the ordinary
    build.  Returns (SMLs or KeyTables, seed)."""
    from libmems_tpu_torch.parallel.shard import process_count
    if resolve_mesh(cfg.mesh, cfg.device) is not None \
            and process_count() > 1:
        from libmems_tpu_torch.parallel import multihost as mh
        from libmems_tpu_torch.sml import default_seed
        seed = cfg.seed if cfg.seed is not None else \
            default_seed(genomes, cfg.seed_rank)
        owned = mh.build_owned_smls(genomes, seed, device=device)
        return mh.gather_key_tables(owned, len(genomes), seed), seed
    return create_smls(genomes, cfg.seed, cfg.seed_rank, device=device)


def _find_mums_maybe_sharded(smls, cfg: AlignerConfig) -> MatchArray:
    """Seed discovery through the single-device pipeline or, when
    cfg.mesh is set, the seed-prefix-sharded one: both find the same
    unique MUMs, as ParallelMemHash::FindMatches fed the aligner what
    MemHash::FindMatches did (Aligner.cpp:2193)."""
    mesh = resolve_mesh(cfg.mesh, cfg.device)
    if mesh is None:
        return find_mums(smls, repeat_tolerance=cfg.repeat_tolerance)
    from libmems_tpu_torch.parallel.shard import sharded_find_mums
    return sharded_find_mums(smls, mesh,
                             repeat_tolerance=cfg.repeat_tolerance)


def _config_device(arguments):
    """cuda.entry's pick: the device of the run's config."""
    return (arguments["config"] or AlignerConfig()).device


@cuda.entry(_config_device)
def align(genomes: list[Genome], config: AlignerConfig | None = None
          ) -> tuple[IntervalList, MatchArray]:
    """Run the flat aligner (Aligner::align,
    Aligner.cpp:2193-2286) on ``config.device``; returns (intervals,
    mums)."""
    cfg = config or AlignerConfig()
    seq_count = len(genomes)
    if seq_count < 2:
        raise ValueError("need at least two genomes")
    device = cuda.resolve_device(cfg.device)

    with trace.stage("sml_build"):
        smls, seed = _build_index_maybe_multihost(genomes, cfg, device)
    with trace.stage("mum_find"):
        mums = _find_mums_maybe_sharded(smls, cfg)

    # Step 2-3 (Aligner.cpp:2217-2247): overlap trim, then keep only
    # full n-way multi-MUMs
    mums = eliminate_overlaps(mums)
    mums = mums.multiplicity_filter(seq_count)
    if len(mums) == 0:
        return IntervalList([], list(genomes)), mums

    # Step 4-7: LCB formation + greedy elimination at minimum weight
    min_weight = cfg.min_lcb_weight
    if min_weight is None:
        min_weight = 3 * seedlib.seed_weight(seed) * seq_count
    with trace.stage("lcb_gbe"):
        if cfg.collinear:
            from libmems_tpu_torch.gbe import SimpleBreakpointScorer, \
                greedy_breakpoint_elimination
            lcbs = compute_lcb_set(mums)
            scorer = SimpleBreakpointScorer(lcbs, float(min_weight),
                                            collinear=True)
            greedy_breakpoint_elimination(lcbs, scorer)
            members = surviving_members(lcbs)
        elif cfg.lcb_extension:
            mums, members = _extend_lcb_anchors(
                mums, genomes, seed, float(min_weight),
                seed_families=cfg.seed_families, device=device)
        else:
            lcbs = compute_lcb_set(mums)
            eliminate_below_weight(lcbs, float(min_weight))
            members = surviving_members(lcbs)

    if not cfg.gapped_alignment:
        intervals = [interval_from_matches(mums, idx) for idx in members]
        return IntervalList(intervals, list(genomes)), mums

    # NJ guide tree from anchor identity (Aligner.cpp:2230-2240) drives
    # both recursion seeding and the MSA merge order
    dm = distance_matrix(mums, [len(g) for g in genomes])
    tree = midpoint_root(neighbor_joining(dm))

    if cfg.recursive:
        from libmems_tpu_torch.recursion import recursive_anchor_fill
        with trace.stage("recursion"):
            mums, members = recursive_anchor_fill(
                mums, members, genomes, seed,
                min_gap=cfg.min_recursive_gap,
                seed_families=cfg.seed_families, device=device)

    from libmems_tpu_torch.gapalign import align_lcbs
    with trace.stage("gapped_align"):
        intervals = align_lcbs(mums, members, genomes, tree,
                               max_window=cfg.max_gapped_window,
                               device=device)
    with trace.stage("unaligned_intervals"):
        intervals = add_unaligned_intervals(intervals, genomes)
    return IntervalList(intervals, list(genomes)), mums
