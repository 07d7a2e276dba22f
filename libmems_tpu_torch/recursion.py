"""Recursive inter-anchor anchoring: re-seed the gaps between anchors
with smaller spaced seeds.

Equivalent of Aligner::Recursion (libMems/Aligner.cpp:1078-1291) and the
per-gap re-search of SearchWithinLCB (:1472-1583): for every gap between
consecutive anchors of an LCB, build small in-memory SMLs over the gap
fragments with a seed sized for the gap (MatchList::GetDefaultMerSize
semantics), find MUMs among the fragments, translate their coordinates
back into the global frame, and keep a collinear chain consistent with
the enclosing LCB.  Repeats until no gap yields new anchors.

The fragment-local searches reuse the pair MUM pipeline
(libmems_tpu_torch.matchfind): small fragment pairs run its numpy twin in
a fork pool, larger ones the device pipeline on the run's `device` in the
parent process; coordinate translation is pure index algebra on signed
starts (AbstractMatch sign conventions).
"""

from __future__ import annotations

import os

import numpy as np

from libmems_tpu_torch import seeds as seedlib
from libmems_tpu_torch.match import MatchArray, NO_MATCH
from libmems_tpu_torch.matchfind import find_mums
from libmems_tpu_torch.sequence import (Genome, ambig_mask, revcomp_ascii,
                                  translate_dna)
from libmems_tpu_torch.sml import SortedMerList


def _local_to_global(sl: int, L: int, gs: int, n: int) -> int:
    """Translate a signed fragment-local 1-based start to a signed
    global start.  gs = fragment's signed global start, n = fragment
    length."""
    if sl > 0:
        if gs > 0:
            return gs + sl - 1
        return -(abs(gs) + n - (sl - 1) - L)
    if gs > 0:
        return -(gs + abs(sl) - 1)
    return abs(gs) + n - (abs(sl) - 1) - L


def _chain_collinear(starts: np.ndarray, lengths: np.ndarray
                     ) -> np.ndarray:
    """Greedy collinear chain filter over fragment-local matches: keep
    matches whose every genome's local start is positive (consistent
    relative orientation) and strictly non-overlapping/increasing in all
    genomes along the genome-0 order."""
    n = len(lengths)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    ok_fwd = (starts > 0).all(axis=1)
    idx = np.flatnonzero(ok_fwd)
    if idx.size == 0:
        return idx
    order = idx[np.argsort(starts[idx, 0], kind="stable")]
    kept = []
    prev_end = None
    for i in order:
        s = starts[i]
        if prev_end is not None and not (s > prev_end).all():
            continue
        kept.append(i)
        prev_end = s + lengths[i] - 1
    return np.array(kept, dtype=np.int64)


def _gap_windows(starts: np.ndarray, lengths: np.ndarray, G: int):
    """Per consecutive anchor pair: (insert_after_row, gap_starts[G],
    gap_lens[G]) in LCB order (genome-0 ascending)."""
    from libmems_tpu_torch.gapalign import _gap_region
    out = []
    for i in range(1, len(lengths)):
        gs = np.zeros(G, dtype=np.int64)
        gl = np.zeros(G, dtype=np.int64)
        for g in range(G):
            sp, sc = int(starts[i - 1, g]), int(starts[i, g])
            if sp == NO_MATCH or sc == NO_MATCH:
                continue
            s, l = _gap_region(sp, int(lengths[i - 1]), sc, int(lengths[i]))
            gs[g], gl[g] = s, l
        out.append((i, gs, gl))
    return out


def search_gap(genomes: list[Genome], gap_starts: np.ndarray,
               gap_lens: np.ndarray, seed: int,
               seed_families: int = 1, nway: bool = False,
               device="cuda") -> MatchArray:
    """Find MUMs among the gap fragments; returns matches in GLOBAL
    signed coordinates (pairwiseAnchorSearch / SearchWithinLCB analog).

    seed_families > 1 unions the MUMs found with that many same-weight
    seed patterns of increasing sensitivity rank before deduping —
    ProgressiveAligner::pairwiseAnchorSearch's use_seed_families mode
    (ProgressiveAligner.cpp:619-651, seed_count = 3).

    nway=True is the MaskedMemHash mode of SearchLCBGaps
    (Aligner.cpp:2208-2212 + MaskedMemHash.cpp:38-63): only seeds in
    which EVERY genome participates are kept, rejected before extension;
    a gap where any genome's fragment is below seed length cannot yield
    an n-way match and returns empty."""
    from libmems_tpu_torch import trace
    with trace.stage("search_gap"):
        return _search_gap(genomes, gap_starts, gap_lens, seed,
                           seed_families, nway, device)


def _prep_gap(genomes, gap_starts, gap_lens, seed, nway: bool):
    """Fragment extraction for one gap search.  Returns the worker
    payload (frags, frag_ambig, members) or None when the gap cannot
    yield a match."""
    G = len(genomes)
    seed_len = seedlib.seed_length(seed)
    frags = []
    frag_ambig = []
    members = []
    for g in range(G):
        if gap_lens[g] < seed_len:
            continue
        le = abs(int(gap_starts[g]))
        a = genomes[g].ascii[le - 1: le - 1 + int(gap_lens[g])]
        if gap_starts[g] < 0:
            a = revcomp_ascii(a)
        frags.append(translate_dna(a))
        amb = ambig_mask(a)
        frag_ambig.append(amb if amb.any() else None)
        members.append(g)
    if len(members) < 2 or (nway and len(members) < G):
        return None
    return frags, frag_ambig, members


def _host_eligible(frags, members) -> bool:
    """Small fragment pairs run the single-core numpy twin of the fused
    pair pipeline — device dispatch latency dwarfs the compute at
    gap-search scale (a G==2 full mask equals the pair path's exact-pair
    semantics); these jobs are also safe for a fork-pool worker (numpy
    only: no torch or CUDA call)."""
    from libmems_tpu_torch.matchfind import HOST_PAIR_CUTOFF
    return (len(members) == 2
            and sum(len(f) for f in frags) <= HOST_PAIR_CUTOFF)


def _search_frags(frags, frag_ambig, members, G, gap_starts, gap_lens,
                  seed, seed_families, nway, use_host,
                  device=None) -> MatchArray:
    """Family-union MUM search over prepared fragments + translation to
    global coordinates.  With use_host=True this is numpy-only (fork-
    pool safe); otherwise it builds SMLs on `device`."""
    seq_mask = (1 << len(members)) - 1 if nway else 0
    weight = seedlib.seed_weight(seed)
    from libmems_tpu_torch.matchfind import find_pair_mums_np
    found: list[MatchArray] = []
    for rank in range(max(1, seed_families)):
        try:
            fam_seed = seed if rank == 0 else seedlib.get_seed(weight, rank)
        except (KeyError, ValueError):
            break
        if use_host:
            fam = find_pair_mums_np(frags[0], frags[1], fam_seed,
                                    frag_ambig[0], frag_ambig[1])
        else:
            smls = [SortedMerList.create(f, fam_seed, ambig=amb,
                                         device=device)
                    for f, amb in zip(frags, frag_ambig)]
            fam = find_mums(smls, seq_mask=seq_mask)
        if len(fam):
            found.append(fam)
    if not found:
        return MatchArray.empty(G)
    local = found[0]
    for fam in found[1:]:
        local = MatchArray(
            np.concatenate([local.starts, fam.starts]),
            np.concatenate([local.lengths, fam.lengths]))
    local = local.dedup()
    if len(local) == 0:
        return MatchArray.empty(G)
    # only matches including every fragment genome stay anchors
    local = local.multiplicity_filter(len(members))
    keep = _chain_collinear(local.starts, local.lengths)
    if keep.size == 0:
        return MatchArray.empty(G)
    gstarts = np.zeros((keep.size, G), dtype=np.int64)
    for row, i in enumerate(keep):
        for m, g in enumerate(members):
            gstarts[row, g] = _local_to_global(
                int(local.starts[i, m]), int(local.lengths[i]),
                int(gap_starts[g]), int(gap_lens[g]))
    return MatchArray(gstarts, local.lengths[keep])


def _search_gap(genomes, gap_starts, gap_lens, seed,
                seed_families=1, nway=False, device="cuda") -> MatchArray:
    G = len(genomes)
    prep = _prep_gap(genomes, gap_starts, gap_lens, seed, nway)
    if prep is None:
        return MatchArray.empty(G)
    frags, frag_ambig, members = prep
    return _search_frags(frags, frag_ambig, members, G, gap_starts,
                         gap_lens, seed, seed_families, nway,
                         _host_eligible(frags, members), device)


# how many host-eligible jobs justify spinning up the fork pool, and
# its size; LIBMEMS_TPU_POOL=0 disables pooling entirely
_POOL_MIN_JOBS = int(os.environ.get("LIBMEMS_TPU_POOL_MIN_JOBS", 8))
_POOL_SIZE = int(os.environ.get("LIBMEMS_TPU_POOL",
                                min(os.cpu_count() or 1, 16)))


def _pool_worker(payload):
    frags, frag_ambig, members, G, gap_starts, gap_lens, seed, \
        seed_families, nway = payload
    return _search_frags(frags, frag_ambig, members, G, gap_starts,
                         gap_lens, seed, seed_families, nway, True)


def search_gaps_batch(genomes: list[Genome], jobs: list,
                      seed_families: int = 1,
                      nway: bool = False,
                      device="cuda") -> list[MatchArray]:
    """Batched gap re-anchoring: collect-then-run all (gap, seed) jobs
    of a recursion round instead of one `search_gap` at a time (the
    reference ran these under `#pragma omp parallel for`,
    ProgressiveAligner.cpp:695; here the sub-cutoff host-twin searches
    fan out over a fork pool and the rare device-scale jobs run in the
    parent on `device`; the forked children run numpy only, never torch
    or CUDA, which the parent may already have initialised).

    `jobs` is a list of (gap_starts[G], gap_lens[G], seed); returns one
    MatchArray per job, order-preserving.
    """
    from libmems_tpu_torch import trace
    G = len(genomes)
    results: list[MatchArray | None] = [None] * len(jobs)
    pool_payloads: list[tuple[int, tuple]] = []
    with trace.stage("search_gap_batch"):
        for i, (gs, gl, seed) in enumerate(jobs):
            prep = _prep_gap(genomes, gs, gl, seed, nway)
            if prep is None:
                results[i] = MatchArray.empty(G)
                continue
            frags, frag_ambig, members = prep
            if _host_eligible(frags, members):
                pool_payloads.append(
                    (i, (frags, frag_ambig, members, G, gs, gl, seed,
                         seed_families, nway)))
            else:
                # device-scale job: must run in the parent process
                results[i] = _search_frags(
                    frags, frag_ambig, members, G, gs, gl, seed,
                    seed_families, nway, False, device)
        if (_POOL_SIZE > 1 and len(pool_payloads) >= _POOL_MIN_JOBS
                and hasattr(os, "fork")):
            import multiprocessing as mp
            ctx = mp.get_context("fork")
            with ctx.Pool(processes=min(_POOL_SIZE,
                                        len(pool_payloads))) as pool:
                outs = pool.map(_pool_worker,
                                [p for _, p in pool_payloads])
            for (i, _), out in zip(pool_payloads, outs):
                results[i] = out
        else:
            for i, payload in pool_payloads:
                results[i] = _pool_worker(payload)
    return results


def recursive_anchor_fill(matches: MatchArray, members: list[np.ndarray],
                          genomes: list[Genome], seed: int,
                          min_gap: int = 32, max_rounds: int = 3,
                          seed_families: int = 1, device="cuda"
                          ) -> tuple[MatchArray, list[np.ndarray]]:
    """Iteratively densify every LCB's anchor set (Recursion equivalent).

    Returns (matches', members'): the input MatchArray extended with the
    newly found gap anchors, and updated member index lists.
    """
    G = len(genomes)
    for _ in range(max_rounds):
        new_rows: list[np.ndarray] = []
        new_lens: list[int] = []
        grew = False
        # collect-then-batch: every LCB's gap jobs for this round run as
        # one search_gaps_batch call (pooled host twins)
        jobs: list[tuple] = []
        job_owner: list[int] = []
        member_rows_all: list[list[int]] = []
        for mi, idx in enumerate(members):
            s = matches.starts[idx]
            l = matches.lengths[idx]
            order = np.argsort(np.abs(s[:, 0]), kind="stable")
            s, l, idx = s[order], l[order], idx[order]
            member_rows_all.append(list(idx))
            for _, gs, gl in _gap_windows(s, l, G):
                active = gl[gl > 0]
                if active.size < 2 or int(gl.max()) < min_gap:
                    continue
                gap_seed_w = seedlib.default_seed_weight(int(active.mean()))
                if gap_seed_w == 0:
                    continue
                gap_seed = seedlib.get_seed(
                    min(gap_seed_w, seedlib.seed_weight(seed)), 0)
                jobs.append((gs, gl, gap_seed))
                job_owner.append(mi)
        founds = search_gaps_batch(genomes, jobs,
                                   seed_families=seed_families,
                                   device=device)
        for mi, found in zip(job_owner, founds):
            for row, ln in zip(found.starts, found.lengths):
                member_rows_all[mi].append(
                    matches.n_matches + len(new_rows))
                new_rows.append(row)
                new_lens.append(int(ln))
                grew = True
        next_members = [np.array(rows, dtype=np.int64)
                        for rows in member_rows_all]
        if not grew:
            break
        matches = MatchArray(
            np.concatenate([matches.starts, np.stack(new_rows)]),
            np.concatenate([matches.lengths,
                            np.array(new_lens, dtype=np.int64)]))
        members = next_members
    return matches, members
