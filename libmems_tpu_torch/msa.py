"""Progressive multiple sequence alignment (the MUSCLE replacement,
MuscleInterface::CallMuscleFast / RefineFast / ProfileAlignFast,
libMems/MuscleInterface.cpp:727-769, :823, :1053).

Port of libmems_tpu/msa.py, copied with imports renamed and a `device`
on every function that reaches the profile DP.  Windows are aligned by

1. a k-mer-fraction distance matrix over the window's sequences
   (MUSCLE stage-1 analog),
2. a neighbor-joining guide tree (libmems_tpu_torch.tree),
3. progressive profile-profile alignment up the tree, where every
   merge level runs as ONE batched profile DP over all windows sharing
   the tree (libmems_tpu_torch.ops.profile),
4. optional iterative refinement: bipartition re-alignment kept only
   when the sum-of-pairs score improves (RefineFast analog), gated by
   the forward-only DP scores (profile_scores_batch).
"""

from __future__ import annotations

import os

import numpy as np

from libmems_tpu_torch import trace
from libmems_tpu_torch.ops.profile import (GAP_CODE, align_profile_batch,
                                           profile_path_score,
                                           profile_path_scores_single,
                                           profile_scores_batch)
from libmems_tpu_torch.scoring import codes_rows_to_ascii, sp_score
from libmems_tpu_torch.tree import TreeNode, neighbor_joining

MAX_ALIGNMENT_LENGTH = 10000   # GappedAligner.h:25 default window cap


# --------------------------------------------------------------------------
# guide tree from k-mer distance (MUSCLE stage-1 analog)
# --------------------------------------------------------------------------

def kmer_distance_matrix(seqs: list[np.ndarray], k: int = 6) -> np.ndarray:
    """1 − shared-k-mer fraction over 2-bit code sequences."""
    G = len(seqs)
    sets = []
    for s in seqs:
        if len(s) < k:
            sets.append(frozenset())
            continue
        kmers = np.zeros(len(s) - k + 1, dtype=np.int64)
        for i in range(k):
            kmers = (kmers << 2) | s[i: len(s) - k + 1 + i].astype(np.int64)
        sets.append(frozenset(np.unique(kmers).tolist()))
    D = np.zeros((G, G))
    for i in range(G):
        for j in range(i + 1, G):
            a, b = sets[i], sets[j]
            denom = min(len(a), len(b))
            frac = len(a & b) / denom if denom else 0.0
            D[i, j] = D[j, i] = 1.0 - frac
    return D


def _binary_merge_order(tree: TreeNode) -> list[tuple]:
    """Postorder merge schedule: each step is (kind, payload) where
    kind='leaf' payload=seq_id, kind='merge' payload=(slot_a, slot_b);
    slots index the schedule list itself."""
    schedule: list[tuple] = []

    def visit(node: TreeNode) -> int:
        if node.is_leaf():
            schedule.append(("leaf", node.sequence_id))
            return len(schedule) - 1
        slots = [visit(c) for c in node.children]
        left = slots[0]
        for right in slots[1:]:
            schedule.append(("merge", (left, right)))
            left = len(schedule) - 1
        return left

    visit(tree)
    return schedule


# --------------------------------------------------------------------------
# progressive alignment over batched windows
# --------------------------------------------------------------------------

def align_window_group(windows: list[list[np.ndarray]],
                       tree: TreeNode, device="cuda") -> list[np.ndarray]:
    """Align many windows sharing one guide tree on `device`.

    windows[w][g]: uint8 2-bit codes of member g's fragment in window w
    (fragment order must match the tree's leaf sequence_ids).  Returns
    per-window alignment rows uint8[G, C] with GAP_CODE=4, rows ordered
    by sequence_id.
    """
    n_w = len(windows)
    if n_w == 0:
        return []
    schedule = _binary_merge_order(tree)
    # state[slot][w] = (row_ids, rows uint8[n, C])
    state: list = [None] * len(schedule)
    for si, (kind, payload) in enumerate(schedule):
        if kind == "leaf":
            g = payload
            state[si] = [(np.array([g]),
                          windows[w][g].reshape(1, -1).astype(np.uint8))
                         for w in range(n_w)]
        else:
            a_slot, b_slot = payload
            p_rows = [state[a_slot][w][1] for w in range(n_w)]
            q_rows = [state[b_slot][w][1] for w in range(n_w)]
            merged = align_profile_batch(p_rows, q_rows, device=device)
            ids = [np.concatenate([state[a_slot][w][0],
                                   state[b_slot][w][0]])
                   for w in range(n_w)]
            state[si] = list(zip(ids, merged))
            state[a_slot] = state[b_slot] = None  # free
    out = []
    for w in range(n_w):
        ids, rows = state[-1][w]
        order = np.argsort(ids)
        out.append(rows[order])
    return out


def align_codes(seqs: list[np.ndarray], tree: TreeNode | None = None,
                refine_iters: int = 0, device="cuda") -> np.ndarray:
    """Align one window of 2-bit code sequences on `device`; returns rows
    uint8[G, C] (4 = gap) in input order (CallMuscleFast equivalent)."""
    G = len(seqs)
    if G == 1:
        return seqs[0].reshape(1, -1).astype(np.uint8)
    if tree is None:
        tree = neighbor_joining(kmer_distance_matrix(seqs))
    rows = align_window_group([seqs], tree, device=device)[0]
    if refine_iters:
        rows = refine(rows, tree, iters=refine_iters, device=device)
    return rows


# --------------------------------------------------------------------------
# iterative refinement (RefineFast analog)
# --------------------------------------------------------------------------

def _drop_all_gap_columns(rows: np.ndarray) -> np.ndarray:
    keep = (rows != GAP_CODE).any(axis=0)
    return rows[:, keep]


# fork-pool plumbing for the refinement gate's path-score sweep: the
# parent stores the shared state, forked children inherit it copy-on-
# write and run numpy only, never torch or CUDA (the same pattern as
# recursion.search_gaps_batch)
_PATH_GATE_STATE: dict = {}


def _path_gate_worker(w):
    return profile_path_scores_single(_PATH_GATE_STATE["best"][w])


def _bipartitions(tree: TreeNode, G: int) -> list[np.ndarray]:
    """Edge-induced leaf bipartitions (one side's sequence_ids each)."""
    parts = []
    for node in tree.postorder():
        if node is tree:
            continue
        ids = sorted(node.descendant_leaf_ids())
        if 0 < len(ids) < G:
            parts.append(np.array(ids))
    return parts


def refine_windows(chunks: list[np.ndarray], iters: int = 1,
                   device="cuda") -> list[np.ndarray]:
    """Batched single-row-bipartition refinement across MANY windows.

    The windowed refinement pass (refineAlignment, PA.cpp:1118-1239)
    produces dozens-to-hundreds of column windows per block.  Each
    row-bipartition round runs ONE align_profile_batch over every
    window, and acceptance (keep iff the window's sum-of-pairs score
    improves) stays per-window: identical results to mapping
    `refine(..., tree=None)` over the windows, at 1/len(chunks) the
    launch count.
    """
    if not chunks:
        return []
    G = chunks[0].shape[0]
    if G < 3:
        return list(chunks)
    best = [c for c in chunks]
    best_score = [sp_score(codes_rows_to_ascii(b)) for b in best]

    def gate(w, mask):
        """(p, q) for window w under a row bipartition, or None when a
        side is empty.  Score gate: the traceback runs ONLY where the
        forward-optimal score beats the current alignment's own path
        score (most windows of a near-identical family are already
        optimal).  tol absorbs f32-forward vs f64-path accumulation
        drift; improvements below it are sub-mismatch noise."""
        p = _drop_all_gap_columns(best[w][mask])
        q = _drop_all_gap_columns(best[w][~mask])
        if not (p.shape[1] and q.shape[1]):
            return None
        return p, q

    def path_tol(w, mask):
        cur = profile_path_score(best[w][mask], best[w][~mask])
        return cur, 1e-4 * abs(cur) + 10.0

    def path_scores_all(job_key):
        """Path scores for every (bipartition, window) job.  All gate
        bipartitions are single-row, so each WINDOW's G scores come from
        one vectorized profile_path_scores_single pass; windows fan out
        over a fork pool when available (children inherit `best` by
        fork)."""
        from libmems_tpu_torch.recursion import _POOL_SIZE
        wins = sorted({w for _, w in job_key})
        if (_POOL_SIZE > 1 and len(wins) >= 32 and hasattr(os, "fork")):
            import multiprocessing as mp
            _PATH_GATE_STATE["best"] = best
            try:
                ctx = mp.get_context("fork")
                with ctx.Pool(processes=_POOL_SIZE) as pool:
                    scores = pool.map(
                        _path_gate_worker, wins,
                        chunksize=max(len(wins) // (4 * _POOL_SIZE), 1))
            finally:
                _PATH_GATE_STATE.clear()
            by_w = dict(zip(wins, scores))
        else:
            by_w = {w: profile_path_scores_single(best[w]) for w in wins}
        return [by_w[w][g] for g, w in job_key]

    masks = []
    for g in range(G):
        m = np.zeros(G, dtype=bool)
        m[g] = True
        masks.append(m)

    for _ in range(iters):
        # ALL (window, bipartition) gates run as ONE forward batch
        # against the round-start state: a window none of whose
        # bipartitions can improve is untouched this round, so gating
        # it against round-start equals the sequential order exactly.
        # Flagged windows re-run the sequential per-bipartition loop
        # against their evolving state (bit-identical to the unbatched
        # algorithm, at 1/G the forward launches for the common case).
        jobs = []
        job_key = []
        with trace.stage("profiles"):
            for g in range(G):
                for w in range(len(best)):
                    pq = gate(w, masks[g])
                    if pq is not None:
                        jobs.append(pq)
                        job_key.append((g, w))
        if not jobs:
            break
        with trace.stage("gate_forward"):
            dp = profile_scores_batch([j[0] for j in jobs],
                                      [j[1] for j in jobs], device=device)
        flagged: list[int] = []
        flagged_set: set[int] = set()
        with trace.stage("gate_path_score"):
            curs = path_scores_all(job_key)
            for i, (g, w) in enumerate(job_key):
                cur = curs[i]
                tol = 1e-4 * abs(cur) + 10.0
                if dp[i] > cur + tol and w not in flagged_set:
                    flagged.append(w)
                    flagged_set.add(w)
        improved = np.zeros(len(best), dtype=bool)
        for g in range(G):
            mask = masks[g]
            cand = []
            pqs = {}
            # re-check flagged windows against their EVOLVING state:
            # one batched forward per bipartition
            re_ws, re_pqs = [], []
            with trace.stage("gate_path_score"):
                for w in flagged:
                    pq = gate(w, mask)
                    if pq is not None:
                        re_ws.append(w)
                        re_pqs.append(pq)
            if re_ws:
                with trace.stage("gate_forward"):
                    dps = profile_scores_batch([p for p, _ in re_pqs],
                                               [q for _, q in re_pqs],
                                               device=device)
                with trace.stage("gate_path_score"):
                    for w, pq, dp_w in zip(re_ws, re_pqs, dps):
                        cur, tol = path_tol(w, mask)
                        if dp_w > cur + tol:
                            cand.append(w)
                            pqs[w] = pq
            if not cand:
                continue
            with trace.stage("traceback_dp"):
                merged = align_profile_batch([pqs[w][0] for w in cand],
                                             [pqs[w][1] for w in cand],
                                             device=device)
            order = np.concatenate([np.flatnonzero(mask),
                                    np.flatnonzero(~mask)])
            with trace.stage("accept"):
                for w, m in zip(cand, merged):
                    restored = np.empty_like(m)
                    restored[order] = m
                    score = sp_score(codes_rows_to_ascii(restored))
                    if score > best_score[w]:
                        best[w], best_score[w] = restored, score
                        improved[w] = True
        if not improved.any():
            break
    return best


def refine(rows: np.ndarray, tree: TreeNode | None = None,
           iters: int = 1, device="cuda") -> np.ndarray:
    """Tree-bipartition iterative refinement: split rows along each guide
    tree edge, strip all-gap columns from each side, re-align the two
    profiles on `device`, keep the result iff the sum-of-pairs score
    improves (MuscleInterface::RefineFast analog, MuscleInterface.cpp:823)."""
    G = rows.shape[0]
    if G < 3:
        return rows
    if tree is None:
        parts = [np.array([g]) for g in range(G)]
    else:
        parts = _bipartitions(tree, G)
    best = rows
    best_score = sp_score(codes_rows_to_ascii(best))
    for _ in range(iters):
        improved = False
        for ids in parts:
            mask = np.zeros(G, dtype=bool)
            mask[ids] = True
            p = _drop_all_gap_columns(best[mask])
            q = _drop_all_gap_columns(best[~mask])
            merged = align_profile_batch([p], [q], device=device)[0]
            # restore row order: p rows then q rows -> original order
            order = np.concatenate([np.flatnonzero(mask),
                                    np.flatnonzero(~mask)])
            restored = np.empty_like(merged)
            restored[order] = merged
            score = sp_score(codes_rows_to_ascii(restored))
            if score > best_score:
                best, best_score = restored, score
                improved = True
        if not improved:
            break
    return best
