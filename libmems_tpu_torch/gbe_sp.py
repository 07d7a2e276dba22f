"""Scored sum-of-pairs greedy breakpoint elimination.

Re-derivation of the reference's EvenFasterSumOfPairsBreakpointScorer +
greedySearch (libMems/GreedyBreakpointElimination.h:478-582, 761-860;
.cpp:323-786) — the objective engine of progressiveMauve's anchoring:

* state: a set of pairwise "tracking" matches, each carrying a per-
  genome-pair anchor score (tm_score_array analog, here a dense
  float64[n_matches, n_pairs]), plus an independent pairwise LCB
  decomposition for every genome pair (PairwiseLCBMatrix analog);
* objective: sum over pairs of (pairwise LCB score − scaled breakpoint
  penalty × (LCB count − 1)), with penalty_ij =
  max(bp_penalty · (1−conservation_w)⁴ · (1−bp_w)², min_penalty)
  (GBE.cpp:408-421);
* moves: delete one pairwise LCB; all of its member matches are removed
  globally, which drains / deletes / coalesces LCBs in every other pair
  (GBE.cpp:530-690);
* search: heap of moves ordered by score difference, lazily revalidated
  (greedySearch, GBE.h:761-860).

Differences from the reference (deliberate):

* matches are rows of a MatchArray, not pointer-linked objects; per-pair
  member lists are python lists of row indices;
* probe moves use the mutation journal of gbe.remove_and_coalesce and
  undo_journal instead of the reference's triple score-diff buffers and
  undoLcbRemoval — same no-copy cost profile, simpler bookkeeping;
* move scores are exact diffs; the reference's ±1e-5 numerical-drift
  tolerance is kept for validity checks.
"""

from __future__ import annotations

import heapq

import numpy as np

from libmems_tpu_torch.lcb import LCBSet, compute_lcb_set
from libmems_tpu_torch.gbe import remove_and_coalesce, undo_journal
from libmems_tpu_torch.match import MatchArray, NO_MATCH

UNASSIGNED_ID = -1
SCORE_TOLERANCE = 1e-5  # GBE.cpp:744-748


def scaled_breakpoint_penalties(bp_penalty: float,
                                min_penalty: float,
                                bp_weights: np.ndarray,
                                cons_weights: np.ndarray) -> np.ndarray:
    """penalty_p = max(bp · (1−cw)⁴ · (1−bw)², min) per pair
    (EvenFasterSumOfPairsBreakpointScorer::score, GBE.cpp:408-421)."""
    cw = 1.0 - np.asarray(cons_weights, dtype=np.float64)
    bw = 1.0 - np.asarray(bp_weights, dtype=np.float64)
    return np.maximum(bp_penalty * cw ** 4 * bw ** 2, min_penalty)


class SumOfPairsBreakpointScorer:
    """Incremental sum-of-pairs LCB scorer over genome pairs.

    Args:
      matches: MatchArray over G coordinate columns (signed starts).
      tm_scores: float64[n_matches, n_pairs] — per-pair anchor score of
        each match (GetPairwiseAnchorScore output); 0 where the match
        does not span the pair.
      pairs: list of (gi, gj) column-index pairs.
      penalties: float64[n_pairs] scaled breakpoint penalty per pair
        (see scaled_breakpoint_penalties); a scalar is broadcast.
    """

    def __init__(self, matches: MatchArray, tm_scores: np.ndarray,
                 pairs: list[tuple[int, int]], penalties):
        self.matches = matches
        self.tm_scores = np.asarray(tm_scores, dtype=np.float64)
        self.pairs = list(pairs)
        P = len(self.pairs)
        self.penalties = np.broadcast_to(
            np.asarray(penalties, dtype=np.float64), (P,)).copy()
        n = len(matches)
        self.deleted = np.zeros(n, dtype=bool)
        self.tm_lcb_id = np.full((n, P), UNASSIGNED_ID, dtype=np.int64)

        self.sets: list[LCBSet] = []
        self.members: list[list[list[int]]] = []
        self.pair_count = np.zeros(P, dtype=np.int64)
        self.pair_score = np.zeros(P, dtype=np.float64)
        for p, (gi, gj) in enumerate(self.pairs):
            sel = np.flatnonzero((matches.starts[:, gi] != NO_MATCH)
                                 & (matches.starts[:, gj] != NO_MATCH))
            if len(sel) == 0:
                self.sets.append(LCBSet(
                    left_end=np.zeros((0, 2), np.int64),
                    right_end=np.zeros((0, 2), np.int64),
                    left_adjacency=np.zeros((0, 2), np.int64),
                    right_adjacency=np.zeros((0, 2), np.int64),
                    lcb_id=np.zeros(0, np.int64),
                    weight=np.zeros(0, np.float64)))
                self.members.append([])
                continue
            proj = MatchArray(matches.starts[sel][:, [gi, gj]],
                              matches.lengths[sel])
            # normalize leading-genome orientation for the LCB scan
            flip = proj.starts[:, 0] < 0
            proj.starts[flip] *= -1
            lset = compute_lcb_set(proj)
            mem: list[list[int]] = []
            for li, idx in enumerate(lset.members):
                orig = sorted(int(sel[k]) for k in idx)
                mem.append(orig)
                self.tm_lcb_id[orig, p] = li
                lset.weight[li] = self.tm_scores[orig, p].sum()
            self.sets.append(lset)
            self.members.append(mem)
            self.pair_count[p] = lset.n
            self.pair_score[p] = lset.weight.sum()

        self._offsets = np.concatenate(
            [[0], np.cumsum([s.n for s in self.sets])]).astype(np.int64)

    # -- move encoding ---------------------------------------------------

    def move_count(self) -> int:
        return int(self._offsets[-1])

    def _decode(self, move: int) -> tuple[int, int]:
        p = int(np.searchsorted(self._offsets, move, side="right")) - 1
        return p, int(move - self._offsets[p])

    # -- scoring ---------------------------------------------------------

    def score(self) -> float:
        return float((self.pair_score
                      - self.penalties * (self.pair_count - 1)).sum())

    def _removal_effects(self, p_t: int, l_t: int, really: bool):
        """Core of the reference's remove() (GBE.cpp:530-690): delete
        pairwise LCB (p_t, l_t)'s matches globally.  Returns (score_diff,
        removed_count, impact) per pair, or None if the move is invalid.
        When really=False the structure is restored before returning."""
        st_t = self.sets[p_t]
        if l_t >= st_t.n or st_t.lcb_id[l_t] != l_t:
            return None
        mats = list(self.members[p_t][l_t])
        if not mats:
            return None
        P = len(self.pairs)
        score_diff = np.zeros(P, dtype=np.float64)
        removed_cnt = np.zeros(P, dtype=np.int64)
        impact: list[set[int]] = [set() for _ in range(P)]
        journal: list | None = None if really else []
        mats_arr = np.asarray(mats)

        for q in range(P):
            st = self.sets[q]
            ids = self.tm_lcb_id[mats_arr, q]
            sel = ids != UNASSIGNED_ID
            if not sel.any():
                continue
            groups: dict[int, list[int]] = {}
            for mid, lid in zip(mats_arr[sel], ids[sel]):
                groups.setdefault(int(lid), []).append(int(mid))
            full_dels = []
            for lid, gm in groups.items():
                cur = self.members[q][lid]
                if len(gm) == len(cur):
                    full_dels.append(lid)
                    score_diff[q] += st.weight[lid]
                    if really:
                        st.weight[lid] = 0.0
                        self.members[q][lid] = []
                else:
                    ds = float(self.tm_scores[gm, q].sum())
                    score_diff[q] += ds
                    impact[q].add(lid)
                    if really:
                        st.weight[lid] -= ds
                        gset = set(gm)
                        self.members[q][lid] = [
                            m for m in cur if m not in gset]
            for lid in full_dels:
                if st.lcb_id[lid] != lid:
                    continue  # already coalesced away this pass
                rc, imp, remaps = remove_and_coalesce(st, lid, journal)
                removed_cnt[q] += rc
                impact[q].update(imp)
                if really:
                    for old, new in remaps:
                        if new == -1:
                            continue
                        mv = self.members[q][old]
                        if mv:
                            self.tm_lcb_id[mv, q] = new
                            self.members[q][new] = sorted(
                                self.members[q][new] + mv)
                            self.members[q][old] = []

        if not really:
            undo_journal(journal)
        return mats, score_diff, removed_cnt, impact

    def move_score(self, move: int) -> float | None:
        """Score difference if `move` were applied; None if invalid."""
        p_t, l_t = self._decode(move)
        eff = self._removal_effects(p_t, l_t, really=False)
        if eff is None:
            return None
        _, score_diff, removed_cnt, _ = eff
        diff = (-score_diff + self.penalties * removed_cnt).sum()
        return float(diff)

    def is_valid(self, move: int, claimed: float) -> bool:
        d = self.move_score(move)
        return d is not None and abs(d - claimed) <= SCORE_TOLERANCE

    def remove(self, move: int) -> list[tuple[float, int]] | None:
        """Apply the move; returns rescored impacted moves (new_move_list
        analog).  Trashed moves come back with -inf scores."""
        p_t, l_t = self._decode(move)
        eff = self._removal_effects(p_t, l_t, really=True)
        if eff is None:
            return None
        mats, score_diff, removed_cnt, impact = eff
        self.pair_score -= score_diff
        self.pair_count -= removed_cnt
        self.deleted[mats] = True
        self.tm_lcb_id[np.asarray(mats)] = UNASSIGNED_ID

        new_moves: list[tuple[float, int]] = []
        for q in range(len(self.pairs)):
            st = self.sets[q]
            base = int(self._offsets[q])
            for lid in sorted(impact[q]):
                if st.lcb_id[lid] != lid:
                    new_moves.append((-np.inf, base + lid))
                    continue
                d = self.move_score(base + lid)
                new_moves.append((d if d is not None else -np.inf,
                                  base + lid))
        return new_moves

    def results(self) -> np.ndarray:
        """Indices of surviving matches (getResults analog)."""
        return np.flatnonzero(~self.deleted)


def greedy_search(scorer) -> float:
    """Heap-driven greedy move search (greedySearch, GBE.h:761-860):
    pop best move, lazily revalidate, apply, push rescored impacted
    moves; stop when the best move no longer improves the score."""
    n = scorer.move_count()
    current = np.full(n, -np.inf)
    heap: list[tuple[float, int]] = []
    for m in range(n):
        d = scorer.move_score(m)
        if d is None:
            continue
        current[m] = d
        heap.append((-d, m))
    heapq.heapify(heap)
    while heap:
        neg, m = heapq.heappop(heap)
        d = -neg
        if d < 0:
            break
        if d != current[m]:
            continue  # stale heap entry
        if not scorer.is_valid(m, d):
            continue
        new_moves = scorer.remove(m)
        if new_moves is None:
            continue
        current[m] = -np.inf
        for ms, mi in new_moves:
            current[mi] = ms
            if np.isfinite(ms):
                heapq.heappush(heap, (-ms, mi))
    return scorer.score()
