"""Greedy breakpoint elimination (GBE).

Host-side port of the reference's move-heap greedy search over LCB
removals (libMems/GreedyBreakpointElimination.{h,cpp}):

* remove_and_coalesce — RemoveLCBandCoalesce (GBE.cpp:147-271): unlink an
  LCB from every per-genome adjacency list, then coalesce neighbor pairs
  left collinear in all genomes (weights add);
* SimpleBreakpointScorer (GBE.cpp:877-938): move value =
  -weight + removed_breakpoints * penalty;
* GreedyRemovalScorer (GBE.cpp:941-986): move value =
  -(weight - min_weight) — removes every LCB below a weight floor, with
  coalescing able to rescue neighbors (this is the flat aligner's
  weight-threshold elimination);
* greedy_breakpoint_elimination — greedyBreakpointElimination_v4
  (GBE.h:650-756): pop best move / validate / apply / push new moves.

The greedy loop is inherently sequential and stays on host; expensive
anchor scoring for the progressive aligner's sum-of-pairs scorer is
computed on device (see progressive milestone).
"""

from __future__ import annotations

import heapq

import numpy as np

from libmems_tpu_torch.lcb import LCBSet, UNASSIGNED

REMOVED = -2


def undo_journal(journal: list) -> None:
    """Reverse every (array, index, old_value) write in LIFO order —
    the undoLcbRemoval analog (GBE.cpp:93-144) generalized to exact
    state restoration."""
    for arr, idx, old in reversed(journal):
        arr[idx] = old


def _jset(journal, arr, idx, val):
    if journal is not None:
        journal.append((arr, idx, arr[idx].copy()
                        if hasattr(arr[idx], "copy") else arr[idx]))
    arr[idx] = val


def remove_and_coalesce(lcbs: LCBSet, lcbI: int, journal: list | None = None
                        ) -> tuple[int, list[int], list[tuple[int, int]]]:
    """Remove LCB lcbI, re-link adjacencies, coalesce newly-collinear
    neighbors.  Returns (removed_count, impact_list, id_remaps) —
    removed_count is 1 + number of coalesces; impact_list are LCB ids
    whose removal score may have changed; id_remaps records (old_id,
    new_id) for coalesces and (lcbI, -1) for the deletion, in operation
    order (RemoveLCBandCoalesce, GBE.cpp:147-271).  When `journal` is a
    list, every mutation is recorded so undo_journal() restores the
    exact pre-call state (the reference's probe-then-undo pattern,
    GBE.cpp:445-465, without copying the structure)."""
    la, ra = lcbs.left_adjacency, lcbs.right_adjacency
    G = la.shape[1]
    impact: list[int] = []
    remaps: list[tuple[int, int]] = [(lcbI, -1)]

    _jset(journal, lcbs.lcb_id, lcbI, REMOVED)
    orig_left = la[lcbI].copy()
    orig_right = ra[lcbI].copy()

    for g in range(G):
        l_adj, r_adj = orig_left[g], orig_right[g]
        if l_adj != UNASSIGNED:
            _jset(journal, ra, (l_adj, g), r_adj)
        if r_adj != UNASSIGNED and r_adj != lcbs.n:
            _jset(journal, la, (r_adj, g), l_adj)

    for g in range(G):
        for adj in (orig_left[g], orig_right[g]):
            if adj != UNASSIGNED:
                impact.append(int(adj))
                impact.extend(int(x) for x in la[adj] if x != UNASSIGNED)
                impact.extend(int(x) for x in ra[adj] if x != UNASSIGNED)

    removed_count = 1

    # check each genome's (left, right) neighbor pair for collapse
    for g in range(G):
        l_adj, r_adj = int(orig_left[g]), int(orig_right[g])
        # chase stale ids to the live LCBs ("find the real slim shady")
        while l_adj != UNASSIGNED and lcbs.lcb_id[l_adj] != l_adj:
            l_adj = int(la[l_adj, g])
        while r_adj != UNASSIGNED and lcbs.lcb_id[r_adj] != r_adj:
            r_adj = int(ra[r_adj, g])
        if l_adj == UNASSIGNED or r_adj == UNASSIGNED:
            continue
        if lcbs.lcb_id[l_adj] != l_adj or lcbs.lcb_id[r_adj] != r_adj:
            continue  # already coalesced this pass

        # collinear in every genome, with consistent orientations?
        orientation = lcbs.left_end[l_adj, g] > 0
        ok = True
        for g2 in range(G):
            j_ori = lcbs.left_end[l_adj, g2] > 0
            if j_ori == orientation and ra[l_adj, g2] != r_adj:
                ok = False
                break
            if j_ori != orientation and la[l_adj, g2] != r_adj:
                ok = False
                break
            if (lcbs.left_end[r_adj, g2] > 0) != j_ori:
                ok = False
                break
        if not ok or lcbs.to_be_deleted[l_adj] or lcbs.to_be_deleted[r_adj]:
            continue

        # coalesce right into left
        _jset(journal, lcbs.lcb_id, r_adj, l_adj)
        _jset(journal, lcbs.weight, l_adj,
              lcbs.weight[l_adj] + lcbs.weight[r_adj])
        remaps.append((int(r_adj), int(l_adj)))
        for g2 in range(G):
            j_ori = lcbs.left_end[l_adj, g2] > 0
            rr = int(ra[r_adj, g2])
            rl = int(la[r_adj, g2])
            if j_ori == orientation:
                _jset(journal, lcbs.right_end, (l_adj, g2),
                      lcbs.right_end[r_adj, g2])
                _jset(journal, ra, (l_adj, g2), rr)
                if rr != UNASSIGNED:
                    _jset(journal, la, (rr, g2), l_adj)
            else:
                _jset(journal, lcbs.left_end, (l_adj, g2),
                      lcbs.left_end[r_adj, g2])
                _jset(journal, la, (l_adj, g2), rl)
                if rl != UNASSIGNED:
                    _jset(journal, ra, (rl, g2), l_adj)
        removed_count += 1

    return removed_count, sorted(set(impact)), remaps


class SimpleBreakpointScorer:
    """total_weight - bp_count * penalty (GBE.cpp:877-938)."""

    def __init__(self, lcbs: LCBSet, breakpoint_penalty: float,
                 collinear: bool = False):
        self.lcbs = lcbs
        self.bp_penalty = float(breakpoint_penalty)
        self.collinear = collinear
        self.total_weight = float(lcbs.weight.sum())
        self.bp_count = lcbs.n

    def move_count(self) -> int:
        return self.lcbs.n

    def score(self) -> float:
        return self.total_weight - self.bp_count * self.bp_penalty

    def _probe_removed(self, lcbI: int) -> int:
        # probe-and-undo via the mutation journal: no O(n) copy per move
        journal: list = []
        removed, _, _ = remove_and_coalesce(self.lcbs, lcbI, journal)
        undo_journal(journal)
        return removed

    def move_score(self, lcbI: int) -> float:
        bp_removed = self._probe_removed(lcbI)
        move = (self.total_weight - self.lcbs.weight[lcbI]
                - (self.bp_count - bp_removed) * self.bp_penalty)
        diff = move - self.score()
        if self.collinear and self.bp_count - bp_removed > 0 and diff < 0:
            return 1.0 / (-diff)  # keep removing until one block remains
        return diff

    def is_valid(self, lcbI: int, move_score: float) -> bool:
        if self.lcbs.lcb_id[lcbI] != lcbI:
            return False
        return self.move_score(lcbI) == move_score

    def remove(self, lcbI: int) -> list[tuple[float, int]]:
        bp_removed, impact, _ = remove_and_coalesce(self.lcbs, lcbI)
        self.total_weight -= float(self.lcbs.weight[lcbI])
        self.bp_count -= bp_removed
        return [(self.move_score(i), i) for i in impact
                if self.lcbs.lcb_id[i] == i]


class GreedyRemovalScorer:
    """Weight-floor elimination (GBE.cpp:941-986)."""

    def __init__(self, lcbs: LCBSet, minimum_weight: float):
        self.lcbs = lcbs
        self.min_weight = float(minimum_weight)
        self.total_weight = float((lcbs.weight - minimum_weight).sum())

    def move_count(self) -> int:
        return self.lcbs.n

    def score(self) -> float:
        return self.total_weight

    def move_score(self, lcbI: int) -> float:
        return -(float(self.lcbs.weight[lcbI]) - self.min_weight)

    def is_valid(self, lcbI: int, move_score: float) -> bool:
        if self.lcbs.lcb_id[lcbI] != lcbI:
            return False
        return self.move_score(lcbI) == move_score

    def remove(self, lcbI: int) -> list[tuple[float, int]]:
        _, impact, _ = remove_and_coalesce(self.lcbs, lcbI)
        self.total_weight -= (float(self.lcbs.weight[lcbI])
                              - self.min_weight)
        return [(self.move_score(i), i) for i in impact
                if self.lcbs.lcb_id[i] == i]


def greedy_breakpoint_elimination(lcbs: LCBSet, scorer) -> LCBSet:
    """Move-heap greedy search (greedyBreakpointElimination_v4,
    GBE.h:650-756).  Mutates and returns `lcbs`."""
    if lcbs.n == 0:
        return lcbs
    scores = lcbs.weight.copy()  # per-LCB weights (mutated on coalesce)
    total_current = float(scores[lcbs.alive()].sum())

    heap: list[tuple[float, int]] = [
        (-scorer.move_score(i), i) for i in range(scorer.move_count())]
    heapq.heapify(heap)

    while heap:
        neg, lcbI = heapq.heappop(heap)
        move_score = -neg
        if move_score < 0:
            break  # can't improve score
        if total_current == lcbs.weight[lcbI]:
            break  # never remove the last LCB
        if not scorer.is_valid(lcbI, move_score):
            continue
        new_moves = scorer.remove(lcbI)
        for ms, i in new_moves:
            heapq.heappush(heap, (-ms, i))
        total_current -= float(lcbs.weight[lcbI])
    return lcbs


def eliminate_below_weight(lcbs: LCBSet, min_weight: float) -> LCBSet:
    """Remove every LCB lighter than min_weight, coalescing as removal
    proceeds — the flat aligner's GBE loop (Aligner.cpp:1615-1812) via
    the GreedyRemovalScorer."""
    scorer = GreedyRemovalScorer(lcbs, min_weight)
    return greedy_breakpoint_elimination(lcbs, scorer)


def surviving_members(lcbs: LCBSet) -> list[np.ndarray]:
    """Match-index lists of the surviving (possibly coalesced) LCBs, in
    genome-0 order of their left ends."""
    groups: dict[int, list[int]] = {}
    for i in range(lcbs.n):
        root = int(lcbs.lcb_id[i])
        if root == REMOVED:
            continue
        # chase coalesce chains
        seen = set()
        while root != REMOVED and lcbs.lcb_id[root] != root \
                and root not in seen:
            seen.add(root)
            root = int(lcbs.lcb_id[root])
        if root == REMOVED or lcbs.lcb_id[root] != root:
            continue
        groups.setdefault(root, []).append(i)
    out = []
    for root in sorted(groups, key=lambda r: abs(lcbs.left_end[r, 0])):
        idx = np.concatenate([lcbs.members[i] for i in sorted(groups[root])])
        out.append(idx)
    return out
