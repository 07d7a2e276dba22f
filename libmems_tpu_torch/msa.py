"""Progressive alignment of inter-anchor windows (the MUSCLE
replacement, MuscleInterface::CallMuscleFast,
libMems/MuscleInterface.cpp:727-769).

Port of the flat aligner's part of libmems_tpu/msa.py: windows that
share one guide tree are merged up the tree in postorder, and every
merge level runs as ONE batched profile DP over all windows
(libmems_tpu_torch.ops.profile).  The k-mer guide tree and the iterative
refinement are not ported yet (ROADMAP queue 2: banded DP and refine).
"""

from __future__ import annotations

import numpy as np

from libmems_tpu_torch.ops.profile import align_profile_batch
from libmems_tpu_torch.tree import TreeNode

MAX_ALIGNMENT_LENGTH = 10000   # GappedAligner.h:25 default window cap


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
