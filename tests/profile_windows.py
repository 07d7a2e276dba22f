"""K3's and K9's test windows, shared by tests/test_torch_profile.py,
tests/test_torch_cuda.py and chip_smoke.py, which load this file by path:
fractional profiles of given sizes, and the strip kernels' edge widths."""

import numpy as np

from libmems_tpu_torch.ops.profile import STRIP_MAX_N, rows_to_profile

# the lane widths of csrc/profile.cu's strip geometries (kStripK), in
# table order
STRIP_KS = (17, 13, 9, 5, 3, 1)


def msa_rows(rng, n_rows, n):
    """n_rows aligned rows with gap columns: a fractional profile (10%
    gaps, 5% substitutions: thirds and halves, ties that hang on the
    float order)."""
    base = rng.integers(0, 4, size=n).astype(np.uint8)
    rows = np.stack([base] * n_rows)
    rows[rng.random(rows.shape) < 0.1] = 4
    mut = rng.random(rows.shape) < 0.05
    rows[mut] = rng.integers(0, 4, size=int(mut.sum()))
    rows[:, (rows == 4).all(axis=0)] = 0
    return rows


def sized_profiles(rng, M, N, shapes, n_p=3, n_q=2):
    """Windows of the given (p_len, q_len) as fractional n_p- and n_q-row
    profiles, zero-padded to M rows and N columns: numpy (p, q, p_len,
    q_len)."""
    p = np.zeros((len(shapes), M, 5), np.float32)
    q = np.zeros((len(shapes), N, 5), np.float32)
    for r, (cp, cq) in enumerate(shapes):
        p[r, :cp] = rows_to_profile(msa_rows(rng, n_p, cp))
        q[r, :cq] = rows_to_profile(msa_rows(rng, n_q, cq))
    return (p, q, np.array([s[0] for s in shapes], np.int32),
            np.array([s[1] for s in shapes], np.int32))


def strip_edges(K):
    """(M, N, shapes) at lane width K's edges: a one-warp bucket (N = 32K
    - 1) and a two-strip one (N = 32K + 1), each with q_len at 32K - 1,
    32K and 32K + 1 where they fit, an empty window, windows with p_len
    = 0 or q_len = 0, and one of half the bucket's width."""
    return [(24, N, [(20, q) for q in (32 * K - 1, 32 * K, 32 * K + 1)
                     if q <= N] + [(0, 0), (0, N), (20, 0), (17, N // 2)])
            for N in (32 * K - 1, 32 * K + 1)]


# the wide route's boundary, (M, N, shapes) at N = STRIP_MAX_N - 1,
# STRIP_MAX_N (strips) and STRIP_MAX_N + 1 (the one-block-a-window kernel)
BOUNDARY = [(8, N, [(6, N), (5, N - 100), (0, N), (6, 0)])
            for N in (STRIP_MAX_N - 1, STRIP_MAX_N, STRIP_MAX_N + 1)]

# every edge width: each lane width's, then the boundary
EDGES = [e for K in STRIP_KS for e in strip_edges(K)] + BOUNDARY
