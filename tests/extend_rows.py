"""Extension rows with planted match gaps, for K2's tests on the CPU
(against the JAX package) and on the card (against the plain version).
No JAX here: the card's tests load this file by path.

Each row has its own pair of key segments of L windows: genome 1 is
genome 0 (forward) or its reverse complement (keys reversed, strand bit
flipped), so every offset matches except where a window of genome 1 is
replaced.  Keys are below 2^40, so none is the all-ones sentinel unless
planted."""

import numpy as np

FILL = -1          # the sentinel of 64-bit keys (mers.key_sentinel)


def _segment_pair(rng, L, fwd):
    a = rng.integers(0, 1 << 40, L, dtype=np.int64)
    b = a.copy() if fwd else (a[::-1] ^ 1).copy()
    return a, b


def _b_index(q, L, fwd):
    """Genome 1's window that genome 0's window q is compared with."""
    return q if fwd else L - 1 - q


def gap_rows(seed_len: int, C: int, rng_seed: int = 0):
    """Rows whose match gaps are exactly seed_len and seed_len + 1 (the
    first continues a chain, the second ends it), with the match after
    the gap at offsets C - 1, C, C + 1, 8C, 9C and 9C + 1 of either side
    (the JAX rounds' edges: C, then C + 8C), genome 1 on either strand;
    rows that reach a sequence's first and last window; sentinel runs;
    rows of one genome and absent rows.  Returns (keys int64[N], off,
    cnt, lefts int32[R, 2], present, is_fwd bool[R, 2], lengths
    int32[R]) as numpy arrays."""
    rng = np.random.default_rng(rng_seed)
    L = 24 * C
    s0 = L // 2 - seed_len // 2
    parts, rows = [], []
    at_list = (C - 1, C, C + 1, 8 * C, 9 * C, 9 * C + 1)

    def add(fwd, breaks, present=(True, True), lefts0=None, plant=None):
        a, b = _segment_pair(rng, L, fwd)
        for q in breaks:
            if 0 <= q < L:
                b[_b_index(q, L, fwd)] = rng.integers(0, 1 << 40)
        if plant is not None:
            plant(a, b)
        base = sum(len(p) for p in parts)
        parts.extend([a, b])
        la = s0 if lefts0 is None else lefts0
        lb = la if fwd else L - 1 - la    # len = seed_len at the start
        rows.append(([la, lb], [base, base + L], present, [True, fwd]))

    def stop(side, d0, n=2 * seed_len):
        """Genome 0's windows of n mismatching offsets from d0 on."""
        return [s0 + d if side else s0 - d for d in range(d0, d0 + n)]

    for fwd in (True, False):
        for side in (0, 1):
            for gap in (seed_len, seed_len + 1):
                for at in at_list:
                    # non-matching offsets between the matches at at - gap
                    # and at; the chain's far end at 10C + 7, and the
                    # other side ends a few offsets out
                    miss = [d for d in range(at - gap + 1, at)]
                    br = [s0 + d if side else s0 - d for d in miss]
                    add(fwd, br + stop(side, 10 * C + 7)
                        + stop(1 - side, 3 + at % 5))
        # to both sequence edges, from the middle, the first and the last
        # window
        add(fwd, [])
        add(fwd, [], lefts0=0)
        add(fwd, [], lefts0=L - 1)
        # a sentinel run of seed_len + 1 windows in both genomes, then
        # one with the low bit clear, each C + 3 offsets ahead

        def sentinels(a, b, fwd=fwd):
            for d in range(C + 3, C + 4 + seed_len):
                q = s0 + d
                a[q] = b[_b_index(q, L, fwd)] = FILL
            for d in range(3 * C, 3 * C + seed_len + 1):
                q = s0 - d
                a[q] = FILL ^ 1
                b[_b_index(q, L, fwd)] = FILL ^ 1 if fwd else FILL
        add(fwd, [], plant=sentinels)
    # genome 1 absent (genome 0 alone matches every window in range), and
    # a row with no genome
    add(True, [], present=(True, False))
    add(True, stop(0, 5) + stop(1, 9), present=(False, False))
    keys = np.concatenate(parts)
    lefts = np.array([r[0] for r in rows], np.int32)
    off = np.array([r[1] for r in rows], np.int32)
    cnt = np.full_like(off, L)
    present = np.array([r[2] for r in rows], bool)
    is_fwd = np.array([r[3] for r in rows], bool)
    lengths = np.full(len(rows), seed_len, np.int32)
    return keys, off, cnt, lefts, present, is_fwd, lengths


def copies_rows(seed_len: int, C: int, G: int, n_rows: int,
                rng_seed: int = 0):
    """n_rows rows of G genomes, every genome a copy of genome 0 (odd
    genomes reverse complemented) with its own runs of 1 to 2 x seed_len
    mismatching windows (a run starting at 0.2% / G of windows, so chains
    both cross runs and end at them, and some run past 8 x 256 offsets),
    each row seeded at its own window of genome 0, some genomes absent
    from some rows, the last row absent.  Same return as gap_rows."""
    rng = np.random.default_rng(rng_seed)
    L = 40 * C
    a = rng.integers(0, 1 << 40, L, dtype=np.int64)
    parts, fwds = [a], [True]
    for g in range(1, G):
        fwd = g % 2 == 0
        b = a.copy() if fwd else (a[::-1] ^ 1).copy()
        for s in np.flatnonzero(rng.random(L) < 0.002 / G):
            n = int(rng.integers(1, 2 * seed_len + 1))
            b[s:s + n] = rng.integers(0, 1 << 40, len(b[s:s + n]))
        parts.append(b)
        fwds.append(fwd)
    keys = np.concatenate(parts)
    starts = rng.integers(0, L - seed_len, n_rows)
    lefts = np.stack([s if f else np.full_like(s, L - 1) - s
                      for f, s in zip(fwds, [starts] * G)], 1)
    present = rng.random((n_rows, G)) < 0.9
    present[:, 0] = True
    present[-1] = False
    off = np.broadcast_to(np.arange(G, dtype=np.int32) * L, (n_rows, G))
    return (keys, np.ascontiguousarray(off, np.int32),
            np.full((n_rows, G), L, np.int32), lefts.astype(np.int32),
            present, np.broadcast_to(np.array(fwds), (n_rows, G)).copy(),
            np.full(n_rows, seed_len, np.int32))


def widen(rows, G: int):
    """gap_rows' or copies_rows' rows padded to G genomes with absent
    ones (which change no result), so that they take K2's wide route."""
    keys, off, cnt, lefts, present, is_fwd, lengths = rows
    R, g0 = lefts.shape

    def pad(a, v):
        return np.concatenate([a, np.full((R, G - g0), v, a.dtype)], 1)
    return (keys, pad(off, 0), pad(cnt, 1), pad(lefts, 0),
            pad(present, False), pad(is_fwd, True), lengths)
