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


def span_rows(seed_len: int, C: int, G: int, side: int, rng_seed: int = 0):
    """One probe round's rows on answered spans, for K31's tests (its
    plain version against the JAX make_probe_round on the CPU, the kernel
    against the plain version on the card).  Rows have planted match gaps
    of seed_len (the chain goes on) and seed_len + 1 (it ends) whose later
    match falls at offsets 31-33, 63-65, C - seed_len and C (ballot-word
    edges and the round's last offsets), with the chain's far end left
    open or closed a few offsets on; probe positions that leave [0,
    count) past such an offset (a genome moving left whose left end is
    that offset, one moving ahead that reaches its genome's last window)
    or before it; sentinel keys (both low bits); absent genomes; present
    genomes whose request was dropped (where -1); rows of one present
    genome; every genome on either strand.  Keys are below 2^30, so that
    the JAX test can hold them as uint32.

    Returns (resp int64[n, C] the answered spans, where int64[Rb, G],
    rows int64[Rb], lefts int32[R, G], lengths int32[R], present, is_fwd
    bool[R, G], gen_cnt int32[G], active bool[R]) as numpy arrays.  The
    block's rows are every row with a present genome, in a shuffled
    order; one row with no genome and one other row stay out of it (and
    out of active), so a round must leave them as they are."""
    rng = np.random.default_rng(rng_seed)
    cnt = np.array([4 * C + 1000 + 3 * g for g in range(G)], np.int32)
    edges = sorted({d for d in (31, 32, 33, 63, 64, 65, C - seed_len, C)
                    if 1 <= d <= C})
    rows = []   # (lefts, length, present, is_fwd, raw keys [G, C], drop)

    def add(miss=(), sentinel=(), cut=None, absent=(), drop=(), one=False):
        """miss: offsets where one present genome's key differs;
        sentinel: offsets where one present genome's key is the
        sentinel; cut: (genome, offset, above) the probe positions of
        that genome leave [0, count) past (above) or up to that offset."""
        fwd = rng.random(G) < 0.5
        pres = np.ones(G, bool)
        pres[list(absent)] = False
        if one:
            pres[:] = False
            pres[int(rng.integers(0, G))] = True
        n = seed_len + int(rng.integers(0, 20))
        lefts = rng.integers(2 * C, 2 * C + 100, G).astype(np.int64)
        back = fwd if side == 0 else ~fwd
        if cut is not None:
            g, x, above = cut
            ahead_shift = n - seed_len
            if above:       # offsets past x leave the genome
                lefts[g] = x if back[g] else cnt[g] - 1 - x - ahead_shift
            else:           # offsets up to x lie before or past it
                lefts[g] = cnt[g] + x if back[g] else -(x + 1) - ahead_shift
        flipped = np.broadcast_to(
            rng.integers(0, 1 << 30, C + 1, dtype=np.int64), (G, C + 1)
        ).copy()            # column d: offset d (column 0 unused)
        live = np.flatnonzero(pres)
        odd = int(rng.choice(live))
        for d in [d for d in miss if 1 <= d <= C]:
            flipped[odd, d] = (flipped[odd, d] + 1 + int(
                rng.integers(0, 1 << 20))) % (1 << 30)
        raw = flipped ^ fwd[:, None].astype(np.int64)
        for d in [d for d in sentinel if 1 <= d <= C]:
            raw[odd, d] = FILL if d % 2 else FILL ^ 1
        for g in np.flatnonzero(~pres):
            raw[g] = rng.integers(0, 1 << 30, C + 1)   # never compared
        rows.append((lefts, n, pres, fwd, raw[:, 1:], set(drop)))

    for gap in (seed_len, seed_len + 1):
        for at in edges:
            if at - gap < 0:
                continue
            miss = list(range(at - gap + 1, at))
            add(miss=miss)
            # the chain's far end: seed_len + 1 misses a few offsets on
            stop = at + 1 + int(rng.integers(0, 5))
            add(miss=miss + list(range(stop, stop + seed_len + 1)))
    for x in edges:
        for above in (True, False):
            add(cut=(int(rng.integers(0, G)), x, above))
    run = min(9, C)
    add(sentinel=range(run, min(run + seed_len + 1, C + 1)))
    add(sentinel=[run, min(run + 1, C)])
    add(absent=[g for g in range(1, G) if rng.random() < 0.5])
    add(absent=range(1, G), miss=range(5, 5 + seed_len + 1))
    add(drop=[int(rng.integers(0, G))])
    add(one=True)
    add(one=True, sentinel=range(2, 2 + seed_len + 1))
    if G > 1:
        add(absent=[0])
    # rows outside the block: one with no genome, one inactive
    rows.insert(0, rows[0][:2] + (np.zeros(G, bool),) + rows[0][3:])
    rows.insert(1, rows[2])
    R = len(rows)
    lefts = np.stack([r[0] for r in rows]).astype(np.int32)
    lengths = np.array([r[1] for r in rows], np.int32)
    present = np.stack([r[2] for r in rows])
    is_fwd = np.stack([r[3] for r in rows])
    active = present.any(axis=1)
    active[1] = False
    block = np.flatnonzero(active)
    rng.shuffle(block)
    back = is_fwd if side == 0 else ~is_fwd
    spans, where = [], np.full((len(block), G), -1, np.int64)
    for b, r in enumerate(block):
        raw, drop = rows[r][4], rows[r][5]
        for g in np.flatnonzero(present[r]):
            if g in drop:
                continue
            where[b, g] = len(spans)
            # offset d: span[C - d] moving left, span[d - 1] ahead
            spans.append(raw[g][::-1] if back[r, g] else raw[g])
    order = rng.permutation(len(spans))
    resp = np.stack(spans)[order] if spans else np.zeros((0, C), np.int64)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    where = np.where(where >= 0, inv[np.maximum(where, 0)], -1)
    return (resp.astype(np.int64), where, block.astype(np.int64), lefts,
            lengths, present, is_fwd, cnt, active)


def owner_major(resp, where, owners, rng_seed: int = 0):
    """span_rows' answered spans regrouped as a fetch hands them to K31:
    each answered request goes to one of `owners` (an int array of owner
    indices to pick from, so that owners left out answer nothing), its
    slot its rank among that owner's requests in (row, genome) order; the
    owners' answers are concatenated in owner order.  Returns (resp
    int64[n, C], where int64[Rb, G] (owner << 32) | slot or -1, resp_off
    int64[n_dev] each owner's first row in resp) as numpy arrays, n_dev =
    max(owners) + 1."""
    rng = np.random.default_rng(rng_seed)
    n_dev = int(np.max(owners)) + 1
    flat = where.reshape(-1)
    asked = np.flatnonzero(flat >= 0)
    owner = rng.choice(owners, asked.shape[0])
    slot = np.zeros_like(owner)
    counts = np.zeros(n_dev, np.int64)
    for k, o in enumerate(owner):
        slot[k] = counts[o]
        counts[o] += 1
    resp_off = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    out = np.empty_like(resp)
    out[resp_off[owner] + slot] = resp[flat[asked]]
    new = np.full(flat.shape, -1, np.int64)
    new[asked] = (owner.astype(np.int64) << 32) | slot
    return out, new.reshape(where.shape), resp_off
