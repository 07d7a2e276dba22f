"""K5's and K13's launches on sorted seed tables built to reach the tile
edges: one row, one tile and one tile plus a row, runs that start or end
exactly at a tile boundary, a run over more than 32 tiles, a sentinel run
of 10^6 rows, a table that is one run, a kept run of exactly repeat_limit
rows across an edge, repeat_limit above a tile, repeat_tolerance 0, 1 and
2 with big rows just across an edge, a (content, genome) subrun across an
edge, G = 2, 3, 9 and 62, and rows carrying their own keys.  Here on the
CPU the plain versions of the two launches compose to run_flags_plain and
mum_seed_flags_plain (exact), and on the small tables those equal the JAX
package's _unique_occ_flags and _mum_seed_flags;
tests/test_torch_cuda.py loads this file by path and holds each launch to
its plain version on the same tables.  Imports neither JAX nor
libmems_tpu at module level, so the card's machine can load it."""

import numpy as np
import pytest
import torch

from libmems_tpu_torch.ops import mums, pairwise

T = pairwise.RUN_TILE
SENT = (1 << 63) - 1   # the sentinel content of 64-bit keys

# case: dict(G, segs, limit=1000, tol=0, row_keys=False).  A segment is
# ("short", rows): runs of 1-6 rows over random genomes (a genome may
# repeat: subruns of several rows); ("pad_to", row): short runs up to
# that row; ("run", rows): one run in subruns as even as the genomes allow;
# ("subruns", [rows of genome 0, 1, ...]): one run; ("sentinel", rows): the
# masked windows' run (last in its table).
TABLES = {
    "n1": dict(G=2, segs=[("run", 1)]),
    "one_tile": dict(G=3, segs=[("short", T)]),
    "tile_plus_one": dict(G=3, segs=[("short", T + 1)]),
    # kept runs starting exactly at 3T and ending exactly at 5T
    "start_at_tile": dict(G=9, segs=[("pad_to", 3 * T), ("subruns", [1] * 9),
                                     ("pad_to", 5 * T - 9),
                                     ("subruns", [1] * 9),
                                     ("short", 1_000)]),
    "end_at_tile": dict(G=3, segs=[("short", 1_000), ("run", 5 * T - 1_000),
                                   ("short", 10_000)]),
    "multi_tile_run": dict(G=3, segs=[("short", 3_000), ("run", 200_000),
                                      ("short", 100_000)]),
    "sentinel_run": dict(G=3, segs=[("short", 150_000),
                                    ("sentinel", 1_000_000)]),
    "one_run": dict(G=3, segs=[("run", 150_000)]),
    # kept: exactly repeat_limit = 100 rows over 62 genomes across T;
    # dropped: 101 rows across 2T
    "limit_run_at_edge": dict(G=62, limit=100, tol=1, segs=[
        ("pad_to", T - 50), ("subruns", [2] * 38 + [1] * 24),
        ("pad_to", 2 * T - 50), ("subruns", [2] * 39 + [1] * 23),
        ("short", 1_000)]),
    # repeat_limit 6,000 above the tile: a kept run of 4,960 rows across
    # T, one of 6,014 dropped by the limit, and one of 4,981 whose only big
    # row (genome 0's 101st) lies in a tile without a start
    "limit_above_tile": dict(G=62, limit=6_000, tol=99, segs=[
        ("pad_to", T - 2_000), ("subruns", [80] * 62), ("short", 3_000),
        ("subruns", [97] * 62), ("pad_to", 5 * T - 50),
        ("subruns", [101] + [80] * 61), ("short", 5_000)]),
    "subrun_at_edge": dict(G=3, tol=1, segs=[
        ("pad_to", T - 2), ("subruns", [0, 4, 1]), ("pad_to", 2 * T - 1),
        ("subruns", [1, 1]), ("pad_to", 3 * T - 1), ("subruns", [2]),
        ("short", 500)]),
    "g2": dict(G=2, segs=[("short", 3 * T + 17)]),
    "g9": dict(G=9, tol=1, segs=[("short", 2 * T + 5), ("run", 700),
                                 ("short", T)]),
    "g62": dict(G=62, tol=2, limit=150, segs=[
        ("short", T + 100), ("run", 140), ("pad_to", 2 * T - 70),
        ("run", 150), ("short", 2 * T)]),
    "row_keys": dict(G=3, row_keys=True, segs=[
        ("short", 5 * T + 3), ("run", 9_000), ("short", 100)]),
}
for _tol in (0, 1, 2):
    _s = _tol + 1
    # the first big row is a tile's first row, its partner before the
    # tile; a big row is a tile's last, in a run its next tile decides;
    # a kept run with subruns of span rows across an edge
    TABLES[f"tol{_tol}_edge"] = dict(G=3, tol=_tol, segs=[
        ("pad_to", T - _s - 1), ("subruns", [1, _s + 1, 1]),
        ("pad_to", 2 * T - _s - 2), ("subruns", [1, _s + 1, 1]),
        ("pad_to", 3 * T - _s), ("subruns", [_s, _s, _s]),
        ("short", 2_000)])
# the tables the JAX package's functions run on (under 100,000 rows)
SMALL = [c for c in TABLES
         if c not in ("multi_tile_run", "sentinel_run", "one_run")]


def _short_runs(rng, rows, G):
    """Runs of 1-6 rows totalling `rows`, each a sorted array of genomes."""
    out = []
    while rows > 0:
        k = int(min(rng.integers(1, 7), rows))
        out.append(np.sort(rng.integers(0, G, size=k)))
        rows -= k
    return out


def _even_run(rows, G):
    """One run of `rows` rows over G genomes in subruns as even as can be."""
    per = np.full(G, rows // G)
    per[:rows % G] += 1
    return np.repeat(np.arange(G), per)


def sorted_table(case: str, rng_seed: int = 0):
    """(content, src, keys, seg_off, repeat_tolerance, repeat_limit,
    sentinel content, row_keys) of table `case`: content and src the
    (content, gid, pos)-sorted table as a stable sort of the position-order
    keys gives it, keys those (with row_keys the rows' own keys), seg_off
    the G + 1 genome bounds."""
    spec = TABLES[case]
    G = spec["G"]
    rng = np.random.default_rng(rng_seed)
    runs, sentinel = [], 0
    for kind, arg in spec["segs"]:
        if kind == "short":
            runs += _short_runs(rng, arg, G)
        elif kind == "pad_to":
            have = sum(len(r) for r in runs)
            assert arg >= have, (case, arg, have)
            runs += _short_runs(rng, arg - have, G)
        elif kind == "run":
            runs.append(_even_run(arg, G))
        elif kind == "subruns":
            runs.append(np.repeat(np.arange(len(arg)), arg))
        else:
            sentinel = arg
    lengths = np.array([len(r) for r in runs], dtype=np.int64)
    gid = np.concatenate(runs + [rng.integers(0, G, size=sentinel)])
    n_real = int(lengths.sum())
    run_content = np.cumsum(rng.integers(1, 1 << 20, size=len(runs)))
    run_content[len(runs) // 2:] += 1 << 62
    content = np.concatenate([np.repeat(run_content, lengths),
                              np.full(sentinel, SENT)])
    if sentinel:
        gid[n_real:] = np.sort(gid[n_real:])
    n = len(gid)
    strand = rng.integers(0, 2, size=n)
    strand[n_real:] = 1
    # positions: a random permutation a genome, ascending inside each
    # (content, genome) subrun, as the stable sort orders them
    counts = np.bincount(gid, minlength=G)
    seg_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    pos = np.empty(n, dtype=np.int64)
    for g in range(G):
        rows = np.flatnonzero(gid == g)
        pos[rows] = rng.permutation(len(rows))
    sub = np.ones(n, dtype=bool)
    sub[1:] = (content[1:] != content[:-1]) | (gid[1:] != gid[:-1])
    sub_id = np.cumsum(sub)
    order = np.lexsort((pos, sub_id))
    pos = pos[order]                # sub_id is sorted: each subrun's rows
    src = seg_off[gid] + pos
    keys = np.empty(n, dtype=np.int64)
    keys[src] = (content << 1) | strand
    row_keys = spec.get("row_keys", False)
    t = dict(content=torch.from_numpy(content), src=torch.from_numpy(src),
             keys=torch.from_numpy(keys[src] if row_keys else keys),
             seg_off=torch.from_numpy(seg_off))
    return (t["content"], t["src"], t["keys"], t["seg_off"],
            spec.get("tol", 0), spec.get("limit", 1000), SENT, row_keys)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, torch.Tensor):
            assert g.dtype == r.dtype and torch.equal(g, r)
        else:
            assert g == r


@pytest.mark.parametrize("case", list(TABLES))
def test_table_is_a_sorted_seed_table(case):
    """Each table is what a stable sort of its position-order keys gives,
    and reaches what its name says."""
    content, src, keys, seg_off, tol, limit, sent, row_keys = \
        sorted_table(case)
    n = content.shape[0]
    if not row_keys:
        c2, s2 = torch.sort(pairwise.shr(keys, 1), stable=True)
        assert torch.equal(c2, content) and torch.equal(s2, src)
    else:
        assert torch.equal(pairwise.shr(keys, 1), content)
    sc = pairwise.run_starts(content)
    longest = int(torch.diff(torch.cat([torch.nonzero(sc).flatten(),
                                        torch.tensor([n])])).max())
    if case in ("multi_tile_run", "one_run", "sentinel_run"):
        assert longest > 32 * T
    if case == "start_at_tile":
        assert bool(sc[3 * T]) and bool(sc[5 * T])
    if case == "end_at_tile":
        assert bool(sc[5 * T]) and not bool(sc[5 * T - 1])
    if case.startswith("limit"):
        assert limit < longest


@pytest.mark.parametrize("case", list(TABLES))
def test_k5_launches_compose_to_plain(case):
    """K5's plain summaries (no row flagged) and its flag pass on them equal
    run_flags_plain, bit for bit."""
    content, src, keys, seg_off, _, limit, sent, row_keys = \
        sorted_table(case)
    if row_keys:
        keys = torch.zeros(int(seg_off[-1]), dtype=torch.int64).scatter_(
            0, src, keys)
    words = pairwise.run_summaries_plain(content, src, seg_off)
    assert words.shape == (2 * pairwise.run_tiles(content.shape[0]),)
    assert not bool((words & 1).any())
    got = pairwise.run_flags_from_summaries_plain(content, src, keys, seg_off,
                                                  words, limit, sent)
    ref = pairwise.run_flags_plain(content, src, keys, seg_off, limit, sent)
    _same(got, ref)
    if case in ("n1", "limit_run_at_edge", "subrun_at_edge", "g2"):
        assert bool(ref.unique_occ.any())


@pytest.mark.parametrize("case", list(TABLES))
def test_k13_launches_compose_to_plain(case):
    """K13's plain summaries (big rows flagged) and its flag pass on them
    equal mum_seed_flags_plain, bit for bit."""
    content, src, keys, seg_off, tol, limit, sent, row_keys = \
        sorted_table(case)
    words = pairwise.run_summaries_plain(content, src, seg_off, tol + 1)
    got = mums.mum_flags_from_summaries_plain(
        content, src, keys, seg_off, words, tol, limit, sent, row_keys)
    ref = mums.mum_seed_flags_plain(content, src, keys, seg_off, tol, limit,
                                    sent, row_keys)
    _same(got, ref)
    if case in ("start_at_tile", "limit_run_at_edge", "limit_above_tile",
                "tol0_edge", "tol1_edge", "tol2_edge"):
        assert ref.n_rows > 0
    if case == "limit_above_tile":
        # the kept 4,960-row run is one candidate row; the other two drop
        sc = pairwise.run_starts(content)
        long_runs = torch.nonzero(sc).flatten()[
            torch.diff(torch.cat([torch.nonzero(sc).flatten(),
                                  torch.tensor([content.shape[0]])])) > 4_000]
        assert [bool(ref.kept_occ[r]) for r in long_runs] == [True, False,
                                                               False]


def test_empty_table_composes():
    """No row: no summary, empty flags, no candidate row."""
    e = torch.zeros(0, dtype=torch.int64)
    seg_off = torch.tensor([0, 0, 0])
    words = pairwise.run_summaries_plain(e, e, seg_off)
    assert words.numel() == 0
    got = pairwise.run_flags_from_summaries_plain(e, e, e, seg_off, words,
                                                  1000, SENT)
    assert all(x.numel() == 0 for x in got)
    got = mums.mum_flags_from_summaries_plain(e, e, e, seg_off, words, 0,
                                              1000, SENT)
    _same(got, mums.mum_seed_flags_plain(e, e, e, seg_off, 0, 1000, SENT))


@pytest.mark.parametrize("case", SMALL)
def test_plain_versions_equal_jax(case):
    """On the small tables, run_flags_plain and mum_seed_flags_plain equal
    the JAX package's _unique_occ_flags and _mum_seed_flags (run on the
    CPU, as its own tests run them)."""
    import jax.numpy as jnp
    from libmems_tpu import matchfind as jmf
    content, src, keys, seg_off, tol, limit, sent, row_keys = \
        sorted_table(case)
    flags = mums.mum_seed_flags_plain(content, src, keys, seg_off, tol, limit,
                                      sent, row_keys)
    jc = jnp.asarray(content.numpy().view(np.uint64))
    jg, jp, js = (jnp.asarray(x.numpy()) for x in
                  (flags.gid, flags.pos, flags.strand))
    jk, jrid, jref, jn = jmf._mum_seed_flags(jc, jg, jp, js, tol, limit)
    assert flags.n_rows == int(jn)
    for got, want in ((flags.kept_occ, jk), (flags.row_id, jrid),
                      (flags.ref_strand, jref)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if row_keys:
        return
    rf = pairwise.run_flags_plain(content, src, keys, seg_off, limit, sent)
    uo, rid = jmf._unique_occ_flags(jc, jg, jp, js, limit)
    np.testing.assert_array_equal(rf.unique_occ.numpy(), np.asarray(uo))
    np.testing.assert_array_equal(rf.run_id.numpy(), np.asarray(rid))
