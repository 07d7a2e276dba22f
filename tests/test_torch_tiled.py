"""Port parity: the position-tiled extension (K29-K31 through their plain
versions) against the JAX package's build_position_tiles,
make_probe_round and sharded_find_mums_tiled.  Shards run on
``Mesh([cpu] * n)``; the JAX package runs on its virtual CPU mesh
(tests/conftest.py).  Exact throughout: tiles, row states and match rows
equal."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu import seeds as jseeds
from libmems_tpu.ops import extend as jextend
from libmems_tpu.ops.extend import _fetch_spans, make_probe_round
from libmems_tpu.parallel import shard as jsh
from jax.sharding import PartitionSpec as P
from libmems_tpu.sml import SortedMerList as JaxSML
from libmems_tpu_torch.matchfind import find_mums
from libmems_tpu_torch.ops import mums as ops_mums
from libmems_tpu_torch.ops import shard as ops_shard
from libmems_tpu_torch.ops import tiled as ops_tiled
from libmems_tpu_torch.ops.mers import sentinel_content
from libmems_tpu_torch.parallel import shard as psh
from libmems_tpu_torch.sml import SortedMerList

CPU = torch.device("cpu")
SEED = jseeds.get_seed(9, 0)
# the span rows with planted match gaps (no JAX; loaded by path, as the
# card's tests load it)
_spec = importlib.util.spec_from_file_location(
    "extend_rows", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "extend_rows.py"))
extend_rows = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(extend_rows)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got, want):
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.fixture(scope="module")
def pair():
    """tests/test_sharded_mums.py:104's pair: a 6 kbp genome and a 2%
    mutant whose halves are swapped, the first half inverted.  Returns
    (the port's SMLs, the JAX package's SMLs, the JAX package's
    sharded_find_mums_tiled on make_mesh(4) at capacity 2048, made once:
    each JAX call compiles its rounds anew)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, size=6000).astype(np.uint8)
    b = a.copy()
    idx = rng.random(len(b)) < 0.02
    b[idx] = rng.integers(0, 4, size=int(idx.sum()))
    b = np.concatenate([b[3000:], (3 - b[:3000])[::-1]])
    jsmls = [JaxSML.create(x, SEED) for x in (a, b)]
    want = jsh.sharded_find_mums_tiled(jsmls, jsh.make_mesh(4),
                                       capacity=2048)
    return ([SortedMerList.create(x, SEED, device="cpu") for x in (a, b)],
            jsmls, want)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_build_position_tiles_equals_jax(dtype, n_dev):
    """The padded tiles, tile size and offset of the JAX package's, and
    the tiled path's own tiles (built from each genome's keys, the
    concatenation never formed) equal their rows."""
    rng = np.random.default_rng(n_dev)
    keys = rng.integers(0, np.iinfo(dtype).max, 5_000, dtype=np.uint64
                        ).astype(dtype)
    want = jsh.build_position_tiles(keys, n_dev, 512)
    got = psh.build_position_tiles(keys, n_dev, 512)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    assert got[1:] == want[1:]
    cut = [keys[:1_800], keys[1_800:]]
    as_i64 = [torch.from_numpy(k.astype(np.uint64).view(np.int64)) for k in cut]
    sentinel = int(np.array(~dtype(0)).astype(np.uint64).view(np.int64))
    S, big, halo = psh._tile_geometry(len(keys), n_dev, 512)
    for d in range(n_dev):
        tile = psh._table_range(as_i64, d * S - big, d * S + S + halo - big,
                                sentinel, CPU)
        np.testing.assert_array_equal(
            tile.numpy(), want[0][d].astype(np.uint64).view(np.int64))


def _shard_rows(mesh, tiles):
    """The tiled path's init step on the CPU mesh: every shard's candidate
    rows (K26, K13 at tolerance 0, K27)."""
    tables, dropped = psh._route(mesh, tiles.slices, tiles.sentinel, 1 << 14)
    assert dropped == 0
    rows = []
    for content, src, rk in tables:
        f = ops_mums.mum_seed_flags(content, src, rk, tiles.seg_off[CPU], 0,
                                    1000, sentinel_content(SEED),
                                    row_keys=True)
        rows.append(ops_shard.shard_candidates(f, 2, 2048, tiles.seed_len))
    return rows


@pytest.mark.parametrize("C", [15, 33, 512, 520])
@pytest.mark.parametrize("n", [0, 1, 300])
def test_tiled_serve_equals_jax(monkeypatch, C, n):
    """K30's plain version against the owner's answer in
    parallel/shard.py:572-577 (ops/extend.py's _fetch_spans on the served
    starts, the sentinel row where a start lies outside [0, S)): odd and
    even starts, the tile's first and last, starts outside it on both
    sides, and no requests.  _fetch_spans takes its "slice" strategy, a
    dynamic_slice a row: its "rows" strategy reads C // 128 + 1 rows of
    128 keys, which hold a span only where start % 128 + C fits them.
    Exact."""
    monkeypatch.setattr(jextend, "FETCH", "slice")
    rng = np.random.default_rng(C + n)
    S = 1024
    size = S + C + 128
    tile = rng.integers(-2**62, 2**62, size)
    offs = rng.integers(-40, S + 40, n)
    offs[:4] = [0, 1, S - 1, S][:n]
    want = np.zeros((n, C), np.int64)
    if n:
        junk = (offs < 0) | (offs >= S)
        served = np.asarray(_fetch_spans(
            jnp.asarray(tile), jnp.asarray(np.where(junk, 0, offs),
                                           jnp.int32), C))
        want = np.where(junk[:, None], np.int64(-1), served)
    got = ops_tiled.tiled_serve(torch.from_numpy(tile), S,
                                torch.from_numpy(offs), C, -1)
    assert got.shape == (n, C) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_fetch(monkeypatch, tiles, starts, S, n_dev, req_cap, C):
    """The JAX package's span fetch (_dist_fetch_factory) of every shard's
    starts on its virtual CPU mesh: (the spans [n_dev, n, C], the requests
    past req_cap a shard, the send rows [n_dev, n_dev, req_cap] each shard
    built, -1 where empty), the send rows taken from the fetch's first
    all_to_all."""
    monkeypatch.setattr(jextend, "FETCH", "slice")
    real = jax.lax.all_to_all
    sent = []

    def spy(x, *a, **k):
        sent.append(x)
        return real(x, *a, **k)
    monkeypatch.setattr(jax.lax, "all_to_all", spy)

    @jax.jit
    @jax.shard_map(mesh=jsh.make_mesh(n_dev),
                   in_specs=(P(jsh.SHARD_AXIS), P(jsh.SHARD_AXIS)),
                   out_specs=(P(jsh.SHARD_AXIS), P(jsh.SHARD_AXIS),
                              P(jsh.SHARD_AXIS)))
    def run(tile, start):
        fetch = jsh._dist_fetch_factory(tile[0], S, n_dev, req_cap)
        spans, aux = fetch(start[0], C, jnp.zeros((), jnp.int32))
        return spans[None], aux[None], sent[0][None]

    out = run(jnp.asarray(tiles), jnp.asarray(starts))
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("G,n_dev,req_cap", [(2, 4, 4096), (3, 4, 160),
                                             (5, 3, 2048), (2, 8, 1024)])
def test_request_layout_equals_jax_fetch(monkeypatch, G, n_dev, req_cap):
    """K29's plain version on each of n_dev shards' rows against the JAX
    fetch on the same requests (the present genomes of every row, in
    (row, genome) order, on a shared presence pattern): each owner's
    filled send row holds the JAX send row's starts as a sorted multiset
    (tile-local here, global there; where req_cap drops requests, the
    same count of them, all among the owner's requests), the same
    requests past req_cap a shard, and the spans that `where` resolves to
    through _spans and the tally's offsets equal the JAX fetch's spans on
    every request both answered (all of them unless req_cap drops; a
    dropped request reads the sentinel row in both)."""
    rng = np.random.default_rng(G * n_dev + req_cap)
    R, S, C, seed_len, fill = 600, 2048, 64, 15, -1
    big = C
    halo = C + 128
    tiles = rng.integers(-2**62, 2**62, (n_dev, S + halo))
    present = torch.from_numpy(rng.random((R, G)) < 0.85)
    present[:, 0] = True
    gen_off = torch.from_numpy((np.arange(G) * (n_dev * S // G)
                                ).astype(np.int32))
    rows = torch.arange(R)
    reqs, starts = [], []
    side = int(rng.integers(0, 2))
    for _ in range(n_dev):
        lefts = torch.from_numpy(rng.integers(
            0, n_dev * S // G + 300, (R, G)).astype(np.int32))
        lengths = torch.from_numpy(rng.integers(15, 200, R).astype(np.int32))
        is_fwd = torch.from_numpy(rng.random((R, G)) < 0.5)
        args = (rows, lefts, lengths, present, is_fwd, gen_off, side, C,
                seed_len, big, S, n_dev, req_cap)
        reqs.append(ops_tiled.tiled_requests_plain(*args))
        start, asks = ops_tiled._span_starts(*args[:10])
        starts.append(start[asks].numpy())
    starts = np.stack(starts).astype(np.int32)
    spans, over, send = _jax_fetch(monkeypatch, tiles, starts, S, n_dev,
                                   req_cap, C)
    tiles_t = [torch.from_numpy(t) for t in tiles]
    dropped = 0
    for s, q in enumerate(reqs):
        counts, past = ops_tiled.tally_counts(q.tally.tolist(), n_dev)
        assert past == over[s]
        dropped += past
        asked = starts[s]
        owner = np.clip(asked // S, 0, n_dev - 1)
        answers = []
        for o in range(n_dev):
            mine = q.send[o, :counts[o]].numpy() + o * S
            theirs = send[s, o][send[s, o] != -1]
            assert len(mine) == len(theirs) == min(req_cap,
                                                   int((owner == o).sum()))
            if past == 0:
                np.testing.assert_array_equal(np.sort(mine), np.sort(theirs))
            else:
                pool = np.sort(asked[owner == o])
                pos = np.searchsorted(pool, np.sort(mine))
                assert (pool[np.minimum(pos, len(pool) - 1)]
                        == np.sort(mine)).all()
            answers.append(ops_tiled.tiled_serve_plain(
                tiles_t[o], S, q.send[o, :counts[o]], C, fill))
        got = ops_tiled._spans(torch.cat(answers), q.where, C, fill,
                               q.offsets)[present].numpy()
        ours = q.where[present].numpy() >= 0
        if past == 0:
            assert ours.all()
            np.testing.assert_array_equal(got, spans[s])
        else:
            both = ours & (spans[s] != fill).any(axis=1)
            assert both.sum() > 100
            np.testing.assert_array_equal(got[both], spans[s][both])
            assert (got[~ours] == fill).all()
    assert (dropped > 0) == (req_cap < 200)


@pytest.mark.parametrize("side", [0, 1])
def test_probe_round_equals_jax(pair, side):
    """One probe round of every shard's rows through K29-K31's plain
    versions and the exchange of a 4-shard CPU mesh equals the JAX
    make_probe_round with a local _fetch_spans fetch of the padded table:
    left ends, lengths and activity (side 1 after a side-0 round)."""
    smls, _, _ = pair
    mesh = psh.Mesh([CPU] * 4)
    tiles = psh._Tiles(smls, mesh, 512)
    rows = _shard_rows(mesh, tiles)
    assert sum(r.lengths.shape[0] for r in rows) > 20
    padded = np.concatenate([t.numpy()[:tiles.S] for t in tiles.tiles]
                            + [tiles.tiles[-1].numpy()[tiles.S:]])
    keys = jnp.asarray(padded.view(np.uint64).astype(np.uint32))

    def fetch(span_start, C, aux):
        return _fetch_spans(keys, span_start, C), aux

    # the JAX round on every shard's rows at once
    counts = [s.n_windows for s in smls]
    cat = {k: np.concatenate([getattr(r, k).numpy() for r in rows])
           for k in ("lefts", "lengths", "present", "is_fwd")}
    R = len(cat["lengths"])
    pr = make_probe_round(
        fetch, jnp.uint32, tiles.seed_len, tiles.big,
        jnp.asarray(np.broadcast_to(np.array([0, counts[0]], np.int32),
                                    (R, 2))),
        jnp.asarray(np.broadcast_to(np.array(counts, np.int32), (R, 2))),
        jnp.asarray(cat["present"]), jnp.asarray(cat["is_fwd"]))
    start = jnp.asarray(cat["present"].any(axis=1))
    state = (jnp.asarray(cat["lefts"]), jnp.asarray(cat["lengths"]), start)
    for s in range(side + 1):
        l, n, a, _ = pr(s, 512, *state, jnp.int32(0))
        state = (l, n, a if s == side else start)
    want = [np.asarray(x) for x in (l, n, a)]
    lefts = [r.lefts for r in rows]
    lengths = [r.lengths for r in rows]
    for s in range(side + 1):
        active = [r.present.any(dim=1) for r in rows]
        blk = [torch.nonzero(a).flatten() for a in active]
        assert psh._probe_block(tiles, mesh, rows, lefts, lengths, active,
                                blk, s, 1 << 20) == 0
    for got, w in zip((lefts, lengths, active), want):
        np.testing.assert_array_equal(torch.cat(got).numpy(), w)


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("seed_len,C,G", [
    (15, 15, 2), (15, 33, 3), (15, 512, 2), (15, 520, 3), (21, 21, 3),
    (21, 33, 2), (21, 512, 3), (21, 520, 2), (40, 40, 2), (40, 512, 3),
    (40, 520, 2)])
def test_probe_round_on_span_rows_equals_jax(seed_len, C, G, side):
    """K31's plain version on extend_rows.span_rows (planted gaps of
    seed_len and seed_len + 1 ending at offsets 31-33, 63-65, C - seed_len
    and C, probe positions leaving the genome, sentinels, absent genomes,
    dropped requests) equals the JAX make_probe_round on the same spans
    (uint32 keys; the sentinels' low bits kept): left ends, lengths and
    activity of the block's rows; the rows outside it unchanged."""
    resp, where, rows, lefts, lengths, present, is_fwd, cnt, active = \
        extend_rows.span_rows(seed_len, C, G, side, seed_len + C + G)
    state = [torch.from_numpy(x.copy()) for x in (lefts, lengths, active)]
    ops_tiled.tiled_probe_plain(
        torch.from_numpy(resp), torch.from_numpy(where),
        torch.from_numpy(rows), state[0], state[1], torch.from_numpy(present),
        torch.from_numpy(is_fwd), torch.from_numpy(cnt), state[2], side, C,
        seed_len, -1, torch.zeros(1, dtype=torch.int64))
    # the JAX round on the block's rows, its fetch handing each genome's
    # spans in turn (the sentinel row where no span was answered)
    spans = np.where((where >= 0)[..., None], resp[np.maximum(where, 0)],
                     -1).astype(np.uint32)
    Rb = len(rows)
    calls = iter(range(G))

    def fetch(span_start, C_, aux):
        return jnp.asarray(spans[:, next(calls)]), aux

    pr = make_probe_round(
        fetch, jnp.uint32, seed_len, 0, jnp.zeros((Rb, G), jnp.int32),
        jnp.asarray(np.broadcast_to(cnt, (Rb, G))),
        jnp.asarray(present[rows]), jnp.asarray(is_fwd[rows]))
    l, n, a, _ = pr(side, C, jnp.asarray(lefts[rows]),
                    jnp.asarray(lengths[rows]), jnp.asarray(active[rows]),
                    jnp.int32(0))
    for got, want, before in zip(state, (l, n, a), (lefts, lengths, active)):
        np.testing.assert_array_equal(got.numpy()[rows], np.asarray(want))
        out = np.setdiff1d(np.arange(len(before)), rows)
        np.testing.assert_array_equal(got.numpy()[out], before[out])
    a = np.asarray(a)
    assert a.any() and not a.all()
    assert (np.asarray(n) > lengths[rows]).any()


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("G", [3, 33])
def test_probe_plain_resolves_owner_offsets(G, side):
    """K31's plain version on span_rows' spans regrouped by owner
    (extend_rows.owner_major: three of four owners answer, each owner's
    rows at a non-zero offset but the first's, the empty owner between
    two others) gives the same round as on the spans in one owner's
    answer."""
    seed_len, C = 15, 512
    resp, where, rows, lefts, lengths, present, is_fwd, cnt, active = \
        extend_rows.span_rows(seed_len, C, G, side, seed_len + C + G)
    resp2, where2, off2 = extend_rows.owner_major(resp, where,
                                                  np.array([0, 1, 3]), G)
    assert (off2[1:] > 0).all() and (where2 >> 32).max() == 3
    out = []
    for r, w, off in ((resp, where, np.zeros(1, np.int64)),
                      (resp2, where2, off2)):
        state = [torch.from_numpy(x.copy()) for x in (lefts, lengths, active)]
        ops_tiled.tiled_probe_plain(
            torch.from_numpy(r), torch.from_numpy(w), torch.from_numpy(rows),
            state[0], state[1], torch.from_numpy(present),
            torch.from_numpy(is_fwd), torch.from_numpy(cnt), state[2], side,
            C, seed_len, -1, torch.from_numpy(off))
        out.append(state)
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert out[0][2].any() and not out[0][2].all()


def test_sharded_find_mums_tiled_equals_jax(pair):
    smls, _, want = pair
    got = psh.sharded_find_mums_tiled(smls, psh.Mesh([CPU] * 4),
                                      capacity=2048)
    assert len(want) > 0 and psh.TILED_STATS["rounds"] > 2
    _same(got, want)
    _same(got, find_mums(smls))


def test_sharded_find_mums_tiled_req_cap_retry(pair, monkeypatch):
    """An undersized request capacity drops requests, which are counted
    and retried with req_cap doubled (tests/test_sharded_mums.py:127-146,
    on the port only): more than one pass, the same matches."""
    smls, _, want = pair
    calls = []
    real = psh._sharded_tiled_once

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out[3])
        return out
    monkeypatch.setattr(psh, "_sharded_tiled_once", spy)
    got = psh.sharded_find_mums_tiled(smls, psh.Mesh([CPU] * 4),
                                      capacity=2048, req_cap=256,
                                      max_retries=8)
    assert len(calls) >= 2 and calls[0] > 0 and calls[-1] == 0
    _same(got, want)
    with pytest.raises(ValueError, match="req_cap"):
        psh.sharded_find_mums_tiled(smls, psh.Mesh([CPU] * 4),
                                    capacity=2048, req_cap=256,
                                    max_retries=0)


def test_tiled_path_holds_no_whole_table(pair, monkeypatch):
    """The tiled path never builds the replicated table (_Layout), and
    each shard holds S + halo keys of the table, fewer than all of it."""
    smls, _, want = pair

    def refuse(*a, **k):
        raise AssertionError("the tiled path built _Layout")
    monkeypatch.setattr(psh, "_Layout", refuse)
    mesh = psh.Mesh([CPU] * 4)
    _same(psh.sharded_find_mums_tiled(smls, mesh, capacity=2048), want)
    tiles = psh._Tiles(smls, mesh, 512)
    n_keys = sum(s.n_windows for s in smls)
    for t in tiles.tiles:
        assert t.shape[0] == tiles.S + tiles.halo < n_keys
