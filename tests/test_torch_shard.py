"""Port parity: the seed-prefix routing of libmems_tpu_torch.parallel.shard
(K26's plain version) against the JAX package on its virtual CPU mesh
(tests/conftest.py): the owner-shard mix, the mesh padding, each shard's
routed and sorted seed table row for row (u64 keys as int64), the
surviving-run census and the per-shard loads; and the plain versions of
K26-K28 on their own.  Exact throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libmems_tpu import seeds as jseeds
from libmems_tpu.ops.mers import canonical_seed_keys_np
from libmems_tpu.parallel import shard as jsh
from libmems_tpu_torch.ops import mums
from libmems_tpu_torch.ops import shard as ops_shard
from libmems_tpu_torch.ops.mers import key_sentinel
from libmems_tpu_torch.ops.pairwise import shr
from libmems_tpu_torch.parallel import shard as psh

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _as_int64(x: np.ndarray) -> np.ndarray:
    return x.view(np.int64) if x.dtype == np.uint64 else x.astype(np.int64)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_bucket_of_equals_jax(n_dev):
    rng = np.random.default_rng(n_dev)
    for bits, dt in ((31, np.uint32), (62, np.uint64)):
        content = rng.integers(0, 1 << bits, 20_000,
                               dtype=np.uint64).astype(dt)
        content[:3] = [0, 1, (1 << bits) - 1]
        want = np.asarray(jsh._bucket_of(jnp.asarray(content), 11, n_dev))
        got = ops_shard.bucket_of(torch.from_numpy(_as_int64(content)),
                                  n_dev)
        np.testing.assert_array_equal(got.numpy(), want)
        if n_dev == 3:      # the clamp: shard 2 owns half the space
            assert (want == 2).mean() > 0.4


@pytest.mark.parametrize("dt", [np.uint32, np.uint64])
def test_pad_table_for_mesh_equals_jax(dt):
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 30, 1003, dtype=np.uint64).astype(dt)
    gid = np.repeat(np.arange(2, dtype=np.int32), [500, 503])
    pos = np.concatenate([np.arange(500), np.arange(503)]).astype(np.int32)
    for n_dev in (1, 2, 4, 8):
        want = jsh.pad_table_for_mesh(keys, gid, pos, n_dev)
        got = psh.pad_table_for_mesh(keys, gid, pos, n_dev)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        # the port's int64 keys with the sentinel of their key width
        k64, _, _ = psh.pad_table_for_mesh(
            _as_int64(keys), gid, pos, n_dev,
            sentinel=0xFFFFFFFF if dt == np.uint32 else None)
        np.testing.assert_array_equal(k64, _as_int64(want[0]))


def _table(weight):
    """Three genomes (a mutant and an inverted copy of the first) with an
    N run masked in the first: the position-order window table."""
    seed = jseeds.get_seed(weight, 0)
    rng = np.random.default_rng(weight)
    a = rng.integers(0, 4, 4_000).astype(np.uint8)
    b = a.copy()
    b[rng.random(len(b)) < 0.02] = 2
    c = (3 - a[:2_500])[::-1].copy()
    kl = [canonical_seed_keys_np(s, seed) for s in (a, b, c)]
    kl[0][700:760] = ~kl[0].dtype.type(0)        # masked windows
    keys = np.concatenate(kl)
    gid = np.concatenate([np.full(len(k), i, np.int32)
                          for i, k in enumerate(kl)])
    pos = np.concatenate([np.arange(len(k), dtype=np.int32) for k in kl])
    return seed, keys, gid, pos


CASES = [(2, 11), (4, 11), (2, 17), (4, 17)]
CENSUS = [(4, 17)]      # the JAX census and loads compile apiece


@pytest.fixture(scope="module")
def routed():
    """Every case's padded table and the JAX package's route (one
    shard_map compile each), with its census and loads in CENSUS."""
    out = {}
    for n_dev, weight in CASES:
        seed, keys, gid, pos = _table(weight)
        k, g, p = jsh.pad_table_for_mesh(keys, gid, pos, n_dev)
        mesh = jsh.make_mesh(n_dev)
        w = jseeds.seed_weight(seed)
        args = (jnp.asarray(k), jnp.asarray(g), jnp.asarray(p), mesh, w)
        out[n_dev, weight] = r = dict(
            table=(k, g, p), weight=w,
            routed=[np.asarray(x) for x in jsh.sharded_seed_table(*args)])
        if (n_dev, weight) in CENSUS:
            r["count"] = int(jsh.sharded_mum_seed_count(*args))
            r["loads"] = jsh.shard_loads(*args)
    return out


@pytest.mark.parametrize("n_dev,weight", CASES)
def test_sharded_seed_table_equals_jax(routed, n_dev, weight):
    r = routed[n_dev, weight]
    k, g, p = r["table"]
    assert k.dtype == (np.uint32 if weight == 11 else np.uint64)
    assert (k == ~k.dtype.type(0)).sum() >= 60       # masked windows
    got = psh.sharded_seed_table(k, g, p, psh.Mesh([CPU] * n_dev),
                                 r["weight"])
    for want, col in zip(r["routed"], got):
        assert len(col) == n_dev
        for d in range(n_dev):
            np.testing.assert_array_equal(col[d].numpy().astype(np.int64),
                                          _as_int64(want[d]))
    # the port's int64 keys route to the same shards
    got64 = psh.sharded_seed_table(torch.from_numpy(_as_int64(k)), g, p,
                                   psh.Mesh([CPU] * n_dev), r["weight"])
    for a, b in zip(got, got64):
        for d in range(n_dev):
            assert torch.equal(a[d], b[d])
    # shard_loads counts each shard's rows of real content
    content = r["routed"][0]
    loads = psh.shard_loads(k, g, p, psh.Mesh([CPU] * n_dev), r["weight"])
    np.testing.assert_array_equal(
        loads, (content != (~k.dtype.type(0) >> 1)).sum(axis=1))


@pytest.mark.parametrize("n_dev,weight", CASES)
def test_sharded_mum_seed_count_and_loads_equal_jax(routed, n_dev, weight):
    """The census equals the unsharded one (K13's run count on the whole
    table, as tests/test_sharding.py holds the JAX census), and in CENSUS
    the JAX package's census and loads."""
    r = routed[n_dev, weight]
    mesh = psh.Mesh([CPU] * n_dev)
    count = psh.sharded_mum_seed_count(*r["table"], mesh, r["weight"])
    loads = psh.shard_loads(*r["table"], mesh, r["weight"])
    k, g, p = r["table"]
    keys = torch.from_numpy(_as_int64(k))
    seg_off = torch.from_numpy(psh._table_layout(keys, g, p, int(
        _as_int64(np.array([~k.dtype.type(0)]))[0])))
    content, src = torch.sort(shr(keys, 1), stable=True)
    whole = mums.mum_seed_flags(content, src, keys, seg_off, 0, 1000,
                                psh._sentinels(r["weight"])[1])
    assert count == whole.n_rows > 100
    if (n_dev, weight) in CENSUS:
        assert count == r["count"]
        np.testing.assert_array_equal(loads, r["loads"])
    # every unmasked window arrives at exactly one shard
    assert loads.sum() == int((k != ~k.dtype.type(0)).sum())


def test_table_layout_rejects_unordered_tables():
    _, keys, gid, pos = _table(11)
    k, g, p = psh.pad_table_for_mesh(keys, gid, pos, 2)
    p = p.copy()
    p[10] += 1
    with pytest.raises(ValueError, match="position order"):
        psh.sharded_seed_table(k, g, p, psh.Mesh([CPU] * 2), 11)


def test_route_fill_plain_slots_and_drops():
    """Rows keep their order within a destination; rows past the
    capacity and masked windows are not sent, the former counted."""
    seed = jseeds.get_seed(15, 0)
    rng = np.random.default_rng(8)
    keys = torch.from_numpy(rng.integers(0, 1 << 31, 5_000))
    keys[::97] = key_sentinel(seed)
    n_dev = 4
    bucket = ops_shard.bucket_of(keys >> 1, n_dev).numpy()
    masked = (keys == key_sentinel(seed)).numpy()
    for cap in (5_000, 1_000, 300):
        r = ops_shard.route_fill_plain(keys, 1234, key_sentinel(seed),
                                       n_dev, cap)
        sent = 0
        for d in range(n_dev):
            rows = np.flatnonzero((bucket == d) & ~masked)
            n = min(len(rows), cap)
            np.testing.assert_array_equal(r.src[d, :n].numpy(),
                                          rows[:n] + 1234)
            np.testing.assert_array_equal(r.keys[d, :n].numpy(),
                                          keys.numpy()[rows[:n]])
            assert (r.keys[d, n:] == key_sentinel(seed)).all()
            assert (r.src[d, n:] == 0).all()
            sent += n
        assert int(r.dropped) == int((~masked).sum()) - sent
        assert (int(r.dropped) == 0) == (cap == 5_000)


def test_dedup_flags_plain_marks_each_distinct_valid_row_once():
    rng = np.random.default_rng(9)
    m, G = 400, 3
    lefts = torch.from_numpy(rng.integers(0, 5, (m, G)).astype(np.int32))
    present = torch.from_numpy(rng.random((m, G)) < 0.8)
    is_fwd = torch.from_numpy(rng.random((m, G)) < 0.5)
    lengths = torch.from_numpy(rng.integers(20, 22, m).astype(np.int32))
    valid = torch.from_numpy(rng.random(m) < 0.9)
    d = ops_shard.dedup_flags(lefts, present, is_fwd, lengths, valid)
    starts = np.where(present.numpy(), np.where(is_fwd.numpy(), 1, -1)
                      * (lefts.numpy() + 1), 0)
    rows = np.concatenate([starts, lengths.numpy()[:, None]], axis=1)
    want = {tuple(r) for r in rows[valid.numpy()]}
    got = np.concatenate([d.starts.numpy(), d.lengths.numpy()[:, None]],
                         axis=1)[d.uniq.numpy()]
    assert len(got) == len(want) == len({tuple(r) for r in got})
    assert {tuple(r) for r in got} == want
    # sorted by (starts..., length)
    keys = [tuple(r) for r in np.concatenate(
        [d.starts.numpy(), d.lengths.numpy()[:, None]], axis=1)]
    assert keys == sorted(keys)
