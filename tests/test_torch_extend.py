"""Port parity: ungapped extension (K2's plain version) against the JAX
package's extend_matches, exact; the independence from the round width
that K2's warp route relies on; the fused paths' live rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_e2e import _mutant_family
from libmems_tpu import seeds as jseeds
from libmems_tpu.ops.extend import extend_matches as jax_extend
from libmems_tpu_torch import matchfind
from libmems_tpu_torch.ops import extend, mers
from libmems_tpu_torch.sequence import Genome
from libmems_tpu_torch.sml import create_smls
from tests.extend_rows import FILL, gap_rows


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 12_000
INV = (5_000, 8_000)        # region of B that is A reverse-complemented


def _pair(rng):
    a = rng.integers(0, 4, size=N).astype(np.uint8)
    b = a.copy()
    sub = rng.random(N) < 0.004
    b[sub] = rng.integers(0, 4, size=int(sub.sum())).astype(np.uint8)
    lo, hi = INV
    b[lo:hi] = 3 - b[lo:hi][::-1]
    ambig_a = np.zeros(N, dtype=bool)
    ambig_a[2_000:2_030] = True                 # an N run in A
    return a, b, ambig_a


def _candidates(rng, seed_len):
    """Rows: forward seeds (some at both table ends, some beside the N
    run), reverse-strand seeds in the inverted region, absent rows."""
    n = N - seed_len + 1
    rows = []
    fwd_pos = list(rng.integers(0, INV[0] - seed_len, size=12)) \
        + list(rng.integers(INV[1], n, size=12)) \
        + [0, 1, n - 1, n - 2, 1_990, 2_031, INV[0] - seed_len]
    for p in fwd_pos:
        rows.append(([p, p], [True, True], [True, True]))
    for p in rng.integers(INV[0], INV[1] - seed_len, size=12):
        q = INV[0] + (INV[1] - (int(p) + seed_len))
        rows.append(([p, q], [True, True], [True, False]))
    rows.append(([0, 0], [False, False], [True, True]))
    rows.append(([7, 7], [False, False], [True, False]))
    lefts = np.array([r[0] for r in rows], dtype=np.int32)
    present = np.array([r[1] for r in rows], dtype=bool)
    is_fwd = np.array([r[2] for r in rows], dtype=bool)
    return lefts, present, is_fwd


@pytest.mark.parametrize("chunk_mode", ["default", "small"])
@pytest.mark.parametrize("weight", [15, 17])
def test_extend_matches_equal_jax(weight, chunk_mode):
    seed = jseeds.get_seed(weight)
    seed_len = jseeds.seed_length(seed)
    # small chunk: matches run far past 8*chunk, so rows escalate often
    # (a multiple of 128, as the JAX package's row fetch assumes)
    chunk = max(seed_len, 256) if chunk_mode == "default" else 128
    rng = np.random.default_rng(weight)
    a, b, ambig_a = _pair(rng)
    ka = mers.canonical_seed_keys_np(a, seed, ambig_a)
    kb = mers.canonical_seed_keys_np(b, seed)
    keys_u = np.concatenate([ka, kb])
    lefts, present, is_fwd = _candidates(rng, seed_len)
    R = len(lefts)
    off = np.tile(np.array([0, len(ka)], np.int32), (R, 1))
    cnt = np.tile(np.array([len(ka), len(kb)], np.int32), (R, 1))
    lengths = np.full(R, seed_len, dtype=np.int32)

    ref_l, ref_n = jax_extend(jnp.asarray(keys_u), seed_len, chunk,
                              jnp.asarray(off), jnp.asarray(cnt),
                              jnp.asarray(lefts), jnp.asarray(present),
                              jnp.asarray(is_fwd), jnp.asarray(lengths))
    keys = torch.from_numpy(keys_u.view(np.int64) if keys_u.dtype ==
                            np.uint64 else keys_u.astype(np.int64))
    got_l, got_n = extend.extend_matches(
        keys, seed_len, chunk, torch.from_numpy(off), torch.from_numpy(cnt),
        torch.from_numpy(lefts), torch.from_numpy(present),
        torch.from_numpy(is_fwd), torch.from_numpy(lengths),
        mers.key_sentinel(seed))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    ref_n = np.asarray(ref_n)
    assert ref_n.max() > 8 * chunk          # long matches were exercised
    assert (ref_n[present[:, 0]] > seed_len).any()


def test_extend_matches_rejects_small_chunk():
    t = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        extend.extend_matches(torch.zeros(4, dtype=torch.int64), 10, 5, t, t,
                              t, t.bool(), t.bool(),
                              torch.zeros(1, dtype=torch.int32), -1)


GAP_SEED_LEN = 21


def _torch_rows(rows):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in rows]


@pytest.mark.parametrize("C", [128, 256])
def test_extend_matches_round_edges_equal_jax(C):
    """K2's plain version against the JAX package on rows whose match
    gaps are exactly seed_len (the chain goes on) and seed_len + 1 (it
    ends), the match after the gap at C - 1, C, C + 1, 8C, 9C and 9C + 1
    of either side (the JAX rounds' edges), genome 1 on either strand;
    rows reaching a sequence's first and last window; sentinel runs.
    The lengths are the planted chains'."""
    sl = GAP_SEED_LEN
    rows = gap_rows(sl, C)
    keys, off, cnt, lefts, present, is_fwd, lengths = rows
    ref_l, ref_n = jax_extend(jnp.asarray(keys.view(np.uint64)), sl, C,
                              *[jnp.asarray(a) for a in rows[1:]])
    t = _torch_rows(rows)
    got_l, got_n = extend.extend_matches(t[0], sl, C, *t[1:], FILL)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    # gap_rows' order: per strand, 24 gap rows (side, gap, edge), three
    # rows to both sequence edges, a sentinel row
    want = []
    for _side in (0, 1):
        for gap in (sl, sl + 1):
            for at in (C - 1, C, C + 1, 8 * C, 9 * C, 9 * C + 1):
                far = 10 * C + 6 if gap == sl else at - gap
                want.append(sl + far + 2 + at % 5)
    n = got_n.numpy()
    L = 24 * C
    for s in (0, 28):
        np.testing.assert_array_equal(n[s:s + 24], want)
        assert (n[s + 24:s + 27] == L + sl - 1).all()
        assert (got_l.numpy()[s + 24:s + 27, 0] == 0).all()
        # the sentinel runs end the row on both sides
        assert n[s + 27] < 3 * C + C + 4 + sl


@pytest.mark.parametrize("chunk", ["seed_len", 128, 256, "one round"])
def test_extend_result_independent_of_round_width(chunk):
    """What K2's warp route relies on: a side ends at its maximal chain
    whatever the round widths, so the plain version gives the same rows
    at chunk = seed_len, 128, 256 and a chunk wide enough for one round,
    on the planted rows and on the pair's candidates."""
    sl = GAP_SEED_LEN
    cases = [(_torch_rows(gap_rows(sl, 256)), sl, FILL)]
    seed = jseeds.get_seed(15)
    rng = np.random.default_rng(15)
    a, b, ambig_a = _pair(rng)
    ka = mers.canonical_seed_keys_np(a, seed, ambig_a)
    kb = mers.canonical_seed_keys_np(b, seed)
    p_len = jseeds.seed_length(seed)
    lefts, present, is_fwd = _candidates(rng, p_len)
    R = len(lefts)
    keys = np.concatenate([ka, kb])
    cases.append(([torch.from_numpy(keys.view(np.int64) if keys.dtype ==
                                    np.uint64 else keys.astype(np.int64)),
                   torch.from_numpy(np.tile(np.array([0, len(ka)], np.int32),
                                            (R, 1))),
                   torch.from_numpy(np.tile(np.array([len(ka), len(kb)],
                                                     np.int32), (R, 1))),
                   torch.from_numpy(lefts), torch.from_numpy(present),
                   torch.from_numpy(is_fwd),
                   torch.full((R,), p_len, dtype=torch.int32)], p_len,
                  mers.key_sentinel(seed)))
    for t, seed_len, fill in cases:
        c = {"seed_len": seed_len, "one round": 1 << 14}.get(chunk, chunk)
        ref = extend.extend_matches(t[0], seed_len, 256, *t[1:], fill)
        got = extend.extend_matches(t[0], seed_len, c, *t[1:], fill)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert int(ref[1].max()) > 8 * 256


@pytest.mark.parametrize("G", [2, 3])
def test_fused_paths_extend_live_rows_only(G, monkeypatch):
    """The pair's (K19's decode) and the trio's (K15's) extension rows
    after their representatives are absent, the fused paths pass their
    count as n_live, and extending those rows alone gives every row of
    the call extended."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    smls, _ = create_smls([Genome(f"g{i}", lut[f].copy()) for i, f in
                           enumerate(_mutant_family(G, 30_000,
                                                    rng_seed=20 + G))],
                          device="cpu")
    real, calls = matchfind.extend_matches, []

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(matchfind, "extend_matches", spy)
    n_reps = matchfind.find_mums_device(smls)[4]
    assert (G == 2) == matchfind.pair_fast_path_ok(smls)
    (args, kw), = calls
    present = args[6]
    n = kw["n_live"]
    assert n == min(n_reps, present.shape[0]) and 0 < n < present.shape[0]
    assert present[:n].any(dim=1).all() and not present[n:].any()
    got, full = real(*args, **kw), real(*args)
    assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
