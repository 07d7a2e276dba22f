"""Port parity: ungapped extension (K2's plain version) against the JAX
package's extend_matches, exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu import seeds as jseeds
from libmems_tpu.ops.extend import extend_matches as jax_extend
from libmems_tpu_torch.ops import extend, mers


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
