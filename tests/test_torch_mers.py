"""Port parity: canonical seed keys (K1's plain version) and SML build of
libmems_tpu_torch against the JAX package, exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu import seeds as jseeds
from libmems_tpu.ops.mers import canonical_seed_keys as jax_keys
from libmems_tpu.sml import SortedMerList as JaxSML
from libmems_tpu_torch.ops import mers
from libmems_tpu_torch.sml import SortedMerList


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SEEDS = {"u32_w15": jseeds.get_seed(15), "u64_w17": jseeds.get_seed(17)}


def _codes_and_ambig(rng, n):
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    ambig = np.zeros(n, dtype=bool)
    ambig[100:140] = True          # an N run
    ambig[n // 2] = True           # a lone ambiguous base
    ambig[n - 3:] = True           # a run at the end
    return codes, ambig


def _as_int64(keys) -> np.ndarray:
    """JAX unsigned keys as the port's int64 values."""
    k = np.asarray(keys)
    return k.view(np.int64) if k.dtype == np.uint64 else k.astype(np.int64)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(SEEDS))
def test_seed_keys_equal_jax(name, masked):
    seed = SEEDS[name]
    rng = np.random.default_rng(5)
    codes, ambig = _codes_and_ambig(rng, 3000)
    if masked:
        ref = jax_keys(jnp.asarray(codes), seed, jnp.asarray(ambig))
        got = mers.canonical_seed_keys(torch.from_numpy(codes), seed,
                                       torch.from_numpy(ambig))
    else:
        ref = jax_keys(jnp.asarray(codes), seed)
        got = mers.canonical_seed_keys(torch.from_numpy(codes), seed)
    assert np.asarray(ref).dtype == (np.uint32 if name == "u32_w15"
                                     else np.uint64)
    np.testing.assert_array_equal(got.numpy(), _as_int64(ref))
    # the numpy twin keeps the JAX key dtype
    twin = mers.canonical_seed_keys_np(codes, seed,
                                       ambig if masked else None)
    np.testing.assert_array_equal(twin, np.asarray(ref))


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("name", sorted(SEEDS))
def test_sml_create_equal_jax(name, circular):
    seed = SEEDS[name]
    rng = np.random.default_rng(9)
    codes, ambig = _codes_and_ambig(rng, 2500)
    codes[600:900] = codes[1200:1500]      # repeats: equal keys to order
    ref = JaxSML.create(codes, seed, circular=circular, ambig=ambig)
    got = SortedMerList.create(codes, seed, circular=circular, ambig=ambig,
                               device="cpu")
    assert got.length == ref.length and got.n_windows == ref.n_windows
    np.testing.assert_array_equal(got.keys.numpy(), _as_int64(ref.keys))
    np.testing.assert_array_equal(got.sorted_keys.numpy(),
                                  _as_int64(ref.sorted_keys))
    np.testing.assert_array_equal(got.sorted_positions.numpy(),
                                  np.asarray(ref.sorted_positions))
    assert got.unique_mer_count() == ref.unique_mer_count()


def test_sentinel_sorts_last_for_u64_keys():
    seed = SEEDS["u64_w17"]
    keys = torch.tensor([5, mers.key_sentinel(seed), 3, 1 << 40])
    vals, pos = mers.sort_keys(keys)
    assert vals.tolist() == [3, 5, 1 << 40, -1]
    assert pos.tolist() == [2, 0, 3, 1]
