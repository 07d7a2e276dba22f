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
from libmems_tpu_torch.ops.pairwise import shr as _shr
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


# every spaced pattern of the seed table, and solid seeds up to the
# solid 32 that get_seed returns above weight 31
ALL_SEEDS = {f"w{w}_r{r}": p for w, pats in jseeds._SPACED_SEEDS.items()
             for r, p in enumerate(pats)}
ALL_SEEDS.update({f"solid{w}": jseeds.solid_seed(w) for w in (5, 31, 32)})


def _i64(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def _swap(x: torch.Tensor, s: int, m: int) -> torch.Tensor:
    return (_shr(x, s) & m) | ((x & m) << s)


def _brev64(x: torch.Tensor) -> torch.Tensor:
    for s, m in ((1, 0x5555555555555555), (2, 0x3333333333333333),
                 (4, 0x0F0F0F0F0F0F0F0F), (8, 0x00FF00FF00FF00FF),
                 (16, 0x0000FFFF0000FFFF), (32, 0x00000000FFFFFFFF)):
        x = _swap(x, s, m)
    return x


def _kernel_keys(codes: np.ndarray, seed: int, ambig) -> torch.Tensor:
    """K1's arithmetic (csrc/mers.cu) in torch: a window's first 32 bases
    as one word W (base k at bits 63-2k), fwd from the run table, rc as
    pairswap(brev(fwd ^ wmask)) >> (64 - 2 * weight), the ambiguity test
    on flag bits packed 32 bases a word."""
    weight, length = jseeds.seed_weight(seed), jseeds.seed_length(seed)
    n = codes.shape[0] - length + 1
    c = torch.from_numpy(np.concatenate([codes, np.zeros(32, np.uint8)])
                         ).to(torch.int64)
    W = torch.zeros(n, dtype=torch.int64)
    for k in range(32):
        W |= c[k:k + n] << (62 - 2 * k)
    fwd = torch.zeros(n, dtype=torch.int64)
    for shift, mask in mers.seed_runs(seed):
        fwd |= _shr(W, shift) & _i64(mask)
    wmask = _i64((1 << 2 * weight) - 1)
    rc = _shr(_swap(_brev64(fwd ^ wmask), 1, 0x5555555555555555),
              64 - 2 * weight)
    keys = mers.umin(fwd << 1, (rc << 1) | 1)
    if ambig is None:
        return keys
    bits = np.concatenate([ambig, np.zeros(64 - ambig.shape[0] % 32,
                                           bool)])
    words = torch.from_numpy(np.packbits(bits, bitorder="little").view(
        np.uint32).astype(np.int64))
    p = torch.arange(n)
    A = words[p >> 5] | (words[(p >> 5) + 1] << 32)
    bad = (_shr_each(A, p & 31) & ((1 << length) - 1)) != 0
    return torch.where(bad, mers.key_sentinel(seed), keys)


def _shr_each(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift by a per-element amount below 64."""
    return (x >> s) & ((torch.ones_like(x) << (64 - s)) - 1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(ALL_SEEDS))
def test_seed_keys_every_seed_equal_jax(name, masked):
    """The plain K1 and the kernel's formulation (run table, funnel word,
    brev) against the JAX package for every seed the package can pick,
    with N runs (one over the last bases) and without."""
    seed = ALL_SEEDS[name]
    rng = np.random.default_rng(len(name) + seed % 1000)
    codes = rng.integers(0, 4, size=400).astype(np.uint8)
    ambig = None
    if masked:
        ambig = np.zeros(400, dtype=bool)
        ambig[37:45] = True
        ambig[200] = True
        ambig[396:] = True
        ref = jax_keys(jnp.asarray(codes), seed, jnp.asarray(ambig))
        got = mers.canonical_seed_keys(torch.from_numpy(codes), seed,
                                       torch.from_numpy(ambig))
    else:
        ref = jax_keys(jnp.asarray(codes), seed)
        got = mers.canonical_seed_keys(torch.from_numpy(codes), seed)
    want = _as_int64(ref)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_kernel_keys(codes, seed, ambig).numpy(),
                                  want)


def test_sentinel_sorts_last_for_u64_keys():
    seed = SEEDS["u64_w17"]
    keys = torch.tensor([5, mers.key_sentinel(seed), 3, 1 << 40])
    vals, pos = mers.sort_keys(keys)
    assert vals.tolist() == [3, 5, 1 << 40, -1]
    assert pos.tolist() == [2, 0, 3, 1]
