"""Port parity: the seed occurrence list's device construction (the plain
versions of K16 and K17 on CPU tensors) against the JAX package's device
construction and against the host twin; tolerance 0, the float32 lists
are bit-equal (one case shows the JAX device route a unit in the last
place off its own host twin; the port equals the twin)."""

import numpy as np
import pytest
import torch

from libmems_tpu import anchorscore as janchorscore
from libmems_tpu import seeds as jseeds
from libmems_tpu.sequence import Genome as JaxGenome
from libmems_tpu.sml import SortedMerList as JaxSML
from libmems_tpu.sml import _bucket_len
from libmems_tpu_torch import anchorscore
from libmems_tpu_torch.ops import seedocc
from libmems_tpu_torch.sequence import Genome
from libmems_tpu_torch.sml import SortedMerList


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
SEED = jseeds.get_seed(11, 0)
SEED_LEN = jseeds.seed_length(SEED)


def _ascii(case: str, n: int = 6000) -> tuple[np.ndarray, bool]:
    """(ascii, circular) of the cases of tests/test_gbe_sp.py's host-twin
    parity test, from rng 11."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    asc = _LUT[codes].copy()
    if case == "n_runs":
        asc[1000:1040] = ord("N")
        asc[n // 2] = ord("R")
    if case.startswith("repeat"):
        # the final seed window repeats an interior one: the last
        # position must keep its raw count
        codes[-SEED_LEN:] = codes[100:100 + SEED_LEN]
        asc = _LUT[codes].copy()
    if case == "poly_a":
        asc[2000:2600] = ord("A")
    return asc, case.endswith("circular")


def _three_ways(asc, circular, seed=SEED):
    """(port on CPU tensors, JAX device construction, port's host twin)."""
    g = Genome("g", asc.copy(), circular=circular)
    jg = JaxGenome("g", asc.copy(), circular=circular)
    got = anchorscore.seed_occurrence_list(
        SortedMerList.create(g, seed, device="cpu"))
    ref = janchorscore.seed_occurrence_list(JaxSML.create(jg, seed))
    twin = anchorscore.seed_occurrence_list_np(g, seed)
    return got, ref, twin


@pytest.mark.parametrize("case", ["linear", "n_runs", "circular", "repeat",
                                  "repeat_circular", "poly_a"])
def test_seed_occurrence_list_equals_jax_and_host_twin(case):
    asc, circular = _ascii(case)
    got, ref, twin = _three_ways(asc, circular)
    assert got.dtype == np.float32 and got.shape == (len(asc),)
    np.testing.assert_array_equal(got, twin)
    if case == "poly_a":
        # On the CPU, XLA compiles the JAX device route's division by
        # seed_len into a multiplication by its reciprocal, so at four
        # positions of this run that route is one ulp off the JAX
        # package's own host twin.  The port divides, as the twin does.
        jtwin = janchorscore.seed_occurrence_list_np(
            JaxGenome("g", asc.copy()), SEED)
        np.testing.assert_array_equal(got, jtwin)
        assert 0 < (ref != jtwin).sum() < 10
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    else:
        np.testing.assert_array_equal(got, ref)
    if case == "repeat":
        assert got[-1] == 1.0
    if case == "poly_a":
        assert got.max() > 100
    if case == "n_runs":
        # masked windows count 1 and do not form a run
        assert (got[1000:1040 - SEED_LEN] == 1.0).all()


def test_long_poly_a_and_n_runs_equal_jax_and_host_twin():
    """A 40 kbp genome with a 20 kbp poly-A run and a 10 kbp N run: a
    content run and a sentinel run of thousands of windows, each across
    several of K16's tiles of SEED_TILE sorted rows.  The port's plain
    route equals both host twins bit for bit, and the JAX device
    construction within one ulp (its division is a reciprocal multiply on
    the CPU, as in the poly_a case above)."""
    rng = np.random.default_rng(14)
    asc = _LUT[rng.integers(0, 4, 40_000)].copy()
    asc[5_000:25_000] = ord("A")
    asc[28_000:38_000] = ord("N")
    got, ref, twin = _three_ways(asc, False)
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got, janchorscore.seed_occurrence_list_np(
        JaxGenome("g", asc.copy()), SEED))
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    assert (got != ref).sum() < 10
    assert got.max() > 10_000
    assert (got[28_000:38_000 - SEED_LEN] == 1.0).all()


def test_bucket_boundary_lengths_equal_jax():
    """Genome lengths either side of a JAX length bucket: the JAX package
    pads the table to the bucket, the port never pads."""
    n0 = 5000
    edge = _bucket_len(n0)
    assert _bucket_len(edge) == edge < _bucket_len(edge + 1)
    rng = np.random.default_rng(12)
    for n_windows in (edge - 1, edge, edge + 1):
        asc = _LUT[rng.integers(0, 4, n_windows + SEED_LEN - 1)]
        got, ref, twin = _three_ways(asc, False)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("n", [1, SEED_LEN - 1, SEED_LEN])
def test_genome_at_or_below_the_seed_length(n):
    """No window (all ones), and exactly one window."""
    asc = _LUT[np.random.default_rng(n).integers(0, 4, n)]
    got, ref, twin = _three_ways(asc, False)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, twin)
    assert (got == 1.0).all()


def test_u64_key_sentinel_counts_one():
    """A weight-17 seed has 64-bit keys, whose sentinel is -1 as int64."""
    seed = jseeds.get_seed(17, 0)
    asc, _ = _ascii("n_runs", 3000)
    got, ref, twin = _three_ways(asc, False, seed)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, twin)


def test_seed_occurrence_lists_routes_are_bit_equal(monkeypatch):
    """With genomes given, small genomes take the host twin; without
    them, or above SOL_HOST_MAX windows, the device construction: all
    three give the same lists, and the JAX package's."""
    cases = ["linear", "n_runs", "circular"]
    gs = [Genome(c, _ascii(c)[0], circular=_ascii(c)[1]) for c in cases]
    gs.append(Genome("short", _LUT[np.zeros(SEED_LEN - 2, np.uint8)]))
    smls = [SortedMerList.create(g, SEED, device="cpu") for g in gs]
    calls = []
    real = seedocc.seed_smooth
    monkeypatch.setattr(seedocc, "seed_smooth",
                        lambda *a: calls.append(1) or real(*a))
    via_host = anchorscore.seed_occurrence_lists(smls, gs)
    assert not calls
    via_dev = anchorscore.seed_occurrence_lists(smls)
    assert len(calls) == 3          # the windowless genome is all ones
    monkeypatch.setattr(anchorscore, "SOL_HOST_MAX", 1_000)
    above = anchorscore.seed_occurrence_lists(smls, gs)
    assert len(calls) == 6
    ref = janchorscore.seed_occurrence_lists(
        [JaxSML.create(JaxGenome(g.name, g.ascii.copy(),
                                 circular=g.circular), SEED) for g in gs])
    for a, b, c, r in zip(via_host, via_dev, above, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, r)


def test_smoothing_sums_stay_exact_past_float32_integers():
    """Counts whose window sums exceed 2^24: the int64 sum keeps every
    unit that a float32 running sum would drop."""
    rng = np.random.default_rng(13)
    count = rng.integers(1 << 21, 1 << 22, 4000).astype(np.int32)
    got = seedocc.seed_smooth(torch.from_numpy(count), 21).numpy()
    np.testing.assert_array_equal(
        got, anchorscore._smooth_counts_np(count, 21))
    np.testing.assert_array_equal(
        got, janchorscore._smooth_counts_np(count, 21))
    for seed_len, n in ((0, 5), (7, 1)):
        c = count[:n]
        np.testing.assert_array_equal(
            seedocc.seed_smooth(torch.from_numpy(c), seed_len).numpy(),
            anchorscore._smooth_counts_np(c, seed_len))
