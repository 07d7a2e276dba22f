"""Port parity: pair MUM discovery against the JAX package, exact, in
the default mode and the others."""

import io

import numpy as np
import pytest

from libmems_tpu import seeds as jseeds
from libmems_tpu.matchfind import find_mums as jax_find_mums
from libmems_tpu.sequence import Genome as JaxGenome
from libmems_tpu.sml import SortedMerList as JaxSML
from libmems_tpu_torch import convert
from libmems_tpu_torch.match import write_match_list
from libmems_tpu_torch.matchfind import find_mums, find_pair_mums_np
from libmems_tpu_torch.sequence import Genome
from libmems_tpu_torch.sml import create_smls
from tests.golden import generate


def _pair_ascii(rng_seed, n=40_000):
    """An ancestor and a mutant with an inversion; N runs in both."""
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    b = generate._mutant(rng, anc, invert=(3 * n // 10, n // 2))
    a_asc = generate._LUT[anc].copy()
    b_asc = generate._LUT[b].copy()
    a_asc[n // 8:n // 8 + 60] = ord("N")
    b_asc[3 * n // 4:3 * n // 4 + 10] = ord("N")
    a_asc[5 * n // 8] = ord("R")
    return a_asc, b_asc


def _both(a_asc, b_asc):
    port = [Genome("a", a_asc.copy()), Genome("b", b_asc.copy())]
    ref = [JaxGenome("a", a_asc.copy()), JaxGenome("b", b_asc.copy())]
    return port, ref


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


@pytest.mark.parametrize("weight", [None, 17])
@pytest.mark.parametrize("rng_seed", [11, 12, 13])
def test_find_mums_equal_jax(rng_seed, weight):
    seed = None if weight is None else jseeds.get_seed(weight)
    port, ref = _both(*_pair_ascii(rng_seed))
    got = find_mums(port, seed=seed, device="cpu")
    want = jax_find_mums(ref, seed=seed)
    assert len(want) > 10
    assert (want.starts[:, 1] < 0).any()          # the inversion
    _assert_same(got, want)


def test_find_mums_equals_numpy_twin():
    a_asc, b_asc = _pair_ascii(14)
    port, _ = _both(a_asc, b_asc)
    smls, seed = create_smls(port, device="cpu")
    got = find_mums(smls)
    twin = find_pair_mums_np(port[0].codes, port[1].codes, seed,
                             port[0].ambig, port[1].ambig)
    _assert_same(got, twin.canonical_sort())


def test_pair_mums_golden_bytes():
    gs = [Genome(g.name, g.ascii, filename=g.filename)
          for g in generate._genomes_pair()]
    mums = find_mums(gs, device="cpu")
    buf = io.StringIO()
    write_match_list(buf, mums, [g.filename for g in gs],
                     [len(g) for g in gs])
    with open(f"{generate.GOLDEN_DIR}/pair.mums", "rb") as fh:
        assert buf.getvalue().encode() == fh.read()


@pytest.mark.parametrize("circular", [False, True])
def test_jax_smls_through_convert_give_same_mums(circular):
    a_asc, b_asc = _pair_ascii(15)
    _, ref = _both(a_asc, b_asc)
    seed = jseeds.get_seed(11)
    jsmls = [JaxSML.create(g, seed, circular=circular) for g in ref]
    smls = [convert.sml_from_reference(
        np.asarray(s.keys), np.asarray(s.sorted_keys),
        np.asarray(s.sorted_positions), s.seed, s.length, s.circular,
        "cpu") for s in jsmls]
    _assert_same(find_mums(smls), jax_find_mums(jsmls))


@pytest.mark.parametrize("kwargs", [
    dict(repeat_tolerance=1),
    dict(enumeration_tolerance=2),
    dict(extend=False),
    dict(seq_mask=0b01),
])
def test_unported_modes_raise(kwargs):
    """The modes beyond the default pair mode run and equal the JAX
    package (a one-genome seq_mask gives no match on either side)."""
    port, ref = _both(*_pair_ascii(16, n=2_000))
    got = find_mums(port, device="cpu", **kwargs)
    want = jax_find_mums(ref, **kwargs)
    assert len(want) > 0 or kwargs == dict(seq_mask=0b01)
    _assert_same(got, want)


def test_three_genomes_raise():
    """Three genomes (the pair plus a copy of its first genome) run and
    equal the JAX package."""
    port, ref = _both(*_pair_ascii(16, n=2_000))
    got = find_mums(port + [port[0]], device="cpu")
    want = jax_find_mums(ref + [ref[0]])
    _assert_same(got, want)
