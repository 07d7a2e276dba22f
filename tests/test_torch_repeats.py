"""Port parity: within-genome repeat discovery (libmems_tpu_torch.repeats,
K2's plain version at the families' full row width) against the JAX
package, on the repeat cases of tests/test_formats_repeats.py; the
written repeat lists are byte-equal."""

import io

import numpy as np
import pytest
import torch

from libmems_tpu import repeats as jrep
from libmems_tpu import seeds as jseeds
from libmems_tpu_torch import repeats


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_str(c):
    return "".join("ACGT"[x] for x in c)


def _direct(rng):
    unit = rng.integers(0, 4, size=120).astype(np.uint8)
    mid = rng.integers(0, 4, size=200).astype(np.uint8)
    return np.concatenate([unit, mid, unit]), 50, 9


def _inverted(rng):
    unit = rng.integers(0, 4, size=150).astype(np.uint8)
    mid = rng.integers(0, 4, size=100).astype(np.uint8)
    return np.concatenate([unit, mid, (3 - unit)[::-1]]), 100, 9


def _tandem(rng):
    unit = rng.integers(0, 4, size=100).astype(np.uint8)
    return np.concatenate([unit, unit]), None, 9


def _family(rng):
    """A 90 bp element in 8 copies, every fourth inverted and the last
    one truncated, in random sequence: rows 8 slots wide (a weight-13
    seed and few copies keep the distinct multiplicities, and so the JAX
    package's compiles, few)."""
    elem = rng.integers(0, 4, size=90).astype(np.uint8)
    parts = []
    for k in range(8):
        e = elem[:60] if k == 7 else elem
        parts += [rng.integers(0, 4, size=int(rng.integers(20, 60)))
                  .astype(np.uint8), e if k % 4 else (3 - e)[::-1]]
    return np.concatenate(parts), None, 13


@pytest.mark.parametrize("case", [_direct, _inverted, _tandem, _family])
def test_find_repeats_and_list_equal_jax(case):
    s, min_length, weight = case(np.random.default_rng(0))
    text = _to_str(s)
    seed = jseeds.get_seed(weight, 0)
    want = jrep.find_repeats(text, seed=seed, min_length=min_length)
    got = repeats.find_repeats(text, seed=seed, min_length=min_length,
                               device="cpu")
    assert len(got) > 0
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.multiplicity(), want.multiplicity())
    bufs = [io.StringIO(), io.StringIO()]
    jrep.write_repeat_list(bufs[0], want, "test.fa", len(s))
    repeats.write_repeat_list(bufs[1], got, "test.fa", len(s))
    assert bufs[1].getvalue() == bufs[0].getvalue()


def test_find_repeats_default_seed_and_empty():
    rng = np.random.default_rng(4)
    s = _to_str(rng.integers(0, 4, size=400).astype(np.uint8))
    for text in (s, s + s[:150]):
        want = jrep.find_repeats(text)
        got = repeats.find_repeats(text, device="cpu")
        np.testing.assert_array_equal(got.starts, want.starts)
        np.testing.assert_array_equal(got.lengths, want.lengths)
