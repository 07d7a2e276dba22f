"""The port's public surface against the JAX package: the exported
names, find_mums_device's signature, and find_mums on 64 genomes (the
device pipeline, with signature words whose mask and sign fields span
words, and K2 at the full row width)."""

import inspect

import numpy as np
import pytest
import torch

import libmems_tpu
import libmems_tpu_torch
from libmems_tpu import matchfind as jmf
from libmems_tpu_torch import matchfind


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_exports_cover_the_reference():
    missing = set(libmems_tpu.__all__) - set(libmems_tpu_torch.__all__)
    assert not missing, sorted(missing)
    for name in libmems_tpu_torch.__all__:
        assert hasattr(libmems_tpu_torch, name), name
    assert {"write_match_list", "BackboneSegment"} <= \
        set(libmems_tpu_torch.__all__)


def test_find_mums_device_signature():
    """The JAX package's parameters in its order, with its defaults
    (`capacity` is accepted and ignored)."""
    want = inspect.signature(jmf.find_mums_device).parameters
    got = inspect.signature(matchfind.find_mums_device).parameters
    assert list(got) == list(want)
    for name in want:
        assert got[name].default == want[name].default, name
    assert list(got)[:3] == ["smls", "capacity", "extend_capacity"]
    assert libmems_tpu_torch.find_mums_device is matchfind.find_mums_device


def _family64(seed=5, n=64, length=1_500):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, length).astype(np.uint8)
    out = []
    for _ in range(n):
        s = base.copy()
        m = rng.random(length) < 0.01
        s[m] = rng.integers(0, 4, int(m.sum()))
        out.append("".join("ACGT"[x] for x in s))
    return out


def test_find_mums_64_genomes_equals_jax():
    """64 genomes: the port's device pipeline (K13-K15, K2 at 64 slots a
    row) gives the JAX package's matches; the capacity argument of
    find_mums_device changes nothing."""
    texts = _family64()
    want = jmf.find_mums([libmems_tpu.Genome.from_string(t) for t in texts])
    genomes = [libmems_tpu_torch.Genome.from_string(t) for t in texts]
    got = libmems_tpu_torch.find_mums(genomes, device="cpu")
    assert len(want) > 0 and got.starts.shape[1] == 64
    assert (got.multiplicity() > 62).any()
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.lengths, want.lengths)

    smls, _ = libmems_tpu_torch.create_smls(genomes[:3], device="cpu")
    a = matchfind.find_mums_device(smls)
    b = matchfind.find_mums_device(smls, 1 << 20)
    for x, y in zip(a[:3], b[:3]):
        assert (x == y).all()
