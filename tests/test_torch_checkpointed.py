"""Port parity: the resumable multi-MUM search (find_mums_checkpointed)
against the JAX package: results, the state files after every range
byte for byte, and states that resume across the two packages."""

import json
import os

import numpy as np
import pytest
import torch

from libmems_tpu import matchfind as jmatchfind
from libmems_tpu.sequence import Genome as JaxGenome
from libmems_tpu_torch import matchfind, seeds
from libmems_tpu_torch.match import MatchArray, write_match_list
from libmems_tpu_torch.sequence import Genome


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ALPHA = np.array(list("ACGT"))


def _pair(rng, n, rate=0.01):
    a = "".join(rng.choice(ALPHA, n))
    chars = np.array(list(a))
    idx = rng.random(n) < rate
    chars[idx] = rng.choice(ALPHA, size=int(idx.sum()))
    return a, "".join(chars)


def _torch_pair(a, b):
    return [Genome.from_string(a, name="a"), Genome.from_string(b, name="b")]


def _jax_pair(a, b):
    return [JaxGenome.from_string(a, name="a"),
            JaxGenome.from_string(b, name="b")]


def _find_mums(a, b, seed):
    return matchfind.find_mums(_torch_pair(a, b), seed=seed, device="cpu")


@pytest.fixture
def snapshots(monkeypatch):
    """Every state file as os.replace puts it in place: [(name, bytes)]."""
    seen = []
    real = os.replace

    def spy(src, dst):
        real(src, dst)
        with open(dst, "rb") as fh:
            seen.append((os.path.basename(dst), fh.read()))
    monkeypatch.setattr(os, "replace", spy)
    return seen


def _files(state):
    out = {}
    for ext in (".json", ".matches"):
        with open(state + ext, "rb") as fh:
            out[ext] = fh.read()
    return out


def test_checkpointed_matches_find_mums(tmp_path):
    a, b = _pair(np.random.default_rng(11), 4000)
    seed = seeds.get_seed(9, 0)
    want = _find_mums(a, b, seed)
    state = str(tmp_path / "st")
    got = matchfind.find_mums_checkpointed(_torch_pair(a, b), state,
                                           seed=seed, n_chunks=4,
                                           device="cpu")
    assert got.key_set() == want.key_set()
    ref = jmatchfind.find_mums(_jax_pair(a, b), seed=seed)
    assert got.key_set() == ref.key_set()
    with open(state + ".json") as fh:
        assert json.load(fh)["next_chunk"] == 4
    # a completed state returns its list without searching
    again = matchfind.find_mums_checkpointed(_torch_pair(a, b), state,
                                             seed=seed, n_chunks=4,
                                             device="cpu")
    assert again.key_set() == want.key_set()


def test_checkpointed_resumes_midway(tmp_path):
    a, b = _pair(np.random.default_rng(13), 4000)
    seed = seeds.get_seed(9, 0)
    want = _find_mums(a, b, seed)
    state = str(tmp_path / "st")
    gs = _torch_pair(a, b)
    matchfind.find_mums_checkpointed(gs, state, seed=seed, n_chunks=4,
                                     device="cpu")
    with open(state + ".json") as fh:
        meta = json.load(fh)
    meta["next_chunk"] = 2
    with open(state + ".json", "w") as fh:
        json.dump(meta, fh)
    # ranges 0..1's matches come only from the (now empty) persisted list
    write_match_list(state + ".matches", MatchArray.empty(2),
                     ["null", "null"], [4000, 4000])
    got = matchfind.find_mums_checkpointed(gs, state, seed=seed, n_chunks=4,
                                           device="cpu")
    assert got.key_set() <= want.key_set()
    os.remove(state + ".json")
    os.remove(state + ".matches")
    got_full = matchfind.find_mums_checkpointed(gs, state, seed=seed,
                                                n_chunks=4, device="cpu")
    assert got_full.key_set() == want.key_set()


@pytest.mark.parametrize("change", ["seed", "n_chunks", "total_windows"])
def test_checkpointed_stale_state_restarts(tmp_path, change):
    a, b = _pair(np.random.default_rng(17), 3000)
    state = str(tmp_path / "st")
    s9, s11 = seeds.get_seed(9, 0), seeds.get_seed(11, 0)
    matchfind.find_mums_checkpointed(_torch_pair(a, b), state, seed=s9,
                                     n_chunks=2, device="cpu")
    kw = dict(seed=s9, n_chunks=2)
    gs = _torch_pair(a, b)
    if change == "seed":
        kw["seed"] = s11
    elif change == "n_chunks":
        kw["n_chunks"] = 3
    else:
        b = b[:-100]
        gs = _torch_pair(a, b)
    # the stale state is ignored, not mixed in
    got = matchfind.find_mums_checkpointed(gs, state, device="cpu", **kw)
    assert got.key_set() == _find_mums(a, b, kw["seed"]).key_set()
    with open(state + ".json") as fh:
        assert json.load(fh)["n_chunks"] == kw["n_chunks"]


def test_state_files_equal_jax_after_every_range(tmp_path, snapshots):
    """The .matches and .json files after each of the 4 ranges are the
    JAX package's byte for byte (so the cut points are too)."""
    a, b = _pair(np.random.default_rng(19), 4000)
    seed = seeds.get_seed(9, 0)
    got = matchfind.find_mums_checkpointed(
        _torch_pair(a, b), str(tmp_path / "t"), seed=seed, n_chunks=4,
        device="cpu")
    mine = list(snapshots)
    snapshots.clear()
    ref = jmatchfind.find_mums_checkpointed(
        _jax_pair(a, b), str(tmp_path / "j"), seed=seed, n_chunks=4)
    assert got.key_set() == ref.key_set()
    assert len(mine) == 8
    assert [(n.replace("t.", "j.", 1), d) for n, d in mine] == snapshots
    # the ranges found matches at different steps
    assert len({d for n, d in mine if n.endswith(".matches")}) > 2


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_state_resumes_across_packages(tmp_path, snapshots, writer):
    """A state written by one package after range 2 of 4 resumes in the
    other: the result equals find_mums and the final files equal an
    uninterrupted run's."""
    a, b = _pair(np.random.default_rng(23), 4000)
    seed = seeds.get_seed(9, 0)
    whole = str(tmp_path / "whole")
    if writer == "jax":
        jmatchfind.find_mums_checkpointed(_jax_pair(a, b), whole, seed=seed,
                                          n_chunks=4)
    else:
        matchfind.find_mums_checkpointed(_torch_pair(a, b), whole,
                                         seed=seed, n_chunks=4, device="cpu")
    final = _files(whole)
    # the state after two ranges: the third and fourth snapshots
    state = str(tmp_path / "mid")
    for name, data in snapshots[2:4]:
        with open(state + os.path.splitext(name)[1], "wb") as fh:
            fh.write(data)
    with open(state + ".json") as fh:
        assert json.load(fh)["next_chunk"] == 2
    if writer == "jax":
        got = matchfind.find_mums_checkpointed(_torch_pair(a, b), state,
                                               seed=seed, n_chunks=4,
                                               device="cpu")
        want = _find_mums(a, b, seed)
    else:
        got = jmatchfind.find_mums_checkpointed(_jax_pair(a, b), state,
                                                seed=seed, n_chunks=4)
        want = jmatchfind.find_mums(_jax_pair(a, b), seed=seed)
    assert got.key_set() == want.key_set()
    assert _files(state) == final
