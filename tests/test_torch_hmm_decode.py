"""Port parity: Viterbi decoding (K20's plain version) and Baum-Welch
(K21's plain version, the host loop) against the JAX package's f64
functions, on the cases of tests/test_hmm_decode.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu.ops import hmm as jhmm
from libmems_tpu_torch.ops import hmm


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params_equal(got, want, rtol):
    for name in ("start_homologous", "go_homologous", "go_unrelated",
                 "go_stop_from_homologous", "go_stop_from_unrelated"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=rtol, atol=0)
    for name in ("emit_homologous", "emit_unrelated"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=rtol, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_equals_jax(seed):
    rng = np.random.default_rng(seed)
    p = jhmm.hoxd_params()
    seqs = [rng.integers(0, 8, size=n).astype(np.uint8)
            for n in (1, 3, 7, 11, 0, 70)]
    got = hmm.viterbi_homologous(seqs, p, device="cpu")
    want = jhmm.viterbi_homologous(seqs, p)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_viterbi_long_runs_equal_jax():
    """Identity and gap-extend runs, and a mixed corpus of ragged lengths
    under GC-adapted parameters (both decode states reached)."""
    rng = np.random.default_rng(5)
    p = jhmm.adapted_hoxd_params(0.45)
    ident = np.zeros(200, np.uint8)
    gaps = np.full(200, 7, np.uint8)
    mixed = np.concatenate([rng.integers(0, 2, 150),
                            rng.choice(8, 120, p=p.emit_unrelated),
                            rng.integers(0, 2, 90)]).astype(np.uint8)
    seqs = [ident, gaps, mixed, mixed[:97]]
    got = hmm.viterbi_homologous(seqs, p, device="cpu")
    want = jhmm.viterbi_homologous(seqs, p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].all() and not got[1][50:].any()
    assert got[2].any() and not got[2].all()


def test_viterbi_path_plain_equals_jax_kernel_function():
    """The padded-batch function against _viterbi_path: equal on every
    column below each row's length, False past it."""
    rng = np.random.default_rng(8)
    B, T = 5, 64
    obs = rng.integers(0, 8, (B, T)).astype(np.uint8)
    lens = np.array([64, 1, 33, 63, 2], np.int32)
    p = jhmm.adapted_hoxd_params(0.5)
    want = np.asarray(jhmm._viterbi_path(
        jnp.asarray(obs), jnp.asarray(lens),
        *(jnp.asarray(x) for x in jhmm._log_matrices(p))))
    got = hmm.viterbi_path(torch.from_numpy(obs), torch.from_numpy(lens),
                           hmm.log_matrices(p, "cpu")).numpy()
    valid = np.arange(T)[None, :] < lens[:, None]
    np.testing.assert_array_equal(got[valid], want[valid])
    assert not got[~valid].any()


def _decode_corpus(rng, p):
    """Rows of lengths 1, 15-17, 63-65 and longer, a tie-heavy row (a
    repeating four-symbol unit) and the rows of
    test_viterbi_long_runs_equal_jax."""
    seqs = [rng.integers(0, 8, n).astype(np.uint8)
            for n in (1, 15, 16, 17, 63, 64, 65, 200, 1000)]
    seqs.append(np.tile(np.array([0, 6, 7, 2], np.uint8), 50))
    mixed = np.concatenate([rng.integers(0, 2, 150),
                            rng.choice(8, 120, p=p.emit_unrelated),
                            rng.integers(0, 2, 90)]).astype(np.uint8)
    seqs += [np.zeros(200, np.uint8), np.full(200, 7, np.uint8), mixed,
             mixed[:97]]
    return seqs


@pytest.mark.parametrize("tied", [False, True])
def test_viterbi_ragged_plain_equals_jax_rows(tied):
    """viterbi_ragged's plain version over pack_ragged's layout (rows
    longest first, 16-byte aligned offsets) against _viterbi_path on each
    row alone: equal on every column of a row, False between rows.  With
    `tied`, transitions and emissions equal in both states, so every
    column's candidates tie and the first argmax decides."""
    rng = np.random.default_rng(12)
    p = jhmm.adapted_hoxd_params(0.45)
    seqs = _decode_corpus(rng, p)
    if tied:
        p = jhmm.HmmParams(0.5, 0.25, 0.25, 0.5, 0.5, np.full(8, 1 / 8),
                           np.full(8, 1 / 8))
    jm = [jnp.asarray(x) for x in jhmm._log_matrices(p)]
    mats = hmm.log_matrices(p, "cpu")
    batches = list(hmm.pack_ragged(seqs, list(range(len(seqs)))))
    assert len(batches) == 1
    batch = batches[0]
    obs, offsets, lengths = batch.tensors("cpu")
    got = hmm.viterbi_ragged(obs, offsets, lengths, mats).numpy()
    inside = np.zeros(len(got), bool)
    for i, o in zip(batch.rows, batch.offsets.tolist()):
        n = len(seqs[i])
        T = hmm.padded_width(n)
        row = np.zeros((1, T), np.uint8)
        row[0, :n] = seqs[i]
        want = np.asarray(jhmm._viterbi_path(
            jnp.asarray(row), jnp.asarray([n], jnp.int32), *jm))[0, :n]
        np.testing.assert_array_equal(got[o:o + n], want)
        inside[o:o + n] = True
    assert not got[~inside].any()
    if tied:
        assert got[inside].all()


@pytest.mark.parametrize("iterations", [1, 6])
def test_baum_welch_equals_jax(iterations):
    """tests/test_hmm_decode.py's corpus (5 + 3 sequences) and one of 5
    sequences, whose batch has 3 padding rows (5 -> Bp 8): fitted
    parameters and log-likelihoods within 1e-9 relative."""
    rng = np.random.default_rng(3)
    p0 = jhmm.hoxd_params()
    corpus = [rng.choice(8, size=120, p=p0.emit_homologous)
              .astype(np.uint8) for _ in range(5)]
    corpus += [rng.choice(8, size=37, p=p0.emit_unrelated)
               .astype(np.uint8) for _ in range(3)]
    for seqs in (corpus, corpus[3:]):
        got, got_ll = hmm.baum_welch(seqs, p0, iterations=iterations,
                                     device="cpu")
        want, want_ll = jhmm.baum_welch(seqs, p0, iterations=iterations)
        assert len(got_ll) == iterations
        np.testing.assert_allclose(got_ll, want_ll, rtol=1e-9, atol=0)
        _params_equal(got, want, 1e-9)


def test_bw_counts_plain_equals_jax_counts():
    """Per-sequence counts summed in index order against _bw_counts on a
    ragged batch."""
    rng = np.random.default_rng(6)
    B, T = 4, 64
    obs = rng.integers(0, 8, (B, T)).astype(np.uint8)
    lens = np.array([64, 1, 40, 2], np.int32)
    p = jhmm.adapted_hoxd_params(0.4)
    want = [np.asarray(x) for x in jhmm._bw_counts(
        jnp.asarray(obs), jnp.asarray(lens),
        *(jnp.asarray(x) for x in jhmm._log_matrices(p)))]
    part = hmm.bw_counts(torch.from_numpy(obs), torch.from_numpy(lens),
                         hmm.log_matrices(p, "cpu"))
    assert part.shape == (B, hmm.BW_COUNTS)
    got = hmm.sum_counts(part.numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-300)


def test_baum_welch_empty_corpus():
    p0 = jhmm.hoxd_params()
    got, lls = hmm.baum_welch([np.zeros(0, np.uint8)], p0, device="cpu")
    assert lls == []
    _params_equal(got, p0, 0)
