"""Port parity: the homology HMM (K8's plain version; its sequential
route below a padded width of 2^17) against the JAX package's f64 tiers
and its f32 associative tier."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu.ops import hmm as jhmm
from libmems_tpu_torch import convert
from libmems_tpu_torch.ops import hmm


def _columns(rng, n, block=2_000):
    """Encoded columns of a pairwise projection: homologous stretches
    (identity symbols, 1% substitutions, short gap runs) alternating
    with unrelated ones (symbols drawn from the unrelated emissions)."""
    eu = jhmm.adapted_hoxd_params(0.5).emit_unrelated
    out = np.empty(n, np.uint8)
    pos = 0
    homologous = True
    while pos < n:
        m = min(int(rng.integers(block // 2, 2 * block)), n - pos)
        if homologous:
            s = rng.integers(0, 2, m).astype(np.uint8)
            sub = rng.random(m) < 0.01
            s[sub] = rng.integers(2, 6, int(sub.sum()))
            for g in np.flatnonzero(rng.random(m) < 0.002):
                z = int(rng.integers(1, 6))
                s[g:g + z] = 7
                s[g] = 6
        else:
            s = rng.choice(8, size=m, p=eu).astype(np.uint8)
        out[pos:pos + m] = s
        pos += m
        homologous = not homologous
    return out


def _batch(rng, T, lens):
    obs = np.zeros((len(lens), T), np.uint8)
    for r, n in enumerate(lens):
        obs[r, :n] = _columns(rng, n, block=max(n // 6, 8))
    return obs, np.asarray(lens, np.int32)


def _mats(params):
    return [jnp.asarray(x) for x in jhmm._log_matrices(params)], \
        hmm.log_matrices(params, "cpu")


@pytest.mark.parametrize("T", [64, 4096, (1 << 14) + 3])
def test_plain_posterior_equals_jax_f64_tiers(T):
    rng = np.random.default_rng(T)
    params = jhmm.adapted_hoxd_params(0.47)
    jm, tm = _mats(params)
    lens = [T, max(T - 5, 1), max(T // 2, 1), 1]
    obs, lengths = _batch(rng, T, lens)
    post, calls = hmm.fb_posterior_plain(torch.from_numpy(obs),
                                         torch.from_numpy(lengths), tm, 0.9)
    post, calls = post.numpy(), calls.numpy()
    Tp = -(-T // 1024) * 1024 if T >= 1024 else T
    obs_p = np.zeros((len(lens), Tp), np.int32)
    obs_p[:, :T] = obs
    K = min(1024, Tp)
    refs = [np.asarray(jhmm._fb_posterior(jnp.asarray(obs), jnp.asarray(
                lengths), *jm)),
            np.asarray(jhmm._fb_posterior_ckpt(jnp.asarray(obs_p),
                                               jnp.asarray(lengths), *jm, K))]
    for ref in refs:
        for r, n in enumerate(lens):
            np.testing.assert_allclose(post[r, :n], ref[r, :n], rtol=0,
                                       atol=1e-9)
            np.testing.assert_array_equal(calls[r, :n], ref[r, :n] >= 0.9)
    assert 0.1 < calls[0, :lens[0]].mean() < 0.9 or T == 64


def test_long_sequence_f64_equals_jax_ckpt_tier_not_its_f32_tier():
    """At 2^17 columns and above the JAX package ran an f32 associative
    scan; the port stays f64 at every length.  Against the JAX package's
    f64 checkpointed scan on the same 2^17+5 columns the port's
    sequential route is exact to 1e-9 with equal calls.  At that width
    the port computes the chunked route (tests/test_torch_hmm_scan.py
    holds it to an 80-bit reference); against the f32 tier its calls
    agree away from the threshold (|post - 0.9| > 1e-3,
    tests/test_hmm_decode.py:115) except where that tier drops
    homologous calls from a 4096-column block boundary on (ROADMAP queue
    3): every such column has an f64 posterior >= 0.9 and they are a
    small share of the sequence."""
    rng = np.random.default_rng(17)
    T = (1 << 17) + 5
    params = jhmm.adapted_hoxd_params(0.5)
    jm, tm = _mats(params)
    obs = _columns(rng, T, block=20_000)
    batch = (torch.from_numpy(obs[None]), torch.tensor([T], dtype=torch.int32))
    post, calls = hmm.fb_sequential_plain(*batch, tm, 0.9)
    post, calls = post.numpy()[0], calls.numpy()[0]
    Tp = (1 << 17) + 4096     # a multiple of both tiers' blocks
    obs_p = np.zeros((1, Tp), np.int32)
    obs_p[0, :T] = obs
    lens = jnp.asarray(np.array([T], np.int32))
    ref64 = np.asarray(jhmm._fb_posterior_ckpt(jnp.asarray(obs_p), lens,
                                               *jm, 1024))[0, :T]
    np.testing.assert_allclose(post, ref64, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(calls, ref64 >= 0.9)
    post, calls = hmm.fb_posterior_plain(*batch, tm, 0.9)
    post, calls = post.numpy()[0], calls.numpy()[0]
    packed = np.asarray(jhmm._fb_calls_assoc(jnp.asarray(obs_p), lens, *jm,
                                             0.9))
    ref32 = np.unpackbits(packed, axis=1,
                          bitorder="little").astype(bool)[0, :T]
    sure = np.abs(post - 0.9) > 1e-3
    differ = sure & (calls != ref32)
    assert (calls[differ] & (post[differ] >= 0.9) & ~ref32[differ]).all()
    assert differ.mean() < 0.1
    assert 0.2 < calls.mean() < 0.8


def test_predict_homologous_equals_jax():
    """The bucketing front end: many lengths, several buckets, empty and
    length-1 sequences."""
    rng = np.random.default_rng(5)
    seqs = [_columns(rng, n, block=max(n // 4, 4))
            for n in (0, 1, 7, 64, 65, 300, 1000, 2500)]
    params = jhmm.hoxd_params()
    ref = jhmm.predict_homologous(seqs, params)
    got = hmm.predict_homologous(seqs, hmm.hoxd_params(), device="cpu")
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    post = hmm.posterior_homologous(seqs, params, device="cpu")
    ref_post = jhmm.posterior_homologous(seqs, params)
    for r, p in zip(ref_post, post):
        np.testing.assert_allclose(p, r, rtol=0, atol=1e-9)


@pytest.mark.parametrize("gc", [0.35, 0.5, 0.62])
def test_parameters_and_log_matrices_equal_jax(gc):
    params = jhmm.adapt_to_percent_identity(jhmm.adapted_hoxd_params(gc),
                                            0.93)
    mine = hmm.adapt_to_percent_identity(hmm.adapted_hoxd_params(gc), 0.93)
    np.testing.assert_array_equal(mine.emit_homologous,
                                  params.emit_homologous)
    np.testing.assert_array_equal(mine.emit_unrelated, params.emit_unrelated)
    ref = convert.hmm_matrices_from_reference(*jhmm._log_matrices(params),
                                              device="cpu")
    for r, g in zip(ref, hmm.log_matrices(mine, "cpu")):
        assert r.dtype == g.dtype == torch.float64
        assert torch.equal(r, g)
    np.testing.assert_array_equal(hmm.hoxd_params().emit_homologous,
                                  jhmm.hoxd_params().emit_homologous)
