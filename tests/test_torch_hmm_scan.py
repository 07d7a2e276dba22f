"""Port parity: the chunked f64 scan of the homology HMM (K8's and K21's
route from a padded width of FB_SCAN_MIN_T on) against an 80-bit run of
the recurrence, the JAX package's f64 scans and the port's sequential
route, which serves every narrower width unchanged."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu.ops import hmm as jhmm
from libmems_tpu_torch.ops import hmm
from tests.test_torch_hmm import _columns


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_LONG = (1 << 17) + 5
K = hmm.FB_SCAN_COLS


def _pad(seqs, T):
    obs = np.zeros((len(seqs), T), np.uint8)
    for r, s in enumerate(seqs):
        obs[r, :len(s)] = s
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    return torch.from_numpy(obs), lens


def _posterior_80bit(obs, params):
    """The sequential recurrence of K8 in 80-bit np.longdouble scalars."""
    ls, lt, lstop, le = (np.asarray(x, np.longdouble)
                         for x in jhmm._log_matrices(params))

    def lse(a, b):
        m = max(a, b)
        return np.log(np.exp(a - m) + np.exp(b - m)) + m

    n = len(obs)
    F0 = np.empty(n, np.longdouble)
    f0, f1 = ls[0] + le[0, obs[0]], ls[1] + le[1, obs[0]]
    F0[0] = f0
    for i in range(1, n):
        s = obs[i]
        f0, f1 = (lse(f0 + lt[0, 0], f1 + lt[1, 0]) + le[0, s],
                  lse(f0 + lt[0, 1], f1 + lt[1, 1]) + le[1, s])
        F0[i] = f0
    logp = lse(f0 + lstop[0], f1 + lstop[1])
    post = np.empty(n, np.longdouble)
    b0, b1 = lstop
    post[n - 1] = np.exp(F0[n - 1] + b0 - logp)
    for i in range(n - 2, -1, -1):
        s = obs[i + 1]
        t0, t1 = le[0, s] + b0, le[1, s] + b1
        b0, b1 = (lse(lt[0, 0] + t0, lt[0, 1] + t1),
                  lse(lt[1, 0] + t0, lt[1, 1] + t1))
        post[i] = np.exp(F0[i] + b0 - logp)
    return post


@pytest.fixture(scope="module")
def long_case():
    """tests/test_torch_hmm.py's seeded 2^17 + 5 columns: the port's
    posterior (padded width 2^18: the chunked route), the 80-bit
    reference and the JAX package's f64 checkpointed scan."""
    rng = np.random.default_rng(17)
    params = jhmm.adapted_hoxd_params(0.5)
    obs = _columns(rng, N_LONG, block=20_000)
    post = hmm.posterior_homologous([obs], params, device="cpu")[0]
    Tp = (1 << 17) + 4096
    obs_p = np.zeros((1, Tp), np.int32)
    obs_p[0, :N_LONG] = obs
    jm = [jnp.asarray(x) for x in jhmm._log_matrices(params)]
    ref64 = np.asarray(jhmm._fb_posterior_ckpt(
        jnp.asarray(obs_p), jnp.asarray(np.array([N_LONG], np.int32)), *jm,
        1024))[0, :N_LONG]
    return {"obs": obs, "params": params, "post": post, "ref64": ref64,
            "ref80": _posterior_80bit(obs, params)}


def test_scan_constants_match_kernel_source():
    src = (Path(hmm.__file__).parent.parent / "csrc" / "hmm.cu").read_text()
    cols = re.search(r"constexpr int kScanCols = (\d+);", src)
    min_t = re.search(r"constexpr int kScanMinT = 1 << (\d+);", src)
    threads = re.search(r"constexpr int kScanThreads = (\d+);", src)
    assert int(cols.group(1)) == hmm.FB_SCAN_COLS
    assert 1 << int(min_t.group(1)) == hmm.FB_SCAN_MIN_T
    assert int(threads.group(1)) * hmm.FB_SCAN_COLS == hmm.FB_SCAN_BLOCK_COLS
    assert hmm.FB_SCAN_MIN_T == jhmm._FB_ASSOC_MIN_T


def test_scan_route_within_1e9_of_80bit_and_closer_than_jax_f64(long_case):
    post, ref80 = long_case["post"], long_case["ref80"]
    err = float(np.abs(post - ref80).max())
    jax_err = float(np.abs(long_case["ref64"] - ref80).max())
    assert err <= 1e-9
    assert err < jax_err


def test_scan_route_within_1e6_of_jax_f64_scan(long_case):
    post, ref64 = long_case["post"], long_case["ref64"]
    np.testing.assert_allclose(post, ref64, rtol=0, atol=1e-6)
    calls = hmm.predict_homologous([long_case["obs"]], long_case["params"],
                                   device="cpu")[0]
    sure = np.abs(post - 0.9) > 1e-6
    np.testing.assert_array_equal(calls[sure], ref64[sure] >= 0.9)
    np.testing.assert_array_equal(calls, post >= 0.9)
    assert 0.2 < calls.mean() < 0.8


def test_mixed_batch_short_rows_take_the_sequential_route(long_case):
    """Rows padded below 2^17 get the sequential route's bits; the row
    padded to 2^18 gets the chunked route's, which differ from them."""
    rng = np.random.default_rng(23)
    params = long_case["params"]
    seqs = [_columns(rng, n, block=max(n // 5, 4))
            for n in (1, 100, 3_000)] + [long_case["obs"]]
    posts = hmm.posterior_homologous(seqs, params, device="cpu")
    calls = hmm.predict_homologous(seqs, params, device="cpu")
    mats = hmm.log_matrices(params, "cpu")
    for s, p, c in zip(seqs[:-1], posts, calls):
        T = max(64, 1 << (len(s) - 1).bit_length())
        assert T < hmm.FB_SCAN_MIN_T
        rp, rc = hmm.fb_sequential_plain(*_pad([s], T), mats, 0.9)
        assert torch.equal(torch.from_numpy(p), rp[0, :len(s)])
        assert torch.equal(torch.from_numpy(c), rc[0, :len(s)])
    assert np.array_equal(posts[-1], long_case["post"])
    obs, lens = _pad(seqs[2:3], 1 << 12)
    assert torch.equal(hmm.bw_counts_plain(obs, lens, mats),
                       hmm.bw_sequential_plain(obs, lens, mats))


def test_scan_output_independent_of_batch_and_launch_split(monkeypatch):
    """Length 1, a length ending on a chunk boundary and one past it, and
    a long row, padded to 2^17: each alone gives the bits it gets in the
    ragged batch, for K8 and K21; splitting a 2^17 bucket into launches
    changes nothing."""
    rng = np.random.default_rng(29)
    params = hmm.adapted_hoxd_params(0.45)
    mats = hmm.log_matrices(params, "cpu")
    seqs = [_columns(rng, n, block=max(n // 5, 4))
            for n in (1, 37 * K, 37 * K + 1, 100_000)]
    obs, lens = _pad(seqs, hmm.FB_SCAN_MIN_T)
    post, calls = hmm.fb_posterior_plain(obs, lens, mats, 0.9)
    counts = hmm.bw_counts_plain(obs, lens, mats)
    for r in range(len(seqs)):
        p, c = hmm.fb_posterior_plain(obs[r:r + 1], lens[r:r + 1], mats, 0.9)
        assert torch.equal(p[0], post[r]) and torch.equal(c[0], calls[r])
        assert torch.equal(hmm.bw_counts_plain(obs[r:r + 1], lens[r:r + 1],
                                               mats)[0], counts[r])
    bucket = [seqs[3], _columns(rng, 70_000, block=9_000),
              _columns(rng, 1 << 17, block=9_000)]
    whole = hmm.posterior_homologous(bucket, params, device="cpu")
    monkeypatch.setattr(hmm, "FB_MAX_ELEMS", 2 * hmm.FB_SCAN_MIN_T)
    assert len(list(hmm.pack_batches(bucket))) == 2
    split = hmm.posterior_homologous(bucket, params, device="cpu")
    for a, b in zip(whole, split):
        assert np.array_equal(a, b)
    assert np.array_equal(whole[0], post[3, :100_000].numpy())


def test_bw_scan_counts_equal_jax_at_long_length(long_case):
    """K21's chunked counts within 1e-6 relative of the JAX package's f64
    _bw_counts; its summed H-state emission counts equal the sum of K8's
    chunked posteriors within 1e-12 relative."""
    obs, params = long_case["obs"], long_case["params"]
    o, lens = _pad([obs], 1 << 18)
    part = hmm.bw_counts_plain(o, lens, hmm.log_matrices(params, "cpu"))
    got = hmm.sum_counts(part.numpy())
    jm = [jnp.asarray(x) for x in jhmm._log_matrices(params)]
    want = [np.asarray(x) for x in jhmm._bw_counts(
        jnp.asarray(obs[None].astype(np.int32)),
        jnp.asarray(np.array([N_LONG], np.int32)), *jm)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    total = float(long_case["post"].sum())
    assert abs(float(got[2][0].sum()) - total) <= 1e-12 * total
