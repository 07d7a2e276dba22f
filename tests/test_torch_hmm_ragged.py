"""K8's sequential route as one ragged launch a call: the plan
(plan_launches: which rows take which route, the rows longest first,
the column budget) and the ragged plain version, held to
fb_sequential_plain and to the JAX package's predict_homologous and
posterior_homologous."""

import numpy as np
import pytest
import torch

from libmems_tpu.ops import hmm as jhmm
from libmems_tpu_torch.ops import hmm

# lengths around the 16-symbol groups and the 64-column bucket, shuffled
MIXED = (0, 1, 2, 15, 16, 17, 63, 64, 65, 1_000, 4_097)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _columns(rng, n, gc):
    """Encoded columns: homologous stretches (identity symbols, a few
    substitutions and gaps) alternating with unrelated ones."""
    eu = jhmm.adapted_hoxd_params(gc).emit_unrelated
    out = np.empty(n, np.uint8)
    pos, homologous = 0, True
    while pos < n:
        m = min(int(rng.integers(max(n // 8, 4), max(n // 3, 8))), n - pos)
        if homologous:
            s = rng.integers(0, 2, m).astype(np.uint8)
            sub = rng.random(m) < 0.02
            s[sub] = rng.integers(2, 8, int(sub.sum()))
        else:
            s = rng.choice(8, size=m, p=eu).astype(np.uint8)
        out[pos:pos + m] = s
        pos += m
        homologous = not homologous
    return out


def _mixed(seed, gc):
    rng = np.random.default_rng(seed)
    lens = list(MIXED)
    rng.shuffle(lens)
    return [_columns(rng, n, gc) for n in lens]


def _alone(seq, mats, threshold=0.9):
    """fb_sequential_plain on the sequence alone, padded to its width."""
    T = hmm.padded_width(len(seq))
    obs = np.zeros((1, T), np.uint8)
    obs[0, :len(seq)] = seq
    p, c = hmm.fb_sequential_plain(torch.from_numpy(obs),
                                   torch.tensor([len(seq)], dtype=torch.int32),
                                   mats, threshold)
    return p[0, :len(seq)], c[0, :len(seq)]


@pytest.mark.parametrize("gc", [0.38, 0.5, 0.61])
def test_ragged_plain_equals_sequential_plain_and_jax(gc):
    """One launch holds every row, longest first, at 16-byte offsets; the
    ragged plain version gives each row fb_sequential_plain's bits, and
    the entry points give the JAX package's calls and posteriors."""
    seqs = _mixed(int(gc * 100), gc)
    params = hmm.adapted_hoxd_params(gc)
    mats = hmm.log_matrices(params, "cpu")
    ragged, padded = hmm.plan_launches(seqs)
    assert padded == [] and len(ragged) == 1
    batch = ragged[0]
    lens = [len(seqs[i]) for i in batch.rows]
    assert sorted(batch.rows) == [i for i, s in enumerate(seqs) if len(s)]
    assert lens == sorted(lens, reverse=True)
    assert list(batch.lengths) == lens
    assert all(o % hmm.FB_ROW_ALIGN == 0 for o in batch.offsets)
    assert batch.start % hmm.FB_ROW_ALIGN == 0
    obs, offsets, lengths = batch.tensors("cpu")
    post, calls = hmm.fb_ragged(obs, offsets, lengths, mats, 0.9)
    covered = torch.zeros(batch.total, dtype=torch.bool)
    for i, o in zip(batch.rows, batch.offsets.tolist()):
        n = len(seqs[i])
        assert np.array_equal(obs[o:o + n].numpy(), seqs[i])
        rp, rc = _alone(seqs[i], mats)
        assert torch.equal(post[o:o + n], rp)
        assert torch.equal(calls[o:o + n], rc)
        covered[o:o + n] = True
    assert not post[~covered].any() and not calls[~covered].any()
    ref_calls = jhmm.predict_homologous(seqs, jhmm.adapted_hoxd_params(gc))
    ref_post = jhmm.posterior_homologous(seqs, jhmm.adapted_hoxd_params(gc))
    got_calls = hmm.predict_homologous(seqs, params, device="cpu")
    got_post = hmm.posterior_homologous(seqs, params, device="cpu")
    for s, r, g, rp, gp in zip(seqs, ref_calls, got_calls, ref_post,
                               got_post):
        assert len(g) == len(gp) == len(s)
        np.testing.assert_array_equal(g, r)
        # XLA's and PyTorch's exp and log differ in the last bit
        np.testing.assert_allclose(gp, rp, rtol=0, atol=1e-15)
        if len(s):
            np.testing.assert_array_equal(gp, _alone(s, mats)[0].numpy())
    assert any(0 < c.mean() < 1 for c in got_calls if len(c) > 100)


def test_route_split_follows_pack_batches(monkeypatch):
    """With the chunked route's threshold lowered, the rows padded to it
    or wider keep pack_batches' padded launches exactly, the others go
    into the ragged launch, and each row gets its route's bits."""
    monkeypatch.setattr(hmm, "FB_SCAN_MIN_T", 128)
    seqs = _mixed(7, 0.45) + _mixed(8, 0.45)
    params = hmm.adapted_hoxd_params(0.45)
    mats = hmm.log_matrices(params, "cpu")
    ragged, padded = hmm.plan_launches(seqs)
    wide = [(p, o, n) for p, o, n in hmm.pack_batches(seqs)
            if o.shape[1] >= 128]
    assert len(padded) == len(wide) == 3
    for (p, o, n), (wp, wo, wn) in zip(padded, wide):
        assert p == wp and np.array_equal(o, wo) and np.array_equal(n, wn)
    (batch,) = ragged
    assert sorted(batch.rows) == sorted(
        i for i, s in enumerate(seqs) if 0 < len(s) <= 64)
    got = hmm.posterior_homologous(seqs, params, device="cpu")
    calls = hmm.predict_homologous(seqs, params, device="cpu")
    for p, obs, lens in wide:
        rp, rc = hmm.fb_scan_plain(torch.from_numpy(obs),
                                   torch.from_numpy(lens), mats, 0.9)
        for r, i in enumerate(p):
            n = len(seqs[i])
            np.testing.assert_array_equal(got[i], rp[r, :n].numpy())
            np.testing.assert_array_equal(calls[i], rc[r, :n].numpy())
    for i in batch.rows:
        rp, rc = _alone(seqs[i], mats)
        np.testing.assert_array_equal(got[i], rp.numpy())
        np.testing.assert_array_equal(calls[i], rc.numpy())


def test_budget_splits_longest_first(monkeypatch):
    """A column budget below the call's columns cuts the ragged rows into
    launches in length order (a row alone may exceed it); the outputs do
    not change."""
    seqs = _mixed(11, 0.5)
    params = hmm.adapted_hoxd_params(0.5)
    whole = hmm.posterior_homologous(seqs, params, device="cpu")
    whole_calls = hmm.predict_homologous(seqs, params, device="cpu")
    monkeypatch.setattr(hmm, "FB_MAX_ELEMS", 1_100)
    ragged, padded = hmm.plan_launches(seqs)
    assert padded == []
    assert [[len(seqs[i]) for i in b.rows] for b in ragged] == \
        [[4_097], [1_000, 65], [64, 63, 17, 16, 15, 2, 1]]
    assert [b.total for b in ragged] == [4_112, 1_088, 224]
    split = hmm.posterior_homologous(seqs, params, device="cpu")
    split_calls = hmm.predict_homologous(seqs, params, device="cpu")
    for a, b, c, d in zip(whole, split, whole_calls, split_calls):
        assert np.array_equal(a, b) and np.array_equal(c, d)


def test_ragged_ties_keep_index_order_and_empty_call():
    """Rows of equal length keep their index order; a call of empty
    sequences makes no launch and returns empty arrays."""
    rng = np.random.default_rng(3)
    seqs = [_columns(rng, n, 0.5) for n in (40, 300, 40, 0, 300, 40)]
    (batch,), _ = hmm.plan_launches(seqs)
    assert batch.rows == [1, 4, 0, 2, 5]
    assert hmm.plan_launches([np.zeros(0, np.uint8)] * 3) == ([], [])
    out = hmm.predict_homologous([np.zeros(0, np.uint8)] * 2, device="cpu")
    assert [len(x) for x in out] == [0, 0]
