"""Port parity: the pairwise Gotoh DP (K22 and K23's plain versions, the
walk K4's plain version) against the JAX package, on the cases of
tests/test_gapped.py: integer scores equal, gap masks byte-equal, on the
device-walk route and the checkpointed route; carries and pointer bytes
(packed and unpacked) equal the JAX arrays whole."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu.ops import gapped as jg
from libmems_tpu_torch.ops import gapped


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(seed, n, lo=5, hi=60):
    """tests/test_gapped.py:test_traceback_reaches_dp_score's pairs."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        la = int(rng.integers(lo, hi))
        lb = int(rng.integers(lo, hi))
        a = rng.integers(0, 4, la).astype(np.uint8)
        b = a[:lb].copy() if rng.random() < 0.5 else \
            rng.integers(0, 4, lb).astype(np.uint8)
        pairs.append((a, b))
    return pairs


def _affine_score(a, b, a_gaps, b_gaps):
    """tests/test_gapped.py:alignment_score."""
    score = 0
    ai = bi = 0
    prev_a = prev_b = False
    for ag, bg in zip(a_gaps, b_gaps):
        assert not (ag and bg)
        if ag:
            score += jg.GAP_EXTEND + (0 if prev_a else jg.GAP_OPEN)
            bi += 1
        elif bg:
            score += jg.GAP_EXTEND + (0 if prev_b else jg.GAP_OPEN)
            ai += 1
        else:
            score += int(jg.HOXD70[a[ai], b[bi]])
            ai += 1
            bi += 1
        prev_a, prev_b = bool(ag), bool(bg)
    assert ai == len(a) and bi == len(b)
    return score


@pytest.mark.parametrize("seed,la,lb", [(0, 20, 20), (1, 35, 28),
                                        (2, 10, 40), (3, 57, 60),
                                        (4, 1, 30), (5, 30, 1)])
def test_align_score_equals_jax(seed, la, lb):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, la).astype(np.uint8)
    b = rng.integers(0, 4, lb).astype(np.uint8)
    assert gapped.align_score(a, b, device="cpu") == jg.align_score(a, b)


def test_identical_sequences_score():
    a = np.random.default_rng(9).integers(0, 4, 50).astype(np.uint8)
    want = sum(int(jg.HOXD70[c, c]) for c in a)
    assert gapped.align_score(a, a, device="cpu") == want


@pytest.mark.parametrize("budget", [None, 0])
def test_align_pairs_equal_jax(monkeypatch, budget):
    """Both routes: the full pointer tensor walked by K4 (the default
    budget) and the checkpointed blocks walked on the host (budget 0),
    in both packages.  Masks are byte-equal and score to the DP score."""
    if budget is not None:
        monkeypatch.setattr(jg, "DEVICE_TB_BUDGET", budget)
        monkeypatch.setattr(gapped, "DEVICE_TB_BUDGET", budget)
    pairs = _pairs(10, 12)
    rng = np.random.default_rng(11)
    a = rng.integers(0, 4, 200).astype(np.uint8)
    b = a.copy()
    b[50] = (b[50] + 1) % 4                     # one substitution
    c = np.concatenate([a[:60], a[70:120]])     # a 10-base deletion
    pairs += [(a, b), (a[:120], c)]
    got = gapped.align_pairs(pairs, device="cpu")
    want = jg.align_pairs(pairs)
    for (x, y), (ga, gb), (wa, wb) in zip(pairs, got, want):
        assert ga.dtype == wa.dtype and gb.dtype == wb.dtype
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gb, wb)
        assert _affine_score(x, y, ga, gb) == \
            gapped.align_score(x, y, device="cpu")
    (ga, gb), (ca, cb) = got[-2], got[-1]
    assert not ga.any() and not gb.any()
    assert cb.sum() == 10 and not ca.any()


def test_carries_and_pointer_bytes_equal_jax():
    """K22's carries and K23's pointer bytes, packed and unpacked, from
    the first row and from a checkpoint, equal _gotoh_forward_ckpt,
    _gotoh_block_ptrs and pack_ptrs on one seeded batch (every row and
    column of the padded arrays, padding pairs included)."""
    rng = np.random.default_rng(21)
    B, M, N, K = 4, 64, 33, 32
    a = np.zeros((B, M), np.uint8)
    b = np.zeros((B, N), np.uint8)
    a_len = np.array([64, 40, 0, 17], np.int32)
    b_len = np.array([33, 30, 5, 0], np.int32)
    for r in range(B):
        a[r, :a_len[r]] = rng.integers(0, 4, a_len[r])
        b[r, :b_len[r]] = rng.integers(0, 4, b_len[r])
    b[1, :20] = a[1, 5:25]
    go, ge = jg.GAP_OPEN, jg.GAP_EXTEND
    js, jh, jf = (np.asarray(x) for x in jg._gotoh_forward_ckpt(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_len),
        jnp.asarray(b_len), go, ge, K))
    t = [torch.from_numpy(x) for x in (a, b, a_len, b_len)]
    score, ck_h, ck_f = gapped.gotoh_forward(*t, go, ge, K)
    np.testing.assert_array_equal(score.numpy(), js)
    np.testing.assert_array_equal(ck_h.numpy(), jh)
    np.testing.assert_array_equal(ck_f.numpy(), jf)
    assert score.dtype == torch.int32 and ck_h.dtype == torch.int32
    s_only, none_h, none_f = gapped.gotoh_forward(*t, go, ge, K,
                                                  carries=False)
    assert none_h is None and none_f is None
    np.testing.assert_array_equal(s_only.numpy(), js)

    h0, f0 = jg._gotoh_h0f0(B, N, go, ge)
    cases = [(None, None, h0, f0, 0, M), (ck_h[1], ck_f[1], jh[1], jf[1],
                                          K, 2 * K)]
    for th, tf, jh_, jf_, lo, hi in cases:
        want = np.asarray(jg._gotoh_block_ptrs(
            jnp.asarray(jh_), jnp.asarray(jf_), jnp.asarray(a[:, lo:hi]),
            jnp.asarray(b), jnp.asarray(b_len), go, ge))
        blk = torch.from_numpy(np.ascontiguousarray(a[:, lo:hi]))
        got = gapped.gotoh_block_ptrs(th, tf, blk, t[1], go, ge)
        np.testing.assert_array_equal(got.numpy(), want)
        packed = gapped.gotoh_block_ptrs(th, tf, blk, t[1], go, ge,
                                         packed=True)
        want_p = np.asarray(jg.pack_ptrs(jnp.asarray(want)))
        np.testing.assert_array_equal(packed.numpy(), want_p)
        np.testing.assert_array_equal(
            gapped.unpack_ptrs(packed.numpy(), N + 1), want)
        np.testing.assert_array_equal(
            gapped.unpack_ptrs(want_p, N + 1),
            jg.unpack_ptrs(want_p, N + 1))


def _padded_batch(B, n_pairs, M, N, rng_seed):
    """B rows of which the first n_pairs hold related pairs (pair 1 with
    an empty a, pair 2 with an empty b) and the rest are padding pairs
    (no a, no b), as plan_pairs pads a bucket."""
    rng = np.random.default_rng(rng_seed)
    a = np.zeros((B, M), np.uint8)
    b = np.zeros((B, N), np.uint8)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    for r in range(n_pairs):
        la = 0 if r == 1 else (M if r == 0 else int(rng.integers(1, M + 1)))
        lb = 0 if r == 2 else (N if r == 0 else int(rng.integers(1, N + 1)))
        x = rng.integers(0, 4, max(la, lb)).astype(np.uint8)
        y = x.copy()
        y[rng.random(len(y)) < 0.05] = rng.integers(0, 4)
        a[r, :la] = x[:la]
        b[r, :lb] = np.concatenate([y[:10], y[14:], y[:4]])[:lb]
        a_len[r], b_len[r] = la, lb
    return a, b, a_len, b_len


@pytest.mark.parametrize("N", [40, 33])
@pytest.mark.parametrize("first,G", [(0, 1), (2, 1), (0, 3), (1, 3),
                                     (0, 4)])
def test_block_ptrs_batch_equal_jax(first, G, N):
    """The batched K23's plain version against _gotoh_block_ptrs and
    pack_ptrs block by block: G = 1, 3 and all 4 blocks, from the first
    row (block 0, made from _gotoh_h0f0's row) and from checkpoints, with
    padding pairs, an empty a and an empty b; N + 1 odd (41) and even
    (34); packed and unpacked, every row and column."""
    B, M, K = 8, 64, 16
    a, b, a_len, b_len = _padded_batch(B, 4, M, N, 7 * N + first + G)
    go, ge = jg.GAP_OPEN, jg.GAP_EXTEND
    _, jh, jf = (np.asarray(x) for x in jg._gotoh_forward_ckpt(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_len),
        jnp.asarray(b_len), go, ge, K))
    t = [torch.from_numpy(x) for x in (a, b, a_len, b_len)]
    _, ck_h, ck_f = gapped.gotoh_forward(*t, go, ge, K)
    packed = gapped.gotoh_block_ptrs_batch(ck_h, ck_f, t[0], t[1], first, G,
                                           go, ge)
    full = gapped.gotoh_block_ptrs_batch(ck_h, ck_f, t[0], t[1], first, G,
                                         go, ge, packed=False)
    assert packed.shape == (G, B, K, (N + 2) // 2)
    assert full.shape == (G, B, K, N + 1)
    for k, bi in enumerate(range(first, first + G)):
        want = np.asarray(jg._gotoh_block_ptrs(
            jnp.asarray(jh[bi]), jnp.asarray(jf[bi]),
            jnp.asarray(a[:, bi * K:(bi + 1) * K]), jnp.asarray(b),
            jnp.asarray(b_len), go, ge))
        np.testing.assert_array_equal(full[k].numpy(), want)
        np.testing.assert_array_equal(packed[k].numpy(),
                                      np.asarray(jg.pack_ptrs(want)))


@pytest.mark.parametrize("share", [None, 1800])
def test_align_pairs_batched_fetch_equal_jax(monkeypatch, share):
    """align_pairs' checkpointed route with the batched fetch (the port's
    DEVICE_TB_BUDGET lowered to 0; the JAX package keeps its own): masks
    equal the JAX package's.  With PTR_BATCH_SHARE raised, a launch
    holds two blocks and the walk takes several; by default one launch
    holds every block the walk reads."""
    from libmems_tpu_torch.ops import profile
    monkeypatch.setattr(gapped, "DEVICE_TB_BUDGET", 0)
    if share is not None:
        monkeypatch.setattr(profile, "PTR_BATCH_SHARE", share)
    calls = []
    real = gapped.gotoh_block_ptrs_batch

    def counted(*args, **kw):
        calls.append(args[4:6])
        return real(*args, **kw)
    monkeypatch.setattr(gapped, "gotoh_block_ptrs_batch", counted)
    rng = np.random.default_rng(31)
    x = rng.integers(0, 4, 460).astype(np.uint8)
    y = x.copy()
    y[rng.random(460) < 0.04] = rng.integers(0, 4)
    # one bucket of 512 rows (four blocks of 128), the longest a in block 3
    pairs = [(x, np.concatenate([y[:100], y[112:]])), (x[:290], y[5:]),
             (x[:260], x[:270])] + _pairs(12, 3, 260, 500)
    got = gapped.align_pairs(pairs, device="cpu")
    want = jg.align_pairs(pairs)
    for (ga, gb), (wa, wb) in zip(got, want):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gb, wb)
    if share is None:
        assert calls == [(0, 4)]
    else:
        assert calls == [(2, 2), (0, 2)]


@pytest.mark.parametrize("B,M,C", [(8, 128, 26), (120, 128, 26),
                                   (8, 16_384, 26), (8, 1 << 20, 241)])
def test_gotoh_band_rows_hold_the_cap_with_pointers(B, M, C):
    """K23's rows a launch: 24 bytes a row at each of C - 1 block edges
    (three hand-off words), all M rows where they fit the cap, else the
    most that do, at least one."""
    from libmems_tpu_torch.ops import profile
    cap = profile.PTR_BUDGET // profile.SPAN_EDGE_SHARE
    per_row = 24 * B * (C - 1)
    rows = gapped.gotoh_band_rows(B, M, C, ptr=True)
    assert 1 <= rows <= M
    if per_row * M <= cap:
        assert rows == M
    else:
        assert per_row * rows <= cap or rows == 1
        assert per_row * (rows + 1) > cap


@pytest.mark.parametrize("B,M,N,K", [(3, 32, 70, 32), (4, 48, 100, 16),
                                     (3, 16, 543, 16), (2, 64, 33, 64),
                                     (3, 24, 0, 8)])
def test_forward_carries_at_strip_edges_equal_jax(B, M, N, K):
    """K22's plain version against _gotoh_forward_ckpt at the shapes K22's
    strips cut unevenly: N + 1 no multiple of 32 x K columns (71, 101)
    and one that is (544 = 32 x 17), M = K (one carry), no b at all (N =
    0); pair 1 has no a (a_len 0) and pair 2 no b (b_len 0).  Scores and
    carries equal, with carries and without."""
    rng = np.random.default_rng(B * M + N)
    a = rng.integers(0, 4, (B, M)).astype(np.uint8)
    b = rng.integers(0, 4, (B, N)).astype(np.uint8)
    a_len = rng.integers(0, M + 1, B).astype(np.int32)
    b_len = rng.integers(0, N + 1, B).astype(np.int32)
    a_len[0], b_len[0] = M, N
    a_len[1] = 0
    b_len[2 % B] = 0
    go, ge = jg.GAP_OPEN, jg.GAP_EXTEND
    want = [np.asarray(x) for x in jg._gotoh_forward_ckpt(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_len),
        jnp.asarray(b_len), go, ge, K)]
    t = [torch.from_numpy(x) for x in (a, b, a_len, b_len)]
    got = gapped.gotoh_forward(*t, go, ge, K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[1].shape == (M // K, B, N + 1)
    score = gapped.gotoh_forward(*t, go, ge, K, carries=False)[0]
    np.testing.assert_array_equal(score.numpy(), want[0])


@pytest.mark.parametrize("B,M,C", [(8, 16_384, 26), (8, 65_536, 16),
                                   (1, 1 << 20, 241), (3, 384, 1),
                                   (8, 256, 1 << 20)])
def test_gotoh_band_rows_hold_the_cap(B, M, C):
    """K22's rows a launch: all M where B pairs' hand-off columns (16
    bytes a row at each of C - 1 block edges) fit the span kernels' cap
    (phase 9's 8 x 16,384 rows in 26 blocks, one block a pair), else the
    most rows that do, at least one (a 1 Mbp pair, 8 pairs of 64 kbp)."""
    from libmems_tpu_torch.ops import profile
    cap = profile.PTR_BUDGET // profile.SPAN_EDGE_SHARE
    per_row = 16 * B * (C - 1)
    rows = gapped.gotoh_band_rows(B, M, C)
    assert 1 <= rows <= M
    if per_row * M <= cap:
        assert rows == M
    else:
        assert per_row * rows <= cap or rows == 1
        assert per_row * (rows + 1) > cap


def test_read_substitution_matrix_equals_jax():
    txt = ("#example matrix\n"
           "A C G T N\n"
           "A 91 -114 -31 -123 0\n"
           "C -114 100 -125 -31 0\n"
           "G -31 -125 100 -114 0\n"
           "T -123 -31 -114 91 0\n")
    got = gapped.read_substitution_matrix(io.StringIO(txt))
    want = jg.read_substitution_matrix(io.StringIO(txt))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gapped.HOXD70)
    with pytest.raises((ValueError, IndexError)):
        gapped.read_substitution_matrix(
            io.StringIO(txt.replace("A C G T N", "A C G T")))


def test_codes_outside_acgt_raise():
    a = np.array([0, 1, 4, 2], np.uint8)
    b = np.array([0, 1, 2], np.uint8)
    with pytest.raises(ValueError):
        gapped.align_score(a, b, device="cpu")
    with pytest.raises(ValueError):
        gapped.align_pairs([(b, b), (b, a)], device="cpu")


def test_entry_points_need_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    a = np.zeros(4, np.uint8)
    with pytest.raises(RuntimeError):
        gapped.align_score(a, a)
    with pytest.raises(RuntimeError):
        gapped.align_pairs([(a, a)])
