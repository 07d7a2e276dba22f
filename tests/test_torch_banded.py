"""Port parity: the banded profile DP (K10/K11's plain version, with the
certificate), the banded walk (K12's plain version), the score-only
forward (K9's plain version), profile_scores_batch and the banded branch
of align_profile_batch against the JAX package.  Tolerance 0 throughout:
scores bit for bit, certificates, masks and merged rows equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu.ops import gapped as jgapped
from libmems_tpu.ops import profile as jprofile
from libmems_tpu_torch.ops import gapped, profile


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GO, GE = profile.GAP_OPEN, profile.GAP_EXTEND


def _mutant_pair(rng, n, mutate=0.01, indel_at=None, indel_len=0):
    """tests/test_banded.py's pair: q is p with substitutions and an
    optional insertion."""
    a = rng.integers(0, 4, n).astype(np.uint8)
    b = a.copy()
    m = rng.random(n) < mutate
    b[m] = (b[m] + rng.integers(1, 4, int(m.sum()))) % 4
    if indel_at is not None:
        ins = rng.integers(0, 4, indel_len).astype(np.uint8)
        b = np.concatenate([b[:indel_at], ins, b[indel_at:]])
    return a, b


def _gappy_rows(rng, a, n_rows, gap=0.005):
    """n_rows aligned copies of a with gaps and substitutions: a
    fractional profile with gap columns."""
    rows = np.stack([a] * n_rows)
    sub = rng.random(rows.shape) < 0.02
    rows[sub] = rng.integers(0, 4, int(sub.sum()))
    rows[rng.random(rows.shape) < gap] = 4
    rows[:, (rows == 4).all(axis=0)] = 0
    return rows.astype(np.uint8)


def _windows(seed=3):
    """Row groups in the 1024 bucket: a near-diagonal pair, a 300-column
    insertion (fails the certificate), multi-row profiles with gap
    columns, a window under 256 columns (ineligible: slope > 2) and a
    short pair."""
    rng = np.random.default_rng(seed)
    p_rows, q_rows = [], []
    a, b = _mutant_pair(rng, 900)
    p_rows.append(a[None]), q_rows.append(b[None])
    a, b = _mutant_pair(rng, 700, indel_at=350, indel_len=300)
    p_rows.append(a[None]), q_rows.append(b[None])
    a, b = _mutant_pair(rng, 950, mutate=0.02)
    p_rows.append(_gappy_rows(rng, a, 3)), q_rows.append(_gappy_rows(rng, b, 2))
    a, b = _mutant_pair(rng, 880, mutate=0.02, indel_at=400, indel_len=6)
    p_rows.append(_gappy_rows(rng, a, 4)), q_rows.append(_gappy_rows(rng, b, 5))
    a, _ = _mutant_pair(rng, 200)
    _, b = _mutant_pair(rng, 1000)
    p_rows.append(a[None]), q_rows.append(b[None])
    a, b = _mutant_pair(rng, 300, mutate=0.05)
    p_rows.append(a[None]), q_rows.append(b[None])
    return p_rows, q_rows


def _batch(p_rows, q_rows, M=1024, N=1024):
    Mp = -(-M // profile.BAND_K) * profile.BAND_K
    t = profile.pack_profiles(p_rows, q_rows, list(range(len(p_rows))), Mp,
                              N, "cpu")
    return t, [x.numpy() for x in t]


def test_banded_scores_and_certificates_equal_jax():
    p_rows, q_rows = _windows()
    t, (p, q, pl, ql) = _batch(p_rows, q_rows)
    H_W = profile._band_half(1024)
    ref_s, ref_c = jprofile._banded_forward_scores(
        *map(jnp.asarray, (p, q, pl, ql)), GO, GE, H_W)
    got_s, got_c = profile.banded_forward_scores(*t, GO, GE, H_W)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    # the inputs cover certify and fallback, and an ineligible window
    elig = profile._band_eligible(pl, ql, p.shape[1], 1024)
    assert got_c[0] and not got_c[1] and not elig[4] and elig[0]
    # the pointer form gives the same scores and certificates
    _, s2, c2 = profile.banded_forward_ptrs(*t, GO, GE, H_W)
    assert torch.equal(s2, got_s) and torch.equal(c2, got_c)


def test_certified_scores_equal_full_width_forward():
    p_rows, q_rows = _windows(5)
    t, (p, q, pl, ql) = _batch(p_rows, q_rows)
    H_W = profile._band_half(1024)
    score, cert = profile.banded_forward_scores(*t, GO, GE, H_W)
    full = profile.profile_forward_scores(*t, GO, GE)
    ref, _, _ = jprofile.profile_forward_ckpt(
        *map(jnp.asarray, (p, q, pl, ql)), GO, GE, p.shape[1])
    np.testing.assert_array_equal(full.numpy(), np.asarray(ref))
    # K9's plain version is K3's score bit for bit
    _, k3 = profile.profile_forward_plain(*t, GO, GE)
    assert torch.equal(full, k3)
    assert cert.sum() >= 3
    assert torch.equal(score[cert], full[cert])


def test_banded_walk_masks_equal_jax():
    p_rows, q_rows = _windows(7)
    t, (p, q, pl, ql) = _batch(p_rows, q_rows)
    N = 1024
    H_W = profile._band_half(N)
    T = gapped._device_tb_T(p.shape[1], N)
    _, ref_c, packed = jprofile._banded_fwd_tb(
        *map(jnp.asarray, (p, q, pl, ql)), GO, GE, H_W, T)
    ref_tb = jgapped.tb_unpack(packed, len(pl), T)
    ptrs, _, cert = profile.banded_forward_ptrs(*t, GO, GE, H_W)
    assert ptrs.shape == (len(pl), p.shape[1], profile.band_width(H_W) + 1)
    np.testing.assert_array_equal(cert.numpy(), np.asarray(ref_c))
    walk = profile.banded_traceback_walk(ptrs, t[2], t[3], N, H_W, T)
    for (ra, rb), (ga, gb) in zip(ref_tb, gapped.tb_unpack(walk, len(pl))):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)


def test_profile_scores_batch_and_band_stats_equal_jax():
    p_rows, q_rows = _windows(11)
    # a second bucket below the band (64 columns): K9 only
    rng = np.random.default_rng(12)
    for n in (40, 60):
        a, b = _mutant_pair(rng, n)
        p_rows.append(a[None]), q_rows.append(b[None])
    before = (dict(jprofile.BAND_STATS), dict(profile.BAND_STATS))
    ref = jprofile.profile_scores_batch(p_rows, q_rows)
    got = profile.profile_scores_batch(p_rows, q_rows, device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    d_ref = {k: jprofile.BAND_STATS[k] - before[0][k] for k in before[0]}
    d_got = {k: profile.BAND_STATS[k] - before[1][k] for k in before[1]}
    assert d_got == d_ref
    assert d_got["fallback"] >= 1 and d_got["certified"] >= 3


def test_align_profile_batch_banded_equals_jax():
    """Certified windows take the banded traceback, the others re-run at
    full width; merged rows equal the JAX package's byte for byte."""
    p_rows, q_rows = _windows(13)
    before = dict(profile.BAND_STATS)
    ref = jprofile.align_profile_batch(p_rows, q_rows, mesh=None)
    got = profile.align_profile_batch(p_rows, q_rows, device="cpu")
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    d = {k: profile.BAND_STATS[k] - before[k] for k in before}
    assert d["certified"] >= 3 and d["fallback"] >= 1


@pytest.mark.parametrize("M,N", [(1536, 1536), (1024, 2304)])
def test_band_shift_across_blocks_equal_jax(M, N):
    """Windows in larger buckets, longer than a few row blocks and off a
    1:1 slope, so lo moves at every block boundary."""
    rng = np.random.default_rng(M + N)
    p_rows, q_rows = [], []
    for n_p, n_q in ((M - 30, N - 40), (M // 2 + 100, N - 10)):
        a, _ = _mutant_pair(rng, n_p)
        b = np.concatenate([a, rng.integers(0, 4, max(n_q - n_p, 0))
                            .astype(np.uint8)])[:n_q]
        sub = rng.random(len(b)) < 0.02
        b[sub] = rng.integers(0, 4, int(sub.sum()))
        p_rows.append(_gappy_rows(rng, a, 2))
        q_rows.append(b[None])
    t, (p, q, pl, ql) = _batch(p_rows, q_rows, M, N)
    H_W = profile._band_half(N)
    ref_s, ref_c = jprofile._banded_forward_scores(
        *map(jnp.asarray, (p, q, pl, ql)), GO, GE, H_W)
    got_s, got_c = profile.banded_forward_scores(*t, GO, GE, H_W)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))


def test_band_rules_equal_jax():
    for N in (1024, 1536, 7776, 11664):
        assert profile._band_half(N) == jprofile._band_half(N)
        assert profile._band_wb(N) == jprofile._band_wb(N)
    pl = np.array([900, 0, 100, 500, 1000], np.int32)
    ql = np.array([905, 10, 900, 0, 2000], np.int32)
    for M, N in ((1024, 1024), (1024, 256), (128, 1024), (256, 1024)):
        np.testing.assert_array_equal(profile._band_eligible(pl, ql, M, N),
                                      jprofile._band_eligible(pl, ql, M, N))
    for name in ("BAND_K", "BAND_SMAX", "BAND_MIN_N", "BAND_MARGIN"):
        assert getattr(profile, name) == getattr(jprofile, name)
    assert set(profile.BAND_STATS) == set(jprofile.BAND_STATS)


def test_path_scores_equal_jax():
    rng = np.random.default_rng(17)
    a, _ = _mutant_pair(rng, 400)
    rows = _gappy_rows(rng, a, 5, gap=0.1)
    np.testing.assert_array_equal(profile.profile_path_scores_single(rows),
                                  jprofile.profile_path_scores_single(rows))
    assert profile.profile_path_score(rows[:2], rows[2:]) == \
        jprofile.profile_path_score(rows[:2], rows[2:])


def test_c_signatures_cover_every_entry_point():
    """Every extern "C" function of csrc/*.cu has a ctypes signature in
    cuda._SIGNATURES with its number of arguments (the CPU cannot build
    the library, so a missing or short signature shows only on the
    card)."""
    import re
    from libmems_tpu_torch import cuda
    found = {}
    for src in cuda._CSRC.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C"[^(]*?\b(lm_\w+)\(([^)]*)\)', text):
            args = [a for a in m.group(2).split(",") if a.strip()]
            found[m.group(1)] = len(args)
    assert {"lm_profile_fwd", "lm_profile_geometry", "lm_banded_fwd",
            "lm_banded_walk"} <= set(found)
    assert set(found) == set(cuda._SIGNATURES)
    for name, n in found.items():
        assert len(cuda._SIGNATURES[name][0]) == n, name
