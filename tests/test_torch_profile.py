"""Port parity: the profile DP (K3's plain version), the traceback walk
(K4's plain version) and align_profile_batch against the JAX package."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu.ops import gapped as jgapped
from libmems_tpu.ops import profile as jprofile
from libmems_tpu_torch import convert
from libmems_tpu_torch.ops import gapped, profile

# K3's and K9's test windows (tests/profile_windows.py), loaded by path as
# tests/test_torch_cuda.py and chip_smoke.py load them
_spec = importlib.util.spec_from_file_location(
    "profile_windows", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "profile_windows.py"))
windows = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(windows)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mutate(rng, a, rate=0.03, indels=2):
    b = a.copy()
    sub = rng.random(len(b)) < rate
    b[sub] = rng.integers(0, 4, size=int(sub.sum())).astype(np.uint8)
    for _ in range(indels):
        s = int(rng.integers(0, len(b)))
        z = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            b = np.concatenate([b[:s], rng.integers(0, 4, z).astype(np.uint8),
                                b[s:]])
        else:
            b = np.concatenate([b[:s], b[s + z:]])
    return b.astype(np.uint8)


def _pair_windows(rng, sizes):
    p_rows, q_rows = [], []
    for n in sizes:
        a = rng.integers(0, 4, size=n).astype(np.uint8)
        b = _mutate(rng, a)
        p_rows.append(a[None])
        q_rows.append(b[None])
    return p_rows, q_rows


@pytest.mark.parametrize("bucket,sizes", [
    (16, [1, 5, 12, 16]),
    (64, [17, 30, 50, 64]),
    (1024, [700, 1000]),
])
def test_align_profile_batch_pairs_equal_jax(bucket, sizes):
    rng = np.random.default_rng(bucket)
    p_rows, q_rows = _pair_windows(rng, sizes)
    assert {profile._bucket_cols(p.shape[1]) for p in p_rows} == {bucket}
    ref = jprofile.align_profile_batch(p_rows, q_rows, mesh=None)
    got = profile.align_profile_batch(p_rows, q_rows, device="cpu")
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)


def _profiles(rng, B, M, N, n_p, n_q):
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for r in range(B):
        cp = int(rng.integers(M // 2, M + 1))
        cq = int(rng.integers(N // 2, N + 1))
        p[r, :cp] = profile.rows_to_profile(windows.msa_rows(rng, n_p, cp))
        q[r, :cq] = profile.rows_to_profile(windows.msa_rows(rng, n_q, cq))
        pl[r], ql[r] = cp, cq
    return p, q, pl, ql


@pytest.mark.parametrize("n_q", [1, 2])
def test_three_row_forward_scores_close_to_jax(n_q):
    """Fractional profiles: the sum order differs, so scores agree to
    rtol 1e-6 rather than bit for bit."""
    rng = np.random.default_rng(3 + n_q)
    M, N = 64, 64
    p, q, pl, ql = _profiles(rng, 6, M, N, 3, n_q)
    ref, _, _ = jprofile.profile_forward_ckpt(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(pl), jnp.asarray(ql),
        profile.GAP_OPEN, profile.GAP_EXTEND, M)
    _, got = profile.profile_forward(*map(torch.from_numpy, (p, q, pl, ql)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("M,N", [(16, 16), (64, 16), (16, 64)])
def test_pointer_tensor_and_walk_equal_jax(M, N):
    """One-hot profiles: every DP value is a whole number, so the pointer
    bytes in each window's rows 1..p_len, columns 0..q_len and the
    traceback masks match the JAX functions exactly."""
    rng = np.random.default_rng(M * 100 + N)
    p, q, pl, ql = _profiles(rng, 5, M, N, 1, 1)
    qw, ext_q, ext_cum, h0, f0 = jprofile._profile_q_setup(
        jnp.asarray(q), profile.GAP_OPEN, profile.GAP_EXTEND)
    ext_p = profile.GAP_EXTEND * (1.0 - jnp.asarray(p)[:, :, 4])
    ref_ptrs = np.asarray(jprofile.profile_block_ptrs(
        h0, f0, jnp.asarray(p), ext_p, jnp.asarray(q), jnp.asarray(ql),
        profile.GAP_OPEN, profile.GAP_EXTEND))
    ptrs, _ = profile.profile_forward(*map(torch.from_numpy,
                                           (p, q, pl, ql)))
    got = ptrs.numpy()
    for r in range(len(pl)):
        np.testing.assert_array_equal(got[r, :pl[r], :ql[r] + 1],
                                      ref_ptrs[r, :pl[r], :ql[r] + 1])
        assert not got[r, pl[r]:].any() and not got[r, :, ql[r] + 1:].any()

    T = gapped._device_tb_T(M, N)
    packed = jgapped._device_tb_scan(jnp.asarray(got), jnp.asarray(pl),
                                     jnp.asarray(ql), T)
    ref_tb = jgapped.tb_unpack(packed, len(pl), T)
    walk = gapped.traceback_walk(ptrs, torch.from_numpy(pl),
                                  torch.from_numpy(ql), T)
    for (ra, rb), (ga, gb) in zip(ref_tb, gapped.tb_unpack(walk, len(pl))):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)


@pytest.mark.parametrize("n_p,n_q,seed", [(3, 2, 0), (3, 2, 1), (4, 5, 0),
                                          (4, 5, 1)])
def test_fractional_pointers_scores_and_walk_equal_jax(n_p, n_q, seed):
    """Multi-row profiles hold fractions, so pointers depend on the
    rounding order of qw, the row score and ext_cum.  The plain version
    (K3's order) gives the JAX package's pointer bytes, scores and
    traceback masks exactly."""
    rng = np.random.default_rng(100 * n_p + 10 * n_q + seed)
    B, M, N = 4, 64, 64
    p, q, pl, ql = _profiles(rng, B, M, N, n_p, n_q)
    vals = np.unique(np.concatenate([p.ravel(), q.ravel()]))
    assert (np.abs(vals * 64 - np.round(vals * 64)) > 1e-3).any()  # 1/3, 1/5
    jp, jq, jpl, jql = map(jnp.asarray, (p, q, pl, ql))
    qw, ext_q, ext_cum, h0, f0 = jprofile._profile_q_setup(
        jq, profile.GAP_OPEN, profile.GAP_EXTEND)
    ext_p = profile.GAP_EXTEND * (1.0 - jp[:, :, 4])
    ref_ptrs = np.asarray(jprofile.profile_block_ptrs(
        h0, f0, jp, ext_p, jq, jql, profile.GAP_OPEN, profile.GAP_EXTEND))
    ref_score, _, _ = jprofile.profile_forward_ckpt(
        jp, jq, jpl, jql, profile.GAP_OPEN, profile.GAP_EXTEND, M)
    T = gapped._device_tb_T(M, N)
    ref_tb = jgapped.tb_unpack(jprofile._full_ptr_tb_jit(
        jp, ext_p, jq, jql, jpl, profile.GAP_OPEN, profile.GAP_EXTEND, T),
        B, T)

    ptrs, score = profile.profile_forward_plain(
        *map(torch.from_numpy, (p, q, pl, ql)))
    got = ptrs.numpy()
    for r in range(B):
        np.testing.assert_array_equal(got[r, :pl[r], :ql[r] + 1],
                                      ref_ptrs[r, :pl[r], :ql[r] + 1])
    np.testing.assert_array_equal(score.numpy(), np.asarray(ref_score))
    walk = gapped.traceback_walk_plain(ptrs, torch.from_numpy(pl),
                                        torch.from_numpy(ql), T)
    for (ra, rb), (ga, gb) in zip(ref_tb, gapped.tb_unpack(walk, B)):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)


def test_fma32_rounds_once():
    """fma32 equals a*b + c computed exactly (as fractions) and rounded
    once to float32, including sums that fall near a float32 tie."""
    from fractions import Fraction
    rng = np.random.default_rng(9)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 1e-4).astype(np.float32)
    # c chosen so a*b + c sits within a few float64 ulps of a float32 tie
    ab = a.astype(np.float64) * b.astype(np.float64)
    r = ab.astype(np.float32).astype(np.float64)
    half = np.abs(np.spacing(ab.astype(np.float32)).astype(np.float64)) / 2
    c[:1000] = (r + half - ab)[:1000].astype(np.float32)
    got = profile.fma32(*map(torch.from_numpy, (a, b, c))).numpy()
    for k in range(len(a)):
        exact = Fraction(float(a[k])) * Fraction(float(b[k])) \
            + Fraction(float(c[k]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.int32)) & 1))
        assert got[k] == best, k


def test_split_under_pointer_budget_changes_nothing(monkeypatch):
    rng = np.random.default_rng(21)
    p_rows, q_rows = _pair_windows(rng, [40, 50, 60, 64, 33])
    whole = profile.align_profile_batch(p_rows, q_rows, device="cpu")
    monkeypatch.setattr(profile, "PTR_BUDGET", 64 * 65 * 2)
    assert all(len(sub) <= 2 for _, _, sub in
               profile.plan_launches(p_rows, q_rows))
    split = profile.align_profile_batch(p_rows, q_rows, device="cpu")
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(a, b)


def test_scoring_constants_equal_jax():
    ref = convert.scoring_from_reference(jgapped.HOXD70, jprofile.W5,
                                         jgapped.GAP_OPEN,
                                         jgapped.GAP_EXTEND)
    got = convert.scoring_from_reference(gapped.HOXD70, profile.W5,
                                         gapped.GAP_OPEN, gapped.GAP_EXTEND)
    np.testing.assert_array_equal(got.w5, ref.w5)
    assert (got.gap_open, got.gap_extend) == (ref.gap_open, ref.gap_extend)
    for name in ("H_DIAG", "H_E", "H_F", "E_EXT_BIT", "F_EXT_BIT"):
        assert getattr(gapped, name) == getattr(jgapped, name)
    assert profile.NEG_BIG == jprofile.NEG_BIG
    assert profile.GAP_CODE == jprofile.GAP_CODE


@pytest.mark.parametrize("M,N,shapes", windows.EDGES,
                         ids=[f"N{N}" for _, N, _ in windows.EDGES])
def test_plain_equals_jax_at_strip_edge_widths(M, N, shapes):
    """K3's and K9's plain versions at the widths where the strip kernels
    change strips or route, on fractional 3 + 2-row profiles with empty
    windows: pointer bytes (the JAX block pointers from the first row),
    zeros outside each window, scores bit for bit (profile_forward_ckpt
    at K = M, the JAX form of K9) and traceback masks (_full_ptr_tb)
    equal the JAX package's."""
    rng = np.random.default_rng(N)
    p, q, pl, ql = windows.sized_profiles(rng, M, N, shapes)
    jp, jq, jpl, jql = map(jnp.asarray, (p, q, pl, ql))
    _, _, _, h0, f0 = jprofile._profile_q_setup(jq, profile.GAP_OPEN,
                                                profile.GAP_EXTEND)
    ext_p = profile.GAP_EXTEND * (1.0 - jp[:, :, 4])
    ref_ptrs = np.asarray(jprofile.profile_block_ptrs(
        h0, f0, jp, ext_p, jq, jql, profile.GAP_OPEN, profile.GAP_EXTEND))
    ref_score, _, _ = jprofile.profile_forward_ckpt(
        jp, jq, jpl, jql, profile.GAP_OPEN, profile.GAP_EXTEND, M)
    T = gapped._device_tb_T(M, N)
    ref_tb = jgapped.tb_unpack(jprofile._full_ptr_tb_jit(
        jp, ext_p, jq, jql, jpl, profile.GAP_OPEN, profile.GAP_EXTEND, T),
        len(pl), T)

    t = [torch.from_numpy(x) for x in (p, q, pl, ql)]
    ptrs, score = profile.profile_forward(*t)
    got = ptrs.numpy()
    for r in range(len(pl)):
        np.testing.assert_array_equal(got[r, :pl[r], :ql[r] + 1],
                                      ref_ptrs[r, :pl[r], :ql[r] + 1])
        assert not got[r, pl[r]:].any() and not got[r, :, ql[r] + 1:].any()
    np.testing.assert_array_equal(score.numpy(), np.asarray(ref_score))
    np.testing.assert_array_equal(
        profile.profile_forward_scores(*t).numpy(), np.asarray(ref_score))
    walk = gapped.traceback_walk(ptrs, t[2], t[3], T)
    for (ra, rb), (ga, gb) in zip(ref_tb, gapped.tb_unpack(walk, len(pl))):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)


def test_strip_boundary_matches_the_kernels():
    """STRIP_MAX_N is csrc/profile.cu's kStripMaxN: the widest bucket the
    strip kernels take (8 warps x 32 lanes x 17 columns - 1); and the
    edge widths' lane widths (tests/profile_windows.py) are its kStripK."""
    import re
    from libmems_tpu_torch import cuda
    src = (cuda._CSRC / "profile.cu").read_text()
    m = re.search(r"constexpr int kStripMaxN = (\d+);", src)
    assert m and int(m.group(1)) == profile.STRIP_MAX_N == 8 * 32 * 17 - 1
    m = re.search(r"constexpr int kStripK\[\] = \{([\d, ]+)\};", src)
    assert m and tuple(int(k) for k in m.group(1).split(",")) == \
        windows.STRIP_KS
