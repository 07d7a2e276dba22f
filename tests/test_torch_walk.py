"""Port parity of the traceback walks' compact output: K4's and K12's
plain versions return each window's 2-bit column codes (WalkCodes), and
tb_unpack decodes them to the JAX package's (a_gaps, b_gaps) masks of
_device_tb_scan and _banded_fwd_tb, on edge windows; and global_mesh's
device default."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu.ops import gapped as jgapped
from libmems_tpu.ops import profile as jprofile
from libmems_tpu_torch.ops import gapped, profile
from libmems_tpu_torch.parallel import multihost as mh

GO, GE = profile.GAP_OPEN, profile.GAP_EXTEND
DIAG = gapped.H_DIAG
E_RUN = gapped.H_E | gapped.E_EXT_BIT    # enter E and stay
F_RUN = gapped.H_F | gapped.F_EXT_BIT    # enter F and stay


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _full_windows(rng, M=40, N=50):
    """Pointer bytes of edge windows over M rows of N+1 columns: random
    valid bytes (p_len and q_len around the 4-, 8-, 16- and 32-row slabs
    of the walk's ring), p_len = 0, q_len = 0, an all-gap window (E
    everywhere: the walk runs left along its last row, then up column
    0), a walk that ends in E (diagonal, then row 1 in E) and one that
    ends in F (diagonal, then column 1 in F)."""
    rand = rng.integers(0, 16, (6, M, N + 1)).astype(np.uint8)
    rand[rand % 4 == 3] &= 0xC
    ends_e = np.full((M, N + 1), DIAG, np.uint8)
    ends_e[0] = E_RUN
    ends_f = np.full((M, N + 1), DIAG, np.uint8)
    ends_f[:, 1] = F_RUN
    ptrs = np.concatenate([rand, np.full((3, M, N + 1), DIAG, np.uint8),
                           np.full((1, M, N + 1), E_RUN, np.uint8),
                           ends_e[None], ends_f[None]])
    lens = [(31, 50), (32, 47), (33, 29), (17, 16), (9, 4), (40, 50),
            (0, 37), (23, 0), (0, 0), (40, 45), (12, 30), (35, 12)]
    pl = np.array([a for a, _ in lens], np.int32)
    ql = np.array([b for _, b in lens], np.int32)
    return ptrs, pl, ql


def _assert_decodes_to(walk, ref_tb, n):
    got = gapped.tb_unpack(walk, n)
    assert len(got) == len(ref_tb) == n
    for k, ((ra, rb), (ga, gb)) in enumerate(zip(ref_tb, got)):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)
        assert int(walk.counts[k]) == len(ra)
        # the words left of the alignment are zero
        lead = (16 * walk.words.shape[1] - len(ra)) // 16
        assert not walk.words[k, :lead].any()


def test_full_walk_codes_decode_to_jax_masks():
    ptrs, pl, ql = _full_windows(np.random.default_rng(12))
    B, M, N1 = ptrs.shape
    T = gapped._device_tb_T(M, N1 - 1)
    packed = jgapped._device_tb_scan(jnp.asarray(ptrs), jnp.asarray(pl),
                                     jnp.asarray(ql), T)
    ref_tb = jgapped.tb_unpack(packed, B, T)
    walk = gapped.traceback_walk(torch.from_numpy(ptrs), torch.from_numpy(pl),
                                 torch.from_numpy(ql), T)
    assert walk.words.shape == (B, gapped.code_words(M, N1 - 1))
    _assert_decodes_to(walk, ref_tb, B)
    # the edge windows are what they claim
    assert int(walk.counts[8]) == 0 and int(walk.steps[8]) == 0
    a, b = ref_tb[9]
    assert (a | b).all() and a.sum() == 45 and b.sum() == 40   # all gaps
    # the walk's last steps (the alignment's first columns): the gaps in
    # a of E along row 1, then one gap in b; the gaps in b of F down
    # column 1, then one gap in a
    assert ref_tb[10][1][0] and ref_tb[10][0][1:20].all()
    assert ref_tb[11][0][0] and ref_tb[11][1][1:25].all()
    # a selection of windows decodes in the order asked for
    sel = gapped.tb_unpack(walk, [11, 0, 6])
    for (ga, gb), k in zip(sel, [11, 0, 6]):
        np.testing.assert_array_equal(ga, ref_tb[k][0])
        np.testing.assert_array_equal(gb, ref_tb[k][1])


def test_full_walk_one_window_decodes_to_jax_masks():
    rng = np.random.default_rng(3)
    ptrs, pl, ql = _full_windows(rng, M=20, N=24)
    ptrs, pl, ql = ptrs[:1], np.array([20], np.int32), np.array([19], np.int32)
    T = gapped._device_tb_T(20, 24)
    packed = jgapped._device_tb_scan(jnp.asarray(ptrs), jnp.asarray(pl),
                                     jnp.asarray(ql), T)
    walk = gapped.traceback_walk_plain(torch.from_numpy(ptrs),
                                       torch.from_numpy(pl),
                                       torch.from_numpy(ql), T)
    _assert_decodes_to(walk, jgapped.tb_unpack(packed, 1, T), 1)


def test_walk_codes_layout():
    """Column c of a window's row is bits 2*(c % 16) of word c // 16 and
    the alignment is right-aligned: the codes of a known walk."""
    ptrs = np.full((1, 3, 21), DIAG, np.uint8)
    ptrs[0, 2, 20] = E_RUN & ~gapped.E_EXT_BIT   # one gap in a at the end
    walk = gapped.traceback_walk_plain(
        torch.from_numpy(ptrs), torch.tensor([3], dtype=torch.int32),
        torch.tensor([20], dtype=torch.int32), gapped._device_tb_T(3, 20))
    # 20 columns: 16 gaps in a (row 0), three diagonal, the last a gap
    # in a (entered from H at the walk's first step)
    codes = [1] * 16 + [0, 0, 0, 1]
    C = 16 * walk.words.shape[1]
    want = np.zeros(C, np.int64)
    want[C - 20:] = codes
    words = (want.reshape(-1, 16) << (2 * np.arange(16))).sum(1)
    words = np.where(words >= 1 << 31, words - (1 << 32), words)
    np.testing.assert_array_equal(walk.words[0].numpy(), words)
    assert int(walk.counts[0]) == 20 and int(walk.steps[0]) == 21


def _mutant(rng, n, ins_at=0, ins=0, cut_at=0, cut=0):
    a = rng.integers(0, 4, n).astype(np.uint8)
    b = a.copy()
    m = rng.random(n) < 0.02
    b[m] = (b[m] + 1) % 4
    b = np.concatenate([b[:ins_at], rng.integers(0, 4, ins), b[ins_at:]])
    b = np.concatenate([b[:cut_at], b[cut_at + cut:]])
    return a, b.astype(np.uint8)


def test_banded_walk_codes_decode_to_jax_masks():
    """K12's plain version on edge windows of the 1024 bucket: p_len =
    0, q_len = 0, lengths just past one and two 128-row bands and a
    walk's 32-row slab, paths that hug the band's upper edge (370
    columns inserted near the start, H_W = 127) and its lower edge (125
    cut), and a window that fails the certificate (its pointers are
    walked all the same)."""
    rng = np.random.default_rng(1024)
    pairs = [(rng.integers(0, 4, 0).astype(np.uint8),
              rng.integers(0, 4, 300).astype(np.uint8)),
             (rng.integers(0, 4, 300).astype(np.uint8),
              rng.integers(0, 4, 0).astype(np.uint8)),
             _mutant(rng, 129), _mutant(rng, 257), _mutant(rng, 33),
             _mutant(rng, 500, ins_at=40, ins=370),
             _mutant(rng, 600, cut_at=40, cut=125),
             _mutant(rng, 700, ins_at=350, ins=300)]
    p_rows = [a[None] for a, _ in pairs]
    q_rows = [b[None] for _, b in pairs]
    t = profile.pack_profiles(p_rows, q_rows, list(range(len(pairs))), 1024,
                              1024, "cpu")
    p, q, pl, ql = (x.numpy() for x in t)
    N = 1024
    H_W = profile._band_half(N)
    T = gapped._device_tb_T(1024, N)
    _, ref_c, packed = jprofile._banded_fwd_tb(
        *map(jnp.asarray, (p, q, pl, ql)), GO, GE, H_W, T)
    ptrs, _, cert = profile.banded_forward_ptrs(*t, GO, GE, H_W)
    np.testing.assert_array_equal(cert.numpy(), np.asarray(ref_c))
    walk = profile.banded_traceback_walk(ptrs, t[2], t[3], N, H_W, T)
    assert walk.words.shape == (len(pairs), gapped.code_words(1024, N))
    _assert_decodes_to(walk, jgapped.tb_unpack(packed, len(pairs), T),
                       len(pairs))
    # the insertion's path runs along the band's upper edge and the cut's
    # along its lower edge (local column clip(j - lo, 0, WB))
    WB = profile.band_width(H_W)
    local = []
    for k, (a, b) in zip((5, 6), gapped.tb_unpack(walk, [5, 6])):
        i = np.cumsum(~a)       # rows and columns consumed through each
        j = np.cumsum(~b)       # alignment column
        lo = np.clip((((i - 1).clip(0) // 128) * 128 * ql[k]) // pl[k]
                     - (H_W + 1), 0, N - WB)
        local.append(j - lo)
    assert local[0].max() >= WB - 8 and local[1].min() <= 8


def test_global_mesh_default_device_is_the_card(monkeypatch):
    """In one process global_mesh() takes the card: without a usable GPU
    it raises, as every entry point does; device="cpu" still gives the
    CPU mesh the tests use."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mh.global_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mh.global_mesh(2)
    cpu = torch.device("cpu")
    assert mh.global_mesh(device="cpu").devices == [cpu]
    assert mh.global_mesh(3, device="cpu").devices == [cpu] * 3
