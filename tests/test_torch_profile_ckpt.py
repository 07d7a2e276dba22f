"""Port parity: the checkpointed profile DP (K24's and K25's plain
versions) and the route of align_profile_batch that takes it for windows
whose full pointer tensor exceeds PTR_BUDGET, against the JAX package's
profile_forward_ckpt / profile_block_ptrs at K = 128 and its own
checkpointed route."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmems_tpu.interval import write_xmfa as jax_write_xmfa
from libmems_tpu.ops import gapped as jgapped
from libmems_tpu.ops import profile as jprofile
from libmems_tpu.progressive import ProgressiveConfig as JaxProgressiveConfig
from libmems_tpu.progressive import progressive_align as jax_progressive
from libmems_tpu.sequence import Genome as JaxGenome
import libmems_tpu_torch as lt
from libmems_tpu_torch.ops import gapped, profile
from tests.golden import generate


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GO, GE = profile.GAP_OPEN, profile.GAP_EXTEND
K = 128


def _msa_rows(rng, n_rows, n):
    """n_rows aligned rows with gap columns (one row: a one-hot
    profile)."""
    base = rng.integers(0, 4, size=n).astype(np.uint8)
    rows = np.stack([base] * n_rows)
    if n_rows > 1:
        rows[rng.random(rows.shape) < 0.1] = 4
        mut = rng.random(rows.shape) < 0.05
        rows[mut] = rng.integers(0, 4, size=int(mut.sum()))
        rows[:, (rows == 4).all(axis=0)] = 0
    return rows


def _profiles(rng, B, M, N, n_p, n_q):
    """Zero-padded profiles whose lengths leave padded rows and
    columns."""
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for r in range(B):
        cp = int(rng.integers(M // 2, M - 7))
        cq = int(rng.integers(N // 2, N - 3))
        p[r, :cp] = profile.rows_to_profile(_msa_rows(rng, n_p, cp))
        q[r, :cq] = profile.rows_to_profile(_msa_rows(rng, n_q, cq))
        pl[r], ql[r] = cp, cq
    return p, q, pl, ql


# B * N = 256, above the XLA CPU dot's order switch (the shapes of
# test_torch_profile.py's fractional test), at two 128-row blocks
KINDS = [(1, 1, 0), (3, 2, 0), (3, 2, 1), (4, 5, 0)]


@pytest.mark.parametrize("n_p,n_q,seed", KINDS)
def test_ckpt_forward_and_block_ptrs_equal_jax(n_p, n_q, seed):
    """Score, ck_h and ck_f whole, and every block's pointer bytes whole
    (padded rows and columns included), exactly."""
    rng = np.random.default_rng(1000 + 100 * n_p + 10 * n_q + seed)
    B, M, N = 4, 2 * K, 64
    p, q, pl, ql = _profiles(rng, B, M, N, n_p, n_q)
    jp, jq, jpl, jql = map(jnp.asarray, (p, q, pl, ql))
    ref_score, ref_h, ref_f = map(np.asarray, jprofile.profile_forward_ckpt(
        jp, jq, jpl, jql, GO, GE, K))
    tp, tq, tpl, tql = map(torch.from_numpy, (p, q, pl, ql))
    score, ck_h, ck_f = profile.profile_forward_ckpt_plain(tp, tq, tpl, tql,
                                                           GO, GE, K)
    np.testing.assert_array_equal(score.numpy(), ref_score)
    np.testing.assert_array_equal(ck_h.numpy(), ref_h)
    np.testing.assert_array_equal(ck_f.numpy(), ref_f)
    # the wrapper takes the plain version for CPU tensors
    for g, r in zip(profile.profile_forward_ckpt(tp, tq, tpl, tql, GO, GE, K),
                    (score, ck_h, ck_f)):
        assert torch.equal(g, r)
    # K24's score is K9's (profile_forward_scores) bit for bit
    assert torch.equal(score, profile.profile_forward_scores(tp, tq, tpl,
                                                             tql, GO, GE))

    ext_p = GE * (1.0 - jp[:, :, 4])
    for bi in range(M // K):
        sl = slice(bi * K, (bi + 1) * K)
        ref = np.asarray(jprofile.profile_block_ptrs(
            jnp.asarray(ref_h[bi]), jnp.asarray(ref_f[bi]), jp[:, sl],
            ext_p[:, sl], jq, jql, GO, GE))
        got = profile.profile_block_ptrs_plain(
            ck_h[bi], ck_f[bi], tp[:, sl].contiguous(), tq, tql, GO, GE)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jgapped.pack_ptrs(jnp.asarray(ref))))
        np.testing.assert_array_equal(gapped.unpack_ptrs(got.numpy(), N + 1),
                                      ref)
        # the wrapper takes the plain version for CPU tensors
        assert torch.equal(got, profile.profile_block_ptrs(
            ck_h[bi], ck_f[bi], tp[:, sl].contiguous(), tq, tql, GO, GE))


def test_ckpt_pointer_rows_equal_full_pointer_tensor():
    """Inside each window, K25's blocks are K3's pointer rows."""
    rng = np.random.default_rng(77)
    B, M, N = 3, 2 * K, 80
    t = tuple(map(torch.from_numpy, _profiles(rng, B, M, N, 3, 2)))
    full, score = profile.profile_forward_plain(*t, GO, GE)
    s2, ck_h, ck_f = profile.profile_forward_ckpt_plain(*t, GO, GE, K)
    assert torch.equal(score, s2)
    pl, ql = t[2].numpy(), t[3].numpy()
    for bi in range(M // K):
        blk = gapped.unpack_ptrs(profile.profile_block_ptrs_plain(
            ck_h[bi], ck_f[bi], t[0][:, bi * K:(bi + 1) * K].contiguous(),
            t[1], t[3], GO, GE).numpy(), N + 1)
        for r in range(B):
            rows = max(0, min(K, pl[r] - bi * K))
            np.testing.assert_array_equal(
                blk[r, :rows, :ql[r] + 1],
                full.numpy()[r, bi * K:bi * K + rows, :ql[r] + 1])


def _windows(rng, sizes, n_p=1, n_q=1):
    p_rows, q_rows = [], []
    for n in sizes:
        a = _msa_rows(rng, n_p, n)
        b = _msa_rows(rng, n_q, n + int(rng.integers(-n // 8, n // 8 + 1)))
        p_rows.append(a)
        q_rows.append(b)
    return p_rows, q_rows


def _force_ckpt(monkeypatch, budget):
    """Lower PTR_BUDGET and record every K3 launch's pointer bytes."""
    monkeypatch.setattr(profile, "PTR_BUDGET", budget)
    seen = []
    real = profile.profile_forward

    def spy(p, q, *a, **k):
        seen.append(p.shape[0] * p.shape[1] * (q.shape[1] + 1))
        return real(p, q, *a, **k)
    monkeypatch.setattr(profile, "profile_forward", spy)
    return seen


@pytest.mark.parametrize("n_p,n_q", [(1, 1), (3, 2)])
def test_align_profile_batch_ckpt_route_equals_jax(monkeypatch, n_p, n_q):
    """Windows over the pointer budget take K24 + K25 + the host walk;
    their merged rows equal the JAX package's checkpointed route and the
    port's one-launch route, and no launch builds a pointer tensor over
    the budget."""
    rng = np.random.default_rng(31 + n_p)
    p_rows, q_rows = _windows(rng, [40, 60, 150, 200, 250], n_p, n_q)
    one_launch = profile.align_profile_batch(p_rows, q_rows, device="cpu")
    monkeypatch.setattr(jgapped, "DEVICE_TB_BUDGET", 1)
    ref = jprofile.align_profile_batch(p_rows, q_rows, mesh=None)
    budget = 64 * 65 + 1     # the 64 x 64 bucket fits, larger ones do not
    seen = _force_ckpt(monkeypatch, budget)
    before = dict(profile.CKPT_STATS)
    got = profile.align_profile_batch(p_rows, q_rows, device="cpu")
    moved = profile.CKPT_STATS["windows"] - before["windows"]
    assert moved == sum(
        len(sub) for Mp, N, sub in profile.plan_launches(p_rows, q_rows)
        if profile.ckpt_route(Mp, N)) >= 3
    assert seen and max(seen) <= budget
    for g, r, o in zip(got, ref, one_launch):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, o)


def test_ckpt_launches_keep_carries_under_budget(monkeypatch):
    monkeypatch.setattr(profile, "PTR_BUDGET", 3 * 8 * 2 * 257)
    p_rows, q_rows = _windows(np.random.default_rng(5), [200] * 7)
    launches = profile.plan_launches(p_rows, q_rows)
    assert all(profile.ckpt_route(Mp, N) for Mp, N, _ in launches)
    assert [len(s) for _, _, s in launches] == [3, 3, 1]
    assert all(profile.full_window_bytes(Mp, N) * len(s) <= profile.PTR_BUDGET
               for Mp, N, s in launches)


def _family(rng_seed=43, n=6_000):
    """Four genomes, 8% substitutions and 0.2% indels: node merges with
    16- and 64-column windows."""
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    out = [anc] + [generate._mutant(rng, anc, mutate=0.08, indel=0.002)
                   for _ in range(3)]
    return [generate._LUT[g] for g in out]


def test_progressive_ckpt_route_xmfa_equals_jax(monkeypatch):
    """progressive_align with every profile-DP window on the checkpointed
    route (no K3 launch at all) writes the JAX package's XMFA bytes (the
    JAX package on its own checkpointed route)."""
    fam = _family()
    cfg = dict(refine=False, max_gapped_window=2_000)
    monkeypatch.setattr(jgapped, "DEVICE_TB_BUDGET", 1)
    ref, _ = jax_progressive([JaxGenome(f"g{i}", a)
                              for i, a in enumerate(fam)],
                             JaxProgressiveConfig(**cfg))
    seen = _force_ckpt(monkeypatch, 1)
    before = profile.CKPT_STATS["windows"]
    ivs, _ = lt.progressive_align([lt.Genome(f"g{i}", a)
                                   for i, a in enumerate(fam)],
                                  lt.ProgressiveConfig(device="cpu", **cfg))
    assert profile.CKPT_STATS["windows"] - before >= 50
    assert not seen

    def text(write, x):
        buf = io.StringIO()
        write(buf, x)
        return buf.getvalue()
    assert text(lt.write_xmfa, ivs) == text(jax_write_xmfa, ref)


def _ckpt_batch(seed, B, nb, N, n_p=3, n_q=2):
    rng = np.random.default_rng(seed)
    t = tuple(map(torch.from_numpy, _profiles(rng, B, nb * K, N, n_p, n_q)))
    _, ck_h, ck_f = profile.profile_forward_ckpt_plain(*t, GO, GE, K)
    return t, ck_h, ck_f


@pytest.mark.parametrize("G", [1, 3, 5])
def test_block_ptrs_batch_plain_equals_blocks(G):
    """The batched K25's plain version over G row blocks (G = 1, 3 and
    nb = 5) is profile_block_ptrs_plain block by block, and the wrapper
    takes it for CPU tensors."""
    t, ck_h, ck_f = _ckpt_batch(61, 2, 5, 48)
    for first in sorted({0, 5 - G}):
        got = profile.profile_block_ptrs_batch_plain(ck_h, ck_f, t[0], t[1],
                                                     t[3], first, G, GO, GE)
        assert got.shape == (G, 2, K, (48 + 2) // 2)
        for k in range(G):
            bi = first + k
            want = profile.profile_block_ptrs_plain(
                ck_h[bi], ck_f[bi], t[0][:, bi * K:(bi + 1) * K].contiguous(),
                t[1], t[3], GO, GE)
            assert torch.equal(got[k], want), bi
        assert torch.equal(got, profile.profile_block_ptrs_batch(
            ck_h, ck_f, t[0], t[1], t[3], first, G, GO, GE))


@pytest.mark.parametrize("G", [1, 3, 5])
def test_ckpt_tracebacks_batches_equal_jax(monkeypatch, G):
    """ckpt_tracebacks with G row blocks a K25 launch (1, 3 and all 5)
    gives the JAX package's checkpointed route's gap masks; the walk's
    requests are served from as many launches as the groups need (the
    top block, above every window's rows, is never asked for)."""
    rng = np.random.default_rng(67)
    B, nb, N = 3, 5, 56
    p = np.zeros((B, nb * K, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = np.array([300, 470, 512], np.int32)
    ql = np.array([40, 55, 29], np.int32)
    for r in range(B):
        p[r, :pl[r]] = profile.rows_to_profile(_msa_rows(rng, 3, pl[r]))
        q[r, :ql[r]] = profile.rows_to_profile(_msa_rows(rng, 2, ql[r]))
    jp, jq, jpl, jql = map(jnp.asarray, (p, q, pl, ql))
    _, jh, jf = jprofile.profile_forward_ckpt(jp, jq, jpl, jql, GO, GE, K)
    ext_p = GE * (1.0 - jp[:, :, 4])

    def jfetch(bi):
        sl = slice(bi * K, (bi + 1) * K)
        return np.asarray(jprofile.profile_block_ptrs(
            jh[bi], jf[bi], jp[:, sl], ext_p[:, sl], jq, jql, GO, GE))
    ref = jgapped.traceback_blocks(jfetch, nb, K, pl, ql)
    calls = []
    real = profile.profile_block_ptrs_batch

    def spy(ck_h, ck_f, p_, q_, q_len, first, count, *a, **k):
        calls.append((first, count))
        return real(ck_h, ck_f, p_, q_, q_len, first, count, *a, **k)
    monkeypatch.setattr(profile, "profile_block_ptrs_batch", spy)
    got = profile.ckpt_tracebacks(*map(torch.from_numpy, (p, q, pl, ql)),
                                  GO, GE, G=G)
    assert len(got) == len(ref) == B
    for (ga, gb), (ra, rb) in zip(got, ref):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)
    # blocks 3 .. 0 are asked for, from the top window's row 512 down
    want = {1: [(3, 1), (2, 1), (1, 1), (0, 1)], 3: [(1, 3), (0, 1)],
            5: [(0, 4)]}[G]
    assert calls == want


def span_tickets(n_inst, N, K, W):
    """The blocks of a span launch of n_inst instances in ticket order,
    as csrc/profile.cu's span_kernel maps a ticket: (ticket, instance,
    segment, strips, columns [lo, hi)), segment-major within an
    instance."""
    S, C = profile.span_plan(N, K, W)
    out = []
    for t in range(n_inst * C):
        inst, seg = divmod(t, C)
        strips = list(range(seg * W, min(S, (seg + 1) * W)))
        out.append((t, inst, seg, strips,
                    (strips[0] * 32 * K, min(N + 1, (strips[-1] + 1) * 32 * K))))
    return out


@pytest.mark.parametrize("N", [4_352, 12_160, 39_366])
def test_span_plan_covers_every_column_once(N):
    """The host-side plan of K24/K25 (ticket -> instance, segment,
    strips, columns) covers an instance's N+1 columns exactly once, in
    every geometry, with blocks that hold fewer strips than W at the end
    (S not a multiple of W); a block waits only on the ticket before
    it."""
    partial = 0
    for g, Kc in enumerate(profile.SPAN_K):
        for W in range(1, profile.SPAN_MAX_W + 1):
            S, C = profile.span_plan(N, Kc, W)
            partial += S % W != 0
            seen = np.zeros((2, N + 1), np.int32)
            tickets = span_tickets(2, N, Kc, W)
            assert len(tickets) == 2 * C
            for t, inst, seg, strips, (lo, hi) in tickets:
                assert 1 <= len(strips) <= W
                assert lo == strips[0] * 32 * Kc
                seen[inst, lo:hi] += 1
                if seg > 0:
                    assert tickets[t - 1][1:3] == (inst, seg - 1)
            assert (seen == 1).all(), (g, W)
    assert partial > 0


def test_span_pick_and_block_batch():
    """The pick of (K, warps) takes only geometries that fit the card's
    registers (fits > 0), never more warps than strips, and covers the
    window; G keeps a K25 launch's packed pointers within
    PTR_BUDGET / PTR_BATCH_SHARE."""
    fits = {(g, W): (0 if g == 0 and W == 8 else 1)
            for g in range(len(profile.SPAN_K))
            for W in range(1, profile.SPAN_MAX_W + 1)}
    for n_inst, R, N, ptr in ((1, 34_048, 39_366, False),
                              (53, 128, 39_366, True),
                              (2, 2_304, 2_303, False), (1, 128, 100, True)):
        g, W = profile.span_pick(n_inst, R, N, ptr, 132, fits)
        S, C = profile.span_plan(N, profile.SPAN_K[g], W)
        assert fits[(g, W)] > 0 and W <= S and C * W >= S
        assert S * 32 * profile.SPAN_K[g] >= N + 1
    with pytest.raises(RuntimeError):
        profile.span_pick(1, 128, 100, True, 132, dict.fromkeys(fits, 0))
    N, nb = 39_366, 266
    G = profile.block_batch(1, K, N, nb)
    per = K * ((N + 2) // 2)
    assert 1 <= G <= nb
    assert G * per <= profile.PTR_BUDGET // profile.PTR_BATCH_SHARE
    assert (G + 1) * per > profile.PTR_BUDGET // profile.PTR_BATCH_SHARE
    assert profile.block_batch(1, K, 64, 5) == 5
    assert profile.block_batch(4, K, 10 ** 9, 5) == 1
