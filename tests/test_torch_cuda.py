"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Marked ``cuda``: they skip where no GPU is
present.  On a GPU machine (no JAX needed):

    python -m pytest tests/test_torch_cuda.py -q
"""

import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from libmems_tpu_torch import AlignerConfig, Genome, align, write_xmfa
from libmems_tpu_torch import seeds
from libmems_tpu_torch.ops import extend, gapped, mers, profile

# loaded by path, not as tests.golden.generate: `tests` here is a
# namespace package, which any regular `tests` package installed in
# site-packages would shadow
_spec = importlib.util.spec_from_file_location(
    "golden_generate", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "golden", "generate.py"))
generate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(generate)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("weight", [15, 17])
def test_seed_keys_kernel_equals_plain(dev, weight):
    seed = seeds.get_seed(weight)
    rng = np.random.default_rng(weight)
    codes = torch.from_numpy(rng.integers(0, 4, 100_000).astype(np.uint8))
    ambig = torch.from_numpy(rng.random(100_000) < 0.001)
    for a in (None, ambig):
        got = mers.canonical_seed_keys(codes.to(dev), seed,
                                       None if a is None else a.to(dev))
        ref = mers.canonical_seed_keys_plain(codes, seed, a)
        assert torch.equal(got.cpu(), ref)


def test_extend_kernel_equals_plain(dev):
    seed = seeds.get_seed(15)
    seed_len = seeds.seed_length(seed)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, 50_000).astype(np.uint8)
    b = a.copy()
    sub = rng.random(len(b)) < 0.003
    b[sub] = rng.integers(0, 4, int(sub.sum())).astype(np.uint8)
    b[20_000:30_000] = 3 - b[20_000:30_000][::-1]
    ka = mers.canonical_seed_keys_plain(torch.from_numpy(a), seed)
    kb = mers.canonical_seed_keys_plain(torch.from_numpy(b), seed)
    keys = torch.cat([ka, kb])
    pos = rng.integers(0, len(ka), 500)
    inv = (pos >= 20_000) & (pos < 30_000 - seed_len)
    posb = np.where(inv, 50_000 - pos - seed_len, pos)
    R = len(pos)
    lefts = torch.from_numpy(np.stack([pos, posb], 1).astype(np.int32))
    present = torch.ones((R, 2), dtype=torch.bool)
    present[-3:] = False
    is_fwd = torch.from_numpy(np.stack([np.ones(R, bool), ~inv], 1))
    off = torch.tensor([[0, len(ka)]], dtype=torch.int32).expand(R, 2)
    cnt = torch.tensor([[len(ka), len(kb)]], dtype=torch.int32).expand(R, 2)
    lengths = torch.full((R,), seed_len, dtype=torch.int32)
    args = [keys, seed_len, 256, off.contiguous(), cnt.contiguous(), lefts,
            present, is_fwd, lengths, mers.key_sentinel(seed)]
    ref = extend.extend_matches_plain(*args)
    got = extend.extend_matches(*[x.to(dev) if isinstance(x, torch.Tensor)
                                  else x for x in args])
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    assert int(ref[1].max()) > 8 * 256


@pytest.mark.parametrize("M,N,smem", [(64, 64, True), (64, 1536, True),
                                      (64, 1536, False)])
def test_profile_and_traceback_kernels_equal_plain(dev, monkeypatch, M, N,
                                                   smem):
    if not smem:   # rows in global scratch instead of shared memory
        monkeypatch.setattr(profile, "PROFILE_SMEM_LIMIT", 0)
    rng = np.random.default_rng(M + N)
    B = 4
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = rng.integers(M // 2, M + 1, B).astype(np.int32)
    ql = rng.integers(N // 2, N + 1, B).astype(np.int32)
    for r in range(B):
        p[r, np.arange(pl[r]), rng.integers(0, 4, pl[r])] = 1
        q[r, np.arange(ql[r]), rng.integers(0, 4, ql[r])] = 1
    cpu = [torch.from_numpy(x) for x in (p, q, pl, ql)]
    ref_p, ref_s = profile.profile_forward_plain(*cpu)
    got_p, got_s = profile.profile_forward(*[x.to(dev) for x in cpu])
    assert torch.equal(got_p.cpu(), ref_p)
    assert torch.equal(got_s.cpu(), ref_s)
    T = gapped._device_tb_T(M, N)
    ref_m = gapped.traceback_walk_plain(ref_p, cpu[2], cpu[3], T)
    got_m = gapped.traceback_walk(got_p, cpu[2].to(dev), cpu[3].to(dev), T)
    for g, r in zip(got_m, ref_m):
        assert torch.equal(g.cpu(), r)


def test_profile_kernel_equals_plain_on_fractional_profiles(dev):
    """Multi-row profiles (thirds, fifths): K3's fixed rounding order
    gives the plain version's bytes and scores exactly."""
    rng = np.random.default_rng(35)
    B, M, N = 6, 256, 256
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = rng.integers(M // 2, M + 1, B).astype(np.int32)
    ql = rng.integers(N // 2, N + 1, B).astype(np.int32)
    for r in range(B):
        for arr, n, k in ((p, pl[r], 3 + r % 2), (q, ql[r], 5 - r % 3)):
            rows = rng.integers(0, 4, (k, n)).astype(np.uint8)
            rows[rng.random((k, n)) < 0.15] = 4
            rows[:, (rows == 4).all(axis=0)] = 0
            arr[r, :n] = profile.rows_to_profile(rows)
    cpu = [torch.from_numpy(x) for x in (p, q, pl, ql)]
    ref_p, ref_s = profile.profile_forward_plain(*cpu)
    got_p, got_s = profile.profile_forward(*[x.to(dev) for x in cpu])
    assert torch.equal(got_p.cpu(), ref_p)
    assert torch.equal(got_s.cpu(), ref_s)


def _band_batch(rng, B, M, N):
    """B near-diagonal windows with fractional multi-row profiles, one
    with a 300-column insertion (fails the certificate) and one too short
    to band (q longer than twice p)."""
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for r in range(B):
        n = int(rng.integers(M // 2, M - 40))
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        sub = rng.random(n) < 0.02
        b[sub] = rng.integers(0, 4, int(sub.sum()))
        if r == 1:
            b = np.concatenate([b[:n // 2], rng.integers(0, 4, 300),
                                b[n // 2:]]).astype(np.uint8)
        if r == 2:
            a = a[:N // 4]
        b = b[:N]
        for arr, s, k in ((p, a, 1 + r % 3), (q, b, 1 + r % 2)):
            rows = np.stack([s] * k)
            rows[rng.random(rows.shape) < 0.005] = 4
            rows[:, (rows == 4).all(axis=0)] = 0
            arr[r, :len(s)] = profile.rows_to_profile(rows)
        pl[r], ql[r] = len(a), len(b)
    return [torch.from_numpy(x) for x in (p, q, pl, ql)]


@pytest.mark.parametrize("N,smem", [(1024, True), (1536, False)])
def test_score_forward_kernel_equals_plain(dev, monkeypatch, N, smem):
    """K9 against its plain version, and bit for bit K3's score."""
    if not smem:   # rows in global scratch instead of shared memory
        monkeypatch.setattr(profile, "PROFILE_SMEM_LIMIT", 0)
    cpu = _band_batch(np.random.default_rng(N), 6, N, N)
    ref = profile.profile_forward_scores_plain(*cpu)
    got = profile.profile_forward_scores(*[x.to(dev) for x in cpu])
    assert torch.equal(got.cpu(), ref)
    _, k3 = profile.profile_forward(*[x.to(dev) for x in cpu])
    assert torch.equal(k3, got)


@pytest.mark.parametrize("M,N", [(1024, 1024), (1536, 2304)])
def test_banded_kernels_equal_plain(dev, M, N):
    """K10, K11 and K12 against their plain versions: scores bit for bit,
    certificates, pointer bytes and walk masks equal."""
    cpu = _band_batch(np.random.default_rng(M + N), 7, M, N)
    cuda_t = [x.to(dev) for x in cpu]
    H_W = profile._band_half(N)
    ref_s, ref_c = profile.banded_forward_scores_plain(
        *cpu, profile.GAP_OPEN, profile.GAP_EXTEND, H_W)
    got_s, got_c = profile.banded_forward_scores(
        *cuda_t, profile.GAP_OPEN, profile.GAP_EXTEND, H_W)
    assert torch.equal(got_s.cpu(), ref_s)
    assert torch.equal(got_c.cpu(), ref_c)
    assert bool(ref_c[0]) and not bool(ref_c[1])
    ref_p, ref_s2, ref_c2 = profile.banded_forward_ptrs_plain(
        *cpu, profile.GAP_OPEN, profile.GAP_EXTEND, H_W)
    got_p, got_s2, got_c2 = profile.banded_forward_ptrs(
        *cuda_t, profile.GAP_OPEN, profile.GAP_EXTEND, H_W)
    assert torch.equal(got_p.cpu(), ref_p)
    assert torch.equal(got_s2.cpu(), ref_s) and torch.equal(got_c2.cpu(),
                                                            ref_c)
    T = gapped._device_tb_T(M, N)
    ref_m = profile.banded_traceback_walk_plain(ref_p, cpu[2], cpu[3], N,
                                                H_W, T)
    got_m = profile.banded_traceback_walk(got_p, cuda_t[2], cuda_t[3], N,
                                          H_W, T)
    for g, r in zip(got_m, ref_m):
        assert torch.equal(g.cpu(), r)


def test_refine_on_cuda_equals_cpu(dev):
    """align_codes with refinement: GPU kernels give the CPU tensors'
    rows."""
    from libmems_tpu_torch import align_codes
    rng = np.random.default_rng(41)
    anc = rng.integers(0, 4, 1100).astype(np.uint8)
    seqs = []
    for _ in range(4):
        s = anc.copy()
        sub = rng.random(len(s)) < 0.03
        s[sub] = rng.integers(0, 4, int(sub.sum()))
        at = int(rng.integers(100, 1000))
        seqs.append(np.concatenate([s[:at], s[at + 3:]]).astype(np.uint8))
    ref = align_codes(seqs, refine_iters=2, device="cpu")
    got = align_codes(seqs, refine_iters=2, device=dev)
    np.testing.assert_array_equal(got, ref)


def _family(G, n, rng_seed):
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    out = [anc] + [generate._mutant(rng, anc, invert=(n // 4, n // 3)
                                    if g % 2 else None)
                   for g in range(1, G)]
    ascii_ = [generate._LUT[g].copy() for g in out]
    ascii_[1][100:160] = ord("N")
    return [Genome(f"g{i}", a) for i, a in enumerate(ascii_)]


def test_pairwise_kernels_equal_plain(dev):
    """K5, K6 and K7 against their plain versions on one table: exact."""
    from libmems_tpu_torch.matchfind import _pair_pos_bits
    from libmems_tpu_torch.ops import pairwise
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls
    G = 6
    smls, seed = create_smls(_family(G, 60_000, 36), device="cpu")
    keys = torch.cat([s.keys for s in smls])
    cnts = [s.n_windows for s in smls]
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(cnts)]))
    c_sorted, src = torch.sort(pairwise.shr(keys, 1), stable=True)
    args = (c_sorted, src, keys, offs, 1000, sentinel_content(seed))
    ref = pairwise.run_flags_plain(*args)
    got = pairwise.run_flags(*[a.to(dev) if isinstance(a, torch.Tensor)
                               else a for a in args])
    for r, g in zip(ref, got):
        assert torch.equal(g.cpu(), r)
    pb = _pair_pos_bits(max(cnts))
    ref_w = pairwise.cluster_words_plain(ref, G, pb)
    got_w = pairwise.cluster_words(got, G, pb)
    assert torch.equal(got_w.cpu(), ref_w)
    cw = pairwise.usort(ref_w)
    off32 = offs[:-1].to(torch.int32)
    cnt32 = torch.tensor(cnts, dtype=torch.int32)
    seed_len = smls[0].seed_length
    for ec in (64, 1 << 14):
        ref_r = pairwise.cluster_reps_plain(cw, ec, G, pb, seed_len, off32,
                                            cnt32)
        got_r = pairwise.cluster_reps(cw.to(dev), ec, G, pb, seed_len,
                                      off32.to(dev), cnt32.to(dev))
        assert got_r.n_reps == ref_r.n_reps > 64
        for r, g in zip(ref_r[:-1], got_r[:-1]):
            assert torch.equal(g.cpu(), r)


def test_pairwise_mums_cuda_equal_cpu(dev):
    from libmems_tpu_torch import find_pairwise_mums
    gs = _family(5, 50_000, 37)
    ref = find_pairwise_mums(gs, device="cpu")
    got = find_pairwise_mums(gs, device=dev)
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


@pytest.mark.parametrize("T", [64, 4096, (1 << 14) + 3])
def test_hmm_kernel_equals_plain(dev, T):
    from libmems_tpu_torch.ops import hmm
    rng = np.random.default_rng(T)
    B = 5
    obs = rng.integers(0, 8, (B, T)).astype(np.uint8)
    blocks = np.repeat(rng.random((B, T // 64 + 1)) < 0.5, 64, 1)[:, :T]
    obs = np.where(blocks, rng.integers(0, 2, (B, T)), obs).astype(np.uint8)
    lens = np.array([T, max(T - 7, 1), max(T // 3, 1), 1, T], np.int32)
    mats = hmm.log_matrices(hmm.adapted_hoxd_params(0.45), "cpu")
    ref_p, ref_c = hmm.fb_posterior_plain(torch.from_numpy(obs),
                                          torch.from_numpy(lens), mats, 0.9)
    got_p, got_c = hmm.fb_posterior(torch.from_numpy(obs).to(dev),
                                    torch.from_numpy(lens).to(dev),
                                    tuple(m.to(dev) for m in mats), 0.9)
    assert float((got_p.cpu() - ref_p).abs().max()) <= 1e-12
    assert torch.equal(got_c.cpu(), ref_c)


def test_nine_goldens_on_cuda(dev):
    from libmems_tpu_torch import (ProgressiveConfig, apply_backbone,
                                   progressive_align,
                                   write_backbone_columns,
                                   write_backbone_seq_coordinates)
    rng = np.random.default_rng(1004)      # generate._genomes_nine
    anc = rng.integers(0, 4, size=20_000).astype(np.uint8)
    gs = []
    for gi in range(9):
        inv = (6_000, 9_000) if gi % 3 == 1 else None
        g = generate._mutant(rng, anc, mutate=0.012, invert=inv)
        gs.append(Genome(f"e{gi}", generate._LUT[g], filename=f"e{gi}.fa"))
    ivs, _ = progressive_align(gs, ProgressiveConfig(refine=False,
                                                     device=dev))
    new_ivs, segs = apply_backbone(ivs, device=dev)
    outs = {}
    for name, write, args in (
            ("nine.xmfa", write_xmfa, (new_ivs,)),
            ("nine.bbseq", write_backbone_seq_coordinates,
             (segs, len(gs))),
            ("nine.bbcols", write_backbone_columns, (segs,))):
        buf = io.StringIO()
        write(buf, *args)
        outs[name] = buf.getvalue().encode()
    for name, data in outs.items():
        with open(f"{generate.GOLDEN_DIR}/{name}", "rb") as fh:
            assert data == fh.read(), name


def test_pair_xmfa_golden_on_cuda(dev):
    rng = np.random.default_rng(1001)      # generate._genomes_pair
    anc = rng.integers(0, 4, size=60_000).astype(np.uint8)
    b = generate._mutant(rng, anc, invert=(20_000, 28_000))
    gs = [Genome("gA", generate._LUT[anc], filename="gA.fa"),
          Genome("gB", generate._LUT[b], filename="gB.fa")]
    ivs, _ = align(gs, AlignerConfig(gapped_alignment=True, device=dev))
    buf = io.StringIO()
    write_xmfa(buf, ivs)
    with open(f"{generate.GOLDEN_DIR}/pair.xmfa", "rb") as fh:
        assert buf.getvalue().encode() == fh.read()


@pytest.mark.parametrize("tol,seq_mask", [(0, 0), (0, 0b101), (2, 0)])
def test_mum_kernels_equal_plain(dev, tol, seq_mask):
    """K13, K14 and K15 against their plain versions on one G = 3 table:
    exact."""
    from libmems_tpu_torch.matchfind import _lexsort_rows, _seed_table
    from libmems_tpu_torch.ops import mums
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls
    G = 3
    smls, seed = create_smls(_family(G, 60_000, 38), device="cpu")
    keys, seg_off, content, src = _seed_table(smls)
    args = (content, src, keys, seg_off, tol, 1000, sentinel_content(seed))
    ref = mums.mum_seed_flags_plain(*args)
    got = mums.mum_seed_flags(*[a.to(dev) if isinstance(a, torch.Tensor)
                                else a for a in args])
    assert got.n_rows == ref.n_rows > 1000
    for r, g in zip(ref, got):
        if isinstance(r, torch.Tensor):
            assert torch.equal(g.cpu(), r)
    pos_bits = keys.shape[0].bit_length()
    ref_c = mums.mum_candidates_plain(ref, G, seq_mask, pos_bits)
    got_c = mums.mum_candidates(got, G, seq_mask, pos_bits)
    for r, g in zip(ref_c, got_c):
        assert torch.equal(g.cpu(), r)
    order = _lexsort_rows(list(ref_c.words) + [ref_c.posref])
    words = torch.index_select(ref_c.words, 1, order)
    posref = ref_c.posref[order]
    seed_len = smls[0].seed_length
    for ec in (64, 1 << 14):
        ref_r = mums.mum_reps_plain(words, posref, ec, G, pos_bits, seed_len)
        got_r = mums.mum_reps(words.to(dev), posref.to(dev), ec, G, pos_bits,
                              seed_len)
        assert got_r.n_reps == ref_r.n_reps > 64
        for r, g in zip(ref_r[:-1], got_r[:-1]):
            assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("G", [64, 100])
def test_mum_kernels_wide_rows_equal_plain(dev, G):
    """K14 and K15 above 62 genomes, where the signature's mask and sign
    fields span several words: exact against their plain versions, and
    the device pipeline on the GPU equals it on CPU tensors."""
    from libmems_tpu_torch.matchfind import (_lexsort_rows, _seed_table,
                                             find_mums_device)
    from libmems_tpu_torch.ops import mums
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls
    smls, seed = create_smls(_family(G, 3_000, 41), device="cpu")
    keys, seg_off, content, src = _seed_table(smls)
    flags = mums.mum_seed_flags_plain(content, src, keys, seg_off, 0, 1000,
                                      sentinel_content(seed))
    assert flags.n_rows > 100
    pos_bits = keys.shape[0].bit_length()
    ref_c = mums.mum_candidates_plain(flags, G, 0, pos_bits)
    got_c = mums.mum_candidates(
        mums.MumFlags(*[x.to(dev) if isinstance(x, torch.Tensor) else x
                        for x in flags]), G, 0, pos_bits)
    for r, g in zip(ref_c, got_c):
        assert torch.equal(g.cpu(), r)
    assert (ref_c.starts != 0).sum(dim=1).max() > 62
    order = _lexsort_rows(list(ref_c.words) + [ref_c.posref])
    words = torch.index_select(ref_c.words, 1, order)
    posref = ref_c.posref[order]
    seed_len = smls[0].seed_length
    ref_r = mums.mum_reps_plain(words, posref, 1 << 13, G, pos_bits,
                                seed_len)
    got_r = mums.mum_reps(words.to(dev), posref.to(dev), 1 << 13, G,
                          pos_bits, seed_len)
    assert got_r.n_reps == ref_r.n_reps > 0
    for r, g in zip(ref_r[:-1], got_r[:-1]):
        assert torch.equal(g.cpu(), r)
    gpu = create_smls(_family(G, 3_000, 41), seed, device=dev)[0]
    for a, b in zip(find_mums_device(gpu)[:3], find_mums_device(smls)[:3]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("G", [3, 9])
def test_extend_kernel_many_genomes_equals_plain(dev, G):
    """K2 on rows of G genomes (dynamic shared memory per row)."""
    from libmems_tpu_torch.matchfind import find_mums_device
    from libmems_tpu_torch.sml import create_smls
    smls, seed = create_smls(_family(G, 40_000, 39), device="cpu")
    keys = torch.cat([s.keys for s in smls])
    seed_len = smls[0].seed_length
    rng = np.random.default_rng(G)
    # candidate rows: every genome at the ancestor's positions, some
    # genomes absent
    R = 400
    cnts = np.array([s.n_windows for s in smls])
    pos = rng.integers(0, cnts.min() - 1, R)
    lefts = torch.from_numpy(np.repeat(pos[:, None], G, 1).astype(np.int32))
    present = torch.from_numpy(rng.random((R, G)) < 0.8)
    present[:, 0] = True
    is_fwd = torch.ones((R, G), dtype=torch.bool)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(cnts)[:-1]])
                           .astype(np.int32))[None].expand(R, G).contiguous()
    cnt = torch.from_numpy(cnts.astype(np.int32))[None].expand(R, G)
    args = [keys, seed_len, 256, off, cnt.contiguous(), lefts, present,
            is_fwd, torch.full((R,), seed_len, dtype=torch.int32),
            mers.key_sentinel(seed)]
    ref = extend.extend_matches_plain(*args)
    got = extend.extend_matches(*[x.to(dev) if isinstance(x, torch.Tensor)
                                  else x for x in args])
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    assert int(ref[1].max()) > seed_len
    # and the whole pipeline: GPU equals CPU tensors
    gpu = create_smls(_family(G, 40_000, 39), seed, device=dev)[0]
    for a, b in zip(find_mums_device(gpu)[:3], find_mums_device(smls)[:3]):
        assert torch.equal(a.cpu(), b)


def test_three_genome_align_on_cuda_equals_cpu(dev):
    """A divergent trio with an unrelated block in each genome: the
    recursion's three-genome gap searches, 2+1-row node windows at full
    width and, for the block's 1536-column window, the banded kernels;
    GPU XMFA and anchors equal CPU tensors'."""
    from libmems_tpu_torch.ops import profile
    rng = np.random.default_rng(42)
    anc = rng.integers(0, 4, 40_000).astype(np.uint8)
    gs = []
    for i in range(3):
        g = generate._mutant(rng, anc, mutate=0.03, indel=0.002)
        block = rng.integers(0, 4, 1_100 + 150 * i).astype(np.uint8)
        g = np.concatenate([g[:20_000], block, g[20_000:]])
        gs.append(Genome(f"g{i}", generate._LUT[g]))
    cfg = dict(gapped_alignment=True, recursive=True)
    out = {}
    profile.banded_forward_ptrs.launches = 0
    for d in ("cpu", dev):
        ivs, mums_ = align(gs, AlignerConfig(device=d, **cfg))
        buf = io.StringIO()
        write_xmfa(buf, ivs)
        out[str(d)] = (buf.getvalue(), mums_)
    assert profile.banded_forward_ptrs.launches > 0
    (xmfa_cpu, mums_cpu), (xmfa_gpu, mums_gpu) = out["cpu"], out[str(dev)]
    assert xmfa_gpu == xmfa_cpu
    np.testing.assert_array_equal(mums_gpu.starts, mums_cpu.starts)


def _repeat_genome(n, rng_seed):
    """A genome with an N run, a poly-A run and a duplicated segment."""
    rng = np.random.default_rng(rng_seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[n // 2:n // 2 + 2_000] = codes[1_000:3_000]
    asc = generate._LUT[codes].copy()
    asc[5_000:5_300] = ord("N")
    asc[7_000:9_000] = ord("A")
    return Genome("r", asc)


@pytest.mark.parametrize("weight,circular", [(11, False), (17, False),
                                             (15, True)])
def test_seed_run_counts_kernel_equals_plain(dev, weight, circular):
    """K16 against its plain version: u32 and u64 key sentinels, a linear
    genome's tail positions, a circular genome."""
    from libmems_tpu_torch.ops import seedocc
    from libmems_tpu_torch.sml import SortedMerList
    g = _repeat_genome(60_000, weight)
    seed = seeds.get_seed(weight)
    sml = SortedMerList.create(g, seed, circular=circular, device="cpu")
    sent = mers.key_sentinel(seed)
    ref = seedocc.seed_run_counts_plain(sml.sorted_keys,
                                        sml.sorted_positions, sml.length,
                                        sent)
    got = seedocc.seed_run_counts(sml.sorted_keys.to(dev),
                                  sml.sorted_positions.to(dev), sml.length,
                                  sent)
    assert torch.equal(got.cpu(), ref)
    assert int(ref.max()) > 1_000 and int((ref == 1).sum()) > 1_000


@pytest.mark.parametrize("seed_len,n", [(21, 50_000), (21, 1), (0, 100),
                                        (37, 30)])
def test_seed_smooth_kernel_equals_plain(dev, seed_len, n):
    """K17 against its plain version, bit for bit: window sums above
    2^24, a window longer than the genome, the pass-through cases."""
    from libmems_tpu_torch.ops import seedocc
    rng = np.random.default_rng(n)
    count = rng.integers(1, 1 << 22, n).astype(np.int32)
    count[rng.random(n) < 0.5] = 1
    ref = seedocc.seed_smooth_plain(torch.from_numpy(count), seed_len)
    got = seedocc.seed_smooth(torch.from_numpy(count).to(dev), seed_len)
    assert torch.equal(got.cpu(), ref)


def _pair_keys(weight, n, rng_seed):
    from libmems_tpu_torch.sml import create_smls
    gs = _family(2, n, rng_seed)
    smls, seed = create_smls(gs, seeds.get_seed(weight), device="cpu")
    pb = max(max(s.n_windows for s in smls).bit_length(), 8)
    return smls, seed, pb


@pytest.mark.parametrize("weight,n", [(15, 60_000), (25, 1_500)])
def test_pair_cluster_words_kernel_equals_plain(dev, weight, n):
    """K18 against its plain version; at weight 25 and 1.5 kbp the seed
    words use bit 63."""
    from libmems_tpu_torch.ops import pair
    smls, seed, pb = _pair_keys(weight, n, 43)
    sent = mers.sentinel_content(seed)
    ref, ref_n = pair.pair_cluster_words_plain(smls[0].keys, smls[1].keys,
                                               pb, sent)
    got, got_n = pair.pair_cluster_words(smls[0].keys.to(dev),
                                         smls[1].keys.to(dev), pb, sent)
    assert got_n == ref_n > 2
    assert torch.equal(got.cpu(), ref)


def test_pair_reps_kernel_equals_plain(dev):
    """K19 against its plain version, with fewer and with more extension
    rows than representatives."""
    from libmems_tpu_torch.ops import pair, pairwise
    smls, seed, pb = _pair_keys(15, 60_000, 44)
    cw, _ = pair.pair_cluster_words_plain(smls[0].keys, smls[1].keys, pb,
                                          mers.sentinel_content(seed))
    cw = pairwise.usort(cw)
    seed_len = smls[0].seed_length
    for ec in (16, 1 << 14):
        ref = pair.pair_reps_plain(cw, ec, pb, seed_len)
        got = pair.pair_reps(cw.to(dev), ec, pb, seed_len)
        assert got.n_reps == ref.n_reps > 16
        for r, g in zip(ref[:-1], got[:-1]):
            assert torch.equal(g.cpu(), r)


def test_pairwise_host_path_on_cuda_equals_fused(dev):
    """_find_pairwise_mums_host with K5 and K2 on the card gives the
    fused seeder's matches."""
    from libmems_tpu_torch import find_pairwise_mums
    from libmems_tpu_torch.matchfind import _find_pairwise_mums_host
    from libmems_tpu_torch.sml import create_smls
    smls, _ = create_smls(_family(5, 50_000, 45), device=dev)
    host = _find_pairwise_mums_host(smls)
    fused = find_pairwise_mums(smls)
    assert len(fused) > 50
    np.testing.assert_array_equal(host.starts, fused.starts)
    np.testing.assert_array_equal(host.lengths, fused.lengths)


def _copies_rows(G, R=6, unit_len=200, spacer=30, rng_seed=0):
    """K2's arguments for R rows of G slots: one genome holding G copies
    of an element (every seventh inverted, every fifth with a
    substitution near its end) between random spacers; row r places
    every slot at offset 20 + 17 r of its copy; some slots absent and the
    last row empty."""
    rng = np.random.default_rng(rng_seed)
    seed = seeds.get_seed(11)
    seed_len = seeds.seed_length(seed)
    unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    parts, starts, pos = [], [], 0
    for g in range(G):
        u = unit.copy()
        if g % 5 == 0:
            k = unit_len - 40 + g % 30
            u[k] = (u[k] + 1) % 4
        fwd = g % 7 != 0
        parts += [rng.integers(0, 4, spacer).astype(np.uint8),
                  u if fwd else 3 - u[::-1]]
        starts.append((pos + spacer, fwd))
        pos += spacer + unit_len
    keys = mers.canonical_seed_keys_plain(
        torch.from_numpy(np.concatenate(parts)), seed)
    lefts = np.zeros((R, G), np.int32)
    is_fwd = np.ones((R, G), bool)
    for r in range(R):
        off = 20 + 17 * r
        for g, (p0, fwd) in enumerate(starts):
            lefts[r, g] = p0 + off if fwd else p0 + unit_len - off - seed_len
            is_fwd[r, g] = fwd
    present = np.ones((R, G), bool)
    present[2, :3] = False
    present[R - 1] = False
    return [keys, seed_len, 128, torch.zeros((R, G), dtype=torch.int32),
            torch.full((R, G), keys.shape[0], dtype=torch.int32),
            torch.from_numpy(lefts), torch.from_numpy(present),
            torch.from_numpy(is_fwd),
            torch.full((R,), seed_len, dtype=torch.int32),
            mers.key_sentinel(seed)]


@pytest.mark.parametrize("G,scratch", [(63, False), (64, False),
                                       (64, True), (1000, False),
                                       (1000, True), (3000, False)])
def test_extend_kernel_wide_rows_equal_plain(dev, G, scratch):
    """K2 above 62 slots a row: the row state in shared memory (above
    48 KB at G = 3000) or, when `scratch` asks for it, in global
    scratch."""
    args = _copies_rows(G)
    ref = extend.extend_matches_plain(*args)
    got = extend.extend_matches(*[x.to(dev) if isinstance(x, torch.Tensor)
                                  else x for x in args], scratch=scratch)
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    assert int(ref[1][0]) > args[1]


def test_find_repeats_and_find_mums_wide_on_cuda_equal_cpu(dev):
    """find_repeats on a genome with 1,000 copies of an element (rows of
    1,000 slots) and find_mums on 64 genomes (the device pipeline, K2 rows
    of 64 slots): the GPU gives the CPU tensors' result."""
    from libmems_tpu_torch import find_mums
    from libmems_tpu_torch.repeats import find_repeats
    rng = np.random.default_rng(47)
    elem = rng.integers(0, 4, 120).astype(np.uint8)
    parts = []
    for k in range(1000):
        e = elem.copy()
        if k % 3 == 0:
            e[80 + k % 30] = (e[80 + k % 30] + 1) % 4
        parts += [rng.integers(0, 4, 40).astype(np.uint8),
                  e if k % 5 else 3 - e[::-1]]
    text = "".join("ACGT"[x] for x in np.concatenate(parts))
    seed = seeds.get_seed(13)
    got = find_repeats(text, seed=seed, device=dev)
    ref = find_repeats(text, seed=seed, device="cpu")
    assert got.starts.shape[1] == 1000
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    base = rng.integers(0, 4, 3_000).astype(np.uint8)
    gs = []
    for g in range(64):
        s = base.copy()
        m = rng.random(len(s)) < 0.01
        s[m] = rng.integers(0, 4, int(m.sum()))
        gs.append(Genome(f"m{g}", generate._LUT[s].copy()))
    got = find_mums(gs, device=dev)
    ref = find_mums(gs, device="cpu")
    assert len(ref) > 0 and (ref.multiplicity() == 64).any()
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


def _gotoh_batch(B, M, N, rng_seed):
    """A padded batch of related pairs (full, partial and empty rows)."""
    rng = np.random.default_rng(rng_seed)
    a = np.zeros((B, M), np.uint8)
    b = np.zeros((B, N), np.uint8)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    for r in range(B):
        la = M if r == 0 else int(rng.integers(0, M + 1))
        lb = N if r == 0 else int(rng.integers(0, N + 1))
        x = rng.integers(0, 4, max(la, lb)).astype(np.uint8)
        y = x.copy()
        sub = rng.random(len(y)) < 0.03
        y[sub] = rng.integers(0, 4, int(sub.sum()))
        if len(y) > 40:
            y = np.concatenate([y[:20], y[27:]])
        a[r, :la] = x[:la]
        b[r, :lb] = np.resize(y, lb) if lb else y[:0]
        a_len[r], b_len[r] = la, lb
    return [torch.from_numpy(x) for x in (a, b, a_len, b_len)]


@pytest.mark.parametrize("B,M,N,scratch", [(3, 128, 130, False),
                                           (2, 256, 2047, False),
                                           (2, 128, 1500, True)])
def test_gotoh_kernels_equal_plain(dev, B, M, N, scratch):
    """K22 (score, carries; score only) and K23 (from the first row and
    from a carry, unpacked and packed) against their plain versions:
    exact.  N = 2047 runs two tiles a row; `scratch` keeps the rows in
    global memory."""
    from libmems_tpu_torch.ops import gapped as gp
    K = 128
    t = _gotoh_batch(B, M, N, M + N)
    td = [x.to(dev) for x in t]
    ref = gp.gotoh_forward_plain(*t, gp.GAP_OPEN, gp.GAP_EXTEND, K)
    got = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K,
                           scratch=scratch)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    s_only = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K,
                              carries=False, scratch=scratch)[0]
    assert torch.equal(s_only.cpu(), ref[0])
    for packed in (False, True):
        r0 = gp.gotoh_block_ptrs_plain(None, None, t[0], t[1], gp.GAP_OPEN,
                                       gp.GAP_EXTEND, packed)
        g0 = gp.gotoh_block_ptrs(None, None, td[0], td[1], packed=packed,
                                 scratch=scratch)
        assert torch.equal(g0.cpu(), r0)
        bi = M // K - 1
        blk = t[0][:, bi * K:(bi + 1) * K].contiguous()
        r1 = gp.gotoh_block_ptrs_plain(ref[1][bi], ref[2][bi], blk, t[1],
                                       gp.GAP_OPEN, gp.GAP_EXTEND, packed)
        g1 = gp.gotoh_block_ptrs(got[1][bi], got[2][bi], blk.to(dev), td[1],
                                 packed=packed, scratch=scratch)
        assert torch.equal(g1.cpu(), r1)


def test_align_pairs_on_cuda_equals_cpu(dev, monkeypatch):
    """align_pairs and align_score on the card equal the CPU tensors on
    both routes (K23 + K4; K22 + packed K23 + the host walk)."""
    from libmems_tpu_torch.ops import gapped as gp
    rng = np.random.default_rng(48)
    pairs = []
    for n in (5, 30, 60, 200, 700):
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        sub = rng.random(n) < 0.05
        b[sub] = rng.integers(0, 4, int(sub.sum()))
        pairs += [(a, np.concatenate([b[:n // 3], b[n // 3 + 4:]])),
                  (a, rng.integers(0, 4, n // 2 + 1).astype(np.uint8))]
    for budget in (gp.DEVICE_TB_BUDGET, 0):
        monkeypatch.setattr(gp, "DEVICE_TB_BUDGET", budget)
        got = gp.align_pairs(pairs, device=dev)
        ref = gp.align_pairs(pairs, device="cpu")
        for (ga, gb), (ra, rb) in zip(got, ref):
            np.testing.assert_array_equal(ga, ra)
            np.testing.assert_array_equal(gb, rb)
    for a, b in pairs[:4]:
        assert gp.align_score(a, b, device=dev) == \
            gp.align_score(a, b, device="cpu")


@pytest.mark.parametrize("T", [64, 4096, (1 << 14) + 3])
def test_hmm_decode_kernels_equal_plain(dev, T):
    """K20 (exact) and K21 (1e-12 relative) against their plain versions
    on ragged batches; viterbi_homologous and baum_welch on the card
    against CPU tensors."""
    from libmems_tpu_torch.ops import hmm
    rng = np.random.default_rng(T + 1)
    B = 5
    obs = rng.integers(0, 8, (B, T)).astype(np.uint8)
    blocks = np.repeat(rng.random((B, T // 64 + 1)) < 0.5, 64, 1)[:, :T]
    obs = np.where(blocks, rng.integers(0, 2, (B, T)), obs).astype(np.uint8)
    lens = np.array([T, max(T - 7, 1), max(T // 3, 1), 1, 0], np.int32)
    mats = hmm.log_matrices(hmm.adapted_hoxd_params(0.45), "cpu")
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    md = tuple(m.to(dev) for m in mats)
    ref = hmm.viterbi_path_plain(o, n, mats)
    got = hmm.viterbi_path(o.to(dev), n.to(dev), md)
    assert torch.equal(got.cpu(), ref)
    ref = hmm.bw_counts_plain(o, n, mats)
    got = hmm.bw_counts(o.to(dev), n.to(dev), md).cpu()
    rel = (got - ref).abs() / ref.abs().clamp(min=1e-300)
    assert float(rel.max()) <= 1e-12
    assert torch.equal(got[4], torch.zeros(hmm.BW_COUNTS, dtype=torch.float64))
    seqs = [obs[r, :lens[r]] for r in range(B)]
    for g, r in zip(hmm.viterbi_homologous(seqs, device=dev),
                    hmm.viterbi_homologous(seqs, device="cpu")):
        np.testing.assert_array_equal(g, r)
    gp_, gl = hmm.baum_welch(seqs, iterations=2, device=dev)
    rp, rl = hmm.baum_welch(seqs, iterations=2, device="cpu")
    np.testing.assert_allclose(gl, rl, rtol=1e-12, atol=0)
    np.testing.assert_allclose(gp_.emit_homologous, rp.emit_homologous,
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("n", [(1 << 17) + 5, (1 << 20) + 3])
def test_hmm_scan_kernels_equal_plain(dev, n):
    """K8 and K21 on the chunked route (padded widths from FB_SCAN_MIN_T
    on) against their plain versions on a ragged batch: the longest row,
    rows ending on a chunk boundary and one past it, length 1 and 0 (K21
    only); posteriors within 1e-12 with calls equal, counts within 1e-12
    relative; predict_homologous on the card equals CPU tensors."""
    from libmems_tpu_torch.ops import hmm
    K = hmm.FB_SCAN_COLS
    T = 1 << (n - 1).bit_length()
    assert T >= hmm.FB_SCAN_MIN_T
    rng = np.random.default_rng(n)
    lens = np.array([n, n - 999, 37 * K, 37 * K + 1, 1, 3 * K + 77],
                    np.int32)
    obs = rng.integers(0, 8, (len(lens), T)).astype(np.uint8)
    blocks = np.repeat(rng.random((len(lens), T // 4096)) < 0.5, 4096, 1)
    obs = np.where(blocks, rng.integers(0, 2, obs.shape), obs)
    obs = obs.astype(np.uint8)
    mats = hmm.log_matrices(hmm.adapted_hoxd_params(0.45), "cpu")
    md = tuple(m.to(dev) for m in mats)
    o, m = torch.from_numpy(obs), torch.from_numpy(lens)
    ref_p, ref_c = hmm.fb_posterior_plain(o, m, mats, 0.9)
    got_p, got_c = hmm.fb_posterior(o.to(dev), m.to(dev), md, 0.9)
    assert float((got_p.cpu() - ref_p).abs().max()) <= 1e-12
    assert torch.equal(got_c.cpu(), ref_c)
    assert 0.1 < float(ref_c[0, :n].double().mean()) < 0.9
    m0 = torch.from_numpy(np.append(lens[:-1], 0).astype(np.int32))
    ref = hmm.bw_counts_plain(o, m0, mats)
    got = hmm.bw_counts(o.to(dev), m0.to(dev), md).cpu()
    rel = (got - ref).abs() / ref.abs().clamp(min=1e-300)
    assert float(torch.where(got == ref, 0.0, rel).max()) <= 1e-12
    assert torch.equal(got[-1], torch.zeros(hmm.BW_COUNTS,
                                            dtype=torch.float64))
    if n < (1 << 18):
        # the sequential kernel, forced at this width, against its plain
        # version on the longest row and the one past a chunk boundary
        two = (o[[0, 3]].contiguous(), m[[0, 3]].contiguous())
        sp, sc = hmm.fb_sequential_plain(*two, mats, 0.9)
        kp, kc = hmm.fb_posterior(two[0].to(dev), two[1].to(dev), md, 0.9,
                                  sequential=True)
        assert float((kp.cpu() - sp).abs().max()) <= 1e-12
        assert torch.equal(kc.cpu(), sc)
        seqs = [obs[r, :lens[r]] for r in range(len(lens))]
        for g, r in zip(hmm.predict_homologous(seqs, device=dev),
                        hmm.predict_homologous(seqs, device="cpu")):
            np.testing.assert_array_equal(g, r)


def _fractional(rng, B, M, N, n_p, n_q):
    """Profiles of n_p and n_q aligned rows with gaps (one row: one-hot)
    whose lengths leave padded rows and columns."""
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = rng.integers(M * 3 // 4, M - 7, B).astype(np.int32)
    ql = rng.integers(N * 3 // 4, N - 3, B).astype(np.int32)
    for r in range(B):
        for arr, n, k in ((p, pl[r], n_p), (q, ql[r], n_q)):
            rows = np.repeat(rng.integers(0, 4, (1, n)), k, 0).astype(
                np.uint8)
            if k > 1:
                rows[rng.random((k, n)) < 0.1] = 4
                mut = rng.random((k, n)) < 0.05
                rows[mut] = rng.integers(0, 4, int(mut.sum()))
                rows[:, (rows == 4).all(axis=0)] = 0
            arr[r, :n] = profile.rows_to_profile(rows)
    return [torch.from_numpy(x) for x in (p, q, pl, ql)]


@pytest.mark.parametrize("n_p,n_q,M,N,smem", [
    (1, 1, 256, 700, True), (3, 2, 384, 1000, True),
    (3, 2, 256, 700, False), (4, 5, 256, 12_160, True)])
def test_ckpt_kernels_equal_plain(dev, monkeypatch, n_p, n_q, M, N, smem):
    """K24 (score, ck_h, ck_f) and K25 (every block's packed pointer
    bytes) equal their plain versions exactly, with the rows in shared memory
    and in global scratch (the limit forced to 0, or N = 12,160 columns,
    17 bytes each, above PROFILE_SMEM_LIMIT)."""
    if not smem:
        monkeypatch.setattr(profile, "PROFILE_SMEM_LIMIT", 0)
    cpu = _fractional(np.random.default_rng(M + N + n_p), 2, M, N, n_p, n_q)
    gpu = [x.to(dev) for x in cpu]
    K = profile.CKPT_ROWS
    ref = profile.profile_forward_ckpt_plain(*cpu, K=K)
    got = profile.profile_forward_ckpt(*gpu, K=K)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert torch.equal(got[0], profile.profile_forward_scores(*gpu))
    for bi in range(M // K):
        pb = cpu[0][:, bi * K:(bi + 1) * K].contiguous()
        want = profile.profile_block_ptrs_plain(ref[1][bi], ref[2][bi], pb,
                                                cpu[1], cpu[3])
        g = profile.profile_block_ptrs(got[1][bi], got[2][bi], pb.to(dev),
                                       gpu[1], gpu[3])
        assert torch.equal(g.cpu(), want), bi


def test_ckpt_route_equals_one_launch_on_cuda(dev, monkeypatch):
    """Phase "bounded"'s route equality at about 8,000 columns: with
    PTR_BUDGET lowered below one window's pointers, the uncertified
    window (unrelated sequences) takes K24 + K25 + the host walk, the
    near-diagonal one still certifies banded, and the merged rows equal
    the one-launch route's (K3 + K4)."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 4, 8_000).astype(np.uint8)
    b = a.copy()
    m = rng.random(8_000) < 0.01
    b[m] = (b[m] + 1) % 4
    p_rows = [rng.integers(0, 4, (1, 8_000)).astype(np.uint8), a[None]]
    q_rows = [rng.integers(0, 4, (1, 7_900)).astype(np.uint8), b[None]]
    whole = profile.align_profile_batch(p_rows, q_rows, device=dev)
    Mp, N = profile.padded_rows(profile._bucket_cols(8_000)), \
        profile._bucket_cols(8_000)
    monkeypatch.setattr(profile, "PTR_BUDGET", Mp * (N + 1) - 1)
    before = profile.CKPT_STATS["windows"]
    n24 = profile.profile_forward_ckpt.launches
    got = profile.align_profile_batch(p_rows, q_rows, device=dev)
    assert profile.CKPT_STATS["windows"] - before == 1
    assert profile.profile_forward_ckpt.launches - n24 == 1
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("weight,cap", [(11, 1 << 20), (17, 1 << 20),
                                        (17, 3_000)])
def test_route_fill_kernel_equals_plain(dev, weight, cap):
    """K26 against its plain version on one shard's slice of a pair's
    table, u32 and u64 keys with masked windows, with and without rows
    past the capacity: exact (send buffers and the drop count)."""
    from libmems_tpu_torch.ops import shard
    seed = seeds.get_seed(weight)
    rng = np.random.default_rng(weight)
    codes = torch.from_numpy(rng.integers(0, 4, 100_000).astype(np.uint8))
    ambig = torch.from_numpy(rng.random(100_000) < 0.001)
    keys = mers.canonical_seed_keys_plain(codes, seed, ambig)
    for n_dev in (3, 4):
        args = (keys, 777, mers.key_sentinel(seed), n_dev, cap)
        ref = shard.route_fill_plain(*args)
        got = shard.route_fill(keys.to(dev), *args[1:])
        assert torch.equal(got.keys.cpu(), ref.keys)
        assert torch.equal(got.src.cpu(), ref.src)
        assert int(got.dropped) == int(ref.dropped)
        assert (int(ref.dropped) > 0) == (cap < 10_000)


def _routed_flags(dev, G=3, n=40_000):
    """K13's flags of shard 0's routed table of a G-genome family, on
    CPU tensors and on dev."""
    from libmems_tpu_torch.ops import mums
    from libmems_tpu_torch.ops.mers import key_sentinel, sentinel_content
    from libmems_tpu_torch.parallel import shard as psh
    from libmems_tpu_torch.sml import create_smls
    smls, seed = create_smls(_family(G, n, 38), device="cpu")
    lay = psh._Layout(smls, psh.Mesh(["cpu"] * 2))
    tables, dropped = psh._route(psh.Mesh(["cpu"] * 2), lay.slices,
                                 key_sentinel(seed), 1 << 20)
    assert dropped == 0
    content, src, _ = tables[0]
    keys, seg_off = lay.keys[torch.device("cpu")], \
        lay.seg_off[torch.device("cpu")]
    args = (content, src, keys, seg_off, 0, 1000, sentinel_content(seed))
    return (mums.mum_seed_flags(*args),
            mums.mum_seed_flags(*[a.to(dev) if isinstance(a, torch.Tensor)
                                  else a for a in args]),
            smls[0].seed_length)


def test_shard_candidates_kernel_equals_plain(dev):
    """K27 against its plain version on a shard's routed table, with a
    capacity above and below the surviving runs (the dump row): exact."""
    from libmems_tpu_torch.ops import shard
    ref_f, got_f, seed_len = _routed_flags(dev)
    assert got_f.n_rows == ref_f.n_rows > 1000
    for capacity in (1 << 20, ref_f.n_rows // 3):
        ref = shard.shard_candidates_plain(ref_f, 3, capacity, seed_len)
        got = shard.shard_candidates(got_f, 3, capacity, seed_len)
        assert got.over == ref.over == max(ref_f.n_rows - capacity, 0)
        for r, g in zip(ref[:-1], got[:-1]):
            assert torch.equal(g.cpu(), r)


def test_dedup_flags_kernel_equals_plain(dev):
    """K28 against its plain version on rows with many exact repeats and
    invalid rows: exact (sorted rows, lengths, flags)."""
    from libmems_tpu_torch.ops import shard
    rng = np.random.default_rng(28)
    m, G = 200_000, 3
    cpu = (torch.from_numpy(rng.integers(0, 50, (m, G)).astype(np.int32)),
           torch.from_numpy(rng.random((m, G)) < 0.8),
           torch.from_numpy(rng.random((m, G)) < 0.5),
           torch.from_numpy(rng.integers(20, 23, m).astype(np.int32)),
           torch.from_numpy(rng.random(m) < 0.9))
    ref = shard.dedup_flags_plain(*cpu)
    got = shard.dedup_flags(*[x.to(dev) for x in cpu])
    for r, g in zip(ref, got):
        assert torch.equal(g.cpu(), r)
    assert 0 < int(ref.uniq.sum()) < m


def test_shard_kernels_count_only_launches(dev):
    """K26-K28 count a launch only where their kernel runs: empty inputs
    return the plain version's empty results and leave the counts as
    they were; a meshed seeding whose last slice is empty (3 x 38 kbp
    over 4 shards) counts K26 once per non-empty slice."""
    from libmems_tpu_torch.ops import shard
    from libmems_tpu_torch.parallel import shard as psh
    from libmems_tpu_torch.sml import create_smls
    wrappers = (shard.route_fill, shard.shard_candidates, shard.dedup_flags)
    before = [w.launches for w in wrappers]
    empty = torch.zeros(0, dtype=torch.int64)
    args = (empty, 0, -1, 4, 256)
    ref = shard.route_fill_plain(*args)
    got = shard.route_fill(empty.to(dev), *args[1:])
    assert torch.equal(got.keys.cpu(), ref.keys)
    assert torch.equal(got.src.cpu(), ref.src)
    assert int(got.dropped) == 0
    cols = (torch.zeros((0, 3), dtype=torch.int32),
            torch.zeros((0, 3), dtype=torch.bool),
            torch.zeros((0, 3), dtype=torch.bool),
            torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.bool))
    got = shard.dedup_flags(*[x.to(dev) for x in cols])
    assert [tuple(x.shape) for x in got] == [(0, 3), (0,), (0,)]
    assert [w.launches for w in wrappers] == before
    mesh = psh.Mesh([dev] * 4)
    smls, _ = create_smls(_family(3, 38_000, 38), device=dev)
    nonempty = sum(k.shape[0] > 0 for k, _ in psh._Layout(smls, mesh).slices)
    assert nonempty == 3
    n26 = shard.route_fill.launches
    psh.sharded_find_mums(smls, mesh)
    assert shard.route_fill.launches - n26 == nonempty


def _sharded_cuda_vs_cpu(mesh):
    """sharded_find_mums and sharded_find_pairwise_mums on `mesh` equal
    the same calls on CPU shards; the kernels K26-K28 launched."""
    from libmems_tpu_torch.ops import shard
    from libmems_tpu_torch.parallel import shard as psh
    from libmems_tpu_torch.sml import create_smls
    fam = _family(3, 40_000, 38)
    dev = mesh.devices[0]
    smls_g, _ = create_smls(fam, device=dev)
    smls_c, _ = create_smls(fam, device="cpu")
    cpu_mesh = psh.Mesh(["cpu"] * mesh.size)
    wrappers = (shard.route_fill, shard.shard_candidates, shard.dedup_flags)
    before = [w.launches for w in wrappers]
    got = psh.sharded_find_mums(smls_g, mesh)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    ref = psh.sharded_find_mums(smls_c, cpu_mesh)
    assert len(ref) > 100
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    got = psh.sharded_find_pairwise_mums(smls_g, mesh)
    ref = psh.sharded_find_pairwise_mums(smls_c, cpu_mesh)
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


def test_sharded_find_mums_on_cuda_equals_cpu(dev):
    from libmems_tpu_torch.parallel import shard as psh
    _sharded_cuda_vs_cpu(psh.Mesh([dev] * 4))


def test_sharded_find_mums_on_every_card_equals_cpu(dev):
    """make_mesh() over every visible card: real peer copies."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA GPUs")
    from libmems_tpu_torch.parallel import shard as psh
    _sharded_cuda_vs_cpu(psh.make_mesh())


def test_align_profile_batch_mesh_split_on_cuda_equals_whole(dev,
                                                             monkeypatch):
    """The window split of align_profile_batch over 3 shards on the card
    (the _shard_* wrappers): merged rows equal the whole batch's, on the
    banded bucket and with PTR_BUDGET lowered so the 256-column bucket
    takes the checkpointed route (K24 + K25 on each slice); the split
    banded scores equal the whole batch's (K10)."""
    from libmems_tpu_torch.parallel import shard as psh
    rng = np.random.default_rng(9)
    p_rows, q_rows = [], []
    for n in (900, 950, 700, 880, 200, 150, 180):
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        m = rng.random(n) < 0.01
        b[m] = (b[m] + 1) % 4
        p_rows.append(np.stack([a, a]))
        q_rows.append(b[None])
    mesh = psh.Mesh([dev] * 3)
    whole = profile.align_profile_batch(p_rows, q_rows, device=dev,
                                        mesh=None)
    for g, w in zip(profile.align_profile_batch(p_rows, q_rows, device=dev,
                                                mesh=mesh), whole):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setattr(profile, "PTR_BUDGET", 64 * 65 + 1)
    n24 = profile.profile_forward_ckpt.launches
    ckpt = profile.CKPT_STATS["windows"]
    for g, w in zip(profile.align_profile_batch(p_rows, q_rows, device=dev,
                                                mesh=mesh), whole):
        np.testing.assert_array_equal(g, w)
    assert profile.CKPT_STATS["windows"] - ckpt >= 3
    assert profile.profile_forward_ckpt.launches - n24 >= 3   # a slice each
    t = profile.pack_profiles(p_rows, q_rows, [0, 1, 2, 3], 1024, 1024, dev)
    H_W = profile._band_half(1024)
    want = profile.banded_forward_scores(*t, profile.GAP_OPEN,
                                         profile.GAP_EXTEND, H_W)
    got = profile.banded_scores_split(*t, profile.GAP_OPEN,
                                      profile.GAP_EXTEND, H_W, mesh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("G,n_dev,req_cap", [(2, 4, 1 << 20), (3, 4, 50),
                                             (5, 3, 1 << 20), (2, 8, 3000)])
def test_tiled_request_and_serve_kernels_equal_plain(dev, G, n_dev, req_cap):
    """K29 (with requests past req_cap) and K30 (with starts outside the
    tile) against their plain versions on both sides."""
    from libmems_tpu_torch.ops import tiled
    rng = np.random.default_rng(G * n_dev)
    R, S, C = 6_000, 1 << 14, 512
    lefts = torch.from_numpy(rng.integers(0, n_dev * S // 2, (R, G)
                                          ).astype(np.int32))
    lengths = torch.from_numpy(rng.integers(15, 400, R).astype(np.int32))
    present = torch.from_numpy(rng.random((R, G)) < 0.9)
    is_fwd = torch.from_numpy(rng.random((R, G)) < 0.5)
    gen_off = torch.from_numpy((np.arange(G) * (n_dev * S // (2 * G))
                                ).astype(np.int32))
    rows = torch.from_numpy(np.sort(rng.choice(R, 4_000, replace=False)))
    for side in (0, 1):
        args = [rows, lefts, lengths, present, is_fwd, gen_off, side, C, 15,
                C, S, n_dev, req_cap]
        ref = tiled.tiled_requests_plain(*args)
        got = tiled.tiled_requests(*[a.to(dev) if isinstance(a, torch.Tensor)
                                     else a for a in args])
        assert torch.equal(got.send.cpu(), ref.send)
        assert torch.equal(got.where.cpu(), ref.where)
        assert got.counts == ref.counts and got.dropped == ref.dropped
        assert (ref.dropped > 0) == (req_cap < 1000)
    tile = torch.from_numpy(rng.integers(-2**62, 2**62, S + C + 128))
    offs = torch.from_numpy(rng.integers(-5, S + 5, 3_000))
    ref = tiled.tiled_serve_plain(tile, S, offs, C, -1)
    assert torch.equal(tiled.tiled_serve(tile.to(dev), S, offs.to(dev), C,
                                         -1).cpu(), ref)


def _tiled_genomes(rng_seed, n=60_000):
    rng = np.random.default_rng(rng_seed)
    a = rng.integers(0, 4, n).astype(np.uint8)
    b = generate._mutant(rng, a, mutate=0.01, indel=0.0005)
    b = np.concatenate([b[n // 2:], 3 - b[:n // 2][::-1]])
    return [Genome(f"g{i}", generate._LUT[x]) for i, x in enumerate((a, b))]


def test_sharded_find_mums_tiled_on_cuda_equals_find_mums(dev, monkeypatch):
    """The tiled path on 4 shards of the card equals find_mums (which the
    CPU tests hold to the JAX package); its first K31 launches equal
    their plain version on the same inputs, on CPU tensors."""
    from libmems_tpu_torch.matchfind import find_mums
    from libmems_tpu_torch.ops import tiled
    from libmems_tpu_torch.parallel import shard as psh
    from libmems_tpu_torch.sml import create_smls
    genomes = _tiled_genomes(5)
    smls_g, _ = create_smls(genomes, device=dev)
    real = tiled.tiled_probe
    seen = []

    def both(resp, where, rows, lefts, lengths, present, is_fwd, gen_cnt,
             active, *rest):
        if len(seen) >= 8:
            return real(resp, where, rows, lefts, lengths, present, is_fwd,
                        gen_cnt, active, *rest)
        cpu = [x.cpu().clone() for x in (lefts, lengths, active)]
        tiled.tiled_probe_plain(resp.cpu(), where.cpu(), rows.cpu(), cpu[0],
                                cpu[1], present.cpu(), is_fwd.cpu(),
                                gen_cnt.cpu(), cpu[2], *rest)
        real(resp, where, rows, lefts, lengths, present, is_fwd, gen_cnt,
             active, *rest)
        seen.append(all(torch.equal(a.cpu(), b) for a, b in
                        zip((lefts, lengths, active), cpu)))
    both.launches = 0
    monkeypatch.setattr(tiled, "tiled_probe", both)
    launches = (tiled.tiled_requests.launches, tiled.tiled_serve.launches)
    got = psh.sharded_find_mums_tiled(smls_g, psh.Mesh([dev] * 4))
    monkeypatch.setattr(tiled, "tiled_probe", real)
    assert seen and all(seen)
    assert tiled.tiled_requests.launches > launches[0]
    assert tiled.tiled_serve.launches > launches[1]
    want = find_mums(smls_g)
    assert len(want) > 10
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def test_align_on_second_card_equals_first(dev):
    """Launches follow the tensors' card: with card 0 current, align on
    cuda:1 gives the XMFA bytes of cuda:0, and card 0 stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA GPUs")
    genomes = _tiled_genomes(6)
    cfg = dict(gapped_alignment=True, recursive=True)
    out = []
    with torch.cuda.device(0):
        for d in ("cuda:0", "cuda:1"):
            ivs, _ = align(genomes, AlignerConfig(device=d, **cfg))
            buf = io.StringIO()
            write_xmfa(buf, ivs)
            out.append(buf.getvalue())
            assert torch.cuda.current_device() == 0
    assert out[0] == out[1]
