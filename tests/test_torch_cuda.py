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
