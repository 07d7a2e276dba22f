"""Port parity: the seed-prefix-sharded seeders (K26-K28 with K13, K5-K7
and K2, all through their plain versions) and the mesh options of align,
progressive_align, align_profiles and align_profile_batch.  Shards run on
``Mesh([cpu] * n)``; the JAX package runs on its virtual CPU mesh
(tests/conftest.py).  Exact throughout: match sets, XMFA bytes and merged
rows equal."""

import io
import types

import numpy as np
import pytest
import torch

from libmems_tpu import matchfind as jmf
from libmems_tpu import seeds as jseeds
from libmems_tpu.aligner import AlignerConfig as JaxConfig
from libmems_tpu.aligner import align as jax_align
from libmems_tpu.interval import write_xmfa as jax_write_xmfa
from libmems_tpu.parallel import shard as jsh
from libmems_tpu.progressive import ProgressiveConfig as JaxProgressiveConfig
from libmems_tpu.progressive import align_profiles as jax_align_profiles
from libmems_tpu.progressive import progressive_align as jax_progressive
from libmems_tpu.sequence import Genome as JaxGenome
from libmems_tpu.sml import SortedMerList as JaxSML
import libmems_tpu_torch as lt
from libmems_tpu_torch.matchfind import (find_mums, find_pairwise_mums,
                                         pairwise_fused_fits)
from libmems_tpu_torch.ops import profile
from libmems_tpu_torch.parallel import shard as psh
from libmems_tpu_torch.sml import SortedMerList

CPU = torch.device("cpu")
LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mesh(n):
    return psh.Mesh([CPU] * n)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _family(rng_seed, n_genomes, length, mutate=0.02, rearrange=0):
    """tests/test_sharded_e2e.py's family: a star of mutants, each with
    `rearrange` inverted segments."""
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=length).astype(np.uint8)
    out = []
    for _ in range(n_genomes):
        g = anc.copy()
        idx = rng.random(length) < mutate
        g[idx] = rng.integers(0, 4, size=int(idx.sum())).astype(np.uint8)
        for _ in range(rearrange):
            a = int(rng.integers(0, length - 400))
            b = a + int(rng.integers(100, 400))
            g = np.concatenate([g[:a], 3 - g[a:b][::-1], g[b:]])
        out.append(g)
    return out


def _xmfa(write, ivs):
    buf = io.StringIO()
    write(buf, ivs)
    return buf.getvalue()


def _same(got, want):
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.lengths, want.lengths)


TRIO_SEED = jseeds.get_seed(11, 0)


@pytest.fixture(scope="module")
def trio():
    """tests/test_sharded_mums.py's trio, cut to 6 kbp: two mutants of
    the first genome, the third with an inverted third.  Returns (codes,
    the port's SMLs, the JAX package's SMLs)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, size=6_000).astype(np.uint8)
    b, c = a.copy(), a.copy()
    for x, rate in ((b, 0.02), (c, 0.03)):
        idx = rng.random(len(x)) < rate
        x[idx] = rng.integers(0, 4, size=int(idx.sum()))
    c = np.concatenate([c[:2_000], (3 - c[2_000:4_000])[::-1], c[4_000:]])
    codes = (a, b, c)
    return (codes,
            [SortedMerList.create(x, TRIO_SEED, device="cpu") for x in codes],
            [JaxSML.create(x, TRIO_SEED) for x in codes])


def test_sharded_find_mums_equals_jax(trio):
    """Repeat tolerance 0 here; tolerance 1 is held to the JAX seeding
    inside test_align_with_mesh_equals_jax_and_unsharded (each JAX
    sharded call compiles anew)."""
    _, smls, jsmls = trio
    want = jsh.sharded_find_mums(jsmls, jsh.make_mesh(4))
    got = psh.sharded_find_mums(smls, _mesh(4))
    assert len(want) > 10 and (want.starts < 0).any()
    _same(got, want)
    _same(got, find_mums(smls))


def test_sharded_find_mums_overflow_retries(trio, monkeypatch):
    """Undersized routing and candidate buffers double and retry
    (tests/test_sharded_mums.py:74-100): the same matches, more than one
    pass, and an error once the retries run out."""
    _, smls, _ = trio
    calls = []
    real = psh._sharded_find_mums_once

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out[1:])
        return out
    monkeypatch.setattr(psh, "_sharded_find_mums_once", spy)
    got = psh.sharded_find_mums(smls, _mesh(4), capacity=256,
                                route_cap=256, max_retries=8)
    _same(got, find_mums(smls))
    assert len(calls) >= 2
    assert any(d for d, _ in calls) and any(c for _, c in calls)
    with pytest.raises(ValueError, match="capacity"):
        psh.sharded_find_mums(smls, _mesh(4), capacity=8, max_retries=0)


@pytest.fixture(scope="module")
def five():
    seed = jseeds.get_seed(9, 0)
    fam = _family(0, 5, 4_000)
    return ([SortedMerList.create(g, seed, device="cpu") for g in fam],
            [JaxSML.create(g, seed) for g in fam])


def test_sharded_find_pairwise_mums_equals_jax(five):
    smls, jsmls = five
    want = jmf.find_pairwise_mums(jsmls)
    got = psh.sharded_find_pairwise_mums(smls, _mesh(4))
    assert len(want) > 50
    _same(got, want)
    # undersized buffers retry to the same matches
    _same(psh.sharded_find_pairwise_mums(smls, _mesh(3), capacity=256,
                                         route_cap=256, max_retries=10),
          want)
    _same(find_pairwise_mums(smls, device="cpu"), want)


def _fake_smls(n_windows, G):
    seed = jseeds.get_seed(11, 0)
    return [types.SimpleNamespace(n_windows=n_windows, seed=seed,
                                  seed_length=jseeds.seed_length(seed))
            for _ in range(G)]


@pytest.mark.parametrize("case", ["g63", "rid_bits", "cluster_word"])
def test_sharded_pairwise_refuses_what_jax_refuses(case):
    if case == "g63":
        with pytest.raises(ValueError, match="62 genomes"):
            psh.sharded_find_pairwise_mums(_fake_smls(100, 63), _mesh(2))
        return
    # 2^27 windows a genome: pos_bits 28, rid_bits 29 -> the kept-row
    # word needs 64 bits; 2^30: the cluster word too
    n = 1 << (27 if case == "rid_bits" else 30)
    smls = _fake_smls(n, 2)
    pos_bits = max(n.bit_length(), 8)
    rid_bits = (psh._bucketed_total(smls, 2) + 1).bit_length()
    assert not jmf.pairwise_fused_fits(2, pos_bits, rid_bits)
    assert not psh.sharded_pairwise_fits(2, pos_bits, rid_bits)
    assert pairwise_fused_fits(2, pos_bits) == (case == "rid_bits")
    with pytest.raises(ValueError, match="exceed 64 bits"):
        psh.sharded_find_pairwise_mums(smls, _mesh(2))


def test_align_with_mesh_equals_jax_and_unsharded(trio, monkeypatch):
    """The trio through align with a mesh and repeat_tolerance 1
    (tests/test_sharded_e2e.py:126-138): the sharded seeding (recorded on
    the JAX side) equals the JAX package's sharded_find_mums at tolerance
    1 and the port's find_mums; MUMs and XMFA equal the JAX package's
    align with make_mesh(4) and the port's without a mesh."""
    codes, smls, _ = trio
    seeded = []
    real = jsh.sharded_find_mums

    def keep(*a, **k):
        seeded.append(real(*a, **k))
        return seeded[-1]
    monkeypatch.setattr(jsh, "sharded_find_mums", keep)
    cfg = dict(seed=TRIO_SEED, repeat_tolerance=1)
    genomes = [lt.Genome(f"g{i}", LUT[a]) for i, a in enumerate(codes)]
    ivs, mums = lt.align(genomes, lt.AlignerConfig(device="cpu",
                                                   mesh=_mesh(4), **cfg))
    ref_ivs, ref_mums = jax_align(
        [JaxGenome(f"g{i}", LUT[a]) for i, a in enumerate(codes)],
        JaxConfig(mesh=jsh.make_mesh(4), **cfg))
    assert len(seeded) == 1 and len(seeded[0]) > 10
    got = psh.sharded_find_mums(smls, _mesh(4), repeat_tolerance=1)
    _same(got, seeded[0])
    _same(got, find_mums(smls, repeat_tolerance=1))
    _same(mums, ref_mums)
    assert len(ivs.intervals) > 1
    assert _xmfa(lt.write_xmfa, ivs) == _xmfa(jax_write_xmfa, ref_ivs)
    plain, _ = lt.align(genomes, lt.AlignerConfig(device="cpu", **cfg))
    assert _xmfa(lt.write_xmfa, plain) == _xmfa(lt.write_xmfa, ivs)


def test_pair_align_with_mesh_and_tolerance_equals_unsharded(monkeypatch):
    """A divergent pair with repeat_tolerance 1 takes the sharded seeding
    with a mesh (no pair fast path) and writes the unsharded XMFA."""
    gs = [lt.Genome(f"g{i}", LUT[a]) for i, a in enumerate(
        _family(5, 2, 3_000))]
    cfg = dict(device="cpu", repeat_tolerance=1, recursive=False)
    calls = []
    real = psh._sharded_find_mums_once

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(psh, "_sharded_find_mums_once", spy)
    got, _ = lt.align(gs, lt.AlignerConfig(mesh=_mesh(4), **cfg))
    ref, _ = lt.align(gs, lt.AlignerConfig(**cfg))
    assert calls and len(ref.intervals) > 0
    assert _xmfa(lt.write_xmfa, got) == _xmfa(lt.write_xmfa, ref)


@pytest.mark.parametrize("mesh", [3, "mesh"])
def test_trio_align_with_mesh_equals_unsharded(mesh):
    """Three genomes, gapped, no recursion (tests/test_sharded_e2e.py:
    83-98): a shard count or a Mesh gives the unsharded XMFA."""
    gs = [lt.Genome(f"g{i}", LUT[a])
          for i, a in enumerate(_family(2, 3, 5_000, mutate=0.01,
                                        rearrange=1))]
    base = dict(device="cpu", gapped_alignment=True, recursive=False)
    ref, ref_mums = lt.align(gs, lt.AlignerConfig(**base))
    got, mums = lt.align(gs, lt.AlignerConfig(
        mesh=_mesh(4) if mesh == "mesh" else mesh, **base))
    _same(mums, ref_mums)
    assert len(ref.intervals) > 1
    assert _xmfa(lt.write_xmfa, got) == _xmfa(lt.write_xmfa, ref)


@pytest.mark.parametrize("refine", [False, True])
def test_progressive_align_with_mesh_equals_unsharded(monkeypatch, refine):
    """progressive_align with a mesh seeds through
    sharded_find_pairwise_mums (tests/test_sharded_e2e.py:112-123) and
    writes the unsharded XMFA, with and without refinement."""
    n, length = (5, 3_000) if not refine else (4, 6_000)
    gs = [lt.Genome(f"g{i}", LUT[a]) for i, a in enumerate(
        _family(4, n, length, mutate=0.015, rearrange=1))]
    calls = []
    real = psh._sharded_pairwise_once

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(psh, "_sharded_pairwise_once", spy)
    got, _ = lt.progressive_align(gs, lt.ProgressiveConfig(
        refine=refine, device="cpu", mesh=_mesh(4)))
    ref, _ = lt.progressive_align(gs, lt.ProgressiveConfig(
        refine=refine, device="cpu"))
    assert calls
    assert len(ref.intervals) > 0
    assert _xmfa(lt.write_xmfa, got) == _xmfa(lt.write_xmfa, ref)


def test_align_profiles_with_mesh_equals_jax():
    """align_profiles accepts a mesh and ignores it, as the JAX package
    does: two 2-genome sub-alignments (tests/test_progressive_api.py:
    32-45) merge to the JAX package's XMFA bytes."""
    fam = _family(3, 4, 6_000, mutate=0.01)
    port = [lt.Genome(f"g{i}", LUT[a]) for i, a in enumerate(fam)]
    ref = [JaxGenome(f"g{i}", LUT[a]) for i, a in enumerate(fam)]
    sub = dict(refine=False, gap_search=False, use_bp_distance=False)
    p1, _ = lt.progressive_align(port[:2], lt.ProgressiveConfig(
        device="cpu", **sub))
    p2, _ = lt.progressive_align(port[2:], lt.ProgressiveConfig(
        device="cpu", **sub))
    r1, _ = jax_progressive(ref[:2], JaxProgressiveConfig(**sub))
    r2, _ = jax_progressive(ref[2:], JaxProgressiveConfig(**sub))
    assert _xmfa(lt.write_xmfa, p1) == _xmfa(jax_write_xmfa, r1)
    got = lt.align_profiles(p1, port[:2], p2, port[2:], lt.ProgressiveConfig(
        refine=False, gap_search=False, device="cpu", mesh=_mesh(2)))
    want = jax_align_profiles(r1, ref[:2], r2, ref[2:], JaxProgressiveConfig(
        refine=False, gap_search=False, mesh=jsh.make_mesh(2)))
    assert sum((iv.starts() != 0).sum() == 4 for iv in got.intervals) > 0
    assert _xmfa(lt.write_xmfa, got) == _xmfa(jax_write_xmfa, want)


def _profile_windows(rng):
    """Multi-row windows in the 1024-column (banded) bucket, one of them
    failing the certificate, and smaller full-width ones."""
    def rows(a, n_rows):
        r = np.stack([a] * n_rows)
        r[rng.random(r.shape) < 0.02] = 4
        r[:, (r == 4).all(axis=0)] = 0
        return r.astype(np.uint8)

    p_rows, q_rows = [], []
    for n, ins, n_p, n_q in ((900, 0, 3, 2), (700, 300, 1, 1),
                             (950, 6, 4, 5), (880, 0, 2, 2), (150, 0, 3, 1),
                             (200, 9, 1, 2), (60, 0, 2, 3)):
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        m = rng.random(n) < 0.01
        b[m] = (b[m] + 1) % 4
        if ins:
            b = np.concatenate([b[:n // 2], rng.integers(0, 4, ins)
                                .astype(np.uint8), b[n // 2:]])
        p_rows.append(rows(a, n_p))
        q_rows.append(rows(b, n_q))
    return p_rows, q_rows


@pytest.mark.parametrize("route", ["banded", "ckpt"])
def test_align_profile_batch_mesh_split_equals_unsplit(monkeypatch, route):
    """Each launch's windows split over three shards (the _shard_*
    wrappers of the JAX module) give the unsplit merged rows, on the
    banded bucket (K11 + K12, the uncertified window through K3 + K4) and
    with PTR_BUDGET lowered so the larger buckets take the checkpointed
    route (K24 + K25)."""
    p_rows, q_rows = _profile_windows(np.random.default_rng(21))
    if route == "ckpt":
        monkeypatch.setattr(profile, "PTR_BUDGET", 64 * 65 + 1)
    before = (dict(profile.BAND_STATS), dict(profile.CKPT_STATS))
    want = profile.align_profile_batch(p_rows, q_rows, device="cpu",
                                       mesh=None)
    mid = (dict(profile.BAND_STATS), dict(profile.CKPT_STATS))
    got = profile.align_profile_batch(p_rows, q_rows, device="cpu",
                                      mesh=_mesh(3))
    after = (dict(profile.BAND_STATS), dict(profile.CKPT_STATS))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the split runs the same routes on the same windows
    for b, m, a in zip(before, mid, after):
        assert {k: m[k] - b[k] for k in b} == {k: a[k] - m[k] for k in m}
    band = {k: mid[0][k] - before[0][k] for k in before[0]}
    assert band["certified"] >= 2 and band["fallback"] >= 1
    ckpt = mid[1]["windows"] - before[1]["windows"]
    assert (ckpt >= 2) if route == "ckpt" else ckpt == 0
    # "auto" on CPU tensors never splits
    assert profile.align_profile_batch(p_rows[:2], q_rows[:2],
                                       device="cpu")[1].shape == \
        want[1].shape


@pytest.mark.parametrize("n_dev", [2, 3])
def test_banded_scores_split_equals_unsplit(n_dev):
    """The counterpart of _shard_banded_scores: scores and certificates
    of a banded batch split over the mesh equal the whole batch's."""
    p_rows, q_rows = _profile_windows(np.random.default_rng(22))
    sub = [0, 1, 2, 3]
    t = profile.pack_profiles(p_rows, q_rows, sub, 1024, 1024, "cpu")
    H_W = profile._band_half(1024)
    want = profile.banded_forward_scores(*t, profile.GAP_OPEN,
                                         profile.GAP_EXTEND, H_W)
    got = profile.banded_scores_split(*t, profile.GAP_OPEN,
                                      profile.GAP_EXTEND, H_W,
                                      _mesh(n_dev))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[1].any() and not want[1].all()
    assert [s.stop - s.start for s in profile.mesh_slices(4, n_dev)] == \
        ([2, 2] if n_dev == 2 else [2, 2, 0])
