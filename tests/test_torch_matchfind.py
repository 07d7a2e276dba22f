"""Port parity: pair MUM discovery against the JAX package, exact, in
the default mode and the others."""

import io

import numpy as np
import pytest
import torch

from libmems_tpu import seeds as jseeds
from libmems_tpu.matchfind import find_mums as jax_find_mums
from libmems_tpu.matchfind import find_mums_device as jax_find_mums_device
from libmems_tpu.sequence import Genome as JaxGenome
from libmems_tpu.sml import SortedMerList as JaxSML
from libmems_tpu_torch import convert
from libmems_tpu_torch.match import write_match_list
from libmems_tpu_torch import matchfind
from libmems_tpu_torch.matchfind import find_mums, find_pair_mums_np
from libmems_tpu_torch.ops import pair as ops_pair
from libmems_tpu_torch.ops.mers import sentinel_content
from libmems_tpu_torch.sequence import Genome
from libmems_tpu_torch.sml import create_smls
from tests.golden import generate


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair_ascii(rng_seed, n=40_000):
    """An ancestor and a mutant with an inversion; N runs in both."""
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    b = generate._mutant(rng, anc, invert=(3 * n // 10, n // 2))
    a_asc = generate._LUT[anc].copy()
    b_asc = generate._LUT[b].copy()
    a_asc[n // 8:n // 8 + 60] = ord("N")
    b_asc[3 * n // 4:3 * n // 4 + 10] = ord("N")
    a_asc[5 * n // 8] = ord("R")
    return a_asc, b_asc


def _both(a_asc, b_asc):
    port = [Genome("a", a_asc.copy()), Genome("b", b_asc.copy())]
    ref = [JaxGenome("a", a_asc.copy()), JaxGenome("b", b_asc.copy())]
    return port, ref


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


@pytest.mark.parametrize("weight", [None, 17])
@pytest.mark.parametrize("rng_seed", [11, 12, 13])
def test_find_mums_equal_jax(rng_seed, weight):
    seed = None if weight is None else jseeds.get_seed(weight)
    port, ref = _both(*_pair_ascii(rng_seed))
    got = find_mums(port, seed=seed, device="cpu")
    want = jax_find_mums(ref, seed=seed)
    assert len(want) > 10
    assert (want.starts[:, 1] < 0).any()          # the inversion
    _assert_same(got, want)


def test_find_mums_equals_numpy_twin():
    a_asc, b_asc = _pair_ascii(14)
    port, _ = _both(a_asc, b_asc)
    smls, seed = create_smls(port, device="cpu")
    got = find_mums(smls)
    twin = find_pair_mums_np(port[0].codes, port[1].codes, seed,
                             port[0].ambig, port[1].ambig)
    _assert_same(got, twin.canonical_sort())


def test_pair_mums_golden_bytes():
    gs = [Genome(g.name, g.ascii, filename=g.filename)
          for g in generate._genomes_pair()]
    mums = find_mums(gs, device="cpu")
    buf = io.StringIO()
    write_match_list(buf, mums, [g.filename for g in gs],
                     [len(g) for g in gs])
    with open(f"{generate.GOLDEN_DIR}/pair.mums", "rb") as fh:
        assert buf.getvalue().encode() == fh.read()


@pytest.mark.parametrize("circular", [False, True])
def test_jax_smls_through_convert_give_same_mums(circular):
    a_asc, b_asc = _pair_ascii(15)
    _, ref = _both(a_asc, b_asc)
    seed = jseeds.get_seed(11)
    jsmls = [JaxSML.create(g, seed, circular=circular) for g in ref]
    smls = [convert.sml_from_reference(
        np.asarray(s.keys), np.asarray(s.sorted_keys),
        np.asarray(s.sorted_positions), s.seed, s.length, s.circular,
        "cpu") for s in jsmls]
    _assert_same(find_mums(smls), jax_find_mums(jsmls))


@pytest.mark.parametrize("kwargs", [
    dict(repeat_tolerance=1),
    dict(enumeration_tolerance=2),
    dict(extend=False),
    dict(seq_mask=0b01),
])
def test_unported_modes_raise(kwargs):
    """The modes beyond the default pair mode run and equal the JAX
    package (a one-genome seq_mask gives no match on either side)."""
    port, ref = _both(*_pair_ascii(16, n=2_000))
    got = find_mums(port, device="cpu", **kwargs)
    want = jax_find_mums(ref, **kwargs)
    assert len(want) > 0 or kwargs == dict(seq_mask=0b01)
    _assert_same(got, want)


def test_three_genomes_raise():
    """Three genomes (the pair plus a copy of its first genome) run and
    equal the JAX package."""
    port, ref = _both(*_pair_ascii(16, n=2_000))
    got = find_mums(port + [port[0]], device="cpu")
    want = jax_find_mums(ref + [ref[0]])
    _assert_same(got, want)


def _device_outputs(a_asc, b_asc, seed=None, **kw):
    """find_mums_device of both packages on one pair: each runs its
    _fused_pair_pipeline (the port's through the plain versions of K18
    and K19)."""
    port, ref = _both(a_asc, b_asc)
    smls, seed = create_smls(port, seed, device="cpu")
    assert matchfind.pair_fast_path_ok(smls)
    jsmls = [JaxSML.create(g, seed) for g in ref]
    got = matchfind.find_mums_device(smls, **kw)
    want = jax_find_mums_device(jsmls, **kw)
    return smls, got, want


def _assert_device_outputs_equal(got, want):
    starts, lengths, valid, n_cands, n_reps = got
    np.testing.assert_array_equal(starts.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[2]))
    assert int(n_cands) == int(want[3])
    assert int(n_reps) == int(want[4])


@pytest.mark.parametrize("rng_seed", [21, 22])
def test_fused_pair_pipeline_outputs_equal_jax(rng_seed):
    _, got, want = _device_outputs(*_pair_ascii(rng_seed, n=20_000))
    assert int(want[4]) > 5 and bool(np.asarray(want[2]).any())
    _assert_device_outputs_equal(got, want)


def test_fused_pair_pipeline_last_table_rows_survive():
    """The largest seed content of the table is an exact pair, so the
    last two rows of the sorted word table are a candidate: the fills
    past the table's end decide the flag.  K18 keeps only the candidates'
    cluster words, in table order, so the last of them is the top
    content's pair (forward, on diagonal 0, at its position in genome
    a)."""
    rng = np.random.default_rng(23)
    n = 3_000
    a = rng.integers(0, 4, size=n).astype(np.uint8)
    a_asc = generate._LUT[a]
    smls, seed = create_smls([Genome("a", a_asc)], device="cpu")
    top = int(smls[0].keys.argmax())
    b = a.copy()
    far = np.flatnonzero(np.abs(np.arange(n) - top) > 100)
    sub = rng.choice(far, size=12, replace=False)
    b[sub] = (b[sub] + 1) % 4
    smls, got, want = _device_outputs(a_asc, generate._LUT[b], seed)
    pb = matchfind._pair_pos_bits(max(s.n_windows for s in smls))
    cw, n_cands = ops_pair.pair_cluster_words_plain(
        smls[0].keys, smls[1].keys, pb, sentinel_content(seed))
    top_pair = (1 << (2 * pb + 2)) | ((1 << pb) << pb) | top
    assert int(cw[-1]) == top_pair and n_cands == cw.numel() > 5
    assert not bool((cw == -1).any())
    _assert_device_outputs_equal(got, want)


def test_fused_pair_pipeline_without_candidates():
    """Two unrelated genomes share no weight-21 seed: K18 keeps no
    cluster word, and both packages find no MUM."""
    rng = np.random.default_rng(26)
    a_asc, b_asc = (generate._LUT[rng.integers(0, 4, size=2_000).astype(
        np.uint8)] for _ in range(2))
    seed = jseeds.get_seed(21)
    smls, got, want = _device_outputs(a_asc, b_asc, seed)
    pb = matchfind._pair_pos_bits(max(s.n_windows for s in smls))
    cw, n_cands = ops_pair.pair_cluster_words_plain(
        smls[0].keys, smls[1].keys, pb, sentinel_content(seed))
    assert n_cands == cw.numel() == 0
    assert int(want[3]) == 0 and not bool(np.asarray(want[2]).any())
    _assert_device_outputs_equal(got, want)
    port, ref = _both(a_asc, b_asc)
    mums = find_mums(port, seed=seed, device="cpu")
    assert len(mums) == 0
    _assert_same(mums, jax_find_mums(ref, seed=seed))


def test_fused_pair_pipeline_capacity_retry():
    """More representatives than extension rows: both packages report
    the same n_reps > EC and the same truncated rows, and find_mums'
    retry at the next power of two gives the full result."""
    a_asc, b_asc = _pair_ascii(24, n=20_000)
    smls, got, want = _device_outputs(a_asc, b_asc, extend_capacity=4)
    n_reps = int(got[4])
    assert n_reps > 4 == got[2].shape[0]
    _assert_device_outputs_equal(got, want)
    again = matchfind.find_mums_device(
        smls, extend_capacity=1 << (n_reps - 1).bit_length())
    full = matchfind.find_mums_device(smls)
    assert int(again[4]) == n_reps <= again[2].shape[0]
    rows = [(t[0][t[2]].numpy(), t[1][t[2]].numpy()) for t in (again, full)]
    np.testing.assert_array_equal(rows[0][0], rows[1][0])
    np.testing.assert_array_equal(rows[0][1], rows[1][1])


def _cumsum_pair_reps(cw, ec: int, pos_bits: int, seed_len: int):
    """K19's rows by the JAX package's route (matchfind.py:546-594):
    the rep flags, their cumsum ranks, the row of the j-th rep by a
    binary search over the ranks, the cluster's last member before the
    next rep's row or at the last candidate.  Returns (lefts, present,
    is_fwd, lengths0, n_reps)."""
    from libmems_tpu_torch.ops.pairwise import shr
    pb = pos_bits
    pmask = (1 << pb) - 1
    valid_c = cw != -1
    s_posA = cw & pmask
    head = shr(cw, pb)
    prev_head = torch.cat([torch.full((1,), -1, dtype=cw.dtype), head[:-1]])
    prev_posA = torch.cat([torch.zeros(1, dtype=cw.dtype), s_posA[:-1]])
    rep = valid_c & ((head != prev_head) | (s_posA - prev_posA > seed_len))
    n_cands = valid_c.sum()
    n_reps = rep.sum()
    rank = torch.cumsum(rep.to(torch.int64), 0)
    src = torch.searchsorted(rank, torch.arange(1, ec + 1), side="left")
    e_valid = torch.arange(ec) < n_reps
    next_src = torch.cat([src[1:], torch.full((1,), cw.shape[0])])
    src = src.clamp(max=cw.shape[0] - 1)
    rep_cw = cw[src]
    r_posA = rep_cw & pmask
    r_delta = shr(rep_cw, pb) & ((1 << (pb + 2)) - 1)
    r_fwd = (shr(rep_cw, 2 * pb + 2) & 1) == 1
    end_row = (torch.minimum(next_src, n_cands) - 1).clamp(0,
                                                           cw.shape[0] - 1)
    last_posA = torch.maximum(cw[end_row] & pmask, r_posA)
    lengths0 = torch.where(e_valid, last_posA - r_posA + seed_len, seed_len)
    posB_rep = torch.where(r_fwd, r_delta - (1 << pb) + r_posA,
                           r_delta - r_posA)
    leftB = torch.where(r_fwd, posB_rep, r_delta - last_posA).clamp(min=0)
    present = e_valid[:, None].expand(ec, 2)
    lefts = torch.where(present, torch.stack([r_posA, leftB], dim=1), 0)
    is_fwd = torch.stack([torch.ones_like(r_fwd), r_fwd], dim=1)
    return (lefts.to(torch.int32), present, is_fwd,
            lengths0.to(torch.int32), int(n_reps))


@pytest.mark.parametrize("invalid", [0, 100])
def test_pair_reps_plain_equal_jax_route(invalid):
    """K19's split plain versions (K7's scan, then the pair decode)
    against the JAX package's cumsum and binary-search route, with and
    without -1 words after the candidates, below, at and above the
    representative count: the same rows, each cluster's last member at
    the last candidate in the last valid slot also when EC < n_reps;
    absent rows forward."""
    from libmems_tpu_torch.ops import pairwise
    a_asc, b_asc = _pair_ascii(24, n=20_000)
    smls, seed = create_smls(_both(a_asc, b_asc)[0], device="cpu")
    pb = matchfind._pair_pos_bits(max(s.n_windows for s in smls))
    seed_len = smls[0].seed_length
    cw, n_cands = ops_pair.pair_cluster_words_plain(
        smls[0].keys, smls[1].keys, pb, sentinel_content(seed))
    cw = torch.cat([pairwise.usort(cw),
                    torch.full((invalid,), -1, dtype=torch.int64)])
    idx = pairwise.rep_index_plain(cw, pb, seed_len)
    n = idx.n_reps
    assert int(idx.counts[0]) == n_cands > n > 8
    for ec in (4, n - 1, n, n + 5):
        got = ops_pair.pair_decode_reps_plain(cw, idx, ec, pb, seed_len)
        composed = ops_pair.pair_reps_plain(cw, ec, pb, seed_len)
        for g, c in zip(got, composed):
            assert torch.equal(g, c) if isinstance(g, torch.Tensor) \
                else g == c
        lefts, present, is_fwd, lengths0, n_reps = _cumsum_pair_reps(
            cw, ec, pb, seed_len)
        assert got.n_reps == n_reps == n
        assert torch.equal(got.lefts, lefts)
        assert torch.equal(got.present, present)
        assert torch.equal(got.lengths0, lengths0)
        v = present[:, 0]
        assert torch.equal(got.is_fwd[v], is_fwd[v])
        assert bool(got.is_fwd[~v].all())
        k = min(n, ec)
        last = max(int(cw[n_cands - 1]) & ((1 << pb) - 1),
                   int(got.lefts[k - 1, 0]))
        assert int(got.lengths0[k - 1]) == last - int(got.lefts[k - 1, 0]) \
            + seed_len


def test_pair_words_with_bit_63_equal_jax():
    """A weight-25 seed on 1.5 kbp genomes packs 2 * 25 + 3 + 11 = 64
    bits: the seed words use bit 63 and the pair path still runs."""
    seed = jseeds.get_seed(25)
    rng = np.random.default_rng(25)
    a = rng.integers(0, 4, size=1_500).astype(np.uint8)
    b = a.copy()
    b[[300, 900]] = (b[[300, 900]] + 1) % 4
    b[1_000:1_200] = 3 - b[1_000:1_200][::-1]
    smls, got, want = _device_outputs(generate._LUT[a], generate._LUT[b],
                                      seed)
    pb = matchfind._pair_pos_bits(max(s.n_windows for s in smls))
    assert 2 * smls[0].seed_weight + 3 + pb == 64
    assert int(want[4]) >= 3
    _assert_device_outputs_equal(got, want)
