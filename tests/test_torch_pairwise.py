"""Port parity: the pairwise seeder (find_pairwise_mums with the plain
versions of K5-K7) against the JAX package, stage by stage."""

import numpy as np
import pytest
import torch

from libmems_tpu import matchfind as jmatchfind
from libmems_tpu.sequence import Genome as JaxGenome
from libmems_tpu.sml import create_smls as jax_create_smls
from libmems_tpu_torch import Genome, find_pairwise_mums
from libmems_tpu_torch import matchfind
from libmems_tpu_torch.matchfind import _pair_pos_bits
from libmems_tpu_torch.ops import pairwise
from libmems_tpu_torch.ops.mers import sentinel_content
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


def _family(G, rng_seed, n=20_000):
    """G seeded mutants of one ancestor: inversions in every other
    genome, an N run in genome 1."""
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    out = [anc]
    for g in range(1, G):
        inv = (n // 4, n // 4 + 3_000) if g % 2 else None
        out.append(generate._mutant(rng, anc, mutate=0.01, invert=inv))
    ascii_ = [generate._LUT[g].copy() for g in out]
    ascii_[1][500:560] = ord("N")
    return ascii_


@pytest.mark.parametrize("G,rng_seed", [(3, 31), (4, 32), (9, 33)])
def test_find_pairwise_mums_equal_jax(G, rng_seed):
    fam = _family(G, rng_seed)
    ref = jmatchfind.find_pairwise_mums(
        [JaxGenome(f"g{i}", a) for i, a in enumerate(fam)])
    got = find_pairwise_mums([Genome(f"g{i}", a) for i, a in enumerate(fam)],
                             device="cpu")
    assert len(ref) > 50
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


def _tables(G, rng_seed):
    fam = _family(G, rng_seed, n=8_000)
    jsmls, seed = jax_create_smls([JaxGenome(f"g{i}", a)
                                   for i, a in enumerate(fam)])
    smls, _ = create_smls([Genome(f"g{i}", a) for i, a in enumerate(fam)],
                          seed, device="cpu")
    return jsmls, smls, seed


def test_run_flags_equal_jax_unique_occ_flags():
    jsmls, smls, seed = _tables(4, 41)
    content, gid, pos, strand = (np.asarray(x) for x in
                                 jmatchfind._seed_table(jsmls))
    ref_uo, ref_rid = (np.asarray(x) for x in jmatchfind._unique_occ_flags(
        content, gid, pos, strand, jmatchfind.MER_REPEAT_LIMIT))

    keys = torch.cat([s.keys for s in smls])
    offs = np.concatenate([[0], np.cumsum([s.n_windows for s in smls])])
    c_sorted, src = torch.sort(pairwise.shr(keys, 1), stable=True)
    flags = pairwise.run_flags(c_sorted, src, keys, torch.from_numpy(offs),
                               jmatchfind.MER_REPEAT_LIMIT,
                               sentinel_content(seed))
    np.testing.assert_array_equal(c_sorted.numpy(), content.astype(np.int64))
    np.testing.assert_array_equal(flags.gid.numpy(), gid)
    np.testing.assert_array_equal(flags.pos.numpy(), pos)
    np.testing.assert_array_equal(flags.strand.numpy(), strand)
    np.testing.assert_array_equal(flags.unique_occ.numpy(), ref_uo)
    np.testing.assert_array_equal(flags.run_id.numpy(), ref_rid)
    assert ref_uo.sum() > 1000 and (~ref_uo).sum() > 0


def _reference_words(uo, rid, gid, pos, strand, G, pos_bits):
    """The JAX pipeline's cluster words (matchfind.py:1117-1161): kept
    rows compacted in table order, then one word per (row, shift) pair in
    the same run; numpy uint64, unsigned sort, -1 words dropped."""
    rid, gid, pos = rid[uo].astype(np.uint64), gid[uo].astype(np.int64), \
        pos[uo].astype(np.int64)
    st = strand[uo]
    pair_bits = 2 * max(G - 1, 1).bit_length()
    words = []
    for s in range(1, G):
        a, b = slice(0, len(rid) - s), slice(s, len(rid))
        ok = rid[a] == rid[b]
        fwd = st[a] == st[b]
        delta = np.where(fwd, pos[b] - pos[a] + (1 << pos_bits),
                         pos[b] + pos[a]).astype(np.uint64)
        pair = (gid[a] * G + gid[b]).astype(np.uint64)
        w = (fwd.astype(np.uint64) << np.uint64(pair_bits + 2 * pos_bits + 2)) \
            | (pair << np.uint64(2 * pos_bits + 2)) \
            | (delta << np.uint64(pos_bits)) | pos[a].astype(np.uint64)
        words.append(w[ok])
    return np.sort(np.concatenate(words))


def test_sorted_cluster_words_equal_jax_layout():
    G = 5
    jsmls, smls, seed = _tables(G, 42)
    content, gid, pos, strand = (np.asarray(x) for x in
                                 jmatchfind._seed_table(jsmls))
    uo, rid = (np.asarray(x) for x in jmatchfind._unique_occ_flags(
        content, gid, pos, strand, jmatchfind.MER_REPEAT_LIMIT))
    pos_bits = _pair_pos_bits(max(s.n_windows for s in smls))
    ref = _reference_words(uo, rid, gid, pos, strand, G, pos_bits)

    keys = torch.cat([s.keys for s in smls])
    offs = np.concatenate([[0], np.cumsum([s.n_windows for s in smls])])
    c_sorted, src = torch.sort(pairwise.shr(keys, 1), stable=True)
    flags = pairwise.run_flags(c_sorted, src, keys, torch.from_numpy(offs),
                               jmatchfind.MER_REPEAT_LIMIT,
                               sentinel_content(seed))
    cw = pairwise.usort(pairwise.cluster_words(flags, G, pos_bits))
    got = cw.numpy().view(np.uint64)
    n_valid = int((got != np.uint64(2**64 - 1)).sum())
    assert len(got) == (G - 1) * int(flags.unique_occ.sum())
    np.testing.assert_array_equal(got[:n_valid], ref)
    assert (got[n_valid:] == np.uint64(2**64 - 1)).all()
    assert len(ref) > 1000


@pytest.mark.parametrize("rng_seed", [0, 1])
def test_usort_is_unsigned_order_with_bit_63(rng_seed):
    """Cluster words may use bit 63 (1 + pair_bits + 2*pos_bits + 2 =
    64): held in int64 they are negative, and usort must still give the
    unsigned order with the -1 sentinel last."""
    rng = np.random.default_rng(rng_seed)
    u = rng.integers(0, 2**64 - 1, size=5000, dtype=np.uint64)
    u[:50] = np.uint64(2**64 - 1)
    u[50:100] |= np.uint64(1 << 63)
    got = pairwise.usort(torch.from_numpy(u.view(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), np.sort(u))
    assert got[-1] == -1
    # shr is a logical shift of those patterns
    np.testing.assert_array_equal(
        pairwise.shr(torch.from_numpy(u.view(np.int64)), 7).numpy()
        .view(np.uint64), u >> np.uint64(7))


def test_cluster_reps_capacity_retry_equal_results():
    """A capacity below the representative count reruns at the next
    power of two, as the JAX loop does; the matches do not change."""
    fam = _family(3, 51, n=6_000)
    gs = [Genome(f"g{i}", a) for i, a in enumerate(fam)]
    small = find_pairwise_mums(gs, extend_capacity=8, device="cpu")
    full = find_pairwise_mums(gs, device="cpu")
    assert len(full) > 8
    np.testing.assert_array_equal(small.starts, full.starts)
    np.testing.assert_array_equal(small.lengths, full.lengths)


@pytest.mark.parametrize("ec", [8, 64, 1 << 14])
def test_rep_index_then_decode_equals_cluster_reps(ec):
    """K7 in two parts, the representatives' index and counts and then
    the decode at a chosen capacity, gives cluster_reps's results below
    and above the representative count."""
    G = 4
    fam = _family(G, 43)
    smls, seed = create_smls([Genome(f"g{i}", a) for i, a in enumerate(fam)],
                             device="cpu")
    keys = torch.cat([s.keys for s in smls])
    cnts = [s.n_windows for s in smls]
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(cnts)]))
    c_sorted, src = torch.sort(pairwise.shr(keys, 1), stable=True)
    flags = pairwise.run_flags(c_sorted, src, keys, offs,
                               jmatchfind.MER_REPEAT_LIMIT,
                               sentinel_content(seed))
    pos_bits = _pair_pos_bits(max(cnts))
    cw = pairwise.usort(pairwise.cluster_words(flags, G, pos_bits))
    seed_len = smls[0].seed_length
    gen = (offs[:-1].to(torch.int32), torch.tensor(cnts, dtype=torch.int32))
    ref = pairwise.cluster_reps_plain(cw, ec, G, pos_bits, seed_len, *gen)
    idx = pairwise.rep_index(cw, pos_bits, seed_len)
    got = pairwise.decode_reps(cw, idx, ec, G, pos_bits, seed_len, *gen)
    assert idx.n_reps == ref.n_reps == int(idx.counts[1]) > 64
    assert int(idx.counts[0]) == int((cw != -1).sum())
    assert bool((idx.index[1:] > idx.index[:-1]).all())
    for g, r in zip(got[:-1], ref[:-1]):
        assert torch.equal(g, r)
    composed = pairwise.cluster_reps(cw, ec, G, pos_bits, seed_len, *gen)
    for g, r in zip(composed, got):
        assert torch.equal(g, r) if isinstance(g, torch.Tensor) else g == r


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


def test_pairwise_host_path_equals_fused_and_jax_on_nine_goldens():
    """_find_pairwise_mums_host (K5's plain version, numpy expansion and
    clustering, K2's plain version) gives the fused seeder's matches and
    the JAX host path's, on the nine-genome golden family."""
    nine = generate._genomes_nine()
    smls, _ = create_smls([Genome(g.name, g.ascii) for g in nine],
                          device="cpu")
    jsmls, _ = jax_create_smls(nine)
    host = matchfind._find_pairwise_mums_host(smls)
    assert len(host) > 500
    _assert_same(host, find_pairwise_mums(smls))
    _assert_same(host, jmatchfind._find_pairwise_mums_host(jsmls))


@pytest.mark.parametrize("case", ["extend_false", "max_rows",
                                  "extend_false_host_jax"])
def test_unported_pairwise_layouts_raise(case, monkeypatch):
    """The layouts beyond the fused pipeline (extend=False, an expansion
    table above _PAIRWISE_FUSED_MAX_ROWS) take the host path and equal
    the JAX package."""
    fam = _family(3, 52, 2_000)
    gs = [Genome(f"g{i}", a) for i, a in enumerate(fam)]
    jgs = [JaxGenome(f"g{i}", a) for i, a in enumerate(fam)]
    calls = []
    real = matchfind._find_pairwise_mums_host
    monkeypatch.setattr(matchfind, "_find_pairwise_mums_host",
                        lambda *a: calls.append(1) or real(*a))
    if case == "max_rows":
        monkeypatch.setattr(matchfind, "_PAIRWISE_FUSED_MAX_ROWS", 1)
        got = find_pairwise_mums(gs, device="cpu")
        ref = jmatchfind.find_pairwise_mums(jgs)
    elif case == "extend_false":
        got = find_pairwise_mums(gs, extend=False, device="cpu")
        ref = jmatchfind.find_pairwise_mums(jgs, extend=False)
    else:
        got = find_pairwise_mums(gs, extend=False, device="cpu")
        ref = jmatchfind._find_pairwise_mums_host(
            jax_create_smls(jgs)[0], extend=False)
    assert calls == [1] and len(ref) >= 10
    _assert_same(got, ref)
