"""Port parity: multi-MUM discovery for any G and every mode (kernels
K13-K15 through their plain versions) against the JAX package, exact."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_e2e import _mutant_family
from libmems_tpu import seeds as jseeds
from libmems_tpu import matchfind as jmf
from libmems_tpu.sequence import Genome as JaxGenome
from libmems_tpu.sml import SortedMerList as JaxSML
from libmems_tpu_torch import convert
from libmems_tpu_torch.match import write_match_list
from libmems_tpu_torch.match import MatchArray
from libmems_tpu_torch.matchfind import (_lexsort_rows, _seed_table,
                                         find_mums, find_mums_device,
                                         find_pair_mums_np)
from libmems_tpu_torch.ops import mums, pairwise
from libmems_tpu_torch.ops.mers import sentinel_content
from libmems_tpu_torch.sequence import Genome
from libmems_tpu_torch.sml import create_smls
from tests.golden import generate
from tests.oracle.refimpl import find_mums_oracle, match_set


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _family_ascii(G, n=80_000, rng_seed=5):
    """bench_e2e's mutant family with N runs and an IUPAC base, as
    test_torch_matchfind._pair_ascii adds them."""
    asc = [LUT[g].copy() for g in _mutant_family(G, n, rng_seed=rng_seed)]
    asc[0][n // 8:n // 8 + 60] = ord("N")
    asc[1][3 * n // 4:3 * n // 4 + 10] = ord("N")
    asc[-1][5 * n // 8] = ord("R")
    return asc


def _both(asc):
    port = [Genome(f"g{i}", a.copy()) for i, a in enumerate(asc)]
    ref = [JaxGenome(f"g{i}", a.copy()) for i, a in enumerate(asc)]
    return port, ref


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


@pytest.mark.parametrize("G,kwargs", [
    (3, {}),
    (3, dict(seq_mask=0b111)),
    (3, dict(seq_mask=0b101)),
    (3, dict(seq_mask=0b011)),
    (3, dict(seq_mask=0b100)),            # one genome: never satisfiable
    (3, dict(repeat_tolerance=1)),
    (3, dict(repeat_tolerance=2)),
    (3, dict(extend=False)),
    (3, dict(min_multiplicity=3)),
    (4, {}),
    (4, dict(repeat_tolerance=1)),
])
def test_find_mums_equal_jax(G, kwargs):
    port, ref = _both(_family_ascii(G))
    got = find_mums(port, device="cpu", **kwargs)
    want = jmf.find_mums(ref, **kwargs)
    if kwargs.get("seq_mask") == 0b100:
        assert len(want) == 0
    else:
        assert len(want) > 30
    _assert_same(got, want)
    if not kwargs:
        assert (want.starts < 0).any()               # inverted segments
        assert (want.multiplicity() == G).any()
        assert (want.multiplicity() < G).any()


def _repeat_rich(rng_seed, G):
    """Short genomes sharing a core that genome 0 carries twice, so runs
    hold several occurrences per genome (test_matchfind's
    enumeration-tolerance inputs)."""
    rng = np.random.default_rng(rng_seed)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    def mutate(s, rate):
        c = np.array(list(s))
        m = rng.random(len(c)) < rate
        c[m] = rng.choice(list("ACGT"), size=int(m.sum()))
        return "".join(c)

    core = rand(70)
    seqs = [core + rand(30) + core, mutate(core, 0.02) + rand(25),
            rand(20) + mutate(core, 0.02)]
    for _ in range(G - 3):
        seqs.append(mutate(core, 0.03) + rand(15) + mutate(core, 0.03))
    return seqs


@pytest.mark.parametrize("G,rt,et", [(3, 2, 2), (3, 2, 3), (4, 1, 2),
                                     (4, 2, 3)])
def test_enumeration_tolerance_equal_jax_and_oracle(G, rt, et):
    seqs = _repeat_rich(11 + G, G)
    seed = jseeds.get_seed(5, 0)
    kw = dict(repeat_tolerance=rt, enumeration_tolerance=et)
    got = find_mums(seqs, seed, device="cpu", **kw)
    want = jmf.find_mums(seqs, seed, **kw)
    assert len(want) > 5
    _assert_same(got, want)
    assert got.key_set() == match_set(find_mums_oracle(seqs, seed, **kw))


def test_overflowing_pair_equal_jax():
    """Seed weight 31: the packed pair word needs more than 64 bits, so
    find_mums and the numpy twin take the general pipeline."""
    rng = np.random.default_rng(41)
    anc = rng.integers(0, 4, 30_000).astype(np.uint8)
    b = generate._mutant(rng, anc, mutate=0.005, invert=(9_000, 15_000))
    a_asc, b_asc = generate._LUT[anc].copy(), generate._LUT[b].copy()
    a_asc[100:130] = ord("N")
    seed = jseeds.get_seed(31)
    port, ref = _both([a_asc, b_asc])
    want = jmf.find_mums(ref, seed=seed)
    assert len(want) > 10 and (want.starts[:, 1] < 0).any()
    _assert_same(find_mums(port, seed=seed, device="cpu"), want)
    twin = find_pair_mums_np(port[0].codes, port[1].codes, seed,
                             port[0].ambig, port[1].ambig)
    ref_twin = jmf.find_pair_mums_np(ref[0].codes, ref[1].codes, seed,
                                     ref[0].ambig, ref[1].ambig)
    _assert_same(twin, ref_twin)
    _assert_same(twin, want)


def test_three_mums_golden_bytes():
    gs = [Genome(g.name, g.ascii, filename=g.filename)
          for g in generate._genomes_three()]
    mums_ = find_mums(gs, device="cpu")
    buf = io.StringIO()
    write_match_list(buf, mums_, [g.filename for g in gs],
                     [len(g) for g in gs])
    with open(f"{generate.GOLDEN_DIR}/three.mums", "rb") as fh:
        assert buf.getvalue().encode() == fh.read()


def test_jax_smls_through_convert_give_same_mums():
    _, ref = _both(_family_ascii(3))
    jsmls = [JaxSML.create(g, jseeds.get_seed(11)) for g in ref]
    smls = [convert.sml_from_reference(
        np.asarray(s.keys), np.asarray(s.sorted_keys),
        np.asarray(s.sorted_positions), s.seed, s.length, s.circular,
        "cpu") for s in jsmls]
    want = jmf.find_mums(jsmls)
    assert len(want) > 30
    _assert_same(find_mums(smls), want)


def _np(x):
    return np.asarray(x).view(np.int64) if np.asarray(x).dtype == np.uint64 \
        else np.asarray(x)


K15_CASES = [(0, 0), (0, 0b110), (2, 0)]


def _jax_table(tol, seq_mask, G=3):
    """One table through K13's and K14's plain versions and through
    _mum_seed_flags and _packed_diagonal_words with the JAX pipeline's
    scatter and seq_mask glue (matchfind.py:355-375), held equal on the
    way; then K15's input, the rows in the JAX signature order.  Returns
    (words, posref, the JAX recovered starts, the JAX representative
    flags, pos_bits, seed_len)."""
    port, ref = _both(_family_ascii(G, n=30_000, rng_seed=9))
    smls, seed = create_smls(port, device="cpu")
    keys, seg_off, content, src = _seed_table(smls)
    flags = mums.mum_seed_flags_plain(content, src, keys, seg_off, tol,
                                      1000, sentinel_content(seed))
    jsmls = [JaxSML.create(g, seed) for g in ref]
    jc, jg, jp, js = jmf._seed_table(jsmls)
    np.testing.assert_array_equal(content.numpy(), _np(jc))
    for got, want in ((flags.gid, jg), (flags.pos, jp), (flags.strand, js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jk, jrid, jref, jn = jmf._mum_seed_flags(jc, jg, jp, js, tol, 1000)
    assert flags.n_rows == int(jn) > 100
    for got, want in ((flags.kept_occ, jk), (flags.row_id, jrid),
                      (flags.ref_strand, jref)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # K14: the JAX scatter and seq_mask glue (matchfind.py:355-375)
    pos_bits = keys.shape[0].bit_length()
    cand = mums.mum_candidates_plain(flags, G, seq_mask, pos_bits)
    n_rows = flags.n_rows
    rid = jnp.where(jk, jnp.minimum(jrid, n_rows), n_rows)
    sign = jnp.where(js == jref, 1, -1).astype(jnp.int32)
    jst = jnp.zeros((n_rows + 1, G), jnp.int32).at[rid, jg].set(
        sign * (jp + 1), mode="drop")[:n_rows]
    valid = jnp.ones((n_rows,), bool)
    if seq_mask:
        want = jnp.asarray([(seq_mask >> (G - 1 - g)) & 1 for g in range(G)],
                           dtype=bool)
        ok = jnp.all((jst != 0) == want[None, :], axis=1)
        jst = jnp.where(ok[:, None], jst, 0)
        valid = valid & ok
    np.testing.assert_array_equal(cand.starts.numpy(), np.asarray(jst))
    jw, jpr = jmf._packed_diagonal_words(jst, valid, pos_bits)
    assert cand.words.shape[0] == len(jw) == 2
    for w in range(len(jw)):
        np.testing.assert_array_equal(cand.words[w].numpy(), _np(jw[w]))
    np.testing.assert_array_equal(cand.posref.numpy(), _np(jpr))

    # K15's input: the rows in signature order, the JAX representatives
    s = jax.lax.sort(tuple(jw) + (jpr,), num_keys=len(jw) + 1)
    s_words = np.stack([_np(x) for x in s[:-1]])
    s_posref = _np(s[-1]).copy()
    j_starts = np.asarray(jmf._recover_starts(s[:-1], s[-1], G, pos_bits))
    seed_len = smls[0].seed_length
    change = np.concatenate([[True], (s_words[:, 1:] != s_words[:, :-1]).any(0)
                             | (s_posref[1:] - s_posref[:-1] > seed_len)])
    rep = change & (j_starts != 0).any(axis=1)
    return (torch.from_numpy(s_words), torch.from_numpy(s_posref), j_starts,
            rep, pos_bits, seed_len)


def _assert_jax_reps(reps, j_starts, rep, ec):
    """reps holds the JAX package's first EC representatives' rows, and
    absent rows (zeros, not forward) after them."""
    e = j_starts[rep][:ec]
    k = len(e)
    np.testing.assert_array_equal(reps.present.numpy()[:k], e != 0)
    np.testing.assert_array_equal(reps.lefts.numpy()[:k],
                                  np.where(e != 0, np.abs(e) - 1, 0))
    np.testing.assert_array_equal(reps.is_fwd.numpy()[:k], e > 0)
    for t in reps[:-1]:
        assert not t.numpy()[k:].any()


@pytest.mark.parametrize("tol,seq_mask", K15_CASES)
def test_plain_kernels_equal_jax_functions(tol, seq_mask):
    """K13, K14 and K15's plain versions against _mum_seed_flags,
    _packed_diagonal_words and _recover_starts (with the JAX pipeline's
    scatter, seq_mask and representative glue) on one table."""
    G = 3
    tw, tp, j_starts, rep, pos_bits, seed_len = _jax_table(tol, seq_mask, G)
    np.testing.assert_array_equal(
        mums.recover_starts(tw, tp, G, pos_bits).numpy(), j_starts)
    for ec in (64, 1 << 14):
        reps = mums.mum_reps_plain(tw, tp, ec, G, pos_bits, seed_len)
        assert reps.n_reps == int(rep.sum()) > 64
        _assert_jax_reps(reps, j_starts, rep, ec)


@pytest.mark.parametrize("tol,seq_mask", K15_CASES)
def test_rep_index_and_decode_plain_equal_jax_rows(tol, seq_mask):
    """K15's scan and decode plain versions on the JAX signature rows: a
    row's validity read from its fields alone is the JAX test (a
    recovered start is nonzero; seq_mask's rejected rows are invalid),
    the scan finds the JAX representatives in order, and the decode
    below, at and above their count composes with it to mum_reps_plain
    and gives the JAX rows."""
    G = 3
    tw, tp, j_starts, rep, pos_bits, seed_len = _jax_table(tol, seq_mask, G)
    valid = mums.rows_valid(tw, G)
    np.testing.assert_array_equal(valid.numpy(),
                                  (j_starts != 0).any(axis=1))
    np.testing.assert_array_equal(
        valid, (mums.recover_starts(tw, tp, G, pos_bits) != 0).any(1))
    assert valid.any() and bool(seq_mask) == (not valid.all())
    idx = mums.mum_rep_index_plain(tw, tp, G, pos_bits, seed_len)
    assert idx.index.dtype == torch.int32
    np.testing.assert_array_equal(idx.index.numpy(), np.flatnonzero(rep))
    n = idx.n_reps
    assert n == int(rep.sum()) > 64
    for ec in (n - 1, n, n + 7):
        got = mums.mum_decode_reps_plain(tw, tp, idx, ec, G, pos_bits)
        ref = mums.mum_reps_plain(tw, tp, ec, G, pos_bits, seed_len)
        assert got.n_reps == ref.n_reps == n
        for g, r in zip(got[:-1], ref[:-1]):
            assert torch.equal(g, r)
        _assert_jax_reps(got, j_starts, rep, ec)


@pytest.mark.parametrize("seq_mask", [0b101, 0b011, 0b111])
def test_candidates_plain_equal_jax_rows_with_seq_mask(seq_mask):
    """K14's plain version on the fused path's flags with seq_mask set:
    its starts, signature words and posref are the JAX pipeline's rows
    (_jax_table holds them equal: the rejected rows zero and invalid)."""
    _, tp, j_starts, _, _, _ = _jax_table(0, seq_mask)
    valid = (tp != 1 << 62).numpy()
    assert valid.any() and (seq_mask == 0b111 or not valid.all())


@pytest.mark.parametrize("G", [3, 9])
def test_kept_runs_are_one_group_of_kept_rows(G):
    """K14's precondition on its one caller's flags (K13 at
    repeat_tolerance 0, as the fused path calls it), which its kernel
    builds each candidate from: every kept run is one group of at most G
    consecutive kept table rows, in ascending genome order, from its
    run's start to its end; so the rows its kernel takes as a group's
    first are one a candidate."""
    port, _ = _both(_family_ascii(G, n=30_000))
    smls, seed = create_smls(port, device="cpu")
    keys, seg_off, content, src = _seed_table(smls)
    f = mums.mum_seed_flags_plain(content, src, keys, seg_off, 0, 1000,
                                  sentinel_content(seed))
    kept, rid, gid = f.kept_occ.numpy(), f.row_id.numpy(), f.gid.numpy()
    c = content.numpy()
    n = len(c)
    idx = np.flatnonzero(kept)
    r = rid[idx]
    assert f.n_rows > 1000 and (np.diff(r) >= 0).all()
    ids, first, counts = np.unique(r, return_index=True, return_counts=True)
    np.testing.assert_array_equal(ids, np.arange(f.n_rows))
    lo = idx[first]
    hi = idx[first + counts - 1]
    np.testing.assert_array_equal(hi - lo + 1, counts)     # consecutive
    assert counts.max() <= G and counts.min() >= 2
    same = r[1:] == r[:-1]
    assert (gid[idx][1:][same] > gid[idx][:-1][same]).all()
    assert ((lo == 0) | (c[np.maximum(lo - 1, 0)] != c[lo])).all()
    assert ((hi == n - 1) | (c[np.minimum(hi + 1, n - 1)] != c[hi])).all()
    prev_same = np.concatenate([[False], kept[:-1] & (rid[:-1] == rid[1:])])
    np.testing.assert_array_equal(np.flatnonzero(kept & ~prev_same), lo)


@pytest.mark.parametrize("tol", [0, 1, 2])
def test_candidates_take_tolerance_zero_flags_only(tol):
    """K13's flags carry the tolerance they were flagged at, on both of
    its plain routes; K14's wrapper takes those at 0 (its plain version
    then) and refuses the others, whose kept runs need not be one group
    of rows."""
    port, _ = _both(_family_ascii(3, n=30_000))
    smls, seed = create_smls(port, device="cpu")
    keys, seg_off, content, src = _seed_table(smls)
    args = (content, src, keys, seg_off, tol, 1000, sentinel_content(seed))
    f = mums.mum_seed_flags_plain(*args)
    words = pairwise.run_summaries_plain(content, src, seg_off, tol + 1)
    f2 = mums.mum_flags_from_summaries_plain(*args[:4], words, *args[4:])
    assert f.repeat_tolerance == f2.repeat_tolerance == tol
    pos_bits = keys.shape[0].bit_length()
    if tol:
        with pytest.raises(ValueError, match="repeat_tolerance 0"):
            mums.mum_candidates(f, 3, 0, pos_bits)
    else:
        assert f.n_rows > 100
        for g, r in zip(mums.mum_candidates(f, 3, 0, pos_bits),
                        mums.mum_candidates_plain(f, 3, 0, pos_bits)):
            assert torch.equal(g, r)


@pytest.mark.parametrize("extend_capacity", [8, 1 << 14])
def test_find_mums_device_capacity_picked_once(extend_capacity):
    """K15's capacity, picked once from the representatives' count, is
    the last of the loop that called K15 until its representatives fit:
    the first guess where they fit it, the next power of two above their
    count where they do not; the matches at it are the JAX pipeline's at
    that capacity."""
    for ec0 in (1, 8, 64):
        for n in range(200):
            ec = ec0
            while n > ec:
                ec = 1 << (n - 1).bit_length()
            assert pairwise.rep_capacity(ec0, n) == ec
    G = 3
    port, ref = _both(_family_ascii(G, n=30_000, rng_seed=9))
    smls, seed = create_smls(port, device="cpu")
    starts, lengths, valid, n_rows, n_reps = find_mums_device(
        smls, extend_capacity=extend_capacity)
    keys, seg_off, content, src = _seed_table(smls)
    flags = mums.mum_seed_flags_plain(content, src, keys, seg_off, 0, 1000,
                                      sentinel_content(seed))
    pos_bits = keys.shape[0].bit_length()
    cand = mums.mum_candidates_plain(flags, G, 0, pos_bits)
    order = _lexsort_rows(list(cand.words) + [cand.posref])
    words = torch.index_select(cand.words, 1, order)
    posref = cand.posref[order]
    ec0 = ec = min(extend_capacity, 1 << (n_rows - 1).bit_length())
    while True:
        reps = mums.mum_reps_plain(words, posref, ec, G, pos_bits,
                                   smls[0].seed_length)
        if reps.n_reps <= ec:
            break
        ec = 1 << (reps.n_reps - 1).bit_length()
    assert (ec > ec0) == (extend_capacity == 8)
    assert starts.shape == (ec, G) and valid.shape == (ec,)
    assert n_reps == reps.n_reps == int(valid.sum())
    jst, jlen, jvalid, _, jn_reps = jmf.find_mums_device(
        [JaxSML.create(g, seed) for g in ref], extend_capacity=ec)
    assert int(jn_reps) == n_reps
    v, jv = valid.numpy(), np.asarray(jvalid)
    got = MatchArray(starts.numpy()[v].astype(np.int64),
                     lengths.numpy()[v].astype(np.int64)).dedup()
    want = MatchArray(np.asarray(jst)[jv].astype(np.int64),
                      np.asarray(jlen)[jv].astype(np.int64)).dedup()
    _assert_same(got.canonical_sort(), want.canonical_sort())


def _flags_of(starts: np.ndarray) -> mums.MumFlags:
    """K13 flags whose candidate scatter rebuilds `starts` [R, G] (every
    kept occurrence is a nonzero entry; the strand reference is 0)."""
    r, g = np.nonzero(starts)
    s = starts[r, g]
    t = torch.from_numpy
    return mums.MumFlags(
        torch.ones(len(s), dtype=torch.bool), t(r.astype(np.int32)),
        torch.zeros(len(s), dtype=torch.uint8), starts.shape[0],
        t(g.astype(np.int32)), t((np.abs(s) - 1).astype(np.int32)),
        t((s < 0).astype(np.uint8)), 0)


@pytest.mark.parametrize("G", [63, 64, 100])
def test_signature_words_at_wide_rows(G):
    """K14's plain version above 62 genomes: the mask and sign bits of
    every genome land in the JAX package's words (compared where its G-bit
    integers hold them, G <= 64), and K15's recovery gives the rows
    back."""
    rng = np.random.default_rng(G)
    R, pos_bits = 40, 16
    present = rng.random((R, G)) < 0.7
    present[:, 0] |= ~present.any(axis=1)
    sign = np.where(rng.random((R, G)) < 0.3, -1, 1)
    starts = np.where(present, sign * rng.integers(1, 1 << 14, (R, G)),
                      0).astype(np.int32)
    cand = mums.mum_candidates_plain(_flags_of(starts), G, 0, pos_bits)
    np.testing.assert_array_equal(cand.starts.numpy(), starts)
    assert cand.words.shape[0] == mums.n_words_for(G, pos_bits)
    if G <= 64:
        jw, jpr = jmf._packed_diagonal_words(
            jnp.asarray(starts), jnp.ones((R,), bool), pos_bits)
        assert len(jw) == cand.words.shape[0]
        for w in range(len(jw)):
            np.testing.assert_array_equal(cand.words[w].numpy(), _np(jw[w]))
        np.testing.assert_array_equal(cand.posref.numpy(), _np(jpr))
    np.testing.assert_array_equal(
        mums.recover_starts(cand.words, cand.posref, G, pos_bits).numpy(),
        starts)


def test_find_mums_device_above_64_genomes_equals_oracle():
    """66 genomes, where the mask and sign fields pass 64 bits: the
    device pipeline's matches (plain versions; chunk = seed length keeps
    the plain extension small) are the oracle's, and reach all 66."""
    rng = np.random.default_rng(66)
    core = rng.integers(0, 4, 150)
    seqs = []
    for _ in range(66):
        s = core.copy()
        m = rng.random(len(s)) < 0.01
        s[m] = rng.integers(0, 4, int(m.sum()))
        seqs.append("".join("ACGT"[x] for x in s))
    seed = jseeds.get_seed(9, 0)
    smls, _ = create_smls([Genome.from_string(s) for s in seqs], seed,
                          device="cpu")
    starts, lengths, valid, _, n_reps = find_mums_device(
        smls, chunk=smls[0].seed_length)
    assert n_reps <= valid.shape[0]
    v = valid.numpy()
    got = MatchArray(starts.numpy()[v].astype(np.int64),
                     lengths.numpy()[v].astype(np.int64)).dedup()
    assert got.multiplicity().max() == 66
    assert got.key_set() == match_set(find_mums_oracle(seqs, seed))
