"""Port parity: refinement (msa.refine, align_codes(refine_iters=...),
msa.refine_windows and the windowed refinement of progressive_align's
default refine=True) against the JAX package; exact equality."""

import io

import numpy as np
import pytest
import torch

from libmems_tpu import msa as jmsa
from libmems_tpu.backbone import apply_backbone as jax_apply_backbone
from libmems_tpu.backbone import write_backbone_columns as jax_bbcols
from libmems_tpu.backbone import \
    write_backbone_seq_coordinates as jax_bbseq
from libmems_tpu.interval import write_xmfa as jax_write_xmfa
from libmems_tpu.progressive import ProgressiveConfig as JaxProgressiveConfig
from libmems_tpu.progressive import progressive_align as jax_progressive
from libmems_tpu.sequence import Genome as JaxGenome
from libmems_tpu.tree import neighbor_joining as jax_neighbor_joining
import libmems_tpu_torch as lt
from libmems_tpu_torch import msa, trace
from libmems_tpu_torch.ops import profile
from libmems_tpu_torch.tree import neighbor_joining
from tests.golden import generate


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _text(write, *args):
    buf = io.StringIO()
    write(buf, *args)
    return buf.getvalue().encode()


def _family_seqs(rng, G, n, mutate=0.03, indels=3):
    """G 2-bit code sequences: a common ancestor with substitutions and
    short indels each."""
    anc = rng.integers(0, 4, n).astype(np.uint8)
    out = []
    for _ in range(G):
        s = anc.copy()
        sub = rng.random(n) < mutate
        s[sub] = rng.integers(0, 4, int(sub.sum()))
        for _ in range(indels):
            at = int(rng.integers(0, len(s)))
            z = int(rng.integers(1, 6))
            if rng.random() < 0.5:
                s = np.concatenate([s[:at], rng.integers(0, 4, z), s[at:]])
            else:
                s = np.concatenate([s[:at], s[at + z:]])
        out.append(s.astype(np.uint8))
    return out


def test_align_codes_with_refinement_equals_jax():
    rng = np.random.default_rng(31)
    seqs = _family_seqs(rng, 5, 300)
    ref = jmsa.align_codes(seqs, refine_iters=1)
    got = lt.align_codes(seqs, refine_iters=1, device="cpu")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        msa.kmer_distance_matrix(seqs), jmsa.kmer_distance_matrix(seqs))


def test_refine_two_iterations_equals_jax():
    """Rows from a deliberately poor alignment (each sequence padded at
    its end), so refinement has work to do; with and without a tree."""
    rng = np.random.default_rng(32)
    seqs = _family_seqs(rng, 4, 250, mutate=0.05, indels=4)
    C = max(len(s) for s in seqs)
    rows = np.full((len(seqs), C), 4, np.uint8)
    for g, s in enumerate(seqs):
        rows[g, :len(s)] = s
    ref = jmsa.refine(rows, iters=2)
    got = lt.refine(rows, iters=2, device="cpu")
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, rows)
    tree = neighbor_joining(msa.kmer_distance_matrix(seqs))
    jtree = jax_neighbor_joining(jmsa.kmer_distance_matrix(seqs))
    np.testing.assert_array_equal(lt.refine(rows, tree, device="cpu"),
                                  jmsa.refine(rows, jtree))


def test_refine_windows_equals_jax():
    """Many windows in one batched round: near-optimal ones, shifted
    gaps that a re-alignment repairs, and one with a large insertion."""
    rng = np.random.default_rng(33)
    chunks = []
    for k in range(6):
        seqs = _family_seqs(rng, 4, 150 + 40 * k, mutate=0.02)
        C = max(len(s) for s in seqs) + 3
        rows = np.full((4, C), 4, np.uint8)
        for g, s in enumerate(seqs):
            off = (g * k) % 4
            rows[g, off:off + len(s)] = s
        chunks.append(rows)
    ref = jmsa.refine_windows([c.copy() for c in chunks], iters=1)
    got = msa.refine_windows([c.copy() for c in chunks], iters=1,
                             device="cpu")
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert any(not np.array_equal(g, c) for g, c in zip(got, chunks))


def _four(rng_seed=61, n=25_000):
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    out = [anc]
    for g in range(1, 4):
        inv = (7_000, 10_000) if g == 2 else None
        out.append(generate._mutant(rng, anc, mutate=0.015, invert=inv))
    return [generate._LUT[g] for g in out]


def test_four_genome_refined_xmfa_equals_jax():
    fam = _four()
    ref, _ = jax_progressive([JaxGenome(f"g{i}", a)
                              for i, a in enumerate(fam)],
                             JaxProgressiveConfig())
    trace.reset()
    trace.set_enabled(True, stream=io.StringIO())
    stats0 = dict(profile.BAND_STATS)
    try:
        ivs, _ = lt.progressive_align(
            [lt.Genome(f"g{i}", a) for i, a in enumerate(fam)],
            lt.ProgressiveConfig(device="cpu"))
        stages = trace.stage_seconds()
    finally:
        trace.set_enabled(False)
    assert _text(lt.write_xmfa, ivs) == _text(jax_write_xmfa, ref)
    for name in ("refine", "refine/profiles", "refine/gate_forward",
                 "refine/gate_path_score"):
        assert name in stages, name
    assert profile.BAND_STATS["certified"] > stats0["certified"]


def test_nine_golden_family_refined_outputs_equal_jax():
    """The nine-genome golden family with refine=True: XMFA, bbseq and
    bbcols after apply_backbone equal the JAX package's."""
    ref_ivs, _ = jax_progressive(generate._genomes_nine(),
                                 JaxProgressiveConfig())
    ref_new, ref_segs = jax_apply_backbone(ref_ivs)
    gs = [lt.Genome(g.name, g.ascii, filename=g.filename)
          for g in generate._genomes_nine()]
    ivs, _ = lt.progressive_align(gs, lt.ProgressiveConfig(device="cpu"))
    new_ivs, segs = lt.apply_backbone(ivs, device="cpu")
    assert _text(lt.write_xmfa, new_ivs) == _text(jax_write_xmfa, ref_new)
    assert _text(lt.write_backbone_seq_coordinates, segs, len(gs)) == \
        _text(jax_bbseq, ref_segs, len(gs))
    assert _text(lt.write_backbone_columns, segs) == \
        _text(jax_bbcols, ref_segs)
    # refinement changed the alignment: the goldens are refine=False's
    with open(f"{generate.GOLDEN_DIR}/nine.xmfa", "rb") as fh:
        assert _text(lt.write_xmfa, new_ivs) != fh.read()
