"""Port parity: the flat aligner end to end against the JAX package and
the golden XMFA, on pairs, trios and quads; import isolation and device
handling."""

import io
import subprocess
import sys

import numpy as np
import pytest
import torch

from libmems_tpu.aligner import AlignerConfig as JaxConfig
from libmems_tpu.aligner import align as jax_align
from libmems_tpu.interval import write_xmfa as jax_write_xmfa
from libmems_tpu.sequence import Genome as JaxGenome
from bench_e2e import _mutant_family
from libmems_tpu_torch import AlignerConfig, Genome, align, write_xmfa
from tests.golden import generate


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _golden_pair():
    return [Genome(g.name, g.ascii, filename=g.filename)
            for g in generate._genomes_pair()]


def _xmfa(write, ivs):
    buf = io.StringIO()
    write(buf, ivs)
    return buf.getvalue()


def test_pair_xmfa_golden_bytes():
    ivs, _ = align(_golden_pair(),
                   AlignerConfig(gapped_alignment=True, device="cpu"))
    with open(f"{generate.GOLDEN_DIR}/pair.xmfa", "rb") as fh:
        assert _xmfa(write_xmfa, ivs).encode() == fh.read()


def _random_pair(rng_seed, n=30_000):
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    b = generate._mutant(rng, anc, mutate=0.02, indel=0.002,
                         invert=(9_000, 15_000))
    return generate._LUT[anc], generate._LUT[b]


@pytest.mark.parametrize("rng_seed", [21, 22])
def test_anchor_intervals_equal_jax(rng_seed):
    a, b = _random_pair(rng_seed)
    ivs, mums = align([Genome("a", a), Genome("b", b)],
                      AlignerConfig(device="cpu"))
    ref_ivs, ref_mums = jax_align([JaxGenome("a", a), JaxGenome("b", b)],
                                  JaxConfig())
    np.testing.assert_array_equal(mums.starts, ref_mums.starts)
    assert len(ivs.intervals) == len(ref_ivs.intervals) > 1
    assert _xmfa(write_xmfa, ivs) == _xmfa(jax_write_xmfa, ref_ivs)


def test_gapped_recursive_equal_jax():
    a, b = _random_pair(23)
    cfg = dict(gapped_alignment=True, recursive=True)
    ivs, _ = align([Genome("a", a), Genome("b", b)],
                   AlignerConfig(device="cpu", **cfg))
    ref_ivs, _ = jax_align([JaxGenome("a", a), JaxGenome("b", b)],
                           JaxConfig(**cfg))
    assert _xmfa(write_xmfa, ivs) == _xmfa(jax_write_xmfa, ref_ivs)


def test_import_loads_no_jax():
    code = ("import sys, libmems_tpu_torch, libmems_tpu_torch.repeats, "
            "libmems_tpu_torch.ops.gapped, libmems_tpu_torch.ops.hmm, "
            "libmems_tpu_torch.native, libmems_tpu_torch.ops.profile, "
            "libmems_tpu_torch.parallel, libmems_tpu_torch.ops.shard; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'libmems_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' runs instead")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        align(_golden_pair(), AlignerConfig(gapped_alignment=True,
                                            device="cuda"))


def _family(G, n=80_000, **kw):
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [lut[g] for g in _mutant_family(G, n, rng_seed=5, **kw)]


@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("cfg", [
    dict(),
    dict(gapped_alignment=True, recursive=False),
    dict(gapped_alignment=True, recursive=True),
], ids=["anchors", "gapped", "gapped_recursive"])
def test_multi_genome_xmfa_equal_jax(G, cfg):
    asc = _family(G)
    ivs, mums = align([Genome(f"g{i}", a) for i, a in enumerate(asc)],
                      AlignerConfig(device="cpu", **cfg))
    ref_ivs, ref_mums = jax_align(
        [JaxGenome(f"g{i}", a) for i, a in enumerate(asc)], JaxConfig(**cfg))
    np.testing.assert_array_equal(mums.starts, ref_mums.starts)
    np.testing.assert_array_equal(mums.lengths, ref_mums.lengths)
    assert len(ivs.intervals) == len(ref_ivs.intervals) > G
    assert _xmfa(write_xmfa, ivs) == _xmfa(jax_write_xmfa, ref_ivs)


@pytest.mark.parametrize("case", ["three_genomes", "mesh"])
def test_unported_configurations_raise(case):
    """Configurations that once raised now run.  A mesh: the golden pair
    seeded through the sharded pipeline on two CPU shards (a shard count
    on a CPU run) writes pair.xmfa byte for byte.  Three genomes: a
    divergent trio, whose LCB-extension loop searches its collinear gaps
    with three-genome masked searches (seq_mask 0b111), gives the JAX
    package's anchors and intervals."""
    if case == "mesh":
        # one intra-op thread: the sharded plain versions run many small
        # tensor operations, which contend with the other test workers
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            ivs, _ = align(_golden_pair(), AlignerConfig(
                gapped_alignment=True, device="cpu", mesh=2))
        finally:
            torch.set_num_threads(threads)
        with open(f"{generate.GOLDEN_DIR}/pair.xmfa", "rb") as fh:
            assert _xmfa(write_xmfa, ivs).encode() == fh.read()
        return
    asc = _family(3, n=25_000, mutate=0.03, indel=0.002)
    ivs, mums = align([Genome(f"g{i}", a) for i, a in enumerate(asc)],
                      AlignerConfig(device="cpu"))
    ref_ivs, ref_mums = jax_align(
        [JaxGenome(f"g{i}", a) for i, a in enumerate(asc)], JaxConfig())
    np.testing.assert_array_equal(mums.starts, ref_mums.starts)
    assert _xmfa(write_xmfa, ivs) == _xmfa(jax_write_xmfa, ref_ivs)
