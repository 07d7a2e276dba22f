"""Port parity: progressive alignment + backbone (the progressiveMauve
path) against the JAX package and the nine-genome goldens; unported
options; import isolation."""

import io
import subprocess
import sys

import numpy as np
import pytest
import torch

from libmems_tpu.interval import write_xmfa as jax_write_xmfa
from libmems_tpu.progressive import ProgressiveConfig as JaxProgressiveConfig
from libmems_tpu.progressive import progressive_align as jax_progressive
from libmems_tpu.sequence import Genome as JaxGenome
import libmems_tpu_torch as lt
from libmems_tpu_torch import anchorscore
from libmems_tpu_torch.ops import seedocc
from tests.golden import generate


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nine():
    return [lt.Genome(g.name, g.ascii, filename=g.filename)
            for g in generate._genomes_nine()]


def _text(write, *args):
    buf = io.StringIO()
    write(buf, *args)
    return buf.getvalue().encode()


def test_nine_goldens_bytes():
    gs = _nine()
    ivs, _ = lt.progressive_align(gs, lt.ProgressiveConfig(refine=False,
                                                           device="cpu"))
    new_ivs, segs = lt.apply_backbone(ivs, device="cpu")
    got = {"nine.xmfa": _text(lt.write_xmfa, new_ivs),
           "nine.bbseq": _text(lt.write_backbone_seq_coordinates, segs,
                               len(gs)),
           "nine.bbcols": _text(lt.write_backbone_columns, segs)}
    for name, data in got.items():
        with open(f"{generate.GOLDEN_DIR}/{name}", "rb") as fh:
            assert data == fh.read(), name


def _four(rng_seed=61, n=25_000):
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    out = [anc]
    for g in range(1, 4):
        inv = (7_000, 10_000) if g == 2 else None
        out.append(generate._mutant(rng, anc, mutate=0.015, invert=inv))
    return [generate._LUT[g] for g in out]


def test_four_genome_intervals_equal_jax():
    fam = _four()
    ref, _ = jax_progressive([JaxGenome(f"g{i}", a)
                              for i, a in enumerate(fam)],
                             JaxProgressiveConfig(refine=False))
    # validate=True also runs the copied invariant checks after each merge
    ivs, tree = lt.progressive_align(
        [lt.Genome(f"g{i}", a) for i, a in enumerate(fam)],
        lt.ProgressiveConfig(refine=False, device="cpu", validate=True))
    assert len(ivs.intervals) == len(ref.intervals) > 1
    assert _text(lt.write_xmfa, ivs) == _text(jax_write_xmfa, ref)
    assert sorted(leaf.sequence_id for leaf in tree.leaves()) == [0, 1, 2, 3]


def test_detect_backbone_segments_have_two_or_more_genomes():
    gs = _nine()
    ivs, _ = lt.progressive_align(gs, lt.ProgressiveConfig(refine=False,
                                                           device="cpu"))
    segs = lt.detect_backbone(ivs, device="cpu")
    assert segs and all(isinstance(s, lt.BackboneSegment) for s in segs)
    for s in segs:
        assert 0 <= s.left_col <= s.right_col
        assert len(s.genomes) >= 2


@pytest.mark.parametrize("case", ["mesh"])
def test_unported_options_raise(case):
    """Options that once raised now run: a mesh (here a shard count on a
    CPU run) seeds through the sharded pairwise seeder and writes the
    XMFA of the run without one."""
    gs = [lt.Genome(f"g{i}", a) for i, a in enumerate(_four(62, 4_000))]
    cfg = lt.ProgressiveConfig(refine=False, device="cpu", mesh=2)
    ivs, _ = lt.progressive_align(gs, cfg)
    ref, _ = lt.progressive_align(gs, lt.ProgressiveConfig(refine=False,
                                                           device="cpu"))
    assert len(ref.intervals) > 0
    assert _text(lt.write_xmfa, ivs) == _text(lt.write_xmfa, ref)


def test_seed_occurrence_device_route_writes_jax_xmfa(monkeypatch):
    """Genomes above SOL_HOST_MAX seed windows take the device seed
    occurrence construction (here the plain versions of K16 and K17):
    the four-genome family still aligns to the JAX package's XMFA
    bytes."""
    fam = _four(62, 4_000)
    ref, _ = jax_progressive([JaxGenome(f"g{i}", a)
                              for i, a in enumerate(fam)],
                             JaxProgressiveConfig(refine=False))
    calls = []
    real = seedocc.seed_run_counts
    monkeypatch.setattr(seedocc, "seed_run_counts",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(anchorscore, "SOL_HOST_MAX", 1_000)
    ivs, _ = lt.progressive_align(
        [lt.Genome(f"g{i}", a) for i, a in enumerate(fam)],
        lt.ProgressiveConfig(refine=False, device="cpu"))
    assert len(calls) == 4
    assert _text(lt.write_xmfa, ivs) == _text(jax_write_xmfa, ref)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' runs instead")
    gs = [lt.Genome(f"g{i}", a) for i, a in enumerate(_four(63, 3_000))]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lt.progressive_align(gs, lt.ProgressiveConfig(refine=False,
                                                      device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lt.find_pairwise_mums(gs, device="cuda")


def test_new_modules_import_no_jax():
    mods = ["libmems_tpu_torch", "libmems_tpu_torch.progressive",
            "libmems_tpu_torch.backbone", "libmems_tpu_torch.islands",
            "libmems_tpu_torch.anchorscore", "libmems_tpu_torch.distance",
            "libmems_tpu_torch.cga", "libmems_tpu_torch.gbe_sp",
            "libmems_tpu_torch.scoring", "libmems_tpu_torch.validate",
            "libmems_tpu_torch.ops.hmm", "libmems_tpu_torch.ops.pairwise",
            "libmems_tpu_torch.ops.seedocc", "libmems_tpu_torch.ops.pair",
            "libmems_tpu_torch.convert", "libmems_tpu_torch.msa",
            "libmems_tpu_torch.ops.profile", "libmems_tpu_torch.ops.gapped",
            "libmems_tpu_torch.profile_progressive"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'libmems_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
