"""Port parity: the multi-process slice (parallel/multihost.py and the
mesh that spans processes).  Two processes, spawned as fresh interpreters
(tests/torch_multihost_worker.py), join a gloo group and run 2 CPU shards
each on the JAX package's multi-process dryrun family
(libmems_tpu/parallel/multihost_dryrun.py:37-45); each child has 120 s,
so a hang fails instead of stalling the suite.  This process holds their
results to the JAX package's and to the port's single-process runs:
match rows, key tables and XMFA bytes equal."""

import importlib.util
import io
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from libmems_tpu import seeds as jseeds
from libmems_tpu.aligner import AlignerConfig as JaxConfig
from libmems_tpu.aligner import align as jax_align
from libmems_tpu.interval import write_xmfa as jax_write_xmfa
from libmems_tpu.matchfind import find_mums as jax_find_mums
from libmems_tpu.matchfind import find_pairwise_mums as jax_find_pairwise
from libmems_tpu.parallel.shard import make_mesh as jax_make_mesh
from libmems_tpu.sequence import Genome as JaxGenome
from libmems_tpu.sml import SortedMerList as JaxSML
import libmems_tpu_torch as lt
from libmems_tpu_torch.parallel import multihost as mh
from libmems_tpu_torch.parallel import shard as psh


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multihost_worker.py")
CHILD_TIMEOUT_S = 120
WORLD = 2
CPU = torch.device("cpu")

_spec = importlib.util.spec_from_file_location("torch_multihost_worker",
                                               WORKER)
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)
SEED = jseeds.get_seed(9, 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results: each child a fresh interpreter (spawned, not
    forked), killed at CHILD_TIMEOUT_S."""
    out = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(HERE)]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD),
                               str(port), str(out)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank did not finish within {CHILD_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    res = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as fh:
            res.append(pickle.load(fh))
    return res


@pytest.fixture(scope="module")
def family():
    """(codes, the port's Genomes, the JAX package's Genomes, JAX SMLs)."""
    fam = worker.dryrun_family()
    genomes = [lt.Genome(name=f"g{i}", ascii=worker.LUT[g], codes=g)
               for i, g in enumerate(fam)]
    jgenomes = [JaxGenome(name=f"g{i}", ascii=worker.LUT[g], codes=g)
                for i, g in enumerate(fam)]
    return fam, genomes, jgenomes, [JaxSML.create(g, SEED) for g in fam]


@pytest.mark.parametrize("mode", ["default", "pairwise", "tiled"])
def test_multihost_find_mums_equals_jax(ranks, family, mode):
    """Every rank returns the same rows, the JAX package's find_mums
    (default and tiled) or find_pairwise_mums (pairwise)."""
    jsmls = family[3]
    want = jax_find_pairwise(jsmls) if mode == "pairwise" \
        else jax_find_mums(jsmls)
    assert len(want) > 10
    assert [r["mesh"] for r in ranks] == [(4, [0, 1]), (4, [2, 3])]
    for r in ranks:
        np.testing.assert_array_equal(r[mode][0], want.starts)
        np.testing.assert_array_equal(r[mode][1], want.lengths)


def test_gather_key_tables_equals_each_genome(ranks, family):
    """Each rank owns its round-robin share and ends with every genome's
    key table, equal to that genome's keys."""
    fam, _, _, jsmls = family
    assert [r["owned"] for r in ranks] == [[0, 2, 4], [1, 3, 5]]
    for r in ranks:
        assert len(r["tables"]) == len(fam)
        for got, js in zip(r["tables"], jsmls):
            np.testing.assert_array_equal(
                got, np.asarray(js.keys).astype(np.int64))


def _xmfa(write, ivs) -> bytes:
    buf = io.StringIO()
    write(buf, ivs)
    return buf.getvalue().encode()


def test_multihost_align_equals_single_process_and_jax(ranks, family):
    """multihost_align's XMFA bytes: equal in both ranks, equal to the
    port's align on a 4-shard mesh in one process and to the JAX
    package's align on make_mesh(4)."""
    _, genomes, jgenomes, _ = family
    ivs, _ = lt.align(genomes, lt.AlignerConfig(
        recursive=False, device="cpu", mesh=psh.Mesh([CPU] * 4)))
    one = _xmfa(lt.write_xmfa, ivs)
    jivs, _ = jax_align(jgenomes, JaxConfig(recursive=False,
                                             mesh=jax_make_mesh(4)))
    assert one == _xmfa(jax_write_xmfa, jivs)
    for r in ranks:
        assert r["xmfa"] == one


def test_multihost_progressive_align_equals_single_process(ranks, family):
    _, genomes, _, _ = family
    ivs, _ = lt.progressive_align(genomes, lt.ProgressiveConfig(
        refine=False, gap_search=False, use_bp_distance=False, device="cpu",
        mesh=psh.Mesh([CPU] * 4)))
    one = _xmfa(lt.write_xmfa, ivs)
    assert len(one) > 1000
    for r in ranks:
        assert r["pxmfa"] == one


def test_assert_processes_agree_raises_on_divergence(ranks):
    for r in ranks:
        assert r["diverged"] is not None
        assert "rank bytes" in r["diverged"]


def test_single_process_wrappers(family):
    """In one process the wrappers add nothing (tests/test_multihost.py:
    19): the tripwire is a no-op, multihost_align equals align on the
    global mesh, and the progressive wrapper aligns."""
    _, genomes, _, _ = family
    mh.assert_processes_agree("noop", b"x")
    assert mh.owned_genomes(3) == [0, 1, 2]
    cfg = lt.AlignerConfig(recursive=False, device="cpu")
    ivs_mh, _ = mh.multihost_align(genomes[:3], cfg)
    ivs_1p, _ = lt.align(genomes[:3], lt.AlignerConfig(
        recursive=False, device="cpu", mesh=mh.global_mesh(device="cpu")))
    assert mh._xmfa_bytes(ivs_mh) == mh._xmfa_bytes(ivs_1p)
    pivs, _ = mh.multihost_progressive_align(
        genomes[:3], lt.ProgressiveConfig(refine=False, gap_search=False,
                                          use_bp_distance=False,
                                          device="cpu"))
    assert len(pivs.intervals) > 0
