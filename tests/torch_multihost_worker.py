"""One rank of the port's multi-process run (tests/test_torch_multihost.py).

    python tests/torch_multihost_worker.py RANK WORLD PORT OUT_DIR

Joins a process group of WORLD processes at tcp://localhost:PORT (gloo
on a machine without CUDA, where the tests run),
takes 2 CPU shards, and runs on the family of the JAX package's
multi-process dryrun (libmems_tpu/parallel/multihost_dryrun.py:37-45:
rng 7, 6 x 3,000 bp mutants, seed get_seed(9, 0)): multihost_find_mums
(default, pairwise, tiled), gather_key_tables, multihost_align,
multihost_progressive_align, and assert_processes_agree on bytes that
differ by rank.  Writes its results to OUT_DIR/rank<RANK>.pkl.  Imports
the port only.
"""

import os
import pickle
import sys

import numpy as np
import torch

SHARDS_PER_PROCESS = 2
LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def dryrun_family():
    """The JAX dryrun's family: every process makes the same genomes."""
    rng = np.random.default_rng(7)
    anc = rng.integers(0, 4, size=3000).astype(np.uint8)
    fam = []
    for _ in range(6):
        g = anc.copy()
        idx = rng.random(len(g)) < 0.02
        g[idx] = rng.integers(0, 4, size=int(idx.sum())).astype(np.uint8)
        fam.append(g)
    return fam


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    import libmems_tpu_torch as lt
    from libmems_tpu_torch import seeds
    from libmems_tpu_torch.parallel import multihost as mh

    mh.initialize(f"localhost:{port}", world, rank)
    fam = dryrun_family()
    genomes = [lt.Genome(name=f"g{i}", ascii=LUT[g], codes=g)
               for i, g in enumerate(fam)]
    seed = seeds.get_seed(9, 0)
    mesh = mh.global_mesh(SHARDS_PER_PROCESS)
    out = {"mesh": (mesh.size, mesh.local)}
    for mode, kw in (("default", {}), ("pairwise", {"pairwise": True}),
                     ("tiled", {"tiled": True})):
        ma = mh.multihost_find_mums(fam, seed, mesh=mesh, **kw)
        out[mode] = (ma.starts, ma.lengths)
    owned = mh.build_owned_smls(fam, seed, device="cpu")
    out["owned"] = sorted(owned)
    out["tables"] = [t.keys.numpy() for t in
                     mh.gather_key_tables(owned, len(fam), seed)]
    ivs, _ = mh.multihost_align(genomes, lt.AlignerConfig(
        recursive=False, device="cpu", mesh=mesh))
    out["xmfa"] = mh._xmfa_bytes(ivs)
    pivs, _ = mh.multihost_progressive_align(genomes, lt.ProgressiveConfig(
        refine=False, gap_search=False, use_bp_distance=False, device="cpu",
        mesh=mesh))
    out["pxmfa"] = mh._xmfa_bytes(pivs)
    try:
        mh.assert_processes_agree("rank bytes", b"rank %d" % rank)
        out["diverged"] = None
    except RuntimeError as e:
        out["diverged"] = str(e)
    torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
