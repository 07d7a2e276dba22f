"""Multi-process entry for the sharded alignment pipeline.

Port of libmems_tpu/parallel/multihost.py on ``torch.distributed``: the
reference's out-of-core key-range partitioning (dmSML/dmsort.c bins the
mer stream by key prefix across scratch disks; FileSML::BigCreate/Merge)
promoted across processes:

* host-sharded SML construction: each process builds the sorted mer
  index only for the genomes it owns (``owned_genomes``);
* one mesh spanning every process's shards (``global_mesh``: one card a
  process with NCCL, or CPU shards with gloo); the seed-prefix routing,
  shard-local enumeration and extension of ``parallel.shard`` run over it,
  the route and span exchanges being ``all_to_all_single`` between the
  processes;
* the position-order key tables assembled everywhere by a one-time
  exchange (``gather_key_tables``), which the unsharded stages and the
  replicated extension read; ``multihost_find_mums(tiled=True)`` extends
  against position tiles instead, no shard holding the whole table.

Everything after seeding runs redundantly in every process on the same
gathered inputs, and the XMFA bytes are compared across processes
(``assert_processes_agree``).  Launch one process a card, each calling
``initialize`` with the coordinator's address, the world size and its
rank, e.g. ``initialize("localhost:29500", 4, rank)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os

import numpy as np
import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch import seeds as seedlib
from libmems_tpu_torch.parallel.shard import (Mesh, make_mesh, process_count,
                                              process_index)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group: ``init_process_group`` at
    tcp://coordinator_address with the world size and this rank.  The
    backend is NCCL where CUDA is available (this process's card, its
    local rank, is made current and named to NCCL first) and gloo
    otherwise.  Fewer than two processes do nothing, as in the JAX
    package."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize needs the coordinator's address, the "
                         "number of processes and this process's rank")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        local = local_rank(process_id)
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kw)


def local_rank(process_id: int | None = None) -> int:
    """This process's card on its host: LOCAL_RANK where a launcher sets
    it, else the rank modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_index() if process_id is None else process_id
    return rank % max(torch.cuda.device_count(), 1)


def global_mesh(shards_per_process: int | None = None,
                device=None) -> Mesh:
    """The mesh over every process's shards.  Across processes: one
    shard a process on its card with NCCL, or `shards_per_process` shards
    on its CPU with gloo (the tests' layout); any process may also take
    several shards of its card.  In one process: every visible card
    (make_mesh), or `shards_per_process` shards of `device` where it is
    the CPU (one by default).  `device` defaults to the card: without a
    usable GPU it raises (cuda.resolve_device); the CPU mesh is asked for
    with device="cpu"."""
    n_proc = process_count()
    k = shards_per_process or 1
    if n_proc == 1:
        dev = cuda.resolve_device("cuda" if device is None else device)
        if dev.type == "cuda" and shards_per_process is None:
            return make_mesh()
        return Mesh([dev] * k)
    cpu = torch.distributed.get_backend() == "gloo"
    devices = [torch.device("cpu") if cpu else
               torch.device("cuda", local_rank(r))
               for r in range(n_proc) for _ in range(k)]
    return Mesh(devices, [r for r in range(n_proc) for _ in range(k)])


def owned_genomes(n_genomes: int) -> list[int]:
    """Genome ids this process owns (round robin by rank): the
    host-sharded analog of dmSML's per-scratch-device bin ownership."""
    pid, nproc = process_index(), process_count()
    return [g for g in range(n_genomes) if g % nproc == pid]


class KeyTable:
    """A stand-in for SortedMerList carrying what the sharded finders
    read: the position-order canonical keys (int64 tensor) and the seed.
    (The sorted arrays of a full SML are not needed: the sharded pipeline
    sorts routed rows shard-locally.)"""

    def __init__(self, seed: int, keys: torch.Tensor):
        self.seed = seed
        self.keys = keys

    @property
    def n_windows(self) -> int:
        return int(self.keys.shape[0])

    @property
    def seed_length(self) -> int:
        return seedlib.seed_length(self.seed)

    @property
    def seed_weight(self) -> int:
        return seedlib.seed_weight(self.seed)

    @property
    def device(self) -> torch.device:
        return self.keys.device


def build_owned_smls(genomes, seed: int, device="cuda") -> dict:
    """SMLs of this process's genomes only, on `device`.  `genomes` maps
    genome id -> Genome or codes; a list is every genome, of which the
    owned ones are built.  Returns {genome_id: SortedMerList}."""
    from libmems_tpu_torch.sml import SortedMerList
    if isinstance(genomes, dict):
        items = genomes.items()
    else:
        items = [(g, genomes[g]) for g in owned_genomes(len(genomes))]
    return {g: SortedMerList.create(v, seed, device=device)
            for g, v in items}


def _comm_device() -> torch.device:
    """Where this process's collectives run: its card under NCCL, the
    CPU under gloo or without a process group."""
    if process_count() > 1 and torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_key_tables(owned_smls: dict, n_genomes: int,
                      seed: int) -> list[KeyTable]:
    """Every genome's key table in every process (the one-time
    replication of O(total windows) bytes): the lengths summed first,
    then zero-padded key planes, each genome's row non-zero only on its
    owner, summed with all_reduce (an int64 sum of one non-zero term is
    exact).  The tables lie on the process's collective device (its card
    under NCCL, the CPU under gloo); in one process they are the owned
    SMLs' keys."""
    if process_count() <= 1:
        return [KeyTable(seed, owned_smls[g].keys) for g in range(n_genomes)]
    dev = _comm_device()
    lengths = torch.zeros(n_genomes, dtype=torch.int64, device=dev)
    for g, s in owned_smls.items():
        lengths[g] = s.n_windows
    torch.distributed.all_reduce(lengths)
    lengths = lengths.tolist()
    buf = torch.zeros((n_genomes, max(lengths)), dtype=torch.int64,
                      device=dev)
    for g, s in owned_smls.items():
        buf[g, :s.n_windows] = s.keys.to(dev)
    torch.distributed.all_reduce(buf)
    return [KeyTable(seed, buf[g, :lengths[g]].clone())
            for g in range(n_genomes)]


def assert_processes_agree(tag: str, data: bytes) -> None:
    """Cross-process divergence tripwire of the redundant host stages:
    all_gather a sha256 of `data` and raise RuntimeError if any process
    computed something else (a silent divergence would corrupt every
    later collective).  Nothing in one process."""
    if process_count() <= 1:
        return
    digest = np.frombuffer(hashlib.sha256(data).digest(), np.uint8)
    h = torch.from_numpy(digest.astype(np.int64)).to(_comm_device())
    outs = [torch.empty_like(h) for _ in range(process_count())]
    torch.distributed.all_gather(outs, h)
    rows = [o.cpu().numpy() for o in outs]
    if any(not np.array_equal(r, rows[0]) for r in rows):
        raise RuntimeError(
            f"multi-process divergence at {tag!r}: processes computed "
            f"different results "
            f"({[bytes(r.astype(np.uint8)).hex()[:16] for r in rows]})")


def _xmfa_bytes(ivs) -> bytes:
    from libmems_tpu_torch.interval import write_xmfa
    buf = io.StringIO()
    write_xmfa(buf, ivs)
    return buf.getvalue().encode()


def multihost_align(genomes, config=None):
    """Flat alignment across processes (Aligner.cpp:2193 promoted): the
    host-sharded index build and the seed-prefix-sharded seeding span the
    global mesh; every later stage (overlap trim, LCBs, gapped DP, XMFA)
    runs redundantly in every process on the same gathered matches.  The
    XMFA bytes are compared across processes before returning.  Returns
    (IntervalList, MatchArray) in every process."""
    from libmems_tpu_torch.aligner import AlignerConfig, align
    cfg = config or AlignerConfig()
    if cfg.mesh is None:
        cfg = dataclasses.replace(cfg, mesh=global_mesh(device=cfg.device))
    ivs, mums = align(genomes, cfg)
    assert_processes_agree("align/xmfa", _xmfa_bytes(ivs))
    return ivs, mums


def multihost_progressive_align(genomes, config=None):
    """Progressive alignment across processes (PA.cpp:3779 promoted; the
    contract of multihost_align).  Returns (IntervalList, guide tree) in
    every process, the XMFA compared across processes."""
    from libmems_tpu_torch.progressive import (ProgressiveConfig,
                                               progressive_align)
    cfg = config or ProgressiveConfig()
    if cfg.mesh is None:
        cfg = dataclasses.replace(cfg, mesh=global_mesh(device=cfg.device))
    ivs, tree = progressive_align(genomes, cfg)
    assert_processes_agree("progressive/xmfa", _xmfa_bytes(ivs))
    return ivs, tree


def multihost_find_mums(genomes, seed: int | None = None, mesh=None,
                        pairwise: bool = False, tiled: bool = False,
                        device=None, **kw):
    """Host-sharded seeding: each process builds its owned SMLs (on
    `device`, by default the mesh's), the key tables are exchanged once,
    and the seed-prefix-sharded finder runs over the mesh
    (sharded_find_pairwise_mums with pairwise, sharded_find_mums_tiled
    with tiled, sharded_find_mums otherwise; `kw` goes to it).  Every
    process receives the same MatchArray.  The multi-process twin of
    MatchList::LoadSMLs + MemHash::FindMatches (MatchList.h:261-349,
    MemHash.cpp:109)."""
    from libmems_tpu_torch.parallel.shard import (sharded_find_mums,
                                                  sharded_find_mums_tiled,
                                                  sharded_find_pairwise_mums)
    from libmems_tpu_torch.sml import default_seed
    if mesh is None:
        mesh = global_mesh(device=device)
    if device is None:
        device = mesh.comm_device
    if seed is None:
        seed = default_seed(genomes)
    owned = build_owned_smls(genomes, seed, device=device)
    tables = gather_key_tables(owned, len(genomes), seed)
    if pairwise:
        find = sharded_find_pairwise_mums
    elif tiled:
        find = sharded_find_mums_tiled
    else:
        find = sharded_find_mums
    return find(tables, mesh, **kw)
