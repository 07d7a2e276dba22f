"""Seed-prefix-range sharding of the mer table over a mesh of devices.

Port of libmems_tpu/parallel/shard.py (dmSML's key-prefix binning,
dmSML/dmsort.c, and ParallelMemHash's fan-out, libMems/ParallelMemHash.cpp:
42-121, promoted to devices):

1. the position-order window table of all genomes is cut into one slice
   per shard (the JAX package's slices of its bucket-padded table, whose
   padding rows only reached the drop bucket, so none is built here);
2. each shard sends every row to the owner of its canonical seed content
   (K26: a Fibonacci mix of the content, its top bits), the all_to_all
   being peer copies between the mesh's devices (``_all_to_all``);
3. each shard sorts what it received: equal-content runs are then local to
   one shard, so the single-device seed enumeration (K13, or K5 for the
   pairwise seeder) runs unchanged on each shard's table, and global
   counts are host sums of per-shard counts.

``sharded_find_mums`` then builds candidate rows (K27), extends them (K2)
against the position-order keys replicated on every device and dedups
them shard-locally (K28) before the host gather;
``sharded_find_pairwise_mums`` runs the pairwise seeder's stages (K5-K7,
K2) on each shard.  A capacity overflow doubles the capacity and retries,
as in the JAX package.

``sharded_find_mums_tiled`` is the position-tiled variant: no shard
holds the whole position-order key table, only its tile (K29-K31 fetch
the extension's spans from the tiles' owners).

A ``Mesh`` is an ordered list of devices, and a device may repeat in it:
four shards on one card run the same route, exchange (then local copies)
and retries as four cards.  A mesh may also span processes
(``torch.distributed``, parallel/multihost.py): each shard then belongs
to one process, a process runs only its own shards, the exchanges are
``all_to_all_single`` (NCCL between cards, gloo between CPU shards), the
host sums ``all_reduce`` and the results an ``all_gather``, so every
process returns the same result.
"""

from __future__ import annotations

import numpy as np
import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch.match import MatchArray
from libmems_tpu_torch.matchfind import MER_REPEAT_LIMIT, pairwise_rows
from libmems_tpu_torch.ops import mums as ops_mums
from libmems_tpu_torch.ops import pairwise as ops_pairwise
from libmems_tpu_torch.ops import shard as ops_shard
from libmems_tpu_torch.ops import tiled as ops_tiled
from libmems_tpu_torch.ops.extend import extend_matches
from libmems_tpu_torch.ops.mers import key_sentinel, sentinel_content
from libmems_tpu_torch.ops.pairwise import shr, usort

SHARD_AXIS = "shard"    # the JAX package's mesh axis name, kept for parity


def process_index() -> int:
    """This process's rank in torch.distributed (0 without it)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    """The processes of torch.distributed (1 without it)."""
    dist = torch.distributed
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


class Mesh:
    """An ordered list of devices, one shard each (a device may repeat).

    processes: the rank that runs each shard, ascending, every rank the
    same number of shards (parallel.multihost.global_mesh builds it);
    None runs every shard in this process.  A shard of another process
    is named by the device its process gives it.  A mesh that spans
    processes needs every local shard on one device, and the backend that
    device takes: NCCL for a card, gloo for the CPU (nothing falls back
    from one to the other)."""

    def __init__(self, devices, processes=None):
        me = process_index()
        if processes is not None and len(processes) != len(devices):
            raise ValueError("one process a shard")
        spans = processes is not None and process_count() > 1
        devs = []
        for i, d in enumerate(devices):
            mine = not spans or processes[i] == me
            d = cuda.resolve_device(d) if mine else torch.device(d)
            if d.type == "cuda" and d.index is None and mine:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs
        self.processes = None
        self.local = list(range(len(devs)))
        if spans:
            self._span(list(processes), me)

    def _span(self, processes, me):
        n_proc = process_count()
        per = len(processes) // n_proc
        if processes != [r for r in range(n_proc) for _ in range(per)]:
            raise ValueError(f"a mesh over {n_proc} processes needs the "
                             f"same number of shards in each, in rank order "
                             f"(got {processes})")
        self.processes = processes
        self.local = [i for i, r in enumerate(processes) if r == me]
        devs = {self.devices[i] for i in self.local}
        if len(devs) != 1:
            raise ValueError(f"a process's shards must share one device "
                             f"(got {sorted(map(str, devs))})")
        want = "nccl" if self.comm_device.type == "cuda" else "gloo"
        got = torch.distributed.get_backend()
        if got != want:
            raise RuntimeError(f"a mesh of {self.comm_device.type} shards "
                               f"across processes needs the {want} backend, "
                               f"not {got}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        return self.processes is not None

    @property
    def comm_device(self) -> torch.device:
        """The device of this process's shards (where its collectives
        run)."""
        return self.devices[self.local[0]]

    def local_devices(self) -> list:
        return [self.devices[i] for i in self.local]

    def __repr__(self) -> str:
        if self.processes is None:
            return f"Mesh({[str(d) for d in self.devices]})"
        return (f"Mesh({[str(d) for d in self.devices]}, processes="
                f"{self.processes})")


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The first n_devices visible CUDA devices (all by default; fewer
    where fewer exist, as the JAX package takes jax.devices()[:n]).  A
    mesh of CPU shards is built explicitly:
    ``Mesh([torch.device("cpu")] * n)``."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible")
    devs = [torch.device("cuda", i) for i in range(count)]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs)


def _bucket_len(n: int, minimum: int = 1 << 12) -> int:
    """libmems_tpu/sml.py _bucket_len: the sqrt(2)-spaced length buckets
    the JAX package pads tables to; here it only sizes the shard slices
    and the default capacities, as there."""
    b = minimum
    while b < n:
        b = b * 3 // 2
    return b


def _bucketed_total(smls, n_dev: int) -> int:
    """The bucket-padded window total rounded to the mesh size: the base
    of the default capacity and route_cap and of the shard slices."""
    totb = _bucket_len(sum(s.n_windows for s in smls))
    return totb + ((-totb) % n_dev)


def _default_caps(total: int, n_dev: int, capacity, route_cap):
    if capacity is None:
        capacity = max(256, 1 << (total // n_dev - 1).bit_length())
    if route_cap is None:
        # per-destination send capacity: 2x the balanced share of one
        # shard's rows (total / n_dev, spread over n_dev destinations)
        route_cap = max(256, 2 * (-(-total // n_dev) // n_dev))
    return capacity, route_cap


def _sentinels(weight: int) -> tuple[int, int]:
    """The masked-window key of a seed weight and its content field
    (ops.mers.key_sentinel, sentinel_content)."""
    if 2 * weight + 1 <= 32:
        return 0xFFFFFFFF, (1 << 31) - 1
    return -1, (1 << 63) - 1


def pad_table_for_mesh(keys, gid, pos, n_devices: int,
                       sentinel: int | None = None):
    """Pad the global window table to a multiple of the mesh size with
    sentinel rows (gid 0, pos 0).  The sentinel defaults to the all-ones
    pattern of the keys' dtype (the JAX package's for uint32/uint64 keys,
    the port's u64 sentinel -1 for int64 keys); int64 keys of a seed
    below weight 16 pass 0xFFFFFFFF."""
    keys, gid, pos = (np.asarray(x) for x in (keys, gid, pos))
    pad = (-len(keys)) % n_devices
    if pad:
        if sentinel is None:
            sentinel = ~keys.dtype.type(0)
        keys = np.concatenate([keys, np.full(pad, sentinel, keys.dtype)])
        gid = np.concatenate([gid, np.zeros(pad, gid.dtype)])
        pos = np.concatenate([pos, np.zeros(pad, pos.dtype)])
    return keys, gid, pos


def _all_to_all(send: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """send[i]: local shard i's [n_dev, C, ...] buffers on its device.
    Shard d receives cat over s of send[s][d], in source order (the
    layout of jax.lax.all_to_all(x, axis, 0, 0, tiled=False) flattened):
    by peer copies between cards or a local copy where two shards share
    one, or by one all_to_all_single where the mesh spans processes
    (equal splits: every process sends each its shards' slots).  Returns
    the local shards' receptions."""
    if not mesh.spans_processes:
        n = mesh.size
        return [torch.cat([send[s][d].to(mesh.devices[d], non_blocking=True)
                           for s in range(n)]) for d in range(n)]
    k, n_proc = len(mesh.local), process_count()
    x = torch.stack(send)                       # [k_src, n_dev, C, ...]
    rest = x.shape[2:]
    x = x.view(k, n_proc, k, *rest).transpose(0, 1).contiguous()
    out = torch.empty_like(x)                   # [n_proc, k_src, k_dst, ...]
    torch.distributed.all_to_all_single(out, x)
    return [out[:, :, j].reshape(-1, *rest[1:]) for j in range(k)]


def _exchange(parts: list[list[torch.Tensor]], mesh: Mesh):
    """A variable-length exchange: parts[i][d] is what local shard i
    sends to shard d (any length, one dtype and trailing shape).  Returns
    recv[j][s], what shard s sent to local shard j, on j's device.  In one
    process these are copies; across processes the counts go first (one
    all_to_all_single of n_dev counts a shard), then the data in one
    all_to_all_single split by them."""
    if not mesh.spans_processes:
        n = mesh.size
        return [[parts[s][d].to(mesh.devices[d], non_blocking=True)
                 for s in range(n)] for d in range(n)]
    dist = torch.distributed
    k, n_proc, dev = len(mesh.local), process_count(), mesh.comm_device
    sizes = torch.tensor([[[parts[i][q * k + j].shape[0] for j in range(k)]
                           for i in range(k)] for q in range(n_proc)],
                         dtype=torch.int64)          # [n_proc, k_src, k_dst]
    got = torch.empty_like(sizes, device=dev)
    dist.all_to_all_single(got, sizes.to(dev))
    got = got.cpu()
    inp = torch.cat([parts[i][q * k + j] for q in range(n_proc)
                     for i in range(k) for j in range(k)])
    out = torch.empty((int(got.sum()), *inp.shape[1:]), dtype=inp.dtype,
                      device=dev)
    dist.all_to_all_single(out, inp, got.sum((1, 2)).tolist(),
                           sizes.sum((1, 2)).tolist())
    pieces = torch.split(out, got.flatten().tolist())   # (p, s, j) order
    return [[pieces[(p * k + s) * k + j] for p in range(n_proc)
             for s in range(k)] for j in range(k)]


def _sum_all(mesh: Mesh, values: list[int]) -> list[int]:
    """Host sums over the mesh's processes (the JAX package's psums):
    every process gets the same, so every one takes the same branch."""
    if not mesh.spans_processes:
        return list(values)
    t = torch.tensor(values, dtype=torch.int64, device=mesh.comm_device)
    torch.distributed.all_reduce(t)
    return t.tolist()


def _max_all(mesh: Mesh, value: int) -> int:
    if not mesh.spans_processes:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=mesh.comm_device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return int(t.item())


def _all_shards(mesh: Mesh, local: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every shard's tensor (one shape for all) in shard order: the local
    list itself in one process, an all_gather onto this process's device
    across processes."""
    if not mesh.spans_processes:
        return local
    x = torch.stack(local)
    outs = [torch.empty_like(x) for _ in range(process_count())]
    torch.distributed.all_gather(outs, x)
    return [o[i] for o in outs for i in range(len(local))]


def _gather_rows(mesh: Mesh, starts: list, lengths: list, G: int):
    """This process's match rows (lists of int64 arrays) and every other
    process's, in process order: the sizes first, then the rows padded to
    the largest, one all_gather each (the JAX package's _np_global)."""
    st = np.concatenate(starts) if starts else np.zeros((0, G), np.int64)
    ln = np.concatenate(lengths) if lengths else np.zeros(0, np.int64)
    if not mesh.spans_processes:
        return st, ln
    dist, dev = torch.distributed, mesh.comm_device
    n_proc = process_count()
    size = torch.tensor([len(ln)], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(n_proc)]
    dist.all_gather(sizes, size)
    sizes = [int(x.item()) for x in sizes]
    rows = torch.zeros((max(sizes), G + 1), dtype=torch.int64, device=dev)
    rows[:len(ln), :G] = torch.from_numpy(st)
    rows[:len(ln), G] = torch.from_numpy(ln)
    outs = [torch.empty_like(rows) for _ in range(n_proc)]
    dist.all_gather(outs, rows)
    got = np.concatenate([o[:m].cpu().numpy() for o, m in zip(outs, sizes)])
    return got[:, :G], got[:, G]


def _replicas(t: torch.Tensor, mesh: Mesh) -> dict:
    """t on every distinct device of this process's shards (one copy a
    device)."""
    return {d: t.to(d) for d in dict.fromkeys(mesh.local_devices())}


def _route(mesh: Mesh, slices, sentinel: int, cap: int):
    """Route each local shard's slice (keys int64 on its device, the
    index of its first row in the table) to the content owners (K26),
    exchange, and sort each local shard's received rows by content,
    stably: rows arrive in ascending source index, so that is the
    (content, gid, pos) order.  Returns ([(content, src, key) per local
    shard], this process's rows dropped past cap)."""
    n_dev = mesh.size
    sends = []
    for (k, base), dev in zip(slices, mesh.local_devices()):
        with cuda.on(dev):
            sends.append(ops_shard.route_fill(k, base, sentinel, n_dev, cap))
    recv_k = _all_to_all([s.keys for s in sends], mesh)
    recv_src = _all_to_all([s.src for s in sends], mesh)
    dropped = sum(int(s.dropped) for s in sends)
    tables = []
    for rk, rs, dev in zip(recv_k, recv_src, mesh.local_devices()):
        with cuda.on(dev):
            content, order = torch.sort(shr(rk, 1), stable=True)
            tables.append((content, rs[order], rk[order]))
    return tables, dropped


def _as_keys(keys) -> torch.Tensor:
    """Keys as the port's int64 (numpy uint32 widened, uint64 viewed)."""
    if isinstance(keys, torch.Tensor):
        return keys.to(torch.int64)
    keys = np.asarray(keys)
    if keys.dtype == np.uint64:
        return torch.from_numpy(keys.view(np.int64).copy())
    return torch.from_numpy(keys.astype(np.int64))


def _table_layout(keys: torch.Tensor, gid, pos, sentinel: int) -> np.ndarray:
    """Genome bounds int64[G+1] of a position-order table (each genome's
    windows in order, then sentinel padding, as pad_table_for_mesh
    leaves it)."""
    gid = np.asarray(gid, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)
    n = len(gid)
    G = int(gid.max()) + 1 if n else 0
    _, first = np.unique(gid, return_index=True)
    offs = np.full(G, -1, np.int64)
    offs[np.unique(gid)] = first
    ok = (pos == np.arange(n) - offs[gid]) if n else np.zeros(0, bool)
    ok[1:] &= np.diff(gid) >= 0
    n_real = int(np.argmin(ok)) if n and not ok.all() else n
    tail = keys[n_real:].cpu().numpy()
    if (offs < 0).any() or not np.all(tail == sentinel):
        raise ValueError("the table must hold each genome's windows in "
                         "position order, then sentinel padding")
    return np.concatenate([offs, [n_real]])


def _table_slices(keys: torch.Tensor, mesh: Mesh, T: int):
    """Local shard d's rows [d*T, (d+1)*T) of the table (clipped to its
    end) on its device, with the index of the first."""
    n = keys.shape[0]
    return [(keys[min(d * T, n):min((d + 1) * T, n)].to(mesh.devices[d]),
             min(d * T, n)) for d in mesh.local]


def _route_table(keys, gid, pos, mesh: Mesh, weight: int):
    """Route a global window table (the arguments of sharded_seed_table)
    with T = len / mesh size rows a slice and T slots a destination.
    Returns (the local shards' (content, src, key) tables, the genome
    bounds int64[G+1], the keys int64, the masked-window key)."""
    keys = _as_keys(keys)
    if keys.shape[0] % mesh.size:
        raise ValueError("pad the table to a multiple of the mesh size "
                         "(pad_table_for_mesh)")
    sentinel, _ = _sentinels(weight)
    seg_off = torch.from_numpy(_table_layout(keys, gid, pos, sentinel))
    T = keys.shape[0] // mesh.size
    tables, _ = _route(mesh, _table_slices(keys, mesh, T), sentinel, T)
    return tables, seg_off, keys, sentinel


def sharded_seed_table(keys, gid, pos, mesh: Mesh, weight: int):
    """Route windows to their content owners and sort shard-locally.

    keys/gid/pos: the global window table (keys int64, or the JAX
    package's uint32/uint64), its length a multiple of the mesh size,
    each genome's windows in position order; padding rows carry the
    sentinel key.  Shard d starts from rows [d*T, (d+1)*T), T = len /
    mesh size, and sends up to T rows to each shard.  Returns (content,
    gid, pos, strand), each a list of one tensor a shard on its device
    (int64, int32, int32, int32; n_dev * T rows, those with the sentinel
    content padding with gid 0, pos 0, strand 1), sorted by (content,
    gid, pos); across processes every shard's, on this process's
    device."""
    tables, seg_off, _, sentinel = _route_table(keys, gid, pos, mesh,
                                                weight)
    out = ([], [], [], [])
    for (content, src, rk), dev in zip(tables, mesh.local_devices()):
        so = seg_off.to(dev)
        g = (torch.searchsorted(so, src, right=True) - 1).clamp(min=0)
        pad = rk == sentinel
        out[0].append(content)
        out[1].append(torch.where(pad, 0, g).to(torch.int32))
        out[2].append(torch.where(pad, 0, src - so[g]).to(torch.int32))
        out[3].append((rk & 1).to(torch.int32))
    return tuple(_all_shards(mesh, x) for x in out)


def sharded_mum_seed_count(keys, gid, pos, mesh: Mesh, weight: int,
                           repeat_tolerance: int = 0,
                           repeat_limit: int = MER_REPEAT_LIMIT) -> int:
    """Surviving unique-MUM seed runs across the mesh: each shard's run
    census (K13 on its routed table) summed on the host, runs being local
    to their owner shard.  Arguments as sharded_seed_table."""
    tables, seg_off, _, _ = _route_table(keys, gid, pos, mesh, weight)
    total = 0
    for (content, src, rk), dev in zip(tables, mesh.local_devices()):
        with cuda.on(dev):
            total += ops_mums.mum_seed_flags(
                content, src, rk, seg_off.to(dev), repeat_tolerance,
                repeat_limit, _sentinels(weight)[1], row_keys=True).n_rows
    return _sum_all(mesh, [total])[0]


def shard_loads(keys, gid, pos, mesh: Mesh, weight: int) -> np.ndarray:
    """Rows each shard receives after prefix routing (the load-balance
    diagnostic of the Fibonacci-mixed buckets): int64[n_dev] non-sentinel
    rows a shard.  Arguments as sharded_seed_table."""
    tables, _, _, sentinel = _route_table(keys, gid, pos, mesh, weight)
    loads = [0] * mesh.size
    for d, (_, _, rk) in zip(mesh.local, tables):
        loads[d] = int((rk != sentinel).sum())
    return np.array(_sum_all(mesh, loads), dtype=np.int64)


def _retry(once, capacity: int, route_cap: int, max_retries: int,
           name: str):
    """Run once(capacity, route_cap) until nothing overflows, doubling
    route_cap after dropped rows and capacity after a candidate
    overflow; raise after max_retries retries."""
    last = None
    for _ in range(max_retries + 1):
        ma, dropped, cand_over = once(capacity, route_cap)
        if dropped == 0 and cand_over == 0:
            return ma
        if dropped:
            route_cap *= 2
        if cand_over:
            capacity *= 2
        last = (dropped, cand_over)
    raise ValueError(
        f"{name} still overflowing after {max_retries} retries "
        f"(dropped={last[0]}, cand_over={last[1]}, capacity={capacity}, "
        f"route_cap={route_cap})")


class _Layout:
    """The SMLs' position-order table, replicated on the devices of this
    process's shards, and their slices of the JAX package's bucket-padded
    layout."""

    def __init__(self, smls, mesh: Mesh):
        self.G = len(smls)
        self.seed = smls[0].seed
        self.seed_len = smls[0].seed_length
        self.total = _bucketed_total(smls, mesh.size)
        keys = torch.cat([s.keys for s in smls])
        seg_off = torch.from_numpy(np.concatenate(
            [[0], np.cumsum([s.n_windows for s in smls])]).astype(np.int64))
        self.keys = _replicas(keys, mesh)
        self.seg_off = {d: seg_off.to(d) for d in self.keys}
        self.slices = _table_slices(keys, mesh, self.total // mesh.size)

    def gen_rows(self, dev, rows: int):
        """Per-row genome offsets and window counts int32[rows, G]."""
        so = self.seg_off[dev]
        off = so[:-1].to(torch.int32)
        cnt = (so[1:] - so[:-1]).to(torch.int32)
        return (off[None].expand(rows, self.G).contiguous(),
                cnt[None].expand(rows, self.G).contiguous())


def sharded_find_mums(smls, mesh: Mesh, capacity: int | None = None,
                      chunk: int | None = None,
                      repeat_limit: int = MER_REPEAT_LIMIT,
                      route_cap: int | None = None,
                      max_retries: int = 3,
                      repeat_tolerance: int = 0) -> MatchArray:
    """Seed-prefix-sharded multi-MUM discovery: the windows routed to
    their content owners (K26, per-destination send capacity route_cap),
    each shard's unique-MUM seed runs enumerated (K13) into at most
    `capacity` candidate rows (K27), extended (K2) and deduplicated
    shard-locally (K28); the host gathers the unique rows, and cross-shard
    duplicates (seeds of one maximal match owned by different shards)
    collapse in the final dedup.  Overflow of either capacity retries
    with it doubled, up to max_retries times.  Returns a MatchArray with
    find_mums semantics (unique MUMs at repeat_tolerance)."""
    lay = _Layout(smls, mesh)
    capacity, route_cap = _default_caps(lay.total, mesh.size, capacity,
                                        route_cap)
    if chunk is None:
        chunk = max(lay.seed_len, 128)

    def once(capacity, route_cap):
        return _sharded_find_mums_once(lay, mesh, capacity, chunk,
                                       repeat_limit, route_cap,
                                       repeat_tolerance)

    return _retry(once, capacity, route_cap, max_retries,
                  "sharded_find_mums")


def _sharded_find_mums_once(lay: _Layout, mesh: Mesh, capacity: int,
                            chunk: int, repeat_limit: int, route_cap: int,
                            repeat_tolerance: int = 0):
    G, seed, seed_len = lay.G, lay.seed, lay.seed_len
    tables, dropped = _route(mesh, lay.slices, key_sentinel(seed), route_cap)
    flags = []
    for (content, src, _), dev in zip(tables, mesh.local_devices()):
        with cuda.on(dev):
            flags.append(ops_mums.mum_seed_flags(
                content, src, lay.keys[dev], lay.seg_off[dev],
                repeat_tolerance, repeat_limit, sentinel_content(seed)))
    del tables
    dropped, cand_over = _sum_all(mesh, [
        dropped, sum(max(f.n_rows - capacity, 0) for f in flags)])
    if dropped or cand_over:
        return None, dropped, cand_over
    starts, lengths = [], []
    for f, dev in zip(flags, mesh.local_devices()):
        with cuda.on(dev):
            rows = ops_shard.shard_candidates(f, G, capacity, seed_len)
            R = rows.lengths.shape[0]
            if R == 0:
                continue
            lefts, lens = extend_matches(
                lay.keys[dev], seed_len, chunk, *lay.gen_rows(dev, R),
                rows.lefts, rows.present, rows.is_fwd, rows.lengths,
                key_sentinel(seed))
            d = ops_shard.dedup_flags(lefts, rows.present, rows.is_fwd,
                                      lens, torch.ones(R, dtype=torch.bool,
                                                       device=dev))
        starts.append(d.starts[d.uniq].cpu().numpy().astype(np.int64))
        lengths.append(d.lengths[d.uniq].cpu().numpy().astype(np.int64))
    ma = MatchArray(*_gather_rows(mesh, starts, lengths, G))
    return ma.dedup().canonical_sort(), 0, 0


def sharded_pairwise_fits(G: int, pos_bits: int, rid_bits: int) -> bool:
    """The JAX package's word budget of its sharded pairwise seeder
    (libmems_tpu/matchfind.py:1245 pairwise_fused_fits, applied at
    parallel/shard.py:489-495): the kept-row word rid | gid(6) | pos |
    strand within 63 bits and the cluster word fwd | pair_id | delta |
    posA within 64, G <= 63.  The port's kernels derive gid and pos per
    row and need only the cluster word (matchfind.pairwise_fused_fits),
    but the sharded seeder refuses what the JAX package refuses."""
    pair_bits = 2 * max(G - 1, 1).bit_length()
    return (rid_bits + 6 + pos_bits + 1 <= 63
            and 1 + pair_bits + 2 * pos_bits + 2 <= 64
            and G <= 63)


def sharded_find_pairwise_mums(smls, mesh: Mesh, capacity: int | None = None,
                               chunk: int | None = None,
                               repeat_limit: int = MER_REPEAT_LIMIT,
                               route_cap: int | None = None,
                               max_retries: int = 3) -> MatchArray:
    """Seed-prefix-sharded PairwiseMatchFinder (the progressiveMauve
    seeder, libMems/PairwiseMatchFinder.cpp:37-71): routing as in
    sharded_find_mums (K26), then on each shard the single-device
    seeder's stages on its table: per-genome-unique occurrence flags
    (K5), cluster words of every genome pair of a run (K6), their sort,
    at most `capacity` diagonal-cluster representatives (K7) and their
    extension (K2).  Overflow retries with the capacity doubled.  Returns
    a MatchArray with find_pairwise_mums semantics."""
    G = len(smls)
    if G > 62:
        raise ValueError("sharded pairwise seeder supports <= 62 genomes")
    # word budget of the JAX package's local pair tables (worst case:
    # every routed row lands on one shard)
    total = _bucketed_total(smls, mesh.size)
    pos_bits = max(max(s.n_windows for s in smls).bit_length(), 8)
    rid_bits = (total + 1).bit_length()
    if not sharded_pairwise_fits(G, pos_bits, rid_bits):
        raise ValueError(
            f"packed pair words exceed 64 bits (G={G}, pos_bits="
            f"{pos_bits}, rid_bits={rid_bits}); genomes too large for "
            "the sharded pairwise seeder's packed layout")
    lay = _Layout(smls, mesh)
    capacity, route_cap = _default_caps(lay.total, mesh.size, capacity,
                                        route_cap)
    if chunk is None:
        chunk = max(lay.seed_len, 256)

    def once(capacity, route_cap):
        return _sharded_pairwise_once(lay, mesh, capacity, chunk,
                                      repeat_limit, route_cap, pos_bits)

    return _retry(once, capacity, route_cap, max_retries,
                  "sharded_find_pairwise_mums")


def _sharded_pairwise_once(lay: _Layout, mesh: Mesh, capacity: int,
                           chunk: int, repeat_limit: int, route_cap: int,
                           pos_bits: int):
    G, seed, seed_len = lay.G, lay.seed, lay.seed_len
    tables, dropped = _route(mesh, lay.slices, key_sentinel(seed), route_cap)
    reps = []
    for (content, src, _), dev in zip(tables, mesh.local_devices()):
        with cuda.on(dev):
            flags = ops_pairwise.run_flags(content, src, lay.keys[dev],
                                           lay.seg_off[dev], repeat_limit,
                                           sentinel_content(seed))
            cw = usort(ops_pairwise.cluster_words(flags, G, pos_bits))
            del flags
            so = lay.seg_off[dev]
            reps.append(ops_pairwise.cluster_reps(
                cw, capacity, G, pos_bits, seed_len,
                so[:-1].to(torch.int32), (so[1:] - so[:-1]).to(torch.int32)))
    del tables
    dropped, cand_over = _sum_all(mesh, [
        dropped, sum(max(r.n_reps - capacity, 0) for r in reps)])
    if dropped or cand_over:
        return None, dropped, cand_over
    parts = []
    for r, dev in zip(reps, mesh.local_devices()):
        if r.n_reps:
            with cuda.on(dev):
                parts.append(pairwise_rows(lay.keys[dev], seed_len, chunk,
                                           r, G, seed))
    ma = MatchArray(*_gather_rows(mesh, [p.starts for p in parts],
                                  [p.lengths for p in parts], G))
    return ma.dedup().canonical_sort(), 0, 0


# ---------------------------------------------------------------------------
# the position-tiled extension: no shard holds the whole key table
# ---------------------------------------------------------------------------

FETCH_BYTES = 1 << 30   # bound on the responses of one fetch a shard


def _tile_geometry(n_keys: int, n_dev: int, max_chunk: int):
    """(S, big, halo) of the padded, tiled table: big sentinel keys
    before the table, tiles of S keys (a multiple of 128) each with a
    halo of max_chunk + 128 (libmems_tpu/parallel/shard.py:591)."""
    big = max_chunk
    halo = max_chunk + 128
    S = -(-(big + n_keys + halo) // n_dev)
    S += (-S) % 128
    return S, big, halo


def build_position_tiles(keys_concat: np.ndarray, n_dev: int,
                         max_chunk: int):
    """The padded, tiled key table (host): the padded global space is
    [sentinel * max_chunk | keys | sentinel tail] with tile_size S a
    multiple of 128; device d's slice is padded[d*S : (d+1)*S + halo]
    (halo = max_chunk + 128, so any span starting inside a tile is local
    to its owner).  Returns (tiles [n_dev, S + halo], S, big_offset), the
    JAX package's values for any key dtype (the sentinel is its
    all-ones)."""
    keys_concat = np.asarray(keys_concat)
    S, big, halo = _tile_geometry(len(keys_concat), n_dev, max_chunk)
    sentinel = ~keys_concat.dtype.type(0)
    padded = np.full(n_dev * S + halo, sentinel, keys_concat.dtype)
    padded[big:big + len(keys_concat)] = keys_concat
    tiles = np.stack([padded[d * S: d * S + S + halo]
                      for d in range(n_dev)])
    return tiles, S, big


def _table_range(keys: list[torch.Tensor], lo: int, hi: int, sentinel: int,
                 device) -> torch.Tensor:
    """Rows [lo, hi) of the concatenation of the genomes' key tensors,
    the sentinel outside it, built on `device` from the pieces (the
    concatenation itself is never formed)."""
    pieces, base = [], 0
    if lo < 0:
        pieces.append(torch.full((min(hi, 0) - lo,), sentinel,
                                 dtype=torch.int64, device=device))
    for k in keys:
        a, b = max(lo, base), min(hi, base + k.shape[0])
        if a < b:
            pieces.append(k[a - base:b - base].to(device))
        base += k.shape[0]
    if hi > max(lo, base):
        pieces.append(torch.full((hi - max(lo, base),), sentinel,
                                 dtype=torch.int64, device=device))
    if not pieces:
        return torch.empty(0, dtype=torch.int64, device=device)
    return torch.cat(pieces)


class _Tiles:
    """This process's shards' position tiles and routing slices of the
    SMLs' table (padded to a multiple of the mesh size only), with the
    genome bounds: the state of the tiled path, in which no shard holds
    more than S + halo keys of the table."""

    def __init__(self, smls, mesh: Mesh, chunk: int):
        n_dev = mesh.size
        self.G = len(smls)
        self.seed = smls[0].seed
        self.seed_len = smls[0].seed_length
        self.C = chunk
        self.sentinel = key_sentinel(self.seed)
        keys = [s.keys for s in smls]
        counts = [s.n_windows for s in smls]
        n_keys = sum(counts)
        self.S, self.big, self.halo = _tile_geometry(n_keys, n_dev, chunk)
        T = (n_keys + (-n_keys) % n_dev) // n_dev
        devs = mesh.local_devices()
        self.tiles = [_table_range(keys, d * self.S - self.big,
                                   d * self.S + self.S + self.halo - self.big,
                                   self.sentinel, dev)
                      for d, dev in zip(mesh.local, devs)]
        # the routing slices, without the sentinel rows that pad the table
        self.slices = [(_table_range(keys, min(d * T, n_keys),
                                     min((d + 1) * T, n_keys),
                                     self.sentinel, dev), min(d * T, n_keys))
                       for d, dev in zip(mesh.local, devs)]
        seg_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.seg_off = {d: torch.from_numpy(seg_off).to(d)
                        for d in dict.fromkeys(devs)}
        self.gen_off = {d: so[:-1].to(torch.int32)
                        for d, so in self.seg_off.items()}
        self.gen_cnt = {d: (so[1:] - so[:-1]).to(torch.int32)
                        for d, so in self.seg_off.items()}


def sharded_find_mums_tiled(smls, mesh: Mesh, capacity: int | None = None,
                            chunk: int | None = None,
                            repeat_limit: int = MER_REPEAT_LIMIT,
                            route_cap: int | None = None,
                            req_cap: int | None = None,
                            max_retries: int = 4) -> MatchArray:
    """sharded_find_mums with the position-tiled extension: no shard
    holds the whole key table.  Enumeration reads the content-routed rows
    (K26, then K13 and K27 at repeat tolerance 0 on each shard's routed
    table, whose rows carry their own keys); extension reads spans of
    position tiles (S keys and a halo a shard) from their owners, one
    probe round at a time on each side until no row anywhere is active:
    requests (K29), their exchange, the owners' answers (K30) and the
    round on the spans (K31), the active rows cut into blocks whose
    responses stay within FETCH_BYTES a shard.  Then K28 dedups each
    shard's rows and every process gathers them.

    Defaults as the JAX package (libmems_tpu/parallel/shard.py:614):
    capacity and route_cap from the table padded to a multiple of the
    mesh size, req_cap = max(128, 4 * ceil(capacity / n_dev)) requests a
    shard may send one owner in one fetch, probe width chunk = max(seed
    length, 512), not escalated.  Dropped route rows double route_cap, a
    candidate overflow capacity, requests past req_cap req_cap, and the
    run repeats, up to max_retries times.  Only the active rows' present
    genomes ask for spans here, where the JAX fetch asks for every row
    and genome, so the two may retry a different number of times; their
    matches are the same (a dropped request reads sentinel keys, a short
    match that the retry replaces)."""
    n_dev = mesh.size
    total0 = sum(s.n_windows for s in smls)
    total = total0 + ((-total0) % n_dev)
    capacity, route_cap = _default_caps(total, n_dev, capacity, route_cap)
    if req_cap is None:
        req_cap = max(128, 4 * (-(-capacity // n_dev)))
    if chunk is None:
        chunk = max(smls[0].seed_length, 512)
    tiles = _Tiles(smls, mesh, chunk)
    last = None
    for _ in range(max_retries + 1):
        ma, dropped, cand_over, fetch_drop = _sharded_tiled_once(
            tiles, mesh, capacity, repeat_limit, route_cap, req_cap)
        if dropped == 0 and cand_over == 0 and fetch_drop == 0:
            return ma
        if dropped:
            route_cap *= 2
        if cand_over:
            capacity *= 2
        if fetch_drop:
            req_cap *= 2
        last = (dropped, cand_over, fetch_drop)
    raise ValueError(
        f"sharded_find_mums_tiled still overflowing after {max_retries} "
        f"retries {last}; capacity={capacity}, route_cap={route_cap}, "
        f"req_cap={req_cap}")


# the last tiled run's probe rounds and fetches (blocks), for diagnostics
TILED_STATS = {"rounds": 0, "fetches": 0}


def _sharded_tiled_once(tiles: _Tiles, mesh: Mesh, capacity: int,
                        repeat_limit: int, route_cap: int, req_cap: int):
    G, seed, seed_len = tiles.G, tiles.seed, tiles.seed_len
    devs = mesh.local_devices()
    tables, dropped = _route(mesh, tiles.slices, tiles.sentinel, route_cap)
    flags = []
    for (content, src, rk), dev in zip(tables, devs):
        with cuda.on(dev):
            flags.append(ops_mums.mum_seed_flags(
                content, src, rk, tiles.seg_off[dev], 0, repeat_limit,
                sentinel_content(seed), row_keys=True))
    del tables
    dropped, cand_over = _sum_all(mesh, [
        dropped, sum(max(f.n_rows - capacity, 0) for f in flags)])
    if dropped or cand_over:
        return None, dropped, cand_over, 0
    rows = []
    for f, dev in zip(flags, devs):
        with cuda.on(dev):
            rows.append(ops_shard.shard_candidates(f, G, capacity, seed_len))
    del flags
    C = tiles.C
    block = max(1, FETCH_BYTES // (G * C * 8))
    lefts = [r.lefts for r in rows]       # extended in place
    lengths = [r.lengths for r in rows]
    fetch_drop = 0
    TILED_STATS.update(rounds=0, fetches=0)
    for side in (0, 1):
        active = [r.present.any(dim=1) for r in rows]
        while True:
            idx = [torch.nonzero(a).flatten() for a in active]
            nb = _max_all(mesh, max(-(-i.shape[0] // block) for i in idx))
            for b in range(nb):
                blk = [i[b * block:(b + 1) * block] for i in idx]
                fetch_drop += _probe_block(tiles, mesh, rows, lefts, lengths,
                                           active, blk, side, req_cap)
            TILED_STATS["rounds"] += 1
            TILED_STATS["fetches"] += nb
            n_active = _sum_all(mesh, [sum(int(a.sum()) for a in active)])[0]
            if n_active == 0:
                break
    fetch_drop = _sum_all(mesh, [fetch_drop])[0]
    if fetch_drop:
        return None, 0, 0, fetch_drop
    starts, lens = [], []
    for r, l, n, dev in zip(rows, lefts, lengths, devs):
        with cuda.on(dev):
            d = ops_shard.dedup_flags(l, r.present, r.is_fwd, n,
                                      torch.ones(n.shape[0], dtype=torch.bool,
                                                 device=dev))
        starts.append(d.starts[d.uniq].cpu().numpy().astype(np.int64))
        lens.append(d.lengths[d.uniq].cpu().numpy().astype(np.int64))
    ma = MatchArray(*_gather_rows(mesh, starts, lens, G))
    return ma.dedup().canonical_sort(), 0, 0, 0


def _probe_block(tiles: _Tiles, mesh: Mesh, rows, lefts, lengths, active,
                 blk, side: int, req_cap: int) -> int:
    """One fetch and probe round of a block of each local shard's active
    rows (blk: their indices): requests (K29, every local shard's first),
    one read of their tallies to the host (a copy a card), the exchange of
    the counts and the tile-local starts, the owners' spans (K30), their
    return, and the round on them (K31), which updates lefts, lengths and
    active in place.  Returns this process's requests past req_cap."""
    n_dev, C, seed_len = mesh.size, tiles.C, tiles.seed_len
    devs = mesh.local_devices()
    # the local shards' tallies, a row each, one buffer a card
    on_card = {d: [i for i, x in enumerate(devs) if x == d]
               for d in dict.fromkeys(devs)}
    buf = {d: ops_tiled.tally_rows(len(ix), n_dev, d)
           for d, ix in on_card.items()}
    reqs = []
    for i, dev in enumerate(devs):
        with cuda.on(dev):
            reqs.append(ops_tiled.tiled_requests(
                blk[i], lefts[i], lengths[i], rows[i].present,
                rows[i].is_fwd, tiles.gen_off[dev], side, C, seed_len,
                tiles.big, tiles.S, n_dev, req_cap,
                tally=buf[dev][on_card[dev].index(i)]))
    tally = [None] * len(devs)
    for d, ix in on_card.items():
        for i, t in zip(ix, buf[d].cpu().tolist()):
            tally[i] = ops_tiled.tally_counts(t, n_dev)
    recv = _exchange([[q.send[o, :n] for o, n in enumerate(t[0])]
                      for q, t in zip(reqs, tally)], mesh)
    answers = []
    for tile, got, dev in zip(tiles.tiles, recv, devs):
        with cuda.on(dev):
            spans = ops_tiled.tiled_serve(tile, tiles.S, torch.cat(got), C,
                                          tiles.sentinel)
        answers.append(list(torch.split(spans, [g.shape[0] for g in got])))
    back = _exchange(answers, mesh)
    for i, dev in enumerate(devs):
        with cuda.on(dev):
            ops_tiled.tiled_probe(
                torch.cat(back[i]), reqs[i].where, blk[i], lefts[i],
                lengths[i], rows[i].present, rows[i].is_fwd,
                tiles.gen_cnt[dev], active[i], side, C, seed_len,
                tiles.sentinel, reqs[i].offsets)
    return sum(t[1] for t in tally)
