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

A ``Mesh`` is an ordered list of devices, and a device may repeat in it:
four shards on one card run the same route, exchange (then local copies)
and retries as four cards.  This module runs every shard from one
process; the multi-process exchange (NCCL) and the position-tiled
extension of the JAX package (``sharded_find_mums_tiled``) are not
ported yet.
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
from libmems_tpu_torch.ops.extend import extend_matches
from libmems_tpu_torch.ops.mers import key_sentinel, sentinel_content
from libmems_tpu_torch.ops.pairwise import shr, usort

SHARD_AXIS = "shard"    # the JAX package's mesh axis name, kept for parity


class Mesh:
    """An ordered list of devices, one shard each (a device may repeat)."""

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = cuda.resolve_device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


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
    """send[s]: shard s's [n_dev, C, ...] buffers on its device.  Shard d
    receives cat over s of send[s][d], in source order (the layout of
    jax.lax.all_to_all(x, axis, 0, 0, tiled=False) flattened), by peer
    copies between cards or a local copy where two shards share one."""
    n = mesh.size
    return [torch.cat([send[s][d].to(mesh.devices[d], non_blocking=True)
                       for s in range(n)]) for d in range(n)]


def _replicas(t: torch.Tensor, mesh: Mesh) -> dict:
    """t on every distinct device of the mesh (one copy a device)."""
    return {d: t.to(d) for d in dict.fromkeys(mesh.devices)}


def _route(mesh: Mesh, slices, sentinel: int, cap: int):
    """Route each shard's slice (keys int64 on its device, the index of
    its first row in the table) to the content owners (K26), exchange,
    and sort each shard's received rows by content, stably: rows arrive
    in ascending source index, so that is the (content, gid, pos) order.
    Returns ([(content, src, key) per shard], rows dropped past cap)."""
    n_dev = mesh.size
    sends = []
    for (k, base), dev in zip(slices, mesh.devices):
        with cuda.on(dev):
            sends.append(ops_shard.route_fill(k, base, sentinel, n_dev, cap))
    recv_k = _all_to_all([s.keys for s in sends], mesh)
    recv_src = _all_to_all([s.src for s in sends], mesh)
    dropped = sum(int(s.dropped) for s in sends)
    tables = []
    for rk, rs, dev in zip(recv_k, recv_src, mesh.devices):
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
    """Shard d's rows [d*T, (d+1)*T) of the table (clipped to its end) on
    its device, with the index of the first."""
    n = keys.shape[0]
    return [(keys[min(d * T, n):min((d + 1) * T, n)].to(dev), min(d * T, n))
            for d, dev in enumerate(mesh.devices)]


def _route_table(keys, gid, pos, mesh: Mesh, weight: int):
    """Route a global window table (the arguments of sharded_seed_table)
    with T = len / mesh size rows a slice and T slots a destination.
    Returns (the shards' (content, src, key) tables, the genome bounds
    int64[G+1], the keys int64, the masked-window key)."""
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
    gid, pos)."""
    tables, seg_off, _, sentinel = _route_table(keys, gid, pos, mesh,
                                                weight)
    out = ([], [], [], [])
    for (content, src, rk), dev in zip(tables, mesh.devices):
        so = seg_off.to(dev)
        g = (torch.searchsorted(so, src, right=True) - 1).clamp(min=0)
        pad = rk == sentinel
        out[0].append(content)
        out[1].append(torch.where(pad, 0, g).to(torch.int32))
        out[2].append(torch.where(pad, 0, src - so[g]).to(torch.int32))
        out[3].append((rk & 1).to(torch.int32))
    return out


def sharded_mum_seed_count(keys, gid, pos, mesh: Mesh, weight: int,
                           repeat_tolerance: int = 0,
                           repeat_limit: int = MER_REPEAT_LIMIT) -> int:
    """Surviving unique-MUM seed runs across the mesh: each shard's run
    census (K13 on its routed table) summed on the host, runs being local
    to their owner shard.  Arguments as sharded_seed_table."""
    tables, seg_off, keys, _ = _route_table(keys, gid, pos, mesh, weight)
    reps = _replicas(keys, mesh)
    total = 0
    for (content, src, _), dev in zip(tables, mesh.devices):
        with cuda.on(dev):
            total += ops_mums.mum_seed_flags(
                content, src, reps[dev], seg_off.to(dev), repeat_tolerance,
                repeat_limit, _sentinels(weight)[1]).n_rows
    return total


def shard_loads(keys, gid, pos, mesh: Mesh, weight: int) -> np.ndarray:
    """Rows each shard receives after prefix routing (the load-balance
    diagnostic of the Fibonacci-mixed buckets): int64[n_dev] non-sentinel
    rows a shard.  Arguments as sharded_seed_table."""
    tables, _, _, sentinel = _route_table(keys, gid, pos, mesh, weight)
    return np.array([int((rk != sentinel).sum()) for _, _, rk in tables],
                    dtype=np.int64)


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
    """The SMLs' position-order table, replicated on the mesh's devices,
    and the shard slices of the JAX package's bucket-padded layout."""

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
    for (content, src, _), dev in zip(tables, mesh.devices):
        with cuda.on(dev):
            flags.append(ops_mums.mum_seed_flags(
                content, src, lay.keys[dev], lay.seg_off[dev],
                repeat_tolerance, repeat_limit, sentinel_content(seed)))
    del tables
    cand_over = sum(max(f.n_rows - capacity, 0) for f in flags)
    if dropped or cand_over:
        return None, dropped, cand_over
    starts, lengths = [], []
    for f, dev in zip(flags, mesh.devices):
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
    if not starts:
        return MatchArray.empty(G), 0, 0
    ma = MatchArray(np.concatenate(starts), np.concatenate(lengths))
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
    for (content, src, _), dev in zip(tables, mesh.devices):
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
    cand_over = sum(max(r.n_reps - capacity, 0) for r in reps)
    if dropped or cand_over:
        return None, dropped, cand_over
    parts = []
    for r, dev in zip(reps, mesh.devices):
        if r.n_reps:
            with cuda.on(dev):
                parts.append(pairwise_rows(lay.keys[dev], seed_len, chunk,
                                           r, G, seed))
    if not parts:
        return MatchArray.empty(G), 0, 0
    return MatchArray.concat(parts).dedup().canonical_sort(), 0, 0
