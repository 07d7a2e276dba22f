"""The seed-prefix-sharded seeder's table passes (kernels K26-K28,
csrc/shard.cu).

Port of the device stages of libmems_tpu/parallel/shard.py:

* ``route_fill`` (K26): ``_route_local``'s bucketing (``_bucket_of``, a
  Fibonacci mix of the seed content, the masked-window sentinel to the
  drop bucket n_dev) and its [n_dev, C] send buffers of key and source
  row, with the count of rows past C;
* ``shard_candidates`` (K27): ``_sharded_find_mums_once``'s scatter of a
  shard's kept seed occurrences into candidate rows, as K2's extension
  rows;
* ``dedup_flags`` (K28): its shard-local dedup, the signed starts after
  extension, a lexsort, and the first-of-run flags.

Each wrapper takes its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors; a count of launches sits on each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch.ops.pairwise import shr

_MIX = 0x9E3779B97F4A7C15   # Fibonacci hashing constant (2^64 / phi)


def bucket_bits(n_dev: int) -> int:
    return max((n_dev - 1).bit_length(), 1)


def _mix_top32(content: torch.Tensor) -> torch.Tensor:
    """Top 32 bits of content * _MIX mod 2^64 for int64 contents below
    2^63, in int64 arithmetic that never overflows (16- and 32-bit
    partial products)."""
    m_lo, m_hi = _MIX & 0xFFFFFFFF, _MIX >> 32
    c_lo = content & 0xFFFFFFFF
    c_hi = shr(content, 32)
    # high 32 bits of c_lo * m_lo, with c_lo split at bit 16
    a1, a0 = c_lo >> 16, c_lo & 0xFFFF
    carry = (a1 * m_lo + ((a0 * m_lo) >> 16)) >> 16
    # c_lo * m_hi mod 2^32, with m_hi split at bit 16
    cross = ((((c_lo * (m_hi >> 16)) & 0xFFFF) << 16)
             + c_lo * (m_hi & 0xFFFF)) & 0xFFFFFFFF
    return (carry + ((c_hi * m_lo) & 0xFFFFFFFF) + cross) & 0xFFFFFFFF


def bucket_of(content: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Owner shard int32 of each seed content (_bucket_of): the top
    bucket_bits(n_dev) bits of the mixed content, clamped to n_dev - 1
    (so at n_dev = 3 shard 2 owns half the content space, as in the JAX
    package)."""
    b = _mix_top32(content) >> (32 - bucket_bits(n_dev))
    return torch.clamp(b, max=n_dev - 1).to(torch.int32)


class Routed(NamedTuple):
    keys: torch.Tensor      # int64[n_dev, C], the sentinel in unused slots
    src: torch.Tensor       # int64[n_dev, C], 0 in unused slots
    dropped: torch.Tensor   # int64[] rows past C (0-d, on the keys' device)


def route_fill_plain(keys, base: int, sentinel: int, n_dev: int,
                     cap: int) -> Routed:
    """Plain PyTorch version of K26."""
    dev = keys.device
    n = keys.shape[0]
    bucket = bucket_of(shr(keys, 1), n_dev)
    bucket = torch.where(keys == sentinel, n_dev, bucket).to(torch.int32)
    sb, perm = torch.sort(bucket, stable=True)
    counts = torch.bincount(bucket.to(torch.int64), minlength=n_dev + 1)
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=dev) - start[sb.to(torch.int64)]
    sent = sb < n_dev
    ok = sent & (slot < cap)
    dst = sb[ok].to(torch.int64) * cap + slot[ok]
    send_k = torch.full((n_dev * cap,), sentinel, dtype=torch.int64,
                        device=dev)
    send_src = torch.zeros(n_dev * cap, dtype=torch.int64, device=dev)
    send_k[dst] = keys[perm[ok]]
    send_src[dst] = base + perm[ok]
    dropped = (sent & (slot >= cap)).sum()
    return Routed(send_k.view(n_dev, cap), send_src.view(n_dev, cap),
                  dropped)


@cuda.launcher
def route_fill(keys, base: int, sentinel: int, n_dev: int,
               cap: int) -> Routed:
    """Send buffers of one shard's rows (_route_local before the
    all_to_all).

    keys: int64[n], the shard's slice of the position-order key table,
    whose first row is row `base` of the table; sentinel: the masked-
    window key.  Row i goes to shard bucket_of(key >> 1) at the next free
    slot of that destination (rows keep their order), carrying its key
    and src = base + i; masked windows and rows past `cap` are not sent,
    the latter counted.  CPU tensors take the plain version; CUDA tensors
    launch K26 (two passes around a stable torch.sort by bucket), except
    for an empty slice, whose buffers stay empty and which launches
    nothing."""
    if keys.device.type == "cpu":
        return route_fill_plain(keys, base, sentinel, n_dev, cap)
    dev = keys.device
    n = keys.shape[0]
    cuda.require(keys, "keys", torch.int64, dev, (n,))
    send_k = torch.full((n_dev, cap), sentinel, dtype=torch.int64,
                        device=dev)
    send_src = torch.zeros((n_dev, cap), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    if n == 0:
        return Routed(send_k, send_src, dropped)
    bucket = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(n_dev + 1, dtype=torch.int64, device=dev)
    lib = cuda.library()
    stream = cuda.stream(keys)
    cuda.check(lib.lm_route_buckets(
        keys.data_ptr(), n, sentinel, bucket_bits(n_dev), n_dev,
        bucket.data_ptr(), counts.data_ptr(), stream), "lm_route_buckets")
    sb, perm = torch.sort(bucket, stable=True)
    start = torch.cumsum(counts, 0) - counts
    cuda.check(lib.lm_route_fill(
        keys.data_ptr(), sb.data_ptr(), perm.data_ptr(), start.data_ptr(), n,
        base, n_dev, cap, send_k.data_ptr(), send_src.data_ptr(),
        dropped.data_ptr(), stream), "lm_route_fill")
    route_fill.launches += 1
    return Routed(send_k, send_src, dropped)


route_fill.launches = 0


class ShardRows(NamedTuple):
    lefts: torch.Tensor     # int32[R, G]
    present: torch.Tensor   # bool[R, G]
    is_fwd: torch.Tensor    # bool[R, G]
    lengths: torch.Tensor   # int32[R], seed_len
    over: int               # rows past capacity: max(n_rows - capacity, 0)


def _shard_rows_args(flags, capacity: int):
    R = min(flags.n_rows, capacity)
    return R, max(flags.n_rows - capacity, 0)


def shard_candidates_plain(flags, G: int, capacity: int,
                           seed_len: int) -> ShardRows:
    """Plain PyTorch version of K27."""
    dev = flags.kept_occ.device
    R, over = _shard_rows_args(flags, capacity)
    keep = flags.kept_occ
    starts = torch.zeros((R + 1, G), dtype=torch.int32, device=dev)
    rid = torch.clamp(flags.row_id[keep].to(torch.int64), max=R)
    sign = torch.where(flags.strand[keep] == flags.ref_strand[keep], 1, -1)
    starts[rid, flags.gid[keep].to(torch.int64)] = \
        (sign * (flags.pos[keep] + 1)).to(torch.int32)
    starts = starts[:R]
    present = starts != 0
    lefts = torch.where(present, starts.abs() - 1, 0).to(torch.int32)
    return ShardRows(lefts, present, starts > 0,
                     torch.full((R,), seed_len, dtype=torch.int32,
                                device=dev), over)


@cuda.launcher
def shard_candidates(flags, G: int, capacity: int,
                     seed_len: int) -> ShardRows:
    """A shard's candidate rows from K13's flags of its routed table: row
    r of the first R = min(n_rows, capacity) holds sign * (pos + 1) of
    each genome's kept occurrence of the r-th surviving seed run (sign
    relative to the run's first row), as K2's extension rows of length
    seed_len; rows past capacity go to a dump row and are counted in
    `over` for the retry.  CPU tensors take the plain version; CUDA
    tensors launch K27, except for an empty table (no rows, nothing
    launched)."""
    keep = flags.kept_occ
    if keep.device.type == "cpu":
        return shard_candidates_plain(flags, G, capacity, seed_len)
    dev = keep.device
    n = keep.shape[0]
    for name, t, dt in (("kept_occ", keep, torch.bool),
                        ("row_id", flags.row_id, torch.int32),
                        ("ref_strand", flags.ref_strand, torch.uint8),
                        ("gid", flags.gid, torch.int32),
                        ("pos", flags.pos, torch.int32),
                        ("strand", flags.strand, torch.uint8)):
        cuda.require(t, name, dt, dev, (n,))
    R, over = _shard_rows_args(flags, capacity)
    lefts = torch.empty((R, G), dtype=torch.int32, device=dev)
    present = torch.empty((R, G), dtype=torch.bool, device=dev)
    is_fwd = torch.empty((R, G), dtype=torch.bool, device=dev)
    lengths = torch.full((R,), seed_len, dtype=torch.int32, device=dev)
    if n == 0:
        return ShardRows(lefts, present, is_fwd, lengths, over)
    starts = torch.zeros((R + 1, G), dtype=torch.int32, device=dev)
    cuda.check(cuda.library().lm_shard_candidates(
        keep.data_ptr(), flags.row_id.data_ptr(), flags.gid.data_ptr(),
        flags.pos.data_ptr(), flags.strand.data_ptr(),
        flags.ref_strand.data_ptr(), n, R, G, starts.data_ptr(),
        lefts.data_ptr(), present.data_ptr(), is_fwd.data_ptr(),
        cuda.stream(keep)), "lm_shard_candidates")
    shard_candidates.launches += 1
    return ShardRows(lefts, present, is_fwd, lengths, over)


shard_candidates.launches = 0


class Deduped(NamedTuple):
    starts: torch.Tensor    # int32[m, G] in sorted order
    lengths: torch.Tensor   # int32[m]
    uniq: torch.Tensor      # bool[m]: valid and first of its exact run


def _lexsort(cols: list[torch.Tensor]) -> torch.Tensor:
    """Permutation ordering rows by cols[0], cols[1], ... (successive
    stable sorts from the last key; the JAX lax.sort over the tuple)."""
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for col in reversed(cols):
        order = order[torch.sort(col[order], stable=True).indices]
    return order


def _dedup_order(out_starts, lengths, valid):
    G = out_starts.shape[1]
    return _lexsort([out_starts[:, g] for g in range(G)]
                    + [lengths, (~valid).to(torch.int32)])


def dedup_flags_plain(lefts, present, is_fwd, lengths, valid) -> Deduped:
    """Plain PyTorch version of K28."""
    sign = torch.where(is_fwd, 1, -1).to(torch.int32)
    out = torch.where(present, sign * (lefts + 1), 0).to(torch.int32)
    order = _dedup_order(out, lengths, valid)
    srows = out[order]
    slens = lengths[order]
    m = srows.shape[0]
    first = torch.ones(m, dtype=torch.bool, device=srows.device)
    first[1:] = (srows[1:] != srows[:-1]).any(dim=1) \
        | (slens[1:] != slens[:-1])
    return Deduped(srows, slens, valid[order] & first)


@cuda.launcher
def dedup_flags(lefts, present, is_fwd, lengths, valid) -> Deduped:
    """Shard-local dedup of extended rows: signed 1-based starts
    (is_fwd ? 1 : -1) * (lefts + 1) where present, the rows sorted by
    (starts..., length, ~valid), and uniq marking each valid row that
    differs from the one before it.  lefts int32[m, G], present and
    is_fwd bool[m, G], lengths int32[m], valid bool[m].  CPU tensors take
    the plain version; CUDA tensors launch K28 (two passes around the
    lexsort's stable torch.sorts), except for no rows (nothing
    launched)."""
    if lefts.device.type == "cpu":
        return dedup_flags_plain(lefts, present, is_fwd, lengths, valid)
    dev = lefts.device
    m, G = lefts.shape
    cuda.require(lefts, "lefts", torch.int32, dev, (m, G))
    cuda.require(present, "present", torch.bool, dev, (m, G))
    cuda.require(is_fwd, "is_fwd", torch.bool, dev, (m, G))
    cuda.require(lengths, "lengths", torch.int32, dev, (m,))
    cuda.require(valid, "valid", torch.bool, dev, (m,))
    srows = torch.empty((m, G), dtype=torch.int32, device=dev)
    slens = torch.empty(m, dtype=torch.int32, device=dev)
    uniq = torch.empty(m, dtype=torch.bool, device=dev)
    if m == 0:
        return Deduped(srows, slens, uniq)
    lib = cuda.library()
    stream = cuda.stream(lefts)
    out = torch.empty((m, G), dtype=torch.int32, device=dev)
    cuda.check(lib.lm_dedup_starts(
        lefts.data_ptr(), present.data_ptr(), is_fwd.data_ptr(), m, G,
        out.data_ptr(), stream), "lm_dedup_starts")
    order = _dedup_order(out, lengths, valid)
    cuda.check(lib.lm_dedup_flags(
        out.data_ptr(), lengths.data_ptr(), valid.data_ptr(),
        order.data_ptr(), m, G, srows.data_ptr(), slens.data_ptr(),
        uniq.data_ptr(), stream), "lm_dedup_flags")
    dedup_flags.launches += 1
    return Deduped(srows, slens, uniq)


dedup_flags.launches = 0
