"""Seed occurrence counts and their smoothing on the SML's device
(kernels K16 and K17, csrc/seedocc.cu).

Port of libmems_tpu/anchorscore.py's _seed_occurrence_device
(SeedOccurrenceList::construct + smoothFrequencies,
libMems/SeedOccurrenceList.h:22-92), in two steps:

* ``seed_run_counts`` (K16): per window position, how many windows of the
  genome share the seed content of the window that starts there (1 for a
  masked window and for the positions past the last window);
* ``seed_smooth`` (K17): the trailing mean of those counts over
  ``seed_len`` positions as float32, floor 1, the last position raw.

The JAX package pads the table to a length bucket and reorders with a
payload sort; the port works on the exact windows and scatters (the
sorted positions are a permutation).  Each wrapper takes its plain
PyTorch version for CPU tensors and launches its kernel for CUDA
tensors.  K16 is two launches over tiles of SEED_TILE sorted rows: the
tiles' first and last run starts (``_tile_edges``), then the counts
(``_count_pass``), each with a plain version (``seed_tile_edges_plain``,
``seed_run_counts_from_edges_plain``) that compose to
``seed_run_counts_plain``.
"""

from __future__ import annotations

import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch.ops.pairwise import cumsum32, shr


def seed_run_counts_plain(sorted_keys, sorted_positions, length: int,
                          sentinel: int) -> torch.Tensor:
    """Plain PyTorch version of K16."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    count = torch.ones(length, dtype=torch.int32, device=dev)
    if n == 0:
        return count
    content = shr(sorted_keys, 1)
    sc = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                    content[1:] != content[:-1]])
    starts = torch.nonzero(sc).flatten()
    bounds = torch.cat([starts, torch.full((1,), n, dtype=starts.dtype,
                                           device=dev)])
    r = (cumsum32(sc) - 1).to(torch.int64)
    runlen = (bounds[r + 1] - bounds[r]).to(torch.int32)
    runlen = torch.where(sorted_keys == sentinel, 1, runlen)
    count[sorted_positions.to(torch.int64)] = runlen
    return count


# sorted rows a tile of K16 (kSeedTile in csrc/seedocc.cu; its launchers
# refuse any other tile count)
SEED_TILE = 4096


def seed_tiles(n: int) -> int:
    """K16's tiles over n sorted rows."""
    return -(-n // SEED_TILE)


def _run_start_flags(sorted_keys) -> torch.Tensor:
    """bool[n]: row i starts a run of equal content (key >> 1)."""
    content = shr(sorted_keys, 1)
    return torch.cat([torch.ones(1, dtype=torch.bool,
                                 device=sorted_keys.device),
                      content[1:] != content[:-1]])


def _tiled(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x int64[n] as [tiles, SEED_TILE], the last tile padded with fill."""
    tiles = seed_tiles(x.shape[0])
    return torch.nn.functional.pad(
        x, (0, tiles * SEED_TILE - x.shape[0]), value=fill).view(
            tiles, SEED_TILE)


def seed_tile_edges_plain(sorted_keys) -> torch.Tensor:
    """Plain version of K16's first launch: int32[2 * tiles], the first
    run start of each tile of SEED_TILE sorted rows, then the last, -1
    where a tile holds none."""
    n = sorted_keys.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=sorted_keys.device)
    idx = torch.arange(n, device=sorted_keys.device)
    sc = _run_start_flags(sorted_keys)
    first = _tiled(torch.where(sc, idx, n), n).amin(1)
    last = _tiled(torch.where(sc, idx, -1), -1).amax(1)
    return torch.cat([torch.where(first == n, -1, first),
                      last]).to(torch.int32)


def seed_run_counts_from_edges_plain(sorted_keys, sorted_positions, edges,
                                     length: int,
                                     sentinel: int) -> torch.Tensor:
    """Plain version of K16's second launch: the run counts of
    seed_run_counts_plain, each run's bounds found inside its row's tile
    and, across a tile's edges, from the tile summaries `edges`
    (seed_tile_edges_plain)."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    count = torch.ones(length, dtype=torch.int32, device=dev)
    if n == 0:
        return count
    tiles = seed_tiles(n)
    first, last = edges[:tiles].long(), edges[tiles:].long()
    idx = torch.arange(n, device=dev)
    sc = _run_start_flags(sorted_keys)
    # a tile's left carry: the last start of the nearest earlier tile
    # with one; its right carry: the first start of the nearest later
    # tile with one, or n
    left = torch.cat([torch.full((1,), -1, device=dev),
                      torch.cummax(last, 0).values[:-1]])
    f = torch.where(first < 0, n, first)
    right = torch.cat([torch.cummin(f.flip(0), 0).values.flip(0)[1:],
                       torch.full((1,), n, device=dev)])
    start = torch.cummax(_tiled(torch.where(sc, idx, -1), -1), 1).values
    start = torch.where(start < 0, left[:, None], start)
    nxt = torch.cummin(_tiled(torch.where(sc, idx, n), n).flip(1),
                       1).values.flip(1)
    end = torch.cat([nxt[:, 1:], torch.full((tiles, 1), n, device=dev)], 1)
    end = torch.where(end == n, right[:, None], end)
    runlen = (end - start).flatten()[:n].to(torch.int32)
    runlen = torch.where(sorted_keys == sentinel, 1, runlen)
    count[sorted_positions.to(torch.int64)] = runlen
    return count


def _tile_edges(sorted_keys, edges) -> None:
    """K16's first launch: the tile summaries of sorted_keys into edges
    (int32[2 * seed_tiles(n)])."""
    n = sorted_keys.shape[0]
    cuda.check(cuda.library().lm_seed_tile_edges(
        sorted_keys.data_ptr(), n, seed_tiles(n), edges.data_ptr(),
        cuda.stream(sorted_keys)), "lm_seed_tile_edges")


def _count_pass(sorted_keys, sorted_positions, edges, length: int,
                sentinel: int, count) -> None:
    """K16's second launch: the run counts into count (int32[length])
    from the keys, positions and tile summaries."""
    n = sorted_keys.shape[0]
    cuda.check(cuda.library().lm_seed_run_counts(
        sorted_keys.data_ptr(), sorted_positions.data_ptr(),
        edges.data_ptr(), n, seed_tiles(n), length, sentinel,
        count.data_ptr(), cuda.stream(sorted_keys)), "lm_seed_run_counts")


@cuda.launcher
def seed_run_counts(sorted_keys, sorted_positions, length: int,
                    sentinel: int) -> torch.Tensor:
    """int32[length] seed counts in position order.

    sorted_keys: int64[n] the SML's keys in sorted order; sorted_positions:
    int32[n] their window positions (a permutation of 0..n-1); length >= n
    the genome length; sentinel: the masked-window key
    (``ops.mers.key_sentinel``).  CPU tensors take the plain version; CUDA
    tensors launch K16: the tile summaries, then the counts."""
    if sorted_keys.device.type == "cpu":
        return seed_run_counts_plain(sorted_keys, sorted_positions, length,
                                     sentinel)
    dev = sorted_keys.device
    n = sorted_keys.shape[0]
    if length < n:
        raise ValueError(f"length {length} below the window count {n}")
    cuda.require(sorted_keys, "sorted_keys", torch.int64, dev, (n,))
    cuda.require(sorted_positions, "sorted_positions", torch.int32, dev, (n,))
    edges = torch.empty(2 * seed_tiles(n), dtype=torch.int32, device=dev)
    count = torch.empty(length, dtype=torch.int32, device=dev)
    _tile_edges(sorted_keys, edges)
    _count_pass(sorted_keys, sorted_positions, edges, length, sentinel, count)
    seed_run_counts.launches += 1
    return count


seed_run_counts.launches = 0


def seed_smooth_plain(count: torch.Tensor, seed_len: int) -> torch.Tensor:
    """Plain PyTorch version of K17: the int64 prefix-sum difference of
    the JAX function (never a float cumsum), one float32 division."""
    length = count.shape[0]
    if length > 1 and seed_len > 0:
        padded = torch.cat([torch.ones(seed_len - 1, dtype=torch.int64,
                                       device=count.device),
                            count.to(torch.int64)])
        csum = torch.cat([torch.zeros(1, dtype=torch.int64,
                                      device=count.device),
                          torch.cumsum(padded, 0)])
        smoothed = (csum[seed_len:] - csum[:-seed_len]).to(torch.float32) \
            / torch.tensor(seed_len, dtype=torch.float32, device=count.device)
        countf = torch.cat([smoothed[:-1], count[-1:].to(torch.float32)])
    else:
        countf = count.to(torch.float32)
    return countf.clamp(min=1.0)


def _smooth_pass(count, seed_len: int, out) -> None:
    """K17's launch: the smoothed frequencies of count into out."""
    cuda.check(cuda.library().lm_seed_smooth(
        count.data_ptr(), count.shape[0], seed_len, out.data_ptr(),
        cuda.stream(count)), "lm_seed_smooth")


@cuda.launcher
def seed_smooth(count: torch.Tensor, seed_len: int) -> torch.Tensor:
    """float32[length] smoothed seed frequencies of int32[length] counts.
    CPU tensors take the plain version; CUDA tensors launch K17."""
    if count.device.type == "cpu":
        return seed_smooth_plain(count, seed_len)
    dev = count.device
    length = count.shape[0]
    cuda.require(count, "count", torch.int32, dev, (length,))
    out = torch.empty(length, dtype=torch.float32, device=dev)
    _smooth_pass(count, seed_len, out)
    seed_smooth.launches += 1
    return out


seed_smooth.launches = 0
