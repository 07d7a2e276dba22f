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
tensors.
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


@cuda.launcher
def seed_run_counts(sorted_keys, sorted_positions, length: int,
                    sentinel: int) -> torch.Tensor:
    """int32[length] seed counts in position order.

    sorted_keys: int64[n] the SML's keys in sorted order; sorted_positions:
    int32[n] their window positions (a permutation of 0..n-1); length >= n
    the genome length; sentinel: the masked-window key
    (``ops.mers.key_sentinel``).  CPU tensors take the plain version; CUDA
    tensors launch K16."""
    if sorted_keys.device.type == "cpu":
        return seed_run_counts_plain(sorted_keys, sorted_positions, length,
                                     sentinel)
    dev = sorted_keys.device
    n = sorted_keys.shape[0]
    if length < n:
        raise ValueError(f"length {length} below the window count {n}")
    cuda.require(sorted_keys, "sorted_keys", torch.int64, dev, (n,))
    cuda.require(sorted_positions, "sorted_positions", torch.int32, dev, (n,))
    lib = cuda.library()
    stream = cuda.stream(sorted_keys)
    sc = torch.empty(n, dtype=torch.int32, device=dev)
    cuda.check(lib.lm_seed_run_starts(sorted_keys.data_ptr(), n,
                                      sc.data_ptr(), stream),
               "lm_seed_run_starts")
    rid1 = torch.cumsum(sc, 0, dtype=torch.int32)
    run_start = torch.empty(n + 1, dtype=torch.int64, device=dev)
    count = torch.empty(length, dtype=torch.int32, device=dev)
    cuda.check(lib.lm_seed_run_counts(
        sorted_keys.data_ptr(), sorted_positions.data_ptr(), sc.data_ptr(),
        rid1.data_ptr(), run_start.data_ptr(), n, length, sentinel,
        count.data_ptr(), stream), "lm_seed_run_counts")
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
    cuda.check(cuda.library().lm_seed_smooth(
        count.data_ptr(), length, seed_len, out.data_ptr(),
        cuda.stream(count)), "lm_seed_smooth")
    seed_smooth.launches += 1
    return out


seed_smooth.launches = 0
