"""Canonical spaced-seed mer extraction (kernel K1, csrc/mers.cu).

Port of libmems_tpu/ops/mers.py.  A key is ``(content << 1) | strand``
where ``content`` packs the seed's `weight` sampled 2-bit characters
MSB-first, and the canonical key is ``min(fwd_key, rc_key)`` (forward
wins ties on palindromes); see the JAX module for the equivalence with
the reference's left-aligned bmers.

Keys are carried as int64 whatever the JAX key width (u32 when
``2*weight+1 <= 32``, else u64): every real key has at most 63 bits, so
its int64 value equals its unsigned value.  A window that overlaps an
ambiguous base gets the all-ones sentinel of the JAX width
(``key_sentinel``): 0xFFFFFFFF for u32 keys, -1 for u64 keys.  The u64
sentinel sorts FIRST as int64, so sorts flip bit 63 (``sort_keys``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch import seeds as seedlib

_I64_MIN = -(1 << 63)


def key_bits(seed: int) -> int:
    """Width of the JAX package's key dtype: 32 or 64."""
    return 32 if 2 * seedlib.seed_weight(seed) + 1 <= 32 else 64


def key_sentinel(seed: int) -> int:
    """int64 value of the all-ones masked-window key."""
    return 0xFFFFFFFF if key_bits(seed) == 32 else -1


def sentinel_content(seed: int) -> int:
    """Content field of the sentinel key (~0 >> 1 in the key width)."""
    return (1 << (key_bits(seed) - 1)) - 1


def sort_keys(keys: torch.Tensor, stable: bool = True):
    """Sort int64 keys in the unsigned order of the JAX key width.
    Returns (sorted keys, int64 positions)."""
    flipped = keys ^ _I64_MIN
    vals, pos = torch.sort(flipped, stable=stable)
    return vals ^ _I64_MIN, pos


def _window_bad(ambig: torch.Tensor, length: int, n: int) -> torch.Tensor:
    """bool[n]: window i contains an ambiguous base in [i, i+length)."""
    c = torch.cat([torch.zeros(1, dtype=torch.int32, device=ambig.device),
                   torch.cumsum(ambig.to(torch.int32), 0, dtype=torch.int32)])
    return (c[length:length + n] - c[:n]) > 0


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum of 64-bit patterns held in int64, in unsigned
    order (the JAX package's u64 keys)."""
    return torch.where((a ^ _I64_MIN) < (b ^ _I64_MIN), a, b)


def canonical_seed_keys_plain(codes: torch.Tensor, seed: int,
                              ambig: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of K1: one strided slice per seed offset,
    as the JAX module builds it (the minimum in unsigned order: at weight
    32 the shifted keys use bit 63)."""
    length = seedlib.seed_length(seed)
    weight = seedlib.seed_weight(seed)
    n = codes.shape[0] - length + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.int64, device=codes.device)
    fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rc = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for j, off in enumerate(seedlib.seed_offsets(seed)):
        ch = codes[off:off + n].to(torch.int64)
        fwd |= ch << (2 * (weight - 1 - j))
        rc |= (3 - ch) << (2 * j)
    keys = umin(fwd << 1, (rc << 1) | 1)
    if ambig is not None:
        bad = _window_bad(ambig, length, n)
        keys = torch.where(bad, torch.full_like(keys, key_sentinel(seed)),
                           keys)
    return keys


MAX_RUNS = 32   # csrc/mers.cu kMaxRuns


class SeedRuns(ctypes.Structure):
    """csrc/mers.cu's SeedRuns: the seed's run table."""
    _fields_ = [("n_runs", ctypes.c_int), ("weight", ctypes.c_int),
                ("length", ctypes.c_int), ("pad", ctypes.c_int),
                ("shift", ctypes.c_int * MAX_RUNS),
                ("mask", ctypes.c_uint64 * MAX_RUNS)]


def seed_runs(seed: int) -> list[tuple[int, int]]:
    """The seed's runs of consecutive sampled positions as K1 applies
    them: (shift, mask) pairs such that fwd is the OR of (W >> shift) &
    mask over the runs, where W holds a window's first 32 bases MSB-first
    (base k at bits 63-2k).  A run of `r` offsets starting at sample j
    and offset o moves base o + t (group 31 - o - t of W) to group
    weight - 1 - j - t of the content."""
    weight = seedlib.seed_weight(seed)
    offs = seedlib.seed_offsets(seed)
    runs, j = [], 0
    while j < weight:
        r = 1
        while j + r < weight and offs[j + r] == offs[j] + r:
            r += 1
        runs.append((2 * (32 - weight + j - offs[j]),
                     ((1 << 2 * r) - 1) << 2 * (weight - j - r)))
        j += r
    return runs


@functools.lru_cache(maxsize=None)
def _seed_runs_struct(seed: int) -> SeedRuns:
    """The run table of `seed` as K1's launcher takes it, built once."""
    runs = seed_runs(seed)
    length = seedlib.seed_length(seed)
    if len(runs) > MAX_RUNS or length > 32:
        raise ValueError(f"K1 takes seeds of at most 32 bases and "
                         f"{MAX_RUNS} runs (seed {seed:#b})")
    sr = SeedRuns(len(runs), seedlib.seed_weight(seed), length, 0)
    for r, (shift, mask) in enumerate(runs):
        sr.shift[r] = shift
        sr.mask[r] = mask
    return sr


@cuda.launcher
def canonical_seed_keys(codes: torch.Tensor, seed: int,
                        ambig: torch.Tensor | None = None) -> torch.Tensor:
    """Canonical seed keys for every window of one genome.

    codes: uint8[L] 2-bit codes; ambig: optional bool[L] (windows that
    overlap a True position get ``key_sentinel(seed)``).  Returns
    int64[L - seed_length + 1].  CPU tensors take the plain version; CUDA
    tensors launch K1."""
    if codes.device.type == "cpu":
        return canonical_seed_keys_plain(codes, seed, ambig)
    dev = codes.device
    cuda.require(codes, "codes", torch.uint8, dev, (codes.shape[0],))
    n = max(codes.shape[0] - seedlib.seed_length(seed) + 1, 0)
    if ambig is not None:
        cuda.require(ambig, "ambig", torch.bool, dev, (codes.shape[0],))
    out = torch.empty(n, dtype=torch.int64, device=dev)
    runs = _seed_runs_struct(seed)
    cuda.check(cuda.library().lm_seed_keys(
        codes.data_ptr(), ambig.data_ptr() if ambig is not None else None,
        n, ctypes.addressof(runs), key_sentinel(seed), out.data_ptr(),
        cuda.stream(codes)), "lm_seed_keys")
    canonical_seed_keys.launches += 1
    return out


canonical_seed_keys.launches = 0


def canonical_seed_keys_np(codes: np.ndarray, seed: int,
                           ambig: np.ndarray | None = None) -> np.ndarray:
    """Numpy twin (host paths: the gap-search pair twin), returning the
    JAX package's unsigned key dtype."""
    length = seedlib.seed_length(seed)
    weight = seedlib.seed_weight(seed)
    dt = np.uint32 if key_bits(seed) == 32 else np.uint64
    n = codes.shape[0] - length + 1
    if n <= 0:
        return np.zeros((0,), dtype=dt)
    fwd = np.zeros((n,), dtype=dt)
    rc = np.zeros((n,), dtype=dt)
    for j, off in enumerate(seedlib.seed_offsets(seed)):
        ch = codes[off:off + n].astype(dt)
        fwd = fwd | (ch << dt(2 * (weight - 1 - j)))
        rc = rc | ((dt(3) - ch) << dt(2 * j))
    keys = np.minimum(fwd << dt(1), (rc << dt(1)) | dt(1))
    if ambig is not None:
        a = np.asarray(ambig, bool)
        c = np.concatenate([np.zeros((1,), np.int32),
                            np.cumsum(a.astype(np.int32))])
        bad = (c[length:length + n] - c[:n]) > 0
        keys = np.where(bad, ~keys.dtype.type(0), keys)
    return keys
