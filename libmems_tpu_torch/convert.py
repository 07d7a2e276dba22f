"""State carried across from the JAX package (libmems_tpu).

The two packages share no code at run time: the port never imports the
JAX package.  These functions take plain numpy arrays and numbers, as a
JAX-package object hands them out, and return the port's equivalents,
so an index built by either package can feed the other and the DP and
HMM constants of both can be held equal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch.sml import SortedMerList


def _keys_to_int64(keys: np.ndarray) -> torch.Tensor:
    """u32 keys widen; u64 keys keep their bit pattern (every real key
    is below 2**63, and the all-ones sentinel becomes -1)."""
    keys = np.array(keys)          # a writable copy
    if keys.dtype == np.uint64:
        return torch.from_numpy(keys.view(np.int64))
    if keys.dtype == np.uint32:
        return torch.from_numpy(keys.astype(np.int64))
    raise TypeError(f"keys must be uint32 or uint64, not {keys.dtype}")


def sml_from_reference(keys, sorted_keys, sorted_positions, seed: int,
                       length: int, circular: bool, device
                       ) -> SortedMerList:
    """The port's SortedMerList from the numpy arrays of a JAX-package
    SortedMerList (its keys, sorted_keys and sorted_positions)."""
    dev = cuda.resolve_device(device)
    return SortedMerList(
        seed=int(seed), length=int(length),
        keys=_keys_to_int64(keys).to(dev),
        sorted_keys=_keys_to_int64(sorted_keys).to(dev),
        sorted_positions=torch.from_numpy(
            np.array(sorted_positions, dtype=np.int32)).to(dev),
        circular=bool(circular))


class ProfileScoring(NamedTuple):
    """The profile DP's parameters: the 5x5 expected-score matrix over
    (A, C, G, T, gap) and the affine gap costs."""

    w5: np.ndarray        # float32[5, 5]
    gap_open: float
    gap_extend: float


def hmm_matrices_from_reference(ls, lt, lstop, le, device) -> tuple:
    """The homology HMM's log matrices (log start [2], log transitions
    [2, 2], log stop [2], log emissions [2, 8], state order (H, U)), as
    a JAX-package ``ops.hmm._log_matrices`` returns them, as the float64
    tensors on `device` that the port's kernel K8 takes."""
    shapes = ((2,), (2, 2), (2,), (2, 8))
    out = []
    for x, shape in zip((ls, lt, lstop, le), shapes):
        x = np.array(x, dtype=np.float64)
        if x.shape != shape:
            raise ValueError(f"expected HMM matrix shape {shape}, got "
                             f"{x.shape}")
        out.append(torch.from_numpy(x).to(cuda.resolve_device(device)))
    return tuple(out)


def scoring_from_reference(hoxd70, w5, gap_open, gap_extend
                           ) -> ProfileScoring:
    """The DP parameters from a package's HOXD70, W5, GAP_OPEN and
    GAP_EXTEND, checked for the layout the profile DP assumes: W5 holds
    HOXD70 over ACGT and zeros in the gap row and column."""
    hoxd70 = np.asarray(hoxd70)
    w5 = np.asarray(w5, dtype=np.float32)
    if hoxd70.shape != (4, 4) or w5.shape != (5, 5):
        raise ValueError("expected HOXD70 [4, 4] and W5 [5, 5]")
    if not (np.array_equal(w5[:4, :4], hoxd70.astype(np.float32))
            and not w5[4].any() and not w5[:, 4].any()):
        raise ValueError("W5 must be HOXD70 padded with a zero gap row "
                         "and column")
    return ProfileScoring(w5=w5, gap_open=float(gap_open),
                          gap_extend=float(gap_extend))
