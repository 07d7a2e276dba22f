"""Sorted Mer List (SML): canonical spaced-seed mer index of one genome.

Port of libmems_tpu/sml.py (SortedMerList::Create + std::sort,
libMems/SortedMerList.cpp:786, FileSML.cpp:344).  The index is three
tensors on the run's device:

* ``keys``: int64 canonical seed key per window, position order (K1,
  libmems_tpu_torch.ops.mers);
* ``sorted_keys`` / ``sorted_positions``: the SML proper, (key, position)
  pairs ordered by key in the JAX key width's unsigned order, then by
  position (a stable sort).

The JAX package pads every table to a length bucket so that genomes of
nearby sizes share compiled programs; PyTorch runs eagerly, so the port
sorts the exact window count (the padding only ever added sentinel keys
behind every real window).  Save/load and the out-of-core build are not
ported yet (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch import seeds as seedlib
from libmems_tpu_torch.ops.mers import canonical_seed_keys, sort_keys
from libmems_tpu_torch.sequence import Genome


@dataclass
class SortedMerList:
    """Canonical spaced-seed mer index of one genome (device tensors)."""

    seed: int
    length: int                    # genome length in bases
    keys: torch.Tensor             # int64 key per window, position order
    sorted_keys: torch.Tensor      # int64
    sorted_positions: torch.Tensor  # int32 window positions ordered by key
    circular: bool = False
    filename: str = ""

    @property
    def seed_length(self) -> int:
        return seedlib.seed_length(self.seed)

    @property
    def seed_weight(self) -> int:
        return seedlib.seed_weight(self.seed)

    @property
    def n_windows(self) -> int:
        """Number of seed windows (SMLSize): length - seed_length + 1."""
        return int(self.keys.shape[0])

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @staticmethod
    def create(genome_or_codes, seed: int, circular: bool = False,
               filename: str = "", ambig: np.ndarray | None = None,
               device="cuda") -> "SortedMerList":
        """Build the SML on `device`.  `ambig` (bool[L], defaulting to
        the Genome's own mask) gives every seed window that overlaps an
        ambiguous base the sentinel key (maskNNNNN equivalent,
        libMems/FileSML.h:135)."""
        dev = cuda.resolve_device(device)
        if isinstance(genome_or_codes, Genome):
            codes = genome_or_codes.codes
            if ambig is None:
                a = genome_or_codes.ambig
                ambig = a if a.any() else None
            filename = filename or genome_or_codes.filename
            circular = circular or genome_or_codes.circular
        else:
            codes = np.asarray(genome_or_codes, dtype=np.uint8)
        if ambig is not None and not np.asarray(ambig).any():
            ambig = None
        if circular:
            # circular sequences wrap seed_length-1 characters
            # (SortedMerList::Create, SortedMerList.cpp:797-800)
            wrap = seedlib.seed_length(seed) - 1
            codes = np.concatenate([codes, codes[:wrap]])
            if ambig is not None:
                ambig = np.concatenate([ambig, ambig[:wrap]])
            length = len(codes) - wrap
        else:
            length = len(codes)
        codes_t = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)
                                   ).to(dev)
        ambig_t = None
        if ambig is not None:
            ambig_t = torch.from_numpy(
                np.ascontiguousarray(ambig, dtype=bool)).to(dev)
        keys = canonical_seed_keys(codes_t, seed, ambig_t)
        skeys, spos = sort_keys(keys, stable=True)
        return SortedMerList(seed=seed, length=int(length), keys=keys,
                             sorted_keys=skeys,
                             sorted_positions=spos.to(torch.int32),
                             circular=circular, filename=filename)

    def unique_mer_count(self) -> int:
        """Number of distinct canonical mer contents
        (SortedMerList::GetUniqueMerCount, SortedMerList.cpp:465-505)."""
        if self.n_windows == 0:
            return 0
        contents = (self.sorted_keys >> 1) & ((1 << 63) - 1)
        return int(1 + (contents[1:] != contents[:-1]).sum())


def default_seed(genomes: list[Genome], seed_rank: int = 0) -> int:
    """Default seed pattern for a set of genomes
    (MatchList::GetDefaultMerSize, libMems/MatchList.h:351-357)."""
    if not genomes:
        raise ValueError("no genomes")
    avg = sum(len(g) for g in genomes) // len(genomes)
    weight = seedlib.default_seed_weight(avg)
    return seedlib.get_seed(weight, seed_rank)


def create_smls(genomes: list[Genome], seed: int | None = None,
                seed_rank: int = 0, device="cuda"
                ) -> tuple[list[SortedMerList], int]:
    """Create SMLs for all genomes on `device`
    (MatchList::CreateMemorySMLs, libMems/MatchList.h:407-435)."""
    if seed is None:
        seed = default_seed(genomes, seed_rank)
    return [SortedMerList.create(g, seed, device=device)
            for g in genomes], seed
