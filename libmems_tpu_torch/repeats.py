"""Within-genome repeat discovery (the procrastAligner seeder).

Port of libmems_tpu/repeats.py (RepeatHash / RepeatMatch /
RepeatMatchList, libMems/RepeatHash.{h,cpp}, RepeatMatchList.cpp): every
canonical seed content occurring >= 2 times in ONE genome yields a single
repeat match of multiplicity = occurrence count — starts sorted by
position, strands set relative to the first occurrence
(RepeatHash::HashMatch, RepeatHash.cpp:39-61) — then extended outward to
a maximal repeat while every copy's canonical seed mer stays equal with
consistent strand parity: K2 (libmems_tpu_torch.ops.extend) with every
"row genome" pointing at the same SML, one launch per multiplicity, rows
up to max_multiplicity slots wide.

The run bookkeeping is host numpy copied from the JAX module; the SML and
the extension run on `device`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch import seeds as seedlib
from libmems_tpu_torch.ops.extend import extend_matches
from libmems_tpu_torch.ops.mers import key_sentinel
from libmems_tpu_torch.sequence import Genome
from libmems_tpu_torch.sml import SortedMerList


@dataclass
class RepeatMatchArray:
    """Repeats of one genome: ragged multiplicity stored padded.

    starts: int64[n, max_mult] signed 1-based (0 = unused slot);
    lengths: int64[n].
    """

    starts: np.ndarray
    lengths: np.ndarray

    def __len__(self) -> int:
        return int(self.lengths.shape[0])

    def multiplicity(self) -> np.ndarray:
        return (self.starts != 0).sum(axis=1)


def _run_device(arguments):
    """cuda.entry's pick: the SML's device, or `device` for a genome."""
    x = arguments["genome_or_sml"]
    return x.device if isinstance(x, SortedMerList) else arguments["device"]


@cuda.entry(_run_device)
def find_repeats(genome_or_sml, seed: int | None = None,
                 max_multiplicity: int = 1000,
                 min_length: int | None = None,
                 device="cuda") -> RepeatMatchArray:
    """Find maximal repeat families (RepeatHash::CreateMatches analog).

    max_multiplicity bounds the occurrence count per family (the
    MER_REPEAT_LIMIT analog); families above it are skipped.  A genome is
    indexed on `device`; an SML is used where it lies.
    """
    if isinstance(genome_or_sml, SortedMerList):
        sml = genome_or_sml
        seed = sml.seed
    else:
        genome = genome_or_sml if isinstance(genome_or_sml, Genome) \
            else Genome.from_string(genome_or_sml)
        if seed is None:
            weight = seedlib.default_seed_weight(len(genome))
            seed = seedlib.get_seed(max(weight, 5), 0)
        sml = SortedMerList.create(genome, seed, device=device)
    seed_len = sml.seed_length
    dev = sml.device

    skeys = sml.sorted_keys.cpu().numpy()
    spos = sml.sorted_positions.cpu().numpy()
    # the JAX key's logical content: int64 keys carry the unsigned pattern
    content = (skeys >> 1) & np.int64((1 << 63) - 1)
    strand = (skeys & 1).astype(np.int8)
    n = len(content)
    if n == 0:
        return RepeatMatchArray(np.zeros((0, 0), np.int64),
                                np.zeros(0, np.int64))
    change = np.concatenate([[True], content[1:] != content[:-1]])
    run_id = np.cumsum(change) - 1
    run_len = np.bincount(run_id)
    keep = (run_len[run_id] >= 2) & (run_len[run_id] <= max_multiplicity)
    if not keep.any():
        return RepeatMatchArray(np.zeros((0, 0), np.int64),
                                np.zeros(0, np.int64))

    rid = run_id[keep]
    pos = spos[keep].astype(np.int64)
    st = strand[keep]
    # within each run: sort occurrences by position (idmer_position_
    # lessthan, RepeatHash.cpp:43); strands relative to the first
    order = np.lexsort((pos, rid))
    rid, pos, st = rid[order], pos[order], st[order]
    run_change = np.concatenate([[True], rid[1:] != rid[:-1]])
    first_idx = np.cumsum(run_change) - 1
    run_first = np.flatnonzero(run_change)
    ref_strand = st[run_first][first_idx]
    sign = np.where(st == ref_strand, 1, -1).astype(np.int64)
    occ_idx = np.arange(len(rid)) - run_first[first_idx]
    k = run_len[rid]  # multiplicity of each occurrence's family

    rows = []
    lens = []
    keys_concat = sml.keys
    cnt = sml.n_windows

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    for mult in np.unique(k):
        sel = k == mult
        fam_ids, fam_index = np.unique(rid[sel], return_inverse=True)
        R = len(fam_ids)
        starts = np.zeros((R, int(mult)), dtype=np.int64)
        starts[fam_index, occ_idx[sel]] = sign[sel] * (pos[sel] + 1)
        # extend on device: every slot addresses the same genome
        Rp = max(8, 1 << (R - 1).bit_length())
        pad = Rp - R
        starts_p = np.concatenate(
            [starts, np.zeros((pad, int(mult)), np.int64)])
        present = starts_p != 0
        lefts = np.where(present, np.abs(starts_p) - 1, 0).astype(np.int32)
        is_fwd = starts_p > 0
        gen_off = np.zeros((Rp, int(mult)), np.int32)
        gen_cnt = np.full((Rp, int(mult)), cnt, np.int32)
        lengths0 = np.full(Rp, seed_len, np.int32)
        out_lefts, out_lengths = extend_matches(
            keys_concat, seed_len, max(seed_len, 128), put(gen_off),
            put(gen_cnt), put(lefts), put(present), put(is_fwd),
            put(lengths0), key_sentinel(seed))
        out_lefts = out_lefts.cpu().numpy()[:R]
        out_lengths = out_lengths.cpu().numpy()[:R].astype(np.int64)
        s = np.sign(starts) * (out_lefts.astype(np.int64) + 1)
        s[starts == 0] = 0
        rows.append(s)
        lens.append(out_lengths)

    max_mult = max(r.shape[1] for r in rows)
    padded = [np.pad(r, ((0, 0), (0, max_mult - r.shape[1])))
              for r in rows]
    starts = np.concatenate(padded)
    lengths = np.concatenate(lens)
    # dedup: the same maximal repeat reached from several seeds
    key = np.concatenate([starts, lengths[:, None]], axis=1)
    _, uniq = np.unique(key, axis=0, return_index=True)
    uniq = np.sort(uniq)
    starts, lengths = starts[uniq], lengths[uniq]
    if min_length:
        keep = lengths >= min_length
        starts, lengths = starts[keep], lengths[keep]
    # canonical order: by first occurrence position
    order = np.argsort(np.abs(starts[:, 0]), kind="stable")
    return RepeatMatchArray(starts[order], lengths[order])


def write_repeat_list(path_or_fh, repeats: RepeatMatchArray,
                      seq_filename: str, seq_length: int):
    """RepeatMatchList::WriteList-style text output (RepeatMatchList.cpp):
    FormatVersion 3 header, then per family: length, starts,
    multiplicity, family id, subset/superset ids (always 0)."""
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "w") if own else path_or_fh
    try:
        fh.write("FormatVersion\t3\n")
        fh.write("SequenceCount\t1\n")
        fh.write(f"Sequence0File\t{seq_filename or 'null'}\n")
        fh.write(f"Sequence0Length\t{seq_length}\n")
        fh.write(f"MatchCount\t{len(repeats)}\n")
        for i in range(len(repeats)):
            row = repeats.starts[i]
            occ = row[row != 0]
            fh.write(str(int(repeats.lengths[i])))
            for s in occ:
                fh.write(f"\t{int(s)}")
            fh.write(f"\t{len(occ)}\t{i}\t0\t0\n")
    finally:
        if own:
            fh.close()
