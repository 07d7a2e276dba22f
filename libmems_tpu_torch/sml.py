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
behind every real window).

Persistence is the JAX package's SMLT0001 file, byte for byte (FileSML's
load-if-present-and-the-seed-matches, else recreate;
MatchList::LoadSMLs, libMems/MatchList.h:261-349): the magic, four <u8
header words (seed, length, circular, windows), the position-order keys
as <u8 values of the JAX key width (u32 keys widened, their sentinel
0xFFFFFFFF; u64 keys with the all-ones sentinel), then the <i4 sorted
positions.  A file written by either package loads in both.  The
out-of-core builds (``create_big``: the native distribution sort of
native/dmsml.cpp, else the Python split-sort-merge) are host code; the
device sees only the uploaded result.
"""

from __future__ import annotations

import heapq
import logging
import os
import shutil
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch import seeds as seedlib
from libmems_tpu_torch.ops.mers import (canonical_seed_keys,
                                        canonical_seed_keys_np, key_bits,
                                        sort_keys)
from libmems_tpu_torch.sequence import Genome

_MAGIC = b"SMLT0001"   # the JAX package's SML file format v1
_LOAD_CHUNK = 1 << 22  # rows a host-to-device upload step holds
_log = logging.getLogger(__name__)


def _file_keys(keys: np.ndarray, seed: int) -> np.ndarray:
    """int64 keys -> the file's <u8 values of the JAX key width."""
    if key_bits(seed) == 32:
        return (keys & 0xFFFFFFFF).astype("<u8")
    return keys.view("<u8")


def _int64_keys(keys: np.ndarray, seed: int) -> np.ndarray:
    """The file's <u8 keys -> int64 keys as the port holds them
    (convert.py: u32 widened, u64 bit pattern kept).  The native builder
    writes the u64 all-ones sentinel at every width; u32 keys keep its
    low 32 bits, as the JAX package's load narrows it."""
    if key_bits(seed) == 32:
        return (keys & 0xFFFFFFFF).astype(np.int64)
    return np.array(keys).view(np.int64)


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
    @cuda.entry(cuda.device_arg)
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

    # -- persistence (FileSML load-or-create semantics) ------------------

    def save(self, path: str | os.PathLike):
        """Write the SMLT0001 file (libmems_tpu/sml.py:175-184), fetching
        the keys and positions _LOAD_CHUNK rows at a time."""
        n = self.n_windows
        with open(os.fspath(path), "wb") as fh:
            fh.write(_MAGIC)
            fh.write(np.array([self.seed, self.length, int(self.circular),
                               n], dtype="<u8").tobytes())
            for i in range(0, n, _LOAD_CHUNK):
                _file_keys(self.keys[i:i + _LOAD_CHUNK].cpu().numpy(),
                           self.seed).tofile(fh)
            for i in range(0, n, _LOAD_CHUNK):
                self.sorted_positions[i:i + _LOAD_CHUNK].cpu().numpy(
                ).astype("<i4").tofile(fh)

    @staticmethod
    @cuda.entry(cuda.device_arg)
    def load(path: str | os.PathLike, mmap: bool = True, device="cuda"
             ) -> "SortedMerList":
        """Load an SML file onto `device`.  With mmap=True (default) the
        file's key and position arrays are memory-mapped (FileSML's
        mapped_file_source, libMems/FileSML.h:109-111) and uploaded
        _LOAD_CHUNK rows at a time, so host RAM holds one chunk; without
        it they are read whole.  The sorted keys are a device gather of
        the keys by the sorted positions, never a host copy."""
        dev = cuda.resolve_device(device)
        path = os.fspath(path)
        with open(path, "rb") as fh:
            if fh.read(8) != _MAGIC:
                raise ValueError(f"{path}: not a libmems_tpu SML file")
            seed, length, circular, n = (
                int(x) for x in np.frombuffer(fh.read(32), dtype="<u8"))
            keys_off = fh.tell()
        spos_off = keys_off + 8 * n
        keys = torch.empty(n, dtype=torch.int64, device=dev)
        spos = torch.empty(n, dtype=torch.int32, device=dev)
        if mmap and n:
            keys_mm = np.memmap(path, dtype="<u8", mode="r",
                                offset=keys_off, shape=(n,))
            spos_mm = np.memmap(path, dtype="<i4", mode="r",
                                offset=spos_off, shape=(n,))
            for i in range(0, n, _LOAD_CHUNK):
                keys[i:i + _LOAD_CHUNK] = torch.from_numpy(_int64_keys(
                    np.asarray(keys_mm[i:i + _LOAD_CHUNK]), seed))
                spos[i:i + _LOAD_CHUNK] = torch.from_numpy(
                    np.array(spos_mm[i:i + _LOAD_CHUNK]))
            del keys_mm, spos_mm
        elif n:
            with open(path, "rb") as fh:
                fh.seek(keys_off)
                keys64 = np.fromfile(fh, dtype="<u8", count=n)
                spos_np = np.fromfile(fh, dtype="<i4", count=n)
            keys.copy_(torch.from_numpy(_int64_keys(keys64, seed)))
            spos.copy_(torch.from_numpy(spos_np.astype(np.int32)))
        return SortedMerList(seed=seed, length=length, keys=keys,
                             sorted_keys=keys[spos.long()],
                             sorted_positions=spos,
                             circular=bool(circular), filename=path)

    @staticmethod
    @cuda.entry(cuda.device_arg)
    def create_big(genome_or_codes, seed: int, sml_path: str,
                   scratch_dir: str | None = None,
                   mem_limit: int = 256 << 20,
                   circular: bool = False, device="cuda"
                   ) -> "SortedMerList":
        """Out-of-core build (FileSML::dmCreate -> dmSML,
        FileSML.cpp:278-314) for genomes whose (key, pos) table exceeds
        device or host RAM: the native distribution sort when its
        library builds, else the Python split-sort-merge
        (_big_create_py, FileSML::BigCreate/Merge), as the JAX package
        chooses.  Both are host code; the file is then loaded onto
        `device`."""
        from libmems_tpu_torch import native
        if native.available():
            _log.info("create_big: native distribution sort -> %s",
                      sml_path)
            native.create_file_sml(genome_or_codes, seed, sml_path,
                                   scratch_dir=scratch_dir,
                                   mem_limit=mem_limit, circular=circular)
            return SortedMerList.load(sml_path, device=device)
        _log.info("create_big: no native library, Python split-sort-merge "
                  "-> %s", sml_path)
        return SortedMerList._big_create_py(
            genome_or_codes, seed, sml_path, scratch_dir=scratch_dir,
            mem_limit=mem_limit, circular=circular, device=device)

    @staticmethod
    @cuda.entry(cuda.device_arg)
    def _big_create_py(genome_or_codes, seed: int, sml_path: str,
                       scratch_dir: str | None = None,
                       mem_limit: int = 256 << 20,
                       circular: bool = False, device="cuda"
                       ) -> "SortedMerList":
        """RAM-bounded split-sort-merge SML build (FileSML::BigCreate +
        Merge, libMems/FileSML.cpp:417-660; libmems_tpu/sml.py:279-384):
        the genome is processed in chunks that fit mem_limit, each
        chunk's (key, pos) records are sorted and spilled to a scratch
        run file, and the runs are k-way-merged into the sorted-position
        array.  Host RAM holds one chunk plus one merge block per run."""
        ambig = None
        if isinstance(genome_or_codes, Genome):
            codes = genome_or_codes.codes
            if genome_or_codes.ambig.any():
                ambig = genome_or_codes.ambig
        else:
            codes = np.asarray(genome_or_codes, dtype=np.uint8)
        length = len(codes)
        if circular:
            wrap = seedlib.seed_length(seed) - 1
            codes = np.concatenate([codes, codes[:wrap]])
            if ambig is not None:
                ambig = np.concatenate([ambig, ambig[:wrap]])
        seed_len = seedlib.seed_length(seed)
        n = max(len(codes) - seed_len + 1, 0)
        # 12 bytes/record (u8 key + i4 pos); chunk sized to mem_limit/4
        # to leave room for the sort's working copies
        chunk = max(1 << 16, int(mem_limit // (12 * 4)))
        run_paths = []
        tmpdir = tempfile.mkdtemp(dir=scratch_dir)
        try:
            def _chunk_keys(lo, hi):
                # windows starting in [lo, hi) need codes up to
                # hi+seed_len-1
                amb = None if ambig is None else \
                    ambig[lo:hi + seed_len - 1]
                return canonical_seed_keys_np(
                    codes[lo:hi + seed_len - 1], seed, amb).astype("<u8")

            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                part = _chunk_keys(lo, hi)
                order = np.argsort(part, kind="stable")
                rec = np.empty(hi - lo, dtype=[("k", "<u8"), ("p", "<i4")])
                rec["k"] = part[order]
                rec["p"] = np.arange(lo, hi, dtype="<i4")[order]
                rp = os.path.join(tmpdir, f"run{len(run_paths)}.bin")
                rec.tofile(rp)
                run_paths.append(rp)

            # k-way merge of the sorted runs -> sorted positions,
            # streaming
            rec_dt = np.dtype([("k", "<u8"), ("p", "<i4")])
            block = max(1 << 14, chunk // max(len(run_paths), 1))
            readers = [np.memmap(rp, dtype=rec_dt, mode="r")
                       for rp in run_paths]
            heads = [(int(r[0]["k"]), ri, 0) for ri, r in enumerate(readers)
                     if len(r)]
            heapq.heapify(heads)
            out = np.empty(block, dtype="<i4")
            fill = 0
            spos_path = os.path.join(tmpdir, "spos.bin")
            with open(spos_path, "wb") as sfh:
                while heads:
                    _, ri, off = heapq.heappop(heads)
                    out[fill] = readers[ri][off]["p"]
                    fill += 1
                    if fill == block:
                        out[:fill].tofile(sfh)
                        fill = 0
                    if off + 1 < len(readers[ri]):
                        heapq.heappush(
                            heads, (int(readers[ri][off + 1]["k"]), ri,
                                    off + 1))
                if fill:
                    out[:fill].tofile(sfh)
            del readers

            # the SML file: header + position-order keys + sorted
            # positions, streamed in chunks
            with open(sml_path, "wb") as fh:
                fh.write(_MAGIC)
                fh.write(np.array([seed, length, int(circular), n],
                                  dtype="<u8").tobytes())
                for lo in range(0, n, chunk):
                    _chunk_keys(lo, min(lo + chunk, n)).tofile(fh)
                spos_mm = np.memmap(spos_path, dtype="<i4", mode="r") \
                    if n else np.zeros(0, "<i4")
                for lo in range(0, n, chunk):
                    np.asarray(spos_mm[lo:lo + chunk]).tofile(fh)
                del spos_mm
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
        return SortedMerList.load(sml_path, device=device)

    @staticmethod
    @cuda.entry(cuda.device_arg)
    def create_with_fallback(genome_or_codes, seed: int,
                             sml_path: str | os.PathLike | None = None,
                             circular: bool = False,
                             scratch_dir: str | None = None,
                             device="cuda") -> "SortedMerList":
        """The in-memory build on `device`, falling back to the
        out-of-core build when the device or host allocator gives out:
        the reference's RAM-first, dmSML-on-bad_alloc policy
        (FileSML::Create catching bad_alloc -> dmCreate,
        libMems/FileSML.cpp:316-374).  Only torch.OutOfMemoryError and
        MemoryError fall back; any other failure (a kernel that does not
        build or launch, among them) raises."""
        try:
            sml = SortedMerList.create(genome_or_codes, seed,
                                       circular=circular, device=device)
            if sml_path is not None:
                sml.save(sml_path)
            return sml
        except (torch.OutOfMemoryError, MemoryError) as e:
            _log.info("create_with_fallback: %s: out-of-core build",
                      type(e).__name__)
        if sml_path is None:
            tmp = tempfile.NamedTemporaryFile(suffix=".sml", delete=False,
                                              dir=scratch_dir)
            tmp.close()
            sml_path = tmp.name
        return SortedMerList.create_big(genome_or_codes, seed,
                                        os.fspath(sml_path),
                                        scratch_dir=scratch_dir,
                                        circular=circular, device=device)

    @staticmethod
    @cuda.entry(cuda.device_arg)
    def load_or_create(genome: Genome, seed: int,
                       sml_path: str | os.PathLike | None = None,
                       circular: bool = False, device="cuda"
                       ) -> "SortedMerList":
        """Load the SML when the file exists with a matching seed and
        length, else (re)create it (MatchList::LoadSMLs,
        libMems/MatchList.h:261-349; the seed-mismatch recreate,
        h:297-302).  Creation falls back to the out-of-core build on
        allocator exhaustion."""
        if sml_path is not None and os.path.exists(sml_path):
            try:
                sml = SortedMerList.load(sml_path, device=device)
                if sml.seed == seed and sml.length == len(genome):
                    return sml
            except (ValueError, OSError):
                pass
        return SortedMerList.create_with_fallback(
            genome, seed, sml_path=sml_path, circular=circular,
            device=device)


def default_seed(genomes: list[Genome], seed_rank: int = 0) -> int:
    """Default seed pattern for a set of genomes
    (MatchList::GetDefaultMerSize, libMems/MatchList.h:351-357)."""
    if not genomes:
        raise ValueError("no genomes")
    avg = sum(len(g) for g in genomes) // len(genomes)
    weight = seedlib.default_seed_weight(avg)
    return seedlib.get_seed(weight, seed_rank)


@cuda.entry(cuda.device_arg)
def create_smls(genomes: list[Genome], seed: int | None = None,
                seed_rank: int = 0, device="cuda"
                ) -> tuple[list[SortedMerList], int]:
    """Create SMLs for all genomes on `device`
    (MatchList::CreateMemorySMLs, libMems/MatchList.h:407-435)."""
    if seed is None:
        seed = default_seed(genomes, seed_rank)
    return [SortedMerList.create(g, seed, device=device)
            for g in genomes], seed
