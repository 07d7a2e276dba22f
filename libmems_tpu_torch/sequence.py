"""Genome sequence model and file I/O.

Replaces the libGenome dependency of the reference (gnSequence +
FastA/GenBank/raw parsers; cf. libMems/MatchList.h:167-258 LoadSequences /
LoadMFASequences / LoadAndCreateRawSequences).  Sequences are held as numpy
``uint8`` arrays in two forms:

* ``ascii`` — raw nucleotide characters (for output / gapped alignment)
* ``codes`` — 2-bit codes via the libMems translation table
  (A,a and every unrecognised character -> 0; C,c,B,b,Y,y -> 1;
  G,g,S,s,K,k -> 2; T,t -> 3; reference: libMems/SortedMerList.cpp:29-47
  CreateBasicDNATable).  Complement of a code x is 3-x.

Gap characters ('-') are rejected exactly like translate32
(libMems/SortedMerList.cpp:431-436).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field

import numpy as np

_TRANSLATION = np.zeros(256, dtype=np.uint8)
for _c in "cCbByY":
    _TRANSLATION[ord(_c)] = 1
for _c in "gGsSkK":
    _TRANSLATION[ord(_c)] = 2
for _c in "tT":
    _TRANSLATION[ord(_c)] = 3


def translate_dna(seq: str | bytes | np.ndarray) -> np.ndarray:
    """ASCII nucleotides -> 2-bit codes (uint8 in [0,3]).

    Raises ValueError on gap characters, mirroring translate32's rejection
    of aligned input (libMems/SortedMerList.cpp:431-436).
    """
    if isinstance(seq, str):
        arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    elif isinstance(seq, (bytes, bytearray)):
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    if (arr == ord("-")).any():
        raise ValueError(
            "gap character in genome sequence; input must be unaligned and ungapped"
        )
    return _TRANSLATION[arr]


_IS_ACGT = np.zeros(256, dtype=bool)
for _c in "ACGTacgt":
    _IS_ACGT[ord(_c)] = True


def ambig_mask(seq: str | bytes | np.ndarray) -> np.ndarray:
    """bool[L]: True where the character is not an unambiguous A/C/G/T.

    Seed windows overlapping such positions are excluded from the mer
    index (sentinel-keyed) so N-runs in draft genomes cannot seed or
    extend matches — the reference's maskNNNNN behaviour
    (libMems/FileSML.h:135, used by dmCreate FileSML.cpp:278-314),
    applied uniformly to all index builds."""
    if isinstance(seq, str):
        arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    elif isinstance(seq, (bytes, bytearray)):
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    return ~_IS_ACGT[arr]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a 2-bit code array (complement = 3 - x)."""
    return (3 - codes[::-1]).astype(np.uint8)


_COMPLEMENT_ASCII = np.frombuffer(
    bytes(range(256)), dtype=np.uint8
).copy()
for _a, _b in [("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"),
               ("a", "t"), ("c", "g"), ("g", "c"), ("t", "a"),
               ("R", "Y"), ("Y", "R"), ("r", "y"), ("y", "r"),
               ("K", "M"), ("M", "K"), ("k", "m"), ("m", "k"),
               ("B", "V"), ("V", "B"), ("b", "v"), ("v", "b"),
               ("D", "H"), ("H", "D"), ("d", "h"), ("h", "d")]:
    _COMPLEMENT_ASCII[ord(_a)] = ord(_b)


def revcomp_ascii(ascii_arr: np.ndarray) -> np.ndarray:
    """Reverse complement of an ASCII nucleotide array (IUPAC aware)."""
    return _COMPLEMENT_ASCII[ascii_arr[::-1]]


@dataclass
class Genome:
    """One input genome: name, source file, raw characters, 2-bit codes."""

    name: str
    ascii: np.ndarray  # uint8 nucleotide characters
    filename: str = ""
    circular: bool = False
    codes: np.ndarray = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self):
        if self.codes is None:
            self.codes = translate_dna(self.ascii)
        self._ambig = None

    @property
    def ambig(self) -> np.ndarray:
        """bool[L]: True at ambiguous (non-ACGT) positions; seed windows
        overlapping them are excluded from the mer index."""
        if self._ambig is None:
            self._ambig = ambig_mask(self.ascii)
        return self._ambig

    def __len__(self) -> int:
        return int(self.ascii.shape[0])

    @property
    def length(self) -> int:
        return int(self.ascii.shape[0])

    def subseq(self, left: int, length: int) -> np.ndarray:
        """1-based, inclusive-left extraction of `length` ASCII characters."""
        return self.ascii[left - 1 : left - 1 + length]

    def to_string(self) -> str:
        return self.ascii.tobytes().decode("ascii")

    @staticmethod
    def from_string(seq: str, name: str = "", filename: str = "",
                    circular: bool = False) -> "Genome":
        arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8).copy()
        return Genome(name=name, ascii=arr, filename=filename, circular=circular)


def _parse_fasta_stream(fh: io.TextIOBase) -> list[tuple[str, np.ndarray]]:
    records: list[tuple[str, np.ndarray]] = []
    name = None
    chunks: list[bytes] = []
    for line in fh:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                records.append((name, _join_seq(chunks)))
            name = line[1:].strip()
            chunks = []
        else:
            chunks.append(line.encode("ascii"))
    if name is not None:
        records.append((name, _join_seq(chunks)))
    return records


def _join_seq(chunks: list[bytes]) -> np.ndarray:
    return np.frombuffer(b"".join(chunks), dtype=np.uint8).copy()


def _parse_genbank_stream(fh: io.TextIOBase) -> list[tuple[str, np.ndarray]]:
    """Minimal GenBank flat-file parser: LOCUS name + ORIGIN sequence,
    one record per LOCUS...// block (multi-record files supported;
    FEATURES/annotations are skipped — this library aligns sequence, it
    does not consume annotations; README "Scope limits").  A trailing
    record missing its // terminator is still flushed."""
    records: list[tuple[str, np.ndarray]] = []
    name = ""
    in_origin = False
    chunks: list[bytes] = []
    for line in fh:
        if line.startswith("LOCUS"):
            # malformed variant: a new LOCUS without a preceding //
            # closes the open record rather than merging into it
            if in_origin and chunks:
                records.append((name, _join_seq(chunks)))
            parts = line.split()
            name = parts[1] if len(parts) > 1 else ""
            in_origin, chunks = False, []
        elif line.startswith("ORIGIN"):
            in_origin = True
        elif line.startswith("//"):
            records.append((name, _join_seq(chunks)))
            name, in_origin, chunks = "", False, []
        elif in_origin:
            seq = "".join(c for c in line if c.isalpha())
            chunks.append(seq.encode("ascii"))
    if in_origin and chunks:
        records.append((name, _join_seq(chunks)))
    return records


def read_fasta(path: str | os.PathLike, concatenate: bool = True) -> list[Genome]:
    """Load a FastA (or GenBank, by extension/content) file.

    With ``concatenate=True`` multiple records in one file are joined into a
    single Genome, matching how mauveAligner treats multi-contig inputs as
    one concatenated coordinate system (cf. MatchList::LoadSequences,
    libMems/MatchList.h:167-203, which loads one gnSequence per file).
    """
    path = os.fspath(path)
    with open(path, "r") as fh:
        head = fh.read(16)
        fh.seek(0)
        if head.startswith("LOCUS") or path.endswith((".gbk", ".gb", ".genbank")):
            records = _parse_genbank_stream(fh)
        else:
            records = _parse_fasta_stream(fh)
    if not records:
        raise ValueError(f"no sequence records in {path}")
    if concatenate and len(records) > 1:
        name = records[0][0]
        seq = np.concatenate([r[1] for r in records])
        records = [(name, seq)]
    return [Genome(name=n, ascii=s, filename=path) for n, s in records]


def read_mfa(path: str | os.PathLike) -> list[Genome]:
    """Load a Multi-FastA file: one Genome per record.

    Equivalent of MatchList::LoadMFASequences (libMems/MatchList.h:371-405).
    """
    genomes = read_fasta(path, concatenate=False)
    for g in genomes:
        g.filename = f"{os.fspath(path)}/{g.name}"
    return genomes


def read_raw(path: str | os.PathLike, name: str = "") -> Genome:
    """Load a raw (headerless) sequence file.

    Equivalent of MatchList::LoadAndCreateRawSequences
    (libMems/MatchList.h:212-258).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    arr = np.frombuffer(data, dtype=np.uint8)
    keep = arr[(arr != ord("\n")) & (arr != ord("\r")) & (arr != ord(" "))]
    return Genome(name=name or os.path.basename(os.fspath(path)),
                  ascii=keep.copy(), filename=os.fspath(path))


def write_fasta(path: str | os.PathLike, genomes: list[Genome], width: int = 80):
    with open(path, "w") as fh:
        for g in genomes:
            fh.write(f">{g.name}\n")
            s = g.to_string()
            for i in range(0, len(s), width):
                fh.write(s[i : i + width] + "\n")
