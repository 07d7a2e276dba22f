"""ctypes bridge to the native out-of-core SML builder (dmSML analog).

Port of libmems_tpu/native.py.  Builds the same ``native/dmsml.cpp`` with
g++ at first use (the toolchain is part of the deployment image; there
is no pip dependency), into this package's own build directory,
``build/libmems_tpu_torch/native/<source hash>/libdmsml.so`` beside the
package: the JAX bridge builds ``native/libdmsml.so``, and two packages'
processes must never race on one file.  The library is compiled under a
temporary name and renamed into place, so concurrent builders are safe.
Exposes:

* ``native_keys(codes, seed)``: C canonical-key extraction (uint64), a
  bit-parity oracle against the K1 and numpy key pipelines;
* ``create_file_sml(genome, seed, out_path, ...)``: the FileSML::dmCreate
  path (FileSML.cpp:278-314): stream the genome once, write the
  position-order keys, distribution-sort (key, pos) records through
  scratch bins, and emit an SMLT0001 file that SortedMerList.load reads.

Host code only: no device is involved.  When the shared library cannot
be built (no compiler), ``available()`` is False and
SortedMerList.create_big takes its Python split-sort-merge instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from libmems_tpu_torch import seeds as seedlib
from libmems_tpu_torch.sequence import Genome

_REPO_ROOT = Path(__file__).resolve().parent.parent
_SRC = _REPO_ROOT / "native" / "dmsml.cpp"
BUILD_ROOT = _REPO_ROOT / "build" / "libmems_tpu_torch" / "native"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_LIB_NAME = "libdmsml.so"

_lib = None
_lib_err: str | None = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / _LIB_NAME


def _build(final: Path) -> None:
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=final.parent))
    try:
        out = tmp / _LIB_NAME
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(out)],
                       check=True, capture_output=True)
        os.replace(out, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        path = _lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.dmsml_keys.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)]
        lib.dmsml_keys.restype = None
        lib.dmsml_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int]
        lib.dmsml_create.restype = ctypes.c_int
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        _lib_err = str(e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def native_keys(codes: np.ndarray, seed: int) -> np.ndarray:
    """Canonical seed keys via the C implementation (uint64; a window
    over a code above 3 gets the u64 all-ones sentinel)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_lib_err}")
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    windows = max(n - seedlib.seed_length(seed) + 1, 0)
    out = np.zeros(windows, dtype=np.uint64)
    if windows:
        lib.dmsml_keys(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_uint64(n), ctypes.c_uint64(seed),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def create_file_sml(genome_or_codes, seed: int, out_path: str,
                    scratch_dir: str | None = None,
                    mem_limit: int = 256 << 20,
                    circular: bool = False) -> str:
    """Build an SMLT0001 file out-of-core (dmSML / FileSML::dmCreate
    equivalent).  Returns out_path; load with SortedMerList.load()."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_lib_err}")
    if isinstance(genome_or_codes, Genome):
        codes = genome_or_codes.codes
        if genome_or_codes.ambig.any():
            # positions with ambiguous bases carry byte 0xFF in the
            # streamed codes file; the native sorter sentinel-keys every
            # window overlapping one (maskNNNNN, libMems/FileSML.h:135)
            codes = np.where(genome_or_codes.ambig,
                             np.uint8(0xFF), codes)
    else:
        codes = np.asarray(genome_or_codes, dtype=np.uint8)
    if scratch_dir is None:
        scratch_dir = os.path.dirname(os.path.abspath(out_path)) or "."
    with tempfile.NamedTemporaryFile(dir=scratch_dir, suffix=".codes",
                                     delete=False) as tf:
        codes_path = tf.name
        np.ascontiguousarray(codes, dtype=np.uint8).tofile(tf)
    try:
        rc = lib.dmsml_create(
            codes_path.encode(), os.fspath(out_path).encode(),
            os.fspath(scratch_dir).encode(), ctypes.c_uint64(seed),
            ctypes.c_uint64(mem_limit), ctypes.c_int(int(circular)))
        if rc != 0:
            raise RuntimeError(f"dmsml_create failed with code {rc}")
    finally:
        os.unlink(codes_path)
    return os.fspath(out_path)
