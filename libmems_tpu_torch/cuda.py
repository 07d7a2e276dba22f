"""Device selection and the hand-written CUDA kernels' build and binding.

The kernels of the port (``csrc/*.cu``) are compiled by ``nvcc``
into ONE shared library with a plain C interface and loaded with
``ctypes``: no PyTorch header is compiled, so a cold build takes
seconds.  The library is built at first use, from the sources in this
package only, into ``build/libmems_tpu_torch/<hash>/`` beside the
package; the hash covers the sources and the compiler flags, so a
changed source builds a new library and an unchanged one is reused.

Every C entry point takes device pointers and the CUDA stream as
``void*``, sizes as ``int``/``int64_t``, launches on that stream without
synchronising, and returns ``cudaGetLastError()``; ``check`` raises when
it is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import inspect
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "libmems_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB_NAME = "liblmkernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C signatures of csrc/*.cu (extern "C"); the launchers return cudaError_t
_SIGNATURES = {
    "lm_seed_keys": ([_P, _P, _L, _P, _L, _P, _P], _I),
    "lm_extend_row_bytes": ([_I], _L),
    "lm_extend_smem_limit": ([], _L),
    "lm_extend_warp_genomes": ([], _I),
    "lm_extend": ([_P, _L, _L, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                   _P, _P], _I),
    "lm_profile_row_bytes": ([_I], _L),
    "lm_profile_cum_scratch": ([_I], _L),
    "lm_profile_scratch_bytes": ([_I] * 4, _L),
    "lm_profile_fwd": ([_P] * 7 + [_I] * 4 + [_F, _F, _P, _I, _P, _P], _I),
    "lm_profile_geometry": ([_I] * 5 + [_P], _I),
    "lm_span_scratch_bytes": ([_I] * 7, _L),
    "lm_span_fits": ([_I, _P], _I),
    "lm_profile_ckpt": ([_P] * 8 + [_I] * 4 + [_F, _F, _P, _I, _I, _P], _I),
    "lm_profile_block_ptrs": ([_P] * 7 + [_I] * 6 + [_F, _F, _P, _I, _I,
                                                     _P], _I),
    "lm_traceback": ([_P, _P, _P] + [_I] * 5 + [_P] * 3 + [_I, _P], _I),
    "lm_traceback_geometry": ([_I] * 4 + [_P], _I),
    "lm_banded_fwd": ([_P] * 7 + [_L] + [_P] * 5 + [_I] * 4
                      + [_F, _F, _P, _I, _P], _I),
    "lm_banded_geometry": ([_I] * 4 + [_P], _I),
    "lm_banded_walk": ([_P] * 3 + [_I] * 6 + [_P] * 3 + [_I, _P], _I),
    "lm_banded_walk_geometry": ([_I] * 4 + [_P], _I),
    "lm_run_scratch_words": ([_L], _L),
    "lm_run_summaries": ([_P, _P, _P, _I, _L, _I, _I, _P, _P], _I),
    "lm_run_tile_flags": ([_P] * 4 + [_I, _L, _L, _L] + [_P] * 7, _I),
    "lm_scan_scratch_words": ([_L], _L),
    "lm_compact_kept": ([_P] * 5 + [_L, _I, _I, _P, _P, _P], _I),
    "lm_cluster_words": ([_P, _L, _I, _I, _I, _I, _P, _P], _I),
    "lm_rep_index": ([_P, _L, _I, _I, _P, _P, _P], _I),
    "lm_reps": ([_P, _P, _P, _L, _L, _I, _I, _I, _I] + [_P] * 11, _I),
    "lm_mum_tile_flags": ([_P] * 3 + [_I, _P, _I, _L, _I, _L, _L]
                          + [_P] * 8, _I),
    "lm_mum_candidates": ([_P] * 6 + [_L, _I, _L, _L, _I, _I] + [_P] * 4,
                          _I),
    "lm_mum_rep_index": ([_P, _P, _L, _I, _I, _I, _P, _P, _P], _I),
    "lm_mum_decode_reps": ([_P] * 3 + [_L, _L, _L, _I, _I] + [_P] * 4, _I),
    "lm_seed_tile_edges": ([_P, _L, _L, _P, _P], _I),
    "lm_seed_run_counts": ([_P] * 3 + [_L] * 4 + [_P, _P], _I),
    "lm_seed_smooth": ([_P, _L, _I, _P, _P], _I),
    "lm_pair_pack": ([_P, _L, _P, _L, _I, _P, _P], _I),
    "lm_pair_cluster_words": ([_P, _L, _I, _L, _P, _P, _P], _I),
    "lm_pair_rep_index": ([_P, _L, _I, _I, _P, _P, _P], _I),
    "lm_pair_reps": ([_P] * 3 + [_L, _L, _I, _I] + [_P] * 5, _I),
    "lm_hmm_scan_doubles": ([_I, _I, _I], _L),
    "lm_hmm_fb": ([_P, _P, _I, _I, _P, ctypes.c_double] + [_P] * 5, _I),
    "lm_hmm_fb_rows": ([_P, _P, _P, _I, _L, _P, ctypes.c_double] + [_P] * 5,
                       _I),
    "lm_hmm_step_cycles": ([_P, _I, _L, _P, _P, _P, _P], _I),
    "lm_hmm_viterbi_rows": ([_P, _P, _P, _I, _L] + [_P] * 4, _I),
    "lm_hmm_viterbi_step_cycles": ([_P, _I] + [_P] * 5, _I),
    "lm_hmm_bw": ([_P, _P, _I, _I, _P] + [_P] * 5, _I),
    "lm_gotoh_scratch_bytes": ([_I] * 6, _L),
    "lm_gotoh_fits": ([_I, _P], _I),
    "lm_gotoh_fwd": ([_P, _P, _P, _P] + [_I] * 8 + [_P] * 9 + [_I, _I, _P],
                     _I),
    "lm_gotoh_block_ptrs": ([_P, _P] + [_I] * 8 + [_P] * 4
                            + [_I, _I, _P, _I, _P, _L, _P, _I, _I, _P], _I),
    "lm_route_buckets": ([_P, _L, _L, _I, _I, _P, _P, _P], _I),
    "lm_route_fill": ([_P] * 4 + [_L, _L, _I, _L] + [_P] * 4, _I),
    "lm_shard_candidates": ([_P] * 6 + [_L, _L, _I] + [_P] * 5, _I),
    "lm_dedup_starts": ([_P] * 3 + [_L, _I, _P, _P], _I),
    "lm_dedup_flags": ([_P] * 4 + [_L, _I] + [_P] * 4, _I),
    "lm_tiled_request_scratch_words": ([_L, _I], _L),
    "lm_tiled_requests": ([_P, _L, _I] + [_P] * 5 + [_I, _I, _I, _L, _L, _I,
                                                      _L, _L] + [_P] * 5,
                          _I),
    "lm_tiled_serve": ([_P, _L, _P, _L, _I, _L, _P, _P], _I),
    "lm_tiled_probe_row_bytes": ([_I], _L),
    "lm_tiled_probe_smem_limit": ([], _L),
    "lm_tiled_probe": ([_P, _P, _P, _P, _L, _I] + [_P] * 6 + [_I, _I, _I,
                                                             _L, _P], _I),
    "lm_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # this process's build wall time
build_log_path: Path | None = None   # nvcc/ptxas output of the build


def resolve_device(device) -> torch.device:
    """The explicit device a run uses.  ``cuda`` without a usable GPU
    raises: nothing carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           "available")
    return dev


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the libmems_tpu_torch kernels")


def _build(out_dir: Path) -> Path:
    """Compile every csrc/*.cu in parallel, link one shared library, and
    move it into out_dir atomically (concurrent builders are safe)."""
    global build_seconds, build_log_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir.parent))
    try:
        procs = []
        for src in sorted(_CSRC.glob("*.cu")):
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for cmd, _, proc in procs:
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(cmd[-3])
        lib_tmp = tmp / _LIB_NAME
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(lib_tmp),
                   *[str(o) for _, o, _ in procs]]
            res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            log.append(" ".join(cmd) + "\n" + res.stdout)
            if res.returncode != 0:
                failed.append("link")
        log_path = out_dir / "build.log"
        log_path.write_text("\n".join(log))
        build_log_path = log_path
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}; see {log_path}:\n"
                               + "\n".join(log)[-4000:])
        final = out_dir / _LIB_NAME
        os.replace(lib_tmp, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return final


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / _source_hash()
            path = out_dir / _LIB_NAME
            if not path.exists():
                path = _build(out_dir)
            lib = ctypes.CDLL(str(path))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if status != 0:
        msg = library().lm_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on(device: torch.device):
    """Make `device` the current CUDA device for a block of launches: a
    launcher runs on the current device, and a stream of another card is
    refused there.  A no-op for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _first_device(args) -> torch.device | None:
    """The device of the first tensor among args, looking one level into
    tuples (the NamedTuples of flags the table kernels take)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, tuple):
            for x in a:
                if isinstance(x, torch.Tensor):
                    return x.device
    return None


def launcher(fn):
    """Decorator of a kernel wrapper: run it with the card of its first
    tensor argument current, so its launches, its stream and its queries
    of the card's limits all belong to that card, whichever card the
    caller left current.  Costs nothing for CPU tensors or where the card
    is already current."""
    @functools.wraps(fn)
    def run(*args, **kw):
        dev = _first_device(args)
        with on(dev) if dev is not None else contextlib.nullcontext():
            return fn(*args, **kw)
    return run


def entry(pick):
    """Decorator of a public entry point: run it with the device that
    pick(arguments) names current (arguments bound by name, defaults
    applied).  A CPU device, or a CUDA device where CUDA is absent (the
    entry point then raises as it would), changes nothing."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def run(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            dev = torch.device(pick(bound.arguments))
            if dev.type != "cuda" or not torch.cuda.is_available():
                return fn(*args, **kw)
            with on(dev):
                return fn(*args, **kw)
        return run
    return wrap


def device_arg(arguments):
    """entry()'s pick for a function with a `device` argument."""
    return arguments["device"]


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, shape: tuple | None = None) -> None:
    """Validate a kernel argument: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
