"""Stage timing and progress reporting (port of libmems_tpu/trace.py).

* ``stage(name)`` — context manager timing one pipeline stage; nested
  stages form a tree in a global registry that ``stage_seconds()``
  flattens.  When tracing is on, a stage synchronises
  the CUDA device at both ends (if CUDA is in use), so its time includes
  the device work it enqueued; when tracing is off it does nothing.
* ``progress(name, done, total)`` — throttled percent progress lines.

Disabled by default: enable with ``set_enabled(True)`` or the
LIBMEMS_TPU_TRACE=1 environment variable.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

import torch

_enabled = os.environ.get("LIBMEMS_TPU_TRACE", "") == "1"
_stream = sys.stderr


@dataclass
class StageRecord:
    name: str
    seconds: float = 0.0
    calls: int = 0
    children: dict = field(default_factory=dict)


_root = StageRecord("root")
_stack: list[StageRecord] = [_root]
_last_progress: dict[str, float] = {}


def set_enabled(on: bool, stream=None):
    global _enabled, _stream
    _enabled = on
    if stream is not None:
        _stream = stream


def reset():
    global _root, _stack
    _root = StageRecord("root")
    _stack = [_root]
    _last_progress.clear()


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage (SML build, MUM find, GBE, ...)."""
    if not _enabled:
        yield
        return
    parent = _stack[-1]
    rec = parent.children.setdefault(name, StageRecord(name))
    _stack.append(rec)
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        dt = time.perf_counter() - t0
        rec.seconds += dt
        rec.calls += 1
        _stack.pop()
        print(f"[libmems_tpu_torch] {name}: {dt:.3f}s", file=_stream,
              flush=True)


def progress(name: str, done: int, total: int, min_interval: float = 1.0):
    """Throttled percent progress (MatchFinder::LogProgress analog)."""
    if not _enabled or total <= 0:
        return
    now = time.monotonic()
    last = _last_progress.get(name, 0.0)
    if now - last < min_interval and done < total:
        return
    _last_progress[name] = now
    print(f"[libmems_tpu_torch] {name}: {100.0 * done / total:.0f}%",
          file=_stream, flush=True)


def stage_seconds(rec: StageRecord | None = None, prefix: str = ""
                  ) -> dict:
    """Flat {stage/path: seconds} view of the collected tree."""
    rec = rec or _root
    out = {}
    for child in rec.children.values():
        path = f"{prefix}{child.name}"
        out[path] = child.seconds
        out.update(stage_seconds(child, path + "/"))
    return out
