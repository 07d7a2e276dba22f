"""Where the time goes in the 9 x 1 Mbp progressive path, in the
3 x 1.5 Mbp flat trio, or in the 3 x 8.7 Mbp progressive path, on one GPU.

    python -m libmems_tpu_torch.profile_progressive          # progressive
    python -m libmems_tpu_torch.profile_progressive --trio   # flat trio
    python -m libmems_tpu_torch.profile_progressive --large  # 3 x 8.7 Mbp

Run from the repository root (the genomes come from bench_e2e.py's
``_mutant_family``).  Method: one untimed run on input rng 0 loads every
kernel and shape; then inputs rng 1 and 2, each timed by wall clock with
the stage tracer on (``trace.stage``, device-synchronised), print one JSON
line each: ``progressive_align``, ``apply_backbone`` and ``writers``
seconds and the stage seconds.  Last, input rng 3 runs under
``torch.profiler`` (CPU and CUDA activities); its device time is the sum
of the kernel, memcpy and memset events of the exported Chrome trace
(``key_averages()`` would count an op and its kernels twice), and the
busy share is that sum over the run's wall; the pairwise seeder's
stages (K5, K6, the sort of its cluster words, K7) are cut from the
same trace (``seeder_time``), and so are the seed occurrence lists'
kernels (K16, K17: ``seedocc_time``).  The configuration is the
default ``ProgressiveConfig()``, which refines, so the stage table has
the ``refine/*`` stages; each timed input also prints its banding
outcomes (``ops.profile.BAND_STATS``).  With ``--trio`` each input is
instead ``align`` (gapped, no recursion: bench_e2e.py's trio phase) +
``write_xmfa`` of a 3 x 1.5 Mbp family.  With ``--large`` each input is
the progressive path on a 3 x 8.7 Mbp family (every genome above the host
twin's 8 M-window limit, so the seed occurrence lists come from K16 and
K17); a run being long, the warm-up is one 3 x 1 Mbp family, one input
(rng 0) is timed and the same input is profiled (CUDA activities only).
Prints the card's name
and power limit first.  The trace is written under build/ in the checkout.
"""

from __future__ import annotations

import collections
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

import libmems_tpu_torch as lt
from libmems_tpu_torch import cuda, trace
from libmems_tpu_torch.ops import profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def family(rng_seed: int, n: int = 9, length: int = 1_000_000):
    from bench_e2e import _mutant_family
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [lt.Genome(name=f"g{i}", ascii=lut[g], codes=g)
            for i, g in enumerate(_mutant_family(n, length,
                                                 rng_seed=rng_seed))]


def run(rng_seed: int, dev, n: int = 9, length: int = 1_000_000) -> dict:
    """One input through progressive_align (default config, refine=True),
    apply_backbone and the three writers; returns the walls in seconds."""
    gs = family(rng_seed, n, length)
    cfg = lt.ProgressiveConfig(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivs, _ = lt.progressive_align(gs, cfg)
    t1 = time.perf_counter()
    new_ivs, segs = lt.apply_backbone(ivs, device=dev)
    t2 = time.perf_counter()
    lt.write_xmfa(io.StringIO(), new_ivs)
    lt.write_backbone_seq_coordinates(io.StringIO(), segs, len(gs))
    lt.write_backbone_columns(io.StringIO(), segs)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {"progressive_align": t1 - t0, "apply_backbone": t2 - t1,
            "writers": t3 - t2, "total": t3 - t0}


def run_trio(rng_seed: int, dev) -> dict:
    """One 3 x 1.5 Mbp input through align (gapped, no recursion) and
    write_xmfa; returns the walls in seconds."""
    gs = family(rng_seed, 3, 1_500_000)
    cfg = lt.AlignerConfig(gapped_alignment=True, recursive=False,
                           device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivs, _ = lt.align(gs, cfg)
    t1 = time.perf_counter()
    lt.write_xmfa(io.StringIO(), ivs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"align": t1 - t0, "writers": t2 - t1, "total": t2 - t0}


def device_time(trace_path: str) -> tuple[float, list]:
    """(device milliseconds, [(item, ms, events)] largest first) of the
    kernel, memcpy and memset events of a Chrome trace."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    ms = collections.Counter()
    count = collections.Counter()
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name = e["name"]
        if e["cat"] != "kernel":
            name = e["cat"] + ":" + name.split(" ")[0]
        elif "radix" in name.lower() or "sort" in name.lower():
            name = "torch.sort (cub)"
        name = name[:90]
        ms[name] += e["dur"] / 1e3
        count[name] += 1
    return sum(ms.values()), [(k, round(v, 3), count[k])
                              for k, v in ms.most_common(25)]


def _named(name: str, kernel: str) -> bool:
    """Whether a trace event's name is `kernel` itself (not a kernel
    whose name ends in it, such as mum_tile_flags_kernel for
    tile_flags_kernel)."""
    return re.search(r"(?<!\w)" + kernel + r"\b", name) is not None


def seeder_time(trace_path: str) -> dict:
    """Device milliseconds and events of the pairwise seeder's stages in
    a Chrome trace, cut at its kernels (csrc/pairwise.cu): K5 from
    run_summaries_kernel through run_tile_flags_kernel; K6 from there
    through cluster_words_kernel (its wrapper's own work included); the word
    sort from there to K7's rep_index_kernel; K7 from there up to K2's
    extend_kernel (every scan, host read and decode of the call).  The
    path runs on one stream, so what runs inside a stage's span is the
    stage's."""
    with open(trace_path) as fh:
        events = sorted((e for e in json.load(fh)["traceEvents"]
                         if e.get("cat") in ("kernel", "gpu_memcpy",
                                             "gpu_memset")),
                        key=lambda e: e["ts"])
    ms = collections.Counter()
    count = collections.Counter()
    stage = None
    for e in events:
        name = e["name"]
        if _named(name, "run_summaries_kernel"):
            stage = "K5"
        elif stage == "sort" and _named(name, "rep_index_kernel"):
            stage = "K7"
        elif stage == "K7" and _named(name, "extend_kernel"):
            stage = None
        if stage is None:
            continue
        ms[stage] += e["dur"] / 1e3
        count[stage] += 1
        if stage == "K5" and _named(name, "run_tile_flags_kernel"):
            stage = "K6"
        elif stage == "K6" and _named(name, "cluster_words_kernel"):
            stage = "sort"
    return {"ms": {k: round(v, 4) for k, v in ms.items()},
            "events": dict(count)}


def seedocc_time(trace_path: str) -> dict:
    """Device milliseconds and events of the seed occurrence lists' kernels
    in a Chrome trace: K16 from its first kernel (csrc/seedocc.cu's
    seed_tile_* or seed_run_*) through seed_run_counts_kernel, with
    whatever runs between them on the stream; K17 its
    seed_smooth_kernel."""
    with open(trace_path) as fh:
        events = sorted((e for e in json.load(fh)["traceEvents"]
                         if e.get("cat") in ("kernel", "gpu_memcpy",
                                             "gpu_memset")),
                        key=lambda e: e["ts"])
    ms = collections.Counter()
    count = collections.Counter()
    in_k16 = False
    for e in events:
        name = e["name"]
        if _named(name, "seed_smooth_kernel"):
            stage = "K17"
        elif in_k16 or re.search(r"(?<!\w)seed_(tile|run)_\w*kernel\b",
                                 name):
            stage = "K16"
            in_k16 = not _named(name, "seed_run_counts_kernel")
        else:
            continue
        ms[stage] += e["dur"] / 1e3
        count[stage] += 1
    return {"ms": {k: round(v, 4) for k, v in ms.items()},
            "events": dict(count)}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed")
    dev = torch.device("cuda", 0)
    cuda.library()
    trio = "--trio" in sys.argv[1:]
    large = "--large" in sys.argv[1:]
    run_one = run_trio if trio else run
    timed, profiled = (1, 2), 3
    if large:
        run(0, dev, 3)
        timed, profiled = (0,), 0

        def run_one(seed, dev):
            return run(seed, dev, 3, 8_700_000)
    else:
        run_one(0, dev)
    for seed in timed:
        trace.reset()
        profile.BAND_STATS.update(dict.fromkeys(profile.BAND_STATS, 0))
        with open(os.devnull, "w") as null:
            trace.set_enabled(True, stream=null)
            walls = run_one(seed, dev)
            trace.set_enabled(False)
        print(json.dumps({"rng_seed": seed, **walls,
                          "band_stats": dict(profile.BAND_STATS),
                          "stages": trace.stage_seconds()}), flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    if large:
        acts = acts[1:]     # minutes of host events would swamp the trace
    with torch.profiler.profile(activities=acts) as prof:
        walls = run_one(profiled, dev)
    out_dir = os.path.join(ROOT, "build", "profile_progressive")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        "trace_trio.json" if trio else
                        "trace_large.json" if large else "trace.json")
    prof.export_chrome_trace(path)
    busy, top = device_time(path)
    wall_ms = walls["total"] * 1e3
    print(json.dumps({"rng_seed": profiled, "profiled_wall_ms": wall_ms,
                      "device_busy_ms": busy, "busy_share": busy / wall_ms,
                      "top": top, "seeder": seeder_time(path),
                      "seed_occurrence": seedocc_time(path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
