#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (libmems_tpu_torch) on one GPU.

    python3 chip_smoke.py [phase ...]

With no argument every phase runs; naming phases (kernels, goldens, main,
trio, progressive, large, profile_dp, decode, bounded, mesh, tiled,
multihost, cards) runs only those, plus the progressive run whose
recorded inputs profile_dp and decode read (and the main, trio and
progressive runs whose outputs mesh and cards are held to, the main run
for tiled and multihost).  Needs one NVIDIA Hopper GPU (compute capability 9.0) and the CUDA
toolkit's nvcc; builds the port's kernels from libmems_tpu_torch/csrc at
first use.  Phases, each raising on failure (the script then exits
non-zero and prints no result line):

1. device  - CUDA present, capability (9, 0); card name and power limit;
2. build   - compile the kernel library, report its build seconds;
3. kernels - each hand kernel against its plain PyTorch version on the
             card at its path's shapes (K1-K4, K18 and K19 the pair's,
             K5-K7 the 9 x 1 Mbp seeder's, K13-K15 and K2 the first
             trio's, K16 and K17 one 8.7 Mbp genome's; exact equality),
             with timings; K1, K2, K18 and K19 once more at the 8.7 Mbp
             family's weight-17 seed, K16 and K17 once more on a 1 Mbp
             genome beside the host twin's seconds;
4. goldens - the port on the GPU reproduces tests/golden/pair.mums,
             three.mums, pair.xmfa and nine.{xmfa,bbseq,bbcols} byte for
             byte; find_mums on the nine-genome family (G = 9) and that
             family with refine=True give the same MUMs and XMFA bytes on
             the GPU as on CPU tensors (which the CPU tests hold to the
             JAX package); the host-orchestrated pairwise seeder on the
             nine family equals the fused one, both on the GPU;
5. main    - align() of a 2 x 4.6 Mbp pair with gapped alignment on the
             GPU: every kernel of the pair path (K1-K4, K18, K19)
             launched, MUMs equal to
             the numpy twin, intervals partition both genomes; then a
             second pair;
5b. trio   - align() + write_xmfa of two 3 x 1.5 Mbp families (rng 0,
             then 1; gapped, no recursion), the flat N-way path: K1, K2,
             K13-K15, K3 and K4 launched (K11/K12 printed), find_mums on
             the GPU equal to the same call on CPU tensors, intervals
             partition every genome, stage seconds printed;
6. progressive - progressive_align with the default config (refine=True)
             + apply_backbone + the three writers on two 9 x 1 Mbp
             families: every kernel K1-K12 launched, the pairwise MUMs
             equal the same call on CPU tensors, intervals partition
             every genome, backbone segments lie inside their intervals,
             stage seconds (refine/* among them) and banding outcomes
             printed;
6b. large  - the same path on one 3 x 8.7 Mbp family (weight-17 seed,
             26.1 M seed windows, every genome above the host twin's
             8 M-window limit): K16 and K17 launched three times each,
             K1, K2 and K5-K7 launched, each genome's seed occurrence
             list bit-equal to the host twin, intervals partition every
             genome, backbone segments inside their intervals, stage
             seconds printed; its predict_homologous calls recorded and
             K8 launched;
7. profile DP - K3, K4 and K9-K12 against their plain versions on the
             profile-DP launches of the first progressive run: the node
             merges' and the refinement's align_profile_batch calls
             (banded K11 + K12 first in 1024+ buckets, uncertified windows
             through K3 + K4) and the refine gate's profile_scores_batch
             calls (banded K10, uncertified and small-bucket windows
             through K9); exact equality (scores bit for bit,
             certificates, pointer bytes, masks).  Where that run left K9
             no launch or no uncertified window, tests/test_banded.py's
             adversarial windows run the same routes as well;
8. hmm     - K8 against its plain version on the card on the HMM batches
             of the first progressive run and of phase 6b, at their full
             lengths (posteriors within 1e-12, calls equal), timed; the
             batches of padded width 2^17 and more (the chunked route)
             once more through the sequential kernel that serves the
             narrower ones: its time, the largest posterior difference,
             the calls that differ (7 and 8 are the phase "profile_dp");
9. decode  - decode and pairwise DP, the API no path calls: align_pairs
             on the pair path's inter-anchor windows (K23 + K4 on the
             card) and on 8 mutant pairs of 10 kbp (over the pointer
             budget: K22, packed K23 blocks, the host walk),
             viterbi_homologous (K20) on the first progressive run's HMM
             sequences and 2 iterations of baum_welch (K21) on them; K22,
             K23 and K20 exact against their plain versions, K21 within
             1e-12, the walked masks scoring to the DP score; K2 at 64 and
             1,000 slots a row, in shared memory and global scratch
             (find_mums on 64 genomes GPU == CPU tensors, find_repeats on a
             1,000-copy element family);
10. bounded - the memory-bounded routes: K24 and K25 exact against their
             plain versions on 2 windows of about 2,300 columns (one-hot,
             3+2 rows); align + write_xmfa of the 2 x 4.6 Mbp pair with a
             34 kbp swapped locus at max_gapped_window 40,000: its
             34,003 x 34,000 window takes the checkpointed route (K24,
             K25, the host walk), and the XMFA equals the same input's
             with PTR_BUDGET raised here (K3 + K4, 1.44 GiB of pointers);
             genome a's SML saved, loaded memory-mapped and built by
             create_big (native, 64 MB) byte-equal; find_mums_checkpointed
             (8 ranges) stopped after range 3 and resumed == find_mums,
             with an uninterrupted run's file bytes; all within 90 s; then
             K24 and K25, kernel and plain, on the counted launches;
11. mesh   - the seed-prefix-sharded path with 4 shards on the card:
             K26-K28 exact against their plain versions at the pair's
             shapes (every shard's slice routed with route_cap slots a
             destination, shard 0's candidate rows and dedup), timed;
             align of the rng-0 pair (gapped, no recursion) and trio with
             AlignerConfig(mesh=...) and progressive_align(mesh=...) of the
             rng-0 9 x 1 Mbp family (refine=True) + apply_backbone + the
             writers: seeding matches, MUMs and output bytes equal phases
             5, 5b and 6, shard loads and retries printed; phase 6's
             align_profile_batch calls split over 2 shards equal whole;
             K26's launches equal the non-empty slices of each pass;
             all within 150 s;
12. tiled  - the position-tiled extension with 4 shards on the card:
             K29-K31 exact against their plain versions at the pair's
             first fetch, timed; sharded_find_mums_tiled of the rng-0
             pair equals phase main's find_mums (K26-K31 launched; probe
             rounds, fetches, each shard's S + halo resident keys against
             the replicated table, the memory peak printed); within 90 s;
13. multihost - one NCCL rank a card, spawned after the build (one card:
             one process, a 4-shard mesh of its card), runs
             multihost_find_mums (default, pairwise, tiled) and
             multihost_align on the rng-0 pair; every rank's MUMs and XMFA
             equal the single-process runs; within 90 s;
14. cards  - with two or more cards (skipped with one): the pair's
             sharded_find_mums over every card (make_mesh) against as many
             shards on one card, in turns, equal matches; the exchange's
             bytes and walls on both; align over the cards == unsharded;
             with phase 6 run too, its align_profile_batch calls whole on
             one card against the default split over the cards, in turns;
             align with device="cuda:1" while card 0 is current equals
             phase main's XMFA; one NCCL rank a card on the pair (three
             seeding modes, align, the route exchange timed), the trio
             (align) and the 9 x 1 Mbp family (progressive_align,
             backbone, writers), byte-equal to phases 5, 5b and 6.

The inputs of phases 7-9 are recorded one layer above the kernel
wrappers (align_profile_batch, profile_scores_batch, predict_homologous,
the callers' extend_matches) and rebuilt into launches by the path's own
planners.  Counts of kernel launches are set to 0 just before each main
path and read just after; the kernel table reports the trio path's
counts for K13-K15, the pair path's for K18 and K19, the 3 x 8.7 Mbp
path's for K16 and K17, the decode run's for K20-K23, the bounded
path's for K24 and K25, the meshed pair's for K26-K28, the tiled pair's
for K29-K31 and the 9 x 1 Mbp
progressive path's for the rest, and the times of K3, K4 and K8-K12 are
taken on that path's inputs.  Each kernel's bound_ms is max(bytes /
3.35 TB/s, operations / peak rate) for the work of those inputs (the
counts are in work_* below).
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}} when every phase ran, and {"ok": true,
"phases": [...]} when only the named ones did.  Logs go to
chiprun_out/chip_smoke/.
Imports neither JAX nor libmems_tpu.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
PAIR_LEN = 4_600_000
PROG_GENOMES, PROG_LEN = 9, 1_000_000
TRIO_LEN = 1_500_000
LARGE_GENOMES, LARGE_LEN = 3, 8_700_000
MUM_KERNELS = ("mum_seed_flags", "mum_candidates", "mum_reps")
PAIR_KERNELS = ("pair_cluster_words", "pair_reps")
SEEDOCC_KERNELS = ("seed_run_counts", "seed_smooth")
SOURCES = {
    "canonical_seed_keys": ("libmems_tpu_torch/csrc/mers.cu",
                            "libmems_tpu/ops/mers.py:75"),
    "extend_matches": ("libmems_tpu_torch/csrc/extend.cu",
                       "libmems_tpu/ops/extend.py:91"),
    "profile_forward": ("libmems_tpu_torch/csrc/profile.cu",
                        "libmems_tpu/ops/profile.py:215"),
    "traceback_walk": ("libmems_tpu_torch/csrc/gapped.cu",
                       "libmems_tpu/ops/gapped.py:213"),
    "run_flags": ("libmems_tpu_torch/csrc/pairwise.cu",
                  "libmems_tpu/matchfind.py:99"),
    "cluster_words": ("libmems_tpu_torch/csrc/pairwise.cu",
                      "libmems_tpu/matchfind.py:1096"),
    "cluster_reps": ("libmems_tpu_torch/csrc/pairwise.cu",
                     "libmems_tpu/matchfind.py:1096"),
    "fb_posterior": ("libmems_tpu_torch/csrc/hmm.cu",
                     "libmems_tpu/ops/hmm.py:139"),
    "profile_forward_scores": ("libmems_tpu_torch/csrc/profile.cu",
                               "libmems_tpu/ops/profile.py:116"),
    "banded_forward_scores": ("libmems_tpu_torch/csrc/banded.cu",
                              "libmems_tpu/ops/profile.py:411"),
    "banded_forward_ptrs": ("libmems_tpu_torch/csrc/banded.cu",
                            "libmems_tpu/ops/profile.py:306"),
    "banded_traceback_walk": ("libmems_tpu_torch/csrc/banded.cu",
                              "libmems_tpu/ops/profile.py:422"),
    "mum_seed_flags": ("libmems_tpu_torch/csrc/mums.cu",
                       "libmems_tpu/matchfind.py:68"),
    "mum_candidates": ("libmems_tpu_torch/csrc/mums.cu",
                       "libmems_tpu/matchfind.py:336"),
    "mum_reps": ("libmems_tpu_torch/csrc/mums.cu",
                 "libmems_tpu/matchfind.py:336"),
    "seed_run_counts": ("libmems_tpu_torch/csrc/seedocc.cu",
                        "libmems_tpu/anchorscore.py:37"),
    "seed_smooth": ("libmems_tpu_torch/csrc/seedocc.cu",
                    "libmems_tpu/anchorscore.py:37"),
    "pair_cluster_words": ("libmems_tpu_torch/csrc/pair.cu",
                           "libmems_tpu/matchfind.py:482"),
    "pair_reps": ("libmems_tpu_torch/csrc/pair.cu",
                  "libmems_tpu/matchfind.py:482"),
    "gotoh_forward": ("libmems_tpu_torch/csrc/gotoh.cu",
                      "libmems_tpu/ops/gapped.py:151"),
    "gotoh_block_ptrs": ("libmems_tpu_torch/csrc/gotoh.cu",
                         "libmems_tpu/ops/gapped.py:178"),
    "viterbi_path": ("libmems_tpu_torch/csrc/hmm.cu",
                     "libmems_tpu/ops/hmm.py:531"),
    "bw_counts": ("libmems_tpu_torch/csrc/hmm.cu",
                  "libmems_tpu/ops/hmm.py:603"),
    "profile_forward_ckpt": ("libmems_tpu_torch/csrc/profile.cu",
                             "libmems_tpu/ops/profile.py:116"),
    "profile_block_ptrs": ("libmems_tpu_torch/csrc/profile.cu",
                           "libmems_tpu/ops/profile.py:142"),
    "route_fill": ("libmems_tpu_torch/csrc/shard.cu",
                   "libmems_tpu/parallel/shard.py:208"),
    "shard_candidates": ("libmems_tpu_torch/csrc/shard.cu",
                         "libmems_tpu/parallel/shard.py:310"),
    "dedup_flags": ("libmems_tpu_torch/csrc/shard.cu",
                    "libmems_tpu/parallel/shard.py:310"),
    "tiled_requests": ("libmems_tpu_torch/csrc/tiled.cu",
                       "libmems_tpu/parallel/shard.py:538"),
    "tiled_serve": ("libmems_tpu_torch/csrc/tiled.cu",
                    "libmems_tpu/ops/extend.py:66"),
    "tiled_probe": ("libmems_tpu_torch/csrc/tiled.cu",
                    "libmems_tpu/ops/extend.py:210"),
}
# peak rates of one H100 SXM (NVIDIA's H100 SXM data sheet; f64 outside
# the tensor cores).  Integer
# kernels count their 32/64-bit integer operations at the f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
DP_CELL_OPS = 20      # per profile-DP cell: 9 for the row score (a
                      # product and four FMAs), 11 adds and maxes
WALK_STEP_BYTES = 4   # per traceback step: one pointer byte, three masks
HMM_COLUMN_OPS = 60   # per HMM column: two passes of 2-state log-sum-exps
GOTOH_CELL_OPS = 3    # per pairwise DP cell (K22): F, the diagonal, g
GOTOH_PTR_CELL_OPS = 5  # K23: the same and the pointer byte's compares
VITERBI_COLUMN_OPS = 10  # per column (K20): 4 adds, 2 compares, 2 selects,
                         # a step of the walk
BW_COLUMN_OPS = 100   # per column (K21): K8's two passes, 6 exps and the
                      # count sums
DECODE_KERNELS = ("gotoh_forward", "gotoh_block_ptrs", "viterbi_path",
                  "bw_counts")
MUTANT_PAIRS, MUTANT_PAIR_LEN = 8, 10_000
REPEAT_LEN, REPEAT_COPIES, REPEAT_ELEM = 2_000_000, 1_000, 500
WIDE_GENOMES, WIDE_LEN = 64, 20_000
HMM_CHECK_MAX_T = 1 << 14   # K20/K21 vs plain: these batches + the longest
# the bounded phase: genome b of the pair with a swapped locus, one window
# over the pointer budget, K24/K25 vs plain on windows of about 2,300
SWAP_AT, SWAP_LEN, SWAP_WINDOW = 2_000_000, 34_000, 40_000
CKPT_CHECK_N, CKPT_CHECK_MP = 2_300, 2_304
CKPT_CHUNKS, CKPT_STOP = 8, 3     # the resumable search's ranges, its stop
BOUNDED_CAP_S = 90.0
BOUNDED_KERNELS = ("profile_forward_ckpt", "profile_block_ptrs")
# the mesh phase: shards on one card, its time cap
MESH_SHARDS, MESH_CAP_S = 4, 150.0
MESH_KERNELS = ("route_fill", "shard_candidates", "dedup_flags")
# the tiled phase (4 shards on one card) and the multi-process phase (one
# NCCL rank a card), their time caps; the cards phase's ranks' cap
TILED_CAP_S, MULTIHOST_CAP_S, CARDS_RANKS_CAP_S = 90.0, 90.0, 300.0
TILED_KERNELS = ("tiled_requests", "tiled_serve", "tiled_probe")
PHASES = ("kernels", "goldens", "main", "trio", "progressive", "large",
          "profile_dp", "decode", "bounded", "mesh", "tiled", "multihost",
          "cards")


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def timed_ms(fn, reps, torch, warmup=True):
    """Median milliseconds of fn() over reps runs, timed with CUDA
    events; one untimed warm-up run first unless warmup is False."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_once(fn, torch):
    """(fn(), milliseconds of that one run), timed with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def recording(targets):
    """Patch each (module, name) so that every call's arguments, bound to
    their parameter names with defaults applied, are recorded and the
    call goes on unchanged.  Yields {name: [arguments, ...]}."""
    logs, saved = {}, []
    for mod, name in targets:
        fn = getattr(mod, name)
        calls = logs.setdefault(name, [])

        def rec(*args, _fn=fn, _calls=calls, **kw):
            bound = inspect.signature(_fn).bind(*args, **kw)
            bound.apply_defaults()
            _calls.append(dict(bound.arguments))
            return _fn(*args, **kw)
        saved.append((mod, name, fn))
        setattr(mod, name, rec)
    try:
        yield logs
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def nbytes(*xs):
    """Bytes of every tensor in xs (tensors, tuples, named tuples)."""
    total = 0
    for x in xs:
        if isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif hasattr(x, "element_size"):
            total += x.numel() * x.element_size()
    return total


def work(bytes_, ops, rate=F32_OPS_PER_S):
    return {"bytes": int(bytes_), "ops": int(ops), "rate": rate}


def bound(w):
    """(bound_ms, bound_by) of a work count: the larger of its bytes over
    the memory rate and its operations over the peak rate."""
    t_b = w["bytes"] / HBM_BYTES_PER_S
    t_o = w["ops"] / w["rate"]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def entry(err, ms, plain_ms, w):
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "work": w}


def sum_work(ws):
    ws = list(ws)
    return work(sum(w["bytes"] for w in ws), sum(w["ops"] for w in ws))


def _lens(t):
    return (t[2].cpu().numpy().astype(np.int64),
            t[3].cpu().numpy().astype(np.int64))


def band_cells(t, H_W):
    """DP cells the banded forward computes for a packed batch t: rows
    1..p_len, local columns 0..clip(q_len - lo, 0, WB) of each block."""
    from libmems_tpu_torch.ops import profile
    N = t[1].shape[1]
    WB = profile.band_width(H_W)
    pl, ql = _lens(t)
    plc = np.maximum(pl, 1)
    total = 0
    for bi in range(-(-int(pl.max(initial=0)) // profile.BAND_K)):
        rows = np.clip(pl - bi * profile.BAND_K, 0, profile.BAND_K)
        lo = np.clip((bi * profile.BAND_K * ql) // plc - (H_W + 1), 0,
                     max(N - WB, 0))
        total += int((rows * (np.clip(ql - lo, 0, WB) + 1)).sum())
    return total


def dp_work(name, t, H_W=None):
    """Work of one profile-DP launch on the packed batch t: the profile
    rows it reads (20 bytes a row and column), the lengths, its outputs
    (pointer bytes of the computed cells, scores, certificates; the
    banded forward also reads the sorted gap costs) and DP_CELL_OPS a
    cell."""
    pl, ql = _lens(t)
    B = len(pl)
    io = int(((pl + ql) * 20).sum()) + 8 * B
    if name in ("profile_forward", "profile_forward_scores"):
        cells = int((pl * (ql + 1)).sum())
        out = 4 * B + (cells if name == "profile_forward" else 0)
    else:
        cells = band_cells(t, H_W)
        io += 4 * B * (t[0].shape[1] + t[1].shape[1])
        out = 5 * B + (cells if name == "banded_forward_ptrs" else 0)
    return work(io + out, DP_CELL_OPS * cells)


def walk_work(masks):
    """Work of one traceback walk: the steps it took (masks[0])."""
    steps = int(masks[0].sum())
    return work(WALK_STEP_BYTES * steps + 8 * masks[0].shape[1], 10 * steps)


def max_abs_err(pairs):
    """Largest |kernel - plain| over the compared tensors."""
    err = 0.0
    for a, b in pairs:
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def genome_pair(lt, rng_seed):
    """The 2 x 4.6 Mbp synthetic pair of bench.py (1% substitutions,
    0.05% indels)."""
    from bench import _synthetic_pair
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    a, b = _synthetic_pair(PAIR_LEN, rng_seed=rng_seed)
    return [lt.Genome(name="A", ascii=lut[a], codes=a),
            lt.Genome(name="B", ascii=lut[b], codes=b)]


def _family(lt, n_genomes, length, rng_seed):
    """A bench_e2e.py mutant family (star phylogeny, 1% substitutions,
    indels, two rearrangements per genome) as the port's Genomes."""
    from bench_e2e import _mutant_family
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    fam = _mutant_family(n_genomes, length, rng_seed=rng_seed)
    return [lt.Genome(name=f"g{i}", ascii=lut[g], codes=g)
            for i, g in enumerate(fam)]


def family_nine(lt, rng_seed):
    """bench_e2e.py's 9 x 1 Mbp progressive family."""
    return _family(lt, PROG_GENOMES, PROG_LEN, rng_seed)


def family_trio(lt, rng_seed):
    """bench_e2e.py's trio: a 3 x 1.5 Mbp mutant family."""
    return _family(lt, 3, TRIO_LEN, rng_seed)


def family_large(lt):
    """A 3 x 8.7 Mbp mutant family (rng 0; Streptomyces scale: every
    genome above 8 M seed windows, a weight-17 default seed)."""
    return _family(lt, LARGE_GENOMES, LARGE_LEN, 0)


def golden_three(lt):
    """tests/golden/generate.py's _genomes_three with the port's Genome."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "golden"))
    from generate import _LUT, _mutant
    rng = np.random.default_rng(1002)
    anc = rng.integers(0, 4, size=40_000).astype(np.uint8)
    out = [anc] + [_mutant(rng, anc) for _ in range(2)]
    return [lt.Genome(f"g{i}", _LUT[g], filename=f"g{i}.fa")
            for i, g in enumerate(out)]


def golden_nine(lt):
    """tests/golden/generate.py's _genomes_nine with the port's Genome."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "golden"))
    from generate import _LUT, _mutant
    rng = np.random.default_rng(1004)
    anc = rng.integers(0, 4, size=20_000).astype(np.uint8)
    out = []
    for gi in range(9):
        inv = (6_000, 9_000) if gi % 3 == 1 else None
        g = _mutant(rng, anc, mutate=0.012, invert=inv)
        out.append(lt.Genome(f"e{gi}", _LUT[g], filename=f"e{gi}.fa"))
    return out


def golden_pair(lt):
    """tests/golden/generate.py's _genomes_pair, built with the port's
    Genome."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "golden"))
    from generate import _LUT, _mutant
    rng = np.random.default_rng(1001)
    anc = rng.integers(0, 4, size=60_000).astype(np.uint8)
    b = _mutant(rng, anc, invert=(20_000, 28_000))
    return [lt.Genome("gA", _LUT[anc], filename="gA.fa"),
            lt.Genome("gB", _LUT[b], filename="gB.fa")]


def mutant_pairs(rng_seed=0):
    """MUTANT_PAIRS code pairs of MUTANT_PAIR_LEN bp: b is a with 1%
    substitutions and three indels of 1-20 bases (the gap-window size for
    which the JAX gapped module sizes its memory budget, ops/gapped.py
    design note)."""
    rng = np.random.default_rng(rng_seed)
    pairs = []
    for _ in range(MUTANT_PAIRS):
        a = rng.integers(0, 4, MUTANT_PAIR_LEN).astype(np.uint8)
        b = a.copy()
        sub = rng.random(len(b)) < 0.01
        b[sub] = (b[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        for _ in range(3):
            at = int(rng.integers(0, len(b) - 40))
            n = int(rng.integers(1, 21))
            if rng.random() < 0.5:
                b = np.concatenate([b[:at], rng.integers(0, 4, n), b[at:]])
            else:
                b = np.concatenate([b[:at], b[at + n:]])
        pairs.append((a, b.astype(np.uint8)))
    return pairs


def affine_score(a, b, a_gaps, b_gaps, go, ge, sub):
    """tests/test_gapped.py:alignment_score: the affine score of an
    alignment given by its per-row gap masks."""
    score = 0
    ai = bi = 0
    prev_a = prev_b = False
    for ag, bg in zip(a_gaps.tolist(), b_gaps.tolist()):
        require(not (ag and bg), "a column gapped in both rows")
        if ag:
            score += ge + (0 if prev_a else go)
            bi += 1
        elif bg:
            score += ge + (0 if prev_b else go)
            ai += 1
        else:
            score += int(sub[a[ai], b[bi]])
            ai += 1
            bi += 1
        prev_a, prev_b = ag, bg
    require(ai == len(a) and bi == len(b), "a walk left residues out")
    return score


def repeat_genome(lt):
    """A REPEAT_LEN bp random genome (rng 23) carrying REPEAT_COPIES copies
    of one REPEAT_ELEM bp element, half of them inverted, each with 0-2
    substitutions in the element's second half: a transposon family.
    Seeds of the first half occur in every copy, so find_repeats' rows
    reach max_multiplicity's full width of 1,000 slots."""
    rng = np.random.default_rng(23)
    g = rng.integers(0, 4, REPEAT_LEN).astype(np.uint8)
    elem = rng.integers(0, 4, REPEAT_ELEM).astype(np.uint8)
    slot = REPEAT_LEN // REPEAT_COPIES
    for k in range(REPEAT_COPIES):
        e = elem.copy()
        for _ in range(int(rng.integers(0, 3))):
            at = int(rng.integers(REPEAT_ELEM // 2, REPEAT_ELEM))
            e[at] = (e[at] + int(rng.integers(1, 4))) % 4
        if rng.random() < 0.5:
            e = 3 - e[::-1]
        at = k * slot + int(rng.integers(0, slot - REPEAT_ELEM))
        g[at:at + REPEAT_ELEM] = e
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return lt.Genome(name="rep", ascii=lut[g], codes=g)


def wide_family(lt):
    """WIDE_GENOMES genomes of WIDE_LEN bp (rng 29): one ancestor, 0.05%
    substitutions each, so most multi-MUMs span all 64 genomes."""
    rng = np.random.default_rng(29)
    anc = rng.integers(0, 4, WIDE_LEN).astype(np.uint8)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for i in range(WIDE_GENOMES):
        g = anc.copy()
        m = rng.random(WIDE_LEN) < 0.0005
        g[m] = (g[m] + rng.integers(1, 4, int(m.sum()))) % 4
        out.append(lt.Genome(name=f"w{i}", ascii=lut[g], codes=g))
    return out


def mutant_profiles(rng, B, n, M, N):
    """B one-hot window pairs of about n columns: q is p with 2%
    substitutions and a few short indels (near-diagonal, like the
    inter-anchor windows)."""
    from libmems_tpu_torch.ops.profile import rows_to_profile
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for r in range(B):
        a = rng.integers(0, 4, size=n - int(rng.integers(0, n // 20)))
        b = a.copy()
        sub = rng.random(len(b)) < 0.02
        b[sub] = rng.integers(0, 4, size=int(sub.sum()))
        for _ in range(3):
            s = int(rng.integers(0, len(b)))
            if rng.random() < 0.5:
                b = np.concatenate([b[:s], rng.integers(0, 4, size=5), b[s:]])
            else:
                b = np.concatenate([b[:s], b[s + 5:]])
        b = b[:N]
        p[r, :len(a)] = rows_to_profile(a[None].astype(np.uint8))
        q[r, :len(b)] = rows_to_profile(b[None].astype(np.uint8))
        pl[r], ql[r] = len(a), len(b)
    return p, q, pl, ql


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def sort_rows(torch, lt, dev):
    """Rows 2 and 11a of PERF.md's kernel table, library sorts, at their
    paths' shapes: sort_keys (a stable torch.sort) of one 4.6 Mbp
    genome's keys, as SortedMerList.create sorts them, and the stable
    torch.sort of the 3 x 1.5 Mbp trio's contents (matchfind._seed_table),
    median CUDA-event ms beside a bytes bound (the keys read, the sorted
    values and int64 positions written)."""
    from libmems_tpu_torch.ops.mers import sort_keys
    from libmems_tpu_torch.ops.pairwise import shr
    keys = lt.create_smls(genome_pair(lt, 0), device=dev)[0][0].keys
    content = shr(torch.cat([s.keys for s in lt.create_smls(
        family_trio(lt, 0), device=dev)[0]]), 1)
    parts = []
    for row, x, fn in (("2", keys, lambda: sort_keys(keys)),
                       ("11a", content,
                        lambda: torch.sort(content, stable=True))):
        ms = timed_ms(fn, 5, torch)
        b_ms, _ = bound(work(3 * 8 * x.shape[0], 0))
        parts.append(f"row {row}: {x.shape[0]} keys {ms:.4f} ms (bound "
                     f"{b_ms:.5f} ms, bytes)")
    log("# sorts (torch.sort, stable): " + "; ".join(parts))


def phase_device(torch):
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"compute capability {cap}, need (9, 0)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"# device: {torch.cuda.get_device_name(0)} capability {cap}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    # the plain references compute in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from libmems_tpu_torch import cuda
    t0 = time.perf_counter()
    cuda.library()
    dt = time.perf_counter() - t0
    how = "compiled" if cuda.build_seconds is not None else "cached"
    log(f"# build: {dt:.2f} s ({how})")
    if cuda.build_log_path is not None:
        os.makedirs(OUT_DIR, exist_ok=True)
        text = cuda.build_log_path.read_text()
        with open(os.path.join(OUT_DIR, "build.log"), "w") as fh:
            fh.write(text)
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("# ptxas:", line.strip())
    return dt


def pair_kernels_vs_plain(torch, smls, seed, pb, EC, timed):
    """K18 and K19 against their plain versions on the card on one pair
    of SMLs; exact equality.  Returns ({name: entry} when timed, K19's
    rows)."""
    from libmems_tpu_torch.ops import pair, pairwise
    from libmems_tpu_torch.ops.mers import sentinel_content
    res = {}
    seed_len = smls[0].seed_length
    n = sum(s.n_windows for s in smls)
    wargs = (smls[0].keys, smls[1].keys, pb, sentinel_content(seed))
    got_w, got_n = pair.pair_cluster_words(*wargs)
    ref_w, ref_n = pair.pair_cluster_words_plain(*wargs)
    require(got_n == ref_n and torch.equal(got_w, ref_w),
            "K18 differs from its plain version")
    cw = pairwise.usort(got_w)
    rargs = (cw, EC, pb, seed_len)
    got_r = pair.pair_reps(*rargs)
    ref_r = pair.pair_reps_plain(*rargs)
    require(got_r.n_reps == ref_r.n_reps
            and all(torch.equal(g, r) for g, r in zip(got_r[:-1],
                                                      ref_r[:-1])),
            "K19 differs from its plain version")
    log(f"# K18 cluster words: rows={n} candidates={got_n} equal; K19 "
        f"representatives: {got_r.n_reps} reps in EC={EC} equal "
        f"(weight {smls[0].seed_weight}, pos_bits {pb})")
    if timed:
        res["pair_cluster_words"] = entry(
            max_abs_err([(got_w, ref_w)]),
            timed_ms(lambda: pair.pair_cluster_words(*wargs), 10, torch),
            timed_ms(lambda: pair.pair_cluster_words_plain(*wargs), 3,
                     torch, warmup=False),
            # both genomes' keys in, one cluster word a row out (the
            # sort of the seed words between the two passes is a library
            # call inside the wrapper and moves more than this); ~25
            # integer operations a row: pack, four unpacks, compares
            work(nbytes(wargs[:2], got_w), 25 * n))
        res["pair_reps"] = entry(
            max_abs_err(list(zip(got_r[:-1], ref_r[:-1]))),
            timed_ms(lambda: pair.pair_reps(*rargs), 10, torch),
            timed_ms(lambda: pair.pair_reps_plain(*rargs), 3, torch,
                     warmup=False),
            work(nbytes(cw, got_r[:-1]), 10 * n))
        sort_ms = timed_ms(lambda: pairwise.usort(got_w), 10, torch)
        log(f"# torch.sort of the {n} seed words (inside K18's wrapper): "
            f"{sort_ms:.3f} ms")
    return res, got_r


def pair_windows(lt, genomes, smls, seed, dev):
    """The inter-anchor gap windows of the pair path (the LCB anchors of
    find_mums, extended as align() extends them): a list of
    gapalign windows, window[2] its (a, b) code rows."""
    from libmems_tpu_torch import aligner, gapalign, seeds
    from libmems_tpu_torch.lcb import eliminate_overlaps
    mums = lt.find_mums(smls)
    mums = eliminate_overlaps(mums).multiplicity_filter(2)
    min_w = 3 * seeds.seed_weight(seed) * 2
    mums, members = aligner._extend_lcb_anchors(mums, genomes, seed,
                                                float(min_w), device=dev)
    return [w for idx in members for w in
            gapalign.gapped_interval_from_matches(mums, idx, genomes,
                                                  None)[1]]


def phase_kernels(torch, lt, dev):
    """Each kernel against its plain version on the card; exact
    equality.  Returns {name: entry}, entry = {err, ms, plain_ms,
    work}."""
    from libmems_tpu_torch import matchfind, seeds
    from libmems_tpu_torch.ops import extend, gapped, mers, profile
    from libmems_tpu_torch.sml import create_smls, default_seed

    res = {}
    genomes = genome_pair(lt, 0)
    seed = default_seed(genomes)

    # K1: a 4.6 Mbp genome with N runs
    codes = torch.from_numpy(genomes[0].codes.copy()).to(dev)
    amb = np.zeros(len(genomes[0]), bool)
    rng = np.random.default_rng(7)
    for s in rng.integers(0, len(amb) - 500, size=40):
        amb[s:s + int(rng.integers(1, 400))] = True
    ambt = torch.from_numpy(amb).to(dev)
    k = mers.canonical_seed_keys(codes, seed, ambt)
    ref = mers.canonical_seed_keys_plain(codes, seed, ambt)
    k0 = mers.canonical_seed_keys(codes, seed)
    ref0 = mers.canonical_seed_keys_plain(codes, seed)
    require(torch.equal(k, ref) and torch.equal(k0, ref0),
            "K1 differs from its plain version")
    n = codes.numel()
    res["canonical_seed_keys"] = entry(
        max_abs_err([(k, ref), (k0, ref0)]),
        timed_ms(lambda: mers.canonical_seed_keys(codes, seed, ambt), 20,
                 torch),
        timed_ms(lambda: mers.canonical_seed_keys_plain(codes, seed, ambt),
                 5, torch, warmup=False),
        # codes and flags in, int64 keys out; ~4 integer operations per
        # seed position and strand
        work(n + n + 8 * n, 4 * seeds.seed_weight(seed) * n))
    log(f"# K1 seed keys: n={k.numel()} equal")

    # K18/K19: the 4.6 Mbp pair's seed words and cluster words
    smls, seed = create_smls(genomes, device=dev)
    seed_len = smls[0].seed_length
    chunk = max(seed_len, 256)
    total = sum(s.n_windows for s in smls)
    EC = min(1 << 14, 1 << max((total - 1).bit_length() - 1, 1))
    pb = matchfind._pair_pos_bits(max(s.n_windows for s in smls))
    pair_res, reps = pair_kernels_vs_plain(torch, smls, seed, pb, EC,
                                           timed=True)
    res.update(pair_res)
    lefts, present, is_fwd, lengths0, n_reps = reps

    # K2: the candidates of the 4.6 Mbp pair's pipeline
    keys = torch.cat([s.keys for s in smls])
    off = torch.tensor([0, smls[0].n_windows], dtype=torch.int32,
                       device=dev)[None].expand(EC, 2).contiguous()
    cnt = torch.tensor([s.n_windows for s in smls], dtype=torch.int32,
                       device=dev)[None].expand(EC, 2).contiguous()
    fill = mers.key_sentinel(seed)
    args = (keys, seed_len, chunk, off, cnt, lefts, present, is_fwd,
            lengths0, fill)
    kl, kn = extend.extend_matches(*args)
    rl, rn = extend.extend_matches_plain(*args)
    require(torch.equal(kl, rl) and torch.equal(kn, rn),
            "K2 differs from its plain version")
    # the keys of both genomes each probe reads (at least one chunk per
    # side and live row, plus the extension beyond it), the rows' inputs
    # and outputs
    live = int(present.any(dim=1).sum())
    ext = 2 * chunk * live + int((kn.long() - lengths0.long()).clamp(
        min=0).sum())
    res["extend_matches"] = entry(
        max_abs_err([(kl, rl), (kn, rn)]),
        timed_ms(lambda: extend.extend_matches(*args), 10, torch),
        timed_ms(lambda: extend.extend_matches_plain(*args), 3, torch,
                 warmup=False),
        work(16 * ext + nbytes(off, cnt, lefts, present, is_fwd, lengths0,
                               kl, kn), 4 * ext))
    log(f"# K2 extension: rows={EC} live={int(n_reps)} "
        f"max_len={int(kn.max())} equal")

    # K3/K4: the pair's inter-anchor window batch, launch by launch
    windows = pair_windows(lt, genomes, smls, seed, dev)
    p_rows = [w[2][0][None] for w in windows]
    q_rows = [w[2][1][None] for w in windows]
    launches = profile.plan_launches(p_rows, q_rows)
    packed = [(M, N, profile.pack_profiles(p_rows, q_rows, sub, M, N, dev))
              for M, N, sub in launches]
    log(f"# window batch: {len(windows)} windows in {len(launches)} "
        f"launches, buckets {sorted({(M, N) for M, N, _ in launches})}")
    extra = []
    rng = np.random.default_rng(11)
    for n, M, N, B in ((1000, 1024, 1024, 16), (4000, 4096, 4096, 2)):
        arrs = mutant_profiles(rng, B, n, M, N)
        extra.append((M, N, tuple(torch.from_numpy(x).to(dev)
                                  for x in arrs)))

    def run3(batches, fn):
        return [fn(*t) for _, _, t in batches]

    def run4(batches, ptrs, fn):
        return [fn(pt, t[2], t[3], gapped._device_tb_T(M, N))
                for (M, N, t), (pt, _) in zip(batches, ptrs)]

    errs3, errs4 = [], []
    for name, batches in (("pair windows", packed), ("extra", extra)):
        got = run3(batches, profile.profile_forward)
        ref = run3(batches, profile.profile_forward_plain)
        for (M, N, _), (gp, gs), (rp, rs) in zip(batches, got, ref):
            require(torch.equal(gp, rp) and torch.equal(gs, rs),
                    f"K3 differs from its plain version at ({M}, {N})")
            errs3 += [(gp, rp), (gs, rs)]
        got4 = run4(batches, got, gapped.traceback_walk)
        ref4 = run4(batches, got, gapped.traceback_walk_plain)
        for (M, N, _), g, r in zip(batches, got4, ref4):
            require(all(torch.equal(x, y) for x, y in zip(g, r)),
                    f"K4 differs from its plain version at ({M}, {N})")
            errs4 += list(zip(g, r))
        log(f"# K3/K4 {name}: equal")
    ptrs = run3(packed, profile.profile_forward)
    res["profile_forward"] = entry(
        max_abs_err(errs3),
        timed_ms(lambda: run3(packed, profile.profile_forward), 5, torch),
        timed_ms(lambda: run3(packed, profile.profile_forward_plain), 1,
                 torch, warmup=False),
        sum_work(dp_work("profile_forward", t) for _, _, t in packed))
    masks = run4(packed, ptrs, gapped.traceback_walk)
    res["traceback_walk"] = entry(
        max_abs_err(errs4),
        timed_ms(lambda: run4(packed, ptrs, gapped.traceback_walk), 5,
                 torch),
        timed_ms(lambda: run4(packed, ptrs, gapped.traceback_walk_plain),
                 1, torch, warmup=False),
        sum_work(walk_work(m) for m in masks))
    for M, N, t in extra:
        ptr = profile.profile_forward(*t)[0]
        T = gapped._device_tb_T(M, N)
        k3 = timed_ms(lambda: profile.profile_forward(*t), 3, torch)
        p3 = timed_ms(lambda: profile.profile_forward_plain(*t), 1, torch,
                      warmup=False)
        k4 = timed_ms(lambda: gapped.traceback_walk(ptr, t[2], t[3], T), 3,
                      torch)
        p4 = timed_ms(lambda: gapped.traceback_walk_plain(ptr, t[2], t[3], T),
                      1, torch, warmup=False)
        log(f"# K3 at {M}x{N} B={t[0].shape[0]}: kernel {k3:.3f} ms, plain "
            f"{p3:.3f} ms; K4: kernel {k4:.3f} ms, plain {p4:.3f} ms")
    for name, e in res.items():
        log(f"# {name}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} "
            f"ms, max_abs_err {e['err']}")
    return res


def phase_pairwise_kernels(torch, lt, dev):
    """K5-K7 against their plain versions on the card, on the seed table
    of the 9 x 1 Mbp family (rng 0); exact equality.  Returns {name:
    entry}."""
    from libmems_tpu_torch.matchfind import _pair_pos_bits
    from libmems_tpu_torch.ops import pairwise
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls

    res = {}
    smls, seed = create_smls(family_nine(lt, 0), device=dev)
    G = len(smls)
    cnts = [s.n_windows for s in smls]
    keys = torch.cat([s.keys for s in smls])
    seg_off = torch.from_numpy(np.concatenate([[0], np.cumsum(cnts)])
                               ).to(dev)
    c_sorted, src = torch.sort(pairwise.shr(keys, 1), stable=True)
    args = (c_sorted, src, keys, seg_off, 1000, sentinel_content(seed))
    got = pairwise.run_flags(*args)
    ref = pairwise.run_flags_plain(*args)
    require(all(torch.equal(g, r) for g, r in zip(got, ref)),
            "K5 differs from its plain version")
    res["run_flags"] = entry(
        max_abs_err(list(zip(got, ref))),
        timed_ms(lambda: pairwise.run_flags(*args), 10, torch),
        timed_ms(lambda: pairwise.run_flags_plain(*args), 3, torch,
                 warmup=False),
        # ~10 integer operations a row: neighbour compares, run bounds
        work(nbytes(args, got), 10 * keys.numel()))
    kept = int(got.unique_occ.sum())
    log(f"# K5 run flags: rows={keys.numel()} kept={kept} equal")

    pb = _pair_pos_bits(max(cnts))
    got_w = pairwise.cluster_words(got, G, pb)
    ref_w = pairwise.cluster_words_plain(ref, G, pb)
    require(torch.equal(got_w, ref_w), "K6 differs from its plain version")
    res["cluster_words"] = entry(
        max_abs_err([(got_w, ref_w)]),
        timed_ms(lambda: pairwise.cluster_words(got, G, pb), 10, torch),
        timed_ms(lambda: pairwise.cluster_words_plain(ref, G, pb), 3, torch,
                 warmup=False),
        work(nbytes(got, got_w), 5 * got_w.numel()))
    log(f"# K6 cluster words: {got_w.numel()} words equal")

    cw = pairwise.usort(got_w)
    total = keys.numel()
    ec = min(1 << 14, 1 << (max(total, 2) - 1).bit_length())
    off = seg_off[:-1].to(torch.int32)
    cnt = torch.tensor(cnts, dtype=torch.int32, device=dev)
    seed_len = smls[0].seed_length
    rargs = (cw, ec, G, pb, seed_len, off, cnt)
    got_r = pairwise.cluster_reps(*rargs)
    if got_r.n_reps > ec:       # the main path's capacity retry
        ec = 1 << (got_r.n_reps - 1).bit_length()
        rargs = (cw, ec, G, pb, seed_len, off, cnt)
        got_r = pairwise.cluster_reps(*rargs)
    ref_r = pairwise.cluster_reps_plain(*rargs)
    require(got_r.n_reps == ref_r.n_reps
            and all(torch.equal(g, r) for g, r in zip(got_r[:-1],
                                                      ref_r[:-1])),
            "K7 differs from its plain version")
    res["cluster_reps"] = entry(
        max_abs_err(list(zip(got_r[:-1], ref_r[:-1]))),
        timed_ms(lambda: pairwise.cluster_reps(*rargs), 10, torch),
        timed_ms(lambda: pairwise.cluster_reps_plain(*rargs), 3, torch,
                 warmup=False),
        work(nbytes(cw, off, cnt, got_r[:-1]), 10 * cw.numel()))
    log(f"# K7 representatives: {got_r.n_reps} reps in EC={ec} equal")
    for name in ("run_flags", "cluster_words", "cluster_reps"):
        e = res[name]
        log(f"# {name}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} "
            f"ms, max_abs_err {e['err']}")
    return res


def phase_seedocc_kernels(torch, lt, dev, genomes):
    """K16 and K17 against their plain versions on the card on one
    8.7 Mbp genome of the large family `genomes` (timed), K1, K18, K19
    and K2 on that family's weight-17 tables (35-bit keys, 24 position
    bits), and K16 + K17 on one 1 Mbp genome beside the host twin; exact
    equality.  Returns ({name: entry}, K2's max_abs_err)."""
    from libmems_tpu_torch import anchorscore, matchfind, seeds
    from libmems_tpu_torch.ops import extend, mers, seedocc
    from libmems_tpu_torch.sml import create_smls, default_seed

    res = {}
    seed = default_seed(genomes)
    require(seeds.seed_weight(seed) == 17,
            f"the large family's seed weight is {seeds.seed_weight(seed)}")
    codes = torch.from_numpy(genomes[0].codes.copy()).to(dev)
    require(torch.equal(mers.canonical_seed_keys(codes, seed),
                        mers.canonical_seed_keys_plain(codes, seed)),
            "K1 differs from its plain version at weight 17")
    del codes
    smls, _ = create_smls(genomes[:2], seed, device=dev)
    log(f"# K1 at weight 17: n={smls[0].n_windows} equal")

    def occ_vs_plain(sml, reps):
        n, L = sml.n_windows, sml.length
        cargs = (sml.sorted_keys, sml.sorted_positions, L,
                 mers.key_sentinel(sml.seed))
        got_c = seedocc.seed_run_counts(*cargs)
        ref_c = seedocc.seed_run_counts_plain(*cargs)
        require(torch.equal(got_c, ref_c),
                "K16 differs from its plain version")
        got_s = seedocc.seed_smooth(got_c, sml.seed_length)
        ref_s = seedocc.seed_smooth_plain(got_c, sml.seed_length)
        require(torch.equal(got_s, ref_s),
                "K17 differs from its plain version")
        return {
            # sorted keys and positions in, one count a position out; ~8
            # integer operations a row (compare, run bounds, scatter)
            "seed_run_counts": entry(
                max_abs_err([(got_c, ref_c)]),
                timed_ms(lambda: seedocc.seed_run_counts(*cargs), reps,
                         torch),
                timed_ms(lambda: seedocc.seed_run_counts_plain(*cargs), 3,
                         torch, warmup=False),
                work(nbytes(cargs[:2], got_c), 8 * n)),
            # counts in, floats out; seed_len adds and one division a
            # position
            "seed_smooth": entry(
                max_abs_err([(got_s, ref_s)]),
                timed_ms(lambda: seedocc.seed_smooth(got_c, sml.seed_length),
                         reps, torch),
                timed_ms(lambda: seedocc.seed_smooth_plain(
                    got_c, sml.seed_length), 3, torch, warmup=False),
                work(nbytes(got_c, got_s), (sml.seed_length + 2) * L))}

    res.update(occ_vs_plain(smls[0], 10))
    log(f"# K16/K17 on one {LARGE_LEN} bp genome ({smls[0].n_windows} "
        f"windows, seed length {smls[0].seed_length}): equal")

    # K18, K19 and K2 on the weight-17 tables of the first two genomes
    pb = matchfind._pair_pos_bits(max(s.n_windows for s in smls))
    EC = 1 << 14
    _, reps = pair_kernels_vs_plain(torch, smls, seed, pb, EC, timed=False)
    seed_len = smls[0].seed_length
    keys = torch.cat([s.keys for s in smls])
    off = torch.tensor([0, smls[0].n_windows], dtype=torch.int32,
                       device=dev)[None].expand(EC, 2).contiguous()
    cnt = torch.tensor([s.n_windows for s in smls], dtype=torch.int32,
                       device=dev)[None].expand(EC, 2).contiguous()
    args = (keys, seed_len, max(seed_len, 256), off, cnt, reps.lefts,
            reps.present, reps.is_fwd, reps.lengths0,
            mers.key_sentinel(seed))
    kl, kn = extend.extend_matches(*args)
    rl, rn = extend.extend_matches_plain(*args)
    require(torch.equal(kl, rl) and torch.equal(kn, rn),
            "K2 differs from its plain version at weight 17")
    log(f"# K2 at weight 17: rows={EC} live={min(reps.n_reps, EC)} "
        f"max_len={int(kn.max())} equal")
    del smls, keys

    # one 1 Mbp genome: the device route beside the host twin it would
    # replace below anchorscore.SOL_HOST_MAX
    g = family_nine(lt, 0)[0]
    sml = create_smls([g], device=dev)[0][0]
    small = occ_vs_plain(sml, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_list = anchorscore.seed_occurrence_list(sml)
    t1 = time.perf_counter()
    twin = anchorscore.seed_occurrence_list_np(g, sml.seed)
    t2 = time.perf_counter()
    require(np.array_equal(dev_list, twin),
            "1 Mbp seed occurrence list differs from the host twin")
    log(f"# 1 Mbp genome ({sml.n_windows} windows): K16 "
        f"{small['seed_run_counts']['ms']:.3f} ms + K17 "
        f"{small['seed_smooth']['ms']:.3f} ms; seed_occurrence_list with "
        f"the fetch {(t1 - t0) * 1e3:.3f} ms; host twin {t2 - t1:.3f} s; "
        f"bit-equal")
    for name in SEEDOCC_KERNELS:
        e = res[name]
        log(f"# {name}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} "
            f"ms, max_abs_err {e['err']}")
    return res, max_abs_err([(kl, rl), (kn, rn)])


def phase_mum_kernels(torch, lt, dev):
    """K13-K15 against their plain versions on the card, on the seed
    table of the first trio input (rng 0), and K2 on that input's
    extension rows; exact equality.  Returns ({name: entry}, K2's
    max_abs_err)."""
    from libmems_tpu_torch.matchfind import _lexsort_rows, _seed_table
    from libmems_tpu_torch.ops import extend, mums
    from libmems_tpu_torch.ops.mers import key_sentinel, sentinel_content
    from libmems_tpu_torch.sml import create_smls

    def tensors(t):
        return [x for x in t if hasattr(x, "element_size")]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tensors(a),
                                                      tensors(b)))

    res = {}
    smls, seed = create_smls(family_trio(lt, 0), device=dev)
    G = len(smls)
    seed_len = smls[0].seed_length
    keys, seg_off, content, src = _seed_table(smls)
    n = keys.numel()
    args = (content, src, keys, seg_off, 0, 1000, sentinel_content(seed))
    got = mums.mum_seed_flags(*args)
    ref = mums.mum_seed_flags_plain(*args)
    require(got.n_rows == ref.n_rows and same(got, ref),
            "K13 differs from its plain version")
    res["mum_seed_flags"] = entry(
        max_abs_err(zip(tensors(got), tensors(ref))),
        timed_ms(lambda: mums.mum_seed_flags(*args), 10, torch),
        timed_ms(lambda: mums.mum_seed_flags_plain(*args), 3, torch,
                 warmup=False),
        # the sorted table and keys in, seven per-row columns out; ~12
        # integer operations a row (compares, run bounds, flags)
        work(nbytes(args, tensors(got)), 12 * n))
    log(f"# K13 seed flags: rows={n} candidate rows={got.n_rows} equal")

    pos_bits = n.bit_length()
    got_c = mums.mum_candidates(got, G, 0, pos_bits)
    ref_c = mums.mum_candidates_plain(ref, G, 0, pos_bits)
    require(same(got_c, ref_c), "K14 differs from its plain version")
    n_rows = got.n_rows
    res["mum_candidates"] = entry(
        max_abs_err(zip(got_c, ref_c)),
        timed_ms(lambda: mums.mum_candidates(got, G, 0, pos_bits), 10,
                 torch),
        timed_ms(lambda: mums.mum_candidates_plain(ref, G, 0, pos_bits), 3,
                 torch, warmup=False),
        # six per-row flag columns in, starts + words + posref out; per
        # candidate row ~6 operations per field bit-placement and genome
        work(nbytes(tensors(got), got_c),
             4 * n + 6 * (G + 3) * got_c.words.shape[0] * n_rows))
    log(f"# K14 candidates: {n_rows} rows, {got_c.words.shape[0]} words "
        f"each, equal")

    order = _lexsort_rows(list(got_c.words) + [got_c.posref])
    words = torch.index_select(got_c.words, 1, order)
    posref = got_c.posref[order]
    ec = min(1 << 14, 1 << (n_rows - 1).bit_length())
    got_r = mums.mum_reps(words, posref, ec, G, pos_bits, seed_len)
    if got_r.n_reps > ec:       # the main path's capacity growth
        ec = 1 << (got_r.n_reps - 1).bit_length()
        got_r = mums.mum_reps(words, posref, ec, G, pos_bits, seed_len)
    rargs = (words, posref, ec, G, pos_bits, seed_len)
    ref_r = mums.mum_reps_plain(*rargs)
    require(got_r.n_reps == ref_r.n_reps and same(got_r, ref_r),
            "K15 differs from its plain version")
    res["mum_reps"] = entry(
        max_abs_err(zip(tensors(got_r), tensors(ref_r))),
        timed_ms(lambda: mums.mum_reps(*rargs), 10, torch),
        timed_ms(lambda: mums.mum_reps_plain(*rargs), 3, torch,
                 warmup=False),
        # sorted words and posref in, [EC, G] rows out; ~10 operations a
        # row and field (unpack, compares)
        work(nbytes(words, posref, tensors(got_r)),
             10 * (G + 3) * posref.numel()))
    log(f"# K15 representatives: {got_r.n_reps} reps in EC={ec} equal")

    off = seg_off[:-1].to(torch.int32)[None].expand(ec, G).contiguous()
    cnt = (seg_off[1:] - seg_off[:-1]).to(torch.int32)[None].expand(
        ec, G).contiguous()
    kargs = (keys, seed_len, max(seed_len, 256), off, cnt, got_r.lefts,
             got_r.present, got_r.is_fwd,
             torch.full((ec,), seed_len, dtype=torch.int32, device=dev),
             key_sentinel(seed))
    kl, kn = extend.extend_matches(*kargs)
    rl, rn = extend.extend_matches_plain(*kargs)
    require(torch.equal(kl, rl) and torch.equal(kn, rn),
            "K2 differs from its plain version on the trio's rows")
    log(f"# K2 on the trio's {got_r.n_reps} rows at G = {G}: equal")
    for name in MUM_KERNELS:
        e = res[name]
        log(f"# {name}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} "
            f"ms, max_abs_err {e['err']}")
    return res, max_abs_err([(kl, rl), (kn, rn)])


def write_outputs(lt, ivs, segs, n_genomes):
    """The three progressive outputs as bytes: XMFA, bbseq, bbcols."""
    outs = {}
    for name, write, args in (
            ("nine.xmfa", lt.write_xmfa, (ivs,)),
            ("nine.bbseq", lt.write_backbone_seq_coordinates,
             (segs, n_genomes)),
            ("nine.bbcols", lt.write_backbone_columns, (segs,))):
        buf = io.StringIO()
        write(buf, *args)
        outs[name] = buf.getvalue().encode()
    return outs


def phase_goldens(lt, dev):
    gs = golden_pair(lt)
    mums = lt.find_mums(gs, device=dev)
    buf = io.StringIO()
    lt.write_match_list(buf, mums, [g.filename for g in gs],
                        [len(g) for g in gs])
    with open(os.path.join(ROOT, "tests", "golden", "pair.mums"), "rb") as fh:
        require(buf.getvalue().encode() == fh.read(),
                "pair.mums differs from the golden")
    ivs, _ = lt.align(gs, lt.AlignerConfig(gapped_alignment=True,
                                           device=dev))
    buf = io.StringIO()
    lt.write_xmfa(buf, ivs)
    with open(os.path.join(ROOT, "tests", "golden", "pair.xmfa"), "rb") as fh:
        require(buf.getvalue().encode() == fh.read(),
                "pair.xmfa differs from the golden")
    log(f"# goldens: pair.mums ({len(mums)} MUMs) and pair.xmfa "
        f"({len(ivs.intervals)} intervals) byte-equal")
    gs = golden_three(lt)
    mums = lt.find_mums(gs, device=dev)
    buf = io.StringIO()
    lt.write_match_list(buf, mums, [g.filename for g in gs],
                        [len(g) for g in gs])
    with open(os.path.join(ROOT, "tests", "golden", "three.mums"),
              "rb") as fh:
        require(buf.getvalue().encode() == fh.read(),
                "three.mums differs from the golden")
    log(f"# goldens: three.mums ({len(mums)} MUMs) byte-equal")
    gs = golden_nine(lt)
    got = lt.find_mums(gs, device=dev)
    ref = lt.find_mums(gs, device="cpu")
    require(len(ref) > 0 and np.array_equal(got.starts, ref.starts)
            and np.array_equal(got.lengths, ref.lengths),
            f"find_mums at G = 9: GPU ({len(got)}) differs from CPU "
            f"tensors ({len(ref)})")
    log(f"# goldens: find_mums on the nine family (G = 9) GPU == CPU "
        f"tensors ({len(ref)} MUMs)")
    from libmems_tpu_torch.matchfind import _find_pairwise_mums_host
    smls, _ = lt.create_smls(gs, device=dev)
    host = _find_pairwise_mums_host(smls)
    fused = lt.find_pairwise_mums(smls)
    require(len(fused) > 0 and np.array_equal(host.starts, fused.starts)
            and np.array_equal(host.lengths, fused.lengths),
            f"nine family: the host-orchestrated pairwise seeder "
            f"({len(host)}) differs from the fused one ({len(fused)})")
    log(f"# goldens: _find_pairwise_mums_host == find_pairwise_mums on the "
        f"nine family on the GPU ({len(fused)} matches)")
    ivs, _ = lt.progressive_align(gs, lt.ProgressiveConfig(refine=False,
                                                           device=dev))
    new_ivs, segs = lt.apply_backbone(ivs, device=dev)
    for name, data in write_outputs(lt, new_ivs, segs, len(gs)).items():
        with open(os.path.join(ROOT, "tests", "golden", name), "rb") as fh:
            require(data == fh.read(), f"{name} differs from the golden")
    log(f"# goldens: nine.xmfa, nine.bbseq, nine.bbcols byte-equal "
        f"({len(new_ivs.intervals)} intervals, {len(segs)} segments)")
    # refine=True (the default): the GPU's bytes equal the CPU tensors',
    # which tests/test_torch_refine.py holds to the JAX package
    xmfa = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        ivs, _ = lt.progressive_align(golden_nine(lt),
                                      lt.ProgressiveConfig(device=d))
        buf = io.StringIO()
        lt.write_xmfa(buf, ivs)
        xmfa[str(d)] = buf.getvalue().encode()
        log(f"# nine family refine=True on {d}: "
            f"{time.perf_counter() - t0:.3f} s")
    require(xmfa[str(dev)] == xmfa["cpu"],
            "nine family refine=True: GPU XMFA differs from CPU tensors")
    log(f"# goldens: nine family refine=True XMFA GPU == CPU tensors "
        f"({len(xmfa['cpu'])} bytes)")


def check_partition(ivs, genomes):
    for g, genome in enumerate(genomes):
        spans = sorted((int(iv.left_ends()[g]), int(iv.right_ends()[g]))
                       for iv in ivs.intervals if iv.left_ends()[g] != 0)
        cursor = 1
        for lo, hi in spans:
            require(lo == cursor, f"genome {g}: gap or overlap at {cursor}")
            cursor = hi + 1
        require(cursor == len(genome) + 1,
                f"genome {g}: intervals end at {cursor - 1}, "
                f"length {len(genome)}")


def phase_main(torch, lt, dev):
    from libmems_tpu_torch import trace
    from libmems_tpu_torch.matchfind import find_pair_mums_np
    from libmems_tpu_torch.ops import extend, gapped, mers, pair, profile
    from libmems_tpu_torch.sml import default_seed
    wrappers = {"canonical_seed_keys": mers.canonical_seed_keys,
                "extend_matches": extend.extend_matches,
                "pair_cluster_words": pair.pair_cluster_words,
                "pair_reps": pair.pair_reps,
                "profile_forward": profile.profile_forward,
                "traceback_walk": gapped.traceback_walk}
    cfg = lt.AlignerConfig(gapped_alignment=True, recursive=False,
                           device=dev)

    def run(rng_seed):
        genomes = genome_pair(lt, rng_seed)
        trace.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ivs, mums = lt.align(genomes, cfg)
        buf = io.StringIO()
        lt.write_xmfa(buf, ivs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return dt, genomes, ivs, mums, buf.getvalue()

    trace.set_enabled(True, stream=sys.stdout)
    for w in wrappers.values():
        w.launches = 0
    dt1, genomes, ivs, mums, xmfa = run(0)
    nbytes = len(xmfa)
    launches = {k: w.launches for k, w in wrappers.items()}
    stages1 = trace.stage_seconds()
    log(f"# main path: 2 x {PAIR_LEN} bp, first run {dt1:.3f} s, "
        f"{len(mums)} anchors, {len(ivs.intervals)} intervals, "
        f"{nbytes} XMFA bytes, launches {launches}")
    log("# stages (first run): " + json.dumps(stages1))
    for name, n in launches.items():
        require(n > 0, f"{name}: no launch on the main path")
    check_partition(ivs, genomes)

    found = lt.find_mums(genomes, device=dev)
    twin = find_pair_mums_np(genomes[0].codes, genomes[1].codes,
                             default_seed(genomes)).canonical_sort()
    require(np.array_equal(found.starts, twin.starts)
            and np.array_equal(found.lengths, twin.lengths),
            f"find_mums ({len(found)}) differs from the numpy twin "
            f"({len(twin)})")
    log(f"# find_mums equals the numpy twin: {len(found)} MUMs")

    dt2, genomes2, ivs2, _, _ = run(1)
    stages2 = trace.stage_seconds()
    trace.set_enabled(False)
    check_partition(ivs2, genomes2)
    log(f"# main path second input (rng_seed=1): {dt2:.3f} s")
    log("# stages (second run): " + json.dumps(stages2))
    return launches, dt1, dt2, {"mums": mums, "found": found, "xmfa": xmfa,
                                "stages": (stages1, stages2)}


def phase_trio(torch, lt, dev):
    """The flat N-way path on two 3 x 1.5 Mbp families (bench_e2e.py's
    trio: gapped, no recursion).  Returns (launches of the first run,
    walls, {"xmfa": the first run's XMFA})."""
    from libmems_tpu_torch import trace
    from libmems_tpu_torch.ops import extend, gapped, mers, mums, profile
    wrappers = {"canonical_seed_keys": mers.canonical_seed_keys,
                "extend_matches": extend.extend_matches,
                "mum_seed_flags": mums.mum_seed_flags,
                "mum_candidates": mums.mum_candidates,
                "mum_reps": mums.mum_reps,
                "profile_forward": profile.profile_forward,
                "traceback_walk": gapped.traceback_walk,
                "banded_forward_ptrs": profile.banded_forward_ptrs,
                "banded_traceback_walk": profile.banded_traceback_walk}
    printed_only = ("banded_forward_ptrs", "banded_traceback_walk")
    cfg = lt.AlignerConfig(gapped_alignment=True, recursive=False,
                           device=dev)

    def run(rng_seed):
        genomes = family_trio(lt, rng_seed)
        trace.reset()
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ivs, mums_ = lt.align(genomes, cfg)
        buf = io.StringIO()
        lt.write_xmfa(buf, ivs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        log(f"# trio rng_seed={rng_seed}: 3 x {TRIO_LEN} bp, align + "
            f"write_xmfa {dt:.3f} s, {len(mums_)} anchors, "
            f"{len(ivs.intervals)} intervals, {len(buf.getvalue())} XMFA "
            f"bytes")
        xmfa[rng_seed] = buf.getvalue()
        log(f"# launches: {launches}")
        log("# stages: " + json.dumps(trace.stage_seconds()))
        for name, n in launches.items():
            require(n > 0 or name in printed_only,
                    f"{name}: no launch on the trio path")
        check_partition(ivs, genomes)
        return genomes, launches, dt

    xmfa = {}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "trio_trace.log"), "w") as fh:
        trace.set_enabled(True, stream=fh)
        genomes, launches, dt1 = run(0)
        t0 = time.perf_counter()
        got = lt.find_mums(genomes, device=dev)
        t1 = time.perf_counter()
        ref = lt.find_mums(genomes, device="cpu")
        t2 = time.perf_counter()
        require(np.array_equal(got.starts, ref.starts)
                and np.array_equal(got.lengths, ref.lengths),
                f"trio find_mums on the GPU ({len(got)}) differs from CPU "
                f"tensors ({len(ref)})")
        log(f"# trio find_mums GPU == CPU tensors: {len(got)} MUMs "
            f"({t1 - t0:.3f} s on the GPU, {t2 - t1:.3f} s on CPU tensors)")
        _, _, dt2 = run(1)
        trace.set_enabled(False)
    return launches, (dt1, dt2), {"xmfa": xmfa[0]}


def check_segments(ivs, segs):
    """Every backbone segment lies inside its interval: its columns in
    the interval's alignment, its member ranges in the interval's
    per-genome range."""
    bounds = {}     # an interval's ends cost a pass over its columns
    for k, seg in enumerate(segs):
        if seg.interval not in bounds:
            iv = ivs.intervals[seg.interval]
            bounds[seg.interval] = (iv.alignment_length, iv.left_ends(),
                                    iv.right_ends())
        n_cols, le, re = bounds[seg.interval]
        require(0 <= seg.left_col <= seg.right_col < n_cols,
                f"segment {k}: columns outside interval {seg.interval}")
        for g in seg.genomes:
            lo, hi = sorted(abs(int(x)) for x in seg.seq_ranges[g])
            require(le[g] <= lo <= hi <= re[g],
                    f"segment {k}: genome {g} outside interval "
                    f"{seg.interval}")


def phase_progressive(torch, lt, dev):
    """The progressiveMauve path, default config (refine=True), on two
    9 x 1 Mbp families.  Returns (launches of the first run, the
    arguments of the first run's align_profile_batch,
    profile_scores_batch and predict_homologous calls, walls, {"outs":
    the first run's output bytes, "pairwise": find_pairwise_mums of the
    first family on the GPU})."""
    from libmems_tpu_torch import islands, msa, progressive, trace
    from libmems_tpu_torch.ops import (extend, gapped, hmm, mers, pairwise,
                                       profile)
    wrappers = {"canonical_seed_keys": mers.canonical_seed_keys,
                "extend_matches": extend.extend_matches,
                "profile_forward": profile.profile_forward,
                "traceback_walk": gapped.traceback_walk,
                "run_flags": pairwise.run_flags,
                "cluster_words": pairwise.cluster_words,
                "cluster_reps": pairwise.cluster_reps,
                "fb_posterior": hmm.fb_posterior,
                "profile_forward_scores": profile.profile_forward_scores,
                "banded_forward_scores": profile.banded_forward_scores,
                "banded_forward_ptrs": profile.banded_forward_ptrs,
                "banded_traceback_walk": profile.banded_traceback_walk}
    cfg = lt.ProgressiveConfig(device=dev)
    require(cfg.refine, "the default ProgressiveConfig must refine")
    # the callers' names of the node-DP, refinement and HMM entry points
    targets = [(progressive, "align_profile_batch"),
               (msa, "align_profile_batch"),
               (msa, "profile_scores_batch"),
               (islands, "predict_homologous")]

    def run(rng_seed, capture):
        genomes = family_nine(lt, rng_seed)
        trace.reset()
        profile.BAND_STATS.update(dict.fromkeys(profile.BAND_STATS, 0))
        for w in wrappers.values():
            w.launches = 0
        with recording(targets if capture else []) as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ivs, _ = lt.progressive_align(genomes, cfg)
            t1 = time.perf_counter()
            new_ivs, segs = lt.apply_backbone(ivs, device=dev)
            outs = write_outputs(lt, new_ivs, segs, len(genomes))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        launches = {k: w.launches for k, w in wrappers.items()}
        stages = trace.stage_seconds()
        log(f"# progressive rng_seed={rng_seed}: {PROG_GENOMES} x "
            f"{PROG_LEN} bp, align {t1 - t0:.3f} s, backbone + writers "
            f"{t2 - t1:.3f} s, total {t2 - t0:.3f} s; "
            f"{len(ivs.intervals)} intervals -> {len(new_ivs.intervals)}, "
            f"{len(segs)} segments, bytes "
            f"{ {k: len(v) for k, v in outs.items()} }")
        log(f"# launches: {launches}")
        log("# stages: " + json.dumps(stages))
        log("# refine stages: " + json.dumps(
            {k: round(v, 3) for k, v in stages.items()
             if k.startswith("refine")}))
        log(f"# BAND_STATS: {json.dumps(profile.BAND_STATS)}")
        for name, n in launches.items():
            require(n > 0, f"{name}: no launch on the progressive path")
        check_partition(ivs, genomes)
        check_partition(new_ivs, genomes)
        check_segments(new_ivs, segs)
        first_outs.setdefault("outs", outs)
        return genomes, launches, calls, t2 - t0

    first_outs = {}
    trace.set_enabled(True, stream=sys.stdout)
    genomes, launches, calls, dt1 = run(0, True)
    got = lt.find_pairwise_mums(genomes, device=dev)
    ref = lt.find_pairwise_mums(genomes, device="cpu")
    require(np.array_equal(got.starts, ref.starts)
            and np.array_equal(got.lengths, ref.lengths),
            f"find_pairwise_mums on the GPU ({len(got)}) differs from CPU "
            f"tensors ({len(ref)})")
    log(f"# find_pairwise_mums GPU == CPU tensors: {len(got)} matches")
    _, _, _, dt2 = run(1, False)
    trace.set_enabled(False)
    return launches, calls, (dt1, dt2), {"outs": first_outs["outs"],
                                         "pairwise": got}


def phase_large(torch, lt, dev, genomes):
    """The progressiveMauve path, default config, on the 3 x 8.7 Mbp
    family `genomes`: every genome is above anchorscore.SOL_HOST_MAX seed windows,
    so the seed occurrence lists come from K16 and K17.  Returns
    (launches, wall, the arguments of its predict_homologous calls)."""
    from libmems_tpu_torch import anchorscore, islands, progressive, trace
    from libmems_tpu_torch.ops import (extend, hmm, mers, pairwise, profile,
                                       seedocc)
    from libmems_tpu_torch.sml import default_seed
    wrappers = {"canonical_seed_keys": mers.canonical_seed_keys,
                "extend_matches": extend.extend_matches,
                "run_flags": pairwise.run_flags,
                "cluster_words": pairwise.cluster_words,
                "cluster_reps": pairwise.cluster_reps,
                "seed_run_counts": seedocc.seed_run_counts,
                "seed_smooth": seedocc.seed_smooth,
                "fb_posterior": hmm.fb_posterior}
    require(all(len(g) - 1 > anchorscore.SOL_HOST_MAX for g in genomes),
            "a genome of the large family is below SOL_HOST_MAX windows")
    cfg = lt.ProgressiveConfig(device=dev)
    sols = []
    real = progressive.seed_occurrence_lists

    def keep_lists(*args):
        sols.extend(real(*args))
        return list(sols)

    trace.set_enabled(True, stream=sys.stdout)
    trace.reset()
    profile.BAND_STATS.update(dict.fromkeys(profile.BAND_STATS, 0))
    progressive.seed_occurrence_lists = keep_lists
    for w in wrappers.values():
        w.launches = 0
    try:
        with recording([(islands, "predict_homologous")]) as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ivs, _ = lt.progressive_align(genomes, cfg)
            t1 = time.perf_counter()
            new_ivs, segs = lt.apply_backbone(ivs, device=dev)
            outs = write_outputs(lt, new_ivs, segs, len(genomes))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    finally:
        progressive.seed_occurrence_lists = real
    launches = {k: w.launches for k, w in wrappers.items()}
    trace.set_enabled(False)
    log(f"# large rng_seed=0: {LARGE_GENOMES} x {LARGE_LEN} bp, align "
        f"{t1 - t0:.3f} s, backbone + writers {t2 - t1:.3f} s, total "
        f"{t2 - t0:.3f} s; {len(ivs.intervals)} intervals -> "
        f"{len(new_ivs.intervals)}, {len(segs)} segments, bytes "
        f"{ {k: len(v) for k, v in outs.items()} }")
    log(f"# launches: {launches}")
    log("# stages: " + json.dumps(trace.stage_seconds()))
    log(f"# BAND_STATS: {json.dumps(profile.BAND_STATS)}")
    for name, n in launches.items():
        require(n > 0, f"{name}: no launch on the large-family path")
    for name in SEEDOCC_KERNELS:
        require(launches[name] == len(genomes),
                f"{name}: {launches[name]} launches for {len(genomes)} "
                f"genomes")
    require(len(sols) == len(genomes), "seed occurrence lists not recorded")
    seed = default_seed(genomes)
    t3 = time.perf_counter()
    for g, (genome, sol) in enumerate(zip(genomes, sols)):
        twin = anchorscore.seed_occurrence_list_np(genome, seed)
        require(sol.dtype == np.float32 and np.array_equal(sol, twin),
                f"genome {g}: seed occurrence list differs from the host "
                f"twin")
    log(f"# seed occurrence lists of the path == host twin, bit for bit "
        f"(max {max(float(x.max()) for x in sols)}; the twin took "
        f"{(time.perf_counter() - t3) / len(genomes):.3f} s a genome)")
    check_partition(ivs, genomes)
    check_partition(new_ivs, genomes)
    check_segments(new_ivs, segs)
    return launches, t2 - t0, calls["predict_homologous"]


DP_KERNELS = ("banded_forward_scores", "profile_forward_scores",
              "banded_forward_ptrs", "banded_traceback_walk",
              "profile_forward", "traceback_walk")


def adversarial_windows():
    """tests/test_banded.py's windows in the 1024 bucket: a near-diagonal
    pair, a 300-column insertion (fails the certificate), a two-row
    profile with gap columns against a mutant, and a 200-column window
    against a 1000-column one (not band-eligible)."""
    rng = np.random.default_rng(7)

    def pair(n, mutate=0.01, ins=0):
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        m = rng.random(n) < mutate
        b[m] = (b[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if ins:
            b = np.concatenate([b[:n // 2], rng.integers(0, 4, ins),
                                b[n // 2:]]).astype(np.uint8)
        return a, b

    p_rows, q_rows = [], []
    for n, ins in ((950, 0), (800, 300)):
        a, b = pair(n, ins=ins)
        p_rows.append(a[None])
        q_rows.append(b[None])
    a, b = pair(900, mutate=0.02)
    p_rows.append(np.stack([a, np.where(rng.random(900) < 0.02, 4, b)]
                           ).astype(np.uint8))
    q_rows.append(pair(905, mutate=0.02)[1][None])
    p_rows.append(pair(200)[0][None])
    q_rows.append(pair(1000)[1][None])
    return p_rows, q_rows


def plan_profile_dp(score_calls, align_calls, dev):
    """The profile-DP launches of recorded profile_scores_batch and
    align_profile_batch calls, rebuilt with the path's own planners
    (ops.profile.plan_buckets, plan_launches, band_route, split_launch)
    and routed by the kernels' own certificates, as the path routes them.
    Returns ({kernel name: [arguments, ...]}, uncertified eligible
    windows)."""
    from libmems_tpu_torch.ops import gapped, profile
    launches = {name: [] for name in DP_KERNELS}
    uncert = 0
    for a in score_calls:
        pr, qr, go, ge = a["p_rows"], a["q_rows"], a["gap_open"], \
            a["gap_extend"]
        for M, N, idxs in profile.plan_buckets(pr, qr):
            Mp = -(-M // profile.BAND_K) * profile.BAND_K
            todo = list(idxs)
            t = profile.pack_profiles(pr, qr, todo, Mp, N, dev)
            elig = profile.band_route(pr, qr, todo, Mp, N)
            if elig.any():
                args = (*t, go, ge, profile._band_half(N))
                launches["banded_forward_scores"].append(args)
                _, cert = profile.banded_forward_scores(*args)
                okm = elig & cert.cpu().numpy()
                uncert += int((elig & ~okm).sum())
                todo = [k for r, k in enumerate(todo) if not okm[r]]
                if not todo:
                    continue
                t = profile.pack_profiles(pr, qr, todo, Mp, N, dev)
            launches["profile_forward_scores"].append((*t, go, ge))
    for a in align_calls:
        pr, qr, go, ge = a["p_rows"], a["q_rows"], a["gap_open"], \
            a["gap_extend"]
        for Mp, N, sub in profile.plan_launches(pr, qr):
            t = profile.pack_profiles(pr, qr, sub, Mp, N, dev)
            T = gapped._device_tb_T(Mp, N)
            todo = sub
            elig = profile.band_route(pr, qr, sub, Mp, N)
            if elig.any():
                H_W = profile._band_half(N)
                args = (*t, go, ge, H_W)
                launches["banded_forward_ptrs"].append(args)
                ptrs, _, cert = profile.banded_forward_ptrs(*args)
                launches["banded_traceback_walk"].append(
                    (ptrs, t[2], t[3], N, H_W, T))
                okm = elig & cert.cpu().numpy()
                uncert += int((elig & ~okm).sum())
                todo = [k for r, k in enumerate(sub) if not okm[r]]
            if profile.ckpt_route(Mp, N):
                continue    # K24 + K25 + the host walk: phase "bounded"
            for chunk in profile.split_launch(todo, Mp * (N + 1)):
                if chunk != sub:
                    t = profile.pack_profiles(pr, qr, chunk, Mp, N, dev)
                launches["profile_forward"].append((*t, go, ge))
                ptrs, _ = profile.profile_forward(*t, go, ge)
                launches["traceback_walk"].append((ptrs, t[2], t[3], T))
    return launches, uncert


def phase_profile_dp(torch, dev, calls, launches):
    """K3, K4 and K9-K12 against their plain versions on the card, on
    the profile-DP launches of the first progressive run (node merges,
    refine gate, refine tracebacks), rebuilt by plan_profile_dp; exact
    equality.  Where that run gave K9 no launch or left no uncertified
    window, the adversarial windows run the same routes too.  Returns
    {name: entry}, the times and work summed over the path's launches."""
    from libmems_tpu_torch.ops import gapped, profile
    fns = {"profile_forward": (profile.profile_forward,
                               profile.profile_forward_plain),
           "traceback_walk": (gapped.traceback_walk,
                              gapped.traceback_walk_plain),
           "profile_forward_scores": (profile.profile_forward_scores,
                                      profile.profile_forward_scores_plain),
           "banded_forward_scores": (profile.banded_forward_scores,
                                     profile.banded_forward_scores_plain),
           "banded_forward_ptrs": (profile.banded_forward_ptrs,
                                   profile.banded_forward_ptrs_plain),
           "banded_traceback_walk": (profile.banded_traceback_walk,
                                     profile.banded_traceback_walk_plain)}
    align_calls = calls.get("align_profile_batch", [])
    score_calls = calls.get("profile_scores_batch", [])
    path, uncert = plan_profile_dp(score_calls, align_calls, dev)
    for name in DP_KERNELS:
        require(len(path[name]) == launches[name],
                f"{name}: {len(path[name])} launches rebuilt, the path "
                f"made {launches[name]}")
    n_win = {name: sum(int(a[0].shape[0]) for a in path[name])
             for name in DP_KERNELS}
    log(f"# profile DP of the first input: {len(align_calls)} "
        f"align_profile_batch and {len(score_calls)} profile_scores_batch "
        f"calls; launches {json.dumps({k: len(v) for k, v in path.items()})}"
        f", windows {json.dumps(n_win)}, {uncert} uncertified eligible")
    runs = [("path", path)]
    if not path["profile_forward_scores"] or not uncert:
        pr, qr = adversarial_windows()
        arg = {"p_rows": pr, "q_rows": qr, "gap_open": profile.GAP_OPEN,
               "gap_extend": profile.GAP_EXTEND}
        extra, x_uncert = plan_profile_dp([arg], [arg], dev)
        require(x_uncert >= 2 and all(extra[n] for n in DP_KERNELS),
                "the adversarial windows missed a route")
        runs.append(("adversarial", extra))
        log(f"# adversarial windows: launches "
            f"{json.dumps({k: len(v) for k, v in extra.items()})}, "
            f"{x_uncert} uncertified")

    res = {}
    for name in DP_KERNELS:
        fn, plain = fns[name]
        errs, timed = [], None
        for label, lst in runs:
            if not lst[name]:
                continue
            got = [fn(*a) for a in lst[name]]
            ref, pms = timed_once(lambda: [plain(*a) for a in lst[name]],
                                  torch)
            for a, g, r in zip(lst[name], got, ref):
                g = g if isinstance(g, tuple) else (g,)
                r = r if isinstance(r, tuple) else (r,)
                require(all(torch.equal(x, y) for x, y in zip(g, r)),
                        f"{name} differs from its plain version on a "
                        f"{label} launch at {tuple(a[0].shape)}")
                errs += list(zip(g, r))
            if timed is None:
                ms = timed_ms(lambda: [fn(*a) for a in lst[name]], 3, torch)
                if name in ("traceback_walk", "banded_traceback_walk"):
                    w = sum_work(walk_work(g) for g in got)
                else:
                    w = sum_work(dp_work(name, a[:4], a[6] if len(a) > 6
                                         else None) for a in lst[name])
                timed = (label, ms, pms, w)
        label, ms, pms, w = timed
        res[name] = entry(max_abs_err(errs), ms, pms, w)
        log(f"# {name}: equal on {', '.join(lb for lb, l in runs if l[name])}"
            f"; kernel {ms:.3f} ms, plain {pms:.3f} ms over the {label} "
            f"launches")
    return res


def hmm_batches(torch, dev, calls):
    """The K8 launches of a path's recorded predict_homologous calls,
    rebuilt by hmm.pack_batches: (obs, lengths, mats, threshold) on the
    card."""
    from libmems_tpu_torch.ops import hmm
    batches = []
    for a in calls:
        mats = hmm.log_matrices(a["params"] or hmm.hoxd_params(), dev)
        for _, obs, lens in hmm.pack_batches(a["sequences"]):
            batches.append((torch.from_numpy(obs).to(dev),
                            torch.from_numpy(lens).to(dev), mats,
                            a["threshold"]))
    return batches


def hmm_vs_plain(torch, batches, label):
    """K8 against its plain version on the card on `batches`: posteriors
    within 1e-12, calls equal.  Then the batches of padded width
    FB_SCAN_MIN_T and more once more through the sequential kernel (the
    route every narrower width takes), timed once, against the chunked
    route: its time, the largest posterior difference and the calls that
    differ.  Returns the entry, the times summed over the launches."""
    from libmems_tpu_torch.ops import hmm
    log(f"# K8 {label} batches (B x T): "
        f"{sorted(tuple(o.shape) for o, _, _, _ in batches)}, longest "
        f"sequence {max(int(n.max()) for _, n, _, _ in batches)} columns")

    def run(fn, bs, **kw):
        return [fn(o, n, m, t, **kw) for o, n, m, t in bs]

    got = run(hmm.fb_posterior, batches)
    ref, pms = timed_once(lambda: run(hmm.fb_posterior_plain, batches), torch)
    for (o, _, _, _), (_, gc), (_, rc) in zip(batches, got, ref):
        require(torch.equal(gc, rc), f"K8 calls differ at {tuple(o.shape)}")
    err = max_abs_err([(g[0], r[0]) for g, r in zip(got, ref)])
    require(err <= 1e-12, f"K8 posteriors differ by {err}")
    del ref
    ms = timed_ms(lambda: run(hmm.fb_posterior, batches), 3, torch)
    # observations in, f64 posteriors and calls out, over each sequence's
    # columns
    cols = sum(int(n.sum()) for _, n, _, _ in batches)
    e = entry(err, ms, pms, work(10 * cols, HMM_COLUMN_OPS * cols,
                                 F64_OPS_PER_S))
    wide = [i for i, b in enumerate(batches)
            if b[0].shape[1] >= hmm.FB_SCAN_MIN_T]
    routes = {"wide_launches": len(wide)}
    if wide:
        bs = [batches[i] for i in wide]
        routes["scan_ms"] = timed_ms(lambda: run(hmm.fb_posterior, bs), 3,
                                     torch)
        seq, routes["sequential_ms"] = timed_once(
            lambda: run(hmm.fb_posterior, bs, sequential=True), torch)
        routes["max_post_diff"] = max_abs_err(
            [(got[i][0], q[0]) for i, q in zip(wide, seq)])
        routes["calls_differ"] = sum(int((got[i][1] != q[1]).sum())
                                     for i, q in zip(wide, seq))
        routes["wide_columns"] = sum(int(b[1].sum()) for b in bs)
    log(f"# K8 {label} vs plain: max_abs_err {err}, calls equal; kernel "
        f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bound(e['work'])[0]:.6f} "
        f"ms, {len(batches)} launches; padded width >= "
        f"{hmm.FB_SCAN_MIN_T}, chunked route vs the sequential kernel: "
        + json.dumps(routes))
    return e


def phase_hmm(torch, dev, calls, launches, large_calls=None,
              large_launches=None):
    """K8 against its plain version on the card, on the batches of the
    first progressive run's predict_homologous calls at their full
    lengths, rebuilt into the path's launches by hmm.pack_batches:
    posteriors within 1e-12, calls equal; and, where phase large ran, on
    the batches of the 3 x 8.7 Mbp path the same way (logged apart).
    Returns the 9 x 1 Mbp entry, the times summed over those launches."""
    batches = hmm_batches(torch, dev, calls)
    require(len(batches) == launches["fb_posterior"],
            f"{len(batches)} HMM launches rebuilt, the path made "
            f"{launches['fb_posterior']}")
    e = hmm_vs_plain(torch, batches, f"{PROG_GENOMES} x {PROG_LEN} bp")
    del batches
    if large_calls is not None:
        big = hmm_batches(torch, dev, large_calls)
        require(len(big) == large_launches["fb_posterior"],
                f"{len(big)} HMM launches rebuilt, the 3 x 8.7 Mbp path "
                f"made {large_launches['fb_posterior']}")
        hmm_vs_plain(torch, big, f"{LARGE_GENOMES} x {LARGE_LEN} bp")
    return e


def phase_decode(torch, lt, dev, hmm_calls):
    """Decode and pairwise DP: the API that libMems ships but no path of
    it calls.  Counted run: align_pairs on the pair path's inter-anchor
    windows (every bucket walked on the card: K23 + K4) and on the mutant
    pairs (over DEVICE_TB_BUDGET: K22, packed K23 blocks, the host walk),
    viterbi_homologous on the sequences of the first progressive run's
    predict_homologous calls and 2 iterations of baum_welch on all of
    them.  Then K22 and K23 against their plain versions (exact: scores,
    carries, pointer bytes, the walked masks, which score to the DP
    score), K20 (exact) and K21 (1e-12 relative) on the HMM batches of
    T <= HMM_CHECK_MAX_T and the longest one, and K2 at 64 and 1,000
    slots a row (find_mums on 64 genomes, GPU == CPU tensors; find_repeats
    on a 1,000-copy family), in shared memory and in global scratch.
    Returns ({name: entry}, the counted run's launches, K2's
    max_abs_err)."""
    from libmems_tpu_torch import matchfind, repeats
    from libmems_tpu_torch.ops import extend, gapped, hmm
    from libmems_tpu_torch.sml import create_smls
    wrappers = {"gotoh_forward": gapped.gotoh_forward,
                "gotoh_block_ptrs": gapped.gotoh_block_ptrs,
                "traceback_walk": gapped.traceback_walk,
                "viterbi_path": hmm.viterbi_path,
                "bw_counts": hmm.bw_counts}
    go, ge = gapped.GAP_OPEN, gapped.GAP_EXTEND

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    genomes = genome_pair(lt, 0)
    smls, seed = create_smls(genomes, device=dev)
    win_pairs = [(w[2][0], w[2][1])
                 for w in pair_windows(lt, genomes, smls, seed, dev)]
    del smls, genomes
    mut_pairs = mutant_pairs()
    by_call = [(a["sequences"], a["params"] or hmm.hoxd_params())
               for a in hmm_calls]
    corpus = [q for seqs, _ in by_call for q in seqs]
    require(len(corpus) > 0, "no recorded HMM sequences")

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    win_masks = gapped.align_pairs(win_pairs, device=dev)
    t1 = time.perf_counter()
    mut_masks = gapped.align_pairs(mut_pairs, device=dev)
    t2 = time.perf_counter()
    for seqs, params in by_call:
        hmm.viterbi_homologous(seqs, params, device=dev)
    t3 = time.perf_counter()
    _, lls = hmm.baum_welch(corpus, by_call[0][1], iterations=2, device=dev)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"# decode run: align_pairs on {len(win_pairs)} pair windows "
        f"{t1 - t0:.3f} s, on {len(mut_pairs)} x {MUTANT_PAIR_LEN} bp mutant "
        f"pairs {t2 - t1:.3f} s; viterbi_homologous on {len(corpus)} "
        f"sequences {t3 - t2:.3f} s; baum_welch (2 iterations) "
        f"{t4 - t3:.3f} s, log-likelihoods {lls}; launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name}: no launch on the decode run")
    require(len(lls) == 2 and all(np.isfinite(lls)),
            "baum_welch log-likelihoods")
    win_plan = list(gapped.plan_pairs(win_pairs))
    mut_plan = list(gapped.plan_pairs(mut_pairs))
    require(all(p[6] for p in win_plan),
            "a pair-window bucket missed the device walk")
    require(len(mut_plan) == 1 and not mut_plan[0][6],
            "the mutant pairs missed the checkpointed route")
    log(f"# routes: pair windows in buckets "
        f"{sorted((p[1].shape, p[2].shape[1]) for p in win_plan)} walked "
        f"on the card; mutant pairs {mut_plan[0][1].shape} x "
        f"{mut_plan[0][2].shape[1]} checkpointed")
    res = {}

    # the full route: K23 from the first row, the walked masks score to
    # the DP score, and equal the CPU tensors' masks
    k23, errs23 = [], []
    for idxs, a, b, al, bl, K, _ in win_plan:
        aj, bj = put(a), put(b)
        k23.append((None, None, aj, bj, False))
        score = gapped.gotoh_forward(aj, bj, put(al), put(bl), go, ge, K,
                                     carries=False)[0].cpu().numpy()
        for row, idx in enumerate(idxs):
            (x, y), (ga, gb) = win_pairs[idx], win_masks[idx]
            require(affine_score(x, y, ga, gb, go, ge, gapped.HOXD70)
                    == score[row], f"pair window {idx}: the walk's score "
                    f"differs from the DP score")
    cpu_masks = gapped.align_pairs(win_pairs, device="cpu")
    for (ga, gb), (ca, cb) in zip(win_masks, cpu_masks):
        require(np.array_equal(ga, ca) and np.array_equal(gb, cb),
                "pair windows: GPU masks differ from CPU tensors")
    log(f"# full route: {len(win_pairs)} windows score to the DP score; "
        f"masks GPU == CPU tensors")

    # the checkpointed route: K22 and the packed K23 blocks
    idxs, a, b, al, bl, K, _ = mut_plan[0]
    aj, bj, alj, blj = put(a), put(b), put(al), put(bl)
    B, Mp = a.shape
    N = b.shape[1]
    got22 = gapped.gotoh_forward(aj, bj, alj, blj, go, ge, K)
    ref22, p22 = timed_once(lambda: gapped.gotoh_forward_plain(
        aj, bj, alj, blj, go, ge, K), torch)
    for g, r, what in zip(got22, ref22, ("scores", "ck_h", "ck_f")):
        require(torch.equal(g, r), f"K22 {what} differ from the plain "
                f"version at {tuple(a.shape)} x {N}")
    ms22 = timed_ms(lambda: gapped.gotoh_forward(aj, bj, alj, blj, go, ge,
                                                 K), 3, torch)
    res["gotoh_forward"] = entry(
        max_abs_err(zip(got22, ref22)), ms22, p22,
        work(nbytes(aj, bj, alj, blj, *got22),
             GOTOH_CELL_OPS * B * Mp * (N + 1)))
    nb = Mp // K
    k23 += [(got22[1][bi], got22[2][bi],
             aj[:, bi * K:(bi + 1) * K].contiguous(), bj, True)
            for bi in range(nb)]
    got23 = [gapped.gotoh_block_ptrs(h, f, x, y, go, ge, packed=pk)
             for h, f, x, y, pk in k23]
    ref23 = [gapped.gotoh_block_ptrs_plain(h, f, x, y, go, ge, pk)
             for h, f, x, y, pk in k23]
    for (_, _, x, _, pk), g, r in zip(k23, got23, ref23):
        require(torch.equal(g, r), f"K23 differs from its plain version "
                f"at {tuple(x.shape)} (packed {pk})")
        errs23.append((g, r))
    fetched = []   # the blocks the walk reads: the counted run's launches

    def fetch(bi):
        fetched.append(bi)
        return gapped.unpack_ptrs(ref23[len(win_plan) + bi].cpu().numpy(),
                                  N + 1)
    walked = gapped.traceback_blocks(fetch, nb, K, al, bl)
    dp = ref22[0].cpu().numpy()
    for row, idx in enumerate(idxs):
        (x, y), (ga, gb) = mut_pairs[idx], mut_masks[idx]
        require(np.array_equal(walked[row][0], ga)
                and np.array_equal(walked[row][1], gb),
                f"mutant pair {idx}: masks differ from the plain blocks'")
        require(affine_score(x, y, ga, gb, go, ge, gapped.HOXD70)
                == dp[row], f"mutant pair {idx}: the walk's score differs "
                f"from the DP score")
    # time and bound the launches the counted run made: every window
    # bucket and the blocks the walk fetched (the comparison covers all)
    run23 = list(range(len(win_plan))) + [len(win_plan) + bi
                                          for bi in fetched]
    require(len(run23) == launches["gotoh_block_ptrs"],
            f"K23: {len(run23)} launches rebuilt, the decode run made "
            f"{launches['gotoh_block_ptrs']}")
    p23 = timed_once(lambda: [gapped.gotoh_block_ptrs_plain(
        *k23[i][:4], go, ge, k23[i][4]) for i in run23], torch)[1]
    ms23 = timed_ms(lambda: [gapped.gotoh_block_ptrs(
        *k23[i][:4], go, ge, packed=k23[i][4]) for i in run23], 3, torch)
    cells = sum(k23[i][2].shape[0] * k23[i][2].shape[1]
                * (k23[i][3].shape[1] + 1) for i in run23)
    res["gotoh_block_ptrs"] = entry(
        max_abs_err(errs23), ms23, p23,
        work(sum(nbytes(*k23[i][:4], got23[i]) for i in run23),
             GOTOH_PTR_CELL_OPS * cells))
    del got23, ref23, got22, ref22
    log(f"# checkpointed route: K22 and {nb} packed K23 blocks equal the "
        f"plain versions; masks equal, scores {dp[:len(idxs)].tolist()}; "
        f"K23 timed on the {len(run23)} launches of the decode run "
        f"({len(fetched)} blocks fetched)")

    # K20 and K21 on the HMM batches up to HMM_CHECK_MAX_T and the longest
    batches = []
    for seqs, params in by_call:
        mats = hmm.log_matrices(params, dev)
        for _, obs, lens in hmm.pack_batches(seqs):
            batches.append((put(obs), put(lens), mats))
    longest = max(range(len(batches)),
                  key=lambda i: int(batches[i][1].max()))
    chosen = [t for i, t in enumerate(batches)
              if t[0].shape[1] <= HMM_CHECK_MAX_T or i == longest]
    require(any(t[0].shape[1] >= hmm.FB_SCAN_MIN_T for t in chosen),
            "no K21 batch of the chunked route's widths")
    cols = sum(int(n.sum()) for _, n, _ in chosen)
    rows = sum(int(n.numel()) for _, n, _ in chosen)
    log(f"# K20/K21 batches (B x T) compared: "
        f"{sorted(tuple(o.shape) for o, _, _ in chosen)} of "
        f"{len(batches)}, {cols} columns")
    got20 = [hmm.viterbi_path(*t) for t in chosen]
    ref20, p20 = timed_once(lambda: [hmm.viterbi_path_plain(*t)
                                     for t in chosen], torch)
    for (o, _, _), g, r in zip(chosen, got20, ref20):
        require(torch.equal(g, r), f"K20 differs from its plain version "
                f"at {tuple(o.shape)}")
    res["viterbi_path"] = entry(
        max_abs_err(zip(got20, ref20)),
        timed_ms(lambda: [hmm.viterbi_path(*t) for t in chosen], 3, torch),
        p20, work(2 * cols + 4 * rows, VITERBI_COLUMN_OPS * cols,
                  F64_OPS_PER_S))
    got21 = [hmm.bw_counts(*t) for t in chosen]
    ref21, p21 = timed_once(lambda: [hmm.bw_counts_plain(*t)
                                     for t in chosen], torch)
    rel = 0.0
    for g, r in zip(got21, ref21):
        d = (g - r).abs() / r.abs().clamp(min=1e-300)
        rel = max(rel, float(torch.where(g == r, 0.0, d).max()))
    require(rel <= 1e-12, f"K21 counts differ by {rel} relative")
    res["bw_counts"] = entry(
        max_abs_err(zip(got21, ref21)),
        timed_ms(lambda: [hmm.bw_counts(*t) for t in chosen], 3, torch),
        p21, work(cols + (4 + 8 * hmm.BW_COUNTS) * rows,
                  BW_COLUMN_OPS * cols, F64_OPS_PER_S))
    log(f"# K20 equal; K21 within {rel} relative")

    # K2 at 64 slots a row (find_mums' device pipeline, whose K14/K15
    # signature words then hold 64 mask and sign bits) and at 1,000
    # (find_repeats); the recorded names are the callers', so the
    # wrapper and its counter are untouched
    fam = wide_family(lt)
    with recording([(matchfind, "extend_matches")]) as c64:
        t_gpu = time.perf_counter()
        got = lt.find_mums(fam, device=dev)
        t_gpu = time.perf_counter() - t_gpu
    t5 = time.perf_counter()
    ref = lt.find_mums(fam, device="cpu")
    require(len(ref) > 0 and np.array_equal(got.starts, ref.starts)
            and np.array_equal(got.lengths, ref.lengths),
            f"find_mums on {WIDE_GENOMES} genomes: GPU ({len(got)}) differs "
            f"from CPU tensors ({len(ref)})")
    log(f"# find_mums on {WIDE_GENOMES} x {WIDE_LEN} bp: GPU == CPU tensors "
        f"({len(ref)} MUMs, {t_gpu:.3f} s on the GPU, "
        f"{time.perf_counter() - t5:.3f} s on CPU tensors)")
    with recording([(repeats, "extend_matches")]) as crep:
        t6 = time.perf_counter()
        reps = repeats.find_repeats(repeat_genome(lt), device=dev)
        t7 = time.perf_counter()
    widths = sorted({c["lefts"].shape[1] for c in crep["extend_matches"]})
    log(f"# find_repeats on {REPEAT_LEN} bp with {REPEAT_COPIES} copies: "
        f"{len(reps)} families in {t7 - t6:.3f} s, {len(widths)} K2 "
        f"launches, widths {widths[:3]} ... {widths[-3:]}")
    require(widths[-1] == REPEAT_COPIES,
            f"the widest K2 row has {widths[-1]} slots")
    wide = [c for c in c64["extend_matches"]
            if c["lefts"].shape[1] == WIDE_GENOMES]
    wide.append(max(crep["extend_matches"],
                    key=lambda c: c["lefts"].shape[1]))
    require(len(wide) == 2, "no K2 launch at 64 slots a row")
    errs2 = []
    names = list(inspect.signature(extend.extend_matches_plain).parameters)
    for c in wide:
        args = {k: c[k] for k in names}
        ref = extend.extend_matches_plain(**args)
        for scratch in (False, True):
            got = extend.extend_matches(**args, scratch=scratch)
            require(torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                                ref[1]),
                    f"K2 differs from its plain version at "
                    f"{tuple(args['lefts'].shape)} (global scratch "
                    f"{scratch})")
            errs2 += list(zip(got, ref))
        log(f"# K2 at {tuple(args['lefts'].shape)}: equal in shared memory "
            f"and in global scratch")
    for name in DECODE_KERNELS:
        e = res[name]
        log(f"# {name}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} "
            f"ms, max_abs_err {e['err']}")
    return res, launches, max_abs_err(errs2)


def swapped_pair(lt):
    """The 2 x 4.6 Mbp pair of bench.py with SWAP_LEN bases of genome b
    from SWAP_AT replaced by unrelated sequence (numpy rng 7): a swapped
    locus, such as another prophage or capsule cluster at the same site.
    Its inter-anchor window (34,003 x 34,000 columns) pads to the 39,366
    bucket, whose full pointer tensor is 1.44 GiB."""
    from bench import _synthetic_pair
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    a, b = _synthetic_pair(PAIR_LEN, rng_seed=0)
    b = b.copy()
    b[SWAP_AT:SWAP_AT + SWAP_LEN] = np.random.default_rng(7).integers(
        0, 4, SWAP_LEN).astype(np.uint8)
    return [lt.Genome(name="A", ascii=lut[a], codes=a),
            lt.Genome(name="B", ascii=lut[b], codes=b)]


def fractional_profiles(rng, B, n, M, N, n_p, n_q):
    """B window pairs of about n columns as n_p- and n_q-row profiles:
    aligned rows with 10% gaps and 5% substitutions, so the profiles
    hold fractions (1/3, 1/2) and the float order decides ties."""
    from libmems_tpu_torch.ops.profile import rows_to_profile

    def rows(n_rows, cols):
        base = rng.integers(0, 4, size=cols).astype(np.uint8)
        r = np.stack([base] * n_rows)
        r[rng.random(r.shape) < 0.1] = 4
        m = rng.random(r.shape) < 0.05
        r[m] = rng.integers(0, 4, size=int(m.sum()))
        r[:, (r == 4).all(axis=0)] = 0
        return r
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for r in range(B):
        cp = n - int(rng.integers(0, n // 20))
        cq = n - int(rng.integers(0, n // 20))
        p[r, :cp] = rows_to_profile(rows(n_p, cp))
        q[r, :cq] = rows_to_profile(rows(n_q, cq))
        pl[r], ql[r] = cp, cq
    return p, q, pl, ql


def ckpt_work(t, K):
    """Work of one K24 launch on the packed batch t: every cell of the
    padded [Mp, N+1] matrix (the carries span every column), the
    profiles and lengths read, the score and the carries written."""
    B, Mp, _ = t[0].shape
    N = t[1].shape[1]
    return work(nbytes(*t) + 4 * B + 8 * (Mp // K) * B * (N + 1),
                DP_CELL_OPS * B * Mp * (N + 1))


def block_work(a):
    """Work of one K25 launch (ck_h, ck_f, p_blk, q, q_len, ...): every
    cell of its rows, the carry and profiles read, the nibble-packed
    pointers written."""
    B, R, _ = a[2].shape
    N = a[3].shape[1]
    return work(nbytes(*a[:5]) + B * R * ((N + 2) // 2),
                DP_CELL_OPS * B * R * (N + 1))


def ckpt_vs_plain(torch, t, go, ge):
    """K24 and every K25 block against their plain versions on the launch
    t.  Returns the compared pairs."""
    from libmems_tpu_torch.ops import profile
    K = profile.CKPT_ROWS
    got = profile.profile_forward_ckpt(*t, go, ge, K)
    ref = profile.profile_forward_ckpt_plain(*t, go, ge, K)
    for g, r, what in zip(got, ref, ("score", "ck_h", "ck_f")):
        require(torch.equal(g, r), f"K24 {what} differs from its plain "
                f"version at {tuple(t[0].shape)} x {t[1].shape[1]}")
    pairs = list(zip(got, ref))
    for bi in range(t[0].shape[1] // K):
        pb = t[0][:, bi * K:(bi + 1) * K].contiguous()
        r = profile.profile_block_ptrs_plain(ref[1][bi], ref[2][bi], pb,
                                             t[1], t[3], go, ge)
        g = profile.profile_block_ptrs(got[1][bi], got[2][bi], pb, t[1],
                                       t[3], go, ge)
        require(torch.equal(g, r), f"K25 block {bi} differs from its plain "
                f"version at {tuple(pb.shape)} x {t[1].shape[1]}")
        pairs.append((g, r))
    return pairs


def phase_bounded(torch, lt, dev):
    """The memory-bounded routes.  (1) K24 and every K25 block against
    their plain versions on 2 windows of about 2,300 columns, one-hot and
    3+2-row profiles (exact).  (2) align + write_xmfa of the swapped-locus
    pair with max_gapped_window 40,000 (counted run): the 34,003 x 34,000
    window takes the checkpointed route (CKPT_STATS, K24 and K25
    launched); the same input with PTR_BUDGET raised here (K3 + K4 in one
    launch) writes the same XMFA bytes; both walls and device memory
    peaks printed.  (3) genome a's SML saved and loaded back memory-mapped
    equals the in-memory one; create_big through the native bridge
    (mem_limit 64 MB) writes save()'s bytes; find_mums_checkpointed over
    CKPT_CHUNKS ranges, stopped after range CKPT_STOP and resumed, equals
    find_mums and leaves an uninterrupted run's file bytes.  The phase
    (its plain versions on the counted launches aside) must end within
    BOUNDED_CAP_S.  (4) K24 and K25 timed, kernel and plain, over the
    counted run's launches, and compared there too.  Returns ({name:
    entry}, the counted run's launches, walls)."""
    import functools
    import shutil
    from libmems_tpu_torch import matchfind, native, trace
    from libmems_tpu_torch.ops import profile
    from libmems_tpu_torch.sml import SortedMerList, create_smls
    t_phase = time.perf_counter()
    go, ge = profile.GAP_OPEN, profile.GAP_EXTEND
    K = profile.CKPT_ROWS

    # 1. the kernels against their plain versions on small windows
    rng = np.random.default_rng(11)
    checks = {"one-hot": mutant_profiles(rng, 2, CKPT_CHECK_N,
                                         CKPT_CHECK_MP, CKPT_CHECK_MP),
              "3+2 rows": fractional_profiles(rng, 2, CKPT_CHECK_N,
                                              CKPT_CHECK_MP, CKPT_CHECK_MP,
                                              3, 2)}
    errs = {name: [] for name in BOUNDED_KERNELS}
    for label, arrays in checks.items():
        t = tuple(torch.from_numpy(x).to(dev) for x in arrays)
        pairs = ckpt_vs_plain(torch, t, go, ge)
        errs["profile_forward_ckpt"] += pairs[:3]
        errs["profile_block_ptrs"] += pairs[3:]
        log(f"# K24 and {len(pairs) - 3} K25 blocks equal their plain "
            f"versions on 2 {label} windows, {tuple(t[0].shape)} x "
            f"{t[1].shape[1]}")

    # 2. the full-width path: the checkpointed route, then one launch
    genomes = swapped_pair(lt)
    cfg = lt.AlignerConfig(gapped_alignment=True, recursive=False,
                           max_gapped_window=SWAP_WINDOW, device=dev)
    wrappers = {"profile_forward_ckpt": profile.profile_forward_ckpt,
                "profile_block_ptrs": profile.profile_block_ptrs,
                "profile_forward": profile.profile_forward}

    def run():
        for w in wrappers.values():
            w.launches = 0
        profile.CKPT_STATS.update(dict.fromkeys(profile.CKPT_STATS, 0))
        trace.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ivs, _ = lt.align(genomes, cfg)
        buf = io.StringIO()
        lt.write_xmfa(buf, ivs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_partition(ivs, genomes)
        return (buf.getvalue().encode(), dt,
                torch.cuda.max_memory_allocated(),
                {k: w.launches for k, w in wrappers.items()},
                dict(profile.CKPT_STATS), trace.stage_seconds())

    # the checkpointed route's wall inside the path (K24, K25, the walk)
    ckpt_walls = []
    real_ckpt = profile.ckpt_tracebacks

    @functools.wraps(real_ckpt)
    def timed_ckpt(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_ckpt(*args, **kw)
        ckpt_walls.append(time.perf_counter() - t0)
        return out

    profile.ckpt_tracebacks = timed_ckpt
    trace.set_enabled(True, stream=sys.stdout)
    try:
        with recording([(profile, "ckpt_tracebacks")]) as rec:
            xmfa_ck, dt_ck, peak_ck, launches, stats, stages = run()
    finally:
        trace.set_enabled(False)
        profile.ckpt_tracebacks = real_ckpt
    calls = rec["ckpt_tracebacks"]
    log(f"# bounded path: 2 x {PAIR_LEN} bp, locus {SWAP_AT}+{SWAP_LEN} "
        f"swapped, max_gapped_window {SWAP_WINDOW}: {dt_ck:.3f} s, peak "
        f"{peak_ck} bytes allocated, {len(xmfa_ck)} XMFA bytes; CKPT_STATS "
        f"{json.dumps(stats)}; launches {json.dumps(launches)}; "
        f"checkpointed launches "
        f"{[(tuple(c['p'].shape), c['q'].shape[1]) for c in calls]}, "
        f"their route {sum(ckpt_walls):.3f} s (K24, K25, fetches, host "
        f"walk)")
    log("# stages (bounded path): " + json.dumps(stages))
    require(stats["windows"] >= 1 and calls,
            "no window took the checkpointed route")
    for name in BOUNDED_KERNELS:
        require(launches[name] > 0, f"{name}: no launch on the bounded "
                f"path")
    for c in calls:
        Mp, N = c["p"].shape[1], c["q"].shape[1]
        require(profile.ckpt_route(Mp, N), f"the {Mp} x {N} launch fits "
                f"the pointer budget")
    saved = profile.PTR_BUDGET
    big = max(c["p"].shape[1] * (c["q"].shape[1] + 1) for c in calls)
    profile.PTR_BUDGET = big
    try:
        xmfa_full, dt_full, peak_full, l_full, s_full, _ = run()
    finally:
        profile.PTR_BUDGET = saved
    log(f"# the same input with PTR_BUDGET {big} (K3 + K4 in one launch): "
        f"{dt_full:.3f} s, peak {peak_full} bytes allocated; CKPT_STATS "
        f"{json.dumps(s_full)}; launches {json.dumps(l_full)}")
    require(s_full["windows"] == 0 and l_full["profile_forward"] > 0,
            "the raised budget did not take the one-launch route")
    require(xmfa_ck == xmfa_full, "the checkpointed route's XMFA differs "
            "from the one-launch route's")
    log(f"# XMFA byte-equal across the two routes ({len(xmfa_ck)} bytes)")

    # 3. SML persistence, the out-of-core build, the resumable search
    tmp = os.path.join(ROOT, "build", "chip_smoke_bounded")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        smls, seed = create_smls(genomes, device=dev)
        mem = smls[0]
        saved_path = os.path.join(tmp, "a.sml")
        t0 = time.perf_counter()
        mem.save(saved_path)
        t1 = time.perf_counter()
        disk = SortedMerList.load(saved_path, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for name in ("keys", "sorted_keys", "sorted_positions"):
            require(torch.equal(getattr(disk, name), getattr(mem, name)),
                    f"loaded SML {name} differs from the in-memory SML")
        require(native.available(), "the native SML builder did not build")
        big_path = os.path.join(tmp, "a_big.sml")
        t3 = time.perf_counter()
        built = SortedMerList.create_big(genomes[0], seed, big_path,
                                         scratch_dir=tmp,
                                         mem_limit=64 << 20, device=dev)
        t4 = time.perf_counter()
        with open(saved_path, "rb") as fh, open(big_path, "rb") as fb:
            require(fh.read() == fb.read(), "create_big's file differs from "
                    "save()'s")
        require(torch.equal(built.sorted_positions, mem.sorted_positions),
                "create_big's SML differs from the in-memory SML")
        log(f"# SML of genome a ({mem.n_windows} windows): save {t1 - t0:.3f}"
            f" s, memory-mapped load {t2 - t1:.3f} s, equal; create_big "
            f"(native, mem_limit 64 MB) {t4 - t3:.3f} s, file byte-equal to "
            f"save()'s ({os.path.getsize(big_path)} bytes)")

        class Stop(Exception):
            pass

        ref = lt.find_mums(smls, device=dev)
        whole = os.path.join(tmp, "whole")
        t5 = time.perf_counter()
        got = matchfind.find_mums_checkpointed(smls, whole,
                                               n_chunks=CKPT_CHUNKS,
                                               device=dev)
        t6 = time.perf_counter()
        real_replace = os.replace
        n_replaced = [0]

        def stop_after(src, dst):
            real_replace(src, dst)
            n_replaced[0] += 1
            if n_replaced[0] == 2 * CKPT_STOP:   # .matches, .json a range
                raise Stop
        part = os.path.join(tmp, "part")
        os.replace = stop_after
        try:
            matchfind.find_mums_checkpointed(smls, part,
                                             n_chunks=CKPT_CHUNKS,
                                             device=dev)
            require(False, "the search was not stopped")
        except Stop:
            pass
        finally:
            os.replace = real_replace
        with open(part + ".json") as fh:
            require(json.load(fh)["next_chunk"] == CKPT_STOP,
                    "the stopped state's cursor")
        t7 = time.perf_counter()
        resumed = matchfind.find_mums_checkpointed(smls, part,
                                                   n_chunks=CKPT_CHUNKS,
                                                   device=dev)
        t8 = time.perf_counter()
        for label, m in (("uninterrupted", got), ("resumed", resumed)):
            require(len(ref) > 0 and np.array_equal(m.starts, ref.starts)
                    and np.array_equal(m.lengths, ref.lengths),
                    f"find_mums_checkpointed ({label}, {len(m)}) differs "
                    f"from find_mums ({len(ref)})")
        for ext in (".matches", ".json"):
            with open(whole + ext, "rb") as fh, open(part + ext, "rb") as fb:
                require(fh.read() == fb.read(), f"the resumed run's {ext} "
                        f"differs from the uninterrupted run's")
        log(f"# find_mums_checkpointed, {CKPT_CHUNKS} ranges: uninterrupted"
            f" {t6 - t5:.3f} s, stopped after range {CKPT_STOP} then "
            f"resumed ({t8 - t7:.3f} s for the rest); both == find_mums "
            f"({len(ref)} MUMs), state files byte-equal")
        del smls, mem, disk, built
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"# bounded phase without the plain timings: {wall:.1f} s (cap "
        f"{BOUNDED_CAP_S} s)")
    require(wall <= BOUNDED_CAP_S, f"phase bounded took {wall:.1f} s, over "
            f"its {BOUNDED_CAP_S} s cap")

    # 4. K24 and K25 over the counted run's launches: kernel, plain, work
    t_plain = time.perf_counter()
    res = {}
    k24 = [(c["p"], c["q"], c["p_len"], c["q_len"]) for c in calls]
    got24 = [profile.profile_forward_ckpt(*t, go, ge, K) for t in k24]
    ref24, p24 = timed_once(lambda: [profile.profile_forward_ckpt_plain(
        *t, go, ge, K) for t in k24], torch)
    for t, g, r in zip(k24, got24, ref24):
        for x, y in zip(g, r):
            require(torch.equal(x, y), f"K24 differs from its plain version "
                    f"on the counted launch {tuple(t[0].shape)}")
            errs["profile_forward_ckpt"].append((x, y))
    ms24 = timed_ms(lambda: [profile.profile_forward_ckpt(*t, go, ge, K)
                             for t in k24], 1, torch, warmup=False)
    res["profile_forward_ckpt"] = entry(
        max_abs_err(errs["profile_forward_ckpt"]), ms24, p24,
        sum_work(ckpt_work(t, K) for t in k24))
    # the blocks the walk fetched: every block that holds a window row
    k25 = []
    for t, (_, ck_h, ck_f) in zip(k24, got24):
        pl = t[2].cpu().numpy()
        for bi in range(t[0].shape[1] // K):
            if bi == 0 or (pl > bi * K).any():
                k25.append((ck_h[bi], ck_f[bi],
                            t[0][:, bi * K:(bi + 1) * K].contiguous(), t[1],
                            t[3]))
    require(len(k25) == launches["profile_block_ptrs"],
            f"K25: {len(k25)} launches rebuilt, the counted run made "
            f"{launches['profile_block_ptrs']}")
    del ref24
    ref25, p25 = timed_once(lambda: [profile.profile_block_ptrs_plain(
        *a, go, ge) for a in k25], torch)
    for a, r in zip(k25, ref25):
        g = profile.profile_block_ptrs(*a, go, ge)
        require(torch.equal(g, r), f"K25 differs from its plain version on "
                f"a counted launch {tuple(a[2].shape)}")
        errs["profile_block_ptrs"].append((g, r))
    ms25 = timed_ms(lambda: [profile.profile_block_ptrs(*a, go, ge)
                             for a in k25], 1, torch, warmup=False)
    res["profile_block_ptrs"] = entry(
        max_abs_err(errs["profile_block_ptrs"]), ms25, p25,
        sum_work(block_work(a) for a in k25))
    for name in BOUNDED_KERNELS:
        e = res[name]
        log(f"# {name}: {launches[name]} launches, kernel {e['ms']:.3f} ms,"
            f" plain {e['plain_ms']:.3f} ms, max_abs_err {e['err']}")
    log(f"# K24/K25 plain versions on the counted launches: "
        f"{time.perf_counter() - t_plain:.1f} s")
    walls = (f"bounded path {dt_ck:.3f} s (peak {peak_ck} B), one-launch "
             f"route {dt_full:.3f} s (peak {peak_full} B)")
    return res, launches, walls


def shard_kernels_vs_plain(torch, lt, dev, genomes):
    """K26, K27 and K28 against their plain versions on the card at the
    pair path's shapes (4 shards on one card): K26 on every shard's slice
    of the 2 x 4.6 Mbp pair's table with route_cap slots a destination,
    K27 on shard 0's routed table (K13's flags), K28 on shard 0's extended
    rows.  Exact; each timed, kernel and plain, with CUDA events.
    Returns ({name: entry}, the shapes)."""
    from libmems_tpu_torch.ops import extend, mums, shard
    from libmems_tpu_torch.ops.mers import key_sentinel, sentinel_content
    from libmems_tpu_torch.parallel import shard as psh
    from libmems_tpu_torch.sml import create_smls
    smls, seed = create_smls(genomes, device=dev)
    mesh = psh.Mesh([dev] * MESH_SHARDS)
    lay = psh._Layout(smls, mesh)
    capacity, route_cap = psh._default_caps(lay.total, mesh.size, None,
                                            None)
    sent = key_sentinel(seed)
    res = {}

    # K26 on every shard's slice; timed on shard 0's
    for keys, base in lay.slices:
        args = (keys, base, sent, mesh.size, route_cap)
        got, ref = shard.route_fill(*args), shard.route_fill_plain(*args)
        for g, r in zip(got, ref):
            require(torch.equal(g, r), f"K26 differs from its plain version "
                    f"on the slice at row {base}")
    keys, base = lay.slices[0]
    args = (keys, base, sent, mesh.size, route_cap)
    ms = timed_ms(lambda: shard.route_fill(*args), 5, torch)
    plain_ms = timed_ms(lambda: shard.route_fill_plain(*args), 3, torch)
    T = keys.shape[0]
    res["route_fill"] = entry(0.0, ms, plain_ms, work(
        nbytes(keys) + 2 * 8 * mesh.size * route_cap, 12 * T))

    # K27 on shard 0's routed table
    tables, dropped = psh._route(mesh, lay.slices, sent, route_cap)
    require(dropped == 0, f"{dropped} rows dropped at route_cap {route_cap}")
    content, src, _ = tables[0]
    del tables
    flags = mums.mum_seed_flags(content, src, lay.keys[dev],
                                lay.seg_off[dev], 0, 1000,
                                sentinel_content(seed))
    G, seed_len = lay.G, lay.seed_len
    got = shard.shard_candidates(flags, G, capacity, seed_len)
    ref = shard.shard_candidates_plain(flags, G, capacity, seed_len)
    require(got.over == ref.over == 0, "K27: candidate rows over capacity")
    for g, r in zip(got[:-1], ref[:-1]):
        require(torch.equal(g, r), "K27 differs from its plain version")
    ms = timed_ms(lambda: shard.shard_candidates(flags, G, capacity,
                                                 seed_len), 5, torch)
    plain_ms = timed_ms(lambda: shard.shard_candidates_plain(
        flags, G, capacity, seed_len), 3, torch)
    n, R = content.shape[0], got.lengths.shape[0]
    res["shard_candidates"] = entry(0.0, ms, plain_ms, work(
        15 * n + 6 * R * G + 4 * R, n + 3 * R * G))

    # K28 on shard 0's extended rows
    lefts, lens = extend.extend_matches(
        lay.keys[dev], seed_len, max(seed_len, 128), *lay.gen_rows(dev, R),
        got.lefts, got.present, got.is_fwd, got.lengths, sent)
    valid = torch.ones(R, dtype=torch.bool, device=dev)
    dargs = (lefts, got.present, got.is_fwd, lens, valid)
    d_got, d_ref = shard.dedup_flags(*dargs), shard.dedup_flags_plain(*dargs)
    for g, r in zip(d_got, d_ref):
        require(torch.equal(g, r), "K28 differs from its plain version")
    ms = timed_ms(lambda: shard.dedup_flags(*dargs), 5, torch)
    plain_ms = timed_ms(lambda: shard.dedup_flags_plain(*dargs), 3, torch)
    # inputs read once, srows, slens and uniq written once
    res["dedup_flags"] = entry(0.0, ms, plain_ms, work(
        nbytes(*dargs) + 4 * R * G + 5 * R, 2 * R * G * (G + 2)))
    shapes = (f"{mesh.size} shards, slices of {T} rows, route_cap "
              f"{route_cap}, capacity {capacity}; shard 0: {n} routed rows, "
              f"{R} candidate rows, {int(d_got.uniq.sum())} unique")
    log(f"# K26-K28 equal their plain versions: {shapes}")
    return res, shapes


def phase_mesh(torch, lt, dev, refs, calls):
    """The single-process multi-device path with MESH_SHARDS shards on
    one card.  (1) K26-K28 against their plain versions at the pair's
    shapes.  (2) align of the 2 x 4.6 Mbp pair (rng 0, gapped, no
    recursion) with AlignerConfig(mesh=...): the sharded seeding's MUMs
    equal phase main's find_mums, align's MUMs and XMFA bytes equal phase
    main's; shard loads and retries printed.  (3) the 3 x 1.5 Mbp trio
    (rng 0): XMFA equal to phase trio's.  (4) the 9 x 1 Mbp family (rng
    0) through progressive_align(mesh=...) with refine=True, apply_backbone
    and the writers: the sharded pairwise matches equal phase
    progressive's find_pairwise_mums, XMFA, bbseq and bbcols bytes equal
    its first run's.  (5) phase progressive's recorded align_profile_batch
    calls split over a 2-shard mesh: merged rows equal mesh=None.  Launch
    counts of K26-K28 zeroed before each of (2)-(4), read after.  Within
    MESH_CAP_S.  Returns ({name: entry}, the pair run's launches,
    walls)."""
    from libmems_tpu_torch import trace
    from libmems_tpu_torch.ops import (extend, gapped, mers, mums, pairwise,
                                       profile, shard)
    from libmems_tpu_torch.ops.mers import key_sentinel
    from libmems_tpu_torch.parallel import shard as psh
    t_phase = time.perf_counter()
    mesh = psh.Mesh([dev] * MESH_SHARDS)
    genomes = genome_pair(lt, 0)
    res, _ = shard_kernels_vs_plain(torch, lt, dev, genomes)
    t_kernels = time.perf_counter() - t_phase

    wrappers = {"canonical_seed_keys": mers.canonical_seed_keys,
                "route_fill": shard.route_fill,
                "mum_seed_flags": mums.mum_seed_flags,
                "shard_candidates": shard.shard_candidates,
                "extend_matches": extend.extend_matches,
                "dedup_flags": shard.dedup_flags}
    pw_wrappers = {"canonical_seed_keys": mers.canonical_seed_keys,
                   "route_fill": shard.route_fill,
                   "run_flags": pairwise.run_flags,
                   "cluster_words": pairwise.cluster_words,
                   "cluster_reps": pairwise.cluster_reps,
                   "extend_matches": extend.extend_matches}
    seeded = []
    targets = [(psh, "_sharded_find_mums_once"),
               (psh, "_sharded_pairwise_once")]

    def counted(label, ws, fn):
        """fn() with the launch counts zeroed before and read after; the
        sharded seeders' passes and results recorded."""
        for w in ws.values():
            w.launches = 0
        seeded.clear()
        with recording(targets) as passes, keep_results(
                psh, ("sharded_find_mums", "sharded_find_pairwise_mums"),
                seeded):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = {k: w.launches for k, w in ws.items()}
        n_pass = sum(len(v) for v in passes.values())
        # K26 launches once for each non-empty slice of each pass
        slices = sum(sum(k.shape[0] > 0 for k, _ in c["lay"].slices)
                     for v in passes.values() for c in v)
        log(f"# mesh {label}: {dt:.3f} s, {n_pass} seeding pass(es) "
            f"({n_pass - 1} retries), {slices} non-empty slices, launches "
            f"{launches}")
        for name, n in launches.items():
            require(n > 0, f"{name}: no launch on the meshed {label} path")
        require(launches["route_fill"] == slices,
                f"K26: {launches['route_fill']} launches on the meshed "
                f"{label} path, {slices} non-empty slices")
        require(len(seeded) == 1, f"{label}: {len(seeded)} sharded seedings")
        return out, launches, dt

    # (2) the pair
    cfg = lt.AlignerConfig(gapped_alignment=True, recursive=False,
                           mesh=mesh, device=dev)

    def pair():
        trace.reset()
        ivs, mums_ = lt.align(genomes, cfg)
        buf = io.StringIO()
        lt.write_xmfa(buf, ivs)
        return mums_, buf.getvalue()

    trace.set_enabled(True, stream=io.StringIO())
    (mums_, xmfa), launches, dt_pair = counted("pair", wrappers, pair)
    stages = trace.stage_seconds()
    trace.set_enabled(False)
    ref = refs["pair"]
    for label, a, b in (("seeding", seeded[0], ref["found"]),
                        ("align", mums_, ref["mums"])):
        require(np.array_equal(a.starts, b.starts)
                and np.array_equal(a.lengths, b.lengths),
                f"meshed pair {label} MUMs ({len(a)}) differ from phase "
                f"main's ({len(b)})")
    require(xmfa == ref["xmfa"], "meshed pair XMFA differs from phase main's")
    smls = [s for s in lt.create_smls(genomes, device=dev)[0]]
    seed = smls[0].seed
    keys = torch.cat([s.keys for s in smls]).cpu().numpy()
    gid = np.repeat(np.arange(2, dtype=np.int32), [s.n_windows for s in smls])
    pos = np.concatenate([np.arange(s.n_windows, dtype=np.int32)
                          for s in smls])
    loads = psh.shard_loads(*psh.pad_table_for_mesh(
        keys, gid, pos, mesh.size, key_sentinel(seed)), mesh,
        smls[0].seed_weight)
    unsharded = " and ".join(f"{st.get('mum_find', 0.0):.4f}"
                             for st in ref["stages"])
    log(f"# meshed pair: {len(seeded[0])} seeding MUMs and {len(mums_)} "
        f"anchors equal phase main's, XMFA equal ({len(xmfa)} bytes); "
        f"shard loads {loads.tolist()}; mum_find "
        f"{stages.get('mum_find', 0.0):.4f} s meshed vs {unsharded} s "
        f"unsharded (phase main's two inputs); wall {dt_pair:.3f} s")

    # (3) the trio
    trio = family_trio(lt, 0)
    cfg3 = lt.AlignerConfig(gapped_alignment=True, recursive=False,
                            mesh=mesh, device=dev)

    def run_trio():
        ivs, _ = lt.align(trio, cfg3)
        buf = io.StringIO()
        lt.write_xmfa(buf, ivs)
        return buf.getvalue()

    xmfa3, _, dt_trio = counted("trio", wrappers, run_trio)
    require(xmfa3 == refs["trio"]["xmfa"],
            "meshed trio XMFA differs from phase trio's")

    # (4) the 9 x 1 Mbp family, refine=True
    nine = family_nine(lt, 0)
    pcfg = lt.ProgressiveConfig(mesh=mesh, device=dev)
    require(pcfg.refine, "the default ProgressiveConfig must refine")

    def run_nine():
        ivs, _ = lt.progressive_align(nine, pcfg)
        new_ivs, segs = lt.apply_backbone(ivs, device=dev)
        return write_outputs(lt, new_ivs, segs, len(nine))

    outs, _, dt_nine = counted("progressive", pw_wrappers, run_nine)
    want = refs["progressive"]
    got_pw, ref_pw = seeded[0], want["pairwise"]
    require(np.array_equal(got_pw.starts, ref_pw.starts)
            and np.array_equal(got_pw.lengths, ref_pw.lengths),
            f"meshed pairwise matches ({len(got_pw)}) differ from phase "
            f"progressive's ({len(ref_pw)})")
    for name, data in want["outs"].items():
        require(outs[name] == data, f"meshed progressive {name} differs")
    log(f"# meshed progressive: {len(got_pw)} pairwise matches, XMFA, "
        f"bbseq and bbcols equal phase progressive's first run")

    # (5) the window DP split over 2 shards
    dp = {"profile_forward": profile.profile_forward,
          "traceback_walk": gapped.traceback_walk,
          "banded_forward_ptrs": profile.banded_forward_ptrs,
          "banded_traceback_walk": profile.banded_traceback_walk,
          "profile_forward_ckpt": profile.profile_forward_ckpt,
          "profile_block_ptrs": profile.profile_block_ptrs}
    mesh2 = psh.Mesh([dev] * 2)
    n_win, t_whole, t_split = 0, 0.0, 0.0
    split_launches = dict.fromkeys(dp, 0)
    for c in calls:
        args = (c["p_rows"], c["q_rows"], c["gap_open"], c["gap_extend"])
        t0 = time.perf_counter()
        whole = profile.align_profile_batch(*args, device=dev, mesh=None)
        t1 = time.perf_counter()
        before = {k: w.launches for k, w in dp.items()}
        split = profile.align_profile_batch(*args, device=dev, mesh=mesh2)
        t_whole += t1 - t0
        t_split += time.perf_counter() - t1
        for k, w in dp.items():
            split_launches[k] += w.launches - before[k]
        for a, b in zip(whole, split):
            require(np.array_equal(a, b), "align_profile_batch split over "
                    "2 shards differs from the whole batch")
        n_win += len(whole)
    log(f"# align_profile_batch split over 2 shards == whole on "
        f"{len(calls)} recorded calls ({n_win} windows): whole "
        f"{t_whole:.3f} s, split {t_split:.3f} s, split launches "
        f"{split_launches}")
    wall = time.perf_counter() - t_phase
    log(f"# phase mesh: {wall:.1f} s (cap {MESH_CAP_S} s; K26-K28 checks "
        f"{t_kernels:.1f} s)")
    require(wall <= MESH_CAP_S, f"phase mesh took {wall:.1f} s, over its "
            f"{MESH_CAP_S} s cap")
    walls = (f"meshed pair {dt_pair:.3f} s, trio {dt_trio:.3f} s, "
             f"9 x {PROG_LEN} bp progressive {dt_nine:.3f} s "
             f"({MESH_SHARDS} shards on one card)")
    return res, launches, walls


def _pair_rows(tiles, mesh, route_cap, capacity):
    """The tiled path's init step on every shard: K26, then K13 at
    repeat tolerance 0 and K27 on each routed table."""
    from libmems_tpu_torch.ops import mums, shard
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.parallel import shard as psh
    tables, dropped = psh._route(mesh, tiles.slices, tiles.sentinel,
                                 route_cap)
    require(dropped == 0, f"{dropped} rows dropped at route_cap {route_cap}")
    rows = []
    for (content, src, rk), dev in zip(tables, mesh.local_devices()):
        f = mums.mum_seed_flags(content, src, rk, tiles.seg_off[dev], 0, 1000,
                                sentinel_content(tiles.seed), row_keys=True)
        rows.append(shard.shard_candidates(f, tiles.G, capacity,
                                           tiles.seed_len))
    return rows


def span_union(offs, S, C):
    """Keys of a tile that spans of C keys from the starts offs (inside
    [0, S)) cover: what K30 must read."""
    s = np.sort(offs[(offs >= 0) & (offs < S)])
    if len(s) == 0:
        return 0
    gaps = np.minimum(np.diff(s), C)
    return int(gaps.sum()) + C


def tiled_kernels_vs_plain(torch, dev, smls):
    """K29, K30 and K31 against their plain versions on the card at the
    pair path's shapes (4 shards on one card): the first fetch of side 0
    (every shard's first block of active rows), K29 on each shard's
    block, K30 on shard 0's received starts, K31 on shard 0's answered
    spans.  Exact; each timed, kernel and plain, with CUDA events.
    Returns ({name: entry}, the shapes)."""
    from libmems_tpu_torch.ops import tiled
    from libmems_tpu_torch.parallel import shard as psh
    mesh = psh.Mesh([dev] * MESH_SHARDS)
    n_dev, G = mesh.size, len(smls)
    seed_len = smls[0].seed_length
    C = max(seed_len, 512)
    tiles = psh._Tiles(smls, mesh, C)
    total0 = sum(s.n_windows for s in smls)
    capacity, route_cap = psh._default_caps(total0 + (-total0) % n_dev,
                                            n_dev, None, None)
    req_cap = max(128, 4 * (-(-capacity // n_dev)))
    rows = _pair_rows(tiles, mesh, route_cap, capacity)
    block = max(1, psh.FETCH_BYTES // (G * C * 8))
    blk = [torch.nonzero(r.present.any(dim=1)).flatten()[:block]
           for r in rows]
    res = {}

    # K29 on every shard's block; timed on shard 0's
    reqs = []
    for i, r in enumerate(rows):
        args = (blk[i], r.lefts, r.lengths, r.present, r.is_fwd,
                tiles.gen_off[dev], 0, C, seed_len, tiles.big, tiles.S, n_dev,
                req_cap)
        got, ref = tiled.tiled_requests(*args), tiled.tiled_requests_plain(
            *args)
        require(torch.equal(got.send, ref.send) and got.counts == ref.counts
                and torch.equal(got.where, ref.where)
                and got.dropped == ref.dropped == 0,
                f"K29 differs from its plain version on shard {i}")
        reqs.append(got)
        if i == 0:
            args0 = args
    ms = timed_ms(lambda: tiled.tiled_requests(*args0), 5, torch)
    plain_ms = timed_ms(lambda: tiled.tiled_requests_plain(*args0), 3, torch)
    Rb, n_sent = blk[0].shape[0], reqs[0].send.shape[0]
    res["tiled_requests"] = entry(0.0, ms, plain_ms, work(
        Rb * 8 + Rb * G * 6 + Rb * 4 + G * 4 + n_sent * 8 + Rb * G * 8,
        16 * Rb * G))

    # the exchange; K30 on shard 0's received starts
    recv = psh._exchange([list(torch.split(q.send, q.counts)) for q in reqs],
                         mesh)
    offs = torch.cat(recv[0])
    targs = (tiles.tiles[0], tiles.S, offs, C, tiles.sentinel)
    got, ref = tiled.tiled_serve(*targs), tiled.tiled_serve_plain(*targs)
    require(torch.equal(got, ref), "K30 differs from its plain version")
    del ref
    ms = timed_ms(lambda: tiled.tiled_serve(*targs), 5, torch)
    plain_ms = timed_ms(lambda: tiled.tiled_serve_plain(*targs), 3, torch)
    n_recv = offs.shape[0]
    res["tiled_serve"] = entry(0.0, ms, plain_ms, work(
        n_recv * 8 + 8 * span_union(offs.cpu().numpy(), tiles.S, C)
        + n_recv * C * 8, 2 * n_recv * C))

    # the answers' return; K31 on shard 0's block
    answers = []
    for tile, rv in zip(tiles.tiles, recv):
        spans = tiled.tiled_serve(tile, tiles.S, torch.cat(rv), C,
                                  tiles.sentinel)
        answers.append(list(torch.split(spans, [g.shape[0] for g in rv])))
    resp = torch.cat(psh._exchange(answers, mesh)[0])
    del answers, spans
    r = rows[0]

    def state():
        return (r.lefts.clone(), r.lengths.clone(),
                r.present.any(dim=1).clone())

    def k31_args(st):
        return (resp, reqs[0].where, blk[0], st[0], st[1], r.present,
                r.is_fwd, tiles.gen_cnt[dev], st[2], 0, C, seed_len,
                tiles.sentinel)
    st_k, st_p = state(), state()
    tiled.tiled_probe(*k31_args(st_k))
    tiled.tiled_probe_plain(*k31_args(st_p))
    for a, b in zip(st_k, st_p):
        require(torch.equal(a, b), "K31 differs from its plain version")
    fresh = [state() for _ in range(6)]
    ms = timed_ms(lambda: tiled.tiled_probe(*k31_args(fresh.pop())), 5,
                  torch)
    fresh = [state() for _ in range(4)]
    plain_ms = timed_ms(lambda: tiled.tiled_probe_plain(
        *k31_args(fresh.pop())), 3, torch)
    n_ans = int((reqs[0].where >= 0).sum())
    res["tiled_probe"] = entry(0.0, ms, plain_ms, work(
        Rb * 8 + Rb * G * 8 + Rb * G * 6 + Rb * 4 + G * 4 + n_ans * C * 8
        + Rb * G * 4 + Rb * 5, 10 * Rb * G * C))
    shapes = (f"{n_dev} shards, tiles of S = {tiles.S} + halo {tiles.halo} "
              f"keys, C = {C}, req_cap {req_cap}, blocks of {block} rows; "
              f"shard 0: {r.lengths.shape[0]} candidate rows, a block of "
              f"{Rb} rows, {n_sent} requests, {n_recv} received, "
              f"{n_ans} answered")
    log(f"# K29-K31 equal their plain versions: {shapes}")
    return res, shapes


def phase_tiled(torch, lt, dev, refs):
    """The position-tiled extension with MESH_SHARDS shards on one card.
    (1) K29-K31 against their plain versions at the pair's first fetch.
    (2) sharded_find_mums_tiled of the 2 x 4.6 Mbp pair (rng 0): its MUMs
    equal phase main's find_mums; launch counts of K26-K31 zeroed before
    and read after, probe rounds and fetches printed.  (3) Each shard's
    resident keys (S + halo) against the replicated table of
    sharded_find_mums, and the run's device memory peak.  Within
    TILED_CAP_S.  Returns ({name: entry}, the path's launches, walls)."""
    from libmems_tpu_torch.ops import mums, shard, tiled
    from libmems_tpu_torch.parallel import shard as psh
    t_phase = time.perf_counter()
    genomes = genome_pair(lt, 0)
    smls, _ = lt.create_smls(genomes, device=dev)
    res, _ = tiled_kernels_vs_plain(torch, dev, smls)
    t_kernels = time.perf_counter() - t_phase
    wrappers = {"route_fill": shard.route_fill,
                "mum_seed_flags": mums.mum_seed_flags,
                "shard_candidates": shard.shard_candidates,
                "tiled_requests": tiled.tiled_requests,
                "tiled_serve": tiled.tiled_serve,
                "tiled_probe": tiled.tiled_probe,
                "dedup_flags": shard.dedup_flags}
    mesh = psh.Mesh([dev] * MESH_SHARDS)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ma = psh.sharded_find_mums_tiled(smls, mesh)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: w.launches for k, w in wrappers.items()}
    stats = dict(psh.TILED_STATS)
    for name, n in launches.items():
        require(n > 0, f"{name}: no launch on the tiled path")
    want = refs["pair"]["found"]
    require(np.array_equal(ma.starts, want.starts)
            and np.array_equal(ma.lengths, want.lengths),
            f"tiled MUMs ({len(ma)}) differ from phase main's find_mums "
            f"({len(want)})")
    tiles = psh._Tiles(smls, mesh, max(smls[0].seed_length, 512))
    n_keys = sum(s.n_windows for s in smls)
    for t in tiles.tiles:
        require(t.shape[0] == tiles.S + tiles.halo < n_keys,
                f"a shard holds {t.shape[0]} keys, S + halo = "
                f"{tiles.S + tiles.halo}, the table {n_keys}")
    log(f"# tiled pair: {len(ma)} MUMs equal phase main's find_mums; "
        f"{dt:.3f} s, {stats['rounds']} probe rounds, {stats['fetches']} "
        f"fetches; launches {launches}; resident keys a shard "
        f"{(tiles.S + tiles.halo) * 8} bytes (S {tiles.S} + halo "
        f"{tiles.halo}) against the replicated table's {n_keys * 8} bytes "
        f"on each device of sharded_find_mums; device memory peak {peak} B")
    wall = time.perf_counter() - t_phase
    log(f"# phase tiled: {wall:.1f} s (cap {TILED_CAP_S} s; K29-K31 checks "
        f"{t_kernels:.1f} s)")
    require(wall <= TILED_CAP_S, f"phase tiled took {wall:.1f} s, over its "
            f"{TILED_CAP_S} s cap")
    return res, launches, (f"tiled pair seeding {dt:.3f} s ({MESH_SHARDS} "
                           f"shards on one card, peak {peak} B)")


def spawn_ranks(world, jobs, cap_s):
    """Run `jobs` in `world` processes of this script (rank_main), one
    NCCL rank a card (one process without a group where world is 1),
    each loading the kernels the parent built.  A rank that fails or
    outlives cap_s fails the run; every rank is ended.  Returns each
    rank's results."""
    import pickle
    import socket
    out = os.path.join(OUT_DIR, "ranks")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    logs = [open(os.path.join(out, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         str(world), str(port), out, ",".join(jobs)], cwd=ROOT, env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.perf_counter() + cap_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [p for p in procs if p.poll() is None]
        for p in late:
            p.kill()
        for p in procs:
            p.wait()
        for fh in logs:
            fh.close()
    tails = []
    for r, p in enumerate(procs):
        with open(os.path.join(out, f"rank{r}.log")) as fh:
            tails.append(fh.read()[-3000:])
    require(not late, f"{len(late)} rank(s) still running after {cap_s} s:"
            f"\n{tails[0]}")
    for r, p in enumerate(procs):
        require(p.returncode == 0, f"rank {r} exited {p.returncode}:\n"
                f"{tails[r]}")
    res = []
    for r in range(world):
        path = os.path.join(out, f"rank{r}.pkl")
        with open(path, "rb") as fh:
            res.append(pickle.load(fh))
        os.remove(path)
    return res


def digest(data) -> str:
    """sha256 of output text or bytes: what a rank reports of its
    outputs, and what the parent's are held to."""
    import hashlib
    return hashlib.sha256(data.encode() if isinstance(data, str)
                          else data).hexdigest()


def rank_main(argv) -> int:
    """One rank of spawn_ranks: RANK WORLD PORT OUT_DIR JOBS.  Jobs (comma
    separated): pair (multihost_find_mums in its three modes and
    multihost_align of the rng-0 pair), exchange (the pair's route
    exchange over the mesh, timed), trio (multihost_align of the rng-0
    trio), nine (multihost_progressive_align + apply_backbone + the
    writers of the rng-0 9 x 1 Mbp family).  Writes OUT_DIR/rank<RANK>.pkl:
    the MUM arrays, the output files' sha256 digests, the walls."""
    import pickle
    import torch
    import libmems_tpu_torch as lt
    from libmems_tpu_torch.parallel import multihost as mh
    rank, world, port = (int(x) for x in argv[:3])
    out, jobs = argv[3], argv[4].split(",")
    mh.initialize(f"localhost:{port}", world, rank)
    dev = rank_device(torch, rank)
    mesh = mh.global_mesh(MESH_SHARDS if world == 1 else None, device=dev)
    res = {"mesh": repr(mesh)}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def xmfa(ivs):
        buf = io.StringIO()
        lt.write_xmfa(buf, ivs)
        return digest(buf.getvalue())

    if "pair" in jobs or "exchange" in jobs:
        genomes = genome_pair(lt, 0)
    if "pair" in jobs:
        for mode, kw in (("default", {}), ("pairwise", {"pairwise": True}),
                         ("tiled", {"tiled": True})):
            ma, dt = timed(lambda: mh.multihost_find_mums(genomes, mesh=mesh,
                                                          **kw))
            res[mode] = (ma.starts, ma.lengths, dt)
        (ivs, _), dt = timed(lambda: mh.multihost_align(
            genomes, lt.AlignerConfig(gapped_alignment=True, recursive=False,
                                      device=dev, mesh=mesh)))
        res["pair"] = (xmfa(ivs), dt)
    if "exchange" in jobs and mesh.spans_processes:
        res["exchange"] = time_exchange(torch, lt, genomes, mesh, dev)
    if "trio" in jobs:
        (ivs, _), dt = timed(lambda: mh.multihost_align(
            family_trio(lt, 0), lt.AlignerConfig(
                gapped_alignment=True, recursive=False, device=dev,
                mesh=mesh)))
        res["trio"] = (xmfa(ivs), dt)
    if "nine" in jobs:
        nine = family_nine(lt, 0)

        def run_nine():
            ivs, _ = mh.multihost_progressive_align(
                nine, lt.ProgressiveConfig(device=dev, mesh=mesh))
            new_ivs, segs = lt.apply_backbone(ivs, device=dev)
            return {k: digest(v) for k, v in
                    write_outputs(lt, new_ivs, segs, len(nine)).items()}
        res["nine"] = timed(run_nine)
    if world > 1:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    return 0


def rank_device(torch, rank):
    """A rank's card, made current (multihost.initialize already did
    under NCCL)."""
    from libmems_tpu_torch.parallel import multihost as mh
    dev = torch.device("cuda", mh.local_rank(rank))
    torch.cuda.set_device(dev)
    return dev


def time_exchange(torch, lt, genomes, mesh, dev):
    """The pair's route exchange (key and source buffers, _all_to_all)
    over a mesh that spans processes, after this rank's K26: (bytes all
    ranks move, median ms of 5 after a warm-up, each between barriers)."""
    from libmems_tpu_torch.ops import shard
    from libmems_tpu_torch.ops.mers import key_sentinel
    from libmems_tpu_torch.parallel import shard as psh
    smls, seed = lt.create_smls(genomes, device=dev)
    lay = psh._Layout(smls, mesh)
    _, route_cap = psh._default_caps(lay.total, mesh.size, None, None)
    sends = [shard.route_fill(k, base, key_sentinel(seed), mesh.size,
                              route_cap) for k, base in lay.slices]
    times = []
    for _ in range(6):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psh._all_to_all([x.keys for x in sends], mesh)
        psh._all_to_all([x.src for x in sends], mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return 2 * 8 * mesh.size * mesh.size * route_cap, \
        statistics.median(times[1:])


def check_ranks(res, refs, jobs, pairwise):
    """Every rank's outputs equal the single-process runs': the pair's
    MUMs (find_mums for the default and tiled modes, find_pairwise_mums
    for pairwise) and XMFA (phase main), the trio's XMFA (phase trio),
    the 9 x 1 Mbp family's XMFA, bbseq and bbcols (phase progressive).
    Returns a line of walls."""
    walls = []
    for r, got in enumerate(res):
        if "pair" in jobs:
            for mode, want in (("default", refs["pair"]["found"]),
                               ("pairwise", pairwise),
                               ("tiled", refs["pair"]["found"])):
                st, ln, dt = got[mode]
                require(np.array_equal(st, want.starts)
                        and np.array_equal(ln, want.lengths),
                        f"rank {r}: multihost_find_mums {mode} ({len(ln)}) "
                        f"differs from the single-process run "
                        f"({len(want)})")
                if r == 0:
                    walls.append(f"{mode} {dt:.3f} s")
            require(got["pair"][0] == digest(refs["pair"]["xmfa"]),
                    f"rank {r}: multihost_align pair XMFA differs")
        if "trio" in jobs:
            require(got["trio"][0] == digest(refs["trio"]["xmfa"]),
                    f"rank {r}: multihost_align trio XMFA differs")
        if "nine" in jobs:
            for name, data in refs["progressive"]["outs"].items():
                require(got["nine"][0][name] == digest(data),
                        f"rank {r}: multihost 9 x {PROG_LEN} bp {name} "
                        f"differs")
    first = res[0]
    for job in ("pair", "trio", "nine"):
        if job in jobs:
            walls.append(f"{job} {first[job][1]:.3f} s")
    return ", ".join(walls)


def phase_multihost(torch, lt, dev, refs):
    """multihost_find_mums (default, pairwise, tiled) and multihost_align
    of the rng-0 pair in one NCCL rank a visible card, spawned after the
    parent built the kernels (one card: one process with a 4-shard mesh
    of its card): every rank's MUMs and XMFA equal phase main's (the
    pairwise MUMs find_pairwise_mums of the pair here).  Within
    MULTIHOST_CAP_S.  Returns (the pairwise reference, walls)."""
    t0 = time.perf_counter()
    pairwise = lt.find_pairwise_mums(genome_pair(lt, 0), device=dev)
    world = torch.cuda.device_count()
    res = spawn_ranks(world, ["pair"], MULTIHOST_CAP_S)
    walls = check_ranks(res, refs, ["pair"], pairwise)
    wall = time.perf_counter() - t0
    log(f"# multihost: {world} rank(s) ({res[0]['mesh']}): pair MUMs in "
        f"three modes and XMFA equal the single-process runs; rank 0 "
        f"{walls}; phase {wall:.1f} s (cap {MULTIHOST_CAP_S} s)")
    require(wall <= MULTIHOST_CAP_S, f"phase multihost took {wall:.1f} s, "
            f"over its {MULTIHOST_CAP_S} s cap")
    return pairwise, f"multihost pair ({world} rank(s)): {walls}"


@contextlib.contextmanager
def keep_results(mod, names, out):
    """Patch each name of mod so that every call's result is appended to
    out and returned unchanged."""
    saved = []
    for name in names:
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, **kw):
            r = _fn(*args, **kw)
            out.append(r)
            return r
        saved.append((name, fn))
        setattr(mod, name, rec)
    try:
        yield out
    finally:
        for name, fn in saved:
            setattr(mod, name, fn)


def phase_cards(torch, lt, dev, dp_calls):
    """The meshed pair over every visible card (make_mesh) against as many
    shards on one card, timed in turns (one card, cards, cards, one
    card): sharded_find_mums equal on both and its walls; the exchange
    alone (_all_to_all of the route's send buffers), its bytes and
    walls; align of the pair with the cards' mesh, XMFA equal to the
    unsharded run's.  With phase progressive's recorded
    align_profile_batch calls (dp_calls), those calls whole on one card
    (mesh=None) against the default split over the cards (mesh="auto"),
    in turns, merged rows equal.  Skipped with one card.  Returns the
    walls text or None."""
    from libmems_tpu_torch import cuda
    from libmems_tpu_torch.ops import profile, shard
    from libmems_tpu_torch.ops.mers import key_sentinel
    from libmems_tpu_torch.parallel import shard as psh
    n = torch.cuda.device_count()
    if n < 2:
        log("# phase cards: skipped, one card visible")
        return None
    many = psh.make_mesh()
    one = psh.Mesh([dev] * many.size)
    genomes = genome_pair(lt, 0)
    smls, seed = lt.create_smls(genomes, device=dev)

    def sync():
        for i in range(n):
            torch.cuda.synchronize(i)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    labels = {id(one): "one card", id(many): f"{n} cards"}
    seeding, exchange = {}, {}
    lays = {id(m): psh._Layout(smls, m) for m in (one, many)}
    caps = psh._default_caps(lays[id(one)].total, one.size, None, None)
    for mesh in (one, many, many, one):
        ma, dt = timed(lambda: psh.sharded_find_mums(smls, mesh))
        seeding.setdefault(labels[id(mesh)], []).append(dt)
        seeding.setdefault("mums " + labels[id(mesh)], ma)
        lay = lays[id(mesh)]
        sends = []
        for (k, base), d in zip(lay.slices, mesh.devices):
            with cuda.on(d):
                sends.append(shard.route_fill(k, base, key_sentinel(seed),
                                              mesh.size, caps[1]))
        _, dt = timed(lambda: (psh._all_to_all([x.keys for x in sends],
                                               mesh),
                               psh._all_to_all([x.src for x in sends],
                                               mesh)))
        exchange.setdefault(labels[id(mesh)], []).append(dt)
    a, b = seeding["mums one card"], seeding[f"mums {n} cards"]
    require(np.array_equal(a.starts, b.starts)
            and np.array_equal(a.lengths, b.lengths),
            f"sharded_find_mums over {n} cards differs from one card")
    moved = 2 * 8 * many.size * many.size * caps[1]
    cfg = lt.AlignerConfig(gapped_alignment=True, recursive=False,
                           device=dev)
    ref, dt_plain = timed(lambda: lt.align(genomes, cfg))
    got, dt_many = timed(lambda: lt.align(genomes, lt.AlignerConfig(
        gapped_alignment=True, recursive=False, device=dev, mesh=many)))
    bufs = []
    for ivs in (ref[0], got[0]):
        buf = io.StringIO()
        lt.write_xmfa(buf, ivs)
        bufs.append(buf.getvalue())
    require(bufs[0] == bufs[1], f"align over {n} cards differs from the "
            "unsharded XMFA")
    fmt = lambda xs: " / ".join(f"{x:.4f}" for x in xs)
    log(f"# cards: {len(a)} MUMs equal; sharded_find_mums one card "
        f"{fmt(seeding['one card'])} s, {n} cards "
        f"{fmt(seeding[f'{n} cards'])} s; exchange of {moved} bytes: "
        f"one card {fmt(exchange['one card'])} s, {n} cards "
        f"{fmt(exchange[f'{n} cards'])} s; align over {n} cards "
        f"{dt_many:.3f} s (unsharded {dt_plain:.3f} s), XMFA equal")
    walls = (f"pair seeding over {n} cards {fmt(seeding[f'{n} cards'])} s, "
             f"on one card {fmt(seeding['one card'])} s")
    if not dp_calls:
        log("# cards: no recorded align_profile_batch calls (phase "
            "progressive did not run), DP split not timed")
        return walls
    dp, rows = {}, {}
    for label, m in (("whole", None), ("split", "auto"), ("split", "auto"),
                     ("whole", None)):
        out, dt = timed(lambda: [profile.align_profile_batch(
            c["p_rows"], c["q_rows"], c["gap_open"], c["gap_extend"],
            device=dev, mesh=m) for c in dp_calls])
        dp.setdefault(label, []).append(dt)
        rows.setdefault(label, out)
    for wa, wb in zip(rows["whole"], rows["split"]):
        require(all(np.array_equal(x, y) for x, y in zip(wa, wb)),
                f"align_profile_batch split over {n} cards differs from "
                "the whole batch")
    n_win = sum(len(c["p_rows"]) for c in dp_calls)
    log(f"# cards: {len(dp_calls)} recorded align_profile_batch calls "
        f"({n_win} windows) whole on one card {fmt(dp['whole'])} s, split "
        f"over {n} cards (the default) {fmt(dp['split'])} s, merged rows "
        f"equal")
    return (walls + f"; DP calls whole {fmt(dp['whole'])} s, split over "
            f"{n} cards {fmt(dp['split'])} s")


def cards_processes(torch, lt, refs, pairwise):
    """With two or more cards: the second-card repair (align of the rng-0
    pair with device="cuda:1" while card 0 is current gives phase main's
    XMFA), then one NCCL rank a card on the pair (multihost_find_mums in
    three modes, multihost_align, the route exchange timed), the trio
    (multihost_align) and the 9 x 1 Mbp family
    (multihost_progressive_align, apply_backbone, the writers): every
    rank's outputs equal phases main, trio and progressive.  Returns the
    walls text."""
    n = torch.cuda.device_count()
    require(torch.cuda.current_device() == 0, "card 0 must be current")
    ivs, _ = lt.align(genome_pair(lt, 0), lt.AlignerConfig(
        gapped_alignment=True, recursive=False, device="cuda:1"))
    buf = io.StringIO()
    lt.write_xmfa(buf, ivs)
    require(buf.getvalue() == refs["pair"]["xmfa"],
            "align on cuda:1 (card 0 current) differs from phase main's "
            "XMFA on cuda:0")
    log("# cards: align with device=cuda:1 while card 0 is current gives "
        "phase main's XMFA")
    jobs = ["pair", "exchange", "trio", "nine"]
    res = spawn_ranks(n, jobs, CARDS_RANKS_CAP_S)
    walls = check_ranks(res, refs, jobs, pairwise)
    moved, ms = res[0]["exchange"]
    per_rank = " / ".join(f"{r['exchange'][1]:.3f}" for r in res)
    log(f"# cards: {n} NCCL ranks ({res[0]['mesh']}): the pair's MUMs in "
        f"three modes and XMFA, the trio's XMFA and the 9 x {PROG_LEN} bp "
        f"family's XMFA, bbseq and bbcols equal the single-process runs; "
        f"rank 0 {walls}; NCCL route exchange of {moved} bytes "
        f"{per_rank} ms (ranks 0-{n - 1}, median of 5)")
    return (f"{n} NCCL ranks: {walls}; route exchange {moved} bytes "
            f"{ms:.3f} ms")


def select_phases(argv):
    """The phases to run: those named on the command line (PHASES), all
    when none is, plus the progressive run that profile_dp and decode
    read their inputs from."""
    bad = [a for a in argv if a not in PHASES]
    if bad:
        raise SystemExit(f"unknown phase {bad}; phases: {' '.join(PHASES)}")
    want = set(argv or PHASES)
    if want & {"profile_dp", "decode"}:
        want.add("progressive")
    if want & {"mesh", "cards"}:
        want |= {"main", "trio", "progressive"}
    if want & {"tiled", "multihost"}:
        want.add("main")
    return [p for p in PHASES if p in want]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        return rank_main(argv[1:])
    import torch
    import libmems_tpu_torch as lt

    phases = select_phases(argv)
    card = phase_device(torch)
    dev = torch.device("cuda", 0)
    clock = [time.perf_counter()]

    def lap(name):
        clock.append(time.perf_counter())
        log(f"# phase {name}: {clock[-1] - clock[-2]:.1f} s")

    log(f"# phases: {' '.join(phases)}")
    phase_build()
    lap("build")
    res, paths, walls, k2_errs, refs, calls = {}, {}, [], [], {}, {}
    large = None
    if "kernels" in phases:
        res = phase_kernels(torch, lt, dev)
        res.update(phase_pairwise_kernels(torch, lt, dev))
        large = family_large(lt)
        occ_res, err = phase_seedocc_kernels(torch, lt, dev, large)
        res.update(occ_res)
        k2_errs.append(err)
        mum_res, err = phase_mum_kernels(torch, lt, dev)
        res.update(mum_res)
        k2_errs.append(err)
        sort_rows(torch, lt, dev)
        lap("kernels")
    if "goldens" in phases:
        phase_goldens(lt, dev)
        lap("goldens")
    if "main" in phases:
        paths["pair"], dt1, dt2, refs["pair"] = phase_main(torch, lt, dev)
        walls.append(f"pair path {dt1:.3f} s then {dt2:.3f} s")
        lap("main (pair)")
    if "trio" in phases:
        paths["trio"], tdt, refs["trio"] = phase_trio(torch, lt, dev)
        walls.append(f"trio path {tdt[0]:.3f} s then {tdt[1]:.3f} s")
        lap("trio")
    if "progressive" in phases:
        paths["progressive"], calls, pdt, refs["progressive"] = \
            phase_progressive(torch, lt, dev)
        walls.append(f"progressive path {pdt[0]:.3f} s then {pdt[1]:.3f} s")
        lap("progressive")
    if "large" in phases:
        paths["large"], ldt, calls["large_hmm"] = phase_large(
            torch, lt, dev, large or family_large(lt))
        walls.append(f"3 x {LARGE_LEN} bp path {ldt:.3f} s")
        lap("large")
    if "profile_dp" in phases:
        for name, e in phase_profile_dp(torch, dev, calls,
                                        paths["progressive"]).items():
            if name in res:
                e["err"] = max(e["err"], res[name]["err"])
            res[name] = e
        res["fb_posterior"] = phase_hmm(
            torch, dev, calls["predict_homologous"], paths["progressive"],
            calls.get("large_hmm"), paths.get("large"))
        lap("profile DP and hmm")
    if "decode" in phases:
        dec_res, paths["decode"], err = phase_decode(
            torch, lt, dev, calls["predict_homologous"])
        res.update(dec_res)
        k2_errs.append(err)
        lap("decode")
    if "bounded" in phases:
        b_res, paths["bounded"], b_walls = phase_bounded(torch, lt, dev)
        res.update(b_res)
        walls.append(b_walls)
        lap("bounded")
    if "mesh" in phases:
        m_res, paths["mesh"], m_walls = phase_mesh(
            torch, lt, dev, refs, calls["align_profile_batch"])
        res.update(m_res)
        walls.append(m_walls)
        lap("mesh")
    if "tiled" in phases:
        t_res, paths["tiled"], t_walls = phase_tiled(torch, lt, dev, refs)
        res.update(t_res)
        walls.append(t_walls)
        lap("tiled")
    pairwise = None
    if "multihost" in phases:
        pairwise, mh_walls = phase_multihost(torch, lt, dev, refs)
        walls.append(mh_walls)
        lap("multihost")
    if "cards" in phases:
        c_walls = phase_cards(torch, lt, dev,
                              calls.get("align_profile_batch"))
        if c_walls:
            walls.append(c_walls)
            if pairwise is None:
                pairwise = lt.find_pairwise_mums(genome_pair(lt, 0),
                                                 device=dev)
            walls.append(cards_processes(torch, lt, refs, pairwise))
        lap("cards")
    if "extend_matches" in res:
        res["extend_matches"]["err"] = max([res["extend_matches"]["err"]]
                                           + k2_errs)
    # launches: the 9 x 1 Mbp progressive path's, K13-K15 the trio's,
    # K18/K19 the pair's, K16/K17 the 3 x 8.7 Mbp path's, K20-K23 the
    # decode run's, K24/K25 the bounded path's, K26-K28 the meshed pair's,
    # K29-K31 the tiled pair's
    launches = dict(paths.get("progressive", {}))
    for path, names in (("trio", MUM_KERNELS), ("pair", PAIR_KERNELS),
                        ("large", SEEDOCC_KERNELS),
                        ("decode", DECODE_KERNELS),
                        ("bounded", BOUNDED_KERNELS),
                        ("mesh", MESH_KERNELS),
                        ("tiled", TILED_KERNELS)):
        if path in paths:
            launches.update({k: paths[path][k] for k in names})
    forbidden = [m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "libmems_tpu."))
                 or m == "libmems_tpu"]
    require(not forbidden, f"imported {forbidden[:5]}")
    kernels = []
    for name, e in res.items():
        src, replaces = SOURCES[name]
        bound_ms, bound_by = bound(e["work"])
        log(f"# work {name}: {e['work']['bytes']} bytes, "
            f"{e['work']['ops']} operations")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches.get(name),
                        "max_abs_err": e["err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    log(f"# card: {card}; " + "; ".join(walls))
    log(json.dumps({"kernels": kernels}))
    if phases != list(PHASES):
        # a partial run: its own result line, never the contract's
        log(json.dumps({"ok": True, "phases": phases}))
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
