#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (libmems_tpu_torch) on one GPU.

    python3 chip_smoke.py [--sweep] [phase ...]

With no argument every phase runs but the light fullwidth, wide, hmm,
hmmstage, runflags, seedwords, reps, extend, viterbi and requests;
naming phases (kernels, seeder, seedocc, goldens, main, trio,
progressive, large, profile_dp, decode, bounded, mesh, tiled, multihost,
cards, fullwidth, wide, hmm, hmmstage, runflags, seedwords, reps, extend,
viterbi, requests) runs only those, plus
the progressive run whose recorded inputs profile_dp, decode and hmm
read (and the large run for hmm, the main, trio and progressive runs
whose outputs mesh and cards are held to, the main run for tiled and
multihost).  Needs one NVIDIA Hopper GPU (compute capability 9.0) and the CUDA
toolkit's nvcc; builds the port's kernels from libmems_tpu_torch/csrc at
first use.  Phases, each raising on failure (the script then exits
non-zero and prints no result line):

1. device  - CUDA present, capability (9, 0); card name and power limit;
2. build   - compile the kernel library, report its build seconds;
3. kernels - each hand kernel but K5-K7, K16 and K17 against its plain
             PyTorch version on the card at its path's shapes (K1-K4,
             K18 and K19 the pair's, K13-K15 and K2 the first trio's;
             exact equality; K13 launch by launch too, and on the card
             apart from its host launch), with timings (K18's two passes timed
             without the library sort between them, which is timed
             apart; K4's walk bytes to the host and tb_unpack's seconds
             printed); K3 and K9 alone (fullwidth_checks): an empty
             launch timed by CUDA events, on the card alone and on the
             host clock (the launcher's host time), then launch by launch
             on the pair's windows, 1024 x 1024 and 4096 x 4096 shapes,
             fractional 3 + 2 and 4 + 5-row windows and the strip
             kernels' edge widths (q_len at 32K - 1, 32K, 32K + 1 for each
             lane width K; the wide route's boundary), exact in the
             launcher's geometry (the one the launch reports taking) and
             in every geometry that fits, each timed, with its latency
             floor;
3b. seeder - K5-K7 against their plain versions on the 9 x 1 Mbp
             seeder's table, then K5-K7 once more on the 3 x 8.7 Mbp
             family's (26 M rows, tens of thousands of tiles); exact
             equality, K5 (and K13 in phase 3) also launch by launch
             (run_flag_launches: the summaries, the flag pass on the
             plain summaries), with timings: K5 by events and on the
             card, each of its launches alone, K7 as the path runs it
             (its scan, the read of n_reps and the decode at the final
             capacity) and at the initial capacity, the sort of K6's
             words apart, and each pass of K6 and K7 alone;
3c. seedocc - K16 and K17 against their plain versions on one 8.7 Mbp
             genome of the 3 x 8.7 Mbp family (K16's tile summaries too;
             exact), timed through the wrappers and each launch alone
             (K16's summaries and its count pass, K17; through
             ops.seedocc's launch helpers), K16 then K17 back to back,
             and a scatter-only pass of the same positions; K1, K2, K18
             and K19 at that family's weight-17 seed; K16 on
             tests/test_torch_seedocc_tables.py's tables: a run over more
             than 32 tiles at 8.7 M rows, and 10 M rows of short runs
             against 10 M rows holding one content run of 10^6 rows (at
             most twice the time); K16 and K17 once more on a 1 Mbp
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
             printed; K7's decode launched once for each scan, and
             find_pairwise_mums of the first family launching K6, K7's
             scan and its decode once each;
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
             certificates, pointer bytes, the walks' column codes), each
             walk's bytes to the host, tb_unpack's host seconds and
             latency floor printed; K3 and K9 also launch by launch in
             every geometry, each timed (fullwidth_launches).  Where
             that run left K9
             no launch or no uncertified window, tests/test_banded.py's
             adversarial windows run the same routes as well; then
             K10, K11 and K12 on a many-window launch (2,112 windows in
             the 1024 bucket) and a wide-window one (three in the
             11,664 bucket, the longest 10,000 rows): exact, each
             launch's geometry printed, every geometry of the launcher's
             table forced and timed; K12 and K4 (on K3's pointers of the
             same windows) on both launches in every walk geometry that
             fits, exact and timed;
8. hmm     - K8 against its plain version on the card on the launches
             of the first progressive run's predict_homologous calls and
             of phase 6b's, rebuilt by hmm.plan_launches at their full
             lengths: the sequential route's ragged launches (fb_ragged,
             posteriors bit-equal, max_abs_err 0.0) and the chunked
             route's padded ones (fb_posterior, within 1e-12), calls
             equal; each route timed apart by events and on the card;
             one chain step's cycles by clock64 on one pair of lanes (the
             sequential route's latency floor); the HMM stage's device
             peak; the batches of padded width 2^17 and more (the chunked
             route) once more through the sequential route: its time,
             the largest posterior difference, the calls that differ (7
             and 8 are the phase "profile_dp");
9. decode  - decode and pairwise DP, the API no path calls: align_pairs
             on the pair path's inter-anchor windows (K23 + K4 on the
             card) and on 8 mutant pairs of 10 kbp (over the pointer
             budget: K22, packed K23 blocks a launch, the host walk),
             viterbi_homologous (K20, one ragged launch a call) on the
             first progressive run's HMM sequences (written to
             DECODE_CALLS) and 2 iterations of baum_welch (K21) on them;
             K22, K20 (the run's ragged launches and the padded batches
             up to HMM_CHECK_MAX_T and the longest, through viterbi_path)
             and every K23 call of the run (recorded, replayed) exact
             against their plain versions, K20's step cycles (clock64)
             and each launch's latency floor, K21 within 1e-12, the walked
             masks scoring to the DP score (K22, and K23's Σ, by events
             and on the card, beside their latency floors; with --sweep
             also K22 and K23's largest call in every geometry of
             SWEEP_GEOMETRIES beside span_cost's price); K2 at 64 and
             1,000 slots a row, in shared memory and global scratch
             (find_mums on 64 genomes GPU == CPU tensors, find_repeats on a
             1,000-copy element family);
10. bounded - the memory-bounded routes: K24 and K25 (batched and one
             block) exact against their plain versions on 2 windows of
             about 2,300 columns and 2,304 rows (one-hot, 3+2 rows), in
             the pick and in geometries spanning 2 and 10 blocks; align +
             write_xmfa of the 2 x 4.6 Mbp pair with a 34 kbp swapped
             locus at max_gapped_window 40,000: its 34,003 x 34,000 window
             takes the checkpointed route (K24, batched K25, the host
             walk; its time split into K24, K25, copies, unpack and
             walk), and the XMFA equals the same input's with PTR_BUDGET
             raised here (K3 on its wide route + K4, 1.44 GiB of
             pointers);
             genome a's SML saved, loaded memory-mapped and built by
             create_big (native, 64 MB) byte-equal; find_mums_checkpointed
             (8 ranges) stopped after range 3 and resumed == find_mums,
             with an uninterrupted run's file bytes; all within 90 s; then
             K24 and K25 on the counted launches by events and on the
             card alone, and their plain versions (K25's on its first and
             last launches); with --sweep also K24 and K25 in every
             geometry of SWEEP_GEOMETRIES beside span_cost's price;
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
             first fetch, timed (K29 with its tally's read, K29-K31 on
             the card too, K31's bound its least probe);
             sharded_find_mums_tiled of the rng-0 pair equals
             phase main's find_mums (K26-K31 launched; probe rounds,
             fetches, each shard's S + halo resident keys against the
             replicated table, the memory peak printed); a second run
             times every K30 and K31 launch alone on the card and each
             fetch's request stage (every shard's K29 and the counts'
             read), their Σ beside their Σ bound, and the concatenation
             of each shard's returned answers; a third counts the
             synchronising operations a fetch; within 90 s;
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
             backbone, writers), byte-equal to phases 5, 5b and 6;
fullwidth - (named runs only) K3 and K9 alone, as phase 3 holds them, on
             the rng-0 pair's windows and the shapes; with the progressive
             phase, each of its K3 and K9 launches too;
wide     - (named runs only) K3 and K9 on their wide route (a 4,608- and
             an 11,664-column bucket), exact and timed, through the
             wrappers alone, so that it times an older tree as well;
hmm      - (named runs only) phase 8 alone, with the progressive and
             large runs it reads its inputs from; it also writes both
             paths' predict_homologous calls to HMM_CALLS;
hmmstage - (named runs only) those calls, read back from HMM_CALLS,
             through predict_homologous as each path makes them: the
             stage's wall, its device time by kernel (torch.profiler)
             and its device peak.  It calls only predict_homologous, so
             the same phase copied into an older tree's archive (with
             HMM_CALLS) times that tree.
runflags - (named runs only) K5 and K13 through their wrappers alone
             (phase_runflags); it times an older tree's archive as well;
seedwords - (named runs only) K1 at 1, 4.6 and 8.7 Mbp with and without
             N runs, K18's wrapper and its two passes on the pair's rows,
             the seed-word and cluster-word sorts beside them, by events,
             on the card and on the host (phase_seedwords); it times an
             older tree's archive as well.
reps     - (named runs only) K15 on the trio's sorted signature rows (the
             call at the first capacity guess and the main path's whole
             step), K19 on the pair's sorted cluster words and K7 on the
             9 x 1 Mbp family's, through the wrappers and each launch
             alone, by events, on the card and on the host (phase_reps);
             it times an older tree's archive as well.
extend   - (named runs only) K2's call on the pair, trio, 9 x 1 Mbp and
             3 x 8.7 Mbp paths and its wide route at 64 genomes, K14's on
             the trio, recorded at their call sites, each alone by
             events, on the card and on the host (phase_extend); it
             times an older tree's archive as well.
viterbi  - (named runs only) the decode run's viterbi_homologous calls,
             read back from DECODE_CALLS: their wall, launches, K20's
             card time (torch.profiler) and the chosen padded batches
             through viterbi_path (phase_viterbi); copied with
             DECODE_CALLS into an older tree's archive it times that
             tree as well.
requests - (named runs only) K29 at the tiled pair's first fetch with
             its counts' host reads, each fetch's request stage over a
             run, the synchronising operations a fetch, K29's card time
             (torch.profiler) and the seeding wall (phase_requests); it
             times an older tree's archive as well.

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
import functools
import inspect
import io
import json
import os
import re
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
    "viterbi_ragged": ("libmems_tpu_torch/csrc/hmm.cu",
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
# the full-width DP's latency floor (K3, K9): a row depends on the row
# above through at least DP_ROW_OPS dependent float32 operations of a cell
# (fo's two adds, F's max, G's max, Wv's add and subtract, e's add, H's
# max) and E's prefix maximum over the row's q_len + 1 columns, at best
# ceil(log2(q_len + 1)) dependent maxima with every column in its own
# lane; each dependent operation waits DP_DEP_CYCLES (the FP32 pipeline's
# latency on Hopper).  A launch's floor is its longest window's rows at
# that many cycles a row, at SM_CLOCK_HZ; no communication is counted.
DP_ROW_OPS = 8
DP_DEP_CYCLES = 4
# cycles of the sleep kernel that hides the host's launch time (device_ms):
# about 1 ms, far above a wrapper's host time
SLEEP_CYCLES = 2_000_000
WALK_STEP_BYTES = 1   # per traceback step: one pointer byte
# the walks' latency floor: a step is at least one shared-memory load
# (about 30 cycles on Hopper) at the H100 SXM's boost clock
SMEM_STEP_CYCLES = 30
SM_CLOCK_HZ = 1.98e9
HMM_COLUMN_OPS = 60   # per HMM column: two passes of 2-state log-sum-exps
GOTOH_CELL_OPS = 3    # per pairwise DP cell (K22): F, the diagonal, g
GOTOH_PTR_CELL_OPS = 5  # K23: the same and the pointer byte's compares
VITERBI_COLUMN_OPS = 10  # per column (K20): 4 adds, 2 compares, 2 selects,
                         # a step of the walk
BW_COLUMN_OPS = 100   # per column (K21): K8's two passes, 6 exps and the
                      # count sums
DECODE_KERNELS = ("gotoh_forward", "gotoh_block_ptrs", "viterbi_ragged",
                  "bw_counts")
K23_WRAPPERS = ("gotoh_block_ptrs", "gotoh_block_ptrs_batch")
MUTANT_PAIRS, MUTANT_PAIR_LEN = 8, 10_000
REPEAT_LEN, REPEAT_COPIES, REPEAT_ELEM = 2_000_000, 1_000, 500
WIDE_GENOMES, WIDE_LEN = 64, 20_000
HMM_CHECK_MAX_T = 1 << 14   # K20/K21 vs plain: these batches + the longest
# the bounded phase: genome b of the pair with a swapped locus, one window
# over the pointer budget, K24/K25 vs plain on windows of about 2,300
SWAP_AT, SWAP_LEN, SWAP_WINDOW = 2_000_000, 34_000, 40_000
CKPT_CHECK_N, CKPT_CHECK_MP = 2_300, 2_304
# K24/K25's geometries on those windows: the launcher's pick, then forced
# (g, W) whose 2,305 columns span 2 blocks (K = 17, 3 strips a block) and
# 10 blocks (K = 1, 8 strips a block)
CKPT_CHECK_GEOMETRIES = (None, (0, 3), (7, 8))
# --sweep: forced geometries timed on the swapped locus's K24 launch and
# on its first K25 launch (bounded), for span_cost's fit, and on phase
# 9's K22 launch (decode)
SWEEP_GEOMETRIES = ((0, 1), (0, 4), (0, 7), (1, 4), (2, 4), (3, 2),
                    (3, 4), (4, 2), (5, 1), (5, 2), (5, 4), (6, 1),
                    (6, 2), (6, 4), (7, 1), (7, 4), (7, 8), (1, 7))
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
PHASES = ("kernels", "seeder", "seedocc", "goldens", "main", "trio",
          "progressive", "large", "profile_dp", "decode", "bounded", "mesh",
          "tiled", "multihost", "cards")
# phases only a named run takes: their checks are part of the full run's
# phases already
LIGHT_PHASES = ("fullwidth", "wide", "hmm", "hmmstage", "runflags",
                "seedwords", "reps", "extend", "viterbi", "requests")
# the HMM calls phase hmm records for phase hmmstage
HMM_CALLS = os.path.join(ROOT, "build", "chip_smoke_hmm", "calls.npz")
# the predict_homologous calls phase decode runs viterbi_homologous on,
# for phase viterbi
DECODE_CALLS = os.path.join(ROOT, "build", "chip_smoke_decode", "calls.npz")


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


def device_ms(fn, reps, torch):
    """Median milliseconds of fn()'s work on the card alone: a sleep
    kernel (torch.cuda._sleep, SLEEP_CYCLES) keeps the stream busy while
    the host enqueues fn, so the events bracket fn's kernels and not the
    host's time to launch them.  One untimed warm-up run first."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps, torch):
    """Median milliseconds of fn() on the host clock, synchronised before
    and after each run (the launcher's host time and the card's)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
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


class Patched:
    """A stand-in at a wrapper's module name: calls go through `run`, and
    attributes are the wrapper's, so that its launch count, which the
    wrapper adds to under its own module name, stays the wrapper's."""

    def __init__(self, fn, run):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_run", run)

    def __call__(self, *args, **kw):
        return self._run(*args, **kw)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


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
        setattr(mod, name, Patched(fn, rec))
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
    """The work of several launches; their latency floors (walks) add,
    as the launches run one after another."""
    ws = list(ws)
    out = work(sum(w["bytes"] for w in ws), sum(w["ops"] for w in ws))
    if any("latency_ms" in w for w in ws):
        out["latency_ms"] = sum(w.get("latency_ms", 0.0) for w in ws)
    return out


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
    (scores, certificates, pointer bytes: K11's of the computed cells,
    K3's whole [B, M, N+1] tensor, every byte of which it writes; the
    banded forward also reads the sorted gap costs) and DP_CELL_OPS a
    cell; K3 and K9 also carry their latency floor (dp_latency_ms)."""
    pl, ql = _lens(t)
    B = len(pl)
    io = int(((pl + ql) * 20).sum()) + 8 * B
    if name in ("profile_forward", "profile_forward_scores"):
        cells = int((pl * (ql + 1)).sum())
        # K3 writes every byte of its [B, M, N+1] pointer tensor
        out = 4 * B + (t[0].shape[0] * t[0].shape[1] * (t[1].shape[1] + 1)
                       if name == "profile_forward" else 0)
        w = work(io + out, DP_CELL_OPS * cells)
        w["latency_ms"] = dp_latency_ms(pl, ql)
        return w
    cells = band_cells(t, H_W)
    io += 4 * B * (t[0].shape[1] + t[1].shape[1])
    out = 5 * B + (cells if name == "banded_forward_ptrs" else 0)
    return work(io + out, DP_CELL_OPS * cells)


def dp_latency_ms(pl, ql):
    """The full-width DP's latency floor of a launch with these window
    lengths: its longest chain of rows, p_len x DP_DEP_CYCLES x
    (DP_ROW_OPS + ceil(log2(q_len + 1))) cycles, at SM_CLOCK_HZ."""
    if not len(pl):
        return 0.0
    depth = np.ceil(np.log2(np.asarray(ql, np.float64) + 1))
    cycles = np.asarray(pl, np.float64) * DP_DEP_CYCLES * (DP_ROW_OPS + depth)
    return float(cycles.max()) / SM_CLOCK_HZ * 1e3


def walk_work(walk):
    """Work of one traceback walk (a WalkCodes): a pointer byte a step
    taken, the lengths in and the codes, counts and steps out; and its
    latency floor, the longest window's steps at one shared-memory load
    a step."""
    steps = walk.steps.long()
    w = work(WALK_STEP_BYTES * int(steps.sum()) + 8 * steps.numel()
             + nbytes(walk), 10 * int(steps.sum()))
    w["latency_ms"] = (int(steps.max()) if steps.numel() else 0) \
        * SMEM_STEP_CYCLES / SM_CLOCK_HZ * 1e3
    return w


def walk_geometries(kind, launches):
    """The launcher's geometry of each K4 (kind "full") or K12
    ("banded") launch in launches, (pointer tensor, N or H_W) each, as
    'B@S: rows x depth (x cols), W windows a block', S the bytes a
    pointer row."""
    from libmems_tpu_torch.ops import gapped
    out = []
    for ptrs, n in launches:
        B, M, S = (int(x) for x in ptrs.shape)
        g = gapped.walk_geometry(kind, B, M, n)
        out.append(f"{B}@{S}: {g['rows']} x {g['depth']}"
                   f"{' x ' + str(g['cols']) if g['cols'] else ''}, "
                   f"{g['warps']}/block")
    return "; ".join(out)


def walk_host_tail(torch, outs):
    """(bytes, host seconds) of the walks' host tail over the outputs of
    a list of walk launches: the bytes each output copies to the host,
    and tb_unpack decoding every window of every launch (its copy to the
    host included), as the path's callers decode them."""
    from libmems_tpu_torch.ops import gapped
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for o in outs:
        gapped.tb_unpack(o, int(o[1].shape[-1]))
    return nbytes(outs), time.perf_counter() - t0


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
    log(f"# K18 cluster words: rows={n} candidates={got_n} "
        f"({got_n / n:.4f} of the rows) equal; K19 "
        f"representatives: {got_r.n_reps} reps in EC={EC} equal "
        f"(weight {smls[0].seed_weight}, pos_bits {pb})")
    if timed:
        wrap_ms = timed_ms(lambda: pair.pair_cluster_words(*wargs), 10,
                           torch)
        pack, flags = k18_passes(torch, *wargs)
        passes_ms = timed_ms(lambda: (pack(), flags()), 10, torch)
        res["pair_cluster_words"] = entry(
            max_abs_err([(got_w, ref_w)]),
            # K18's two passes alone: the sort of the seed words between
            # them is a library call inside the wrapper, timed apart
            passes_ms,
            timed_ms(lambda: pair.pair_cluster_words_plain(*wargs), 3,
                     torch, warmup=False),
            # the pack reads a key and writes a word a row, the flag pass
            # reads a sorted word a row and writes a word a candidate; ~25
            # integer operations a row: pack, four unpacks, compares
            work(k18_bytes(n, got_n), 25 * n))
        res["pair_cluster_words"]["card_ms"] = device_ms(
            lambda: (pack(), flags()), 10, torch)
        log(f"# K18's two passes {passes_ms:.3f} ms "
            f"({res['pair_cluster_words']['card_ms']:.4f} on the card); the "
            f"wrapper with its torch.sort {wrap_ms:.3f} ms")
        res["pair_reps"] = entry(
            max_abs_err(list(zip(got_r[:-1], ref_r[:-1]))),
            timed_ms(lambda: pair.pair_reps(*rargs), 10, torch),
            timed_ms(lambda: pair.pair_reps_plain(*rargs), 3, torch,
                     warmup=False),
            # its input is K18's n_cands words, a word index out a
            # representative, then the [EC] rows
            work(nbytes(cw, got_r[:-1]) + 4 * got_r.n_reps,
                 10 * cw.numel()))
        res["pair_reps"]["card_ms"] = device_ms(
            lambda: pair.pair_reps(*rargs), 10, torch)
        log(f"# K19 {res['pair_reps']['ms']:.4f} ms by events, "
            f"{res['pair_reps']['card_ms']:.4f} on the card")
        sort_ms = timed_ms(lambda: pairwise.usort(got_w), 10, torch)
        log(f"# torch.sort of the {got_n} cluster words (K19's input): "
            f"{sort_ms:.3f} ms")
    return res, got_r


def k18_bytes(n, n_cands):
    """Bytes K18's two passes must move over n rows with n_cands
    candidates: the pack reads a key and writes a word a row (16), the
    flag pass reads a sorted word a row (8) and writes a word a
    candidate."""
    return 24 * n + 8 * n_cands


def k18_passes(torch, keys_a, keys_b, pos_bits, sent_content):
    """(pack, flags): functions that launch K18's two passes as its
    wrapper does, without the library sort between them (the words are
    sorted once here).  The flag pass of a tree whose K18 writes a word
    a row (before the compaction) counts into a word its caller zeroes:
    it gets a fresh zero each call, as its wrapper gave it."""
    from libmems_tpu_torch import cuda
    from libmems_tpu_torch.ops import pair, pairwise
    lib = cuda.library()
    stream = cuda.stream(keys_a)
    na, nb = keys_a.shape[0], keys_b.shape[0]
    w = torch.empty(na + nb, dtype=torch.int64, device=keys_a.device)
    cw = torch.empty_like(w)
    compacted = hasattr(pair, "scan_scratch")
    scratch = pairwise.scan_scratch(na + nb, keys_a.device)

    def pack():
        cuda.check(lib.lm_pair_pack(keys_a.data_ptr(), na, keys_b.data_ptr(),
                                    nb, pos_bits, w.data_ptr(), stream),
                   "lm_pair_pack")
    pack()
    ws = pairwise.usort(w)
    k18_passes.words = w

    def flags():
        if not compacted:
            scratch[:1].zero_()
        cuda.check(lib.lm_pair_cluster_words(
            ws.data_ptr(), na + nb, pos_bits, sent_content, cw.data_ptr(),
            scratch.data_ptr(), stream), "lm_pair_cluster_words")
    return pack, flags


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


def pair_launches(lt, genomes, smls, seed, dev):
    """The pair path's inter-anchor windows (pair_windows) as the path
    launches them: (windows, [(M, N, packed tensors), one a launch])."""
    from libmems_tpu_torch.ops import profile
    windows = pair_windows(lt, genomes, smls, seed, dev)
    p_rows = [w[2][0][None] for w in windows]
    q_rows = [w[2][1][None] for w in windows]
    return windows, [
        (M, N, profile.pack_profiles(p_rows, q_rows, sub, M, N, dev))
        for M, N, sub in profile.plan_launches(p_rows, q_rows)]


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
    card = [device_ms(lambda: mers.canonical_seed_keys(codes, seed, a), 20,
                      torch) for a in (ambt, None)]
    res["canonical_seed_keys"]["card_ms"] = card[0]
    log(f"# K1 seed keys: n={k.numel()} equal; on the card {card[0]:.4f} ms "
        f"with N runs, {card[1]:.4f} without")

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
    # the path launches the representatives' rows only
    n_live = min(int(n_reps), EC)
    args = (keys, seed_len, chunk, off, cnt, lefts, present, is_fwd,
            lengths0, fill, False, n_live)
    kl, kn = extend.extend_matches(*args)
    rl, rn = extend.extend_matches_plain(*args[:-2], n_live=n_live)
    require(torch.equal(kl, rl) and torch.equal(kn, rn),
            "K2 differs from its plain version")
    live = int(present.any(dim=1).sum())
    res["extend_matches"] = entry(
        max_abs_err([(kl, rl), (kn, rn)]),
        timed_ms(lambda: extend.extend_matches(*args), 10, torch),
        timed_ms(lambda: extend.extend_matches_plain(*args[:-2],
                                                     n_live=n_live), 3,
                 torch, warmup=False),
        k2_work(inspect.signature(extend.extend_matches).bind(
            *args).arguments, (kl, kn)))
    log(f"# K2 extension: rows={EC} launched={n_live} live={live} "
        f"reps={int(n_reps)} max_len={int(kn.max())} equal")

    # K3/K4: the pair's inter-anchor window batch, launch by launch
    windows, packed = pair_launches(lt, genomes, smls, seed, dev)
    log(f"# window batch: {len(windows)} windows in {len(packed)} "
        f"launches, buckets {sorted({(M, N) for M, N, _ in packed})}")
    extra = fullwidth_shapes(torch, dev)

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
    walks = run4(packed, ptrs, gapped.traceback_walk)
    tail_b, tail_s = walk_host_tail(torch, walks)
    w4 = sum_work(walk_work(w) for w in walks)
    log(f"# K4 pair windows: {len(walks)} launches, walk output to the "
        f"host {tail_b} bytes, tb_unpack {tail_s:.6f} s; geometries "
        f"{walk_geometries('full', [(p, N) for (_, N, _), (p, _) in zip(packed, ptrs)])}"
        f"; latency floor {w4['latency_ms']:.4f} ms")
    res["traceback_walk"] = entry(
        max_abs_err(errs4),
        timed_ms(lambda: run4(packed, ptrs, gapped.traceback_walk), 5,
                 torch),
        timed_ms(lambda: run4(packed, ptrs, gapped.traceback_walk_plain),
                 1, torch, warmup=False),
        w4)
    for M, N, t in extra:
        ptr = profile.profile_forward(*t)[0]
        T = gapped._device_tb_T(M, N)
        k4 = timed_ms(lambda: gapped.traceback_walk(ptr, t[2], t[3], T), 3,
                      torch)
        p4 = timed_ms(lambda: gapped.traceback_walk_plain(ptr, t[2], t[3], T),
                      1, torch, warmup=False)
        log(f"# K4 at {M}x{N} B={t[0].shape[0]} "
            f"({walk_geometries('full', [(ptr, N)])}): kernel {k4:.3f} ms, "
            f"plain {p4:.3f} ms")
    # K3 and K9 alone: launch by launch, every geometry, the edge widths
    fw = fullwidth_checks(torch, dev, packed, extra)
    res["profile_forward"]["err"] = max(res["profile_forward"]["err"],
                                        max_abs_err(fw["profile_forward"]))
    k9 = [t for _, _, t in packed]
    res["profile_forward_scores"] = entry(
        max_abs_err(fw["profile_forward_scores"]),
        timed_ms(lambda: [profile.profile_forward_scores(*t) for t in k9],
                 5, torch),
        timed_ms(lambda: [profile.profile_forward_scores_plain(*t)
                          for t in k9], 1, torch, warmup=False),
        sum_work(dp_work("profile_forward_scores", t) for t in k9))
    for name, e in res.items():
        log(f"# {name}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} "
            f"ms, max_abs_err {e['err']}")
    return res


def phase_pairwise_kernels(torch, lt, dev, large=None):
    """K5-K7 against their plain versions on the card, on the seed table
    of the 9 x 1 Mbp family (rng 0); exact equality.  K7 is timed as the
    path runs it, at the capacity the path ends with (its scan, the read
    of n_reps and the decode), and at the initial capacity; the sort of
    the cluster words between K6 and K7 is timed apart.  With `large`
    (the 3 x 8.7 Mbp genomes), K6 and K7 once more on their seed table.
    Returns {name: entry}."""
    from libmems_tpu_torch.ops import pairwise

    res = {}
    t = seeder_table(torch, lt, dev, family_nine(lt, 0))
    args = t["flag_args"]
    got, ref = t["flags"], pairwise.run_flags_plain(*args)
    require(all(torch.equal(g, r) for g, r in zip(got, ref)),
            "K5 differs from its plain version")
    res["run_flags"] = entry(
        max_abs_err(list(zip(got, ref))),
        timed_ms(lambda: pairwise.run_flags(*args), 10, torch),
        timed_ms(lambda: pairwise.run_flags_plain(*args), 3, torch,
                 warmup=False),
        # ~10 integer operations a row: neighbour compares, run bounds
        work(nbytes(args, got), 10 * t["rows"]))
    res["run_flags"]["card_ms"] = device_ms(
        lambda: pairwise.run_flags(*args), 10, torch)
    log(f"# K5 run flags: rows={t['rows']} kept="
        f"{int(got.unique_occ.sum())} equal; "
        f"{res['run_flags']['ms']:.4f} ms by events, "
        f"{res['run_flags']['card_ms']:.4f} on the card")
    run_flag_launches(torch, args, None, "K5 on the 9 x 1 Mbp table")
    k6, k7, cw = seeder_k6_k7(torch, t, ref)
    res["cluster_words"] = entry(
        k6["err"], k6["ms"], k6["plain_ms"],
        work(nbytes(got, k6["words"]), 5 * k6["words"].numel()))
    # K7 needs only the valid words: the -1 words sort last, and a block
    # whose tile starts at one leaves without reading more
    out = nbytes(t["gen"], k7["reps"][:-1])
    res["cluster_reps"] = entry(
        k7["err"], k7["ms"], k7["plain_ms"],
        work(8 * k7["n_cands"] + out, 10 * k7["n_cands"]))
    log(f"# K7 bound's bytes: {8 * k7['n_cands'] + out} (the valid words "
        f"and the decode's outputs); all {cw.numel()} words counted, as "
        f"before, {nbytes(cw) + out} bytes, "
        f"{bound(work(nbytes(cw) + out, 10 * cw.numel()))[0]:.4f} ms")
    for name in ("run_flags", "cluster_words", "cluster_reps"):
        e = res[name]
        log(f"# {name}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} "
            f"ms, max_abs_err {e['err']}")
    if large is not None:
        t = seeder_table(torch, lt, dev, large)
        ref = pairwise.run_flags_plain(*t["flag_args"])
        require(all(torch.equal(g, r) for g, r in zip(t["flags"], ref)),
                "K5 differs from its plain version on the 3 x 8.7 Mbp table")
        run_flag_launches(torch, t["flag_args"], None,
                          "K5 on the 3 x 8.7 Mbp table")
        seeder_k6_k7(torch, t, ref)
    return res


def run_flag_launches(torch, args, span, label):
    """K5's (span None; args run_flags') or K13's (span = repeat_tolerance
    + 1; args mum_seed_flags') two launches each against its plain
    version on the card: the summaries, and the flag pass on the plain
    summaries with its look-back words zeroed; exact.  Each launch timed
    alone by CUDA events and on the card (device_ms), the flag pass with
    a zero fill of its look-back words, which is timed apart; and torch's
    gather keys[src] (the strands' random reads, the flag pass's floor),
    where keys are in position order."""
    from libmems_tpu_torch.ops import mums, pairwise
    content, src, keys, seg_off = args[:4]
    n, dev = content.shape[0], content.device
    scratch = pairwise.run_scratch(n, dev)
    words = pairwise.run_summary_words(scratch, n)
    pairwise._summaries(content, src, seg_off, span, scratch)
    ref_words = pairwise.run_summaries_plain(content, src, seg_off, span)
    require(torch.equal(words, ref_words),
            f"{label}: the summaries differ from their plain version")
    look = scratch[:scratch.shape[0] - words.shape[0]]
    look.zero_()
    i32 = dict(dtype=torch.int32, device=dev)
    u8 = dict(dtype=torch.uint8, device=dev)
    if span is None:
        _, _, _, _, limit, sent = args
        out = pairwise.RunFlags(torch.empty(n, dtype=torch.bool, device=dev),
                                torch.empty(n, **i32), torch.empty(n, **i32),
                                torch.empty(n, **i32), torch.empty(n, **u8))

        def flag_pass():
            pairwise._flag_pass(content, src, keys, seg_off, limit, sent,
                                scratch, out)
        flag_pass()
        ref = pairwise.run_flags_from_summaries_plain(
            content, src, keys, seg_off, ref_words, limit, sent)
    else:
        tol, limit, sent = args[4:7]
        row_keys = args[7] if len(args) > 7 else False
        out = mums.MumFlags(torch.empty(n, dtype=torch.bool, device=dev),
                            torch.empty(n, **i32), torch.empty(n, **u8), 0,
                            torch.empty(n, **i32), torch.empty(n, **i32),
                            torch.empty(n, **u8), tol)

        def flag_pass():
            mums._flag_pass(content, src, keys, seg_off, tol, limit, sent,
                            row_keys, scratch, out)
        flag_pass()
        out = out._replace(n_rows=int(scratch[1]))
        ref = mums.mum_flags_from_summaries_plain(
            content, src, keys, seg_off, ref_words, tol, limit, sent,
            row_keys)
    require(all(torch.equal(g, r) if hasattr(r, "shape") else g == r
                for g, r in zip(out, ref)),
            f"{label}: the flag pass differs from its plain version")

    def summaries():
        pairwise._summaries(content, src, seg_off, span, scratch)

    def filled_pass():
        look.zero_()
        flag_pass()
    ms = {}
    timed = [("summaries", summaries), ("flag pass", filled_pass),
             ("zero fill", look.zero_)]
    if span is None or not row_keys:
        timed.append(("keys[src] gather",
                      lambda: torch.index_select(keys, 0, src)))
    for name, fn in timed:
        ms[name] = (timed_ms(fn, 20, torch), device_ms(fn, 20, torch))
    tiles = pairwise.run_tiles(n)
    log(f"# {label}: {n} rows, {tiles} tiles, each launch equal to its "
        f"plain version; alone (events, card ms): " + "; ".join(
            f"{k} {e:.4f}, {c:.4f}" for k, (e, c) in ms.items()))
    return ms


def seeder_table(torch, lt, dev, genomes):
    """The pairwise seeder's table of `genomes` on the card as
    find_pairwise_mums builds it: K5's arguments and flags, G, pos_bits,
    the seed length, the genomes' offsets and counts."""
    from libmems_tpu_torch.matchfind import _pair_pos_bits
    from libmems_tpu_torch.ops import pairwise
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls
    smls, seed = create_smls(genomes, device=dev)
    cnts = [s.n_windows for s in smls]
    keys = torch.cat([s.keys for s in smls])
    seg_off = torch.from_numpy(np.concatenate([[0], np.cumsum(cnts)])
                               ).to(dev)
    c_sorted, src = torch.sort(pairwise.shr(keys, 1), stable=True)
    args = (c_sorted, src, keys, seg_off, 1000, sentinel_content(seed))
    return {"flag_args": args, "flags": pairwise.run_flags(*args),
            "G": len(smls), "rows": keys.numel(),
            "pos_bits": _pair_pos_bits(max(cnts)),
            "seed_len": smls[0].seed_length,
            "gen": (seg_off[:-1].to(torch.int32),
                    torch.tensor(cnts, dtype=torch.int32, device=dev))}


def seeder_k6_k7(torch, t, ref_flags):
    """K6, the word sort and K7 on the table t (seeder_table) against
    the plain versions (on ref_flags, K5's plain flags); exact, timed.
    K7 at the capacity the path ends with: the initial one if the
    representatives fit, else the power of two above their count.
    Returns (K6's {err, ms, plain_ms, words}, K7's {err, ms, plain_ms,
    reps, n_cands}, the sorted words)."""
    from libmems_tpu_torch.ops import pairwise
    G, pb, seed_len = t["G"], t["pos_bits"], t["seed_len"]
    flags = t["flags"]
    got_w = pairwise.cluster_words(flags, G, pb)
    ref_w = pairwise.cluster_words_plain(ref_flags, G, pb)
    require(torch.equal(got_w, ref_w),
            f"K6 differs from its plain version ({t['rows']} rows)")
    cw = pairwise.usort(got_w)
    ec0 = min(1 << 14, 1 << (max(t["rows"], 2) - 1).bit_length())
    got_r = pairwise.cluster_reps(cw, ec0, G, pb, seed_len, *t["gen"])
    ec = ec0
    if got_r.n_reps > ec0:
        ec = 1 << (got_r.n_reps - 1).bit_length()
        got_r = pairwise.cluster_reps(cw, ec, G, pb, seed_len, *t["gen"])
    ref_r = pairwise.cluster_reps_plain(cw, ec, G, pb, seed_len, *t["gen"])
    require(got_r.n_reps == ref_r.n_reps
            and all(torch.equal(g, r) for g, r in zip(got_r[:-1],
                                                      ref_r[:-1])),
            f"K7 differs from its plain version ({cw.numel()} words)")
    kept = int(flags.unique_occ.sum())
    n_valid = int((cw != -1).sum())
    log(f"# K6 cluster words: G={G} rows={t['rows']} kept={kept} "
        f"words={cw.numel()} ({n_valid} valid) equal; K7: "
        f"{got_r.n_reps} reps in EC={ec} equal")
    k6 = {"err": max_abs_err([(got_w, ref_w)]), "words": got_w}
    k7 = {"err": max_abs_err(list(zip(got_r[:-1], ref_r[:-1]))),
          "reps": got_r}
    gen = t["gen"]
    k6["ms"] = timed_ms(lambda: pairwise.cluster_words(flags, G, pb), 10,
                        torch)
    k6["plain_ms"] = timed_ms(
        lambda: pairwise.cluster_words_plain(ref_flags, G, pb), 3, torch,
        warmup=False)
    sort_ms = timed_ms(lambda: pairwise.usort(got_w), 10, torch)
    k7["ms"] = timed_ms(
        lambda: pairwise.cluster_reps(cw, ec, G, pb, seed_len, *gen), 10,
        torch)
    first_ms = timed_ms(
        lambda: pairwise.cluster_reps(cw, ec0, G, pb, seed_len, *gen), 10,
        torch)
    k7["plain_ms"] = timed_ms(
        lambda: pairwise.cluster_reps_plain(cw, ec, G, pb, seed_len, *gen),
        3, torch, warmup=False)
    log(f"# seeder on {t['rows']} rows: K6 {k6['ms']:.4f} ms; the "
        f"unsigned sort of its {cw.numel()} words {sort_ms:.4f} ms; K7 "
        f"at the final EC={ec} {k7['ms']:.4f} ms, at the initial "
        f"EC={ec0} {first_ms:.4f} ms; plain K6 {k6['plain_ms']:.3f} ms, "
        f"K7 {k7['plain_ms']:.3f} ms")
    seeder_passes(torch, t, cw, ec)
    k7["n_cands"] = n_valid
    return k6, k7, cw


def seeder_passes(torch, t, cw, ec):
    """K6's and K7's passes each timed alone (CUDA events), through the
    wrappers' own launch helpers: K6's compaction and its word pass, K7's
    scan and its decode at EC, each beside the bytes it moves; and one
    host read of an int64 from the card, the stall each of the two
    wrappers takes once."""
    from libmems_tpu_torch.ops import pairwise
    flags, G, pb, seed_len = t["flags"], t["G"], t["pos_bits"], t["seed_len"]
    gid_bits = pairwise.gid_bits_for(G)
    dev = flags.unique_occ.device
    n, m = flags.unique_occ.shape[0], cw.shape[0]
    rec = torch.empty(n, dtype=torch.int64, device=dev)
    scratch6 = pairwise.scan_scratch(n, dev)
    index = torch.empty(m, dtype=torch.int32, device=dev)
    scratch7 = pairwise.scan_scratch(m, dev)
    kept = int(pairwise._compact_kept(flags, pb, gid_bits, rec, scratch6))
    words = torch.empty(kept * (G - 1), dtype=torch.int64, device=dev)
    idx = pairwise.rep_index(cw, pb, seed_len)
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    ms = {name: timed_ms(fn, 20, torch) for name, fn in (
        ("compaction", lambda: pairwise._compact_kept(flags, pb, gid_bits,
                                                      rec, scratch6)),
        ("words", lambda: pairwise._word_pass(rec, kept, G, pb, gid_bits,
                                              words)),
        ("scan", lambda: pairwise._rep_scan(cw, pb, seed_len, index,
                                            scratch7)),
        ("decode", lambda: pairwise.decode_reps(cw, idx, ec, G, pb,
                                                seed_len, *t["gen"])),
        ("read", lambda: int(one[0])))}
    n_valid = int(idx.counts[0])
    log(f"# seeder blocks: K6 {pairwise.scan_tiles(n)} compaction tiles, "
        f"{-(-kept // 256)} word blocks; K7 {pairwise.scan_tiles(m)} scan "
        f"tiles, {pairwise.scan_tiles(n_valid)} of them with a valid word")
    moved = {"compaction": nbytes(flags) + 8 * kept,
             "words": 8 * kept * G,
             "scan": 8 * n_valid + 4 * idx.n_reps,
             "decode": 12 * min(idx.n_reps, ec) + 26 * ec}
    log("# seeder passes alone: " + "; ".join(
        f"{k} {v:.4f} ms" + (f" ({moved[k] / v / 1e6:.0f} GB/s of "
                             f"{moved[k]} bytes)" if k in moved else "")
        for k, v in ms.items()))


def tests_module(name):
    """tests/<name>.py, loaded by path: the card's machine has a `tests`
    package of its own."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seedocc_launches(torch, cargs, seed_len, label):
    """Each launch of K16 and K17 alone (CUDA events, through
    ops.seedocc's launch helpers, beside the bytes each must move): K16's
    tile summaries and its count pass, K17; K16 then K17 back to back
    through the wrappers, as the path runs them; and a scatter-only pass
    of the same positions (torch's scatter_ of int32 values at them, then
    at the identity permutation), which shows what K16's 4-byte scattered
    writes cost alone."""
    from libmems_tpu_torch.ops import seedocc
    keys, pos, L, sent = cargs
    n = keys.shape[0]
    dev = keys.device
    edges = torch.empty(2 * seedocc.seed_tiles(n), dtype=torch.int32,
                        device=dev)
    count = torch.empty(L, dtype=torch.int32, device=dev)
    smooth = torch.empty(L, dtype=torch.float32, device=dev)
    seedocc._tile_edges(keys, edges)
    seedocc._count_pass(keys, pos, edges, L, sent, count)
    at, seq = pos.long(), torch.arange(n, device=dev)
    vals = torch.ones(n, dtype=torch.int32, device=dev)
    sink = torch.empty(n, dtype=torch.int32, device=dev)
    ms = {name: timed_ms(fn, 20, torch) for name, fn in (
        ("K16 summaries", lambda: seedocc._tile_edges(keys, edges)),
        ("K16 counts", lambda: seedocc._count_pass(keys, pos, edges, L, sent,
                                                   count)),
        ("K17", lambda: seedocc._smooth_pass(count, seed_len, smooth)),
        ("K16 + K17", lambda: seedocc.seed_smooth(
            seedocc.seed_run_counts(*cargs), seed_len)),
        ("scatter at pos", lambda: sink.scatter_(0, at, vals)),
        ("scatter in order", lambda: sink.scatter_(0, seq, vals)))}
    moved = {"K16 counts": 16 * n, "K17": 8 * L,
             "scatter at pos": 16 * n, "scatter in order": 16 * n}
    log(f"# {label}: {n} rows, {seedocc.seed_tiles(n)} tiles, launches "
        "alone: " + "; ".join(
            f"{k} {v:.4f} ms" + (f" ({moved[k] / v / 1e6:.0f} GB/s of "
                                 f"{moved[k]} bytes)" if k in moved else "")
            for k, v in ms.items()))


def phase_seedocc_kernels(torch, lt, dev, genomes):
    """K16 and K17 against their plain versions on the card on one
    8.7 Mbp genome of the large family `genomes` (timed, each launch
    alone as well, and beside a scatter-only pass), K1, K18, K19 and K2 on
    that family's weight-17 tables (35-bit keys, 24 position bits), K16 on
    the tests' sorted tables at the path's sizes (a run over more than 32
    tiles at 8.7 M rows; 10 M rows of short runs and 10 M rows holding one
    content run of 10^6 rows, the second within twice the first's time),
    and K16 + K17 on one 1 Mbp genome beside the host twin; exact
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

    def k16_vs_plain(cargs, what):
        got = seedocc.seed_run_counts(*cargs)
        ref = seedocc.seed_run_counts_plain(*cargs)
        require(torch.equal(got, ref),
                f"K16 differs from its plain version ({what})")
        edges = torch.empty(2 * seedocc.seed_tiles(cargs[0].shape[0]),
                            dtype=torch.int32, device=dev)
        seedocc._tile_edges(cargs[0], edges)
        require(torch.equal(edges, seedocc.seed_tile_edges_plain(cargs[0])),
                f"K16's tile summaries differ from their plain version "
                f"({what})")
        return got, ref

    def occ_vs_plain(sml, reps):
        n, L = sml.n_windows, sml.length
        cargs = (sml.sorted_keys, sml.sorted_positions, L,
                 mers.key_sentinel(sml.seed))
        got_c, ref_c = k16_vs_plain(cargs, f"{n} windows")
        got_s = seedocc.seed_smooth(got_c, sml.seed_length)
        ref_s = seedocc.seed_smooth_plain(got_c, sml.seed_length)
        require(torch.equal(got_s, ref_s),
                "K17 differs from its plain version")
        seedocc_launches(torch, cargs, sml.seed_length,
                         f"K16/K17 on {L} bp")
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
    n_live = min(reps.n_reps, EC)
    args = (keys, seed_len, max(seed_len, 256), off, cnt, reps.lefts,
            reps.present, reps.is_fwd, reps.lengths0,
            mers.key_sentinel(seed))
    kl, kn = extend.extend_matches(*args, n_live=n_live)
    rl, rn = extend.extend_matches_plain(*args, n_live=n_live)
    require(torch.equal(kl, rl) and torch.equal(kn, rn),
            "K2 differs from its plain version at weight 17")
    log(f"# K2 at weight 17: rows={EC} launched={n_live} "
        f"max_len={int(kn.max())} equal")
    del smls, keys

    # K16 on the tests' sorted tables: a run over more than 32 tiles at
    # the 8.7 Mbp genome's rows, and 10 M rows of short runs against 10 M
    # rows with one content run of 10^6 rows
    tables = tests_module("test_torch_seedocc_tables")
    table_ms = {}
    for case, n in (("multi_tile_run", LARGE_LEN), ("many_rows", None),
                    ("content_run", 10_000_019)):
        keys, pos, L, sent = tables.sorted_table(case, n)
        cargs = (keys.to(dev), pos.to(dev), L, sent)
        got, _ = k16_vs_plain(cargs, f"table {case}")
        table_ms[case] = timed_ms(lambda: seedocc.seed_run_counts(*cargs),
                                  10, torch)
        log(f"# K16 on table {case}: {keys.shape[0]} rows, longest run "
            f"{int(got.max())}, {table_ms[case]:.4f} ms; equal")
    ratio = table_ms["content_run"] / table_ms["many_rows"]
    log(f"# K16: 10 M rows with a 10^6-row content run / 10 M rows of "
        f"short runs = {ratio:.3f}")
    require(ratio <= 2.0, f"K16 on a 10^6-row run takes {ratio:.2f}x the "
            f"short runs' time")

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


def phase_runflags(torch, lt, dev):
    """K5 and K13 through their wrappers alone at the paths' shapes: K5 on
    the 9 x 1 Mbp family's seed table (rng 0) and on the 3 x 8.7 Mbp
    family's, K13 on the first trio's and on the meshed pair's shard 0
    (its routed rows, MESH_SHARDS shards); each equal to its plain
    version, then timed by CUDA events and on the card (device_ms), 20
    runs each, median.  It calls only the wrappers, their plain versions
    and the paths' table builders, so this script copied into an older
    tree's archive times that tree the same way.  Prints one JSON line
    {"runflags": {table: {rows, events_ms, card_ms}}}."""
    from libmems_tpu_torch.matchfind import _seed_table
    from libmems_tpu_torch.ops import mums, pairwise
    from libmems_tpu_torch.ops.mers import key_sentinel, sentinel_content
    from libmems_tpu_torch.parallel import shard as psh
    from libmems_tpu_torch.sml import create_smls
    tables = {}
    for label, fam in (("K5 9 x 1 Mbp", family_nine(lt, 0)),
                       ("K5 3 x 8.7 Mbp", family_large(lt))):
        tables[label] = (pairwise.run_flags, pairwise.run_flags_plain,
                         seeder_table(torch, lt, dev, fam)["flag_args"])
    smls, seed = create_smls(family_trio(lt, 0), device=dev)
    keys, seg_off, content, src = _seed_table(smls)
    tables["K13 3 x 1.5 Mbp trio"] = (
        mums.mum_seed_flags, mums.mum_seed_flags_plain,
        (content, src, keys, seg_off, 0, 1000, sentinel_content(seed)))
    smls, seed = create_smls(genome_pair(lt, 0), device=dev)
    mesh = psh.Mesh([dev] * MESH_SHARDS)
    lay = psh._Layout(smls, mesh)
    _, route_cap = psh._default_caps(lay.total, mesh.size, None, None)
    routed, dropped = psh._route(mesh, lay.slices, key_sentinel(seed),
                                 route_cap)
    require(dropped == 0, f"{dropped} rows dropped at route_cap {route_cap}")
    content, src, _ = routed[0]
    tables["K13 meshed pair shard 0"] = (
        mums.mum_seed_flags, mums.mum_seed_flags_plain,
        (content, src, lay.keys[dev], lay.seg_off[dev], 0, 1000,
         sentinel_content(seed)))
    out = {}
    for label, (fn, plain, args) in tables.items():
        got, ref = fn(*args), plain(*args)
        require(all(torch.equal(g, r) if hasattr(r, "shape") else g == r
                    for g, r in zip(got, ref)),
                f"{label}: differs from its plain version")
        out[label] = {"rows": args[0].shape[0],
                      "events_ms": timed_ms(lambda: fn(*args), 20, torch),
                      "card_ms": device_ms(lambda: fn(*args), 20, torch)}
        log(f"# {label}: {out[label]['rows']} rows, equal; "
            f"{out[label]['events_ms']:.4f} ms by events, "
            f"{out[label]['card_ms']:.4f} on the card")
    log(json.dumps({"runflags": out}))


def phase_seedwords(torch, lt, dev):
    """K1 and K18 alone at the paths' shapes: K1's wrapper on the first
    genome of the 9 x 1 Mbp family, of the 4.6 Mbp pair and of the 3 x
    8.7 Mbp family, each with 40 N runs and without; on the pair's rows
    K18's wrapper, its pack and its flag pass, the seed-word sort between
    them and the cluster-word sort after them (K19's input).  Each is
    equal to its plain version, then timed by CUDA events, on the card
    (device_ms; not for K18's wrapper, whose host read waits for the
    card) and on the host clock (host_ms), 20 runs each, median.  It calls
    only the wrappers, their plain versions, the launchers K18's wrapper
    calls and the SML builder, so this script copied into an older tree's
    archive times that tree the same way.  Prints one JSON line
    {"seedwords": {label: {rows, events_ms, card_ms, host_ms}}}."""
    from libmems_tpu_torch import matchfind
    from libmems_tpu_torch.ops import mers, pair, pairwise
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls, default_seed
    out = {}

    def timings(label, rows, fn, card=True):
        out[label] = {"rows": rows,
                      "events_ms": timed_ms(fn, 20, torch),
                      "card_ms": device_ms(fn, 20, torch) if card else None,
                      "host_ms": host_ms(fn, 20, torch)}
        e = out[label]
        card_s = "" if e["card_ms"] is None else f", {e['card_ms']:.4f} card"
        log(f"# {label}: {rows} rows; {e['events_ms']:.4f} ms by events"
            f"{card_s}, {e['host_ms']:.4f} on the host")

    pair_genomes = genome_pair(lt, 0)
    for label, fam in (("1 Mbp", family_nine(lt, 0)),
                       ("4.6 Mbp", pair_genomes),
                       ("8.7 Mbp", family_large(lt))):
        seed = default_seed(fam)
        codes = torch.from_numpy(fam[0].codes.copy()).to(dev)
        amb = np.zeros(len(fam[0]), bool)
        rng = np.random.default_rng(7)
        for s in rng.integers(0, len(amb) - 500, size=40):
            amb[s:s + int(rng.integers(1, 400))] = True
        ambt = torch.from_numpy(amb).to(dev)
        del fam
        for a, what in ((ambt, "with N runs"), (None, "no mask")):
            got = mers.canonical_seed_keys(codes, seed, a)
            require(torch.equal(got, mers.canonical_seed_keys_plain(
                codes, seed, a)), f"K1 {label} {what}: differs from its "
                "plain version")
            timings(f"K1 {label} {what}", got.numel(),
                    lambda: mers.canonical_seed_keys(codes, seed, a))
        del codes, ambt

    smls, seed = create_smls(pair_genomes, device=dev)
    n = sum(s.n_windows for s in smls)
    pb = matchfind._pair_pos_bits(max(s.n_windows for s in smls))
    wargs = (smls[0].keys, smls[1].keys, pb, sentinel_content(seed))
    got_w, got_n = pair.pair_cluster_words(*wargs)
    ref_w, ref_n = pair.pair_cluster_words_plain(*wargs)
    require(got_n == ref_n and torch.equal(got_w, ref_w),
            "K18 differs from its plain version")
    log(f"# K18 on the pair: {n} rows, {got_n} candidates "
        f"({got_n / n:.4f}), {got_w.numel()} cluster words sorted after")
    pack, flags = k18_passes(torch, *wargs)
    words = k18_passes.words
    timings("K18 wrapper", n, lambda: pair.pair_cluster_words(*wargs),
            card=False)
    timings("K18 pack", n, pack)
    timings("K18 flags", n, flags)
    timings("K18 both passes", n, lambda: (pack(), flags()))
    timings("seed-word sort", n, lambda: pairwise.usort(words))
    timings("cluster-word sort", got_w.numel(),
            lambda: pairwise.usort(got_w))
    out["K18 candidates"] = got_n
    log(json.dumps({"seedwords": out}))


def k15_step(mums, words, posref, ec0, G, pos_bits, seed_len):
    """K15 as the trio's main path runs it from the first capacity guess
    ec0: on a tree with K15's scan, the scan, the capacity from its count
    and the decode; on an older tree the call at ec0 and, where the
    representatives do not fit, the call again at the next power of two
    above their count."""
    if hasattr(mums, "mum_rep_index"):
        idx = mums.mum_rep_index(words, posref, G, pos_bits, seed_len)
        ec = ec0 if idx.n_reps <= ec0 else 1 << (idx.n_reps - 1).bit_length()
        return mums.mum_decode_reps(words, posref, idx, ec, G, pos_bits)
    r = mums.mum_reps(words, posref, ec0, G, pos_bits, seed_len)
    if r.n_reps > ec0:
        r = mums.mum_reps(words, posref, 1 << (r.n_reps - 1).bit_length(),
                          G, pos_bits, seed_len)
    return r


def rep_passes(torch, lib, stream, kind, *args):
    """{"scan": fn, "decode": fn, and the buffers they launch on}: the
    scan and the decode of K15 ("mum") or K19 ("pair") launched alone
    through the library, as their wrappers launch them but with no host
    read between (the decode reads the index of the scan's last run); {}
    on a tree without those launches.  args: K15's (words, posref, G,
    pos_bits, seed_len, n_reps, ec), K19's (cw, pos_bits, seed_len,
    n_reps, ec)."""
    from libmems_tpu_torch.ops import pairwise
    if not hasattr(lib, f"lm_{kind}_rep_index"):
        return {}
    dev = args[0].device
    m = args[1].shape[0] if kind == "mum" else args[0].shape[0]
    index = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
    scratch = pairwise.scan_scratch(m, dev)
    if kind == "mum":
        words, posref, G, pb, seed_len, n_reps, ec = args
        outs = [torch.empty((ec, G), dtype=dt, device=dev)
                for dt in (torch.int32, torch.uint8, torch.uint8)]
        return {"scan": lambda: lib.lm_mum_rep_index(
                    words.data_ptr(), posref.data_ptr(), m, G,
                    words.shape[0], seed_len, index.data_ptr(),
                    scratch.data_ptr(), stream),
                "decode": lambda: lib.lm_mum_decode_reps(
                    words.data_ptr(), posref.data_ptr(), index.data_ptr(),
                    m, min(n_reps, ec), ec, G, pb,
                    *[o.data_ptr() for o in outs], stream),
                "outs": outs, "index": index, "scratch": scratch}
    cw, pb, seed_len, n_reps, ec = args
    outs = [torch.empty(shape, dtype=dt, device=dev)
            for shape, dt in (((ec, 2), torch.int32), ((ec, 2), torch.uint8),
                              ((ec, 2), torch.uint8), ((ec,), torch.int32))]
    counts = scratch[1:3]
    return {"scan": lambda: lib.lm_pair_rep_index(
                cw.data_ptr(), m, pb, seed_len, index.data_ptr(),
                scratch.data_ptr(), stream),
            "decode": lambda: lib.lm_pair_reps(
                cw.data_ptr(), index.data_ptr(), counts.data_ptr(),
                min(n_reps, ec), ec, pb, seed_len,
                *[o.data_ptr() for o in outs], stream),
            "outs": outs, "index": index, "scratch": scratch}


def phase_reps(torch, lt, dev):
    """K15, K19 and K7 alone at the paths' shapes: K15 on the first
    trio's sorted signature rows, the call at the first capacity guess
    and the main path's whole step (k15_step); K19 on the 4.6 Mbp pair's
    sorted cluster words at the pair path's capacity; K7's scan and
    decode on the 9 x 1 Mbp family's sorted words.  Each is equal to its
    plain version, then timed by CUDA events, on the card (device_ms) and
    on the host clock (host_ms), 20 runs each, median; where the tree
    has them, the scans and decodes of K15 and K19 are timed alone too
    (rep_passes).  It calls only the wrappers, their plain versions, the
    paths' table builders and the launchers rep_passes finds, so this
    script copied into an older tree's archive times that tree the same
    way.  Prints one JSON line {"reps": {label: {rows, events_ms,
    card_ms, host_ms}}}."""
    from libmems_tpu_torch import cuda, matchfind
    from libmems_tpu_torch.matchfind import _seed_table
    from libmems_tpu_torch.ops import mums, pair, pairwise
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls
    lib = cuda.library()
    out = {}

    def timings(label, rows, fn):
        out[label] = {"rows": rows,
                      "events_ms": timed_ms(fn, 20, torch),
                      "card_ms": device_ms(fn, 20, torch),
                      "host_ms": host_ms(fn, 20, torch)}
        e = out[label]
        log(f"# {label}: {rows} rows; {e['events_ms']:.4f} ms by events, "
            f"{e['card_ms']:.4f} card, {e['host_ms']:.4f} on the host")

    def same(a, b):
        return a.n_reps == b.n_reps and all(
            torch.equal(x, y) for x, y in zip(a[:-1], b[:-1]))

    def passes(label, rows, kind, *args):
        fns = rep_passes(torch, lib, cuda.stream(args[0]), kind, *args)
        for name in ("scan", "decode") if fns else ():
            timings(f"{label} {name} alone", rows,
                    lambda f=fns[name], n=name: cuda.check(f(), n))

    smls, seed = create_smls(family_trio(lt, 0), device=dev)
    G, seed_len = len(smls), smls[0].seed_length
    keys, seg_off, content, src = _seed_table(smls)
    flags = mums.mum_seed_flags(content, src, keys, seg_off, 0, 1000,
                                sentinel_content(seed))
    pos_bits = keys.numel().bit_length()
    words, posref = trio_signature_rows(
        torch, mums.mum_candidates(flags, G, 0, pos_bits))
    m = posref.numel()
    ec0 = min(1 << 14, 1 << (flags.n_rows - 1).bit_length())
    del keys, seg_off, content, src, flags
    got = k15_step(mums, words, posref, ec0, G, pos_bits, seed_len)
    ec = got.lefts.shape[0]
    require(same(got, mums.mum_reps_plain(words, posref, ec, G, pos_bits,
                                          seed_len)),
            "K15's step differs from its plain version")
    log(f"# K15 on the trio: {m} rows of {words.shape[0]} words, "
        f"{got.n_reps} reps, EC {ec0} -> {ec}")
    timings("K15 at the first guess", m,
            lambda: mums.mum_reps(words, posref, ec0, G, pos_bits, seed_len))
    timings("K15 step", m,
            lambda: k15_step(mums, words, posref, ec0, G, pos_bits,
                             seed_len))
    passes("K15", m, "mum", words, posref, G, pos_bits, seed_len,
           got.n_reps, ec)
    out["K15 counts"] = {"rows": m, "n_words": words.shape[0],
                         "n_reps": got.n_reps, "ec0": ec0, "ec": ec}
    del words, posref, got

    smls, seed = create_smls(genome_pair(lt, 0), device=dev)
    pb = matchfind._pair_pos_bits(max(s.n_windows for s in smls))
    total = sum(s.n_windows for s in smls)
    ec = min(1 << 14, 1 << max((total - 1).bit_length() - 1, 1))
    cw, _ = pair.pair_cluster_words(smls[0].keys, smls[1].keys, pb,
                                    sentinel_content(seed))
    cw = pairwise.usort(cw)
    rargs = (cw, ec, pb, smls[0].seed_length)
    got = pair.pair_reps(*rargs)
    require(same(got, pair.pair_reps_plain(*rargs)),
            "K19 differs from its plain version")
    timings("K19", cw.numel(), lambda: pair.pair_reps(*rargs))
    passes("K19", cw.numel(), "pair", cw, pb, smls[0].seed_length,
           got.n_reps, ec)
    out["K19 counts"] = {"words": cw.numel(), "n_reps": got.n_reps,
                         "ec": ec}
    del smls, cw, got

    t = seeder_table(torch, lt, dev, family_nine(lt, 0))
    G, pb, seed_len = t["G"], t["pos_bits"], t["seed_len"]
    cw = pairwise.usort(pairwise.cluster_words(t["flags"], G, pb))
    idx = pairwise.rep_index(cw, pb, seed_len)
    ec0 = min(1 << 14, 1 << (max(t["rows"], 2) - 1).bit_length())
    ec = ec0 if idx.n_reps <= ec0 else 1 << (idx.n_reps - 1).bit_length()
    got = pairwise.decode_reps(cw, idx, ec, G, pb, seed_len, *t["gen"])
    require(same(got, pairwise.cluster_reps_plain(cw, ec, G, pb, seed_len,
                                                  *t["gen"])),
            "K7 differs from its plain version")
    n_valid = int(idx.counts[0])
    index = torch.empty(cw.numel(), dtype=torch.int32, device=dev)
    scratch = pairwise.scan_scratch(cw.numel(), dev)
    timings("K7 scan", n_valid, lambda: pairwise.rep_index(cw, pb, seed_len))
    timings("K7 scan alone", n_valid,
            lambda: pairwise._rep_scan(cw, pb, seed_len, index, scratch))
    timings("K7 decode", ec,
            lambda: pairwise.decode_reps(cw, idx, ec, G, pb, seed_len,
                                         *t["gen"]))
    out["K7 counts"] = {"words": cw.numel(), "valid": n_valid,
                        "n_reps": idx.n_reps, "ec": ec}
    log(json.dumps({"reps": out}))


def k2_work(c, out):
    """K2's least work on one call's arguments c (bound by name) and its
    output (lefts, lengths).  Each side of a live row reads, for each
    present genome, the windows of its extension and then the seed_len
    offsets past the chain's last match that show its end (a match
    seed_len + 1 past it would not continue it), or fewer where a
    sequence's edge comes first.  Bytes: each key that some row reads,
    once (a key that several overlapping rows read is charged once; its
    re-reads may come from L2), and the rows' inputs and outputs.
    Operations: 4 a present genome a probed offset."""
    import torch
    s = c["seed_len"]
    R, G = c["lefts"].shape
    n = R if c.get("n_live") is None else c["n_live"]
    lo_in, cnt = c["lefts"][:n].long(), c["gen_cnt"][:n].long()
    lo_out = out[0][:n].long()
    len_in, len_out = c["lengths"][:n].long(), out[1][:n].long()
    pres, fwd = c["present"][:n], c["is_fwd"][:n]
    end_in = lo_in + len_in[:, None] - s
    end_out = lo_out + len_out[:, None] - s
    # a side's reach: the back-moving genomes' left ends moved by it (side
    # 0 moves the forward genomes back, side 1 the reverse ones)
    ref = torch.argmax(pres.to(torch.int8), dim=1, keepdim=True)
    moved = (lo_in - lo_out).gather(1, ref)[:, 0]
    total = len_out - len_in
    ref_fwd = fwd.gather(1, ref)[:, 0]
    reach = [torch.where(ref_fwd, moved, total - moved)]
    reach.append(total - reach[0])
    big = 1 << 40
    keys = torch.zeros(c["keys_concat"].shape[0] + 1, dtype=torch.int32,
                       device=lo_in.device)
    offs = c["gen_off"][:n].long()
    probed = 0
    for side in (0, 1):
        back = fwd if side == 0 else ~fwd
        room = torch.where(back, lo_out, cnt - 1 - end_out)
        room = torch.where(pres, room, big).amin(dim=1)
        probes = reach[side] + room.clamp(max=s)
        probes = torch.where(pres.any(dim=1), probes, 0)
        probed += int((probes * pres.sum(dim=1)).sum())
        lo = torch.where(back, lo_in - probes[:, None], end_in + 1)
        hi = torch.where(back, lo_in, end_in + 1 + probes[:, None])
        lo, hi = lo.clamp(min=0), torch.minimum(hi, cnt)
        use = pres & (hi > lo)
        one = torch.ones(int(use.sum()), dtype=torch.int32,
                         device=keys.device)
        keys.index_add_(0, (offs + lo)[use], one)
        keys.index_add_(0, (offs + hi)[use], -one)
    distinct = int((keys.cumsum(0) > 0).sum())
    return work(8 * distinct + nbytes(c["gen_off"], c["gen_cnt"], c["lefts"],
                                      c["present"], c["is_fwd"],
                                      c["lengths"], out), 4 * probed)


def phase_extend(torch, lt, dev):
    """K2 at the four default paths' shapes and K14 at the trio's, alone:
    the calls the paths make, recorded at their call sites (matchfind's
    extend_matches and mum_candidates) while the pair's and the trio's
    find_mums_device and the 9 x 1 Mbp and 3 x 8.7 Mbp find_pairwise_mums
    run, and K2's wide route on the 64-genome find_mums_device rows, in
    shared memory and in global scratch.  Each call is held equal to its
    plain version, then timed by CUDA events, on the card (device_ms) and
    on the host clock (host_ms), 20 runs each, median.  It calls only
    entry points and wrappers both trees share, so this script copied
    into an older tree's archive times that tree's calls the same way.
    Prints one JSON line {"extend": {label: {...}}}."""
    from libmems_tpu_torch import matchfind
    from libmems_tpu_torch.ops import extend, mums
    from libmems_tpu_torch.sml import create_smls
    out = {}
    plain_names = list(inspect.signature(
        extend.extend_matches_plain).parameters)

    def timings(label, fn, info):
        e = dict(info, events_ms=timed_ms(fn, 20, torch),
                 card_ms=device_ms(fn, 20, torch),
                 host_ms=host_ms(fn, 20, torch))
        out[label] = e
        log(f"# {label}: " + ", ".join(f"{k} {v}" for k, v in e.items()))

    def k2(label, c, scratch=False):
        got = extend.extend_matches(**dict(c, scratch=scratch))
        ref = extend.extend_matches_plain(
            **{k: c[k] for k in plain_names if k in c})
        require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                f"K2 differs from its plain version: {label}")
        R, G = c["lefts"].shape
        n_live = c.get("n_live")
        bound_ms, bound_by = bound(k2_work(c, got))
        timings(label, lambda: extend.extend_matches(
            **dict(c, scratch=scratch)), {
                "rows": R, "G": G,
                "launched": R if n_live is None else n_live,
                "live": int(c["present"].any(dim=1).sum()),
                "max_len": int(got[1].max()), "bound_ms": bound_ms,
                "bound_by": bound_by})

    def recorded(fn, names):
        with recording([(matchfind, n) for n in names]) as calls:
            fn()
        return calls

    smls, _ = create_smls(genome_pair(lt, 0), device=dev)
    c = recorded(lambda: matchfind.find_mums_device(smls),
                 ["extend_matches"])["extend_matches"]
    require(len(c) == 1, "the pair path made no single K2 call")
    k2("K2 pair 2 x 4.6 Mbp", c[0])
    del smls, c

    smls, _ = create_smls(family_trio(lt, 0), device=dev)
    calls = recorded(lambda: matchfind.find_mums_device(smls),
                     ["extend_matches"])
    k2("K2 trio 3 x 1.5 Mbp", calls["extend_matches"][0])
    del calls
    # K14 on the trio's flags, recorded where the fused pipeline calls it
    with recording([(matchfind.ops_mums, "mum_candidates")]) as calls:
        matchfind.find_mums_device(smls)
    c = calls["mum_candidates"][0]
    got = mums.mum_candidates(**c)
    ref = mums.mum_candidates_plain(**c)
    require(all(torch.equal(a, b) for a, b in zip(got, ref)),
            "K14 differs from its plain version")
    f = c["flags"]
    n = f.kept_occ.numel()
    bound_ms, bound_by = bound(work(
        5 * n + 10 * int(f.kept_occ.sum()) + nbytes(got),
        4 * n + 6 * (c["G"] + 3) * got.words.shape[0] * f.n_rows))
    timings("K14 trio", lambda: mums.mum_candidates(**c), {
        "table_rows": n, "candidates": f.n_rows,
        "n_words": got.words.shape[0], "bound_ms": bound_ms,
        "bound_by": bound_by})
    del smls, calls, c, got, ref, f

    for label, fam in (("K2 pairwise 9 x 1 Mbp", family_nine(lt, 0)),
                       (f"K2 pairwise 3 x {LARGE_LEN} bp",
                        family_large(lt))):
        c = recorded(lambda: matchfind.find_pairwise_mums(fam, device=dev),
                     ["extend_matches"])["extend_matches"]
        require(len(c) == 1, f"{label}: not one K2 call")
        k2(label, c[0])
        del c

    smls, _ = create_smls(wide_family(lt), device=dev)
    c = recorded(lambda: matchfind.find_mums_device(smls),
                 ["extend_matches"])["extend_matches"]
    for scratch in (False, True):
        k2(f"K2 wide route G = {WIDE_GENOMES}"
           + (" in global scratch" if scratch else ""), c[0], scratch)
    log(json.dumps({"extend": out}))


def phase_mum_kernels(torch, lt, dev):
    """K13-K15 against their plain versions on the card, on the seed
    table of the first trio input (rng 0), and K2 on that input's
    extension rows; exact equality.  Returns ({name: entry}, K2's
    max_abs_err)."""
    from libmems_tpu_torch.matchfind import _seed_table
    from libmems_tpu_torch.ops import extend, mums, pairwise
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
    res["mum_seed_flags"]["card_ms"] = device_ms(
        lambda: mums.mum_seed_flags(*args), 10, torch)
    log(f"# K13 seed flags: rows={n} candidate rows={got.n_rows} equal; "
        f"{res['mum_seed_flags']['ms']:.4f} ms by events, "
        f"{res['mum_seed_flags']['card_ms']:.4f} on the card")
    run_flag_launches(torch, args, args[4] + 1, "K13 on the trio's table")

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
        # every row's kept flag and row id, the kept rows' genome,
        # position and strand (and their reference strand), starts +
        # words + posref out; per candidate row ~6 operations per field
        # bit-placement and genome
        work(5 * n + 10 * int(got.kept_occ.sum()) + nbytes(got_c),
             4 * n + 6 * (G + 3) * got_c.words.shape[0] * n_rows))
    log(f"# K14 candidates: {n_rows} rows, {got_c.words.shape[0]} words "
        f"each, equal")

    words, posref = trio_signature_rows(torch, got_c)
    # the main path's capacity: its first guess, or the next power of two
    # above the representatives' count, picked once from the scan's count
    idx = mums.mum_rep_index(words, posref, G, pos_bits, seed_len)
    ref_i = mums.mum_rep_index_plain(words, posref, G, pos_bits, seed_len)
    require(idx.n_reps == ref_i.n_reps
            and torch.equal(idx.index[:idx.n_reps], ref_i.index),
            "K15's scan differs from its plain version")
    ec0 = min(1 << 14, 1 << (n_rows - 1).bit_length())
    ec = pairwise.rep_capacity(ec0, idx.n_reps)
    got_r = mums.mum_decode_reps(words, posref, idx, ec, G, pos_bits)
    rargs = (words, posref, ec, G, pos_bits, seed_len)
    ref_r = mums.mum_reps_plain(*rargs)
    require(got_r.n_reps == ref_r.n_reps and same(got_r, ref_r),
            "K15 differs from its plain version")
    res["mum_reps"] = entry(
        max_abs_err(zip(tensors(got_r), tensors(ref_r))),
        timed_ms(lambda: mums.mum_reps(*rargs), 10, torch),
        timed_ms(lambda: mums.mum_reps_plain(*rargs), 3, torch,
                 warmup=False),
        # sorted words and posref in, a row index a representative, [EC,
        # G] rows out; ~10 operations a row and field (unpack, compares)
        work(nbytes(words, posref, tensors(got_r)) + 4 * idx.n_reps,
             10 * (G + 3) * posref.numel()))
    res["mum_reps"]["card_ms"] = device_ms(lambda: mums.mum_reps(*rargs),
                                           10, torch)
    log(f"# K15 representatives: {got_r.n_reps} reps in EC={ec} (first "
        f"guess {ec0}) equal; {res['mum_reps']['ms']:.4f} ms by events, "
        f"{res['mum_reps']['card_ms']:.4f} on the card")

    off = seg_off[:-1].to(torch.int32)[None].expand(ec, G).contiguous()
    cnt = (seg_off[1:] - seg_off[:-1]).to(torch.int32)[None].expand(
        ec, G).contiguous()
    kargs = (keys, seed_len, max(seed_len, 256), off, cnt, got_r.lefts,
             got_r.present, got_r.is_fwd,
             torch.full((ec,), seed_len, dtype=torch.int32, device=dev),
             key_sentinel(seed))
    n_live = min(got_r.n_reps, ec)
    kl, kn = extend.extend_matches(*kargs, n_live=n_live)
    rl, rn = extend.extend_matches_plain(*kargs, n_live=n_live)
    require(torch.equal(kl, rl) and torch.equal(kn, rn),
            "K2 differs from its plain version on the trio's rows")
    log(f"# K2 on the trio's rows at G = {G}: rows={ec} launched={n_live} "
        f"max_len={int(kn.max())} equal")
    for name in MUM_KERNELS:
        e = res[name]
        log(f"# {name}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} "
            f"ms, max_abs_err {e['err']}")
    return res, max_abs_err([(kl, rl), (kn, rn)])


def trio_signature_rows(torch, cand):
    """K14's candidate rows in the signature order K15 takes them, as the
    main path sorts them: (words, posref)."""
    from libmems_tpu_torch.matchfind import _lexsort_rows
    order = _lexsort_rows(list(cand.words) + [cand.posref])
    return torch.index_select(cand.words, 1, order), cand.posref[order]


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
                "mum_reps": mums.mum_rep_index,
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
        for w in (*wrappers.values(), mums.mum_decode_reps):
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
        require(mums.mum_decode_reps.launches == launches["mum_reps"],
                "K15: a decode for each scan of the signature rows")
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
                "cluster_reps": pairwise.rep_index,
                "fb_posterior": hmm.fb_posterior,
                "fb_ragged": hmm.fb_ragged,
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
        for w in (*wrappers.values(), pairwise.decode_reps):
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
        require(pairwise.decode_reps.launches == launches["cluster_reps"],
                "K7: a decode for each scan of the cluster words")
        check_partition(ivs, genomes)
        check_partition(new_ivs, genomes)
        check_segments(new_ivs, segs)
        first_outs.setdefault("outs", outs)
        return genomes, launches, calls, t2 - t0

    first_outs = {}
    trace.set_enabled(True, stream=sys.stdout)
    genomes, launches, calls, dt1 = run(0, True)
    steps = (pairwise.cluster_words, pairwise.rep_index, pairwise.decode_reps)
    for w in steps:
        w.launches = 0
    got = lt.find_pairwise_mums(genomes, device=dev)
    counts = [w.launches for w in steps]
    log(f"# find_pairwise_mums on the card: K6 {counts[0]}, K7's scan "
        f"{counts[1]}, K7's decode {counts[2]} launches")
    require(counts == [1, 1, 1], "find_pairwise_mums: the cluster words "
            "are not scanned exactly once")
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
    (launches, wall, the arguments of its predict_homologous calls, those
    of its align_profile_batch calls)."""
    from libmems_tpu_torch import (anchorscore, islands, msa, progressive,
                                   trace)
    from libmems_tpu_torch.ops import (extend, gapped, hmm, mers, pairwise,
                                       profile, seedocc)
    from libmems_tpu_torch.sml import default_seed
    wrappers = {"canonical_seed_keys": mers.canonical_seed_keys,
                "extend_matches": extend.extend_matches,
                "run_flags": pairwise.run_flags,
                "cluster_words": pairwise.cluster_words,
                "cluster_reps": pairwise.rep_index,
                "seed_run_counts": seedocc.seed_run_counts,
                "seed_smooth": seedocc.seed_smooth,
                "fb_posterior": hmm.fb_posterior,
                "fb_ragged": hmm.fb_ragged,
                "traceback_walk": gapped.traceback_walk,
                "banded_traceback_walk": profile.banded_traceback_walk}
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
    for w in (*wrappers.values(), pairwise.decode_reps):
        w.launches = 0
    try:
        with recording([(islands, "predict_homologous"),
                        (progressive, "align_profile_batch"),
                        (msa, "align_profile_batch")]) as calls:
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
    require(pairwise.decode_reps.launches == launches["cluster_reps"],
            "K7: a decode for each scan of the cluster words")
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
    return launches, t2 - t0, calls["predict_homologous"], \
        calls["align_profile_batch"]


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


def band_windows(rng, M, N, shapes):
    """Windows of the given (p_len, q_len, insertion) shapes with
    fractional multi-row profiles: q is p with 2% substitutions, an
    insertion of that many random columns in the middle, then cut or
    extended with random columns to q_len (tests/test_torch_cuda.py's
    _band_windows)."""
    from libmems_tpu_torch.ops.profile import rows_to_profile
    B = len(shapes)
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for r, (n_p, n_q, ins) in enumerate(shapes):
        a = rng.integers(0, 4, n_p).astype(np.uint8)
        b = a.copy()
        sub = rng.random(n_p) < 0.02
        b[sub] = rng.integers(0, 4, int(sub.sum()))
        b = np.concatenate([b[:n_p // 2], rng.integers(0, 4, ins),
                            b[n_p // 2:]]).astype(np.uint8)
        b = np.concatenate([b, rng.integers(0, 4, max(n_q - len(b), 0))
                            ]).astype(np.uint8)[:n_q]
        for arr, s, k in ((p, a, 1 + r % 3), (q, b, 1 + r % 2)):
            rows = np.stack([s] * k)
            rows[rng.random(rows.shape) < 0.005] = 4
            rows[:, (rows == 4).all(axis=0)] = 0
            arr[r, :len(s)] = rows_to_profile(rows)
        pl[r], ql[r] = n_p, n_q
    return (p, q, pl, ql)


def band_launches(torch, dev):
    """One many-window K10/K11 launch, the refine gate's shape: 2,112
    windows in the 1024 bucket (16 an SM on 132 SMs); and one
    wide-window launch, the tracebacks' shape: three windows in the
    11,664 bucket, the longest of 10,000 rows and 9,980 columns, one with
    a 300-column insertion.  Returns [(label, packed CUDA tensors)]."""
    rng = np.random.default_rng(11)
    n = rng.integers(400, 985, 2112)
    d = rng.integers(-20, 21, 2112)
    many = band_windows(rng, 1024, 1024,
                        [(int(a), int(a + b), 0) for a, b in zip(n, d)])
    wide = band_windows(rng, 10_112, 11_664, [
        (10_000, 9_980, 0), (6_000, 6_300, 300), (120, 170, 0)])
    return [(label, [torch.from_numpy(x).to(dev) for x in t])
            for label, t in (("many-window", many), ("wide-window", wide))]


def band_geometries(lst, emit_ptr):
    """The launcher's geometry of each K10 (K11) launch in lst, as
    'B@N: S warps x K columns a lane, W windows an SM'."""
    from libmems_tpu_torch.ops import profile
    out = []
    for a in lst:
        B, N = int(a[0].shape[0]), int(a[1].shape[1])
        g = profile.band_geometry(a[6], emit_ptr, B)
        out.append(f"{B}@{N}: {g['warps']} x {g['K']}"
                   f"{'' if g['qw_registers'] else ' (qw in smem)'}, "
                   f"{g['windows_per_sm']}/SM")
    return "; ".join(out)


def extra_band_launches(torch, dev, fns, res):
    """K10, K11 and K12 against their plain versions on the two launches
    of band_launches, exact; each launch's geometry and time, every other
    geometry of the launcher's table forced and timed, and K11's pointer
    zero-fill timed apart.  Widens res's max_abs_err; the path's times
    stay those of the path."""
    from libmems_tpu_torch.ops import gapped, profile
    for label, t in band_launches(torch, dev):
        B, Mp, N = int(t[0].shape[0]), int(t[0].shape[1]), int(t[1].shape[1])
        H_W = profile._band_half(N)
        args = (*t, profile.GAP_OPEN, profile.GAP_EXTEND, H_W)
        for name, emit_ptr in (("banded_forward_scores", False),
                               ("banded_forward_ptrs", True)):
            fn, plain = fns[name]
            got = fn(*args)
            ref, pms = timed_once(lambda: plain(*args), torch)
            require(all(torch.equal(x, y) for x, y in zip(got, ref)),
                    f"{name} differs from its plain version on the "
                    f"{label} launch")
            res[name]["err"] = max(res[name]["err"],
                                   max_abs_err(zip(got, ref)))
            ms = timed_ms(lambda: fn(*args), 3, torch)
            forced = []
            g = 0
            while (geo := profile.band_geometry(H_W, emit_ptr, g=g)) \
                    is not None:
                if geo["windows_per_sm"]:
                    g_ms = timed_ms(lambda: fn(*args, geometry=g), 3, torch)
                    forced.append(
                        f"{geo['warps']} x {geo['K']}"
                        f"{'' if geo['qw_registers'] else ' (qw in smem)'}"
                        f" {g_ms:.3f} ms")
                g += 1
            geo = band_geometries([args], emit_ptr)
            log(f"# {name} {label} launch: {geo} (warps a window x columns "
                f"a lane); kernel {ms:.3f} ms, "
                f"plain {pms:.3f} ms, equal; forced: {'; '.join(forced)}")
            if emit_ptr:
                T = gapped._device_tb_T(Mp, N)
                wa = (got[0], t[2], t[3], N, H_W, T)
                walk, walk_plain = fns["banded_traceback_walk"]
                walk_vs_plain(torch, "banded", walk, walk_plain, wa, label,
                              res["banded_traceback_walk"])
                # K4 on K3's full pointers of the same windows
                fp = profile.profile_forward(*t)[0]
                walk_vs_plain(torch, "full", fns["traceback_walk"][0],
                              fns["traceback_walk"][1],
                              (fp, t[2], t[3], T), label,
                              res["traceback_walk"])
                del fp
        fill_ms = timed_ms(lambda: torch.zeros(
            (B, Mp, profile.band_width(H_W) + 1), dtype=torch.uint8,
            device=dev), 3, torch)
        log(f"# {label} launch: K11's pointer zero-fill {fill_ms:.3f} ms")


def walk_vs_plain(torch, kind, walk, plain, wa, label, e):
    """K4 (kind "full") or K12 on one launch against its plain version,
    exact, in the launcher's geometry and in every geometry of the
    table that fits, each timed; the output's bytes to the host,
    tb_unpack's seconds and the latency floor logged.  Widens the
    entry e's max_abs_err."""
    from libmems_tpu_torch.ops import gapped
    ptrs = wa[0]
    n = ptrs.shape[2] - 1 if kind == "full" else wa[4]
    ref, pms = timed_once(lambda: plain(*wa), torch)
    times = []
    for g in range(-1, 5):
        geo = gapped.walk_geometry(kind, int(ptrs.shape[0]),
                                   int(ptrs.shape[1]), n, g)
        if not geo["warps"]:
            continue
        got = walk(*wa, geometry=g)
        require(all(torch.equal(x, y) for x, y in zip(got, ref)),
                f"{kind} walk differs from its plain version on the {label} "
                f"launch in geometry {geo}")
        e["err"] = max(e["err"], max_abs_err(zip(got, ref)))
        ms = timed_ms(lambda: walk(*wa, geometry=g), 3, torch)
        times.append(f"{'pick ' if g < 0 else ''}{geo['rows']} x "
                     f"{geo['depth']}{' x ' + str(geo['cols']) if geo['cols'] else ''}"
                     f" ({geo['warps']}/block) {ms:.3f} ms")
    tail_b, tail_s = walk_host_tail(torch, [ref])
    w = walk_work(ref)
    log(f"# {kind} walk {label} launch: {'; '.join(times)}; plain "
        f"{pms:.3f} ms, equal; longest window {int(ref.steps.max())} "
        f"steps, latency floor {w['latency_ms']:.4f} ms; output to the "
        f"host {tail_b} bytes, tb_unpack {tail_s:.6f} s")


def walk_step_costs(torch, dev):
    """What a walk step and a walk launch cost apart: K12 (the launcher's
    geometry) on one-window launches of a 1024-column band: no step
    (p_len = q_len = 0), 4,096 diagonal steps, 1,153 steps along one row
    (all E) and 4,096 rows straight up (all F); K4 on a 2,048 x 2,048
    diagonal (the slab route) and forced into whole rows.  Logs each
    launch's ms and ns a step net of the empty launch."""
    from libmems_tpu_torch.ops import gapped, profile
    e_run = gapped.H_E | gapped.E_EXT_BIT
    f_run = gapped.H_F | gapped.F_EXT_BIT
    H_W = profile._band_half(1024)
    W1 = profile.band_width(H_W) + 1

    def one(n):
        return torch.tensor([n], dtype=torch.int32, device=dev)
    cases = [("banded", "empty", 0, 0, 0, 128, W1, -1),
             ("banded", "diagonal", 0, 4096, 1024, 4096, W1, -1),
             ("banded", "one row (E)", e_run, 128, 1024, 128, W1, -1),
             ("banded", "straight up (F)", f_run, 4096, 1000, 4096, W1, -1),
             ("full", "diagonal", 0, 2048, 2048, 2048, 2049, -1),
             ("full", "diagonal, whole rows", 0, 2048, 2048, 2048, 2049, 1)]
    out, empty = [], 0.0
    for kind, label, val, pl, ql, M, S, g in cases:
        ptrs = torch.full((1, M, S), val, dtype=torch.uint8, device=dev)
        N = 1024 if kind == "banded" else S - 1
        T = gapped._device_tb_T(M, N)
        if kind == "banded":
            args = (ptrs, one(pl), one(ql), N, H_W, T)
            fn = profile.banded_traceback_walk
        else:
            args = (ptrs, one(pl), one(ql), T)
            fn = gapped.traceback_walk
        steps = int(fn(*args, geometry=g).steps[0])
        ms = timed_ms(lambda: fn(*args, geometry=g), 5, torch)
        if label == "empty":
            empty = ms
            out.append(f"{kind} {label} {ms:.4f} ms")
        else:
            out.append(f"{kind} {label} {steps} steps {ms:.4f} ms, "
                       f"{(ms - empty) * 1e6 / steps:.1f} ns a step")
    log(f"# walk step costs (one window a launch): {'; '.join(out)}")


def geometry_label(geo):
    if geo["route"] == "wide":
        return "wide route (one block a window)"
    return (f"{geo['warps']} x {geo['K']}, {geo['windows_per_block']}/block,"
            f" {geo['windows_per_sm']}/SM")


def fullwidth_launches(torch, label, lst, emit_ptr):
    """K3 (emit_ptr) or K9 against its plain version on each launch of
    lst ((p, q, p_len, q_len, ...) on the card), exact, in the launcher's
    geometry and in every geometry of the table that fits; a log line a
    launch: its bucket (Mp, N), windows, longest p_len and q_len,
    geometry, time with CUDA events (the host's launch time included
    where the card waits for it), time on the card alone (device_ms),
    latency floor and each forced geometry's time.  Returns (compared
    pairs, sum of event ms, sum of card ms)."""
    from libmems_tpu_torch.ops import profile
    fn, plain = ((profile.profile_forward, profile.profile_forward_plain)
                 if emit_ptr else (profile.profile_forward_scores,
                                   profile.profile_forward_scores_plain))
    name = "K3" if emit_ptr else "K9"
    pairs, tot_ms, tot_dev = [], 0.0, 0.0
    for k, a in enumerate(lst):
        B, Mp, N = (int(a[0].shape[0]), int(a[0].shape[1]),
                    int(a[1].shape[1]))
        pl, ql = _lens(a[:4])
        ref = plain(*a)
        ref = ref if isinstance(ref, tuple) else (ref,)
        geo = profile.profile_geometry(B, N, emit_ptr)
        runs = [-1]
        if geo["route"] == "strips":
            g = 0
            while (x := profile.profile_geometry(B, N, emit_ptr, g)) \
                    is not None:
                if x["windows_per_sm"]:
                    runs.append(g)
                g += 1
        forced = []
        for g in runs:
            def call(g=g):
                return fn(*a) if g < 0 else fn(*a, geometry=g)
            got = call()
            if g < 0:
                took = profile.launched_geometry(a[0].device)
                require(took == geo, f"{name} {label} launch {k}: the "
                        f"launch took {took}, the query says {geo}")
            got = got if isinstance(got, tuple) else (got,)
            require(all(torch.equal(x, y) for x, y in zip(got, ref)),
                    f"{name} differs from its plain version on {label} "
                    f"launch {k} ({Mp}, {N}) B={B} in geometry {g}")
            pairs += list(zip(got, ref))
            if g >= 0:
                x = profile.profile_geometry(B, N, emit_ptr, g)
                forced.append(f"{geometry_label(x)} "
                              f"{timed_ms(call, 3, torch):.4f}")
        ms = timed_ms(lambda: fn(*a), 5, torch)
        dev_ms = device_ms(lambda: fn(*a), 5, torch)
        tot_ms += ms
        tot_dev += dev_ms
        log(f"# {name} {label} launch {k}: ({Mp}, {N}) B={B}, longest "
            f"p_len {int(pl.max(initial=0))}, q_len {int(ql.max(initial=0))}"
            f"; {geometry_label(geo)}; {ms:.4f} ms (events), {dev_ms:.4f} ms"
            f" on the card, latency floor {dp_latency_ms(pl, ql):.4f} ms"
            f"{'; forced: ' + '; '.join(forced) + ' ms' if forced else ''}")
    log(f"# {name} {label}: {len(lst)} launches, equal; sum {tot_ms:.4f} ms "
        f"(events), {tot_dev:.4f} ms on the card")
    return pairs, tot_ms, tot_dev


def empty_launch_split(torch, dev):
    """K3 and K9 on one empty window (B = 1, p_len = q_len = 0, a 16 x 16
    bucket), timed four ways: CUDA events around the wrapper (as the
    path's launches are timed), the card's time alone (device_ms), the
    host clock around the wrapper with a synchronise on each side, and
    the host's time a call over 100 calls back to back.  The launcher's
    host time is the host clock less the card's time."""
    from libmems_tpu_torch.ops import profile
    z = torch.zeros((1,), dtype=torch.int32, device=dev)
    args = (torch.zeros((1, 16, 5), device=dev),
            torch.zeros((1, 16, 5), device=dev), z, z)
    out = []
    for name, fn in (("K3", profile.profile_forward),
                     ("K9", profile.profile_forward_scores)):
        ev = timed_ms(lambda: fn(*args), 20, torch)
        card = device_ms(lambda: fn(*args), 20, torch)
        host = host_ms(lambda: fn(*args), 20, torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn(*args)
        enq = (time.perf_counter() - t0) * 10
        torch.cuda.synchronize()
        out.append(f"{name} events {ev:.4f} ms, card {card:.4f} ms, host "
                   f"clock {host:.4f} ms (launcher's host time "
                   f"{host - card:.4f} ms), enqueue {enq:.4f} ms a call")
    log(f"# empty launch (B = 1, p_len = q_len = 0): {'; '.join(out)}")


def edge_launches(dev, torch):
    """Launches at the strip kernels' edge widths (the EDGES of
    tests/profile_windows.py, which the tests hold too): for each lane
    width K of the geometry table a one-warp bucket (N = 32K - 1) and a
    two-strip one (N = 32K + 1), q_len at 32K - 1, 32K and 32K + 1 where
    they fit, empty windows and windows with p_len = 0 or q_len = 0; and
    the wide route's boundary, N = STRIP_MAX_N - 1, STRIP_MAX_N and
    STRIP_MAX_N + 1.  Fractional 3 + 2-row profiles."""
    w = tests_module("profile_windows")
    rng = np.random.default_rng(23)
    return [(f"N={N}", [torch.from_numpy(x).to(dev)
                        for x in w.sized_profiles(rng, M, N, shapes)])
            for M, N, shapes in w.EDGES]


def fullwidth_checks(torch, dev, pair_packed, shapes):
    """K3 and K9 alone: the empty launch's host/card split, then each
    against its plain version, launch by launch and in every geometry
    that fits (fullwidth_launches), on the pair's inter-anchor windows,
    the 1024 x 1024 and 4096 x 4096 shapes, fractional 3 + 2 and 4 + 5-row
    windows and the edge widths.  Returns {name: compared pairs}."""
    empty_launch_split(torch, dev)
    rng = np.random.default_rng(29)
    w = tests_module("profile_windows")
    frac = [(f"{n_p}+{n_q} rows", [torch.from_numpy(x).to(dev) for x in
                                   w.sized_profiles(rng, 300, 256, [
                                       (int(rng.integers(128, 257)),
                                        int(rng.integers(128, 257)))
                                       for _ in range(6)], n_p, n_q)])
            for n_p, n_q in ((3, 2), (4, 5))]
    groups = [("pair windows", [t for _, _, t in pair_packed]),
              ("shape", [t for _, _, t in shapes]),
              ("fractional", [t for _, t in frac]),
              ("edge", [t for _, t in edge_launches(dev, torch)])]
    out = {"profile_forward": [], "profile_forward_scores": []}
    for label, lst in groups:
        for name, emit_ptr in (("profile_forward", True),
                               ("profile_forward_scores", False)):
            out[name] += fullwidth_launches(torch, label, lst, emit_ptr)[0]
    return out


def phase_fullwidth(torch, lt, dev, calls):
    """The light K3/K9 phase (not part of the full run, whose kernels and
    profile_dp phases hold the same checks): fullwidth_checks on the
    rng-0 pair's windows and the shapes, and, where the progressive run
    was recorded, each of its K3 and K9 launches (plan_profile_dp)."""
    from libmems_tpu_torch.sml import create_smls
    genomes = genome_pair(lt, 0)
    smls, seed = create_smls(genomes, device=dev)
    _, packed = pair_launches(lt, genomes, smls, seed, dev)
    fullwidth_checks(torch, dev, packed, fullwidth_shapes(torch, dev))
    if calls.get("align_profile_batch"):
        path, _ = plan_profile_dp(calls.get("profile_scores_batch", []),
                                  calls["align_profile_batch"], dev)
        fullwidth_launches(torch, "path", path["profile_forward"], True)
        fullwidth_launches(torch, "path", path["profile_forward_scores"],
                           False)


def fullwidth_shapes(torch, dev):
    """The single-launch shapes: 16 one-hot windows of about 1,000
    columns in the 1024 bucket, 2 of about 4,000 at 4096 x 4096."""
    rng = np.random.default_rng(11)
    out = []
    for n, M, N, B in ((1000, 1024, 1024, 16), (4000, 4096, 4096, 2)):
        arrs = mutant_profiles(rng, B, n, M, N)
        out.append((M, N, tuple(torch.from_numpy(x).to(dev)
                                for x in arrs)))
    return out


def wide_shapes(torch, dev):
    """Launches on K3's and K9's wide route (one block a window): 4
    one-hot windows of about 4,500 columns in a 4,608-column bucket, and 2
    of about 9,000 in the 11,664 bucket, which windows of 7,777-10,000
    columns take under the default cap."""
    rng = np.random.default_rng(13)
    return [(M, N, tuple(torch.from_numpy(x).to(dev)
                         for x in mutant_profiles(rng, B, n, M, N)))
            for n, M, N, B in ((4500, 4608, 4608, 4),
                               (9000, 11664, 11664, 2))]


def phase_wide(torch, dev):
    """The light wide-route phase: K3 and K9 on wide_shapes, exact
    against their plain versions, then timed with CUDA events and on the
    card alone (device_ms), with the card's time a row of the longest
    window.  It calls only the wrappers and their plain versions, so the
    same phase times a tree from before the strip kernels."""
    from libmems_tpu_torch.ops import profile
    for M, N, t in wide_shapes(torch, dev):
        B, rows = int(t[0].shape[0]), int(t[2].max())
        ref_p, ref_s = profile.profile_forward_plain(*t)
        got_p, got_s = profile.profile_forward(*t)
        require(torch.equal(got_p, ref_p) and torch.equal(got_s, ref_s),
                f"K3 differs from its plain version at ({M}, {N}) B={B}")
        require(torch.equal(profile.profile_forward_scores(*t), ref_s),
                f"K9 differs from its plain version at ({M}, {N}) B={B}")
        del ref_p, got_p
        parts = []
        for name, fn in (("K3", profile.profile_forward),
                         ("K9", profile.profile_forward_scores)):
            ev = timed_ms(lambda: fn(*t), 5, torch)
            card = device_ms(lambda: fn(*t), 5, torch)
            parts.append(f"{name} {ev:.4f} ms (events), {card:.4f} ms on "
                         f"the card, {card * 1e3 / rows:.3f} us a row")
        log(f"# wide route ({M}, {N}) B={B}, longest p_len {rows}, "
            f"equal: {'; '.join(parts)}")


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


def large_walks(torch, dev, align_calls, launches, res):
    """K4 and K12 against their plain versions on the card, exact, on the
    walk launches of phase 6b's align_profile_batch calls (rebuilt by
    plan_profile_dp, as many as the path made); their kernel ms, bytes
    to the host, tb_unpack's seconds and latency floor, summed over the
    launches.  Widens res's max_abs_err; the path's times stay the 9 x 1
    Mbp path's."""
    from libmems_tpu_torch.ops import gapped, profile
    path, _ = plan_profile_dp([], align_calls, dev)
    fns = {"traceback_walk": (gapped.traceback_walk,
                              gapped.traceback_walk_plain),
           "banded_traceback_walk": (profile.banded_traceback_walk,
                                     profile.banded_traceback_walk_plain)}
    for name, (fn, plain) in fns.items():
        lst = path[name]
        require(len(lst) == launches[name],
                f"{name}: {len(lst)} launches rebuilt, the 3 x {LARGE_LEN} "
                f"bp path made {launches[name]}")
        got = [fn(*a) for a in lst]
        ref, pms = timed_once(lambda: [plain(*a) for a in lst], torch)
        for a, g, r in zip(lst, got, ref):
            require(all(torch.equal(x, y) for x, y in zip(g, r)),
                    f"{name} differs from its plain version on a 3 x "
                    f"{LARGE_LEN} bp launch at {tuple(a[0].shape)}")
            res[name]["err"] = max(res[name]["err"], max_abs_err(zip(g, r)))
        ms = timed_ms(lambda: [fn(*a) for a in lst], 3, torch) if lst \
            else 0.0
        w = sum_work(walk_work(g) for g in got)
        tail_b, tail_s = walk_host_tail(torch, got)
        kind = "full" if name == "traceback_walk" else "banded"
        geo = walk_geometries(kind, [(a[0], a[0].shape[2] - 1 if
                                      kind == "full" else a[4])
                                     for a in lst])
        log(f"# {name} on the 3 x {LARGE_LEN} bp path: {len(lst)} launches "
            f"({sum(int(a[0].shape[0]) for a in lst)} windows), equal; "
            f"kernel {ms:.3f} ms, plain {pms:.3f} ms; walk output to the "
            f"host {tail_b} bytes, tb_unpack {tail_s:.6f} s, latency floor "
            f"{w.get('latency_ms', 0.0):.4f} ms; geometries {geo}")


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
                    tail_b, tail_s = walk_host_tail(torch, got)
                    kind = "full" if name == "traceback_walk" else "banded"
                    geo = walk_geometries(kind, [
                        (a[0], a[0].shape[2] - 1 if kind == "full"
                         else a[4])
                        for a in lst[name]])
                    log(f"# {name} {label}: {len(got)} launches, walk "
                        f"output to the host {tail_b} bytes, tb_unpack "
                        f"{tail_s:.6f} s, latency floor "
                        f"{w['latency_ms']:.4f} ms (longest windows "
                        f"{[int(g.steps.max()) for g in got]} steps); "
                        f"geometries {geo}")
                else:
                    w = sum_work(dp_work(name, a[:4], a[6] if len(a) > 6
                                         else None) for a in lst[name])
                timed = (label, ms, pms, w)
        label, ms, pms, w = timed
        res[name] = entry(max_abs_err(errs), ms, pms, w)
        log(f"# {name}: equal on {', '.join(lb for lb, l in runs if l[name])}"
            f"; kernel {ms:.3f} ms, plain {pms:.3f} ms over the {label} "
            f"launches")
        if name in ("banded_forward_scores", "banded_forward_ptrs"):
            sort_ms = timed_ms(lambda: [profile.band_costs(*a[:4])
                                        for a in path[name]], 3, torch)
            geo = band_geometries(path[name], name == "banded_forward_ptrs")
            log(f"# {name} geometry of the path's launches (windows@N: "
                f"warps a window x columns a lane): {geo}; the full sort "
                f"of their gap costs (the plain version's; the kernel "
                f"selects the largest instead) {sort_ms:.3f} ms")
    for label, lst in runs:   # K3 and K9 launch by launch, every geometry
        for name, emit_ptr in (("profile_forward", True),
                               ("profile_forward_scores", False)):
            if lst[name]:
                fullwidth_launches(torch, label, lst[name], emit_ptr)
    extra_band_launches(torch, dev, fns, res)
    walk_step_costs(torch, dev)
    return res


def hmm_batches(torch, dev, calls):
    """K8's launches of a path's recorded predict_homologous calls,
    rebuilt by hmm.plan_launches, on the card: (the sequential route's
    ragged launches as (obs, offsets, lengths, mats, threshold), the
    chunked route's padded ones as (obs, lengths, mats, threshold))."""
    from libmems_tpu_torch.ops import hmm
    rows, padded = [], []
    for a in calls:
        mats = hmm.log_matrices(a["params"] or hmm.hoxd_params(), dev)
        ragged, wide = hmm.plan_launches(a["sequences"])
        rows += [(*b.tensors(dev), mats, a["threshold"]) for b in ragged]
        padded += [(torch.from_numpy(obs).to(dev),
                    torch.from_numpy(lens).to(dev), mats, a["threshold"])
                   for _, obs, lens in wide]
    return rows, padded


def hmm_step_cycles(torch, rows):
    """Cycles of one step of the sequential route's forward and backward
    chains (hmm.chain_step_cycles, clock64 on one pair of lanes) over the
    longest row of `rows`' first launch (the rows go longest first);
    the second of two runs."""
    from libmems_tpu_torch.ops import hmm
    obs, offsets, lengths, mats, _ = rows[0]
    o, n = int(offsets[0]), int(lengths[0])
    hmm.chain_step_cycles(obs[o:o + n], mats)
    return hmm.chain_step_cycles(obs[o:o + n], mats)


def hmm_vs_plain(torch, dev, batches, calls, label):
    """K8 against its plain version on the card on `batches`
    (hmm_batches): the sequential route's launches bit-equal
    (max_abs_err 0.0), the chunked route's within 1e-12, calls equal;
    each route timed by events and on the card; a chain step's cycles
    and the route's latency floor (each launch's longest row at that
    many cycles a column); the device peak of the path's HMM stage
    (`calls` run again through predict_homologous).  Then the batches of
    padded width FB_SCAN_MIN_T and more once more through the
    sequential route, timed once, against the chunked route: its time,
    the largest posterior difference and the calls that differ.
    Returns the entry, the times summed over the launches."""
    from libmems_tpu_torch.ops import hmm
    rows, padded = batches
    log(f"# K8 {label}: sequential route {len(rows)} launch(es) of "
        f"{[int(r[2].shape[0]) for r in rows]} rows, "
        f"{[int(r[0].shape[0]) for r in rows]} columns, longest "
        f"{[int(r[2][0]) for r in rows]}; chunked route (B x T) "
        f"{sorted(tuple(o.shape) for o, _, _, _ in padded)}")

    def run(fn, bs, **kw):
        return [fn(*b, **kw) for b in bs]

    got = run(hmm.fb_ragged, rows)
    ref, seq_pms = timed_once(lambda: run(hmm.fb_ragged_plain, rows), torch)
    for (o, _, _, _, _), (_, gc), (_, rc) in zip(rows, got, ref):
        require(torch.equal(gc, rc),
                f"K8's sequential route: calls differ ({o.shape[0]} columns)")
    seq_err = max_abs_err([(g[0], r[0]) for g, r in zip(got, ref)])
    require(seq_err == 0.0, f"K8's sequential route: posteriors differ by "
            f"{seq_err}")
    del got, ref
    got = run(hmm.fb_posterior, padded)
    ref, scan_pms = timed_once(lambda: run(hmm.fb_posterior_plain, padded),
                               torch)
    for (o, _, _, _), (_, gc), (_, rc) in zip(padded, got, ref):
        require(torch.equal(gc, rc), f"K8 calls differ at {tuple(o.shape)}")
    scan_err = max_abs_err([(g[0], r[0]) for g, r in zip(got, ref)])
    require(scan_err <= 1e-12, f"K8 posteriors differ by {scan_err}")
    del ref
    ms = timed_ms(lambda: (run(hmm.fb_ragged, rows),
                           run(hmm.fb_posterior, padded)), 3, torch)
    step = hmm_step_cycles(torch, rows) if rows else (0.0, 0.0)
    latency = sum(int(r[2][0]) for r in rows) * max(step) / SM_CLOCK_HZ * 1e3
    routes = {
        "sequential": {
            "launches": len(rows),
            "columns": sum(int(r[2].sum()) for r in rows),
            "events_ms": timed_ms(lambda: run(hmm.fb_ragged, rows), 3,
                                  torch),
            "device_ms": device_ms(lambda: run(hmm.fb_ragged, rows), 3,
                                   torch),
            "plain_ms": seq_pms, "max_abs_err": seq_err,
            "step_cycles": list(step), "latency_bound_ms": latency},
        "chunked": {
            "launches": len(padded),
            "columns": sum(int(b[1].sum()) for b in padded),
            "events_ms": timed_ms(lambda: run(hmm.fb_posterior, padded), 3,
                                  torch),
            "device_ms": device_ms(lambda: run(hmm.fb_posterior, padded), 3,
                                   torch),
            "plain_ms": scan_pms, "max_abs_err": scan_err}}
    if padded:
        seq, routes["sequential_on_wide_ms"] = timed_once(
            lambda: run(hmm.fb_posterior, padded, sequential=True), torch)
        routes["wide_max_post_diff"] = max_abs_err(
            [(g[0], q[0]) for g, q in zip(got, seq)])
        routes["wide_calls_differ"] = sum(int((g[1] != q[1]).sum())
                                          for g, q in zip(got, seq))
        del seq
    del got
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for a in calls:
        hmm.predict_homologous(a["sequences"], a["params"], a["threshold"],
                               device=dev)
    routes["stage_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    cols = routes["sequential"]["columns"] + routes["chunked"]["columns"]
    # observations in, f64 posteriors and calls out, over each sequence's
    # columns
    e = entry(max(seq_err, scan_err), ms, seq_pms + scan_pms,
              work(10 * cols, HMM_COLUMN_OPS * cols, F64_OPS_PER_S))
    e["work"]["latency_ms"] = latency
    log(f"# K8 {label} vs plain: max_abs_err {seq_err} (sequential), "
        f"{scan_err} (chunked), calls equal; kernel {ms:.3f} ms, plain "
        f"{seq_pms + scan_pms:.3f} ms, bound {bound(e['work'])[0]:.6f} ms, "
        f"latency floor {latency:.4f} ms, {len(rows) + len(padded)} "
        f"launches; by route: " + json.dumps(routes))
    return e


def phase_hmm(torch, dev, calls, launches, large_calls=None,
              large_launches=None, save=False):
    """K8 against its plain version on the card, on the launches of the
    first progressive run's predict_homologous calls at their full
    lengths, rebuilt by hmm.plan_launches (fb_ragged's for the
    sequential route, fb_posterior's for the chunked one; each count the
    path's): the sequential route bit for bit, the chunked within 1e-12,
    calls equal; and, where phase large ran, on the 3 x 8.7 Mbp path's
    the same way (logged apart); with `save`, both paths' calls to
    HMM_CALLS.  Returns the 9 x 1 Mbp entry, the times summed over those
    launches."""
    def rebuilt(calls, launches, label):
        rows, padded = hmm_batches(torch, dev, calls)
        for name, made in (("fb_ragged", rows), ("fb_posterior", padded)):
            require(len(made) == launches[name],
                    f"{len(made)} {name} launches rebuilt, the {label} path "
                    f"made {launches[name]}")
        return rows, padded

    e = hmm_vs_plain(torch, dev, rebuilt(calls, launches, "progressive"),
                     calls, f"{PROG_GENOMES} x {PROG_LEN} bp")
    paths = {"progressive": calls}
    if large_calls is not None:
        hmm_vs_plain(torch, dev,
                     rebuilt(large_calls, large_launches, "3 x 8.7 Mbp"),
                     large_calls, f"{LARGE_GENOMES} x {LARGE_LEN} bp")
        paths["large"] = large_calls
    if save:
        save_hmm_calls(paths)
    return e


_HMM_PARAMS = ("start_homologous", "go_homologous", "go_unrelated",
               "go_stop_from_homologous", "go_stop_from_unrelated")


def save_hmm_calls(paths, path=HMM_CALLS):
    """Write each path's recorded predict_homologous calls (sequences,
    params, threshold) to `path`."""
    from libmems_tpu_torch.ops import hmm
    out = {}
    for label, calls in paths.items():
        seqs = [s for a in calls for s in a["sequences"]]
        pars = [a["params"] or hmm.hoxd_params() for a in calls]
        out[label + ":seqs"] = np.concatenate(seqs) if seqs \
            else np.zeros(0, np.uint8)
        out[label + ":lens"] = np.array([len(s) for s in seqs], np.int64)
        out[label + ":calls"] = np.array([len(a["sequences"]) for a in calls],
                                         np.int64)
        out[label + ":thresholds"] = np.array([a["threshold"] for a in calls])
        out[label + ":scalars"] = np.array(
            [[getattr(q, k) for k in _HMM_PARAMS] for q in pars])
        out[label + ":emit"] = np.array(
            [np.concatenate([q.emit_homologous, q.emit_unrelated])
             for q in pars])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **out)
    log(f"# HMM calls of {sorted(paths)} written to {path}")


def load_hmm_calls(path=HMM_CALLS):
    """{label: [(sequences, HmmParams, threshold), ...]} from `path`."""
    from libmems_tpu_torch.ops import hmm
    require(os.path.exists(path), f"{path} is missing: run "
            f"`chip_smoke.py {'hmm' if path == HMM_CALLS else 'decode'}` "
            f"first")
    z = np.load(path)
    out = {}
    for label in sorted({k.split(":")[0] for k in z.files}):
        seqs = np.split(z[label + ":seqs"], np.cumsum(z[label + ":lens"])[:-1])
        bounds = np.concatenate([[0], np.cumsum(z[label + ":calls"])])
        calls = []
        for c, th in enumerate(z[label + ":thresholds"]):
            sc, em = z[label + ":scalars"][c], z[label + ":emit"][c]
            par = hmm.HmmParams(**dict(zip(_HMM_PARAMS, map(float, sc))),
                                emit_homologous=em[:8].copy(),
                                emit_unrelated=em[8:].copy())
            calls.append((seqs[bounds[c]:bounds[c + 1]], par, float(th)))
        out[label] = calls
    return out


def trace_kernels(path):
    """{name: [events, device ms]} of a Chrome trace's kernels, memcpys
    and memsets (a kernel by its name before the argument list)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out = {}
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if cat == "kernel":
            m = re.search(r"(\w+)(?:<[^()]*>)?\(", e["name"])
            name = m.group(1) if m else e["name"][:60]
        else:
            name = cat + ":" + e["name"].split(" ")[0]
        c = out.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += e["dur"] / 1e3
    return out


def phase_hmmstage(torch, dev):
    """The HMM stage of each path as the path runs it: its recorded
    predict_homologous calls (HMM_CALLS) through predict_homologous on
    the card, after one warm-up: the wall (host clock, synchronised,
    median of 3), the device time by kernel in one traced run
    (torch.profiler, CUDA activity), and the device peak above what was
    allocated before."""
    from libmems_tpu_torch.ops import hmm
    for label, calls in load_hmm_calls().items():
        def run():
            for seqs, par, th in calls:
                hmm.predict_homologous(seqs, par, th, device=dev)
        wall = host_ms(run, 3, torch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        peak = torch.cuda.max_memory_allocated() - base
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        path = os.path.join(os.path.dirname(HMM_CALLS), f"{label}.json")
        prof.export_chrome_trace(path)
        kernels = trace_kernels(path)
        log(f"# HMM stage {label}: {len(calls)} calls, "
            f"{sum(len(c[0]) for c in calls)} sequences, "
            f"{sum(len(x) for c in calls for x in c[0])} columns; wall "
            f"{wall:.3f} ms, device peak {peak} bytes, device ms by "
            f"kernel: " + json.dumps(
                {k: [n, round(ms, 4)] for k, (n, ms) in sorted(
                    kernels.items(), key=lambda kv: -kv[1][1])}))


def decode_batches(torch, hmm, by_call, dev):
    """The padded batches (hmm.pack_batches, with their call's log
    matrices) of the decode run's viterbi_homologous calls ((sequences,
    params) each), and those K20 and K21 are held to their plain
    versions on: T <= HMM_CHECK_MAX_T and the longest.  Through names
    older trees share.  Returns (batches, chosen)."""
    batches = []
    for seqs, params in by_call:
        mats = hmm.log_matrices(params, dev)
        for _, obs, lens in hmm.pack_batches(seqs):
            batches.append((torch.from_numpy(obs).to(dev),
                            torch.from_numpy(lens).to(dev), mats))
    longest = max(range(len(batches)),
                  key=lambda i: int(batches[i][1].max()))
    return batches, [t for i, t in enumerate(batches)
                     if t[0].shape[1] <= HMM_CHECK_MAX_T or i == longest]


def viterbi_timings(torch, hmm, by_call, chosen, dev):
    """K20 timed through names older trees share: the decode run's
    viterbi_homologous calls ((sequences, params) each), their wall
    (host clock, synchronised, median of 3 after a warm-up), the launches
    they make, the card time of K20's kernels (names with viterbi) in a
    profiled run; and the chosen padded batches through viterbi_path (Σ
    by events and on the card).  Returns a dict of them."""
    def run():
        for seqs, params in by_call:
            hmm.viterbi_homologous(seqs, params, device=dev)
    wrappers = [w for w in (getattr(hmm, "viterbi_ragged", None),
                            hmm.viterbi_path) if w is not None]
    run()
    for w in wrappers:
        w.launches = 0
    wall = host_ms(run, 3, torch)
    launches = {w.__name__: w.launches // 4 for w in wrappers}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    path = os.path.join(OUT_DIR, "viterbi_trace.json")
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(path)
    kernels = trace_kernels(path)

    def chosen_run():
        return [hmm.viterbi_path(*t) for t in chosen]
    return {"calls": len(by_call),
            "sequences": sum(len(c[0]) for c in by_call),
            "columns": sum(len(x) for c in by_call for x in c[0]),
            "wall_ms": wall, "launches": launches,
            "card_ms": sum(ms for k, (_, ms) in kernels.items()
                           if "viterbi" in k),
            "trace": {k: [n, round(ms, 4)] for k, (n, ms) in kernels.items()},
            "chosen_launches": len(chosen),
            "chosen_events_ms": timed_ms(chosen_run, 3, torch),
            "chosen_card_ms": device_ms(chosen_run, 3, torch)}


def viterbi_floor_ms(n_cols, cycles):
    """K20's latency floor for a launch whose longest row has n_cols
    columns: its forward and walk steps (clock64 cycles a column, one
    thread) at SM_CLOCK_HZ."""
    return n_cols * (cycles[0] + cycles[1]) / SM_CLOCK_HZ * 1e3


def viterbi_checks(torch, hmm, chosen, rec20, by_call, dev):
    """K20 on the card against its plain version, exact: on the chosen
    padded batches through viterbi_path (rows at offsets r x T) and on
    every ragged launch of the decode run's viterbi_homologous calls
    (recorded, replayed through viterbi_ragged), the ragged launches
    timed by events and on the card; one column's forward and walk
    steps by clock64 on the corpus's longest row, each launch's latency
    floor from them, and one launch on 1, 32, 128 and 256 copies of that
    row (how a row's column time grows with the rows beside it); then
    viterbi_timings.  Returns K20's entry: the decode run's ragged
    launches (their Σ, plain Σ and work, latency floor the Σ of their
    floors)."""
    got = [hmm.viterbi_path(*t) for t in chosen]
    ref, p_chosen = timed_once(lambda: [hmm.viterbi_path_plain(*t)
                                        for t in chosen], torch)
    for (o, _, _), g, r in zip(chosen, got, ref):
        require(torch.equal(g, r), f"K20 differs from its plain version "
                f"at {tuple(o.shape)} (viterbi_path)")
    err_chosen = max_abs_err(zip(got, ref))
    del got, ref
    calls = [(c["obs"], c["offsets"], c["lengths"], c["mats"])
             for c in rec20["viterbi_ragged"]]
    got = [hmm.viterbi_ragged(*a) for a in calls]
    ref, p_rag = timed_once(lambda: [hmm.viterbi_ragged_plain(*a)
                                     for a in calls], torch)
    for (o, _, n, _), g, r in zip(calls, got, ref):
        require(torch.equal(g, r), f"K20 differs from its plain version "
                f"on a ragged launch of {n.shape[0]} rows, {o.shape[0]} "
                f"columns")
    err = max(err_chosen, max_abs_err(zip(got, ref)))
    del got, ref
    ms_rag = timed_ms(lambda: [hmm.viterbi_ragged(*a) for a in calls], 3,
                      torch)
    card_rag = device_ms(lambda: [hmm.viterbi_ragged(*a) for a in calls], 3,
                         torch)
    longest = max((x for c in by_call for x in c[0]), key=len)
    row = torch.from_numpy(np.ascontiguousarray(longest)).to(dev)
    hmm.viterbi_step_cycles(row, calls[0][3])
    cycles = hmm.viterbi_step_cycles(row, calls[0][3])
    floors = [viterbi_floor_ms(int(a[2].max()), cycles) for a in calls]
    card_each = [device_ms(lambda a=a: hmm.viterbi_ragged(*a), 3, torch)
                 for a in calls]
    copies = {}
    for n in (1, 32, 128, 256):
        batch, = hmm.pack_ragged([longest] * n, list(range(n)))
        t = batch.tensors(dev)
        ms = device_ms(lambda: hmm.viterbi_ragged(*t, calls[0][3]), 3, torch)
        copies[n] = [round(ms, 4),
                     round(ms * 1e-3 * SM_CLOCK_HZ / len(longest), 2)]
    del t
    cols = sum(int(a[2].sum()) for a in calls)
    w = work(sum(2 * a[0].shape[0] + 12 * a[2].shape[0] for a in calls),
             VITERBI_COLUMN_OPS * cols, F64_OPS_PER_S)
    w["latency_ms"] = sum(floors)
    e = entry(err, ms_rag, p_rag, w)
    e["card_ms"] = card_rag
    tm = viterbi_timings(torch, hmm, by_call, chosen, dev)
    chosen_floor = sum(viterbi_floor_ms(int(t[1].max()), cycles)
                       for t in chosen)
    log(f"# K20 step on the corpus's longest row ({len(longest)} columns, "
        f"clock64, one thread): forward {cycles[0]:.2f} cycles a column, "
        f"walk {cycles[1]:.2f}; one launch on n copies of it, {{n: [ms "
        f"card, cycles a column at {SM_CLOCK_HZ / 1e9} GHz]}}: "
        f"{json.dumps(copies)}")
    log(f"# K20 on the chosen batches ({len(chosen)} launches of "
        f"viterbi_path): Σ {tm['chosen_events_ms']:.4f} ms events, "
        f"{tm['chosen_card_ms']:.4f} ms card, plain {p_chosen:.4f} ms; Σ "
        f"latency floor {chosen_floor:.4f} ms; equal")
    log(f"# K20 over the decode run's viterbi_homologous calls: "
        f"{len(calls)} ragged launches of "
        f"{[int(a[2].shape[0]) for a in calls]} rows, {cols} columns; Σ "
        f"{ms_rag:.4f} ms events, {card_rag:.4f} ms card, plain "
        f"{p_rag:.4f} ms; each launch on the card "
        f"{[round(c, 4) for c in card_each]} ms against its floor "
        f"{[round(f, 4) for f in floors]} ms (ratio "
        f"{[round(c / f, 3) for c, f in zip(card_each, floors)]}); equal; "
        f"the calls' wall {tm['wall_ms']:.4f} ms, launches "
        f"{tm['launches']}, K20's card time by the profiler "
        f"{tm['card_ms']:.4f} ms")
    return e


def phase_decode(torch, lt, dev, hmm_calls, sweep=False):
    """Decode and pairwise DP: the API that libMems ships but no path of
    it calls.  Counted run: align_pairs on the pair path's inter-anchor
    windows (every bucket walked on the card: K23 + K4) and on the mutant
    pairs (over DEVICE_TB_BUDGET: K22, packed K23 blocks, the host walk),
    viterbi_homologous on the sequences of the first progressive run's
    predict_homologous calls (written to DECODE_CALLS) and 2 iterations
    of baum_welch on all of them.  Then K22 and every K23 call of that
    run (replayed from their recorded arguments) against their plain
    versions (exact: scores, carries, pointer bytes, the masks walked
    over the plain blocks, which score to the DP score), K20 (exact, on
    the run's ragged launches and, through viterbi_path, on the HMM
    batches of T <= HMM_CHECK_MAX_T and the longest one: viterbi_checks)
    and K21 (1e-12 relative) on those batches, and K2 at 64
    and 1,000 slots a row (find_mums on 64 genomes, GPU == CPU tensors;
    find_repeats on a 1,000-copy family), in shared memory and in global
    scratch.  With `sweep`, gotoh_sweep on K22's launch and K23's largest
    call.  Returns ({name: entry}, the counted run's launches, K2's
    max_abs_err)."""
    from libmems_tpu_torch import matchfind, repeats
    from libmems_tpu_torch.ops import extend, gapped, hmm
    from libmems_tpu_torch.sml import create_smls
    wrappers = {"gotoh_forward": gapped.gotoh_forward,
                "gotoh_block_ptrs": gapped.gotoh_block_ptrs,
                "traceback_walk": gapped.traceback_walk,
                "viterbi_ragged": hmm.viterbi_ragged,
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
    # K23's calls, by the wrapper the route calls (an older tree's copy
    # has no batch wrapper: it fetches a block a launch)
    with recording([(gapped, n) for n in K23_WRAPPERS
                    if hasattr(gapped, n)]) as rec23:
        t0 = time.perf_counter()
        win_masks = gapped.align_pairs(win_pairs, device=dev)
        t1 = time.perf_counter()
        mut_masks = gapped.align_pairs(mut_pairs, device=dev)
        t2 = time.perf_counter()
    with recording([(hmm, "viterbi_ragged")]) as rec20:
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
    save_hmm_calls({"decode": hmm_calls}, DECODE_CALLS)
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
    for idxs, a, b, al, bl, K, _ in win_plan:
        aj, bj = put(a), put(b)
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
    card22 = device_ms(lambda: gapped.gotoh_forward(aj, bj, alj, blj, go,
                                                    ge, K), 3, torch)
    w22 = work(nbytes(aj, bj, alj, blj, *got22),
               GOTOH_CELL_OPS * B * Mp * (N + 1))
    w22["latency_ms"] = dp_latency_ms([Mp], [N])
    res["gotoh_forward"] = entry(max_abs_err(zip(got22, ref22)), ms22, p22,
                                 w22)
    res["gotoh_forward"]["card_ms"] = card22
    log(f"# K22 at {B} x {Mp} x {N + 1}: {ms22:.4f} ms events, "
        f"{card22:.4f} ms card, plain {p22:.4f} ms; bound "
        f"{bound(w22)[0]:.6f} ms, latency floor {w22['latency_ms']:.4f} ms")
    # K23: every call of the counted run replayed through its wrapper,
    # each held to its plain version, then timed together
    calls23 = [(name, c) for name, cs in rec23.items() for c in cs]
    n0 = gapped.gotoh_block_ptrs.launches
    got23 = [k23_run(gapped, *x) for x in calls23]
    require(gapped.gotoh_block_ptrs.launches - n0
            == launches["gotoh_block_ptrs"],
            f"K23: {gapped.gotoh_block_ptrs.launches - n0} launches "
            f"replayed, the decode run made {launches['gotoh_block_ptrs']}")
    ref23, p23 = timed_once(lambda: [k23_plain(gapped, *x)
                                     for x in calls23], torch)
    for (name, c), g, r in zip(calls23, got23, ref23):
        require(torch.equal(g, r), f"K23 ({name}) differs from its plain "
                f"version at {tuple(g.shape)} (packed {c['packed']})")
    ms23 = timed_ms(lambda: [k23_run(gapped, *x) for x in calls23], 3,
                    torch)
    card23 = device_ms(lambda: [k23_run(gapped, *x) for x in calls23], 3,
                       torch)
    w23 = sum_work(k23_work(*x, g) for x, g in zip(calls23, got23))
    res["gotoh_block_ptrs"] = entry(max_abs_err(zip(got23, ref23)), ms23,
                                    p23, w23)
    res["gotoh_block_ptrs"]["card_ms"] = card23
    if sweep:
        gotoh_sweep(torch, aj, bj, alj, blj, K, [
            c for name, c in calls23 if name == "gotoh_block_ptrs_batch"])
    # the walk over the plain blocks: the batch calls' by block index
    # (an older tree's single blocks are made again as the walk asks)
    nb = Mp // K
    blocks = {}
    for (name, c), r in zip(calls23, ref23):
        if name == "gotoh_block_ptrs_batch":
            blocks.update((c["first"] + k, r[k]) for k in range(c["G"]))
    del got23, ref23
    fetched = []

    def fetch(bi):
        fetched.append(bi)
        if bi not in blocks:
            blocks[bi] = gapped.gotoh_block_ptrs_plain(
                got22[1][bi], got22[2][bi],
                aj[:, bi * K:(bi + 1) * K].contiguous(), bj, go, ge, True)
        return gapped.unpack_ptrs(blocks[bi].cpu().numpy(), N + 1)
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
    del blocks, got22, ref22
    log(f"# checkpointed route: K22 equals its plain version; the walk over "
        f"the plain blocks gives the run's masks ({len(fetched)} blocks "
        f"fetched), scores {dp[:len(idxs)].tolist()}")
    log(f"# K23 over the decode run: {launches['gotoh_block_ptrs']} launches "
        f"in {len(calls23)} calls "
        f"({', '.join(k23_shape(*x) for x in calls23)}), each equal to its "
        f"plain version; Σ {ms23:.4f} ms events, {card23:.4f} ms card, "
        f"plain {p23:.4f} ms; Σ bound {bound(w23)[0]:.6f} ms, Σ latency "
        f"floor {w23['latency_ms']:.4f} ms")

    # K20 and K21 on the HMM batches up to HMM_CHECK_MAX_T and the longest
    batches, chosen = decode_batches(torch, hmm, by_call, dev)
    require(any(t[0].shape[1] >= hmm.FB_SCAN_MIN_T for t in chosen),
            "no K21 batch of the chunked route's widths")
    cols = sum(int(n.sum()) for _, n, _ in chosen)
    rows = sum(int(n.numel()) for _, n, _ in chosen)
    log(f"# K20/K21 batches (B x T) compared: "
        f"{sorted(tuple(o.shape) for o, _, _ in chosen)} of "
        f"{len(batches)}, {cols} columns")
    res["viterbi_ragged"] = viterbi_checks(torch, hmm, chosen, rec20,
                                           by_call, dev)
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
    # K21's sequential route runs K8's two chains, so K8's measured step
    # (the longer of its forward and backward steps) floors each of its
    # launches at one chain of its longest row
    seq21 = [t for t in chosen if t[0].shape[1] < hmm.FB_SCAN_MIN_T]
    o, n, m = max(seq21, key=lambda t: int(t[1].max()))
    r = int(torch.argmax(n))
    hmm.chain_step_cycles(o[r, :int(n[r])], m)
    step = max(hmm.chain_step_cycles(o[r, :int(n[r])], m))
    res["bw_counts"]["work"]["latency_ms"] = sum(
        int(t[1].max()) for t in seq21) * step / SM_CLOCK_HZ * 1e3
    log(f"# K21 within {rel} relative; K21's sequential "
        f"launches' latency floor {res['bw_counts']['work']['latency_ms']:.4f}"
        f" ms at K8's step of {step:.1f} cycles")

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
    profiles and lengths read, the score and the carries written; its
    latency floor is Mp dependent rows of N+1 columns (dp_latency_ms)."""
    B, Mp, _ = t[0].shape
    N = t[1].shape[1]
    w = work(nbytes(*t) + 4 * B + 8 * (Mp // K) * B * (N + 1),
             DP_CELL_OPS * B * Mp * (N + 1))
    w["latency_ms"] = dp_latency_ms([Mp], [N])
    return w


def block_work(c):
    """Work of one batched K25 launch (a recorded profile_block_ptrs_batch
    call c): every cell of its G x B blocks of R rows, their carries,
    rows and q read, the nibble-packed pointers written; its latency
    floor is R dependent rows (the blocks run side by side)."""
    nb, B = c["ck_h"].shape[:2]
    N = c["q"].shape[1]
    R = c["p"].shape[1] // nb
    G = c["G"]
    w = work(8 * G * B * (N + 1) + 20 * G * B * R + nbytes(c["q"], c["q_len"])
             + G * B * R * ((N + 2) // 2), DP_CELL_OPS * G * B * R * (N + 1))
    w["latency_ms"] = dp_latency_ms([R], [N])
    return w


def ckpt_vs_plain(torch, t, go, ge, geometries=(None,)):
    """K24 and K25 against their plain versions on the launch t, in each
    geometry (None: the launcher's pick): K24's score and carries, K25
    over every row block in one launch and block 0 alone.  The plain
    versions run once.  Returns the compared pairs, K24's first."""
    from libmems_tpu_torch.ops import profile
    K = profile.CKPT_ROWS
    nb = t[0].shape[1] // K
    ref = profile.profile_forward_ckpt_plain(*t, go, ge, K)
    ref25 = profile.profile_block_ptrs_batch_plain(ref[1], ref[2], t[0], t[1],
                                                   t[3], 0, nb, go, ge)
    p24, p25 = [], []
    for geo in geometries:
        got = profile.profile_forward_ckpt(*t, go, ge, K, geometry=geo)
        d = profile.span_geometry(t[0].shape[0], t[0].shape[1],
                                  t[1].shape[1], False, geo)
        where = (f"at {tuple(t[0].shape)} x {t[1].shape[1]}, K = {d['K']}, "
                 f"{d['blocks']} blocks of {d['warps']} strips")
        for g, r, what in zip(got, ref, ("score", "ck_h", "ck_f")):
            require(torch.equal(g, r), f"K24 {what} differs from its plain "
                    f"version {where}")
        p24 += list(zip(got, ref))
        many = profile.profile_block_ptrs_batch(got[1], got[2], t[0], t[1],
                                                t[3], 0, nb, go, ge,
                                                geometry=geo)
        one = profile.profile_block_ptrs(got[1][0], got[2][0],
                                         t[0][:, :K].contiguous(), t[1], t[3],
                                         go, ge, geometry=geo)
        require(torch.equal(many, ref25) and torch.equal(one, ref25[0]),
                f"K25 differs from its plain version {where}")
        p25 += [(many, ref25), (one, ref25[0])]
    return p24, p25


class RouteSplit:
    """The checkpointed route's time by part, on the host clock with the
    card synchronised at each boundary: K24 (profile_forward_ckpt), K25
    (its launches), the copies to the host, the unpack and the host walk
    (traceback_blocks less its fetches).  A context manager that wraps
    the names ops.profile's route calls."""

    def __init__(self, torch):
        from libmems_tpu_torch.ops import profile
        self.torch, self.profile = torch, profile
        self.s = dict.fromkeys(("K24", "K25", "fetch", "unpack", "walk"), 0.0)
        self.n = {"K25": 0, "fetch": 0}

    def _timed(self, key, fn, sync=True):
        @functools.wraps(fn)
        def run(*a, **kw):
            if sync:
                self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                self.torch.cuda.synchronize()
            self.s[key] += time.perf_counter() - t0
            if key in self.n:
                self.n[key] += 1
            return out
        return run

    def __enter__(self):
        p = self.profile
        self.saved = {k: getattr(p, k) for k in (
            "profile_forward_ckpt", "profile_block_ptrs_batch",
            "unpack_ptrs", "traceback_blocks")}
        for key, name in (("K24", "profile_forward_ckpt"),
                          ("K25", "profile_block_ptrs_batch")):
            fn = getattr(p, name)
            setattr(p, name, Patched(fn, self._timed(key, fn)))
        p.unpack_ptrs = self._timed("unpack", p.unpack_ptrs, sync=False)
        real_tb = self.saved["traceback_blocks"]

        def tb(fetch, *a, **kw):
            t0 = time.perf_counter()
            out = real_tb(self._timed("fetch", fetch, sync=False), *a, **kw)
            self.s["walk"] += time.perf_counter() - t0
            return out
        p.traceback_blocks = tb
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.profile, k, v)

    def text(self):
        s = self.s
        copy = s["fetch"] - s["K25"] - s["unpack"]
        walk = s["walk"] - s["fetch"]
        return (f"K24 {s['K24']:.4f} s, K25 {s['K25']:.4f} s in "
                f"{self.n['K25']} launches, copies {copy:.4f} s, unpack "
                f"{s['unpack']:.4f} s, host walk {walk:.4f} s "
                f"({self.n['fetch']} blocks fetched)")


def span_sweep(torch, c24, c25):
    """K24 on the recorded launch c24 and K25 on c25 in every geometry of
    SWEEP_GEOMETRIES that fits the card: each output equal to the
    pick's, its time on the card alone beside span_cost's price (the
    data span_cost is fitted to)."""
    from libmems_tpu_torch.ops import profile
    B, M, N = c24["p"].shape[0], c24["p"].shape[1], c24["q"].shape[1]
    G, R = c25["G"], c25["p"].shape[1] // c25["ck_h"].shape[0]
    for label, fn, args, n_inst, rows, ptr in (
            ("K24", profile.profile_forward_ckpt, c24, B, M, False),
            ("K25", profile.profile_block_ptrs_batch, c25, G * B, R, True)):
        base = fn(**args)
        base = base if isinstance(base, tuple) else (base,)
        for geo in SWEEP_GEOMETRIES:
            d = profile.span_geometry(n_inst, rows, N, ptr, geo)
            where = f"K = {d['K']}, {d['warps']} strips a block"
            if d["blocks_per_sm"] <= 0:
                log(f"# sweep {label} {where}: does not fit")
                continue
            kw = dict(args, geometry=geo)
            out = fn(**kw)
            out = out if isinstance(out, tuple) else (out,)
            require(all(torch.equal(x, y) for x, y in zip(out, base)),
                    f"{label} in geometry {geo} differs from the pick's")
            ms = device_ms(lambda: fn(**kw), 1, torch)
            log(f"# sweep {label} {where} ({d['blocks_per_sm']} an SM): "
                f"{ms:.3f} ms on the card, priced {d['cost_ns'] / 1e6:.3f}")
        log(f"# sweep {label} pick: "
            f"{profile.span_geometry(n_inst, rows, N, ptr)['geometry']}")


def k23_run(gapped, name, c):
    """A recorded K23 call replayed through its wrapper."""
    return getattr(gapped, name)(**c)


def k23_plain(gapped, name, c):
    """The plain version of a recorded K23 call."""
    if name == "gotoh_block_ptrs_batch":
        return gapped.gotoh_block_ptrs_batch_plain(
            c["ck_h"], c["ck_f"], c["a"], c["b"], c["first"], c["G"],
            c["gap_open"], c["gap_extend"], c["packed"])
    return gapped.gotoh_block_ptrs_plain(c["ck_h"], c["ck_f"], c["a_blk"],
                                         c["b"], c["gap_open"],
                                         c["gap_extend"], c["packed"])


def k23_rows(name, c):
    """(row blocks, rows a block, carries read) of a recorded K23 call:
    the batch's G blocks (block 0 made from the DP's first row) or one
    block from its carry or from the first row."""
    if name == "gotoh_block_ptrs_batch":
        R = c["a"].shape[1] // c["ck_h"].shape[0]
        return c["G"], R, c["G"] - (c["first"] == 0)
    return 1, c["a_blk"].shape[1], int(c["ck_h"] is not None)


def k23_shape(name, c):
    G, R, _ = k23_rows(name, c)
    return f"{G} x {c['b'].shape[0]} x {R} x {c['b'].shape[1] + 1}"


def k23_work(name, c, out):
    """Work of one K23 call: every cell of its G blocks of B x R rows, the
    carries it reads (8 bytes a column a pair), a's rows, b and the
    pointer bytes written once each; its latency floor is R dependent
    rows of N+1 columns (the blocks run side by side)."""
    G, R, carried = k23_rows(name, c)
    B, N = c["b"].shape
    w = work(8 * carried * B * (N + 1) + G * B * R + B * N + nbytes(out),
             GOTOH_PTR_CELL_OPS * G * B * R * (N + 1))
    w["latency_ms"] = dp_latency_ms([R], [N])
    return w


def gotoh_sweep(torch, aj, bj, alj, blj, K, calls23=()):
    """K22 on phase 9's launch (aj, bj, alj, blj, K) and K23 on its
    largest batched call (calls23: the decode run's recorded
    gotoh_block_ptrs_batch calls) in the pick's geometry and every
    geometry of SWEEP_GEOMETRIES that fits the card: each output equal to
    the pick's, its time on the card alone beside span_cost's price
    (K24's and K25's SPAN_COST, which K22's and K23's picks take), and
    the pick's time over the best's."""
    from libmems_tpu_torch.ops import gapped, profile
    go, ge = gapped.GAP_OPEN, gapped.GAP_EXTEND
    B, M, N = aj.shape[0], aj.shape[1], bj.shape[1]
    if calls23:
        c = max(calls23, key=lambda c: c["G"])
        R = c["a"].shape[1] // c["ck_h"].shape[0]
        fits = profile.span_fits("lm_gotoh_fits", 1)[1]
        pick = gapped.gotoh_geometry(c["G"] * B, R, N, ptr=True)["geometry"]
        base = gapped.gotoh_block_ptrs_batch(**c)
        times = {}
        for geo in dict.fromkeys((pick,) + SWEEP_GEOMETRIES):
            if fits.get(geo, 0) < 1:
                log(f"# sweep K23 {geo}: does not fit")
                continue
            d = gapped.gotoh_geometry(c["G"] * B, R, N, geo, ptr=True)
            kw = dict(c, geometry=geo)
            require(torch.equal(gapped.gotoh_block_ptrs_batch(**kw), base),
                    f"K23 in geometry {geo} differs from the pick's")
            times[geo] = device_ms(
                lambda: gapped.gotoh_block_ptrs_batch(**kw), 1, torch)
            log(f"# sweep K23 {c['G']} x {B} blocks, K = {d['K']}, "
                f"{d['warps']} strips a block ({d['blocks']} blocks a "
                f"row block, {d['blocks_per_sm']} an SM"
                f"{', the pick' if geo == pick else ''}): "
                f"{times[geo]:.3f} ms on the card, priced "
                f"{d['cost_ns'] / 1e6:.3f}")
        best = min(times, key=times.get)
        log(f"# sweep K23 pick {pick} {times[pick]:.3f} ms, best {best} "
            f"{times[best]:.3f} ms: {times[pick] / times[best]:.3f}x")
    fits = profile.span_fits("lm_gotoh_fits", 0)[1]
    pick = gapped.gotoh_geometry(B, M, N)["geometry"]
    base = gapped.gotoh_forward(aj, bj, alj, blj, go, ge, K)
    for geo in dict.fromkeys((pick,) + SWEEP_GEOMETRIES):
        if fits.get(geo, 0) < 1:
            log(f"# sweep K22 {geo}: does not fit")
            continue
        d = gapped.gotoh_geometry(B, M, N, geo)
        out = gapped.gotoh_forward(aj, bj, alj, blj, go, ge, K, geometry=geo)
        require(all(torch.equal(x, y) for x, y in zip(out, base)),
                f"K22 in geometry {geo} differs from the pick's")
        ms = device_ms(lambda: gapped.gotoh_forward(
            aj, bj, alj, blj, go, ge, K, geometry=geo), 1, torch)
        log(f"# sweep K22 K = {d['K']}, {d['warps']} strips a block "
            f"({d['blocks']} blocks a pair, {d['blocks_per_sm']} an SM"
            f"{', the pick' if geo == pick else ''}): {ms:.3f} ms on the "
            f"card, priced {d['cost_ns'] / 1e6:.3f}")


def phase_bounded(torch, lt, dev, sweep=False):
    """The memory-bounded routes.  (1) K24 and K25 (all row blocks in one
    launch, and one alone) against their plain versions on 2 windows of
    about 2,300 columns and 2,304 rows, one-hot and 3+2-row profiles
    (exact), in the launcher's geometry and in two forced ones whose
    windows span 2 and 10 blocks.  (2) align + write_xmfa of the
    swapped-locus pair with max_gapped_window 40,000 (counted run): the
    34,003 x 34,000 window takes the checkpointed route (CKPT_STATS, K24
    and K25 launched), its time split by part (RouteSplit); the same
    input with PTR_BUDGET raised here (K3 + K4 in one launch) writes the
    same XMFA bytes; both walls and device memory peaks printed.  (3) genome a's SML saved and loaded back memory-mapped
    equals the in-memory one; create_big through the native bridge
    (mem_limit 64 MB) writes save()'s bytes; find_mums_checkpointed over
    CKPT_CHUNKS ranges, stopped after range CKPT_STOP and resumed, equals
    find_mums and leaves an uninterrupted run's file bytes.  The phase
    (its plain versions on the counted launches aside) must end within
    BOUNDED_CAP_S.  (4) K24 and K25 timed over the counted run's
    launches with CUDA events and on the card alone (device_ms), and
    their plain versions timed and compared there too (K25's on its
    first and last launches, whose event times its entry holds); with
    `sweep`, span_sweep on the first launch of each.  Returns ({name:
    entry}, the counted run's launches, walls)."""
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
        p24, p25 = ckpt_vs_plain(torch, t, go, ge, CKPT_CHECK_GEOMETRIES)
        errs["profile_forward_ckpt"] += p24
        errs["profile_block_ptrs"] += p25
        geos = [profile.span_geometry(2, t[0].shape[1], t[1].shape[1],
                                      False, g) for g in
                CKPT_CHECK_GEOMETRIES]
        log(f"# K24 and K25 (all {t[0].shape[1] // K} row blocks at once, "
            f"and block 0 alone) equal their plain versions on 2 {label} "
            f"windows, {tuple(t[0].shape)} x {t[1].shape[1]}, in "
            + ", ".join(f"K = {d['K']} x {d['warps']} strips a block "
                        f"({d['blocks']} blocks)" for d in geos))

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
        with recording([(profile, "ckpt_tracebacks"),
                        (profile, "profile_forward_ckpt"),
                        (profile, "profile_block_ptrs_batch")]) as rec, \
                RouteSplit(torch) as split:
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
        f"their route {sum(ckpt_walls):.3f} s: {split.text()}")
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
    for N in sorted({c["q"].shape[1] for c in calls}):
        geo = profile.profile_geometry(1, N, True)
        log(f"# K3's one launch at N = {N}: {geometry_label(geo)}")
        require(geo["route"] == "wide", f"K3 at N = {N} is not on the wide "
                f"route")
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

    # 4. K24 and K25 over the counted run's launches: events, the card's
    # time, plain, work
    t_plain = time.perf_counter()
    res = {}
    k24 = rec["profile_forward_ckpt"]
    k25 = rec["profile_block_ptrs_batch"]
    require(len(k24) == launches["profile_forward_ckpt"]
            and len(k25) == launches["profile_block_ptrs"],
            f"recorded {len(k24)} K24 and {len(k25)} K25 calls, the counted "
            f"run launched {launches['profile_forward_ckpt']} and "
            f"{launches['profile_block_ptrs']}")
    geo24 = [profile.span_geometry(c["p"].shape[0], c["p"].shape[1],
                                   c["q"].shape[1], False) for c in k24]
    geo25 = [profile.span_geometry(c["G"] * c["p"].shape[0],
                                   c["p"].shape[1] // c["ck_h"].shape[0],
                                   c["q"].shape[1], True) for c in k25]
    log("# K24 geometries: " + "; ".join(
        f"K = {d['K']}, {d['warps']} strips a block, {d['blocks']} blocks, "
        f"{d['blocks_per_sm']} an SM" for d in geo24) + "; K25: " +
        "; ".join(f"G = {c['G']}: K = {d['K']}, {d['warps']} strips a "
                  f"block, {d['blocks']} blocks a block row, "
                  f"{d['blocks_per_sm']} an SM, {d['waves']} waves"
                  for c, d in zip(k25, geo25)))
    got24 = [profile.profile_forward_ckpt(**c) for c in k24]
    ref24, p24 = timed_once(lambda: [profile.profile_forward_ckpt_plain(
        c["p"], c["q"], c["p_len"], c["q_len"], c["gap_open"],
        c["gap_extend"], c["K"]) for c in k24], torch)
    for c, g, r in zip(k24, got24, ref24):
        for x, y in zip(g, r):
            require(torch.equal(x, y), f"K24 differs from its plain version "
                    f"on the counted launch {tuple(c['p'].shape)}")
            errs["profile_forward_ckpt"].append((x, y))
    del ref24, got24
    run24 = lambda: [profile.profile_forward_ckpt(**c) for c in k24]
    ms24 = timed_ms(run24, 3, torch)
    card24 = device_ms(run24, 3, torch)
    res["profile_forward_ckpt"] = entry(
        max_abs_err(errs["profile_forward_ckpt"]), ms24, p24,
        sum_work(ckpt_work(
            (c["p"], c["q"], c["p_len"], c["q_len"]), c["K"]) for c in k24))
    # K25's plain version on the first and the last counted launches (the
    # XMFA equality above covers the walk's every block); its entry's
    # times and work are of those launches
    held = k25[:1] + k25[1:][-1:]
    p25 = 0.0
    for c in held:
        plain_args = (c["ck_h"], c["ck_f"], c["p"], c["q"], c["q_len"],
                      c["first"], c["G"], c["gap_open"], c["gap_extend"])
        ref25, ms = timed_once(
            lambda a=plain_args: profile.profile_block_ptrs_batch_plain(*a),
            torch)
        p25 += ms
        g = profile.profile_block_ptrs_batch(**c)
        require(torch.equal(g, ref25), f"K25 differs from its plain version "
                f"on the counted launch of blocks {c['first']}.."
                f"{c['first'] + c['G'] - 1}")
        errs["profile_block_ptrs"].append((g, ref25))
        del ref25, g
    ms25 = timed_ms(lambda: [profile.profile_block_ptrs_batch(**c)
                             for c in held], 3, torch)
    run25 = lambda: [profile.profile_block_ptrs_batch(**c) for c in k25]
    all25 = timed_ms(run25, 3, torch)
    card25 = device_ms(run25, 3, torch)
    res["profile_block_ptrs"] = entry(
        max_abs_err(errs["profile_block_ptrs"]), ms25, p25,
        sum_work(block_work(c) for c in held))
    floor25 = sum_work(block_work(c) for c in k25)["latency_ms"]
    e = res["profile_forward_ckpt"]
    log(f"# profile_forward_ckpt: {len(k24)} launch(es), {ms24:.3f} ms by "
        f"events, {card24:.3f} ms on the card, plain {p24:.3f} ms, latency "
        f"floor {e['work']['latency_ms']:.4f} ms, max_abs_err {e['err']}")
    e = res["profile_block_ptrs"]
    log(f"# profile_block_ptrs: launches of blocks "
        + ", ".join(f"{c['first']}..{c['first'] + c['G'] - 1}"
                    for c in held)
        + f" {ms25:.3f} ms by events, plain {p25:.3f} ms, latency floor "
        f"{e['work']['latency_ms']:.4f} ms; all {len(k25)} launches Σ "
        f"{all25:.3f} ms by events, {card25:.3f} ms on the card, latency "
        f"floor {floor25:.4f} ms; max_abs_err {e['err']}")
    log(f"# K24/K25 plain versions on the counted launches: "
        f"{time.perf_counter() - t_plain:.1f} s")
    if sweep:
        span_sweep(torch, k24[0], k25[0])
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
    fargs = (content, src, lay.keys[dev], lay.seg_off[dev], 0, 1000,
             sentinel_content(seed))
    flags = mums.mum_seed_flags(*fargs)
    ref_f = mums.mum_seed_flags_plain(*fargs)
    require(flags.n_rows == ref_f.n_rows
            and all(torch.equal(g, r) for g, r in zip(flags, ref_f)
                    if hasattr(r, "shape")),
            "K13 differs from its plain version on shard 0's routed table")
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
                   "cluster_reps": pairwise.rep_index,
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


def k31_work(c, before, after_len):
    """K31's least work on one call: c its arguments (bound by name),
    before (lefts[rows], lengths[rows]) ahead of the round, after_len
    lengths[rows] after it.  Each answered span is read up to the round's
    break: offsets 1 .. min(reach + seed_len, hi), hi <= C the row's last
    offset whose probe positions all lie in their genomes; a row with a
    dropped request (where -1) reads nothing.  Bytes: those keys once (8
    each) and the rows' state: rows 8, where 8 G, lefts 4 G, present and
    is_fwd 2 G, lengths read and written 8, active written 1, a moved
    genome's left end written 4, gen_cnt 4 G once.  Operations: 4 a
    present genome a probed offset."""
    import torch
    rows, where = c["rows"], c["where"]
    side, C, s = c["side"], c["C"], c["seed_len"]
    Rb, G = where.shape
    l0, n0 = before[0].long(), before[1].long()
    reach = after_len.long() - n0
    pres, fwd = c["present"][rows], c["is_fwd"][rows]
    back = fwd if side == 0 else ~fwd
    q0 = torch.where(back, l0, l0 + n0[:, None] - s)
    hi = torch.where(back, q0, c["gen_cnt"].long()[None] - 1 - q0)
    hi = torch.where(pres, hi, C).amin(dim=1).clamp(0, C)
    probes = torch.minimum(reach + s, hi)
    probes = torch.where((pres & (where < 0)).any(dim=1), 0, probes)
    keys = int((probes * pres.sum(dim=1)).sum())
    moved = int((pres & back & (reach > 0)[:, None]).sum())
    return work(8 * keys + Rb * (8 + 8 * G + 4 * G + 2 * G + 8 + 1)
                + 4 * moved + 4 * G, 4 * keys)


def k31_span_work(Rb, G, C, n_ans):
    """K31's work counted as every answered span read whole (the older
    count, logged beside k31_work's least probe): C keys a span, and the
    rows' state."""
    return work(Rb * 8 + Rb * G * 8 + Rb * G * 6 + Rb * 4 + G * 4
                + n_ans * C * 8 + Rb * G * 4 + Rb * 5, 10 * Rb * G * C)


def k31_early_rows(torch, dev, Rb, G, C, seed_len, fill):
    """K31 on Rb rows of G genomes whose chains end within their first
    ballot word: every genome moves left (side 0, forward strand), the
    answered spans agree at offsets 1 .. d - 1 with d in [1, 32 -
    seed_len] a row and differ past them, so a round reads 32 keys a
    genome of C.  Held equal to the plain version; timed by events and
    on the card.  Returns (events ms, card ms, least-probe work, whole
    spans' work)."""
    from libmems_tpu_torch.ops import tiled
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    n = Rb * G
    resp = torch.randint(0, 1 << 40, (n, C), generator=gen, device=dev)
    resp = torch.where((resp | 1) == fill, resp ^ 4, resp)
    d = torch.randint(1, 33 - seed_len, (Rb,), generator=gen, device=dev)
    # offset e of a leftward genome is span[C - e]: copy the reference's
    # keys of offsets below d into every genome's span
    col = torch.arange(C, device=dev)
    same = (C - col)[None, :] < d[:, None]
    ref = resp.view(Rb, G, C)[:, :1]
    resp = torch.where(same[:, None, :], ref, resp.view(Rb, G, C)).view(n, C)
    where = torch.arange(n, device=dev).view(Rb, G)
    rows = torch.arange(Rb, device=dev)
    present = torch.ones((Rb, G), dtype=torch.bool, device=dev)
    is_fwd = torch.ones((Rb, G), dtype=torch.bool, device=dev)
    gen_cnt = torch.full((G,), 1 << 28, dtype=torch.int32, device=dev)

    def state():
        return (torch.full((Rb, G), 2 * C, dtype=torch.int32, device=dev),
                torch.full((Rb,), seed_len, dtype=torch.int32, device=dev),
                torch.ones(Rb, dtype=torch.bool, device=dev))

    one_owner = torch.zeros(1, dtype=torch.int64, device=dev)

    def args(st):
        return (resp, where, rows, st[0], st[1], present, is_fwd, gen_cnt,
                st[2], 0, C, seed_len, fill, one_owner)
    st_k, st_p = state(), state()
    tiled.tiled_probe(*args(st_k))
    tiled.tiled_probe_plain(*args(st_p))
    for a, b in zip(st_k, st_p):
        require(torch.equal(a, b), "K31 differs from its plain version on "
                "rows that end within their first word")
    require(torch.equal(st_p[1] - seed_len, d - 1) and not st_p[2].any(),
            "K31's early rows did not end where planted")
    fresh = [state() for _ in range(6)]
    ms = timed_ms(lambda: tiled.tiled_probe(*args(fresh.pop())), 5, torch)
    fresh = [state() for _ in range(6)]
    card = device_ms(lambda: tiled.tiled_probe(*args(fresh.pop())), 5,
                     torch)
    names = list(inspect.signature(tiled.tiled_probe_plain).parameters)
    st = state()
    w = k31_work(dict(zip(names, args(st))), (st[0], st[1]), st_p[1])
    return ms, card, w, k31_span_work(Rb, G, C, n)


def k29_work(Rb, G, n_dev, n_sent):
    """K29's bytes on a block of Rb rows x G genomes: the rows (8 a row),
    present and is_fwd (2 a request), lefts (4), lengths (4 a row),
    gen_off (4 G), the n_sent starts sent (8 each), where (8 a request)
    and the tally (8 (2 n_dev + 1)); 16 operations a request."""
    return work(Rb * 8 + Rb * G * 6 + Rb * 4 + G * 4 + n_sent * 8
                + Rb * G * 8 + 8 * (2 * n_dev + 1), 16 * Rb * G)


def first_fetch(torch, psh, smls, dev):
    """The tiled pair path's first fetch of side 0 (MESH_SHARDS shards on
    one card), through names older trees share: (the mesh, its tiles,
    each shard's candidate rows, K29's arguments on each shard's first
    block of active rows (the block first), the block's size in rows)."""
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
    args = [(torch.nonzero(r.present.any(dim=1)).flatten()[:block],
             r.lefts, r.lengths, r.present, r.is_fwd, tiles.gen_off[dev], 0,
             C, seed_len, tiles.big, tiles.S, n_dev, req_cap) for r in rows]
    return mesh, tiles, rows, args, block


def k29_first_fetch(torch, tiled, args):
    """K29 at the tiled pair's first fetch on one shard's block, through
    names older trees share: events with the counts' read to the host
    (the tally's one read; an older launcher reads its counts itself,
    twice), the card alone (device_ms), its kernels' card time and count
    in a profiled call (k29_kernel_ms), the wall of a call among 50
    back to back, and the host functions that take a call's time
    (host_profile).  Returns a dict of them."""
    def fetch():
        q = tiled.tiled_requests(*args)
        return q.tally.tolist() if hasattr(q, "tally") else q.counts

    def call():
        tiled.tiled_requests(*args)
    events = timed_ms(fetch, 9, torch)
    card = device_ms(call, 5, torch)
    kernels_ms, n, trace = k29_kernel_ms(torch, fetch, "k29_fetch_trace")
    n_calls = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        call()
    torch.cuda.synchronize()
    return {"events_ms": events, "card_ms": card,
            "kernels_card_ms": kernels_ms, "kernels": n, "trace": trace,
            "call_wall_ms": (time.perf_counter() - t0) * 1e3 / n_calls,
            "call_host_split_ms": host_profile(call, 200)}


def tiled_kernels_vs_plain(torch, dev, smls):
    """K29, K30 and K31 against their plain versions on the card at the
    pair path's shapes (4 shards on one card): the first fetch of side 0
    (every shard's first block of active rows), K29 on each shard's
    block, K30 on shard 0's received starts, K31 on shard 0's answered
    spans.  Exact; each timed, kernel and plain, with CUDA events (K29
    by k29_first_fetch).  Returns ({name: entry}, the shapes)."""
    from libmems_tpu_torch.ops import tiled
    from libmems_tpu_torch.parallel import shard as psh
    mesh, tiles, rows, args, block = first_fetch(torch, psh, smls, dev)
    n_dev, G = mesh.size, len(smls)
    seed_len, C, req_cap = args[0][8], args[0][7], args[0][12]
    blk = [a[0] for a in args]
    res = {}

    # K29 on every shard's block; timed on shard 0's
    reqs, counts = [], []
    for i, a in enumerate(args):
        got, ref = tiled.tiled_requests(*a), tiled.tiled_requests_plain(*a)
        sent, dropped = tiled.tally_counts(got.tally.tolist(), n_dev)
        require(torch.equal(got.tally, ref.tally)
                and torch.equal(got.where, ref.where)
                and got.send.shape == ref.send.shape
                and all(torch.equal(got.send[o, :c], ref.send[o, :c])
                        for o, c in enumerate(sent))
                and dropped == 0,
                f"K29 differs from its plain version on shard {i}")
        reqs.append(got)
        counts.append(sent)
    one = k29_first_fetch(torch, tiled, args[0])
    plain_ms = timed_ms(lambda: tiled.tiled_requests_plain(*args[0]), 3,
                        torch)
    Rb, n_sent = blk[0].shape[0], sum(counts[0])
    w29 = k29_work(Rb, G, n_dev, n_sent)
    res["tiled_requests"] = entry(0.0, one["events_ms"], plain_ms, w29)
    res["tiled_requests"]["card_ms"] = one["card_ms"]
    log(f"# K29 first fetch ({Rb} rows x {G} genomes, {n_sent} requests): "
        f"{one['events_ms']:.4f} ms events with the tally's read, "
        f"{one['card_ms']:.4f} ms card ({one['kernels_card_ms']:.4f} ms in "
        f"{one['kernels']} kernel by the profiler), plain {plain_ms:.4f} "
        f"ms; bound {bound(w29)[0]:.6f} ms; a call among 50 back to back "
        f"{one['call_wall_ms']:.4f} ms of wall, its host by function "
        f"{json.dumps(one['call_host_split_ms'])}")

    # the exchange; K30 on shard 0's received starts
    recv = psh._exchange([[q.send[o, :c] for o, c in enumerate(t)]
                          for q, t in zip(reqs, counts)], mesh)
    offs = torch.cat(recv[0])
    targs = (tiles.tiles[0], tiles.S, offs, C, tiles.sentinel)
    got, ref = tiled.tiled_serve(*targs), tiled.tiled_serve_plain(*targs)
    require(torch.equal(got, ref), "K30 differs from its plain version")
    del ref
    ms = timed_ms(lambda: tiled.tiled_serve(*targs), 5, torch)
    card = device_ms(lambda: tiled.tiled_serve(*targs), 5, torch)
    plain_ms = timed_ms(lambda: tiled.tiled_serve_plain(*targs), 3, torch)
    n_recv = offs.shape[0]
    w30 = work(n_recv * 8 + 8 * span_union(offs.cpu().numpy(), tiles.S, C)
               + n_recv * C * 8, 2 * n_recv * C)
    res["tiled_serve"] = entry(0.0, ms, plain_ms, w30)
    res["tiled_serve"]["card_ms"] = card
    log(f"# K30 first fetch ({n_recv} spans of {C} keys, "
        f"{n_recv * C * 8} bytes out): {ms:.4f} ms events, {card:.4f} ms "
        f"card, plain {plain_ms:.4f} ms; bound {bound(w30)[0]:.6f} ms")
    # beside it the card's own write of the answer's bytes (fill_) and
    # K30 on the same starts in sorted order, where neighbouring warps
    # share tile lines
    sargs = (targs[0], targs[1], torch.sort(offs)[0], *targs[3:])
    log(f"# K30 on the first fetch's starts sorted: "
        f"{device_ms(lambda: tiled.tiled_serve(*sargs), 5, torch):.4f} ms "
        f"card; fill_ of its answer's {nbytes(got)} bytes "
        f"{device_ms(lambda: got.fill_(tiles.sentinel), 5, torch):.4f} ms "
        f"card")
    del got, sargs

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
                tiles.sentinel, reqs[0].offsets)
    st_k, st_p = state(), state()
    tiled.tiled_probe(*k31_args(st_k))
    tiled.tiled_probe_plain(*k31_args(st_p))
    for a, b in zip(st_k, st_p):
        require(torch.equal(a, b), "K31 differs from its plain version")
    fresh = [state() for _ in range(6)]
    ms = timed_ms(lambda: tiled.tiled_probe(*k31_args(fresh.pop())), 5,
                  torch)
    fresh = [state() for _ in range(6)]
    card = device_ms(lambda: tiled.tiled_probe(*k31_args(fresh.pop())), 5,
                     torch)
    fresh = [state() for _ in range(4)]
    plain_ms = timed_ms(lambda: tiled.tiled_probe_plain(
        *k31_args(fresh.pop())), 3, torch)
    n_ans = int((reqs[0].where >= 0).sum())
    names = list(inspect.signature(tiled.tiled_probe_plain).parameters)
    w31 = k31_work(dict(zip(names, k31_args(state()))),
                   (r.lefts[blk[0]], r.lengths[blk[0]]), st_p[1][blk[0]])
    span_ms = bound(k31_span_work(Rb, G, C, n_ans))[0]
    res["tiled_probe"] = entry(0.0, ms, plain_ms, w31)
    res["tiled_probe"]["card_ms"] = card
    log(f"# K31 first fetch: {ms:.4f} ms events, {card:.4f} ms card, "
        f"plain {plain_ms:.4f} ms; bound {bound(w31)[0]:.6f} ms (least "
        f"probe, {w31['bytes']} bytes), {span_ms:.6f} ms counting every "
        f"answered span whole")
    e_ms, e_card, e_w, e_span = k31_early_rows(torch, dev, Rb, 3, C,
                                               seed_len, tiles.sentinel)
    res["tiled_probe"]["early_card_ms"] = e_card
    log(f"# K31 on {Rb} rows of 3 genomes ending within their first word "
        f"(C = {C}): {e_ms:.4f} ms events, {e_card:.4f} ms card; bound "
        f"{bound(e_w)[0]:.6f} ms (least probe), {bound(e_span)[0]:.6f} ms "
        f"counting every span whole")
    shapes = (f"{n_dev} shards, tiles of S = {tiles.S} + halo {tiles.halo} "
              f"keys, C = {C}, req_cap {req_cap}, blocks of {block} rows; "
              f"shard 0: {r.lengths.shape[0]} candidate rows, a block of "
              f"{Rb} rows, {n_sent} requests, {n_recv} received, "
              f"{n_ans} answered")
    log(f"# K29-K31 equal their plain versions: {shapes}")
    return res, shapes


def tiled_sums(torch, tiled, psh, tiles, smls, mesh):
    """K29, K30 and K31 over a run of the tiled pair's path, through names
    older trees share: each launch timed alone on the card by CUDA events
    with a sleep kernel ahead of it (device_ms's way; an older K29's
    events also hold its host reads of the counts, two a shard) and its
    work: K29's k29_work, K30's as tiled_kernels_vs_plain counts it,
    K31's least probe (k31_work); and each torch.cat of a shard's
    returned answers (the argument of its K31) once more, timed alone on
    the card.  Returns ({name: (Σ ms, launches, Σ work)}, (Σ cat ms,
    cats, Σ cat bytes))."""
    names = {"tiled_probe": list(inspect.signature(
        tiled.tiled_probe_plain).parameters),
             "tiled_serve": list(inspect.signature(
                 tiled.tiled_serve_plain).parameters),
             "tiled_requests": list(inspect.signature(
                 tiled.tiled_requests_plain).parameters)}
    got = {name: ([], []) for name in names}
    n_dev = mesh.size
    cats = []
    state = {"exchanges": 0}

    def work_of(name, c, before, out):
        if name == "tiled_probe":
            return k31_work(c, before, c["lengths"][c["rows"]])
        if name == "tiled_requests":    # its counts read after the run
            return (c["rows"].shape[0], c["lefts"].shape[1], out)
        n, C = c["offs"].shape[0], c["C"]
        return work(n * 8 + 8 * span_union(c["offs"].cpu().numpy(),
                                           tiles.S, C) + n * C * 8,
                    2 * n * C)

    def timed(name, real):
        def run(*args, **kw):
            c = dict(zip(names[name], args), **kw)
            before = (c["lefts"][c["rows"]], c["lengths"][c["rows"]]) \
                if name == "tiled_probe" else None
            n = real.launches
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kw)
            end.record()
            if real.launches > n:
                got[name][0].append((start, end))
                got[name][1].append(work_of(name, c, before, out))
            return out
        return Patched(real, run)

    real_x = psh._exchange

    def exchange(parts, mesh_):
        out = real_x(parts, mesh_)
        state["exchanges"] += 1
        if state["exchanges"] % 2 == 0:   # the answers' return
            for back in out:
                torch.cuda._sleep(SLEEP_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                cat = torch.cat(back)
                end.record()
                cats.append((start, end, cat.numel() * cat.element_size()))
        return out
    reals = {name: getattr(tiled, name) for name in names}
    for name, real in reals.items():
        setattr(tiled, name, timed(name, real))
    psh._exchange = exchange
    try:
        psh.sharded_find_mums_tiled(smls, mesh)
    finally:
        for name, real in reals.items():
            setattr(tiled, name, real)
        psh._exchange = real_x
    torch.cuda.synchronize()
    w29 = []
    for Rb, G, q in got["tiled_requests"][1]:
        sent = q.counts if hasattr(q, "counts") else \
            tiled.tally_counts(q.tally.tolist(), n_dev)[0]
        w29.append(k29_work(Rb, G, n_dev, sum(sent)))
    got["tiled_requests"] = (got["tiled_requests"][0], w29)
    return ({name: (sum(a.elapsed_time(b) for a, b in ev), len(ws),
                    sum_work(ws)) for name, (ev, ws) in got.items()},
            (sum(a.elapsed_time(b) for a, b, _ in cats), len(cats),
             sum(n for _, _, n in cats)))


@contextlib.contextmanager
def fetch_stages(tiled, psh, opened, closed):
    """Patches K29's wrapper and the exchange for a run of the tiled
    path: at a fetch's first K29 call, mark = opened(); at the first
    exchange after it, closed(mark).  The request stage between them
    holds every local shard's K29 and the host reads of their counts.
    Through names older trees share."""
    state = {"mark": None}
    real29, real_x = tiled.tiled_requests, psh._exchange

    def requests(*args, **kw):
        if state["mark"] is None:
            state["mark"] = opened()
        return real29(*args, **kw)

    def exchange(parts, mesh_):
        if state["mark"] is not None:
            closed(state["mark"])
            state["mark"] = None
        return real_x(parts, mesh_)
    tiled.tiled_requests = Patched(real29, requests)
    psh._exchange = exchange
    try:
        yield
    finally:
        tiled.tiled_requests = real29
        psh._exchange = real_x


def request_stages(torch, tiled, psh, smls, mesh):
    """Each fetch's request stage over a run of the tiled pair's path,
    from an idle card (a synchronize before its first K29 call), by CUDA
    events and on the host clock: the stage's whole cost on the path,
    every shard's K29 and the reads of their counts (one a fetch, two a
    shard in an older tree).  Returns (Σ events ms, Σ host ms, stages)."""
    stages = []

    def opened():
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return start, time.perf_counter()

    def closed(mark):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        stages.append((mark[0].elapsed_time(end),
                       (time.perf_counter() - mark[1]) * 1e3))
    with fetch_stages(tiled, psh, opened, closed):
        psh.sharded_find_mums_tiled(smls, mesh)
    return (sum(e for e, _ in stages), sum(h for _, h in stages),
            len(stages))


def tiled_syncs(torch, tiled, psh, smls, mesh):
    """A run of the tiled pair's path under torch's sync debug mode: the
    synchronising operations it makes (host reads of the card's tensors
    among them), all and those of the fetches' request stages.  Returns
    (all, in request stages, fetches)."""
    import warnings
    in_stages = []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")

        def n_sync():
            return sum("synchroniz" in str(w.message) for w in seen)
        with fetch_stages(tiled, psh, n_sync,
                          lambda mark: in_stages.append(n_sync() - mark)):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                psh.sharded_find_mums_tiled(smls, mesh)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        n_all = n_sync()
    return n_all, sum(in_stages), psh.TILED_STATS["fetches"]


def tiled_timings(torch, tiled, psh, smls, mesh, tiles):
    """The tiled pair's path timed through names older trees share: its
    seeding wall (host clock, synchronised, 3 runs after a warm-up),
    K29-K31 launch by launch and the answers' torch.cat (tiled_sums),
    each fetch's request stage (request_stages), the synchronising
    operations (tiled_syncs) and K29's kernels' card time over a
    profiled run (k29_kernel_ms).  Returns a dict of them."""
    psh.sharded_find_mums_tiled(smls, mesh)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psh.sharded_find_mums_tiled(smls, mesh)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    sums, (cat_ms, n_cat, cat_bytes) = tiled_sums(torch, tiled, psh, tiles,
                                                 smls, mesh)
    stage_ms, stage_host, stages = request_stages(torch, tiled, psh, smls,
                                                  mesh)
    n_sync, stage_sync, fetches = tiled_syncs(torch, tiled, psh, smls, mesh)
    card, n, _ = k29_kernel_ms(
        torch, lambda: psh.sharded_find_mums_tiled(smls, mesh),
        "k29_path_trace")
    require(stages == fetches, f"{stages} request stages, {fetches} "
            f"fetches")
    return {"seeding_wall_s": walls,
            "sums": {name: {"card_ms": ms, "launches": k,
                            "bound_ms": bound(w)[0], "bytes": w["bytes"]}
                     for name, (ms, k, w) in sums.items()},
            "cat": {"card_ms": cat_ms, "copies": n_cat, "bytes": cat_bytes},
            "fetches": fetches, "stage_events_ms": stage_ms,
            "stage_host_ms": stage_host,
            "syncs_a_fetch_in_stages": stage_sync / fetches,
            "syncs_a_fetch": n_sync / fetches,
            "k29_kernels_card_ms": card, "k29_kernels": n}


def phase_tiled(torch, lt, dev, refs):
    """The position-tiled extension with MESH_SHARDS shards on one card.
    (1) K29-K31 against their plain versions at the pair's first fetch.
    (2) sharded_find_mums_tiled of the 2 x 4.6 Mbp pair (rng 0): its MUMs
    equal phase main's find_mums; launch counts of K26-K31 zeroed before
    and read after, probe rounds and fetches printed; then the path timed
    (tiled_timings).  (3) Each shard's resident keys (S + halo) against
    the replicated table of sharded_find_mums, and the run's device
    memory peak.  Within TILED_CAP_S.  Returns ({name: entry}, the path's
    launches, walls)."""
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
    tm = tiled_timings(torch, tiled, psh, smls, mesh, tiles)
    for name, s_ in tm["sums"].items():
        e = res[name]
        e["sum_card_ms"], e["sum_launches"] = s_["card_ms"], s_["launches"]
        e["sum_bound_ms"] = s_["bound_ms"]
        log(f"# {name} over the tiled pair's path: Σ {s_['card_ms']:.4f} ms "
            f"of card in {s_['launches']} launches (each timed alone, a "
            f"sleep kernel ahead of it), Σ bound {s_['bound_ms']:.6f} ms "
            f"({s_['bytes']} bytes)")
        require(s_["launches"] == launches[name], f"{name} launched "
                f"{s_['launches']} times in the timed run, {launches[name]} "
                f"in the counted one")
    e = res["tiled_requests"]
    e["sum_stage_ms"] = tm["stage_events_ms"]
    e["syncs_a_fetch"] = tm["syncs_a_fetch_in_stages"]
    log(f"# tiled pair's request stages from an idle card (every shard's "
        f"K29 and the counts' reads): Σ {tm['stage_events_ms']:.4f} ms by "
        f"events, {tm['stage_host_ms']:.4f} ms on the host clock over "
        f"{tm['fetches']} fetches; K29's kernels Σ "
        f"{tm['k29_kernels_card_ms']:.4f} ms of card by the profiler; "
        f"synchronising operations {tm['syncs_a_fetch_in_stages']:.3f} a "
        f"fetch in the request stages, {tm['syncs_a_fetch']:.3f} a fetch in "
        f"the run; torch.cat of the returned answers Σ "
        f"{tm['cat']['card_ms']:.4f} ms of card in {tm['cat']['copies']} "
        f"copies, {tm['cat']['bytes']} bytes; seeding walls "
        f"{[round(x, 4) for x in tm['seeding_wall_s']]} s")
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


def k29_kernel_ms(torch, fn, name):
    """Card ms and count of K29's kernels (names with tiled_request or
    tiled_count) in one traced run of fn, and every kernel's, memcpy's
    and memset's {name: [events, ms]} of that run (its trace kept as
    OUT_DIR/name.json)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(OUT_DIR, name + ".json")
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(path)
    kernels = trace_kernels(path)
    mine = [v for k, v in kernels.items()
            if "tiled_request" in k or "tiled_count" in k]
    return (sum(ms for _, ms in mine), sum(n for n, _ in mine),
            {k: [n, round(ms, 4)] for k, (n, ms) in kernels.items()})


def host_profile(fn, reps, top=12):
    """{function: ms a call of fn} of the functions that take the most
    host time of its own (cProfile's tottime) over reps calls."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {f"{os.path.basename(f)}:{line}:{name}": round(v[2] * 1e3 / reps,
                                                          5)
            for (f, line, name), v in rows}


def phase_requests(torch, lt, dev):
    """(named runs only) Phase tiled's timings without its checks: K29 at
    the first fetch on shard 0's block (k29_first_fetch) and the tiled
    pair's path (tiled_timings), through names older trees share, so
    that copied into an older tree's archive it times that tree the same
    way."""
    from libmems_tpu_torch.ops import tiled
    from libmems_tpu_torch.parallel import shard as psh
    smls, _ = lt.create_smls(genome_pair(lt, 0), device=dev)
    mesh, tiles, rows, args, _ = first_fetch(torch, psh, smls, dev)
    one = k29_first_fetch(torch, tiled, args[0])
    del rows, args
    log(json.dumps({"requests": {
        "first_fetch": one,
        "path": tiled_timings(torch, tiled, psh, smls, mesh, tiles)}}))


def phase_viterbi(torch, dev):
    """(named runs only) Phase decode's K20 timings without its checks
    (viterbi_timings) on the predict_homologous calls it ran
    viterbi_homologous on (DECODE_CALLS), through names older trees
    share, so that copied with DECODE_CALLS into an older tree's archive
    it times that tree the same way."""
    from libmems_tpu_torch.ops import hmm
    by_call = [(seqs, params) for seqs, params, _ in
               load_hmm_calls(DECODE_CALLS)["decode"]]
    _, chosen = decode_batches(torch, hmm, by_call, dev)
    log(json.dumps({"viterbi": viterbi_timings(torch, hmm, by_call, chosen,
                                               dev)}))


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
    # K24 and batched K25 on cuda:1 with card 0 current equal cuda:0's
    arrays = fractional_profiles(np.random.default_rng(17), 2, CKPT_CHECK_N,
                                 CKPT_CHECK_MP, CKPT_CHECK_MP, 3, 2)
    spans = []
    with torch.cuda.device(0):
        for d in (torch.device("cuda", 0), torch.device("cuda", 1)):
            t = tuple(torch.from_numpy(x).to(d) for x in arrays)
            sc, ck_h, ck_f = profile.profile_forward_ckpt(*t)
            ptr = profile.profile_block_ptrs_batch(ck_h, ck_f, t[0], t[1],
                                                   t[3], 0, ck_h.shape[0])
            spans.append([x.cpu() for x in (sc, ck_h, ck_f, ptr)])
            require(torch.cuda.current_device() == 0, "a K24/K25 launch on "
                    f"{d} left another card current")
    require(all(torch.equal(a, b) for a, b in zip(*spans)),
            "K24/K25 on cuda:1 differ from cuda:0")
    log("# cards: K24 and K25 on cuda:1 with card 0 current equal cuda:0")
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
    bad = [a for a in argv if a not in PHASES + LIGHT_PHASES]
    if bad:
        raise SystemExit(f"unknown phase {bad}; phases: "
                         f"{' '.join(PHASES + LIGHT_PHASES)}")
    want = set(argv or PHASES)
    if want & {"profile_dp", "decode", "hmm"}:
        want.add("progressive")
    if "hmm" in want:
        want.add("large")
    if want & {"mesh", "cards"}:
        want |= {"main", "trio", "progressive"}
    if want & {"tiled", "multihost"}:
        want.add("main")
    return [p for p in PHASES + LIGHT_PHASES if p in want]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        return rank_main(argv[1:])
    import torch
    import libmems_tpu_torch as lt

    sweep = "--sweep" in argv
    phases = select_phases([a for a in argv if a != "--sweep"])
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
    if {"seeder", "seedocc"} & set(phases):
        large = family_large(lt)
    if "kernels" in phases:
        res = phase_kernels(torch, lt, dev)
        mum_res, err = phase_mum_kernels(torch, lt, dev)
        res.update(mum_res)
        k2_errs.append(err)
        sort_rows(torch, lt, dev)
        lap("kernels")
    if "seeder" in phases:
        res.update(phase_pairwise_kernels(torch, lt, dev, large))
        lap("seeder")
    if "seedocc" in phases:
        occ_res, err = phase_seedocc_kernels(torch, lt, dev, large)
        res.update(occ_res)
        k2_errs.append(err)
        lap("seedocc")
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
        paths["large"], ldt, calls["large_hmm"], calls["large_align"] = \
            phase_large(torch, lt, dev, large or family_large(lt))
        walls.append(f"3 x {LARGE_LEN} bp path {ldt:.3f} s")
        lap("large")
    if "profile_dp" in phases:
        for name, e in phase_profile_dp(torch, dev, calls,
                                        paths["progressive"]).items():
            if name in res:
                e["err"] = max(e["err"], res[name]["err"])
            res[name] = e
        if calls.get("large_align"):
            large_walks(torch, dev, calls["large_align"], paths["large"],
                        res)
        res["fb_posterior"] = phase_hmm(
            torch, dev, calls["predict_homologous"], paths["progressive"],
            calls.get("large_hmm"), paths.get("large"))
        lap("profile DP and hmm")
    elif "hmm" in phases:
        res["fb_posterior"] = phase_hmm(
            torch, dev, calls["predict_homologous"], paths["progressive"],
            calls["large_hmm"], paths["large"], save=True)
        lap("hmm")
    if "hmmstage" in phases:
        phase_hmmstage(torch, dev)
        lap("hmmstage")
    if "decode" in phases:
        dec_res, paths["decode"], err = phase_decode(
            torch, lt, dev, calls["predict_homologous"], sweep)
        res.update(dec_res)
        k2_errs.append(err)
        lap("decode")
    if "bounded" in phases:
        b_res, paths["bounded"], b_walls = phase_bounded(torch, lt, dev,
                                                         sweep)
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
    if "fullwidth" in phases:
        phase_fullwidth(torch, lt, dev, calls)
        lap("fullwidth")
    if "wide" in phases:
        phase_wide(torch, dev)
        lap("wide")
    if "runflags" in phases:
        phase_runflags(torch, lt, dev)
        lap("runflags")
    if "seedwords" in phases:
        phase_seedwords(torch, lt, dev)
        lap("seedwords")
    if "reps" in phases:
        phase_reps(torch, lt, dev)
        lap("reps")
    if "extend" in phases:
        phase_extend(torch, lt, dev)
        lap("extend")
    if "requests" in phases:
        phase_requests(torch, lt, dev)
        lap("requests")
    if "viterbi" in phases:
        phase_viterbi(torch, dev)
        lap("viterbi")
    if "extend_matches" in res:
        res["extend_matches"]["err"] = max([res["extend_matches"]["err"]]
                                           + k2_errs)
    # launches: the 9 x 1 Mbp progressive path's, K13-K15 the trio's,
    # K18/K19 the pair's, K16/K17 the 3 x 8.7 Mbp path's, K20-K23 the
    # decode run's, K24/K25 the bounded path's, K26-K28 the meshed pair's,
    # K29-K31 the tiled pair's
    launches = dict(paths.get("progressive", {}))
    # K8's launches: its chunked route's (fb_posterior) and its sequential
    # route's (fb_ragged)
    if "fb_ragged" in launches:
        launches["fb_posterior"] += launches.pop("fb_ragged")
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
        if "latency_ms" in e["work"]:   # a chain's second bound
            kernels[-1]["latency_bound_ms"] = e["work"]["latency_ms"]
        if "card_ms" in e:   # the card's time apart from the host launch
            kernels[-1]["card_ms"] = e["card_ms"]
        for key in ("sum_card_ms", "sum_launches", "sum_bound_ms",
                    "sum_stage_ms", "syncs_a_fetch"):
            if key in e:     # every launch of the path (K31)
                kernels[-1][key] = e[key]
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
