#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (libmems_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (compute capability 9.0) and the CUDA
toolkit's nvcc; builds the port's kernels from libmems_tpu_torch/csrc at
first use.  Phases, each raising on failure (the script then exits
non-zero and prints no result line):

1. device  - CUDA present, capability (9, 0); card name and power limit;
2. build   - compile the kernel library, report its build seconds;
3. kernels - each hand kernel against its plain PyTorch version on the
             card at the slice's shapes (exact equality), with timings;
4. goldens - the port on the GPU reproduces tests/golden/pair.mums and
             tests/golden/pair.xmfa byte for byte;
5. main    - align() of a 2 x 4.6 Mbp pair with gapped alignment on the
             GPU: every kernel launched, MUMs equal to the numpy twin,
             intervals partition both genomes; then a second pair.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Logs go to chiprun_out/chip_smoke/.
Imports neither JAX nor libmems_tpu.
"""

from __future__ import annotations

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
SOURCES = {
    "canonical_seed_keys": ("libmems_tpu_torch/csrc/mers.cu",
                            "libmems_tpu/ops/mers.py:75"),
    "extend_matches": ("libmems_tpu_torch/csrc/extend.cu",
                       "libmems_tpu/ops/extend.py:91"),
    "profile_forward": ("libmems_tpu_torch/csrc/profile.cu",
                        "libmems_tpu/ops/profile.py:215"),
    "traceback_walk": ("libmems_tpu_torch/csrc/gapped.cu",
                       "libmems_tpu/ops/gapped.py:213"),
}


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


def phase_kernels(torch, lt, dev):
    """Each kernel against its plain version on the card; exact
    equality.  Returns {name: (max_abs_err, ms, plain_ms)}."""
    from libmems_tpu_torch import aligner, gapalign, matchfind, seeds
    from libmems_tpu_torch.lcb import eliminate_overlaps
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
    res["canonical_seed_keys"] = (
        max_abs_err([(k, ref), (k0, ref0)]),
        timed_ms(lambda: mers.canonical_seed_keys(codes, seed, ambt), 20,
                 torch),
        timed_ms(lambda: mers.canonical_seed_keys_plain(codes, seed, ambt),
                 5, torch, warmup=False))
    log(f"# K1 seed keys: n={k.numel()} equal")

    # K2: the candidates of the 4.6 Mbp pair's pipeline
    smls, seed = create_smls(genomes, device=dev)
    seed_len = smls[0].seed_length
    chunk = max(seed_len, 256)
    total = sum(s.n_windows for s in smls)
    EC = min(1 << 14, 1 << max((total - 1).bit_length() - 1, 1))
    pb = matchfind._pair_pos_bits(max(s.n_windows for s in smls))
    lefts, present, is_fwd, lengths0, _, n_reps = \
        matchfind.pair_candidates(seed_len, pb, EC, smls[0].keys,
                                  smls[1].keys, seed)
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
    res["extend_matches"] = (
        max_abs_err([(kl, rl), (kn, rn)]),
        timed_ms(lambda: extend.extend_matches(*args), 10, torch),
        timed_ms(lambda: extend.extend_matches_plain(*args), 3, torch,
                 warmup=False))
    log(f"# K2 extension: rows={EC} live={int(n_reps)} "
        f"max_len={int(kn.max())} equal")

    # K3/K4: the pair's inter-anchor window batch, launch by launch
    mums = lt.find_mums(smls)
    mums = eliminate_overlaps(mums).multiplicity_filter(2)
    min_w = 3 * seeds.seed_weight(seed) * 2
    mums, members = aligner._extend_lcb_anchors(mums, genomes, seed,
                                                float(min_w), device=dev)
    windows = [w for idx in members for w in
               gapalign.gapped_interval_from_matches(
                   mums, idx, genomes, None)[1]]
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
    res["profile_forward"] = (
        max_abs_err(errs3),
        timed_ms(lambda: run3(packed, profile.profile_forward), 5, torch),
        timed_ms(lambda: run3(packed, profile.profile_forward_plain), 1,
                 torch, warmup=False))
    res["traceback_walk"] = (
        max_abs_err(errs4),
        timed_ms(lambda: run4(packed, ptrs, gapped.traceback_walk), 5,
                 torch),
        timed_ms(lambda: run4(packed, ptrs, gapped.traceback_walk_plain),
                 1, torch, warmup=False))
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
    for name, (err, ms, pms) in res.items():
        log(f"# {name}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
            f"max_abs_err {err}")
    return res


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
    from libmems_tpu_torch.ops import extend, gapped, mers, profile
    from libmems_tpu_torch.sml import default_seed
    wrappers = {"canonical_seed_keys": mers.canonical_seed_keys,
                "extend_matches": extend.extend_matches,
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
        return dt, genomes, ivs, mums, len(buf.getvalue())

    trace.set_enabled(True, stream=sys.stdout)
    for w in wrappers.values():
        w.launches = 0
    dt1, genomes, ivs, mums, nbytes = run(0)
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
    return launches, dt1, dt2


def main() -> int:
    import torch
    import libmems_tpu_torch as lt

    card = phase_device(torch)
    dev = torch.device("cuda", 0)
    phase_build()
    res = phase_kernels(torch, lt, dev)
    phase_goldens(lt, dev)
    launches, dt1, dt2 = phase_main(torch, lt, dev)
    forbidden = [m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "libmems_tpu."))
                 or m == "libmems_tpu"]
    require(not forbidden, f"imported {forbidden[:5]}")
    kernels = []
    for name, (err, ms, pms) in res.items():
        src, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms})
    log(f"# card: {card}; main path {dt1:.3f} s then {dt2:.3f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
