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
             card at its path's shapes (K1-K4 the pair's, K5-K7 the 9 x
             1 Mbp seeder's; exact equality), with timings;
4. goldens - the port on the GPU reproduces tests/golden/pair.mums,
             pair.xmfa and nine.{xmfa,bbseq,bbcols} byte for byte;
5. main    - align() of a 2 x 4.6 Mbp pair with gapped alignment on the
             GPU: every kernel of the pair path launched, MUMs equal to
             the numpy twin, intervals partition both genomes; then a
             second pair;
6. progressive - progressive_align(refine=False) + apply_backbone + the
             three writers on two 9 x 1 Mbp families: every kernel K1-K8
             launched, the pairwise MUMs equal the same call on CPU
             tensors, intervals partition every genome, backbone
             segments lie inside their intervals, stage seconds printed;
7. node DP - K3 and K4 against their plain versions on the node-merge
             windows of the first progressive run (fractional multi-row
             profiles; exact equality);
8. hmm     - K8 against its plain version on the card on the HMM batches
             of the first progressive run, at their full lengths.

The inputs of phases 7 and 8 are recorded one layer above the kernel
wrappers (align_profile_batch, predict_homologous) and rebuilt into
launches by the path's own planners.  Counts of kernel launches are set
to 0 just before each main path and read just after; the kernel table
reports the progressive path's counts, and K3, K4 and K8's times are
taken on that path's inputs.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Logs go to chiprun_out/chip_smoke/.
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


def family_nine(lt, rng_seed):
    """bench_e2e.py's 9 x 1 Mbp progressive family (1% substitutions,
    indels, two rearrangements per genome)."""
    from bench_e2e import _mutant_family
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    fam = _mutant_family(PROG_GENOMES, PROG_LEN, rng_seed=rng_seed)
    return [lt.Genome(name=f"g{i}", ascii=lut[g], codes=g)
            for i, g in enumerate(fam)]


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


def phase_pairwise_kernels(torch, lt, dev):
    """K5-K7 against their plain versions on the card, on the seed table
    of the 9 x 1 Mbp family (rng 0); exact equality.  Returns {name:
    (max_abs_err, ms, plain_ms)}."""
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
    res["run_flags"] = (
        max_abs_err(list(zip(got, ref))),
        timed_ms(lambda: pairwise.run_flags(*args), 10, torch),
        timed_ms(lambda: pairwise.run_flags_plain(*args), 3, torch,
                 warmup=False))
    kept = int(got.unique_occ.sum())
    log(f"# K5 run flags: rows={keys.numel()} kept={kept} equal")

    pb = _pair_pos_bits(max(cnts))
    got_w = pairwise.cluster_words(got, G, pb)
    ref_w = pairwise.cluster_words_plain(ref, G, pb)
    require(torch.equal(got_w, ref_w), "K6 differs from its plain version")
    res["cluster_words"] = (
        max_abs_err([(got_w, ref_w)]),
        timed_ms(lambda: pairwise.cluster_words(got, G, pb), 10, torch),
        timed_ms(lambda: pairwise.cluster_words_plain(ref, G, pb), 3, torch,
                 warmup=False))
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
    res["cluster_reps"] = (
        max_abs_err(list(zip(got_r[:-1], ref_r[:-1]))),
        timed_ms(lambda: pairwise.cluster_reps(*rargs), 10, torch),
        timed_ms(lambda: pairwise.cluster_reps_plain(*rargs), 3, torch,
                 warmup=False))
    log(f"# K7 representatives: {got_r.n_reps} reps in EC={ec} equal")
    for name in ("run_flags", "cluster_words", "cluster_reps"):
        err, ms, pms = res[name]
        log(f"# {name}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
            f"max_abs_err {err}")
    return res


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
    gs = golden_nine(lt)
    ivs, _ = lt.progressive_align(gs, lt.ProgressiveConfig(refine=False,
                                                           device=dev))
    new_ivs, segs = lt.apply_backbone(ivs, device=dev)
    for name, data in write_outputs(lt, new_ivs, segs, len(gs)).items():
        with open(os.path.join(ROOT, "tests", "golden", name), "rb") as fh:
            require(data == fh.read(), f"{name} differs from the golden")
    log(f"# goldens: nine.xmfa, nine.bbseq, nine.bbcols byte-equal "
        f"({len(new_ivs.intervals)} intervals, {len(segs)} segments)")


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


def check_segments(ivs, segs):
    """Every backbone segment lies inside its interval: its columns in
    the interval's alignment, its member ranges in the interval's
    per-genome range."""
    for k, seg in enumerate(segs):
        iv = ivs.intervals[seg.interval]
        require(0 <= seg.left_col <= seg.right_col < iv.alignment_length,
                f"segment {k}: columns outside interval {seg.interval}")
        le, re = iv.left_ends(), iv.right_ends()
        for g in seg.genomes:
            lo, hi = sorted(abs(int(x)) for x in seg.seq_ranges[g])
            require(le[g] <= lo <= hi <= re[g],
                    f"segment {k}: genome {g} outside interval "
                    f"{seg.interval}")


def phase_progressive(torch, lt, dev):
    """The progressiveMauve path on two 9 x 1 Mbp families.  Returns
    (launches of the first run, the arguments of the first run's
    align_profile_batch and predict_homologous calls, walls)."""
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
                "fb_posterior": hmm.fb_posterior}
    cfg = lt.ProgressiveConfig(refine=False, device=dev)
    # the callers' names of the node-DP and HMM entry points
    targets = [(progressive, "align_profile_batch"),
               (msa, "align_profile_batch"),
               (islands, "predict_homologous")]

    def run(rng_seed, capture):
        genomes = family_nine(lt, rng_seed)
        trace.reset()
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
        for name, n in launches.items():
            require(n > 0, f"{name}: no launch on the progressive path")
        check_partition(ivs, genomes)
        check_partition(new_ivs, genomes)
        check_segments(new_ivs, segs)
        return genomes, launches, calls, t2 - t0

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
    return launches, calls, (dt1, dt2)


def phase_node_dp(torch, dev, calls, launches):
    """K3 and K4 against their plain versions on the card, on the windows
    of the first progressive run's align_profile_batch calls, rebuilt
    into the path's launches by plan_launches and pack_profiles; exact
    equality.  Returns {name: (max_abs_err, ms, plain_ms)}, the times
    summed over those launches."""
    from libmems_tpu_torch.ops import gapped, profile
    batches = []
    for a in calls:
        for M, N, sub in profile.plan_launches(a["p_rows"], a["q_rows"]):
            t = profile.pack_profiles(a["p_rows"], a["q_rows"], sub, M, N,
                                      dev)
            batches.append((M, N, t, a["gap_open"], a["gap_extend"]))
    require(len(batches) == launches["profile_forward"],
            f"{len(batches)} node-DP launches rebuilt, the path made "
            f"{launches['profile_forward']}")

    def fractional(x):
        return ((x > 0) & (x < 1)).flatten(1).any(1)

    frac = sum(int((fractional(t[0]) | fractional(t[1])).sum())
               for _, _, t, _, _ in batches)
    n_win = sum(t[0].shape[0] for _, _, t, _, _ in batches)
    log(f"# node DP: {n_win} windows ({frac} with fractional profiles) in "
        f"{len(batches)} launches, buckets "
        f"{sorted({(M, N) for M, N, _, _, _ in batches})}")

    def k3(fn):
        return [fn(*t, go, ge) for _, _, t, go, ge in batches]

    def k4(ptrs, fn):
        return [fn(pt, t[2], t[3], gapped._device_tb_T(M, N))
                for (M, N, t, _, _), (pt, _) in zip(batches, ptrs)]

    got = k3(profile.profile_forward)
    ref, p3 = timed_once(lambda: k3(profile.profile_forward_plain), torch)
    for (M, N, _, _, _), (gp, gs), (rp, rs) in zip(batches, got, ref):
        require(torch.equal(gp, rp) and torch.equal(gs, rs),
                f"K3 differs from its plain version on a node-DP launch "
                f"at ({M}, {N})")
    got4 = k4(got, gapped.traceback_walk)
    ref4, p4 = timed_once(lambda: k4(got, gapped.traceback_walk_plain),
                          torch)
    for (M, N, _, _, _), g, r in zip(batches, got4, ref4):
        require(all(torch.equal(x, y) for x, y in zip(g, r)),
                f"K4 differs from its plain version on a node-DP launch "
                f"at ({M}, {N})")
    err3 = max_abs_err([x for g, r in zip(got, ref) for x in zip(g, r)])
    err4 = max_abs_err([x for g, r in zip(got4, ref4) for x in zip(g, r)])
    ms3 = timed_ms(lambda: k3(profile.profile_forward), 5, torch)
    ms4 = timed_ms(lambda: k4(got, gapped.traceback_walk), 5, torch)
    log(f"# K3/K4 node DP: equal; K3 kernel {ms3:.3f} ms, plain {p3:.3f} "
        f"ms; K4 kernel {ms4:.3f} ms, plain {p4:.3f} ms")
    return {"profile_forward": (err3, ms3, p3),
            "traceback_walk": (err4, ms4, p4)}


def phase_hmm(torch, dev, calls, launches):
    """K8 against its plain version on the card, on the batches of the
    first progressive run's predict_homologous calls at their full
    lengths, rebuilt into the path's launches by hmm.pack_batches:
    posteriors within 1e-12, calls equal.  Returns (max_abs_err, ms,
    plain_ms), the times summed over those launches."""
    from libmems_tpu_torch.ops import hmm
    batches = []
    for a in calls:
        mats = hmm.log_matrices(a["params"] or hmm.hoxd_params(), dev)
        for _, obs, lens in hmm.pack_batches(a["sequences"]):
            batches.append((torch.from_numpy(obs).to(dev),
                            torch.from_numpy(lens).to(dev), mats,
                            a["threshold"]))
    require(len(batches) == launches["fb_posterior"],
            f"{len(batches)} HMM launches rebuilt, the path made "
            f"{launches['fb_posterior']}")
    log(f"# K8 batches (B x T): "
        f"{sorted(tuple(o.shape) for o, _, _, _ in batches)}, longest "
        f"sequence {max(int(n.max()) for _, n, _, _ in batches)} columns")

    def run(fn):
        return [fn(o, n, m, t) for o, n, m, t in batches]

    got = run(hmm.fb_posterior)
    ref, pms = timed_once(lambda: run(hmm.fb_posterior_plain), torch)
    for (o, _, _, _), (_, gc), (_, rc) in zip(batches, got, ref):
        require(torch.equal(gc, rc), f"K8 calls differ at {tuple(o.shape)}")
    err = max_abs_err([(g[0], r[0]) for g, r in zip(got, ref)])
    require(err <= 1e-12, f"K8 posteriors differ by {err}")
    ms = timed_ms(lambda: run(hmm.fb_posterior), 3, torch)
    log(f"# K8 vs plain at full length: max_abs_err {err}, calls equal; "
        f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
    return err, ms, pms


def main() -> int:
    import torch
    import libmems_tpu_torch as lt

    card = phase_device(torch)
    dev = torch.device("cuda", 0)
    phase_build()
    res = phase_kernels(torch, lt, dev)
    res.update(phase_pairwise_kernels(torch, lt, dev))
    phase_goldens(lt, dev)
    _, dt1, dt2 = phase_main(torch, lt, dev)
    launches, calls, pdt = phase_progressive(torch, lt, dev)
    for name, (err, ms, pms) in phase_node_dp(
            torch, dev, calls["align_profile_batch"], launches).items():
        res[name] = (max(err, res[name][0]), ms, pms)
    res["fb_posterior"] = phase_hmm(torch, dev, calls["predict_homologous"],
                                    launches)
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
    log(f"# card: {card}; pair path {dt1:.3f} s then {dt2:.3f} s; "
        f"progressive path {pdt[0]:.3f} s then {pdt[1]:.3f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
