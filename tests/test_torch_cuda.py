"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Marked ``cuda``: they skip where no GPU is
present.  On a GPU machine (no JAX needed):

    python -m pytest tests/test_torch_cuda.py -q
"""

import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from libmems_tpu_torch import AlignerConfig, Genome, align, write_xmfa
from libmems_tpu_torch import seeds
from libmems_tpu_torch.ops import extend, gapped, mers, profile

# loaded by path, not as tests.golden.generate: `tests` here is a
# namespace package, which any regular `tests` package installed in
# site-packages would shadow
_spec = importlib.util.spec_from_file_location(
    "golden_generate", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "golden", "generate.py"))
generate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(generate)
# the sorted seed tables of K16's CPU tests, loaded by path as well
_spec = importlib.util.spec_from_file_location(
    "seedocc_tables", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "test_torch_seedocc_tables.py"))
seedocc_tables = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(seedocc_tables)
# the sorted seed tables of K5's and K13's CPU tests, loaded by path too
_spec = importlib.util.spec_from_file_location(
    "run_tables", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "test_torch_run_tables.py"))
run_tables = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run_tables)
# K2's rows with planted match gaps, loaded by path as well
_spec = importlib.util.spec_from_file_location(
    "extend_rows", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "extend_rows.py"))
extend_rows = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(extend_rows)
# K3's and K9's test windows, loaded by path as well
_spec = importlib.util.spec_from_file_location(
    "profile_windows", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "profile_windows.py"))
windows = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(windows)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("weight", [15, 17])
def test_seed_keys_kernel_equals_plain(dev, weight):
    seed = seeds.get_seed(weight)
    rng = np.random.default_rng(weight)
    codes = torch.from_numpy(rng.integers(0, 4, 100_000).astype(np.uint8))
    ambig = torch.from_numpy(rng.random(100_000) < 0.001)
    for a in (None, ambig):
        got = mers.canonical_seed_keys(codes.to(dev), seed,
                                       None if a is None else a.to(dev))
        ref = mers.canonical_seed_keys_plain(codes, seed, a)
        assert torch.equal(got.cpu(), ref)


# K1's seeds on the card: every weight at rank 0, every rank at weights
# 15 and 21, and the solid 32 that get_seed returns above weight 31
K1_SEEDS = sorted({seeds.get_seed(w) for w in range(5, 32)}
                  | {seeds.get_seed(w, r) for w in (15, 21) for r in range(5)}
                  | {seeds.get_seed(32)})
# windows a call: one, a tile (4,096) -1/0/+1, three tiles -1/0/+1
K1_WINDOWS = (1, 4095, 4096, 4097, 3 * 4096 - 1, 3 * 4096, 3 * 4096 + 1)


@pytest.mark.parametrize("seed", K1_SEEDS, ids=lambda s: f"{s:#x}")
def test_seed_keys_kernel_tiles_equal_plain(dev, seed):
    """K1 against its plain version at every window count around its
    tile edges, with flag runs crossing the tile edges and a run over the
    last bases, with no mask, and on codes one byte into their buffer
    (no 16-byte load there)."""
    length = seeds.seed_length(seed)
    rng = np.random.default_rng(seed % 10_007)
    for n in K1_WINDOWS:
        L = n + length - 1
        codes = torch.from_numpy(rng.integers(0, 4, L + 1).astype(np.uint8))
        amb = np.zeros(L + 1, bool)
        for edge in range(4096, L + 1, 4096):
            amb[max(edge - length // 2 - 1, 0):edge + 2] = True
        amb[rng.integers(0, L + 1, 3)] = True
        amb[L - 1:] = True
        ambig = torch.from_numpy(amb)
        for c, a in ((codes[:L], ambig[:L]), (codes[:L], None),
                     (codes[1:], ambig[1:])):
            got = mers.canonical_seed_keys(c.to(dev), seed,
                                           None if a is None else a.to(dev))
            ref = mers.canonical_seed_keys_plain(c, seed, a)
            assert got.numel() == n
            assert torch.equal(got.cpu(), ref), (n, a is None)


def _trace(call, grids=False):
    """(kernel names, device-to-host copies) of one call traced by
    torch.profiler on the card, after an untraced call (with grids, each
    kernel's entry ends with its grid's blocks in x).  The call starts
    0.2 s into the session: a kernel launched right at a session's start
    was seen missing from its trace."""
    import json
    import re
    import tempfile
    import time
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("cat") in ("kernel", "gpu_memcpy")]
    kernels = [[re.search(r"(\w+)(?:<[^()]*>)?\(", e["name"]).group(1),
                e["name"]] + ([e["args"]["grid"][0]] if grids else [])
               for e in events if e["cat"] == "kernel"]
    d2h = sum(e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]
              for e in events)
    return kernels, d2h


def _traced_in_process(fn_name):
    """The result of this module's `fn_name()` run in a fresh Python
    process.  Profiler sessions taken late in a long test process were
    seen to trace the launches but none of their kernels, and a session
    disturbed the ones after it; a fresh process gives each trace the
    state its first session has."""
    import json
    import subprocess
    import sys
    here = os.path.abspath(__file__)
    code = ("import importlib.util, json\n"
            f"spec = importlib.util.spec_from_file_location('t', {here!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            f"print(json.dumps(m.{fn_name}()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=os.path.dirname(os.path.dirname(here)))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _k1_traces():
    """K1's traces with and without a mask (run by _traced_in_process)."""
    seed = seeds.get_seed(15)
    rng = np.random.default_rng(4)
    dev = torch.device("cuda", 0)
    codes = torch.from_numpy(rng.integers(0, 4, 50_000).astype(np.uint8)
                             ).to(dev)
    ambig = torch.from_numpy(rng.random(50_000) < 0.01).to(dev)
    return [_trace(lambda: mers.canonical_seed_keys(codes, seed, a))
            for a in (ambig, None)]


def test_seed_keys_trace_one_kernel(dev):
    """One call of K1's wrapper, with and without a mask, traced by
    torch.profiler: one kernel, no copy."""
    for kernels, d2h in _traced_in_process("_k1_traces"):
        assert [k for k, _ in kernels] == ["seed_keys_kernel"], kernels
        assert d2h == 0


def test_extend_kernel_equals_plain(dev):
    seed = seeds.get_seed(15)
    seed_len = seeds.seed_length(seed)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, 50_000).astype(np.uint8)
    b = a.copy()
    sub = rng.random(len(b)) < 0.003
    b[sub] = rng.integers(0, 4, int(sub.sum())).astype(np.uint8)
    b[20_000:30_000] = 3 - b[20_000:30_000][::-1]
    ka = mers.canonical_seed_keys_plain(torch.from_numpy(a), seed)
    kb = mers.canonical_seed_keys_plain(torch.from_numpy(b), seed)
    keys = torch.cat([ka, kb])
    pos = rng.integers(0, len(ka), 500)
    inv = (pos >= 20_000) & (pos < 30_000 - seed_len)
    posb = np.where(inv, 50_000 - pos - seed_len, pos)
    R = len(pos)
    lefts = torch.from_numpy(np.stack([pos, posb], 1).astype(np.int32))
    present = torch.ones((R, 2), dtype=torch.bool)
    present[-3:] = False
    is_fwd = torch.from_numpy(np.stack([np.ones(R, bool), ~inv], 1))
    off = torch.tensor([[0, len(ka)]], dtype=torch.int32).expand(R, 2)
    cnt = torch.tensor([[len(ka), len(kb)]], dtype=torch.int32).expand(R, 2)
    lengths = torch.full((R,), seed_len, dtype=torch.int32)
    args = [keys, seed_len, 256, off.contiguous(), cnt.contiguous(), lefts,
            present, is_fwd, lengths, mers.key_sentinel(seed)]
    ref = extend.extend_matches_plain(*args)
    got = extend.extend_matches(*[x.to(dev) if isinstance(x, torch.Tensor)
                                  else x for x in args])
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    assert int(ref[1].max()) > 8 * 256


def _extend_both(dev, rows, chunk, **kw):
    """K2 on the card and its plain version on the CPU on the same rows
    (numpy arrays of extend_rows): (card, plain, args)."""
    keys, off, cnt, lefts, present, is_fwd, lengths = [
        torch.from_numpy(np.ascontiguousarray(a)) for a in rows]
    args = [keys, 21, chunk, off, cnt, lefts, present, is_fwd, lengths,
            extend_rows.FILL]
    ref = extend.extend_matches_plain(*args, n_live=kw.get("n_live"))
    got = extend.extend_matches(*[x.to(dev) if isinstance(x, torch.Tensor)
                                  else x for x in args], **kw)
    return [t.cpu() for t in got], ref, args


def test_extend_warp_width_matches_library(dev):
    from libmems_tpu_torch import cuda
    assert cuda.library().lm_extend_warp_genomes() == extend.WARP_GENOMES


@pytest.mark.parametrize("G", range(1, extend.WARP_GENOMES + 2))
def test_extend_kernel_every_width_equals_plain(dev, G):
    """K2 at every width of its warp route and one above it (the wide
    route), on copies with runs of mismatches, some genomes absent."""
    rows = extend_rows.copies_rows(21, 256, G, 96, rng_seed=G)
    got, ref, _ = _extend_both(dev, rows, 256)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert int(ref[1].max()) > 8 * 256


@pytest.mark.parametrize("C,chunk,n_live,G,scratch", [
    (128, 128, None, 2, False), (256, 256, None, 2, False),
    (256, 256, 40, 2, False), (256, 256, 0, 2, False),
    (256, 128, None, 33, False), (256, 128, None, 33, True),
    (256, 256, 40, 33, True)])
def test_extend_kernel_round_edges_equal_plain(dev, C, chunk, n_live, G,
                                               scratch):
    """K2 on rows with match gaps of seed_len and seed_len + 1 at the
    JAX rounds' edges (C, C + 1, 8C, 9C), rows reaching a sequence's
    first and last window and sentinel runs; only the first n_live rows
    launched (the rest returned as given); the rows padded with absent
    genomes to G = 33 take the wide route, its state in shared memory or
    in global scratch."""
    rows = extend_rows.widen(extend_rows.gap_rows(21, C), G)
    got, ref, args = _extend_both(dev, rows, chunk, n_live=n_live,
                                  scratch=scratch)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    n = ref[1].shape[0] if n_live is None else n_live
    assert torch.equal(got[0][n:], args[5][n:])
    assert torch.equal(got[1][n:], args[8][n:])
    if n_live is None:
        assert int(ref[1].max()) > 8 * 256 or C < 256


@pytest.mark.parametrize("G", [2, extend.WARP_GENOMES + 1])
def test_extend_kernel_no_live_rows_counts_no_launch(dev, G):
    """K2 with n_live = 0 launches nothing and counts nothing: its rows
    come back as given."""
    rows = extend_rows.widen(extend_rows.gap_rows(21, 128), G)
    before = extend.extend_matches.launches
    got, ref, args = _extend_both(dev, rows, 128, n_live=0)
    assert extend.extend_matches.launches == before
    assert torch.equal(got[0], args[5]) and torch.equal(got[1], args[8])
    assert torch.equal(ref[0], args[5]) and torch.equal(ref[1], args[8])
    _extend_both(dev, rows, 128, n_live=1)
    assert extend.extend_matches.launches == before + 1


@pytest.mark.parametrize("M,N,smem", [(64, 64, True), (64, 1536, True),
                                      (64, 4608, True), (64, 4608, False)])
def test_profile_and_traceback_kernels_equal_plain(dev, monkeypatch, M, N,
                                                   smem):
    """K3 (strips up to STRIP_MAX_N columns, the wide route beyond it)
    and K4 on its pointers against their plain versions."""
    if not smem:   # the wide route's rows in global scratch
        monkeypatch.setattr(profile, "PROFILE_SMEM_LIMIT", 0)
    rng = np.random.default_rng(M + N)
    B = 4
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = rng.integers(M // 2, M + 1, B).astype(np.int32)
    ql = rng.integers(N // 2, N + 1, B).astype(np.int32)
    for r in range(B):
        p[r, np.arange(pl[r]), rng.integers(0, 4, pl[r])] = 1
        q[r, np.arange(ql[r]), rng.integers(0, 4, ql[r])] = 1
    cpu = [torch.from_numpy(x) for x in (p, q, pl, ql)]
    ref_p, ref_s = profile.profile_forward_plain(*cpu)
    got_p, got_s = profile.profile_forward(*[x.to(dev) for x in cpu])
    assert torch.equal(got_p.cpu(), ref_p)
    assert torch.equal(got_s.cpu(), ref_s)
    # the launch's geometry, rows in shared or global memory alike
    assert profile.launched_geometry(got_p.device) == \
        profile.profile_geometry(B, N, True)
    T = gapped._device_tb_T(M, N)
    ref_w = gapped.traceback_walk_plain(ref_p, cpu[2], cpu[3], T)
    got_w = gapped.traceback_walk(got_p, cpu[2].to(dev), cpu[3].to(dev), T)
    for g, r in zip(got_w, ref_w):    # codes, counts, steps
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("rows", ["mixed", (3, 2), (4, 5)])
def test_profile_kernel_equals_plain_on_fractional_profiles(dev, rows):
    """Multi-row profiles (thirds, fifths; 3 + 2 and 4 + 5 rows, or a
    mix): K3's and K9's fixed rounding order gives the plain version's
    bytes and scores exactly, in every strip geometry."""
    rng = np.random.default_rng(35)
    B, M, N = 6, 256, 256
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = rng.integers(M // 2, M + 1, B).astype(np.int32)
    ql = rng.integers(N // 2, N + 1, B).astype(np.int32)
    for r in range(B):
        k_p, k_q = (3 + r % 2, 5 - r % 3) if rows == "mixed" else rows
        for arr, n, k in ((p, pl[r], k_p), (q, ql[r], k_q)):
            rs = rng.integers(0, 4, (k, n)).astype(np.uint8)
            rs[rng.random((k, n)) < 0.15] = 4
            rs[:, (rs == 4).all(axis=0)] = 0
            arr[r, :n] = profile.rows_to_profile(rs)
    cpu = [torch.from_numpy(x) for x in (p, q, pl, ql)]
    ref_p, ref_s = profile.profile_forward_plain(*cpu)
    for g in [-1] + _fitting_geometries(B, N):
        got_p, got_s = profile.profile_forward(*[x.to(dev) for x in cpu],
                                               geometry=g)
        assert torch.equal(got_p.cpu(), ref_p)
        assert torch.equal(got_s.cpu(), ref_s)
        got_9 = profile.profile_forward_scores(*[x.to(dev) for x in cpu],
                                               geometry=g)
        assert torch.equal(got_9.cpu(), ref_s)


def _fitting_geometries(B, N):
    """The strip geometries that fit an N-column bucket on this card."""
    out, g = [], 0
    while (geo := profile.profile_geometry(B, N, True, g)) is not None:
        if geo["windows_per_sm"]:
            out.append(g)
        g += 1
    return out


def _sized_profiles(rng, M, N, shapes):
    """profile_windows.sized_profiles as CPU tensors: fractional 3- and
    2-row profiles."""
    return [torch.from_numpy(x)
            for x in windows.sized_profiles(rng, M, N, shapes)]


def _full_kernels_equal_plain(dev, cpu, g=-1):
    """K3 and K9 in geometry g (the launcher's for -1) against their
    plain versions, K4 on K3's pointers against K4 on the plain
    version's; the launch took the geometry profile_geometry reports."""
    B, M, N = cpu[0].shape[0], cpu[0].shape[1], cpu[1].shape[1]
    cuda_t = [x.to(dev) for x in cpu]
    ref_p, ref_s = profile.profile_forward_plain(*cpu)
    got_p, got_s = profile.profile_forward(*cuda_t, geometry=g)
    assert profile.launched_geometry() == profile.profile_geometry(B, N,
                                                                   True, g)
    assert torch.equal(got_p.cpu(), ref_p)
    assert torch.equal(got_s.cpu(), ref_s)
    got_9 = profile.profile_forward_scores(*cuda_t, geometry=g)
    assert profile.launched_geometry() == profile.profile_geometry(B, N,
                                                                   False, g)
    assert torch.equal(got_9.cpu(), ref_s)
    T = gapped._device_tb_T(M, N)
    ref_w = gapped.traceback_walk_plain(ref_p, cpu[2], cpu[3], T)
    got_w = gapped.traceback_walk(got_p, cuda_t[2], cuda_t[3], T)
    for a, b in zip(got_w, ref_w):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("g", range(6))
def test_strip_kernels_every_geometry_equal_plain(dev, g):
    """K3 and K9 in strip geometry g at its edge widths: a one-warp
    bucket (N = 32K - 1) and a two-strip one (N = 32K + 1), q_len at
    32K - 1, 32K and 32K + 1 where they fit, empty windows and windows
    with p_len = 0 or q_len = 0."""
    K = profile.profile_geometry(1, 16, True, g)["K"]
    assert K == windows.STRIP_KS[g]
    rng = np.random.default_rng(40 + g)
    for M, N, shapes in windows.strip_edges(K):
        cpu = _sized_profiles(rng, M, N, shapes)
        if profile.profile_geometry(len(shapes), N, True, g)[
                "windows_per_sm"]:
            _full_kernels_equal_plain(dev, cpu, g)
        _full_kernels_equal_plain(dev, cpu)


def test_strip_kernels_many_windows_equal_plain(dev):
    """More windows of the 16-column bucket than the card holds at once
    (windows an SM x the SMs, plus some): packed blocks in waves."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = profile.profile_geometry(1 << 20, 16, True)["windows_per_sm"]
    B = per_sm * n_sm + 7
    rng = np.random.default_rng(41)
    p = np.zeros((B, 16, 5), np.float32)
    q = np.zeros((B, 16, 5), np.float32)
    pl = rng.integers(0, 17, B).astype(np.int32)
    ql = rng.integers(0, 17, B).astype(np.int32)
    p[np.arange(B)[:, None], np.arange(16)[None], rng.integers(0, 4, (B, 16))] = 1
    q[np.arange(B)[:, None], np.arange(16)[None], rng.integers(0, 4, (B, 16))] = 1
    p[np.arange(16)[None] >= pl[:, None]] = 0
    q[np.arange(16)[None] >= ql[:, None]] = 0
    assert profile.profile_geometry(B, 16, True)["windows_per_sm"] == per_sm
    _full_kernels_equal_plain(dev, [torch.from_numpy(x)
                                    for x in (p, q, pl, ql)])


@pytest.mark.parametrize("d", [-1, 0, 1])
def test_wide_route_boundary_equal_plain(dev, d):
    """At N = STRIP_MAX_N - 1 and STRIP_MAX_N the strips, at
    STRIP_MAX_N + 1 the wide route (which takes no forced geometry)."""
    M, N, shapes = windows.BOUNDARY[d + 1]
    assert N == profile.STRIP_MAX_N + d
    cpu = _sized_profiles(np.random.default_rng(50 + d), M, N, shapes)
    _full_kernels_equal_plain(dev, cpu)
    route = profile.launched_geometry()["route"]
    assert route == ("wide" if d > 0 else "strips")
    if d > 0:
        assert profile.profile_geometry(4, N, True, 0) is None
        with pytest.raises(RuntimeError):
            profile.profile_forward(*[x.to(dev) for x in cpu], geometry=0)


def _band_batch(rng, B, M, N):
    """B near-diagonal windows with fractional multi-row profiles, one
    with a 300-column insertion (fails the certificate) and one too short
    to band (q longer than twice p)."""
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for r in range(B):
        n = int(rng.integers(M // 2, M - 40))
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        sub = rng.random(n) < 0.02
        b[sub] = rng.integers(0, 4, int(sub.sum()))
        if r == 1:
            b = np.concatenate([b[:n // 2], rng.integers(0, 4, 300),
                                b[n // 2:]]).astype(np.uint8)
        if r == 2:
            a = a[:N // 4]
        b = b[:N]
        for arr, s, k in ((p, a, 1 + r % 3), (q, b, 1 + r % 2)):
            rows = np.stack([s] * k)
            rows[rng.random(rows.shape) < 0.005] = 4
            rows[:, (rows == 4).all(axis=0)] = 0
            arr[r, :len(s)] = profile.rows_to_profile(rows)
        pl[r], ql[r] = len(a), len(b)
    return [torch.from_numpy(x) for x in (p, q, pl, ql)]


@pytest.mark.parametrize("M,N,smem", [(1024, 1024, True),
                                      (1536, 1536, True),
                                      (512, 4608, False)])
def test_score_forward_kernel_equals_plain(dev, monkeypatch, M, N, smem):
    """K9 against its plain version, and bit for bit K3's score (strips;
    at 4608 columns the wide route with its rows in global scratch)."""
    if not smem:   # the wide route's rows in global scratch
        monkeypatch.setattr(profile, "PROFILE_SMEM_LIMIT", 0)
    cpu = _band_batch(np.random.default_rng(N), 6, M, N)
    ref = profile.profile_forward_scores_plain(*cpu)
    got = profile.profile_forward_scores(*[x.to(dev) for x in cpu])
    assert torch.equal(got.cpu(), ref)
    _, k3 = profile.profile_forward(*[x.to(dev) for x in cpu])
    assert torch.equal(k3, got)


@pytest.mark.parametrize("M,N", [(1024, 1024), (1536, 2304)])
def test_banded_kernels_equal_plain(dev, M, N):
    """K10, K11 and K12 against their plain versions: scores bit for bit,
    certificates, pointer bytes and the walk's column codes equal."""
    cpu = _band_batch(np.random.default_rng(M + N), 7, M, N)
    cuda_t = [x.to(dev) for x in cpu]
    H_W = profile._band_half(N)
    ref_s, ref_c = profile.banded_forward_scores_plain(
        *cpu, profile.GAP_OPEN, profile.GAP_EXTEND, H_W)
    got_s, got_c = profile.banded_forward_scores(
        *cuda_t, profile.GAP_OPEN, profile.GAP_EXTEND, H_W)
    assert torch.equal(got_s.cpu(), ref_s)
    assert torch.equal(got_c.cpu(), ref_c)
    assert bool(ref_c[0]) and not bool(ref_c[1])
    ref_p, ref_s2, ref_c2 = profile.banded_forward_ptrs_plain(
        *cpu, profile.GAP_OPEN, profile.GAP_EXTEND, H_W)
    got_p, got_s2, got_c2 = profile.banded_forward_ptrs(
        *cuda_t, profile.GAP_OPEN, profile.GAP_EXTEND, H_W)
    assert torch.equal(got_p.cpu(), ref_p)
    assert torch.equal(got_s2.cpu(), ref_s) and torch.equal(got_c2.cpu(),
                                                            ref_c)
    T = gapped._device_tb_T(M, N)
    ref_w = profile.banded_traceback_walk_plain(ref_p, cpu[2], cpu[3], N,
                                                H_W, T)
    got_w = profile.banded_traceback_walk(got_p, cuda_t[2], cuda_t[3], N,
                                          H_W, T)
    for g, r in zip(got_w, ref_w):    # codes, counts, steps
        assert torch.equal(g.cpu(), r)


def _band_windows(rng, M, N, shapes):
    """Windows of the given (p_len, q_len, insertion) shapes with
    fractional multi-row profiles: q is p with 2% substitutions, an
    insertion of that many random columns in the middle, then cut or
    extended with random columns to q_len."""
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
            arr[r, :len(s)] = profile.rows_to_profile(rows)
        pl[r], ql[r] = n_p, n_q
    return [torch.from_numpy(x) for x in (p, q, pl, ql)]


# the edge windows of the 1024 bucket: p_len under 128 (and not a
# multiple of it), q_len under WB, an ineligible window (q_len > 2 p_len),
# the 300-column insertion that fails the certificate, and q_len = 1.5
# p_len, whose band start lo moves at every 128-row boundary
EDGE_SHAPES = [(100, 130, 0), (301, 310, 0), (200, 300, 0), (200, 1000, 0),
               (700, 1000, 300), (600, 900, 0)]


def _plain_gap_bound(t, H_W):
    """The certificate's gap bound as banded_forward_plain forms it: the
    blocked prefix sum of the sorted gap costs (-inf as 0) at g_lb - 1."""
    p, q, pl, ql = t
    L = p.shape[1] + q.shape[1]
    costs = profile.band_costs(p, q, pl, ql)
    csum = profile.blocked_cumsum(torch.where(torch.isfinite(costs), costs,
                                              0.0))
    g_lb = (2 * H_W - 3 * (ql.long() - pl.long()).abs()).clamp(min=0)
    gidx = (g_lb - 1).clamp(0, L - 1)
    return torch.where(g_lb > 0, csum.gather(1, gidx[:, None])[:, 0], 0.0)


def _banded_vs_plain(t, H_W, geometry=-1):
    """K10, K11 and K12 on the card against their plain versions on the
    same CUDA tensors: scores, certificates, the certificate's gap bound
    (K10's selection of the largest gap costs against the full sort),
    every pointer byte and the walks' column codes equal.  Returns the
    plain
    certificates."""
    go, ge = profile.GAP_OPEN, profile.GAP_EXTEND
    kw = dict(geometry=geometry)
    ref_s, ref_c = profile.banded_forward_scores_plain(*t, go, ge, H_W)
    got_s, got_c = profile.banded_forward_scores(*t, go, ge, H_W, **kw)
    assert torch.equal(got_s, ref_s) and torch.equal(got_c, ref_c)
    bound = torch.empty(len(t[2]), dtype=torch.float32, device=t[0].device)
    profile._banded_launch(*t, go, ge, H_W, False, geometry, bound)
    assert torch.equal(bound, _plain_gap_bound(t, H_W))
    ref_p, ref_s2, ref_c2 = profile.banded_forward_ptrs_plain(*t, go, ge,
                                                              H_W)
    got_p, got_s2, got_c2 = profile.banded_forward_ptrs(*t, go, ge, H_W,
                                                        **kw)
    assert torch.equal(got_p, ref_p)
    assert torch.equal(got_s2, ref_s) and torch.equal(got_c2, ref_c)
    assert torch.equal(ref_s2, ref_s) and torch.equal(ref_c2, ref_c)
    Mp, N = t[0].shape[1], t[1].shape[1]
    T = gapped._device_tb_T(Mp, N)
    ref_w = profile.banded_traceback_walk_plain(ref_p, t[2], t[3], N, H_W, T)
    got_w = profile.banded_traceback_walk(got_p, t[2], t[3], N, H_W, T)
    for g, r in zip(got_w, ref_w):    # codes, counts, steps
        assert torch.equal(g, r)
    return ref_c


def test_banded_many_windows_equal_plain(dev):
    """K10/K11 at the refine gate's launch shape: 2,112 windows in the
    1024 bucket (16 an SM on 132 SMs) with the edge windows among them,
    in the launcher's geometry."""
    rng = np.random.default_rng(1024)
    n = rng.integers(400, 985, 2112 - len(EDGE_SHAPES))
    d = rng.integers(-20, 21, len(n))
    shapes = [(int(a), int(a + b), 0) for a, b in zip(n, d)] + EDGE_SHAPES
    t = [x.to(dev) for x in _band_windows(rng, 1024, 1024, shapes)]
    H_W = profile._band_half(1024)
    cert = _banded_vs_plain(t, H_W).cpu()
    assert bool(cert[0]) and not bool(cert[-2])   # the insertion fails


def test_banded_wide_windows_equal_plain(dev):
    """K10/K11 at the tracebacks' launch shape: three windows in the
    11,664 bucket, one of 10,000 rows and 9,980 columns, one with the
    300-column insertion and one short, in the launcher's geometry."""
    rng = np.random.default_rng(11664)
    shapes = [(10_000, 9_980, 0), (6_000, 6_300, 300), (120, 170, 0)]
    t = [x.to(dev) for x in _band_windows(rng, 10_112, 11_664, shapes)]
    H_W = profile._band_half(11_664)
    geo = profile.band_geometry(H_W, True, B=3)
    assert geo["warps"] > 1   # a wide window takes several strips
    cert = _banded_vs_plain(t, H_W).cpu()
    assert bool(cert[0]) and not bool(cert[1])


@pytest.mark.parametrize("M,N", [(1024, 1024), (1536, 2304)])
def test_banded_every_geometry_equals_plain(dev, M, N):
    """Each geometry of the launcher's table that fits the band, forced,
    on random windows and the edge windows."""
    rng = np.random.default_rng(M + N + 1)
    n = rng.integers(M // 2, M - 40, 6)
    shapes = [(int(a), int(a + 7), 0) for a in n] + EDGE_SHAPES
    t = [x.to(dev) for x in _band_windows(rng, M, N, shapes)]
    H_W = profile._band_half(N)
    fits = 0
    g = 0
    while (geo := profile.band_geometry(H_W, True, g=g)) is not None:
        if geo["windows_per_sm"] > 0:
            _banded_vs_plain(t, H_W, geometry=g)
            fits += 1
        g += 1
    assert fits >= 4


E_RUN = gapped.H_E | gapped.E_EXT_BIT    # enter E and stay
F_RUN = gapped.H_F | gapped.F_EXT_BIT    # enter F and stay


def _walk_vs_plain(kind, ptrs, pl, ql, N, H_W=None, geometries=(-1,)):
    """K4 (kind "full") or K12 ("banded") on the card against its plain
    version on the same CUDA tensors, exactly (codes, counts, steps), in
    each geometry of `geometries` (-1: the launcher's pick) that fits.
    Returns the geometries run, as walk_geometry describes them."""
    B, M = ptrs.shape[:2]
    T = gapped._device_tb_T(M, N)
    if kind == "full":
        ref = gapped.traceback_walk_plain(ptrs, pl, ql, T)

        def run(g):
            return gapped.traceback_walk(ptrs, pl, ql, T, geometry=g)
    else:
        ref = profile.banded_traceback_walk_plain(ptrs, pl, ql, N, H_W, T)

        def run(g):
            return profile.banded_traceback_walk(ptrs, pl, ql, N, H_W, T,
                                                 geometry=g)
    ran = []
    for g in geometries:
        geo = gapped.walk_geometry(kind, B, M, N if kind == "full" else H_W,
                                   g)
        if not geo["warps"]:
            continue
        got = run(g)
        assert all(torch.equal(x, y) for x, y in zip(got, ref)), (kind, geo)
        ran.append(geo)
    return ran


def _run_ptrs(dev, B, M, N1, seed, diag=85):
    """Pointer bytes made on the card: 0 (diagonal) with probability
    diag %, else a random byte whose state bits are 0-2."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (B, M, N1)
    r = torch.randint(0, 16, shape, generator=gen, device=dev,
                      dtype=torch.uint8)
    r = torch.where(r % 4 == 3, r - 3, r)
    keep = torch.randint(0, 100, shape, generator=gen, device=dev,
                         dtype=torch.uint8) < diag
    return torch.where(keep, 0, r)


@pytest.mark.parametrize("kind", ["full", "banded"])
def test_walk_kernels_every_geometry_equal_plain(dev, kind):
    """K4 and K12 in each geometry of csrc/walk.cuh's table, forced, and
    in the launcher's pick, on the pointers of K3 (K11) over random and
    edge windows of the 1024 bucket, with one window's pointers all E
    and one's all F."""
    rng = np.random.default_rng(1025)
    n = rng.integers(400, 985, 8)
    shapes = [(int(a), int(a + 9), 0) for a in n] + EDGE_SHAPES
    t = [x.to(dev) for x in _band_windows(rng, 1024, 1024, shapes)]
    if kind == "full":
        ptrs, _ = profile.profile_forward(*t)
        H_W = None
    else:
        H_W = profile._band_half(1024)
        ptrs, _, _ = profile.banded_forward_ptrs(
            *t, profile.GAP_OPEN, profile.GAP_EXTEND, H_W)
    ptrs[0] = E_RUN
    ptrs[1] = F_RUN
    ran = _walk_vs_plain(kind, ptrs, t[2], t[3], 1024, H_W,
                         (-1,) + tuple(range(5)))
    assert len(ran) == 6, ran   # every geometry fits these rows
    assert ran[-1]["cols"] == 512 and ran[1]["rows"] == 32


def test_walk_kernels_straight_runs_equal_plain(dev):
    """A walk straight up through many slabs (all F, 4,096 rows) and one
    along a row (all E, 8,192 columns: K4 takes the slab route), in every
    geometry that fits."""
    pl = torch.tensor([4096, 4000], dtype=torch.int32, device=dev)
    ql = torch.tensor([60, 64], dtype=torch.int32, device=dev)
    ptrs = torch.full((2, 4096, 65), F_RUN, dtype=torch.uint8, device=dev)
    assert len(_walk_vs_plain("full", ptrs, pl, ql, 64,
                              geometries=(-1,) + tuple(range(5)))) == 6
    H_W = profile._band_half(1024)
    bp = torch.full((2, 4096, profile.band_width(H_W) + 1), F_RUN,
                    dtype=torch.uint8, device=dev)
    ql = torch.tensor([1000, 1024], dtype=torch.int32, device=dev)
    assert len(_walk_vs_plain("banded", bp, pl, ql, 1024, H_W,
                              (-1,) + tuple(range(5)))) == 6
    pl = torch.tensor([64], dtype=torch.int32, device=dev)
    ql = torch.tensor([8192], dtype=torch.int32, device=dev)
    ptrs = torch.full((1, 64, 8193), E_RUN, dtype=torch.uint8, device=dev)
    ran = _walk_vs_plain("full", ptrs, pl, ql, 8192,
                         geometries=(-1,) + tuple(range(5)))
    assert ran[0]["cols"] == 512 and len(ran) >= 3


def test_full_walk_many_and_wide_windows_equal_plain(dev):
    """K4 at the refine gate's launch shape (2,112 windows in the 1024
    bucket), at the wide one (three windows of 10,112 rows in the 11,664
    bucket, the longest 10,000 x 9,980) and on windows wide enough for
    the column-slab route (24,576 columns), on pointer bytes made on the
    card, in the launcher's geometry and a forced whole-row one."""
    rng = np.random.default_rng(2112)
    pl = torch.from_numpy(rng.integers(400, 1025, 2112).astype(np.int32))
    ql = (pl + torch.from_numpy(rng.integers(-20, 21, 2112).astype(
        np.int32))).clamp(0, 1024)
    ptrs = _run_ptrs(dev, 2112, 1024, 1025, 1)
    ran = _walk_vs_plain("full", ptrs, pl.to(dev), ql.to(dev), 1024)
    assert ran[0]["cols"] == 0 and ran[0]["warps"] == 16
    del ptrs
    pl = torch.tensor([10_000, 6_000, 120], dtype=torch.int32, device=dev)
    ql = torch.tensor([9_980, 6_300, 170], dtype=torch.int32, device=dev)
    ptrs = _run_ptrs(dev, 3, 10_112, 11_665, 2, diag=95)
    ran = _walk_vs_plain("full", ptrs, pl, ql, 11_664, geometries=(-1, 3))
    assert ran[0]["cols"] == 512 and ran[1]["cols"] == 0
    del ptrs
    pl = torch.tensor([256, 200], dtype=torch.int32, device=dev)
    ql = torch.tensor([24_000, 24_576], dtype=torch.int32, device=dev)
    ptrs = _run_ptrs(dev, 2, 256, 24_577, 3, diag=40)
    ran = _walk_vs_plain("full", ptrs, pl, ql, 24_576)
    assert ran[0]["cols"] == 512


def test_refine_on_cuda_equals_cpu(dev):
    """align_codes with refinement: GPU kernels give the CPU tensors'
    rows."""
    from libmems_tpu_torch import align_codes
    rng = np.random.default_rng(41)
    anc = rng.integers(0, 4, 1100).astype(np.uint8)
    seqs = []
    for _ in range(4):
        s = anc.copy()
        sub = rng.random(len(s)) < 0.03
        s[sub] = rng.integers(0, 4, int(sub.sum()))
        at = int(rng.integers(100, 1000))
        seqs.append(np.concatenate([s[:at], s[at + 3:]]).astype(np.uint8))
    ref = align_codes(seqs, refine_iters=2, device="cpu")
    got = align_codes(seqs, refine_iters=2, device=dev)
    np.testing.assert_array_equal(got, ref)


def _family(G, n, rng_seed):
    rng = np.random.default_rng(rng_seed)
    anc = rng.integers(0, 4, size=n).astype(np.uint8)
    out = [anc] + [generate._mutant(rng, anc, invert=(n // 4, n // 3)
                                    if g % 2 else None)
                   for g in range(1, G)]
    ascii_ = [generate._LUT[g].copy() for g in out]
    ascii_[1][100:160] = ord("N")
    return [Genome(f"g{i}", a) for i, a in enumerate(ascii_)]


def test_pairwise_kernels_equal_plain(dev):
    """K5, K6 and K7 against their plain versions on one table: exact."""
    from libmems_tpu_torch.matchfind import _pair_pos_bits
    from libmems_tpu_torch.ops import pairwise
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls
    G = 6
    smls, seed = create_smls(_family(G, 60_000, 36), device="cpu")
    keys = torch.cat([s.keys for s in smls])
    cnts = [s.n_windows for s in smls]
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(cnts)]))
    c_sorted, src = torch.sort(pairwise.shr(keys, 1), stable=True)
    args = (c_sorted, src, keys, offs, 1000, sentinel_content(seed))
    ref = pairwise.run_flags_plain(*args)
    got = pairwise.run_flags(*[a.to(dev) if isinstance(a, torch.Tensor)
                               else a for a in args])
    for r, g in zip(ref, got):
        assert torch.equal(g.cpu(), r)
    pb = _pair_pos_bits(max(cnts))
    ref_w = pairwise.cluster_words_plain(ref, G, pb)
    got_w = pairwise.cluster_words(got, G, pb)
    assert torch.equal(got_w.cpu(), ref_w)
    cw = pairwise.usort(ref_w)
    off32 = offs[:-1].to(torch.int32)
    cnt32 = torch.tensor(cnts, dtype=torch.int32)
    seed_len = smls[0].seed_length
    for ec in (64, 1 << 14):
        ref_r = pairwise.cluster_reps_plain(cw, ec, G, pb, seed_len, off32,
                                            cnt32)
        got_r = pairwise.cluster_reps(cw.to(dev), ec, G, pb, seed_len,
                                      off32.to(dev), cnt32.to(dev))
        assert got_r.n_reps == ref_r.n_reps > 64
        for r, g in zip(ref_r[:-1], got_r[:-1]):
            assert torch.equal(g.cpu(), r)


def test_pairwise_mums_cuda_equal_cpu(dev):
    from libmems_tpu_torch import find_pairwise_mums
    gs = _family(5, 50_000, 37)
    ref = find_pairwise_mums(gs, device="cpu")
    got = find_pairwise_mums(gs, device=dev)
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


def _synth_flags(n, G, pos_bits, rng_seed, p_keep=0.9, max_run=12,
                 sentinel=None):
    """Run flags of n table rows: runs of 1..max_run rows, a kept share
    p_keep, random genomes, positions below 2^pos_bits and strands; with
    sentinel=(a, b) rows [a, b) form one run of which none is kept."""
    from libmems_tpu_torch.ops import pairwise
    rng = np.random.default_rng(rng_seed)
    rid = np.repeat(np.arange(n), rng.integers(1, max_run + 1, size=n))[:n]
    keep = rng.random(n) < p_keep
    if sentinel is not None:
        a, b = sentinel
        keep[a:b] = False
        rid[b:] += rid[a] + 1 - rid[b]
        rid[a:b] = rid[a]
    return pairwise.RunFlags(
        torch.from_numpy(keep), torch.from_numpy(rid.astype(np.int32)),
        torch.from_numpy(rng.integers(0, G, size=n).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 1 << pos_bits, size=n)
                         .astype(np.int32)),
        torch.from_numpy(rng.integers(0, 2, size=n).astype(np.uint8)))


@pytest.mark.parametrize("case,n,G,pos_bits", [
    ("kept0", 5_000, 9, 20),
    ("kept_below_shifts", 5_000, 9, 20),
    ("ragged", 3 * 4096 + 77, 2, 29),
    ("ragged", 3 * 4096 + 77, 3, 28),
    ("ragged", 3 * 4096 + 77, 62, 24),
    ("long_runs", 100_003, 9, 20),
    ("sentinel_run", 1_200_000, 9, 20),
    ("many_blocks", 10_000_019, 3, 24)])
def test_cluster_words_kernel_edges_equal_plain(dev, case, n, G, pos_bits):
    """K6 against its plain version on synthetic tables built to reach
    its edges: no kept row, fewer kept rows than shifts, row counts that
    are no multiple of a tile or a block with runs across their bounds,
    runs of thousands of rows, a sentinel run of 10^6 rows, and a table
    of several thousand tiles (the look-back between tiles); exact."""
    from libmems_tpu_torch.ops import pairwise
    flags = _synth_flags(
        n, G, pos_bits, 61, p_keep=0.0 if case.startswith("kept") else 0.9,
        max_run=5_000 if case == "long_runs" else 12,
        sentinel=(100_000, 1_100_000) if case == "sentinel_run" else None)
    if case == "kept_below_shifts":
        flags.unique_occ[[10, 4095, 4096]] = True
        flags.run_id[:] = 3
    ref = pairwise.cluster_words_plain(flags, G, pos_bits)
    got = pairwise.cluster_words(pairwise.RunFlags(*(t.to(dev)
                                                     for t in flags)),
                                 G, pos_bits)
    assert got.shape == ref.shape
    assert torch.equal(got.cpu(), ref)


def _sorted_words(m, n_heads, pos_bits, rng_seed, invalid=0, top_bit=False):
    """m sorted words head << pos_bits | pos (n_heads heads, so clusters
    of close positions run across tiles), bit 63 set on the upper heads
    with top_bit, then `invalid` -1 words."""
    rng = np.random.default_rng(rng_seed)
    head = rng.integers(0, n_heads, size=m).astype(np.uint64)
    if top_bit:
        head[head >= n_heads // 2] |= np.uint64(1 << (63 - pos_bits))
    w = np.sort((head << np.uint64(pos_bits))
                | rng.integers(0, 1 << pos_bits, size=m).astype(np.uint64))
    w = np.concatenate([w, np.full(invalid, 2**64 - 1, np.uint64)])
    return torch.from_numpy(w.view(np.int64).copy())


REP_EDGES = ["bit63", "all_invalid", "empty", "single", "tile_end",
             "no_invalid", "many_blocks"]


def _edge_words(case, pos_bits):
    """The sorted cluster words of a REP_EDGES case."""
    return {"bit63": lambda: _sorted_words(9_000, 64, pos_bits, 71, 1_500,
                                           top_bit=True),
            "all_invalid": lambda: torch.full((5_000,), -1,
                                              dtype=torch.int64),
            "empty": lambda: torch.zeros(0, dtype=torch.int64),
            "single": lambda: torch.tensor([5 << pos_bits | 7]),
            "tile_end": lambda: _sorted_words(8_192, 8, pos_bits, 72, 2_048),
            "no_invalid": lambda: _sorted_words(4_099, 8, pos_bits, 73),
            "many_blocks": lambda: _sorted_words(8_000_000, 50, pos_bits, 74,
                                                 3_000_001)}[case]()


@pytest.mark.parametrize("case", REP_EDGES)
def test_rep_index_and_decode_kernels_edges_equal_plain(dev, case):
    """K7's scan and decode against their plain versions, exact: words
    with bit 63 set, no valid word (n_reps = 0), no word, one word, the
    last valid word at a tile's end, no -1 word, and several thousand
    tiles; each decoded below, exactly at and above n_reps."""
    from libmems_tpu_torch.ops import pairwise
    G, pos_bits, seed_len = 9, 20, 15
    cw = _edge_words(case, pos_bits)
    ref_i = pairwise.rep_index_plain(cw, pos_bits, seed_len)
    idx = pairwise.rep_index(cw.to(dev), pos_bits, seed_len)
    assert idx.n_reps == ref_i.n_reps
    assert torch.equal(idx.counts.cpu(), ref_i.counts)
    assert torch.equal(idx.index[:idx.n_reps].cpu(), ref_i.index)
    off = torch.arange(G, dtype=torch.int32) * 1000
    cnt = torch.arange(G, dtype=torch.int32) + 500
    for ec in sorted({8, max(idx.n_reps - 1, 1), max(idx.n_reps, 1),
                      idx.n_reps + 5}):
        ref = pairwise.cluster_reps_plain(cw, ec, G, pos_bits, seed_len, off,
                                          cnt)
        got = pairwise.decode_reps(cw.to(dev), idx, ec, G, pos_bits,
                                   seed_len, off.to(dev), cnt.to(dev))
        assert got.n_reps == ref.n_reps
        for g, r in zip(got[:-1], ref[:-1]):
            assert torch.equal(g.cpu(), r)
    if case == "many_blocks":
        assert 0 < idx.n_reps < int(idx.counts[0]) < cw.shape[0]


@pytest.mark.parametrize("case", REP_EDGES)
def test_pair_reps_kernels_edges_equal_plain(dev, case):
    """K19 (K7's scan, one read of n_reps, the pair decode) against its
    plain version on K7's edge words, exact, with EC below, at and above
    n_reps."""
    from libmems_tpu_torch.ops import pair, pairwise
    pos_bits, seed_len = 20, 15
    cw = _edge_words(case, pos_bits)
    n = pairwise.rep_index_plain(cw, pos_bits, seed_len).n_reps
    for ec in sorted({8, max(n - 1, 1), max(n, 1), n + 5}):
        ref = pair.pair_reps_plain(cw, ec, pos_bits, seed_len)
        got = pair.pair_reps(cw.to(dev), ec, pos_bits, seed_len)
        assert got.n_reps == ref.n_reps == n
        for g, r in zip(got[:-1], ref[:-1]):
            assert torch.equal(g.cpu(), r)


def _signature_rows(G, pos_bits, runs, n_invalid=0, rng_seed=0):
    """K14's signature words and posref of clusters in the given order:
    cluster k holds runs[k] rows on one diagonal, posref one apart (its
    first row its representative); then n_invalid rows that seq_mask
    rejected (the invalid bit, posref 1 << 62), as they sort last."""
    from libmems_tpu_torch.ops import mums
    rng = np.random.default_rng(rng_seed)
    k = len(runs)
    runs = np.asarray(runs, dtype=np.int64)
    of = np.repeat(np.arange(k), runs)
    step = np.arange(len(of)) - np.repeat(np.cumsum(runs) - runs, runs)
    lo = 1 << (pos_bits - 3)
    off = rng.integers(lo, 2 * lo, (k, G))
    sign = np.where(rng.random((k, G)) < 0.3, -1, 1)
    present = rng.random((k, G)) < 0.8
    # genomes 0 and 1 in every cluster: no two clusters share their words
    sign[:, 0], present[:, :2] = 1, True
    # a reverse genome's position falls as the reference's rises
    pos = off[of] + sign[of] * step[:, None]
    starts = np.where(present[of], sign[of] * (pos + 1), 0)
    r, g = np.nonzero(starts)
    v = starts[r, g]
    t = torch.from_numpy
    flags = mums.MumFlags(
        torch.ones(len(v), dtype=torch.bool), t(r.astype(np.int32)),
        torch.zeros(len(v), dtype=torch.uint8), len(of),
        t(g.astype(np.int32)), t((np.abs(v) - 1).astype(np.int32)),
        t((v < 0).astype(np.uint8)), 0)
    cand = mums.mum_candidates_plain(flags, G, 0, pos_bits)
    bad = torch.zeros((cand.words.shape[0], n_invalid), dtype=torch.int64)
    bad[0] = 1 << 62
    return (torch.cat([cand.words, bad], 1),
            torch.cat([cand.posref, torch.full((n_invalid,), 1 << 62)]))


# (G, pos_bits, cluster lengths, invalid rows) of K15's edge cases; None
# draws clusters of 1-50 rows up to the given row count
K15_EDGES = {
    "empty": (3, 20, [], 0),
    "one": (3, 20, [1], 0),
    "all_invalid": (3, 20, [], 5_000),
    "every_row": (3, 20, [1] * 9_000, 0),
    "tile_end": (3, 20, [4_095, 2], 0),
    "past_tile_end": (3, 20, [4_096, 1], 0),
    "one_word": (2, 20, None, 3_000),
    "two_words": (3, 20, (None, 20_000), 1_000),
    "wide": (64, 16, (None, 5_000), 300),
    "many_tiles": (3, 20, (None, 3_000 * 4_096), 77),
}


@pytest.mark.parametrize("case", list(K15_EDGES))
def test_mum_reps_kernels_edges_equal_plain(dev, case):
    """K15's scan and decode against their plain versions, exact: no row,
    one row, every row invalid (n_reps = 0), every row a representative,
    the last representative at a tile's last row and one row past it,
    signature rows of 1, 2 and 21 words, and several thousand tiles; each
    decoded below, at and above n_reps."""
    from libmems_tpu_torch.ops import mums
    G, pos_bits, runs, n_invalid = K15_EDGES[case]
    rng = np.random.default_rng(len(case))
    if runs is None or isinstance(runs, tuple):
        rows = 20_000 if runs is None else runs[1]
        runs = rng.integers(1, 51, rows // 25 + 10)
        runs = runs[:np.searchsorted(np.cumsum(runs), rows) + 1]
        runs[-1] -= runs.sum() - rows
        runs = runs[runs > 0]
    words, posref = _signature_rows(G, pos_bits, runs, n_invalid,
                                    rng_seed=len(case))
    n_words = mums.n_words_for(G, pos_bits)
    assert words.shape[0] == n_words
    seed_len = 15
    ref = mums.mum_rep_index_plain(words, posref, G, pos_bits, seed_len)
    idx = mums.mum_rep_index(words.to(dev), posref.to(dev), G, pos_bits,
                             seed_len)
    n = idx.n_reps
    assert n == ref.n_reps
    assert torch.equal(idx.index[:n].cpu(), ref.index)
    want = {"empty": [], "one": [0], "all_invalid": [],
            "tile_end": [0, 4_095], "past_tile_end": [0, 4_096]}.get(case)
    if want is not None:
        assert ref.index.tolist() == want
    if case == "every_row":
        assert n == 9_000
    if case in ("one_word", "wide", "many_tiles"):
        assert n_words == {"one_word": 1, "wide": 21, "many_tiles": 2}[case]
        assert n == len(runs)
    for ec in sorted({1, max(n - 1, 1), max(n, 1), n + 5}):
        r = mums.mum_decode_reps_plain(words, posref, ref, ec, G, pos_bits)
        got = mums.mum_decode_reps(words.to(dev), posref.to(dev), idx, ec, G,
                                   pos_bits)
        assert got.n_reps == r.n_reps == n
        for a, b in zip(got[:-1], r[:-1]):
            assert torch.equal(a.cpu(), b)


def _reps_traces():
    """K15's and K19's traces (run by _traced_in_process): a mum_reps
    call, a pair_reps call, and find_mums_device on three genomes with a
    first capacity guess below their representative count."""
    from libmems_tpu_torch.matchfind import find_mums_device
    from libmems_tpu_torch.ops import mums, pair, pairwise
    from libmems_tpu_torch.sml import create_smls
    dev = torch.device("cuda", 0)
    words, posref = _signature_rows(3, 20, [3, 1, 7] * 2_000, 50)
    words, posref = words.to(dev), posref.to(dev)
    smls, seed, pb = _pair_keys(15, 60_000, 44)
    cw, _ = pair.pair_cluster_words_plain(smls[0].keys, smls[1].keys, pb,
                                          mers.sentinel_content(seed))
    cw = pairwise.usort(cw).to(dev)
    seed_len = smls[0].seed_length
    trio = create_smls(_family(3, 40_000, 38), device=dev)[0]
    return [_trace(lambda: mums.mum_reps(words, posref, 1 << 12, 3, 20, 15)),
            _trace(lambda: pair.pair_reps(cw, 1 << 12, pb, seed_len)),
            _trace(lambda: find_mums_device(trio, extend_capacity=8))]


def test_reps_traces_scan_and_decode(dev):
    """One call of K15's and of K19's wrappers traced by torch.profiler:
    the scan and the decode and no other kernel (no library cumsum), and
    one copy to the host (the representatives' count); find_mums_device
    on three genomes launches K15's scan and its decode once, though its
    first capacity guess is below the representative count."""
    (mk, m_d2h), (pk, p_d2h), (fk, _) = _traced_in_process("_reps_traces")
    assert [k for k, _ in mk] == ["mum_rep_index_kernel",
                                  "mum_decode_reps_kernel"], mk
    assert m_d2h == 1
    assert [k for k, _ in pk] == ["rep_index_kernel", "pair_reps_kernel"], pk
    assert p_d2h == 1
    names = [k for k, _ in fk]
    assert names.count("mum_rep_index_kernel") == 1, names
    assert names.count("mum_decode_reps_kernel") == 1, names


def test_find_mums_device_scans_rows_once(dev):
    """With a capacity below the representative count, find_mums_device
    on three genomes on the card scans the signature rows once and
    decodes once at the capacity their count asks for; its outputs equal
    CPU tensors'."""
    from libmems_tpu_torch.matchfind import find_mums_device
    from libmems_tpu_torch.ops import mums
    from libmems_tpu_torch.sml import create_smls
    gs = _family(3, 40_000, 38)
    ref = find_mums_device(create_smls(gs, device="cpu")[0],
                           extend_capacity=8)
    gpu = create_smls(gs, device=dev)[0]
    mums.mum_rep_index.launches = mums.mum_decode_reps.launches = 0
    got = find_mums_device(gpu, extend_capacity=8)
    assert (mums.mum_rep_index.launches, mums.mum_decode_reps.launches) \
        == (1, 1)
    assert int(ref[4]) > 8
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a.cpu(), b)
    assert (int(got[3]), int(got[4])) == (int(ref[3]), int(ref[4]))


def test_find_pairwise_mums_scans_words_once(dev):
    """With a capacity below the representative count, find_pairwise_mums
    on the card scans the cluster words once and decodes once at the
    capacity their count asks for; matches equal CPU tensors."""
    from libmems_tpu_torch import find_pairwise_mums
    from libmems_tpu_torch.ops import pairwise
    gs = _family(5, 50_000, 37)
    ref = find_pairwise_mums(gs, device="cpu", extend_capacity=8)
    for w in (pairwise.cluster_words, pairwise.rep_index,
              pairwise.decode_reps):
        w.launches = 0
    got = find_pairwise_mums(gs, device=dev, extend_capacity=8)
    assert (pairwise.cluster_words.launches, pairwise.rep_index.launches,
            pairwise.decode_reps.launches) == (1, 1, 1)
    assert len(ref) > 8
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


@pytest.mark.parametrize("T", [64, 4096, (1 << 14) + 3])
def test_hmm_kernel_equals_plain(dev, T):
    from libmems_tpu_torch.ops import hmm
    rng = np.random.default_rng(T)
    B = 5
    obs = rng.integers(0, 8, (B, T)).astype(np.uint8)
    blocks = np.repeat(rng.random((B, T // 64 + 1)) < 0.5, 64, 1)[:, :T]
    obs = np.where(blocks, rng.integers(0, 2, (B, T)), obs).astype(np.uint8)
    lens = np.array([T, max(T - 7, 1), max(T // 3, 1), 1, T], np.int32)
    mats = hmm.log_matrices(hmm.adapted_hoxd_params(0.45), "cpu")
    ref_p, ref_c = hmm.fb_posterior_plain(torch.from_numpy(obs),
                                          torch.from_numpy(lens), mats, 0.9)
    got_p, got_c = hmm.fb_posterior(torch.from_numpy(obs).to(dev),
                                    torch.from_numpy(lens).to(dev),
                                    tuple(m.to(dev) for m in mats), 0.9)
    assert float((got_p.cpu() - ref_p).abs().max()) <= 1e-12
    assert torch.equal(got_c.cpu(), ref_c)


def _hmm_ragged_case(case):
    """Sequences for K8's sequential route: rows of unequal length sharing
    warps, lengths around the 16-symbol group edges, or one row of
    65,536 columns (the route's widest) beside short ones."""
    rng = np.random.default_rng(len(case))
    if case == "warps":
        lens = rng.integers(1, 3_000, 45)
    elif case == "edges":
        lens = [16 * k + d for k in (1, 2, 3, 8) for d in (-1, 0, 1)] + \
            [1, 2, 3]
    else:
        lens = [1 << 16, 1_000, 1]
    seqs = []
    for n in lens:
        s = rng.integers(0, 8, n).astype(np.uint8)
        keep = np.repeat(rng.random(n // 64 + 1) < 0.5, 64)[:n]
        seqs.append(np.where(keep, rng.integers(0, 2, n), s).astype(np.uint8))
    return seqs


@pytest.mark.parametrize("case", ["warps", "edges", "long"])
def test_hmm_ragged_kernels_equal_plain(dev, case):
    """K8's sequential route (fb_ragged: the forward and backward chains,
    then the posterior pass) against its plain version on the card, bit
    for bit: posteriors torch.equal, calls equal, every column outside
    the rows 0; without posteriors the same calls; predict_homologous and
    posterior_homologous on the card equal to CPU tensors within 1e-12
    (the CPU's exp and log may differ in the last bit)."""
    from libmems_tpu_torch.ops import hmm
    seqs = _hmm_ragged_case(case)
    params = hmm.adapted_hoxd_params(0.45)
    md = hmm.log_matrices(params, dev)
    (batch,), padded = hmm.plan_launches(seqs)
    assert padded == []
    t = batch.tensors(dev)
    ref_p, ref_c = hmm.fb_ragged_plain(*t, md, 0.9)
    got_p, got_c = hmm.fb_ragged(*t, md, 0.9)
    assert torch.equal(got_p, ref_p)
    assert torch.equal(got_c, ref_c)
    assert 0 < int(ref_c.sum()) < sum(len(s) for s in seqs)
    _, calls = hmm.fb_ragged(*t, md, 0.9, want_post=False)
    assert torch.equal(calls, ref_c)
    for g, r in zip(hmm.predict_homologous(seqs, params, device=dev),
                    hmm.predict_homologous(seqs, params, device="cpu")):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(hmm.posterior_homologous(seqs, params, device=dev),
                    hmm.posterior_homologous(seqs, params, device="cpu")):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)


def test_hmm_sequential_forced_at_wide_width_equals_plain(dev):
    """fb_posterior(..., sequential=True) at a padded width of 2^17 (the
    smoke's comparison of the two routes): the new chains on rows at
    offsets b * T, bit-equal to fb_sequential_plain on the card."""
    from libmems_tpu_torch.ops import hmm
    T = hmm.FB_SCAN_MIN_T
    rng = np.random.default_rng(T)
    lens = np.array([T, T - 1, 70_001, 17], np.int32)
    obs = rng.integers(0, 8, (len(lens), T)).astype(np.uint8)
    blocks = np.repeat(rng.random((len(lens), T // 4096)) < 0.5, 4096, 1)
    obs = np.where(blocks, rng.integers(0, 2, obs.shape), obs)
    o = torch.from_numpy(obs.astype(np.uint8)).to(dev)
    n = torch.from_numpy(lens).to(dev)
    md = hmm.log_matrices(hmm.adapted_hoxd_params(0.45), dev)
    ref_p, ref_c = hmm.fb_sequential_plain(o, n, md, 0.9)
    got_p, got_c = hmm.fb_posterior(o, n, md, 0.9, sequential=True)
    assert torch.equal(got_p, ref_p)
    assert torch.equal(got_c, ref_c)


def test_hmm_chain_step_cycles(dev):
    """The one-thread step measurement runs and gives a positive count
    of cycles a step each way."""
    from libmems_tpu_torch.ops import hmm
    row = torch.from_numpy(_hmm_ragged_case("edges")[-4]).to(dev)
    md = hmm.log_matrices(hmm.hoxd_params(), dev)
    fwd, bwd = hmm.chain_step_cycles(row, md)
    assert 0 < fwd < 1e5 and 0 < bwd < 1e5


def test_nine_goldens_on_cuda(dev):
    from libmems_tpu_torch import (ProgressiveConfig, apply_backbone,
                                   progressive_align,
                                   write_backbone_columns,
                                   write_backbone_seq_coordinates)
    rng = np.random.default_rng(1004)      # generate._genomes_nine
    anc = rng.integers(0, 4, size=20_000).astype(np.uint8)
    gs = []
    for gi in range(9):
        inv = (6_000, 9_000) if gi % 3 == 1 else None
        g = generate._mutant(rng, anc, mutate=0.012, invert=inv)
        gs.append(Genome(f"e{gi}", generate._LUT[g], filename=f"e{gi}.fa"))
    ivs, _ = progressive_align(gs, ProgressiveConfig(refine=False,
                                                     device=dev))
    new_ivs, segs = apply_backbone(ivs, device=dev)
    outs = {}
    for name, write, args in (
            ("nine.xmfa", write_xmfa, (new_ivs,)),
            ("nine.bbseq", write_backbone_seq_coordinates,
             (segs, len(gs))),
            ("nine.bbcols", write_backbone_columns, (segs,))):
        buf = io.StringIO()
        write(buf, *args)
        outs[name] = buf.getvalue().encode()
    for name, data in outs.items():
        with open(f"{generate.GOLDEN_DIR}/{name}", "rb") as fh:
            assert data == fh.read(), name


def test_pair_xmfa_golden_on_cuda(dev):
    rng = np.random.default_rng(1001)      # generate._genomes_pair
    anc = rng.integers(0, 4, size=60_000).astype(np.uint8)
    b = generate._mutant(rng, anc, invert=(20_000, 28_000))
    gs = [Genome("gA", generate._LUT[anc], filename="gA.fa"),
          Genome("gB", generate._LUT[b], filename="gB.fa")]
    ivs, _ = align(gs, AlignerConfig(gapped_alignment=True, device=dev))
    buf = io.StringIO()
    write_xmfa(buf, ivs)
    with open(f"{generate.GOLDEN_DIR}/pair.xmfa", "rb") as fh:
        assert buf.getvalue().encode() == fh.read()


@pytest.mark.parametrize("tol,seq_mask", [(0, 0), (0, 0b101), (2, 0)])
def test_mum_kernels_equal_plain(dev, tol, seq_mask):
    """K13, K14 and K15 against their plain versions on one G = 3 table:
    exact.  K14 takes K13's flags at repeat_tolerance 0 only (its one
    caller's; a kept run is then one group of consecutive rows) and
    refuses the others, so at tol = 2 K15's input comes from K14's plain
    version."""
    from libmems_tpu_torch.matchfind import _lexsort_rows, _seed_table
    from libmems_tpu_torch.ops import mums
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls
    G = 3
    smls, seed = create_smls(_family(G, 60_000, 38), device="cpu")
    keys, seg_off, content, src = _seed_table(smls)
    args = (content, src, keys, seg_off, tol, 1000, sentinel_content(seed))
    ref = mums.mum_seed_flags_plain(*args)
    got = mums.mum_seed_flags(*[a.to(dev) if isinstance(a, torch.Tensor)
                                else a for a in args])
    assert got.n_rows == ref.n_rows > 1000
    for r, g in zip(ref, got):
        if isinstance(r, torch.Tensor):
            assert torch.equal(g.cpu(), r)
    pos_bits = keys.shape[0].bit_length()
    ref_c = mums.mum_candidates_plain(ref, G, seq_mask, pos_bits)
    if tol == 0:
        got_c = mums.mum_candidates(got, G, seq_mask, pos_bits)
        for r, g in zip(ref_c, got_c):
            assert torch.equal(g.cpu(), r)
    else:
        with pytest.raises(ValueError, match="repeat_tolerance 0"):
            mums.mum_candidates(got, G, seq_mask, pos_bits)
    order = _lexsort_rows(list(ref_c.words) + [ref_c.posref])
    words = torch.index_select(ref_c.words, 1, order)
    posref = ref_c.posref[order]
    seed_len = smls[0].seed_length
    for ec in (64, 1 << 14):
        ref_r = mums.mum_reps_plain(words, posref, ec, G, pos_bits, seed_len)
        got_r = mums.mum_reps(words.to(dev), posref.to(dev), ec, G, pos_bits,
                              seed_len)
        assert got_r.n_reps == ref_r.n_reps > 64
        for r, g in zip(ref_r[:-1], got_r[:-1]):
            assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("G", [64, 100])
def test_mum_kernels_wide_rows_equal_plain(dev, G):
    """K14 and K15 above 62 genomes, where the signature's mask and sign
    fields span several words: exact against their plain versions, and
    the device pipeline on the GPU equals it on CPU tensors."""
    from libmems_tpu_torch.matchfind import (_lexsort_rows, _seed_table,
                                             find_mums_device)
    from libmems_tpu_torch.ops import mums
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls
    smls, seed = create_smls(_family(G, 3_000, 41), device="cpu")
    keys, seg_off, content, src = _seed_table(smls)
    flags = mums.mum_seed_flags_plain(content, src, keys, seg_off, 0, 1000,
                                      sentinel_content(seed))
    assert flags.n_rows > 100
    pos_bits = keys.shape[0].bit_length()
    ref_c = mums.mum_candidates_plain(flags, G, 0, pos_bits)
    got_c = mums.mum_candidates(
        mums.MumFlags(*[x.to(dev) if isinstance(x, torch.Tensor) else x
                        for x in flags]), G, 0, pos_bits)
    for r, g in zip(ref_c, got_c):
        assert torch.equal(g.cpu(), r)
    assert (ref_c.starts != 0).sum(dim=1).max() > 62
    order = _lexsort_rows(list(ref_c.words) + [ref_c.posref])
    words = torch.index_select(ref_c.words, 1, order)
    posref = ref_c.posref[order]
    seed_len = smls[0].seed_length
    ref_r = mums.mum_reps_plain(words, posref, 1 << 13, G, pos_bits,
                                seed_len)
    got_r = mums.mum_reps(words.to(dev), posref.to(dev), 1 << 13, G,
                          pos_bits, seed_len)
    assert got_r.n_reps == ref_r.n_reps > 0
    for r, g in zip(ref_r[:-1], got_r[:-1]):
        assert torch.equal(g.cpu(), r)
    gpu = create_smls(_family(G, 3_000, 41), seed, device=dev)[0]
    for a, b in zip(find_mums_device(gpu)[:3], find_mums_device(smls)[:3]):
        assert torch.equal(a.cpu(), b)


def _fused_flags(G, n, rng_seed):
    """The fused path's K13 flags (plain version, repeat_tolerance 0) of
    a G-genome family, with pos_bits."""
    from libmems_tpu_torch.matchfind import _seed_table
    from libmems_tpu_torch.ops import mums
    from libmems_tpu_torch.ops.mers import sentinel_content
    from libmems_tpu_torch.sml import create_smls
    smls, seed = create_smls(_family(G, n, rng_seed), device="cpu")
    keys, seg_off, content, src = _seed_table(smls)
    flags = mums.mum_seed_flags_plain(content, src, keys, seg_off, 0, 1000,
                                      sentinel_content(seed))
    return flags, keys.shape[0].bit_length()


@pytest.mark.parametrize("G,seq_mask", [
    (2, 0), (2, 0b11), (3, 0), (3, 0b101), (9, 0), (9, (1 << 9) - 1),
    (9, 0b101111111), (63, 0), (64, 0), (64, (1 << 64) - 1)])
def test_mum_candidates_kernel_equals_plain(dev, G, seq_mask):
    """K14 in one pass against its plain version on the flags of K13 at
    repeat_tolerance 0 (its caller's), with and without seq_mask."""
    from libmems_tpu_torch.ops import mums
    n = {2: 60_000, 3: 60_000, 9: 20_000, 63: 3_000, 64: 3_000}[G]
    flags, pos_bits = _fused_flags(G, n, 40 + G)
    assert flags.n_rows > 100
    ref = mums.mum_candidates_plain(flags, G, seq_mask, pos_bits)
    got = mums.mum_candidates(
        mums.MumFlags(*[x.to(dev) if isinstance(x, torch.Tensor) else x
                        for x in flags]), G, seq_mask, pos_bits)
    for r, g in zip(ref, got):
        assert torch.equal(g.cpu(), r)
    valid = ref.posref != 1 << 62
    assert valid.any() and (seq_mask or valid.all())


def test_mum_candidates_kernel_no_rows(dev):
    """K14 where K13 kept no run: empty outputs, no launch needed."""
    from libmems_tpu_torch.ops import mums
    z = torch.zeros(7, dtype=torch.int32)
    flags = mums.MumFlags(z.bool(), z, z.to(torch.uint8), 0, z, z,
                          z.to(torch.uint8), 0)
    for sm in (0, 0b101):
        ref = mums.mum_candidates_plain(flags, 3, sm, 20)
        got = mums.mum_candidates(
            mums.MumFlags(*[x.to(dev) if isinstance(x, torch.Tensor) else x
                            for x in flags]), 3, sm, 20)
        for r, g in zip(ref, got):
            assert g.shape == r.shape and torch.equal(g.cpu(), r)


def _k2_k14_traces():
    """K14's trace on the trio's flags, and the fused pair's and trio's
    traces with their representatives' counts (run by
    _traced_in_process)."""
    from libmems_tpu_torch.matchfind import find_mums_device
    from libmems_tpu_torch.ops import mums
    from libmems_tpu_torch.sml import create_smls
    dev = torch.device("cuda", 0)
    flags, pos_bits = _fused_flags(3, 40_000, 38)
    flags = mums.MumFlags(*[x.to(dev) if isinstance(x, torch.Tensor) else x
                            for x in flags])
    pair = create_smls(_family(2, 60_000, 42), device=dev)[0]
    trio = create_smls(_family(3, 40_000, 38), device=dev)[0]
    return [_trace(lambda: mums.mum_candidates(flags, 3, 0, pos_bits)),
            _trace(lambda: find_mums_device(pair), grids=True),
            find_mums_device(pair)[4],
            _trace(lambda: find_mums_device(trio), grids=True),
            find_mums_device(trio)[4]]


def test_k14_one_kernel_and_k2_live_rows_only(dev):
    """One call of K14's wrapper traced by torch.profiler: its one kernel
    and no other (no zero fill), no copy to the host; the fused pair and
    trio launch K2's warp route over their representatives only."""
    (k14, d2h), (pk, _), p_reps, (tk, _), t_reps = _traced_in_process(
        "_k2_k14_traces")
    assert [k for k, _ in k14] == ["mum_candidates_kernel"], k14
    assert d2h == 0
    for kernels, n_reps in ((pk, p_reps), (tk, t_reps)):
        grids = [g for k, _, g in kernels if k == "extend_warp_kernel"]
        assert grids == [-(-n_reps // 8)], (grids, n_reps)
        assert "extend_kernel" not in [k for k, _, _ in kernels]


@pytest.mark.parametrize("G", [3, 9])
def test_extend_kernel_many_genomes_equals_plain(dev, G):
    """K2 on rows of G genomes (dynamic shared memory per row)."""
    from libmems_tpu_torch.matchfind import find_mums_device
    from libmems_tpu_torch.sml import create_smls
    smls, seed = create_smls(_family(G, 40_000, 39), device="cpu")
    keys = torch.cat([s.keys for s in smls])
    seed_len = smls[0].seed_length
    rng = np.random.default_rng(G)
    # candidate rows: every genome at the ancestor's positions, some
    # genomes absent
    R = 400
    cnts = np.array([s.n_windows for s in smls])
    pos = rng.integers(0, cnts.min() - 1, R)
    lefts = torch.from_numpy(np.repeat(pos[:, None], G, 1).astype(np.int32))
    present = torch.from_numpy(rng.random((R, G)) < 0.8)
    present[:, 0] = True
    is_fwd = torch.ones((R, G), dtype=torch.bool)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(cnts)[:-1]])
                           .astype(np.int32))[None].expand(R, G).contiguous()
    cnt = torch.from_numpy(cnts.astype(np.int32))[None].expand(R, G)
    args = [keys, seed_len, 256, off, cnt.contiguous(), lefts, present,
            is_fwd, torch.full((R,), seed_len, dtype=torch.int32),
            mers.key_sentinel(seed)]
    ref = extend.extend_matches_plain(*args)
    got = extend.extend_matches(*[x.to(dev) if isinstance(x, torch.Tensor)
                                  else x for x in args])
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    assert int(ref[1].max()) > seed_len
    # and the whole pipeline: GPU equals CPU tensors
    gpu = create_smls(_family(G, 40_000, 39), seed, device=dev)[0]
    for a, b in zip(find_mums_device(gpu)[:3], find_mums_device(smls)[:3]):
        assert torch.equal(a.cpu(), b)


def test_three_genome_align_on_cuda_equals_cpu(dev):
    """A divergent trio with an unrelated block in each genome: the
    recursion's three-genome gap searches, 2+1-row node windows at full
    width and, for the block's 1536-column window, the banded kernels;
    GPU XMFA and anchors equal CPU tensors'."""
    from libmems_tpu_torch.ops import profile
    rng = np.random.default_rng(42)
    anc = rng.integers(0, 4, 40_000).astype(np.uint8)
    gs = []
    for i in range(3):
        g = generate._mutant(rng, anc, mutate=0.03, indel=0.002)
        block = rng.integers(0, 4, 1_100 + 150 * i).astype(np.uint8)
        g = np.concatenate([g[:20_000], block, g[20_000:]])
        gs.append(Genome(f"g{i}", generate._LUT[g]))
    cfg = dict(gapped_alignment=True, recursive=True)
    out = {}
    profile.banded_forward_ptrs.launches = 0
    for d in ("cpu", dev):
        ivs, mums_ = align(gs, AlignerConfig(device=d, **cfg))
        buf = io.StringIO()
        write_xmfa(buf, ivs)
        out[str(d)] = (buf.getvalue(), mums_)
    assert profile.banded_forward_ptrs.launches > 0
    (xmfa_cpu, mums_cpu), (xmfa_gpu, mums_gpu) = out["cpu"], out[str(dev)]
    assert xmfa_gpu == xmfa_cpu
    np.testing.assert_array_equal(mums_gpu.starts, mums_cpu.starts)


def _repeat_genome(n, rng_seed):
    """A genome with an N run, a poly-A run and a duplicated segment."""
    rng = np.random.default_rng(rng_seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[n // 2:n // 2 + 2_000] = codes[1_000:3_000]
    asc = generate._LUT[codes].copy()
    asc[5_000:5_300] = ord("N")
    asc[7_000:9_000] = ord("A")
    return Genome("r", asc)


@pytest.mark.parametrize("weight,circular", [(11, False), (17, False),
                                             (15, True)])
def test_seed_run_counts_kernel_equals_plain(dev, weight, circular):
    """K16 against its plain version: u32 and u64 key sentinels, a linear
    genome's tail positions, a circular genome."""
    from libmems_tpu_torch.ops import seedocc
    from libmems_tpu_torch.sml import SortedMerList
    g = _repeat_genome(60_000, weight)
    seed = seeds.get_seed(weight)
    sml = SortedMerList.create(g, seed, circular=circular, device="cpu")
    sent = mers.key_sentinel(seed)
    ref = seedocc.seed_run_counts_plain(sml.sorted_keys,
                                        sml.sorted_positions, sml.length,
                                        sent)
    got = seedocc.seed_run_counts(sml.sorted_keys.to(dev),
                                  sml.sorted_positions.to(dev), sml.length,
                                  sent)
    assert torch.equal(got.cpu(), ref)
    assert int(ref.max()) > 1_000 and int((ref == 1).sum()) > 1_000


@pytest.mark.parametrize("seed_len,n", [(21, 50_000), (21, 1), (0, 100),
                                        (37, 30)])
def test_seed_smooth_kernel_equals_plain(dev, seed_len, n):
    """K17 against its plain version, bit for bit: window sums above
    2^24, a window longer than the genome, the pass-through cases."""
    from libmems_tpu_torch.ops import seedocc
    rng = np.random.default_rng(n)
    count = rng.integers(1, 1 << 22, n).astype(np.int32)
    count[rng.random(n) < 0.5] = 1
    ref = seedocc.seed_smooth_plain(torch.from_numpy(count), seed_len)
    got = seedocc.seed_smooth(torch.from_numpy(count).to(dev), seed_len)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("case", list(seedocc_tables.TABLES))
def test_seed_run_counts_kernel_tables_equal_plain(dev, case):
    """K16's two launches against their plain versions on the sorted
    tables of tests/test_torch_seedocc_tables.py: one row, one tile and one
    tile plus a row, runs starting or ending exactly at a tile boundary, a
    run over more than 32 tiles, sentinel and content runs of 10^6 rows,
    one run, the tail of 1s, u32 and u64 sentinels, and 10 M rows.  The
    summaries, the count pass on the plain summaries and the wrapper (one
    launch counted) are each exact."""
    from libmems_tpu_torch.ops import seedocc
    keys, pos, length, sent = seedocc_tables.sorted_table(case)
    ref_edges = seedocc.seed_tile_edges_plain(keys)
    ref = seedocc.seed_run_counts_plain(keys, pos, length, sent)
    kd, pd = keys.to(dev), pos.to(dev)
    edges = torch.empty_like(ref_edges, device=dev)
    seedocc._tile_edges(kd, edges)
    assert torch.equal(edges.cpu(), ref_edges)
    count = torch.empty(length, dtype=torch.int32, device=dev)
    seedocc._count_pass(kd, pd, ref_edges.to(dev), length, sent, count)
    assert torch.equal(count.cpu(), ref)
    before = seedocc.seed_run_counts.launches
    got = seedocc.seed_run_counts(kd, pd, length, sent)
    assert seedocc.seed_run_counts.launches == before + 1
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("case", list(run_tables.TABLES))
def test_run_flag_launches_tables_equal_plain(dev, case):
    """K5's and K13's launches against their plain versions on the sorted
    tables of tests/test_torch_run_tables.py: the summaries (K13's with
    its big rows flagged), each flag pass on the plain summaries (with
    its look-back words zeroed) and each wrapper (one launch counted),
    every field exact."""
    from libmems_tpu_torch.ops import mums, pairwise
    content, src, keys, seg_off, tol, limit, sent, row_keys = \
        run_tables.sorted_table(case)
    pos_keys = keys
    if row_keys:
        pos_keys = torch.zeros(int(seg_off[-1]), dtype=torch.int64).scatter_(
            0, src, keys)
    n = content.shape[0]
    c, s, k, pk, so = (x.to(dev) for x in (content, src, keys, pos_keys,
                                           seg_off))

    def check(got, ref, what):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            if isinstance(r, torch.Tensor):
                assert torch.equal(g.cpu(), r), f"{what}: field {i}"
            else:
                assert g == r, f"{what}: field {i}"

    for span in (None, tol + 1):
        ref_words = pairwise.run_summaries_plain(content, src, seg_off, span)
        scratch = pairwise.run_scratch(n, dev)
        pairwise._summaries(c, s, so, span, scratch)
        assert torch.equal(pairwise.run_summary_words(scratch, n).cpu(),
                           ref_words), f"{case}: summaries, span {span}"
        scratch.zero_()
        pairwise.run_summary_words(scratch, n).copy_(ref_words)
        i32 = dict(dtype=torch.int32, device=dev)
        u8 = dict(dtype=torch.uint8, device=dev)
        if span is None:
            out = pairwise.RunFlags(torch.empty(n, dtype=torch.bool,
                                                device=dev),
                                    torch.empty(n, **i32),
                                    torch.empty(n, **i32),
                                    torch.empty(n, **i32),
                                    torch.empty(n, **u8))
            pairwise._flag_pass(c, s, pk, so, limit, sent, scratch, out)
            check(out, pairwise.run_flags_from_summaries_plain(
                content, src, pos_keys, seg_off, ref_words, limit, sent),
                f"{case}: K5's flag pass")
            before = pairwise.run_flags.launches
            got = pairwise.run_flags(c, s, pk, so, limit, sent)
            assert pairwise.run_flags.launches == before + 1
            check(got, pairwise.run_flags_plain(content, src, pos_keys,
                                                seg_off, limit, sent),
                  f"{case}: K5")
        else:
            out = mums.MumFlags(torch.empty(n, dtype=torch.bool, device=dev),
                                torch.empty(n, **i32), torch.empty(n, **u8),
                                0, torch.empty(n, **i32),
                                torch.empty(n, **i32), torch.empty(n, **u8),
                                tol)
            mums._flag_pass(c, s, k, so, tol, limit, sent, row_keys, scratch,
                            out)
            out = out._replace(n_rows=int(scratch[1]))
            check(out, mums.mum_flags_from_summaries_plain(
                content, src, keys, seg_off, ref_words, tol, limit, sent,
                row_keys), f"{case}: K13's flag pass")
            before = mums.mum_seed_flags.launches
            got = mums.mum_seed_flags(c, s, k, so, tol, limit, sent,
                                      row_keys)
            assert mums.mum_seed_flags.launches == before + 1
            check(got, mums.mum_seed_flags_plain(content, src, keys, seg_off,
                                                 tol, limit, sent, row_keys),
                  f"{case}: K13")


def test_run_flag_wrappers_trace_two_kernels(dev, tmp_path):
    """One call of each wrapper, traced by torch.profiler: two kernels
    (the summaries and the flag pass), no library cumsum or scan, and for
    K13 one copy to the host (n_rows), none for K5."""
    import json
    import re
    from libmems_tpu_torch.ops import mums, pairwise
    content, src, keys, seg_off, tol, limit, sent, _ = \
        run_tables.sorted_table("multi_tile_run")
    c, s, k, so = (x.to(dev) for x in (content, src, keys, seg_off))
    calls = {"K5": lambda: pairwise.run_flags(c, s, k, so, limit, sent),
             "K13": lambda: mums.mum_seed_flags(c, s, k, so, tol, limit,
                                                sent)}
    want = {"K5": ("run_summaries_kernel", "run_tile_flags_kernel"),
            "K13": ("run_summaries_kernel", "mum_tile_flags_kernel")}
    for label, call in calls.items():
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        path = tmp_path / f"{label}.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        kernels = [re.search(r"(\w+)(?:<[^()]*>)?\(", e["name"]).group(1)
                   for e in events if e["cat"] == "kernel"]
        assert kernels == list(want[label]), (label, kernels)
        assert not any(re.search(r"(?i)cumsum|scan", e["name"])
                       for e in events), label
        d2h = [e for e in events if e["cat"] == "gpu_memcpy"
               and "DtoH" in e["name"]]
        assert len(d2h) == (1 if label == "K13" else 0), (label, d2h)


def test_run_flag_wrappers_empty_table(dev):
    """No row: empty flags, no candidate row, no launch counted."""
    from libmems_tpu_torch.ops import mums, pairwise
    e = torch.zeros(0, dtype=torch.int64, device=dev)
    so = torch.tensor([0, 0, 0], device=dev)
    before = (pairwise.run_flags.launches, mums.mum_seed_flags.launches)
    got = pairwise.run_flags(e, e, e, so, 1000, run_tables.SENT)
    assert all(x.numel() == 0 for x in got)
    got = mums.mum_seed_flags(e, e, e, so, 0, 1000, run_tables.SENT)
    assert got.n_rows == 0 and all(x.numel() == 0 for x in got
                                   if isinstance(x, torch.Tensor))
    assert (pairwise.run_flags.launches,
            mums.mum_seed_flags.launches) == before


def test_seed_run_counts_kernel_without_windows(dev):
    """No window: no tile summary, and the count pass writes 1 at every
    position."""
    from libmems_tpu_torch.ops import seedocc
    keys = torch.zeros(0, dtype=torch.int64, device=dev)
    pos = torch.zeros(0, dtype=torch.int32, device=dev)
    got = seedocc.seed_run_counts(keys, pos, 5_000, -1)
    assert torch.equal(got.cpu(), torch.ones(5_000, dtype=torch.int32))


@pytest.mark.parametrize("seed_len,n,offset", [
    (23, 1_000_003, 0), (40, 50_001, 0), (23, 50_000, 1), (4_096, 100_000, 0),
    (4_097, 100_002, 0), (9_000, 100_000, 3), (70_000, 30_000, 0),
    (30_000, 30_001, 0), (1, 9_999, 0), (21, 1, 0), (0, 100, 0)])
def test_seed_smooth_kernel_windows_equal_plain(dev, seed_len, n, offset):
    """K17 against its plain version, bit for bit: windows longer than a
    thread's 16 positions, than a tile of 4,096 and than what a block
    stages (so their far part comes from device memory), a window longer
    than the genome, lengths that are no multiple of 4, counts at an
    offset of 1 or 3 (unaligned: no 16-byte loads), window sums above
    2^24, and the pass-through cases."""
    from libmems_tpu_torch.ops import seedocc
    rng = np.random.default_rng(seed_len + n)
    count = rng.integers(1, 1 << 22, n).astype(np.int32)
    count[rng.random(n) < 0.5] = 1
    ref = seedocc.seed_smooth_plain(torch.from_numpy(count), seed_len)
    buf = torch.zeros(n + offset, dtype=torch.int32, device=dev)
    buf[offset:] = torch.from_numpy(count).to(dev)
    got = seedocc.seed_smooth(buf[offset:], seed_len)
    assert torch.equal(got.cpu(), ref)


def _pair_keys(weight, n, rng_seed):
    from libmems_tpu_torch.sml import create_smls
    gs = _family(2, n, rng_seed)
    smls, seed = create_smls(gs, seeds.get_seed(weight), device="cpu")
    pb = max(max(s.n_windows for s in smls).bit_length(), 8)
    return smls, seed, pb


@pytest.mark.parametrize("weight,n", [(15, 60_000), (25, 1_500)])
def test_pair_cluster_words_kernel_equals_plain(dev, weight, n):
    """K18 against its plain version; at weight 25 and 1.5 kbp the seed
    words use bit 63."""
    from libmems_tpu_torch.ops import pair
    smls, seed, pb = _pair_keys(weight, n, 43)
    sent = mers.sentinel_content(seed)
    ref, ref_n = pair.pair_cluster_words_plain(smls[0].keys, smls[1].keys,
                                               pb, sent)
    got, got_n = pair.pair_cluster_words(smls[0].keys.to(dev),
                                         smls[1].keys.to(dev), pb, sent)
    assert got_n == ref_n > 2
    assert torch.equal(got.cpu(), ref)


def _run_keys(runs, rng):
    """keys_a, keys_b (int64, position order) whose sorted seed words are
    the content runs `runs`: a run is a tuple of genome ids (content: its
    index + 1) or a pair (content, tuple of genome ids).  Positions are
    shuffled in each genome, strands drawn at random."""
    ka, kb = [], []
    for c, run in enumerate(runs):
        content, gids = run if isinstance(run[-1], tuple) else (c + 1, run)
        for g in gids:
            (ka if g == 0 else kb).append((content << 1)
                                          | int(rng.integers(0, 2)))
    ka, kb = np.array(ka, np.int64), np.array(kb, np.int64)
    return (torch.from_numpy(ka[rng.permutation(len(ka))]),
            torch.from_numpy(kb[rng.permutation(len(kb))]))


EDGE_SENT = 0x40000000   # the sentinel content of _edge_runs' table


def _edge_runs():
    """Seven candidate runs of 2 (genome 0 then 1) among singletons and
    genome-1 runs of 2: at three tile edges e, one on rows e - 2 and
    e - 1 (a tile's last two rows) and one on e + 4095 and e + 4096
    (across the next edge), then a run of 3 across the edge after (no
    candidate); a pair of the sentinel content (no candidate); a pair as
    the table's last two rows."""
    runs, rows = [], 0

    def fill(to):
        nonlocal rows
        while rows < to:
            runs.append((rows % 2,) if rows + 2 > to or rows % 5 else (1, 1))
            rows += len(runs[-1])

    def put(run):
        nonlocal rows
        runs.append(run)
        rows += len(run)
    for e in (4096, 4 * 4096, 7 * 4096):
        fill(e - 2)
        put((0, 1))
        fill(e + 4095)
        put((0, 1))
        fill(e + 2 * 4096 - 1)
        put((0, 0, 1))
    fill(rows + 50)
    runs += [(EDGE_SENT, (0, 1)), (0x7FFFFFFF, (0, 1))]
    return runs


@pytest.mark.parametrize("case", ["tile_edges", "no_candidate",
                                  "every_run_a_pair", "10M_rows"])
def test_pair_cluster_words_kernel_cases_equal_plain(dev, case):
    """K18 against its plain version on built tables: candidate runs at
    and across tile edges, none at all, every run a pair, and 10 M rows
    of random contents; the words kept are the candidates', in table
    order."""
    from libmems_tpu_torch.ops import pair
    rng = np.random.default_rng(46)
    sent = EDGE_SENT
    if case == "tile_edges":
        ka, kb = _run_keys(_edge_runs(), rng)
    elif case == "no_candidate":
        ka, kb = _run_keys([(g,) if c % 3 else (g, g)
                            for c, g in enumerate([0, 1] * 6_000)], rng)
    elif case == "every_run_a_pair":
        ka, kb = _run_keys([(0, 1)] * 6_000, rng)
    else:
        a = rng.integers(1, 1 << 23, size=5_000_000)
        b = np.where(rng.random(5_000_000) < 0.5,
                     a[rng.permutation(5_000_000)],
                     rng.integers(1, 1 << 23, size=5_000_000))
        ka = torch.from_numpy((a << 1) | rng.integers(0, 2, a.shape[0]))
        kb = torch.from_numpy((b << 1) | rng.integers(0, 2, b.shape[0]))
    pb = max(max(ka.shape[0], kb.shape[0]).bit_length(), 8)
    ka, kb = ka.to(dev), kb.to(dev)
    ref, ref_n = pair.pair_cluster_words_plain(ka, kb, pb, sent)
    got, got_n = pair.pair_cluster_words(ka, kb, pb, sent)
    assert got_n == ref_n == got.numel()
    assert torch.equal(got, ref)
    want = {"tile_edges": 7, "no_candidate": 0,
            "every_run_a_pair": 6_000}.get(case)
    assert ref_n == want if want is not None else ref_n > 100_000


def _k18_trace():
    """K18's trace on a pair's keys (run by _traced_in_process)."""
    from libmems_tpu_torch.ops import pair
    dev = torch.device("cuda", 0)
    smls, seed, pb = _pair_keys(15, 60_000, 43)
    args = (smls[0].keys.to(dev), smls[1].keys.to(dev), pb,
            mers.sentinel_content(seed))
    return _trace(lambda: pair.pair_cluster_words(*args))


def test_pair_cluster_words_trace_two_kernels(dev):
    """One call of K18's wrapper traced by torch.profiler: the pack and
    the flag pass, the library sort between them (no other kernel), and
    one copy to the host (the candidates' count)."""
    kernels, d2h = _traced_in_process("_k18_trace")
    ours = [k for k, full in kernels
            if "at::" not in full and "cub::" not in full]
    assert ours == ["pair_pack_kernel", "pair_cluster_words_kernel"], kernels
    assert d2h == 1


def test_pair_reps_kernel_equals_plain(dev):
    """K19 against its plain version, with fewer and with more extension
    rows than representatives."""
    from libmems_tpu_torch.ops import pair, pairwise
    smls, seed, pb = _pair_keys(15, 60_000, 44)
    cw, _ = pair.pair_cluster_words_plain(smls[0].keys, smls[1].keys, pb,
                                          mers.sentinel_content(seed))
    cw = pairwise.usort(cw)
    seed_len = smls[0].seed_length
    for ec in (16, 1 << 14):
        ref = pair.pair_reps_plain(cw, ec, pb, seed_len)
        got = pair.pair_reps(cw.to(dev), ec, pb, seed_len)
        assert got.n_reps == ref.n_reps > 16
        for r, g in zip(ref[:-1], got[:-1]):
            assert torch.equal(g.cpu(), r)


def test_pairwise_host_path_on_cuda_equals_fused(dev):
    """_find_pairwise_mums_host with K5 and K2 on the card gives the
    fused seeder's matches."""
    from libmems_tpu_torch import find_pairwise_mums
    from libmems_tpu_torch.matchfind import _find_pairwise_mums_host
    from libmems_tpu_torch.sml import create_smls
    smls, _ = create_smls(_family(5, 50_000, 45), device=dev)
    host = _find_pairwise_mums_host(smls)
    fused = find_pairwise_mums(smls)
    assert len(fused) > 50
    np.testing.assert_array_equal(host.starts, fused.starts)
    np.testing.assert_array_equal(host.lengths, fused.lengths)


def _copies_rows(G, R=6, unit_len=200, spacer=30, rng_seed=0):
    """K2's arguments for R rows of G slots: one genome holding G copies
    of an element (every seventh inverted, every fifth with a
    substitution near its end) between random spacers; row r places
    every slot at offset 20 + 17 r of its copy; some slots absent and the
    last row empty."""
    rng = np.random.default_rng(rng_seed)
    seed = seeds.get_seed(11)
    seed_len = seeds.seed_length(seed)
    unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    parts, starts, pos = [], [], 0
    for g in range(G):
        u = unit.copy()
        if g % 5 == 0:
            k = unit_len - 40 + g % 30
            u[k] = (u[k] + 1) % 4
        fwd = g % 7 != 0
        parts += [rng.integers(0, 4, spacer).astype(np.uint8),
                  u if fwd else 3 - u[::-1]]
        starts.append((pos + spacer, fwd))
        pos += spacer + unit_len
    keys = mers.canonical_seed_keys_plain(
        torch.from_numpy(np.concatenate(parts)), seed)
    lefts = np.zeros((R, G), np.int32)
    is_fwd = np.ones((R, G), bool)
    for r in range(R):
        off = 20 + 17 * r
        for g, (p0, fwd) in enumerate(starts):
            lefts[r, g] = p0 + off if fwd else p0 + unit_len - off - seed_len
            is_fwd[r, g] = fwd
    present = np.ones((R, G), bool)
    present[2, :3] = False
    present[R - 1] = False
    return [keys, seed_len, 128, torch.zeros((R, G), dtype=torch.int32),
            torch.full((R, G), keys.shape[0], dtype=torch.int32),
            torch.from_numpy(lefts), torch.from_numpy(present),
            torch.from_numpy(is_fwd),
            torch.full((R,), seed_len, dtype=torch.int32),
            mers.key_sentinel(seed)]


@pytest.mark.parametrize("G,scratch", [(63, False), (64, False),
                                       (64, True), (1000, False),
                                       (1000, True), (3000, False)])
def test_extend_kernel_wide_rows_equal_plain(dev, G, scratch):
    """K2 above 62 slots a row: the row state in shared memory (above
    48 KB at G = 3000) or, when `scratch` asks for it, in global
    scratch."""
    args = _copies_rows(G)
    ref = extend.extend_matches_plain(*args)
    got = extend.extend_matches(*[x.to(dev) if isinstance(x, torch.Tensor)
                                  else x for x in args], scratch=scratch)
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    assert int(ref[1][0]) > args[1]


def test_find_repeats_and_find_mums_wide_on_cuda_equal_cpu(dev):
    """find_repeats on a genome with 1,000 copies of an element (rows of
    1,000 slots) and find_mums on 64 genomes (the device pipeline, K2 rows
    of 64 slots): the GPU gives the CPU tensors' result."""
    from libmems_tpu_torch import find_mums
    from libmems_tpu_torch.repeats import find_repeats
    rng = np.random.default_rng(47)
    elem = rng.integers(0, 4, 120).astype(np.uint8)
    parts = []
    for k in range(1000):
        e = elem.copy()
        if k % 3 == 0:
            e[80 + k % 30] = (e[80 + k % 30] + 1) % 4
        parts += [rng.integers(0, 4, 40).astype(np.uint8),
                  e if k % 5 else 3 - e[::-1]]
    text = "".join("ACGT"[x] for x in np.concatenate(parts))
    seed = seeds.get_seed(13)
    got = find_repeats(text, seed=seed, device=dev)
    ref = find_repeats(text, seed=seed, device="cpu")
    assert got.starts.shape[1] == 1000
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    base = rng.integers(0, 4, 3_000).astype(np.uint8)
    gs = []
    for g in range(64):
        s = base.copy()
        m = rng.random(len(s)) < 0.01
        s[m] = rng.integers(0, 4, int(m.sum()))
        gs.append(Genome(f"m{g}", generate._LUT[s].copy()))
    got = find_mums(gs, device=dev)
    ref = find_mums(gs, device="cpu")
    assert len(ref) > 0 and (ref.multiplicity() == 64).any()
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


def _gotoh_batch(B, M, N, rng_seed):
    """A padded batch of related pairs (full, partial and empty rows)."""
    rng = np.random.default_rng(rng_seed)
    a = np.zeros((B, M), np.uint8)
    b = np.zeros((B, N), np.uint8)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    for r in range(B):
        la = M if r == 0 else int(rng.integers(0, M + 1))
        lb = N if r == 0 else int(rng.integers(0, N + 1))
        x = rng.integers(0, 4, max(la, lb)).astype(np.uint8)
        y = x.copy()
        sub = rng.random(len(y)) < 0.03
        y[sub] = rng.integers(0, 4, int(sub.sum()))
        if len(y) > 40:
            y = np.concatenate([y[:20], y[27:]])
        a[r, :la] = x[:la]
        b[r, :lb] = np.resize(y, lb) if lb else y[:0]
        a_len[r], b_len[r] = la, lb
    return [torch.from_numpy(x) for x in (a, b, a_len, b_len)]


@pytest.mark.parametrize("B,M,N", [(3, 128, 130), (2, 256, 2047),
                                   (2, 128, 1500)])
def test_gotoh_kernels_equal_plain(dev, B, M, N):
    """K22 (score, carries; score only) and K23 (from the first row and
    from a carry, unpacked and packed) against their plain versions:
    exact, in the launchers' picks."""
    from libmems_tpu_torch.ops import gapped as gp
    K = 128
    t = _gotoh_batch(B, M, N, M + N)
    td = [x.to(dev) for x in t]
    ref = gp.gotoh_forward_plain(*t, gp.GAP_OPEN, gp.GAP_EXTEND, K)
    got = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    s_only = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K,
                              carries=False)[0]
    assert torch.equal(s_only.cpu(), ref[0])
    for packed in (False, True):
        r0 = gp.gotoh_block_ptrs_plain(None, None, t[0], t[1], gp.GAP_OPEN,
                                       gp.GAP_EXTEND, packed)
        g0 = gp.gotoh_block_ptrs(None, None, td[0], td[1], packed=packed)
        assert torch.equal(g0.cpu(), r0)
        bi = M // K - 1
        blk = t[0][:, bi * K:(bi + 1) * K].contiguous()
        r1 = gp.gotoh_block_ptrs_plain(ref[1][bi], ref[2][bi], blk, t[1],
                                       gp.GAP_OPEN, gp.GAP_EXTEND, packed)
        g1 = gp.gotoh_block_ptrs(got[1][bi], got[2][bi], blk.to(dev), td[1],
                                 packed=packed)
        assert torch.equal(g1.cpu(), r1)


def _gotoh_edge_batch(B, M, N, rng_seed):
    """_gotoh_batch with an empty a in pair 1 and an empty b in pair 2."""
    t = _gotoh_batch(B, M, N, rng_seed)
    if B > 2:
        t[0][1] = 0
        t[2][1] = 0
        t[1][2] = 0
        t[3][2] = 0
    return t


@pytest.mark.parametrize("B,M,N,K,geometry", [
    (3, 128, 130, 128, None),        # the pick
    (3, 128, 70, 128, (0, 1)),       # N + 1 inside one strip
    (3, 256, 300, 128, (5, 1)),      # one strip a block, two blocks
    (2, 256, 2047, 128, (1, 4)),     # four strips of one block
    (4, 128, 1500, 128, (5, 2)),     # ten strips over five blocks
    (2, 256, 2047, 128, (7, 8)),     # 64 strips over eight blocks
    (3, 128, 900, 128, (3, 1)),
    (3, 128, 900, 128, (4, 2)),
    (3, 384, 900, 128, (6, 8)),
    (8, 128, 16_384, 128, None),     # phase 9's width, the pick
    (8, 256, 16_384, 128, (2, 3)),   # 40 strips over 14 blocks
])
def test_gotoh_forward_strips_equal_plain(dev, B, M, N, K, geometry):
    """K22's strips (score and carries; score only) against the plain
    version, exact: N + 1 inside one strip, across the strips of one
    block and across several blocks, up to 16,385 columns and 8 pairs,
    with an empty a and an empty b; M = K has one carry."""
    from libmems_tpu_torch.ops import gapped as gp
    t = _gotoh_edge_batch(B, M, N, B + M + N)
    td = [x.to(dev) for x in t]
    ref = gp.gotoh_forward_plain(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K)
    n = gp.gotoh_forward.launches
    got = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K,
                           geometry=geometry)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    s_only = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K,
                              carries=False, geometry=geometry)[0]
    assert torch.equal(s_only, ref[0])
    assert gp.gotoh_forward.launches == n + 2
    geo = gp.gotoh_geometry(B, M, N, geometry)
    if geometry is not None:
        assert geo["geometry"] == geometry
    assert geo["blocks_per_sm"] > 0


@pytest.mark.parametrize("rows,geometry", [(100, (5, 2)), (128, (0, 1)),
                                           (1, (3, 1))])
def test_gotoh_forward_bands_equal_plain(dev, monkeypatch, rows, geometry):
    """K22 in bands of `rows` rows, each launch starting from the (H, F)
    row the one before it wrote, as gotoh_band_rows cuts a launch whose
    hand-off columns pass the cap (lowered here to `rows` rows): scores
    and carries (score only too) equal the plain version's, with a_len at
    a band's edge, 0 and M, and an empty b; one launch a band."""
    from libmems_tpu_torch.ops import gapped as gp
    from libmems_tpu_torch.ops import profile
    B, M, N, K = 4, 384, 900, 128
    t = _gotoh_edge_batch(B, M, N, 77)
    t[2][3] = 200
    td = [x.to(dev) for x in t]
    ref = gp.gotoh_forward_plain(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K)
    C = gp.gotoh_geometry(B, M, N, geometry)["blocks"]
    monkeypatch.setattr(profile, "SPAN_EDGE_SHARE",
                        profile.PTR_BUDGET // (16 * B * (C - 1) * rows))
    assert gp.gotoh_geometry(B, M, N, geometry)["rows"] == rows
    n = gp.gotoh_forward.launches
    got = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K,
                           geometry=geometry)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    s_only = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K,
                              carries=False, geometry=geometry)[0]
    assert torch.equal(s_only, ref[0])
    assert gp.gotoh_forward.launches == n + 2 * -(-M // rows)


def _gotoh_geometries(N, ptr):
    """Every span geometry (g, W) K22 (K23 with `ptr`) fits on the card
    with no more strips a block than an N-column bucket has."""
    from libmems_tpu_torch.ops import profile
    fits = profile.span_fits("lm_gotoh_fits", int(ptr))[1]
    return [(g, W) for (g, W), n in sorted(fits.items())
            if n > 0 and W <= profile.span_plan(N, profile.SPAN_K[g], 1)[0]]


@pytest.mark.parametrize("N", [130, 1500, 2047])
def test_gotoh_block_ptrs_geometries_equal_plain(dev, N):
    """K23 in every geometry that fits the card against its plain
    versions, exact: the batch of G row blocks (all four from the DP's
    top, two from a checkpoint, the last alone), the single block from a
    carry, and the full route from the first row, packed and unpacked,
    with an empty a and an empty b; one launch a call."""
    from libmems_tpu_torch.ops import gapped as gp
    B, M, K = 3, 512, 128
    nb = M // K
    t = _gotoh_edge_batch(B, M, N, N + 3)
    td = [x.to(dev) for x in t]
    _, ck_h, ck_f = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K)
    refs = {pk: (gp.gotoh_block_ptrs_batch_plain(ck_h, ck_f, td[0], td[1],
                                                 0, nb, packed=pk),
                 gp.gotoh_block_ptrs_plain(None, None, td[0], td[1],
                                           gp.GAP_OPEN, gp.GAP_EXTEND, pk))
            for pk in (False, True)}
    geos = _gotoh_geometries(N, True)
    assert geos
    for geo in geos:
        for pk, (blocks, full) in refs.items():
            n = gp.gotoh_block_ptrs.launches
            for first, G in ((0, nb), (1, 2), (nb - 1, 1)):
                got = gp.gotoh_block_ptrs_batch(ck_h, ck_f, td[0], td[1],
                                                first, G, packed=pk,
                                                geometry=geo)
                assert torch.equal(got, blocks[first:first + G]), \
                    (geo, pk, first, G)
            one = gp.gotoh_block_ptrs(ck_h[2], ck_f[2],
                                      td[0][:, 2 * K:3 * K].contiguous(),
                                      td[1], packed=pk, geometry=geo)
            assert torch.equal(one, blocks[2]), (geo, pk)
            got = gp.gotoh_block_ptrs(None, None, td[0], td[1], packed=pk,
                                      geometry=geo)
            assert torch.equal(got, full), (geo, pk)
            assert gp.gotoh_block_ptrs.launches == n + 5


@pytest.mark.parametrize("rows,geometry", [(100, (5, 2)), (1, (3, 1)),
                                           (128, (0, 1))])
def test_gotoh_block_ptrs_bands_equal_plain(dev, monkeypatch, rows,
                                            geometry):
    """K23 in bands of `rows` rows, each launch starting from the (H, F)
    rows the one before it wrote, as gotoh_band_rows cuts a launch whose
    hand-off columns pass the cap (lowered here): the full route of 384
    rows and a batch of three 128-row blocks equal their plain versions,
    one launch a band."""
    from libmems_tpu_torch.ops import gapped as gp
    from libmems_tpu_torch.ops import profile
    B, M, N, K = 4, 384, 900, 128
    t = _gotoh_edge_batch(B, M, N, 78)
    td = [x.to(dev) for x in t]
    _, ck_h, ck_f = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, K)
    full = gp.gotoh_block_ptrs_plain(None, None, td[0], td[1], gp.GAP_OPEN,
                                     gp.GAP_EXTEND)
    blocks = gp.gotoh_block_ptrs_batch_plain(ck_h, ck_f, td[0], td[1], 0,
                                             M // K)
    for n_inst, R, call, want in (
            (B, M, lambda: gp.gotoh_block_ptrs(None, None, td[0], td[1],
                                               geometry=geometry), full),
            (3 * B, K, lambda: gp.gotoh_block_ptrs_batch(
                ck_h, ck_f, td[0], td[1], 0, 3, geometry=geometry),
             blocks)):
        C = gp.gotoh_geometry(n_inst, R, N, geometry, ptr=True)["blocks"]
        monkeypatch.setattr(profile, "SPAN_EDGE_SHARE", profile.PTR_BUDGET
                            // (24 * n_inst * (C - 1) * rows))
        assert gp.gotoh_geometry(n_inst, R, N, geometry,
                                 ptr=True)["rows"] == min(rows, R)
        n = gp.gotoh_block_ptrs.launches
        assert torch.equal(call(), want)
        assert gp.gotoh_block_ptrs.launches == n + -(-R // rows)


def test_gotoh_forward_one_row_block(dev):
    """M = K: the strips store one carry (row 0) and the score."""
    from libmems_tpu_torch.ops import gapped as gp
    t = _gotoh_edge_batch(3, 128, 700, 5)
    td = [x.to(dev) for x in t]
    ref = gp.gotoh_forward_plain(*td, gp.GAP_OPEN, gp.GAP_EXTEND, 128)
    got = gp.gotoh_forward(*td, gp.GAP_OPEN, gp.GAP_EXTEND, 128)
    assert got[1].shape[0] == 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_align_pairs_on_cuda_equals_cpu(dev, monkeypatch):
    """align_pairs and align_score on the card equal the CPU tensors on
    both routes (K23 + K4; K22 + packed K23 + the host walk)."""
    from libmems_tpu_torch.ops import gapped as gp
    rng = np.random.default_rng(48)
    pairs = []
    for n in (5, 30, 60, 200, 700):
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        sub = rng.random(n) < 0.05
        b[sub] = rng.integers(0, 4, int(sub.sum()))
        pairs += [(a, np.concatenate([b[:n // 3], b[n // 3 + 4:]])),
                  (a, rng.integers(0, 4, n // 2 + 1).astype(np.uint8))]
    for budget in (gp.DEVICE_TB_BUDGET, 0):
        monkeypatch.setattr(gp, "DEVICE_TB_BUDGET", budget)
        got = gp.align_pairs(pairs, device=dev)
        ref = gp.align_pairs(pairs, device="cpu")
        for (ga, gb), (ra, rb) in zip(got, ref):
            np.testing.assert_array_equal(ga, ra)
            np.testing.assert_array_equal(gb, rb)
    for a, b in pairs[:4]:
        assert gp.align_score(a, b, device=dev) == \
            gp.align_score(a, b, device="cpu")


@pytest.mark.parametrize("T", [64, 4096, (1 << 14) + 3])
def test_hmm_decode_kernels_equal_plain(dev, T):
    """K20 (exact) and K21 (1e-12 relative) against their plain versions
    on ragged batches; viterbi_homologous and baum_welch on the card
    against CPU tensors."""
    from libmems_tpu_torch.ops import hmm
    rng = np.random.default_rng(T + 1)
    B = 5
    obs = rng.integers(0, 8, (B, T)).astype(np.uint8)
    blocks = np.repeat(rng.random((B, T // 64 + 1)) < 0.5, 64, 1)[:, :T]
    obs = np.where(blocks, rng.integers(0, 2, (B, T)), obs).astype(np.uint8)
    lens = np.array([T, max(T - 7, 1), max(T // 3, 1), 1, 0], np.int32)
    mats = hmm.log_matrices(hmm.adapted_hoxd_params(0.45), "cpu")
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    md = tuple(m.to(dev) for m in mats)
    ref = hmm.viterbi_path_plain(o, n, mats)
    got = hmm.viterbi_path(o.to(dev), n.to(dev), md)
    assert torch.equal(got.cpu(), ref)
    ref = hmm.bw_counts_plain(o, n, mats)
    got = hmm.bw_counts(o.to(dev), n.to(dev), md).cpu()
    rel = (got - ref).abs() / ref.abs().clamp(min=1e-300)
    assert float(rel.max()) <= 1e-12
    assert torch.equal(got[4], torch.zeros(hmm.BW_COUNTS, dtype=torch.float64))
    seqs = [obs[r, :lens[r]] for r in range(B)]
    for g, r in zip(hmm.viterbi_homologous(seqs, device=dev),
                    hmm.viterbi_homologous(seqs, device="cpu")):
        np.testing.assert_array_equal(g, r)
    gp_, gl = hmm.baum_welch(seqs, iterations=2, device=dev)
    rp, rl = hmm.baum_welch(seqs, iterations=2, device="cpu")
    np.testing.assert_allclose(gl, rl, rtol=1e-12, atol=0)
    np.testing.assert_allclose(gp_.emit_homologous, rp.emit_homologous,
                               rtol=1e-12, atol=0)


def test_viterbi_ragged_kernel_equals_plain(dev):
    """K20 over pack_ragged's layout against its plain version, exact:
    rows of lengths 1, 15-17, 63-65 and longer, a row of a repeating
    four-symbol unit, identity and gap-extend runs, a mixed row, and one
    row of 2^17 + 5 columns; under GC-adapted parameters and under
    parameters whose candidates all tie (the first argmax decides).  One
    launch for the batch; viterbi_path on the same rows padded (T = 2^18,
    and T = 1,000 for the short ones: a width the kernel's stride rounds
    up) equals the plain version; viterbi_homologous on the card equals
    CPU tensors."""
    from libmems_tpu_torch.ops import hmm
    rng = np.random.default_rng(20)
    p = hmm.adapted_hoxd_params(0.45)
    seqs = [rng.integers(0, 8, n).astype(np.uint8)
            for n in (1, 15, 16, 17, 63, 64, 65, 200, 1000)]
    seqs.append(np.tile(np.array([0, 6, 7, 2], np.uint8), 50))
    seqs += [np.zeros(200, np.uint8), np.full(200, 7, np.uint8)]
    seqs.append(np.concatenate([rng.integers(0, 2, 150),
                                rng.choice(8, 120, p=p.emit_unrelated),
                                rng.integers(0, 2, 90)]).astype(np.uint8))
    n_long = (1 << 17) + 5
    blocks = np.repeat(rng.random(n_long // 512 + 1) < 0.5, 512)[:n_long]
    seqs.append(np.where(blocks, rng.integers(0, 2, n_long),
                         rng.integers(0, 8, n_long)).astype(np.uint8))
    tied = hmm.HmmParams(0.5, 0.25, 0.25, 0.5, 0.5, np.full(8, 1 / 8),
                         np.full(8, 1 / 8))
    batch, = hmm.pack_ragged(seqs, list(range(len(seqs))))
    inside = torch.zeros(batch.total, dtype=torch.bool)
    for r, o in enumerate(batch.offsets.tolist()):
        inside[o:o + int(batch.lengths[r])] = True
    for params in (p, tied):
        mats = hmm.log_matrices(params, "cpu")
        md = hmm.log_matrices(params, dev)
        ref = hmm.viterbi_ragged(*batch.tensors("cpu"), mats)
        n = hmm.viterbi_ragged.launches
        got = hmm.viterbi_ragged(*batch.tensors(dev), md)
        assert hmm.viterbi_ragged.launches == n + 1
        assert torch.equal(got.cpu(), ref)
        assert not ref[~inside].any()
        assert bool(ref[inside].all()) == (params is tied)
    mats = hmm.log_matrices(p, "cpu")
    md = hmm.log_matrices(p, dev)
    for T, rows in ((1 << 18, [len(seqs) - 1, 0, 5]),
                    (1000, list(range(len(seqs) - 1)))):
        obs = np.zeros((len(rows), T), np.uint8)
        lens = np.array([len(seqs[i]) for i in rows], np.int32)
        for r, i in enumerate(rows):
            obs[r, :lens[r]] = seqs[i]
        o, ln = torch.from_numpy(obs), torch.from_numpy(lens)
        want = hmm.viterbi_path(o, ln, mats)
        assert torch.equal(hmm.viterbi_path(o.to(dev), ln.to(dev),
                                            md).cpu(), want)
    for g, r in zip(hmm.viterbi_homologous(seqs, p, device=dev),
                    hmm.viterbi_homologous(seqs, p, device="cpu")):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("n", [(1 << 17) + 5, (1 << 20) + 3])
def test_hmm_scan_kernels_equal_plain(dev, n):
    """K8 and K21 on the chunked route (padded widths from FB_SCAN_MIN_T
    on) against their plain versions on a ragged batch: the longest row,
    rows ending on a chunk boundary and one past it, length 1 and 0 (K21
    only); posteriors within 1e-12 with calls equal, counts within 1e-12
    relative; predict_homologous on the card equals CPU tensors."""
    from libmems_tpu_torch.ops import hmm
    K = hmm.FB_SCAN_COLS
    T = 1 << (n - 1).bit_length()
    assert T >= hmm.FB_SCAN_MIN_T
    rng = np.random.default_rng(n)
    lens = np.array([n, n - 999, 37 * K, 37 * K + 1, 1, 3 * K + 77],
                    np.int32)
    obs = rng.integers(0, 8, (len(lens), T)).astype(np.uint8)
    blocks = np.repeat(rng.random((len(lens), T // 4096)) < 0.5, 4096, 1)
    obs = np.where(blocks, rng.integers(0, 2, obs.shape), obs)
    obs = obs.astype(np.uint8)
    mats = hmm.log_matrices(hmm.adapted_hoxd_params(0.45), "cpu")
    md = tuple(m.to(dev) for m in mats)
    o, m = torch.from_numpy(obs), torch.from_numpy(lens)
    ref_p, ref_c = hmm.fb_posterior_plain(o, m, mats, 0.9)
    got_p, got_c = hmm.fb_posterior(o.to(dev), m.to(dev), md, 0.9)
    assert float((got_p.cpu() - ref_p).abs().max()) <= 1e-12
    assert torch.equal(got_c.cpu(), ref_c)
    assert 0.1 < float(ref_c[0, :n].double().mean()) < 0.9
    m0 = torch.from_numpy(np.append(lens[:-1], 0).astype(np.int32))
    ref = hmm.bw_counts_plain(o, m0, mats)
    got = hmm.bw_counts(o.to(dev), m0.to(dev), md).cpu()
    rel = (got - ref).abs() / ref.abs().clamp(min=1e-300)
    assert float(torch.where(got == ref, 0.0, rel).max()) <= 1e-12
    assert torch.equal(got[-1], torch.zeros(hmm.BW_COUNTS,
                                            dtype=torch.float64))
    if n < (1 << 18):
        # the sequential kernel, forced at this width, against its plain
        # version on the longest row and the one past a chunk boundary
        two = (o[[0, 3]].contiguous(), m[[0, 3]].contiguous())
        sp, sc = hmm.fb_sequential_plain(*two, mats, 0.9)
        kp, kc = hmm.fb_posterior(two[0].to(dev), two[1].to(dev), md, 0.9,
                                  sequential=True)
        assert float((kp.cpu() - sp).abs().max()) <= 1e-12
        assert torch.equal(kc.cpu(), sc)
        seqs = [obs[r, :lens[r]] for r in range(len(lens))]
        for g, r in zip(hmm.predict_homologous(seqs, device=dev),
                        hmm.predict_homologous(seqs, device="cpu")):
            np.testing.assert_array_equal(g, r)


def _fractional(rng, B, M, N, n_p, n_q):
    """Profiles of n_p and n_q aligned rows with gaps (one row: one-hot)
    whose lengths leave padded rows and columns."""
    p = np.zeros((B, M, 5), np.float32)
    q = np.zeros((B, N, 5), np.float32)
    pl = rng.integers(M * 3 // 4, M - 7, B).astype(np.int32)
    ql = rng.integers(N * 3 // 4, N - 3, B).astype(np.int32)
    for r in range(B):
        for arr, n, k in ((p, pl[r], n_p), (q, ql[r], n_q)):
            rows = np.repeat(rng.integers(0, 4, (1, n)), k, 0).astype(
                np.uint8)
            if k > 1:
                rows[rng.random((k, n)) < 0.1] = 4
                mut = rng.random((k, n)) < 0.05
                rows[mut] = rng.integers(0, 4, int(mut.sum()))
                rows[:, (rows == 4).all(axis=0)] = 0
            arr[r, :n] = profile.rows_to_profile(rows)
    return [torch.from_numpy(x) for x in (p, q, pl, ql)]


@pytest.mark.parametrize("n_p,n_q,M,N", [
    (1, 1, 256, 700), (3, 2, 384, 1000), (3, 2, 256, 4_352),
    (4, 5, 256, 12_160)])
def test_ckpt_kernels_equal_plain(dev, n_p, n_q, M, N):
    """K24 (score, ck_h, ck_f) and K25 (every block's packed pointer
    bytes, one block a launch and all blocks in one) equal their plain
    versions exactly, in the launcher's geometry."""
    cpu = _fractional(np.random.default_rng(M + N + n_p), 2, M, N, n_p, n_q)
    gpu = [x.to(dev) for x in cpu]
    K = profile.CKPT_ROWS
    ref = profile.profile_forward_ckpt_plain(*cpu, K=K)
    got = profile.profile_forward_ckpt(*gpu, K=K)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert torch.equal(got[0], profile.profile_forward_scores(*gpu))
    nb = M // K
    for bi in range(nb):
        pb = cpu[0][:, bi * K:(bi + 1) * K].contiguous()
        want = profile.profile_block_ptrs_plain(ref[1][bi], ref[2][bi], pb,
                                                cpu[1], cpu[3])
        g = profile.profile_block_ptrs(got[1][bi], got[2][bi], pb.to(dev),
                                       gpu[1], gpu[3])
        assert torch.equal(g.cpu(), want), bi
    many = profile.profile_block_ptrs_batch(got[1], got[2], gpu[0], gpu[1],
                                            gpu[3], 0, nb)
    assert torch.equal(many.cpu(), profile.profile_block_ptrs_batch_plain(
        ref[1], ref[2], cpu[0], cpu[1], cpu[3], 0, nb))


# (geometry (g, W), N): windows of 2, 3 and 10+ blocks, odd and even K
# (SPAN_K[g]), a last block with fewer strips than W
SPAN_CASES = [((0, 3), 2_303), ((1, 2), 2_303), ((5, 1), 2_303),
              ((4, 1), 4_000), ((7, 4), 2_303), ((2, 4), 2_303)]


@pytest.mark.parametrize("geometry,N", SPAN_CASES)
@pytest.mark.parametrize("n_p,n_q", [(1, 1), (3, 2)])
def test_span_kernels_multi_block_equal_plain(dev, geometry, N, n_p, n_q):
    """K24 and batched K25 in a forced geometry whose windows span
    several blocks (hand-offs through global memory): three windows of
    different q_len, one-hot and 3+2-row profiles, exact; K25 over every
    row block at once, over the last two, and one at a time."""
    B, M, K = 3, 384, profile.CKPT_ROWS
    g, W = geometry
    S, C = profile.span_plan(N, profile.SPAN_K[g], W)
    assert C >= 2
    cpu = _fractional(np.random.default_rng(N + 7 * g + W + n_p), B, M, N,
                      n_p, n_q)
    assert len(set(cpu[3].tolist())) == B
    gpu = [x.to(dev) for x in cpu]
    ref = profile.profile_forward_ckpt_plain(*cpu, K=K)
    got = profile.profile_forward_ckpt(*gpu, K=K, geometry=geometry)
    for name, x, r in zip(("score", "ck_h", "ck_f"), got, ref):
        assert torch.equal(x.cpu(), r), (name, S, C)
    nb = M // K
    for first, G in ((0, nb), (nb - 2, 2)):
        want = profile.profile_block_ptrs_batch_plain(
            ref[1], ref[2], cpu[0], cpu[1], cpu[3], first, G)
        many = profile.profile_block_ptrs_batch(
            got[1], got[2], gpu[0], gpu[1], gpu[3], first, G,
            geometry=geometry)
        assert torch.equal(many.cpu(), want), (first, G, S, C)
    pb = gpu[0][:, K:2 * K].contiguous()
    one = profile.profile_block_ptrs(got[1][1], got[2][1], pb, gpu[1],
                                     gpu[3], geometry=geometry)
    assert torch.equal(one.cpu(), profile.profile_block_ptrs_plain(
        ref[1][1], ref[2][1], pb.cpu(), cpu[1], cpu[3]))


def test_span_geometry_fits_the_bounded_shapes(dev):
    """The pick for the swapped-locus launch (K24: 39,424 rows x 39,366
    columns; K25: block_batch's G row blocks) fits the card, and its
    blocks cover the window's columns."""
    N, M, K = 39_366, 39_424, profile.CKPT_ROWS
    G = profile.block_batch(1, K, N, M // K)
    for n_inst, R, ptr in ((1, M, False), (G, K, True)):
        geo = profile.span_geometry(n_inst, R, N, ptr)
        assert geo["blocks_per_sm"] > 0
        assert geo["strips"] * 32 * geo["K"] >= N + 1
        assert geo["blocks"] * geo["warps"] >= geo["strips"]


def test_ckpt_route_equals_one_launch_on_cuda(dev, monkeypatch):
    """Phase "bounded"'s route equality at about 8,000 columns: with
    PTR_BUDGET lowered below one window's pointers, the uncertified
    window (unrelated sequences) takes K24 + K25 + the host walk, the
    near-diagonal one still certifies banded, and the merged rows equal
    the one-launch route's (K3 + K4)."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 4, 8_000).astype(np.uint8)
    b = a.copy()
    m = rng.random(8_000) < 0.01
    b[m] = (b[m] + 1) % 4
    p_rows = [rng.integers(0, 4, (1, 8_000)).astype(np.uint8), a[None]]
    q_rows = [rng.integers(0, 4, (1, 7_900)).astype(np.uint8), b[None]]
    whole = profile.align_profile_batch(p_rows, q_rows, device=dev)
    Mp, N = profile.padded_rows(profile._bucket_cols(8_000)), \
        profile._bucket_cols(8_000)
    monkeypatch.setattr(profile, "PTR_BUDGET", Mp * (N + 1) - 1)
    before = profile.CKPT_STATS["windows"]
    n24 = profile.profile_forward_ckpt.launches
    got = profile.align_profile_batch(p_rows, q_rows, device=dev)
    assert profile.CKPT_STATS["windows"] - before == 1
    assert profile.profile_forward_ckpt.launches - n24 == 1
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("weight,cap", [(11, 1 << 20), (17, 1 << 20),
                                        (17, 3_000)])
def test_route_fill_kernel_equals_plain(dev, weight, cap):
    """K26 against its plain version on one shard's slice of a pair's
    table, u32 and u64 keys with masked windows, with and without rows
    past the capacity: exact (send buffers and the drop count)."""
    from libmems_tpu_torch.ops import shard
    seed = seeds.get_seed(weight)
    rng = np.random.default_rng(weight)
    codes = torch.from_numpy(rng.integers(0, 4, 100_000).astype(np.uint8))
    ambig = torch.from_numpy(rng.random(100_000) < 0.001)
    keys = mers.canonical_seed_keys_plain(codes, seed, ambig)
    for n_dev in (3, 4):
        args = (keys, 777, mers.key_sentinel(seed), n_dev, cap)
        ref = shard.route_fill_plain(*args)
        got = shard.route_fill(keys.to(dev), *args[1:])
        assert torch.equal(got.keys.cpu(), ref.keys)
        assert torch.equal(got.src.cpu(), ref.src)
        assert int(got.dropped) == int(ref.dropped)
        assert (int(ref.dropped) > 0) == (cap < 10_000)


def _routed_flags(dev, G=3, n=40_000):
    """K13's flags of shard 0's routed table of a G-genome family, on
    CPU tensors and on dev."""
    from libmems_tpu_torch.ops import mums
    from libmems_tpu_torch.ops.mers import key_sentinel, sentinel_content
    from libmems_tpu_torch.parallel import shard as psh
    from libmems_tpu_torch.sml import create_smls
    smls, seed = create_smls(_family(G, n, 38), device="cpu")
    lay = psh._Layout(smls, psh.Mesh(["cpu"] * 2))
    tables, dropped = psh._route(psh.Mesh(["cpu"] * 2), lay.slices,
                                 key_sentinel(seed), 1 << 20)
    assert dropped == 0
    content, src, _ = tables[0]
    keys, seg_off = lay.keys[torch.device("cpu")], \
        lay.seg_off[torch.device("cpu")]
    args = (content, src, keys, seg_off, 0, 1000, sentinel_content(seed))
    return (mums.mum_seed_flags(*args),
            mums.mum_seed_flags(*[a.to(dev) if isinstance(a, torch.Tensor)
                                  else a for a in args]),
            smls[0].seed_length)


def test_shard_candidates_kernel_equals_plain(dev):
    """K27 against its plain version on a shard's routed table, with a
    capacity above and below the surviving runs (the dump row): exact."""
    from libmems_tpu_torch.ops import shard
    ref_f, got_f, seed_len = _routed_flags(dev)
    assert got_f.n_rows == ref_f.n_rows > 1000
    for capacity in (1 << 20, ref_f.n_rows // 3):
        ref = shard.shard_candidates_plain(ref_f, 3, capacity, seed_len)
        got = shard.shard_candidates(got_f, 3, capacity, seed_len)
        assert got.over == ref.over == max(ref_f.n_rows - capacity, 0)
        for r, g in zip(ref[:-1], got[:-1]):
            assert torch.equal(g.cpu(), r)


def test_dedup_flags_kernel_equals_plain(dev):
    """K28 against its plain version on rows with many exact repeats and
    invalid rows: exact (sorted rows, lengths, flags)."""
    from libmems_tpu_torch.ops import shard
    rng = np.random.default_rng(28)
    m, G = 200_000, 3
    cpu = (torch.from_numpy(rng.integers(0, 50, (m, G)).astype(np.int32)),
           torch.from_numpy(rng.random((m, G)) < 0.8),
           torch.from_numpy(rng.random((m, G)) < 0.5),
           torch.from_numpy(rng.integers(20, 23, m).astype(np.int32)),
           torch.from_numpy(rng.random(m) < 0.9))
    ref = shard.dedup_flags_plain(*cpu)
    got = shard.dedup_flags(*[x.to(dev) for x in cpu])
    for r, g in zip(ref, got):
        assert torch.equal(g.cpu(), r)
    assert 0 < int(ref.uniq.sum()) < m


def test_shard_kernels_count_only_launches(dev):
    """K26-K28 count a launch only where their kernel runs: empty inputs
    return the plain version's empty results and leave the counts as
    they were; a meshed seeding whose last slice is empty (3 x 38 kbp
    over 4 shards) counts K26 once per non-empty slice."""
    from libmems_tpu_torch.ops import shard
    from libmems_tpu_torch.parallel import shard as psh
    from libmems_tpu_torch.sml import create_smls
    wrappers = (shard.route_fill, shard.shard_candidates, shard.dedup_flags)
    before = [w.launches for w in wrappers]
    empty = torch.zeros(0, dtype=torch.int64)
    args = (empty, 0, -1, 4, 256)
    ref = shard.route_fill_plain(*args)
    got = shard.route_fill(empty.to(dev), *args[1:])
    assert torch.equal(got.keys.cpu(), ref.keys)
    assert torch.equal(got.src.cpu(), ref.src)
    assert int(got.dropped) == 0
    cols = (torch.zeros((0, 3), dtype=torch.int32),
            torch.zeros((0, 3), dtype=torch.bool),
            torch.zeros((0, 3), dtype=torch.bool),
            torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.bool))
    got = shard.dedup_flags(*[x.to(dev) for x in cols])
    assert [tuple(x.shape) for x in got] == [(0, 3), (0,), (0,)]
    assert [w.launches for w in wrappers] == before
    mesh = psh.Mesh([dev] * 4)
    smls, _ = create_smls(_family(3, 38_000, 38), device=dev)
    nonempty = sum(k.shape[0] > 0 for k, _ in psh._Layout(smls, mesh).slices)
    assert nonempty == 3
    n26 = shard.route_fill.launches
    psh.sharded_find_mums(smls, mesh)
    assert shard.route_fill.launches - n26 == nonempty


def _sharded_cuda_vs_cpu(mesh):
    """sharded_find_mums and sharded_find_pairwise_mums on `mesh` equal
    the same calls on CPU shards; the kernels K26-K28 launched."""
    from libmems_tpu_torch.ops import shard
    from libmems_tpu_torch.parallel import shard as psh
    from libmems_tpu_torch.sml import create_smls
    fam = _family(3, 40_000, 38)
    dev = mesh.devices[0]
    smls_g, _ = create_smls(fam, device=dev)
    smls_c, _ = create_smls(fam, device="cpu")
    cpu_mesh = psh.Mesh(["cpu"] * mesh.size)
    wrappers = (shard.route_fill, shard.shard_candidates, shard.dedup_flags)
    before = [w.launches for w in wrappers]
    got = psh.sharded_find_mums(smls_g, mesh)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    ref = psh.sharded_find_mums(smls_c, cpu_mesh)
    assert len(ref) > 100
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    got = psh.sharded_find_pairwise_mums(smls_g, mesh)
    ref = psh.sharded_find_pairwise_mums(smls_c, cpu_mesh)
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)


def test_sharded_find_mums_on_cuda_equals_cpu(dev):
    from libmems_tpu_torch.parallel import shard as psh
    _sharded_cuda_vs_cpu(psh.Mesh([dev] * 4))


def test_sharded_find_mums_on_every_card_equals_cpu(dev):
    """make_mesh() over every visible card: real peer copies."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA GPUs")
    from libmems_tpu_torch.parallel import shard as psh
    _sharded_cuda_vs_cpu(psh.make_mesh())


def test_align_profile_batch_mesh_split_on_cuda_equals_whole(dev,
                                                             monkeypatch):
    """The window split of align_profile_batch over 3 shards on the card
    (the _shard_* wrappers): merged rows equal the whole batch's, on the
    banded bucket and with PTR_BUDGET lowered so the 256-column bucket
    takes the checkpointed route (K24 + K25 on each slice); the split
    banded scores equal the whole batch's (K10)."""
    from libmems_tpu_torch.parallel import shard as psh
    rng = np.random.default_rng(9)
    p_rows, q_rows = [], []
    for n in (900, 950, 700, 880, 200, 150, 180):
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        m = rng.random(n) < 0.01
        b[m] = (b[m] + 1) % 4
        p_rows.append(np.stack([a, a]))
        q_rows.append(b[None])
    mesh = psh.Mesh([dev] * 3)
    whole = profile.align_profile_batch(p_rows, q_rows, device=dev,
                                        mesh=None)
    for g, w in zip(profile.align_profile_batch(p_rows, q_rows, device=dev,
                                                mesh=mesh), whole):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setattr(profile, "PTR_BUDGET", 64 * 65 + 1)
    n24 = profile.profile_forward_ckpt.launches
    ckpt = profile.CKPT_STATS["windows"]
    for g, w in zip(profile.align_profile_batch(p_rows, q_rows, device=dev,
                                                mesh=mesh), whole):
        np.testing.assert_array_equal(g, w)
    assert profile.CKPT_STATS["windows"] - ckpt >= 3
    assert profile.profile_forward_ckpt.launches - n24 >= 3   # a slice each
    t = profile.pack_profiles(p_rows, q_rows, [0, 1, 2, 3], 1024, 1024, dev)
    H_W = profile._band_half(1024)
    want = profile.banded_forward_scores(*t, profile.GAP_OPEN,
                                         profile.GAP_EXTEND, H_W)
    got = profile.banded_scores_split(*t, profile.GAP_OPEN,
                                      profile.GAP_EXTEND, H_W, mesh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("G,n_dev,req_cap", [(2, 4, 1 << 20), (3, 4, 50),
                                             (5, 3, 1 << 20), (2, 8, 3000)])
def test_tiled_request_and_serve_kernels_equal_plain(dev, G, n_dev, req_cap):
    """K29 (with requests past req_cap) and K30 (with starts outside the
    tile) against their plain versions on both sides."""
    from libmems_tpu_torch.ops import tiled
    rng = np.random.default_rng(G * n_dev)
    R, S, C = 6_000, 1 << 14, 512
    lefts = torch.from_numpy(rng.integers(0, n_dev * S // 2, (R, G)
                                          ).astype(np.int32))
    lengths = torch.from_numpy(rng.integers(15, 400, R).astype(np.int32))
    present = torch.from_numpy(rng.random((R, G)) < 0.9)
    is_fwd = torch.from_numpy(rng.random((R, G)) < 0.5)
    gen_off = torch.from_numpy((np.arange(G) * (n_dev * S // (2 * G))
                                ).astype(np.int32))
    rows = torch.from_numpy(np.sort(rng.choice(R, 4_000, replace=False)))
    for side in (0, 1):
        args = [rows, lefts, lengths, present, is_fwd, gen_off, side, C, 15,
                C, S, n_dev, req_cap]
        ref = tiled.tiled_requests_plain(*args)
        n = tiled.tiled_requests.launches
        got = tiled.tiled_requests(*[a.to(dev) if isinstance(a, torch.Tensor)
                                     else a for a in args])
        assert tiled.tiled_requests.launches == n + 1
        counts, dropped = tiled.tally_counts(ref.tally.tolist(), n_dev)
        assert torch.equal(got.tally.cpu(), ref.tally)
        assert got.send.shape == ref.send.shape
        for o, c in enumerate(counts):
            assert torch.equal(got.send[o, :c].cpu(), ref.send[o, :c])
        assert torch.equal(got.where.cpu(), ref.where)
        assert (dropped > 0) == (req_cap < 1000)
    tile = torch.from_numpy(rng.integers(-2**62, 2**62, S + C + 128))
    offs = torch.from_numpy(rng.integers(-5, S + 5, 3_000))
    ref = tiled.tiled_serve_plain(tile, S, offs, C, -1)
    assert torch.equal(tiled.tiled_serve(tile.to(dev), S, offs.to(dev), C,
                                         -1).cpu(), ref)


@pytest.mark.parametrize("C", [15, 33, 512, 520])
def test_tiled_serve_kernel_equals_plain(dev, C):
    """K30, a warp a span, against its plain version, exact: odd and even
    starts, the tile's first and last starts, starts outside it, a tile
    view 8 bytes off a 16-byte boundary, odd C, one request and none; one
    launch a call, none for no requests."""
    from libmems_tpu_torch.ops import tiled
    rng = np.random.default_rng(C)
    S = 1 << 14
    big = torch.from_numpy(rng.integers(-2**62, 2**62, S + C + 129)).to(dev)
    for tile in (big[:-1], big[1:]):
        for n in (0, 1, 20_001):
            offs = torch.from_numpy(rng.integers(-40, S + 40, n))
            offs[:4] = torch.tensor([0, 1, S - 1, S])[:n]
            ref = tiled.tiled_serve_plain(tile.cpu(), S, offs, C, -1)
            k = tiled.tiled_serve.launches
            got = tiled.tiled_serve(tile, S, offs.to(dev), C, -1)
            assert torch.equal(got.cpu(), ref)
            assert tiled.tiled_serve.launches == k + (n > 0)


# K31's span rows: (seed_len, C) as the CPU tests take them
SPAN_SHAPES = [(15, 15), (15, 33), (15, 512), (15, 520), (21, 21), (21, 33),
               (21, 512), (21, 520), (40, 40), (40, 512), (40, 520)]


@pytest.mark.parametrize("owners", [1, 3])
@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("G", [2, 3, 32, 33])
def test_tiled_probe_kernel_span_rows_equal_plain(dev, G, side, owners):
    """K31 against its plain version, bit for bit, on extend_rows'
    span_rows: planted gaps at ballot-word edges and the round's last
    offsets, probe positions leaving their genome, sentinels, absent
    genomes and dropped requests.  G = 32 is the warp route's widest row,
    G = 33 the block route's narrowest; rows outside the block stay as
    they are; one launch a call.  With three owners, `where` points into
    several owners' answers at non-zero offsets (extend_rows.owner_major:
    owners 0, 1 and 3 answer, the empty owner 2 between them)."""
    from libmems_tpu_torch.ops import tiled
    for seed_len, C in SPAN_SHAPES:
        resp, where, rows, *state = extend_rows.span_rows(
            seed_len, C, G, side, seed_len + C + G)
        off = np.zeros(1, np.int64)     # one owner: where indexes resp
        if owners > 1:
            resp, where, off = extend_rows.owner_major(
                resp, where, np.array([0, 1, 3]), C)
            assert (off[1:] > 0).all()
        resp, where, rows, off = (torch.from_numpy(x)
                                  for x in (resp, where, rows, off))
        state = [torch.from_numpy(x) for x in state]
        ref = [x.clone() for x in state]
        tiled.tiled_probe_plain(resp, where, rows, ref[0], ref[1], ref[2],
                                ref[3], ref[4], ref[5], side, C, seed_len,
                                -1, off)
        got = [x.to(dev) for x in state]
        n = tiled.tiled_probe.launches
        tiled.tiled_probe(resp.to(dev), where.to(dev), rows.to(dev), got[0],
                          got[1], got[2], got[3], got[4], got[5], side, C,
                          seed_len, -1, off.to(dev))
        assert tiled.tiled_probe.launches == n + 1
        for g, r, name in zip(got, ref, ("lefts", "lengths", "present",
                                         "is_fwd", "gen_cnt", "active")):
            assert torch.equal(g.cpu(), r), (seed_len, C, name)
        assert ref[5].any() and not ref[5].all()


def _tiled_genomes(rng_seed, n=60_000):
    rng = np.random.default_rng(rng_seed)
    a = rng.integers(0, 4, n).astype(np.uint8)
    b = generate._mutant(rng, a, mutate=0.01, indel=0.0005)
    b = np.concatenate([b[n // 2:], 3 - b[:n // 2][::-1]])
    return [Genome(f"g{i}", generate._LUT[x]) for i, x in enumerate((a, b))]


def test_sharded_find_mums_tiled_on_cuda_equals_find_mums(dev, monkeypatch):
    """The tiled path on 4 shards of the card equals find_mums (which the
    CPU tests hold to the JAX package); its first K31 launches equal
    their plain version on the same inputs, on CPU tensors."""
    from libmems_tpu_torch.matchfind import find_mums
    from libmems_tpu_torch.ops import tiled
    from libmems_tpu_torch.parallel import shard as psh
    from libmems_tpu_torch.sml import create_smls
    genomes = _tiled_genomes(5)
    smls_g, _ = create_smls(genomes, device=dev)
    real = tiled.tiled_probe
    seen = []

    def both(resp, where, rows, lefts, lengths, present, is_fwd, gen_cnt,
             active, *rest):
        if len(seen) >= 8:
            return real(resp, where, rows, lefts, lengths, present, is_fwd,
                        gen_cnt, active, *rest)
        cpu = [x.cpu().clone() for x in (lefts, lengths, active)]
        tiled.tiled_probe_plain(resp.cpu(), where.cpu(), rows.cpu(), cpu[0],
                                cpu[1], present.cpu(), is_fwd.cpu(),
                                gen_cnt.cpu(), cpu[2], *rest[:-1],
                                rest[-1].cpu())
        real(resp, where, rows, lefts, lengths, present, is_fwd, gen_cnt,
             active, *rest)
        seen.append(all(torch.equal(a.cpu(), b) for a, b in
                        zip((lefts, lengths, active), cpu)))
    both.launches = 0
    monkeypatch.setattr(tiled, "tiled_probe", both)
    launches = (tiled.tiled_requests.launches, tiled.tiled_serve.launches)
    got = psh.sharded_find_mums_tiled(smls_g, psh.Mesh([dev] * 4))
    monkeypatch.setattr(tiled, "tiled_probe", real)
    assert seen and all(seen)
    assert tiled.tiled_requests.launches > launches[0]
    assert tiled.tiled_serve.launches > launches[1]
    want = find_mums(smls_g)
    assert len(want) > 10
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def test_span_kernels_on_second_card_equal_first(dev):
    """K24 and batched K25 launch on their tensors' card: on cuda:1 with
    card 0 current they give cuda:0's outputs, and card 0 stays
    current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA GPUs")
    cpu = _fractional(np.random.default_rng(23), 2, 384, 2_303, 3, 2)
    outs = []
    with torch.cuda.device(0):
        for d in ("cuda:0", "cuda:1"):
            t = [x.to(d) for x in cpu]
            sc, ck_h, ck_f = profile.profile_forward_ckpt(*t)
            ptr = profile.profile_block_ptrs_batch(ck_h, ck_f, t[0], t[1],
                                                   t[3], 0, ck_h.shape[0])
            outs.append([x.cpu() for x in (sc, ck_h, ck_f, ptr)])
            assert torch.cuda.current_device() == 0
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_align_on_second_card_equals_first(dev):
    """Launches follow the tensors' card: with card 0 current, align on
    cuda:1 gives the XMFA bytes of cuda:0, and card 0 stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA GPUs")
    genomes = _tiled_genomes(6)
    cfg = dict(gapped_alignment=True, recursive=True)
    out = []
    with torch.cuda.device(0):
        for d in ("cuda:0", "cuda:1"):
            ivs, _ = align(genomes, AlignerConfig(device=d, **cfg))
            buf = io.StringIO()
            write_xmfa(buf, ivs)
            out.append(buf.getvalue())
            assert torch.cuda.current_device() == 0
    assert out[0] == out[1]
