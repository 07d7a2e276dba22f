"""Batched profile-profile global alignment with affine gaps: the
full-width forward with pointers (K3) and without (K9, csrc/profile.cu),
the banded forward with its certificate (K10) and with pointers (K11),
the banded traceback walk (K12, csrc/banded.cu), the checkpointed
forward (K24) and the block pointers (K25, csrc/profile.cu), plus the
full-width walk K4 of ops.gapped.

Port of libmems_tpu/ops/profile.py, the compute core of the MSA engine
that replaces the reference's in-process MUSCLE profile alignment
(MuscleInterface::ProfileAlignFast, libMems/MuscleInterface.cpp:1053).
A profile is a column distribution over (A, C, G, T, gap); the
substitution score of two columns is the expected HOXD70 score
``p_i . W5 . q_j``, and gap-extend costs scale with the partner column's
non-gap occupancy.

Windows are grouped by padded column bucket (``_bucket_cols``) into
launches.  Buckets of 1024+ columns run the banded DP first: a window
whose banded optimum passes the certificate has exactly the full-width
score and traceback (the proof is at ``BAND_K`` below), the rest re-run
at full width.  A launch's pointer tensor (B*Mp*(WB+1) banded,
B*Mp*(N+1) full) stays under PTR_BUDGET bytes: launches are split
(``split_launch``) down to one window.  A bucket whose ONE window's full
pointer tensor Mp*(N+1) exceeds PTR_BUDGET (at the 1 GiB default, a
window whose two sides both pad to the 39,366-column bucket: 1.44 GiB)
never builds it: its uncertified and ineligible windows take the JAX
module's checkpointed route (``profile_forward_ckpt`` at K = 128 +
``profile_block_ptrs``).  K24 keeps the (H, F) carry every 128 rows,
launches split so the carries stay under PTR_BUDGET too, and the host
walk ``ops.gapped.traceback_blocks`` fetches each 128-row block's
pointers, nibble-packed, from K25, which computes the ``block_batch``
blocks below the one asked for side by side (``CKPT_STATS`` counts the
windows).  Both run a window's columns as strips of warps over several
thread blocks (``span_geometry``).
With two or more cards (``dp_mesh``) or a mesh passed in, each launch's
windows are cut into one contiguous slice a device (the ``_shard_*``
wrappers of the JAX module).  Windows are independent and padding never
reaches a window's result, so neither the grouping, the splits nor the
route changes an output.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch.ops.gapped import (CKPT_ROWS, E_EXT_BIT, F_EXT_BIT,
                                          GAP_EXTEND, GAP_OPEN, H_DIAG, H_E,
                                          H_F, HOXD70, WalkCodes,
                                          _device_tb_T, check_walk_ptrs,
                                          code_words, pack_ptrs_plain,
                                          tb_unpack, traceback_blocks,
                                          traceback_walk, unpack_ptrs,
                                          walk_outputs, walk_plain)

GAP_CODE = 4

# 5x5 expected-score matrix: HOXD70 over ACGT; a gap in an input profile
# column contributes 0 to the cross term (gap costs are carried by the
# affine gap machinery, not the substitution score).
W5 = np.zeros((5, 5), dtype=np.float32)
W5[:4, :4] = HOXD70.astype(np.float32)

NEG_BIG = np.float32(-1e30)

PTR_BUDGET = 1 << 30          # bytes of pointer tensor per launch
# the widest column bucket K3 and K9 run as strips of warps; wider ones
# take the wide route, one thread block a window (csrc/profile.cu
# kStripMaxN: 8 warps x 32 lanes x 17 columns - 1)
STRIP_MAX_N = 4351
# on the wide route, windows whose rows need more shared memory than this
# keep them in global scratch instead (csrc/profile.cu: 17 bytes per
# column)
PROFILE_SMEM_LIMIT = 200 * 1024


def rows_to_profile(rows: np.ndarray) -> np.ndarray:
    """Alignment rows (uint8 codes, GAP_CODE=4) -> column distribution
    float32[C, 5]."""
    n_rows, C = rows.shape
    prof = np.zeros((C, 5), dtype=np.float32)
    for a in range(5):
        prof[:, a] = (rows == a).sum(axis=0)
    return prof / max(n_rows, 1)


def _bucket_cols(n, minimum=16):
    """Padded column bucket: 4x-spaced below 1024, 1.5x-spaced above
    (the JAX module's compile-cache buckets; here they only group
    windows of similar size into one launch)."""
    b = minimum
    while b < n and b < 1024:
        b *= 4
    while b < n:
        b = b * 3 // 2
    return b


def fma32(a, b, c):
    """float32 a*b + c rounded once, as a fused multiply-add: the product
    is exact in float64, and a float64 sum that lands exactly halfway
    between two float32 values is resolved by its TwoSum error."""
    prod = a.double() * b.double()
    cd = c.double()
    d = prod + cd
    bv = d - prod
    err = (prod - (d - bv)) + (cd - bv)
    r = d.float()
    rd = r.double()
    inf = torch.full_like(r, float("inf"))
    nb = torch.nextafter(r, torch.where(d > rd, inf, -inf))
    tie = (d != rd) & ((rd + nb.double()) * 0.5 == d)
    up = tie & (err != 0) & ((err > 0) == (d > rd))
    return torch.where(up, nb, r)


def profile_qw(q, w):
    """qw[.., y] = sum_x q[.., x] * W5[y, x] in the fixed order
    ((t0 + t1) + (t2 + t3)) + t4 of rounded products (csrc/profile.cu)."""
    t = [q[..., None, x] * w[:, x] for x in range(5)]
    return ((t[0] + t[1]) + (t[2] + t[3])) + t[4]


def profile_row_score(p_i, qw):
    """p_i . qw[j] as a chain of fused multiply-adds over x = 0..4,
    starting from the rounded product of x = 0 (csrc/profile.cu)."""
    s = p_i[:, None, 0] * qw[..., 0]
    for x in range(1, 5):
        s = fma32(p_i[:, None, x].expand_as(s), qw[..., x], s)
    return s


def blocked_cumsum(x):
    """Inclusive cumsum along dim 1 in the order of the JAX package's
    jnp.cumsum on the CPU: sequential within blocks of 16, the block
    totals' prefix (recursively the same) added to every later block
    (csrc/common.cuh)."""
    B, n = x.shape
    if n <= 16:
        out = x.clone()
        for k in range(1, n):
            out[:, k] = out[:, k - 1] + x[:, k]
        return out
    nb = -(-n // 16)
    xp = torch.zeros((B, nb * 16), dtype=x.dtype, device=x.device)
    xp[:, :n] = x
    inner = blocked_cumsum(xp.reshape(B * nb, 16)).reshape(B, nb, 16)
    tot = blocked_cumsum(inner[:, :, -1].contiguous())
    carry = torch.cat([torch.zeros((B, 1), dtype=x.dtype, device=x.device),
                       tot[:, :-1]], 1)
    return (inner + carry[:, :, None]).reshape(B, nb * 16)[:, :n]


def _q_setup(q, gap_extend):
    """(qw [B, N, 5], ext_q [B, N], ext_cum [B, N+1]) in the kernels'
    rounding order (ops/profile.py:98-112)."""
    B = q.shape[0]
    w = torch.from_numpy(W5).to(q.device)
    ext_q = gap_extend * (1.0 - q[:, :, GAP_CODE])
    ext_cum = torch.cat([torch.zeros((B, 1), dtype=torch.float32,
                                     device=q.device),
                         blocked_cumsum(ext_q)], dim=1)
    return profile_qw(q, w), ext_q, ext_cum


def _row_plain(h, f, p_i, qw, ext_cum, ext_q, gap_open, gap_extend,
               emit_ptr):
    """One DP row of ops/profile.py:54-93 over the columns of h/f [B, W+1]
    (qw [B, W, 5], ext_cum [B, W+1], ext_q [B, W]).  Returns (h_row,
    f_row, pointer row uint8[B, W+1] or None)."""
    B = h.shape[0]
    ext_pi = (gap_extend * (1.0 - p_i[:, GAP_CODE]))[:, None]
    f_open = h + gap_open + ext_pi
    f_ext = f + ext_pi
    f_row = torch.maximum(f_open, f_ext)
    diag = h[:, :-1] + profile_row_score(p_i, qw)
    g = torch.maximum(diag, f_row[:, 1:])
    g0 = f_row[:, :1]
    gp = torch.cat([g0, g[:, :-1]], dim=1)
    wk = gp + gap_open - ext_cum[:, :-1]
    e_row = ext_cum[:, 1:] + torch.cummax(wk, dim=1).values
    h_row_1 = torch.maximum(g, e_row)
    h_row = torch.cat([g0, h_row_1], dim=1)
    if not emit_ptr:
        return h_row, f_row, None
    f_ext_bit = (f_row == f_ext) & (f > float(NEG_BIG) / 2)
    e_ext_bit = torch.cat([
        torch.zeros((B, 1), dtype=torch.bool, device=h.device),
        e_row[:, 1:] == e_row[:, :-1] + ext_q[:, 1:]], dim=1)
    h_src = torch.where(h_row_1 == diag, H_DIAG,
                        torch.where(h_row_1 == e_row, H_E, H_F))
    ptr = h_src | torch.where(e_ext_bit, E_EXT_BIT, 0) \
        | torch.where(f_ext_bit[:, 1:], F_EXT_BIT, 0)
    ptr_j0 = H_F | torch.where(f_ext_bit[:, :1], F_EXT_BIT, 0)
    return h_row, f_row, torch.cat([ptr_j0, ptr], dim=1).to(torch.uint8)


def profile_forward_plain(p, q, p_len, q_len, gap_open: int = GAP_OPEN,
                          gap_extend: int = GAP_EXTEND,
                          emit_ptr: bool = True):
    """Plain PyTorch version of K3 (and, with emit_ptr=False, of K9): the
    row scan of ops/profile.py:49-93 over rows 1..max(p_len).  qw, the
    row scores and ext_cum are formed in one fixed order of float32
    operations (profile_qw, profile_row_score, blocked_cumsum), which K3
    and K9 repeat, so fractional profiles give the kernels the same
    bytes.  Returns (ptrs uint8[B, M, N+1], zero outside each window's
    rows 1..p_len and columns 0..q_len, or None; score float32[B] =
    H[p_len][q_len])."""
    B, M, _ = p.shape
    N = q.shape[1]
    dev = p.device
    qw, ext_q, ext_cum = _q_setup(q, gap_extend)
    h, f = _h0f0(ext_cum, gap_open)
    ql = q_len.to(torch.int64)[:, None]
    pl = p_len.to(torch.int64)
    col_ok = torch.arange(N + 1, device=dev)[None, :] <= ql
    score = h.gather(1, ql)[:, 0]
    ptrs = torch.zeros((B, M, N + 1), dtype=torch.uint8, device=dev) \
        if emit_ptr else None
    n_rows = int(pl.max()) if B else 0
    for i in range(n_rows):
        h, f, ptr_row = _row_plain(h, f, p[:, i], qw, ext_cum, ext_q,
                                   gap_open, gap_extend, emit_ptr)
        if emit_ptr:
            keep = col_ok & (i < pl)[:, None]
            ptrs[:, i] = torch.where(keep, ptr_row, 0)
        score = torch.where(pl == i + 1, h.gather(1, ql)[:, 0], score)
    return ptrs, score


# the W5 matrix as the launchers take it (a host float[25]), built once
_W5_C = (ctypes.c_float * 25)(*W5.ravel().tolist())
# the geometry of the latest K3 or K9 launch on each card (lm_profile_fwd's
# `taken`), by device index
_TAKEN = {}


def _require_batch(p, q, p_len, q_len):
    dev = p.device
    B, M, _ = p.shape
    N = q.shape[1]
    cuda.require(p, "p", torch.float32, dev, (B, M, 5))
    cuda.require(q, "q", torch.float32, dev, (B, N, 5))
    cuda.require(p_len, "p_len", torch.int32, dev, (B,))
    cuda.require(q_len, "q_len", torch.int32, dev, (B,))
    return dev, B, M, N


def _full_launch(p, q, p_len, q_len, gap_open, gap_extend, emit_ptr,
                 geometry):
    """One K3 (emit_ptr) or K9 launch: the pointer tensor uninitialised
    on the strip route (the kernel writes every byte) and zero-filled on
    the wide route (its kernel writes each window's rows and columns
    only), the wide route's scratch in one allocation (none on the strip
    route).  Returns (ptrs or None, score)."""
    dev, B, M, N = _require_batch(p, q, p_len, q_len)
    lib = cuda.library()
    rows_global = _rows_global(lib, N)
    n = lib.lm_profile_scratch_bytes(B, N, int(emit_ptr), int(rows_global))
    # held by name until the launch is enqueued
    scratch = torch.empty((n,), dtype=torch.uint8, device=dev) if n else None
    alloc = torch.empty if N <= STRIP_MAX_N else torch.zeros
    ptrs = alloc((B, M, N + 1), dtype=torch.uint8, device=dev) \
        if emit_ptr else None
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    taken = _TAKEN.get(dev.index)
    if taken is None:
        taken = _TAKEN.setdefault(dev.index, (ctypes.c_int * 6)())
    cuda.check(lib.lm_profile_fwd(
        p.data_ptr(), q.data_ptr(), p_len.data_ptr(), q_len.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if ptrs is None else ptrs.data_ptr(), score.data_ptr(), B, M,
        N, int(rows_global), float(gap_open), float(gap_extend), _W5_C,
        geometry, taken, cuda.stream(p)), "lm_profile_fwd")
    return ptrs, score


def _describe(out):
    return {"route": ("strips", "wide")[out[0]], "geometry": out[1],
            "K": out[2], "warps": out[3], "windows_per_block": out[4],
            "windows_per_sm": out[5]}


def _rows_global(lib, N):
    """Whether the wide route keeps an N-column bucket's rows in global
    scratch (past PROFILE_SMEM_LIMIT) instead of shared memory."""
    return lib.lm_profile_row_bytes(N) > PROFILE_SMEM_LIMIT


def launched_geometry(device=None):
    """The geometry the latest K3 or K9 launch on `device` (the current
    card by default) took, as profile_geometry describes it; None before
    the card's first."""
    d = torch.device("cuda" if device is None else device)
    out = _TAKEN.get(torch.cuda.current_device() if d.index is None
                     else d.index)
    return None if out is None else _describe(out)


def profile_geometry(B: int, N: int, emit_ptr: bool = True, g: int = -1):
    """The launch geometry of K3 (emit_ptr) or K9 for B windows in an
    N-column bucket on the current card.  Up to STRIP_MAX_N: entry g of
    csrc/profile.cu's strip table, or for g < 0 the launcher's pick,
    {"route": "strips", "geometry", "K" (columns a lane), "warps" (a
    window), "windows_per_block", "windows_per_sm"} with windows_per_sm 0
    where g does not fit the bucket; None past the table's end.  Wider:
    {"route": "wide", "geometry": -1, "warps" (the block), ...,
    "windows_per_sm" with the rows where PROFILE_SMEM_LIMIT puts them} for
    g < 0, None for g >= 0."""
    lib = cuda.library()
    out = (ctypes.c_int * 6)()
    rc = lib.lm_profile_geometry(B, N, int(emit_ptr), g,
                                 int(_rows_global(lib, N)), out)
    if rc == -1:
        return None
    cuda.check(rc, "lm_profile_geometry")
    return _describe(out)


@cuda.launcher
def profile_forward(p, q, p_len, q_len, gap_open: int = GAP_OPEN,
                    gap_extend: int = GAP_EXTEND, *, geometry: int = -1):
    """Profile DP forward with pointer bytes for a batch of windows.

    p: float32[B, M, 5], q: float32[B, N, 5] (zero-padded profiles);
    p_len, q_len: int32[B].  Returns (ptrs uint8[B, M, N+1], score
    float32[B]) as profile_forward_plain does.  CPU tensors take the
    plain version; CUDA tensors launch K3, in the launcher's geometry or
    in strip table entry `geometry` (profile_geometry) where that is >= 0
    and N <= STRIP_MAX_N."""
    if p.device.type == "cpu":
        return profile_forward_plain(p, q, p_len, q_len, gap_open,
                                     gap_extend)
    out = _full_launch(p, q, p_len, q_len, gap_open, gap_extend, True,
                       geometry)
    profile_forward.launches += 1
    return out


profile_forward.launches = 0


def profile_forward_scores_plain(p, q, p_len, q_len,
                                 gap_open: int = GAP_OPEN,
                                 gap_extend: int = GAP_EXTEND):
    """Plain PyTorch version of K9: K3's row loop without pointers."""
    return profile_forward_plain(p, q, p_len, q_len, gap_open, gap_extend,
                                 emit_ptr=False)[1]


@cuda.launcher
def profile_forward_scores(p, q, p_len, q_len, gap_open: int = GAP_OPEN,
                           gap_extend: int = GAP_EXTEND, *,
                           geometry: int = -1):
    """Full-width forward scores float32[B] of a batch of windows (the
    gate's fallback: profile_forward_ckpt with K = Mp,
    ops/profile.py:115-138, checkpoints discarded).  Equal bit for bit to
    profile_forward's score.  CPU tensors take the plain version; CUDA
    tensors launch K9 (`geometry` as for profile_forward)."""
    if p.device.type == "cpu":
        return profile_forward_scores_plain(p, q, p_len, q_len, gap_open,
                                            gap_extend)
    _, score = _full_launch(p, q, p_len, q_len, gap_open, gap_extend, False,
                            geometry)
    profile_forward_scores.launches += 1
    return score


profile_forward_scores.launches = 0


def _h0f0(ext_cum, gap_open: int):
    """The DP's first row: H[0][j] = open + ext_cum[j] (0 at j = 0),
    F = NEG_BIG (ops/profile.py:107-112)."""
    j_idx = torch.arange(ext_cum.shape[1], device=ext_cum.device)
    h = torch.where(j_idx[None, :] == 0, 0.0, gap_open + ext_cum)
    return h, torch.full_like(h, float(NEG_BIG))


def profile_forward_ckpt_plain(p, q, p_len, q_len, gap_open: int = GAP_OPEN,
                               gap_extend: int = GAP_EXTEND,
                               K: int = CKPT_ROWS):
    """Plain PyTorch version of K24: profile_forward_ckpt
    (ops/profile.py:115-138) over every row and column of the padded
    matrix, in K3's order of float operations.  M must be a multiple of
    K.  Returns (score float32[B] = H[p_len][q_len], ck_h, ck_f
    float32[M/K, B, N+1]: the (H, F) carry at the top of every K-row
    block, block 0 the DP's first row)."""
    B, M, _ = p.shape
    N = q.shape[1]
    if K < 1 or M % K:
        raise ValueError(f"M = {M} is not a multiple of K = {K}")
    qw, ext_q, ext_cum = _q_setup(q, gap_extend)
    h, f = _h0f0(ext_cum, gap_open)
    ck_h = torch.empty((M // K, B, N + 1), dtype=torch.float32,
                       device=p.device)
    ck_f = torch.empty_like(ck_h)
    ql = q_len.to(torch.int64)[:, None]
    pl = p_len.to(torch.int64)
    score = h.gather(1, ql)[:, 0]
    for i in range(M):
        if i % K == 0:
            ck_h[i // K] = h
            ck_f[i // K] = f
        h, f, _ = _row_plain(h, f, p[:, i], qw, ext_cum, ext_q, gap_open,
                             gap_extend, False)
        score = torch.where(pl == i + 1, h.gather(1, ql)[:, 0], score)
    return score, ck_h, ck_f


# The span kernels' geometry (K24, K25, K22 and K23): SPAN_K[g] columns
# a lane (csrc/strip.cuh kSpanK), W strips a block of W + 1 warps (warp 0
# the receiver), W <= SPAN_MAX_W
SPAN_K = (17, 16, 13, 9, 8, 5, 3, 1)
SPAN_MAX_W = 8
# The price of a span launch, in ns (span_cost): a row of a strip costs
# A + Bk*K + Cs*W; an instance alone takes R rows plus its pipeline's
# fill, Hop a strip and E a block edge (the hand-off through L2); many
# instances take the card's block slots for their rows and their blocks'
# waits.  (A, Bk, Cs, Hop, E) for the carries (K24) and the pointers
# (K25), fitted to the forced-geometry times of `chip_smoke.py --sweep
# bounded` on an H100 (the swapped-locus launch of 39,367 columns: K24
# one window of 39,424 rows, K25 53 row blocks of 128; within 11% and
# 31% of the times).
SPAN_COST = {False: (350, 20, 20, 200, 5_000),
             True: (1_200, 40, 20, 200, 500)}
# a launch's hand-off columns hold at most PTR_BUDGET / SPAN_EDGE_SHARE
# bytes: span_pick leaves out the geometries of more blocks
SPAN_EDGE_SHARE = 16
# K25's and K23's launches on the checkpointed routes hold at most this
# share of PTR_BUDGET in packed pointers (block_batch)
PTR_BATCH_SHARE = 8
# the card's fits of the span kernels, by (device index, C entry, its
# arguments)
_SPAN_FITS = {}


def span_plan(N: int, K: int, W: int) -> tuple[int, int]:
    """(S, C): the strips of K columns a lane that cover an N-column
    bucket's N+1 columns, and the blocks of W strips that hold them."""
    S = -(-(N + 1) // (32 * K))
    return S, -(-S // W)


def span_cost(n_inst: int, R: int, N: int, ptr: bool, g: int, W: int,
              per_sm: int, n_sm: int) -> float:
    """The price in ns of a span launch of n_inst instances of R rows in
    geometry (g, W), with per_sm blocks an SM and n_sm SMs (SPAN_COST):
    the larger of one instance's rows and fill, and the block slots its
    instances hold (each block its R rows and on average half its
    instance's fill); an instance wider than the card's slots runs its
    blocks in turns."""
    A, Bk, Cs, Hop, E = SPAN_COST[ptr]
    K = SPAN_K[g]
    S, C = span_plan(N, K, W)
    w = min(W, S)
    resident = per_sm * n_sm
    row = A + Bk * K + Cs * w
    span = R * row + S * Hop + (C - 1) * E
    if C > resident:
        return n_inst * -(-C // resident) * span
    slots = n_inst * C * (R * row + (C - 1) / 2 * (w * Hop + E)) / resident
    return max(span, slots)


def span_edge_bytes(n_inst: int, R: int, N: int, ptr: bool, g: int,
                    W: int) -> int:
    """Bytes of a span launch's hand-off columns: R rows of 2 (K24) or 3
    (K25) words at each of an instance's C - 1 block edges."""
    C = span_plan(N, SPAN_K[g], W)[1]
    return n_inst * (C - 1) * R * (24 if ptr else 16)


def span_fits(entry: str, *args):
    """(n_sm, {(g, W): blocks an SM}) of a span kernel on the current
    card, from its C entry (lm_span_fits or lm_gotoh_fits, with ptr 0
    for K24 and K22, 1 for K25 and K23), asked of the runtime once a
    card."""
    key = (torch.cuda.current_device(), entry, args)
    fits = _SPAN_FITS.get(key)
    if fits is None:
        nk = len(SPAN_K)
        out = (ctypes.c_int * (1 + nk + nk * SPAN_MAX_W))()
        cuda.check(getattr(cuda.library(), entry)(*args, out), entry)
        if tuple(out[1:1 + nk]) != SPAN_K:
            raise RuntimeError(f"csrc/strip.cuh's kSpanK {out[1:1 + nk]} "
                               f"is not SPAN_K {SPAN_K}")
        fits = _SPAN_FITS.setdefault(key, (out[0], {
            (g, W): out[1 + nk + g * SPAN_MAX_W + W - 1]
            for g in range(nk) for W in range(1, SPAN_MAX_W + 1)}))
    return fits


def span_pick(n_inst: int, R: int, N: int, ptr: bool, n_sm: int,
              fits: dict) -> tuple[int, int]:
    """The cheapest geometry (g, W) by span_cost among those that fit
    (fits[(g, W)] > 0 blocks an SM) with no more warps than strips and
    hand-off columns within PTR_BUDGET / SPAN_EDGE_SHARE; where none is
    that small, the fitting one with the fewest edge bytes."""
    cands = [(g, W) for (g, W), per_sm in sorted(fits.items())
             if per_sm > 0 and W <= span_plan(N, SPAN_K[g], 1)[0]]
    if not cands:
        raise RuntimeError(f"no span geometry fits an {N}-column bucket")
    cap = PTR_BUDGET // SPAN_EDGE_SHARE
    small = [c for c in cands
             if span_edge_bytes(n_inst, R, N, ptr, *c) <= cap]
    if not small:
        return min(cands, key=lambda c: span_edge_bytes(n_inst, R, N, ptr,
                                                        *c))
    return min(small, key=lambda c: span_cost(n_inst, R, N, ptr, *c,
                                               fits[c], n_sm))


def span_geometry(n_inst: int, R: int, N: int, ptr: bool,
                  geometry=None, fits=None) -> dict:
    """The launch geometry of K24 (ptr False; n_inst = B, R = M) or K25
    (n_inst = G*B row blocks of R rows) on the current card: `geometry`
    (g, W) or the pick.  `fits` (span_fits) are the launched kernel's
    when it is another span kernel priced as these (K22, ptr False).
    {"geometry", "K" (columns a lane), "warps" (strips a block),
    "strips" (a window's), "blocks" (an instance's), "blocks_per_sm",
    "waves", "cost_ns"}."""
    n_sm, fits = fits or span_fits("lm_span_fits", int(ptr))
    g, W = span_pick(n_inst, R, N, ptr, n_sm, fits) if geometry is None \
        else geometry
    S, C = span_plan(N, SPAN_K[g], W)
    per_sm = fits[(g, W)]
    return {"geometry": (g, W), "K": SPAN_K[g], "warps": W, "strips": S,
            "blocks": C, "blocks_per_sm": per_sm,
            "waves": -(-(n_inst * C) // max(1, per_sm * n_sm)),
            "cost_ns": span_cost(n_inst, R, N, ptr, g, W, max(1, per_sm),
                                 n_sm)}


def _span_scratch(lib, dev, B, G, R, N, geometry, ptr):
    """One scratch allocation of a span launch (ext_cum, its levels, the
    hand-off columns, the ticket), held by the caller until enqueued."""
    n = lib.lm_span_scratch_bytes(B, G, R, N, *geometry, int(ptr))
    if n < 0:
        raise ValueError(f"no span geometry {geometry}")
    return torch.empty((n,), dtype=torch.uint8, device=dev)


@cuda.launcher
def profile_forward_ckpt(p, q, p_len, q_len, gap_open: int = GAP_OPEN,
                         gap_extend: int = GAP_EXTEND, K: int = CKPT_ROWS,
                         *, geometry=None):
    """Checkpointed forward profile DP of a batch of windows: the score
    and the (H, F) carry every K rows, for the host walk over re-derived
    blocks when the full pointer tensor exceeds PTR_BUDGET.

    p: float32[B, M, 5] (M a multiple of K), q: float32[B, N, 5];
    p_len, q_len: int32[B].  Returns (score float32[B], equal bit for bit
    to profile_forward's; ck_h, ck_f float32[M/K, B, N+1]), as
    profile_forward_ckpt_plain.  CPU tensors take the plain version;
    CUDA tensors launch K24, strips over several blocks in the pick of
    span_geometry or in `geometry` (g, W)."""
    if p.device.type == "cpu":
        return profile_forward_ckpt_plain(p, q, p_len, q_len, gap_open,
                                          gap_extend, K)
    dev, B, M, N = _require_batch(p, q, p_len, q_len)
    if K < 1 or M % K:
        raise ValueError(f"M = {M} is not a multiple of K = {K}")
    lib = cuda.library()
    geo = span_geometry(B, M, N, False, geometry)["geometry"]
    scratch = _span_scratch(lib, dev, B, 1, M, N, geo, False)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    ck_h = torch.empty((M // K, B, N + 1), dtype=torch.float32, device=dev)
    ck_f = torch.empty_like(ck_h)
    cuda.check(lib.lm_profile_ckpt(
        p.data_ptr(), q.data_ptr(), p_len.data_ptr(), q_len.data_ptr(),
        scratch.data_ptr(), score.data_ptr(), ck_h.data_ptr(),
        ck_f.data_ptr(), B, M, N, K, float(gap_open), float(gap_extend),
        _W5_C, *geo, cuda.stream(p)), "lm_profile_ckpt")
    profile_forward_ckpt.launches += 1
    return score, ck_h, ck_f


profile_forward_ckpt.launches = 0


def profile_block_ptrs_plain(ck_h, ck_f, p_blk, q, q_len,
                             gap_open: int = GAP_OPEN,
                             gap_extend: int = GAP_EXTEND):
    """Plain PyTorch version of K25: profile_block_ptrs
    (ops/profile.py:141-151, ext_p_blk derived from p_blk as every caller
    derives it) over every column, then pack_ptrs."""
    B, R, _ = p_blk.shape
    N = q.shape[1]
    qw, ext_q, ext_cum = _q_setup(q, gap_extend)
    h, f = ck_h, ck_f
    ptrs = torch.empty((B, R, N + 1), dtype=torch.uint8, device=q.device)
    for i in range(R):
        h, f, ptrs[:, i] = _row_plain(h, f, p_blk[:, i], qw, ext_cum, ext_q,
                                      gap_open, gap_extend, True)
    return pack_ptrs_plain(ptrs)


def profile_block_ptrs_batch_plain(ck_h, ck_f, p, q, q_len, first: int,
                                   G: int, gap_open: int = GAP_OPEN,
                                   gap_extend: int = GAP_EXTEND):
    """Plain PyTorch version of the batched K25: profile_block_ptrs_plain
    of row blocks first .. first+G-1, stacked."""
    R = p.shape[1] // ck_h.shape[0]
    return torch.stack([profile_block_ptrs_plain(
        ck_h[bi], ck_f[bi], p[:, bi * R:(bi + 1) * R].contiguous(), q,
        q_len, gap_open, gap_extend) for bi in range(first, first + G)])


@cuda.launcher
def profile_block_ptrs_batch(ck_h, ck_f, p, q, q_len, first: int, G: int,
                             gap_open: int = GAP_OPEN,
                             gap_extend: int = GAP_EXTEND, *,
                             geometry=None):
    """Pointer bytes of G row blocks of a batch of windows at once, each
    re-derived from its carry, two cells a byte.

    ck_h, ck_f: float32[nb, B, N+1], the carries at the top of every
    R-row block (profile_forward_ckpt's); p: float32[B, nb*R, 5] the
    windows' rows; q: float32[B, N, 5]; q_len: int32[B].  Returns
    uint8[G, B, R, ceil((N+1)/2)]: blocks first .. first+G-1, cell 2k in
    the low nibble, every column written; ops.gapped.unpack_ptrs restores
    a block's uint8[B, R, N+1] in K3's layout.  CPU tensors take the
    plain version; CUDA tensors launch K25 (its launches are counted on
    profile_block_ptrs), every row block side by side, in the pick of
    span_geometry or in `geometry` (g, W)."""
    if q.device.type == "cpu":
        return profile_block_ptrs_batch_plain(ck_h, ck_f, p, q, q_len,
                                              first, G, gap_open, gap_extend)
    dev = q.device
    nb, B = ck_h.shape[:2]
    M, N = p.shape[1], q.shape[1]
    R = M // max(nb, 1)
    if nb < 1 or R * nb != M or first < 0 or G < 1 or first + G > nb:
        raise ValueError(f"blocks {first}..{first + G - 1} of {nb} over "
                         f"{M} rows")
    cuda.require(p, "p", torch.float32, dev, (B, M, 5))
    cuda.require(q, "q", torch.float32, dev, (B, N, 5))
    cuda.require(q_len, "q_len", torch.int32, dev, (B,))
    cuda.require(ck_h, "ck_h", torch.float32, dev, (nb, B, N + 1))
    cuda.require(ck_f, "ck_f", torch.float32, dev, (nb, B, N + 1))
    lib = cuda.library()
    geo = span_geometry(G * B, R, N, True, geometry)["geometry"]
    scratch = _span_scratch(lib, dev, B, G, R, N, geo, True)
    ptr = torch.empty((G, B, R, (N + 2) // 2), dtype=torch.uint8, device=dev)
    cuda.check(lib.lm_profile_block_ptrs(
        p.data_ptr(), q.data_ptr(), q_len.data_ptr(), ck_h[first].data_ptr(),
        ck_f[first].data_ptr(), scratch.data_ptr(), ptr.data_ptr(), B, M, N,
        R, first, G, float(gap_open), float(gap_extend), _W5_C, *geo,
        cuda.stream(q)), "lm_profile_block_ptrs")
    profile_block_ptrs.launches += 1
    return ptr


def profile_block_ptrs(ck_h, ck_f, p_blk, q, q_len,
                       gap_open: int = GAP_OPEN,
                       gap_extend: int = GAP_EXTEND, *, geometry=None):
    """Pointer bytes of a block of profile-DP rows, re-derived from their
    carry, two cells a byte: profile_block_ptrs_batch of one block (G =
    1).

    ck_h, ck_f: float32[B, N+1], the (H, F) carry at the block's top (a
    row of profile_forward_ckpt's checkpoints); p_blk: float32[B, R, 5]
    the block's profile rows; q: float32[B, N, 5]; q_len: int32[B].
    Returns uint8[B, R, ceil((N+1)/2)], cell 2k in the low nibble, every
    column written; ops.gapped.unpack_ptrs restores uint8[B, R, N+1] in
    K3's layout.  CPU tensors take the plain version; CUDA tensors launch
    K25."""
    if q.device.type == "cpu":
        return profile_block_ptrs_plain(ck_h, ck_f, p_blk, q, q_len,
                                        gap_open, gap_extend)
    return profile_block_ptrs_batch(ck_h[None], ck_f[None], p_blk, q, q_len,
                                    0, 1, gap_open, gap_extend,
                                    geometry=geometry)[0]


profile_block_ptrs.launches = 0


# --------------------------------------------------------------------------
# banded DP (ops/profile.py:246-303).  The inter-anchor and refine windows
# sit between chained anchors, so their optimal paths hug the
# corner-to-corner diagonal; a block-banded scan cuts DP cells 2-7x at
# the big column buckets.  EXACTNESS IS PRESERVED by a per-window
# certificate:
#
#   any alignment path through a cell more than H_W diagonals off the
#   straight (0,0)->(p_len,q_len) line contains at least
#   2*H_W - 3*|q_len-p_len| gap moves, each costing at least one
#   occupancy-scaled extend, plus one gap_open; its score is therefore
#   bounded by SumCap + gap_open + (the g_lb least negative extend
#   costs), where SumCap sums over q columns the best possible column
#   score (max over letters of W5 @ q_j, floored at 0).
#
# If the banded optimum beats that bound by BAND_MARGIN, every optimal
# path stays strictly inside the band, all DP values on it are the
# full-width DP's (same operations on the same floats), and the banded
# traceback equals the full one byte for byte.  Windows that fail the
# certificate re-run at full width.
# --------------------------------------------------------------------------

BAND_K = 128            # rows per band block
BAND_SMAX = 2           # max q_len/p_len slope eligible for banding
BAND_MIN_N = 1024       # smallest padded column bucket worth banding
BAND_MARGIN = 64.0      # certificate strictness slack (f32 safety)

# cumulative banding outcomes (windows counted once per banded attempt;
# "fallback" = eligible but uncertified -> full-width rerun)
BAND_STATS = {"eligible": 0, "certified": 0, "fallback": 0,
              "ineligible": 0}


def _band_note(elig: np.ndarray, okm: np.ndarray, n: int) -> None:
    BAND_STATS["eligible"] += int(elig[:n].sum())
    BAND_STATS["certified"] += int(okm[:n].sum())
    BAND_STATS["fallback"] += int((elig[:n] & ~okm[:n]).sum())
    BAND_STATS["ineligible"] += int(n - elig[:n].sum())


def _band_half(N: int) -> int:
    """Nominal half band width for an N-column bucket: wide enough that
    ~2%-divergent windows certify."""
    return max(127, N // 16 - 1)


def _band_wb(N: int) -> int:
    """Local band width WB: per 128-row block the band covers K*slope
    columns of diagonal drift plus the nominal band on both sides plus
    one guard column."""
    return band_width(_band_half(N))


def band_width(H_W: int) -> int:
    return BAND_K * BAND_SMAX + 2 * H_W + 2


def band_bucket(Mp: int, N: int) -> bool:
    """Whether an (Mp, N) bucket can run the banded DP at all."""
    return N >= BAND_MIN_N and Mp >= 2 * BAND_K and _band_wb(N) + 1 < N


def _band_eligible(p_len: np.ndarray, q_len: np.ndarray,
                   M: int, N: int) -> np.ndarray:
    """Host-side banding eligibility per batch element (the kernel runs
    on the whole batch; ineligible rows are just never trusted)."""
    if not band_bucket(M, N):
        return np.zeros(len(p_len), dtype=bool)
    pl = p_len.astype(np.int64)
    ql = q_len.astype(np.int64)
    return (pl > 0) & (ql > 0) & (ql <= BAND_SMAX * pl)


def _band_shape(p, q, H_W):
    B, Mp, _ = p.shape
    N = q.shape[1]
    WB = band_width(H_W)
    if Mp % BAND_K or WB + 1 >= N:
        raise ValueError(f"banded DP needs Mp % {BAND_K} == 0 and WB + 1 < "
                         f"N; got Mp={Mp}, N={N}, WB={WB}")
    return B, Mp, N, WB


def band_costs(p, q, p_len, q_len, gap_extend: int = GAP_EXTEND):
    """The certificate's per-window gap costs gap_extend * occupancy over
    rows < p_len and columns < q_len (-inf elsewhere), sorted descending:
    float32[B, Mp+N] (ops/profile.py:388-395; a library sort, as
    lax.sort was)."""
    B, Mp, _ = p.shape
    N = q.shape[1]
    dev = p.device
    m_rows = torch.arange(Mp, device=dev)[None, :] < p_len[:, None]
    n_cols = torch.arange(N, device=dev)[None, :] < q_len[:, None]
    cost_p = torch.where(m_rows, gap_extend * (1.0 - p[:, :, GAP_CODE]),
                         float("-inf"))
    cost_q = torch.where(n_cols, gap_extend * (1.0 - q[:, :, GAP_CODE]),
                         float("-inf"))
    return torch.sort(torch.cat([cost_p, cost_q], dim=1), dim=1,
                      descending=True).values


def banded_forward_plain(p, q, p_len, q_len, gap_open: int, gap_extend: int,
                         H_W: int, emit_ptr: bool = False):
    """Plain PyTorch version of K10 (emit_ptr=False) and K11: the banded
    block scan of ops/profile.py:306-407.  Block bi of 128 rows covers
    global columns lo..lo+WB, lo = clip((bi*128*q_len)//max(p_len, 1) -
    (H_W+1), 0, N-WB); carried rows shift with lo.  Returns (ptrs
    uint8[B, Mp, WB+1], zero outside rows 1..p_len and local columns
    0..clip(q_len-lo, 0, WB), or None; score float32[B]; cert bool[B])."""
    B, Mp, N, WB = _band_shape(p, q, H_W)
    dev = p.device
    qw, ext_q, ext_cum = _q_setup(q, gap_extend)
    j_idx = torch.arange(N + 1, device=dev)
    h0 = torch.where(j_idx[None, :] == 0, 0.0, gap_open + ext_cum)
    lo_cap = max(N - WB, 0)
    pl = p_len.to(torch.int64)
    plc = pl.clamp(min=1)
    ql = q_len.to(torch.int64)
    w_idx = torch.arange(WB + 1, device=dev)
    h = h0[:, :WB + 1].clone()
    f = torch.full_like(h, float(NEG_BIG))
    lo = torch.zeros(B, dtype=torch.int64, device=dev)
    score = h0.gather(1, ql[:, None])[:, 0]
    ptrs = torch.zeros((B, Mp, WB + 1), dtype=torch.uint8, device=dev) \
        if emit_ptr else None
    n_rows = int(pl.max()) if B else 0
    for bi in range(-(-n_rows // BAND_K)):
        lo_new = ((bi * BAND_K * ql) // plc - (H_W + 1)).clamp(0, lo_cap)
        src = w_idx[None, :] + (lo_new - lo)[:, None]
        ok = src <= WB
        srcc = src.clamp(max=WB)
        h = torch.where(ok, h.gather(1, srcc), float(NEG_BIG))
        f = torch.where(ok, f.gather(1, srcc), float(NEG_BIG))
        lo = lo_new
        colc = (lo[:, None] + w_idx[None, :WB]).clamp(max=N - 1)
        qw_loc = qw.gather(1, colc[:, :, None].expand(B, WB, 5))
        eq_loc = ext_q.gather(1, colc)
        cum_loc = ext_cum.gather(1, (lo[:, None] + w_idx[None, :]).clamp(
            max=N))
        qlen_loc = (ql - lo).clamp(0, WB)[:, None]
        col_ok = w_idx[None, :] <= qlen_loc
        for i in range(bi * BAND_K, min((bi + 1) * BAND_K, n_rows)):
            h, f, ptr_row = _row_plain(h, f, p[:, i], qw_loc, cum_loc,
                                       eq_loc, gap_open, gap_extend,
                                       emit_ptr)
            if emit_ptr:
                keep = col_ok & (i < pl)[:, None]
                ptrs[:, i] = torch.where(keep, ptr_row, 0)
            score = torch.where(pl == i + 1, h.gather(1, qlen_loc)[:, 0],
                                score)

    # optimality certificate (ops/profile.py:381-406): the prefix sums
    # and sumcap in the kernels' blocked order
    L = Mp + N
    costs = band_costs(p, q, p_len, q_len, gap_extend)
    csum = blocked_cumsum(torch.where(torch.isfinite(costs), costs, 0.0))
    g_lb = (2 * H_W - 3 * (ql - pl).abs()).clamp(min=0)
    gidx = (g_lb - 1).clamp(0, L - 1)
    gap_bound = torch.where(g_lb > 0, csum.gather(1, gidx[:, None])[:, 0],
                            0.0)
    n_cols = torch.arange(N, device=dev)[None, :] < ql[:, None]
    cap = qw.amax(dim=2).clamp(min=0.0)
    sumcap = blocked_cumsum(torch.where(n_cols, cap, 0.0))[:, -1]
    rhs = (sumcap + gap_open) + gap_bound
    cert = score > rhs + BAND_MARGIN
    return ptrs, score, cert


def _banded_launch(p, q, p_len, q_len, gap_open, gap_extend, H_W,
                   emit_ptr, geometry, bound=None):
    dev, B, Mp, N = _require_batch(p, q, p_len, q_len)
    _, _, _, WB = _band_shape(p, q, H_W)
    lib = cuda.library()
    f32 = dict(dtype=torch.float32, device=dev)
    stride = lib.lm_profile_cum_scratch(Mp + N)
    ptrs = torch.zeros((B, Mp, WB + 1), dtype=torch.uint8, device=dev) \
        if emit_ptr else None
    score = torch.empty((B,), **f32)
    cert = torch.empty((B,), dtype=torch.uint8, device=dev)
    # scratch, held by name until the launch is enqueued: ext_q, ext_cum,
    # cumsum levels, column caps
    scratch = (torch.empty((B, N), **f32), torch.empty((B, N + 1), **f32),
               torch.empty((B, stride), **f32), torch.empty((B, N), **f32))
    ext_q, ext_cum, cum_lv, capbuf = (t.data_ptr() for t in scratch)
    cuda.check(lib.lm_banded_fwd(
        p.data_ptr(), q.data_ptr(), p_len.data_ptr(), q_len.data_ptr(),
        ext_q, ext_cum, cum_lv, stride, capbuf,
        ptrs.data_ptr() if emit_ptr else None, score.data_ptr(),
        cert.data_ptr(), None if bound is None else bound.data_ptr(), B, Mp,
        N, H_W, float(gap_open), float(gap_extend), _W5_C, geometry,
        cuda.stream(p)), "lm_banded_fwd")
    return ptrs, score, cert.bool()


def band_geometry(H_W: int, emit_ptr: bool, B: int = 1, g: int = -1):
    """The launch geometry of K10 (emit_ptr False) or K11 for B windows at
    half band H_W on the current card: geometry g of csrc/banded.cu's
    table, or for g < 0 the one the launcher picks.  Returns None past
    the table's end, else {"geometry", "K" (band columns a lane),
    "warps" (a window), "qw_registers", "windows_per_sm"};
    windows_per_sm is 0 where geometry g does not fit the band."""
    out = (ctypes.c_int * 5)()
    rc = cuda.library().lm_banded_geometry(B, H_W, int(emit_ptr), g, out)
    if rc == -1:
        return None
    cuda.check(rc, "lm_banded_geometry")
    return {"geometry": out[0], "K": out[1], "warps": out[2],
            "qw_registers": bool(out[3]), "windows_per_sm": out[4]}


def banded_forward_scores_plain(p, q, p_len, q_len, gap_open: int,
                                gap_extend: int, H_W: int):
    """Plain PyTorch version of K10: (score, cert)."""
    return banded_forward_plain(p, q, p_len, q_len, gap_open, gap_extend,
                                H_W)[1:]


@cuda.launcher
def banded_forward_scores(p, q, p_len, q_len, gap_open: int,
                          gap_extend: int, H_W: int, *, geometry: int = -1):
    """Banded forward scores float32[B] and certificates bool[B]
    (_banded_forward_scores).  Scores of uncertified windows are lower
    bounds only; callers re-run those at full width.  p: float32[B, Mp,
    5] with Mp a multiple of 128.  CPU tensors take the plain version;
    CUDA tensors launch K10, in the launcher's geometry or in table
    entry `geometry` (band_geometry) where that is >= 0."""
    if p.device.type == "cpu":
        return banded_forward_scores_plain(p, q, p_len, q_len, gap_open,
                                           gap_extend, H_W)
    _, score, cert = _banded_launch(p, q, p_len, q_len, gap_open,
                                    gap_extend, H_W, False, geometry)
    banded_forward_scores.launches += 1
    return score, cert


banded_forward_scores.launches = 0


def banded_forward_ptrs_plain(p, q, p_len, q_len, gap_open: int,
                              gap_extend: int, H_W: int):
    """Plain PyTorch version of K11: (ptrs, score, cert)."""
    return banded_forward_plain(p, q, p_len, q_len, gap_open, gap_extend,
                                H_W, emit_ptr=True)


@cuda.launcher
def banded_forward_ptrs(p, q, p_len, q_len, gap_open: int, gap_extend: int,
                        H_W: int, *, geometry: int = -1):
    """Banded forward with pointer bytes uint8[B, Mp, WB+1], scores and
    certificates (the forward half of _banded_fwd_tb).  Pointers of
    certified windows walk to the full-width traceback.  CPU tensors take
    the plain version; CUDA tensors launch K11 (`geometry` as for
    banded_forward_scores)."""
    if p.device.type == "cpu":
        return banded_forward_ptrs_plain(p, q, p_len, q_len, gap_open,
                                         gap_extend, H_W)
    out = _banded_launch(p, q, p_len, q_len, gap_open, gap_extend, H_W,
                         True, geometry)
    banded_forward_ptrs.launches += 1
    return out


banded_forward_ptrs.launches = 0


def banded_traceback_walk_plain(ptrs, p_len, q_len, N: int, H_W: int,
                                T: int) -> WalkCodes:
    """Plain PyTorch version of K12: the walk of ops/profile.py:445-477,
    reading byte (i-1)*(WB+1) + clip(j - lo(i), 0, WB)."""
    Mp, W1 = ptrs.shape[1:]
    WB = W1 - 1
    lo_cap = max(N - WB, 0)
    plc = p_len.to(torch.int64).clamp(min=1)
    ql = q_len.to(torch.int64)

    def addr(i, j):
        bi = (i - 1).clamp(min=0) // BAND_K
        lo = ((bi * BAND_K * ql) // plc - (H_W + 1)).clamp(0, lo_cap)
        return (i - 1) * W1 + (j - lo).clamp(0, WB)

    return walk_plain(ptrs, p_len, q_len, T, addr, code_words(Mp, N))


@cuda.launcher
def banded_traceback_walk(ptrs, p_len, q_len, N: int, H_W: int, T: int, *,
                          geometry: int = -1) -> WalkCodes:
    """Affine traceback of every window over its banded pointers
    uint8[B, Mp, WB+1] (N: the bucket's columns).  Returns the windows'
    column codes in K4's form (WalkCodes), so tb_unpack serves both
    walks.  CPU tensors take the plain version; CUDA tensors launch K12,
    in the launcher's geometry or in table entry `geometry`
    (gapped.walk_geometry) where that is >= 0."""
    if ptrs.device.type == "cpu":
        return banded_traceback_walk_plain(ptrs, p_len, q_len, N, H_W, T)
    dev = ptrs.device
    B, Mp, W1 = ptrs.shape
    if W1 != band_width(H_W) + 1:
        raise ValueError(f"ptrs: {W1} columns, expected "
                         f"{band_width(H_W) + 1}")
    cuda.require(ptrs, "ptrs", torch.uint8, dev, (B, Mp, W1))
    cuda.require(p_len, "p_len", torch.int32, dev, (B,))
    cuda.require(q_len, "q_len", torch.int32, dev, (B,))
    check_walk_ptrs(ptrs)
    C16 = code_words(Mp, N)
    out = walk_outputs(B, C16, dev)
    cuda.check(cuda.library().lm_banded_walk(
        ptrs.data_ptr(), p_len.data_ptr(), q_len.data_ptr(), B, Mp, N, H_W,
        T, C16, out.words.data_ptr(), out.counts.data_ptr(),
        out.steps.data_ptr(), geometry, cuda.stream(ptrs)), "lm_banded_walk")
    banded_traceback_walk.launches += 1
    return out


banded_traceback_walk.launches = 0


# --------------------------------------------------------------------------
# batch entry points
# --------------------------------------------------------------------------

def padded_rows(M: int) -> int:
    """Rows of a bucket's launches: M rounded up to a multiple of
    min(128, M), as the JAX module pads them (ops/profile.py:748-749)."""
    K = min(BAND_K, M)
    return -(-M // K) * K


def plan_buckets(p_rows: list[np.ndarray], q_rows: list[np.ndarray]
                 ) -> list[tuple[int, int, list[int]]]:
    """Group pairs by padded column bucket: (M, N, pair indices)."""
    buckets: dict[tuple[int, int], list[int]] = {}
    for k in range(len(p_rows)):
        key = (_bucket_cols(p_rows[k].shape[1]),
               _bucket_cols(q_rows[k].shape[1]))
        buckets.setdefault(key, []).append(k)
    return [(M, N, idxs) for (M, N), idxs in buckets.items()]


def split_launch(idxs: list[int], cell_bytes: int) -> list[list[int]]:
    """Split pair indices so each launch moves at most PTR_BUDGET bytes
    of pointers at cell_bytes per window."""
    per = max(1, PTR_BUDGET // cell_bytes)
    return [idxs[s:s + per] for s in range(0, len(idxs), per)]


# windows sent through the checkpointed route (K24 + K25 + the host walk)
CKPT_STATS = {"windows": 0}


def ckpt_route(Mp: int, N: int) -> bool:
    """Whether an (Mp, N) bucket's full-width windows take the
    checkpointed route: one window's pointer tensor exceeds PTR_BUDGET."""
    return Mp * (N + 1) > PTR_BUDGET


def full_window_bytes(Mp: int, N: int) -> int:
    """Bytes one window adds to a full-width launch: its pointer tensor,
    or on the checkpointed route its (H, F) carries."""
    if ckpt_route(Mp, N):
        return 8 * (Mp // min(CKPT_ROWS, Mp)) * (N + 1)
    return Mp * (N + 1)


def block_batch(B: int, R: int, N: int, nb: int) -> int:
    """G, the row blocks of R rows a K25 launch of the checkpointed route
    computes side by side: as many as keep their packed pointers (B * R *
    ceil((N+1)/2) bytes a block) within PTR_BUDGET / PTR_BATCH_SHARE, at
    least 1 and at most the nb blocks there are."""
    per = B * R * ((N + 2) // 2)
    return max(1, min(nb, PTR_BUDGET // PTR_BATCH_SHARE // max(per, 1)))


def ckpt_tracebacks(p, q, p_len, q_len, gap_open: int = GAP_OPEN,
                    gap_extend: int = GAP_EXTEND, G: int | None = None):
    """The checkpointed route of a launch (ops/profile.py:814-831): K24's
    carries every K = min(128, Mp) rows, then the host walk
    traceback_blocks over each block's pointers from K25, nibble-packed.
    The walk asks for blocks from the last down; each K25 launch computes
    the G blocks below the one asked for (block_batch by default) side by
    side, and one copy brings them to the host, which unpacks each as the
    walk reaches it.  Returns the (p_gaps, q_gaps) masks of every window,
    as tb_unpack does for the full-width walk."""
    B, Mp, N = p.shape[0], p.shape[1], q.shape[1]
    K = min(CKPT_ROWS, Mp)
    nb = Mp // K
    if G is None:
        G = block_batch(B, K, N, nb)
    _, ck_h, ck_f = profile_forward_ckpt(p, q, p_len, q_len, gap_open,
                                         gap_extend, K)
    held = {}   # the latest launch's blocks on the host, packed

    def fetch(bi):
        if bi not in held:
            held.clear()
            lo = max(0, bi - G + 1)
            packed = profile_block_ptrs_batch(
                ck_h, ck_f, p, q, q_len, lo, bi + 1 - lo, gap_open,
                gap_extend).cpu().numpy()
            held.update((lo + k, packed[k]) for k in range(len(packed)))
        return unpack_ptrs(held[bi], N + 1)

    CKPT_STATS["windows"] += B
    return traceback_blocks(fetch, nb, K, p_len.cpu().numpy(),
                            q_len.cpu().numpy())


def plan_launches(p_rows: list[np.ndarray], q_rows: list[np.ndarray]
                  ) -> list[tuple[int, int, list[int]]]:
    """The launches of align_profile_batch: each bucket's pairs at
    Mp = padded_rows(M) rows, split so a launch's pointer tensor stays
    under PTR_BUDGET bytes (banded pointers where the bucket bands, full
    width otherwise, the carries on the checkpointed route; a banded
    launch's uncertified windows are split again at full width).
    Returns (Mp, N, pair indices) per launch."""
    launches = []
    for M, N, idxs in plan_buckets(p_rows, q_rows):
        Mp = padded_rows(M)
        cell = Mp * (_band_wb(N) + 1) if band_bucket(Mp, N) \
            else full_window_bytes(Mp, N)
        for sub in split_launch(idxs, cell):
            launches.append((Mp, N, sub))
    return launches


def pack_profiles(p_rows, q_rows, sub: list[int], M: int, N: int, device):
    """Zero-padded profile tensors of the pairs `sub` on `device`:
    (p float32[B, M, 5], q float32[B, N, 5], p_len, q_len int32[B])."""
    nb = len(sub)
    p = np.zeros((nb, M, 5), dtype=np.float32)
    q = np.zeros((nb, N, 5), dtype=np.float32)
    p_len = np.zeros(nb, dtype=np.int32)
    q_len = np.zeros(nb, dtype=np.int32)
    for r, k in enumerate(sub):
        cp, cq = p_rows[k].shape[1], q_rows[k].shape[1]
        p[r, :cp] = rows_to_profile(p_rows[k])
        q[r, :cq] = rows_to_profile(q_rows[k])
        p_len[r], q_len[r] = cp, cq
    return tuple(torch.from_numpy(x).to(device)
                 for x in (p, q, p_len, q_len))


def band_route(p_rows, q_rows, sub: list[int], Mp: int, N: int
               ) -> np.ndarray:
    """Band eligibility of the pairs `sub` in an (Mp, N) launch."""
    return _band_eligible(
        np.array([p_rows[k].shape[1] for k in sub], dtype=np.int32),
        np.array([q_rows[k].shape[1] for k in sub], dtype=np.int32), Mp, N)


def profile_scores_batch(p_rows: list[np.ndarray],
                         q_rows: list[np.ndarray],
                         gap_open: int = GAP_OPEN,
                         gap_extend: int = GAP_EXTEND,
                         device="cuda") -> np.ndarray:
    """Forward-only DP scores float64[B] of many (p, q) profile pairs on
    `device`, no traceback (ops/profile.py:530-599): the gate of
    score-gated refinement (msa.refine_windows).  Per bucket, the banded
    forward (K10) runs when any window is eligible; uncertified and
    ineligible windows re-run at full width (K9)."""
    B = len(p_rows)
    if B == 0:
        return np.zeros(0, np.float64)
    dev = cuda.resolve_device(device)
    out = np.zeros(B, dtype=np.float64)
    for M, N, idxs in plan_buckets(p_rows, q_rows):
        Mp = -(-M // BAND_K) * BAND_K
        todo = list(idxs)
        t = pack_profiles(p_rows, q_rows, todo, Mp, N, dev)
        elig = band_route(p_rows, q_rows, todo, Mp, N)
        if elig.any():
            score, cert = banded_forward_scores(*t, gap_open, gap_extend,
                                                _band_half(N))
            okm = elig & cert.cpu().numpy()
            _band_note(elig, okm, len(todo))
            sb = score.cpu().numpy()
            out[[k for r, k in enumerate(todo) if okm[r]]] = sb[okm]
            todo = [k for r, k in enumerate(todo) if not okm[r]]
            if not todo:
                continue
            t = pack_profiles(p_rows, q_rows, todo, Mp, N, dev)
        out[todo] = profile_forward_scores(*t, gap_open,
                                           gap_extend).cpu().numpy()
    return out


def profile_path_score(p_rows: np.ndarray, q_rows: np.ndarray,
                       gap_open: int = GAP_OPEN,
                       gap_extend: int = GAP_EXTEND) -> float:
    """DP-objective score of the CURRENT alignment of two row groups
    (the path the existing merged columns describe), under exactly the
    model the profile DP optimizes: expected-W5 substitution on
    both-present columns, affine gaps with occupancy-scaled extends.
    profile_scores_batch(optimal) <= this + tol  <=>  the DP cannot
    improve the pair, so its traceback can be skipped."""
    p_present = (p_rows != GAP_CODE).any(axis=0)
    q_present = (q_rows != GAP_CODE).any(axis=0)
    keep = p_present | q_present
    p_prof = rows_to_profile(p_rows)[keep]          # [C, 5]
    q_prof = rows_to_profile(q_rows)[keep]
    p_present = p_present[keep]
    q_present = q_present[keep]
    diag = p_present & q_present
    w = W5.astype(np.float64)
    sub = float(np.einsum("cx,xy,cy->", p_prof[diag].astype(np.float64),
                          w, q_prof[diag].astype(np.float64)))
    ext_p = gap_extend * (1.0 - p_prof[:, GAP_CODE].astype(np.float64))
    ext_q = gap_extend * (1.0 - q_prof[:, GAP_CODE].astype(np.float64))
    f_move = p_present & ~q_present     # consume p col, gap in q
    e_move = q_present & ~p_present
    gaps = 0.0
    for move, ext in ((f_move, ext_p), (e_move, ext_q)):
        opens = int((move & ~np.concatenate([[False], move[:-1]])).sum())
        gaps += opens * gap_open + float(ext[move].sum())
    return sub + gaps


def profile_path_scores_single(rows: np.ndarray,
                               gap_open: int = GAP_OPEN,
                               gap_extend: int = GAP_EXTEND
                               ) -> np.ndarray:
    """Path scores of ALL G single-row bipartitions of one window in one
    vectorized pass: float64[G], entry g equal (to fp-summation order)
    to profile_path_score(rows[g:g+1], rows[others]).  The column count
    matrix and its W5 contraction are computed once and each row's score
    falls out of count arithmetic."""
    G, C = rows.shape
    if G < 2 or C == 0:
        return np.zeros(G, dtype=np.float64)
    w = W5.astype(np.float64)
    # column counts over all rows
    cnt = np.zeros((5, C), dtype=np.int64)
    for a in range(5):
        cnt[a] = (rows == a).sum(axis=0)
    nongap = (G - cnt[GAP_CODE]).astype(np.int64)     # non-gap rows/col
    t = w @ cnt.astype(np.float64)                    # [5, C]
    wdiag = np.diag(w)                                # [5]
    inv = 1.0 / (G - 1)
    col = np.arange(C)

    out = np.empty(G, dtype=np.float64)
    for g in range(G):
        rg = rows[g]
        p_present = rg != GAP_CODE
        q_present = (nongap - p_present) > 0
        keep = p_present | q_present
        diag = p_present & q_present
        # substitution: one-hot p row against the others' count profile
        tg = t[rg, col] - wdiag[rg]
        sub = float((tg[diag]).sum() * inv)
        # affine gaps on kept columns (runs merge across dropped cols)
        f_move = (p_present & ~q_present)[keep]
        e_move = (~p_present & q_present)[keep]
        opens = int((f_move & ~np.concatenate([[False],
                                               f_move[:-1]])).sum()) \
            + int((e_move & ~np.concatenate([[False],
                                             e_move[:-1]])).sum())
        # ext_p = gap_extend at f_move cols (p is one-hot non-gap there)
        gaps = opens * gap_open + gap_extend * float(f_move.sum())
        # ext_q = gap_extend * (1 - others_gap/(G-1)); at e_move columns
        # p is a gap, so others_gap = total_gap - 1
        e_cols = (~p_present & q_present)
        if e_cols.any():
            others_gap = cnt[GAP_CODE][e_cols] - 1
            gaps += gap_extend * float(
                (1.0 - others_gap.astype(np.float64) * inv).sum())
        out[g] = sub + gaps
    return out


def dp_mesh():
    """The mesh that splits the window DP's batches (ops/profile.py:167):
    every visible CUDA device when there are two or more, else None, so
    on one card the batches run whole as before.  The AlignLCBInParallel
    parallelism (Aligner.cpp:1293-1367) over devices instead of
    threads."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        return None
    from libmems_tpu_torch.parallel.shard import Mesh
    return Mesh([torch.device("cuda", i) for i in range(count)])


def mesh_slices(B: int, n_dev: int) -> list[slice]:
    """A batch of B windows cut into n_dev contiguous slices of
    ceil(B / n_dev) windows, the last ones shorter or empty, as the JAX
    module's shard_map cuts its batch padded to at least n_dev windows
    (ops/profile.py:752); the port's kernels take any batch, so no
    padding window is added."""
    per = max(1, -(-B // n_dev))
    return [slice(min(d * per, B), min((d + 1) * per, B))
            for d in range(n_dev)]


def banded_scores_split(p, q, p_len, q_len, gap_open: int, gap_extend: int,
                        H_W: int, mesh):
    """banded_forward_scores with the batch split over the mesh's devices
    (_shard_banded_scores, ops/profile.py:492): each device scores its
    contiguous slice of the windows (K10), and the scores and
    certificates come back in window order on p's device."""
    scores, certs = [], []
    for sl, dev in zip(mesh_slices(p.shape[0], mesh.size), mesh.devices):
        if sl.start == sl.stop:
            continue
        with cuda.on(dev):
            score, cert = banded_forward_scores(
                *(t[sl].to(dev) for t in (p, q, p_len, q_len)), gap_open,
                gap_extend, H_W)
        scores.append(score.to(p.device))
        certs.append(cert.to(p.device))
    return torch.cat(scores), torch.cat(certs)


def _align_launch(p_rows, q_rows, sub: list[int], Mp: int, N: int, dev,
                  gap_open: int, gap_extend: int, results: list):
    """One launch of align_profile_batch on `dev`: the banded forward
    (K11) and walk (K12) where a window is eligible, then K3 and K4, or
    the checkpointed route, for the rest; merged rows into results.  A
    generator: it yields after queueing each device pass and before
    reading it back, so that a caller can queue every device's first pass
    before it waits on any; run it to its end."""
    t = pack_profiles(p_rows, q_rows, sub, Mp, N, dev)
    T = _device_tb_T(Mp, N)
    todo = sub
    elig = band_route(p_rows, q_rows, sub, Mp, N)
    if elig.any():
        H_W = _band_half(N)
        ptrs, _, cert = banded_forward_ptrs(*t, gap_open, gap_extend, H_W)
        walk = banded_traceback_walk(ptrs, t[2], t[3], N, H_W, T)
        del ptrs
        yield
        okm = elig & cert.cpu().numpy()
        _band_note(elig, okm, len(sub))
        rs = np.flatnonzero(okm).tolist()
        for r, (p_gaps, q_gaps) in zip(rs, tb_unpack(walk, rs)):
            k = sub[r]
            results[k] = merge_rows(p_rows[k], q_rows[k], p_gaps, q_gaps)
        todo = [k for r, k in enumerate(sub) if not okm[r]]
    for chunk in split_launch(todo, full_window_bytes(Mp, N)):
        if chunk != sub:
            t = pack_profiles(p_rows, q_rows, chunk, Mp, N, dev)
        if ckpt_route(Mp, N):
            tb = ckpt_tracebacks(*t, gap_open, gap_extend)
        else:
            ptrs, _ = profile_forward(*t, gap_open, gap_extend)
            walk = traceback_walk(ptrs, t[2], t[3], T)
            del ptrs
            yield
            tb = tb_unpack(walk, len(chunk))
        for k, (p_gaps, q_gaps) in zip(chunk, tb):
            results[k] = merge_rows(p_rows[k], q_rows[k], p_gaps, q_gaps)


def align_profile_batch(p_rows: list[np.ndarray], q_rows: list[np.ndarray],
                        gap_open: int = GAP_OPEN,
                        gap_extend: int = GAP_EXTEND,
                        device="cuda", mesh="auto") -> list[np.ndarray]:
    """Align many (p, q) alignment-row groups on `device`.

    p_rows[k] / q_rows[k]: uint8[G_k, C_k] code rows (4 = gap).  Returns
    per pair merged rows uint8[Gp_k + Gq_k, C'_k].  In a launch with an
    eligible window the banded forward (K11) and walk (K12) run first;
    certified windows take their traceback (byte-identical to full
    width), the others re-run through K3 and K4 (ops/profile.py:768-843),
    or, where one window's full pointer tensor exceeds PTR_BUDGET, through
    the checkpointed route (ckpt_tracebacks: K24, K25 and the host walk).

    With a mesh (a parallel.Mesh; "auto", the default, is dp_mesh() on a
    CUDA device, else None) each launch's windows are cut into
    mesh.size contiguous slices (mesh_slices), each run as above on its
    own device (the _shard_* wrappers of ops/profile.py), every slice's
    first device pass queued before any is read back; windows are
    independent, so the merged rows do not change."""
    if not p_rows:
        return []
    dev = cuda.resolve_device(device)
    if isinstance(mesh, str) and mesh == "auto":
        mesh = dp_mesh() if dev.type == "cuda" else None
    devices = [dev] if mesh is None else mesh.devices
    results: list = [None] * len(p_rows)
    for Mp, N, sub in plan_launches(p_rows, q_rows):
        runs = []
        for sl, d in zip(mesh_slices(len(sub), len(devices)), devices):
            if sl.start < sl.stop:
                run = _align_launch(p_rows, q_rows, sub[sl], Mp, N, d,
                                    gap_open, gap_extend, results)
                with cuda.on(d):
                    next(run, None)
                runs.append((d, run))
        for d, run in runs:
            with cuda.on(d):
                for _ in run:
                    pass
    return results


def merge_rows(p_rows: np.ndarray, q_rows: np.ndarray,
               p_gaps: np.ndarray, q_gaps: np.ndarray) -> np.ndarray:
    """Interleave two row groups along the merged column axis given their
    gap masks (True = insert an all-gap column on that side)."""
    C = len(p_gaps)
    Gp, Gq = p_rows.shape[0], q_rows.shape[0]
    out = np.full((Gp + Gq, C), GAP_CODE, dtype=np.uint8)
    out[:Gp, ~p_gaps] = p_rows
    out[Gp:, ~q_gaps] = q_rows
    return out
