"""Batched pairwise global alignment with affine gaps (Gotoh DP): kernels
K22 (forward with checkpoints) and K23 (pointer bytes of row blocks,
many a launch), both strips over several blocks in csrc/gotoh.cu, and
the traceback walk K4 (csrc/gapped.cu).

Port of libmems_tpu/ops/gapped.py, the replacement for the reference's
in-process MUSCLE calls on inter-anchor gap regions
(MuscleInterface::Align / CallMuscleFast, libMems/MuscleInterface.cpp):
the reference's default scoring (HOXD70 substitution matrix, gap open
-400, gap extend -30; libMems/SubstitutionMatrix.h:23-35), the matrix
file reader, the pointer byte layout, and ``align_pairs`` /
``align_score``.  The int32 DP runs row by row; the in-row E dependency
is the max-plus prefix E[j] = ext*j + cummax_{k<j}(G'[k] + open - ext*k).
``align_pairs`` takes one of two routes per length bucket, as the JAX
module does: when the bucket's full pointer tensor fits DEVICE_TB_BUDGET
bytes, K23 derives every row's pointers from the first row and K4 walks
them on the device; otherwise K22 keeps the (H, F) carry every
CKPT_ROWS rows and the host walk ``traceback_blocks`` fetches the
blocks' pointers from K23, nibble-packed, the G blocks below the one it
asks for in one launch and one copy.  The profile aligner uses K4 and
the pointer layout too.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from libmems_tpu_torch import cuda

# HOXD70 (A,C,G,T), libMems/SubstitutionMatrix.h:23-32
HOXD70 = np.array([
    [91, -114, -31, -123],
    [-114, 100, -125, -31],
    [-31, -125, 100, -114],
    [-123, -31, -114, 91],
], dtype=np.int32)
GAP_OPEN = -400    # SubstitutionMatrix.h:34
GAP_EXTEND = -30   # SubstitutionMatrix.h:35

NEG_INF = -(1 << 30)


def read_substitution_matrix(path_or_fh) -> np.ndarray:
    """Parse the reference's substitution-matrix file format
    (readSubstitutionMatrix, libMems/SubstitutionMatrix.h:76-107):
    one header line, an 'A C G T N' column-label line, then four rows
    of 'letter s(A) s(C) s(G) s(T) s(N)' (the N column is ignored).
    Returns int32[4, 4]."""
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh) if own else path_or_fh
    try:
        fh.readline()                       # header info
        labels = fh.readline().split()
        if labels[:5] != ["A", "C", "G", "T", "N"]:
            raise ValueError("Invalid substitution matrix format")
        out = np.zeros((4, 4), dtype=np.int32)
        for i in range(4):
            tok = fh.readline().split()
            out[i] = [int(x) for x in tok[1:5]]
        return out
    finally:
        if own:
            fh.close()


# pointer byte layout: bits 0-1 the H source, then the extend bits
H_DIAG, H_E, H_F = 0, 1, 2
E_EXT_BIT = 4
F_EXT_BIT = 8

CKPT_ROWS = 128   # forward-carry checkpoint spacing (traceback block)

# align_pairs walks a bucket on the device when its full pointer tensor
# (Bpad * Mp * (N+1) bytes) fits this budget; above it, the host walks
# checkpointed blocks.  A module constant, as tests patch it.
DEVICE_TB_BUDGET = 1 << 30


def _device_tb_T(M: int, N: int) -> int:
    """Steps that bound a walk over an M x N pointer tensor: every step
    consumes a row or a column or enters E/F, which happens at most once
    per emitted column."""
    t = 2 * (M + N) + 4
    return -(-t // 8) * 8


class WalkCodes(NamedTuple):
    """The output of a traceback walk (K4, K12 and their plain versions):
    per window its 2-bit column codes (0 aligned, 1 gap in a, 2 gap in
    b) in column order, right-aligned in its row of words: column c of
    a row of 16 * C16 codes is bits 2*(c % 16) of word c // 16, and the
    window's alignment is its last counts[b] columns; the words left of
    them are 0."""
    words: torch.Tensor    # int32[B, C16]
    counts: torch.Tensor   # int32[B]: columns emitted
    steps: torch.Tensor    # int32[B]: steps taken (at most T)


def code_words(M: int, N: int) -> int:
    """Words of a window's code row: a walk over M rows and N columns
    emits at most M + N columns, 16 a word."""
    return -(-(M + N) // 16)


def traceback_walk_plain(ptrs: torch.Tensor, p_len: torch.Tensor,
                         q_len: torch.Tensor, T: int) -> WalkCodes:
    """Plain PyTorch version of K4: the state machine of
    ops/gapped.py:230-254, all windows in lockstep for T steps."""
    M, N1 = ptrs.shape[1:]
    return walk_plain(ptrs, p_len, q_len, T, lambda i, j: (i - 1) * N1 + j,
                      code_words(M, N1 - 1))


def walk_plain(ptrs: torch.Tensor, p_len: torch.Tensor, q_len: torch.Tensor,
               T: int, addr, C16: int) -> WalkCodes:
    """The lockstep affine traceback over pointer bytes ptrs[B, R, W]:
    addr(i, j) gives each window's byte offset of DP cell (i, j) within
    its R*W bytes (clamped here).  Each emitted column's code goes to
    column 16*C16 - 1 - (columns emitted before it) of the window's row,
    and the rows are packed 16 codes a word."""
    B, M, N1 = ptrs.shape
    dev = ptrs.device
    C = 16 * C16
    flat = ptrs.reshape(B, M * N1)
    i = p_len.to(torch.int64).clone()
    j = q_len.to(torch.int64).clone()
    st = torch.zeros(B, dtype=torch.int64, device=dev)
    cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    taken = torch.zeros(B, dtype=torch.int64, device=dev)
    codes = torch.zeros((B, C + 1), dtype=torch.int64, device=dev)
    for t in range(T):
        active = (i > 0) | (j > 0)
        if t % 64 == 0 and not bool(active.any()):
            break   # every walk is done
        c0 = active & (i == 0)
        c1 = active & (i > 0) & (j == 0)
        c2 = active & (i > 0) & (j > 0)
        lin = addr(i, j).clamp(0, max(M * N1 - 1, 0))
        byte = flat.gather(1, lin[:, None])[:, 0].to(torch.int64) \
            if M * N1 else torch.zeros_like(i)
        was_h = c2 & (st == 0)
        was_e = c2 & (st == 1)
        was_f = c2 & (st == 2)
        newst = byte & 3
        dm = was_h & (newst == 0)
        emit = c0 | c1 | dm | was_e | was_f
        code = (c0 | was_e).to(torch.int64) + 2 * (c1 | was_f).to(
            torch.int64)
        # columns not emitted this step write to the spare column C
        pos = torch.where(emit, C - 1 - cnt, C)
        codes.scatter_(1, pos[:, None], code[:, None])
        cnt += emit.to(torch.int64)
        taken += active.to(torch.int64)
        i = i - (c1 | dm | was_f).to(torch.int64)
        j = j - (c0 | dm | was_e).to(torch.int64)
        st = torch.where(
            was_h, newst,
            torch.where(was_e, ((byte & E_EXT_BIT) != 0).to(torch.int64),
                        torch.where(was_f,
                                    2 * ((byte & F_EXT_BIT) != 0).to(
                                        torch.int64), st)))
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=dev)
    words = (codes[:, :C].reshape(B, C16, 16) << shifts).sum(-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return WalkCodes(words.to(torch.int32), cnt.to(torch.int32),
                     taken.to(torch.int32))


def walk_geometry(kind: str, B: int, M: int, N: int, g: int = -1):
    """The launch geometry of K4 (kind "full": M rows of N+1 pointer
    bytes) or K12 (kind "banded": M rows at half band N) for B windows
    on the current card: geometry g of csrc/walk.cuh's table, or for
    g < 0 the one the launcher picks.  Returns None past the table's
    end, else {"geometry", "rows" (a slab), "depth" (slabs in the ring),
    "cols" (a slab; 0 for whole rows), "warps" (windows a block, 0 where
    geometry g does not fit), "smem" (bytes a block)}."""
    out = (ctypes.c_int * 6)()
    lib = cuda.library()
    fn = lib.lm_traceback_geometry if kind == "full" else \
        lib.lm_banded_walk_geometry
    rc = fn(B, M, N, g, out)
    if rc == -1:
        return None
    cuda.check(rc, fn.__name__)
    return dict(zip(("geometry", "rows", "depth", "cols", "warps", "smem"),
                    out))


def walk_outputs(B: int, C16: int, dev) -> WalkCodes:
    """Unfilled output buffers of a walk launch (the kernel writes every
    word), in one allocation."""
    buf = torch.empty(B * (C16 + 2), dtype=torch.int32, device=dev)
    return WalkCodes(buf[:B * C16].view(B, C16), buf[B * C16:B * (C16 + 1)],
                     buf[B * (C16 + 1):])


def check_walk_ptrs(ptrs: torch.Tensor) -> None:
    """The walks stage pointer rows with 16-byte copies from the tensor's
    start."""
    if ptrs.data_ptr() % 16:
        raise ValueError("ptrs: the walk needs a 16-byte aligned tensor")


@cuda.launcher
def traceback_walk(ptrs: torch.Tensor, p_len: torch.Tensor,
                   q_len: torch.Tensor, T: int, *,
                   geometry: int = -1) -> WalkCodes:
    """Affine traceback of every window over its full pointer tensor.

    ptrs: uint8[B, M, N+1] (pointer row i-1 holds DP row i); p_len,
    q_len: int32[B]; T bounds the steps.  Returns the windows' column
    codes (WalkCodes; tb_unpack decodes them).  CPU tensors take the
    plain version; CUDA tensors launch K4, in the launcher's geometry or
    in table entry `geometry` (walk_geometry) where that is >= 0."""
    if ptrs.device.type == "cpu":
        return traceback_walk_plain(ptrs, p_len, q_len, T)
    dev = ptrs.device
    B, M, N1 = ptrs.shape
    cuda.require(ptrs, "ptrs", torch.uint8, dev, (B, M, N1))
    cuda.require(p_len, "p_len", torch.int32, dev, (B,))
    cuda.require(q_len, "q_len", torch.int32, dev, (B,))
    check_walk_ptrs(ptrs)
    C16 = code_words(M, N1 - 1)
    out = walk_outputs(B, C16, dev)
    cuda.check(cuda.library().lm_traceback(
        ptrs.data_ptr(), p_len.data_ptr(), q_len.data_ptr(), B, M, N1 - 1,
        T, C16, out.words.data_ptr(), out.counts.data_ptr(),
        out.steps.data_ptr(), geometry, cuda.stream(ptrs)), "lm_traceback")
    traceback_walk.launches += 1
    return out


traceback_walk.launches = 0

_CODE_SHIFTS = np.array([0, 2, 4, 6], dtype=np.uint8)


def tb_unpack(walk: WalkCodes, n_pairs):
    """Host tail of the walk: each window's (a_gaps, b_gaps) bool arrays
    in column order (the contract of the JAX package's tb_unpack /
    traceback_blocks), decoded from its contiguous code row.
    `n_pairs` is a count of leading windows or a list of window
    indices."""
    ks = list(range(n_pairs)) if isinstance(n_pairs, int) else list(n_pairs)
    if not ks:
        return []
    words = walk.words.cpu().numpy()
    counts = walk.counts.cpu().numpy()
    sel = np.ascontiguousarray(words[ks]).view(np.uint8)
    codes = ((sel[:, :, None] >> _CODE_SHIFTS) & 3).reshape(len(ks), -1)
    a_all, b_all = codes == 1, codes == 2
    C = codes.shape[1]
    return [(a_all[r, C - n:].copy(), b_all[r, C - n:].copy())
            for r, n in enumerate(counts[ks].tolist())]


# --------------------------------------------------------------------------
# pairwise Gotoh DP (K22, K23)
# --------------------------------------------------------------------------

def _gotoh_h0f0(B: int, N: int, gap_open: int, gap_extend: int, device):
    """The DP's first row: H[0][j] = open + ext*j (0 at j = 0), F = -inf."""
    j = torch.arange(N + 1, dtype=torch.int32, device=device)
    h0 = torch.where(j == 0, 0, gap_open + gap_extend * j).to(torch.int32)
    f0 = torch.full((B, N + 1), NEG_INF, dtype=torch.int32, device=device)
    return h0[None].expand(B, N + 1).contiguous(), f0


def _gotoh_rows(h, f, a, b, gap_open: int, gap_extend: int, emit_ptr: bool,
                on_row=None):
    """The row scan of ops/gapped.py:_gotoh_row_fn over the rows of
    a[B, R], from the carry (h, f) int32[B, N+1].  Calls on_row(r, h, f)
    after each row; with emit_ptr returns the pointer bytes uint8[B, R,
    N+1], else None.  Codes are 0..3 (align_pairs and align_score check);
    like the kernels, the scan clamps larger ones so that no read leaves
    the matrix."""
    B, R = a.shape
    N = b.shape[1]
    dev = b.device
    sub = torch.from_numpy(HOXD70).to(dev)
    oe = gap_open + gap_extend
    ext = gap_extend
    j_idx = torch.arange(N + 1, dtype=torch.int32, device=dev)
    b_scores = sub[:, b.long().clamp(max=3)]               # [4, B, N]
    ext_j = ext * j_idx[1:]                                 # [N]
    w_off = ext * j_idx[:-1]
    rows_b = torch.arange(B, device=dev)
    ptrs = torch.zeros((B, R, N + 1), dtype=torch.uint8, device=dev) \
        if emit_ptr else None
    a_l = a.long().clamp(max=3)
    for r in range(R):
        f_ext = f + ext
        f_row = torch.maximum(h + oe, f_ext)
        s = b_scores[a_l[:, r], rows_b]                     # [B, N]
        diag = h[:, :-1] + s
        g = torch.maximum(diag, f_row[:, 1:])
        g0 = f_row[:, :1]
        gp = torch.cat([g0, g[:, :-1]], dim=1)
        w = gp + gap_open - w_off[None]
        e_row = ext_j[None] + torch.cummax(w, dim=1).values
        h_row_1 = torch.maximum(g, e_row)
        h_row = torch.cat([g0, h_row_1], dim=1)
        if emit_ptr:
            f_bit = (f_row == f_ext) & (f > NEG_INF // 2)
            e_bit = e_row[:, 1:] == e_row[:, :-1] + ext
            h_src = torch.where(h_row_1 == diag, H_DIAG,
                                torch.where(h_row_1 == e_row, H_E, H_F))
            p = ptrs[:, r]
            p[:, 0] = H_F
            p[:, 1:] = h_src.to(torch.uint8)
            p[:, 2:] |= torch.where(e_bit, E_EXT_BIT, 0).to(torch.uint8)
            p |= torch.where(f_bit, F_EXT_BIT, 0).to(torch.uint8)
        h, f = h_row, f_row
        if on_row is not None:
            on_row(r, h, f)
    return ptrs


def gotoh_forward_plain(a, b, a_len, b_len, gap_open: int, gap_extend: int,
                        K: int, carries: bool = True):
    """Plain PyTorch version of K22: _gotoh_forward_ckpt's row scan.
    Returns (score int32[B], ck_h, ck_f int32[Mp/K, B, N+1] or None)."""
    B, M = a.shape
    N = b.shape[1]
    dev = b.device
    h0, f0 = _gotoh_h0f0(B, N, gap_open, gap_extend, dev)
    nb = M // K
    ck_h = torch.empty((nb, B, N + 1), dtype=torch.int32, device=dev) \
        if carries else None
    ck_f = torch.empty_like(ck_h) if carries else None
    al = a_len.long()
    bl = b_len.long()[:, None]
    score = torch.where(al == 0, h0.gather(1, bl)[:, 0], 0)

    def on_row(r, h, f):
        nonlocal score
        score = torch.where(al == r + 1, h.gather(1, bl)[:, 0], score)
        if carries and (r + 1) % K == 0 and r + 1 < M:
            ck_h[(r + 1) // K] = h
            ck_f[(r + 1) // K] = f

    if carries and nb:
        ck_h[0] = h0
        ck_f[0] = f0
    _gotoh_rows(h0, f0, a, b, gap_open, gap_extend, False, on_row)
    return score.to(torch.int32), ck_h, ck_f


def _gotoh_sub() -> ctypes.Array:
    """HOXD70 as the host int[16] the launchers copy into the kernel."""
    return (ctypes.c_int * 16)(*HOXD70.reshape(-1).tolist())


def gotoh_geometry(n_inst: int, M: int, N: int, geometry=None,
                   ptr: bool = False) -> dict:
    """The launch geometry of K22 (n_inst = B pairs of M rows) or, with
    `ptr`, K23 (n_inst = G x B row blocks of M rows) in an N-column
    bucket on the current card: `geometry` (g, W) or the pick, K24's or
    K25's (ops.profile.span_geometry on K22's or K23's fits: they hand on
    two and three words a row as K24 and K25 do, and are priced by their
    SPAN_COST).  Its keys, and "rows" (gotoh_band_rows)."""
    from libmems_tpu_torch.ops import profile   # profile imports this module
    geo = profile.span_geometry(n_inst, M, N, ptr, geometry,
                                profile.span_fits("lm_gotoh_fits", int(ptr)))
    if geo["blocks_per_sm"] < 1:
        raise ValueError(f"K{23 if ptr else 22} geometry {geo['geometry']} "
                         f"does not fit the card")
    geo["rows"] = gotoh_band_rows(n_inst, M, geo["blocks"], ptr)
    return geo


def gotoh_band_rows(n_inst: int, M: int, C: int, ptr: bool = False) -> int:
    """The rows a K22 (K23 with `ptr`) launch of n_inst instances of C
    blocks takes: all M where its hand-off columns (16 bytes a row, 24
    for K23, at each of an instance's C - 1 block edges) fit the span
    kernels' cap, PTR_BUDGET / SPAN_EDGE_SHARE bytes, else the most that
    do (at least one); the rest follow in launches of as many rows."""
    from libmems_tpu_torch.ops import profile
    per_row = (24 if ptr else 16) * n_inst * (C - 1)
    cap = profile.PTR_BUDGET // profile.SPAN_EDGE_SHARE
    return M if per_row * M <= cap else max(1, min(M, cap // per_row))


@cuda.launcher
def gotoh_forward(a, b, a_len, b_len, gap_open: int = GAP_OPEN,
                  gap_extend: int = GAP_EXTEND, K: int = CKPT_ROWS,
                  carries: bool = True, *, geometry=None):
    """Checkpointed forward DP of many pairs.

    a: uint8[B, M] with M a multiple of K; b: uint8[B, N]; a_len, b_len:
    int32[B].  Returns (score int32[B], the H at (a_len, b_len); ck_h,
    ck_f int32[M/K, B, N+1], the (H, F) carries at the top of each K-row
    block, or None when not `carries`).  CPU tensors take the plain
    version; CUDA tensors launch K22, strips over several blocks in the
    pick of gotoh_geometry or in `geometry` (g, W).

    Besides its outputs K22 takes B (C - 1) R 16 bytes of hand-off
    columns for a launch of R rows (C: the blocks a pair, gotoh_geometry),
    zeroed before each launch, score only too.  R is M up to the cap of
    gotoh_band_rows, 64 MiB; above it the rows run as bands of R rows,
    each launch starting from the (H, F) row the one before it wrote
    (another 16 B (N+1) bytes), so the scratch stays at the cap."""
    if b.device.type == "cpu":
        return gotoh_forward_plain(a, b, a_len, b_len, gap_open, gap_extend,
                                   K, carries)
    dev = b.device
    B, M = a.shape
    N = b.shape[1]
    if K < 1 or M % K:
        raise ValueError(f"M = {M} is not a multiple of K = {K}")
    cuda.require(a, "a", torch.uint8, dev, (B, M))
    cuda.require(b, "b", torch.uint8, dev, (B, N))
    cuda.require(a_len, "a_len", torch.int32, dev, (B,))
    cuda.require(b_len, "b_len", torch.int32, dev, (B,))
    score = torch.zeros(B, dtype=torch.int32, device=dev)
    ck_h = ck_f = None
    if carries:
        ck_h = torch.empty((M // K, B, N + 1), dtype=torch.int32, device=dev)
        ck_f = torch.empty_like(ck_h)
    geo = gotoh_geometry(B, M, N, geometry)
    rows = geo["rows"]
    lib = cuda.library()
    # held by name until the launches are queued (ground rule of cuda.py)
    work = torch.empty((lib.lm_gotoh_scratch_bytes(B, rows, N,
                                                   *geo["geometry"], 0),),
                       dtype=torch.uint8, device=dev)
    # the (H, F) row between bands, [band parity, H or F, B, N+1]
    edge = torch.empty((2, 2, B, N + 1), dtype=torch.int32, device=dev) \
        if rows < M else None
    for k, r0 in enumerate(range(0, M, rows) if M else [0]):
        R = min(rows, M - r0)
        h_in = edge[(k - 1) % 2] if r0 else (None, None)
        h_out = edge[k % 2] if r0 + R < M else (None, None)
        cuda.check(lib.lm_gotoh_fwd(
            a.data_ptr(), b.data_ptr(), a_len.data_ptr(), b_len.data_ptr(),
            B, M, N, K, r0, R, gap_open, gap_extend, _gotoh_sub(),
            score.data_ptr(), ck_h.data_ptr() if carries else None,
            ck_f.data_ptr() if carries else None,
            *(x.data_ptr() if x is not None else None
              for x in (*h_in, *h_out)),
            work.data_ptr(), *geo["geometry"], cuda.stream(b)),
            "lm_gotoh_fwd")
        gotoh_forward.launches += 1
    return score, ck_h, ck_f


gotoh_forward.launches = 0


def pack_ptrs_plain(p):
    """pack_ptrs: two 4-bit cells a byte, cell 2k in the low nibble, a
    zero pad cell at odd widths."""
    if p.shape[2] % 2:
        p = torch.cat([p, torch.zeros(p.shape[:2] + (1,), dtype=torch.uint8,
                                      device=p.device)], dim=2)
    return p[:, :, 0::2] | (p[:, :, 1::2] << 4)


def unpack_ptrs(packed: np.ndarray, width: int) -> np.ndarray:
    """Host inverse of pack_ptrs."""
    out = np.empty(packed.shape[:2] + (packed.shape[2] * 2,), np.uint8)
    out[:, :, 0::2] = packed & 0xF
    out[:, :, 1::2] = packed >> 4
    return out[:, :, :width]


def gotoh_block_ptrs_plain(ck_h, ck_f, a_blk, b, gap_open: int,
                           gap_extend: int, packed: bool = False):
    """Plain PyTorch version of K23: _gotoh_block_ptrs (then pack_ptrs
    when `packed`)."""
    B, R = a_blk.shape
    if ck_h is None:
        ck_h, ck_f = _gotoh_h0f0(B, b.shape[1], gap_open, gap_extend,
                                 b.device)
    p = _gotoh_rows(ck_h, ck_f, a_blk, b, gap_open, gap_extend, True)
    return pack_ptrs_plain(p) if packed else p


def gotoh_block_ptrs_batch_plain(ck_h, ck_f, a, b, first: int, G: int,
                                 gap_open: int = GAP_OPEN,
                                 gap_extend: int = GAP_EXTEND,
                                 packed: bool = True):
    """Plain PyTorch version of the batched K23: gotoh_block_ptrs_plain of
    row blocks first .. first+G-1, stacked (block 0 from the DP's first
    row, as the kernel makes it)."""
    R = a.shape[1] // ck_h.shape[0]
    return torch.stack([gotoh_block_ptrs_plain(
        ck_h[bi] if bi else None, ck_f[bi] if bi else None,
        a[:, bi * R:(bi + 1) * R].contiguous(), b, gap_open, gap_extend,
        packed) for bi in range(first, first + G)])


def _ptr_launches(a, b, h_in, f_in, r0: int, R: int, G: int,
                  from_top: bool, out, gap_open: int, gap_extend: int,
                  geometry) -> None:
    """K23's launches: row blocks k < G of every pair, rows r0 + k R + 1
    .. r0 + (k + 1) R of a[B, M], from the (H, F) rows h_in, f_in [G, B,
    N+1] (None: block 0 from the DP's first row, G = 1; with from_top
    block 0 starts there whatever h_in holds), into out [G, B, R, width]
    (width N+1, or ceil((N+1)/2) packed).  The rows run in bands of
    gotoh_band_rows where the hand-off columns pass the cap, each band
    from the rows the one before it wrote; one count a launch on
    gotoh_block_ptrs.launches."""
    dev = b.device
    B, M = a.shape
    N = b.shape[1]
    width = out.shape[-1]
    geo = gotoh_geometry(G * B, R, N, geometry, ptr=True)
    rows = geo["rows"]
    lib = cuda.library()
    # held by name until the launches are queued (ground rule of cuda.py)
    work = torch.empty((lib.lm_gotoh_scratch_bytes(G * B, rows, N,
                                                   *geo["geometry"], 1),),
                       dtype=torch.uint8, device=dev)
    # the (H, F) rows between bands, [band parity, H or F, G, B, N+1]
    edge = torch.empty((2, 2, G, B, N + 1), dtype=torch.int32, device=dev) \
        if rows < R else None
    sub = _gotoh_sub()
    for k, lo in enumerate(range(0, R, rows)):
        n = min(rows, R - lo)
        h = (h_in, f_in) if lo == 0 else edge[(k - 1) % 2]
        o = edge[k % 2] if lo + n < R else (None, None)
        cuda.check(lib.lm_gotoh_block_ptrs(
            a.data_ptr(), b.data_ptr(), B, M, N, r0 + lo, R, n, G,
            int(from_top and lo == 0),
            *(x.data_ptr() if x is not None else None for x in (*h, *o)),
            gap_open, gap_extend, sub, int(width != N + 1),
            out.data_ptr() + lo * width, R, work.data_ptr(),
            *geo["geometry"], cuda.stream(b)), "lm_gotoh_block_ptrs")
        gotoh_block_ptrs.launches += 1


@cuda.launcher
def gotoh_block_ptrs_batch(ck_h, ck_f, a, b, first: int, G: int,
                           gap_open: int = GAP_OPEN,
                           gap_extend: int = GAP_EXTEND,
                           packed: bool = True, *, geometry=None):
    """Pointer bytes of G row blocks of a batch of pairs at once, each
    re-derived from its carry.

    ck_h, ck_f: int32[nb, B, N+1], the carries at the top of every R-row
    block (gotoh_forward's); a: uint8[B, nb*R]; b: uint8[B, N].  Returns
    uint8[G, B, R, ceil((N+1)/2)] (two cells a byte, cell 2k in the low
    nibble; unpack_ptrs restores a block's uint8[B, R, N+1]), or without
    `packed` uint8[G, B, R, N+1]: blocks first .. first+G-1 in the layout
    of ops/gapped.py:124-136, every row and column written, block 0 from
    the DP's first row.  CPU tensors take the plain version; CUDA tensors
    launch K23 (its launches are counted on gotoh_block_ptrs), every row
    block side by side, in the pick of gotoh_geometry or in `geometry`
    (g, W)."""
    if b.device.type == "cpu":
        return gotoh_block_ptrs_batch_plain(ck_h, ck_f, a, b, first, G,
                                            gap_open, gap_extend, packed)
    dev = b.device
    nb, B = ck_h.shape[:2]
    M, N = a.shape[1], b.shape[1]
    R = M // max(nb, 1)
    if nb < 1 or R < 1 or R * nb != M or first < 0 or G < 1 or \
            first + G > nb:
        raise ValueError(f"blocks {first}..{first + G - 1} of {nb} over "
                         f"{M} rows")
    cuda.require(a, "a", torch.uint8, dev, (B, M))
    cuda.require(b, "b", torch.uint8, dev, (B, N))
    cuda.require(ck_h, "ck_h", torch.int32, dev, (nb, B, N + 1))
    cuda.require(ck_f, "ck_f", torch.int32, dev, (nb, B, N + 1))
    width = (N + 2) // 2 if packed else N + 1
    ptr = torch.empty((G, B, R, width), dtype=torch.uint8, device=dev)
    _ptr_launches(a, b, ck_h[first], ck_f[first], first * R, R, G,
                  first == 0, ptr, gap_open, gap_extend, geometry)
    return ptr


@cuda.launcher
def gotoh_block_ptrs(ck_h, ck_f, a_blk, b, gap_open: int = GAP_OPEN,
                     gap_extend: int = GAP_EXTEND, packed: bool = False, *,
                     geometry=None):
    """Pointer bytes of a block of DP rows, re-derived from its carry: the
    batched K23 of one block (G = 1), or from the DP's first row.

    ck_h, ck_f: int32[B, N+1], the (H, F) carry at the block's top, or
    both None to start from the DP's first row (align_pairs' full route:
    every row of a bucket); a_blk: uint8[B, R] the block's symbols; b:
    uint8[B, N].  Returns uint8[B, R, N+1] in the layout of
    ops/gapped.py:124-136, or with `packed` uint8[B, R, ceil((N+1)/2)],
    two cells a byte.  CPU tensors take the plain version; CUDA tensors
    launch K23 in the pick of gotoh_geometry or in `geometry` (g, W), in
    bands of rows where its hand-off columns pass the cap."""
    if b.device.type == "cpu":
        return gotoh_block_ptrs_plain(ck_h, ck_f, a_blk, b, gap_open,
                                      gap_extend, packed)
    dev = b.device
    B, R = a_blk.shape
    N = b.shape[1]
    cuda.require(a_blk, "a_blk", torch.uint8, dev, (B, R))
    cuda.require(b, "b", torch.uint8, dev, (B, N))
    if (ck_h is None) != (ck_f is None):
        raise ValueError("give both carries or neither")
    if ck_h is not None:
        cuda.require(ck_h, "ck_h", torch.int32, dev, (B, N + 1))
        cuda.require(ck_f, "ck_f", torch.int32, dev, (B, N + 1))
    width = (N + 2) // 2 if packed else N + 1
    ptr = torch.empty((B, R, width), dtype=torch.uint8, device=dev)
    if R:
        _ptr_launches(a_blk, b, ck_h, ck_f, 0, R, 1, ck_h is None, ptr,
                      gap_open, gap_extend, geometry)
    return ptr


gotoh_block_ptrs.launches = 0


def traceback_blocks(fetch_block, nb: int, K: int, a_len: np.ndarray,
                     b_len: np.ndarray):
    """Batched affine traceback over checkpointed pointer blocks.

    fetch_block(bi) must return uint8[B, K, N+1] pointer rows for global
    rows bi*K+1 .. (bi+1)*K.  All pairs step in lockstep (vectorized
    numpy over the batch); per-pair gap masks come back as lists of
    (a_gaps, b_gaps) bool arrays, True = gap column.  Semantics are
    identical to the scalar per-cell traceback of the full-pointer
    formulation (state machine over H/E/F with extend bits)."""
    B = len(a_len)
    i = np.asarray(a_len, dtype=np.int64).copy()
    j = np.asarray(b_len, dtype=np.int64).copy()
    st = np.zeros(B, dtype=np.int64)
    rec_step: list[np.ndarray] = []
    rec_agap: list[np.ndarray] = []
    rec_bgap: list[np.ndarray] = []
    for bi in range(nb - 1, -1, -1):
        lo = bi * K
        boundary_ok = (i > 0) | (j > 0) if bi == 0 else np.zeros(B, bool)
        if not (np.any(i > lo) or np.any(boundary_ok)):
            continue
        P = fetch_block(bi)
        while True:
            if bi == 0:
                active = (i > 0) | (j > 0)
            else:
                active = i > lo
            if not active.any():
                break
            a_gap = np.zeros(B, bool)
            b_gap = np.zeros(B, bool)
            step = np.zeros(B, bool)
            c0 = active & (i == 0)                     # leading b columns
            a_gap |= c0
            j = np.where(c0, j - 1, j)
            c1 = active & (i > 0) & (j == 0)           # leading a columns
            b_gap |= c1
            i = np.where(c1, i - 1, i)
            c2 = active & (i > 0) & (j > 0)
            step |= c0 | c1
            if c2.any():
                idx = np.flatnonzero(c2)
                byte = np.zeros(B, np.int64)
                byte[idx] = P[idx, i[idx] - lo - 1, j[idx]]
                was_h = c2 & (st == 0)
                was_e = c2 & (st == 1)
                was_f = c2 & (st == 2)
                newst = byte & 3
                dm = was_h & (newst == 0)              # diagonal move
                step |= dm
                i = np.where(dm, i - 1, i)
                j = np.where(dm, j - 1, j)
                st = np.where(was_h, newst, st)        # enter E/F, no emit
                # E: gap in a, consume b column
                a_gap |= was_e
                step |= was_e
                j = np.where(was_e, j - 1, j)
                st = np.where(was_e,
                              np.where((byte & E_EXT_BIT) != 0, 1, 0), st)
                # F: gap in b, consume a row
                b_gap |= was_f
                step |= was_f
                i = np.where(was_f, i - 1, i)
                st = np.where(was_f,
                              np.where((byte & F_EXT_BIT) != 0, 2, 0), st)
            rec_step.append(step)
            rec_agap.append(a_gap)
            rec_bgap.append(b_gap)
    if rec_step:
        steps = np.stack(rec_step)       # [T, B]
        agaps = np.stack(rec_agap)
        bgaps = np.stack(rec_bgap)
    else:
        steps = np.zeros((0, B), bool)
        agaps = bgaps = steps
    out = []
    for k in range(B):
        sel = steps[:, k]
        out.append((agaps[sel, k][::-1].copy(),
                    bgaps[sel, k][::-1].copy()))
    return out


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b <<= 1
    return b


def _check_codes(*seqs) -> None:
    """The DP scores A, C, G, T (codes 0..3) only; the JAX package's
    gathers read out of the matrix for anything else."""
    for x in seqs:
        if len(x) and int(np.max(x)) > 3:
            raise ValueError("pairwise DP codes must be 0..3 (A, C, G, T)")


def plan_pairs(pairs: list[tuple[np.ndarray, np.ndarray]]):
    """The launches of align_pairs, as the JAX package plans them: pairs
    bucketed by padded length (a power of two, at least 32), each bucket
    padded to a power of two of at least 8 pairs and to Mp rows, a
    multiple of K = min(CKPT_ROWS, M).  Yields (pair indices, a uint8[Bpad,
    Mp], b uint8[Bpad, N], a_len, b_len int32[Bpad], K, device_walk) on
    the host; device_walk is True when the bucket's full pointer tensor
    fits DEVICE_TB_BUDGET bytes."""
    buckets: dict[tuple[int, int], list[int]] = {}
    for idx, (a, b) in enumerate(pairs):
        _check_codes(a, b)
        key = (_bucket(len(a)), _bucket(len(b)))
        buckets.setdefault(key, []).append(idx)
    for (M, N), idxs in buckets.items():
        Bpad = _bucket(len(idxs), 8)
        K = min(CKPT_ROWS, M)
        Mp = -(-M // K) * K
        a_arr = np.zeros((Bpad, Mp), dtype=np.uint8)
        b_arr = np.zeros((Bpad, N), dtype=np.uint8)
        a_len = np.zeros(Bpad, dtype=np.int32)
        b_len = np.zeros(Bpad, dtype=np.int32)
        for row, idx in enumerate(idxs):
            a, b = pairs[idx]
            a_arr[row, :len(a)] = a
            b_arr[row, :len(b)] = b
            a_len[row], b_len[row] = len(a), len(b)
        yield (idxs, a_arr, b_arr, a_len, b_len, K,
               Bpad * Mp * (N + 1) <= DEVICE_TB_BUDGET)


def _block_fetch(ck_h, ck_f, a, b, gap_open: int, gap_extend: int):
    """traceback_blocks' fetch on the checkpointed route: asked for block
    bi, one K23 launch computes the G blocks bi - G + 1 .. bi
    (ops.profile.block_batch) side by side, one copy brings them to the
    host packed, and each is unpacked when the walk reaches it."""
    from libmems_tpu_torch.ops import profile
    nb, B, N1 = ck_h.shape
    G = profile.block_batch(B, a.shape[1] // nb, N1 - 1, nb)
    held = {}   # the latest launch's blocks, packed

    def fetch(bi):
        if bi not in held:
            held.clear()
            lo = max(0, bi - G + 1)
            packed = gotoh_block_ptrs_batch(
                ck_h, ck_f, a, b, lo, bi + 1 - lo, gap_open,
                gap_extend).cpu().numpy()
            held.update((lo + k, packed[k]) for k in range(len(packed)))
        return unpack_ptrs(held[bi], N1)
    return fetch


@cuda.entry(cuda.device_arg)
def align_pairs(pairs: list[tuple[np.ndarray, np.ndarray]],
                gap_open: int = GAP_OPEN, gap_extend: int = GAP_EXTEND,
                device="cuda") -> list[tuple[np.ndarray, np.ndarray]]:
    """Globally align many (a_codes, b_codes) pairs on `device`.

    Returns per pair (a_gap_mask, b_gap_mask): boolean arrays over
    alignment columns, True where that row has a gap.  Launches follow
    plan_pairs, so every one sees the JAX arrays' shapes."""
    if not pairs:
        return []
    dev = cuda.resolve_device(device)
    results: list = [None] * len(pairs)
    for idxs, a_arr, b_arr, a_len, b_len, K, device_walk in \
            plan_pairs(pairs):
        Mp, N = a_arr.shape[1], b_arr.shape[1]
        aj = torch.from_numpy(a_arr).to(dev)
        bj = torch.from_numpy(b_arr).to(dev)
        alj = torch.from_numpy(a_len).to(dev)
        blj = torch.from_numpy(b_len).to(dev)
        if device_walk:
            # the full pointer tensor fits: derive it from the first row
            # and walk it on the device (the fetch is the column codes)
            ptrs = gotoh_block_ptrs(None, None, aj, bj, gap_open,
                                    gap_extend)
            tb = tb_unpack(traceback_walk(ptrs, alj, blj,
                                          _device_tb_T(Mp, N)), len(idxs))
        else:
            _, ck_h, ck_f = gotoh_forward(aj, bj, alj, blj, gap_open,
                                          gap_extend, K)
            tb = traceback_blocks(
                _block_fetch(ck_h, ck_f, aj, bj, gap_open, gap_extend),
                Mp // K, K, a_len, b_len)
        for row, idx in enumerate(idxs):
            results[idx] = tb[row]
    return results


@cuda.entry(cuda.device_arg)
def align_score(a: np.ndarray, b: np.ndarray, gap_open: int = GAP_OPEN,
                gap_extend: int = GAP_EXTEND, device="cuda") -> int:
    """Score-only global alignment of one pair on `device` (K22 without
    its carries)."""
    dev = cuda.resolve_device(device)
    _check_codes(a, b)
    M, N = _bucket(len(a)), _bucket(len(b))
    K = min(CKPT_ROWS, M)
    Mp = -(-M // K) * K
    a_arr = np.zeros((1, Mp), np.uint8)
    b_arr = np.zeros((1, N), np.uint8)
    a_arr[0, :len(a)] = a
    b_arr[0, :len(b)] = b
    score, _, _ = gotoh_forward(
        torch.from_numpy(a_arr).to(dev), torch.from_numpy(b_arr).to(dev),
        torch.tensor([len(a)], dtype=torch.int32, device=dev),
        torch.tensor([len(b)], dtype=torch.int32, device=dev), gap_open,
        gap_extend, K, carries=False)
    return int(score[0])
