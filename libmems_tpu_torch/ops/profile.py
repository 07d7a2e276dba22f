"""Batched profile-profile global alignment with affine gaps (kernel K3,
csrc/profile.cu, plus the traceback walk K4 of ops.gapped).

Port of the full-width path of libmems_tpu/ops/profile.py, the compute
core of the MSA engine that replaces the reference's in-process MUSCLE
profile alignment (MuscleInterface::ProfileAlignFast,
libMems/MuscleInterface.cpp:1053).  A profile is a column distribution
over (A, C, G, T, gap); the substitution score of two columns is the
expected HOXD70 score ``p_i . W5 . q_j``, and gap-extend costs scale
with the partner column's non-gap occupancy.

Windows are grouped by padded column bucket (``_bucket_cols``) into
launches; a bucket's batch is split so each launch's pointer tensor
B*M*(N+1) stays under PTR_BUDGET bytes (one window at the 10,000-column
cap buckets to 11,664 columns, 136 MB, so one window always fits).
Windows are independent and padding never reaches a window's traceback,
so neither the grouping nor the split changes an output.  The JAX
module's banded path is exact by its certificate and its checkpointed
path is exact by construction; running every window at full width
therefore gives the same bytes, and both are left to later work
(ROADMAP queue 2).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch.ops.gapped import (E_EXT_BIT, F_EXT_BIT, GAP_EXTEND,
                                          GAP_OPEN, H_DIAG, H_E, H_F,
                                          HOXD70, _device_tb_T, tb_unpack,
                                          traceback_walk)

GAP_CODE = 4

# 5x5 expected-score matrix: HOXD70 over ACGT; a gap in an input profile
# column contributes 0 to the cross term (gap costs are carried by the
# affine gap machinery, not the substitution score).
W5 = np.zeros((5, 5), dtype=np.float32)
W5[:4, :4] = HOXD70.astype(np.float32)

NEG_BIG = np.float32(-1e30)

PTR_BUDGET = 1 << 30          # bytes of pointer tensor per launch
# windows whose rows need more shared memory than this keep them in
# global scratch instead (csrc/profile.cu: 17 bytes per column)
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
    (csrc/profile.cu)."""
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


def profile_forward_plain(p, q, p_len, q_len, gap_open: int = GAP_OPEN,
                          gap_extend: int = GAP_EXTEND):
    """Plain PyTorch version of K3: the row scan of ops/profile.py:49-93
    (emit_ptr=True) over rows 1..max(p_len).  qw, the row scores and
    ext_cum are formed in one fixed order of float32 operations
    (profile_qw, profile_row_score, blocked_cumsum), which K3 repeats, so
    fractional profiles give K3 the same bytes.  Returns (ptrs uint8[B,
    M, N+1], zero outside each window's rows 1..p_len and columns
    0..q_len; score float32[B] = H[p_len][q_len])."""
    B, M, _ = p.shape
    N = q.shape[1]
    dev = p.device
    w = torch.from_numpy(W5).to(dev)
    ext_q = gap_extend * (1.0 - q[:, :, GAP_CODE])             # [B, N]
    qw = profile_qw(q, w)                                       # [B, N, 5]
    ext_cum = torch.cat([torch.zeros((B, 1), dtype=torch.float32,
                                     device=dev),
                         blocked_cumsum(ext_q)], dim=1)
    j_idx = torch.arange(N + 1, device=dev)
    h = torch.where(j_idx[None, :] == 0, 0.0, gap_open + ext_cum)
    f = torch.full_like(h, float(NEG_BIG))
    ext_p = gap_extend * (1.0 - p[:, :, GAP_CODE])              # [B, M]
    ql = q_len.to(torch.int64)[:, None]
    pl = p_len.to(torch.int64)
    col_ok = j_idx[None, :] <= ql
    score = h.gather(1, ql)[:, 0]
    ptrs = torch.zeros((B, M, N + 1), dtype=torch.uint8, device=dev)
    n_rows = int(pl.max()) if B else 0
    for i in range(n_rows):
        ext_pi = ext_p[:, i][:, None]
        f_open = h + gap_open + ext_pi
        f_ext = f + ext_pi
        f_row = torch.maximum(f_open, f_ext)
        s = profile_row_score(p[:, i], qw)                      # [B, N]
        diag = h[:, :-1] + s
        g = torch.maximum(diag, f_row[:, 1:])
        g0 = f_row[:, :1]
        gp = torch.cat([g0, g[:, :-1]], dim=1)
        wk = gp + gap_open - ext_cum[:, :-1]
        e_row = ext_cum[:, 1:] + torch.cummax(wk, dim=1).values
        h_row_1 = torch.maximum(g, e_row)
        h_row = torch.cat([g0, h_row_1], dim=1)

        f_ext_bit = (f_row == f_ext) & (f > float(NEG_BIG) / 2)
        e_ext_bit = torch.cat([
            torch.zeros((B, 1), dtype=torch.bool, device=dev),
            e_row[:, 1:] == e_row[:, :-1] + ext_q[:, 1:]], dim=1)
        h_src = torch.where(h_row_1 == diag, H_DIAG,
                            torch.where(h_row_1 == e_row, H_E, H_F))
        ptr = h_src | torch.where(e_ext_bit, E_EXT_BIT, 0) \
            | torch.where(f_ext_bit[:, 1:], F_EXT_BIT, 0)
        ptr_j0 = H_F | torch.where(f_ext_bit[:, :1], F_EXT_BIT, 0)
        ptr_row = torch.cat([ptr_j0, ptr], dim=1).to(torch.uint8)
        keep = col_ok & (i < pl)[:, None]
        ptrs[:, i] = torch.where(keep, ptr_row, 0)
        h, f = h_row, f_row
        score = torch.where(pl == i + 1, h.gather(1, ql)[:, 0], score)
    return ptrs, score


def profile_forward(p, q, p_len, q_len, gap_open: int = GAP_OPEN,
                    gap_extend: int = GAP_EXTEND):
    """Profile DP forward with pointer bytes for a batch of windows.

    p: float32[B, M, 5], q: float32[B, N, 5] (zero-padded profiles);
    p_len, q_len: int32[B].  Returns (ptrs uint8[B, M, N+1], score
    float32[B]) as profile_forward_plain does.  CPU tensors take the
    plain version; CUDA tensors launch K3."""
    if p.device.type == "cpu":
        return profile_forward_plain(p, q, p_len, q_len, gap_open,
                                     gap_extend)
    dev = p.device
    B, M, _ = p.shape
    N = q.shape[1]
    cuda.require(p, "p", torch.float32, dev, (B, M, 5))
    cuda.require(q, "q", torch.float32, dev, (B, N, 5))
    cuda.require(p_len, "p_len", torch.int32, dev, (B,))
    cuda.require(q_len, "q_len", torch.int32, dev, (B,))
    lib = cuda.library()
    f32 = dict(dtype=torch.float32, device=dev)
    qw = torch.empty((B, 5, N), **f32)
    ext_q = torch.empty((B, N), **f32)
    ext_cum = torch.empty((B, N + 1), **f32)
    cum_lv = torch.empty((B, lib.lm_profile_cum_scratch(N)), **f32)
    rows = flags = None
    if lib.lm_profile_row_bytes(N) > PROFILE_SMEM_LIMIT:
        rows = torch.empty((B, 4, N + 1), **f32)
        flags = torch.empty((B, N + 1), dtype=torch.uint8, device=dev)
    ptrs = torch.zeros((B, M, N + 1), dtype=torch.uint8, device=dev)
    score = torch.empty((B,), **f32)
    w5 = (ctypes.c_float * 25)(*W5.ravel().tolist())
    cuda.check(lib.lm_profile_fwd(
        p.data_ptr(), q.data_ptr(), p_len.data_ptr(), q_len.data_ptr(),
        qw.data_ptr(), ext_q.data_ptr(), ext_cum.data_ptr(),
        cum_lv.data_ptr(), rows.data_ptr() if rows is not None else None,
        flags.data_ptr() if flags is not None else None,
        ptrs.data_ptr(), score.data_ptr(), B, M, N, float(gap_open),
        float(gap_extend), w5, cuda.stream(p)), "lm_profile_fwd")
    profile_forward.launches += 1
    return ptrs, score


profile_forward.launches = 0


def plan_launches(p_rows: list[np.ndarray], q_rows: list[np.ndarray]
                  ) -> list[tuple[int, int, list[int]]]:
    """Group pairs by padded column bucket (M, N) and split each group so
    a launch's pointer tensor stays under PTR_BUDGET bytes.  Returns
    (M, N, pair indices) per launch."""
    buckets: dict[tuple[int, int], list[int]] = {}
    for k in range(len(p_rows)):
        key = (_bucket_cols(p_rows[k].shape[1]),
               _bucket_cols(q_rows[k].shape[1]))
        buckets.setdefault(key, []).append(k)
    launches = []
    for (M, N), idxs in buckets.items():
        per_launch = max(1, PTR_BUDGET // (M * (N + 1)))
        for s0 in range(0, len(idxs), per_launch):
            launches.append((M, N, idxs[s0:s0 + per_launch]))
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


def align_profile_batch(p_rows: list[np.ndarray], q_rows: list[np.ndarray],
                        gap_open: int = GAP_OPEN,
                        gap_extend: int = GAP_EXTEND,
                        device="cuda") -> list[np.ndarray]:
    """Align many (p, q) alignment-row groups on `device`.

    p_rows[k] / q_rows[k]: uint8[G_k, C_k] code rows (4 = gap).  Returns
    per pair merged rows uint8[Gp_k + Gq_k, C'_k]."""
    if not p_rows:
        return []
    dev = cuda.resolve_device(device)
    results: list = [None] * len(p_rows)
    for M, N, sub in plan_launches(p_rows, q_rows):
        p, q, pl, ql = pack_profiles(p_rows, q_rows, sub, M, N, dev)
        ptrs, _ = profile_forward(p, q, pl, ql, gap_open, gap_extend)
        masks = traceback_walk(ptrs, pl, ql, _device_tb_T(M, N))
        del ptrs
        for k, (p_gaps, q_gaps) in zip(sub, tb_unpack(masks, len(sub))):
            results[k] = merge_rows(p_rows[k], q_rows[k], p_gaps, q_gaps)
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
