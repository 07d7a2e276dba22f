"""Affine-gap scoring constants and the traceback walk (kernel K4,
csrc/gapped.cu).

Port of the part of libmems_tpu/ops/gapped.py that the profile aligner
uses: the reference's default scoring (HOXD70 substitution matrix, gap
open -400, gap extend -30; libMems/SubstitutionMatrix.h:23-35), the
pointer byte layout, and the lockstep affine traceback over a full
pointer tensor (_device_tb_scan).  The pairwise int32 Gotoh DP
(align_pairs) is not ported yet (ROADMAP queue 2).
"""

from __future__ import annotations

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

# pointer byte layout: bits 0-1 the H source, then the extend bits
H_DIAG, H_E, H_F = 0, 1, 2
E_EXT_BIT = 4
F_EXT_BIT = 8


def _device_tb_T(M: int, N: int) -> int:
    """Steps that bound a walk over an M x N pointer tensor: every step
    consumes a row or a column or enters E/F, which happens at most once
    per emitted column."""
    t = 2 * (M + N) + 4
    return -(-t // 8) * 8


def traceback_walk_plain(ptrs: torch.Tensor, p_len: torch.Tensor,
                         q_len: torch.Tensor, T: int):
    """Plain PyTorch version of K4: the state machine of
    ops/gapped.py:230-254, all windows in lockstep for T steps.
    Returns bool (steps, a_gaps, b_gaps), each [T, B]."""
    N1 = ptrs.shape[2]
    return walk_plain(ptrs, p_len, q_len, T, lambda i, j: (i - 1) * N1 + j)


def walk_plain(ptrs: torch.Tensor, p_len: torch.Tensor, q_len: torch.Tensor,
               T: int, addr):
    """The lockstep affine traceback over pointer bytes ptrs[B, R, W]:
    addr(i, j) gives each window's byte offset of DP cell (i, j) within
    its R*W bytes (clamped here).  Returns bool (steps, a_gaps, b_gaps),
    each [T, B]."""
    B, M, N1 = ptrs.shape
    dev = ptrs.device
    flat = ptrs.reshape(B, M * N1)
    i = p_len.to(torch.int64).clone()
    j = q_len.to(torch.int64).clone()
    st = torch.zeros(B, dtype=torch.int64, device=dev)
    steps = torch.zeros((T, B), dtype=torch.bool, device=dev)
    agaps = torch.zeros((T, B), dtype=torch.bool, device=dev)
    bgaps = torch.zeros((T, B), dtype=torch.bool, device=dev)
    for t in range(T):
        active = (i > 0) | (j > 0)
        if t % 64 == 0 and not bool(active.any()):
            break   # every walk is done; the remaining steps stay zero
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
        agaps[t] = c0 | was_e
        bgaps[t] = c1 | was_f
        steps[t] = c0 | c1 | dm | was_e | was_f
        i = i - (c1 | dm | was_f).to(torch.int64)
        j = j - (c0 | dm | was_e).to(torch.int64)
        st = torch.where(
            was_h, newst,
            torch.where(was_e, ((byte & E_EXT_BIT) != 0).to(torch.int64),
                        torch.where(was_f,
                                    2 * ((byte & F_EXT_BIT) != 0).to(
                                        torch.int64), st)))
    return steps, agaps, bgaps


def traceback_walk(ptrs: torch.Tensor, p_len: torch.Tensor,
                   q_len: torch.Tensor, T: int):
    """Affine traceback of every window over its full pointer tensor.

    ptrs: uint8[B, M, N+1] (pointer row i-1 holds DP row i); p_len,
    q_len: int32[B].  Returns bool (steps, a_gaps, b_gaps), each [T, B]:
    step t of window b emitted a column (steps) with a gap in p (a_gaps)
    or in q (b_gaps).  CPU tensors take the plain version; CUDA tensors
    launch K4."""
    if ptrs.device.type == "cpu":
        return traceback_walk_plain(ptrs, p_len, q_len, T)
    dev = ptrs.device
    B, M, N1 = ptrs.shape
    cuda.require(ptrs, "ptrs", torch.uint8, dev, (B, M, N1))
    cuda.require(p_len, "p_len", torch.int32, dev, (B,))
    cuda.require(q_len, "q_len", torch.int32, dev, (B,))
    out = torch.zeros((3, T, B), dtype=torch.uint8, device=dev)
    lib = cuda.library()
    cuda.check(lib.lm_traceback(
        ptrs.data_ptr(), p_len.data_ptr(), q_len.data_ptr(), B, M, N1 - 1,
        T, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        cuda.stream(ptrs)), "lm_traceback")
    traceback_walk.launches += 1
    out = out.to(torch.bool)
    return out[0], out[1], out[2]


traceback_walk.launches = 0


def tb_unpack(masks, n_pairs: int):
    """Host tail of the walk: compact each window's step masks to its
    (a_gaps, b_gaps) bool arrays in column order (the contract of the
    JAX package's tb_unpack / traceback_blocks).  `n_pairs` is a count
    of leading windows or a list of window indices."""
    steps, agaps, bgaps = (m.cpu().numpy() for m in masks)
    out = []
    ks = range(n_pairs) if isinstance(n_pairs, int) else n_pairs
    for k in ks:
        sel = steps[:, k]
        out.append((agaps[sel, k][::-1].copy(),
                    bgaps[sel, k][::-1].copy()))
    return out
