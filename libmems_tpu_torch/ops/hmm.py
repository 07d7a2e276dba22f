"""Two-state homology pair-HMM: batched log-space forward/backward
(kernel K8), Viterbi decoding (K20) and Baum-Welch counts (K21), all in
csrc/hmm.cu.

Port of libmems_tpu/ops/hmm.py, the replacement for the HMMoC-generated
HomologyHMM (libMems/HomologyHMM/homology.{h,cc}, homology.xml,
homologymain.cc): states {homologous, unrelated} over 8 column-class
symbols (identity AT/GC, transversion/transition classes, gap open, gap
extend — parameters.h:24-47), log-space forward/backward (log-sum-exp
replaces the reference's extended-exponent float), and the posterior
threshold (>= 0.9 => homologous, homologymain.cc:44-58).

The JAX package dispatched three tiers by length (an f64 scan below 2^14
columns, a checkpointed f64 scan below 2^17, an f32 associative scan
above).  The port runs f64 at every length (R15), on two routes chosen
only by a sequence's padded width T = max(64, 2^ceil(log2 L)), the JAX
package's length bucket:

- T < FB_SCAN_MIN_T (2^17, the JAX package's _FB_ASSOC_MIN_T): the
  sequential route, one walk along each sequence, identical to the JAX
  f64 tiers.  Every such sequence of a call goes into one ragged launch
  (plan_launches, fb_ragged): the rows longest first, their symbols
  concatenated at 16-byte aligned offsets, one upload and one download;
  the forward and backward chains of a row run side by side in two
  warps, then one thread a column forms the posteriors and calls.
- T >= FB_SCAN_MIN_T: the chunked scan, on padded batches of one bucket
  each (pack_batches, fb_posterior).  Each chunk of FB_SCAN_COLS
  columns gives its 2x2 log-space transfer from unit vectors, both ways;
  a fold over the chunks gives each chunk's carries as a normalised pair
  plus an offset summed in double-double (two-sum) arithmetic; each chunk
  then walks from its carries relative to those offsets, and a posterior
  is exp((F + B) + ((off_f + off_b) - logP)).  Values stay small, so the
  route is far more accurate than the sequential walk, whose rounding
  grows with |F| (R16): against an 80-bit run of the recurrence at
  2^17 + 5 columns the sequential f64 walk is off by 3.3e-7, the chunked
  route by about 1e-10.  It therefore differs from the sequential route
  by up to that error, and from the JAX f32 tier only where a posterior
  lies near the threshold (ROADMAP queue 3).

A sequence gets the same bits in any batch, split or launch (R7), since
its route and its arithmetic depend on its own length alone.  A launch
holds at most FB_MAX_ELEMS columns: the sequential route splits its
rows, longest first, and pack_batches each padded bucket.
``viterbi_homologous`` and ``baum_welch`` (the HMMoC Viterbi and
Baum-Welch API, which libMems ships but never calls) run K20 and K21 in
f64: K20 sequential at every length, one ragged launch a call
(pack_ragged's layout, viterbi_ragged; max-plus needs no precision tier),
K21 on both routes over pack_batches' padded batches.  Baum-Welch sums
each sequence's expected counts in column
order on the device (on the chunked route: per chunk in column order,
then over the chunks in chunk order) and the sequences' sums in index
order on the host, so the kernel and its plain version add in the same
order.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from libmems_tpu_torch import cuda

POSTERIOR_THRESHOLD = 0.9   # homologymain.cc:50

# columns per launch: the sequential route keeps 16 bytes of scratch a
# column (forward and backward values of state 0), the chunked route 8
# (forward), so a launch holds at most 1 GiB of them
FB_MAX_ELEMS = 1 << 26
# the sequential route's rows start at multiples of this many bytes (its
# kernels read the symbols 16 at a time)
FB_ROW_ALIGN = 16
# padded widths from which K8 and K21 take the chunked scan (the JAX
# package's _FB_ASSOC_MIN_T), and its chunk: csrc/hmm.cu kScanMinT and
# kScanCols hold the same values
FB_SCAN_MIN_T = 1 << 17
FB_SCAN_COLS = 1024
# a launch's padded width must be a multiple of one block's chunks
# (csrc/hmm.cu kScanThreads = 128 chunk threads a block)
FB_SCAN_BLOCK_COLS = FB_SCAN_COLS * 128


@dataclass
class HmmParams:
    """Transition + emission parameters (HomologyHMM Params struct)."""

    start_homologous: float = 0.5
    go_homologous: float = 1e-5          # U -> H
    go_unrelated: float = 1e-7           # H -> U
    go_stop_from_homologous: float = 1e-8
    go_stop_from_unrelated: float = 1e-8
    emit_homologous: np.ndarray = field(default=None)  # float[8]
    emit_unrelated: np.ndarray = field(default=None)


def hoxd_params() -> HmmParams:
    """The Chiaromonte/Miller HOXD-derived defaults
    (parameters.h getHoxdParams, :11-53)."""
    eh = np.zeros(8)
    eh[0] = 0.1723 * 2     # a:a, t:t
    eh[1] = 0.1462 * 2     # c:c, g:g
    eh[2] = 0.0180 * 4     # a:c class (transversion 1)
    eh[3] = 0.0426 * 4     # a:g class (transition)
    eh[4] = 0.0186 * 2     # a:t
    eh[5] = 0.0142 * 2     # g:c
    eh[6] = 0.004461       # gap open
    eh[7] = 1.0 - eh[:7].sum()   # gap extend
    eu = np.zeros(8)
    eu[0] = 0.12818742714404662781015820149872
    eu[1] = 0.10493347210657785179017485428807
    eu[2] = 0.11597910074937552039966694421313
    eu[3] = eu[2]
    eu[4] = eu[0]
    eu[5] = eu[1]
    eu[6] = 0.0483
    eu[7] = 1.0 - eu[:7].sum()
    return HmmParams(go_stop_from_homologous=1e-8,
                     go_stop_from_unrelated=1e-8,
                     emit_homologous=eh, emit_unrelated=eu)


def adapted_hoxd_params(gc_content: float) -> HmmParams:
    """GC-adapted emissions (getAdaptedHoxdMatrixParameters,
    parameters.h:59-137)."""
    at = 1.0 - gc_content
    gO_u, gE_u = 0.0483, 0.2535
    gO_h, gE_h = 0.004461, 0.050733
    eu = np.zeros(8)
    eu[0] = 2 * (at / 2) ** 2
    eu[1] = 2 * (gc_content / 2) ** 2
    eu[2] = 2 * (at / 2) * (gc_content / 2)
    eu[3] = eu[2]
    eu[4] = eu[0]
    eu[5] = eu[1]
    norm = (1 - (gO_u + gE_u)) / eu[:6].sum()
    eu[:6] *= norm
    eu[6] = gO_u
    eu[7] = 1.0 - eu[:7].sum()
    eh = np.zeros(8)
    eh[0] = (at / 0.525) * 0.1723 * 2
    eh[1] = (gc_content / 0.475) * 0.1462 * 2
    eh[2] = 0.0180 * 4
    eh[3] = 0.0426 * 4
    eh[4] = (at / 0.525) * 0.0186 * 2
    eh[5] = (gc_content / 0.475) * 0.0142 * 2
    norm = (1 - (gO_h + gE_h)) / eh[:6].sum()
    eh[:6] *= norm
    eh[6] = gO_h
    eh[7] = 1.0 - eh[:7].sum()
    return HmmParams(go_stop_from_homologous=1e-7,
                     go_stop_from_unrelated=1e-7,
                     emit_homologous=eh, emit_unrelated=eu)


def adapt_to_percent_identity(params: HmmParams,
                              pct_identity: float) -> HmmParams:
    """Shift homologous identity emission mass to match an expected
    percent identity (adaptToPercentIdentity, parameters.h:140-159)."""
    if not (0 < pct_identity <= 1):
        raise ValueError("bad pct identity")
    eh = params.emit_homologous.copy()
    gapnorm = pct_identity * (1.0 - eh[6] - eh[7])
    prev = eh[0] + eh[1]
    diff = prev - gapnorm
    rest = eh[2] + eh[3] + eh[4] + eh[5]
    eh[2:6] += diff * eh[2:6] / rest
    eh[0] -= diff * eh[0] / prev
    eh[1] -= diff * eh[1] / prev
    out = HmmParams(**{**params.__dict__})
    out.emit_homologous = eh
    return out


def _log_matrices(params: HmmParams):
    """(log_start[2], log_T[2,2], log_stop[2], log_emit[2,8]) with state
    order (H, U)."""
    lt = np.log(np.array([
        [1.0 - params.go_unrelated - params.go_stop_from_homologous,
         params.go_unrelated],
        [params.go_homologous,
         1.0 - params.go_homologous - params.go_stop_from_unrelated],
    ]))
    ls = np.log(np.array([params.start_homologous,
                          1.0 - params.start_homologous]))
    lstop = np.log(np.array([params.go_stop_from_homologous,
                             params.go_stop_from_unrelated]))
    le = np.log(np.stack([params.emit_homologous,
                          params.emit_unrelated]))
    return ls, lt, lstop, le


def _lse(x, dim: int, finite: bool = False):
    """jax.nn.logsumexp: max + log(sum(exp(x - max))) with a non-finite
    max replaced by 0 (`finite`: the caller knows every max is finite,
    so the replacement is a no-op and is skipped)."""
    m = x.amax(dim)
    if not finite:
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(x - m.unsqueeze(dim)).sum(dim)) + m


def fb_sequential_plain(obs, lengths, mats, threshold: float):
    """Plain PyTorch version of K8's sequential route: the two lax.scans
    of ops/hmm.py:_fb_posterior, with its length masking, in f64.  The
    scans stop at the longest row: past it the forward carry is frozen
    and the backward carry is the stop vector, which no returned column
    reads.  Returns (post float64[B, T], calls bool[B, T]); columns at
    or past a row's length are 0 / False."""
    ls, lt, lstop, le = mats
    B, T = obs.shape
    dev = obs.device
    lens = lengths.to(torch.int64)
    n_cols = int(lens.max()) if B else 0
    # finite parameters keep every forward and backward value finite
    fin = all(bool(torch.isfinite(m).all()) for m in mats)
    ragged = bool((lens != n_cols).any())
    le_obs = le.t()[obs[:, :n_cols].to(torch.int64)]        # [B, n, 2]
    F = torch.empty((n_cols, B, 2), dtype=torch.float64, device=dev)
    f = ls[None] + le_obs[:, 0]
    F[0] = f
    for i in range(1, n_cols):
        g = _lse(f[:, :, None] + lt[None], 1, fin) + le_obs[:, i]
        f = torch.where((i < lens)[:, None], g, f) if ragged else g
        F[i] = f
    Bk = torch.empty_like(F)
    stop = lstop[None].expand(B, 2)
    b = stop
    Bk[n_cols - 1] = b
    for i in range(n_cols - 2, -1, -1):
        n = _lse(lt[None] + (le_obs[:, i + 1] + b)[:, None, :], 2, fin)
        if ragged:
            n = torch.where((i == lens - 1)[:, None], stop, n)
            n = torch.where((i > lens - 1)[:, None], b, n)
        b = n
        Bk[i] = b
    last = F[(lens - 1).clamp(min=0), torch.arange(B, device=dev)]
    logp = _lse(last + lstop[None], 1)
    post = torch.zeros((B, T), dtype=torch.float64, device=dev)
    post[:, :n_cols] = torch.exp((F[:, :, 0] + Bk[:, :, 0]) - logp[None]).t()
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    post = torch.where(valid, post, 0.0)
    return post, valid & (post >= threshold)


def _lse2(a, b):
    """K8's lse2: max + log(exp(a - max) + exp(b - max)), a non-finite
    max replaced by 0 (the kernel's `a > b ? a : b`)."""
    m = torch.where(a > b, a, b)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(a - m) + torch.exp(b - m)) + m


def _two_sum(a, b):
    """(a + b rounded, its rounding error), exactly (Knuth's two-sum)."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _normalise(n0, n1, hi, lo):
    """A fold step's new pair less its finite max, the max added to the
    double-double offset (hi, lo)."""
    m = torch.where(n0 > n1, n0, n1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    hi, e = _two_sum(hi, m)
    return n0 - m, n1 - m, hi, lo + e


def _scan_columns(obs, lengths, mats):
    """The chunked scan's inputs: nch (chunks the longest row needs), the
    emissions by chunk le_c f64[B, nch, K, 2] (zero symbols past T), each
    chunk's first column c0 [nch] and the lengths as int64 [B, 1]."""
    K = FB_SCAN_COLS
    B, T = obs.shape
    lens = lengths.to(torch.int64)
    nch = -(-int(lens.max()) // K) if B else 0
    ob = obs[:, :nch * K].to(torch.int64)
    if ob.shape[1] < nch * K:      # a width that is no multiple of K
        ob = torch.nn.functional.pad(ob, (0, nch * K - ob.shape[1]))
    le_c = mats[3].t()[ob].reshape(B, nch, K, 2)
    c0 = torch.arange(nch, device=obs.device) * K
    return nch, le_c, c0, lens[:, None]


def _scan_transfers(le_c, c0, L, mats):
    """Phase 1 of the chunked scan: each chunk's forward and backward
    transfers, walked from the unit vectors (0, -inf) and (-inf, 0) with
    K8's steps.  Forward: g (the log-probability entering a column, by
    state) through the chunk's columns; at a row's last column the walk
    adds lstop and stops.  Backward: beta = le(o_i) + B_i from the
    chunk's right edge leftwards; at a row's last column B starts at the
    unit vector.  Returns Tf, Tb f64[B, nch, 2 (start), 2 (state)]."""
    _, lt, lstop, _ = mats
    K = FB_SCAN_COLS
    B, nch = le_c.shape[:2]
    dev = le_c.device
    unit = torch.tensor([[0.0, -np.inf], [-np.inf, 0.0]], dtype=torch.float64,
                        device=dev).expand(B, nch, 2, 2)
    g = unit
    for i in range(K):
        col = (c0 + i)[None]
        f = g + le_c[:, :, i, None, :]
        step = _lse2(f[..., 0:1] + lt[0], f[..., 1:2] + lt[1])
        last = (col == L - 1)[..., None, None]
        live = (col < L)[..., None, None]
        g = torch.where(last, f + lstop, torch.where(live, step, g))
    Tf = g
    beta = unit
    for i in range(K - 1, -1, -1):
        col = (c0 + i)[None]
        step = _lse2(lt[:, 0] + beta[..., 0:1], lt[:, 1] + beta[..., 1:2])
        b = torch.where((col == L - 1)[..., None, None], unit, step)
        beta = torch.where((col < L)[..., None, None],
                           le_c[:, :, i, None, :] + b, beta)
    return Tf, beta


def _scan_fold(Tf, Tb, L, mats):
    """Phase 2: fold each row's chunk transfers from ls left to right and
    from lstop right to left, chunk after chunk.  A carry is a pair less
    its max plus an offset (hi, lo) summed with two-sum.  Returns Cf, Cb
    f64[B, nch, 4] (pair, hi, lo) entering each chunk from the left (g
    at its first column) and from the right (beta of the next chunk's
    first column; the last chunk's: B = lstop at the row's last column),
    and logP as (hi, lo) f64[B, 2]."""
    ls, _, lstop, _ = mats
    B, nch = Tf.shape[:2]
    dev = Tf.device
    nc = -(-L[:, 0] // FB_SCAN_COLS)
    zero = torch.zeros(B, dtype=torch.float64, device=dev)

    def start(v):
        return _normalise(v[0].expand(B), v[1].expand(B), zero, zero)

    Cf = torch.zeros((B, nch, 4), dtype=torch.float64, device=dev)
    lp = torch.zeros((B, 2), dtype=torch.float64, device=dev)
    p0, p1, hi, lo = start(ls)
    for c in range(nch):
        Cf[:, c] = torch.stack([p0, p1, hi, lo], 1)
        n0 = _lse2(p0 + Tf[:, c, 0, 0], p1 + Tf[:, c, 1, 0])
        n1 = _lse2(p0 + Tf[:, c, 0, 1], p1 + Tf[:, c, 1, 1])
        lh, le_ = _two_sum(hi, _lse2(n0, n1))
        done = c == nc - 1
        lp = torch.where(done[:, None], torch.stack([lh, lo + le_], 1), lp)
        step = c < nc - 1
        new = _normalise(n0, n1, hi, lo)
        p0, p1, hi, lo = (torch.where(step, n, o)
                          for n, o in zip(new, (p0, p1, hi, lo)))
    Cb = torch.zeros((B, nch, 4), dtype=torch.float64, device=dev)
    p0, p1, hi, lo = start(lstop)
    for c in range(nch - 1, -1, -1):
        Cb[:, c] = torch.stack([p0, p1, hi, lo], 1)
        if c == 0:
            break
        n0 = _lse2(p0 + Tb[:, c, 0, 0], p1 + Tb[:, c, 1, 0])
        n1 = _lse2(p0 + Tb[:, c, 0, 1], p1 + Tb[:, c, 1, 1])
        new = _normalise(n0, n1, hi, lo)
        step = c <= nc - 1
        p0, p1, hi, lo = (torch.where(step, n, o)
                          for n, o in zip(new, (p0, p1, hi, lo)))
    return Cf, Cb, lp


def _scan_offsets(Cf, Cb, lp):
    """(off_f + off_b) - logP of each chunk in double-double arithmetic,
    rounded once: f64[B, nch]."""
    s, e = _two_sum(Cf[..., 2], Cb[..., 2])
    t = (Cf[..., 3] + Cb[..., 3]) + e
    s2, e2 = _two_sum(s, -lp[:, None, 0])
    return s2 + ((t - lp[:, None, 1]) + e2)


def _scan_values(obs, lengths, mats):
    """Phases 1-3 of the chunked scan for a padded batch: each chunk's
    forward values from its left carry and backward values from its
    right carry, relative to their offsets.  Returns (nch, le_c, c0, L,
    Fh, Bh f64[B, nch, K, 2], Cb, D f64[B, nch], logP (hi, lo))."""
    _, lt, _, _ = mats
    K = FB_SCAN_COLS
    nch, le_c, c0, L = _scan_columns(obs, lengths, mats)
    Tf, Tb = _scan_transfers(le_c, c0, L, mats)
    Cf, Cb, lp = _scan_fold(Tf, Tb, L, mats)
    D = _scan_offsets(Cf, Cb, lp)
    Fh = torch.empty_like(le_c)
    g = Cf[..., 0:2]
    for i in range(K):
        f = g + le_c[:, :, i]
        Fh[:, :, i] = f
        g = _lse2(f[..., 0:1] + lt[0], f[..., 1:2] + lt[1])
    Bh = torch.empty_like(le_c)
    beta = Cb[..., 0:2]
    for i in range(K - 1, -1, -1):
        step = _lse2(lt[:, 0] + beta[..., 0:1], lt[:, 1] + beta[..., 1:2])
        b = torch.where((c0 + i == L - 1)[..., None], Cb[..., 0:2], step)
        Bh[:, :, i] = b
        beta = le_c[:, :, i] + b
    return nch, le_c, c0, L, Fh, Bh, Cb, D, lp


def fb_scan_plain(obs, lengths, mats, threshold: float):
    """Plain PyTorch version of K8's chunked route (padded widths from
    FB_SCAN_MIN_T on): the kernel's arithmetic, vectorised over rows and
    chunks, FB_SCAN_COLS steps a pass.  Returns (post float64[B, T],
    calls bool[B, T]); columns at or past a row's length are 0 / False."""
    B, T = obs.shape
    dev = obs.device
    post = torch.zeros((B, T), dtype=torch.float64, device=dev)
    if B:
        nch, _, _, _, Fh, Bh, _, D, _ = _scan_values(obs, lengths, mats)
        p = torch.exp((Fh[..., 0] + Bh[..., 0]) + D[..., None])
        n = min(nch * FB_SCAN_COLS, T)
        post[:, :n] = p.reshape(B, -1)[:, :n]
    valid = torch.arange(T, device=dev)[None, :] \
        < lengths.to(torch.int64)[:, None]
    post = torch.where(valid, post, 0.0)
    return post, valid & (post >= threshold)


def fb_posterior_plain(obs, lengths, mats, threshold: float):
    """Plain PyTorch version of K8 on a padded batch: fb_sequential_plain
    below a padded width of FB_SCAN_MIN_T, fb_scan_plain from it on."""
    if obs.shape[1] >= FB_SCAN_MIN_T:
        return fb_scan_plain(obs, lengths, mats, threshold)
    return fb_sequential_plain(obs, lengths, mats, threshold)


def padded_width(n: int) -> int:
    """A sequence's padded width: the JAX package's length bucket, a
    power of two of at least 64 (n >= 1)."""
    return max(64, 1 << (n - 1).bit_length())


def _round_up(n, k: int):
    return -(-n // k) * k


def fb_ragged_plain(obs, offsets, lengths, mats, threshold: float):
    """Plain PyTorch version of K8's sequential route on a ragged batch
    (fb_ragged's layout): the rows grouped by padded width, each group
    through fb_sequential_plain.  Returns (post float64[total], calls
    bool[total]), 0 / False outside the rows."""
    total = obs.shape[0]
    dev = obs.device
    post = torch.zeros(total, dtype=torch.float64, device=dev)
    calls = torch.zeros(total, dtype=torch.bool, device=dev)
    groups: dict[int, list[int]] = {}
    for r, n in enumerate(lengths.tolist()):
        if n > 0:
            groups.setdefault(padded_width(n), []).append(r)
    for T, rows in groups.items():
        rows = torch.tensor(rows, dtype=torch.int64, device=dev)
        n = lengths[rows]
        cols = torch.arange(T, device=dev)
        valid = cols[None] < n[:, None].to(torch.int64)
        idx = offsets[rows][:, None] + cols[None]
        o = torch.where(valid, obs[idx.clamp(max=total - 1)], 0)
        p, c = fb_sequential_plain(o.to(torch.uint8), n, mats, threshold)
        post[idx[valid]] = p[valid]
        calls[idx[valid]] = c[valid]
    return post, calls


def _host_mats(mats) -> ctypes.Array:
    """The 24 f64 matrix entries as the host array the launchers copy
    into the kernel (ls[2], lt[2, 2], lstop[2], le[2, 8])."""
    flat = torch.cat([m.reshape(-1) for m in mats]).to(torch.float64).cpu()
    if flat.shape[0] != 24:
        raise ValueError("mats must be ls[2], lt[2, 2], lstop[2], le[2, 8]")
    return (ctypes.c_double * 24)(*flat.tolist())


def _scan_route(obs, sequential: bool = False):
    """True where the launch takes the chunked route: from a padded
    width of FB_SCAN_MIN_T on, unless `sequential`."""
    T = obs.shape[1]
    scan = T >= FB_SCAN_MIN_T and not sequential
    if scan and (T % FB_SCAN_BLOCK_COLS or obs.data_ptr() % 16):
        raise ValueError(f"the chunked route needs T a multiple of "
                         f"{FB_SCAN_BLOCK_COLS} and obs 16-byte aligned")
    return scan


def _scan_scratch(lib, B, T, counts, dev):
    """The chunked route's scratch (transfers, carries, logP and `counts`
    doubles a chunk), sized by the kernel library."""
    n = lib.lm_hmm_scan_doubles(B, T, counts)
    return torch.empty(n, dtype=torch.float64, device=dev)


def _launch_rows(obs, offsets, lengths, mats, threshold, want_post):
    """K8's sequential route on the card (lm_hmm_fb_rows: the chains,
    then the posterior pass) over fb_ragged's layout.  Returns (post
    float64[total] or None, calls bool[total]), views of one byte buffer,
    post first."""
    dev = obs.device
    N, total = lengths.shape[0], obs.shape[0]
    host = _host_mats(mats)
    lib = cuda.library()
    fb = torch.empty(2 * total, dtype=torch.float64, device=dev)
    logp = torch.empty(max(N, 1), dtype=torch.float64, device=dev)
    out = torch.empty(total * (9 if want_post else 1), dtype=torch.uint8,
                      device=dev)
    post = out[:8 * total].view(torch.float64) if want_post else None
    calls = out[out.shape[0] - total:]
    cuda.check(lib.lm_hmm_fb_rows(
        obs.data_ptr(), offsets.data_ptr(), lengths.data_ptr(), N, total,
        host, float(threshold), fb.data_ptr(), logp.data_ptr(),
        post.data_ptr() if want_post else None, calls.data_ptr(),
        cuda.stream(obs)), "lm_hmm_fb_rows")
    return post, calls.view(torch.bool)


@cuda.launcher
def fb_ragged(obs, offsets, lengths, mats,
              threshold: float = POSTERIOR_THRESHOLD,
              want_post: bool = True):
    """K8's sequential route: posterior P(homologous) and calls for a
    ragged batch of rows at once (the chains, then the posterior pass).

    obs: uint8[total] symbols 0..7, 16-byte aligned; offsets: int64[N],
    ascending multiples of FB_ROW_ALIGN, row r's symbols at obs[offsets[r]
    :offsets[r] + lengths[r]] and its span (the length rounded up to
    FB_ROW_ALIGN) inside obs; lengths: int32[N]; mats as for
    fb_posterior.  Returns (post float64[total] or None when not
    want_post on CUDA, calls bool[total]), zero outside the rows; on
    CUDA both are views of one byte buffer, post first, so one copy
    brings them to the host.  CPU tensors take the plain version; CUDA
    tensors launch the chains and the posterior pass (lm_hmm_fb_rows)."""
    if obs.device.type == "cpu":
        return fb_ragged_plain(obs, offsets, lengths, mats, threshold)
    dev = obs.device
    N = lengths.shape[0]
    cuda.require(obs, "obs", torch.uint8, dev, (obs.shape[0],))
    cuda.require(offsets, "offsets", torch.int64, dev, (N,))
    cuda.require(lengths, "lengths", torch.int32, dev, (N,))
    if obs.data_ptr() % FB_ROW_ALIGN:
        raise ValueError(f"obs must be {FB_ROW_ALIGN}-byte aligned")
    post, calls = _launch_rows(obs, offsets, lengths, mats, threshold,
                               want_post)
    fb_ragged.launches += 1
    return post, calls


fb_ragged.launches = 0


@cuda.launcher
def fb_posterior(obs, lengths, mats, threshold: float = POSTERIOR_THRESHOLD,
                 want_post: bool = True, sequential: bool = False):
    """Posterior P(homologous) and calls for a padded batch.

    obs: uint8[B, T] symbols 0..7; lengths: int32[B] (1..T); mats: the
    f64 tensors (ls[2], lt[2, 2], lstop[2], le[2, 8]) on obs's device.
    Returns (post float64[B, T] or None when not want_post on CUDA,
    calls bool[B, T]), zero past each row's length.  CPU tensors take
    the plain version; CUDA tensors launch K8, on the chunked route from
    a padded width of FB_SCAN_MIN_T on and the sequential one below it,
    with rows at offsets b * T (`sequential` forces the sequential route
    at any width on CUDA: a measurement's switch, which no path sets)."""
    if obs.device.type == "cpu":
        return fb_posterior_plain(obs, lengths, mats, threshold)
    dev = obs.device
    B, T = obs.shape
    cuda.require(obs, "obs", torch.uint8, dev, (B, T))
    cuda.require(lengths, "lengths", torch.int32, dev, (B,))
    if not _scan_route(obs, sequential):
        S = _round_up(T, FB_ROW_ALIGN)
        rows = obs
        if S != T or obs.data_ptr() % FB_ROW_ALIGN:
            rows = torch.zeros((B, S), dtype=torch.uint8, device=dev)
            rows[:, :T] = obs
        offsets = torch.arange(B, dtype=torch.int64, device=dev) * S
        post, calls = _launch_rows(rows.reshape(-1), offsets, lengths, mats,
                                   threshold, want_post)
        fb_posterior.launches += 1
        post = post.view(B, S)[:, :T].contiguous() if want_post else None
        return post, calls.view(B, S)[:, :T].contiguous()
    host = _host_mats(mats)
    lib = cuda.library()
    fwd = torch.empty((B, T), dtype=torch.float64, device=dev)
    aux = _scan_scratch(lib, B, T, 0, dev)
    post = torch.zeros((B, T), dtype=torch.float64, device=dev) \
        if want_post else None
    calls = torch.zeros((B, T), dtype=torch.bool, device=dev)
    cuda.check(lib.lm_hmm_fb(
        obs.data_ptr(), lengths.data_ptr(), B, T, host, float(threshold),
        fwd.data_ptr(), post.data_ptr() if post is not None else None,
        calls.data_ptr(), aux.data_ptr(), cuda.stream(obs)), "lm_hmm_fb")
    fb_posterior.launches += 1
    return post, calls


fb_posterior.launches = 0


@cuda.launcher
def chain_step_cycles(row, mats):
    """A measurement on the card, no path's: the cycles of one step of
    the sequential route's forward and backward chains, timed with
    clock64 on one pair of lanes (one chain) over `row` (uint8[L]
    symbols on the card, L >= 2).  Returns (forward, backward) cycles a
    step."""
    if row.device.type != "cuda":
        raise ValueError("chain_step_cycles measures the card")
    dev = row.device
    L = row.shape[0]
    if L < 2:
        raise ValueError("chain_step_cycles needs two columns or more")
    S = _round_up(L, FB_ROW_ALIGN)
    obs = torch.zeros(S, dtype=torch.uint8, device=dev)
    obs[:L] = row
    fb = torch.empty(2 * S + 1, dtype=torch.float64, device=dev)
    cycles = torch.zeros(2, dtype=torch.int64, device=dev)
    cuda.check(cuda.library().lm_hmm_step_cycles(
        obs.data_ptr(), L, S, _host_mats(mats), fb.data_ptr(),
        cycles.data_ptr(), cuda.stream(obs)), "lm_hmm_step_cycles")
    fwd, bwd = cycles.tolist()
    return fwd / (L - 1), bwd / (L - 1)


def log_matrices(params: HmmParams, device) -> tuple:
    """The log matrices as f64 tensors on `device`."""
    return tuple(torch.from_numpy(np.asarray(x, dtype=np.float64)).to(device)
                 for x in _log_matrices(params))


def _buckets(sequences) -> dict[int, list[int]]:
    """The non-empty sequences' indices by padded width, in index order."""
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(sequences):
        if len(s):
            buckets.setdefault(padded_width(len(s)), []).append(i)
    return buckets


def _pad_buckets(sequences, buckets):
    """Each bucket split so a launch holds at most FB_MAX_ELEMS columns:
    (sequence indices, obs uint8[B, T], lengths int32[B]) per launch."""
    for T, idxs in buckets.items():
        max_rows = max(1, FB_MAX_ELEMS // T)
        for base in range(0, len(idxs), max_rows):
            part = idxs[base:base + max_rows]
            obs = np.zeros((len(part), T), dtype=np.uint8)
            lens = np.ones(len(part), dtype=np.int32)
            for r, i in enumerate(part):
                obs[r, :len(sequences[i])] = sequences[i]
                lens[r] = len(sequences[i])
            yield part, obs, lens


def pack_batches(sequences):
    """Bucket the non-empty sequences by the JAX package's padded length
    (a power of two >= 64) and split each bucket so a launch holds at
    most FB_MAX_ELEMS columns.  Yields (sequence indices, obs uint8[B,
    T], lengths int32[B]) per launch, on the host."""
    yield from _pad_buckets(sequences, _buckets(sequences))


@dataclass
class RaggedBatch:
    """One launch of K8's sequential route, on the host: the rows
    (sequence indices, longest first) and one buffer holding offsets
    int64[N], lengths int32[N] and, from a 16-byte aligned byte, the
    symbols, each row at its offset (fb_ragged's layout)."""

    rows: list
    buf: np.ndarray
    total: int

    @property
    def start(self) -> int:
        return _round_up(12 * len(self.rows), FB_ROW_ALIGN)

    @property
    def offsets(self) -> np.ndarray:
        return self.buf[:8 * len(self.rows)].view(np.int64)

    @property
    def lengths(self) -> np.ndarray:
        return self.buf[8 * len(self.rows):12 * len(self.rows)].view(np.int32)

    def tensors(self, device):
        """(obs uint8[total], offsets int64[N], lengths int32[N]) on
        `device`, from one host-to-device copy."""
        n = len(self.rows)
        d = torch.from_numpy(self.buf).to(device)
        return (d[self.start:], d[:8 * n].view(torch.int64),
                d[8 * n:12 * n].view(torch.int32))


def pack_ragged(sequences, idxs):
    """The sequential route's launches of the sequences `idxs`: the rows
    longest first (ties in index order), cut so a launch holds at most
    FB_MAX_ELEMS columns (each row's length rounded up to FB_ROW_ALIGN;
    a row alone may hold more).  Yields a RaggedBatch per launch."""
    order = sorted(idxs, key=lambda i: -len(sequences[i]))
    launch, cols = [], 0
    for i in order:
        span = _round_up(len(sequences[i]), FB_ROW_ALIGN)
        if launch and cols + span > FB_MAX_ELEMS:
            yield _ragged_batch(sequences, launch)
            launch, cols = [], 0
        launch.append(i)
        cols += span
    if launch:
        yield _ragged_batch(sequences, launch)


def _ragged_batch(sequences, rows) -> RaggedBatch:
    lens = np.array([len(sequences[i]) for i in rows], dtype=np.int64)
    spans = _round_up(lens, FB_ROW_ALIGN)
    offs = np.concatenate([[0], np.cumsum(spans)[:-1]]).astype(np.int64)
    total = int(spans.sum())
    batch = RaggedBatch(rows, np.zeros(_round_up(12 * len(rows), FB_ROW_ALIGN)
                                       + total, dtype=np.uint8), total)
    batch.offsets[:] = offs
    batch.lengths[:] = lens
    obs = batch.buf[batch.start:]
    for i, o, n_i in zip(rows, offs, lens):
        obs[o:o + n_i] = sequences[i]
    return batch


def plan_launches(sequences):
    """K8's launches for a call: (the sequential route's RaggedBatches,
    pack_batches' padded launches of the chunked route).  A sequence of
    padded width below FB_SCAN_MIN_T takes the sequential route, every
    other one the chunked route, in pack_batches' buckets and splits;
    empty sequences take neither."""
    buckets = _buckets(sequences)
    short = [i for T, idxs in buckets.items() if T < FB_SCAN_MIN_T
             for i in idxs]
    wide = {T: idxs for T, idxs in buckets.items() if T >= FB_SCAN_MIN_T}
    return (list(pack_ragged(sequences, short)),
            list(_pad_buckets(sequences, wide)))


def _to_host(post, calls):
    """fb_ragged's (post or None, calls) as numpy arrays; on the card one
    copy of the byte buffer both are views of."""
    if calls.device.type == "cpu":
        return (post.numpy() if post is not None else None), calls.numpy()
    raw = torch.empty(0, dtype=torch.uint8, device=calls.device).set_(
        calls.untyped_storage()).cpu().numpy()
    n = calls.shape[0]
    return (raw[:8 * n].view(np.float64) if post is not None else None,
            raw[raw.shape[0] - n:].view(np.bool_))


def _fb_batched(sequences, params, device, threshold, want_post):
    """Run K8 (or its plain version) on the launches of plan_launches.
    Returns per sequence (post float64 or None, calls bool) on the host;
    empty sequences give empty arrays."""
    dev = cuda.resolve_device(device)
    if params is None:
        params = hoxd_params()
    mats = log_matrices(params, dev)
    out: list = [(np.zeros(0, np.float64), np.zeros(0, bool))] \
        * len(sequences)
    ragged, padded = plan_launches(sequences)
    for batch in ragged:
        post, calls = _to_host(*fb_ragged(*batch.tensors(dev), mats,
                                          threshold, want_post))
        for i, o in zip(batch.rows, batch.offsets.tolist()):
            n = len(sequences[i])
            out[i] = (post[o:o + n] if want_post else None, calls[o:o + n])
    for part, obs, lens in padded:
        post, calls = fb_posterior(
            torch.from_numpy(obs).to(dev), torch.from_numpy(lens).to(dev),
            mats, threshold, want_post)
        calls = calls.cpu().numpy()
        post = post.cpu().numpy() if want_post else None
        for r, i in enumerate(part):
            n = len(sequences[i])
            out[i] = (post[r, :n] if want_post else None, calls[r, :n])
    return out


@cuda.entry(cuda.device_arg)
def posterior_homologous(sequences: list[np.ndarray],
                         params: HmmParams | None = None,
                         device="cuda") -> list[np.ndarray]:
    """Posterior P(homologous) per column, float64, for a batch of
    encoded symbol sequences (uint8 codes 0..7), on `device`."""
    return [p for p, _ in _fb_batched(sequences, params, device,
                                      POSTERIOR_THRESHOLD, True)]


@cuda.entry(cuda.device_arg)
def predict_homologous(sequences: list[np.ndarray],
                       params: HmmParams | None = None,
                       threshold: float = POSTERIOR_THRESHOLD,
                       device="cuda") -> list[np.ndarray]:
    """Boolean per-column homology calls (run() equivalent) on
    `device`."""
    return [c for _, c in _fb_batched(sequences, params, device, threshold,
                                      False)]


# --------------------------------------------------------------------------
# Viterbi decoding (K20) + Baum-Welch re-estimation (K21)
# --------------------------------------------------------------------------

def viterbi_path_plain(obs, lengths, mats):
    """Plain PyTorch version of K20: the max-product scan of
    ops/hmm.py:_viterbi_path (first argmax on ties; identity pointers
    past each row's length) and its walk back from the end state, the
    walk as a log-depth suffix scan of the pointer maps (each column's
    map takes the state there to the state one column earlier).  Returns
    bool[B, T], True = homologous, False at or past a row's length."""
    ls, lt, lstop, le = mats
    B, T = obs.shape
    dev = obs.device
    lens = lengths.to(torch.int64)
    n_cols = int(lens.max()) if B else 0
    path = torch.zeros((B, T), dtype=torch.bool, device=dev)
    if n_cols == 0:
        return path
    le_obs = le.t()[obs[:, :n_cols].to(torch.int64)]        # [B, n, 2]
    V = torch.empty((n_cols, B, 2), dtype=torch.float64, device=dev)
    ptr = torch.zeros((n_cols, B, 2), dtype=torch.bool, device=dev)
    v = ls[None] + le_obs[:, 0]
    V[0] = v
    for i in range(1, n_cols):
        cand = v[:, :, None] + lt[None]                      # [B, from, to]
        p = cand[:, 1] > cand[:, 0]
        v = torch.where(p, cand[:, 1], cand[:, 0]) + le_obs[:, i]
        V[i] = v
        ptr[i] = p
    rows = torch.arange(B, device=dev)
    e = V[lens - 1, rows] + lstop[None]
    end = (e[:, 1] > e[:, 0]).to(torch.int64)
    # S[i] maps the state at the last column to the state at column i
    ident = torch.arange(2, device=dev).expand(n_cols, B, 2)
    live = (torch.arange(n_cols, device=dev)[:, None] < lens[None])[:, :, None]
    step = torch.where(live, ptr.to(torch.int64), ident)
    S = torch.cat([step[1:], ident[:1]])
    d = 1
    while d < n_cols:
        S = torch.cat([torch.gather(S[:-d], 2, S[d:]), S[-d:]])
        d *= 2
    states = torch.gather(S, 2, end[None, :, None].expand(n_cols, B, 1))
    states = states[:, :, 0]
    path[:, :n_cols] = (states.t() == 0) & live[:, :, 0].t()
    return path


def viterbi_ragged_plain(obs, offsets, lengths, mats):
    """Plain PyTorch version of K20 on a ragged batch (viterbi_ragged's
    layout): the rows grouped by padded width, each group through
    viterbi_path_plain.  Returns bool[total], False outside the rows and
    past each row's length."""
    total = obs.shape[0]
    dev = obs.device
    path = torch.zeros(total, dtype=torch.bool, device=dev)
    groups: dict[int, list[int]] = {}
    for r, n in enumerate(lengths.tolist()):
        if n > 0:
            groups.setdefault(padded_width(n), []).append(r)
    for T, rows in groups.items():
        rows = torch.tensor(rows, dtype=torch.int64, device=dev)
        n = lengths[rows]
        cols = torch.arange(T, device=dev)
        valid = cols[None] < n[:, None].to(torch.int64)
        idx = offsets[rows][:, None] + cols[None]
        o = torch.where(valid, obs[idx.clamp(max=total - 1)], 0)
        p = viterbi_path_plain(o.to(torch.uint8), n, mats)
        path[idx[valid]] = p[valid]
    return path


def _launch_viterbi(obs, offsets, lengths, mats):
    """K20 on the card over viterbi_ragged's layout (lm_hmm_viterbi_rows).
    Returns bool[total]."""
    total = obs.shape[0]
    if obs.data_ptr() % FB_ROW_ALIGN or total % FB_ROW_ALIGN:
        raise ValueError(f"obs must be {FB_ROW_ALIGN}-byte aligned and a "
                         f"multiple of {FB_ROW_ALIGN} long")
    ptr = torch.empty(total // 16, dtype=torch.int32, device=obs.device)
    path = torch.empty(total, dtype=torch.uint8, device=obs.device)
    cuda.check(cuda.library().lm_hmm_viterbi_rows(
        obs.data_ptr(), offsets.data_ptr(), lengths.data_ptr(),
        lengths.shape[0], total, _host_mats(mats), ptr.data_ptr(),
        path.data_ptr(), cuda.stream(obs)), "lm_hmm_viterbi_rows")
    return path.view(torch.bool)


@cuda.launcher
def viterbi_ragged(obs, offsets, lengths, mats):
    """Most likely state per column of a ragged batch (K20 over
    fb_ragged's layout, in one launch).

    obs: uint8[total] symbols 0..7, 16-byte aligned, total a multiple of
    FB_ROW_ALIGN; offsets: int64[N], ascending multiples of FB_ROW_ALIGN,
    row r's symbols at obs[offsets[r]:offsets[r] + lengths[r]] and its
    span (the length rounded up to FB_ROW_ALIGN) below the next row's
    offset (the last row's below total); lengths: int32[N]; mats as for
    fb_posterior.  Rows longest first keep a warp's rows alike (the
    launch lasts as long as its longest row).  Returns bool[total], True
    = homologous, False past each row's length and between rows.  CPU
    tensors take the plain version; CUDA tensors launch K20 (a thread a
    row, every byte of the layout written)."""
    if obs.device.type == "cpu":
        return viterbi_ragged_plain(obs, offsets, lengths, mats)
    dev = obs.device
    N = lengths.shape[0]
    cuda.require(obs, "obs", torch.uint8, dev, (obs.shape[0],))
    cuda.require(offsets, "offsets", torch.int64, dev, (N,))
    cuda.require(lengths, "lengths", torch.int32, dev, (N,))
    path = _launch_viterbi(obs, offsets, lengths, mats)
    viterbi_ragged.launches += 1
    return path


viterbi_ragged.launches = 0


@cuda.launcher
def viterbi_path(obs, lengths, mats):
    """Most likely state per column of a padded batch.

    obs: uint8[B, T] symbols 0..7; lengths: int32[B] (0..T); mats as for
    fb_posterior.  Returns bool[B, T], True = homologous, False at or
    past each row's length.  CPU tensors take the plain version; CUDA
    tensors launch K20 as viterbi_ragged does, the rows at offsets r x S
    (S = T rounded up to FB_ROW_ALIGN; the rows are copied to that
    stride only where T or obs's address is not aligned)."""
    if obs.device.type == "cpu":
        return viterbi_path_plain(obs, lengths, mats)
    dev = obs.device
    B, T = obs.shape
    cuda.require(obs, "obs", torch.uint8, dev, (B, T))
    cuda.require(lengths, "lengths", torch.int32, dev, (B,))
    S = _round_up(T, FB_ROW_ALIGN)
    rows = obs
    if S != T or obs.data_ptr() % FB_ROW_ALIGN:
        rows = torch.zeros((B, S), dtype=torch.uint8, device=dev)
        rows[:, :T] = obs
    offsets = torch.arange(B, dtype=torch.int64, device=dev) * S
    path = _launch_viterbi(rows.reshape(-1), offsets, lengths,
                           mats).view(B, S)
    viterbi_path.launches += 1
    return path if S == T else path[:, :T].contiguous()


viterbi_path.launches = 0


@cuda.launcher
def viterbi_step_cycles(row, mats):
    """A measurement on the card, no path's: the cycles of one column of
    K20 on `row` (uint8[L] symbols on the card, L >= 2), by clock64:
    (the forward pass, the walk back), each a step."""
    if row.device.type != "cuda":
        raise ValueError("viterbi_step_cycles measures the card")
    dev = row.device
    L = row.shape[0]
    if L < 2:
        raise ValueError("viterbi_step_cycles needs two columns or more")
    S = _round_up(L, FB_ROW_ALIGN)
    obs = torch.zeros(S, dtype=torch.uint8, device=dev)
    obs[:L] = row
    ptr = torch.empty(S // 16, dtype=torch.int32, device=dev)
    path = torch.empty(S, dtype=torch.uint8, device=dev)
    cycles = torch.zeros(2, dtype=torch.int64, device=dev)
    cuda.check(cuda.library().lm_hmm_viterbi_step_cycles(
        obs.data_ptr(), L, _host_mats(mats), ptr.data_ptr(), path.data_ptr(),
        cycles.data_ptr(), cuda.stream(obs)), "lm_hmm_viterbi_step_cycles")
    return tuple(c / (L - 1) for c in cycles.tolist())


@cuda.entry(cuda.device_arg)
def viterbi_homologous(sequences: list[np.ndarray],
                       params: HmmParams | None = None,
                       device="cuda") -> list[np.ndarray]:
    """Most-likely state path per column (True = homologous) for a batch
    of encoded symbol sequences, on `device`: the Viterbi analog of
    predict_homologous, every non-empty sequence in pack_ragged's
    launches (one unless the call passes FB_MAX_ELEMS columns), one
    upload and one download each."""
    dev = cuda.resolve_device(device)
    if params is None:
        params = hoxd_params()
    mats = log_matrices(params, dev)
    out: list = [np.zeros(0, dtype=bool)] * len(sequences)
    idxs = [i for i, s in enumerate(sequences) if len(s)]
    for batch in pack_ragged(sequences, idxs):
        path = viterbi_ragged(*batch.tensors(dev), mats).cpu().numpy()
        for i, o in zip(batch.rows, batch.offsets.tolist()):
            out[i] = path[o:o + len(sequences[i])]
    return out


BW_COUNTS = 23   # start[2], trans[2, 2], emit[2, 8], logP per sequence


def bw_sequential_plain(obs, lengths, mats):
    """Plain PyTorch version of K21's sequential route: the forward and
    backward scans and masks of ops/hmm.py:_bw_counts, with each
    sequence's expected counts summed over its columns in column order.
    Values past a row's length are computed but never read (the JAX
    scans freeze them there).
    Returns f64[B, 23] (start[2], trans[2, 2], emit[2, 8], logP); a row of
    length 0 gives zeros."""
    ls, lt, lstop, le = mats
    B, T = obs.shape
    dev = obs.device
    lens = lengths.to(torch.int64)
    out = torch.zeros((B, BW_COUNTS), dtype=torch.float64, device=dev)
    n_cols = int(lens.max()) if B else 0
    if n_cols == 0:
        return out
    # finite parameters keep every forward and backward value finite
    fin = all(bool(torch.isfinite(m).all()) for m in mats)
    ob = obs[:, :n_cols].to(torch.int64)
    le_obs = le.t()[ob]                                      # [B, n, 2]
    F = torch.empty((n_cols, B, 2), dtype=torch.float64, device=dev)
    f = ls[None] + le_obs[:, 0]
    F[0] = f
    for i in range(1, n_cols):
        f = _lse(f[:, :, None] + lt[None], 1, fin) + le_obs[:, i]
        F[i] = f
    Bk = torch.empty_like(F)
    stop = lstop[None].expand(B, 2)
    last = (lens - 1)[:, None]
    b = stop
    Bk[n_cols - 1] = b
    for i in range(n_cols - 2, -1, -1):
        n = _lse(lt[None] + (le_obs[:, i + 1] + b)[:, None, :], 2, fin)
        b = torch.where(last == i, stop, n)
        Bk[i] = b
    rows = torch.arange(B, device=dev)
    logp = _lse(F[(lens - 1).clamp(min=0), rows] + lstop[None], 1)  # [B]
    idx = torch.arange(n_cols, device=dev)
    col = (idx[:, None] < lens[None, :])[:, :, None]          # [n, B, 1]
    gamma = torch.where(col, torch.exp((F + Bk) - logp[None, :, None]),
                        0.0)                                  # [n, B, 2]
    le_b = le_obs.transpose(0, 1) + Bk                        # [n, B, 2]
    terms = torch.zeros((n_cols, B, 20), dtype=torch.float64, device=dev)
    xi = torch.exp(((F[:-1, :, :, None] + lt[None, None])
                    + le_b[1:, :, None, :]) - logp[None, :, None, None])
    terms[:-1, :, :4] = torch.where(
        (idx[:-1, None] < lens[None, :] - 1)[:, :, None, None], xi,
        0.0).reshape(n_cols - 1, B, 4)
    onehot = torch.nn.functional.one_hot(ob.t(), 8).to(torch.bool)
    terms[:, :, 4:] = torch.where(onehot[:, :, None, :], gamma[:, :, :, None],
                                  0.0).reshape(n_cols, B, 16)
    # each sequence's columns in column order, as K21 adds them (a term
    # masked to 0 leaves a sum unchanged)
    acc = terms[0].clone()
    for t in range(1, n_cols):
        acc += terms[t]
    out[:, 0:2] = gamma[0]
    out[:, 2:22] = acc
    out[:, 22] = logp
    return torch.where((lens > 0)[:, None], out, 0.0)


def bw_scan_plain(obs, lengths, mats):
    """Plain PyTorch version of K21's chunked route (padded widths from
    FB_SCAN_MIN_T on): K8's chunked values, then each chunk's expected
    counts summed in column order (a transition out of a chunk's last
    column takes beta of the next column from the chunk's right carry)
    and the chunks' sums in chunk order.  Returns f64[B, 23] as
    bw_sequential_plain does."""
    _, lt, _, _ = mats
    B, T = obs.shape
    dev = obs.device
    out = torch.zeros((B, BW_COUNTS), dtype=torch.float64, device=dev)
    lens = lengths.to(torch.int64)
    if B == 0 or int(lens.max()) == 0:
        return out
    nch, le_c, c0, L, Fh, Bh, Cb, D, lp = _scan_values(obs, lengths, mats)
    K = FB_SCAN_COLS
    ob = torch.nn.functional.pad(obs[:, :nch * K].to(torch.int64),
                                 (0, max(nch * K - T, 0)))
    onehot = torch.nn.functional.one_hot(ob.reshape(B, nch, K), 8) \
        .to(torch.bool)
    acc = torch.zeros((B, nch, 20), dtype=torch.float64, device=dev)
    for i in range(K):
        col = (c0 + i)[None]                                   # [1, nch]
        gamma = torch.exp((Fh[:, :, i] + Bh[:, :, i]) + D[..., None])
        gamma = torch.where((col < L)[..., None], gamma, 0.0)  # [B, nch, 2]
        nb = le_c[:, :, i + 1] + Bh[:, :, i + 1] if i + 1 < K \
            else Cb[..., 0:2]
        xi = torch.exp(((Fh[:, :, i, :, None] + lt)
                        + nb[:, :, None, :]) + D[..., None, None])
        xi = torch.where((col + 1 < L)[..., None, None], xi, 0.0)
        acc[..., :4] += xi.reshape(B, nch, 4)
        acc[..., 4:] += torch.where(onehot[:, :, i, None, :],
                                    gamma[..., None], 0.0).reshape(B, nch, 16)
    tot = torch.zeros((B, 20), dtype=torch.float64, device=dev)
    for c in range(nch):
        tot += acc[:, c]
    gamma0 = torch.exp((Fh[:, 0, 0] + Bh[:, 0, 0]) + D[:, 0, None])
    out[:, 0:2] = gamma0
    out[:, 2:22] = tot
    out[:, 22] = lp[:, 0] + lp[:, 1]
    return torch.where((lens > 0)[:, None], out, 0.0)


def bw_counts_plain(obs, lengths, mats):
    """Plain PyTorch version of K21: bw_sequential_plain below a padded
    width of FB_SCAN_MIN_T, bw_scan_plain from it on."""
    if obs.shape[1] >= FB_SCAN_MIN_T:
        return bw_scan_plain(obs, lengths, mats)
    return bw_sequential_plain(obs, lengths, mats)


@cuda.launcher
def bw_counts(obs, lengths, mats):
    """Baum-Welch expected counts of each sequence of a padded batch.

    obs: uint8[B, T] symbols 0..7; lengths: int32[B] (0..T); mats as for
    fb_posterior.  Returns f64[B, 23]: start counts [2], transition
    counts [2, 2], emission counts [2, 8] and logP of each row (zeros for
    a row of length 0).  CPU tensors take the plain version; CUDA
    tensors launch K21, on the chunked route from a padded width of
    FB_SCAN_MIN_T on."""
    if obs.device.type == "cpu":
        return bw_counts_plain(obs, lengths, mats)
    dev = obs.device
    B, T = obs.shape
    cuda.require(obs, "obs", torch.uint8, dev, (B, T))
    cuda.require(lengths, "lengths", torch.int32, dev, (B,))
    scan = _scan_route(obs)
    host = _host_mats(mats)
    lib = cuda.library()
    fwd = torch.empty((B, T, 2), dtype=torch.float64, device=dev)
    bwd = torch.empty((B, T, 2), dtype=torch.float64, device=dev)
    aux = _scan_scratch(lib, B, T, 22, dev) if scan else None
    part = torch.empty((B, BW_COUNTS), dtype=torch.float64, device=dev)
    cuda.check(lib.lm_hmm_bw(
        obs.data_ptr(), lengths.data_ptr(), B, T, host, fwd.data_ptr(),
        bwd.data_ptr(), part.data_ptr(), aux.data_ptr() if scan else None,
        cuda.stream(obs)), "lm_hmm_bw")
    bw_counts.launches += 1
    return part


bw_counts.launches = 0


def sum_counts(part: np.ndarray):
    """Sum per-sequence counts f64[B, 23] over the sequences in index
    order (a sequential accumulation, the same on every device).
    Returns (start [2], trans [2, 2], emit [2, 8], log-likelihood)."""
    tot = np.cumsum(part, axis=0)[-1] if len(part) \
        else np.zeros(BW_COUNTS)
    return (tot[0:2].copy(), tot[2:6].reshape(2, 2).copy(),
            tot[6:22].reshape(2, 8).copy(), float(tot[22]))


def _bw_counts(obs: np.ndarray, lens: np.ndarray, params: HmmParams, dev):
    """ops/hmm.py:_bw_counts for a padded host batch: K21 (or its plain
    version) on launches of at most FB_MAX_ELEMS columns, the
    per-sequence counts summed in index order."""
    mats = log_matrices(params, dev)
    T = obs.shape[1]
    rows = max(1, FB_MAX_ELEMS // T)
    parts = []
    for base in range(0, obs.shape[0], rows):
        parts.append(bw_counts(
            torch.from_numpy(obs[base:base + rows]).to(dev),
            torch.from_numpy(lens[base:base + rows]).to(dev),
            mats).cpu().numpy())
    return sum_counts(np.concatenate(parts))


@cuda.entry(cuda.device_arg)
def baum_welch(sequences: list[np.ndarray],
               params: HmmParams | None = None,
               iterations: int = 5,
               pseudocount: float = 1e-3,
               device="cuda") -> tuple[HmmParams, list[float]]:
    """Baum-Welch EM re-estimation of emissions and H<->U transitions
    from a corpus of encoded column sequences, on `device`.  Returns
    (fitted params, per-iteration total log-likelihood).  Stop
    probabilities are held fixed (they encode sequence-end modelling,
    parameters.h:18-21)."""
    dev = cuda.resolve_device(device)
    if params is None:
        params = hoxd_params()
    params = HmmParams(**{**params.__dict__})
    seqs = [s for s in sequences if len(s) > 0]
    if not seqs:
        return params, []
    T = max(64, 1 << (max(len(s) for s in seqs) - 1).bit_length())
    Bp = max(1, 1 << (len(seqs) - 1).bit_length())
    obs = np.zeros((Bp, T), dtype=np.uint8)
    lens = np.ones(Bp, dtype=np.int32)
    for r, s in enumerate(seqs):
        obs[r, :len(s)] = s
        lens[r] = len(s)
    # padding rows replicate row 0 with length 1; subtract their counts
    n_pad = Bp - len(seqs)
    lls: list[float] = []
    for _ in range(iterations):
        sc, tc, ec, ll = _bw_counts(obs, lens, params, dev)
        if n_pad:
            # each pad row is a length-1 symbol-0 sequence: its gamma adds
            # start/emission mass but no transitions
            ls_np, _, lstop_np, le_np = _log_matrices(params)
            g0 = np.exp(ls_np + le_np[:, 0] + lstop_np)
            g0 = g0 / g0.sum()
            sc = sc - n_pad * g0
            ec[:, 0] = ec[:, 0] - n_pad * g0
            ll = ll - n_pad * float(
                np.log(np.exp(ls_np + le_np[:, 0] + lstop_np).sum()))
        lls.append(float(ll))
        sc = np.maximum(sc, 0) + pseudocount
        tc = np.maximum(tc, 0) + pseudocount
        ec = np.maximum(ec, 0) + pseudocount
        params.start_homologous = float(sc[0] / sc.sum())
        # row-normalize transitions, preserving the fixed stop mass
        stop = np.array([params.go_stop_from_homologous,
                         params.go_stop_from_unrelated])
        tnorm = tc / tc.sum(axis=1, keepdims=True) * (1.0 - stop)[:, None]
        params.go_unrelated = float(tnorm[0, 1])
        params.go_homologous = float(tnorm[1, 0])
        enorm = ec / ec.sum(axis=1, keepdims=True)
        params.emit_homologous = enorm[0]
        params.emit_unrelated = enorm[1]
    return params, lls
