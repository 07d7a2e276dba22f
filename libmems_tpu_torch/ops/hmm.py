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
above).  The port runs every length through one f64 forward/backward:
identical to the f64 tiers, and at 2^17 columns or more it can differ
from the JAX f32 tier only where a posterior lies within about 1e-3 of
the threshold (ROADMAP queue 3).  Sequences are grouped by the JAX
package's length buckets (a power of two, at least 64) into padded
batches, each split so a launch holds at most FB_MAX_ELEMS columns; the
grouping never changes an output.  ``viterbi_homologous`` and
``baum_welch`` (the HMMoC Viterbi and Baum-Welch API, which libMems
ships but never calls) run K20 and K21 the same way, in f64 at every
length.  Baum-Welch sums each sequence's expected counts in column order
on the device and the sequences' sums in index order on the host, so
the kernel and its plain version add in the same order.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from libmems_tpu_torch import cuda

POSTERIOR_THRESHOLD = 0.9   # homologymain.cc:50

# columns per launch: the kernel keeps 16 bytes of forward values per
# column, so a launch holds at most 1 GiB of them
FB_MAX_ELEMS = 1 << 26


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


def fb_posterior_plain(obs, lengths, mats, threshold: float):
    """Plain PyTorch version of K8: the two lax.scans of
    ops/hmm.py:_fb_posterior, with its length masking, in f64.  The
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


def _host_mats(mats) -> ctypes.Array:
    """The 24 f64 matrix entries as the host array the launchers copy
    into the kernel (ls[2], lt[2, 2], lstop[2], le[2, 8])."""
    flat = torch.cat([m.reshape(-1) for m in mats]).to(torch.float64).cpu()
    if flat.shape[0] != 24:
        raise ValueError("mats must be ls[2], lt[2, 2], lstop[2], le[2, 8]")
    return (ctypes.c_double * 24)(*flat.tolist())


@cuda.launcher
def fb_posterior(obs, lengths, mats, threshold: float = POSTERIOR_THRESHOLD,
                 want_post: bool = True):
    """Posterior P(homologous) and calls for a padded batch.

    obs: uint8[B, T] symbols 0..7; lengths: int32[B] (1..T); mats: the
    f64 tensors (ls[2], lt[2, 2], lstop[2], le[2, 8]) on obs's device.
    Returns (post float64[B, T] or None when not want_post on CUDA,
    calls bool[B, T]), zero past each row's length.  CPU tensors take
    the plain version; CUDA tensors launch K8."""
    if obs.device.type == "cpu":
        return fb_posterior_plain(obs, lengths, mats, threshold)
    dev = obs.device
    B, T = obs.shape
    cuda.require(obs, "obs", torch.uint8, dev, (B, T))
    cuda.require(lengths, "lengths", torch.int32, dev, (B,))
    host = _host_mats(mats)
    fwd = torch.empty((B, T, 2), dtype=torch.float64, device=dev)
    post = torch.zeros((B, T), dtype=torch.float64, device=dev) \
        if want_post else None
    calls = torch.zeros((B, T), dtype=torch.bool, device=dev)
    lib = cuda.library()
    cuda.check(lib.lm_hmm_fb(
        obs.data_ptr(), lengths.data_ptr(), B, T, host, float(threshold),
        fwd.data_ptr(), post.data_ptr() if post is not None else None,
        calls.data_ptr(), cuda.stream(obs)), "lm_hmm_fb")
    fb_posterior.launches += 1
    return post, calls


fb_posterior.launches = 0


def log_matrices(params: HmmParams, device) -> tuple:
    """The log matrices as f64 tensors on `device`."""
    return tuple(torch.from_numpy(np.asarray(x, dtype=np.float64)).to(device)
                 for x in _log_matrices(params))


def pack_batches(sequences):
    """Bucket the non-empty sequences by the JAX package's padded length
    (a power of two >= 64) and split each bucket so a launch holds at
    most FB_MAX_ELEMS columns.  Yields (sequence indices, obs uint8[B,
    T], lengths int32[B]) per launch, on the host."""
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(sequences):
        if len(s):
            T = max(64, 1 << (len(s) - 1).bit_length())
            buckets.setdefault(T, []).append(i)
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


def _fb_batched(sequences, params, device, threshold, want_post):
    """Run K8 (or its plain version) on each launch of pack_batches.
    Returns per sequence (post float64 or None, calls bool) on the host;
    empty sequences give empty arrays."""
    dev = cuda.resolve_device(device)
    if params is None:
        params = hoxd_params()
    mats = log_matrices(params, dev)
    out: list = [(np.zeros(0, np.float64), np.zeros(0, bool))] \
        * len(sequences)
    for part, obs, lens in pack_batches(sequences):
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


@cuda.launcher
def viterbi_path(obs, lengths, mats):
    """Most likely state per column of a padded batch.

    obs: uint8[B, T] symbols 0..7; lengths: int32[B] (1..T); mats as for
    fb_posterior.  Returns bool[B, T], True = homologous, False at or
    past each row's length.  CPU tensors take the plain version; CUDA
    tensors launch K20."""
    if obs.device.type == "cpu":
        return viterbi_path_plain(obs, lengths, mats)
    dev = obs.device
    B, T = obs.shape
    cuda.require(obs, "obs", torch.uint8, dev, (B, T))
    cuda.require(lengths, "lengths", torch.int32, dev, (B,))
    host = _host_mats(mats)
    ptr = torch.empty((B, T), dtype=torch.uint8, device=dev)
    path = torch.zeros((B, T), dtype=torch.uint8, device=dev)
    lib = cuda.library()
    cuda.check(lib.lm_hmm_viterbi(
        obs.data_ptr(), lengths.data_ptr(), B, T, host, ptr.data_ptr(),
        path.data_ptr(), cuda.stream(obs)), "lm_hmm_viterbi")
    viterbi_path.launches += 1
    return path.to(torch.bool)


viterbi_path.launches = 0


@cuda.entry(cuda.device_arg)
def viterbi_homologous(sequences: list[np.ndarray],
                       params: HmmParams | None = None,
                       device="cuda") -> list[np.ndarray]:
    """Most-likely state path per column (True = homologous) for a batch
    of encoded symbol sequences, on `device`: the Viterbi analog of
    predict_homologous, bucketed by the JAX package's padded lengths."""
    dev = cuda.resolve_device(device)
    if params is None:
        params = hoxd_params()
    mats = log_matrices(params, dev)
    out: list = [np.zeros(0, dtype=bool)] * len(sequences)
    for part, obs, lens in pack_batches(sequences):
        path = viterbi_path(torch.from_numpy(obs).to(dev),
                            torch.from_numpy(lens).to(dev), mats)
        path = path.cpu().numpy()
        for r, i in enumerate(part):
            out[i] = path[r, :len(sequences[i])]
    return out


BW_COUNTS = 23   # start[2], trans[2, 2], emit[2, 8], logP per sequence


def bw_counts_plain(obs, lengths, mats):
    """Plain PyTorch version of K21: the forward and backward scans and
    masks of ops/hmm.py:_bw_counts, with each sequence's expected counts
    summed over its columns in column order.  Values past a row's length
    are computed but never read (the JAX scans freeze them there).
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


@cuda.launcher
def bw_counts(obs, lengths, mats):
    """Baum-Welch expected counts of each sequence of a padded batch.

    obs: uint8[B, T] symbols 0..7; lengths: int32[B] (0..T); mats as for
    fb_posterior.  Returns f64[B, 23]: start counts [2], transition
    counts [2, 2], emission counts [2, 8] and logP of each row (zeros for
    a row of length 0).  CPU tensors take the plain version; CUDA
    tensors launch K21."""
    if obs.device.type == "cpu":
        return bw_counts_plain(obs, lengths, mats)
    dev = obs.device
    B, T = obs.shape
    cuda.require(obs, "obs", torch.uint8, dev, (B, T))
    cuda.require(lengths, "lengths", torch.int32, dev, (B,))
    host = _host_mats(mats)
    fwd = torch.empty((B, T, 2), dtype=torch.float64, device=dev)
    bwd = torch.empty((B, T, 2), dtype=torch.float64, device=dev)
    part = torch.empty((B, BW_COUNTS), dtype=torch.float64, device=dev)
    lib = cuda.library()
    cuda.check(lib.lm_hmm_bw(
        obs.data_ptr(), lengths.data_ptr(), B, T, host, fwd.data_ptr(),
        bwd.data_ptr(), part.data_ptr(), cuda.stream(obs)), "lm_hmm_bw")
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
