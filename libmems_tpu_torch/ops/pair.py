"""The pair fast path's table passes (kernels K18 and K19, csrc/pair.cu).

Port of the stages of libmems_tpu/matchfind.py's _fused_pair_pipeline
between its two sorts (the G = 2 unique-MUM pipeline of ``find_mums``):

* ``pair_cluster_words`` (K18): one word per seed window of both genomes
  (content | gid | pos | strand), sorted; a content run of exactly one
  window of genome 0 then one of genome 1 is a candidate pair, and its
  cluster word ``fwd | biased diagonal | posA`` is kept, in the order of
  the sorted seed words; the candidate count;
* ``pair_reps`` (K19): over the sorted cluster words, the diagonal
  clusters' representatives as compact [EC, 2] extension rows for K2,
  each seeded with its cluster's extent.

64-bit words are int64 tensors holding unsigned patterns (right shifts
mask the sign fill, sorts flip bit 63); -1 is the all-ones sentinel.
Both sorts stay ``torch.sort`` (library sorts in the JAX package too).
Each wrapper takes its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch.ops.pairwise import scan_scratch, shr, usort


def _nxt(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    return torch.cat([x[k:], torch.full((k,), fill, dtype=x.dtype,
                                        device=x.device)])


def pair_cluster_words_plain(keys_a, keys_b, pos_bits: int,
                             sent_content: int):
    """Plain PyTorch version of K18 (matchfind.py:499-543)."""
    pb = pos_bits
    dev = keys_a.device
    pmask = (1 << pb) - 1

    def pack(keys, gid):
        content = shr(keys, 1)
        strand = keys & 1
        pos = torch.arange(keys.shape[0], dtype=torch.int64, device=dev)
        return (content << (pb + 2)) | (gid << (pb + 1)) | (pos << 1) \
            | strand

    w = usort(torch.cat([pack(keys_a, 0), pack(keys_b, 1)]))
    c = shr(w, pb + 2)
    gid = shr(w, pb + 1) & 1
    pos = shr(w, 1) & pmask
    strand = w & 1

    cmax = (1 << (64 - pb - 2)) - 1        # ~0 >> (pb + 2)
    c1 = _nxt(c, 1, cmax)
    c2 = _nxt(c, 2, cmax)
    cp = torch.cat([torch.full((1,), -1, dtype=c.dtype, device=dev),
                    c[:-1]])
    g1 = _nxt(gid, 1, 0)
    # exact-pair run: length 2, one occurrence per genome (row = genome 0)
    surv = (c == c1) & (c != cp) & (c1 != c2) & (gid == 0) & (g1 == 1)
    # the masked-window sentinel content never survives
    surv &= c != sent_content

    posA = pos
    posB = _nxt(pos, 1, 0)
    fwd = strand == _nxt(strand, 1, 0)

    # cluster word: (fwd | biased diagonal | posA), the survivors' only
    delta_b = torch.where(fwd, posB - posA + (1 << pb), posB + posA)
    cw = (fwd.to(torch.int64) << (2 * pb + 2)) | (delta_b << pb) | posA
    cw = cw[surv]
    return cw, cw.shape[0]


@cuda.launcher
def pair_cluster_words(keys_a, keys_b, pos_bits: int, sent_content: int):
    """(cluster words int64[n_cands] of the candidate pairs, in the
    order of the sorted seed words, n_cands).

    keys_a, keys_b: int64 keys of the two genomes in position order;
    sent_content: the masked-window content (``ops.mers.sentinel_content``).
    CPU tensors take the plain version; CUDA tensors launch K18 (pack,
    ``torch.sort``, then flags and words compacted in one pass) and read
    the count once."""
    if keys_a.device.type == "cpu":
        return pair_cluster_words_plain(keys_a, keys_b, pos_bits,
                                        sent_content)
    dev = keys_a.device
    na, nb = keys_a.shape[0], keys_b.shape[0]
    n = na + nb
    cuda.require(keys_a, "keys_a", torch.int64, dev, (na,))
    cuda.require(keys_b, "keys_b", torch.int64, dev, (nb,))
    lib = cuda.library()
    stream = cuda.stream(keys_a)
    w = torch.empty(n, dtype=torch.int64, device=dev)
    cuda.check(lib.lm_pair_pack(keys_a.data_ptr(), na, keys_b.data_ptr(), nb,
                                pos_bits, w.data_ptr(), stream),
               "lm_pair_pack")
    w = usort(w)
    cw = torch.empty(n, dtype=torch.int64, device=dev)
    scratch = scan_scratch(n, dev)
    cuda.check(lib.lm_pair_cluster_words(
        w.data_ptr(), n, pos_bits, sent_content, cw.data_ptr(),
        scratch.data_ptr(), stream), "lm_pair_cluster_words")
    pair_cluster_words.launches += 1
    # the one host read: the candidates' count
    n_cands = int(scratch[1])
    return cw[:n_cands], n_cands


pair_cluster_words.launches = 0


class PairReps(NamedTuple):
    lefts: torch.Tensor      # int32[EC, 2]
    present: torch.Tensor    # bool[EC, 2]
    is_fwd: torch.Tensor     # bool[EC, 2]
    lengths0: torch.Tensor   # int32[EC]
    n_reps: int


def pair_reps_plain(cw, ec: int, pos_bits: int, seed_len: int) -> PairReps:
    """Plain PyTorch version of K19 (matchfind.py:546-594)."""
    pb = pos_bits
    dev = cw.device
    if cw.shape[0] == 0:
        # no candidate: one invalid word gives the same absent rows
        cw = torch.full((1,), -1, dtype=torch.int64, device=dev)
    pmask = (1 << pb) - 1
    valid_c = cw != -1
    s_posA = cw & pmask
    head = shr(cw, pb)
    prev_head = torch.cat([torch.full((1,), -1, dtype=cw.dtype, device=dev),
                           head[:-1]])
    prev_posA = torch.cat([torch.zeros(1, dtype=cw.dtype, device=dev),
                           s_posA[:-1]])
    rep = valid_c & ((head != prev_head) | (s_posA - prev_posA > seed_len))
    n_cands = valid_c.sum()
    n_reps = rep.sum()

    # compact reps to EC slots: the row of the j-th rep is a binary
    # search over the cumsum of the rep flags
    rank = torch.cumsum(rep.to(torch.int64), 0)
    src = torch.searchsorted(
        rank, torch.arange(1, ec + 1, dtype=torch.int64, device=dev),
        side="left")
    e_valid = torch.arange(ec, device=dev) < n_reps
    # cluster extent: the cluster's last member is the row before the
    # next rep (or the last valid candidate row; taken before the clamp
    # below, since the candidates may fill cw to its end)
    next_src = torch.cat([src[1:], torch.full((1,), cw.shape[0],
                                              dtype=src.dtype, device=dev)])
    src = src.clamp(max=cw.shape[0] - 1)
    rep_cw = cw[src]
    r_posA = rep_cw & pmask
    r_delta = shr(rep_cw, pb) & ((1 << (pb + 2)) - 1)
    r_fwd = (shr(rep_cw, 2 * pb + 2) & 1) == 1

    end_row = torch.minimum(next_src, n_cands) - 1
    end_row = end_row.clamp(0, cw.shape[0] - 1)
    last_posA = torch.maximum(cw[end_row] & pmask, r_posA)
    span = last_posA - r_posA

    lengths0 = torch.where(e_valid, span + seed_len, seed_len)
    # genome-B left end of the cluster-covering match
    posB_rep = torch.where(r_fwd, r_delta - (1 << pb) + r_posA,
                           r_delta - r_posA)
    leftB = torch.where(r_fwd, posB_rep, r_delta - last_posA).clamp(min=0)

    present = e_valid[:, None].expand(ec, 2).contiguous()
    lefts = torch.stack([r_posA, leftB], dim=1)
    lefts = torch.where(present, lefts, 0).to(torch.int32)
    is_fwd = torch.stack([torch.ones_like(r_fwd), r_fwd], dim=1)
    return PairReps(lefts, present, is_fwd, lengths0.to(torch.int32),
                    int(n_reps))


@cuda.launcher
def pair_reps(cw, ec: int, pos_bits: int, seed_len: int) -> PairReps:
    """Representatives of the sorted cluster words as EC extension rows
    (rows past min(n_reps, EC) are absent: zero left ends, forward,
    length seed_len).

    cw: int64[m] cluster words in unsigned order (K18's candidates; any
    -1 words last).  CPU tensors take the plain version; CUDA tensors
    launch K19."""
    if cw.device.type == "cpu":
        return pair_reps_plain(cw, ec, pos_bits, seed_len)
    dev = cw.device
    m = cw.shape[0]
    cuda.require(cw, "cw", torch.int64, dev, (m,))
    lib = cuda.library()
    stream = cuda.stream(cw)
    rep = torch.empty(m, dtype=torch.int32, device=dev)
    n_cands = torch.zeros(1, dtype=torch.int64, device=dev)
    cuda.check(lib.lm_pair_rep_flags(cw.data_ptr(), m, pos_bits, seed_len,
                                     rep.data_ptr(), n_cands.data_ptr(),
                                     stream), "lm_pair_rep_flags")
    rank = torch.cumsum(rep, 0, dtype=torch.int32)
    n_reps = int(rank[-1]) if m else 0
    src = torch.empty(max(ec, 1), dtype=torch.int64, device=dev)
    lefts = torch.empty((ec, 2), dtype=torch.int32, device=dev)
    present = torch.empty((ec, 2), dtype=torch.bool, device=dev)
    is_fwd = torch.empty((ec, 2), dtype=torch.bool, device=dev)
    lengths0 = torch.empty(ec, dtype=torch.int32, device=dev)
    cuda.check(lib.lm_pair_reps(
        cw.data_ptr(), rep.data_ptr(), rank.data_ptr(), m, ec,
        min(n_reps, ec), n_cands.data_ptr(), pos_bits, seed_len,
        src.data_ptr(), lefts.data_ptr(), present.data_ptr(),
        is_fwd.data_ptr(), lengths0.data_ptr(), stream), "lm_pair_reps")
    pair_reps.launches += 1
    return PairReps(lefts, present, is_fwd, lengths0, n_reps)


pair_reps.launches = 0
