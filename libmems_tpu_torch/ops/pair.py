"""The pair fast path's table passes (kernels K18 and K19, csrc/pair.cu).

Port of the stages of libmems_tpu/matchfind.py's _fused_pair_pipeline
between its two sorts (the G = 2 unique-MUM pipeline of ``find_mums``):

* ``pair_cluster_words`` (K18): one word per seed window of both genomes
  (content | gid | pos | strand), sorted; a content run of exactly one
  window of genome 0 then one of genome 1 is a candidate pair, and its
  cluster word ``fwd | biased diagonal | posA`` is kept, in the order of
  the sorted seed words; the candidate count;
* ``pair_reps`` (K19): over the sorted cluster words, the diagonal
  clusters' representatives found by K7's scan (``pairwise.rep_index``'s
  test on the same word tail), their count read once, then decoded into
  compact [EC, 2] extension rows for K2, each seeded with its cluster's
  extent.

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
from libmems_tpu_torch.ops.pairwise import (RepIndex, rep_index_plain,
                                            scan_scratch, shr, usort)


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


def pair_decode_reps_plain(cw, idx: RepIndex, ec: int, pos_bits: int,
                           seed_len: int) -> PairReps:
    """Plain PyTorch version of K19's decode (matchfind.py:561-594): the
    reps at word indices src, each cluster ending before word nxt (the
    last valid slot's at the last candidate), in EC slots."""
    pb = pos_bits
    dev = cw.device
    src = idx.index[:min(idx.n_reps, ec)].to(torch.int64)
    nxt = torch.cat([src[1:], idx.counts[:1]])[:src.shape[0]]
    n_valid = src.shape[0]
    pmask = (1 << pb) - 1
    w = cw[src]
    r_pos = w & pmask
    r_delta = shr(w, pb) & ((1 << (pb + 2)) - 1)
    r_fwd = (shr(w, 2 * pb + 2) & 1) == 1
    last = torch.maximum(cw[nxt - 1] & pmask, r_pos)
    # genome-B left end of the cluster-covering match
    left_b = torch.where(r_fwd, r_delta - (1 << pb) + r_pos,
                         r_delta - last).clamp(min=0)
    lefts = torch.zeros((ec, 2), dtype=torch.int32, device=dev)
    present = torch.zeros((ec, 2), dtype=torch.bool, device=dev)
    is_fwd = torch.ones((ec, 2), dtype=torch.bool, device=dev)
    lengths0 = torch.full((ec,), seed_len, dtype=torch.int32, device=dev)
    v = slice(0, n_valid)
    lefts[v] = torch.stack([r_pos, left_b], 1).to(torch.int32)
    present[v] = True
    is_fwd[v, 1] = r_fwd
    lengths0[v] = (last - r_pos + seed_len).to(torch.int32)
    return PairReps(lefts, present, is_fwd, lengths0, idx.n_reps)


def pair_reps_plain(cw, ec: int, pos_bits: int, seed_len: int) -> PairReps:
    """Plain PyTorch version of K19 (matchfind.py:546-594): K7's scan
    plain version, then the decode's."""
    return pair_decode_reps_plain(cw, rep_index_plain(cw, pos_bits,
                                                      seed_len),
                                  ec, pos_bits, seed_len)


@cuda.launcher
def pair_reps(cw, ec: int, pos_bits: int, seed_len: int) -> PairReps:
    """Representatives of the sorted cluster words as EC extension rows
    (rows past min(n_reps, EC) are absent: zero left ends, forward,
    length seed_len).

    cw: int64[m] cluster words in unsigned order (K18's candidates; any
    -1 words last).  CPU tensors take the plain version; CUDA tensors
    launch K19: K7's scan, one host read of the representatives' count,
    the decode."""
    if cw.device.type == "cpu":
        return pair_reps_plain(cw, ec, pos_bits, seed_len)
    dev = cw.device
    m = cw.shape[0]
    cuda.require(cw, "cw", torch.int64, dev, (m,))
    if m >= 1 << 31:
        raise ValueError(f"K19 indexes words with int32: {m} words")
    lib = cuda.library()
    stream = cuda.stream(cw)
    index = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
    scratch = scan_scratch(m, dev)
    cuda.check(lib.lm_pair_rep_index(cw.data_ptr(), m, pos_bits, seed_len,
                                     index.data_ptr(), scratch.data_ptr(),
                                     stream), "lm_pair_rep_index")
    # the outputs' shapes do not wait for the count: allocated while the
    # scan runs
    lefts = torch.empty((ec, 2), dtype=torch.int32, device=dev)
    present = torch.empty((ec, 2), dtype=torch.bool, device=dev)
    is_fwd = torch.empty((ec, 2), dtype=torch.bool, device=dev)
    lengths0 = torch.empty(ec, dtype=torch.int32, device=dev)
    counts = scratch[1:3]
    # the one host read: the representatives' count
    n_reps = int(counts[1])
    cuda.check(lib.lm_pair_reps(
        cw.data_ptr(), index.data_ptr(), counts.data_ptr(), min(n_reps, ec),
        ec, pos_bits, seed_len, lefts.data_ptr(), present.data_ptr(),
        is_fwd.data_ptr(), lengths0.data_ptr(), stream), "lm_pair_reps")
    pair_reps.launches += 1
    return PairReps(lefts, present, is_fwd, lengths0, n_reps)


pair_reps.launches = 0
