"""The pairwise seeder's table passes (kernels K5-K7, csrc/pairwise.cu).

Port of the device stages of libmems_tpu/matchfind.py's
_fused_pairwise_pipeline / _pairwise_core and of the ops/segments.py run
helpers they use (PairwiseMatchFinder::EnumerateMatches,
libMems/PairwiseMatchFinder.cpp:37-71):

* ``run_flags`` (K5): per row of the (content, gid, pos)-sorted seed
  table its genome, position, strand, run id and the unique-occurrence
  flag ``(subrun_len == 1) & (runlen <= repeat_limit) & not_sent``
  (``_unique_occ_flags``; gid and pos replace ``_padded_table_meta``);
* ``cluster_words`` (K6): the kept rows' G-1 shifted compares as packed
  cluster words ``fwd | pair_id | delta | posA`` (-1 where invalid);
* ``cluster_reps`` (K7): diagonal-cluster representatives of the sorted
  words and their compact [EC, 2] extension rows for K2.

64-bit words are int64 tensors holding unsigned patterns (right shifts
mask the sign fill, sorts flip bit 63); -1 is the all-ones sentinel.
Each wrapper takes its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libmems_tpu_torch import cuda

_I64_MIN = -(1 << 63)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of 64-bit patterns held in int64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def usort(x: torch.Tensor) -> torch.Tensor:
    """Sort 64-bit patterns held in int64 in unsigned order."""
    return torch.sort(x ^ _I64_MIN).values ^ _I64_MIN


def cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


class RunFlags(NamedTuple):
    unique_occ: torch.Tensor   # bool[n]
    run_id: torch.Tensor       # int32[n]
    gid: torch.Tensor          # int32[n]
    pos: torch.Tensor          # int32[n]
    strand: torch.Tensor       # uint8[n]


def seed_table_meta(src, keys, seg_off, row_keys: bool = False):
    """Genome, position and strand of each sorted row from its source
    index into keys (the position-order concatenation; seg_off int64[G+1]
    the genome bounds).  With row_keys, keys are the rows' own keys
    (int64[n]) and give the strand row by row."""
    gid = torch.searchsorted(seg_off, src, right=True) - 1
    pos = (src - seg_off[gid]).to(torch.int32)
    strand = ((keys if row_keys else keys[src]) & 1).to(torch.uint8)
    return gid.to(torch.int32), pos, strand


def run_flags_plain(content, src, keys, seg_off, repeat_limit: int,
                    sent_content: int) -> RunFlags:
    """Plain PyTorch version of K5."""
    n = content.shape[0]
    dev = content.device
    gid, pos, strand = seed_table_meta(src, keys, seg_off)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    sc = torch.cat([one, content[1:] != content[:-1]])
    scg = sc | torch.cat([one, gid[1:] != gid[:-1]])
    rid1 = cumsum32(sc)
    starts = torch.nonzero(sc).flatten()
    bounds = torch.cat([starts, torch.full((1,), n, dtype=starts.dtype,
                                           device=dev)])
    r = (rid1 - 1).to(torch.int64)
    runlen = bounds[r + 1] - bounds[r]
    sub1 = scg & torch.cat([scg[1:], one])
    unique_occ = sub1 & (runlen <= repeat_limit) & (content != sent_content)
    return RunFlags(unique_occ, (rid1 - 1).to(torch.int32), gid, pos, strand)


@cuda.launcher
def run_flags(content, src, keys, seg_off, repeat_limit: int,
              sent_content: int) -> RunFlags:
    """Run flags of the sorted seed table.

    content: int64[n] sorted contents (key >> 1); src: int64[n] each
    row's index into keys, the int64 position-order concatenation of the
    genomes' keys; seg_off: int64[G+1] genome bounds in keys.  CPU
    tensors take the plain version; CUDA tensors launch K5."""
    if content.device.type == "cpu":
        return run_flags_plain(content, src, keys, seg_off, repeat_limit,
                               sent_content)
    dev = content.device
    n = content.shape[0]
    G = seg_off.shape[0] - 1
    cuda.require(content, "content", torch.int64, dev, (n,))
    cuda.require(src, "src", torch.int64, dev, (n,))
    cuda.require(keys, "keys", torch.int64, dev, (keys.shape[0],))
    cuda.require(seg_off, "seg_off", torch.int64, dev, (G + 1,))
    i32 = dict(dtype=torch.int32, device=dev)
    sc = torch.empty(n, **i32)
    gid = torch.empty(n, **i32)
    pos = torch.empty(n, **i32)
    strand = torch.empty(n, dtype=torch.uint8, device=dev)
    lib = cuda.library()
    stream = cuda.stream(content)
    cuda.check(lib.lm_run_starts(
        content.data_ptr(), src.data_ptr(), keys.data_ptr(), 0,
        seg_off.data_ptr(), G, n, sc.data_ptr(), gid.data_ptr(),
        pos.data_ptr(), strand.data_ptr(), stream), "lm_run_starts")
    rid1 = torch.cumsum(sc, 0, dtype=torch.int32)
    run_start = torch.empty(n + 1, dtype=torch.int64, device=dev)
    unique_occ = torch.empty(n, dtype=torch.bool, device=dev)
    run_id = torch.empty(n, **i32)
    cuda.check(lib.lm_run_flags(
        content.data_ptr(), sc.data_ptr(), gid.data_ptr(), rid1.data_ptr(),
        run_start.data_ptr(), n, repeat_limit, sent_content,
        unique_occ.data_ptr(), run_id.data_ptr(), stream), "lm_run_flags")
    run_flags.launches += 1
    return RunFlags(unique_occ, run_id, gid, pos, strand)


run_flags.launches = 0


def pair_bits_for(G: int) -> int:
    """Bits of the pair id field: 2 * ceil(log2(G-1)) as the JAX word."""
    return 2 * max(G - 1, 1).bit_length()


def cluster_words_plain(flags: RunFlags, G: int, pos_bits: int
                        ) -> torch.Tensor:
    """Plain PyTorch version of K6."""
    keep = flags.unique_occ
    rid = flags.run_id[keep].to(torch.int64)
    gid = flags.gid[keep].to(torch.int64)
    pos = flags.pos[keep].to(torch.int64)
    st = flags.strand[keep]
    kept = rid.shape[0]
    pair_bits = pair_bits_for(G)
    bias = 1 << pos_bits
    out = []
    for s in range(1, G):
        n_ok = max(kept - s, 0)
        w = torch.full((kept,), -1, dtype=torch.int64, device=rid.device)
        a = slice(0, n_ok)
        b = slice(s, s + n_ok)
        fwd = st[a] == st[b]
        pair = gid[a] * G + gid[b]
        delta = torch.where(fwd, pos[b] - pos[a] + bias, pos[b] + pos[a])
        word = (fwd.to(torch.int64) << (pair_bits + 2 * pos_bits + 2)) \
            | (pair << (2 * pos_bits + 2)) | (delta << pos_bits) | pos[a]
        w[:n_ok] = torch.where(rid[a] == rid[b], word, -1)
        out.append(w)
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=rid.device)
    return torch.cat(out)


@cuda.launcher
def cluster_words(flags: RunFlags, G: int, pos_bits: int) -> torch.Tensor:
    """Unsorted cluster words int64[(G-1) * kept_count]: the word of
    shift s and kept row k pairs k with kept row k+s of the same run.
    CPU tensors take the plain version; CUDA tensors launch K6."""
    keep = flags.unique_occ
    if keep.device.type == "cpu":
        return cluster_words_plain(flags, G, pos_bits)
    dev = keep.device
    n = keep.shape[0]
    for name, t, dt in (("unique_occ", keep, torch.bool),
                        ("run_id", flags.run_id, torch.int32),
                        ("gid", flags.gid, torch.int32),
                        ("pos", flags.pos, torch.int32),
                        ("strand", flags.strand, torch.uint8)):
        cuda.require(t, name, dt, dev, (n,))
    rank = cumsum32(keep)
    kept = int(rank[-1]) if n else 0
    i32 = dict(dtype=torch.int32, device=dev)
    k_rid = torch.empty(kept, **i32)
    k_gid = torch.empty(kept, **i32)
    k_pos = torch.empty(kept, **i32)
    k_str = torch.empty(kept, dtype=torch.uint8, device=dev)
    out = torch.empty(kept * (G - 1), dtype=torch.int64, device=dev)
    lib = cuda.library()
    cuda.check(lib.lm_cluster_words(
        keep.data_ptr(), rank.data_ptr(), n, flags.run_id.data_ptr(),
        flags.gid.data_ptr(), flags.pos.data_ptr(), flags.strand.data_ptr(),
        k_rid.data_ptr(), k_gid.data_ptr(), k_pos.data_ptr(),
        k_str.data_ptr(), kept, G, pos_bits, pair_bits_for(G),
        out.data_ptr(), cuda.stream(keep)), "lm_cluster_words")
    cluster_words.launches += 1
    return out


cluster_words.launches = 0


class Reps(NamedTuple):
    lefts: torch.Tensor      # int32[EC, 2]
    present: torch.Tensor    # bool[EC, 2]
    is_fwd: torch.Tensor     # bool[EC, 2]
    gen_off: torch.Tensor    # int32[EC, 2]
    gen_cnt: torch.Tensor    # int32[EC, 2]
    lengths0: torch.Tensor   # int32[EC]
    r_a: torch.Tensor        # int32[EC] genome of column 0
    r_b: torch.Tensor        # int32[EC] genome of column 1
    n_reps: int


def cluster_reps_plain(cw, ec: int, G: int, pos_bits: int, seed_len: int,
                       gen_off, gen_cnt) -> Reps:
    """Plain PyTorch version of K7 (matchfind.py:1163-1214)."""
    dev = cw.device
    m = cw.shape[0]
    pmask = (1 << pos_bits) - 1
    pair_bits = pair_bits_for(G)
    bias = 1 << pos_bits
    valid = cw != -1
    s_pos = cw & pmask
    head = shr(cw, pos_bits)
    prev_head = torch.cat([torch.full((1,), -1, dtype=cw.dtype, device=dev),
                           head[:-1]])
    prev_pos = torch.cat([torch.zeros(1, dtype=cw.dtype, device=dev),
                          s_pos[:-1]])
    rep = valid & ((head != prev_head) | (s_pos - prev_pos > seed_len))
    n_cands = int(valid.sum())
    n_reps = int(rep.sum())
    n_valid = min(n_reps, ec)
    src = torch.nonzero(rep).flatten()[:n_valid]
    nxt = torch.cat([src[1:], torch.full((1,), n_cands, dtype=src.dtype,
                                         device=dev)])[:n_valid]
    w = cw[src]
    r_pos = w & pmask
    r_delta = shr(w, pos_bits) & ((1 << (pos_bits + 2)) - 1)
    r_pair = shr(w, 2 * pos_bits + 2) & ((1 << pair_bits) - 1)
    r_fwd = (shr(w, pair_bits + 2 * pos_bits + 2) & 1) == 1
    r_a = (r_pair // G).clamp(max=G - 1)
    r_b = (r_pair % G).clamp(max=G - 1)
    last = torch.maximum(cw[nxt - 1] & pmask, r_pos)
    span = last - r_pos
    pos_b = torch.where(r_fwd, r_delta - bias + r_pos, r_delta - r_pos)
    left_b = torch.where(r_fwd, pos_b, r_delta - last).clamp(min=0)

    def full(shape, val, dt):
        return torch.full(shape, val, dtype=dt, device=dev)

    lefts = full((ec, 2), 0, torch.int32)
    present = full((ec, 2), False, torch.bool)
    is_fwd = full((ec, 2), True, torch.bool)
    off2 = full((ec, 2), int(gen_off[0]), torch.int32)
    cnt2 = full((ec, 2), int(gen_cnt[0]), torch.int32)
    lengths0 = full((ec,), seed_len, torch.int32)
    ra = full((ec,), 0, torch.int32)
    rb = full((ec,), 0, torch.int32)
    v = slice(0, n_valid)
    lefts[v] = torch.stack([r_pos, left_b], 1).to(torch.int32)
    present[v] = True
    is_fwd[v, 1] = r_fwd
    off2[v] = torch.stack([gen_off[r_a], gen_off[r_b]], 1)
    cnt2[v] = torch.stack([gen_cnt[r_a], gen_cnt[r_b]], 1)
    lengths0[v] = (span + seed_len).to(torch.int32)
    ra[v] = r_a.to(torch.int32)
    rb[v] = r_b.to(torch.int32)
    return Reps(lefts, present, is_fwd, off2, cnt2, lengths0, ra, rb,
                n_reps)


@cuda.launcher
def cluster_reps(cw, ec: int, G: int, pos_bits: int, seed_len: int,
                 gen_off, gen_cnt) -> Reps:
    """Representatives of the sorted cluster words as EC compact
    extension rows (rows past min(n_reps, EC) are absent).

    cw: int64[m] cluster words in unsigned order (-1 last); gen_off,
    gen_cnt: int32[G] genome offsets and window counts in the keys that
    K2 probes.  CPU tensors take the plain version; CUDA tensors launch
    K7."""
    if cw.device.type == "cpu":
        return cluster_reps_plain(cw, ec, G, pos_bits, seed_len, gen_off,
                                  gen_cnt)
    dev = cw.device
    m = cw.shape[0]
    cuda.require(cw, "cw", torch.int64, dev, (m,))
    cuda.require(gen_off, "gen_off", torch.int32, dev, (G,))
    cuda.require(gen_cnt, "gen_cnt", torch.int32, dev, (G,))
    lib = cuda.library()
    stream = cuda.stream(cw)
    rep = torch.empty(m, dtype=torch.int32, device=dev)
    n_cands = torch.zeros(1, dtype=torch.int64, device=dev)
    cuda.check(lib.lm_rep_flags(cw.data_ptr(), m, pos_bits, seed_len,
                                rep.data_ptr(), n_cands.data_ptr(), stream),
               "lm_rep_flags")
    rank = torch.cumsum(rep, 0, dtype=torch.int32)
    n_reps = int(rank[-1]) if m else 0
    i32 = dict(dtype=torch.int32, device=dev)
    src = torch.empty(max(ec, 1), dtype=torch.int64, device=dev)
    lefts = torch.empty((ec, 2), **i32)
    present = torch.empty((ec, 2), dtype=torch.bool, device=dev)
    is_fwd = torch.empty((ec, 2), dtype=torch.bool, device=dev)
    off2 = torch.empty((ec, 2), **i32)
    cnt2 = torch.empty((ec, 2), **i32)
    lengths0 = torch.empty(ec, **i32)
    r_a = torch.empty(ec, **i32)
    r_b = torch.empty(ec, **i32)
    cuda.check(lib.lm_reps(
        cw.data_ptr(), rep.data_ptr(), rank.data_ptr(), m, ec,
        min(n_reps, ec), n_cands.data_ptr(), G, pos_bits, pair_bits_for(G),
        seed_len, gen_off.data_ptr(), gen_cnt.data_ptr(), src.data_ptr(),
        lefts.data_ptr(), present.data_ptr(), is_fwd.data_ptr(),
        off2.data_ptr(), cnt2.data_ptr(), lengths0.data_ptr(),
        r_a.data_ptr(), r_b.data_ptr(), stream), "lm_reps")
    cluster_reps.launches += 1
    return Reps(lefts, present, is_fwd, off2, cnt2, lengths0, r_a, r_b,
                n_reps)


cluster_reps.launches = 0
