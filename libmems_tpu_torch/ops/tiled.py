"""The position-tiled extension's probe round (kernels K29-K31,
csrc/tiled.cu).

Port of the span fetch of libmems_tpu/parallel/shard.py:538
(``_dist_fetch_factory``, with ops/extend.py:66 ``_fetch_spans``) and of
the probe of ops/extend.py:210 ``make_probe_round`` on the fetched spans.
The position-order key table is cut into tiles of S keys, each with a
halo of C + 128 keys, one tile a shard; a probe round asks the owner of
each span start for its C keys:

* ``tiled_requests`` (K29): for each present genome of each row of a
  block of active rows, the span start in the padded global space, its
  owner clip(start // S, 0, n_dev - 1) and its slot among the requests to
  that owner in (row, genome) order, in one launch with no host read; the
  send buffer of tile-local starts, owner-major; the tally of each
  owner's count, where its answer starts in the concatenated answer, and
  the requests past req_cap, which the caller reads once a fetch;
* ``tiled_serve`` (K30): the owner's copy of tile[s : s + C] for each
  received start s, the sentinel row for a start outside its tile, a
  warp a span with evict-first stores;
* ``tiled_probe`` (K31): the round on the spans (reversed for genomes
  moving left), updating the rows' left ends, lengths and activity: up
  to WARP_GENOMES genomes a row a warp a row over ballot words of the
  spans, reading no further than the chain's break; wider rows a block
  a row.

Each wrapper takes its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors; a count of launches sits on each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libmems_tpu_torch import cuda
from libmems_tpu_torch.ops.extend import WARP_GENOMES, probe_advance

class Requests(NamedTuple):
    """K29's output.  send: int64[n_dev, cap] tile-local starts, owner o's
    first tally[o] filled in (row, genome) order; where: int64[Rb, G]
    (owner << 32) | slot, -1 for none; tally: int64[2 n_dev + 1], each
    owner's count (clamped to req_cap), their exclusive offsets, and the
    requests past req_cap."""

    send: torch.Tensor
    where: torch.Tensor
    tally: torch.Tensor

    @property
    def offsets(self) -> torch.Tensor:
        """int64[n_dev]: where each owner's answer starts in the
        concatenation of the answers in owner order (K31's resp_off)."""
        n_dev = self.send.shape[0]
        return self.tally[n_dev:2 * n_dev]


def tally_rows(n: int, n_dev: int, device) -> torch.Tensor:
    """int64[n, 2 n_dev + 1] on `device`, uninitialised: a tally row for
    each of n launches of K29 (a buffer read to the host with one copy)."""
    return torch.empty((n, 2 * n_dev + 1), dtype=torch.int64, device=device)


def tally_counts(tally: list, n_dev: int):
    """(counts to each owner, requests past req_cap) from a tally read to
    the host."""
    return tally[:n_dev], tally[2 * n_dev]


def _span_starts(rows, lefts, lengths, present, is_fwd, gen_off, side: int,
                 C: int, seed_len: int, big: int):
    """int64[Rb, G] span starts in the padded global space
    (ops/extend.py:235-239) and the request mask (present genomes)."""
    l = lefts[rows].to(torch.int64)
    n = lengths[rows].to(torch.int64)[:, None]
    f = is_fwd[rows]
    back = f if side == 0 else ~f
    start = torch.where(back, l - C, l + n - seed_len + 1) \
        + gen_off.to(torch.int64)[None] + big
    return start, present[rows]


def tiled_requests_plain(rows, lefts, lengths, present, is_fwd, gen_off,
                         side: int, C: int, seed_len: int, big: int, S: int,
                         n_dev: int, req_cap: int,
                         tally=None) -> Requests:
    """Plain PyTorch version of K29: the slots by a per-owner cumsum, the
    layout of the kernel's (`tally`, if given, is filled too)."""
    dev = lefts.device
    start, asks = _span_starts(rows, lefts, lengths, present, is_fwd,
                               gen_off, side, C, seed_len, big)
    owner = torch.clamp(torch.div(start, S, rounding_mode="floor"), 0,
                        n_dev - 1)
    local = (start - owner * S).flatten()
    owner = torch.where(asks, owner, n_dev).flatten()
    hot = torch.nn.functional.one_hot(owner, n_dev + 1)[:, :n_dev]
    slot = (torch.cumsum(hot, 0) - hot).gather(
        1, owner.clamp(max=n_dev - 1)[:, None]).squeeze(1)
    totals = hot.sum(0)
    sent = totals.clamp(max=req_cap)
    ok = (owner < n_dev) & (slot < req_cap)
    cap = min(req_cap, owner.shape[0])
    send = torch.empty((n_dev, cap), dtype=torch.int64, device=dev)
    send[owner[ok], slot[ok]] = local[ok]
    where = torch.where(ok, owner * (1 << 32) + slot, -1)
    t = torch.cat([sent, torch.cumsum(sent, 0) - sent,
                   (totals - sent).sum().view(1)])
    if tally is None:
        tally = t
    else:
        tally.copy_(t)
    return Requests(send, where.view(start.shape), tally)


@cuda.launcher
def tiled_requests(rows, lefts, lengths, present, is_fwd, gen_off,
                   side: int, C: int, seed_len: int, big: int, S: int,
                   n_dev: int, req_cap: int, tally=None) -> Requests:
    """Span requests of a block of rows, grouped by the owner of their
    start.

    rows: int64[Rb] the block's rows (active) of lefts int32[R, G],
    lengths int32[R], present and is_fwd bool[R, G]; gen_off int32[G] the
    genomes' offsets in the table; side 0 or 1; C the probe width; big the
    sentinel padding before the table; S the tile size; req_cap the
    requests one owner takes; tally: int64[2 n_dev + 1] on the device to
    write the tally into (a row of `tally_rows`, which the caller reads
    once for every shard), or None for a new one.  Returns the tile-local starts
    sent to each owner in (row, genome) order, owner-major
    (int64[n_dev, min(req_cap, Rb * G)]), each request's (owner << 32) |
    slot (-1 for an absent genome or a request past req_cap), and the
    tally: each owner's count, their exclusive offsets and the requests
    past req_cap.  Nothing is read to the host.  CPU tensors take the
    plain version; CUDA tensors launch K29 (one pass, a decoupled
    look-back between its tiles), except for an empty block (nothing
    launched, a zero tally)."""
    if lefts.device.type == "cpu":
        return tiled_requests_plain(rows, lefts, lengths, present, is_fwd,
                                    gen_off, side, C, seed_len, big, S,
                                    n_dev, req_cap, tally)
    dev = lefts.device
    R, G = lefts.shape
    Rb = rows.shape[0]
    cuda.require(rows, "rows", torch.int64, dev, (Rb,))
    cuda.require(lefts, "lefts", torch.int32, dev, (R, G))
    cuda.require(lengths, "lengths", torch.int32, dev, (R,))
    cuda.require(present, "present", torch.bool, dev, (R, G))
    cuda.require(is_fwd, "is_fwd", torch.bool, dev, (R, G))
    cuda.require(gen_off, "gen_off", torch.int32, dev, (G,))
    if tally is None:
        tally = tally_rows(1, n_dev, dev)[0]
    cuda.require(tally, "tally", torch.int64, dev, (2 * n_dev + 1,))
    n = Rb * G
    cap = min(req_cap, n)
    send = torch.empty((n_dev, cap), dtype=torch.int64, device=dev)
    where = torch.empty((Rb, G), dtype=torch.int64, device=dev)
    if Rb == 0:
        tally.zero_()
        return Requests(send, where, tally)
    if n >= 1 << 31:
        raise ValueError(f"K29: {n} requests a block exceed 2^31 - 1")
    lib = cuda.library()
    scratch = torch.empty(lib.lm_tiled_request_scratch_words(n, n_dev),
                          dtype=torch.int64, device=dev)
    cuda.check(lib.lm_tiled_requests(
        rows.data_ptr(), Rb, G, lefts.data_ptr(), lengths.data_ptr(),
        present.data_ptr(), is_fwd.data_ptr(), gen_off.data_ptr(), side, C,
        seed_len, big, S, n_dev, req_cap, cap, send.data_ptr(),
        where.data_ptr(), scratch.data_ptr(), tally.data_ptr(),
        cuda.stream(lefts)), "lm_tiled_requests")
    tiled_requests.launches += 1
    return Requests(send, where, tally)


tiled_requests.launches = 0


def tiled_serve_plain(tile, S: int, offs, C: int, fill: int):
    """Plain PyTorch version of K30: a gather."""
    idx = offs[:, None] + torch.arange(C, device=tile.device)[None]
    ok = (offs >= 0) & (offs < S)
    got = tile[idx.clamp(0, tile.shape[0] - 1)]
    return torch.where(ok[:, None], got, torch.full_like(got, fill))


@cuda.launcher
def tiled_serve(tile, S: int, offs, C: int, fill: int):
    """An owner's answer to span requests: int64[n, C] rows tile[s : s +
    C] for each tile-local start s of offs int64[n], the sentinel row
    `fill` where s lies outside [0, S).  tile: int64[S + halo], halo >=
    C.  CPU tensors take the plain version; CUDA tensors launch K30 (a
    warp a span), except for no requests (nothing launched)."""
    if tile.device.type == "cpu":
        return tiled_serve_plain(tile, S, offs, C, fill)
    dev = tile.device
    n = offs.shape[0]
    cuda.require(tile, "tile", torch.int64, dev, (tile.shape[0],))
    cuda.require(offs, "offs", torch.int64, dev, (n,))
    if tile.shape[0] < S + C:
        raise ValueError(f"tile of {tile.shape[0]} keys: S + C = {S + C}")
    out = torch.empty((n, C), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    cuda.check(cuda.library().lm_tiled_serve(
        tile.data_ptr(), S, offs.data_ptr(), n, C, fill, out.data_ptr(),
        cuda.stream(tile)), "lm_tiled_serve")
    tiled_serve.launches += 1
    return out


tiled_serve.launches = 0


def _spans(resp, where, C: int, fill: int, resp_off):
    """int64[Rb, G, C] span of each request, the sentinel row where none
    was answered."""
    if resp.shape[0] == 0:
        return torch.full((*where.shape, C), fill, dtype=torch.int64,
                          device=where.device)
    w = where.clamp(min=0)
    got = resp[resp_off[w >> 32] + (w & 0xFFFFFFFF)]
    return torch.where((where >= 0)[..., None], got, torch.full_like(got,
                                                                     fill))


def tiled_probe_plain(resp, where, rows, lefts, lengths, present, is_fwd,
                      gen_cnt, active, side: int, C: int, seed_len: int,
                      fill: int, resp_off) -> None:
    """Plain PyTorch version of K31: ops.extend.probe_advance on the
    spans."""
    Rb, G = where.shape
    f = is_fwd[rows]
    back = f if side == 0 else ~f
    spans = _spans(resp, where, C, fill, resp_off)
    keys_g = [torch.where(back[:, g:g + 1], spans[:, g].flip(1), spans[:, g])
              for g in range(G)]
    l2, n2, a2 = probe_advance(
        keys_g, fill, seed_len, C, side,
        gen_cnt[None].expand(Rb, G), lefts[rows], present[rows], f,
        lengths[rows], active[rows])
    lefts[rows] = l2
    lengths[rows] = n2
    active[rows] = a2


@cuda.launcher
def tiled_probe(resp, where, rows, lefts, lengths, present, is_fwd, gen_cnt,
                active, side: int, C: int, seed_len: int, fill: int,
                resp_off) -> None:
    """One probe round of a block of active rows on their fetched spans.

    resp: int64[n, C] the answered spans, the owners' answers one after
    another; where: int64[Rb, G] each request's (owner << 32) | slot, its
    row of resp resp_off[owner] + slot (K29's layout; -1: none, read as
    sentinel keys); resp_off: int64[n_dev], where each owner's answer
    starts in resp (K29's Requests.offsets); rows:
    int64[Rb] the block's rows of lefts int32[R, G], lengths int32[R] and
    active bool[R], updated in place; present, is_fwd: bool[R, G];
    gen_cnt: int32[G] window counts; every row of the block has a
    present genome (active rows start from present.any).  CPU tensors
    take the plain version; CUDA tensors launch K31, except for an empty
    block (nothing launched): a warp a row up to WARP_GENOMES genomes,
    else a block a row with its state in shared memory."""
    if rows.shape[0] == 0:
        return
    if lefts.device.type == "cpu":
        return tiled_probe_plain(resp, where, rows, lefts, lengths, present,
                                 is_fwd, gen_cnt, active, side, C, seed_len,
                                 fill, resp_off)
    dev = lefts.device
    R, G = lefts.shape
    Rb = rows.shape[0]
    cuda.require(resp, "resp", torch.int64, dev, (resp.shape[0], C))
    cuda.require(where, "where", torch.int64, dev, (Rb, G))
    cuda.require(rows, "rows", torch.int64, dev, (Rb,))
    cuda.require(lefts, "lefts", torch.int32, dev, (R, G))
    cuda.require(lengths, "lengths", torch.int32, dev, (R,))
    cuda.require(present, "present", torch.bool, dev, (R, G))
    cuda.require(is_fwd, "is_fwd", torch.bool, dev, (R, G))
    cuda.require(gen_cnt, "gen_cnt", torch.int32, dev, (G,))
    cuda.require(active, "active", torch.bool, dev, (R,))
    cuda.require(resp_off, "resp_off", torch.int64, dev,
                 (resp_off.shape[0],))
    lib = cuda.library()
    if G > WARP_GENOMES and \
            lib.lm_tiled_probe_row_bytes(G) > lib.lm_tiled_probe_smem_limit():
        raise ValueError(f"K31: {G} genomes a row exceed the shared memory "
                         "a block may take")
    cuda.check(lib.lm_tiled_probe(
        resp.data_ptr(), where.data_ptr(), resp_off.data_ptr(),
        rows.data_ptr(), Rb, G,
        lefts.data_ptr(), lengths.data_ptr(), present.data_ptr(),
        is_fwd.data_ptr(), gen_cnt.data_ptr(), active.data_ptr(), side, C,
        seed_len, fill, cuda.stream(lefts)), "lm_tiled_probe")
    tiled_probe.launches += 1


tiled_probe.launches = 0
