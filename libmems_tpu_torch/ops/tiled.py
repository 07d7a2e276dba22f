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
  that owner in (row, genome) order; the send buffer of tile-local starts
  grouped by owner, and the requests past req_cap counted;
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

_TILE = 256     # requests a tile of K29 (one thread block)


class Requests(NamedTuple):
    send: torch.Tensor      # int64[n_sent] tile-local starts, by owner
    counts: list            # requests sent to each owner (n_dev ints)
    where: torch.Tensor     # int64[Rb, G] index into send, -1: none
    dropped: int            # requests past req_cap


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
                         n_dev: int, req_cap: int) -> Requests:
    """Plain PyTorch version of K29: the slots by a per-owner cumsum."""
    dev = lefts.device
    start, asks = _span_starts(rows, lefts, lengths, present, is_fwd,
                               gen_off, side, C, seed_len, big)
    owner = torch.clamp(torch.div(start, S, rounding_mode="floor"), 0,
                        n_dev - 1)
    local = (start - owner * S).flatten()
    owner = torch.where(asks, owner, n_dev).flatten()
    hot = torch.nn.functional.one_hot(owner, n_dev + 1)[:, :n_dev]
    rank = (torch.cumsum(hot, 0) - hot).gather(
        1, owner.clamp(max=n_dev - 1)[:, None]).squeeze(1)
    totals = hot.sum(0)
    sent = totals.clamp(max=req_cap)
    send_off = torch.cumsum(sent, 0) - sent
    ok = (owner < n_dev) & (rank < req_cap)
    where = torch.where(ok, send_off[owner.clamp(max=n_dev - 1)] + rank, -1)
    send = torch.empty(int(sent.sum()), dtype=torch.int64, device=dev)
    send[where[ok]] = local[ok]
    return Requests(send, sent.tolist(), where.view(start.shape),
                    int((totals - sent).sum()))


@cuda.launcher
def tiled_requests(rows, lefts, lengths, present, is_fwd, gen_off,
                   side: int, C: int, seed_len: int, big: int, S: int,
                   n_dev: int, req_cap: int) -> Requests:
    """Span requests of a block of rows, grouped by the owner of their
    start.

    rows: int64[Rb] the block's rows (active) of lefts int32[R, G],
    lengths int32[R], present and is_fwd bool[R, G]; gen_off int32[G] the
    genomes' offsets in the table; side 0 or 1; C the probe width; big the
    sentinel padding before the table; S the tile size; req_cap the
    requests one owner takes.  Returns the tile-local starts sent to each
    owner in (row, genome) order, their counts, each request's index into
    the send buffer (-1 for an absent genome or a request past req_cap)
    and the number past req_cap.  CPU tensors take the plain version;
    CUDA tensors launch K29 (two passes around a cumsum of its tiles'
    counts), except for an empty block (nothing launched)."""
    if lefts.device.type == "cpu":
        return tiled_requests_plain(rows, lefts, lengths, present, is_fwd,
                                    gen_off, side, C, seed_len, big, S,
                                    n_dev, req_cap)
    dev = lefts.device
    R, G = lefts.shape
    Rb = rows.shape[0]
    cuda.require(rows, "rows", torch.int64, dev, (Rb,))
    cuda.require(lefts, "lefts", torch.int32, dev, (R, G))
    cuda.require(lengths, "lengths", torch.int32, dev, (R,))
    cuda.require(present, "present", torch.bool, dev, (R, G))
    cuda.require(is_fwd, "is_fwd", torch.bool, dev, (R, G))
    cuda.require(gen_off, "gen_off", torch.int32, dev, (G,))
    where = torch.empty((Rb, G), dtype=torch.int64, device=dev)
    if Rb == 0:
        return Requests(torch.empty(0, dtype=torch.int64, device=dev),
                        [0] * n_dev, where, 0)
    lib = cuda.library()
    stream = cuda.stream(lefts)
    tiles = -(-(Rb * G) // _TILE)
    tile_counts = torch.empty((tiles, n_dev), dtype=torch.int32, device=dev)
    cuda.check(lib.lm_tiled_count(
        rows.data_ptr(), Rb, G, lefts.data_ptr(), lengths.data_ptr(),
        present.data_ptr(), is_fwd.data_ptr(), gen_off.data_ptr(), side, C,
        seed_len, big, S, n_dev, tile_counts.data_ptr(), stream),
        "lm_tiled_count")
    tc = tile_counts.to(torch.int64)
    tile_base = torch.cumsum(tc, 0) - tc
    totals = tc.sum(0)
    sent = totals.clamp(max=req_cap)
    send_off = torch.cumsum(sent, 0) - sent
    counts = sent.tolist()
    send = torch.empty(sum(counts), dtype=torch.int64, device=dev)
    cuda.check(lib.lm_tiled_requests(
        rows.data_ptr(), Rb, G, lefts.data_ptr(), lengths.data_ptr(),
        present.data_ptr(), is_fwd.data_ptr(), gen_off.data_ptr(), side, C,
        seed_len, big, S, n_dev, tile_base.data_ptr(), send_off.data_ptr(),
        req_cap, send.data_ptr(), where.data_ptr(), stream),
        "lm_tiled_requests")
    tiled_requests.launches += 1
    return Requests(send, counts, where, int((totals - sent).sum()))


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


def _spans(resp, where, C: int, fill: int):
    """int64[Rb, G, C] span of each request, the sentinel row where none
    was answered."""
    if resp.shape[0] == 0:
        return torch.full((*where.shape, C), fill, dtype=torch.int64,
                          device=where.device)
    got = resp[where.clamp(min=0)]
    return torch.where((where >= 0)[..., None], got, torch.full_like(got,
                                                                     fill))


def tiled_probe_plain(resp, where, rows, lefts, lengths, present, is_fwd,
                      gen_cnt, active, side: int, C: int, seed_len: int,
                      fill: int) -> None:
    """Plain PyTorch version of K31: ops.extend.probe_advance on the
    spans."""
    Rb, G = where.shape
    f = is_fwd[rows]
    back = f if side == 0 else ~f
    spans = _spans(resp, where, C, fill)
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
                active, side: int, C: int, seed_len: int, fill: int) -> None:
    """One probe round of a block of active rows on their fetched spans.

    resp: int64[n, C] the answered spans in send order; where: int64[Rb,
    G] each request's row of resp (-1: none, read as sentinel keys); rows:
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
                                 fill)
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
    lib = cuda.library()
    if G > WARP_GENOMES and \
            lib.lm_tiled_probe_row_bytes(G) > lib.lm_tiled_probe_smem_limit():
        raise ValueError(f"K31: {G} genomes a row exceed the shared memory "
                         "a block may take")
    cuda.check(lib.lm_tiled_probe(
        resp.data_ptr(), where.data_ptr(), rows.data_ptr(), Rb, G,
        lefts.data_ptr(), lengths.data_ptr(), present.data_ptr(),
        is_fwd.data_ptr(), gen_cnt.data_ptr(), active.data_ptr(), side, C,
        seed_len, fill, cuda.stream(lefts)), "lm_tiled_probe")
    tiled_probe.launches += 1


tiled_probe.launches = 0
