"""Batched ungapped maximal extension of match candidates (kernel K2,
csrc/extend.cu).

Port of libmems_tpu/ops/extend.py (MatchFinder::ExtendMatch,
libMems/MatchFinder.h:218-374).  Net semantics: repeatedly jump to the
FURTHEST window offset within `seed_len` steps at which every member
genome's canonical spaced-seed key is equal with consistent strand
parity; stop when no window in the next `seed_len` offsets matches or a
sequence boundary cuts the probe range.  Each side runs probe rounds:
one at `chunk`, then rounds at ESCALATE*`chunk` while the row stays
active.  Parity: with key = (content << 1 | strand), windows match iff
``key ^ is_fwd`` is equal across member genomes.

Rows address genomes through per-row (offset, window-count) tables, so a
row may be a dense G-genome match or a compact pair, of any width G.  A
side ends at its maximal chain whatever the round widths (csrc/extend.cu
says why), so K2 picks its own: up to WARP_GENOMES genomes a row runs on
one warp with its state in registers; wider rows keep it (5 * G ints) in
shared memory while the card lets a block opt into that much
(lm_extend_smem_limit), and in a global scratch tensor above it or when
the caller asks for it.  A caller whose rows after the first n_live are
absent passes n_live, and only those rows are launched.
"""

from __future__ import annotations

import torch

from libmems_tpu_torch import cuda

ESCALATE = 8       # long-match probe window = ESCALATE * chunk
WARP_GENOMES = 32  # genomes a row on K2's warp route (lm_extend_warp_genomes)


def _probe_round(keys, fill, seed_len, C, side, gen_off, gen_cnt, lefts,
                 present, is_fwd, lengths, active):
    """One probe round over rows (all tensors already cut to the rows
    that are active); ops/extend.py:227-294."""
    R, G = lefts.shape
    n_keys = keys.shape[0]
    dd = torch.arange(1, C + 1, dtype=torch.int32, device=keys.device)[None]
    back = is_fwd if side == 0 else ~is_fwd
    keys_g = []
    for g in range(G):
        l = lefts[:, g:g + 1]
        q = torch.where(back[:, g:g + 1], l - dd,
                        l + lengths[:, None] - seed_len + dd)
        idx = gen_off[:, g:g + 1].to(torch.int64) + q
        inb = (idx >= 0) & (idx < n_keys)
        keys_g.append(torch.where(inb, keys[idx.clamp(0, max(n_keys - 1, 0))],
                                  torch.full_like(idx, fill)))
    return probe_advance(keys_g, fill, seed_len, C, side, gen_cnt, lefts,
                         present, is_fwd, lengths, active)


def probe_advance(keys_g, fill, seed_len, C, side, gen_cnt, lefts, present,
                  is_fwd, lengths, active):
    """The probe round after its fetch (ops/extend.py:241-294): keys_g[g]
    int64[R, C] holds genome g's key at probe offset d = 1..C (column
    d - 1) of each row.  Matches (probe positions inside the genome, no
    sentinel, keys XOR strand equal to the reference genome's), the
    furthest reach with gaps <= seed_len, and the advance.  Returns
    (lefts, lengths, active)."""
    R, G = lefts.shape
    dev = lefts.device
    dd = torch.arange(1, C + 1, dtype=torch.int32, device=dev)[None]
    back = is_fwd if side == 0 else ~is_fwd
    ref_idx = torch.argmax(present.to(torch.int8), dim=1)
    flipped, valid_g = [], []
    for g in range(G):
        l = lefts[:, g:g + 1]
        q = torch.where(back[:, g:g + 1], l - dd,
                        l + lengths[:, None] - seed_len + dd)
        valid_g.append((q >= 0) & (q < gen_cnt[:, g:g + 1]))
        flipped.append(keys_g[g] ^ is_fwd[:, g:g + 1].to(torch.int64))
    stacked = torch.stack(flipped)                       # [G, R, C]
    ref_keys = stacked[ref_idx, torch.arange(R, device=dev)]
    match = active[:, None].expand(R, C).clone()
    for g in range(G):
        ok = valid_g[g] & (flipped[g] == ref_keys) & ((flipped[g] | 1) != fill)
        match &= torch.where(present[:, g:g + 1], ok, True)

    # furthest offset reachable with gaps <= seed_len between matches
    dm = torch.where(match, dd, 0)
    pm_incl = torch.cummax(dm, dim=1).values
    pm_excl = torch.cat([torch.zeros_like(pm_incl[:, :1]),
                         pm_incl[:, :-1]], dim=1)
    bad = match & (dd - pm_excl > seed_len)
    first_bad = torch.where(bad, dd, C + 1).min(dim=1).values
    reach = torch.where(match & (dd < first_bad[:, None]), dd, 0
                        ).max(dim=1).values

    # advance: the side's moving genomes shift left by `reach`
    lefts = torch.where(back & present & active[:, None],
                        lefts - reach[:, None], lefts)
    lengths = torch.where(active, lengths + reach, lengths)
    back_room = lefts
    ahead_room = (gen_cnt - 1) - (lefts + lengths[:, None] - seed_len)
    room = torch.where(back, back_room, ahead_room)
    room = torch.where(present, room, 1 << 30).min(dim=1).values
    active = active & (reach + seed_len > C) & (room + reach > C)
    return lefts, lengths, active


def _live_count(R: int, n_live: int | None) -> int:
    """The leading rows to extend: n_live, all R where it is None."""
    n = R if n_live is None else n_live
    if not 0 <= n <= R:
        raise ValueError(f"n_live = {n_live} outside [0, {R}]")
    return n


def extend_matches_plain(keys_concat, seed_len: int, chunk: int, gen_off,
                         gen_cnt, lefts, present, is_fwd, lengths,
                         fill: int, n_live: int | None = None):
    """Plain PyTorch version of K2: the probe rounds of the JAX module,
    run on the still-active rows only (a finished row no longer changes,
    so the result equals the global while_loop); the rows from n_live on
    are left as they are."""
    if chunk < seed_len:
        raise ValueError("chunk must be >= seed_len")
    big = ESCALATE * chunk
    lefts = lefts.clone()
    lengths = lengths.clone()
    live = torch.arange(lefts.shape[0], device=lefts.device) \
        < _live_count(lefts.shape[0], n_live)
    for side in (0, 1):
        active = present.any(dim=1) & live
        C = chunk
        while True:
            rows = torch.nonzero(active).flatten()
            if rows.numel() == 0:
                break
            l2, n2, a2 = _probe_round(
                keys_concat, fill, seed_len, C, side, gen_off[rows],
                gen_cnt[rows], lefts[rows], present[rows], is_fwd[rows],
                lengths[rows], active[rows])
            lefts[rows] = l2
            lengths[rows] = n2
            active[rows] = a2
            C = big
    return lefts, lengths


@cuda.launcher
def extend_matches(keys_concat, seed_len: int, chunk: int, gen_off,
                   gen_cnt, lefts, present, is_fwd, lengths, fill: int,
                   scratch: bool = False, n_live: int | None = None):
    """Extend candidates to maximal matches. Returns (lefts, lengths).

    keys_concat: int64[Ntot] keys of all genomes; gen_off, gen_cnt,
    lefts: int32[R, G] (genome offset, window count, 0-based left end);
    present, is_fwd: bool[R, G]; lengths: int32[R]; fill: the sentinel
    key; n_live: the leading rows to extend (default all R), the rows
    after them returned as they are.  CPU tensors take the plain
    version; CUDA tensors launch K2 over the n_live rows (none where
    n_live is 0): the warp route up to WARP_GENOMES genomes a row, the
    wide route above, its row state in global scratch when it exceeds
    the shared memory a block may take or when `scratch` asks for it."""
    if keys_concat.device.type == "cpu":
        return extend_matches_plain(keys_concat, seed_len, chunk, gen_off,
                                    gen_cnt, lefts, present, is_fwd,
                                    lengths, fill, n_live)
    if chunk < seed_len:
        raise ValueError("chunk must be >= seed_len")
    dev = keys_concat.device
    R, G = lefts.shape
    n = _live_count(R, n_live)
    if G < 1:
        raise ValueError("K2 needs at least one genome a row")
    cuda.require(keys_concat, "keys_concat", torch.int64, dev,
                 (keys_concat.shape[0],))
    for name, t in (("gen_off", gen_off), ("gen_cnt", gen_cnt),
                    ("lefts", lefts)):
        cuda.require(t, name, torch.int32, dev, (R, G))
    cuda.require(present, "present", torch.bool, dev, (R, G))
    cuda.require(is_fwd, "is_fwd", torch.bool, dev, (R, G))
    cuda.require(lengths, "lengths", torch.int32, dev, (R,))
    lefts = lefts.clone()
    lengths = lengths.clone()
    if n == 0:
        return lefts, lengths
    lib = cuda.library()
    # held by name until the launch is queued (ground rule of cuda.py)
    rows = None
    if G > WARP_GENOMES and (
            scratch
            or lib.lm_extend_row_bytes(G) > lib.lm_extend_smem_limit()):
        rows = torch.empty((n, 5, G), dtype=torch.int32, device=dev)
    cuda.check(lib.lm_extend(
        keys_concat.data_ptr(), keys_concat.shape[0], fill, seed_len, chunk,
        ESCALATE * chunk, G, n, gen_off.data_ptr(), gen_cnt.data_ptr(),
        lefts.data_ptr(), present.data_ptr(), is_fwd.data_ptr(),
        lengths.data_ptr(), rows.data_ptr() if rows is not None else None,
        cuda.stream(keys_concat)), "lm_extend")
    extend_matches.launches += 1
    return lefts, lengths


extend_matches.launches = 0
