"""K16's two launches on sorted seed tables built to reach their edges:
one row, one tile and one tile plus a row, runs that start or end exactly
at a tile boundary, runs spanning more than 32 tiles (so a tile's walk
over the summaries takes several steps each way), a sentinel run and a
content run of 10^6 rows, a table that is one run, the tail of 1s past
the windows, and u32 and u64 sentinels.  Here on the CPU the plain
versions of the two launches compose to seed_run_counts_plain (exact);
tests/test_torch_cuda.py loads this file by path and holds the kernels
to the plain versions on the same tables.  Imports neither JAX nor
libmems_tpu, so the card's machine can load it."""

import numpy as np
import pytest
import torch

from libmems_tpu_torch.ops import seedocc

T = seedocc.SEED_TILE
TAIL = 22   # a weight-15 seed's length - 1: the positions past the windows

# case: (segments, key bits, tail); a segment is ("short", rows) runs of
# 1-5 rows, ("run", rows) one content run, ("twin", 1) the key whose
# content is the sentinel's, ("sentinel", rows) masked windows
TABLES = {
    "n1": ([("run", 1)], 64, 3),
    "one_tile": ([("short", T)], 64, 0),
    "tile_plus_one": ([("short", T + 1)], 32, TAIL),
    "start_at_tile": ([("short", 3 * T), ("run", 50_000),
                       ("short", 20_000)], 64, TAIL),
    "end_at_tile": ([("short", 1_000), ("run", 5 * T - 1_000),
                     ("short", 10_000)], 64, 0),
    "multi_tile_run": ([("short", 3_000), ("run", 200_000),
                        ("short", 100_000)], 64, TAIL),
    "sentinel_run": ([("short", 150_000), ("sentinel", 1_000_000)], 64,
                     TAIL),
    "content_run": ([("short", 100_000), ("run", 1_000_000),
                     ("short", 100_000)], 64, 0),
    "one_run": ([("run", 150_000)], 64, TAIL),
    "u32_sentinel": ([("short", 30_000), ("twin", 1), ("sentinel", 5_000)],
                     32, TAIL),
    "many_rows": ([("short", 10_000_019)], 64, TAIL),
}
CPU_TABLES = [c for c in TABLES if c != "many_rows"]


def sorted_table(case: str, n: int | None = None, rng_seed: int = 0):
    """(sorted_keys int64[n], sorted_positions int32[n], length, sentinel)
    of table `case`: keys in unsigned order (bit 63 set on the upper half
    of a u64 table's contents), positions a random permutation.  With n,
    the last "short" segment grows or shrinks so the table has n rows."""
    segs, key_bits, tail = TABLES[case]
    if n is not None:
        k = max(i for i, (kind, _) in enumerate(segs) if kind == "short")
        segs = list(segs)
        segs[k] = ("short", n - sum(r for i, (_, r) in enumerate(segs)
                                    if i != k))
    rng = np.random.default_rng(rng_seed)
    lengths = []
    for kind, rows in segs:
        if kind == "short":
            runs = rng.integers(1, 6, size=rows)
            runs = runs[:int(np.searchsorted(np.cumsum(runs), rows)) + 1]
            runs[-1] -= runs.sum() - rows
            lengths.append(runs)
        elif kind == "run":
            lengths.append(np.array([rows]))
    lengths = np.concatenate(lengths)
    gap = 1 << (20 if key_bits == 64 else 6)
    content = np.cumsum(rng.integers(1, gap, size=len(lengths)),
                        dtype=np.uint64)
    if key_bits == 64:
        content[len(content) // 2:] += np.uint64(1 << 62)
    keys = np.sort((np.repeat(content, lengths) << np.uint64(1))
                   | rng.integers(0, 2, size=int(lengths.sum()),
                                  dtype=np.uint64))
    sentinel = np.uint64((1 << key_bits) - 1)
    for kind, rows in segs:
        if kind == "twin":
            keys = np.concatenate([keys, [sentinel - np.uint64(1)]])
        elif kind == "sentinel":
            keys = np.concatenate([keys, np.full(rows, sentinel)])
    n_rows = len(keys)
    pos = rng.permutation(n_rows).astype(np.int32)
    return (torch.from_numpy(keys.view(np.int64).copy()),
            torch.from_numpy(pos), n_rows + tail,
            int(sentinel) if key_bits == 32 else -1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _edges_np(keys: np.ndarray) -> np.ndarray:
    """Each tile's first and last run start by a loop over the tiles."""
    content = keys.view(np.uint64) >> np.uint64(1)
    start = np.ones(len(keys), bool)
    start[1:] = content[1:] != content[:-1]
    tiles = -(-len(keys) // T)
    first, last = np.full(tiles, -1), np.full(tiles, -1)
    for t in range(tiles):
        s = np.flatnonzero(start[t * T:(t + 1) * T])
        if len(s):
            first[t], last[t] = t * T + s[0], t * T + s[-1]
    return np.concatenate([first, last])


@pytest.mark.parametrize("case", CPU_TABLES)
def test_tile_edges_and_counts_compose_to_plain(case):
    """The plain edges equal each tile's first and last run start, and the
    plain count pass on them equals seed_run_counts_plain, bit for bit."""
    keys, pos, length, sentinel = sorted_table(case)
    edges = seedocc.seed_tile_edges_plain(keys)
    assert edges.dtype == torch.int32
    np.testing.assert_array_equal(edges.numpy(), _edges_np(keys.numpy()))
    got = seedocc.seed_run_counts_from_edges_plain(keys, pos, edges, length,
                                                   sentinel)
    ref = seedocc.seed_run_counts_plain(keys, pos, length, sentinel)
    assert torch.equal(got, ref)
    assert (ref[keys.shape[0]:] == 1).all()
    if case in ("multi_tile_run", "content_run", "one_run"):
        assert int(ref.max()) >= 150_000
    if case == "sentinel_run":
        assert int(ref.max()) <= 5


def test_empty_table_composes_to_ones():
    """No window: no tile, every position 1."""
    keys = torch.zeros(0, dtype=torch.int64)
    pos = torch.zeros(0, dtype=torch.int32)
    edges = seedocc.seed_tile_edges_plain(keys)
    assert edges.numel() == 0
    got = seedocc.seed_run_counts_from_edges_plain(keys, pos, edges, 7, -1)
    assert torch.equal(got, seedocc.seed_run_counts_plain(keys, pos, 7, -1))
    assert torch.equal(got, torch.ones(7, dtype=torch.int32))
