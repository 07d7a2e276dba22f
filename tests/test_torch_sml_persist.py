"""Port parity: SML persistence (save / load / load_or_create), the
out-of-core builds (the native dmSML bridge and the Python
split-sort-merge) and create_with_fallback, against the JAX package:
the SMLT0001 file bytes are the yardstick, in both directions."""

import os

import numpy as np
import pytest
import torch

from libmems_tpu import seeds as jseeds
from libmems_tpu.ops.mers import canonical_seed_keys_np as jax_keys_np
from libmems_tpu.sequence import Genome as JaxGenome
from libmems_tpu.sml import SortedMerList as JaxSML
from libmems_tpu_torch import native, seeds
from libmems_tpu_torch.ops.mers import canonical_seed_keys
from libmems_tpu_torch.sequence import Genome
from libmems_tpu_torch.sml import SortedMerList


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def _native():
    """Skip, when the test runs, where the port's own native library
    (libmems_tpu_torch.native, built under a temporary name and renamed
    into place) cannot be built."""
    if not native.available():
        pytest.skip("native toolchain unavailable")


needs_native = pytest.mark.usefixtures("_native")


def _codes(seed, n):
    return np.random.default_rng(seed).integers(0, 4, size=n).astype(
        np.uint8)


def _ascii(seed, n, n_run=None):
    a = np.random.default_rng(seed).choice(list(b"ACGT"), size=n).astype(
        np.uint8)
    if n_run is not None:
        a[n_run[0]:n_run[1]] = ord("N")
    return a


def _same(sml, ref):
    """A port SML equals a JAX-package SML: length, window count and all
    three tables (the port's int64 keys widen the JAX key width's)."""
    assert (sml.length, sml.n_windows, sml.seed, sml.circular) == \
        (ref.length, ref.n_windows, ref.seed, ref.circular)
    for got, want in ((sml.keys, ref.keys), (sml.sorted_keys,
                                             ref.sorted_keys)):
        want = np.asarray(want)
        got = got.cpu().numpy()
        if want.dtype == np.uint64:
            got = got.view(np.uint64)
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    np.testing.assert_array_equal(sml.sorted_positions.cpu().numpy(),
                                  np.asarray(ref.sorted_positions))


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@needs_native
@pytest.mark.parametrize("weight", [5, 9, 15, 21])
def test_native_keys_bit_parity(weight):
    seed = seeds.get_seed(weight, 0)
    codes = _codes(weight, 5000)
    got = native.native_keys(codes, seed)
    np.testing.assert_array_equal(
        got, jax_keys_np(codes, seed).astype(np.uint64))
    k1 = canonical_seed_keys(torch.from_numpy(codes), seed).numpy()
    np.testing.assert_array_equal(got, k1.view(np.uint64))


@needs_native
def test_native_keys_solid_seed():
    seed = seeds.solid_seed(11)
    assert seed == jseeds.solid_seed(11)
    codes = _codes(1, 2000)
    np.testing.assert_array_equal(
        native.native_keys(codes, seed),
        jax_keys_np(codes, seed).astype(np.uint64))


@needs_native
def test_create_file_sml_matches_memory(tmp_path):
    """Many bins (a 1 MiB mem_limit): the native file loads to the
    in-memory SML, and its bytes are save()'s and the JAX package's
    SortedMerList.save's."""
    seed = seeds.get_seed(9, 0)
    codes = _codes(2, 200_000)
    out = tmp_path / "g.sml"
    native.create_file_sml(codes, seed, str(out), scratch_dir=str(tmp_path),
                           mem_limit=1 << 20)
    disk = SortedMerList.load(str(out), device="cpu")
    mem = SortedMerList.create(codes, seed, device="cpu")
    for name in ("keys", "sorted_keys", "sorted_positions"):
        assert torch.equal(getattr(disk, name), getattr(mem, name)), name
    mem.save(tmp_path / "mem.sml")
    ref = JaxSML.create(codes, seed)
    ref.save(str(tmp_path / "j.sml"))
    assert _bytes(out) == _bytes(tmp_path / "mem.sml") == \
        _bytes(tmp_path / "j.sml")
    _same(disk, ref)


@needs_native
def test_create_file_sml_circular(tmp_path):
    seed = seeds.get_seed(5, 0)
    codes = _codes(3, 500)
    out = tmp_path / "c.sml"
    native.create_file_sml(codes, seed, str(out), scratch_dir=str(tmp_path),
                           circular=True)
    disk = SortedMerList.load(str(out), device="cpu")
    mem = SortedMerList.create(codes, seed, circular=True, device="cpu")
    assert disk.n_windows == mem.n_windows
    assert torch.equal(disk.keys, mem.keys)
    _same(disk, JaxSML.create(codes, seed, circular=True))


@needs_native
def test_create_big_entrypoint(tmp_path):
    seed = seeds.get_seed(7, 0)
    codes = _codes(4, 10_000)
    path = tmp_path / "big.sml"
    sml = SortedMerList.create_big(codes, seed, str(path),
                                   scratch_dir=str(tmp_path), device="cpu")
    mem = SortedMerList.create(codes, seed, device="cpu")
    assert torch.equal(sml.sorted_positions, mem.sorted_positions)
    mem.save(tmp_path / "mem.sml")
    assert _bytes(path) == _bytes(tmp_path / "mem.sml")


def test_big_create_python_fallback(tmp_path, monkeypatch):
    """The Python split-sort-merge, many chunks: its file is the JAX
    package's byte for byte, and create_big takes it when the native
    library is unavailable."""
    codes = _codes(5, 30_000)
    seed = seeds.get_seed(9, 0)
    path = tmp_path / "big.sml"
    sml = SortedMerList._big_create_py(codes, seed, str(path),
                                       mem_limit=48 * 4096, device="cpu")
    ref = JaxSML._big_create_py(codes, seed, str(tmp_path / "j.sml"),
                                mem_limit=48 * 4096)
    _same(sml, ref)
    assert _bytes(path) == _bytes(tmp_path / "j.sml")
    again = SortedMerList.load(str(path), mmap=False, device="cpu")
    assert torch.equal(again.sorted_positions, sml.sorted_positions)
    monkeypatch.setattr(native, "available", lambda: False)
    other = tmp_path / "py.sml"
    SortedMerList.create_big(codes, seed, str(other), mem_limit=48 * 4096,
                             device="cpu")
    assert _bytes(other) == _bytes(path)


@needs_native
def test_native_sorter_masks_windows(tmp_path):
    a = _ascii(9, 4000, (2000, 2040))
    g = Genome("g", a)
    seed = seeds.get_seed(11, 0)
    path = tmp_path / "g.sml"
    native.create_file_sml(g, seed, str(path))
    sml = SortedMerList.load(path, device="cpu")
    ref = SortedMerList.create(g, seed, device="cpu")
    assert torch.equal(sml.keys, ref.keys)
    assert torch.equal(sml.sorted_positions, ref.sorted_positions)
    _same(sml, JaxSML.create(JaxGenome("g", a), seed))
    masked = np.where(g.ambig, np.uint8(0xFF), g.codes)
    np.testing.assert_array_equal(
        native.native_keys(masked, seed).astype(np.uint32),
        ref.keys.numpy().astype(np.uint32))


def test_big_create_py_masks_windows(tmp_path):
    a = _ascii(11, 6000, (3000, 3025))
    seed = seeds.get_seed(11, 0)
    sml = SortedMerList._big_create_py(Genome("g", a), seed,
                                       str(tmp_path / "g.sml"),
                                       mem_limit=1 << 16, device="cpu")
    ref = SortedMerList.create(Genome("g", a), seed, device="cpu")
    assert torch.equal(sml.keys, ref.keys)
    assert torch.equal(sml.sorted_positions, ref.sorted_positions)
    JaxSML._big_create_py(JaxGenome("g", a), seed, str(tmp_path / "j.sml"),
                          mem_limit=1 << 16)
    assert _bytes(tmp_path / "g.sml") == _bytes(tmp_path / "j.sml")


def test_create_with_fallback_on_oom(tmp_path, monkeypatch):
    """Allocator exhaustion (torch.OutOfMemoryError, MemoryError) falls
    back to the out-of-core build; any other failure raises."""
    g = Genome("g", _ascii(17, 5000))
    seed = seeds.get_seed(11, 0)
    ref = SortedMerList.create(g, seed, device="cpu")
    real_create = SortedMerList.create

    for exc in (torch.OutOfMemoryError("CUDA out of memory"),
                MemoryError()):
        def oom_create(*a, _exc=exc, **k):
            raise _exc
        monkeypatch.setattr(SortedMerList, "create",
                            staticmethod(oom_create))
        sml = SortedMerList.create_with_fallback(
            g, seed, sml_path=str(tmp_path / "g.sml"), device="cpu")
        assert torch.equal(sml.keys, ref.keys)
        assert torch.equal(sml.sorted_positions, ref.sorted_positions)

    def broken(*a, **k):
        raise RuntimeError("lm_seed_keys: CUDA error 209: no kernel image")
    monkeypatch.setattr(SortedMerList, "create", staticmethod(broken))
    with pytest.raises(RuntimeError, match="no kernel image"):
        SortedMerList.create_with_fallback(g, seed, device="cpu")
    monkeypatch.setattr(SortedMerList, "create", staticmethod(real_create))
    path = tmp_path / "mem.sml"
    sml = SortedMerList.create_with_fallback(g, seed, sml_path=str(path),
                                             device="cpu")
    assert torch.equal(sml.keys, ref.keys) and path.exists()


@pytest.mark.parametrize("weight", [9, 17])
@pytest.mark.parametrize("circular", [False, True])
def test_saved_files_byte_equal_across_packages(tmp_path, weight, circular):
    """u32 (weight 9) and u64 (weight 17) keys, an N run: either
    package's file is the other's byte for byte and loads in both."""
    a = _ascii(weight, 7000, (3100, 3160))
    seed = seeds.get_seed(weight, 0)
    sml = SortedMerList.create(Genome("g", a), seed, circular=circular,
                               device="cpu")
    ref = JaxSML.create(JaxGenome("g", a), seed, circular=circular)
    sml.save(tmp_path / "t.sml")
    ref.save(str(tmp_path / "j.sml"))
    assert _bytes(tmp_path / "t.sml") == _bytes(tmp_path / "j.sml")
    for mmap in (True, False):
        _same(SortedMerList.load(tmp_path / "j.sml", mmap=mmap,
                                 device="cpu"), ref)
        _same(sml, JaxSML.load(str(tmp_path / "t.sml"), mmap=mmap))


def test_load_or_create_reuses_and_recreates(tmp_path, monkeypatch):
    g = Genome("g", _ascii(23, 6000))
    s9, s11 = seeds.get_seed(9, 0), seeds.get_seed(11, 0)
    path = str(tmp_path / "g.sml")
    first = SortedMerList.load_or_create(g, s9, path, device="cpu")
    stamp = os.stat(path).st_mtime_ns
    real_create = SortedMerList.create

    def no_create(*a, **k):
        raise AssertionError("a matching file must be reused")
    monkeypatch.setattr(SortedMerList, "create", staticmethod(no_create))
    again = SortedMerList.load_or_create(g, s9, path, device="cpu")
    assert torch.equal(again.sorted_positions, first.sorted_positions)
    assert os.stat(path).st_mtime_ns == stamp
    monkeypatch.setattr(SortedMerList, "create", staticmethod(real_create))
    other = SortedMerList.load_or_create(g, s11, path, device="cpu")
    assert other.seed == s11
    ref = JaxSML.load_or_create(JaxGenome("g", g.ascii), s11,
                                str(tmp_path / "j.sml"))
    _same(other, ref)
    assert _bytes(path) == _bytes(tmp_path / "j.sml")
