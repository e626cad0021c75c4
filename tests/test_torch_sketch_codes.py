"""``sketch_codes`` (the DB build's codes-in bottom-s sketch) on the CPU:
its plain version against the jitted JAX ``sketch_batch`` on the counted
prefix and the count, and against the host build (``kmer_hashes_host`` +
``bottom_sketch_from_hashes``) row by row at k = 15, 21, 31; the card
wrappers' argument checks, which raise before any launch; the buffers
they size for ``csrc/bottom_sketch.cu``; and a DB built in pieces on the
CPU, written as the JAX build writes it. The kernel itself runs only on
the card (``tests/test_torch_gpu.py``)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hymet_tpu.io import sketchdb as jsdb
from hymet_tpu.ops.hashing import kmer_hashes_host, pack64
from hymet_tpu.ops.sketch import sketch_batch as jax_sketch_batch
from hymet_tpu_torch.io import sketchdb as tsdb
from hymet_tpu_torch.ops import sketch_kernels as sk

torch.set_num_threads(1)


def _code_rows(seed: int, B: int, L: int) -> np.ndarray:
    """[B, L] codes: random rows with an N run, a poly-A row, a row of one
    repeated 30-mer, an all-N row."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[0, L // 3 : L // 3 + 25] = 4
    codes[1 % B] = 0
    codes[2 % B] = np.resize(rng.integers(0, 4, 30).astype(np.uint8), L)
    codes[3 % B] = 4
    return codes


@pytest.mark.parametrize("B,L,k,s", [(4, 300, 21, 7), (5, 5000, 21, 1000), (4, 9000, 21, 64),
                                     (4, 40, 21, 1), (4, 21, 21, 3), (4, 200, 32, 300)])
def test_sketch_codes_torch_matches_jax_on_the_counted_prefix(B, L, k, s):
    """The JAX function (jitted) returns duplicates past n before any
    padding; the two agree on [:n] and n, and the port pads past n. The
    wrapper takes the plain version for a CPU tensor."""
    codes = _code_rows(B * L + k + 1, B, L)
    hi, lo, jn = jax_sketch_batch(jnp.asarray(codes), k=k, s=s)
    want = pack64(np.asarray(hi), np.asarray(lo))
    got, n = sk.sketch_codes_torch(torch.from_numpy(codes), k, s)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    view = got.numpy().view(np.uint64)
    for b in range(B):
        m = int(jn[b])
        np.testing.assert_array_equal(view[b, :m], want[b, :m])
        assert (view[b, m:] == jsdb.PAD_HASH).all()
    again = sk.sketch_codes(torch.from_numpy(codes), k, s)
    assert torch.equal(again[0], got) and torch.equal(again[1], n)
    assert sk.sketch_codes.launches == 0


def _host_rows(rng: np.random.Generator, L: int, k: int) -> list:
    """Rows of codes of their own lengths: random, all N, N runs (one a
    few bases, one every 20 bases), shorter than k, poly-A, a 7-base
    repeat, and a row of k bases."""
    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    runs = rand(L)
    runs[::20] = 4
    few = rand(L)
    few[L // 2 : L // 2 + 3] = 4
    return [rand(L), np.full(L // 2, 4, np.uint8), runs, few, rand(k - 1), np.zeros(L, np.uint8),
            np.resize(rand(7), L), rand(k)]


@pytest.mark.parametrize("k", [15, 21, 31])
@pytest.mark.parametrize("s", [64, 5000])
def test_sketch_codes_torch_matches_the_host_build_row_by_row(k, s):
    """Rows padded with N to one batch: each row's sketch and count are
    the host build's (``bottom_sketch_from_hashes`` of
    ``kmer_hashes_host``) of the row alone."""
    rows = _host_rows(np.random.default_rng(k * s), 3000, k)
    got, n = sk.sketch_codes_torch(torch.from_numpy(tsdb.pad_rows(rows)), k, s)
    view = got.numpy().view(np.uint64)
    for b, row in enumerate(rows):
        want, m = jsdb.bottom_sketch_from_hashes(kmer_hashes_host(row, k), s)
        np.testing.assert_array_equal(view[b], want, err_msg=f"row {b}")
        assert int(n[b]) == m, b
    assert int(n[1]) == int(n[4]) == 0 and int(n[5]) == int(n[7]) == 1


@pytest.fixture
def no_launch(monkeypatch):
    """The wrappers' card path on CPU tensors, with a launch that fails the
    test: what raises must raise before it."""
    monkeypatch.setattr(sk, "_check_device", lambda name, *t: "cuda")

    def launch(name, device, *args):
        raise AssertionError(f"{name} launched")

    monkeypatch.setattr(sk, "_launch", launch)


def test_sketch_codes_refuses_before_any_launch(no_launch):
    codes = torch.zeros((2, 64), dtype=torch.uint8)
    bad = [((codes.int(), 21, 5), "uint8"), ((codes[0], 21, 5), "uint8"),
           ((codes[:, ::2], 21, 5), "contiguous"), ((codes, 0, 5), "k must"),
           ((codes, 33, 5), "k must"), ((codes, 21, 0), "s must"), ((codes, 21, 2**31), "s must"),
           ((torch.zeros((0, 64), dtype=torch.uint8), 21, 5), "B must"),
           ((torch.zeros((65536, 1), dtype=torch.uint8), 1, 5), "B must")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            sk.sketch_codes(*args)
    assert sk.sketch_codes.launches == 0
    with pytest.raises(AssertionError, match="sketch_codes launched"):
        sk.sketch_codes(codes, 21, 5)
    # a row shorter than k has no window: nothing to launch
    out, n = sk.sketch_codes(torch.zeros((3, 10), dtype=torch.uint8), 21, 5)
    assert n.tolist() == [0, 0, 0] and (out == -1).all()


def test_bottom_sketch_refuses_before_any_launch(no_launch):
    h, v = torch.zeros((3, 10), dtype=torch.int64), torch.ones((3, 10), dtype=torch.bool)
    bad = [((h.int(), v, 5), "int64"), ((h, v.int(), 5), "int64"), ((h, v[:, :4], 5), "int64"),
           ((h[:, ::2], v[:, ::2], 5), "contiguous"), ((h, v, 0), "s must"),
           ((h, v, 2**31), "s must"), ((h, v, 5, [1, 1]), "segments"),
           ((h, v, 5, [0, 3]), "segments"),
           ((torch.zeros((0, 4), dtype=torch.int64), torch.zeros((0, 4), dtype=torch.bool), 5),
            "B must")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            sk.bottom_sketch(*args)
    assert sk.bottom_sketch.launches == 0
    with pytest.raises(AssertionError, match="bottom_sketch launched"):
        sk.bottom_sketch(h, v, 5, [2, 1])


@pytest.mark.parametrize("B,n,s,G,seg", [
    (78, 779_944, 1000, 78, 779_944), (3, 69_980, 5000, 3, 69_980), (2, 65_537, 70_000, 2, 65_537),
    (6, 4_596, 300, 3, 13_788), (1, 10, 10_000, 1, 10)])
def test_kernel_buffers_follow_the_kernels_contract(B, n, s, G, seg):
    """ceil(n / CHUNK) chunks a row, chunk lists of min(s, CHUNK) keys,
    segment lists of min(s, a segment's windows), scratch only for lists
    past the shared-memory room, and no bound at the start."""
    cpr, cap0, cap, lists, counts, seg_tau, work = sk._lists(B, n, s, G, seg, torch.device("cpu"))
    assert cpr == -(-n // sk.CHUNK) and cap0 == min(s, sk.CHUNK) and cap == min(s, seg)
    assert lists.numel() == B * cpr * cap0 and counts.numel() == B * cpr
    assert seg_tau.tolist() == [sk.MAX_KEY] * G
    need = max(B * cpr * cap0 if cap0 > sk.SHARED_CAP else 0, G * cap if cap > sk.SHARED_CAP else 0)
    assert work.numel() == max(need, 1)
    with pytest.raises(ValueError, match="grid"):
        sk._lists(1, 65536 * sk.CHUNK, s, 1, 1, torch.device("cpu"))


def _fasta(path, records) -> str:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i : i + 70].decode() + "\n")
    return str(path)


def test_build_in_pieces_writes_the_jax_builds_bytes(tmp_path, monkeypatch):
    """A budget of 2000 windows puts each genome up in pieces (folded by
    ``bottom_sketch``) and in batches of rows (``sketch_codes``); the
    port's ``.msh`` file is the JAX build's byte for byte, and its ``.npz``
    holds the same arrays."""
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def dna(n):
        return acgt[rng.integers(0, 4, n)].tobytes()

    files = [_fasta(tmp_path / "a.fna", [("c1", dna(9000)), ("p1", b"N" * 30 + dna(2500))]),
             _fasta(tmp_path / "b.fna", [("c2", dna(7000))]),
             _fasta(tmp_path / "c.fna", [("c3", dna(1500))]),
             _fasta(tmp_path / "d.fna", [("c4", b"A" * 4000)])]
    monkeypatch.setitem(tsdb.BUILD_WINDOWS, "cpu", 2000)
    timings = {}
    got = tsdb.build_sketch_db(files, 21, 300, device="cpu", timings=timings)
    want = jsdb.build_sketch_db(files, 21, 300)
    assert timings["batches"] >= 8 and "bottom_sketch_s" in timings
    got.to_msh(str(tmp_path / "t.msh"))
    want.to_msh(str(tmp_path / "j.msh"))
    with open(tmp_path / "t.msh", "rb") as t, open(tmp_path / "j.msh", "rb") as j:
        assert t.read() == j.read()
    got.save(str(tmp_path / "t.npz"))
    want.save(str(tmp_path / "j.npz"))
    with np.load(tmp_path / "t.npz", allow_pickle=True) as t, \
            np.load(tmp_path / "j.npz", allow_pickle=True) as j:
        assert sorted(t.files) == sorted(j.files)
        for f in t.files:
            assert t[f].dtype == j[f].dtype, f
            np.testing.assert_array_equal(t[f], j[f], err_msg=f)
    assert os.path.getsize(tmp_path / "t.msh") > 0
