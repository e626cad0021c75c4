"""hymet_tpu_torch.io.native_io: the port's native host helpers, built from
its own ``csrc/host/hymetio.cpp`` into ``build/`` (never into
``native/``), against the JAX package's numpy functions on
tests/test_native.py's seeds and edge cases; the CPU index build and the
CPU DB build give the same arrays with the library and without it (the
numpy fallback, logged once)."""

import gzip
import logging
import os

import numpy as np
import pytest

from hymet_tpu.io.fasta import encode_seq as jax_encode_seq
from hymet_tpu.io.fasta import read_fasta_codes as jax_read_fasta_codes
from hymet_tpu.io.minimizer_index import MinimizerIndex as JIndex
from hymet_tpu.io.sketchdb import bottom_sketch_from_hashes as jax_bottom_sketch_from_hashes
from hymet_tpu.io.sketchdb import build_sketch_db as jax_build_sketch_db
from hymet_tpu.ops.hashing import kmer_hashes_numpy
from hymet_tpu.ops.minimizer import extract_minimizers_numpy
from hymet_tpu_torch.io import fasta, native_io
from hymet_tpu_torch.io.minimizer_index import MinimizerIndex
from hymet_tpu_torch.io.sketchdb import bottom_sketch_from_hashes, build_sketch_db
from hymet_tpu_torch.ops.hashing import kmer_hashes_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _native_tree() -> dict:
    root = os.path.join(REPO, "native")
    return {name: os.stat(os.path.join(root, name)).st_mtime_ns for name in os.listdir(root)}


@pytest.fixture
def without_library(monkeypatch):
    """The helpers as where the library did not build: the numpy paths."""
    monkeypatch.setattr(native_io, "_LIB", None)
    monkeypatch.setattr(native_io, "_TRIED", True)
    assert not native_io.available()


def test_library_builds_from_the_ports_own_source():
    before = _native_tree()
    assert native_io.build()
    assert native_io.available()
    so = native_io.library_path()
    assert so.exists() and so.parent.parent.parent == native_io._PKG.parent / "build" / "hymet_tpu_torch"
    assert native_io.SOURCE == native_io._PKG / "csrc" / "host" / "hymetio.cpp"
    assert _native_tree() == before  # nothing written under native/


def test_encode_matches_jax():
    seq = b"ACGTNacgtnXYZ#" * 500
    got = native_io.encode_seq(seq)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_encode_seq(seq))
    np.testing.assert_array_equal(got, fasta.encode_seq(seq))


@pytest.mark.parametrize("k", [1, 15, 21, 31, 32])
def test_kmer_hashes_match_jax_numpy(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=50000).astype(np.uint8)
    codes[rng.integers(0, 50000, 50)] = 4
    got = native_io.kmer_hashes(codes, k)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, kmer_hashes_numpy(codes, k))
    np.testing.assert_array_equal(kmer_hashes_host(codes, k), got)


@pytest.mark.parametrize("k,w", [(19, 19), (15, 10), (21, 11)])
def test_minimizers_match_jax_numpy(k, w):
    rng = np.random.default_rng(k * w)
    codes = rng.integers(0, 4, size=30000).astype(np.uint8)
    codes[rng.integers(0, 30000, 30)] = 4
    for got, want in zip(native_io.minimizers(codes, k, w), extract_minimizers_numpy(codes, k, w)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_edge_cases():
    assert native_io.kmer_hashes(np.zeros(5, dtype=np.uint8), 21).size == 0
    assert native_io.minimizers(np.zeros(10, dtype=np.uint8), 19, 19)[0].size == 0
    codes = np.full(1000, 4, dtype=np.uint8)  # all invalid
    assert native_io.kmer_hashes(codes, 21).size == 0
    assert native_io.minimizers(codes, 19, 19)[0].size == 0
    assert native_io.encode_seq(b"").size == 0


def test_read_fasta_codes_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    seqs = [_ACGT[rng.integers(0, 4, n)].tobytes() for n in (700, 1, 2500)]
    seqs[0] = seqs[0][:100] + b"NNnn" + seqs[0][100:].lower()
    text = "".join(f">s{i} desc\n{s.decode()}\n" for i, s in enumerate(seqs)) + ">empty\n"
    for path in (tmp_path / "a.fna", tmp_path / "a.fna.gz"):
        if path.suffix == ".gz":
            with gzip.open(path, "wt") as f:
                f.write(text)
        else:
            path.write_text(text)
        names, codes = fasta.read_fasta_codes(str(path))
        jnames, jcodes = jax_read_fasta_codes(str(path))
        assert names == jnames == ["s0", "s1", "s2", "empty"]
        assert len(codes) == len(jcodes)
        for got, want in zip(codes, jcodes):
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)


def test_read_fasta_codes_without_library(tmp_path, without_library):
    path = tmp_path / "b.fna"
    path.write_text(">x\nACGTNacgt\n>y\nGG\n")
    names, codes = fasta.read_fasta_codes(str(path))
    assert names == ["x", "y"]
    np.testing.assert_array_equal(codes[0], jax_encode_seq(b"ACGTNacgt"))


def _genomes(rng):
    seqs = [_ACGT[rng.integers(0, 4, n)].tobytes() for n in (9000, 4000, 15000, 30)]
    seqs[1] = seqs[1][:2000] + b"N" * 30 + seqs[1][2000:]
    seqs.append(seqs[2][5000:8000])  # shared with another genome
    return [(f"g{i}", s) for i, s in enumerate(seqs)]


@pytest.mark.parametrize("k,w", [(19, 19), (15, 10), (32, 5)])
def test_cpu_index_build_same_with_and_without_library(k, w, monkeypatch):
    """k = 32 is past the library's 31: the numpy twin either way."""
    genomes = _genomes(np.random.default_rng(k))
    native = MinimizerIndex.build(genomes, k=k, w=w, device="cpu")
    want = JIndex.build(genomes, k=k, w=w)
    monkeypatch.setattr(native_io, "_LIB", None)
    monkeypatch.setattr(native_io, "_TRIED", True)
    plain = MinimizerIndex.build(genomes, k=k, w=w, device="cpu")
    assert native.n_minimizers > 0
    for f in ("hashes", "seq_id", "pos", "strand", "lengths"):
        for got in (native, plain):
            assert getattr(got, f).dtype == getattr(want, f).dtype
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("distinct", [1, 40, 999, 1000, 1001, 2**63])
def test_host_bottom_sketch_matches_jax(distinct):
    """The host route's bottom-s (a partition of the smallest hashes,
    doubled until they hold s distinct values) against the JAX package's
    np.unique of the whole row: rows with few distinct values, about s,
    and all distinct; s from 1 to above the row's length."""
    rng = np.random.default_rng(distinct % 1000)
    for n in (0, 1, 999, 5000):
        hashes = rng.integers(0, distinct, n, dtype=np.uint64)
        for s in (1, 7, 1000, 6000):
            got, n_got = bottom_sketch_from_hashes(hashes, s)
            want, n_want = jax_bottom_sketch_from_hashes(hashes, s)
            assert n_got == n_want and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,s", [(21, 64), (15, 1000), (32, 50)])
def test_cpu_db_build_same_with_and_without_library(tmp_path, k, s, monkeypatch):
    rng = np.random.default_rng(s)
    files = []
    for i, (name, seq) in enumerate(_genomes(rng)):
        path = tmp_path / f"{name}.fna"
        path.write_text(f">{name}a\n{seq[: len(seq) // 2].decode()}\n>{name}b\n"
                        f"{seq[len(seq) // 2 :].decode()}\n")
        files.append(str(path))
    native = build_sketch_db(files, k=k, sketch_size=s, device="cpu")
    want = jax_build_sketch_db(files, k=k, sketch_size=s)
    monkeypatch.setattr(native_io, "_LIB", None)
    monkeypatch.setattr(native_io, "_TRIED", True)
    plain = build_sketch_db(files, k=k, sketch_size=s, device="cpu")
    for got in (native, plain):
        assert got.names == want.names
        for f in ("hashes", "n_hashes", "lengths"):
            assert getattr(got, f).dtype == getattr(want, f).dtype
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_fallback_is_logged_once(tmp_path, monkeypatch, caplog):
    """No library and HYMET_BUILD_NATIVE=0: nothing is built, available()
    says so, the fallback is logged once, and the host hashing is numpy's."""
    missing = tmp_path / "none" / "libhymetio.so"
    monkeypatch.setattr(native_io, "library_path", lambda: missing)
    monkeypatch.setattr(native_io, "_LIB", None)
    monkeypatch.setattr(native_io, "_TRIED", False)
    monkeypatch.setenv("HYMET_BUILD_NATIVE", "0")
    with caplog.at_level(logging.WARNING, logger="hymet_tpu_torch.native_io"):
        assert not native_io.available()
        assert not native_io.available()
        codes = np.random.default_rng(1).integers(0, 4, 3000).astype(np.uint8)
        np.testing.assert_array_equal(kmer_hashes_host(codes, 21), kmer_hashes_numpy(codes, 21))
    assert not missing.parent.exists()
    assert [r.getMessage().split(" (")[0] for r in caplog.records] == [
        "native host helpers unavailable"]
