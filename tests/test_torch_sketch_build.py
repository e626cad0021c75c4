"""hymet_tpu_torch's sketch DB build against hymet_tpu's host build on the
CPU: ``build_sketch_db``, ``build_sketch_db_from_sequences`` and
``sketch_genome_file`` with ``device="cpu"`` give the JAX build's arrays
element for element (hashes, n_hashes, lengths, names, comments) on gzip
and plain files, multi-sequence files, all-N, shorter-than-k, poly-A,
repetitive and empty inputs, at s = 1, 7, 1000 and s above the windows,
with the window budget at its default and cut so that rows go up in many
batches and in pieces; ``sketch_batch`` equals the jitted JAX
``sketch_batch`` on ``[:n]`` and n; ``bottom_sketch_torch`` equals the
host ``bottom_sketch_from_hashes``."""

import gzip
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hymet_tpu.io import sketchdb as jsdb
from hymet_tpu.ops.hashing import canonical_kmer_bytes, kmer_hashes_numpy, pack64
from hymet_tpu.ops.sketch import sketch_batch as jax_sketch_batch
from hymet_tpu_torch.io import sketchdb as tsdb
from hymet_tpu_torch.ops.sketch import sketch_batch
from hymet_tpu_torch.ops.sketch_kernels import bottom_sketch, bottom_sketch_torch

torch.set_num_threads(1)

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _dna(rng, n: int) -> bytes:
    return _ACGT[rng.integers(0, 4, n)].tobytes()


def _write(path, records, gz=False, width=60) -> str:
    text = "".join(f">{name} desc\n" + "".join(seq[i : i + width].decode() + "\n"
                                                for i in range(0, len(seq), width))
                   for name, seq in records)
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def genome_files(tmp_path_factory):
    """Genome files of a few tens of kbp: two sequences with N runs and
    lower case (gzip), one plain, all N, shorter than k, poly-A, a tandem
    repeat, an empty file, and a record with no sequence."""
    d = tmp_path_factory.mktemp("genomes")
    rng = np.random.default_rng(13)
    chrom = bytearray(_dna(rng, 30_000))
    chrom[1000:1040] = b"N" * 40
    chrom[5000:5003] = b"nnn"
    chrom[7000:9000] = chrom[7000:9000].lower()
    files = [
        _write(d / "two.fna.gz", [("chr", bytes(chrom)), ("plas", _dna(rng, 5000))], gz=True),
        _write(d / "plain.fna", [("one", _dna(rng, 20_000))]),
        _write(d / "alln.fna", [("n", b"N" * 500)]),
        _write(d / "short.fna", [("a", _dna(rng, 10)), ("b", _dna(rng, 15))]),
        _write(d / "polya.fna", [("a", b"A" * 5000)]),
        _write(d / "repeat.fna", [("r", _dna(rng, 50) * 200), ("s", _dna(rng, 30))], width=70),
        _write(d / "empty.fna", []),
        _write(d / "gap.fna", [("x", b""), ("y", _dna(rng, 3000)), ("z", b"")]),
    ]
    return files


def _same_db(t, j) -> None:
    assert (t.k, t.sketch_size, t.names, t.comments) == (j.k, j.sketch_size, j.names, j.comments)
    for f in ("hashes", "n_hashes", "lengths"):
        x, y = getattr(t, f), getattr(j, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("budget", [None, 3000, 700])
@pytest.mark.parametrize("k,s", [(21, 1), (21, 7), (21, 1000), (21, 100_000), (15, 64), (32, 500)])
def test_build_sketch_db_matches_jax(genome_files, monkeypatch, k, s, budget):
    """budget: the CPU window budget (None: the default); 3000 puts the
    35 kbp genome up in pieces and the others in several batches, 700
    every row past 700 windows in pieces merged by bottom_sketch."""
    if budget is not None:
        monkeypatch.setitem(tsdb.BUILD_WINDOWS, "cpu", budget)
    timings = {}
    got = tsdb.build_sketch_db(genome_files, k=k, sketch_size=s, device="cpu", timings=timings)
    want = jsdb.build_sketch_db(genome_files, k=k, sketch_size=s)
    _same_db(got, want)
    names = [os.path.basename(p) for p in genome_files]
    n = dict(zip(names, got.n_hashes.tolist()))
    assert n["alln.fna"] == n["empty.fna"] == 0 and n["polya.fna"] == 1
    assert (n["short.fna"] == 0) == (k > 15)
    assert got.lengths[names.index("short.fna")] == 25
    assert timings["batches"] >= (1 if budget is None else 4)
    assert {"read_s", "upload_s", "sketch_codes_s", "windows"} <= set(timings)
    assert ("bottom_sketch_s" in timings) == (budget is not None)  # pieces folded


def test_build_sketch_db_with_names(genome_files):
    names = [f"g{i}" for i in range(len(genome_files))]
    _same_db(tsdb.build_sketch_db(genome_files, 21, 50, names=names, device="cpu"),
             jsdb.build_sketch_db(genome_files, 21, 50, names=names))


def test_build_sketch_db_of_no_files():
    _same_db(tsdb.build_sketch_db([], 21, 10, device="cpu"), jsdb.build_sketch_db([], 21, 10))


@pytest.mark.parametrize("s", [1, 7, 1000])
def test_build_from_sequences_matches_jax(genome_files, monkeypatch, s):
    """Mash -i mode: one sketch a sequence, named by the sequence; the
    budget cut so that the rows go up in several batches."""
    from hymet_tpu.io.fasta import iter_fasta

    def seqs():
        for path in genome_files:
            yield from iter_fasta(path)

    monkeypatch.setitem(tsdb.BUILD_WINDOWS, "cpu", 2500)
    _same_db(tsdb.build_sketch_db_from_sequences(seqs(), 21, s, device="cpu"),
             jsdb.build_sketch_db_from_sequences(seqs(), 21, s))
    _same_db(tsdb.build_sketch_db_from_sequences(iter([]), 21, s, device="cpu"),
             jsdb.build_sketch_db_from_sequences(iter([]), 21, s))


def test_sketch_genome_file_matches_jax(genome_files):
    for path in genome_files:
        got, want = tsdb.sketch_genome_file(path, 21, 300, device="cpu"), jsdb.sketch_genome_file(
            path, 21, 300)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_build_defaults_to_the_card(genome_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsdb.build_sketch_db(genome_files[:1])
    with pytest.raises(RuntimeError, match="CUDA"):
        tsdb.build_sketch_db_from_sequences([("a", b"ACGT" * 20)])


def _code_rows(seed: int, B: int, L: int) -> np.ndarray:
    """[B, L] codes: random rows with N runs, a poly-A row, a row of one
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
def test_sketch_batch_matches_jax_on_the_counted_prefix(B, L, k, s):
    """The JAX function (jitted) returns duplicates past n before any
    padding; the two agree on [:n] and n, and the port pads past n."""
    codes = _code_rows(B * L + k, B, L)
    hi, lo, jn = jax_sketch_batch(jnp.asarray(codes), k=k, s=s)
    want = pack64(np.asarray(hi), np.asarray(lo))
    got, n = sketch_batch(torch.from_numpy(codes), k, s)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    got = got.numpy().view(np.uint64)
    for b in range(B):
        m = int(jn[b])
        np.testing.assert_array_equal(got[b, :m], want[b, :m])
        assert (got[b, m:] == jsdb.PAD_HASH).all()
    assert int(n[1 % B]) == min(1, L - k + 1)  # poly-A: one canonical k-mer
    assert int(n[3 % B]) == 0


def test_sketch_batch_row_shorter_than_k():
    """No window: n = 0 and an all-PAD row (the JAX function raises)."""
    got, n = sketch_batch(torch.zeros((2, 10), dtype=torch.uint8), 21, 5)
    assert n.tolist() == [0, 0] and (got == -1).all()


@pytest.mark.parametrize("s", [1, 7, 1000, 5000])
def test_bottom_sketch_torch_matches_host(s):
    """Per row and per pooled segment, on a genome's window hashes (the
    JAX package's numpy hashes of random, repetitive and N-run rows): the
    plain version equals ``bottom_sketch_from_hashes``; the wrapper takes
    it for CPU tensors."""
    codes = _code_rows(s, 4, 3000)
    rows = [kmer_hashes_numpy(c, 21) for c in codes]
    n = 3000 - 20
    hashes = torch.full((4, n), 0, dtype=torch.int64)
    valid = torch.zeros((4, n), dtype=torch.bool)
    for b, c in enumerate(codes):
        _, v = canonical_kmer_bytes(c, 21)
        hashes[b, torch.from_numpy(v)] = torch.from_numpy(rows[b].view(np.int64))
        valid[b] = torch.from_numpy(v)
        hashes[b, ~valid[b]] = 12345  # invalid windows' hashes are ignored
    for segments, groups in ((None, [[0], [1], [2], [3]]), ([1, 3], [[0], [1, 2, 3]]), ([4], [[0, 1, 2, 3]])):
        got = bottom_sketch_torch(hashes, valid, s, segments)
        again = bottom_sketch(hashes, valid, s, segments)
        for g, members in enumerate(groups):
            want, m = jsdb.bottom_sketch_from_hashes(np.concatenate([rows[b] for b in members]), s)
            np.testing.assert_array_equal(got[0][g].numpy().view(np.uint64), want)
            assert int(got[1][g]) == m
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_bottom_sketch_keeps_a_real_pad_hash():
    """A valid hash equal to PAD_HASH counts, as np.unique counts it in
    the host build (the JAX sketch_batch would drop it)."""
    h = torch.tensor([[5, -1, 3, -1, 5]], dtype=torch.int64)
    valid = torch.tensor([[True, True, True, False, True]])
    out, n = bottom_sketch_torch(h, valid, 4)
    want, m = jsdb.bottom_sketch_from_hashes(np.array([5, 2**64 - 1, 3, 5], np.uint64), 4)
    np.testing.assert_array_equal(out[0].numpy().view(np.uint64), want)
    assert int(n[0]) == m == 3


def test_bottom_sketch_rejects_bad_segments():
    h, v = torch.zeros((3, 4), dtype=torch.int64), torch.ones((3, 4), dtype=torch.bool)
    for segments in ([1, 1], [0, 3], [4]):
        with pytest.raises(ValueError, match="segments"):
            bottom_sketch_torch(h, v, 2, segments)


def test_code_batches_respect_the_budget():
    """Longest first, at most `budget` windows padded to a batch's longest
    row (a longer row alone), rows shorter than k apart."""
    rows = [np.zeros(n, np.uint8) for n in (100, 5, 300, 60, 60, 20, 2000)]
    batches = list(tsdb.code_batches(rows, 21, 400))
    assert sorted(i for b in batches for i in b) == list(range(7))
    assert batches[0] == [6] and batches[-1] == [5, 1]  # 20 and 5 bases: no window
    for b in batches[1:-1]:
        assert len(b) * (max(len(rows[i]) for i in b) - 20) <= 400
    assert [len(rows[b[0]]) for b in batches] == sorted((len(rows[b[0]]) for b in batches),
                                                        reverse=True)
