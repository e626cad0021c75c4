"""hymet_tpu_torch MinimizerIndex vs the JAX package's: the same arrays
from the same sequences, and the .npz cache read both ways."""

import numpy as np
import pytest
import torch

from hymet_tpu.io.minimizer_index import MinimizerIndex as JIndex
from hymet_tpu_torch.io.minimizer_index import MinimizerIndex as TIndex

torch.set_num_threads(1)

FIELDS = ("hashes", "seq_id", "pos", "strand", "lengths")
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _genomes(seed: int):
    """Sequences of mixed lengths: random, a repeat of another (equal
    hashes across sequences), an N run, lowercase, a low-complexity one,
    and ones shorter than a window (k + w - 1) and empty."""
    rng = np.random.default_rng(seed)
    seqs = [_ACGT[rng.integers(0, 4, n)].tobytes() for n in (30000, 12000, 5000)]
    seqs.append(seqs[1][2000:9000])
    s = bytearray(seqs[0][:8000])
    s[3000:3100] = b"N" * 100
    seqs.append(bytes(s))
    seqs.append(seqs[2][:4000].lower())
    seqs.append((b"AC" * 1500) + seqs[2][:500])
    seqs += [seqs[0][:36], seqs[0][:37], b""]
    return [(f"s{i}", q) for i, q in enumerate(seqs)]


def _assert_same(a, b):
    assert (a.k, a.w, a.names) == (b.k, b.w, b.names)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("k,w", [(19, 19), (15, 5), (31, 3)])
def test_build_matches_jax(k, w):
    genomes = _genomes(k + w)
    _assert_same(TIndex.build(genomes, k=k, w=w, device="cpu"), JIndex.build(genomes, k=k, w=w))


def test_build_from_fasta_matches_jax(tmp_path):
    fasta = tmp_path / "ref.fna"
    fasta.write_text("".join(f">{n} desc\n{s.decode()}\n" for n, s in _genomes(5)))
    _assert_same(TIndex.build_from_fasta(str(fasta), device="cpu"), JIndex.build_from_fasta(str(fasta)))


def test_npz_reads_both_ways(tmp_path):
    """An index the port saves loads into the JAX package, and one the JAX
    package saves loads into the port, array for array."""
    genomes = _genomes(9)
    mine, theirs = TIndex.build(genomes, device="cpu"), JIndex.build(genomes)
    mine.save(str(tmp_path / "port.npz"))
    theirs.save(str(tmp_path / "jax.npz"))
    _assert_same(JIndex.load(str(tmp_path / "port.npz")), theirs)
    _assert_same(TIndex.load(str(tmp_path / "jax.npz")), mine)
    with np.load(str(tmp_path / "port.npz"), allow_pickle=True) as a, \
            np.load(str(tmp_path / "jax.npz"), allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
