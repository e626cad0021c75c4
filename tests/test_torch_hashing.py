"""hymet_tpu_torch hashing vs the JAX package: the plain PyTorch k-mer hash
against kmer_hashes_jax and the Pallas kernel (interpret mode), the
scalar/numpy oracles, the 2-bit unpack, and the kernel wrappers' CPU
dispatch. Integers must be identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hymet_tpu.io import fasta as jfasta
from hymet_tpu.ops import hashing as jhash
from hymet_tpu.ops.pallas_kernels import TILE, kmer_hashes_pallas
from hymet_tpu_torch.io import fasta as tfasta
from hymet_tpu_torch.ops import hash_kernels
from hymet_tpu_torch.ops import hashing as thash

torch.set_num_threads(1)


def _codes(seed: int, B: int, L: int) -> np.ndarray:
    """Random ACGT codes with runs of N (4) and one N at a row end."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[0, L // 3 : L // 3 + 7] = 4
    codes[-1, rng.integers(0, L)] = 4
    codes[-1, -1] = 4
    return codes


def _u64(h: torch.Tensor) -> np.ndarray:
    return h.numpy().view(np.uint64)


@pytest.mark.parametrize("k", [15, 21, 32])
@pytest.mark.parametrize("L", [1000, TILE + 20, 3 * TILE + 7])
def test_plain_hash_matches_jax_and_pallas(L, k):
    codes = _codes(L + k, 2, L)
    h, v = thash.kmer_hashes_torch(torch.from_numpy(codes), k)
    n = L - k + 1
    assert h.dtype == torch.int64 and v.dtype == torch.bool
    assert tuple(h.shape) == (2, n) == tuple(v.shape)

    jhi, jlo, jv = kmer_hashes_pallas(jnp.asarray(codes), k, interpret=True)
    pv = np.asarray(jv)
    np.testing.assert_array_equal(v.numpy(), pv[:, :n])
    # every window, valid or not, hashes identically (codes & 3 in both)
    np.testing.assert_array_equal(
        _u64(h), jhash.pack64(np.asarray(jhi)[:, :n], np.asarray(jlo)[:, :n])
    )
    assert not pv[:, n:].any()

    xhi, xlo, xv = jhash.kmer_hashes_jax(jnp.asarray(codes), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(xv))
    np.testing.assert_array_equal(_u64(h), jhash.pack64(np.asarray(xhi), np.asarray(xlo)))


@pytest.mark.parametrize("k", [1, 8, 9, 16, 17, 24, 25, 31])
def test_plain_hash_matches_scalar_murmur(k):
    """Single k-mers against the pure-Python MurmurHash3 of their
    canonical ASCII bytes (Mash's rule: the smaller of k-mer and revcomp)."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(3, k), dtype=np.uint8)
    h, v = thash.kmer_hashes_torch(torch.from_numpy(codes), k)
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    for row in range(3):
        fwd = bytes(b"ACGT"[c] for c in codes[row])
        rc = bytes(b"ACGT"[comp[int(c)]] for c in codes[row][::-1])
        want = jhash.murmur3_x64_128_py(min(fwd, rc))[0]
        assert int(_u64(h)[row, 0]) == want
        assert bool(v[row, 0])


@pytest.mark.parametrize("k", [15, 21, 32])
def test_host_oracles_match_reference(k):
    codes = _codes(7 * k, 1, 500)[0]
    np.testing.assert_array_equal(
        thash.kmer_hashes_numpy(codes, k), jhash.kmer_hashes_numpy(codes, k)
    )
    for data in (b"", b"A", b"ACGTACGTACGTACG", b"ACGT" * 8, b"TTGCA" * 7):
        assert thash.murmur3_x64_128_py(data) == jhash.murmur3_x64_128_py(data)
    h, v = thash.kmer_hashes_torch(torch.from_numpy(codes[None, :]), k)
    np.testing.assert_array_equal(_u64(h)[0][v.numpy()[0]], jhash.kmer_hashes_numpy(codes, k))


@pytest.mark.parametrize("L", [1, 8, 1003, 4096])
def test_unpack_code_batch_matches_jax(L):
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 5, size=(3, L), dtype=np.uint8)
    packed, mask, L2 = tfasta.pack_code_batch(codes)
    jpacked, jmask, _ = jfasta.pack_code_batch(codes)
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(mask, jmask)
    got = thash.unpack_code_batch(torch.from_numpy(packed), torch.from_numpy(mask), L2)
    want = jhash.unpack_code_batch_jax(jnp.asarray(packed), jnp.asarray(mask), L2)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), codes)


def test_fasta_copies_match_reference(tmp_path):
    fa = tmp_path / "q.fna"
    fa.write_text(">a desc\nACGTN\nacgt\n>b\n\n>c\nRYKM\n")
    assert tfasta.read_fasta(str(fa)) == jfasta.read_fasta(str(fa))
    for _, seq in tfasta.iter_fasta(str(fa)):
        np.testing.assert_array_equal(tfasta.encode_seq(seq), jfasta.encode_seq(seq))


def test_wrapper_takes_plain_path_on_cpu():
    codes = torch.from_numpy(_codes(3, 2, 300))
    before = hash_kernels.kmer_hashes.launches
    h, v = hash_kernels.kmer_hashes(codes, 21)
    h2, v2 = thash.kmer_hashes_torch(codes, 21)
    assert torch.equal(h, h2) and torch.equal(v, v2)
    assert hash_kernels.kmer_hashes.launches == before  # no kernel launch


@pytest.mark.parametrize("L,k", [(10, 21), (40, 0), (40, 33)])
def test_plain_hash_rejects_bad_shapes(L, k):
    with pytest.raises(ValueError):
        thash.kmer_hashes_torch(torch.zeros((1, L), dtype=torch.uint8), k)


def test_wrapper_refuses_other_devices():
    """No silent fallback: a tensor on neither the CPU nor a CUDA card is refused."""
    with pytest.raises(ValueError):
        hash_kernels.kmer_hashes(torch.zeros((1, 40), dtype=torch.uint8, device="meta"), 21)


def _count_inputs(seed: int, k: int = 21):
    """A packed batch and flat keys holding some of its hashes."""
    codes = _codes(seed, 3, 700)
    packed, mask, L = tfasta.pack_code_batch(codes)
    h, v = thash.kmer_hashes_torch(torch.from_numpy(codes), k)
    keys = torch.unique(torch.cat([h[v][::7], torch.tensor([5, -9])]) ^ thash.SIGN)
    return torch.from_numpy(packed), torch.from_numpy(mask), L, keys


def test_screen_count_wrapper_takes_plain_path_on_cpu():
    packed, mask, L, flat = _count_inputs(4)
    before = hash_kernels.screen_count.launches
    out = []
    for fn in (hash_kernels.screen_count, hash_kernels.screen_count_torch):
        counts = torch.zeros(flat.shape[0], dtype=torch.int32)
        total = torch.zeros(1, dtype=torch.int64)
        fn(packed, mask, L, 21, flat, int(flat[-1]), counts, total)
        out.append((counts, total))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert int(out[0][0].sum()) > 0 and int(out[0][1]) > 0
    assert hash_kernels.screen_count.launches == before  # no kernel launch


@pytest.mark.parametrize("where", ["meta", "mixed"])
def test_screen_count_wrapper_refuses_other_devices(where):
    """A batch on neither the CPU nor a card, or split across devices, is refused."""
    packed, mask, L, flat = _count_inputs(5)
    counts = torch.zeros(flat.shape[0], dtype=torch.int32)
    total = torch.zeros(1, dtype=torch.int64, device="meta" if where == "meta" else "cpu")
    if where == "meta":
        packed, mask, flat, counts = (x.to("meta") for x in (packed, mask, flat, counts))
    else:
        counts = counts.to("meta")
    with pytest.raises(ValueError):
        hash_kernels.screen_count(packed, mask, L, 21, flat, 0, counts, total)
