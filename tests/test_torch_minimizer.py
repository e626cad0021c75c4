"""hymet_tpu_torch minimizer extraction vs the JAX package: hash64 twins,
every window's (hi, lo, pos, strand, keep) element for element, and the
plain compacted minimizers the align kernel is held against."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hymet_tpu.io.fasta import pack_code_batch
from hymet_tpu.ops import minimizer as jm
from hymet_tpu_torch.ops import align_kernels
from hymet_tpu_torch.ops import minimizer as tm

torch.set_num_threads(1)


def _codes(seed: int, B: int, L: int) -> np.ndarray:
    """Random ACGT rows with an N run, a low-complexity row (A/C only),
    equal k-mers in one window (a repeat of period 2) and a padded tail."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[0, L // 4 : L // 4 + 30] = 4
    codes[1] = rng.integers(0, 2, L)
    codes[2, : L // 2] = np.arange(L // 2) % 2
    codes[3, 2 * L // 3 :] = 4
    codes[-1, ::53] = 4
    return codes


@pytest.mark.parametrize("bits", [2, 32, 38, 62, 64])
def test_hash64_twins_match(bits):
    rng = np.random.default_rng(bits)
    keys = rng.integers(0, 2**63, size=500, dtype=np.uint64) << np.uint64(1)
    keys |= rng.integers(0, 2, size=500, dtype=np.uint64)
    keys &= np.uint64((1 << bits) - 1)
    want = jm.hash64_numpy(keys, bits)
    np.testing.assert_array_equal(tm.hash64_numpy(keys, bits), want)
    got = tm.hash64_torch(torch.from_numpy(keys.view(np.int64)), bits).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    hi, lo = jm.hash64_jax(
        jnp.asarray((keys >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)), bits,
    )
    np.testing.assert_array_equal(
        (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo), want
    )


@pytest.mark.parametrize("k,w", [(19, 19), (16, 1), (16, 5), (31, 19), (32, 19)])
def test_extract_minimizers_matches_jax(k, w):
    """All five outputs element for element: the asm10 preset, w = 1, the
    32-bit limb boundary (2k = 32) and k = 31/32 (the whole 64-bit key)."""
    codes = _codes(k * 100 + w, 5, 700)
    want = jm.extract_minimizers_jax(jnp.asarray(codes), k, w)
    got = tm.extract_minimizers_torch(torch.from_numpy(codes), k, w)
    for name, a, b in zip(("hi", "lo", "pos", "strand", "keep"), want, got):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), name
        np.testing.assert_array_equal(b.numpy().astype(np.int64), a.astype(np.int64), err_msg=name)


@pytest.mark.parametrize("k,w", [(19, 19), (15, 10), (32, 3)])
def test_numpy_twin_matches_reference(k, w):
    for seed, L in ((0, 5000), (1, k + w - 2), (2, k + w - 1), (3, 3000)):
        codes = _codes(seed, 5, L)[seed % 5]
        for a, b in zip(tm.extract_minimizers_numpy(codes, k, w), jm.extract_minimizers_numpy(codes, k, w)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", [4096, 100])
def test_compacted_minimizers_match_jax_keep_order(cap):
    """The plain compacted minimizers (the CPU path of the minimizer
    kernel's wrapper): the kept windows of extract_minimizers_jax in
    row-major order, cut to cap, zeros after, n_kept counting all."""
    k, w, L = 19, 19, 1024
    codes = _codes(7, 6, L)
    codes[4] = 4  # an all-padding row
    packed, mask, _ = pack_code_batch(codes)
    got = align_kernels.minimizers(torch.from_numpy(packed), torch.from_numpy(mask), L, k, w, cap)
    hi, lo, pos, strand, keep = (np.asarray(x) for x in jm.extract_minimizers_jax(jnp.asarray(codes), k, w))
    sel = np.flatnonzero(keep.reshape(-1))
    assert int(got[4]) == sel.size > 100
    sel = sel[:cap]
    n = sel.size
    h = ((hi.astype(np.uint64) << np.uint64(32)) | lo).reshape(-1)[sel].view(np.int64)
    want = (h, pos.reshape(-1)[sel], strand.reshape(-1)[sel], sel // keep.shape[1])
    for a, b in zip(got[:4], want):
        np.testing.assert_array_equal(a[:n].numpy().astype(np.int64), b.astype(np.int64))
        assert not a[n:].any()


def test_compacted_minimizers_row_len_match_numpy_per_sequence():
    """row_len cuts each row's windows at its own length: the kept
    minimizers of a row equal the numpy twin's on the unpadded sequence
    (the index build's contract), rows shorter than k + w - 1 give none."""
    k, w, L = 19, 19, 2048
    rng = np.random.default_rng(3)
    lengths = [2048, 1500, 700, k + w - 1, k + w - 2, 0]
    codes = np.full((len(lengths), L), 4, dtype=np.uint8)
    for r, n in enumerate(lengths):
        codes[r, :n] = rng.integers(0, 4, n)
    codes[1, 300:340] = 4
    packed, mask, _ = pack_code_batch(codes)
    row_len = torch.tensor(lengths, dtype=torch.int32)
    h, p, s, rows, n_kept = align_kernels.minimizers(
        torch.from_numpy(packed), torch.from_numpy(mask), L, k, w, 1 << 12, row_len)
    n = int(n_kept)
    for r, ln in enumerate(lengths):
        mine = rows[:n] == r
        wh, wp, ws = tm.extract_minimizers_numpy(codes[r, :ln], k, w)
        np.testing.assert_array_equal(h[:n][mine].numpy().view(np.uint64), wh)
        np.testing.assert_array_equal(p[:n][mine].numpy(), wp)
        np.testing.assert_array_equal(s[:n][mine].numpy(), ws.astype(np.uint8))
