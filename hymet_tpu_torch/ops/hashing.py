"""MurmurHash3_x64_128 k-mer hashing, Mash-compatible.

Mash hashes each canonical k-mer's ASCII bytes with MurmurHash3_x64_128
(seed 42) and keeps the first 64 bits. Three implementations live here:

- :func:`murmur3_x64_128_py` — scalar pure Python, from the MurmurHash3
  specification; the ground truth for tests (copy of hymet_tpu's).
- :func:`kmer_hashes_numpy` — vectorized numpy uint64 over one sequence
  (copy of hymet_tpu's host oracle); :func:`kmer_hashes_host` takes the
  native helpers (:mod:`hymet_tpu_torch.io.native_io`) instead where they
  built, for the CPU DB build.
- :func:`kmer_hashes_torch` — the plain PyTorch version of the screen's
  hash kernel over a [B, L] code batch: the CPU path, and the version the
  CUDA kernel (:mod:`hymet_tpu_torch.ops.hash_kernels`) is held against.

64-bit hashes travel as int64 tensors holding the uint64 bit pattern:
torch multiplies and adds int64 with wrap-around like uint64, but its
``>>`` is arithmetic and its compares are signed. So right shifts are
masked (:func:`_lsr`) and values are XORed with :data:`SIGN` before any
sort, search or compare, which maps unsigned order onto signed order.

Canonical k-mer rule (Mash's): the lexicographically smaller of the
forward k-mer and its reverse complement. A<C<G<T holds in both the
2-bit codes and ASCII, so this is an integer compare of 2-bit-packed
k-mers.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

SEED = 42  # Mash's default hash seed

_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F
_F1 = 0xFF51AFD7ED558CCD
_F2 = 0xC4CEB9FE1A85EC53
_M64 = (1 << 64) - 1

# XOR with SIGN maps uint64 bit patterns held in int64 onto signed order
SIGN = -(1 << 63)


def as_int64(x: int) -> int:
    """uint64 value -> the int64 with the same bit pattern."""
    return x - (1 << 64) if x >= (1 << 63) else x


# ----------------------------------------------------------------------
# scalar pure-Python ground truth


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * _F1) & _M64
    k ^= k >> 33
    k = (k * _F2) & _M64
    k ^= k >> 33
    return k


def murmur3_x64_128_py(data: bytes, seed: int = SEED) -> Tuple[int, int]:
    """MurmurHash3_x64_128 of `data`; returns (h1, h2) as ints."""
    length = len(data)
    nblocks = length // 16
    h1 = seed
    h2 = seed

    for b in range(nblocks):
        k1 = int.from_bytes(data[b * 16 : b * 16 + 8], "little")
        k2 = int.from_bytes(data[b * 16 + 8 : b * 16 + 16], "little")
        k1 = (k1 * _C1) & _M64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _M64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _M64
        h1 = (h1 * 5 + 0x52DCE729) & _M64
        k2 = (k2 * _C2) & _M64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _M64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _M64
        h2 = (h2 * 5 + 0x38495AB5) & _M64

    tail = data[nblocks * 16 :]
    k1 = 0
    k2 = 0
    for i in range(len(tail) - 1, 7, -1):  # bytes 8..15 into k2
        k2 = (k2 << 8) | tail[i]
    for i in range(min(len(tail), 8) - 1, -1, -1):  # bytes 0..7 into k1
        k1 = (k1 << 8) | tail[i]
    if len(tail) > 8:
        k2 = (k2 * _C2) & _M64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _M64
        h2 ^= k2
    if len(tail) > 0:
        k1 = (k1 * _C1) & _M64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _M64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    return h1, h2


# ----------------------------------------------------------------------
# vectorized numpy (uint64 lanes, host)

_NP_C1 = np.uint64(_C1)
_NP_C2 = np.uint64(_C2)


def _np_rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _np_fmix(k: np.ndarray) -> np.ndarray:
    k = k ^ (k >> np.uint64(33))
    k = k * np.uint64(_F1)
    k = k ^ (k >> np.uint64(33))
    k = k * np.uint64(_F2)
    k = k ^ (k >> np.uint64(33))
    return k


def murmur3_x64_128_numpy(rows: np.ndarray, seed: int = SEED) -> np.ndarray:
    """Hash each row of a [N, L] uint8 byte matrix; returns [N] uint64 h1
    (the 64-bit hash Mash keeps)."""
    n, length = rows.shape
    nblocks = length // 16
    h1 = np.full(n, seed, dtype=np.uint64)
    h2 = np.full(n, seed, dtype=np.uint64)

    def word(lo_byte: int) -> np.ndarray:
        w = np.zeros(n, dtype=np.uint64)
        for i in range(7, -1, -1):
            w = (w << np.uint64(8)) | rows[:, lo_byte + i].astype(np.uint64)
        return w

    with np.errstate(over="ignore"):
        for b in range(nblocks):
            k1 = word(b * 16)
            k2 = word(b * 16 + 8)
            k1 *= _NP_C1
            k1 = _np_rotl(k1, 31)
            k1 *= _NP_C2
            h1 ^= k1
            h1 = _np_rotl(h1, 27)
            h1 += h2
            h1 = h1 * np.uint64(5) + np.uint64(0x52DCE729)
            k2 *= _NP_C2
            k2 = _np_rotl(k2, 33)
            k2 *= _NP_C1
            h2 ^= k2
            h2 = _np_rotl(h2, 31)
            h2 += h1
            h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)

        tail_len = length - nblocks * 16
        base = nblocks * 16
        if tail_len > 8:
            k2 = np.zeros(n, dtype=np.uint64)
            for i in range(tail_len - 1, 7, -1):
                k2 = (k2 << np.uint64(8)) | rows[:, base + i].astype(np.uint64)
            k2 *= _NP_C2
            k2 = _np_rotl(k2, 33)
            k2 *= _NP_C1
            h2 ^= k2
        if tail_len > 0:
            k1 = np.zeros(n, dtype=np.uint64)
            for i in range(min(tail_len, 8) - 1, -1, -1):
                k1 = (k1 << np.uint64(8)) | rows[:, base + i].astype(np.uint64)
            k1 *= _NP_C1
            k1 = _np_rotl(k1, 31)
            k1 *= _NP_C2
            h1 ^= k1

        h1 ^= np.uint64(length)
        h2 ^= np.uint64(length)
        h1 += h2
        h2 += h1
        h1 = _np_fmix(h1)
        h2 = _np_fmix(h2)
        h1 += h2
    return h1


_CODE_TO_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)


def canonical_kmer_bytes(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """All k-mer windows of a uint8 code sequence -> canonical ASCII byte
    rows [n_kmers, k] plus a validity mask (False where the window holds a
    non-ACGT base). Requires k <= 32."""
    if not 1 <= k <= 32:
        raise ValueError(f"packed canonicalization supports 1 <= k <= 32, got {k}")
    n = codes.shape[0] - k + 1
    if n <= 0:
        return np.zeros((0, k), dtype=np.uint8), np.zeros(0, dtype=bool)

    inv = (codes >= 4).astype(np.int32)
    csum = np.concatenate([[0], np.cumsum(inv)])
    valid = (csum[k:] - csum[:-k]) == 0

    fwd = np.zeros(n, dtype=np.uint64)
    rc = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        c = (codes[j : j + n] & 3).astype(np.uint64)
        fwd |= c << np.uint64(2 * (k - 1 - j))
        rc |= (np.uint64(3) - c) << np.uint64(2 * j)
    canon = np.minimum(fwd, rc)

    out = np.empty((n, k), dtype=np.uint8)
    for j in range(k):
        out[:, j] = _CODE_TO_CHAR[
            ((canon >> np.uint64(2 * (k - 1 - j))) & np.uint64(3)).astype(np.uint8)
        ]
    return out, valid


def kmer_hashes_numpy(codes: np.ndarray, k: int, seed: int = SEED) -> np.ndarray:
    """uint64 hashes of all valid canonical k-mers of a code sequence."""
    rows, valid = canonical_kmer_bytes(codes, k)
    if rows.shape[0] == 0:
        return np.zeros(0, dtype=np.uint64)
    return murmur3_x64_128_numpy(rows[valid], seed)


def pack64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) 32-bit limbs (any integer dtype holding values below 2^32)
    -> uint64, on the host."""
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def kmer_hashes_host(codes: np.ndarray, k: int) -> np.ndarray:
    """Host k-mer hashing: the native helpers where they built (1 <= k <=
    32), :func:`kmer_hashes_numpy` else. Mash's default seed only (the
    native code pins it)."""
    from hymet_tpu_torch.io import native_io

    if 1 <= k <= 32 and native_io.available():
        return native_io.kmer_hashes(codes, k)
    return kmer_hashes_numpy(codes, k)


# ----------------------------------------------------------------------
# plain PyTorch (int64 holding uint64 bit patterns)

_T_C1 = as_int64(_C1)
_T_C2 = as_int64(_C2)
_T_F1 = as_int64(_F1)
_T_F2 = as_int64(_F2)


def _lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch's >> is arithmetic)."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 64 - r)


def _fmix(k: torch.Tensor) -> torch.Tensor:
    k = k ^ _lsr(k, 33)
    k = k * _T_F1
    k = k ^ _lsr(k, 33)
    k = k * _T_F2
    return k ^ _lsr(k, 33)


def _murmur3_h1_words(words: List[torch.Tensor], length: int, seed: int) -> torch.Tensor:
    """MurmurHash3_x64_128 h1 of messages of `length` <= 32 bytes given as
    four little-endian 64-bit words each (bytes past `length` zero)."""
    h1 = torch.full_like(words[0], seed)
    h2 = torch.full_like(words[0], seed)
    nblocks = length // 16
    for b in range(nblocks):
        k1 = _rotl(words[2 * b] * _T_C1, 31) * _T_C2
        h1 = _rotl(h1 ^ k1, 27) + h2
        h1 = h1 * 5 + 0x52DCE729
        k2 = _rotl(words[2 * b + 1] * _T_C2, 33) * _T_C1
        h2 = _rotl(h2 ^ k2, 31) + h1
        h2 = h2 * 5 + 0x38495AB5
    tail = length - nblocks * 16
    if tail > 8:
        h2 = h2 ^ (_rotl(words[2 * nblocks + 1] * _T_C2, 33) * _T_C1)
    if tail > 0:
        h1 = h1 ^ (_rotl(words[2 * nblocks] * _T_C1, 31) * _T_C2)
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    return _fmix(h1) + _fmix(h2)


def kmer_hashes_torch(
    codes: torch.Tensor, k: int, seed: int = SEED
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] uint8 codes -> (hash int64 [B, L-k+1], valid bool [B, L-k+1]).

    For every k-window: valid if no code >= 4 lies in it; the canonical
    2-bit packed k-mer (codes taken & 3, so invalid windows still get a
    defined hash, as in the Pallas kernel); that k-mer's ASCII bytes;
    MurmurHash3_x64_128 h1 (`seed`) as an int64 bit pattern. Plain
    PyTorch on whatever device `codes` lies on."""
    if codes.dim() != 2:
        raise ValueError(f"codes must be [B, L], got shape {tuple(codes.shape)}")
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in 1..32, got {k}")
    B, L = codes.shape
    n = L - k + 1
    if n <= 0:
        raise ValueError(f"sequence shorter than k: L={L}, k={k}")
    c = codes.to(torch.int64)
    csum = torch.nn.functional.pad(torch.cumsum((c >= 4).to(torch.int32), dim=1), (1, 0))
    valid = (csum[:, k:] - csum[:, :-k]) == 0

    c = c & 3
    fwd = torch.zeros((B, n), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        w = c[:, j : j + n]
        fwd = fwd | (w << (2 * (k - 1 - j)))
        rc = rc | ((3 - w) << (2 * j))
    canon = torch.where((fwd ^ SIGN) <= (rc ^ SIGN), fwd, rc)

    ascii_lut = torch.tensor([65, 67, 71, 84], dtype=torch.int64, device=codes.device)
    words = [torch.zeros_like(fwd) for _ in range(4)]
    for j in range(k):
        ch = ascii_lut[(canon >> (2 * (k - 1 - j))) & 3]
        words[j >> 3] = words[j >> 3] | (ch << (8 * (j & 7)))
    return _murmur3_h1_words(words, k, seed), valid


def unpack_code_batch(packed: torch.Tensor, mask: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse of :func:`hymet_tpu_torch.io.fasta.pack_code_batch`:
    [B, W] 2-bit fields + [B, M] validity bits -> [B, L] uint8 codes with
    invalid positions restored to 4."""
    B = packed.shape[0]
    p = packed.to(torch.int32)
    m = mask.to(torch.int32)
    codes4 = torch.stack([(p >> (2 * i)) & 3 for i in range(4)], dim=-1).reshape(B, -1)
    bits = torch.stack([(m >> i) & 1 for i in range(8)], dim=-1).reshape(B, -1)
    codes = torch.where(bits[:, : codes4.shape[1]] == 1, codes4, 4)
    return codes[:, :L].to(torch.uint8)


def pack_code_batch_torch(codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`hymet_tpu_torch.io.fasta.pack_code_batch` on the device of
    `codes` ([B, L] uint8): (packed [B, ceil(L/8)*2] uint8, mask
    [B, ceil(L/8)] uint8, L), the same bytes as the host packer."""
    B, L = codes.shape
    Lp = -(-L // 8) * 8
    c = torch.nn.functional.pad(codes, (0, Lp - L), value=4)
    valid = c < 4
    two = torch.where(valid, c, torch.zeros_like(c)).to(torch.int32).reshape(B, -1, 4)
    packed = (two << torch.arange(0, 8, 2, dtype=torch.int32, device=c.device)).sum(dim=-1)
    bits = valid.to(torch.int32).reshape(B, -1, 8)
    mask = (bits << torch.arange(8, dtype=torch.int32, device=c.device)).sum(dim=-1)
    return packed.to(torch.uint8), mask.to(torch.uint8), L
