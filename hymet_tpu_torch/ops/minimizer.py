"""Minimizer extraction, minimap2-style (counterpart of hymet_tpu.ops.minimizer).

minimap2's invertible ``hash64`` mixer over 2-bit-packed canonical k-mers
(2k bits), leftmost-minimum winnowing over windows of w k-mers, and the
keep flag of a window that brings a new minimizer position. Three
implementations of one function:

- numpy uint64 twins (copies of hymet_tpu's): :func:`hash64_numpy` and
  :func:`extract_minimizers_numpy` — the CPU index build and the tests;
- :func:`extract_minimizers_torch` — the plain PyTorch version over a
  [B, L] code batch, with the same (hi, lo, pos, strand, keep) outputs as
  ``extract_minimizers_jax``; the aligner's CPU path, and what the CUDA
  kernel (``csrc/minimizers.cu``, :mod:`hymet_tpu_torch.ops.align_kernels`)
  is held against.

Rules kept exactly: canonical k-mer = min(forward, reverse complement),
strand = forward > reverse complement; a k-mer holding a non-ACGT base
hashes to the all-ones sentinel, so it never wins a window; the leftmost
minimum wins ties; keep = a new position and not the sentinel. 64-bit
values travel as int64 holding the uint64 bit pattern (see
:mod:`hymet_tpu_torch.ops.hashing`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hymet_tpu_torch.ops.hashing import SIGN, _lsr, as_int64

BAD = -1  # the all-ones sentinel hash of an invalid k-mer, as int64


# ----------------------------------------------------------------------
# numpy uint64 twins (copies of hymet_tpu.ops.minimizer's)


def hash64_numpy(key: np.ndarray, bits: int) -> np.ndarray:
    mask = np.uint64((1 << bits) - 1)
    key = key.astype(np.uint64)
    with np.errstate(over="ignore"):
        key = (~key + (key << np.uint64(21))) & mask
        key = key ^ (key >> np.uint64(24))
        key = (key + (key << np.uint64(3)) + (key << np.uint64(8))) & mask
        key = key ^ (key >> np.uint64(14))
        key = (key + (key << np.uint64(2)) + (key << np.uint64(4))) & mask
        key = key ^ (key >> np.uint64(28))
        key = (key + (key << np.uint64(31))) & mask
    return key


def _packed_kmers_numpy(codes: np.ndarray, k: int):
    L = codes.shape[0]
    n = L - k + 1
    if n <= 0:
        z = np.zeros(0, dtype=np.uint64)
        return z, np.zeros(0, dtype=bool), np.zeros(0, dtype=np.int8)
    inv = (codes >= 4).astype(np.int32)
    csum = np.concatenate([[0], np.cumsum(inv)])
    valid = (csum[k:] - csum[:-k]) == 0
    fwd = np.zeros(n, dtype=np.uint64)
    rc = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        c = (codes[j : j + n] & 3).astype(np.uint64)
        fwd |= c << np.uint64(2 * (k - 1 - j))
        rc |= (np.uint64(3) - c) << np.uint64(2 * j)
    strand = (fwd > rc).astype(np.int8)
    canon = np.minimum(fwd, rc)
    return canon, valid, strand


def _sliding_argmin(h: np.ndarray, w: int) -> np.ndarray:
    """Leftmost argmin over every length-w window of `h`, via the van
    Herk/Gil-Werman block prefix/suffix min decomposition."""
    n = h.shape[0]
    nw = n - w + 1
    pad = (-n) % w
    maxv = np.uint64(0xFFFFFFFFFFFFFFFF)
    hp = np.concatenate([h, np.full(pad, maxv, dtype=np.uint64)]) if pad else h
    # transpose to [w, nblocks] so each scan step is a contiguous row op
    m = np.ascontiguousarray(hp.reshape(-1, w).T)
    idx = np.ascontiguousarray(
        np.arange(hp.shape[0], dtype=np.int64).reshape(-1, w).T
    )
    # prefix scan (left->right), strict < keeps the earlier index on ties
    pv = m.copy()
    pi = idx.copy()
    for j in range(1, w):
        upd = m[j] < pv[j - 1]
        pv[j] = np.where(upd, m[j], pv[j - 1])
        pi[j] = np.where(upd, idx[j], pi[j - 1])
    # suffix scan (right->left), <= prefers the left index
    sv = m.copy()
    si = idx.copy()
    for j in range(w - 2, -1, -1):
        upd = m[j] <= sv[j + 1]
        sv[j] = np.where(upd, m[j], sv[j + 1])
        si[j] = np.where(upd, idx[j], si[j + 1])
    sv_f = sv.T.ravel()
    si_f = si.T.ravel()
    pv_f = pv.T.ravel()
    pi_f = pi.T.ravel()
    # window [i, i+w-1] = suffix-of-block(i) U prefix-of-block(i+w-1)
    end = np.arange(nw, dtype=np.int64) + w - 1
    a_val, a_idx = sv_f[:nw], si_f[:nw]
    b_val, b_idx = pv_f[end], pi_f[end]
    take_a = (a_val < b_val) | ((a_val == b_val) & (a_idx <= b_idx))
    return np.where(take_a, a_idx, b_idx).astype(np.int32)


def extract_minimizers_numpy(
    codes: np.ndarray, k: int, w: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Minimizers of one code sequence, for index builds. Returns (hashes
    uint64, positions int32, strands int8) of the kept windows, in order."""
    bits = 2 * k
    canon, valid, strand = _packed_kmers_numpy(codes, k)
    n = canon.shape[0]
    if n < w:
        return (
            np.zeros(0, dtype=np.uint64),
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int8),
        )
    h = hash64_numpy(canon, bits)
    h = np.where(valid, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    nw = n - w + 1
    pos = _sliding_argmin(h, w)
    hmin = h[pos]
    keep = np.ones(nw, dtype=bool)
    keep[1:] = pos[1:] != pos[:-1]
    keep &= hmin != np.uint64(0xFFFFFFFFFFFFFFFF)
    pos = pos[keep]
    return h[pos], pos, strand[pos]


# ----------------------------------------------------------------------
# plain PyTorch (int64 holding uint64 bit patterns)


def hash64_torch(key: torch.Tensor, bits: int) -> torch.Tensor:
    """minimap2's hash64 of int64 keys (uint64 bit patterns) under a
    `bits`-bit mask (bits <= 64)."""
    mask = as_int64((1 << bits) - 1)
    key = (~key + (key << 21)) & mask
    key = key ^ _lsr(key, 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ _lsr(key, 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ _lsr(key, 28)
    return (key + (key << 31)) & mask


def packed_canonical_kmers_torch(codes: torch.Tensor, k: int):
    """[B, L] uint8 codes -> (canonical 2k-bit k-mer int64 [B, n], valid
    bool, strand int32) with n = L - k + 1; strand 1 where the forward
    k-mer is above its reverse complement. Codes >= 4 count as code & 3 in
    the k-mer and make the window invalid."""
    B, L = codes.shape
    n = L - k + 1
    c = codes.to(torch.int64)
    inv = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int64, device=codes.device), (c >= 4).long().cumsum(1)], 1
    )
    valid = (inv[:, k:] - inv[:, :-k]) == 0
    c = c & 3
    fwd = torch.zeros((B, n), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        cj = c[:, j : j + n]
        fwd = fwd | (cj << (2 * (k - 1 - j)))
        rc = rc | ((3 - cj) << (2 * j))
    above = (fwd ^ SIGN) > (rc ^ SIGN)  # unsigned compare
    return torch.where(above, rc, fwd), valid, above.to(torch.int32)


def extract_minimizers_torch(codes: torch.Tensor, k: int, w: int):
    """Minimizers of a [B, L] uint8 code batch (the counterpart of
    ``extract_minimizers_jax``). Returns (hash_hi, hash_lo, pos, strand,
    keep), each [B, L - k - w + 2]: per window of w k-mers the minimal
    hashed canonical k-mer (hi and lo 32 bits as int64), its k-mer index
    (int32) and strand (int32), and whether the window keeps it (a new
    position and a valid k-mer)."""
    canon, valid, strand = packed_canonical_kmers_torch(codes, k)
    h = torch.where(valid, hash64_torch(canon, 2 * k), torch.full_like(canon, BAD))
    B, n = h.shape
    nw = n - w + 1
    if nw <= 0:
        z = torch.zeros((B, 0), dtype=torch.int64, device=codes.device)
        return z, z, z.int(), z.int(), z.bool()
    # leftmost minimum of each window (argmin returns the first minimum)
    off = torch.argmin((h ^ SIGN).unfold(1, w, 1), dim=2)
    m_idx = off + torch.arange(nw, device=codes.device)[None, :]
    m_h = torch.gather(h, 1, m_idx)
    prev = torch.cat([torch.full((B, 1), -1, dtype=m_idx.dtype, device=codes.device), m_idx[:, :-1]], 1)
    keep = (m_idx != prev) & (m_h != BAD)
    return (
        _lsr(m_h, 32),
        m_h & 0xFFFFFFFF,
        m_idx.to(torch.int32),
        torch.gather(strand, 1, m_idx),
        keep,
    )
