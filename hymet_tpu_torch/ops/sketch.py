"""MinHash containment screen on the device (counterpart of hymet_tpu.ops.sketch,
single-device path).

1. Engine set-up: the union of all reference sketch hashes is
   de-duplicated and sorted into a flat array [F] on the device, with a
   per-reference index matrix [R, s] into it (:func:`flat_index_device`).
2. Streaming: each 2-bit packed batch of query codes is counted in one
   step (:func:`~hymet_tpu_torch.ops.hash_kernels.screen_count`, the
   hand-written kernel on the card): every valid window is hashed, hashes
   above the largest DB hash are dropped (bottom-s sketches hold only
   small hashes), the survivors are looked up in the flat array and each
   hit adds 1 to its count.
3. Scores: per reference, shared = #sketch hashes with count > 0;
   identity = 1 + ln(2c/(1+c))/k with c = shared/n_hashes (Mash's
   containment estimate); median = upper median of the shared hashes'
   counts.

Hashes are int64 tensors holding uint64 bit patterns, XORed with
:data:`~hymet_tpu_torch.ops.hashing.SIGN` (``keys``) wherever they are
sorted, searched or compared.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from hymet_tpu_torch.io.fasta import pack_code_batch
from hymet_tpu_torch.io.sketchdb import SketchDB
from hymet_tpu_torch.ops.hash_kernels import screen_count
from hymet_tpu_torch.ops.hashing import SIGN
from hymet_tpu_torch.ops.sketch_kernels import sketch_codes
from hymet_tpu_torch.utils.device import resolve_device

# (packed, mask, L, k, flat, t, counts, total) -> None, as screen_count
CountFn = Callable[..., None]


def flat_index_device(
    hashes: np.ndarray, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, s] uint64 sketch rows (PAD_HASH padded) -> (flat keys [F] int64,
    sorted unique and sign-flipped; ref_idx [R, s] int32 into them, -1 at
    pads). The same tables as :meth:`SketchDB.flat_index`, built on `device`."""
    h = torch.from_numpy(np.ascontiguousarray(hashes).view(np.int64)).to(device)
    real = h != -1  # PAD_HASH's bit pattern
    flat, inv = torch.unique(h[real] ^ SIGN, sorted=True, return_inverse=True)
    ref_idx = torch.full(h.shape, -1, dtype=torch.int32, device=device)
    ref_idx[real] = inv.to(torch.int32)
    return flat, ref_idx


# The JAX package's identity is float32 as XLA's CPU backend computes it:
# log is a Cephes polynomial whose fmul/fadd pairs are contracted to FMAs,
# and "1 + log(x) / k" becomes fma(log(x), float32(1/k), 1). The port
# evaluates the same steps to stay bit-identical. An FMA is taken in
# float64: the product of two float32 values is exact there, and the one
# rounding of the sum to float32 matched the FMA's on every input
# screen_scores can see (all 501,500 pairs shared <= n_hashes <= 1000,
# checked against the JAX package at k = 15, 21 and 32; the tests keep a
# sample of them).
_LOG_P = [
    float(np.float32(p))
    for p in (
        7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
        1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
        3.3333331174e-1,
    )
]
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_SQRTHF = float(np.float32(0.707106781186547524))
_MIN_NORM = float(np.float32(1.17549435e-38))


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    return (a.double() * (b.double() if torch.is_tensor(b) else b)
            + (c.double() if torch.is_tensor(c) else c)).float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 values, step for step as XLA's CPU
    backend evaluates it (see the note above)."""
    x = torch.clamp(x, min=_MIN_NORM)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # 0x807FFFFF
    small = m < _SQRTHF
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma32(_fma32(m, p[0], p[1]), m, p[2])
    y1 = _fma32(_fma32(m, p[3], p[4]), m, p[5])
    y2 = _fma32(_fma32(m, p[6], p[7]), m, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, e * _LOG_Q1)
    return ((m - x2 * 0.5) + y) + e * _LOG_Q2


def screen_scores(
    counts: torch.Tensor,  # [F] int32
    ref_idx: torch.Tensor,  # [R, s] int32 into counts (-1 pad)
    n_hashes: torch.Tensor,  # [R] int32
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-reference (identity float32, shared int32, median int32)."""
    valid = ref_idx >= 0
    if counts.numel():
        cnt = torch.where(valid, counts[torch.where(valid, ref_idx, 0).long()], 0)
    else:
        cnt = torch.zeros_like(ref_idx)
    hit = cnt > 0
    shared = hit.sum(dim=1, dtype=torch.int32)

    c = shared.float() / n_hashes.clamp(min=1).float()
    inv_k = float(np.float32(1.0) / np.float32(k))
    identity = torch.where(
        c > 0, _fma32(log_f32(2.0 * c / (1.0 + c)), inv_k, 1.0), torch.zeros_like(c)
    )
    identity = identity.clamp(min=0.0)

    # upper median of the shared hashes' multiplicities: sort with the
    # non-shared pushed to +inf, take the element at index shared//2
    ordered = torch.sort(torch.where(hit, cnt, 2**30), dim=1).values
    mid = (shared // 2).clamp(0, ref_idx.shape[1] - 1).long()
    median = torch.gather(ordered, 1, mid[:, None])[:, 0]
    median = torch.where(shared > 0, median, 0).to(torch.int32)
    return identity, shared, median


def binom_sf(x: int, n: int, p: float) -> float:
    """P(X >= x) for X ~ Binomial(n, p); exact log-space sum."""
    if x <= 0:
        return 1.0
    if p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0
    lp = math.log(p)
    lq = math.log1p(-p)
    total = -math.inf
    lgn = math.lgamma(n + 1)
    for i in range(x, n + 1):
        lt = lgn - math.lgamma(i + 1) - math.lgamma(n - i + 1) + i * lp + (n - i) * lq
        total = lt if total == -math.inf else max(total, lt) + math.log1p(
            math.exp(min(total, lt) - max(total, lt))
        )
    return min(1.0, math.exp(total))


def count_valid_windows(codes, k: int) -> int:
    """Windows of k valid bases (codes < 4) in a host [B, L] code batch."""
    arr = np.asarray(codes)
    inv = (arr >= 4).astype(np.int32)
    csum = np.concatenate(
        [np.zeros((arr.shape[0], 1), np.int32), np.cumsum(inv, axis=1)], axis=1
    )
    return int(((csum[:, k:] - csum[:, :-k]) == 0).sum())


class ScreenEngine:
    """Streaming mash-screen over one SketchDB on one device. Feed query
    code batches; :meth:`finalize` gives per-reference rows.

    ``count_fn`` counts one packed batch, a test seam: callers leave the
    kernel wrapper; a check passes
    :func:`~hymet_tpu_torch.ops.hash_kernels.screen_count_torch` to
    compare the two on the card."""

    def __init__(self, db: SketchDB, device="cuda", *, count_fn: CountFn = screen_count):
        self.device = resolve_device(device)
        self.db = db
        self.count_fn = count_fn
        self.flat, self.ref_idx = flat_index_device(db.hashes, self.device)
        self.counts = torch.zeros(self.flat.shape[0], dtype=torch.int32, device=self.device)
        self.n_hashes = torch.from_numpy(np.asarray(db.n_hashes, np.int32)).to(self.device)
        # the largest DB key, read once: query keys above it cannot match
        self._t = int(self.flat[-1]) if self.flat.numel() else None
        self.total_query_kmers = 0
        # valid windows of the batches counted so far, on the device until
        # finalize()
        self._total = torch.zeros(1, dtype=torch.int64, device=self.device)

    def update_codes_packed(self, codes: np.ndarray) -> None:
        """Stream in a host [B, L] uint8 batch, shipped 2-bit packed with
        validity bits and unpacked on the device."""
        if self._t is None:
            self._count_kmers_host(codes)
            return
        packed, mask, L = pack_code_batch(np.asarray(codes))
        self.update_staged(
            torch.from_numpy(packed).to(self.device),
            torch.from_numpy(mask).to(self.device),
            L,
        )

    def update_staged(self, packed: torch.Tensor, mask: torch.Tensor, L: int) -> None:
        """Stream in a packed batch already on the device (upload-once
        staging, pipeline/staged.py)."""
        if self._t is None:
            raise ValueError("staged screen updates need a non-empty DB")
        self.count_fn(packed, mask, L, self.db.k, self.flat, self._t, self.counts, self._total)

    def _count_kmers_host(self, codes) -> None:
        """Exact valid-window count (empty-DB path only)."""
        self.total_query_kmers += count_valid_windows(codes, self.db.k)

    def finalize(self) -> "ScreenResult":
        identity, shared, median = screen_scores(
            self.counts, self.ref_idx, self.n_hashes, self.db.k
        )
        self.total_query_kmers += int(self._total)
        self._total.zero_()
        return ScreenResult(
            db=self.db,
            identity=identity.cpu().numpy(),
            shared=shared.cpu().numpy(),
            median=median.cpu().numpy(),
            total_query_kmers=self.total_query_kmers,
        )


class ScreenResult:
    def __init__(self, db, identity, shared, median, total_query_kmers):
        self.db = db
        self.identity = identity
        self.shared = shared
        self.median = median
        self.total_query_kmers = total_query_kmers
        self._pvalues: Optional[np.ndarray] = None

    def slice(self, offset: int, db: SketchDB) -> "ScreenResult":
        """Per-DB view of a merged-DB screen (see ``SketchDB.concat``):
        scores are per reference, and the p-value depends only on the query
        k-mer count and that reference's sketch size, so the slice equals
        screening `db` alone."""
        n = db.n_refs
        return ScreenResult(
            db=db,
            identity=self.identity[offset : offset + n],
            shared=self.shared[offset : offset + n],
            median=self.median[offset : offset + n],
            total_query_kmers=self.total_query_kmers,
        )

    def pvalues(self) -> np.ndarray:
        """Mash-style null-model p-values per reference: the probability of
        >= shared sketch hashes in a random query k-mer set of this size."""
        if self._pvalues is not None:
            return self._pvalues
        kmer_space = float(4 ** self.db.k)
        r_null = 1.0 / (1.0 + kmer_space / max(self.total_query_kmers, 1))
        out = np.ones(self.db.n_refs)
        for i in range(self.db.n_refs):
            out[i] = binom_sf(int(self.shared[i]), int(self.db.n_hashes[i]), r_null)
        self._pvalues = out
        return out

    def rows(self) -> list:
        """mash-screen rows: (identity, shared/total, median, pvalue,
        ref_id, comment), the 6 columns of screen.tab."""
        pv = self.pvalues()
        out = []
        for i in range(self.db.n_refs):
            out.append(
                (
                    float(self.identity[i]),
                    f"{int(self.shared[i])}/{int(self.db.n_hashes[i])}",
                    int(self.median[i]),
                    pv[i],
                    self.db.names[i],
                    self.db.comments[i] if self.db.comments else "",
                )
            )
        return out


def sketch_batch(codes: torch.Tensor, k: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bottom-s distinct-hash sketch per row of a [B, L] uint8 code batch
    (counterpart of ``hymet_tpu.ops.sketch.sketch_batch``): (hashes int64
    [B, s], uint64 bit patterns ascending in uint64 order, -1 past the
    count; n int32 [B]). Through
    :func:`~hymet_tpu_torch.ops.sketch_kernels.sketch_codes`, the
    hand-written kernel for a CUDA batch.

    The JAX function returns (hi, lo) uint32 limbs and, past n, duplicate
    hashes before any padding; the two agree on ``[:n]`` and n. A row
    shorter than k has no window: n = 0."""
    return sketch_codes(codes, k, s)
