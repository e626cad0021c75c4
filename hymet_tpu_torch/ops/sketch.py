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

Beside the engine, :func:`sketch_batch_topk` and :func:`finish_bottom_sketch`
make bottom-s sketches the JAX package's TPU way (the bench's DB build):
every window hashed by the ``kmer_hashes`` kernel, each row's candidates
picked on the device by their high limb, the sketch finished on the host.

Hashes are int64 tensors holding uint64 bit patterns, XORed with
:data:`~hymet_tpu_torch.ops.hashing.SIGN` (``keys``) wherever they are
sorted, searched or compared.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from hymet_tpu_torch.io.fasta import pack_code_batch
from hymet_tpu_torch.io.sketchdb import PAD_HASH, SketchDB
from hymet_tpu_torch.ops.hash_kernels import count_hashes, kmer_hashes, screen_count
from hymet_tpu_torch.ops.hashing import SIGN, pack64, pack_code_batch_torch
from hymet_tpu_torch.ops.sketch_kernels import sketch_codes
from hymet_tpu_torch.utils.device import resolve_device

# (packed, mask, L, k, flat, t, counts, total) -> None, as screen_count
CountFn = Callable[..., None]
# (codes, k) -> (hash, valid), as kmer_hashes
HashFn = Callable[[torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]


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

    ``track_kmers=False`` leaves the query k-mer total at 0 (as in the JAX
    engine, for benches: the p-values need it, the bench reads none).
    ``count_fn`` counts one packed batch, a test seam: callers leave the
    kernel wrapper; a check passes
    :func:`~hymet_tpu_torch.ops.hash_kernels.screen_count_torch` to
    compare the two on the card."""

    def __init__(self, db: SketchDB, device="cuda", *, track_kmers: bool = True,
                 count_fn: CountFn = screen_count):
        self.device = resolve_device(device)
        self.db = db
        self.track_kmers = track_kmers
        self.count_fn = count_fn
        self.flat, self.ref_idx = flat_index_device(db.hashes, self.device)
        self.counts = torch.zeros(self.flat.shape[0], dtype=torch.int32, device=self.device)
        self.n_hashes = torch.from_numpy(np.asarray(db.n_hashes, np.int32)).to(self.device)
        # the largest DB key, read once: query keys above it cannot match
        self._t = int(self.flat[-1]) if self.flat.numel() else None
        self.total_query_kmers = 0
        # valid windows of the batches counted so far, on the device until
        # finalize(); without track_kmers the count goes to a sink never read
        self._total = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._sink = self._total if track_kmers else torch.zeros_like(self._total)

    def update(self, q_hi, q_lo, q_valid) -> None:
        """Stream in query hashes given as the JAX engine's uint32 limbs
        (numpy arrays or tensors of any shape; `q_valid` bool), counted by
        a search of the flat keys and a scatter-add."""
        valid = q_valid if torch.is_tensor(q_valid) else torch.from_numpy(np.array(q_valid, bool))
        valid = valid.to(self.device, torch.bool).reshape(-1)
        if self._t is None:
            self._sink += valid.sum()
            return
        h = (self._limb(q_hi) << 32) | self._limb(q_lo)
        count_hashes(h, valid, self.flat, self._t, self.counts, self._sink)

    def _limb(self, x) -> torch.Tensor:
        """A 32-bit limb as int64 values 0 .. 2^32 - 1, flat."""
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(np.int64))
        return (x.to(self.device).to(torch.int64) & 0xFFFFFFFF).reshape(-1)

    def update_codes(self, codes: torch.Tensor) -> None:
        """Stream in a [B, L] uint8 code batch on the engine's device:
        packed there (:func:`~hymet_tpu_torch.ops.hashing.pack_code_batch_torch`)
        and counted like a staged batch."""
        if self._t is None:
            if self.track_kmers:
                self._count_kmers_host(codes.cpu().numpy())
            return
        packed, mask, L = pack_code_batch_torch(codes)
        self.update_staged(packed, mask, L)

    def update_codes_packed(self, codes: np.ndarray) -> None:
        """Stream in a host [B, L] uint8 batch, shipped 2-bit packed with
        validity bits and unpacked on the device."""
        if self._t is None:
            if self.track_kmers:
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
        self.count_fn(packed, mask, L, self.db.k, self.flat, self._t, self.counts, self._sink)

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


def sketch_batch_topk(
    codes: torch.Tensor, k: int, cand: int, *, hash_fn: HashFn = kmer_hashes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bottom-`cand` sketch candidates of each row of a [B, L] uint8 code
    batch (counterpart of ``hymet_tpu.ops.sketch.sketch_batch_topk``):
    (cand_hi, cand_lo) int64 [B, min(cand, L-k+1)] holding uint32 limbs,
    the windows in ascending order of their hash's high limb, an invalid
    window's limbs both 0xFFFFFFFF. Equal high limbs keep window order, as
    ``jax.lax.top_k`` keeps the lower index first (an invalid window and a
    valid one whose high limb is 0xFFFFFFFF tie on purpose).

    The window hashes come from `hash_fn`, the
    :func:`~hymet_tpu_torch.ops.hash_kernels.kmer_hashes` kernel by
    default (its plain version for a CPU batch); the selection is a stable
    sort. :func:`finish_bottom_sketch` turns the candidates into the
    bottom-s distinct sketch on the host."""
    h, valid = hash_fn(codes, k)
    pad = 0xFFFFFFFF
    key = torch.where(valid, (h >> 32) & pad, pad)
    lo = torch.where(valid, h & pad, pad)
    idx = torch.sort(key, dim=1, stable=True).indices[:, : min(cand, key.shape[1])]
    return torch.gather(key, 1, idx), torch.gather(lo, 1, idx)


def finish_bottom_sketch(
    cand_hi: np.ndarray, cand_lo: np.ndarray, s: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host finish for :func:`sketch_batch_topk` (copy of the JAX
    package's): per row, pack to uint64, de-duplicate, keep the s
    smallest. Returns ([B, s] uint64 PAD_HASH-padded, [B] int32 counts).

    Warns (RuntimeWarning) on the rows whose candidates may miss a hash of
    the true bottom s: a full pool with fewer than s distinct hashes (a
    repeated low-hash k-mer crowding it), or a full pool whose s-th hash
    shares its high limb with the pool's last (the selection ordered by
    that limb alone, so an excluded hash with a smaller low limb could
    displace it)."""
    B = cand_hi.shape[0]
    out = np.full((B, s), PAD_HASH, dtype=np.uint64)
    n_out = np.zeros(B, dtype=np.int32)
    saturated = np.zeros(B, dtype=bool)
    h64 = pack64(np.asarray(cand_hi), np.asarray(cand_lo))
    for i in range(B):
        uniq = np.unique(h64[i])
        uniq = uniq[uniq != PAD_HASH]
        n = min(len(uniq), s)
        out[i, :n] = uniq[:n]
        n_out[i] = n
        pool_full = bool((h64[i] != PAD_HASH).all())
        cutoff_tie = (
            n >= s
            and pool_full
            and (out[i, n - 1] >> np.uint64(32)) == (h64[i].max() >> np.uint64(32))
        )
        saturated[i] = (n < s and pool_full) or cutoff_tie
    if saturated.any():
        warnings.warn(
            f"sketch_batch_topk candidate pool saturated for rows "
            f"{np.flatnonzero(saturated).tolist()}; rerun those rows with "
            "the exact sort path or a larger cand",
            RuntimeWarning,
            stacklevel=2,
        )
    return out, n_out
