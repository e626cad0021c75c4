"""Bottom-s distinct sketch: the hand-written CUDA kernel, its two wrappers
and their plain PyTorch versions.

Counterpart of ``hymet_tpu/ops/sketch.py::sketch_batch`` (:919; B10) and
of the host build's ``bottom_sketch_from_hashes``
(``hymet_tpu/io/sketchdb.py:178``): for each segment of a batch of k-mer
windows (a row, or a run of consecutive rows pooled), the s smallest
*distinct* valid hashes in uint64 order, ``PAD_HASH`` padded, and their
count ``min(#distinct, s)``.

- :func:`sketch_codes` takes code rows and hashes their windows inside
  the kernel (the DB build's path: no hash reaches device memory);
- :func:`bottom_sketch` takes window hashes and valid flags (the fold of
  a long genome's pieces).

torch has no "s smallest distinct" primitive short of sorting every
window, so the card runs ``csrc/bottom_sketch.cu``: a block a chunk of
65,536 windows of a row keeps only the windows at or below its running
s-th key, sorts those and merges them into its list; one block a segment
folds the chunks' lists.

A real hash equal to ``PAD_HASH`` counts like any other, as ``np.unique``
counts it in the host build; the JAX ``sketch_batch`` takes it for
padding and drops it (2^-64 a window).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hymet_tpu_torch.ops.hash_kernels import _check_device, _launch, _vec
from hymet_tpu_torch.ops.hashing import SIGN, kmer_hashes_torch

CHUNK = 16 * 4096  # windows a chunk block of csrc/bottom_sketch.cu owns (kChunk)
SHARED_CAP = 4096  # the longest list a block keeps in shared memory (kSharedCap)
MAX_KEY = 2**63 - 1  # the largest key (PAD_HASH ^ SIGN): no bound yet


def _segment_rows(B: int, segments: Optional[Sequence[int]]) -> np.ndarray:
    """Rows of each segment (all 1 when `segments` is None), checked."""
    rows = np.ones(B, np.int64) if segments is None else np.asarray(segments, np.int64)
    if rows.ndim != 1 or (rows < 1).any() or int(rows.sum()) != B:
        raise ValueError(f"bottom_sketch: segments must be positive row counts summing to "
                         f"B={B}, got {list(rows)}")
    return rows


def _empty(G: int, s: int, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((G, s), -1, dtype=torch.int64, device=dev),
            torch.zeros(G, dtype=torch.int32, device=dev))


def bottom_sketch_torch(
    hash_: torch.Tensor, valid: torch.Tensor, s: int, segments: Optional[Sequence[int]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bottom_sketch`: ``torch.unique`` of each
    segment's valid keys (``hash ^ SIGN``, sorted), the first s, back to
    hashes. Runs on whatever device the tensors lie on."""
    B = hash_.shape[0]
    rows = _segment_rows(B, segments)
    out, count = _empty(len(rows), s, hash_.device)
    start = 0
    for g, r in enumerate(rows.tolist()):
        keys = torch.unique(hash_[start : start + r][valid[start : start + r]] ^ SIGN, sorted=True)
        m = min(int(keys.numel()), s)
        out[g, :m] = keys[:m] ^ SIGN
        count[g] = m
        start += r
    return out, count


def sketch_codes_torch(codes: torch.Tensor, k: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`sketch_codes`: every window's hash
    (:func:`~hymet_tpu_torch.ops.hashing.kmer_hashes_torch`), then
    :func:`bottom_sketch_torch` of each row. A row shorter than k has no
    window: count 0. Runs on whatever device `codes` lies on."""
    B, L = codes.shape
    if L < k:
        return _empty(B, s, codes.device)
    h, valid = kmer_hashes_torch(codes, k)
    return bottom_sketch_torch(h, valid, s)


def _lists(B: int, n: int, s: int, G: int, seg_windows: int, dev: torch.device) -> tuple:
    """Chunks a row, the two list rooms and the kernel's buffers: chunk
    lists and counts, each segment's bound (``MAX_KEY``: none yet), and
    scratch for the lists that do not fit in shared memory."""
    cpr = -(-n // CHUNK)
    if cpr > 65535:  # the grid's second dimension
        raise ValueError(f"bottom_sketch: {n} windows a row exceed the kernel's grid; "
                         f"cut the rows")
    cap0, cap = min(s, CHUNK), min(s, seg_windows)
    chunks = B * cpr
    lists = torch.empty(chunks * cap0, dtype=torch.int64, device=dev)
    counts = torch.empty(chunks, dtype=torch.int32, device=dev)
    seg_tau = torch.full((G,), MAX_KEY, dtype=torch.int64, device=dev)
    work = max(chunks * cap0 if cap0 > SHARED_CAP else 0, G * cap if cap > SHARED_CAP else 0)
    work = torch.empty(max(work, 1), dtype=torch.int64, device=dev)
    return cpr, cap0, cap, lists, counts, seg_tau, work


def _check_s(name: str, s: int) -> None:
    if not 1 <= s < 2**31:
        raise ValueError(f"{name}: s must be in 1..2^31-1, got {s}")


def bottom_sketch(
    hash_: torch.Tensor, valid: torch.Tensor, s: int, segments: Optional[Sequence[int]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """hash int64 [B, n] (uint64 bit patterns) and valid bool [B, n] ->
    (sketch int64 [G, s], count int32 [G]): per segment (``segments[g]``
    consecutive rows; one row each when None) its s smallest distinct
    valid hashes in uint64 order, -1 (``PAD_HASH``) past the count.

    A CUDA batch goes to the hand-written kernel (counted in
    ``bottom_sketch.launches``, one a call: the chunk pass and the fold on
    one stream); a CPU batch to :func:`bottom_sketch_torch`."""
    if _check_device("bottom_sketch", hash_, valid) == "cpu":
        return bottom_sketch_torch(hash_, valid, s, segments)
    if hash_.dtype != torch.int64 or valid.dtype != torch.bool or hash_.dim() != 2 \
            or valid.shape != hash_.shape:
        raise ValueError(f"bottom_sketch: need int64 hash and bool valid of one [B, n] shape, "
                         f"got {hash_.dtype} {tuple(hash_.shape)}, {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if not (hash_.is_contiguous() and valid.is_contiguous()):
        raise ValueError("bottom_sketch: hash and valid must be contiguous")
    B, n = hash_.shape
    if not 1 <= B <= 65535:
        raise ValueError(f"bottom_sketch: B must be in 1..65535, got {B}")
    _check_s("bottom_sketch", s)
    rows = _segment_rows(B, segments)
    dev = hash_.device
    G = len(rows)
    if n == 0:  # no window: every segment is empty
        return _empty(G, s, dev)
    cpr, cap0, cap, lists, counts, seg_tau, work = _lists(B, n, s, G, int(rows.max()) * n, dev)
    first_row = torch.from_numpy(np.concatenate([[0], np.cumsum(rows)]).astype(np.int32)).to(dev)
    row_group = torch.from_numpy(np.repeat(np.arange(G, dtype=np.int32), rows)).to(dev)
    out = torch.empty((G, s), dtype=torch.int64, device=dev)
    count = torch.empty(G, dtype=torch.int32, device=dev)
    _launch("bottom_sketch", dev, hash_.data_ptr(), valid.data_ptr(), B, n,
            row_group.data_ptr(), first_row.data_ptr(), G, s, cpr, cap0, cap, lists.data_ptr(),
            counts.data_ptr(), seg_tau.data_ptr(), work.data_ptr(), out.data_ptr(),
            count.data_ptr())
    bottom_sketch.launches += 1
    return out, count


bottom_sketch.launches = 0


def sketch_codes(codes: torch.Tensor, k: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """codes uint8 [B, L] (0-3 = ACGT, >= 4 invalid) -> (sketch int64 [B, s],
    count int32 [B]): each row's s smallest distinct valid canonical k-mer
    hashes (MurmurHash3_x64_128 h1, seed 42, as Mash hashes them) in uint64
    order, -1 (``PAD_HASH``) past the count. The same function as
    :func:`~hymet_tpu_torch.ops.hash_kernels.kmer_hashes` followed by
    :func:`bottom_sketch`; a row shorter than k has count 0.

    A CUDA batch goes to the hand-written kernel, which hashes each window
    in registers (counted in ``sketch_codes.launches``, one a call); a CPU
    batch to :func:`sketch_codes_torch`."""
    if _check_device("sketch_codes", codes) == "cpu":
        return sketch_codes_torch(codes, k, s)
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"sketch_codes: need a [B, L] uint8 tensor, got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if not codes.is_contiguous():
        raise ValueError("sketch_codes: codes must be contiguous")
    if not 1 <= k <= 32:
        raise ValueError(f"sketch_codes: k must be in 1..32, got {k}")
    _check_s("sketch_codes", s)
    B, L = codes.shape
    if not 1 <= B <= 65535:
        raise ValueError(f"sketch_codes: B must be in 1..65535, got {B}")
    if L >= 2**31:
        raise ValueError(f"sketch_codes: L must be below 2^31, got {L}")
    dev = codes.device
    if L < k:  # no window
        return _empty(B, s, dev)
    n = L - k + 1
    cpr, cap0, cap, lists, counts, seg_tau, work = _lists(B, n, s, B, n, dev)
    out = torch.empty((B, s), dtype=torch.int64, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    _launch("sketch_codes", dev, codes.data_ptr(), B, L, k, _vec(codes, width=L), s, cpr, cap0,
            cap, lists.data_ptr(), counts.data_ptr(), seg_tau.data_ptr(), work.data_ptr(),
            out.data_ptr(), count.data_ptr())
    sketch_codes.launches += 1
    return out, count


sketch_codes.launches = 0
