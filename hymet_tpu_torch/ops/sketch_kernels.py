"""Bottom-s distinct sketch: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

Counterpart of the selection in ``hymet_tpu/ops/sketch.py::sketch_batch``
(:919; B10) and of the host build's ``bottom_sketch_from_hashes``
(``hymet_tpu/io/sketchdb.py:178``): for each segment of a [B, n] batch of
window hashes (a row, or a run of consecutive rows pooled), the s
smallest *distinct* valid hashes in uint64 order, ``PAD_HASH`` padded, and
their count ``min(#distinct, s)``. torch has no "s smallest distinct"
primitive short of sorting every window, so the card runs
``csrc/bottom_sketch.cu`` (tiles sorted in shared memory, then sorted
candidate lists merged pairwise in rounds).

A real hash equal to ``PAD_HASH`` counts like any other, as ``np.unique``
counts it in the host build; the JAX ``sketch_batch`` takes it for
padding and drops it (2^-64 a window).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hymet_tpu_torch.ops.hash_kernels import _check_device, _launch
from hymet_tpu_torch.ops.hashing import SIGN

TILE = 4096  # windows a block of csrc/bottom_sketch.cu sorts (kTile)


def _segment_rows(B: int, segments: Optional[Sequence[int]]) -> np.ndarray:
    """Rows of each segment (all 1 when `segments` is None), checked."""
    rows = np.ones(B, np.int64) if segments is None else np.asarray(segments, np.int64)
    if rows.ndim != 1 or (rows < 1).any() or int(rows.sum()) != B:
        raise ValueError(f"bottom_sketch: segments must be positive row counts summing to "
                         f"B={B}, got {list(rows)}")
    return rows


def bottom_sketch_torch(
    hash_: torch.Tensor, valid: torch.Tensor, s: int, segments: Optional[Sequence[int]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bottom_sketch`: ``torch.unique`` of each
    segment's valid keys (``hash ^ SIGN``, sorted), the first s, back to
    hashes. Runs on whatever device the tensors lie on."""
    B = hash_.shape[0]
    rows = _segment_rows(B, segments)
    out = torch.full((len(rows), s), -1, dtype=torch.int64, device=hash_.device)
    count = torch.zeros(len(rows), dtype=torch.int32, device=hash_.device)
    start = 0
    for g, r in enumerate(rows.tolist()):
        keys = torch.unique(hash_[start : start + r][valid[start : start + r]] ^ SIGN, sorted=True)
        m = min(int(keys.numel()), s)
        out[g, :m] = keys[:m] ^ SIGN
        count[g] = m
        start += r
    return out, count


def bottom_sketch(
    hash_: torch.Tensor, valid: torch.Tensor, s: int, segments: Optional[Sequence[int]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """hash int64 [B, n] (uint64 bit patterns) and valid bool [B, n] ->
    (sketch int64 [G, s], count int32 [G]): per segment (``segments[g]``
    consecutive rows; one row each when None) its s smallest distinct
    valid hashes in uint64 order, -1 (``PAD_HASH``) past the count.

    A CUDA batch goes to the hand-written kernel (counted in
    ``bottom_sketch.launches``, one a call: a tile pass, the merge rounds
    and the write-out on one stream); a CPU batch to
    :func:`bottom_sketch_torch`."""
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
    if not 1 <= s < 2**31:
        raise ValueError(f"bottom_sketch: s must be in 1..2^31-1, got {s}")
    rows = _segment_rows(B, segments)
    dev = hash_.device
    G = len(rows)
    out = torch.empty((G, s), dtype=torch.int64, device=dev)
    count = torch.empty(G, dtype=torch.int32, device=dev)
    if n == 0:  # no window: every segment is empty
        out.fill_(-1)
        count.zero_()
        return out, count
    tpr = -(-n // TILE)
    c0 = min(s, TILE)
    leaves = B * tpr
    if leaves >= 2**31:
        raise ValueError(f"bottom_sketch: {leaves} tiles exceed the kernel's indices; "
                         f"cut the batch")
    first_row = np.concatenate([[0], np.cumsum(rows)])
    lstart = torch.from_numpy((first_row * tpr).astype(np.int32)).to(dev)
    row_group = torch.from_numpy(np.repeat(np.arange(G, dtype=np.int32), rows)).to(dev)
    rounds = (int(rows.max()) * tpr - 1).bit_length()  # ceil(log2(a segment's most leaves))
    buf0 = torch.empty(leaves * c0, dtype=torch.int64, device=dev)
    buf1 = torch.empty_like(buf0) if rounds else buf0
    cnt0 = torch.empty(leaves, dtype=torch.int32, device=dev)
    cnt1 = torch.empty_like(cnt0) if rounds else cnt0
    drops = torch.empty(leaves * c0 if rounds else 1, dtype=torch.int32, device=dev)
    _launch("bottom_sketch", dev, hash_.data_ptr(), valid.data_ptr(), B, n,
            row_group.data_ptr(), lstart.data_ptr(), G, tpr, c0, s, rounds, buf0.data_ptr(),
            buf1.data_ptr(), cnt0.data_ptr(), cnt1.data_ptr(), drops.data_ptr(),
            out.data_ptr(), count.data_ptr())
    bottom_sketch.launches += 1
    return out, count


bottom_sketch.launches = 0
