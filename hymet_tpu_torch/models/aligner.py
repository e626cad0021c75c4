"""Host helpers of hymet_tpu's minimizer aligner that the upload-once
staging shares: query padding, grouping and batch building (same rules
and defaults; the aligner's device path is not ported yet)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from hymet_tpu_torch.io.fasta import encode_seq


def pad_query_len(length: int, quantum: int) -> int:
    """Padded query-row length: linear `quantum` buckets up to 2 quanta,
    then powers of two with their 3*2^k midpoints (<= 1.33x padding)."""
    pad = -(-max(length, 1) // quantum) * quantum
    if pad > 2 * quantum:
        p2 = 1 << int(np.ceil(np.log2(pad)))
        mid = 3 * p2 // 4
        return mid if pad <= mid else p2
    return pad


def plan_query_groups(
    lengths: Sequence[int], batch_pad: int, min_len: int
) -> Tuple[List[List[int]], bool]:
    """Group queries into equal-padded batches of <= 64 rows, ascending by
    length; returns (groups of query indices, fixed_rows)."""
    fixed_rows = len(lengths) >= 64
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_pad = None
    for i in order:
        pad = pad_query_len(max(lengths[i], min_len), batch_pad)
        if cur_pad is None or pad == cur_pad and len(cur) < 64:
            cur.append(i)
            cur_pad = pad
        else:
            groups.append(cur)
            cur = [i]
            cur_pad = pad
    if cur:
        groups.append(cur)
    return groups, fixed_rows


def group_rows(n: int, fixed_rows: bool) -> int:
    """Padded row count for an n-query group: the next power of two; on
    large runs (fixed_rows) at least 16 and at most 64."""
    p2 = 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))
    return min(64, max(16, p2)) if fixed_rows else p2


def build_group_batch(
    seqs: Sequence[bytes],
    group: Sequence[int],
    batch_pad: int,
    min_len: int,
    fixed_rows: bool,
) -> np.ndarray:
    """[rows, pad] uint8 code batch for one query group (pad code 4)."""
    pad = pad_query_len(max(max(len(seqs[i]) for i in group), min_len), batch_pad)
    batch = np.full((group_rows(len(group), fixed_rows), pad), 4, dtype=np.uint8)
    for row, i in enumerate(group):
        codes = encode_seq(seqs[i])
        batch[row, : codes.shape[0]] = codes
    return batch
