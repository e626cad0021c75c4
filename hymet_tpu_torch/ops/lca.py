"""Weighted rank-consensus LCA: the hand-written CUDA kernel, its plain
PyTorch version, the host oracle and the bucketing.

Counterpart of ``hymet_tpu/ops/lca.py``. For each query and each of the 8
ranks, from the top:

  - sum the hit weights per taxon *name* at that rank,
  - pick the name of the largest sum (ties: the lowest hit index, as
    ``jnp.argmax`` and Python's dict-insertion-order ``max``),
  - rank confidence = best sum / total named weight at that rank,
  - stop at the first rank with no named weight,
  - final confidence = product of rank confidences, clamped to 1.0.

The JAX package computes the per-name sums as a [Q, H, H] equality einsum
and the named total as a ``jnp.sum``; XLA-CPU adds them in orders of its
own, and torch's einsum and cuBLAS add in others. So the port writes the
orders out (ROADMAP C2), in float64, in the kernel
(``csrc/lca.cu``) and in :func:`weighted_lca_torch` alike:

  - per-name sum ``wsum[q, i]``: four accumulators; hit j, in increasing
    j, goes into accumulator ``j % 4`` where ``names[j] == names[i] != 0``;
    then ``(a0 + a2) + (a1 + a3)``;
  - named total: the hits in chunks of 1024; in a chunk, each block of 32
    hits folded in order, then the block sums folded in order; then the
    chunk sums folded in order.

Weights are non-negative (coverage times a count), so a term that is not
added (a hit of another name, a padding slot) is an added +0.0 and
changes no bit.

:func:`weighted_lca_host` is the reference-exact oracle (left-fold sums in
dict-insertion order) behind the ``host`` backend.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hymet_tpu_torch import RANKS
from hymet_tpu_torch.ops.hash_kernels import _check_device, _launch

NUM_RANKS = len(RANKS)
SUM_LANES = 4  # the per-name sums' strided accumulators
DENOM_BLOCK = 32  # the named total's blocks
DENOM_CHUNK = 1024  # and chunks


def _fold(x: torch.Tensor, width: int) -> torch.Tensor:
    """[Q, n] -> [Q, ceil(n / width)]: each run of `width` columns folded
    left to right (zero padding, an exact +0.0, fills the last run)."""
    Q, n = x.shape
    m = -(-n // width)
    x = torch.nn.functional.pad(x, (0, m * width - n)).reshape(Q, m, width)
    acc = x[:, :, 0]
    for t in range(1, width):
        acc = acc + x[:, :, t]
    return acc


def named_total_torch(wn: torch.Tensor) -> torch.Tensor:
    """[Q, H] float64 -> [Q]: the named weight in the blocked order."""
    blocks = _fold(wn, DENOM_BLOCK)
    chunks = _fold(blocks, DENOM_CHUNK // DENOM_BLOCK)
    return _fold(chunks, chunks.shape[1])[:, 0]


def name_sums_torch(names: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
    """[Q, H] names (0 = none), [Q, H] weights -> [Q, H] float64: for each
    hit i, the weight of the hits sharing its name, in the strided order
    (-inf where hit i has no name)."""
    Q, H = names.shape
    n4 = -(-H // SUM_LANES) * SUM_LANES
    pn = torch.nn.functional.pad(names, (0, n4 - H))  # padding: no name
    pw = torch.nn.functional.pad(wn, (0, n4 - H))
    acc = torch.zeros((Q, H, SUM_LANES), dtype=torch.float64, device=names.device)
    for j in range(0, n4, SUM_LANES):
        nj = pn[:, None, j : j + SUM_LANES]  # [Q, 1, 4]
        eq = (names[:, :, None] == nj) & (nj != 0)
        acc = acc + torch.where(eq, pw[:, None, j : j + SUM_LANES], 0.0)
    wsum = (acc[:, :, 0] + acc[:, :, 2]) + (acc[:, :, 1] + acc[:, :, 3])
    return torch.where(names != 0, wsum, -torch.inf)


def weighted_lca_torch(
    hit_rows: torch.Tensor, hit_weights: torch.Tensor, rank_table: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`weighted_lca`, the same orders in torch ops,
    on whatever device the tensors lie."""
    Q, H = hit_rows.shape
    dev = hit_rows.device
    w = hit_weights.to(torch.float64)
    valid = hit_rows >= 0
    rows = torch.where(valid, hit_rows, 0).long()
    active = torch.ones(Q, dtype=torch.bool, device=dev)
    conf = torch.ones(Q, dtype=torch.float64, device=dev)
    chosen = torch.zeros((Q, NUM_RANKS), dtype=torch.int32, device=dev)
    n_chosen = torch.zeros(Q, dtype=torch.int32, device=dev)
    q_iota = torch.arange(Q, device=dev)
    for r in range(NUM_RANKS):
        names = torch.where(valid, rank_table[rows, r], 0)
        named = names != 0
        wn = torch.where(named, w, 0.0)
        denom = named_total_torch(wn)
        wsum = name_sums_torch(names, wn)
        best = torch.argmax(wsum, dim=1)  # the first maximum
        has = denom > 0
        conf_r = torch.where(has, wsum[q_iota, best] / torch.where(has, denom, 1.0), 1.0)
        active = active & has
        chosen[:, r] = torch.where(active, names[q_iota, best], 0)
        conf = torch.where(active, conf * conf_r, conf)
        n_chosen += active.to(torch.int32)
    confidence = torch.where(n_chosen > 0, torch.minimum(conf, torch.ones_like(conf)), 0.0)
    return chosen, n_chosen, confidence


def weighted_lca(
    hit_rows: torch.Tensor,  # [Q, H] int32: row in rank_table per hit (-1 = pad)
    hit_weights: torch.Tensor,  # [Q, H] float64: coverage * ref abundance, >= 0
    rank_table: torch.Tensor,  # [T, NUM_RANKS] int32 name ids (0 = no name)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched weighted LCA (``hymet_tpu.ops.lca.weighted_lca`` at float64).

    Returns chosen names int32 [Q, NUM_RANKS] (0 beyond the consensus
    depth), n_chosen int32 [Q] (0 => Unknown/root) and confidence float64
    [Q] (the product of per-rank confidences clamped to 1.0; 0.0 where
    nothing was chosen).

    CUDA tensors go to the hand-written kernel (``csrc/lca.cu``, all 8
    ranks in one launch, counted in ``weighted_lca.launches``); CPU tensors
    go to :func:`weighted_lca_torch`."""
    if _check_device("weighted_lca", hit_rows, hit_weights, rank_table) == "cpu":
        return weighted_lca_torch(hit_rows, hit_weights, rank_table)
    for name, x, dtype in (("hit_rows", hit_rows, torch.int32),
                           ("hit_weights", hit_weights, torch.float64),
                           ("rank_table", rank_table, torch.int32)):
        if x.dtype != dtype or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"weighted_lca: {name} must be a contiguous 2-d {dtype}, "
                             f"got {x.dtype} {tuple(x.shape)}")
    Q, H = hit_rows.shape
    T = rank_table.shape[0]
    if hit_weights.shape != (Q, H) or rank_table.shape[1] != NUM_RANKS or T < 1:
        raise ValueError(f"weighted_lca: shapes {tuple(hit_rows.shape)}, "
                         f"{tuple(hit_weights.shape)}, {tuple(rank_table.shape)}")
    if not 1 <= H <= LCA_MAX_BUCKET or not 1 <= Q < 2**31:
        raise ValueError(f"weighted_lca: need 1 <= H <= {LCA_MAX_BUCKET} and Q >= 1, got {Q}, {H}")
    chosen = torch.empty((Q, NUM_RANKS), dtype=torch.int32, device=hit_rows.device)
    n_chosen = torch.empty(Q, dtype=torch.int32, device=hit_rows.device)
    confidence = torch.empty(Q, dtype=torch.float64, device=hit_rows.device)
    _launch("lca", hit_rows.device, hit_rows.data_ptr(), hit_weights.data_ptr(),
            rank_table.data_ptr(), Q, H, T, chosen.data_ptr(), n_chosen.data_ptr(),
            confidence.data_ptr())
    weighted_lca.launches += 1
    return chosen, n_chosen, confidence


weighted_lca.launches = 0


# ----------------------------------------------------------------------
# host oracle: exact reference float semantics


def weighted_lca_host(
    taxid_weights: Dict[str, float],
    hier: Dict[str, Sequence[str]],
) -> Tuple[str, str, float]:
    """Reference-exact weighted LCA for one query.

    Semantics of ``classification_cami.py:251-288``: iterate ranks top-down;
    per rank accumulate weights per name over taxids in dict-insertion
    order; Python ``max`` tie-break (first-seen); confidence product;
    break at the first nameless rank.
    """
    total_w = sum(taxid_weights.values())
    if total_w <= 0:
        return "Unknown", "root", 0.0

    chosen: List[str] = []
    conf_product = 1.0
    for r_idx in range(NUM_RANKS):
        name_w: Dict[str, float] = {}
        denom = 0.0
        for tid, wgt in taxid_weights.items():
            names = hier.get(tid)
            if not names:
                continue
            nm = names[r_idx] if r_idx < len(names) else ""
            if nm:
                name_w[nm] = name_w.get(nm, 0.0) + wgt
                denom += wgt
        if denom <= 0 or not name_w:
            break
        best_name, best_w = max(name_w.items(), key=lambda kv: kv[1])
        conf_product *= best_w / denom
        chosen.append(best_name)

    if not chosen:
        return "Unknown", "root", 0.0
    lineage = "; ".join(f"{RANKS[i]}:{nm}" for i, nm in enumerate(chosen))
    return lineage, RANKS[len(chosen) - 1], min(conf_product, 1.0)


# ----------------------------------------------------------------------
# batching helpers


# Largest hit-list a query may carry into :func:`bucket_pad`. The aligner
# emits at most ``max_secondary + 1`` records per query, so the run checks
# that cap against this ceiling: a config raising max_secondary past it
# must fail loudly, not silently drop weights.
DEFAULT_BUCKETS: Tuple[int, ...] = (8, 32, 128, 512, 2048)
LCA_MAX_BUCKET: int = DEFAULT_BUCKETS[-1]


def bucket_pad(
    entries_per_query: Sequence[Sequence[Tuple[int, float]]],
    buckets: Sequence[int] = DEFAULT_BUCKETS,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Group ragged per-query (row, weight) hit lists into padded buckets.

    Returns a list of (query_indices, hit_rows [q, H], hit_weights [q, H])
    per non-empty bucket. A query whose hit count exceeds the largest
    bucket raises ``ValueError`` — truncation would silently drop LCA
    weights; size the largest bucket above the aligner's per-query hit
    cap instead (``AlignerConfig.max_secondary + 1``).
    """
    out = []
    maxb = buckets[-1]
    assignments: Dict[int, List[int]] = {b: [] for b in buckets}
    for qi, entries in enumerate(entries_per_query):
        n = len(entries)
        if n > maxb:
            raise ValueError(
                f"query {qi} carries {n} LCA entries > largest bucket "
                f"{maxb}; raise the bucket ceiling (weights must never be "
                f"silently dropped)"
            )
        b = next((b for b in buckets if n <= b), maxb)
        assignments[b].append(qi)
    for b, qidx in assignments.items():
        if not qidx:
            continue
        # the query dimension padded to a power of two as well (the JAX
        # package's compile buckets; the batches stay the same here), and
        # capped so a [Q, H, H] equality tensor stays within ~256 MB
        q_pad = 1 << max(3, int(np.ceil(np.log2(len(qidx)))))
        q_cap = max(8, (1 << 26) // max(b * b, 1))
        q_pad = min(q_pad, 1 << int(np.ceil(np.log2(q_cap))))
        for base in range(0, len(qidx), q_pad):
            part = qidx[base : base + q_pad]
            rows = np.full((q_pad, b), -1, dtype=np.int32)
            weights = np.zeros((q_pad, b), dtype=np.float64)
            for i, qi in enumerate(part):
                entries = entries_per_query[qi][:b]
                for j, (row, wgt) in enumerate(entries):
                    rows[i, j] = row
                    weights[i, j] = wgt
            out.append((np.asarray(part, dtype=np.int64), rows, weights))
    return out
