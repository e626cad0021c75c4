"""Minimizer seed-chain aligner, the ``minimap2 -x asm10`` replacement
(counterpart of hymet_tpu.models.aligner's single-device path).

Produces PAF records whose block extents drive the downstream
coverage-weighted LCA. Per staged batch of <= 64 contig rows the device
runs three hand-written kernels (:mod:`hymet_tpu_torch.ops.align_kernels`):
minimizers -> anchors (bucket-confined index search, expansion, packed
keys, their stable sort) -> chains, and returns only the good chains'
[n, 9] rows; the host
then picks primaries and secondaries and emits PAF. Batches are
dispatched four ahead of the one being finished, so the card works while
the host reads counts and builds records; a batch's three counts come
back in one device-to-host copy.

The JAX package's host-chain path, its compile-service fallbacks and its
flag-gated variants are not ported: this module runs the shipping
defaults.

Chain geometry: anchors of a colinear alignment share a diagonal (rpos -
qpos, or rpos + qpos on opposite strands) up to indel drift; chains are
maximal runs of anchors within merged diagonal bands of width
2^band_bits.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hymet_tpu_torch.io.fasta import encode_seq, pack_code_batch
from hymet_tpu_torch.io.minimizer_index import MinimizerIndex
from hymet_tpu_torch.io.paf import PafRecord
from hymet_tpu_torch.ops.align_kernels import KERNELS, SEQ_BITS, AlignOps, anchor_tables
from hymet_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("hymet_tpu_torch.aligner")

BUCKET_BITS_MAX = 22  # the anchor search's largest bucket table: 2^22 + 2 int32


@dataclass
class AlignerConfig:
    max_occ: int = 16  # drop minimizers with more index occurrences (repetitive)
    band_bits: int = 11  # diagonal band width = 2^band_bits
    min_cnt: int = 3  # min anchors per chain (minimap2 -n 3)
    min_mlen: int = 40  # min matched bases per chain (minimap2 -m 40)
    pri_ratio: float = 0.8  # secondary kept if score >= 0.8 * its primary
    max_secondary: int = 50  # minimap2 asm10 -N 50
    mask_level: float = 0.5  # query-overlap fraction marking a chain secondary
    # a secondary needs at least this share of its primary's anchors: a
    # sibling strain at divergence d keeps ~(1-d)^k of them (0.93 at
    # d = 0.4 %, k = 19), near-equal explanations survive; 0 disables
    sec_count_ratio: float = 0.96
    batch_pad: int = 1 << 16  # query padding quantum


def build_search_tables(
    hashes: np.ndarray, seq_id: np.ndarray, pos: np.ndarray, strand: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The anchor search's tables from an index's sorted hashes:
    (uniq int64 [U] — the unique hashes as uint64 bit patterns, ascending
    as unsigned; roff2 int32 [U, 2] — each unique hash's run (start, end)
    in the index; ps int32 [M, 2] — each entry's (pos, seq << 1 | strand)).
    The JAX package keeps ``uniq`` as (hi, lo) uint32 pairs; its
    top-bits bucket table, on the 64-bit word, confines nothing at
    2k <= 38-bit hashes (:func:`build_bucket_table` takes the hash's own
    top bits)."""
    M = int(hashes.shape[0])
    if M == 0:
        return (np.zeros(0, dtype=np.int64), np.zeros((0, 2), dtype=np.int32),
                np.zeros((0, 2), dtype=np.int32))
    change = np.ones(M, dtype=bool)
    change[1:] = hashes[1:] != hashes[:-1]
    starts = np.flatnonzero(change)
    ends = np.append(starts[1:], M)
    roff2 = np.stack([starts, ends], axis=1).astype(np.int32)
    ps = np.stack(
        [pos.astype(np.int32), (seq_id.astype(np.int32) << 1) | strand.astype(np.int32)], axis=1
    )
    return np.ascontiguousarray(hashes[starts]).view(np.int64), roff2, ps


def build_bucket_table(uniq: np.ndarray, k: int) -> Tuple[np.ndarray, int]:
    """The anchor search's bucket table on the top `bits` bits of the
    2k-bit hash: (bucket int32 [2^bits + 2], shift = 2k - bits), where
    ``bucket[t]`` is the first u with ``uniq[u] >> shift >= t`` (unsigned)
    and the last two entries are U, so that a hash's lower bound lies in
    ``[bucket[t], bucket[t + 1]]``, t = min(hash >> shift, 2^bits).
    bits = ceil(log2(U + 1)), within [1, min(2k, BUCKET_BITS_MAX)]: about
    one entry a bucket on average. An index's hashes are window minima, so
    the low buckets hold many times the average (and queries, minimizers
    too, fall there as often): on a random 4 Mbp index the searches average
    3 steps and take at most 5 (4.6 and 6 at a quarter of the buckets)."""
    U = int(uniq.shape[0])
    bits = min(2 * k, BUCKET_BITS_MAX, max(1, int(np.ceil(np.log2(U + 1)))))
    shift = 2 * k - bits
    bucket = np.empty((1 << bits) + 2, dtype=np.int32)
    bucket[:-1] = np.searchsorted(uniq.view(np.uint64) >> np.uint64(shift),
                                  np.arange((1 << bits) + 1, dtype=np.uint64))
    bucket[-1] = U
    return bucket, shift


def expected_anchor_occ(hashes: np.ndarray, max_occ: int) -> float:
    """Expected anchors per query minimizer for self-similar queries: a
    query hash is drawn with probability proportional to its occurrence
    and contributes `occ` anchors if occ <= max_occ, so
    E = sum_{occ<=max_occ} occ^2 / sum_all occ. Sizes the anchor cap."""
    M = hashes.shape[0]
    if M == 0:
        return 1.0
    change = np.ones(M, dtype=bool)
    change[1:] = hashes[1:] != hashes[:-1]
    occ = np.diff(np.append(np.flatnonzero(change), M))
    kept = occ[occ <= max_occ]
    return float((kept.astype(np.float64) ** 2).sum() / max(occ.sum(), 1))


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


def _round_4k(x: float, lo: int = 4096) -> int:
    """Round up to a multiple of 4096 (at least `lo`)."""
    return max(lo, int(-(-x // 4096)) * 4096)


@dataclass
class _Chain:
    qid: int
    seq: int
    rel: int
    count: int
    minq: int
    maxq: int
    minr: int
    maxr: int
    mlen: int = 0
    blen: int = 0
    # minimap2 s1 analog: union of the anchors' k-mer intervals on the
    # query — the primary-ranking score
    score: int = 0


def _chains_from_rows(rows: np.ndarray, k: int, seq_offset: int = 0) -> List[_Chain]:
    """_Chain objects from device [n, 9] chain rows; ``seq_offset`` (an
    index shard's first sequence) makes a shard's sequence ids global."""
    arr = rows.astype(np.int64)
    out = []
    for q, s, rel, cnt, minq, maxq, minr, maxr, score in arr:
        span_q = maxq - minq + k
        span_r = maxr - minr + k
        out.append(
            _Chain(
                qid=int(q),
                seq=int(s) + seq_offset,
                rel=int(rel),
                count=int(cnt),
                minq=int(minq),
                maxq=int(maxq),
                minr=int(minr),
                maxr=int(maxr),
                mlen=int(min(cnt * k, span_q)),
                blen=int(max(span_q, span_r)),
                score=int(score),
            )
        )
    return out


class MinimizerAligner:
    """Maps query contigs against a MinimizerIndex, emitting PAF records.

    The index's search tables live on `device` (default the card; raises
    without one). ``ops`` (keyword-only) is a test seam: the three device
    functions the batches go through, the hand-written kernels by default
    (:data:`hymet_tpu_torch.ops.align_kernels.PLAIN` swaps in the plain
    versions)."""

    def __init__(
        self,
        index: MinimizerIndex,
        config: Optional[AlignerConfig] = None,
        *,
        device="cuda",
        ops: AlignOps = KERNELS,
    ):
        if len(index.names) >= (1 << SEQ_BITS):
            raise ValueError(
                f"index has {len(index.names)} sequences; the packed sort-key "
                f"layout supports < 2^{SEQ_BITS}"
            )
        self.dev = resolve_device(device)
        self.index = index
        self.cfg = config or AlignerConfig()
        self.ops = ops
        uniq, roff2, ps = build_search_tables(index.hashes, index.seq_id, index.pos, index.strand)
        self._tables = anchor_tables(uniq, roff2, ps, *build_bucket_table(uniq, index.k),
                                     len(index.names), self.dev)
        # sticky overflow-retry multipliers (see _finish_batch)
        self._cap_boost = 1
        self._acap_boost = 1
        self._ccap_boost = 1
        self._exp_occ = expected_anchor_occ(index.hashes, self.cfg.max_occ)

    # ------------------------------------------------------------------

    def map_batch(
        self, names: Sequence[str], seqs: Sequence[bytes], staged=None
    ) -> List[PafRecord]:
        """Map queries; returns PAF records grouped per query in input
        order (primary chain first).

        ``staged`` (a :class:`hymet_tpu_torch.pipeline.staged.StagedContigs`)
        supplies the batches already on the device, in this exact grouping;
        it is used only when its plan matches these queries and this
        config."""
        k, w = self.index.k, self.index.w
        cfg = self.cfg
        records: List[PafRecord] = []
        if self.index.n_minimizers == 0:
            return records
        use_staged = staged is not None and staged.matches(len(seqs), cfg.batch_pad, k + w)
        if use_staged:
            groups, fixed_rows = staged.groups, staged.fixed_rows
        else:
            groups, fixed_rows = plan_query_groups([len(s) for s in seqs], cfg.batch_pad, k + w)

        def _stage(gi: int):
            if use_staged:
                return staged.device[gi]
            return build_group_batch(seqs, groups[gi], cfg.batch_pad, k + w, fixed_rows)

        per_query: dict = {i: [] for i in range(len(seqs))}
        # dispatch-ahead: the next `lookahead` groups are enqueued before
        # this group's counts are read, so the card is not idle while the
        # host finishes a batch
        pending: dict = {}
        lookahead = 4
        for gi, group in enumerate(groups):
            for gj in range(gi, min(gi + lookahead, len(groups))):
                if gj not in pending:
                    pending[gj] = self._dispatch_batch(_stage(gj))
            for ch in self._finish_batch(pending.pop(gi)):
                if ch.qid < len(group):
                    per_query[group[ch.qid]].append(ch)
        for i, name in enumerate(names):
            records.extend(
                emit_paf(name, len(seqs[i]), per_query[i], self.index.names,
                         self.index.lengths, k, cfg)
            )
        return records

    # ------------------------------------------------------------------

    def _chains_for_batch(self, batch) -> List[_Chain]:
        """Dispatch one batch and wait for its chains (see
        :meth:`_dispatch_batch` for what `batch` may be)."""
        return self._finish_batch(self._dispatch_batch(batch))

    def _dispatch_batch(self, batch):
        """Enqueue one batch on the device and return a pending handle
        without waiting for it. `batch` is a staged (packed, mask, rows, L)
        tuple or a host [B, L] uint8 code array, which is packed there and
        uploaded."""
        if not isinstance(batch, tuple):
            packed, mask, L = pack_code_batch(np.asarray(batch))
            batch = (torch.from_numpy(packed).to(self.dev), torch.from_numpy(mask).to(self.dev),
                     packed.shape[0], L)
        _packed, _mask, B, L = batch
        NW, cap = self._minimizer_cap(B, L)
        acap, ccap = self._device_caps(B, NW, cap)
        return (batch, cap, acap, ccap, self._dispatch_fused(batch, cap, acap, ccap))

    def _dispatch_fused(self, batch, cap: int, acap: int, ccap: int):
        """minimizers -> sorted anchors -> chains for one batch, all on the
        device: (chain rows [ccap, 9], counts int64 [3] = (n_chains,
        n_kept, n_anchors))."""
        packed, mask, B, L = batch
        k, w = self.index.k, self.index.w
        cfg = self.cfg
        mz = self.ops.minimizers(packed, mask, L, k, w, cap)
        key, qpos, rpos, n_anchors = self.ops.anchors(
            *mz, self._tables, cfg.max_occ, cfg.band_bits, acap, B, L
        )
        rows, n_chains = self.ops.chains(key, qpos, rpos, k, cfg.min_cnt, cfg.min_mlen, ccap)
        return rows, torch.cat([n_chains, mz[4], n_anchors])

    def _minimizer_cap(self, B: int, L: int):
        """(window count, minimizer compaction cap) for a [B, L] batch:
        random-sequence minimizer density 2/(w+1) with 1.35x headroom,
        rounded up to 4096; low-complexity sequence can exceed it, and the
        overflow retries with a sticky doubled cap."""
        NW = L - self.index.k - self.index.w + 2
        density = 2.0 / (self.index.w + 1)
        cap = _round_4k(B * NW * density * 1.35) * self._cap_boost
        cap = min(cap, B * NW)
        return NW, cap

    def _device_caps(self, B: int, NW: int, cap: int):
        """Anchor and chain caps: expected anchors = windows x minimizer
        density x E[occ] (from the index) with 1.5x headroom, never above
        4 cap; chains max(1024, min(4 cap, 2^15)); both times their sticky
        boosts."""
        exp_anchors = B * NW * (2.0 / (self.index.w + 1)) * self._exp_occ
        acap = min(_round_4k(1.5 * exp_anchors), 4 * cap) * self._acap_boost
        ccap = max(1024, min(4 * cap, 1 << 15)) * self._ccap_boost
        return acap, ccap

    def _finish_batch(self, pending) -> List[_Chain]:
        """Wait for a pending batch (one copy of its three counts), retry
        it with doubled caps on overflow (the boosts stay for later
        batches), and return its chains."""
        batch, cap, acap, ccap, (rows, counts) = pending
        while True:
            n_chains, n_kept, n_anchors = counts.tolist()
            if n_kept > cap:
                logger.info("minimizer overflow (%d > %d): doubling cap", n_kept, cap)
                cap *= 2
                self._cap_boost *= 2
            elif n_anchors > acap:
                logger.info("anchor overflow (%d > %d): doubling acap", n_anchors, acap)
                acap *= 2
                self._acap_boost *= 2
            elif n_chains > ccap:
                logger.info("chain overflow (%d > %d): doubling ccap", n_chains, ccap)
                ccap *= 2
                self._ccap_boost *= 2
            else:
                break
            rows, counts = self._dispatch_fused(batch, cap, acap, ccap)
        if n_chains == 0:
            return []
        return _chains_from_rows(rows[:n_chains].cpu().numpy(), self.index.k)


def emit_paf(
    qname: str,
    qlen: int,
    chains: List[_Chain],
    names,
    lengths,
    k: int,
    cfg: AlignerConfig,
) -> List[PafRecord]:
    if not chains:
        return []
    # rank by the minimap2-s1-analog `score` (union anchor coverage); count
    # and mlen break residual ties
    chains.sort(key=lambda c: (-c.score, -c.count, -c.mlen))
    # minimap2-style primary marking (mm_set_parent): walking chains by
    # descending score, a chain is secondary iff its query interval
    # overlaps an already-chosen primary by > mask_level of the shorter
    # span; disjoint spans (e.g. chimeric contigs) each get their own
    # primary. Each primary's mapq derives from its own best secondary.
    primaries: List[Tuple[_Chain, int]] = []  # (chain, best sub-score)
    parent_of: List[Optional[int]] = []
    for c in chains:
        parent = None
        for i, (p, _) in enumerate(primaries):
            ov = min(c.maxq, p.maxq) - max(c.minq, p.minq) + k
            shorter = min(c.maxq - c.minq, p.maxq - p.minq) + k
            if ov > 0 and ov > cfg.mask_level * shorter:
                parent = i
                break
        if parent is None:
            primaries.append((c, 0))
            parent_of.append(None)
        else:
            p, sub = primaries[parent]
            if c.score > sub:
                primaries[parent] = (p, c.score)
            parent_of.append(parent)

    out: List[PafRecord] = []
    n_sec = 0
    for rank, c in enumerate(chains):
        parent = parent_of[rank]
        primary = parent is None
        mapq = 0
        if primary:
            sub = next(s for p, s in primaries if p is c)
            frac = sub / c.score if c.score else 1.0
            mapq = int(min(60, max(0, 60 * (1.0 - frac))))
        else:
            pri = primaries[parent][0]
            if c.score < cfg.pri_ratio * pri.score:
                continue
            if cfg.sec_count_ratio and c.count < cfg.sec_count_ratio * pri.count:
                continue
            if n_sec >= cfg.max_secondary:
                continue
            n_sec += 1
        out.append(
            PafRecord(
                qname=qname,
                qlen=qlen,
                qstart=c.minq,
                qend=c.maxq + k,
                strand="-" if c.rel else "+",
                tname=names[c.seq],
                tlen=int(lengths[c.seq]),
                tstart=c.minr,
                tend=c.maxr + k,
                # column 10: the chain's matching-length estimate (sum of
                # min(anchor gap, k)), which `score` is
                nmatch=c.score,
                blocklen=c.blen,
                mapq=mapq,
                tags={
                    "tp": f"A:{'P' if primary else 'S'}",
                    "cm": f"i:{c.count}",
                },
            )
        )
    return out
