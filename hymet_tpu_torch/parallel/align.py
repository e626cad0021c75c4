"""Sharded minimizer alignment over the ("data", "db") mesh (counterpart of
hymet_tpu.parallel.align).

The minimap2 ``-I2g`` batching (reference ``scripts/minimap2.sh:12``,
``run_hymet_cami.sh:76-80``) bounded index RAM by processing reference
chunks one after another; here the index shards by reference sequence
(:meth:`~hymet_tpu_torch.io.minimizer_index.MinimizerIndex.shard`), each
shard's search tables live on its device of the mesh's first data row,
and every shard runs the three kernels — ``minimizers`` → ``anchors`` →
``chains`` — on the whole (replicated) query batch. The JAX program's
data replicas compute the same thing again, so each shard runs once here.
The host concatenates the shards' chains in shard order (reference
sequences are disjoint across shards) before primary and secondary
selection.

One set of caps serves every shard, as in the JAX program: the anchor
cap from the worst shard's occurrence expectation, and the sticky boosts
double when any shard overflows. ``max_occ`` applies to each shard's
index alone, so a minimizer frequent in the whole reference but not in
its shard is kept: the sharded run may map otherwise than the
single-device run (ROADMAP C14); it follows the JAX sharded program.

Over a mesh that spans processes, each process builds aligners only for
the shards it owns. Each group's counts are gathered from every process
before the overflow decision, so that every process retries, or goes on,
together; then the chain rows are gathered in shard order. Every process
enters both gathers for every group, a process that owns no shard too.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from hymet_tpu_torch.io.fasta import encode_seq, pack_code_batch
from hymet_tpu_torch.io.minimizer_index import MinimizerIndex
from hymet_tpu_torch.io.paf import PafRecord
from hymet_tpu_torch.models.aligner import (
    AlignerConfig,
    MinimizerAligner,
    _chains_from_rows,
    emit_paf,
    expected_anchor_occ,
    pad_query_len,
)
from hymet_tpu_torch.ops.align_kernels import KERNELS, SEQ_BITS, AlignOps
from hymet_tpu_torch.parallel.mesh import Mesh, fetch_global_tree

logger = logging.getLogger("hymet_tpu_torch.aligner")

GROUP_ROWS = 64  # queries a batch


class ShardedMinimizerAligner:
    """Multi-device MinimizerAligner with the same map_batch contract.

    ``ops`` (keyword-only) is the test seam of
    :class:`~hymet_tpu_torch.models.aligner.MinimizerAligner`: the kernels
    by default, :data:`~hymet_tpu_torch.ops.align_kernels.PLAIN` for the
    plain versions."""

    def __init__(
        self,
        mesh: Mesh,
        index: MinimizerIndex,
        config: Optional[AlignerConfig] = None,
        *,
        ops: AlignOps = KERNELS,
    ):
        self.mesh = mesh
        self.index = index
        self.cfg = config or AlignerConfig()
        n_db = mesh.shape["db"]
        self.shards = index.shard(n_db)
        if any(len(s.names) >= (1 << SEQ_BITS) for s in self.shards):
            raise ValueError(
                f"an index shard holds 2^{SEQ_BITS} sequences or more (packed sort-key "
                "layout); use more db shards"
            )
        # global sequence id of each shard's first (shard() renumbers)
        bounds = np.linspace(0, len(index.names), n_db + 1).astype(int)
        self.seq_offsets = bounds[:-1]
        # an empty shard has no tables and maps nothing; another process's
        # shard has no tables here
        local = set(mesh.local_shards)
        self.aligners: List[Optional[MinimizerAligner]] = [
            MinimizerAligner(sh, self.cfg, device=dev, ops=ops)
            if sh.n_minimizers and i in local else None
            for i, (sh, dev) in enumerate(zip(self.shards, mesh.db_devices))
        ]
        # (shard, aligner) of this process's live shards
        self._live = [(i, a) for i, a in enumerate(self.aligners) if a is not None]
        # sticky overflow-retry multipliers, shared by the shards
        self._cap_boost = 1
        self._acap_boost = 1
        self._ccap_boost = 1
        # the worst shard's occurrence expectation sizes every shard's cap:
        # from the host shards, which every process holds whole
        self._exp_occ = max((expected_anchor_occ(sh.hashes, self.cfg.max_occ)
                             for sh in self.shards if sh.n_minimizers), default=1.0)

    def map_batch(self, names: Sequence[str], seqs: Sequence[bytes]) -> List[PafRecord]:
        """Map queries; returns PAF records grouped per query in input
        order (primary chain first). One pad for the whole call (the
        longest query's), groups of 64 queries in input order."""
        k, w = self.index.k, self.index.w
        cfg = self.cfg
        records: List[PafRecord] = []
        if self.index.n_minimizers == 0:
            return records
        pad = pad_query_len(max(max((len(s) for s in seqs), default=1), k + w), cfg.batch_pad)
        groups = [
            list(range(base, min(base + GROUP_ROWS, len(seqs))))
            for base in range(0, len(seqs), GROUP_ROWS)
        ]

        def _stage(group) -> tuple:
            rows = GROUP_ROWS if len(seqs) >= GROUP_ROWS else len(group)
            batch = np.full((rows, pad), 4, dtype=np.uint8)
            for row, i in enumerate(group):
                codes = encode_seq(seqs[i])
                batch[row, : codes.shape[0]] = codes
            packed, mask, L = pack_code_batch(batch)
            uploaded: dict = {}
            for _i, a in self._live:
                if a.dev not in uploaded:
                    uploaded[a.dev] = (torch.from_numpy(packed).to(a.dev),
                                       torch.from_numpy(mask).to(a.dev), rows, L)
            return uploaded, rows, L

        per_query: dict = {i: [] for i in range(len(seqs))}
        # dispatch-ahead, as MinimizerAligner.map_batch
        pending: dict = {}
        lookahead = 4
        for gi, group in enumerate(groups):
            for gj in range(gi, min(gi + lookahead, len(groups))):
                if gj not in pending:
                    pending[gj] = self._dispatch_batch(_stage(groups[gj]))
            for ch in self._finish_batch(pending.pop(gi)):
                if ch.qid < len(group):
                    per_query[group[ch.qid]].append(ch)
        for i, name in enumerate(names):
            records.extend(
                emit_paf(name, len(seqs[i]), per_query[i], self.index.names,
                         self.index.lengths, k, cfg)
            )
        return records

    def _caps(self, B: int, L: int):
        """(cap, acap, ccap) of a [B, L] batch: MinimizerAligner's sizing,
        on this aligner's worst-shard occurrence expectation and shared
        boosts (the attributes it reads)."""
        NW, cap = MinimizerAligner._minimizer_cap(self, B, L)
        return (cap, *MinimizerAligner._device_caps(self, B, NW, cap))

    def _dispatch_all(self, batches: dict, cap: int, acap: int, ccap: int) -> list:
        return [a._dispatch_fused(batches[a.dev], cap, acap, ccap) for _i, a in self._live]

    def _dispatch_batch(self, staged: tuple):
        """Enqueue one group on every local shard without waiting for it."""
        batches, B, L = staged
        cap, acap, ccap = self._caps(B, L)
        return (batches, cap, acap, ccap, self._dispatch_all(batches, cap, acap, ccap))

    def _finish_batch(self, pending) -> list:
        """Wait for a pending group (its local shards' counts in one copy,
        every process's in one gather), retry every shard with doubled caps
        when any overflowed (the boosts stay for later groups), and return
        the shards' chains in shard order with global sequence ids."""
        batches, cap, acap, ccap, outs = pending
        while True:
            local = (torch.stack([c.to(self._live[0][1].dev) for _rows, c in outs]).cpu()
                     if outs else ())
            # {shard: (n_chains, n_kept, n_anchors)} of every process's live shards
            counts = fetch_global_tree({i: row for (i, _a), row in zip(self._live, local)})
            n_chains, n_kept, n_anchors = (int(max(col)) for col in zip(*counts.values()))
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
            outs = self._dispatch_all(batches, cap, acap, ccap)
        rows = fetch_global_tree({i: rows[: int(counts[i][0])] for (i, _a), (rows, _c) in
                                  zip(self._live, outs)})
        chains = []
        for i in sorted(rows):
            if rows[i].shape[0]:
                chains.extend(_chains_from_rows(rows[i], self.index.k,
                                                seq_offset=int(self.seq_offsets[i])))
        return chains
