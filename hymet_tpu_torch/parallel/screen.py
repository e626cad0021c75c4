"""Sharded sketch screen over a ("data", "db") mesh (counterpart of
hymet_tpu.parallel.screen, one process).

The reference's three sequential sketch DBs and ``mash screen -p 8``
(``run_hymet_cami.sh:83-99``, ``scripts/mash.sh:14``) become one screen
over row-sharded sketch matrices:

- the references shard row-contiguously over "db"
  (:meth:`~hymet_tpu_torch.io.sketchdb.SketchDB.shard`); each shard's flat
  keys and counts live once, on its device of the mesh's first data row,
  in a :class:`~hymet_tpu_torch.ops.sketch.ScreenEngine` of its own;
- each batch's rows are padded with code-4 rows to a multiple of the
  "data" size, packed once on the host, uploaded once a distinct device,
  and counted by every db shard with the ``screen_count`` kernel (one
  launch a batch and shard). The JAX program hashes each data block on
  its own device and all-gathers the hashes over "data", so that every db
  shard counts the whole batch, which is what this does; its data
  replicas count the same again;
- each shard scores its own rows; the rows concatenate in shard order (a
  pure reshard: references are disjoint across shards).

Sharding by reference changes no count: the scores equal the
single-device engine's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from hymet_tpu_torch.io.fasta import pack_code_batch
from hymet_tpu_torch.io.sketchdb import SketchDB
from hymet_tpu_torch.ops.hash_kernels import screen_count
from hymet_tpu_torch.ops.sketch import CountFn, ScreenEngine, ScreenResult, count_valid_windows
from hymet_tpu_torch.parallel.mesh import Mesh


class ShardedScreenEngine:
    """Multi-device ScreenEngine: the same update and finalize contract.

    ``count_fn`` counts one packed batch on one shard, the
    :class:`~hymet_tpu_torch.ops.sketch.ScreenEngine` test seam: the kernel
    wrapper by default."""

    def __init__(self, mesh: Mesh, db: SketchDB, *, count_fn: CountFn = screen_count):
        self.mesh = mesh
        self.db = db
        self.shards = db.shard(mesh.shape["db"])
        # an empty shard (fewer references than shards) holds no engine; a
        # shard whose sketches hold no hash scores 0 and counts nothing
        self.engines: List[Optional[ScreenEngine]] = [
            ScreenEngine(sh, device=dev, count_fn=count_fn) if sh.n_refs else None
            for sh, dev in zip(self.shards, mesh.db_devices)
        ]
        self._counting = [e for e in self.engines if e is not None and e.flat.numel()]
        self.total_query_kmers = 0

    def update_codes(self, codes: np.ndarray) -> None:
        """Stream in a host [B, L] uint8 code batch: padded with code-4
        rows to a multiple of the data size, shipped 2-bit packed with
        validity bits (the kernel's input), counted by every db shard."""
        codes = np.asarray(codes)
        n_data = self.mesh.shape["data"]
        B = codes.shape[0]
        if B % n_data != 0:
            pad = n_data - (B % n_data)
            codes = np.concatenate([codes, np.full((pad, codes.shape[1]), 4, dtype=np.uint8)])
        if not self._counting:
            self.total_query_kmers += count_valid_windows(codes, self.db.k)
            return
        packed, mask, L = pack_code_batch(codes)
        uploaded: dict = {}
        for eng in self._counting:
            if eng.device not in uploaded:
                uploaded[eng.device] = (torch.from_numpy(packed).to(eng.device),
                                        torch.from_numpy(mask).to(eng.device))
            eng.update_staged(*uploaded[eng.device], L)

    # the JAX engine's packed variant differs only in what crosses the
    # link; this one always ships packed codes
    update_codes_packed = update_codes

    def finalize(self) -> ScreenResult:
        results = [e.finalize() if e is not None else None for e in self.engines]
        if self._counting:
            # every counting shard saw every valid window; read the first
            self.total_query_kmers = self._counting[0].total_query_kmers
        # reassemble per-shard rows into the global reference order
        identity = np.zeros(self.db.n_refs)
        g_shared = np.zeros(self.db.n_refs, dtype=np.int64)
        g_median = np.zeros(self.db.n_refs, dtype=np.int64)
        off = 0
        for sh, res in zip(self.shards, results):
            r = sh.n_refs
            if r:
                identity[off : off + r] = res.identity
                g_shared[off : off + r] = res.shared
                g_median[off : off + r] = res.median
            off += r
        return ScreenResult(
            db=self.db,
            identity=identity,
            shared=g_shared,
            median=g_median,
            total_query_kmers=self.total_query_kmers,
        )
