"""Sharded sketch screen over a ("data", "db") mesh (counterpart of
hymet_tpu.parallel.screen).

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

Over a mesh that spans processes, each process builds engines only for
the shards it owns and counts every batch on them; ``finalize`` gathers
every shard's rows and the window total (the first counting shard's) in
one collective round, which every process enters, a process that owns no
shard too.

Sharding by reference changes no count: the scores equal the
single-device engine's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from hymet_tpu_torch.io.fasta import pack_code_batch
from hymet_tpu_torch.io.sketchdb import PAD_HASH, SketchDB
from hymet_tpu_torch.ops.hash_kernels import screen_count
from hymet_tpu_torch.ops.sketch import CountFn, ScreenEngine, ScreenResult, count_valid_windows
from hymet_tpu_torch.parallel.mesh import Mesh, fetch_global_tree


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
        # shard whose sketches hold no hash scores 0 and counts nothing;
        # another process's shard holds no engine here
        local = set(mesh.local_shards)
        self.engines: List[Optional[ScreenEngine]] = [
            ScreenEngine(sh, device=dev, count_fn=count_fn) if sh.n_refs and i in local else None
            for i, (sh, dev) in enumerate(zip(self.shards, mesh.db_devices))
        ]
        # every process knows which shards count (each holds the whole DB)
        counting = [i for i, sh in enumerate(self.shards) if (sh.hashes != PAD_HASH).any()]
        self._first_counting = counting[0] if counting else None
        self._counting = [self.engines[i] for i in counting if self.engines[i] is not None]
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
        if self._first_counting is None:
            self.total_query_kmers += count_valid_windows(codes, self.db.k)
            return
        if not self._counting:
            return  # every counting shard lives in another process
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
        local = {i: e.finalize() for i, e in enumerate(self.engines) if e is not None}
        rows, totals = fetch_global_tree((
            {i: (r.identity, r.shared, r.median) for i, r in local.items()},
            # every counting shard saw every valid window; the first's
            # count is the total
            {i: r.total_query_kmers for i, r in local.items() if i == self._first_counting},
        ))
        if self._first_counting is not None:
            self.total_query_kmers = int(totals[self._first_counting])
        # reassemble per-shard rows into the global reference order
        identity = np.zeros(self.db.n_refs)
        g_shared = np.zeros(self.db.n_refs, dtype=np.int64)
        g_median = np.zeros(self.db.n_refs, dtype=np.int64)
        off = 0
        for i, sh in enumerate(self.shards):
            r = sh.n_refs
            if r:
                identity[off : off + r], g_shared[off : off + r], g_median[off : off + r] = rows[i]
            off += r
        return ScreenResult(
            db=self.db,
            identity=identity,
            shared=g_shared,
            median=g_median,
            total_query_kmers=self.total_query_kmers,
        )
