"""Sketch database: the same columnar ``.npz`` layout as hymet_tpu's
``SketchDB`` (bottom-s MinHash sketches, hash-compatible with Mash).

The screen engine builds its flat search tables on the device
(:func:`hymet_tpu_torch.ops.sketch.flat_index_device`); :meth:`SketchDB.flat_index`
is the host form of the same tables.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

PAD_HASH = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclass
class SketchDB:
    k: int
    sketch_size: int
    hashes: np.ndarray  # [R, s] uint64, sorted ascending per row, PAD_HASH padded
    n_hashes: np.ndarray  # [R] int32 — actual sketch sizes
    names: List[str]  # reference ids (col 5 of screen output)
    lengths: np.ndarray  # [R] int64 — total genome bp
    comments: List[str] = field(default_factory=list)

    _flat: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def n_refs(self) -> int:
        return len(self.names)

    def flat_index(self) -> Tuple[np.ndarray, np.ndarray]:
        """(flat_hashes [F] uint64 sorted unique, ref_idx [R, s] int32 into
        flat_hashes, -1 padded)."""
        if self._flat is None:
            valid_mask = self.hashes != PAD_HASH
            flat = np.unique(self.hashes[valid_mask])
            ref_idx = np.full(self.hashes.shape, -1, dtype=np.int32)
            pos = np.searchsorted(flat, self.hashes[valid_mask])
            ref_idx[valid_mask] = pos.astype(np.int32)
            self._flat = (flat, ref_idx)
        return self._flat

    def save(self, path: str) -> None:
        # atomic (tmp + rename): readers never see a half-written archive
        tmp = f"{path}.tmp.{os.getpid()}"
        np.savez_compressed(
            tmp,
            k=np.int32(self.k),
            sketch_size=np.int32(self.sketch_size),
            hashes=self.hashes,
            n_hashes=self.n_hashes,
            names=np.array(self.names, dtype=object),
            lengths=self.lengths,
            comments=np.array(self.comments or [""] * self.n_refs, dtype=object),
        )
        os.replace(tmp if tmp.endswith(".npz") else f"{tmp}.npz", path)

    @classmethod
    def load(cls, path: str) -> "SketchDB":
        with np.load(path, allow_pickle=True) as z:
            return cls(
                k=int(z["k"]),
                sketch_size=int(z["sketch_size"]),
                hashes=z["hashes"],
                n_hashes=z["n_hashes"],
                names=[str(x) for x in z["names"]],
                lengths=z["lengths"],
                comments=[str(x) for x in z["comments"]],
            )

    @classmethod
    def concat(cls, dbs: Sequence["SketchDB"]) -> "SketchDB":
        """Row-concatenate DBs with the same k into one screening DB; per-DB
        rows come back by :meth:`hymet_tpu_torch.ops.sketch.ScreenResult.slice`."""
        ks = {db.k for db in dbs}
        if len(ks) != 1:
            raise ValueError(f"cannot concat sketch DBs with mixed k: {ks}")
        s = max(db.hashes.shape[1] for db in dbs)
        rows = []
        for db in dbs:
            h = db.hashes
            if h.shape[1] < s:
                pad = np.full((h.shape[0], s - h.shape[1]), PAD_HASH, dtype=np.uint64)
                h = np.concatenate([h, pad], axis=1)
            rows.append(h)
        return cls(
            k=dbs[0].k,
            sketch_size=max(db.sketch_size for db in dbs),
            hashes=np.concatenate(rows, axis=0),
            n_hashes=np.concatenate([db.n_hashes for db in dbs]),
            names=[n for db in dbs for n in db.names],
            lengths=np.concatenate([db.lengths for db in dbs]),
            comments=[c for db in dbs for c in (db.comments or [""] * db.n_refs)],
        )


def load_sketch_db(path: str) -> SketchDB:
    """Load a sketch DB in the ``.npz`` layout (``.msh`` is not ported yet)."""
    if path.endswith(".msh"):
        raise NotImplementedError(f"{path}: .msh sketch DBs are not supported by the port yet")
    return SketchDB.load(path)
