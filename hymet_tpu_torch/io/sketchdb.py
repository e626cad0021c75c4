"""Sketch database: the same columnar ``.npz`` layout as hymet_tpu's
``SketchDB`` (bottom-s MinHash sketches, hash-compatible with Mash), Mash
``.msh`` files read and written (:mod:`hymet_tpu_torch.io.msh`), and the DB
build on the card.

The screen engine builds its flat search tables on the device
(:func:`hymet_tpu_torch.ops.sketch.flat_index_device`); :meth:`SketchDB.flat_index`
is the host form of the same tables.

The build (:func:`build_sketch_db`, :func:`build_sketch_db_from_sequences`)
gives the JAX host build's arrays element for element. The host gunzips,
parses and encodes the FASTA; each genome becomes one row of codes, its
sequences joined by one N code (no window spans an N, so no k-mer spans
two sequences, as in ``sketch_genome_file``); rows go up in batches under
a window budget, sorted by length, and one kernel on the card hashes every
window and keeps each row's s smallest distinct hashes
(:func:`~hymet_tpu_torch.ops.sketch_kernels.sketch_codes`: codes in,
sketches out, no hash written to device memory). A row longer than the
budget goes up in pieces that overlap by k - 1 bases, their sketches
folded by :func:`~hymet_tpu_torch.ops.sketch_kernels.bottom_sketch`. On
the CPU, where the native helpers of :mod:`hymet_tpu_torch.io.native_io`
built (1 <= k <= 32), a batch's rows are hashed on the host instead, as
the JAX host build hashes them; without them the CPU takes
:func:`sketch_codes`'s plain version, which is faster than numpy's.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hymet_tpu_torch.io import native_io
from hymet_tpu_torch.io.fasta import encode_seq, iter_fasta
from hymet_tpu_torch.ops.hashing import kmer_hashes_host
from hymet_tpu_torch.ops.sketch_kernels import bottom_sketch, sketch_codes
from hymet_tpu_torch.utils.device import resolve_device

PAD_HASH = np.uint64(0xFFFFFFFFFFFFFFFF)

# Windows a batch of the build holds, by device type; a window costs about
# a byte there (its code) and the kernel's chunk lists 8 min(s, 65536)
# bytes a 65,536 windows (0.12 bytes a window at s = 1000).
BUILD_WINDOWS = {"cuda": 1 << 27, "cpu": 1 << 22}
MAX_ROWS = 65535  # rows a batch may hold (the kernels' grid)


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
    def from_msh(cls, path: str) -> "SketchDB":
        """Load a Mash ``.msh`` (Cap'n Proto) sketch DB, the format of the
        reference's shipped ``data/sketch1-3.msh``."""
        from hymet_tpu_torch.io.msh import sketchdb_from_msh

        return sketchdb_from_msh(path)

    def to_msh(self, path: str) -> None:
        """Export as a Mash-compatible ``.msh`` file."""
        from hymet_tpu_torch.io.msh import msh_from_sketchdb

        msh_from_sketchdb(self, path)

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

    def shard(self, n_shards: int) -> List["SketchDB"]:
        """Row-contiguous reference shards for the ``db`` mesh axis; the
        bounds are the JAX package's, so each reference lands in the same
        shard."""
        out = []
        bounds = np.linspace(0, self.n_refs, n_shards + 1).astype(int)
        for i in range(n_shards):
            lo, hi = bounds[i], bounds[i + 1]
            out.append(
                SketchDB(
                    k=self.k,
                    sketch_size=self.sketch_size,
                    hashes=self.hashes[lo:hi],
                    n_hashes=self.n_hashes[lo:hi],
                    names=self.names[lo:hi],
                    lengths=self.lengths[lo:hi],
                    comments=self.comments[lo:hi] if self.comments else [],
                )
            )
        return out


def load_sketch_db(path: str) -> SketchDB:
    """Load a sketch DB by extension: ``.msh`` (Mash's Cap'n Proto files)
    or the ``.npz`` layout."""
    if path.endswith(".msh"):
        return SketchDB.from_msh(path)
    return SketchDB.load(path)


def bottom_sketch_from_hashes(hashes: np.ndarray, s: int) -> Tuple[np.ndarray, int]:
    """Bottom-s of the *distinct* hash set (Mash semantics), on the host.
    Returns a length-s array (PAD_HASH padded) and the true count.

    Only the m smallest hashes are made distinct (m = s, doubled until
    they hold s distinct values or are all of them): a partition is linear
    where ``np.unique`` of the whole row sorts or hashes millions."""
    m = s
    while m < len(hashes):
        uniq = np.unique(np.partition(hashes, m - 1)[:m])  # sorted
        if len(uniq) >= s:
            break
        m *= 2
    else:
        uniq = np.unique(hashes)
    n = min(len(uniq), s)
    out = np.full(s, PAD_HASH, dtype=np.uint64)
    out[:n] = uniq[:n]
    return out, n


def genome_row(codes: List[np.ndarray]) -> np.ndarray:
    """A genome's sequences as one row of codes, one N (code 4) between
    two sequences: every window over it is invalid."""
    if len(codes) == 1:
        return codes[0]
    sep = np.full(1, 4, np.uint8)
    parts = [sep] * (2 * len(codes) - 1)
    parts[::2] = codes
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def _add_time(timings: Optional[dict], key: str, t0: float, dev: torch.device) -> float:
    """Add the seconds since t0 (the card's work done) to timings[key];
    returns the clock. A no-op without timings."""
    if timings is None:
        return t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    timings[key] = timings.get(key, 0.0) + t - t0
    return t


def code_batches(rows: List[np.ndarray], k: int, budget: int) -> Iterator[List[int]]:
    """Indices of `rows` in batches: longest first, each batch at most
    MAX_ROWS rows and at most `budget` windows padded to its longest row
    (a row alone may exceed it); rows shorter than k in a batch of their
    own."""
    order = sorted(range(len(rows)), key=lambda i: -len(rows[i]))
    batch: List[int] = []
    for i in order:
        L = len(rows[batch[0]]) if batch else len(rows[i])
        short = len(rows[i]) < k <= L
        if batch and (short or len(batch) == MAX_ROWS or (len(batch) + 1) * (L - k + 1) > budget):
            yield batch
            batch = []
        batch.append(i)
    if batch:
        yield batch


def pad_rows(rows: List[np.ndarray]) -> np.ndarray:
    """Code rows as one [B, longest] batch, N (code 4) past each row."""
    codes = np.full((len(rows), max(len(r) for r in rows)), 4, np.uint8)
    for b, r in enumerate(rows):
        codes[b, : len(r)] = r
    return codes


def _sketch_host(rows: List[np.ndarray], k: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sketch_codes` of the rows on the host, as the JAX host build
    sketches: each row's hashes (:func:`kmer_hashes_host`), the s smallest
    distinct ones."""
    sketches = [bottom_sketch_from_hashes(kmer_hashes_host(r, k), s) for r in rows]
    return (torch.from_numpy(np.stack([h for h, _ in sketches]).view(np.int64)),
            torch.tensor([n for _, n in sketches], dtype=torch.int32))


def _sketch_batch_rows(rows: List[np.ndarray], k: int, s: int, dev: torch.device,
                       timings: Optional[dict]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of code rows (the longest at least k) -> their sketches
    [B, s] and counts [B] on `dev`: :func:`sketch_codes` of the padded
    batch, or on the CPU with the native helpers, :func:`_sketch_host` of
    the rows as they are."""
    t = time.perf_counter()
    host = dev.type == "cpu" and 1 <= k <= 32 and native_io.available()
    if not host:
        codes = torch.from_numpy(pad_rows(rows)).to(dev)
    t = _add_time(timings, "upload_s", t, dev)  # 0 on the host route: nothing goes up
    out = _sketch_host(rows, k, s) if host else sketch_codes(codes, k, s)
    _add_time(timings, "sketch_codes_s", t, dev)
    if timings is not None:
        timings["batches"] = timings.get("batches", 0) + 1
        longest = max(len(r) for r in rows)
        timings["windows"] = timings.get("windows", 0) + len(rows) * (longest - k + 1)
    return out


def _sketch_long_row(row: np.ndarray, k: int, s: int, dev: torch.device, budget: int,
                     timings: Optional[dict]) -> Tuple[torch.Tensor, torch.Tensor]:
    """A row of more than `budget` windows in pieces of `budget` windows
    (k - 1 bases shared by neighbours), each piece's sketch merged into
    the running one as a segment of two rows."""
    acc = None
    for start in range(0, len(row) - k + 1, budget):
        h, n = _sketch_batch_rows([row[start : start + budget + k - 1]], k, s, dev, timings)
        if acc is not None:
            both = torch.cat([acc[0], h])
            counts = torch.cat([acc[1], n])
            valid = torch.arange(s, device=dev)[None, :] < counts[:, None]
            t = time.perf_counter()
            h, n = bottom_sketch(both, valid, s, segments=[2])
            _add_time(timings, "bottom_sketch_s", t, dev)
        acc = (h, n)
    return acc


def sketch_rows(rows: Iterable[np.ndarray], k: int, s: int, device="cuda",
                timings: Optional[dict] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Rows of codes (one genome or sequence each) -> (sketches [R, s]
    uint64, PAD_HASH padded; counts [R] int32): each row's s smallest
    distinct valid k-mer hashes, on `device` (default the card).

    Rows are read in groups of about one batch of windows and batched
    longest first. With a `timings` dict, each step's seconds are added to
    it (``read_s`` for pulling rows from `rows` — gunzip, parse, encode —
    and ``upload_s``, ``sketch_codes_s`` and, for rows that go up in
    pieces, ``bottom_sketch_s``, each ending in a synchronize), with the
    ``batches`` and ``windows``."""
    dev = resolve_device(device)
    budget = BUILD_WINDOWS[dev.type]
    hashes: List[np.ndarray] = []
    counts: List[np.ndarray] = []
    group: List[np.ndarray] = []
    it = iter(rows)
    done = False
    while not done:
        t = time.perf_counter()
        size = 0
        for row in it:
            group.append(row)
            size += len(row)
            if size >= budget:
                break
        else:
            done = True
        _add_time(timings, "read_s", t, dev)
        out_h = np.full((len(group), s), PAD_HASH, np.uint64)
        out_n = np.zeros(len(group), np.int32)
        for batch in code_batches(group, k, budget):
            rows_b = [group[i] for i in batch]
            if len(rows_b[0]) < k:
                continue  # no window: an empty sketch
            if len(rows_b[0]) - k + 1 > budget:
                h, n = _sketch_long_row(rows_b[0], k, s, dev, budget, timings)
            else:
                h, n = _sketch_batch_rows(rows_b, k, s, dev, timings)
            out_h[batch] = h.cpu().numpy().view(np.uint64)
            out_n[batch] = n.cpu().numpy()
        hashes.append(out_h)
        counts.append(out_n)
        group = []
    return (np.concatenate(hashes) if hashes else np.zeros((0, s), np.uint64),
            np.concatenate(counts) if counts else np.zeros(0, np.int32))


def build_sketch_db(
    genome_files: Sequence[str],
    k: int = 21,
    sketch_size: int = 1000,
    names: Optional[Sequence[str]] = None,
    device="cuda",
    timings: Optional[dict] = None,
) -> SketchDB:
    """Build a reference sketch DB from genome FASTA files, one sketch a
    file (all its sequences pooled, Mash's per-file default), on `device`
    (default the card; see :func:`sketch_rows` for `timings`)."""
    R = len(genome_files)
    lengths = np.zeros(R, dtype=np.int64)

    def rows():
        for i, path in enumerate(genome_files):
            codes = []
            for _, seq in iter_fasta(path):
                lengths[i] += len(seq)
                codes.append(encode_seq(seq))
            yield genome_row(codes)

    hashes, n_hashes = sketch_rows(rows(), k, sketch_size, device, timings)
    use_names = list(names) if names is not None else [os.path.basename(p) for p in genome_files]
    return SketchDB(k=k, sketch_size=sketch_size, hashes=hashes, n_hashes=n_hashes,
                    names=use_names, lengths=lengths, comments=[""] * R)


def sketch_genome_file(path: str, k: int, s: int, device="cuda") -> Tuple[np.ndarray, int, int]:
    """Sketch one genome FASTA (all sequences pooled). Returns (sketch [s],
    n_hashes, total_bp)."""
    db = build_sketch_db([path], k, s, device=device)
    return db.hashes[0], int(db.n_hashes[0]), int(db.lengths[0])


def build_sketch_db_from_sequences(
    named_seqs: Iterable[Tuple[str, bytes]],
    k: int = 21,
    sketch_size: int = 1000,
    device="cuda",
) -> SketchDB:
    """Sketch individual sequences (one sketch a sequence, Mash's ``-i``
    mode), on `device` (default the card)."""
    names: List[str] = []
    lens: List[int] = []

    def rows():
        for name, seq in named_seqs:
            names.append(name)
            lens.append(len(seq))
            yield encode_seq(seq)

    hashes, n_hashes = sketch_rows(rows(), k, sketch_size, device)
    return SketchDB(k=k, sketch_size=sketch_size, hashes=hashes, n_hashes=n_hashes,
                    names=names, lengths=np.asarray(lens, dtype=np.int64),
                    comments=[""] * len(names))
