"""Minimizer index over reference sequences (counterpart of
hymet_tpu.io.minimizer_index).

The same layout and the same ``.npz`` file as the JAX package's, so an
index cached by one package loads into the other:

- ``hashes`` [M] uint64, sorted (one entry per minimizer occurrence; ties
  in (sequence, position) order, as a stable sort of the per-sequence
  minimizers concatenated in sequence order leaves them),
- ``seq_id`` [M] int32, ``pos`` [M] int32, ``strand`` [M] int8 co-sorted,
- per-sequence names and lengths (PAF tname/tlen come from here).

On the CPU the index is built with the native helpers
(:mod:`hymet_tpu_torch.io.native_io`, 1 <= k <= 31) or, where they did not
build, the numpy twin
(:func:`hymet_tpu_torch.ops.minimizer.extract_minimizers_numpy`); on the
card with the minimizer kernel (:func:`hymet_tpu_torch.ops.align_kernels.minimizers`,
rows cut at each sequence's own length) and a stable sort by hash. Both
give the numpy result.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from hymet_tpu_torch.io import native_io
from hymet_tpu_torch.io.fasta import encode_seq, iter_fasta, pack_code_batch
from hymet_tpu_torch.ops.align_kernels import minimizers
from hymet_tpu_torch.ops.hashing import SIGN
from hymet_tpu_torch.ops.minimizer import extract_minimizers_numpy
from hymet_tpu_torch.utils.device import resolve_device

ASM_K = 19  # minimap2 asm10 preset (-k19)
ASM_W = 19  # minimap2 asm10 preset (-w19)

_ROW_QUANTUM = 1024  # device build: rows padded to a multiple of this
_BATCH_POSITIONS = 1 << 25  # device build: positions a batch


@dataclass
class MinimizerIndex:
    k: int
    w: int
    hashes: np.ndarray  # [M] uint64 sorted
    seq_id: np.ndarray  # [M] int32
    pos: np.ndarray  # [M] int32
    strand: np.ndarray  # [M] int8
    names: List[str]
    lengths: np.ndarray  # [S] int64

    @property
    def n_minimizers(self) -> int:
        return int(self.hashes.shape[0])

    # ------------------------------------------------------------------

    @classmethod
    def build(
        cls,
        named_seqs: Iterable[Tuple[str, bytes]],
        k: int = ASM_K,
        w: int = ASM_W,
        device="cuda",
    ) -> "MinimizerIndex":
        dev = resolve_device(device)
        names: List[str] = []
        seqs: List[bytes] = []
        for name, seq in named_seqs:
            names.append(name)
            seqs.append(seq)
        if dev.type == "cpu":
            hashes, seq_id, pos, strand = _build_numpy(seqs, k, w)
        else:
            hashes, seq_id, pos, strand = _build_device(seqs, k, w, dev)
        return cls(
            k=k,
            w=w,
            hashes=hashes,
            seq_id=seq_id,
            pos=pos,
            strand=strand,
            names=names,
            lengths=np.asarray([len(s) for s in seqs], dtype=np.int64),
        )

    @classmethod
    def build_from_fasta(
        cls, path: str, k: int = ASM_K, w: int = ASM_W, device="cuda"
    ) -> "MinimizerIndex":
        return cls.build(iter_fasta(path), k=k, w=w, device=device)

    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        # atomic: parallel jobs share content-addressed caches, and a
        # reader must never see a half-written archive
        tmp = f"{path}.tmp.{os.getpid()}"
        np.savez_compressed(
            tmp,
            k=np.int32(self.k),
            w=np.int32(self.w),
            hashes=self.hashes,
            seq_id=self.seq_id,
            pos=self.pos,
            strand=self.strand,
            names=np.array(self.names, dtype=object),
            lengths=self.lengths,
        )
        # np.savez appends .npz when missing
        os.replace(tmp if tmp.endswith(".npz") else f"{tmp}.npz", path)

    @classmethod
    def load(cls, path: str) -> "MinimizerIndex":
        with np.load(path, allow_pickle=True) as z:
            return cls(
                k=int(z["k"]),
                w=int(z["w"]),
                hashes=z["hashes"],
                seq_id=z["seq_id"],
                pos=z["pos"],
                strand=z["strand"],
                names=[str(x) for x in z["names"]],
                lengths=z["lengths"],
            )

    def shard(self, n_shards: int) -> List["MinimizerIndex"]:
        """Split by reference sequence for the ``db`` mesh axis (minimap2's
        -I batching, but the shards are searched side by side); each
        shard numbers its sequences from 0. The bounds are the JAX
        package's, so each sequence lands in the same shard."""
        S = len(self.names)
        bounds = np.linspace(0, S, n_shards + 1).astype(int)
        out = []
        for i in range(n_shards):
            lo, hi = bounds[i], bounds[i + 1]
            mask = (self.seq_id >= lo) & (self.seq_id < hi)
            out.append(
                MinimizerIndex(
                    k=self.k,
                    w=self.w,
                    hashes=self.hashes[mask],
                    seq_id=self.seq_id[mask] - lo,
                    pos=self.pos[mask],
                    strand=self.strand[mask],
                    names=self.names[lo:hi],
                    lengths=self.lengths[lo:hi],
                )
            )
        return out


def _empty():
    return (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int8))


def _extract_minimizers_host(codes: np.ndarray, k: int, w: int):
    """The native helpers' minimizers where they built (1 <= k <= 31, one
    fewer than numpy's 32), the numpy twin's else: the same arrays."""
    if 1 <= k <= 31 and native_io.available():
        return native_io.minimizers(codes, k, w)
    return extract_minimizers_numpy(codes, k, w)


def _build_numpy(seqs: Sequence[bytes], k: int, w: int):
    h_parts, s_parts, p_parts, st_parts = [], [], [], []
    for sid, seq in enumerate(seqs):
        h, p, st = _extract_minimizers_host(encode_seq(seq), k, w)
        if h.size:
            h_parts.append(h)
            p_parts.append(p)
            st_parts.append(st)
            s_parts.append(np.full(h.shape[0], sid, dtype=np.int32))
    if not h_parts:
        return _empty()
    hashes = np.concatenate(h_parts)
    order = np.argsort(hashes, kind="stable")
    return (hashes[order], np.concatenate(s_parts)[order],
            np.concatenate(p_parts)[order], np.concatenate(st_parts)[order])


def _row_batches(lengths: Sequence[int], min_len: int) -> List[Tuple[List[int], int]]:
    """Sequences grouped by padded row length (ascending), at most
    _BATCH_POSITIONS positions and 65535 rows a batch: [(ids, L)]."""
    out: List[Tuple[List[int], int]] = []
    for i in sorted(range(len(lengths)), key=lambda i: lengths[i]):
        L = -(-max(lengths[i], min_len) // _ROW_QUANTUM) * _ROW_QUANTUM
        if out and out[-1][1] == L and (len(out[-1][0]) + 1) * L <= max(_BATCH_POSITIONS, L) \
                and len(out[-1][0]) < 65535:
            out[-1][0].append(i)
        else:
            out.append(([i], L))
    return out


def _build_device(seqs: Sequence[bytes], k: int, w: int, dev: torch.device):
    """Every sequence's minimizers with the minimizer kernel, rows cut at
    each sequence's length; then ordered by (sequence, position) and
    stably by hash."""
    parts = []
    for ids, L in _row_batches([len(s) for s in seqs], k + w - 1):
        codes = np.full((len(ids), L), 4, dtype=np.uint8)
        for row, i in enumerate(ids):
            c = encode_seq(seqs[i])
            codes[row, : c.shape[0]] = c
        packed, mask, _ = pack_code_batch(codes)
        packed = torch.from_numpy(packed).to(dev)
        mask = torch.from_numpy(mask).to(dev)
        row_len = torch.tensor([len(seqs[i]) for i in ids], dtype=torch.int32, device=dev)
        nw = len(ids) * (L - k - w + 2)
        cap = max(4096, int(nw * 2.0 / (w + 1) * 1.35))
        out = minimizers(packed, mask, L, k, w, cap, row_len)
        n = int(out[4])
        if n > cap:  # low-complexity sequence beat the estimate
            out = minimizers(packed, mask, L, k, w, n, row_len)
        h, p, st, r = (x[:n] for x in out[:4])
        sid = torch.tensor(ids, dtype=torch.int32, device=dev)[r.long()]
        parts.append((h, sid, p, st))
    if not parts or not sum(int(x[0].numel()) for x in parts):
        return _empty()
    h, sid, p, st = (torch.cat(col) for col in zip(*parts))
    order = torch.argsort((sid.to(torch.int64) << 32) | p.to(torch.int64))
    h, sid, p, st = h[order], sid[order], p[order], st[order]
    order = torch.sort(h ^ SIGN, stable=True).indices
    return (h[order].cpu().numpy().view(np.uint64), sid[order].cpu().numpy(),
            p[order].cpu().numpy(), st[order].to(torch.int8).cpu().numpy())
