"""Upload-once contig staging (counterpart of hymet_tpu.pipeline.staged).

The contigs are packed ONCE, in the aligner's (<= 64-row, geometric pad
bucket) layout (:func:`hymet_tpu_torch.models.aligner.plan_query_groups`),
and uploaded to the device, where the screen and the aligner consume the
resident buffers. The whole-contig rows carry the
same k-mer multiset as the screen's chunked layout, so screen results
are identical either way.

Tight upload + device repack: the per-contig 2-bit segments cross the
link concatenated (each on a 128-byte grid), and a small device step
expands them into the padded [rows, Lpad/4] layout. The validity bitmask
is derived on the device from contig lengths for rows without ambiguous
bases; rows with N codes upload their mask segments too. The buffers are
byte-identical to packing the padded batch on the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hymet_tpu_torch.io.fasta import encode_seq, pack_code_batch
from hymet_tpu_torch.models.aligner import (
    build_group_batch,
    group_rows,
    pad_query_len,
    plan_query_groups,
)
from hymet_tpu_torch.utils.device import resolve_device

_ALIGN = 128  # per-row segment alignment in the tight buffer


def _quantize(n: int, quantum: int) -> int:
    return -(-max(n, 1) // quantum) * quantum


def _cap_quantum(need: int) -> int:
    """Capacity quantum for tight buffers: 1/8 of the floor power of two."""
    return max(1 << 14, (1 << (max(need, 1).bit_length() - 1)) >> 3)


def _expand(tight: torch.Tensor, off: torch.Tensor, rlen: torch.Tensor, width: int) -> torch.Tensor:
    """[rows, width] padded rows from per-row tight segments: each row
    gathers width/ALIGN consecutive 128-byte chunks from its offset;
    bytes past the row's own segment are zeroed."""
    chunks = tight.reshape(-1, _ALIGN)
    idx = (off // _ALIGN)[:, None] + torch.arange(width // _ALIGN, device=tight.device)[None, :]
    out = chunks[idx].reshape(off.shape[0], width)
    j = torch.arange(width, device=tight.device)
    return torch.where(j[None, :] < rlen[:, None], out, torch.zeros_like(out))


def repack(tight_p, offp, plen, tight_m, offm, mlen, nlen, W: int, M: int):
    """Device repack of one group: (packed [rows, W], mask [rows, M]).
    Rows without ambiguous bases (mlen == 0) derive their prefix bitmask
    from the contig length: byte b = (1 << clip(n - 8b, 0, 8)) - 1."""
    packed = _expand(tight_p, offp, plen, W)
    b = torch.arange(M, dtype=torch.int32, device=nlen.device)
    rem = (nlen[:, None] - 8 * b[None, :]).clamp(0, 8)
    dmask = (torch.bitwise_left_shift(torch.ones_like(rem), rem) - 1).to(torch.uint8)
    gmask = _expand(tight_m, offm, mlen, M)
    return packed, torch.where((mlen > 0)[:, None], gmask, dmask)


class StagedContigs:
    """Per-contig padded code batches, packed 2-bit, resident on the device
    (``dev``, from the `device` argument).

    ``device[gi]`` is the ``(packed, mask, rows, L)`` tuple of one batch
    (the JAX package's name for it); ``groups[gi]`` lists the query
    indices in that batch (row order)."""

    def __init__(
        self,
        names: Sequence[str],
        seqs: Sequence[bytes],
        batch_pad: int,
        min_len: int,
        device="cuda",
    ) -> None:
        self.dev = resolve_device(device)
        self.n_seqs = len(seqs)
        self.batch_pad = batch_pad
        self.min_len = min_len
        self.groups, self.fixed_rows = plan_query_groups(
            [len(s) for s in seqs], batch_pad, min_len
        )
        self.device: List[Tuple] = []
        total = 0
        for group in self.groups:
            batch, nbytes = self._stage_tight(seqs, group)
            total += nbytes
            self.device.append(batch)
        self.packed_bytes = total

    def _up(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.dev)

    def _stage_tight(self, seqs, group):
        """One group via tight upload + device repack."""
        Lpad = pad_query_len(
            max(max(len(seqs[i]) for i in group), self.min_len), self.batch_pad
        )
        rows = group_rows(len(group), self.fixed_rows)
        W, M = Lpad // 4, Lpad // 8
        if W % _ALIGN or M % _ALIGN:
            # the chunk gather needs row widths on the 128-byte grid (true for
            # every batch_pad >= 1024): pack the padded batch on the host
            batch = build_group_batch(
                seqs, group, self.batch_pad, self.min_len, self.fixed_rows
            )
            packed, mask, L = pack_code_batch(batch)
            return (
                (self._up(packed), self._up(mask), batch.shape[0], L),
                packed.nbytes + mask.nbytes,
            )
        offp = np.zeros(rows, dtype=np.int32)
        plen = np.zeros(rows, dtype=np.int32)
        offm = np.zeros(rows, dtype=np.int32)
        mlen = np.zeros(rows, dtype=np.int32)
        nlen = np.zeros(rows, dtype=np.int32)
        psegs: List[np.ndarray] = []
        msegs: List[Tuple[int, np.ndarray]] = []
        po = mo = 0
        for row, i in enumerate(group):
            codes = encode_seq(seqs[i])
            p_i, m_i, _ = pack_code_batch(codes[None, :])
            p_i, m_i = p_i[0], m_i[0]
            offp[row], plen[row] = po, p_i.nbytes
            nlen[row] = codes.size
            psegs.append(p_i)
            po += _quantize(p_i.nbytes, _ALIGN)
            # mask segments ship only for rows with ambiguous bases
            if codes.size and int(codes.max()) >= 4:
                offm[row], mlen[row] = mo, m_i.nbytes
                msegs.append((mo, m_i))
                mo += _quantize(m_i.nbytes, _ALIGN)
        # capacity: + one row width so the last row's chunk gather stays
        # inside the buffer
        TP = _quantize(po + W, _cap_quantum(po + W))
        tight_p = np.zeros(TP, dtype=np.uint8)
        for o, seg in zip(offp[: len(group)], psegs):
            tight_p[o : o + seg.nbytes] = seg
        TM = _quantize(mo + M, _cap_quantum(max(mo, 1)))
        tight_m = np.zeros(TM, dtype=np.uint8)
        for o, seg in msegs:
            tight_m[o : o + seg.nbytes] = seg
        packed, mask = repack(
            self._up(tight_p), self._up(offp), self._up(plen),
            self._up(tight_m), self._up(offm), self._up(mlen), self._up(nlen),
            W, M,
        )
        return (packed, mask, rows, Lpad), TP + TM

    def matches(self, n_seqs: int, batch_pad: int, min_len: int) -> bool:
        """Whether these batches are the plan of `n_seqs` queries at
        `batch_pad` and `min_len` (the aligner uses them only then)."""
        return (
            n_seqs == self.n_seqs
            and batch_pad == self.batch_pad
            and min_len == self.min_len
        )
