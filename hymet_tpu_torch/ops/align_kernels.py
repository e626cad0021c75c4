"""Hand-written CUDA kernels of the align stage, their wrappers and plain
versions.

The JAX package runs the aligner's device work as XLA programs
(``hymet_tpu/models/aligner.py``); torch has no primitive for them, so
each is a hand-written kernel here, built by :mod:`hymet_tpu_torch.ops.hash_kernels`'
one nvcc into the same library:

- :func:`minimizers` (``csrc/minimizers.cu``) — a staged batch's
  minimizers, compacted in row-major order (``extract_minimizers_jax``
  and the keep-flag compaction of ``_collect_sorted_impl``);
- :func:`anchors` (``csrc/anchors.cu``) — the index search, the anchor
  expansion with its packed sort keys, and their stable sort
  (``_search_occ`` and ``_collect_anchors_slots`` with its ``lax.sort``);
- :func:`chains` (``csrc/chains.cu``) — the chain segmentation, filter and
  compaction of the sorted anchors (``_chain_reduce_sorted``,
  ``_chain_core``).

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel (counted in ``.launches``) or raises.
Counts (``n_kept``, ``n_anchors``, ``n_chains``) stay on the device as
int64 [1] tensors, so a batch runs without a host sync.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from hymet_tpu_torch.ops.compaction import slot_fill_delta, slot_fill_mono
from hymet_tpu_torch.ops.hash_kernels import _check_device, _launch
from hymet_tpu_torch.ops.hashing import SIGN, _lsr, unpack_code_batch
from hymet_tpu_torch.ops.minimizer import extract_minimizers_torch

DIAG_OFF = 1 << 28  # |diagonal| < 268 Mbp
SEQ_BITS = 26  # k1 = qid << SEQ_BITS | seq
KEY_PAD = (1 << 63) - 1  # the sort key of a padding anchor (k1 = k2 = 0xFFFFFFFF)
KEY_BIG = 0xFFFFFFFF

# mirrors of the kernels' block shapes (csrc/minimizers.cu kMinTile,
# anchors.cu kAncThreads and SortTile, chains.cu kTile)
_MIN_TILE = 2048
_ANC_THREADS = 256
_SORT_TILE = {4: 4096, 8: 2048}  # items a sort tile, by compact key bytes
_RADIX_BITS = 8
_CHAIN_TILE = 2048
_MAX_W = 256


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _check(name: str, **tensors) -> None:
    for arg, (x, dtype, dim) in tensors.items():
        if x.dtype != dtype or x.dim() != dim:
            raise ValueError(f"{name}: {arg} must be {dtype} with {dim} dims, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


# ----------------------------------------------------------------------
# minimizers


def minimizers_torch(
    packed: torch.Tensor, mask: torch.Tensor, L: int, k: int, w: int, cap: int,
    row_len: Optional[torch.Tensor] = None,
):
    """Plain version of :func:`minimizers`: unpack, extract every window's
    minimizer, keep the kept ones in row-major order."""
    codes = unpack_code_batch(packed, mask, L)
    hi, lo, pos, strand, keep = extract_minimizers_torch(codes, k, w)
    B, nw = keep.shape
    if row_len is not None:
        windows = torch.arange(nw, device=keep.device)[None, :]
        keep = keep & (windows < (row_len.to(torch.int64) - k - w + 2)[:, None])
    sel = keep.reshape(-1).nonzero().squeeze(1)
    n_kept = torch.tensor([sel.numel()], dtype=torch.int64, device=keep.device)
    sel = sel[:cap]
    n = sel.numel()
    out_hash = torch.zeros(cap, dtype=torch.int64, device=keep.device)
    out_pos = torch.zeros(cap, dtype=torch.int32, device=keep.device)
    out_strand = torch.zeros(cap, dtype=torch.uint8, device=keep.device)
    out_row = torch.zeros(cap, dtype=torch.int32, device=keep.device)
    out_hash[:n] = ((hi << 32) | lo).reshape(-1)[sel]
    out_pos[:n] = pos.reshape(-1)[sel]
    out_strand[:n] = strand.reshape(-1)[sel].to(torch.uint8)
    out_row[:n] = (sel // nw).to(torch.int32)
    return out_hash, out_pos, out_strand, out_row, n_kept


def minimizers(
    packed: torch.Tensor, mask: torch.Tensor, L: int, k: int, w: int, cap: int,
    row_len: Optional[torch.Tensor] = None,
):
    """Minimizers of a batch (packed [B, W] 2-bit codes and mask [B, M]
    validity bits, as :func:`hymet_tpu_torch.io.fasta.pack_code_batch` and
    the staged batches hold them; rows of L positions), at k and w.

    Returns (hash int64, pos int32, strand uint8, row int32), each [cap]:
    the kept windows' minimizers in row-major window order (hash the uint64
    bit pattern of minimap2's hash64 of the canonical k-mer, pos its k-mer
    index in the row, strand 1 where the forward k-mer is above its reverse
    complement), zeros past the last; and n_kept (int64 [1]), which counts
    every kept window and exceeds `cap` on overflow. ``row_len`` (int32
    [B]) ends row r's windows at ``row_len[r] - k - w + 2``.

    A CUDA batch goes to the hand-written kernel (counted in
    ``minimizers.launches``); a CPU batch to :func:`minimizers_torch`."""
    extra = () if row_len is None else (row_len,)
    if _check_device("minimizers", packed, mask, *extra) == "cpu":
        return minimizers_torch(packed, mask, L, k, w, cap, row_len)
    _check("minimizers", packed=(packed, torch.uint8, 2), mask=(mask, torch.uint8, 2))
    if row_len is not None:
        _check("minimizers", row_len=(row_len, torch.int32, 1))
    B, W = packed.shape
    M = mask.shape[1]
    if mask.shape[0] != B or W != 2 * M or (row_len is not None and row_len.shape[0] != B):
        raise ValueError(f"minimizers: packed {tuple(packed.shape)}, mask {tuple(mask.shape)} "
                         f"and row_len do not describe one batch")
    if not 1 <= k <= 32 or not 1 <= w <= _MAX_W:
        raise ValueError(f"minimizers: need 1 <= k <= 32 and 1 <= w <= {_MAX_W}, got k={k}, w={w}")
    nw = L - k - w + 2
    if not (nw >= 1 and L <= 8 * M and L < 2**31):
        raise ValueError(f"minimizers: need k + w - 1 <= L <= {8 * M} (and < 2^31), got L={L}")
    if not 1 <= B <= 65535 or not 1 <= cap < 2**31:
        raise ValueError(f"minimizers: need 1 <= B <= 65535 and 1 <= cap < 2^31, got {B}, {cap}")
    dev = packed.device
    nb = B * _ceil(nw, _MIN_TILE)
    if nb >= 2**31:
        raise ValueError(f"minimizers: {nb} tiles of {_MIN_TILE} windows, need fewer than 2^31")
    # each tile's status word, then the tile counter (zeroed by the launch)
    status = torch.empty(nb + 1, dtype=torch.int64, device=dev)
    n_kept = torch.empty(1, dtype=torch.int64, device=dev)
    out_hash = torch.empty(cap, dtype=torch.int64, device=dev)
    out_pos = torch.empty(cap, dtype=torch.int32, device=dev)
    out_strand = torch.empty(cap, dtype=torch.uint8, device=dev)
    out_row = torch.empty(cap, dtype=torch.int32, device=dev)
    _launch("minimizers", dev, packed.data_ptr(), mask.data_ptr(), B, W, M, L, k, w,
            None if row_len is None else row_len.data_ptr(), nb, status.data_ptr(),
            n_kept.data_ptr(), cap, out_hash.data_ptr(),
            out_pos.data_ptr(), out_strand.data_ptr(), out_row.data_ptr())
    minimizers.launches += 1
    return out_hash, out_pos, out_strand, out_row, n_kept


minimizers.launches = 0


# ----------------------------------------------------------------------
# anchors


class AnchorTables(NamedTuple):
    """An index's anchor search tables on one device, and what the
    kernel's sort needs to know of them: the sorted unique hashes ``uniq``
    (int64 [U], ascending as unsigned), their run offsets ``roff`` (int32
    [U, 2]) and payload ``ps`` (int32 [M, 2] = (pos, seq << 1 | strand)),
    as :func:`hymet_tpu_torch.models.aligner.build_search_tables` makes
    them; the bucket table (int32 [2^bits + 2]:
    ``bucket[t]`` = the first u with ``uniq[u] >> shift >= t``, the last two
    entries U) and its ``shift`` = 2k - bits, as
    :func:`hymet_tpu_torch.models.aligner.build_bucket_table` makes them;
    ``n_seq`` > every seq and ``rpos_max`` >= every pos of ``ps``."""

    uniq: torch.Tensor
    roff: torch.Tensor
    ps: torch.Tensor
    bucket: torch.Tensor
    shift: int
    n_seq: int
    rpos_max: int


def anchor_tables(uniq: np.ndarray, roff: np.ndarray, ps: np.ndarray, bucket: np.ndarray,
                  shift: int, n_seq: int, device) -> AnchorTables:
    """:class:`AnchorTables` on `device` from the host's tables."""
    rpos_max = int(ps[:, 0].max()) if ps.shape[0] else 0
    return AnchorTables(*(torch.from_numpy(x).to(device) for x in (uniq, roff, ps, bucket)),
                        shift, max(1, n_seq), rpos_max)


class SortLayout(NamedTuple):
    """The kernel's compact sort key: ``qid << (sbits + vbits) | seq <<
    vbits | vpart``, only the bits of the packed key that can vary in a
    batch. ``vpart`` = ``rel << bw | (band - bmin)`` when every band is
    below 2^24 (``bw`` >= 0), else ``(rel << 24 | band) - bmin`` (``bw`` =
    -1); either is monotone in ``k2``, so the compact keys order and tie as
    the packed keys do. ``bits`` in all, held in ``key_bytes``, sorted in
    ``passes`` 8-bit digits."""

    sbits: int
    vbits: int
    bw: int
    bmin: int
    bits: int
    key_bytes: int
    passes: int

    @property
    def launches(self) -> int:
        """Device launches of one :func:`anchors` call: search, scan,
        expansion, and one a sort pass."""
        return 3 + self.passes


def sort_layout(tables: AnchorTables, B: int, L: int, band_bits: int) -> SortLayout:
    """The compact key of a batch of B rows of L positions: qid < B,
    seq < n_seq, and the diagonal in [-(L - 1), rpos_max + L - 1], so the
    band in [bmin, bmax]."""
    qbits, sbits = (B - 1).bit_length(), (tables.n_seq - 1).bit_length()
    bmin = (DIAG_OFF - (L - 1)) >> band_bits
    bmax = (DIAG_OFF + tables.rpos_max + L - 1) >> band_bits
    if bmax < 1 << 24:
        bw = (bmax - bmin).bit_length()
        vbits = bw + 1
    else:
        bw, vbits = -1, (bmax + (1 << 24) - bmin).bit_length()
    bits = qbits + sbits + vbits
    return SortLayout(sbits, vbits, bw, bmin, bits, 4 if bits <= 32 else 8,
                      -(-bits // _RADIX_BITS))


def _check_key_layout(B: int, L: int) -> None:
    """The packed keys hold a row in 6 bits (k1 = qid << 26 | seq) and a
    position in 25 (qid << 26 | pos << 1 | strand): raise for a batch that
    would wrap them."""
    if not (1 <= B <= 64 and 1 <= L <= 1 << 25):
        raise ValueError(f"anchors: the packed key layout needs 1 <= B <= 64 rows of "
                         f"1 <= L <= 2^25 positions, got B={B}, L={L}")


def bucket_lower_bound(hash_: torch.Tensor, uniq: torch.Tensor, bucket: torch.Tensor,
                       shift: int):
    """The kernel's search, step by step: each hash's bucket t (its top bits,
    ``hash >> shift``, at most 2^bits), and its lower bound lo (unsigned)
    within ``[bucket[t], bucket[t + 1])``, which is its lower bound in all
    of ``uniq``; with the entries each step reads (one tensor a step, of
    the hashes still searching). Returns (t, lo, probes)."""
    U, top_max = uniq.shape[0], bucket.shape[0] - 2
    top = _lsr(hash_, shift) if shift else hash_
    t = torch.where(top < 0, top_max, top.clamp(max=top_max))
    lo, hi = bucket[t].to(torch.int64), bucket[t + 1].to(torch.int64)
    q, ukey, probes = hash_ ^ SIGN, uniq ^ SIGN, []
    while True:
        active = lo < hi
        if not bool(active.any()):
            return t, lo, probes
        mid = (lo + hi) >> 1
        probes.append(mid[active])
        right = active & (ukey[mid.clamp(max=U - 1)] < q)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)


def bucket_search_torch(hash_: torch.Tensor, uniq: torch.Tensor, roff: torch.Tensor,
                        bucket: torch.Tensor, shift: int):
    """Plain twin of the kernel's search (:func:`bucket_lower_bound`), with
    (left, occ) as the JAX package's ``_search_occ``: ``left = roff[lo,
    0]`` (lo clipped to U - 1), ``occ`` the run length where ``uniq[lo]``
    is the hash, else 0."""
    t, lo, _ = bucket_lower_bound(hash_, uniq, bucket, shift)
    r = lo.clamp(0, uniq.shape[0] - 1)
    found = (lo < bucket[t + 1]) & (uniq[r] == hash_)
    left = roff[r, 0]
    return left, torch.where(found, roff[r, 1] - left, 0)


def anchors_torch(
    hash_: torch.Tensor, pos: torch.Tensor, strand: torch.Tensor, rows: torch.Tensor,
    n_kept: torch.Tensor, uniq: torch.Tensor, roff: torch.Tensor, ps: torch.Tensor,
    max_occ: int, band_bits: int, acap: int, B: int, L: int,
):
    """The anchors of :func:`anchors` in emission order, unsorted,
    formulated as the JAX package's default collect: one lower-bound
    search, the occurrence filter, the slot fills of
    :mod:`hymet_tpu_torch.ops.compaction`, one payload gather per anchor."""
    _check_key_layout(B, L)
    dev = hash_.device
    cap = hash_.shape[0]
    U, M = uniq.shape[0], ps.shape[0]
    valid = torch.arange(cap, device=dev) < n_kept
    lo = torch.searchsorted(uniq ^ SIGN, hash_ ^ SIGN)
    r = lo.clamp(max=U - 1)
    found = (lo < U) & (uniq[r] == hash_)
    left = roff[r, 0]
    occ = torch.where(found, roff[r, 1] - left, 0)
    occk = torch.where(valid & (occ > 0) & (occ <= max_occ), occ, 0)
    cbase = torch.cumsum(occk.to(torch.int64), 0)
    n_anchors = cbase[-1:]
    basex = cbase - occk
    occm = occk > 0
    mono = (rows.to(torch.int64) << 26) | (pos.to(torch.int64) << 1) | strand.to(torch.int64)
    fa = slot_fill_mono(mono, basex, occm, acap)
    fcol = slot_fill_delta(left - basex.to(torch.int32), basex, occm, acap)
    aiota = torch.arange(acap, device=dev)
    prow = ps[(fcol.to(torch.int64) + aiota).clamp(0, max(M - 1, 0))].to(torch.int64)
    rpos, seq, rstrand = prow[:, 0], prow[:, 1] >> 1, prow[:, 1] & 1
    aqpos = (fa >> 1) & ((1 << 25) - 1)
    rel = ((fa & 1) ^ rstrand) & 1
    diag = torch.where(rel == 0, rpos - aqpos, rpos + aqpos)
    band = ((diag + DIAG_OFF) >> band_bits) & 0xFFFFFFFF
    k1 = ((fa >> 26) << SEQ_BITS) | seq
    key = ((k1 << 32) | (rel << 24) | band) ^ SIGN
    avalid = aiota < n_anchors.clamp(max=acap)
    return (
        torch.where(avalid, key, KEY_PAD),
        torch.where(avalid, aqpos, 0).to(torch.int32),
        torch.where(avalid, rpos, 0).to(torch.int32),
        n_anchors,
    )


def sorted_anchors_torch(
    hash_: torch.Tensor, pos: torch.Tensor, strand: torch.Tensor, rows: torch.Tensor,
    n_kept: torch.Tensor, tables: AnchorTables, max_occ: int, band_bits: int, acap: int,
    B: int, L: int,
):
    """Plain version of :func:`anchors`: :func:`anchors_torch`, then
    :func:`sort_anchors`."""
    key, qpos, rpos, n_anchors = anchors_torch(
        hash_, pos, strand, rows, n_kept, tables.uniq, tables.roff, tables.ps, max_occ,
        band_bits, acap, B, L)
    return (*sort_anchors(key, qpos, rpos), n_anchors)


def anchors(
    hash_: torch.Tensor, pos: torch.Tensor, strand: torch.Tensor, rows: torch.Tensor,
    n_kept: torch.Tensor, tables: AnchorTables, max_occ: int, band_bits: int, acap: int,
    B: int, L: int,
):
    """Sorted anchors of a batch's kept minimizers (:func:`minimizers`'
    outputs for a batch of B <= 64 rows of L <= 2^25 positions: rows < B,
    pos < L; raises for a larger batch, whose packed keys would wrap)
    against an index's :class:`AnchorTables`.

    Returns (key int64, qpos int32, rpos int32), each [acap], and
    n_anchors (int64 [1], > acap on overflow): every occurrence of each
    minimizer whose hash occurs 1..max_occ times, the first acap of them in
    minimizer order, with its sort key
    ``((qid << 26 | seq) << 32 | rel << 24 | band) ^ (1 << 63)``, sorted by
    key, ties in minimizer order; past the last anchor the key ``2^63 - 1``
    and zeros.

    A CUDA input goes to the hand-written kernel (counted in
    ``anchors.launches``; :attr:`SortLayout.launches` device launches, no
    host sync); a CPU input to :func:`sorted_anchors_torch`."""
    _check_key_layout(B, L)
    args = (hash_, pos, strand, rows, n_kept)
    if _check_device("anchors", *args, tables.uniq, tables.roff, tables.ps, tables.bucket) == "cpu":
        return sorted_anchors_torch(*args, tables, max_occ, band_bits, acap, B, L)
    uniq, roff, ps, bucket = tables.uniq, tables.roff, tables.ps, tables.bucket
    _check("anchors", hash=(hash_, torch.int64, 1), pos=(pos, torch.int32, 1),
           strand=(strand, torch.uint8, 1), rows=(rows, torch.int32, 1),
           n_kept=(n_kept, torch.int64, 1), uniq=(uniq, torch.int64, 1),
           roff=(roff, torch.int32, 2), ps=(ps, torch.int32, 2), bucket=(bucket, torch.int32, 1))
    cap, U = hash_.shape[0], uniq.shape[0]
    if not (pos.shape[0] == strand.shape[0] == rows.shape[0] == cap and n_kept.shape[0] == 1):
        raise ValueError("anchors: the minimizer arrays differ in length")
    if roff.shape != (U, 2) or ps.dim() != 2 or ps.shape[1] != 2 or ps.shape[0] < 1:
        raise ValueError(f"anchors: need roff [U, 2] and ps [M >= 1, 2], got "
                         f"{tuple(roff.shape)}, {tuple(ps.shape)}")
    n_buckets = bucket.shape[0] - 2
    if not (n_buckets >= 1 and 0 <= tables.shift <= 63 and tables.n_seq <= 1 << SEQ_BITS):
        raise ValueError(f"anchors: need a bucket table of 2^bits + 2 entries, 0 <= shift "
                         f"<= 63 and n_seq <= 2^{SEQ_BITS}, got {bucket.shape[0]}, "
                         f"{tables.shift}, {tables.n_seq}")
    if not (1 <= cap < 2**31 and 1 <= U < 2**31 and 1 <= acap < 2**31):
        raise ValueError(f"anchors: need 1 <= cap, U, acap < 2^31, got {cap}, {U}, {acap}")
    if not 1 <= band_bits <= 24 or max_occ < 1:
        raise ValueError(f"anchors: need 1 <= band_bits <= 24 and max_occ >= 1, got "
                         f"{band_bits}, {max_occ}")
    if DIAG_OFF + tables.rpos_max + L > 2**31:
        raise ValueError(f"anchors: the diagonal of a reference position {tables.rpos_max} "
                         f"and a row of {L} wraps 32 bits")
    lay = sort_layout(tables, B, L, band_bits)
    dev = hash_.device
    nb = _ceil(cap, _ANC_THREADS)
    tiles = _ceil(acap, _SORT_TILE[lay.key_bytes])
    kdt = torch.int32 if lay.key_bytes == 4 else torch.int64

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    occk, left, block_sums, offsets = empty(cap), empty(cap), empty(nb), empty(nb, dtype=torch.int64)
    key_u, qpos_u, rpos_u = empty(acap, dtype=torch.int64), empty(acap), empty(acap)
    ck, kbuf, vbuf = empty(acap, dtype=kdt), empty(acap, dtype=kdt), empty(2, acap)
    published = empty(lay.passes, tiles, 1 << _RADIX_BITS)
    totals, tile_counter = empty(lay.passes, 1 << _RADIX_BITS), empty(lay.passes)
    n_anchors = empty(1, dtype=torch.int64)
    key, qpos, rpos = empty(acap, dtype=torch.int64), empty(acap), empty(acap)
    _launch("anchors", dev, hash_.data_ptr(), pos.data_ptr(), strand.data_ptr(),
            rows.data_ptr(), n_kept.data_ptr(), cap, uniq.data_ptr(), bucket.data_ptr(),
            n_buckets, tables.shift, roff.data_ptr(), ps.data_ptr(), max_occ, band_bits,
            lay.sbits, lay.vbits, lay.bw, lay.bmin, lay.key_bytes, lay.passes, nb, tiles,
            occk.data_ptr(), left.data_ptr(), block_sums.data_ptr(), offsets.data_ptr(),
            n_anchors.data_ptr(), acap, key_u.data_ptr(), qpos_u.data_ptr(), rpos_u.data_ptr(),
            ck.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), published.data_ptr(),
            totals.data_ptr(), tile_counter.data_ptr(), key.data_ptr(), qpos.data_ptr(),
            rpos.data_ptr())
    anchors.launches += 1
    return key, qpos, rpos, n_anchors


anchors.launches = 0


def sort_anchors(key: torch.Tensor, qpos: torch.Tensor, rpos: torch.Tensor):
    """Anchors in key order, ties in slot order (``lax.sort``'s stable
    order of the JAX package's (k1, k2, iota))."""
    skey, perm = torch.sort(key, stable=True)
    return skey, qpos[perm], rpos[perm]


# ----------------------------------------------------------------------
# chains


def chains_torch(
    skey: torch.Tensor, s_p: torch.Tensor, s_r: torch.Tensor, k: int, min_cnt: int,
    min_mlen: int, ccap: int,
):
    """Plain version of :func:`chains`: segment ids from the break flags,
    per-segment counts, extents and score by scatter reductions, the good
    segments' rows in order."""
    dev = skey.device
    raw = skey ^ SIGN
    k1, k2 = _lsr(raw, 32), raw & 0xFFFFFFFF
    rel, band = (k2 >> 24) & 0xF, k2 & 0xFFFFFF
    same = (k1[1:] == k1[:-1]) & (rel[1:] == rel[:-1]) & (((band[1:] - band[:-1]) & 0xFFFFFFFF) <= 1)
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ~same])
    seg = torch.cumsum(start.to(torch.int64), 0) - 1
    firsts = start.nonzero().squeeze(1)
    nseg = firsts.numel()
    p, r = s_p.to(torch.int64), s_r.to(torch.int64)

    def reduce(x, how, fill):
        return torch.full((nseg,), fill, dtype=torch.int64, device=dev).scatter_reduce(
            0, seg, x, how, include_self=False)

    minq, maxq = reduce(p, "amin", 0), reduce(p, "amax", 0)
    minr, maxr = reduce(r, "amin", 0), reduce(r, "amax", 0)
    cnt = torch.bincount(seg, minlength=nseg)
    dq = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), p[1:] - p[:-1]])
    contrib = torch.where(start, k, dq.clamp(0, k))
    score = torch.zeros(nseg, dtype=torch.int64, device=dev).index_add_(0, seg, contrib)
    mlen = torch.minimum(cnt * k, maxq - minq + k)
    good = (k2[firsts] != KEY_BIG) & (cnt >= min_cnt) & (mlen >= min_mlen)
    g = good.nonzero().squeeze(1)
    n_chains = torch.tensor([g.numel()], dtype=torch.int64, device=dev)
    g = g[:ccap]
    first = firsts[g]
    cols = [k1[first] >> SEQ_BITS, k1[first] & ((1 << SEQ_BITS) - 1), rel[first],
            cnt[g], minq[g], maxq[g], minr[g], maxr[g], score[g]]
    out = torch.zeros((ccap, 9), dtype=torch.int32, device=dev)
    out[: g.numel()] = torch.stack(cols, 1).to(torch.int32)
    return out, n_chains


def chains(
    skey: torch.Tensor, s_p: torch.Tensor, s_r: torch.Tensor, k: int, min_cnt: int,
    min_mlen: int, ccap: int,
):
    """Chains of sorted anchors (:func:`anchors`' outputs): anchor
    i + 1 continues anchor i's chain when qid, seq and rel are equal and
    its band is at most one above. Returns the good chains' rows
    (qid, seq, rel, cnt, minq, maxq, minr, maxr, score) as int32
    [ccap, 9] in anchor order, zeros past the last, and n_chains (int64
    [1], > ccap on overflow). A chain is good when cnt >= min_cnt and
    min(cnt * k, maxq - minq + k) >= min_mlen; score = k + the sum of its
    anchors' qpos steps clipped to [0, k].

    A CUDA input goes to the hand-written kernel (counted in
    ``chains.launches``); a CPU input to :func:`chains_torch`."""
    if _check_device("chains", skey, s_p, s_r) == "cpu":
        return chains_torch(skey, s_p, s_r, k, min_cnt, min_mlen, ccap)
    _check("chains", skey=(skey, torch.int64, 1), s_p=(s_p, torch.int32, 1),
           s_r=(s_r, torch.int32, 1))
    A = skey.shape[0]
    if not (s_p.shape[0] == s_r.shape[0] == A and 1 <= A < 2**31 and 1 <= ccap < 2**31):
        raise ValueError(f"chains: need equal lengths and 1 <= A, ccap < 2^31, got "
                         f"{A}, {s_p.shape[0]}, {s_r.shape[0]}, {ccap}")
    dev = skey.device
    nb = _ceil(A, _CHAIN_TILE)
    agg = torch.empty((nb, 8), dtype=torch.int32, device=dev)
    block_sums = torch.empty(nb, dtype=torch.int32, device=dev)
    offsets = torch.empty(nb, dtype=torch.int64, device=dev)
    n_chains = torch.empty(1, dtype=torch.int64, device=dev)
    rows = torch.empty((A, 8), dtype=torch.int32, device=dev)
    out = torch.empty((ccap, 9), dtype=torch.int32, device=dev)
    _launch("chains", dev, skey.data_ptr(), s_p.data_ptr(), s_r.data_ptr(), A, k, min_cnt,
            min_mlen, nb, agg.data_ptr(), block_sums.data_ptr(), offsets.data_ptr(),
            n_chains.data_ptr(), rows.data_ptr(), ccap, out.data_ptr())
    chains.launches += 1
    return out, n_chains


chains.launches = 0


class AlignOps(NamedTuple):
    """The align stage's three device functions, as the aligner calls them."""

    minimizers: Callable
    anchors: Callable
    chains: Callable


KERNELS = AlignOps(minimizers, anchors, chains)
PLAIN = AlignOps(minimizers_torch, sorted_anchors_torch, chains_torch)
