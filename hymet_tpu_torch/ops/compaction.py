"""Slot compaction by destination-map inversion (counterpart of the
default members of hymet_tpu.ops.compaction).

A stream of N rows each owns ``occ[n] >= 0`` items, and the items compact
densely into a ``[cap]`` buffer in row-major order: row n's item j lands
at ``basex[n] + j``, with ``basex`` the exclusive cumsum of ``occ``. The
plain anchor collect (:func:`hymet_tpu_torch.ops.align_kernels.anchors_torch`)
fills its slots with :func:`slot_fill_mono` and :func:`slot_fill_delta`,
as the JAX package's default collect does. Torch has ``searchsorted``,
``cumsum`` and ``cummax``; the outputs equal the JAX functions', not their
formulation.
"""

from __future__ import annotations

from typing import Tuple

import torch


def searchsorted_right(arr: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """First index where ``arr[i] > q`` per query (``np.searchsorted(arr,
    q, "right")`` for sorted ``arr``), int32."""
    return torch.searchsorted(arr, q.to(arr.dtype), right=True).to(torch.int32)


def slot_compact_map(occ: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Invert ``dst(n, j) = basex[n] + j`` for the first `cap` slots.

    Returns ``(n_i, basex, n_items)``: each slot's source row (the last row
    with ``basex <= p``, clipped to [0, N-1]; rows of slots past
    ``n_items`` are clamped, as the JAX function's "bsearch" method gives
    them), the exclusive base of each row, and the item total (``> cap``
    means overflow)."""
    n = occ.shape[0]
    cbase = torch.cumsum(occ.to(torch.int64), 0)
    n_items = cbase[-1]
    basex = (cbase - occ).to(torch.int32)
    p = torch.arange(cap, dtype=torch.int32, device=occ.device)
    n_i = (searchsorted_right(basex, p) - 1).clamp(0, n - 1)
    return n_i, basex, n_items.to(torch.int32)


def _scatter_bases(vals: torch.Tensor, basex: torch.Tensor, occupied: torch.Tensor, cap: int) -> torch.Tensor:
    """[cap] int64 zeros holding each occupied row's value at its base slot
    (bases at or past `cap` dropped)."""
    at = occupied & (basex < cap)
    out = torch.zeros(cap, dtype=torch.int64, device=vals.device)
    out[basex[at].long()] = vals[at].to(torch.int64)
    return out


def slot_fill_mono(mono: torch.Tensor, basex: torch.Tensor, occupied: torch.Tensor, cap: int) -> torch.Tensor:
    """Fill a NON-DECREASING per-row uint32 value (held in int64) over the
    slot-compaction output: each occupied row's value at its base slot,
    forward-filled by a running max. Slots past the end repeat the last
    value."""
    return torch.cummax(_scatter_bases(mono, basex, occupied, cap), 0).values


def slot_fill_delta(vals: torch.Tensor, basex: torch.Tensor, occupied: torch.Tensor, cap: int) -> torch.Tensor:
    """Fill an ARBITRARY per-row int32 value over the slot-compaction
    output: each occupied row's difference to the previous occupied row's
    value at its base slot, then a cumsum (exact in int64). int32."""
    n = vals.shape[0]
    idx = torch.where(occupied, torch.arange(n, device=vals.device), -1)
    last = torch.cummax(idx, 0).values  # last occupied row at or before n
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    v = vals.to(torch.int64)
    base = torch.where(prev >= 0, v[prev.clamp(min=0)], 0)
    delta = torch.where(occupied, v - base, 0)
    return torch.cumsum(_scatter_bases(delta, basex, occupied, cap), 0).to(torch.int32)
