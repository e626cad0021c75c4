"""Device mesh construction (counterpart of hymet_tpu.parallel.mesh).

A :class:`Mesh` is a [data, db] grid of ``torch.device`` s. A device may
appear more than once: one card named eight times is the port's
counterpart of XLA's virtual host devices (the CPU tests use
``["cpu"] * 8``).

Under a process group (:mod:`hymet_tpu_torch.parallel.distributed`) the
grid spans every process: each process names its own devices, the global
list orders them by process and then by local index (the order of
``jax.devices()``), and each entry records its owner. A process holds a
``torch.device`` only for the entries it owns; the others are None.
:func:`fetch_global` and :func:`fetch_global_tree` then gather every
process's local pieces, so that every process gets the whole value.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hymet_tpu_torch.parallel.distributed import all_gather, local_card, process_count, process_index
from hymet_tpu_torch.utils.device import resolve_device


class Mesh:
    """[data, db] grid of devices; ``shape == {"data": d, "db": b}``.
    ``owners`` is the same grid of process indices (all this process's by
    default); ``devices`` holds None where another process owns the entry."""

    def __init__(self, devices: Sequence[Sequence[Optional[torch.device]]],
                 owners: Optional[Sequence[Sequence[int]]] = None):
        self.devices: List[List[Optional[torch.device]]] = [list(row) for row in devices]
        self.owners: List[List[int]] = (
            [list(row) for row in owners] if owners is not None
            else [[process_index()] * len(row) for row in self.devices])
        self.shape = {"data": len(self.devices), "db": len(self.devices[0])}

    @property
    def db_devices(self) -> List[Optional[torch.device]]:
        """The first data row's devices: where each db shard runs. The
        other rows are data replicas, which would compute the same thing
        again."""
        return self.devices[0]

    @property
    def local_shards(self) -> List[int]:
        """The db shards whose first-data-row device this process owns."""
        me = process_index()
        return [i for i, owner in enumerate(self.owners[0]) if owner == me]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]}, "
                f"owners={self.owners})")


def global_devices(local=None) -> Tuple[List[Optional[torch.device]], List[int]]:
    """(devices, owners) of every process's `local` devices, in process
    order and then local order; devices another process owns are None.
    Collective under a process group. `local` defaults to every visible
    card in one process and to :func:`local_card` in a group; resolving a
    card raises where there is none."""
    if local is None:
        if process_count() > 1:
            local = [local_card()]
        else:
            if not torch.cuda.is_available():
                resolve_device("cuda")  # raises: no card
            local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [resolve_device(d) for d in local]
    me = process_index()
    devices: List[Optional[torch.device]] = []
    owners: List[int] = []
    for rank, n in enumerate(all_gather(len(local))):
        devices += local if rank == me else [None] * n
        owners += [rank] * n
    return devices, owners


def make_mesh(
    data: Optional[int] = None, db: Optional[int] = None, devices=None, owners=None
) -> Mesh:
    """2D ("data", "db") mesh over `devices`: this process's devices (see
    :func:`global_devices`; the mesh spans every process of a group), or,
    with `owners`, a global list from :func:`global_devices`.

    Defaults: put everything on "db" (reference sharding is the usual
    memory constraint) unless data is given. data * db must equal the
    number of devices.
    """
    if owners is None:
        devs, owners = global_devices(devices)
    else:
        devs = [None if d is None else resolve_device(d) for d in devices]
    n = len(devs)
    if data is None and db is None:
        data, db = 1, n
    elif data is None:
        data = n // db
    elif db is None:
        db = n // data
    if data * db != n or n == 0 or len(owners) != n:
        raise ValueError(f"mesh {data}x{db} != {n} devices")
    return Mesh([devs[r * db : (r + 1) * db] for r in range(data)],
                [list(owners[r * db : (r + 1) * db]) for r in range(data)])


def _host(x):
    """Host numpy copy of a tree of tensors, arrays and scalars."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    return _leaf(x)


def _leaf(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _merge(parts: list):
    """Every process's host tree (same structure) -> one tree: dicts
    united (keys sorted), tuples and lists element by element, arrays
    concatenated along axis 0 in process order (scalars stacked)."""
    first = parts[0]
    if isinstance(first, dict):
        out = {}
        for p in parts:
            out.update(p)
        return {k: out[k] for k in sorted(out)}
    if isinstance(first, (tuple, list)):
        return type(first)(_merge([p[i] for p in parts]) for i in range(len(first)))
    if first.ndim == 0:
        return np.stack(parts)
    return np.concatenate(parts)


def fetch_global(x) -> np.ndarray:
    """Host copy of a tensor. In a process group, `x` is this process's
    local piece (its shards along axis 0, possibly none): every process
    must call, and each gets the pieces joined in process order, which is
    global shard order (see :func:`fetch_global_tree`)."""
    if process_count() > 1:
        return _merge(all_gather(_leaf(x)))
    return _leaf(x)


def fetch_global_tree(xs):
    """:func:`fetch_global` over a tuple, list or dict of tensors (nested),
    in one collective round in a process group. There a dict holds this
    process's entries, keyed by shard index, and comes back holding every
    process's, keys sorted; an array comes back joined along axis 0 in
    process order."""
    if process_count() > 1:
        return _merge(all_gather(_host(xs)))
    return _host(xs)
