"""Device mesh construction (counterpart of hymet_tpu.parallel.mesh, one
process).

A :class:`Mesh` is a [data, db] grid of ``torch.device`` s. A device may
appear more than once: one card named eight times is the port's
counterpart of XLA's virtual host devices (the CPU tests use
``["cpu"] * 8``). The multi-process branch of the JAX package's
``fetch_global`` (``jax.distributed``) is not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from hymet_tpu_torch.utils.device import resolve_device


class Mesh:
    """[data, db] grid of devices; ``shape == {"data": d, "db": b}``."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices: List[List[torch.device]] = [list(row) for row in devices]
        self.shape = {"data": len(self.devices), "db": len(self.devices[0])}

    @property
    def db_devices(self) -> List[torch.device]:
        """The first data row's devices: where each db shard runs. The
        other rows are data replicas, which would compute the same thing
        again."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]})"


def make_mesh(
    data: Optional[int] = None, db: Optional[int] = None, devices=None
) -> Mesh:
    """2D ("data", "db") mesh over `devices` (default: every visible card;
    raises where there is none).

    Defaults: put everything on "db" (reference sharding is the usual
    memory constraint) unless data is given. data * db must equal the
    number of devices.
    """
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")  # raises: no card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if data is None and db is None:
        data, db = 1, n
    elif data is None:
        data = n // db
    elif db is None:
        db = n // data
    if data * db != n or n == 0:
        raise ValueError(f"mesh {data}x{db} != {n} devices")
    return Mesh([devs[r * db : (r + 1) * db] for r in range(data)])


def fetch_global(x) -> np.ndarray:
    """Host copy of a tensor (the single-process branch of the JAX
    package's ``fetch_global``)."""
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


def fetch_global_tree(xs):
    """:func:`fetch_global` over a tuple, list or dict of tensors."""
    if isinstance(xs, dict):
        return {k: fetch_global(v) for k, v in xs.items()}
    return type(xs)(fetch_global(x) for x in xs)
