"""Multi-process initialization (counterpart of
hymet_tpu.parallel.distributed).

Scaling past one process means a ``torch.distributed`` process group and
the same ("data", "db") mesh spanning every process's devices
(:func:`hymet_tpu_torch.parallel.mesh.make_mesh`). What crosses processes
is host data — screen rows, each aligner group's counts and chain rows —
so the group runs on gloo: it needs no card, and it takes two ranks that
drive one card, which NCCL refuses. Process 0 writes the canonical
outputs (:class:`hymet_tpu_torch.pipeline.run.ClassificationRun`).

Launch one process a card with ``torchrun --nproc-per-node=N script.py``
(the script calls :func:`init_distributed` with no arguments), or start
the processes yourself and pass ``init_distributed("127.0.0.1:29500",
num_processes=N, process_id=i)``; each process calls :func:`shutdown`
before it exits.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("hymet_tpu_torch.distributed")

# how long a collective waits for its peers: longer than any stage's skew
# between processes (a cold cache builds the reference and its index), so
# that a peer that died fails the others instead of hanging them
DEFAULT_TIMEOUT_S = 1800.0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Start a gloo process group from the arguments or torchrun's
    variables (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    ``coordinator_address`` is ``host:port`` of process 0. With none of
    them set, starts nothing. Returns True when running multi-process.

    Raises if the group cannot form within :data:`DEFAULT_TIMEOUT_S`; the
    same limit holds for every collective after."""
    if dist.is_initialized():
        return process_count() > 1
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if not (coordinator_address or num_processes):
        return False
    if not (coordinator_address and num_processes and process_id is not None):
        raise ValueError(
            f"init_distributed needs an address, a process count and a process id "
            f"(got {coordinator_address!r}, {num_processes!r}, {process_id!r})")
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
    )
    logger.info("distributed: process %d/%d", process_index(), process_count())
    return process_count() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def local_card() -> torch.device:
    """The card this process drives by default in a group: ``LOCAL_RANK``'s
    (torchrun sets it), else the process index's, over the visible cards."""
    rank = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def all_gather(obj) -> list:
    """Every process's `obj` (picklable), in process order; ``[obj]`` in
    one process."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (the counterpart of
    ``jax.distributed.shutdown``): a barrier, then the group's destruction,
    so that no process exits while a peer still talks to it. Call it
    before a process of a group exits: a gloo group left to the
    interpreter's exit can abort the process."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
