"""Reference-DB sharding over a ("data", "db") mesh of devices
(counterpart of hymet_tpu.parallel): the replacement for what the
reference does with process and thread pools and minimap2 -I batching
(SURVEY.md §2.6).

Axes of the device mesh:
  - ``data``: query batches are padded to a multiple of its size (the JAX
    program streams them data-parallel);
  - ``db``: reference sketch rows and minimizer-index sequence shards;
    each shard runs the screen's and the aligner's kernels on its device.

A device may appear more than once in a mesh (one card named several
times). The mesh may span several processes
(:mod:`hymet_tpu_torch.parallel.distributed`): each shard then runs in
the process that owns its device, and the host gathers cross processes.
"""

from hymet_tpu_torch.parallel.collectives import sharded_topk
from hymet_tpu_torch.parallel.distributed import (
    init_distributed,
    is_primary,
    process_count,
    process_index,
    shutdown,
)
from hymet_tpu_torch.parallel.mesh import fetch_global, fetch_global_tree, make_mesh
from hymet_tpu_torch.parallel.screen import ShardedScreenEngine

__all__ = [
    "make_mesh", "ShardedScreenEngine", "sharded_topk", "init_distributed", "is_primary",
    "process_count", "process_index", "shutdown", "fetch_global", "fetch_global_tree",
]
