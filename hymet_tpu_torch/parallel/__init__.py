"""Reference-DB sharding over a ("data", "db") mesh of devices, in one
process (counterpart of hymet_tpu.parallel): the replacement for what the
reference does with process and thread pools and minimap2 -I batching
(SURVEY.md §2.6).

Axes of the device mesh:
  - ``data``: query batches are padded to a multiple of its size (the JAX
    program streams them data-parallel);
  - ``db``: reference sketch rows and minimizer-index sequence shards;
    each shard runs the screen's and the aligner's kernels on its device.

A device may appear more than once in a mesh (one card named several
times). The multi-process path (``parallel/distributed.py``) is not
ported.
"""

from hymet_tpu_torch.parallel.collectives import sharded_topk
from hymet_tpu_torch.parallel.mesh import make_mesh
from hymet_tpu_torch.parallel.screen import ShardedScreenEngine

__all__ = ["make_mesh", "ShardedScreenEngine", "sharded_topk"]
