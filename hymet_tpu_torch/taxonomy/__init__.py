"""In-process NCBI taxonomy component (copy of hymet_tpu.taxonomy).

Replaces every external taxonomy dependency of the reference pipeline:

- ``taxonkit name2taxid`` / ``taxonkit reformat`` subprocesses
  (reference ``tools/hymet2cami.py:61-102``, ``tools/eval_cami.py:110-132``),
- ``scripts/taxonomy_hierarchy.py`` (names.dmp/nodes.dmp -> hierarchy TSV),
- the 8-rank lineage codec of ``scripts/classification_cami.py:104-156``.
"""

from hymet_tpu_torch.taxonomy.db import TaxonomyDB
from hymet_tpu_torch.taxonomy.lineage import (
    lineage_to_rank_names,
    rank_names_to_lineage,
)

__all__ = [
    "TaxonomyDB",
    "lineage_to_rank_names",
    "rank_names_to_lineage",
]
