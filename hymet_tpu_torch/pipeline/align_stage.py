"""The align stage (counterpart of hymet_tpu.pipeline.run.ClassificationRun._stage_align):
the candidate references' minimizer index, the contigs mapped onto it,
``resultados.paf``.

    run_align_stage(combined_fasta, names, seqs, workdir, cfg, staged=staged)

- ``resultados.paf`` already in `workdir` and not empty: nothing is done;
- the index is cached beside the reference FASTA as
  ``reference_minidx_k{k}w{w}.npz`` (the JAX package's name and file, so
  either package's cache serves the other); a cache that does not load,
  or holds another k or w, is rebuilt, as is every cache under
  ``cfg.force_download``;
- the contigs go through :meth:`MinimizerAligner.map_batch`, on the staged
  batches when `staged` holds this plan, with `aligner` when the caller
  holds one on this reference's index (the run's resident cache);
- with a ``mesh`` the index shards over it
  (:class:`~hymet_tpu_torch.parallel.align.ShardedMinimizerAligner`) and
  the contigs map unstaged.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

from hymet_tpu_torch.io.minimizer_index import MinimizerIndex
from hymet_tpu_torch.io.paf import write_paf
from hymet_tpu_torch.models.aligner import AlignerConfig, MinimizerAligner
from hymet_tpu_torch.parallel.align import ShardedMinimizerAligner
from hymet_tpu_torch.utils.config import RunConfig

logger = logging.getLogger("hymet_tpu_torch.align")


def index_cache_path(combined_fasta: str, cfg: RunConfig) -> str:
    return os.path.join(
        os.path.dirname(combined_fasta), f"reference_minidx_k{cfg.align_k}w{cfg.align_w}.npz"
    )


def load_or_build_index(combined_fasta: str, cfg: RunConfig, device="cuda") -> MinimizerIndex:
    """The cached index when it loads and has cfg's k and w; else one built
    from the FASTA (on `device`) and saved."""
    path = index_cache_path(combined_fasta, cfg)
    if os.path.exists(path) and not cfg.force_download:
        try:
            index = MinimizerIndex.load(path)
        except Exception as e:  # noqa: BLE001 — any unreadable cache is rebuilt
            logger.warning("cached index unreadable (%s); rebuilding", e)
        else:
            if index.k == cfg.align_k and index.w == cfg.align_w:
                logger.info("cached minimizer index: %s", path)
                return index
            logger.warning("cached index k/w mismatch; rebuilding")
    index = MinimizerIndex.build_from_fasta(combined_fasta, k=cfg.align_k, w=cfg.align_w,
                                            device=device)
    index.save(path)
    return index


def run_align_stage(
    combined_fasta: str,
    names: Sequence[str],
    seqs: Sequence[bytes],
    workdir: str,
    cfg: Optional[RunConfig] = None,
    *,
    staged=None,
    device="cuda",
    aligner=None,
    mesh=None,
) -> str:
    """Map the contigs (`names`, `seqs`) onto the references of
    `combined_fasta`; returns the path of ``workdir/resultados.paf``."""
    cfg = cfg or RunConfig()
    paf_path = os.path.join(workdir, "resultados.paf")
    if os.path.exists(paf_path) and os.path.getsize(paf_path) > 0:
        logger.info("PAF exists; skipping alignment")
        return paf_path
    if aligner is None:
        index = load_or_build_index(combined_fasta, cfg, device)
        aln_cfg = AlignerConfig(batch_pad=cfg.align_batch_pad)
        aligner = (ShardedMinimizerAligner(mesh, index, aln_cfg) if mesh is not None
                   else MinimizerAligner(index, aln_cfg, device=device))
    if mesh is not None:
        records = aligner.map_batch(names, seqs)
    else:
        records = aligner.map_batch(names, seqs, staged=staged)
    os.makedirs(workdir, exist_ok=True)
    write_paf(paf_path, records)
    logger.info("alignment rows: %d", len(records))
    return paf_path
