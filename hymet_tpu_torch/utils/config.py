"""Run configuration: the fields of hymet_tpu's ``RunConfig``, with the same
names and defaults (the reference batch script's env-var contract,
``run_hymet_cami.sh:23-38``, plus the package's own), save one:
``classifier_backend`` defaults to ``"device"``, the port's name for the
backend the JAX package calls ``"jax"`` (which is accepted as the same, so
a reference config runs unchanged)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class RunConfig:
    # reference env-var contract (run_hymet_cami.sh:23-38)
    input_fasta: str = ""
    outdir: str = "out/run"
    threads: int = 8
    cand_max: int = 5000
    species_dedup: bool = False
    assembly_summary_dir: Optional[str] = None
    cand_limit_log: Optional[str] = None
    mash_thresh: float = 0.9  # initial screen threshold (mash.sh -t analog)
    force_download: bool = False  # rebuild cached references and indexes
    cache_root: str = "data/cache"
    taxonomy_dir: Optional[str] = None  # TAXONKIT_DB analog: taxdump or hierarchy TSV dir

    sketch_dbs: List[str] = field(default_factory=list)  # .npz sketch DBs
    genome_catalog: Optional[str] = None  # refs.tsv or genome dir (offline source)
    # preset combined reference (the "subset reference" mode: skip
    # candidate-driven reference building entirely)
    reference_fasta: Optional[str] = None
    seqid2taxid: Optional[str] = None
    allow_download: bool = False
    sketch_k: int = 21
    sketch_size: int = 1000
    align_k: int = 19
    align_w: int = 19
    classifier_backend: str = "device"  # device (= jax) | host
    db_shards: int = 1  # reference-DB sharding across devices (one card: 1)
    screen_chunk_bp: int = 1 << 20  # query streaming chunk (chunked screen path)
    align_batch_pad: int = 1 << 16  # query padding quantum (staged batches)
    keep_work: bool = False
    dry_run: bool = False
