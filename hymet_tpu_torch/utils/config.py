"""Run configuration: the fields of hymet_tpu's ``RunConfig``, with the same
names and defaults (the reference batch script's env-var contract,
``run_hymet_cami.sh:23-38``, plus the package's own), save one:
``classifier_backend`` defaults to ``"device"``, the port's name for the
backend the JAX package calls ``"jax"`` (which is accepted as the same, so
a reference config runs unchanged). :meth:`RunConfig.from_env` reads the
same environment variables with the same defaults."""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import List, Optional


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


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
    classifier_backend: str = "device"  # device (= jax) | host | legacy
    db_shards: int = 1  # reference-DB sharding across devices (one card: 1)
    screen_chunk_bp: int = 1 << 20  # query streaming chunk (chunked screen path)
    align_batch_pad: int = 1 << 16  # query padding quantum (staged batches)
    keep_work: bool = False
    dry_run: bool = False

    @classmethod
    def from_env(cls, **overrides) -> "RunConfig":
        """The config the reference's environment variables describe; each
        override that is not None replaces its field."""
        cfg = cls(
            input_fasta=_env("INPUT_FASTA", ""),
            outdir=_env("OUTDIR", "out/run"),
            threads=int(_env("THREADS", "8")),
            cand_max=int(_env("CAND_MAX", "5000")),
            species_dedup=_env("SPECIES_DEDUP", "0") == "1",
            assembly_summary_dir=os.environ.get("ASSEMBLY_SUMMARY_DIR"),
            cand_limit_log=os.environ.get("CAND_LIMIT_LOG") or None,
            mash_thresh=float(_env("MASH_THRESH", "0.9")),
            force_download=_env("FORCE_DOWNLOAD", "0") == "1",
            cache_root=_env("CACHE_ROOT", "data/cache"),
            taxonomy_dir=os.environ.get("TAXONKIT_DB") or os.environ.get("TAXONOMY_DIR"),
            sketch_dbs=[p for p in _env("SKETCH_DBS", "").split(os.pathsep) if p],
            genome_catalog=os.environ.get("GENOME_CATALOG"),
            seqid2taxid=os.environ.get("SEQID2TAXID"),
            allow_download=_env("ALLOW_DOWNLOAD", "0") == "1",
            db_shards=int(_env("DB_SHARDS", "1")),
            screen_chunk_bp=int(_env("SCREEN_CHUNK_BP", str(1 << 20))),
            align_batch_pad=int(_env("ALIGN_BATCH_PAD", str(1 << 16))),
        )
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)
        return cfg

    def describe(self) -> str:
        """One ``name=value`` line a field, in field order."""
        return "\n".join(f"{f.name}={getattr(self, f.name)!r}" for f in dataclasses.fields(self))
