"""Run configuration: the fields of hymet_tpu's ``RunConfig`` that the
ported stages (screen, candidate limit, align) read, with the same names
and defaults."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class RunConfig:
    mash_thresh: float = 0.9  # initial screen threshold (mash.sh -t analog)
    screen_chunk_bp: int = 1 << 20  # query streaming chunk (chunked screen path)
    align_batch_pad: int = 1 << 16  # query padding quantum (staged batches)
    align_k: int = 19
    align_w: int = 19
    cand_max: int = 5000
    species_dedup: bool = False
    assembly_summary_dir: Optional[str] = None
    force_download: bool = False  # rebuild cached references and indexes
