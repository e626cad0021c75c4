"""Host I/O layer: FASTA, PAF and sketch-DB formats (counterpart of
hymet_tpu.io)."""

from hymet_tpu_torch.io.fasta import iter_fasta, pack_2bit, read_fasta
from hymet_tpu_torch.io.paf import PafRecord, read_paf, write_paf

__all__ = [
    "read_fasta",
    "iter_fasta",
    "pack_2bit",
    "PafRecord",
    "read_paf",
    "write_paf",
]
