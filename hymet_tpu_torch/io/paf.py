"""PAF (Pairwise mApping Format) records, reader, writer and the
classifier's tolerant reader (copy of hymet_tpu.io.paf).

The classifier consumes only columns 1, 2, 6, 10 and 11 (qname, qlen,
tname, nmatch, block_len); records carry all 12 columns plus tags so the
aligner's output is drop-in compatible with minimap2's.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Tuple


@dataclass
class PafRecord:
    qname: str
    qlen: int
    qstart: int
    qend: int
    strand: str
    tname: str
    tlen: int
    tstart: int
    tend: int
    nmatch: int
    blocklen: int
    mapq: int
    tags: Dict[str, str] = field(default_factory=dict)

    @property
    def coverage(self) -> float:
        """block_len / qlen — the quantity the weighted LCA consumes."""
        return self.blocklen / self.qlen if self.qlen > 0 else 0.0

    def to_line(self) -> str:
        cols = [
            self.qname,
            str(self.qlen),
            str(self.qstart),
            str(self.qend),
            self.strand,
            self.tname,
            str(self.tlen),
            str(self.tstart),
            str(self.tend),
            str(self.nmatch),
            str(self.blocklen),
            str(self.mapq),
        ]
        for k, v in self.tags.items():
            cols.append(f"{k}:{v}")
        return "\t".join(cols)


def _opener(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8", errors="ignore")
    return open(path, "r", encoding="utf-8", errors="ignore")


def iter_paf(path: str) -> Iterator[PafRecord]:
    """The records of a PAF file (``.gz`` too) with all 12 columns and
    their ``tag:type:value`` tags; comment lines, short lines and lines
    whose numbers do not parse are skipped."""
    with _opener(path) as f:
        for line in f:
            if not line or line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 12:
                continue
            try:
                rec = PafRecord(
                    qname=parts[0],
                    qlen=int(parts[1]),
                    qstart=int(parts[2]),
                    qend=int(parts[3]),
                    strand=parts[4],
                    tname=parts[5],
                    tlen=int(parts[6]),
                    tstart=int(parts[7]),
                    tend=int(parts[8]),
                    nmatch=int(parts[9]),
                    blocklen=int(parts[10]),
                    mapq=int(parts[11]),
                )
            except ValueError:
                continue
            for tag in parts[12:]:
                bits = tag.split(":", 2)
                if len(bits) == 3:
                    rec.tags[bits[0]] = f"{bits[1]}:{bits[2]}"
            yield rec


def read_paf(path: str) -> List[PafRecord]:
    return list(iter_paf(path))


def write_paf(path: str, records: Iterable[PafRecord]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(rec.to_line() + "\n")


def parse_paf_for_classification(
    path: str,
) -> Tuple[Dict[str, List[Tuple[str, float]]], Dict[str, int]]:
    """Tolerant PAF parse matching the classifier's consumption: accepts
    >= 11 columns, zero qlen/blocklen on a parse failure; returns

      query_map:  qname -> [(tname, coverage)], insertion-ordered
      ref_counts: tname -> number of alignment rows (the abundance weight)
    """
    query_map: Dict[str, List[Tuple[str, float]]] = {}
    ref_counts: Dict[str, int] = {}
    with _opener(path) as f:
        for line in f:
            if not line or line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 11:
                continue
            qname = parts[0]
            try:
                qlen = int(parts[1])
                aln_block = int(parts[10])
            except ValueError:
                qlen = 0
                aln_block = 0
            tname = parts[5]
            cov = (aln_block / qlen) if qlen > 0 else 0.0
            query_map.setdefault(qname, []).append((tname, cov))
            ref_counts[tname] = ref_counts.get(tname, 0) + 1
    return query_map, ref_counts
