"""Manifest TSV parsing (the dataset-config layer; copy of
hymet_tpu.harness.manifest).

Same format as the reference manifests (``bench/cami_manifest.tsv``,
``case/manifest*.tsv``): tab-separated, '#' comments, columns
``sample_id  contigs_fa  truth_contigs_tsv  truth_profile_tsv`` plus
optional ``*_url`` columns and case-study extras (``expected_taxa``).
Relative paths resolve against the manifest's directory (the reference's
``resolve_path``, ``bench/lib/common.sh:28-41``).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ManifestRow:
    sample_id: str
    contigs: str
    truth_contigs: Optional[str] = None
    truth_profile: Optional[str] = None
    extra: Dict[str, str] = field(default_factory=dict)


def _resolve(value: str, base: str) -> Optional[str]:
    value = (value or "").strip()
    if not value:
        return None
    if os.path.isabs(value):
        return os.path.normpath(value)
    return os.path.normpath(os.path.join(base, value))


def load_manifest(path: str) -> List[ManifestRow]:
    base = os.path.dirname(os.path.abspath(path))
    rows: List[ManifestRow] = []
    with open(path, encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t")
        header: Optional[List[str]] = None
        for raw in reader:
            if not raw or not raw[0].strip() or raw[0].lstrip().startswith("#"):
                continue
            if header is None:
                header = [c.strip().lower() for c in raw]
                continue
            rec = dict(zip(header, raw))
            sample = (rec.get("sample_id") or rec.get("sample") or "").strip()
            if not sample:
                continue
            contigs = _resolve(
                rec.get("contigs_fa") or rec.get("contigs") or "", base
            )
            rows.append(
                ManifestRow(
                    sample_id=sample,
                    contigs=contigs or "",
                    truth_contigs=_resolve(rec.get("truth_contigs_tsv") or "", base),
                    truth_profile=_resolve(rec.get("truth_profile_tsv") or "", base),
                    extra={
                        k: v
                        for k, v in rec.items()
                        if k
                        not in (
                            "sample_id",
                            "sample",
                            "contigs_fa",
                            "contigs",
                            "truth_contigs_tsv",
                            "truth_profile_tsv",
                        )
                    },
                )
            )
    return rows
