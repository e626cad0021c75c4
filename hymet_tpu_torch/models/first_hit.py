"""Fallback first-hit classifier (copy of hymet_tpu.models.first_hit).

Parity with the reference's empty-result fallback path
(``run_hymet_cami.sh:182-206``): flatten detailed_taxonomy.tsv to an
id->taxid map (``tools/build_id_map.py``), then assign each query the taxid
of its first PAF hit (``tools/mini_classify.py``), and convert to the
4-column classified_sequences format with lineage/level "unknown" and
confidence 1.0000.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Tuple


def build_id_map(taxonomy_file: str) -> Dict[str, str]:
    """GCF + Identifiers tokens (split ';') + versionless variants, first
    mapping wins (``tools/build_id_map.py:17-48``)."""
    id2tax: Dict[str, str] = {}

    def emit(k: str, tax: str) -> None:
        if not k:
            return
        id2tax.setdefault(k, tax)
        if "." in k:
            id2tax.setdefault(k.split(".", 1)[0], tax)

    with open(taxonomy_file, "r", encoding="utf-8", errors="ignore", newline="") as f:
        first = f.readline()
        if not first:
            raise RuntimeError("empty taxonomy file")
        hdr = first.rstrip("\n").split("\t")
        try:
            i_gcf, i_tax, i_ids = hdr.index("GCF"), hdr.index("TaxID"), hdr.index("Identifiers")
        except ValueError:
            i_gcf, i_tax, i_ids = 0, 1, 2
        for line in f:
            if not line.strip():
                continue
            row = line.rstrip("\n").split("\t")
            if len(row) <= max(i_gcf, i_tax):
                continue
            gcf = row[i_gcf].strip()
            tax = row[i_tax].strip()
            if gcf:
                emit(gcf, tax)
            ids = row[i_ids].strip() if len(row) > i_ids else ""
            for tok in ids.split(";"):
                emit(tok.strip(), tax)
    return id2tax


def classify_first_hit(
    paf_file: str, id2tax: Dict[str, str]
) -> Tuple[List[Tuple[str, str, str]], int]:
    """First taxid-resolvable hit per query, in PAF order
    (``tools/mini_classify.py:16-30``). Returns ([(qname, tname, taxid)],
    total alignment rows seen)."""

    def opener(p: str):
        if p.endswith(".gz"):
            return gzip.open(p, "rt", encoding="utf-8", errors="ignore")
        return open(p, "r", encoding="utf-8", errors="ignore")

    seen = set()
    rows: List[Tuple[str, str, str]] = []
    tot = 0
    with opener(paf_file) as f:
        for ln in f:
            if not ln or ln[0] == "#":
                continue
            p = ln.rstrip("\n").split("\t")
            if len(p) < 6:
                continue
            q, t = p[0], p[5]
            tot += 1
            if q in seen:
                continue
            tax = id2tax.get(t) or id2tax.get(t.split(".", 1)[0])
            if tax:
                rows.append((q, t, tax))
                seen.add(q)
    return rows, tot


def write_fallback_classified(
    path: str, rows: List[Tuple[str, str, str]]
) -> None:
    """Write the 4-column format the batch script produces from the fallback
    (``run_hymet_cami.sh:197-202`` — awk output, LF line endings)."""
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write("Query\tLineage\tTaxonomic Level\tConfidence\n")
        for q, _t, _tax in rows:
            f.write(f"{q}\tunknown\tunknown\t1.0000\n")
