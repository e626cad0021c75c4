"""Sequence-identifier -> TaxID mapping with aggressive normalization (copy
of hymet_tpu.taxonomy.idmap).

Reproduces the reference classifier's identifier handling:

- ``load_taxonomy_file`` (``classification_cami.py:63-102``): builds the
  id->taxid map from detailed_taxonomy.tsv, harvesting GCF/GCA accessions
  from every column, splitting the Identifiers field on ``;|,`` and
  whitespace, extracting embedded contig accessions, and adding versionless
  variants — first mapping wins (setdefault).
- ``_generate_lookup_candidates`` / ``_lookup_taxid``
  (``classification_cami.py:212-249``): the ranked candidate-key cascade
  used per PAF target name.
- ``tools/build_id_map.py``: the simpler flattening used by the fallback
  first-hit classifier.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

GCFA_RE = re.compile(r"GC[AF]_\d+(?:\.\d+)?(?:_PRJ[A-Z]+\d+)?")
ACC_RE = re.compile(
    r"(NC_\d+\.\d+|NZ_[A-Z]{2}\d+\.\d+|NZ_[A-Z]{5}\d+\.\d+|CP\d+\.\d+|CM\d+\.\d+|[A-Z]{2}_\d+\.\d+)"
)
_ID_SPLIT_RE = re.compile(r"[;|,\s]+")


class IdentifierMap:
    """identifier -> taxid map with versionless variants."""

    def __init__(self) -> None:
        self._map: Dict[str, str] = {}

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def get(self, key: str) -> Optional[str]:
        return self._map.get(key)

    def add_token(self, tok: str, taxid: str) -> None:
        """Add token and its versionless variant (first mapping wins)."""
        if not tok:
            return
        tok = tok.strip()
        if not tok:
            return
        self._map.setdefault(tok, taxid)
        if "." in tok:
            self._map.setdefault(tok.split(".", 1)[0], taxid)

    # ------------------------------------------------------------------

    @classmethod
    def from_detailed_taxonomy(cls, taxonomy_file: str) -> "IdentifierMap":
        """Build from detailed_taxonomy.tsv (columns GCF / TaxID /
        Identifiers), with the reference's full harvesting cascade."""
        m = cls()
        with open(taxonomy_file, "r", encoding="utf-8", errors="ignore", newline="") as f:
            header_line = f.readline()
            if not header_line:
                raise RuntimeError("empty taxonomy file")
            # rstrip \r too: the file is csv.writer output (CRLF endings)
            header = header_line.rstrip("\r\n").split("\t")
            if "TaxID" not in header:
                raise RuntimeError("TaxID column not found in taxonomy file")
            tax_i = header.index("TaxID")
            ids_i = header.index("Identifiers") if "Identifiers" in header else -1
            for line in f:
                if not line.strip():
                    continue
                row = line.rstrip("\r\n").split("\t")
                if len(row) <= tax_i:
                    continue
                taxid = row[tax_i].strip()
                if not taxid:
                    continue
                # 1) GCF/GCA accessions anywhere in the row
                for v in row:
                    if not v:
                        continue
                    for acc in GCFA_RE.findall(v):
                        m.add_token(acc, taxid)
                # 2) Identifiers column token split
                ids = row[ids_i] if 0 <= ids_i < len(row) else ""
                for tok in split_identifiers(ids):
                    m.add_token(tok, taxid)
                # 3) embedded contig accessions in any column
                for v in (ids, *row):
                    if not v:
                        continue
                    for acc in ACC_RE.findall(v):
                        m.add_token(acc, taxid)
        return m

    @classmethod
    def from_seqid2taxid(cls, path: str) -> "IdentifierMap":
        """Build from a simple 2-column seqid<TAB>taxid table (the in-repo
        Zymo panel format, reference case/truth/zymo_refs/seqid2taxid.tsv)."""
        m = cls()
        with open(path, "r", encoding="utf-8", errors="ignore") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2 and parts[0].strip():
                    m.add_token(parts[0], parts[1].strip())
        return m

    # ------------------------------------------------------------------

    def lookup(self, tname: str) -> Optional[str]:
        """Ranked-candidate lookup (reference ``_lookup_taxid``)."""
        for cand in generate_lookup_candidates(tname):
            tid = self._map.get(cand)
            if tid:
                return tid
        return None

    def flatten(self) -> Dict[str, str]:
        return dict(self._map)


def split_identifiers(s: str) -> List[str]:
    """Split an Identifiers field on ``; | ,`` and whitespace."""
    if not s:
        return []
    return [p for p in (x.strip() for x in _ID_SPLIT_RE.split(s)) if p]


def generate_lookup_candidates(tname: str) -> List[str]:
    """Ranked candidate keys for a PAF target name: original, versionless,
    head token before '|'/whitespace, embedded GCF/GCA + contig accessions
    (reference ``classification_cami.py:212-241``)."""
    cands: List[str] = []

    def add(x: str) -> None:
        if x and x not in cands:
            cands.append(x)
        if x and "." in x:
            xv = x.split(".", 1)[0]
            if xv not in cands:
                cands.append(xv)

    add(tname)
    head = re.split(r"[|\s]+", tname)[0]
    add(head)
    for g in GCFA_RE.findall(tname):
        add(g)
    for a in ACC_RE.findall(tname):
        add(a)
    return cands
