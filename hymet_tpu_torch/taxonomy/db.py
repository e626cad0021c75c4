"""NCBI taxonomy database, fully in-process (copy of hymet_tpu.taxonomy.db).

Replaces the reference's external taxonomy tooling:

- ``scripts/taxonomy_hierarchy.py`` (names.dmp/nodes.dmp -> TSV with
  root-to-node ``rank:name;...`` lineages, incl. the "no rank" + strain-flag
  promotion rule at ``taxonomy_hierarchy.py:32-33``),
- ``taxonkit name2taxid`` (scientific names + synonyms -> taxid, with rank;
  used at ``tools/hymet2cami.py:61-75``),
- ``taxonkit reformat -f "{d}|{p}|{c}|{o}|{f}|{g}|{s}" -t`` (taxid -> 7-rank
  taxpath names + ids; used at ``tools/hymet2cami.py:78-102``).

Also produces dense integer rank tables for device-side consumption:
``taxid-index -> int32 name-id per rank``, the representation the vectorized
weighted-LCA kernel operates on.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from hymet_tpu_torch import CAMI_RANKS, RANKS
from hymet_tpu_torch.taxonomy.lineage import lineage_to_rank_names

_MAX_DEPTH = 200  # lineage walk guard against malformed parent cycles


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8", errors="ignore")
    return open(path, "r", encoding="utf-8", errors="ignore")


class TaxonomyDB:
    """Taxonomy graph with name/rank/parent per taxid.

    Taxids are handled as strings throughout (matching the reference's
    file formats); integer views are built on demand.
    """

    def __init__(self) -> None:
        self.name: Dict[str, str] = {}  # taxid -> scientific name
        self.rank: Dict[str, str] = {}  # taxid -> rank ("strain"-promoted)
        self.parent: Dict[str, str] = {}  # taxid -> parent taxid
        self.merged: Dict[str, str] = {}  # old taxid -> new taxid
        # name (exact string) -> taxid; scientific names win over synonyms
        self._name2taxid: Dict[str, str] = {}
        self._name2taxid_lower: Dict[str, str] = {}

    # ------------------------------------------------------------------
    # constructors

    @classmethod
    def from_taxdump(cls, taxdump_dir: str) -> "TaxonomyDB":
        """Load from an NCBI taxdump directory (names.dmp + nodes.dmp,
        optionally merged.dmp)."""
        db = cls()
        names_path = os.path.join(taxdump_dir, "names.dmp")
        nodes_path = os.path.join(taxdump_dir, "nodes.dmp")

        synonyms: Dict[str, str] = {}
        with _open_text(names_path) as f:
            for line in f:
                parts = line.split("\t|\t")
                if len(parts) < 4:
                    continue
                taxid = parts[0].strip()
                name = parts[1].strip()
                name_class = parts[3].strip("\t|\n").strip()
                if name_class == "scientific name":
                    db.name[taxid] = name
                    db._name2taxid[name] = taxid
                elif name_class in (
                    "synonym",
                    "equivalent name",
                    "genbank synonym",
                    "common name",
                    "genbank common name",
                ):
                    synonyms.setdefault(name, taxid)

        with _open_text(nodes_path) as f:
            for line in f:
                parts = line.split("\t|\t")
                if len(parts) < 3:
                    continue
                taxid = parts[0].strip()
                parent = parts[1].strip()
                rank = parts[2].strip("\t|\n").strip()
                # "no rank" + strain flag promotion, cf. reference
                # scripts/taxonomy_hierarchy.py:32-33.
                if rank == "no rank" and len(parts) > 4 and "strain" in parts[4]:
                    rank = "strain"
                db.rank[taxid] = rank
                db.parent[taxid] = parent

        merged_path = os.path.join(taxdump_dir, "merged.dmp")
        if os.path.exists(merged_path):
            with _open_text(merged_path) as f:
                for line in f:
                    parts = [p.strip() for p in line.replace("|", "\t").split("\t") if p.strip()]
                    if len(parts) >= 2:
                        db.merged[parts[0]] = parts[1]

        # synonyms fill holes only (scientific names take precedence)
        for name, taxid in synonyms.items():
            db._name2taxid.setdefault(name, taxid)
        db._rebuild_lower_index()
        return db

    @classmethod
    def from_hierarchy_tsv(cls, path: str) -> "TaxonomyDB":
        """Load from a taxonomy_hierarchy.tsv
        (``TaxID\\tName\\tRank\\tParentTaxID\\tLineage``)."""
        db = cls()
        with _open_text(path) as f:
            header = f.readline().rstrip("\n").split("\t")
            idx = {c: i for i, c in enumerate(header)}
            for line in f:
                if not line.strip():
                    continue
                row = line.rstrip("\n").split("\t")

                def get(col: str) -> str:
                    i = idx.get(col, -1)
                    return row[i] if 0 <= i < len(row) else ""

                taxid = get("TaxID").strip()
                if not taxid:
                    continue
                db.name[taxid] = get("Name").strip()
                db.rank[taxid] = get("Rank").strip()
                db.parent[taxid] = get("ParentTaxID").strip() or "1"
                if db.name[taxid]:
                    db._name2taxid.setdefault(db.name[taxid], taxid)
        db._rebuild_lower_index()
        return db

    @classmethod
    def from_records(
        cls, records: Iterable[Tuple[str, str, str, str]]
    ) -> "TaxonomyDB":
        """Build from (taxid, name, rank, parent_taxid) tuples — handy for
        test fixtures and for synthesizing mini taxonomies from in-repo
        truth tables."""
        db = cls()
        for taxid, name, rank, parent in records:
            db.name[taxid] = name
            db.rank[taxid] = rank
            db.parent[taxid] = parent
            if name:
                db._name2taxid.setdefault(name, taxid)
        db._rebuild_lower_index()
        return db

    def _rebuild_lower_index(self) -> None:
        self._name2taxid_lower = {}
        for name, taxid in self._name2taxid.items():
            self._name2taxid_lower.setdefault(name.lower(), taxid)

    # ------------------------------------------------------------------
    # queries

    def resolve(self, taxid: str) -> str:
        """Follow merged-taxid redirects."""
        seen = 0
        while taxid in self.merged and seen < 8:
            taxid = self.merged[taxid]
            seen += 1
        return taxid

    def name2taxid(self, name: str) -> Optional[str]:
        """Exact-name lookup with case-insensitive fallback
        (taxonkit name2taxid semantics)."""
        if not name:
            return None
        tid = self._name2taxid.get(name)
        if tid is None:
            tid = self._name2taxid_lower.get(name.lower())
        return tid

    def batch_name2taxid(self, names: Iterable[str]) -> Dict[str, str]:
        """Map names -> taxid (drop-in for the reference's taxonkit batch
        call at ``tools/hymet2cami.py:61-75``)."""
        out: Dict[str, str] = {}
        for n in names:
            tid = self.name2taxid(n)
            if tid is not None:
                out[n] = tid
        return out

    def lineage_pairs(self, taxid: str) -> List[Tuple[str, str, str]]:
        """Root-to-node list of (taxid, rank, name). Excludes the root node
        "1" itself, matching reference ``taxonomy_hierarchy.py:45-53``."""
        out: List[Tuple[str, str, str]] = []
        current = self.resolve(taxid)
        depth = 0
        while current != "1" and depth < _MAX_DEPTH:
            rank, parent = self.rank.get(current, ""), self.parent.get(current, "1")
            name = self.name.get(current, "Unknown")
            out.insert(0, (current, rank, name))
            if parent == current:  # self-parenting guard (other than root)
                break
            current = parent
            depth += 1
        return out

    def lineage_string(self, taxid: str) -> str:
        """``rank:name;rank:name;...`` root-to-node, matching the reference
        hierarchy TSV Lineage column (``taxonomy_hierarchy.py:45-53``)."""
        return ";".join(f"{rank}:{name}" for _, rank, name in self.lineage_pairs(taxid))

    def taxpath(
        self, taxid: str, ranks: Sequence[str] = CAMI_RANKS
    ) -> Tuple[str, str]:
        """(taxpath_ids, taxpath_names) pipe-joined over `ranks`, with empty
        slots for missing ranks — ``taxonkit reformat -t`` semantics used by
        ``tools/hymet2cami.py:78-102``."""
        by_rank_id = {r: "" for r in ranks}
        by_rank_name = {r: "" for r in ranks}
        for tid, rank, name in self.lineage_pairs(taxid):
            r = rank
            if r == "domain":  # GTDB-style dumps
                r = "superkingdom"
            if r in by_rank_id and not by_rank_id[r]:
                by_rank_id[r] = tid
                by_rank_name[r] = name
        ids = "|".join(by_rank_id[r] for r in ranks)
        names = "|".join(by_rank_name[r] for r in ranks)
        return ids, names

    def rank_names_vector(self, taxid: str) -> List[str]:
        """Names aligned to the 8 RANKS for a taxid (classifier's `_HIER`
        representation, cf. ``classification_cami.py:158-174``)."""
        return lineage_to_rank_names(self.lineage_string(taxid))

    def ancestor_at_rank(self, taxid: str, rank: str) -> Optional[str]:
        for tid, r, _ in self.lineage_pairs(taxid):
            rr = "superkingdom" if r == "domain" else r
            if rr == rank:
                return tid
        return None

    # ------------------------------------------------------------------
    # exports

    def write_hierarchy_tsv(self, path: str) -> None:
        """Write taxonomy_hierarchy.tsv byte-compatible with the reference
        generator (``scripts/taxonomy_hierarchy.py:55-61``)."""
        with open(path, "w", encoding="utf-8") as out:
            out.write("TaxID\tName\tRank\tParentTaxID\tLineage\n")
            for taxid in self.rank:
                name = self.name.get(taxid, "Unknown")
                rank = self.rank[taxid]
                parent = self.parent.get(taxid, "1")
                out.write(
                    f"{taxid}\t{name}\t{rank}\t{parent}\t{self.lineage_string(taxid)}\n"
                )

    # ------------------------------------------------------------------
    # dense device-side tables

    def build_rank_table(
        self, taxids: Sequence[str]
    ) -> Tuple[np.ndarray, Dict[str, int], List[str]]:
        """Intern per-rank names of `taxids` into int32 ids.

        Returns (table, taxid_index, names) where
          - table[i, r] = name-id of rank r for taxids[i] (0 = no name),
          - taxid_index maps taxid string -> row i,
          - names[j] is the interned name for id j (names[0] == "").

        The per-query tie-break of the reference's ``_weighted_lca``
        (Python ``max`` over dict-insertion order,
        ``classification_cami.py:278``) is reproduced downstream by the LCA
        kernel's argmax over hit positions, not by this interning order.
        """
        names: List[str] = [""]
        intern: Dict[str, int] = {"": 0}
        table = np.zeros((len(taxids), len(RANKS)), dtype=np.int32)
        taxid_index: Dict[str, int] = {}
        for i, tid in enumerate(taxids):
            taxid_index[tid] = i
            vec = self.rank_names_vector(tid)
            for r, nm in enumerate(vec):
                if not nm:
                    continue
                j = intern.get(nm)
                if j is None:
                    j = len(names)
                    intern[nm] = j
                    names.append(nm)
                table[i, r] = j
        return table, taxid_index, names
