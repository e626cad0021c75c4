"""Superkingdom canonicalization for predicted CAMI profiles (copy of
hymet_tpu.evalx.superkingdom_fix).

GTDB-derived converters emit Bacillati/Pseudomonadati (taxids
1783272/3379134) where NCBI truth says Bacteria (2), so rank-sliced
evaluators score the top stratum as a total miss. The fix rebuilds the
predicted profile's superkingdom rows bottom-up: every row of the best
available lower rank is walked up the taxonomy until it reaches one of
the truth profile's superkingdom taxids (falling back to the canonical
NCBI superkingdoms, then to the row's own taxid), and abundances sum per
landing point. Non-superkingdom strata pass through untouched.

Behavior-parity port of reference
``bench/tools/fix_superkingdom_taxids.py`` (byte-identical in-place
rewrite, pinned by
``tests/test_harness.py::test_superkingdom_fix_oracle_parity``), built
on the package's :class:`~hymet_tpu_torch.taxonomy.db.TaxonomyDB`
instead of the reference's ad-hoc csv table.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, List, Sequence, Set, Tuple

from hymet_tpu_torch.taxonomy.db import TaxonomyDB

#: NCBI top-level taxa: Bacteria, Archaea, Eukaryota, Viruses, Viroids.
NCBI_SUPERKINGDOMS = ("2", "2157", "2759", "10239", "12884")

#: Abundances aggregate from the highest-resolution rank present, trying
#: these in order (reference fix_superkingdom_taxids.py:20-27).
_AGG_RANKS = ("phylum", "class", "order", "family", "genus", "species")

#: CAMI TAXPATH/TAXPATHSN column width used for the rebuilt rows.
_TAXPATH_WIDTH = 7


def _ancestry(db: TaxonomyDB, taxid: str) -> Iterator[str]:
    """``taxid`` followed by each ancestor, stopping at roots, unknown
    ids, and cycles."""
    seen: Set[str] = set()
    cur = taxid
    while cur and cur not in seen:
        seen.add(cur)
        yield cur
        parent = db.parent.get(cur, "")
        if not parent or parent == cur:
            return
        cur = parent


def _superkingdom_of(db: TaxonomyDB, taxid: str, targets: Set[str]) -> str:
    """Landing point for one profile row: first ancestor among the truth
    superkingdoms, else the first canonical NCBI one, else the row's own
    taxid (so unmapped mass is preserved under its original id)."""
    for anc in _ancestry(db, taxid):
        if anc in targets:
            return anc
    for anc in _ancestry(db, taxid):
        if anc in NCBI_SUPERKINGDOMS:
            return anc
    return taxid


def _rank_of(row: Sequence[str]) -> str:
    return row[1].lower() if len(row) >= 2 else ""


def _read_profile(path: str) -> Tuple[List[str], List[List[str]]]:
    with open(path, encoding="utf-8", errors="ignore") as f:
        lines = f.readlines()
    headers = [ln for ln in lines if ln.startswith(("@", "#"))]
    rows = [
        ln.rstrip("\n").split("\t")
        for ln in lines
        if not ln.startswith(("@", "#"))
    ]
    return headers, rows


def truth_superkingdoms(truth_profile_path: str) -> Set[str]:
    """Superkingdom taxids the truth profile actually uses."""
    _, rows = _read_profile(truth_profile_path)
    return {row[0] for row in rows if _rank_of(row) == "superkingdom"}


def _rebuild_rows(
    db: TaxonomyDB, rows: Iterable[Sequence[str]], targets: Set[str]
) -> List[List[str]]:
    """The replacement superkingdom stratum: abundances of the best
    available lower rank, summed per landing superkingdom."""
    ranks_present = {_rank_of(r) for r in rows} - {"superkingdom", ""}
    agg_rank = next((r for r in _AGG_RANKS if r in ranks_present), None)
    total: Dict[str, float] = dict.fromkeys(targets, 0.0)
    for row in rows:
        if len(row) < 5 or _rank_of(row) == "superkingdom":
            continue
        if agg_rank is not None and _rank_of(row) != agg_rank:
            continue
        try:
            pct = float(row[4])
        except ValueError:
            pct = 0.0
        sk = _superkingdom_of(db, row[0], targets)
        total[sk] = total.get(sk, 0.0) + pct

    pad = ["NA"] * (_TAXPATH_WIDTH - 1)
    return [
        [
            taxid,
            "superkingdom",
            "|".join([taxid] + pad),
            "|".join([db.name.get(taxid) or "NA"] + pad),
            f"{total[taxid]:.6f}",
        ]
        for taxid in sorted(total)
        if total[taxid] > 0
    ]


def fix_superkingdom(
    profile_path: str,
    truth_profile_path: str,
    taxonomy_hierarchy_tsv: str,
) -> None:
    """Rewrite ``profile_path`` in place (no-op on missing/empty files)."""
    if not os.path.exists(profile_path):
        return
    headers, rows = _read_profile(profile_path)
    if not rows:
        return
    db = TaxonomyDB.from_hierarchy_tsv(taxonomy_hierarchy_tsv)
    targets = truth_superkingdoms(truth_profile_path) or set(
        NCBI_SUPERKINGDOMS
    )

    rebuilt = _rebuild_rows(db, rows, targets)
    rebuilt_ids = {row[0] for row in rebuilt}
    # superkingdom rows the rebuild didn't produce pass through (e.g. a
    # converter's stratum for mass with no lower-rank support)
    kept = [
        row
        for row in rows
        if _rank_of(row) == "superkingdom" and row[0] not in rebuilt_ids
    ]
    lower = [
        row for row in rows if len(row) >= 5 and _rank_of(row) != "superkingdom"
    ]
    with open(profile_path, "w", encoding="utf-8") as f:
        f.writelines(headers)
        for row in rebuilt + kept + lower:
            f.write("\t".join(row) + "\n")
