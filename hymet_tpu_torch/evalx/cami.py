"""CAMI profile export: ``classified_sequences.tsv`` -> CAMI profile, and the
readers the evaluator and converters share (copy of hymet_tpu.evalx.cami).

Parity with reference ``tools/hymet2cami.py`` (same parsing, counting,
ordering, and formatting), with the taxonkit subprocess calls
(``hymet2cami.py:61-102``) replaced by :class:`TaxonomyDB` lookups.
"""

from __future__ import annotations

import csv
from collections import defaultdict
from typing import Dict, List, TextIO, Tuple

from hymet_tpu_torch import CAMI_RANKS, RANK_ALIAS
from hymet_tpu_torch.taxonomy.db import TaxonomyDB


def parse_lineage_cami(lineage: str) -> Dict[str, str]:
    """``rank:name; ...`` -> {rank: name} over the 7 CAMI ranks
    (``hymet2cami.py:46-58`` — unknown rank labels fall through to their
    lowercase selves, so only recognized ranks land)."""
    out = {rank: "" for rank in CAMI_RANKS}
    if not lineage:
        return out
    for part in lineage.split(";"):
        part = part.strip()
        if not part or ":" not in part:
            continue
        rk, name = part.split(":", 1)
        rk = RANK_ALIAS.get(rk.strip().lower(), rk.strip().lower())
        if rk in out:
            out[rk] = name.strip()
    return out


def read_lineages(path: str) -> List[Dict[str, str]]:
    """Per-contig rank->name lineages from ``classified_sequences.tsv``
    (rows whose Lineage column names at least one recognized rank)."""
    return [ranks for _, ranks in read_query_lineages(path)]


def read_query_lineages(path: str) -> List[Tuple[str, Dict[str, str]]]:
    """Like :func:`read_lineages` but keeps the Query column, so callers
    can weight records (e.g. by contig length) instead of counting."""
    out: List[Tuple[str, Dict[str, str]]] = []
    with open(path, encoding="utf-8", errors="ignore") as fh:
        for r in csv.DictReader(fh, delimiter="\t"):
            ranks = parse_lineage_cami(r.get("Lineage", ""))
            if any(ranks.values()):
                out.append((r.get("Query", ""), ranks))
    return out


def tally_by_rank(
    lineages: List[Dict[str, str]],
    name2tid: Dict[str, str],
    weights: List[float] = None,
) -> Tuple[Dict[str, Dict[str, int]], Dict[str, int], set]:
    """Per-rank taxid tallies over resolvable names. Returns
    (counts per rank, per-rank totals, the set of taxids used).

    ``weights=None`` counts records, byte-parity with the reference
    converter (``tools/hymet2cami.py:117-131``). A weights list (one per
    lineage, e.g. contig lengths) makes the profile abundance-weighted —
    the CAMI convention proper — as an opt-in extension."""
    counts: Dict[str, Dict[str, int]] = {rank: defaultdict(int) for rank in CAMI_RANKS}
    for i, ranks in enumerate(lineages):
        w = 1 if weights is None else weights[i]
        for rank in CAMI_RANKS:
            tid = name2tid.get(ranks.get(rank) or "")
            if tid:
                counts[rank][tid] += w
    totals = {rank: sum(counts[rank].values()) for rank in CAMI_RANKS}
    used = {tid for per_rank in counts.values() for tid in per_rank}
    return counts, totals, used


def emit_cami(
    out: TextIO,
    counts: Dict[str, Dict[str, int]],
    totals: Dict[str, int],
    taxid2path: Dict[str, Tuple[str, str]],
    sample_id: str = "sample_0",
) -> None:
    """Header + rows, identical formatting to ``hymet2cami.py:134-149``
    (count-descending order per rank; 6dp percentages)."""
    out.write("#CAMI Submission for Taxonomic Profiling\n")
    out.write(
        "@Version:0.9.1 @Ranks:superkingdom|phylum|class|order|family|genus|species "
        f"@SampleID:{sample_id}\n"
    )
    out.write("@@TAXID RANK TAXPATH TAXPATHSN PERCENTAGE\n")
    for rank in CAMI_RANKS:
        total = totals.get(rank, 0)
        if total <= 0:
            continue
        for tid, count in sorted(
            counts.get(rank, {}).items(), key=lambda kv: kv[1], reverse=True
        ):
            path = taxid2path.get(tid)
            if not path:
                continue
            names, ids = path
            pct = 100.0 * count / total
            out.write(f"{tid}\t{rank}\t{ids}\t{names}\t{pct:.6f}\n")


def classified_to_cami(
    classified_tsv: str,
    taxdb: TaxonomyDB,
    out_path: str,
    sample_id: str = "sample_0",
    lengths: Dict[str, int] = None,
) -> int:
    """Full conversion; returns the number of lineage records used.

    ``lengths`` (contig name -> bp, missing contigs weigh 1) switches
    the profile from the reference's contig-count weighting to CAMI
    abundance weighting; default ``None`` keeps byte parity."""
    pairs = read_query_lineages(classified_tsv)
    records = [ranks for _, ranks in pairs]
    all_names = {n for parsed in records for n in parsed.values() if n}
    name2tid = taxdb.batch_name2taxid(all_names)
    weights = (
        None if lengths is None else [lengths.get(q, 1) for q, _ in pairs]
    )
    counts, totals, needed = tally_by_rank(records, name2tid, weights)
    taxid2path: Dict[str, Tuple[str, str]] = {}
    for tid in needed:
        ids, names = taxdb.taxpath(tid)
        taxid2path[tid] = (names, ids)
    with open(out_path, "w", encoding="utf-8") as f:
        emit_cami(f, counts, totals, taxid2path, sample_id)
    return len(records)


# ----------------------------------------------------------------------
# CAMI profile parsing (shared by the evaluator and harness)


def parse_cami_profile(path: str) -> List[Dict[str, str]]:
    """Rows of TAXID/RANK/TAXPATH/TAXPATHSN/PERCENTAGE; tolerant of header
    variants (used by eval + converters)."""
    rows: List[Dict[str, str]] = []
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#") or line.startswith("@"):
                continue
            parts = line.split("\t")
            if len(parts) < 5:
                continue
            try:
                pct = float(parts[4])
            except ValueError:
                continue
            rows.append(
                {
                    "taxid": parts[0].strip(),
                    "rank": parts[1].strip().lower(),
                    "taxpath": parts[2].strip(),
                    "taxpathsn": parts[3].strip(),
                    "percentage": pct,
                }
            )
    return rows
