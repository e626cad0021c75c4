"""Profile format converters to CAMI (copy of hymet_tpu.evalx.converters):
ports of the ``bench/convert/*`` stack, with taxonkit calls replaced by
:class:`TaxonomyDB`.

- :func:`metaphlan_to_cami` — MetaPhlAn ``k__|p__|...`` lineages
  (``metaphlan4_to_cami.py:37-60``)
- :func:`sourmash_gather_to_cami` — gather CSV fractions via a
  seqid->taxid map (``sourmash_gather_to_cami.py:42-99``)
- :func:`parse_kreport` — Kraken/Centrifuge report trees
  (``bench/convert/kreport.py:18-72``)

:func:`parse_kreport` and :func:`write_cami_profile` are the port's copies
of the JAX package's ``harness/baselines.py`` helpers, which the
converters use; the port's harness takes them from here.
"""

from __future__ import annotations

import csv
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from hymet_tpu_torch.taxonomy.db import TaxonomyDB

RANKS = ["superkingdom", "phylum", "class", "order", "family", "genus", "species"]
_KREPORT_RANK = {
    "D": "superkingdom",
    "K": "superkingdom",
    "P": "phylum",
    "C": "class",
    "O": "order",
    "F": "family",
    "G": "genus",
    "S": "species",
}

_MP_PREFIX = {
    "k": "superkingdom",
    "p": "phylum",
    "c": "class",
    "o": "order",
    "f": "family",
    "g": "genus",
    "s": "species",
}


def metaphlan_lineage_names(lineage: str) -> Dict[str, str]:
    """``k__Bacteria|p__Firmicutes|...`` -> {rank: name} (underscores in
    names become spaces, ``metaphlan4_to_cami.py:37-60``)."""
    out: Dict[str, str] = {}
    for comp in lineage.split("|"):
        if "__" not in comp:
            continue
        prefix, name = comp.split("__", 1)
        rank = _MP_PREFIX.get(prefix.lower())
        if rank:
            out[rank] = name.replace("_", " ").strip()
    return out


_MP_TAXCHAIN = re.compile(r"-?\d+(\|-?\d*)*")


def _parses_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _is_v4_layout(data: List[List[str]]) -> bool:
    """File-level dialect detection: the v3/v4 layout is assumed only
    when EVERY data row carries a taxid-chain-shaped column 2 with a
    parseable column-3 abundance AND some chain is multi-rank (contains
    '|'). Real v4 profiles always have multi-rank rows; a legacy file
    whose integer abundance happens to look like a bare taxid (e.g.
    ``k__X\\t12``, plus an extra column) must stay legacy — the old
    per-row heuristic misread column 3 as its abundance (ADVICE r3)."""
    if not data:
        return False
    chain_rows = [
        p
        for p in data
        if len(p) >= 3
        and _MP_TAXCHAIN.fullmatch(p[1].strip())
        and _parses_float(p[2])
    ]
    return len(chain_rows) == len(data) and any("|" in p[1] for p in chain_rows)


def read_metaphlan(path: str) -> List[Tuple[str, float]]:
    """(lineage, relative abundance) rows in BOTH MetaPhlAn dialects: the
    2-column legacy layout (clade_name, relative_abundance — what the
    reference's converter reads, ``metaphlan4_to_cami.py:18-34``) and the
    v3/v4 default (clade_name, NCBI_tax_id chain, relative_abundance,
    additional_species) where column 2 is a |-chain of taxids, never a
    decimal — the v4 layout made the old column heuristic read the taxid
    as the abundance (caught by tests/fixtures/metaphlan4_zymo.tsv).
    The dialect is decided once per file (see :func:`_is_v4_layout`)."""
    data: List[List[str]] = []
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2 or "__" not in parts[0]:
                continue
            data.append(parts)
    col = 2 if _is_v4_layout(data) else 1
    rows: List[Tuple[str, float]] = []
    for parts in data:
        try:
            abundance = float(parts[col])
        except ValueError:
            continue
        rows.append((parts[0], abundance))
    return rows


def metaphlan_to_cami(
    input_path: str, out_path: str, sample_id: str, taxdb: TaxonomyDB
) -> int:
    """Returns the number of converted rows."""
    records = read_metaphlan(input_path)
    cami_rows: List[Dict[str, str]] = []
    for lineage, abundance in records:
        ranked = metaphlan_lineage_names(lineage)
        target_rank = next((r for r in reversed(RANKS) if r in ranked), None)
        if not target_rank:
            continue
        tid = taxdb.name2taxid(ranked[target_rank])
        if tid:
            ids, names = taxdb.taxpath(tid)
        else:
            tid = "NA"
            ids = "|".join("NA" for _ in RANKS)
            names = "|".join("NA" for _ in RANKS)
        cami_rows.append(
            {
                "taxid": tid,
                "rank": target_rank,
                "taxpath": ids,
                "taxpathsn": names,
                "percentage": f"{abundance:.6f}",
            }
        )
    write_cami_profile(out_path, cami_rows, sample_id)
    return len(cami_rows)


# ----------------------------------------------------------------------


def sourmash_lookup_taxid(name: str, seqmap: Dict[str, str]) -> Optional[str]:
    """Signature-name -> taxid via token + versionless candidates
    (``sourmash_gather_to_cami.py:42-66``)."""
    if not name or not name.strip():
        return None
    cleaned = name.strip()
    candidates = re.split(r"[\s\|,;]+", cleaned)
    candidates.append(cleaned.split()[0])
    for cand in candidates:
        cand = cand.strip()
        if not cand:
            continue
        if cand in seqmap:
            return seqmap[cand]
        if "." in cand:
            base = cand.split(".", 1)[0]
            if base in seqmap:
                return seqmap[base]
    return None


def sourmash_gather_to_cami(
    gather_csv: str,
    seqmap: Dict[str, str],
    out_path: str,
    sample_id: str,
    taxdb: TaxonomyDB,
) -> int:
    totals: Dict[str, float] = defaultdict(float)
    with open(gather_csv, newline="", encoding="utf-8", errors="ignore") as f:
        reader = csv.DictReader(f)
        frac_keys = ["f_unique_to_query", "fraction_unique_to_query", "unique_fraction"]
        name_keys = ["name", "match_name", "filename"]
        for row in reader:
            if not row:
                continue
            frac = None
            for key in frac_keys:
                if row.get(key):
                    try:
                        frac = float(row[key])
                        break
                    except ValueError:
                        continue
            if frac is None or frac <= 0.0:
                continue
            name_val = next((row[k] for k in name_keys if row.get(k)), "")
            taxid = sourmash_lookup_taxid(name_val, seqmap)
            if taxid:
                totals[taxid] += frac * 100.0

    cami_rows: List[Dict[str, str]] = []
    for tid, pct in sorted(totals.items(), key=lambda kv: -kv[1]):
        ids, names = taxdb.taxpath(tid)
        # emit at the deepest resolvable rank of the taxid
        rank = taxdb.rank.get(taxdb.resolve(tid), "species")
        if rank == "domain":
            rank = "superkingdom"
        if rank not in RANKS:
            rank = "species"
        cami_rows.append(
            {
                "taxid": tid,
                "rank": rank,
                "taxpath": ids,
                "taxpathsn": names,
                "percentage": f"{pct:.6f}",
            }
        )
    write_cami_profile(out_path, cami_rows, sample_id)
    return len(cami_rows)


# ----------------------------------------------------------------------
# kreport trees and the shared CAMI writer


def parse_kreport(path: str) -> List[Dict[str, str]]:
    """Kraken-style report parser maintaining an indent-depth stack to
    rebuild taxpaths (port of ``bench/convert/kreport.py:18-72``)."""
    rows: List[Dict[str, str]] = []
    stack: List[Tuple[int, str, str, str]] = []  # (depth, taxid, name, rank)
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 6:
                continue
            pct, _clade, _direct, rank_code, taxid, name_field = parts[:6]
            depth = (len(name_field) - len(name_field.lstrip(" "))) // 2
            name = name_field.strip()
            rank = _KREPORT_RANK.get(rank_code.strip()[:1], "")
            while stack and stack[-1][0] >= depth:
                stack.pop()
            stack.append((depth, taxid.strip(), name, rank))
            if not rank:
                continue
            try:
                pct_f = float(pct)
            except ValueError:
                continue
            # reference semantics (bench/convert/kreport.py:60): zero-mass
            # clades and the unclassified pseudo-taxon never emit rows
            if pct_f <= 0.0 or taxid.strip() in ("0", "", "NA"):
                continue
            path_ids = [""] * len(RANKS)
            path_names = [""] * len(RANKS)
            for _, tid, nm, rk in stack:
                if rk in RANKS:
                    i = RANKS.index(rk)
                    path_ids[i] = tid
                    path_names[i] = nm
            rows.append(
                {
                    "taxid": taxid.strip(),
                    "rank": rank,
                    "taxpath": "|".join(path_ids),
                    "taxpathsn": "|".join(path_names),
                    "percentage": f"{pct_f:.6f}",
                }
            )
    return rows


def write_cami_profile(path: str, rows: List[Dict[str, str]], sample_id: str) -> None:
    """Shared CAMI writer with per-rank normalization to 100
    (port of ``bench/convert/common.py:56-87``)."""
    totals: Dict[str, float] = {r: 0.0 for r in RANKS}
    for row in rows:
        try:
            totals[row["rank"]] += float(row["percentage"])
        except (KeyError, ValueError):
            pass
    with open(path, "w", encoding="utf-8") as f:
        f.write("#CAMI Submission for Taxonomic Profiling\n")
        f.write(
            "@Version:0.9.1 @Ranks:superkingdom|phylum|class|order|family|genus|species "
            f"@SampleID:{sample_id}\n"
        )
        f.write("@@TAXID RANK TAXPATH TAXPATHSN PERCENTAGE\n")
        for rank in RANKS:
            total = totals.get(rank, 0.0)
            if total <= 0:
                continue
            for row in rows:
                if row["rank"] != rank:
                    continue
                pct = float(row["percentage"]) * 100.0 / total
                f.write(
                    f"{row['taxid']}\t{rank}\t{row['taxpath']}\t{row['taxpathsn']}\t{pct:.6f}\n"
                )
