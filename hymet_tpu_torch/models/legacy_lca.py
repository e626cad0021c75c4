"""Legacy classifier (parity with reference ``scripts/classification.py``,
invoked by ``main.pl:113``).

Differences from the production classifier:
  - exact-match shortcut: query id == ref id AND coverage >= 0.99 =>
    that taxid's full lineage, confidence 1.0 (``classification.py:53-55,
    143-151``);
  - identifier lookup is exact ``Identifiers`` tokens only (split on ';',
    no versionless/embedded-accession harvesting, ``classification.py:14-25``);
  - consensus works on raw ``rank:name`` lineage-string parts with weights
    normalized by the *total* weight over all resolved taxids
    (``classification.py:98-139``) — so per-rank confidences are not
    renormalized by the per-rank denominator;
  - output lineage joins with ';' (no space).

This path is host-only: it exists for behavioral completeness of the
``legacy`` CLI subcommand; the device backend is the fast one. (The port's
own copy of hymet_tpu.models.legacy_lca: the same bytes written.)
"""

from __future__ import annotations

import csv
import logging
from typing import Dict, List, Tuple

from hymet_tpu_torch import RANKS

logger = logging.getLogger("hymet_tpu_torch.legacy")


def load_taxonomy_exact(taxonomy_file: str) -> Dict[str, str]:
    """Exact Identifiers-token map (``classification.py:14-25``)."""
    taxonomy: Dict[str, str] = {}
    with open(taxonomy_file, "r", encoding="utf-8", newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            taxid = row["TaxID"]
            for identifier in (row.get("Identifiers") or "").split(";"):
                cleaned = identifier.strip()
                if cleaned:
                    taxonomy[cleaned] = taxid
    return taxonomy


def load_hierarchy_strings(hierarchy_file: str) -> Dict[str, str]:
    hierarchy: Dict[str, str] = {}
    with open(hierarchy_file, "r", encoding="utf-8", newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            hierarchy[row["TaxID"]] = (row.get("Lineage") or "").strip()
    return hierarchy


def parse_paf_legacy(
    paf_file: str,
) -> Tuple[Dict[str, List[Tuple[str, float, bool]]], Dict[str, int]]:
    query_map: Dict[str, List[Tuple[str, float, bool]]] = {}
    ref_counts: Dict[str, int] = {}
    with open(paf_file, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 11:
                continue
            query_id = parts[0]
            query_len = int(parts[1])
            ref_id = parts[5]
            align_len = int(parts[10])
            coverage = align_len / query_len if query_len > 0 else 0
            is_exact = (query_id == ref_id) and (coverage >= 0.99)
            query_map.setdefault(query_id, []).append((ref_id, coverage, is_exact))
            ref_counts[ref_id] = ref_counts.get(ref_id, 0) + 1
    return query_map, ref_counts


def deepest_rank(lineage: str) -> str:
    """Deepest recognized rank label in a ``rank:name;...`` lineage
    (``classification.py:61-81``)."""
    current = None
    for part in lineage.split(";"):
        part = part.strip()
        if ":" not in part:
            continue
        rank = part.split(":", 1)[0].strip().lower()
        if rank not in RANKS:
            continue
        if current is None or RANKS.index(rank) > RANKS.index(current):
            current = rank
    return current if current is not None else "root"


def _consensus(
    taxid_weights: Dict[str, float],
    total_weight: float,
    hierarchy: Dict[str, str],
) -> Tuple[str, str, float]:
    if total_weight == 0:
        return "Unknown", "root", 0.0
    lineages = [
        (hierarchy[tid].split(";"), w / total_weight)
        for tid, w in taxid_weights.items()
        if tid in hierarchy
    ]
    if not lineages:
        return "Unknown", "root", 0.0

    consensus: Dict[str, str] = {}
    confidence = 1.0
    for rank in RANKS:
        level_counts: Dict[str, float] = {}
        for lineage, weight in lineages:
            for part in lineage:
                if part.startswith(f"{rank}:"):
                    level_counts[part] = level_counts.get(part, 0.0) + weight
                    break
        if not level_counts:
            break
        best, conf = max(level_counts.items(), key=lambda kv: kv[1])
        consensus[rank] = best
        confidence *= conf

    parts = [consensus[r] for r in RANKS if consensus.get(r)]
    if not parts:
        return "Unknown", "root", 0.0
    full = ";".join(parts)
    return full, deepest_rank(full), min(confidence, 1.0)


def classify_query_legacy(
    refs: List[Tuple[str, float, bool]],
    ref_abundance: Dict[str, int],
    taxonomy: Dict[str, str],
    hierarchy: Dict[str, str],
) -> Tuple[str, str, float]:
    exact = [r for r, _, is_exact in refs if is_exact and r in taxonomy]
    if exact:
        taxid = taxonomy[exact[0]]
        if taxid in hierarchy:
            lineage = hierarchy[taxid]
            return lineage, deepest_rank(lineage), 1.0

    taxid_weights: Dict[str, float] = {}
    total_weight = 0.0
    for ref_id, coverage, _ in refs:
        if ref_id not in taxonomy:
            continue
        taxid = taxonomy[ref_id]
        weight = coverage * ref_abundance.get(ref_id, 1)
        taxid_weights[taxid] = taxid_weights.get(taxid, 0.0) + weight
        total_weight += weight
    return _consensus(taxid_weights, total_weight, hierarchy)


def classify_paf_legacy(
    paf_file: str,
    taxonomy_file: str,
    hierarchy_file: str,
    output_file: str,
) -> Tuple[int, int]:
    taxonomy = load_taxonomy_exact(taxonomy_file)
    logger.info("Loaded %d taxonomy mappings", len(taxonomy))
    hierarchy = load_hierarchy_strings(hierarchy_file)
    query_map, ref_abundance = parse_paf_legacy(paf_file)

    classified = 0
    with open(output_file, "w", encoding="utf-8", newline="") as f:
        writer = csv.writer(f, delimiter="\t")
        writer.writerow(["Query", "Lineage", "Taxonomic Level", "Confidence"])
        for query, refs in query_map.items():
            lineage, level, confidence = classify_query_legacy(
                refs, ref_abundance, taxonomy, hierarchy
            )
            if lineage != "Unknown":
                classified += 1
            writer.writerow([query, lineage, level, f"{confidence:.4f}"])
    return classified, len(query_map)
