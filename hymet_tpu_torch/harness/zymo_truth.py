"""Zymo mock-community truth builder: port of reference
``case/truth/build_zymo_truth.py``.

Maps assembly contigs vs the curated multi-strain reference panel (PAF)
to per-contig truth: filter min_match 1000 bp / identity >= 0.95
(preferring the ``dv:f:`` tag) / coverage >= 0.5; keep hits within 1% of
the best match; unique species => species call, else unique genus =>
genus call; emit the contig truth TSV and a length-weighted CAMI truth
profile with the Bacteria->3379134 ALT_SUPERKINGDOM remap
(``build_zymo_truth.py:91-308``). taxonkit calls become TaxonomyDB.
Copy of hymet_tpu.harness.zymo_truth (host code), but for one thing: the
seqmap is required, where the JAX package falls back to a path of its
own machine's reference data.
"""

from __future__ import annotations

import csv
import logging
import os
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from hymet_tpu_torch.io.fasta import iter_fasta
from hymet_tpu_torch.io.paf import PafRecord, iter_paf
from hymet_tpu_torch.taxonomy.db import TaxonomyDB

logger = logging.getLogger("hymet_tpu_torch.zymo_truth")

RANKS = ["superkingdom", "phylum", "class", "order", "family", "genus", "species"]
ALT_SUPERKINGDOM = {"Bacteria": 3379134}


def load_seqmap(path: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) >= 2 and row[0].strip():
                try:
                    out[row[0].strip()] = int(row[1])
                except ValueError:
                    continue
    return out


def _hit_identity(rec: PafRecord) -> float:
    """Gap-compressed identity, preferring minimap2's ``dv:f:`` divergence
    tag over nmatch/blocklen (reference build_zymo_truth.py:114-124)."""
    dv_tag = rec.tags.get("dv", "")
    if dv_tag.startswith("f:"):
        return 1.0 - float(dv_tag[2:])
    return rec.nmatch / rec.blocklen


def parse_truth_paf(
    path: str,
    seq2tax: Dict[str, int],
    min_match: int = 1000,
    min_identity: float = 0.95,
    min_coverage: float = 0.5,
) -> Dict[str, List[Tuple[int, str, int, float, float]]]:
    """Collect taxid-resolvable PAF hits per contig that clear the truth
    thresholds: ``min_match`` aligned bases, ``min_identity`` (dv-tag
    preferred), and ``min_coverage`` of the query span
    (reference build_zymo_truth.py:91-131; thresholds ARE the spec)."""
    hits: Dict[str, List[Tuple[int, str, int, float, float]]] = defaultdict(list)
    for rec in iter_paf(path):
        if rec.nmatch < min_match or rec.blocklen <= 0:
            continue
        identity = _hit_identity(rec)
        if identity < min_identity:
            continue
        span_cov = (rec.qend - rec.qstart) / rec.qlen if rec.qlen > 0 else 0.0
        if span_cov < min_coverage:
            continue
        taxid = seq2tax.get(rec.tname)
        if taxid is not None:
            hits[rec.qname].append((taxid, rec.tname, rec.nmatch, identity, span_cov))
    return hits


def assign_truth_taxids(
    hits: Dict[str, List[Tuple[int, str, int, float, float]]],
    taxdb: TaxonomyDB,
    tolerance: float = 0.01,
) -> Dict[str, Tuple[int, str, int, float, float]]:
    assignments: Dict[str, Tuple[int, str, int, float, float]] = {}
    for contig, rows in hits.items():
        if not rows:
            continue
        best_match = max(row[2] for row in rows)
        threshold = best_match * (1.0 - tolerance)
        kept = [row for row in rows if row[2] >= threshold]
        species_taxids = {row[0] for row in kept}
        chosen_rank = "species"
        chosen: Optional[int] = None
        if len(species_taxids) == 1:
            chosen = next(iter(species_taxids))
        else:
            genus_taxids = set()
            for taxid in species_taxids:
                g = taxdb.ancestor_at_rank(str(taxid), "genus")
                if g:
                    genus_taxids.add(int(g))
            if len(genus_taxids) == 1:
                chosen = next(iter(genus_taxids))
                chosen_rank = "genus"
        if chosen:
            primary = max(kept, key=lambda r: r[2])
            assignments[contig] = (
                chosen,
                chosen_rank,
                primary[2],
                primary[3] * 100.0,
                primary[4] * 100.0,
            )
    return assignments


def build_truth_profile(
    assignments: Dict[str, Tuple[int, str, int, float, float]],
    lengths: Dict[str, int],
    taxdb: TaxonomyDB,
) -> List[Tuple[str, str, str, str, float]]:
    totals: Counter = Counter()
    accum: Dict[str, Counter] = {rank: Counter() for rank in RANKS}
    paths: Dict[int, Tuple[str, str]] = {}
    for _, (taxid, *_rest) in assignments.items():
        if taxid not in paths:
            ids, names = taxdb.taxpath(str(taxid))
            paths[taxid] = (names, ids)

    # include ancestor taxids' paths for row emission
    ancestor: set = set()
    for names, ids in paths.values():
        for tid in ids.split("|"):
            if tid and tid != "NA":
                ancestor.add(int(tid))
    for tid in ancestor:
        if tid not in paths:
            ids, names = taxdb.taxpath(str(tid))
            paths[tid] = (names, ids)

    for contig, (taxid, *_rest) in assignments.items():
        length = lengths.get(contig, 1)
        names_ids = paths.get(taxid)
        if not names_ids:
            continue
        id_list = names_ids[1].split("|")
        for idx, rank in enumerate(RANKS):
            if idx >= len(id_list):
                continue
            tid = id_list[idx]
            if not tid or tid == "NA":
                continue
            accum[rank][int(tid)] += length
            totals[rank] += length

    rows: List[Tuple[str, str, str, str, float]] = []
    for rank in RANKS:
        total = totals.get(rank, 0)
        if total <= 0:
            continue
        for tid, length in accum[rank].items():
            names_ids = paths.get(tid)
            if not names_ids:
                continue
            names, ids = names_ids
            rows.append((str(tid), rank, ids, names, 100.0 * length / total))
    return rows


def build_zymo_truth(
    contigs: str,
    paf: str,
    out_contigs: str,
    out_profile: str,
    seqmap: Optional[str] = None,
    taxonomy_dir: Optional[str] = None,
    min_match: int = 1000,
    min_identity: float = 0.95,
    min_coverage: float = 0.5,
    tolerance: float = 0.01,
) -> Dict[str, Tuple[int, str, int, float, float]]:
    if not seqmap:
        raise ValueError("a seqmap (reference sequence id -> taxid TSV, --seqmap) is required")
    taxdb = _load_taxdb(taxonomy_dir)
    seq2tax = load_seqmap(seqmap)
    lengths = {name: len(seq) for name, seq in iter_fasta(contigs)}
    hits = parse_truth_paf(paf, seq2tax, min_match, min_identity, min_coverage)
    assignments = assign_truth_taxids(hits, taxdb, tolerance)

    n_species = sum(1 for v in assignments.values() if v[1] == "species")
    n_genus = sum(1 for v in assignments.values() if v[1] == "genus")
    logger.info(
        "Assigned %d contigs (%d species-level, %d genus-level)",
        len(assignments),
        n_species,
        n_genus,
    )

    with open(out_contigs, "w", newline="") as out:
        writer = csv.writer(out, delimiter="\t")
        writer.writerow(
            ["contig_id", "taxid", "rank", "match_bases", "identity_percent", "coverage_percent"]
        )
        for contig, (taxid, rank, match, ident, cov) in sorted(assignments.items()):
            writer.writerow([contig, taxid, rank, match, f"{ident:.2f}", f"{cov:.2f}"])

    rows = build_truth_profile(assignments, lengths, taxdb)
    with open(out_profile, "w") as out:
        out.write("#CAMI Submission for Taxonomic Profiling\n")
        out.write(
            "@Version:0.9.1 @Ranks:superkingdom|phylum|class|order|family|genus|species "
            "@SampleID:zymo_mc_truth\n"
        )
        out.write("@@TAXID RANK TAXPATH TAXPATHSN PERCENTAGE\n")
        for tid, rank_name, ids, names, pct in sorted(
            rows, key=lambda x: (RANKS.index(x[1]), -x[4])
        ):
            write_tid = tid
            if rank_name == "superkingdom":
                first_name = names.split("|")[0] if names else ""
                alt = ALT_SUPERKINGDOM.get(first_name)
                if alt:
                    write_tid = str(alt)
            out.write(f"{write_tid}\t{rank_name}\t{ids}\t{names}\t{pct:.6f}\n")
    return assignments


def _load_taxdb(taxonomy_dir: Optional[str]) -> TaxonomyDB:
    taxonomy_dir = taxonomy_dir or os.environ.get("TAXONKIT_DB") or os.environ.get("TAXONOMY_DIR")
    if taxonomy_dir:
        if os.path.exists(os.path.join(taxonomy_dir, "names.dmp")):
            return TaxonomyDB.from_taxdump(taxonomy_dir)
        tsv = (
            taxonomy_dir
            if taxonomy_dir.endswith(".tsv")
            else os.path.join(taxonomy_dir, "taxonomy_hierarchy.tsv")
        )
        if os.path.exists(tsv):
            return TaxonomyDB.from_hierarchy_tsv(tsv)
    raise RuntimeError("taxonomy_dir with names.dmp or taxonomy_hierarchy.tsv required")
