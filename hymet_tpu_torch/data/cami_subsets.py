"""Derived-CAMI-sample generation (copy of hymet_tpu.data.cami_subsets):
port of reference
``tools/generate_cami_subsets.py``.

Partitions a CAMI sample's taxa (sorted by assembled length, descending)
into derived samples per a partition spec (the reference default: 6
samples of 8/12/14/14/12/12 taxa, ``generate_cami_subsets.py:340-347``),
writing per-sample ``contigs.fna``, ``truth_contigs.tsv`` (original
mapping rows), and a length-weighted CAMI truth profile built from the
taxonomy (``:185-301``), with the "0"/unclassified taxpath convention.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Iterable, List, Sequence, Tuple

from hymet_tpu_torch.taxonomy.db import TaxonomyDB

RANKS = [
    "superkingdom",
    "phylum",
    "class",
    "order",
    "family",
    "genus",
    "species",
    "strain",
]

DEFAULT_PARTITIONS = [
    ("cami_i_lc", 8),
    ("cami_i_mc", 12),
    ("cami_i_hc", 14),
    ("cami_ii_mousegut", 14),
    ("cami_ii_marine", 12),
    ("cami_ii_strainmadness", 12),
]

_ALIAS = {
    "domain": "superkingdom",
    "kingdom": "superkingdom",
    "superkingdom": "superkingdom",
    "phylum": "phylum",
    "class": "class",
    "order": "order",
    "family": "family",
    "genus": "genus",
    "species": "species",
    "subspecies": "species",
    "strain": "strain",
}


def _lineage_ranks(taxid: str, db: TaxonomyDB) -> Dict[str, str]:
    """rank -> ancestor taxid (including taxid itself)."""
    out: Dict[str, str] = {}
    current = db.resolve(taxid)
    seen = set()
    while current and current not in seen:
        seen.add(current)
        rk = _ALIAS.get(db.rank.get(current, "").lower())
        if rk in RANKS and rk not in out:
            out[rk] = current
        nxt = db.parent.get(current)
        if not nxt or nxt == current:
            break
        current = nxt
    return out


def _build_taxpath(
    taxid: str, upto_rank: str, db: TaxonomyDB, cache: Dict[str, Dict[str, str]]
) -> Tuple[str, str]:
    if taxid == "0":
        count = RANKS.index(upto_rank) + 1
        return "|".join(["0"] * count), "|".join(["unclassified"] * count)
    if taxid not in cache:
        cache[taxid] = _lineage_ranks(taxid, db)
    lineage = cache[taxid]
    ids: List[str] = []
    nms: List[str] = []
    for rk in RANKS:
        anc = lineage.get(rk)
        if anc:
            ids.append(anc)
            nms.append(db.name.get(anc, f"taxid_{anc}"))
        else:
            ids.append("0")
            nms.append("unclassified")
        if rk == upto_rank:
            break
    return "|".join(ids), "|".join(nms)


def generate_cami_subsets(
    fasta: str,
    mapping: str,
    taxdb: TaxonomyDB,
    out_root: str,
    partitions: Sequence[Tuple[str, int]] = tuple(DEFAULT_PARTITIONS),
) -> Dict[str, List[str]]:
    """Returns {sample_name: [taxids]}; writes the per-sample trees."""
    contig_rows: Dict[str, str] = {}
    contig_taxid: Dict[str, str] = {}
    contig_len: Dict[str, int] = {}
    taxid_lengths: Dict[str, int] = collections.defaultdict(int)
    with open(mapping, encoding="utf-8") as handle:
        header = handle.readline().rstrip("\n")
        for line in handle:
            if not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 7:
                continue
            contig_id = parts[0]
            taxid = parts[2]
            start = int(parts[5])
            end = int(parts[6])
            length = max(0, end - start + 1)
            contig_rows[contig_id] = line
            contig_taxid[contig_id] = taxid
            contig_len[contig_id] = length
            taxid_lengths[taxid] += length

    ordered = [t for t, _ in sorted(taxid_lengths.items(), key=lambda kv: -kv[1])]
    sample_defs: List[Tuple[str, List[str]]] = []
    taxid_to_sample: Dict[str, str] = {}
    idx = 0
    for name, count in partitions:
        subset = ordered[idx : idx + count]
        if len(subset) < count:
            raise RuntimeError(
                f"Not enough taxa for {name}: requested {count}, got {len(subset)}"
            )
        idx += count
        sample_defs.append((name, subset))
        for tid in subset:
            taxid_to_sample[tid] = name

    cache: Dict[str, Dict[str, str]] = {}
    samples = {
        name: {
            "contigs": [],
            "total_length": 0,
            "rank_sums": {rk: collections.defaultdict(int) for rk in RANKS},
        }
        for name, _ in sample_defs
    }
    for contig_id, taxid in contig_taxid.items():
        name = taxid_to_sample.get(taxid)
        if not name:
            continue
        entry = samples[name]
        entry["contigs"].append(contig_id)
        length = contig_len[contig_id]
        entry["total_length"] += length
        lineage = _lineage_ranks(taxid, taxdb)
        cache[taxid] = lineage
        for rk in RANKS:
            anc = lineage.get(rk)
            entry["rank_sums"][rk][anc if anc else "0"] += length

    # truth contig tables
    for name, data in samples.items():
        sdir = os.path.join(out_root, name)
        os.makedirs(sdir, exist_ok=True)
        with open(os.path.join(sdir, "truth_contigs.tsv"), "w", encoding="utf-8") as f:
            f.write(header + "\n")
            for contig_id in data["contigs"]:
                f.write(contig_rows[contig_id])

    # contig FASTAs (stream once)
    from hymet_tpu_torch.io.fasta import iter_fasta

    handles = {
        name: open(os.path.join(out_root, name, "contigs.fna"), "w", encoding="utf-8")
        for name in samples
    }
    try:
        for cid, seq in iter_fasta(fasta):
            taxid = contig_taxid.get(cid)
            name = taxid_to_sample.get(taxid) if taxid else None
            if name:
                handles[name].write(f">{cid}\n")
                s = seq.decode()
                for i in range(0, len(s), 80):
                    handles[name].write(s[i : i + 80] + "\n")
    finally:
        for fh in handles.values():
            fh.close()

    # truth profiles (length-weighted, reference header format)
    for name, data in samples.items():
        total = data["total_length"] or 1
        path = os.path.join(out_root, name, "truth_profile.tsv")
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"@SampleID: {name}\n")
            f.write("@Version: 0.9.1\n")
            f.write("@Ranks:superkingdom|phylum|class|order|family|genus|species|strain\n")
            f.write("@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE\t_CAMI_GENOMEID\n\n")
            for rk in RANKS:
                items = sorted(
                    data["rank_sums"][rk].items(), key=lambda kv: (-kv[1], kv[0])
                )
                for taxid, length in items:
                    if length <= 0:
                        continue
                    taxpath, taxpathsn = _build_taxpath(taxid, rk, taxdb, cache)
                    f.write(
                        f"{taxid}\t{rk}\t{taxpath}\t{taxpathsn}\t{(length / total) * 100.0:.4f}\n"
                    )
    return {name: taxids for name, taxids in sample_defs}
