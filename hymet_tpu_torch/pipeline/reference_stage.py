"""Reference set construction: the downloadDB.py replacement (copy of
hymet_tpu.pipeline.reference_stage).

Reproduces reference ``scripts/downloadDB.py``:
  - resolve candidate names (``GCF_xxx_..._genomic.fna.gz`` filenames) to
    genome sources via assembly summaries,
  - fetch with bounded parallelism + exponential-backoff retries
    (``downloadDB.py:113-176``; we use urllib instead of wget),
  - build ``detailed_taxonomy.tsv`` (GCF / TaxID / Identifiers) by
    scanning FASTA headers (``downloadDB.py:178-207``),
  - concatenate into ``combined_genomes.fasta`` (``downloadDB.py:209-222``).

Plus an **offline catalog source** (the primary path in air-gapped
deployments, mirroring the reference's own preloaded-cache route,
``case/results_summary.md:121-160``): a local directory of genome FASTAs +
a taxid table (accession -> taxid, e.g. the in-repo Zymo ``refs.tsv``).
"""

from __future__ import annotations

import csv
import gzip
import logging
import os
import shutil
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

logger = logging.getLogger("hymet_tpu_torch.reference")

MAX_WORKERS = 64  # downloadDB.py:14
RETRIES = 3


def extract_gcf(filename: str) -> str:
    """First two '_'-tokens (``downloadDB.py:106-111``)."""
    parts = filename.split("_")
    if len(parts) >= 2:
        return f"{parts[0]}_{parts[1]}"
    return filename


class LocalGenomeCatalog:
    """Offline genome source: accession -> (fasta path, taxid)."""

    def __init__(self) -> None:
        self.paths: Dict[str, str] = {}
        self.taxids: Dict[str, str] = {}

    @classmethod
    def from_refs_tsv(cls, refs_tsv: str, base_dir: Optional[str] = None) -> "LocalGenomeCatalog":
        """Load from a refs.tsv-style table (columns incl.
        assembly_accession, taxid, local_fasta — the in-repo Zymo panel
        format, reference case/truth/zymo_refs/refs.tsv)."""
        cat = cls()
        base = base_dir or os.path.dirname(os.path.abspath(refs_tsv))
        with open(refs_tsv, "r", encoding="utf-8") as f:
            reader = csv.DictReader(f, delimiter="\t")
            for row in reader:
                acc = (row.get("assembly_accession") or "").strip()
                taxid = (row.get("taxid") or "").strip()
                local = (row.get("local_fasta") or "").strip()
                ftp_file = (row.get("ftp_file") or "").strip()
                if not acc:
                    continue
                path = cls._resolve_local(local, ftp_file, base)
                if path:
                    cat.paths[acc] = path
                    cat.taxids[acc] = taxid
        return cat

    @staticmethod
    def _resolve_local(local: str, ftp_file: str, base: str) -> Optional[str]:
        cands = []
        if local:
            cands.append(local)
            cands.append(os.path.join(base, os.path.basename(local)))
            # refs.tsv paths are repo-relative ("HYMET/case/...") — search
            # for the basename under base
        if ftp_file:
            cands.append(os.path.join(base, ftp_file))
        for c in cands:
            if os.path.exists(c):
                return c
        # recursive basename search
        target = os.path.basename(local or ftp_file)
        if target:
            for root, _, files in os.walk(base):
                if target in files:
                    return os.path.join(root, target)
        return None

    @classmethod
    def from_directory(
        cls, genome_dir: str, seqid2taxid: Optional[str] = None
    ) -> "LocalGenomeCatalog":
        """Every *.fna/*.fna.gz under `genome_dir`; taxids default empty
        (fill from an accession->taxid table if provided)."""
        cat = cls()
        taxmap: Dict[str, str] = {}
        if seqid2taxid and os.path.exists(seqid2taxid):
            with open(seqid2taxid, "r", encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2:
                        taxmap[parts[0].strip()] = parts[1].strip()
        for root, _, files in os.walk(genome_dir):
            for fn in sorted(files):
                if fn.endswith((".fna", ".fna.gz", ".fa", ".fasta", ".fa.gz", ".fasta.gz")):
                    acc = extract_gcf(fn)
                    cat.paths.setdefault(acc, os.path.join(root, fn))
                    if acc in taxmap:
                        cat.taxids[acc] = taxmap[acc]
        return cat


class AssemblySummarySource:
    """Online source resolved via NCBI assembly summaries (requires
    network; retries with exponential backoff like ``downloadDB.py``)."""

    def __init__(self, assembly_dir: str):
        self.meta: Dict[str, Dict[str, str]] = {}
        for name in ("assembly_summary_refseq.txt", "assembly_summary_genbank.txt"):
            path = os.path.join(assembly_dir, name)
            if not os.path.exists(path):
                continue
            with open(path, "r", encoding="utf-8", errors="ignore") as f:
                for line in f:
                    if line.startswith("#"):
                        continue
                    row = line.rstrip("\n").split("\t")
                    if len(row) < 20:
                        continue
                    acc = row[0].strip()
                    self.meta.setdefault(
                        acc,
                        {"taxid": row[5].strip(), "ftp_path": row[19].strip()},
                    )

    def fetch(self, gcf: str, out_dir: str) -> Optional[str]:
        meta = self.meta.get(gcf)
        if not meta or not meta["ftp_path"] or meta["ftp_path"] == "na":
            return None
        url = f"{meta['ftp_path']}/{os.path.basename(meta['ftp_path'])}_genomic.fna.gz"
        out_path = os.path.join(out_dir, os.path.basename(url))
        if os.path.exists(out_path):
            return out_path
        tmp = out_path + ".part"
        for attempt in range(RETRIES):
            try:
                urllib.request.urlretrieve(url, tmp)
                os.replace(tmp, out_path)
                return out_path
            except Exception as e:  # noqa: BLE001
                logger.warning("attempt %d/%d failed for %s: %s", attempt + 1, RETRIES, gcf, e)
                if attempt < RETRIES - 1:
                    time.sleep(2**attempt)
        return None


def build_reference_from_combined(
    combined_fasta: str,
    out_dir: str,
    seqid2taxid: Optional[str] = None,
) -> Tuple[str, str]:
    """Preset-reference mode (the bench/ablation subset-reference path):
    the given FASTA *is* the combined reference. Builds
    detailed_taxonomy.tsv by mapping each sequence header through the
    seqid->taxid table, grouping identifiers per taxid."""
    os.makedirs(out_dir, exist_ok=True)
    taxmap: Dict[str, str] = {}
    if seqid2taxid and os.path.exists(seqid2taxid):
        with open(seqid2taxid, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    taxmap[parts[0].strip()] = parts[1].strip()

    by_taxid: Dict[str, List[str]] = {}
    combined_out = os.path.join(out_dir, "combined_genomes.fasta")
    with _open_genome(combined_fasta) as fin, open(
        combined_out, "w", encoding="utf-8"
    ) as fout:
        for line in fin:
            if line.startswith(">"):
                seqid = line.split()[0][1:]
                taxid = taxmap.get(seqid) or taxmap.get(seqid.split(".", 1)[0], "Unknown TaxID")
                by_taxid.setdefault(taxid, []).append(seqid)
            fout.write(line)

    taxonomy = os.path.join(out_dir, "detailed_taxonomy.tsv")
    with open(taxonomy, "w", encoding="utf-8", newline="") as tax_f:
        writer = csv.writer(tax_f, delimiter="\t")
        writer.writerow(["GCF", "TaxID", "Identifiers"])
        for i, (taxid, seqids) in enumerate(sorted(by_taxid.items())):
            writer.writerow([f"SET_{i:06d}", taxid, ";".join(seqids)])
    return combined_out, taxonomy


def _open_genome(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8", errors="ignore")
    return open(path, "r", encoding="utf-8", errors="ignore")


def build_reference_set(
    selected_names: Sequence[str],
    out_dir: str,
    catalog: Optional[LocalGenomeCatalog] = None,
    summary_source: Optional[AssemblySummarySource] = None,
    max_workers: int = MAX_WORKERS,
) -> Tuple[str, str, List[str]]:
    """Resolve + (fetch) + scan + concatenate.

    Returns (combined_fasta, detailed_taxonomy_tsv, missing_names).
    Sources are tried in order: local catalog, then the online summary
    source (if provided). Missing genomes are skipped with a warning — the
    reference behaves the same (failed downloads logged, pipeline
    continues, ``downloadDB.py:120-127``).
    """
    os.makedirs(out_dir, exist_ok=True)
    resolved: List[Tuple[str, str, str]] = []  # (gcf, path, taxid)
    missing: List[str] = []
    to_fetch: List[str] = []

    for name in selected_names:
        gcf = extract_gcf(name)
        if catalog and gcf in catalog.paths:
            resolved.append((gcf, catalog.paths[gcf], catalog.taxids.get(gcf, "Unknown TaxID")))
        elif summary_source:
            to_fetch.append(gcf)
        else:
            missing.append(name)

    if to_fetch and summary_source:
        dl_dir = os.path.join(out_dir, "download_cache")
        os.makedirs(dl_dir, exist_ok=True)
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            futs = {ex.submit(summary_source.fetch, g, dl_dir): g for g in to_fetch}
            for fut in as_completed(futs):
                gcf = futs[fut]
                try:
                    path = fut.result()
                except Exception:  # noqa: BLE001
                    path = None
                if path:
                    taxid = summary_source.meta.get(gcf, {}).get("taxid", "Unknown TaxID")
                    resolved.append((gcf, path, taxid))
                else:
                    missing.append(gcf)

    # deterministic order: selected_names order
    order = {extract_gcf(n): i for i, n in enumerate(selected_names)}
    resolved.sort(key=lambda t: order.get(t[0], 1 << 30))

    combined = os.path.join(out_dir, "combined_genomes.fasta")
    taxonomy = os.path.join(out_dir, "detailed_taxonomy.tsv")
    with open(combined, "w", encoding="utf-8") as out_f, open(
        taxonomy, "w", encoding="utf-8", newline=""
    ) as tax_f:
        writer = csv.writer(tax_f, delimiter="\t")
        writer.writerow(["GCF", "TaxID", "Identifiers"])
        for gcf, path, taxid in resolved:
            identifiers = []
            with _open_genome(path) as f:
                for line in f:
                    if line.startswith(">"):
                        identifiers.append(line.split()[0][1:])
                    out_f.write(line)
                if identifiers and not line.endswith("\n"):
                    out_f.write("\n")
            writer.writerow([gcf, taxid, ";".join(identifiers)])

    if missing:
        logger.warning("missing %d reference genomes: %s", len(missing), missing[:5])
    return combined, taxonomy, missing
