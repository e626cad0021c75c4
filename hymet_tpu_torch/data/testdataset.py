"""Synthetic test-dataset toolkit (copy of hymet_tpu.data.testdataset):
ports of ``testdataset/*``.

The paper's self-validation data: sample a fraction of reference genomes
(``createDatabase.py:86-89``), trim to the first 10% of bases with the
reference's multi-sequence distribution rule (``filterGCF.py:11-39``),
apply per-base point mutations at a chosen rate keeping non-ACGT
characters unchanged (``mutationGCF.py:4-18``), and emit GCF->sequence-id
maps (``extractNC.py:7-34``) and taxonomy tables
(``extractTaxonomy.py`` — from a local catalog instead of Entrez).

The reference scripts are interactive (stdin prompts); these are plain
functions + CLI-able, seeded for reproducibility.
"""

from __future__ import annotations

import csv
import glob
import gzip
import os
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from hymet_tpu_torch.io.fasta import iter_fasta


def sample_genomes(
    genome_files: Sequence[str], fraction: float = 0.1, seed: int = 0
) -> List[str]:
    """Random fraction of genome files (``createDatabase.py:86-89`` uses
    random.sample over the per-domain assembly list)."""
    rng = random.Random(seed)
    k = max(1, int(len(genome_files) * fraction))
    return sorted(rng.sample(list(genome_files), min(k, len(genome_files))))


def trim_first_fraction(
    seqs: List[Tuple[str, bytes]], fraction: float = 0.1
) -> List[Tuple[str, bytes, str]]:
    """First-`fraction`-of-bases trim with the reference's distribution:
    single sequence keeps the first target_bases; multiple sequences split
    target bases evenly with the remainder on the last
    (``filterGCF.py:11-39``). Returns (id, seq, description)."""
    total = sum(len(s) for _, s in seqs)
    target = int(total * fraction)
    if len(seqs) == 1:
        name, seq = seqs[0]
        return [(name, seq[:target], f"First segment (1-{target})")]
    out: List[Tuple[str, bytes, str]] = []
    per = target // len(seqs)
    rem = target % len(seqs)
    for i, (name, seq) in enumerate(seqs):
        take = per + rem if i == len(seqs) - 1 else per
        if len(seq) > take:
            out.append((name, seq[:take], f"First {take} bases"))
        else:
            out.append((name, seq, "Full sequence (shorter than target segment)"))
    return out


def mutate_sequence(seq: bytes, rate: float, rng: random.Random) -> bytes:
    """Per-base substitutions to a different base at `rate`; non-ACGT
    unchanged (``mutationGCF.py:4-18``)."""
    bases = b"ACGT"
    out = bytearray(seq)
    for i, b in enumerate(out):
        if b not in bases:
            continue
        if rng.random() < rate:
            choices = [x for x in bases if x != b]
            out[i] = rng.choice(choices)
    return bytes(out)


def build_test_dataset(
    genome_dir: str,
    out_dir: str,
    fraction_genomes: float = 0.1,
    trim_fraction: float = 0.1,
    mutation_rate: float = 0.02,
    seed: int = 0,
) -> Dict[str, List[str]]:
    """Full testdataset pipeline: sample -> trim -> mutate; writes
    per-genome mutated FASTAs plus gcf2seqid.tsv. Returns
    {gcf: [sequence ids]}."""
    files = sorted(
        glob.glob(os.path.join(genome_dir, "**", "*.fna*"), recursive=True)
    )
    chosen = sample_genomes(files, fraction_genomes, seed)
    rng = random.Random(seed + 1)
    os.makedirs(out_dir, exist_ok=True)
    gcf_map: Dict[str, List[str]] = {}
    for path in chosen:
        base = os.path.basename(path)
        gcf = "_".join(base.split("_")[:2])
        seqs = list(iter_fasta(path))
        trimmed = trim_first_fraction(seqs, trim_fraction)
        out_path = os.path.join(out_dir, f"{gcf}_test.fna")
        ids: List[str] = []
        with open(out_path, "w", encoding="utf-8") as f:
            for name, seq, desc in trimmed:
                mutated = mutate_sequence(seq, mutation_rate, rng)
                f.write(f">{name} {desc}\n")
                for i in range(0, len(mutated), 80):
                    f.write(mutated[i : i + 80].decode() + "\n")
                ids.append(name)
        gcf_map[gcf] = ids

    with open(os.path.join(out_dir, "gcf2seqid.tsv"), "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["GCF", "SeqIDs"])
        for gcf, ids in sorted(gcf_map.items()):
            w.writerow([gcf, ";".join(ids)])
    return gcf_map


def extract_gcf_seqids(genome_files: Sequence[str]) -> Dict[str, List[str]]:
    """GCF -> sequence ids map from FASTA headers (``extractNC.py:7-34``)."""
    out: Dict[str, List[str]] = {}
    for path in genome_files:
        gcf = "_".join(os.path.basename(path).split("_")[:2])
        out[gcf] = [name for name, _ in iter_fasta(path)]
    return out


def extract_taxonomy_table(
    gcf_taxids: Dict[str, str],
    taxdb,
    out_path: str,
) -> None:
    """Taxonomy CSV per GCF (``extractTaxonomy.py`` semantics, resolved
    through the in-process TaxonomyDB instead of Entrez)."""
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["GCF", "TaxID", "Lineage"])
        for gcf, taxid in sorted(gcf_taxids.items()):
            w.writerow([gcf, taxid, taxdb.lineage_string(taxid)])
