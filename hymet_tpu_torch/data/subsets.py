"""FASTA subsetting + seqid->taxid maps (copy of hymet_tpu.data.subsets).

Ports of ``bench/lib/subset_fasta.py`` (cap sequences/bases; stops after
the first truncated sequence) and ``bench/lib/make_seqid_map.py`` (map
FASTA headers to taxids through an id-map with versionless + token
fallbacks).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

from hymet_tpu_torch.io.fasta import iter_fasta


def subset_fasta(
    input_path: str,
    output_path: str,
    max_seqs: int = 1000,
    max_bases: int = 500_000_000,
) -> Tuple[int, int]:
    """Emit up to max_seqs/max_bases; 80-column wrapping; a truncated
    sequence ends the subset (``subset_fasta.py:62-75``)."""
    os.makedirs(os.path.dirname(os.path.abspath(output_path)) or ".", exist_ok=True)
    emitted_seqs = 0
    emitted_bases = 0
    with open(output_path, "w", encoding="utf-8") as out:
        for name, seq in iter_fasta(input_path):
            if emitted_seqs >= max_seqs or emitted_bases >= max_bases:
                break
            remaining = max_bases - emitted_bases
            sub = seq if len(seq) <= remaining else seq[:remaining]
            out.write(f">{name}\n")
            for i in range(0, len(sub), 80):
                out.write(sub[i : i + 80].decode() + "\n")
            emitted_seqs += 1
            emitted_bases += len(sub)
            if len(sub) < len(seq):
                break
    return emitted_seqs, emitted_bases


_TOKEN_SPLIT = re.compile(r"[\s\|,;]+")


def make_seqid_map(
    fasta_path: str,
    id_map: Dict[str, str],
    out_path: str,
) -> Tuple[int, int]:
    """seqid -> taxid table from FASTA headers; versionless + token
    fallbacks (``make_seqid_map.py:38-69``). Returns (mapped, total)."""

    def lookup(key: str) -> Optional[str]:
        if key in id_map:
            return id_map[key]
        if "." in key:
            base = key.split(".", 1)[0]
            if base in id_map:
                return id_map[base]
        return None

    mapped = 0
    total = 0
    with open(out_path, "w", encoding="utf-8") as out:
        for name, _seq in iter_fasta(fasta_path):
            total += 1
            tax = lookup(name)
            if not tax:
                for tok in _TOKEN_SPLIT.split(name):
                    tax = lookup(tok)
                    if tax:
                        break
            if tax:
                out.write(f"{name}\t{tax}\n")
                mapped += 1
    return mapped, total
