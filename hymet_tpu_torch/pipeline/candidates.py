"""Candidate limiting (copy of hymet_tpu.pipeline.candidates): parity with
reference ``scripts/limit_candidates.py``.

Caps the unioned Mash-screen candidate list at CAND_MAX (default 5000;
bench uses 1500) with optional species-level deduplication keeping the
best-scoring assembly per species. Deterministic: sort by (-score,
original order), greedy unique-species selection, atomic output write,
"kept X / Y" log line (``limit_candidates.py:217-240, 276-287``).

Offline-first: assembly summaries are only read if present on disk (the
reference auto-downloads them with a 14-day refresh; we expose the same
hook but default to no-download since classification runs must work
air-gapped — pass ``allow_download=True`` to restore reference behavior).
"""

from __future__ import annotations

import csv
import os
import pathlib
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_MAX_CANDIDATES = 5000

SUMMARY_FILES = ("assembly_summary_refseq.txt", "assembly_summary_genbank.txt")


def _iter_screen_rows(path: str):
    """Yield (identity, reference id) from one sorted-screen tab file,
    dropping malformed rows; IO errors end the file early."""
    try:
        with open(path, "r", encoding="utf-8", errors="ignore") as handle:
            for raw in handle:
                cols = raw.rstrip("\n").split("\t")
                if len(cols) < 5 or not cols[4].strip():
                    continue
                try:
                    yield float(cols[0]), cols[4].strip()
                except ValueError:
                    continue
    except OSError:
        return


def load_scores(files: Iterable[str]) -> Dict[str, float]:
    """Best screen identity per candidate across all screen tab files
    (col 1 = identity, col 5 = reference id)."""
    best: Dict[str, float] = {}
    for path in files:
        if not os.path.exists(path):
            continue
        for identity, ref in _iter_screen_rows(path):
            if best.get(ref, float("-inf")) < identity:
                best[ref] = identity
    return best


def accession_from_filename(candidate: str) -> str:
    """First two '_'-separated tokens, e.g. GCF_000005845.2 from
    GCF_000005845.2_ASM584v2_genomic.fna.gz."""
    pieces = candidate.split("_", 2)
    if len(pieces) >= 2:
        return f"{pieces[0]}_{pieces[1]}"
    return candidate


def load_species_map(
    directory: Optional[str],
) -> Dict[str, Tuple[str, str]]:
    """accession -> (species_taxid, organism_name) from NCBI assembly
    summary files already on disk."""
    mapping: Dict[str, Tuple[str, str]] = {}
    if not directory:
        return mapping
    for name in SUMMARY_FILES:
        path = pathlib.Path(directory) / name
        if not path.exists():
            continue
        try:
            with path.open("r", encoding="utf-8", errors="ignore") as handle:
                reader = csv.reader(handle, delimiter="\t")
                for row in reader:
                    if not row or row[0].startswith("#"):
                        continue
                    if len(row) < 8:
                        continue
                    accession = row[0].strip()
                    species_taxid = (
                        (row[6] or row[5]).strip() if len(row) > 6 else row[5].strip()
                    )
                    organism = row[7].strip() if len(row) > 7 else ""
                    if accession:
                        mapping[accession] = (
                            species_taxid or accession,
                            organism or accession,
                        )
        except OSError:
            continue
    return mapping


def limit_candidates(
    names: Sequence[str],
    scores: Dict[str, float],
    max_candidates: int = DEFAULT_MAX_CANDIDATES,
    dedupe: bool = False,
    species_map: Optional[Dict[str, Tuple[str, str]]] = None,
) -> Tuple[List[str], str]:
    """Returns (kept names, log summary line).

    The ordering and tie-break rules are the spec (reference
    ``limit_candidates.py:217-232``): rank by screen score descending with
    input position as the deterministic tie-break, then greedily keep the
    first candidate per dedupe key up to the cap. With ``dedupe`` the key is
    the assembly summary's species taxid (falling back to the accession);
    without it every name is its own key, so the pass is a pure top-N.
    """
    if max_candidates <= 0:
        raise ValueError("max_candidates must be greater than zero")
    species_map = species_map or {}

    def species_key(name: str) -> str:
        accession = accession_from_filename(name)
        return species_map.get(accession, (accession, ""))[0]

    ranked = sorted(
        range(len(names)),
        key=lambda i: (-scores.get(names[i], float("-inf")), i),
    )

    kept: List[str] = []
    taken: set = set()
    for i in ranked:
        key = species_key(names[i]) if dedupe else names[i]
        if key in taken:
            continue
        taken.add(key)
        kept.append(names[i])
        if len(kept) >= max_candidates:
            break

    summary = (
        f"[limit_candidates] kept {len(kept)} / {len(names)} candidates "
        f"({len(taken)} unique keys) "
        f"{'(species dedupe)' if dedupe else ''}"
    )
    return kept, summary


def limit_candidates_files(
    selected_path: str,
    output_path: str,
    score_files: Sequence[str],
    max_candidates: int = DEFAULT_MAX_CANDIDATES,
    dedupe: bool = False,
    assembly_dir: Optional[str] = None,
    log_path: Optional[str] = None,
) -> int:
    """File-level drop-in for the reference CLI invocation
    (``run_hymet_cami.sh:101-126``). Atomic write; appends the summary to
    `log_path` if given. Returns the kept count."""
    with open(selected_path, "r", encoding="utf-8") as f:
        names = [line.strip() for line in f if line.strip()]
    if not names:
        raise RuntimeError(f"No candidates found in {selected_path}")

    scores = load_scores(score_files)
    species_map = load_species_map(assembly_dir) if dedupe else {}
    kept, summary = limit_candidates(
        names, scores, max_candidates, dedupe, species_map
    )

    tmp_path = output_path + ".tmp"
    with open(tmp_path, "w", encoding="utf-8") as f:
        for name in kept:
            f.write(name + "\n")
    os.replace(tmp_path, output_path)

    # stderr, not stdout: library stages must never pollute the stdout of
    # drivers with machine-readable output contracts (bench.py's one JSON
    # line; the reference routes this line to its log at run_hymet_cami.sh:119)
    print(summary, file=sys.stderr)
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        with open(log_path, "a", encoding="utf-8") as f:
            f.write(summary.rstrip("\n") + "\n")
    return len(kept)
