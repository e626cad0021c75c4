"""Reference-database ablation experiment: ``case/ablate_db.py`` +
``case/run_ablation.sh`` replacement — the framework's graceful-degradation
/ fault-injection experiment (SURVEY.md §5).

For each ablation level: remove a per-taxid fraction of reference
sequences (seeded RNG, same default seed 1337 and rounding as
``ablate_db.py:54-64,101``), run the pipeline against the ablated
reference, evaluate if truth is available, and append rank-fallback
statistics (% of assignments at species/genus/family/higher —
``run_ablation.sh:230-260``). The reference swaps the ablated FASTA in
for combined_genomes.fasta with a backup/trap-restore dance
(``run_ablation.sh:115-144``); we simply point the run's genome catalog
at the ablated file — no global mutable state to restore. Copy of
hymet_tpu.harness.ablation; the runs and evaluations are the port's, on
the device ``HYMET_PLATFORM`` names (a preset reference: no screen).
"""

from __future__ import annotations

import csv
import logging
import os
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

from hymet_tpu_torch.harness.measure import measured
from hymet_tpu_torch.utils.device import device_from_env, resolve_device

logger = logging.getLogger("hymet_tpu_torch.ablation")

RANKS8 = [
    "superkingdom",
    "phylum",
    "class",
    "order",
    "family",
    "genus",
    "species",
    "strain",
]


# ----------------------------------------------------------------------
# ablate_db.py port


def load_seqmap(path: str) -> Dict[str, str]:
    mapping: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) >= 2 and row[0].strip() and row[1].strip():
                mapping[row[0].strip()] = row[1].strip()
    return mapping


def determine_removals(
    grouped: Dict[str, List[str]], level: float, rng: random.Random
) -> Set[str]:
    to_remove: Set[str] = set()
    for _, seqs in grouped.items():
        if not seqs:
            continue
        count = int(round(level * len(seqs), 0))
        if count <= 0:
            continue
        to_remove.update(rng.sample(seqs, min(count, len(seqs))))
    return to_remove


def write_ablated_fasta(
    fasta_path: str, out_path: str, removal_set: Set[str]
) -> Tuple[int, int]:
    total = 0
    removed = 0
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(fasta_path, encoding="utf-8", errors="ignore") as fin, open(
        out_path, "w", encoding="utf-8"
    ) as fout:
        keep = True
        for line in fin:
            if line.startswith(">"):
                total += 1
                current_id = line[1:].strip().split()[0]
                keep = current_id not in removal_set
                if not keep:
                    removed += 1
                else:
                    fout.write(line)
            elif keep:
                fout.write(line)
    return total, removed


def ablate_db(
    fasta: str,
    seqmap: str,
    taxa: Sequence[str],
    levels: Sequence[float],
    out_dir: str,
    prefix: str = "combined_subset",
    seed: int = 1337,
) -> List[Tuple[float, str]]:
    """Write one ablated FASTA per level + ablation_summary.tsv; returns
    [(level, path)]."""
    mapping = load_seqmap(seqmap)
    targets = {t.strip() for t in taxa if t.strip()}
    grouped: Dict[str, List[str]] = {t: [] for t in targets}
    for seq, tax in mapping.items():
        if tax in grouped:
            grouped[tax].append(seq)
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    summary_path = os.path.join(out_dir, "ablation_summary.tsv")
    if not os.path.exists(summary_path):
        with open(summary_path, "w") as f:
            f.write(
                "level_fraction\tlevel_label\ttarget_taxid\ttotal_sequences\tdropped_sequences\n"
            )
    outputs: List[Tuple[float, str]] = []
    for level in sorted(set(levels)):
        label = f"{int(level * 100):03d}"
        removal = determine_removals(grouped, level, rng)
        out_path = os.path.join(out_dir, f"{prefix}.ablate{label}.fasta")
        total, removed = write_ablated_fasta(fasta, out_path, removal)
        with open(summary_path, "a") as f:
            for taxid, seqs in grouped.items():
                count = int(round(level * len(seqs), 0))
                f.write(f"{level}\t{label}\t{taxid}\t{len(seqs)}\t{min(count, len(seqs))}\n")
        logger.info(
            "level=%.2f (%s) -> %s (removed %d/%d sequences)",
            level,
            label,
            os.path.basename(out_path),
            removed,
            total,
        )
        outputs.append((level, out_path))
    return outputs


# ----------------------------------------------------------------------
# rank-fallback statistics (run_ablation.sh:230-260)


def rank_fallback_stats(classified_tsv: str) -> Dict[str, float]:
    """% of classified rows assigned at species / genus / family / higher."""
    counts = {"species": 0, "genus": 0, "family": 0, "higher": 0, "unknown": 0}
    total = 0
    with open(classified_tsv, encoding="utf-8", errors="ignore") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            total += 1
            level = (row.get("Taxonomic Level") or "").strip().lower()
            if level in ("species", "strain"):
                counts["species"] += 1
            elif level == "genus":
                counts["genus"] += 1
            elif level == "family":
                counts["family"] += 1
            elif level in ("root", "unknown", ""):
                counts["unknown"] += 1
            else:
                counts["higher"] += 1
    if total == 0:
        return {k: 0.0 for k in counts} | {"total": 0}
    return {k: 100.0 * v / total for k, v in counts.items()} | {"total": total}


# ----------------------------------------------------------------------
# the swap-and-rerun loop


def run_ablation(
    sample: Optional[str],
    taxa: Optional[Sequence[str]],
    levels: Sequence[float],
    seqmap: Optional[str],
    fasta: Optional[str],
    out_root: Optional[str] = None,
    threads: int = 8,
    truth_contigs: Optional[str] = None,
    truth_profile: Optional[str] = None,
) -> int:
    if not fasta or not os.path.exists(fasta):
        raise FileNotFoundError(f"reference FASTA not found: {fasta}")
    if not seqmap or not os.path.exists(seqmap):
        raise FileNotFoundError(f"seqmap not found: {seqmap}")
    if not taxa:
        raise ValueError("no target taxa provided")
    device = device_from_env()
    resolve_device(device)
    sample = sample or "ablation_sample"
    out_root = out_root or "out/ablation"
    os.makedirs(out_root, exist_ok=True)
    runtime_log = os.path.join(out_root, "runtime_memory.tsv")

    refsets = ablate_db(
        fasta, seqmap, taxa, levels, os.path.join(out_root, "refsets")
    )

    from hymet_tpu_torch.pipeline.run import ClassificationRun
    from hymet_tpu_torch.utils.config import RunConfig

    eval_summary = os.path.join(out_root, "ablation_eval_summary.tsv")
    fallback_path = os.path.join(out_root, "rank_fallback.tsv")
    with open(fallback_path, "w") as f:
        f.write(
            "level\ttotal\tspecies_pct\tgenus_pct\tfamily_pct\thigher_pct\tunknown_pct\n"
        )

    input_fasta = os.environ.get("INPUT_FASTA")
    for level, ref_path in refsets:
        label = f"{int(level * 100):03d}"
        lvl_dir = os.path.join(out_root, f"level_{label}")
        os.makedirs(lvl_dir, exist_ok=True)
        cfg = RunConfig.from_env(
            input_fasta=input_fasta,
            outdir=lvl_dir,
            threads=threads,
            genome_catalog=None,
        )
        if not cfg.input_fasta or not os.path.exists(cfg.input_fasta):
            raise FileNotFoundError(
                "set INPUT_FASTA (query contigs) for the ablation runs"
            )
        # the ablated FASTA IS the combined reference (preset mode — the
        # reference's swap of combined_subset.fasta)
        cfg.reference_fasta = ref_path
        cfg.seqid2taxid = seqmap
        cfg.cache_root = os.path.join(out_root, "cache", label)
        classified = None
        try:
            with measured(runtime_log, sample, "hymet_tpu", f"ablation_{label}"):
                classified = ClassificationRun(cfg, device=device).execute()
        except Exception as e:  # noqa: BLE001 — e.g. fully-ablated reference
            logger.warning("level %s run failed (%s); recording zeros", label, e)

        stats = (
            rank_fallback_stats(classified)
            if classified and os.path.exists(classified)
            else {
                "total": 0,
                "species": 0.0,
                "genus": 0.0,
                "family": 0.0,
                "higher": 0.0,
                "unknown": 0.0,
            }
        )
        with open(fallback_path, "a") as f:
            f.write(
                f"{level}\t{stats['total']}\t{stats['species']:.2f}\t{stats['genus']:.2f}"
                f"\t{stats['family']:.2f}\t{stats['higher']:.2f}\t{stats['unknown']:.2f}\n"
            )

        if (truth_contigs or truth_profile) and classified:
            from hymet_tpu_torch.evalx.eval_cami import evaluate

            with measured(
                runtime_log, sample, "hymet_tpu", f"ablation_eval_{label}"
            ):
                evaluate(
                    pred_profile=_find_profile(lvl_dir),
                    truth_profile=truth_profile,
                    pred_contigs=classified,
                    truth_contigs=truth_contigs,
                    taxonomy_dir=os.environ.get("TAXONKIT_DB")
                    or os.environ.get("TAXONOMY_DIR"),
                    outdir=os.path.join(lvl_dir, "eval"),
                    device=device,
                )
            _append_eval_summary(eval_summary, level, os.path.join(lvl_dir, "eval"))

    try:
        from hymet_tpu_torch.harness.plots import make_ablation_figures

        make_ablation_figures(out_root)
    except Exception as e:  # noqa: BLE001
        logger.warning("ablation figures skipped: %s", e)
    return 0


def _find_profile(outdir: str) -> Optional[str]:
    for fn in os.listdir(outdir):
        if fn.endswith(".cami.tsv"):
            return os.path.join(outdir, fn)
    return None


def _append_eval_summary(path: str, level: float, eval_dir: str) -> None:
    prof = os.path.join(eval_dir, "profile_summary.tsv")
    if not os.path.exists(prof):
        return
    new = not os.path.exists(path)
    with open(prof, encoding="utf-8") as src, open(path, "a", newline="") as out:
        reader = csv.reader(src, delimiter="\t")
        header = next(reader)
        w = csv.writer(out, delimiter="\t")
        if new:
            w.writerow(["level"] + header)
        for row in reader:
            w.writerow([level] + row)
