"""Metric aggregation: port of reference ``bench/aggregate_metrics.py``
(copy of hymet_tpu.harness.aggregate).

Walks ``out/<sample>/<tool>/eval/`` and emits the same three tables with
identical columns: ``summary_per_tool_per_sample.tsv``,
``leaderboard_by_rank.tsv`` (mean per tool x rank), and
``contig_accuracy_per_tool.tsv`` (rows with n <= 0 dropped,
``aggregate_metrics.py:34-45``).
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List, Tuple

PROFILE_SUMMARY = "profile_summary.tsv"
CONTIG_SUMMARY = "contigs_per_rank.tsv"

SUMMARY_FIELDS = [
    "sample",
    "tool",
    "rank",
    "L1_total_variation_pctpts",
    "BrayCurtis_pct",
    "Precision_%",
    "Recall_%",
    "F1_%",
    "TP",
    "FP",
    "FN",
]
METRIC_KEYS = SUMMARY_FIELDS[3:8]
LEADERBOARD_FIELDS = [
    "tool",
    "rank",
    "samples",
    "mean_L1_total_variation_pctpts",
    "mean_BrayCurtis_pct",
    "mean_Precision_%",
    "mean_Recall_%",
    "mean_F1_%",
]
CONTIG_FIELDS = ["sample", "tool", "rank", "n", "correct", "accuracy_percent"]


def _read_tsv(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return [dict(r) for r in csv.DictReader(f, delimiter="\t")]


def _write(path: str, rows: List[Dict[str, str]], fields: List[str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, delimiter="\t")
        w.writeheader()
        for row in rows:
            w.writerow({k: row.get(k, "") for k in fields})


def aggregate(out_root: str) -> None:
    """out_root contains <sample>/<tool>/eval/; writes aggregate tables
    into out_root."""
    per_sample: List[Dict[str, str]] = []
    contigs: List[Dict[str, str]] = []
    if not os.path.isdir(out_root):
        print(f"[aggregate] No benchmark outputs under {out_root}; skipping.")
        return
    for sample in sorted(os.listdir(out_root)):
        sdir = os.path.join(out_root, sample)
        if not os.path.isdir(sdir):
            continue
        for tool in sorted(os.listdir(sdir)):
            eval_dir = os.path.join(sdir, tool, "eval")
            if not os.path.isdir(eval_dir):
                continue
            ppath = os.path.join(eval_dir, PROFILE_SUMMARY)
            if os.path.isfile(ppath) and os.path.getsize(ppath) > 0:
                for row in _read_tsv(ppath):
                    row.update({"sample": sample, "tool": tool})
                    per_sample.append(row)
            cpath = os.path.join(eval_dir, CONTIG_SUMMARY)
            if os.path.isfile(cpath) and os.path.getsize(cpath) > 0:
                for row in _read_tsv(cpath):
                    try:
                        if float((row.get("n") or "").strip()) <= 0:
                            continue
                    except ValueError:
                        continue
                    row.update({"sample": sample, "tool": tool})
                    contigs.append(row)

    if per_sample:
        _write(
            os.path.join(out_root, "summary_per_tool_per_sample.tsv"),
            per_sample,
            SUMMARY_FIELDS,
        )
        by_tool_rank: Dict[Tuple[str, str], List[Dict[str, str]]] = defaultdict(list)
        for row in per_sample:
            by_tool_rank[(row["tool"], row["rank"])].append(row)
        leaderboard = []
        for (tool, rank), rows in sorted(by_tool_rank.items()):
            means = {}
            for key in METRIC_KEYS:
                vals = []
                for r in rows:
                    try:
                        vals.append(float(r.get(key) or ""))
                    except ValueError:
                        continue
                means[key] = sum(vals) / len(vals) if vals else 0.0
            leaderboard.append(
                {
                    "tool": tool,
                    "rank": rank,
                    "samples": str(len(rows)),
                    "mean_L1_total_variation_pctpts": f"{means['L1_total_variation_pctpts']:.4f}",
                    "mean_BrayCurtis_pct": f"{means['BrayCurtis_pct']:.4f}",
                    "mean_Precision_%": f"{means['Precision_%']:.2f}",
                    "mean_Recall_%": f"{means['Recall_%']:.2f}",
                    "mean_F1_%": f"{means['F1_%']:.2f}",
                }
            )
        _write(
            os.path.join(out_root, "leaderboard_by_rank.tsv"),
            leaderboard,
            LEADERBOARD_FIELDS,
        )
    if contigs:
        _write(
            os.path.join(out_root, "contig_accuracy_per_tool.tsv"),
            contigs,
            CONTIG_FIELDS,
        )
