"""Figure generation: ports of ``bench/plot/make_figures.py`` (6 figures:
F1 by rank, L1 lines, Bray-Curtis lines, contig accuracy, per-sample F1,
CPU time + peak memory) and ``case/plot_ablation.py`` (rank-fallback
curve, stacked assignment chart, F1-by-rank-vs-ablation); copy of
hymet_tpu.harness.plots. matplotlib is imported when a figure is made,
not with the module: the harness runs where it is not installed and
skips the figures there."""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List


def _read_tsv(path: str) -> List[Dict[str, str]]:
    if not os.path.exists(path):
        return []
    with open(path, newline="") as f:
        return [dict(r) for r in csv.DictReader(f, delimiter="\t")]


RANK_ORDER = ["superkingdom", "phylum", "class", "order", "family", "genus", "species"]


def make_bench_figures(out_root: str) -> List[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig_dir = os.path.join(out_root, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    written: List[str] = []

    leaderboard = _read_tsv(os.path.join(out_root, "leaderboard_by_rank.tsv"))
    per_sample = _read_tsv(os.path.join(out_root, "summary_per_tool_per_sample.tsv"))
    contig = _read_tsv(os.path.join(out_root, "contig_accuracy_per_tool.tsv"))
    runtime = _read_tsv(os.path.join(out_root, "runtime_memory.tsv"))

    def by_tool(rows, val_key):
        d = defaultdict(dict)
        for r in rows:
            rank = r.get("rank", "")
            if rank in RANK_ORDER:
                try:
                    d[r["tool"]][rank] = float(r.get(val_key) or 0)
                except ValueError:
                    pass
        return d

    def line_fig(data, title, ylabel, fname):
        if not data:
            return
        fig, ax = plt.subplots(figsize=(7, 4))
        for tool, vals in sorted(data.items()):
            ys = [vals.get(r) for r in RANK_ORDER]
            ax.plot(RANK_ORDER, ys, marker="o", label=tool)
        ax.set_title(title)
        ax.set_ylabel(ylabel)
        ax.tick_params(axis="x", rotation=30)
        ax.legend(fontsize=8)
        fig.tight_layout()
        path = os.path.join(fig_dir, fname)
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)

    line_fig(by_tool(leaderboard, "mean_F1_%"), "Mean F1 by rank", "F1 (%)", "f1_by_rank.png")
    line_fig(
        by_tool(leaderboard, "mean_L1_total_variation_pctpts"),
        "Mean L1 total variation by rank",
        "L1 (pct pts)",
        "l1_by_rank.png",
    )
    line_fig(
        by_tool(leaderboard, "mean_BrayCurtis_pct"),
        "Mean Bray-Curtis by rank",
        "Bray-Curtis (%)",
        "braycurtis_by_rank.png",
    )
    line_fig(
        by_tool(contig, "accuracy_percent"),
        "Contig accuracy by rank",
        "Accuracy (%)",
        "contig_accuracy.png",
    )

    # per-sample species F1 bars
    f1_rows = [r for r in per_sample if r.get("rank") == "species"]
    if f1_rows:
        fig, ax = plt.subplots(figsize=(8, 4))
        samples = sorted({r["sample"] for r in f1_rows})
        tools = sorted({r["tool"] for r in f1_rows})
        width = 0.8 / max(len(tools), 1)
        for ti, tool in enumerate(tools):
            xs, ys = [], []
            for si, s in enumerate(samples):
                rec = next(
                    (r for r in f1_rows if r["sample"] == s and r["tool"] == tool), None
                )
                if rec:
                    xs.append(si + ti * width)
                    ys.append(float(rec.get("F1_%") or 0))
            ax.bar(xs, ys, width=width, label=tool)
        ax.set_xticks(range(len(samples)))
        ax.set_xticklabels(samples, rotation=30, fontsize=7)
        ax.set_ylabel("Species F1 (%)")
        ax.set_title("Species F1 per sample")
        ax.legend(fontsize=8)
        fig.tight_layout()
        path = os.path.join(fig_dir, "f1_per_sample.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)

    # CPU time and memory
    if runtime:
        by_tool_cpu = defaultdict(float)
        by_tool_mem = defaultdict(float)
        for r in runtime:
            if r.get("stage") != "run":
                continue
            try:
                by_tool_cpu[r["tool"]] += float(r.get("user_seconds") or 0) + float(
                    r.get("sys_seconds") or 0
                )
                by_tool_mem[r["tool"]] = max(
                    by_tool_mem[r["tool"]], float(r.get("max_rss_gb") or 0)
                )
            except ValueError:
                continue
        for data, title, ylabel, fname in (
            (by_tool_cpu, "Total CPU time (run stages)", "CPU seconds", "cpu_time.png"),
            (by_tool_mem, "Peak RSS", "GB", "peak_memory.png"),
        ):
            if not data:
                continue
            fig, ax = plt.subplots(figsize=(5, 4))
            tools = sorted(data)
            ax.bar(tools, [data[t] for t in tools])
            ax.set_title(title)
            ax.set_ylabel(ylabel)
            fig.tight_layout()
            path = os.path.join(fig_dir, fname)
            fig.savefig(path, dpi=120)
            plt.close(fig)
            written.append(path)
    return written


def make_ablation_figures(out_root: str) -> List[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig_dir = os.path.join(out_root, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    written: List[str] = []

    fallback = _read_tsv(os.path.join(out_root, "rank_fallback.tsv"))
    if fallback:
        levels = [float(r["level"]) for r in fallback]
        fig, ax = plt.subplots(figsize=(6, 4))
        for key in ("species_pct", "genus_pct", "family_pct", "higher_pct", "unknown_pct"):
            ax.plot(levels, [float(r.get(key) or 0) for r in fallback], marker="o", label=key)
        ax.set_xlabel("ablation level")
        ax.set_ylabel("% of assignments")
        ax.set_title("Rank fallback vs ablation level")
        ax.legend(fontsize=8)
        fig.tight_layout()
        p = os.path.join(fig_dir, "rank_fallback.png")
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

        fig, ax = plt.subplots(figsize=(6, 4))
        keys = ["species_pct", "genus_pct", "family_pct", "higher_pct", "unknown_pct"]
        bottoms = [0.0] * len(levels)
        for key in keys:
            vals = [float(r.get(key) or 0) for r in fallback]
            ax.bar([str(l) for l in levels], vals, bottom=bottoms, label=key)
            bottoms = [b + v for b, v in zip(bottoms, vals)]
        ax.set_xlabel("ablation level")
        ax.set_ylabel("% of assignments")
        ax.set_title("Assignment ranks (stacked)")
        ax.legend(fontsize=8)
        fig.tight_layout()
        p = os.path.join(fig_dir, "assignments_stacked.png")
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    evals = _read_tsv(os.path.join(out_root, "ablation_eval_summary.tsv"))
    if evals:
        fig, ax = plt.subplots(figsize=(6, 4))
        by_rank = defaultdict(list)
        for r in evals:
            rank = r.get("rank", "")
            if rank in RANK_ORDER:
                try:
                    by_rank[rank].append((float(r["level"]), float(r.get("F1_%") or 0)))
                except ValueError:
                    continue
        for rank, pts in by_rank.items():
            pts.sort()
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=rank)
        ax.set_xlabel("ablation level")
        ax.set_ylabel("F1 (%)")
        ax.set_title("F1 by rank vs ablation level")
        ax.legend(fontsize=7)
        fig.tight_layout()
        p = os.path.join(fig_dir, "f1_vs_ablation.png")
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)
    return written
