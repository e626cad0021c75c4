"""CAMI benchmark harness: the ``bench/run_all_cami.sh`` replacement (copy
of hymet_tpu.harness.bench; the run and the evaluator are the port's).

Manifest loop x tool loop; per (sample, tool): measured run, superkingdom
fix of the predicted profile (``bench/lib/run_eval.sh:82-85``), measured
eval; at the end, aggregation + figures (``run_all_cami.sh:91-168``).

Output tree matches the reference:
  out/<sample>/<tool>/profile.cami.tsv
  out/<sample>/<tool>/classified_sequences.tsv
  out/<sample>/<tool>/metadata.json
  out/<sample>/<tool>/eval/{profile_summary.tsv, contigs_*.tsv}
  out/runtime_memory.tsv

The ``hymet_tpu`` tool (the name the output tree and metadata.json keep)
runs the port's ``ClassificationRun`` in-process with the bench defaults
the reference uses (CAND_MAX=1500, SPECIES_DEDUP=1, shared cache —
``bench/run_hymet.sh:44-49``), on the device ``HYMET_PLATFORM`` names
(unset: the card; ``cpu``: the plain CPU path), as is the evaluator.
External baseline tools (kraken2, centrifuge, ganon2, sourmash,
metaphlan4) run through :mod:`hymet_tpu_torch.harness.baselines` when
their binaries are installed and are skipped with a warning otherwise
(the reference behaves the same way via missing-conda-env failures).

A tool's failure is logged and the loop goes on, as in the JAX harness:
a run that raised (a kernel or CUDA error included) leaves its cell
without outputs and ``run_bench`` still returns 0, so read the output
files, not the exit code.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import List, Optional

from hymet_tpu_torch.harness.aggregate import aggregate
from hymet_tpu_torch.harness.manifest import ManifestRow, load_manifest
from hymet_tpu_torch.harness.measure import measured
from hymet_tpu_torch.utils.device import device_from_env, resolve_device

logger = logging.getLogger("hymet_tpu_torch.bench")

BENCH_CAND_MAX = 1500
BENCH_SPECIES_DEDUP = True


def _taxdb_from_env():
    """TaxonomyDB from TAXONKIT_DB / TAXONOMY_DIR (taxdump or hierarchy
    TSV) — the taxonomy source shared by eval and converters."""
    from hymet_tpu_torch.evalx.eval_cami import _load_taxdb

    return _load_taxdb(os.environ.get("TAXONKIT_DB") or os.environ.get("TAXONOMY_DIR"))


def run_bench(
    manifest: Optional[str],
    tools: List[str],
    max_samples: Optional[int] = None,
    out_root: Optional[str] = None,
    resume: bool = False,
    threads: int = 8,
    jobs: int = 1,
) -> int:
    """Manifest x tool benchmark loop.

    ``jobs > 1`` runs (sample, tool) cells in parallel worker processes —
    cross-sample parallelism the reference's sequential manifest loop
    lacks (``bench/run_all_cami.sh:91-162``; SURVEY §2.6 last row). Use
    it for CPU runs (``HYMET_PLATFORM=cpu``) and external baseline tools;
    keep jobs=1 when the in-process tool runs on the card (one process on
    the card at a time; a worker's kernel launch counts stay in the
    worker). Per-cell runtime logs merge deterministically. The device is
    resolved here first, so without a card (and ``HYMET_PLATFORM`` not
    ``cpu``) this raises before any cell runs.
    """
    if not manifest or not os.path.exists(manifest):
        raise FileNotFoundError(f"manifest not found: {manifest}")
    resolve_device(device_from_env())
    rows = load_manifest(manifest)
    if max_samples is not None:
        rows = rows[:max_samples]
    out_root = out_root or "out/bench"
    os.makedirs(out_root, exist_ok=True)
    runtime_log = os.path.join(out_root, "runtime_memory.tsv")
    if not resume and os.path.exists(runtime_log):
        os.remove(runtime_log)

    cells = []
    for row in rows:
        if not row.contigs or not os.path.exists(row.contigs):
            logger.warning(
                "sample %s: contigs missing (%s); skipping", row.sample_id, row.contigs
            )
            continue
        cells.extend((row, tool) for tool in tools)

    if jobs <= 1:
        for row, tool in cells:
            _run_cell(row, tool, out_root, threads, runtime_log)
    else:
        import concurrent.futures as cf
        import multiprocessing as mp

        # spawn (not fork): a CUDA context does not survive a fork
        ctx = mp.get_context("spawn")
        cell_logs = [
            f"{runtime_log}.{row.sample_id}.{tool}" for row, tool in cells
        ]
        with cf.ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as ex:
            futs = [
                ex.submit(_run_cell, row, tool, out_root, threads, log)
                for (row, tool), log in zip(cells, cell_logs)
            ]
            for f in futs:
                f.result()  # surface worker crashes
        # deterministic merge in cell order (one header only)
        have_header = (
            os.path.exists(runtime_log) and os.path.getsize(runtime_log) > 0
        )
        with open(runtime_log, "a") as out:
            for log in cell_logs:
                if not os.path.exists(log):
                    continue
                with open(log) as f:
                    lines = f.readlines()
                if lines and lines[0].startswith("sample\t") and have_header:
                    lines = lines[1:]
                out.writelines(lines)
                have_header = True
                os.remove(log)

    aggregate(out_root)
    try:
        from hymet_tpu_torch.harness.plots import make_bench_figures

        make_bench_figures(out_root)
    except Exception as e:  # noqa: BLE001 — plotting is best-effort
        logger.warning("figure generation skipped: %s", e)
    return 0


def _run_cell(
    row: ManifestRow, tool: str, out_root: str, threads: int, runtime_log: str
) -> None:
    """One measured (sample, tool) run + eval cell (parallel-safe: all
    writes go under the cell's own tool_dir + its runtime log)."""
    # a spawned worker reads HYMET_PLATFORM itself (set it to cpu for
    # parallel cells so workers never contend for the one card)
    device = device_from_env()
    tool_dir = os.path.join(out_root, row.sample_id, tool)
    os.makedirs(tool_dir, exist_ok=True)
    try:
        with measured(runtime_log, row.sample_id, tool, "run"):
            ok = _run_tool(tool, row, tool_dir, threads, device)
    except Exception as e:  # noqa: BLE001 — harness tolerates tool failures
        logger.error("%s/%s run failed: %s", row.sample_id, tool, e)
        return
    if not ok:
        return
    with measured(runtime_log, row.sample_id, tool, "eval"):
        _run_eval(row, tool_dir, device)


def _run_tool(tool: str, row: ManifestRow, tool_dir: str, threads: int, device: str) -> bool:
    if tool in ("hymet_tpu", "hymet"):
        return _run_hymet_tpu(row, tool_dir, threads, device)
    from hymet_tpu_torch.harness.baselines import run_baseline_tool

    return run_baseline_tool(tool, row, tool_dir, threads)


def _run_hymet_tpu(row: ManifestRow, tool_dir: str, threads: int, device: str) -> bool:
    from hymet_tpu_torch.pipeline.run import ClassificationRun
    from hymet_tpu_torch.utils.config import RunConfig

    cfg = RunConfig.from_env(
        input_fasta=row.contigs,
        outdir=os.path.join(tool_dir, "work_out"),
        threads=threads,
        cand_max=int(os.environ.get("CAND_MAX", BENCH_CAND_MAX)),
        species_dedup=BENCH_SPECIES_DEDUP if os.environ.get("SPECIES_DEDUP") is None else None,
    )
    classified = ClassificationRun(cfg, device=device).execute()
    shutil.copyfile(classified, os.path.join(tool_dir, "classified_sequences.tsv"))
    sample = os.path.splitext(os.path.basename(row.contigs))[0]
    prof_src = os.path.join(cfg.outdir, f"hymet.{sample}.cami.tsv")
    if os.path.exists(prof_src):
        shutil.copyfile(prof_src, os.path.join(tool_dir, "profile.cami.tsv"))
    paf = os.path.join(cfg.outdir, "work", "resultados.paf")
    if os.path.exists(paf):
        shutil.copyfile(paf, os.path.join(tool_dir, "resultados.paf"))
    with open(os.path.join(tool_dir, "metadata.json"), "w") as f:
        json.dump(
            {"tool": "hymet_tpu", "sample": row.sample_id, "threads": threads},
            f,
            indent=2,
        )
    return True


def _run_eval(row: ManifestRow, tool_dir: str, device: str) -> None:
    from hymet_tpu_torch.evalx.eval_cami import evaluate
    from hymet_tpu_torch.evalx.superkingdom_fix import fix_superkingdom

    eval_dir = os.path.join(tool_dir, "eval")
    profile = os.path.join(tool_dir, "profile.cami.tsv")
    taxonomy_dir = os.environ.get("TAXONKIT_DB") or os.environ.get("TAXONOMY_DIR")

    if row.truth_profile and os.path.exists(profile) and taxonomy_dir:
        hier = (
            taxonomy_dir
            if taxonomy_dir.endswith(".tsv")
            else os.path.join(taxonomy_dir, "taxonomy_hierarchy.tsv")
        )
        if os.path.exists(hier):
            try:
                fix_superkingdom(profile, row.truth_profile, hier)
            except Exception as e:  # noqa: BLE001
                logger.warning("superkingdom fix failed: %s", e)

    evaluate(
        pred_profile=profile if os.path.exists(profile) else None,
        truth_profile=row.truth_profile,
        pred_contigs=os.path.join(tool_dir, "classified_sequences.tsv"),
        truth_contigs=row.truth_contigs,
        pred_fasta=row.contigs,
        truth_fasta=None,
        taxonomy_dir=taxonomy_dir,
        paf=os.path.join(tool_dir, "resultados.paf"),
        outdir=eval_dir,
        device=device,
    )
