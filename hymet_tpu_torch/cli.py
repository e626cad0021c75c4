"""Command line of hymet_tpu_torch: ``python -m hymet_tpu_torch <subcommand>``.

The subcommands of hymet_tpu's command line (``hymet_tpu/cli.py``) that the
port runs, with its flags, ``--dry-run`` plan lines, messages and exit
codes: ``run`` and ``legacy`` (one sample end to end), ``sketch`` (sketch
DBs, ``.npz`` or Mash ``.msh``), ``index`` (a minimizer index),
``taxonomy`` (``taxonomy_hierarchy.tsv`` from a taxdump), ``prune-cache``,
``eval`` (score a run against the truth; a contig remap runs on the
device), ``diag`` (PAF targets against the id map), the dataset tools
``subset``, ``testdataset`` and ``cami-subsets``, and the experiment
harnesses ``bench`` (a manifest of samples x tools: run, evaluate,
aggregate), ``case`` (the case study), ``ablation`` (the reference-DB
ablation), ``truth build-zymo`` and ``fetch`` (a manifest's ``*_url``
assets). One difference: ``--backend`` defaults to ``device``, the
port's name for the JAX package's ``jax`` backend (which is accepted as
the same).

The device comes from ``HYMET_PLATFORM``, the variable the JAX command
line reads: unset, ``gpu`` or ``cuda`` run on the card (and fail without
one); ``cpu`` runs the plain CPU path; anything else is an error. There is
no silent CPU fallback: ``eval`` asks for the device even when no remap
runs, so ``HYMET_PLATFORM=cpu`` scores profiles on a machine without a
card. ``--dry-run`` prints the resolved plan and touches
no device.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

from hymet_tpu_torch.utils.config import RunConfig
from hymet_tpu_torch.utils.device import device_from_env


def _plan(args, lines: List[str]) -> bool:
    """Print the execution plan; return True if this is a dry run."""
    for line in lines:
        print(f"[hymet-tpu] {line}")
    return bool(getattr(args, "dry_run", False))


def command_run(args) -> int:
    cfg = RunConfig.from_env(
        input_fasta=os.path.abspath(args.contigs),
        outdir=os.path.abspath(args.out),
        threads=args.threads,
        cand_max=args.cand_max,
        species_dedup=args.species_dedup or None,
        assembly_summary_dir=args.assembly_summary_dir,
        cache_root=os.path.abspath(args.cache_root) if args.cache_root else None,
        force_download=args.force_download or None,
        taxonomy_dir=args.taxonomy_dir,
        sketch_dbs=args.sketch_db or None,
        genome_catalog=args.genome_catalog,
        seqid2taxid=args.seqid2taxid,
        allow_download=args.allow_download or None,
        classifier_backend=args.backend,
        keep_work=args.keep_work or None,
    )
    if _plan(
        args,
        [
            "run: screen -> limit -> reference -> align -> classify -> export",
            *cfg.describe().splitlines(),
        ],
    ):
        return 0
    from hymet_tpu_torch.pipeline.run import ClassificationRun

    out = ClassificationRun(cfg, device=device_from_env()).execute()
    print(f"[hymet-tpu] OK: {out}")
    return 0


def command_sketch(args) -> int:
    genomes = list(args.genomes)
    if _plan(
        args,
        [
            f"sketch: {len(genomes)} genome files -> {args.out} "
            f"(k={args.kmer}, s={args.sketch_size}, per_sequence={args.per_sequence})"
        ],
    ):
        return 0
    from hymet_tpu_torch.io.fasta import iter_fasta
    from hymet_tpu_torch.io.sketchdb import build_sketch_db, build_sketch_db_from_sequences

    device = device_from_env()
    if args.per_sequence:
        def gen():
            for path in genomes:
                yield from iter_fasta(path)

        db = build_sketch_db_from_sequences(gen(), k=args.kmer, sketch_size=args.sketch_size,
                                            device=device)
    else:
        db = build_sketch_db(genomes, k=args.kmer, sketch_size=args.sketch_size, device=device)
    if args.out.endswith(".msh"):
        db.to_msh(args.out)
    else:
        db.save(args.out)
    print(f"[hymet-tpu] sketched {db.n_refs} references -> {args.out}")
    return 0


def command_index(args) -> int:
    if _plan(args, [f"index: {args.fasta} -> {args.out} (k={args.kmer}, w={args.window})"]):
        return 0
    from hymet_tpu_torch.io.minimizer_index import MinimizerIndex

    idx = MinimizerIndex.build_from_fasta(args.fasta, k=args.kmer, w=args.window,
                                          device=device_from_env())
    idx.save(args.out)
    print(
        f"[hymet-tpu] indexed {len(idx.names)} sequences, "
        f"{idx.n_minimizers:,} minimizers -> {args.out}"
    )
    return 0


def command_taxonomy(args) -> int:
    """config.pl equivalent: taxdump -> data/taxonomy_hierarchy.tsv."""
    if _plan(args, [f"taxonomy: {args.taxdump} -> {args.out}"]):
        return 0
    from hymet_tpu_torch.taxonomy.db import TaxonomyDB

    db = TaxonomyDB.from_taxdump(args.taxdump)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    db.write_hierarchy_tsv(args.out)
    print(f"[hymet-tpu] wrote {args.out}")
    return 0


def command_prune_cache(args) -> int:
    if _plan(
        args,
        [f"prune-cache: {args.cache_root} age<={args.max_age_days}d size<={args.max_size_gb}GB"],
    ):
        return 0
    from hymet_tpu_torch.pipeline.prune_cache import prune_cache

    removed = prune_cache(
        args.cache_root, args.max_age_days, args.max_size_gb, dry_run=args.no_delete
    )
    for p in removed:
        print(f"[hymet-tpu] {'would remove' if args.no_delete else 'removed'} {p}")
    return 0


def command_bench(args) -> int:
    if _plan(
        args,
        [
            f"bench: manifest={args.manifest} tools={args.tools} "
            f"max_samples={args.max_samples} resume={args.resume}"
        ],
    ):
        return 0
    from hymet_tpu_torch.harness.bench import run_bench

    return run_bench(
        manifest=args.manifest,
        tools=(args.tools or "hymet_tpu").split(","),
        max_samples=args.max_samples,
        out_root=args.out,
        resume=args.resume,
        jobs=args.jobs,
        threads=args.threads,
    )


def command_case(args) -> int:
    if _plan(args, [f"case: manifest={args.manifest} out={args.out}"]):
        return 0
    from hymet_tpu_torch.harness.case import run_case

    return run_case(manifest=args.manifest, out_root=args.out, threads=args.threads)


def command_ablation(args) -> int:
    if _plan(
        args,
        [
            f"ablation: sample={args.sample} taxa={args.taxa} levels={args.levels} "
            f"fasta={args.fasta} out={args.out}"
        ],
    ):
        return 0
    from hymet_tpu_torch.harness.ablation import run_ablation

    return run_ablation(
        sample=args.sample,
        taxa=(args.taxa or "").split(",") if args.taxa else None,
        levels=[float(x) for x in (args.levels or "0,0.5,1.0").split(",")],
        seqmap=args.seqmap,
        fasta=args.fasta,
        out_root=args.out,
        threads=args.threads,
    )


def command_truth_build_zymo(args) -> int:
    if _plan(
        args,
        [f"truth build-zymo: contigs={args.contigs} paf={args.paf}"],
    ):
        return 0
    from hymet_tpu_torch.harness.zymo_truth import build_zymo_truth

    build_zymo_truth(
        contigs=args.contigs,
        paf=args.paf,
        seqmap=args.seqmap,
        out_contigs=args.out_contigs,
        out_profile=args.out_profile,
    )
    return 0


def command_fetch(args) -> int:
    if _plan(args, [f"fetch: manifest={args.manifest}"]):
        return 0
    from hymet_tpu_torch.harness.fetch import fetch_manifest_assets

    ok, failed = fetch_manifest_assets(args.manifest)
    print(f"[hymet-tpu] fetched/present: {len(ok)}, failed: {len(failed)}")
    return 1 if failed else 0


def command_eval(args) -> int:
    if _plan(
        args,
        [f"eval: pred={args.pred_profile} truth={args.truth_profile} out={args.out}"],
    ):
        return 0
    from hymet_tpu_torch.evalx.eval_cami import evaluate

    return evaluate(
        pred_profile=args.pred_profile,
        truth_profile=args.truth_profile,
        pred_contigs=args.pred_contigs,
        truth_contigs=args.truth_contigs,
        pred_fasta=args.pred_fasta,
        truth_fasta=args.truth_fasta,
        taxonomy_dir=args.taxonomy_dir,
        taxmap=args.taxmap,
        paf=args.paf,
        presence_thresh=args.presence_thresh,
        outdir=args.out,
        device=device_from_env(),
    )


def command_subset(args) -> int:
    if _plan(args, [f"subset: {args.input} -> {args.output} (max {args.max_seqs} seqs / {args.max_bases} bases)"]):
        return 0
    from hymet_tpu_torch.data.subsets import subset_fasta

    n, bases = subset_fasta(args.input, args.output, args.max_seqs, args.max_bases)
    print(f"[hymet-tpu] wrote {n} sequences / {bases} bases to {args.output}")
    return 0


def command_testdataset(args) -> int:
    if _plan(
        args,
        [
            f"testdataset: {args.genome_dir} -> {args.out} "
            f"(genomes {args.fraction_genomes}, trim {args.trim_fraction}, mutation {args.mutation_rate})"
        ],
    ):
        return 0
    from hymet_tpu_torch.data.testdataset import build_test_dataset

    gcf_map = build_test_dataset(
        args.genome_dir,
        args.out,
        fraction_genomes=args.fraction_genomes,
        trim_fraction=args.trim_fraction,
        mutation_rate=args.mutation_rate,
        seed=args.seed,
    )
    print(f"[hymet-tpu] built test dataset with {len(gcf_map)} genomes -> {args.out}")
    return 0


def command_cami_subsets(args) -> int:
    if _plan(args, [f"cami-subsets: {args.fasta} + {args.mapping} -> {args.out}"]):
        return 0
    from hymet_tpu_torch.data.cami_subsets import generate_cami_subsets
    from hymet_tpu_torch.taxonomy.db import TaxonomyDB

    taxdb = (
        TaxonomyDB.from_taxdump(args.taxonomy_dir)
        if os.path.exists(os.path.join(args.taxonomy_dir, "names.dmp"))
        else TaxonomyDB.from_hierarchy_tsv(
            os.path.join(args.taxonomy_dir, "taxonomy_hierarchy.tsv")
        )
    )
    out = generate_cami_subsets(args.fasta, args.mapping, taxdb, args.out)
    for name, taxids in out.items():
        print(f"[hymet-tpu] {name}: {len(taxids)} taxa")
    return 0


def command_diag(args) -> int:
    if _plan(args, [f"diag: overlap of {args.paf} targets vs {args.taxonomy}"]):
        return 0
    from hymet_tpu_torch.evalx.diagnostics import diag_overlap
    from hymet_tpu_torch.models.first_hit import build_id_map

    id_map = build_id_map(args.taxonomy)
    n_keys, n_targets, direct, versionless = diag_overlap(args.paf, id_map)
    print(
        f"[diag] id_map_keys={n_keys:,} unique_paf_targets={n_targets:,} "
        f"direct_overlap={direct} versionless_overlap={versionless}"
    )
    return 0


def command_legacy(args) -> int:
    """Legacy pipeline: the main.pl path (classification.py's exact-match
    + LCA classifier)."""
    args.backend = "legacy"
    return command_run(args)


def _common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--cache-root", help="Override cache root (CACHE_ROOT)")
    parser.add_argument("--force-download", action="store_true")
    parser.add_argument("--keep-work", action="store_true")
    parser.add_argument("--dry-run", action="store_true", help="Show the plan without executing")


def _run_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--contigs", required=True, help="Input contigs FASTA")
    p.add_argument("--out", required=True, help="Output directory")
    p.add_argument("--cand-max", type=int, default=None)
    p.add_argument("--species-dedup", action="store_true")
    p.add_argument("--assembly-summary-dir")
    p.add_argument("--taxonomy-dir", help="taxdump dir or taxonomy_hierarchy.tsv")
    p.add_argument(
        "--sketch-db",
        action="append",
        help="Sketch DB (.npz or Mash .msh); repeat for sketch1/2/3-style multi-DB screening",
    )
    p.add_argument("--genome-catalog", help="Local genome dir or refs.tsv (offline source)")
    p.add_argument("--seqid2taxid", help="accession->taxid table for local catalogs")
    p.add_argument("--allow-download", action="store_true", help="Permit NCBI downloads")
    p.add_argument("--backend", default="device", choices=["device", "jax", "host", "legacy"])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m hymet_tpu_torch",
        description="hybrid metagenomic classifier on one NVIDIA card (PyTorch/CUDA)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run", help="Classify one sample end-to-end")
    _run_flags(p)
    _common(p)
    p.set_defaults(func=command_run)

    p = sub.add_parser("sketch", help="Build a reference sketch DB")
    p.add_argument("genomes", nargs="+", help="Genome FASTA files")
    p.add_argument("--out", required=True, help="Output .npz (or .msh)")
    p.add_argument("--kmer", type=int, default=21)
    p.add_argument("--sketch-size", type=int, default=1000)
    p.add_argument("--per-sequence", action="store_true", help="One sketch per sequence (mash -i)")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=command_sketch)

    p = sub.add_parser("index", help="Build a minimizer index")
    p.add_argument("fasta")
    p.add_argument("--out", required=True)
    p.add_argument("--kmer", type=int, default=19)
    p.add_argument("--window", type=int, default=19)
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=command_index)

    p = sub.add_parser("taxonomy", help="Build taxonomy_hierarchy.tsv from an NCBI taxdump")
    p.add_argument("taxdump", help="Directory with names.dmp/nodes.dmp")
    p.add_argument("--out", default="data/taxonomy_hierarchy.tsv")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=command_taxonomy)

    p = sub.add_parser("bench", help="Run the CAMI benchmark harness")
    p.add_argument("--manifest")
    p.add_argument("--tools")
    p.add_argument("--max-samples", type=int)
    p.add_argument("--out")
    p.add_argument("--no-build", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument(
        "--jobs",
        type=int,
        default=1,
        help="Parallel (sample, tool) cells (CPU-backend / baseline runs)",
    )
    _common(p)
    p.set_defaults(func=command_bench)

    p = sub.add_parser("case", help="Run the case-study harness")
    p.add_argument("--manifest")
    p.add_argument("--out")
    _common(p)
    p.set_defaults(func=command_case)

    p = sub.add_parser("ablation", help="Reference-database ablation experiment")
    p.add_argument("--sample")
    p.add_argument("--taxa")
    p.add_argument("--levels")
    p.add_argument("--seqmap")
    p.add_argument("--fasta")
    p.add_argument("--out")
    _common(p)
    p.set_defaults(func=command_ablation)

    p = sub.add_parser("truth", help="Truth-set utilities")
    tsub = p.add_subparsers(dest="truth_command", required=True)
    tz = tsub.add_parser("build-zymo", help="Build Zymo mock community truth tables")
    tz.add_argument("--contigs", required=True)
    tz.add_argument("--paf", required=True)
    tz.add_argument("--seqmap")
    tz.add_argument("--out-contigs", required=True)
    tz.add_argument("--out-profile", required=True)
    tz.add_argument("--dry-run", action="store_true")
    tz.set_defaults(func=command_truth_build_zymo)

    p = sub.add_parser("legacy", help="Legacy pipeline (main.pl semantics)")
    _run_flags(p)
    _common(p)
    p.set_defaults(func=command_legacy)

    p = sub.add_parser("prune-cache", help="Prune the reference cache by age/size")
    p.add_argument("cache_root")
    p.add_argument("--max-age-days", type=float)
    p.add_argument("--max-size-gb", type=float)
    p.add_argument("--no-delete", action="store_true", help="Report only")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=command_prune_cache)

    p = sub.add_parser("eval", help="CAMI profile + contig evaluation")
    p.add_argument("--pred-profile")
    p.add_argument("--truth-profile")
    p.add_argument("--pred-contigs")
    p.add_argument("--truth-contigs")
    p.add_argument("--pred-fasta", help="for MD5/remap contig pairing")
    p.add_argument("--truth-fasta")
    p.add_argument("--taxonomy-dir")
    p.add_argument("--taxmap", help="detailed_taxonomy.tsv for the id-map cascade")
    p.add_argument("--paf", help="alignment PAF for the first-hit fallback")
    p.add_argument("--presence-thresh", type=float, default=0.1)
    p.add_argument("--out", required=True)
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=command_eval)

    p = sub.add_parser("fetch", help="Fetch manifest *_url assets (idempotent)")
    p.add_argument("--manifest", required=True)
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=command_fetch)

    p = sub.add_parser("subset", help="Subset a FASTA by seq/base caps")
    p.add_argument("input")
    p.add_argument("--output", required=True)
    p.add_argument("--max-seqs", type=int, default=1000)
    p.add_argument("--max-bases", type=int, default=500_000_000)
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=command_subset)

    p = sub.add_parser("testdataset", help="Build a synthetic mutated test dataset")
    p.add_argument("genome_dir")
    p.add_argument("--out", required=True)
    p.add_argument("--fraction-genomes", type=float, default=0.1)
    p.add_argument("--trim-fraction", type=float, default=0.1)
    p.add_argument("--mutation-rate", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=command_testdataset)

    p = sub.add_parser("cami-subsets", help="Generate derived CAMI sample subsets")
    p.add_argument("--fasta", required=True)
    p.add_argument("--mapping", required=True, help="gsa_mapping truth TSV")
    p.add_argument("--taxonomy-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=command_cami_subsets)

    p = sub.add_parser("diag", help="PAF-target vs id-map overlap diagnostic")
    p.add_argument("--paf", required=True)
    p.add_argument("--taxonomy", required=True, help="detailed_taxonomy.tsv")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=command_diag)

    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except Exception as exc:  # noqa: BLE001
        print(f"[hymet-tpu] ERROR: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
