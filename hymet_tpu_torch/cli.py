"""Command line of hymet_tpu_torch: ``python -m hymet_tpu_torch <subcommand>``.

The subcommands of hymet_tpu's command line (``hymet_tpu/cli.py``) that the
port runs, with its flags, ``--dry-run`` plan lines, messages and exit
codes: ``run`` and ``legacy`` (one sample end to end), ``sketch`` (sketch
DBs, ``.npz`` or Mash ``.msh``), ``index`` (a minimizer index),
``taxonomy`` (``taxonomy_hierarchy.tsv`` from a taxdump) and
``prune-cache``. One difference: ``--backend`` defaults to ``device``, the
port's name for the JAX package's ``jax`` backend (which is accepted as
the same).

The device comes from ``HYMET_PLATFORM``, the variable the JAX command
line reads: unset, ``gpu`` or ``cuda`` run on the card (and fail without
one); ``cpu`` runs the plain CPU path; anything else is an error. There is
no silent CPU fallback. ``--dry-run`` prints the resolved plan and touches
no device.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

from hymet_tpu_torch.utils.config import RunConfig

PLATFORMS = {"": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def device_from_env() -> str:
    """The torch device ``HYMET_PLATFORM`` names (see the module note)."""
    platform = os.environ.get("HYMET_PLATFORM", "")
    if platform not in PLATFORMS:
        raise ValueError(f"HYMET_PLATFORM={platform!r}: use gpu, cuda or cpu")
    return PLATFORMS[platform]


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
