"""External baseline-tool runners + CAMI converters.

The reference benchmarks against kraken2(+bracken), centrifuge, ganon2,
sourmash gather and metaphlan4 (``bench/run_*.sh``). Those tools stay
external here exactly as in the reference — each runner shells out when
the binary is installed, converts the native report into a CAMI profile
(ports of ``bench/convert/*``), and writes a per-read/contig table when
the tool supports one. Absent binaries skip with a warning (SURVEY.md
§2.1: baseline tools are harness components, not reimplementation
targets). Copy of hymet_tpu.harness.baselines; its ``parse_kreport`` and
``write_cami_profile`` are the ones the port's
:mod:`hymet_tpu_torch.evalx.converters` already holds.
"""

from __future__ import annotations

import csv
import glob
import json
import logging
import os
import re
import shutil
import subprocess
from typing import Dict, List

from hymet_tpu_torch.evalx.converters import RANKS, parse_kreport, write_cami_profile
from hymet_tpu_torch.harness.manifest import ManifestRow

logger = logging.getLogger("hymet_tpu_torch.baselines")


def _have(cmd: str) -> bool:
    return shutil.which(cmd) is not None


def run_baseline_tool(
    tool: str, row: ManifestRow, tool_dir: str, threads: int
) -> bool:
    runner = _RUNNERS.get(tool)
    if runner is None:
        logger.warning("unknown tool %r; skipping", tool)
        return False
    return runner(row, tool_dir, threads)


_TAXID_IN_NAME = re.compile(r"taxid\s*(\d+)", re.IGNORECASE)


def _kraken_taxid(value: str) -> str:
    """Taxid from a kraken2 ``--use-names`` column ("Name (taxid 123)") or
    a bare numeric taxid (``run_kraken2.sh:115-124``)."""
    value = value.strip()
    m = _TAXID_IN_NAME.search(value)
    if m:
        return m.group(1)
    return value if value.isdigit() else "0"


def _run_kraken2(row: ManifestRow, tool_dir: str, threads: int) -> bool:
    """kraken2 + bracken species refinement (``bench/run_kraken2.sh:70-108``):
    classify with --use-names/--confidence, refine the report with
    ``bracken -l S`` when installed, and fall back to the raw kraken2
    report if bracken is absent or fails."""
    if not _have("kraken2"):
        logger.warning("kraken2 not installed; skipping")
        return False
    db = os.environ.get("KRAKEN2_DB")
    if not db:
        logger.warning("KRAKEN2_DB unset; skipping kraken2")
        return False
    report = os.path.join(tool_dir, "kraken2.report")
    output = os.path.join(tool_dir, "kraken2.out")
    confidence = os.environ.get("KRAKEN2_CONFIDENCE", "0.0")
    subprocess.run(
        [
            "kraken2",
            "--db",
            db,
            "--threads",
            str(threads),
            "--use-names",
            "--confidence",
            confidence,
            "--report",
            report,
            "--output",
            output,
            row.contigs,
        ],
        check=True,
    )
    # bracken refinement leg; any failure falls back to the raw report
    profile_report = report
    if _have("bracken"):
        btable = os.path.join(tool_dir, "bracken_species.tsv")
        breport = os.path.join(tool_dir, "bracken_species.kreport")
        read_len = os.environ.get("BRACKEN_READ_LEN", "150")
        try:
            subprocess.run(
                ["bracken", "-d", db, "-i", report, "-o", btable,
                 "-w", breport, "-r", read_len, "-l", "S"],
                check=True,
            )
            if os.path.getsize(breport) > 0:
                profile_report = breport
        except (subprocess.CalledProcessError, OSError):
            logger.warning("bracken failed; using raw kraken2 report")
    else:
        logger.warning("bracken not installed; using raw kraken2 report")
    rows = parse_kreport(profile_report)
    write_cami_profile(
        os.path.join(tool_dir, "profile.cami.tsv"), rows, row.sample_id
    )
    # per-contig table (Query/TaxID) from the kraken2 per-read output;
    # with --use-names column 3 is "Name (taxid N)"
    with open(output, encoding="utf-8", errors="ignore") as f, open(
        os.path.join(tool_dir, "classified_sequences.tsv"), "w", newline=""
    ) as out:
        w = csv.writer(out, delimiter="\t")
        w.writerow(["Query", "TaxID"])
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3 and parts[0] == "C":
                w.writerow([parts[1], _kraken_taxid(parts[2])])
    _metadata(tool_dir, "kraken2", row)
    return True


def _run_centrifuge(row: ManifestRow, tool_dir: str, threads: int) -> bool:
    if not _have("centrifuge"):
        logger.warning("centrifuge not installed; skipping")
        return False
    db = os.environ.get("CENTRIFUGE_DB")
    if not db:
        logger.warning("CENTRIFUGE_DB unset; skipping centrifuge")
        return False
    report = os.path.join(tool_dir, "centrifuge.kreport")
    out_tab = os.path.join(tool_dir, "centrifuge.out")
    subprocess.run(
        [
            "centrifuge",
            "-x",
            db,
            "-f",
            "-U",
            row.contigs,
            "-p",
            str(threads),
            "-S",
            out_tab,
        ],
        check=True,
    )
    subprocess.run(
        ["centrifuge-kreport", "-x", db, out_tab],
        check=True,
        stdout=open(report, "w"),
    )
    write_cami_profile(
        os.path.join(tool_dir, "profile.cami.tsv"),
        parse_kreport(report),
        row.sample_id,
    )
    _metadata(tool_dir, "centrifuge", row)
    return True


def _run_ganon2(row: ManifestRow, tool_dir: str, threads: int) -> bool:
    if not _have("ganon"):
        logger.warning("ganon not installed; skipping")
        return False
    db = os.environ.get("GANON_DB")
    if not db:
        logger.warning("GANON_DB unset; skipping ganon2")
        return False
    prefix = os.path.join(tool_dir, "ganon")
    subprocess.run(
        [
            "ganon",
            "classify",
            "--db-prefix",
            db,
            "--single-reads",
            row.contigs,
            "--threads",
            str(threads),
            "--rel-cutoff",
            os.environ.get("GANON_REL_CUTOFF", "0"),
            "--rel-filter",
            os.environ.get("GANON_REL_FILTER", "1"),
            "--multiple-matches",
            "lca",
            "--output-one",
            "--skip-report",
            "--output-prefix",
            prefix,
        ],
        check=True,
    )
    # bioboxes (CAMI) report leg (``bench/run_ganon2.sh:80-95``): ganon
    # report emits a CAMI-format .tre which IS the profile; fall back to
    # parsing a native .tre if the report step fails
    profile = os.path.join(tool_dir, "profile.cami.tsv")
    made_profile = False
    try:
        subprocess.run(
            ["ganon", "report", "--input", prefix + ".rep",
             "--db-prefix", db, "--output-prefix", prefix,
             "--output-format", "bioboxes", "--report-type", "reads",
             "--min-count", "0", "--max-count", "0", "--split-hierarchy"],
            check=True,
        )
        tres = sorted(glob.glob(os.path.join(tool_dir, "ganon*.tre")))
        if tres and os.path.getsize(tres[0]) > 0:
            shutil.copyfile(tres[0], profile)
            made_profile = True
    except (subprocess.CalledProcessError, OSError):
        logger.warning("ganon report failed; parsing native .tre")
    if not made_profile and os.path.exists(prefix + ".tre"):
        rows = _parse_ganon_tre(prefix + ".tre")
        write_cami_profile(profile, rows, row.sample_id)
    # per-contig table from the .one assignment file (first taxid token)
    one = prefix + ".one"
    if os.path.exists(one):
        with open(one, encoding="utf-8", errors="ignore") as f, open(
            os.path.join(tool_dir, "classified_sequences.tsv"), "w", newline=""
        ) as out:
            w = csv.writer(out, delimiter="\t")
            w.writerow(["Query", "TaxID"])
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) < 2:
                    continue
                tok = parts[1].split("|")[0]
                if not tok.isdigit():
                    digits = re.findall(r"\d+", parts[1])
                    tok = digits[0] if digits else "0"
                w.writerow([parts[0], tok])
    _metadata(tool_dir, "ganon2", row)
    return True


def _parse_ganon_tre(path: str) -> List[Dict[str, str]]:
    rows = []
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 8:
                continue
            rank = parts[0].strip().lower()
            if rank not in RANKS:
                continue
            rows.append(
                {
                    "taxid": parts[1].strip(),
                    "rank": rank,
                    "taxpath": parts[2].strip().replace("|", "|"),
                    "taxpathsn": parts[3].strip(),
                    "percentage": parts[-1].strip(),
                }
            )
    return rows


def _run_sourmash(row: ManifestRow, tool_dir: str, threads: int) -> bool:
    if not _have("sourmash"):
        logger.warning("sourmash not installed; skipping")
        return False
    db = os.environ.get("SOURMASH_DB")
    if not db:
        logger.warning("SOURMASH_DB unset; skipping sourmash")
        return False
    ksize = os.environ.get("SOURMASH_KSIZE", "31")
    sig = os.path.join(tool_dir, "query.sig")
    gather_csv = os.path.join(tool_dir, "gather.csv")
    subprocess.run(
        [
            "sourmash",
            "sketch",
            "dna",
            "-p",
            f"k={ksize},scaled=1000",
            row.contigs,
            "-o",
            sig,
        ],
        check=True,
    )
    subprocess.run(
        ["sourmash", "gather", sig, db, "-o", gather_csv, "-k", ksize],
        check=True,
    )
    seqmap_path = os.environ.get("SOURMASH_SEQMAP")
    if seqmap_path and os.path.exists(seqmap_path):
        from hymet_tpu_torch.evalx.converters import sourmash_gather_to_cami
        from hymet_tpu_torch.harness.bench import _taxdb_from_env

        seqmap = {}
        with open(seqmap_path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    seqmap[parts[0]] = parts[1]
        sourmash_gather_to_cami(
            gather_csv,
            seqmap,
            os.path.join(tool_dir, "profile.cami.tsv"),
            row.sample_id,
            _taxdb_from_env(),
        )
    else:
        logger.warning(
            "SOURMASH_SEQMAP unset/missing; gather.csv not converted to CAMI"
        )
    _metadata(tool_dir, "sourmash", row)
    return True


def _run_metaphlan4(row: ManifestRow, tool_dir: str, threads: int) -> bool:
    if not _have("metaphlan"):
        logger.warning("metaphlan not installed; skipping")
        return False
    out_prof = os.path.join(tool_dir, "metaphlan.tsv")
    base = ["metaphlan", row.contigs, "--input_type", "fasta", "-o", out_prof]
    try:
        subprocess.run(base + ["--nproc", str(threads)], check=True)
    except subprocess.CalledProcessError:
        # reference retries with <=4 threads + --split_reads
        # (bench/run_metaphlan4.sh:101-125)
        logger.warning("metaphlan failed; retrying with 4 threads + --split_reads")
        subprocess.run(
            base + ["--nproc", str(min(threads, 4)), "--split_reads"], check=True
        )
    from hymet_tpu_torch.evalx.converters import metaphlan_to_cami
    from hymet_tpu_torch.harness.bench import _taxdb_from_env

    metaphlan_to_cami(
        out_prof,
        os.path.join(tool_dir, "profile.cami.tsv"),
        row.sample_id,
        _taxdb_from_env(),
    )
    _metadata(tool_dir, "metaphlan4", row)
    return True


def _metadata(tool_dir: str, tool: str, row: ManifestRow) -> None:
    with open(os.path.join(tool_dir, "metadata.json"), "w") as f:
        json.dump({"tool": tool, "sample": row.sample_id}, f, indent=2)


_RUNNERS = {
    "kraken2": _run_kraken2,
    "centrifuge": _run_centrifuge,
    "ganon2": _run_ganon2,
    "sourmash": _run_sourmash,
    "metaphlan4": _run_metaphlan4,
}
