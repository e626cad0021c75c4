"""hymet_tpu_torch's harness modules against hymet_tpu's, on the CPU, one
function at a time: manifests (the committed ones and the dialects),
runtime_memory.tsv rows, the aggregate tables, the case study's metrics
and tables, the ablation's seeded removals and rank-fallback statistics,
the Zymo truth builder, the baseline runners through the shim binaries of
tests/test_baseline_runners.py, ``fetch`` on ``file://`` URLs, and the
figures skipped where matplotlib is missing. Each writes the same bytes
(or returns the same values) as the JAX package's."""

import csv
import filecmp
import inspect
import logging
import os
import random
import sys

import numpy as np
import pytest
import torch

import test_baseline_runners as shims
from hymet_tpu.harness import ablation as jablation
from hymet_tpu.harness import aggregate as jaggregate
from hymet_tpu.harness import baselines as jbaselines
from hymet_tpu.harness import bench as jbench
from hymet_tpu.harness import case as jcase
from hymet_tpu.harness import fetch as jfetch
from hymet_tpu.harness import manifest as jmanifest
from hymet_tpu.harness import measure as jmeasure
from hymet_tpu.harness import zymo_truth as jzymo
from hymet_tpu_torch.harness import ablation as tablation
from hymet_tpu_torch.harness import aggregate as taggregate
from hymet_tpu_torch.harness import baselines as tbaselines
from hymet_tpu_torch.harness import bench as tbench
from hymet_tpu_torch.harness import case as tcase
from hymet_tpu_torch.harness import fetch as tfetch
from hymet_tpu_torch.harness import manifest as tmanifest
from hymet_tpu_torch.harness import measure as tmeasure
from hymet_tpu_torch.harness import zymo_truth as tzymo
from test_baseline_runners import world  # noqa: F401 — the shims' bin directory and row

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_dirs(got, want):
    """The same names under both directories, and the same bytes in each
    file, subdirectories included."""
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and names
    for name in names:
        a, b = os.path.join(got, name), os.path.join(want, name)
        if os.path.isdir(b):
            _same_dirs(a, b)
        else:
            assert filecmp.cmp(a, b, shallow=False), name


# ----------------------------------------------------------------------
# manifests, runtime rows, aggregate tables

@pytest.mark.parametrize("path", ["examples/cami_manifest.tsv", "examples/case_manifest_zymo.tsv",
                                  "validation/work_cami_suite/cami_manifest.tsv"])
def test_committed_manifests_load_as_jax(path):
    got = tmanifest.load_manifest(os.path.join(REPO, path))
    want = jmanifest.load_manifest(os.path.join(REPO, path))
    assert [vars(r) for r in got] == [vars(r) for r in want] and len(want) >= 2


def test_manifest_dialects_load_as_jax(tmp_path):
    """Comments, blank and sample-less lines, ``sample``/``contigs`` aliases,
    a header in capitals, relative, absolute and empty paths, extra
    columns, a short row."""
    m = tmp_path / "sub" / "manifest.tsv"
    m.parent.mkdir()
    m.write_text(
        "# leading comment\n\n"
        "Sample\tContigs\tTruth_Contigs_TSV\ttruth_profile_tsv\tcompare_profile\texpected_taxa\n"
        "s1\tdata/s1.fna\t\t/abs/truth.tsv\tp.tsv\t1;2\n"
        "  # indented comment\n"
        "\tno_sample.fna\n"
        "s2\t../up/s2.fna\trel/./tc.tsv\n"
        "s3\t/abs/dir/../s3.fna\t\t\t\t\n")
    got, want = tmanifest.load_manifest(str(m)), jmanifest.load_manifest(str(m))
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert [r.sample_id for r in got] == ["s1", "s2", "s3"]
    assert got[1].contigs == str(tmp_path / "up" / "s2.fna")


@pytest.mark.parametrize("values", [(0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
                                    (1.0005, 2.49951, 1e-4, 3.14159, 1024.0, 7.0 / 3),
                                    (123456.789, 0.0015, 0.0025, 12.3456789, 0.5, 1e9)])
def test_runtime_rows_equal_jax(tmp_path, values):
    """HEADER and append_row's formats; measured() appends a row of the
    schema under one header."""
    assert tmeasure.HEADER == jmeasure.HEADER
    for pkg, mod in (("j", jmeasure), ("t", tmeasure)):
        log = str(tmp_path / pkg / "runtime_memory.tsv")
        mod.append_row(log, "s1", "hymet_tpu", "run", *values)
        mod.append_row(log, "s2", "kraken2", "eval", *values[::-1])
    assert filecmp.cmp(tmp_path / "t" / "runtime_memory.tsv", tmp_path / "j" / "runtime_memory.tsv",
                       shallow=False)
    log = str(tmp_path / "t" / "runtime_memory.tsv")
    with tmeasure.measured(log, "s3", "hymet_tpu", "run"):
        sum(range(10000))
    rows = list(csv.DictReader(open(log), delimiter="\t"))
    assert list(rows[-1]) == jmeasure.HEADER and rows[-1]["sample"] == "s3" and len(rows) == 3
    assert all(len(rows[-1][k].split(".")[1]) == 3 for k in jmeasure.HEADER[3:])


def _eval_tree(root, rng):
    """<sample>/<tool>/eval/ trees with random metrics: n <= 0, blank and
    non-numeric rows, a non-numeric metric, an empty and a missing summary,
    a file where a sample directory would be, a tool without eval/."""
    header = "rank\tL1_total_variation_pctpts\tBrayCurtis_pct\tPrecision_%\tRecall_%\tF1_%\tTP\tFP\tFN\n"
    ranks = ["superkingdom", "phylum", "genus", "species"]
    for s in range(4):
        for tool in ("hymet_tpu", "kraken2", "centrifuge"):
            ed = root / f"sample_{s}" / tool / "eval"
            ed.mkdir(parents=True)
            if (s, tool) == (1, "kraken2"):
                (ed / "profile_summary.tsv").write_text("")
                continue
            if (s, tool) == (2, "centrifuge"):
                continue
            rows = [f"{r}\t" + "\t".join(f"{v:.4f}" for v in rng.random(5) * 100)
                    + f"\t{rng.integers(9)}\t1\t2\n" for r in ranks]
            if s == 3:
                rows[0] = "superkingdom\tNA\t1\tx\t4\t5\t1\t1\t1\n"
            (ed / "profile_summary.tsv").write_text(header + "".join(rows))
            (ed / "contigs_per_rank.tsv").write_text(
                "rank\tn\tcorrect\taccuracy_percent\n"
                + "".join(f"{r}\t{n}\t{n // 2}\t{50.0:.4f}\n"
                          for r, n in zip(ranks, (10, 0, -1, int(rng.integers(1, 99)))))
                + "strain\t\t0\t0\nclass\tx\t0\t0\n")
    (root / "sample_0" / "no_eval_tool").mkdir()
    (root / "stray.tsv").write_text("not a sample\n")


def test_aggregate_tables_equal_jax(tmp_path, capsys):
    for pkg, mod in (("j", jaggregate), ("t", taggregate)):
        _eval_tree(tmp_path / pkg, np.random.default_rng(11))
        mod.aggregate(str(tmp_path / pkg))
    names = ["summary_per_tool_per_sample.tsv", "leaderboard_by_rank.tsv",
             "contig_accuracy_per_tool.tsv"]
    for name in names:
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name, shallow=False), name
    board = list(csv.DictReader(open(tmp_path / "t" / names[1]), delimiter="\t"))
    assert {r["tool"] for r in board} == {"hymet_tpu", "kraken2", "centrifuge"}
    jaggregate.aggregate(str(tmp_path / "missing"))
    want = capsys.readouterr().out
    taggregate.aggregate(str(tmp_path / "missing"))
    assert capsys.readouterr().out == want and "No benchmark outputs" in want


# ----------------------------------------------------------------------
# the case study

def _profile_dicts(seed):
    rng = np.random.default_rng(seed)
    keys = [str(k) for k in rng.choice(1000, 30, replace=False)]
    a = {k: float(v) for k, v in zip(keys[:20], rng.integers(0, 5, 20))}  # ties and zeros
    b = {k: float(v) for k, v in zip(keys[10:], rng.random(20) * 50)}
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_case_metrics_equal_jax(seed):
    a, b = _profile_dicts(seed)
    for x, y in ((a, b), (b, a), (a, a), ({}, {}), ({"1": 2.0}, {"1": 2.0}), ({"1": 0.0}, b)):
        assert tcase.symmetric_kl(x, y) == jcase.symmetric_kl(x, y)
        assert tcase.spearman(x, y) == jcase.spearman(x, y)
    assert tcase.spearman(a, a) == pytest.approx(1.0)


def _cami(path, rows):
    with open(path, "w") as f:
        f.write("#CAMI Submission for Taxonomic Profiling\n@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\t"
                "PERCENTAGE\n")
        for tid, rank, pct in rows:
            f.write(f"{tid}\t{rank}\t2|{tid}\tBacteria||Name {tid}|\t{pct}\n")


def test_case_tables_equal_jax(tmp_path):
    """top_taxa_table (three ranks, top 15 of each, the last non-empty
    name) and compare_profiles at species and genus."""
    rng = np.random.default_rng(4)
    rows = [(str(100 + i), rank, f"{rng.random() * 40:.6f}")
            for rank in ("species", "genus", "phylum", "class") for i in range(20)]
    _cami(tmp_path / "a.tsv", rows)
    _cami(tmp_path / "b.tsv", [(t, r, f"{float(p) * (1 + i % 3):.6f}")
                               for i, (t, r, p) in enumerate(rows[::2])])
    for pkg, mod in (("j", jcase), ("t", tcase)):
        mod.top_taxa_table(str(tmp_path / "a.tsv"), str(tmp_path / f"{pkg}_top.tsv"))
        mod.top_taxa_table(str(tmp_path / "b.tsv"), str(tmp_path / f"{pkg}_top5.tsv"), top_n=5)
    for name in ("top.tsv", "top5.tsv"):
        assert filecmp.cmp(tmp_path / f"t_{name}", tmp_path / f"j_{name}", shallow=False)
    assert len((tmp_path / "t_top.tsv").read_text().splitlines()) == 1 + 3 * 15
    for rank in ("species", "genus", "order"):
        a, b = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
        assert tcase.compare_profiles(a, b, rank) == jcase.compare_profiles(a, b, rank)


# ----------------------------------------------------------------------
# the ablation

def _ablation_world(tmp_path):
    rng = np.random.default_rng(8)
    fasta, seqmap = tmp_path / "ref.fasta", tmp_path / "seqmap.tsv"
    with fasta.open("w") as f, seqmap.open("w") as m:
        for i in range(40):
            f.write(f">seq{i} desc {i}\n" + "ACGT" * int(rng.integers(1, 5)) + "\nAC\n")
            m.write(f"seq{i}\t{100 + i % 5}\n")
        m.write("\t7\nshort\n extra \t 101 \n")
    return str(fasta), str(seqmap)


@pytest.mark.parametrize("levels", [[0.0, 0.5, 1.0], [0.25, 0.1, 0.25, 0.75]])
@pytest.mark.parametrize("seed", [1337, 5])
def test_ablate_db_equals_jax(tmp_path, levels, seed):
    """The same removals in the same RNG call order: every level's FASTA
    and ablation_summary.tsv byte for byte; taxa with spaces and one with
    no sequence."""
    fasta, seqmap = _ablation_world(tmp_path)
    taxa = ["100", " 101", "103", "999", ""]
    outs = {}
    for pkg, mod in (("j", jablation), ("t", tablation)):
        outs[pkg] = mod.ablate_db(fasta, seqmap, taxa, levels, str(tmp_path / pkg), seed=seed)
    assert [lv for lv, _ in outs["t"]] == [lv for lv, _ in outs["j"]] == sorted(set(levels))
    _same_dirs(tmp_path / "t", tmp_path / "j")
    assert tablation.load_seqmap(seqmap) == jablation.load_seqmap(seqmap)
    grouped = {"a": [f"s{i}" for i in range(9)], "b": ["x"], "c": []}
    assert (tablation.determine_removals(grouped, 0.5, random.Random(seed))
            == jablation.determine_removals(grouped, 0.5, random.Random(seed)))


@pytest.mark.parametrize("body", [
    "Query\tLineage\tTaxonomic Level\tConfidence\n"
    "c1\tx\tspecies\t1\nc2\tx\tStrain\t1\nc3\tx\tgenus\t1\nc4\tx\tfamily\t1\n"
    "c5\tx\tphylum\t1\nc6\tUnknown\troot\t0\nc7\tx\t\t0\nc8\tx\tunknown\t0\nc9\tx\n",
    "Query\tLineage\tTaxonomic Level\tConfidence\n",
    "Query\tLineage\n"
    "c1\tx\n"])
def test_rank_fallback_stats_equal_jax(tmp_path, body):
    p = tmp_path / "classified.tsv"
    p.write_text(body)
    assert tablation.rank_fallback_stats(str(p)) == jablation.rank_fallback_stats(str(p))


# ----------------------------------------------------------------------
# the Zymo truth builder

SEQMAP = "seqA\t1280\nseqB\t1279\nseqC\t562\nseqD\t287\nseqE\t4932\nseqF\tNA\nshort\n"
PAF_ROWS = [
    # qname qlen qstart qend tname nmatch blocklen [tags]
    ("c1", 10000, 0, 9000, "seqA", 5000, 5100, ""),          # species 1280
    ("c2", 8000, 0, 8000, "seqA", 4000, 4100, ""),           # 1280 and its genus within 1 %
    ("c2", 8000, 0, 8000, "seqB", 3980, 4000, ""),           # -> genus 1279
    ("c3", 6000, 0, 6000, "seqA", 3000, 3050, ""),           # two genera: no call
    ("c3", 6000, 0, 6000, "seqC", 2990, 3000, ""),
    ("c4", 5000, 0, 5000, "seqA", 900, 910, ""),             # under min_match
    ("c5", 5000, 0, 5000, "seqC", 4000, 4010, "dv:f:0.10"),  # dv says 90 %
    ("c6", 5000, 0, 5000, "seqD", 2000, 4000, "dv:f:0.01"),  # dv says 99 %
    ("c7", 5000, 0, 2000, "seqD", 1900, 1950, ""),           # under min_coverage
    ("c8", 5000, 0, 5000, "seqZ", 4000, 4000, ""),           # no taxid
    ("c9", 7000, 0, 7000, "seqE", 6000, 6100, ""),           # Eukaryota: no ALT remap
    ("c10", 9000, 0, 9000, "seqD", 5000, 5050, ""),          # best out of 1 %: 287
    ("c10", 9000, 0, 9000, "seqC", 4000, 4010, ""),
    ("c11", 3000, 0, 3000, "seqA", 2000, 0, ""),             # blocklen 0
    ("c12", 0, 0, 3000, "seqA", 2000, 2000, ""),             # qlen 0
    ("c13", 4000, 100, 3900, "seqF", 3000, 3000, ""),        # non-integer taxid in the seqmap
]


def _zymo_world(tmp_path, mini_taxdb):
    mini_taxdb.write_hierarchy_tsv(str(tmp_path / "taxonomy_hierarchy.tsv"))
    (tmp_path / "seqmap.tsv").write_text(SEQMAP)
    with open(tmp_path / "hits.paf", "w") as f:
        for q, qlen, qs, qe, t, nm, bl, tags in PAF_ROWS:
            f.write(f"{q}\t{qlen}\t{qs}\t{qe}\t+\t{t}\t50000\t0\t{qe - qs}\t{nm}\t{bl}\t60"
                    + (f"\t{tags}" if tags else "") + "\n")
    with open(tmp_path / "contigs.fna", "w") as f:
        for i in range(1, 11):
            f.write(f">c{i} len\n" + "A" * (100 * i + 7) + "\n")


def test_build_zymo_truth_equals_jax(tmp_path, mini_taxdb):
    _zymo_world(tmp_path, mini_taxdb)
    got = {}
    for pkg, mod in (("j", jzymo), ("t", tzymo)):
        (tmp_path / pkg).mkdir()
        got[pkg] = mod.build_zymo_truth(
            contigs=str(tmp_path / "contigs.fna"), paf=str(tmp_path / "hits.paf"),
            seqmap=str(tmp_path / "seqmap.tsv"), out_contigs=str(tmp_path / pkg / "truth_contigs.tsv"),
            out_profile=str(tmp_path / pkg / "truth_profile.cami.tsv"), taxonomy_dir=str(tmp_path))
    assert got["t"] == got["j"]
    assert {c: v[:2] for c, v in got["t"].items()} == {
        "c1": (1280, "species"), "c2": (1279, "genus"), "c6": (287, "species"),
        "c9": (4932, "species"), "c10": (287, "species")}
    _same_dirs(tmp_path / "t", tmp_path / "j")
    assert "\n3379134\tsuperkingdom\t" in (tmp_path / "t" / "truth_profile.cami.tsv").read_text()
    assert "\n2759\tsuperkingdom\t" in (tmp_path / "t" / "truth_profile.cami.tsv").read_text()


def test_build_zymo_truth_thresholds_equal_jax(tmp_path, mini_taxdb):
    """Looser thresholds and a wider tolerance through the helpers."""
    _zymo_world(tmp_path, mini_taxdb)
    paf, seq2tax = str(tmp_path / "hits.paf"), tzymo.load_seqmap(str(tmp_path / "seqmap.tsv"))
    assert seq2tax == jzymo.load_seqmap(str(tmp_path / "seqmap.tsv"))
    for args in ((1000, 0.95, 0.5), (500, 0.5, 0.3), (2500, 0.99, 0.9)):
        hits = tzymo.parse_truth_paf(paf, seq2tax, *args)
        assert hits == jzymo.parse_truth_paf(paf, seq2tax, *args)
        for tol in (0.0, 0.01, 0.3):
            assert (tzymo.assign_truth_taxids(hits, mini_taxdb, tol)
                    == jzymo.assign_truth_taxids(hits, mini_taxdb, tol))


def test_build_zymo_truth_needs_a_seqmap(tmp_path, mini_taxdb):
    _zymo_world(tmp_path, mini_taxdb)
    with pytest.raises(ValueError, match="seqmap"):
        tzymo.build_zymo_truth(str(tmp_path / "contigs.fna"), str(tmp_path / "hits.paf"),
                               str(tmp_path / "c.tsv"), str(tmp_path / "p.tsv"),
                               taxonomy_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="taxonomy_dir"):
        tzymo._load_taxdb(str(tmp_path / "nowhere"))


# ----------------------------------------------------------------------
# the baseline runners, through tests/test_baseline_runners.py's shims

SHIM_TESTS = ["test_kraken2_bracken_refinement", "test_kraken2_bracken_fallback",
              "test_ganon_bioboxes_report", "test_centrifuge_kreport_leg",
              "test_sourmash_gather_leg", "test_metaphlan_split_reads_retry"]


@pytest.mark.parametrize("name", SHIM_TESTS)
def test_baseline_runner_writes_the_jax_files(name, world, monkeypatch, tmp_path,  # noqa: F811
                                              mini_taxdb):
    """Each of test_baseline_runners.py's shim tests, with its
    run_baseline_tool running both packages' runner into two directories:
    the same return value and the same files (the JAX test's own checks
    then read the JAX package's)."""
    runs = []

    def both(tool, row, tool_dir, threads):
        ok = jbaselines.run_baseline_tool(tool, row, tool_dir, threads)
        port_dir = tool_dir + "_port"
        os.makedirs(port_dir)
        trow = tmanifest.ManifestRow(**vars(row))
        assert tbaselines.run_baseline_tool(tool, trow, port_dir, threads) == ok
        runs.append((port_dir, tool_dir))
        return ok

    monkeypatch.setattr(shims, "run_baseline_tool", both)
    test = getattr(shims, name)
    given = {"world": world, "monkeypatch": monkeypatch, "tmp_path": tmp_path,
             "mini_taxdb": mini_taxdb}
    test(**{p: given[p] for p in inspect.signature(test).parameters})
    assert runs
    for port_dir, jax_dir in runs:
        _same_dirs(port_dir, jax_dir)


@pytest.mark.parametrize("tool,installed", [
    *((tool, False) for tool in ("kraken2", "centrifuge", "ganon2", "sourmash", "metaphlan4",
                                 "no_such_tool")),
    *((tool, True) for tool in ("kraken2", "centrifuge", "ganon2", "sourmash"))])
def test_baseline_runner_skips_as_jax(tool, installed, world, monkeypatch, tmp_path, caplog):  # noqa: F811
    """A binary not on PATH, or its DB variable unset (metaphlan has none),
    skips the tool with the JAX package's warning and writes nothing."""
    monkeypatch.setenv("PATH", str(world["bindir"]))
    for var in ("KRAKEN2_DB", "CENTRIFUGE_DB", "GANON_DB", "SOURMASH_DB"):
        monkeypatch.delenv(var, raising=False)
    if installed:
        for binary in ("kraken2", "centrifuge", "ganon", "sourmash"):
            shims._shim(world["bindir"], binary, "exit 3\n")
    msgs = {}
    for pkg, mod in (("j", jbaselines), ("t", tbaselines)):
        out = tmp_path / pkg
        out.mkdir()
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert mod.run_baseline_tool(tool, world["row"], str(out), 2) is False
        msgs[pkg] = [r.getMessage() for r in caplog.records]
        assert os.listdir(out) == []
    assert msgs["t"] == msgs["j"] and len(msgs["j"]) == 1


def test_kraken_taxid_and_ganon_tre_parse_as_jax(tmp_path):
    for value in ("Escherichia coli (taxid 562)", "562", "unclassified", " TAXID 7 ", "x12"):
        assert tbaselines._kraken_taxid(value) == jbaselines._kraken_taxid(value)
    tre = tmp_path / "g.tre"
    tre.write_text("species\t562\t2|562\tBacteria|E. coli\ta\tb\tc\t80.5\n"
                   "genus\t561\t2|561\tBacteria|Escherichia\ta\tb\tc\t19.5\n"
                   "strain\t1\t2\tx\ta\tb\tc\t1\nshort\tline\n")
    assert tbaselines._parse_ganon_tre(str(tre)) == jbaselines._parse_ganon_tre(str(tre))


# ----------------------------------------------------------------------
# fetch

def test_fetch_copies_file_urls_as_jax(tmp_path, caplog):
    """``*_url`` columns as file:// URLs: fetched next to their targets,
    a target already present kept, a missing source failed with no
    ``.part`` left, a URL without a target column ignored."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.fna").write_text(">a\nACGT\n")
    (src / "t.tsv").write_text("contig_id\ttaxid\na\t562\n")
    url = (src / "a.fna").as_uri()
    results = {}
    for pkg, mod in (("j", jfetch), ("t", tfetch)):
        root = tmp_path / pkg
        (root / "data").mkdir(parents=True)
        (root / "data" / "present.fna").write_text(">kept\n")
        (root / "m.tsv").write_text(
            "sample_id\tcontigs_fa\ttruth_contigs_tsv\ttruth_profile_tsv\tcontigs_url\t"
            "truth_contigs_url\ttruth_profile_url\n"
            f"s1\tdata/s1/contigs.fna\tdata/s1/t.tsv\t\t{url}\t{(src / 't.tsv').as_uri()}\t"
            f"{url}\n"
            f"s2\tdata/s2.fna\t\t\t{(src / 'missing.fna').as_uri()}\t\t\n"
            f"s3\tdata/present.fna\t\t\t{url}\t\t\n")
        ok, failed = mod.fetch_manifest_assets(str(root / "m.tsv"))
        results[pkg] = ([os.path.relpath(p, root) for p in ok],
                        [os.path.relpath(p, root) for p in failed])
    assert results["t"] == results["j"] == (["data/s1/contigs.fna", "data/s1/t.tsv",
                                             "data/present.fna"], ["data/s2.fna"])
    _same_dirs(tmp_path / "t" / "data", tmp_path / "j" / "data")
    assert (tmp_path / "t" / "data" / "present.fna").read_text() == ">kept\n"
    assert (tmp_path / "t" / "data" / "s1" / "contigs.fna").read_text() == ">a\nACGT\n"


# ----------------------------------------------------------------------
# figures where matplotlib is missing (the card's machine)

def test_bench_without_matplotlib_skips_the_figures_as_jax(tmp_path, monkeypatch, caplog):
    """The only failure the bench swallows on its own path: no matplotlib
    logs "figure generation skipped" and the bench returns 0 (a baseline
    tool that is not installed runs no cell)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setenv("HYMET_PLATFORM", "cpu")
    monkeypatch.setenv("PATH", str(tmp_path))
    contigs = tmp_path / "c.fna"
    contigs.write_text(">c1\nACGT\n")
    (tmp_path / "m.tsv").write_text(f"sample_id\tcontigs_fa\ns1\t{contigs}\n")
    msgs = {}
    for pkg, mod in (("j", jbench), ("t", tbench)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert mod.run_bench(str(tmp_path / "m.tsv"), ["kraken2"],
                                 out_root=str(tmp_path / pkg)) == 0
        msgs[pkg] = [r.getMessage() for r in caplog.records]
    assert msgs["t"] == msgs["j"]
    assert any(m.startswith("figure generation skipped") for m in msgs["t"])
    assert not (tmp_path / "t" / "figures").exists()
    assert ([r[:3] for r in csv.reader(open(tmp_path / "t" / "runtime_memory.tsv"), delimiter="\t")]
            == [r[:3] for r in csv.reader(open(tmp_path / "j" / "runtime_memory.tsv"),
                                          delimiter="\t")])


@pytest.mark.parametrize("platform", ["tpu", "GPU"])
def test_harness_refuses_an_unknown_platform(tmp_path, monkeypatch, platform):
    """HYMET_PLATFORM other than gpu, cuda or cpu fails before anything
    is written (a missing manifest is reported first, as in the JAX
    package)."""
    monkeypatch.setenv("HYMET_PLATFORM", platform)
    (tmp_path / "m.tsv").write_text("sample_id\tcontigs_fa\n")
    for call in (lambda: tbench.run_bench(str(tmp_path / "m.tsv"), ["hymet_tpu"],
                                          out_root=str(tmp_path / "b")),
                 lambda: tcase.run_case(str(tmp_path / "m.tsv"), out_root=str(tmp_path / "c"))):
        with pytest.raises(ValueError, match="HYMET_PLATFORM"):
            call()
    with pytest.raises(FileNotFoundError):
        tbench.run_bench(str(tmp_path / "none.tsv"), ["hymet_tpu"])
    assert sorted(os.listdir(tmp_path)) == ["m.tsv"]
