"""hymet_tpu_torch's experiment harnesses against hymet_tpu's, on the CPU,
on the world of tests/test_pipeline_e2e.py (seed 77: 3 genomes x 50 kbp, 7
contigs): ``run_bench`` with one job and with two spawned workers,
``run_case`` with a comparison profile, and ``run_ablation`` at levels 0.0
and 1.0 with its evaluation. Every file each writes is compared byte for
byte, but for the measured columns of runtime_memory.tsv (sample, tool and
stage are compared), the run's own metadata.json (the port names itself and
its device there), the two figures drawn from measured CPU time and memory,
and the output roots in the evaluator's _debug_info.txt. The minimizer
index an ablation level caches is compared array for array (its zip
entries carry a time stamp) and cache directories keyed by a path's sha1
by position."""

import csv
import json
import os
import re

import numpy as np
import pytest
import torch

from hymet_tpu.harness import ablation as jablation
from hymet_tpu.harness import bench as jbench
from hymet_tpu.harness import case as jcase
from hymet_tpu.io.fasta import iter_fasta
from hymet_tpu_torch.harness import ablation as tablation
from hymet_tpu_torch.harness import bench as tbench
from hymet_tpu_torch.harness import case as tcase
from test_harness_e2e import _truth_files
from test_pipeline_e2e import world  # noqa: F401 — the seed-77 world

torch.set_num_threads(1)

PACKAGES = {"jax": (jbench, jcase, jablation), "torch": (tbench, tcase, tablation)}
KEY = re.compile(r"^[0-9a-f]{40}$")  # a cache directory named by a sha1
MEASURED_FIGURES = {"cpu_time.png", "peak_memory.png"}
TAXA = ["1423", "562", "287"]


def _ablation_inputs(world, tmp):
    """The world's genomes as one combined FASTA and a seqmap of both its
    sequence names and its accessions (as tests/test_harness_e2e.py makes
    them)."""
    acc2tax = dict(ln.split("\t") for ln in open(world["seqid2taxid"]).read().splitlines())
    combined, seqmap = tmp / "combined.fasta", tmp / "seqmap.tsv"
    with combined.open("w") as cf, seqmap.open("w") as sf:
        for fn in sorted(os.listdir(world["genomes_dir"])):
            acc = "_".join(fn.split("_")[:2])
            for name, seq in iter_fasta(os.path.join(world["genomes_dir"], fn)):
                cf.write(f">{name}\n{seq.decode()}\n")
                sf.write(f"{name}\t{acc2tax[acc]}\n{acc}\t{acc2tax[acc]}\n")
    return str(combined), str(seqmap)


@pytest.fixture(scope="module")
def harness_runs(world, tmp_path_factory):
    """Both packages' bench (jobs 1 and 2), case and ablation on the CPU,
    each package with a cache of its own; the jobs=2 workers under
    PYTHONHASHSEED=0, so that both packages' workers order the evaluator's
    equal profile gaps alike."""
    tmp = tmp_path_factory.mktemp("harness")
    truth_contigs, truth_profile = _truth_files(world, tmp)
    contigs = world["query"]
    manifest = tmp / "manifest.tsv"
    manifest.write_text(
        "sample_id\tcontigs_fa\ttruth_contigs_tsv\ttruth_profile_tsv\n"
        f"s_one\t{contigs}\t{truth_contigs}\t{truth_profile}\n"
        f"s_two\t{contigs}\t{truth_contigs}\t{truth_profile}\n")
    case_manifest = tmp / "case_manifest.tsv"
    case_manifest.write_text(
        "sample_id\tcontigs_fa\ttruth_contigs_tsv\ttruth_profile_tsv\tcompare_profile\n"
        f"synthetic\t{contigs}\t{truth_contigs}\t\ttruth_profile.cami.tsv\n")
    combined, seqmap = _ablation_inputs(world, tmp)
    mp = pytest.MonkeyPatch()
    for name, value in {"SKETCH_DBS": world["db_path"], "GENOME_CATALOG": world["genomes_dir"],
                        "SEQID2TAXID": world["seqid2taxid"], "TAXONOMY_DIR": world["tax_dir"],
                        "SCREEN_CHUNK_BP": str(1 << 15), "ALIGN_BATCH_PAD": str(1 << 13),
                        "CAND_MAX": "100", "HYMET_PLATFORM": "cpu", "INPUT_FASTA": contigs,
                        "HYMET_NO_COMPILE_CACHE": "1"}.items():
        mp.setenv(name, value)
    for name in ("TAXONKIT_DB", "SPECIES_DEDUP", "HYMET_PROFILE_WEIGHT", "OUTDIR"):
        mp.delenv(name, raising=False)
    rcs = {}
    try:
        for pkg, (bench, case, ablation) in PACKAGES.items():
            out = tmp / pkg
            mp.setenv("CACHE_ROOT", str(out / "cache"))
            rcs[pkg, "bench"] = bench.run_bench(str(manifest), ["hymet_tpu"],
                                                out_root=str(out / "bench"))
            rcs[pkg, "case"] = case.run_case(str(case_manifest), out_root=str(out / "case"),
                                             threads=2)
            rcs[pkg, "ablation"] = ablation.run_ablation(
                sample="synthetic", taxa=TAXA, levels=[0.0, 1.0], seqmap=seqmap,
                fasta=combined, out_root=str(out / "ablation"), threads=2,
                truth_contigs=truth_contigs, truth_profile=truth_profile)
            mp.setenv("PYTHONHASHSEED", "0")
            rcs[pkg, "bench_jobs2"] = bench.run_bench(str(manifest), ["hymet_tpu"],
                                                      out_root=str(out / "bench_jobs2"), jobs=2)
            mp.delenv("PYTHONHASHSEED")
    finally:
        mp.undo()
    return tmp, rcs


def _tree(root: str) -> dict:
    """relative path -> path of every file under root; a sha1-named
    directory stands as KEY."""
    files = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name), root).split(os.sep)
            files["/".join("KEY" if KEY.match(p) else p for p in rel)] = os.path.join(dirpath,
                                                                                   name)
    return files


def _runtime_keys(path: str) -> list:
    with open(path) as f:
        return [line.split("\t")[:3] for line in f]


def _differences(got_root: str, want_root: str) -> list:
    """Names of the files that differ between the two trees, as the module
    note says they are compared; [] when the trees agree."""
    got, want = _tree(got_root), _tree(want_root)
    if sorted(got) != sorted(want):
        return [f"file sets: only in port {sorted(set(got) - set(want))}, "
                f"only in JAX {sorted(set(want) - set(got))}"]
    bad = []
    for rel, want_path in want.items():
        name, got_path = os.path.basename(rel), got[rel]
        if name == "runtime_memory.tsv":
            same = _runtime_keys(got_path) == _runtime_keys(want_path)
        elif name == "metadata.json" and "timings_sec" in json.load(open(want_path)):
            same = (set(json.load(open(got_path))["timings_sec"])
                    == set(json.load(open(want_path))["timings_sec"]))
        elif name in MEASURED_FIGURES:
            same = True
        elif name.endswith(".npz"):
            # written by the runs above (its names are an object array)
            a, b = np.load(got_path, allow_pickle=True), np.load(want_path, allow_pickle=True)
            same = sorted(a.files) == sorted(b.files) and all(
                a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]) for f in b.files)
        else:
            data = open(want_path, "rb").read()
            if name == "_debug_info.txt":
                data = data.replace(want_root.encode(), got_root.encode())
            same = open(got_path, "rb").read() == data
        if not same:
            bad.append(rel)
    return bad


@pytest.mark.parametrize("what", ["bench", "bench_jobs2", "case", "ablation"])
def test_harness_writes_the_jax_files(harness_runs, what):
    tmp, rcs = harness_runs
    assert rcs["jax", what] == rcs["torch", what] == 0
    got, want = str(tmp / "torch" / what), str(tmp / "jax" / what)
    assert len(_tree(want)) > 20
    assert _differences(got, want) == []


def test_bench_scores_the_world(harness_runs):
    """The port's bench outputs are the harness's, not empty ones: perfect
    species recovery, the aggregate tables over both samples, the cell's
    metadata naming the tool hymet_tpu, and a run and an eval row a
    sample."""
    tmp, _ = harness_runs
    out = tmp / "torch" / "bench"
    for sample in ("s_one", "s_two"):
        tool_dir = out / sample / "hymet_tpu"
        rows = {r["rank"]: r for r in csv.DictReader(
            open(tool_dir / "eval" / "profile_summary.tsv"), delimiter="\t")}
        assert float(rows["species"]["F1_%"]) == 100.0
        meta = json.load(open(tool_dir / "metadata.json"))
        assert meta == {"tool": "hymet_tpu", "sample": sample, "threads": 8}
        run_meta = json.load(open(tool_dir / "work_out" / "metadata.json"))
        assert run_meta["tool"] == "hymet_tpu_torch" and run_meta["device"] == "cpu"
    board = list(csv.DictReader(open(out / "leaderboard_by_rank.tsv"), delimiter="\t"))
    assert {r["samples"] for r in board} == {"2"}
    for root in (out, tmp / "torch" / "bench_jobs2"):
        assert [r[:3] for r in _runtime_keys(str(root / "runtime_memory.tsv"))][1:] == [
            ["s_one", "hymet_tpu", "run"], ["s_one", "hymet_tpu", "eval"],
            ["s_two", "hymet_tpu", "run"], ["s_two", "hymet_tpu", "eval"]]
        assert not [f for f in os.listdir(root) if f.startswith("runtime_memory.tsv.")]


def test_case_compares_against_the_truth_profile(harness_runs):
    """compare_profile, given relative to the manifest, is read: the
    prediction against the truth profile has a KL and a Spearman of its
    own (not the 0 / 1 of a profile against itself), and the top-taxa
    table lists species."""
    tmp, _ = harness_runs
    tool_dir = tmp / "torch" / "case" / "synthetic" / "hymet_tpu"
    rows = dict(ln.split("\t") for ln in (tool_dir / "profile_compare.tsv").read_text().split(
        "\n")[1:] if ln)
    assert set(rows) == {"symmetric_kl_species", "spearman_species"}
    assert "species\t" in (tool_dir / "top_taxa.tsv").read_text()
    assert (tool_dir / "eval" / "profile_summary.tsv").exists()


def test_ablation_levels_degrade(harness_runs):
    """Level 0 keeps the whole reference and classifies at species; level
    1 removes every sequence of the three taxa, and the run there records
    zeros or no species call."""
    tmp, _ = harness_runs
    out = tmp / "torch" / "ablation"
    fallback = list(csv.DictReader(open(out / "rank_fallback.tsv"), delimiter="\t"))
    assert [float(r["level"]) for r in fallback] == [0.0, 1.0]
    assert float(fallback[0]["species_pct"]) > 90.0
    assert float(fallback[1]["total"]) == 0 or float(fallback[1]["species_pct"]) == 0.0
    summary = (out / "refsets" / "ablation_summary.tsv").read_text().splitlines()
    assert len(summary) == 1 + 2 * len(TAXA)
