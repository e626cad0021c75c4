"""hymet_tpu_torch's command line against hymet_tpu's on the CPU: the
``--dry-run`` plan lines of all 16 subcommands (equal but for the
documented ``classifier_backend`` default);
``RunConfig.from_env`` under a patched environment; ``HYMET_PLATFORM=cpu
python -m hymet_tpu_torch sketch`` writing the JAX CLI's ``.npz`` arrays
and ``.msh`` bytes; ``run`` and ``legacy`` on the world of
tests/test_pipeline_e2e.py writing the JAX CLI's stage files byte for
byte; index, taxonomy and prune-cache runs; ``eval`` and ``diag`` on the
gut sample and the dataset tools through both command lines with the same
files; bench, case, ablation, truth build-zymo and fetch through both
command lines with the same files, messages and exit codes; and the
device rule (no CPU fallback, an unknown platform refused,
``eval`` refused without ``HYMET_PLATFORM=cpu`` on a machine without a
card)."""

import dataclasses
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hymet_tpu import cli as jcli
from hymet_tpu.io.sketchdb import SketchDB as JDB
from hymet_tpu.utils.config import RunConfig as JConfig
from hymet_tpu_torch import cli as tcli
from hymet_tpu_torch.utils.config import RunConfig as TConfig
from test_pipeline_e2e import world  # noqa: F401 — the seed-77 world
from test_torch_classify import _write_taxdump

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENV = {"INPUT_FASTA": "in.fna", "OUTDIR": "o", "THREADS": "3", "CAND_MAX": "77",
       "SPECIES_DEDUP": "1", "ASSEMBLY_SUMMARY_DIR": "asm", "CAND_LIMIT_LOG": "lim.log",
       "MASH_THRESH": "0.75", "FORCE_DOWNLOAD": "1", "CACHE_ROOT": "cc", "TAXONKIT_DB": "tk",
       "SKETCH_DBS": os.pathsep.join(["a.npz", "", "b.msh"]), "GENOME_CATALOG": "gc",
       "SEQID2TAXID": "s2t", "ALLOW_DOWNLOAD": "1", "DB_SHARDS": "1",
       "SCREEN_CHUNK_BP": "4096", "ALIGN_BATCH_PAD": "8192"}
ENV_NAMES = list(ENV) + ["TAXONOMY_DIR", "HYMET_PLATFORM"]


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HYMET_NO_COMPILE_CACHE", "1")
    return monkeypatch


def _lines(main, argv, capsys):
    rc = main(list(argv))
    out = capsys.readouterr().out
    return rc, out.splitlines()


RUN_ARGS = ["--contigs", "c.fna", "--out", "o", "--threads", "2", "--cand-max", "9",
            "--species-dedup", "--taxonomy-dir", "tax", "--sketch-db", "s1.npz", "--sketch-db",
            "s2.msh", "--genome-catalog", "g", "--seqid2taxid", "m.tsv", "--allow-download",
            "--cache-root", "cache", "--force-download", "--keep-work", "--dry-run"]


@pytest.mark.parametrize("argv", [
    ["run", "--contigs", "c.fna", "--out", "o", "--dry-run"],
    ["run", *RUN_ARGS, "--backend", "host"],
    ["run", *RUN_ARGS, "--backend", "jax"],
    ["legacy", "--contigs", "c.fna", "--out", "o", "--dry-run"],
    ["legacy", *RUN_ARGS],
    ["sketch", "a.fna", "b.fna.gz", "--out", "x.msh", "--dry-run"],
    ["sketch", "a.fna", "--out", "x.npz", "--kmer", "15", "--sketch-size", "7", "--per-sequence",
     "--dry-run"],
    ["index", "ref.fna", "--out", "i.npz", "--dry-run"],
    ["index", "ref.fna", "--out", "i.npz", "--kmer", "15", "--window", "10", "--dry-run"],
    ["taxonomy", "taxdump/", "--dry-run"],
    ["taxonomy", "taxdump/", "--out", "t/h.tsv", "--dry-run"],
    ["prune-cache", "cache", "--max-age-days", "3", "--max-size-gb", "0.5", "--dry-run"],
    ["prune-cache", "cache", "--dry-run"],
    ["eval", "--out", "e", "--dry-run"],
    ["eval", "--pred-profile", "p.tsv", "--truth-profile", "t.tsv", "--pred-contigs", "c.tsv",
     "--truth-contigs", "tc.tsv", "--pred-fasta", "p.fna", "--truth-fasta", "t.fna",
     "--taxonomy-dir", "tax", "--taxmap", "m.tsv", "--paf", "r.paf", "--presence-thresh", "0.5",
     "--out", "e", "--dry-run"],
    ["diag", "--paf", "r.paf", "--taxonomy", "d.tsv", "--dry-run"],
    ["subset", "in.fna", "--output", "s.fna", "--dry-run"],
    ["subset", "in.fna", "--output", "s.fna", "--max-seqs", "3", "--max-bases", "99", "--dry-run"],
    ["testdataset", "genomes/", "--out", "td", "--dry-run"],
    ["testdataset", "genomes/", "--out", "td", "--fraction-genomes", "0.5", "--trim-fraction",
     "0.2", "--mutation-rate", "0.1", "--seed", "4", "--dry-run"],
    ["cami-subsets", "--fasta", "c.fna", "--mapping", "m.tsv", "--taxonomy-dir", "tax", "--out",
     "cs", "--dry-run"],
    ["bench", "--dry-run"],
    ["bench", "--manifest", "m.tsv", "--tools", "hymet_tpu,kraken2", "--max-samples", "2", "--out",
     "b", "--no-build", "--resume", "--jobs", "3", "--threads", "4", "--cache-root", "cc",
     "--dry-run"],
    ["case", "--dry-run"],
    ["case", "--manifest", "m.tsv", "--out", "cs", "--threads", "2", "--dry-run"],
    ["ablation", "--dry-run"],
    ["ablation", "--sample", "s", "--taxa", "1,2", "--levels", "0,1", "--seqmap", "sm.tsv",
     "--fasta", "r.fna", "--out", "ab", "--keep-work", "--dry-run"],
    ["truth", "build-zymo", "--contigs", "c.fna", "--paf", "r.paf", "--out-contigs", "tc.tsv",
     "--out-profile", "tp.tsv", "--dry-run"],
    ["truth", "build-zymo", "--contigs", "c.fna", "--paf", "r.paf", "--seqmap", "sm.tsv",
     "--out-contigs", "tc.tsv", "--out-profile", "tp.tsv", "--dry-run"],
    ["fetch", "--manifest", "m.tsv", "--dry-run"],
], ids=lambda a: "-".join(x for x in a if not x.startswith(("--", "c.", "o")))[:40])
@pytest.mark.parametrize("env", ["clean", "patched"])
def test_dry_run_lines_equal_jax(clean_env, capsys, argv, env):
    """The same plan lines, in the same order, and exit code 0; where the
    backend is left at its default, the port names it "device" where the
    JAX package names it "jax"."""
    if env == "patched":
        for name, value in ENV.items():
            clean_env.setenv(name, value)
    rc_j, want = _lines(jcli.main, argv, capsys)
    rc_t, got = _lines(tcli.main, argv, capsys)
    assert rc_t == rc_j == 0 and len(want) >= 1
    if argv[0] == "run" and "--backend" not in argv:
        assert want.count("[hymet-tpu] classifier_backend='jax'") == 1
        want = [ln.replace("'jax'", "'device'") if "classifier_backend" in ln else ln for ln in want]
    assert got == want


def test_from_env_equals_jax(clean_env):
    """Every field from the environment, then overrides (None ones
    ignored); describe() gives the same lines but for the backend
    default."""
    for name, value in ENV.items():
        clean_env.setenv(name, value)
    t, j = TConfig.from_env(), JConfig.from_env()
    want = dataclasses.asdict(j)
    want["classifier_backend"] = "device"
    assert dataclasses.asdict(t) == want
    assert t.sketch_dbs == ["a.npz", "b.msh"] and t.taxonomy_dir == "tk"
    clean_env.delenv("TAXONKIT_DB")
    clean_env.setenv("TAXONOMY_DIR", "td")
    over = dict(cand_max=5, outdir=None, classifier_backend="host", keep_work=True)
    t, j = TConfig.from_env(**over), JConfig.from_env(**over)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.describe() == j.describe() and t.taxonomy_dir == "td" and t.outdir == "o"
    assert [f.name for f in dataclasses.fields(TConfig)] == [f.name for f in dataclasses.fields(JConfig)]


def test_from_env_defaults_equal_jax(clean_env):
    want = dataclasses.asdict(JConfig.from_env())
    want["classifier_backend"] = "device"
    assert dataclasses.asdict(TConfig.from_env()) == want == dataclasses.asdict(TConfig())


def _genome_files(tmp_path):
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    paths = []
    for i, lens in enumerate([(4000, 900), (3000,), (12,), (2500, 40, 700)]):
        path = tmp_path / f"g{i}.fna"
        path.write_text("".join(f">g{i}_{j} x\n{acgt[rng.integers(0, 4, n)].tobytes().decode()}\n"
                                for j, n in enumerate(lens)))
        paths.append(str(path))
    return paths


def _same_npz(a: str, b: str) -> None:
    x, y = JDB.load(a), JDB.load(b)
    assert (x.k, x.sketch_size, x.names, x.comments) == (y.k, y.sketch_size, y.names, y.comments)
    for f in ("hashes", "n_hashes", "lengths"):
        assert getattr(x, f).dtype == getattr(y, f).dtype
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


@pytest.mark.parametrize("ext,extra", [(".npz", []), (".msh", []), (".npz", ["--per-sequence"]),
                                       (".msh", ["--per-sequence", "--kmer", "15"])])
def test_sketch_subcommand_writes_the_jax_files(clean_env, tmp_path, capsys, ext, extra):
    """``HYMET_PLATFORM=cpu python -m hymet_tpu_torch sketch`` in a child
    process; the JAX CLI in this one: the same .npz arrays, the same .msh
    bytes, the same message."""
    genomes = _genome_files(tmp_path)
    args = ["sketch", *genomes, "--sketch-size", "50", *extra]
    clean_env.setenv("HYMET_PLATFORM", "cpu")
    want = tmp_path / f"j{ext}"
    assert jcli.main([*args, "--out", str(want)]) == 0
    jmsg = capsys.readouterr().out
    got = tmp_path / f"t{ext}"
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-m", "hymet_tpu_torch", *args, "--out", str(got)],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.replace(str(got), "X") == jmsg.replace(str(want), "X")
    if ext == ".msh":
        assert got.read_bytes() == want.read_bytes()
    else:
        _same_npz(str(got), str(want))


def _run_argv(world, out, cache, backend_args):
    return ["--contigs", world["query"], "--out", str(out), "--cand-max", "100",
            "--cache-root", str(cache), "--taxonomy-dir", world["tax_dir"],
            "--sketch-db", world["db_path"], "--genome-catalog", world["genomes_dir"],
            "--seqid2taxid", world["seqid2taxid"], *backend_args]


@pytest.fixture(scope="module")
def cli_runs(world, tmp_path_factory):
    """run and legacy through both command lines, on the CPU, with the
    e2e test's small shapes from the environment (SCREEN_CHUNK_BP,
    ALIGN_BATCH_PAD, read by RunConfig.from_env)."""
    tmp = tmp_path_factory.mktemp("cli_runs")
    mp = pytest.MonkeyPatch()
    for name in ENV_NAMES:
        mp.delenv(name, raising=False)
    mp.setenv("HYMET_PLATFORM", "cpu")
    mp.setenv("HYMET_NO_COMPILE_CACHE", "1")
    mp.setenv("SCREEN_CHUNK_BP", str(1 << 15))
    mp.setenv("ALIGN_BATCH_PAD", str(1 << 13))
    rcs = {}
    try:
        for pkg, main in (("jax", jcli.main), ("torch", tcli.main)):
            for cmd in ("run", "legacy"):
                rcs[pkg, cmd] = main([cmd, *_run_argv(world, tmp / pkg / cmd, tmp / pkg / "cache",
                                                      [])])
    finally:
        mp.undo()
    return tmp, rcs


@pytest.mark.parametrize("cmd", ["run", "legacy"])
@pytest.mark.parametrize("name", ["work/selected_genomes.txt", "work/resultados.paf",
                                  "classified_sequences.tsv", "hymet.sample.cami.tsv"])
def test_run_and_legacy_write_the_jax_files(cli_runs, cmd, name):
    tmp, rcs = cli_runs
    assert rcs["jax", cmd] == rcs["torch", cmd] == 0
    got, want = tmp / "torch" / cmd / name, tmp / "jax" / cmd / name
    assert os.path.getsize(want) > 0
    assert filecmp.cmp(got, want, shallow=False)


def test_legacy_classifies_otherwise_than_run(cli_runs):
    """The legacy subcommand really ran classification.py's classifier:
    its TSV differs from the run's (no space after ';', 4-decimal
    confidences of a consensus over all hits)."""
    tmp, _ = cli_runs
    legacy = (tmp / "torch" / "legacy" / "classified_sequences.tsv").read_text()
    run = (tmp / "torch" / "run" / "classified_sequences.tsv").read_text()
    assert legacy != run and "; " not in legacy and "; " in run
    with open(tmp / "torch" / "legacy" / "metadata.json") as f:
        assert '"classifier_backend": "legacy"' in f.read()


def test_index_subcommand_writes_the_jax_index(clean_env, tmp_path, capsys):
    from hymet_tpu.io.minimizer_index import MinimizerIndex as JIndex

    rng = np.random.default_rng(3)
    fasta = tmp_path / "ref.fna"
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fasta.write_text("".join(f">r{i}\n{acgt[rng.integers(0, 4, n)].tobytes().decode()}\n"
                             for i, n in enumerate([3000, 50, 1200])))
    clean_env.setenv("HYMET_PLATFORM", "cpu")
    args = ["index", str(fasta), "--kmer", "15", "--window", "10", "--out"]
    assert jcli.main([*args, str(tmp_path / "j.npz")]) == 0
    jmsg = capsys.readouterr().out
    assert tcli.main([*args, str(tmp_path / "t.npz")]) == 0
    assert capsys.readouterr().out.replace("t.npz", "j.npz") == jmsg
    got, want = JIndex.load(str(tmp_path / "t.npz")), JIndex.load(str(tmp_path / "j.npz"))
    assert got.names == want.names and (got.k, got.w) == (want.k, want.w)
    for f in ("hashes", "seq_id", "pos", "strand", "lengths"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_taxonomy_subcommand_writes_the_jax_hierarchy(clean_env, tmp_path, capsys):
    _write_taxdump(tmp_path)
    clean_env.setenv("HYMET_PLATFORM", "cpu")
    assert jcli.main(["taxonomy", str(tmp_path), "--out", str(tmp_path / "j" / "h.tsv")]) == 0
    assert tcli.main(["taxonomy", str(tmp_path), "--out", str(tmp_path / "t" / "h.tsv")]) == 0
    assert filecmp.cmp(tmp_path / "t" / "h.tsv", tmp_path / "j" / "h.tsv", shallow=False)


@pytest.mark.parametrize("flags", [["--max-age-days", "2"], ["--max-size-gb", "0.000002"],
                                   ["--max-age-days", "2", "--max-size-gb", "0.000001"], []])
def test_prune_cache_lists_the_jax_paths(clean_env, tmp_path, capsys, flags):
    """--no-delete: the same paths listed, in the same order, nothing
    removed; then a real prune removes them."""
    cache = tmp_path / "cache"
    for i, (age_days, size) in enumerate([(5, 100), (1, 3000), (3, 10), (0, 500), (10, 0)]):
        d = cache / f"key{i}"
        d.mkdir(parents=True)
        (d / "combined_genomes.fasta").write_bytes(b"A" * size)
        t = 1_700_000_000 - age_days * 86400
        os.utime(d, (t, t))
    (cache / "stray.txt").write_text("not an entry")
    args = ["prune-cache", str(cache), *flags]
    assert jcli.main([*args, "--no-delete"]) == 0
    want = capsys.readouterr().out
    assert tcli.main([*args, "--no-delete"]) == 0
    assert capsys.readouterr().out == want
    assert len(os.listdir(cache)) == 6
    assert tcli.main(args) == 0
    removed = capsys.readouterr().out
    assert removed == want.replace("would remove", "removed")
    assert len(os.listdir(cache)) == 6 - removed.count("removed")


def test_unknown_platform_is_refused(clean_env, tmp_path, capsys):
    clean_env.setenv("HYMET_PLATFORM", "tpu")
    assert tcli.main(["sketch", *_genome_files(tmp_path), "--out", str(tmp_path / "x.npz")]) == 1
    assert "HYMET_PLATFORM='tpu'" in capsys.readouterr().err
    assert not (tmp_path / "x.npz").exists()


@pytest.mark.parametrize("platform", [None, "gpu", "cuda"])
def test_card_platforms_do_not_fall_back_to_the_cpu(clean_env, tmp_path, capsys, platform):
    """Unset, gpu and cuda ask for the card: here, where there is none,
    the command fails (exit 1) and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    if platform:
        clean_env.setenv("HYMET_PLATFORM", platform)
    assert tcli.device_from_env() == "cuda"
    assert tcli.main(["sketch", *_genome_files(tmp_path), "--out", str(tmp_path / "x.npz")]) == 1
    assert "CUDA" in capsys.readouterr().err and not (tmp_path / "x.npz").exists()


def test_usage_errors_exit_like_jax(clean_env, capsys):
    for argv in ([], ["run"], ["sketch", "--out", "x.npz"], ["truth", "--dry-run"],
                 ["fetch", "--dry-run"], ["truth", "build-zymo", "--paf", "p", "--dry-run"],
                 ["bench", "--jobs", "two", "--dry-run"], ["serve", "--dry-run"],
                 ["run", "--contigs", "c", "--out", "o", "--backend", "tpu"]):
        for main in (jcli.main, tcli.main):
            with pytest.raises(SystemExit) as t:
                main(argv)
            assert t.value.code == 2
    capsys.readouterr()


def test_module_entry_point_prints_usage():
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-m", "hymet_tpu_torch", "--help"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    for cmd in ("run", "legacy", "sketch", "index", "taxonomy", "prune-cache", "eval", "diag",
                "subset", "testdataset", "cami-subsets", "bench", "case", "ablation", "truth",
                "fetch"):
        assert cmd in out.stdout


# ----------------------------------------------------------------------
# the evaluator and the dataset tools

WORLD = os.path.join(REPO, "validation", "work_cami_suite")
GUT = os.path.join(WORLD, "data", "camisyn_gut")


@pytest.fixture(scope="module")
def gut_run(world, cli_runs):
    """What eval scores: the port's run of the e2e world (its TSV, profile,
    PAF and cache's detailed_taxonomy.tsv) against that world's truth,
    written as a truth table from the world's contig labels."""
    tmp, _ = cli_runs
    run = tmp / "torch" / "run"
    (key,) = os.listdir(tmp / "torch" / "cache")
    truth = tmp / "truth_contigs.tsv"
    names = [ln[1:].split()[0] for ln in open(world["query"]) if ln.startswith(">")]
    taxids = [ln.split("\t")[1].strip() for ln in open(world["seqid2taxid"])]
    truth.write_text("contig_id\ttaxid\n" + "".join(
        f"{n}\t{taxids[i % len(taxids)]}\n" for i, n in enumerate(names)))
    return {"pred_profile": str(run / "hymet.sample.cami.tsv"),
            "classified": str(run / "classified_sequences.tsv"),
            "paf": str(run / "work" / "resultados.paf"), "truth": str(truth),
            "taxmap": str(tmp / "torch" / "cache" / key / "detailed_taxonomy.tsv"),
            "query": world["query"], "tax_dir": world["tax_dir"]}


def _eval_argv(run, out):
    return ["eval", "--pred-profile", run["pred_profile"], "--truth-profile", run["pred_profile"],
            "--pred-contigs", run["classified"], "--truth-contigs", run["truth"],
            "--pred-fasta", run["query"], "--taxonomy-dir", run["tax_dir"],
            "--taxmap", run["taxmap"], "--paf", run["paf"], "--out", str(out)]


def test_eval_writes_the_jax_files(clean_env, tmp_path, capsys, gut_run):
    clean_env.setenv("HYMET_PLATFORM", "cpu")
    assert jcli.main(_eval_argv(gut_run, tmp_path / "j")) == 0
    assert tcli.main(_eval_argv(gut_run, tmp_path / "t")) == 0
    written = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == written and "contigs_exact.tsv" in written
    for name in written:
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name, shallow=False), name


def test_eval_module_under_one_hash_seed_writes_the_jax_files(tmp_path, gut_run):
    """``python -m hymet_tpu_torch eval`` and the JAX command line, each in
    a child process under PYTHONHASHSEED=0, on the committed gut profile
    scored against itself rebuilt from its truth table: every gap is 0, so
    set order alone orders profile_diffs_*."""
    argv = ["eval", "--pred-profile", os.path.join(GUT, "truth_profile.tsv"),
            "--truth-contigs", os.path.join(GUT, "truth_contigs.tsv"),
            "--pred-fasta", os.path.join(GUT, "contigs.fna"),
            "--taxonomy-dir", os.path.join(WORLD, "taxonomy")]
    env = {**os.environ, "PYTHONPATH": REPO, "PYTHONHASHSEED": "0", "HYMET_PLATFORM": "cpu",
           "HYMET_NO_COMPILE_CACHE": "1"}
    for pkg in ("hymet_tpu", "hymet_tpu_torch"):
        mod = [pkg + ".cli"] if pkg == "hymet_tpu" else [pkg]
        out = subprocess.run([sys.executable, "-m", *mod, *argv, "--out", str(tmp_path / pkg)],
                             cwd=str(tmp_path), env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr
    written = sorted(os.listdir(tmp_path / "hymet_tpu"))
    assert sorted(os.listdir(tmp_path / "hymet_tpu_torch")) == written
    assert "profile_diffs_species.tsv" in written
    for name in written:
        assert filecmp.cmp(tmp_path / "hymet_tpu_torch" / name, tmp_path / "hymet_tpu" / name,
                           shallow=False), name


@pytest.mark.parametrize("platform", [None, "gpu", "cuda"])
def test_eval_without_a_card_is_refused(clean_env, tmp_path, capsys, platform):
    """eval asks for the card even with nothing to remap: here, without
    one, it fails (exit 1) before writing; HYMET_PLATFORM=cpu scores."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    if platform:
        clean_env.setenv("HYMET_PLATFORM", platform)
    prof = os.path.join(GUT, "truth_profile.tsv")
    argv = ["eval", "--pred-profile", prof, "--truth-profile", prof, "--out", str(tmp_path / "e")]
    assert tcli.main(argv) == 1
    assert "CUDA" in capsys.readouterr().err and not (tmp_path / "e").exists()
    clean_env.setenv("HYMET_PLATFORM", "cpu")
    assert tcli.main(argv) == 0 and (tmp_path / "e" / "profile_summary.tsv").exists()


def test_diag_prints_the_jax_line(clean_env, tmp_path, capsys, gut_run):
    argv = ["diag", "--paf", gut_run["paf"], "--taxonomy", gut_run["taxmap"]]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want and "\n[diag] id_map_keys=" in got


def test_dataset_tools_write_the_jax_files(clean_env, tmp_path, capsys):
    """subset, testdataset and cami-subsets through both command lines:
    the same messages and files."""
    mapping = tmp_path / "gsa.tsv"
    rows = [ln.split() for ln in open(os.path.join(GUT, "truth_contigs.tsv"))][1:]
    mapping.write_text("#contig\tgenome\ttaxid\ta\tb\tstart\tend\n" + "".join(
        f"{c}\tg\t{t}\tx\ty\t1\t{1000 + i}\n" for i, (c, t) in enumerate(rows)))
    genomes = tmp_path / "genomes"
    genomes.mkdir()
    for d in sorted(os.listdir(os.path.join(WORLD, "genomes")))[:20]:
        os.symlink(os.path.join(WORLD, "genomes", d), genomes / d)
    for pkg, main in (("j", jcli.main), ("t", tcli.main)):
        out = tmp_path / pkg
        assert main(["subset", os.path.join(GUT, "contigs.fna"), "--output", str(out / "s.fna"),
                     "--max-seqs", "50", "--max-bases", "400000"]) == 0
        assert main(["testdataset", str(genomes), "--out", str(out / "td"), "--seed", "3",
                     "--fraction-genomes", "0.2"]) == 0
        assert main(["cami-subsets", "--fasta", os.path.join(GUT, "contigs.fna"), "--mapping",
                     str(mapping), "--taxonomy-dir", os.path.join(WORLD, "taxonomy"), "--out",
                     str(out / "cs")]) == 0
        msgs = capsys.readouterr().out
        (tmp_path / f"{pkg}.log").write_text(msgs.replace(str(out), "OUT"))
    assert (tmp_path / "t.log").read_text() == (tmp_path / "j.log").read_text()
    assert "built test dataset with 4 genomes" in (tmp_path / "t.log").read_text()
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert len(files) == 1 + 5 + 18
    for name in files:
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name, shallow=False), name


# ----------------------------------------------------------------------
# the experiment harnesses

@pytest.fixture(scope="module")
def harness_cli(world, cli_runs):
    """bench, case and ablation through both command lines on the e2e
    world, with each package's cache of the run above (CACHE_ROOT), the
    world's files from the environment, as a bench user sets them."""
    from test_harness_e2e import _truth_files
    from test_torch_harness_e2e import _ablation_inputs

    tmp, _ = cli_runs
    tmp = tmp / "harness"
    tmp.mkdir()
    truth_contigs, truth_profile = _truth_files(world, tmp)
    (tmp / "m.tsv").write_text(
        "sample_id\tcontigs_fa\ttruth_contigs_tsv\ttruth_profile_tsv\tcompare_profile\n"
        f"e2e\t{world['query']}\t{truth_contigs}\t{truth_profile}\t{truth_profile}\n")
    combined, seqmap = _ablation_inputs(world, tmp)
    mp = pytest.MonkeyPatch()
    for name in ENV_NAMES:
        mp.delenv(name, raising=False)
    for name, value in {"HYMET_PLATFORM": "cpu", "HYMET_NO_COMPILE_CACHE": "1",
                        "SCREEN_CHUNK_BP": str(1 << 15), "ALIGN_BATCH_PAD": str(1 << 13),
                        "CAND_MAX": "100", "SKETCH_DBS": world["db_path"],
                        "GENOME_CATALOG": world["genomes_dir"],
                        "SEQID2TAXID": world["seqid2taxid"], "TAXONOMY_DIR": world["tax_dir"],
                        "INPUT_FASTA": world["query"]}.items():
        mp.setenv(name, value)
    rcs = {}
    try:
        for pkg, main in (("jax", jcli.main), ("torch", tcli.main)):
            out = tmp / pkg
            mp.setenv("CACHE_ROOT", str(tmp.parent / pkg / "cache"))
            rcs[pkg] = [
                main(["bench", "--manifest", str(tmp / "m.tsv"), "--tools", "hymet_tpu",
                      "--out", str(out / "bench"), "--threads", "2"]),
                main(["case", "--manifest", str(tmp / "m.tsv"), "--out", str(out / "case")]),
                main(["ablation", "--sample", "e2e", "--taxa", "562,287", "--levels", "0,1",
                      "--seqmap", seqmap, "--fasta", combined, "--out", str(out / "ablation")])]
    finally:
        mp.undo()
    return tmp, rcs


@pytest.mark.parametrize("what", ["bench", "case", "ablation"])
def test_harness_subcommands_write_the_jax_files(harness_cli, what):
    from test_torch_harness_e2e import _differences

    tmp, rcs = harness_cli
    assert rcs["jax"] == rcs["torch"] == [0, 0, 0]
    assert _differences(str(tmp / "torch" / what), str(tmp / "jax" / what)) == []
    if what == "case":
        compare = (tmp / "torch" / "case" / "e2e" / "hymet_tpu" / "profile_compare.tsv").read_text()
        assert compare.startswith("metric\tvalue\nsymmetric_kl_species\t")


def test_truth_build_zymo_writes_the_jax_files(clean_env, tmp_path, capsys, mini_taxdb):
    """truth build-zymo through both command lines (the taxonomy from
    TAXONOMY_DIR, as the JAX command line reads it); without --seqmap both
    exit 1 (the JAX package falls back to a path that is not there, the
    port asks for the flag)."""
    from test_torch_harness import _zymo_world

    _zymo_world(tmp_path, mini_taxdb)
    clean_env.setenv("TAXONOMY_DIR", str(tmp_path))
    argv = ["truth", "build-zymo", "--contigs", str(tmp_path / "contigs.fna"), "--paf",
            str(tmp_path / "hits.paf")]
    for pkg, main in (("j", jcli.main), ("t", tcli.main)):
        (tmp_path / pkg).mkdir()
        outs = ["--out-contigs", str(tmp_path / pkg / "c.tsv"), "--out-profile",
                str(tmp_path / pkg / "p.tsv")]
        assert main([*argv, "--seqmap", str(tmp_path / "seqmap.tsv"), *outs]) == 0
        assert main([*argv, *outs[:1], str(tmp_path / pkg / "c2.tsv"), *outs[2:]]) == 1
    capsys.readouterr()
    for name in ("c.tsv", "p.tsv"):
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name, shallow=False)
    assert sorted(os.listdir(tmp_path / "t")) == ["c.tsv", "p.tsv"]


@pytest.mark.parametrize("missing", [False, True])
def test_fetch_subcommand_exits_like_jax(clean_env, tmp_path, capsys, missing):
    """fetch on file:// URLs: exit 0 and the copied file when every asset
    arrives, exit 1 when one fails; the same message."""
    (tmp_path / "src.fna").write_text(">a\nACGT\n")
    src = (tmp_path / ("absent.fna" if missing else "src.fna")).as_uri()
    for pkg, main in (("j", jcli.main), ("t", tcli.main)):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "m.tsv").write_text(
            f"sample_id\tcontigs_fa\tcontigs_url\ns1\tin/c.fna\t{src}\n")
        assert main(["fetch", "--manifest", str(tmp_path / pkg / "m.tsv")]) == int(missing)
        out = capsys.readouterr().out.replace(str(tmp_path / pkg), "ROOT")
        (tmp_path / f"{pkg}.log").write_text(out)
    assert (tmp_path / "t.log").read_text() == (tmp_path / "j.log").read_text() == (
        "[hymet-tpu] fetch: manifest=ROOT/m.tsv\n"
        f"[hymet-tpu] fetched/present: {int(not missing)}, failed: {int(missing)}\n")
    assert os.path.exists(tmp_path / "t" / "in" / "c.fna") != missing
    if not missing:
        assert filecmp.cmp(tmp_path / "t" / "in" / "c.fna", tmp_path / "src.fna", shallow=False)


@pytest.mark.parametrize("argv", [["bench", "--tools", "kraken2"], ["case"],
                                  ["ablation", "--taxa", "562", "--seqmap", "SEQMAP",
                                   "--fasta", "FASTA"]])
@pytest.mark.parametrize("platform", [None, "gpu", "cuda"])
def test_harness_without_a_card_is_refused(clean_env, tmp_path, capsys, argv, platform):
    """bench, case and ablation ask for the card before any run or file:
    here, without one, they exit 1 and write nothing; HYMET_PLATFORM=cpu
    runs them (bench with an absent baseline tool, case and ablation
    failing later on what they were given)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    if platform:
        clean_env.setenv("HYMET_PLATFORM", platform)
    (tmp_path / "c.fna").write_text(">c1\nACGT\n")
    (tmp_path / "m.tsv").write_text(f"sample_id\tcontigs_fa\ns1\t{tmp_path / 'c.fna'}\n")
    (tmp_path / "s.tsv").write_text("c1\t562\n")
    argv = [a.replace("SEQMAP", str(tmp_path / "s.tsv")).replace("FASTA", str(tmp_path / "c.fna"))
            for a in argv]
    out = str(tmp_path / "out")
    argv = [*argv, "--out", out] + (["--manifest", str(tmp_path / "m.tsv")]
                                    if argv[0] in ("bench", "case") else [])
    assert tcli.main(argv) == 1
    assert "CUDA" in capsys.readouterr().err and not os.path.exists(out)
    clean_env.setenv("HYMET_PLATFORM", "cpu")
    clean_env.setenv("PATH", str(tmp_path))
    assert tcli.main(argv) == (0 if argv[0] == "bench" else 1) and os.path.exists(out)
