"""hymet_tpu_torch's command line against hymet_tpu's on the CPU: the
``--dry-run`` plan lines of run, legacy, sketch, index, taxonomy and
prune-cache (equal but for the documented ``classifier_backend`` default);
``RunConfig.from_env`` under a patched environment; ``HYMET_PLATFORM=cpu
python -m hymet_tpu_torch sketch`` writing the JAX CLI's ``.npz`` arrays
and ``.msh`` bytes; ``run`` and ``legacy`` on the world of
tests/test_pipeline_e2e.py writing the JAX CLI's stage files byte for
byte; index, taxonomy and prune-cache runs; and the device rule (no CPU
fallback, an unknown platform refused)."""

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
    for argv in ([], ["run"], ["sketch", "--out", "x.npz"], ["bench", "--dry-run"],
                 ["run", "--contigs", "c", "--out", "o", "--backend", "tpu"]):
        with pytest.raises(SystemExit) as t:
            tcli.main(argv)
        assert t.value.code == 2
    capsys.readouterr()


def test_module_entry_point_prints_usage():
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-m", "hymet_tpu_torch", "--help"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    for cmd in ("run", "legacy", "sketch", "index", "taxonomy", "prune-cache"):
        assert cmd in out.stdout
