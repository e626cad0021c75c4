"""hymet_tpu_torch's ClassificationRun.execute against hymet_tpu's, on the
CPU, on the world of tests/test_pipeline_e2e.py (seed 77: 3 genomes x 50
kbp, 7 contigs) with the same RunConfig: every stage file byte for byte,
the cached reference too; the reference cache and the resident aligner on
a second run; the first-hit fallback for a data error and not for a
kernel or CUDA error; the max_secondary check; the legacy classifier's
run; the length-weighted profile (HYMET_PROFILE_WEIGHT=length); the
sharded run at db_shards=4 over 8 devices, and db_shards=2 on one device;
what the port refuses."""

import dataclasses
import filecmp
import json
import os

import pytest
import torch

from hymet_tpu.pipeline.run import ClassificationRun as JRun
from hymet_tpu_torch.ops import lca
from hymet_tpu_torch.ops.hash_kernels import KernelError
from hymet_tpu_torch.pipeline import run as trun_mod
from hymet_tpu_torch.pipeline.run import ClassificationRun as TRun
from hymet_tpu_torch.utils.config import RunConfig as TConfig
from test_pipeline_e2e import _config, world  # noqa: F401 — the same world and RunConfig

torch.set_num_threads(1)


def _tcfg(world, outdir, cache):
    cfg = TConfig(**dataclasses.asdict(_config(world, outdir)))
    cfg.cache_root = str(cache)
    return cfg


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runs")
    jcfg = _config(world, tmp / "jax")
    jcfg.cache_root = str(tmp / "jcache")
    jrun = JRun(jcfg)
    jrun.execute()
    trun = TRun(_tcfg(world, tmp / "torch", tmp / "tcache"), device="cpu")
    trun.execute()
    return jrun, trun


def _cache_dir(cfg) -> str:
    (key,) = os.listdir(cfg.cache_root)
    return os.path.join(cfg.cache_root, key)


@pytest.mark.parametrize("name", ["work/selected_genomes.txt", "work/resultados.paf",
                                  "classified_sequences.tsv", "hymet.sample.cami.tsv"])
def test_outputs_byte_identical(runs, name):
    jrun, trun = runs
    got, want = os.path.join(trun.cfg.outdir, name), os.path.join(jrun.cfg.outdir, name)
    assert os.path.getsize(want) > 0
    assert filecmp.cmp(got, want, shallow=False)


@pytest.mark.parametrize("name", ["combined_genomes.fasta", "detailed_taxonomy.tsv"])
def test_cached_reference_byte_identical(runs, name):
    jrun, trun = runs
    assert os.path.basename(_cache_dir(trun.cfg)) == os.path.basename(_cache_dir(jrun.cfg))
    assert filecmp.cmp(os.path.join(_cache_dir(trun.cfg), name),
                       os.path.join(_cache_dir(jrun.cfg), name), shallow=False)


def test_metadata_and_classification(runs):
    jrun, trun = runs
    with open(os.path.join(trun.cfg.outdir, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(jrun.cfg.outdir, "metadata.json")) as f:
        jmeta = json.load(f)
    assert meta["tool"] == "hymet_tpu_torch" and meta["device"] == "cpu"
    assert set(meta["timings_sec"]) == set(jmeta["timings_sec"])
    assert set(meta["timings_sec"]) == {"upload", "screen", "limit", "reference", "align",
                                        "classify", "export"}
    assert meta["first_hit_fallback"] is False and not trun.fallback_ran
    with open(os.path.join(trun.cfg.outdir, "classified_sequences.tsv"), newline="") as f:
        rows = f.read().split("\r\n")
    assert len(rows) > 6 and all("unknown" not in r for r in rows)


def test_second_run_hits_the_caches(world, runs, tmp_path, monkeypatch):
    """A second run on the same cache: no reference stage, the aligner
    resident from the first run (no new MinimizerAligner), the same bytes."""
    _jrun, first = runs
    built = []
    real = trun_mod.MinimizerAligner
    monkeypatch.setattr(trun_mod, "MinimizerAligner", lambda *a, **k: built.append(1) or real(*a, **k))
    cfg = _tcfg(world, tmp_path / "again", first.cfg.cache_root)
    run = TRun(cfg, device="cpu")
    run.execute()
    assert "reference" not in run.timings and "align" in run.timings
    for name in ("work/resultados.paf", "classified_sequences.tsv", "hymet.sample.cami.tsv"):
        assert filecmp.cmp(os.path.join(cfg.outdir, name), os.path.join(first.cfg.outdir, name),
                           shallow=False)
    assert built == []
    monkeypatch.setenv("HYMET_RESIDENT_INDEX", "0")
    run = TRun(_tcfg(world, tmp_path / "cold", first.cfg.cache_root), device="cpu")
    run.execute()
    assert built == [1]


def _classify_with(run, runs_dir, tax_dir):
    run.cfg.taxonomy_dir = str(tax_dir)
    os.makedirs(run.workdir, exist_ok=True)
    cache = _cache_dir(run.cfg)
    return run._stage_classify(os.path.join(runs_dir, "work", "resultados.paf"),
                               os.path.join(cache, "detailed_taxonomy.tsv"))


def test_first_hit_fallback_on_a_data_error(world, runs, tmp_path):
    """A hierarchy without a Lineage column fails the weighted LCA (a data
    error): both packages fall back to first-hit and write the same bytes."""
    jrun, trun = runs
    bad = tmp_path / "tax"
    bad.mkdir()
    (bad / "taxonomy_hierarchy.tsv").write_text("TaxID\tName\n1\troot\n")
    jcfg = _config(world, tmp_path / "jax")
    jcfg.cache_root = jrun.cfg.cache_root
    jout = _classify_with(JRun(jcfg), jrun.cfg.outdir, bad)
    run = TRun(_tcfg(world, tmp_path / "torch", trun.cfg.cache_root), device="cpu")
    out = _classify_with(run, trun.cfg.outdir, bad)
    assert run.fallback_ran and "classify" in run.timings
    assert filecmp.cmp(out, jout, shallow=False)
    with open(out) as f:
        lines = f.read().splitlines()
    assert len(lines) >= 2 and lines[1].endswith("\tunknown\tunknown\t1.0000")


def test_empty_paf_still_empty_after_fallback(world, runs, tmp_path):
    _jrun, trun = runs
    run = TRun(_tcfg(world, tmp_path / "torch", trun.cfg.cache_root), device="cpu")
    os.makedirs(os.path.join(run.workdir), exist_ok=True)
    paf = tmp_path / "empty.paf"
    paf.write_text("")
    with pytest.raises(RuntimeError, match="still empty"):
        run._stage_classify(str(paf), os.path.join(_cache_dir(run.cfg), "detailed_taxonomy.tsv"))
    assert run.fallback_ran


@pytest.mark.parametrize("error", [KernelError("lca launch failed with CUDA error 700"),
                                   RuntimeError("CUDA error: an illegal memory access")])
def test_kernel_error_is_not_swallowed(world, runs, tmp_path, monkeypatch, error):
    """A failing LCA launch (the wrapper's device check sent to the kernel
    path, its launch made to raise) propagates out of the classify stage;
    the first-hit fallback does not run."""
    _jrun, trun = runs

    def launch(*args):
        raise error

    monkeypatch.setattr(lca, "_check_device", lambda *a: "cuda")
    monkeypatch.setattr(lca, "_launch", launch)
    run = TRun(_tcfg(world, tmp_path / "torch", trun.cfg.cache_root), device="cpu")
    with pytest.raises(type(error), match="CUDA error"):
        _classify_with(run, trun.cfg.outdir, trun.cfg.taxonomy_dir)
    assert not run.fallback_ran


def test_kernel_build_failure_is_not_swallowed(world, runs, tmp_path, monkeypatch):
    """A kernel library that does not build (an nvcc that fails) raises
    KernelError from the LCA's launch, out of the classify stage; the
    first-hit fallback does not run."""
    from hymet_tpu_torch.ops import hash_kernels

    _jrun, trun = runs
    monkeypatch.setattr(hash_kernels, "_LIBRARY", None)
    monkeypatch.setattr(hash_kernels, "_build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(hash_kernels, "_nvcc", lambda: "false")  # exits 1
    monkeypatch.setattr(lca, "_check_device", lambda *a: "cuda")
    monkeypatch.setattr(lca, "_launch", lambda name, dev, *args: hash_kernels.load_library())
    run = TRun(_tcfg(world, tmp_path / "torch", trun.cfg.cache_root), device="cpu")
    with pytest.raises(KernelError, match="nvcc failed"):
        _classify_with(run, trun.cfg.outdir, trun.cfg.taxonomy_dir)
    assert not run.fallback_ran and not (tmp_path / "build" / "libhymet_kernels.so").exists()


def test_max_secondary_above_the_lca_ceiling_is_refused(world, runs, tmp_path, monkeypatch):
    _jrun, trun = runs
    monkeypatch.setattr(trun_mod, "LCA_MAX_BUCKET", 50)  # below max_secondary + 1 = 51
    run = TRun(_tcfg(world, tmp_path / "torch", trun.cfg.cache_root), device="cpu")
    with pytest.raises(ValueError, match="max_secondary=50"):
        run._stage_align(os.path.join(_cache_dir(run.cfg), "combined_genomes.fasta"))


@pytest.mark.parametrize("field,value", [("classifier_backend", "nope")])
def test_unported_options_raise(field, value):
    cfg = TConfig(**{field: value})
    with pytest.raises(ValueError):
        TRun(cfg, device="cpu")


@pytest.fixture(scope="module")
def sharded_runs(world, tmp_path_factory):
    """Both packages' execute at db_shards=4 over 8 devices (a 2x4 mesh):
    JAX's 8 virtual CPU devices, the port's CPU named eight times."""
    tmp = tmp_path_factory.mktemp("sharded")
    jcfg = _config(world, tmp / "jax")
    jcfg.cache_root, jcfg.db_shards = str(tmp / "jcache"), 4
    jrun = JRun(jcfg)
    jrun.execute()
    tcfg = _tcfg(world, tmp / "torch", tmp / "tcache")
    tcfg.db_shards = 4
    trun = TRun(tcfg, device="cpu", mesh_devices=["cpu"] * 8)
    trun.execute()
    return jrun, trun


@pytest.mark.parametrize("name", ["work/selected_genomes.txt", "work/resultados.paf",
                                  "classified_sequences.tsv", "hymet.sample.cami.tsv"])
def test_sharded_outputs_byte_identical(sharded_runs, name):
    jrun, trun = sharded_runs
    assert trun.mesh.shape == {"data": 2, "db": 4}
    got, want = os.path.join(trun.cfg.outdir, name), os.path.join(jrun.cfg.outdir, name)
    assert os.path.getsize(want) > 0
    assert filecmp.cmp(got, want, shallow=False)


def test_sharded_run_stages(sharded_runs):
    """The sharded run stages no upload (as JAX's) and goes through the
    sharded screen and aligner."""
    jrun, trun = sharded_runs
    assert set(trun.timings) == set(jrun.timings) == {"screen", "limit", "reference", "align",
                                                      "classify", "export"}
    assert trun._staged is None and not trun.fallback_ran


def test_db_shards_without_enough_devices_runs_single_device(world, runs, tmp_path, caplog):
    """db_shards=2 on one CPU device (the default mesh devices of a CPU
    run): the JAX warning, no mesh, and the single-device run's files."""
    _jrun, trun = runs
    cfg = _tcfg(world, tmp_path / "torch", tmp_path / "tcache")
    cfg.db_shards = 2
    with caplog.at_level("WARNING", logger="hymet_tpu_torch.run"):
        run = TRun(cfg, device="cpu")
    assert run.mesh is None
    assert "db_shards=2 but only 1 devices; running single-device" in caplog.text
    run.execute()
    for name in ("work/selected_genomes.txt", "work/resultados.paf", "classified_sequences.tsv",
                 "hymet.sample.cami.tsv"):
        assert filecmp.cmp(os.path.join(cfg.outdir, name), os.path.join(trun.cfg.outdir, name),
                           shallow=False), name


def test_legacy_run_matches_jax(world, runs, tmp_path):
    """classifier_backend="legacy" (classification.py's classifier): both
    packages' whole runs, on the caches of the first runs, write the same
    stage files, and the classification is the legacy one."""
    jrun, trun = runs
    jcfg = _config(world, tmp_path / "jax")
    jcfg.cache_root, jcfg.classifier_backend = jrun.cfg.cache_root, "legacy"
    JRun(jcfg).execute()
    tcfg = _tcfg(world, tmp_path / "torch", trun.cfg.cache_root)
    tcfg.classifier_backend = "legacy"
    run = TRun(tcfg, device="cpu")
    run.execute()
    assert not run.fallback_ran and "reference" not in run.timings
    for name in ("work/selected_genomes.txt", "work/resultados.paf", "classified_sequences.tsv",
                 "hymet.sample.cami.tsv"):
        assert filecmp.cmp(os.path.join(tcfg.outdir, name), os.path.join(jcfg.outdir, name),
                           shallow=False), name
    assert not filecmp.cmp(os.path.join(tcfg.outdir, "classified_sequences.tsv"),
                           os.path.join(trun.cfg.outdir, "classified_sequences.tsv"), shallow=False)


def test_length_weighted_profile_matches_jax(world, tmp_path, monkeypatch):
    """HYMET_PROFILE_WEIGHT=length (CAMI abundance weighting): both
    packages' whole runs on the world's contigs cut to 8000 .. 3000 bp
    write the same classification and profile bytes, and the profile is not
    the contig-count one of the same classification."""
    from hymet_tpu_torch.evalx.cami import classified_to_cami
    from hymet_tpu_torch.io.fasta import read_fasta
    from hymet_tpu_torch.taxonomy.db import TaxonomyDB

    names, seqs = read_fasta(world["query"])
    sample = tmp_path / "sample.fna"
    sample.write_text("".join(f">{n}\n{q[:8000 - 1000 * i].decode()}\n"
                              for i, (n, q) in enumerate(zip(names, seqs))))
    monkeypatch.setenv("HYMET_PROFILE_WEIGHT", "length")
    jcfg = _config(world, tmp_path / "jax")
    jcfg.input_fasta, jcfg.cache_root = str(sample), str(tmp_path / "jcache")
    JRun(jcfg).execute()
    tcfg = _tcfg(world, tmp_path / "torch", tmp_path / "tcache")
    tcfg.input_fasta = str(sample)
    TRun(tcfg, device="cpu").execute()
    for name in ("classified_sequences.tsv", "hymet.sample.cami.tsv"):
        assert filecmp.cmp(os.path.join(tcfg.outdir, name), os.path.join(jcfg.outdir, name),
                           shallow=False), name
    counted = tmp_path / "counted.cami.tsv"
    taxdb = TaxonomyDB.from_hierarchy_tsv(os.path.join(world["tax_dir"], "taxonomy_hierarchy.tsv"))
    assert classified_to_cami(os.path.join(tcfg.outdir, "classified_sequences.tsv"), taxdb,
                              str(counted), "sample") == 6
    assert counted.read_text() != open(os.path.join(tcfg.outdir, "hymet.sample.cami.tsv")).read()


def test_jax_backend_name_is_the_device_backend(world, runs, tmp_path):
    """classifier_backend="jax" (a reference config) and "host" classify
    the run's PAF to the bytes of the default device backend."""
    _jrun, trun = runs
    want = os.path.join(trun.cfg.outdir, "classified_sequences.tsv")
    for backend in ("jax", "host"):
        run = TRun(_tcfg(world, tmp_path / backend, trun.cfg.cache_root), device="cpu")
        run.cfg.classifier_backend = backend
        out = _classify_with(run, trun.cfg.outdir, trun.cfg.taxonomy_dir)
        assert filecmp.cmp(out, want, shallow=False)


def test_preset_reference_run_matches_jax(world, tmp_path):
    """With a preset combined FASTA (reference_fasta) there is no screen
    or limit; both packages write the same reference cache, PAF,
    classification and profile."""
    import gzip

    combined = tmp_path / "preset.fna"
    with open(combined, "w") as out:
        for fn in sorted(os.listdir(world["genomes_dir"])):
            with gzip.open(os.path.join(world["genomes_dir"], fn), "rt") as g:
                out.write(g.read())
    s2t = tmp_path / "seqid2taxid.tsv"
    s2t.write_text("bsub_chr\t1423\necoli_chr\t562\n")  # paer_chr: Unknown TaxID
    outs = []
    for pkg in ("jax", "torch"):
        jcfg = _config(world, tmp_path / pkg)
        jcfg.cache_root, jcfg.reference_fasta, jcfg.seqid2taxid = (
            str(tmp_path / f"{pkg}_cache"), str(combined), str(s2t))
        run = JRun(jcfg) if pkg == "jax" else TRun(TConfig(**dataclasses.asdict(jcfg)), device="cpu")
        run.execute()
        assert set(run.timings) == {"upload", "reference", "align", "classify", "export"}
        outs.append(run.cfg)
    for name in ("work/resultados.paf", "classified_sequences.tsv", "hymet.sample.cami.tsv"):
        assert filecmp.cmp(*(os.path.join(c.outdir, name) for c in outs), shallow=False), name
    for name in ("combined_genomes.fasta", "detailed_taxonomy.tsv"):
        assert filecmp.cmp(*(os.path.join(_cache_dir(c), name) for c in outs), shallow=False), name
    with open(os.path.join(outs[1].outdir, "classified_sequences.tsv")) as f:
        text = f.read()
    assert "Escherichia coli" in text and "Bacillus subtilis" in text
