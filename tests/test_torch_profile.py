"""HYMET_PROFILE's per-stage traces and the last public pieces of the port,
against hymet_tpu on the CPU.

Both packages' ClassificationRun.execute run on the world of
tests/test_pipeline_e2e.py (seed 77: 3 genomes x 50 kbp, 7 contigs) under
HYMET_PROFILE=1: the same stage directories under logs/profile/, each of
the port's holding one gzipped Chrome trace at
<stage>/plugins/profile/<timestamp>/<host>.trace.json.gz; the port's
outputs equal to a run without the flag, byte for byte; an explicit root;
nothing written with the flag unset; a profiler that cannot write raises;
a stage's seconds without the trace's lead (a lead forced on the CPU,
stubbed to sleep 0.3 s, inside the trace before the stage's span).
Then hymet_tpu_torch.io's re-exports, io.fasta's pack_2bit and
revcomp_codes, screen_stage.screen_queries (device "cpu") against the JAX
functions on seeded input, and bin/hymet-tpu-torch."""

import dataclasses
import filecmp
import glob
import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import hymet_tpu.io as jio
import hymet_tpu_torch.io as tio
from hymet_tpu.io.fasta import pack_2bit as jpack_2bit, revcomp_codes as jrevcomp_codes
from hymet_tpu.io.sketchdb import build_sketch_db_from_sequences
from hymet_tpu.pipeline.run import ClassificationRun as JRun
from hymet_tpu.pipeline.screen_stage import screen_queries as jscreen_queries
from hymet_tpu_torch.io.fasta import encode_seq, pack_2bit, revcomp_codes
from hymet_tpu_torch.io.sketchdb import load_sketch_db
from hymet_tpu_torch.pipeline import run as trun_mod
from hymet_tpu_torch.pipeline.run import ClassificationRun as TRun
from hymet_tpu_torch.pipeline.screen_stage import screen_queries
from hymet_tpu_torch.utils.config import RunConfig as TConfig
from test_pipeline_e2e import _config, world  # noqa: F401 — the same world and RunConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("upload", "screen", "limit", "reference", "align", "classify", "export")
TRACE_GLOB = os.path.join("*", "plugins", "profile", "*", "*.trace.json.gz")


def _tcfg(world, outdir, cache):
    cfg = TConfig(**dataclasses.asdict(_config(world, outdir)))
    cfg.cache_root = str(cache)
    return cfg


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """outdir of: the JAX run and the port's under HYMET_PROFILE=1, the
    port's without it, and the port's under an explicit root (with that
    root); each with a cache of its own, so every stage runs."""
    tmp = tmp_path_factory.mktemp("profile")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYMET_PROFILE", "1")
        jcfg = _config(world, tmp / "jax")
        jcfg.cache_root = str(tmp / "jcache")
        JRun(jcfg).execute()
        out["jax"] = tmp / "jax"
        TRun(_tcfg(world, tmp / "torch", tmp / "tcache"), device="cpu").execute()
        out["torch"] = tmp / "torch"
        mp.setenv("HYMET_PROFILE", str(tmp / "root"))
        TRun(_tcfg(world, tmp / "explicit", tmp / "ecache"), device="cpu").execute()
        out["explicit"], out["root"] = tmp / "explicit", tmp / "root"
        mp.delenv("HYMET_PROFILE")
        TRun(_tcfg(world, tmp / "plain", tmp / "pcache"), device="cpu").execute()
        out["plain"] = tmp / "plain"
    return out


def _stage_dirs(root) -> set:
    return {p.name for p in root.iterdir() if p.is_dir()}


def test_stage_directories_match_the_jax_run(runs):
    want = _stage_dirs(runs["jax"] / "logs" / "profile")
    assert want == set(STAGES)
    assert _stage_dirs(runs["torch"] / "logs" / "profile") == want


@pytest.mark.parametrize("stage", STAGES)
def test_each_stage_writes_one_chrome_trace(runs, stage):
    root = runs["torch"] / "logs" / "profile"
    (path,) = glob.glob(str(root / stage / "plugins" / "profile" / "*" / "*.trace.json.gz"))
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    assert events
    assert any(e.get("name") == f"stage {stage}" for e in events)
    assert os.path.basename(path).endswith(".trace.json.gz")


def _outputs(outdir) -> list:
    """Every file of a run but its logs and metadata.json (which holds
    the measured seconds), relative to `outdir`."""
    return sorted(os.path.relpath(p, outdir) for p in glob.glob(str(outdir / "**"), recursive=True)
                  if os.path.isfile(p) and not os.path.relpath(p, outdir).startswith("logs")
                  and os.path.basename(p) != "metadata.json")


@pytest.mark.parametrize("run", ["torch", "explicit"])
def test_outputs_byte_identical_without_the_flag(runs, run):
    names = _outputs(runs["plain"])
    assert "classified_sequences.tsv" in names and "work/resultados.paf" in names
    assert _outputs(runs[run]) == names
    for name in names:
        assert filecmp.cmp(runs[run] / name, runs["plain"] / name, shallow=False), name
    with open(runs[run] / "metadata.json") as f:
        assert set(json.load(f)["timings_sec"]) == set(STAGES)


def test_explicit_root_is_honoured(runs):
    assert _stage_dirs(runs["root"]) == set(STAGES)
    assert len(glob.glob(str(runs["root"] / TRACE_GLOB))) == len(STAGES)
    assert not (runs["explicit"] / "logs" / "profile").exists()


def test_unset_flag_writes_no_trace(runs):
    assert (runs["plain"] / "logs").is_dir()
    assert not (runs["plain"] / "logs" / "profile").exists()


@pytest.mark.parametrize("flag", [None, ""])
def test_no_profiler_without_the_flag(tmp_path, monkeypatch, flag):
    """Unset or empty: the stage runs without a profiler object."""
    if flag is None:
        monkeypatch.delenv("HYMET_PROFILE", raising=False)
    else:
        monkeypatch.setenv("HYMET_PROFILE", flag)
    monkeypatch.setattr(torch.profiler, "profile", None)
    run = TRun(TConfig(outdir=str(tmp_path / "out")), device="cpu")
    assert run._timed("screen", lambda: 7) == 7
    assert set(run.timings) == {"screen"}
    assert not (tmp_path / "out").exists()


def test_process_index_in_the_trace_name(tmp_path, monkeypatch):
    """In a group of processes, every process writes its own file under a
    shared root."""
    monkeypatch.setenv("HYMET_PROFILE", str(tmp_path / "root"))
    run = TRun(TConfig(outdir=str(tmp_path / "out")), device="cpu")
    run._multihost = True
    monkeypatch.setattr(trun_mod, "process_index", lambda: 3)
    assert run._timed("align", lambda: torch.ones(4).sum().item()) == 4.0
    (path,) = glob.glob(str(tmp_path / "root" / TRACE_GLOB))
    assert os.path.basename(path).endswith(".proc3.trace.json.gz")
    assert path.startswith(str(tmp_path / "root" / "align" / "plugins" / "profile"))


def test_a_trace_that_cannot_be_written_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("HYMET_PROFILE", str(tmp_path / "root"))

    def refuse(self, path):
        raise OSError(f"cannot write {path}")

    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", refuse)
    run = TRun(TConfig(outdir=str(tmp_path / "out")), device="cpu")
    with pytest.raises(OSError, match="cannot write"):
        run._timed("export", lambda: None)
    assert "export" not in run.timings


LEAD_S = 0.3  # the stub's sleep


@pytest.fixture(scope="module")
def leads(world, runs, tmp_path_factory):
    """Two more profiled runs after `runs` (so both are warm), each with a
    cache of its own: one as the CPU takes it, without a lead, then one
    with the lead forced and stubbed to sleep LEAD_S inside a
    ``profile lead`` span; each run's timings and outdir, and the stub's
    calls with whether the profiler was on."""
    tmp = tmp_path_factory.mktemp("leads")
    calls, out = [], {}

    def stub(device):
        with torch.profiler.record_function("profile lead"):
            calls.append(torch.autograd.profiler._is_profiler_enabled)
            time.sleep(LEAD_S)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYMET_PROFILE", "1")
        for name in ("none", "lead"):
            if name == "lead":
                mp.setattr(TRun, "_takes_lead", lambda self: True)
                mp.setattr(trun_mod, "profile_lead", stub)
            run = TRun(_tcfg(world, tmp / name, tmp / f"{name}_cache"), device="cpu")
            run.execute()
            out[name] = (run, tmp / name)
    return out, calls


@pytest.mark.parametrize("stage", STAGES)
def test_stage_seconds_leave_the_lead_out(leads, stage):
    """A stage's timings value and metadata.json's timings_sec stay within
    0.2 s of the same stage's without a lead: the 0.3 s lead is not in
    them (it is in lead_s)."""
    (none, none_dir), (lead, lead_dir) = leads[0]["none"], leads[0]["lead"]
    assert none.lead_s == {}
    assert LEAD_S <= lead.lead_s[stage] < LEAD_S + 0.2
    assert lead.timings[stage] < none.timings[stage] + 0.2
    with open(none_dir / "metadata.json") as f:
        want = json.load(f)["timings_sec"][stage]
    with open(lead_dir / "metadata.json") as f:
        assert json.load(f)["timings_sec"][stage] < want + 0.2


def test_the_lead_runs_once_a_stage_inside_its_trace(leads):
    """The stub ran once a stage with the profiler on, and each stage's
    trace holds its ``profile lead`` span, ended before ``stage <name>``
    begins."""
    (_run, lead_dir), calls = leads[0]["lead"], leads[1]
    assert len(calls) == len(STAGES) and all(calls)
    for stage in STAGES:
        (path,) = glob.glob(str(lead_dir / "logs" / "profile" / stage / "plugins" / "profile"
                                / "*" / "*.trace.json.gz"))
        with gzip.open(path, "rt") as f:
            spans = {e["name"]: e for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
        lead, body = spans["profile lead"], spans[f"stage {stage}"]
        assert lead["dur"] >= LEAD_S * 1e6 * 0.99
        assert lead["ts"] + lead["dur"] <= body["ts"]


# ---------------------------------------------------------------------
# the public pieces


def test_io_reexports_the_jax_package_names():
    assert tio.__all__ == jio.__all__
    for name in tio.__all__:
        obj = getattr(tio, name)
        assert obj.__module__.startswith("hymet_tpu_torch.io."), (name, obj.__module__)
        assert obj.__name__ == getattr(jio, name).__name__


def _seq(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"ACGTacgtNnRY-", dtype=np.uint8), size=n).tobytes()


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 17), (3, 1000), (4, 65_537)])
def test_pack_2bit_matches_jax(seed, n):
    seq = _seq(seed, n)
    got, want = pack_2bit(seq), jpack_2bit(seq)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,n", [(5, 0), (6, 1), (7, 31), (8, 4096)])
def test_revcomp_codes_matches_jax(seed, n):
    codes = encode_seq(_seq(seed, n))
    got, want = revcomp_codes(codes), jrevcomp_codes(codes)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(revcomp_codes(got), codes)


def _rand_seq(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n).tobytes()


@pytest.fixture(scope="module")
def screen_world(tmp_path_factory):
    """Five 7 kbp genomes in a JAX sketch DB (k = 21, s = 150) saved as
    .npz, and a query file of two of them, one mutated, one cut."""
    tmp = tmp_path_factory.mktemp("screen_queries")
    rng = np.random.default_rng(17)
    genomes = {f"g{i}": _rand_seq(rng, 7000) for i in range(5)}
    jdb = build_sketch_db_from_sequences(list(genomes.items()), k=21, sketch_size=150)
    path = tmp / "db.npz"
    jdb.save(str(path))
    g3 = bytearray(genomes["g3"])
    for i in rng.choice(len(g3), size=200, replace=False):
        g3[i] = ord("ACGT"[rng.integers(4)])
    q = tmp / "q.fna"
    q.write_text(">c2\n" + genomes["g2"].decode() + "\n>c3\n" + g3.decode() + "\n"
                 + ">c4\n" + genomes["g4"][1000:4000].decode() + "\n")
    return jdb, load_sketch_db(str(path)), str(q)


@pytest.mark.parametrize("chunk_bp,pvalue_max", [(1 << 20, 0.9), (2048, 0.9), (1 << 20, 1.0)])
def test_screen_queries_matches_jax(screen_world, chunk_bp, pvalue_max):
    jdb, tdb, q = screen_world
    want = jscreen_queries(jdb, [q], chunk_bp=chunk_bp, pvalue_max=pvalue_max)
    got = screen_queries(tdb, [q], chunk_bp=chunk_bp, pvalue_max=pvalue_max, device="cpu")
    assert want
    assert got == want


def test_launcher_help(tmp_path):
    """bin/hymet-tpu-torch from another directory: the port's CLI."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, os.path.join(REPO, "bin", "hymet-tpu-torch"), "--help"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "run" in out.stdout and "legacy" in out.stdout and "PyTorch" in out.stdout
