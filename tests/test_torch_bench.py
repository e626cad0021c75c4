"""The port's bench (``python -m hymet_tpu_torch.bench``) on the CPU
(``HYMET_PLATFORM=cpu``), on a 4-genome synthetic stand-in for the Zymo
panel (``chip_smoke.synthetic_panel``) at tiny ``BENCH_*`` sizes: the
pipeline world's files byte for byte and its DBs array for array against
the JAX ``bench._build_world``; each of the seven modes returning its
metric; the aligner's ``_chains_for_batch`` against the JAX aligner's; a
child process printing exactly one JSON line; and, without a card and
without ``HYMET_PLATFORM=cpu``, a non-zero exit."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp  # noqa: F401 — JAX on the CPU before the JAX bench imports it
import numpy as np
import pytest
import torch

import bench as jbench
import chip_smoke
from hymet_tpu.io.minimizer_index import MinimizerIndex as JIndex
from hymet_tpu.models.aligner import MinimizerAligner as JAligner
from hymet_tpu_torch import bench
from hymet_tpu_torch.harness import deadline
from hymet_tpu_torch.io.minimizer_index import MinimizerIndex as TIndex
from hymet_tpu_torch.models.aligner import MinimizerAligner as TAligner

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMALL_ENV = {"BENCH_REFS": "4", "BENCH_REF_LEN": "20000", "BENCH_BATCH_ROWS": "2",
             "BENCH_BATCH_LEN": "8192"}


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    return chip_smoke.synthetic_panel(str(tmp_path_factory.mktemp("panel")), seed=11,
                                      n_genomes=4, lengths=(40_000, 80_000))


@pytest.fixture
def small(monkeypatch, panel, tmp_path):
    """The port bench's module constants cut to a CPU test's size, its
    cache under the test's temporary directory."""
    glob_, refs = panel
    for name, value in (("GENOME_GLOB", glob_), ("REFS_TSV", refs),
                        ("CACHE", str(tmp_path / "cache")), ("N_CONTIGS", 20),
                        ("N_REFS", 4), ("REF_LEN", 20_000), ("BATCH_ROWS", 2),
                        ("BATCH_LEN", 8192), ("LARGE_F_REFS", 50), ("LARGE_F_SKETCH", 100),
                        ("ALIGN_ROWS", 4), ("ALIGN_PAD", 4096)):
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setenv("BENCH_ALIGN_ROWS", "4")
    monkeypatch.setenv("BENCH_ALIGN_PAD", "4096")
    return tmp_path


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_build_world_matches_jax(small, monkeypatch):
    for name in ("GENOME_GLOB", "REFS_TSV", "N_CONTIGS", "N_GENOMES", "SEED"):
        monkeypatch.setattr(jbench, name, getattr(bench, name))
    monkeypatch.setattr(jbench, "CACHE", str(small / "jax_cache"))
    want = jbench._build_world()
    got = bench._build_world(CPU)
    for key in ("n_contigs", "total_bp", "genome_dir"):
        assert got[key] == want[key]
    assert got["n_contigs"] >= 20
    for key in ("sample", "truth", "seqid2taxid"):
        assert _read(got[key]) == _read(want[key]), key
    hier = "taxonomy_hierarchy.tsv"
    assert _read(os.path.join(got["tax_dir"], hier)) == _read(os.path.join(want["tax_dir"], hier))
    assert (os.path.relpath(got["world"], bench.CACHE)
            == os.path.relpath(want["world"], jbench.CACHE))
    for g, w in zip(got["sketch_dbs"], want["sketch_dbs"]):
        with np.load(g, allow_pickle=True) as a, np.load(w, allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])


def test_build_world_needs_the_panel(small, monkeypatch):
    monkeypatch.setattr(bench, "GENOME_GLOB", str(small / "none" / "*.fna.gz"))
    with pytest.raises(SystemExit, match="reference Zymo genomes not found"):
        bench._build_world(CPU)
    with pytest.raises(SystemExit, match="reference Zymo genomes not found"):
        bench._align_world(CPU)


@pytest.mark.parametrize("mode", sorted(deadline.SKELETONS))
def test_mode_returns_its_metric(small, mode):
    result = bench.MODES[mode](CPU)
    assert result["metric"] == deadline.SKELETONS[mode][0]
    assert result["value"] > 0
    assert set(result) >= {"metric", "value", "unit", "vs_baseline"}
    json.dumps(result)


def test_chains_for_batch_matches_jax(panel):
    """The align mode's call, ``_chains_for_batch`` on a host code batch,
    gives the JAX aligner's chains."""
    import glob

    from hymet_tpu_torch.io.fasta import encode_seq, iter_fasta

    named = [(n.split()[0], s) for g in sorted(glob.glob(panel[0])) for n, s in iter_fasta(g)]
    rng = np.random.default_rng(5)
    src = named[0][1]
    batch = np.full((4, 4096), 4, np.uint8)
    for i in range(3):  # row 3 stays padding
        st = int(rng.integers(0, len(src) - 4096))
        frag = encode_seq(src[st : st + 4096]).copy()
        mut = rng.random(frag.size) < 0.02
        frag[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.uint8)
        batch[i, : 4096 - 300 * i] = frag[: 4096 - 300 * i]
    want = JAligner(JIndex.build(named))._chains_for_batch(batch)
    got = TAligner(TIndex.build(named, device="cpu"), device="cpu")._chains_for_batch(batch)
    assert len(got) >= 3
    assert [dataclasses.astuple(c) for c in got] == [dataclasses.astuple(c) for c in want]


def _child(env: dict, tmp_path):
    env = {**{k: v for k, v in os.environ.items()
              if not k.startswith(("_BENCH_", "HYMET_PLATFORM", "BENCH_"))},
           "PYTHONPATH": REPO, "BENCH_DEADLINE_S": "600", **env}
    return subprocess.run([sys.executable, "-m", "hymet_tpu_torch.bench"], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)


def test_child_prints_exactly_one_json_line(tmp_path):
    proc = _child({"HYMET_PLATFORM": "cpu", "BENCH_MODE": "sketch", **SMALL_ENV}, tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert line["metric"] == "sketch_query_Gbp_per_s" and line["value"] > 0
    assert "degraded" not in line
    assert "[bench] device: cpu" in proc.stderr


def test_child_without_a_card_exits_nonzero(tmp_path):
    """No HYMET_PLATFORM and no card: the device cannot be resolved, so the
    bench takes its crash path (one degraded line, exit 1); there is no CPU
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the bench would run on it")
    proc = _child({"BENCH_MODE": "sketch", **SMALL_ENV}, tmp_path)
    assert proc.returncode == 1
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert line["metric"] == "sketch_query_Gbp_per_s" and line["value"] == 0.0
    assert line["degraded"] == "error:RuntimeError"
    assert "torch.cuda.is_available() is False" in proc.stderr
