"""hymet_tpu_torch screen stage + candidate limit vs the JAX package on the
in-repo synthetic CAMI world (sketch1-3 and the first 50 camisyn_gut
contigs): every output file byte-identical, staged and chunked."""

import filecmp
import os

import numpy as np
import pytest
import torch

from hymet_tpu.io.fasta import read_fasta
from hymet_tpu.io.sketchdb import SketchDB as JDB
from hymet_tpu.pipeline import candidates as jcand
from hymet_tpu.pipeline import screen_stage as jstage
from hymet_tpu_torch.io.sketchdb import load_sketch_db
from hymet_tpu_torch.pipeline import candidates as tcand
from hymet_tpu_torch.pipeline import screen_stage as tstage
from hymet_tpu_torch.pipeline.staged import StagedContigs

torch.set_num_threads(1)

WORLD = os.path.join(os.path.dirname(__file__), "..", "validation", "work_cami_suite")
LABELS = ["sketch1", "sketch2", "sketch3"]
N_CONTIGS = 50
CHUNK_BP = 1 << 14  # small chunks keep the CPU run short; the files do not depend on it
BATCH_PAD = 1 << 14
CAND_MAX = 12  # below the screen's selection, so the limit really cuts


def _limit(workdir: str, limit_files) -> None:
    """The limit stage as ClassificationRun runs it (run.py:292-315)."""
    selected = os.path.join(workdir, "selected_genomes.txt")
    scores = sorted(os.path.join(workdir, f) for f in os.listdir(workdir) if f.endswith("_sorted.tab"))
    limit_files(selected, selected + ".limited", scores, max_candidates=CAND_MAX)
    os.replace(selected + ".limited", selected)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("screen_world")
    names, seqs = read_fasta(os.path.join(WORLD, "data", "camisyn_gut", "contigs.fna"))
    names, seqs = names[:N_CONTIGS], seqs[:N_CONTIGS]
    query = root / "contigs.fna"
    query.write_text("".join(f">{n} sample contig\n{s.decode()}\n" for n, s in zip(names, seqs)))
    ref = root / "jax"
    jdbs = [JDB.load(os.path.join(WORLD, f"{label}.npz")) for label in LABELS]
    selected = jstage.run_screen_stage(jdbs, [str(query)], str(ref), 0.9, LABELS, chunk_bp=CHUNK_BP)
    _limit(str(ref), jcand.limit_candidates_files)
    return {"root": root, "query": str(query), "names": names, "seqs": seqs,
            "ref": str(ref), "selected": selected}


@pytest.mark.parametrize("staged", [False, True], ids=["chunked", "staged"])
def test_screen_stage_and_limit_match_jax(world, staged):
    out = str(world["root"] / ("staged" if staged else "chunked"))
    dbs = [load_sketch_db(os.path.join(WORLD, f"{label}.npz")) for label in LABELS]
    batches = (
        StagedContigs(world["names"], world["seqs"], BATCH_PAD, 38, device="cpu") if staged else None
    )
    selected = tstage.run_screen_stage(
        dbs, [world["query"]], out, 0.9, LABELS, chunk_bp=CHUNK_BP, staged=batches, device="cpu"
    )
    assert selected == world["selected"] and len(selected) > CAND_MAX
    _limit(out, tcand.limit_candidates_files)
    files = sorted(os.listdir(world["ref"]))
    assert files == sorted(os.listdir(out))
    assert len(files) == 4 * len(LABELS) + 1
    for name in files:
        assert filecmp.cmp(os.path.join(world["ref"], name), os.path.join(out, name), shallow=False), name
    with open(os.path.join(out, "selected_genomes.txt")) as f:
        assert sum(1 for _ in f) == CAND_MAX


def _rows(seed: int, n: int):
    rng = np.random.default_rng(seed)
    ident = np.round(rng.uniform(0.6, 1.0, n), 6)
    ident[: n // 4] = 0.9  # ties at the threshold: the walk compares strictly
    return [(float(i), f"{j}/1000", 1, 0.0, f"ref{j % (n - 3)}", "") for j, i in enumerate(ident)]


@pytest.mark.parametrize("seed,n,files,start", [(0, 40, 1, 0.9), (1, 12, 1, 0.9), (2, 30, 4, 0.85), (3, 6, 2, 0.95)])
def test_threshold_walk_and_rows_match_jax(tmp_path, seed, n, files, start):
    rows = _rows(seed, n)
    srt = tstage.unique_sorted_rows(rows)
    assert srt == jstage.unique_sorted_rows(rows)
    assert tstage.adaptive_threshold_select(srt, files, start) == jstage.adaptive_threshold_select(srt, files, start)
    tstage.write_screen_tab(str(tmp_path / "t.tab"), srt)
    jstage.write_screen_tab(str(tmp_path / "j.tab"), srt)
    assert (tmp_path / "t.tab").read_bytes() == (tmp_path / "j.tab").read_bytes()


def test_limit_candidates_dedupe_matches_jax(tmp_path):
    names = [f"GCF_{i:09d}.1_ASM_genomic.fna.gz" for i in range(30)]
    (tmp_path / "sel.txt").write_text("".join(n + "\n" for n in names))
    rng = np.random.default_rng(5)
    (tmp_path / "a_sorted.tab").write_text(
        "".join(f"{rng.uniform(0.7, 1):.6f}\t1/1\t1\t0\t{n}\t\n" for n in names[::2])
    )
    summary = tmp_path / "sum"
    summary.mkdir()
    (summary / "assembly_summary_refseq.txt").write_text(
        "# header\n" + "".join(
            f"GCF_{i:09d}.1\tx\tx\tx\tx\t{i}\t{i % 7}\torg{i % 7}\n" for i in range(30)
        )
    )
    for mod, out in ((tcand, "t.txt"), (jcand, "j.txt")):
        mod.limit_candidates_files(
            str(tmp_path / "sel.txt"), str(tmp_path / out), [str(tmp_path / "a_sorted.tab")],
            max_candidates=5, dedupe=True, assembly_dir=str(summary),
        )
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
