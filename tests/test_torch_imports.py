"""hymet_tpu_torch stands alone: every module (and chip_smoke.py) imports
with ``jax`` and ``hymet_tpu`` blocked, and the entry points run on the
card unless the caller asks for the CPU — without a card they raise."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hymet_tpu_torch.io.sketchdb import load_sketch_db
from hymet_tpu_torch.ops.sketch import ScreenEngine
from hymet_tpu_torch.pipeline.screen_stage import run_screen_stage, screen_queries, stream_screen
from hymet_tpu_torch.pipeline.staged import StagedContigs
from hymet_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "validation", "work_cami_suite")

_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "hymet_tpu"):
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
import hymet_tpu_torch
mods = ["hymet_tpu_torch"]
for info in pkgutil.walk_packages(hymet_tpu_torch.__path__, "hymet_tpu_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hymet_tpu")]
assert not bad, bad
print(len(mods))
"""


def test_port_imports_without_jax_or_reference_package():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 30  # every module was walked


ALIGN_MODULES = [
    "hymet_tpu_torch.ops.minimizer", "hymet_tpu_torch.ops.compaction",
    "hymet_tpu_torch.ops.align_kernels", "hymet_tpu_torch.io.minimizer_index",
    "hymet_tpu_torch.io.paf", "hymet_tpu_torch.models.aligner",
    "hymet_tpu_torch.pipeline.align_stage",
]


RUN_MODULES = [
    "hymet_tpu_torch.taxonomy", "hymet_tpu_torch.taxonomy.lineage",
    "hymet_tpu_torch.taxonomy.idmap", "hymet_tpu_torch.taxonomy.db", "hymet_tpu_torch.ops.lca",
    "hymet_tpu_torch.models.weighted_lca", "hymet_tpu_torch.models.first_hit",
    "hymet_tpu_torch.pipeline.reference_stage", "hymet_tpu_torch.evalx.cami",
    "hymet_tpu_torch.utils.config", "hymet_tpu_torch.pipeline.run",
]


CLI_MODULES = [
    "hymet_tpu_torch.io.msh", "hymet_tpu_torch.io.sketchdb", "hymet_tpu_torch.ops.sketch_kernels",
    "hymet_tpu_torch.ops.sketch", "hymet_tpu_torch.models.legacy_lca",
    "hymet_tpu_torch.pipeline.prune_cache", "hymet_tpu_torch.cli", "hymet_tpu_torch.__main__",
]


EVAL_MODULES = [
    "hymet_tpu_torch.evalx", "hymet_tpu_torch.evalx.eval_cami",
    "hymet_tpu_torch.evalx.superkingdom_fix", "hymet_tpu_torch.evalx.converters",
    "hymet_tpu_torch.evalx.diagnostics", "hymet_tpu_torch.data", "hymet_tpu_torch.data.subsets",
    "hymet_tpu_torch.data.testdataset", "hymet_tpu_torch.data.cami_subsets",
    "hymet_tpu_torch.data.zymo_taxonomy",
]


HARNESS_MODULES = [
    "hymet_tpu_torch.utils.device", "hymet_tpu_torch.harness", "hymet_tpu_torch.harness.manifest",
    "hymet_tpu_torch.harness.measure", "hymet_tpu_torch.harness.aggregate",
    "hymet_tpu_torch.harness.baselines", "hymet_tpu_torch.harness.plots",
    "hymet_tpu_torch.harness.fetch", "hymet_tpu_torch.harness.bench",
    "hymet_tpu_torch.harness.case", "hymet_tpu_torch.harness.ablation",
    "hymet_tpu_torch.harness.zymo_truth",
]


PARALLEL_MODULES = [
    "hymet_tpu_torch.parallel", "hymet_tpu_torch.parallel.mesh",
    "hymet_tpu_torch.parallel.collectives", "hymet_tpu_torch.parallel.screen",
    "hymet_tpu_torch.parallel.align", "hymet_tpu_torch.parallel.distributed",
]


HOST_MODULES = ["hymet_tpu_torch.io.native_io", "hymet_tpu_torch.io.fasta"]


BENCH_MODULES = ["hymet_tpu_torch.bench", "hymet_tpu_torch.harness.deadline",
                 "hymet_tpu_torch.harness.timing"]


# the last public pieces: io's re-exports, screen_queries, the profile hook
PUBLIC_MODULES = ["hymet_tpu_torch.io", "hymet_tpu_torch.pipeline.screen_stage",
                  "hymet_tpu_torch.pipeline.run"]


_IMPORT_EACH_ALONE = r"""
import importlib, json, os, sys, traceback

import numpy, torch  # neither is blocked; imported once, before the forks

results = {}
for module in sys.argv[1:]:
    pid = os.fork()
    if pid == 0:  # a child imports one module into a process that has none of the package
        try:
            importlib.import_module(module)
            bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hymet_tpu")]
            os._exit(3 if bad else 0)
        except BaseException:
            traceback.print_exc()
            os._exit(1)
    results[module] = os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1])
print(json.dumps(results))
"""


@pytest.fixture(scope="module")
def alone():
    """Exit code of importing each module of ALIGN_MODULES, RUN_MODULES,
    CLI_MODULES, EVAL_MODULES, HARNESS_MODULES, PARALLEL_MODULES, HOST_MODULES,
    BENCH_MODULES and PUBLIC_MODULES alone,
    with jax and hymet_tpu blocked (0: imported, pulling in neither), from one interpreter that forks a
    child a module."""
    code = _BLOCKED_IMPORTS.split("import hymet_tpu_torch")[0] + _IMPORT_EACH_ALONE
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code, *ALIGN_MODULES, *RUN_MODULES,
                          *CLI_MODULES, *EVAL_MODULES, *HARNESS_MODULES, *PARALLEL_MODULES,
                          *HOST_MODULES, *BENCH_MODULES, *PUBLIC_MODULES],
                         cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("module", ALIGN_MODULES)
def test_align_module_imports_without_jax_or_reference_package(alone, module):
    """Each module of the align slice, imported alone in a fresh process
    with jax and hymet_tpu blocked, pulls in neither."""
    codes, stderr = alone
    assert codes[module] == 0, stderr


@pytest.mark.parametrize("module", RUN_MODULES)
def test_run_module_imports_without_jax_or_reference_package(alone, module):
    """Each module of the reference -> classify -> export slice and the
    run, imported alone with jax and hymet_tpu blocked, pulls in neither."""
    codes, stderr = alone
    assert codes[module] == 0, stderr


@pytest.mark.parametrize("module", CLI_MODULES)
def test_cli_module_imports_without_jax_or_reference_package(alone, module):
    """Each module of the DB build and command-line slice, imported alone
    with jax and hymet_tpu blocked, pulls in neither (the package's
    ``__main__`` does not run when imported)."""
    codes, stderr = alone
    assert codes[module] == 0, stderr


@pytest.mark.parametrize("module", EVAL_MODULES)
def test_eval_module_imports_without_jax_or_reference_package(alone, module):
    """Each module of the evaluator and dataset-tools slice, imported alone
    with jax and hymet_tpu blocked, pulls in neither (the converters carry
    their own copy of the JAX harness's CAMI writer)."""
    codes, stderr = alone
    assert codes[module] == 0, stderr


@pytest.mark.parametrize("module", HARNESS_MODULES)
def test_harness_module_imports_without_jax_or_reference_package(alone, module):
    """Each module of the experiment harnesses (and the device rule they
    share with the command line), imported alone with jax and hymet_tpu
    blocked, pulls in neither (plots imports matplotlib only to draw)."""
    codes, stderr = alone
    assert codes[module] == 0, stderr


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_module_imports_without_jax_or_reference_package(alone, module):
    """Each module of the reference-DB sharding (mesh, sharded_topk, the
    sharded screen and aligner), imported alone with jax and hymet_tpu
    blocked, pulls in neither."""
    codes, stderr = alone
    assert codes[module] == 0, stderr


@pytest.mark.parametrize("module", HOST_MODULES)
def test_host_module_imports_without_jax_or_reference_package(alone, module):
    """The native host helpers' bindings and the FASTA reader that uses
    them, imported alone with jax and hymet_tpu blocked, pull in neither
    (the library builds at first use, not at import)."""
    codes, stderr = alone
    assert codes[module] == 0, stderr


@pytest.mark.parametrize("module", BENCH_MODULES + PUBLIC_MODULES)
def test_bench_and_public_module_imports_without_jax_or_reference_package(alone, module):
    """The bench's modules, io's re-exports, the screen stage with
    screen_queries and the run with its profile hook, each imported alone
    with jax and hymet_tpu blocked, pull in neither."""
    codes, stderr = alone
    assert codes[module] == 0, stderr


_LAUNCHER = r"""
import runpy, sys
sys.argv = [sys.argv[1], "--help"]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hymet_tpu")]
assert not bad, bad
assert "hymet_tpu_torch.cli" in sys.modules
"""


def test_launcher_runs_without_jax_or_reference_package(tmp_path):
    """bin/hymet-tpu-torch, run from another directory with jax and
    hymet_tpu blocked, prints the port's usage and pulls in neither."""
    code = _BLOCKED_IMPORTS.split("import hymet_tpu_torch")[0] + _LAUNCHER
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_") and k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, os.path.join(REPO, "bin", "hymet-tpu-torch")],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage:" in out.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")


def test_default_device_raises_without_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(tmp_path):
    """No CPU fallback: called without device=, each entry point asks for
    CUDA and raises here, where there is no card."""
    _no_card()
    db = load_sketch_db(os.path.join(WORLD, "sketch1.npz"))
    q = tmp_path / "q.fna"
    q.write_text(">a\n" + "ACGT" * 50 + "\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_screen_stage([db], [str(q)], str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_screen(db, [str(q)])
    with pytest.raises(RuntimeError, match="CUDA"):
        screen_queries(db, [str(q)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ScreenEngine(db)
    with pytest.raises(RuntimeError, match="CUDA"):
        StagedContigs(["a"], [b"ACGT" * 50], 4096, 38)


def test_align_entry_points_default_to_the_card(tmp_path):
    """The align slice's entry points, called without device=, ask for
    CUDA and raise here, where there is no card."""
    _no_card()
    from hymet_tpu_torch.io.minimizer_index import MinimizerIndex
    from hymet_tpu_torch.models.aligner import MinimizerAligner
    from hymet_tpu_torch.pipeline.align_stage import run_align_stage

    seq = b"ACGTTGCAAGGCTTAC" * 40
    fasta = tmp_path / "ref.fna"
    fasta.write_text(">r\n" + seq.decode() + "\n")
    index = MinimizerIndex.build([("r", seq)], device="cpu")
    for call in (
        lambda: MinimizerIndex.build([("r", seq)]),
        lambda: MinimizerIndex.build_from_fasta(str(fasta)),
        lambda: MinimizerAligner(index),
        lambda: run_align_stage(str(fasta), ["q"], [seq], str(tmp_path / "out")),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_run_entry_points_default_to_the_card(tmp_path):
    """The run and the device classifier, called without device=, ask for
    CUDA and raise here; the host backend and the plain LCA need no card."""
    _no_card()
    from hymet_tpu_torch.models.weighted_lca import classify_query_map
    from hymet_tpu_torch.ops.lca import weighted_lca
    from hymet_tpu_torch.pipeline.run import ClassificationRun
    from hymet_tpu_torch.taxonomy.idmap import IdentifierMap
    from hymet_tpu_torch.utils.config import RunConfig

    with pytest.raises(RuntimeError, match="CUDA"):
        ClassificationRun(RunConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        classify_query_map({"q": [("t", 1.0)]}, {"t": 1}, IdentifierMap(), {})
    assert classify_query_map({"q": [("t", 1.0)]}, {"t": 1}, IdentifierMap(), {},
                              backend="host") == [("q", "Unknown", "root", 0.0)]
    rows = torch.zeros((1, 8), dtype=torch.int32)
    n = weighted_lca(rows, torch.ones((1, 8), dtype=torch.float64),
                     torch.ones((1, 8), dtype=torch.int32))[1]
    assert n.tolist() == [8]


def test_mesh_defaults_to_the_cards():
    """make_mesh without devices= takes every visible card, and raises here,
    where there is none; so do meshes naming the card."""
    _no_card()
    from hymet_tpu_torch.parallel import make_mesh

    for call in (lambda: make_mesh(), lambda: make_mesh(1, 2), lambda: make_mesh(devices=["cuda"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert make_mesh(devices=["cpu"]).shape == {"data": 1, "db": 1}


def test_eval_entry_points_default_to_the_card(tmp_path):
    """evaluate, score_contigs and the remap, called without device=, ask
    for CUDA and raise here, where there is no card."""
    _no_card()
    from hymet_tpu_torch.evalx import eval_cami
    from hymet_tpu_torch.taxonomy.db import TaxonomyDB

    fasta = tmp_path / "a.fna"
    fasta.write_text(">a\n" + "ACGTTGCAAGGCTTAC" * 40 + "\n")
    for call in (
        lambda: eval_cami.evaluate(None, None, str(tmp_path / "out")),
        lambda: eval_cami.score_contigs(None, [], TaxonomyDB(), str(tmp_path)),
        lambda: eval_cami._contig_remap(str(fasta), str(fasta)),
        lambda: eval_cami._pairs_by_remap({}, {}, str(fasta), str(fasta)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_harness_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """run_bench, run_case and run_ablation with HYMET_PLATFORM unset ask
    for CUDA and raise here, where there is no card, before writing."""
    _no_card()
    from hymet_tpu_torch.harness.ablation import run_ablation
    from hymet_tpu_torch.harness.bench import run_bench
    from hymet_tpu_torch.harness.case import run_case

    monkeypatch.delenv("HYMET_PLATFORM", raising=False)
    (tmp_path / "m.tsv").write_text("sample_id\tcontigs_fa\n")
    (tmp_path / "r.fna").write_text(">r\nACGT\n")
    out = str(tmp_path / "out")
    for call in (
        lambda: run_bench(str(tmp_path / "m.tsv"), ["hymet_tpu"], out_root=out),
        lambda: run_case(str(tmp_path / "m.tsv"), out_root=out),
        lambda: run_ablation("s", ["1"], [0.0], str(tmp_path / "m.tsv"), str(tmp_path / "r.fna"),
                             out_root=out),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not os.path.exists(out)


def test_chip_smoke_refuses_to_run_without_card():
    _no_card()
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""  # prints no result


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(alone)], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_bound_counts():
    """The kernels' bounds in chip_smoke: 32-bit instructions per window as
    documented, term by term, at the card's integer rates; kmer_hashes
    counted on every window, screen_count only on valid windows (not on
    padding), each bound by whichever of bytes and operations is slower."""
    import chip_smoke

    assert chip_smoke.window_ops(21, screen=True) == (1 + 10 + 20 + 2 + 16 + 4 + 20 + 3, 16 + 6 + 12)
    assert chip_smoke.window_ops(21, screen=False) == (1 + 10 + 20 + 2 + 16 + 4 + 20 + 2, 16 + 6 + 12)
    assert chip_smoke.window_ops(32, screen=False) == (1 + 10 + 26 + 2 + 32 + 20 + 2, 32 + 12)
    assert chip_smoke.window_ops(15, screen=False) == (1 + 10 + 14 + 2 + 4 + 4 + 20 + 2, 6 + 6 + 12)
    sms, clock = 132, 1.98e9
    ms, by = chip_smoke.hash_bound_ms([(8, 1 << 20)], 21, sms, clock)
    n = 8 * ((1 << 20) - 20)
    assert by == "operations"
    assert ms == pytest.approx(n * max(75 / 64, 34 / 64, 109 / 128) / sms / clock * 1e3)
    assert ms > (8 * (1 << 20) + 9 * n) / 3.35e12 * 1e3
    two, by2 = chip_smoke.hash_bound_ms([(8, 1 << 20), (8, 1 << 20)], 21, sms, clock)
    assert by2 == "operations" and two == pytest.approx(2 * ms)
    # screen_count: the same valid windows cost the same operations however
    # much padding the batch carries; the bytes count every packed byte
    dense = chip_smoke.screen_bound_ms([(4_000_000, 10_000_000, 2000, 10**8)], 21, sms, clock)
    padded = chip_smoke.screen_bound_ms([(20_000_000, 10_000_000, 2000, 10**8)], 21, sms, clock)
    alu = 10_000_000 * 76 + 2000 * 6 * 27
    want = max(alu / 64, 10_000_000 * 34 / 64, (alu + 10_000_000 * 34) / 128) / sms / clock * 1e3
    assert dense == padded == (pytest.approx(want), "operations")
    assert chip_smoke.screen_bound_ms([(10**10, 10, 0, 1)], 21, sms, clock) == (
        pytest.approx(10**10 / 3.35e12 * 1e3), "bytes")
    codes = chip_smoke.codes_with_n_runs(np.random.default_rng(0), 2, 1000)
    assert codes.shape == (2, 1000) and (codes == 4).any() and codes.max() <= 4
    edge = chip_smoke.edge_codes(np.random.default_rng(0), 200)
    assert (edge[2] == 4).all() and edge[1, chip_smoke.RUN - 1] == edge[1, 2 * chip_smoke.RUN] == 4


def test_chip_smoke_align_bounds(tmp_path, monkeypatch):
    """The align kernels' bounds in chip_smoke count only what the function
    needs: minimizers its operations on windows with a valid k-mer (48 ALU
    and 12 multiply-add instructions a window) and its bytes for the kept
    minimizers, not the [cap] slots; anchors the loads of its
    bucket-confined search and the bucket and unique-hash entries it
    touches, once each, the anchors and 16 bytes an empty slot (the
    sentinel key, zero qpos and rpos); chains the anchors
    and the good chains' rows, not the padding; and the reference FASTA
    written in selected_genomes.txt order."""
    import gzip

    import chip_smoke

    sms, clock = 132, 1.98e9
    assert chip_smoke.minimizer_ops(19) == (48, 12)
    dense = chip_smoke.minimizer_bound_ms([(1_000_000, 10_000_000, 1000)], 19, sms, clock)
    assert dense == (pytest.approx(10_000_000 * 0.75 / sms / clock * 1e3), "operations")
    assert chip_smoke.minimizer_bound_ms([(10**10, 10, 5)], 19, sms, clock) == (
        pytest.approx((10**10 + 17 * 5) / 3.35e12 * 1e3), "bytes")
    # 2k = 8-bit hashes 3, 7, 8 | 250 in 8 buckets of 32: 7 takes two steps
    # and lands on entry 1, 250 one step in a bucket of one, 100 an empty
    # bucket
    from hymet_tpu_torch.models.aligner import build_bucket_table
    from hymet_tpu_torch.ops.align_kernels import anchor_tables

    uniq = np.array([3, 7, 8, 250], np.int64)
    tables = anchor_tables(uniq, np.zeros((4, 2), np.int32), np.zeros((1, 2), np.int32),
                           *build_bucket_table(uniq, 4), 1, "cpu")
    assert tables.shift == 5 and tables.bucket.tolist() == [0, 3, 3, 3, 3, 3, 3, 3, 4, 4]
    assert chip_smoke.search_stats(torch.tensor([7, 250, 100]), tables) == (2 + 1 + 1 + 1, 6, 3)
    ms, by = chip_smoke.anchor_bound_ms([(500, 1200, 600, 700, 800, 1024)], sms, clock)
    nbytes = 500 * (17 + 8) + 4 * 600 + 8 * 700 + 800 * 24 + 16 * 224
    assert (ms, by) == (pytest.approx(nbytes / 3.35e12 * 1e3), "bytes")
    over, _ = chip_smoke.anchor_bound_ms([(10, 20, 4, 4, 5000, 1024)], sms, clock)
    assert over == pytest.approx((10 * 25 + 16 + 32 + 24 * 1024) / 3.35e12 * 1e3)
    ms, by = chip_smoke.chain_bound_ms([(4096, 10), (4096, 10)], sms, clock)
    assert (ms, by) == (pytest.approx(2 * (16 * 4096 + 36 * 10) / 3.35e12 * 1e3), "bytes")
    for acc, body in (("A_1.1", b">a1\nACGT\nAC"), ("B_2.1", b">b2\nGGGG\n")):
        (tmp_path / acc).mkdir()
        with gzip.open(tmp_path / acc / f"{acc}_genomic.fna.gz", "wb") as f:
            f.write(body)
    (tmp_path / "selected.txt").write_text("B_2.1_genomic.fna.gz\nA_1.1_genomic.fna.gz\n")
    monkeypatch.setattr(chip_smoke, "GENOMES", str(tmp_path))
    out = tmp_path / "combined.fasta"
    assert chip_smoke.write_combined(str(tmp_path / "selected.txt"), str(out)) == 2
    assert out.read_bytes() == b">b2\nGGGG\n>a1\nACGT\nAC\n"


def test_chip_smoke_lca_bound():
    """lca_bound_ms counts 12 B a valid hit, 4 B a (row, rank) entry that
    the queries' hits reach (once), 44 B a query written; and float64 adds:
    a rank's named hits n, distinct names d: (n - d) + (n - 1), plus a
    quotient and a product on a chosen rank."""
    import chip_smoke

    table = np.zeros((3, 8), np.int32)
    table[0, :2], table[1, :2] = (1, 2), (1, 3)  # row 2: no name
    rows = np.array([[0, 1, 0, -1], [-1, -1, -1, -1]], np.int32)
    n_chosen = np.array([2, 0])  # query 0 evaluates ranks 0, 1 and 2
    ms, by = chip_smoke.lca_bound_ms([(rows, n_chosen)], table, 132, 1.98e9)
    nbytes = 3 * 12 + 2 * 44 + 6 * 4
    assert (ms, by) == (pytest.approx(nbytes / 3.35e12 * 1e3), "bytes")
    adds = (2 + 2 + 2) + (1 + 2 + 2)  # rank 0: one name over 3 hits; rank 1: two names
    ms, by = chip_smoke.lca_bound_ms([(rows, n_chosen)], table, 132, 1.0)
    assert (ms, by) == (pytest.approx(adds / 64 / 132 * 1e3), "operations")
    twice, _ = chip_smoke.lca_bound_ms([(rows, n_chosen), (rows, n_chosen)], table, 132, 1.98e9)
    assert twice == pytest.approx(2 * nbytes / 3.35e12 * 1e3)
