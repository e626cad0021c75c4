"""hymet_tpu_torch's multi-process path on the CPU: two real OS processes
over gloo, each naming the CPU twice (``["cpu", "cpu"]``), against
hymet_tpu on the 8 virtual CPU devices of tests/conftest.py (the
counterparts of tests/test_multiprocess.py).

- ``init_distributed`` from arguments and from torchrun's variables;
  ``is_primary``, ``process_count``, ``process_index``;
- the global mesh's shape, owners and devices at (1, 4) and (2, 2);
  ``fetch_global`` and ``fetch_global_tree`` equal on both ranks;
- ``ShardedScreenEngine`` on test_multiprocess.py's seed-5 world: integers
  equal and float32 identity bit for bit to hymet_tpu's at the same db
  size (at (2, 2) process 1 owns no shard and still enters the gathers);
- ``ShardedMinimizerAligner``: records equal the JAX sharded aligner's as
  ordered lists, also with caps far too small, where both ranks retry
  together;
- the full pipeline on test_two_process_full_pipeline's world at
  db_shards = 4: process 0's files byte for byte equal to hymet_tpu's
  single-process sharded run, process 1's under ``.proc1`` and equal to
  them; then again with process 0's outputs warm and process 1's cold.

The workers import hymet_tpu_torch only (jax and hymet_tpu are blocked in
them) and run one thread each; every wait has a timeout that kills both.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 240

PREAMBLE = r"""
import importlib.abc, os, pickle, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "hymet_tpu"):
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, _Block())
import numpy as np
import torch
torch.set_num_threads(1)
from hymet_tpu_torch.parallel.distributed import (
    init_distributed, is_primary, process_count, process_index, shutdown)

rank, port, out, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
if mode == "torchrun":
    started = init_distributed()
else:
    started = init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=rank)
res = {"started": started, "primary": is_primary(), "count": process_count(),
       "index": process_index()}
"""

UNITS = PREAMBLE + r"""
from hymet_tpu_torch.parallel import fetch_global, fetch_global_tree, make_mesh, sharded_topk

meshes = {}
for shape in ((1, 4), (2, 2)):
    m = meshes[shape] = make_mesh(*shape, devices=["cpu", "cpu"])
    res[("mesh", shape)] = (m.shape, m.owners, [[None if d is None else str(d) for d in row]
                                                for row in m.devices], m.local_shards)
x = torch.full((rank + 1, 3), rank, dtype=torch.int32)
res["fetch"] = fetch_global(x)
res["tree"] = fetch_global_tree(({rank: x}, (x[:1], torch.tensor(rank)), [x.numpy()]))
scores = torch.from_numpy(np.random.default_rng(7).integers(0, 20, 64).astype(np.float32))
res["topk"] = {shape: [[t.numpy() for t in sharded_topk(m, scores, k)] for k in (1, 5, 20, 64)]
               for shape, m in meshes.items()}

if mode == "arguments":
    from hymet_tpu_torch.io.fasta import encode_seq
    from hymet_tpu_torch.io.minimizer_index import MinimizerIndex
    from hymet_tpu_torch.io.sketchdb import build_sketch_db_from_sequences
    from hymet_tpu_torch.parallel.align import ShardedMinimizerAligner
    from hymet_tpu_torch.parallel.screen import ShardedScreenEngine

    rng = np.random.default_rng(5)
    ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = [(f"g{i}", rng.choice(ACGT, 40000).tobytes()) for i in range(8)]
    db = build_sketch_db_from_sequences(genomes, k=21, sketch_size=200, device="cpu")
    q = np.frombuffer(genomes[3][1], dtype=np.uint8).copy()
    idx = rng.random(q.size) < 0.02
    q[idx] = rng.choice(ACGT, int(idx.sum()))
    batches = [encode_seq(q.tobytes())[None, :]]
    rows = [genomes[5][1][:9000], rng.choice(ACGT, 7000).tobytes(), genomes[1][1][3000:12000]]
    batch = np.full((3, 9000), 4, dtype=np.uint8)
    for i, r in enumerate(rows):
        batch[i, : len(r)] = encode_seq(r)
    batches.append(batch)
    refs = [(f"chr{i}", genomes[i][1]) for i in range(8)]
    midx = MinimizerIndex.build(refs, device="cpu")
    qnames = ["qa", "qb", "qc", "qd"]
    qseqs = [genomes[2][1][1000:9000], genomes[6][1][5000:30000], genomes[0][1][20000:26000],
             genomes[1][1][3000:8000]]
    for shape, mesh in meshes.items():
        eng = ShardedScreenEngine(mesh, db)
        for b in batches:
            eng.update_codes(b)
        r = eng.finalize()
        res[("screen", shape)] = (r.identity, r.shared, r.median, r.total_query_kmers,
                                  sum(e is not None for e in eng.engines))
        aln = ShardedMinimizerAligner(mesh, midx)
        res[("align", shape)] = [r.to_line() for r in aln.map_batch(qnames, qseqs)]
        # caps far too small: every shard overflows, and every rank retries
        small = ShardedMinimizerAligner(mesh, midx)
        small._caps = lambda B, L, a=small: (64 * a._cap_boost, 64 * a._acap_boost,
                                              a._ccap_boost)
        lines = [r.to_line() for r in small.map_batch(qnames, qseqs)]
        res[("retry", shape)] = (lines, (small._cap_boost, small._acap_boost, small._ccap_boost))

# a bare "cuda" in a group is the process's own card: torch.cuda is
# patched to show two cards, and nothing is placed on them
from hymet_tpu_torch.pipeline.run import ClassificationRun
from hymet_tpu_torch.utils.config import RunConfig

torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 2
default = ClassificationRun(RunConfig(outdir=out + "_default", db_shards=2))
res["default_card"] = (str(default.dev), [[None if d is None else str(d) for d in row]
                                          for row in default.mesh.devices], default.cfg.outdir)

shutdown()
res["after_shutdown"] = (process_count(), process_index())
with open(f"{out}.{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
print(f"WORKER{rank}_OK", flush=True)
"""

FULLRUN = PREAMBLE + r"""
import shutil
from hymet_tpu_torch.pipeline.run import ClassificationRun
from hymet_tpu_torch.utils.config import RunConfig

shared = sys.argv[5]
FILES = ("work/selected_genomes.txt", "work/resultados.paf", "classified_sequences.tsv",
         "hymet.sample.cami.tsv")


def run():
    cfg = RunConfig(
        input_fasta=os.path.join(shared, "sample.fna"),
        outdir=os.path.join(shared, "out_multi"),
        cache_root=os.path.join(shared, "cache_multi"),
        cand_max=50,
        species_dedup=False,
        taxonomy_dir=os.path.join(shared, "taxonomy_hierarchy.tsv"),
        sketch_dbs=[os.path.join(shared, f"sketch{i + 1}.npz") for i in range(2)],
        genome_catalog=os.path.join(shared, "genomes"),
        seqid2taxid=os.path.join(shared, "seqid2taxid.tsv"),
        db_shards=4,
    )
    r = ClassificationRun(cfg, device="cpu", mesh_devices=["cpu", "cpu"])
    classified = r.execute()
    files = {}
    for name in FILES:
        with open(os.path.join(r.cfg.outdir, name), "rb") as f:
            files[name] = f.read()
    return r, {"classified": classified, "outdir": r.cfg.outdir, "cache_root": r.cfg.cache_root,
               "mesh": (r.mesh.shape, r.mesh.owners, r.mesh.local_shards),
               "stages": sorted(r.timings), "files": files}


first, res["cold"] = run()
if rank == 1:  # process 0 warm, process 1 cold: both must run the sharded stages again
    shutil.rmtree(first.cfg.outdir)
    shutil.rmtree(first.cfg.cache_root)
_, res["warm_and_cold"] = run()
shutdown()
with open(f"{out}.{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
print(f"FULLRUN{rank}_OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(tmp, script: str, mode: str, *extra) -> list:
    """Run `script` as ranks 0 and 1; each rank's pickled results."""
    path = tmp / "worker.py"
    path.write_text(script)
    port = str(_free_port())
    out = str(tmp / "result")
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("XLA_", "MASTER_", "WORLD_SIZE", "RANK", "LOCAL_RANK"))}
        env["PYTHONPATH"] = REPO
        env["OMP_NUM_THREADS"] = "1"
        if mode == "torchrun":
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE="2",
                       RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(path), str(rank), port, out, mode, *extra], cwd=str(tmp),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for rank, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=WAIT_S))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{stdout[-1000:]}\n{stderr[-4000:]}"
    results = []
    for rank in range(2):
        with open(f"{out}.{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    return _two_ranks(tmp_path_factory.mktemp("units"), UNITS, "arguments")


@pytest.fixture(scope="module")
def units_torchrun(tmp_path_factory):
    return _two_ranks(tmp_path_factory.mktemp("units_torchrun"), UNITS, "torchrun")


# ----------------------------------------------------------------------
# init_distributed, the mesh, fetch_global


def test_init_distributed_without_a_group_starts_nothing(monkeypatch):
    from hymet_tpu_torch.parallel import distributed

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    assert distributed.is_primary() and distributed.all_gather(7) == [7]
    with pytest.raises(ValueError, match="needs an address"):
        distributed.init_distributed(num_processes=2)


@pytest.mark.parametrize("fixture", ["units", "units_torchrun"])
def test_init_distributed_ranks(request, fixture):
    """From explicit arguments and from torchrun's variables: both ranks
    in one group of 2."""
    r0, r1 = request.getfixturevalue(fixture)
    for rank, r in enumerate((r0, r1)):
        assert r["started"] is True and r["count"] == 2 and r["index"] == rank
        assert r["primary"] == (rank == 0)
        assert r["after_shutdown"] == (1, 0)  # shutdown() left the group


@pytest.mark.parametrize("fixture", ["units", "units_torchrun"])
def test_global_mesh_shapes_and_owners(request, fixture):
    """Devices ordered by rank, then local index, as jax.devices(): at
    (1, 4) each rank owns two db shards; at (2, 2) rank 1 holds the data
    replicas and owns no shard."""
    r0, r1 = request.getfixturevalue(fixture)
    assert r0[("mesh", (1, 4))][:2] == r1[("mesh", (1, 4))][:2] == (
        {"data": 1, "db": 4}, [[0, 0, 1, 1]])
    assert r0[("mesh", (1, 4))][2:] == ([["cpu", "cpu", None, None]], [0, 1])
    assert r1[("mesh", (1, 4))][2:] == ([[None, None, "cpu", "cpu"]], [2, 3])
    assert r0[("mesh", (2, 2))][:2] == r1[("mesh", (2, 2))][:2] == (
        {"data": 2, "db": 2}, [[0, 0], [1, 1]])
    assert r0[("mesh", (2, 2))][2:] == ([["cpu", "cpu"], [None, None]], [0, 1])
    assert r1[("mesh", (2, 2))][2:] == ([[None, None], ["cpu", "cpu"]], [])


@pytest.mark.parametrize("fixture", ["units", "units_torchrun"])
def test_default_device_is_the_process_card(request, fixture):
    """ClassificationRun's default device="cuda" in a group: rank i runs
    on cuda:i (LOCAL_RANK under torchrun, else the process index), and the
    mesh spans both ranks' cards; rank 1 writes under .proc1."""
    r0, r1 = request.getfixturevalue(fixture)
    dev0, mesh0, out0 = r0["default_card"]
    dev1, mesh1, out1 = r1["default_card"]
    assert (dev0, dev1) == ("cuda:0", "cuda:1")
    assert mesh0 == [["cuda:0", None]] and mesh1 == [[None, "cuda:1"]]
    assert out1 == out0 + ".proc1"


@pytest.mark.parametrize("fixture", ["units", "units_torchrun"])
def test_fetch_global_equal_on_both_ranks(request, fixture):
    """Each rank's local piece joined in rank order; a tree's dicts united
    by key, its arrays joined, its scalars stacked, in one round."""
    r0, r1 = request.getfixturevalue(fixture)
    want = np.array([[0, 0, 0], [1, 1, 1], [1, 1, 1]], dtype=np.int32)
    for r in (r0, r1):
        assert r["fetch"].dtype == np.int32 and np.array_equal(r["fetch"], want)
        shards, (firsts, ranks), [joined] = r["tree"]
        assert sorted(shards) == [0, 1]
        assert np.array_equal(shards[0], want[:1]) and np.array_equal(shards[1], want[1:])
        assert np.array_equal(firsts, want[:2]) and np.array_equal(ranks, [0, 1])
        assert np.array_equal(joined, want)


# ----------------------------------------------------------------------
# sharded_topk, the sharded screen and aligner against hymet_tpu

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# the port's mesh over 2 processes x 2 devices -> hymet_tpu's on 8 devices
# with the same db size
JAX_SHAPE = {(1, 4): (2, 4), (2, 2): (4, 2)}


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_two_process_sharded_topk_matches_jax(units, shape):
    """Each rank's top-k of its own shards, gathered in shard order: both
    ranks get lax.top_k's values and indices, ties the lower index first."""
    import jax.numpy as jnp

    from hymet_tpu.parallel import make_mesh as jmesh
    from hymet_tpu.parallel import sharded_topk as jtopk

    scores = np.random.default_rng(7).integers(0, 20, 64).astype(np.float32)
    for i, k in enumerate((1, 5, 20, 64)):
        want = [np.asarray(t) for t in jtopk(jmesh(*JAX_SHAPE[shape]), jnp.asarray(scores), k)]
        for r in units:
            got = r["topk"][shape][i]
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def jax_world():
    """test_multiprocess.py's seed-5 world, built by hymet_tpu, and the
    workers' two screen batches and four queries."""
    from hymet_tpu.io.fasta import encode_seq
    from hymet_tpu.io.minimizer_index import MinimizerIndex
    from hymet_tpu.io.sketchdb import build_sketch_db_from_sequences

    rng = np.random.default_rng(5)
    genomes = [(f"g{i}", rng.choice(_ACGT, 40000).tobytes()) for i in range(8)]
    db = build_sketch_db_from_sequences(genomes, k=21, sketch_size=200)
    q = np.frombuffer(genomes[3][1], dtype=np.uint8).copy()
    idx = rng.random(q.size) < 0.02
    q[idx] = rng.choice(_ACGT, int(idx.sum()))
    batches = [np.asarray(encode_seq(q.tobytes()))[None, :]]
    rows = [genomes[5][1][:9000], rng.choice(_ACGT, 7000).tobytes(), genomes[1][1][3000:12000]]
    batch = np.full((3, 9000), 4, dtype=np.uint8)
    for i, r in enumerate(rows):
        batch[i, : len(r)] = np.asarray(encode_seq(r))
    batches.append(batch)
    midx = MinimizerIndex.build([(f"chr{i}", genomes[i][1]) for i in range(8)])
    # qc and qd map to one shard: 2 chains there
    queries = (["qa", "qb", "qc", "qd"],
               [genomes[2][1][1000:9000], genomes[6][1][5000:30000], genomes[0][1][20000:26000],
                genomes[1][1][3000:8000]])
    return db, batches, midx, queries


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_two_process_screen_matches_jax(units, jax_world, shape):
    from hymet_tpu.parallel import ShardedScreenEngine as JScreen
    from hymet_tpu.parallel import make_mesh as jmesh

    db, batches, _midx, _queries = jax_world
    jeng = JScreen(jmesh(*JAX_SHAPE[shape]), db)
    for b in batches:
        jeng.update_codes(b)
    want = jeng.finalize()
    engines = []
    for r in units:
        identity, shared, median, total, n_engines = r[("screen", shape)]
        assert identity.dtype == np.float64
        assert np.array_equal(identity.view(np.uint64), np.asarray(want.identity).view(np.uint64))
        assert np.array_equal(shared, want.shared) and shared.dtype == want.shared.dtype
        assert np.array_equal(median, want.median) and median.dtype == want.median.dtype
        assert total == want.total_query_kmers
        assert db.names[int(np.argmax(identity))] == "g3"
        engines.append(n_engines)
    assert engines == ([2, 2] if shape == (1, 4) else [2, 0])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_two_process_aligner_matches_jax(units, jax_world, shape):
    from hymet_tpu.parallel import make_mesh as jmesh
    from hymet_tpu.parallel.align import ShardedMinimizerAligner as JAligner

    _db, _batches, midx, (names, seqs) = jax_world
    want = [r.to_line() for r in JAligner(jmesh(*JAX_SHAPE[shape]), midx).map_batch(names, seqs)]
    assert want and any(ln.split("\t")[5] == "chr2" for ln in want)
    for r in units:
        assert r[("align", shape)] == want


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_two_process_overflow_retry_in_lockstep(units, jax_world, shape):
    """Caps of 64 anchors and 1 chain: every cap doubles several times, on
    both ranks alike (a rank that went on alone would hang the other), and
    the records still equal the JAX aligner's at its own caps."""
    from hymet_tpu.parallel import make_mesh as jmesh
    from hymet_tpu.parallel.align import ShardedMinimizerAligner as JAligner

    _db, _batches, midx, (names, seqs) = jax_world
    want = [r.to_line() for r in JAligner(jmesh(*JAX_SHAPE[shape]), midx).map_batch(names, seqs)]
    (lines0, boosts0), (lines1, boosts1) = (r[("retry", shape)] for r in units)
    assert lines0 == lines1 == want
    assert boosts0 == boosts1 and min(boosts0) >= 2


# ----------------------------------------------------------------------
# the full pipeline


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """test_two_process_full_pipeline's world; both ranks' runs (cold, then
    rank 0 warm and rank 1 cold) and hymet_tpu's single-process sharded
    run at db_shards = 4 (a 2x4 mesh of the 8 virtual devices)."""
    from hymet_tpu.io.sketchdb import build_sketch_db
    from hymet_tpu.pipeline.run import ClassificationRun as JRun
    from hymet_tpu.taxonomy.db import TaxonomyDB
    from hymet_tpu.utils.config import RunConfig as JConfig

    tmp = tmp_path_factory.mktemp("pipeline")
    shared = tmp / "world"
    gdir = shared / "genomes"
    gdir.mkdir(parents=True)
    rng = np.random.default_rng(11)
    taxids = {}
    genome_files = []
    for i in range(6):
        seq = rng.choice(_ACGT, 20000).tobytes().decode()
        name = f"GEN{i}.1"
        p = gdir / f"g{i}.fna"
        p.write_text(f">{name}\n{seq}\n")
        genome_files.append(str(p))
        taxids[name] = 9000 + i
    with open(shared / "seqid2taxid.tsv", "w") as f:
        for name, t in taxids.items():
            f.write(f"{name}\t{t}\n")
    for d in range(2):
        build_sketch_db(genome_files[d::2], k=21, sketch_size=150).save(
            str(shared / f"sketch{d + 1}.npz"))
    recs = [("1", "root", "no rank", "1")] + [
        (str(t), f"Species {t}", "species", "1") for t in taxids.values()]
    TaxonomyDB.from_records(recs).write_hierarchy_tsv(str(shared / "taxonomy_hierarchy.tsv"))
    with open(shared / "sample.fna", "w") as f:
        for i, gi in enumerate((1, 4)):
            src = np.frombuffer(open(genome_files[gi]).read().splitlines()[1].encode(),
                                np.uint8).copy()
            mut = rng.random(src.size) < 0.01
            src[mut] = rng.choice(_ACGT, int(mut.sum()))
            f.write(f">ctg{i}\n{src.tobytes().decode()}\n")
    world_entries = sorted(os.listdir(shared))

    ranks = _two_ranks(tmp, FULLRUN, "arguments", str(shared))
    JRun(JConfig(
        input_fasta=str(shared / "sample.fna"), outdir=str(tmp / "jax_out"),
        cache_root=str(tmp / "jax_cache"), cand_max=50, species_dedup=False,
        taxonomy_dir=str(shared / "taxonomy_hierarchy.tsv"),
        sketch_dbs=[str(shared / f"sketch{i + 1}.npz") for i in range(2)],
        genome_catalog=str(gdir), seqid2taxid=str(shared / "seqid2taxid.tsv"), db_shards=4,
    )).execute()
    jax_files = {}
    for name in ranks[0]["cold"]["files"]:
        with open(tmp / "jax_out" / name, "rb") as f:
            jax_files[name] = f.read()
    return ranks, jax_files, shared, world_entries


@pytest.mark.parametrize("run", ["cold", "warm_and_cold"])
def test_two_process_pipeline_matches_jax_sharded_run(pipeline, run):
    """Process 0's selected genomes, PAF, classification and CAMI profile
    equal hymet_tpu's single-process run at db_shards = 4, byte for byte;
    process 1's equal them (the second run: process 0 warm, 1 cold)."""
    (r0, r1), jax_files, _shared, _entries = pipeline
    assert jax_files["work/resultados.paf"] and jax_files["classified_sequences.tsv"]
    assert r0[run]["files"] == jax_files
    assert r1[run]["files"] == jax_files


@pytest.mark.parametrize("run", ["cold", "warm_and_cold"])
def test_two_process_pipeline_writes_per_process(pipeline, run):
    """Process 0 writes outdir and cache_root, process 1 their .proc1
    twins and nothing else; the mesh is the global 1x4 one, two shards a
    process; every stage ran in both processes (the cold one too)."""
    (r0, r1), _jax, shared, world_entries = pipeline
    out, cache = str(shared / "out_multi"), str(shared / "cache_multi")
    assert (r0[run]["outdir"], r0[run]["cache_root"]) == (out, cache)
    assert (r1[run]["outdir"], r1[run]["cache_root"]) == (out + ".proc1", cache + ".proc1")
    assert r0[run]["classified"] == os.path.join(out, "classified_sequences.tsv")
    assert r1[run]["classified"] == os.path.join(out + ".proc1", "classified_sequences.tsv")
    assert sorted(os.listdir(shared)) == sorted(
        world_entries + ["out_multi", "cache_multi", "out_multi.proc1", "cache_multi.proc1"])
    assert r0[run]["mesh"] == ({"data": 1, "db": 4}, [[0, 0, 1, 1]], [0, 1])
    assert r1[run]["mesh"] == ({"data": 1, "db": 4}, [[0, 0, 1, 1]], [2, 3])
    stages = {"screen", "limit", "reference", "align", "classify", "export"}
    assert stages <= set(r1[run]["stages"])
    assert stages - {"reference"} <= set(r0[run]["stages"])
