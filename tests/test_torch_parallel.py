"""hymet_tpu_torch.parallel against hymet_tpu.parallel on the CPU: the JAX
side on the 8 virtual CPU devices of tests/conftest.py, the port on a mesh
of the CPU named eight times. Exact comparisons: mesh shapes and the 3x3
ValueError, sharded_topk (equal scores too), SketchDB.shard and
MinimizerIndex.shard, ShardedScreenEngine on tests/test_parallel.py's
worlds (integers equal, float32 identity bit for bit), and
ShardedMinimizerAligner on tests/test_sharded_align.py's seed-99 world (PAF
records equal as ordered lists)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hymet_tpu.io.fasta import encode_seq
from hymet_tpu.io.minimizer_index import MinimizerIndex as JIndex
from hymet_tpu.io.sketchdb import build_sketch_db_from_sequences
from hymet_tpu.models.aligner import AlignerConfig as JAlignerConfig
from hymet_tpu.parallel import ShardedScreenEngine as JScreen
from hymet_tpu.parallel import make_mesh as jmesh
from hymet_tpu.parallel import sharded_topk as jtopk
from hymet_tpu.parallel.align import ShardedMinimizerAligner as JAligner
from hymet_tpu_torch.io.minimizer_index import MinimizerIndex
from hymet_tpu_torch.io.sketchdb import SketchDB
from hymet_tpu_torch.models.aligner import AlignerConfig, MinimizerAligner
from hymet_tpu_torch.ops import align_kernels, hash_kernels
from hymet_tpu_torch.ops.sketch import ScreenEngine
from hymet_tpu_torch.parallel import ShardedScreenEngine, make_mesh, sharded_topk
from hymet_tpu_torch.parallel.align import ShardedMinimizerAligner

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_seq(rng, n):
    return rng.choice(_ACGT, size=n).astype(np.uint8).tobytes()


def _sketch_db(jdb) -> SketchDB:
    return SketchDB(k=jdb.k, sketch_size=jdb.sketch_size, hashes=jdb.hashes,
                    n_hashes=jdb.n_hashes, names=list(jdb.names), lengths=jdb.lengths,
                    comments=list(jdb.comments))


def _index(jidx) -> MinimizerIndex:
    return MinimizerIndex(k=jidx.k, w=jidx.w, hashes=jidx.hashes, seq_id=jidx.seq_id,
                          pos=jidx.pos, strand=jidx.strand, names=list(jidx.names),
                          lengths=jidx.lengths)


def _codes(queries) -> np.ndarray:
    L = max(len(q) for q in queries)
    codes = np.full((len(queries), L), 4, dtype=np.uint8)
    for i, q in enumerate(queries):
        codes[i, : len(q)] = encode_seq(q)
    return codes


# ----------------------------------------------------------------------
# mesh


@pytest.mark.parametrize("data,db", [(None, None), (2, 4), (1, 8), (8, 1), (4, None), (None, 2)])
def test_mesh_shapes_match_jax(data, db):
    m = make_mesh(data, db, devices=CPU8)
    assert m.shape == dict(jmesh(data, db).shape)
    assert m.shape["data"] * m.shape["db"] == 8
    assert len(m.devices) == m.shape["data"] and m.db_devices == [torch.device("cpu")] * m.shape["db"]


def test_mesh_3x3_raises_as_jax():
    with pytest.raises(ValueError, match="mesh 3x3 != 8 devices"):
        make_mesh(3, 3, devices=CPU8)
    with pytest.raises(ValueError, match="mesh 3x3 != 8 devices"):
        jmesh(3, 3)


def test_fetch_global_copies_to_the_host():
    """The single-process branch of fetch_global(_tree): host numpy copies,
    one call for a tuple or a dict."""
    from hymet_tpu_torch.parallel.mesh import fetch_global, fetch_global_tree

    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    got = fetch_global(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32 and np.array_equal(got, x.numpy())
    a, b = fetch_global_tree((x, x[0]))
    assert np.array_equal(a, x.numpy()) and np.array_equal(b, [0, 1, 2])
    assert np.array_equal(fetch_global_tree({"n": torch.tensor([7])})["n"], [7])
    assert np.array_equal(fetch_global([1, 2]), [1, 2])


# ----------------------------------------------------------------------
# sharded_topk


def _scores(kind: str, R: int) -> np.ndarray:
    rng = np.random.default_rng(R)
    return {
        "arange": np.arange(R, dtype=np.float32),
        "ties": rng.integers(0, 4, size=R).astype(np.float32),
        "equal": np.zeros(R, dtype=np.float32),
        "random": rng.standard_normal(R).astype(np.float32),
    }[kind]


@pytest.mark.parametrize("kind,R,k,shape", [
    ("arange", 64, 5, (1, 8)), ("ties", 64, 10, (1, 8)), ("equal", 64, 12, (1, 8)),
    ("ties", 16, 20, (1, 8)), ("random", 32, 7, (2, 4)), ("ties", 40, 9, (2, 4)),
])
def test_sharded_topk_matches_jax(kind, R, k, shape):
    """Values and indices equal lax.top_k's merge, ties the lower index
    first (k above a shard's size, and above every candidate, too)."""
    scores = _scores(kind, R)
    vals, idx = sharded_topk(make_mesh(*shape, devices=CPU8), torch.from_numpy(scores), k)
    jvals, jidx = jtopk(jmesh(*shape), jnp.asarray(scores), k)
    assert np.array_equal(vals.numpy(), np.asarray(jvals))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))


def test_sharded_topk_arange():
    vals, idx = sharded_topk(make_mesh(1, 8, devices=CPU8), torch.arange(64, dtype=torch.float32), 5)
    assert vals.tolist() == [63, 62, 61, 60, 59] and idx.tolist() == [63, 62, 61, 60, 59]


# ----------------------------------------------------------------------
# shards


@pytest.fixture(scope="module")
def screen_world():
    """tests/test_parallel.py's seed-31 world: 13 genomes x 6 kbp, k = 21,
    s = 64, and its three queries."""
    rng = np.random.default_rng(31)
    genomes = [(f"g{i}", _rand_seq(rng, 6000)) for i in range(13)]
    jdb = build_sketch_db_from_sequences(genomes, k=21, sketch_size=64)
    queries = [genomes[2][1], genomes[7][1][:3000], _rand_seq(rng, 4000)]
    return jdb, genomes, queries


@pytest.fixture(scope="module")
def align_world():
    """tests/test_sharded_align.py's seed-99 world: 10 sequences x 20 kbp."""
    rng = np.random.default_rng(99)
    genomes = [(f"chr{i}", _rand_seq(rng, 20000)) for i in range(10)]
    return JIndex.build(genomes), dict(genomes)


@pytest.mark.parametrize("n", [1, 3, 4, 8, 16])
def test_sketchdb_shard_matches_jax(screen_world, n):
    jdb = screen_world[0]
    got, want = _sketch_db(jdb).shard(n), jdb.shard(n)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.names == w.names and g.comments == w.comments and g.k == w.k
        for f in ("hashes", "n_hashes", "lengths"):
            assert getattr(g, f).dtype == getattr(w, f).dtype
            assert np.array_equal(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("n", [1, 3, 4, 8, 16])
def test_minimizer_index_shard_matches_jax(align_world, n):
    jidx = align_world[0]
    got, want = _index(jidx).shard(n), jidx.shard(n)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.names == w.names and (g.k, g.w) == (w.k, w.w)
        for f in ("hashes", "seq_id", "pos", "strand", "lengths"):
            assert getattr(g, f).dtype == getattr(w, f).dtype
            assert np.array_equal(getattr(g, f), getattr(w, f))


# ----------------------------------------------------------------------
# ShardedScreenEngine


def _same_result(got, want) -> None:
    assert got.identity.dtype == want.identity.dtype == np.float64
    assert np.array_equal(got.identity.view(np.uint64), np.asarray(want.identity).view(np.uint64))
    assert np.array_equal(got.shared, want.shared) and got.shared.dtype == want.shared.dtype
    assert np.array_equal(got.median, want.median) and got.median.dtype == want.median.dtype
    assert got.total_query_kmers == want.total_query_kmers


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (4, 2)])
def test_sharded_screen_matches_jax(screen_world, shape):
    """update_codes on the seed-31 world: the port equals the JAX sharded
    engine, and the port's single-device engine (sharding changes no
    count); each counting shard went through its count function once."""
    jdb, _genomes, queries = screen_world
    codes = _codes(queries + [b""])  # 4 rows, one all padding
    db = _sketch_db(jdb)
    calls = []

    def count(*args):
        calls.append(args[4].shape[0])
        return hash_kernels.screen_count(*args)

    eng = ShardedScreenEngine(make_mesh(*shape, devices=CPU8), db, count_fn=count)
    eng.update_codes(codes)
    got = eng.finalize()
    jeng = JScreen(jmesh(*shape), jdb)
    jeng.update_codes(codes)
    _same_result(got, jeng.finalize())
    single = ScreenEngine(db, device="cpu")
    single.update_codes_packed(codes)
    want = single.finalize()
    assert np.array_equal(got.shared, want.shared) and np.array_equal(got.median, want.median)
    assert np.array_equal(got.identity, want.identity.astype(np.float64))
    assert len(calls) == shape[1]
    assert sum(calls) == sum(int(s.flat_index()[0].shape[0]) for s in db.shard(shape[1]))


def test_sharded_screen_streaming_updates_match_jax():
    """tests/test_parallel.py's seed-5 world: the same genome streamed twice
    on a 1x8 mesh gives median multiplicity 2, as the JAX engine."""
    rng = np.random.default_rng(5)
    genomes = [(f"g{i}", _rand_seq(rng, 5000)) for i in range(8)]
    jdb = build_sketch_db_from_sequences(genomes, k=21, sketch_size=64)
    codes = encode_seq(genomes[0][1])[None, :]
    eng = ShardedScreenEngine(make_mesh(1, 8, devices=CPU8), _sketch_db(jdb))
    jeng = JScreen(jmesh(1, 8), jdb)
    for e in (eng, jeng):
        e.update_codes(codes)
        e.update_codes(codes)
    got = eng.finalize()
    _same_result(got, jeng.finalize())
    assert got.shared[0] == jdb.n_hashes[0] and got.median[0] == 2


def test_sharded_screen_packed_update_matches_jax():
    """tests/test_parallel.py's seed-9 world: update_codes_packed (an N
    run in a query, 2 rows over a data axis of 2) equals JAX's packed path."""
    rng = np.random.default_rng(9)
    genomes = [(f"g{i}", _rand_seq(rng, 6000)) for i in range(8)]
    jdb = build_sketch_db_from_sequences(genomes, k=21, sketch_size=64)
    codes = _codes([genomes[3][1], genomes[5][1][:2500] + b"NN" + genomes[5][1][2500:]])
    eng = ShardedScreenEngine(make_mesh(2, 4, devices=CPU8), _sketch_db(jdb))
    eng.update_codes_packed(codes)
    jeng = JScreen(jmesh(2, 4), jdb)
    jeng.update_codes_packed(codes)
    _same_result(eng.finalize(), jeng.finalize())


@pytest.mark.parametrize("n_refs", [3, 1])
def test_sharded_screen_fewer_references_than_shards(screen_world, n_refs):
    """A DB with fewer references than db shards: the empty shards neither
    raise nor count; the rows and the window total equal JAX's, after
    three odd-sized batches (padded to the data axis)."""
    jdb_all, _genomes, queries = screen_world
    jdb = jdb_all.shard(13 // n_refs)[0] if n_refs > 1 else jdb_all.shard(13)[0]
    assert jdb.n_refs == n_refs
    calls = []

    def count(*args):
        calls.append(1)
        return hash_kernels.screen_count(*args)

    eng = ShardedScreenEngine(make_mesh(2, 4, devices=CPU8), _sketch_db(jdb), count_fn=count)
    jeng = JScreen(jmesh(2, 4), jdb)
    for batch in (queries[:1], queries[1:], queries):
        codes = _codes(batch)
        eng.update_codes(codes)
        jeng.update_codes(codes)
    _same_result(eng.finalize(), jeng.finalize())
    assert len(calls) == 3 * n_refs
    assert sum(e is None for e in eng.engines) == 4 - n_refs


# ----------------------------------------------------------------------
# ShardedMinimizerAligner


def _lines(records) -> list:
    return [r.to_line() for r in records]


def _queries(genomes) -> tuple:
    queries = [("q0", genomes["chr0"][2000:9000]), ("q1", genomes["chr7"][500:6000]),
               ("q2", genomes["chr4"][1000:4000])]
    return [q[0] for q in queries], [q[1] for q in queries]


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_sharded_aligner_matches_jax(align_world, shape):
    """tests/test_sharded_align.py's three queries: the records equal the
    JAX sharded aligner's as an ordered list, each query's primary on its
    own chromosome, and every live shard ran each of its three functions."""
    jidx, genomes = align_world
    names, seqs = _queries(genomes)
    calls = {"minimizers": 0, "anchors": 0, "chains": 0}

    def counted(fn):
        def call(*args):
            calls[fn.__name__.replace("sorted_", "").replace("_torch", "")] += 1
            return fn(*args)
        return call

    ops = align_kernels.AlignOps(*(counted(f) for f in align_kernels.PLAIN))
    aligner = ShardedMinimizerAligner(make_mesh(*shape, devices=CPU8), _index(jidx), ops=ops)
    got = aligner.map_batch(names, seqs)
    want = JAligner(jmesh(*shape), jidx).map_batch(names, seqs)
    assert got and _lines(got) == _lines(want)
    pri = {r.qname: r.tname for r in got if r.tags["tp"] == "A:P"}
    assert pri == {"q0": "chr0", "q1": "chr7", "q2": "chr4"}
    live = sum(a is not None for a in aligner.aligners)
    assert live == shape[1] and calls == {"minimizers": live, "anchors": live, "chains": live}


def test_sharded_aligner_no_hits(align_world):
    jidx, _ = align_world
    rng = np.random.default_rng(123)
    q = _rand_seq(rng, 5000)
    aligner = ShardedMinimizerAligner(make_mesh(1, 8, devices=CPU8), _index(jidx))
    assert aligner.map_batch(["x"], [q]) == [] == JAligner(jmesh(1, 8), jidx).map_batch(["x"], [q])


def test_sharded_aligner_groups_of_64_match_jax(align_world):
    """70 queries (two groups, each padded to 64 rows, one pad for the
    call) from every chromosome and both strands, at batch_pad 4096, on a
    2x4 mesh: the records equal JAX's as an ordered list."""
    jidx, genomes = align_world
    rng = np.random.default_rng(7)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    names, seqs = [], []
    for i in range(70):
        g = genomes[f"chr{i % 10}"]
        start = int(rng.integers(0, 20000 - 3000))
        s = g[start : start + int(rng.integers(1500, 3000))]
        seqs.append(s.translate(comp)[::-1] if i % 3 == 0 else s)
        names.append(f"q{i}")
    got = ShardedMinimizerAligner(make_mesh(2, 4, devices=CPU8), _index(jidx),
                                  AlignerConfig(batch_pad=4096)).map_batch(names, seqs)
    want = JAligner(jmesh(2, 4), jidx, JAlignerConfig(batch_pad=4096)).map_batch(names, seqs)
    assert len({r.qname for r in got}) == 70 and _lines(got) == _lines(want)


def test_max_occ_applies_per_shard():
    """A 400 bp element in 20 copies, 2 on each of 10 sequences: one device
    drops its minimizers (20 occurrences > max_occ 16), 8 shards keep them
    (2-4 a shard). The port's sharded records equal the JAX sharded ones
    and differ from the single-device run's (ROADMAP C14)."""
    rng = np.random.default_rng(41)
    rep = _rand_seq(rng, 400)
    genomes = [(f"s{i}", _rand_seq(rng, 3000) + rep + _rand_seq(rng, 3000) + rep
                + _rand_seq(rng, 3000)) for i in range(10)]
    jidx = JIndex.build(genomes)
    q = [rng.choice(_ACGT, 100).tobytes() + rep + rng.choice(_ACGT, 100).tobytes()]
    cfg = AlignerConfig(batch_pad=4096)
    got = ShardedMinimizerAligner(make_mesh(1, 8, devices=CPU8), _index(jidx), cfg).map_batch(
        ["rep"], q)
    want = JAligner(jmesh(1, 8), jidx, JAlignerConfig(batch_pad=4096)).map_batch(["rep"], q)
    single = MinimizerAligner(_index(jidx), cfg, device="cpu").map_batch(["rep"], q)
    assert got and _lines(got) == _lines(want)
    assert _lines(single) != _lines(got)


def test_sharded_aligner_refuses_too_many_sequences_in_a_shard(monkeypatch):
    from hymet_tpu_torch.parallel import align as palign

    monkeypatch.setattr(palign, "SEQ_BITS", 2)  # 4 sequences a shard at most
    rng = np.random.default_rng(3)
    idx = MinimizerIndex.build([(f"s{i}", _rand_seq(rng, 200)) for i in range(9)], device="cpu")
    with pytest.raises(ValueError, match="use more db shards"):
        ShardedMinimizerAligner(make_mesh(1, 2, devices=["cpu"] * 2), idx)
    assert ShardedMinimizerAligner(make_mesh(1, 4, devices=["cpu"] * 4), idx).shards


def test_sharded_aligner_overflow_retries_match_jax(align_world, monkeypatch):
    """Caps far too small for every shard: each overflow doubles the shared
    sticky boost and reruns every shard, and the records still equal the
    JAX sharded aligner's."""
    jidx, genomes = align_world
    names, seqs = _queries(genomes)
    names, seqs = names + ["q3"], seqs + [genomes["chr1"][3000:8000]]  # 2 chains in shard 0
    monkeypatch.setattr(ShardedMinimizerAligner, "_caps", lambda self, B, L: (
        64 * self._cap_boost, 64 * self._acap_boost, self._ccap_boost))
    aligner = ShardedMinimizerAligner(make_mesh(2, 4, devices=CPU8), _index(jidx))
    got = aligner.map_batch(names, seqs)
    want = JAligner(jmesh(2, 4), jidx).map_batch(names, seqs)
    assert got and _lines(got) == _lines(want)
    assert min(aligner._cap_boost, aligner._acap_boost, aligner._ccap_boost) >= 2
