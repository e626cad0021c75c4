"""hymet_tpu_torch screen engine vs the JAX package's ScreenEngine on the
CPU: flat index, counts, identity (float32 bit-identical), shared, median,
query k-mer total and p-values; and the plain version of the screen_count
kernel against the JAX engine's staged update, count for count."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hymet_tpu.io.sketchdb import SketchDB as JDB
from hymet_tpu.io.sketchdb import build_sketch_db_from_sequences
from hymet_tpu.ops import sketch as jsketch
from hymet_tpu_torch.io.sketchdb import SketchDB as TDB
from hymet_tpu_torch.io.sketchdb import load_sketch_db
from hymet_tpu_torch.ops import sketch as tsketch
from hymet_tpu_torch.ops.hash_kernels import screen_count_torch
from hymet_tpu_torch.ops.hashing import kmer_hashes_numpy

torch.set_num_threads(1)

WORLD = os.path.join(os.path.dirname(__file__), "..", "validation", "work_cami_suite")


def _as_port(db: JDB) -> TDB:
    return TDB(k=db.k, sketch_size=db.sketch_size, hashes=db.hashes, n_hashes=db.n_hashes,
               names=list(db.names), lengths=db.lengths, comments=list(db.comments))


def _world(seed: int, k: int = 21, s: int = 64):
    """A small DB (8 random genomes of 2-6 kbp, bottom-s sketches) and query
    code rows holding pieces of some genomes, random DNA and N runs."""
    rng = np.random.default_rng(seed)
    genomes = [
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(rng.integers(2000, 6000)))].tobytes()
        for _ in range(8)
    ]
    db = build_sketch_db_from_sequences(
        [(f"ref{i}", g) for i, g in enumerate(genomes)], k=k, sketch_size=s
    )
    lut = np.full(256, 4, np.uint8)
    lut[list(b"ACGT")] = np.arange(4, dtype=np.uint8)
    rows = np.full((5, 4000), 4, np.uint8)
    for r in range(5):
        g = genomes[r % 3]
        piece = lut[np.frombuffer(g[: 1000 + 400 * r], np.uint8)]
        rows[r, : piece.size] = piece
        rows[r, piece.size : piece.size + 900] = rng.integers(0, 4, 900)
        rows[r, 200 + r : 230 + r] = 4
    return db, rows


def _jax_engine(db, rows, staged):
    eng = jsketch.ScreenEngine(db)
    if staged:
        from hymet_tpu.io.fasta import pack_code_batch

        p, m, L = pack_code_batch(rows)
        eng.update_staged(jnp.asarray(p), jnp.asarray(m), L)
    else:
        eng.update_codes_packed(rows)
    return eng.finalize()


def _port_engine(db, rows, staged, count_fn=None):
    kw = {"count_fn": count_fn} if count_fn else {}
    eng = tsketch.ScreenEngine(_as_port(db), device="cpu", **kw)
    if staged:
        from hymet_tpu_torch.io.fasta import pack_code_batch

        p, m, L = pack_code_batch(rows)
        eng.update_staged(torch.from_numpy(p), torch.from_numpy(m), L)
    else:
        eng.update_codes_packed(rows)
    return eng.finalize()


def _assert_same_result(a, b):
    assert a.identity.dtype == b.identity.dtype == np.float32
    np.testing.assert_array_equal(a.identity.view(np.uint32), b.identity.view(np.uint32))
    np.testing.assert_array_equal(a.shared, b.shared)
    np.testing.assert_array_equal(a.median, b.median)
    assert a.total_query_kmers == b.total_query_kmers
    np.testing.assert_array_equal(a.pvalues(), b.pvalues())
    assert a.rows() == b.rows()


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_screen_engine_matches_jax(seed, staged):
    db, rows = _world(seed)
    ref = _jax_engine(db, rows, staged)
    got = _port_engine(db, rows, staged)
    assert (got.shared > 0).sum() >= 3  # the world really exercises hits
    _assert_same_result(got, ref)


def test_screen_engine_hash_fn_is_used():
    """The engine's test seam (``count_fn``, which took the place of the
    hash seam ``hash_fn``) receives every batch, with the engine's flat
    keys, threshold, counts and total."""
    db, rows = _world(2)
    calls = []

    def counting(packed, mask, L, k, flat, t, counts, total):
        calls.append((tuple(packed.shape), tuple(mask.shape), L, k, t == int(flat[-1])))
        return screen_count_torch(packed, mask, L, k, flat, t, counts, total)

    _assert_same_result(_port_engine(db, rows, True, counting), _port_engine(db, rows, True))
    W = -(-rows.shape[1] // 8) * 2
    assert calls == [((rows.shape[0], W), (rows.shape[0], W // 2), rows.shape[1], 21, True)]


def _staged_batch(seed: int, k: int):
    """Seeded code rows as a staged batch holds them: N runs (two of them
    on a 32-window run boundary), a short contig in a padded row, an
    all-padding row; L not a multiple of 8."""
    rng = np.random.default_rng(seed)
    L = 1003
    rows = rng.integers(0, 4, size=(6, L), dtype=np.uint8)
    rows[0, 31:33] = 4
    rows[1, 64] = 4
    rows[2, 500:520] = 4
    rows[3, 300:] = 4  # a short contig, then padding
    rows[4] = 4  # all padding
    rows[5, rng.integers(0, L, 12)] = 4
    return rows


@pytest.mark.parametrize("k", [21, 32])
@pytest.mark.parametrize("case", ["db", "all_survive", "none_survive"])
def test_screen_count_plain_matches_jax_update_staged(case, k):
    """screen_count_torch against the JAX engine's update_staged on one
    packed batch: counts over the flat keys and the valid-window total,
    equal element for element. "all_survive": the DB's largest hash is
    2^64 - 2, the largest a DB can hold (2^64 - 1 pads), so every valid
    window passes the threshold; "none_survive": the DB holds only hashes
    below every query hash."""
    from hymet_tpu.io.fasta import pack_code_batch

    rows = _staged_batch(k, k)
    rng = np.random.default_rng(k + 1)
    if case == "none_survive":
        hashes = np.arange(1, 9, dtype=np.uint64).reshape(2, 4)
    else:
        q = np.concatenate([kmer_hashes_numpy(r, k) for r in rows])
        hashes = np.sort(
            np.concatenate([rng.choice(q, 60, replace=False),
                            rng.integers(0, 2**63, 4, dtype=np.uint64)])
        ).reshape(4, 16)
        if case == "all_survive":
            hashes[-1, -1] = np.uint64(2**64 - 2)
    db = JDB(k=k, sketch_size=hashes.shape[1], hashes=hashes,
             n_hashes=np.full(hashes.shape[0], hashes.shape[1], np.int32),
             names=[f"r{i}" for i in range(hashes.shape[0])],
             lengths=np.zeros(hashes.shape[0], np.int64), comments=[""] * hashes.shape[0])
    packed, mask, L = pack_code_batch(rows)
    jeng = jsketch.ScreenEngine(db)
    jeng.update_staged(jnp.asarray(packed), jnp.asarray(mask), L)
    want_counts = np.asarray(jeng.counts)
    want_total = jeng.finalize().total_query_kmers

    flat, _ = tsketch.flat_index_device(db.hashes, torch.device("cpu"))
    counts = torch.zeros(flat.shape[0], dtype=torch.int32)
    total = torch.zeros(1, dtype=torch.int64)
    screen_count_torch(torch.from_numpy(packed), torch.from_numpy(mask), L, k, flat,
                       int(flat[-1]), counts, total)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert int(total) == want_total > 0
    if case == "none_survive":
        assert not want_counts.any()
    else:
        assert want_counts.sum() >= 30  # the sampled query hashes are found


def test_screen_engine_empty_db():
    """A DB with no real hash: the engine still counts the query's valid
    windows (as the JAX engine does) and scores every reference 0. The
    JAX engine's finalize raises on its empty gather here, so only the
    k-mer count is compared with it."""
    db = JDB(k=21, sketch_size=4, hashes=np.full((2, 4), 0xFFFFFFFFFFFFFFFF, np.uint64),
             n_hashes=np.zeros(2, np.int32), names=["a", "b"],
             lengths=np.zeros(2, np.int64), comments=["", ""])
    _, rows = _world(3)
    jeng = jsketch.ScreenEngine(db)
    jeng.update_codes_packed(rows)
    got = _port_engine(db, rows, False)
    assert got.total_query_kmers == jeng.total_query_kmers > 0
    assert not got.shared.any() and not got.median.any() and not got.identity.any()
    with pytest.raises(ValueError):
        _port_engine(db, rows, True)


def _score_pairs():
    """(shared, n_hashes) pairs: every shared count at the sketch size
    n_hashes = 1000, every n_hashes at shared = n_hashes, and a seeded
    sample of the rest of shared <= n_hashes <= 1000."""
    rng = np.random.default_rng(0)
    n = np.concatenate([np.full(1001, 1000), np.arange(1, 1001), rng.integers(1, 1001, 6000)])
    s = np.concatenate([np.arange(1001), np.arange(1, 1001), np.zeros(6000, np.int64)])
    s[2001:] = rng.integers(0, n[2001:] + 1)
    return s.astype(np.int32), n.astype(np.int32)


@pytest.mark.parametrize("k", [15, 21, 32])
def test_identity_bit_identical_to_jax(k):
    """One reference per (shared, n_hashes) pair: identity, shared and
    median equal the JAX package's, identity bit for bit."""
    s, n = _score_pairs()
    cols = np.arange(1000)[None, :]
    ref_idx = np.full((n.size, 1000), -1, np.int32)
    ref_idx[cols < s[:, None]] = 0
    ref_idx[(cols >= s[:, None]) & (cols < n[:, None])] = 1
    counts = np.array([3, 0], np.int32)
    want = jsketch.screen_scores(jnp.asarray(counts), jnp.asarray(ref_idx), jnp.asarray(n), k)
    got = tsketch.screen_scores(
        torch.from_numpy(counts), torch.from_numpy(ref_idx), torch.from_numpy(n), k
    )
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_flat_index_device_matches_sketchdb():
    jdbs = [JDB.load(os.path.join(WORLD, f"sketch{i}.npz")) for i in (1, 2, 3)]
    merged = JDB.concat(jdbs)
    flat, ref_idx = merged.flat_index()
    keys, idx = tsketch.flat_index_device(merged.hashes, torch.device("cpu"))
    np.testing.assert_array_equal((keys ^ (-(1 << 63))).numpy().view(np.uint64), flat)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    tflat, tidx = _as_port(merged).flat_index()
    np.testing.assert_array_equal(tflat, flat)
    np.testing.assert_array_equal(tidx, ref_idx)


def test_sketchdb_roundtrip_and_concat(tmp_path):
    jdbs = [JDB.load(os.path.join(WORLD, f"sketch{i}.npz")) for i in (1, 2)]
    tdbs = [load_sketch_db(os.path.join(WORLD, f"sketch{i}.npz")) for i in (1, 2)]
    for j, t in zip(jdbs, tdbs):
        assert (t.k, t.sketch_size, t.names, t.comments) == (j.k, j.sketch_size, j.names, j.comments)
        np.testing.assert_array_equal(t.hashes, j.hashes)
    merged_t, merged_j = TDB.concat(tdbs), JDB.concat(jdbs)
    np.testing.assert_array_equal(merged_t.hashes, merged_j.hashes)
    np.testing.assert_array_equal(merged_t.n_hashes, merged_j.n_hashes)
    assert merged_t.names == merged_j.names
    path = str(tmp_path / "m.npz")
    merged_t.save(path)
    back = JDB.load(path)
    np.testing.assert_array_equal(back.hashes, merged_j.hashes)
    assert back.names == merged_j.names and back.k == merged_j.k
    # a .msh the JAX package wrote loads as the same DB
    merged_j.to_msh(str(tmp_path / "m.msh"))
    from_msh = load_sketch_db(str(tmp_path / "m.msh"))
    np.testing.assert_array_equal(from_msh.hashes, merged_j.hashes)
    np.testing.assert_array_equal(from_msh.n_hashes, merged_j.n_hashes)
    np.testing.assert_array_equal(from_msh.lengths, merged_j.lengths)
    assert (from_msh.k, from_msh.sketch_size, from_msh.names) == (merged_j.k, merged_j.sketch_size,
                                                                  merged_j.names)


@pytest.mark.parametrize("x,n,p", [(0, 10, 0.5), (3, 10, 0.0), (3, 10, 1.0), (7, 1000, 1e-3), (400, 1000, 0.37)])
def test_binom_sf_matches_reference(x, n, p):
    assert tsketch.binom_sf(x, n, p) == jsketch.binom_sf(x, n, p)
