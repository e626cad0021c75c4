"""The port's ScreenEngine entry points that the bench uses, against the
JAX package's ScreenEngine on the CPU: ``update_codes`` (a code batch on
the engine's device, packed there), ``update`` (the JAX engine's uint32
hash limbs) and ``track_kmers=False``; counts, finalize() rows and the
query k-mer total equal, the empty-DB path included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hymet_tpu.io.sketchdb import PAD_HASH
from hymet_tpu.io.sketchdb import SketchDB as JDB
from hymet_tpu.ops import sketch as jsketch
from hymet_tpu.ops.hashing import kmer_hashes_jax
from hymet_tpu_torch.ops import sketch as tsketch
from test_torch_sketch import _as_port, _assert_same_result, _world

torch.set_num_threads(1)


def _limbs(rows: np.ndarray, k: int):
    hi, lo, valid = kmer_hashes_jax(jnp.asarray(rows), k)
    return np.array(hi), np.array(lo), np.array(valid)


def _engines(db, track_kmers):
    return (jsketch.ScreenEngine(db, track_kmers=track_kmers),
            tsketch.ScreenEngine(_as_port(db), device="cpu", track_kmers=track_kmers))


def _same_counts(jeng, teng):
    np.testing.assert_array_equal(teng.counts.numpy(), np.asarray(jeng.counts))


@pytest.mark.parametrize("track_kmers", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_codes_matches_jax(seed, track_kmers):
    db, rows = _world(seed)
    jeng, teng = _engines(db, track_kmers)
    for part in (rows[:2], rows[2:]):
        jeng.update_codes(jnp.asarray(part))
        teng.update_codes(torch.from_numpy(np.ascontiguousarray(part)))
    _same_counts(jeng, teng)
    want, got = jeng.finalize(), teng.finalize()
    assert (got.shared > 0).sum() >= 3
    _assert_same_result(got, want)
    assert (got.total_query_kmers > 0) == track_kmers


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("track_kmers", [True, False])
def test_update_limbs_matches_jax(track_kmers, as_tensor):
    db, rows = _world(2)
    jeng, teng = _engines(db, track_kmers)
    hi, lo, valid = _limbs(rows, db.k)
    jeng.update(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    if as_tensor:  # the limbs' bit patterns in int32 tensors
        teng.update(torch.from_numpy(hi.view(np.int32)), torch.from_numpy(lo.view(np.int32)),
                    torch.from_numpy(valid))
    else:
        teng.update(hi, lo, valid)
    _same_counts(jeng, teng)
    _assert_same_result(teng.finalize(), jeng.finalize())


def test_mixed_updates_match_jax():
    """update_codes, update and update_codes_packed into one engine each,
    in the same order."""
    db, rows = _world(3)
    jeng, teng = _engines(db, True)
    jeng.update_codes(jnp.asarray(rows[:1]))
    teng.update_codes(torch.from_numpy(np.ascontiguousarray(rows[:1])))
    hi, lo, valid = _limbs(rows[1:3], db.k)
    jeng.update(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    teng.update(hi, lo, valid)
    jeng.update_codes_packed(rows[3:])
    teng.update_codes_packed(rows[3:])
    jeng.update_codes(jnp.asarray(rows))
    teng.update_codes(torch.from_numpy(rows))
    _same_counts(jeng, teng)
    _assert_same_result(teng.finalize(), jeng.finalize())


@pytest.mark.parametrize("track_kmers", [True, False])
def test_empty_db_counts_query_kmers_like_jax(track_kmers):
    """A DB with no real hash: nothing to count, the valid windows still
    totalled (the JAX engine's host count), or not at all without
    track_kmers. (The JAX finalize raises on such a DB, ROADMAP C4; its
    running total is compared.)"""
    _, rows = _world(4)
    db = JDB(k=21, sketch_size=8, hashes=np.full((2, 8), PAD_HASH, np.uint64),
             n_hashes=np.zeros(2, np.int32), names=["a", "b"],
             lengths=np.zeros(2, np.int64), comments=["", ""])
    jeng, teng = _engines(db, track_kmers)
    hi, lo, valid = _limbs(rows[:2], db.k)
    jeng.update_codes(jnp.asarray(rows))
    teng.update_codes(torch.from_numpy(rows))
    jeng.update(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    teng.update(hi, lo, valid)
    jeng.update_codes_packed(rows[2:])
    teng.update_codes_packed(rows[2:])
    got = teng.finalize()
    assert got.total_query_kmers == jeng.total_query_kmers
    assert (got.total_query_kmers > 0) == track_kmers
    assert got.shared.tolist() == [0, 0]
