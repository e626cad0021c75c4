"""The port's bench sketch path against the JAX package's on the CPU:
``sketch_batch_topk`` candidates element for element (ties included),
``finish_bottom_sketch`` sketches, counts and warnings row for row, and,
where no row warns, the finished sketch equal to the port's exact
``sketch_codes_torch`` bottom sketch."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hymet_tpu.ops import sketch as jsketch
from hymet_tpu_torch.ops import sketch as tsketch
from hymet_tpu_torch.ops.hashing import kmer_hashes_numpy
from hymet_tpu_torch.ops.sketch_kernels import sketch_codes_torch

torch.set_num_threads(1)

KS = (15, 21, 31)
L = 3000
WARN_ROWS = [3, 4]  # the rows of _rows whose candidate pools saturate


def _distinct(row: np.ndarray, k: int) -> int:
    return int(np.unique(kmer_hashes_numpy(row, k)).size)


def _rows(seed: int, k: int):
    """[5, L] code rows and a sketch size s: random; random with N runs;
    mostly N (fewer valid windows than the candidate pool); one repeated
    k-mer (poly-A: a full pool of one hash); a tandem repeat of s bases
    (each of its s distinct k-mers about 30 times, so a full pool holds
    fewer than s)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4, size=(5, L)).astype(np.uint8)
    for start in (100, 640, 1999):
        rows[1, start : start + int(rng.integers(1, 60))] = 4
    rows[2, 80:] = 4
    rows[3] = 0
    unit = rng.integers(0, 4, size=97).astype(np.uint8)
    rows[4] = np.tile(unit, -(-L // unit.size))[:L]
    s = _distinct(rows[4], k)
    return rows, s


def _jax_topk(codes: np.ndarray, k: int, cand: int):
    hi, lo = jsketch.sketch_batch_topk(jnp.asarray(codes), k, cand)
    return np.asarray(hi).astype(np.int64), np.asarray(lo).astype(np.int64)


def _port_topk(codes: np.ndarray, k: int, cand: int, **kw):
    hi, lo = tsketch.sketch_batch_topk(torch.from_numpy(codes), k, cand, **kw)
    return hi.numpy(), lo.numpy()


def _finish(fn, hi, lo, s):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out, n = fn(hi, lo, s)
    return out, n, [(w.category, str(w.message)) for w in rec]


@pytest.mark.parametrize("k", KS)
def test_topk_candidates_match_jax(k):
    rows, s = _rows(k, k)
    cand = 2 * s + 56
    want = _jax_topk(rows, k, cand)
    got = _port_topk(rows, k, cand)
    assert got[0].shape == want[0].shape == (5, cand)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0][2, 81 - k :] == 0xFFFFFFFF).all()  # invalid windows sort last


@pytest.mark.parametrize("k", KS)
def test_finish_matches_jax_and_warns_on_the_same_rows(k):
    rows, s = _rows(k, k)
    cand = 2 * s + 56
    jhi, jlo = _jax_topk(rows, k, cand)
    want = _finish(jsketch.finish_bottom_sketch, jhi.astype(np.uint32), jlo.astype(np.uint32), s)
    got = _finish(tsketch.finish_bottom_sketch, *_port_topk(rows, k, cand), s)
    assert got[0].dtype == want[0].dtype == np.uint64 and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == [(RuntimeWarning, (
        f"sketch_batch_topk candidate pool saturated for rows {WARN_ROWS}; rerun those rows "
        "with the exact sort path or a larger cand"))]
    assert got[1][3] == 1 and got[1][4] < s


@pytest.mark.parametrize("k", KS)
def test_finish_equals_exact_sketch_where_no_row_warns(k):
    """Rows 0-2 (no saturated pool): the finished candidates are the exact
    bottom-s distinct sketch."""
    rows, s = _rows(k, k)
    rows = np.ascontiguousarray(rows[:3])
    out, n, rec = _finish(tsketch.finish_bottom_sketch, *_port_topk(rows, k, 2 * s + 56), s)
    assert rec == []
    want_h, want_n = sketch_codes_torch(torch.from_numpy(rows), k, s)
    np.testing.assert_array_equal(out.view(np.int64), want_h.numpy())
    np.testing.assert_array_equal(n, want_n.numpy())
    assert n[2] < s  # the mostly-N row has fewer than s distinct k-mers


def test_rows_shorter_than_the_pool():
    """Fewer windows than `cand`: the candidates are every window."""
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 4, size=(3, 140)).astype(np.uint8)
    rows[1, 60:70] = 4
    rows[2] = 4
    want = _jax_topk(rows, 21, 300)
    got = _port_topk(rows, 21, 300)
    assert got[0].shape == (3, 120)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    j = _finish(jsketch.finish_bottom_sketch, want[0].astype(np.uint32),
                want[1].astype(np.uint32), 50)
    t = _finish(tsketch.finish_bottom_sketch, *got, 50)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    assert t[2] == j[2] == [] and t[1].tolist() == [50, 50, 0]
    # every window in the pool and s its distinct count: the s-th hash is
    # the pool's last (a high-limb tie at the cutoff) in the full row 0
    s = _distinct(rows[0], 21)
    j = _finish(jsketch.finish_bottom_sketch, want[0].astype(np.uint32),
                want[1].astype(np.uint32), s)
    t = _finish(tsketch.finish_bottom_sketch, *got, s)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[2] == j[2] and "rows [0];" in t[2][0][1]


def test_high_limb_ties_keep_window_order(monkeypatch):
    """Crafted window hashes through both selections (JAX's top_k via its
    hash function, the port's stable sort via ``hash_fn``): equal high
    limbs with other low limbs across the cutoff, valid hashes whose high
    limb is 0xFFFFFFFF among invalid windows, and a cutoff inside that
    group. The lower window index comes first in both."""
    rng = np.random.default_rng(3)
    n, cand = 777, 40
    hi = rng.integers(1 << 20, 1 << 32, size=(3, n), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=(3, n), dtype=np.uint64).astype(np.uint32)
    valid = np.ones((3, n), bool)
    # row 0: 60 windows share the 10th smallest high limb (cut by cand)
    hi[0, rng.choice(n, 60, replace=False)] = 5
    hi[0, rng.choice(n, 9, replace=False)] = 1
    # row 1: most windows invalid; valid ones with high limb 0xFFFFFFFF
    # interleaved with them; the pool ends inside that group
    valid[1] = False
    valid[1, :20] = True
    hi[1, :20] = 7
    ff = np.arange(30, n, 7)
    valid[1, ff] = True
    hi[1, ff] = 0xFFFFFFFF
    # row 2: a duplicated hash and a tie at the s-th place
    hi[2, :100], lo[2, :100] = 3, 9
    hi[2, 100:150] = 4
    h64 = ((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)).view(np.int64)

    codes = np.zeros((3, n + 20), np.uint8)  # a shape no other test traces
    monkeypatch.setattr(jsketch, "kmer_hashes_jax",
                        lambda c, k: (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid)))
    want = _jax_topk(codes, 21, cand)
    got = _port_topk(codes, 21, cand,
                     hash_fn=lambda c, k: (torch.from_numpy(h64), torch.from_numpy(valid)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0][1, 20:] == 0xFFFFFFFF).all() and (got[1][1, 20:] != 0xFFFFFFFF).any()
    for s in (5, 12, 30):
        j = _finish(jsketch.finish_bottom_sketch, want[0].astype(np.uint32),
                    want[1].astype(np.uint32), s)
        t = _finish(tsketch.finish_bottom_sketch, *got, s)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        assert t[2] == j[2]
    assert t[2]  # at s = 30 the s-th hash ties the pool's last high limb
