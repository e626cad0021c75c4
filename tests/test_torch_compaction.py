"""hymet_tpu_torch slot compaction vs the JAX package's default members:
searchsorted_right, slot_compact_map, slot_fill_mono, slot_fill_delta."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hymet_tpu.ops import compaction as jc
from hymet_tpu_torch.ops import compaction as tc

torch.set_num_threads(1)


def _occ(seed: int, n: int, empty_share: float) -> np.ndarray:
    """Per-row item counts 0..16 with runs of empty rows (first and last
    rows empty in some cases)."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(1, 17, n).astype(np.int32)
    occ[rng.random(n) < empty_share] = 0
    if seed % 2:
        occ[:3] = 0
        occ[-2:] = 0
    return occ


CASES = [(0, 200, 0.5, 300), (1, 200, 0.5, 5000), (2, 50, 0.9, 64), (3, 1000, 0.0, 2048), (4, 30, 1.0, 16)]


@pytest.mark.parametrize("seed,n,empty,cap", CASES)
def test_searchsorted_right_matches_jax(seed, n, empty, cap):
    arr = np.sort(np.random.default_rng(seed).integers(0, 500, n)).astype(np.int32)
    q = np.arange(-3, 510, dtype=np.int32)
    want = np.asarray(jc.searchsorted_right(jnp.asarray(arr), jnp.asarray(q)))
    got = tc.searchsorted_right(torch.from_numpy(arr), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,n,empty,cap", CASES)
def test_slot_compact_map_matches_jax(seed, n, empty, cap):
    """Every slot equals the JAX "bsearch" method's; the "scatter"
    method's agrees on the valid slots (its padding slots differ by
    design, and callers mask them)."""
    occ = _occ(seed, n, empty)
    n_i, basex, n_items = tc.slot_compact_map(torch.from_numpy(occ), cap)
    assert int(n_items) == occ.sum()
    for method in ("bsearch", "scatter"):
        j_ni, j_basex, j_items = (np.asarray(x) for x in jc.slot_compact_map(jnp.asarray(occ), cap, method))
        np.testing.assert_array_equal(basex.numpy(), j_basex)
        assert int(j_items) == int(n_items)
        valid = min(int(n_items), cap)
        upto = cap if method == "bsearch" else valid
        np.testing.assert_array_equal(n_i.numpy()[:upto], j_ni[:upto])


@pytest.mark.parametrize("seed,n,empty,cap", CASES)
def test_slot_fills_match_jax(seed, n, empty, cap):
    """Every slot, padding included: a non-decreasing packed value by
    running max, and an arbitrary int32 (negative and near the int32
    limits) by delta cumsum."""
    occ = _occ(seed, n, empty)
    rng = np.random.default_rng(seed + 100)
    basex = (np.cumsum(occ) - occ).astype(np.int32)
    occupied = occ > 0
    mono = np.sort(rng.integers(0, 2**32, n, dtype=np.uint64)).astype(np.uint32)
    vals = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    want_m = np.asarray(jc.slot_fill_mono(jnp.asarray(mono), jnp.asarray(basex), jnp.asarray(occupied), cap))
    want_d = np.asarray(jc.slot_fill_delta(jnp.asarray(vals), jnp.asarray(basex), jnp.asarray(occupied), cap))
    got_m = tc.slot_fill_mono(torch.from_numpy(mono.astype(np.int64)), torch.from_numpy(basex),
                              torch.from_numpy(occupied), cap)
    got_d = tc.slot_fill_delta(torch.from_numpy(vals), torch.from_numpy(basex), torch.from_numpy(occupied), cap)
    np.testing.assert_array_equal(got_m.numpy(), want_m.astype(np.int64))
    assert got_d.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), want_d)
