"""Sorted anchors and the bucket-confined index search: hymet_tpu_torch's
plain versions against the JAX package's.

- ``sorted_anchors_torch`` (the plain version of the ``anchors`` kernel:
  anchors in emission order, then the stable sort) against
  ``_collect_anchors_slots``' default branch, every [acap] key and the
  valid qpos and rpos bit for bit, n_anchors equal, on the anchor edge sets
  (``chip_smoke.anchor_edge_sets``: runs of equal keys over several sort
  tiles, rows without anchors first, in the middle and last, no anchor at
  all, overflow, a 43-bit compact key at band_bits 1, the band at its
  extremes).
- ``bucket_search_torch`` (the plain twin of the kernel's search, confined
  to the bucket of the hash's top bits) against ``_search_occ`` (a search
  of all U): (left, occ) equal on hashes at bucket edges, at three k.

The card tests hold the kernel to ``sorted_anchors_torch`` on the same sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hymet_tpu.models import aligner as jal
from hymet_tpu_torch.models import aligner as tal
from hymet_tpu_torch.ops import align_kernels as ak

torch.set_num_threads(1)

SETS = {name: rest for name, *rest in chip_smoke.anchor_edge_sets()}
_JAX_COLLECT = jax.jit(jal._collect_anchors_slots, static_argnames=("max_occ", "band_bits", "acap"))
_JAX_SEARCH = jax.jit(jal._search_occ)


@pytest.mark.parametrize("name", list(SETS))
def test_sorted_anchors_match_jax(name):
    genomes, codes, band_bits, acap = SETS[name]
    index, tables, mz, B, L = chip_smoke.anchor_inputs(genomes, codes)
    hash_, pos, strand, rows, n_kept = mz
    key, qpos, rpos, n_anchors = ak.sorted_anchors_torch(*mz, tables, chip_smoke.MAX_OCC,
                                                         band_bits, acap, B, L)
    hl, roff2, ps = jal.build_search_tables(index.hashes, index.seq_id, index.pos, index.strand)[:3]
    q = hash_.numpy().view(np.uint64)
    valid = np.arange(q.shape[0]) < int(n_kept)
    s_k1, s_k2, s_p, s_r, j_anchors = (np.asarray(x) for x in _JAX_COLLECT(
        jnp.asarray(hl), jnp.asarray(roff2), jnp.asarray(ps),
        jnp.asarray((q >> np.uint64(32)).astype(np.uint32)), jnp.asarray(q.astype(np.uint32)),
        jnp.asarray(pos.numpy()), jnp.asarray(strand.numpy().astype(np.int32)),
        jnp.asarray(rows.numpy()), jnp.asarray(valid), max_occ=chip_smoke.MAX_OCC,
        band_bits=band_bits, acap=acap))
    n = int(n_anchors)
    assert n == int(j_anchors)
    want = ((s_k1.astype(np.uint64) << np.uint64(32)) | s_k2) ^ np.uint64(1 << 63)
    np.testing.assert_array_equal(key.numpy().view(np.uint64), want)
    filled = min(n, acap)
    np.testing.assert_array_equal(qpos.numpy()[:filled].astype(np.uint32), s_p[:filled])
    np.testing.assert_array_equal(rpos.numpy()[:filled].astype(np.uint32), s_r[:filled])
    assert not qpos[filled:].any() and not rpos[filled:].any()
    # what each set is for
    expect = {"no_anchors": n == 0, "overflow": n > acap,
              "many_short_refs": ak.sort_layout(tables, B, L, band_bits).bits > 32,
              "all_ties": filled > 3 * 4096 and int((key[1:filled] == key[: filled - 1]).sum()) > filled // 2}
    assert expect.get(name, 0 < n <= acap)


def _edge_world(k: int, U: int, seed: int):
    """Sorted unique 2k-bit hashes whose table (at about one entry a
    bucket) has empty buckets and buckets of one entry, each bucket's
    first and last entry present; their run offsets; and query hashes: every
    entry, each entry +- 1, each bucket's first and last possible hash, 0,
    2^2k - 1, and hashes above every 2k-bit hash."""
    rng = np.random.default_rng(seed)
    top = 1 << (2 * k)
    bits = min(2 * k, tal.BUCKET_BITS_MAX, max(1, int(np.ceil(np.log2(U + 1)))))
    shift = 2 * k - bits
    # crowd the entries into a third of the buckets: the rest are empty
    buckets = rng.choice(1 << bits, size=max(1, (1 << bits) // 3), replace=False)
    picks = set()
    while len(picks) < U:
        t = int(rng.choice(buckets))
        picks.add((t << shift) + int(rng.integers(0, 1 << shift)))
    uniq = np.array(sorted(picks), dtype=np.uint64)
    runs = rng.integers(1, 20, U)
    starts = np.concatenate([[0], np.cumsum(runs)[:-1]])
    roff = np.stack([starts, starts + runs], axis=1).astype(np.int32)
    t = np.arange(1 << bits, dtype=np.uint64) << np.uint64(shift)
    edges = np.concatenate([t, t + np.uint64((1 << shift) - 1)])
    far = [x for x in (0, top - 1, top, top + 12345, 2**63, 2**64 - 1) if x < 2**64]
    q = np.concatenate([uniq, uniq + np.uint64(1), uniq - np.uint64(1), edges,
                        np.array(far, np.uint64)])
    return uniq.view(np.int64), roff, q.view(np.int64)


@pytest.mark.parametrize("k, U", [(5, 1), (5, 2), (5, 200), (19, 1), (19, 2), (19, 300),
                                  (19, 5000), (32, 1), (32, 300), (32, 5000)])
def test_bucket_search_matches_jax(k, U):
    uniq, roff, q = _edge_world(k, U, seed=k * 1000 + U)
    bucket, shift = tal.build_bucket_table(uniq, k)
    n_buckets = bucket.shape[0] - 2
    assert n_buckets == 1 << (2 * k - shift) and bucket[-2] == bucket[-1] == U
    sizes = np.diff(bucket[:-1])
    if U >= 200:  # the world has empty buckets and buckets of one entry
        assert (sizes == 0).any() and (sizes == 1).any()
    left, occ = ak.bucket_search_torch(torch.from_numpy(q), torch.from_numpy(uniq),
                                       torch.from_numpy(roff), torch.from_numpy(bucket), shift)
    u = uniq.view(np.uint64)
    hl = np.stack([(u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32)], axis=1)
    qu = q.view(np.uint64)
    j_left, j_occ = (np.asarray(x) for x in _JAX_SEARCH(
        jnp.asarray(hl), jnp.asarray(roff), jnp.asarray((qu >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(qu.astype(np.uint32))))
    np.testing.assert_array_equal(left.numpy(), j_left)
    np.testing.assert_array_equal(occ.numpy(), j_occ)
    np.testing.assert_array_equal(occ.numpy() > 0, np.isin(q, uniq))  # entries, nothing else


def test_bucket_table_of_an_index_confines_the_search():
    """On an index's own hashes (2k = 38 bits) the table spreads the
    entries: about one a bucket, none over 31 (a search of at most 5
    steps; the JAX package's table on the 64-bit word puts every entry in
    bucket 0)."""
    genomes, *_ = SETS["many_short_refs"]
    index, tables, *_ = chip_smoke.anchor_inputs(genomes, SETS["many_short_refs"][1][:1])
    U = tables.uniq.numel()
    bucket, shift = tal.build_bucket_table(tables.uniq.numpy(), index.k)
    assert np.array_equal(bucket, tables.bucket.numpy()) and shift == tables.shift
    sizes = np.diff(bucket[:-1])
    assert sizes.sum() == U and 0.5 < U / sizes.size <= 1 and sizes.max() <= 31
    assert jal.build_search_tables(index.hashes, index.seq_id, index.pos, index.strand)[3][0, 1] == U


@pytest.mark.parametrize("name", ["all_ties", "many_short_refs"])
def test_anchors_wrapper_on_cpu_is_the_plain_version(name):
    genomes, codes, band_bits, acap = SETS[name]
    _index, tables, mz, B, L = chip_smoke.anchor_inputs(genomes, codes)
    before = ak.anchors.launches
    got = ak.anchors(*mz, tables, chip_smoke.MAX_OCC, band_bits, acap, B, L)
    want = ak.sorted_anchors_torch(*mz, tables, chip_smoke.MAX_OCC, band_bits, acap, B, L)
    assert ak.anchors.launches == before
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
