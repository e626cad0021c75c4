"""hymet_tpu_torch.ops.lca against hymet_tpu.ops.lca: the plain version
``weighted_lca_torch`` against the jitted JAX ``weighted_lca`` (float64,
x64 on) at every bucket size, names and depths equal and confidences
equal bit for bit, on chip_smoke's edge sets (ties on purpose, -1 rows,
all-zero rank rows, queries with no rank-0 name); ``bucket_pad`` and
``weighted_lca_host`` equal; the wrapper's dispatch and checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hymet_tpu.ops import lca as jlca
from hymet_tpu_torch.ops import lca

torch.set_num_threads(1)

SETS = {(seed, name): s for seed in (0, 1)
        for name, *s in chip_smoke.lca_edge_sets(seed, big_q=4)}


def _jax(rows, w, table):
    out = jlca.weighted_lca(jnp.asarray(rows), jnp.asarray(w), jnp.asarray(table), dtype=jnp.float64)
    return [np.asarray(x) for x in out]


def _torch(rows, w, table):
    out = lca.weighted_lca_torch(*map(torch.from_numpy, (rows, w, table)))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("seed,name", list(SETS))
def test_plain_lca_matches_jax_bit_for_bit(seed, name):
    rows, w, table = SETS[seed, name]
    jc, jn, jconf = _jax(rows, w, table)
    tc, tn, tconf = _torch(rows, w, table)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    assert tconf.dtype == np.float64
    np.testing.assert_array_equal(tconf.view(np.int64), jconf.view(np.int64))
    assert set(jn.tolist()) >= {0, 8}  # stops at rank 0 and full depth both occur
    assert (jconf < 1).any()  # confidences that carry the sums' bits


def _hit_order(rows, w, table):
    """The weighted LCA with both sums folded in hit order (the host
    oracle's order), the per-name sums as a masked torch.sum."""
    rows_t, w_t, tab = map(torch.from_numpy, (rows, w, table))
    Q, H = rows_t.shape
    valid = rows_t >= 0
    conf, active = torch.ones(Q, dtype=torch.float64), torch.ones(Q, dtype=torch.bool)
    for r in range(8):
        names = torch.where(valid, tab[rows_t.clamp(min=0).long(), r], 0)
        wn = torch.where(names != 0, w_t, 0.0)
        denom = torch.zeros(Q, dtype=torch.float64)
        wsum = torch.zeros((Q, H), dtype=torch.float64)
        for j in range(H):
            denom = denom + wn[:, j]
            wsum = wsum + torch.where((names == names[:, j : j + 1]) & (names[:, j : j + 1] != 0),
                                      wn[:, j : j + 1], 0.0)
        wsum = torch.where(names != 0, wsum, -torch.inf)
        best = wsum.max(1).values
        active &= denom > 0
        conf = torch.where(active, conf * (best / torch.where(denom > 0, denom, 1.0)), conf)
    return conf.numpy()


@pytest.mark.parametrize("H", [32, 128, 512])
def test_the_sets_tell_the_sum_orders_apart(H):
    """On these inputs a hit-order fold gives other confidence bits than the
    JAX program, so the bit-for-bit test above holds the orders."""
    rows, w, table = SETS[0, f"H={H}"]
    jn, jconf = _jax(rows, w, table)[1:]
    naive = np.where(jn > 0, np.minimum(_hit_order(rows, w, table), 1.0), 0.0)
    np.testing.assert_allclose(naive, jconf, rtol=1e-12)
    assert (naive.view(np.int64) != jconf.view(np.int64)).any()


def test_chunked_denominator_order_at_2048():
    """At H = 2048 the named total adds its two 1024-hit chunks apart: a
    plain 32-block fold of all 64 blocks gives other bits on some input."""
    rng = np.random.default_rng(5)
    wn = torch.from_numpy(rng.random((64, 2048)) * 10.0 ** rng.uniform(-3, 3, (64, 2048)))
    blocks = lca._fold(wn, 32)
    assert not torch.equal(lca.named_total_torch(wn), lca._fold(blocks, 64)[:, 0])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rows, w, table = SETS[0, "H=32"]
    before = lca.weighted_lca.launches
    got = lca.weighted_lca(*map(torch.from_numpy, (rows, w, table)))
    want = lca.weighted_lca_torch(*map(torch.from_numpy, (rows, w, table)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert lca.weighted_lca.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(lca, "_check_device", lambda *a: "cuda")
    monkeypatch.setattr(lca, "_launch", lambda *a: pytest.fail("launched"))
    rows = torch.zeros((2, 8), dtype=torch.int32)
    w = torch.zeros((2, 8), dtype=torch.float64)
    table = torch.zeros((3, 8), dtype=torch.int32)
    for args in ((rows.long(), w, table), (rows, w.float(), table), (rows, w, table[:, :7].contiguous()),
                 (rows, w[:1], table), (torch.zeros((2, 4096), dtype=torch.int32),
                                        torch.zeros((2, 4096), dtype=torch.float64), table),
                 (rows.t(), w, table)):
        with pytest.raises(ValueError, match="weighted_lca"):
            lca.weighted_lca(*args)


@pytest.mark.parametrize("sizes", [[0, 1, 8], [9, 32, 33, 3], [128, 129, 512, 513, 2048] + [5] * 70,
                                   [2048] * 20 + [600] * 300])
def test_bucket_pad_matches_jax(sizes):
    rng = np.random.default_rng(len(sizes))
    entries = [[(int(rng.integers(0, 50)), float(rng.random())) for _ in range(n)] for n in sizes]
    got, want = lca.bucket_pad(entries), jlca.bucket_pad(entries)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert lca.DEFAULT_BUCKETS == jlca.DEFAULT_BUCKETS and lca.LCA_MAX_BUCKET == jlca.LCA_MAX_BUCKET


def test_bucket_pad_refuses_more_hits_than_the_largest_bucket():
    entries = [[(0, 1.0)] * (lca.LCA_MAX_BUCKET + 1)]
    with pytest.raises(ValueError, match="largest bucket"):
        lca.bucket_pad(entries)
    with pytest.raises(ValueError, match="largest bucket"):
        jlca.bucket_pad(entries)


def test_host_oracle_matches_jax():
    rng = np.random.default_rng(3)
    names = [["Bac", "Arc"], ["P1", "P2", "P3"], ["C1", "C2", ""], ["O1", "O2"], ["F1", ""],
             ["G1", "G2"], ["S1", "S2", "S3"], ["T1", ""]]
    hier = {f"t{i}": [str(rng.choice(n)) for n in names] for i in range(30)}
    hier["t0"] = [""] * 8
    hier["t1"] = [""] + ["x"] * 7
    for q in range(200):
        tids = rng.choice([*hier, "missing"], int(rng.integers(0, 12)))
        tw = {str(t): float(rng.choice([0.0, 0.5, 1.25, rng.random() * 40])) for t in tids}
        assert lca.weighted_lca_host(tw, hier) == jlca.weighted_lca_host(tw, hier)
