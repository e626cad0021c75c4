"""The chain rows of sorted anchors: hymet_tpu_torch's plain ``chains_torch``
vs the JAX package's ``_chain_reduce_sorted`` (unblocked and blocked by
2048, the tile of ``csrc/chains.cu``), on the synthetic sets at the kernel's
tile edges (``chip_smoke.chain_edge_sets``): the rows [:n] element for
element and n_chains equal. The card tests hold the kernel to
``chains_torch`` on the same sets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hymet_tpu.models.aligner import _chain_reduce_sorted
from hymet_tpu_torch.ops.align_kernels import chains, chains_torch

torch.set_num_threads(1)

SETS = {name: rest for name, *rest in chip_smoke.chain_edge_sets()}
# one compile a shape (eager, each of the scans' many slices compiles alone)
_JAX_CHAINS = jax.jit(_chain_reduce_sorted,
                      static_argnames=("k", "min_cnt", "min_mlen", "ccap", "block"))
T = chip_smoke.CHAIN_TILE


def _torch_rows(name):
    key, p, r, cargs = SETS[name]
    return chains_torch(torch.from_numpy(key), torch.from_numpy(p), torch.from_numpy(r), *cargs)


@pytest.mark.parametrize("block", [0, T])
@pytest.mark.parametrize("name", list(SETS))
def test_chain_rows_match_jax(name, block):
    key, p, r, cargs = SETS[name]
    raw = key.view(np.uint64) ^ np.uint64(1 << 63)
    k1, k2 = (raw >> np.uint64(32)).astype(np.uint32), raw.astype(np.uint32)
    want, want_n = _JAX_CHAINS(
        jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(p.astype(np.uint32)),
        jnp.asarray(r.astype(np.uint32)), *cargs, block=block)
    got, got_n = _torch_rows(name)
    n = int(want_n)
    assert int(got_n[0]) == n
    m = min(n, cargs[3])
    np.testing.assert_array_equal(got.numpy()[:m].astype(np.int64),
                                  np.asarray(want)[:m].astype(np.int64))
    assert not got.numpy()[m:].any()


def test_chain_edge_sets_hold_their_edges():
    """Each set holds the edge its name promises (so that a card run of the
    kernel on it crosses that edge)."""
    k, min_cnt, min_mlen = chip_smoke.CHAIN_ARGS
    assert [len(SETS[f"A={A}"][0]) for A in (1, T - 1, T, T + 1, 3 * T + 5)] == [
        1, T - 1, T, T + 1, 3 * T + 5]
    for key, *_ in SETS.values():
        assert (key[1:] >= key[:-1]).all()
    rows, _ = _torch_rows("chain_over_5_tiles")
    assert int(rows[:, 3].max()) > 5 * T
    rows, _ = _torch_rows("tile_starts_and_ends")
    assert T in rows[:, 3].tolist()  # the tile that is one whole chain
    rows = _torch_rows("cnt_and_mlen_thresholds")[0].tolist()
    assert min_cnt in [row[3] for row in rows] and min_cnt - 1 not in [row[3] for row in rows]
    # the two chains of 6 anchors at mlen = min_mlen pass, those at min_mlen - 1 do not
    q0 = 1_000_000
    assert [row[5] - row[4] + k for row in rows if row[3] == 6 and row[4] == q0].count(min_mlen) == 2
    valid = {name: int((SETS[name][0] != (1 << 63) - 1).sum())
             for name in SETS if name.startswith(("padding", "only"))}
    assert valid == {"padding_from_mid_tile": 2 * T + 904,
                     "padding_ends_in_last_tile_min_mlen_below_k": chip_smoke.CHAIN_A - 3,
                     "padding_from_tile_start": 2 * T, "only_padding": 0}
    assert SETS["padding_ends_in_last_tile_min_mlen_below_k"][3][2] <= k
    assert int(_torch_rows("ccap_cuts_rows")[1][0]) > SETS["ccap_cuts_rows"][3][3]
    assert "chain_over_260_tiles" not in SETS
    longest = chip_smoke.chain_edge_sets(longest=True)[-1]
    assert longest[0] == "chain_over_260_tiles" and len(longest[1]) == 263 * T


def test_chains_wrapper_takes_the_plain_version_on_cpu():
    key, p, r, cargs = SETS["A=6149"]
    args = (torch.from_numpy(key), torch.from_numpy(p), torch.from_numpy(r))
    before = chains.launches
    for a, b in zip(chains(*args, *cargs), chains_torch(*args, *cargs)):
        assert torch.equal(a, b)
    assert chains.launches == before
