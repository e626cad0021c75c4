"""The compacted minimizers at the minimizer kernel's tile edges:
hymet_tpu_torch's plain ``minimizers_torch`` vs the JAX package's
``extract_minimizers_jax`` plus the keep-order compaction, on the code
batches of ``chip_smoke.minimizer_edge_sets`` (kept windows in a tile's
first and last slot, minima in the halos, a valid part ending in a halo,
whole tiles of N, row_len mid-tile, every window kept, w = 256), with and
without row lengths, at a cap that holds every kept window and one that
cuts them. At w = 256 the JAX window minimum (unrolled w steps, jitted)
takes minutes to compile, so that set is held to the JAX package's numpy
twin, row by row. The card tests hold the kernel to ``minimizers_torch``
on the same sets."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hymet_tpu.io.fasta import pack_code_batch
from hymet_tpu.ops import minimizer as jm
from hymet_tpu_torch.ops.align_kernels import minimizers, minimizers_torch

torch.set_num_threads(1)

SETS = {name: rest for name, *rest in chip_smoke.minimizer_edge_sets()}
T = chip_smoke.MIN_TILE


@functools.lru_cache(maxsize=None)
def _jax_windows(name):
    """(hash uint64, pos, strand, keep), each [B, NW], of every window, from
    the JAX package."""
    codes, row_len, k, w = SETS[name]
    hi, lo, pos, strand, keep = (np.asarray(x) for x in jm.extract_minimizers_jax(jnp.asarray(codes), k, w))
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64), pos, strand, keep


def _jax_keep(name, use_row_len):
    """_jax_windows with keep cut at each row's row_len when asked."""
    codes, row_len, k, w = SETS[name]
    h, pos, strand, keep = _jax_windows(name)
    if use_row_len:
        keep = keep & (np.arange(keep.shape[1])[None, :] < (row_len.astype(np.int64) - k - w + 2)[:, None])
    return h, pos, strand, keep


def _jax_compacted(name, use_row_len):
    """The kept windows' (hash int64, pos, strand, row) in row-major order:
    the keep-order compaction of extract_minimizers_jax, or, for the w = 256
    set, the JAX package's numpy twin on each row (cut at row_len)."""
    codes, row_len, k, w = SETS[name]
    if w > 64:
        parts = []
        for r in range(codes.shape[0]):
            h, p, st = jm.extract_minimizers_numpy(codes[r, : row_len[r] if use_row_len else None], k, w)
            parts.append((h.view(np.int64), p, st, np.full(h.size, r)))
        return tuple(np.concatenate(col) for col in zip(*parts))
    h, pos, strand, keep = _jax_keep(name, use_row_len)
    sel = np.flatnonzero(keep.reshape(-1))
    return (h.reshape(-1)[sel].view(np.int64), pos.reshape(-1)[sel], strand.reshape(-1)[sel],
            sel // keep.shape[1])


def _torch_out(name, cap, use_row_len):
    codes, row_len, k, w = SETS[name]
    packed, mask, L = pack_code_batch(codes)
    return minimizers_torch(torch.from_numpy(packed), torch.from_numpy(mask), L, k, w, cap,
                            torch.from_numpy(row_len) if use_row_len else None)


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("use_row_len", [False, True])
@pytest.mark.parametrize("name", list(SETS))
def test_compacted_minimizers_match_jax_at_tile_edges(name, use_row_len, cut):
    want = _jax_compacted(name, use_row_len)
    n_kept = want[0].size
    cap = max(1, n_kept // 3) if cut else n_kept + 100
    got = _torch_out(name, cap, use_row_len)
    assert int(got[4][0]) == n_kept > 0
    n = min(n_kept, cap)
    for a, b in zip(got[:4], want):
        np.testing.assert_array_equal(a[:n].numpy().astype(np.int64), b[:n].astype(np.int64))
        assert not a[n:].any()


def test_minimizer_edge_sets_hold_their_edges():
    """Each set holds the edge its name promises, so that a card run of the
    kernel on it crosses that edge."""
    h, pos, _, keep = _jax_keep("kept_at_tile_edges", False)
    w = SETS["kept_at_tile_edges"][3]
    # a tile's last slot kept, its minimum in the right halo; a first slot kept
    assert keep[0, T - 1] and pos[0, T - 1] == T + w - 2
    assert keep[0, 2 * T] and pos[0, 2 * T] == 2 * T + w - 1
    # window 3T - 1's minimum is k-mer 3T - 1, tile 3's left halo; 3T is kept
    assert pos[0, 3 * T - 1] == 3 * T - 1 and keep[0, 3 * T]
    codes, row_len, k, _ = SETS["kept_at_tile_edges"]
    valid = np.flatnonzero(codes[1] < 4)
    assert T <= valid[-1] - k + 1 < T + w - 1  # row 1's last valid k-mer in tile 0's halo
    # row 2: tiles 2-4 (with their halos) hold no valid base
    assert (codes[2, 2 * T - 16 : 5 * T + w + k] == 4).all() and (codes[2, : T] < 4).all()
    assert 2 * T < row_len[3] - k - w + 2 < 3 * T
    _, _, _, keep = _jax_keep("every_window_kept", False)
    assert keep[:3].all() and not keep[3].all()
    codes, row_len, k, w = SETS["wide_window"]
    _, pos, _ = jm.extract_minimizers_numpy(codes[0], k, w)
    # k-mer T + w - 2, tile 0's farthest halo k-mer, is kept: first by window
    # T - 1, the first window that holds it
    assert w == 256 and T + w - 2 in pos.tolist()
    assert "more_tiles_than_resident" not in SETS
    name, codes, row_len, k, w = chip_smoke.minimizer_edge_sets(big=True)[-1]
    tiles = codes.shape[0] * -(-(codes.shape[1] - k - w + 2) // T)
    assert name == "more_tiles_than_resident" and tiles >= 4096
    assert (codes < 4).mean() > 0.8  # most tiles work


def test_minimizers_wrapper_takes_the_plain_version_on_cpu():
    codes, row_len, k, w = SETS["kept_at_tile_edges"]
    packed, mask, L = pack_code_batch(codes)
    args = (torch.from_numpy(packed), torch.from_numpy(mask), L, k, w, 5000, torch.from_numpy(row_len))
    before = minimizers.launches
    for a, b in zip(minimizers(*args), minimizers_torch(*args)):
        assert torch.equal(a, b)
    assert minimizers.launches == before


def test_chip_smoke_counts_the_device_activities_of_a_call(monkeypatch):
    """chip_smoke's phase 6 check: a minimizers call of the single-pass
    design (the tile kernel, the tail fill and one memset; a profiled window
    may drop its first activity) passes; the earlier count pass, scan and
    write pass with a memset (4 activities), or a profile without the tile
    kernel, raise."""
    from types import SimpleNamespace

    batch = (torch.zeros(1, 4, dtype=torch.uint8), torch.zeros(1, 2, dtype=torch.uint8), 1, 16)
    staged = SimpleNamespace(device=[batch] * 16)
    aligner = SimpleNamespace(_minimizer_cap=lambda B, L: (1, 4096))
    index = SimpleNamespace(k=19, w=19)
    monkeypatch.setattr(chip_smoke, "align_kernels", SimpleNamespace(minimizers=lambda *a: None))
    n = chip_smoke.PROFILED_CALLS

    def profiled(counts):
        trace = {"device_ms": [[k, 0.1, c] for k, c in counts]}
        monkeypatch.setattr(chip_smoke, "profile_run", lambda fn, **_kw: (fn(), trace)[1])

    map_batch = {"device_ms": [["ns::minimizer_tile_kernel(...)", 0.3, 16],
                               ["ns::minimizer_tail_kernel(...)", 0.1, 16]]}
    profiled([("ns::minimizer_tile_kernel(...)", n - 1), ("ns::minimizer_tail_kernel(...)", n),
              ("Memset (Device)", n)])
    out = chip_smoke.minimizer_activities(map_batch, aligner, index, staged)
    assert sum(out["activities_per_call"].values()) == 3
    for counts in ([("ns::minimizer_count_kernel(...)", n), ("ns::scan_block_counts(...)", n),
                    ("ns::minimizer_write_kernel(...)", n), ("Memset (Device)", n)],
                   [("ns::minimizer_tile_kernel(...)", n), ("ns::minimizer_tail_kernel(...)", n),
                    ("ns::other_kernel(...)", n), ("Memset (Device)", n)], []):
        profiled(counts)
        with pytest.raises(AssertionError, match="device activities"):
            chip_smoke.minimizer_activities(map_batch, aligner, index, staged)
