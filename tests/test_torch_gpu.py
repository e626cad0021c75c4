"""hymet_tpu_torch on the card: the hand-written kernels against their plain
PyTorch versions (kmer_hashes bit for bit, screen_count count for count)
at the edge cases, and the screen slice through them. These need a CUDA
card (and nvcc) and skip without one; on the card run
``python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py``
(``tests/conftest.py`` imports jax, which the port does not need)."""

import filecmp
import os
from unittest import mock

import numpy as np
import pytest
import torch

from hymet_tpu_torch.io.fasta import pack_code_batch, read_fasta
from hymet_tpu_torch.io.sketchdb import load_sketch_db
from hymet_tpu_torch.ops import hash_kernels
from hymet_tpu_torch.ops.hash_kernels import screen_count_torch
from hymet_tpu_torch.ops.hashing import SIGN, kmer_hashes_torch
from hymet_tpu_torch.ops.sketch import ScreenEngine
from hymet_tpu_torch.pipeline.screen_stage import run_screen_stage
from hymet_tpu_torch.pipeline.staged import StagedContigs

WORLD = os.path.join(os.path.dirname(__file__), "..", "validation", "work_cami_suite")
LABELS = ["sketch1", "sketch2", "sketch3"]
RUN = 16  # windows a thread owns in the kernels (csrc/kmer_core.cuh kRun)
EDGE_K = [15, 16, 17, 21, 24, 25, 32]  # Murmur's block and tail boundaries
EDGE_L = ["k", "k+1", "run+k-1", "run+k", 1003, "block+k+5", 1 << 20]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _length(L, k: int) -> int:
    return {"k": k, "k+1": k + 1, "run+k-1": RUN + k - 1, "run+k": RUN + k,
            "block+k+5": 128 * RUN + k + 5}.get(L, L)


def _codes(k: int, L: int) -> np.ndarray:
    """[4, L] codes: N runs, N bases on the last base of a thread's run and
    the first of the next, an N at a row end, an all-padding row."""
    rng = np.random.default_rng(L + k)
    codes = rng.integers(0, 4, size=(4, L), dtype=np.uint8)
    codes[0, L // 2 : L // 2 + 40] = 4
    codes[1, RUN - 1 :: 3 * RUN] = 4
    codes[1, 2 * RUN :: 3 * RUN] = 4
    codes[2, -1] = 4
    codes[3] = 4
    return codes


@pytest.mark.gpu
@pytest.mark.parametrize("k", EDGE_K)
@pytest.mark.parametrize("L", EDGE_L)
def test_kmer_hash_kernel_matches_plain(L, k):
    _need_card()
    g = torch.from_numpy(_codes(k, _length(L, k))).cuda()
    before = hash_kernels.kmer_hashes.launches
    h, v = hash_kernels.kmer_hashes(g, k)
    h_ref, v_ref = kmer_hashes_torch(g, k)
    torch.cuda.synchronize()
    assert hash_kernels.kmer_hashes.launches == before + 1
    assert torch.equal(h, h_ref) and torch.equal(v, v_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("k", EDGE_K)
@pytest.mark.parametrize("L", EDGE_L)
@pytest.mark.parametrize("keys", ["largest", "all_survive", "none_survive", "one_key"])
def test_screen_count_kernel_matches_plain(keys, L, k):
    """Counts and valid total equal the plain version's, element for
    element: t the largest key, t at the sign-flipped maximum (every valid
    window survives), t below every key, and a single key (F = 1)."""
    _need_card()
    codes = _codes(k, _length(L, k))
    packed, mask, L = pack_code_batch(codes)
    packed, mask = torch.from_numpy(packed).cuda(), torch.from_numpy(mask).cuda()
    h, v = kmer_hashes_torch(torch.from_numpy(codes).cuda(), k)
    q = (h[v] ^ SIGN).cpu().numpy()
    rng = np.random.default_rng(k)
    if keys == "one_key":
        flat = torch.from_numpy(q[:1].copy() if q.size else np.zeros(1, np.int64))
    else:
        pick = q[rng.choice(q.size, min(q.size, 50), replace=False)]
        flat = torch.from_numpy(np.unique(np.concatenate([pick, [-5, 2**62]])))
    flat = flat.cuda()
    t = {"all_survive": 2**63 - 1, "none_survive": -(2**63)}.get(keys, int(flat[-1]))
    out = []
    for fn in (hash_kernels.screen_count, screen_count_torch):
        counts = torch.zeros(flat.shape[0], dtype=torch.int32, device="cuda")
        total = torch.zeros(1, dtype=torch.int64, device="cuda")
        fn(packed, mask, L, k, flat, t, counts, total)
        out.append((counts, total))
    torch.cuda.synchronize()
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert int(out[1][1]) == int(v.sum())
    if keys != "none_survive":
        assert int(out[1][0].sum()) >= min(1, q.size)


@pytest.mark.gpu
def test_screen_slice_kernel_matches_plain_on_card(tmp_path):
    _need_card()
    names, seqs = read_fasta(os.path.join(WORLD, "data", "camisyn_gut", "contigs.fna"))
    query = tmp_path / "q.fna"
    query.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in zip(names[:200], seqs[:200])))
    staged = StagedContigs(names[:200], seqs[:200], 1 << 16, 38, device="cuda")
    dbs = [load_sketch_db(os.path.join(WORLD, f"{label}.npz")) for label in LABELS]
    outs = {tag: str(tmp_path / tag) for tag in ("kernel", "plain")}
    hash_kernels.screen_count.launches = 0
    hash_kernels.kmer_hashes.launches = 0
    run_screen_stage(dbs, [str(query)], outs["kernel"], 0.9, LABELS, staged=staged, device="cuda")
    assert hash_kernels.screen_count.launches == len(staged.device)
    # the same stage with the plain count: the engine's seam, its default swapped
    with mock.patch.dict(ScreenEngine.__init__.__kwdefaults__, count_fn=screen_count_torch):
        run_screen_stage(dbs, [str(query)], outs["plain"], 0.9, LABELS, staged=staged, device="cuda")
    assert hash_kernels.screen_count.launches == len(staged.device)
    assert hash_kernels.kmer_hashes.launches == 0
    names = sorted(os.listdir(outs["kernel"]))
    assert names == sorted(os.listdir(outs["plain"])) and len(names) == 4 * len(LABELS) + 1
    for name in names:
        assert filecmp.cmp(os.path.join(outs["kernel"], name), os.path.join(outs["plain"], name), shallow=False)
