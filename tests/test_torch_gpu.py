"""hymet_tpu_torch on the card: the hand-written kernel against its plain
PyTorch version, bit for bit, and the screen slice through it. These need
a CUDA card (and nvcc) and skip without one; on the card run
``python -m pytest tests/test_torch_gpu.py -m gpu``."""

import filecmp
import os

import numpy as np
import pytest
import torch

from hymet_tpu_torch.io.fasta import read_fasta
from hymet_tpu_torch.io.sketchdb import load_sketch_db
from hymet_tpu_torch.ops import hash_kernels
from hymet_tpu_torch.ops.hashing import kmer_hashes_torch
from hymet_tpu_torch.pipeline.screen_stage import run_screen_stage
from hymet_tpu_torch.pipeline.staged import StagedContigs

WORLD = os.path.join(os.path.dirname(__file__), "..", "validation", "work_cami_suite")
LABELS = ["sketch1", "sketch2", "sketch3"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [15, 21, 32])
@pytest.mark.parametrize("L", ["k", "k+1", 2048 + 20, 3 * 2048 + 7, 1 << 20])
def test_kmer_hash_kernel_matches_plain(L, k):
    _need_card()
    L = {"k": k, "k+1": k + 1}.get(L, L)
    rng = np.random.default_rng(L + k)
    codes = rng.integers(0, 4, size=(4, L), dtype=np.uint8)
    codes[0, L // 2 : L // 2 + 40] = 4
    codes[1, -1] = 4
    g = torch.from_numpy(codes).cuda()
    before = hash_kernels.kmer_hashes.launches
    h, v = hash_kernels.kmer_hashes(g, k)
    h_ref, v_ref = kmer_hashes_torch(g, k)
    torch.cuda.synchronize()
    assert hash_kernels.kmer_hashes.launches == before + 1
    assert torch.equal(h, h_ref) and torch.equal(v, v_ref)


@pytest.mark.gpu
def test_screen_slice_kernel_matches_plain_on_card(tmp_path):
    _need_card()
    names, seqs = read_fasta(os.path.join(WORLD, "data", "camisyn_gut", "contigs.fna"))
    query = tmp_path / "q.fna"
    query.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in zip(names[:200], seqs[:200])))
    staged = StagedContigs(names[:200], seqs[:200], 1 << 16, 38, device="cuda")
    outs = {}
    for tag, fn in (("kernel", hash_kernels.kmer_hashes), ("plain", kmer_hashes_torch)):
        dbs = [load_sketch_db(os.path.join(WORLD, f"{label}.npz")) for label in LABELS]
        hash_kernels.kmer_hashes.launches = 0
        outs[tag] = str(tmp_path / tag)
        run_screen_stage(dbs, [str(query)], outs[tag], 0.9, LABELS, staged=staged,
                         device="cuda", hash_fn=fn)
        assert (hash_kernels.kmer_hashes.launches > 0) == (tag == "kernel")
    for name in os.listdir(outs["kernel"]):
        assert filecmp.cmp(os.path.join(outs["kernel"], name), os.path.join(outs["plain"], name), shallow=False)
