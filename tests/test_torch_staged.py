"""hymet_tpu_torch upload-once staging and the aligner's host helpers vs
the JAX package: same groups, same padded 2-bit buffers, byte for byte."""

import numpy as np
import pytest
import torch

from hymet_tpu.models import aligner as jal
from hymet_tpu.pipeline.staged import StagedContigs as JStaged
from hymet_tpu_torch.models import aligner as tal
from hymet_tpu_torch.pipeline.staged import StagedContigs as TStaged

torch.set_num_threads(1)


def _contigs(seed: int, n: int, max_len: int):
    """Contigs of mixed lengths; some hold N runs or IUPAC codes."""
    rng = np.random.default_rng(seed)
    names, seqs = [], []
    for i in range(n):
        L = int(rng.integers(30, max_len))
        s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)].copy()
        if i % 3 == 0:
            s[L // 2 : L // 2 + 5] = ord("N")
        if i % 7 == 0:
            s[0] = ord("R")
        names.append(f"c{i}")
        seqs.append(s.tobytes())
    return names, seqs


@pytest.mark.parametrize(
    "n,max_len,batch_pad",
    [(20, 9000, 4096), (70, 5000, 1024), (12, 3000, 256)],
)
def test_staged_buffers_match_jax(n, max_len, batch_pad):
    """Tight upload + repack (batch_pad 4096, 1024) and the host-packed
    path for row widths off the 128-byte grid (batch_pad 256)."""
    names, seqs = _contigs(n + batch_pad, n, max_len)
    ref = JStaged(names, seqs, batch_pad, 38)
    got = TStaged(names, seqs, batch_pad, 38, device="cpu")
    assert got.groups == ref.groups and got.fixed_rows == ref.fixed_rows
    assert got.packed_bytes == ref.packed_bytes
    assert len(got.device) == len(ref.device)
    for (p, m, rows, L), (jp, jm, jrows, jL) in zip(got.device, ref.device):
        assert (rows, L) == (jrows, jL)
        assert p.dtype == m.dtype == torch.uint8
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_aligner_host_helpers_match_jax():
    """pad_query_len (3*2^k midpoints), plan_query_groups, group_rows
    (pow2 partial rows) and build_group_batch at the shipping defaults."""
    for q in (256, 4096, 1 << 16):
        for length in list(range(1, 40 * q, max(1, q // 7))) + [2 * q + 1, 3 * q, 3 * q + 1]:
            assert tal.pad_query_len(length, q) == jal.pad_query_len(length, q)
    for n in range(1, 130):
        for fixed in (False, True):
            assert tal.group_rows(n, fixed) == jal.group_rows(n, fixed)
    for count in (5, 64, 100):
        names, seqs = _contigs(count, count, 20000)
        lengths = [len(s) for s in seqs]
        assert tal.plan_query_groups(lengths, 4096, 38) == jal.plan_query_groups(lengths, 4096, 38)
        groups, fixed = tal.plan_query_groups(lengths, 4096, 38)
        for g in groups:
            np.testing.assert_array_equal(
                tal.build_group_batch(seqs, g, 4096, 38, fixed),
                jal.build_group_batch(seqs, g, 4096, 38, fixed),
            )
