"""hymet_tpu_torch's aligner (plain CPU path) vs the JAX package's: the
search tables, the sorted anchors and the [n, 9] chain rows of a batch,
and the PAF records of a seeded world with exact, reverse-complement,
mutated, indel and chimeric contigs, an absent genome and a too-short
query; the overflow retries of all three caps with their sticky boosts;
and staged against unstaged batches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hymet_tpu.io.minimizer_index import MinimizerIndex as JIndex
from hymet_tpu.models import aligner as jal
from hymet_tpu.pipeline.staged import StagedContigs as JStaged
from hymet_tpu_torch.io.fasta import pack_code_batch
from hymet_tpu_torch.io.minimizer_index import MinimizerIndex as TIndex
from hymet_tpu_torch.models import aligner as tal
from hymet_tpu_torch.ops import align_kernels as ak
from hymet_tpu_torch.ops.align_kernels import SIGN, anchors
from hymet_tpu_torch.pipeline.staged import StagedContigs as TStaged

torch.set_num_threads(1)

PAD = 1 << 14  # every query below fits one pad bucket: one batch shape
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_RC = bytes.maketrans(b"ACGT", b"TGCA")


def _rand(rng, n):
    return _ACGT[rng.integers(0, 4, n)].tobytes()


def _mutate(rng, seq, rate):
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    idx = rng.random(len(arr)) < rate
    arr[idx] = _ACGT[rng.integers(0, 4, int(idx.sum()))]
    return arr.tobytes()


def _indels(rng, seq, n, max_len):
    s = bytearray(seq)
    for _ in range(n):
        at = int(rng.integers(100, len(s) - 100))
        if rng.random() < 0.5:
            del s[at : at + int(rng.integers(1, max_len))]
        else:
            s[at:at] = _rand(rng, int(rng.integers(1, max_len)))
    return bytes(s)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(42)
    genomes = [("chrA", _rand(rng, 60000)), ("chrB", _rand(rng, 40000)), ("chrC", _rand(rng, 30000))]
    g = dict(genomes)
    n_run = bytearray(g["chrA"][40000:46000])
    n_run[2000:2300] = b"N" * 300
    queries = [
        ("exact", g["chrB"][5000:15000]),
        ("revcomp", g["chrA"][20000:28000].translate(_RC)[::-1]),
        ("mutated", _mutate(rng, g["chrC"][2000:12000], 0.05)),
        ("deletion", g["chrA"][30000:34000] + g["chrA"][34500:40000]),
        ("indels", _indels(rng, g["chrB"][20000:32000], 8, 50)),
        ("chimeric", g["chrB"][1000:9000] + g["chrC"][5000:13000]),
        ("absent", _rand(rng, 8000)),
        ("short", g["chrA"][100:120]),
        ("n_run", bytes(n_run)),
    ]
    names = [n for n, _ in queries]
    seqs = [s for _, s in queries]
    jidx = JIndex.build(genomes)
    jrecs = jal.MinimizerAligner(jidx, jal.AlignerConfig(batch_pad=PAD)).map_batch(names, seqs)
    return genomes, names, seqs, jidx, [r.to_line() for r in jrecs]


def _port(world, **kw):
    genomes = world[0]
    return tal.MinimizerAligner(TIndex.build(genomes, device="cpu"),
                                tal.AlignerConfig(batch_pad=PAD), device="cpu", **kw)


def _lines(records):
    return [r.to_line() for r in records]


def test_search_tables_match_jax(world):
    idx = world[3]
    hl, roff2, ps, _bkt2, _bits, _steps, U = jal.build_search_tables(idx.hashes, idx.seq_id, idx.pos, idx.strand)
    uniq, t_roff2, t_ps = tal.build_search_tables(idx.hashes, idx.seq_id, idx.pos, idx.strand)
    assert uniq.dtype == np.int64 and uniq.shape == (U,)
    np.testing.assert_array_equal(
        uniq.view(np.uint64), (hl[:, 0].astype(np.uint64) << np.uint64(32)) | hl[:, 1])
    np.testing.assert_array_equal(t_roff2, roff2)
    np.testing.assert_array_equal(t_ps, ps)
    for max_occ in (1, 16):
        assert tal.expected_anchor_occ(idx.hashes, max_occ) == jal.expected_anchor_occ(idx.hashes, max_occ)


def test_records_match_jax(world):
    _genomes, names, seqs, _jidx, jlines = world
    lines = _lines(_port(world).map_batch(names, seqs))
    assert lines == jlines
    mapped = {ln.split("\t")[0] for ln in lines}
    assert {"exact", "revcomp", "mutated", "deletion", "indels", "chimeric", "n_run"} <= mapped
    assert not {"absent", "short"} & mapped


def test_sorted_anchors_and_chain_rows_match_jax(world):
    """One batch through both device paths: the sorted anchors (valid
    part) from ``anchors`` itself, the counts and the [n, 9] chain rows,
    element for element, through the aligner's ``KERNELS`` (their plain
    versions on the CPU) and ``PLAIN``."""
    _genomes, names, seqs, jidx, _ = world
    jaln = jal.MinimizerAligner(jidx, jal.AlignerConfig(batch_pad=PAD))
    groups, fixed = tal.plan_query_groups([len(s) for s in seqs], PAD, 38)
    assert len(groups) == 1
    batch = tal.build_group_batch(seqs, groups[0], PAD, 38, fixed)
    packed, mask, L = pack_code_batch(batch)
    B = batch.shape[0]
    jp, jm = jnp.asarray(packed), jnp.asarray(mask)
    tp, tm = torch.from_numpy(packed), torch.from_numpy(mask)
    NW, cap = jaln._minimizer_cap(B, L)
    acap, ccap = jaln._device_caps(B, NW, cap)
    s_k1, s_k2, s_p, s_r, j_anchors, j_kept = (np.asarray(x) for x in jal._collect_sorted_fused_packed(
        jaln._idx_hl, jaln._idx_roff2, jaln._idx_ps, jp, jm, L, 19, 19, 16, 11, cap, acap,
        jaln._bkt2, jaln._bkt_bits, jaln._bkt_steps, bsearch=True, slot_fill=True))
    _, _, _, _, _, (chains, n_chains, _, _) = jaln._dispatch_batch((jp, jm, B, L))
    nc = int(n_chains)
    for ops in (ak.KERNELS, ak.PLAIN):
        taln = _port(world, ops=ops)
        assert (NW, cap) == taln._minimizer_cap(B, L) and (acap, ccap) == taln._device_caps(B, NW, cap)
        mz = ops.minimizers(tp, tm, L, 19, 19, cap)
        skey, sp, sr, n_anchors = ops.anchors(*mz, taln._tables, 16, 11, acap, B, L)
        n = int(n_anchors)
        assert (int(mz[4]), n) == (int(j_kept), int(j_anchors)) and 0 < n <= acap
        raw = (skey ^ SIGN).numpy().view(np.uint64)
        np.testing.assert_array_equal((raw >> np.uint64(32)).astype(np.uint32), s_k1)
        np.testing.assert_array_equal((raw & np.uint64(0xFFFFFFFF)).astype(np.uint32), s_k2)
        np.testing.assert_array_equal(sp.numpy()[:n].astype(np.uint32), s_p[:n])
        np.testing.assert_array_equal(sr.numpy()[:n].astype(np.uint32), s_r[:n])

        rows, counts = taln._dispatch_batch((tp, tm, B, L))[4]
        assert counts.tolist() == [nc, int(j_kept), int(j_anchors)] and nc > 5
        np.testing.assert_array_equal(rows.numpy()[:nc].astype(np.int64),
                                      np.asarray(chains)[:nc].astype(np.int64))
        assert not rows[nc:].any()


def _small_caps(cls, monkeypatch, caps):
    """Caps below this world's counts, so each overflows once; the sticky
    boosts multiply them as the aligners' own caps."""
    monkeypatch.setattr(cls, "_minimizer_cap", lambda self, B, L: (
        L - self.index.k - self.index.w + 2, caps[0] * self._cap_boost))
    monkeypatch.setattr(cls, "_device_caps", lambda self, B, NW, cap: (
        caps[1] * self._acap_boost, caps[2] * self._ccap_boost))


def test_overflow_retries_with_sticky_boosts(world, monkeypatch):
    """cap, acap and ccap each overflow on the first batch: both aligners
    retry with doubled caps, emit the same records as without overflow,
    keep the boosts, and do not overflow again on the next call."""
    _genomes, names, seqs, jidx, jlines = world
    taln = _port(world)
    batch = tal.build_group_batch(seqs, list(range(len(seqs))), PAD, 38, False)
    packed, mask, L = pack_code_batch(batch)
    n_chains, n_kept, n_anchors = taln._dispatch_batch(
        (torch.from_numpy(packed), torch.from_numpy(mask), batch.shape[0], L))[4][1].tolist()
    caps = (n_kept * 3 // 4, n_anchors * 3 // 4, n_chains * 3 // 4)
    _small_caps(tal.MinimizerAligner, monkeypatch, caps)
    _small_caps(jal.MinimizerAligner, monkeypatch, caps)
    jaln = jal.MinimizerAligner(jidx, jal.AlignerConfig(batch_pad=PAD))
    for aln in (taln, jaln):
        assert _lines(aln.map_batch(names, seqs)) == jlines
        assert (aln._cap_boost, aln._acap_boost, aln._ccap_boost) == (2, 2, 2)
        assert _lines(aln.map_batch(names, seqs)) == jlines
        assert (aln._cap_boost, aln._acap_boost, aln._ccap_boost) == (2, 2, 2)


def test_staged_batches_give_the_same_records(world):
    """map_batch on upload-once staged batches (the screen's) equals the
    unstaged path and the JAX package's records; the JAX package's staged
    batches hold the same bytes."""
    _genomes, names, seqs, _jidx, jlines = world
    staged = TStaged(names, seqs, PAD, 38, device="cpu")
    jstaged = JStaged(names, seqs, PAD, 38)
    for (p, m, rows, L), (jp, jm, jrows, jL) in zip(staged.device, jstaged.device):
        assert (rows, L) == (jrows, jL)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert _lines(_port(world).map_batch(names, seqs, staged=staged)) == jlines


class _Watched(list):
    """A staged batch list that counts the batches read from it."""

    reads = 0

    def __getitem__(self, i):
        _Watched.reads += 1
        return super().__getitem__(i)


@pytest.mark.parametrize("plan", ["same", "other_pad", "other_min_len", "other_queries"])
def test_map_batch_uses_staged_batches_only_when_they_match(world, plan):
    _genomes, names, seqs, _jidx, jlines = world
    pad, min_len, n = {"same": (PAD, 38, len(seqs)), "other_pad": (PAD // 2, 38, len(seqs)),
                       "other_min_len": (PAD, 40, len(seqs)), "other_queries": (PAD, 38, 5)}[plan]
    staged = TStaged(names[:n], seqs[:n], pad, min_len, device="cpu")
    for args in ((len(seqs), PAD, 38), (n, pad, min_len), (len(seqs), PAD, 40)):
        assert staged.matches(*args) == JStaged(names[:n], seqs[:n], pad, min_len).matches(*args)
    staged.device = _Watched(staged.device)
    _Watched.reads = 0
    assert _lines(_port(world).map_batch(names, seqs, staged=staged)) == jlines
    assert _Watched.reads == (len(staged.groups) if plan == "same" else 0)


def test_short_query_and_empty_index():
    rng = np.random.default_rng(3)
    genomes = [("g", _rand(rng, 5000))]
    aln = tal.MinimizerAligner(TIndex.build(genomes, device="cpu"), device="cpu")
    assert aln.map_batch(["q"], [b"ACGT"]) == []
    empty = tal.MinimizerAligner(TIndex.build([("tiny", b"ACGT")], device="cpu"), device="cpu")
    assert empty.index.n_minimizers == 0 and empty.map_batch(["q"], [genomes[0][1]]) == []


@pytest.mark.parametrize("B, L", [(65, 1024), (0, 1024), (4, (1 << 25) + 1), (4, 0)])
@pytest.mark.parametrize("plain", [False, True])
def test_anchors_refuse_batches_past_the_key_layout(B, L, plain):
    """The packed keys hold a row in 6 bits and a position in 25: the
    wrapper and its plain version raise for a batch that would wrap them,
    rather than return wrong sort keys."""
    fn = ak.sorted_anchors_torch if plain else anchors
    mz = (torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int32),
          torch.zeros(4, dtype=torch.uint8), torch.zeros(4, dtype=torch.int32),
          torch.zeros(1, dtype=torch.int64))
    uniq = np.zeros(1, dtype=np.int64)
    tables = ak.anchor_tables(uniq, np.zeros((1, 2), np.int32), np.zeros((1, 2), np.int32),
                              *tal.build_bucket_table(uniq, 19), 1, "cpu")
    with pytest.raises(ValueError, match="packed key layout"):
        fn(*mz, tables, 16, 11, 8, B, L)
    fn(*mz, tables, 16, 11, 8, 64, 1 << 25)  # the largest batch the layout holds
