"""hymet_tpu_torch on the card: the hand-written kernels against their plain
PyTorch versions (kmer_hashes bit for bit, screen_count count for count,
and the rest) at the edge cases, the slices through them, the sketch DB
build against the committed DBs, and the bench harness against the CPU. These need a CUDA
card (and nvcc) and skip without one; on the card run
``python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py``
(``tests/conftest.py`` imports jax, which the port does not need)."""

import filecmp
import os
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from hymet_tpu_torch.evalx import eval_cami
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


# ----------------------------------------------------------------------
# the align slice's kernels: minimizers, anchors, chains

ALIGN_KW = [(19, 19), (15, 5), (16, 1), (32, 7), (31, 19), (5, 64)]
ALIGN_L = ["k+w-1", "tile+k+w", 4099, 70_000]
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _align_codes(k: int, w: int, L: int) -> np.ndarray:
    """[6, L] codes: N runs, an all-padding row, a half-padded row, a row
    shorter than k + w - 1, a period-2 repeat (equal hashes in a window)."""
    rng = np.random.default_rng(L * 64 + k + w)
    codes = rng.integers(0, 4, size=(6, L), dtype=np.uint8)
    codes[0, L // 3 : L // 3 + 40] = 4
    codes[0, RUN - 1 :: 3 * RUN] = 4
    codes[2] = 4
    codes[3, L // 2 :] = 4
    codes[4, k + w - 2 :] = 4
    codes[5] = np.arange(L) % 2
    return codes


@pytest.mark.gpu
@pytest.mark.parametrize("k,w", ALIGN_KW)
@pytest.mark.parametrize("L", ALIGN_L)
def test_minimizers_kernel_matches_plain(L, k, w):
    """Every output bit for bit, with and without row lengths, with a cap
    that holds every kept window and one that overflows."""
    _need_card()
    from hymet_tpu_torch.ops import align_kernels as ak

    L = {"k+w-1": k + w - 1, "tile+k+w": 2048 + k + w}.get(L, L)
    packed, mask, _ = pack_code_batch(_align_codes(k, w, L))
    packed, mask = torch.from_numpy(packed).cuda(), torch.from_numpy(mask).cuda()
    lens = torch.tensor([L, L - 1, 0, L // 2, k + w - 2, L], dtype=torch.int32).cuda()
    for cap in (6 * L, max(1, L // 8)):
        for row_len in (None, lens):
            before = ak.minimizers.launches
            got = ak.minimizers(packed, mask, L, k, w, cap, row_len)
            want = ak.minimizers_torch(packed, mask, L, k, w, cap, row_len)
            torch.cuda.synchronize()
            assert ak.minimizers.launches == before + 1
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)


MIN_SETS = {name: rest for name, *rest in chip_smoke.minimizer_edge_sets(big=True)}


def _dirty(*sizes):
    """Fill and free blocks of the allocator, so that an output slot a kernel
    leaves unwritten shows."""
    dirty = [torch.full((n,), -1, dtype=torch.int64, device="cuda") for n in sizes]
    del dirty


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(MIN_SETS))
def test_minimizers_kernel_matches_plain_at_tile_edges(name):
    """Every output bit for bit, one launch a call, on the code batches at
    the kernel's tile edges (chip_smoke.minimizer_edge_sets: kept windows in
    a tile's first and last slot, minima in the halos, whole tiles of N,
    row_len mid-tile, every window kept, w = 256, 4480 tiles), with and
    without row lengths, at a cap that holds every kept window and one that
    overflows."""
    _need_card()
    from hymet_tpu_torch.ops import align_kernels as ak

    codes, row_len, k, w = MIN_SETS[name]
    packed, mask, L = pack_code_batch(codes)
    packed, mask = torch.from_numpy(packed).cuda(), torch.from_numpy(mask).cuda()
    for rl in (None, torch.from_numpy(row_len).cuda()):
        n = int(ak.minimizers_torch(packed, mask, L, k, w, 1, rl)[4])
        for cap in (n + 100, max(1, n // 3)):
            _dirty(cap, codes.size // 2048 + 64)
            before = ak.minimizers.launches
            got = ak.minimizers(packed, mask, L, k, w, cap, rl)
            want = ak.minimizers_torch(packed, mask, L, k, w, cap, rl)
            torch.cuda.synchronize()
            assert ak.minimizers.launches == before + 1
            assert int(want[4]) == n
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
def test_minimizers_kernel_gives_one_order_across_calls():
    """Tiles take their ids from an atomic counter in whatever order the
    blocks start: 20 calls on one input give identical outputs."""
    _need_card()
    from hymet_tpu_torch.ops import align_kernels as ak

    codes, row_len, k, w = MIN_SETS["more_tiles_than_resident"]
    packed, mask, L = pack_code_batch(codes)
    packed, mask = torch.from_numpy(packed).cuda(), torch.from_numpy(mask).cuda()
    rl = torch.from_numpy(row_len).cuda()
    first = ak.minimizers(packed, mask, L, k, w, 1 << 20, rl)
    assert 0 < int(first[4]) <= 1 << 20
    for _ in range(19):
        again = ak.minimizers(packed, mask, L, k, w, 1 << 20, rl)
        torch.cuda.synchronize()
        for a, b in zip(again, first):
            assert torch.equal(a, b)


@pytest.fixture(scope="module")
def repeat_world():
    """A repetitive index (a unit in 16 copies, another in 17: hashes at
    max_occ and above it; a 40 kbp genome) and a batch of query rows."""
    from hymet_tpu_torch.io.minimizer_index import MinimizerIndex

    rng = np.random.default_rng(11)
    unit, other, long_g = (_ACGT[rng.integers(0, 4, n)].tobytes() for n in (3000, 3000, 40000))
    genomes = [(f"u{i}", unit) for i in range(16)] + [(f"o{i}", other) for i in range(17)]
    index = MinimizerIndex.build(genomes + [("long", long_g)], device="cpu")
    rows = [unit, other, long_g, unit[:500] + other[:500], unit[:30]]
    codes = np.full((len(rows), 1 << 16), 4, np.uint8)
    for r, q in enumerate(rows):
        codes[r, : len(q)] = _ACGT.searchsorted(np.frombuffer(q, np.uint8))
    packed, mask, L = pack_code_batch(codes)
    return index, torch.from_numpy(packed), torch.from_numpy(mask), L


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [8192, 1000])
@pytest.mark.parametrize("acap", [1 << 17, 3000])
@pytest.mark.parametrize("ccap", [1024, 7])
def test_anchor_and_chain_kernels_match_plain(repeat_world, cap, acap, ccap):
    """Sorted anchors (occurrences up to max_occ and above, a cap that cuts
    the minimizers, an acap that cuts the anchors) and chains (one of about
    4000 anchors, a ccap that cuts them) bit for bit."""
    _need_card()
    from hymet_tpu_torch.models.aligner import MinimizerAligner
    from hymet_tpu_torch.ops import align_kernels as ak

    index, packed, mask, L = repeat_world
    aln = MinimizerAligner(index, device="cuda")
    mz = ak.minimizers_torch(packed.cuda(), mask.cuda(), L, 19, 19, cap)
    got = ak.anchors(*mz, aln._tables, 16, 11, acap, packed.shape[0], L)
    want = ak.sorted_anchors_torch(*mz, aln._tables, 16, 11, acap, packed.shape[0], L)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    sorted_ = want[:3]
    got = ak.chains(*sorted_, 19, 3, 40, ccap)
    want = ak.chains_torch(*sorted_, 19, 3, 40, ccap)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(want[1]) > 0


ANCHOR_SETS = {name: rest for name, *rest in chip_smoke.anchor_edge_sets()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ANCHOR_SETS))
def test_anchors_kernel_matches_plain_on_edge_sets(name):
    """The kernel's sorted anchors and n_anchors bit for bit, one wrapper
    call a call, against ``sorted_anchors_torch`` on the anchor edge sets
    (chip_smoke.anchor_edge_sets: runs of equal keys over several sort
    tiles, rows without anchors, none at all, overflow, a 43-bit compact
    key in 64 bits, the band at its extremes), at the set's acap and at a
    seventh of it, with the allocator's free blocks dirtied first so that a
    slot left unwritten shows."""
    _need_card()
    from hymet_tpu_torch.ops import align_kernels as ak

    genomes, codes, band_bits, acap = ANCHOR_SETS[name]
    _index, tables, mz, B, L = chip_smoke.anchor_inputs(genomes, codes, device="cuda")
    for cut in (acap, max(1, acap // 7)):
        _dirty(4 * cut, 4 * cut, mz[0].numel())
        before = ak.anchors.launches
        got = ak.anchors(*mz, tables, chip_smoke.MAX_OCC, band_bits, cut, B, L)
        want = ak.sorted_anchors_torch(*mz, tables, chip_smoke.MAX_OCC, band_bits, cut, B, L)
        torch.cuda.synchronize()
        assert ak.anchors.launches == before + 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


CHAIN_SETS = {name: rest for name, *rest in chip_smoke.chain_edge_sets(longest=True)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CHAIN_SETS))
def test_chains_kernel_matches_plain_at_tile_edges(name):
    """The chain kernel's rows and n_chains bit for bit, one launch a call,
    on the sets at its tile edges (chip_smoke.chain_edge_sets: sizes around
    a tile, chains over 5 and 260 tiles, starts and ends at tile edges,
    thresholds, padding from mid-tile and from a tile start, none and only
    padding, a ccap that cuts the rows), with the allocator's free blocks
    dirtied first so that a row left unwritten shows."""
    _need_card()
    from hymet_tpu_torch.ops import align_kernels as ak

    key, p, r, cargs = CHAIN_SETS[name]
    args = tuple(torch.from_numpy(x).cuda() for x in (key, p, r))
    dirty = [torch.full((n,), -1, dtype=torch.int32, device="cuda")
             for n in (9 * cargs[3], 8 * len(key), 8 * len(key) // 2048 + 8)]
    del dirty
    before = ak.chains.launches
    got = ak.chains(*args, *cargs)
    want = ak.chains_torch(*args, *cargs)
    torch.cuda.synchronize()
    assert ak.chains.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B, L", [(65, 1 << 16), (5, (1 << 25) + 1)])
def test_anchors_kernel_refuses_batches_past_the_key_layout(repeat_world, B, L):
    """On the card too, a batch whose packed keys would wrap raises before
    any launch."""
    _need_card()
    from hymet_tpu_torch.models.aligner import MinimizerAligner
    from hymet_tpu_torch.ops import align_kernels as ak

    index, packed, mask, L0 = repeat_world
    aln = MinimizerAligner(index, device="cuda")
    mz = ak.minimizers_torch(packed.cuda(), mask.cuda(), L0, 19, 19, 8192)
    before = ak.anchors.launches
    with pytest.raises(ValueError, match="packed key layout"):
        ak.anchors(*mz, aln._tables, 16, 11, 1 << 17, B, L)
    assert ak.anchors.launches == before


@pytest.mark.gpu
def test_align_slice_kernel_matches_plain_on_card(tmp_path):
    """run_align_stage on the card: the index built by the kernel equals the
    numpy twin's, the three kernels are launched, and resultados.paf is the
    same bytes as with the plain versions."""
    _need_card()
    from hymet_tpu_torch.io.minimizer_index import MinimizerIndex
    from hymet_tpu_torch.models.aligner import MinimizerAligner
    from hymet_tpu_torch.ops import align_kernels as ak
    from hymet_tpu_torch.pipeline.align_stage import run_align_stage

    rng = np.random.default_rng(5)
    genomes = [(f"g{i}", _ACGT[rng.integers(0, 4, n)].tobytes()) for i, n in enumerate((90000, 60000, 300))]
    seqs = [genomes[0][1][5000:25000], genomes[1][1][:8000] + genomes[0][1][50000:58000],
            _ACGT[rng.integers(0, 4, 6000)].tobytes(), genomes[1][1][100:130]]
    names = [f"c{i}" for i in range(len(seqs))]
    fasta = tmp_path / "combined_genomes.fasta"
    fasta.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in genomes))
    card = MinimizerIndex.build(genomes, device="cuda")
    host = MinimizerIndex.build(genomes, device="cpu")
    for f in ("hashes", "seq_id", "pos", "strand", "lengths"):
        assert getattr(card, f).dtype == getattr(host, f).dtype
        np.testing.assert_array_equal(getattr(card, f), getattr(host, f))
    for fn in ak.KERNELS:
        fn.launches = 0
    staged = StagedContigs(names, seqs, 1 << 16, 38, device="cuda")
    paf = run_align_stage(str(fasta), names, seqs, str(tmp_path / "kernel"), staged=staged, device="cuda")
    assert all(fn.launches > 0 for fn in ak.KERNELS)
    launched = [fn.launches for fn in ak.KERNELS]
    with mock.patch.dict(MinimizerAligner.__init__.__kwdefaults__, ops=ak.PLAIN):
        plain = run_align_stage(str(fasta), names, seqs, str(tmp_path / "plain"), staged=staged, device="cuda")
    assert [fn.launches for fn in ak.KERNELS] == launched
    assert os.path.getsize(paf) > 0 and filecmp.cmp(paf, plain, shallow=False)


LCA_SETS = {(seed, name): rest for seed in (0, 1, 2)
            for name, *rest in chip_smoke.lca_edge_sets(seed, big_q=16)}


@pytest.mark.gpu
@pytest.mark.parametrize("seed,name", list(LCA_SETS))
def test_lca_kernel_matches_plain_bit_for_bit(seed, name):
    """weighted_lca's kernel equals weighted_lca_torch on the card, names,
    depths and float64 confidence bits, at every bucket size
    (chip_smoke.lca_edge_sets: ties on purpose, -1 rows and padding
    queries, all-zero rank rows, no name at rank 0, zero totals)."""
    _need_card()
    from hymet_tpu_torch.ops import lca

    rows, w, table = (torch.from_numpy(x).cuda() for x in LCA_SETS[seed, name])
    before = lca.weighted_lca.launches
    got = lca.weighted_lca(rows, w, table)
    want = lca.weighted_lca_torch(rows, w, table)
    torch.cuda.synchronize()
    assert lca.weighted_lca.launches == before + 1
    chip_smoke.check_equal(f"lca seed {seed}, {name}", got, want)
    assert set(want[1].tolist()) >= {0, 8}


@pytest.mark.gpu
@pytest.mark.parametrize("Q,H", [(4096, 8), (513, 32), (37, 128), (1, 2048), (3, 5), (2, 1000)])
def test_lca_kernel_matches_plain_on_random_batches(Q, H):
    """Many queries a launch, and hit counts that are no bucket size."""
    _need_card()
    from hymet_tpu_torch.ops import lca

    rng = np.random.default_rng(Q * H)
    table = torch.from_numpy(rng.integers(0, 4, (50, 8)).astype(np.int32)).cuda()
    rows = torch.from_numpy(rng.integers(-1, 50, (Q, H)).astype(np.int32)).cuda()
    w = torch.from_numpy(rng.random((Q, H)) * 10.0 ** rng.uniform(-3, 3, (Q, H))).cuda()
    chip_smoke.check_equal(f"lca [{Q}, {H}]", lca.weighted_lca(rows, w, table),
                           lca.weighted_lca_torch(rows, w, table))


@pytest.mark.gpu
def test_lca_kernel_refuses_more_hits_than_the_largest_bucket():
    _need_card()
    from hymet_tpu_torch.ops import lca

    before = lca.weighted_lca.launches
    with pytest.raises(ValueError, match="H <= 2048"):
        lca.weighted_lca(torch.zeros((1, 2049), dtype=torch.int32, device="cuda"),
                         torch.zeros((1, 2049), dtype=torch.float64, device="cuda"),
                         torch.zeros((1, 8), dtype=torch.int32, device="cuda"))
    assert lca.weighted_lca.launches == before


@pytest.mark.gpu
def test_execute_on_card_matches_cpu(tmp_path):
    """ClassificationRun.execute on the card (60 gut contigs, the in-repo
    sketch DBs, genomes and taxonomy, 5 candidates) writes the bytes the
    same run writes on the CPU, through the LCA kernel, with no
    first-hit fallback."""
    _need_card()
    from hymet_tpu_torch.ops import lca
    from hymet_tpu_torch.pipeline.run import ClassificationRun
    from hymet_tpu_torch.utils.config import RunConfig

    names, seqs = read_fasta(os.path.join(WORLD, "data", "camisyn_gut", "contigs.fna"))
    sample = tmp_path / "gut60.fna"
    sample.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in zip(names[:60], seqs[:60])))
    outs = {}
    for device in ("cuda", "cpu"):
        cfg = RunConfig(input_fasta=str(sample), outdir=str(tmp_path / device), cand_max=5,
                        cache_root=str(tmp_path / f"cache_{device}"),
                        taxonomy_dir=os.path.join(WORLD, "taxonomy"),
                        sketch_dbs=[os.path.join(WORLD, f"{label}.npz") for label in LABELS],
                        genome_catalog=os.path.join(WORLD, "genomes"),
                        seqid2taxid=os.path.join(WORLD, "acc2taxid.tsv"))
        lca.weighted_lca.launches = 0
        run = ClassificationRun(cfg, device=device)
        run.execute()
        assert not run.fallback_ran
        outs[device] = (cfg.outdir, lca.weighted_lca.launches)
    assert outs["cuda"][1] > 0 and outs["cpu"][1] == 0
    for name in ("work/selected_genomes.txt", "work/resultados.paf", "classified_sequences.tsv",
                 "hymet.gut60.cami.tsv"):
        a, b = (os.path.join(outs[d][0], name) for d in ("cuda", "cpu"))
        assert os.path.getsize(a) > 0 and filecmp.cmp(a, b, shallow=False), name


@pytest.mark.gpu
def test_bench_on_card_matches_cpu(tmp_path, monkeypatch):
    """run_bench of 60 gut contigs (with the committed truth files, 5
    candidates) under HYMET_PLATFORM=cuda and =cpu: the same files, byte
    for byte, but the measured columns of runtime_memory.tsv, the run's
    own metadata.json, the output root in _debug_info.txt and the figures
    (none where matplotlib is missing); the card's run through the LCA
    kernel."""
    _need_card()
    from hymet_tpu_torch.harness.bench import run_bench
    from hymet_tpu_torch.ops import lca

    gut = os.path.join(WORLD, "data", "camisyn_gut")
    names, seqs = read_fasta(os.path.join(gut, "contigs.fna"))
    sample = tmp_path / "gut60.fna"
    sample.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in zip(names[:60], seqs[:60])))
    (tmp_path / "m.tsv").write_text(
        "sample_id\tcontigs_fa\ttruth_contigs_tsv\ttruth_profile_tsv\n"
        f"gut60\t{sample}\t{gut}/truth_contigs.tsv\t{gut}/truth_profile.tsv\n")
    for name, value in {"SKETCH_DBS": os.pathsep.join(os.path.join(WORLD, f"{label}.npz")
                                                      for label in LABELS),
                        "GENOME_CATALOG": os.path.join(WORLD, "genomes"),
                        "SEQID2TAXID": os.path.join(WORLD, "acc2taxid.tsv"),
                        "TAXONOMY_DIR": os.path.join(WORLD, "taxonomy"), "CAND_MAX": "5"}.items():
        monkeypatch.setenv(name, value)
    launches = {}
    for platform in ("cuda", "cpu"):
        monkeypatch.setenv("HYMET_PLATFORM", platform)
        monkeypatch.setenv("CACHE_ROOT", str(tmp_path / f"cache_{platform}"))
        lca.weighted_lca.launches = 0
        assert run_bench(str(tmp_path / "m.tsv"), ["hymet_tpu"],
                         out_root=str(tmp_path / platform)) == 0
        launches[platform] = lca.weighted_lca.launches
    assert launches["cuda"] > 0 and launches["cpu"] == 0
    files = {}
    for platform in ("cuda", "cpu"):
        root = tmp_path / platform
        files[platform] = sorted(os.path.relpath(os.path.join(d, f), root)
                                 for d, _, fs in os.walk(root) for f in fs
                                 if not d.endswith("figures"))
    assert files["cuda"] == files["cpu"] and "gut60/hymet_tpu/eval/profile_summary.tsv" in files["cpu"]
    for rel in files["cpu"]:
        a, b = tmp_path / "cuda" / rel, tmp_path / "cpu" / rel
        if rel == "runtime_memory.tsv":
            assert [ln.split("\t")[:3] for ln in a.read_text().splitlines()] == [
                ln.split("\t")[:3] for ln in b.read_text().splitlines()]
        elif rel.endswith("_debug_info.txt"):  # names the files under each root
            assert a.read_text().replace(str(tmp_path / "cuda"), "ROOT") == b.read_text().replace(
                str(tmp_path / "cpu"), "ROOT"), rel
        elif rel != "gut60/hymet_tpu/work_out/metadata.json":
            assert filecmp.cmp(a, b, shallow=False), rel


# ----------------------------------------------------------------------
# the DB build: bottom_sketch, sketch_codes, sketch_batch, build_sketch_db

SKETCH_SETS = {name: rest for name, *rest in chip_smoke.bottom_sketch_edge_sets(0)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SKETCH_SETS))
def test_bottom_sketch_kernel_matches_plain(name):
    """chip_smoke.bottom_sketch_edge_sets: s = 1, 7, 1000, above a wave and
    above the windows; poly-A; duplicates across waves; an all-invalid row;
    a real PAD_HASH; a wave's and a chunk's edges; 37 waves; pooled
    segments; the sign edge; descending keys; ties at the s-th key; a
    sparse first chunk. Sketches and counts equal the plain version's, one
    launch a call."""
    _need_card()
    from hymet_tpu_torch.ops import sketch_kernels

    h, v, s, segments = SKETCH_SETS[name]
    h, v = torch.from_numpy(h).cuda(), torch.from_numpy(v).cuda()
    before = sketch_kernels.bottom_sketch.launches
    got = sketch_kernels.bottom_sketch(h, v, s, segments)
    want = sketch_kernels.bottom_sketch_torch(h, v, s, segments)
    torch.cuda.synchronize()
    assert sketch_kernels.bottom_sketch.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


CODES_SETS = {name: rest for name, *rest in chip_smoke.sketch_codes_edge_sets(0)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CODES_SETS))
def test_sketch_codes_kernel_matches_plain(name):
    """chip_smoke.sketch_codes_edge_sets: s = 1, 7, 1000, 5000, 10,000 and
    above the windows; poly-A, a repeat, all-N and half-N rows; L at a
    wave's and a chunk's edges; one row much longer than the rest; k = 15,
    21, 31. Sketches and counts equal the plain version's, one launch a
    call, no kmer_hash launch."""
    _need_card()
    from hymet_tpu_torch.ops import sketch_kernels

    codes, k, s = CODES_SETS[name]
    codes = torch.from_numpy(codes).cuda()
    before = (sketch_kernels.sketch_codes.launches, hash_kernels.kmer_hashes.launches)
    got = sketch_kernels.sketch_codes(codes, k, s)
    want = sketch_kernels.sketch_codes_torch(codes, k, s)
    torch.cuda.synchronize()
    assert (sketch_kernels.sketch_codes.launches, hash_kernels.kmer_hashes.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_sketch_codes_kernel_refuses_what_it_does_not_take():
    _need_card()
    from hymet_tpu_torch.ops import sketch_kernels

    before = sketch_kernels.sketch_codes.launches
    codes = torch.zeros((2, 64), dtype=torch.uint8, device="cuda")
    for args in ((codes.int(), 21, 5), (codes[0], 21, 5), (codes[:, ::2], 21, 5), (codes, 0, 5),
                 (codes, 33, 5), (codes, 21, 0), (codes, 21, 2**31)):
        with pytest.raises(ValueError):
            sketch_kernels.sketch_codes(*args)
    assert sketch_kernels.sketch_codes.launches == before


@pytest.mark.gpu
def test_bottom_sketch_kernel_refuses_what_it_does_not_take():
    _need_card()
    from hymet_tpu_torch.ops import sketch_kernels

    before = sketch_kernels.bottom_sketch.launches
    h = torch.zeros((2, 10), dtype=torch.int64, device="cuda")
    v = torch.ones((2, 10), dtype=torch.bool, device="cuda")
    for args in ((h.int(), v, 5), (h, v.int(), 5), (h[:, ::2], v[:, ::2], 5), (h, v, 0),
                 (h, v.cpu(), 5)):
        with pytest.raises(ValueError):
            sketch_kernels.bottom_sketch(*args)
    with pytest.raises(ValueError, match="segments"):
        sketch_kernels.bottom_sketch(h, v, 5, [3])
    assert sketch_kernels.bottom_sketch.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,k,s", [(3, 20_000, 21, 1000), (5, 4118, 15, 7), (2, 40, 32, 1)])
def test_sketch_batch_on_card_matches_cpu(B, L, k, s):
    _need_card()
    from hymet_tpu_torch.ops.sketch import sketch_batch

    rng = np.random.default_rng(B * L)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[0, 100:150] = 4
    codes[-1] = 0  # poly-A
    got = sketch_batch(torch.from_numpy(codes).cuda(), k, s)
    want = sketch_batch(torch.from_numpy(codes), k, s)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert int(want[1][-1]) == 1


@pytest.mark.gpu
def test_build_sketch_db_on_card_equals_committed(tmp_path):
    """sketch1 rebuilt on the card from its 78 genome files equals the
    committed sketch1.npz bit for bit through sketch_codes alone (no
    kmer_hash launch), and again with a window budget that puts every
    genome up in pieces folded by bottom_sketch."""
    _need_card()
    from hymet_tpu_torch.io import sketchdb

    want = load_sketch_db(os.path.join(WORLD, "sketch1.npz"))
    files = chip_smoke.db_files("sketch1")
    from hymet_tpu_torch.ops import sketch_kernels

    def launches():
        return (sketch_kernels.sketch_codes.launches, hash_kernels.kmer_hashes.launches,
                sketch_kernels.bottom_sketch.launches)

    before = launches()
    chip_smoke.same_db(sketchdb.build_sketch_db(files, 21, 1000, device="cuda"), want, "sketch1")
    after = launches()
    # the fused kernel, and neither kmer_hash nor a fold (no genome in pieces)
    assert after[0] > before[0] and after[1:] == before[1:]
    with mock.patch.dict(sketchdb.BUILD_WINDOWS, cuda=300_000):
        chip_smoke.same_db(sketchdb.build_sketch_db(files[:6], 21, 1000, device="cuda"),
                           sketchdb.SketchDB(k=21, sketch_size=1000, hashes=want.hashes[:6],
                                             n_hashes=want.n_hashes[:6], names=want.names[:6],
                                             lengths=want.lengths[:6]), "sketch1[:6] in pieces")
    pieces = launches()
    assert pieces[0] > after[0] and pieces[1] == after[1] and pieces[2] > after[2]


@pytest.mark.gpu
def test_contig_remap_on_card_matches_plain(tmp_path):
    """The evaluator's remap of 60 gut contigs against their second
    assembly (chip_smoke.second_assembly), unstaged through minimizers,
    anchors and chains: each launched, and the same pairs, every one a
    contig's own counterpart, as through the plain versions on the card
    and on the CPU."""
    _need_card()
    names, seqs = read_fasta(chip_smoke.CONTIGS)
    names, seqs = names[:60], seqs[:60]
    pred = tmp_path / "pred.fna"
    pred.write_text("".join(f">{n}\n{q.decode()}\n" for n, q in zip(names, seqs)))
    asm2 = str(tmp_path / "asm2.fna")
    new = chip_smoke.second_assembly(names, seqs, dict.fromkeys(names, "1"), asm2,
                                     str(tmp_path / "t.tsv"))
    chip_smoke.zero_launches()
    got = eval_cami._contig_remap(str(pred), asm2, device="cuda")
    launches = chip_smoke.align_launches()
    with chip_smoke.plain_ops():
        plain = eval_cami._contig_remap(str(pred), asm2, device="cuda")
    assert all(n > 0 for n in launches.values()), launches
    assert got == plain == eval_cami._contig_remap(str(pred), asm2, device="cpu")
    assert len(got) >= 30 and all(t == new[names.index(q)] for q, t in got.items())
