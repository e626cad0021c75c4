"""hymet_tpu_torch's align stage vs the JAX package: ``resultados.paf``
byte for byte against ``write_paf(map_batch(...))``, and the stage's
cache rules (skip on an existing PAF, reuse a matching cached index,
rebuild a corrupt, mismatched or forced one)."""

import filecmp
import os

import numpy as np
import pytest
import torch

from hymet_tpu.io.minimizer_index import MinimizerIndex as JIndex
from hymet_tpu.io.paf import write_paf as jwrite_paf
from hymet_tpu.models.aligner import AlignerConfig as JConfig
from hymet_tpu.models.aligner import MinimizerAligner as JAligner
from hymet_tpu_torch.io.fasta import read_fasta
from hymet_tpu_torch.io.minimizer_index import MinimizerIndex as TIndex
from hymet_tpu_torch.io.paf import parse_paf_for_classification
from hymet_tpu_torch.pipeline.align_stage import index_cache_path, run_align_stage
from hymet_tpu_torch.pipeline.staged import StagedContigs
from hymet_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

PAD = 1 << 14
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(77)
    genomes = [(f"G{i}_chr1", _ACGT[rng.integers(0, 4, n)].tobytes()) for i, n in enumerate((50000, 35000, 20000))]
    g = [s for _, s in genomes]
    seqs = [g[0][1000:9000], g[1][3000:15000], g[2][500:6000] + g[0][20000:26000],
            _ACGT[rng.integers(0, 4, 5000)].tobytes(), g[1][:30]]
    names = [f"contig_{i}" for i in range(len(seqs))]
    ref = tmp_path_factory.mktemp("ref")
    fasta = ref / "combined_genomes.fasta"
    # wrapped lines, as the reference build concatenates genome files
    fasta.write_text("".join(
        f">{n} some description\n" + "\n".join(s[i : i + 80].decode() for i in range(0, len(s), 80)) + "\n"
        for n, s in genomes))
    jdir = tmp_path_factory.mktemp("jax")
    jrecs = JAligner(JIndex.build_from_fasta(str(fasta)), JConfig(batch_pad=PAD)).map_batch(names, seqs)
    jwrite_paf(str(jdir / "resultados.paf"), jrecs)
    return str(fasta), names, seqs, str(jdir / "resultados.paf")


def _cfg(**kw):
    return RunConfig(align_batch_pad=PAD, **kw)


def _fresh_ref(world, tmp_path):
    """A copy of the reference FASTA in its own directory (its own cache)."""
    fasta = tmp_path / "ref" / "combined_genomes.fasta"
    fasta.parent.mkdir()
    with open(world[0], "rb") as f:
        fasta.write_bytes(f.read())
    return str(fasta)


@pytest.mark.parametrize("staged", [False, True])
def test_resultados_paf_matches_jax_bytes(world, tmp_path, staged):
    _fasta, names, seqs, jpaf = world
    fasta = _fresh_ref(world, tmp_path)
    batches = StagedContigs(names, seqs, PAD, 38, device="cpu") if staged else None
    paf = run_align_stage(fasta, names, seqs, str(tmp_path / "out"), _cfg(), staged=batches, device="cpu")
    assert paf == str(tmp_path / "out" / "resultados.paf")
    assert os.path.getsize(paf) > 0 and filecmp.cmp(paf, jpaf, shallow=False)
    # the cached index is the JAX package's file
    cached = JIndex.load(index_cache_path(fasta, _cfg()))
    want = JIndex.build_from_fasta(fasta)
    for f in ("hashes", "seq_id", "pos", "strand", "lengths"):
        np.testing.assert_array_equal(getattr(cached, f), getattr(want, f))
    query_map, ref_counts = parse_paf_for_classification(paf)
    assert set(query_map) == {"contig_0", "contig_1", "contig_2"}
    assert ref_counts["G0_chr1"] == 2


def test_existing_paf_is_kept(world, tmp_path):
    _fasta, names, seqs, jpaf = world
    fasta = _fresh_ref(world, tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    (out / "resultados.paf").write_text("kept\n")
    run_align_stage(fasta, names, seqs, str(out), _cfg(), device="cpu")
    assert (out / "resultados.paf").read_text() == "kept\n"
    assert not os.path.exists(index_cache_path(fasta, _cfg()))
    (out / "resultados.paf").write_text("")  # an empty PAF is redone
    run_align_stage(fasta, names, seqs, str(out), _cfg(), device="cpu")
    assert filecmp.cmp(str(out / "resultados.paf"), jpaf, shallow=False)


@pytest.mark.parametrize("cache", ["other_reference", "other_kw", "corrupt", "forced"])
def test_cached_index_reused_or_rebuilt(world, tmp_path, cache):
    """A cached index with cfg's k and w is used as it is (here one of
    another reference, which shows that it was used); one with other k/w,
    an unreadable one, or any under force_download is rebuilt."""
    _fasta, names, seqs, jpaf = world
    fasta = _fresh_ref(world, tmp_path)
    path = index_cache_path(fasta, _cfg())
    first = TIndex.build_from_fasta(fasta, device="cpu")
    ref_names, ref_seqs = read_fasta(fasta)
    only_first = TIndex.build([(ref_names[0], ref_seqs[0])], device="cpu")
    if cache == "corrupt":
        (tmp_path / "ref" / os.path.basename(path)).write_bytes(b"not an npz")
    elif cache == "other_kw":
        TIndex.build_from_fasta(fasta, k=15, w=10, device="cpu").save(path)
    else:
        only_first.save(path)
    paf = run_align_stage(fasta, names, seqs, str(tmp_path / "out"), _cfg(force_download=cache == "forced"),
                          device="cpu")
    reused = cache == "other_reference"
    assert filecmp.cmp(paf, jpaf, shallow=False) != reused
    assert 0 < only_first.n_minimizers < first.n_minimizers
    assert TIndex.load(path).n_minimizers == (only_first if reused else first).n_minimizers
