"""hymet_tpu_torch's dataset tools against hymet_tpu's on the CPU:
``subset_fasta``, ``make_seqid_map``, ``build_test_dataset`` on the in-repo
genomes (the same seed gives the same bytes: ``random.Random(seed)`` picks
the genomes, ``random.Random(seed + 1)`` mutates them, in the same call
order), ``generate_cami_subsets`` on the gut sample, and the curated Zymo
taxonomy. Every file byte for byte, every return value equal."""

import filecmp
import os
import random

import pytest

from hymet_tpu.data import cami_subsets as JS
from hymet_tpu.data import subsets as JF
from hymet_tpu.data import testdataset as JT
from hymet_tpu.data.zymo_taxonomy import ZYMO_TAXONOMY_RECORDS as J_RECORDS
from hymet_tpu.data.zymo_taxonomy import zymo_taxdb as j_zymo
from hymet_tpu.taxonomy.db import TaxonomyDB as JDB
from hymet_tpu_torch.data import cami_subsets as TS
from hymet_tpu_torch.data import subsets as TF
from hymet_tpu_torch.data import testdataset as TT
from hymet_tpu_torch.data.zymo_taxonomy import ZYMO_TAXONOMY_RECORDS as T_RECORDS
from hymet_tpu_torch.data.zymo_taxonomy import zymo_taxdb as t_zymo
from hymet_tpu_torch.taxonomy.db import TaxonomyDB as TDB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "validation", "work_cami_suite")
GUT = os.path.join(WORLD, "data", "camisyn_gut")
CONTIGS = os.path.join(GUT, "contigs.fna")
GENOMES = os.path.join(WORLD, "genomes")
HIER = os.path.join(WORLD, "taxonomy", "taxonomy_hierarchy.tsv")


def _same_tree(a, b):
    """Two directories hold the same files, byte for byte."""
    walk = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)
                               for d, _, fs in os.walk(root) for f in fs)
    names = walk(a)
    assert names == walk(b) and names
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name
    return names


@pytest.mark.parametrize("caps", [(1000, 500_000_000), (7, 10**9), (1000, 60_000), (3, 1),
                                  (0, 100), (5, 0)])
def test_subset_fasta_writes_the_jax_file(tmp_path, caps):
    """Sequence and base caps; a base cap inside a contig cuts it and ends
    the subset."""
    got = TF.subset_fasta(CONTIGS, str(tmp_path / "t" / "s.fna"), *caps)
    want = JF.subset_fasta(CONTIGS, str(tmp_path / "j" / "s.fna"), *caps)
    assert got == want
    assert filecmp.cmp(tmp_path / "t" / "s.fna", tmp_path / "j" / "s.fna", shallow=False)


def test_make_seqid_map_writes_the_jax_table(tmp_path):
    rng = random.Random(4)
    heads = [f"CSU_{i:04d}.1_chr1" for i in range(40)] + ["NC_9.2 x", "a|CSU_0003.1|b", "nothing"]
    fasta = tmp_path / "seqs.fna"
    fasta.write_text("".join(f">{h}\nACGT\n" for h in rng.sample(heads, len(heads))))
    id_map = {f"CSU_{i:04d}.1_chr1": str(i) for i in range(0, 40, 3)}
    id_map.update({"NC_9": "9", "CSU_0003": "3"})
    got = TF.make_seqid_map(str(fasta), id_map, str(tmp_path / "t.tsv"))
    assert got == JF.make_seqid_map(str(fasta), id_map, str(tmp_path / "j.tsv"))
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()


@pytest.mark.parametrize("seed", [0, 7])
def test_build_test_dataset_writes_the_jax_files(tmp_path, seed):
    """The in-repo genomes (260, gzipped) at fraction_genomes = 0.05: the
    same 13 genomes picked, trimmed and mutated, the same FASTAs and
    gcf2seqid.tsv."""
    got = TT.build_test_dataset(GENOMES, str(tmp_path / "t"), fraction_genomes=0.05, seed=seed)
    want = JT.build_test_dataset(GENOMES, str(tmp_path / "j"), fraction_genomes=0.05, seed=seed)
    assert got == want and len(got) == 13
    names = _same_tree(tmp_path / "t", tmp_path / "j")
    assert "gcf2seqid.tsv" in names


def test_test_dataset_helpers_equal_jax(tmp_path, mini_taxdb):
    seqs = [("a", b"ACGTNACGTACGTRYACGT" * 30), ("b", b"AC"), ("c", b"GGGGTTTTAAAACCCC" * 7)]
    for parts in (seqs[:1], seqs, seqs[1:]):
        for frac in (0.1, 0.5, 1.0):
            assert TT.trim_first_fraction(parts, frac) == JT.trim_first_fraction(parts, frac)
    for rate in (0.0, 0.02, 0.5):
        got = TT.mutate_sequence(seqs[0][1], rate, random.Random(3))
        assert got == JT.mutate_sequence(seqs[0][1], rate, random.Random(3))
    files = sorted(os.path.join(GENOMES, d, f) for d in os.listdir(GENOMES)[:5]
                   for f in os.listdir(os.path.join(GENOMES, d)))
    assert TT.sample_genomes(files, 0.5, 2) == JT.sample_genomes(files, 0.5, 2)
    assert TT.extract_gcf_seqids(files) == JT.extract_gcf_seqids(files)
    gcf_taxids = {"GCF_1": "562", "GCF_2": "1423", "GCF_3": "424242"}
    TT.extract_taxonomy_table(gcf_taxids, t_zymo(), str(tmp_path / "t.csv"))
    JT.extract_taxonomy_table(gcf_taxids, mini_taxdb, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.fixture(scope="module")
def gsa_mapping(tmp_path_factory):
    """The gut sample as a gsa_mapping truth table: contig, genome, taxid,
    two filler columns, start and end (1-based), a blank line and a short
    row the reader skips."""
    tmp = tmp_path_factory.mktemp("gsa")
    lengths = {}
    name = None
    with open(CONTIGS) as f:
        for ln in f:
            if ln.startswith(">"):
                name = ln[1:].split()[0]
                lengths[name] = 0
            else:
                lengths[name] += len(ln.strip())
    with open(os.path.join(GUT, "truth_contigs.tsv")) as f:
        rows = [ln.split() for ln in f][1:]
    path = tmp / "gsa_mapping.tsv"
    with open(path, "w") as f:
        f.write("#anonymous_contig_id\tgenome_id\ttax_id\tcontig_id\tnumber_reads\tstart\tend\n")
        for i, (contig, taxid) in enumerate(rows):
            f.write(f"{contig}\tg{taxid}\t{taxid}\tx{i}\t9\t1\t{lengths[contig]}\n")
        f.write("\nshort\trow\n")
    return str(path)


@pytest.mark.parametrize("partitions", [
    tuple(JS.DEFAULT_PARTITIONS),
    (("first", 1), ("next", 30), ("rest", 100)),
])
def test_generate_cami_subsets_writes_the_jax_files(tmp_path, gsa_mapping, partitions):
    """The gut sample's 135 taxa split by assembled length into derived
    samples, with the world's taxonomy: the same taxa a sample, the same
    contigs.fna, truth_contigs.tsv and truth_profile.tsv."""
    got = TS.generate_cami_subsets(CONTIGS, gsa_mapping, TDB.from_hierarchy_tsv(HIER),
                                   str(tmp_path / "t"), partitions)
    want = JS.generate_cami_subsets(CONTIGS, gsa_mapping, JDB.from_hierarchy_tsv(HIER),
                                    str(tmp_path / "j"), partitions)
    assert got == want and list(got) == [name for name, _ in partitions]
    assert len(_same_tree(tmp_path / "t", tmp_path / "j")) == 3 * len(partitions)


def test_generate_cami_subsets_refuses_like_jax(tmp_path, gsa_mapping):
    for gen, db in ((TS.generate_cami_subsets, TDB), (JS.generate_cami_subsets, JDB)):
        with pytest.raises(RuntimeError, match="Not enough taxa for big: requested 200, got 135"):
            gen(CONTIGS, gsa_mapping, db.from_hierarchy_tsv(HIER), str(tmp_path / gen.__module__),
                [("big", 200)])


def test_zymo_taxonomy_equals_jax(tmp_path):
    assert T_RECORDS == J_RECORDS
    got, want = t_zymo(), j_zymo()
    assert (got.name, got.rank, got.parent) == (want.name, want.rank, want.parent)
    got.write_hierarchy_tsv(str(tmp_path / "t.tsv"))
    want.write_hierarchy_tsv(str(tmp_path / "j.tsv"))
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    for tid in ("562", "511145", "5207", "2"):
        assert got.taxpath(tid) == want.taxpath(tid)
