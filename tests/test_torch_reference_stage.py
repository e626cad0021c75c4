"""hymet_tpu_torch.pipeline.reference_stage against hymet_tpu's:
``combined_genomes.fasta`` and ``detailed_taxonomy.tsv`` byte for byte,
from a local genome catalog (a directory, or a refs.tsv) and from a preset
combined FASTA. No test reaches the download path."""

import filecmp
import gzip

import pytest

from hymet_tpu.pipeline import reference_stage as jref
from hymet_tpu_torch.pipeline import reference_stage as tref

GENOMES = {
    # accession -> (taxid, FASTA text, gzipped)
    "GCF_000000001.1": ("1423", ">bsub_chr1 chromosome\nACGTACGT\nACG\n>bsub_p1 plasmid\nTTTT\n", True),
    "GCF_000000002.1": ("562", ">ecoli_chr\nGGGGCCCC\nAA", False),  # no final newline
    "GCA_000000003.2": ("", ">paer_chr x\nCCCC\n", True),  # no taxid known
    "GCF_000000004.1": ("1280", ">saur\nAC\n", False),
}


@pytest.fixture()
def catalog_dir(tmp_path):
    d = tmp_path / "genomes"
    (d / "sub").mkdir(parents=True)
    for acc, (_tid, text, gz) in GENOMES.items():
        fn = d / ("sub" if acc.startswith("GCA") else "") / f"{acc}_ASM{acc[-3]}v1_genomic.fna"
        if gz:
            with gzip.open(f"{fn}.gz", "wt") as f:
                f.write(text)
        else:
            fn.write_text(text)
    (d / "README.txt").write_text("not a genome\n")
    s2t = tmp_path / "acc2taxid.tsv"
    s2t.write_text("".join(f"{a}\t{t}\n" for a, (t, _x, _g) in GENOMES.items() if t) + "junk\n")
    return d, s2t


SELECTED = ["GCF_000000002.1_ASM1v1_genomic.fna", "GCA_000000003.2_ASM2v1_genomic.fna.gz",
            "GCF_000000001.1_ASM1v1_genomic.fna.gz", "GCF_999999999.1_missing_genomic.fna.gz"]


def _same_outputs(t, j):
    assert t[2:] == j[2:]  # the missing names
    for a, b in zip(t[:2], j[:2]):
        assert filecmp.cmp(a, b, shallow=False)


def test_reference_set_from_a_directory_matches_jax(catalog_dir, tmp_path):
    d, s2t = catalog_dir
    tcat = tref.LocalGenomeCatalog.from_directory(str(d), str(s2t))
    jcat = jref.LocalGenomeCatalog.from_directory(str(d), str(s2t))
    assert (tcat.paths, tcat.taxids) == (jcat.paths, jcat.taxids) and len(tcat.paths) == 4
    t = tref.build_reference_set(SELECTED, str(tmp_path / "t"), tcat)
    j = jref.build_reference_set(SELECTED, str(tmp_path / "j"), jcat)
    _same_outputs(t, j)
    assert t[2] == ["GCF_999999999.1_missing_genomic.fna.gz"]
    with open(t[0]) as f:
        assert f.read().startswith(">ecoli_chr\nGGGGCCCC\nAA\n>paer_chr x\n")
    with open(t[1], newline="") as f:
        assert f.read().split("\r\n")[1:3] == ["GCF_000000002.1\t562\tecoli_chr",
                                               "GCA_000000003.2\tUnknown TaxID\tpaer_chr"]


def test_reference_set_from_refs_tsv_matches_jax(catalog_dir, tmp_path):
    d, _s2t = catalog_dir
    refs = d / "refs.tsv"
    refs.write_text("assembly_accession\ttaxid\tlocal_fasta\tftp_file\n"
                    "GCF_000000001.1\t1423\tHYMET/case/GCF_000000001.1_ASM1v1_genomic.fna.gz\t\n"
                    "GCF_000000002.1\t562\t\tGCF_000000002.1_ASM2v1_genomic.fna\n"
                    "GCA_000000003.2\t287\t\tGCA_000000003.2_ASM2v1_genomic.fna.gz\n"
                    "GCF_000000005.1\t9\tnowhere.fna\t\n\t1\tx\t\n")
    tcat = tref.LocalGenomeCatalog.from_refs_tsv(str(refs))
    jcat = jref.LocalGenomeCatalog.from_refs_tsv(str(refs))
    assert (tcat.paths, tcat.taxids) == (jcat.paths, jcat.taxids)
    _same_outputs(tref.build_reference_set(SELECTED, str(tmp_path / "t"), tcat),
                  jref.build_reference_set(SELECTED, str(tmp_path / "j"), jcat))


@pytest.mark.parametrize("gz", [False, True])
def test_reference_from_combined_matches_jax(tmp_path, gz):
    text = ">NC_000913.3 E. coli\nACGT\nAC\n>NC_000913 dup\nGG\n>CP001.1\nTT\n>x.9\nA\n>orphan y\nC\n"
    src = tmp_path / ("combined.fna.gz" if gz else "combined.fna")
    if gz:
        with gzip.open(src, "wt") as f:
            f.write(text)
    else:
        src.write_text(text)
    s2t = tmp_path / "s2t.tsv"
    s2t.write_text("NC_000913.3\t562\nCP001\t1423\nx\t9\n")
    t = tref.build_reference_from_combined(str(src), str(tmp_path / "t"), str(s2t))
    j = jref.build_reference_from_combined(str(src), str(tmp_path / "j"), str(s2t))
    for a, b in zip(t, j):
        assert filecmp.cmp(a, b, shallow=False)
    t2 = tref.build_reference_from_combined(str(src), str(tmp_path / "t2"))  # no table
    j2 = jref.build_reference_from_combined(str(src), str(tmp_path / "j2"))
    assert filecmp.cmp(t2[1], j2[1], shallow=False)


def test_extract_gcf_and_assembly_summary_match_jax(tmp_path):
    for name in ("GCF_000005845.2_ASM584v2_genomic.fna.gz", "plain", "a_b", ""):
        assert tref.extract_gcf(name) == jref.extract_gcf(name)
    cols = ["na"] * 20
    row = list(cols)
    row[0], row[5], row[19] = "GCF_000000001.1", "1423", "https://example.invalid/GCF_000000001.1_A"
    (tmp_path / "assembly_summary_refseq.txt").write_text("# header\n" + "\t".join(row) + "\nshort\trow\n")
    t, j = tref.AssemblySummarySource(str(tmp_path)), jref.AssemblySummarySource(str(tmp_path))
    assert t.meta == j.meta and len(t.meta) == 1
    assert t.fetch("GCF_404.1", str(tmp_path)) is None  # unknown: no download is tried
