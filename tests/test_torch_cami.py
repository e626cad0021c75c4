"""hymet_tpu_torch.evalx.cami against hymet_tpu's: ``hymet.<sample>.cami.tsv``
byte for byte from crafted classified TSVs (CRLF and LF, unknown rank
labels, names the taxonomy lacks, Unknown rows, strain ranks), count- and
length-weighted, and the tallies behind them."""

import filecmp

import pytest

from hymet_tpu.data.zymo_taxonomy import ZYMO_TAXONOMY_RECORDS
from hymet_tpu.evalx import cami as jcami
from hymet_tpu.taxonomy.db import TaxonomyDB as JDB
from hymet_tpu_torch.evalx import cami as tcami
from hymet_tpu_torch.taxonomy.db import TaxonomyDB as TDB

ROWS = [
    ("c1", "superkingdom:Bacteria; phylum:Bacillota; class:Bacilli; order:Bacillales; family:Bacillaceae; "
           "genus:Bacillus; species:Bacillus subtilis", "species", "0.9000"),
    ("c2", "superkingdom:Bacteria; phylum:Pseudomonadota; class:Gammaproteobacteria; order:Enterobacterales; "
           "family:Enterobacteriaceae; genus:Escherichia; species:Escherichia coli; strain:K-12", "strain", "1.0000"),
    ("c3", "superkingdom:Bacteria; phylum:Pseudomonadota; genus:Escherichia", "genus", "0.5000"),
    ("c4", "Unknown", "root", "0.0000"),
    ("c5", "sk:Bacteria; p:Bacillota; foo:bar; species:Not in taxonomy", "species", "0.3000"),
    ("c6", "domain:Bacteria;phylum:Bacillota;species:Bacillus subtilis", "species", "0.7000"),
    ("c7", "", "root", "0.0000"),
    ("c8", "superkingdom:Eukaryota", "superkingdom", "1.0000"),
]


@pytest.fixture(scope="module")
def dbs():
    return TDB.from_records(ZYMO_TAXONOMY_RECORDS), JDB.from_records(ZYMO_TAXONOMY_RECORDS)


@pytest.mark.parametrize("eol", ["\r\n", "\n"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cami_profile_matches_jax_bytes(tmp_path, dbs, eol, weighted):
    classified = tmp_path / "classified_sequences.tsv"
    with open(classified, "w", newline="") as f:
        f.write("Query\tLineage\tTaxonomic Level\tConfidence" + eol)
        for row in ROWS:
            f.write("\t".join(row) + eol)
    lengths = {"c1": 5000, "c2": 120, "c6": 7} if weighted else None
    t, j = tmp_path / "hymet.sample.cami.tsv", tmp_path / "j.tsv"
    n = tcami.classified_to_cami(str(classified), dbs[0], str(t), "sample", lengths=lengths)
    assert n == jcami.classified_to_cami(str(classified), dbs[1], str(j), "sample", lengths=lengths) == 6
    assert filecmp.cmp(t, j, shallow=False)
    text = t.read_text()
    assert text.startswith("#CAMI Submission for Taxonomic Profiling\n") and "@SampleID:sample" in text
    assert "\tspecies\t" in text and "Not in taxonomy" not in text


def test_tallies_and_emit_match_jax(dbs):
    import io

    lineages = [tcami.parse_lineage_cami(r[1]) for r in ROWS]
    assert lineages == [jcami.parse_lineage_cami(r[1]) for r in ROWS]
    names = {n for lin in lineages for n in lin.values() if n}
    name2tid = dbs[0].batch_name2taxid(names)
    for weights in (None, [3, 1, 4, 1, 5, 9, 2, 6]):
        got = tcami.tally_by_rank(lineages, name2tid, weights)
        want = jcami.tally_by_rank(lineages, name2tid, weights)
        assert got == want
        paths = {tid: dbs[0].taxpath(tid)[::-1] for tid in got[2]}
        a, b = io.StringIO(), io.StringIO()
        tcami.emit_cami(a, *got[:2], paths, "s0")
        jcami.emit_cami(b, *want[:2], paths, "s0")
        assert a.getvalue() == b.getvalue()
