"""hymet_tpu_torch's classify layer against hymet_tpu's on crafted inputs:
``classify_paf`` with the host and the device backend (the port on the
CPU, the JAX package with x64 on), ``classified_sequences.tsv`` byte for
byte; the lineage and identifier helpers; the first-hit fallback; and
``TaxonomyDB`` from a small taxdump and from a hierarchy TSV (the same
``write_hierarchy_tsv`` bytes, the same lookups)."""

import filecmp

import numpy as np
import pytest
import torch

from hymet_tpu.data.zymo_taxonomy import ZYMO_TAXONOMY_RECORDS
from hymet_tpu.models import first_hit as jfirst
from hymet_tpu.models import weighted_lca as jwlca
from hymet_tpu.taxonomy import db as jdb
from hymet_tpu.taxonomy import idmap as jidmap
from hymet_tpu.taxonomy import lineage as jlineage
from hymet_tpu_torch.io import paf as tpaf
from hymet_tpu_torch.models import first_hit as tfirst
from hymet_tpu_torch.models import weighted_lca as twlca
from hymet_tpu_torch.taxonomy import db as tdb
from hymet_tpu_torch.taxonomy import idmap as tidmap
from hymet_tpu_torch.taxonomy import lineage as tlineage

torch.set_num_threads(1)

SPECIES = [r[0] for r in ZYMO_TAXONOMY_RECORDS if r[2] == "species"]
GENERA = [r[0] for r in ZYMO_TAXONOMY_RECORDS if r[2] == "genus"]


def _write_taxdump(d):
    """names.dmp, nodes.dmp and merged.dmp of the Zymo records, plus a
    synonym, a strain-flagged "no rank" node, a merged taxid and a node
    that is its own parent."""
    records = list(ZYMO_TAXONOMY_RECORDS) + [("9999001", "B. subtilis str. 168", "no rank", "1423"),
                                             ("9999002", "Loop", "genus", "9999002")]
    with open(d / "names.dmp", "w") as f:
        f.write("1\t|\troot\t|\t\t|\tscientific name\t|\n")
        for tid, name, _rank, _parent in records:
            f.write(f"{tid}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
        f.write("1423\t|\tVibrio subtilis\t|\t\t|\tsynonym\t|\n")
        f.write("562\t|\tE. coli\t|\t\t|\tgenbank common name\t|\n")
    with open(d / "nodes.dmp", "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\t\t|\n")
        for tid, _name, rank, parent in records:
            flag = "strain" if tid == "9999001" else ""
            f.write(f"{tid}\t|\t{parent}\t|\t{rank}\t|\t\t|\t{flag}\t|\n")
    (d / "merged.dmp").write_text("777\t|\t562\t|\n")
    return records


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A taxdump, its hierarchy TSV, a detailed_taxonomy.tsv and a PAF of
    80 queries with 1-100 hits (buckets 8, 32, 128) over 30 reference
    sequences: species and genus taxids, one taxid missing from the
    hierarchy, one target no taxid resolves, versioned and versionless
    names, zero and equal coverages (ties)."""
    d = tmp_path_factory.mktemp("classify")
    _write_taxdump(d)
    hier = d / "taxonomy_hierarchy.tsv"
    jdb.TaxonomyDB.from_taxdump(str(d)).write_hierarchy_tsv(str(hier))
    rng = np.random.default_rng(11)
    refs = [f"NZ_CP{100000 + i}.1" for i in range(30)]
    taxids = [str(rng.choice(SPECIES + GENERA)) for _ in range(14)] + ["424242"]  # not in the hierarchy
    tax = d / "detailed_taxonomy.tsv"
    with open(tax, "w", newline="") as f:
        f.write("GCF\tTaxID\tIdentifiers\r\n")
        for g, tid in enumerate(taxids):
            ids = ";".join(refs[i] for i in range(30) if i % len(taxids) == g)
            f.write(f"GCF_{g:09d}.1\t{tid}\t{ids}\r\n")
    paf = d / "resultados.paf"
    with open(paf, "w") as f:
        for q in range(80):
            qlen = int(rng.integers(500, 20000))
            for _ in range(int(rng.choice([1, 2, 5, 9, 30, 51, 100]))):
                t = refs[int(rng.integers(0, 30))] if rng.random() > 0.03 else "unmapped_ctg"
                if rng.random() < 0.2:
                    t = t.split(".")[0]
                block = int(rng.choice([0, qlen // 4, qlen // 2, int(rng.integers(1, qlen))]))
                f.write(f"q{q}\t{qlen}\t0\t{block}\t+\t{t}\t100000\t0\t{block}\t{block // 2}\t{block}\t60\n")
    return {"dir": d, "hier": str(hier), "tax": str(tax), "paf": str(paf)}


@pytest.mark.parametrize("backend", ["host", "device", "jax"])
def test_classify_paf_matches_jax_bytes(world, tmp_path, backend):
    jbackend = "host" if backend == "host" else "jax"
    want, got = tmp_path / "jax.tsv", tmp_path / "torch.tsv"
    jres = jwlca.classify_paf(world["paf"], world["tax"], world["hier"], str(want), backend=jbackend)
    tres = twlca.classify_paf(world["paf"], world["tax"], world["hier"], str(got), backend=backend,
                              device="cpu")
    assert tres == jres and 0 < jres[0] < jres[1] == 80
    assert filecmp.cmp(got, want, shallow=False)
    text = got.read_bytes()
    assert text.count(b"\r\n") == 81 and b"\tUnknown\troot\t0.0000" in text
    confs = {line.split(b"\t")[-1] for line in text.split(b"\r\n")[1:-1]}
    assert len(confs) > 5  # many distinct confidences, not only 1.0000


def test_device_backend_confidences_bit_for_bit(world):
    """The float64 confidences themselves, not only their 4 decimals."""
    idmap = tidmap.IdentifierMap.from_detailed_taxonomy(world["tax"])
    hier = twlca.load_hierarchy_vectors(world["hier"])
    qmap, counts = tpaf.parse_paf_for_classification(world["paf"])
    got = twlca.classify_query_map(qmap, counts, idmap, hier, backend="device", device="cpu")
    want = jwlca.classify_query_map(qmap, counts, jidmap.IdentifierMap.from_detailed_taxonomy(world["tax"]),
                                    jwlca.load_hierarchy_vectors(world["hier"]), backend="jax")
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert np.array_equal(np.array([g[3] for g in got]).view(np.int64),
                          np.array([w[3] for w in want], dtype=np.float64).view(np.int64))


def test_unknown_backend_is_refused(world, tmp_path):
    with pytest.raises(ValueError, match="backend"):
        twlca.classify_paf(world["paf"], world["tax"], world["hier"], str(tmp_path / "o.tsv"),
                           backend="legacy", device="cpu")


LINEAGES = [
    "", "  ", "superkingdom:Bacteria; phylum:Bacillota; species:Bacillus subtilis",
    "domain:Bacteria;p:Firmicutes|c:Bacilli; subspecies:str 1; foo:bar; g:",
    "k__Bacteria; p__Firmicutes; s__Bacillus subtilis; x__y; g__",
    "Bacteria; Firmicutes; NA; Bacillales", "Bacteria|Firmicutes|Bacilli|a|b|c|d|e|f|g",
    "cellular organisms;superkingdom:Bacteria;strain:B. subtilis 168",
]


@pytest.mark.parametrize("lineage", LINEAGES)
def test_lineage_codec_matches_jax(lineage):
    names = tlineage.lineage_to_rank_names(lineage)
    assert names == jlineage.lineage_to_rank_names(lineage)
    assert tlineage.rank_names_to_lineage(names) == jlineage.rank_names_to_lineage(names)


TNAMES = ["NZ_CP100003.1", "NZ_CP100003", "NZ_CP100003.2", "GCF_000000002.1_ASM1v1",
          "contig|NC_000913.3|x", "ref GCA_000005845.2 chr", "CP012345.1 desc", "zz", "",
          "AB_123456.7|x y", "NZ_ABCDE01000001.1"]


def test_identifier_map_matches_jax(world, tmp_path):
    t = tidmap.IdentifierMap.from_detailed_taxonomy(world["tax"])
    j = jidmap.IdentifierMap.from_detailed_taxonomy(world["tax"])
    assert t.flatten() == j.flatten() and len(t) == len(j) > 30
    s2t = tmp_path / "seqid2taxid.tsv"
    s2t.write_text("NC_000913.3\t562\nGCA_000005845.2\t562\n\tx\nCP012345.1\t1423\nbad\n")
    ts, js = tidmap.IdentifierMap.from_seqid2taxid(str(s2t)), jidmap.IdentifierMap.from_seqid2taxid(str(s2t))
    assert ts.flatten() == js.flatten()
    for name in TNAMES:
        assert tidmap.generate_lookup_candidates(name) == jidmap.generate_lookup_candidates(name)
        assert t.lookup(name) == j.lookup(name) and ts.lookup(name) == js.lookup(name)
        assert tidmap.split_identifiers(name) == jidmap.split_identifiers(name)
    assert ("NZ_CP100003" in t) and t.get("NZ_CP100003") == j.get("NZ_CP100003")


def test_first_hit_matches_jax(world, tmp_path):
    id2tax = tfirst.build_id_map(world["tax"])
    assert id2tax == jfirst.build_id_map(world["tax"])
    rows = tfirst.classify_first_hit(world["paf"], id2tax)
    assert rows == jfirst.classify_first_hit(world["paf"], id2tax) and len(rows[0]) > 50
    tfirst.write_fallback_classified(str(tmp_path / "t.tsv"), rows[0])
    jfirst.write_fallback_classified(str(tmp_path / "j.tsv"), rows[0])
    assert filecmp.cmp(tmp_path / "t.tsv", tmp_path / "j.tsv", shallow=False)
    bare = tmp_path / "bare.tsv"  # no header names: columns 0, 1, 2
    bare.write_text("x\ty\tz\nGCF_1.1\t562\tA.1;B\n\n")
    assert tfirst.build_id_map(str(bare)) == jfirst.build_id_map(str(bare))
    (tmp_path / "empty.tsv").write_text("")
    with pytest.raises(RuntimeError, match="empty"):
        tfirst.build_id_map(str(tmp_path / "empty.tsv"))


QUERY_TAXIDS = ["562", "1423", "9999001", "9999002", "777", "1", "2", "424242", "131567"]


def _same_db(t, j):
    assert (t.name, t.rank, t.parent, t.merged) == (j.name, j.rank, j.parent, j.merged)
    for tid in QUERY_TAXIDS:
        assert t.resolve(tid) == j.resolve(tid)
        assert t.lineage_pairs(tid) == j.lineage_pairs(tid)
        assert t.lineage_string(tid) == j.lineage_string(tid)
        assert t.taxpath(tid) == j.taxpath(tid)
        assert t.rank_names_vector(tid) == j.rank_names_vector(tid)
        for rank in ("superkingdom", "genus", "species", "strain"):
            assert t.ancestor_at_rank(tid, rank) == j.ancestor_at_rank(tid, rank)
    names = ["Escherichia coli", "escherichia COLI", "Vibrio subtilis", "E. coli", "nope", "", "Loop"]
    assert t.batch_name2taxid(names) == j.batch_name2taxid(names)
    assert [t.name2taxid(n) for n in names] == [j.name2taxid(n) for n in names]
    table, index, interned = t.build_rank_table(QUERY_TAXIDS)
    jt, ji, jn = j.build_rank_table(QUERY_TAXIDS)
    assert np.array_equal(table, jt) and table.dtype == jt.dtype and index == ji and interned == jn


def test_taxonomy_db_from_taxdump_matches_jax(tmp_path):
    _write_taxdump(tmp_path)
    t, j = tdb.TaxonomyDB.from_taxdump(str(tmp_path)), jdb.TaxonomyDB.from_taxdump(str(tmp_path))
    _same_db(t, j)
    assert t.rank["9999001"] == "strain" and t.resolve("777") == "562"
    t.write_hierarchy_tsv(str(tmp_path / "t.tsv"))
    j.write_hierarchy_tsv(str(tmp_path / "j.tsv"))
    assert filecmp.cmp(tmp_path / "t.tsv", tmp_path / "j.tsv", shallow=False)


def test_taxonomy_db_from_hierarchy_and_records_matches_jax(world, tmp_path):
    t = tdb.TaxonomyDB.from_hierarchy_tsv(world["hier"])
    j = jdb.TaxonomyDB.from_hierarchy_tsv(world["hier"])
    _same_db(t, j)
    t.write_hierarchy_tsv(str(tmp_path / "t.tsv"))
    j.write_hierarchy_tsv(str(tmp_path / "j.tsv"))
    assert filecmp.cmp(tmp_path / "t.tsv", tmp_path / "j.tsv", shallow=False)
    assert filecmp.cmp(tmp_path / "t.tsv", world["hier"], shallow=False)
    _same_db(tdb.TaxonomyDB.from_records(ZYMO_TAXONOMY_RECORDS),
             jdb.TaxonomyDB.from_records(ZYMO_TAXONOMY_RECORDS))


def test_hierarchy_vectors_match_jax(world, tmp_path):
    assert twlca.load_hierarchy_vectors(world["hier"]) == jwlca.load_hierarchy_vectors(world["hier"])
    bad = tmp_path / "bad.tsv"
    bad.write_text("TaxID\tName\n1\troot\n")
    with pytest.raises(RuntimeError, match="Lineage"):
        twlca.load_hierarchy_vectors(str(bad))


def test_read_paf_matches_jax(world, tmp_path):
    from hymet_tpu.io import paf as jpaf

    paf = tmp_path / "tags.paf"
    paf.write_text(open(world["paf"]).read() + "# comment\nshort\tline\n"
                   "q\t10\t0\t5\t-\tt\t20\t1\t6\t4\t5\t60\ttp:A:P\tcm:i:7\tbad\n"
                   "q\tx\t0\t5\t-\tt\t20\t1\t6\t4\t5\t60\n")
    assert tpaf.read_paf(str(paf)) == [tpaf.PafRecord(**r.__dict__) for r in jpaf.read_paf(str(paf))]
    assert len(tpaf.read_paf(str(paf))) == sum(1 for _ in open(world["paf"])) + 1
