"""hymet_tpu_torch's evaluator against hymet_tpu's on the CPU: the three
profile dialects and the truth-table dialects, ``profile_distance`` and
``presence_prf``, the prediction-taxid cascade, ``rebuild_profile``,
``score_contigs`` paired by name, by MD5 and by remap (the remap through
the port's aligner with ``device="cpu"``), and ``evaluate`` on the
committed gut truth files with a prediction perturbed from a seed, every
output file byte for byte.

Both packages run in this one process, so under one ``PYTHONHASHSEED``:
where an output's order follows set iteration (``profile_diffs_*``' ties),
both iterate the same sets built the same way."""

import filecmp
import os
import random

import numpy as np
import pytest
import torch

import chip_smoke
from hymet_tpu.evalx import eval_cami as J
from hymet_tpu.io.fasta import read_fasta
from hymet_tpu.taxonomy.db import TaxonomyDB as JDB
from hymet_tpu.taxonomy.idmap import IdentifierMap as JMap
from hymet_tpu_torch.evalx import eval_cami as T
from hymet_tpu_torch.taxonomy.db import TaxonomyDB as TDB
from hymet_tpu_torch.taxonomy.idmap import IdentifierMap as TMap

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "validation", "work_cami_suite")
GUT = os.path.join(WORLD, "data", "camisyn_gut")
HIER = os.path.join(WORLD, "taxonomy", "taxonomy_hierarchy.tsv")
OUTPUTS = ["profile_summary.tsv", "summary.txt", "_debug_info.txt", "contigs_exact.tsv",
           "contigs_per_rank.tsv", *(f"profile_diffs_{r}.tsv" for r in T.RANKS)]


@pytest.fixture(scope="module")
def dbs():
    return JDB.from_hierarchy_tsv(HIER), TDB.from_hierarchy_tsv(HIER)


@pytest.fixture(scope="module")
def truth():
    """The gut sample's truth table and contigs."""
    with open(os.path.join(GUT, "truth_contigs.tsv")) as f:
        rows = [ln.rstrip("\n").split("\t") for ln in f][1:]
    names, seqs = read_fasta(os.path.join(GUT, "contigs.fna"))
    return dict(rows), names, seqs


def _same_profile(a, b):
    assert list(a) == list(b)
    for rank in a:
        assert list(a[rank].items()) == list(b[rank].items()), rank


def _write(path, text):
    path.write_text(text)
    return str(path)


def _profile_files(tmp_path, db, seed):
    """One profile in each dialect, with values from the seed: bare CAMI
    rows, taxid+rank+value headers (a percentage and a 0..1 abundance
    column), rank+taxpath chains, rank+taxpathsn name chains."""
    rng = random.Random(seed)
    taxids = sorted(t for t in db.rank if db.rank[t] in T.RANKS)
    rows = []
    for tid in rng.sample(taxids, 40):
        ids, names = db.taxpath(tid)
        rows.append((tid, db.rank[tid], ids, names, rng.random() * 30))
    rows.append(("bad", "species", "x", "y", 1.0))  # a non-numeric taxid mid-table
    bare = "".join(f"{t}\t{r}\t{i}\t{n}\t{v:.6f}\n" for t, r, i, n, v in rows[:20])
    bare = "#CAMI\n@Version:0.9.1\n\n" + bare + "1\tno rank\t1\troot\t5\n2\tgenus\tx\ty\tnan?\n"
    out = {"bare": _write(tmp_path / "bare.tsv", bare)}
    head = "".join(f"taxid:{t}\t{r.upper()}\t{v}\n" for t, r, _i, _n, v in rows)
    out["taxid_pct"] = _write(tmp_path / "pct.tsv", "@@x\nTAXID\tRANK\tPERCENTAGE\n" + head)
    head = "".join(f"{r}\t{v / 100}\t{t}\n" for t, r, _i, _n, v in rows)
    out["taxid_abundance"] = _write(tmp_path / "abund.tsv", "Rank\tAbundance\tNCBI_TaxID\n" + head)
    head = "".join(f"{r}\t{i.replace('||', '|NA|')}\t{v}\n" for _t, r, i, _n, v in rows)
    out["taxpath"] = _write(tmp_path / "path.tsv", "rank\ttaxpath\tpercentage\n" + head)
    head = "".join(f"{r}\t{n}\t{v}\n" for _t, r, _i, n, v in rows)
    out["taxpathsn"] = _write(tmp_path / "names.tsv", "rank\ttaxpathsn\trel_abundance\n" + head)
    out["header_only"] = _write(tmp_path / "empty.tsv", "rank\tpercentage\n")
    out["missing"] = str(tmp_path / "absent.tsv")
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_profile_dialects_read_like_jax(tmp_path, dbs, seed):
    jdb, tdb = dbs
    files = _profile_files(tmp_path, jdb, seed)
    for kind, path in files.items():
        got, want = T.read_profile(path, tdb), J.read_profile(path, jdb)
        _same_profile(got, want)
        if kind not in ("header_only", "missing"):
            assert any(got[r] for r in T.RANKS), kind
    _same_profile(T.read_profile(files["taxpathsn"], None), J.read_profile(files["taxpathsn"], None))


TRUTH_TABLES = {
    "tsv": "contig_id\ttaxid\nc1\t562\nc2\ttaxid:1280\nc3\t\nc4\n",
    "csv": "#Sequence,NCBI_TaxID,other\nc1,562,x\nc2,1423.5,y\n",
    "whitespace": "scaffold  species_taxid\nc1   562\nc2 abc\n",
    "taxpath": "contig\ttaxpath\nc1\t2|1224|NA|562\nc2\tNA|NA\n",
    "no_column": "name\tnote\tvalue\nc1\tx\t562\nc2\t7.5\t9\nc3\ty\tz\n",
    "empty": "",
}


@pytest.mark.parametrize("kind", sorted(TRUTH_TABLES))
def test_truth_tables_read_like_jax(tmp_path, kind):
    path = _write(tmp_path / "t.tsv", TRUTH_TABLES[kind])
    got = T.read_truth_assignments(path)
    assert got == J.read_truth_assignments(path)
    assert list(got) == list(J.read_truth_assignments(path))
    assert T.read_truth_assignments(str(tmp_path / "none")) == {}


def test_truth_table_of_the_gut_sample(truth):
    table = T.read_truth_assignments(os.path.join(GUT, "truth_contigs.tsv"))
    assert table == J.read_truth_assignments(os.path.join(GUT, "truth_contigs.tsv")) == truth[0]


@pytest.mark.parametrize("seed", range(4))
def test_profile_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    keys = [str(k) for k in rng.integers(1, 40, 30)]
    pred = {k: float(v) for k, v in zip(keys[:20], rng.random(20) * 10)}
    truth = {k: float(v) for k, v in zip(keys[10:], rng.random(20) * rng.choice([0.05, 10], 20))}
    for a, b in ((pred, truth), ({}, {}), (pred, {}), ({}, truth)):
        assert T.profile_distance(a, b) == J.profile_distance(a, b)
        for thr in (0.1, 1.0, 5.0):
            assert T.presence_prf(a, b, thr) == J.presence_prf(a, b, thr)


def _idmap_file(tmp_path):
    """detailed_taxonomy.tsv of the in-repo genomes (GCF / TaxID /
    Identifiers, the classify stage's layout)."""
    lines = ["GCF\tTaxID\tIdentifiers"]
    with open(os.path.join(WORLD, "acc2taxid.tsv")) as f:
        for ln in f:
            acc, tid = ln.split()
            lines.append(f"GCF_{acc[4:]}\t{tid}\t{acc}_chr1;{acc}_plas1")
    return _write(tmp_path / "detailed_taxonomy.tsv", "\r\n".join(lines) + "\r\n")


def _classified(tmp_path, db, truth_map, names, seed, extra_cols=True):
    """A prediction perturbed from the truth: most contigs their own
    lineage, some cut at genus (the rank-truncated rows), some another
    taxon's, some a lineage of unknown names that the TaxID or Target
    column or the PAF's first hit must resolve, some left out."""
    rng = random.Random(seed)
    taxa = sorted(set(truth_map.values()))
    rows, paf = [], []
    accs = [ln.split()[0] for ln in open(os.path.join(WORLD, "acc2taxid.tsv"))]
    for name in names:
        tid = truth_map[name]
        roll = rng.random()
        taxid_col, target = "", ""
        if roll < 0.55:
            lineage = db.lineage_string(tid)
        elif roll < 0.7:
            lineage = ";".join(p for p in db.lineage_string(tid).split(";")
                               if p.split(":")[0] not in ("species", "strain"))
        elif roll < 0.8:
            lineage = db.lineage_string(rng.choice(taxa))
        elif roll < 0.85:
            lineage, taxid_col = "species:nothing known", f"taxid:{tid}"
        elif roll < 0.9:
            lineage, target = "Unknown", f"{rng.choice(accs)}_chr1"
        elif roll < 0.95:
            lineage = ""
            paf.append(f"{name}\t100\t0\t90\t+\t{rng.choice(accs)}_plas1\t500\t0\t90\t80\t90\t60\n")
        else:
            continue
        conf = f"{rng.random():.4f}"
        rows.append([name, lineage, "species", conf, taxid_col, target] if extra_cols
                    else [name, lineage, "species", conf])
    head = ["Query", "Lineage", "Taxonomic Level", "Confidence"]
    if extra_cols:
        head += ["TaxID", "Target"]
        rows.append([names[0], "", "species", "0.1", "", ""])  # a duplicate row
    path = tmp_path / f"classified_{seed}.tsv"
    path.write_text("".join("\t".join(r) + "\r\n" for r in [head, *rows]))
    paf_path = tmp_path / f"run_{seed}.paf"
    paf_path.write_text("#\n" + "".join(paf))
    return str(path), str(paf_path)


@pytest.mark.parametrize("seed", [3, 4])
def test_taxid_cascade_and_rebuild_equal_jax(tmp_path, dbs, truth, seed):
    jdb, tdb = dbs
    truth_map, names, seqs = truth
    tsv, paf = _classified(tmp_path, jdb, truth_map, names[:300], seed)
    taxmap = _idmap_file(tmp_path)
    got = T.resolve_contig_taxids(tsv, tdb, TMap.from_detailed_taxonomy(taxmap), paf)
    want = J.resolve_contig_taxids(tsv, jdb, JMap.from_detailed_taxonomy(taxmap), paf)
    assert got == want and list(got) == list(want) and len(got) > 200
    assert T.first_target_by_query(paf) == J.first_target_by_query(paf)
    lens = {n: len(s) for n, s in zip(names, seqs)}
    assert T.sequence_lengths([os.path.join(GUT, "contigs.fna"), None]) == lens
    _same_profile(T.rebuild_profile(got, lens, tdb), J.rebuild_profile(want, lens, jdb))
    _same_profile(T.rebuild_profile(truth_map, {}, tdb), J.rebuild_profile(truth_map, {}, jdb))
    # rank-truncated labels put mass under the "" taxon at species rank
    assert "" in T.rebuild_profile(got, lens, tdb)["species"]


def _score_both(tmp_path, dbs, pred, truth_tables, **kw):
    jdb, tdb = dbs
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = J.score_contigs(pred, truth_tables, jdb, str(tmp_path / "j"), **kw)
    got = T.score_contigs(pred, truth_tables, tdb, str(tmp_path / "t"), device="cpu", **kw)
    assert got == want
    for name in ("contigs_exact.tsv", "contigs_per_rank.tsv"):
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name, shallow=False)
    return got


def _fasta(path, names, seqs):
    path.write_text("".join(f">{n} x\n{s.decode()}\n" for n, s in zip(names, seqs)))
    return str(path)


def test_score_contigs_by_name(tmp_path, dbs, truth):
    truth_map, names, _ = truth
    tsv, paf = _classified(tmp_path, dbs[0], truth_map, names[:200], 5)
    got = _score_both(tmp_path, dbs, tsv, [os.path.join(GUT, "truth_contigs.tsv")],
                      taxmap_path=_idmap_file(tmp_path), paf_path=paf)
    assert got["usable_pairs"] > 150 and 0 < got["exact"] < got["usable_pairs"]


def test_score_contigs_by_md5(tmp_path, dbs, truth):
    """Predicted contigs renamed: names pair nothing, the sequences' MD5s
    pair every one."""
    truth_map, names, seqs = truth
    renamed = [f"p_{i}" for i in range(60)]
    tsv, _ = _classified(tmp_path, dbs[0], {p: truth_map[n] for p, n in zip(renamed, names)},
                         renamed, 6, extra_cols=False)
    pred_fasta = _fasta(tmp_path / "pred.fna", renamed, seqs[:60])
    got = _score_both(tmp_path, dbs, tsv, [os.path.join(GUT, "truth_contigs.tsv")],
                      pred_fasta=pred_fasta, gt_fasta=os.path.join(GUT, "contigs.fna"))
    assert got["usable_pairs"] > 40


def test_score_contigs_by_remap(tmp_path, dbs, truth):
    """30 gut contigs (about 330 kbp) against their second assembly
    (chip_smoke.second_assembly, as phase 11 makes it): names and MD5s
    pair nothing, so the remap maps them through the port's aligner on the
    CPU and the JAX package's; the same pairs, each a contig's own
    counterpart, and the same files."""
    truth_map, names, seqs = truth
    n = 30
    pred_fasta = _fasta(tmp_path / "pred.fna", names[:n], seqs[:n])
    gt_fasta, table = str(tmp_path / "asm2.fna"), str(tmp_path / "asm2_truth.tsv")
    new = chip_smoke.second_assembly(names[:n], seqs[:n], truth_map, gt_fasta, table)
    got = T._contig_remap(pred_fasta, gt_fasta, device="cpu")
    want = J._contig_remap(pred_fasta, gt_fasta)
    assert got == want and len(got) >= n // 2
    assert all(got[q] == new[names.index(q)] for q in got)
    tsv, _ = _classified(tmp_path, dbs[0], truth_map, names[:n], 7, extra_cols=False)
    score = _score_both(tmp_path, dbs, tsv, [table], pred_fasta=pred_fasta, gt_fasta=gt_fasta)
    assert 0 < score["usable_pairs"] <= len(got)


def test_remap_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    fasta = _write(tmp_path / "a.fna", ">a\n" + "ACGT" * 100 + "\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        T._contig_remap(fasta, fasta)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.score_contigs(None, [], TDB(), str(tmp_path))


def _perturbed_profile(tmp_path, seed):
    """The gut truth profile with each row's percentage scaled by a factor
    from the seed, a tenth of rows dropped and a spurious row added."""
    rng = random.Random(seed)
    out = []
    with open(os.path.join(GUT, "truth_profile.tsv")) as f:
        for ln in f:
            if ln.startswith(("#", "@")):
                out.append(ln)
                continue
            cols = ln.rstrip("\n").split("\t")
            if rng.random() < 0.1:
                continue
            cols[4] = f"{float(cols[4]) * rng.uniform(0.5, 1.5):.6f}"
            out.append("\t".join(cols) + "\n")
    out.append("9999999\tspecies\t2|1|1|1|1|1|9999999\tx|x|x|x|x|x|x\t0.300000\n")
    return _write(tmp_path / f"pred_profile_{seed}.tsv", "".join(out))


@pytest.mark.parametrize("mode", ["profiles", "rebuild_pred", "rebuild_both", "no_contigs"])
def test_evaluate_writes_the_jax_files(tmp_path, truth, mode):
    """evaluate on the committed gut truth files and a perturbed
    prediction (seed 11): every output file byte for byte, the same paths
    given to both packages. rebuild_pred scores an empty predicted
    profile rebuilt from the contig labels; rebuild_both rebuilds the
    truth's too."""
    truth_map, names, _ = truth
    tsv, paf = _classified(tmp_path, JDB.from_hierarchy_tsv(HIER), truth_map, names, 11)
    kw = dict(pred_profile=_perturbed_profile(tmp_path, 11),
              truth_profile=os.path.join(GUT, "truth_profile.tsv"), pred_contigs=tsv,
              truth_contigs=os.path.join(GUT, "truth_contigs.tsv"),
              pred_fasta=os.path.join(GUT, "contigs.fna"), truth_fasta=None,
              taxonomy_dir=os.path.join(WORLD, "taxonomy"), taxmap=_idmap_file(tmp_path), paf=paf)
    if mode != "profiles":
        kw["pred_profile"] = _write(tmp_path / "empty.tsv", "")
    if mode == "rebuild_both":
        kw["truth_profile"] = None
    if mode == "no_contigs":
        kw.update(pred_contigs=None, truth_contigs=None, taxonomy_dir=HIER)
    assert J.evaluate(outdir=str(tmp_path / "j"), **kw) == 0
    assert T.evaluate(outdir=str(tmp_path / "t"), device="cpu", **kw) == 0
    written = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == written
    assert set(written) <= set(OUTPUTS) and "profile_summary.tsv" in written
    assert ("contigs_exact.tsv" in written) == (mode != "no_contigs")
    for name in written:
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name, shallow=False), name


def test_evaluate_resolves_the_device_first(tmp_path):
    """Without a card evaluate raises before it writes anything, even with
    nothing to remap; device="cpu" scores."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    prof = os.path.join(GUT, "truth_profile.tsv")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.evaluate(prof, prof, str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
    assert T.evaluate(prof, prof, str(tmp_path / "out"), device="cpu") == 0


def test_load_taxdb_equals_jax(tmp_path):
    for where in (os.path.join(WORLD, "taxonomy"), HIER, None, str(tmp_path)):
        got, want = T._load_taxdb(where), J._load_taxdb(where)
        assert (got.name, got.rank, got.parent) == (want.name, want.rank, want.parent)
