"""hymet_tpu_torch's evaluation tools against hymet_tpu's on the CPU:
``fix_superkingdom`` rewriting profiles in place, the MetaPhlAn,
sourmash-gather and kreport converters with the CAMI writer, and
``diag_overlap``; every file byte for byte, every return value equal."""

import gzip
import os
import random

import pytest

from hymet_tpu.data.zymo_taxonomy import zymo_taxdb as j_zymo
from hymet_tpu.evalx import converters as JC
from hymet_tpu.evalx.diagnostics import diag_overlap as j_diag
from hymet_tpu.evalx.superkingdom_fix import fix_superkingdom as j_fix
from hymet_tpu.harness import baselines as JB
from hymet_tpu.models.first_hit import build_id_map as j_id_map
from hymet_tpu_torch.data.zymo_taxonomy import zymo_taxdb as t_zymo
from hymet_tpu_torch.evalx import converters as TC
from hymet_tpu_torch.evalx.diagnostics import diag_overlap as t_diag
from hymet_tpu_torch.evalx.superkingdom_fix import fix_superkingdom as t_fix
from hymet_tpu_torch.models.first_hit import build_id_map as t_id_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "validation", "work_cami_suite")
GUT = os.path.join(WORLD, "data", "camisyn_gut")
HIER = os.path.join(WORLD, "taxonomy", "taxonomy_hierarchy.tsv")
FIX = os.path.join(REPO, "tests", "fixtures")


def _gut_profile(seed, superkingdoms="gtdb", drop=()):
    """The gut truth profile perturbed from a seed: percentages scaled,
    ranks in ``drop`` left out, and its superkingdom rows replaced by a
    GTDB taxon (``gtdb``), kept (``ncbi``) or left out (``none``)."""
    rng = random.Random(seed)
    out = []
    with open(os.path.join(GUT, "truth_profile.tsv")) as f:
        for ln in f:
            if ln.startswith(("#", "@")):
                out.append(ln)
                continue
            cols = ln.rstrip("\n").split("\t")
            if cols[1] in drop:
                continue
            if cols[1] == "superkingdom":
                if superkingdoms == "none":
                    continue
                if superkingdoms == "gtdb":
                    cols[0], cols[3] = "3379134", "Pseudomonadati||||||"
            cols[4] = f"{float(cols[4]) * rng.uniform(0.5, 1.5):.6f}"
            out.append("\t".join(cols) + "\n")
    return "".join(out)


ZYMO_PROFILE = (
    "#CAMI Submission for Taxonomic Profiling\n"
    "@@TAXID RANK TAXPATH TAXPATHSN PERCENTAGE\n"
    "3379134\tsuperkingdom\t3379134||||||\tPseudomonadati||||||\t100.000000\n"
    "1239\tphylum\t2|1239|||||\tBacteria|Bacillota|||||\t60.000000\n"
    "1224\tphylum\t2|1224|||||\tBacteria|Pseudomonadota|||||\t40.000000\n"
    "4890\tphylum\t2759|4890|||||\tEukaryota|Ascomycota|||||\t5.000000\n"
    "562\tspecies\t2|1224|1236|91347|543|561|562\tx\t100.000000\n"
    "short\tspecies\n"
    "77\tgenus\tx\ty\tnot-a-number\n"
)

CASES = {
    "gut_gtdb": lambda: (_gut_profile(1), "gut", HIER),
    "gut_ncbi": lambda: (_gut_profile(2, "ncbi"), "gut", HIER),
    "gut_no_phylum": lambda: (_gut_profile(3, drop=("phylum", "class")), "gut", HIER),
    "gut_only_superkingdoms": lambda: (_gut_profile(4, drop=("phylum", "class", "order", "family",
                                                            "genus", "species")), "gut", HIER),
    "gut_truth_without_superkingdoms": lambda: (_gut_profile(5), "truth_no_sk", HIER),
    "zymo": lambda: (ZYMO_PROFILE, "zymo", "zymo"),
    "headers_only": lambda: ("#CAMI\n@@TAXID\n", "gut", HIER),
    "missing": lambda: (None, "gut", HIER),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fix_superkingdom_rewrites_like_jax(tmp_path, case):
    text, truth, hier = CASES[case]()
    if hier == "zymo":
        hier = str(tmp_path / "zymo_hierarchy.tsv")
        j_zymo().write_hierarchy_tsv(hier)
    truth_path = os.path.join(GUT, "truth_profile.tsv")
    if truth == "zymo":
        truth_path = str(tmp_path / "zymo_truth.tsv")
        open(truth_path, "w").write("@@TAXID\n2\tsuperkingdom\t2||||||\tBacteria||||||\t100.0\n")
    elif truth == "truth_no_sk":
        truth_path = str(tmp_path / "truth.tsv")
        open(truth_path, "w").write(_gut_profile(9, "none"))
    paths = {}
    for pkg in ("j", "t"):
        paths[pkg] = tmp_path / f"{pkg}_profile.tsv"
        if text is not None:
            paths[pkg].write_text(text)
    j_fix(str(paths["j"]), truth_path, hier)
    t_fix(str(paths["t"]), truth_path, hier)
    if text is None:
        assert not paths["t"].exists() and not paths["j"].exists()
        return
    assert paths["t"].read_bytes() == paths["j"].read_bytes()
    if case in ("gut_gtdb", "zymo"):
        assert paths["t"].read_text() != text and "\n2\tsuperkingdom" in paths["t"].read_text()


@pytest.fixture(scope="module")
def zymo():
    return j_zymo(), t_zymo()


def test_metaphlan_fixture_converts_like_jax(tmp_path, zymo):
    src = os.path.join(FIX, "metaphlan4_zymo.tsv")
    assert TC.read_metaphlan(src) == JC.read_metaphlan(src)
    n_t = TC.metaphlan_to_cami(src, str(tmp_path / "t.tsv"), "zymo", zymo[1])
    n_j = JC.metaphlan_to_cami(src, str(tmp_path / "j.tsv"), "zymo", zymo[0])
    assert n_t == n_j > 0
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()


@pytest.mark.parametrize("text", [
    "#mpa_v2\nk__Bacteria\t12\t0.5\nk__Bacteria|p__Bacillota\t88.5\t0.9\n",
    "#v4\nk__Bacteria\t2\t70.25\t\nk__Bacteria|p__Bacillota\t2|1239\t70.25\t\n"
    "k__Bacteria|p__Bacillota|c__Bacilli|o__Bacillales|f__Bacillaceae|g__Bacillus|s__Bacillus_subtilis"
    "\t2|1239|91061|1385|186817|1386|1423\t30.5\t\n",
    "k__Unheard_of\t50\nk__Bacteria|s__Nobody_knows\t50\nno_clade\t1\nk__Bacteria\tx\n",
])
def test_metaphlan_dialects_convert_like_jax(tmp_path, zymo, text):
    src = tmp_path / "mp.tsv"
    src.write_text(text)
    assert TC.read_metaphlan(str(src)) == JC.read_metaphlan(str(src))
    assert (TC.metaphlan_to_cami(str(src), str(tmp_path / "t.tsv"), "s", zymo[1])
            == JC.metaphlan_to_cami(str(src), str(tmp_path / "j.tsv"), "s", zymo[0]))
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    for lineage in text.split():
        assert TC.metaphlan_lineage_names(lineage) == JC.metaphlan_lineage_names(lineage)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sourmash_gather_converts_like_jax(tmp_path, zymo, seed):
    rng = random.Random(seed)
    seqmap = {"NC_1": "562", "NC_2.1": "1423", "NZ_3": "1280", "CP4": "4932", "X5": "99999999"}
    names = ["NC_1.1 Escherichia coli chromosome", "NC_2.1 Bacillus subtilis", "NZ_3.2|x",
             "CP4;plasmid", "X5", "unmappable", ""]
    keys = ["f_unique_to_query", "fraction_unique_to_query", "unique_fraction"]
    key = keys[seed]
    lines = [f"name,{key},match_name"]
    for _ in range(12):
        frac = rng.choice([f"{rng.random():.4f}", "0", "-0.1", "oops", ""])
        lines.append(f'"{rng.choice(names)}",{frac},m')
    src = tmp_path / "gather.csv"
    src.write_text("\n".join(lines) + "\n")
    for name in names:
        assert TC.sourmash_lookup_taxid(name, seqmap) == JC.sourmash_lookup_taxid(name, seqmap)
    n_t = TC.sourmash_gather_to_cami(str(src), seqmap, str(tmp_path / "t.tsv"), "s", zymo[1])
    n_j = JC.sourmash_gather_to_cami(str(src), seqmap, str(tmp_path / "j.tsv"), "s", zymo[0])
    assert n_t == n_j
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()


def test_kreport_and_cami_writer_equal_jax(tmp_path):
    """parse_kreport and write_cami_profile, the port's copies of the JAX
    harness's helpers, on the kraken2 fixture and a tree with zero-mass
    and unranked clades."""
    odd = tmp_path / "odd.kreport"
    odd.write_text(
        " 90.00\t900\t0\tD\t2\tBacteria\n"
        " 0.00\t0\t0\tP\t1239\t  Bacillota\n"
        " 50.00\t500\t10\tS1\t1423\t    Bacillus subtilis\n"
        " 30.00\t300\t0\t-\t7\t  no rank here\n"
        " x\t300\t0\tG\t561\t    Escherichia\n"
        "short\tline\n"
    )
    for src in (os.path.join(FIX, "kraken2_zymo.kreport"), str(odd)):
        rows = TC.parse_kreport(src)
        assert rows == JB.parse_kreport(src) and rows
        TC.write_cami_profile(str(tmp_path / "t.tsv"), rows, "s0")
        JB.write_cami_profile(str(tmp_path / "j.tsv"), rows, "s0")
        assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()


@pytest.mark.parametrize("gz", [False, True])
def test_diag_overlap_equals_jax(tmp_path, gz):
    rng = random.Random(int(gz))
    accs = [ln.split()[0] for ln in open(os.path.join(WORLD, "acc2taxid.tsv"))]
    taxonomy = tmp_path / "detailed_taxonomy.tsv"
    taxonomy.write_text("GCF\tTaxID\tIdentifiers\n" + "".join(
        f"GCF_{a[4:]}\t{i}\t{a};{a}_chr1\n" for i, a in enumerate(accs[:150])))
    lines = ["#comment\n", "\n", "short\tline\n"]
    for _ in range(400):
        acc = rng.choice(accs)
        target = rng.choice([acc, acc.split(".")[0] + ".9", f"{acc}_chr1", f"{acc}_plas1"])
        lines.append(f"q{rng.randrange(50)}\t100\t0\t90\t+\t{target}\t500\t0\t90\t80\t90\t60\n")
    paf = tmp_path / ("r.paf.gz" if gz else "r.paf")
    with (gzip.open(paf, "wt") if gz else open(paf, "w")) as f:
        f.writelines(lines)
    t_map, j_map = t_id_map(str(taxonomy)), j_id_map(str(taxonomy))
    assert t_map == j_map
    got = t_diag(str(paf), t_map)
    assert got == j_diag(str(paf), j_map) and got[2] > 0 and got[3] > 0


def test_converters_write_with_the_ports_cami_writer(tmp_path, zymo, monkeypatch):
    """metaphlan_to_cami and sourmash_gather_to_cami write through the
    port's write_cami_profile, not the JAX package's harness."""
    calls = []
    monkeypatch.setattr(TC, "write_cami_profile", lambda *a: calls.append(a))
    src = tmp_path / "mp.tsv"
    src.write_text("k__Bacteria\t60.0\n")
    TC.metaphlan_to_cami(str(src), str(tmp_path / "a.tsv"), "s", zymo[1])
    gather = tmp_path / "g.csv"
    gather.write_text("name,f_unique_to_query\nNC_1,0.5\n")
    TC.sourmash_gather_to_cami(str(gather), {"NC_1": "562"}, str(tmp_path / "b.tsv"), "s", zymo[1])
    assert [c[0] for c in calls] == [str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")]
