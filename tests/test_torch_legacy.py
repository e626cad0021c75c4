"""hymet_tpu_torch's legacy classifier (classification.py's exact-match +
consensus) against hymet_tpu's on the CPU: ``classify_paf_legacy`` writes
the same bytes and returns the same counts on seeded PAFs, taxonomies and
hierarchies (exact self-hits, references missing from the taxonomy,
taxids missing from the hierarchy, lineages with gaps and unknown ranks,
weight ties, zero-length queries, short lines)."""

import filecmp

import numpy as np
import pytest

from hymet_tpu.models import legacy_lca as jleg
from hymet_tpu_torch.models import legacy_lca as tleg

RANK_LABELS = ["superkingdom", "phylum", "class", "order", "family", "genus", "species",
               "strain", "domain", "no rank"]


def _world(tmp_path, seed: int):
    """A taxonomy of 12 taxids over 30 references (some with two
    identifiers, some in none), their hierarchy (two taxids missing, ranks
    skipped or repeated), and a PAF of 60 queries."""
    rng = np.random.default_rng(seed)
    refs = [f"NZ_CP{seed:02d}{i:04d}.1" for i in range(30)]
    tax_rows, by_tax = [], {}
    for i, ref in enumerate(refs[:26]):
        tid = str(100 + int(rng.integers(0, 12)))
        by_tax.setdefault(tid, []).append(ref)
    for tid, members in by_tax.items():
        ids = ";".join(members + ([f" GCF_{tid}.2 "] if int(tid) % 3 == 0 else []))
        tax_rows.append(f"{tid}\t{ids}\n")
    tax = tmp_path / "detailed_taxonomy.tsv"
    tax.write_text("TaxID\tIdentifiers\n" + "".join(tax_rows))
    hier_rows = []
    for t in range(100, 112):
        if t in (104, 109):
            continue  # a taxid the hierarchy lacks
        parts = []
        for r, label in enumerate(RANK_LABELS[:8]):
            if rng.random() < 0.15:
                continue  # a missing rank
            parts.append(f"{label}:N{r}_{int(rng.integers(0, 3))}")
        if rng.random() < 0.3:
            parts.insert(1, f"{RANK_LABELS[int(rng.integers(8, 10))]}:odd")
        hier_rows.append(f"{t}\t{';'.join(parts)}\n")
    hier = tmp_path / "taxonomy_hierarchy.tsv"
    hier.write_text("TaxID\tLineage\n" + "".join(hier_rows))
    lines = []
    for q in range(60):
        qid = refs[int(rng.integers(0, 30))] if q % 7 == 0 else f"contig_{q}"
        qlen = 0 if q == 11 else int(rng.integers(500, 5000))
        for _ in range(int(rng.integers(1, 6))):
            ref = qid if q % 7 == 0 and rng.random() < 0.7 else refs[int(rng.integers(0, 30))]
            alen = qlen if rng.random() < 0.2 else int(rng.integers(50, max(qlen, 51)))
            lines.append("\t".join(map(str, [qid, qlen, 0, alen, "+", ref, 9_000_000, 10, 10 + alen,
                                             alen, alen, 60])) + "\n")
        if q == 5:
            lines.append("contig_5\t100\t0\n")  # a short line: skipped
    paf = tmp_path / "resultados.paf"
    paf.write_text("".join(lines))
    return str(paf), str(tax), str(hier)


@pytest.mark.parametrize("seed", range(6))
def test_classify_paf_legacy_writes_the_jax_bytes(tmp_path, seed):
    paf, tax, hier = _world(tmp_path, seed)
    got = tleg.classify_paf_legacy(paf, tax, hier, str(tmp_path / "t.tsv"))
    want = jleg.classify_paf_legacy(paf, tax, hier, str(tmp_path / "j.tsv"))
    assert got == want and want[1] > 0
    assert filecmp.cmp(tmp_path / "t.tsv", tmp_path / "j.tsv", shallow=False)


def test_parsers_and_consensus_match(tmp_path):
    paf, tax, hier = _world(tmp_path, 42)
    assert tleg.load_taxonomy_exact(tax) == jleg.load_taxonomy_exact(tax)
    assert tleg.load_hierarchy_strings(hier) == jleg.load_hierarchy_strings(hier)
    assert tleg.parse_paf_legacy(paf) == jleg.parse_paf_legacy(paf)
    for lineage in ("", "genus:G;species:S", "phylum:P;no rank:x;class:C", "Strain:s ; order:o",
                    "species:S;superkingdom:B", "root"):
        assert tleg.deepest_rank(lineage) == jleg.deepest_rank(lineage)
    taxonomy, hierarchy = jleg.load_taxonomy_exact(tax), jleg.load_hierarchy_strings(hier)
    qmap, counts = jleg.parse_paf_legacy(paf)
    for refs in qmap.values():
        assert tleg.classify_query_legacy(refs, counts, taxonomy, hierarchy) == \
            jleg.classify_query_legacy(refs, counts, taxonomy, hierarchy)
