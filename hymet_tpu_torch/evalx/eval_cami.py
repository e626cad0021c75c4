"""CAMI evaluator: profile + per-contig metrics (the port of
hymet_tpu.evalx.eval_cami).

Behavioral counterpart of reference ``tools/eval_cami.py`` (same metrics
and output files: profile_summary.tsv, contigs_exact.tsv,
contigs_per_rank.tsv, _debug_info.txt):

- per-rank L1 total variation (0.5 * sum |a-b|), Bray-Curtis %, and
  presence/absence P/R/F1 at a 0.1% threshold (``eval_cami.py:369-385``),
- multi-format profile reader (bare CAMI data rows / taxid+rank+value
  headers / taxpath(sn) headers, ``:168-234``),
- tolerant truth-contig reader (tsv/csv/whitespace, header aliases,
  ``:243-303``),
- length-weighted profile rebuild from per-contig labels (``:306-329``),
- prediction-taxid resolution cascade: deepest lineage name -> TaxID
  column -> Target id-map -> PAF first hit (``:388-483``),
- contig pairing cascade: name match -> MD5-of-sequence -> best-hit remap
  with cov/id >= 0.95 (``:499-528``) — the last leg uses our minimizer
  aligner instead of a minimap2 subprocess: the truth FASTA's index is
  built and the predicted contigs mapped on ``device`` through the
  ``minimizers``, ``anchors`` and ``chains`` kernels.

The rest is host code. ``evaluate`` and ``score_contigs`` take a
keyword-only ``device`` (default the card) and resolve it at entry, as
``ClassificationRun`` does: without a card they raise unless the caller
passes ``device="cpu"``, which runs the remap's plain versions.

All taxonkit subprocess calls are TaxonomyDB lookups. Reference quirks
are preserved for byte parity: rank-truncated lineages accumulate an
empty-string taxon in rebuilt profiles (``eval_cami.py:322-324``) and
count as incorrect (not excluded) rows in per-rank contig accuracy
(``:544``) — arguably bugs, but the evaluator must report the same
numbers as the reference's own evaluator on the same inputs
(oracle: tests/test_eval_oracle.py::test_profile_rebuild_byte_parity).
"""

from __future__ import annotations

import collections
import csv
import hashlib
import os
import pathlib
import re
from typing import Dict, List, Optional, Sequence, Tuple

from hymet_tpu_torch.io.fasta import iter_fasta, read_fasta
from hymet_tpu_torch.io.minimizer_index import MinimizerIndex
from hymet_tpu_torch.models.aligner import MinimizerAligner
from hymet_tpu_torch.taxonomy.db import TaxonomyDB
from hymet_tpu_torch.taxonomy.idmap import IdentifierMap
from hymet_tpu_torch.utils.device import resolve_device

RANKS = ["superkingdom", "phylum", "class", "order", "family", "genus", "species"]

# Rank depth within a 7-slot taxpath chain.
_DEPTH = {rank: i for i, rank in enumerate(RANKS)}

# note: strain/subspecies collapse to species here (eval granularity),
# unlike the classifier's 8-rank table — mirrors eval_cami.py:19-40.
_EVAL_ALIAS = {
    "domain": "superkingdom",
    "kingdom": "superkingdom",
    "sk": "superkingdom",
    "k": "superkingdom",
    "superkingdom": "superkingdom",
    "phylum": "phylum",
    "p": "phylum",
    "class": "class",
    "c": "class",
    "order": "order",
    "o": "order",
    "family": "family",
    "f": "family",
    "genus": "genus",
    "g": "genus",
    "species": "species",
    "s": "species",
    "subspecies": "species",
    "ss": "species",
    "strain": "species",
}

_NUMERIC = re.compile(r"[0-9]+(?:\.[0-9]+)?")


def _numlike(tok: Optional[str]) -> bool:
    """True when the (stripped) token is a bare decimal number."""
    tok = (tok or "").strip()
    return bool(tok) and _NUMERIC.fullmatch(tok) is not None


def taxid_digits(tok: Optional[str]) -> str:
    """First digit run in a token ('taxid:562' -> '562'), else ''."""
    hit = re.search(r"[0-9]+", tok or "")
    return hit.group(0) if hit else ""


def _eval_lineage(text: str) -> Dict[str, str]:
    """'rank:name; ...' -> {canonical rank: name}, eval-alias collapsed."""
    lineage: Dict[str, str] = {}
    for piece in (text or "").split(";"):
        rank_name = piece.strip().split(":", 1)
        if len(rank_name) != 2:
            continue
        rank = _EVAL_ALIAS.get(rank_name[0].strip().lower())
        name = rank_name[1].strip()
        if rank and name:
            lineage[rank] = name
    return lineage


# ----------------------------------------------------------------------
# profiles: {rank: Counter(taxon -> percentage)}


def _blank_profile() -> Dict[str, collections.Counter]:
    return {rank: collections.Counter() for rank in RANKS}


def _percent_scale(value_header: str) -> float:
    """Columns named like a 0..1 fraction are rescaled to percent."""
    return 100.0 if ("abundance" in value_header or "fraction" in value_header) else 1.0


def _headerless_cami(lines: Sequence[str]) -> Optional[Dict[str, collections.Counter]]:
    """Bare CAMI data rows (taxid/rank/taxpath/taxpathsn/pct, no header
    beyond #/@ comments). None when the text is not in this shape."""
    prof = _blank_profile()
    found = False
    for raw in lines:
        if not raw.strip() or raw[0] in "#@":
            continue
        cols = raw.rstrip("\n").split("\t")
        if len(cols) < 5 or not _numlike(cols[0]):
            break  # a header row — this is a tabular profile instead
        rank = cols[1].strip().lower()
        if rank not in prof:
            continue
        try:
            prof[rank][cols[0]] += float(cols[4])
            found = True
        except ValueError:
            pass
    return prof if found else None


def _tabular_profile(
    lines: Sequence[str], taxdb: Optional[TaxonomyDB]
) -> Dict[str, collections.Counter]:
    """Header-driven profile tables: taxid+rank+value, or rank+taxpath(sn)
    +value with the rank's slot picked out of the path chain."""
    prof = _blank_profile()
    table = list(
        csv.reader((ln for ln in lines if ln.strip() and ln[0] not in "#@"), delimiter="\t")
    )
    if not table:
        return prof
    head = [c.strip().lower() for c in table[0]]
    rows = table[1:]

    def col(*aliases: str) -> int:
        for alias in aliases:
            if alias in head:
                return head.index(alias)
        return -1

    c_tax = col("taxid", "taxon_id", "ncbi_taxid", "ncbi_tax_id")
    c_rank = col("rank")
    c_val = col("percentage", "abundance", "rel_abundance", "fraction_total_reads")
    c_path = col("taxpath")
    c_names = col("taxpathsn", "taxpath_sn", "taxpath_names", "lineage")

    if c_tax >= 0 and c_rank >= 0 and c_val >= 0:
        scale = _percent_scale(head[c_val])
        for row in rows:
            try:
                rank = row[c_rank].strip().lower()
                tid = taxid_digits(row[c_tax])
                if rank in prof and tid:
                    prof[rank][tid] += float(row[c_val]) * scale
            except (ValueError, IndexError):
                pass
        return prof

    if c_rank < 0 or c_val < 0 or (c_path < 0 and c_names < 0):
        return prof
    scale = _percent_scale(head[c_val])

    if c_path >= 0:  # taxid chains: rank picks its depth slot
        for row in rows:
            try:
                rank = row[c_rank].strip().lower()
                chain = [t for t in row[c_path].strip().split("|") if t and t != "NA"]
                pos = _DEPTH.get(rank, -1)
                if 0 <= pos < len(chain):
                    prof[rank][chain[pos]] += float(row[c_val]) * scale
            except (ValueError, IndexError):
                pass
        return prof

    # name chains: two passes so name->taxid resolution is one batch call
    parsed: List[Tuple[str, int, List[str], List[str]]] = []
    wanted: set = set()
    for row in rows:
        try:
            rank = row[c_rank].strip().lower()
            chain = [p.strip() for p in row[c_names].split("|")]
        except (ValueError, IndexError):
            continue
        pos = _DEPTH.get(rank, -1)
        if 0 <= pos < len(chain) and chain[pos]:
            wanted.add(chain[pos])
        parsed.append((rank, pos, chain, row))
    resolved = taxdb.batch_name2taxid(wanted) if taxdb else {}
    for rank, pos, chain, row in parsed:
        if not (0 <= pos < len(chain)):
            continue
        tid = resolved.get(chain[pos])
        if tid:
            try:
                prof[rank][tid] += float(row[c_val]) * scale
            except (ValueError, IndexError):
                pass
    return prof


def read_profile(
    path: Optional[str], taxdb: Optional[TaxonomyDB]
) -> Dict[str, collections.Counter]:
    """Profile in any of the accepted dialects; blank when unreadable."""
    if not path or not os.path.isfile(path):
        return _blank_profile()
    with open(path, encoding="utf-8", errors="ignore") as fh:
        lines = fh.readlines()
    prof = _headerless_cami(lines)
    return prof if prof is not None else _tabular_profile(lines, taxdb)


# ----------------------------------------------------------------------
# truth contigs: contig name -> taxid


def read_truth_assignments(gt_file: Optional[str]) -> Dict[str, str]:
    """Truth contig table with sniffed delimiter and aliased columns."""
    if not gt_file or not os.path.isfile(gt_file):
        return {}
    with open(gt_file, encoding="utf-8", errors="ignore") as fh:
        lines = fh.read().splitlines()
    if not lines:
        return {}
    if "\t" in lines[0]:
        table = [r for r in csv.reader(lines, delimiter="\t") if r]
    elif "," in lines[0]:
        table = [r for r in csv.reader(lines, delimiter=",") if r]
    else:
        table = [ln.split() for ln in lines if ln.strip()]
    header, rows = table[0], table[1:]

    fields = [c.strip().lstrip("#").lower() for c in header]

    def pick(want) -> int:
        for i, name in enumerate(fields):
            if want(name):
                return i
        return -1

    qcol = pick(lambda k: "contig" in k or "sequence" in k or "scaffold" in k)
    if qcol < 0:
        qcol = 0
    tcol = pick(lambda k: "tax" in k and "path" not in k)
    if tcol < 0:
        tcol = pick(
            lambda k: k
            in ("ncbi_taxid", "ncbi_tax_id", "taxid", "tax_id", "species_taxid", "genome_taxid")
        )

    out: Dict[str, str] = {}
    if tcol >= 0:
        for row in rows:
            if len(row) <= max(qcol, tcol):
                continue
            raw = (row[tcol] or "").strip()
            if not raw:
                continue
            tid = raw if _numlike(raw) else taxid_digits(raw)
            if tid:
                out[row[qcol]] = taxid_digits(tid)
    elif "taxpath" in fields:
        pcol = fields.index("taxpath")
        for row in rows:
            chain = [t for t in row[pcol].split("|") if t and t != "NA"]
            tid = taxid_digits(chain[-1]) if chain else ""
            if tid:
                out[row[qcol]] = tid
    else:  # no recognizable taxid column: first numeric token per row
        for row in rows:
            for tok in row[1:]:
                if _numlike(tok):
                    out[row[0]] = taxid_digits(tok)
                    break
    return out


# ----------------------------------------------------------------------
# fasta helpers


def sequence_lengths(paths: Sequence[Optional[str]]) -> Dict[str, int]:
    lens: Dict[str, int] = {}
    for path in paths:
        if path and os.path.isfile(path):
            for name, seq in iter_fasta(path):
                lens.setdefault(name, len(seq))
    return lens


def sequence_md5s(path: Optional[str]) -> Dict[str, str]:
    if not path or not os.path.isfile(path):
        return {}
    return {name: hashlib.md5(seq).hexdigest() for name, seq in iter_fasta(path)}


# ----------------------------------------------------------------------
# metrics


def profile_distance(pred: dict, truth: dict) -> Tuple[float, float]:
    """(0.5*L1 total variation, Bray-Curtis dissimilarity %)."""
    taxa = set(pred) | set(truth)
    if not taxa:
        # an empty rank scores BC=100 in the reference's profile_summary
        # (eval_cami.py:611-620 computes inline without the early return
        # its own standalone helper at :369-377 has)
        return 0.0, 100.0
    l1 = 0.5 * sum(abs(pred.get(t, 0.0) - truth.get(t, 0.0)) for t in taxa)
    overlap = sum(min(pred.get(t, 0.0), truth.get(t, 0.0)) for t in taxa)
    mass = sum(pred.get(t, 0.0) for t in taxa) + sum(truth.get(t, 0.0) for t in taxa)
    bc = 1.0 - 2.0 * overlap / (mass if mass > 0 else 1.0)
    return l1, bc * 100.0


def presence_prf(pred: dict, truth: dict, thr: float = 0.1):
    """Presence/absence P/R/F1 (%) at an abundance threshold."""
    called = {t for t, v in pred.items() if v >= thr}
    present = {t for t, v in truth.items() if v >= thr}
    tp = len(called & present)
    fp = len(called) - tp
    fn = len(present) - tp
    prec = tp / len(called) if called else 0.0
    rec = tp / len(present) if present else 0.0
    f1 = 2 * prec * rec / (prec + rec) if (prec + rec) > 0 else 0.0
    return prec * 100.0, rec * 100.0, f1 * 100.0, tp, fp, fn


# ----------------------------------------------------------------------
# prediction taxids


def first_target_by_query(paf_path: Optional[str]) -> Dict[str, str]:
    """First PAF hit's target per query, file order."""
    hits: Dict[str, str] = {}
    if not paf_path or not os.path.isfile(paf_path):
        return hits
    with open(paf_path, encoding="utf-8", errors="ignore") as fh:
        for raw in fh:
            if not raw.strip() or raw[0] == "#":
                continue
            cols = raw.rstrip("\n").split("\t")
            if len(cols) >= 6 and cols[0] not in hits:
                hits[cols[0]] = cols[5]
    return hits


def _read_classified(path: Optional[str]) -> Dict[str, dict]:
    """classified_sequences.tsv -> per-query record {lineage, taxid, target}.

    Duplicate queries merge the way two keyed dicts would: the last row's
    taxid/target win, the last NON-EMPTY lineage wins.
    """
    merged: Dict[str, dict] = {}
    if not path or not os.path.isfile(path):
        return merged
    with open(path, encoding="utf-8", errors="ignore") as fh:
        reader = csv.DictReader(fh, delimiter="\t")
        byname: Dict[str, str] = {}
        for c in reader.fieldnames or []:
            byname.setdefault((c or "").strip().lower(), c)

        def named(*aliases: str) -> Optional[str]:
            for alias in aliases:
                if alias in byname:
                    return byname[alias]
            return None

        qcol = named("query", "qname", "q")
        tidcol = named("taxid")
        tgtcol = named("target", "tname")
        lincol = named("lineage")
        for row in reader:
            q = row.get(qcol) if qcol else None
            if not q:
                continue
            rec = merged.setdefault(q, {"lineage": {}, "taxid": None, "target": None})
            lineage = _eval_lineage(row.get(lincol, "") if lincol else "")
            if lineage:
                rec["lineage"] = lineage
            rec["taxid"] = row.get(tidcol) if tidcol else None
            rec["target"] = row.get(tgtcol) if tgtcol else None
    return merged


def _deepest_taxid(lineage: Dict[str, str], name2tid: Dict[str, str]) -> Optional[str]:
    """Taxid of the deepest resolvable rank name, species upward."""
    for rank in reversed(RANKS):
        tid = name2tid.get(lineage.get(rank) or "")
        if tid and taxid_digits(tid):
            return taxid_digits(tid)
    return None


def _idmap_taxid(idmap: Optional[IdentifierMap], target: str) -> Optional[str]:
    """Id-map lookup trying the full target, its pre-'|' stem, and the
    stem without the accession version suffix."""
    if not idmap:
        return None
    stem = target.split("|", 1)[0]
    trials = [target, stem]
    if "." in stem:
        trials.append(stem.split(".", 1)[0])
    for t in trials:
        tid = idmap.get(t)
        if tid and taxid_digits(tid):
            return taxid_digits(tid)
    return None


def resolve_contig_taxids(
    classified_tsv: Optional[str],
    taxdb: TaxonomyDB,
    idmap: Optional[IdentifierMap],
    paf_path: Optional[str],
) -> Dict[str, str]:
    """Resolution cascade of ``eval_cami.py:388-483``: deepest lineage
    name, then the TaxID column, then the Target column via the id-map,
    then the PAF first hit via the id-map."""
    records = _read_classified(classified_tsv)
    wanted = {n for rec in records.values() for n in rec["lineage"].values() if n}
    name2tid = taxdb.batch_name2taxid(wanted) if wanted else {}

    resolved: Dict[str, str] = {}
    for q, rec in records.items():
        if rec["lineage"]:
            tid = _deepest_taxid(rec["lineage"], name2tid)
            if tid:
                resolved[q] = tid
    for q, rec in records.items():
        if q not in resolved:
            tid = taxid_digits(rec["taxid"] or "")
            if tid:
                resolved[q] = tid
    for q, rec in records.items():
        target = (rec["target"] or "").strip()
        if q not in resolved and target:
            tid = _idmap_taxid(idmap, target)
            if tid:
                resolved[q] = tid
    for q, target in first_target_by_query(paf_path).items():
        if q not in resolved:
            tid = _idmap_taxid(idmap, target)
            if tid:
                resolved[q] = tid
    return resolved


# ----------------------------------------------------------------------
# length-weighted profile rebuild


def rebuild_profile(
    assignments: Dict[str, str], lengths: Dict[str, int], taxdb: TaxonomyDB
) -> Dict[str, collections.Counter]:
    """Per-rank percentage profile from contig->taxid labels, weighted by
    contig length (1 when unknown)."""
    prof = _blank_profile()
    labeled = {c: taxid_digits(t) for c, t in assignments.items() if taxid_digits(t)}
    if not labeled:
        return prof
    chains = {tid: taxdb.taxpath(tid)[0].split("|") for tid in set(labeled.values())}
    mass = {rank: 0 for rank in RANKS}
    for contig, tid in labeled.items():
        weight = lengths.get(contig, 1)
        chain = chains[tid]
        for pos, rank in enumerate(RANKS):
            # reference quirk preserved: empty (rank-truncated) slots
            # accumulate under the "" key (eval_cami.py:322-324), so a
            # genus-level call still contributes "unassigned" mass at
            # species rank and "" can match "" in presence P/R/F1
            if pos < len(chain) and chain[pos] != "NA":
                prof[rank][chain[pos]] += weight
                mass[rank] += weight
    for rank in RANKS:
        if mass[rank] > 0:
            prof[rank] = collections.Counter(
                {t: 100.0 * v / mass[rank] for t, v in prof[rank].items()}
            )
    return prof


# ----------------------------------------------------------------------
# contig pairing + per-rank accuracy


def _contig_remap(
    pred_fasta: str,
    gt_fasta: str,
    min_cov: float = 0.95,
    min_id: float = 0.95,
    *,
    device="cuda",
) -> Dict[str, str]:
    """Best-hit contig remap using the minimizer aligner (replaces the
    reference's minimap2 subprocess, ``eval_cami.py:333-353``): the truth
    index built and the contigs mapped on ``device``, at AlignerConfig
    defaults."""
    dev = resolve_device(device)
    idx = MinimizerIndex.build_from_fasta(gt_fasta, device=dev)
    aligner = MinimizerAligner(idx, device=dev)
    names, seqs = read_fasta(pred_fasta)
    best: Dict[str, Tuple[int, str]] = {}
    for rec in aligner.map_batch(names, seqs):
        cov = (rec.qend - rec.qstart) / rec.qlen if rec.qlen > 0 else 0.0
        iden = rec.nmatch / rec.blocklen if rec.blocklen > 0 else 0.0
        if cov < min_cov or iden < min_id:
            continue
        cur = best.get(rec.qname)
        if cur is None or rec.nmatch > cur[0]:
            best[rec.qname] = (rec.nmatch, rec.tname)
    return {q: t for q, (_, t) in best.items()}


def _pairs_by_md5(
    predictions: Dict[str, str], truth: Dict[str, str], pred_fasta: str, gt_fasta: str
) -> List[Tuple[str, str, str]]:
    """Pair prediction and truth contigs whose sequences hash identically."""
    by_hash: Dict[str, List[str]] = collections.defaultdict(list)
    for name, digest in sequence_md5s(gt_fasta).items():
        by_hash[digest].append(name)
    qhash = sequence_md5s(pred_fasta)
    pairs: List[Tuple[str, str, str]] = []
    for q, tid in predictions.items():
        digest = qhash.get(q)
        if not digest:
            continue
        for t in by_hash.get(digest, []):
            if truth.get(t):
                pairs.append((q, tid, truth[t]))
    return pairs


def _pairs_by_remap(
    predictions: Dict[str, str],
    truth: Dict[str, str],
    pred_fasta: str,
    gt_fasta: str,
    *,
    device="cuda",
) -> List[Tuple[str, str, str]]:
    """Pair via a >=95% cov/id best-hit alignment of pred onto truth."""
    pairs: List[Tuple[str, str, str]] = []
    for q, t in _contig_remap(pred_fasta, gt_fasta, device=device).items():
        if predictions.get(q) and truth.get(t):
            pairs.append((q, predictions[q], truth[t]))
    return pairs


def score_contigs(
    pred_file: Optional[str],
    gt_files: Sequence[Optional[str]],
    taxdb: TaxonomyDB,
    outdir: str,
    pred_fasta: Optional[str] = None,
    gt_fasta: Optional[str] = None,
    taxmap_path: Optional[str] = None,
    paf_path: Optional[str] = None,
    *,
    device="cuda",
) -> dict:
    """Exact-taxid and per-rank contig accuracy; writes contigs_exact.tsv
    and contigs_per_rank.tsv when any pair is usable. The remap, the last
    pairing leg, runs on ``device``."""
    dev = resolve_device(device)
    idmap = (
        IdentifierMap.from_detailed_taxonomy(taxmap_path)
        if taxmap_path and os.path.isfile(taxmap_path)
        else None
    )
    predictions = resolve_contig_taxids(pred_file, taxdb, idmap, paf_path)
    truth: Dict[str, str] = {}
    for gtf in gt_files:
        truth.update(read_truth_assignments(gtf))

    pairs = [(q, tid, truth[q]) for q, tid in predictions.items() if q in truth]
    have_fastas = bool(
        pred_fasta and gt_fasta and os.path.isfile(pred_fasta) and os.path.isfile(gt_fasta)
    )
    if not pairs and have_fastas:
        pairs = _pairs_by_md5(predictions, truth, pred_fasta, gt_fasta)
    if not pairs and have_fastas:
        pairs = _pairs_by_remap(predictions, truth, pred_fasta, gt_fasta, device=dev)

    usable = len(pairs)
    exact = sum(1 for _, ptid, gtid in pairs if ptid == gtid)

    chains = {
        tid: taxdb.taxpath(tid)[0]
        for tid in {p for _, p, _ in pairs} | {g for *_, g in pairs}
    }
    per_rank = {}
    for pos, rank in enumerate(RANKS):
        n = hit = 0
        for _, ptid, gtid in pairs:
            pchain = chains.get(ptid, "")
            gchain = chains.get(gtid, "")
            if not pchain or not gchain:
                continue
            pvec = pchain.split("|")
            gvec = gchain.split("|")
            if pos >= len(pvec) or pos >= len(gvec):
                continue
            # the reference counts empty (rank-truncated) slots — only "NA"
            # is skipped — so a genus-level prediction scores as incorrect
            # at species rank rather than being excluded (eval_cami.py:544)
            if pvec[pos] == "NA" or gvec[pos] == "NA":
                continue
            n += 1
            hit += int(pvec[pos] == gvec[pos])
        per_rank[rank] = {"n": n, "acc": (100.0 * hit / n if n else 0.0), "correct": hit}

    exact_path = os.path.join(outdir, "contigs_exact.tsv")
    perrank_path = os.path.join(outdir, "contigs_per_rank.tsv")
    if usable > 0:
        with open(exact_path, "w", newline="") as w:
            wr = csv.writer(w, delimiter="\t")
            wr.writerow(["metric", "value"])
            wr.writerow(["usable_pairs", usable])
            wr.writerow(["exact_taxid_matches", exact])
            wr.writerow(["exact_taxid_accuracy_percent", 100.0 * exact / usable])
        with open(perrank_path, "w", newline="") as w:
            wr = csv.writer(w, delimiter="\t")
            wr.writerow(["rank", "n", "correct", "accuracy_percent"])
            for rank in RANKS:
                m = per_rank.get(rank, {"n": 0, "correct": 0, "acc": 0.0})
                wr.writerow([rank, m["n"], m["correct"], f"{m['acc']:.4f}"])
    else:
        for stale in (exact_path, perrank_path):
            if os.path.exists(stale):
                os.remove(stale)

    return {
        "usable_pairs": usable,
        "exact": exact,
        "per_rank": per_rank,
        "pred_n": len(predictions),
        "gt_n": len(truth),
    }


# ----------------------------------------------------------------------
# top-level


def evaluate(
    pred_profile: Optional[str],
    truth_profile: Optional[str],
    outdir: str,
    pred_contigs: Optional[str] = None,
    truth_contigs: Optional[str] = None,
    pred_fasta: Optional[str] = None,
    truth_fasta: Optional[str] = None,
    taxonomy_dir: Optional[str] = None,
    taxmap: Optional[str] = None,
    paf: Optional[str] = None,
    presence_thresh: float = 0.1,
    *,
    device="cuda",
) -> int:
    """Scores a run against the truth: profile_summary.tsv, summary.txt,
    profile_diffs_<rank>.tsv, _debug_info.txt, and with contig tables
    contigs_exact.tsv and contigs_per_rank.tsv. ``device`` (resolved here,
    before anything is written) is where a contig remap runs."""
    dev = resolve_device(device)
    pathlib.Path(outdir).mkdir(parents=True, exist_ok=True)
    taxdb = _load_taxdb(taxonomy_dir)
    gt_files = [truth_contigs] if truth_contigs else []

    pred_prof = read_profile(pred_profile, taxdb)
    truth_prof = read_profile(truth_profile, taxdb)

    # profile fallback: rebuild either side from its per-contig labels
    rebuild_pred = all(not pred_prof[r] for r in RANKS)
    rebuild_truth = all(not truth_prof[r] for r in RANKS)
    lens: Dict[str, int] = {}
    if rebuild_pred or rebuild_truth:
        lens = sequence_lengths([pred_fasta, truth_fasta])
    if rebuild_pred and pred_contigs:
        idmap = (
            IdentifierMap.from_detailed_taxonomy(taxmap)
            if taxmap and os.path.isfile(taxmap)
            else None
        )
        pred_prof = rebuild_profile(
            resolve_contig_taxids(pred_contigs, taxdb, idmap, paf), lens, taxdb
        )
    if rebuild_truth and gt_files:
        truth_map: Dict[str, str] = {}
        for gtf in gt_files:
            truth_map.update(read_truth_assignments(gtf))
        truth_prof = rebuild_profile(truth_map, lens, taxdb)

    with open(os.path.join(outdir, "profile_summary.tsv"), "w", newline="") as w:
        wr = csv.writer(w, delimiter="\t")
        wr.writerow(
            [
                "rank",
                "L1_total_variation_pctpts",
                "BrayCurtis_pct",
                "Precision_%",
                "Recall_%",
                "F1_%",
                "TP",
                "FP",
                "FN",
            ]
        )
        for rank in RANKS:
            l1, bc = profile_distance(pred_prof[rank], truth_prof[rank])
            pr, rc, f1, tp, fp, fn = presence_prf(
                pred_prof[rank], truth_prof[rank], presence_thresh
            )
            wr.writerow(
                [rank, f"{l1:.4f}", f"{bc:.4f}", f"{pr:.2f}", f"{rc:.2f}", f"{f1:.2f}", tp, fp, fn]
            )

    if pred_contigs and gt_files:
        score_contigs(
            pred_contigs,
            gt_files,
            taxdb,
            outdir,
            pred_fasta=pred_fasta,
            gt_fasta=truth_fasta,
            taxmap_path=taxmap,
            paf_path=paf,
            device=dev,
        )

    # per-rank abundance diff tables + human summary (the prior
    # evaluator's extras, reference tools/eval_cami_prior.py:435-446)
    with open(os.path.join(outdir, "summary.txt"), "w") as w:
        w.write("# Profile-level metrics (per rank)\n")
        for rank in RANKS:
            l1, bc = profile_distance(pred_prof[rank], truth_prof[rank])
            pr, rc, f1, tp, fp, fn = presence_prf(
                pred_prof[rank], truth_prof[rank], presence_thresh
            )
            w.write(
                f"{rank:14s}  L1={l1:.3f}  BC={bc:.3f}%  "
                f"P/R/F1={pr:.1f}/{rc:.1f}/{f1:.1f}% (TP={tp}, FP={fp}, FN={fn})\n"
            )
    for rank in RANKS:
        taxa = set(pred_prof[rank]) | set(truth_prof[rank])
        if not taxa:
            continue
        with open(os.path.join(outdir, f"profile_diffs_{rank}.tsv"), "w", newline="") as w:
            wr = csv.writer(w, delimiter="\t")
            wr.writerow(["taxid", "pred_pct", "truth_pct", "diff"])
            by_gap = sorted(
                taxa,
                key=lambda t: -abs(pred_prof[rank].get(t, 0.0) - truth_prof[rank].get(t, 0.0)),
            )
            for taxon in by_gap:
                a = pred_prof[rank].get(taxon, 0.0)
                b = truth_prof[rank].get(taxon, 0.0)
                wr.writerow([taxon, f"{a:.6f}", f"{b:.6f}", f"{a - b:.6f}"])

    with open(os.path.join(outdir, "_debug_info.txt"), "w") as w:
        w.write(f"pred_profile_path: {pred_profile}\n")
        w.write(f"truth_profile_path: {truth_profile}\n")
        w.write(f"pred_contigs_path: {pred_contigs}\n")
        w.write("truth_contigs_paths:\n  " + "\n  ".join(g for g in gt_files if g) + "\n")
        w.write(f"pred_fasta: {pred_fasta}\n")
        w.write(f"truth_fasta: {truth_fasta}\n")
        w.write(f"taxonomy_dir: {taxonomy_dir}\n")
        w.write(f"taxmap: {taxmap}\n")
        w.write(f"paf: {paf}\n")
    return 0


def _load_taxdb(taxonomy_dir: Optional[str]) -> TaxonomyDB:
    if taxonomy_dir:
        if os.path.exists(os.path.join(taxonomy_dir, "names.dmp")):
            return TaxonomyDB.from_taxdump(taxonomy_dir)
        tsv = (
            taxonomy_dir
            if taxonomy_dir.endswith(".tsv")
            else os.path.join(taxonomy_dir, "taxonomy_hierarchy.tsv")
        )
        if os.path.exists(tsv):
            return TaxonomyDB.from_hierarchy_tsv(tsv)
    return TaxonomyDB()
