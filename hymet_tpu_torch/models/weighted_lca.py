"""Production classifier: PAF -> per-contig lineage TSV (counterpart of
hymet_tpu.models.weighted_lca).

Drop-in equivalent of reference ``scripts/classification_cami.py``: same
input contracts (PAF + detailed_taxonomy.tsv + taxonomy_hierarchy.tsv),
same output TSV (``Query  Lineage  Taxonomic Level  Confidence``, 4dp),
same weighting (coverage * per-reference alignment count) and consensus
semantics, with the per-query LCA loop replaced by the batched
:func:`hymet_tpu_torch.ops.lca.weighted_lca`.

Two backends:
  - ``device`` (``jax``, the JAX package's name for it, is accepted as the
    same) — bucketed, padded batches through ``weighted_lca``, always in
    float64: the hand-written kernel on the card, its plain version on the
    CPU (the JAX package computes in float32 where x64 is off, as on its
    TPU; ROADMAP C2);
  - ``host`` — the reference-exact Python oracle (golden path).
"""

from __future__ import annotations

import csv
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hymet_tpu_torch import RANKS
from hymet_tpu_torch.io.paf import parse_paf_for_classification
from hymet_tpu_torch.ops.lca import bucket_pad, weighted_lca, weighted_lca_host
from hymet_tpu_torch.taxonomy.idmap import IdentifierMap
from hymet_tpu_torch.taxonomy.lineage import lineage_to_rank_names
from hymet_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("hymet_tpu_torch.classify")

ClassifyResult = Tuple[str, str, str, float]  # query, lineage, level, conf

BACKENDS = ("device", "jax", "host")


def load_hierarchy_vectors(path: str) -> Dict[str, List[str]]:
    """taxonomy_hierarchy.tsv -> {taxid: 8-rank name vector}.

    Parity with reference ``load_taxonomy_hierarchy_file``
    (``classification_cami.py:158-174``)."""
    hier: Dict[str, List[str]] = {}
    with open(path, "r", encoding="utf-8", errors="ignore", newline="") as f:
        header = f.readline().rstrip("\r\n").split("\t")
        if "TaxID" not in header or "Lineage" not in header:
            raise RuntimeError("Hierarchy file must have TaxID and Lineage columns")
        tid_i = header.index("TaxID")
        lin_i = header.index("Lineage")
        for line in f:
            if not line.strip():
                continue
            row = line.rstrip("\r\n").split("\t")
            tid = row[tid_i].strip() if tid_i < len(row) else ""
            lin = row[lin_i].strip() if lin_i < len(row) else ""
            if not tid:
                continue
            hier[tid] = lineage_to_rank_names(lin)
    logger.info("Loaded %d taxonomy hierarchies", len(hier))
    return hier


def taxid_weights(
    query_map: Dict[str, List[Tuple[str, float]]],
    ref_counts: Dict[str, int],
    idmap: IdentifierMap,
) -> List[Dict[str, float]]:
    """Per query (in query_map's order), weight per taxid in hit order:
    coverage * the target's alignment count, summed left to right in
    float64, the exact reference accumulation
    (``classification_cami.py:296-304``); targets no taxid resolves drop."""
    # Resolve target names -> taxids once per unique name.
    tname_taxid: Dict[str, Optional[str]] = {}
    for hits in query_map.values():
        for tname, _ in hits:
            if tname not in tname_taxid:
                tname_taxid[tname] = idmap.lookup(tname)

    per_query_tw: List[Dict[str, float]] = []
    for hits in query_map.values():
        tw: Dict[str, float] = {}
        for tname, cov in hits:
            tid = tname_taxid[tname]
            if not tid:
                continue
            w = cov * ref_counts.get(tname, 1)
            tw[tid] = tw.get(tid, 0.0) + w
        per_query_tw.append(tw)
    return per_query_tw


def lca_inputs(
    per_query_tw: Sequence[Dict[str, float]], hier: Dict[str, Sequence[str]]
) -> Tuple[np.ndarray, List[str], List[Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """The device backend's inputs: the rank table of the taxids hit
    (int32 [T, 8], 0 = no name), the interned names (names[0] == ""), and
    the hit lists in :func:`bucket_pad`'s batches."""
    # Intern the taxids actually hit + their rank-name vectors.
    used_taxids: List[str] = []
    tax_row: Dict[str, int] = {}
    names: List[str] = [""]
    intern: Dict[str, int] = {"": 0}
    rows_tmp: List[List[int]] = []
    for tw in per_query_tw:
        for tid in tw:
            if tid in tax_row:
                continue
            vec = hier.get(tid)
            if not vec:
                # taxid without hierarchy entry contributes nothing at any
                # rank (reference skips it inside the rank loop) — encode as
                # an all-zero row so its weight never lands in any name.
                vec = [""] * len(RANKS)
            tax_row[tid] = len(used_taxids)
            used_taxids.append(tid)
            row = []
            for r in range(len(RANKS)):
                nm = vec[r] if r < len(vec) else ""
                if not nm:
                    row.append(0)
                    continue
                j = intern.get(nm)
                if j is None:
                    j = len(names)
                    intern[nm] = j
                    names.append(nm)
                row.append(j)
            rows_tmp.append(row)

    rank_table = np.asarray(rows_tmp, dtype=np.int32) if rows_tmp else np.zeros(
        (1, len(RANKS)), dtype=np.int32
    )
    entries_per_query: List[List[Tuple[int, float]]] = [
        [(tax_row[tid], w) for tid, w in tw.items()] for tw in per_query_tw
    ]
    return rank_table, names, bucket_pad(entries_per_query)


def classify_query_map(
    query_map: Dict[str, List[Tuple[str, float]]],
    ref_counts: Dict[str, int],
    idmap: IdentifierMap,
    hier: Dict[str, Sequence[str]],
    backend: str = "device",
    device="cuda",
) -> List[ClassifyResult]:
    """Classify an in-memory query->hits map. Returns rows in query
    insertion order (the reference's stable output order,
    ``classification_cami.py:333-339``). The device backend runs on
    `device` (default the card; raises without one)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown classifier backend {backend!r}; expected one of {BACKENDS}")
    dev = None if backend == "host" else resolve_device(device)
    queries = list(query_map.keys())
    per_query_tw = taxid_weights(query_map, ref_counts, idmap)

    if backend == "host":
        results: List[ClassifyResult] = []
        for q, tw in zip(queries, per_query_tw):
            if not tw:
                results.append((q, "Unknown", "root", 0.0))
                continue
            lineage, level, conf = weighted_lca_host(tw, hier)
            results.append((q, lineage, level, conf))
        return results

    # ---- device backend ----
    rank_table, names, batches = lca_inputs(per_query_tw, hier)
    out_lineage = ["Unknown"] * len(queries)
    out_level = ["root"] * len(queries)
    out_conf = [0.0] * len(queries)

    rank_table_t = torch.from_numpy(rank_table).to(dev)
    for qidx, rows, weights in batches:
        chosen, n_chosen, conf = weighted_lca(
            torch.from_numpy(rows).to(dev), torch.from_numpy(weights).to(dev), rank_table_t
        )
        chosen = chosen.cpu().numpy()
        n_chosen = n_chosen.cpu().numpy()
        conf = conf.cpu().numpy()
        for i, qi in enumerate(qidx):
            n = int(n_chosen[i])
            if n <= 0:
                continue
            parts = [
                f"{RANKS[r]}:{names[int(chosen[i, r])]}" for r in range(n)
            ]
            out_lineage[qi] = "; ".join(parts)
            out_level[qi] = RANKS[n - 1]
            out_conf[qi] = float(conf[i])

    return [
        (q, out_lineage[i], out_level[i], out_conf[i])
        for i, q in enumerate(queries)
    ]


def classify_paf(
    paf_file: str,
    taxonomy_file: str,
    hierarchy_file: str,
    output_file: str,
    backend: str = "device",
    device="cuda",
) -> Tuple[int, int]:
    """Full file-level drop-in for ``classification_cami.py``'s
    ``main_process``. Returns (classified, total)."""
    idmap = IdentifierMap.from_detailed_taxonomy(taxonomy_file)
    logger.info("Loaded %d taxonomy mappings", len(idmap))
    hier = load_hierarchy_vectors(hierarchy_file)
    query_map, ref_counts = parse_paf_for_classification(paf_file)
    logger.info("Processed %d queries from PAF file", len(query_map))

    results = classify_query_map(query_map, ref_counts, idmap, hier, backend=backend,
                                 device=device)
    write_classified_tsv(output_file, results)
    classified = sum(1 for _, lin, _, _ in results if lin != "Unknown")
    total = len(results)
    logger.info("Classification complete. Results saved to %s", output_file)
    logger.info(
        "Classified: %d/%d (%.1f%%)", classified, total, 100.0 * classified / total if total else 0.0
    )
    return classified, total


def write_classified_tsv(path: str, results: Sequence[ClassifyResult]) -> None:
    """Write the 4-column output TSV, byte-identical formatting to the
    reference (``classification_cami.py:334-339``, which uses csv.writer
    with tab delimiter — hence CRLF line endings and minimal quoting)."""
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["Query", "Lineage", "Taxonomic Level", "Confidence"])
        for q, lineage, level, conf in results:
            w.writerow([q, lineage, level, f"{conf:.4f}"])
