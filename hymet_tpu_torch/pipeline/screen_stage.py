"""Sketch-screen stage: reference ``scripts/mash.sh`` semantics over the
device screen engine (counterpart of hymet_tpu.pipeline.screen_stage).

- screen the pooled query k-mer stream against a sketch DB
  (``mash screen -p 8 -v 0.9``, line 14);
- unique rows by reference id, sort by identity descending (lines 15-16);
- adaptive threshold walk: min_candidates = max(5, round(3.25 * number of
  input files)); start at the initial threshold (default 0.9), step down
  by 0.02 until >= min_candidates rows have identity STRICTLY GREATER
  than the threshold, floor 0.70; if never reached, filter with 0.71
  (lines 19-51: the reference echoes "Using 0.70" but filters with 0.71);
- emit top_hits.tab and selected_genomes.txt (column 5 = reference id).

The walk uses exact decimal arithmetic (the reference uses bc) and float
comparison of the printed threshold (the reference's awk parses a double).
"""

from __future__ import annotations

import os
from decimal import Decimal
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hymet_tpu_torch.io.fasta import encode_seq, iter_fasta
from hymet_tpu_torch.io.sketchdb import SketchDB
from hymet_tpu_torch.ops.sketch import ScreenEngine, ScreenResult
from hymet_tpu_torch.parallel.screen import ShardedScreenEngine

DEFAULT_PVALUE_MAX = 0.9  # mash screen -v 0.9 (mash.sh:14)
THRESHOLD_FLOOR = Decimal("0.70")
THRESHOLD_STEP = Decimal("0.02")
FALLBACK_THRESHOLD = 0.71  # mash.sh:48


ScreenRow = Tuple[float, str, int, float, str, str]


def stream_screen(
    db: SketchDB,
    query_files: Sequence[str],
    chunk_bp: int = 1 << 20,
    staged=None,
    device="cuda",
    mesh=None,
) -> ScreenResult:
    """Stream all sequences of all query files through the screen engine.

    Chunked path: sequences are cut to `chunk_bp` with a k-1 overlap so no
    window is lost, and the chunks go to the device 8 rows at a time,
    2-bit packed.

    ``staged`` (:class:`hymet_tpu_torch.pipeline.staged.StagedContigs`, one
    device only): consume the upload-once device-resident batches instead
    of re-reading the files; whole-contig rows carry the same k-mer
    multiset as the overlapped chunk rows, so the counts are identical.
    With a ``mesh`` (:func:`hymet_tpu_torch.parallel.make_mesh`) the
    db-sharded engine takes the chunked path on the mesh's devices.
    """
    if mesh is not None:
        eng = ShardedScreenEngine(mesh, db)
    else:
        eng = ScreenEngine(db, device=device)
        if staged is not None:
            for packed, mask, _rows, L in staged.device:
                eng.update_staged(packed, mask, L)
            return eng.finalize()
    k = db.k

    ROWS = 8
    buf = np.full((ROWS, chunk_bp), 4, dtype=np.uint8)
    buf_row = 0

    def flush():
        nonlocal buf_row, buf
        if buf_row == 0:
            return
        batch = buf if buf_row == ROWS else buf[:buf_row].copy()
        eng.update_codes_packed(batch)
        buf = np.full((ROWS, chunk_bp), 4, dtype=np.uint8)
        buf_row = 0

    for qf in query_files:
        for _, seq in iter_fasta(qf):
            codes = encode_seq(seq)
            L = codes.shape[0]
            if L < k:
                continue
            start = 0
            while start < L:
                end = min(L, start + chunk_bp)
                chunk = codes[start:end]
                if chunk.shape[0] >= k:
                    buf[buf_row, : chunk.shape[0]] = chunk
                    buf[buf_row, chunk.shape[0] :] = 4
                    buf_row += 1
                    if buf_row == ROWS:
                        flush()
                if end == L:
                    break
                start = end - (k - 1)
    flush()
    return eng.finalize()


def screen_rows_filtered(res: ScreenResult, pvalue_max: float) -> List[ScreenRow]:
    """mash screen emits only references with shared hashes > 0 and
    p-value <= -v threshold."""
    rows = []
    pv = res.pvalues()
    for i, row in enumerate(res.rows()):
        if res.shared[i] > 0 and pv[i] <= pvalue_max:
            rows.append(row)
    return rows


def write_screen_tab(path: str, rows: Sequence[ScreenRow]) -> None:
    """screen.tab: identity, shared/total, median-mult, p-value, ref-id,
    comment; identity at 6 decimals."""
    with open(path, "w", encoding="utf-8") as f:
        for ident, shared, median, pv, name, comment in rows:
            f.write(f"{ident:.6f}\t{shared}\t{median}\t{pv:.6g}\t{name}\t{comment}\n")


def unique_sorted_rows(rows: Sequence[ScreenRow]) -> List[ScreenRow]:
    """``sort -u -k5,5`` then ``sort -gr``: one row per reference id (best
    identity wins), ordered by identity descending (mash.sh:15-16)."""
    best = {}
    for row in rows:
        name = row[4]
        if name not in best or row[0] > best[name][0]:
            best[name] = row
    return sorted(best.values(), key=lambda r: r[0], reverse=True)


def adaptive_threshold_select(
    sorted_rows: Sequence[ScreenRow],
    num_input_files: int,
    initial_threshold: float = 0.9,
) -> Tuple[List[ScreenRow], float, int]:
    """The mash.sh:19-55 walk. Returns (top_hits, threshold_used,
    min_candidates)."""
    min_candidates = max(5, int(Decimal(num_input_files) * Decimal("3.25") + Decimal("0.5")))
    identities = np.array([r[0] for r in sorted_rows])

    current = Decimal(str(initial_threshold))
    best: Optional[float] = None
    while current >= THRESHOLD_FLOOR:
        t = float(current)
        if int((identities > t).sum()) >= min_candidates:
            best = t
            break
        current -= THRESHOLD_STEP
    if best is None:
        best = FALLBACK_THRESHOLD
    top = [r for r in sorted_rows if r[0] > best]
    return top, best, min_candidates


def run_screen_stage(
    dbs: Sequence[SketchDB],
    query_files: Sequence[str],
    outdir: str,
    initial_threshold: float = 0.9,
    db_labels: Optional[Sequence[str]] = None,
    chunk_bp: int = 1 << 20,
    staged=None,
    device="cuda",
    mesh=None,
) -> List[str]:
    """Full stage over several sketch DBs (the reference screens sketch1,
    sketch2, sketch3 and unions the selections, ``run_hymet_cami.sh:83-98``).

    Writes per-DB screen/sorted/top_hits/selected files plus the unioned,
    de-duplicated ``selected_genomes.txt``; returns the selected ids.
    With a ``mesh`` the merged DB is sharded over it (:func:`stream_screen`).
    """
    os.makedirs(outdir, exist_ok=True)
    labels = list(db_labels) if db_labels else [f"db{i+1}" for i in range(len(dbs))]

    def screen(db):
        return stream_screen(
            db, query_files, chunk_bp=chunk_bp, staged=staged, device=device, mesh=mesh
        )

    # single pass: DBs sharing k are merged and the queries stream once;
    # per-DB rows are slices of the merged result (identical to screening
    # each DB alone)
    results: List[ScreenResult]
    if len(dbs) > 1 and len({db.k for db in dbs}) == 1:
        res = screen(SketchDB.concat(dbs))
        results = []
        off = 0
        for db in dbs:
            results.append(res.slice(off, db))
            off += db.n_refs
    else:
        results = [screen(db) for db in dbs]

    union: List[str] = []
    for db, label, res in zip(dbs, labels, results):
        rows = screen_rows_filtered(res, DEFAULT_PVALUE_MAX)
        write_screen_tab(os.path.join(outdir, f"{label}_screen.tab"), rows)
        srt = unique_sorted_rows(rows)
        write_screen_tab(os.path.join(outdir, f"{label}_sorted.tab"), srt)
        top, _used, _ = adaptive_threshold_select(srt, len(query_files), initial_threshold)
        write_screen_tab(os.path.join(outdir, f"{label}_top_hits.tab"), top)
        with open(os.path.join(outdir, f"{label}_selected_genomes.txt"), "w") as f:
            for r in top:
                f.write(r[4] + "\n")
        union.extend(r[4] for r in top)

    selected = sorted(set(union))  # sort -u (run_hymet_cami.sh:98)
    with open(os.path.join(outdir, "selected_genomes.txt"), "w") as f:
        for name in selected:
            f.write(name + "\n")
    return selected
