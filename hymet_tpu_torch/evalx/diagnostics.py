"""Diagnostics (copy of hymet_tpu.evalx.diagnostics): port of reference
``tools/diag_overlap.py`` — reports
id-map vs PAF-target key overlap (direct and versionless), the quick
sanity check for "why is everything Unknown?"."""

from __future__ import annotations

import gzip
from typing import Dict, Tuple


def diag_overlap(paf_path: str, id_map: Dict[str, str]) -> Tuple[int, int, int, int]:
    """Returns (n_keys, n_targets, direct_overlap, versionless_overlap)."""

    def opener(p: str):
        if p.endswith(".gz"):
            return gzip.open(p, "rt", encoding="utf-8", errors="ignore")
        return open(p, "r", encoding="utf-8", errors="ignore")

    keys = set(id_map.keys())
    targets = set()
    with opener(paf_path) as f:
        for ln in f:
            if not ln or ln[0] == "#":
                continue
            p = ln.rstrip("\n").split("\t")
            if len(p) >= 6:
                targets.add(p[5])
    direct = sum(1 for t in targets if t in keys)
    versionless = sum(
        1 for t in targets if (t.split(".", 1)[0] in keys) and (t not in keys)
    )
    return len(keys), len(targets), direct, versionless
