"""8-rank lineage codec (copy of hymet_tpu.taxonomy.lineage).

Parses the four lineage encodings accepted by the reference classifier
(``scripts/classification_cami.py:104-156``) into a fixed vector of names
aligned to :data:`hymet_tpu_torch.RANKS`, and re-encodes the canonical
``rank:name; rank:name`` form the classifier emits
(``classification_cami.py:286``).
"""

from __future__ import annotations

import re
from typing import List, Sequence

from hymet_tpu_torch import RANKS, RANK_ALIAS

_SPLIT_RE = re.compile(r"[;|]+")


def lineage_to_rank_names(lineage_raw: str) -> List[str]:
    """Normalize a lineage string into a list of names aligned to RANKS.

    Accepted forms (same cascade as the reference):
      - ``rank:name; rank:name; ...``
      - ``k__Bacteria; p__Firmicutes; ...``
      - ``Bacteria; Firmicutes; ...`` (plain, ordered from superkingdom)
      - ``name1|name2|...`` (pipe-separated plain)
    """
    names_by_rank = [""] * len(RANKS)
    if not lineage_raw:
        return names_by_rank

    s = lineage_raw.strip()
    if not s:
        return names_by_rank

    if ":" in s:
        for part in _SPLIT_RE.split(s):
            part = part.strip()
            if not part or ":" not in part:
                continue
            rk, nm = part.split(":", 1)
            rank = RANK_ALIAS.get(rk.strip().lower())
            nm = nm.strip()
            if not rank or not nm:
                continue
            names_by_rank[RANKS.index(rank)] = nm
        return names_by_rank

    if "__" in s:
        for part in _SPLIT_RE.split(s):
            part = part.strip()
            if not part or "__" not in part:
                continue
            rk_tag, nm = part.split("__", 1)
            rank = RANK_ALIAS.get(rk_tag.strip().lower())
            nm = nm.strip()
            if not rank or not nm:
                continue
            names_by_rank[RANKS.index(rank)] = nm
        return names_by_rank

    parts = [p.strip() for p in _SPLIT_RE.split(s)]
    seq = [p for p in parts if p and p.upper() != "NA"]
    for i, nm in enumerate(seq[: len(RANKS)]):
        names_by_rank[i] = nm
    return names_by_rank


def rank_names_to_lineage(names: Sequence[str]) -> str:
    """Encode chosen per-rank names as ``rank:name; ...`` (prefix up to the
    last contiguous chosen rank is the caller's concern; we encode what is
    given)."""
    return "; ".join(f"{RANKS[i]}:{nm}" for i, nm in enumerate(names) if nm)
