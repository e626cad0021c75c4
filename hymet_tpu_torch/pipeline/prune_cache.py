"""Cache pruning: port of reference ``bench/tools/prune_cache.py``.

Age- and size-based pruning of content-addressed reference cache
directories (``prune_cache.py:113-138``): entries older than max_age_days
are removed first; if the remainder still exceeds max_size_gb, the oldest
entries are removed until under the limit. (The port's own copy of
hymet_tpu.pipeline.prune_cache.)
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class CacheEntry:
    path: str
    size_bytes: int
    mtime: float

    @property
    def age_days(self) -> float:
        return (time.time() - self.mtime) / 86400.0


def _dir_size(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(root, fn))
            except OSError:
                pass
    return total


def scan_cache(cache_root: str) -> List[CacheEntry]:
    entries: List[CacheEntry] = []
    if not os.path.isdir(cache_root):
        return entries
    for name in os.listdir(cache_root):
        path = os.path.join(cache_root, name)
        if not os.path.isdir(path):
            continue
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            continue
        entries.append(CacheEntry(path, _dir_size(path), mtime))
    return entries


def prune_cache(
    cache_root: str,
    max_age_days: Optional[float] = None,
    max_size_gb: Optional[float] = None,
    dry_run: bool = False,
) -> List[str]:
    """Returns the list of removed (or would-be-removed) paths."""
    entries = scan_cache(cache_root)
    removed: List[str] = []

    def remove(entry: CacheEntry) -> None:
        removed.append(entry.path)
        if not dry_run:
            shutil.rmtree(entry.path, ignore_errors=True)

    remaining: List[CacheEntry] = []
    if max_age_days is not None and max_age_days > 0:
        for e in entries:
            if e.age_days > max_age_days:
                remove(e)
            else:
                remaining.append(e)
    else:
        remaining = entries

    if max_size_gb is not None and max_size_gb > 0:
        limit = max_size_gb * 1024**3
        remaining.sort(key=lambda e: e.mtime)  # oldest first
        total = sum(e.size_bytes for e in remaining)
        for e in list(remaining):
            if total <= limit:
                break
            remove(e)
            total -= e.size_bytes
    return removed
