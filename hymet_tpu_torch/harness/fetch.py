"""Idempotent dataset fetching: the ``bench/fetch_cami.sh`` /
``case/fetch_case_data.sh`` replacement (copy of hymet_tpu.harness.fetch).

Downloads the ``*_url`` assets referenced by a manifest next to their
target paths, skipping files that already exist, with sha256 echo for
provenance (``fetch_case_data.sh`` prints checksums the same way).
Gated on network availability — air-gapped deployments simply pre-place
the files.
"""

from __future__ import annotations

import hashlib
import logging
import os
import urllib.request
from typing import List, Tuple

from hymet_tpu_torch.harness.manifest import load_manifest

logger = logging.getLogger("hymet_tpu_torch.fetch")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fetch_url(url: str, target: str) -> bool:
    if os.path.exists(target) and os.path.getsize(target) > 0:
        logger.info("exists: %s", target)
        return True
    os.makedirs(os.path.dirname(os.path.abspath(target)) or ".", exist_ok=True)
    tmp = target + ".part"
    try:
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, target)
    except Exception as e:  # noqa: BLE001
        logger.warning("fetch failed %s: %s", url, e)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    logger.info("fetched %s sha256=%s", target, _sha256(target))
    return True


def fetch_manifest_assets(manifest_path: str) -> Tuple[List[str], List[str]]:
    """Fetch every (path, *_url) pair in the manifest. Returns
    (fetched_or_present, failed)."""
    ok: List[str] = []
    failed: List[str] = []
    url_for = {
        "contigs_url": "contigs",
        "truth_contigs_url": "truth_contigs",
        "truth_profile_url": "truth_profile",
    }
    for row in load_manifest(manifest_path):
        for url_col, attr in url_for.items():
            url = (row.extra.get(url_col) or "").strip()
            target = getattr(row, attr)
            if not url or not target:
                continue
            (ok if fetch_url(url, target) else failed).append(target)
    return ok, failed
