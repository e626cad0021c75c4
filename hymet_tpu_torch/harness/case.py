"""Real-data case-study harness: the ``case/run_case.sh`` replacement (copy
of hymet_tpu.harness.case; runs and evaluation on the device
``HYMET_PLATFORM`` names, as in :mod:`hymet_tpu_torch.harness.bench`).

Per manifest sample: measured HYMET run (bench defaults), a top-N taxa
table from the predicted profile (``run_case.sh:97-119``), and an
optional profile sanity comparison computing symmetric KL divergence and
Spearman rank correlation between two profiles
(``run_case.sh:167-264`` — there against MetaPhlAn; here against any
comparison profile given in the manifest's ``compare_profile`` column or
produced by a baseline runner).
"""

from __future__ import annotations

import csv
import logging
import math
import os
from typing import Dict, List, Optional, Tuple

from hymet_tpu_torch.evalx.cami import parse_cami_profile
from hymet_tpu_torch.harness.manifest import load_manifest
from hymet_tpu_torch.harness.measure import measured
from hymet_tpu_torch.utils.device import device_from_env, resolve_device

logger = logging.getLogger("hymet_tpu_torch.case")


def top_taxa_table(profile_path: str, out_path: str, top_n: int = 15) -> None:
    rows = parse_cami_profile(profile_path)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["rank", "taxid", "name", "percentage"])
        for rank in ("species", "genus", "phylum"):
            ranked = sorted(
                (r for r in rows if r["rank"] == rank),
                key=lambda r: -r["percentage"],
            )[:top_n]
            for r in ranked:
                # last non-empty name on the taxpath
                names = [n for n in r["taxpathsn"].split("|") if n]
                name = names[-1] if names else ""
                w.writerow([rank, r["taxid"], name, f"{r['percentage']:.4f}"])


def symmetric_kl(a: Dict[str, float], b: Dict[str, float], eps: float = 1e-9) -> float:
    keys = set(a) | set(b)
    sa = sum(a.values()) or 1.0
    sb = sum(b.values()) or 1.0
    kl_ab = 0.0
    kl_ba = 0.0
    for k in keys:
        pa = max(a.get(k, 0.0) / sa, eps)
        pb = max(b.get(k, 0.0) / sb, eps)
        kl_ab += pa * math.log(pa / pb)
        kl_ba += pb * math.log(pb / pa)
    return kl_ab + kl_ba


def spearman(a: Dict[str, float], b: Dict[str, float]) -> float:
    keys = sorted(set(a) | set(b))
    if len(keys) < 2:
        return 0.0

    def ranks(d: Dict[str, float]) -> List[float]:
        vals = [(d.get(k, 0.0), i) for i, k in enumerate(keys)]
        order = sorted(range(len(vals)), key=lambda i: -vals[i][0])
        rk = [0.0] * len(keys)
        i = 0
        while i < len(order):
            j = i
            while j + 1 < len(order) and vals[order[j + 1]][0] == vals[order[i]][0]:
                j += 1
            avg = (i + j) / 2.0 + 1.0
            for t in range(i, j + 1):
                rk[order[t]] = avg
            i = j + 1
        return rk

    ra, rb = ranks(a), ranks(b)
    n = len(keys)
    ma = sum(ra) / n
    mb = sum(rb) / n
    cov = sum((x - ma) * (y - mb) for x, y in zip(ra, rb))
    va = math.sqrt(sum((x - ma) ** 2 for x in ra))
    vb = math.sqrt(sum((y - mb) ** 2 for y in rb))
    if va == 0 or vb == 0:
        return 0.0
    return cov / (va * vb)


def compare_profiles(
    profile_a: str, profile_b: str, rank: str = "species"
) -> Tuple[float, float]:
    """(symmetric KL, Spearman) at `rank` between two CAMI profiles."""
    a = {
        r["taxid"]: r["percentage"]
        for r in parse_cami_profile(profile_a)
        if r["rank"] == rank
    }
    b = {
        r["taxid"]: r["percentage"]
        for r in parse_cami_profile(profile_b)
        if r["rank"] == rank
    }
    return symmetric_kl(a, b), spearman(a, b)


def run_case(
    manifest: Optional[str],
    out_root: Optional[str] = None,
    threads: int = 8,
) -> int:
    if not manifest or not os.path.exists(manifest):
        raise FileNotFoundError(f"manifest not found: {manifest}")
    device = device_from_env()
    resolve_device(device)
    out_root = out_root or "out/case"
    os.makedirs(out_root, exist_ok=True)
    runtime_log = os.path.join(out_root, "runtime_memory.tsv")

    from hymet_tpu_torch.harness.bench import _run_eval, _run_hymet_tpu

    for row in load_manifest(manifest):
        if not row.contigs or not os.path.exists(row.contigs):
            logger.warning("sample %s: contigs missing; skipping", row.sample_id)
            continue
        tool_dir = os.path.join(out_root, row.sample_id, "hymet_tpu")
        os.makedirs(tool_dir, exist_ok=True)
        with measured(runtime_log, row.sample_id, "hymet_tpu", "run"):
            _run_hymet_tpu(row, tool_dir, threads, device)

        profile = os.path.join(tool_dir, "profile.cami.tsv")
        if os.path.exists(profile):
            top_taxa_table(profile, os.path.join(tool_dir, "top_taxa.tsv"))

        if row.truth_profile or row.truth_contigs:
            with measured(runtime_log, row.sample_id, "hymet_tpu", "eval"):
                _run_eval(row, tool_dir, device)

        compare = (row.extra.get("compare_profile") or "").strip()
        if compare and not os.path.isabs(compare):
            # resolve against the manifest directory like the path columns
            compare = os.path.normpath(
                os.path.join(os.path.dirname(os.path.abspath(manifest)), compare)
            )
        if compare and os.path.exists(compare) and os.path.exists(profile):
            kl, rho = compare_profiles(profile, compare)
            with open(os.path.join(tool_dir, "profile_compare.tsv"), "w") as f:
                f.write("metric\tvalue\n")
                f.write(f"symmetric_kl_species\t{kl:.6f}\n")
                f.write(f"spearman_species\t{rho:.6f}\n")
    return 0
