"""Collective helpers over the ("data", "db") mesh (counterpart of
hymet_tpu.parallel.collectives)."""

from __future__ import annotations

from typing import Tuple

import torch

from hymet_tpu_torch.parallel.distributed import process_count
from hymet_tpu_torch.parallel.mesh import Mesh, fetch_global_tree


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a 1-D tensor, ties in ``lax.top_k``'s order (the lower
    index first): a stable descending sort. ``torch.topk`` promises no
    order for ties."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def sharded_topk(mesh: Mesh, scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over db-sharded per-reference scores.

    scores: [R_total], split row-block over "db" (R_total a multiple of
    the db size, as a sharded array must be). Each shard takes a local
    top-k on its device and adds its base offset; the candidates are
    gathered, in shard order, on the first shard's device and reduced to
    the global top-k (SURVEY.md §2.6 "per-shard top-k then global merge").

    Returns (values [k], indices int64 [k]) on the first shard's device;
    over a mesh that spans processes, each process takes the top-k of the
    shards it owns, the candidates are gathered in shard order, and every
    process gets the result on `scores`' device.
    """
    devices = mesh.db_devices
    n_db = len(devices)
    R = scores.shape[0]
    if R % n_db:
        raise ValueError(f"{R} scores do not split over {n_db} db shards")
    shard = R // n_db
    out = devices[0] if process_count() == 1 else scores.device
    vals, idx = {}, {}
    for i in mesh.local_shards:
        local = scores[i * shard : (i + 1) * shard].to(devices[i])
        v, j = _topk_stable(local, min(k, shard))
        vals[i], idx[i] = v.to(out), (j + i * shard).to(out)
    if process_count() > 1:
        vals, idx = ({i: torch.from_numpy(x).to(out) for i, x in part.items()}
                     for part in fetch_global_tree((vals, idx)))
    all_vals = torch.cat([vals[i] for i in sorted(vals)])
    all_idx = torch.cat([idx[i] for i in sorted(idx)])
    g_vals, g_pos = _topk_stable(all_vals, min(k, all_vals.shape[0]))
    return g_vals, all_idx[g_pos]
