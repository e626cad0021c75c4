#!/usr/bin/env python3
"""The ``lca`` kernel of one checkout of hymet_tpu_torch, on one CUDA card:
its device time on a gut classification's bucket batches and on
chip_smoke's LCA edge sets, each held to ``weighted_lca_torch`` bit for
bit, beside the launch floor (a one-element in-place add).

    python3 tools/lca_ab.py prepare <batches.npz>
    python3 tools/lca_ab.py <root of a checkout that holds hymet_tpu_torch> <batches.npz>

Run from the root of this repository. ``prepare`` runs
``ClassificationRun.execute`` on the gut sample as chip_smoke's phase 8
does (this repository's package, a cold cache in a temporary directory)
and saves the classification's rank table and bucket batches. The second
form times them with the checkout's kernel. To hold a change against its
parent on one card, unpack the parent into a directory that .gitignore
lists and run them in turns in one command:

    git archive HEAD~1 hymet_tpu_torch | tar -x -C build/parent
    python3 tools/lca_ab.py prepare build/gut_lca.npz
    for r in build/parent . . build/parent; do python3 tools/lca_ab.py $r build/gut_lca.npz; done

Prints one JSON line: each gut batch's [Q, H, ms] and their sum, each
edge set's (seed 0, H = 8 .. 2048) [H, Q, ms], the launch floor, all
under ``chip_smoke.cuda_ms``, and the card's name and power limit.
"""

import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prepare(out: str) -> int:
    sys.path.insert(0, REPO)
    import numpy as np

    import chip_smoke
    from hymet_tpu_torch.io.paf import parse_paf_for_classification
    from hymet_tpu_torch.models.weighted_lca import lca_inputs, load_hierarchy_vectors, taxid_weights
    from hymet_tpu_torch.pipeline.run import ClassificationRun
    from hymet_tpu_torch.taxonomy.idmap import IdentifierMap

    with tempfile.TemporaryDirectory(prefix="lca_ab_") as tmp:
        cfg = chip_smoke.run_config(tmp)
        run = ClassificationRun(cfg, device="cuda")
        run.execute()
        (key,) = os.listdir(cfg.cache_root)
        taxonomy = os.path.join(cfg.cache_root, key, "detailed_taxonomy.tsv")
        qmap, counts = parse_paf_for_classification(os.path.join(cfg.outdir, "work", "resultados.paf"))
        tw = taxid_weights(qmap, counts, IdentifierMap.from_detailed_taxonomy(taxonomy))
        table, _names, batches = lca_inputs(tw, load_hierarchy_vectors(run._hierarchy_path()))
    arrays = {"rank_table": table}
    for i, (_q, rows, weights) in enumerate(batches):
        arrays[f"rows{i}"], arrays[f"weights{i}"] = rows, weights
    np.savez(out, **arrays)
    print(json.dumps({"prepared": out, "batches": [list(r.shape) for _q, r, _w in batches]}))
    return 0


def time_checkout(root: str, path: str) -> int:
    root = os.path.abspath(root)
    sys.path[:0] = [root, REPO]
    import numpy as np
    import torch

    import chip_smoke
    from hymet_tpu_torch.ops import lca

    if not os.path.dirname(lca.__file__).startswith(root):
        raise SystemExit(f"imported {lca.__file__}, not the checkout at {root}")
    data = np.load(path)
    table = torch.from_numpy(data["rank_table"]).cuda()
    n = sum(1 for k in data.files if k.startswith("rows"))
    gut = [(torch.from_numpy(data[f"rows{i}"]).cuda(), torch.from_numpy(data[f"weights{i}"]).cuda())
           for i in range(n)]
    sets = [(torch.from_numpy(r).cuda(), torch.from_numpy(w).cuda(), torch.from_numpy(t).cuda())
            for _name, r, w, t in chip_smoke.lca_edge_sets(0, big_q=16)]
    for rows, w, tab in [(r, w, table) for r, w in gut] + sets:
        chip_smoke.check_equal(f"lca {tuple(rows.shape)}", lca.weighted_lca(rows, w, tab),
                               lca.weighted_lca_torch(rows, w, tab))
    per_batch = [[*rows.shape, chip_smoke.cuda_ms(lambda: lca.weighted_lca(rows, w, table))]
                 for rows, w in gut]
    per_set = [[rows.shape[1], rows.shape[0], chip_smoke.cuda_ms(lambda: lca.weighted_lca(rows, w, tab))]
               for rows, w, tab in sets]
    one = torch.zeros(1, device="cuda")
    floor = chip_smoke.cuda_ms(lambda: one.add_(1))
    print(json.dumps({"checkout": root, "gut_batches": per_batch,
                      "gut_ms": sum(b[-1] for b in per_batch), "edge_sets": per_set,
                      "launch_floor_ms": floor, "identical": True,
                      "nvidia_smi": chip_smoke.nvidia_smi("name,power.limit")}))
    return 0


def main() -> int:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        print("lca_ab: no CUDA device visible", file=sys.stderr)
        return 1
    if sys.argv[1] == "prepare":
        return prepare(sys.argv[2])
    return time_checkout(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
    sys.exit(main())
