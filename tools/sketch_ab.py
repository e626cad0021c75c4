#!/usr/bin/env python3
"""The DB build's kernels of one checkout of hymet_tpu_torch, on one CUDA
card: their device times on the in-repo DBs' batches (sketch1-3: three
batches of [78, 779,964] codes, k = 21, s = 1000) and each DB's build
seconds and peak device memory.

    python3 tools/sketch_ab.py <root of a checkout that holds hymet_tpu_torch>

Run from the root of this repository (it reads validation/work_cami_suite).
To hold a change against its parent on one card, unpack the parent into a
directory that .gitignore lists and run them in turns in one command:

    git archive HEAD~1 hymet_tpu_torch | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 tools/sketch_ab.py $r; done

Prints one JSON line: ``kmer_hash`` and ``bottom_sketch`` (on kmer_hash's
hashes) summed over the three batches and, where the checkout has it,
``sketch_codes`` (held to ``bottom_sketch``'s sketches bit for bit); each
build checked against the committed DB.
"""

import json
import math
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hymet_tpu_torch.io import sketchdb  # noqa: E402
from hymet_tpu_torch.io.fasta import encode_seq, iter_fasta  # noqa: E402
from hymet_tpu_torch.ops import hash_kernels as hk, sketch_kernels as sk  # noqa: E402

WORLD = os.path.join("validation", "work_cami_suite")


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls, as chip_smoke.cuda_ms
    times a kernel (the card sleeps first so that the host has enqueued
    the calls before they run)."""
    host_s = math.inf
    for _ in range(warmup):
        t = time.perf_counter()
        fn()
        host_s = min(host_s, time.perf_counter() - t)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(max(100_000, 2 * host_s * 2e9), 4_000_000)) * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("sketch_ab: no CUDA device visible", file=sys.stderr)
        return 1
    if not os.path.dirname(sk.__file__).startswith(root):
        raise SystemExit(f"imported {sk.__file__}, not the checkout at {root}")
    out = {"checkout": root, "ms": {}, "build_s": {}, "peak_bytes": {}}
    hk.load_library()
    for label in ("sketch1", "sketch2", "sketch3"):
        want = sketchdb.load_sketch_db(os.path.join(WORLD, f"{label}.npz"))
        files = [os.path.join(WORLD, "genomes", "_".join(n.split("_")[:2]), n) for n in want.names]
        rows = [sketchdb.genome_row([encode_seq(q) for _, q in iter_fasta(p)]) for p in files]
        for batch in sketchdb.code_batches(rows, 21, sketchdb.BUILD_WINDOWS["cuda"]):
            g = torch.from_numpy(sketchdb.pad_rows([rows[i] for i in batch])).cuda()
            h, v = hk.kmer_hashes(g, 21)
            times = {"kmer_hash": cuda_ms(lambda: hk.kmer_hashes(g, 21)),
                     "bottom_sketch": cuda_ms(lambda: sk.bottom_sketch(h, v, 1000))}
            if hasattr(sk, "sketch_codes"):
                got, ref = sk.sketch_codes(g, 21, 1000), sk.bottom_sketch(h, v, 1000)
                if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                    raise AssertionError(f"{label}: sketch_codes differs from bottom_sketch")
                times["sketch_codes"] = cuda_ms(lambda: sk.sketch_codes(g, 21, 1000))
            for k, ms in times.items():
                out["ms"][k] = out["ms"].get(k, 0.0) + ms
            del g, h, v
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        db = sketchdb.build_sketch_db(files, 21, 1000, device="cuda")
        out["build_s"][label] = time.perf_counter() - t
        out["peak_bytes"][label] = torch.cuda.max_memory_allocated() - base
        if not (np.array_equal(db.hashes, want.hashes) and np.array_equal(db.n_hashes, want.n_hashes)):
            raise AssertionError(f"{label}: the build differs from the committed DB")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
