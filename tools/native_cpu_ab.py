#!/usr/bin/env python3
"""What the native host helpers (hymet_tpu_torch.io.native_io) change on
the port's CPU path (device="cpu"): the seconds of a CPU DB build of the
first N in-repo genomes and of ClassificationRun.execute on the first M
gut contigs (cold cache, RunConfig defaults otherwise), each with the
library and without it (then the index build takes numpy's minimizers and
the DB build the plain sketch_codes), in the order with, without, without,
with. Every output must be the same with and without.

    python3 tools/native_cpu_ab.py [--genomes 20] [--contigs 60] [--threads 4]

Run from the root of the repository (it reads validation/work_cami_suite).
Prints one JSON line: each run's seconds, the run's stage split, and the
library's build seconds.
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hymet_tpu_torch.io import native_io  # noqa: E402
from hymet_tpu_torch.io.fasta import read_fasta  # noqa: E402
from hymet_tpu_torch.io.sketchdb import build_sketch_db  # noqa: E402
from hymet_tpu_torch.pipeline.run import ClassificationRun  # noqa: E402
from hymet_tpu_torch.utils.config import RunConfig  # noqa: E402

WORLD = os.path.join("validation", "work_cami_suite")
RUN_FILES = ("work/selected_genomes.txt", "work/resultados.paf", "classified_sequences.tsv")


def use_library(on: bool) -> None:
    native_io._LIB, native_io._TRIED = None, False
    if on:
        assert native_io.available(), "the native helpers did not build"
    else:
        native_io._TRIED = True


def db_build(files):
    t = time.perf_counter()
    db = build_sketch_db(files, device="cpu")
    return time.perf_counter() - t, (db.names, db.hashes, db.n_hashes, db.lengths)


def execute(contigs: str, tmp: str):
    cfg = RunConfig(
        input_fasta=contigs, outdir=os.path.join(tmp, "run"),
        cache_root=os.path.join(tmp, "cache"), taxonomy_dir=os.path.join(WORLD, "taxonomy"),
        sketch_dbs=[os.path.join(WORLD, f"sketch{i}.npz") for i in (1, 2, 3)],
        genome_catalog=os.path.join(WORLD, "genomes"),
        seqid2taxid=os.path.join(WORLD, "acc2taxid.tsv"))
    run = ClassificationRun(cfg, device="cpu")
    t = time.perf_counter()
    run.execute()
    seconds = time.perf_counter() - t
    files = {}
    for name in RUN_FILES:
        with open(os.path.join(cfg.outdir, name), "rb") as f:
            files[name] = f.read()
    return seconds, dict(run.timings), files


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", type=int, default=20)
    ap.add_argument("--contigs", type=int, default=60)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    t = time.perf_counter()
    assert native_io.build()
    build_s = time.perf_counter() - t
    files = sorted(glob.glob(os.path.join(WORLD, "genomes", "*", "*")))[: args.genomes]
    out = {"library_build_s": build_s, "genomes": len(files), "contigs": args.contigs,
           "threads": args.threads, "db_build_s": {"with": [], "without": []},
           "execute_s": {"with": [], "without": []}, "stages": {"with": [], "without": []}}
    with tempfile.TemporaryDirectory() as tmp:
        names, seqs = read_fasta(os.path.join(WORLD, "data", "camisyn_gut", "contigs.fna"))
        contigs = os.path.join(tmp, "contigs.fna")
        with open(contigs, "w") as f:
            for name, seq in zip(names[: args.contigs], seqs[: args.contigs]):
                f.write(f">{name}\n{seq.decode()}\n")
        dbs, runs = {}, {}
        for i, mode in enumerate(("with", "without", "without", "with")):
            use_library(mode == "with")
            seconds, dbs[mode] = db_build(files)
            out["db_build_s"][mode].append(seconds)
            seconds, stages, runs[mode] = execute(contigs, os.path.join(tmp, f"r{i}"))
            out["execute_s"][mode].append(seconds)
            out["stages"][mode].append(stages)
        a, b = dbs["with"], dbs["without"]
        assert a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:])), \
            "the DB builds differ"
        assert runs["with"] == runs["without"], "the runs' files differ"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
