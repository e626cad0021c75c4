"""Headline benchmark of the port (counterpart of the repository's
``bench.py``): END-TO-END pipeline throughput (contigs/s) on one card.

    python -m hymet_tpu_torch.bench          # BENCH_MODE=pipeline
    BENCH_MODE=sketch python -m hymet_tpu_torch.bench

Runs the port's FULL classification pipeline — sketch screen over 3 DBs,
adaptive-threshold candidate selection, species-dedup limiting, reference
build, minimizer alignment, weighted LCA, CAMI export — on a simulated
metagenomic assembly drawn from the Zymo panel genomes (``GENOME_GLOB``,
``REFS_TSV``), and prints ONE JSON line on stdout:

  {"metric": "pipeline_contigs_per_s", "value": ..., "unit": "contigs/s",
   "vs_baseline": ...}

Everything else goes to stderr. Modes (``BENCH_MODE``), each with the JAX
bench's metric, unit and baseline:

- ``pipeline`` (default): a warm run (reference cache, kernel build) then
  2-8 timed runs of ``ClassificationRun.execute``; contigs/s of the best.
- ``warm_pipeline``: one run; its seconds.
- ``sketch``: a DB of ``BENCH_REFS`` random references sketched through
  :func:`~hymet_tpu_torch.ops.sketch.sketch_batch_topk` (the ``kmer_hashes``
  kernel) and :func:`~hymet_tpu_torch.ops.sketch.finish_bottom_sketch`,
  then query Gbp/s of ``ScreenEngine.update_codes`` (``screen_count``) on
  batches staged on the card.
- ``sketch_stages``: ``kmer_hashes`` (``hash``) and ``screen_count``
  (``full``), each alone on one batch.
- ``sketch_large``: query Gbp/s against a flat DB of F = refs x sketch
  (10^8 by default).
- ``align``: aligner Gbp/s (``minimizers`` -> ``anchors`` -> ``chains``)
  of mutated slices of the panel's largest genome.
- ``align_stages``: ``minimizers`` (``extract``), ``anchors``
  (``anchor_sort``) and all three (``full``), each alone on one batch.

The JAX bench's stage modes time truncated prefixes of one fused XLA
program; the port's kernels are separate launches, so its stages are
the kernels themselves and the other JAX stages have no time of their
own. Not here, as they serve only the TPU: the dial retries and CPU
re-exec, the warm child, the compile-health probe, the align prewarm and
the CPU fallback's metric tag. The device is resolved once
(``HYMET_PLATFORM``: unset the card, which fails without one; ``cpu`` the
plain CPU path), and on the card the kernels are built before any mode
runs; a build failure is a crash.

Crash or deadline: the watchdog of :mod:`hymet_tpu_torch.harness.deadline`
(``BENCH_DEADLINE_S``, default 2700 s) prints the best partial result or a
zero-value line with a ``degraded`` field, so one JSON line always
appears. Caches (worlds, sketch DBs, status files) live under
``build/bench_cache_torch/`` beside the package.
"""

import csv
import glob
import json
import logging
import os
import shutil
import sys
import time
import traceback

import numpy as np
import torch

from hymet_tpu_torch.harness import deadline
from hymet_tpu_torch.harness.timing import best_run, force_readback, spread_note, timed_groups

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "bench_cache_torch")

# ---- pipeline mode config ----
PIPE_BASELINE_CONTIGS_PER_S = 1000.0 / 180.0  # reference's fastest (3 min)
N_CONTIGS = int(os.environ.get("BENCH_CONTIGS", "1000"))
N_GENOMES = int(os.environ.get("BENCH_GENOMES", "0"))  # 0 = all 24
SEED = int(os.environ.get("BENCH_SEED", "2024"))
MUT_RATE = 0.02
INDEL_RATE = 0.0005
GENOME_GLOB = "/root/reference/case/truth/zymo_refs/genomes/*/*.fna.gz"
REFS_TSV = "/root/reference/case/truth/zymo_refs/refs.tsv"

# ---- sketch mode config (round-1 metric) ----
SKETCH_BASELINE_GBP_S = 0.04
N_REFS = int(os.environ.get("BENCH_REFS", "32"))
REF_LEN = int(os.environ.get("BENCH_REF_LEN", str(2_000_000)))
BATCH_ROWS = int(os.environ.get("BENCH_BATCH_ROWS", "8"))
BATCH_LEN = int(os.environ.get("BENCH_BATCH_LEN", str(1 << 20)))
SKETCH_S = 1000

# ---- align mode config: rows x pad of the align mode's batches (the
# align_stages mode reads BENCH_ALIGN_ROWS / BENCH_ALIGN_PAD) ----
ALIGN_ROWS, ALIGN_PAD = 64, 1 << 16
ALIGN_BASELINE_GBP_S = 0.0056  # minimap2 -x asm10 ~1 Gbp / 3 CPU-min

# decimals of the stage modes' seconds: the JAX bench's 4 would round a
# batch's 0.1 ms on the card to 0.0001
STAGE_DIGITS = 7

# ---- sketch_large mode config ----
LARGE_F_REFS = int(os.environ.get("BENCH_LARGE_REFS", "100000"))
LARGE_F_SKETCH = int(os.environ.get("BENCH_LARGE_SKETCH", "1000"))


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _init_device() -> torch.device:
    """The device ``HYMET_PLATFORM`` names; on the card, the kernel library
    built (or loaded) before any mode runs."""
    from hymet_tpu_torch.ops.hash_kernels import load_library
    from hymet_tpu_torch.utils.device import device_from_env, resolve_device

    # stage-level INFO logs to stderr
    logging.basicConfig(
        level=logging.INFO,
        stream=sys.stderr,
        format="%(asctime)s %(name)s %(message)s",
        datefmt="%H:%M:%S",
    )
    dev = resolve_device(device_from_env())
    if dev.type == "cuda":
        t0 = time.time()
        lib = load_library()
        log(f"kernels: {lib.path.name} (nvcc {lib.build_s:.1f}s; ready in {time.time() - t0:.1f}s)")
        log(f"device: cuda {torch.cuda.get_device_name(dev)}")
    else:
        log("device: cpu (HYMET_PLATFORM=cpu)")
    return dev


# ----------------------------------------------------------------------
# pipeline mode


def _build_world(dev: torch.device) -> dict:
    """Zymo world (cached): 3 sketch DBs over the panel genomes, a
    simulated ~N_CONTIGS-contig assembly (2% SNPs, sparse indels, half
    reverse-complemented), truth table, taxonomy."""
    from hymet_tpu_torch.data.zymo_taxonomy import zymo_taxdb
    from hymet_tpu_torch.io.fasta import iter_fasta
    from hymet_tpu_torch.io.sketchdb import build_sketch_db

    world = os.path.join(CACHE, f"zymo_world_n{N_CONTIGS}_g{N_GENOMES}_s{SEED}")
    os.makedirs(world, exist_ok=True)
    genomes = sorted(glob.glob(GENOME_GLOB))
    if not genomes:
        raise SystemExit("reference Zymo genomes not found")

    acc2tax = {}
    with open(REFS_TSV) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            acc2tax[row["assembly_accession"]] = row["taxid"]
    s2t = os.path.join(world, "acc2taxid.tsv")
    if not os.path.exists(s2t):
        with open(s2t + ".tmp", "w") as f:
            for acc, tax in sorted(acc2tax.items()):
                f.write(f"{acc}\t{tax}\n")
        os.replace(s2t + ".tmp", s2t)

    tax_dir = os.path.join(world, "taxonomy")
    hier = os.path.join(tax_dir, "taxonomy_hierarchy.tsv")
    if not os.path.exists(hier):
        os.makedirs(tax_dir, exist_ok=True)
        zymo_taxdb().write_hierarchy_tsv(hier)

    db_paths = [os.path.join(world, f"sketch{i + 1}.npz") for i in range(3)]
    if not all(os.path.exists(p) for p in db_paths):
        t0 = time.time()
        for i, path in enumerate(db_paths):
            db = build_sketch_db(genomes[i::3], k=21, sketch_size=1000, device=dev)
            db.save(path)
        log(f"built 3 sketch DBs in {time.time() - t0:.1f}s")

    sample = os.path.join(world, "sample.fna")
    truth = os.path.join(world, "truth_contigs.tsv")
    if not (os.path.exists(sample) and os.path.exists(truth)):
        # A realistic assembly TILES each genome (near-full coverage), so
        # whole-sample containment identity stays above the 0.9 screen
        # threshold; sparse random fragments would under-cover large
        # genomes and get screened out, which no real assembly does.
        t0 = time.time()
        rng = np.random.default_rng(SEED)
        acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
        per_genome = {}
        for g in genomes[: N_GENOMES or None]:
            acc = "_".join(os.path.basename(g).split("_")[:2])
            seqs = [s for _, s in iter_fasta(g)]
            per_genome[acc] = max(seqs, key=len)
        accs = sorted(per_genome)
        total_ref_bp = sum(len(s) for s in per_genome.values())
        avg_len = max(5_000, total_ref_bp // max(N_CONTIGS, 1))
        comp = np.full(256, 78, dtype=np.uint8)
        comp[65], comp[67], comp[71], comp[84] = 84, 71, 67, 65
        i = 0
        with open(sample + ".tmp", "w") as sf, open(truth + ".tmp", "w") as tf:
            tf.write("contig_id\ttaxid\n")
            for acc in accs:
                src = np.frombuffer(per_genome[acc], dtype=np.uint8)
                pos = 0
                while pos < len(src):
                    length = int(rng.integers(avg_len // 2, avg_len * 3 // 2))
                    frag = src[pos : pos + length].copy()
                    pos += length
                    if len(frag) < 1_000:
                        continue
                    mut = rng.random(len(frag)) < MUT_RATE
                    frag[mut] = rng.choice(acgt, size=int(mut.sum()))
                    frag = frag[rng.random(len(frag)) >= INDEL_RATE]
                    if rng.random() < 0.5:
                        frag = comp[frag[::-1]]
                    sf.write(f">sim_ctg{i}\n{frag.tobytes().decode()}\n")
                    tf.write(f"sim_ctg{i}\t{acc2tax[acc]}\n")
                    i += 1
        os.replace(sample + ".tmp", sample)
        os.replace(truth + ".tmp", truth)
        log(f"simulated {i} tiled contigs in {time.time() - t0:.1f}s")

    total_bp = sum(len(s) for _, s in iter_fasta(sample))
    with open(truth) as f:
        n_contigs = sum(1 for _ in f) - 1
    return {
        "world": world,
        "sample": sample,
        "truth": truth,
        "tax_dir": tax_dir,
        "sketch_dbs": db_paths,
        "genome_dir": os.path.dirname(os.path.dirname(genomes[0])),
        "seqid2taxid": s2t,
        "total_bp": total_bp,
        "n_contigs": n_contigs,
    }


def _run_once(w: dict, outdir: str, cache_root: str, dev: torch.device):
    from hymet_tpu_torch.pipeline.run import ClassificationRun
    from hymet_tpu_torch.utils.config import RunConfig

    if os.path.exists(outdir):
        shutil.rmtree(outdir)
    cfg = RunConfig(
        input_fasta=w["sample"],
        outdir=outdir,
        cand_max=1500,
        species_dedup=True,
        cache_root=cache_root,
        taxonomy_dir=w["tax_dir"],
        sketch_dbs=w["sketch_dbs"],
        genome_catalog=w["genome_dir"],
        seqid2taxid=w["seqid2taxid"],
    )
    run = ClassificationRun(cfg, device=dev)
    t0 = time.time()
    classified = run.execute()
    return time.time() - t0, run.timings, classified


def _species_accuracy(w: dict, classified: str) -> float:
    """Fraction of truth contigs whose species name appears in the
    classified lineage (cheap gate that the timed pipeline is correct)."""
    from hymet_tpu_torch.data.zymo_taxonomy import zymo_taxdb

    taxdb = zymo_taxdb()
    truth = {}
    with open(w["truth"]) as f:
        next(f)
        for line in f:
            c, t = line.split("\t")
            truth[c] = t.strip()
    rows = {}
    with open(classified) as f:
        next(f)
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows[parts[0]] = parts[1]
    ok = 0
    for c, tid in truth.items():
        sp = taxdb.ancestor_at_rank(tid, "species")
        name = taxdb.name.get(sp or tid, "")
        if name and f"species:{name}" in rows.get(c, ""):
            ok += 1
    return ok / max(len(truth), 1)


def bench_warm_pipeline(dev: torch.device) -> dict:
    """One pipeline run on a fresh process (world and reference caches
    filled on the way); its seconds."""
    w = _build_world(dev)
    cache_root = os.path.join(w["world"], "cache")
    t0 = time.time()
    _, _, classified = _run_once(w, os.path.join(w["world"], "out_warmup"), cache_root, dev)
    acc = _species_accuracy(w, classified)
    log(f"warm run: {time.time() - t0:.1f}s, accuracy {acc * 100:.2f}%")
    return {
        "metric": "pipeline_warmup_s",
        "value": round(time.time() - t0, 1),
        "unit": "s",
        "vs_baseline": 0.0,
    }


def _report_pipeline_partial(w: dict, total_s: float, reason: str) -> None:
    """Checkpoint a best-so-far contigs/s so a deadline or crash still
    yields a real measurement (tagged via the ``degraded`` field)."""
    cps = w["n_contigs"] / total_s
    deadline.report_partial(
        {
            "metric": "pipeline_contigs_per_s",
            "value": round(cps, 2),
            "unit": "contigs/s",
            "vs_baseline": round(cps / PIPE_BASELINE_CONTIGS_PER_S, 2),
        },
        reason,
    )


def bench_pipeline(dev: torch.device) -> dict:
    w = _build_world(dev)
    log(f"sample: {w['n_contigs']} contigs, {w['total_bp'] / 1e6:.1f} Mbp")

    cache_root = os.path.join(w["world"], "cache")
    warm_s, warm_t, classified = _run_once(
        w, os.path.join(w["world"], "out_warmup"), cache_root, dev
    )
    log(
        f"warmup (reference-cache build) {warm_s:.1f}s; stages "
        + " ".join(f"{k}={v:.1f}s" for k, v in warm_t.items())
    )
    # the warm run is a complete, correct pipeline execution: record it
    # so the watchdog never has to print a zero
    _report_pipeline_partial(w, warm_s, "warmup_run_only")

    acc = _species_accuracy(w, classified)
    log(f"species accuracy gate: {acc * 100:.2f}%")
    if acc < 0.9:
        log("WARNING: accuracy below 90% — the speed number is suspect")

    best_sofar = [float("inf")]

    def _timed():
        total_s, timings, _ = _run_once(
            w, os.path.join(w["world"], "out_timed"), cache_root, dev
        )
        log(
            f"timed run: {total_s:.2f}s ("
            + " ".join(f"{k}={v:.2f}s" for k, v in timings.items())
            + ")"
        )
        if total_s < best_sofar[0]:
            best_sofar[0] = total_s
            _report_pipeline_partial(w, total_s, "partial_timed_runs")
        return total_s, timings

    budget_s = min(600.0, max(60.0, deadline.remaining_s(690.0) - 90.0))
    runs = timed_groups(_timed, min_runs=2, max_runs=8, budget_s=budget_s)
    # the pipeline times itself inside _run_once (excludes outdir cleanup)
    best, best_timings = best_run([r for _, r in runs])
    cps = w["n_contigs"] / best
    mbps = w["total_bp"] / best / 1e6
    log(f"runs: {spread_note([(r[0], None) for _, r in runs])}")
    log(
        f"best {best:.2f}s -> {cps:.1f} contigs/s ({mbps:.1f} Mbp/s); "
        f"stages: " + " ".join(f"{k}={v:.2f}s" for k, v in best_timings.items())
    )
    # the rate without the contig upload, reported beside the headline as
    # the JAX bench reports it
    upload_s = best_timings.get("upload", 0.0)
    cps_nolink = w["n_contigs"] / max(best - upload_s, 1e-9)
    log(f"link-excluded: {cps_nolink:.1f} contigs/s (upload {upload_s:.2f}s)")
    return {
        "metric": "pipeline_contigs_per_s",
        "value": round(cps, 2),
        "unit": "contigs/s",
        "vs_baseline": round(cps / PIPE_BASELINE_CONTIGS_PER_S, 2),
        "link_excluded_contigs_per_s": round(cps_nolink, 2),
        "link_excluded_vs_baseline": round(cps_nolink / PIPE_BASELINE_CONTIGS_PER_S, 2),
    }


# ----------------------------------------------------------------------
# sketch mode (round-1 headline, kept as a secondary metric)


def sketch_refs() -> np.ndarray:
    """The sketch mode's references: [N_REFS, REF_LEN] random codes."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 4, size=(N_REFS, REF_LEN), dtype=np.uint8)


def sketch_db_path() -> str:
    return os.path.join(CACHE, f"db_{N_REFS}x{REF_LEN}_s{SKETCH_S}.npz")


def bench_sketch(dev: torch.device) -> dict:
    from hymet_tpu_torch.io.sketchdb import PAD_HASH, SketchDB
    from hymet_tpu_torch.ops.sketch import ScreenEngine, finish_bottom_sketch, sketch_batch_topk

    t0 = time.time()
    refs = sketch_refs()
    log(f"generated {N_REFS}x{REF_LEN / 1e6:.1f} Mbp refs in {time.time() - t0:.1f}s")

    s = SKETCH_S
    cache = sketch_db_path()
    if os.path.exists(cache):
        db = SketchDB.load(cache)
        log(f"loaded cached sketch DB (F={db.flat_index()[0].shape[0]:,})")
    else:
        t0 = time.time()
        hashes = np.full((N_REFS, s), PAD_HASH, dtype=np.uint64)
        n_hashes = np.zeros(N_REFS, dtype=np.int32)
        rows_per_call = max(1, min(8, N_REFS))
        for base in range(0, N_REFS, rows_per_call):
            chunk = refs[base : base + rows_per_call]
            c_hi, c_lo = sketch_batch_topk(torch.from_numpy(chunk).to(dev), 21, 2 * s + 256)
            sk, nn = finish_bottom_sketch(c_hi.cpu().numpy(), c_lo.cpu().numpy(), s)
            hashes[base : base + chunk.shape[0]] = sk
            n_hashes[base : base + chunk.shape[0]] = nn
        db = SketchDB(
            k=21,
            sketch_size=s,
            hashes=hashes,
            n_hashes=n_hashes,
            names=[f"ref{i}" for i in range(N_REFS)],
            lengths=np.full(N_REFS, REF_LEN, dtype=np.int64),
            comments=[""] * N_REFS,
        )
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        db.save(cache)
        log(f"device-sketched DB in {time.time() - t0:.1f}s (F={db.flat_index()[0].shape[0]:,})")

    def make_batch(seed: int) -> np.ndarray:
        r = np.random.default_rng(seed)
        out = np.empty((BATCH_ROWS, BATCH_LEN), dtype=np.uint8)
        for i in range(BATCH_ROWS):
            src = refs[r.integers(0, N_REFS)]
            start = int(r.integers(0, REF_LEN - BATCH_LEN))
            sl = src[start : start + BATCH_LEN].copy()
            mut = r.random(BATCH_LEN) < 0.03
            sl[mut] = r.integers(0, 4, size=int(mut.sum()), dtype=np.uint8)
            out[i] = sl
        return out

    eng = ScreenEngine(db, dev, track_kmers=False)
    t0 = time.time()
    eng.update_codes(torch.from_numpy(make_batch(1)).to(dev))
    force_readback(eng.counts)
    eng.finalize()
    log(f"warmup {time.time() - t0:.1f}s")

    # steady-state timing on batches staged on the card beforehand
    batches = [torch.from_numpy(make_batch(2 + i)).to(dev) for i in range(4)]
    _sync(dev)

    def _group():
        for b in batches:
            eng.update_codes(b)
        force_readback(eng.counts)

    runs = timed_groups(_group, min_runs=6, max_runs=12, budget_s=180.0)
    best, _ = best_run(runs)
    bp_group = len(batches) * BATCH_ROWS * BATCH_LEN
    gbps = bp_group / best / 1e9
    log(f"groups: {spread_note(runs)} of {bp_group / 1e9:.3f} Gbp each")

    t0 = time.time()
    res = eng.finalize()
    log(f"finalize {time.time() - t0:.2f}s; top identity {res.identity.max():.4f}")
    return {
        "metric": "sketch_query_Gbp_per_s",
        "value": round(gbps, 4),
        "unit": "Gbp/s",
        "vs_baseline": round(gbps / SKETCH_BASELINE_GBP_S, 2),
    }


def _synthetic_db(R: int, s: int, rng: np.random.Generator):
    """R sketches of s hashes drawn as a 4 Mbp genome's bottom sketch
    would fall: uniform on [0, t) with t = s / 4e6 of the hash space (the
    JAX bench's realistic threshold, ~2.5e-4 at s = 1000)."""
    from hymet_tpu_torch.io.sketchdb import SketchDB

    genome_len = 4_000_000
    thresh = (1 << 64) * s // genome_len
    hashes = np.sort(rng.integers(0, thresh, size=(R, s), dtype=np.uint64), axis=1)
    return SketchDB(
        k=21,
        sketch_size=s,
        hashes=hashes,
        n_hashes=np.full(R, s, dtype=np.int32),
        names=[f"r{i}" for i in range(R)],
        lengths=np.full(R, genome_len, dtype=np.int64),
        comments=[""] * R,
    )


# ----------------------------------------------------------------------
# sketch_stages mode: the screen update's kernels, each alone on one
# batch: hash (kmer_hashes) and full (screen_count: unpack, hash,
# threshold, search and count in one launch)


def bench_sketch_stages(dev: torch.device) -> dict:
    from hymet_tpu_torch.io.fasta import pack_code_batch
    from hymet_tpu_torch.ops.hash_kernels import kmer_hashes
    from hymet_tpu_torch.ops.sketch import ScreenEngine

    rng = np.random.default_rng(0)
    db = _synthetic_db(N_REFS, SKETCH_S, rng)
    eng = ScreenEngine(db, dev, track_kmers=False)
    codes = rng.integers(0, 4, size=(BATCH_ROWS, BATCH_LEN), dtype=np.uint8)
    packed, mask, L = pack_code_batch(codes)
    codes_d = torch.from_numpy(codes).to(dev)
    packed_d, mask_d = torch.from_numpy(packed).to(dev), torch.from_numpy(mask).to(dev)
    _sync(dev)

    def _full():
        eng.update_staged(packed_d, mask_d, L)
        return eng.counts

    stages = (("hash", lambda: kmer_hashes(codes_d, db.k)), ("full", _full))
    best: dict = {}
    for name, fn in stages:
        t0 = time.time()
        force_readback(fn())
        log(f"stage {name}: warmup {time.time() - t0:.1f}s")
        runs = timed_groups(lambda: force_readback(fn()), min_runs=6, max_runs=6, budget_s=120.0)
        best[name], _ = best_run(runs)
        log(f"stage {name}: best {best[name]:.7f}s over {len(runs)}")
    log("the JAX bench's threshold and compact stages are fused into screen_count here: "
        "no separate time")
    log(f"marginal full: {best['full'] - best['hash']:+.7f}s over hash")
    bp = BATCH_ROWS * BATCH_LEN
    gbps = bp / best["full"] / 1e9
    return {
        "metric": "sketch_stages_full_s_per_batch",
        "value": round(best["full"], STAGE_DIGITS),
        "unit": f"s per {bp / 1e6:.1f} Mbp batch",
        "vs_baseline": round(gbps / SKETCH_BASELINE_GBP_S, 2),
    }


# ----------------------------------------------------------------------
# align mode: aligner-only throughput on real genome sequence


def _align_world(dev: torch.device):
    """Shared align-bench workload: the panel's index plus a
    mutated-fragment batch generator (2% SNPs over slices of the largest
    genome). bench_align and bench_align_stages measure the SAME input
    distribution, so both build it here."""
    from hymet_tpu_torch.io.fasta import encode_seq, iter_fasta
    from hymet_tpu_torch.io.minimizer_index import MinimizerIndex
    from hymet_tpu_torch.models.aligner import MinimizerAligner

    genomes = sorted(glob.glob(GENOME_GLOB))
    if not genomes:
        raise SystemExit("reference Zymo genomes not found")
    named = []
    for g in genomes:
        for n, s in iter_fasta(g):
            named.append((n.split()[0], s))
    t0 = time.time()
    index = MinimizerIndex.build(named, device=dev)
    total_bp = sum(len(s) for _, s in named)
    log(
        f"index {total_bp / 1e6:.1f} Mbp, {index.n_minimizers:,} minimizers "
        f"in {time.time() - t0:.1f}s"
    )
    aligner = MinimizerAligner(index, device=dev)
    src = np.frombuffer(max((s for _, s in named), key=len), np.uint8)

    def make_batch(seed: int, rows: int, pad: int) -> np.ndarray:
        r = np.random.default_rng(seed)
        b = np.full((rows, pad), 4, np.uint8)
        for i in range(rows):
            st = int(r.integers(0, len(src) - pad))
            frag = encode_seq(src[st : st + pad].tobytes()).copy()
            mut = r.random(frag.size) < 0.02
            frag[mut] = r.integers(0, 4, int(mut.sum()), dtype=np.uint8)
            b[i] = frag
        return b

    return index, aligner, make_batch


def bench_align(dev: torch.device) -> dict:
    index, aligner, make_batch = _align_world(dev)
    rows, pad = ALIGN_ROWS, ALIGN_PAD

    def batch(seed):
        return make_batch(seed, rows, pad)

    t0 = time.time()
    chains = aligner._chains_for_batch(batch(0))
    log(f"warmup {time.time() - t0:.1f}s; {len(chains)} chains")

    batches = [batch(1 + i) for i in range(3)]

    def _group():
        # dispatch-ahead like map_batch: every batch of the group is
        # enqueued before the first count copy, so the host's chain
        # builds overlap the card's work
        pend = [aligner._dispatch_batch(b) for b in batches]
        return sum(len(aligner._finish_batch(p)) for p in pend)

    runs = timed_groups(_group, min_runs=3, max_runs=8, budget_s=180.0)
    best, _ = best_run(runs)
    bp_group = len(batches) * rows * pad
    gbps = bp_group / best / 1e9
    log(
        f"groups: {spread_note(runs)} of {bp_group / 1e9:.4f} Gbp each; "
        f"last group chains={runs[-1][1]}"
    )
    return {
        "metric": "align_query_Gbp_per_s",
        "value": round(gbps, 4),
        "unit": "Gbp/s",
        "vs_baseline": round(gbps / ALIGN_BASELINE_GBP_S, 2),
    }


# ----------------------------------------------------------------------
# align_stages mode: the align kernels, each alone on one batch:
# extract (minimizers), anchor_sort (anchors: search, collect and sort in
# one kernel, on extract's output) and full (all three)


def bench_align_stages(dev: torch.device) -> dict:
    from hymet_tpu_torch.io.fasta import pack_code_batch

    index, aligner, make_batch = _align_world(dev)
    rows = int(os.environ.get("BENCH_ALIGN_ROWS", "64"))
    pad = int(os.environ.get("BENCH_ALIGN_PAD", str(1 << 16)))
    packed, mask, L = pack_code_batch(make_batch(1, rows, pad))
    batch = (torch.from_numpy(packed).to(dev), torch.from_numpy(mask).to(dev), rows, L)
    _sync(dev)

    NW, cap = aligner._minimizer_cap(rows, L)
    acap, ccap = aligner._device_caps(rows, NW, cap)
    cfg, ops = aligner.cfg, aligner.ops
    mz = ops.minimizers(batch[0], batch[1], L, index.k, index.w, cap)
    stages = (
        ("extract", lambda: ops.minimizers(batch[0], batch[1], L, index.k, index.w, cap)),
        ("anchor_sort", lambda: ops.anchors(*mz, aligner._tables, cfg.max_occ, cfg.band_bits,
                                            acap, rows, L)),
        ("full", lambda: aligner._dispatch_fused(batch, cap, acap, ccap)),
    )
    # force_readback fetches one element of the first output, so no
    # transfer time is billed to the stage with the biggest output
    best: dict = {}
    for name, fn in stages:
        t0 = time.time()
        force_readback(fn())
        log(f"stage {name}: warmup {time.time() - t0:.1f}s")
        runs = timed_groups(lambda: force_readback(fn()), min_runs=6, max_runs=6,
                            budget_s=120.0)
        best[name], _ = best_run(runs)
        log(f"stage {name}: best {best[name]:.7f}s over {len(runs)}")
    log("the JAX bench's min_compact, search and anchor_collect stages are fused into "
        "minimizers and anchors here: no separate time")
    bp = rows * pad
    return {
        "metric": "align_stages_full_s_per_batch",
        "value": round(best["full"], STAGE_DIGITS),
        "unit": f"s per {bp / 1e6:.1f} Mbp batch",
        "vs_baseline": round((bp / best["full"] / 1e9) / ALIGN_BASELINE_GBP_S, 2),
    }


# ----------------------------------------------------------------------
# sketch_large mode: F ~ 1e8 flat hashes (the ~45 GB RefSeq sketch-DB
# scale, reference bench/README.md:45): device memory sizing and the
# screen's count throughput at real DB size


def bench_sketch_large(dev: torch.device) -> dict:
    from hymet_tpu_torch.ops.sketch import ScreenEngine

    rng = np.random.default_rng(0)
    t0 = time.time()
    db = _synthetic_db(LARGE_F_REFS, LARGE_F_SKETCH, rng)
    eng = ScreenEngine(db, dev, track_kmers=False)
    F = eng.flat.shape[0]
    log(f"flat DB F={F:,} ({F * 8 / 1e9:.2f} GB of 64-bit hashes) in {time.time() - t0:.1f}s")

    t0 = time.time()
    eng.update_codes(torch.from_numpy(
        rng.integers(0, 4, size=(BATCH_ROWS, BATCH_LEN), dtype=np.uint8)).to(dev))
    force_readback(eng.counts)
    log(f"warmup {time.time() - t0:.1f}s")

    batches = [
        torch.from_numpy(rng.integers(0, 4, size=(BATCH_ROWS, BATCH_LEN), dtype=np.uint8)).to(dev)
        for _ in range(4)
    ]
    _sync(dev)

    def _group():
        for b in batches:
            eng.update_codes(b)
        force_readback(eng.counts)

    runs = timed_groups(_group, min_runs=4, max_runs=10, budget_s=180.0)
    best, _ = best_run(runs)
    bp_group = len(batches) * BATCH_ROWS * BATCH_LEN
    gbps = bp_group / best / 1e9
    log(f"groups: {spread_note(runs)} of {bp_group / 1e9:.3f} Gbp each (F={F:,})")
    t0 = time.time()
    res = eng.finalize()
    log(f"finalize {time.time() - t0:.2f}s; max shared {int(res.shared.max())}")
    return {
        "metric": "sketch_largeF_Gbp_per_s",
        "value": round(gbps, 4),
        "unit": "Gbp/s",
        "vs_baseline": round(gbps / SKETCH_BASELINE_GBP_S, 2),
    }


MODES = {
    "pipeline": bench_pipeline,
    "warm_pipeline": bench_warm_pipeline,
    "sketch": bench_sketch,
    "sketch_stages": bench_sketch_stages,
    "sketch_large": bench_sketch_large,
    "align": bench_align,
    "align_stages": bench_align_stages,
}


def main() -> None:
    os.makedirs(CACHE, exist_ok=True)
    mode = os.environ.get("BENCH_MODE", "pipeline")
    # hard-deadline watchdog (a separate process): prints the best partial
    # result and kills this process if the wall clock runs out
    deadline.arm(mode, CACHE)
    # the one-JSON-line stdout contract is absolute: route any stray
    # library prints to stderr while the benchmark body runs
    real_stdout = sys.stdout
    sys.stdout = sys.stderr
    try:
        dev = _init_device()
        result = MODES.get(mode, bench_pipeline)(dev)
    except Exception as e:
        sys.stdout = real_stdout
        # crash path: still print one parseable line (the best partial if
        # any run completed), then exit nonzero with the traceback on stderr
        traceback.print_exc(file=sys.stderr)
        status = deadline._read_status(os.environ.get(deadline.ENV_STATUS, ""))
        line = deadline.degraded_line(status, mode)
        if not status.get("result"):
            line["degraded"] = f"error:{type(e).__name__}"
        deadline.finish()
        print(json.dumps(line), flush=True)
        sys.exit(1)
    finally:
        sys.stdout = real_stdout
    deadline.finish()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
