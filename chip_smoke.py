#!/usr/bin/env python3
"""Smoke run of hymet_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line with its seconds:

1. device  — requires CUDA; the card's name and power limit.
2. build   — nvcc builds the hand-written kernels from the checkout's
             sources; prints ptxas's registers, shared memory and spills.
3. kernel  — every kernel against its plain PyTorch version on the card,
             bit for bit, at the chunked screen's shape, at edge lengths
             and on each batch of the staged gut screen; the kernel's
             time, the plain version's time and the kernel's bound, at the
             chunk shape and summed over one staged screen.
4. slice   — contigs -> staged upload -> sketch screen -> candidate limit
             on the in-repo synthetic CAMI world (validation/work_cami_suite:
             sketch1-3 and the camisyn_gut contigs), three times: with the
             kernel, with the plain hash, and through the chunked path.
             All screen files must be byte-identical across the three, and
             the kernel must have been launched on the staged and chunked runs.
             Then one more staged screen under torch.profiler.
5. scale   — the same screen against a RefSeq-sized merged DB: sketch1-3
             plus 100,000 synthetic references x 1000 hashes made on the
             card from --seed (1e8 flat hashes); median of 3 screen-stage
             runs, the kernel's share of it, peak device memory, and one
             profiled run (device busy time and idle share).

Then the card's name and power limit as nvidia-smi prints them, one JSON
line with the kernels' numbers, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
Outputs go to a temporary directory outside the repository.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hymet_tpu_torch.io.fasta import read_fasta
from hymet_tpu_torch.io.sketchdb import SketchDB, load_sketch_db
from hymet_tpu_torch.ops import hash_kernels
from hymet_tpu_torch.ops.hashing import kmer_hashes_torch, unpack_code_batch
from hymet_tpu_torch.ops.sketch import flat_index_device
from hymet_tpu_torch.pipeline.candidates import limit_candidates_files
from hymet_tpu_torch.pipeline.screen_stage import run_screen_stage
from hymet_tpu_torch.pipeline.staged import StagedContigs
from hymet_tpu_torch.utils.config import RunConfig

REPO = os.path.dirname(os.path.abspath(__file__))
WORLD = os.path.join(REPO, "validation", "work_cami_suite")
CONTIGS = os.path.join(WORLD, "data", "camisyn_gut", "contigs.fna")
DB_LABELS = ["sketch1", "sketch2", "sketch3"]

# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the float32 rate of
# the CUDA cores. The kernel's work is 64-bit integer work, for which the
# data sheet gives no rate; the float32 rate stands in for it and is an
# upper limit (a 64-bit multiply takes several 32-bit instructions), so
# the operations bound is optimistic.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# The screen's chunk shape (RunConfig.screen_chunk_bp rows, 8 at a time).
MAIN_B, MAIN_L, MAIN_K = 8, 1 << 20, 21


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3), **fields}), flush=True)


def hash_ops_per_window(k: int) -> int:
    """64-bit integer operations the hash needs per window, counted from
    the function rather than from this kernel's way of computing it: a
    rolling update of the forward word, the reverse-complement word and
    the invalid-base count, 12 (the kernel repacks every window from
    scratch instead, 8 per base); the canonical compare and select 2;
    per ASCII byte 5; per 16-byte Murmur block 24; the tail words 6 each;
    and the finalization 21."""
    nblocks, tail = divmod(k, 16)
    return 12 + 2 + 5 * k + 24 * nblocks + 6 * (tail > 8) + 6 * (tail > 0) + 21


def hash_bound_ms(shapes, k: int) -> tuple:
    """(least time in ms, what bounds it) for hashing [B, L] batches of
    the given shapes: each code read once, each hash (8 B) and valid flag
    (1 B) written once; the operations at the float32 CUDA-core rate."""
    n = sum(B * (L - k + 1) for B, L in shapes)
    t_bytes = (sum(B * L for B, L in shapes) + 9 * n) / PEAK_BYTES_S
    t_ops = n * hash_ops_per_window(k) / PEAK_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_run(fn) -> dict:
    """One run of fn() under torch.profiler: its wall time, the device's
    busy time (CUDA kernels and copies, all on one stream), the idle
    share, and the device activities that took longest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "top_device_ms": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top]}


def codes_with_n_runs(rng: np.random.Generator, B: int, L: int) -> np.ndarray:
    """Random ACGT codes with runs of N (code 4) and an N tail on row 0."""
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    for b in range(B):
        for _ in range(max(1, L // 50_000)):
            start = int(rng.integers(0, L))
            codes[b, start : start + int(rng.integers(1, 200))] = 4
    codes[0, -(L // 10 or 1) :] = 4
    return codes


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_kernel(codes: torch.Tensor, k: int) -> float:
    """Raise unless the kernel's hash and valid equal the plain version's
    bit for bit; returns the largest absolute difference (0.0)."""
    h, v = hash_kernels.kmer_hashes(codes, k)
    h_ref, v_ref = kmer_hashes_torch(codes, k)
    torch.cuda.synchronize()
    if not (torch.equal(h, h_ref) and torch.equal(v, v_ref)):
        raise AssertionError(f"kmer_hash kernel differs from the plain version at k={k}, shape={list(codes.shape)}")
    return float((h.double() - h_ref.double()).abs().max())


def phase_kernel(seed: int, cfg: RunConfig) -> dict:
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    cases = []
    max_err = 0.0
    for k in (15, 21, 32):
        for B, L in [(MAIN_B, MAIN_L), (2, k), (2, k + 1), (2, 2048 + 20), (2, 3 * 2048 + 7)]:
            codes = torch.from_numpy(codes_with_n_runs(rng, B, L)).cuda()
            max_err = max(max_err, check_kernel(codes, k))
            cases.append([k, B, L])
    codes = torch.from_numpy(codes_with_n_runs(rng, MAIN_B, MAIN_L)).cuda()
    ms = cuda_ms(lambda: hash_kernels.kmer_hashes(codes, MAIN_K))
    plain_ms = cuda_ms(lambda: kmer_hashes_torch(codes, MAIN_K), iters=20, warmup=1)
    bound_ms, bound_by = hash_bound_ms([(MAIN_B, MAIN_L)], MAIN_K)
    del codes
    # the staged screen's own batches (the main path's shapes): each one
    # checked bit for bit, and the kernel, the plain version and the
    # bound summed over one screen's launches
    staged = stage_contigs(cfg)
    k = load_world_dbs()[0].k
    shapes, screen = [], {"ms": 0.0, "plain_ms": 0.0}
    for packed, mask, _rows, L in staged.device:
        codes = unpack_code_batch(packed, mask, L)
        max_err = max(max_err, check_kernel(codes, k))
        shapes.append(list(codes.shape))
        cases.append([k, *codes.shape])
        screen["ms"] += cuda_ms(lambda: hash_kernels.kmer_hashes(codes, k), iters=5, warmup=1)
        screen["plain_ms"] += cuda_ms(lambda: kmer_hashes_torch(codes, k), iters=3, warmup=1)
    screen["bound_ms"], screen["bound_by"] = hash_bound_ms(shapes, k)
    emit("kernel", t0, name="kmer_hash", cases=cases, bit_identical=True,
         shape=[MAIN_B, MAIN_L], k=MAIN_K, ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
         staged_screen={"batches": shapes, **screen})
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "staged_ms_per_screen": screen["ms"]}


def limit_stage(workdir: str, cfg: RunConfig) -> int:
    """The candidate limit as ClassificationRun runs it: cap the union at
    cand_max, scored by every *_sorted.tab, and replace the list in place."""
    selected = os.path.join(workdir, "selected_genomes.txt")
    score_files = sorted(
        os.path.join(workdir, f) for f in os.listdir(workdir) if f.endswith("_sorted.tab")
    )
    limit_candidates_files(
        selected, selected + ".limited", score_files,
        max_candidates=cfg.cand_max, dedupe=cfg.species_dedup,
        assembly_dir=cfg.assembly_summary_dir,
    )
    os.replace(selected + ".limited", selected)
    with open(selected) as f:
        return sum(1 for _ in f)


def load_world_dbs() -> list:
    return [load_sketch_db(os.path.join(WORLD, f"{label}.npz")) for label in DB_LABELS]


def stage_contigs(cfg: RunConfig) -> StagedContigs:
    """The upload stage as ClassificationRun runs it (run.py:208-240)."""
    names, seqs = read_fasta(CONTIGS)
    return StagedContigs(names, seqs, cfg.align_batch_pad, cfg.align_k + cfg.align_w, device="cuda")


def screen(workdir: str, cfg: RunConfig, dbs, labels, staged, hash_fn=None):
    """The screen stage as ClassificationRun runs it (run.py:242-269)."""
    kw = {"hash_fn": hash_fn} if hash_fn is not None else {}
    return run_screen_stage(
        dbs, [CONTIGS], workdir, initial_threshold=cfg.mash_thresh, db_labels=labels,
        chunk_bp=cfg.screen_chunk_bp, staged=staged, device="cuda", **kw,
    )


def run_slice(workdir: str, cfg: RunConfig, staged: bool, hash_fn) -> dict:
    """contigs -> (staged upload) -> screen -> limit, in ClassificationRun's order."""
    times = {}
    t = time.perf_counter()
    batches = stage_contigs(cfg) if staged else None
    torch.cuda.synchronize()
    times["upload_s"] = time.perf_counter() - t
    t = time.perf_counter()
    screen(workdir, cfg, load_world_dbs(), DB_LABELS, batches, hash_fn)
    torch.cuda.synchronize()
    times["screen_s"] = time.perf_counter() - t
    t = time.perf_counter()
    times["selected"] = limit_stage(workdir, cfg)
    times["limit_s"] = time.perf_counter() - t
    return times


def screen_files(workdir: str) -> list:
    return sorted(f for f in os.listdir(workdir) if f.endswith(".tab") or f.endswith(".txt"))


def same_files(a: str, b: str, names) -> None:
    for name in names:
        if not filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False):
            raise AssertionError(f"{name} differs between {a} and {b}")


def phase_slice(tmp: str, cfg: RunConfig) -> tuple:
    t0 = time.perf_counter()
    runs = {}
    launches = {}
    for tag, staged, hash_fn in (
        ("kernel_staged", True, hash_kernels.kmer_hashes),
        ("plain_staged", True, kmer_hashes_torch),
        ("kernel_chunked", False, hash_kernels.kmer_hashes),
    ):
        hash_kernels.kmer_hashes.launches = 0
        runs[tag] = run_slice(os.path.join(tmp, tag), cfg, staged, hash_fn)
        launches[tag] = hash_kernels.kmer_hashes.launches
    ref = os.path.join(tmp, "kernel_staged")
    files = screen_files(ref)
    if len(files) != 4 * len(DB_LABELS) + 1:
        raise AssertionError(f"unexpected screen outputs: {files}")
    for tag in ("plain_staged", "kernel_chunked"):
        same_files(ref, os.path.join(tmp, tag), files)
    if launches["kernel_staged"] <= 0 or launches["kernel_chunked"] <= 0:
        raise AssertionError(f"kmer_hash kernel not launched on the slice: {launches}")
    if launches["plain_staged"] != 0:
        raise AssertionError("the plain run launched the kernel")
    selected = runs["kernel_staged"]["selected"]
    if selected <= 0:
        raise AssertionError("no genome selected")
    staged, dbs = stage_contigs(cfg), load_world_dbs()
    prof = profile_run(lambda: screen(os.path.join(tmp, "profiled"), cfg, dbs, DB_LABELS, staged))
    emit("slice", t0, files_identical=files, launches=launches, selected_genomes=selected,
         runs=runs, staged_screen_profile=prof)
    return ref, launches["kernel_staged"]


def synthetic_db(seed: int, n_refs: int = 100_000, s: int = 1000) -> SketchDB:
    """RefSeq-sized bottom sketches: per reference s sorted hashes drawn
    uniformly below 2^64 * 1000 / 5e6 (a 5 Mbp genome's bottom-1000
    threshold), made on the card from `seed`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    top = int(2**64 * 1000 / 5e6)
    h = torch.randint(0, top, (n_refs, s), generator=gen, device="cuda", dtype=torch.int64)
    hashes = torch.sort(h, dim=1).values.cpu().numpy().view(np.uint64)
    return SketchDB(
        k=21, sketch_size=s, hashes=hashes, n_hashes=np.full(n_refs, s, np.int32),
        names=[f"SYN_{i:06d}" for i in range(n_refs)],
        lengths=np.full(n_refs, 5_000_000, np.int64), comments=[""] * n_refs,
    )


def phase_scale(tmp: str, cfg: RunConfig, seed: int, small_ref: str, kernel_ms: float) -> None:
    """`kernel_ms`: the kernel's device time for one staged screen, its
    launches timed alone (phase 3)."""
    t0 = time.perf_counter()
    synth = synthetic_db(seed)
    dbs = load_world_dbs() + [synth]
    labels = DB_LABELS + ["synthetic"]
    F = int(flat_index_device(SketchDB.concat(dbs).hashes, torch.device("cuda"))[0].numel())
    staged = stage_contigs(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        out = os.path.join(tmp, f"scale{i}")
        t = time.perf_counter()
        screen(out, cfg, dbs, labels, staged)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        same_files(small_ref, out, [f"{label}_sorted.tab" for label in DB_LABELS])
    peak = torch.cuda.max_memory_allocated()
    prof = profile_run(lambda: screen(os.path.join(tmp, "scale_profiled"), cfg, dbs, labels, staged))
    median_s = statistics.median(times)
    emit("scale", t0, refs=sum(db.n_refs for db in dbs), flat_hashes=F,
         screen_s=times, screen_median_s=median_s, kernel_ms_per_screen=kernel_ms,
         kernel_share=kernel_ms / 1e3 / median_s, staged_batches=len(staged.device),
         max_memory_allocated=peak, sorted_tab_identical_to_slice=True, screen_profile=prof)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", t0, name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = hash_kernels.load_library()
    emit("build", t0, nvcc_s=lib.build_s, library=os.path.relpath(lib.path, REPO),
         ptxas=[ln.strip() for ln in lib.log.splitlines() if "ptxas" in ln or "spill" in ln])

    cfg = RunConfig()
    kernel = phase_kernel(args.seed, cfg)
    kernel_ms = kernel.pop("staged_ms_per_screen")
    tmp = tempfile.mkdtemp(prefix="hymet_chip_smoke_")
    try:
        small_ref, launches = phase_slice(tmp, cfg)
        phase_scale(tmp, cfg, args.seed, small_ref, kernel_ms)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "kmer_hash", "route": "cuda",
        "source": "hymet_tpu_torch/csrc/kmer_hash.cu",
        "replaces": "hymet_tpu/ops/pallas_kernels.py:35",
        "launches": launches, **kernel, "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
