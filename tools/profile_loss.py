#!/usr/bin/env python3
"""How many of the port's kernel launches torch.profiler records, on one
CUDA card: a lone loop of one kernel under the profiler, for each way of
linking the kernel library against CUDA's runtime.

    python3 tools/profile_loss.py [--traces 10] [--calls 8] [--cudart static shared]

Run from the root of this repository (it reads the gut contigs of
validation/work_cami_suite). For each ``--cudart`` choice the kernel
library is linked anew (``nvcc -cudart <choice>``, into
``build/hymet_tpu_torch/profile_loss/<choice>/``) and a child process of
its own loads it and traces, for each of ``minimizers`` (staged gut batch
0, the run's k and w), ``screen_count`` (the same batch against 65,536
random keys) and ``kmer_hashes`` ([8, 1 Mbp] random codes, k = 21), in
three modes:

- ``loop``: ``--calls`` launches back to back, a synchronize, the end of
  the trace;
- ``paused``: each launch in its own ``record_function`` span with 2 ms of
  host sleep after it;
- ``settled``: as ``loop``, then 0.2 s of host sleep inside the trace
  after the synchronize;
- ``padded``: as ``loop``, with 20 ms of host sleep at both ends of the
  trace;
- ``preroll``: as ``loop``, after a synchronize, one small torch kernel
  and a synchronize inside the trace;
- ``hook``: the launches as one stage of ``ClassificationRun`` under
  ``HYMET_PROFILE`` (its ``_profiled``: the lead, the closing
  synchronize), read from the trace file it writes.

Prints one JSON line per choice, kernel and mode: the calls a trace, the
kernels each of ``--traces`` traces shows, each trace's skew (the least
start of a device record less the start of the runtime call that
launched it, matched by correlation id, in us: below 0, the trace's
device timestamps lie before their launches), whether CUPTI asked for an
activity buffer inside the trace, each lost launch's start from the
trace's start, and which ``libcudart`` files the child's process maps.
The first trace of each kind that lost a launch is written, gzipped,
under ``--out`` (default ``build/profile_loss/``).
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from hymet_tpu_torch.io.fasta import read_fasta  # noqa: E402
from hymet_tpu_torch.ops import align_kernels, hash_kernels  # noqa: E402
from hymet_tpu_torch.pipeline.run import ClassificationRun  # noqa: E402
from hymet_tpu_torch.pipeline.staged import StagedContigs  # noqa: E402
from hymet_tpu_torch.utils.config import RunConfig  # noqa: E402

CONTIGS = REPO / "validation" / "work_cami_suite" / "data" / "camisyn_gut" / "contigs.fna"
OUT = REPO / "build" / "profile_loss"
KERNEL_NAMES = {"minimizers": "minimizer_tile_kernel", "screen_count": "screen_count_kernel",
                "kmer_hashes": "kmer_hash_kernel"}
MODES = ("loop", "paused", "settled", "padded", "preroll", "hook")
PAUSE_S = 0.002
SETTLE_S = 0.2
PAD_S = 0.02


def build(cudart: str) -> Path:
    """The kernel library linked with ``-cudart <cudart>``."""
    out = REPO / "build" / "hymet_tpu_torch" / "profile_loss" / cudart
    so = out / "libhymet_kernels.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        hash_kernels._build(out, so, link_flags=("-cudart", cudart))
    return so


def cudart_maps() -> list:
    with open("/proc/self/maps") as f:
        return sorted({ln.split()[-1] for ln in f if "cudart" in ln})


def launchers(cfg: RunConfig):
    """kernel name -> a function that launches it once."""
    names, seqs = read_fasta(str(CONTIGS))
    staged = StagedContigs(names, seqs, cfg.align_batch_pad, cfg.align_k + cfg.align_w,
                           device="cuda")
    packed, mask, B, L = staged.device[0]
    k, w = cfg.align_k, cfg.align_w
    cap = B * (L - k - w + 2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat = torch.randint(-2**62, 2**62, (65536,), device="cuda", generator=gen).unique()
    counts = torch.zeros(flat.shape[0], dtype=torch.int32, device="cuda")
    total = torch.zeros(1, dtype=torch.int64, device="cuda")
    codes = torch.randint(0, 4, (8, 1 << 20), dtype=torch.uint8, device="cuda", generator=gen)
    return {
        "minimizers": lambda: align_kernels.minimizers(packed, mask, L, k, w, cap),
        "screen_count": lambda: hash_kernels.screen_count(packed, mask, L, 21, flat, 2**62,
                                                          counts, total),
        "kmer_hashes": lambda: hash_kernels.kmer_hashes(codes, 21),
    }


def trace(fn, calls: int, mode: str):
    """One trace of `calls` launches in `mode`: the profile."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if mode == "padded":
            time.sleep(PAD_S)
        elif mode == "preroll":
            torch.cuda.synchronize()
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        for i in range(calls):
            if mode == "paused":
                with record_function(f"call{i}"):
                    fn()
                    time.sleep(PAUSE_S)
            else:
                fn()
        torch.cuda.synchronize()
        if mode == "settled":
            time.sleep(SETTLE_S)
        elif mode == "padded":
            time.sleep(PAD_S)
    return prof


def hook_trace(fn, calls: int) -> list:
    """One trace of `calls` launches through ClassificationRun's own
    HYMET_PROFILE hook (its lead and its closing synchronize): the
    events of the trace it writes."""
    with tempfile.TemporaryDirectory() as tmp:
        run = ClassificationRun(RunConfig(outdir=tmp), device="cuda")
        run._profiled("loop", tmp, lambda: [fn() for _ in range(calls)])
        (path,) = glob.glob(os.path.join(tmp, "plugins", "profile", "*", "*.trace.json.gz"))
        with gzip.open(path, "rt") as f:
            return json.load(f)["traceEvents"]


def chrome_events(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def read(events: list, kernel: str) -> dict:
    """What a trace shows: the kernel's records (`traced`); the skew, the
    least start of a device record less the start of the runtime call
    that launched it (matched by correlation, us; below 0: the record
    lies before its launch); whether CUPTI asked for an activity buffer
    in the window; and, of each runtime launch without a device record,
    its start from the window's start (us)."""
    spans = [e for e in events if e.get("ph") == "X"]
    (window,) = [e for e in spans if e.get("cat") == "Trace"]
    runtime = {e["args"]["correlation"]: e for e in spans if e.get("cat") == "cuda_runtime"
               and e["name"].startswith(("cudaLaunchKernel", "cudaMemsetAsync"))}
    device = [e for e in spans if e.get("cat") in ("kernel", "gpu_memset")]
    shown = {e["args"]["correlation"] for e in device}
    skews = [e["ts"] - runtime[e["args"]["correlation"]]["ts"] for e in device
             if e["args"]["correlation"] in runtime]
    return {"traced": sum(kernel in e["name"] for e in device),
            "skew_us": round(min(skews), 1) if skews else None,
            "buffer_request": any(e["name"] == "Activity Buffer Request" for e in spans),
            "lost_at_us": sorted(round(r["ts"] - window["ts"], 1) for c, r in runtime.items()
                                 if c not in shown)}


def child(so: str, traces: int, calls: int, modes) -> int:
    t_child = time.perf_counter()
    torch.zeros(1, device="cuda")
    hash_kernels._LIBRARY = hash_kernels.KernelLibrary(ctypes.CDLL(so), Path(so), 0.0, "")
    fns = launchers(RunConfig())
    for fn in fns.values():  # load, warm up
        fn()
    torch.cuda.synchronize()
    maps = cudart_maps()
    for name, fn in fns.items():
        kernel = KERNEL_NAMES[name]
        for mode in modes:
            rows, saved = [], False
            for t in range(traces):
                at = time.perf_counter() - t_child
                if mode == "hook":
                    events = hook_trace(fn, calls)
                else:
                    events = chrome_events(trace(fn, calls, mode))
                row = read(events, kernel)
                row["at_s"] = round(at, 2)
                rows.append(row)
                if row["traced"] < calls and not saved:
                    OUT.mkdir(parents=True, exist_ok=True)
                    path = OUT / f"{Path(so).parent.name}_{name}_{mode}_{t}.json.gz"
                    with gzip.open(path, "wt") as g:
                        json.dump({"traceEvents": events}, g)
                    saved = True
            print(json.dumps({
                "cudart": Path(so).parent.name, "kernel": name, "mode": mode, "calls": calls,
                "traced": [r["traced"] for r in rows],
                "whole_traces": sum(r["traced"] == calls for r in rows),
                "skew_us": [r["skew_us"] for r in rows],
                "buffer_request": [int(r["buffer_request"]) for r in rows],
                "lost_at_us": [r["lost_at_us"] for r in rows if r["lost_at_us"]],
                "at_s": [rows[0]["at_s"], rows[-1]["at_s"]],
                "libcudart_mapped": maps}), flush=True)
    return 0


def stage_rows(outdir: str, per_stage: dict, stages: dict) -> list:
    """For each stage trace of a HYMET_PROFILE run: the wrappers' launches
    and the kernels the trace shows (`stages`: stage -> wrapper -> kernel
    name), the device records and runtime calls it holds, the runtime
    calls without a device record (how many; the first's and the last's
    start from the trace's start, us), the least and largest device start
    less launch start (us), and the trace's length (us)."""
    rows = []
    root = os.path.join(outdir, "logs", "profile")
    for stage in sorted(os.listdir(root)):
        (path,) = glob.glob(os.path.join(root, stage, "plugins", "profile", "*", "*.trace.json.gz"))
        with gzip.open(path, "rt") as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X"]
        (window,) = [e for e in spans if e.get("cat") == "Trace"]
        runtime = {e["args"]["correlation"]: e for e in spans if e.get("cat") == "cuda_runtime"
                   and e["name"].startswith(("cudaLaunch", "cudaMemcpy", "cudaMemset"))}
        device = [e for e in spans if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
        shown = {e["args"]["correlation"] for e in device}
        skews = [e["ts"] - runtime[e["args"]["correlation"]]["ts"] for e in device
                 if e["args"]["correlation"] in runtime]
        lost_calls = sorted((r["ts"] - window["ts"], r["name"]) for c, r in runtime.items()
                            if c not in shown)
        lost = [t for t, _name in lost_calls]
        (span,) = [e for e in spans
                   if e.get("cat") == "user_annotation" and e["name"] == f"stage {stage}"]
        in_stage = sum(r["ts"] >= span["ts"] for c, r in runtime.items() if c not in shown)
        launched = {w: per_stage.get(stage, {}).get(w, 0) for w in stages.get(stage, {})}
        traced = {w: sum(k in e["name"] for e in device) for w, k in stages.get(stage, {}).items()}
        rows.append({"stage": stage, "launched": launched, "traced": traced,
                     "device": len(device), "runtime": len(runtime), "lost": len(lost),
                     "lost_from_us": [round(x, 1) for x in lost[:1] + lost[-1:]],
                     "lost_names": [name for _t, name in lost_calls[:4]],
                     "lost_in_stage": in_stage,
                     "skew_us": [round(min(skews), 1), round(max(skews), 1)] if skews else None,
                     "trace_us": round(window["dur"], 1), "path": path})
    return rows


def profiled_runs(n: int) -> int:
    """`n` runs of chip_smoke's gut ClassificationRun.execute under
    HYMET_PROFILE=1 (the first with a cold cache, the rest on its cache),
    each stage's launches read around it; one JSON line a run, and each
    stage trace that lacks a launch copied under OUT."""
    from unittest import mock

    import chip_smoke as cs

    tmp = tempfile.mkdtemp(prefix="profile_loss_")
    timed = ClassificationRun._timed
    per_stage = {}

    def counted(self, name, fn):
        before = cs.all_launches()
        try:
            return timed(self, name, fn)
        finally:
            after = cs.all_launches()
            per_stage[name] = {k: v - before[k] for k, v in after.items() if v != before[k]}

    bad = 0
    for i in range(n):
        cfg = cs.run_config(tmp)
        cfg.outdir = os.path.join(tmp, f"run{i}")
        per_stage.clear()
        with mock.patch.dict(os.environ, {"HYMET_PROFILE": "1"}), \
                mock.patch.object(ClassificationRun, "_timed", counted):
            t = time.perf_counter()
            ClassificationRun(cfg, device="cuda").execute()
            run_s = time.perf_counter() - t
        rows = stage_rows(cfg.outdir, per_stage, cs.PROFILE_STAGES)
        for row in rows:
            path = row.pop("path")
            if row["launched"] != row["traced"]:
                bad += 1
                OUT.mkdir(parents=True, exist_ok=True)
                shutil.copy(path, OUT / f"run{i}_{row['stage']}.trace.json.gz")
        print(json.dumps({"run": i, "execute_s": round(run_s, 3), "stages": rows}), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"runs": n, "stage_traces_short": bad}), flush=True)
    return 0


def main() -> int:
    global OUT
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=10)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--cudart", nargs="+", default=["static", "shared"])
    ap.add_argument("--modes", nargs="+", default=list(MODES), choices=MODES)
    ap.add_argument("--runs", type=int, default=0,
                    help="instead of the lone loops: this many profiled gut runs")
    ap.add_argument("--out", type=Path, default=OUT,
                    help="where lossy traces are written (default build/profile_loss/)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    OUT = args.out.resolve()
    if not torch.cuda.is_available():
        print("profile_loss: no CUDA device visible", file=sys.stderr)
        return 1
    if args.child:
        return child(args.child, args.traces, args.calls, args.modes)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "cuda": torch.version.cuda, "nvidia_smi": subprocess.run(
                          ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()}), flush=True)
    if args.runs:
        return profiled_runs(args.runs)
    t = time.perf_counter()
    libs = {c: build(c) for c in args.cudart}
    print(json.dumps({"build_s": time.perf_counter() - t,
                      "needed": {c: subprocess.run(["ldd", str(so)], capture_output=True,
                                                   text=True).stdout.split("\n")
                                 for c, so in libs.items()}}), flush=True)
    rc = 0
    for c, so in libs.items():
        rc |= subprocess.run([sys.executable, __file__, "--child", str(so), "--traces",
                              str(args.traces), "--calls", str(args.calls),
                              "--modes", *args.modes, "--out", str(OUT)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
