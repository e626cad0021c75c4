#!/usr/bin/env python3
"""Where csrc/bottom_sketch.cu spends its time on the DB build's batches,
on one CUDA card.

    python3 tools/sketch_trace.py [--label sketch1]

Builds an instrumented copy of the kernel source (the committed source
with clock reads added by text replacement; it stops if the source no
longer has the lines it instruments) into ``build/trace/``, runs
``sketch_codes`` and the hash-input ``bottom_sketch`` on the in-repo DB's
batch (k = 21, s = 1000) through it, holds both to ``sketch_codes_torch``,
and prints, for each chunk index of a row averaged over the rows: when its
blocks started and how long they ran (the card's globaltimer, us), their
cycles, the cycles in folds and in the folds' sorts, the folds and the
survivors. Then the two kernels' device times from torch.profiler, with
the committed library. Needs nvcc (CUDA_HOME or /usr/local/cuda).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from hymet_tpu_torch.ops import hash_kernels as hk, sketch_kernels as sk  # noqa: E402

CSRC = os.path.join(REPO, "hymet_tpu_torch", "csrc")
STATS = 7  # start ns, end ns, cycles, fold cycles, sort cycles, folds, survivors
EDITS = [
    ("constexpr unsigned long long kSign = 0x8000000000000000ULL;",
     "constexpr unsigned long long kSign = 0x8000000000000000ULL;\n"
     f"__device__ unsigned long long g_stats[1 << 16][{STATS}];\n"
     "__shared__ long long s_sort_cycles;\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("    __syncthreads();\n    bitonic_sort(C, P);\n  }",
     "    __syncthreads();\n    const long long t0 = clock64();\n    bitonic_sort(C, P);\n"
     "    if (threadIdx.x == 0) s_sort_cycles += clock64() - t0;\n  }"),
    ("  int waiting = 0;  // survivors in cand, not yet folded\n",
     "  int waiting = 0;  // survivors in cand, not yet folded\n"
     "  if (tid == 0) s_sort_cycles = 0;\n"
     "  const unsigned long long t_start = gtime();\n"
     "  const long long c_start = clock64();\n"
     "  long long c_fold = 0, n_fold = 0, n_surv = 0;\n"),
    ("    if (waiting + c_new > kWave) {\n      fold(S, waiting, false);",
     "    n_surv += c_new;\n    if (waiting + c_new > kWave) {\n"
     "      const long long t0 = clock64();\n      fold(S, waiting, false);\n"
     "      c_fold += clock64() - t0;\n      ++n_fold;"),
    ("  if (waiting) {\n    fold(S, waiting, false);",
     "  if (waiting) {\n    const long long t0 = clock64();\n    fold(S, waiting, false);\n"
     "    c_fold += clock64() - t0;\n    ++n_fold;"),
    ("  if (tid == 0) counts[slot] = S.m;\n}",
     "  if (tid == 0) {\n    counts[slot] = S.m;\n"
     "    const unsigned long long v[] = {t_start, gtime(), (unsigned long long)(clock64() - c_start),\n"
     "        (unsigned long long)c_fold, (unsigned long long)s_sort_cycles,\n"
     "        (unsigned long long)n_fold, (unsigned long long)n_surv};\n"
     f"    for (int i = 0; i < {STATS}; ++i) g_stats[slot][i] = v[i];\n  }}\n}}"),
]


def build() -> ctypes.CDLL:
    src = open(os.path.join(CSRC, "bottom_sketch.cu")).read()
    for old, new in EDITS:
        if old not in src:
            raise SystemExit(f"csrc/bottom_sketch.cu no longer has:\n{old}")
        src = src.replace(old, new, 1)
    src += ('\nextern "C" int read_stats(void* dst, int n) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stats, n));\n}\n")
    out = os.path.join(REPO, "build", "trace")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "bottom_sketch_trace.cu"), os.path.join(out, "trace.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([hk._nvcc(), *hk.NVCC_FLAGS, "-shared", f"-I{CSRC}", "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bottom_sketch_launch.argtypes = [P, P, I, LL, P, P, I, I, I, I, I, P, P, P, P, P, P, P]
    lib.sketch_codes_launch.argtypes = [P, I, I, I, I, I, I, I, I, P, P, P, P, P, P, P]
    lib.read_stats.argtypes = [P, I]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="sketch1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sketch_trace: no CUDA device visible", file=sys.stderr)
        return 1
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    (codes,) = cs.build_batches(cs.db_files(args.label))
    g = torch.from_numpy(codes).cuda()
    h, v = hk.kmer_hashes(g, 21)
    want = sk.sketch_codes_torch(g, 21, 1000)
    prof = cs.profile_run(lambda: (sk.sketch_codes(g, 21, 1000), sk.bottom_sketch(h, v, 1000)),
                          counted=((sk.sketch_codes, "chunk_kernel<3>"),
                                   (sk.bottom_sketch, "chunk_kernel<0>")))
    print(json.dumps({"device_ms": prof["device_ms"]}), flush=True)
    lib = build()

    def launch(name, dev, *a):
        rc = getattr(lib, f"{name}_launch")(*a, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    sk._launch = launch
    B, n = g.shape[0], g.shape[1] - 20
    cpr = -(-n // sk.CHUNK)
    for name, fn in (("sketch_codes", lambda: sk.sketch_codes(g, 21, 1000)),
                     ("bottom_sketch", lambda: sk.bottom_sketch(h, v, 1000))):
        fn()
        cs.check_equal(name, fn(), want)
        buf = np.zeros((1 << 16, STATS), np.uint64)
        if lib.read_stats(buf.ctypes.data, buf.nbytes):
            raise RuntimeError("read_stats failed")
        st = buf[: B * cpr].astype(np.float64)
        start = (st[:, 0] - st[:, 0].min()) / 1e3
        end = (st[:, 1] - st[:, 0].min()) / 1e3
        chunk = np.arange(B * cpr) % cpr
        rows = []
        for c in range(cpr):
            m = chunk == c
            rows.append([c, round(start[m].mean(), 1), round((end[m] - start[m]).mean(), 1),
                         *(round(st[m, i].mean()) for i in (2, 3, 4)), round(st[m, 5].mean(), 2),
                         round(st[m, 6].mean())])
        print(json.dumps({"kernel": name, "span_us": round(end.max(), 1), "chunks": [
            ["chunk", "start_us", "us", "cycles", "fold_cycles", "sort_cycles", "folds",
             "survivors"], *rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
