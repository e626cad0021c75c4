"""Hand-written CUDA kernels of the screen, and their wrappers.

Counterpart of ``hymet_tpu/ops/pallas_kernels.py``. The kernel
(``csrc/kmer_hash.cu``) is compiled by ``nvcc`` at first use — never at
import — into a shared library with a plain C interface, bound with
``ctypes``. The build lands in ``build/hymet_tpu_torch/<sha1>/`` beside
the package, keyed by the sources and flags, so an edited source builds
anew.

A wrapper takes its kernel's plain PyTorch version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from hymet_tpu_torch.ops.hashing import kmer_hashes_torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "kmer_hash.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 180


class KernelLibrary:
    """The built shared library, with the build's time and nvcc's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_s: float, log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s
        self.log = log
        fn = lib.kmer_hash_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int


_LIBRARY: Optional[KernelLibrary] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build_dir() -> Path:
    digest = hashlib.sha1()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _PKG.parent / "build" / "hymet_tpu_torch" / digest.hexdigest()


def load_library() -> KernelLibrary:
    """Build (if this source's library is not there yet) and load the
    kernels. Raises with nvcc's output if the build fails."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    out_dir = _build_dir()
    so = out_dir / "libhymet_kernels.so"
    build_s, log = 0.0, ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libhymet_kernels.so.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S
        )
        build_s = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    _LIBRARY = KernelLibrary(ctypes.CDLL(str(so)), so, build_s, log)
    return _LIBRARY


def kmer_hashes(codes: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] uint8 codes -> (hash int64 [B, L-k+1], valid bool [B, L-k+1]).

    Same function as :func:`hymet_tpu_torch.ops.hashing.kmer_hashes_torch`.
    A CUDA tensor goes to the hand-written kernel (counted in
    ``kmer_hashes.launches``); a CPU tensor goes to the plain version."""
    if codes.device.type == "cpu":
        return kmer_hashes_torch(codes, k)
    if codes.device.type != "cuda":
        raise ValueError(f"kmer_hashes: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(
            f"kmer_hashes: need a [B, L] uint8 tensor, got {codes.dtype} "
            f"{tuple(codes.shape)}"
        )
    if not codes.is_contiguous():
        raise ValueError("kmer_hashes: codes must be contiguous")
    if not 1 <= k <= 32:
        raise ValueError(f"kmer_hashes: k must be in 1..32, got {k}")
    B, L = codes.shape
    if L < k:
        raise ValueError(f"sequence shorter than k: L={L}, k={k}")
    if not 1 <= B <= 65535:
        raise ValueError(f"kmer_hashes: B must be in 1..65535, got {B}")
    n = L - k + 1
    hash_ = torch.empty((B, n), dtype=torch.int64, device=codes.device)
    valid = torch.empty((B, n), dtype=torch.bool, device=codes.device)
    lib = load_library().lib
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.kmer_hash_launch(
            codes.data_ptr(), hash_.data_ptr(), valid.data_ptr(), B, L, k, stream
        )
    if rc != 0:
        raise RuntimeError(f"kmer_hash_launch failed with CUDA error {rc}")
    kmer_hashes.launches += 1
    return hash_, valid


kmer_hashes.launches = 0
