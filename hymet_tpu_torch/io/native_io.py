"""ctypes bindings for the native host helpers (counterpart of
hymet_tpu.io.native_io), built from the port's own
``csrc/host/hymetio.cpp``.

They serve the port's CPU path only (``device="cpu"``,
``HYMET_PLATFORM=cpu``): the index build's minimizers
(:mod:`hymet_tpu_torch.io.minimizer_index`), the DB build's k-mer hashes
(:func:`hymet_tpu_torch.ops.hashing.kmer_hashes_host`) and
:func:`hymet_tpu_torch.io.fasta.read_fasta_codes`. The card's paths keep
their CUDA kernels.

The library builds at first use with the host compiler (``c++ -O3
-std=c++17 -fPIC -shared``) into ``build/hymet_tpu_torch/host/<sha1>/``
beside the package, keyed by the source, the flags and the machine;
``HYMET_BUILD_NATIVE=0`` loads only a library already built. Where there
is none, callers take the numpy versions: go through :func:`available`,
which logs the fallback once, never assume the library exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger("hymet_tpu_torch.native_io")

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "hymetio.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
BUILD_TIMEOUT_S = 120

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _compiler() -> Optional[str]:
    return shutil.which("c++") or shutil.which("g++")


def library_path() -> Path:
    """Where this source's library lives (built or not)."""
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join((*CXX_FLAGS, platform.machine())).encode())
    return _PKG.parent / "build" / "hymet_tpu_torch" / "host" / digest.hexdigest() / "libhymetio.so"


def build(quiet: bool = True) -> bool:
    """Compile the library into :func:`library_path` (atomically: a
    concurrent loader sees all of it or nothing). Returns success."""
    so = library_path()
    cxx = _compiler()
    if cxx is None:
        return False
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=quiet, timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.hymet_encode.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p]
    lib.hymet_encode.restype = None
    lib.hymet_kmer_hashes.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_uint64)]
    lib.hymet_kmer_hashes.restype = ctypes.c_int64
    lib.hymet_minimizers.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int8)]
    lib.hymet_minimizers.restype = ctypes.c_int64
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    if not so.exists() and os.environ.get("HYMET_BUILD_NATIVE", "1") == "1":
        build()
    try:
        _LIB = _bind(ctypes.CDLL(str(so)))
    except OSError as e:
        logger.warning("native host helpers unavailable (%s); the CPU paths use numpy", e)
        _LIB = None
    return _LIB


def available() -> bool:
    """Whether the library loaded: the CPU paths then use it."""
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def encode_seq(seq: bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A=0 C=1 G=2 T=3, other=4)."""
    out = np.empty(len(seq), dtype=np.uint8)
    _load().hymet_encode(seq, len(seq), _ptr(out, ctypes.c_uint8))
    return out


def kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64 Mash hashes (seed 42) of every valid canonical k-mer, 1 <= k
    <= 32 (none outside that range)."""
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    out = np.empty(n - k + 1, dtype=np.uint64)
    n_out = _load().hymet_kmer_hashes(_ptr(codes, ctypes.c_uint8), n, k,
                                      _ptr(out, ctypes.c_uint64))
    return out[:n_out]


def minimizers(codes: np.ndarray, k: int, w: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hashes uint64, positions int32, strands int8) of the minimizers,
    1 <= k <= 31 (none outside that range)."""
    n = codes.shape[0]
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    cap = max(n, 1)
    out_h = np.empty(cap, dtype=np.uint64)
    out_pos = np.empty(cap, dtype=np.int32)
    out_strand = np.empty(cap, dtype=np.int8)
    n_out = _load().hymet_minimizers(_ptr(codes, ctypes.c_uint8), n, k, w,
                                     _ptr(out_h, ctypes.c_uint64), _ptr(out_pos, ctypes.c_int32),
                                     _ptr(out_strand, ctypes.c_int8))
    return out_h[:n_out].copy(), out_pos[:n_out].copy(), out_strand[:n_out].copy()


def read_fasta_codes(path: str) -> Tuple[List[str], List[np.ndarray]]:
    """(names, code arrays) of a FASTA file, encoded by the library."""
    from hymet_tpu_torch.io.fasta import iter_fasta

    names: List[str] = []
    codes: List[np.ndarray] = []
    for name, seq in iter_fasta(path):
        names.append(name)
        codes.append(encode_seq(seq))
    return names, codes
