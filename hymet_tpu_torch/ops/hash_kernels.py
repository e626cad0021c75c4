"""Hand-written CUDA kernels of the screen, their wrappers and plain versions.

Counterpart of ``hymet_tpu/ops/pallas_kernels.py``:

- :func:`screen_count` (``csrc/screen_count.cu``) — the screen's main
  path: one staged batch, 2-bit packed, unpacked, hashed, filtered and
  counted in one kernel;
- :func:`kmer_hashes` (``csrc/kmer_hash.cu``) — the hash of every window
  of a code batch, the direct counterpart of ``kmer_hashes_pallas``: the
  bench's sketch DB build runs it
  (:func:`~hymet_tpu_torch.ops.sketch.sketch_batch_topk`); the run's DB
  build hashes inside
  :func:`~hymet_tpu_torch.ops.sketch_kernels.sketch_codes`.

Both build on ``csrc/kmer_core.cuh``, as does the DB build's bottom-s
sketch (:mod:`hymet_tpu_torch.ops.sketch_kernels`). The align stage's
kernels (:mod:`hymet_tpu_torch.ops.align_kernels`), the weighted LCA
(:mod:`hymet_tpu_torch.ops.lca`) and the sketch live in the same library.
The ``.cu`` sources are compiled at first use — never at import — one nvcc a
source, all started together (the build runs inside chip_smoke.py's time
limit, and side by side it takes about the time of the slowest source),
and linked into one shared library with a plain C interface, bound with
``ctypes``. The build lands in
``build/hymet_tpu_torch/<sha1>/`` beside the package, keyed by all sources
(the header included) and flags, so an edited source builds anew.

A wrapper takes its kernel's plain PyTorch version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises. A build or
launch that fails raises :class:`KernelError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from hymet_tpu_torch.ops.hashing import SIGN, kmer_hashes_torch, unpack_code_batch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
SOURCES = (
    _CSRC / "kmer_core.cuh", _CSRC / "scan.cuh", _CSRC / "kmer_hash.cu", _CSRC / "screen_count.cu",
    _CSRC / "minimizers.cu", _CSRC / "anchors.cu", _CSRC / "chains.cu", _CSRC / "lca.cu",
    _CSRC / "bottom_sketch.cu",
)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 180

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch. Callers that
    tolerate a failing stage (the first-hit fallback) let it through."""


class KernelLibrary:
    """The built shared library, with the build's time and nvcc's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_s: float, log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s
        self.log = log
        for fn, argtypes in (
            (lib.kmer_hash_launch, [_P, _P, _P, _I, _I, _I, _I, _P]),
            (lib.screen_count_launch, [_P, _P, _I, _I, _I, _I, _I, _P, _I, _LL, _P, _P, _I, _P]),
            (lib.minimizers_launch,
             [_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _LL, _P, _P, _P, _P, _P]),
            (lib.anchors_launch,
             [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
              _I, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]),
            (lib.chains_launch, [_P, _P, _P, _LL, _I, _I, _I, _I, _P, _P, _P, _P, _P, _LL, _P, _P]),
            (lib.lca_launch, [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P]),
            (lib.bottom_sketch_launch,
             [_P, _P, _I, _LL, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P]),
            (lib.sketch_codes_launch,
             [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P]),
        ):
            fn.argtypes = argtypes
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
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build_dir() -> Path:
    digest = hashlib.sha1()
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _PKG.parent / "build" / "hymet_tpu_torch" / digest.hexdigest()


def _run_all(cmds, deadline: float) -> str:
    """Run the commands side by side; their joined output. Raises with a
    failing command's output, or when `deadline` (time.monotonic()) passes;
    leaves no command running."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    try:
        outs = [p.communicate(timeout=max(0.0, deadline - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelError(f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _build(out_dir: Path, so: Path, link_flags=()) -> str:
    """One nvcc a source, all started together, then one link into `so`
    (with `link_flags`: tools/profile_loss.py links with ``-cudart
    shared``), all within NVCC_TIMEOUT_S; returns nvcc's output. The
    objects live in a directory of their own, removed whether the build
    succeeds or not."""
    deadline = time.monotonic() + NVCC_TIMEOUT_S
    work = Path(tempfile.mkdtemp(prefix="build", dir=out_dir))
    try:
        cus = [src for src in SOURCES if src.suffix == ".cu"]
        objs = [work / f"{src.stem}.o" for src in cus]
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(cus, objs)], deadline)
        tmp = work / so.name
        log += _run_all([[_nvcc(), *ARCH_FLAGS, *link_flags, "-shared", "-o", str(tmp),
                          *map(str, objs)]],
                        deadline)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return log


def load_library() -> KernelLibrary:
    """Build (if these sources' library is not there yet) and load the
    kernels. Raises :class:`KernelError`, with nvcc's output, if the build
    or the load fails."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    out_dir = _build_dir()
    so = out_dir / "libhymet_kernels.so"
    build_s, log = 0.0, ""
    try:
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            log = _build(out_dir, so)
            build_s = time.perf_counter() - t0
        _LIBRARY = KernelLibrary(ctypes.CDLL(str(so)), so, build_s, log)
    except (OSError, AttributeError, subprocess.SubprocessError) as e:
        raise KernelError(f"kernel library {so}: {e}") from e
    return _LIBRARY


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        fn = getattr(load_library().lib, f"{name}_launch")
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelError(f"{name} launch failed with CUDA error {rc}")


def _vec(*tensors, width: int) -> int:
    """1 if every row of `width` bytes may be read 16 bytes at a time."""
    return int(width % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check_device(name: str, *tensors) -> str:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: unsupported devices {[str(t.device) for t in tensors]}")
    return "cuda"


def kmer_hashes(codes: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] uint8 codes -> (hash int64 [B, L-k+1], valid bool [B, L-k+1]).

    Same function as :func:`hymet_tpu_torch.ops.hashing.kmer_hashes_torch`.
    A CUDA tensor goes to the hand-written kernel (counted in
    ``kmer_hashes.launches``); a CPU tensor goes to the plain version."""
    if _check_device("kmer_hashes", codes) == "cpu":
        return kmer_hashes_torch(codes, k)
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
    if L >= 2**31:
        raise ValueError(f"kmer_hashes: L must be below 2^31, got {L}")
    n = L - k + 1
    hash_ = torch.empty((B, n), dtype=torch.int64, device=codes.device)
    valid = torch.empty((B, n), dtype=torch.bool, device=codes.device)
    _launch("kmer_hash", codes.device, codes.data_ptr(), hash_.data_ptr(),
            valid.data_ptr(), B, L, k, _vec(codes, width=L))
    kmer_hashes.launches += 1
    return hash_, valid


kmer_hashes.launches = 0


def screen_count_torch(
    packed: torch.Tensor, mask: torch.Tensor, L: int, k: int,
    flat: torch.Tensor, t: int, counts: torch.Tensor, total: torch.Tensor,
) -> None:
    """Plain version of :func:`screen_count`: unpack, hash every window,
    keep the valid windows whose key ``q = hash ^ SIGN`` is <= `t`, look
    them up in `flat` and add 1 to `counts` at each exact hit; add the
    number of valid windows to `total`. Updates `counts` and `total` in
    place, on whatever device they lie."""
    h, valid = kmer_hashes_torch(unpack_code_batch(packed, mask, L), k)
    count_hashes(h, valid, flat, t, counts, total)


def count_hashes(
    h: torch.Tensor, valid: torch.Tensor, flat: torch.Tensor, t: int,
    counts: torch.Tensor, total: torch.Tensor,
) -> None:
    """The count step of :func:`screen_count_torch` on window hashes
    already made: add the valid windows to `total`, and 1 to
    ``counts[pos]`` for each valid key ``hash ^ SIGN <= t`` equal to
    ``flat[pos]``."""
    valid = valid.reshape(-1)
    total += valid.sum()
    q = h.reshape(-1) ^ SIGN
    q = q[valid & (q <= t)]
    pos = torch.searchsorted(flat, q).clamp_(max=flat.shape[0] - 1)
    pos = pos[flat[pos] == q]
    counts.index_add_(0, pos, torch.ones_like(pos, dtype=torch.int32))


def screen_count(
    packed: torch.Tensor, mask: torch.Tensor, L: int, k: int,
    flat: torch.Tensor, t: int, counts: torch.Tensor, total: torch.Tensor,
) -> None:
    """Count one packed batch into the screen: for every window of the
    [B, L] rows (packed [B, W] 2-bit codes, mask [B, M] validity bits, as
    :func:`hymet_tpu_torch.io.fasta.pack_code_batch` makes them) whose k
    bases are valid, add 1 to `total` (int64, one element); if its key
    ``q = hash ^ SIGN`` is <= `t` and equals ``flat[pos]`` (sorted unique
    int64 keys [F]), add 1 to ``counts[pos]`` (int32 [F]).

    A CUDA batch goes to the hand-written kernel (counted in
    ``screen_count.launches``); a CPU batch goes to
    :func:`screen_count_torch`."""
    args = (packed, mask, flat, counts, total)
    if _check_device("screen_count", *args) == "cpu":
        return screen_count_torch(packed, mask, L, k, flat, t, counts, total)
    for name, x, dtype, dim in (
        ("packed", packed, torch.uint8, 2), ("mask", mask, torch.uint8, 2),
        ("flat", flat, torch.int64, 1), ("counts", counts, torch.int32, 1),
        ("total", total, torch.int64, None),
    ):
        if x.dtype != dtype or (dim is not None and x.dim() != dim):
            raise ValueError(f"screen_count: {name} must be {dtype} with {dim} dims, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"screen_count: {name} must be contiguous")
    B, W = packed.shape
    M = mask.shape[1]
    if mask.shape[0] != B or W != 2 * M:
        raise ValueError(f"screen_count: packed {tuple(packed.shape)} and mask "
                         f"{tuple(mask.shape)} do not describe one batch")
    if not 1 <= k <= 32:
        raise ValueError(f"screen_count: k must be in 1..32, got {k}")
    if not k <= L <= 8 * M:
        raise ValueError(f"screen_count: need k <= L <= {8 * M}, got L={L}, k={k}")
    if not 1 <= B <= 65535:
        raise ValueError(f"screen_count: B must be in 1..65535, got {B}")
    F = flat.shape[0]
    if not 1 <= F < 2**31 or counts.shape[0] != F or total.numel() != 1:
        raise ValueError(f"screen_count: need 1 <= F < 2^31 keys, counts [F] and one "
                         f"total, got {F}, {tuple(counts.shape)}, {tuple(total.shape)}")
    if L >= 2**31:
        raise ValueError(f"screen_count: L must be below 2^31, got {L}")
    _launch("screen_count", packed.device, packed.data_ptr(), mask.data_ptr(), B, W, M,
            L, k, flat.data_ptr(), F, int(t), counts.data_ptr(), total.data_ptr(),
            _vec(packed, mask, width=M))
    screen_count.launches += 1


screen_count.launches = 0
