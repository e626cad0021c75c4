"""Benchmark timing core (counterpart of hymet_tpu.harness.timing),
importable so its semantics are testable.

Two invariants that keep a bench's measurement honest live here:

- :func:`force_readback` — a timing ends with a device-to-host copy of
  result bytes: the kernels are launched through ctypes onto the current
  CUDA stream and return at once, and the copy waits for that stream;
- :func:`timed_groups` — the repeat/deadline protocol (at least one run,
  aim for ``min_runs``, never exceed ``max_runs`` or run past the budget
  once a result exists) in one place.

The JAX module's ``tag_fallback`` and ``warmup_reaction`` serve its CPU
fallback and its host-chain fallback; the port has neither.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch


def force_readback(out) -> None:
    """Copy the first element of the first tensor leaf of ``out`` (a
    tensor, or a tuple, list or dict of them) to the host.

    The copy is one element, so no transfer time is billed to the timed
    work; it waits for the stream the leaf's kernels went to."""
    leaf = _first_tensor(out)
    if leaf is None:
        raise ValueError("force_readback: no tensor in the result")
    leaf.reshape(-1)[:1].cpu()


def _first_tensor(out):
    """The first tensor of ``out`` in the JAX package's leaf order (a
    dict's values by sorted key), or None."""
    if torch.is_tensor(out):
        return out
    if isinstance(out, dict):
        out = [out[key] for key in sorted(out)]
    if isinstance(out, (tuple, list)):
        for item in out:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def timed_groups(
    run_group: Callable[[], object],
    *,
    min_runs: int,
    max_runs: int,
    budget_s: float,
    clock: Callable[[], float] = time.monotonic,
) -> List[Tuple[float, object]]:
    """Run ``run_group`` repeatedly; return [(seconds, result)] per run.

    Protocol: always at least one run; keep running toward ``min_runs``
    and opportunistically up to ``max_runs``, but stop as soon as the
    wall-clock budget is spent and at least one timing exists.
    ``run_group`` itself must force execution of the work it times (see
    :func:`force_readback`).
    """
    if min_runs < 1 or max_runs < min_runs:
        raise ValueError("need 1 <= min_runs <= max_runs")
    runs: List[Tuple[float, object]] = []
    deadline = clock() + budget_s
    while len(runs) < min_runs or (clock() < deadline and len(runs) < max_runs):
        if runs and clock() > deadline:
            break
        t0 = clock()
        out = run_group()
        runs.append((clock() - t0, out))
    return runs


def best_run(runs: List[Tuple[float, object]]) -> Tuple[float, object]:
    """(seconds, result) of the fastest run."""
    return min(runs, key=lambda r: r[0])


def spread_note(runs: List[Tuple[float, object]]) -> str:
    """Human summary quoting best / median / worst over n runs."""
    times = sorted(r[0] for r in runs)
    return (
        f"best {times[0]:.3f}s median {times[len(times) // 2]:.3f}s "
        f"worst {times[-1]:.3f}s over {len(times)} runs"
    )
