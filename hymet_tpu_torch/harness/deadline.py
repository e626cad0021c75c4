"""Hard-deadline guarantee for the port's bench (counterpart of
hymet_tpu.harness.deadline): one JSON line, always.

``python -m hymet_tpu_torch.bench`` prints one JSON line on stdout, and a
bench that is killed or stalls must still print it:

- an **absolute wall-clock deadline** (``BENCH_DEADLINE_S``, default
  2700 s) fixed when the bench arms it (``_BENCH_DEADLINE_EPOCH``);
- a **watchdog subprocess** (this file run by path, so it imports neither
  torch nor the package) that fires at ``deadline - margin``: it prints
  the best measurement recorded so far (or a zero-value skeleton) as the
  one JSON line, with a ``"degraded"`` field naming what was missing,
  then SIGKILLs the bench and its registered children. A separate
  *process* is the only shape that survives a wedge of the bench that
  holds the interpreter lock (a thread or a SIGALRM handler needs it);
- **partial-result checkpoints**: the bench records its best-so-far
  number into a status file as runs complete (the warm run, each timed
  run), so a deadline line is a real, if less converged, measurement
  whenever any run finished.

The watchdog also rescues *crashes*: if the bench dies without marking
the status file done, the watchdog prints the degraded line at once, so
even an uncaught exception yields a parseable record.

Protocol (single-print guarantee): the bench marks ``done`` in the
status file BEFORE printing its own line, and the watchdog re-reads the
file and stays silent once ``done`` is set; the watchdog SIGKILLs the
bench before printing its line. The race window between the two orders
is microseconds against a >= 30 s margin.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

ENV_EPOCH = "_BENCH_DEADLINE_EPOCH"
ENV_STATUS = "_BENCH_STATUS_FILE"
ENV_WATCHDOG = "_BENCH_WATCHDOG_PID"

# Default deadline: 45 min, as in the JAX bench. Firing early costs a
# degraded line only where the alternative was an empty record.
DEFAULT_DEADLINE_S = 2700.0
MARGIN_S = 60.0

SKELETONS = {
    "pipeline": ("pipeline_contigs_per_s", "contigs/s"),
    "warm_pipeline": ("pipeline_warmup_s", "s"),
    "sketch": ("sketch_query_Gbp_per_s", "Gbp/s"),
    "sketch_stages": ("sketch_stages_full_s_per_batch", "s"),
    "sketch_large": ("sketch_largeF_Gbp_per_s", "Gbp/s"),
    "align": ("align_query_Gbp_per_s", "Gbp/s"),
    "align_stages": ("align_stages_full_s_per_batch", "s"),
}


def skeleton(mode: str) -> dict:
    metric, unit = SKELETONS.get(mode, SKELETONS["pipeline"])
    return {"metric": metric, "value": 0.0, "unit": unit, "vs_baseline": 0.0}


def _read_status(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _write_status(path: str, status: dict) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(status, f)
    os.replace(tmp, path)


def degraded_line(status: dict, mode: str) -> dict:
    """The JSON object the watchdog prints: the best partial result if
    any stage completed, else a zero-value skeleton; always carries a
    ``degraded`` field naming what the number is missing."""
    result = status.get("result") or skeleton(mode)
    result = dict(result)
    result["degraded"] = status.get("degraded") or "deadline_no_measurement"
    return result


# ---------------------------------------------------------------------
# parent-side API (imported by bench.py)


def arm(mode: str, cache_dir: str) -> None:
    """Fix the deadline epoch and spawn the watchdog (both idempotent: a
    second call in a process, or in a child that inherits the
    environment, arms nothing new).

    ``BENCH_DEADLINE_S=0`` disables the whole mechanism (for callers that
    bound the run with a ``timeout`` of their own)."""
    budget = float(os.environ.get("BENCH_DEADLINE_S", str(DEFAULT_DEADLINE_S)))
    if budget <= 0:
        return
    if ENV_EPOCH not in os.environ:
        os.environ[ENV_EPOCH] = str(time.time() + budget)
    epoch = os.environ[ENV_EPOCH]
    if ENV_STATUS not in os.environ:
        os.makedirs(cache_dir, exist_ok=True)
        os.environ[ENV_STATUS] = os.path.join(
            cache_dir, f"bench_status_{os.getpid()}.json"
        )
        _write_status(os.environ[ENV_STATUS], {"done": False})
    if ENV_WATCHDOG not in os.environ:
        # Lifeline pipe: parent-death detection must work while the
        # parent is an unreaped zombie (os.kill(pid, 0) still succeeds
        # then). The kernel closes a terminated process's fds before
        # reaping, so EOF on this pipe is the reliable death signal.
        # The write end stays open in this process only: a child started
        # with Popen's default close_fds=True does not hold it.
        lifeline_r, lifeline_w = os.pipe()
        proc = subprocess.Popen(
            [
                sys.executable,
                os.path.abspath(__file__),
                str(os.getpid()),
                os.environ[ENV_STATUS],
                epoch,
                str(MARGIN_S),
                mode,
                str(lifeline_r),
            ],
            stdout=sys.stdout,  # the watchdog's line IS the bench output
            stderr=sys.stderr,
            pass_fds=(lifeline_r,),
            # survive parent SIGKILL: no process-group tie needed; the
            # watchdog exits on its own once it observes the parent gone
        )
        os.close(lifeline_r)
        os.environ[ENV_WATCHDOG] = str(proc.pid)


def remaining_s(default: float = float("inf")) -> float:
    epoch = os.environ.get(ENV_EPOCH)
    if not epoch:
        return default
    return float(epoch) - time.time()


def report_partial(result: dict, degraded: str) -> None:
    """Record the best-so-far measurement; the watchdog prints it (plus
    the ``degraded`` tag) if the deadline fires before `finish`."""
    path = os.environ.get(ENV_STATUS)
    if not path:
        return
    status = _read_status(path)
    status.update(result=result, degraded=degraded)
    _write_status(path, status)


def register_child(pid: int | None) -> None:
    """Tell the watchdog about a live child that holds the card, so a
    deadline kill takes the whole tree."""
    path = os.environ.get(ENV_STATUS)
    if not path:
        return
    status = _read_status(path)
    children = [c for c in status.get("children", []) if c != pid]
    if pid is not None:
        children.append(pid)
    status["children"] = children
    _write_status(path, status)


def unregister_child(pid: int) -> None:
    path = os.environ.get(ENV_STATUS)
    if not path:
        return
    status = _read_status(path)
    status["children"] = [c for c in status.get("children", []) if c != pid]
    _write_status(path, status)


def finish() -> None:
    """Mark the run complete and retire the watchdog. Call BEFORE
    printing the final line (the watchdog stays silent once done)."""
    path = os.environ.get(ENV_STATUS)
    if path:
        status = _read_status(path)
        status["done"] = True
        _write_status(path, status)
    pid = os.environ.get(ENV_WATCHDOG)
    if pid:
        try:
            os.kill(int(pid), signal.SIGKILL)
        except OSError:
            pass


# ---------------------------------------------------------------------
# watchdog process


def watch_step(now: float, epoch: float, margin: float, parent_alive: bool,
               status: dict) -> str:
    """Pure decision table for one watchdog poll (unit-tested).

    Returns one of: "sleep", "exit_quiet", "print_and_exit",
    "kill_print_exit"."""
    if status.get("done"):
        return "exit_quiet"
    if not parent_alive:
        # crashed without printing: rescue the record immediately
        return "print_and_exit"
    if now >= epoch - margin:
        return "kill_print_exit"
    return "sleep"


def _lifeline_wait(fd: int, wait_s: float) -> bool:
    """Block up to ``wait_s`` on the lifeline; True while the parent
    lives (no EOF). Doubles as the watchdog's poll sleep."""
    import select

    readable, _, _ = select.select([fd], [], [], wait_s)
    if not readable:
        return True
    return len(os.read(fd, 1)) > 0  # nothing is ever written: b'' == death


def _watchdog_main(pid: int, status_path: str, epoch: float, margin: float,
                   mode: str, lifeline_fd: int) -> None:
    alive = True
    while True:
        status = _read_status(status_path)
        action = watch_step(time.time(), epoch, margin, alive, status)
        if action == "sleep":
            alive = _lifeline_wait(
                lifeline_fd, min(5.0, max(0.2, epoch - margin - time.time()))
            )
            continue
        if action == "exit_quiet":
            return
        if action == "kill_print_exit":
            for child in status.get("children", []):
                try:
                    os.kill(int(child), signal.SIGKILL)
                except OSError:
                    pass
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
            # the bench may have marked done in the kill race — re-read
            status = _read_status(status_path)
            if status.get("done"):
                return
        print(json.dumps(degraded_line(status, mode)), flush=True)
        return


if __name__ == "__main__":
    _pid, _path, _epoch, _margin, _mode, _fd = sys.argv[1:7]
    _watchdog_main(
        int(_pid), _path, float(_epoch), float(_margin), _mode, int(_fd)
    )
