"""Resource measurement: the ``lib/measure.sh`` replacement (copy of
hymet_tpu.harness.measure).

The reference wraps every run/eval stage with ``/usr/bin/time -v`` and
appends to ``out/runtime_memory.tsv`` with schema
``sample tool stage wall_seconds user_seconds sys_seconds max_rss_gb
io_input_mb io_output_mb`` (``bench/lib/measure.sh:46-102``,
``bench/lib/common.sh:55-58``). We measure in-process (resource.getrusage
+ /proc I/O counters) since stages run in-process rather than as
subprocesses; the TSV schema and units are identical so the reference's
plotting/aggregation consume it unchanged.
"""

from __future__ import annotations

import csv
import os
import resource
import time
from contextlib import contextmanager
from typing import Iterator, Optional

HEADER = [
    "sample",
    "tool",
    "stage",
    "wall_seconds",
    "user_seconds",
    "sys_seconds",
    "max_rss_gb",
    "io_input_mb",
    "io_output_mb",
]


def _read_proc_io() -> tuple:
    try:
        with open("/proc/self/io") as f:
            vals = dict(
                line.strip().split(": ", 1) for line in f if ": " in line
            )
        return int(vals.get("read_bytes", 0)), int(vals.get("write_bytes", 0))
    except OSError:
        return 0, 0


def append_runtime_header(path: str) -> None:
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        f.write("\t".join(HEADER) + "\n")


def append_row(
    path: str,
    sample: str,
    tool: str,
    stage: str,
    wall: float,
    user: float,
    sys_t: float,
    rss_gb: float,
    io_in_mb: float,
    io_out_mb: float,
) -> None:
    append_runtime_header(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(
            [
                sample,
                tool,
                stage,
                f"{wall:.3f}",
                f"{user:.3f}",
                f"{sys_t:.3f}",
                f"{rss_gb:.3f}",
                f"{io_in_mb:.3f}",
                f"{io_out_mb:.3f}",
            ]
        )


@contextmanager
def measured(
    out_file: str, sample: str, tool: str, stage: str = "overall"
) -> Iterator[None]:
    """Measure the enclosed block and append a runtime_memory.tsv row."""
    t_wall = time.time()
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    c0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    io_r0, io_w0 = _read_proc_io()
    try:
        yield
    finally:
        wall = time.time() - t_wall
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        c1 = resource.getrusage(resource.RUSAGE_CHILDREN)
        io_r1, io_w1 = _read_proc_io()
        user = (r1.ru_utime - r0.ru_utime) + (c1.ru_utime - c0.ru_utime)
        sys_t = (r1.ru_stime - r0.ru_stime) + (c1.ru_stime - c0.ru_stime)
        # ru_maxrss is KB on Linux
        rss_gb = max(r1.ru_maxrss, c1.ru_maxrss) / (1024.0 * 1024.0)
        append_row(
            out_file,
            sample,
            tool,
            stage,
            wall,
            user,
            sys_t,
            rss_gb,
            (io_r1 - io_r0) / (1024.0 * 1024.0),
            (io_w1 - io_w0) / (1024.0 * 1024.0),
        )
