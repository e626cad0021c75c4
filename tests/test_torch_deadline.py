"""The port bench's hard-deadline watchdog (hymet_tpu_torch/harness/deadline.py)
against the JAX package's (hymet_tpu/harness/deadline.py): the same
decision table, skeletons and degraded lines; the status-file plumbing;
and, live, ONE parseable JSON line whether the bench stalls past its
deadline or crashes. The watchdog runs the port's file by path."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from hymet_tpu.harness import deadline as jdeadline
from hymet_tpu_torch.harness import deadline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------
# pure decision table


@pytest.mark.parametrize(
    "now,alive,status,expect",
    [
        (0.0, True, {}, "sleep"),  # far from deadline, parent healthy
        (0.0, True, {"done": True}, "exit_quiet"),  # bench printed its line
        (9941.0, True, {}, "kill_print_exit"),  # now >= epoch - margin
        (10_050.0, True, {"done": True}, "exit_quiet"),  # done wins over time
        (0.0, False, {}, "print_and_exit"),  # crash rescue
        (0.0, False, {"done": True}, "exit_quiet"),  # normal exit, no rescue
    ],
)
def test_watch_step(now, alive, status, expect):
    assert deadline.watch_step(now, 10_001.0, 60.0, alive, status) == expect
    assert jdeadline.watch_step(now, 10_001.0, 60.0, alive, status) == expect


def test_degraded_line_skeleton():
    line = deadline.degraded_line({}, "pipeline")
    assert line["metric"] == "pipeline_contigs_per_s"
    assert line["value"] == 0.0
    assert line["degraded"] == "deadline_no_measurement"
    json.dumps(line)  # must be serializable
    assert line == jdeadline.degraded_line({}, "pipeline")


def test_degraded_line_partial():
    status = {
        "result": {
            "metric": "pipeline_contigs_per_s",
            "value": 12.5,
            "unit": "contigs/s",
            "vs_baseline": 2.2,
        },
        "degraded": "warmup_run_only",
    }
    line = deadline.degraded_line(status, "pipeline")
    assert line["value"] == 12.5
    assert line["degraded"] == "warmup_run_only"
    assert line == jdeadline.degraded_line(status, "pipeline")


def test_skeleton_covers_every_bench_mode():
    for mode in ("pipeline", "warm_pipeline", "sketch", "sketch_stages",
                 "sketch_large", "align", "align_stages", "unknown"):
        line = deadline.skeleton(mode)
        assert set(line) == {"metric", "value", "unit", "vs_baseline"}
        assert line == jdeadline.skeleton(mode)


def test_skeletons_are_the_port_benchs_modes():
    """SKELETONS names exactly the modes of hymet_tpu_torch.bench, with the
    JAX bench's metric names and units."""
    from hymet_tpu_torch import bench

    assert set(deadline.SKELETONS) == set(bench.MODES)
    assert deadline.SKELETONS == jdeadline.SKELETONS
    assert (deadline.DEFAULT_DEADLINE_S, deadline.MARGIN_S) == (
        jdeadline.DEFAULT_DEADLINE_S, jdeadline.MARGIN_S)
    assert (deadline.ENV_EPOCH, deadline.ENV_STATUS, deadline.ENV_WATCHDOG) == (
        jdeadline.ENV_EPOCH, jdeadline.ENV_STATUS, jdeadline.ENV_WATCHDOG)


# ---------------------------------------------------------------------
# status-file plumbing


def test_partial_and_children_roundtrip(tmp_path, monkeypatch):
    path = str(tmp_path / "status.json")
    monkeypatch.setenv(deadline.ENV_STATUS, path)
    deadline._write_status(path, {"done": False})
    deadline.report_partial({"metric": "m", "value": 1.0}, "warmup_run_only")
    deadline.register_child(123)
    deadline.register_child(456)
    deadline.register_child(123)  # dedupe
    status = deadline._read_status(path)
    assert status["result"]["value"] == 1.0
    assert status["degraded"] == "warmup_run_only"
    assert sorted(status["children"]) == [123, 456]
    deadline.unregister_child(123)
    assert deadline._read_status(path)["children"] == [456]
    # the JAX module reads the same file the same way
    assert jdeadline._read_status(path) == deadline._read_status(path)


def test_helpers_noop_without_env(monkeypatch):
    monkeypatch.delenv(deadline.ENV_STATUS, raising=False)
    monkeypatch.delenv(deadline.ENV_WATCHDOG, raising=False)
    monkeypatch.delenv(deadline.ENV_EPOCH, raising=False)
    deadline.report_partial({"metric": "m"}, "x")  # no crash
    deadline.register_child(1)
    deadline.unregister_child(1)
    deadline.finish()
    assert deadline.remaining_s(42.0) == 42.0


def test_arm_disabled_by_zero_budget(tmp_path, monkeypatch):
    for key in (deadline.ENV_EPOCH, deadline.ENV_STATUS, deadline.ENV_WATCHDOG):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("BENCH_DEADLINE_S", "0")
    deadline.arm("sketch", str(tmp_path))
    assert deadline.ENV_WATCHDOG not in os.environ and not os.listdir(tmp_path)


# ---------------------------------------------------------------------
# live integration: a stalling "bench" gets killed and its watchdog
# prints the partial line; a crashing one is rescued too


_STALL = textwrap.dedent(
    """
    import os, sys, time
    sys.path.insert(0, {root!r})
    os.environ["BENCH_DEADLINE_S"] = "2"   # epoch 2s out, margin 60 -> fires now
    from hymet_tpu_torch.harness import deadline
    # land the partial BEFORE arming so the watchdog (which fires on its
    # first poll here) can never observe an empty status file
    os.environ[deadline.ENV_STATUS] = os.path.join({cache!r}, "status.json")
    deadline._write_status(os.environ[deadline.ENV_STATUS], {{"done": False}})
    deadline.report_partial(
        {{"metric": "pipeline_contigs_per_s", "value": 7.0,
          "unit": "contigs/s", "vs_baseline": 1.26}}, "warmup_run_only")
    deadline.arm("pipeline", {cache!r})
    time.sleep(120)  # simulated wedge: never prints
    """
)

_CRASH = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, {root!r})
    os.environ["BENCH_DEADLINE_S"] = "600"
    from hymet_tpu_torch.harness import deadline
    deadline.arm("align", {cache!r})
    sys.exit(3)  # dies without finish(); watchdog must rescue
    """
)

_FINISH = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {root!r})
    os.environ["BENCH_DEADLINE_S"] = "600"
    from hymet_tpu_torch.harness import deadline
    deadline.arm("sketch", {cache!r})
    deadline.finish()
    print(json.dumps({{"metric": "sketch_query_Gbp_per_s", "value": 1.0,
                       "unit": "Gbp/s", "vs_baseline": 25.0}}))
    """
)


def _run_fake_bench(tmp_path, script):
    proc = subprocess.run(
        [sys.executable, "-c", script.format(root=REPO, cache=str(tmp_path))],
        capture_output=True,
        text=True,
        timeout=60,
        env={k: v for k, v in os.environ.items() if not k.startswith("_BENCH_")},
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, f"want exactly one line, got {proc.stdout!r}"
    return json.loads(lines[0])


def test_watchdog_kills_stalled_bench_and_prints_partial(tmp_path):
    line = _run_fake_bench(tmp_path, _STALL)
    assert line["metric"] == "pipeline_contigs_per_s"
    assert line["value"] == 7.0
    assert line["degraded"] == "warmup_run_only"


def test_watchdog_rescues_crashed_bench(tmp_path):
    line = _run_fake_bench(tmp_path, _CRASH)
    assert line["metric"] == "align_query_Gbp_per_s"
    assert line["degraded"] == "deadline_no_measurement"


def test_watchdog_silent_after_finish(tmp_path):
    """A bench that finishes prints the only line: the watchdog, killed by
    finish(), prints nothing."""
    line = _run_fake_bench(tmp_path, _FINISH)
    assert line == {"metric": "sketch_query_Gbp_per_s", "value": 1.0, "unit": "Gbp/s",
                    "vs_baseline": 25.0}


def test_watchdog_file_imports_nothing_of_the_package():
    """The watchdog runs the port's deadline.py by path: the file itself
    imports only the standard library."""
    src = open(deadline.__file__).read()
    assert deadline.__file__.startswith(os.path.join(REPO, "hymet_tpu_torch"))
    imports = [ln.split()[1] for ln in src.splitlines() if ln.startswith(("import ", "from "))]
    assert set(imports) <= {"__future__", "json", "os", "signal", "subprocess", "sys", "time"}
