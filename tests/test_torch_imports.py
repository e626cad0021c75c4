"""hymet_tpu_torch stands alone: every module (and chip_smoke.py) imports
with ``jax`` and ``hymet_tpu`` blocked, and the entry points run on the
card unless the caller asks for the CPU — without a card they raise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hymet_tpu_torch.io.sketchdb import load_sketch_db
from hymet_tpu_torch.ops.sketch import ScreenEngine
from hymet_tpu_torch.pipeline.screen_stage import run_screen_stage, stream_screen
from hymet_tpu_torch.pipeline.staged import StagedContigs
from hymet_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "validation", "work_cami_suite")

_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "hymet_tpu"):
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
import hymet_tpu_torch
mods = ["hymet_tpu_torch"]
for info in pkgutil.walk_packages(hymet_tpu_torch.__path__, "hymet_tpu_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hymet_tpu")]
assert not bad, bad
print(len(mods))
"""


def test_port_imports_without_jax_or_reference_package():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 12  # every module was walked


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")


def test_default_device_raises_without_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(tmp_path):
    """No CPU fallback: called without device=, each entry point asks for
    CUDA and raises here, where there is no card."""
    _no_card()
    db = load_sketch_db(os.path.join(WORLD, "sketch1.npz"))
    q = tmp_path / "q.fna"
    q.write_text(">a\n" + "ACGT" * 50 + "\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_screen_stage([db], [str(q)], str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_screen(db, [str(q)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ScreenEngine(db)
    with pytest.raises(RuntimeError, match="CUDA"):
        StagedContigs(["a"], [b"ACGT" * 50], 4096, 38)


def test_chip_smoke_refuses_to_run_without_card():
    _no_card()
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""  # prints no result


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(alone)], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_bound_counts():
    """The kernels' bounds in chip_smoke: 32-bit instructions per window as
    documented, term by term, at the card's integer rates; kmer_hashes
    counted on every window, screen_count only on valid windows (not on
    padding), each bound by whichever of bytes and operations is slower."""
    import chip_smoke

    assert chip_smoke.window_ops(21, screen=True) == (1 + 10 + 20 + 2 + 16 + 4 + 20 + 3, 16 + 6 + 12)
    assert chip_smoke.window_ops(21, screen=False) == (1 + 10 + 20 + 2 + 16 + 4 + 20 + 2, 16 + 6 + 12)
    assert chip_smoke.window_ops(32, screen=False) == (1 + 10 + 26 + 2 + 32 + 20 + 2, 32 + 12)
    assert chip_smoke.window_ops(15, screen=False) == (1 + 10 + 14 + 2 + 4 + 4 + 20 + 2, 6 + 6 + 12)
    sms, clock = 132, 1.98e9
    ms, by = chip_smoke.hash_bound_ms([(8, 1 << 20)], 21, sms, clock)
    n = 8 * ((1 << 20) - 20)
    assert by == "operations"
    assert ms == pytest.approx(n * max(75 / 64, 34 / 64, 109 / 128) / sms / clock * 1e3)
    assert ms > (8 * (1 << 20) + 9 * n) / 3.35e12 * 1e3
    two, by2 = chip_smoke.hash_bound_ms([(8, 1 << 20), (8, 1 << 20)], 21, sms, clock)
    assert by2 == "operations" and two == pytest.approx(2 * ms)
    # screen_count: the same valid windows cost the same operations however
    # much padding the batch carries; the bytes count every packed byte
    dense = chip_smoke.screen_bound_ms([(4_000_000, 10_000_000, 2000, 10**8)], 21, sms, clock)
    padded = chip_smoke.screen_bound_ms([(20_000_000, 10_000_000, 2000, 10**8)], 21, sms, clock)
    alu = 10_000_000 * 76 + 2000 * 6 * 27
    want = max(alu / 64, 10_000_000 * 34 / 64, (alu + 10_000_000 * 34) / 128) / sms / clock * 1e3
    assert dense == padded == (pytest.approx(want), "operations")
    assert chip_smoke.screen_bound_ms([(10**10, 10, 0, 1)], 21, sms, clock) == (
        pytest.approx(10**10 / 3.35e12 * 1e3), "bytes")
    codes = chip_smoke.codes_with_n_runs(np.random.default_rng(0), 2, 1000)
    assert codes.shape == (2, 1000) and (codes == 4).any() and codes.max() <= 4
    edge = chip_smoke.edge_codes(np.random.default_rng(0), 200)
    assert (edge[2] == 4).all() and edge[1, chip_smoke.RUN - 1] == edge[1, 2 * chip_smoke.RUN] == 4
