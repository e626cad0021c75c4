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
    """The kernel's bound in chip_smoke: ops per window as documented
    (rolling packing, not a repack per window), and the chunk shape and
    the staged screen's batches bound by bytes at the table's peaks."""
    import chip_smoke

    assert chip_smoke.hash_ops_per_window(21) == 12 + 2 + 5 * 21 + 24 + 6 + 21
    assert chip_smoke.hash_ops_per_window(32) == 12 + 2 + 5 * 32 + 48 + 21
    assert chip_smoke.hash_ops_per_window(15) == 12 + 2 + 5 * 15 + 12 + 21
    ms, by = chip_smoke.hash_bound_ms([(8, 1 << 20)], 21)
    n = 8 * ((1 << 20) - 20)
    assert by == "bytes"
    assert ms == pytest.approx((8 * (1 << 20) + 9 * n) / 3.35e12 * 1e3)
    two, by2 = chip_smoke.hash_bound_ms([(8, 1 << 20), (8, 1 << 20)], 21)
    assert by2 == "bytes" and two == pytest.approx(2 * ms)
    codes = chip_smoke.codes_with_n_runs(np.random.default_rng(0), 2, 1000)
    assert codes.shape == (2, 1000) and (codes == 4).any() and codes.max() <= 4
