"""The port's bench timing core (hymet_tpu_torch/harness/timing.py) against
the JAX package's (hymet_tpu/harness/timing.py): the repeat/deadline
protocol on a scripted clock, the best run and spread note, and the
forced readback on tensors."""

import jax.numpy as jnp
import pytest
import torch

from hymet_tpu.harness import timing as jtiming
from hymet_tpu_torch.harness.timing import best_run, force_readback, spread_note, timed_groups

torch.set_num_threads(1)


class FakeClock:
    """Deterministic clock: each call returns the next scripted tick."""

    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        t = self.t
        self.t += self.step
        return t


def test_timed_groups_counts_and_times():
    clock = FakeClock(step=1.0)
    runs = timed_groups(lambda: "r", min_runs=3, max_runs=10, budget_s=1000.0, clock=clock)
    # each run brackets exactly two clock reads (plus loop checks)
    assert len(runs) >= 3
    assert all(dt == pytest.approx(1.0) for dt, _ in runs)
    assert all(res == "r" for _, res in runs)


def test_timed_groups_stops_at_budget_with_one_run():
    # budget so small the deadline passes during the first run: the
    # protocol still records that one run, then stops
    clock = FakeClock(step=10.0)
    runs = timed_groups(lambda: None, min_runs=4, max_runs=8, budget_s=5.0, clock=clock)
    assert len(runs) == 1


def test_timed_groups_max_runs_cap():
    clock = FakeClock(step=0.001)
    runs = timed_groups(lambda: None, min_runs=1, max_runs=5, budget_s=1e9, clock=clock)
    assert len(runs) == 5


def test_timed_groups_rejects_bad_bounds():
    with pytest.raises(ValueError):
        timed_groups(lambda: None, min_runs=0, max_runs=3, budget_s=1.0)
    with pytest.raises(ValueError):
        timed_groups(lambda: None, min_runs=4, max_runs=3, budget_s=1.0)


@pytest.mark.parametrize("step,min_runs,max_runs,budget", [
    (1.0, 3, 10, 1000.0), (10.0, 4, 8, 5.0), (0.001, 1, 5, 1e9), (1.0, 2, 8, 7.0),
    (3.0, 6, 12, 20.0),
])
def test_timed_groups_same_runs_as_jax(step, min_runs, max_runs, budget):
    """Both protocols take the same number of runs and the same times on
    the same scripted clock."""
    calls = []
    got = timed_groups(lambda: calls.append(1) or len(calls), min_runs=min_runs,
                       max_runs=max_runs, budget_s=budget, clock=FakeClock(step))
    jcalls = []
    want = jtiming.timed_groups(lambda: jcalls.append(1) or len(jcalls), min_runs=min_runs,
                                max_runs=max_runs, budget_s=budget, clock=FakeClock(step))
    assert got == want


def test_best_run_and_spread():
    runs = [(3.0, "slow"), (1.0, "fast"), (2.0, "mid")]
    assert best_run(runs) == (1.0, "fast") == jtiming.best_run(runs)
    note = spread_note(runs)
    assert "best 1.000s" in note and "worst 3.000s" in note and "3 runs" in note
    assert note == jtiming.spread_note(runs)


def test_force_readback_shapes():
    # tensors, scalars and nested containers must all be fetchable, as the
    # JAX helper fetches arrays, scalars and pytrees
    force_readback(torch.zeros((4, 4)))
    force_readback(torch.tensor(3.0))
    force_readback((torch.zeros((2, 3, 4)), torch.ones((5,))))
    force_readback({"a": torch.arange(10)})
    force_readback([None, (torch.zeros(0, 3), torch.ones(2))])
    jtiming.force_readback({"a": jnp.arange(10)})


def test_force_readback_orders_after_execution():
    # the readback must fetch the produced VALUE: the first element of the
    # first leaf in the JAX package's leaf order (a dict by sorted key)
    x = torch.arange(8, dtype=torch.int32) + 1
    assert x.reshape(-1)[:1].cpu().item() == 1
    force_readback(x)
    seen = []

    class Probe(torch.Tensor):
        def cpu(self, *args, **kwargs):
            seen.append(int(self.reshape(-1)[0]))
            return super().cpu(*args, **kwargs)

    force_readback({"b": torch.full((3,), 2).as_subclass(Probe),
                    "a": torch.full((2, 2), 7).as_subclass(Probe)})
    assert seen == [7]


def test_force_readback_needs_a_tensor():
    with pytest.raises(ValueError, match="no tensor"):
        force_readback((None, [1, 2]))
