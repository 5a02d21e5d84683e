"""The comparison that decides ``correct``, on the CPU at smoke widths:
the plain reference agrees with the port; the control (the reference with
float8 products in the program's place) and the planted faults fail the
cells' limits."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import check
from benchmark.calibrate import as_program
from benchmark.reference import kokoro as reference
from benchmark.run import checked_steps, reference_run, run
from benchmark.tests.small import small_cell

CELLS = ["hp-ladder", "long-b48-t1408"]
CPU = torch.device("cpu")
SEED = 2 ** 33 + 5


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_in_float32(name):
    """In float32 the port's plain route and the reference take the same three
    steps: same masks (dropout, stochastic depth, SpecAugment, the kernels'
    Philox dropout), losses, clips and updates, to rounding."""
    c = small_cell(name, "float32")
    *_, seen = checked_steps(c, SEED, CPU)
    found = check.numbers(seen, reference_run(c, SEED, seen, CPU), 0.9)
    assert found["loss_gap"]["value"] < 1e-6
    assert found["grad_gap"]["value"] < 1e-5
    assert found["update_gap"]["value"] < 1e-4


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    """The reference with float8 products (``fp8_cast``) in the program's place
    fails at least one of the cell's limits."""
    c = small_cell(name, "bfloat16")
    *_, seen = checked_steps(c, SEED, CPU)
    ref = reference_run(c, SEED, seen, CPU)
    ctl = reference_run(c, SEED, seen, CPU, cast=reference.fp8_cast)
    found = check.numbers(as_program(ctl, seen["params0"], 0.9), ref, 0.9)
    correct, _ = check.judge(found, c["cell"]["limits"])
    assert not correct


def _unchanged(step):
    """A step that returns its state unchanged: parameters and moments as
    they were before it."""
    def broken(state, batch, generator):
        before = [t.detach().clone() for t in (list(state.optimizer.params)
                                               + state.optimizer.mu + state.optimizer.nu)]
        metrics = step(state, batch, generator)
        with torch.no_grad():
            for t, b in zip(list(state.optimizer.params) + state.optimizer.mu
                            + state.optimizer.nu, before):
                t.copy_(b)
        return metrics
    return broken


def _half_batch(step):
    """Half of each batch's rows left out; the means over the rest."""
    def broken(state, batch, generator):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(state, half, generator)
    return broken


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch],
                         ids=["sound", "unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_run_with_the_timed_path_broken(name, fault):
    """A whole run (the look for a card skipped) judges the sound step
    correct and each planted fault not."""
    c = small_cell(name, "float32")
    result = run(c, SEED, 0.5, False, device="cpu", fault=fault)
    assert result["correct"] is (fault is None)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]


def test_limits_separate():
    """Each cell's limits lie above the sound readings and below the
    faults'; a state left unchanged reads 1 on ``update_gap``."""
    for name in CELLS:
        limits = small_cell(name)["cell"]["limits"]
        assert all(0 < v < 1 for v in limits.values())
        assert "update_gap" in limits or "update_gap_median" in limits
    params = {"w": torch.ones(3), "b": torch.ones(2)}
    ref = {"losses": [{"total": 1.0}], "first_grad": {"w": torch.ones(3), "b": torch.ones(2)},
           "params": {"w": torch.full((3,), 2.0), "b": torch.full((2,), 2.0)}}
    prog = {"losses": [1.0], "params0": params, "params": copy.deepcopy(params),
            "first_moment": {k: 0.1 * v for k, v in ref["first_grad"].items()}}
    found = check.numbers(prog, ref, 0.9)
    assert found["update_gap"]["value"] == pytest.approx(1.0)
    assert found["grad_gap"]["value"] == pytest.approx(0.0, abs=1e-12)
