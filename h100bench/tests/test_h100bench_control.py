"""The control and the planted faults come out as not correct under each
cell's limits: on the CPU at a small size (the port's plain versions),
and on the card at the cell's own size (marked `cuda`)."""

import importlib.util

import pytest
import torch

from h100bench import faults, harness
from h100bench.tests.conftest import tiny

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def load_run():
    spec = importlib.util.spec_from_file_location(
        "h100bench_run", harness.HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fails(cell, checks) -> bool:
    return any(v > cell.limits["limits"][k] for k, v in checks.items())


def control_checks(cell, seed, device, seconds=0.1):
    drv = cell.driver
    st = drv.setup(cell, seed, device=device)
    drv.window(st, seconds)
    drv.free(st)
    return drv.check(st, cell.limits, control=faults.CONTROL_DTYPE)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny(harness.Cell(name, BENCH))
    checks = control_checks(cell, 2**35 + 17, "cpu")
    assert fails(cell, checks), checks


FAULT_CASES = [(c, f) for c in CELLS for f in sorted(
    faults.FAULTS[harness.Cell(c, BENCH).traffic["driver"]])]


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_a_planted_fault_is_not_correct(name, fault):
    """The harness's look for a card skipped, a whole run drives the timed
    path with the fault planted under it."""
    cell = tiny(harness.Cell(name, BENCH))
    run = load_run()
    drv_faults = faults.FAULTS[cell.traffic["driver"]]
    out = run.execute(cell, 2**36 + 29, 0.1, False, device="cpu",
                      fault=drv_faults[fault])
    assert not out["correct"], out["checks"]


def nan_after_first_steps(step, st):
    """A step whose loss turns NaN once set-up's first steps are done."""
    calls = [0]

    def broken(params, xs, ys, target, key):
        loss, grads = step(params, xs, ys, target, key)
        calls[0] += 1
        if calls[0] > st.cell.traffic["first_steps"]:
            loss = loss * float("nan")
        return loss, grads
    return broken


def test_a_non_finite_window_is_not_correct():
    """The first steps agree with the reference; the window's NaN losses
    alone make the run not correct."""
    cell = tiny(harness.Cell("cornell.train", BENCH))
    out = load_run().execute(cell, 2**37 + 3, 0.2, False, device="cpu",
                             fault=nan_after_first_steps)
    checks = out["checks"]
    assert checks["nonfinite"]["value"] > 0 and not out["correct"]
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k != "nonfinite"), checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(card, name):
    cell = harness.Cell(name, BENCH)
    checks = control_checks(cell, 2**35 + 19, card, seconds=1.0)
    torch.cuda.empty_cache()
    assert fails(cell, checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_a_planted_fault_is_not_correct_on_the_card(card, name, fault):
    cell = harness.Cell(name, BENCH)
    out = load_run().execute(cell, 2**36 + 31, 1.0, False, device=card,
                             fault=faults.FAULTS[cell.traffic["driver"]][
                                 fault])
    torch.cuda.empty_cache()
    assert not out["correct"], out["checks"]
