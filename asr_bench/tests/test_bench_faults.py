"""Runs with the timed path broken underneath come out not correct; the
same runs unbroken come out correct (the program in f32, so that only
the fault can fail them)."""

import pytest

from asr_bench import calibrate
import tiny


@pytest.mark.parametrize("fault", calibrate.FAULTS)
def test_train_fault_is_not_correct(fault):
    with calibrate.planted(fault):
        out, checks, run = tiny.run(tiny.TRAIN, dtype="float32")
    assert not out["correct"], out["checks"]


def test_unbroken_runs_are_correct():
    out, checks, run = tiny.run(tiny.TRAIN, dtype="float32")
    assert out["correct"], out["checks"]


def test_checked_dispatches_are_two_on_their_own_batches():
    # the reference follows the capture's dispatch and a replay on other
    # batches, through the window's own call
    out, checks, run = tiny.run(tiny.TRAIN, dtype="float32")
    K = run.traffic["steps_per_dispatch"]
    assert len(run.check_detail["losses_prog"]) == 2 * K
    assert len({tuple(b) for b in run.bins[:2 * K]}) == 2 * K
