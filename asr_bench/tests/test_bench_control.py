"""The control, the reference computed with float8 products in the
program's place, fails the cell's limits (here at a tiny size; the
chip's readings at the cell's own size are in PERF.md, from
calibrate.py)."""

from asr_bench import calibrate
import tiny


def test_train_control_fails_the_limits():
    out, checks, run = tiny.run(tiny.TRAIN, dtype="float32")
    control = calibrate.train_control(run)
    lim = run.limits
    assert any(control[k] > lim[k]
               for k in ("loss_rel", "grad_mu_gap", "update_gap")), control

