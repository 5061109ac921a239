"""Readings that set the limits of `correct`, for many seeds in one
process (the benchmark's own runs do not run this).

    python3 asr_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--variants program control faults] [--seconds 0]

For each seed, one line of JSON on standard output per variant:
  * program: the cell's run as the benchmark makes it (the window of
    `--seconds`, 0 by default: the set-up's checked dispatches alone)
    and its readings against the reference;
  * control: the reference computed with float8 products put in the
    program's place, against the float32 reference, on the checked
    dispatches' batches;
  * faults: the program with a fault planted under the timed path: a
    step that returns its state unchanged; half of each batch left out
    (the mean over the rest); a dispatch that trains on the first
    dispatch's batches whatever it is given (a graph whose input copy is
    skipped); a dispatch that starts from a fresh optimizer state (the
    state not carried from one dispatch to the next).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from asr_bench import core  # noqa: E402
from asr_bench.reference import check, model as ref  # noqa: E402


# -- faults planted under the timed path --------------------------------------

FAULTS = ("unchanged", "half_batch", "stale_inputs", "fresh_opt")


@contextlib.contextmanager
def planted(fault: str):
    """The program with `fault` (one of FAULTS) planted."""
    from end2end_asr_tpu_torch.training import optimizer, steps
    saved = (steps.make_train_step_impl, steps.make_multi_train_step)
    make, make_multi = saved

    def make_faulty(cfg, dims, *a, **kw):
        step = make(cfg, dims, *a, **kw)

        def faulty(fp, data, opt, rng, pcm, n_frames, targets, tgt_lengths,
                   spect_T, model_state=None):
            if fault == "half_batch":
                h = targets.shape[0] // 2
                return step(fp, data, opt, rng, pcm[:h], n_frames[:h],
                            targets[:h], tgt_lengths[:h], spect_T,
                            model_state=model_state)
            out = step(fp, data, opt, rng, pcm, n_frames, targets,
                       tgt_lengths, spect_T, model_state=model_state)
            return (data, opt, model_state or {}) + tuple(out[3:])
        return faulty

    def make_multi_faulty(cfg, step, K, device):
        multi = make_multi(cfg, step, K, device)
        first = []

        def call(fp, data, opt_state, rng, batches, spect_T,
                 model_state=None):
            if fault == "stale_inputs":
                batches = first[0] if first else batches
            elif first:
                opt_state = optimizer.init_opt_state(cfg, data)
            first.append(batches)
            return multi(fp, data, opt_state, rng, batches, spect_T,
                         model_state=model_state)
        call.close = multi.close
        return call

    if fault in ("unchanged", "half_batch"):
        steps.make_train_step_impl = make_faulty
    elif fault in ("stale_inputs", "fresh_opt"):
        steps.make_multi_train_step = make_multi_faulty
    else:
        raise ValueError(f"unknown fault {fault}")
    try:
        yield
    finally:
        steps.make_train_step_impl, steps.make_multi_train_step = saved


# -- readings ---------------------------------------------------------------

def one_run(cell: str, seed: int, seconds: float, device):
    from asr_bench import run as R
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=0)
    return R.measure(args, device, time.time(),
                     sync=lambda: core.sync(device))


def readings(checks):
    return {name: value for name, value, _ in checks}


def train_control(run) -> dict:
    """The float8 reference in the program's place, against the float32
    reference, on the checked dispatches' batches."""
    from asr_bench.kinds import train
    ref.no_tf32()
    batches = train.reference_batches(run)
    want = run.model_ref.train(run.flat, batches, run.seed, ref.F32)
    low = run.model_ref.train(run.flat, batches, run.seed,
                              ref.Precision("fp8"))
    r = check.compare_train(want, run.flat, low["losses"], low["mu"],
                            low["params"])
    return {"loss_rel": r["loss_rel"], "grad_mu_gap": r["mu_gap"],
            "update_gap": r["update_gap"], "mu_leaf": r["mu_leaf"],
            "update_leaf": r["update_leaf"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["program", "control"])
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    core.set_caches()
    import torch
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    for seed in args.seeds:
        for variant in args.variants:
            todo = ([(variant, None)] if variant != "faults" else
                    [(f"fault_{f}", f) for f in FAULTS])
            for name, fault in todo:
                t = time.time()
                with (planted(fault) if fault else contextlib.nullcontext()):
                    out, checks, run = one_run(args.workload, seed,
                                               args.seconds, device)
                line = {"cell": args.workload, "seed": seed,
                        "variant": name, "readings": readings(checks),
                        "correct": out["correct"]}
                if variant == "program":
                    line["detail"] = getattr(run, "check_detail", None)
                if variant == "control":
                    line["readings"] = train_control(run)
                line["seconds"] = time.time() - t
                print(json.dumps(line, default=str), flush=True)
                del run
                core.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
