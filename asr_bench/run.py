"""Run one cell of the benchmark once.

    python3 asr_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Measures the PyTorch and CUDA port (end2end_asr_tpu_torch) on the CUDA
cards of this machine: set-up (inputs and weights from the seed, the
program's kernels built into build/ inside the checkout, the cell's
shapes warmed), then the window of `--seconds`, then the check that
decides `correct`. Prints each compared number beside its limit as the
last lines of standard error, and one JSON line as the last line of
standard output: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (a profiled stretch at the window's
start) and the breakdown.

Exits non-zero without a result where there is no CUDA card (or fewer
than the cell asks for), where the program is not in the checkout, or
where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse      # noqa: E402
import importlib.util  # noqa: E402
import json          # noqa: E402
import os            # noqa: E402
import sys           # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from asr_bench import core  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def program_present() -> None:
    if importlib.util.find_spec(core.PROGRAM) is None:
        raise core.BenchError(f"the program ({core.PROGRAM}) is not in "
                              "this checkout")


def cuda_device(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise core.BenchError("no CUDA device: torch.cuda.is_available() "
                              "is False")
    if torch.cuda.device_count() < chips:
        raise core.BenchError(f"the cell needs {chips} CUDA devices, "
                              f"{torch.cuda.device_count()} are visible")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def measure(args, device, t_start: float, bench=None, files=None,
            sync=None) -> dict:
    """One run on `device`: (result line, checks, run)."""
    from asr_bench.kinds import common
    bench = bench or core.benchmark()
    run = common.Run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start, device, files)
    runner = importlib.import_module(
        f"asr_bench.kinds.{run.traffic['kind']}").RUNNER
    sync = sync or (lambda: None)
    try:
        runner.build(run)
        sync()
        run.setup_s = time.time() - t_start
        t0 = time.perf_counter()
        runner.window(run, t0 + args.seconds, run.traffic["trace_units"])
        sync()
        t1 = time.perf_counter()
        run.window_span, run.window_s = (t0, t1), t1 - t0
        run.card = core.card_state() if device.type == "cuda" else ""
        dev = device_line(device)
        if args.trace and run.trace_result is not None:
            dev["busy_s"] = run.trace_result["busy_s"]
            dev["window_s"] = run.trace_result["window_s"]
        checks = runner.check(run)
        rec = runner.record(run)
    finally:
        if run.corpus is not None:
            run.corpus.close()
    metrics = {}
    for m in core.metrics_of(bench, args.workload, bool(args.trace)):
        v = core.reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": core.passed(checks), "attempted": rec["steps"],
           "failed": int(sum(v for n, v, _ in checks
                             if n == "nonfinite_steps")),
           "metrics": metrics, "device": dev}
    if args.trace and "trace" in rec:
        out["breakdown"] = core.breakdown(rec["trace"])
    out["checks"] = core.checks_line(checks)
    return out, checks, run


def device_line(device) -> dict:
    if device.type == "cuda":
        import torch
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    return {"platform": device.type, "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    try:
        core.set_caches()
        bench = core.benchmark()
        files = core.cell_files(args.workload, bench)
        program_present()
        device = cuda_device(files[0]["chips"])
        import torch
        core.cpu_threads()
        out, checks, run = measure(args, device, T_START, bench, files,
                                   sync=torch.cuda.synchronize)
    except core.BenchError as e:
        print(f"asr_bench: {e}", file=sys.stderr)
        return 2
    found = core.forbidden_modules()
    if found:
        print("asr_bench: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    parts = {n: round(b - a, 3) for n, a, b in run.spans.items
             if n.startswith("setup.")}
    print(f"card: {core.power_limit()}; at the window's close "
          f"{run.card}; set-up {run.setup_s:.3f} s "
          f"{json.dumps(parts)}, window {run.window_s:.3f} s",
          file=sys.stderr)
    detail = getattr(run, "check_detail", None)
    if detail:
        print("check detail: " + json.dumps(
            {k: v for k, v in detail.items()}, default=str),
            file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
