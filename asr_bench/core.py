"""What every run of the benchmark shares: finding a cell's files by name,
the caches, host spans, the reduction of a device trace, the metric
readers and the result line.

A cell of BENCHMARK.json names a configuration (configs/<name>.json) and
a traffic mix (traffic/<name>.json, whose "kind" picks the runner in
kinds/); each metric is read by metrics/<name>.py from the run's record;
limits/<cell>.json holds the limits of the numbers that decide
`correct`. A new cell, mix, metric or limit is a new file.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "end2end_asr_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "end2end_asr_tpu")


class BenchError(RuntimeError):
    """A run that cannot measure: it prints no result."""


def load_json(*parts: str) -> dict:
    path = os.path.join(HERE, *parts)
    if not os.path.exists(path):
        raise BenchError(f"{os.path.relpath(path, ROOT)} is missing")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise BenchError("BENCHMARK.json is missing")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell_files(name: str, bench: Optional[dict] = None):
    """(cell, configuration, traffic, limits) of the workload `name`."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.relpath(os.path.join(ROOT, conf["file"]),
                                       HERE))
    traffic = load_json("traffic", cell["traffic"] + ".json")
    limits = load_json("limits", name + ".json")
    return cell, config, traffic, limits


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metric entries this cell reports: its end-to-end ones, or with
    `trace` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    """metrics/<name>.py as a module (its `read(record)` gives the value
    or None)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        raise BenchError(f"metrics/{name}.py is missing")
    spec = importlib.util.spec_from_file_location(
        "asr_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_caches() -> None:
    """Every cache the program or its libraries may write, at fixed paths
    inside the checkout (the CUDA kernels build into build/kernels there
    by themselves); nothing loads JAX through a library."""
    build = os.path.join(ROOT, "build")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(build, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def cpu_threads(n: int = 4) -> None:
    import torch
    torch.set_num_threads(n)



# -- host spans -----------------------------------------------------------

class Spans:
    """Named intervals on the host clock (perf_counter seconds)."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str, lo: float = -math.inf,
                  hi: float = math.inf) -> List[float]:
        return [b - a for n, a, b in self.items
                if n == name and a >= lo and b <= hi]


# -- the device trace -----------------------------------------------------

LEAD = "spin_kernel"       # torch.cuda._sleep's kernel


class Trace:
    """A torch.profiler window over CUDA activity. It opens with two lead
    kernels (a window can lose its first launch) and notes the host clock
    at the second, so that host spans map onto the device's timeline."""

    def __init__(self):
        self.prof = None
        self.t_host = None
        self.t0 = self.t1 = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.t_host = time.perf_counter()
        torch.cuda._sleep(1000)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        return False

    def reduce(self, spans: Spans) -> dict:
        """{"window_s", "busy_s", "n_kernels", "by_name" {name: [seconds,
        calls]}, "gaps" [(seconds, host span)]} of the window [t0, t1],
        device intervals clipped to it; without the lead kernels."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        evs = sorted(((e.name, e.time_range.start, e.time_range.end)
                      for e in self.prof.events()
                      if e.device_type == cuda),
                     key=lambda x: x[1])
        leads = [e for e in evs if LEAD in e[0]]
        if not leads:
            raise BenchError("the profiler kept no lead kernel: the trace "
                             "is not aligned")
        # device us = host seconds · 1e6 + shift
        shift = leads[-1][1] - self.t_host * 1e6
        lo, hi = self.t0 * 1e6 + shift, self.t1 * 1e6 + shift
        by: Dict[str, List[float]] = {}
        busy, n, end = 0.0, 0, lo
        gaps = []
        for name, a, b in evs:
            if LEAD in name:
                continue
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            n += 1
            r = by.setdefault(name, [0.0, 0])
            r[0] += (b - a) * 1e-6
            r[1] += 1
            if a > end:
                gaps.append((a - end, end))
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        if hi > end:
            gaps.append((hi - end, end))
        host = sorted(((a * 1e6 + shift, b * 1e6 + shift, name)
                       for name, a, b in spans.items), key=lambda s: s[0])
        starts = [s[0] for s in host]

        def during(t):
            # the innermost host span open at device time t
            best = None
            for s in host[:bisect.bisect_right(starts, t)]:
                if s[1] >= t and (best is None or s[0] >= best[0]):
                    best = s
            return best[2] if best else "host outside any span"

        gaps.sort(reverse=True)
        return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
                "n_kernels": n, "by_name": by,
                "gaps": [(g * 1e-6, during(t + g / 2)) for g, t in gaps[:10]]}


def breakdown(tr: dict) -> dict:
    ops = sorted(tr["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[name, v[0]] for name, v in ops],
            "idle_gaps": [[name, s] for s, name in tr["gaps"]]}


def kernel_seconds(tr: dict, names) -> Tuple[float, int]:
    """(device seconds, calls) of the kernels whose names hold any of
    `names`."""
    s, c = 0.0, 0
    for name, (sec, calls) in tr["by_name"].items():
        if any(k in name for k in names):
            s += sec
            c += calls
    return s, c


# -- the result ------------------------------------------------------------


def _smi(fields: str) -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def power_limit() -> str:
    return _smi("name,power.limit")


def card_state() -> str:
    """The card's SM clock (and its maximum), temperature and power draw
    now: beside each run's numbers, so that a run slowed by its clock
    shows."""
    return "sm clock, max, temperature, power: " + _smi(
        "clocks.sm,clocks.max.sm,temperature.gpu,power.draw")


def checks_line(checks: List[Tuple[str, float, float]]) -> dict:
    return {name: {"value": value, "limit": limit}
            for name, value, limit in checks}


def passed(checks: List[Tuple[str, float, float]]) -> bool:
    return all(value == value and value <= limit
               for _, value, limit in checks)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
