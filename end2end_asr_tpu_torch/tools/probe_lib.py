"""What the kernel probes (``probe_*.py``) share: building CUDA sources into
libraries of their own, timing one call on the card, and the card's line.

Needs a CUDA card and ``nvcc`` only when a function is called; imports
nothing at import time that needs either.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Tuple


def write_source(name: str, src: str) -> str:
    """Writes `src` to ``<name>.cu`` in the build directory; its path."""
    from end2end_asr_tpu_torch.ops import cuda_lib
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_lib.BUILD_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def build(named: Dict[str, str],
          prefix: str) -> Dict[str, Tuple[str, List[str]]]:
    """{name: .cu path} -> {name: (library, ptxas's lines on registers and
    spills)}; one nvcc per source, all started together."""
    from end2end_asr_tpu_torch.ops import cuda_lib
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    nvcc, procs = cuda_lib._nvcc(), {}
    for i, (name, path) in enumerate(named.items()):
        so = os.path.join(cuda_lib.BUILD_DIR,
                          f"{prefix}_{i}_{os.path.basename(path)[:-3]}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{prefix}: nvcc failed for {name}:\n{log}")
        out[name] = (so, [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln])
    return out


def kernel_ms(torch, fn, iters=20, tries=3) -> Dict[str, float]:
    """Mean device ms of one fn() call, by kernel name. Each kernel of a
    call runs the same number of times in every call, so a profile in
    which a kernel's count is not a multiple of `iters` (the profiler
    drops events now and then) is taken again."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by, seen = {}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
                seen[e.name] = seen.get(e.name, 0) + 1
        if by and all(c % iters == 0 for c in seen.values()):
            return {n: us / 1e3 / iters for n, us in by.items()}
    raise RuntimeError("the profiler missed kernel events in "
                       f"{tries} profiles")


def device_ms(torch, fn, iters=20) -> float:
    """Mean device ms of one fn() call, its kernels summed."""
    return sum(kernel_ms(torch, fn, iters).values())


def events_ms(torch, fn, iters=50) -> float:
    """Mean ms of one fn() call between CUDA events around `iters` calls
    back to back, after three warm calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
