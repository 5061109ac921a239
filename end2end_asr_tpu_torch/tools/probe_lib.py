"""What the kernel probes (``probe_*.py``) share: building CUDA sources into
libraries of their own, timing one call on the card, and the card's line.

Needs a CUDA card and ``nvcc`` only when a function is called; imports
nothing at import time that needs either.
"""

from __future__ import annotations

import ast
import contextlib
import ctypes
import operator
import os
import re
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


def bind(so: str, kernel, argtypes=None):
    """The entry `kernel` (an ops.cuda_lib.CudaKernel) names, from the
    library `so`, typed as the wrapper calls it (or by `argtypes`)."""
    fn = getattr(ctypes.CDLL(so), kernel.symbol)
    fn.argtypes = kernel.argtypes if argtypes is None else argtypes
    fn.restype = ctypes.c_int
    return fn


def edited_copies(src: str, table: Dict[str, list], names,
                  prog: str) -> Dict[str, str]:
    """{name: `src` with the (old, new) edits table[name] lists}, for
    `names`; each old text must be in the source once."""
    out = {}
    for name in names:
        v = src
        for old, new in table[name]:
            if v.count(old) != 1:
                raise RuntimeError(f"{prog}: {old.strip()!r} is not in the "
                                   "source once; update the probe")
            v = v.replace(old, new)
        out[name] = v
    return out


_OPS = {ast.Add: operator.add, ast.Sub: operator.sub,
        ast.Mult: operator.mul, ast.FloorDiv: operator.floordiv,
        ast.Div: operator.floordiv, ast.Mod: operator.mod}


def constexprs(path: str) -> Dict[str, int]:
    """{name: value} of a CUDA source's ``constexpr int NAME = <expr>;``
    lines whose expr holds integers, earlier names, + - * / % and brackets
    (C's integer division), in source order; other lines are left out."""
    with open(path) as f:
        src = f.read()
    out: Dict[str, int] = {}

    def ev(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            return out[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.left), ev(node.right))
        raise ValueError(f"{path}: cannot evaluate {ast.dump(node)}")
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        try:
            out[name] = ev(ast.parse(expr.strip(), mode="eval").body)
        except (KeyError, ValueError, SyntaxError):
            continue
    return out


# A profiling window on this card can lose the first kernel launched in
# it: in a process that had loaded more of the port's kernel libraries,
# every window lost its first launch (PERF.md, §6), so a one-call window
# around an entry caught only its later kernels, or none. The window opens
# with two kernels of its own, torch.cuda._sleep's, which device_events
# leaves out; where the profiler kept neither, it lost the whole window
# (one in hundreds), and a caller looks again.
LEAD_KERNEL = "spin_kernel"


@contextlib.contextmanager
def profiled(torch, cpu: bool = False):
    """torch.profiler over CUDA activity (and the host's, with `cpu`)
    whose window opens with two lead kernels and closes after the card
    has finished the block's work; yields the profile."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(2):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def window_kept(torch, prof) -> bool:
    """Whether the profiler kept a `profiled` window (a lead kernel's
    event is in it)."""
    return any(e.device_type == torch.autograd.DeviceType.CUDA
               and LEAD_KERNEL in e.name for e in prof.events())


def device_events(torch, prof) -> list:
    """The kernel events of a `profiled` window in launch order, its lead
    kernels left out."""
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and LEAD_KERNEL not in e.name),
                  key=lambda e: e.time_range.start)


def kernel_names(torch, fn, key: str, tries: int = 5) -> List[str]:
    """The device kernels of one fn() call whose names hold `key`, in
    launch order (fn runs again where the profiler lost the window, up to
    `tries` times)."""
    for _ in range(tries):
        with profiled(torch) as prof:
            fn()
        if window_kept(torch, prof):
            break
    return [e.name for e in device_events(torch, prof) if key in e.name]


def kernel_ms(torch, fn, iters=20, tries=3) -> Dict[str, float]:
    """Mean device ms of one fn() call, by kernel name. Each kernel of a
    call runs the same number of times in every call, so a profile in
    which a kernel's count is not a multiple of `iters` is taken again."""
    fn()
    for _ in range(tries):
        with profiled(torch) as prof:
            for _ in range(iters):
                fn()
        by, seen = {}, {}
        for e in device_events(torch, prof):
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
            seen[e.name] = seen.get(e.name, 0) + 1
        if by and all(c % iters == 0 for c in seen.values()):
            return {n: us / 1e3 / iters for n, us in by.items()}
    raise RuntimeError("the profiler missed kernel events in "
                       f"{tries} profiles (kernels seen in the last, of "
                       f"{iters} calls: {seen})")


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


# ---------------------------------------------------------------------------
# The attention probes (probe_attn_fwd.py, probe_attn_bwd.py)
# ---------------------------------------------------------------------------

# the train cell's attention calls (PERF.md §4): {label: (Tq, Tk, causal)}
# at batch 12, 8 heads of 64 and the training's dropout rate
ATTN_SHAPES = {"enc_self": (200, 200, False), "dec_cross": (51, 200, False),
               "dec_self": (51, 51, True)}
ATTN_B, ATTN_H, ATTN_D, ATTN_RATE, ATTN_SEED = 12, 8, 64, 0.1, 77


def cut(src: str, names: str, cuts: Dict[str, list], prog: str) -> str:
    """`src` with the parts `names` (keys of `cuts` joined by '+') cut,
    each by replacing lines of the source."""
    for old, new in (c for name in names.split("+") for c in cuts[name]):
        if old not in src:
            raise RuntimeError(f"{prog}: {old.strip()!r} is not in the "
                               "source; update the probe")
        src = src.replace(old, new)
    return src


def attn_inputs(torch, dev, cdt, Tq: int, Tk: int, causal: bool):
    """q, k, v (B, H, T, D) in `cdt`, transposed views of (B, T, H, D)
    tensors as the projections hand them over, and the f32 bias
    (B, Tq, Tk) of a random mask (plus the future where `causal`); from a
    seed of the shape, so every design of a call gets the same."""
    B, H, D = ATTN_B, ATTN_H, ATTN_D
    g0 = torch.Generator().manual_seed(Tq * 1000 + Tk)
    q, k, v = (torch.randn(B, t, H, D, generator=g0).to(dev, cdt)
               .transpose(1, 2) for t in (Tq, Tk, Tk))
    mask = torch.rand(B, Tq, Tk, generator=g0) < 0.1
    if causal:
        mask |= torch.ones(Tq, Tk, dtype=torch.bool).triu(1)
    return q, k, v, torch.where(mask, -1e9, 0.0).to(dev)


def turns_json(res: Dict[str, dict], gflop=None) -> dict:
    """`time_in_turns`'s result as the probes print it: device, events and
    by-kernel ms for each call and, given the GFLOP a call executes, each
    call's TFLOP/s on its device time."""
    out = {key: {n: r[key] for n, r in res.items()}
           for key in ("device_ms", "events_ms", "kernels_ms")}
    if gflop is not None:
        out["executed_gflop"] = gflop
        out["tflops"] = {n: gflop / r["device_ms"] for n, r in res.items()}
    return out


def time_in_turns(torch, calls: Dict[str, object]) -> Dict[str, dict]:
    """{name: fn} -> {name: {"kernels_ms", "device_ms", "events_ms"}}: the
    calls timed in turns (a, b, ..., b, a), device ms by kernel
    (`kernel_ms`) and events ms (`events_ms`); of each call's two
    readings the smaller is kept."""
    names = list(calls)
    res = {n: {"kernels_ms": [], "events_ms": []} for n in names}
    for order in (names, names[::-1]):
        for n in order:
            try:
                res[n]["kernels_ms"].append(kernel_ms(torch, calls[n]))
            except RuntimeError as e:
                raise RuntimeError(f"{n}: {e}") from e
            res[n]["events_ms"].append(events_ms(torch, calls[n]))
    torch.cuda.synchronize()
    for r in res.values():
        r["kernels_ms"] = min(r["kernels_ms"], key=lambda k: sum(k.values()))
        r["device_ms"] = sum(r["kernels_ms"].values())
        r["events_ms"] = min(r["events_ms"])
    return res
