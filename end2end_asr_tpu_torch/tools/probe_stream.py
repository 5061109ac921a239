#!/usr/bin/env python3
"""Device-memory streaming probe: does a hand-written streaming kernel move
bytes faster than PyTorch's eager elementwise chain?

Port of the JAX package's ``tools/probe_stream.py``. Four arms on flat f32
arrays sized like the full 39M-parameter model's Adam working set:
  1. torch_copy — ``x + 1``                                (8 B/element)
  2. cuda_copy  — the same, kernel ``stream_copy``  (csrc/stream.cu)
  3. torch_adam — the eager chain of `_adam_math`          (28 B/element:
                  p, m, v read and written, g read)
  4. cuda_adam  — the same step in one kernel, in place on p, m, v
Before the Adam arms are timed, the kernel's result is held against the
eager chain's (max abs error < 1e-6).

`stream_copy` / `stream_adam` launch the kernel for CUDA tensors and raise
if they cannot; for CPU tensors they take the plain version.

``--copy-arms`` (the card only) times the copy's designs against
``torch.add(x, 1)`` instead: the package's ``stream_copy``, that of each
``--source`` file (another design, e.g. an earlier commit's file unpacked
with ``git show``) and that of each copy of ``csrc/stream.cu`` with one
knob turned that ``--variants`` names (``COPY_VARIANTS``), each first
checked exact (out == x + 1 bit for bit), in ``COPY_ROUNDS`` rounds of turns
(torch.add, the designs, the designs again in reverse, torch.add again);
each reading the device ms of the call's kernels (torch.profiler) and the
ms between CUDA events around back-to-back calls. One JSON line: each
arm's readings, their medians and spreads, and the card's line.

Run on the card:  python -m end2end_asr_tpu_torch.tools.probe_stream
                  [--copy-arms [--source path/stream.cu]
                   [--variants vec2,cs_hints,...]]
On the CPU (small arrays, plain versions only): add --device cpu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from end2end_asr_tpu_torch.ops import cuda_lib

N_ROWS, N_COLS = 38400, 1024       # 39.3M f32 = 157 MB per array
COPY_ROUNDS = 5
LR, B1, B2, EPS = 1e-3, 0.9, 0.98, 1e-9

_COPY = cuda_lib.CudaKernel("stream", "stream_copy",
                            [cuda_lib.P, cuda_lib.P, cuda_lib.L, cuda_lib.P])
_ADAM = cuda_lib.CudaKernel("stream", "stream_adam",
                            [cuda_lib.P] * 4 + [cuda_lib.L]
                            + [cuda_lib.F32] * 8 + [cuda_lib.P])


def copy_launches() -> int:
    return _COPY.launches


def adam_launches() -> int:
    return _ADAM.launches


def reset_launches() -> None:
    _COPY.launches = 0
    _ADAM.launches = 0


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def _adam_math(p, m, v, g, t: float):
    m = B1 * m + (1.0 - B1) * g
    v = B2 * v + (1.0 - B2) * g * g
    mhat = m / (1.0 - B1 ** t)
    vhat = v / (1.0 - B2 ** t)
    return p - LR * mhat / (torch.sqrt(vhat) + EPS), m, v


def adam_plain(p, m, v, g, t: float):
    """One Adam step, out of place: returns the new (p, m, v)."""
    return _adam_math(p, m, v, g, t)


def _check_flat(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for x in tensors:
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.device != dev or x.shape != tensors[0].shape
                or x.data_ptr() % 16):
            raise ValueError(f"{name}: arguments must be contiguous f32 "
                             "tensors of one shape on one device, 16-byte "
                             "aligned")


def stream_copy(x: torch.Tensor) -> torch.Tensor:
    """x + 1: kernel 10 on a CUDA tensor, plain on a CPU tensor."""
    if x.device.type == "cpu":
        return copy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"stream_copy: unsupported device {x.device}")
    _check_flat("stream_copy", x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _COPY.launch(x.data_ptr(), out.data_ptr(), x.numel(),
                     torch.cuda.current_stream().cuda_stream)
    return out


def stream_adam(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, t: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step IN PLACE on p, m, v (returned for convenience):
    kernel 11 on CUDA tensors, the plain chain on CPU tensors."""
    if p.device.type == "cpu":
        p2, m2, v2 = adam_plain(p, m, v, g, t)
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
        return p, m, v
    if p.device.type != "cuda":
        raise ValueError(f"stream_adam: unsupported device {p.device}")
    _check_flat("stream_adam", p, m, v, g)
    with torch.cuda.device(p.device):
        _ADAM.launch(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                     p.numel(), LR, B1, B2, EPS, 1.0 - B1, 1.0 - B2,
                     1.0 - B1 ** t, 1.0 - B2 ** t,
                     torch.cuda.current_stream().cuda_stream)
    return p, m, v


def _time(fn, device: torch.device, iters: int) -> float:
    """Mean seconds of one call: CUDA events on the card, the host clock
    on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / iters


def run(device: torch.device, rows: int = N_ROWS, cols: int = N_COLS,
        iters: int = 30, seed: int = 0) -> List[dict]:
    """The probe's four arms; returns one dict per arm (name, ms, GB/s)
    and prints the probe's lines."""
    rng = np.random.RandomState(seed)
    p, m, v, g = (torch.from_numpy(
        rng.standard_normal((rows, cols)).astype(np.float32)).to(device)
        for _ in range(4))
    v = v.abs()
    nbytes = rows * cols * 4
    arms = []

    def report(name, dt, nb, note=""):
        arms.append({"name": name, "ms": dt * 1e3, "gbps": nb / dt / 1e9})
        print(f"{name:11s}: {dt*1e3:7.3f} ms  {nb/dt/1e9:7.1f} GB/s{note}")

    report("torch_copy", _time(lambda: copy_plain(p), device, iters),
           2 * nbytes)
    report("cuda_copy", _time(lambda: stream_copy(p), device, iters),
           2 * nbytes)

    # exactness cross-check before the in-place arms are timed
    ka = stream_adam(p.clone(), m.clone(), v.clone(), g, 3.0)
    ta = adam_plain(p, m, v, g, 3.0)
    for a, b in zip(ka, ta):
        err = float((a - b).abs().max())
        if not err < 1e-6:
            raise RuntimeError(f"stream_adam is {err} off the eager chain")
    print("adam exactness: kernel == eager chain (1e-6)")

    state = [p.clone(), m.clone(), v.clone()]

    def torch_arm():
        state[0], state[1], state[2] = adam_plain(*state, g, 3.0)

    report("torch_adam", _time(torch_arm, device, iters), 7 * nbytes,
           "  (28 B/param)")
    state = [p.clone(), m.clone(), v.clone()]
    report("cuda_adam",
           _time(lambda: stream_adam(*state, g, 3.0), device, iters),
           7 * nbytes, "  (28 B/param)")
    return arms


# copies of csrc/stream.cu with one knob of stream_copy turned, each timed
# by its stream_copy entry (--variants)
COPY_VARIANTS = {
    "vec2": [("constexpr int COPY_VEC = 1;", "constexpr int COPY_VEC = 2;")],
    "vec4": [("constexpr int COPY_VEC = 1;", "constexpr int COPY_VEC = 4;")],
    "threads128": [("constexpr int COPY_THREADS = 512;",
                    "constexpr int COPY_THREADS = 128;")],
    "threads256": [("constexpr int COPY_THREADS = 512;",
                    "constexpr int COPY_THREADS = 256;")],
    "cs_hints": [("{ return *p; }", "{ return __ldcs(p); }"),
                 ("{ *p = v; }", "{ __stcs(p, v); }")],
    "nc_loads": [("{ return *p; }", "{ return __ldg(p); }")],
}


def variant_sources(names) -> Dict[str, str]:
    """{name: edited copy of csrc/stream.cu} for COPY_VARIANTS' `names`."""
    from end2end_asr_tpu_torch.tools import probe_lib as P
    with open(os.path.join(cuda_lib.CSRC_DIR, "stream.cu")) as f:
        src = f.read()
    return P.edited_copies(src, COPY_VARIANTS, names, "probe_stream")


def copy_arms(device: torch.device, rows: int = N_ROWS, rounds: int = 3,
              sources: Tuple[str, ...] = (),
              variants: Tuple[str, ...] = ()) -> Dict[str, dict]:
    """{arm: {"device_ms": [...], "events_ms": [...], medians, spreads}}:
    torch.add(x, 1), the wrapper's stream_copy, and the stream_copy of
    each file of `sources` and of each copy COPY_VARIANTS' `variants`
    name, timed in `rounds` rounds of turns (add, arms, arms reversed,
    add) on one (rows, N_COLS) f32 array; each arm is first checked exact
    against x + 1."""
    from end2end_asr_tpu_torch.tools import probe_lib as P
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (rows, N_COLS)).astype(np.float32)).to(device)
    want = x + 1.0
    arms = {"stream_copy": lambda: stream_copy(x)}
    paths = list(sources) + [P.write_source(f"stream_{name}", src)
                             for name, src in variant_sources(variants)
                             .items()]
    libs = P.build({p: p for p in paths}, "probe_stream") if paths else {}
    stream = torch.cuda.current_stream().cuda_stream
    for p in paths:
        fn = getattr(ctypes.CDLL(libs[p][0]), _COPY.symbol)
        fn.argtypes, fn.restype = _COPY.argtypes, ctypes.c_int
        out = torch.empty_like(x)

        def call(fn=fn, out=out, p=p):
            if fn(x.data_ptr(), out.data_ptr(), x.numel(), stream):
                raise RuntimeError(f"probe_stream: {p}'s stream_copy failed")
            return out
        arms[p] = call
    for name, fn in arms.items():
        got = fn()
        torch.cuda.synchronize(device)
        if not torch.equal(got, want):
            raise RuntimeError(f"probe_stream: {name} is not x + 1")
    calls = {"torch_add": lambda: torch.add(x, 1), **arms}
    order = list(calls)
    res = {n: {"device_ms": [], "events_ms": []} for n in order}
    for _ in range(rounds):
        for n in order + order[::-1]:
            res[n]["device_ms"].append(P.device_ms(torch, calls[n]))
            res[n]["events_ms"].append(P.events_ms(torch, calls[n]))
    for r in res.values():
        for key in ("device_ms", "events_ms"):
            r[key + "_median"] = statistics.median(r[key])
            r[key + "_spread"] = max(r[key]) - min(r[key])
    return res


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=None,
                    help=f"rows of {N_COLS} f32 (default {N_ROWS}; 64 on "
                         "the CPU)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--copy-arms", action="store_true",
                    help="time the copy's designs against torch.add in "
                         "rounds of turns (the card only)")
    ap.add_argument("--source", action="append", default=[],
                    help="another stream.cu for --copy-arms (repeatable)")
    ap.add_argument("--variants", default="",
                    help="comma-separated COPY_VARIANTS for --copy-arms")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe measures the card "
                           "(--device cpu runs the plain arms on small "
                           "arrays)")
    rows = args.rows or (N_ROWS if args.device == "cuda" else 64)
    if args.copy_arms:
        if args.device != "cuda":
            raise RuntimeError("--copy-arms times kernels: the card only")
        from end2end_asr_tpu_torch.tools import probe_lib as P
        res = copy_arms(torch.device("cuda", 0), rows, COPY_ROUNDS,
                        tuple(args.source),
                        tuple(v for v in args.variants.split(",") if v))
        print(json.dumps({"shape": [rows, N_COLS], "rounds": COPY_ROUNDS,
                          "arms": res, "gpu": P.gpu_line()}))
        return
    run(torch.device(args.device), rows=rows, iters=args.iters)


if __name__ == "__main__":
    main()
