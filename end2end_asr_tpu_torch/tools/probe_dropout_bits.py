"""Where the dropout bits (kernel 9, ``dropout_bits``) spend their time.

    python -m end2end_asr_tpu_torch.tools.probe_dropout_bits
        [--source path/to/attention.cu ...]

Builds ``csrc/attention.cu`` and every file ``--source`` names (another
design of the same entry point, e.g. an earlier commit's file unpacked
with ``git show``) into libraries of their own and, at the encoder's
self-attention shapes of the 800- and 1600-frame buckets ((12, 8·200,
200) and (12, 8·400, 400), ``SHAPES``), for each design:

  * the bits bit for bit against the plain Philox stream at the seeds
    ``SEEDS``;
  * the kernel's device ms (torch.profiler, kernel events only) and the
    ms between CUDA events around back-to-back ctypes calls, the designs
    timed in turns (``probe_lib.time_in_turns``);
  * the bound: the larger of the bytes written over 3.35 TB/s and the
    integer instructions the built kernel executes for one group of four
    words (``cuobjdump -sass``, by opcode) times the groups, over the
    card's INT32 rate (132 SMs x 64 lanes at ``clocks.max.sm``).

And for the package's wrapper, ``attention_fused.dropout_bits``: its
event ms, its kernels' device ms, and the device ms of the widening from
uint32 to int64 in one pass (``u.to(int64)``, the wrapper's) and in the
two an earlier wrapper took (``i32.to(int64) & 0xFFFFFFFF``), with both
results compared; and each design's event ms followed by the one pass,
as the wrapper runs it. ``--variants`` adds copies of the package's
source with one knob of the kernel turned (``VARIANTS``). The integer
count is the kernel's static one: a thread's work for a kernel that runs
straight through one group a thread (this design; not one that loops or
calls a division routine, as the first design did). One JSON line, with
the card's name and power limit. Needs a CUDA card and ``nvcc``; imports
nothing at import time that needs either.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
from typing import Dict, Optional

from end2end_asr_tpu_torch.tools import probe_lib as P

SOURCE = "attention.cu"
# {label: (B, H, Tq, Tk)}: the encoder self-attention at the 800- and the
# 1600-frame bucket (200 and 400 rows after the front end's 4x)
SHAPES = {"enc_800": (12, 8, 200, 200), "enc_1600": (12, 8, 400, 400)}
SEEDS = (0, 2 ** 64 - 1, 0xDEADBEEF_00C0FFEE)
HBM_BPS = 3.35e12
INT32_LANES = 64        # INT32 results an SM a clock (Hopper)
# vector integer opcodes (SASS, before the first '.'); the uniform
# datapath's (U...), memory, control and special-register ones are left out
INT_OPCODES = {"IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
               "LEA", "ISETP", "SEL", "IABS", "IMNMX", "VIMNMX", "PRMT",
               "MOV", "IMUL", "VIADD", "POPC", "FLO", "BREV"}
# copies of csrc/attention.cu with one knob of the bits kernel turned
# (--variants)
VARIANTS = {
    "plain_store": [("__stcs(reinterpret_cast<uint4*>(o),",
                     "__stwb(reinterpret_cast<uint4*>(o),")],
    "threads128": [("constexpr int BITS_THREADS = 256;",
                    "constexpr int BITS_THREADS = 128;")],
    "threads512": [("constexpr int BITS_THREADS = 256;",
                    "constexpr int BITS_THREADS = 512;")],
}
_SASS = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)")


def sass_opcodes(so: str, kernel: str) -> Optional[Dict[str, int]]:
    """{opcode: count} of the first function of library `so` whose
    mangled name holds `kernel` (None without cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = kernel in line
        elif inside:
            m = _SASS.search(line)
            if m and m.group(1) != "NOP":
                counts[m.group(1).split(".")[0]] += 1
    return dict(counts) if counts else None


def int_ops(opcodes: Optional[Dict[str, int]]) -> Optional[int]:
    """Vector integer instructions of one thread (one group of words)."""
    if opcodes is None:
        return None
    return sum(n for op, n in opcodes.items() if op in INT_OPCODES)


def max_sm_clock_hz() -> Optional[float]:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True)
    try:
        return float(r.stdout.strip().splitlines()[0]) * 1e6
    except (ValueError, IndexError):
        return None


def bound(B: int, H: int, Tq: int, Tk: int, ops_per_group: Optional[int],
          sms: int, clock_hz: Optional[float]) -> dict:
    """The least time for the bits of one call: bytes written over the
    memory rate, integer instructions over the INT32 rate."""
    t_bytes = 4 * B * H * Tq * Tk / HBM_BPS
    groups = B * H * Tq * (-(-Tk // 4))
    t_ops = (ops_per_group * groups / (sms * INT32_LANES * clock_hz)
             if ops_per_group and clock_hz else 0.0)
    return {"bytes_ms": 1e3 * t_bytes, "ops_ms": 1e3 * t_ops,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "groups": groups, "int_ops_per_group": ops_per_group}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", action="append", default=[],
                   help="another attention.cu (repeatable)")
    p.add_argument("--variants", default="",
                   help="comma-separated VARIANTS of the package's source")
    args = p.parse_args(argv)
    import torch
    from end2end_asr_tpu_torch.ops import attention_fused as AF
    from end2end_asr_tpu_torch.ops import cuda_lib
    if not torch.cuda.is_available():
        raise SystemExit("probe_dropout_bits: needs a CUDA device")
    dev = torch.device("cuda", 0)
    paths = [os.path.join(cuda_lib.CSRC_DIR, SOURCE)] + args.source
    with open(paths[0]) as f:
        src = f.read()
    names = [v for v in args.variants.split(",") if v]
    paths += [P.write_source(f"bits_{name}", text) for name, text in
              P.edited_copies(src, VARIANTS, names,
                              "probe_dropout_bits").items()]
    libs = P.build({path: path for path in paths}, "probe_dropout_bits")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = max_sm_clock_hz()
    stream = torch.cuda.current_stream().cuda_stream
    # the 16-byte-store instance where a design has two (Tk % 4 == 0 here)
    sass = {path: sass_opcodes(libs[path][0], "dropout_bits_kernelILb1E")
            or sass_opcodes(libs[path][0], "dropout_bits_kernel")
            for path in paths}
    out_json = {"shapes": {}, "sass_opcodes": sass, "sms": sms,
                "clocks_max_sm_hz": clock}
    for label, (B, H, Tq, Tk) in SHAPES.items():
        calls, bufs = {}, {}
        for path in paths:
            fn = getattr(ctypes.CDLL(libs[path][0]), AF.BITS.symbol)
            fn.argtypes, fn.restype = AF.BITS.argtypes, ctypes.c_int
            u = torch.empty(B, H * Tq, Tk, dtype=torch.int32, device=dev)
            bufs[path] = u

            def call(fn=fn, u=u, seed=SEEDS[-1]):
                if fn(u.data_ptr(), B, H, Tq, Tk, seed, stream):
                    raise RuntimeError("probe_dropout_bits: launch failed")
            calls[path] = call
        exact = {path: [] for path in paths}
        for seed in SEEDS:
            want = AF.dropout_bits_plain(seed, B, H, Tq, Tk, dev)
            for path in paths:
                calls[path](seed=seed)
                got = bufs[path].to(torch.int64) & 0xFFFFFFFF
                exact[path].append(bool(torch.equal(got, want)))
        res = P.time_in_turns(torch, calls)
        for path in paths:
            res[path]["bit_exact_at_seeds"] = exact[path]
            res[path]["bound"] = bound(B, H, Tq, Tk, int_ops(sass[path]),
                                       sms, clock)
        # the widening in two passes and in one (uint32 -> int64 may be
        # missing from a build), and the wrapper, which takes the one
        seed = SEEDS[-1]
        u32 = bufs[paths[0]]
        calls[paths[0]]()
        two = lambda: u32.to(torch.int64) & 0xFFFFFFFF
        one = lambda: u32.view(torch.uint32).to(torch.int64)
        wrap = lambda: AF.dropout_bits(seed, B, H, Tq, Tk, device=dev)
        wrapper = {"widen_two_passes_device_ms": P.device_ms(torch, two)}
        try:
            wrapper["one_pass_equals_two"] = bool(torch.equal(one(), two()))
            wrapper["widen_one_pass_device_ms"] = P.device_ms(torch, one)
            wrapper.update(
                equals_plain=bool(torch.equal(wrap(), AF.dropout_bits_plain(
                    seed, B, H, Tq, Tk, dev))),
                events_ms=P.events_ms(torch, wrap),
                kernels_ms=P.kernel_ms(torch, wrap))
            # each design as the wrapper runs it: the bits, then the one
            # pass that reads them
            for path in paths:
                res[path]["with_widening_events_ms"] = P.events_ms(
                    torch, lambda c=calls[path], u=bufs[path]: (
                        c(), u.view(torch.uint32).to(torch.int64)))
        except (RuntimeError, TypeError, NotImplementedError) as e:
            wrapper["one_pass_error"] = f"{type(e).__name__}: {e}"
        out_json["shapes"][label] = {"shape": [B, H, Tq, Tk],
                                     "designs": res, "wrapper": wrapper}
    out_json["gpu"] = P.gpu_line()
    out_json["ptxas"] = {path: lines for path, (_, lines) in libs.items()}
    print(json.dumps(out_json))


if __name__ == "__main__":
    main()
