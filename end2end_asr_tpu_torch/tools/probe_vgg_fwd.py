"""Where the block-1 forward (``vgg_block1_fwd``) spends its time.

    python -m end2end_asr_tpu_torch.tools.probe_vgg_fwd
        [--dtype bfloat16|float32] [--source path/to/vgg_block1.cu ...]
        [--no-package] [--cuts] [--shift]

Builds ``csrc/vgg_block1.cu`` and every file ``--source`` names (another
design of the same entry point, e.g. an earlier commit's file unpacked
with ``git show``) into libraries of their own, and calls each one's bf16
forward entry through ctypes at the main path's shape, 12 × 161 × 800, on
the same inputs: with the pool argmax (the training path) and without it
(the serving path). For each design and each of the two: the device time
of one call (torch.profiler, its kernels summed) and CUDA events around
back-to-back ctypes calls; the designs are timed in turns (a, b, ..., b,
a) and the smaller of the two readings is kept. Each design's output and
argmax are compared with the first design's.

``--cuts`` adds copies of the package's file with parts of the kernel
taken out (``CUTS``): ``staging`` keeps the persistent item loop, its
barriers, the input tiles and the output stores; ``conv1`` adds the x1
tiles built on the CUDA cores; ``conv1_conv2`` adds the tensor-core
products; the package's file adds the pool epilogue (``part_ms``: each
line's time less the previous line's, what that part adds on top).
``conv2_epilogue`` is the products and the epilogue without conv1: the
products' warpgroups alone. The copies compute wrong outputs; only their
times are kept.

``--shift`` runs the shared-memory descriptor check the kernel's design
rests on: one ``wgmma`` whose B operand starts 0, 1 or 2 rows of 128
bytes into a 128-byte-swizzled tile, with the descriptor's base offset 0
or the start row, against the product computed on the host.

``--dtype float32`` times the f32 entry instead: the package's
(``csrc/vgg_block1_f32.cu``), each ``--source`` file's (an earlier commit's
``vgg_block1.cu``, whose f32 entry takes the same arguments) and cuDNN's
conv2d x2 + max_pool2d on the same inputs (NCHW, TF32 off), in turns,
device ms by kernel name; each entry's output is held against the plain
version, and the executed TFLOP/s are the package's products (``f32_gflop``)
over each one's device time. No cuts at f32.

One JSON line, with the card's name and power limit and ptxas's
registers and spills. Needs a CUDA card and ``nvcc``; imports nothing at
import time that needs either.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
from typing import Dict

from end2end_asr_tpu_torch.tools import probe_lib as P

SOURCES = {"bfloat16": "vgg_block1.cu", "float32": "vgg_block1_f32.cu"}
SOURCE = SOURCES["bfloat16"]

# the kernel's parts, each cut by replacing lines of the source
CUT_PARTS = {
    # the pool, bias, relu and argmax (the stores keep a raw sum's bits)
    "epilogue": [("        pool_window(acc, b0, b2v, v, id);\n",
                  "        { const uint32_t u = __float_as_uint(acc[4 * b0]);\n"
                  "          v = *reinterpret_cast<const __nv_bfloat162*>(&u);\n"
                  "          id[0] = id[1] = 0; }\n")],
    # the tensor-core products (the accumulators get distinct values)
    "conv2": [("        conv2_products(acc, w2d, x1d);\n",
               "#pragma unroll\n"
               "        for (int i = 0; i < 64; ++i)\n"
               "          acc[i] = __uint_as_float((i ^ tid) | 0x3f800000u);\n")],
    # the x1 tiles built on the CUDA cores
    "conv1": [("        build_x1(xs_cur, wr, bp, x1b, w, F, T, ptid);\n",
               "")],
}
# each copy cuts the parts it names
CUTS = {"staging": ("conv1", "conv2", "epilogue"),
        "conv1": ("conv2", "epilogue"),
        "conv1_conv2": ("epilogue",),
        "conv2_epilogue": ("conv1",)}
CHAIN = ("staging", "conv1", "conv1_conv2")
B, F, T = 12, 161, 800   # the main path's shape

SHIFT_SRC = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t desc(const void* p, int base) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)(base & 7) << 49) | (1ull << 62);
}

// D (64 x 16) = A (64 x 64, [m][k]) . B rows dt .. dt+15 ([n][k])^T, both
// operands in 128-byte-swizzled tiles on 1024-byte boundaries
__global__ void shift_probe_kernel(const __nv_bfloat16* a,
                                   const __nv_bfloat16* b, float* d, int dt,
                                   int base) {
  __shared__ __align__(1024) __nv_bfloat16 as[64 * 64];
  __shared__ __align__(1024) __nv_bfloat16 bs[32 * 64];
  const int tid = threadIdx.x;
  for (int e = tid; e < 64 * 8; e += 128) {
    const int r = e >> 3, c = e & 7;
    *reinterpret_cast<uint4*>(as + r * 64 + ((c ^ (r & 7)) << 3)) =
        reinterpret_cast<const uint4*>(a)[e];
  }
  for (int e = tid; e < 32 * 8; e += 128) {
    const int r = e >> 3, c = e & 7;
    *reinterpret_cast<uint4*>(bs + r * 64 + ((c ^ (r & 7)) << 3)) =
        reinterpret_cast<const uint4*>(b)[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint64_t da = desc(as + kc * 16, 0);
    const uint64_t db = desc(bs + dt * 64 + kc * 16, base ? dt : 0);
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
          "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7])
        : "l"(da), "l"(db), "r"(1));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  const int w = tid >> 5, l = tid & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      d[(16 * w + (l >> 2) + 8 * (r >> 1)) * 16 + 8 * i + 2 * (l & 3) +
        (r & 1)] = acc[4 * i + r];
}

extern "C" int shift_probe(const void* a, const void* b, void* d, int dt,
                           int base) {
  shift_probe_kernel<<<1, 128>>>((const __nv_bfloat16*)a,
                                 (const __nv_bfloat16*)b, (float*)d, dt,
                                 base);
  return cudaGetLastError();
}
"""

def cut(src: str, name: str) -> str:
    for old, new in (c for part in CUTS[name] for c in CUT_PARTS[part]):
        if old not in src:
            raise RuntimeError(f"probe_vgg_fwd: {old.strip()!r} is not in "
                               "the source; update the probe")
        src = src.replace(old, new)
    return src


def f32_gflop(B: int, F: int, T: int) -> float:
    """GFLOP the f32 forward executes: conv2 over its tiles (the source's
    TR x TC) of the 2 Fp x 2 Tp positions the pool keeps, conv1 over each
    tile's halo."""
    from end2end_asr_tpu_torch.ops import cuda_lib
    k = P.constexprs(os.path.join(cuda_lib.CSRC_DIR, SOURCES["float32"]))
    tr, tc = k["TR"], k["TC"]
    nf, nt = -(-(F // 2 * 2) // tr), -(-(T // 2 * 2) // tc)
    conv2 = 2 * B * nf * tr * nt * tc * 64 * 576
    conv1 = 2 * B * nf * nt * (tr + 2) * (tc + 2) * 64 * 9
    return (conv2 + conv1) / 1e9


def f32_main(args, torch, dev, out_json):
    """--dtype float32: the package's f32 entry, each --source file's and
    cuDNN's, in turns."""
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    if args.cuts or args.shift:
        raise SystemExit("probe_vgg_fwd: no --cuts or --shift at float32")
    torch.backends.cudnn.allow_tf32 = False
    named = {} if args.no_package else {
        "package": os.path.join(cuda_lib.CSRC_DIR, SOURCES["float32"])}
    named.update({f"source{i}": s for i, s in enumerate(args.source)})
    libs = P.build(named, "probe_vgg_fwd_f32")
    g0 = torch.Generator().manual_seed(0)
    spect = torch.randn(B, F, T, generator=g0).to(dev)
    ws = [(torch.randn(*s, generator=g0) * sc).to(dev)
          for s, sc in (((3, 3, 1, 64), 0.3), ((64,), 0.1),
                        ((3, 3, 64, 64), 0.05), ((64,), 0.1))]
    want, want_idx = V.vgg_block1_plain(spect, *ws, cdt=torch.float32)
    pooled = (B, F // 2, T // 2, 64)
    stream = torch.cuda.current_stream().cuda_stream
    kernel = V._KERNELS[torch.float32]
    calls, outs = {}, {}
    for name, (so, _) in libs.items():
        fn = P.bind(so, kernel)
        out = torch.empty(pooled, device=dev)
        idx = torch.empty(pooled, dtype=torch.uint8, device=dev)
        outs[name] = (out, idx)
        for mode, ip in (("idx", idx.data_ptr()), ("no_idx", None)):
            def call(fn=fn, out=out, ip=ip, name=name):
                if fn(spect.data_ptr(), *(w.data_ptr() for w in ws),
                      out.data_ptr(), ip, B, F, T, stream):
                    raise RuntimeError(f"probe_vgg_fwd: {name} failed")
            calls[name + ("" if mode == "idx" else ":no_idx")] = call
    xs = spect[:, None]
    w1c, w2c = (w.permute(3, 2, 0, 1).contiguous() for w in (ws[0], ws[2]))
    calls["library"] = lambda: torch.relu(Fn.max_pool2d(Fn.conv2d(
        torch.relu(Fn.conv2d(xs, w1c, ws[1], padding=1)), w2c, padding=1),
        2) + ws[3][None, :, None, None])
    res = P.time_in_turns(torch, calls)
    checks = {}
    for name, (out, idx) in outs.items():
        calls[name]()
        torch.cuda.synchronize()
        checks[name] = {
            "max_abs_err": (out - want).abs().max().item(),
            "idx_equal_share": (idx == want_idx).float().mean().item()}
    out_json.update(dtype="float32", shape=[B, F, T], sources=named,
                    **P.turns_json(res, f32_gflop(B, F, T)), checks=checks,
                    ptxas={n: libs[n][1] for n in libs})


def shift_check(torch, dev) -> Dict[str, bool]:
    """{"dt=<d> base=<0|1>": the product matched} for d = 0, 1, 2."""
    path = P.write_source("probe_vgg_fwd_shift", SHIFT_SRC)
    so = P.build({"shift": path}, "probe_vgg_fwd")["shift"][0]
    fn = ctypes.CDLL(so).shift_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    g = torch.Generator().manual_seed(5)
    # small integers: every product and sum is exact in f32
    a = torch.randint(-3, 4, (64, 64), generator=g).to(dev, torch.bfloat16)
    b = torch.randint(-3, 4, (32, 64), generator=g).to(dev, torch.bfloat16)
    res = {}
    for dt in (0, 1, 2):
        want = a.float() @ b[dt:dt + 16].float().T
        for base in (0, 1):
            d = torch.full((64, 16), float("nan"), device=dev)
            if fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), dt, base):
                raise RuntimeError("probe_vgg_fwd: shift probe launch failed")
            torch.cuda.synchronize()
            res[f"dt={dt} base={base}"] = bool(torch.equal(d, want))
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", action="append", default=[],
                   help="another vgg_block1.cu (repeatable)")
    p.add_argument("--no-package", action="store_true",
                   help="leave the package's csrc/vgg_block1.cu out")
    p.add_argument("--cuts", action="store_true",
                   help="add the package's file with parts cut out")
    p.add_argument("--shift", action="store_true",
                   help="run the descriptor shift check")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="the entry to time")
    args = p.parse_args(argv)
    import torch
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    if not torch.cuda.is_available():
        raise SystemExit("probe_vgg_fwd: needs a CUDA device")
    dev = torch.device("cuda", 0)
    out_json = {}
    if args.dtype == "float32":
        f32_main(args, torch, dev, out_json)
        out_json["gpu"] = P.gpu_line()
        print(json.dumps(out_json))
        return
    if args.shift:
        out_json["shift"] = shift_check(torch, dev)
    package = os.path.join(cuda_lib.CSRC_DIR, SOURCE)
    named = {} if args.no_package else {"package": package}
    named.update({f"source{i}": s for i, s in enumerate(args.source)})
    if args.cuts:
        with open(package) as f:
            src = f.read()
        for name in CUTS:
            named[f"cut_{name}"] = P.write_source(f"fwd_cut_{name}",
                                                  cut(src, name))
    if named:
        libs = P.build(named, "probe_vgg_fwd")
        g0 = torch.Generator().manual_seed(0)
        spect = torch.randn(B, F, T, generator=g0).to(dev)
        w1, b1, w2, b2 = [(torch.randn(*s, generator=g0) * sc).to(dev)
                          for s, sc in (((3, 3, 1, 64), 0.3), ((64,), 0.1),
                                        ((3, 3, 64, 64), 0.05),
                                        ((64,), 0.1))]
        w2p = w2.to(torch.bfloat16).permute(0, 1, 3, 2).contiguous()
        pooled = (B, F // 2, T // 2, 64)
        stream = torch.cuda.current_stream().cuda_stream
        kernel = V._KERNELS[torch.bfloat16]
        calls, outs = {}, {}
        for name, (so, _) in libs.items():
            fn = P.bind(so, kernel)
            out = torch.empty(pooled, dtype=torch.bfloat16, device=dev)
            idx = torch.empty(pooled, dtype=torch.uint8, device=dev)
            outs[name] = (out, idx)
            for mode, ip in (("idx", idx.data_ptr()), ("no_idx", None)):
                def call(fn=fn, out=out, ip=ip):
                    if fn(spect.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                          w2p.data_ptr(), b2.data_ptr(), out.data_ptr(), ip,
                          B, F, T, stream):
                        raise RuntimeError("probe_vgg_fwd: launch failed")
                calls[(name, mode)] = call
        res = {name: {"device_ms": {}, "events_ms": {}} for name in libs}
        order = list(calls)
        for turn in (order, order[::-1]):
            for key in turn:
                name, mode = key
                r = res[name]
                r["device_ms"].setdefault(mode, []).append(
                    P.device_ms(torch, calls[key]))
                r["events_ms"].setdefault(mode, []).append(
                    P.events_ms(torch, calls[key]))
        torch.cuda.synchronize()
        first = next(iter(libs))
        ref_out, ref_idx = outs[first]
        for name, r in res.items():
            r["device_ms_all"] = r["device_ms"]
            r["device_ms"] = {m: min(v) for m, v in r["device_ms"].items()}
            r["events_ms"] = {m: min(v) for m, v in r["events_ms"].items()}
            r["ptxas"] = libs[name][1]
            if not name.startswith("cut_"):
                o, i = outs[name]
                r["max_abs_diff_to_first"] = (
                    o.float() - ref_out.float()).abs().max().item()
                r["idx_equal_to_first"] = (i == ref_idx).float().mean(
                ).item()
        out_json.update(shape=[B, F, T], sources=named, results=res)
        if args.cuts:
            t = [res[f"cut_{n}"]["device_ms"]["idx"] for n in CHAIN]
            t.append(res["package"]["device_ms"]["idx"])
            names = list(CHAIN) + ["full"]
            out_json["part_ms"] = {n: t[i] - (t[i - 1] if i else 0.0)
                                   for i, n in enumerate(names)}
    out_json["gpu"] = P.gpu_line()
    print(json.dumps(out_json))


if __name__ == "__main__":
    main()
