"""Where the block-2 backward (``vgg_block2_bwd``) spends its time.

    python -m end2end_asr_tpu_torch.tools.probe_vgg2_bwd
        [--dtype bfloat16|float32] [--source path/to/vgg_block2.cu ...]
        [--parts staging,x2,...] [--phases] [--mma-rate]
        [--variants all|conv_kc8,...]

The card's profiler gives kernel durations but no stall reasons, so this
probe builds cut-down copies of the package's source (``csrc/vgg_block2.cu``
for bf16, ``csrc/vgg_block2_f32.cu`` for f32) and of every file
``--source`` names (another design of the same entry, e.g. the parent
commit's file unpacked with ``git show``), and times the entry of each at
the main path's shape, x (B, 80, 400, 64), each copy's kernels by name,
all of them in turns (a, b, ..., b, a). The bf16 copies add one part of the
work at a time:

  staging   the item loop and its barriers, the x tile and the pooled
            g / out / idx loads (and the dy4 tile built from them), the
            partial sums written; no product, no second kernel
  x2        + conv3 recomputed (x2 and its relu)
  dw4       + the dW4 products
  dx2       + dx2 = W4^T . dy4, masked by x2 > 0: dy3
  dw3       + the dW3 products
  kernel_x  + the dx kernel (dx = W3^T . dy3, from dy3 in device memory)
  full      + the reduction of the partial sums: the kernel as shipped

Each line's device time less the previous line's is that part's cost
where the parts run one after another; where two run at once, the later
part's line gives what it adds on top. At f32 only ``full`` is built (the
entry's kernels run one after another, and ``kernels_ms`` times each by
name); every design is called with the same arguments, the scratch sized
for the largest (three activations of (B, F, T, 128) at f32: x2, dy4 and
dy3; the earlier f32 design uses the first as dy3). ``--phases`` also
builds a copy of the bf16 row-walking pass with clock64 counters at its
barriers and reports the cycles an item spends in each phase (warp 0's
view, barrier waits included) and each warp's phase-1 work, summed over
the blocks' items. ``--mma-rate`` also times what an SM sustains of
mma.sync m16n8k16 on register operands, of ldmatrix.x4 alone, and of
loads feeding products at 1, 1/2 and 1/4 of a load a product
(``RATE_ARMS``). The cuts put ``if (false)`` before a statement of the
row-walking source (a cut tile keeps what it held: the later products run
on whatever it holds); every line must be found, so a change of the
source breaks the probe loudly (``--parts full`` cuts nothing and takes
any source). Each uncut copy is also held against the plain backward
(relative L2 per tensor). At f32, ``--variants`` also builds copies of
the package's source with one design choice changed (``F32_VARIANTS``: a
tile's shared-memory loads cut, the K chunk, the column slots, the wgrad
loop's unrolling and stages, the number of K ranges) and times them in
the same turns. One JSON line, with the card's name and power limit. Needs a CUDA card and ``nvcc``; imports nothing at import time that
needs either.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from typing import Dict, List, Tuple

from end2end_asr_tpu_torch.tools import probe_lib as P

SOURCE = "vgg_block2.cu"
SOURCE_F32 = "vgg_block2_f32.cu"
B, F, T = 12, 80, 400  # the train cell's x (PERF.md §4)
PARTS = ("staging", "x2", "dw4", "dx2", "dw3", "kernel_x", "full")


def _off(stmt: str) -> Tuple[str, str]:
    """A cut: the statement that starts with `stmt` is never run."""
    indent = stmt[:len(stmt) - len(stmt.lstrip())]
    return stmt, f"{indent}if (false) {stmt.lstrip()}"


# {part: the cuts that part lifts} in the row-walking design:
# vgg_block2_bwd_rows_kernel (persistent blocks walking down column strips)
# and vgg_block2_bwd_dx_kernel (dx, which first adds up the partial sums:
# "full" lifts that part)
CUTS = {
    "x2": [_off("      x2_products(xs, w3s, x2s, b3s, warm, r, c0, F, Tn, "
                "warp, lane);")],
    "dw4": [_off("    dw4_products(x2s, dys, acc4, r, warp, lane);")],
    "dx2": [_off("      dx2_products(dys, w4s, dxs, r, warp, lane);"),
            _off("    mask_dy3(dxs, x2s, d3s, r, tid, RT);")],
    "dw3": [_off("    dw3_products(xs, d3s, acc3, r, warp, lane);")],
    "kernel_x": [_off("  vgg_block2_bwd_dx_kernel<<<DX_BLOCKS, DX_THREADS, "
                      "DX_SMEM, s>>>(")],
    "full": [_off("  reduce_partials(part, grads, nparts);")],
}


def variants(src: str, parts=PARTS) -> Dict[str, str]:
    """{part: the source with every part after it cut}, for `parts`."""
    out = {}
    for i, part in enumerate(PARTS):
        if part not in parts:
            continue
        v = src
        for later in PARTS[i + 1:]:
            for old, new in CUTS[later]:
                if old not in v:
                    raise RuntimeError(f"probe_vgg2_bwd: {old.strip()!r} is "
                                       "not in the source; update the probe")
                v = v.replace(old, new)
        out[part] = v
    return out


# ---- --variants (f32): copies of vgg_block2_f32.cu with one design choice
# changed, timed in turns with the source as shipped, so that what each
# choice buys is measured. The load cuts replace a tile's shared-memory
# loads by register constants: their outputs are wrong, their time is kept
_CONV_A = "          a[i] = lds4(ap + (prow(i) * HC + pcol(i)) * PA + kk);"
_CONV_B = ("          const float4 b0 = lds4(wp + (kk + k) * C::NOUT);\n"
           "          const float4 b1 = lds4(wp + (kk + k) * C::NOUT + 32);")
_WG_A = ("    const float4 a0 = lds4(ap + p * C2), a1 = lds4(ap + p * C2 + "
         "32);")
_WG_B = ("      const float4 b = lds4(bp + p * C2 + 16 * q);\n"
         "      bv[4 * q] = b.x;")
_WG_LOOP = ("#pragma unroll 8\n  for (int p = 0; p < KP; ++p) {\n"
            "    const float4 a0")
F32_VARIANTS = {
    "conv_no_a_loads": [(_CONV_A, "          a[i] = make_float4(i, kk, 1.f, "
                                  "2.f);")],
    "conv_no_b_loads": [(_CONV_B, "          const float4 b0 = make_float4("
                                  "k, kk, 1.f, 2.f);\n          const float4 "
                                  "b1 = make_float4(kk, k, 2.f, 1.f);")],
    "wgrad_no_a_loads": [(_WG_A, "    const float4 a0 = make_float4(p, 1.f, "
                                 "2.f, 3.f), a1 = make_float4(3.f, p, 1.f, "
                                 "2.f);")],
    "wgrad_no_b_loads": [(_WG_B, "      const float4 b = make_float4(p, q, "
                                 "1.f, 2.f);\n      bv[4 * q] = b.x;")],
    "conv_kc8": [("  static constexpr int KC = 16;",
                  "  static constexpr int KC = 8;")],
    "conv_cslot6": [("constexpr int CSLOT = 4;", "constexpr int CSLOT = 6;")],
    **{f"wgrad_unroll{n}": [(_WG_LOOP, _WG_LOOP.replace("8", str(n)))]
       for n in (1, 2, 4)},
    "wgrad_stages2": [("constexpr int WG_NST = 3;",
                       "constexpr int WG_NST = 2;")],
    "splits66": [("constexpr int SPLITS = 132;",
                  "constexpr int SPLITS = 66;")],
}


def f32_variants(src: str, names) -> Dict[str, str]:
    """{name: the f32 source with that variant's edits}, for `names`."""
    return P.edited_copies(src, F32_VARIANTS, names, "probe_vgg2_bwd")


# ---- --phases: clock64 counters at the row pass's barriers (warp 0 sums
# each phase, every warp its phase-1 work), read back through two C entries
_PHASES = ("top_wait", "build", "issue_copies", "phase1", "phase2",
           "phase3")
_PHASE_CUTS = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_ph[32];\n"
     "}\nextern \"C\" int probe_phases(void* dst) {\n  return "
     "cudaMemcpyFromSymbol(dst, g_ph, sizeof(g_ph));\n}\nextern \"C\" int "
     "probe_phases_zero() {\n  unsigned long long z[32] = {0};\n  return "
     "cudaMemcpyToSymbol(g_ph, z, sizeof(z));\n}\nnamespace {\n"),
    ("    // the first item of a strip (or of the block) stages its halo rows "
     "too\n", "    // the first item of a strip (or of the block) stages its "
     "halo rows too\n    if (it == lo) tt = clock64();\n"),
    ("  for (long it = lo; it < hi; ++it) {\n    const int r = (int)(it % Fp);"
     "\n    const int c0 = (int)((it / Fp) % chunks) * RW;\n",
     "  unsigned long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tt = 0, t1 = 0;\n"
     "#define PH(k) { const unsigned long long n_ = clock64(); ph[k] += n_ - tt;"
     " tt = n_; }\n  for (long it = lo; it < hi; ++it) {\n    const int r = "
     "(int)(it % Fp);\n    const int c0 = (int)((it / Fp) % chunks) * RW;\n"),
    ("    __syncthreads();  // this item's x rows and pooled rows have landed\n",
     "    __syncthreads();  // this item's x rows and pooled rows have landed\n"
     "    PH(0)\n"),
    ("    __syncthreads();  // dy4 rows 2r-1 .. 2r+3 built; raw consumed\n",
     "    __syncthreads();  // dy4 rows 2r-1 .. 2r+3 built; raw consumed\n"
     "    PH(1)\n"),
    ("    cp_async_commit();\n\n    if (warp < DX2_WARPS) {",
     "    cp_async_commit();\n    PH(2) t1 = tt;\n\n    if (warp < DX2_WARPS) {"),
    ("    __syncthreads();  // x2 rows 2r+1, 2r+2 and dx2's halves written\n",
     "    ph[6] += clock64() - t1;\n    __syncthreads();  // x2 rows 2r+1, 2r+2 "
     "and dx2's halves written\n    PH(3)\n"),
    ("    __syncthreads();  // dy3 written; x2 and dy4 read\n",
     "    __syncthreads();  // dy3 written; x2 and dy4 read\n    PH(4)\n"),
    ("  }\n  cp_async_wait_all();\n\n  // the block's partial sums",
     "    PH(5)\n  }\n  cp_async_wait_all();\n  if (lane == 0) {\n"
     "    if (warp == 0) {\n      for (int k = 0; k < 6; ++k) "
     "atomicAdd(&g_ph[k], ph[k]);\n      atomicAdd(&g_ph[20], "
     "(unsigned long long)(hi - lo));\n    }\n    atomicAdd(&g_ph[8 + warp], "
     "ph[6]);\n  }\n\n  // the block's partial sums"),
]


def phases_source(src: str) -> str:
    """The row pass with its phase counters (the full source otherwise)."""
    for old, new in _PHASE_CUTS:
        if src.count(old) != 1:
            raise RuntimeError(f"probe_vgg2_bwd: {old.strip()!r} is not in "
                               "the source once; update the probe")
        src = src.replace(old, new)
    return src


# ---- --mma-rate: what one SM sustains of mma.sync m16n8k16 (bf16, f32
# accumulate) and of ldmatrix.x4, alone and with the loads feeding the
# products as the row pass's do; one block an SM (its shared memory keeps a
# second off), cycles by clock64 (the slowest warp of each block)
_RATE_SRC = r"""
#include <cuda_bf16.h>
#include <stdint.h>
namespace {
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm(const void* p, uint32_t* r) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// LD ldmatrix.x4 and MM mma.sync an iteration; product m takes load
// m % LD's result as its A operand (none: registers)
template <int LD, int MM>
__global__ void rate(float* sink, unsigned long long* cyc, int iters,
                     int stride) {
  extern __shared__ uint4 sm4[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(sm4);
  for (int i = threadIdx.x; i < 256 * 72; i += blockDim.x)
    tile[i] = __float2bfloat16((i % 7) * 0.01f);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // rows of 144 bytes (the 8 rows of a matrix hit distinct banks), 16 row
  // blocks; a load's block moves by a stride the compiler cannot see, so no
  // two loads can be merged
  const __nv_bfloat16* p = tile + (lane & 15) * 72 + (lane >> 4) * 8;
  int off = 0;
  uint32_t a[4] = {0x3c003c00u, 0x3c003c00u ^ lane, 0x3c003c00u, 0x3c00u};
  uint32_t r[LD > 0 ? LD : 1][4], ck = 0;
  float acc[8][4];
  for (int m = 0; m < 8; ++m)
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
  const unsigned long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int l = 0; l < LD; ++l) ldsm(p + ((off + l) & 15) * 16 * 72, r[l]);
    off += stride;
#pragma unroll
    for (int m = 0; m < MM; ++m)
      mma(acc[m & 7], LD ? r[m % (LD > 0 ? LD : 1)] : a, 0x3c003c00u,
          0x3c003c00u);
    if (MM == 0)
#pragma unroll
      for (int l = 0; l < LD; ++l) ck ^= r[l][0];
  }
  const unsigned long long t1 = clock64();
  float s = (float)ck;
  for (int m = 0; m < 8; ++m)
    for (int i = 0; i < 4; ++i) s += acc[m][i];
  atomicAdd(sink, s);
  atomicMax(cyc + blockIdx.x, t1 - t0);
}
template <int LD, int MM>
int run(int warps, int blocks, int iters, float* sink,
        unsigned long long* cyc) {
  const int smem = 200 * 1024;
  cudaFuncSetAttribute(rate<LD, MM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rate<LD, MM><<<blocks, 32 * warps, smem>>>(sink, cyc, iters, LD + 1);
  return cudaGetLastError();
}
}  // namespace
// the arms: 0 mma alone; 1 ldmatrix alone; 2, 3, 4 one load feeding 1, 2,
// 4 products (the row pass's x2 products: 1)
extern "C" int rate_run(int arm, int warps, int blocks, int iters,
                        float* sink, unsigned long long* cyc) {
  switch (arm) {
    case 0: return run<0, 8>(warps, blocks, iters, sink, cyc);
    case 1: return run<8, 0>(warps, blocks, iters, sink, cyc);
    case 2: return run<2, 2>(warps, blocks, iters, sink, cyc);
    case 3: return run<1, 2>(warps, blocks, iters, sink, cyc);
    default: return run<1, 4>(warps, blocks, iters, sink, cyc);
  }
}
"""
# {arm: (ldmatrix.x4, mma.sync) an iteration}, as rate_run numbers them
RATE_ARMS = {"mma": (0, 8), "ldmatrix": (8, 0), "fed_1_per_mma": (2, 2),
             "fed_1_per_2": (1, 2), "fed_1_per_4": (1, 4)}
RATE_ITERS = 4096


def mma_rate(torch, so: str) -> Dict[str, dict]:
    """{arm@warps: cycles an mma.sync on one SM sub-partition, ldmatrix
    bytes a cycle on one SM, TFLOP/s for the card (events)}."""
    lib = ctypes.CDLL(so)
    fn = lib.rate_run
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1, device="cuda")
    cyc = torch.zeros(sms, dtype=torch.int64, device="cuda")
    out = {}
    for arm, (name, (ld, mm)) in enumerate(RATE_ARMS.items()):
        for warps in ((4, 8, 12, 16) if name == "mma" else (12,)):
            ms = []
            for _ in range(3):
                cyc.zero_()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                if fn(arm, warps, sms, RATE_ITERS, sink.data_ptr(),
                      cyc.data_ptr()):
                    raise RuntimeError("probe_vgg2_bwd: the rate kernel "
                                       "failed")
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            cycles = cyc.double().mean().item()
            n_mma = warps * RATE_ITERS * mm  # a block's
            n_ld = warps * RATE_ITERS * ld
            out[f"{name}@{warps}"] = {
                "cycles_per_mma_per_subpartition":
                    cycles / (n_mma / 4) if mm else None,
                "ldmatrix_bytes_per_cycle_per_sm":
                    n_ld * 512 / cycles if ld else None,
                "tflops": n_mma * sms * 4096 / (min(ms) * 1e9) if mm
                else None}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="the entry to time")
    p.add_argument("--source", action="append", default=[],
                   help="another source of the entry (repeatable), timed "
                        "in turns with the package's")
    p.add_argument("--parts", default=None,
                   help="comma-separated parts to build and time (default: "
                        "all in bf16; f32 takes full only)")
    p.add_argument("--phases", action="store_true",
                   help="also the bf16 row pass's cycles by phase (clock64)")
    p.add_argument("--mma-rate", action="store_true",
                   help="also the card's mma.sync and ldmatrix rates")
    p.add_argument("--variants", default=None,
                   help="f32: comma-separated F32_VARIANTS to time beside "
                        "the package's source, or 'all'")
    args = p.parse_args(argv)
    import torch
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    if not torch.cuda.is_available():
        raise SystemExit("probe_vgg2_bwd: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = args.dtype == "float32"
    parts = args.parts.split(",") if args.parts else (
        ["full"] if f32 else list(PARTS))
    if f32 and (parts != ["full"] or args.phases):
        raise SystemExit("probe_vgg2_bwd: at float32 only --parts full, "
                         "and no --phases (they count the bf16 row pass)")
    if args.variants and not f32:
        raise SystemExit("probe_vgg2_bwd: --variants edit the f32 source")
    chosen = ([] if not args.variants else list(F32_VARIANTS)
              if args.variants == "all" else args.variants.split(","))
    package = os.path.join(cuda_lib.CSRC_DIR, SOURCE_F32 if f32 else SOURCE)
    designs = {"package": package}
    designs.update({f"source{i}": s for i, s in enumerate(args.source)})
    named = {}
    for d, path in designs.items():
        with open(path) as f:
            src = f.read()
        for part, v in variants(src, parts).items():
            named[f"{d}:{part}"] = P.write_source(
                f"probe_vgg2_bwd_{args.dtype}_{d}_{part}", v)
        if d == "package":
            for name, v in f32_variants(src, chosen).items():
                named[f"{name}:full"] = P.write_source(
                    f"probe_vgg2_bwd_variant_{name}", v)
    if args.phases:
        with open(os.path.join(cuda_lib.CSRC_DIR, SOURCE)) as f:
            named["phases"] = P.write_source("probe_vgg2_bwd_phases",
                                             phases_source(f.read()))
    if args.mma_rate:
        named["rate"] = P.write_source("probe_vgg2_bwd_rate", _RATE_SRC)
    libs = P.build(named, "probe_vgg2_bwd")
    phase_lib = libs.pop("phases", None)
    rate_lib = libs.pop("rate", None)

    cdt = torch.float32 if f32 else torch.bfloat16
    g0 = torch.Generator().manual_seed(0)
    x = torch.randn(B, F, T, 64, generator=g0).relu().to(dev, cdt)
    ws = [(torch.randn(*s, generator=g0) * sc).to(dev) for s, sc in
          (((3, 3, 64, 128), (2 / 576) ** 0.5), ((128,), 0.1),
           ((3, 3, 128, 128), (2 / 1152) ** 0.5), ((128,), 0.1))]
    # the plain forward: the probe builds nothing but its own copies
    out, idx = V.vgg_block2_plain(x, *ws, cdt=cdt)
    g = torch.randn(out.shape, generator=g0).to(dev, cdt)
    # the bf16 entry reads w3 "t", w4 "n", w3 "n"; the f32 entries (this
    # design's and the earlier per-tile one's) the other layouts
    w3c, w4d, w3d = (V._layout(ws[0], cdt, not f32),
                     V._layout(ws[2], cdt, f32), V._layout(ws[0], cdt, f32))
    scratch = torch.empty((V.BWD2_SCRATCH[cdt], B, F, T, 128), dtype=cdt,
                          device=dev)
    dx = torch.empty_like(x)
    # room for the partials of any design (256 rows at most)
    part = torch.empty(256 * V.PART2, device=dev)
    grads = torch.empty(V.PART2, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    kernel = V._BWD2_KERNELS[cdt]

    def entry(so):
        fn = P.bind(so, kernel)
        return lambda: fn(x.data_ptr(), w3c.data_ptr(), ws[1].data_ptr(),
                          w4d.data_ptr(), w3d.data_ptr(), g.data_ptr(),
                          out.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
                          dx.data_ptr(), part.data_ptr(), grads.data_ptr(),
                          B, F, T, stream)
    calls, regs = {}, {}
    for name, (so, regs[name]) in libs.items():
        def call(run=entry(so), name=name):
            if run():
                raise RuntimeError(f"probe_vgg2_bwd: {name} failed")
        calls[name] = call
    want = V.vgg_block2_bwd_plain(x, *ws[:3], out, idx, g, cdt)
    o1, o2, o3 = V.DW3_SIZE, V.DW3_SIZE + V.C2, V.DW3_SIZE + V.C2 + V.DW4_SIZE
    checks = {}
    for name in calls:
        if not name.endswith(":full") or name.split(":")[0] not in designs:
            continue
        calls[name]()
        got = (dx, grads[:o1], grads[o1:o2], grads[o2:o3], grads[o3:])
        checks[name] = [((a.double() - b.double().reshape(a.shape)).norm()
                         / b.double().norm()).item()
                        for a, b in zip(got, want)]
    phases = None
    if phase_lib is not None:
        lib = ctypes.CDLL(phase_lib[0])
        run = entry(phase_lib[0])
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        if lib.probe_phases_zero() or any(run() for _ in range(5)):
            raise RuntimeError("probe_vgg2_bwd: the phase copy failed")
        torch.cuda.synchronize()
        if lib.probe_phases(buf):
            raise RuntimeError("probe_vgg2_bwd: reading the phases failed")
        items = buf[20]
        phases = {"cycles_per_item": {k: buf[i] / items
                                      for i, k in enumerate(_PHASES)},
                  "phase1_cycles_per_item_by_warp": [
                      buf[8 + w] / items for w in range(12)],
                  "sm_clocks": subprocess.run(
                      ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip(),
                  "ptxas": phase_lib[1]}
    rates = mma_rate(torch, rate_lib[0]) if rate_lib else None
    res = P.time_in_turns(torch, calls)
    dev_ms = {n: r["device_ms"] for n, r in res.items()}
    part_ms = {}
    for d in designs:
        chain = [f"{d}:{pt}" for pt in PARTS if f"{d}:{pt}" in dev_ms]
        part_ms[d] = {n.split(":")[1]: dev_ms[n] - (dev_ms[chain[i - 1]]
                                                    if i else 0.0)
                      for i, n in enumerate(chain)}
    print(json.dumps({
        "dtype": args.dtype, "sources": designs, "shape": [B, F, T, 64],
        "gpu": P.gpu_line(), **P.turns_json(res), "part_ms": part_ms,
        "full_rel_l2_dx_dw3_db3_dw4_db4": checks,
        "phases": phases, "mma_rate": rates, "ptxas": regs}))


if __name__ == "__main__":
    main()
