"""Where the bf16 block-1 backward (``vgg_block1_bwd``) spends its time.

    python -m end2end_asr_tpu_torch.tools.probe_vgg_bwd [--batch 12]
        [--source path/to/vgg_block1.cu]

The card's profiler here gives kernel durations but no stall reasons, so
this probe builds cut-down copies of ``csrc/vgg_block1.cu`` (or of the
file ``--source`` names) and times the bf16 entry of each at the main
path's shape, B × 161 × 800. The copies add one part of the work at a time:

  staging   the persistent item loop and its barriers, the input tile and
            the pooled g / out / idx loads, the partial sums written and
            added up; in the two-kernel design also the dy2 tiles formed
            from the loads (its loads have no other use: a copy without
            dy2 would lose them)
  dy2       (the fused design) + the dy2 tile and dW1's im2col tile built
            from the staged inputs
  x1        + conv1 recomputed (the forward's x1, and the relu mask)
  products  + the dW2 and dx1 products on the tensor cores
  full      + dW1: the kernel as the port ships it

Each line's device time less the previous line's is that part's cost
where the parts run one after another; where two run at once (the fused
design builds the next item's x1 beside dx1's products), the later part's
line gives what it adds on top. The cuts are lines of the source,
chosen by which design the source holds: the fused single pass
(``fused``) or the two kernels of the earlier design (``two_kernel``, a
dW2 kernel and a dx kernel). Every line must be found, so a change of the
source breaks the probe loudly. One JSON line, with the card's name and
power limit. Needs a CUDA card and ``nvcc``; imports nothing at import
time that needs either.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
from typing import Dict, List, Tuple

from end2end_asr_tpu_torch.tools import probe_lib as P

SOURCE = "vgg_block1.cu"

# ---- the two-kernel design: vgg_block1_dw2_bf16_kernel + ..._dx_bf16_kernel
_OLD_X1 = [
    ("            o[k] = x1_at(xs, w1s, b1s, i - 1, j - 1, cg * 8 + k, true);\n",
     "            o[k] = xs[j];\n"),
    ("        if (in && x1_at(xs, w1s, b1s, q, j, ci, true) > 0.f) "
     "d = acc[nn][i];\n",
     "        if (in && xs[j] > 0.f) d = acc[nn][i];\n")]
_OLD_PRODUCTS = [
    ("      for (int kb = 0; kb < CW / 16; ++kb) {\n"
     "        uint32_t bf[2][2][4];\n",
     "      for (int kb = 0; kb < 0; ++kb) {\n"
     "        uint32_t bf[2][2][4];\n"),
    ("    for (int tap = 0; tap < 9; ++tap) {\n"
     "      const int df = tap / 3, dt = tap % 3;\n"
     "      const int apos = (aq + 2 - df)",
     "    for (int tap = 0; tap < 0; ++tap) {\n"
     "      const int df = tap / 3, dt = tap % 3;\n"
     "      const int apos = (aq + 2 - df)")]
_OLD_DW1 = [("    accumulate_dw1(dxs, xs, dw1, tid);\n", "")]

# ---- the fused design: vgg_block1_bwd_fused_kernel (a cut tile keeps what
# it held: the products run on whatever it holds)
_NEW_DY2 = [("    build_dy2(raw, dys, db2s, tid);\n", ""),
            ("    build_cols(xs, cols, tid);\n", "")]
_NEW_X1 = [
    ("      build_x1_task(xs, w1s, b1s, x1s, mask0, item_of(lo, rows, chunks), "
     "F,\n                    T, e);\n", "      ;\n"),
    ("        build_x1_task(xs, w1s, b1s, x1s, mask0 + (buf ^ 1) * 2 * CW * 8, "
     "wn,\n                      F, T, e);\n", "        ;\n")]
_NEW_PRODUCTS = [
    ("    dw2_products(x1s, dys, acc2, warp, lane);\n", ""),
    ("      dx1_products(dys, w2s, accx, warp, lane);\n", "")]
_NEW_DW1 = [
    ("    if (warp < DX_WARPS) dw1_products(dxs, cols, acc1, warp, lane);\n",
     "")]

DESIGNS: Dict[str, Tuple[str, List[Tuple[str, list]]]] = {
    "fused": ("vgg_block1_bwd_fused_kernel", [
        ("staging", _NEW_DY2 + _NEW_X1 + _NEW_PRODUCTS + _NEW_DW1),
        ("dy2", _NEW_X1 + _NEW_PRODUCTS + _NEW_DW1),
        ("x1", _NEW_PRODUCTS + _NEW_DW1),
        ("products", _NEW_DW1),
        ("full", [])]),
    "two_kernel": ("vgg_block1_dw2_bf16_kernel", [
        ("staging", _OLD_X1 + _OLD_PRODUCTS + _OLD_DW1),
        ("x1", _OLD_PRODUCTS + _OLD_DW1),
        ("products", _OLD_DW1),
        ("full", [])]),
}


def design_of(src: str) -> str:
    for name, (marker, _) in DESIGNS.items():
        if marker in src:
            return name
    raise RuntimeError("probe_vgg_bwd: the source holds neither design")


def variant(src: str, cuts) -> str:
    for old, new in cuts:
        if old not in src:
            raise RuntimeError(f"probe_vgg_bwd: {old.strip()!r} is not in "
                               f"the source; update the probe")
        src = src.replace(old, new)
    return src


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=12)
    p.add_argument("--source", default=None,
                   help="a vgg_block1.cu to cut (default: the package's)")
    p.add_argument("--parts", default=None,
                   help="comma-separated parts to build and time "
                        "(default: all)")
    args = p.parse_args(argv)
    import torch
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    if not torch.cuda.is_available():
        raise SystemExit("probe_vgg_bwd: needs a CUDA device")
    dev = torch.device("cuda", 0)
    path = args.source or os.path.join(cuda_lib.CSRC_DIR, SOURCE)
    with open(path) as f:
        src = f.read()
    design = design_of(src)
    parts = args.parts.split(",") if args.parts else None
    libs = P.build({name: P.write_source(f"probe_vgg_bwd_{name}",
                                         variant(src, cuts))
                    for name, cuts in DESIGNS[design][1]
                    if parts is None or name in parts}, "probe_vgg_bwd")

    B, F, T = args.batch, 161, 800
    g0 = torch.Generator().manual_seed(0)
    spect = torch.randn(B, F, T, generator=g0).to(dev)
    ws = [(torch.randn(*s, generator=g0) * sc).to(dev) for s, sc in
          (((3, 3, 1, 64), 0.3), ((64,), 0.1), ((3, 3, 64, 64), 0.05),
           ((64,), 0.1))]
    # the plain forward: the probe builds nothing but its own copies
    out, idx = V.vgg_block1_plain(spect, *ws, cdt=torch.bfloat16)
    g = torch.randn(out.shape, generator=g0).to(dev, torch.bfloat16)
    w2k = ws[2].to(torch.bfloat16).contiguous()
    # room for the partials of either design (256 blocks at most)
    part = torch.empty(256 * V.PART, device=dev)
    grads = torch.empty(V.PART, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    kernel = V._BWD_KERNELS[torch.bfloat16]
    calls, regs = {}, {}
    for name, (so, regs[name]) in libs.items():
        fn = getattr(ctypes.CDLL(so), kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int

        def call(fn=fn):
            if fn(spect.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
                  w2k.data_ptr(), g.data_ptr(), out.data_ptr(),
                  idx.data_ptr(), part.data_ptr(), grads.data_ptr(), B, F,
                  T, stream):
                raise RuntimeError("probe_vgg_bwd: launch failed")
        calls[name] = call
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):   # in turns
        for name in order:
            times[name].append(1e3 * P.device_ms(torch, calls[name]))
    smi = P.gpu_line()
    best = {n: min(v) for n, v in times.items()}
    names = list(best)
    print(json.dumps({
        "design": design, "source": path, "shape": [B, F, T], "gpu": smi,
        "device_us": best, "device_us_all": times,
        "part_us": {n: best[n] - (best[names[i - 1]] if i else 0.0)
                    for i, n in enumerate(names)},
        "ptxas": regs}))


if __name__ == "__main__":
    main()
