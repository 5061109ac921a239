"""Where the block-1 backward (``vgg_block1_bwd``) spends its time.

    python -m end2end_asr_tpu_torch.tools.probe_vgg_bwd [--batch 12]
        [--dtype bfloat16|float32] [--source path/to/vgg_block1.cu ...]
        [--variants all|conv_no_a_loads,...] [--scratch-mb MB]

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
source breaks the probe loudly.

``--dtype float32`` times the f32 entry instead, whole: the package's
(``csrc/vgg_block1_f32.cu``), each ``--source`` file's (an earlier commit's
``vgg_block1.cu`` or ``vgg_block1_f32.cu``, whose f32 entry takes the same
arguments; the scratch is sized for this design and for the earlier
two-kernel f32 design, ``EARLIER_F32_ROWS``, or ``--scratch-mb``) and
cuDNN's autograd backward of
conv2d x2 + max_pool2d over a retained graph (NCHW, TF32 off), in turns,
device ms by kernel name; each entry's gradients are held against the
plain backward, and the executed TFLOP/s are the package's products
(``f32_gflop``) over each one's device time. ``--variants`` also builds
copies of the package's f32 source with one part changed
(``F32_VARIANTS``: a tile's shared-memory loads replaced by register
constants, dx1's epilogue cut, the dy2 and x1 built beside the products
skipped) and times them in the same turns: what a
part costs, and what bounds the tiles. A variant computes wrong
gradients; only its times are kept.

One JSON line, with the card's name and power limit. Needs a CUDA card
and ``nvcc``; imports nothing at import time that needs either.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

from end2end_asr_tpu_torch.tools import probe_lib as P

SOURCES = {"bfloat16": "vgg_block1.cu", "float32": "vgg_block1_f32.cu"}
SOURCE = SOURCES["bfloat16"]
# rows of partial sums the earlier two-kernel f32 entry (a dW2 kernel of 256
# blocks and a dx kernel) fills in the scratch it is given
EARLIER_F32_ROWS = 256

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


# ---- --variants (f32): copies of vgg_block1_f32.cu with one part changed
_CONV_A = ("        av[i] = lds4(ap + (prow(i) * HC + pcol(i)) * P + kk);")
_CONV_B = ("        const float4 b0 = lds4(wp + (kk + k) * C);\n"
           "        const float4 b1 = lds4(wp + (kk + k) * C + 32);")
_WG_A = ("      const float4 a =\n"
         "          lds4(ap + ((q + tap / 3) * AC + j + tap % 3) * C);")
_WG_B = "    const float4 bb = lds4(bp + (q * SEG + j) * C);"
_EPI = ("      dx1_epilogue(acc, xst + (k & 1) * HR * HC, w1s, b1s, red, sums,"
        "\n                   tile_of(lo + k, nf, nt), F, T);")
F32_VARIANTS = {
    "conv_no_a_loads": [(_CONV_A, "        av[i] = make_float4(i, kk, 1.f, "
                                  "2.f);")],
    "conv_no_b_loads": [(_CONV_B, "        const float4 b0 = make_float4("
                                  "k, kk, 1.f, 2.f);\n        const float4 "
                                  "b1 = make_float4(kk, k, 2.f, 1.f);")],
    "wgrad_no_a_loads": [(_WG_A, "      const float4 a = make_float4(tap, "
                                 "j, 1.f, 2.f);")],
    "wgrad_no_b_loads": [(_WG_B, "    const float4 bb = make_float4(j, q, "
                                 "1.f, 2.f);")],
    # the next step's dy2 (dx1) or x1 and dy2 (wgrad) built beside the
    # products: never (a test that no block meets)
    "dx1_no_build": [("      if (df == 0 && s + 1 < nsteps)\n",
                      "      if (df == 0 && s + 1 < nsteps && sp < 0)\n")],
    "wgrad_no_build": [("      if (q == 0 && s + 1 < n) {\n",
                        "      if (q == 0 && s + 1 < n && sp < 0) {\n")],
    # the sums stay alive (ptxas drops products nothing reads): one test
    # that no real sum meets
    "dx1_no_epilogue": [(_EPI, "      float sink = 0.f;\n      for (int i = 0; "
                               "i < NP; ++i)\n        for (int j = 0; j < 8; "
                               "++j) sink += acc[i][j];\n      if (sink == "
                               "1.5e-38f) part[threadIdx.x] = sink;")],
}


def f32_variants(src: str, names) -> Dict[str, str]:
    """{name: the f32 source with that variant's edits}, for `names`."""
    return P.edited_copies(src, F32_VARIANTS, names, "probe_vgg_bwd")


def f32_gflop(B: int, F: int, T: int) -> float:
    """GFLOP the f32 backward executes: dx1 over its tiles (the source's
    TR x TC) of all F x T positions, with conv1 recomputed and dW1 at
    each; dW2 over its K segments (2 conv rows x SEG columns) of the
    2 Fp x 2 Tp positions, with conv1 recomputed at each segment's AR x AC
    positions."""
    from end2end_asr_tpu_torch.ops import cuda_lib
    k = P.constexprs(os.path.join(cuda_lib.CSRC_DIR, SOURCES["float32"]))
    tr, tc, seg = k["TR"], k["TC"], k["SEG"]
    tiles = -(-F // tr) * -(-T // tc) * tr * tc
    nseg = (F // 2) * -(-(T // 2 * 2) // seg)
    return 2 * B * 64 * (tiles * (576 + 9 + 9) + nseg * (
        2 * seg * 576 + k["AR"] * k["AC"] * 9)) / 1e9


def f32_main(args, torch, dev):
    """--dtype float32: the package's f32 entry, the --source file's and
    cuDNN's backward, in turns."""
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    if args.parts:
        raise SystemExit("probe_vgg_bwd: no --parts at float32")
    torch.backends.cudnn.allow_tf32 = False
    named = {"package": os.path.join(cuda_lib.CSRC_DIR, SOURCES["float32"])}
    named.update({f"source{i}": s for i, s in enumerate(args.source)})
    chosen = ([] if not args.variants else list(F32_VARIANTS)
              if args.variants == "all" else args.variants.split(","))
    with open(named["package"]) as f:
        for name, v in f32_variants(f.read(), chosen).items():
            named[name] = P.write_source(f"probe_vgg_bwd_variant_{name}", v)
    libs = P.build(named, "probe_vgg_bwd_f32")
    B, F, T = args.batch, 161, 800
    g0 = torch.Generator().manual_seed(0)
    spect = torch.randn(B, F, T, generator=g0).to(dev)
    ws = [(torch.randn(*s, generator=g0) * sc).to(dev) for s, sc in
          (((3, 3, 1, 64), 0.3), ((64,), 0.1), ((3, 3, 64, 64), 0.05),
           ((64,), 0.1))]
    cdt = torch.float32
    out, idx = V.vgg_block1_plain(spect, *ws, cdt=cdt)
    g = torch.randn(out.shape, generator=g0).to(dev)
    want = V.vgg_block1_bwd_plain(spect, *ws[:3], out, idx, g, cdt)
    part = torch.empty(max(EARLIER_F32_ROWS * V.PART,
                           V.bwd_scratch(cdt, B, F, T),
                           int(args.scratch_mb * 2 ** 18)), device=dev)
    grads = torch.empty(V.PART, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    kernel = V._BWD_KERNELS[cdt]
    calls, checks = {}, {}
    o1, o2, o3 = 9 * 64, 10 * 64, 10 * 64 + 9 * 64 * 64
    for name, (so, _) in libs.items():
        def call(fn=P.bind(so, kernel), name=name):
            if fn(spect.data_ptr(), *(w.data_ptr() for w in ws[:3]),
                  g.data_ptr(), out.data_ptr(), idx.data_ptr(),
                  part.data_ptr(), grads.data_ptr(), B, F, T, stream):
                raise RuntimeError(f"probe_vgg_bwd: {name} failed")
        calls[name] = call
        call()
        torch.cuda.synchronize()
        if name in F32_VARIANTS:
            continue
        got = (grads[:o1], grads[o1:o2], grads[o2:o3], grads[o3:])
        checks[name] = [((a - b.reshape(a.shape)).abs().max()
                         / b.abs().max()).item() for a, b in zip(got, want)]
    wc = [w.clone().requires_grad_() for w in ws]
    y = Fn.conv2d(spect[:, None], wc[0].permute(3, 2, 0, 1), wc[1],
                  padding=1)
    y = Fn.conv2d(torch.relu(y), wc[2].permute(3, 2, 0, 1), padding=1)
    lib_out = torch.relu(Fn.max_pool2d(y, 2) + wc[3][None, :, None, None])
    gl = torch.randn(lib_out.shape, generator=g0).to(dev)
    calls["library"] = lambda: torch.autograd.grad(lib_out, wc, gl,
                                                   retain_graph=True)
    res = P.time_in_turns(torch, calls)
    print(json.dumps({
        "dtype": "float32", "shape": [B, F, T], "sources": named,
        "gpu": P.gpu_line(), **P.turns_json(res, f32_gflop(B, F, T)),
        "rel_err_dw1_db1_dw2_db2": checks,
        "ptxas": {n: libs[n][1] for n in libs}}))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=12)
    p.add_argument("--source", action="append", default=[],
                   help="bf16: the vgg_block1.cu to cut (default: the "
                        "package's); f32: another source of the entry, "
                        "timed in turns with the package's (repeatable)")
    p.add_argument("--scratch-mb", type=float, default=0.0,
                   help="f32: the least scratch to give every entry, for a "
                        "--source whose design needs more than this one's "
                        "and the two-kernel design's")
    p.add_argument("--parts", default=None,
                   help="comma-separated parts to build and time "
                        "(default: all)")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="the entry to time")
    p.add_argument("--variants", default=None,
                   help="f32: comma-separated F32_VARIANTS to time beside "
                        "the package's source, or 'all'")
    args = p.parse_args(argv)
    import torch
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    if not torch.cuda.is_available():
        raise SystemExit("probe_vgg_bwd: needs a CUDA device")
    dev = torch.device("cuda", 0)
    if args.dtype == "float32":
        f32_main(args, torch, dev)
        return
    if len(args.source) > 1:
        raise SystemExit("probe_vgg_bwd: one --source at bfloat16")
    path = (args.source or [os.path.join(cuda_lib.CSRC_DIR, SOURCE)])[0]
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
        def call(fn=P.bind(so, kernel)):
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
