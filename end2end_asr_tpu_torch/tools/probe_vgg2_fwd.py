"""Where the block-2 forward (``vgg_block2_fwd``) spends its time.

    python -m end2end_asr_tpu_torch.tools.probe_vgg2_fwd
        [--dtype bfloat16|float32] [--source path/to/vgg_block2.cu ...]
        [--parts staging,conv3,...] [--library]

Builds cut-down copies of the package's source (``csrc/vgg_block2.cu`` for
bf16, ``csrc/vgg_block2_f32.cu`` for f32) and of every file ``--source``
names (another design of the same entry point, e.g. the parent commit's
file unpacked with ``git show``) and times the entry of each at the main
path's shape, x (12, 80, 400, 64), with the pool argmax (the training
path); the uncut copies also without it (the serving path). At f32 only
the uncut copies are built (``--parts full``; ``kernels_ms`` times the
entry's kernels by name), and the design, the earlier per-tile kernel
(``conv_gemm``) or the FFMA GEMMs of ``vgg_block2_f32.cu`` (which take an
x2 scratch), is read from the source (``f32_design_of``). The bf16 copies add one part of the
work at a time:

  staging   the work loop, its barriers, the x tiles and the weights
            staged; no product, no epilogue, no output written
  conv3     + conv3's products and its epilogue (x2, bf16, in shared
            memory)
  conv4     + conv4's products (and, where the design writes them, its
            rounded sums; the wgmma design's copy keeps its sums alive by
            one test that no real sum meets, or ptxas would drop them)
  full      + the pool epilogue (pool, argmax, bias, relu, out and idx
            stored): the kernel as shipped

Each line's device time less the previous line's is what that part adds
(``part_ms``). Which cuts apply is read from the source (``design_of``):
the tile kernel of PR 3 (``conv_gemm``, one block per 64-column chunk
and conv row pair) or the persistent ``wgmma`` kernel. Every cut line
must be found, so a changed source breaks the probe loudly; the cuts put
``if (false)`` before a statement or take a product loop to no steps,
and a cut copy computes wrong outputs (only its time is kept). The
designs are timed in turns (a, b, ..., b, a; the smaller reading of each
kept), device ms by kernel name from torch.profiler and CUDA events
around back-to-back calls. Each uncut copy's output is compared with the
plain version (max abs error, the argmax's agreement). ``--library``
also times cuDNN (conv2d x2 + max_pool2d) on the same inputs in NCHW and
in channels-last memory (the gate-off front end's layout; f32 with TF32
off). One JSON
line, with the card's name and power limit and ptxas's registers and
spills. Needs a CUDA card and ``nvcc``; imports nothing at import time
that needs either.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

from end2end_asr_tpu_torch.tools import probe_lib as P

SOURCE = "vgg_block2.cu"
SOURCE_F32 = "vgg_block2_f32.cu"
B, F, T = 12, 80, 400  # the train cell's x (PERF.md §4)
PARTS = ("staging", "conv3", "conv4", "full")
WGMMA_KERNEL = "vgg_block2_fwd_wgmma_kernel"


def design_of(src: str) -> str:
    """"wgmma" for the persistent wgmma kernel, "tiles" for PR 3's."""
    return "wgmma" if WGMMA_KERNEL in src else "tiles"


def f32_design_of(src: str) -> str:
    """The f32 entry's design: "fma" for the FFMA GEMMs with an x2 scratch
    argument, "tiles" for the earlier per-tile kernel."""
    return "fma" if "vgg_block2_fwd_conv4_f32_kernel" in src else "tiles"


def f32_argtypes(design: str) -> list:
    """The f32 entry's ctypes arguments: the "fma" design's x2 scratch
    pointer comes before B, F, T."""
    from end2end_asr_tpu_torch.ops import cuda_lib as C
    return [C.P] * (8 if design == "fma" else 7) + [C.I] * 3 + [C.P]


def _off(stmt: str) -> Tuple[str, str]:
    """A cut: the statement that starts with `stmt` is never run."""
    indent = stmt[:len(stmt) - len(stmt.lstrip())]
    return stmt, f"{indent}if (false) {stmt.lstrip()}"


# {design: {part: the cuts that part lifts}}; "staging" is what is left
# with every other part cut
CUTS = {
    # PR 3's kernel: conv_gemm (shared by conv3 and conv4) takes a flag
    # that runs its product loop for no steps; the epilogues' stores and
    # the pool loop are cut by `if (false)`
    "tiles": {
        "conv3": [("  conv_gemm<CI, C2, true>(\n      xs, w3,",
                   "  conv_gemm<CI, C2, true, false>(\n      xs, w3,"),
                  _off("        x2s[p * P2 + n] = D::from_f(")],
        "conv4": [("  conv_gemm<C2, C2, true>(\n      x2s, w4,",
                   "  conv_gemm<C2, C2, true, false>(\n      x2s, w4,"),
                  ("[&](int p, int n, float v) { y4s[p * P2 + n] = "
                   "D::from_f(v); });",
                   "[&](int p, int n, float v) { if (false) y4s[p * P2 + n]"
                   " = D::from_f(v); });")],
        "full": [_off("  for (int e = tid; e < (W / 2) * C2; e += NT) {")],
    },
    # the wgmma kernel: each part is one statement of the consumers' loop
    "wgmma": {
        "conv3": [_off("          conv3_stage(acc3, wst + c * 8192, xs, "
                       "f0, t);"),
                  _off("        conv3_epilogue(acc3, x2s, b3s, f0, c0, F, "
                       "Tn, c);")],
        "conv4": [_off("        conv4_stage(acc4, wst + c * 8192, x2s, r, "
                       "t, h);")],
        # the pool epilogue cut, conv4's sums are kept alive (ptxas drops
        # products whose sums nothing reads): one test no real sum meets
        "full": [("      pool_epilogue(acc4, b4s, outs, idxs, out, idx, "
                  "b, r, c0, Fp, Tp, c);",
                  "      if (acc4[0][0] == 1.5e-38f && acc4[1][0] == 1.5e-38f)"
                  " out[tid] = out[0];")],
    },
}
# edits every cut copy of a design takes first (the product flag)
PREP = {
    "tiles": [("template <int CIN, int NOUT, bool STREAM, typename APos, "
               "typename Epi>",
               "template <int CIN, int NOUT, bool STREAM, bool P = true, "
               "typename APos, typename Epi>"),
              ("      for (int kc = 0; kc < CIN / 16; ++kc) {",
               "      for (int kc = 0; kc < (P ? CIN / 16 : 0); ++kc) {")],
    "wgmma": [],
}


def _apply(src: str, edits, all_=False) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"probe_vgg2_fwd: {old.strip()!r} is not in "
                               "the source; update the probe")
        src = src.replace(old, new) if all_ else src.replace(old, new, 1)
    return src


def variants(src: str, parts=PARTS) -> Dict[str, str]:
    """{part: the source with every part after it cut}, for `parts`."""
    design = design_of(src)
    out = {}
    for i, part in enumerate(PARTS):
        if part not in parts:
            continue
        later = PARTS[i + 1:]
        v = src
        if later:
            v = _apply(v, PREP[design], all_=True)
            for name in later:
                v = _apply(v, CUTS[design][name])
        out[part] = v
    return out


def weights_for(V, design: str, w3, w4, cdt):
    """The weight arguments the design's entry reads: the per-tile bf16
    kernel the "t" layout (tap, out, in), the wgmma kernel the packed stages, the
    f32 entries (either design) the "n" layout (tap, in, out)."""
    import torch
    if cdt == torch.float32:
        return V._layout(w3, cdt, False), V._layout(w4, cdt, False)
    if design == "wgmma":
        return V._pack_fwd2(w3, w4)
    return (V._layout(w3, torch.bfloat16, True),
            V._layout(w4, torch.bfloat16, True))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="the entry to time")
    p.add_argument("--source", action="append", default=[],
                   help="another vgg_block2.cu (repeatable)")
    p.add_argument("--parts", default=None,
                   help="comma-separated parts to build and time "
                        "(default: all)")
    p.add_argument("--library", action="store_true",
                   help="also cuDNN conv2d x2 + max_pool2d, NCHW and "
                        "channels-last")
    args = p.parse_args(argv)
    import torch
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    if not torch.cuda.is_available():
        raise SystemExit("probe_vgg2_fwd: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    f32 = args.dtype == "float32"
    parts = args.parts.split(",") if args.parts else (
        ["full"] if f32 else list(PARTS))
    if f32 and parts != ["full"]:
        raise SystemExit("probe_vgg2_fwd: at float32 only --parts full")
    designs = {"package": os.path.join(cuda_lib.CSRC_DIR,
                                       SOURCE_F32 if f32 else SOURCE)}
    designs.update({f"source{i}": s for i, s in enumerate(args.source)})
    named, design = {}, {}
    for d, path in designs.items():
        with open(path) as f:
            src = f.read()
        design[d] = f32_design_of(src) if f32 else design_of(src)
        for part, v in variants(src, parts).items():
            named[f"{d}:{part}"] = P.write_source(
                f"probe_vgg2_fwd_{args.dtype}_{d}_{part}", v)
    libs = P.build(named, "probe_vgg2_fwd")

    cdt = torch.float32 if f32 else torch.bfloat16
    g0 = torch.Generator().manual_seed(0)
    x = torch.randn(B, F, T, 64, generator=g0).relu().to(dev, cdt)
    ws = [(torch.randn(*s, generator=g0) * sc).to(dev) for s, sc in
          (((3, 3, 64, 128), (2 / 576) ** 0.5), ((128,), 0.1),
           ((3, 3, 128, 128), (2 / 1152) ** 0.5), ((128,), 0.1))]
    want, want_idx = V.vgg_block2_plain(x, *ws, cdt=cdt)
    pooled = (B, F // 2, T // 2, 128)
    stream = torch.cuda.current_stream().cuda_stream
    kernel = V._FWD2_KERNELS[cdt]
    calls, outs = {}, {}
    x2 = torch.empty((B, F, T, 128), dtype=cdt, device=dev)
    for name, (so, _) in libs.items():
        d, part = name.split(":")
        w3k, w4k = weights_for(V, design[d], ws[0], ws[2], cdt)
        fn = P.bind(so, kernel, f32_argtypes(design[d]) if f32 else None)
        scratch = (x2.data_ptr(),) if design[d] == "fma" else ()
        out = torch.empty(pooled, dtype=cdt, device=dev)
        idx = torch.empty(pooled, dtype=torch.uint8, device=dev)
        outs[name] = (out, idx)
        modes = (("idx", idx), ("no_idx", None)) if part == "full" else (
            ("idx", idx),)
        for mode, ip in modes:
            def call(fn=fn, out=out, ip=ip, w3k=w3k, w4k=w4k,
                     scratch=scratch, name=name):
                if fn(x.data_ptr(), w3k.data_ptr(), ws[1].data_ptr(),
                      w4k.data_ptr(), ws[3].data_ptr(), out.data_ptr(),
                      ip.data_ptr() if ip is not None else None, *scratch,
                      B, F, T, stream):
                    raise RuntimeError(f"probe_vgg2_fwd: {name} failed")
            calls[f"{name}" + ("" if mode == "idx" else ":no_idx")] = call
    if args.library:
        for layout, fmt in (("nchw", torch.contiguous_format),
                            ("channels_last", torch.channels_last)):
            xl = x.permute(0, 3, 1, 2).contiguous(memory_format=fmt)
            wl = [w.to(cdt) for w in ws]
            w3l, w4l = (wl[i].permute(3, 2, 0, 1).contiguous(
                memory_format=fmt) for i in (0, 2))

            def lib(xl=xl, w3l=w3l, w4l=w4l, wl=wl):
                y = torch.relu(Fn.conv2d(xl, w3l, wl[1], padding=1))
                y = Fn.conv2d(y, w4l, padding=1)
                return torch.relu(Fn.max_pool2d(y, 2)
                                  + wl[3][None, :, None, None])
            calls[f"library:{layout}"] = lib
    res = P.time_in_turns(torch, calls)
    checks = {}
    for name, (out, idx) in outs.items():
        if not name.endswith(":full"):
            continue
        calls[name]()
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        tol = 1e-4 if f32 else 2 ** -6   # chip_smoke.py's elementwise ones
        checks[name] = {
            "max_abs_err": diff.max().item(),
            "within_tol": bool((diff <= tol + tol
                                * want.float().abs()).all()),
            "idx_equal_share": (idx == want_idx).float().mean().item()}
    dev_ms = {n: r["device_ms"] for n, r in res.items()}
    part_ms = {}
    for d in designs:
        chain = [f"{d}:{pt}" for pt in PARTS if f"{d}:{pt}" in dev_ms]
        part_ms[d] = {n.split(":")[1]: dev_ms[n] - (dev_ms[chain[i - 1]]
                                                    if i else 0.0)
                      for i, n in enumerate(chain)}
    print(json.dumps({
        "dtype": args.dtype, "shape": [B, F, T, 64], "gpu": P.gpu_line(),
        "sources": designs,
        "designs": design, **P.turns_json(res),
        "part_ms": part_ms, "checks": checks,
        "ptxas": {n: libs[n][1] for n in libs}}))


if __name__ == "__main__":
    main()
