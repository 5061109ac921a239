"""Where the training attention's forward (``attn_fwd``) spends its time.

    python -m end2end_asr_tpu_torch.tools.probe_attn_fwd
        [--source path/to/attention.cu ...] [--no-package]
        [--dtype bf16|f32] [--cuts philox,bias,loads_only]
        [--key-splits 1,2,4]

Builds ``csrc/attention.cu`` and every file ``--source`` names (another
design of the same entry points, e.g. an earlier commit's file unpacked
with ``git show``) into libraries of their own, and calls each one's
forward entry through ctypes on the same inputs (``probe_lib``: batch 12,
8 heads of 64, rate 0.1) at the train cell's shapes, the encoder
self-attention (200, 200), the decoder cross-attention (51, 200) and the
causal decoder self-attention (51, 51), and at the bucket ladder's shapes
where the wrapper splits the keys (``BUCKET_SHAPES``). A design that
reads strides (``FwdParams`` in its source) gets q, k and v as the
training path hands them over, transposed views of (B, T, H, D) tensors,
and writes out into (B, Tq, H, D) memory; an earlier design gets
contiguous copies (the copies are not timed). For each design and shape:
the device time of each kernel the call launches (torch.profiler, by
kernel name), their sum, and CUDA events around back-to-back ctypes
calls, timed in turns (``probe_lib.time_in_turns``). Each design's output
is compared with the first one's and with the plain version's. ``--cuts``
adds copies of the package's file with one part taken out each
(``CUTS``; ``a+b`` cuts both): a part's cost is the full kernel's time
less the copy's (the copies compute wrong outputs; only their times are
kept). ``--key-splits`` times the package's kernel at each given number
of key groups a block besides the wrapper's choice. One JSON line, with
the card's name and power limit. Needs a CUDA card and ``nvcc``; imports
nothing at import time that needs either.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

from end2end_asr_tpu_torch.tools import probe_lib as P

SOURCE = "attention.cu"
# config.src_buckets' 200 and 400 frames (50 and 100 encoder rows) and
# tgt_buckets' 100 columns (101 decoder rows): {label: (Tq, Tk, causal)}
BUCKET_SHAPES = {"enc_self_50": (50, 50, False),
                 "enc_self_100": (100, 100, False),
                 "dec_cross_101": (101, 200, False),
                 "dec_self_101": (101, 101, True)}

# the forward's parts, each cut by replacing lines of the source
CUTS = {
    # the Philox draw and exchange (every element kept)
    "philox": [("f.thresh32 ? keep_bits_fwd<NJ>(f, pkey, b, h, kw, r0, lane, nj)",
                "false ? keep_bits_fwd<NJ>(f, pkey, b, h, kw, r0, lane, nj)")],
    # the bias tiles' copies and reads
    "bias": [("      for (int e = tid; e < QT * cw; e += THREADS) {",
              "      for (int e = tid; e < 0; e += THREADS) {"),
             ("      for (int e = tid; e < QT * nk; e += THREADS) {",
              "      for (int e = tid; e < 0; e += THREADS) {"),
             ("        const float2 x = *reinterpret_cast<const float2*>(\n"
              "            bt + ((lane >> 2) + 8 * r) * LDF + c);",
              "        const float2 x = make_float2(0.f, 0.f);")],
    # no products, softmax or dropout: the staging and the epilogue only
    "loads_only": [("    if (!qwarp || nkw <= 0) continue;",
                    "    continue;")],
}


def cut(src: str, names: str) -> str:
    """`names`: parts of CUTS joined by '+', all cut."""
    return P.cut(src, names, CUTS, "probe_attn_fwd")


def design_of(src: str) -> str:
    return "strided" if "FwdParams" in src else "contiguous"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", action="append", default=[],
                   help="another attention.cu (repeatable)")
    p.add_argument("--no-package", action="store_true",
                   help="leave the package's csrc/attention.cu out")
    p.add_argument("--cuts", default=None,
                   help="comma-separated parts of CUTS to time without")
    p.add_argument("--key-splits", default=None,
                   help="comma-separated key groups a block to time the "
                        "package's kernel at (bf16: 1, 2, 4)")
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    args = p.parse_args(argv)
    import torch
    from end2end_asr_tpu_torch.ops import attention_fused as AF
    from end2end_asr_tpu_torch.ops import cuda_lib
    if not torch.cuda.is_available():
        raise SystemExit("probe_attn_fwd: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cdt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    package = os.path.join(cuda_lib.CSRC_DIR, SOURCE)
    paths = ([] if args.no_package else [package]) + args.source
    if args.cuts:
        with open(package) as f:
            src = f.read()
        for name in args.cuts.split(","):
            paths.append(P.write_source(
                f"cut_fwd_{name.replace('+', '_')}",
                cut(src, name)))
    if not paths:
        raise SystemExit("probe_attn_fwd: no source to time")
    libs = P.build({path: path for path in paths}, "probe_attn_fwd")
    designs = {}
    for path in paths:
        with open(path) as f:
            designs[path] = design_of(f.read())
    symbol = "attn_fwd_" + args.dtype
    B, H, D, rate, seed = P.ATTN_B, P.ATTN_H, P.ATTN_D, P.ATTN_RATE, \
        P.ATTN_SEED
    thresh16 = AF.dropout_thresh16(rate)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    splits = ([int(x) for x in args.key_splits.split(",")]
              if args.key_splits else [])
    out_json = {"shapes": {}, "designs": designs}
    for label, (Tq, Tk, causal) in {**P.ATTN_SHAPES,
                                    **BUCKET_SHAPES}.items():
        q, k, v, bias = P.attn_inputs(torch, dev, cdt, Tq, Tk, causal)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        want = AF.flash_mha_train_plain(qc.float(), kc.float(), vc.float(),
                                        bias, seed, rate)
        wk0 = (1 if cdt == torch.float32
               else AF.fwd_key_split(B, H, Tq, sms))
        # (label, path, key groups)
        runs = [(path, path, wk0) for path in paths]
        runs += [(f"{package}@wk={w}", package, w) for w in splits
                 if not args.no_package]
        calls, outs, alive = {}, {}, []
        for name, path, wk in runs:
            fn = getattr(ctypes.CDLL(libs[path][0]), symbol)
            fn.restype = ctypes.c_int
            stats = torch.empty(B, H, Tq, 2, device=dev)
            if designs[path] == "strided":
                o = torch.empty(B, Tq, H, D, dtype=cdt,
                                device=dev).transpose(1, 2)
                strides = (ctypes.c_longlong * 12)(*(
                    s for t in (q, k, v, o) for s in t.stride()[:3]))
                alive.append(strides)
                fn.argtypes = AF.FWD.argtypes
                a = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     bias.data_ptr(), o.data_ptr(), stats.data_ptr(),
                     ctypes.addressof(strides), B, H, Tq, Tk, D, thresh16,
                     seed, wk, stream]
            else:
                o = torch.empty(B, H, Tq, D, dtype=cdt, device=dev)
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
                    ctypes.c_uint64, ctypes.c_void_p]
                a = [qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                     bias.data_ptr(), o.data_ptr(), stats.data_ptr(), B, H,
                     Tq, Tk, D, thresh16, seed, stream]
            outs[name] = o

            def call(fn=fn, a=a):
                if fn(*a):
                    raise RuntimeError("probe_attn_fwd: launch failed")
            calls[name] = call
        res = P.time_in_turns(torch, calls)
        ref = outs[runs[0][0]].float()
        for (n, path, wk) in runs:
            r = res[n]
            r["key_split"] = wk if designs[path] == "strided" else None
            o = outs[n].float()
            r["max_abs_diff_to_first"] = (o - ref).abs().max().item()
            r["max_abs_err_to_plain"] = (o - want).abs().max().item()
        out_json["shapes"][label] = {"shape": [B, H, Tq, Tk, D],
                                     "causal": causal, "results": res}
    out_json["gpu"] = P.gpu_line()
    out_json.update(dtype=args.dtype, rate=rate, sms=sms,
                    ptxas={path: lines for path, (_, lines) in libs.items()})
    print(json.dumps(out_json))


if __name__ == "__main__":
    main()
