"""Where the training attention's backward (``attn_bwd``) spends its time.

    python -m end2end_asr_tpu_torch.tools.probe_attn_bwd
        [--source path/to/attention.cu ...] [--no-package]
        [--dtype bf16|f32] [--cuts philox,dq_sum,...]

Builds ``csrc/attention.cu`` and every file ``--source`` names (another
design of the same entry points, e.g. an earlier commit's file unpacked
with ``git show``) into libraries of their own, and calls each one's
backward entry through ctypes on the same inputs (``probe_lib``: batch
12, 8 heads of 64, rate 0.1; q, k, v, g contiguous; out and stats from the
package's forward, out made contiguous) at the train cell's shapes: the
encoder self-attention (200, 200), the decoder cross-attention (51, 200)
and the causal decoder self-attention (51, 51). For each design and
shape: the device time of each kernel the call launches (torch.profiler,
by kernel name), their sum, and CUDA events around back-to-back ctypes
calls (the C call and its launches, no Python wrapper), timed in turns
(``probe_lib.time_in_turns``). The first design's gradients are
compared with each other's. One JSON line, with the card's name and power
limit. The two signatures are told apart by the source: the earlier design
(three kernels, ``attn_delta_kernel``) takes a (B, H, Tq) f32 scratch; the
fused one takes strides, a dQ scratch and arrival counters.
``--no-package`` times the ``--source`` files alone. ``--cuts`` adds
copies of the package's file with one part of the fused kernel taken out
each (``CUTS``; ``a+b`` cuts both): a part's cost is the full kernel's
time less the copy's (the copies compute wrong gradients; only their times
are kept). Needs a CUDA card and ``nvcc``; imports nothing at import time
that needs either.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

from end2end_asr_tpu_torch.tools import probe_lib as P

SOURCE = "attention.cu"

# the fused design's parts, each cut by replacing lines of the source
CUTS = {
    # the last block's sum of the dQ shares
    "dq_sum": [("  for (int e0 = tid; e0 < n4; e0 += U * BWD_THREADS) {",
                "  for (int e0 = tid; e0 < 0; e0 += U * BWD_THREADS) {")],
    # the dQ share's product
    "dq_product": [("      C::mma_dq(dqa, dsrc, ks, qw, dh, nk, lane);\n", "")],
    # dV += Pd^T dO and dK += dS^T Q
    "dkdv_products": [
        ("      C::mma_ps(dva, st, gt, lane, pw, nj);  // dV += Pd^T dO\n", ""),
        ("      C::mma_ps(dka, dp, qt, lane, pw, nj);  // dK += dS^T Q\n", "")],
    # S^T and dP^T
    "sdp_products": [
        ("      C::mma_abt(st, ka, qt, lane, nj);  // S^T: keys x queries\n",
         ""),
        ("      C::mma_abt(dp, va, gt, lane, nj);  // (dO V^T)^T\n", "")],
    # the Philox draw and exchange (every element kept)
    "philox": [("f.thresh32 ? keep_bits(pkey, f.thresh32, b, h, kw0, q0, lane)",
                "false ? keep_bits(pkey, f.thresh32, b, h, kw0, q0, lane)")],
    # the rebuilt P and dS: the exp and the bias, (m, 1/l, D) reads
    "softmax": [("          const float pr = expf(x - r.x) * r.y;",
                 "          const float pr = st[n][i];")],
    # the bias tiles' copies (16-byte path)
    "bias_load": [("        cp_async16(bb + r * LDB + c, in ? bg + (size_t)r * f.Tk + c "
                   ": f.bias,\n                   in);\n", "")],
    # the dQ shares' stores to the scratch
    "share_store": [("            *reinterpret_cast<float2*>(o + n * 8) =\n"
                     "                make_float2(dqa[n][2 * r], dqa[n][2 * r + 1]);\n",
                     "            ;\n")],
    # (m, 1/l, D) of the next query tile
    "d_phase": [("      d_phase(it + 1, nxt);\n", "")],
}


def cut(src: str, names: str) -> str:
    """`names`: parts of CUTS joined by '+', all cut."""
    return P.cut(src, names, CUTS, "probe_attn_bwd")


def design_of(src: str) -> str:
    return "three_kernel" if "attn_delta_kernel" in src else "fused"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", action="append", default=[],
                   help="another attention.cu (repeatable)")
    p.add_argument("--no-package", action="store_true",
                   help="leave the package's csrc/attention.cu out")
    p.add_argument("--cuts", default=None,
                   help="comma-separated parts of CUTS to time without "
                        "(default: none)")
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    args = p.parse_args(argv)
    import torch
    from end2end_asr_tpu_torch.ops import attention_fused as AF
    from end2end_asr_tpu_torch.ops import cuda_lib
    if not torch.cuda.is_available():
        raise SystemExit("probe_attn_bwd: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cdt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    paths = ([] if args.no_package
             else [os.path.join(cuda_lib.CSRC_DIR, SOURCE)]) + args.source
    if args.cuts:
        with open(os.path.join(cuda_lib.CSRC_DIR, SOURCE)) as f:
            src = f.read()
        for name in args.cuts.split(","):
            paths.append(P.write_source(
                f"cut_{name.replace('+', '_')}",
                cut(src, name)))
    if not paths:
        raise SystemExit("probe_attn_bwd: no source to time")
    libs = P.build({path: path for path in paths}, "probe_attn_bwd")
    symbol = "attn_bwd_" + args.dtype
    B, H, D, rate, seed = P.ATTN_B, P.ATTN_H, P.ATTN_D, P.ATTN_RATE, \
        P.ATTN_SEED
    thresh16 = AF.dropout_thresh16(rate)
    stream = torch.cuda.current_stream().cuda_stream
    out_json = {"shapes": {}, "designs": {}}
    for path in paths:
        with open(path) as f:
            out_json["designs"][path] = design_of(f.read())
    for label, (Tq, Tk, causal) in P.ATTN_SHAPES.items():
        q, k, v, bias = P.attn_inputs(torch, dev, cdt, Tq, Tk, causal)
        q, k, v = (t.contiguous() for t in (q, k, v))
        g = torch.randn(B, H, Tq, D, generator=torch.Generator()
                        .manual_seed(Tq + Tk)).to(dev, cdt)
        o, stats = AF.attn_fwd(q, k, v, bias, seed, rate)
        o = o.contiguous()   # the layout every design reads
        # dQ shares: room for any design's key tiles (16 keys at least)
        delta = torch.empty(B * H * Tq, device=dev)
        part = torch.empty(B * H * -(-Tk // 16) * Tq * D, device=dev)
        arrive = torch.zeros(B * H, dtype=torch.int32, device=dev)
        calls, grads, alive = {}, {}, []
        for path in paths:
            fn = getattr(ctypes.CDLL(libs[path][0]), symbol)
            fn.restype = ctypes.c_int
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            grads[path] = (dq, dk, dv)
            head = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    bias.data_ptr(), o.data_ptr(), stats.data_ptr(),
                    g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr()]
            dims = [B, H, Tq, Tk, D, thresh16]
            if out_json["designs"][path] == "three_kernel":
                fn.argtypes = AF.BWD.argtypes[:10] + AF.BWD.argtypes[11:18] \
                    + [ctypes.c_void_p, ctypes.c_void_p]
                a = head + dims + [seed, delta.data_ptr(), stream]
            else:
                fn.argtypes = AF.BWD.argtypes
                # a design without out's strides reads the first 21
                strides = (ctypes.c_longlong * 24)(*(
                    s for t in (q, k, v, g, dq, dk, dv, o)
                    for s in t.stride()[:3]))
                alive.append(strides)
                a = head + [ctypes.addressof(strides)] + dims + [
                    seed, part.data_ptr(), arrive.data_ptr(), stream]

            def call(fn=fn, a=a):
                if fn(*a):
                    raise RuntimeError("probe_attn_bwd: launch failed")
            calls[path] = call
        res = P.time_in_turns(torch, calls)
        ref = grads[paths[0]]
        for path in paths:
            r = res[path]
            r["max_abs_diff_to_first"] = max(
                (a.float() - b.float()).abs().max().item()
                for a, b in zip(grads[path], ref))
        out_json["shapes"][label] = {"shape": [B, H, Tq, Tk, D],
                                     "causal": causal, "results": res}
    out_json["gpu"] = P.gpu_line()
    out_json.update(dtype=args.dtype, rate=rate,
                    ptxas={path: lines for path, (_, lines) in libs.items()})
    print(json.dumps(out_json))


if __name__ == "__main__":
    main()
