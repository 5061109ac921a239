"""Where the FFT kernel of ``stft_logmag`` spends its time, on the card.

    python -m end2end_asr_tpu_torch.tools.probe_stft [--batch 12]

The card's profiler here gives kernel durations but no stall reasons, so
this probe builds cut-down copies of ``csrc/stft.cu`` (the main path's
compiled-in plan, n_fft 320, hop 160) and times each at the main path's
shape, B × 800 frames. The copies add one part of the kernel at a time:

  skeleton   the persistent loop, its barriers and nothing else
  stores     + the output rows written (a constant, no shared reads)
  split      + the real-input split and log1p on whatever shared memory
               holds (no samples staged)
  staging    + the tables and the samples copied in (cp.async)
  first      + the first radix pass
  full       + the other passes: the kernel as the port ships it

Each line's device time less the previous line's is that part's cost
where the parts run one after another. Beside them: a library copy of the
PCM (the same bytes in and out) and a fill of the spectrogram, the card's
own floors for the kernel's traffic. One JSON line, with the card's name
and power limit. Needs a CUDA card and ``nvcc``; imports nothing at
import time that needs either.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
from typing import List, Tuple

from end2end_asr_tpu_torch.tools import probe_lib as P

SOURCE = "stft.cu"
# (line of csrc/stft.cu, what the cut-down copy has there); every line must
# be found, so a change of the source breaks the probe loudly
_FIRST = [("      first_pass<R0>(a, g, x, win, bufA);\n", "")]
_PASSES = [("      fft_pass<R1, kM, R0>(g, bufA, bufB, tw, 0);\n", ""),
           ("      fft_pass<R2, kM, R0 * R1>(g, bufB, bufA, tw, 0);\n", "")]
_STAGING = [   # the table loops keep an empty body
    ("    cp_async8(tw + i, a.tw + i);\n", "    ;\n"),
    ("    cp_async8(tws + i, a.tws + i);\n", "    ;\n"),
    ("    cp_async8(win + 2 * i, a.window + 2 * i);\n", "    ;\n"),
    ("  if (run < a.runs) stage_run(a, run, xs[0]);\n", ""),
    ("    if (next < a.runs) stage_run(a, next, xs[(it + 1) & 1]);\n", "")]
_CONST = [
    ("      o_f[k] = __logf(1.f + sqrtf(fmaf(x1.x, x1.x, x1.y * x1.y)));\n",
     "      o_f[k] = 1.f;\n"),
    ("        o_f[g.M - k] = __logf(1.f + sqrtf(fmaf(x2.x, x2.x, "
     "x2.y * x2.y)));\n", "        o_f[g.M - k] = 1.f;\n")]
_NOSPLIT = [("    real_split(a, g, in, tws, b, t0);\n", "")]

PARTS: List[Tuple[str, list]] = [
    ("skeleton", _FIRST + _PASSES + _STAGING + _NOSPLIT),
    ("stores", _FIRST + _PASSES + _STAGING + _CONST),
    ("split", _FIRST + _PASSES + _STAGING),
    ("staging", _FIRST + _PASSES),
    ("first", _PASSES),
    ("full", []),
]


def variant(src: str, cuts) -> str:
    for old, new in cuts:
        if old not in src:
            raise RuntimeError(f"probe_stft: {old.strip()!r} is not in "
                               f"csrc/{SOURCE}; update the probe")
        src = src.replace(old, new)
    return src


def device_us(torch, fn) -> float:
    return 1e3 * P.device_ms(torch, fn, iters=100)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=12)
    args = p.parse_args(argv)
    import torch
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.ops import stft as S
    if not torch.cuda.is_available():
        raise SystemExit("probe_stft: needs a CUDA device")
    dev = torch.device("cuda", 0)
    with open(os.path.join(cuda_lib.CSRC_DIR, SOURCE)) as f:
        src = f.read()
    libs = P.build({name: P.write_source(f"probe_stft_{name}",
                                         variant(src, cuts))
                    for name, cuts in PARTS}, "probe_stft")

    B, T, n_fft, hop = args.batch, 800, 320, 160
    N = (T - 1) * hop + n_fft
    g = torch.Generator().manual_seed(0)
    pcm = (torch.randn(B, N, generator=g) * 0.1).to(dev)
    out = torch.empty(B, T, n_fft // 2 + 1, device=dev)
    win = S.window_vector(n_fft, "hamming", str(dev))
    tw, tws = S.twiddles(n_fft, str(dev))
    code = sum(r << (4 * i) for i, r in enumerate(S.fft_plan(n_fft)))
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, (so, _) in libs.items():
        fn = getattr(ctypes.CDLL(so), S.FFT.symbol)
        fn.argtypes, fn.restype = S.FFT.argtypes, ctypes.c_int

        def call(fn=fn):
            if fn(pcm.data_ptr(), win.data_ptr(), tw.data_ptr(),
                  tws.data_ptr(), out.data_ptr(), B, N, T, n_fft, hop,
                  code, stream):
                raise RuntimeError("probe_stft: launch failed")
        calls[name] = call
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):   # in turns
        for name in order:
            times[name].append(device_us(torch, calls[name]))
    flat = out.view(-1)[:pcm.numel()]
    smi = P.gpu_line()
    print(json.dumps({
        "shape": [B, T, n_fft, hop], "gpu": smi,
        "device_us": {n: min(v) for n, v in times.items()},
        "device_us_all": times,
        "library_copy_of_the_pcm_us": device_us(
            torch, lambda: flat.copy_(pcm.view(-1))),
        "library_fill_of_the_spectrogram_us": device_us(
            torch, lambda: out.fill_(1.0))}))


if __name__ == "__main__":
    main()
