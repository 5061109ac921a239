#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (end2end_asr_tpu_torch) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero without the final result line):
  1. build every CUDA kernel of the serving path from csrc/ (one nvcc per
     source, all started together) and print the card's name and power
     limit;
  2. hold each kernel against its plain PyTorch version on the card at
     the shapes the serving path gives it (B=12, T=800, F=161; f32 with
     TF32 off, and bf16 for the vgg block), and time the kernel, the
     plain version and one PyTorch library yardstick the port never calls;
  3. serve: the full-width AiShell README model (vgg_cnn, 4 layers,
     8 heads, dim 512, dim_inner 2048, the AiShell vocabulary) with
     seeded random weights, written as a checkpoint in the JAX package's
     format, answers 12 synthetic ~8 s utterances through the port's
     `test` entry point, greedy and then beam-8, with the kernels' launch
     counts set to 0 before each run and read after it; then the
     per-batch encode / greedy / beam times, a profile of one encode and
     of 64 greedy steps, and the encoder output and 8 decoder steps on
     the card (f32, TF32 off) against the port's CPU path on one
     utterance;
  4. one JSON line of per-kernel numbers, then the result line
     {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package. Needs one CUDA card.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 1234
B, SECONDS_MAX = 12, 7.99          # 7.99 s → 800 frames: the 800 bucket
F32_PEAK = 67e12                   # H100 SXM f32 FMA, FLOP/s
BF16_PEAK = 989e12                 # H100 SXM bf16 tensor cores, FLOP/s
HBM_BPS = 3.35e12                  # H100 SXM HBM3, bytes/s

# kernel vs plain tolerances (max |kernel - plain|)
STFT_TOL = 1e-4      # f32 sums of 320 products in another order; O(1) out
VGG_F32_TOL = 1e-4   # f32 sums of 9 and 576 products in another order
# bf16: a conv output on the other side of a bf16 rounding boundary is one
# bf16 ulp off (2^-8 relative) and may flip a near-tied pool choice
VGG_BF16_RTOL, VGG_BF16_ATOL = 2 ** -6, 2 ** -6
ENC_TOL = 2e-3       # f32 encoder, 4 layers: GPU vs CPU sum order
DEC_TOL = 2e-3       # f32 decoder logits, 4 layers: GPU vs CPU sum order


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gpu_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_build(cuda_lib):
    t0 = time.time()
    paths = cuda_lib.build(["stft", "vgg_block1"])
    log(f"built {sorted(paths)} in {time.time() - t0:.1f} s")
    for src in sorted(paths):
        for ln in cuda_lib.build_log(src).splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {src}: {ln.strip()}")
    return paths


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def check_stft(torch, dev):
    from end2end_asr_tpu_torch.ops import features as PF
    from end2end_asr_tpu_torch.ops import stft as S
    n_fft, hop, T = 320, 160, 800
    N = (T - 1) * hop + n_fft
    g = torch.Generator().manual_seed(SEED)
    pcm = (torch.randn(B, N, generator=g) * 0.1).mul(32768).round().div(
        32768).to(dev)
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in PF.dft_matrices(n_fft, "hamming"))
    F = cos.shape[1]
    got = S.stft_logmag(pcm, cos, sin, hop, T)
    want = PF.stft_logmag_plain(pcm, cos, sin, hop, T)
    torch.cuda.synchronize()
    if got.shape != (B, T, F) or not torch.isfinite(got).all():
        fail(f"stft_logmag: bad output {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    log(f"stft_logmag f32 max_abs_err {err:.3g} (tol {STFT_TOL})")
    if not err <= STFT_TOL:
        fail(f"stft_logmag disagrees with its plain version: {err}")
    window = torch.hamming_window(n_fft, periodic=False, device=dev)
    ms = time_ms(torch, lambda: S.stft_logmag(pcm, cos, sin, hop, T))
    plain_ms = time_ms(torch, lambda: PF.stft_logmag_plain(
        pcm, cos, sin, hop, T))
    lib_ms = time_ms(torch, lambda: torch.stft(
        pcm, n_fft, hop, window=window, center=False,
        return_complex=True).abs().log1p())
    flops = 4 * B * T * n_fft * F
    nbytes = 4 * (B * N + 2 * n_fft * F + B * T * F)
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_BPS
    log(f"stft_logmag ms {ms:.4f} plain {plain_ms:.4f} torch.stft "
        f"{lib_ms:.4f}; bound {1e3 * max(t_ops, t_bytes):.4f} ms "
        f"({flops / 1e9:.3f} GFLOP f32, {nbytes / 1e6:.2f} MB)")
    return {"name": "stft_logmag", "route": "cuda",
            "source": "end2end_asr_tpu_torch/csrc/stft.cu",
            "replaces": "end2end_asr_tpu/ops/stft_pallas.py:57",
            "max_abs_err": err, "tol": STFT_TOL, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms}


def check_vgg(torch, dev):
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    F, T = 161, 800
    g = torch.Generator().manual_seed(SEED + 1)

    def xavier(shape, fan_in, fan_out):
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return ((torch.rand(shape, generator=g) * 2 - 1) * a).to(dev)

    spect = torch.randn(B, F, T, generator=g).to(dev)
    w1 = xavier((3, 3, 1, 64), 9, 576)
    b1 = xavier((64,), 9, 9)
    w2 = xavier((3, 3, 64, 64), 576, 576)
    b2 = xavier((64,), 576, 576)
    args = (spect, w1, b1, w2, b2)
    Fp, Tp = F // 2, T // 2
    errs = {}
    for cdt in (torch.float32, torch.bfloat16):
        idx = torch.empty((B, Fp, Tp, 64), dtype=torch.uint8, device=dev)
        got = V.vgg_block1(*args, cdt=cdt, idx_out=idx)
        want, want_idx = V.vgg_block1_plain(*args, cdt=cdt)
        torch.cuda.synchronize()
        if (got.shape != (B, Fp, Tp, 64) or got.dtype != cdt
                or not torch.isfinite(got.float()).all()):
            fail(f"vgg_block1 {cdt}: bad output")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        same_idx = (idx == want_idx).float().mean().item()
        errs[cdt] = err
        if cdt == torch.float32:
            ok = err <= VGG_F32_TOL
            tol = f"{VGG_F32_TOL}"
        else:
            ok = bool((diff <= VGG_BF16_ATOL
                       + VGG_BF16_RTOL * want.float().abs()).all())
            tol = f"{VGG_BF16_ATOL} + {VGG_BF16_RTOL}*|plain|"
        log(f"vgg_block1 {str(cdt)[6:]} max_abs_err {err:.3g} (tol {tol}); "
            f"pool argmax equal on {100 * same_idx:.4f}% of outputs")
        if not ok or same_idx < 0.99:
            fail(f"vgg_block1 {cdt} disagrees with its plain version")

    times = {}
    for cdt in (torch.float32, torch.bfloat16):
        times[cdt] = (
            time_ms(torch, lambda: V.vgg_block1(*args, cdt=cdt), iters=10),
            time_ms(torch, lambda: V.vgg_block1_plain(*args, cdt=cdt),
                    iters=10))
    xs = spect.to(torch.bfloat16)[:, None]
    w1c = w1.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
    w2c = w2.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
    b1c, b2c = (b.to(torch.bfloat16) for b in (b1, b2))
    lib_ms = time_ms(torch, lambda: torch.relu(Fn.max_pool2d(Fn.conv2d(
        torch.relu(Fn.conv2d(xs, w1c, b1c, padding=1)), w2c, padding=1), 2)
        + b2c[None, :, None, None]), iters=10)
    flops = 2 * B * F * T * 64 * (9 + 576)
    nbytes = 4 * (B * F * T + 9 * 64 + 576 * 64 + 128) + 2 * B * Fp * Tp * 64
    t_ops, t_bytes = flops / BF16_PEAK, nbytes / HBM_BPS
    for cdt, (k, p) in times.items():
        log(f"vgg_block1 {str(cdt)[6:]} ms {k:.4f} plain {p:.4f}")
    log(f"vgg_block1 cuDNN bf16 conv2d x2 + max_pool2d {lib_ms:.4f} ms; "
        f"bf16 bound {1e3 * max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.1f} "
        f"GFLOP at 989 TFLOP/s; f32 FMA bound "
        f"{1e3 * flops / F32_PEAK:.4f} ms)")
    # the serving path runs the bf16 kernel: its numbers go in the line
    return {"name": "vgg_block1_fwd", "route": "cuda",
            "source": "end2end_asr_tpu_torch/csrc/vgg_block1.cu",
            "replaces": "end2end_asr_tpu/ops/vgg_fused.py:183",
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_f32": errs[torch.float32],
            "ms": times[torch.bfloat16][0],
            "plain_ms": times[torch.bfloat16][1],
            "ms_f32": times[torch.float32][0],
            "plain_ms_f32": times[torch.float32][1],
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms}


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def make_corpus(root, labels, rng):
    """12 WAVs of 7-7.99 s (tones + noise) with random transcripts."""
    import numpy as np
    from end2end_asr_tpu_torch.data.audio import save_wav
    sr = 16000
    rows = []
    chars = [c for c in labels if c.strip()]
    for i in range(B):
        n = int(rng.uniform(7.0, SECONDS_MAX) * sr)
        t = np.arange(n) / sr
        y = 0.3 * np.sin(2 * math.pi * (100 + 40 * i) * t) \
            + 0.05 * rng.randn(n)
        wav = os.path.join(root, f"u{i}.wav")
        txt = os.path.join(root, f"u{i}.txt")
        save_wav(wav, y, sr)
        with open(txt, "w", encoding="utf-8") as f:
            f.write("".join(rng.choice(chars, rng.randint(8, 20))))
        rows.append(f"{wav},{txt}")
    manifest = os.path.join(root, "manifest.csv")
    with open(manifest, "w") as f:
        f.write("\n".join(rows) + "\n")
    return manifest


def phase_serve(torch, dev, kernels, work):
    """`kernels`: {name: module with launches() / reset_launches()};
    `work`: a scratch directory for the checkpoint and the corpus."""
    import numpy as np
    from end2end_asr_tpu_torch import test as port_test
    from end2end_asr_tpu_torch.config import Config, load_vocab
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import AudioBatchLoader
    from end2end_asr_tpu_torch.decoding.beam import BeamDecoder
    from end2end_asr_tpu_torch.decoding.greedy import \
        greedy_decode_progressive
    from end2end_asr_tpu_torch.evaluation import encode_pcm, prepare_params
    from end2end_asr_tpu_torch.models import decoder as D
    from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                          init_params,
                                                          num_params)
    from end2end_asr_tpu_torch.training.checkpoint import save_checkpoint

    labels_path = os.path.join("data", "labels", "aishell_labels.json")
    with open(labels_path, encoding="utf-8") as f:
        labels = json.load(f)
    cfg = Config(feat_extractor="vgg_cnn", num_layers=4, num_heads=8,
                 dim_model=512, dim_key=64, dim_value=64, dim_inner=2048,
                 dim_emb=512, batch_size=B, labels_path=labels_path,
                 label_smoothing=0.1, dtype="bfloat16", seed=SEED)
    label2id, id2label = load_vocab(labels_path)
    params = init_params(cfg, len(label2id),
                         torch.Generator().manual_seed(SEED))
    log(f"model: {num_params(params) / 1e6:.2f} M params, vocab "
        f"{len(label2id)}")

    ckpt = os.path.join(work, "model")
    save_checkpoint(ckpt, cfg, 0, params, label2id, id2label)
    manifest = make_corpus(work, labels, np.random.RandomState(SEED))
    argv = ["--continue-from", ckpt, "--test-manifest-list", manifest,
            "--batch-size", str(B), "--device", str(dev)]

    runs = {}
    for name, extra in (("greedy", []),
                        ("beam8", ["--beam-search", "--beam-width", "8"])):
        for k in kernels.values():
            k.reset_launches()
        timings = []
        t0 = time.time()
        res = port_test.main(argv + extra, timings=timings)
        torch.cuda.synchronize()
        counts = {n: k.launches() for n, k in kernels.items()}
        log(f"serve {name}: {res} in {time.time() - t0:.2f} s; launches "
            f"{counts}; first-run batch times {timings}")
        if not all(math.isfinite(v) for v in res.values()):
            fail(f"serve {name}: non-finite metrics {res}")
        if sum(t["batch"] for t in timings) != B:
            fail(f"serve {name}: decoded {timings}, expected {B} utts")
        missing = [n for n, c in counts.items() if c < 1]
        if missing:
            fail(f"serve {name}: kernels not launched: {missing}")
        runs[name] = counts

    # steady per-batch times on the same batch (host clock + synchronize)
    dims = dims_from_config(cfg)
    prepared = prepare_params(params, dims, dev)
    data = ManifestDataset([manifest], label2id)
    batch = next(iter(AudioBatchLoader(data, cfg)))
    pcm = torch.from_numpy(batch.pcm).to(dev)
    frames = torch.from_numpy(batch.n_frames.astype(np.int64)).to(dev)

    def host_ms(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out), r

    enc_ms, (enc, _) = host_ms(lambda: encode_pcm(
        prepared, cfg, dims, pcm, frames, batch.src_bucket), 5)
    max_len = min(cfg.decode_max_len, cfg.tgt_max_len)
    greedy_ms, ids = host_ms(lambda: greedy_decode_progressive(
        prepared, enc, dims, max_len=max_len,
        stage_len=cfg.decode_stage_len), 3)
    beam = BeamDecoder(cfg.replace(beam_search=True, beam_width=8), dims,
                       id2label, stage_len=cfg.decode_stage_len)
    beam_ms, hyps = host_ms(lambda: beam.decode(prepared, enc), 2)
    steps = int((ids != 2).sum(dim=1).max().item())
    log(f"per batch of {B} (bucket {batch.src_bucket} frames): encode "
        f"{enc_ms:.2f} ms, greedy {greedy_ms:.2f} ms ({steps} steps), "
        f"beam-8 {beam_ms:.2f} ms")
    if enc.shape != (B, batch.src_bucket // 4, cfg.dim_model) or \
            not torch.isfinite(enc).all():
        fail(f"encoder output {tuple(enc.shape)} not finite / wrong shape")

    breakdown = {
        "encode": profile(torch, lambda: encode_pcm(
            prepared, cfg, dims, pcm, frames, batch.src_bucket)),
        "greedy_64_steps": profile(torch, lambda: greedy_decode_progressive(
            prepared, enc, dims, max_len=64, stage_len=64))}

    # encoder on the card (f32, TF32 off) vs the port's CPU path
    cfg32 = cfg.replace(dtype="float32")
    dims32 = dims_from_config(cfg32)
    p_gpu = prepare_params(params, dims32, dev)
    p_cpu = prepare_params(params, dims32, torch.device("cpu"))
    one = torch.from_numpy(batch.pcm[:1])
    fr1 = torch.from_numpy(batch.n_frames[:1].astype(np.int64))
    e_gpu, _ = encode_pcm(p_gpu, cfg32, dims32, one.to(dev), fr1.to(dev),
                          batch.src_bucket)
    e_cpu, _ = encode_pcm(p_cpu, cfg32, dims32, one, fr1,
                          batch.src_bucket)
    err = (e_gpu.cpu() - e_cpu).abs().max().item()
    log(f"encoder f32 card vs CPU (one utterance): max_abs_err {err:.3g} "
        f"(tol {ENC_TOL}), output {tuple(e_gpu.shape)}")
    if not err <= ENC_TOL:
        fail(f"encoder on the card disagrees with the CPU path: {err}")
    # the TF32 hazard: the same comparison with cuDNN/cuBLAS allowed TF32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    e_tf32, _ = encode_pcm(p_gpu, cfg32, dims32, one.to(dev), fr1.to(dev),
                           batch.src_bucket)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    err_tf32 = (e_tf32.cpu() - e_cpu).abs().max().item()
    log(f"encoder with TF32 allowed vs CPU: max_abs_err {err_tf32:.3g} "
        "(why every f32 comparison here turns TF32 off)")

    # decoder steps (f32) on the card vs the CPU path, teacher-forced on
    # the same encoder output
    dec_steps = 8
    toks = np.random.RandomState(SEED).randint(
        0, len(label2id), size=(dec_steps, 1))
    logits = []
    for p, d in ((p_gpu, dev), (p_cpu, torch.device("cpu"))):
        cache = D.init_cache(p["decoder"], e_cpu.to(d), dec_steps,
                             dims32.num_heads, dims32.dim_key,
                             dims32.dim_value, dtype=torch.float32)
        logits.append(torch.stack([D.decode_step(
            p["decoder"], cache, torch.from_numpy(toks[t]).to(d), t,
            dims32.num_heads, dims32.dim_key, dims32.dim_value,
            dims32.dim_model, emb_trg_sharing=dims32.emb_trg_sharing,
            dtype=torch.float32).cpu() for t in range(dec_steps)]))
    dec_err = (logits[0] - logits[1]).abs().max().item()
    log(f"decode_step f32 card vs CPU ({dec_steps} steps): max_abs_err "
        f"{dec_err:.3g} (tol {DEC_TOL})")
    if not dec_err <= DEC_TOL:
        fail(f"decoder on the card disagrees with the CPU path: {dec_err}")
    return runs, {"encode_ms": enc_ms, "greedy_ms": greedy_ms,
                  "beam8_ms": beam_ms, "greedy_steps": steps,
                  "encoder_f32_card_vs_cpu_max_abs_err": err,
                  "encoder_tf32_card_vs_cpu_max_abs_err": err_tf32,
                  "decode_step_f32_card_vs_cpu_max_abs_err": dec_err,
                  "profile": breakdown}


def profile(torch, fn, top=6):
    """One warm call of fn under torch.profiler: wall ms, summed device
    time of its kernels, their share of the wall time (the device's busy
    share; the rest is idle, waiting on the host), launches, and the
    kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    # no kernel events: the profiler saw no device time ("not measured")
    dev_ms = sum(by_name.values()) if kernels else None
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = {"wall_ms": wall, "device_ms": dev_ms,
           "device_busy_share": dev_ms / wall if kernels else None,
           "kernel_launches": len(kernels),
           "top": [[n[:60], ms] for n, ms in heavy]}
    log(f"profile: {json.dumps(out)}")
    return out


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    try:
        from end2end_asr_tpu_torch.ops import cuda_lib, stft, vgg_fused
    except ImportError as e:
        fail(f"the port is not importable ({e}); run from the repo root")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # every f32 comparison below runs in full f32: cuDNN's convolutions
    # default to TF32 on this card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    gpu = gpu_line()
    log(f"gpu: {gpu}")

    t0 = time.time()
    phase_build(cuda_lib)
    entries = [check_stft(torch, dev), check_vgg(torch, dev)]
    kernels = {"stft_logmag": stft, "vgg_block1_fwd": vgg_fused}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        runs, serve = phase_serve(torch, dev, kernels, work)
    for e in entries:
        e["launches"] = runs["greedy"][e["name"]]
        e["launches_beam8"] = runs["beam8"][e["name"]]
    log(f"serving times: {serve}; total {time.time() - t0:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": entries, "serve": serve, "gpu": gpu}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
