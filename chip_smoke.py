#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (end2end_asr_tpu_torch) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero without the final result line):
  1. build every CUDA kernel of the port from csrc/ (one nvcc per
     source, all started together) and the host C++ library
     (csrc/audio_host.cc, g++: its WSOLA is augmentation's path, so a
     failed build fails here), and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card at
     the shapes the serving and training paths give it (B=12, T=800,
     F=161; f32 with TF32 off, and bf16): the STFT (the FFT kernel that
     n_fft 320 takes and the direct-sum kernel, and the wrapper's choice
     at n_fft 322), the vgg block-1 forward and backward, the dropout
     attention forward and backward in bf16 and in f32 (encoder self- and
     decoder cross-attention, rates 0 and 0.1) on the step's layout
     (transposed views of (B, T, H, D) tensors; out must come back in
     (B, Tq, H, D) memory, bit-equal to contiguous inputs), the dropout
     bits (bit-exact at the encoder shapes of the 800- and 1600-frame
     buckets and three seeds; the kernel's own device time beside its
     bound from bytes and from its SASS's integer instructions), the
     block-2 pool backward (exact, channels-last as in the step and NCHW),
     the fused vgg block-2 forward and backward at (12, 80, 400, 64) and at
     a second even shape, and the two streaming probes at (38400, 1024)
     (the copy and torch.add(x, 1) in rounds of turns); time the kernel, the
     plain version and one PyTorch library yardstick the port never calls
     (the STFT also by its device time under the profiler; the vgg block 1
     also beside cuDNN in f32 with TF32 off; the block-2 forward also
     beside cuDNN on channels-last tensors, the gate-off front end's
     layout);
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
  4. train: the same model at the AiShell README's training settings
     (batch 12, dropout 0.1, label smoothing 0.1, Noam Adam, bf16 over f32
     master weights) through the port's `train` entry point for 2 epochs
     on 24 synthetic ~8 s utterances, with every kernel's launch count set
     to 0 before and read after (each must have launched), then one more
     epoch with --auto-resume (the optimizer step must continue); then,
     on one fixed batch, the launches per step, the median train step
     time over 10 steps, a profile of one step (the block-1 backward's
     one fused kernel must be among its heaviest; its share of the step's
     device time is printed), a traced step (tools/probe_step.py: each
     attention forward and backward and each pool backward must launch
     its one kernel and no copy; the launches and copy kernels per step
     and the pool's layouts are printed), 60 overfitting steps
     (the loss must fall under half its first value), one f32 step
     (dropout 0, TF32 off) on the card against the port's CPU path, and
     2 steps of --dtype float32 at dropout 0.1 through `train` (the f32
     attention kernels must have launched, the loss must be finite);
  5. gate on: with ops.vgg_fused.BLOCK2_ENABLED set, the same model serves
     the 12-utterance batch greedy through `test` and trains an epoch
     through `train` with --spec-augment --remat; the block-2 kernels must
     have launched and the pool backward and every library convolution
     must not; the f32 encoder output equals the gate-off one; the bf16
     encode is timed and profiled with the gate off and on (one block-2
     forward kernel); the step time and the launches per step stand
     beside the gate-off ones, and the step's profile must show one
     block-2 forward kernel and the backward's two;
  6. ctc / emb_cnn: the model with --feat_extractor emb_cnn --loss ctc
     trains six steps on one batch through `train` (the loss must be
     finite and fall), saves, and serves the checkpoint greedy through
     `test` with the saved batch-norm state; a batch whose targets cannot
     be aligned gives an infinite loss and the optimizer step stays;
  7. serve options, on phase 3's model: an LSTM LM at lm_train's default
     size (256 / 256, 2 layers) trained on the card for 20 epochs on the
     phases' transcripts through the `lm_train` entry point (its loss
     must be finite and fall); `test --beam-search --beam-width 8
     --lm-rescoring`, whose n-best LM scores on the card must equal the
     CPU LM's, timed beside plain beam-8; `test --quantize-int8` greedy
     and beam-8, the int8 model's f32 encoder output and 8 decode steps
     on the card against the CPU, encode / greedy / beam timed beside
     phase 3's bf16; `StreamingTranscriber` fed one ~8 s utterance in
     2 s chunks (twice: p50 / p95 ms a feed), whose flush() must equal
     `transcribe` on the file; the serving kernels must launch on each
     path (their counts set to 0 just before, read just after);
  8. augmented joint training: the phase 4 model through the
     `multi_train` entry point with --augment (tempo/gain), --noise-dir
     (a synthesised directory of WAV and AU files) and --num-workers 4,
     on two train manifests (phase 4's 24 utterances and 12 new ones) and
     two valid manifests, for 2 epochs of 2 batches, with the training
     kernels' launch counts set to 0 before and read after (each must
     have launched; a TASK line per task and epoch; the buckets the
     batches landed in, read from the run's log, printed); kernels 1-5
     against their plain versions at the 1600-frame bucket that augmented
     ~8 s utterances land in; the host data path: one augmented and one
     plain batch of 12 built at num_workers 0 and 4 (the loader's tempo
     must run the C++ WSOLA, not the Python fallback), the C++ and the
     Python WSOLA on 7.99 s, on the host clock, and the train step on the
     augmented batch; the
     two epoch checkpoints averaged by `tools.average_checkpoints` (each
     leaf the float64 mean) and served greedy through `test`; a
     reference-layout .th of phase 3's weights converted by
     `tools.convert_reference_checkpoint` (its tensors equal phase 3's bit
     for bit) and served greedy through `test` with phase 3's strings;
  9. data parallelism at the phase 4 width (batch 12, bf16, dropout 0,
     one epoch of 2 steps): a group of one NCCL rank through
     `python -m torch.distributed.run --standalone --nproc_per_node 1 -m
     end2end_asr_tpu_torch.train --parallel` (its checkpoint equal to the
     one-process run's bit for bit); two gloo ranks sharing the card, 6
     rows each, through the same entry point (this script's --ddp-rank
     mode wraps it to read each rank's kernel launches, peak memory and
     step time), plain, --zero1 and --fsdp: each rank must launch the
     hand kernels of the dropout-0 path in the run and all six of the
     default path in its timed steps at dropout 0.1, each run's train
     loss must be the
     one-process run's within DDP_LOSS_RTOL and its parameters within
     Adam's two-step bound, and the ZeRO checkpoints (gathered to rank
     0) plain DDP's within ZERO_RTOL; then `test --parallel` on two ranks
     over phase 3's checkpoint must give phase 3's strings at
     --batch-size 24 (rank 0 decodes phase 3's 12 rows; bf16 sums depend
     on the row count);
  10. tensor and sequence parallelism at the same width (gloo ranks
     sharing the card through the --ddp-rank mode, one epoch of 2 steps
     at dropout 0 each): --mesh-model 2 (2 ranks), --mesh-model 2
     --seq-parallel (2), --mesh-data 2 --mesh-model 2 --zero1 (4) and
     --mesh-model 2 --fsdp --checkpoint-format orbax (2): each rank must
     launch the hand kernels as in phase 9 (attention on its 4 local
     heads), each run's loss and gathered parameters must be phase 9's
     one-process run's within its rules; on a model rank, attn_fwd /
     attn_bwd at 4 heads against their plain versions at rate 0.1, and
     the keep mask of each local head the plain one and the same on both
     ranks; the sharded save (`<base>.dcp`) must load in one process equal
     to the run's gathered parameters and serve their strings through
     `test`; `test --parallel --mesh-model 2` over phase 3's checkpoint
     (12 rows a rank) must give the one-process strings at --dtype
     float32; at bf16 the equal strings are counted. Then at --model
     LRTRFS --rank 100 (`phase_tp_lowrank`): the one-process run of the
     same 2 steps, and one group of 2 gloo ranks that runs --mesh-model 2,
     + --seq-parallel and --fsdp --checkpoint-format orbax, each held as
     above against the one-process LRTRFS run (attention on 4 local
     heads), then `test --parallel --mesh-model 2` over tp2_lr's
     checkpoint and, with --quantize-int8, over phase 3's (f32: one
     process's strings; bf16: counted), and over tp2_sp's at f32, which
     must serve on T slices with one process's strings;
  11. pipeline parallelism at the same width (gloo ranks sharing the card
     through the --ddp-rank mode, the runs of a world size one after the
     other in one group, each one epoch of 2 steps at dropout 0, then the
     timed steps at dropout 0.1; the hand-offs between stages through
     pinned host memory): --mesh-pipe 2 at M 2 and at
     --pipe-microbatches 4 (2 ranks), --mesh-pipe 4 --remat (4, one layer a
     stage), --mesh-pipe 2 --mesh-model 2 (4) and --mesh-data 2
     --mesh-pipe 2 --zero1 (4): each rank must launch its stage's hand
     kernels (stage 0 the front end's, every stage the attention's) and
     no other stage's, each run's loss and gathered parameters must be
     phase 9's one-process run's within its rules; each rank's step time,
     peak memory and hand-offs a step (count, MB, ms) are printed; the
     first run's gathered checkpoint served through one-process `test` on
     phase 3's 12 rows must give the one-process run's strings at --dtype
     float32; at bf16 the equal strings are counted;
  12. --steps-per-dispatch 4 at the same width (batch 12, bf16, dropout
     0.1, the 800-frame bucket): in six mixes (the default, the block-2
     gate on, --spec-augment --remat, emb_cnn with --loss ctc, --grad-accum
     2, --dtype float32) 8 single eager steps and 2 replays of the 4-step
     CUDA graph (training/steps.GraphedSteps) from the same weights and
     seeds must give the same losses, parameters, optimizer state and
     model state bit for bit; an infinite batch inside a group (--loss
     ctc, an infeasible batch) must skip its own step only; a gloo group
     must be refused with a ValueError that names NCCL; the trainer at
     K = 4 and with the Prefetcher off must equal the
     trainer at K = 1 with it; the host ms a step, device ms, busy share,
     kernel and graph launches a step at K = 1 and K = 4, the graphs
     captured, their memory and their captured launches are printed
     (`python3 chip_smoke.py --dispatch-only` runs phases 1 and 12 alone;
     `--nccl-dispatch`, on 4 cards (2 run the 2-rank layouts and report
     the others as not run), the train entry point over NCCL, a card a
     rank, in every layout of phases 9-11 at K = 1 and 4,
     `phase_nccl_dispatch`);
  13. the streaming probe's entry point, its four lines printed;
  14. one JSON line of per-kernel numbers (and the serving, training,
     serve-option, augmented-training, parallelism and dispatch numbers,
     the script's seconds), then the result line {"ok": true, "device":
     {...}}.

Imports nothing of JAX or of the JAX package. Needs one CUDA card.
"""

import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types

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
# training kernels, max |kernel - plain| / max |plain| per tensor
VGG_BWD_F32_TOL = 1e-4   # f32 sums over B*F*T positions in another order
# bf16, against the plain backward on the same forward `out` / `idx`: the
# same pool routing and relu masks, f32 sums in another order; a dx1 sum
# that lands by a bf16 rounding boundary may round to the neighbouring
# bf16 value before dW1 takes it. Dropping that rounding moves dW1 by
# more than this tolerance (tests/test_torch_vgg_block1.py pins it)
VGG_BWD_BF16_TOL = 1e-3
# against autograd of the plain forward, which takes its own pool argmax
# (conv1 / x1 from cuDNN bf16 may sit one bf16 ulp off the kernel's and
# flip a near-tied pool or relu choice) and rounds its gradients to bf16
VGG_BWD_AUTOGRAD_TOL = 2e-2
# block 2 (kernels 7, 8), relative L2 error per tensor, ||k - p|| / ||p||.
VGG2_F32_TOL = 1e-4      # f32 sums of 576 / 1152 products, and over B*F*T
# f32 backward, the tensors downstream of the relu mask (dx, dW3, db3): the
# mask is x2 > 0 of a RECOMPUTED x2, and among 4.9e7 activations a few sit
# within one f32 sum error (~3e-7) of zero, so the kernel and the plain
# version may mask one of them differently. One such element among the
# 2.4e7 active ones moves each of the three norms by (1 / 2.4e7)^0.5 =
# 2e-4, and single dx elements by their whole value (printed as max_rel).
# The arithmetic itself is held to VGG2_F32_TOL with the mask out of play
# (b3 + 10: every activation positive) and at the small shapes of
# tests/test_torch_gpu.py
VGG2_F32_MASK_TOL = 1e-3
# bf16 forward: as block 1 (one bf16 ulp where a sum rounds the other way)
# bf16 backward on the same out / idx: a dx2 or dx sum by a bf16 rounding
# boundary rounds to the neighbouring value: one bf16 ulp (2^-8 relative)
# on a share of the elements of dx; the weight gradients sum those
VGG2_BWD_BF16_TOL = 2 ** -8
# the pool argmax must equal the plain version's wherever the plain conv4's
# best and second-best window values lie further apart than both may move,
# relative to max(|best|, 1): two bf16 ulps (2^-6; below 1 the floor covers
# a conv3 activation that is one bf16 ulp off and moves conv4's sum by
# ~1e-3 whatever its size), or the f32 tolerance
IDX_GAP_BF16, IDX_GAP_F32 = 2 ** -6, 1e-4
STREAM_ADAM_TOL = 1e-6   # the probe's own exactness limit
# bf16 attention: probabilities round to bf16 before (kernel) or after
# (plain) the normalisation, and the backward rounds dS to bf16
ATTN_TOL = 2e-2
# f32 attention, TF32 off on both sides: the same f32 arithmetic summed in
# another order (scores over d, P.V over 64-key tiles with an online
# softmax, the backward over query tiles), max |err| / max |plain| per tensor
ATTN_F32_TOL = 2e-5
ENC_TOL = 2e-3       # f32 encoder, 4 layers: GPU vs CPU sum order
DEC_TOL = 2e-3       # f32 decoder logits, 4 layers: GPU vs CPU sum order
# the LM score (-CE / words + 1) of an n-best string, card vs CPU: f32
# LSTM sums in another order, averaged over the string's words
LM_TOL = 1e-4
# f32 train step, card vs CPU: loss, and each gradient relative to its
# largest value (floor 1e-3 of the largest gradient): sums in another
# order through 8 layers and their backward
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-4, 2e-3
# the block-1 kernels as the profiler names them (csrc/vgg_block1.cu)
BWD_KERNEL_NAME = "vgg_block1_bwd_fused_kernel"
FWD_KERNEL_NAME = "vgg_block1_fwd_wgmma_kernel"   # the bf16 forward
# the attention's kernels (csrc/attention.cu), bf16 and f32
ATTN_FWD_KERNEL_NAME = "attn_fwd_kernel"
ATTN_BWD_KERNEL_NAME = "attn_bwd_kernel"
# the block-2 kernels (csrc/vgg_block2.cu): the bf16 forward, the bf16
# backward's main pass, and the prefix every kernel of the backward carries
# (those of csrc/vgg_block2_f32.cu too; its forward's carry vgg_block2_fwd)
FWD2_KERNEL_NAME = "vgg_block2_fwd_wgmma_kernel"
BWD2_KERNEL_NAME = "vgg_block2_bwd_rows_kernel"
BWD2_PREFIX = "vgg_block2_bwd"


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


def backward_ms(torch, out, inputs, g, iters):
    """Mean time of the backward alone: autograd through one retained
    graph (a difference of forward+backward and forward times can come
    out negative where both are host-bound)."""
    return time_ms(torch, lambda: torch.autograd.grad(
        out, inputs, g, retain_graph=True), iters=iters)


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
    from end2end_asr_tpu_torch.data import audio_host
    t0 = time.time()
    paths = cuda_lib.build(["stft", "vgg_block1", "vgg_block1_f32",
                            "attention", "pool_bwd", "vgg_block2",
                            "vgg_block2_f32", "stream", "ctc", "adam"])
    log(f"built {sorted(paths)} in {time.time() - t0:.1f} s")
    # the host C++ WSOLA (csrc/audio_host.cc): a CUDA host has g++ (nvcc
    # needs it), so the Python fallback must not hide a failed build
    if not audio_host.available():
        fail(f"csrc/audio_host.cc did not build: {audio_host.build_error()}")
    log(f"host library {audio_host.library_path()} loaded; augmentation's "
        f"tempo path: {audio_host.active()}")
    for src in sorted(paths):
        for ln in cuda_lib.build_log(src).splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {src}: {ln.strip()}")
    return paths


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def device_ms(torch, fn, iters=20, name=None):
    """Summed device time of the kernels of one fn() call (those whose
    names hold `name`, where given), mean over `iters` calls under
    torch.profiler (no host time), or None where the profiler saw no
    device time."""
    from end2end_asr_tpu_torch.tools import probe_lib as PL
    fn()
    with PL.profiled(torch, cpu=True) as prof:
        for _ in range(iters):
            fn()
    us = [e.time_range.elapsed_us() for e in PL.device_events(torch, prof)
          if name is None or name in e.name]
    return sum(us) / 1e3 / iters if us else None


def check_stft(torch, dev):
    """Kernel 1 at the main path's shape: the FFT kernel (the path n_fft =
    320 takes) and the direct-sum kernel, each against the plain version;
    the wrapper's choice by shape at n_fft = 322 (161 = 7·23)."""
    from end2end_asr_tpu_torch.ops import features as PF
    from end2end_asr_tpu_torch.ops import stft as S
    n_fft, hop, T = 320, 160, 800
    N = (T - 1) * hop + n_fft
    g = torch.Generator().manual_seed(SEED)
    pcm = (torch.randn(B, N, generator=g) * 0.1).mul(32768).round().div(
        32768).to(dev)
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in PF.dft_matrices(n_fft, "hamming"))
    win = S.window_vector(n_fft, "hamming", str(dev))
    F = cos.shape[1]
    want = PF.stft_logmag_plain(pcm, cos, sin, hop, T)
    S.reset_launches()
    got = S.stft_logmag(pcm, n_fft, hop, T, "hamming")
    routed = (S.FFT.launches, S.DFT.launches)
    got_dft = S.stft_logmag_dft(pcm, cos, sin, hop, T)
    torch.cuda.synchronize()
    errs = {}
    for name, out in (("fft", got), ("dft", got_dft)):
        if out.shape != (B, T, F) or not torch.isfinite(out).all():
            fail(f"stft_logmag {name}: bad output {tuple(out.shape)}")
        errs[name] = (out - want).abs().max().item()
    # n_fft 322: no FFT plan, the wrapper takes the direct sum
    n2, h2, t2 = 322, 161, 50
    pcm2 = pcm[:2, :(t2 - 1) * h2 + n2].contiguous()
    c2, s2 = (torch.from_numpy(a).to(dev)
              for a in PF.dft_matrices(n2, "hamming"))
    S.reset_launches()
    got2 = S.stft_logmag(pcm2, n2, h2, t2, "hamming")
    routed2 = (S.FFT.launches, S.DFT.launches)
    err2 = (got2 - PF.stft_logmag_plain(pcm2, c2, s2, h2, t2)).abs().max(
        ).item()
    log(f"stft_logmag f32 max_abs_err: FFT kernel {errs['fft']:.3g}, "
        f"direct-sum kernel {errs['dft']:.3g}, direct sum at n_fft 322 "
        f"{err2:.3g} (tol {STFT_TOL}); launches (fft, dft) at n_fft 320 "
        f"{routed}, at 322 {routed2}")
    if not max(errs["fft"], errs["dft"], err2) <= STFT_TOL:
        fail(f"stft_logmag disagrees with its plain version: {errs}, {err2}")
    if routed != (1, 0) or routed2 != (0, 1):
        fail(f"stft_logmag took the wrong path: {routed}, {routed2}")

    window = torch.hamming_window(n_fft, periodic=False, device=dev)
    lib = lambda: torch.stft(pcm, n_fft, hop, window=window, center=False,
                             return_complex=True).abs().log1p()
    fft = lambda: S.stft_logmag(pcm, n_fft, hop, T, "hamming")
    dft = lambda: S.stft_logmag_dft(pcm, cos, sin, hop, T)
    plain = lambda: PF.stft_logmag_plain(pcm, cos, sin, hop, T)
    # the library and the kernel in turns: lib, fft, fft, lib
    lib_ms = [time_ms(torch, lib)]
    ms = [time_ms(torch, fft), time_ms(torch, fft)]
    lib_ms.append(time_ms(torch, lib))
    dft_ms, plain_ms = time_ms(torch, dft), time_ms(torch, plain)
    dev_ms = {k: device_ms(torch, f) for k, f in
              (("fft", fft), ("dft", dft), ("lib", lib))}
    # bound: the FFT's operations (the formula of csrc/stft.cu, from the
    # radix plan) against the bytes (PCM in, window and twiddles, spectrum
    # out); the direct sum's 4·B·T·n_fft·F operations kept beside it
    plan = S.fft_plan(n_fft)
    M = n_fft // 2
    ops = n_fft + 18 * (M // 2 + 1) + 5 * (M + 1)
    ns = 1
    for r in plan:
        ops += (M // r) * (S.BUTTERFLY_OPS[r] + (6 * (r - 1) if ns > 1 else 0))
        ns *= r
    if ops != S.fft_ops_per_frame(n_fft):
        fail(f"stft op count {ops} != {S.fft_ops_per_frame(n_fft)}")
    flops = B * T * ops
    dft_flops = 4 * B * T * n_fft * F
    nbytes = 4 * (B * N + n_fft + 2 * (M + M // 2 + 1) + B * T * F)
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_BPS
    bound = 1e3 * max(t_ops, t_bytes)
    dft_bound = 1e3 * max(dft_flops / F32_PEAK,
                          4 * (B * N + 2 * n_fft * F + B * T * F) / HBM_BPS)
    ms = min(ms)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    log(f"stft_logmag (B {B}, T {T}, n_fft {n_fft}, hop {hop}, plan "
        f"{plan}): FFT kernel {ms:.4f} ms (device {fmt(dev_ms['fft'])}), "
        f"direct-sum kernel {dft_ms:.4f} (device {fmt(dev_ms['dft'])}), "
        f"plain {plain_ms:.4f}, torch.stft+abs+log1p {lib_ms} (device "
        f"{fmt(dev_ms['lib'])}); bound {bound:.4f} ms = max(ops "
        f"{B * T} frames x {ops} = {flops / 1e6:.2f} MFLOP -> "
        f"{1e3 * t_ops:.4f} ms, bytes {nbytes / 1e6:.3f} MB -> "
        f"{1e3 * t_bytes:.4f} ms); direct-sum bound {dft_bound:.4f} ms "
        f"({dft_flops / 1e9:.3f} GFLOP)")
    if dev_ms["fft"]:
        log(f"stft_logmag FFT kernel: {nbytes / dev_ms['fft'] / 1e9:.2f} "
            f"TB/s of device time, {bound / dev_ms['fft']:.3f} of its bound")
    src, rep = "stft.cu", "end2end_asr_tpu/ops/stft_pallas.py:57"
    return [entry("stft_logmag", src, rep, errs["fft"], ms, plain_ms, t_ops,
                  t_bytes, min(lib_ms), tol=STFT_TOL, path="fft",
                  plan=list(plan), device_ms=dev_ms["fft"],
                  library_device_ms=dev_ms["lib"], library_ms_all=lib_ms,
                  bound_dft_ms=dft_bound, ops_per_frame=ops),
            entry("stft_logmag_dft", src, rep, errs["dft"], dft_ms, plain_ms,
                  dft_flops / F32_PEAK,
                  4 * (B * N + 2 * n_fft * F + B * T * F) / HBM_BPS,
                  min(lib_ms), tol=STFT_TOL, path="dft",
                  device_ms=dev_ms["dft"], max_abs_err_n_fft_322=err2,
                  note="the path of an n_fft without an FFT plan; timed at "
                       "n_fft 320 beside the FFT kernel")]


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
    # the bf16 kernel's own device time (the wrapper also packs W2):
    # with the pool argmax (training) and without (serving)
    idx = torch.empty((B, Fp, Tp, 64), dtype=torch.uint8, device=dev)
    dev_ms = {mode: device_ms(torch, lambda: V.vgg_block1(
        *args, cdt=torch.bfloat16, idx_out=ix), name=FWD_KERNEL_NAME)
        for mode, ix in (("idx", idx), ("no_idx", None))}
    # the f32 entry's kernel (csrc/vgg_block1_f32.cu), with idx (training)
    dev_ms["f32"] = device_ms(torch, lambda: V.vgg_block1(
        *args, cdt=torch.float32, idx_out=idx), name="vgg_block1_fwd")
    lib = {}
    for cdt in (torch.bfloat16, torch.float32):   # TF32 off (main)
        xs = spect.to(cdt)[:, None]
        w1c = w1.to(cdt).permute(3, 2, 0, 1).contiguous()
        w2c = w2.to(cdt).permute(3, 2, 0, 1).contiguous()
        b1c, b2c = (b.to(cdt) for b in (b1, b2))
        lib[cdt] = time_ms(torch, lambda: torch.relu(Fn.max_pool2d(Fn.conv2d(
            torch.relu(Fn.conv2d(xs, w1c, b1c, padding=1)), w2c, padding=1),
            2) + b2c[None, :, None, None]), iters=10)
    lib_ms = lib[torch.bfloat16]
    work = vgg1_work(B, F, T)
    flops = work["fwd_flop"]
    t_ops, t_bytes = flops / BF16_PEAK, work["fwd_bytes_bf16"] / HBM_BPS
    for cdt, (k, p) in times.items():
        log(f"vgg_block1 {str(cdt)[6:]} ms {k:.4f} plain {p:.4f}")
    log(f"vgg_block1 bf16 {FWD_KERNEL_NAME} device ms {dev_ms['idx']} "
        f"with idx, {dev_ms['no_idx']} without; f32 {dev_ms['f32']} "
        f"({tflops(flops, dev_ms['f32'])} TFLOP/s)")
    log(f"vgg_block1 cuDNN bf16 conv2d x2 + max_pool2d {lib_ms:.4f} ms "
        f"(f32, TF32 off: {lib[torch.float32]:.4f}); "
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
            "device_ms": dev_ms["idx"], "device_ms_no_idx": dev_ms["no_idx"],
            "plain_ms": times[torch.bfloat16][1],
            "ms_f32": times[torch.float32][0],
            "plain_ms_f32": times[torch.float32][1],
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "library_ms_f32": lib[torch.float32],
            "device_ms_f32": dev_ms["f32"],
            "tflops_f32": tflops(flops, dev_ms["f32"]),
            "bound_ms_f32": 1e3 * max(flops / F32_PEAK,
                                      work["fwd_bytes_f32"] / HBM_BPS),
            "source_f32": "end2end_asr_tpu_torch/csrc/vgg_block1_f32.cu"}


def vgg1_work(B, F, T):
    """What block 1's forward and backward must do at x (B, F, T), for
    their bounds: conv2 and dW2 at the 2 Fp x 2 Tp positions the pool
    keeps; conv1 (recomputed in the backward), dx1 and dW1 at the F x T
    positions of the image (FLOP); x and the weights read once, out and
    idx written once by the forward, out, idx and g read once by the
    backward and the weight gradients written once (bytes, by the compute
    dtype's size)."""
    keep, full = B * (F // 2 * 2) * (T // 2 * 2), B * F * T
    pooled, wts = B * (F // 2) * (T // 2) * 64, 9 * 64 + 64 + 576 * 64 + 64
    w = {"fwd_flop": 2 * 64 * (keep * 576 + full * 9),
         "bwd_flop": 2 * 64 * ((keep + full) * 576 + 2 * full * 9)}
    for name, size in (("bf16", 2), ("f32", 4)):
        w[f"fwd_bytes_{name}"] = 4 * (full + wts) + (size + 1) * pooled
        w[f"bwd_bytes_{name}"] = (4 * (full + wts) + (2 * size + 1) * pooled
                                  + 4 * wts)
    return w


def tflops(flop, ms):
    """flop / ms in TFLOP/s (None where the profiler saw no time)."""
    return flop / (1e9 * ms) if ms else None


def rel_err(a, b):
    """max |a - b| over max |b| (floor 1e-3)."""
    b = b.float()
    return ((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-3)
            ).item()


def entry(name, source, replaces, err, ms, plain_ms, t_ops, t_bytes,
          lib_ms, **extra):
    e = {"name": name, "route": "cuda",
         "source": f"end2end_asr_tpu_torch/csrc/{source}",
         "replaces": replaces, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "library_ms": lib_ms}
    e.update(extra)
    return e


def check_vgg_bwd(torch, dev):
    """Kernel 3 at the training shapes, bf16 (the main path) and f32."""
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    F, T = 161, 800
    g0 = torch.Generator().manual_seed(SEED + 2)
    spect = torch.randn(B, F, T, generator=g0).to(dev)
    ws = [(torch.randn(*s, generator=g0) * sc).to(dev) for s, sc in
          (((3, 3, 1, 64), 0.3), ((64,), 0.1), ((3, 3, 64, 64), 0.05),
           ((64,), 0.1))]
    res = {}
    for cdt in (torch.bfloat16, torch.float32):
        idx = torch.empty((B, F // 2, T // 2, 64), dtype=torch.uint8,
                          device=dev)
        out = V.vgg_block1(spect, *ws, cdt=cdt, idx_out=idx)
        g = torch.randn(out.shape, generator=g0).to(dev, cdt)
        got = V.vgg_block1_bwd(spect, *ws[:3], out, idx, g, cdt)
        want = V.vgg_block1_bwd_plain(spect, *ws[:3], out, idx, g, cdt)
        again = V.vgg_block1_bwd(spect, *ws[:3], out, idx, g, cdt)
        # and autograd through the plain forward (VGG_BWD_AUTOGRAD_TOL)
        wr = [w.clone().requires_grad_() for w in ws]
        o2, _ = V.vgg_block1_plain(spect, *wr, cdt=cdt)
        auto = torch.autograd.grad(o2, wr, g)
        torch.cuda.synchronize()
        tol = VGG_BWD_F32_TOL if cdt == torch.float32 else VGG_BWD_BF16_TOL
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        auto_errs = [rel_err(a, b) for a, b in zip(got, auto)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"vgg_block1_bwd {str(cdt)[6:]} rel err dW1/db1/dW2/db2 "
            f"{errs} (tol {tol}); vs autograd of the plain forward "
            f"{auto_errs} (tol {VGG_BWD_AUTOGRAD_TOL}); two runs "
            f"bit-identical: {same}")
        if not (max(errs) <= tol and max(auto_errs) <= VGG_BWD_AUTOGRAD_TOL
                and same and all(torch.isfinite(a).all() for a in got)):
            fail(f"vgg_block1_bwd {cdt} disagrees with its plain version")
        ms = time_ms(torch, lambda: V.vgg_block1_bwd(
            spect, *ws[:3], out, idx, g, cdt), iters=10)
        plain = time_ms(torch, lambda: V.vgg_block1_bwd_plain(
            spect, *ws[:3], out, idx, g, cdt), iters=5)
        # the f32 entry's kernels (csrc/vgg_block1_f32.cu) on the device
        dms = device_ms(torch, lambda: V.vgg_block1_bwd(
            spect, *ws[:3], out, idx, g, cdt), iters=10,
            name="vgg_block1_bwd") if cdt == torch.float32 else None
        res[cdt] = (max(errs), ms, plain,
                    max((a - b).abs().max().item() for a, b in zip(got, want)),
                    dms)
    # cuDNN: autograd of conv2d x2 + max_pool2d, less its forward; bf16
    # and f32 (TF32 off, main)
    gl = torch.randn(B, 64, F // 2, T // 2, generator=g0).to(dev)
    lib = {}
    for cdt in (torch.bfloat16, torch.float32):
        xs = spect.to(cdt)[:, None]
        wc = [w.to(cdt).requires_grad_() for w in ws]
        gc = gl.to(cdt)

        def lib_fwd(xs=xs, wc=wc):
            y = Fn.conv2d(xs, wc[0].permute(3, 2, 0, 1), wc[1], padding=1)
            y = Fn.conv2d(torch.relu(y), wc[2].permute(3, 2, 0, 1),
                          padding=1)
            return torch.relu(Fn.max_pool2d(y, 2)
                              + wc[3][None, :, None, None])
        fwd_ms = time_ms(torch, lib_fwd, iters=5)
        both_ms = time_ms(torch, lambda: torch.autograd.grad(
            lib_fwd(), wc, gc), iters=5)
        lib[cdt] = both_ms - fwd_ms
    work = vgg1_work(B, F, T)
    flops = work["bwd_flop"]
    err, ms, plain, abs_err, _ = res[torch.bfloat16]
    dms32 = res[torch.float32][4]
    log(f"vgg_block1_bwd bf16 ms {ms:.4f} plain {plain:.4f}; f32 ms "
        f"{res[torch.float32][1]:.4f}, device {dms32} "
        f"({tflops(flops, dms32)} TFLOP/s of the useful {flops / 1e9:.1f} "
        f"GFLOP), plain {res[torch.float32][2]:.4f}; "
        f"cuDNN conv2d x2 + max_pool2d backward ~{lib[torch.bfloat16]:.4f} "
        f"(f32, TF32 off: ~{lib[torch.float32]:.4f}) "
        f"({flops / 1e9:.1f} GFLOP)")
    return entry("vgg_block1_bwd", "vgg_block1.cu",
                 "end2end_asr_tpu/ops/vgg_fused.py:214", abs_err, ms, plain,
                 flops / BF16_PEAK, work["bwd_bytes_bf16"] / HBM_BPS,
                 lib[torch.bfloat16],
                 rel_err=err, rel_err_f32=res[torch.float32][0],
                 ms_f32=res[torch.float32][1],
                 plain_ms_f32=res[torch.float32][2],
                 bound_ms_f32=1e3 * max(flops / F32_PEAK,
                                        work["bwd_bytes_f32"] / HBM_BPS),
                 library_ms_f32=lib[torch.float32], device_ms_f32=dms32,
                 tflops_f32=tflops(flops, dms32),
                 source_f32="end2end_asr_tpu_torch/csrc/vgg_block1_f32.cu")


def attention_runs(torch, AF, qkv, bias, dout, seed, rate):
    """flash_mha_train forward and backward twice on q, k, v and dout as
    given (transposed views of (B, T, H, D) tensors, the step's layout)
    and once on contiguous copies: the two runs, and whether out lies in
    (B, Tq, H, D) memory, the gradients in the layouts of q, k, v, and the
    contiguous inputs give the same bits."""
    def run(ts, g):
        leaves = [t.detach().requires_grad_() for t in ts]
        out = AF.flash_mha_train(*leaves, bias, seed, rate)
        return (out, *torch.autograd.grad(out, leaves, g))
    runs = [run(qkv, dout) for _ in range(2)]
    dense = run([t.contiguous() for t in qkv], dout.contiguous())
    out, *grads = runs[0]
    return runs, {
        "out_in_BTHD_memory": out.transpose(1, 2).is_contiguous(),
        "grads_in_input_layouts": all(
            a.stride() == t.stride() for a, t in zip(grads, qkv)),
        "equal_to_contiguous_inputs": all(
            torch.equal(a, b) for a, b in zip(runs[0], dense))}


def check_attention(torch, dev):
    """Kernels 4, 5 at the encoder self-attention (T = 200), decoder
    cross-attention (U + 1 = 51 queries) and causal decoder self-attention
    (51 x 51) shapes, rates 0 and 0.1; kernel 9 bit-exact against the plain
    Philox."""
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch.ops import attention_fused as AF
    H, D = 8, 64
    g0 = torch.Generator().manual_seed(SEED + 3)
    out_entries, times, key_splits = {}, {}, {}
    for label, Tq, Tk in (("enc_self", 200, 200), ("dec_cross", 51, 200),
                          ("dec_self", 51, 51)):
        # the step's layout: transposed views of the (B, T, H, D)
        # projections; and contiguous copies of them
        q, k, v = (torch.randn(B, t, H, D, generator=g0).to(
            dev, torch.bfloat16).transpose(1, 2) for t in (Tq, Tk, Tk))
        mask = torch.rand(B, Tq, Tk, generator=g0) < 0.1
        if label == "dec_self":
            mask |= torch.ones(Tq, Tk, dtype=torch.bool).triu(1)
        mask[0, 0] = True                 # a query with every key masked
        bias = torch.where(mask, -1e9, 0.0).to(dev)
        dout = torch.randn(B, Tq, H, D, generator=g0).to(
            dev, torch.bfloat16).transpose(1, 2)
        for rate in (0.0, 0.1):
            seed = 0x5EED + int(rate * 10)
            runs, layout = attention_runs(torch, AF, (q, k, v), bias, dout,
                                          seed, rate)
            qf = [t.float().requires_grad_() for t in (q, k, v)]
            want = AF.flash_mha_train_plain(*qf, bias, seed, rate)
            want_g = torch.autograd.grad(want, qf, dout.float())
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            out, *grads = runs[0]
            ef = rel_err(out, want)
            eb = [rel_err(a, b) for a, b in zip(grads, want_g)]
            log(f"attention {label} rate {rate}: fwd rel err {ef:.3g}, "
                f"dq/dk/dv {[round(e, 6) for e in eb]} (tol {ATTN_TOL}); "
                f"two runs bit-identical: {same}; {layout}")
            if not (ef <= ATTN_TOL and max(eb) <= ATTN_TOL and same
                    and all(layout.values())
                    and torch.isfinite(out.float()).all()):
                fail(f"attention {label} rate {rate} disagrees with plain")
            out_entries[(label, rate)] = (
                (out.float() - want).abs().max().item(),
                max((a.float() - b).abs().max().item()
                    for a, b in zip(grads, want_g)))
        rate, seed = 0.1, 77
        o, stats = AF.attn_fwd(q, k, v, bias, seed, rate)
        fwd = lambda: AF.attn_fwd(q, k, v, bias, seed, rate)
        bwd = lambda: AF.attn_bwd(q, k, v, bias, o, stats, dout, seed, rate)
        fwd_ms, bwd_ms = (time_ms(torch, f, iters=50) for f in (fwd, bwd))
        fwd_dev, bwd_dev = (device_ms(torch, f) for f in (fwd, bwd))
        qf = [t.float() for t in (q, k, v)]
        pf_ms = time_ms(torch, lambda: AF.flash_mha_train_plain(
            *qf, bias, seed, rate), iters=5)
        qg = [t.float().requires_grad_() for t in (q, k, v)]
        pb_ms = backward_ms(torch, AF.flash_mha_train_plain(
            *qg, bias, seed, rate), qg, dout.float(), iters=5)
        ql = [t.clone().requires_grad_() for t in (q, k, v)]
        bl = bias[:, None].to(torch.bfloat16)
        sdpa = lambda: Fn.scaled_dot_product_attention(*ql, attn_mask=bl,
                                                       dropout_p=rate)
        lf_ms = time_ms(torch, sdpa, iters=50)
        lb_ms = backward_ms(torch, sdpa(), ql, dout, iters=50)
        n = B * H * Tq * Tk * D
        in_b = 2 * B * H * (Tq + 2 * Tk) * D + 4 * B * Tq * Tk
        key_splits[label] = AF.fwd_key_split(
            B, H, Tq, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        times[label] = dict(
            fwd=(fwd_ms, pf_ms, 4 * n / BF16_PEAK,
                 (in_b + 2 * B * H * Tq * D + 8 * B * H * Tq) / HBM_BPS,
                 lf_ms),
            bwd=(bwd_ms, pb_ms, 10 * n / BF16_PEAK,
                 (in_b + 2 * 2 * B * H * Tq * D + 8 * B * H * Tq
                  + 2 * B * H * (Tq + 2 * Tk) * D) / HBM_BPS, lb_ms),
            dev=(fwd_dev, bwd_dev))
        log(f"attention {label} (rate 0.1): fwd {fwd_ms:.4f} ms, device "
            f"{fwd_dev} (plain {pf_ms:.4f}, SDPA {lf_ms:.4f}); bwd "
            f"{bwd_ms:.4f} ms, device {bwd_dev} (plain {pb_ms:.4f}, SDPA "
            f"backward ~{lb_ms:.4f})")

    # kernel 9 at the encoder shapes of the 800- and 1600-frame buckets:
    # bit-exact with the plain Philox at three seeds, and deterministic; the
    # wrapper's events, the kernel's own device time, and its bound (bytes
    # written; integer instructions of the built kernel from its SASS)
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.tools import probe_dropout_bits as PD
    from end2end_asr_tpu_torch.tools import probe_lib as PL
    ops = PD.int_ops(PD.sass_opcodes(cuda_lib.library_path("attention"),
                                     "dropout_bits_kernelILb1E"))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = PD.max_sm_clock_hz()
    bits_t = {}
    for label, (Bb, Hb, Tq, Tk) in PD.SHAPES.items():
        for seed in PD.SEEDS:
            bits = AF.dropout_bits(seed, Bb, Hb, Tq, Tk, device=dev)
            want = AF.dropout_bits_plain(seed, Bb, Hb, Tq, Tk, device=dev)
            if not (torch.equal(bits, want) and torch.equal(
                    bits, AF.dropout_bits(seed, Bb, Hb, Tq, Tk, device=dev))):
                fail(f"dropout_bits {label} seed {seed:#x} differs from the "
                     "plain Philox stream")
        keep = (bits < AF.dropout_thresh16(0.1) * 65536).double().mean()
        wrap = lambda: AF.dropout_bits(seed, Bb, Hb, Tq, Tk, device=dev)
        by_kernel = PL.kernel_ms(torch, wrap)
        b = PD.bound(Bb, Hb, Tq, Tk, ops, sms, clock)
        bits_t[label] = dict(
            ms=time_ms(torch, wrap), bound=b,
            device_ms=sum(v for n, v in by_kernel.items()
                          if "dropout_bits_kernel" in n),
            widen_device_ms=sum(v for n, v in by_kernel.items()
                                if "dropout_bits_kernel" not in n),
            plain_ms=time_ms(torch, lambda: AF.dropout_bits_plain(
                seed, Bb, Hb, Tq, Tk, device=dev), iters=3))
        log(f"dropout_bits {label} ({Bb}, {Hb}*{Tq}, {Tk}): bit-exact at "
            f"seeds {[hex(x) for x in PD.SEEDS]}; keep fraction "
            f"{keep.item():.6f} (expected "
            f"{AF.dropout_thresh16(0.1) / 65536:.6f}); {bits_t[label]}")
    t = times["enc_self"]
    fwd_err = max(v[0] for v in out_entries.values())
    bwd_err = max(v[1] for v in out_entries.values())
    cross, dself = times["dec_cross"], times["dec_self"]
    return [
        entry("attn_fwd", "attention.cu",
              "end2end_asr_tpu/ops/attention_fused.py:78", fwd_err,
              t["fwd"][0], t["fwd"][1], t["fwd"][2], t["fwd"][3],
              t["fwd"][4], shape="(12,8,200,200,64) bf16, rate 0.1",
              layout="q, k, v transposed (B, T, H, D) views; out in "
                     "(B, Tq, H, D) memory", key_splits=key_splits,
              device_ms=t["dev"][0], device_ms_dec_cross=cross["dev"][0],
              ms_dec_cross=cross["fwd"][0],
              plain_ms_dec_cross=cross["fwd"][1],
              library_ms_dec_cross=cross["fwd"][4],
              bound_ms_dec_cross=1e3 * max(cross["fwd"][2],
                                           cross["fwd"][3]),
              device_ms_dec_self=dself["dev"][0], ms_dec_self=dself["fwd"][0],
              library_ms_dec_self=dself["fwd"][4],
              bound_ms_dec_self=1e3 * max(dself["fwd"][2], dself["fwd"][3])),
        entry("attn_bwd", "attention.cu",
              "end2end_asr_tpu/ops/attention_fused.py:96", bwd_err,
              t["bwd"][0], t["bwd"][1], t["bwd"][2], t["bwd"][3],
              t["bwd"][4], shape="(12,8,200,200,64) bf16, rate 0.1",
              library_note="SDPA's backward alone, on a retained graph",
              device_ms=t["dev"][1], device_ms_dec_cross=cross["dev"][1],
              ms_dec_cross=cross["bwd"][0],
              plain_ms_dec_cross=cross["bwd"][1],
              library_ms_dec_cross=cross["bwd"][4],
              bound_ms_dec_cross=1e3 * max(cross["bwd"][2],
                                           cross["bwd"][3]),
              device_ms_dec_self=dself["dev"][1], ms_dec_self=dself["bwd"][0],
              library_ms_dec_self=dself["bwd"][4],
              bound_ms_dec_self=1e3 * max(dself["bwd"][2], dself["bwd"][3])),
        # the bound: bytes written over 3.35 TB/s, or the kernel's integer
        # instructions (its SASS) over 132 SMs x 64 INT32 lanes at the
        # card's highest SM clock, whichever is larger
        entry("dropout_bits", "attention.cu",
              "end2end_asr_tpu/ops/attention_fused.py:273", 0.0,
              bits_t["enc_800"]["ms"], bits_t["enc_800"]["plain_ms"],
              bits_t["enc_800"]["bound"]["ops_ms"] / 1e3,
              bits_t["enc_800"]["bound"]["bytes_ms"] / 1e3, None,
              shape="(12, 8*200, 200) uint32, widened to int64",
              device_ms=bits_t["enc_800"]["device_ms"],
              widen_device_ms=bits_t["enc_800"]["widen_device_ms"],
              int_ops_per_group=ops, clocks_max_sm_hz=clock,
              ms_1600=bits_t["enc_1600"]["ms"],
              device_ms_1600=bits_t["enc_1600"]["device_ms"],
              widen_device_ms_1600=bits_t["enc_1600"]["widen_device_ms"],
              plain_ms_1600=bits_t["enc_1600"]["plain_ms"],
              bound_ms_1600=bits_t["enc_1600"]["bound"]["bound_ms"],
              bound_by_1600=bits_t["enc_1600"]["bound"]["bound_by"])]


def check_attention_f32(torch, dev):
    """The f32 entry points of kernels 4 and 5 (what --dtype float32
    training runs) at the same shapes, rates 0 and 0.1, against the plain
    version in f32 (TF32 off), two runs bit-identical; timed beside SDPA
    at f32."""
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch.ops import attention_fused as AF
    H, D = 8, 64
    g0 = torch.Generator().manual_seed(SEED + 7)
    errs, times = {}, {}
    for label, Tq, Tk in (("enc_self", 200, 200), ("dec_cross", 51, 200)):
        q, k, v = (torch.randn(B, t, H, D, generator=g0).to(dev)
                   .transpose(1, 2) for t in (Tq, Tk, Tk))
        mask = torch.rand(B, Tq, Tk, generator=g0) < 0.1
        mask[0, 0] = True                 # a query with every key masked
        bias = torch.where(mask, -1e9, 0.0).to(dev)
        dout = torch.randn(B, Tq, H, D, generator=g0).to(dev).transpose(1, 2)
        for rate in (0.0, 0.1):
            seed = 0xF32 + int(rate * 10)
            runs, layout = attention_runs(torch, AF, (q, k, v), bias, dout,
                                          seed, rate)
            qf = [t.clone().requires_grad_() for t in (q, k, v)]
            want = AF.flash_mha_train_plain(*qf, bias, seed, rate)
            want_g = torch.autograd.grad(want, qf, dout)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            out, *grads = runs[0]
            ef = rel_err(out, want)
            eb = [rel_err(a, b) for a, b in zip(grads, want_g)]
            log(f"attention f32 {label} rate {rate}: fwd rel err {ef:.3g}, "
                f"dq/dk/dv {[float(f'{e:.3g}') for e in eb]} (tol "
                f"{ATTN_F32_TOL}); two runs bit-identical: {same}; {layout}")
            if not (ef <= ATTN_F32_TOL and max(eb) <= ATTN_F32_TOL and same
                    and all(layout.values()) and out.dtype == torch.float32
                    and torch.isfinite(out).all()):
                fail(f"attention f32 {label} rate {rate} disagrees with "
                     "plain")
            errs[(label, rate)] = (
                (out - want).abs().max().item(),
                max((a - b).abs().max().item()
                    for a, b in zip(grads, want_g)))
        rate, seed = 0.1, 78
        o, stats = AF.attn_fwd(q, k, v, bias, seed, rate)
        fwd = lambda: AF.attn_fwd(q, k, v, bias, seed, rate)
        bwd = lambda: AF.attn_bwd(q, k, v, bias, o, stats, dout, seed, rate)
        fwd_ms, bwd_ms = (time_ms(torch, f, iters=50) for f in (fwd, bwd))
        fwd_dev, bwd_dev = (device_ms(torch, f) for f in (fwd, bwd))
        pf_ms = time_ms(torch, lambda: AF.flash_mha_train_plain(
            q, k, v, bias, seed, rate), iters=5)
        qg = [t.clone().requires_grad_() for t in (q, k, v)]
        pb_ms = backward_ms(torch, AF.flash_mha_train_plain(
            *qg, bias, seed, rate), qg, dout, iters=5)
        ql = [t.clone().requires_grad_() for t in (q, k, v)]
        bl = bias[:, None]
        sdpa = lambda: Fn.scaled_dot_product_attention(*ql, attn_mask=bl,
                                                       dropout_p=rate)
        lf_ms = time_ms(torch, sdpa, iters=50)
        lb_ms = backward_ms(torch, sdpa(), ql, dout, iters=50)
        n = B * H * Tq * Tk * D
        in_b = 4 * B * H * (Tq + 2 * Tk) * D + 4 * B * Tq * Tk
        times[label] = dict(
            fwd=(fwd_ms, pf_ms, 4 * n / F32_PEAK,
                 (in_b + 4 * B * H * Tq * D + 8 * B * H * Tq) / HBM_BPS,
                 lf_ms),
            bwd=(bwd_ms, pb_ms, 10 * n / F32_PEAK,
                 (in_b + 2 * 4 * B * H * Tq * D + 8 * B * H * Tq
                  + 4 * B * H * (Tq + 2 * Tk) * D) / HBM_BPS, lb_ms),
            dev=(fwd_dev, bwd_dev))
        log(f"attention f32 {label} (rate 0.1): fwd {fwd_ms:.4f} ms, device "
            f"{fwd_dev} (plain {pf_ms:.4f}, SDPA f32 {lf_ms:.4f}, bound "
            f"{1e3 * max(times[label]['fwd'][2:4]):.4f}); bwd {bwd_ms:.4f} "
            f"ms, device {bwd_dev} (plain {pb_ms:.4f}, SDPA f32 backward "
            f"~{lb_ms:.4f}, bound {1e3 * max(times[label]['bwd'][2:4]):.4f})")
    t, cross = times["enc_self"], times["dec_cross"]
    rep = "end2end_asr_tpu/ops/attention_fused.py:"
    shape = "(12,8,200,200,64) f32, rate 0.1"
    return [
        entry("attn_fwd_f32", "attention.cu", rep + "78",
              max(e[0] for e in errs.values()), *t["fwd"], shape=shape,
              tol_rel=ATTN_F32_TOL, device_ms=t["dev"][0],
              device_ms_dec_cross=cross["dev"][0],
              ms_dec_cross=cross["fwd"][0],
              plain_ms_dec_cross=cross["fwd"][1],
              library_ms_dec_cross=cross["fwd"][4],
              bound_ms_dec_cross=1e3 * max(cross["fwd"][2:4])),
        entry("attn_bwd_f32", "attention.cu", rep + "96",
              max(e[1] for e in errs.values()), *t["bwd"], shape=shape,
              tol_rel=ATTN_F32_TOL, device_ms=t["dev"][1],
              device_ms_dec_cross=cross["dev"][1],
              library_note="SDPA f32's backward alone, on a retained "
                           "graph",
              ms_dec_cross=cross["bwd"][0],
              plain_ms_dec_cross=cross["bwd"][1],
              library_ms_dec_cross=cross["bwd"][4],
              bound_ms_dec_cross=1e3 * max(cross["bwd"][2:4]))]


def check_pool_bwd(torch, dev):
    """Kernel 6 at conv4's output (12, 128, 80, 400) bf16, exact, in the
    train step's layout (channels-last y and g: the JAX kernel's NHWC)
    and in NCHW; dy must come back in y's layout. Timed in the step's
    layout beside the NCHW kernel, the NCHW kernel with the copies the
    step would need around it (y and g to NCHW, dy back), the plain
    version and max_pool2d's backward on the same inputs."""
    from end2end_asr_tpu_torch.ops import pool_vjp as PV
    g0 = torch.Generator().manual_seed(SEED + 4)
    cl = torch.channels_last
    y = torch.randn(B, 128, 80, 400, generator=g0).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)
    g = torch.randn(B, 128, 40, 200, generator=g0).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)
    yn, gn = y.contiguous(), g.contiguous()
    PV.reset_launches()
    got, got_n = PV.pool_bwd(y, g), PV.pool_bwd(yn, gn)
    want = PV.pool_bwd_plain(y, g)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    err_n = (got_n.float() - want.float()).abs().max().item()
    layouts = {"dy_channels_last": got.is_contiguous(memory_format=cl),
               "dy_nchw": got_n.is_contiguous(), "launches":
               PV.launches()}
    log(f"pool_bwd (12,128,80,400) bf16 max_abs_err channels-last {err}, "
        f"NCHW {err_n} (tol 0: exact); {layouts}")
    if err != 0.0 or err_n != 0.0 or not (
            layouts["dy_channels_last"] and layouts["dy_nchw"]
            and layouts["launches"] == 2):
        fail("pool_bwd disagrees with its plain version")
    step = lambda: PV.pool_bwd(y, g)
    nchw_in_step = lambda: PV.pool_bwd(y.contiguous(), g.contiguous()
                                       ).contiguous(memory_format=cl)
    ms = time_ms(torch, step, iters=20)
    dev_ms = device_ms(torch, step, name="pool_bwd")
    ms_n = time_ms(torch, lambda: PV.pool_bwd(yn, gn), iters=20)
    dev_n = device_ms(torch, lambda: PV.pool_bwd(yn, gn), name="pool_bwd")
    copies_ms = device_ms(torch, nchw_in_step)
    plain = time_ms(torch, lambda: PV.pool_bwd_plain(y, g), iters=5)
    _, ind = torch.nn.functional.max_pool2d(y, 2, 2, return_indices=True)
    lib = time_ms(torch, lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        g, y, [2, 2], [2, 2], [0, 0], [1, 1], False, ind), iters=20)
    nbytes = 2 * (2 * y.numel() + g.numel())
    log(f"pool_bwd channels-last ms {ms:.4f} device {dev_ms}; NCHW ms "
        f"{ms_n:.4f} device {dev_n}; NCHW with the step's copies around it "
        f"device {copies_ms}; plain {plain:.4f}; max_pool2d backward "
        f"{lib:.4f}; bound {1e3 * nbytes / HBM_BPS:.4f} ms "
        f"({nbytes / 1e6:.1f} MB)")
    return entry("pool_bwd", "pool_bwd.cu",
                 "end2end_asr_tpu/ops/pool_vjp.py:39", err, ms, plain, 0.0,
                 nbytes / HBM_BPS, lib,
                 shape="(12,128,80,400) bf16, channels-last (the step's)",
                 device_ms=dev_ms, ms_nchw=ms_n, device_ms_nchw=dev_n,
                 max_abs_err_nchw=err_n,
                 device_ms_nchw_with_copies=copies_ms)


# the CTC kernels against PyTorch's ctc_loss: log-sum-exps over the same
# terms in another order, relative to the largest |value|
CTC_TOL = 1e-4
CTC_REPLACES = ("end2end_asr_tpu/ops/ctc.py:30 ctc_loss (a lax.scan in "
                "plain XLA: no pl.pallas_call; the port's plain version, "
                "PyTorch's ctc_loss, reads the lengths on the host)")


def check_ctc(torch, dev):
    """The CTC kernels (csrc/ctc.cu) at phase 6's shape: B 12, the 51
    decoder positions of the 50-token bucket, the 4364 AiShell ids,
    14-label targets (12 distinct characters, SOS, EOS), input lengths
    45-51 as the step scales them, and one infeasible row (32 labels, 30
    copies of one character): the nll and the logits' gradient (through
    log_softmax, on the feasible rows) against the plain version,
    PyTorch's ctc_loss on the card (also the library yardstick); the
    infeasible row +inf on both; two backward runs bit-identical."""
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch.ops import ctc as CT
    g0 = torch.Generator().manual_seed(SEED + 9)
    T = U = 51
    C = 4364
    logits = (torch.randn(B, T, C, generator=g0) * 2).to(dev)
    targets = torch.zeros(B, U, dtype=torch.int64)
    tl = torch.full((B,), 14, dtype=torch.int64)
    for i in range(B):
        ids = torch.randperm(C - 3, generator=g0)[:12] + 3
        targets[i, 1:13], targets[i, 0], targets[i, 13] = ids, 1, 2
    targets[B - 1, 1:31] = targets[B - 1, 1]
    targets[B - 1, 31] = 2
    tl[B - 1] = 32
    il = torch.randint(45, T + 1, (B,), generator=g0)
    targets, tl, il = targets.to(dev), tl.to(dev), il.to(dev)
    ok = torch.arange(B, device=dev) < B - 1

    def run(fn):
        x = logits.detach().requires_grad_()
        nll = fn(torch.log_softmax(x, -1), targets, il, tl)
        grad, = torch.autograd.grad(nll[ok].sum(), x)
        return nll.detach(), grad

    plain = lambda lp, t, i, l: CT.ctc_nll_plain(lp, t, i, l)
    CT.reset_launches()
    got, got_g = run(CT.ctc_nll)
    launches = (CT.FWD.launches, CT.BWD.launches)
    again = run(CT.ctc_nll)[1]
    want, want_g = run(plain)
    torch.cuda.synchronize()
    err = (got[ok] - want[ok]).abs().max().item()
    err_rel = err / want[ok].abs().max().item()
    # the feasible rows (PyTorch's backward puts NaN on an infeasible
    # row even where its incoming gradient is 0; the kernel zeros)
    gerr = (got_g[ok] - want_g[ok]).abs().max().item()
    gerr_rel = gerr / want_g[ok].abs().max().item()
    inf_ok = bool(torch.isinf(got[B - 1]) and torch.isinf(want[B - 1]))
    same = torch.equal(got_g, again)
    log(f"ctc (12, 51, 4364): nll max_abs_err {err:.3e} (rel {err_rel:.2e}), "
        f"the logits' gradient {gerr:.3e} (rel {gerr_rel:.2e}; tol "
        f"{CTC_TOL}); infeasible row inf on both: {inf_ok}; backward runs "
        f"bit-identical: {same}; launches {launches}")
    if (not err_rel <= CTC_TOL or not gerr_rel <= CTC_TOL or not inf_ok
            or not same or launches != (1, 1)
            or not bool(torch.isfinite(got_g).all())):
        fail("the CTC kernels disagree with PyTorch's ctc_loss")
    lp = torch.log_softmax(logits, -1).requires_grad_()
    fwd = lambda: CT.ctc_nll(lp, targets, il, tl)
    fwd_plain = lambda: plain(lp, targets, il, tl)
    ms = time_ms(torch, fwd, iters=20)
    plain_ms = time_ms(torch, fwd_plain, iters=20)
    dev_fwd = device_ms(torch, fwd, name="ctc_fwd")
    out, out_p = fwd(), fwd_plain()
    gout = torch.where(ok, 1.0, 0.0)
    bms = backward_ms(torch, out, [lp], gout, iters=20)
    bplain = backward_ms(torch, out_p, [lp], gout, iters=20)
    S = 2 * U + 1
    # the forward reads the (B, T, S) log-probabilities of the labels and
    # writes alpha; the backward reads them and alpha and writes the
    # (B, T, C) gradient; ~10 operations a (t, s) state each way
    fwd_bytes = 4 * B * T * S * 2 + 8 * B * (U + 2) + 4 * B
    bwd_bytes = 4 * B * T * (2 * S + C) + 8 * B * (U + 2)
    ops = 10 * B * T * S
    log(f"ctc_fwd ms {ms:.4f} (device {dev_fwd}) against plain "
        f"{plain_ms:.4f}; ctc_bwd ms {bms:.4f} against plain {bplain:.4f}; "
        f"bounds {1e3 * fwd_bytes / HBM_BPS:.4f} / "
        f"{1e3 * bwd_bytes / HBM_BPS:.4f} ms by bytes")
    shape = ("(12, 51, 4364) f32, 14-label targets, phase 6's shape; "
             "bound: bytes (latency-bound: 51 sequential steps)")
    return [entry("ctc_fwd", "ctc.cu", CTC_REPLACES, err, ms, plain_ms,
                  ops / 67e12, fwd_bytes / HBM_BPS, plain_ms, shape=shape,
                  device_ms=dev_fwd, max_rel_err=err_rel),
            entry("ctc_bwd", "ctc.cu", CTC_REPLACES, gerr, bms, bplain,
                  ops / 67e12, bwd_bytes / HBM_BPS, bplain, shape=shape,
                  max_rel_err=gerr_rel,
                  note="the logits' gradient through log_softmax")]


def rel_l2(a, b):
    """||a - b|| / ||b|| in f64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def check_vgg2(torch, dev):
    """Kernels 7 and 8 at block 2's shapes on the main path, x (12, 80, 400,
    64), bf16 and f32, and at a second even shape (F = 82, T = 398)."""
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    g0 = torch.Generator().manual_seed(SEED + 5)

    def make(Bn, F, T, cdt):
        x = torch.randn(Bn, F, T, 64, generator=g0).relu().to(dev, cdt)
        ws = [(torch.randn(*s, generator=g0) * sc).to(dev) for s, sc in
              (((3, 3, 64, 128), (2 / 576) ** 0.5), ((128,), 0.1),
               ((3, 3, 128, 128), (2 / 1152) ** 0.5), ((128,), 0.1))]
        return x, ws

    def idx_agrees(x, ws, cdt, idx):
        """Share of outputs whose argmax equals the plain one among those
        whose plain best and second-best values are clearly apart."""
        y4 = Fn.conv2d(V._x2_plain(x, ws[0], ws[1], cdt),
                       V._nchw(ws[2], cdt), padding=1).float()
        Bn, C, F, T = y4.shape
        w = y4.reshape(Bn, C, F // 2, 2, T // 2, 2).permute(
            0, 2, 4, 1, 3, 5).reshape(Bn, F // 2, T // 2, C, 4)
        top = w.topk(2, dim=-1).values
        gap = (IDX_GAP_BF16 if cdt == torch.bfloat16 else IDX_GAP_F32)
        clear = (top[..., 0] - top[..., 1]) > gap * top[..., 0].abs(
            ).clamp_min(1.0)
        _, want_idx = V.pool2_first_wins(y4.to(cdt))
        same = idx == want_idx.permute(0, 2, 3, 1)
        return (bool(same[clear].all()), clear.float().mean().item(),
                same.float().mean().item())

    res, lib = {}, {}
    for Bn, F, T in ((B, 80, 400), (2, 82, 398)):
        for cdt in (torch.bfloat16, torch.float32):
            name = f"{str(cdt)[6:]} ({Bn},{F},{T},64)"
            x, ws = make(Bn, F, T, cdt)
            idx = torch.empty((Bn, F // 2, T // 2, 128), dtype=torch.uint8,
                              device=dev)
            out = V.vgg_block2(x, *ws, cdt=cdt, idx_out=idx)
            want, _ = V.vgg_block2_plain(x, *ws, cdt=cdt)
            torch.cuda.synchronize()
            if (out.shape != want.shape or out.dtype != cdt
                    or not torch.isfinite(out.float()).all()):
                fail(f"vgg_block2 {name}: bad output")
            diff = (out.float() - want.float()).abs()
            ferr, fl2 = diff.max().item(), rel_l2(out, want)
            if cdt == torch.float32:
                ok = fl2 <= VGG2_F32_TOL and ferr <= VGG_F32_TOL * max(
                    1.0, want.abs().max().item())
            else:
                ok = bool((diff <= VGG_BF16_ATOL
                           + VGG_BF16_RTOL * want.float().abs()).all())
            idx_ok, clear, same = idx_agrees(x, ws, cdt, idx)
            log(f"vgg_block2 {name}: max_abs_err {ferr:.3g}, rel L2 "
                f"{fl2:.3g}; pool argmax equal on {100 * same:.4f}% of "
                f"outputs, and on every one of the {100 * clear:.2f}% whose "
                f"two best values are clearly apart: {idx_ok}")
            if not (ok and idx_ok and same > 0.99):
                fail(f"vgg_block2 {name} disagrees with its plain version")
            g = torch.randn(out.shape, generator=g0).to(dev, cdt)
            got = V.vgg_block2_bwd(x, *ws[:3], out, idx, g, cdt)
            again = V.vgg_block2_bwd(x, *ws[:3], out, idx, g, cdt)
            plain = V.vgg_block2_bwd_plain(x, *ws[:3], out, idx, g, cdt)
            torch.cuda.synchronize()
            tols = ([VGG2_F32_MASK_TOL] * 3 + [VGG2_F32_TOL] * 2
                    if cdt == torch.float32 else [VGG2_BWD_BF16_TOL] * 5)
            l2 = [rel_l2(a, b) for a, b in zip(got, plain)]
            mx = [rel_err(a, b) for a, b in zip(got, plain)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"vgg_block2_bwd {name}: rel L2 dx/dW3/db3/dW4/db4 "
                f"{[float(f'{e:.3g}') for e in l2]} (tol {tols}); max_rel "
                f"{[float(f'{e:.3g}') for e in mx]}; two runs bit-identical: "
                f"{same}")
            if not (all(e <= t for e, t in zip(l2, tols)) and same
                    and all(torch.isfinite(a.float()).all() for a in got)):
                fail(f"vgg_block2_bwd {name} disagrees with its plain "
                     "version")
            if cdt == torch.float32:
                # the same with every activation positive: no mask decision
                on = [ws[0], ws[1].abs() + 10.0, ws[2]]
                o2 = V.vgg_block2(x, *on, ws[3], cdt=cdt, idx_out=idx)
                l2on = [rel_l2(a, b) for a, b in zip(
                    V.vgg_block2_bwd(x, *on, o2, idx, g, cdt),
                    V.vgg_block2_bwd_plain(x, *on, o2, idx, g, cdt))]
                log(f"vgg_block2_bwd {name}, b3 + 10 (mask all on): rel L2 "
                    f"{[float(f'{e:.3g}') for e in l2on]} (tol "
                    f"{VGG2_F32_TOL})")
                if not max(l2on) <= VGG2_F32_TOL:
                    fail(f"vgg_block2_bwd {name} (mask all on) disagrees "
                         "with its plain version")
                idx = torch.empty_like(idx)
                out = V.vgg_block2(x, *ws, cdt=cdt, idx_out=idx)
            if Bn != B:
                continue
            fwd = lambda: V.vgg_block2(x, *ws, cdt=cdt, idx_out=idx)
            res[cdt] = dict(
                ferr=ferr, fl2=fl2, bl2=max(l2),
                berr=max((a.float() - b.float()).abs().max().item()
                         for a, b in zip(got, plain)),
                fwd=time_ms(torch, fwd, iters=10),
                fwd_plain=time_ms(torch, lambda: V.vgg_block2_plain(
                    x, *ws, cdt=cdt), iters=5),
                bwd=time_ms(torch, lambda: V.vgg_block2_bwd(
                    x, *ws[:3], out, idx, g, cdt), iters=10),
                bwd_plain=time_ms(torch, lambda: V.vgg_block2_bwd_plain(
                    x, *ws[:3], out, idx, g, cdt), iters=5),
                # the kernels alone (no weight layout copies), on the device
                fwd_device=device_ms(torch, fwd, iters=10,
                                     name="vgg_block2_fwd"),
                bwd_device=device_ms(torch, lambda: V.vgg_block2_bwd(
                    x, *ws[:3], out, idx, g, cdt), iters=10,
                    name=BWD2_PREFIX))
            # library: cuDNN conv2d x2 + max_pool2d, and its autograd
            # (f32: TF32 off, as main() sets it)
            xl = x.permute(0, 3, 1, 2).contiguous().requires_grad_()
            wl = [w.to(cdt).requires_grad_() for w in ws]

            def lib_fwd():
                y = Fn.conv2d(xl, wl[0].permute(3, 2, 0, 1), wl[1],
                              padding=1)
                y = Fn.conv2d(torch.relu(y), wl[2].permute(3, 2, 0, 1),
                              padding=1)
                return torch.relu(Fn.max_pool2d(y, 2)
                                  + wl[3][None, :, None, None])
            gl = g.permute(0, 3, 1, 2).contiguous()
            lib_f = time_ms(torch, lib_fwd, iters=5)
            # the same on channels-last tensors, the gate-off front end's
            # layout (models/frontend.py)
            cl = torch.channels_last
            xc = xl.detach().contiguous(memory_format=cl)
            w3c, w4c = (wl[i].detach().permute(3, 2, 0, 1).contiguous(
                memory_format=cl) for i in (0, 2))

            def lib_fwd_cl():
                y = Fn.conv2d(xc, w3c, wl[1].detach(), padding=1)
                y = Fn.conv2d(torch.relu(y), w4c, padding=1)
                return torch.relu(Fn.max_pool2d(y, 2)
                                  + wl[3].detach()[None, :, None, None])
            with torch.no_grad():
                lib_cl = time_ms(torch, lib_fwd_cl, iters=5)
            lib[cdt] = (lib_f, time_ms(torch, lambda: torch.autograd.grad(
                lib_fwd(), [xl, *wl], gl), iters=5) - lib_f, lib_cl)
    flops = 2 * B * 80 * 400 * 128 * 9 * (64 + 128)
    # the f32 entries' executed products (csrc/vgg_block2_f32.cu): the
    # backward recomputes conv3, and dW3's fifth tile runs one tap in two
    # halves (10/9 of dW3)
    c3 = 2 * B * 80 * 400 * 128 * 9 * 64
    bwd_f32_flops = 2 * flops + c3 + c3 / 9
    f_bytes = 2 * B * 80 * 400 * 64 + 3 * B * 40 * 200 * 128 + 2 * 9 * (
        64 * 128 + 128 * 128)
    b_bytes = 2 * 2 * B * 80 * 400 * 64 + 5 * B * 40 * 200 * 128 + 4 * 9 * (
        64 * 128 + 128 * 128)
    rb, rf = res[torch.bfloat16], res[torch.float32]
    (lib_f, lib_b, lib_cl), (lib_f32, lib_b32, lib_cl32) = (
        lib[torch.bfloat16], lib[torch.float32])
    log(f"vgg_block2 bf16 fwd {rb['fwd']:.4f} ms, device {rb['fwd_device']} "
        f"(plain {rb['fwd_plain']:.4f}, cuDNN conv2d x2 + max_pool2d "
        f"{lib_f:.4f}, channels-last {lib_cl:.4f}), bwd {rb['bwd']:.4f}, "
        f"device {rb['bwd_device']} "
        f"(plain {rb['bwd_plain']:.4f}, cuDNN autograd backward ~{lib_b:.4f})"
        f"; f32 fwd {rf['fwd']:.4f}, device {rf['fwd_device']} (plain "
        f"{rf['fwd_plain']:.4f}, cuDNN {lib_f32:.4f}), bwd {rf['bwd']:.4f}, "
        f"device {rf['bwd_device']} (plain {rf['bwd_plain']:.4f}, cuDNN "
        f"~{lib_b32:.4f}); TF32 off; bounds "
        f"{1e3 * flops / BF16_PEAK:.4f} / {2e3 * flops / BF16_PEAK:.4f} ms "
        f"bf16, {1e3 * flops / F32_PEAK:.4f} / {2e3 * flops / F32_PEAK:.4f} "
        f"f32 ({flops / 1e9:.1f} GFLOP forward)")
    # the f32 entries' executed rates against the 67 TFLOP/s of f32 FMA
    tf_f32 = {k: tflops(n, rf[k]) for k, n in (
        ("fwd_device", flops), ("bwd_device", bwd_f32_flops))}
    log(f"vgg_block2 f32 executed: fwd {flops / 1e9:.1f} GFLOP at "
        f"{tf_f32['fwd_device']} TFLOP/s, bwd {bwd_f32_flops / 1e9:.1f} "
        f"GFLOP at {tf_f32['bwd_device']} TFLOP/s, of "
        f"{F32_PEAK / 1e12:.0f} (device time)")
    rep = "end2end_asr_tpu/ops/vgg_fused.py:"
    src32 = "end2end_asr_tpu_torch/csrc/vgg_block2_f32.cu"
    return [
        entry("vgg_block2_fwd", "vgg_block2.cu", rep + "654", rb["ferr"],
              rb["fwd"], rb["fwd_plain"], flops / BF16_PEAK,
              f_bytes / HBM_BPS, lib_f, rel_l2=rb["fl2"],
              device_ms=rb["fwd_device"],
              max_abs_err_f32=rf["ferr"], rel_l2_f32=rf["fl2"],
              ms_f32=rf["fwd"], plain_ms_f32=rf["fwd_plain"],
              device_ms_f32=rf["fwd_device"],
              tflops_f32=tf_f32["fwd_device"], source_f32=src32,
              bound_ms_f32=1e3 * flops / F32_PEAK, library_ms_f32=lib_f32,
              library_ms_cl=lib_cl, library_ms_cl_f32=lib_cl32),
        entry("vgg_block2_bwd", "vgg_block2.cu", rep + "682", rb["berr"],
              rb["bwd"], rb["bwd_plain"], 2 * flops / BF16_PEAK,
              b_bytes / HBM_BPS, lib_b, rel_l2=rb["bl2"],
              device_ms=rb["bwd_device"],
              max_abs_err_f32=rf["berr"], rel_l2_f32=rf["bl2"],
              ms_f32=rf["bwd"], plain_ms_f32=rf["bwd_plain"],
              device_ms_f32=rf["bwd_device"],
              tflops_f32=tf_f32["bwd_device"], source_f32=src32,
              bound_ms_f32=2e3 * flops / F32_PEAK, library_ms_f32=lib_b32,
              library_note="autograd forward+backward minus forward")]


def check_stream(torch, dev):
    """Kernels 10 and 11 at the probe's size, (38400, 1024) f32."""
    from end2end_asr_tpu_torch.tools import probe_stream as PS
    g0 = torch.Generator().manual_seed(SEED + 6)
    p, m, v, g = (torch.randn(PS.N_ROWS, PS.N_COLS, generator=g0).to(dev)
                  for _ in range(4))
    v = v.abs()
    out = PS.stream_copy(p)
    cerr = (out - PS.copy_plain(p)).abs().max().item()
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    PS.stream_adam(pk, mk, vk, g, 3.0)
    want = PS.adam_plain(p, m, v, g, 3.0)
    torch.cuda.synchronize()
    aerr = max((a - b).abs().max().item() for a, b in zip((pk, mk, vk), want))
    log(f"stream_copy max_abs_err {cerr} (tol 0: exact); stream_adam "
        f"max_abs_err {aerr:.3g} (tol {STREAM_ADAM_TOL})")
    if cerr != 0.0 or not aerr <= STREAM_ADAM_TOL:
        fail("a streaming kernel disagrees with its plain version")
    # the copy and torch.add(x, 1) in 3 rounds of turns (add, copy, copy,
    # add), each reading device ms (the profiler) and events ms
    pairs = PS.copy_arms(dev, rounds=3)
    copy_r, add_r = pairs["stream_copy"], pairs["torch_add"]
    copy_ms, copy_lib = copy_r["events_ms_median"], add_r["events_ms_median"]
    copy_plain = time_ms(torch, lambda: PS.copy_plain(p))
    adam_ms = time_ms(torch, lambda: PS.stream_adam(pk, mk, vk, g, 3.0))
    adam_plain = time_ms(torch, lambda: PS.adam_plain(p, m, v, g, 3.0))
    # one PyTorch call that computes the same update, if it agrees within
    # the probe's limit: the fused Adam of torch.optim, timed and not used
    adam_lib, note = None, "none: no single PyTorch call"
    if hasattr(torch, "_fused_adam_"):
        pl, ml, vl = p.clone(), m.clone(), v.clone()
        step = torch.tensor(3.0, device=dev)
        call = lambda: torch._fused_adam_(
            [pl], [g], [ml], [vl], [], [step], lr=PS.LR, beta1=PS.B1,
            beta2=PS.B2, weight_decay=0.0, eps=PS.EPS, amsgrad=False,
            maximize=False)
        call()
        lerr = max((a - b).abs().max().item()
                   for a, b in zip((pl, ml, vl), want))
        if lerr <= STREAM_ADAM_TOL:
            adam_lib, note = time_ms(torch, call), "torch._fused_adam_"
        else:
            note = f"none: torch._fused_adam_ is {lerr:.3g} off"
    n = 4 * PS.N_ROWS * PS.N_COLS
    log(f"stream_copy ms {copy_ms:.4f} plain {copy_plain:.4f} torch.add "
        f"{copy_lib:.4f}, device {copy_r['device_ms']} against torch.add's "
        f"{add_r['device_ms']} (medians {copy_r['device_ms_median']:.4f} / "
        f"{add_r['device_ms_median']:.4f}), bound "
        f"{1e3 * 2 * n / HBM_BPS:.4f} "
        f"({2 * n / 1e6:.1f} MB); stream_adam ms {adam_ms:.4f} plain "
        f"{adam_plain:.4f} library {adam_lib} ({note}), bound "
        f"{1e3 * 7 * n / HBM_BPS:.4f} ({7 * n / 1e6:.1f} MB)")
    rep = "tools/probe_stream.py:"
    return [entry("stream_copy", "stream.cu", rep + "59", cerr, copy_ms,
                  copy_plain, 0.0, 2 * n / HBM_BPS, copy_lib,
                  gbps=2 * n / copy_ms / 1e6,
                  device_ms=copy_r["device_ms_median"],
                  library_device_ms=add_r["device_ms_median"],
                  device_ms_rounds=copy_r["device_ms"],
                  library_device_ms_rounds=add_r["device_ms"],
                  library_note="torch.add(x, 1); medians of 3 rounds of "
                               "turns"),
            entry("stream_adam", "stream.cu", rep + "89", aerr, adam_ms,
                  adam_plain, 0.0, 7 * n / HBM_BPS, adam_lib,
                  library_note=note, gbps=7 * n / adam_ms / 1e6)]


# the flat f32 buffers of asr_bench's two train cells (aishell_vgg,
# aishell_lrt: the trainable leaves; the sinusoid table is not in them)
ADAM_SIZES = {"vgg": 36776384, "lrt": 16427456}


def check_adam(torch, dev):
    """The train step's update kernel (csrc/adam.cu) at ADAM_SIZES, f32
    moments: ops/adam.adam_step against the plain chain it replaces
    (adam_noam_update on g * inv, then the three torch.where picks) at
    tolerance 0, the step finite and not; then both timed in turns
    (probe_lib.time_in_turns: events ms, device ms by kernel under
    torch.profiler). The bound: 28 bytes an element (p, g, m, v read;
    p, m, v written) at HBM_BPS. The library: torch._fused_adam_ on the
    same inputs, in place, its grad_scale dividing where the step
    multiplies by inv (timed, not used)."""
    from end2end_asr_tpu_torch.ops import adam as A
    from end2end_asr_tpu_torch.tools import probe_lib as PL
    from end2end_asr_tpu_torch.training.optimizer import (NoamConfig,
                                                          adam_noam_update,
                                                          noam_rate,
                                                          tree_map)
    noam = NoamConfig(model_size=512, factor=1.0, warmup=4000, min_lr=1e-6)
    out = {}
    for label, n in ADAM_SIZES.items():
        g0 = torch.Generator(device=dev).manual_seed(SEED + 7 + n)
        p, g, m = (torch.randn(n, generator=g0, device=dev)
                   for _ in range(3))
        v = torch.rand(n, generator=g0, device=dev) * 1e-4
        state = {"step": torch.tensor(6, dtype=torch.int32, device=dev),
                 "mu": m, "nu": v}
        inv = torch.tensor(1.0 / 600.0, device=dev)
        step = state["step"] + 1
        t = step.to(torch.float32)
        lr, bc1, bc2 = (noam_rate(step, noam), 1.0 - noam.beta1 ** t,
                        1.0 - noam.beta2 ** t)
        res = {}
        for finite in (True, False):
            fin = torch.tensor(finite, device=dev)
            kernel = lambda: A.adam_step(p, g, m, v, lr=lr, bc1=bc1,
                                         bc2=bc2, inv=inv, finite=fin,
                                         beta1=noam.beta1, beta2=noam.beta2,
                                         eps=noam.eps)

            def plain():
                upd, new, _ = adam_noam_update(p, g * inv, state, noam)
                pick = lambda a, b: torch.where(fin, a, b)
                return pick(upd, p), pick(new["mu"], m), pick(new["nu"], v)
            A.reset_launches()
            got = kernel()
            launches = A.ADAM.launches
            want = plain()
            torch.cuda.synchronize()
            bits = lambda x: x.view(torch.int32)
            exact = all(torch.equal(bits(a), bits(b))
                        for a, b in zip(got, want))
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            log(f"adam_noam {label} ({n} elements, finite {finite}): "
                f"bit-equal to the plain chain {exact}, max_abs_err {err} "
                f"(tol 0), {launches} launch")
            if not exact or launches != 1:
                fail(f"adam_noam {label}: not the plain chain bit for bit "
                     f"or not one launch (finite {finite})")
            if finite:
                ref_p = got[0]
                res = PL.time_in_turns(torch, {"adam_noam": kernel,
                                               "plain": plain})
            del got, want
        lib_ms, note = None, "none: this PyTorch has no torch._fused_adam_"
        if hasattr(torch, "_fused_adam_"):
            # the call writes the unscaled gradient back: a copy of g
            pl, gl, ml, vl = p.clone(), g.clone(), m.clone(), v.clone()
            steps = [t.clone()]
            scale = 1.0 / inv
            call = lambda: torch._fused_adam_(
                [pl], [gl], [ml], [vl], [], steps, lr=lr.item(),
                beta1=noam.beta1, beta2=noam.beta2, weight_decay=0.0,
                eps=noam.eps, amsgrad=False, maximize=False,
                grad_scale=scale, found_inf=torch.zeros((), device=dev))
            try:
                call()
                lerr = (pl - ref_p).abs().max().item()
                lib_ms = time_ms(torch, call)
                note = (f"torch._fused_adam_ (grad_scale 1/inv, found_inf "
                        f"0; in place), max_abs_err {lerr:.3g} of p")
            except (RuntimeError, TypeError) as e:
                note = f"none: torch._fused_adam_ refused the call ({e})"
            del pl, gl, ml, vl
        nbytes = 28 * n
        out[label] = {"n": n, "res": res, "lib_ms": lib_ms, "note": note,
                      "nbytes": nbytes}
        k, pr = res["adam_noam"], res["plain"]
        log(f"adam_noam {label}: ms {k['events_ms']:.4f} device "
            f"{k['device_ms']:.4f} ({nbytes / k['device_ms'] / 1e6:.0f} "
            f"GB/s) plain {pr['events_ms']:.4f} device {pr['device_ms']:.4f}"
            f" in {len(pr['kernels_ms'])} kernels, library {lib_ms} "
            f"({note}), bound {1e3 * nbytes / HBM_BPS:.4f} "
            f"({nbytes / 1e6:.1f} MB)")
        del p, g, m, v, state, ref_p
        torch.cuda.empty_cache()
    vgg, lrt = out["vgg"], out["lrt"]
    return entry("adam_noam", "adam.cu", "none: the JAX package's update is "
                 "plain XLA (training/optimizer.py)", 0.0,
                 vgg["res"]["adam_noam"]["events_ms"],
                 vgg["res"]["plain"]["events_ms"], 0.0,
                 vgg["nbytes"] / HBM_BPS, vgg["lib_ms"],
                 library_note=vgg["note"], elements=vgg["n"],
                 device_ms=vgg["res"]["adam_noam"]["device_ms"],
                 plain_device_ms=vgg["res"]["plain"]["device_ms"],
                 plain_kernels=len(vgg["res"]["plain"]["kernels_ms"]),
                 gbps=vgg["nbytes"] / vgg["res"]["adam_noam"]["device_ms"]
                 / 1e6,
                 elements_lrt=lrt["n"],
                 ms_lrt=lrt["res"]["adam_noam"]["events_ms"],
                 device_ms_lrt=lrt["res"]["adam_noam"]["device_ms"],
                 plain_ms_lrt=lrt["res"]["plain"]["events_ms"],
                 plain_device_ms_lrt=lrt["res"]["plain"]["device_ms"],
                 bound_ms_lrt=1e3 * lrt["nbytes"] / HBM_BPS,
                 library_ms_lrt=lrt["lib_ms"],
                 gbps_lrt=lrt["nbytes"] / lrt["res"]["adam_noam"]["device_ms"]
                 / 1e6)


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def make_corpus(root, labels, rng, n=B, name="manifest.csv", text=None,
                seconds_min=7.0):
    """n WAVs of seconds_min-7.99 s (tones + noise) with random transcripts
    of 8-19 characters, or text(chars, rng) where given."""
    import numpy as np
    from end2end_asr_tpu_torch.data.audio import save_wav
    sr = 16000
    rows = []
    chars = [c for c in labels if c.strip()]
    for i in range(n):
        n = int(rng.uniform(seconds_min, SECONDS_MAX) * sr)
        t = np.arange(n) / sr
        y = 0.3 * np.sin(2 * math.pi * (100 + 40 * i) * t) \
            + 0.05 * rng.randn(n)
        wav = os.path.join(root, f"{name[:-4]}_u{i}.wav")
        txt = os.path.join(root, f"{name[:-4]}_u{i}.txt")
        save_wav(wav, y, sr)
        with open(txt, "w", encoding="utf-8") as f:
            f.write(text(chars, rng) if text else
                    "".join(rng.choice(chars, rng.randint(8, 20))))
        rows.append(f"{wav},{txt}")
    manifest = os.path.join(root, name)
    with open(manifest, "w") as f:
        f.write("\n".join(rows) + "\n")
    return manifest


def host_ms(torch, fn, n):
    """Median host ms of n calls of fn(), each between two synchronizes,
    and the last call's result."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), r


def f32_card_vs_cpu(torch, dev, params, cfg, batch, n_vocab, label,
                    dec_steps=8):
    """`params` (a checkpoint's, f32 or int8) at f32 with TF32 off: the
    encoder output of the batch's first utterance and `dec_steps`
    teacher-forced decode steps on it, on the card against the port's
    CPU path. Fails past ENC_TOL / DEC_TOL; returns both max abs errs."""
    import numpy as np
    from end2end_asr_tpu_torch.evaluation import encode_pcm, prepare_params
    from end2end_asr_tpu_torch.models import decoder as D
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    cfg32 = cfg.replace(dtype="float32")
    dims32 = dims_from_config(cfg32)
    cpu = torch.device("cpu")
    p_gpu = prepare_params(params, dims32, dev)
    p_cpu = prepare_params(params, dims32, cpu)
    one = torch.from_numpy(batch.pcm[:1])
    fr1 = torch.from_numpy(batch.n_frames[:1].astype(np.int64))
    e_gpu, _ = encode_pcm(p_gpu, cfg32, dims32, one.to(dev), fr1.to(dev),
                          batch.src_bucket)
    e_cpu, _ = encode_pcm(p_cpu, cfg32, dims32, one, fr1, batch.src_bucket)
    err = (e_gpu.cpu() - e_cpu).abs().max().item()
    log(f"{label}encoder f32 card vs CPU (one utterance): max_abs_err "
        f"{err:.3g} (tol {ENC_TOL}), output {tuple(e_gpu.shape)}")
    if not err <= ENC_TOL:
        fail(f"{label}encoder on the card disagrees with the CPU path: "
             f"{err}")
    toks = np.random.RandomState(SEED).randint(0, n_vocab,
                                               size=(dec_steps, 1))
    logits = []
    for p, d in ((p_gpu, dev), (p_cpu, cpu)):
        cache = D.init_cache(p["decoder"], e_cpu.to(d), dec_steps,
                             dims32.num_heads, dims32.dim_key,
                             dims32.dim_value, dtype=torch.float32)
        logits.append(torch.stack([D.decode_step(
            p["decoder"], cache, torch.from_numpy(toks[t]).to(d), t,
            dims32.num_heads, dims32.dim_key, dims32.dim_value,
            dims32.dim_model, emb_trg_sharing=dims32.emb_trg_sharing,
            dtype=torch.float32).cpu() for t in range(dec_steps)]))
    dec_err = (logits[0] - logits[1]).abs().max().item()
    log(f"{label}decode_step f32 card vs CPU ({dec_steps} steps): "
        f"max_abs_err {dec_err:.3g} (tol {DEC_TOL})")
    if not dec_err <= DEC_TOL:
        fail(f"{label}decoder on the card disagrees with the CPU path: "
             f"{dec_err}")
    return err, dec_err


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

    enc_ms, (enc, _) = host_ms(torch, lambda: encode_pcm(
        prepared, cfg, dims, pcm, frames, batch.src_bucket), 5)
    max_len = min(cfg.decode_max_len, cfg.tgt_max_len)
    greedy_ms, ids = host_ms(torch, lambda: greedy_decode_progressive(
        prepared, enc, dims, max_len=max_len,
        stage_len=cfg.decode_stage_len), 3)
    beam = BeamDecoder(cfg.replace(beam_search=True, beam_width=8), dims,
                       id2label, stage_len=cfg.decode_stage_len)
    beam_ms, hyps = host_ms(torch, lambda: beam.decode(prepared, enc), 2)
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
    fwd = breakdown["encode"]["sums"][FWD_KERNEL_NAME]
    if breakdown["encode"]["device_ms"] is not None and \
            fwd["launches"] != 1:
        fail(f"the encode's profile shows {fwd['launches']} launches of "
             f"{FWD_KERNEL_NAME}, not one per batch")

    err, dec_err = f32_card_vs_cpu(torch, dev, params, cfg, batch,
                                   len(label2id), "")
    # the TF32 hazard: the same encoder comparison with cuDNN/cuBLAS
    # allowed TF32
    cfg32 = cfg.replace(dtype="float32")
    dims32 = dims_from_config(cfg32)
    one = torch.from_numpy(batch.pcm[:1])
    fr1 = torch.from_numpy(batch.n_frames[:1].astype(np.int64))
    e_cpu, _ = encode_pcm(prepare_params(params, dims32, torch.device("cpu")),
                          cfg32, dims32, one, fr1, batch.src_bucket)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    e_tf32, _ = encode_pcm(prepare_params(params, dims32, dev), cfg32,
                           dims32, one.to(dev), fr1.to(dev),
                           batch.src_bucket)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    err_tf32 = (e_tf32.cpu() - e_cpu).abs().max().item()
    log(f"encoder with TF32 allowed vs CPU: max_abs_err {err_tf32:.3g} "
        "(why every f32 comparison here turns TF32 off)")
    model = types.SimpleNamespace(cfg=cfg, params=params, ckpt=ckpt,
                                  manifest=manifest, id2label=id2label,
                                  n_vocab=len(label2id), batch=batch)
    return runs, {"encode_ms": enc_ms, "greedy_ms": greedy_ms,
                  "beam8_ms": beam_ms, "greedy_steps": steps,
                  "encoder_f32_card_vs_cpu_max_abs_err": err,
                  "encoder_tf32_card_vs_cpu_max_abs_err": err_tf32,
                  "decode_step_f32_card_vs_cpu_max_abs_err": dec_err,
                  "profile": breakdown}, model


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def aishell_config(**kw):
    """The AiShell README training configuration (README.md:46-54) at full
    width: batch 12, label smoothing 0.1, dropout 0.1, Noam Adam, bf16."""
    from end2end_asr_tpu_torch.config import Config
    base = dict(feat_extractor="vgg_cnn", num_layers=4, num_heads=8,
                dim_model=512, dim_key=64, dim_value=64, dim_inner=2048,
                dim_emb=512, batch_size=B, label_smoothing=0.1, dropout=0.1,
                k_lr=1.0, min_lr=1e-6, warmup=4000, dtype="bfloat16",
                seed=SEED)
    base.update(kw)
    return Config(**base)


def train_argv(cfg, manifest, valid, labels_path, extra=(), name="aishell"):
    """`manifest`, `valid`: a manifest, or a list of them (joint training;
    no `valid`: no validation)."""
    as_list = lambda m: [m] if isinstance(m, str) else list(m)
    return ["--train-manifest-list", *as_list(manifest),
            *(["--valid-manifest-list", *as_list(valid)] if valid else []),
            "--labels-path", labels_path,
            "--name", name, "--save-folder", "models",
            "--feat_extractor", cfg.feat_extractor,
            "--num-layers", str(cfg.num_layers),
            "--num-heads", str(cfg.num_heads),
            "--dim-model", str(cfg.dim_model),
            "--dim-key", str(cfg.dim_key), "--dim-value", str(cfg.dim_value),
            "--dim-inner", str(cfg.dim_inner), "--dim-emb", str(cfg.dim_emb),
            "--batch-size", str(cfg.batch_size),
            "--label-smoothing", str(cfg.label_smoothing),
            "--dropout", str(cfg.dropout), "--k-lr", str(cfg.k_lr),
            "--min-lr", str(cfg.min_lr), "--warmup", str(cfg.warmup),
            "--dtype", cfg.dtype, "--seed", str(cfg.seed),
            "--save-every", "1",
            *(["--model", cfg.model, "--rank", str(cfg.rank)]
              if cfg.rank else []), *extra]


def train_kernel_table():
    """The default training path's kernels: {name: (reset, count)}."""
    from end2end_asr_tpu_torch.ops import (adam, attention_fused, pool_vjp,
                                           stft, vgg_fused)
    AF, V = attention_fused, vgg_fused
    return {
        "stft_logmag": (stft.reset_launches, lambda: stft.FFT.launches),
        "vgg_block1_fwd": (V.reset_launches, V.launches),
        "vgg_block1_bwd": (V.reset_launches, V.bwd_launches),
        "attn_fwd": (AF.reset_launches, lambda: AF.FWD.launches),
        "attn_bwd": (AF.reset_launches, lambda: AF.BWD.launches),
        "pool_bwd": (pool_vjp.reset_launches, pool_vjp.launches),
        "adam_noam": (adam.reset_launches, lambda: adam.ADAM.launches)}


def kernel_counts(kernels):
    """`kernels`: {name: (reset function, launch-count function)}."""
    return {n: count() for n, (_, count) in kernels.items()}


def reset_kernels(kernels):
    for reset, _ in kernels.values():
        reset()


def fixed_batch_step(torch, dev, kernels, cfg, params, batch, steps=10,
                     model_state=None, label="train step", trace=False):
    """The train step of `cfg` on one fixed batch: our kernels' launches
    in one step, the median host time over `steps` steps (each ending in a
    synchronize), and a profile of one step; with `trace`, also what
    tools/probe_step.py reads in one more profiled step (the kernels inside
    each attention forward and backward and each pool backward)."""
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                          to_device)
    from end2end_asr_tpu_torch.training.optimizer import init_opt_state
    from end2end_asr_tpu_torch.training.steps import (FlatParams,
                                                      make_train_step_impl)
    from end2end_asr_tpu_torch.training.trainer import batch_tensors
    fp = FlatParams(params, dev)
    opt = init_opt_state(cfg, fp.data)
    rng = DropoutRng(SEED, dev)
    state = to_device(model_state or {}, dev)
    step = make_train_step_impl(cfg, dims_from_config(cfg))
    tensors = batch_tensors(batch, dev)
    one = lambda: step(fp, fp.data, opt, rng, *tensors, batch.src_bucket,
                       model_state=state)
    one()
    torch.cuda.synchronize()
    reset_kernels(kernels)
    out = one()
    torch.cuda.synchronize()
    per_step = kernel_counts(kernels)
    log(f"launches per {label} (bucket {batch.src_bucket} frames, "
        f"{batch.targets.shape[1]} target columns): {per_step}")
    if not bool(out[3]["finite"].item()):
        fail(f"{label}: the loss is not finite")
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    log(f"{label}: median {step_ms:.2f} ms over {steps} steps "
        f"(min {min(times):.2f}, max {max(times):.2f}); "
        f"{B / step_ms * 1e3:.1f} utterances/s")
    res = {"step_ms": step_ms, "step_ms_all": times,
           "launches_per_step": per_step,
           "profile": profile(torch, one, top=10)}
    if trace:
        from end2end_asr_tpu_torch.tools import probe_step
        res["trace"] = probe_step.profile_step(torch, one)
    return res


def train_f32_dropout(torch, dev, kernels, work, labels_path, manifest):
    """--dtype float32 at dropout 0.1 through the train entry point: 2
    epochs of one batch (the same 12 utterances) with the counts of
    `kernels` set to 0 before and read after; the loss must be finite and
    the f32 attention kernels (and no bf16 ones) must have launched."""
    from end2end_asr_tpu_torch import train as port_train
    cfg = aishell_config(dtype="float32")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_kernels(kernels)
        t0 = time.time()
        res = port_train.main(train_argv(
            cfg, manifest, manifest, labels_path,
            ["--epochs", "2", "--device", str(dev)], name="f32_dropout"))
        torch.cuda.synchronize()
        counts = kernel_counts(kernels)
    finally:
        os.chdir(cwd)
    losses = [h["train_loss"] for h in res["metrics"]["history"]]
    log(f"train --dtype float32 --dropout 0.1: 2 steps in "
        f"{time.time() - t0:.1f} s, train loss per step "
        f"{[round(v, 4) for v in losses]}, launches {counts}")
    if (res["opt_step"] != 2 or len(losses) != 2
            or not all(math.isfinite(v) for v in losses)):
        fail(f"f32 training with dropout: bad result {losses}, step "
             f"{res['opt_step']}")
    if min(counts["attn_fwd_f32"], counts["attn_bwd_f32"]) < 1 or max(
            counts["attn_fwd"], counts["attn_bwd"]) > 0:
        fail(f"f32 training with dropout did not run the f32 attention "
             f"kernels alone: {counts}")
    return counts, losses


def phase_train(torch, dev, kernels, work, labels_path, epochs=2,
                steps=10, overfit_steps=60, f32_kernels=None):
    """`kernels`: see kernel_counts. Runs the train entry point at full
    width, then times, profiles, overfits and holds an f32 step on the
    card against the CPU path; then trains 2 f32 steps with dropout
    through the entry point, counting `f32_kernels`."""
    import numpy as np
    from end2end_asr_tpu_torch import train as port_train
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import AudioBatchLoader
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                          init_params,
                                                          num_params)
    from end2end_asr_tpu_torch.config import load_vocab
    from end2end_asr_tpu_torch.models.transformer import forward
    from end2end_asr_tpu_torch.training.loss import calculate_loss
    from end2end_asr_tpu_torch.training.optimizer import init_opt_state
    from end2end_asr_tpu_torch.training.steps import (FlatParams, features,
                                                      make_train_step_impl)
    from end2end_asr_tpu_torch.training.trainer import batch_tensors

    with open(labels_path, encoding="utf-8") as f:
        labels = json.load(f)
    rs = np.random.RandomState(SEED + 10)
    manifest = make_corpus(work, labels, rs, n=2 * B, name="train.csv")
    valid = make_corpus(work, labels, rs, n=B, name="valid.csv")
    cfg = aishell_config()

    counts = lambda: kernel_counts(kernels)
    reset = lambda: reset_kernels(kernels)
    cwd = os.getcwd()
    os.chdir(work)           # log/ and models/ of the run go here
    try:
        argv = train_argv(cfg, manifest, valid, labels_path,
                          ["--epochs", str(epochs), "--device", str(dev)])
        reset()
        t0 = time.time()
        res = port_train.main(argv)
        torch.cuda.synchronize()
        run_counts = counts()
        wall = time.time() - t0
        m = res["metrics"]
        log(f"train: {epochs} epochs x 2 steps in {wall:.1f} s, metrics "
            f"{ {k: v for k, v in m.items() if k != 'history'} }, optimizer "
            f"step {res['opt_step']}, launches {run_counts}")
        missing = [n for n, c in run_counts.items() if c < 1]
        if missing:
            fail(f"train: kernels not launched: {missing}")
        if res["opt_step"] != 2 * epochs or not all(
                math.isfinite(m[k]) for k in ("train_loss", "valid_loss")):
            fail(f"train: bad result {m}, step {res['opt_step']}")
        with open(os.path.join("log", "aishell"), encoding="utf-8") as f:
            train_log = f.read()
        if "TRAIN LOSS" not in train_log or "VALID SET 0" not in train_log:
            fail("train: log/aishell lacks the TRAIN / VALID lines")
        res2 = port_train.main(
            train_argv(cfg, manifest, valid, labels_path,
                       ["--epochs", str(epochs + 1), "--device", str(dev),
                        "--auto-resume"]))
        log(f"train --auto-resume: one more epoch, optimizer step "
            f"{res['opt_step']} -> {res2['opt_step']}")
        if res2["opt_step"] != res["opt_step"] + 2 or res2["epochs_run"] != 1:
            fail("train --auto-resume did not continue the optimizer step")
    finally:
        os.chdir(cwd)

    # a fixed batch: launches per step, step time, profile
    label2id, _ = load_vocab(labels_path)
    params = init_params(cfg, len(label2id),
                         torch.Generator().manual_seed(SEED))
    log(f"model: {num_params(params) / 1e6:.2f} M params")
    dims = dims_from_config(cfg)
    rng = DropoutRng(SEED, dev)
    batch = next(iter(AudioBatchLoader(ManifestDataset([manifest], label2id),
                                       cfg)))
    tensors = batch_tensors(batch, dev)
    fixed = fixed_batch_step(torch, dev, kernels, cfg, params, batch,
                             steps=steps, trace=True)
    per_step, times, step_ms, prof = (fixed["launches_per_step"],
                                      fixed["step_ms_all"], fixed["step_ms"],
                                      fixed["profile"])
    if per_step["attn_fwd"] != 3 * cfg.num_layers or \
            per_step["attn_bwd"] != 3 * cfg.num_layers:
        fail(f"expected {3 * cfg.num_layers} attention forwards and "
             f"backwards per step, got {per_step}")
    # the block-1 backward is one fused kernel: its share of the step
    bwd_ms = [ms for n, ms in prof["top"] if BWD_KERNEL_NAME in n]
    if prof["device_ms"] is not None and len(bwd_ms) != 1:
        fail(f"the step's profile does not name {BWD_KERNEL_NAME} among "
             f"its heaviest kernels: {prof['top']}")
    bwd_share = (bwd_ms[0] / prof["device_ms"] if bwd_ms else None)
    attn = prof["sums"][ATTN_BWD_KERNEL_NAME]
    attn_f = prof["sums"][ATTN_FWD_KERNEL_NAME]
    pool = prof["sums"]["pool_bwd"]
    fwd = prof["sums"][FWD_KERNEL_NAME]
    log(f"train step device time {prof['device_ms']} ms, of it "
        f"{BWD_KERNEL_NAME} {bwd_ms} ms (share {bwd_share}), "
        f"{FWD_KERNEL_NAME} {fwd['device_ms']} ms in {fwd['launches']} "
        f"launches; the attention forward {attn_f['device_ms']} ms in "
        f"{attn_f['launches']} launches, backward {attn['device_ms']} ms in "
        f"{attn['launches']} launches; pool_bwd {pool['device_ms']} ms in "
        f"{pool['launches']}; {prof['kernel_launches']} launches in the "
        f"step")
    if prof["device_ms"] is not None and \
            attn["launches"] != per_step["attn_bwd"]:
        fail(f"the step's profile shows {attn['launches']} launches of "
             f"{ATTN_BWD_KERNEL_NAME}, not one per attention backward "
             f"({per_step['attn_bwd']})")
    if prof["device_ms"] is not None and fwd["launches"] != 1:
        fail(f"the step's profile shows {fwd['launches']} launches of "
             f"{FWD_KERNEL_NAME}, not one")
    check_step_copies(fixed["trace"], per_step)

    # overfit one batch: peak lr k·5120^-0.5·warmup^-0.5 ≈ 1e-3
    ocfg = aishell_config(k_lr=0.36, warmup=25)
    ostep = make_train_step_impl(ocfg, dims)
    ofp = FlatParams(params, dev)
    data, oopt = ofp.data, init_opt_state(ocfg, ofp.data)
    losses = []
    for _ in range(overfit_steps):
        data, oopt, _, om, _, _ = ostep(ofp, data, oopt, rng, *tensors,
                                        batch.src_bucket)
        losses.append(om["loss"].item())
    half_at = next((i for i, v in enumerate(losses) if v < losses[0] / 2),
                   None)
    log(f"overfit (k_lr 0.36, warmup 25: peak lr "
        f"{0.36 * 5120 ** -0.5 * 25 ** -0.5:.2e}): loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}; under half the first at step {half_at}")
    if half_at is None or not all(math.isfinite(v) for v in losses):
        fail("overfit: the loss did not fall under half its first value "
             f"within {overfit_steps} steps: {losses[::10]}")

    # one f32 step at dropout 0 (TF32 off) on the card vs the CPU path
    fcfg = aishell_config(dtype="float32", dropout=0.0)
    fdims = dims_from_config(fcfg)
    two = [t[:2] for t in batch_tensors(batch, "cpu")]
    grads = []
    for d in (dev, torch.device("cpu")):
        ffp = FlatParams(params, d)
        leaf = ffp.data.clone().requires_grad_()
        ts = [t.to(d) for t in two]
        spect = features(fcfg, ts[0], ts[1], batch.src_bucket)
        pred, gold = forward(ffp.tree(leaf), spect, ts[1], ts[2], fdims,
                             train=True)
        loss = calculate_loss(pred, gold, None, ts[3], fcfg.label_smoothing)
        g, = torch.autograd.grad(loss, leaf)
        grads.append((loss.item(), ffp.views(g.cpu())))
    (lg, gg), (lc, gc) = grads
    gmax = max(v.abs().max().item() for v in gc.values())
    gerr = max(((gg[k] - v).abs().max() / max(v.abs().max().item(),
                                              1e-3 * gmax)).item()
               for k, v in gc.items())
    lerr = abs(lg - lc) / abs(lc)
    log(f"f32 train step card vs CPU (2 utterances, dropout 0, TF32 off): "
        f"loss {lg:.6f} vs {lc:.6f} (rel {lerr:.2e}, tol {STEP_LOSS_TOL}); "
        f"grads max rel err {gerr:.2e} (tol {STEP_GRAD_TOL})")
    if not (lerr <= STEP_LOSS_TOL and gerr <= STEP_GRAD_TOL):
        fail("the f32 train step on the card disagrees with the CPU path")
    f32_counts, f32_losses = train_f32_dropout(torch, dev, f32_kernels, work,
                                               labels_path, valid)
    return run_counts, f32_counts, manifest, valid, {
        "train_step_ms": step_ms, "train_step_ms_all": times,
        "utterances_per_s": B / step_ms * 1e3,
        "bucket_frames": batch.src_bucket,
        "target_columns": int(batch.targets.shape[1]),
        "launches_per_step": per_step, "profile_step": prof,
        "vgg_block1_bwd_step_device_ms": bwd_ms[0] if bwd_ms else None,
        "vgg_block1_bwd_step_device_share": bwd_share,
        "attn_bwd_step_device_ms": attn["device_ms"],
        "attn_fwd_step_device_ms": attn_f["device_ms"],
        "attn_fwd_step_kernel_launches": attn_f["launches"],
        "pool_bwd_step_device_ms": pool["device_ms"],
        "step_trace": fixed["trace"],
        "vgg_block1_fwd_step_device_ms": fwd["device_ms"],
        "vgg_block1_fwd_step_kernel_launches": fwd["launches"],
        "attn_bwd_step_kernel_launches": attn["launches"],
        "step_kernel_launches": prof["kernel_launches"],
        "run_2_epochs_s": wall, "opt_step_after_resume": res2["opt_step"],
        "overfit_first_loss": losses[0], "overfit_last_loss": losses[-1],
        "overfit_half_at_step": half_at,
        "f32_step_card_vs_cpu_loss_rel_err": lerr,
        "f32_step_card_vs_cpu_grad_rel_err": gerr,
        "f32_dropout_train_losses": f32_losses,
        "f32_dropout_launches": f32_counts}


def check_step_copies(tr, per_step):
    """The default step's trace (tools/probe_step.py): each attention
    forward (with the layer's reshape of its output) and each attention
    backward launches one kernel, its own, and each pool backward only
    its kernel: no copy of q, k, v, out, y or g."""
    af, ab, pb = (tr["attention_forward"], tr["attention_backward"],
                  tr["pool_backward"])
    log(f"default step: {tr['kernel_launches']} launches, "
        f"{tr['copy_kernels']} copy kernels in all "
        f"({tr['copies_by_name']}); attention forward {af}; attention "
        f"backward {ab}; pool backward {pb}; pool layouts "
        f"{tr['pool_formats']}")
    n = per_step["attn_fwd"]
    if not (af["calls"] == n and af["kernels_per_call"] == [1]
            and af["copy_kernels"] == 0
            and all(ATTN_FWD_KERNEL_NAME in x for x in af["names"])):
        fail(f"the step's attention forwards are not one {ATTN_FWD_KERNEL_NAME}"
             f" launch each with no copy: {af}")
    if not (ab["calls"] == n and ab["kernels_per_call"] == [1]
            and ab["copy_kernels"] == 0
            and all(ATTN_BWD_KERNEL_NAME in x for x in ab["names"])):
        fail(f"the step's attention backwards are not one "
             f"{ATTN_BWD_KERNEL_NAME} launch each with no copy: {ab}")
    if not (pb["calls"] == per_step["pool_bwd"] and pb["copy_kernels"] == 0
            and pb["kernels_per_call"] == [1]):
        fail(f"the step's pool backward is not its kernel alone: {pb}")


# ---------------------------------------------------------------------------
# phase 5: the block-2 gate on
# ---------------------------------------------------------------------------

def phase_gate_on(torch, dev, kernels, work, labels_path, ckpt,
                  serve_manifest, manifest, valid):
    """Serving and training with ops.vgg_fused.BLOCK2_ENABLED set, as a
    test sets it. `kernels` as in phase_train, with the block-2 entries."""
    import numpy as np
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch import test as port_test
    from end2end_asr_tpu_torch import train as port_train
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import AudioBatchLoader
    from end2end_asr_tpu_torch.evaluation import encode_pcm, prepare_params
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    from end2end_asr_tpu_torch.training.checkpoint import load_checkpoint

    counts = lambda: kernel_counts(kernels)
    reset = lambda: reset_kernels(kernels)
    cfg, _, params, _, _, label2id, _, _ = load_checkpoint(ckpt)
    batch = next(iter(AudioBatchLoader(
        ManifestDataset([serve_manifest], label2id), cfg)))
    cfg32 = cfg.replace(dtype="float32")
    dims32 = dims_from_config(cfg32)
    p32 = prepare_params(params, dims32, dev)
    pcm = torch.from_numpy(batch.pcm).to(dev)
    frames = torch.from_numpy(batch.n_frames.astype(np.int64)).to(dev)
    enc = lambda: encode_pcm(p32, cfg32, dims32, pcm, frames,
                             batch.src_bucket)[0]
    e_off = enc()
    # the serving encode in the checkpoint's compute type (bf16), gate off
    # here and on below: host ms (median of 5) and one profiled call
    dims16 = dims_from_config(cfg)
    p16 = prepare_params(params, dims16, dev)
    enc16 = lambda: encode_pcm(p16, cfg, dims16, pcm, frames,
                               batch.src_bucket)[0]

    def enc16_timed(label):
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc16()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        prof = profile(torch, enc16)
        log(f"{cfg.dtype} encode of {B} utterances, {label}: median "
            f"{statistics.median(ms):.3f} ms, device {prof['device_ms']}, "
            f"block-2 forward {prof['sums'][FWD2_KERNEL_NAME]}")
        return {"host_ms": statistics.median(ms), "host_ms_all": ms,
                "profile": prof}
    enc16_off = enc16_timed("gate off")

    # every library convolution of the run is counted: with the gate on the
    # front end must call none (nor a plain version, which would)
    convs, real_conv = [0], Fn.conv2d

    def counting_conv(*a, **k):
        convs[0] += 1
        return real_conv(*a, **k)

    def check(label, c, need):
        log(f"gate on, {label}: launches {c}; library conv2d calls "
            f"{convs[0]}")
        missing = [n for n in need if c[n] < 1]
        if missing or c["pool_bwd"] != 0 or convs[0] != 0:
            fail(f"gate on, {label}: kernels not launched {missing}, "
                 f"pool_bwd {c['pool_bwd']}, conv2d calls {convs[0]}")

    V.BLOCK2_ENABLED = True
    Fn.conv2d = counting_conv
    cwd = os.getcwd()
    try:
        e_on = enc()
        err = (e_on - e_off).abs().max().item()
        log(f"encoder f32 on the card, gate on vs gate off ({B} utterances): "
            f"max_abs_err {err:.3g} (tol {ENC_TOL}); conv2d calls {convs[0]}")
        if not err <= ENC_TOL or convs[0] != 0:
            fail(f"the gate-on encoder disagrees with the gate-off one: {err}")
        enc16_on = enc16_timed("gate on")
        f2 = enc16_on["profile"]["sums"][FWD2_KERNEL_NAME]
        if (enc16_on["profile"]["device_ms"] is not None
                and f2["launches"] != 1) or convs[0] != 0:
            fail(f"the gate-on bf16 encode does not run one "
                 f"{FWD2_KERNEL_NAME} and no conv2d: {f2}, conv2d "
                 f"{convs[0]}")
        reset()
        res = port_test.main(["--continue-from", ckpt,
                              "--test-manifest-list", serve_manifest,
                              "--batch-size", str(B), "--device", str(dev)])
        torch.cuda.synchronize()
        serve_counts = counts()
        check("serve greedy", serve_counts,
              ["stft_logmag", "vgg_block1_fwd", "vgg_block2_fwd"])
        if not all(math.isfinite(v) for v in res.values()):
            fail(f"gate on, serve: non-finite metrics {res}")

        tcfg = aishell_config()
        os.chdir(work)
        reset()
        convs[0] = 0
        t0 = time.time()
        res = port_train.main(train_argv(
            tcfg, manifest, valid, labels_path,
            ["--epochs", "1", "--device", str(dev), "--spec-augment",
             "--remat"], name="gate_on"))
        torch.cuda.synchronize()
        train_counts = counts()
        check(f"train --spec-augment --remat (2 steps, {time.time() - t0:.1f}"
              " s)", train_counts,
              [n for n in kernels if n != "pool_bwd"])
        m = res["metrics"]
        if res["opt_step"] != 2 or not all(
                math.isfinite(m[k]) for k in ("train_loss", "valid_loss")):
            fail(f"gate on, train: bad result {m}, step {res['opt_step']}")
        os.chdir(cwd)

        tbatch = next(iter(AudioBatchLoader(
            ManifestDataset([manifest], label2id), tcfg)))
        fixed = fixed_batch_step(torch, dev, kernels, tcfg, params, tbatch,
                                 label="gate-on train step")
        fixed_sr = fixed_batch_step(
            torch, dev, kernels, tcfg.replace(spec_augment=True, remat=True),
            params, tbatch, label="gate-on --spec-augment --remat step")
    finally:
        os.chdir(cwd)
        Fn.conv2d = real_conv
        V.BLOCK2_ENABLED = False
    for f in (fixed, fixed_sr):
        c = f["launches_per_step"]
        if (c["vgg_block2_fwd"], c["vgg_block2_bwd"], c["pool_bwd"]) != (
                1, 1, 0):
            fail(f"gate on: expected one block-2 forward and backward and "
                 f"no pool backward per step, got {c}")
        # the step's profile names the backward's kernels: the row-walking
        # pass and the dx kernel (which also adds up the pass's partials)
        b2 = f["profile"]["sums"]
        log(f"gate on: {FWD2_KERNEL_NAME} {b2[FWD2_KERNEL_NAME]}, "
            f"{BWD2_KERNEL_NAME} {b2[BWD2_KERNEL_NAME]}, all "
            f"{BWD2_PREFIX}* kernels {b2[BWD2_PREFIX]} in the step")
        if (b2[FWD2_KERNEL_NAME]["launches"], b2[BWD2_KERNEL_NAME]["launches"],
                b2[BWD2_PREFIX]["launches"]) != (1, 1, 2):
            fail(f"gate on: the step's profile does not show one "
                 f"{FWD2_KERNEL_NAME} and one {BWD2_KERNEL_NAME} among two "
                 f"{BWD2_PREFIX} kernels: {b2}")
    return serve_counts, train_counts, {
        "encoder_f32_gate_on_vs_off_max_abs_err": err,
        "encode_bf16_gate_off": enc16_off, "encode_bf16_gate_on": enc16_on,
        "train_step_ms": fixed["step_ms"],
        "train_step_ms_all": fixed["step_ms_all"],
        "launches_per_step": fixed["launches_per_step"],
        "profile_step": fixed["profile"],
        "spec_augment_remat_step_ms": fixed_sr["step_ms"],
        "spec_augment_remat_step_ms_all": fixed_sr["step_ms_all"],
        "spec_augment_remat_profile_step": fixed_sr["profile"]}


# ---------------------------------------------------------------------------
# phase 6: CTC and the emb_cnn front end
# ---------------------------------------------------------------------------

def phase_ctc_embcnn(torch, dev, kernels, work, labels_path, epochs=6):
    import numpy as np
    from end2end_asr_tpu_torch import test as port_test
    from end2end_asr_tpu_torch import train as port_train
    from end2end_asr_tpu_torch.config import load_vocab
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import AudioBatchLoader
    from end2end_asr_tpu_torch.models.transformer import (init_params,
                                                          init_state)
    from end2end_asr_tpu_torch.training.checkpoint import (flatten_params,
                                                           load_checkpoint)
    with open(labels_path, encoding="utf-8") as f:
        labels = json.load(f)
    rs = np.random.RandomState(SEED + 20)
    # CTC here runs over the decoder's output positions (the 50-token
    # target bucket + 1), scaled by the valid share of the frames: ~50 for
    # utterances of 7.95-7.99 s. 12 distinct characters (+ SOS, EOS) can be
    # aligned; 30 copies of one character need 32 labels and 29 blanks
    # between the copies, 61 positions, and cannot
    feasible = make_corpus(
        work, labels, rs, name="ctc.csv", seconds_min=7.95,
        text=lambda chars, r: "".join(r.choice(chars, 12, replace=False)))
    infeasible = make_corpus(
        work, labels, rs, name="ctc_inf.csv", seconds_min=7.95,
        text=lambda chars, r: str(r.choice(chars)) * 30)
    # peak lr k * 672^-0.5 * warmup^-0.5 ~ 2.8e-3 at step 25; step 6 runs
    # at 6.7e-4
    cfg = aishell_config(feat_extractor="emb_cnn", loss="ctc", k_lr=0.36,
                         warmup=25)
    extra = ["--loss", "ctc", "--device", str(dev), "--save-every", "100"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_kernels(kernels)
        t0 = time.time()
        res = port_train.main(train_argv(
            cfg, feasible, feasible, labels_path,
            extra + ["--epochs", str(epochs)], name="ctc"))
        torch.cuda.synchronize()
        run_counts = kernel_counts(kernels)
        losses = [h["train_loss"] for h in res["metrics"]["history"]]
        log(f"ctc / emb_cnn: {epochs} epochs x 1 step in "
            f"{time.time() - t0:.1f} s, train loss per step "
            f"{[round(v, 4) for v in losses]}, valid loss "
            f"{res['metrics']['valid_loss']:.4f}, optimizer step "
            f"{res['opt_step']}, launches {run_counts}")
        if min(run_counts["ctc_fwd"], run_counts["ctc_bwd"]) < 1:
            fail(f"ctc / emb_cnn: the CTC kernels did not launch: "
                 f"{run_counts}")
        if (len(losses) != epochs or res["opt_step"] != epochs
                or not all(math.isfinite(v) and v > 0 for v in losses)
                or not losses[-1] < losses[0]
                or not math.isfinite(res["metrics"]["valid_loss"])):
            fail(f"ctc / emb_cnn: the loss is not finite and falling: "
                 f"{losses}")
        best = os.path.join(work, "models", "ctc", "best_model")
        _, epoch, _, opt, state, _, _, _ = load_checkpoint(best)
        flat = flatten_params(state)
        moved = float(flat["frontend::bn1::mean"].abs().sum())
        log(f"checkpoint {best}: epoch {epoch}, optimizer step "
            f"{int(opt['step'])}, state {sorted(flat)}, |bn1 mean| sum "
            f"{moved:.4f}")
        if len(flat) != 4 or not moved > 0:
            fail("ctc / emb_cnn: the checkpoint lacks the batch-norm state")
        out = port_test.main(["--continue-from", best,
                              "--test-manifest-list", feasible,
                              "--batch-size", str(B), "--device", str(dev)])
        log(f"ctc / emb_cnn: served the checkpoint greedy: {out}")
        if not all(math.isfinite(v) for v in out.values()):
            fail(f"ctc / emb_cnn: non-finite serving metrics {out}")
        res2 = port_train.main(train_argv(
            cfg, infeasible, infeasible, labels_path,
            extra + ["--epochs", str(epoch + 1), "--continue-from", best],
            name="ctc_inf"))
        with open(os.path.join("log", "ctc_inf"), encoding="utf-8") as f:
            skipped = "Found infinity loss" in f.read()
        log(f"ctc / emb_cnn: an infeasible batch: epochs run "
            f"{res2['epochs_run']}, optimizer step {int(opt['step'])} -> "
            f"{res2['opt_step']}, skip logged: {skipped}")
        if (res2["epochs_run"] != 1 or res2["opt_step"] != int(opt["step"])
                or not skipped):
            fail("ctc / emb_cnn: the infeasible batch was not skipped")
    finally:
        os.chdir(cwd)
    label2id, _ = load_vocab(labels_path)
    params = init_params(cfg, len(label2id),
                         torch.Generator().manual_seed(SEED))
    batch = next(iter(AudioBatchLoader(
        ManifestDataset([feasible], label2id), cfg)))
    fixed = fixed_batch_step(torch, dev, kernels, cfg, params, batch,
                             model_state=init_state(cfg),
                             label="ctc / emb_cnn train step")
    return {"train_losses": losses, "launches": run_counts,
            "valid_loss": res["metrics"]["valid_loss"],
            "serve": out, "opt_step_after_infeasible_batch": res2["opt_step"],
            "train_step_ms": fixed["step_ms"],
            "train_step_ms_all": fixed["step_ms_all"],
            "launches_per_step": fixed["launches_per_step"],
            "profile_step": fixed["profile"]}


# ---------------------------------------------------------------------------
# phase 7: the serving options
# ---------------------------------------------------------------------------

def phase_serve_options(torch, dev, kernels, work, model, serve, manifests):
    """LSTM-LM rescoring, int8 weight-only serving and streaming on phase
    3's model (`model`: the AiShell README model at full width, seeded
    random weights, its checkpoint, manifest and 12-utterance batch), each
    path through its entry point with the serving kernels' counts
    (`kernels`, as in phase_serve) set to 0 just before and read just
    after. `serve`: phase 3's bf16 numbers; `manifests`: the transcripts
    the LM trains on. With random weights every decode runs its full 300
    steps (200 for the beam), as in phase 3."""
    import numpy as np
    from end2end_asr_tpu_torch import lm_train as port_lm_train
    from end2end_asr_tpu_torch import test as port_test
    from end2end_asr_tpu_torch import transcribe as port_transcribe
    from end2end_asr_tpu_torch.data.audio import load_audio
    from end2end_asr_tpu_torch.decoding.beam import BeamDecoder
    from end2end_asr_tpu_torch.decoding.greedy import \
        greedy_decode_progressive
    from end2end_asr_tpu_torch.decoding.lm_rescoring import \
        calculate_lm_score
    from end2end_asr_tpu_torch.evaluation import encode_pcm, prepare_params
    from end2end_asr_tpu_torch.models.lm import LM
    from end2end_asr_tpu_torch.models.quantize import quantize_for_inference
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.streaming import StreamingTranscriber

    cfg, batch, id2label = model.cfg, model.batch, model.id2label
    dims = dims_from_config(cfg)
    launches = {}

    def counted(name, fn):
        for k in kernels.values():
            k.reset_launches()
        r = fn()
        torch.cuda.synchronize()
        launches[name] = {n: k.launches() for n, k in kernels.items()}
        log(f"serve options, {name}: launches {launches[name]}")
        missing = [n for n, c in launches[name].items() if c < 1]
        if missing:
            fail(f"serve options, {name}: kernels not launched: {missing}")
        return r

    # the LM at lm_train's default size (ninp = nhid = 256, 2 layers),
    # trained on the card through its entry point
    lm_path = os.path.join(work, "lm.npz")
    t0 = time.time()
    lm_res = port_lm_train.main(
        ["--train-manifest-list", *manifests, "--lm-path", lm_path,
         "--batch-size", "8", "--epochs", "20", "--device", str(dev)])
    losses = lm_res["losses"]
    lm_step_ms = statistics.median(lm_res["step_ms"])
    log(f"lm_train: stream {lm_res['stream']}, vocab {lm_res['vocab']}, "
        f"{len(lm_res['step_ms'])} steps in {time.time() - t0:.1f} s, "
        f"median {lm_step_ms:.2f} ms a step, loss per epoch "
        f"{[round(v, 4) for v in losses]}")
    if not (all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        fail(f"lm_train: the loss is not finite and falling: {losses}")

    base = ["--continue-from", model.ckpt, "--test-manifest-list",
            model.manifest, "--batch-size", str(B), "--device", str(dev)]
    beam8 = ["--beam-search", "--beam-width", "8"]
    res = counted("lm_beam8", lambda: port_test.main(
        base + beam8 + ["--lm-rescoring", "--lm-path", lm_path]))
    log(f"serve options, LM-rescored beam-8 through test: {res}")
    if not all(math.isfinite(v) for v in res.values()):
        fail(f"LM-rescored beam-8: non-finite metrics {res}")

    # the batch's n-best under the card's LM, its LM scores against the
    # CPU LM's on the same strings; the beam's time with and without it
    pcm = torch.from_numpy(batch.pcm).to(dev)
    frames = torch.from_numpy(batch.n_frames.astype(np.int64)).to(dev)
    prepared = prepare_params(model.params, dims, dev)
    enc, _ = encode_pcm(prepared, cfg, dims, pcm, frames, batch.src_bucket)
    lm_card, lm_cpu = LM(lm_path, dev), LM(lm_path, "cpu")
    bcfg = cfg.replace(beam_search=True, beam_width=8)
    plain = BeamDecoder(bcfg, dims, id2label, stage_len=cfg.decode_stage_len)
    rescored = BeamDecoder(bcfg.replace(lm_rescoring=True), dims, id2label,
                           lm=lm_card, stage_len=cfg.decode_stage_len)
    beam_ms, _ = host_ms(torch, lambda: plain.decode(prepared, enc), 2)
    lm_beam_ms, nbest = host_ms(torch, lambda: rescored.decode_nbest(
        prepared, enc, nbest=8), 2)
    scores = [(calculate_lm_score(h.ids, lm_card, id2label),
               calculate_lm_score(h.ids, lm_cpu, id2label))
              for utt in nbest for h in utt]
    lm_err = max(abs(g[0] - c[0]) for g, c in scores)
    oov_equal = all(g[1:] == c[1:] for g, c in scores)
    log(f"LM-rescored beam-8: {lm_beam_ms:.2f} ms a batch against "
        f"{beam_ms:.2f} plain; {len(scores)} n-best LM scores card vs CPU "
        f"max_abs_err {lm_err:.3g} (tol {LM_TOL}), words and OOV equal "
        f"{oov_equal}; 1-best final {[u[0].final for u in nbest][:3]}")
    if len(scores) < B or not lm_err <= LM_TOL or not oov_equal:
        fail(f"the card's LM scores disagree with the CPU's: {lm_err}")

    # int8 weight-only serving
    for name, extra in (("int8_greedy", []), ("int8_beam8", beam8)):
        res = counted(name, lambda: port_test.main(
            base + ["--quantize-int8"] + extra))
        log(f"serve options, {name} through test: {res}")
        if not all(math.isfinite(v) for v in res.values()):
            fail(f"{name}: non-finite metrics {res}")
    qparams = quantize_for_inference(model.params)
    qprep = prepare_params(qparams, dims, dev)
    q8 = qprep["decoder"]["output_linear"]["q8"]
    if q8.dtype != torch.int8 or q8.device != dev:
        fail(f"int8 params on the card hold {q8.dtype} on {q8.device}")
    q_enc_ms, (qenc, _) = host_ms(torch, lambda: encode_pcm(
        qprep, cfg, dims, pcm, frames, batch.src_bucket), 5)
    max_len = min(cfg.decode_max_len, cfg.tgt_max_len)
    q_greedy_ms, ids = host_ms(torch, lambda: greedy_decode_progressive(
        qprep, qenc, dims, max_len=max_len,
        stage_len=cfg.decode_stage_len), 3)
    q_beam_ms, _ = host_ms(torch, lambda: plain.decode(qprep, qenc), 2)
    log(f"int8 per batch of {B}: encode {q_enc_ms:.2f} ms, greedy "
        f"{q_greedy_ms:.2f} ms ({int((ids != 2).sum(dim=1).max())} steps), "
        f"beam-8 {q_beam_ms:.2f} ms; bf16 (phase 3): encode "
        f"{serve['encode_ms']:.2f}, greedy {serve['greedy_ms']:.2f}, "
        f"beam-8 {serve['beam8_ms']:.2f}")
    q_prof = profile(torch, lambda: greedy_decode_progressive(
        qprep, qenc, dims, max_len=64, stage_len=64))
    bf16_prof = serve["profile"]["greedy_64_steps"]
    log(f"64 greedy steps, int8 against bf16 (phase 3): launches "
        f"{q_prof['kernel_launches']} / {bf16_prof['kernel_launches']}, "
        f"device ms {q_prof['device_ms']} / {bf16_prof['device_ms']}, wall "
        f"ms {q_prof['wall_ms']:.2f} / {bf16_prof['wall_ms']:.2f}")
    q_enc_err, q_dec_err = f32_card_vs_cpu(torch, dev, qparams, cfg, batch,
                                           model.n_vocab, "int8 ")

    # streaming: one utterance of the batch's manifest fed in 2 s chunks,
    # twice; flush() against transcribe on the whole file
    with open(model.manifest) as f:
        wav = f.readline().split(",")[0]
    y = load_audio(wav)
    chunk = 2 * cfg.sample_rate
    st = StreamingTranscriber(model.params, {}, cfg, id2label, device=dev)
    feed_ms, partials = [], []

    def stream():
        for _ in range(2):
            st.reset()
            for i in range(0, len(y), chunk):
                t0 = time.perf_counter()
                partials.append(st.feed(y[i:i + chunk]))
                feed_ms.append((time.perf_counter() - t0) * 1e3)
        return st.flush()
    final = counted("stream", stream)
    line = port_transcribe.main(["--continue-from", model.ckpt, wav,
                                 "--device", str(dev)])[0]
    p50 = statistics.median(feed_ms)
    p95 = float(np.percentile(feed_ms, 95))
    log(f"streaming {len(y) / cfg.sample_rate:.2f} s in 2 s chunks: "
        f"{len(feed_ms)} feeds, p50 {p50:.2f} ms, p95 {p95:.2f} ms a feed "
        f"({[round(v, 2) for v in feed_ms]}); partial lengths "
        f"{[len(p) for p in partials]}; flush equals transcribe: "
        f"{line.split(chr(9), 1)[1] == final}")
    if line.split("\t", 1)[1] != final or not final:
        fail(f"streaming flush() {final!r} differs from transcribe "
             f"{line!r}")
    return {"lm_train": {"losses": losses, "step_ms_median": lm_step_ms,
                         "steps": len(lm_res["step_ms"]),
                         "stream": lm_res["stream"],
                         "vocab": lm_res["vocab"]},
            "lm_beam8_ms": lm_beam_ms, "beam8_ms": beam_ms,
            "lm_score_card_vs_cpu_max_abs_err": lm_err,
            "lm_scores_compared": len(scores),
            "int8": {"encode_ms": q_enc_ms, "greedy_ms": q_greedy_ms,
                     "beam8_ms": q_beam_ms,
                     "profile_greedy_64_steps": q_prof,
                     "encoder_f32_card_vs_cpu_max_abs_err": q_enc_err,
                     "decode_step_f32_card_vs_cpu_max_abs_err": q_dec_err},
            "stream": {"feed_ms": feed_ms, "feed_ms_p50": p50,
                       "feed_ms_p95": p95, "chunk_s": 2,
                       "seconds": len(y) / cfg.sample_rate},
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 8: augmented joint training and the checkpoint tools
# ---------------------------------------------------------------------------

def write_au(path, y, sr):
    """A Sun .au file of big-endian int16 samples."""
    import numpy as np
    data = np.clip(np.asarray(y) * 32768, -32768, 32767).astype(">i2")
    hdr = np.array([0x2E736E64, 24, data.nbytes, 3, sr, 1], ">u4")
    with open(path, "wb") as f:
        f.write(hdr.tobytes() + data.tobytes())


def make_noise_dir(root, rng):
    """Three WAVs (12 s, 5 s and a 2 s one, shorter than an utterance) and
    a 3 s AU file of filtered noise and hum."""
    import numpy as np
    from end2end_asr_tpu_torch.data.audio import save_wav
    d = os.path.join(root, "noise")
    os.makedirs(d, exist_ok=True)
    sr = 16000
    for name, sec in (("babble.wav", 12.0), ("fan.wav", 5.0),
                      ("click.wav", 2.0), ("hum.au", 3.0)):
        n = int(sec * sr)
        y = np.convolve(rng.randn(n), np.ones(8) / 8, "same") * 0.2 \
            + 0.05 * np.sin(2 * math.pi * 50 * np.arange(n) / sr)
        if name.endswith(".au"):
            write_au(os.path.join(d, name), y, sr)
        else:
            save_wav(os.path.join(d, name), y, sr)
    return d


def log_epoch_walls(path):
    """The (Epoch N) TRAIN ... wall:Xs seconds of a train log, in order."""
    import re
    with open(path, encoding="utf-8") as f:
        return [float(m) for m in re.findall(
            r"\(Epoch \d+\) TRAIN LOSS:.* wall:([0-9.]+)s", f.read())]


def log_train_buckets(path):
    """Per epoch of a train log, its batches per bucket: {"<frames>x<target
    columns>": batches}, from the trainer's TRAIN BATCHES PER BUCKET
    lines."""
    import re
    with open(path, encoding="utf-8") as f:
        return [{k: int(n) for k, n in (c.split(":") for c in m.split())}
                for m in re.findall(
                    r"\(Epoch \d+\) TRAIN BATCHES PER BUCKET \(frames x "
                    r"target columns\): ([0-9x: ]+)\n", f.read())]


def check_bucket_1600(torch, dev, tgt_cols):
    """Kernels 1-5 against their plain versions at the 1600-frame bucket
    that tempo-augmented ~8 s utterances land in: the STFT (B, 1600, 161),
    block 1 bf16 forward and backward at (12, 161, 1600), the attention
    bf16 forward and backward at rate 0.1 at the encoder shape (12, 8, 400,
    400, 64) and the cross shape (12, 8, tgt_cols + 1, 400, 64); phase 2's
    tolerances. Returns {kernel: {max err, kernel ms, plain ms}}."""
    from end2end_asr_tpu_torch.ops import attention_fused as AF
    from end2end_asr_tpu_torch.ops import features as PF
    from end2end_asr_tpu_torch.ops import stft as S
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    F, T, n_fft, hop = 161, 1600, 320, 160
    g = torch.Generator().manual_seed(SEED + 40)
    out = {}
    N = (T - 1) * hop + n_fft
    pcm = (torch.randn(B, N, generator=g) * 0.1).mul(32768).round().div(
        32768).to(dev)
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in PF.dft_matrices(n_fft, "hamming"))
    got = S.stft_logmag(pcm, n_fft, hop, T, "hamming")
    err = (got - PF.stft_logmag_plain(pcm, cos, sin, hop, T)).abs().max(
        ).item()
    out["stft_logmag"] = {"max_abs_err": err, "tol": STFT_TOL, "ms": time_ms(
        torch, lambda: S.stft_logmag(pcm, n_fft, hop, T, "hamming"),
        iters=10), "plain_ms": time_ms(torch, lambda: PF.stft_logmag_plain(
            pcm, cos, sin, hop, T), iters=3)}
    if not (err <= STFT_TOL and got.shape == (B, T, F)):
        fail(f"stft_logmag at T {T}: max_abs_err {err}")

    spect = torch.randn(B, F, T, generator=g).to(dev)
    ws = [(torch.randn(*s, generator=g) * sc).to(dev) for s, sc in
          (((3, 3, 1, 64), 0.3), ((64,), 0.1), ((3, 3, 64, 64), 0.05),
           ((64,), 0.1))]
    cdt = torch.bfloat16
    idx = torch.empty((B, F // 2, T // 2, 64), dtype=torch.uint8, device=dev)
    y = V.vgg_block1(spect, *ws, cdt=cdt, idx_out=idx)
    want, want_idx = V.vgg_block1_plain(spect, *ws, cdt=cdt)
    diff = (y.float() - want.float()).abs()
    same_idx = (idx == want_idx).float().mean().item()
    ok = bool((diff <= VGG_BF16_ATOL + VGG_BF16_RTOL
               * want.float().abs()).all())
    out["vgg_block1_fwd"] = {
        "max_abs_err": diff.max().item(), "idx_equal_share": same_idx,
        "ms": time_ms(torch, lambda: V.vgg_block1(spect, *ws, cdt=cdt,
                                                  idx_out=idx), iters=10),
        "plain_ms": time_ms(torch, lambda: V.vgg_block1_plain(
            spect, *ws, cdt=cdt), iters=3)}
    if not ok or same_idx < 0.99 or y.shape != (B, F // 2, T // 2, 64):
        fail(f"vgg_block1 bf16 at T {T} disagrees with its plain version: "
             f"{out['vgg_block1_fwd']}")
    gy = torch.randn(y.shape, generator=g).to(dev, cdt)
    grads = V.vgg_block1_bwd(spect, *ws[:3], y, idx, gy, cdt)
    want_g = V.vgg_block1_bwd_plain(spect, *ws[:3], y, idx, gy, cdt)
    errs = [rel_err(a, b) for a, b in zip(grads, want_g)]
    out["vgg_block1_bwd"] = {
        "rel_err": errs, "tol": VGG_BWD_BF16_TOL,
        "ms": time_ms(torch, lambda: V.vgg_block1_bwd(
            spect, *ws[:3], y, idx, gy, cdt), iters=10),
        "plain_ms": time_ms(torch, lambda: V.vgg_block1_bwd_plain(
            spect, *ws[:3], y, idx, gy, cdt), iters=3)}
    if not (max(errs) <= VGG_BWD_BF16_TOL
            and all(torch.isfinite(a).all() for a in grads)):
        fail(f"vgg_block1_bwd bf16 at T {T} disagrees with its plain "
             f"version: {errs}")
    del want, want_idx, want_g

    H, D, Tk, rate, seed = 8, 64, T // 4, 0.1, 0x5EED1600
    for label, Tq in (("enc_self", Tk), ("dec_cross", tgt_cols + 1)):
        q, k, v = (torch.randn(B, t, H, D, generator=g).to(
            dev, torch.bfloat16).transpose(1, 2) for t in (Tq, Tk, Tk))
        mask = torch.rand(B, Tq, Tk, generator=g) < 0.1
        mask[0, 0] = True                 # a query with every key masked
        bias = torch.where(mask, -1e9, 0.0).to(dev)
        dout = torch.randn(B, Tq, H, D, generator=g).to(
            dev, torch.bfloat16).transpose(1, 2)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = AF.flash_mha_train(*leaves, bias, seed, rate)
        gq = torch.autograd.grad(o, leaves, dout)
        qf = [t.float().requires_grad_() for t in (q, k, v)]
        want = AF.flash_mha_train_plain(*qf, bias, seed, rate)
        want_g = torch.autograd.grad(want, qf, dout.float())
        ef = rel_err(o, want)
        eb = [rel_err(a, b) for a, b in zip(gq, want_g)]
        o2, stats = AF.attn_fwd(q, k, v, bias, seed, rate)
        out[f"attn_{label}"] = {
            "shape": [B, H, Tq, Tk, D], "fwd_rel_err": ef, "bwd_rel_err": eb,
            "tol": ATTN_TOL,
            "fwd_ms": time_ms(torch, lambda: AF.attn_fwd(
                q, k, v, bias, seed, rate), iters=20),
            "bwd_ms": time_ms(torch, lambda: AF.attn_bwd(
                q, k, v, bias, o2, stats, dout, seed, rate), iters=20)}
        if not (ef <= ATTN_TOL and max(eb) <= ATTN_TOL
                and torch.isfinite(o.float()).all()):
            fail(f"attention {label} at T {T} disagrees with plain: "
                 f"{out[f'attn_{label}']}")
    torch.cuda.synchronize()
    log(f"kernels at the 1600-frame bucket: {json.dumps(out)}")
    return out


def host_data_path(cfg, label2id, manifest, noise_dir):
    """One augmented batch of 12 ~8 s utterances (tempo, gain, noise at
    the default probability) and one plain batch, each built three times
    by a loader of rows 0..B-1 (a new epoch's stream each time) at
    num_workers 0 and 4; and _wsola_py and the C++ WSOLA on a 7.99 s
    utterance.
    Returns the times and the last augmented batch. The loader's tempo
    must run the C++ WSOLA (the JAX package's default path)."""
    import numpy as np
    from end2end_asr_tpu_torch.data import audio as A
    from end2end_asr_tpu_torch.data import audio_host
    if audio_host.active() != "native":
        fail(f"augmentation runs the Python WSOLA, not csrc/audio_host.cc: "
             f"{audio_host.build_error()}")
    from end2end_asr_tpu_torch.data.dataset import (ManifestDataset,
                                                    NoiseInjector)
    from end2end_asr_tpu_torch.data.loader import AudioBatchLoader
    res = {}
    for aug in (True, False):
        noise = (NoiseInjector(noise_dir, cfg.sample_rate,
                               (cfg.noise_min, cfg.noise_max))
                 if aug else None)
        data = ManifestDataset([manifest], label2id, augment=aug,
                               noise_injector=noise,
                               noise_prob=cfg.noise_prob)
        for nw in (0, 4):
            loader = AudioBatchLoader(data, cfg, sampler=[list(range(B))],
                                      seed=SEED, num_workers=nw)
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                batch = next(iter(loader))
                ms.append((time.perf_counter() - t0) * 1e3)
            if aug:
                aug_batch = batch
            key = f"{'augmented' if aug else 'plain'}_batch_ms_workers{nw}"
            res[key], res[key + "_all"] = statistics.median(ms), ms
            res[key.replace("_ms_", "_bucket_")] = batch.src_bucket
    y = np.random.RandomState(SEED).randn(int(7.99 * 16000)).astype(
        np.float32) * 0.1
    for key, fn in (("wsola_7.99s_ms", A._wsola_py),
                    ("native_wsola_7.99s_ms", audio_host.tempo_wsola)):
        ms = []
        for tempo in (0.9, 1.1, 0.87):
            t0 = time.perf_counter()
            fn(y, tempo, 16000)
            ms.append((time.perf_counter() - t0) * 1e3)
        res[key] = ms
    log(f"host data path ({B} x ~8 s, host clock): {json.dumps(res)}")
    return res, aug_batch


def reference_state_dict(params):
    """Phase 3's params (the port's tree) in the reference's module names
    and layouts, DataParallel's "module." prefix included: the inverse of
    the converter's mapping."""
    sd = {}

    def lin(name, p):
        sd[f"{name}.weight"] = p["w"].t().contiguous()
        if "b" in p:
            sd[f"{name}.bias"] = p["b"].clone()

    def ln(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = (p["scale"].clone(),
                                                    p["bias"].clone())

    def mha(base, p):
        for ref, ours in (("query", "q"), ("key", "k"), ("value", "v"),
                          ("output", "out")):
            lin(f"{base}.{ref}_linear", p[ours])
        ln(f"{base}.layer_norm", p["ln"])

    def ffn(base, p):
        for i in (1, 2):
            w = p[f"w{i}"]
            sd[f"{base}.conv_{i}.weight"] = w["w"].t().unsqueeze(-1).contiguous()
            sd[f"{base}.conv_{i}.bias"] = w["b"].clone()
        ln(f"{base}.layer_norm", p["ln"])

    enc, dec = params["encoder"], params["decoder"]
    lin("encoder.input_linear", enc["input_linear"])
    ln("encoder.layer_norm_input", enc["ln_input"])
    for i, layer in enumerate(enc["layers"]):
        mha(f"encoder.layers.{i}.self_attn", layer["self_attn"])
        ffn(f"encoder.layers.{i}.pos_ffn", layer["ffn"])
    sd["decoder.trg_embedding.weight"] = dec["embedding"].clone()
    for i, layer in enumerate(dec["layers"]):
        mha(f"decoder.layers.{i}.self_attn", layer["self_attn"])
        mha(f"decoder.layers.{i}.encoder_attn", layer["enc_attn"])
        ffn(f"decoder.layers.{i}.pos_ffn", layer["ffn"])
    if "output_linear" in dec:
        sd["decoder.output_linear.weight"] = \
            dec["output_linear"]["w"].t().contiguous()
    for k, conv in (("0", "conv1"), ("2", "conv2"), ("5", "conv3"),
                    ("7", "conv4")):
        p = params["frontend"][conv]
        sd[f"conv.{k}.weight"] = p["w"].permute(3, 2, 0, 1).contiguous()
        sd[f"conv.{k}.bias"] = p["b"].clone()
    return {"module." + k: v for k, v in sd.items()}


def greedy_strings(torch, kernels, argv):
    """The HYP strings of `test --verbose` on `argv`, with the serving
    kernels' counts set to 0 just before and read just after."""
    import logging
    from end2end_asr_tpu_torch import test as port_test

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.hyps = []

        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("HYP: "):
                self.hyps.append(msg[5:].split(" || GOLD: ")[0])
    keep = Keep()
    lg = logging.getLogger("end2end_asr_tpu_torch")
    lg.addHandler(keep)
    try:
        for k in kernels.values():
            k.reset_launches()
        res = port_test.main(argv + ["--verbose"])
        torch.cuda.synchronize()
        counts = {n: k.launches() for n, k in kernels.items()}
    finally:
        lg.removeHandler(keep)
    if not all(math.isfinite(v) for v in res.values()):
        fail(f"test {argv}: non-finite metrics {res}")
    missing = [n for n, c in counts.items() if c < 1]
    if missing:
        fail(f"test {argv}: kernels not launched: {missing}")
    return keep.hyps, counts, res


def phase_augment_multi(torch, dev, kernels, serve_kernels, work,
                        labels_path, model, manifest, valid, train):
    """Augmented joint training of the AiShell README model through the
    `multi_train` entry point (two train manifests: phase 4's 24
    utterances and 12 new ones; two valid manifests: phase 4's and phase
    3's; --augment, --noise-dir of a synthesised directory, --num-workers
    4; 2 epochs of 2 batches), with the training kernels' counts
    (`kernels`, as in phase_train) set to 0 before and read after; the
    kernels at the 1600-frame bucket; the host data path's times; then the
    epoch checkpoints averaged by `tools.average_checkpoints` and served
    greedy through `test`, and a reference-layout .th of phase 3's weights
    converted by `tools.convert_reference_checkpoint` and served greedy
    beside phase 3's checkpoint (`serve_kernels`, as in phase_serve)."""
    import argparse

    import numpy as np
    from end2end_asr_tpu_torch import multi_train as port_multi_train
    from end2end_asr_tpu_torch.config import load_vocab
    from end2end_asr_tpu_torch.tools import average_checkpoints as PAV
    from end2end_asr_tpu_torch.tools import \
        convert_reference_checkpoint as PCV
    from end2end_asr_tpu_torch.training.checkpoint import (flatten_params,
                                                           load_checkpoint)

    with open(labels_path, encoding="utf-8") as f:
        labels = json.load(f)
    rs = np.random.RandomState(SEED + 50)
    noise_dir = make_noise_dir(work, rs)
    task1 = make_corpus(work, labels, rs, n=B, name="task1.csv")
    cfg = aishell_config()
    label2id, id2label = load_vocab(labels_path)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_kernels(kernels)
        t0 = time.time()
        res = port_multi_train.main(train_argv(
            cfg, [manifest, task1], [valid, model.manifest], labels_path,
            ["--epochs", "2", "--device", str(dev), "--augment",
             "--noise-dir", noise_dir, "--num-workers", "4"],
            name="augment_multi"))
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernel_counts(kernels)
        with open(os.path.join("log", "augment_multi"),
                  encoding="utf-8") as f:
            run_log = f.read()
        aug_walls = log_epoch_walls(os.path.join("log", "augment_multi"))
        plain_walls = log_epoch_walls(os.path.join("log", "aishell"))
        seen = log_train_buckets(os.path.join("log", "augment_multi"))
        plain_seen = log_train_buckets(os.path.join("log", "aishell"))
    finally:
        os.chdir(cwd)
    m = res["metrics"]
    log(f"multi_train --augment --noise-dir --num-workers 4: 2 epochs in "
        f"{wall:.1f} s, optimizer step {res['opt_step']}, metrics "
        f"{ {k: v for k, v in m.items() if k != 'history'} }, launches "
        f"{counts}; train batches per bucket (frames x target columns) and "
        f"epoch {seen} against the plain run's {plain_seen}; epoch wall s "
        f"{aug_walls} against the plain run's {plain_walls}")
    missing = [n for n, c in counts.items() if c < 1]
    if missing:
        fail(f"augmented joint training: kernels not launched: {missing}")
    if res["opt_step"] != 4 or not all(
            math.isfinite(v) for v in m["valid_losses"] + [m["train_loss"]]):
        fail(f"augmented joint training: bad result {m}, step "
             f"{res['opt_step']}")
    if len(m["valid_losses"]) != 2 or not math.isclose(
            m["valid_loss"], sum(m["valid_losses"]) / 2, rel_tol=1e-12):
        fail(f"multi_train: valid_losses {m.get('valid_losses')} and "
             f"valid_loss {m['valid_loss']} are not the tasks' losses and "
             "their mean")
    for epoch in (1, 2):
        for task in (0, 1):
            if f"(Epoch {epoch}) TASK:{task} VALID LOSS:" not in run_log:
                fail(f"multi_train: no TASK:{task} line in epoch {epoch}")
    shapes = [tuple(map(int, k.split("x"))) for e in seen for k in e]
    if len(seen) != 2 or sum(n for e in seen for n in e.values()) != 4:
        fail(f"multi_train: the log's batches per bucket {seen} are not "
             "2 epochs of 2 batches")
    train_buckets = sorted({t for t, _ in shapes})
    tgt_cols = max(u for _, u in shapes)

    bucket = check_bucket_1600(torch, dev, tgt_cols)
    data_path, aug_batch = host_data_path(cfg, label2id, manifest, noise_dir)

    # the train step on an augmented batch, beside phase 4's 800-bucket one
    run_dir = os.path.join(work, "models", "augment_multi")
    epochs = [os.path.join(run_dir, f"epoch_{e}") for e in (1, 2)]
    step_aug = fixed_batch_step(torch, dev, kernels, cfg,
                                load_checkpoint(epochs[1])[2], aug_batch,
                                steps=5, label="augmented train step")

    # the two epoch checkpoints averaged, then served greedy
    avg = os.path.join(work, "avg")
    t0 = time.time()
    PAV.main([avg, *epochs, "--device", str(dev)])
    avg_s = time.time() - t0
    trees = [flatten_params(load_checkpoint(p)[2]) for p in epochs + [avg]]
    exact = all(torch.equal(trees[2][k], ((trees[0][k].double()
                                           + trees[1][k].double()) / 2
                                          ).to(v.dtype))
                for k, v in trees[2].items())
    serve_argv = ["--test-manifest-list", model.manifest, "--batch-size",
                  str(B), "--device", str(dev)]
    avg_hyps, avg_counts, avg_res = greedy_strings(
        torch, serve_kernels, ["--continue-from", avg] + serve_argv)
    log(f"average_checkpoints of epochs 1-2 in {avg_s:.2f} s: every leaf "
        f"(a + b) / 2 in float64, exactly: {exact}; served greedy through "
        f"test: {avg_res}, launches {avg_counts}")
    if not exact:
        fail("the averaged checkpoint is not the mean of the two epochs")

    # a reference-layout .th of phase 3's weights, converted and served
    th = os.path.join(work, "reference.th")
    torch.save({"label2id": label2id, "id2label": id2label,
                "args": argparse.Namespace(**model.cfg.to_dict()),
                "epoch": 0,
                "model_state_dict": reference_state_dict(model.params),
                "optimizer_state_dict": {},
                "optimizer_params": {"_step": 4321, "_rate": 1e-4,
                                     "warmup": 4000, "factor": 1.0,
                                     "model_size": 512},
                "metrics": {}}, th)
    t0 = time.time()
    converted = PCV.main([th, os.path.join(work, "converted"), "--device",
                          str(dev)])
    conv_s = time.time() - t0
    _, _, cparams, _, _, _, _, cmetrics = load_checkpoint(converted)
    want, got = flatten_params(model.params), flatten_params(cparams)
    same = sorted(want) == sorted(got) and all(
        torch.equal(got[k], v) for k, v in want.items())
    ref_hyps, _, _ = greedy_strings(
        torch, serve_kernels, ["--continue-from", model.ckpt] + serve_argv)
    conv_hyps, conv_counts, _ = greedy_strings(
        torch, serve_kernels, ["--continue-from", converted] + serve_argv)
    log(f"convert_reference_checkpoint in {conv_s:.2f} s: {len(got)} "
        f"tensors, equal to phase 3's bit for bit: {same}; noam_step "
        f"{cmetrics.get('noam_step')}; greedy strings equal to phase 3's "
        f"checkpoint's: {conv_hyps == ref_hyps} ({len(conv_hyps)} strings, "
        f"first {conv_hyps[0][:40]!r}); launches {conv_counts}")
    if not same or cmetrics.get("noam_step") != 4321:
        fail("the converted checkpoint differs from phase 3's weights")
    if conv_hyps != ref_hyps or len(conv_hyps) != B:
        fail("the converted checkpoint's greedy strings differ from "
             "phase 3's")
    return counts, {
        "run_2_epochs_s": wall, "epoch_wall_s": aug_walls,
        "plain_epoch_wall_s": plain_walls[:2],
        "train_step_ms_800_bucket": train["train_step_ms"],
        "augmented_train_step_ms": step_aug["step_ms"],
        "augmented_train_step_ms_all": step_aug["step_ms_all"],
        "augmented_train_step_bucket": aug_batch.src_bucket,
        "train_batches_per_bucket": seen,
        "plain_train_batches_per_bucket": plain_seen,
        "train_buckets": train_buckets,
        "valid_losses": m["valid_losses"], "valid_loss": m["valid_loss"],
        "bucket_1600": bucket, "host_data_path": data_path,
        "average_s": avg_s, "average_exact": exact,
        "average_serve_launches": avg_counts,
        "convert_s": conv_s, "converted_equal": same,
        "converted_strings_equal": conv_hyps == ref_hyps,
        "converted_serve_launches": conv_counts}


# ---------------------------------------------------------------------------
# phase 9: data parallelism, ZeRO-1 and FSDP on the one card
# ---------------------------------------------------------------------------

# bf16, two ranks of 6 rows against one process of 12: the same kernels on
# other row counts, the gradients rounded to bf16 per rank before their
# f32 sum; the train loss is a mean over bf16 logits
DDP_LOSS_RTOL = 2e-2
# ZeRO against plain data parallelism: the same ranks, rows and kernels;
# the gradient sum of two ranks rounds once either way and the update is
# elementwise, so only a reordered sum may move a last bit
ZERO_RTOL = 1e-6
DDP_STEPS = 3           # timed steps a rank (host clock, median)
# at dropout 0 the training attention runs the plain core, as the JAX
# package's attn_core: the dropout kernels launch in the timed steps, which
# run at the train cell's dropout 0.1
NO_DROPOUT_KERNELS = ("stft_logmag", "vgg_block1_fwd", "vgg_block1_bwd",
                      "pool_bwd")


def torchrun(work, nproc, args, name, timeout=300):
    """`python -m torch.distributed.run --standalone` with `nproc` ranks
    in `work`, the checkout on PYTHONPATH; its output kept in
    work/<name>.out. Fails on a non-zero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *args]
    t0 = time.time()
    r = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                       text=True, timeout=timeout)
    with open(os.path.join(work, name + ".out"), "w") as f:
        f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
    if r.returncode != 0:
        fail(f"{name}: {' '.join(cmd[3:])} exited {r.returncode}:\n"
             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return r.stdout, time.time() - t0


def rank_step(cfg, params, dev):
    """This rank's train step as the trainer sets it up: (fp, data, opt,
    step, rng); --zero1 / --fsdp in `cfg` shard it over the data axis, a
    data x model layout (phase 10) runs this rank's shard of the
    parameters, a pipe layout (phase 11) its stage's."""
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.parallel import mesh, tp
    from end2end_asr_tpu_torch.parallel.zero import ZeroShard
    from end2end_asr_tpu_torch.training.checkpoint import (flatten_params,
                                                           model_rank_tree,
                                                           pipe_stage_tree)
    from end2end_asr_tpu_torch.training.optimizer import init_opt_state
    from end2end_asr_tpu_torch.training.steps import (FlatParams,
                                                      make_train_step_impl)
    n_model, n_pipe, plan = mesh.model_size(), mesh.pipe_size(), None
    if n_pipe > 1:
        params = pipe_stage_tree(params, n_pipe, mesh.pipe_rank())
    shapes = {k: tuple(v.shape) for k, v in flatten_params(params).items()}
    if n_model > 1:
        params = model_rank_tree(params, n_model, mesh.model_rank())
    fp = FlatParams(params, dev)
    if n_model > 1 or n_pipe > 1:
        plan = tp.FlatPlan(fp, [k for k in fp.train_keys if tp.leaf_dim(
            k, shapes[k], n_model) is not None], n_model, cfg.seq_parallel,
            n_pipe)
    data = fp.data
    zero = (ZeroShard.for_config(cfg, fp.numel) if cfg.zero1 or cfg.fsdp
            else None)
    opt = init_opt_state(cfg, data if zero is None else zero.shard(data))
    if zero is not None and zero.stage == 3:
        data = zero.shard(data)
    step = make_train_step_impl(cfg, dims_from_config(cfg), zero=zero,
                                plan=plan)
    return fp, data, opt, step, DropoutRng(SEED, dev)


def rank_step_ms(torch, cfg, params, batch, dev, n=DDP_STEPS):
    """Median host ms of the train step on `batch` (this rank's rows),
    each step between two synchronizes, after one untimed step
    (`rank_step`'s set-up)."""
    from end2end_asr_tpu_torch.training.trainer import batch_tensors
    fp, data, opt, step, rng = rank_step(cfg, params, dev)
    tensors = batch_tensors(batch, dev)
    one = lambda: step(fp, data, opt, rng, *tensors, batch.src_bucket)
    one()
    ms, _ = host_ms(torch, one, n)
    return ms


def ddp_rank(spec_path):
    """One rank of phases 9-11 (`chip_smoke.py --ddp-rank SPEC`,
    started by torch.distributed.run): joins the group and runs the spec's
    run, or each of its "runs" in turn in the same group (`rank_run`)."""
    import torch
    from end2end_asr_tpu_torch.parallel import mesh
    with open(spec_path) as f:
        spec = json.load(f)
    dev = mesh.rank_device(torch.device("cuda"))
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.maybe_initialize_distributed(dev)
    for run in spec.get("runs", [spec]):
        (rank_test if "test" in run else rank_run)(torch, run, dev)
    mesh.shutdown()


def rank_run(torch, spec, dev):
    """One run on this rank: the train entry point with the spec's argv
    (--parallel, each rank on cuda:0 with gloo), then the step timed at
    dropout 0.1 on its slice of the first batch; writes the launch counts
    of both, the run's peak memory, the step time, the backend and, under
    a pipe layout, the stage and its hand-offs a step to
    <out>.r<rank>.json. With the spec's "local_heads", the attention
    kernels' checks on a model rank's local heads (`local_head_checks`)
    after the counts are read; with "save_npz", rank 0 writes the run's
    returned (gathered) parameters there as an npz checkpoint."""
    from end2end_asr_tpu_torch import train as port_train
    from end2end_asr_tpu_torch.config import config_from_args, load_vocab
    from end2end_asr_tpu_torch.test import split_device_arg
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import AudioBatchLoader
    from end2end_asr_tpu_torch.parallel import mesh, pp
    rank, world = mesh.rank(), mesh.world_size()
    kernels = train_kernel_table()
    reset_kernels(kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = port_train.main(spec["argv"])
    torch.cuda.synchronize()
    out = {"rank": rank, "world": world, "device": str(dev),
           "backend": torch.distributed.get_backend(),
           "launches": kernel_counts(kernels),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
           "train_s": time.time() - t0, "opt_step": res["opt_step"],
           "train_loss": res["metrics"]["train_loss"]}
    cfg = config_from_args(split_device_arg(spec["argv"])[1])
    label2id, id2label = load_vocab(cfg.labels_path)
    loader = AudioBatchLoader(
        ManifestDataset(list(cfg.train_manifest_list), label2id), cfg,
        process_index=mesh.data_rank(), process_count=mesh.data_size())
    reset_kernels(kernels)
    pp.reset_handoffs()
    out["step_ms"] = rank_step_ms(torch, cfg.replace(dropout=0.1),
                                  res["params"], next(iter(loader)), dev)
    out["step_launches"] = kernel_counts(kernels)
    out["layout"] = [mesh.data_size(), mesh.model_size()]
    if mesh.pipe_size() > 1:
        # data x pipe x model; the hand-offs of the DDP_STEPS + 1 steps
        n = DDP_STEPS + 1
        out.update(layout=[mesh.data_size(), mesh.pipe_size(),
                           mesh.model_size()], stage=mesh.pipe_rank(),
                   transport=mesh.TRANSPORT,
                   handoffs_a_step=pp.HANDOFFS["count"] / n,
                   handoff_MB_a_step=pp.HANDOFFS["bytes"] / n / 1e6,
                   handoff_ms_a_step=pp.HANDOFFS["seconds"] * 1e3 / n)
    if spec.get("local_heads"):
        out["local_heads"] = local_head_checks(torch, dev)
    if spec.get("save_npz") and mesh.is_main():
        from end2end_asr_tpu_torch.training.checkpoint import \
            save_checkpoint
        save_checkpoint(spec["save_npz"], cfg, 1, res["params"], label2id,
                        id2label)
    with open(f"{spec['out']}.r{rank}.json", "w") as f:
        json.dump(out, f)


def rank_test(torch, spec, dev):
    """One `test` run on this rank (phase 10): the serving entry point
    with the spec's argv (--parallel, in the group); writes rank 0's HYP
    strings, the CER, whether the run logged sequence-parallel serving
    and the seconds to <out>.r<rank>.json."""
    import logging
    from end2end_asr_tpu_torch import test as port_test
    from end2end_asr_tpu_torch.parallel import mesh
    lines = []
    keep = logging.Handler()
    keep.emit = lambda r: lines.append(r.getMessage())
    lg = logging.getLogger("end2end_asr_tpu_torch")
    lg.addHandler(keep)
    t0 = time.time()
    try:
        res = port_test.main(spec["test"])
    finally:
        lg.removeHandler(keep)
    torch.cuda.synchronize(dev)
    out = {"rank": mesh.rank(), "seconds": time.time() - t0,
           "cer": res.get("cer"),
           "hyps": [ln[5:].split(" || GOLD: ")[0] for ln in lines
                    if ln.startswith("HYP: ")],
           "seq_parallel": any(ln.startswith("sequence parallelism")
                               for ln in lines)}
    with open(f"{spec['out']}.r{mesh.rank()}.json", "w") as f:
        json.dump(out, f)


def flat_npz(path):
    import numpy as np
    with np.load(path + ".npz") as f:
        return {k: f[k] for k in f.files if k.startswith("params::")
                or k.startswith("opt::")}


def phase_ddp(torch, dev, kernels, serve_kernels, work, labels_path, model,
              manifest, valid, gpu):
    """Data parallelism on the card at the AiShell width (batch 12, bf16,
    dropout 0, one epoch = 2 steps of phase 4's 24 utterances): a group of
    one NCCL rank through `torch.distributed.run -m
    end2end_asr_tpu_torch.train --parallel`; two gloo ranks sharing cuda:0
    (6 rows each) through the same entry point, plain, --zero1 and
    --fsdp, each rank's launches, peak memory and step time read; each
    run's loss and checkpoint against the one-process run of the same
    steps; then `test --parallel` on two ranks over phase 3's checkpoint,
    whose strings must be phase 3's."""
    import numpy as np
    from end2end_asr_tpu_torch import train as port_train
    from end2end_asr_tpu_torch.config import load_vocab
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import AudioBatchLoader
    from end2end_asr_tpu_torch.training.optimizer import noam_rate
    from end2end_asr_tpu_torch.training.steps import noam_config_from
    cfg = aishell_config(dropout=0.0)
    argv = lambda name, extra=(): train_argv(
        cfg, manifest, valid, labels_path, ["--epochs", "1", *extra],
        name=name)
    res = {"gpu": gpu}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # the one-process run of the same 2 steps, and its step time
        ref = port_train.main(argv("ddp_ref", ["--device", str(dev)]))
        label2id, _ = load_vocab(labels_path)
        batch = next(iter(AudioBatchLoader(
            ManifestDataset([manifest], label2id), cfg)))
        res["step_ms_1_process"] = rank_step_ms(
            torch, cfg.replace(dropout=0.1), ref["params"], batch, dev)
    finally:
        os.chdir(cwd)
    ref_ck = flat_npz(os.path.join(work, "models", "ddp_ref", "epoch_1"))
    ref_loss = ref["metrics"]["train_loss"]

    # a group of one NCCL rank, through the entry point alone
    out, secs = torchrun(work, 1, ["-m", "end2end_asr_tpu_torch.train",
                                   *argv("ddp_one"), "--parallel"],
                         "ddp_one")
    with open(os.path.join(work, "log", "ddp_one"), encoding="utf-8") as f:
        one_log = f.read()
    if "process group: 1 ranks, backend nccl" not in one_log:
        fail(f"the group of one did not run on NCCL:\n{one_log[-2000:]}")
    one_ck = flat_npz(os.path.join(work, "models", "ddp_one", "epoch_1"))
    with open(os.path.join(work, "models", "ddp_one", "epoch_1.json"),
              encoding="utf-8") as f:
        one_loss = json.load(f)["metrics"]["train_loss"]
    one_same = all(np.array_equal(one_ck[k], v) for k, v in ref_ck.items())
    log(f"torchrun 1 rank --parallel: backend nccl, {secs:.1f} s; train "
        f"loss {one_loss:.6f} against the one-process {ref_loss:.6f}; its "
        f"checkpoint equals the one-process run's bit for bit: {one_same}")
    res["nccl_1_rank"] = {"seconds": secs, "train_loss": one_loss,
                          "checkpoint_bit_equal": one_same}

    runs = {}
    for name, extra in (("ddp", []), ("zero1", ["--zero1"]),
                        ("fsdp", ["--fsdp"])):
        spec = os.path.join(work, f"{name}.json")
        with open(spec, "w") as f:
            json.dump({"argv": argv("ddp_" + name,
                                    ["--parallel", "--device", "cuda",
                                     *extra]),
                       "out": os.path.join(work, name)}, f)
        _, secs = torchrun(work, 2, [os.path.abspath(__file__), "--ddp-rank",
                                     spec], "ddp_" + name)
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"{name}.r{r}.json")) as f:
                ranks.append(json.load(f))
        ck = flat_npz(os.path.join(work, "models", "ddp_" + name,
                                   "epoch_1"))
        runs[name] = {"ranks": ranks, "ck": ck, "s": secs}
        for rk in ranks:
            missing = [n for n in NO_DROPOUT_KERNELS
                       if rk["launches"][n] < 1] + [
                n for n, c in rk["step_launches"].items() if c < 1]
            if missing or rk["backend"] != "gloo" or rk["opt_step"] != 2:
                fail(f"{name} rank {rk['rank']}: kernels not launched "
                     f"{missing}, backend {rk['backend']}, step "
                     f"{rk['opt_step']}")
        log(f"torchrun 2 ranks --parallel {' '.join(extra)} ({gpu}): "
            f"{secs:.1f} s; " + "; ".join(
                f"rank {rk['rank']} on {rk['device']} ({rk['backend']}): "
                f"launches {rk['launches']} in the run, "
                f"{rk['step_launches']} in the {DDP_STEPS + 1} timed "
                f"steps at dropout 0.1, peak memory "
                f"{rk['peak_mem_bytes'] / 2**20:.1f} MiB, step "
                f"{rk['step_ms']:.2f} ms (median of {DDP_STEPS}, 6 rows)"
                for rk in ranks))

    # losses and checkpoints: the group of one and DDP against one process
    # (bf16; library backward kernels with atomics make even a rerun
    # differ), ZeRO against DDP (tighter)
    report = {}
    runs["nccl_1_rank"] = {"ck": one_ck, "ranks": [{"train_loss": one_loss}]}
    for name, run in runs.items():
        loss = run["ranks"][0]["train_loss"]
        ck = run["ck"]
        dp = max(float(np.abs(ck[k].astype(np.float64)
                              - ref_ck[k].astype(np.float64)).max())
                 for k in ref_ck if k.startswith("params::"))
        report[name] = {"train_loss": loss, "params_max_abs_vs_1_process":
                        dp}
        if name in ("zero1", "fsdp"):
            base = runs["ddp"]["ck"]
            rel = max(float(np.abs(ck[k].astype(np.float64)
                                   - base[k].astype(np.float64)).max()
                            / max(np.abs(base[k]).max(), 1e-30))
                      for k in base if k != "opt::step")
            report[name]["rel_vs_ddp"] = rel
            if rel > ZERO_RTOL or set(ck) != set(base):
                fail(f"{name}: checkpoint differs from plain DDP's by rel "
                     f"{rel:.3g} (tolerance {ZERO_RTOL})")
        if abs(loss - ref_loss) > DDP_LOSS_RTOL * abs(ref_loss):
            fail(f"{name}: train loss {loss} against the one-process "
                 f"{ref_loss} (rtol {DDP_LOSS_RTOL})")
    # Adam's first steps move each parameter by at most ~lr (warmup 4000
    # and min-lr 1e-6: 1e-6 a step; the second step's ratio of moments is
    # at most 1.0009), so two runs differ by at most 2 * (lr1 + lr2)
    # wherever their bf16 gradients' signs differ
    lr_sum = sum(float(noam_rate(torch.tensor(s), noam_config_from(cfg)))
                 for s in (1, 2))
    for name in runs:
        if report[name]["params_max_abs_vs_1_process"] > 2 * lr_sum * 1.01:
            fail(f"{name}: parameters moved {report[name]} from the "
                 f"one-process run's, beyond 2 * (lr1 + lr2) = "
                 f"{2 * lr_sum:.3g}")
    runs.pop("nccl_1_rank")
    res["nccl_1_rank"]["params_max_abs_vs_1_process"] = report.pop(
        "nccl_1_rank")["params_max_abs_vs_1_process"]
    n = sum(v.size for k, v in ref_ck.items() if k.startswith("params::"))
    for name, run in runs.items():
        per = -(-n // 2) if name != "ddp" else n
        report[name].update(
            peak_mem_mib=[rk["peak_mem_bytes"] / 2 ** 20
                          for rk in run["ranks"]],
            moments_mib=2 * per * 4 / 2 ** 20,
            step_ms=[rk["step_ms"] for rk in run["ranks"]],
            launches=[rk["launches"] for rk in run["ranks"]],
            step_launches=[rk["step_launches"] for rk in run["ranks"]],
            seconds=run["s"])
    log(f"data parallelism ({gpu}): one-process loss {ref_loss:.6f}; "
        f"{json.dumps({k: {kk: vv for kk, vv in v.items() if 'launches' not in kk} for k, v in report.items()})}; "
        f"the one-process step {res['step_ms_1_process']:.2f} ms (12 rows)")
    res.update(report=report, one_process_loss=ref_loss)

    # test --parallel on two ranks over phase 3's checkpoint. A bf16
    # product's sums depend on its row count, and the random weights' greedy
    # picks are often near ties: 6 rows a rank flipped 16 characters of
    # phase 3's strings (PERF.md §6; no longer run). At
    # --batch-size 24 the 12 utterances' bin is cycled to 24 rows and rank
    # 0 decodes phase 3's batch as it stood, so the gathered strings must
    # be phase 3's
    serve_argv = ["--continue-from", model.ckpt, "--test-manifest-list",
                  model.manifest]
    ref_hyps, _, _ = greedy_strings(
        torch, serve_kernels,
        serve_argv + ["--batch-size", str(B), "--device", str(dev)])
    batch_size = 2 * B
    out, secs = torchrun(work, 2, [
        "-m", "end2end_asr_tpu_torch.test", "--parallel", "--verbose",
        *serve_argv, "--batch-size", str(batch_size), "--device", "cuda"],
        f"test_parallel_{batch_size}")
    hyps = [ln.split("HYP: ", 1)[1].split(" || GOLD: ")[0]
            for ln in out.splitlines() if "HYP: " in ln]
    same = sum(h == r for h, r in zip(hyps, ref_hyps))
    flips = sum(a != b for h, r in zip(hyps, ref_hyps) for a, b in zip(h, r))
    log(f"torchrun 2 ranks test --parallel --batch-size {batch_size} "
        f"({batch_size // 2} rows a rank): {secs:.1f} s, {len(hyps)} "
        f"strings, {same} equal to phase 3's ({flips} characters differ)")
    res[f"test_parallel_batch{batch_size}"] = {
        "seconds": secs, "strings": len(hyps), "equal_to_phase3": same,
        "characters_differing": flips}
    if hyps != ref_hyps or len(hyps) != B:
        fail(f"test --parallel strings differ from phase 3's: "
             f"{list(zip(hyps, ref_hyps))[:3]}")
    return {n: [{k: (rk["launches"][k], rk["step_launches"][k])
                 for k in rk["launches"]} for rk in r["ranks"]]
            for n, r in runs.items()}, res


# ---------------------------------------------------------------------------
# phase 10: tensor and sequence parallelism, sharded checkpoints
# ---------------------------------------------------------------------------

# the runs of phase 10: (name, ranks, flags). bf16 against the one-process
# run of phase 9 (12 rows, dropout 0, 2 steps): each rank's local heads and
# inner columns are the one-process products' own columns; the row-parallel
# partial products sum in f32 before the one bf16 rounding, and the input
# gradients' partial sums round to bf16 a rank: phase 9's loss and
# parameter rules hold
TP_RUNS = (("tp2", 2, ["--mesh-model", "2"]),
           ("tp2_sp", 2, ["--mesh-model", "2", "--seq-parallel"]),
           ("tp4_zero1", 4, ["--mesh-data", "2", "--mesh-model", "2",
                             "--zero1"]),
           ("tp2_fsdp_dcp", 2, ["--mesh-model", "2", "--fsdp",
                                "--checkpoint-format", "orbax"]))
LOCAL_HEADS = 4          # 8 heads over 2 model ranks


def local_head_checks(torch, dev):
    """In a model rank: attn_fwd / attn_bwd on LOCAL_HEADS heads of the
    encoder's self-attention (the step's layout: transposed views of
    (B, T, H, D), rate 0.1; this rank's own data) against their plain
    versions; and the keep mask that attn_fwd draws at the run's seed for
    each local head (q = k = 0 makes the probabilities uniform, V = I makes
    the output's non-zeros the kept ones), against the plain Philox mask,
    and as a digest that the ranks compare."""
    import hashlib
    from end2end_asr_tpu_torch.ops import attention_fused as AF
    from end2end_asr_tpu_torch.parallel import mesh
    H, D, T = LOCAL_HEADS, 64, 200
    g0 = torch.Generator().manual_seed(SEED + 10 + mesh.model_rank())
    q, k, v = (torch.randn(B, T, H, D, generator=g0).to(
        dev, torch.bfloat16).transpose(1, 2) for _ in range(3))
    bias = torch.where(torch.rand(B, T, T, generator=g0) < 0.1, -1e9,
                       0.0).to(dev)
    dout = torch.randn(B, T, H, D, generator=g0).to(
        dev, torch.bfloat16).transpose(1, 2)
    runs, layout = attention_runs(torch, AF, (q, k, v), bias, dout, SEED,
                                  0.1)
    qf = [t.float().requires_grad_() for t in (q, k, v)]
    want = AF.flash_mha_train_plain(*qf, bias, SEED, 0.1)
    want_g = torch.autograd.grad(want, qf, dout.float())
    out, *grads = runs[0]
    errs = [rel_err(out, want)] + [rel_err(a, b)
                                   for a, b in zip(grads, want_g)]
    Tm = 64
    zero = torch.zeros(2, H, Tm, Tm, device=dev, dtype=torch.bfloat16)
    eye = torch.eye(Tm, device=dev, dtype=torch.bfloat16).expand(
        2, H, Tm, Tm).contiguous()
    o = AF.flash_mha_train(zero, zero, eye,
                           torch.zeros(2, Tm, Tm, device=dev), SEED, 0.1)
    keep = o != 0
    plain = AF.keep_mask(SEED, 2, H, Tm, Tm, AF.dropout_thresh16(0.1), dev)
    torch.cuda.synchronize()
    return {"errs": errs, "two_runs_bit_identical": all(
                torch.equal(a, b) for a, b in zip(*runs)),
            "layout": layout,
            "mask_equals_plain": bool(torch.equal(keep, plain)),
            "keep_fraction": keep.float().mean().item(),
            "mask_digest": hashlib.sha256(
                keep.cpu().numpy().tobytes()).hexdigest()}


def phase_tp(torch, dev, serve_kernels, work, labels_path, model, manifest,
             valid, gpu):
    """Tensor and sequence parallelism at the AiShell width (batch 12,
    bf16, dropout 0, one epoch = 2 steps, phase 9's one-process run the
    reference), gloo ranks sharing cuda:0 through phase 9's --ddp-rank
    mode: --mesh-model 2 (2 ranks), --mesh-model 2 --seq-parallel (2),
    --mesh-data 2 --mesh-model 2 --zero1 (4) and --mesh-model 2 --fsdp
    --checkpoint-format orbax (2), each rank's launches and step time
    read, each run's loss and checkpoint against the one-process run; the
    attention kernels on 4 local heads at rate 0.1; then `test` in one
    process on the sharded save against the npz of the same run's
    parameters, and `test --parallel --mesh-model 2` over phase 3's
    checkpoint, whose strings must be one process's at f32 (counted at
    bf16)."""
    import numpy as np
    from end2end_asr_tpu_torch.training.checkpoint import (flatten_params,
                                                           load_checkpoint)
    from end2end_asr_tpu_torch.training.optimizer import noam_rate
    from end2end_asr_tpu_torch.training.steps import noam_config_from
    cfg = aishell_config(dropout=0.0)
    ref_ck = flat_npz(os.path.join(work, "models", "ddp_ref", "epoch_1"))
    with open(os.path.join(work, "models", "ddp_ref", "epoch_1.json"),
              encoding="utf-8") as f:
        ref_loss = json.load(f)["metrics"]["train_loss"]
    lr_sum = sum(float(noam_rate(torch.tensor(s), noam_config_from(cfg)))
                 for s in (1, 2))
    res, counts = {"gpu": gpu, "one_process_loss": ref_loss}, {}
    npz_base = os.path.join(work, "models", "tp2_fsdp_npz", "epoch_1")
    for name, nproc, extra in TP_RUNS:
        spec = os.path.join(work, f"{name}.json")
        with open(spec, "w") as f:
            json.dump({"argv": train_argv(
                cfg, manifest, valid, labels_path,
                ["--epochs", "1", "--parallel", "--device", "cuda", *extra],
                name=name), "out": os.path.join(work, name),
                "local_heads": name == "tp2",
                "save_npz": npz_base if name.endswith("dcp") else None}, f)
        _, secs = torchrun(work, nproc, [os.path.abspath(__file__),
                                         "--ddp-rank", spec], name)
        ranks = []
        for r in range(nproc):
            with open(os.path.join(work, f"{name}.r{r}.json")) as f:
                ranks.append(json.load(f))
        for rk in ranks:
            missing = [n for n in NO_DROPOUT_KERNELS
                       if rk["launches"][n] < 1] + [
                n for n, c in rk["step_launches"].items() if c < 1]
            if missing or rk["backend"] != "gloo" or rk["opt_step"] != 2:
                fail(f"{name} rank {rk['rank']}: kernels not launched "
                     f"{missing}, backend {rk['backend']}, step "
                     f"{rk['opt_step']}")
        base = os.path.join(work, "models", name, "epoch_1")
        if name.endswith("dcp"):
            if not os.path.isdir(base + ".dcp") or os.path.exists(
                    base + ".npz"):
                fail(f"{name}: no {base}.dcp, or an npz beside it")
            files = sorted(os.listdir(base + ".dcp"))
            res["dcp_files"] = {fn: os.path.getsize(
                os.path.join(base + ".dcp", fn)) for fn in files}
            t0 = time.time()
            _, _, params, opt, _, _, _, _ = load_checkpoint(base)
            res["dcp_load_s"] = time.time() - t0
            log(f"{name}: {base}.dcp holds {res['dcp_files']} (bytes), "
                f"loaded in one process in {res['dcp_load_s']:.2f} s")
            ck = {"params::" + k: v.float().numpy()
                  for k, v in flatten_params(params).items()}
            saved = flat_npz(npz_base)
            same = all(np.array_equal(saved[k], v) for k, v in ck.items())
            res["dcp_equals_the_runs_npz"] = same
            if not same or int(opt["step"]) != 2:
                fail(f"{name}: the sharded checkpoint loaded in one process "
                     f"differs from the run's gathered parameters")
        else:
            ck = flat_npz(base)
        loss = ranks[0]["train_loss"]
        dp = max(float(np.abs(ck[k].astype(np.float64)
                              - ref_ck[k].astype(np.float64)).max())
                 for k in ref_ck if k.startswith("params::"))
        res[name] = {
            "seconds": secs, "train_loss": loss,
            "params_max_abs_vs_1_process": dp,
            "layout": ranks[0]["layout"],
            "step_ms": [rk["step_ms"] for rk in ranks],
            "peak_mem_mib": [rk["peak_mem_bytes"] / 2 ** 20
                             for rk in ranks]}
        counts[name] = [{k: (rk["launches"][k], rk["step_launches"][k])
                         for k in rk["launches"]} for rk in ranks]
        log(f"torchrun {nproc} ranks --parallel {' '.join(extra)} ({gpu}): "
            f"{secs:.1f} s; train loss {loss:.6f} against the one-process "
            f"{ref_loss:.6f}; parameters {dp:.3g} from it (bound "
            f"{2 * lr_sum:.3g}); " + "; ".join(
                f"rank {rk['rank']} (data x model {rk['layout']}): launches "
                f"{rk['launches']} in the run, {rk['step_launches']} in the "
                f"{DDP_STEPS + 1} timed steps at dropout 0.1, step "
                f"{rk['step_ms']:.2f} ms, peak "
                f"{rk['peak_mem_bytes'] / 2 ** 20:.1f} MiB" for rk in ranks))
        if abs(loss - ref_loss) > DDP_LOSS_RTOL * abs(ref_loss):
            fail(f"{name}: train loss {loss} against the one-process "
                 f"{ref_loss} (rtol {DDP_LOSS_RTOL})")
        if dp > 2 * lr_sum * 1.01:
            fail(f"{name}: parameters moved {dp:.3g} from the one-process "
                 f"run's, beyond 2 * (lr1 + lr2) = {2 * lr_sum:.3g}")
        if name == "tp2":
            heads = [rk["local_heads"] for rk in ranks]
            log(f"attention on {LOCAL_HEADS} local heads, rate 0.1, each "
                f"rank: {heads}")
            res["local_heads"] = heads
            if not (all(max(h["errs"]) <= ATTN_TOL
                        and h["two_runs_bit_identical"]
                        and all(h["layout"].values())
                        and h["mask_equals_plain"] for h in heads)
                    and len({h["mask_digest"] for h in heads}) == 1):
                fail(f"attention at {LOCAL_HEADS} local heads: {heads}")

    # serving: the sharded save in one process, against the npz of the
    # same run; then TP inference over phase 3's checkpoint
    serve = lambda base, extra=(): greedy_strings(torch, serve_kernels, [
        "--continue-from", base, "--test-manifest-list", model.manifest,
        "--batch-size", str(B), "--device", str(dev), *extra])[0]
    dcp_hyps = serve(os.path.join(work, "models", "tp2_fsdp_dcp",
                                  "epoch_1"))
    npz_hyps = serve(npz_base)
    res["dcp_strings_equal_npz"] = dcp_hyps == npz_hyps
    log(f"test in one process on the sharded save: {len(dcp_hyps)} strings, "
        f"equal to the npz's: {dcp_hyps == npz_hyps}")
    if dcp_hyps != npz_hyps or len(dcp_hyps) != B:
        fail(f"the sharded save serves other strings than the npz: "
             f"{list(zip(dcp_hyps, npz_hyps))[:3]}")
    # TP inference over phase 3's checkpoint, 12 rows a rank. In bf16 the
    # shards' products are cuBLAS GEMMs of other widths (the local heads'
    # 256 columns, not 512), whose f32 sums run in another order before
    # their bf16 rounding, and the random weights' greedy picks are often
    # near ties (phase 9): the strings equal to phase 3's are counted. In
    # f32 (TF32 off) the sums differ by ~1e-7 relative: the strings must
    # be the one-process f32 run's
    for dtype in ("bfloat16", "float32"):
        extra = ["--dtype", dtype]
        ref_hyps = serve(model.ckpt, extra)
        out, secs = torchrun(work, 2, [
            "-m", "end2end_asr_tpu_torch.test", "--parallel", "--mesh-model",
            "2", "--verbose", "--continue-from", model.ckpt,
            "--test-manifest-list", model.manifest, "--batch-size", str(B),
            "--device", "cuda", *extra], "test_tp_" + dtype)
        hyps = [ln.split("HYP: ", 1)[1].split(" || GOLD: ")[0]
                for ln in out.splitlines() if "HYP: " in ln]
        flips = sum(a != b for h, r in zip(hyps, ref_hyps)
                    for a, b in zip(h, r))
        res["test_tp_" + dtype] = {
            "seconds": secs, "strings": len(hyps),
            "equal_to_one_process": sum(
                h == r for h, r in zip(hyps, ref_hyps)),
            "characters_differing": flips}
        log(f"torchrun 2 ranks test --parallel --mesh-model 2 --batch-size "
            f"{B} --dtype {dtype} ({B} rows a rank, 4 local heads): "
            f"{res['test_tp_' + dtype]} against phase 3's checkpoint "
            f"served by one process at {dtype}")
        if len(hyps) != B or (dtype == "float32" and hyps != ref_hyps):
            fail(f"test --parallel --mesh-model 2 --dtype {dtype}: strings "
                 f"differ from one process's: {list(zip(hyps, ref_hyps))[:3]}")
    return counts, res


# the low-rank runs of phase 10: (name, flags), in one group of 2 ranks,
# against the one-process LRTRFS run of the same 2 steps by phase 9's rules
LR_RANK = 100
TP_LR_RUNS = (("tp2_lr", ["--mesh-model", "2"]),
              ("tp2_lr_sp", ["--mesh-model", "2", "--seq-parallel"]),
              ("tp2_lr_fsdp_dcp", ["--mesh-model", "2", "--fsdp",
                                   "--checkpoint-format", "orbax"]))


def phase_tp_lowrank(torch, dev, serve_kernels, work, labels_path, model,
                     manifest, valid, gpu):
    """Phase 10's low-rank and int8 runs: the AiShell width at --model
    LRTRFS --rank LR_RANK (batch 12, bf16, dropout 0, one epoch = 2
    steps): the one-process run in this process, then one group of 2
    gloo ranks sharing cuda:0 (the --ddp-rank mode) that runs TP_LR_RUNS
    (each rank's launches, step time and peak memory read; the attention
    kernels on 4 local heads) and then `test --parallel --mesh-model 2`
    over tp2_lr's checkpoint and, with --quantize-int8, over phase 3's,
    at f32 and bf16, and over the checkpoint of phase 10's --seq-parallel
    run (tp2_sp) at f32, which must serve on T slices. Each train run's
    loss and gathered parameters against the one-process run's; the
    served strings against one process's on the same checkpoint (and
    flags): equal at f32, counted at bf16."""
    import numpy as np
    from end2end_asr_tpu_torch import train as port_train
    from end2end_asr_tpu_torch.config import load_vocab
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import AudioBatchLoader
    from end2end_asr_tpu_torch.models.transformer import num_params
    from end2end_asr_tpu_torch.training.checkpoint import (flatten_params,
                                                           load_checkpoint)
    from end2end_asr_tpu_torch.training.optimizer import noam_rate
    from end2end_asr_tpu_torch.training.steps import noam_config_from
    cfg = aishell_config(dropout=0.0, model="LRTRFS", rank=LR_RANK)
    argv = lambda name, extra=(): train_argv(
        cfg, manifest, valid, labels_path, ["--epochs", "1", *extra],
        name=name)
    res, counts = {"gpu": gpu, "rank": LR_RANK}, {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        ref = port_train.main(argv("lr_ref", ["--device", str(dev)]))
        label2id, _ = load_vocab(labels_path)
        batch = next(iter(AudioBatchLoader(
            ManifestDataset([manifest], label2id), cfg)))
        res["step_ms_1_process"] = rank_step_ms(
            torch, cfg.replace(dropout=0.1), ref["params"], batch, dev)
    finally:
        os.chdir(cwd)
    res["params_M"] = num_params(ref["params"]) / 1e6
    ref_base = os.path.join(work, "models", "lr_ref", "epoch_1")
    ref_ck = flat_npz(ref_base)
    ref_loss = ref["metrics"]["train_loss"]
    res["one_process_loss"] = ref_loss
    log(f"LRTRFS rank {LR_RANK}: {res['params_M']:.2f} M params; the "
        f"one-process run: train loss {ref_loss:.6f}, step "
        f"{res['step_ms_1_process']:.2f} ms (12 rows, dropout 0.1)")
    lr_sum = sum(float(noam_rate(torch.tensor(s), noam_config_from(cfg)))
                 for s in (1, 2))

    # the group: the train runs, then the serving runs
    npz_base = os.path.join(work, "models", "tp2_lr_fsdp_npz", "epoch_1")
    runs = [{"argv": argv(name, ["--parallel", "--device", "cuda",
                                 *extra]),
             "out": os.path.join(work, name),
             "local_heads": name == "tp2_lr",
             "save_npz": npz_base if name.endswith("dcp") else None}
            for name, extra in TP_LR_RUNS]
    serves = {"lr_f32": (os.path.join(work, "models", "tp2_lr", "epoch_1"),
                         ["--dtype", "float32"]),
              "lr_bf16": (os.path.join(work, "models", "tp2_lr", "epoch_1"),
                          ["--dtype", "bfloat16"]),
              "int8_f32": (model.ckpt, ["--dtype", "float32",
                                        "--quantize-int8"]),
              "int8_bf16": (model.ckpt, ["--dtype", "bfloat16",
                                         "--quantize-int8"]),
              "sp_f32": (os.path.join(work, "models", "tp2_sp", "epoch_1"),
                         ["--dtype", "float32"])}
    serve_argv = lambda base, extra: [
        "--continue-from", base, "--test-manifest-list", model.manifest,
        "--batch-size", str(B), *extra]
    runs += [{"test": serve_argv(base, extra) + [
                  "--parallel", "--mesh-model", "2", "--verbose",
                  "--device", "cuda"],
              "out": os.path.join(work, "test_tp_" + name)}
             for name, (base, extra) in serves.items()]
    spec = os.path.join(work, "tp_lowrank.json")
    with open(spec, "w") as f:
        json.dump({"runs": runs}, f)
    _, secs = torchrun(work, 2, [os.path.abspath(__file__), "--ddp-rank",
                                 spec], "tp_lowrank", timeout=600)
    res["group_seconds"] = secs
    log(f"torchrun 2 ranks, runs {[n for n, _ in TP_LR_RUNS]} and "
        f"{len(serves)} test runs: {secs:.1f} s")

    for name, extra in TP_LR_RUNS:
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"{name}.r{r}.json")) as f:
                ranks.append(json.load(f))
        for rk in ranks:
            missing = [n for n in NO_DROPOUT_KERNELS
                       if rk["launches"][n] < 1] + [
                n for n, c in rk["step_launches"].items() if c < 1]
            if missing or rk["backend"] != "gloo" or rk["opt_step"] != 2:
                fail(f"{name} rank {rk['rank']}: kernels not launched "
                     f"{missing}, backend {rk['backend']}, step "
                     f"{rk['opt_step']}")
        base = os.path.join(work, "models", name, "epoch_1")
        if name.endswith("dcp"):
            if not os.path.isdir(base + ".dcp") or os.path.exists(
                    base + ".npz"):
                fail(f"{name}: no {base}.dcp, or an npz beside it")
            _, _, params, opt, _, _, _, _ = load_checkpoint(base)
            ck = {"params::" + k: v.float().numpy()
                  for k, v in flatten_params(params).items()}
            saved = flat_npz(npz_base)
            same = all(np.array_equal(saved[k], v) for k, v in ck.items())
            res["dcp_equals_the_runs_npz"] = same
            if not same or int(opt["step"]) != 2:
                fail(f"{name}: the sharded checkpoint loaded in one process "
                     f"differs from the run's gathered parameters")
        else:
            ck = flat_npz(base)
        loss = ranks[0]["train_loss"]
        dp = max(float(np.abs(ck[k].astype(np.float64)
                              - ref_ck[k].astype(np.float64)).max())
                 for k in ref_ck if k.startswith("params::"))
        res[name] = {
            "train_s": [rk["train_s"] for rk in ranks], "train_loss": loss,
            "loss_rel_vs_1_process": abs(loss - ref_loss) / abs(ref_loss),
            "params_max_abs_vs_1_process": dp,
            "layout": ranks[0]["layout"],
            "step_ms": [rk["step_ms"] for rk in ranks],
            "peak_mem_mib": [rk["peak_mem_bytes"] / 2 ** 20
                             for rk in ranks]}
        counts[name] = [{k: (rk["launches"][k], rk["step_launches"][k])
                         for k in rk["launches"]} for rk in ranks]
        log(f"2 ranks --parallel {' '.join(extra)} --model LRTRFS --rank "
            f"{LR_RANK} ({gpu}): train loss {loss:.6f} against the "
            f"one-process {ref_loss:.6f}; parameters {dp:.3g} from it "
            f"(bound {2 * lr_sum:.3g}); " + "; ".join(
                f"rank {rk['rank']} (data x model {rk['layout']}): launches "
                f"{rk['launches']} in the run, {rk['step_launches']} in the "
                f"{DDP_STEPS + 1} timed steps at dropout 0.1, step "
                f"{rk['step_ms']:.2f} ms, peak "
                f"{rk['peak_mem_bytes'] / 2 ** 20:.1f} MiB" for rk in ranks))
        if abs(loss - ref_loss) > DDP_LOSS_RTOL * abs(ref_loss):
            fail(f"{name}: train loss {loss} against the one-process "
                 f"{ref_loss} (rtol {DDP_LOSS_RTOL})")
        if dp > 2 * lr_sum * 1.01:
            fail(f"{name}: parameters moved {dp:.3g} from the one-process "
                 f"run's, beyond 2 * (lr1 + lr2) = {2 * lr_sum:.3g}")
        if name == "tp2_lr":
            heads = [rk["local_heads"] for rk in ranks]
            res["local_heads"] = heads
            if not (all(max(h["errs"]) <= ATTN_TOL
                        and h["two_runs_bit_identical"]
                        and all(h["layout"].values())
                        and h["mask_equals_plain"] for h in heads)
                    and len({h["mask_digest"] for h in heads}) == 1):
                fail(f"attention at {LOCAL_HEADS} local heads: {heads}")

    # the served strings against one process's on the same checkpoint
    for name, (base, extra) in serves.items():
        with open(os.path.join(work, f"test_tp_{name}.r0.json")) as f:
            got = json.load(f)
        want = greedy_strings(torch, serve_kernels, serve_argv(base, extra)
                              + ["--device", str(dev)])[0]
        hyps = got["hyps"]
        flips = sum(a != b for h, r in zip(hyps, want) for a, b in zip(h, r))
        res["test_tp_" + name] = {
            "seconds": got["seconds"], "strings": len(hyps),
            "equal_to_one_process": sum(h == r for h, r in zip(hyps, want)),
            "characters_differing": flips,
            "seq_parallel": got["seq_parallel"]}
        log(f"test --parallel --mesh-model 2 {' '.join(extra)} over "
            f"{os.path.relpath(base, work)}: {res['test_tp_' + name]} "
            f"against one process")
        if len(hyps) != B or (name.endswith("f32") and hyps != want):
            fail(f"test --parallel --mesh-model 2 {' '.join(extra)} over "
                 f"{base}: strings differ from one process's: "
                 f"{list(zip(hyps, want))[:3]}")
        if got["seq_parallel"] != name.startswith("sp"):
            fail(f"test_tp_{name}: sequence-parallel serving "
                 f"{got['seq_parallel']}, expected {name.startswith('sp')}")
    return counts, res


# ---------------------------------------------------------------------------
# phase 11: pipeline parallelism
# ---------------------------------------------------------------------------

# the runs of phase 11: (name, ranks, flags), against the one-process run of
# phase 9 by its rules: each microbatch runs the one-process layers on its
# rows (6 or 3 of 12, as DDP's ranks), and the stages' gradients of the
# leaves outside the stacks sum zeros with the one stage's own
PP_RUNS = (("pp2", 2, ["--mesh-pipe", "2"]),
           ("pp2_m4", 2, ["--mesh-pipe", "2", "--pipe-microbatches", "4"]),
           ("pp4_remat", 4, ["--mesh-pipe", "4", "--remat"]),
           ("pp2_tp2", 4, ["--mesh-pipe", "2", "--mesh-model", "2"]),
           ("dp2_pp2_zero1", 4, ["--mesh-data", "2", "--mesh-pipe", "2",
                                 "--zero1"]))
# the kernels stage 0 alone launches: the features and the vgg front end
FRONT_KERNELS = ("stft_logmag", "vgg_block1_fwd", "vgg_block1_bwd",
                 "pool_bwd")
STACK_KERNELS = ("attn_fwd", "attn_bwd")


def phase_pp(torch, dev, serve_kernels, work, labels_path, model, manifest,
             valid, gpu):
    """Pipeline parallelism at the AiShell width (batch 12, bf16, dropout
    0, one epoch = 2 steps, phase 9's one-process run the reference),
    gloo ranks sharing cuda:0 through phase 9's --ddp-rank mode (their
    hand-offs through pinned host memory): --mesh-pipe 2 at M 2 and 4,
    --mesh-pipe 4 --remat, --mesh-pipe 2 --mesh-model 2, --mesh-data 2
    --mesh-pipe 2 --zero1. Each rank must launch its stage's kernels (stage
    0 the front end's and the attention's, the others the attention's and
    none of the front end's; the attention's in the timed steps at dropout
    0.1); each run's loss and gathered parameters must be the one-process
    run's within phase 9's rules; the step ms, peak memory and hand-offs
    a rank are read. Then the first run's gathered checkpoint serves phase
    3's 12 rows through one-process `test`, against the one-process run's
    checkpoint: the same strings at f32, the equal ones counted at
    bf16."""
    import numpy as np
    from end2end_asr_tpu_torch.training.optimizer import noam_rate
    from end2end_asr_tpu_torch.training.steps import noam_config_from
    cfg = aishell_config(dropout=0.0)
    ref_base = os.path.join(work, "models", "ddp_ref", "epoch_1")
    ref_ck = flat_npz(ref_base)
    with open(ref_base + ".json", encoding="utf-8") as f:
        ref_loss = json.load(f)["metrics"]["train_loss"]
    lr_sum = sum(float(noam_rate(torch.tensor(s), noam_config_from(cfg)))
                 for s in (1, 2))
    res, counts = {"gpu": gpu, "one_process_loss": ref_loss}, {}
    # the runs of each world size in one group, one after the other
    for nproc in sorted({n for _, n, _ in PP_RUNS}):
        runs = [(name, extra) for name, n, extra in PP_RUNS if n == nproc]
        spec = os.path.join(work, f"pp_{nproc}_ranks.json")
        with open(spec, "w") as f:
            json.dump({"runs": [{"argv": train_argv(
                cfg, manifest, valid, labels_path,
                ["--epochs", "1", "--parallel", "--device", "cuda", *extra],
                name=name), "out": os.path.join(work, name)}
                for name, extra in runs]}, f)
        _, secs = torchrun(work, nproc, [os.path.abspath(__file__),
                                         "--ddp-rank", spec],
                           f"pp_{nproc}_ranks")
        res[f"seconds_{nproc}_ranks"] = secs
        log(f"torchrun {nproc} ranks, runs {[n for n, _ in runs]}: "
            f"{secs:.1f} s")
    for name, nproc, extra in PP_RUNS:
        ranks = []
        for r in range(nproc):
            with open(os.path.join(work, f"{name}.r{r}.json")) as f:
                ranks.append(json.load(f))
        for rk in ranks:
            front = rk["stage"] == 0
            missing = [n for n in FRONT_KERNELS if front and (
                rk["launches"][n] < 1 or rk["step_launches"][n] < 1)]
            missing += [n for n in STACK_KERNELS
                        if rk["step_launches"][n] < 1]
            stray = [n for n in FRONT_KERNELS if not front and (
                rk["launches"][n] or rk["step_launches"][n])]
            if (missing or stray or rk["backend"] != "gloo"
                    or rk["opt_step"] != 2 or rk["transport"] != "host"):
                fail(f"{name} rank {rk['rank']} (stage {rk['stage']}): "
                     f"kernels not launched {missing}, launched off their "
                     f"stage {stray}, backend {rk['backend']}, hand-off "
                     f"{rk['transport']}, step {rk['opt_step']}")
        ck = flat_npz(os.path.join(work, "models", name, "epoch_1"))
        loss = ranks[0]["train_loss"]
        dp = max(float(np.abs(ck[k].astype(np.float64)
                              - ref_ck[k].astype(np.float64)).max())
                 for k in ref_ck if k.startswith("params::"))
        res[name] = {
            "train_s": [rk["train_s"] for rk in ranks], "train_loss": loss,
            "params_max_abs_vs_1_process": dp,
            "layout": ranks[0]["layout"],
            "step_ms": [rk["step_ms"] for rk in ranks],
            "peak_mem_mib": [rk["peak_mem_bytes"] / 2 ** 20
                             for rk in ranks],
            "handoffs_a_step": [rk["handoffs_a_step"] for rk in ranks],
            "handoff_MB_a_step": [rk["handoff_MB_a_step"] for rk in ranks],
            "handoff_ms_a_step": [rk["handoff_ms_a_step"] for rk in ranks]}
        counts[name] = [{k: (rk["launches"][k], rk["step_launches"][k])
                         for k in rk["launches"]} for rk in ranks]
        log(f"{nproc} ranks --parallel {' '.join(extra)} ({gpu}), "
            f"hand-off {ranks[0]['transport']}: the entry point "
            f"{ranks[0]['train_s']:.1f} s on rank 0; train loss "
            f"{loss:.6f} against the one-process {ref_loss:.6f}; parameters "
            f"{dp:.3g} from it (bound {2 * lr_sum:.3g}); " + "; ".join(
                f"rank {rk['rank']} (stage {rk['stage']}, data x pipe x "
                f"model {rk['layout']}): launches {rk['launches']} in the "
                f"run, {rk['step_launches']} in the {DDP_STEPS + 1} timed "
                f"steps at dropout 0.1, step {rk['step_ms']:.2f} ms, peak "
                f"{rk['peak_mem_bytes'] / 2 ** 20:.1f} MiB, "
                f"{rk['handoffs_a_step']:.0f} hand-offs a step of "
                f"{rk['handoff_MB_a_step']:.2f} MB in "
                f"{rk['handoff_ms_a_step']:.2f} ms (waits included)"
                for rk in ranks))
        if abs(loss - ref_loss) > DDP_LOSS_RTOL * abs(ref_loss):
            fail(f"{name}: train loss {loss} against the one-process "
                 f"{ref_loss} (rtol {DDP_LOSS_RTOL})")
        if dp > 2 * lr_sum * 1.01:
            fail(f"{name}: parameters moved {dp:.3g} from the one-process "
                 f"run's, beyond 2 * (lr1 + lr2) = {2 * lr_sum:.3g}")

    # the pipelined run's gathered checkpoint served by one process (test
    # never pipelines), against the one-process run's checkpoint
    for dtype in ("float32", "bfloat16"):
        serve = lambda base: greedy_strings(torch, serve_kernels, [
            "--continue-from", base, "--test-manifest-list", model.manifest,
            "--batch-size", str(B), "--device", str(dev), "--dtype",
            dtype])[0]
        hyps = serve(os.path.join(work, "models", "pp2", "epoch_1"))
        ref_hyps = serve(ref_base)
        flips = sum(a != b for h, r in zip(hyps, ref_hyps)
                    for a, b in zip(h, r))
        res["serve_pp2_" + dtype] = {
            "strings": len(hyps), "equal_to_one_process": sum(
                h == r for h, r in zip(hyps, ref_hyps)),
            "characters_differing": flips}
        log(f"test in one process on pp2's checkpoint --dtype {dtype}: "
            f"{res['serve_pp2_' + dtype]} against the one-process run's "
            f"checkpoint")
        if len(hyps) != B or (dtype == "float32" and hyps != ref_hyps):
            fail(f"pp2's checkpoint --dtype {dtype}: strings differ from "
                 f"the one-process run's: {list(zip(hyps, ref_hyps))[:3]}")
    return counts, res


# ---------------------------------------------------------------------------
# phase 12: --steps-per-dispatch K (CUDA graphs) and the Prefetcher
# ---------------------------------------------------------------------------

DISPATCH_K = 4
DISPATCH_STEPS = 8      # two groups of DISPATCH_K
DISPATCH_COST_STEPS = 24    # the timed runs: 24 single steps, 6 groups
# the mixes held graphed against eager: (name, config overrides, gate on)
DISPATCH_MIXES = (("default", {}, False), ("block2_gate", {}, True),
                  ("spec_augment_remat", dict(spec_augment=True, remat=True),
                   False),
                  ("emb_cnn_ctc", dict(feat_extractor="emb_cnn", loss="ctc"),
                   False),
                  ("grad_accum_2", dict(grad_accum=2), False),
                  ("float32", dict(dtype="float32"), False))


def same_bits(torch, a, b) -> bool:
    """Trees (dicts, lists, tensors) equal bit for bit."""
    from end2end_asr_tpu_torch.training.checkpoint import flatten_params
    fa, fb = flatten_params(a), flatten_params(b)
    return set(fa) == set(fb) and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


def dispatch_runs(torch, dev, cfg, params, state, batches, steps_k):
    """The same batches through `steps_k` K-step dispatches
    (training/steps.make_multi_train_step; K = 1: single steps) from the
    same weights and seeds: (losses, finite flags, data, opt, state,
    the runner or None, host ms a step (each dispatch between two
    synchronizes))."""
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                          to_device)
    from end2end_asr_tpu_torch.training.optimizer import init_opt_state
    from end2end_asr_tpu_torch.training.steps import (FlatParams,
                                                      make_multi_train_step,
                                                      make_train_step_impl)
    fp = FlatParams(params, dev)
    data, opt = fp.data, init_opt_state(cfg, fp.data)
    st = to_device(state or {}, dev)
    rng = DropoutRng(SEED, dev)
    step = make_train_step_impl(cfg, dims_from_config(cfg))
    multi = (make_multi_train_step(cfg, step, steps_k, dev)
             if steps_k > 1 else None)
    losses, finite, times = [], [], []
    T = batches[0][1]
    for g in range(0, len(batches), steps_k):
        group = [b[0] for b in batches[g:g + steps_k]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if multi is None:
            data, opt, st, m, _, _ = step(fp, data, opt, rng, *group[0], T,
                                          model_state=st)
            m = {k: v[None] for k, v in m.items()}
        else:
            data, opt, st, m, _, _ = multi(fp, data, opt, rng, group, T,
                                           model_state=st)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / len(group))
        losses += m["loss"].tolist()
        finite += m["finite"].tolist()
    return losses, finite, data, opt, st, multi, times


def dispatch_batches(torch, dev, cfg, manifest, label2id, n,
                     pcm_dtype=None):
    """n (tensors, bucket) of one shape from the manifest's batches,
    cycled."""
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import (AudioBatchLoader,
                                                   batch_tensors)
    loader = AudioBatchLoader(ManifestDataset([manifest], label2id), cfg)
    got = [(batch_tensors(b, dev), b.src_bucket) for b in loader]
    shape = lambda b: [tuple(t.shape) for t in b[0]] + [b[1]]
    got = [b for b in got if shape(b) == shape(got[0])]
    out = [got[i % len(got)] for i in range(n)]
    if pcm_dtype is not None:
        out = [((t[0].to(pcm_dtype) / 32768.0, *t[1:]), T) for t, T in out]
    return out


def phase_dispatch(torch, dev, work, labels_path, gpu):
    """12. --steps-per-dispatch K = 4 against K = 1 at the AiShell README
    width (batch 12, bf16, dropout 0.1, the 800-frame bucket): in each
    mix of DISPATCH_MIXES, 8 steps as single eager steps and as 2 replays
    of the K-step CUDA graph, from the same weights and seeds: losses,
    parameters, optimizer state and model state bit-equal; an infinite
    batch inside a group skips its own step only (--loss ctc); a gloo
    group refused; the trainer at K = 4 against K = 1 and with the
    Prefetcher against without it; the host ms a step, the device ms, the
    busy share and the launches a step at K = 1 and K = 4, the graphs
    captured and the memory they took."""
    import numpy as np
    import torch.distributed as dist
    from end2end_asr_tpu_torch.config import load_vocab
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import AudioBatchLoader
    from end2end_asr_tpu_torch.models.transformer import (init_params,
                                                          init_state)
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    from end2end_asr_tpu_torch.training.optimizer import init_opt_state
    from end2end_asr_tpu_torch.training.steps import (FlatParams,
                                                      make_multi_train_step,
                                                      make_train_step_impl)
    from end2end_asr_tpu_torch.training.trainer import Trainer
    from end2end_asr_tpu_torch.utils.profiling import RECORDER

    with open(labels_path, encoding="utf-8") as f:
        labels = json.load(f)
    label2id, id2label = load_vocab(labels_path)
    rs = np.random.RandomState(SEED + 12)
    # 4 batches of 12 in the 800-frame bucket, one target bucket
    manifest = make_corpus(work, labels, rs, n=4 * B, name="dispatch.csv",
                           text=lambda chars, r: "".join(
                               r.choice(chars, r.randint(12, 16))))
    out = {"k": DISPATCH_K, "gpu": gpu, "mixes": {}}
    t_phase = time.time()
    for name, kw, gate in DISPATCH_MIXES:
        cfg = aishell_config(**kw)
        params = init_params(cfg, len(label2id),
                             torch.Generator().manual_seed(SEED))
        batches = dispatch_batches(torch, dev, cfg, manifest, label2id,
                                   DISPATCH_STEPS)
        V.BLOCK2_ENABLED = gate
        try:
            one = dispatch_runs(torch, dev, cfg, params, init_state(cfg),
                                batches, 1)
            grp = dispatch_runs(torch, dev, cfg, params, init_state(cfg),
                                batches, DISPATCH_K)
        finally:
            V.BLOCK2_ENABLED = False
        equal = {"losses": one[0] == grp[0], "data": torch.equal(one[2],
                                                                 grp[2]),
                 "opt": same_bits(torch, one[3], grp[3]),
                 "state": same_bits(torch, one[4], grp[4])}
        runner = grp[5]
        counters = RECORDER.graphs_of(runner.tag)
        out["mixes"][name] = {
            "losses": grp[0], "equal": equal,
            "graphs": len(runner.graphs),
            "memory_mib": {str(k[0]): v["memory"] / 2 ** 20
                           for k, v in counters.items()},
            "captured_launches": {str(k[0]): v["launches"]
                                  for k, v in counters.items()},
            "replays": sum(v["replays"] for v in counters.values())}
        log(f"dispatch {name}: losses eager {one[0]} graphed {grp[0]}; "
            f"bit-equal {equal}; {len(runner.graphs)} graph(s), memory "
            f"{out['mixes'][name]['memory_mib']} MiB; captured launches "
            f"{out['mixes'][name]['captured_launches']} x "
            f"{out['mixes'][name]['replays']} replays")
        if not all(equal.values()) or not all(map(math.isfinite, grp[0])):
            fail(f"dispatch {name}: the graphed K = {DISPATCH_K} steps are "
                 f"not the eager steps bit for bit: {equal}")
        del one, grp, runner
        torch.cuda.empty_cache()
    log(f"dispatch mixes done in {time.time() - t_phase:.1f} s")

    # an infinite batch inside a group (--loss ctc; batch 1 of the group
    # has 30 copies of one character in every row: 61 CTC positions on 50)
    # skips its own step only, in both runs alike
    cfg = aishell_config(loss="ctc")
    params = init_params(cfg, len(label2id),
                         torch.Generator().manual_seed(SEED))
    batches = dispatch_batches(torch, dev, cfg, manifest, label2id,
                               DISPATCH_K)
    (pcm, n_frames, targets, lengths), T = batches[1]
    targets = torch.zeros_like(targets)
    targets[:, 0], targets[:, 1:31], targets[:, 31] = 1, 7, 2
    batches[1] = ((pcm, n_frames, targets, torch.full_like(lengths, 32)), T)
    one = dispatch_runs(torch, dev, cfg, params, {}, batches, 1)
    grp = dispatch_runs(torch, dev, cfg, params, {}, batches, DISPATCH_K)
    inf_skip = {"finite_eager": one[1], "finite_graphed": grp[1],
                "step_after_group": int(grp[3]["step"].item()),
                "equal": torch.equal(one[2], grp[2])
                and same_bits(torch, one[3], grp[3])}
    log(f"dispatch: an infinite batch at index 1 of a group: {inf_skip}")
    if (grp[1] != [True, False, True, True] or one[1] != grp[1]
            or inf_skip["step_after_group"] != DISPATCH_K - 1
            or not inf_skip["equal"]):
        fail(f"dispatch: the infinite batch inside a group: {inf_skip}")
    out["inf_skip"] = inf_skip
    del one, grp

    # the refusal: a gloo group on the card
    cfg = aishell_config()
    step = make_train_step_impl(cfg, dims_from_config(cfg))
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            make_multi_train_step(cfg, step, DISPATCH_K, dev)
            refusal = None
        except ValueError as e:
            refusal = str(e)
        finally:
            dist.destroy_process_group()
    log(f"dispatch: a gloo group on the card: {refusal}")
    if refusal is None or "NCCL" not in refusal:
        fail(f"dispatch: a gloo group was not refused: {refusal}")
    out["gloo_refusal"] = refusal

    # the trainer: K = 4 against K = 1 (a group of 4 and its drain), and
    # with the Prefetcher against without it; one epoch of 4 batches
    cfg = aishell_config(epochs=1, save_every=100,
                         save_folder=os.path.join(work, "dispatch_models"))
    runs = {}
    for tag, k, pf in (("k1_prefetch", 1, True), ("k1_plain", 1, False),
                       ("k4_prefetch", DISPATCH_K, True)):
        c = cfg.replace(steps_per_dispatch=k, name=tag)
        params = init_params(c, len(label2id),
                             torch.Generator().manual_seed(SEED))
        ds = ManifestDataset([manifest], label2id)
        t0 = time.time()
        res = Trainer(c, label2id, id2label, dev).train(
            params, None, AudioBatchLoader(ds, c), [], num_epochs=1,
            prefetch=pf)
        torch.cuda.synchronize()
        runs[tag] = (res, time.time() - t0)
    trainer = {tag: {"train_loss": r["metrics"]["train_loss"],
                     "opt_step": r["opt_step"], "s": t}
               for tag, (r, t) in runs.items()}
    ref = runs["k1_prefetch"][0]
    for tag in ("k1_plain", "k4_prefetch"):
        r = runs[tag][0]
        trainer[tag]["equal"] = (
            r["metrics"]["train_loss"] == ref["metrics"]["train_loss"]
            and r["opt_step"] == ref["opt_step"] == 4
            and same_bits(torch, r["params"], ref["params"])
            and same_bits(torch, r["opt_state"], ref["opt_state"]))
    log(f"dispatch trainer runs: {trainer}")
    if not (trainer["k1_plain"]["equal"] and trainer["k4_prefetch"]["equal"]):
        fail(f"dispatch: the trainer's runs differ: {trainer}")
    out["trainer"] = trainer
    del runs

    # what K = 1 and K = 4 cost: host ms a step (the median over the
    # dispatches after the first, which warms up, or captures), device
    # ms, busy share, launches a step (the profile of one dispatch: a
    # step, or a replay)
    cfg = aishell_config()
    params = init_params(cfg, len(label2id),
                         torch.Generator().manual_seed(SEED))
    batches = dispatch_batches(torch, dev, cfg, manifest, label2id,
                               DISPATCH_COST_STEPS)
    cost = {}
    for k in (1, DISPATCH_K):
        res = dispatch_runs(torch, dev, cfg, params, {}, batches, k)
        runner = res[5]
        fp = FlatParams(params, dev)
        data, opt = fp.data, init_opt_state(cfg, fp.data)
        rng = DropoutRng(SEED, dev)
        group, T = [b[0] for b in batches[:k]], batches[0][1]
        if runner is None:
            step = make_train_step_impl(cfg, dims_from_config(cfg))
            fn = lambda: step(fp, data, opt, rng, *group[0], T)
        else:
            fn = lambda: runner(fp, data, opt, rng, group, T)
        prof = profile(torch, fn, top=6)
        cost[k] = {"host_ms_a_step_median": statistics.median(res[6][1:]),
                   "host_ms_first_dispatch_a_step": res[6][0],
                   "host_ms_all": res[6],
                   "device_ms_a_step": (None if prof["device_ms"] is None
                                        else prof["device_ms"] / k),
                   "busy_share": prof["device_busy_share"],
                   "kernel_launches_a_step": prof["kernel_launches"] / k,
                   "graph_launches_a_step": 0 if runner is None else 1 / k}
        if runner is not None:
            counters = RECORDER.graphs_of(runner.tag)
            cost[k]["graphs"] = len(runner.graphs)
            cost[k]["memory_mib"] = sum(
                v["memory"] for v in counters.values()) / 2 ** 20
            cost[k]["captured_launches_a_step"] = {
                n: c / k for n, c in
                next(iter(counters.values()))["launches"].items()}
        del res, runner, fn
    log(f"dispatch cost (K = 1 and K = {DISPATCH_K}; {gpu}): "
        f"{json.dumps(cost)}")
    out["cost"] = cost
    out["s"] = time.time() - t_phase
    return out


# the layouts of phases 9-11 over NCCL, a card a rank: (name, ranks,
# flags), in the order they start (on the first free cards that fit)
NCCL_DISPATCH_RUNS = (
    ("pp2", 2, ["--mesh-pipe", "2"]),
    ("pp2_m4", 2, ["--mesh-pipe", "2", "--pipe-microbatches", "4"]),
    ("dp2_zero1", 2, ["--zero1"]), ("dp2_fsdp", 2, ["--fsdp"]),
    ("dp2", 2, []), ("tp2", 2, ["--mesh-model", "2"]),
    ("pp4_remat", 4, ["--mesh-pipe", "4", "--remat"]),
    ("pp2_tp2", 4, ["--mesh-pipe", "2", "--mesh-model", "2"]),
    ("dp2_pp2_zero1", 4, ["--mesh-data", "2", "--mesh-pipe", "2",
                          "--zero1"]),
    ("tp4_zero1", 4, ["--mesh-data", "2", "--mesh-model", "2", "--zero1"]))
NCCL_LOG_LINE = "backend nccl"
NCCL_RUN_TIMEOUT_S = 480    # a layout's torchrun: its three runs, timed
NCCL_TIMED = 3          # timed dispatches a rank after an untimed one
# a layout's runs, in this order in one group: (tag suffix, K, dropout,
# epochs of 4 batches); at K = 4 an epoch is one replay of the graph, so
# two epochs replay it twice (the first replay follows the capture)
NCCL_RUNS = (("k1", 1, 0.1, 2), (f"k{DISPATCH_K}", DISPATCH_K, 0.1, 2),
             ("k1_d0", 1, 0.0, 1))
# (b)'s gradient check: the dropout-0 run's gathered Adam first moments
# (4 steps of (1 - b1)-weighted gradients) against one process's, a leaf
# at a time, relative L2 with the leaf's norm floored at 1e-2 of the whole
# model's. bf16 kernels on other row counts, sums in other orders and each
# rank's gradient rounded to bf16 before the sum move a right gradient by
# ~1e-2 at most; a hand-off to the wrong peer or a sum left out moves a
# leaf's by ~1
NCCL_D0_MU_RTOL = 5e-2


def captured_counts(kernels, captured):
    """`kernels`' counts of a CUDA graph's captured launches
    (the tracer's graph counter "launches", by binding)."""
    from end2end_asr_tpu_torch.ops import cuda_lib
    saved = cuda_lib.launch_counts()
    cuda_lib.set_launch_counts(dict.fromkeys(saved, 0))
    cuda_lib.set_launch_counts(captured)
    out = kernel_counts(kernels)
    cuda_lib.set_launch_counts(saved)
    return out


def mu_rel_l2(got, ref):
    """(b)'s gradient check: the relative L2 distance of each Adam
    first-moment leaf (``opt::mu::`` of two flat checkpoints), the leaf's
    norm floored at 1e-2 of the whole model's."""
    import numpy as np
    keys = [k for k in ref if k.startswith("opt::mu::")]
    norm = lambda a: float(np.linalg.norm(np.asarray(a, np.float64)))
    floor = 1e-2 * math.sqrt(sum(norm(ref[k]) ** 2 for k in keys))
    return {k: norm(np.asarray(got[k], np.float64) - ref[k])
            / max(norm(ref[k]), floor) for k in keys}


def nccl_rank(spec_path):
    """One rank of a `--nccl-dispatch` layout (`chip_smoke.py --nccl-rank
    SPEC`, started by torch.distributed.run, a card a rank): the train
    entry point with each of the spec's runs' argv in turn, in one group
    (the backend, launches, peak memory and seconds of each), then the
    train step of the first run's parameters on this rank's slice of the
    first batch at K = 1 and at K = DISPATCH_K: NCCL_TIMED dispatches
    after an untimed one (at K > 1 the one that captures), one more
    profiled; the step ms (a dispatch's / K), the profiled kernels' summed
    time a step and over the wall (NCCL's kernels count while they wait
    for a peer, and overlap the compute on their own stream, so it is no
    busy share), the hand-offs a step, the launches a step (at K > 1 the
    graph's captured ones), the graph's pool and the timing's wall-clock
    window go to <out>.r<rank>.json."""
    import torch
    from end2end_asr_tpu_torch import train as port_train
    from end2end_asr_tpu_torch.config import config_from_args, load_vocab
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import (AudioBatchLoader,
                                                   batch_tensors)
    from end2end_asr_tpu_torch.parallel import mesh, pp
    from end2end_asr_tpu_torch.test import split_device_arg
    from end2end_asr_tpu_torch.training.steps import make_multi_train_step
    from end2end_asr_tpu_torch.utils.profiling import RECORDER
    with open(spec_path) as f:
        spec = json.load(f)
    dev = mesh.rank_device(torch.device("cuda"))
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.maybe_initialize_distributed(dev)
    kernels = train_kernel_table()
    out = {"rank": mesh.rank(), "device": str(dev),
           "backend": torch.distributed.get_backend(), "runs": {}}
    params = None
    for run in spec["runs"]:
        reset_kernels(kernels)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        res = port_train.main(run["argv"])
        torch.cuda.synchronize()
        out["runs"][run["tag"]] = {
            "launches": kernel_counts(kernels),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "train_s": time.time() - t0, "opt_step": res["opt_step"]}
        params = params or res["params"]
        del res
    out.update(stage=mesh.pipe_rank(), transport=mesh.TRANSPORT, timing={})
    cfg = config_from_args(split_device_arg(spec["runs"][0]["argv"])[1])
    label2id, _ = load_vocab(cfg.labels_path)
    batch = next(iter(AudioBatchLoader(
        ManifestDataset(list(cfg.train_manifest_list), label2id), cfg,
        process_index=mesh.data_rank(), process_count=mesh.data_size())))
    fp, data, opt, step, rng = rank_step(cfg, params, dev)
    tensors = batch_tensors(batch, dev)
    out["timed"] = [time.time()]
    for k in (1, DISPATCH_K):
        runner = make_multi_train_step(cfg, step, k, dev) if k > 1 else None
        one = ((lambda: step(fp, data, opt, rng, *tensors,
                             batch.src_bucket)) if runner is None else
               (lambda: runner(fp, data, opt, rng, [tensors] * k,
                               batch.src_bucket)))
        reset_kernels(kernels)
        pp.reset_handoffs()
        one()
        ms, _ = host_ms(torch, one, NCCL_TIMED)
        t = {"step_ms": ms / k}
        if runner is None:
            t["handoffs_a_step"] = pp.HANDOFFS["count"] / (1 + NCCL_TIMED)
            t["launches_a_step"] = {n: c / (1 + NCCL_TIMED) for n, c in
                                    kernel_counts(kernels).items()}
        else:
            graph, = RECORDER.graphs_of(runner.tag).values()
            t["handoffs_a_step"] = graph["handoffs"]["count"] / k
            t["launches_a_step"] = {n: c / k for n, c in captured_counts(
                kernels, graph["launches"]).items()}
            t["graph_pool_mib"] = graph["memory"] / 2 ** 20
        prof = profile(torch, one, top=4)
        t["kernel_time_over_wall"] = prof["device_busy_share"]
        t["kernel_ms_a_step"] = (None if prof["device_ms"] is None
                                 else prof["device_ms"] / k)
        if runner is not None:
            runner.close()
        out["timing"][k] = t
    out["timed"].append(time.time())
    with open(f"{spec['out']}.r{mesh.rank()}.json", "w") as f:
        json.dump(out, f)
    mesh.shutdown()


def phase_nccl_dispatch(torch, gpu):
    """`python3 chip_smoke.py --nccl-dispatch`, on a host of 2 or more
    cards (not part of the default run, which needs one): every layout of
    phases 9-11 (NCCL_DISPATCH_RUNS: data parallelism plain, --zero1 and
    --fsdp, tensor parallelism, the 2 x 2 --zero1 layout and the four
    pipelines) through the train entry point at --parallel, one torchrun a
    layout, a card a rank (this script's --nccl-rank mode around it), on
    phase 12's corpus (4 batches of 12, bf16): two epochs at
    --steps-per-dispatch 1 and 4 at dropout 0.1, then one epoch at K = 1
    at dropout 0, one after the other in the layout's group; the layouts
    share the host's cards, as many at once as fit, beside one process's
    run at dropout 0. (a) The K = 4 run's gathered checkpoint must equal
    the K = 1 run's bit for bit after each epoch (each replay of its
    graph); (b) the dropout-0 run's loss, gathered parameters and Adam
    first moments (its gradients) must be the one-process run's within
    phase 9's rules and NCCL_D0_MU_RTOL; (c) every log must name NCCL;
    (d) every torchrun must end within NCCL_RUN_TIMEOUT_S. Each rank's
    step ms at K = 1 and 4 (host clock, a dispatch's median / K), its
    kernels' time over the wall, peak memory, hand-offs a step and its
    stage's kernels (at K = 4 the graph's captured launches) are printed,
    and the jobs that ran beside a layout's timing (they share the host's
    CPU). The 4-rank layouts need 4 cards: with fewer they are reported
    as not run, by name, and not counted as passed."""
    import numpy as np
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.training.optimizer import noam_rate
    from end2end_asr_tpu_torch.training.steps import noam_config_from
    n = torch.cuda.device_count()
    if n < 2:
        fail(f"--nccl-dispatch needs 2 or more cards, found {n}")
    not_run = [r[0] for r in NCCL_DISPATCH_RUNS if r[1] > n]
    layouts = [r for r in NCCL_DISPATCH_RUNS if r[1] <= n]
    phase_build(cuda_lib)
    labels_path = os.path.abspath(os.path.join("data", "labels",
                                               "aishell_labels.json"))
    with open(labels_path, encoding="utf-8") as f:
        labels = json.load(f)
    rs = np.random.RandomState(SEED + 12)
    out = {"gpu": gpu, "cards": n, "not_run": not_run, "layouts": {}}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        manifest = make_corpus(work, labels, rs, n=4 * B,
                               name="dispatch.csv",
                               text=lambda chars, r: "".join(
                                   r.choice(chars, r.randint(12, 16))))
        # no validation: the checks read the checkpoints and train losses
        argv = lambda tag, k, drop, epochs: train_argv(
            aishell_config(dropout=drop), manifest, [], labels_path,
            ["--epochs", str(epochs), "--steps-per-dispatch", str(k)],
            name=tag)
        # the one-process run first, then the layouts, each started on
        # the first free cards that fit it
        jobs = [("one", 1, [sys.executable, "-m",
                            "end2end_asr_tpu_torch.train",
                            *argv("one", 1, 0.0, 1), "--device", "cuda"])]
        for name, nproc, extra in layouts:
            spec = os.path.join(work, name + ".json")
            with open(spec, "w") as f:
                json.dump({"runs": [
                    {"tag": f"{name}_{sfx}", "argv": argv(
                        f"{name}_{sfx}", k, drop, epochs) + [
                        "--parallel", "--device", "cuda", *extra]}
                    for sfx, k, drop, epochs in NCCL_RUNS],
                    "out": os.path.join(work, name)}, f)
            jobs.append((name, nproc, [
                sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc_per_node", str(nproc),
                os.path.abspath(__file__), "--nccl-rank", spec]))

        def ck(tag, epoch=1):
            return flat_npz(os.path.join(work, "models", tag,
                                         f"epoch_{epoch}"))

        def train_loss(tag):
            with open(os.path.join(work, "models", tag, "epoch_1.json"),
                      encoding="utf-8") as f:
                return json.load(f)["metrics"]["train_loss"]

        lr_sum = sum(float(noam_rate(torch.tensor(st), noam_config_from(
            aishell_config()))) for st in range(1, 5))
        k4 = f"k{DISPATCH_K}"
        epochs = {f"{name}_{sfx}": e for name, _, _ in layouts
                  for sfx, _, _, e in NCCL_RUNS}
        bad = []

        def check(name, nproc, extra):
            """A layout's checks (a)-(c) and its ranks' numbers, logged as
            soon as it and the one-process run have ended."""
            ref_ck, ref_loss = ck("one"), train_loss("one")
            tags = {sfx: f"{name}_{sfx}" for sfx, _, _, _ in NCCL_RUNS}
            nccl = {}
            for t in tags.values():
                with open(os.path.join(work, "log", t),
                          encoding="utf-8") as f:
                    nccl[t] = NCCL_LOG_LINE in f.read()
            same = []           # (a) after each epoch: each replay
            for e in range(1, epochs[tags["k1"]] + 1):
                a, b = ck(tags["k1"], e), ck(tags[k4], e)
                same.append(set(a) == set(b) and all(
                    np.array_equal(a[key], b[key]) for key in a))
            d0 = ck(tags["k1_d0"])
            dp = max(float(np.abs(d0[key].astype(np.float64)
                                  - ref_ck[key].astype(np.float64)).max())
                     for key in ref_ck if key.startswith("params::"))
            mu = mu_rel_l2(d0, ref_ck)
            mu_worst = max(mu, key=mu.get)
            loss = train_loss(tags["k1_d0"])
            ranks = []
            for r in range(nproc):
                with open(os.path.join(work, f"{name}.r{r}.json")) as f:
                    ranks.append(json.load(f))
            w0, w1 = ranks[0]["timed"]
            beside = sorted(t for t, (s0, s1) in spans.items() if t != name
                            and s0 < w1 and (s1 is None or s1 > w0))
            timing = lambda key: {kk: [rk["timing"][str(kk)][key]
                                       for rk in ranks]
                                  for kk in (1, DISPATCH_K)}
            rep = {"ranks": nproc, "extra": extra, "seconds": seconds[name],
                   "k4_checkpoint_bit_equal_k1_by_epoch": same,
                   "logs_name_nccl": all(nccl.values()),
                   "d0_train_loss": loss, "one_process_loss": ref_loss,
                   "d0_params_max_abs_vs_1_process": dp,
                   "params_bound": 2 * lr_sum,
                   "d0_mu_rel_l2_max": [mu_worst, mu[mu_worst]],
                   "backend": [rk["backend"] for rk in ranks],
                   "stages": [rk["stage"] for rk in ranks],
                   "transport": ranks[0]["transport"],
                   "opt_step": {t: [rk["runs"][t]["opt_step"]
                                    for rk in ranks] for t in tags.values()},
                   "train_s": {t: [rk["runs"][t]["train_s"] for rk in ranks]
                               for t in tags.values()},
                   "peak_mem_mib": {t: [rk["runs"][t]["peak_mem_bytes"]
                                        / 2 ** 20 for rk in ranks]
                                    for t in tags.values()},
                   "step_ms": timing("step_ms"),
                   "timed_beside": beside,
                   "kernel_time_over_wall": timing("kernel_time_over_wall"),
                   "kernel_ms_a_step": timing("kernel_ms_a_step"),
                   "handoffs_a_step": timing("handoffs_a_step"),
                   "graph_pool_mib": [rk["timing"][str(DISPATCH_K)]
                                      ["graph_pool_mib"] for rk in ranks],
                   "launches_a_step": timing("launches_a_step")}
            out["layouts"][name] = rep
            log(f"nccl dispatch {name} ({nproc} ranks {' '.join(extra)}; "
                f"{gpu}): {json.dumps(rep)}")
            # each stage launches its own kernels: stage 0 the front end's,
            # every stage the attention's (at K = 4 in the graph)
            missing = [(rk["rank"], kk, kn) for rk in ranks
                       for kk in (1, DISPATCH_K)
                       for kn in STACK_KERNELS + (
                           FRONT_KERNELS if rk["stage"] == 0 else ())
                       if rk["timing"][str(kk)]["launches_a_step"][kn] <= 0]
            steps = {t: set(v) for t, v in rep["opt_step"].items()}
            if not all(same):
                bad.append(f"{name}: the K = {DISPATCH_K} checkpoint differs "
                           f"from the K = 1 checkpoint after epochs {same}")
            if not all(nccl.values()) or set(rep["backend"]) != {"nccl"}:
                bad.append(f"{name}: not NCCL: logs {nccl}, backends "
                           f"{rep['backend']}")
            if abs(loss - ref_loss) > DDP_LOSS_RTOL * abs(ref_loss):
                bad.append(f"{name}: the dropout-0 loss {loss} against the "
                           f"one-process {ref_loss} (rtol {DDP_LOSS_RTOL})")
            if dp > 2 * lr_sum * 1.01:
                bad.append(f"{name}: the dropout-0 parameters moved {dp:.3g} "
                           f"from the one-process run's, beyond 2 * (lr1 + "
                           f"... + lr4) = {2 * lr_sum:.3g}")
            if mu[mu_worst] > NCCL_D0_MU_RTOL:
                bad.append(f"{name}: the dropout-0 gradient (Adam's first "
                           f"moment) {mu_worst} {mu[mu_worst]:.3g} from the "
                           f"one-process run's (rtol {NCCL_D0_MU_RTOL})")
            if missing or any(steps[t] != {4 * epochs[t]} for t in steps):
                bad.append(f"{name}: (rank, K, kernel) not launched "
                           f"{missing}; optimizer steps {steps}")

        free, running, seconds = list(range(n)), [], {}
        spans = {}          # a job's wall-clock [start, end or None]
        checked = set()
        while jobs or running:
            for job in [j for j in jobs]:
                tag, nproc, cmd = job
                if nproc > len(free):
                    continue
                jobs.remove(job)
                cards = [free.pop(0) for _ in range(nproc)]
                log_f = open(os.path.join(work, tag + ".out"), "w")
                # a process group of its own: a kill reaches torchrun's
                # ranks
                proc = subprocess.Popen(
                    cmd, cwd=work, stdout=log_f, stderr=subprocess.STDOUT,
                    start_new_session=True, env=dict(
                        env, CUDA_VISIBLE_DEVICES=",".join(map(str, cards))))
                running.append((tag, proc, log_f, cards, time.time()))
                spans[tag] = [time.time(), None]
            time.sleep(1)
            for entry in list(running):
                tag, proc, log_f, cards, t0 = entry
                rc = proc.poll()
                if rc is None and time.time() - t0 > NCCL_RUN_TIMEOUT_S:
                    os.killpg(proc.pid, signal.SIGKILL)
                    rc = f"killed at {NCCL_RUN_TIMEOUT_S} s ({proc.wait()})"
                if rc is None:
                    continue
                running.remove(entry)
                free = sorted(free + cards)
                log_f.close()
                if rc != 0:
                    for _, p, _, _, _ in running:
                        os.killpg(p.pid, signal.SIGKILL)
                        p.wait()
                    with open(os.path.join(work, tag + ".out")) as f:
                        fail(f"{tag}: exited {rc}:\n{f.read()[-6000:]}")
                seconds[tag] = time.time() - t0
                spans[tag][1] = time.time()
                log(f"nccl dispatch {tag} ({len(cards)} cards {cards}): "
                    f"exit 0 in {seconds[tag]:.1f} s")
                if "one" in seconds:
                    for lay in layouts:
                        if lay[0] in seconds and lay[0] not in checked:
                            checked.add(lay[0])
                            check(*lay)

    out["s"] = time.time() - t_phase
    for name in not_run:
        log(f"nccl dispatch {name}: not run ({n} cards, needs 4)")
    if bad:
        fail("nccl dispatch: " + "; ".join(bad))
    return out


def phase_probe(torch):
    """The streaming probe through its entry point (its four lines go to
    the standard output); returns its kernels' launch counts."""
    from end2end_asr_tpu_torch.tools import probe_stream as PS
    PS.reset_launches()
    PS.main([])
    torch.cuda.synchronize()
    c = {"stream_copy": PS.copy_launches(), "stream_adam": PS.adam_launches()}
    log(f"probe: launches {c}")
    if min(c.values()) < 1:
        fail(f"probe: kernels not launched: {c}")
    return c


def profile(torch, fn, top=6, sums=(ATTN_FWD_KERNEL_NAME, ATTN_BWD_KERNEL_NAME,
                                   FWD_KERNEL_NAME, "pool_bwd",
                                   FWD2_KERNEL_NAME, BWD2_KERNEL_NAME,
                                   BWD2_PREFIX)):
    """One warm call of fn under torch.profiler: wall ms, summed device
    time of its kernels, their share of the wall time (the device's busy
    share; the rest is idle, waiting on the host), launches, the kernels
    with the most device time, and the device ms and launches of the
    kernels whose names hold each of `sums`."""
    from end2end_asr_tpu_torch.tools import probe_lib as PL
    fn()
    with PL.profiled(torch, cpu=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = PL.device_events(torch, prof)
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
           "top": [[n[:60], ms] for n, ms in heavy],
           "sums": {p: {"device_ms": sum(ms for n, ms in by_name.items()
                                         if p in n),
                        "launches": sum(p in e.name for e in kernels)}
                    for p in sums}}
    log(f"profile: {json.dumps(out)}")
    return out


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if sys.argv[1:2] == ["--ddp-rank"]:      # a rank of phase 9
        return ddp_rank(sys.argv[2])
    if sys.argv[1:2] == ["--nccl-rank"]:     # a rank of --nccl-dispatch
        return nccl_rank(sys.argv[2])
    dispatch_only = sys.argv[1:2] == ["--dispatch-only"]
    if sys.argv[1:2] == ["--nccl-dispatch"]:
        print(json.dumps(phase_nccl_dispatch(torch, gpu_line())))
        return
    try:
        from end2end_asr_tpu_torch.ops import (attention_fused, cuda_lib,
                                               pool_vjp, stft, vgg_fused)
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
    labels_path = os.path.abspath(os.path.join("data", "labels",
                                               "aishell_labels.json"))
    if dispatch_only:
        ctc_entries = check_ctc(torch, dev)
        adam_entry = check_adam(torch, dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            print(json.dumps({"ctc": ctc_entries, "adam": adam_entry,
                              "dispatch": phase_dispatch(
                                  torch, dev, work, labels_path, gpu)}))
        return
    entries = [*check_stft(torch, dev), check_vgg(torch, dev),
               check_vgg_bwd(torch, dev), *check_attention(torch, dev),
               *check_attention_f32(torch, dev), check_pool_bwd(torch, dev),
               *check_vgg2(torch, dev), *check_stream(torch, dev),
               *check_ctc(torch, dev), check_adam(torch, dev)]
    log(f"kernel checks done at {time.time() - t0:.1f} s")
    # the serving path's n_fft (320) takes the FFT kernel: its own count
    fft_count = types.SimpleNamespace(
        launches=lambda: stft.FFT.launches,
        reset_launches=stft.reset_launches)
    kernels = {"stft_logmag": fft_count, "vgg_block1_fwd": vgg_fused}
    AF = attention_fused
    V = vgg_fused
    train_kernels = train_kernel_table()
    f32_kernels = dict(
        train_kernels,
        attn_fwd_f32=(AF.reset_launches, lambda: AF.FWD_F32.launches),
        attn_bwd_f32=(AF.reset_launches, lambda: AF.BWD_F32.launches))
    from end2end_asr_tpu_torch.ops import ctc as CT
    ctc_kernels = dict(train_kernels,
                       ctc_fwd=(CT.reset_launches, lambda: CT.FWD.launches),
                       ctc_bwd=(CT.reset_launches, lambda: CT.BWD.launches))
    gate_kernels = dict(train_kernels,
                        vgg_block2_fwd=(V.reset_launches2, V.launches2),
                        vgg_block2_bwd=(V.reset_launches2, V.bwd2_launches))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        runs, serve, model = phase_serve(torch, dev, kernels, work)
        log(f"serving done at {time.time() - t0:.1f} s")
        train_counts, f32_counts, manifest, valid, train = phase_train(
            torch, dev, train_kernels, work, labels_path,
            f32_kernels=f32_kernels)
        log(f"training done at {time.time() - t0:.1f} s")
        gate_serve, gate_train, gate = phase_gate_on(
            torch, dev, gate_kernels, work, labels_path,
            os.path.join(work, "model"), os.path.join(work, "manifest.csv"),
            manifest, valid)
        log(f"gate on done at {time.time() - t0:.1f} s; step "
            f"{gate['train_step_ms']:.2f} ms and "
            f"{gate['profile_step']['kernel_launches']} launches against "
            f"{train['train_step_ms']:.2f} ms and "
            f"{train['profile_step']['kernel_launches']} with the gate off; "
            f"with --spec-augment --remat "
            f"{gate['spec_augment_remat_step_ms']:.2f} ms and "
            f"{gate['spec_augment_remat_profile_step']['kernel_launches']}")
        ctc = phase_ctc_embcnn(torch, dev, ctc_kernels, work, labels_path)
        log(f"ctc / emb_cnn done at {time.time() - t0:.1f} s")
        options = phase_serve_options(torch, dev, kernels, work, model,
                                      serve, [model.manifest, manifest,
                                              valid])
        log(f"serve options done at {time.time() - t0:.1f} s")
        augment_counts, augment = phase_augment_multi(
            torch, dev, train_kernels, kernels, work, labels_path, model,
            manifest, valid, train)
        log(f"augmented joint training and the checkpoint tools done at "
            f"{time.time() - t0:.1f} s")
        ddp_counts, ddp = phase_ddp(torch, dev, train_kernels, kernels,
                                    work, labels_path, model, manifest,
                                    valid, gpu)
        log(f"data parallelism done at {time.time() - t0:.1f} s")
        tp_counts, tpar = phase_tp(torch, dev, kernels, work, labels_path,
                                   model, manifest, valid, gpu)
        lr_counts, tpar["lowrank"] = phase_tp_lowrank(
            torch, dev, kernels, work, labels_path, model, manifest, valid,
            gpu)
        tp_counts.update(lr_counts)
        log(f"tensor and sequence parallelism done at "
            f"{time.time() - t0:.1f} s")
        pp_counts, ppar = phase_pp(torch, dev, kernels, work, labels_path,
                                   model, manifest, valid, gpu)
        log(f"pipeline parallelism done at {time.time() - t0:.1f} s")
        dispatch = phase_dispatch(torch, dev, work, labels_path, gpu)
        log(f"steps per dispatch done at {time.time() - t0:.1f} s")
    probe_counts = phase_probe(torch)
    for e in entries:
        # each path was driven with the counts set to 0 just before it: the
        # training run for the kernels of the default path (the serving
        # kernels also keep their serving counts), the gate-on training run
        # for block 2, the probe's entry point for the streaming kernels
        e["launches"] = train_counts.get(e["name"], 0)
        if e["name"] in runs["greedy"]:
            e["launches_serve_greedy"] = runs["greedy"][e["name"]]
            e["launches_serve_beam8"] = runs["beam8"][e["name"]]
            for path, counts in options["launches"].items():
                e[f"launches_{path}"] = counts[e["name"]]
        if e["name"] in ("vgg_block2_fwd", "vgg_block2_bwd"):
            e["launches"] = gate_train[e["name"]]
            e["launches_serve_greedy"] = gate_serve[e["name"]]
        if e["name"] in augment_counts:
            e["launches_augment_multi"] = augment_counts[e["name"]]
        if e["name"] in ddp_counts["ddp"][0]:
            # per rank: (the dropout-0 run of 2 steps, the DDP_STEPS + 1
            # timed steps at dropout 0.1)
            for run, ranks in ddp_counts.items():
                e[f"launches_{run}_2_ranks"] = [r[e["name"]] for r in ranks]
            # phases 10-11, per rank: (the dropout-0 run, the timed steps)
            for run, ranks in {**tp_counts, **pp_counts}.items():
                e[f"launches_{run}"] = [r[e["name"]] for r in ranks]
        if e["name"] in probe_counts:
            e["launches"] = probe_counts[e["name"]]
        if e["name"] in ("attn_fwd_f32", "attn_bwd_f32"):
            e["launches"] = f32_counts[e["name"]]
            e["launches_note"] = "the --dtype float32 training run (2 steps)"
        if e["name"] == "stft_logmag_dft":
            e["launches_note"] = ("no path at n_fft 320; phase 2 launched "
                                  "it at n_fft 320 and 322")
        if e["name"] == "dropout_bits":
            e["note"] = "test hook of attn_fwd/attn_bwd; not on the path"
        if e["name"] in ("ctc_fwd", "ctc_bwd"):
            e["launches"] = ctc["launches"][e["name"]]
            e["launches_note"] = ("phase 6's train run (--loss ctc, 6 "
                                  "steps and the valid passes)")
    log(f"serving times: {serve}; training: {train}; gate on: {gate}; "
        f"ctc / emb_cnn: {ctc}; serve options: {options}; augmented joint "
        f"training and tools: {augment}; data parallelism: {ddp}; tensor "
        f"and sequence parallelism: {tpar}; pipeline parallelism: {ppar}; "
        f"steps per dispatch: {dispatch}; total {time.time() - t0:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": entries, "serve": serve, "train": train,
                      "gate_on": gate, "ctc_embcnn": ctc,
                      "serve_options": options, "augment_multi": augment,
                      "data_parallel": ddp, "tensor_parallel": tpar,
                      "pipeline_parallel": ppar, "dispatch": dispatch,
                      "total_s": time.time() - t0, "gpu": gpu}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
