"""The default train step on the card: launches, device time and the copy
kernels around the attention and the block-2 pool.

    python -m end2end_asr_tpu_torch.tools.probe_step [--block2]
        [--dtype bfloat16|float32]
    PYTHONPATH=<an earlier checkout> python3 \\
        end2end_asr_tpu_torch/tools/probe_step.py       # that package's step

Builds the AiShell README model (vgg_cnn, 4 layers, 8 heads, dim 512,
dim_inner 2048, the 4364 AiShell ids; bf16 over f32 master weights,
dropout 0.1, label smoothing 0.1) with weights from a seed, one synthetic
batch of 12 utterances of 800 frames with 50 target columns (51 decoder
positions: the train cell of PERF.md §4), and times its train step: the
median over STEPS steps, each ending in a synchronize. Then one step
under torch.profiler: its kernel launches, device time and busy share,
the copy kernels by name, and what runs inside each attention forward
(models/layers.mha's kernel call and reshape of its output, the tracer's
site `layers.ATTENTION_FORWARD`, whose profiler range `traced` turns
on), each attention
backward node and each max-pool backward node, with the memory formats
of the pool's y, g and dy, and the launches and device time of the
block-1 and block-2 forwards' and backwards' kernels (`BLOCK1_FWD`,
`BLOCK1_BWD`, `BLOCK2_FWD`, `BLOCK2_BWD`) with their shares of the
step's device time. Then one more step between the allocator's counters
(`step_memory`): what is allocated before it (weights, optimizer state,
the gradient buffer), the most allocated and the most reserved during
it. ``--block2`` sets
``ops.vgg_fused.BLOCK2_ENABLED`` (as a test does) before the step is
built, so the fused block 2 runs; ``--dtype float32`` builds the step at
compute type f32 with TF32 off (as ``train --dtype float32`` runs it), so
the f32 kernels' entries run. It
measures whichever package ``end2end_asr_tpu_torch`` resolves to, so an
earlier commit unpacked into another directory is measured by putting
that directory first on PYTHONPATH (a commit that has the tracer's
sites, utils/profiling.py). One JSON line, with the card's name
and power limit. Needs a CUDA card; imports nothing at import time that
needs one.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time

SEED = 1234
STEPS = 10
B, FRAMES, TARGET_COLUMNS = 12, 800, 50
ATTN_FWD_RANGE = "probe_step: attention forward"
# autograd's nodes of the port's two Functions
ATTN_BWD_NODE, POOL_BWD_NODE = "FlashMhaTrainBackward", "MaxPool2Backward"
# the block-1 and block-2 kernels (csrc/vgg_block{1,2}{,_f32}.cu): every
# kernel of a backward carries the second prefix, a forward's the first
BLOCK1_FWD, BLOCK1_BWD = "vgg_block1_fwd", "vgg_block1_bwd"
BLOCK2_FWD, BLOCK2_BWD = "vgg_block2_fwd", "vgg_block2_bwd"


def is_copy(name: str) -> bool:
    """PyTorch's layout and dtype copies (copy_, contiguous, clone)."""
    n = name.lower()
    return "copy" in n and "cat" not in n


def memory_format(t) -> str:
    import torch
    nchw = t.is_contiguous()
    nhwc = t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
    return ("both" if nchw and nhwc else "nchw" if nchw
            else "channels_last" if nhwc else "strided")


@contextlib.contextmanager
def traced(formats: list):
    """Turns on the tracer's profiler range around each attention forward
    and the reshape of its output (models/layers.ATTENTION_FORWARD, named
    ATTN_FWD_RANGE), and records the memory formats of each pool
    backward's y, g and dy into `formats`. The values are the same as
    without it."""
    from end2end_asr_tpu_torch.models import layers as TL
    from end2end_asr_tpu_torch.ops import pool_vjp as PV
    from end2end_asr_tpu_torch.utils.profiling import RECORDER
    pool = PV.pool_bwd

    def pool_bwd(y, g):
        dy = pool(y, g)
        formats.append({"y": memory_format(y), "g": memory_format(g),
                        "dy": memory_format(dy)})
        return dy

    PV.pool_bwd = pool_bwd
    try:
        with RECORDER.ranges_on(**{TL.ATTENTION_FORWARD: ATTN_FWD_RANGE}):
            yield
    finally:
        PV.pool_bwd = pool


def _kernels_under(events, key: str):
    """[[(kernel name, device us)]] for each top-most CPU event whose name
    holds `key`: the kernels it and the events below it launched."""
    def collect(e):
        return [(k.name, k.duration) for k in e.kernels] + [
            n for c in e.cpu_children for n in collect(c)]

    def outer(e):
        p = e.cpu_parent
        while p is not None:
            if key in p.name:
                return False
            p = p.cpu_parent
        return True
    return [collect(e) for e in events
            if e.device_type.name == "CPU" and key in e.name and outer(e)]


def report(torch, prof, wall_ms: float, formats: list) -> dict:
    """What one profiled step shows (see the module's docstring)."""
    events = prof.events()
    # the record_function range also shows on the device's timeline, as
    # a user annotation spanning its kernels: not a kernel
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != ATTN_FWD_RANGE]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    dev_ms = sum(by_name.values()) / 1e3 if kernels else None
    copies = {}
    for e in kernels:
        if is_copy(e.name):
            copies[e.name[:100]] = copies.get(e.name[:100], 0) + 1

    def group(key):
        calls = _kernels_under(events, key)
        return {"calls": len(calls),
                "kernels_per_call": sorted({len(c) for c in calls}),
                "copy_kernels": sum(is_copy(n) for c in calls for n, _ in c),
                "device_ms": sum(us for c in calls for _, us in c) / 1e3,
                "names": sorted({n[:60] for c in calls for n, _ in c})}
    def by_prefix(prefix):
        ms = [e.time_range.elapsed_us() / 1e3 for e in kernels
              if prefix in e.name]
        return {"launches": len(ms), "device_ms": sum(ms),
                "share": sum(ms) / dev_ms if kernels else None}
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms if kernels else None,
            "kernel_launches": len(kernels),
            "copy_kernels": sum(copies.values()), "copies_by_name": copies,
            "attention_forward": group(ATTN_FWD_RANGE),
            "attention_backward": group(ATTN_BWD_NODE),
            "pool_backward": group(POOL_BWD_NODE),
            "pool_formats": formats,
            "block1_forward": by_prefix(BLOCK1_FWD),
            "block1_backward": by_prefix(BLOCK1_BWD),
            "block2_forward": by_prefix(BLOCK2_FWD),
            "block2_backward": by_prefix(BLOCK2_BWD),
            "top": [[n[:60], ms / 1e3] for n, ms in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:8]]}


def profile_step(torch, one) -> dict:
    """One warm call of `one` (a train step) under the profiler, traced."""
    from torch.profiler import ProfilerActivity, profile
    formats = []
    with traced(formats):
        one()
        torch.cuda.synchronize()
        formats.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    return report(torch, prof, wall, formats)


def step_memory(torch, one) -> dict:
    """MB allocated before one warm call of `one` and the peaks allocated
    and reserved by PyTorch's caching allocator during it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    one()
    torch.cuda.synchronize()
    mb = 2.0 ** -20
    return {"allocated_before_mb": before * mb,
            "peak_allocated_mb": torch.cuda.max_memory_allocated() * mb,
            "peak_reserved_mb": torch.cuda.max_memory_reserved() * mb}


def default_step(torch, dev, dtype="bfloat16"):
    """The train cell's step on one synthetic batch at compute type
    `dtype`: a function of no arguments that runs it once."""
    import numpy as np
    import end2end_asr_tpu_torch as pkg
    from end2end_asr_tpu_torch.config import Config, load_vocab
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                          init_params)
    from end2end_asr_tpu_torch.training.optimizer import init_opt_state
    from end2end_asr_tpu_torch.training.steps import (FlatParams,
                                                      make_train_step_impl)
    cfg = Config(feat_extractor="vgg_cnn", num_layers=4, num_heads=8,
                 dim_model=512, dim_key=64, dim_value=64, dim_inner=2048,
                 dim_emb=512, batch_size=B, label_smoothing=0.1,
                 dropout=0.1, k_lr=1.0, min_lr=1e-6, warmup=4000,
                 dtype=dtype, seed=SEED)
    labels = os.path.join(os.path.dirname(os.path.dirname(pkg.__file__)),
                          "data", "labels", "aishell_labels.json")
    label2id, _ = load_vocab(labels)
    params = init_params(cfg, len(label2id),
                         torch.Generator().manual_seed(SEED))
    rs = np.random.RandomState(SEED)
    n_pcm = (FRAMES - 1) * cfg.hop_length + cfg.n_fft
    pcm = rs.randn(B, n_pcm).astype(np.float32) * 0.1
    if cfg.pcm_wire_dtype == "int16":
        pcm = np.rint(pcm * 32768.0).astype(np.int16)
    lengths = rs.randint(10, 22, size=B)      # SOS + 8..19 + EOS
    targets = np.zeros((B, TARGET_COLUMNS), np.int64)
    for i, n in enumerate(lengths):
        targets[i, :n] = np.concatenate(
            [[1], rs.randint(3, len(label2id), size=n - 2), [2]])
    tensors = (torch.from_numpy(pcm).to(dev),
               torch.full((B,), FRAMES, dtype=torch.int64, device=dev),
               torch.from_numpy(targets).to(dev),
               torch.from_numpy(lengths.astype(np.int64)).to(dev))
    fp = FlatParams(params, dev)
    opt = init_opt_state(cfg, fp.data)
    rng = DropoutRng(SEED, dev)
    step = make_train_step_impl(cfg, dims_from_config(cfg))
    return lambda: step(fp, fp.data, opt, rng, *tensors, FRAMES,
                        model_state={})


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--block2", action="store_true",
                   help="set ops.vgg_fused.BLOCK2_ENABLED: the fused block 2")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="the step's compute type")
    args = p.parse_args(argv)
    import torch
    import end2end_asr_tpu_torch as pkg
    from end2end_asr_tpu_torch.ops import vgg_fused as V
    from end2end_asr_tpu_torch.tools import probe_lib as P
    if not torch.cuda.is_available():
        raise SystemExit("probe_step: needs a CUDA device")
    V.BLOCK2_ENABLED = args.block2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.dtype == "float32":   # JAX's f32 is full f32: no TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    one = default_step(torch, dev, args.dtype)
    one()
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"package": os.path.dirname(os.path.abspath(pkg.__file__)),
           "block2": args.block2, "dtype": args.dtype,
           "step_ms_median": statistics.median(times), "step_ms": times,
           "profile": profile_step(torch, one),
           "step_memory": step_memory(torch, one), "gpu": P.gpu_line()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
