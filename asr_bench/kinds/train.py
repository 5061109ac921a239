"""Training traffic: a pool of batches built once through the program's
batch loader, placed on the device and cycled, K steps a dispatch
through the program's K-step train step (one CUDA graph of K steps),
each dispatch's metrics pulled two dispatches behind, as the program's
trainer does.

Set-up runs the pool's first two dispatches from the seeded weights
through the window's own call: the first captures the graph, the second
replays it on batches of its own (the replay path, warmed before the
window). Their losses, and the first moments and parameters after them,
are kept for the check, which the reference follows step by step once
the window has closed.
"""

from __future__ import annotations

import time
from typing import Dict, List

from asr_bench import core, synth, weights, work
from asr_bench.kinds import common
from asr_bench.reference import check, model as ref

CHECKED_DISPATCHES = 2


def build(run) -> None:
    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import (AudioBatchLoader,
                                                   batch_tensors)
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.training.optimizer import init_opt_state
    from end2end_asr_tpu_torch.training.steps import (FlatParams,
                                                      make_multi_train_step,
                                                      make_train_step_impl)
    tr, dev = run.traffic, run.device
    K, n, B = tr["steps_per_dispatch"], tr["pool_batches"], tr["batch"]
    if n % K or n < CHECKED_DISPATCHES * K:
        raise core.BenchError("pool_batches is not a multiple of "
                              "steps_per_dispatch, or holds fewer than "
                              f"{CHECKED_DISPATCHES} dispatches")
    with run.spans.span("setup.corpus"):
        run.corpus_pcm, text = synth.utterances(
            run.seed, B * n, tr["seconds"], tr["chars"], run.chars)
        run.corpus = synth.Corpus(run.corpus_pcm, text)
    run.targets = [[run.label2id[c] for c in synth.SPECIALS[1] + s
                    + synth.SPECIALS[2]] for s in text]
    cfg = run.program_config()
    run.bins = [list(range(i * B, (i + 1) * B)) for i in range(n)]
    loader = AudioBatchLoader(
        ManifestDataset([run.corpus.manifest], run.label2id), cfg,
        sampler=synth.FixedBins(run.bins), num_workers=1)
    with run.spans.span("build_batch"):
        host = list(loader)
    shapes = {(b.pcm.shape, b.targets.shape, b.src_bucket) for b in host}
    if len(shapes) != 1:
        raise core.BenchError(f"the pool's batches differ in shape: "
                              f"{sorted(shapes)}")
    run.T, run.U = host[0].src_bucket, host[0].targets.shape[1]
    run.pool = [batch_tensors(b, dev) for b in host]
    vocab = len(run.label2id)
    m = run.model_ref
    run.batch_flops = [work.train_step_flops(run.config, vocab, [
        (min(ref.frames_of(len(run.corpus_pcm[j]), m.n_fft, m.hop), run.T),
         len(run.targets[j]) + 1) for j in b]) for b in run.bins]
    with run.spans.span("setup.weights"):
        run.flat = weights.make_flat(run.config, vocab, run.seed, dev)
        run.fp = FlatParams(ref.unflatten(run.flat), dev)
    run.state = {"data": run.fp.data,
                 "opt": init_opt_state(cfg, run.fp.data), "model": {}}
    run.rng = DropoutRng(run.seed, dev)
    run.multi = make_multi_train_step(
        cfg, make_train_step_impl(cfg, dims_from_config(cfg)), K, dev)
    run.next_batch, run.dispatched = 0, []
    run.losses, run.nonfinite = [], 0
    with run.spans.span("setup.checked_dispatches"):
        for _ in range(CHECKED_DISPATCHES):
            drain(run, dispatch(run))
        core.sync(run.device)
    run.kept = {"losses": list(run.losses), "nonfinite": run.nonfinite,
                "data": run.state["data"].clone(),
                "mu": run.state["opt"]["mu"].clone()}
    run.losses, run.nonfinite, run.dispatched = [], 0, []


def dispatch(run) -> Dict:
    """One K-step dispatch of the pool's next K batches."""
    K = run.traffic["steps_per_dispatch"]
    idx = [(run.next_batch + j) % len(run.pool) for j in range(K)]
    run.next_batch += K
    run.dispatched.append(idx)
    st = run.state
    st["data"], st["opt"], st["model"], m, _, _ = run.multi(
        run.fp, st["data"], st["opt"], run.rng, [run.pool[i] for i in idx],
        run.T, model_state=st["model"])
    return m


def drain(run, m) -> None:
    """A dispatch's metrics on the host: one pull."""
    import torch
    got = torch.stack([m["loss"].float(), m["finite"].float()]).tolist()
    run.losses += got[0]
    run.nonfinite += sum(1 for f in got[1] if not f)


def window(run, deadline: float, trace_units: int) -> None:
    """Dispatches until the deadline; with tracing, the first
    `trace_units` of them under the profiler."""
    pending: List = []
    trace = core.Trace() if run.trace else None

    def drain_one():
        with run.spans.span("drain"):
            drain(run, pending.pop(0))

    if trace:
        trace.__enter__()
    while True:
        tracing = trace is not None and len(run.dispatched) < trace_units
        if not tracing and time.perf_counter() >= deadline:
            break
        with run.spans.span("dispatch"):
            pending.append(dispatch(run))
        if tracing and len(run.dispatched) == trace_units:
            while pending:
                drain_one()
            trace.__exit__(None, None, None)
            run.traced = list(run.dispatched)
            run.trace_result = trace.reduce(run.spans)
        while len(pending) > 2:
            drain_one()
    while pending:
        drain_one()
    core.sync(run.device)


def reference_batches(run) -> List:
    """The checked dispatches' batches for the reference."""
    steps = CHECKED_DISPATCHES * run.traffic["steps_per_dispatch"]
    return [run.reference_inputs(rows) for rows in run.bins[:steps]]


def check_program(run) -> List:
    kept = run.kept
    run.multi.close()
    run.multi = run.state = run.pool = None
    core.free(run.device)
    keys = run.fp.train_keys
    mu = dict(zip(keys, run.fp.views(kept["mu"]).values()))
    theta = dict(zip(keys, run.fp.views(kept["data"]).values()))
    r = check.train_readings(run.model_ref, run.flat,
                             reference_batches(run), run.seed,
                             kept["losses"], mu, theta)
    run.check_detail = r
    lim = run.limits
    nonfinite = run.nonfinite + kept["nonfinite"]
    return [("loss_rel", r["loss_rel"], lim["loss_rel"]),
            ("grad_mu_gap", r["mu_gap"], lim["grad_mu_gap"]),
            ("update_gap", r["update_gap"], lim["update_gap"]),
            ("nonfinite_steps", float(nonfinite), 0.0)]


def record(run) -> dict:
    K, B = run.traffic["steps_per_dispatch"], run.traffic["batch"]
    steps = len(run.dispatched) * K
    rec = {"kind": "train", "setup_s": run.setup_s,
           "window_s": run.window_s, "steps": steps,
           "utterances": steps * B, "spans": run.spans,
           "window": run.window_span}
    if run.trace_result is not None:
        rec["trace"] = run.trace_result
        rec["trace_steps"] = len(run.traced) * K
        rec["trace_flops"] = sum(run.batch_flops[i] for idx in run.traced
                                 for i in idx)
        rec["bounds_per_step"] = common.train_kernels(run)
    return rec


RUNNER = common.Runner(build=build, window=window, check=check_program,
                       record=record)
