"""The state of one run, shared by the traffic kinds."""

from __future__ import annotations

from typing import Callable, List, NamedTuple

from asr_bench import core, synth, work
from asr_bench.reference import model as ref


class Runner(NamedTuple):
    build: Callable       # set-up: everything before the window
    window: Callable      # (run, deadline, trace_units)
    check: Callable       # → [(name, value, limit)]
    record: Callable      # → the record the metric readers read


# the program's Config keys a configuration or a mix may set
PROGRAM_KEYS = (
    "model", "rank", "feat_extractor", "num_layers", "num_heads",
    "dim_model", "dim_key", "dim_value", "dim_inner", "dim_emb",
    "sample_rate", "window_size", "window_stride", "window",
    "label_smoothing", "dropout", "k_lr", "min_lr", "warmup", "dtype",
    "src_max_len", "tgt_max_len", "src_buckets", "tgt_buckets",
    "batch_size", "steps_per_dispatch")


class Run:
    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 t0: float, device, files=None):
        self.name, self.seed, self.seconds = name, seed, seconds
        self.trace, self.t0, self.device = trace, t0, device
        self.cell, self.config, self.traffic, self.limits = (
            files or core.cell_files(name))
        self.spans = core.Spans()
        labels = core.load_json("configs", self.config["labels"])
        self.label2id, self.chars = synth.vocabulary(labels)
        self.model_ref = ref.Model(self.config)
        self.corpus = None
        self.trace_result = None

    def program_config(self):
        """The program's Config for this cell."""
        from end2end_asr_tpu_torch.config import Config
        kw = {k: self.config[k] for k in PROGRAM_KEYS if k in self.config}
        kw.update({k: self.traffic[k] for k in PROGRAM_KEYS
                   if k in self.traffic})
        kw["batch_size"] = self.traffic["batch"]
        kw["seed"] = self.seed
        for k in ("src_buckets", "tgt_buckets"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return Config(**kw)

    def bucket(self, n: int, key: str) -> int:
        return next(b for b in self.config[key] if b >= n)

    def reference_inputs(self, rows: List[int]):
        """(pcm, n_frames, targets, T) of the given utterances for the
        reference, on the device, built from the benchmark's own samples
        and transcripts with the configuration's buckets."""
        import torch
        m = self.model_ref
        pcm = [self.corpus_pcm[i] for i in rows]
        frames = [ref.frames_of(len(y), m.n_fft, m.hop) for y in pcm]
        T = self.bucket(max(frames), "src_buckets")
        tg = [self.targets[i] for i in rows]
        U = self.bucket(max(len(t) for t in tg), "tgt_buckets")
        targets = torch.zeros(len(rows), U, dtype=torch.int64)
        for i, t in enumerate(tg):
            targets[i, :len(t)] = torch.tensor(t)
        return (ref.padded_pcm(pcm, T, m.n_fft, m.hop).to(self.device),
                torch.tensor([min(f, T) for f in frames],
                             device=self.device),
                targets.to(self.device), T)


def train_kernels(run) -> dict:
    """The bounds of the kernels the train rooflines read, per step."""
    tr = run.traffic
    B = tr["batch"]
    F = int(run.config["sample_rate"] * run.config["window_size"]) // 2 + 1
    H, D = run.config["num_heads"], run.config["dim_key"]
    T, U = run.T, run.U + 1
    Te = T // 4
    vgg = work.vgg_block1(B, F, T)
    attn = [work.attention_bwd(B, H, Te, Te, D)] * run.config[
        "num_layers"]
    attn += [work.attention_bwd(B, H, U, U, D),
             work.attention_bwd(B, H, U, Te, D)] * run.config["num_layers"]
    return {"vgg_block1_bwd": work.bound_s(vgg["bwd_flop"],
                                           vgg["bwd_bytes"]),
            "attn_bwd": sum(work.bound_s(a["flop"], a["bytes"])
                            for a in attn)}
