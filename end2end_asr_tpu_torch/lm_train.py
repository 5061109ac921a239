"""Train the word-level LSTM LM used for beam rescoring — the flags of
root ``lm_train.py`` plus ``--device`` (default ``cuda``).

    python -m end2end_asr_tpu_torch.lm_train --train-manifest-list m1.csv \
        m2.csv --lm-path lm.npz --epochs 10 --lr 1e-3 [--device cpu]

Trains models/lm.py's RNNModel on the transcripts of ASR manifests
(data/lm_loader.py: lowercased words, each Chinese character a word,
contiguous BPTT batches) with the mean next-word cross-entropy of each
batch and fixed-lr Adam (training/optimizer.adam_update, bias-corrected,
torch semantics), and saves the JAX package's .npz layout, which
``--lm-path`` of ``test`` / ``transcribe`` (either package) loads.
Without a GPU it raises unless --device cpu is given; on the card TF32
is off (evaluation.resolve_device), as the LSTM would otherwise run in
TF32 under cuDNN.
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
import time
from typing import Dict

import torch

from end2end_asr_tpu_torch.models.lm import RNNModel


def train_step(model: RNNModel, opt: Dict, inputs: torch.Tensor,
               targets: torch.Tensor, lr: float):
    """One step on a BPTT batch: mean cross-entropy of targets (B, L)
    given inputs (B, L), then Adam at `lr` over the model's parameters
    (a tied embedding/decoder is one parameter, its gradient the sum of
    both uses), written into the model in place. Returns (opt, loss)."""
    from end2end_asr_tpu_torch.training.optimizer import adam_update
    params = dict(model.named_parameters())
    logits = model(inputs).to(torch.float32)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
    grads = torch.autograd.grad(loss, list(params.values()))
    new, opt = adam_update({k: p.detach() for k, p in params.items()},
                           dict(zip(params, grads)), opt, lr)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(new[k])
    return opt, loss.detach()


def main(argv=None):
    """Trains and saves the LM; returns {"losses": mean loss per epoch,
    "step_ms": host ms of each step (ending in a device synchronize),
    "vocab": vocabulary size, "stream": the BPTT stream's shape}."""
    ap = argparse.ArgumentParser(description="LSTM LM training")
    ap.add_argument("--train-manifest-list", nargs="+", required=True)
    ap.add_argument("--lm-path", default="lm.npz")
    ap.add_argument("--ninp", type=int, default=256)
    ap.add_argument("--nhid", type=int, default=256)
    ap.add_argument("--nlayers", type=int, default=2)
    ap.add_argument("--tie-weights", action="store_true")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--bptt", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--min-count", type=int, default=1)
    ap.add_argument("--seed", type=int, default=123456)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.tie_weights and args.ninp != args.nhid:
        # fail before the corpus scan
        ap.error(f"--tie-weights requires --ninp == --nhid "
                 f"(got {args.ninp} vs {args.nhid})")

    from end2end_asr_tpu_torch.data.lm_loader import (batchify, bptt_batches,
                                                      build_word_vocab,
                                                      corpus_from_manifests)
    from end2end_asr_tpu_torch.evaluation import resolve_device
    from end2end_asr_tpu_torch.models.lm import init_lm, save_npz_lm
    from end2end_asr_tpu_torch.training.optimizer import init_adam_state

    device = resolve_device(args.device)
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s - %(message)s")
    log = logging.getLogger("lm_train")

    sents = corpus_from_manifests(args.train_manifest_list)
    word2idx = build_word_vocab(sents, args.min_count)
    stream = batchify(sents, word2idx, args.batch_size)
    log.info("corpus: %d sentences, vocab %d, stream %s",
             len(sents), len(word2idx), stream.shape)
    model = init_lm(len(word2idx), args.ninp, args.nhid, args.nlayers,
                    args.tie_weights,
                    torch.Generator().manual_seed(args.seed)).to(device)
    opt = init_adam_state({k: p.detach()
                           for k, p in model.named_parameters()})
    stream_t = torch.from_numpy(stream).to(device, torch.int64)

    losses, step_ms = [], []
    for epoch in range(args.epochs):
        total, n = 0.0, 0
        for inputs, targets in bptt_batches(stream_t, args.bptt):
            if inputs.shape[1] < 2:
                continue
            t0 = time.perf_counter()
            opt, loss = train_step(model, opt, inputs, targets, args.lr)
            total += float(loss)  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            n += 1
        if n == 0:
            raise ValueError(
                "corpus too small: no BPTT batch reached 2 columns — "
                f"need at least ~2x --batch-size ({args.batch_size}) "
                "words; lower --batch-size/--bptt or add manifests")
        losses.append(total / n)
        log.info("epoch %d: loss %.4f ppl %.1f", epoch + 1, total / n,
                 math.exp(total / n))

    save_npz_lm(args.lm_path, model, word2idx)
    log.info("saved LM to %s", args.lm_path)
    return {"losses": losses, "step_ms": step_ms, "vocab": len(word2idx),
            "stream": list(stream.shape)}


if __name__ == "__main__":
    main()
