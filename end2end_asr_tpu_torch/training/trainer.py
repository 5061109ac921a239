"""Training loop (the JAX package's ``training/trainer.py`` `Trainer`).

Behavioral contract with trainer/asr/trainer.py:21-213 of the reference:
epoch loop → train step per batch (training/steps.py) → running train
loss / CER / LR lines → per-epoch teacher-forced valid loss and CER over
every valid loader → metrics history → a checkpoint every `save_every`
epochs and `best_model` on the valid loss → optional sampler shuffle.

Metrics are read on the host two dispatches behind the one that made
them, so the device runs ahead of the logging. The loader is wrapped in
data/loader.Prefetcher by default (`prefetch`): a thread builds the next
batches and copies them to the device while a step runs.
``--steps-per-dispatch K`` groups K consecutive batches of one shape into
one dispatch (training/steps.make_multi_train_step: on a CUDA device one
CUDA graph of the K steps) whose K steps' metrics are pulled at once, as
the JAX trainer's flush_group; a partial group (a shape change, the end
of an epoch) runs single steps. `MultiTrainer` (joint training,
`multi_train.py`) overrides the three validation hooks.

Data parallelism (parallel/mesh.py): each rank trains on its loaders'
slices; the step's loss is already the global batch's. The train CER
counts, each valid batch's loss (weighted by its non-PAD tokens, 1 a rank
for CTC) and the valid CER / WER counts are summed over the ranks, so the
log lines (rank 0's; train.py silences the others) carry global values and
every rank picks the same best model. Rank 0 alone writes checkpoints,
then all ranks meet at a barrier. Under --zero1 / --fsdp
(parallel/zero.py) the moments, and with --fsdp the parameters, are this
rank's slices: they are gathered for validation and for checkpoints, so
a checkpoint is the unsharded run's file and resumes at any world size.
Under tensor parallelism (parallel/tp.py) each rank trains its model
coordinate's shard of the parameters and moments; validation runs the
sharded model, and an npz checkpoint gathers the shards over the model
group first, so it is the one-process run's file.
``--checkpoint-format orbax`` writes the sharded format instead
(training/checkpoint.save_sharded): each rank saves the pieces it holds
(`sharded_pieces`), and nothing is gathered. Under pipeline parallelism
(parallel/pp.py) each rank trains its stage's layers and the leaves
outside the stacks (training/checkpoint.pipe_stage_tree), and its model
coordinate's shard of those under TP; the step gives every stage the
last stage's loss and argmax (rank 0, stage 0, logs them) and stage 0's
model state; an npz checkpoint gathers the stages over the pipe group, so
it is the one-process run's file.
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from end2end_asr_tpu_torch.config import PAD_TOKEN, Config
from end2end_asr_tpu_torch.data.loader import Prefetcher, batch_tensors
from end2end_asr_tpu_torch.evaluation import (ids_to_string_until_pad,
                                              strip_specials)
from end2end_asr_tpu_torch.models.layers import DropoutRng
from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                      to_device, with_state)
from end2end_asr_tpu_torch.parallel import mesh, pp, tp
from end2end_asr_tpu_torch.parallel.zero import MOMENT_KEYS, ZeroShard
from end2end_asr_tpu_torch.training import checkpoint as ckpt
from end2end_asr_tpu_torch.training.optimizer import init_opt_state
from end2end_asr_tpu_torch.training.steps import (FlatParams,
                                                  make_eval_step,
                                                  make_multi_train_step,
                                                  make_train_step_impl)
from end2end_asr_tpu_torch.utils.metrics import calculate_cer, calculate_wer
from end2end_asr_tpu_torch.utils.profiling import trace

logger = logging.getLogger("end2end_asr_tpu_torch")

# the running counts summed over the ranks for the log lines
CER_KEYS = ("cer", "wer", "char")   # the loss is global already


def opt_to_flat(fp: FlatParams, opt_tree: Dict, device) -> Dict:
    """A checkpoint's optimizer tree as the step's flat buffers."""
    return {k: (fp.flatten(v) if k in MOMENT_KEYS
                else v.to(device, torch.int32 if k == "step" else None))
            for k, v in opt_tree.items()}


def opt_to_tree(fp: FlatParams, opt: Dict) -> Dict:
    """The step's flat optimizer state as the JAX package's tree (zero
    moments at the fixed tables)."""
    return {k: (fp.tree(v, fixed="zeros") if k in MOMENT_KEYS else v)
            for k, v in opt.items()}


def summed_over_ranks(values: Dict, keys, device) -> Dict:
    """`values` with the entries `keys` summed over the ranks (a copy;
    the values themselves at world size 1)."""
    if mesh.data_size() == 1:
        return dict(values)
    t = mesh.all_reduce_(torch.tensor([float(values[k]) for k in keys],
                                      dtype=torch.float64, device=device))
    return {**values, **dict(zip(keys, t.tolist()))}


def valid_batch_loss(loss: torch.Tensor, gold: torch.Tensor,
                     loss_type: str) -> float:
    """A valid batch's loss over the ranks: weighted by each rank's
    non-PAD tokens (CE) or alike (CTC: equal shards)."""
    if mesh.data_size() == 1:
        return loss.item()
    w = ((gold != PAD_TOKEN).sum().to(torch.float64) if loss_type == "ce"
         else torch.ones((), dtype=torch.float64, device=loss.device))
    lw = mesh.all_reduce_(torch.stack([loss.to(torch.float64) * w, w]))
    return (lw[0] / lw[1]).item()


def sharded_pieces(fp: FlatParams, data: torch.Tensor, opt: Dict, zero,
                   model_state, full_shapes: Dict):
    """(this rank's pieces, the layout) of a sharded checkpoint
    (training/checkpoint.save_sharded): its pipeline stage's and model
    coordinate's flat parameters (its slice under --fsdp) and moments
    (their slices under ZeRO), keyed by stage and coordinate; the optimizer's scalars, the model state
    and the fixed tables under keys that every rank shares."""
    m, d = mesh.model_rank(), mesh.data_rank()
    stage = zero.stage if zero is not None else 0
    pipe = (f"s{mesh.pipe_rank()}{ckpt.SEP}" if mesh.pipe_size() > 1
            else "")
    own = lambda name, sliced: (f"{name}{ckpt.SEP}{pipe}m{m}"
                                + (f"{ckpt.SEP}d{d}" if sliced else ""))
    pieces = {own("params", stage == 3): data}
    for k, v in opt.items():
        pieces[own(k, stage > 0) if k in MOMENT_KEYS
               else "opt" + ckpt.SEP + k] = v
    for k, v in fp.fixed.items():
        pieces["fixed" + ckpt.SEP + k] = v
    for k, v in ckpt.flatten_params(model_state or {}).items():
        pieces["state" + ckpt.SEP + k] = v
    layout = {"n_data": mesh.data_size(), "n_model": mesh.model_size(),
              "n_pipe": mesh.pipe_size(), "stage": stage, "train_keys": fp.train_keys,
              "order": fp.order,
              "shapes": {k: list(full_shapes[k]) for k in fp.train_keys},
              "opt_keys": list(opt),
              "moment_keys": [k for k in opt if k in MOMENT_KEYS]}
    return pieces, layout


class Trainer:
    def __init__(self, cfg: Config, label2id: Dict[str, int],
                 id2label: Dict[int, str], device: torch.device,
                 metrics_every: int = 1):
        self.cfg = cfg
        self.label2id, self.id2label = label2id, id2label
        self.device = device
        self.dims = dims_from_config(cfg)
        self.metrics_every = max(1, metrics_every)

    def _accumulate_cer(self, hyp_seq, gold_seq, totals: Dict) -> None:
        for hyp_row, gold_row in zip(hyp_seq, gold_seq):
            hyp = strip_specials(ids_to_string_until_pad(hyp_row,
                                                         self.id2label))
            gold = strip_specials(ids_to_string_until_pad(gold_row,
                                                          self.id2label))
            totals["cer"] += calculate_cer(hyp.replace(" ", ""),
                                           gold.replace(" ", ""))
            totals["wer"] += calculate_wer(hyp, gold)
            totals["char"] += len(gold.replace(" ", ""))

    # ------------------------------------------------------------------
    # Validation hooks (overridden by MultiTrainer)
    def _log_valid(self, epoch: int, ind: int, vloss: float,
                   cer_pct: float) -> None:
        logger.info("VALID SET %d LOSS:%.4f CER:%.2f%%", ind, vloss,
                    cer_pct)

    def _best_valid_loss_key(self, valid_losses: List[float]) -> float:
        # the reference keys the best model and metrics["valid_loss"] off
        # the LAST valid loader (trainer/asr/trainer.py:189-208 leaks the
        # loop variable out of the loop over the loaders)
        return valid_losses[-1] if valid_losses else 0.0

    def _extend_metrics(self, metrics: Dict,
                        valid_losses: List[float]) -> None:
        pass

    def train(self, params, opt_state, train_loader, valid_loader_list,
              start_epoch: int = 0, num_epochs: Optional[int] = None,
              last_metrics: Optional[Dict] = None,
              model_state: Optional[Dict] = None,
              prefetch: bool = True) -> Dict:
        """Returns {"params", "opt_state", "model_state" (trees), "metrics",
        "epochs_run", "opt_step"}. `model_state` is the emb_cnn batch
        norms' running statistics ({} or None for the other front ends).
        `prefetch`: build and place the train batches in a
        data/loader.Prefetcher thread (the JAX trainer's default)."""
        cfg, dev = self.cfg, self.device
        num_epochs = cfg.epochs if num_epochs is None else num_epochs
        history: List[Dict] = list((last_metrics or {}).get("history", []))
        best_valid_loss = (last_metrics or {}).get("valid_loss", 1e9)
        # pipeline parallelism: this rank trains its stage's layers and the
        # leaves outside the stacks; tensor parallelism: its model
        # coordinate's shard of those
        n_model, n_pipe, plan = mesh.model_size(), mesh.pipe_size(), None
        stage = lambda t: (ckpt.pipe_stage_tree(t, n_pipe, mesh.pipe_rank())
                           if n_pipe > 1 else t)
        shard = lambda t: (ckpt.model_rank_tree(t, n_model, mesh.model_rank())
                           if n_model > 1 else t)
        params = stage(params)
        full_shapes = {k: tuple(v.shape)
                       for k, v in ckpt.flatten_params(params).items()}
        params = shard(params)
        if opt_state is not None:
            opt_state = {k: (shard(stage(v)) if k in MOMENT_KEYS else v)
                         for k, v in opt_state.items()}
        unshard = lambda t: pp.gather_stages(tp.gather_tree(t, full_shapes))
        unshard_opt = lambda o: {k: (unshard(v) if k in MOMENT_KEYS else v)
                                 for k, v in o.items()}
        fp = FlatParams(params, dev)
        if n_model > 1 or n_pipe > 1:
            plan = tp.FlatPlan(
                fp, [k for k in fp.train_keys
                     if tp.leaf_dim(k, full_shapes[k], n_model) is not None],
                n_model, cfg.seq_parallel, n_pipe)
        data = fp.data
        zero = (ZeroShard.for_config(cfg, fp.numel)
                if cfg.zero1 or cfg.fsdp else None)
        if zero is None:
            opt = (init_opt_state(cfg, data) if opt_state is None
                   else opt_to_flat(fp, opt_state, dev))
        else:
            logger.info(zero.describe())
            part = zero.shard(data)
            opt = (init_opt_state(cfg, part) if opt_state is None
                   else zero.shard_opt(opt_to_flat(fp, opt_state, dev)))
            if zero.stage == 3:     # only the slice lives between steps
                data, fp.data = part, None
        full_params = (lambda: zero.gather(data)) if (
            zero is not None and zero.stage == 3) else (lambda: data)
        full_opt = (lambda: opt) if zero is None else (
            lambda: zero.gather_opt(opt))
        state = to_device(model_state or {}, dev)
        # every rank seeds the dropout streams from the run's seed, so the
        # ranks draw the same masks by local row: the replica-correlated
        # dropout of the JAX package's sharded kernel
        rng = DropoutRng(cfg.seed + start_epoch, dev)
        step = make_train_step_impl(cfg, self.dims, zero=zero, plan=plan)
        eval_step = make_eval_step(cfg, self.dims)
        # --steps-per-dispatch K: K same-shape batches a dispatch; built
        # once, so a shape's CUDA graph serves every epoch
        steps_k = max(1, int(cfg.steps_per_dispatch))
        multi = (make_multi_train_step(cfg, step, steps_k, dev)
                 if steps_k > 1 else None)
        metrics: Dict = {}

        for epoch in range(start_epoch, num_epochs):
            totals = {"loss": 0.0, "cer": 0, "wer": 0, "char": 1e-9,
                      "batches": 0, "utts": 0}
            logger.info("TRAIN")
            t0 = time.time()
            lr = 0.0
            # one entry a dispatch: ([(batch index, rows)], metrics, hyp,
            # gold), the K steps' stacked when the dispatch ran K
            pending = []
            buckets: Counter = Counter()   # (frames, target columns)

            def drain(entry):
                nonlocal lr
                metas, m, hyp, gold = entry
                many = len(metas) > 1
                # one device-to-host pull a dispatch
                loss, finite, lrs = torch.stack(
                    [m["loss"].to(torch.float32),
                     m["finite"].to(torch.float32),
                     m["lr"].to(torch.float32)]).reshape(3, -1).tolist()
                for j, (i, rows) in enumerate(metas):
                    lr = lrs[j]
                    if not finite[j]:
                        logger.info("Found infinity loss, masking")
                        continue
                    totals["loss"] += loss[j]
                    totals["batches"] += 1
                    totals["utts"] += rows
                    if i % self.metrics_every == 0:
                        h, g = (hyp[j], gold[j]) if many else (hyp, gold)
                        self._accumulate_cer(h[:rows].tolist(),
                                             g[:rows].tolist(), totals)
                    if i % 20 == 0:
                        t = summed_over_ranks(totals, CER_KEYS, dev)
                        logger.info(
                            "(Epoch %d) it %d TRAIN LOSS:%.4f CER:%.2f%% "
                            "LR:%.7f", epoch + 1, i,
                            t["loss"] / max(t["batches"], 1),
                            t["cer"] * 100 / t["char"], lr)

            def run_single(entry):
                nonlocal data, opt, state
                i, rows, tensors, bucket = entry
                data, opt, state, m, hyp, gold = step(
                    fp, data, opt, rng, *tensors, bucket,
                    model_state=state)
                pending.append(([(i, rows)], m, hyp, gold))

            group: List = []

            def flush_group():
                # K batches: one dispatch; fewer (a shape change, the
                # epoch's end): single steps
                nonlocal data, opt, state
                entries = list(group)
                group.clear()
                if len(entries) < steps_k:
                    for e in entries:
                        run_single(e)
                    return
                data, opt, state, m, hyp, gold = multi(
                    fp, data, opt, rng, [e[2] for e in entries],
                    entries[0][3], model_state=state)
                pending.append(([e[:2] for e in entries], m, hyp, gold))

            batches = (Prefetcher(train_loader, device=dev) if prefetch
                       else ((b, batch_tensors(b, dev))
                             for b in train_loader))
            # --trace-dir: a torch.profiler trace of the first epoch's steps
            with trace(cfg.trace_dir if epoch == start_epoch else "", dev):
                group_key = None
                for i, (batch, tensors) in enumerate(batches):
                    rows = (batch.real_rows if batch.real_rows > 0
                            else len(batch.targets))
                    entry = (i, rows, tensors, batch.src_bucket)
                    buckets[batch.src_bucket, batch.targets.shape[1]] += 1
                    if steps_k > 1:
                        key = (batch.src_bucket,) + tuple(
                            tuple(t.shape) for t in tensors)
                        if group and key != group_key:
                            flush_group()
                        group_key = key
                        group.append(entry)
                        if len(group) == steps_k:
                            flush_group()
                    else:
                        run_single(entry)
                    while len(pending) > 2:
                        drain(pending.pop(0))
                flush_group()
                for entry in pending:
                    drain(entry)
            wall = time.time() - t0
            totals = summed_over_ranks(totals, CER_KEYS + ("utts",), dev)
            train_loss = totals["loss"] / max(totals["batches"], 1)
            logger.info("(Epoch %d) TRAIN LOSS:%.4f CER:%.2f%% LR:%.7f "
                        "utt/s:%.2f wall:%.1fs", epoch + 1, train_loss,
                        totals["cer"] * 100 / totals["char"], lr,
                        totals["utts"] / max(wall, 1e-9), wall)
            logger.info("(Epoch %d) TRAIN BATCHES PER BUCKET (frames x "
                        "target columns): %s", epoch + 1,
                        " ".join(f"{t}x{u}:{n}"
                                 for (t, u), n in sorted(buckets.items())))

            logger.info("VALID")
            params_now = fp.tree(full_params())
            valid_losses: List[float] = []
            valid_cer_total, valid_wer_total = 0, 0
            for ind, loader in enumerate(valid_loader_list):
                vtot = {"loss": 0.0, "cer": 0, "wer": 0, "char": 1e-9,
                        "batches": 0}
                for batch in loader:
                    rows = (batch.real_rows if batch.real_rows > 0
                            else len(batch.targets))
                    loss, hyp, gold = eval_step(
                        with_state(params_now, state),
                        *batch_tensors(batch, dev), batch.src_bucket)
                    loss = valid_batch_loss(loss, gold, cfg.loss)
                    if not np.isfinite(loss):
                        logger.info("Found infinity loss, masking")
                        continue
                    vtot["loss"] += loss
                    vtot["batches"] += 1
                    self._accumulate_cer(hyp[:rows].tolist(),
                                         gold[:rows].tolist(), vtot)
                vtot = summed_over_ranks(vtot, CER_KEYS, dev)
                vloss = vtot["loss"] / max(vtot["batches"], 1)
                self._log_valid(epoch, ind, vloss,
                                vtot["cer"] * 100 / vtot["char"])
                valid_losses.append(vloss)
                valid_cer_total += vtot["cer"]
                valid_wer_total += vtot["wer"]

            valid_loss_key = self._best_valid_loss_key(valid_losses)
            metrics = {"train_loss": train_loss,
                       "valid_loss": valid_loss_key,
                       "train_cer": totals["cer"],
                       "train_wer": totals["wer"],
                       "valid_cer": valid_cer_total,
                       "valid_wer": valid_wer_total, "history": history}
            self._extend_metrics(metrics, valid_losses)
            history.append({k: v for k, v in metrics.items()
                            if k != "history"})

            def save(best: bool):
                base = ckpt.checkpoint_paths(cfg.save_folder, cfg.name,
                                             epoch + 1, best=best)
                if mesh.is_main():
                    logger.info("SAVE %sMODEL to %s",
                                "BEST " if best else "", base)
                if cfg.checkpoint_format == "orbax":
                    pieces, layout = sharded_pieces(fp, data, opt, zero,
                                                    state, full_shapes)
                    ckpt.save_sharded(base, cfg, epoch + 1, self.label2id,
                                      self.id2label, pieces, layout,
                                      metrics=metrics)
                    mesh.barrier()
                    return
                # on every rank: the collectives of ZeRO and TP
                opt_tree = unshard_opt(opt_to_tree(fp, full_opt()))
                params_full = unshard(params_now)
                if mesh.is_main():
                    ckpt.save_checkpoint(base, cfg, epoch + 1, params_full,
                                         self.label2id, self.id2label,
                                         model_state=state, metrics=metrics,
                                         opt_state=opt_tree)
                mesh.barrier()

            if epoch % cfg.save_every == 0:
                save(best=False)
            if valid_loader_list and best_valid_loss > valid_loss_key:
                best_valid_loss = valid_loss_key
                save(best=True)
            if cfg.shuffle:
                logger.info("SHUFFLE")
                train_loader.shuffle(epoch)

        if multi is not None:
            multi.close()
        return {"params": unshard(fp.tree(full_params())),
                "opt_state": unshard_opt(opt_to_tree(fp, full_opt())),
                "model_state": state, "metrics": metrics,
                "epochs_run": max(0, num_epochs - start_epoch),
                "opt_step": int(opt["step"].item())}


class MultiTrainer(Trainer):
    """Joint multi-dataset trainer (`multi_train.py`; the JAX package's
    `MultiTrainer`, restoring the reference's deleted one): one
    `(Epoch N) TASK:i VALID LOSS:… CER:…` line per task, the best model
    keyed off the mean of the tasks' valid losses, and the list of them
    in metrics["valid_losses"]."""

    def _log_valid(self, epoch: int, ind: int, vloss: float,
                   cer_pct: float) -> None:
        logger.info("(Epoch %d) TASK:%d VALID LOSS:%.4f CER:%.2f%%",
                    epoch + 1, ind, vloss, cer_pct)

    def _best_valid_loss_key(self, valid_losses: List[float]) -> float:
        return float(np.mean(valid_losses)) if valid_losses else 0.0

    def _extend_metrics(self, metrics: Dict,
                        valid_losses: List[float]) -> None:
        metrics["valid_losses"] = list(valid_losses)
