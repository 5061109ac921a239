"""Training loop (the JAX package's ``training/trainer.py`` `Trainer`).

Behavioral contract with trainer/asr/trainer.py:21-213 of the reference:
epoch loop → train step per batch (training/steps.py) → running train
loss / CER / LR lines → per-epoch teacher-forced valid loss and CER over
every valid loader → metrics history → a checkpoint every `save_every`
epochs and `best_model` on the valid loss → optional sampler shuffle.

Metrics are read on the host two steps behind the step that made them,
so the device runs ahead of the logging. `MultiTrainer` (joint training,
`multi_train.py`) overrides the three validation hooks.
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from end2end_asr_tpu_torch.config import Config
from end2end_asr_tpu_torch.evaluation import (ids_to_string_until_pad,
                                              strip_specials)
from end2end_asr_tpu_torch.models.layers import DropoutRng
from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                      to_device, with_state)
from end2end_asr_tpu_torch.training import checkpoint as ckpt
from end2end_asr_tpu_torch.training.optimizer import init_opt_state
from end2end_asr_tpu_torch.training.steps import (FlatParams,
                                                  make_eval_step,
                                                  make_train_step_impl)
from end2end_asr_tpu_torch.utils.metrics import calculate_cer, calculate_wer
from end2end_asr_tpu_torch.utils.profiling import trace

logger = logging.getLogger("end2end_asr_tpu_torch")

PARAM_LIKE = ("mu", "nu", "buf")   # optimizer entries shaped like params


def opt_to_flat(fp: FlatParams, opt_tree: Dict, device) -> Dict:
    """A checkpoint's optimizer tree as the step's flat buffers."""
    return {k: (fp.flatten(v) if k in PARAM_LIKE
                else v.to(device, torch.int32 if k == "step" else None))
            for k, v in opt_tree.items()}


def opt_to_tree(fp: FlatParams, opt: Dict) -> Dict:
    """The step's flat optimizer state as the JAX package's tree (zero
    moments at the fixed tables)."""
    return {k: (fp.tree(v, fixed="zeros") if k in PARAM_LIKE else v)
            for k, v in opt.items()}


def batch_tensors(batch, device):
    """(pcm, n_frames, targets, tgt_lengths) of a loader batch on device."""
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
    return (torch.from_numpy(batch.pcm).to(device), as_t(batch.n_frames),
            as_t(batch.targets), as_t(batch.tgt_lengths))


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
              model_state: Optional[Dict] = None) -> Dict:
        """Returns {"params", "opt_state", "model_state" (trees), "metrics",
        "epochs_run", "opt_step"}. `model_state` is the emb_cnn batch
        norms' running statistics ({} or None for the other front ends)."""
        cfg, dev = self.cfg, self.device
        num_epochs = cfg.epochs if num_epochs is None else num_epochs
        history: List[Dict] = list((last_metrics or {}).get("history", []))
        best_valid_loss = (last_metrics or {}).get("valid_loss", 1e9)
        fp = FlatParams(params, dev)
        data = fp.data
        opt = (init_opt_state(cfg, data) if opt_state is None
               else opt_to_flat(fp, opt_state, dev))
        state = to_device(model_state or {}, dev)
        rng = DropoutRng(cfg.seed + start_epoch, dev)
        step = make_train_step_impl(cfg, self.dims)
        eval_step = make_eval_step(cfg, self.dims)
        metrics: Dict = {}

        for epoch in range(start_epoch, num_epochs):
            totals = {"loss": 0.0, "cer": 0, "wer": 0, "char": 1e-9,
                      "batches": 0, "utts": 0}
            logger.info("TRAIN")
            t0 = time.time()
            lr = 0.0
            pending = []
            buckets: Counter = Counter()   # (frames, target columns)

            def drain(entry):
                nonlocal lr
                i, rows, m, hyp, gold = entry
                lr = m["lr"].item()
                if not bool(m["finite"].item()):
                    logger.info("Found infinity loss, masking")
                    return
                totals["loss"] += m["loss"].item()
                totals["batches"] += 1
                totals["utts"] += rows
                if i % self.metrics_every == 0:
                    self._accumulate_cer(hyp[:rows].tolist(),
                                         gold[:rows].tolist(), totals)
                if i % 20 == 0:
                    logger.info(
                        "(Epoch %d) it %d TRAIN LOSS:%.4f CER:%.2f%% "
                        "LR:%.7f", epoch + 1, i,
                        totals["loss"] / max(totals["batches"], 1),
                        totals["cer"] * 100 / totals["char"], lr)

            # --trace-dir: a torch.profiler trace of the first epoch's steps
            with trace(cfg.trace_dir if epoch == start_epoch else "", dev):
                for i, batch in enumerate(train_loader):
                    rows = (batch.real_rows if batch.real_rows > 0
                            else len(batch.targets))
                    data, opt, state, m, hyp, gold = step(
                        fp, data, opt, rng, *batch_tensors(batch, dev),
                        batch.src_bucket, model_state=state)
                    pending.append((i, rows, m, hyp, gold))
                    buckets[batch.src_bucket, batch.targets.shape[1]] += 1
                    while len(pending) > 2:
                        drain(pending.pop(0))
                for entry in pending:
                    drain(entry)
            wall = time.time() - t0
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
            params_now = fp.tree(data)
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
                    loss = loss.item()
                    if not np.isfinite(loss):
                        logger.info("Found infinity loss, masking")
                        continue
                    vtot["loss"] += loss
                    vtot["batches"] += 1
                    self._accumulate_cer(hyp[:rows].tolist(),
                                         gold[:rows].tolist(), vtot)
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
                logger.info("SAVE %sMODEL to %s", "BEST " if best else "",
                            base)
                ckpt.save_checkpoint(base, cfg, epoch + 1, params_now,
                                     self.label2id, self.id2label,
                                     model_state=state, metrics=metrics,
                                     opt_state=opt_to_tree(fp, opt))

            if epoch % cfg.save_every == 0:
                save(best=False)
            if valid_loader_list and best_valid_loss > valid_loss_key:
                best_valid_loss = valid_loss_key
                save(best=True)
            if cfg.shuffle:
                logger.info("SHUFFLE")
                train_loader.shuffle(epoch)

        return {"params": fp.tree(data), "opt_state": opt_to_tree(fp, opt),
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
