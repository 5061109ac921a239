"""Losses and token-level accuracy (the reference's utils/metrics.py:78-168).

Port of the JAX package's ``training/loss.py``. `cross_entropy_loss`
keeps the reference's manual label smoothing: one_hot·(1−ε) + (1−one_hot)
·ε/C, so the mass at the target is exactly 1−ε (not 1−ε+ε/C), summed
against the log-softmax and averaged over the non-PAD positions. With
ε = 0 it is the standard CE with ignore_index = PAD, mean reduction.
``--loss ctc`` is ``ops/ctc.py`` on the f32 log-softmax of the logits,
blank 0, 'mean' reduction; it has no token accuracy (`calculate_metrics`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from end2end_asr_tpu_torch.config import PAD_TOKEN
from end2end_asr_tpu_torch.ops.ctc import ctc_loss


def cross_entropy_loss(pred: torch.Tensor, gold: torch.Tensor,
                       smoothing: float = 0.0) -> torch.Tensor:
    """pred: (B, U, C) logits; gold: (B, U) ids. Scalar f32 loss."""
    B, U, C = pred.shape
    pred = pred.reshape(B * U, C).to(torch.float32)
    gold = gold.reshape(B * U).to(torch.int64)
    non_pad = gold != PAD_TOKEN
    num_word = non_pad.sum().clamp_min(1)
    log_prob = torch.log_softmax(pred, dim=-1)
    if smoothing > 0.0:
        eps = smoothing
        # sum_c q_c·log p_c with q = eps/C everywhere and 1-eps at the gold
        at_gold = log_prob.gather(1, gold.where(non_pad, 0)[:, None])[:, 0]
        loss = -((eps / C) * (log_prob.sum(dim=-1) - at_gold)
                 + (1.0 - eps) * at_gold)
    else:
        loss = -log_prob.gather(1, gold.where(non_pad, 0)[:, None])[:, 0]
    loss = torch.where(non_pad, loss, torch.zeros_like(loss))
    return loss.sum() / num_word


def token_accuracy(pred: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    """Number of correct non-PAD tokens (metrics.py:88-95)."""
    hyp = pred.argmax(dim=-1)
    return ((hyp == gold) & (gold != PAD_TOKEN)).sum()


def calculate_loss(pred: torch.Tensor, gold: torch.Tensor,
                   input_lengths: Optional[torch.Tensor] = None,
                   target_lengths: Optional[torch.Tensor] = None,
                   smoothing: float = 0.0,
                   loss_type: str = "ce") -> torch.Tensor:
    if loss_type == "ce":
        return cross_entropy_loss(pred, gold, smoothing)
    if loss_type == "ctc":
        log_probs = torch.log_softmax(pred.to(torch.float32), dim=-1)
        return ctc_loss(log_probs, gold, input_lengths, target_lengths,
                        blank=0, reduction="mean")
    raise ValueError(f"loss is not defined: {loss_type}")


def calculate_metrics(pred: torch.Tensor, gold: torch.Tensor,
                      input_lengths: Optional[torch.Tensor] = None,
                      target_lengths: Optional[torch.Tensor] = None,
                      smoothing: float = 0.0, loss_type: str = "ce"
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(loss, number of correct tokens or None for ctc)."""
    loss = calculate_loss(pred, gold, input_lengths, target_lengths,
                          smoothing, loss_type)
    return loss, token_accuracy(pred, gold) if loss_type == "ce" else None
