"""CTC loss with the semantics of the JAX package's ``ops/ctc.py`` (and of
torch.nn.functional.ctc_loss as the reference uses it, utils/metrics.py:
133-154): blank id 0; 'mean' = per-sample negative log-likelihood divided
by max(target length, 1), averaged over the batch; a repeated label needs
the blank between its two copies; PAD content beyond a target's length is
ignored; an infeasible row (fewer frames than the CTC path needs, or no
frames) gives +inf, so that the trainer's non-finite-loss skip engages.

The JAX function is plain XLA (a scan over the alpha recursion), so the
port is plain PyTorch: ``Fn.ctc_loss``, whose alpha recursion is the same
and whose backward is the library's. Its 'none' reduction returns the
per-sample nll with +inf for infeasible rows (zero_infinity off); the
division and the mean are done here so that an empty target divides by 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             input_lengths: torch.Tensor, target_lengths: torch.Tensor,
             blank: int = 0, reduction: str = "mean") -> torch.Tensor:
    """log_probs (B, T, C) log-softmax outputs (f32); targets (B, U) ids;
    lengths (B,). A row with input length 0 is infeasible (+inf)."""
    B, T, _ = log_probs.shape
    input_lengths = input_lengths.to(torch.int64)
    target_lengths = target_lengths.to(torch.int64)
    empty = input_lengths < 1
    nll = Fn.ctc_loss(log_probs.transpose(0, 1), targets.to(torch.int64),
                      input_lengths.clamp(1, T), target_lengths,
                      blank=blank, reduction="none", zero_infinity=False)
    nll = torch.where(empty, torch.full_like(nll, float("inf")), nll)
    if reduction == "mean":
        return (nll / target_lengths.clamp_min(1).to(nll.dtype)).mean()
    if reduction == "sum":
        return nll.sum()
    return nll
