"""CTC loss with the semantics of the JAX package's ``ops/ctc.py`` (and of
torch.nn.functional.ctc_loss as the reference uses it, utils/metrics.py:
133-154): blank id 0; 'mean' = per-sample negative log-likelihood divided
by max(target length, 1), averaged over the batch; a repeated label needs
the blank between its two copies; PAD content beyond a target's length is
ignored; an infeasible row (fewer frames than the CTC path needs, or no
frames) gives +inf, so that the trainer's non-finite-loss skip engages.

The JAX function is plain XLA (a scan over the alpha recursion). The
per-row negative log-likelihood (`ctc_nll`) comes, on CUDA tensors, from
csrc/ctc.cu (`CtcNll`, forward and backward): the JAX recursion with the
lengths read from device memory. PyTorch's CUDA CTC copies the lengths to
the host at every call, so it cannot sit in a CUDA graph
(--steps-per-dispatch). The plain version, taken only for CPU tensors, is
``Fn.ctc_loss``, whose alpha recursion is the same: its 'none' reduction
gives the per-sample nll with +inf for infeasible rows (zero_infinity
off). The division and the mean are done here, so that an empty target
divides by 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from end2end_asr_tpu_torch.ops import cuda_lib

P, I = cuda_lib.P, cuda_lib.I
# lp targets in_len tgt_len nll alpha, B T C U blank, stream
FWD = cuda_lib.CudaKernel("ctc", "ctc_fwd_f32", [P] * 6 + [I] * 5 + [P])
# lp targets in_len tgt_len alpha nll g grad post, B T C U blank, stream
BWD = cuda_lib.CudaKernel("ctc", "ctc_bwd_f32", [P] * 9 + [I] * 5 + [P])


def reset_launches() -> None:
    FWD.launches = BWD.launches = 0


def ctc_nll_plain(log_probs: torch.Tensor, targets: torch.Tensor,
                  input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                  blank: int = 0) -> torch.Tensor:
    """(B,) per-row nll: PyTorch's ctc_loss ('none'), +inf where the input
    length is 0. Lengths (B,) int64; input lengths at most T."""
    T = log_probs.shape[1]
    nll = Fn.ctc_loss(log_probs.transpose(0, 1), targets,
                      input_lengths.clamp(1, T), target_lengths,
                      blank=blank, reduction="none", zero_infinity=False)
    return torch.where(input_lengths < 1,
                       torch.full_like(nll, float("inf")), nll)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class CtcNll(torch.autograd.Function):
    """The per-row nll by csrc/ctc.cu on CUDA tensors (f32 log_probs
    (B, T, C), int64 targets and lengths on the same device); its backward
    the kernel's gradient d nll / d log_probs."""

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths,
                blank):
        B, T, C = log_probs.shape
        U = targets.shape[1]
        lp = log_probs.contiguous()
        nll = torch.empty(B, dtype=torch.float32, device=lp.device)
        keep = ctx.needs_input_grad[0]
        alpha = (torch.empty((B, T, 2 * U + 1), dtype=torch.float32,
                             device=lp.device) if keep else None)
        with torch.cuda.device(lp.device):
            FWD.launch(lp.data_ptr(), targets.data_ptr(),
                       input_lengths.data_ptr(), target_lengths.data_ptr(),
                       nll.data_ptr(),
                       alpha.data_ptr() if keep else None, B, T, C, U,
                       blank, _stream())
        if keep:
            ctx.save_for_backward(lp, targets, input_lengths,
                                  target_lengths, alpha, nll)
        ctx.blank = blank
        return nll

    @staticmethod
    def backward(ctx, g):
        lp, targets, input_lengths, target_lengths, alpha, nll = \
            ctx.saved_tensors
        B, T, C = lp.shape
        U = targets.shape[1]
        grad = torch.zeros_like(lp)
        post = torch.empty_like(alpha)
        g = g.to(torch.float32).contiguous()
        with torch.cuda.device(lp.device):
            BWD.launch(lp.data_ptr(), targets.data_ptr(),
                       input_lengths.data_ptr(), target_lengths.data_ptr(),
                       alpha.data_ptr(), nll.data_ptr(), g.data_ptr(),
                       grad.data_ptr(), post.data_ptr(), B, T, C, U,
                       ctx.blank, _stream())
        return grad, None, None, None, None


def ctc_nll(log_probs: torch.Tensor, targets: torch.Tensor,
            input_lengths: torch.Tensor, target_lengths: torch.Tensor,
            blank: int = 0) -> torch.Tensor:
    """(B,) per-row nll, +inf for an infeasible row: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    T = log_probs.shape[1]
    args = (targets.to(torch.int64).contiguous(),
            input_lengths.to(torch.int64).clamp(max=T).contiguous(),
            target_lengths.to(torch.int64).contiguous())
    if log_probs.device.type == "cpu":
        return ctc_nll_plain(log_probs, *args, blank=blank)
    if log_probs.device.type != "cuda" or log_probs.dtype != torch.float32:
        raise ValueError(f"ctc_nll: f32 log_probs on a CUDA device or the "
                         f"CPU, got {log_probs.dtype} on {log_probs.device}")
    return CtcNll.apply(log_probs, *args, blank)


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             input_lengths: torch.Tensor, target_lengths: torch.Tensor,
             blank: int = 0, reduction: str = "mean") -> torch.Tensor:
    """log_probs (B, T, C) log-softmax outputs (f32); targets (B, U) ids;
    lengths (B,). A row with input length 0 is infeasible (+inf)."""
    target_lengths = target_lengths.to(torch.int64)
    nll = ctc_nll(log_probs, targets, input_lengths, target_lengths, blank)
    if reduction == "mean":
        return (nll / target_lengths.clamp_min(1).to(nll.dtype)).mean()
    if reduction == "sum":
        return nll.sum()
    return nll
