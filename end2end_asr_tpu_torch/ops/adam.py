"""The train step's Noam Adam update as one pass over a flat f32 buffer.

The JAX package's update is plain XLA (training/optimizer.py): XLA fuses
its elementwise chain. PyTorch runs the same chain as a kernel an
operation over the whole buffer, each writing a new tensor (9 with f32
moments, the picks included; 12 with bf16). `adam_step` does the
elementwise part of the step's update (the gradient's scale by `inv`,
the clip's scale, the bias-corrected Adam step and the skip of a
non-finite step) on CUDA tensors as ONE kernel, csrc/adam.cu, which
equals that chain and its `torch.where` picks bit for bit
(training/optimizer.adam_noam_step runs the chain itself off the card).

The step's scalars (lr, the two bias corrections, inv, the clip's scale,
finite) are 0-d tensors on the buffer's device, read by the kernel from
device memory: a launch captured in the K-step CUDA graph
(training/steps.GraphedSteps) reads each replay's own. The result is
new tensors; nothing is modified in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from end2end_asr_tpu_torch.ops import cuda_lib

P = cuda_lib.P
# p g m v p_out m_out v_out, n, moments_bf16, lr bc1 bc2 inv clip finite,
# b1 b2 1-b1 1-b2 eps, stream
ADAM = cuda_lib.CudaKernel("adam", "adam_noam",
                           [P] * 7 + [cuda_lib.L, cuda_lib.I] + [P] * 6
                           + [cuda_lib.F32] * 5 + [P])

# the moments' dtypes the kernel takes
MOMENT_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    ADAM.launches = 0


def check_inputs(p, g, m, v, scalars, finite) -> None:
    """Raises ValueError unless the arrays and the scalars are what
    `adam_step` takes (`scalars`: [(name, tensor, dtype)])."""
    dev = p.device
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"adam_step: parameters and gradient must be f32, "
                         f"got {p.dtype} and {g.dtype}")
    if m.dtype not in MOMENT_DTYPES or v.dtype != m.dtype:
        raise ValueError(f"adam_step: moments must both be f32 or both "
                         f"bf16, got {m.dtype} and {v.dtype}")
    for name, x in (("parameters", p), ("gradient", g), ("first moment", m),
                    ("second moment", v)):
        if x.shape != p.shape or not x.is_contiguous():
            raise ValueError(f"adam_step: the {name} must be contiguous and "
                             f"of the parameters' shape {tuple(p.shape)}, "
                             f"got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"adam_step: the {name} is on {x.device}, the "
                             f"parameters on {dev}")
        if x.numel() and x.data_ptr() % 16:
            raise ValueError(f"adam_step: the {name} does not start 16-byte "
                             f"aligned (the kernel's vector accesses)")
    for name, x, dtype in scalars + [("finite", finite, torch.bool)]:
        if x.numel() != 1 or x.dtype != dtype or x.device != dev:
            raise ValueError(f"adam_step: {name} must be one {dtype} value "
                             f"on {dev}, got {x.dtype} of shape "
                             f"{tuple(x.shape)} on {x.device}")


def adam_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, *, lr: torch.Tensor, bc1: torch.Tensor,
              bc2: torch.Tensor, inv: torch.Tensor, finite: torch.Tensor,
              clip: Optional[torch.Tensor] = None, beta1: float,
              beta2: float, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p', m', v') of the Adam step on the gradient (g · inv) · clip (no
    second product where `clip` is None), where `finite` is true; p, m, v
    themselves (bit for bit, in new tensors on the card) where it is
    false. p, g: f32; m, v: f32 or bf16; all of one shape, contiguous, on
    one CUDA device, each starting 16-byte aligned; lr, bc1 = 1 - beta1^t,
    bc2 = 1 - beta2^t, inv, clip: one f32 value each, finite one bool, on
    that device. Raises ValueError otherwise. One launch of csrc/adam.cu,
    into new tensors."""
    scalars = [("lr", lr, torch.float32), ("bc1", bc1, torch.float32),
               ("bc2", bc2, torch.float32), ("inv", inv, torch.float32)]
    if clip is not None:
        scalars.append(("clip", clip, torch.float32))
    check_inputs(p, g, m, v, scalars, finite)
    if p.device.type != "cuda":
        raise ValueError(f"adam_step: the kernel runs on a CUDA device, "
                         f"not {p.device}")
    # ctypes rounds the constants to f32 as PyTorch rounds a Python scalar
    po, mo, vo = (torch.empty_like(x) for x in (p, m, v))
    with torch.cuda.device(p.device):
        ADAM.launch(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    po.data_ptr(), mo.data_ptr(), vo.data_ptr(), p.numel(),
                    int(m.dtype == torch.bfloat16), lr.data_ptr(),
                    bc1.data_ptr(), bc2.data_ptr(), inv.data_ptr(),
                    None if clip is None else clip.data_ptr(),
                    finite.data_ptr(), beta1, beta2, 1.0 - beta1,
                    1.0 - beta2, eps,
                    torch.cuda.current_stream().cuda_stream)
    return po, mo, vo
