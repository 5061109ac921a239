"""Kernel 6: the 2x2/2 max-pool backward (csrc/pool_bwd.cu) and its plain
version, inside `max_pool2`, the pool of vgg block 2.

Replaces ``end2end_asr_tpu/ops/pool_vjp.py::_bwd_kernel``. The forward
is the plain VALID 2x2 stride-2 max pool (the JAX package leaves it to
XLA's reduce_window); the backward routes each pooled gradient to the
FIRST maximum of its window in (f, t) order — (0,0), (0,1), (1,0), (1,1)
— the tie-break of torch's MaxPool2d and XLA's select_and_scatter, and
gives an odd last row or column zero gradient. The JAX gate (even T,
C % 64 == 0, pool_vjp.py:134-140) is a TPU layout limit: any F and T
work here.

Layouts: (B, C, F, T) tensors in either of two memory formats, and dy
comes back in y's. In the train step, cuDNN returns conv4's output y
channels-last ((B, F, T, C) in memory, the JAX kernel's NHWC layout),
and the pool keeps it: the kernel reads y and g and writes dy in that
layout, with no copy. NCHW-contiguous y takes the NCHW kernel. A y of
any other layout (a strided view) is copied to channels-last, and a g
whose layout differs from y's to y's, in `pool_bwd`. Bound on the H100 at the flagship
(conv4's output y (12, 128, 80, 400) bf16): read y (98 MB) and g
(24.6 MB), write dy (98 MB): 0.066 ms at 3.35 TB/s; the kernel is one
pass.

`pool_bwd` takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel, and raises if it cannot.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from end2end_asr_tpu_torch.ops import cuda_lib
from end2end_asr_tpu_torch.ops.vgg_fused import pool2_first_wins

# y g dy, B C F T channels_last, stream
_KERNELS = {
    dt: cuda_lib.CudaKernel("pool_bwd", sym,
                            [cuda_lib.P] * 3 + [cuda_lib.I] * 5
                            + [cuda_lib.P])
    for dt, sym in ((torch.float32, "pool_bwd_f32"),
                    (torch.bfloat16, "pool_bwd_bf16"))}


def launches() -> int:
    return sum(k.launches for k in _KERNELS.values())


def reset_launches() -> None:
    for k in _KERNELS.values():
        k.launches = 0


def pool_bwd_plain(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dy (y's shape) of the 2x2/2 VALID max pool: g (B, C, F//2, T//2)
    to the first maximum of each window; zero elsewhere. NCHW for an
    NCHW-contiguous y, else channels-last, as the kernel's wrapper."""
    dy = _pool_bwd_nchw_plain(y, g)
    return (dy if y.is_contiguous()
            else dy.contiguous(memory_format=torch.channels_last))


def _pool_bwd_nchw_plain(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    B, Cc, F, T = y.shape
    Fp, Tp = F // 2, T // 2
    _, idx = pool2_first_wins(y)
    sel = idx[..., None] == torch.arange(4, device=y.device)
    d = torch.where(sel, g[..., None].to(y.dtype),
                    torch.zeros((), dtype=y.dtype, device=y.device))
    d = (d.reshape(B, Cc, Fp, Tp, 2, 2).permute(0, 1, 2, 4, 3, 5)
         .reshape(B, Cc, 2 * Fp, 2 * Tp))
    return Fn.pad(d, (0, T - 2 * Tp, 0, F - 2 * Fp))


def pool_bwd(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if y.device.type == "cpu":
        return pool_bwd_plain(y, g)
    if y.device.type != "cuda":
        raise ValueError(f"pool_bwd: unsupported device {y.device}")
    if y.dtype not in _KERNELS or y.dim() != 4:
        raise ValueError(f"pool_bwd: y must be (B, C, F, T) f32 or bf16, "
                         f"got {y.dtype} {tuple(y.shape)}")
    B, Cc, F, T = y.shape
    if tuple(g.shape) != (B, Cc, F // 2, T // 2) or g.device != y.device:
        raise ValueError(f"pool_bwd: g {tuple(g.shape)} on {g.device} for "
                         f"y {tuple(y.shape)}")
    g = g.to(y.dtype)
    if y.is_contiguous():
        nhwc, fmt = False, torch.contiguous_format
    else:
        # channels-last as the step gives it; any other layout is copied
        # to channels-last here
        nhwc, fmt = True, torch.channels_last
    y, g = y.contiguous(memory_format=fmt), g.contiguous(memory_format=fmt)
    dy = torch.empty_like(y, memory_format=fmt)
    if dy.numel():
        with torch.cuda.device(y.device):
            _KERNELS[y.dtype].launch(
                y.data_ptr(), g.data_ptr(), dy.data_ptr(), B, Cc, F, T,
                int(nhwc), torch.cuda.current_stream().cuda_stream)
    return dy


class MaxPool2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return Fn.max_pool2d(y, 2, 2)

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return pool_bwd(y, g)


def max_pool2(y: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max pool of (B, C, F, T) with the kernel as
    its backward (in y's memory format, NCHW or channels-last)."""
    return MaxPool2.apply(y)
