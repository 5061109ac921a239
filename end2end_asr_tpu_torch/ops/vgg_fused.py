"""Kernel 2: the fused vgg block 1 forward (csrc/vgg_block1.cu) and its
plain version.

    relu(maxpool2x2(conv2_SAME(relu(conv1_SAME(spect) + b1))) + b2)

Replaces ``end2end_asr_tpu/ops/vgg_fused.py::_fwd_kernel`` (the forward of
``vgg_block1``), mirroring conv1/conv2 and the first MaxPool2d of the
reference's vgg extractor (models/asr/transformer.py:36-44). As in the
TPU kernel, the full-resolution conv1 activations stay on chip (shared
memory) and never go to device memory.

Numerics kept from the JAX package (vgg_fused.py:30-33,163-209): the
input is rounded to the compute dtype ``cdt`` once, conv outputs are
rounded to ``cdt`` before the pool, b2 is added in ``cdt``, and pool ties
go to the earlier window element in (f, t) order. b1 follows the
composite path's order (round conv1 to ``cdt``, then add b1 in ``cdt``),
not the Pallas kernel's f32 add; in f32 the two are the same.

Bound on the H100 (B=12, F=161, T=800): conv2's 2·B·F·T·64·576 ≈
114 GFLOP: ≈0.12 ms at the 989 TFLOP/s of the bf16 tensor cores, which
the bf16 kernel (the serving path's) uses through mma.sync; the f32
kernel runs on f32 FMA (67 TFLOP/s, ≥1.7 ms). See the source for the
tiling.

`vgg_block1` takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel, and raises if it cannot. The training
slice needs the pool argmax: pass ``idx_out``, a uint8 tensor of the
output's shape, and it is filled. The serving path passes none.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as Fn

from end2end_asr_tpu_torch.ops import cuda_lib

C = 64

_KERNELS = {
    dt: cuda_lib.CudaKernel(
        "vgg_block1", sym, [cuda_lib.P] * 7 + [cuda_lib.I] * 3
        + [cuda_lib.P])
    for dt, sym in ((torch.float32, "vgg_block1_fwd_f32"),
                    (torch.bfloat16, "vgg_block1_fwd_bf16"))}


def launches() -> int:
    """Launches of the kernel (both compute dtypes) through this module."""
    return sum(k.launches for k in _KERNELS.values())


def reset_launches() -> None:
    for k in _KERNELS.values():
        k.launches = 0


def pool2_first_wins(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 stride-2 VALID max pool of y (B, C, H, W) with the argmax in
    window order (0,0),(0,1),(1,0),(1,1); strict '>' keeps the first of
    equal values (torch MaxPool2d / XLA select_and_scatter order)."""
    B, Cc, H, W = y.shape
    Hp, Wp = H // 2, W // 2
    w = y[:, :, :2 * Hp, :2 * Wp].reshape(B, Cc, Hp, 2, Wp, 2)
    cands = (w[:, :, :, 0, :, 0], w[:, :, :, 0, :, 1],
             w[:, :, :, 1, :, 0], w[:, :, :, 1, :, 1])
    best = cands[0]
    idx = torch.zeros(best.shape, dtype=torch.uint8, device=y.device)
    for i in (1, 2, 3):
        take = cands[i] > best
        best = torch.where(take, cands[i], best)
        idx = torch.where(take, torch.full_like(idx, i), idx)
    return best, idx


def vgg_block1_plain(spect: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     cdt: torch.dtype = torch.bfloat16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch block 1: spect (B, F, T); w1 (3,3,1,64), w2
    (3,3,64,64) HWIO; b1/b2 (64,). Returns ((B, F//2, T//2, 64) in cdt,
    uint8 pool argmax of the same shape)."""
    x = spect.to(cdt)[:, None]                                # (B,1,F,T)
    y1 = Fn.conv2d(x, w1.to(cdt).permute(3, 2, 0, 1), padding=1)
    x1 = torch.relu(y1 + b1.to(cdt)[None, :, None, None])
    y2 = Fn.conv2d(x1, w2.to(cdt).permute(3, 2, 0, 1), padding=1)
    best, idx = pool2_first_wins(y2)
    out = torch.relu(best + b2.to(cdt)[None, :, None, None])
    return (out.permute(0, 2, 3, 1).contiguous(),
            idx.permute(0, 2, 3, 1).contiguous())


def vgg_block1(spect: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor,
               cdt: torch.dtype = torch.bfloat16,
               idx_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused conv1+relu+conv2+pool+bias+relu. spect (B, F, T) float;
    returns (B, F//2, T//2, 64) NHWC in cdt."""
    if spect.device.type == "cpu":
        out, idx = vgg_block1_plain(spect, w1, b1, w2, b2, cdt)
        if idx_out is not None:
            idx_out.copy_(idx)
        return out
    if spect.device.type != "cuda":
        raise ValueError(f"vgg_block1: unsupported device {spect.device}")
    if cdt not in _KERNELS:
        raise ValueError(f"vgg_block1: compute dtype {cdt} not supported")
    if spect.dim() != 3:
        raise ValueError("vgg_block1: spect must be (B, F, T)")
    shapes = {"w1": (3, 3, 1, C), "b1": (C,), "w2": (3, 3, C, C),
              "b2": (C,)}
    args = {"spect": spect, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    for name, t in args.items():
        if name != "spect" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"vgg_block1: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"vgg_block1: {name} must be contiguous f32")
        if t.device != spect.device:
            raise ValueError(f"vgg_block1: {name} on {t.device}, "
                             f"spect on {spect.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"vgg_block1: {name} must be 16-byte aligned")
    B, F, T = spect.shape
    out = torch.empty((B, F // 2, T // 2, C), dtype=cdt, device=spect.device)
    if idx_out is not None:
        if (idx_out.shape != out.shape or idx_out.dtype != torch.uint8
                or not idx_out.is_contiguous()
                or idx_out.device != spect.device):
            raise ValueError("vgg_block1: idx_out must be a contiguous "
                             f"uint8 {tuple(out.shape)} tensor on "
                             f"{spect.device}")
    if out.numel() == 0:
        return out
    if cdt == torch.bfloat16:
        # the tensor-core kernel reads conv2's weight as bf16
        # (3, 3, out, in), input channels contiguous
        w2 = w2.to(torch.bfloat16).permute(0, 1, 3, 2).contiguous()
    with torch.cuda.device(spect.device):
        _KERNELS[cdt].launch(
            spect.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(),
            idx_out.data_ptr() if idx_out is not None else None,
            B, F, T, torch.cuda.current_stream().cuda_stream)
    return out
