"""Kernels 2 and 3: the fused vgg block 1 forward and its backward
(csrc/vgg_block1.cu), and their plain versions.

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

The backward (kernel 3) replaces ``_bwd_kernel``: from the forward's
uint8 pool argmax and g = dL/d(out) it computes dW1, db1, dW2, db2 with
conv1 recomputed, and NO input gradient (``_zero_input_cotangent``,
vgg_fused.py:455-468: the featurizer upstream has no parameters; the
front end detaches the spectrogram). Numerics of vgg_fused.py:238-285:
dy2 is rounded to cdt, products of cdt values sum in f32, dW1 takes dx1
rounded to cdt. Bound (B=12, F=161, T=800): 231.5 GFLOP, 0.234 ms on the
bf16 tensor cores; the f32 variant runs on f32 FMA (≥3.5 ms).

`vgg_block1` / `vgg_block1_bwd` take the plain version only for a CPU
tensor; for a CUDA tensor they launch the kernel, and raise if they
cannot. The training slice needs the pool argmax: pass ``idx_out``, a
uint8 tensor of the output's shape, and it is filled (`VggBlock1` does).
The serving path passes none.
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


_BWD_KERNELS = {
    dt: cuda_lib.CudaKernel("vgg_block1", sym,
                            [cuda_lib.P] * 9 + [cuda_lib.I] * 3
                            + [cuda_lib.P])
    for dt, sym in ((torch.float32, "vgg_block1_bwd_f32"),
                    (torch.bfloat16, "vgg_block1_bwd_bf16"))}
BWD_BLOCKS = 256                       # csrc/vgg_block1.cu
PART = 9 * C + C + 9 * C * C + C       # floats of one block's partials


def launches() -> int:
    """Launches of the forward kernel (both compute dtypes)."""
    return sum(k.launches for k in _KERNELS.values())


def bwd_launches() -> int:
    """Launches of the backward kernel (both compute dtypes)."""
    return sum(k.launches for k in _BWD_KERNELS.values())


def reset_launches() -> None:
    for k in (*_KERNELS.values(), *_BWD_KERNELS.values()):
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


# ---------------------------------------------------------------------------
# Backward (kernel 3)
# ---------------------------------------------------------------------------

def vgg_block1_bwd_plain(spect: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         out: torch.Tensor,
                         idx: torch.Tensor, g: torch.Tensor,
                         cdt: torch.dtype = torch.bfloat16):
    """Plain block-1 backward: out/idx/g (B, F//2, T//2, 64) NHWC from the
    forward. Returns f32 (dW1 (3,3,1,64), db1 (64,), dW2 (3,3,64,64),
    db2 (64,)); x1 is recomputed as vgg_block1_plain computes it."""
    f32 = torch.float32
    B, F, T = spect.shape
    Fp, Tp = F // 2, T // 2
    x = spect.to(cdt)[:, None]                                # (B,1,F,T)
    x1 = torch.relu(Fn.conv2d(x, w1.to(cdt).permute(3, 2, 0, 1), padding=1)
                    + b1.to(cdt)[None, :, None, None])
    gm = torch.where(out.float() > 0, g.to(cdt).float(),
                     torch.zeros((), dtype=f32, device=g.device))
    db2 = gm.sum(dim=(0, 1, 2))
    # route each pooled gradient to its window's argmax (window order
    # (0,0),(0,1),(1,0),(1,1)); an odd last row / column gets none
    sel = idx[..., None] == torch.arange(4, device=idx.device)
    dyw = torch.where(sel, gm[..., None], torch.zeros((), dtype=f32,
                                                      device=g.device))
    dy2 = (dyw.reshape(B, Fp, Tp, C, 2, 2).permute(0, 3, 1, 4, 2, 5)
           .reshape(B, C, 2 * Fp, 2 * Tp))
    dy2 = Fn.pad(dy2, (0, T - 2 * Tp, 0, F - 2 * Fp)).to(cdt).float()
    x1f = x1.float()
    w2f = w2.to(cdt).float().permute(3, 2, 0, 1)              # (co,ci,3,3)
    dw2 = torch.nn.grad.conv2d_weight(x1f, w2f.shape, dy2, padding=1)
    dx1 = torch.nn.grad.conv2d_input(x1f.shape, w2f, dy2, padding=1)
    dx1 = torch.where(x1f > 0, dx1, torch.zeros((), dtype=f32,
                                                device=dx1.device))
    db1 = dx1.sum(dim=(0, 2, 3))
    dw1 = torch.nn.grad.conv2d_weight(x.float(), (C, 1, 3, 3),
                                      dx1.to(cdt).float(), padding=1)
    return (dw1.permute(2, 3, 1, 0).contiguous(), db1,
            dw2.permute(2, 3, 1, 0).contiguous(), db2)


def vgg_block1_bwd(spect: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, out: torch.Tensor,
                   idx: torch.Tensor, g: torch.Tensor,
                   cdt: torch.dtype = torch.bfloat16):
    """Kernel 3 on CUDA tensors, the plain version on CPU tensors: f32
    (dW1, db1, dW2, db2) of the fused block; no input gradient."""
    if spect.device.type == "cpu":
        return vgg_block1_bwd_plain(spect, w1, b1, w2, out, idx, g, cdt)
    if spect.device.type != "cuda":
        raise ValueError(f"vgg_block1_bwd: unsupported device {spect.device}")
    if cdt not in _BWD_KERNELS:
        raise ValueError(f"vgg_block1_bwd: compute dtype {cdt} not supported")
    B, F, T = spect.shape
    pooled = (B, F // 2, T // 2, C)
    for name, t, dt in (("out", out, cdt), ("g", g, cdt),
                        ("idx", idx, torch.uint8)):
        if tuple(t.shape) != pooled or t.dtype != dt \
                or t.device != spect.device:
            raise ValueError(f"vgg_block1_bwd: {name} must be {dt} "
                             f"{pooled} on {spect.device}")
    for name, t in (("spect", spect), ("w1", w1), ("b1", b1), ("w2", w2)):
        if t.dtype != torch.float32 or t.device != spect.device:
            raise ValueError(f"vgg_block1_bwd: {name} must be f32 on "
                             f"{spect.device}")
    spect, w1, b1, out, idx, g = (t.contiguous() for t in
                                  (spect, w1, b1, out, idx, g))
    # bf16: conv2's weight as bf16 in its natural (tap, ci, co) layout
    w2k = (w2.to(torch.bfloat16) if cdt == torch.bfloat16 else w2).contiguous()
    grads = torch.empty(PART, dtype=torch.float32, device=spect.device)
    part = torch.empty(BWD_BLOCKS * PART, dtype=torch.float32,
                       device=spect.device)
    with torch.cuda.device(spect.device):
        _BWD_KERNELS[cdt].launch(
            spect.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2k.data_ptr(),
            g.data_ptr(), out.data_ptr(), idx.data_ptr(), part.data_ptr(),
            grads.data_ptr(), B, F, T,
            torch.cuda.current_stream().cuda_stream)
    o1, o2, o3 = 9 * C, 10 * C, 10 * C + 9 * C * C
    return (grads[:o1].view(3, 3, 1, C), grads[o1:o2],
            grads[o2:o3].view(3, 3, C, C), grads[o3:])


class VggBlock1(torch.autograd.Function):
    """vgg_block1 with the backward kernel: gradients for w1, b1, w2, b2
    and none for spect (the caller passes a detached spectrogram)."""

    @staticmethod
    def forward(ctx, spect, w1, b1, w2, b2, cdt):
        B, F, T = spect.shape
        idx = torch.empty((B, F // 2, T // 2, C), dtype=torch.uint8,
                          device=spect.device)
        out = vgg_block1(spect, w1, b1, w2, b2, cdt, idx_out=idx)
        ctx.cdt = cdt
        ctx.save_for_backward(spect, w1, b1, w2, out, idx)
        return out

    @staticmethod
    def backward(ctx, g):
        spect, w1, b1, w2, out, idx = ctx.saved_tensors
        dw1, db1, dw2, db2 = vgg_block1_bwd(spect, w1, b1, w2, out, idx,
                                            g.to(ctx.cdt), ctx.cdt)
        return None, dw1, db1, dw2, db2, None
