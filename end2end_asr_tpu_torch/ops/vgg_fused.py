"""Kernels 2 and 3: the fused vgg block 1 forward and its backward
(csrc/vgg_block1.cu in bf16, csrc/vgg_block1_f32.cu in f32), and their plain
versions; kernels 7 and 8, the fused block 2 and its backward
(csrc/vgg_block2.cu in bf16, csrc/vgg_block2_f32.cu in f32), in the second
half of this module, behind `BLOCK2_ENABLED`.

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

Bound on the H100 (B=12, F=161, T=800): conv2 at the 2Fp × 2Tp positions
the pool keeps and conv1 at the F × T of the image, 115.0 GFLOP: 0.116 ms
at the 989 TFLOP/s of the bf16 tensor cores. The
bf16 kernel (the serving and training paths') is one persistent pass
that keeps conv2's weight in shared memory, runs conv2 on ``wgmma`` and
builds conv1's activations beside the products
(tests/test_torch_vgg_block1.py mirrors its tiling). The f32 kernel runs
on f32 FMA (67 TFLOP/s, ≥1.72 ms): a register-blocked FFMA implicit GEMM
over tiles of 8 conv rows × 32 columns, each building its x1 halo tile
once in shared memory (tests/test_torch_vgg_block1_f32.py mirrors it).

The backward (kernel 3) replaces ``_bwd_kernel``: from the forward's
uint8 pool argmax and g = dL/d(out) it computes dW1, db1, dW2, db2 with
conv1 recomputed, and NO input gradient (``_zero_input_cotangent``,
vgg_fused.py:455-468: the featurizer upstream has no parameters; the
front end detaches the spectrogram). Numerics of vgg_fused.py:238-285:
dy2 is rounded to cdt, products of cdt values sum in f32, dW1 takes dx1
rounded to cdt. Bound (B=12, F=161, T=800; dW2 at the pool's positions,
dx1, dW1 and conv1 at the image's): 230.8 GFLOP, 0.233 ms on the bf16
tensor cores, 3.44 ms on f32 FMA. The bf16 kernel is one fused pass
over work items (utterance, conv row pair, 64 columns): x1 and dy2 built
once per item into shared memory, dW2, dx1 and dW1 on the tensor cores
(tests/test_torch_vgg_block1.py mirrors its tiling). The f32 backward is
three kernels, its products on the forward's FFMA tiles, dy2 formed from
g, out and idx where a tile is staged and x1 recomputed where it is
needed: dW2 with db2 (whose blocks first transpose W2 for dx1), dx1 (the
transposed conv2 over all F rows, masked by x1 > 0, dW1 and db1 summed),
each over SPLITS fixed ranges, then the ranges added in order
(tests/test_torch_vgg_block1_f32.py mirrors them); its scratch
(`bwd_scratch`) holds the partial sums and W2 transposed.

`vgg_block1` / `vgg_block1_bwd` take the plain version only for a CPU
tensor; for a CUDA tensor they launch the kernel, and raise if they
cannot. The training slice needs the pool argmax: pass ``idx_out``, a
uint8 tensor of the output's shape, and it is filled (`VggBlock1` does).
The serving path passes none.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as Fn

from end2end_asr_tpu_torch.ops import cuda_lib

C = 64

# the source of each compute dtype's entries
SOURCES = {torch.float32: "vgg_block1_f32", torch.bfloat16: "vgg_block1"}

_KERNELS = {
    dt: cuda_lib.CudaKernel(
        SOURCES[dt], sym, [cuda_lib.P] * 7 + [cuda_lib.I] * 3
        + [cuda_lib.P])
    for dt, sym in ((torch.float32, "vgg_block1_fwd_f32"),
                    (torch.bfloat16, "vgg_block1_fwd_bf16"))}


_BWD_KERNELS = {
    dt: cuda_lib.CudaKernel(SOURCES[dt], sym,
                            [cuda_lib.P] * 9 + [cuda_lib.I] * 3
                            + [cuda_lib.P])
    for dt, sym in ((torch.float32, "vgg_block1_bwd_f32"),
                    (torch.bfloat16, "vgg_block1_bwd_bf16"))}
# rows of the backward's partial sums (csrc/vgg_block1.cu: FUSED_BLOCKS
# persistent blocks of the bf16 pass; csrc/vgg_block1_f32.cu: SPLITS fixed
# ranges)
BWD_BLOCKS = {torch.bfloat16: 132, torch.float32: 132}
PART = 9 * C + C + 9 * C * C + C       # floats of one block's partials


def bwd_scratch(cdt: torch.dtype, B: int, F: int, T: int) -> int:
    """Floats of the backward's scratch (its `part` argument) at x (B, F,
    T): the rows of partial sums and, at f32, W2 transposed (tap, co, ci)
    after them."""
    return BWD_BLOCKS[cdt] * PART + (9 * C * C if cdt == torch.float32
                                     else 0)


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
                or idx_out.device != spect.device
                or idx_out.data_ptr() % 16):
            raise ValueError("vgg_block1: idx_out must be a contiguous, "
                             f"16-byte aligned uint8 {tuple(out.shape)} "
                             f"tensor on {spect.device}")
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
    db2 (64,)), f64 at cdt float64 (a CPU reference, no kernel); x1 is
    recomputed as vgg_block1_plain computes it."""
    f32 = torch.promote_types(cdt, torch.float32)   # the sums' dtype
    B, F, T = spect.shape
    Fp, Tp = F // 2, T // 2
    x = spect.to(cdt)[:, None]                                # (B,1,F,T)
    x1 = torch.relu(Fn.conv2d(x, w1.to(cdt).permute(3, 2, 0, 1), padding=1)
                    + b1.to(cdt)[None, :, None, None])
    gm = torch.where(out.to(f32) > 0, g.to(cdt).to(f32),
                     torch.zeros((), dtype=f32, device=g.device))
    db2 = gm.sum(dim=(0, 1, 2))
    # route each pooled gradient to its window's argmax (window order
    # (0,0),(0,1),(1,0),(1,1)); an odd last row / column gets none
    sel = idx[..., None] == torch.arange(4, device=idx.device)
    dyw = torch.where(sel, gm[..., None], torch.zeros((), dtype=f32,
                                                      device=g.device))
    dy2 = (dyw.reshape(B, Fp, Tp, C, 2, 2).permute(0, 3, 1, 4, 2, 5)
           .reshape(B, C, 2 * Fp, 2 * Tp))
    dy2 = Fn.pad(dy2, (0, T - 2 * Tp, 0, F - 2 * Fp)).to(cdt).to(f32)
    x1f = x1.to(f32)
    w2f = w2.to(cdt).to(f32).permute(3, 2, 0, 1)              # (co,ci,3,3)
    dw2 = torch.nn.grad.conv2d_weight(x1f, w2f.shape, dy2, padding=1)
    dx1 = torch.nn.grad.conv2d_input(x1f.shape, w2f, dy2, padding=1)
    dx1 = torch.where(x1f > 0, dx1, torch.zeros((), dtype=f32,
                                                device=dx1.device))
    db1 = dx1.sum(dim=(0, 2, 3))
    dw1 = torch.nn.grad.conv2d_weight(x.to(f32), (C, 1, 3, 3),
                                      dx1.to(cdt).to(f32), padding=1)
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
    _aligned("vgg_block1_bwd", out, idx, g)
    # bf16: conv2's weight as bf16 in its natural (tap, ci, co) layout
    w2k = (w2.to(torch.bfloat16) if cdt == torch.bfloat16 else w2).contiguous()
    grads = torch.empty(PART, dtype=torch.float32, device=spect.device)
    part = torch.empty(bwd_scratch(cdt, B, F, T), dtype=torch.float32,
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


# ---------------------------------------------------------------------------
# Block 2 (kernels 7 and 8, csrc/vgg_block2.cu in bf16, csrc/vgg_block2_f32.cu
# in f32)
#
#   relu(maxpool2x2(conv4_SAME(relu(conv3_SAME(x) + b3))) + b4)
#
# Replaces ``end2end_asr_tpu/ops/vgg_fused.py::_fwd2_kernel`` and
# ``::_bwd2_kernel``. x is block 1's output as it stands, (B, F, T, 64)
# channels-last in cdt; out is (B, F//2, T//2, 128). The backward returns the
# input gradient too (block 1 consumes it). Rounding order: conv3's f32 sum
# rounds to cdt, + b3 in cdt, relu; conv4's sum rounds to cdt before the pool;
# best + b4 in cdt, relu. Positions outside the image are zero for conv4 (no
# relu(0 + b3) in the border). In the backward dx2 and dx are summed in f32
# and rounded once. Residuals: x, the weights, out and idx; x2 is recomputed.
#
# Bound on the H100 at x (12, 80, 400, 64): 169.9 GFLOP forward (0.172 ms on
# the bf16 tensor cores, 2.54 ms on f32 FMA), 339.7 GFLOP backward (0.343 ms /
# 5.07 ms). The bf16 forward is one persistent kernel on wgmma whose blocks
# walk down 100-column strips, each x2 row computed once a strip, the
# weights streamed in 16 KB stages packed by `_pack_fwd2`. The bf16 backward
# is two kernels: a pass of 8 channel groups x 16 persistent blocks walking
# down 40-column strips (the weight gradients' partial sums, dy3) and a
# persistent dx kernel on wgmma that also adds up the partials;
# tests/test_torch_vgg_block2.py mirrors the three bf16 decompositions. The
# f32 entries are a sequence of register-blocked FFMA implicit GEMMs with
# their intermediates in device memory: forward x2, then conv4 with the
# pool; backward x2, dy4, dy3, the weight gradients over SPLITS fixed K
# ranges, their sum in range order, dx (tests/test_torch_vgg_block2_f32.py
# mirrors their tiling).
# ---------------------------------------------------------------------------

C_IN2, C2 = 64, 128

# The JAX package's default (its ops/vgg_fused.py BLOCK2_ENABLED): the front
# end keeps the library convolutions for block 2 unless a test or the chip
# script sets this attribute. The reasons given there are measurements of the
# TPU's compiler and are not this card's; the card's own times are in PERF.md.
BLOCK2_ENABLED = False

# the f32 forward takes one more pointer, its x2 scratch
_FWD2_KERNELS = {
    dt: cuda_lib.CudaKernel(src, sym, [cuda_lib.P] * n + [cuda_lib.I] * 3
                            + [cuda_lib.P])
    for dt, src, sym, n in (
        (torch.float32, "vgg_block2_f32", "vgg_block2_fwd_f32", 8),
        (torch.bfloat16, "vgg_block2", "vgg_block2_fwd_bf16", 7))}
_BWD2_KERNELS = {
    dt: cuda_lib.CudaKernel(src, sym, [cuda_lib.P] * 12 + [cuda_lib.I] * 3
                            + [cuda_lib.P])
    for dt, src, sym in (
        (torch.float32, "vgg_block2_f32", "vgg_block2_bwd_f32"),
        (torch.bfloat16, "vgg_block2", "vgg_block2_bwd_bf16"))}
# rows of the backward's partial sums (csrc/vgg_block2.cu: RBLK row-walking
# blocks of each channel group in bf16; csrc/vgg_block2_f32.cu: SPLITS K
# ranges of the weight gradients)
BWD2_BLOCKS = {torch.bfloat16: 16, torch.float32: 132}
# activations of (B, F, T, 128) the f32 backward keeps in its scratch: x2,
# dy4, dy3 (the bf16 backward: dy3)
BWD2_SCRATCH = {torch.bfloat16: 1, torch.float32: 3}
DW3_SIZE, DW4_SIZE = 9 * C_IN2 * C2, 9 * C2 * C2
PART2 = DW3_SIZE + C2 + DW4_SIZE + C2           # floats of one block's partials


def launches2() -> int:
    """Launches of the block-2 forward kernel (both compute dtypes)."""
    return sum(k.launches for k in _FWD2_KERNELS.values())


def bwd2_launches() -> int:
    """Launches of the block-2 backward kernel (both compute dtypes)."""
    return sum(k.launches for k in _BWD2_KERNELS.values())


def reset_launches2() -> None:
    for k in (*_FWD2_KERNELS.values(), *_BWD2_KERNELS.values()):
        k.launches = 0


def supported2(F: int, T: int) -> bool:
    """Shapes (of block 2's input) the fused block 2 takes: even F and T,
    F >= 4. Other shapes go through the composite branch of the front end."""
    return F % 2 == 0 and T % 2 == 0 and F >= 4 and T >= 2


def _nchw(w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    return w.to(cdt).permute(3, 2, 0, 1)


def _x2_plain(x, w3, b3, cdt):
    """conv3 + b3 + relu of NHWC x, as NCHW in cdt."""
    y3 = Fn.conv2d(x.to(cdt).permute(0, 3, 1, 2), _nchw(w3, cdt), padding=1)
    return torch.relu(y3 + b3.to(cdt)[None, :, None, None])


def vgg_block2_plain(x: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                     w4: torch.Tensor, b4: torch.Tensor,
                     cdt: torch.dtype = torch.bfloat16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch block 2: x (B, F, T, 64) NHWC; w3 (3,3,64,128), w4
    (3,3,128,128) HWIO; b3/b4 (128,). Returns ((B, F//2, T//2, 128) in cdt,
    uint8 pool argmax of the same shape)."""
    y4 = Fn.conv2d(_x2_plain(x, w3, b3, cdt), _nchw(w4, cdt), padding=1)
    best, idx = pool2_first_wins(y4)
    out = torch.relu(best + b4.to(cdt)[None, :, None, None])
    return (out.permute(0, 2, 3, 1).contiguous(),
            idx.permute(0, 2, 3, 1).contiguous())


def vgg_block2_bwd_plain(x: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                         w4: torch.Tensor, out: torch.Tensor,
                         idx: torch.Tensor, g: torch.Tensor,
                         cdt: torch.dtype = torch.bfloat16):
    """Plain block-2 backward: out/idx/g (B, F//2, T//2, 128) NHWC from the
    forward. Returns (dx in cdt of x's shape, f32 dW3 (3,3,64,128), db3,
    dW4 (3,3,128,128), db4); x2 is recomputed as vgg_block2_plain computes
    it, dx2 and dx are summed in f32 and rounded once."""
    f32 = torch.float32
    B, F, T, _ = x.shape
    Fp, Tp = F // 2, T // 2
    zero = torch.zeros((), dtype=f32, device=x.device)
    x2f = _x2_plain(x, w3, b3, cdt).float()
    gm = torch.where(out.float() > 0, g.to(cdt).float(), zero)
    db4 = gm.sum(dim=(0, 1, 2))
    sel = idx[..., None] == torch.arange(4, device=idx.device)
    dyw = torch.where(sel, gm[..., None], zero)
    dy4 = (dyw.reshape(B, Fp, Tp, C2, 2, 2).permute(0, 3, 1, 4, 2, 5)
           .reshape(B, C2, 2 * Fp, 2 * Tp))
    dy4 = Fn.pad(dy4, (0, T - 2 * Tp, 0, F - 2 * Fp))
    w4f = _nchw(w4, cdt).float()
    dw4 = torch.nn.grad.conv2d_weight(x2f, w4f.shape, dy4, padding=1)
    dx2 = torch.nn.grad.conv2d_input(x2f.shape, w4f, dy4, padding=1)
    dy3 = torch.where(x2f > 0, dx2, zero).to(cdt).float()
    db3 = dy3.sum(dim=(0, 2, 3))
    xf = x.to(cdt).float().permute(0, 3, 1, 2)
    w3f = _nchw(w3, cdt).float()
    dw3 = torch.nn.grad.conv2d_weight(xf, w3f.shape, dy3, padding=1)
    dx = torch.nn.grad.conv2d_input(xf.shape, w3f, dy3, padding=1)
    return (dx.to(cdt).permute(0, 2, 3, 1).contiguous(),
            dw3.permute(2, 3, 1, 0).contiguous(), db3,
            dw4.permute(2, 3, 1, 0).contiguous(), db4)


def _check2(name, x, cdt, params, pooled=()):
    """Validate what the block-2 kernels read through raw pointers: x
    (B, F, T, 64) in cdt, `params` {name: (tensor, shape)} f32, `pooled`
    {name: (tensor, dtype)} of the output's shape; all on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if cdt not in _FWD2_KERNELS:
        raise ValueError(f"{name}: compute dtype {cdt} not supported")
    if x.dim() != 4 or x.shape[3] != C_IN2 or x.dtype != cdt:
        raise ValueError(f"{name}: x must be (B, F, T, {C_IN2}) in {cdt}")
    if not supported2(x.shape[1], x.shape[2]):
        raise ValueError(f"{name}: needs even F and T, F >= 4; got "
                         f"F={x.shape[1]}, T={x.shape[2]}")
    for nm, (t, shape) in params.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != x.device):
            raise ValueError(f"{name}: {nm} must be f32 {shape} on "
                             f"{x.device}")
    out_shape = (x.shape[0], x.shape[1] // 2, x.shape[2] // 2, C2)
    for nm, (t, dt) in pooled.items():
        if (tuple(t.shape) != out_shape or t.dtype != dt
                or t.device != x.device):
            raise ValueError(f"{name}: {nm} must be {dt} {out_shape} on "
                             f"{x.device}")


def _aligned(name, *tensors):
    """The kernels read and write 16 bytes at a time."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _layout(w: torch.Tensor, cdt: torch.dtype, t: bool) -> torch.Tensor:
    """The weight in cdt as "t" (tap, out, in) or "n" (tap, in, out), the
    two layouts of csrc/vgg_block2.cu."""
    w = w.to(cdt)
    return (w.permute(0, 1, 3, 2) if t else w).contiguous()


def _swizzle128(s: torch.Tensor) -> torch.Tensor:
    """(S, 128, 64) -> the same rows with their 16-byte chunks (8 bf16) in
    the 128-byte swizzle: chunk c of row r lands at c ^ (r % 8), as the
    kernel's shared-memory tiles hold it."""
    r = torch.arange(128, device=s.device)[:, None]
    src = torch.arange(8, device=s.device)[None, :] ^ (r % 8)   # (128, 8)
    v = s.reshape(s.shape[0], 128, 8, 8)
    return v.gather(2, src[None, :, :, None].expand(v.shape)).reshape(s.shape)


def _fwd2_stages(w3: torch.Tensor, w4: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 forward kernel's weight stages, in w3's and w4's dtype:
    W3 (3,3,64,128) HWIO as 9 stages (tap) of 128 conv3 channels x 64
    input channels, W4 (3,3,128,128) as 18 stages (tap, half of the 128
    input channels) of 128 output channels x 64; each row's chunks in the
    128-byte swizzle (`_swizzle128`), so a stage is copied into shared
    memory as it lies."""
    s3 = w3.reshape(9, C_IN2, C2).transpose(1, 2)
    s4 = w4.reshape(9, 2, C2 // 2, C2).permute(0, 1, 3, 2).reshape(
        18, C2, C2 // 2)
    return _swizzle128(s3), _swizzle128(s4)


@functools.lru_cache(maxsize=None)
def _fwd2_index(dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where each element of `_fwd2_stages` comes from in the flat w3, w4."""
    return tuple(i.reshape(-1).to(dev) for i in _fwd2_stages(
        torch.arange(9 * C_IN2 * C2).reshape(3, 3, C_IN2, C2),
        torch.arange(9 * C2 * C2).reshape(3, 3, C2, C2)))


def _pack_fwd2(w3: torch.Tensor, w4: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_fwd2_stages` of the weights in bf16, by one gather each (a cast
    and a gather a weight a call)."""
    i3, i4 = _fwd2_index(w3.device)
    return (w3.to(torch.bfloat16).reshape(-1).index_select(0, i3),
            w4.to(torch.bfloat16).reshape(-1).index_select(0, i4))


def vgg_block2(x: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
               w4: torch.Tensor, b4: torch.Tensor,
               cdt: torch.dtype = torch.bfloat16,
               idx_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused conv3+relu+conv4+pool+bias+relu. x (B, F, T, 64) NHWC in cdt;
    returns (B, F//2, T//2, 128) NHWC in cdt. Kernel 7 on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        out, idx = vgg_block2_plain(x, w3, b3, w4, b4, cdt)
        if idx_out is not None:
            idx_out.copy_(idx)
        return out
    _check2("vgg_block2", x, cdt,
            {"w3": (w3, (3, 3, C_IN2, C2)), "b3": (b3, (C2,)),
             "w4": (w4, (3, 3, C2, C2)), "b4": (b4, (C2,))},
            {} if idx_out is None else {"idx_out": (idx_out, torch.uint8)})
    if idx_out is not None and not idx_out.is_contiguous():
        raise ValueError("vgg_block2: idx_out must be contiguous")
    B, F, T, _ = x.shape
    out = torch.empty((B, F // 2, T // 2, C2), dtype=cdt, device=x.device)
    if out.numel() == 0:
        return out
    # the wgmma kernel reads the packed stages, the FMA kernels HWIO and
    # an x2 scratch
    if cdt == torch.bfloat16:
        w3k, w4k = _pack_fwd2(w3, w4)
        scratch = ()
    else:
        w3k, w4k = (_layout(w, cdt, False) for w in (w3, w4))
        x2 = torch.empty((B, F, T, C2), dtype=cdt, device=x.device)
        scratch = (x2.data_ptr(),)
    x, b3, b4 = x.contiguous(), b3.contiguous(), b4.contiguous()
    _aligned("vgg_block2", x, *((idx_out,) if idx_out is not None else ()))
    with torch.cuda.device(x.device):
        _FWD2_KERNELS[cdt].launch(
            x.data_ptr(), w3k.data_ptr(), b3.data_ptr(), w4k.data_ptr(),
            b4.data_ptr(), out.data_ptr(),
            idx_out.data_ptr() if idx_out is not None else None, *scratch,
            B, F, T, torch.cuda.current_stream().cuda_stream)
    return out


def vgg_block2_bwd(x: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                   w4: torch.Tensor, out: torch.Tensor, idx: torch.Tensor,
                   g: torch.Tensor, cdt: torch.dtype = torch.bfloat16):
    """Kernel 8 on CUDA tensors, the plain version on CPU tensors: (dx in
    cdt, f32 dW3, db3, dW4, db4) of the fused block 2."""
    if x.device.type == "cpu":
        return vgg_block2_bwd_plain(x, w3, b3, w4, out, idx, g, cdt)
    _check2("vgg_block2_bwd", x, cdt,
            {"w3": (w3, (3, 3, C_IN2, C2)), "b3": (b3, (C2,)),
             "w4": (w4, (3, 3, C2, C2))},
            {"out": (out, cdt), "g": (g, cdt), "idx": (idx, torch.uint8)})
    B, F, T, _ = x.shape
    x, b3, out, idx, g = (t.contiguous() for t in (x, b3, out, idx, g))
    _aligned("vgg_block2_bwd", x, out, idx, g)
    # the conv3 recompute reads the forward's layout, the two transposed
    # convolutions (dx2 from w4, dx from w3) the other one
    bf = cdt == torch.bfloat16
    w3c, w4d, w3d = (_layout(w3, cdt, bf), _layout(w4, cdt, not bf),
                     _layout(w3, cdt, not bf))
    dev = x.device
    scratch = torch.empty((BWD2_SCRATCH[cdt], B, F, T, C2), dtype=cdt,
                          device=dev)
    dx = torch.empty_like(x)
    grads = torch.empty(PART2, dtype=torch.float32, device=dev)
    part = torch.empty(BWD2_BLOCKS[cdt] * PART2, dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        _BWD2_KERNELS[cdt].launch(
            x.data_ptr(), w3c.data_ptr(), b3.data_ptr(), w4d.data_ptr(),
            w3d.data_ptr(), g.data_ptr(), out.data_ptr(), idx.data_ptr(),
            scratch.data_ptr(), dx.data_ptr(), part.data_ptr(),
            grads.data_ptr(),
            B, F, T, torch.cuda.current_stream().cuda_stream)
    o1, o2, o3 = DW3_SIZE, DW3_SIZE + C2, DW3_SIZE + C2 + DW4_SIZE
    return (dx, grads[:o1].view(3, 3, C_IN2, C2), grads[o1:o2],
            grads[o2:o3].view(3, 3, C2, C2), grads[o3:])


class VggBlock2(torch.autograd.Function):
    """vgg_block2 with the backward kernel: gradients for x, w3, b3, w4,
    b4."""

    @staticmethod
    def forward(ctx, x, w3, b3, w4, b4, cdt):
        B, F, T, _ = x.shape
        idx = torch.empty((B, F // 2, T // 2, C2), dtype=torch.uint8,
                          device=x.device)
        out = vgg_block2(x, w3, b3, w4, b4, cdt, idx_out=idx)
        ctx.cdt = cdt
        ctx.save_for_backward(x, w3, b3, w4, out, idx)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w3, b3, w4, out, idx = ctx.saved_tensors
        dx, dw3, db3, dw4, db4 = vgg_block2_bwd(
            x, w3, b3, w4, out, idx, g.to(ctx.cdt).contiguous(), ctx.cdt)
        return dx, dw3, db3, dw4, db4, None
