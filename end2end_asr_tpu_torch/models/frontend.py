"""Conv feature front end: `vgg_cnn`, `emb_cnn`, or none.

Port of the JAX package's ``models/frontend.py`` (reference:
models/asr/transformer.py:32-53 construction, :70-76 apply + reshape).

vgg_cnn. Block 1 (conv1, relu, conv2, pool, bias, relu) is the fused
kernel of ops/vgg_fused.py. Block 2 (conv3, relu, conv4, pool, bias, relu)
has two branches, as frontend.py:281-325 of the JAX package:
  * `fused2` — when ``vgg_fused.BLOCK2_ENABLED`` is set and the shape is
    one the kernel takes (`supported2`): the fused block-2 kernel, reading
    block 1's channels-last output as it stands; its backward kernel gives
    the input gradient that block 1's backward consumes;
  * otherwise the composite: library convolutions and `max_pool2`, whose
    backward is the pool kernel (ops/pool_vjp.py).
The bias and relu that precede each pool run after it: max commutes with
the monotone bias-add/relu.

emb_cnn (frontend.py:203-223, :327-336): Conv2d(1→32, (41,11), stride
(2,2), padding (0,10)) → BatchNorm → Hardtanh(0,20) → Conv2d(32→32,
(21,11), stride (2,1)) → BatchNorm → Hardtanh(0,20). Plain PyTorch, as the
JAX package leaves it to XLA. The batch norms' running statistics are the
model `state` ({"bn1": {"mean", "var"}, "bn2": ...}): in training the
batch statistics over (B, F, T) normalise (biased variance) and the
running values move by BN_MOMENTUM towards them (unbiased variance); in
evaluation the running values normalise.

The output feature order matches the reference's
`view(B, C*F', T').transpose(1,2)`: feature index = c * F' + f.

Training (`train=True`): block 1 is the `VggBlock1` autograd function,
whose backward kernel emits weight gradients and NO input gradient, so the
spectrogram is detached before it (the JAX package's stop_gradient).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn

from end2end_asr_tpu_torch.ops import vgg_fused
from end2end_asr_tpu_torch.ops.pool_vjp import max_pool2
from end2end_asr_tpu_torch.parallel import mesh
from end2end_asr_tpu_torch.ops.vgg_fused import (VggBlock1, VggBlock2,
                                                 vgg_block1, vgg_block2)

Params = Dict[str, object]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _conv(x: torch.Tensor, p: Params, dtype: torch.dtype, stride=(1, 1),
          padding=(1, 1), bias: bool = True) -> torch.Tensor:
    """Convolution of NCHW x with an HWIO weight in dtype; the bias is
    added in dtype."""
    y = Fn.conv2d(x.to(dtype), p["w"].to(dtype).permute(3, 2, 0, 1),
                  stride=stride, padding=padding)
    return y + p["b"].to(dtype)[None, :, None, None] if bias else y


def init_bn_state(c: int) -> Params:
    return {"mean": torch.zeros(c), "var": torch.ones(c)}


class _SumOverRanks(torch.autograd.Function):
    """Sum over the data-parallel ranks: the forward all-reduces x, the
    backward all-reduces the gradient (each rank's loss reads the sum, so
    the sum's gradient is the ranks' summed gradients). Identity at world
    size 1."""

    @staticmethod
    def forward(ctx, x):
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_(g.clone())


def _bn(p: Params, s: Params, x: torch.Tensor,
        train: bool) -> Tuple[torch.Tensor, Params]:
    """Batch norm over (B, F, T) of NCHW x, per channel. In training the
    statistics are the GLOBAL batch's, as GSPMD computes them for the JAX
    package's sharded batch: the per-channel sum, then the sum of squared
    deviations from the global mean, each summed over the ranks
    (`_SumOverRanks`), over the global count; so every rank's running
    statistics move alike."""
    if train:
        dims = (0, 2, 3)
        n = x.shape[0] * x.shape[2] * x.shape[3] * mesh.data_size()
        # the sums travel in f32 at any dtype (f64 at f64)
        f32 = torch.promote_types(x.dtype, torch.float32)
        mean = (_SumOverRanks.apply(x.sum(dim=dims, dtype=f32))
                / n).to(x.dtype)
        d = x - mean[None, :, None, None]
        var = (_SumOverRanks.apply((d * d).sum(dim=dims, dtype=f32))
               / n).to(x.dtype)
        with torch.no_grad():
            unbiased = var * n / max(n - 1, 1)
            new_s = {"mean": (1 - BN_MOMENTUM) * s["mean"]
                     + BN_MOMENTUM * mean,
                     "var": (1 - BN_MOMENTUM) * s["var"]
                     + BN_MOMENTUM * unbiased}
    else:
        mean, var, new_s = s["mean"], s["var"], s
    c = lambda v: v[None, :, None, None]
    y = (x - c(mean)) * torch.rsqrt(c(var) + BN_EPS) * c(p["scale"]) \
        + c(p["bias"])
    return y, new_s


def frontend_out_time(feat_extractor: str, T: int) -> int:
    """Exact post-front-end time length for input length T."""
    if feat_extractor == "vgg_cnn":
        return T // 2 // 2
    if feat_extractor == "emb_cnn":
        return (T + 20 - 11) // 2 + 1 - 11 + 1
    return T


def _features(y: torch.Tensor) -> torch.Tensor:
    """(B, C, F', T') -> (B, T', C*F') f32 with feature = c*F' + f."""
    B, C, Fq, Tq = y.shape
    return y.permute(0, 3, 1, 2).reshape(B, Tq, C * Fq).to(torch.float32)


def apply_frontend(params: Optional[Params], state: Optional[Params],
                   spect: torch.Tensor, feat_extractor: str,
                   train: bool = False,
                   dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """spect: (B, F, T) log-spectrogram → ((B, T', H) f32, new state).
    vgg_cnn gives H = (F//4)*128 at T' = T//4; emb_cnn H = 672 at F = 161
    and T' = `frontend_out_time`; no front end gives (B, T, F)."""
    if feat_extractor not in ("vgg_cnn", "emb_cnn"):
        return spect.transpose(1, 2), state  # (transformer.py:74-76)

    if feat_extractor == "emb_cnn":
        x = _conv(spect[:, None], params["conv1"], dtype, (2, 2), (0, 10))
        x, s1 = _bn(params["bn1"], state["bn1"], x, train)
        x = x.clamp(0.0, 20.0)                            # Hardtanh(0, 20)
        x = _conv(x, params["conv2"], dtype, (2, 1), (0, 0))
        x, s2 = _bn(params["bn2"], state["bn2"], x, train)
        return _features(x.clamp(0.0, 20.0)), {"bn1": s1, "bn2": s2}

    c1, c2 = params["conv1"], params["conv2"]
    c3, c4 = params["conv3"], params["conv4"]
    if train:
        x = VggBlock1.apply(spect.detach().contiguous(), c1["w"], c1["b"],
                            c2["w"], c2["b"], dtype)
    else:
        x = vgg_block1(spect.contiguous(), c1["w"], c1["b"], c2["w"],
                       c2["b"], dtype)                 # (B, F', T', 64) NHWC
    if vgg_fused.BLOCK2_ENABLED and vgg_fused.supported2(x.shape[1],
                                                         x.shape[2]):
        block2 = VggBlock2.apply if train else vgg_block2
        y = block2(x, c3["w"], c3["b"], c4["w"], c4["b"], dtype)
        return _features(y.permute(0, 3, 1, 2)), state
    # x.permute is the NHWC block-1 output seen as NCHW: the convolutions
    # return channels-last tensors, and max_pool2's backward reads and
    # writes conv4's output in that layout with no copy
    x = torch.relu(_conv(x.permute(0, 3, 1, 2), c3, dtype))
    y = torch.relu(max_pool2(_conv(x, c4, dtype, bias=False))
                   + c4["b"].to(dtype)[None, :, None, None])
    return _features(y), state
