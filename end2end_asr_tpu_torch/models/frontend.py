"""Conv feature front end: `vgg_cnn`, or none.

Port of the JAX package's ``models/frontend.py`` (reference:
models/asr/transformer.py:32-53 construction, :70-76 apply + reshape).
Block 1 (conv1, relu, conv2, pool, bias, relu) is the fused kernel of
ops/vgg_fused.py. Block 2 (conv3, relu, conv4, pool, bias, relu) is
plain PyTorch convolution and max pooling, as the JAX package leaves it
to XLA (frontend.py:323-325). The bias and relu that precede each pool
run after it: max commutes with the monotone bias-add/relu.

The output feature order matches the reference's
`view(B, C*F', T').transpose(1,2)`: feature index = c * F' + f.
emb_cnn is not ported yet.

Training (`train=True`, frontend.py:253-325 of the JAX package): block 1
is the `VggBlock1` autograd function, whose backward kernel emits weight
gradients and NO input gradient, so the spectrogram is detached before
it (the JAX package's stop_gradient). Block 2's pool is `max_pool2` on
both paths; its backward is the pool kernel (ops/pool_vjp.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as Fn

from end2end_asr_tpu_torch.ops.pool_vjp import max_pool2
from end2end_asr_tpu_torch.ops.vgg_fused import VggBlock1, vgg_block1

Params = Dict[str, object]


def _conv_same(x: torch.Tensor, w: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """3x3 SAME convolution of NCHW x with an HWIO weight, in dtype."""
    return Fn.conv2d(x.to(dtype), w.to(dtype).permute(3, 2, 0, 1),
                     padding=1)


def apply_frontend(params: Optional[Params], spect: torch.Tensor,
                   feat_extractor: str,
                   dtype: torch.dtype = torch.bfloat16,
                   train: bool = False) -> torch.Tensor:
    """spect: (B, F, T) log-spectrogram → (B, T', H) f32. vgg_cnn gives
    H = (F//4)*128 at T' = T//4; no front end gives (B, T, F)."""
    if feat_extractor == "emb_cnn":
        raise NotImplementedError("emb_cnn front end is not ported yet")
    if feat_extractor != "vgg_cnn":
        return spect.transpose(1, 2)  # (transformer.py:74-76)

    c1, c2 = params["conv1"], params["conv2"]
    if train:
        x = VggBlock1.apply(spect.detach().contiguous(), c1["w"], c1["b"],
                            c2["w"], c2["b"], dtype)
    else:
        x = vgg_block1(spect.contiguous(), c1["w"], c1["b"], c2["w"],
                       c2["b"], dtype)                 # (B, F', T', 64) NHWC
    x = x.permute(0, 3, 1, 2)                          # NCHW view
    c3, c4 = params["conv3"], params["conv4"]
    x = torch.relu(_conv_same(x, c3["w"], dtype)
                   + c3["b"].to(dtype)[None, :, None, None])
    y = torch.relu(max_pool2(_conv_same(x, c4["w"], dtype))
                   + c4["b"].to(dtype)[None, :, None, None])
    # (B, C, F'', T'') -> (B, T'', C*F'') with feature = c*F'' + f
    B, C, Fq, Tq = y.shape
    return y.permute(0, 3, 1, 2).reshape(B, Tq, C * Fq).to(torch.float32)
