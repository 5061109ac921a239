"""Transformer encoder (eval path).

Port of the JAX package's ``models/encoder.py`` (reference:
models/asr/transformer.py:126-203). Input projection + LayerNorm +
additive sinusoidal positional encoding at the bottom
(transformer.py:172-173); per layer: post-LN self-attention → non-pad
mask multiply → conv-FFN → non-pad mask multiply.
"""

from __future__ import annotations

from typing import Dict

import torch

from end2end_asr_tpu_torch.models import layers as L

Params = Dict[str, object]


def apply_encoder(p: Params, x: torch.Tensor, input_lengths: torch.Tensor,
                  num_heads: int, dim_key: int, dim_value: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x: (B, T, dim_input) post-front-end features; input_lengths (B,).
    Lengths >= T mask nothing (the conv-front-end no-op quirk of the
    reference, see layers.non_pad_mask_from_lengths)."""
    B, T, _ = x.shape
    non_pad = L.non_pad_mask_from_lengths(input_lengths, T)
    self_attn_mask = L.attn_pad_mask_from_lengths(input_lengths, T, T)

    out = L.layer_norm(p["ln_input"], L.dense(p["input_linear"], x, dtype)
                       .to(torch.float32))
    out = out + p["pe"][None, :T]
    for lp in p["layers"]:
        out = L.mha(lp["self_attn"], out, out, out, num_heads, dim_key,
                    dim_value, mask=self_attn_mask, dtype=dtype)
        out = out * non_pad
        out = L.ffn(lp["ffn"], out, dtype=dtype)
        out = out * non_pad
    return out
