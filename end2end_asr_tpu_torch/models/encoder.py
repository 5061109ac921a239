"""Transformer encoder.

Port of the JAX package's ``models/encoder.py`` (reference:
models/asr/transformer.py:126-203). Input projection + LayerNorm +
additive sinusoidal positional encoding at the bottom
(transformer.py:172-173); per layer: post-LN self-attention → non-pad
mask multiply → conv-FFN → non-pad mask multiply. In training
(`rng` given) with dropout, as encoder.py:48-135 of the JAX package;
`remat` checkpoints each layer (encoder.py:123-124). Under tensor
parallelism the layers run this rank's shard (parallel/tp.py); with
`seq_par` (sequence parallelism, encoder.py:82-83, :134) the residual
stream between the products runs on this rank's slice of the time axis,
and the output is whole again. Pipeline parallelism is not ported
(ROADMAP).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from end2end_asr_tpu_torch.models import layers as L
from end2end_asr_tpu_torch.parallel import tp

Params = Dict[str, object]


def apply_encoder(p: Params, x: torch.Tensor, input_lengths: torch.Tensor,
                  num_heads: int, dim_key: int, dim_value: int,
                  dtype: torch.dtype = torch.bfloat16,
                  dropout_rate: float = 0.0,
                  rng: Optional[L.DropoutRng] = None,
                  remat: bool = False, seq_par: bool = False
                  ) -> torch.Tensor:
    """x: (B, T, dim_input) post-front-end features; input_lengths (B,).
    Lengths >= T mask nothing (the conv-front-end no-op quirk of the
    reference, see layers.non_pad_mask_from_lengths). `rng` turns on
    training dropout. The positional table gets no gradient."""
    B, T, _ = x.shape
    non_pad = L.non_pad_mask_from_lengths(input_lengths, T)
    self_attn_mask = L.attn_pad_mask_from_lengths(input_lengths, T, T)
    self_attn_bias = L.train_attn_bias(self_attn_mask, dropout_rate, rng)

    out = L.layer_norm(p["ln_input"], L.dense(p["input_linear"], x, dtype)
                       .to(torch.float32))
    out = out + p["pe"].detach()[None, :T]
    seq = seq_par and tp.active()
    if seq:
        tp.check_seq_divisible(T)
        out = tp.split_seq(out)
        lo, _ = tp.seq_rows(out.shape[1])
        non_pad = non_pad[:, lo:lo + out.shape[1]]

    def layer(lp, out):
        out = L.mha(lp["self_attn"], out, out, out, num_heads, dim_key,
                    dim_value, mask=self_attn_mask, dtype=dtype,
                    dropout_rate=dropout_rate, rng=rng, bias=self_attn_bias,
                    seq=seq)
        out = out * non_pad
        out = L.ffn(lp["ffn"], out, dtype=dtype, dropout_rate=dropout_rate,
                    rng=rng, seq=seq)
        return out * non_pad

    for lp in p["layers"]:
        if remat:
            out = L.remat(lambda o, lp=lp: layer(lp, o), rng, out)
        else:
            out = layer(lp, out)
    return tp.gather_seq(out) if seq else out
