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
and the output is whole again. With `pipe` (pipeline parallelism,
encoder.py:96-119) this stage's layers run on the microbatches through
parallel/pp.py `pipeline_apply`, with the constants (non_pad, the
self-attention mask and its bias); x is stage 0's alone and the output
the last stage's alone (None elsewhere).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from end2end_asr_tpu_torch.models import layers as L
from end2end_asr_tpu_torch.parallel import pp, tp

Params = Dict[str, object]


def apply_encoder(p: Params, x: Optional[torch.Tensor],
                  input_lengths: torch.Tensor, num_heads: int, dim_key: int,
                  dim_value: int, dtype: torch.dtype = torch.bfloat16,
                  dropout_rate: float = 0.0,
                  rng: Optional[L.DropoutRng] = None,
                  remat: bool = False, seq_par: bool = False,
                  pipe: bool = False, n_micro: int = 0,
                  T: Optional[int] = None) -> Optional[torch.Tensor]:
    """x: (B, T, dim_input) post-front-end features; input_lengths (B,).
    Lengths >= T mask nothing (the conv-front-end no-op quirk of the
    reference, see layers.non_pad_mask_from_lengths). `rng` turns on
    training dropout. The positional table gets no gradient. With `pipe`,
    x is None on the stages after the first and `T` gives its length."""
    T = x.shape[1] if x is not None else T
    non_pad = L.non_pad_mask_from_lengths(input_lengths, T)
    self_attn_mask = L.attn_pad_mask_from_lengths(input_lengths, T, T)
    self_attn_bias = L.train_attn_bias(self_attn_mask, dropout_rate, rng)

    out = None
    if x is not None:
        out = L.layer_norm(p["ln_input"], L.dense(p["input_linear"], x,
                                                  dtype).to(torch.float32))
        out = out + p["pe"].detach()[None, :T]

    def layer(lp, out, cs, r, seq=False):
        non_pad, mask, bias = cs
        out = L.mha(lp["self_attn"], out, out, out, num_heads, dim_key,
                    dim_value, mask=mask, dtype=dtype,
                    dropout_rate=dropout_rate, rng=r, bias=bias, seq=seq)
        out = out * non_pad
        out = L.ffn(lp["ffn"], out, dtype=dtype, dropout_rate=dropout_rate,
                    rng=r, seq=seq)
        return out * non_pad

    consts = (non_pad, self_attn_mask, self_attn_bias)
    if pipe:
        return pp.pipeline_apply(
            p["layers"], out, consts, layer, n_micro, remat, stack="encoder",
            shape=(input_lengths.shape[0], T, p["pe"].shape[1]), rng=rng,
            device=input_lengths.device)
    seq = seq_par and tp.active()
    if seq:
        tp.check_seq_divisible(T)
        out = tp.split_seq(out)
        lo, _ = tp.seq_rows(out.shape[1])
        consts = (non_pad[:, lo:lo + out.shape[1]], *consts[1:])
    for lp in p["layers"]:
        if remat:
            out = L.remat(lambda o, lp=lp: layer(lp, o, consts, rng, seq),
                          rng, out)
        else:
            out = layer(lp, out, consts, rng, seq)
    return tp.gather_seq(out) if seq else out
