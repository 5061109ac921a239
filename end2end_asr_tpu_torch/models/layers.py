"""Transformer building blocks (eval path), plain functions on tensors.

Port of the JAX package's ``models/layers.py``. Behavioral contract with
the reference (`models/common_layers.py`):
  * masks — get_non_pad_mask/get_attn_key_pad_mask
    (common_layers.py:28-64); the decoder's causal mask belongs to the
    training slice (inference decodes one position at a time),
  * sinusoidal positional encoding (common_layers.py:76-98),
  * multi-head attention with separate Q/K/V projection widths
    (num_heads*dim_key / num_heads*dim_value) and post-LN residual
    (common_layers.py:144-225), here on its eval path: matmul + masked
    softmax with -inf fill, as the JAX package's ``attn_core``,
  * position-wise FFN with kernel-1 Conv1d (common_layers.py:124-142) as
    two dense layers over the feature axis.

Params are the JAX package's pytree with tensors for leaves: nested
dicts (and lists for layer stacks) keyed exactly as there, so a JAX
checkpoint loads without renaming (training/checkpoint.py).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as Fn

Params = Dict[str, object]

LN_EPS = 1e-5  # torch nn.LayerNorm default


def dense(p: Params, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w + b, or the low-rank (x @ u) @ v + b when p holds "u"/"v"
    (Low-Rank Transformer, Winata et al. ICASSP 2020). Operands are cast
    to `dtype`; the bias is added in the product's dtype."""
    if dtype is not None:
        x = x.to(dtype)
    b = p.get("b")
    if "u" in p:
        u, v = p["u"], p["v"]
        if dtype is not None:
            u, v = u.to(dtype), v.to(dtype)
        w, x = v, x @ u
    else:
        w = p["w"] if dtype is None else p["w"].to(dtype)
    return Fn.linear(x, w.T, None if b is None else b.to(w.dtype))


def layer_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (biased variance, eps inside
    the rsqrt, as torch.nn.LayerNorm), returned in x's dtype."""
    y = Fn.layer_norm(x.to(torch.float32), x.shape[-1:], p["scale"],
                      p["bias"], LN_EPS)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Masks (reference: models/common_layers.py:28-74)
# ---------------------------------------------------------------------------

def non_pad_mask_from_lengths(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T, 1) float mask, 1.0 where t < length. Lengths larger than T
    mask nothing (common_layers.py:37-38) — which is what makes the
    post-conv encoder masks a no-op when raw frame lengths are passed."""
    t = torch.arange(T, device=lengths.device)[None, :]
    return (t < lengths[:, None]).to(torch.float32)[:, :, None]


def attn_pad_mask_from_lengths(lengths: torch.Tensor, T_k: int,
                               len_q: int) -> torch.Tensor:
    """(B, T_q, T_k) bool, True = masked key positions >= length
    (common_layers.py:57-64)."""
    t = torch.arange(T_k, device=lengths.device)[None, :]
    pad = t >= lengths[:, None]
    return pad[:, None, :].expand(lengths.shape[0], len_q, T_k)


# ---------------------------------------------------------------------------
# Sinusoidal positional encoding (common_layers.py:76-98)
# ---------------------------------------------------------------------------

def sinusoid_table(max_length: int, dim_model: int) -> torch.Tensor:
    """(max_length, dim_model) f32 table, identical layout to the
    reference buffer: even columns sin, odd columns cos."""
    position = np.arange(max_length, dtype=np.float32)[:, None]
    exp_term = np.exp(np.arange(0, dim_model, 2, dtype=np.float32)
                      * -(math.log(10000.0) / dim_model))
    pe = np.zeros((max_length, dim_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * exp_term)
    pe[:, 1::2] = np.cos(position * exp_term)
    return torch.from_numpy(pe)


# ---------------------------------------------------------------------------
# Multi-head attention, eval path (common_layers.py:144-225)
# ---------------------------------------------------------------------------

def mha(p: Params, query: torch.Tensor, key_: torch.Tensor,
        value: torch.Tensor, num_heads: int, dim_key: int, dim_value: int,
        mask: Optional[torch.Tensor] = None,
        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Post-LN residual MHA. query/key_/value: (B, T, H). mask: (B, T_q,
    T_k) bool, True = masked (-inf before the softmax). The projections
    and both attention products run in `dtype`; the softmax and the
    residual/LayerNorm run in float32."""
    B, Tq, _ = query.shape
    Tk = key_.shape[1]
    residual = query
    q = dense(p["q"], query, dtype).reshape(B, Tq, num_heads, dim_key)
    k = dense(p["k"], key_, dtype).reshape(B, Tk, num_heads, dim_key)
    v = dense(p["v"], value, dtype).reshape(B, Tk, num_heads, dim_value)

    scale = 1.0 / math.sqrt(dim_key)  # temperature = sqrt(dim_key)
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if mask is not None:
        attn = attn.masked_fill(mask[:, None, :, :], float("-inf"))
    attn = torch.softmax(attn, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    out = out.reshape(B, Tq, num_heads * dim_value)
    out = dense(p["out"], out.to(dtype), dtype).to(torch.float32)
    return layer_norm(p["ln"], out + residual)


# ---------------------------------------------------------------------------
# Position-wise FFN, conv-kernel-1 variant (common_layers.py:124-142)
# ---------------------------------------------------------------------------

def ffn(p: Params, x: torch.Tensor,
        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    residual = x
    h = torch.relu(dense(p["w1"], x, dtype))
    h = dense(p["w2"], h, dtype).to(torch.float32)
    return layer_norm(p["ln"], h + residual)
