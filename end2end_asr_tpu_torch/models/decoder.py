"""Transformer decoder: KV-cached single-step decode (inference).

Port of the JAX package's ``models/decoder.py`` decode path (reference:
models/asr/transformer.py:206-305, :316-517). Inference quirks kept
exactly, as the reference runs them (transformer.py:336-348,430-443):
non-pad mask of ones, NO cross-attention mask, dropout off — so the
cached step equals a full-prefix recompute. The embedding is scaled by
x_logit_scale = dim_model**-0.5 when the output projection is tied to it
(emb_trg_sharing), else 1. (The training forward, with its EOS-as-pad
masks and double-SOS preprocess, belongs to the training slice.)

The caches are updated IN PLACE (one position written per step), where
the JAX package returns new arrays: the step writes position t of the
self-attention K/V rings and reads positions 0..t.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from end2end_asr_tpu_torch.models import layers as L

Params = Dict[str, object]


def logit_scale(dim_model: int, emb_trg_sharing: bool) -> float:
    return dim_model ** -0.5 if emb_trg_sharing else 1.0


def output_logits(p: Params, h: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Bias-free output projection; tied to the embedding when sharing."""
    if "output_linear" in p:
        w = p["output_linear"]["w"]
    else:
        w = p["embedding"].T
    return (h.to(dtype) @ w.to(dtype)).to(torch.float32)


def fused_qkv_weights(p: Params, dtype: torch.dtype = torch.bfloat16):
    """Per-layer fused self-attention projection [Wq‖Wk‖Wv] so the step
    issues one product instead of three. None for low-rank layers."""
    fused = []
    for lp in p["layers"]:
        sa = lp["self_attn"]
        if "w" not in sa["q"]:
            fused.append(None)
            continue
        b = torch.cat([sa["q"]["b"], sa["k"]["b"], sa["v"]["b"]])
        w = torch.cat([sa["q"]["w"], sa["k"]["w"], sa["v"]["w"]],
                      dim=1).to(dtype)
        fused.append({"w": w, "b": b})
    return fused


def init_cache(p: Params, enc_out: torch.Tensor, max_len: int,
               num_heads: int, dim_key: int, dim_value: int,
               dtype: torch.dtype = torch.bfloat16,
               beam_W: Optional[int] = None) -> List[Dict[str, torch.Tensor]]:
    """Per-layer cross K/V from the encoder output, fused self-attention
    QKV weights, and zeroed self-attention K/V rings. enc_out: (B, T, H).

    beam_W: beam layout — self K/V (B, nh, W, L, d) slot-local rings and
    cross K/V (B, nh, T, d) shared by an utterance's beams (enc_out is
    the unreplicated (B_utt, T, H))."""
    B, T_enc = enc_out.shape[0], enc_out.shape[1]
    dev = enc_out.device
    fused = fused_qkv_weights(p, dtype)
    cache = []
    for lp, wqkv in zip(p["layers"], fused):
        k_cross = L.dense(lp["enc_attn"]["k"], enc_out, dtype).reshape(
            B, T_enc, num_heads, dim_key)
        v_cross = L.dense(lp["enc_attn"]["v"], enc_out, dtype).reshape(
            B, T_enc, num_heads, dim_value)
        if beam_W:
            entry = {
                "k_self": torch.zeros(
                    (B, num_heads, beam_W, max_len, dim_key), dtype=dtype,
                    device=dev),
                "v_self": torch.zeros(
                    (B, num_heads, beam_W, max_len, dim_value), dtype=dtype,
                    device=dev),
                "k_cross": k_cross.transpose(1, 2).contiguous(),
                "v_cross": v_cross.transpose(1, 2).contiguous(),
            }
        else:
            entry = {
                "k_self": torch.zeros((B, max_len, num_heads, dim_key),
                                      dtype=dtype, device=dev),
                "v_self": torch.zeros((B, max_len, num_heads, dim_value),
                                      dtype=dtype, device=dev),
                "k_cross": k_cross,
                "v_cross": v_cross,
            }
        if wqkv is not None:
            entry["wqkv"] = wqkv
        cache.append(entry)
    return cache


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            dim_key: int) -> torch.Tensor:
    """q: (B, nh, dk); k/v: (B, Tk, nh, d), every key attended."""
    scale = 1.0 / math.sqrt(dim_key)
    attn = torch.einsum("bhd,bkhd->bhk", q, k).to(torch.float32) * scale
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", attn.to(k.dtype), v
                        ).to(torch.float32)


def _attend_beam(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dim_key: int, t: int, W: int,
                 anc: torch.Tensor) -> torch.Tensor:
    """Beam self-attention over SLOT-LOCAL caches via an ancestry table:
    the caches are never reordered. The key/value that beam row w needs
    at position l lives at slot anc[b, w, l] (the slot its ancestor held
    when position l was written); an index gather picks it.
      q: (B·W, nh, dk); k: (B, nh, W, L, dk); v: (B, nh, W, L, dv);
      anc: (B, W, L) int64 slots (entries at l > t are not read)."""
    scale = 1.0 / math.sqrt(dim_key)
    B, nh = k.shape[0], k.shape[1]
    dk, dv = k.shape[-1], v.shape[-1]
    n = t + 1
    sel = anc[:, None, :, :n, None]                       # (B,1,W,n,1)
    k_sel = torch.gather(k[:, :, :, :n], 2, sel.expand(B, nh, W, n, dk))
    v_sel = torch.gather(v[:, :, :, :n], 2, sel.expand(B, nh, W, n, dv))
    qs = q.reshape(B, W, nh, dk).transpose(1, 2)          # (B, nh, W, dk)
    s = torch.einsum("bhwd,bhwld->bhwl", qs, k_sel).to(torch.float32) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhwl,bhwld->bhwd", p.to(v.dtype), v_sel
                       ).to(torch.float32)
    return out.transpose(1, 2).reshape(B * W, nh, dv)


def _attend_cross_beam(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dim_key: int, W: int) -> torch.Tensor:
    """Beam cross-attention against per-utterance K/V.
    q: (B·W, nh, dk); k: (B, nh, T, dk); v: (B, nh, T, dv)."""
    scale = 1.0 / math.sqrt(dim_key)
    B, nh = k.shape[0], k.shape[1]
    dk, dv = k.shape[-1], v.shape[-1]
    qs = q.reshape(B, W, nh, dk).transpose(1, 2)          # (B, nh, W, dk)
    s = torch.einsum("bhwd,bhtd->bhwt", qs, k).to(torch.float32) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhwt,bhtd->bhwd", p.to(v.dtype), v
                       ).to(torch.float32)
    return out.transpose(1, 2).reshape(B * W, nh, dv)


def decode_step(p: Params, cache, token: torch.Tensor, t: int,
                num_heads: int, dim_key: int, dim_value: int,
                dim_model: int, emb_trg_sharing: bool = False,
                dtype: torch.dtype = torch.bfloat16,
                beam: Optional[Tuple[int, torch.Tensor]] = None
                ) -> torch.Tensor:
    """One decode step at position t. token: (B,) int64 ids.
    Returns logits (B, V) f32 and writes position t of the caches.

    beam=(W, anc) switches self-attention to the slot-local ancestry
    layout (_attend_beam): rows are B_utt·W beam slots."""
    B = token.shape[0]
    scale = logit_scale(dim_model, emb_trg_sharing)
    x = p["embedding"][token] * scale + p["pe"][t]  # (B, H) f32

    nk = num_heads * dim_key
    for lp, c in zip(p["layers"], cache):
        residual = x
        sa = lp["self_attn"]
        if "wqkv" in c:
            qkv = L.dense(c["wqkv"], x, dtype)
            q = qkv[:, :nk].reshape(B, num_heads, dim_key)
            k_t = qkv[:, nk:2 * nk].reshape(B, num_heads, dim_key)
            v_t = qkv[:, 2 * nk:].reshape(B, num_heads, dim_value)
        else:
            q = L.dense(sa["q"], x, dtype).reshape(B, num_heads, dim_key)
            k_t = L.dense(sa["k"], x, dtype).reshape(B, num_heads, dim_key)
            v_t = L.dense(sa["v"], x, dtype).reshape(B, num_heads,
                                                     dim_value)
        if beam is not None:
            W, anc = beam
            Bu = B // W
            c["k_self"][:, :, :, t] = k_t.reshape(Bu, W, num_heads,
                                                  dim_key).transpose(1, 2)
            c["v_self"][:, :, :, t] = v_t.reshape(Bu, W, num_heads,
                                                  dim_value).transpose(1, 2)
            out = _attend_beam(q, c["k_self"], c["v_self"], dim_key, t, W,
                               anc)
        else:
            c["k_self"][:, t] = k_t
            c["v_self"][:, t] = v_t
            out = _attend(q, c["k_self"][:, :t + 1], c["v_self"][:, :t + 1],
                          dim_key)
        out = out.reshape(B, num_heads * dim_value)
        out = L.dense(sa["out"], out.to(dtype), dtype).to(torch.float32)
        x = L.layer_norm(sa["ln"], out + residual)

        residual = x
        ea = lp["enc_attn"]
        q = L.dense(ea["q"], x, dtype).reshape(B, num_heads, dim_key)
        if beam is not None:
            out = _attend_cross_beam(q, c["k_cross"], c["v_cross"],
                                     dim_key, beam[0])
        else:
            out = _attend(q, c["k_cross"], c["v_cross"], dim_key)
        out = out.reshape(B, num_heads * dim_value)
        out = L.dense(ea["out"], out.to(dtype), dtype).to(torch.float32)
        x = L.layer_norm(ea["ln"], out + residual)

        x = L.ffn(lp["ffn"], x, dtype=dtype)

    return output_logits(p, x, dtype)
