"""Weight-only int8 post-training quantisation for serving.

Port of the JAX package's ``models/quantize.py`` (a serving option with
no reference counterpart; the reference evaluates in f32). Every 2-D
dense weight of the encoder and decoder is stored as int8 with a
symmetric per-output-channel f32 scale, in the JAX package's leaves
{"q8": int8 (in, out), "scale": (out,) f32, "b"?}; ``layers.dense``,
``decoder.output_logits`` and ``decoder.fused_qkv_weights`` dispatch on
"q8" and dequantise at use.

Quantise on load (``test`` / ``transcribe`` ``--quantize-int8``), from
the checkpoint's f32 weights and BEFORE ``evaluation.prepare_params``
casts the dense weights to the compute dtype: scales taken from
bf16-rounded weights would differ from the JAX package's.
``cast_dense_weights`` touches only "w"/"u"/"v" leaves, so "q8" stays
int8 on the device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def quantize_dense(p: Params) -> Params:
    """{"w": (in, out), "b"?} → {"q8": int8, "scale": (out,) f32, "b"?}.

    Symmetric per output channel: scale_j = max|w[:, j]| / 127 (1 where
    the column is zero), q8 = round half to even of w / scale, as
    jnp.round, clipped to ±127."""
    w = p["w"].to(torch.float32)
    s = w.abs().amax(dim=0) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    out = {"q8": q, "scale": s}
    if "b" in p:
        out["b"] = p["b"]
    return out


def _walk(node):
    if isinstance(node, dict):
        w = node.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            return quantize_dense(node)
        return {k: _walk(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(v) for v in node]
    return node


def quantize_for_inference(params: Params) -> Params:
    """Every encoder/decoder dense weight quantised (q/k/v/out, ffn
    w1/w2, input_linear, output_linear). Embeddings, LayerNorms, the
    positional table and the conv front end stay f32. A tied output head
    (emb_trg_sharing) becomes a quantised output_linear, and the f32
    embedding stays for the input lookup. Low-rank ("u", "v") leaves stay
    as they are: their factors are already the compression."""
    out = dict(params)
    if "encoder" in out:
        out["encoder"] = _walk(out["encoder"])
    if "decoder" in out:
        dec = dict(out["decoder"])
        emb = dec.get("embedding")
        dec = _walk(dec)
        if emb is not None:
            dec["embedding"] = emb
            if "output_linear" not in dec:
                dec["output_linear"] = quantize_dense(
                    {"w": emb.to(torch.float32).T})
        out["decoder"] = dec
    return out
