"""Transformer container (eval path): front end + encoder + decoder.

Port of the JAX package's ``models/transformer.py`` (reference:
models/asr/transformer.py:16-124, utils/functions.py:116-162). The params
are the JAX pytree ``{"frontend", "encoder", "decoder"}`` with tensors
for leaves. Greedy/beam decoding (decoding/) reuse `encode` and the
decoder's cached step.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from end2end_asr_tpu_torch.config import Config
from end2end_asr_tpu_torch.models import encoder as E
from end2end_asr_tpu_torch.models import frontend as Fe
from end2end_asr_tpu_torch.models.layers import sinusoid_table

Params = Dict[str, object]


class ModelDims(NamedTuple):
    num_heads: int
    dim_key: int
    dim_value: int
    dim_model: int
    emb_trg_sharing: bool
    feat_extractor: str
    dtype: torch.dtype
    ref_compat_masks: bool


def dims_from_config(cfg: Config) -> ModelDims:
    return ModelDims(
        num_heads=cfg.num_heads, dim_key=cfg.dim_key,
        dim_value=cfg.dim_value, dim_model=cfg.dim_model,
        emb_trg_sharing=cfg.emb_trg_sharing,
        feat_extractor=cfg.feat_extractor,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        ref_compat_masks=cfg.ref_compat_masks)


def encoder_lengths(dims: ModelDims, src_lengths: torch.Tensor
                    ) -> torch.Tensor:
    """Lengths fed to the encoder masks. ref_compat_masks=True passes raw
    frame lengths like the reference (transformer.py:78), which makes the
    masks a no-op after conv subsampling; False gives the subsampled
    lengths."""
    if dims.ref_compat_masks or dims.feat_extractor != "vgg_cnn":
        return src_lengths
    return src_lengths // 4


@torch.inference_mode()
def encode(params: Params, spect: torch.Tensor, src_lengths: torch.Tensor,
           dims: ModelDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """spect: (B, F, T). Returns (enc_out (B, T', H) f32, enc_lengths)."""
    feats = Fe.apply_frontend(params.get("frontend"), spect,
                              dims.feat_extractor, dtype=dims.dtype)
    enc_lens = encoder_lengths(dims, src_lengths)
    enc_out = E.apply_encoder(params["encoder"], feats, enc_lens,
                              dims.num_heads, dims.dim_key, dims.dim_value,
                              dtype=dims.dtype)
    return enc_out, enc_lens


# ---------------------------------------------------------------------------
# Seeded random weights (for runs without a trained checkpoint)
# ---------------------------------------------------------------------------

def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def _xavier(g, shape, fan_in: int, fan_out: int) -> torch.Tensor:
    return _uniform(g, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def _dense(g, d_in: int, d_out: int, bias: bool = True,
           rank: int = 0) -> Params:
    if rank and 0 < rank < min(d_in, d_out):
        p = {"u": _xavier(g, (d_in, rank), d_in, rank),
             "v": _xavier(g, (rank, d_out), rank, d_out)}
    else:
        p = {"w": _xavier(g, (d_in, d_out), d_in, d_out)}
    if bias:
        p["b"] = _uniform(g, (d_out,), 1.0 / math.sqrt(d_in))
    return p


def _ln(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def _mha(g, cfg: Config, rank: int) -> Params:
    nh, dm = cfg.num_heads, cfg.dim_model
    return {"q": _dense(g, dm, nh * cfg.dim_key, rank=rank),
            "k": _dense(g, dm, nh * cfg.dim_key, rank=rank),
            "v": _dense(g, dm, nh * cfg.dim_value, rank=rank),
            "out": _dense(g, nh * cfg.dim_value, dm, rank=rank),
            "ln": _ln(dm)}


def _ffn(g, cfg: Config, rank: int) -> Params:
    return {"w1": _dense(g, cfg.dim_model, cfg.dim_inner, rank=rank),
            "w2": _dense(g, cfg.dim_inner, cfg.dim_model, rank=rank),
            "ln": _ln(cfg.dim_model)}


def _conv(g, c_in: int, c_out: int) -> Params:
    fan_in, fan_out = c_in * 9, c_out * 9
    return {"w": _xavier(g, (3, 3, c_in, c_out), fan_in, fan_out),
            "b": _uniform(g, (c_out,), 1.0 / math.sqrt(fan_in))}


def init_params(cfg: Config, num_vocab: int, g: torch.Generator) -> Params:
    """Random params with the JAX package's init_transformer structure,
    shapes and init laws (xavier-uniform weights, torch-default bias
    bounds, LayerNorm (1, 0)), drawn from `g`. The values differ from a
    JAX init of the same seed."""
    if cfg.feat_extractor == "emb_cnn":
        raise NotImplementedError("emb_cnn front end is not ported yet")
    rank = cfg.rank if cfg.rank > 0 else 0
    dm = cfg.dim_model
    params: Params = {
        "encoder": {
            "input_linear": _dense(g, cfg.conv_dim_input(), dm),
            "ln_input": _ln(dm),
            "layers": [{"self_attn": _mha(g, cfg, rank),
                        "ffn": _ffn(g, cfg, rank)}
                       for _ in range(cfg.num_layers)],
            "pe": sinusoid_table(cfg.src_max_len, dm),
        },
        "decoder": {
            "embedding": _xavier(g, (num_vocab, cfg.dim_emb), num_vocab,
                                 cfg.dim_emb),
            "layers": [{"self_attn": _mha(g, cfg, rank),
                        "enc_attn": _mha(g, cfg, rank),
                        "ffn": _ffn(g, cfg, rank)}
                       for _ in range(cfg.num_layers)],
            "pe": sinusoid_table(cfg.tgt_max_len + 1, dm),
        },
    }
    if not cfg.emb_trg_sharing:
        params["decoder"]["output_linear"] = {
            "w": _xavier(g, (dm, num_vocab), dm, num_vocab)}
    if cfg.feat_extractor == "vgg_cnn":
        params["frontend"] = {"conv1": _conv(g, 1, 64),
                              "conv2": _conv(g, 64, 64),
                              "conv3": _conv(g, 64, 128),
                              "conv4": _conv(g, 128, 128)}
    return params


def to_device(tree, device):
    """The param pytree with every leaf moved to `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def cast_dense_weights(params: Params, dtype: torch.dtype) -> Params:
    """The params with every encoder/decoder dense weight ("w", "u",
    "v" leaves) stored in the compute dtype, so the per-call casts in
    layers.dense are no-ops. Same values as casting at each call; the
    front-end convs, biases, LayerNorms, embedding and tables stay f32."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: (v.to(dtype) if k in ("w", "u", "v")
                        and isinstance(v, torch.Tensor) else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree
    return {k: (walk(v) if k in ("encoder", "decoder") else v)
            for k, v in params.items()}


def num_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(num_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(num_params(v) for v in tree)
    return tree.numel()
