"""Transformer container: front end + encoder + decoder.

Port of the JAX package's ``models/transformer.py`` (reference:
models/asr/transformer.py:16-124, utils/functions.py:116-162). The params
are the JAX pytree ``{"frontend", "encoder", "decoder"}`` with tensors
for leaves. Greedy/beam decoding (decoding/) reuse `encode` and the
decoder's cached step; training runs `forward_state` (transformer.py:126-147
of the JAX package), whose encoder keeps gradients.

The model `state` (the emb_cnn batch norms' running statistics, {} for the
other front ends) is a tree beside the params, {"frontend": {...}}, as in
the JAX package. Training passes it in and gets the new one back
(`forward_state`); the evaluation paths (`encode`, `forward`) read it from
the params tree's "state" entry, where `with_state` puts it.

`ModelDims.pipeline` (--mesh-pipe > 1, JAX transformer.py:40-53) runs the
training and eval forwards (`forward_state`, `forward`) through the
pipeline of parallel/pp.py when a pipe layout is up: the front end on
stage 0 (the other stages take `spect` None and `spect_T`), the logits on
the last stage (None on the others). Serving (`encode`, the decoder's
cached step) never pipelines.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from end2end_asr_tpu_torch.config import Config
from end2end_asr_tpu_torch.models import decoder as D
from end2end_asr_tpu_torch.models import encoder as E
from end2end_asr_tpu_torch.models import frontend as Fe
from end2end_asr_tpu_torch.models.layers import DropoutRng, sinusoid_table
from end2end_asr_tpu_torch.parallel import pp

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
    dropout: float = 0.0
    remat: bool = False
    seq_parallel: bool = False
    # GPipe pipeline over the encoder/decoder layer stacks (parallel/pp.py;
    # active only under a pipe layout) and its microbatches (0: stages)
    pipeline: bool = False
    pipe_microbatches: int = 0


def dims_from_config(cfg: Config) -> ModelDims:
    return ModelDims(
        num_heads=cfg.num_heads, dim_key=cfg.dim_key,
        dim_value=cfg.dim_value, dim_model=cfg.dim_model,
        emb_trg_sharing=cfg.emb_trg_sharing,
        feat_extractor=cfg.feat_extractor,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        ref_compat_masks=cfg.ref_compat_masks, dropout=cfg.dropout,
        remat=cfg.remat, seq_parallel=cfg.seq_parallel,
        pipeline=cfg.mesh_pipe > 1, pipe_microbatches=cfg.pipe_microbatches)


def encoder_lengths(dims: ModelDims, src_lengths: torch.Tensor
                    ) -> torch.Tensor:
    """Lengths fed to the encoder masks. ref_compat_masks=True passes raw
    frame lengths like the reference (transformer.py:78), which makes the
    masks a no-op after conv subsampling; False gives the subsampled
    lengths."""
    if dims.ref_compat_masks or dims.feat_extractor not in ("vgg_cnn",
                                                            "emb_cnn"):
        return src_lengths
    if dims.feat_extractor == "vgg_cnn":
        return src_lengths // 4
    return (src_lengths + 20 - 11) // 2 + 1 - 11 + 1


def with_state(params: Params, state: Optional[Params]) -> Params:
    """The params tree with the model state under "state", for the
    evaluation paths."""
    return {**params, "state": state} if state else params


def encode_train(params: Params, state: Optional[Params],
                 spect: Optional[torch.Tensor], src_lengths: torch.Tensor,
                 dims: ModelDims, train: bool,
                 rng: Optional[DropoutRng] = None,
                 spect_T: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """`encode` that keeps gradients; `train` selects the front end's
    training kernels and batch statistics and, with `rng`, dropout.
    Returns (enc_out, enc_lengths, new state). Pipelined, the front end
    runs on stage 0 (the others take spect None and its frame count
    `spect_T`) and every stage gets the last stage's enc_out."""
    pipe = dims.pipeline and pp.active()
    feats, new_fe_state = None, None
    if pipe and not pp.first():
        T = Fe.frontend_out_time(dims.feat_extractor, spect_T)
    else:
        fe_state = state.get("frontend") if state else None
        feats, new_fe_state = Fe.apply_frontend(
            params.get("frontend"), fe_state, spect, dims.feat_extractor,
            train=train, dtype=dims.dtype)
        T = feats.shape[1]
    enc_lens = encoder_lengths(dims, src_lengths)
    enc_out = E.apply_encoder(params["encoder"], feats, enc_lens,
                              dims.num_heads, dims.dim_key, dims.dim_value,
                              dtype=dims.dtype, dropout_rate=dims.dropout,
                              rng=rng if train else None,
                              remat=dims.remat and train,
                              seq_par=dims.seq_parallel, pipe=pipe,
                              n_micro=dims.pipe_microbatches, T=T)
    if pipe:
        enc_out = pp.share_last(enc_out, (src_lengths.shape[0], T,
                                          dims.dim_model), src_lengths.device)
    new_state = dict(state or {})
    if new_fe_state:
        new_state["frontend"] = new_fe_state
    return enc_out, enc_lens, new_state


@torch.inference_mode()
def encode(params: Params, spect: torch.Tensor, src_lengths: torch.Tensor,
           dims: ModelDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """spect: (B, F, T). Returns (enc_out (B, T', H) f32, enc_lengths)."""
    return encode_train(params, params.get("state"), spect, src_lengths,
                        dims._replace(pipeline=False), train=False)[:2]


def forward_state(params: Params, state: Optional[Params],
                  spect: Optional[torch.Tensor], src_lengths: torch.Tensor,
                  targets: torch.Tensor, dims: ModelDims, train: bool = False,
                  rng: Optional[DropoutRng] = None,
                  spect_T: Optional[int] = None
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor, Params]:
    """Teacher-forced forward (transformer.py:59-85 of the reference):
    (pred logits (B, U, V) f32, gold (B, U), new state). `train` with
    `rng` turns on dropout; `dims.remat` checkpoints the layers in
    training. Pipelined, pred is the last stage's (None elsewhere)."""
    rng = rng if train else None
    enc_out, enc_lens, new_state = encode_train(
        params, state, spect, src_lengths, dims, train, rng, spect_T)
    seq_in, seq_out = D.preprocess_targets(targets)
    pred = D.apply_decoder(params["decoder"], seq_in, enc_out, enc_lens,
                           dims.num_heads, dims.dim_key, dims.dim_value,
                           dims.dim_model,
                           emb_trg_sharing=dims.emb_trg_sharing,
                           dropout_rate=dims.dropout, rng=rng,
                           dtype=dims.dtype, remat=dims.remat and train,
                           pipe=dims.pipeline and pp.active(),
                           n_micro=dims.pipe_microbatches)
    return pred, seq_out, new_state


def forward(params: Params, spect: Optional[torch.Tensor],
            src_lengths: torch.Tensor, targets: torch.Tensor,
            dims: ModelDims, train: bool = False,
            rng: Optional[DropoutRng] = None, spect_T: Optional[int] = None
            ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """`forward_state` with the state read from params["state"] and the
    new state dropped: (pred, gold)."""
    return forward_state(params, params.get("state"), spect, src_lengths,
                         targets, dims, train, rng, spect_T)[:2]


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


def _conv(g, c_in: int, c_out: int, kh: int = 3, kw: int = 3) -> Params:
    fan_in, fan_out = c_in * kh * kw, c_out * kh * kw
    return {"w": _xavier(g, (kh, kw, c_in, c_out), fan_in, fan_out),
            "b": _uniform(g, (c_out,), 1.0 / math.sqrt(fan_in))}


def init_params(cfg: Config, num_vocab: int, g: torch.Generator) -> Params:
    """Random params with the JAX package's init_transformer structure,
    shapes and init laws (xavier-uniform weights, torch-default bias
    bounds, LayerNorm (1, 0)), drawn from `g`. The values differ from a
    JAX init of the same seed. The model state that goes with them is
    `init_state(cfg)`."""
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
    elif cfg.feat_extractor == "emb_cnn":
        params["frontend"] = {"conv1": _conv(g, 1, 32, 41, 11),
                              "bn1": _ln(32),
                              "conv2": _conv(g, 32, 32, 21, 11),
                              "bn2": _ln(32)}
    return params


def init_state(cfg: Config) -> Params:
    """The model state of a fresh model: the emb_cnn batch norms' running
    statistics (mean 0, variance 1); {} for the other front ends."""
    if cfg.feat_extractor != "emb_cnn":
        return {}
    return {"frontend": {"bn1": Fe.init_bn_state(32),
                         "bn2": Fe.init_bn_state(32)}}


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
