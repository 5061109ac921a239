"""Shared set-up of the port's parity tests (tests/test_torch_*.py): a
small model configuration, JAX-initialised params, and their conversion
to the PyTorch port's param pytree through the weight bridge."""

import jax
import numpy as np

from end2end_asr_tpu.config import Config
from end2end_asr_tpu.models.transformer import init_transformer
from end2end_asr_tpu.training.checkpoint import flatten_tree
from end2end_asr_tpu_torch.config import Config as TorchConfig
from end2end_asr_tpu_torch.training.checkpoint import params_from_jax


def small_config(rank=0, **kw):
    """2 layers, 4 heads, dim 64, vgg_cnn, f32 — the JAX side's
    --dtype float32 so both sides compute in full precision."""
    base = dict(num_layers=2, num_heads=4, dim_model=64, dim_key=16,
                dim_value=16, dim_inner=128, dim_emb=64,
                feat_extractor="vgg_cnn", dtype="float32",
                src_max_len=800, tgt_max_len=64, beam_width=3)
    if rank:
        base.update(model="LRTRFS", rank=rank)
    base.update(kw)
    return Config(**base)


def torch_config(cfg):
    """The same configuration as the port's Config."""
    return TorchConfig.from_dict(cfg.to_dict())


def jax_params(cfg, num_vocab, seed=0, eos_boost=0.0):
    """JAX init_transformer params. eos_boost > 0 shifts the decoder's
    last LayerNorm bias by 1 and adds eos_boost/dim_model to the output
    projection's EOS column, raising the EOS logit by about eos_boost,
    so that decodes end at varied steps."""
    params, _ = init_transformer(jax.random.PRNGKey(seed), cfg, num_vocab)
    if eos_boost:
        dec = params["decoder"]
        ln = dec["layers"][-1]["ffn"]["ln"]
        ln["bias"] = ln["bias"] + 1.0
        w = np.array(dec["output_linear"]["w"])
        w[:, 2] += eos_boost / cfg.dim_model
        dec["output_linear"]["w"] = jax.numpy.asarray(w)
    return params


def to_port(params):
    """JAX pytree → the port's pytree, through params_from_jax."""
    return params_from_jax({k: np.asarray(v)
                            for k, v in flatten_tree(params).items()})
