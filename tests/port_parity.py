"""Shared set-up of the port's parity tests (tests/test_torch_*.py): a
small model configuration, JAX-initialised params, and their conversion
to the PyTorch port's param pytree through the weight bridge."""

import importlib.util
import os

import jax
import numpy as np

from end2end_asr_tpu.config import Config, load_vocab
from end2end_asr_tpu.models.transformer import init_transformer
from end2end_asr_tpu.training.checkpoint import (flatten_tree,
                                                 save_checkpoint)
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


def corpus_checkpoint(root, seed=3, **cfg_kw):
    """The synthetic corpus of tests/synth.py under `root` and a
    JAX-initialised checkpoint of small_config (tgt_max_len 16,
    src_max_len 400, batch 2, overridden by cfg_kw) on its labels:
    (manifest, checkpoint base)."""
    from synth import make_corpus
    manifest, labels = make_corpus(root)
    kw = dict(labels_path=labels, tgt_max_len=16, src_max_len=400,
              batch_size=2)
    kw.update(cfg_kw)
    cfg = small_config(**kw)
    label2id, id2label = load_vocab(labels)
    params, state = init_transformer(jax.random.PRNGKey(seed), cfg,
                                     len(label2id))
    base = os.path.join(root, "ck")
    save_checkpoint(base, cfg, 1, params, None, state, label2id, id2label)
    return manifest, base


def root_cli(name):
    """The repo root's CLI script `name` (test, transcribe, lm_train) as
    a module, imported by path: the JAX package's entry points."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), name + ".py")
    spec = importlib.util.spec_from_file_location("root_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
