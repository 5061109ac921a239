"""Shared set-up of the port's parity tests (tests/test_torch_*.py): a
small model configuration, JAX-initialised params, and their conversion
to the PyTorch port's param pytree through the weight bridge."""

import functools
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


# ---------------------------------------------------------------------------
# float64 references of the conv front ends. Their max pools and relu /
# 0..20 clips route the gradient by comparisons, and the f32 roundings of
# the spectrogram (~3e-6 on either package) and of the convolutions flip
# near-ties: a different element of a window or a clipped activation gets
# the gradient. So a front-end weight's f32 gradient may lie ~1e-3 of the
# leaf from the exact one on either package; in float64 the two packages
# agree.
# ---------------------------------------------------------------------------

def spect_f64(pcm, n_frames, cfg, T_out):
    """The JAX package's normalised log-spectrogram (ops/features.py
    batched_features on its f32 DFT bases) computed in float64:
    (B, F, T_out)."""
    from end2end_asr_tpu.ops.features import _dft_matrices
    cos, sin = (a.astype(np.float64)
                for a in _dft_matrices(cfg.n_fft, cfg.window))
    idx = (np.arange(T_out)[:, None] * cfg.hop_length
           + np.arange(cfg.n_fft)[None, :])
    frames = np.asarray(pcm, np.float64)[:, idx]
    spect = np.log1p(np.sqrt((frames @ cos) ** 2 + (frames @ sin) ** 2))
    n = np.asarray(n_frames)
    valid = (np.arange(T_out)[None, :] < n[:, None])[:, :, None]
    spect = spect * valid
    count = (n * cos.shape[1]).astype(np.float64)[:, None, None]
    mean = spect.sum(axis=(1, 2), keepdims=True) / count
    sq = ((spect - mean) ** 2 * valid).sum(axis=(1, 2), keepdims=True)
    std = np.sqrt(sq / np.maximum(count - 1.0, 1.0))
    spect = (spect - mean) / np.maximum(std, 1e-10) * valid
    return spect.transpose(0, 2, 1)


_COTANGENTS = {}


def feature_cotangent(loss_of, params, feats, *args):
    """dL/d(front-end output) of a JAX loss `loss_of(params, *args)` that
    runs the JAX transformer: its front-end call returns `feats` (f32,
    the front end's output) while the loss is differentiated. One
    compile for each `loss_of`."""
    from end2end_asr_tpu.models import transformer as JT
    fn = _COTANGENTS.get(loss_of)
    if fn is None:
        real = JT.F.apply_frontend

        def loss_of_feats(f, p, *a):
            JT.F.apply_frontend = lambda p, s, *_, **__: (f, s)
            try:
                return loss_of(p, *a)
            finally:
                JT.F.apply_frontend = real
        fn = _COTANGENTS[loss_of] = jax.jit(jax.grad(loss_of_feats))
    return np.asarray(fn(jax.numpy.asarray(feats), params, *args))


@functools.partial(jax.jit, static_argnames=("feat_extractor",))
def _jax_frontend_vjp(fe, st, spect, g, feat_extractor):
    from end2end_asr_tpu.models import frontend as JF
    _, vjp = jax.vjp(lambda p: JF.apply_frontend(
        p, st, spect, feat_extractor, train=True, dtype=spect.dtype)[0], fe)
    return vjp(g)[0]


def jax_frontend_grads_f64(fe, st, spect, g, feat_extractor):
    """The JAX front end's float64 weight gradients for cotangent g (the
    f32 front-end output's) on the float64 spectrogram, flat by
    "conv1::w" keys. `fe` / `st` are its params and state. ~5 s on the
    CPU at 4 x 161 x 48 (XLA's float64 convolutions)."""
    with jax.enable_x64(True):
        jnp = jax.numpy
        f64 = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        jg = _jax_frontend_vjp(f64(fe), st and f64(st), jnp.asarray(spect),
                               jnp.asarray(g, jnp.float32), feat_extractor)
        return {k: np.asarray(v) for k, v in flatten_tree(jg).items()}


def port_frontend_grads_f64(fe, st, spect, g, feat_extractor):
    """`jax_frontend_grads_f64` from the port's front end (its plain
    versions in float64)."""
    import torch
    from end2end_asr_tpu_torch.models import frontend as PF
    from end2end_asr_tpu_torch.training.checkpoint import flatten_params
    tree = {c: {n: torch.tensor(np.array(v), dtype=torch.float64,
                                requires_grad=True) for n, v in p.items()}
            for c, p in fe.items()}
    state = st and {c: {n: torch.tensor(np.array(v), dtype=torch.float64)
                        for n, v in p.items()} for c, p in st.items()}
    y, _ = PF.apply_frontend(tree, state, torch.from_numpy(spect),
                             feat_extractor, train=True, dtype=torch.float64)
    leaves = flatten_params(tree)
    got = torch.autograd.grad(y, list(leaves.values()),
                              torch.from_numpy(np.array(g)))
    return {k: v.numpy() for k, v in zip(leaves, got)}
