"""The port's checkpoint tools against root `tools/`: averaging npz
checkpoints (bit for bit with the JAX `average_trees` on the same files)
and converting a reference-layout torch `.th` (the same tensors as the
JAX `convert_state_dict`; the converted checkpoint resumes in the port's
`train` with the Noam step carried)."""

import argparse
import os

import numpy as np
import pytest
import torch

from end2end_asr_tpu.training.checkpoint import flatten_tree
from end2end_asr_tpu.training.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from end2end_asr_tpu_torch import train as port_train
from end2end_asr_tpu_torch.config import Config, load_vocab
from end2end_asr_tpu_torch.models.transformer import init_params, init_state
from end2end_asr_tpu_torch.tools import average_checkpoints as PAV
from end2end_asr_tpu_torch.tools import convert_reference_checkpoint as PCV
from end2end_asr_tpu_torch.training.checkpoint import (flatten_params,
                                                       load_checkpoint,
                                                       save_checkpoint)
from tools import average_checkpoints as JAV
from tools import convert_reference_checkpoint as JCV

from synth import make_corpus

TINY = dict(num_layers=1, num_heads=2, dim_model=32, dim_key=16,
            dim_value=16, dim_inner=32, dim_emb=32, dtype="float32",
            src_max_len=64, tgt_max_len=8, batch_size=2)


def _save(base, cfg, seed, epoch, num_layers=None):
    c = cfg.replace(num_layers=num_layers) if num_layers else cfg
    g = torch.Generator().manual_seed(seed)
    state = init_state(c)
    for bn in state.get("frontend", {}).values():   # distinct statistics
        bn["mean"] = torch.rand(bn["mean"].shape, generator=g)
        bn["var"] = torch.rand(bn["var"].shape, generator=g) + 0.5
    vocab = {ch: i for i, ch in enumerate("¶§¤abc")}
    save_checkpoint(base, c, epoch, init_params(c, len(vocab), g), vocab,
                    {i: ch for ch, i in vocab.items()}, model_state=state,
                    metrics={"valid_loss": float(epoch)})
    return base


def test_average_equals_jax_and_rejects_mismatch(tmp_path):
    cfg = Config(feat_extractor="emb_cnn", **TINY)
    bases = [_save(str(tmp_path / f"e{i}"), cfg, seed=i, epoch=i)
             for i in (1, 2, 3)]
    out = str(tmp_path / "avg")
    PAV.main([out, *bases, "--device", "cpu"])

    def stream():
        for b in bases:
            _, _, params, _, state = jax_load_checkpoint(b)[:5]
            yield {"params": params, "state": state or {}}
    want = flatten_tree(JAV.average_trees(stream()))
    _, epoch, params, opt, state, _, _, metrics = load_checkpoint(out)
    got = flatten_params({"params": params, "state": state})
    assert sorted(got) == sorted(want) and any(k.startswith("state")
                                               for k in got)
    for k, v in got.items():
        assert v.dtype == torch.float32
        assert np.array_equal(v.numpy(), np.asarray(want[k])), k
    # metadata from the last checkpoint, no optimizer state
    assert epoch == 3 and opt is None and metrics["valid_loss"] == 3.0
    assert metrics["averaged_from"] == bases

    odd = _save(str(tmp_path / "odd"), cfg, seed=5, epoch=4, num_layers=2)
    with pytest.raises(ValueError, match="different parameter structures"):
        PAV.main([str(tmp_path / "bad"), bases[0], odd, "--device", "cpu"])
    with pytest.raises(SystemExit):
        PAV.main([out, bases[0], "--device", "cpu"])
    os.makedirs(str(tmp_path / "sharded.orbax"))
    with pytest.raises(NotImplementedError, match="orbax imports jax"):
        PAV.main([out, bases[0], str(tmp_path / "sharded"),
                  "--device", "cpu"])


def _reference_sd(cfg, n_vocab, seed):
    """A reference-layout state dict (the reference's module names,
    DataParallel's "module." prefix) with random values."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    dm, di = cfg.dim_model, cfg.dim_inner
    sd = {"encoder.input_linear.weight": r(dm, cfg.conv_dim_input()),
          "encoder.input_linear.bias": r(dm),
          "encoder.layer_norm_input.weight": r(dm),
          "encoder.layer_norm_input.bias": r(dm),
          "decoder.trg_embedding.weight": r(n_vocab, dm)}

    def mha(base):
        for name, (o, i) in (("query", (cfg.num_heads * cfg.dim_key, dm)),
                             ("key", (cfg.num_heads * cfg.dim_key, dm)),
                             ("value", (cfg.num_heads * cfg.dim_value, dm)),
                             ("output", (dm, cfg.num_heads * cfg.dim_value))):
            sd[f"{base}.{name}_linear.weight"] = r(o, i)
            sd[f"{base}.{name}_linear.bias"] = r(o)
        sd[f"{base}.layer_norm.weight"] = r(dm)
        sd[f"{base}.layer_norm.bias"] = r(dm)

    def ffn(base):
        sd[f"{base}.conv_1.weight"], sd[f"{base}.conv_1.bias"] = (
            r(di, dm, 1), r(di))
        sd[f"{base}.conv_2.weight"], sd[f"{base}.conv_2.bias"] = (
            r(dm, di, 1), r(dm))
        sd[f"{base}.layer_norm.weight"] = r(dm)
        sd[f"{base}.layer_norm.bias"] = r(dm)

    for n in range(cfg.num_layers):
        mha(f"encoder.layers.{n}.self_attn")
        ffn(f"encoder.layers.{n}.pos_ffn")
        mha(f"decoder.layers.{n}.self_attn")
        mha(f"decoder.layers.{n}.encoder_attn")
        ffn(f"decoder.layers.{n}.pos_ffn")
    if not cfg.emb_trg_sharing:
        sd["decoder.output_linear.weight"] = r(n_vocab, dm)
    convs = {"vgg_cnn": {"0": (64, 1, 3, 3), "2": (64, 64, 3, 3),
                         "5": (128, 64, 3, 3), "7": (128, 128, 3, 3)},
             "emb_cnn": {"0": (32, 1, 41, 11), "3": (32, 32, 21, 11)}}
    for k, shape in convs[cfg.feat_extractor].items():
        sd[f"conv.{k}.weight"], sd[f"conv.{k}.bias"] = r(*shape), r(shape[0])
    if cfg.feat_extractor == "emb_cnn":
        for k in ("1", "4"):
            sd[f"conv.{k}.weight"], sd[f"conv.{k}.bias"] = r(32), r(32)
            sd[f"conv.{k}.running_mean"] = r(32)
            sd[f"conv.{k}.running_var"] = r(32).abs()
            sd[f"conv.{k}.num_batches_tracked"] = torch.tensor(7)
    return {"module." + k: v for k, v in sd.items()}


@pytest.mark.parametrize("feat,sharing", [("vgg_cnn", False),
                                          ("vgg_cnn", True),
                                          ("emb_cnn", False),
                                          ("emb_cnn", True)])
def test_convert_state_dict_equals_jax(feat, sharing):
    cfg = Config(feat_extractor=feat, emb_trg_sharing=sharing, **TINY)
    sd = _reference_sd(cfg, 6, seed=11)
    args = (cfg.num_layers, feat, sharing, cfg.dim_model, cfg.src_max_len,
            cfg.tgt_max_len)
    want = flatten_tree(dict(zip(("params", "state"),
                                 JCV.convert_state_dict(sd, *args))))
    got = flatten_params(dict(zip(("params", "state"),
                                  PCV.convert_state_dict(sd, *args))))
    assert sorted(got) == sorted(want)
    assert ("params::decoder::output_linear::w" in got) != sharing
    assert any(k.startswith("state") for k in got) == (feat == "emb_cnn")
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.dtype == torch.float32 and v.shape == w.shape, k
        assert np.array_equal(v.numpy(), w), k


def test_converted_checkpoint_resumes_with_noam_step(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    manifest, labels = make_corpus(str(tmp_path / "c"))
    label2id, id2label = load_vocab(labels)
    cfg = Config(feat_extractor="vgg_cnn", labels_path=labels, **TINY)
    th = str(tmp_path / "ref.th")
    torch.save({"label2id": label2id, "id2label": id2label,
                "args": argparse.Namespace(**cfg.to_dict()), "epoch": 3,
                "model_state_dict": _reference_sd(cfg, len(label2id), 12),
                "optimizer_state_dict": {},
                "optimizer_params": {"_step": 1234, "_rate": 3e-4,
                                     "warmup": 4000, "factor": 1.0,
                                     "model_size": 32},
                "metrics": {"valid_loss": 2.5}}, th)
    out = PCV.main([th, str(tmp_path / "conv"), "--device", "cpu"])
    c2, epoch, _, opt, _, l2i, _, metrics = load_checkpoint(out)
    assert (epoch, opt, metrics["noam_step"]) == (3, None, 1234)
    assert c2.feat_extractor == "vgg_cnn" and l2i == label2id
    res = port_train.main([
        "--train-manifest-list", manifest, "--valid-manifest-list",
        manifest, "--labels-path", labels, "--name", "r", "--save-folder",
        "models", "--continue-from", out, "--epochs", "4", "--batch-size",
        "2", "--device", "cpu"])
    assert res["epochs_run"] == 1 and res["opt_step"] == 1234 + 2
