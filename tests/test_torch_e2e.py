"""Port parity end to end, and the port's isolation from JAX.

A tiny synthetic corpus and a JAX-initialised checkpoint: the port's
`test` entry point (`--device cpu`) gives the same CER/WER dict and the
same hypothesis strings as the JAX package's `evaluate()`, greedy and
beam; the port's `transcribe` agrees. Then: every module of the port
imports without JAX or any module of the JAX package, and the entry
points refuse to run on the CPU unless asked to.
"""

import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from end2end_asr_tpu.config import load_vocab
from end2end_asr_tpu.data.dataset import ManifestDataset
from end2end_asr_tpu.data.loader import AudioBatchLoader, BucketingSampler
from end2end_asr_tpu.evaluation import evaluate
from end2end_asr_tpu.models.transformer import init_transformer
from end2end_asr_tpu.training.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from end2end_asr_tpu_torch import test as port_test
from end2end_asr_tpu_torch import transcribe as port_transcribe
from end2end_asr_tpu_torch.config import Config as TorchConfig
from end2end_asr_tpu_torch.data import dataset as port_dataset
from end2end_asr_tpu_torch.data import loader as port_loader

from port_parity import small_config
from synth import make_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_e2e"))
    manifest, labels = make_corpus(root)
    cfg = small_config(labels_path=labels, tgt_max_len=16, src_max_len=400,
                       batch_size=2)
    label2id, id2label = load_vocab(labels)
    params, state = init_transformer(jax.random.PRNGKey(3), cfg,
                                     len(label2id))
    base = os.path.join(root, "ck")
    save_checkpoint(base, cfg, 1, params, None, state, label2id, id2label)
    return manifest, base


def _hyps(caplog, logger):
    return [r.getMessage().split("HYP: ", 1)[1].split(" || GOLD: ")[0]
            for r in caplog.records
            if r.name == logger and r.getMessage().startswith("HYP: ")]


@pytest.mark.parametrize("beam", [False, True])
def test_evaluate_matches_jax(corpus, caplog, beam):
    manifest, base = corpus
    cfg, _, params, _, state, label2id, id2label = load_checkpoint(base)[:7]
    cfg = cfg.replace(test_manifest_list=(manifest,), batch_size=2,
                      beam_search=beam, beam_width=3)
    data = ManifestDataset([manifest], label2id)
    loader = AudioBatchLoader(data, cfg, sampler=BucketingSampler(
        len(data), 2, seed=cfg.seed))
    caplog.set_level(logging.INFO)
    want = evaluate(params, state, cfg, loader, id2label, verbose=True)
    want_hyps = _hyps(caplog, "end2end_asr_tpu")

    argv = ["--continue-from", base, "--test-manifest-list", manifest,
            "--batch-size", "2", "--device", "cpu", "--verbose"]
    if beam:
        argv += ["--beam-search", "--beam-width", "3"]
    got = port_test.main(argv)
    got_hyps = _hyps(caplog, "end2end_asr_tpu_torch")
    assert got == want
    assert got_hyps == want_hyps and len(got_hyps) == 4
    assert any(got_hyps)  # the random model does emit characters

    if not beam:
        # single-file entry: every utterance here falls in one bucket,
        # so its hypothesis is the batch evaluation's
        with open(manifest) as f:
            wavs = [ln.split(",")[0] for ln in f if ln.strip()]
        lines = port_transcribe.main(["--continue-from", base, *wavs,
                                      "--device", "cpu"])
        order = list(BucketingSampler(len(data), 2, seed=cfg.seed))
        by_idx = dict(zip([i for b in order for i in b], want_hyps))
        assert lines == [f"{w}\t{by_idx[i].strip()}"
                         for i, w in enumerate(wavs)]


@pytest.mark.parametrize("wire,pad_to_full", [("int16", False),
                                               ("float32", True)])
def test_loader_batches_equal_jax(corpus, wire, pad_to_full):
    """The port's loader gives the JAX loader's batches: PCM on the wire,
    frames, bucket, targets and, with pad_to_full, the cycled ragged bin
    (4 utterances in bins of 3)."""
    manifest, base = corpus
    cfg, _, _, _, _, label2id, _ = load_checkpoint(base)[:7]
    cfg = cfg.replace(batch_size=3, pcm_wire_dtype=wire)
    tcfg = TorchConfig.from_dict(cfg.to_dict())
    want_loader = AudioBatchLoader(
        ManifestDataset([manifest], label2id), cfg,
        sampler=BucketingSampler(4, 3, seed=5))
    got_loader = port_loader.AudioBatchLoader(
        port_dataset.ManifestDataset([manifest], label2id), tcfg,
        sampler=port_loader.BucketingSampler(4, 3, seed=5))
    want_loader.pad_to_full = got_loader.pad_to_full = pad_to_full
    want, got = list(want_loader), list(got_loader)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.pcm.dtype == w.pcm.dtype == np.dtype(wire)
        np.testing.assert_array_equal(g.pcm, w.pcm)
        np.testing.assert_array_equal(g.n_frames, w.n_frames)
        np.testing.assert_array_equal(g.targets, w.targets)
        assert (g.src_bucket, g.real_rows) == (w.src_bucket, w.real_rows)
    assert len(got[1].pcm) == (3 if pad_to_full else 1)


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, pulls
    in neither jax nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import end2end_asr_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "        pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'end2end_asr_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


@pytest.mark.parametrize("entry", ["test", "transcribe"])
def test_entry_points_raise_without_gpu(corpus, monkeypatch, entry):
    manifest, base = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "test":
            port_test.main(["--continue-from", base,
                            "--test-manifest-list", manifest])
        else:
            port_transcribe.main(["--continue-from", base, "x.wav"])
