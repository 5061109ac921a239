"""Joint training: the port's Trainer / MultiTrainer validation hooks
against the JAX package's on the same losses (log lines, best-model key,
metrics), and one run of the port's `multi_train` entry point on the CPU
with two tasks, --augment and --noise-dir."""

import json
import logging
import os
import re

import numpy as np
import pytest

from end2end_asr_tpu.data.audio import save_wav
from end2end_asr_tpu.training import trainer as JT
from end2end_asr_tpu_torch import multi_train as port_multi_train
from end2end_asr_tpu_torch.training import trainer as PT

from synth import make_corpus


@pytest.mark.parametrize("cls", ["Trainer", "MultiTrainer"])
def test_validation_hooks_equal_jax(caplog, cls):
    losses = [1.25, 0.5, 2.0]
    caplog.set_level(logging.INFO)
    results = {}
    for pkg, mod in (("end2end_asr_tpu", JT), ("end2end_asr_tpu_torch", PT)):
        hooks = getattr(mod, cls)
        for ind, v in enumerate(losses):
            hooks._log_valid(None, 4, ind, v, 12.5 * ind)
        metrics = {"valid_loss": hooks._best_valid_loss_key(None, losses)}
        hooks._extend_metrics(None, metrics, losses)
        results[pkg] = ([r.getMessage() for r in caplog.records
                         if r.name == pkg], metrics,
                        hooks._best_valid_loss_key(None, []))
    assert results["end2end_asr_tpu_torch"] == results["end2end_asr_tpu"]
    lines, metrics, _ = results["end2end_asr_tpu_torch"]
    if cls == "MultiTrainer":
        assert lines[1] == "(Epoch 5) TASK:1 VALID LOSS:0.5000 CER:12.50%"
        assert metrics == {"valid_loss": pytest.approx(1.25),
                           "valid_losses": losses}
    else:
        assert lines[1] == "VALID SET 1 LOSS:0.5000 CER:12.50%"
        assert metrics == {"valid_loss": 2.0}


def test_multi_train_entry_point_two_tasks_augmented(tmp_path, monkeypatch):
    """Two tasks, --augment --noise-dir, 2 epochs at a tiny width: a TASK
    line per task and epoch, valid_losses in the metrics, and best_model
    keyed off the mean of the tasks' losses."""
    monkeypatch.chdir(tmp_path)
    a, labels = make_corpus(str(tmp_path / "a"), seed=1)
    b, _ = make_corpus(str(tmp_path / "b"), texts=["bab", "abc", "cab"],
                       seed=2)
    noise = tmp_path / "noise"
    noise.mkdir()
    save_wav(str(noise / "n.wav"),
             np.random.RandomState(0).randn(4000).astype(np.float32) * .2,
             16000)
    argv = ["--train-manifest-list", a, b, "--valid-manifest-list", a, b,
            "--labels-path", labels, "--name", "mt", "--save-folder",
            "models", "--feat_extractor", "vgg_cnn", "--num-layers", "2",
            "--num-heads", "2", "--dim-model", "64", "--dim-key", "32",
            "--dim-value", "32", "--dim-inner", "64", "--dim-emb", "64",
            "--batch-size", "2", "--save-every", "1", "--dtype", "float32",
            "--src-max-len", "64", "--tgt-max-len", "8", "--epochs", "2",
            "--augment", "--noise-dir", str(noise), "--noise-prob", "1.0",
            "--device", "cpu"]
    res = port_multi_train.main(argv)
    assert res["epochs_run"] == 2 and res["opt_step"] == 4
    with open(os.path.join("log", "mt")) as f:
        log = f.read()
    for epoch in (1, 2):
        for task in (0, 1):
            assert f"(Epoch {epoch}) TASK:{task} VALID LOSS:" in log
        # the epoch's batches per (frames, target columns) bucket
        per_bucket = re.search(
            rf"\(Epoch {epoch}\) TRAIN BATCHES PER BUCKET \(frames x "
            rf"target columns\): ((?:\d+x\d+:\d+ ?)+)\n", log).group(1)
        assert sum(int(c.split(":")[1]) for c in per_bucket.split()) == 2
    assert "VALID SET" not in log
    history = res["metrics"]["history"]
    for h in history:
        assert len(h["valid_losses"]) == 2
        assert h["valid_loss"] == pytest.approx(np.mean(h["valid_losses"]))
    with open(os.path.join("models", "mt", "best_model.json")) as f:
        best = json.load(f)
    means = [h["valid_loss"] for h in history]
    assert best["epoch"] == 1 + int(np.argmin(means))
    assert best["metrics"]["valid_loss"] == pytest.approx(min(means))
