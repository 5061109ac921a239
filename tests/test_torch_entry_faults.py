"""The port's entry points against four faults the JAX package does not
have: `--trace-dir` writes a trace of the first epoch, `--no-pallas-
features` takes the plain STFT, the training run's console output is teed
into log/<name>.stdout, and TF32 is off once an entry point has set up its
device (train, test, transcribe, lm_train, StreamingTranscriber). All on the CPU at a tiny size; the card's
side of the STFT routing is in tests/test_torch_gpu.py.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from end2end_asr_tpu_torch import evaluation as E
from end2end_asr_tpu_torch import lm_train as port_lm_train
from end2end_asr_tpu_torch import test as port_test
from end2end_asr_tpu_torch import train as port_train
from end2end_asr_tpu_torch import transcribe as port_transcribe
from end2end_asr_tpu_torch.config import Config
from end2end_asr_tpu_torch.ops import features as PF
from end2end_asr_tpu_torch.ops import stft as S
from end2end_asr_tpu_torch.streaming import StreamingTranscriber
from end2end_asr_tpu_torch.training import steps as TS
from end2end_asr_tpu_torch.training.checkpoint import load_checkpoint

from synth import make_corpus

BANNER = "THE EXPERIMENT LOG IS SAVED IN: log/t"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_faults"))
    return make_corpus(root)


def _train_argv(corpus, root, extra=()):
    """One step per epoch: the 4 utterances in one batch."""
    manifest, labels = corpus
    return ["--train-manifest-list", manifest,
            "--valid-manifest-list", manifest, "--labels-path", labels,
            "--name", "t", "--save-folder", os.path.join(root, "models"),
            "--feat_extractor", "vgg_cnn", "--num-layers", "1",
            "--num-heads", "2", "--dim-model", "32", "--dim-key", "16",
            "--dim-value", "16", "--dim-inner", "32", "--dim-emb", "32",
            "--batch-size", "4", "--save-every", "1", "--dtype", "float32",
            "--src-max-len", "64", "--tgt-max-len", "8", "--device", "cpu",
            *extra]


def test_trace_dir_writes_a_trace_of_the_first_epoch(corpus, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = port_train.main(_train_argv(corpus, str(tmp_path),
                                      ["--epochs", "1", "--trace-dir",
                                       "trace"]))
    assert res["opt_step"] == 1
    files = glob.glob(os.path.join("trace", "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    # the step's operators are in it
    assert any("conv2d" in e.get("name", "") for e in events)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("entry", ["train_step", "encode_pcm"])
def test_no_pallas_features_takes_the_plain_stft(monkeypatch, use_kernel,
                                                 entry):
    """The kernel's entry (`ops.stft.stft_logmag`) is a counting stub: with
    the flag it is never called, and both routes give the plain
    featurizer's spectrogram."""
    calls = []
    real = S.stft_logmag
    monkeypatch.setattr(S, "stft_logmag",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = Config(use_pallas_features=use_kernel)
    T = 21
    rng = np.random.RandomState(0)
    pcm = torch.from_numpy((rng.randn(2, (T - 1) * cfg.hop_length
                                      + cfg.n_fft) * 3000).astype(np.int16))
    n_frames = torch.tensor([T, 15])
    if entry == "train_step":
        got = TS.features(cfg, pcm, n_frames, T)
    else:
        monkeypatch.setattr(E, "encode", lambda params, spect, n, dims:
                            (spect, n))
        got, _ = E.encode_pcm({}, cfg, None, pcm, n_frames, T)
    assert len(calls) == (1 if use_kernel else 0)
    want = PF.batched_features(pcm, n_frames, cfg.n_fft, cfg.hop_length,
                               cfg.window, T)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_stdout_is_teed_and_a_resumed_run_appends(corpus, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    stdout = sys.stdout
    port_train.main(_train_argv(corpus, str(tmp_path), ["--epochs", "1"]))
    assert sys.stdout is stdout            # the tee is taken down again
    path = os.path.join("log", "t.stdout")
    with open(path) as f:
        first = f.read()
    assert first.count(BANNER) == 1
    port_train.main(_train_argv(corpus, str(tmp_path),
                                ["--epochs", "2", "--auto-resume"]))
    with open(path) as f:
        both = f.read()
    assert both.startswith(first) and both.count(BANNER) == 2
    assert "AUTO-RESUME from" in both[len(first):]
    # a fresh run (no resume) starts the file anew
    port_train.main(_train_argv(corpus, str(tmp_path), ["--epochs", "1"]))
    with open(path) as f:
        assert f.read().count(BANNER) == 1


@pytest.mark.parametrize("entry", ["train", "test", "transcribe",
                                   "lm_train", "streaming"])
def test_tf32_is_off_after_each_entry_points_setup(corpus, tmp_path,
                                                   monkeypatch, entry):
    monkeypatch.chdir(tmp_path)
    manifest, _ = corpus
    root = str(tmp_path)
    if entry not in ("train", "lm_train"):        # a checkpoint to serve
        port_train.main(_train_argv(corpus, root, ["--epochs", "1"]))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    ck = os.path.join(root, "models", "t", "best_model")
    if entry == "train":
        port_train.main(_train_argv(corpus, root, ["--epochs", "1"]))
    elif entry == "test":
        port_test.main(["--continue-from", ck, "--test-manifest-list",
                        manifest, "--batch-size", "4", "--device", "cpu"])
    elif entry == "lm_train":
        port_lm_train.main(["--train-manifest-list", manifest, "--lm-path",
                            os.path.join(root, "lm.npz"), "--ninp", "8",
                            "--nhid", "8", "--nlayers", "1", "--batch-size",
                            "1", "--bptt", "4", "--epochs", "1",
                            "--device", "cpu"])
    elif entry == "streaming":
        cfg, _, params, _, state, _, id2label, _ = load_checkpoint(ck)
        StreamingTranscriber(params, state, cfg, id2label, device="cpu")
    else:
        with open(manifest) as f:
            wav = f.readline().split(",")[0]
        port_transcribe.main(["--continue-from", ck, wav, "--device", "cpu"])
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
