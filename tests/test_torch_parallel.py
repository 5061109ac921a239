"""Data parallelism and ZeRO-1 / FSDP of the port, in one 2-rank gloo group.

A module-scoped fixture spawns the group once (torch.multiprocessing.spawn,
a FileStore under tmp_path); each rank runs every scenario of
tests/torch_parallel_worker.py on its half of the batch and writes the
results to files, and each test below asserts on those files:
  * port steps at world 2 against the JAX package's UNSHARDED step on the
    whole batch (tests/test_sharding.py pins that it equals JAX's sharded
    step): two of CE with --grad-accum 2 inside each rank; one of CTC and
    one of emb_cnn with its global-batch batch norms and running
    statistics, as their one-process tests take (after a second step the
    port's ONE-process path is itself outside tests/test_torch_train.py's
    parameter rule for these two: 99.44% and 95.42% of the parameters
    within 1e-5, against 99.9%, and world 2 reads the same); f32, dropout
    0, with tests/test_torch_train.py's tolerances;
  * --spec-augment: the ranks' masks are the one-process run's rows;
  * ZeRO-1 and FSDP (with --clip) against plain data parallelism;
  * train --parallel plain / --zero1 / --fsdp through the entry point:
    the gathered checkpoints are the same file, and one resumes at world
    size 1;
  * test --parallel: the strings and CER of the one-process run.
"""

import json
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from end2end_asr_tpu.models import transformer as JT
from end2end_asr_tpu.training import optimizer as JO
from end2end_asr_tpu.training.checkpoint import flatten_tree
from end2end_asr_tpu.training.steps import make_train_step_impl
from end2end_asr_tpu_torch import test as port_test
from end2end_asr_tpu_torch import train as port_train
from end2end_asr_tpu_torch.training import steps as TS

import torch_parallel_worker as W
from port_parity import jax_params, small_config, to_port, torch_config
from synth import make_corpus
from test_torch_embcnn import _batch as emb_batch
from test_torch_train import (GRAD_TOL, LOSS_TOL, T_FRAMES, VOCAB, _batch,
                              _ctc_batch, _params_close, _rel)

WORLD = 2
GROUP_TIMEOUT_S = 600   # the group's scenarios take ~13 s on 8 CPU cores
ZERO_TOL = 1e-6    # only the order of the gradient's sum over ranks moves
# world 2 against one process, first-step moments per leaf: the gradient
# summed in another order, through emb_cnn's global batch norm too
# (1.4e-4 measured there, ~1e-5 elsewhere)
MOMENT_TOL = 1e-3
TEXTS = ["abba", "cab", "back", "cabba", "bab"]   # batch 4: a ragged bin


def _cfg(**kw):
    base = dict(dropout=0.0, label_smoothing=0.1, batch_size=4,
                src_max_len=T_FRAMES, tgt_max_len=16, warmup=10, k_lr=1.0)
    base.update(kw)
    return small_config(**base)


def _emb_model():
    """tests/test_torch_embcnn.py's model: emb_cnn, running statistics
    away from (0, 1)."""
    cfg = _cfg(feat_extractor="emb_cnn", k_lr=1.0)
    params, state = JT.init_transformer(jax.random.PRNGKey(0), cfg, VOCAB)
    rng = np.random.RandomState(4)
    for bn in ("bn1", "bn2"):
        state["frontend"][bn] = {
            "mean": jnp.asarray(rng.randn(32).astype(np.float32) * 0.1),
            "var": jnp.asarray(rng.rand(32).astype(np.float32) + 0.5)}
    return cfg, params, state


def _save_tree(path, tree):
    np.savez(path, **{k: np.asarray(v) for k, v in flatten_tree(tree).items()})


def _save_batch(path, batch):
    np.savez(path, **dict(zip(("pcm", "n_frames", "targets", "tgt_lengths"),
                              batch)))


def _argv(corpus, root):
    manifest, labels = corpus
    return ["--train-manifest-list", manifest,
            "--valid-manifest-list", manifest, "--labels-path", labels,
            "--save-folder", os.path.join(root, "models"),
            "--feat_extractor", "vgg_cnn", "--num-layers", "1",
            "--num-heads", "2", "--dim-model", "32", "--dim-key", "64",
            "--dim-value", "64", "--dim-inner", "32", "--dim-emb", "32",
            "--batch-size", "4", "--save-every", "1", "--dtype", "float32",
            "--src-max-len", "64", "--tgt-max-len", "8", "--epochs", "1"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The inputs, then one 2-rank run of every scenario: (root, spec,
    params, corpus). load(name, rank) reads a scenario's results."""
    root = str(tmp_path_factory.mktemp("ddp"))
    cfg = _cfg()
    params = jax_params(cfg, VOCAB, seed=4)
    _save_tree(os.path.join(root, "params.npz"), params)
    ecfg, eparams, estate = _emb_model()
    _save_tree(os.path.join(root, "emb_params.npz"), eparams)
    _save_tree(os.path.join(root, "emb_state.npz"), estate)
    _save_batch(os.path.join(root, "ce.npz"), _batch(0))
    _save_batch(os.path.join(root, "ctc.npz"), _ctc_batch(6, (5, 4, 3, 5)))
    _save_batch(os.path.join(root, "emb.npz"), emb_batch())
    corpus = make_corpus(os.path.join(root, "corpus"), texts=TEXTS)
    spec = {"cfg": torch_config(cfg).to_dict(),
            "emb_cfg": torch_config(ecfg).to_dict(), "T": T_FRAMES,
            "train_argv": _argv(corpus, root),
            "test_argv": ["--continue-from",
                          os.path.join(root, "models", "plain", "epoch_1"),
                          "--test-manifest-list", corpus[0],
                          "--batch-size", "4"]}
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    ctx = mp.spawn(W.run, args=(WORLD, root), nprocs=WORLD, join=False)
    deadline = time.time() + GROUP_TIMEOUT_S
    while not ctx.join(timeout=5):     # a rank's exception raises here
        if time.time() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"the {WORLD}-rank group ran over "
                        f"{GROUP_TIMEOUT_S} s")
    assert not any(p.is_alive() for p in ctx.processes)
    return root, spec, (cfg, params), (ecfg, eparams, estate), corpus


def load(root, name, rank=0):
    with np.load(os.path.join(root, f"{name}.r{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


def _jax_run(cfg, params, batch, state=None, steps=W.STEPS):
    dims = JT.dims_from_config(cfg)
    step = jax.jit(make_train_step_impl(cfg, dims, from_pcm=True),
                   static_argnames=("spect_T",))
    opt = JO.init_opt_state(cfg, params)
    state = {} if state is None else state
    ms, opts = [], []
    for _ in range(steps):
        params, opt, state, m, _, _ = step(
            params, opt, state, jax.random.PRNGKey(0),
            *(jnp.asarray(a) for a in batch), spect_T=T_FRAMES)
        ms.append(m)
        opts.append(opt)
    return params, opts, state, ms


def _flat(tree, keys):
    flat = flatten_tree(tree)
    return np.concatenate([np.asarray(flat[k]).ravel() for k in keys])


def _one_process(cfg, params, root, name, state=None, steps=W.STEPS,
                 **kw):
    """The port's one-process run of a scenario on the whole batch."""
    batch = W.rank_batch(os.path.join(root, name + ".npz"), 0, 1)
    return W.run_steps(torch_config(cfg), to_port(params), batch, T_FRAMES,
                       state=None if state is None else to_port(state),
                       steps=steps, **kw)


def _leaves_close(fp, got, want, tol, but=None):
    """Per leaf, relative to the leaf's largest |value|, floored at 1e-3
    of the model's (tests/test_torch_train.py's gradient rule); leaves
    whose name starts with `but` are left out."""
    want = fp.views(torch.from_numpy(want))
    got = fp.views(torch.from_numpy(got))
    floor = 1e-3 * max(v.abs().max().item() for v in want.values())
    for k in want:
        if not (but and k.startswith(but)):
            assert _rel(got[k].numpy(), want[k].numpy(), floor) < tol, k


def _check_against_jax(got, cfg, params, batch, root, name, state=None,
                       steps=W.STEPS, accum=1):
    """Both ranks agree. The losses, token counts and, after the steps,
    every parameter (tests/test_torch_train.py's rule: Adam moves a
    parameter whose gradient is at noise level by ~lr either way) match
    the JAX step on the whole batch, and so does the state. The Adam
    moments of the first step equal the port's one-process run's within
    MOMENT_TOL per leaf, and JAX's within GRAD_TOL per leaf: every leaf
    for CE on _batch(0); outside the front end for CTC on
    _ctc_batch(6, ...) and emb_cnn. There the front end's f32 gradient
    follows where each package's roundings flip near-ties of its pools
    and clips (up to 1.8e-3 and 6.3e-3 of a leaf from JAX's, on one
    process as on two: the audio's doing, not the loss's); its float64
    gradient equals JAX's, and its f32 one lies no further from that
    than JAX's (tests/test_torch_train.py::frontend_against_f64)."""
    other = got[1]
    got = got[0]
    for k in got:
        assert np.array_equal(got[k], other[k]), k
    jp, jopts, jstate, jms = _jax_run(cfg, params, batch, state, steps)
    for i, jm in enumerate(jms):
        np.testing.assert_allclose(got["loss"][i], float(jm["loss"]),
                                   rtol=LOSS_TOL)
        assert got["num_token"][i] == int(jm["num_token"])
        assert got["num_correct"][i] == int(jm["num_correct"])
    assert int(got["step"]) == int(jopts[-1]["step"]) == steps
    fp = TS.FlatParams(to_port(params), torch.device("cpu"))
    _params_close(got["data"], _flat(jp, fp.train_keys),
                  [float(jm["lr"]) for jm in jms])
    for k, v in flatten_tree(jstate).items():
        np.testing.assert_allclose(got["state::" + k], v, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
    one = _one_process(cfg.replace(grad_accum=accum), params, root, name,
                       state, steps)
    but = None if (cfg.loss == "ce" and cfg.feat_extractor == "vgg_cnn") \
        else "frontend::"
    for m in ("mu", "nu"):
        _leaves_close(fp, got[m + "1"], one[m + "1"], MOMENT_TOL)
        _leaves_close(fp, got[m + "1"], _flat(jopts[0][m], fp.train_keys),
                      GRAD_TOL, but)


def test_ddp_ce_with_grad_accum_equals_the_unsharded_jax_step(group):
    root, _, (cfg, params), _, _ = group
    """Each rank splits its 2 rows into 2 microbatches; JAX takes the 4
    rows at once (its --grad-accum equals that, tests/test_grad_accum.py)."""
    _check_against_jax([load(root, "ce_accum2", r) for r in range(WORLD)],
                       cfg, params, _batch(0), root, "ce", accum=2)


def test_ddp_ctc_equals_the_unsharded_jax_step(group):
    root, _, (cfg, params), _, _ = group
    _check_against_jax([load(root, "ctc", r) for r in range(WORLD)],
                       cfg.replace(loss="ctc"), params,
                       _ctc_batch(6, (5, 4, 3, 5)), root, "ctc", steps=1)


def test_ddp_emb_cnn_batch_norm_is_global(group):
    """The batch statistics of the global batch: loss, parameters and the
    running statistics equal the JAX step on the whole batch."""
    root, _, _, (ecfg, eparams, estate), _ = group
    got = [load(root, "emb_cnn", r) for r in range(WORLD)]
    assert any(k.startswith("state::") for k in got[0])
    _check_against_jax(got, ecfg, eparams, emb_batch(), root, "emb",
                       estate, steps=1)


def test_ddp_spec_augment_equals_one_process(group):
    """Each rank draws the global batch's bands and keeps its rows: the
    one-process run's losses to the order of the sum, and its parameters
    by tests/test_torch_train.py's rule."""
    root, spec, (cfg, params), _, _ = group
    got = load(root, "spec_augment")
    want = _one_process(cfg.replace(spec_augment=True, freq_mask_width=20,
                                    time_mask_width=20), params, root, "ce",
                        rng_seed=3)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=ZERO_TOL)
    _params_close(got["data"], want["data"], list(want["lr"]))
    # and the masks are on: the loss differs from the unmasked step's
    assert abs(got["loss"][0] - load(root, "ce_accum2")["loss"][0]) > 1e-4


@pytest.mark.parametrize("stage", ["zero1", "fsdp"])
def test_zero_equals_plain_ddp(group, stage):
    """With --clip at a norm that clips: parameters and moments within
    rel 1e-6 of plain data parallelism, on both ranks."""
    root = group[0]
    plain = load(root, "clip_plain")
    for r in range(WORLD):
        got = load(root, "clip_" + stage, r)
        np.testing.assert_allclose(got["loss"], plain["loss"], rtol=ZERO_TOL)
        for k in ("data", "mu", "nu"):
            assert got[k].shape == plain[k].shape
            assert _rel(got[k], plain[k]) < ZERO_TOL, k
        assert int(got["step"]) == W.STEPS


def _npz(path):
    with np.load(path + ".npz") as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("stage", ["zero1", "fsdp"])
def test_zero_checkpoint_is_the_plain_file_and_resumes_at_world_1(
        group, stage, tmp_path, monkeypatch):
    """train --parallel --zero1 / --fsdp gather the moments (and
    parameters) to rank 0: the epoch's npz equals plain data
    parallelism's, array for array; then it resumes in one process."""
    root = group[0]
    models = os.path.join(root, "models")
    plain = _npz(os.path.join(models, "plain", "epoch_1"))
    got = _npz(os.path.join(models, stage, "epoch_1"))
    assert set(got) == set(plain) and any(k.startswith("opt::mu")
                                          for k in got)
    for k in plain:
        assert np.array_equal(got[k], plain[k]), k
    monkeypatch.chdir(tmp_path)
    # --parallel without torchrun's environment: one rank, the same ZeRO
    res = port_train.main(group[1]["train_argv"] + [
        "--name", stage, "--epochs", "2", "--auto-resume", "--parallel",
        "--device", "cpu"])
    # 5 utterances at batch 4: 2 steps an epoch, counted on from 2
    assert res["epochs_run"] == 1 and res["opt_step"] == 4


def test_parallel_test_gathers_the_one_process_strings(group, caplog):
    """test --parallel: each rank decodes its half of each batch (the
    ragged bin cycled to 4 rows); rank 0 scores the gathered strings."""
    root, spec = group[0], group[1]
    got = load(root, "eval")
    with caplog.at_level(logging.INFO, logger="end2end_asr_tpu_torch"):
        res = port_test.main(spec["test_argv"] + ["--verbose", "--device",
                                                  "cpu"])
    want = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("HYP: ")]
    assert len(want) == len(TEXTS)
    assert list(got["hyps"]) == want
    assert float(got["cer"]) == res["cer"]
    # rank 1 decoded its slices and scored nothing
    assert load(root, "eval", 1)["hyps"].size == 0
