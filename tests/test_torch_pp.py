"""Pipeline parallelism of the port (parallel/pp.py), in one spawn of gloo
ranks on the CPU for the module.

A module-scoped fixture spawns 4 processes once (tests/torch_pp_worker.py,
which imports no JAX): ranks 0-1 run the world-2 scenarios, then all four
the world-4 ones, each at its own data x pipe x model layout. Each writes
its results to files, and the tests below assert on them:
  * steps of a 4-layer model on an 8-row batch against the JAX package's
    UNSHARDED step on the whole batch (its tests/test_pipeline_parallel.py
    holds JAX's pipeline equal to that step): --mesh-pipe 2 at M 2; at M 4
    with --grad-accum 2; --mesh-pipe 4 (one layer a stage) with --remat;
    --mesh-pipe 2 --mesh-model 2 with --fsdp, and at LRTRFS (rank 8);
    --mesh-data 2 --mesh-pipe 2 with --zero1; all with --clip at a norm
    that clips (JAX's too); the
    losses within LOSS_TOL, the parameters
    after two steps by tests/test_torch_train.py's rule, the first step's
    moments within GRAD_TOL of JAX's per leaf;
  * emb_cnn at pipe 2: one step against JAX's, its batch norms' running
    statistics on both stages;
  * dropout 0.1: the step at pipe 2 equals the step at pipe 4 at the same
    M, and another seed gives another step;
  * train --parallel --mesh-pipe 2 gathers the one-process run's
    parameters; its checkpoint serves the one-process strings through
    `test`, in one process; its sharded save loads in one process equal to
    it; --auto-resume continues its optimizer step in one process.
Without a group: the interleaved split and merge equal JAX's, the layout's
checks are `make_mesh_pipe`'s, the stage cut and its join, and JAX's
refusals.
"""

import functools
import json
import logging
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from end2end_asr_tpu.parallel import pp as JPP
from end2end_asr_tpu.training.checkpoint import flatten_tree
from end2end_asr_tpu_torch import test as port_test
from end2end_asr_tpu_torch import train as port_train
from end2end_asr_tpu_torch.config import config_from_args
from end2end_asr_tpu_torch.parallel import mesh
from end2end_asr_tpu_torch.parallel import pp as PPP
from end2end_asr_tpu_torch.training import checkpoint as TC
from end2end_asr_tpu_torch.training import steps as TS

import torch_pp_worker as W
from port_parity import jax_params, to_port, torch_config
from synth import make_corpus
from test_torch_embcnn import _batch as emb_batch
from test_torch_parallel import (TEXTS, _argv, _cfg, _emb_model, _flat,
                                 _jax_run, _leaves_close, _save_batch,
                                 _save_tree, load)
from test_torch_train import GRAD_TOL, LOSS_TOL, T_FRAMES, VOCAB, _batch, \
    _params_close

WORLD = 4
GROUP_TIMEOUT_S = 600
CLIP = dict(clip=True, max_norm=0.5)
# one model, one 8-row batch (M 4 with --grad-accum 2 needs 8 rows)
LAYERS = 4
DROP = {"dropout": 0.1, "pipe_microbatches": 4}
DROP_REMAT = dict(DROP, remat=True)
RANK = 8

# the groups' scenarios: two worlds of 2 side by side, then a world of 4
STEPS = {
    "2a": {"p2": {"layout": [1, 2, 1]},
           "p2_m4_accum2": {"layout": [1, 2, 1], "cfg": {
               "pipe_microbatches": 4, "grad_accum": 2}},
           "p2_emb": {"layout": [1, 2, 1], "model": "emb"},
           "drop_p2_group": {"layout": [1, 2, 1], "cfg": DROP, "rng": 3,
                             "group": True},
           "drop_p2_remat": {"layout": [1, 2, 1], "cfg": DROP_REMAT,
                             "rng": 3},
           "drop_p2_remat_group": {"layout": [1, 2, 1], "cfg": DROP_REMAT,
                                   "rng": 3, "group": True}},
    "2b": {"drop_p2": {"layout": [1, 2, 1], "cfg": DROP, "rng": 3},
           "drop_p2_seed5": {"layout": [1, 2, 1], "cfg": DROP, "rng": 5}},
    "4": {"p4_remat": {"layout": [1, 4, 1], "cfg": {"remat": True}},
          "drop_p4": {"layout": [1, 4, 1], "cfg": DROP, "rng": 3},
          "p2_tp2_fsdp": {"layout": [1, 2, 2], "zero": 3},
          "p2_tp2_lr": {"layout": [1, 2, 2], "params": "lr_params",
                        "cfg": {"model": "LRTRFS", "rank": RANK}},
          "dp2_p2_zero1": {"layout": [2, 2, 1], "zero": 1}},
}
# held against the JAX package's unsharded step, with --clip at a norm
# that clips: the squared norm counts each stage's layers once and the
# leaves outside the stacks once (name -> the low-rank rank, or 0)
AGAINST_JAX = {"p2": 0, "p2_m4_accum2": 0, "p4_remat": 0, "p2_tp2_fsdp": 0,
               "dp2_p2_zero1": 0, "p2_tp2_lr": RANK}


def _model_cfg(rank=0, **kw):
    return _cfg(num_layers=LAYERS, batch_size=8, rank=rank, **kw)


def _batch8():
    """_batch(0) and _batch(1): 8 rows."""
    return tuple(np.concatenate(ab) for ab in zip(_batch(0), _batch(1)))


@functools.lru_cache(maxsize=None)
def _params(rank=0):
    return jax_params(_model_cfg(rank), VOCAB, seed=4)


@functools.lru_cache(maxsize=None)
def _jax_reference(rank=0):
    return _jax_run(_model_cfg(rank, **CLIP), _params(rank), _batch8(),
                    steps=W.STEPS)


def _entry_argv(corpus, root):
    """tests/test_torch_parallel.py's entry-point model with 2 layers (one
    a stage), at dropout 0."""
    argv = _argv(corpus, root)
    argv[argv.index("--num-layers") + 1] = "2"
    return argv + ["--dropout", "0", "--device", "cpu"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pp"))
    params = _params()
    _save_tree(os.path.join(root, "params.npz"), params)
    _save_tree(os.path.join(root, "lr_params.npz"), _params(RANK))
    _save_batch(os.path.join(root, "batch.npz"), _batch8())
    ecfg, eparams, estate = _emb_model()
    _save_tree(os.path.join(root, "emb_params.npz"), eparams)
    _save_tree(os.path.join(root, "emb_state.npz"), estate)
    _save_batch(os.path.join(root, "emb_batch.npz"), emb_batch())
    corpus = make_corpus(os.path.join(root, "corpus"), texts=TEXTS)
    train = _entry_argv(corpus, root)
    pipe = ["--parallel", "--mesh-pipe", "2"]
    entry = {"2b": [
        {"name": "train_pp", "train": train + ["--name", "pp", *pipe]},
        {"name": "train_pp_dcp", "train": train + [
            "--name", "pp_dcp", *pipe, "--checkpoint-format", "orbax"]}]}
    spec = {"cfg": torch_config(_model_cfg(**CLIP)).to_dict(),
            "emb_cfg": torch_config(ecfg).to_dict(), "T": T_FRAMES,
            "steps": STEPS, "entry": entry}
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    ctx = mp.spawn(W.run, args=(WORLD, root), nprocs=WORLD, join=False)
    deadline = time.time() + GROUP_TIMEOUT_S
    # while the ranks run: the one-process run of the entry point
    # (--parallel at one rank: the ragged bin cycled to the full batch, as
    # on the ranks) and the JAX reference
    cwd = os.getcwd()
    os.chdir(root)
    try:
        one = port_train.main(train + ["--name", "one", "--parallel"])
    finally:
        os.chdir(cwd)
    _jax_reference()
    _jax_reference(RANK)
    emb_ref = _jax_run(ecfg, eparams, emb_batch(), estate, steps=1)
    while not ctx.join(timeout=5):     # a rank's exception raises here
        if time.time() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"the {WORLD}-rank group ran over "
                        f"{GROUP_TIMEOUT_S} s")
    return root, params, corpus, train, one, (eparams, emb_ref)


def _ranks(name):
    return 4 if name in STEPS["4"] else 2


def _fp(params):
    return TS.FlatParams(to_port(params), torch.device("cpu"))


@pytest.mark.parametrize("name", list(AGAINST_JAX))
def test_step_equals_the_unsharded_jax_step(group, name):
    root = group[0]
    got = [load(root, name, r) for r in range(_ranks(name))]
    for other in got[1:]:          # every rank ends with the same values
        for k in got[0]:
            assert np.array_equal(got[0][k], other[k]), k
    got = got[0]
    rank = AGAINST_JAX[name]
    jp, jopts, _, jms = _jax_reference(rank)
    for i, jm in enumerate(jms):
        np.testing.assert_allclose(got["loss"][i], float(jm["loss"]),
                                   rtol=LOSS_TOL)
        assert got["num_token"][i] == int(jm["num_token"])
        assert got["num_correct"][i] == int(jm["num_correct"])
    assert int(got["step"]) == W.STEPS
    fp = _fp(_params(rank))
    _params_close(got["data"], _flat(jp, fp.train_keys),
                  [float(jm["lr"]) for jm in jms])
    for m in ("mu", "nu"):
        _leaves_close(fp, got[m + "1"], _flat(jopts[0][m], fp.train_keys),
                      GRAD_TOL)


def test_emb_cnn_state_reaches_every_stage(group):
    """emb_cnn at pipe 2: its front end runs on stage 0 alone, and stage 1
    takes stage 0's new batch-norm running statistics; one step's loss,
    parameters and state against the JAX package's unsharded step, as
    tests/test_torch_parallel.py holds data parallelism's (the front
    end's f32 gradient left out of the moments: its pools and clips route
    it by comparisons that f32 roundings flip near ties)."""
    root, (eparams, (jp, jopts, jstate, jms)) = group[0], group[5]
    got = [load(root, "p2_emb", r) for r in range(2)]
    assert any(k.startswith("state::") for k in got[0])
    for k in got[0]:
        assert np.array_equal(got[0][k], got[1][k]), k
    got = got[0]
    np.testing.assert_allclose(got["loss"][0], float(jms[0]["loss"]),
                               rtol=LOSS_TOL)
    fp = _fp(eparams)
    _params_close(got["data"], _flat(jp, fp.train_keys),
                  [float(jms[0]["lr"])])
    for k, v in flatten_tree(jstate).items():
        np.testing.assert_allclose(got["state::" + k], v, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
    for m in ("mu", "nu"):
        _leaves_close(fp, got[m + "1"], _flat(jopts[0][m], fp.train_keys),
                      GRAD_TOL, "frontend::")


def test_dropout_step_does_not_depend_on_the_stage_count(group):
    """Each (layer, microbatch) draws from a stream of its own: at
    dropout 0.1 and M 4 the step at pipe 4 is the step at pipe 2 (the
    encoder output's gradient summed over 4 stages instead of 2: the
    same terms in another order); another seed gives another step."""
    root, params = group[:2]
    a, b = load(root, "drop_p2"), load(root, "drop_p4")
    np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_TOL)
    np.testing.assert_array_equal(b["hyp1"], a["hyp1"])
    fp = _fp(params)
    for m in ("mu1", "nu1"):
        _leaves_close(fp, b[m], a[m], GRAD_TOL)
    _params_close(b["data"], a["data"], list(a["lr"]))
    # the dropout acts, and follows the seed
    assert abs(a["loss"][0] - load(root, "p2")["loss"][0]) > 1e-3
    assert abs(a["loss"][0] - load(root, "drop_p2_seed5")["loss"][0]) > 1e-4


@pytest.mark.parametrize("name,single", [
    ("drop_p2_group", "drop_p2"), ("drop_p2_remat_group", "drop_p2_remat"),
    ("drop_p2_remat", "drop_p2")])
def test_grouped_dropout_steps_equal_single_steps(group, name, single):
    """Two pipelined steps at dropout 0.1 as one K = 2 dispatch (the
    run's own kernel seeds drawn at once by DropoutRng.group, the
    pipeline streams' on the device: the path a CUDA graph of the steps
    takes) after a step that is put back, equal two single steps bit for
    bit, plain and under --remat (whose recompute redraws its
    microbatch's masks); --remat's steps equal the plain ones."""
    root = group[0]
    for r in range(2):
        got, want = load(root, name, r), load(root, single, r)
        for k in got:      # a group keeps no first step's moments
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_entry_point_gathers_the_one_process_parameters(group):
    """train --parallel --mesh-pipe 2: one epoch of 2 steps on the
    5-utterance corpus; its returned (gathered) parameters against the
    one-process run's, by the parameter rule; its checkpoint is the
    gathered npz file, and its sharded save loads in one process equal to
    the npz of the same run."""
    root, one = group[0], group[4]
    got = load(root, "train_pp")
    want = {k: v.numpy()
            for k, v in TC.flatten_params(one["params"]).items()}
    assert set(got) == set(want)
    cat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])
    d = np.abs(cat(got) - cat(want))
    assert (d <= 1e-5).mean() >= 0.999 and d.max() < 1e-2
    base = os.path.join(root, "models", "pp", "epoch_1")
    _, _, saved, opt, _, _, _, _ = TC.load_checkpoint(base)
    for k, v in TC.flatten_params(saved).items():
        np.testing.assert_array_equal(v.numpy(), got[k])
    assert int(opt["step"]) == 2
    dcp_base = os.path.join(root, "models", "pp_dcp", "epoch_1")
    assert os.path.isdir(dcp_base + ".dcp")
    _, _, dparams, dopt, _, _, _, _ = TC.load_checkpoint(dcp_base)
    assert list(TC.flatten_params(dparams)) == list(
        TC.flatten_params(saved))
    for k, v in TC.flatten_params(dparams).items():
        np.testing.assert_array_equal(v.numpy(), got[k])
    for k, v in TC.flatten_params(dopt).items():
        np.testing.assert_array_equal(v.numpy(),
                                      TC.flatten_params(opt)[k].numpy())


def test_pipelined_checkpoint_serves_and_resumes_in_one_process(
        group, tmp_path, monkeypatch):
    """`test` (which never pipelines) prints the one-process run's strings
    on the pipelined run's checkpoint; --auto-resume continues it in one
    process (2 steps an epoch, counted on from 2)."""
    root, _, corpus, train = group[:4]
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    log = logging.getLogger("end2end_asr_tpu_torch")
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    argv = ["--test-manifest-list", corpus[0], "--batch-size", "4",
            "--device", "cpu", "--verbose", "--continue-from"]
    try:
        hyps = []
        for name in ("one", "pp"):
            lines.clear()
            port_test.main(argv + [os.path.join(root, "models", name,
                                                "epoch_1")])
            hyps.append([ln for ln in lines if ln.startswith("HYP: ")])
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    assert len(hyps[0]) == len(TEXTS) and hyps[1] == hyps[0]
    monkeypatch.chdir(tmp_path)
    save = train[train.index("--save-folder") + 1]
    res = port_train.main(train + ["--name", "pp", "--epochs", "2",
                                   "--auto-resume", "--parallel",
                                   "--save-folder", save])
    assert res["epochs_run"] == 1 and res["opt_step"] == 4


# ---------------------------------------------------------------------------
# without a group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_interleaved_split_and_merge_equal_jax(m):
    a = np.random.RandomState(0).randn(8, 3, 5).astype(np.float32)
    want = np.asarray(JPP._interleave_split(jnp.asarray(a), m))
    got = PPP._interleave_split(torch.from_numpy(a), m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        PPP._interleave_merge(got).numpy(),
        np.asarray(JPP._interleave_merge(jnp.asarray(want))))
    for k in range(m):                 # microbatch k is rows [k::M]
        np.testing.assert_array_equal(got[k].numpy(), a[k::m])


@pytest.mark.parametrize("n_pipe,n_model,n_data,world", [
    (2, 1, 0, 3), (4, 2, 0, 4), (2, 1, 4, 4), (0, 1, 0, 4)])
def test_layout_checks_are_make_mesh_pipe_s(n_pipe, n_model, n_data, world):
    """The data x pipe x model grid refuses what the JAX package's
    make_mesh_pipe refuses, with its words (ranks for devices)."""
    with pytest.raises(ValueError) as want:
        JPP.make_mesh_pipe(n_pipe, n_model, n_data,
                           devices=list(range(world)))
    with pytest.raises(ValueError) as got:
        mesh.make_layout(n_model, n_data, world, n_pipe)
    assert str(got.value) == str(want.value)


def test_stage_cut_and_join():
    """pipe_stage_tree takes a stage's layers (renumbered) and every leaf
    outside the stacks; pipe_join_trees gives back the whole tree."""
    params = to_port(jax_params(_model_cfg(), VOCAB, seed=1))
    stages = [TC.pipe_stage_tree(params, 2, s) for s in range(2)]
    for s, t in enumerate(stages):
        for stack in ("encoder", "decoder"):
            assert len(t[stack]["layers"]) == LAYERS // 2
            np.testing.assert_array_equal(
                t[stack]["layers"][0]["ffn"]["w1"]["w"].numpy(),
                params[stack]["layers"][2 * s]["ffn"]["w1"]["w"].numpy())
        np.testing.assert_array_equal(t["frontend"]["conv1"]["w"].numpy(),
                                      params["frontend"]["conv1"]["w"]
                                      .numpy())
    full = TC.flatten_params(TC.pipe_join_trees(stages))
    want = TC.flatten_params(params)
    assert list(full) == list(want)
    for k in want:
        np.testing.assert_array_equal(full[k].numpy(), want[k].numpy())
    with pytest.raises(ValueError, match="4 layers do not split over 3"):
        TC.pipe_stage_tree(params, 3, 0)


def test_jax_refusals_are_kept():
    """Root train.py's and pp.py's refusals, in their words."""
    cfg = config_from_args(["--parallel", "--mesh-pipe", "3",
                            "--num-layers", "4"])
    with pytest.raises(ValueError) as want:
        JPP.check_pp_divisibility(cfg, 3)
    with pytest.raises(ValueError) as got:
        port_train.refuse_unported(cfg)
    assert str(got.value) == str(want.value)
    with pytest.raises(SystemExit, match="--mesh-pipe requires --parallel"):
        port_train.refuse_unported(config_from_args(["--mesh-pipe", "2"]))
    with pytest.raises(SystemExit, match="--seq-parallel does not compose "
                                         "with --mesh-pipe"):
        port_train.refuse_unported(config_from_args(
            ["--parallel", "--mesh-pipe", "2", "--num-layers", "4",
             "--mesh-model", "2", "--seq-parallel"]))
    # root train.py:156-163: M divides the per-device microbatch
    with pytest.raises(SystemExit) as e:
        PPP.check_microbatches(12, 2, 2, 4)
    assert str(e.value) == (
        "--pipe-microbatches 4 must divide the per-device microbatch "
        "6//2 (interleaved split stays batch-sharded only then)")
    PPP.check_microbatches(12, 2, 1, 3)
