"""Tensor and sequence parallelism of the port (parallel/tp.py), in one
spawn of gloo ranks on the CPU for the module.

A module-scoped fixture spawns 4 processes once (tests/torch_tp_worker.py,
which imports no JAX): ranks 0-1 run the world-2 scenarios at
--mesh-model 2, then all four the world-4 ones at --mesh-data 2
--mesh-model 2. Each writes its results to files, and the tests below
assert on them:
  * steps against the JAX package's UNSHARDED step on the whole batch
    (its tests/test_tensor_parallel.py and tests/test_seq_parallel.py hold
    JAX's TP and SP equal to that step): plain TP, TP + SP, and with
    --clip under --zero1 / --fsdp, at both layouts; the losses within
    LOSS_TOL, the parameters after two steps by tests/test_torch_train.py's
    rule, the first step's moments within GRAD_TOL of JAX's per leaf;
  * SP with dropout equals TP with dropout (the masks of the slices are
    the slices of the masks);
  * low-rank layers (--model LRTRFS --rank 8, whose factors the shard
    map keeps whole on every rank): TP, TP + SP, TP + SP with --clip
    under --fsdp, and 2 x 2 --zero1 + SP, held as above against the JAX
    package's unsharded LRTRFS step (a gradient a factor of M too small
    on a leaf shows in its first-step moments);
  * train --parallel --mesh-model 2 (also at LRTRFS, and 2 x 2 with
    --zero1 and --seq-parallel) gathers the one-process run's
    parameters, and test --parallel --mesh-model 2 prints the
    one-process strings, greedy and beam; at LRTRFS and with
    --quantize-int8 it prints root test.py's (the JAX package on one
    device), greedy and beam; over a checkpoint whose config has
    seq_parallel it encodes on T slices and prints TP serving's strings.
Without a group: the shard map equals JAX's `param_pspecs` (a low-rank
and a quantised tree too), the partial-gradient leaves, the local-head
rule of the attention's dropout, and the refusals.
"""

import functools
import json
import logging
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from end2end_asr_tpu.parallel import tp as JTP
from end2end_asr_tpu_torch import test as port_test
from end2end_asr_tpu_torch import train as port_train
from end2end_asr_tpu_torch.config import config_from_args
from end2end_asr_tpu_torch.parallel import tp as PTP
from end2end_asr_tpu_torch.training import checkpoint as TC
from end2end_asr_tpu_torch.training import steps as TS

import torch_tp_worker as W
from port_parity import (jax_params, root_cli, small_config, to_port,
                         torch_config)
from synth import make_corpus
from test_torch_parallel import (TEXTS, _argv, _cfg, _flat, _jax_run,
                                 _leaves_close, _one_process, _save_batch,
                                 _save_tree, load)
from test_torch_train import GRAD_TOL, LOSS_TOL, T_FRAMES, VOCAB, _batch, \
    _params_close

WORLD = 4
GROUP_TIMEOUT_S = 600
# SP against TP with the same dropout masks: the sums over the model
# group in another order (reduce-scatter against all-reduce)
SP_TOL = 1e-5
CLIP = dict(clip=True, max_norm=0.5)
RANK = 8
LR = dict(model="LRTRFS", rank=RANK)
LR_ARGS = ["--model", "LRTRFS", "--rank", str(RANK)]

STEPS = {
    "2": {"tp": {}, "tp_sp": {"cfg": {"seq_parallel": True}},
          "tp_zero1_clip": {"cfg": CLIP, "zero": 1},
          "tp_fsdp_sp_clip": {"cfg": dict(CLIP, seq_parallel=True),
                              "zero": 3},
          "tp_drop": {"cfg": {"dropout": 0.1}, "rng": 3},
          "tp_sp_drop": {"cfg": {"dropout": 0.1, "seq_parallel": True},
                         "rng": 3},
          "tp_lr": {"cfg": LR, "params": "lr_params"},
          "tp_lr_sp": {"cfg": dict(LR, seq_parallel=True),
                       "params": "lr_params"},
          "tp_lr_fsdp_sp_clip": {"cfg": dict(LR, **CLIP, seq_parallel=True),
                                 "params": "lr_params", "zero": 3}},
    "4": {"dm": {}, "dm_sp": {"cfg": {"seq_parallel": True}},
          "dm_clip": {"cfg": CLIP},
          "dm_zero1_sp_clip": {"cfg": dict(CLIP, seq_parallel=True),
                               "zero": 1},
          "dm_fsdp_clip": {"cfg": CLIP, "zero": 3},
          "dm_lr_zero1_sp": {"cfg": dict(LR, seq_parallel=True),
                             "params": "lr_params", "zero": 1}},
}
# scenario -> (whether the JAX step it is held against clips, its
# low-rank rank or 0)
AGAINST_JAX = {
    "tp": (False, 0), "tp_sp": (False, 0), "tp_zero1_clip": (True, 0),
    "tp_fsdp_sp_clip": (True, 0), "dm": (False, 0), "dm_sp": (False, 0),
    "dm_clip": (True, 0), "dm_zero1_sp_clip": (True, 0),
    "dm_fsdp_clip": (True, 0), "tp_lr": (False, RANK),
    "tp_lr_sp": (False, RANK), "tp_lr_fsdp_sp_clip": (True, RANK),
    "dm_lr_zero1_sp": (False, RANK)}


# LRTRFS with --clip: the clip scales the front end's gradients down to
# the order of Adam's eps (1e-9), where a step is no longer ~lr·sign(g)
# but proportional to g, and so inherits the front end's f32 conditioning
# against JAX's (its pools and clips route the gradient by comparisons
# that f32 roundings flip near ties: up to ~4e-3 of a leaf on either
# package, tests/test_torch_train.py::frontend_against_f64). The port's
# one-process step moves 835 front-end weights of 628864 more than 1e-5
# from JAX's after two steps, while its losses and first-step moments
# equal JAX's. The parameters of these scenarios are held against that
# one-process step, by the same rule; their losses and moments against
# JAX's.
PARAMS_AGAINST_ONE_PROCESS = ("tp_lr_fsdp_sp_clip",)


def _params(rank: int = 0):
    return jax_params(_cfg(rank=rank), VOCAB, seed=4)


@functools.lru_cache(maxsize=None)
def _jax_reference(clip: bool, rank: int = 0):
    cfg = _cfg(rank=rank).replace(**(CLIP if clip else {}))
    return _jax_run(cfg, _params(rank), _batch(0), steps=W.STEPS)


@functools.lru_cache(maxsize=None)
def _root_hyps(argv):
    """The hypotheses that root test.py (the JAX package, one device)
    logs for `argv`."""
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    log = logging.getLogger("end2end_asr_tpu")
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        root_cli("test").main(list(argv))
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    return [ln.split("HYP: ", 1)[1].split(" || GOLD: ")[0]
            for ln in lines if ln.startswith("HYP: ")]


# the TP serving runs over low-rank and int8 weights: name ->
# (checkpoint, flags)
SERVED = {"lr": ("one_lr", []), "int8": ("one", ["--quantize-int8"])}
BEAM = ["--beam-search", "--beam-width", "3"]


def _model_argv(corpus, root):
    """tests/test_torch_parallel.py's entry-point model with 4 heads and
    dim_inner 64, so that they split in two, at dropout 0 (a rank's
    attention draws its masks by local head)."""
    argv = _argv(corpus, root)
    for flag, val in (("--num-heads", "4"), ("--dim-inner", "64")):
        argv[argv.index(flag) + 1] = val
    return argv + ["--dropout", "0"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    cfg = _cfg()
    params = _params()
    _save_tree(os.path.join(root, "params.npz"), params)
    _save_tree(os.path.join(root, "lr_params.npz"), _params(RANK))
    _save_batch(os.path.join(root, "ce.npz"), _batch(0))
    corpus = make_corpus(os.path.join(root, "corpus"), texts=TEXTS)
    train = _model_argv(corpus, root) + ["--device", "cpu"]
    ck = lambda name: os.path.join(root, "models", name, "epoch_1")
    test = ["--test-manifest-list", corpus[0], "--batch-size", "4",
            "--device", "cpu", "--verbose"]
    entry = {
        "2": [{"name": "train_tp", "train": train + [
                  "--name", "tp", "--parallel", "--mesh-model", "2"]},
              {"name": "test_tp", "test": test + [
                  "--continue-from", ck("one"), "--parallel",
                  "--mesh-model", "2"]},
              {"name": "test_tp_beam", "test": test + [
                  "--continue-from", ck("one"), "--parallel",
                  "--mesh-model", "2", "--beam-search", "--beam-width",
                  "3"]},
              {"name": "train_tp_lr", "train": train + LR_ARGS + [
                  "--name", "tp_lr", "--parallel", "--mesh-model", "2"]},
              *({"name": "test_tp_" + name + beam, "test": test + [
                  "--continue-from", ck(ckpt), "--parallel",
                  "--mesh-model", "2", *extra, *beam_args]}
                for name, (ckpt, extra) in SERVED.items()
                for beam, beam_args in (("", []), ("_beam", BEAM))),
              {"name": "test_sp", "test": test + [
                  "--continue-from", ck("one_sp"), "--parallel",
                  "--mesh-model", "2"]},
              {"name": "test_sp_typed", "test": test + [
                  "--continue-from", ck("one"), "--parallel",
                  "--mesh-model", "2", "--seq-parallel"]}],
        "4": [{"name": "train_dm", "train": train + [
                  "--name", "dm", "--parallel", "--mesh-data", "2",
                  "--mesh-model", "2", "--zero1", "--seq-parallel"]}]}
    spec = {"cfg": torch_config(cfg).to_dict(), "T": T_FRAMES,
            "steps": STEPS, "entry": entry,
            "encode": {"2": [{"name": "enc_lr_bf16",
                              "cfg": dict(LR, dtype="bfloat16"),
                              "params": "lr_params", "batch": "ce"}]}}
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    # the one-process runs whose checkpoints the tests serve (--parallel
    # at one rank: the ragged bin cycled to the full batch, as on the
    # ranks); "one_sp" is "one" with seq_parallel in its config, as a
    # --seq-parallel run writes it
    cwd = os.getcwd()
    os.chdir(root)
    try:
        one = port_train.main(train + ["--name", "one", "--parallel"])
        one_lr = port_train.main(train + LR_ARGS + ["--name", "one_lr",
                                                    "--parallel"])
    finally:
        os.chdir(cwd)
    os.makedirs(os.path.dirname(ck("one_sp")))
    shutil.copy(ck("one") + ".npz", ck("one_sp") + ".npz")
    with open(ck("one") + ".json", encoding="utf-8") as f:
        meta = json.load(f)
    meta["args"]["seq_parallel"] = True
    with open(ck("one_sp") + ".json", "w", encoding="utf-8") as f:
        json.dump(meta, f)
    ctx = mp.spawn(W.run, args=(WORLD, root), nprocs=WORLD, join=False)
    deadline = time.time() + GROUP_TIMEOUT_S
    while not ctx.join(timeout=5):     # a rank's exception raises here
        if time.time() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"the {WORLD}-rank group ran over "
                        f"{GROUP_TIMEOUT_S} s")
    return root, (cfg, params), corpus, {"one": one, "one_lr": one_lr}


def _ranks(name):
    return 2 if name.startswith("tp") else 4


@pytest.mark.parametrize("name", sorted(AGAINST_JAX))
def test_step_equals_the_unsharded_jax_step(group, name):
    root, (cfg, params), _, _ = group
    got = [load(root, name, r) for r in range(_ranks(name))]
    for other in got[1:]:
        for k in got[0]:
            assert np.array_equal(got[0][k], other[k]), k
    got = got[0]
    clip, rank = AGAINST_JAX[name]
    jp, jopts, _, jms = _jax_reference(clip, rank)
    for i, jm in enumerate(jms):
        np.testing.assert_allclose(got["loss"][i], float(jm["loss"]),
                                   rtol=LOSS_TOL)
        assert got["num_token"][i] == int(jm["num_token"])
        assert got["num_correct"][i] == int(jm["num_correct"])
    assert int(got["step"]) == W.STEPS
    fp = TS.FlatParams(to_port(_params(rank) if rank else params),
                       torch.device("cpu"))
    want = _flat(jp, fp.train_keys)
    if name in PARAMS_AGAINST_ONE_PROCESS:
        want = _one_process(_cfg(rank=rank).replace(**CLIP), _params(rank),
                            root, "ce")["data"]
    _params_close(got["data"], want, [float(jm["lr"]) for jm in jms])
    for m in ("mu", "nu"):
        _leaves_close(fp, got[m + "1"], _flat(jopts[0][m], fp.train_keys),
                      GRAD_TOL)


def test_sp_with_dropout_equals_tp_with_dropout(group):
    """The same masks: the losses within SP_TOL, the first step's moments
    per leaf within GRAD_TOL and the parameters after two steps by the
    parameter rule (sums over the model group in another order)."""
    root, (_, params), _, _ = group
    a, b = load(root, "tp_drop"), load(root, "tp_sp_drop")
    np.testing.assert_allclose(b["loss"], a["loss"], rtol=SP_TOL)
    fp = TS.FlatParams(to_port(params), torch.device("cpu"))
    for m in ("mu1", "nu1"):
        _leaves_close(fp, b[m], a[m], GRAD_TOL)
    _params_close(b["data"], a["data"], list(a["lr"]))
    # and the dropout did act: the losses differ from the dropout-0 run's
    assert abs(a["loss"][0] - load(root, "tp")["loss"][0]) > 1e-3


@pytest.mark.parametrize("name", ["train_tp", "train_dm", "train_tp_lr"])
def test_train_entry_point_gathers_the_one_process_parameters(group, name):
    """train --parallel --mesh-model 2 (world 2; also at LRTRFS), and
    --mesh-data 2 --mesh-model 2 --zero1 --seq-parallel (world 4): one
    epoch of 2 steps on the 5-utterance corpus, its returned (gathered)
    parameters against the one-process run's, by the parameter rule; its
    checkpoint is the gathered npz file."""
    root, _, _, ones = group
    got = load(root, name)
    one = ones["one_lr" if name.endswith("_lr") else "one"]
    want = {k: v.numpy()
            for k, v in TC.flatten_params(one["params"]).items()}
    assert set(got) == set(want)
    cat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])
    d = np.abs(cat(got) - cat(want))
    assert (d <= 1e-5).mean() >= 0.999 and d.max() < 1e-2, name
    base = os.path.join(root, "models", name[len("train_"):], "epoch_1")
    _, _, saved, opt, _, _, _, _ = TC.load_checkpoint(base)
    for k, v in TC.flatten_params(saved).items():
        np.testing.assert_array_equal(v.numpy(), got[k])
    assert int(opt["step"]) == 2


@pytest.mark.parametrize("name", ["test_tp", "test_tp_beam"])
def test_test_entry_point_prints_the_one_process_strings(group, name):
    root, _, corpus, _ = group
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    log = logging.getLogger("end2end_asr_tpu_torch")
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    argv = ["--test-manifest-list", corpus[0], "--batch-size", "4",
            "--device", "cpu", "--verbose", "--continue-from",
            os.path.join(root, "models", "one", "epoch_1")]
    if name.endswith("beam"):
        argv += ["--beam-search", "--beam-width", "3"]
    try:
        want = port_test.main(argv)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    got = load(root, name)
    hyps = [ln for ln in lines if ln.startswith("HYP: ")]
    assert len(hyps) == len(TEXTS)
    assert list(got["hyps"]) == hyps
    assert float(got["cer"]) == want["cer"]
    assert load(root, name, 1)["hyps"].size == 0   # rank 0 alone prints


@pytest.mark.parametrize("name", sorted(
    "test_tp_" + n + b for n in SERVED for b in ("", "_beam")))
def test_low_rank_and_int8_tp_serving_prints_the_jax_strings(group, name):
    """test --parallel --mesh-model 2 over the one-process LRTRFS run's
    checkpoint, and over the full-rank one's with --quantize-int8 (each
    rank quantises the whole checkpoint, then keeps its shard: the int8
    weights whole, its columns of the column parents' biases), at f32,
    greedy and beam: the strings and CER of root test.py on one device."""
    root, _, corpus, _ = group
    key = name[len("test_tp_"):].replace("_beam", "")
    ckpt, extra = SERVED[key]
    argv = ("--test-manifest-list", corpus[0], "--batch-size", "4",
            "--verbose", "--continue-from",
            os.path.join(root, "models", ckpt, "epoch_1"), *extra,
            *(BEAM if name.endswith("_beam") else ()))
    want = _root_hyps(argv)
    got = load(root, name)
    hyps = [h.split("HYP: ", 1)[1].split(" || GOLD: ")[0]
            for h in got["hyps"]]
    assert len(want) == len(TEXTS) and hyps == want
    assert load(root, name, 1)["hyps"].size == 0


def test_sp_serving_prints_the_tp_strings_from_t_slices(group):
    """A checkpoint whose config has seq_parallel, served by test
    --parallel --mesh-model 2: the encoder runs on T slices (split_seq
    called on every rank, never under plain TP) and the strings and CER
    are TP serving's on the same weights."""
    root = group[0]
    sp, plain = load(root, "test_sp"), load(root, "test_tp")
    assert list(sp["hyps"]) == list(plain["hyps"]) and len(sp["hyps"]) == 5
    assert float(sp["cer"]) == float(plain["cer"])
    assert int(sp["seq_slices"]) > 0 and int(plain["seq_slices"]) == 0
    assert int(load(root, "test_sp", 1)["seq_slices"]) == int(
        sp["seq_slices"])


def _bf16_encoder_gaps(root):
    """LRTRFS at bf16: (the port's TP encoder output against its one
    process, JAX's 2-device model mesh against its one device), each the
    largest absolute difference; tests/lowrank_bf16_gap.py prints more."""
    from end2end_asr_tpu.models.transformer import dims_from_config
    from end2end_asr_tpu.parallel.tp import make_mesh_2d, shard_params
    from end2end_asr_tpu.training.steps import make_encode_fn
    from end2end_asr_tpu_torch.evaluation import encode_pcm, prepare_params
    from end2end_asr_tpu_torch.models.transformer import \
        dims_from_config as port_dims
    cfg = _cfg(rank=RANK).replace(dtype="bfloat16")
    params = _params(RANK)
    pcm, n_frames = _batch(0)[:2]
    tcfg = torch_config(cfg)
    dims = port_dims(tcfg)
    with torch.no_grad():
        one, _ = encode_pcm(prepare_params(to_port(params), dims,
                                           torch.device("cpu")), tcfg, dims,
                            torch.from_numpy(pcm),
                            torch.from_numpy(n_frames.astype(np.int64)),
                            T_FRAMES)
    tp2 = load(root, "enc_lr_bf16")["enc"]
    assert np.array_equal(tp2, load(root, "enc_lr_bf16", 1)["enc"])
    encode = make_encode_fn(cfg, dims_from_config(cfg), from_pcm=True)
    jone, _ = encode(params, {}, pcm, n_frames, spect_T=T_FRAMES)
    jtp2, _ = encode(shard_params(make_mesh_2d(2, n_data=1), params), {},
                     pcm, n_frames, spect_T=T_FRAMES)
    gap = lambda a, b: float(np.abs(np.asarray(a, np.float32)
                                    - np.asarray(b, np.float32)).max())
    return gap(tp2, one.float().numpy()), gap(jtp2, jone)


def test_low_rank_tp_encoder_at_bf16_is_no_farther_than_jax(group):
    """LRTRFS (--rank 8) served at bf16: the port's encoder at --mesh-model
    2 is no farther from its one-process output than the JAX package's
    2-device model mesh is from its one device (a rounding of the r-wide
    partial product that one process does not do would show here)."""
    port_gap, jax_gap = _bf16_encoder_gaps(group[0])
    assert port_gap <= jax_gap, (port_gap, jax_gap)


def test_typed_seq_parallel_serves_on_t_slices(group):
    """A typed --seq-parallel over a checkpoint trained without it: test
    --parallel --mesh-model 2 serves the encoder on T slices (split_seq
    counted on both ranks) and prints TP serving's strings and CER."""
    root = group[0]
    sp, plain = load(root, "test_sp_typed"), load(root, "test_tp")
    assert list(sp["hyps"]) == list(plain["hyps"]) and len(sp["hyps"]) == 5
    assert float(sp["cer"]) == float(plain["cer"])
    assert int(sp["seq_slices"]) > 0
    assert int(load(root, "test_sp_typed", 1)["seq_slices"]) == int(
        sp["seq_slices"])


def test_typed_seq_parallel_in_one_process_does_nothing(group):
    """One process, --device cpu --seq-parallel: no model axis, so the
    flag does nothing (root test.py), and the strings and CER are those
    of the run without it."""
    root, _, corpus, _ = group
    argv = ["--test-manifest-list", corpus[0], "--batch-size", "4",
            "--device", "cpu", "--continue-from",
            os.path.join(root, "models", "one", "epoch_1")]
    want = port_test.main(argv)
    got = port_test.main(argv + ["--seq-parallel"])
    assert got["cer"] == want["cer"] and got["wer"] == want["wer"]


# ---------------------------------------------------------------------------
# without a group
# ---------------------------------------------------------------------------

def _jax_specs(params, n_model):
    specs = jax.tree_util.tree_flatten_with_path(
        JTP.param_pspecs(params, n_model),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {}
    for path, spec in specs:
        key = "::".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        dims = [i for i, a in enumerate(spec) if a == "model"]
        want[key] = dims[0] if dims else None
    return want


@pytest.mark.parametrize("n_model", [2, 4])
def test_param_pspecs_equal_jax(n_model):
    """The port's shard map is JAX's on the same tree, with an
    indivisible leaf (w1 of 6 inner columns at n_model 4) replicated."""
    cfg = small_config(num_heads=4, dim_inner=8 if n_model == 2 else 6)
    params = jax_params(cfg, VOCAB, seed=1)
    got = PTP.param_pspecs(TC.flatten_params(to_port(params)), n_model)
    assert got == _jax_specs(params, n_model)
    assert sum(d is not None for d in got.values()) > 0
    if n_model == 4:
        assert got["encoder::layers::0::ffn::w1::w"] is None
        assert got["encoder::layers::0::ffn::w2::w"] is None


@pytest.mark.parametrize("variant", ["lowrank", "int8"])
def test_param_pspecs_of_low_rank_and_int8_trees_equal_jax(variant):
    """The shard map of an LRTRFS tree and of a quantised tree (the JAX
    package's and the port's quantize_for_inference on the same weights)
    is JAX's: the factors u / v and the int8 q8 / scale whole on every
    rank, a column parent's bias split, a row parent's replicated."""
    from end2end_asr_tpu.models.quantize import quantize_for_inference
    from end2end_asr_tpu_torch.models.quantize import \
        quantize_for_inference as port_quantize
    params = jax_params(small_config(rank=RANK if variant == "lowrank"
                                     else 0, num_heads=4, dim_inner=8),
                        VOCAB, seed=1)
    port = to_port(params)
    if variant == "int8":
        params, port = quantize_for_inference(params), port_quantize(port)
    got = PTP.param_pspecs(TC.flatten_params(port), 2)
    assert got == _jax_specs(params, 2)
    leaf = "encoder::layers::0::self_attn::"
    factors = ("u", "v") if variant == "lowrank" else ("q8", "scale")
    for parent in ("q", "out"):
        for f in factors:
            assert got[leaf + parent + "::" + f] is None
    assert got[leaf + "q::b"] == 0 and got[leaf + "out::b"] is None


@pytest.mark.parametrize("seq", [False, True], ids=["tp", "tp_sp"])
def test_partial_gradient_leaves_leaf_by_leaf(seq):
    """FlatPlan's partial ranges, leaf by leaf over an LRTRFS tree (2
    encoder and 2 decoder layers): a column parent's u and v and a row
    parent's u (a rank touches them through its own columns or rows);
    under SP also the encoder layers' LayerNorms and a row parent's v and
    b (applied to a T slice); every other leaf is whole on each rank. A
    full-rank tree has none without SP; at one model rank, none."""
    keys = TS.FlatParams(to_port(_params(RANK)),
                         torch.device("cpu")).train_keys
    got = set(PTP.partial_keys(keys, seq))
    n = 0
    for k in keys:
        *path, parent, leaf = k.split("::")
        if "layers" not in path:
            assert k not in got, k
            continue
        column = parent in ("q", "k", "v", "w1")
        row = parent in ("out", "w2")
        enc_slice = seq and path[0] == "encoder" and (
            parent == "ln" or (row and leaf in ("v", "b")))
        want = (column and leaf in ("u", "v")) or (row and leaf == "u") \
            or enc_slice
        assert (k in got) == want, k
        n += want
    # q, k, v, w1 (u, v) and out, w2 (u): 10 leaves an encoder layer, 17 a
    # decoder layer; SP adds two LayerNorms (4) and out, w2 (v, b) (4)
    assert len(got) == n == 2 * 10 + 2 * 17 + (2 * 8 if seq else 0)
    full = TS.FlatParams(to_port(_params()), torch.device("cpu"))
    assert PTP.partial_keys(full.train_keys, False) == []
    fp = TS.FlatParams(to_port(_params(RANK)), torch.device("cpu"))
    offsets = dict(zip(fp.train_keys, np.cumsum([0] + fp.sizes[:-1])))
    plan = PTP.FlatPlan(fp, [], 2, seq)
    assert sorted(plan.partial) == sorted(
        (int(offsets[k]), fp.sizes[fp.train_keys.index(k)]) for k in got)
    assert PTP.FlatPlan(fp, [], 1, seq).partial == []


def test_local_heads_draw_the_same_dropout_masks():
    """The attention's dropout seeds by LOCAL head: each rank's call on
    its 4 of 8 heads, with the run's seed, drops for local head h what
    the other rank's call drops for its local head h (the kernels' rule,
    the JAX package's sharded kernel's), whatever the data. V = I makes
    the output's non-zeros the kept probabilities."""
    from end2end_asr_tpu_torch.ops import attention_fused as AF
    r = np.random.RandomState(0)
    B, H, T = 2, 8, 16
    q, k = (torch.from_numpy(r.randn(B, H, T, T).astype(np.float32))
            for _ in range(2))
    v = torch.eye(T).expand(B, 4, T, T)
    bias = torch.zeros(B, T, T)
    kept = [AF.flash_mha_train(q[:, h].contiguous(), k[:, h].contiguous(),
                               v, bias, 1234, 0.3) != 0
            for h in (slice(0, 4), slice(4, 8))]
    assert torch.equal(kept[0], kept[1])
    assert torch.equal(kept[0], AF.keep_mask(1234, B, 4, T, T,
                                             AF.dropout_thresh16(0.3)))
    assert not torch.equal(kept[0][:, 0], kept[0][:, 1])


@pytest.mark.parametrize("flags,match", [
    (["--parallel", "--mesh-model", "4", "--num-heads", "4",
      "--dim-inner", "6"], "--dim-inner 6 must be divisible by "
                           "--mesh-model 4"),
    (["--parallel", "--mesh-model", "4", "--num-heads", "6"],
     r"--num-heads 6 must be divisible by --mesh-model 4 \(whole"),
])
def test_indivisible_heads_or_inner_width_refuse(flags, match):
    with pytest.raises(ValueError, match=match):
        port_train.refuse_unported(config_from_args(flags))


def test_seq_parallel_refuses_an_indivisible_time_axis():
    """check_seq_divisible, as the JAX package words it, at a layout of
    two model ranks."""
    from end2end_asr_tpu_torch.parallel import mesh
    lay = mesh._LAYOUT
    mesh._LAYOUT = type("L", (), {"n_model": 2, "n_data": 1})()
    try:
        with pytest.raises(ValueError, match="encoder time dim 7 must be "
                           "divisible by the model-axis size 2"):
            PTP.check_seq_divisible(7)
        PTP.check_seq_divisible(8)
    finally:
        mesh._LAYOUT = lay


@pytest.mark.parametrize("n_model,n_data,world", [(2, 0, 3), (4, 0, 2),
                                                  (2, 2, 2)])
def test_layout_checks_are_make_mesh_2d_s(n_model, n_data, world):
    """The data x model grid refuses what the JAX package's make_mesh_2d
    refuses, with its words (ranks for devices)."""
    from end2end_asr_tpu_torch.parallel import mesh
    with pytest.raises(ValueError) as want:
        JTP.make_mesh_2d(n_model, n_data, devices=list(range(world)))
    with pytest.raises(ValueError) as got:
        mesh.make_layout(n_model, n_data, world)
    assert str(got.value) == str(want.value)
    # a subset of the ranks is refused: each rank is one device
    with pytest.raises(ValueError, match="must equal the number of ranks"):
        mesh.make_layout(2, 1, 4)
