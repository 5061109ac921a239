"""Port parity: the training slice.

The port's loss, optimizer functions, training forward and gradients, one
whole train step (and the next), gradient accumulation, the skipped step
on an infinite loss and the checkpoint with optimizer state, each against
the JAX package on the same numpy inputs and the same weights (JAX
init_transformer through the weight bridge). f32 and dropout 0 on both
sides, so the two compute the same function; the dropout paths are held
by tests/test_torch_attention.py. Then the port's train entry point runs
one epoch on the CPU and refuses to start without a card unless asked.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu.models import transformer as JT
from end2end_asr_tpu.training import loss as JL
from end2end_asr_tpu.training import optimizer as JO
from end2end_asr_tpu.training.checkpoint import (flatten_tree,
                                                 load_checkpoint,
                                                 save_checkpoint)
from end2end_asr_tpu.training.steps import make_train_step_impl
from end2end_asr_tpu_torch import train as port_train
from end2end_asr_tpu_torch.models import transformer as TT
from end2end_asr_tpu_torch.training import checkpoint as TC
from end2end_asr_tpu_torch.training import loss as TL
from end2end_asr_tpu_torch.training import optimizer as TO
from end2end_asr_tpu_torch.training import steps as TS

from port_parity import jax_params, small_config, to_port, torch_config
from synth import make_corpus

VOCAB = 12
B, T_FRAMES = 4, 48
# f32 through the front end, 2+2 layers, the loss and its backward: sums in
# another order, ~1e-6 relative per op
LOSS_TOL = 1e-5
# relative to the largest |grad| of each leaf, floored at 1e-3 of the
# largest |grad| of the model: the k-projection bias has an exactly zero
# gradient (softmax ignores a shift shared by all keys), ~1e-10 of noise
GRAD_TOL = 2e-4
OPT_TOL = 1e-6       # the optimizer functions alone, on the same arrays
# Adam's early steps move each parameter by about lr·sign(grad): where a
# gradient is at noise level (~1e-7 of the largest) the two sides may move
# it opposite ways. After whole steps, 99.9% of the parameters must agree
# within 1e-5 and every one within 2·(sum of the lrs).
STEP_TOL, STEP_SHARE = 1e-5, 0.999


def _params_close(got, want, lrs, name=""):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= 2 * sum(lrs), name
    assert (d <= STEP_TOL).mean() >= STEP_SHARE, name


def _cfg(**kw):
    base = dict(dropout=0.0, label_smoothing=0.1, batch_size=B,
                src_max_len=T_FRAMES, tgt_max_len=16, warmup=10, k_lr=1.0)
    base.update(kw)
    return small_config(**base)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    n = (T_FRAMES - 1) * 160 + 320
    pcm = (rng.randn(B, n) * 0.2).astype(np.float32)
    n_frames = np.array([T_FRAMES, 40, 33, T_FRAMES - 2], np.int32)
    U = 10
    targets = np.zeros((B, U), np.int32)
    tgt_lengths = np.array([7, 10, 4, 6], np.int32)
    for i, L in enumerate(tgt_lengths):
        targets[i, :L] = rng.randint(3, VOCAB, size=L)
        targets[i, 0], targets[i, L - 1] = 1, 2        # SOS ... EOS
    return pcm, n_frames, targets, tgt_lengths


def _port_batch(batch):
    pcm, n_frames, targets, tgt_lengths = batch
    return (torch.from_numpy(pcm), torch.from_numpy(n_frames.astype(np.int64)),
            torch.from_numpy(targets.astype(np.int64)),
            torch.from_numpy(tgt_lengths.astype(np.int64)))


def _rel(a, b, floor=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), floor)


# ---------------------------------------------------------------------------
# loss and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_and_accuracy_match_jax(smoothing):
    rng = np.random.RandomState(1)
    pred = rng.randn(3, 7, 11).astype(np.float32) * 3
    gold = rng.randint(0, 11, size=(3, 7)).astype(np.int32)
    gold[0, 4:] = 0
    want = JL.cross_entropy_loss(jnp.asarray(pred), jnp.asarray(gold),
                                 smoothing)
    got = TL.cross_entropy_loss(torch.from_numpy(pred),
                                torch.from_numpy(gold), smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL)
    assert int(TL.token_accuracy(torch.from_numpy(pred),
                                 torch.from_numpy(gold))) == int(
        JL.token_accuracy(jnp.asarray(pred), jnp.asarray(gold)))
    with pytest.raises(ValueError, match="loss is not defined"):
        TL.calculate_loss(torch.from_numpy(pred), torch.from_numpy(gold),
                          loss_type="mse")


def _tree(seed, shapes=((5, 3), (4,))):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(*shapes[0]).astype(np.float32),
            "b": [rng.randn(*shapes[1]).astype(np.float32)]}


def _to_t(tree):
    return TO.tree_map(torch.from_numpy, tree)


def _close_trees(got, want, tol):
    g = TO.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("moments", [None, "bfloat16"])
def test_adam_noam_and_clip_match_jax(moments):
    c = JO.NoamConfig(model_size=161, factor=2.0, warmup=5, min_lr=1e-6)
    tc = TO.NoamConfig(*c)
    p, g1, g2 = _tree(0), _tree(1), _tree(2)
    js = JO.init_adam_state(p, moments_dtype=moments and jnp.bfloat16)
    ts = TO.init_adam_state(_to_t(p), moments_dtype=moments
                            and torch.bfloat16)
    jp, tp = p, _to_t(p)
    for g, clip in ((g1, False), (g2, True)):
        jp, js, jlr = JO.adam_noam_update(jp, g, js, c, clip=clip,
                                          max_norm=0.5)
        tp, ts, tlr = TO.adam_noam_update(tp, _to_t(g), ts, tc, clip=clip,
                                          max_norm=0.5)
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    _close_trees(tp, jp, OPT_TOL)
    _close_trees(ts["mu"], js["mu"], 1e-2 if moments else OPT_TOL)
    _close_trees(ts["nu"], js["nu"], 1e-2 if moments else OPT_TOL)
    for step in (1, 5, 100):
        np.testing.assert_allclose(
            float(TO.noam_rate(torch.tensor(step), tc)),
            float(JO.noam_rate(jnp.asarray(step), c)), rtol=1e-6)
    _, jn = JO.clip_by_global_norm(g1, 1.0)
    _, tn = TO.clip_by_global_norm(_to_t(g1), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)


def test_sgd_annealing_and_init_opt_state_match_jax():
    cfg = _cfg(opt="sgd_annealing", lr=0.1)
    p, g = _tree(3), _tree(4)
    js = JO.init_opt_state(cfg, p)
    ts = TO.init_opt_state(torch_config(cfg), _to_t(p))
    jp, js, jlr = JO.sgd_annealing_update(p, g, js, 0.9, 1.1)
    tp, ts, tlr = TO.sgd_annealing_update(_to_t(p), _to_t(g), ts, 0.9, 1.1)
    np.testing.assert_allclose(float(tlr), float(jlr), rtol=1e-6)
    _close_trees(tp, jp, OPT_TOL)
    _close_trees(ts["buf"], js["buf"], OPT_TOL)
    assert set(TO.init_opt_state(torch_config(_cfg()), _to_t(p))) == {
        "step", "mu", "nu"}


# ---------------------------------------------------------------------------
# forward, gradients, train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    return cfg, jax_params(cfg, VOCAB, seed=4)


def _jax_loss_fn(cfg, batch, state=None):
    dims = JT.dims_from_config(cfg)
    pcm, n_frames, targets, tgt_lengths = (jnp.asarray(a) for a in batch)
    from end2end_asr_tpu.ops.features import batched_features
    spect = batched_features(pcm, n_frames, cfg.n_fft, cfg.hop_length,
                             cfg.window, T_out=T_FRAMES, normalize=True)

    def loss_fn(p):
        pred, gold, _ = JT.forward(p, state or {}, spect, n_frames,
                                   targets, dims, train=True, rng=None)
        return JL.calculate_loss(pred, gold, None, tgt_lengths,
                                 cfg.label_smoothing, "ce")
    return loss_fn


@functools.lru_cache(maxsize=None)
def _jax_batch_loss(cfg):
    """JAX's loss as a function of (params, batch, state)."""
    return lambda p, batch, state: _jax_loss_fn(cfg, batch, state)(p)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(_jax_batch_loss(cfg)))


def frontend_against_f64(cfg, params, state, batch, loss_of, got, want,
                         floor):
    """The front end's leaves of the port's f32 gradient `got` and JAX's
    `want` (flat, full model) against the float64 gradient. The max pools
    and relu / clip of a conv front end route the gradient by comparisons,
    and the f32 roundings of the spectrogram and of the convolutions flip
    near-ties on either package (tests/port_parity.py), so neither f32
    side need lie within GRAD_TOL of the other. The float64 gradient is
    the port's plain front end in float64, which equals the JAX
    package's float64 front end
    (tests/test_torch_pool.py::test_frontend_gradients_in_float64_equal_jax).
    At f32 the port lies no further from it than JAX does, within
    GRAD_TOL: the largest distance over the front end's leaves (which
    leaf a flipped near-tie moves most differs between the two: at
    _batch(2) the port's conv1::w lies 1.72e-3 from float64 and JAX's
    1.48e-3, while JAX's conv2::w lies 1.9e-3 and the port's 1.9e-4).
    `loss_of(params, batch, state)` is JAX's loss. Returns {leaf: (port's,
    JAX's) distance}."""
    from end2end_asr_tpu.models import frontend as JF
    from end2end_asr_tpu.ops.features import batched_features
    from port_parity import (feature_cotangent, port_frontend_grads_f64,
                             spect_f64)
    pcm, n_frames = batch[:2]
    fe = params["frontend"]
    st = state.get("frontend") if state else None
    spect = batched_features(jnp.asarray(pcm), jnp.asarray(n_frames),
                             cfg.n_fft, cfg.hop_length, cfg.window,
                             T_out=T_FRAMES, normalize=True)
    feats, _ = JF.apply_frontend(fe, st, spect, cfg.feat_extractor,
                                 train=True, dtype=jnp.float32)
    g = feature_cotangent(loss_of, params, feats, batch, state or {})
    ref = port_frontend_grads_f64(fe, st, spect_f64(pcm, n_frames, cfg,
                                                    T_FRAMES),
                                  g, cfg.feat_extractor)
    out = {k: (_rel(np.asarray(got["frontend::" + k]), r, floor),
               _rel(want["frontend::" + k], r, floor))
           for k, r in ref.items()}
    port, jax_ = (max(d[i] for d in out.values()) for i in (0, 1))
    assert port <= jax_ + GRAD_TOL, out
    return out


@pytest.mark.parametrize("seed", range(5))
def test_forward_loss_and_all_gradients_match_jax(model, seed):
    """The loss, and every gradient outside the front end within GRAD_TOL
    of JAX's; the front end's against float64 (`frontend_against_f64`)."""
    cfg, params = model
    batch = _batch(seed)
    want_loss, want_g = _jax_value_and_grad(cfg)(params, batch, {})
    fp = TS.FlatParams(to_port(params), torch.device("cpu"))
    leaf = fp.data.clone().requires_grad_()
    dims = TT.dims_from_config(torch_config(cfg))
    pcm, n_frames, targets, tgt_lengths = _port_batch(batch)
    spect = TS.features(torch_config(cfg), pcm, n_frames, T_FRAMES)
    pred, gold = TT.forward(fp.tree(leaf), spect, n_frames, targets, dims,
                            train=True)
    loss = TL.calculate_loss(pred, gold, None, tgt_lengths,
                             cfg.label_smoothing)
    grad, = torch.autograd.grad(loss, leaf)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_TOL)
    got = fp.views(grad)
    flat_want = flatten_tree(want_g)
    assert set(got) == {k for k in flat_want if not k.endswith("::pe")}
    floor = 1e-3 * max(np.abs(v).max() for v in flat_want.values())
    for k, g in got.items():
        if not k.startswith("frontend::"):
            assert _rel(g.numpy(), flat_want[k], floor) < GRAD_TOL, k
    frontend_against_f64(cfg, params, None, batch, _jax_batch_loss(cfg),
                         {k: v.numpy() for k, v in got.items()}, flat_want,
                         floor)
    # the JAX package's stop_gradient: the tables get exactly zero
    for k in ("encoder::pe", "decoder::pe"):
        assert not np.any(flat_want[k])


def _jax_step(cfg, params, batches):
    dims = JT.dims_from_config(cfg)
    step = jax.jit(make_train_step_impl(cfg, dims, from_pcm=True),
                   static_argnames=("spect_T",))
    opt = JO.init_opt_state(cfg, params)
    out = []
    for b in batches:
        params, opt, _, m, hyp, gold = step(
            params, opt, {}, jax.random.PRNGKey(0),
            *(jnp.asarray(a) for a in b), spect_T=T_FRAMES)
        out.append((m, hyp, gold))
    return params, opt, out


def _port_steps(cfg, params, batches):
    tcfg = torch_config(cfg)
    fp = TS.FlatParams(to_port(params), torch.device("cpu"))
    step = TS.make_train_step_impl(tcfg, TT.dims_from_config(tcfg))
    data = fp.data
    opt = TO.init_opt_state(tcfg, data)
    out = []
    for b in batches:
        data, opt, _, m, hyp, gold = step(fp, data, opt, None,
                                          *_port_batch(b), T_FRAMES)
        out.append((m, hyp, gold))
    return fp, data, opt, out


def test_two_train_steps_match_make_train_step_impl(model):
    cfg, params = model
    batches = [_batch(0), _batch(0)]
    jp, jopt, jout = _jax_step(cfg, params, batches)
    fp, data, opt, tout = _port_steps(cfg, params, batches)
    for (jm, jh, jg), (tm, th, tg) in zip(jout, tout):
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(tm["num_token"]) == int(jm["num_token"])
        assert int(tm["num_correct"]) == int(jm["num_correct"])
        assert bool(tm["finite"]) and bool(jm["finite"])
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert int(opt["step"]) == int(jopt["step"]) == 2
    lrs = [m["lr"].item() for m, _, _ in tout]
    flat_want = flatten_tree(jp)
    got = fp.views(data)
    _params_close(torch.cat([v.reshape(-1) for v in got.values()]).numpy(),
                  np.concatenate([flat_want[k].reshape(-1) for k in got]),
                  lrs)


def test_grad_accum_equals_full_batch(model):
    cfg, params = model
    batch = [_batch(2)]
    _, data1, opt1, out1 = _port_steps(cfg, params, batch)
    _, data2, opt2, out2 = _port_steps(cfg.replace(grad_accum=2), params,
                                       batch)
    np.testing.assert_allclose(out2[0][0]["loss"].item(),
                               out1[0][0]["loss"].item(), rtol=LOSS_TOL)
    assert int(out2[0][0]["num_correct"]) == int(out1[0][0]["num_correct"])
    np.testing.assert_array_equal(out2[0][1].numpy(), out1[0][1].numpy())
    _params_close(data2.numpy(), data1.numpy(), [out1[0][0]["lr"].item()])


def test_infinite_loss_skips_the_update(model):
    cfg, params = model
    bad = params.copy()
    bad["decoder"] = dict(params["decoder"])
    bad["decoder"]["output_linear"] = {
        "w": params["decoder"]["output_linear"]["w"].at[0, 0].set(jnp.inf)}
    jp, jopt, jout = _jax_step(cfg, bad, [_batch(0)])
    fp, data, opt, tout = _port_steps(cfg, bad, [_batch(0)])
    m = tout[0][0]
    assert not bool(m["finite"]) and not bool(jout[0][0]["finite"])
    assert m["loss"].item() == 0.0 and int(opt["step"]) == 0
    np.testing.assert_allclose(m["lr"].item(), float(jout[0][0]["lr"]),
                               rtol=1e-6)
    assert torch.equal(data, fp.data)   # unchanged, bit for bit
    assert not opt["mu"].any() and not opt["nu"].any()


# ---------------------------------------------------------------------------
# remat, the block-2 gate, SpecAugment and CTC in the step
# ---------------------------------------------------------------------------

def _port_loss_and_grad(cfg, params, batch, seed=11):
    """Loss and flat gradient of the port's training forward with the
    dropout streams of `seed`."""
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    tcfg = torch_config(cfg)
    fp = TS.FlatParams(to_port(params), torch.device("cpu"))
    leaf = fp.data.clone().requires_grad_()
    pcm, n_frames, targets, tgt_lengths = _port_batch(batch)
    rng = DropoutRng(seed, "cpu")
    spect = TS.features(tcfg, pcm, n_frames, T_FRAMES)
    pred, gold = TT.forward(fp.tree(leaf), spect, n_frames, targets,
                            TT.dims_from_config(tcfg), train=True, rng=rng)
    loss = TL.calculate_loss(pred, gold, None, tgt_lengths,
                             cfg.label_smoothing)
    grad, = torch.autograd.grad(loss, leaf)
    tail = (rng.kernel_seed().value(), rng.bits16((4,), "cpu").tolist())
    return loss.detach(), grad, tail


def test_remat_equals_no_remat_bit_for_bit_with_dropout(model):
    """--remat recomputes each layer in the backward with the dropout
    streams set back, so loss and gradients are the same bits and the
    streams end where they end without it."""
    cfg, params = model
    cfg = cfg.replace(dropout=0.1)
    l0, g0, tail0 = _port_loss_and_grad(cfg, params, _batch(3))
    l1, g1, tail1 = _port_loss_and_grad(cfg.replace(remat=True), params,
                                        _batch(3))
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    assert tail0 == tail1
    # and dropout is really on: another seed gives another loss
    l2, _, _ = _port_loss_and_grad(cfg, params, _batch(3), seed=12)
    assert not torch.equal(l0, l2)


def test_gate_on_step_equals_gate_off_step(model, monkeypatch):
    """One train step with the fused block 2 (its plain version here)
    against the composite block 2: same loss, same update."""
    from end2end_asr_tpu_torch.ops import vgg_fused as TV
    cfg, params = model
    _, data0, _, out0 = _port_steps(cfg, params, [_batch(4)])
    monkeypatch.setattr(TV, "BLOCK2_ENABLED", True)
    calls = []
    real = TV.vgg_block2_bwd
    monkeypatch.setattr(TV, "vgg_block2_bwd",
                        lambda *a: calls.append(1) or real(*a))
    _, data1, _, out1 = _port_steps(cfg, params, [_batch(4)])
    assert calls == [1]
    np.testing.assert_allclose(out1[0][0]["loss"].item(),
                               out0[0][0]["loss"].item(), rtol=LOSS_TOL)
    _params_close(data1.numpy(), data0.numpy(), [out0[0][0]["lr"].item()])


def test_spec_augment_step_uses_its_own_stream(model):
    """--spec-augment changes the loss, needs the step's streams, and
    leaves the dropout streams where they were."""
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    cfg, params = model
    tcfg = torch_config(cfg.replace(spec_augment=True, freq_mask_width=20,
                                    time_mask_width=20))
    fp = TS.FlatParams(to_port(params), torch.device("cpu"))
    step = TS.make_train_step_impl(tcfg, TT.dims_from_config(tcfg))
    opt = TO.init_opt_state(tcfg, fp.data)
    with pytest.raises(ValueError, match="random"):
        step(fp, fp.data, opt, None, *_port_batch(_batch(5)), T_FRAMES)
    rng = DropoutRng(3, "cpu")
    before = rng.dropout_state()
    _, _, _, m, _, _ = step(fp, fp.data, opt, rng, *_port_batch(_batch(5)),
                            T_FRAMES)
    after = rng.dropout_state()
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    _, _, _, out = _port_steps(cfg, params, [_batch(5)])
    assert bool(m["finite"])
    assert abs(m["loss"].item() - out[0][0]["loss"].item()) > 1e-4


def _ctc_batch(seed, tgt_lengths):
    pcm, n_frames, targets, _ = _batch(seed)
    rng = np.random.RandomState(seed)
    targets[:] = 0
    for i, L in enumerate(tgt_lengths):
        # distinct labels (no blank needed between them) while they last
        targets[i, :L] = (rng.permutation(np.arange(3, VOCAB))[:L]
                          if L <= VOCAB - 3 else rng.randint(3, VOCAB, L))
        targets[i, 0], targets[i, L - 1] = 1, 2
    return pcm, n_frames, targets, np.asarray(tgt_lengths, np.int32)


def test_ctc_step_matches_jax_and_an_infeasible_batch_is_skipped(model):
    cfg, params = model
    cfg = cfg.replace(loss="ctc")
    good = _ctc_batch(6, (5, 4, 3, 5))      # fits the 11 output positions
    bad = _ctc_batch(7, (5, 10, 3, 5))      # row 1: 10 labels on 9 frames
    jp, jopt, jout = _jax_step(cfg, params, [good, bad])
    fp, data, opt, tout = _port_steps(cfg, params, [good, bad])
    (m0, _, _), (m1, _, _) = tout
    assert bool(m0["finite"]) and bool(jout[0][0]["finite"])
    np.testing.assert_allclose(m0["loss"].item(), float(jout[0][0]["loss"]),
                               rtol=LOSS_TOL)
    # the second batch is infeasible on both sides: nothing moves
    assert not bool(m1["finite"]) and not bool(jout[1][0]["finite"])
    assert m1["loss"].item() == 0.0
    assert int(opt["step"]) == int(jopt["step"]) == 1
    want = flatten_tree(jp)
    _params_close(data.numpy(),
                  np.concatenate([want[k].ravel() for k in fp.train_keys]),
                  [m0["lr"].item()])


# ---------------------------------------------------------------------------
# checkpoints with optimizer state, and the entry point
# ---------------------------------------------------------------------------

def test_checkpoint_optimizer_state_round_trips_with_jax(model, tmp_path):
    cfg, params = model
    jp, jopt, _ = _jax_step(cfg, params, [_batch(1)])
    label2id = {"a": 3}
    id2label = {3: "a"}
    base = str(tmp_path / "jax")
    save_checkpoint(base, cfg, 2, jp, jopt, {}, label2id, id2label,
                    {"valid_loss": 1.5})
    (tcfg, epoch, tparams, topt, _, l2i, i2l,
     metrics) = TC.load_checkpoint(base)
    assert epoch == 2 and metrics == {"valid_loss": 1.5}
    want = flatten_tree({"params": jp, "opt": jopt})
    got = TC.flatten_params({"params": tparams, "opt": topt})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])

    # port → JAX, through the flat buffers the trainer keeps
    fp = TS.FlatParams(tparams, torch.device("cpu"))
    mu = fp.flatten(topt["mu"])
    opt_tree = {"step": topt["step"], "mu": fp.tree(mu, fixed="zeros"),
                "nu": fp.tree(fp.flatten(topt["nu"]), fixed="zeros")}
    base2 = str(tmp_path / "port")
    TC.save_checkpoint(base2, torch_config(cfg), 3, fp.tree(), label2id,
                       id2label, metrics={"valid_loss": 1.0},
                       opt_state=opt_tree)
    (_, epoch2, p2, o2, _, _, _, m2) = load_checkpoint(base2)
    assert epoch2 == 3 and m2 == {"valid_loss": 1.0}
    back = flatten_tree({"params": p2, "opt": o2})
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_train"))
    manifest, labels = make_corpus(root)
    return manifest, labels


def _train_argv(corpus, root, extra=()):
    manifest, labels = corpus
    return ["--train-manifest-list", manifest,
            "--valid-manifest-list", manifest, "--labels-path", labels,
            "--name", "t", "--save-folder", os.path.join(root, "models"),
            "--feat_extractor", "vgg_cnn", "--num-layers", "1",
            "--num-heads", "2", "--dim-model", "32", "--dim-key", "64",
            "--dim-value", "64", "--dim-inner", "32", "--dim-emb", "32",
            "--batch-size", "2", "--save-every", "1", "--dtype", "float32",
            "--src-max-len", "64", "--tgt-max-len", "8", *extra]


def test_train_entry_point_runs_an_epoch_and_resumes(corpus, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = _train_argv(corpus, str(tmp_path), ["--epochs", "1",
                                               "--device", "cpu"])
    res = port_train.main(argv)
    assert res["epochs_run"] == 1 and res["opt_step"] == 2
    assert np.isfinite(res["metrics"]["train_loss"])
    with open(os.path.join("log", "t")) as f:
        log = f.read()
    assert "TRAIN LOSS" in log and "VALID SET 0 LOSS" in log
    ck = os.path.join(str(tmp_path), "models", "t", "epoch_1")
    assert TC.find_latest_checkpoint(os.path.join(str(tmp_path), "models"),
                                     "t") == ck
    # --auto-resume continues the optimizer's step count
    argv = _train_argv(corpus, str(tmp_path), ["--epochs", "2",
                                               "--device", "cpu",
                                               "--auto-resume"])
    res = port_train.main(argv)
    assert res["epochs_run"] == 1 and res["opt_step"] == 4
    _, epoch, _, opt, _, _, _, _ = load_checkpoint(
        os.path.join(str(tmp_path), "models", "t", "epoch_2"))
    assert epoch == 2 and int(opt["step"]) == 4


def test_train_entry_point_needs_a_card_or_device_cpu(corpus, tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(_train_argv(corpus, str(tmp_path), ["--epochs", "1"]))
    # --noise-dir is ported: a missing directory raises IOError, as the JAX
    # package's NoiseInjector does
    # --seq-parallel needs --parallel --mesh-model (root train.py's
    # SystemExit); pipeline parallelism is ported: one process without
    # torchrun's group has one rank, too few for two stages
    # (make_mesh_pipe's words; tests/test_torch_pp.py runs the stages)
    for flag, exc, match in (
            (["--seq-parallel"], SystemExit, "requires --parallel"),
            (["--noise-dir", "x"], IOError, "Directory doesn't exist: x"),
            (["--parallel", "--mesh-pipe", "2", "--num-layers", "2"],
             ValueError, "--mesh-pipe 2 x --mesh-model 1 exceeds the 1 "
                         "visible devices")):
        with pytest.raises(exc, match=match):
            port_train.main(_train_argv(corpus, str(tmp_path),
                                        ["--device", "cpu", *flag]))
    # data parallelism and ZeRO are ported: without torchrun's environment
    # --parallel is one rank on the CPU (tests/test_torch_parallel.py runs
    # two)
    for flags in (["--parallel"], ["--parallel", "--zero1"]):
        res = port_train.main(_train_argv(
            corpus, str(tmp_path), ["--device", "cpu", "--epochs", "1",
                                    "--name", "p" + str(len(flags)),
                                    *flags]))
        assert res["epochs_run"] == 1 and res["opt_step"] == 2
        assert np.isfinite(res["metrics"]["train_loss"])
    # --checkpoint-format orbax: the port's sharded format, one process
    # here (tests/test_torch_dcp.py runs the layouts)
    res = port_train.main(_train_argv(
        corpus, str(tmp_path), ["--device", "cpu", "--epochs", "1",
                                "--name", "dcp", "--checkpoint-format",
                                "orbax"]))
    base = str(tmp_path / "models" / "dcp" / "epoch_1")
    assert os.path.isdir(base + ".dcp") and not os.path.exists(base + ".npz")
    _, epoch, params, opt, _, _, _, _ = TC.load_checkpoint(base)
    assert epoch == 1 and int(opt["step"]) == res["opt_step"]
    want = TC.flatten_params(res["params"])
    for k, v in TC.flatten_params(params).items():
        assert torch.equal(v, want[k]), k
