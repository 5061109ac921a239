"""Port parity: the emb_cnn front end and its model state.

The port's emb_cnn (two strided convolutions, each with a batch norm and
a 0..20 clip; models/frontend.py) against the JAX package's on numpy
inputs from a seed and JAX-initialised weights: the output, the new
running statistics and every gradient in training mode, the output in
evaluation mode, the output time length, a checkpoint round trip both
ways with the ``state`` group, and one whole train step (loss, updated
parameters, new state) against the JAX step. f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu.models import frontend as JF
from end2end_asr_tpu.models import transformer as JT
from end2end_asr_tpu.training import optimizer as JO
from end2end_asr_tpu.training.checkpoint import (flatten_tree,
                                                 load_checkpoint,
                                                 save_checkpoint)
from end2end_asr_tpu.training.steps import make_train_step_impl
from end2end_asr_tpu_torch.models import frontend as TF
from end2end_asr_tpu_torch.models import transformer as TT
from end2end_asr_tpu_torch.training import checkpoint as TC
from end2end_asr_tpu_torch.training import loss as TL
from end2end_asr_tpu_torch.training import optimizer as TO
from end2end_asr_tpu_torch.training import steps as TS

from port_parity import small_config, to_port, torch_config

TOL = 1e-5        # f32 sums of 451 and 7392 products in another order
VOCAB, B, T_FRAMES = 12, 4, 48


@pytest.fixture(scope="module")
def model():
    cfg = small_config(feat_extractor="emb_cnn", dropout=0.0,
                       label_smoothing=0.1, batch_size=B,
                       src_max_len=T_FRAMES, tgt_max_len=16, warmup=10)
    params, state = JT.init_transformer(jax.random.PRNGKey(0), cfg, VOCAB)
    # running statistics away from their initial (0, 1)
    rng = np.random.RandomState(4)
    for bn in ("bn1", "bn2"):
        state["frontend"][bn] = {
            "mean": jnp.asarray(rng.randn(32).astype(np.float32) * 0.1),
            "var": jnp.asarray(rng.rand(32).astype(np.float32) + 0.5)}
    return cfg, params, state


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def test_init_matches_the_jax_structure(model):
    cfg, params, state = model
    tcfg = torch_config(cfg)
    assert tcfg.conv_dim_input() == 672
    got = TT.init_params(tcfg, VOCAB, torch.Generator().manual_seed(0))
    want = flatten_tree(params)
    assert {k: tuple(v.shape) for k, v in TC.flatten_params(got).items()} \
        == {k: tuple(v.shape) for k, v in want.items()}
    st = TC.flatten_params(TT.init_state(tcfg))
    assert set(st) == set(flatten_tree(state))
    assert all(float(v.sum()) == (32.0 if k.endswith("var") else 0.0)
               for k, v in st.items())
    assert TT.init_state(torch_config(small_config())) == {}


@pytest.mark.parametrize("train", [True, False])
def test_frontend_output_state_and_gradients_match_jax(model, train):
    cfg, params, state = model
    spect = np.random.RandomState(1).randn(3, 161, T_FRAMES).astype(
        np.float32)
    fe, st = params["frontend"], state["frontend"]

    def jrun(p):
        out, new = JF.apply_frontend(p, st, jnp.asarray(spect), "emb_cnn",
                                     train=train, dtype=jnp.float32)
        return out, new
    (want, want_state), vjp = jax.vjp(jrun, fe)[0], jax.vjp(jrun, fe)[1]
    tp, ts = to_port(fe), to_port(st)
    leaves = TC.flatten_params(tp)
    for t in leaves.values():
        t.requires_grad_()
    got, new = TF.apply_frontend(tp, ts, torch.from_numpy(spect), "emb_cnn",
                                 train=train, dtype=torch.float32)
    assert got.shape == (3, TF.frontend_out_time("emb_cnn", T_FRAMES), 672)
    assert got.shape[1] == JF.frontend_out_time("emb_cnn", T_FRAMES)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    for k, v in TC.flatten_params(new).items():
        np.testing.assert_allclose(v.numpy(), flatten_tree(want_state)[k],
                                   rtol=TOL, atol=TOL)
        assert not v.requires_grad
    g = np.random.RandomState(2).randn(*got.shape).astype(np.float32)
    zero_state = jax.tree_util.tree_map(jnp.zeros_like, want_state)
    want_g, = vjp((jnp.asarray(g), zero_state))
    got_g = torch.autograd.grad(got, list(leaves.values()),
                                torch.from_numpy(g))
    # relative to each leaf's largest gradient. In training a bias that
    # feeds a batch norm has an exactly zero gradient (the mean is
    # subtracted): both sides hold only the cancellation noise of a sum
    # over B*F*T positions, a small share of the largest gradient
    want_flat = flatten_tree(want_g)
    gmax = max(np.abs(v).max() for v in want_flat.values())
    for (k, _), a in zip(leaves.items(), got_g):
        if train and k in ("conv1::b", "conv2::b"):
            assert np.abs(a.numpy()).max() < 1e-2 * gmax, k
            assert np.abs(want_flat[k]).max() < 1e-2 * gmax, k
            continue
        assert _rel(a.numpy(), want_flat[k]) < 10 * TOL, k
    if not train:
        assert new is ts or all(
            torch.equal(a, b) for a, b in zip(
                TC.flatten_params(new).values(),
                TC.flatten_params(ts).values()))


def test_encoder_lengths_follow_the_conv_arithmetic(model):
    cfg, _, _ = model
    lens = np.array([48, 33, 20, 11], np.int32)
    for compat in (True, False):
        c = cfg.replace(ref_compat_masks=compat)
        want = JT.encoder_lengths(JT.dims_from_config(c), jnp.asarray(lens))
        got = TT.encoder_lengths(TT.dims_from_config(torch_config(c)),
                                 torch.from_numpy(lens))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_checkpoint_state_round_trips_with_jax(model, tmp_path):
    cfg, params, state = model
    l2i, i2l = {"a": 3}, {3: "a"}
    base = str(tmp_path / "jax")
    save_checkpoint(base, cfg, 1, params, None, state, l2i, i2l, {})
    _, _, tparams, _, tstate, _, _, _ = TC.load_checkpoint(base)
    want = flatten_tree(state)
    got = TC.flatten_params(tstate)
    assert set(got) == set(want) and len(want) == 4
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    base2 = str(tmp_path / "port")
    TC.save_checkpoint(base2, torch_config(cfg), 2, tparams, l2i, i2l,
                       model_state=tstate)
    _, epoch, p2, _, s2, _, _, _ = load_checkpoint(base2)
    assert epoch == 2
    for k, v in flatten_tree(s2).items():
        np.testing.assert_array_equal(v, want[k])
    for k, v in flatten_tree(p2).items():
        np.testing.assert_array_equal(v, flatten_tree(params)[k])


def _batch(seed=0, tgt_lengths=(7, 10, 4, 6)):
    rng = np.random.RandomState(seed)
    n = (T_FRAMES - 1) * 160 + 320
    pcm = (rng.randn(B, n) * 0.2).astype(np.float32)
    n_frames = np.array([T_FRAMES, 40, 33, T_FRAMES - 2], np.int32)
    targets = np.zeros((B, 10), np.int32)
    tgt_lengths = np.array(tgt_lengths, np.int32)
    for i, L in enumerate(tgt_lengths):
        targets[i, :L] = rng.randint(3, VOCAB, size=L)
        targets[i, 0], targets[i, L - 1] = 1, 2
    return pcm, n_frames, targets, tgt_lengths


@pytest.mark.parametrize("seed", range(5))
def test_forward_loss_and_all_gradients_match_jax(model, seed):
    """tests/test_torch_train.py's test of the same name on emb_cnn: the
    loss, every gradient outside the front end within GRAD_TOL of JAX's,
    and the front end's against float64 (`frontend_against_f64`). The
    biases of the two convolutions feed a batch norm, so their exact
    gradient is zero and each side holds its cancellation noise: up to
    7.8e-3 of the floor on JAX's side at f32 and ~2e-4 on the port's."""
    from test_torch_train import (GRAD_TOL, _jax_value_and_grad, _rel,
                                  _jax_batch_loss, frontend_against_f64)
    cfg, params, state = model
    batch = _batch(seed)
    want_loss, want_g = _jax_value_and_grad(cfg)(params, batch, state)
    fp = TS.FlatParams(to_port(params), torch.device("cpu"))
    leaf = fp.data.clone().requires_grad_()
    tcfg = torch_config(cfg)
    pcm, n_frames, targets, tgt_lengths = (
        torch.from_numpy(a.astype(np.int64) if a.dtype != np.float32 else a)
        for a in batch)
    spect = TS.features(tcfg, pcm, n_frames, T_FRAMES)
    pred, gold, _ = TT.forward_state(fp.tree(leaf), to_port(state), spect,
                                     n_frames, targets,
                                     TT.dims_from_config(tcfg), train=True)
    loss = TL.calculate_loss(pred, gold, None, tgt_lengths,
                             cfg.label_smoothing)
    grad, = torch.autograd.grad(loss, leaf)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    got = {k: v.numpy() for k, v in fp.views(grad).items()}
    want = flatten_tree(want_g)
    floor = 1e-3 * max(np.abs(v).max() for v in want.values())
    for k, g in got.items():
        if not k.startswith("frontend::"):
            assert _rel(g, want[k], floor) < GRAD_TOL, k
    frontend_against_f64(cfg, params, state, batch, _jax_batch_loss(cfg),
                         got, want, floor)


@pytest.mark.parametrize("loss", ["ce", "ctc"])
def test_one_train_step_matches_the_jax_step(model, loss):
    """Loss, updated parameters and new state after one step; then the
    evaluation forward with that state."""
    cfg, params, state = model
    cfg = cfg.replace(loss=loss)
    # CTC sees U_out = 11 output positions: targets short enough for them
    batch = _batch() if loss == "ce" else _batch(tgt_lengths=(4, 5, 3, 4))
    dims = JT.dims_from_config(cfg)
    jstep = jax.jit(make_train_step_impl(cfg, dims, from_pcm=True),
                    static_argnames=("spect_T",))
    jp, jopt, jstate, jm, jhyp, _ = jstep(
        params, JO.init_opt_state(cfg, params), state, jax.random.PRNGKey(0),
        *(jnp.asarray(a) for a in batch), spect_T=T_FRAMES)

    tcfg = torch_config(cfg)
    tdims = TT.dims_from_config(tcfg)
    fp = TS.FlatParams(to_port(params), torch.device("cpu"))
    tstate = to_port(state)
    step = TS.make_train_step_impl(tcfg, tdims)
    tb = [torch.from_numpy(a.astype(np.int64) if a.dtype != np.float32 else a)
          for a in batch]
    data, opt, new_state, m, hyp, _ = step(
        fp, fp.data, TO.init_opt_state(tcfg, fp.data), None, *tb, T_FRAMES,
        model_state=tstate)
    assert bool(m["finite"]) and bool(jm["finite"])
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=TOL)
    want_state = flatten_tree(jstate)
    for k, v in TC.flatten_params(new_state).items():
        np.testing.assert_allclose(v.numpy(), want_state[k], rtol=TOL,
                                   atol=TOL)
    # Adam's first step moves each parameter by ~lr * sign(grad)
    lr = m["lr"].item()
    want = flatten_tree(jp)
    got = TC.flatten_params(fp.tree(data))
    close = total = 0
    for k, v in got.items():
        d = np.abs(v.numpy().astype(np.float64) - want[k])
        assert d.max() <= 2 * lr + 1e-7, k
        close += (d <= 1e-5).sum()
        total += d.size
    assert close / total >= 0.999
    if loss == "ce":
        np.testing.assert_array_equal(hyp.numpy(), np.asarray(jhyp))


def test_trainer_carries_the_state_into_checkpoints(tmp_path, monkeypatch):
    """The train entry point with emb_cnn + spec-augment + remat on the
    CPU: the checkpoint holds a state that has moved, --auto-resume
    continues from it, and the test entry point serves it."""
    import os
    from synth import make_corpus
    from end2end_asr_tpu_torch import test as port_test
    from end2end_asr_tpu_torch import train as port_train
    monkeypatch.chdir(tmp_path)
    manifest, labels = make_corpus(str(tmp_path))
    argv = ["--train-manifest-list", manifest, "--valid-manifest-list",
            manifest, "--labels-path", labels, "--name", "e",
            "--save-folder", "models", "--feat_extractor", "emb_cnn",
            "--spec-augment", "--remat", "--num-layers",
            "1", "--num-heads", "2", "--dim-model", "32", "--dim-key", "16",
            "--dim-value", "16", "--dim-inner", "32", "--dim-emb", "32",
            "--batch-size", "2", "--save-every", "1", "--dtype", "float32",
            "--src-max-len", "64", "--tgt-max-len", "8", "--dropout", "0.1",
            "--device", "cpu"]
    res = port_train.main(argv + ["--epochs", "1"])
    assert res["opt_step"] == 2 and np.isfinite(res["metrics"]["train_loss"])
    ck = os.path.join("models", "e", "epoch_1")
    _, _, _, _, st, _, _, _ = TC.load_checkpoint(ck)
    flat = TC.flatten_params(st)
    assert set(flat) == {"frontend::bn1::mean", "frontend::bn1::var",
                         "frontend::bn2::mean", "frontend::bn2::var"}
    assert float(flat["frontend::bn1::mean"].abs().sum()) > 0
    for k, v in TC.flatten_params(res["model_state"]).items():
        np.testing.assert_array_equal(v.numpy(), flat[k].numpy())
    res2 = port_train.main(argv + ["--epochs", "2", "--auto-resume"])
    assert res2["opt_step"] == 4 and res2["epochs_run"] == 1
    s2 = TC.flatten_params(res2["model_state"])
    assert not torch.equal(s2["frontend::bn1::mean"],
                           flat["frontend::bn1::mean"])
    out = port_test.main(["--continue-from", ck, "--test-manifest-list",
                          manifest, "--batch-size", "2", "--device", "cpu"])
    assert np.isfinite(out["cer"])
