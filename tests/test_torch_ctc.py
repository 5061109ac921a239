"""Port parity: the CTC loss (end2end_asr_tpu_torch.ops.ctc) and its
dispatch (training/loss.py) against the JAX package's ops/ctc.py on numpy
inputs from a seed: loss and gradient, a repeated label (needs the blank
between its copies), an empty target, an input of one frame, PAD content
beyond the target length, and an infeasible row (+inf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu.ops.ctc import ctc_loss as jax_ctc
from end2end_asr_tpu.training import loss as JL
from end2end_asr_tpu_torch.ops.ctc import ctc_loss
from end2end_asr_tpu_torch.training import loss as TL
from end2end_asr_tpu_torch.training.steps import ctc_input_lengths

TOL = 1e-5   # f32 log-sum-exp recursions over T frames in another order

CASES = {
    # name: (targets, target_lengths, input_lengths)
    "plain": ([[3, 4, 5, 0], [6, 2, 0, 0], [1, 2, 3, 4]], [3, 2, 4],
              [12, 9, 12]),
    "repeated_label": ([[3, 3, 4, 4], [5, 5, 5, 0], [2, 3, 3, 2]],
                       [4, 3, 4], [12, 7, 10]),
    "empty_target": ([[0, 0, 0, 0], [4, 0, 0, 0], [0, 0, 0, 0]], [0, 1, 0],
                     [12, 5, 1]),
    "input_length_1": ([[7, 0, 0, 0], [0, 0, 0, 0], [3, 0, 0, 0]],
                       [1, 0, 1], [1, 1, 1]),
    "pad_content_ignored": ([[3, 4, 9, 9], [6, 8, 8, 8], [1, 2, 3, 7]],
                            [2, 1, 3], [12, 12, 6]),
}


def _log_probs(seed, B=3, T=12, C=10):
    rng = np.random.RandomState(seed)
    return rng.randn(B, T, C).astype(np.float32) * 2


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_loss_and_gradient_match_jax(name, reduction):
    tg, tl, il = (np.asarray(a, np.int32) for a in CASES[name])
    logits = _log_probs(len(name))

    def jloss(x):
        out = jax_ctc(jax.nn.log_softmax(x, axis=-1), jnp.asarray(tg),
                      jnp.asarray(il), jnp.asarray(tl), reduction=reduction)
        return jnp.sum(out), out
    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(torch.log_softmax(x, dim=-1), torch.from_numpy(tg),
                   torch.from_numpy(il), torch.from_numpy(tl),
                   reduction=reduction)
    got_g, = torch.autograd.grad(got.sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    scale = max(np.abs(np.asarray(want_g)).max(), 1e-6)
    assert np.abs(got_g.numpy() - np.asarray(want_g)).max() / scale < TOL


def test_repeated_label_needs_the_blank_between():
    """Target (3, 3) on 2 frames has no path: blank must sit between."""
    lp = torch.log_softmax(torch.from_numpy(_log_probs(0, 1, 3, 5)), dim=-1)
    tg, tl = torch.tensor([[3, 3]]), torch.tensor([2])
    assert torch.isinf(ctc_loss(lp, tg, torch.tensor([2]), tl))
    assert torch.isfinite(ctc_loss(lp, tg, torch.tensor([3]), tl))


@pytest.mark.parametrize("il", [[12, 1, 12], [12, 0, 12]])
def test_infeasible_row_gives_inf_as_in_jax(il):
    tg, tl, _ = (np.asarray(a, np.int32) for a in CASES["plain"])
    il = np.asarray(il, np.int32)
    logits = _log_probs(5)
    want = jax_ctc(jax.nn.log_softmax(jnp.asarray(logits), axis=-1),
                   jnp.asarray(tg), jnp.asarray(il), jnp.asarray(tl),
                   reduction="none")
    got = ctc_loss(torch.log_softmax(torch.from_numpy(logits), dim=-1),
                   torch.from_numpy(tg), torch.from_numpy(il),
                   torch.from_numpy(tl), reduction="none")
    assert np.isposinf(np.asarray(want)[1]) and torch.isposinf(got[1])
    np.testing.assert_allclose(got.numpy()[[0, 2]], np.asarray(want)[[0, 2]],
                               rtol=TOL)
    mean = ctc_loss(torch.log_softmax(torch.from_numpy(logits), dim=-1),
                    torch.from_numpy(tg), torch.from_numpy(il),
                    torch.from_numpy(tl))
    assert torch.isposinf(mean)


def test_calculate_loss_dispatch_and_input_lengths():
    """loss.py:56-79 (f32 log-softmax, no token accuracy for ctc) and the
    step's input lengths n_frames / spect_T * U_out, truncated."""
    rng = np.random.RandomState(3)
    pred = rng.randn(3, 9, 10).astype(np.float32)
    gold = np.asarray([[3, 4, 5, 2, 0], [6, 2, 0, 0, 0], [1, 2, 3, 4, 2]],
                      np.int32)
    tl = np.asarray([4, 2, 5], np.int32)
    n_frames, spect_T = np.asarray([48, 33, 40], np.int32), 48
    want_il = (jnp.asarray(n_frames).astype(jnp.float32) / spect_T
               * 9).astype(jnp.int32)
    il = ctc_input_lengths(torch.from_numpy(n_frames), spect_T, 9)
    np.testing.assert_array_equal(il.numpy(), np.asarray(want_il))
    want, want_acc = JL.calculate_metrics(
        jnp.asarray(pred), jnp.asarray(gold), want_il, jnp.asarray(tl), 0.1,
        "ctc")
    got, acc = TL.calculate_metrics(
        torch.from_numpy(pred), torch.from_numpy(gold), il,
        torch.from_numpy(tl), 0.1, "ctc")
    assert acc is None and want_acc is None
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    _, acc_ce = TL.calculate_metrics(torch.from_numpy(pred[:, :5]),
                                     torch.from_numpy(gold), loss_type="ce")
    assert int(acc_ce) == int(JL.token_accuracy(jnp.asarray(pred[:, :5]),
                                                jnp.asarray(gold)))
