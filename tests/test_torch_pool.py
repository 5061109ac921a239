"""Port parity: the block-2 pool and its backward (kernel 6).

The port's `max_pool2` (plain pool forward, `pool_bwd_plain` backward on
the CPU) against `jax.grad` of the JAX package's `max_pool2` — the Pallas
backward in interpret mode where it applies (even T, C % 64 == 0), XLA's
select_and_scatter elsewhere — with ties inside windows and odd F and T.
Exact at f32: the backward only routes values. The JAX package works in
NHWC; the port's block 2 holds NCHW tensors whose memory is channels-last
in the train step (cuDNN's conv4), and the pool backward takes either,
handing dy back in y's memory format.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu.ops.pool_vjp import max_pool2 as jax_max_pool2
from end2end_asr_tpu_torch.ops import pool_vjp as PV


def _channels_last(t):
    """(B, F, T, C) in memory and not also NCHW-contiguous."""
    return (t.is_contiguous(memory_format=torch.channels_last)
            and not t.is_contiguous())


def _inputs(B, C, F, T, seed):
    r = np.random.RandomState(seed)
    y = r.randn(B, F, T, C).astype(np.float32)
    y[:, :, 1::3] = y[:, :, 0::3][:, :, :y[:, :, 1::3].shape[2]]  # ties
    y[:, 1::4] = y[:, 0::4][:, :y[:, 1::4].shape[1]]              # ties
    y[0, :2, :2, 0] = 0.5                                         # 4-way
    g = r.randn(B, F // 2, T // 2, C).astype(np.float32)
    return y, g


@pytest.mark.parametrize("B,C,F,T", [(2, 64, 8, 10), (1, 128, 7, 12),
                                     (2, 64, 9, 9), (1, 3, 5, 7)])
def test_pool_and_backward_match_jax(B, C, F, T):
    y, g = _inputs(B, C, F, T, seed=F * T)
    want, vjp = jax.vjp(jax_max_pool2, jnp.asarray(y))
    want_dy, = vjp(jnp.asarray(g))
    yt = torch.from_numpy(y).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = PV.max_pool2(yt)
    dy, = torch.autograd.grad(out, yt,
                              torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(dy.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_dy))
    # a 4-way tie goes to the first element of the window
    assert dy[0, 0, 0, 0] == g[0, 0, 0, 0] and not dy[0, 0, :2, :2].flatten(
    )[1:].any()
    if F % 2:
        assert not dy[:, :, F - 1].any()    # odd last row: no window
    if T % 2:
        assert not dy[..., T - 1].any()


def test_pool_bwd_refuses_other_devices():
    y = torch.zeros(1, 1, 2, 2, device="meta")
    with pytest.raises(ValueError):
        PV.pool_bwd(y, torch.zeros(1, 1, 1, 1, device="meta"))


@pytest.mark.parametrize("B,C,F,T", [(2, 64, 8, 10), (1, 128, 7, 12),
                                     (2, 64, 9, 9), (1, 8, 5, 7),
                                     (1, 3, 6, 5)])
def test_channels_last_backward_matches_jax_nhwc(B, C, F, T):
    """y in the JAX layout itself: the NHWC array seen as (B, C, F, T) is
    a channels-last tensor with no copy; dy comes back channels-last and
    read as NHWC equals JAX's gradient, odd F and T included."""
    y, g = _inputs(B, C, F, T, seed=7 * F + T)
    want, vjp = jax.vjp(jax_max_pool2, jnp.asarray(y))
    want_dy, = vjp(jnp.asarray(g))
    yt = torch.from_numpy(y).permute(0, 3, 1, 2).requires_grad_()
    assert _channels_last(yt) or C == 1
    out = PV.max_pool2(yt)
    dy, = torch.autograd.grad(out, yt, torch.from_numpy(g).permute(0, 3, 1, 2))
    assert dy.is_contiguous(memory_format=torch.channels_last)
    assert _channels_last(dy)
    np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(dy.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_dy))


def test_plain_backward_keeps_the_memory_format():
    y, g = (torch.from_numpy(a).permute(0, 3, 1, 2)
            for a in _inputs(1, 16, 6, 8, seed=3))
    assert _channels_last(PV.pool_bwd(y, g))
    assert PV.pool_bwd(y.contiguous(), g.contiguous()).is_contiguous()
    # a strided view of neither layout: dy comes back channels-last, as
    # the kernel's wrapper gives it
    ys = y.contiguous()[:, ::2]
    gs = g.contiguous()[:, ::2]
    assert not ys.is_contiguous() and not _channels_last(ys)
    dy = PV.pool_bwd(ys, gs)
    assert _channels_last(dy)
    assert torch.equal(dy, PV.pool_bwd(y.contiguous(),
                                       g.contiguous())[:, ::2])


def test_a_near_tie_is_routed_by_the_rounded_values():
    """Where the stage's f32 gradients leave JAX's: two elements of a
    window 2**-40 apart are one value at f32, so both packages route the
    gradient to the first element; in float64 it goes to the larger. The
    front end's f32 gradient therefore follows each package's roundings
    near a tie (tests/test_torch_train.py::frontend_against_f64)."""
    y = np.zeros((1, 2, 2, 64))
    y[0, 0, 0], y[0, 0, 1] = 1.0, 1.0 + 2.0 ** -40
    g = np.ones((1, 1, 1, 64), np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jax_max_pool2(v) * g))(jnp.asarray(y, jnp.float32)))
    for dt, first in ((torch.float32, True), (torch.float64, False)):
        t = torch.tensor(y, dtype=dt).permute(0, 3, 1, 2).requires_grad_()
        dy, = torch.autograd.grad(PV.max_pool2(t), t,
                                  torch.from_numpy(g).permute(0, 3, 1, 2))
        dy = dy.permute(0, 2, 3, 1).numpy()
        assert (dy[0, 0, 0] == 1).all() == first
        assert (dy[0, 0, 1] == 1).all() != first
        if dt == torch.float32:
            np.testing.assert_array_equal(dy, want)


@pytest.mark.parametrize("feat_extractor", ["vgg_cnn", "emb_cnn"])
def test_frontend_gradients_in_float64_equal_jax(feat_extractor):
    """The conv front ends' weight gradients in float64: the port's plain
    versions equal the JAX package's within 1e-6 of each leaf's largest
    (floored at 1e-3 of the largest of all): the same function, whose
    f32 gradients differ only by where the roundings flip near-ties."""
    from end2end_asr_tpu.models.transformer import init_transformer
    from port_parity import (jax_frontend_grads_f64,
                             port_frontend_grads_f64, small_config)
    params, state = init_transformer(
        jax.random.PRNGKey(1), small_config(feat_extractor=feat_extractor),
        12)
    r = np.random.RandomState(2)
    spect = r.randn(2, 161, 24)
    spect[1, :, 17:] = 0.0                   # padded frames, as batches have
    from end2end_asr_tpu.models.frontend import frontend_out_time
    T_out = frontend_out_time(feat_extractor, 24)
    width = 40 * 128 if feat_extractor == "vgg_cnn" else 672
    g = r.randn(2, T_out, width).astype(np.float32)
    st = state.get("frontend")
    want = jax_frontend_grads_f64(params["frontend"], st, spect, g,
                                  feat_extractor)
    got = port_frontend_grads_f64(params["frontend"], st, spect, g,
                                  feat_extractor)
    assert set(got) == set(want)
    floor = 1e-3 * max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        d = np.abs(got[k] - v).max() / max(np.abs(v).max(), floor)
        assert d < 1e-6, (k, d)
