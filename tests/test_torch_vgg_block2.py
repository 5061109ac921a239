"""Port parity: vgg block 2 (conv3+relu+conv4+pool+bias+relu) and its
backward.

The port's plain block-2 forward and backward (the CPU side of the fused
kernels' wrappers, end2end_asr_tpu_torch.ops.vgg_fused) against the JAX
package's fused Pallas kernels in interpret mode, on inputs made from a
numpy seed: the output, the pool argmax and all five gradients; a tie
case and a border-bias case; and the port's front end with the block-2
gate on against the gate off. The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py.

Layouts: the JAX kernels take (B, F, 64, T) and give (B, F/2, 128, T/2);
the port takes block 1's (B, F, T, 64) and gives (B, F/2, T/2, 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu.ops.vgg_fused import _block2_fwd, vgg_block2
from end2end_asr_tpu_torch.models import frontend as TF
from end2end_asr_tpu_torch.ops import vgg_fused as TV

# f32: 576- and 1152-term f32 sums in another order (~1e-6 relative);
# gradients relative to each tensor's largest value
F32_TOL = 1e-5
# bf16 forward: a conv output on the other side of a bf16 rounding boundary
# is one bf16 ulp off (2^-8 relative) and may flip a near-tied pool choice
BF16_TOL = 0.05
# bf16 backward, on the SAME out / idx: the JAX kernel adds ~12 partial dx2
# and dx sums per row in bf16, one rounding each (its documented defect,
# vgg_fused.py:574-579); the port sums in f32 and rounds once
BF16_BWD_TOL = 0.05

SHAPES = [(2, 8, 16), (1, 12, 16), (1, 16, 32)]


def _mk(B, F, T, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(B, F, T, 64) * 0.5).astype(np.float32),
            (rng.randn(3, 3, 64, 128) * 0.05).astype(np.float32),
            (rng.randn(128) * 0.1).astype(np.float32),
            (rng.randn(3, 3, 128, 128) * 0.04).astype(np.float32),
            (rng.randn(128) * 0.1).astype(np.float32))


def _t(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def _jax_fwd(args, cdt):
    x, w3, b3, w4, b4 = (jnp.asarray(a) for a in args)
    out_t, idx = _block2_fwd(jnp.transpose(x, (0, 1, 3, 2)), w3, b3, w4, b4,
                             cdt)
    nhwc = lambda a: np.asarray(jnp.transpose(a, (0, 1, 3, 2)).astype(
        jnp.float32) if a.dtype != jnp.uint8 else jnp.transpose(
            a, (0, 1, 3, 2)))
    return nhwc(out_t), nhwc(idx)


def _port_fwd(args, cdt):
    x, *w = _t(args)
    B, F, T, _ = x.shape
    idx = torch.empty((B, F // 2, T // 2, 128), dtype=torch.uint8)
    out = TV.vgg_block2(x.to(cdt), *w, cdt=cdt, idx_out=idx)
    assert out.dtype == cdt and out.shape == idx.shape
    return out.float().numpy(), idx.numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_block2_forward_and_argmax_match_jax_f32(shape):
    args = _mk(*shape)
    want, want_idx = _jax_fwd(args, jnp.float32)
    got, idx = _port_fwd(args, torch.float32)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    # the argmax may differ only where two candidates tie within the noise
    assert (idx != want_idx).mean() < 1e-3


def test_block2_forward_matches_jax_bf16():
    args = _mk(2, 8, 16, seed=3)
    want, want_idx = _jax_fwd(args, jnp.bfloat16)
    got, idx = _port_fwd(args, torch.bfloat16)
    assert np.abs(got - want).max() < BF16_TOL
    assert (idx == want_idx).mean() > 0.97


def _jax_grads(args, g, cdt):
    x, w3, b3, w4, b4 = (jnp.asarray(a) for a in args)
    x_t = jnp.transpose(x, (0, 1, 3, 2)).astype(cdt)
    out, vjp = jax.vjp(lambda *a: vgg_block2(*a, cdt), x_t, w3, b3, w4, b4)
    dx_t, *dw = vjp(jnp.transpose(jnp.asarray(g), (0, 1, 3, 2)).astype(
        out.dtype))
    return [np.asarray(jnp.transpose(dx_t, (0, 1, 3, 2)).astype(
        jnp.float32))] + [np.asarray(d, np.float32) for d in dw]


def _port_grads(args, g, cdt):
    x, *w = _t(args)
    leaves = [x.to(cdt).requires_grad_()] + [t.requires_grad_() for t in w]
    out = TV.VggBlock2.apply(*leaves, cdt)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(cdt))
    return [t.float().numpy() for t in grads]


@pytest.mark.parametrize("shape", SHAPES)
def test_block2_all_five_gradients_match_jax_f32(shape):
    args = _mk(*shape, seed=1)
    B, F, T = shape
    g = np.random.RandomState(9).randn(B, F // 2, T // 2, 128).astype(
        np.float32)
    want = _jax_grads(args, g, jnp.float32)
    got = _port_grads(args, g, torch.float32)
    for name, a, b in zip(("dx", "dw3", "db3", "dw4", "db4"), got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) < F32_TOL, name


def test_block2_gradients_match_jax_bf16_loosely():
    args = _mk(1, 8, 16, seed=2)
    g = np.random.RandomState(5).randn(1, 4, 8, 128).astype(np.float32)
    want = _jax_grads(args, g, jnp.bfloat16)
    got = _port_grads(args, g, torch.bfloat16)
    for name, a, b in zip(("dx", "dw3", "db3", "dw4", "db4"), got, want):
        assert _rel(a, b) < BF16_BWD_TOL, name


def test_block2_backward_plain_equals_autograd_of_the_composite():
    """The hand-written plain backward against autograd through library
    convolutions and max_pool2d (the gate-off path's own block 2)."""
    import torch.nn.functional as Fn
    args = _mk(2, 8, 12, seed=4)
    g = np.random.RandomState(6).randn(2, 4, 6, 128).astype(np.float32)
    got = _port_grads(args, g, torch.float32)
    x, w3, b3, w4, b4 = [t.requires_grad_() for t in _t(args)]
    y = torch.relu(Fn.conv2d(x.permute(0, 3, 1, 2), w3.permute(3, 2, 0, 1),
                             b3, padding=1))
    y = torch.relu(Fn.max_pool2d(Fn.conv2d(y, w4.permute(3, 2, 0, 1),
                                           padding=1), 2)
                   + b4[None, :, None, None]).permute(0, 2, 3, 1)
    want = torch.autograd.grad(y, (x, w3, b3, w4, b4), torch.from_numpy(g))
    for name, a, b in zip(("dx", "dw3", "db3", "dw4", "db4"), got, want):
        assert _rel(a, b.numpy()) < F32_TOL, name


def test_block2_ties_go_to_the_first_window_element():
    """All-zero weights: every conv4 value of a window is equal, so the
    first element in (f, t) order wins, as in the JAX kernel."""
    x, w3, b3, w4, b4 = _mk(1, 8, 16, seed=7)
    args = (x, w3 * 0, b3, w4 * 0, b4)
    want, want_idx = _jax_fwd(args, jnp.float32)
    got, idx = _port_fwd(args, torch.float32)
    assert not idx.any() and not want_idx.any()
    np.testing.assert_allclose(got, want, atol=1e-7)
    # and an exact two-way tie that is not at element 0
    y = torch.tensor([[[[1.0, 3.0], [3.0, 2.0]]]])
    _, i = TV.pool2_first_wins(y)
    assert int(i) == 1


def test_block2_bias_does_not_leak_into_the_border():
    """Zero input and a large b3: x2 = relu(b3) inside the image and ZERO
    in conv4's SAME padding. With negative conv4 weights the pool picks
    the window element with the fewest taps inside the image, so border
    outputs differ from interior ones; a kernel that pads with
    relu(0 + b3) would make them equal."""
    x, w3, b3, w4, b4 = _mk(1, 8, 16, seed=8)
    args = (x * 0, w3, np.abs(b3) + 1.0, -np.abs(w4), b4 * 0 + 100.0)
    want, _ = _jax_fwd(args, jnp.float32)
    got, _ = _port_fwd(args, torch.float32)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    assert np.abs(got[0, 0, 0] - got[0, 1, 3]).max() > 0.1


def test_supported2():
    assert TV.supported2(80, 400) and TV.supported2(82, 398)
    assert TV.supported2(4, 2)
    assert not TV.supported2(81, 400) and not TV.supported2(80, 399)
    assert not TV.supported2(2, 16)
    assert TV.BLOCK2_ENABLED is False


def _frontend_params(seed):
    rng = np.random.RandomState(seed)
    conv = lambda ci, co: {
        "w": torch.from_numpy((rng.randn(3, 3, ci, co)
                               * (2.0 / (9 * ci)) ** 0.5).astype(np.float32)),
        "b": torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32))}
    return {"conv1": conv(1, 64), "conv2": conv(64, 64),
            "conv3": conv(64, 128), "conv4": conv(128, 128)}


@pytest.mark.parametrize("F,T,fused", [(16, 24, True), (18, 24, False)])
def test_frontend_gate_on_equals_gate_off_f32(monkeypatch, F, T, fused):
    """The front end's output and every gradient with BLOCK2_ENABLED set
    equal the composite branch's; a block-2 input with odd F (18 / 2 = 9)
    takes the composite branch whatever the gate says."""
    spect = torch.from_numpy(np.random.RandomState(1).randn(2, F, T).astype(
        np.float32))
    calls = []
    real = TV.VggBlock2.apply
    monkeypatch.setattr(TF, "VggBlock2", type("Spy", (), {
        "apply": staticmethod(lambda *a: calls.append(1) or real(*a))}))
    res = []
    for gate in (False, True):
        monkeypatch.setattr(TV, "BLOCK2_ENABLED", gate)
        p = _frontend_params(2)
        leaves = [t.requires_grad_() for c in p.values() for t in c.values()]
        out, state = TF.apply_frontend(p, None, spect, "vgg_cnn", train=True,
                                       dtype=torch.float32)
        assert state is None and out.shape == (2, T // 4, (F // 4) * 128)
        g = torch.from_numpy(np.random.RandomState(3).randn(
            *out.shape).astype(np.float32))
        res.append((out.detach(), torch.autograd.grad(out, leaves, g)))
        inf, _ = TF.apply_frontend(p, None, spect, "vgg_cnn", train=False,
                                   dtype=torch.float32)
        np.testing.assert_allclose(inf.detach().numpy(), out.detach().numpy(),
                                   atol=1e-6)
    assert len(calls) == (1 if fused else 0)
    (o0, g0), (o1, g1) = res
    np.testing.assert_allclose(o1.numpy(), o0.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    for a, b in zip(g1, g0):
        assert _rel(a.numpy(), b.numpy()) < F32_TOL
