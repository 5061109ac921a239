"""Port parity: vgg block 1 (conv1+relu+conv2+pool+bias+relu).

The port's plain block-1 forward (the CPU side of the fused kernel's
wrapper, end2end_asr_tpu_torch.ops.vgg_fused) against the JAX package's
fused Pallas kernel in interpret mode and its composite XLA path, on
inputs made from a numpy seed. Output and the pool argmax are compared.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from end2end_asr_tpu.ops.pool_vjp import max_pool2
from end2end_asr_tpu.ops.vgg_fused import _block1_fwd, vgg_block1
from end2end_asr_tpu_torch.ops import vgg_fused as TV

# f32: 9- and 576-term f32 sums in another order (~1e-6 relative)
F32_TOL = 1e-5
# bf16: a conv output that lands on the other side of a bf16 rounding
# boundary differs by one bf16 ulp (2^-8 relative) and can flip a
# near-tied pool choice; values are O(1)
BF16_TOL = 0.05


def composite(spect, w1, b1, w2, b2, cdt):
    """The JAX package's unfused block 1 (models/frontend.py:313-316)."""
    x = spect[..., None].astype(cdt)
    y = jax.lax.conv_general_dilated(
        x, w1.astype(cdt), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    x1 = jax.nn.relu(y + b1.astype(y.dtype))
    y2 = jax.lax.conv_general_dilated(
        x1, w2.astype(cdt), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    p = max_pool2(y2)
    return jax.nn.relu(p + b2.astype(p.dtype))


def _mk(B, F, T, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, F, T).astype(np.float32),
            (rng.randn(3, 3, 1, 64) * 0.2).astype(np.float32),
            (rng.randn(64) * 0.1).astype(np.float32),
            (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32),
            (rng.randn(64) * 0.1).astype(np.float32))


def _port(args, cdt):
    t = [torch.from_numpy(a) for a in args]
    B, F, T = args[0].shape
    idx = torch.empty((B, F // 2, T // 2, 64), dtype=torch.uint8)
    out = TV.vgg_block1(*t, cdt=cdt, idx_out=idx)
    return out.to(torch.float32).numpy(), idx.numpy()


def _jax_fused(args, cdt):
    out, (_, idx) = _block1_fwd(*[jnp.asarray(a) for a in args], cdt)
    return (np.asarray(out.astype(jnp.float32)),
            np.transpose(np.asarray(idx), (0, 1, 3, 2)))


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 17, 16)])
def test_f32_matches_jax_fused_and_composite(shape):
    args = _mk(*shape, seed=1)
    out, idx = _port(args, torch.float32)
    f_out, f_idx = _jax_fused(args, jnp.float32)
    v_out = np.asarray(vgg_block1(*[jnp.asarray(a) for a in args],
                                  jnp.float32))
    c_out = np.asarray(composite(*[jnp.asarray(a) for a in args],
                                 jnp.float32))
    assert out.shape == f_out.shape == (shape[0], shape[1] // 2,
                                        shape[2] // 2, 64)
    np.testing.assert_allclose(out, f_out, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(out, v_out, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(out, c_out, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(idx, f_idx)


@pytest.mark.parametrize("shape", [(1, 16, 17), (2, 17, 9)])
def test_odd_time_crops_like_valid_pool(shape):
    """Odd T (and odd F) drop the last column (row) as the VALID pool of
    the composite does; the JAX fused kernel takes even T only."""
    args = _mk(*shape, seed=2)
    out, _ = _port(args, torch.float32)
    c_out = np.asarray(composite(*[jnp.asarray(a) for a in args],
                                 jnp.float32))
    assert out.shape == c_out.shape
    np.testing.assert_allclose(out, c_out, rtol=F32_TOL, atol=F32_TOL)


def test_bf16_matches_jax_loosely():
    args = _mk(2, 16, 16, seed=3)
    out, idx = _port(args, torch.bfloat16)
    f_out, f_idx = _jax_fused(args, jnp.bfloat16)
    c_out = np.asarray(composite(*[jnp.asarray(a) for a in args],
                                 jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(out, c_out, rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(out, f_out, rtol=BF16_TOL, atol=BF16_TOL)
    assert (idx == f_idx).mean() > 0.97  # near-ties may flip in bf16


def _identity_pool_args(cell):
    """Weights under which channel 0 of conv2's output is the input
    itself (conv1 and conv2 pass the centre tap of channel 0 through):
    the pool then runs on `cell`, the first (2, 2) window, directly (the
    JAX kernel needs F >= 8, so the rest of the 8 x 8 input is zero)."""
    spect = np.zeros((1, 8, 8), np.float32)
    spect[0, :2, :2] = cell
    w1 = np.zeros((3, 3, 1, 64), np.float32)
    w1[1, 1, 0, 0] = 1.0
    w2 = np.zeros((3, 3, 64, 64), np.float32)
    w2[1, 1, 0, 0] = 1.0
    zeros = np.zeros(64, np.float32)
    return spect, w1, zeros, w2, zeros


@pytest.mark.parametrize("cdt,jdt,want", [
    (torch.float32, jnp.float32, 1),
    # 1 + 2^-10 rounds to 1.0 in bf16 BEFORE the pool: a tie, and the
    # earlier window element wins
    (torch.bfloat16, jnp.bfloat16, 0)])
def test_pool_tie_break_and_rounding_before_pool(cdt, jdt, want):
    args = _identity_pool_args([[1.0, 1.0 + 2 ** -10], [0.5, 0.25]])
    out, idx = _port(args, cdt)
    f_out, f_idx = _jax_fused(args, jdt)
    assert idx[0, 0, 0, 0] == f_idx[0, 0, 0, 0] == want
    np.testing.assert_array_equal(out, f_out)


def test_exact_ties_go_to_the_first_window_element():
    """conv2 weights of zero: every window is a 4-way tie of zeros, so
    the argmax is 0 everywhere and the output is relu(b2)."""
    spect, w1, b1, _, b2 = _mk(1, 8, 8, seed=4)
    args = (spect, w1, b1, np.zeros((3, 3, 64, 64), np.float32), b2)
    out, idx = _port(args, torch.float32)
    assert not idx.any()
    np.testing.assert_array_equal(out, np.broadcast_to(np.maximum(b2, 0),
                                                       out.shape))
