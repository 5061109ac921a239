"""Port parity: the training attention (kernels 4, 5, 9) and dropout.

The port's Philox stream against the published known answers and its
keep fraction; the port's plain `flash_mha_train` (the CPU side of the
kernel wrappers) forward and gradients against the JAX package's
``flash_mha_train`` (interpret mode, as its own tests run it) at rate 0,
and against a JAX reference fed the same keep mask at rate 0.1 (the
TPU's random stream cannot be reproduced, so the mask comes from the
port's bits, through numpy); the plain dropout on numpy bits; and the
training `mha` routing through the kernel path. The CUDA kernels are held
against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu.models import layers as JL
from end2end_asr_tpu.ops import attention_fused as JAF
from end2end_asr_tpu_torch.models import layers as TL
from end2end_asr_tpu_torch.ops import attention_fused as AF

B, H, T, S, D = 2, 2, 16, 24, 8
# f32 on both sides: sums in another order
FWD_TOL, GRAD_TOL = 1e-5, 3e-5


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(B, H, T, D).astype(np.float32)
    k = r.randn(B, H, S, D).astype(np.float32)
    v = r.randn(B, H, S, D).astype(np.float32)
    mask = r.rand(B, T, S) < 0.2
    mask[1, 3] = True                      # a query with every key masked
    bias = np.where(mask, np.float32(-1e9), np.float32(0.0))
    return q, k, v, bias


def _jax_ref(q, k, v, bias, keep=None, scale=None):
    s = jnp.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(D) + bias[:, None]
    p = jax.nn.softmax(s, -1)
    if keep is not None:
        p = jnp.where(keep, p * scale, jnp.zeros_like(p))
    return jnp.einsum("bhts,bhsd->bhtd", p, v)


def _port(q, k, v, bias, seed, rate, dout, keep=None):
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if keep is None:
        out = AF.flash_mha_train(*qkv, torch.from_numpy(bias), seed, rate)
    else:
        out = AF.flash_mha_train_plain(*qkv, torch.from_numpy(bias), seed,
                                       rate, keep=torch.from_numpy(keep))
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(dout))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("words,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD))])
def test_philox_known_answers(words, key, want):
    c = [torch.tensor([w], dtype=torch.int64) for w in words]
    got = AF.philox4x32_10(*c, *key)
    assert tuple(int(x) for x in got) == want


def test_keep_fraction_and_layout():
    rate = 0.1
    thresh16 = AF.dropout_thresh16(rate)
    assert thresh16 == 58982
    bits = AF.dropout_bits(5, 4, 4, 32, 128)
    assert bits.shape == (4, 128, 128) and bits.dtype == torch.int64
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    n = bits.numel()
    p = thresh16 / 65536
    frac = (bits < thresh16 * 65536).double().mean().item()
    assert abs(frac - p) < 4 * math.sqrt(p * (1 - p) / n)
    # the spec: word (k & 3) of Philox(counter=(k >> 2, q, h, b), key=seed)
    b, h, q, k = 3, 2, 17, 101
    w = AF.philox4x32_10(*(torch.tensor([x]) for x in (k >> 2, q, h, b)),
                         5, 0)
    assert int(bits[b, h * 32 + q, k]) == int(w[k & 3])
    # seeds differ by their high word only: different streams
    assert not torch.equal(AF.dropout_bits(1, 1, 1, 4, 8),
                           AF.dropout_bits(1 + 2 ** 32, 1, 1, 4, 8))


def test_rate0_matches_jax_kernel_fwd_and_grads():
    q, k, v, bias = _inputs()
    dout = np.random.RandomState(9).randn(B, H, T, D).astype(np.float32)
    seed = jnp.array([7], jnp.int32)
    f = lambda q, k, v: JAF.flash_mha_train(q, k, v, jnp.asarray(bias),
                                            seed, 0.0)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(dout))
    out, grads = _port(q, k, v, bias, 7, 0.0, dout)
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_TOL)
    # the fully masked query attends uniformly, finite
    np.testing.assert_allclose(out[1, :, 3], v[1].mean(axis=1), atol=FWD_TOL)
    for a, b in zip(grads, want_g):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_TOL)


def test_dropout_matches_jax_reference_on_the_same_mask():
    rate = 0.1
    thresh16 = AF.dropout_thresh16(rate)
    scale = np.float32(65536.0 / thresh16)
    q, k, v, bias = _inputs(1)
    dout = np.random.RandomState(3).randn(B, H, T, D).astype(np.float32)
    seed = 0xC0FFEE
    keep = AF.keep_mask(seed, B, H, T, S, thresh16).numpy()
    assert 0 < keep.mean() < 1
    f = lambda q, k, v: _jax_ref(q, k, v, jnp.asarray(bias),
                                 jnp.asarray(keep), scale)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(dout))
    # the Philox draw inside the wrapper, and the mask fed from numpy
    for keep_arg in (None, keep):
        out, grads = _port(q, k, v, bias, seed, rate, dout, keep=keep_arg)
        np.testing.assert_allclose(out, np.asarray(want), atol=FWD_TOL)
        for a, b in zip(grads, want_g):
            np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_TOL)


def test_f32_dropout_matches_jax_kernel_on_its_own_mask():
    """The f32 attention with dropout (what ``--dtype float32`` training
    runs): the JAX ``flash_mha_train`` kernel at f32 and rate 0.1 in
    interpret mode, against the port's plain version fed the JAX kernel's
    own keep mask (its ``dropout_bits``, through numpy), forward and
    gradients. On the CPU Mosaic's interpret PRNG draws zero bits, so that
    mask keeps every key and this holds the 65536/thresh16 scale and the
    kernel path; the dropped pattern is held by the case above."""
    rate = 0.1
    thresh16 = AF.dropout_thresh16(rate)
    q, k, v, bias = _inputs(2)
    dout = np.random.RandomState(4).randn(B, H, T, D).astype(np.float32)
    seed = jnp.array([11], jnp.int32)
    bits = np.asarray(JAF.dropout_bits(seed, B, H, T, S)).reshape(B, H, T, S)
    keep = bits < np.uint32(thresh16 * 65536)
    f = lambda q, k, v: JAF.flash_mha_train(q, k, v, jnp.asarray(bias),
                                            seed, rate)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(dout))
    assert want.dtype == jnp.float32
    out, grads = _port(q, k, v, bias, 11, rate, dout, keep=keep)
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_TOL)
    for a, b in zip(grads, want_g):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5, 1.0])
def test_plain_dropout_on_numpy_bits(rate):
    r = np.random.RandomState(int(rate * 10))
    x = r.randn(3, 5, 7).astype(np.float32)
    bits = r.randint(0, 65536, size=x.shape).astype(np.int32)
    thresh = JL.dropout_thresh16(rate)
    assert thresh == AF.dropout_thresh16(rate)
    want = (np.where(bits < thresh, x * np.float32(65536.0 / thresh), 0.0)
            if thresh > 0 else np.zeros_like(x))
    got = TL.dropout(torch.from_numpy(x), rate,
                     bits=torch.from_numpy(bits)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7)
    rng = TL.DropoutRng(0, "cpu")
    a = TL.dropout(torch.from_numpy(x), rate, rng)
    assert a.shape == x.shape and torch.isfinite(a).all()


def test_training_mha_routes_masked_attention_through_the_kernel(
        monkeypatch):
    """With dropout and a mask, mha calls flash_mha_train with the -1e9
    bias and a seed from the run's generator; without a mask it stays on
    the plain path."""
    calls = []
    real = AF.flash_mha_train

    def spy(q, k, v, bias, seed, rate):
        calls.append((bias.clone(), seed, rate))
        return real(q, k, v, bias, seed, rate)

    monkeypatch.setattr(AF, "flash_mha_train", spy)
    r = np.random.RandomState(2)
    dm = H * D
    p = {n: {"w": torch.from_numpy(r.randn(dm, dm).astype(np.float32) * .1),
             "b": torch.zeros(dm)} for n in ("q", "k", "v", "out")}
    p["ln"] = {"scale": torch.ones(dm), "bias": torch.zeros(dm)}
    x = torch.from_numpy(r.randn(B, T, dm).astype(np.float32))
    mask = torch.from_numpy(r.rand(B, T, T) < 0.3)
    rng = TL.DropoutRng(1, "cpu")
    out = TL.mha(p, x, x, x, H, D, D, mask=mask, dtype=torch.float32,
                 dropout_rate=0.1, rng=rng)
    assert len(calls) == 1 and calls[0][2] == 0.1
    assert torch.equal(calls[0][0], torch.where(mask, -1e9, 0.0))
    assert torch.isfinite(out).all()
    TL.mha(p, x, x, x, H, D, D, mask=None, dtype=torch.float32,
           dropout_rate=0.1, rng=rng)
    TL.mha(p, x, x, x, H, D, D, mask=mask, dtype=torch.float32)
    assert len(calls) == 1
