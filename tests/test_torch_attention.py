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
import os

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
    s = (jnp.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(q.shape[-1])
         + bias[:, None])
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


# ---------------------------------------------------------------------------
# The backward kernel's algorithm (`attn_bwd_emulated`): one pass over key
# tiles of 16-key chunks, 64-query tiles with padding, dQ's per-key-tile
# shares added in key-tile order, the mask drawn by the lanes' exchange
# ---------------------------------------------------------------------------

# f32 against the plain autograd backward: the same f32 arithmetic summed
# in another order (over key tiles, then query tiles), relative to the
# largest value of each gradient: a few 1e-7 (observed <= 4e-7)
EMU_F32_TOL = 2e-6
# bf16: the dropped P and dS round to bf16 (2^-8 relative) before their
# products, the output O of D = dO.O too; relative to the largest value of
# each gradient, as the card's ATTN_TOL (observed <= 5.3e-3)
EMU_BF16_TOL = 2e-2
# (Tq, Tk, causal): ragged tiles both ways, the decoder self-attention
# (causal bias), the decoder cross-attention (two key tiles), three key
# tiles of uneven width (6, 6, 7 chunks)
EMU_SHAPES = [(7, 33, False), (33, 7, False), (51, 51, True),
              (51, 200, False), (17, 300, False)]


def _emu_inputs(Tq, Tk, causal, seed, Dk=64):
    r = np.random.RandomState(seed)
    q = r.randn(B, H, Tq, Dk).astype(np.float32)
    k = r.randn(B, H, Tk, Dk).astype(np.float32)
    v = r.randn(B, H, Tk, Dk).astype(np.float32)
    mask = r.rand(B, Tq, Tk) < 0.2
    if causal:
        mask |= np.triu(np.ones((Tq, Tk), bool), 1)
    mask[1, Tq - 1] = True                 # a query with every key masked
    bias = np.where(mask, np.float32(-1e9), np.float32(0.0))
    dout = r.randn(B, H, Tq, Dk).astype(np.float32)
    return q, k, v, bias, dout


def _rel(a, b):
    """max |a - b| over max |b| (floor 1e-3); torch tensors."""
    b = b.float()
    return ((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-3)
            ).item()


def _emulate(q, k, v, bias, dout, rate, keep=None, cdt=torch.float32,
             seed=5):
    """The emulated backward on the inputs rounded to cdt, with the plain
    forward's output and the forward kernel's statistics."""
    qt, kt, vt, gt = (torch.from_numpy(a).to(cdt) for a in (q, k, v, dout))
    bt = torch.from_numpy(bias)
    kp = None if keep is None else torch.from_numpy(keep)
    out = AF.flash_mha_train_plain(qt, kt, vt, bt, seed, rate, keep=kp)
    stats = AF.attn_stats_plain(qt, kt, bt)
    return AF.attn_bwd_emulated(qt, kt, vt, bt, out, stats, gt, seed, rate,
                                keep=kp)


@pytest.mark.parametrize("Tq,Tk", [(7, 33), (33, 7), (51, 51), (51, 200),
                                   (1, 1), (65, 257)])
@pytest.mark.parametrize("seed", [0, 2 ** 64 - 1])
def test_backward_lanes_draw_the_spec_bits(Tq, Tk, seed):
    """The backward kernel draws one Philox call per four keys and the
    four lanes of a key group swap words: the mask that gives is the
    spec's, bit for bit."""
    thresh16 = AF.dropout_thresh16(0.3)
    got = AF.keep_mask_by_lanes(seed, 2, 3, Tq, Tk, thresh16)
    assert torch.equal(got, AF.keep_mask(seed, 2, 3, Tq, Tk, thresh16))


def test_backward_key_tiles_cover_the_keys_in_chunks():
    assert AF.key_tiles(200) == [(0, 96), (96, 200)]
    assert AF.key_tiles(51) == [(0, 51)]
    for Tk in (1, 16, 17, 128, 129, 200, 257, 1000):
        t = AF.key_tiles(Tk)
        assert t[0][0] == 0 and t[-1][1] == Tk and len(t) == -(-Tk // 128)
        assert all(a[1] == b[0] for a, b in zip(t, t[1:]))
        assert all(a % 16 == 0 and 0 < b - a <= 128 for a, b in t)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Tq,Tk,causal", EMU_SHAPES)
def test_backward_emulation_equals_the_plain_backward(Tq, Tk, causal, rate):
    """f32: the kernel's algorithm against autograd of the plain version
    (the same Philox mask), tight; bf16: against the plain f32 backward of
    the same bf16 inputs, within the card's tolerance."""
    q, k, v, bias, dout = _emu_inputs(Tq, Tk, causal, Tq * 1000 + Tk)
    seed = 0x5EED
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = AF.flash_mha_train_plain(*qkv, torch.from_numpy(bias), seed, rate)
    want = torch.autograd.grad(out, qkv, torch.from_numpy(dout))
    got = _emulate(q, k, v, bias, dout, rate, seed=seed)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel(a, b) < EMU_F32_TOL
    got = _emulate(q, k, v, bias, dout, rate, cdt=torch.bfloat16, seed=seed)
    qkv = [torch.from_numpy(a).to(torch.bfloat16).float().requires_grad_()
           for a in (q, k, v)]
    out = AF.flash_mha_train_plain(*qkv, torch.from_numpy(bias), seed, rate)
    want = torch.autograd.grad(
        out, qkv, torch.from_numpy(dout).to(torch.bfloat16).float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and _rel(a, b) < EMU_BF16_TOL


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Tq,Tk,causal", EMU_SHAPES)
def test_backward_emulation_matches_jax(Tq, Tk, causal, rate):
    """f32, against the JAX package: its ``flash_mha_train`` kernel
    (interpret mode) at rate 0, its reference on a keep mask fed from
    numpy at rate 0.1 (the TPU's bits cannot be reproduced); the fully
    masked query's gradients too. Sums in another order: GRAD_TOL."""
    q, k, v, bias, dout = _emu_inputs(Tq, Tk, causal, Tq + 7 * Tk)
    qkv = [jnp.asarray(a) for a in (q, k, v)]
    if rate == 0.0:
        keep = None
        f = lambda q, k, v: JAF.flash_mha_train(
            q, k, v, jnp.asarray(bias), jnp.array([3], jnp.int32), 0.0)
    else:
        keep = np.random.RandomState(Tq).rand(B, H, Tq, Tk) < 0.9
        scale = np.float32(65536.0 / AF.dropout_thresh16(rate))
        f = lambda q, k, v: _jax_ref(q, k, v, jnp.asarray(bias),
                                     jnp.asarray(keep), scale)
    _, vjp = jax.vjp(f, *qkv)
    want = vjp(jnp.asarray(dout))
    got = _emulate(q, k, v, bias, dout, rate, keep=keep)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL)


def test_backward_probe_cuts_apply_to_the_source():
    """tools/probe_attn_bwd.py times the backward kernel's parts by cutting
    lines out of csrc/attention.cu: each cut must still find its lines and
    change the source, and the earlier design's file is told apart."""
    import os
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.tools import probe_attn_bwd as PA
    with open(os.path.join(cuda_lib.CSRC_DIR, PA.SOURCE)) as f:
        src = f.read()
    assert PA.design_of(src) == "fused"
    assert PA.design_of("... attn_delta_kernel ...") == "three_kernel"
    copies = {name: PA.cut(src, name) for name in PA.CUTS}
    assert src not in copies.values()
    assert len(set(copies.values())) == len(PA.CUTS)
    assert PA.cut(src, "philox+softmax") == PA.cut(copies["philox"],
                                                   "softmax")


# ---------------------------------------------------------------------------
# The forward kernel's algorithm (`attn_fwd_emulated`): key groups of a
# block, each with its own online softmax over its share of every 64-key
# tile, combined in group order; the mask drawn by pairs of lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Tq,Tk", [(51, 51), (51, 200), (200, 200), (7, 33),
                                   (33, 7), (1, 1), (65, 257), (51, 13)])
@pytest.mark.parametrize("seed", [0, 2 ** 64 - 1])
def test_forward_lanes_draw_the_spec_bits(Tq, Tk, seed):
    """The forward kernel draws one Philox call per four elements: the
    even lane of a pair the call of one row, the odd lane that of the row
    8 below, and they swap two flags each. The mask that gives is the
    spec's, bit for bit."""
    thresh16 = AF.dropout_thresh16(0.3)
    got = AF.keep_mask_by_fwd_lanes(seed, 2, 3, Tq, Tk, thresh16)
    assert torch.equal(got, AF.keep_mask(seed, 2, 3, Tq, Tk, thresh16))


def test_forward_grid_fills_the_card_at_the_step_shapes():
    """B = 12, H = 8 on 132 SMs: the encoder (Tq = 200) keeps 64-row
    blocks (384 of them); the decoder (Tq = 51) splits the keys 4 ways,
    384 blocks of 16 rows instead of 96 of 64."""
    assert AF.fwd_key_split(12, 8, 200, 132) == 1
    assert AF.fwd_key_split(12, 8, 51, 132) == 4
    assert AF.fwd_key_split(12, 8, 100, 132) == 2
    assert AF.fwd_key_split(1, 1, 7, 132) == 4
    for Tq in (51, 200):
        wk = AF.fwd_key_split(12, 8, Tq, 132)
        assert -(-Tq // (64 // wk)) * 96 >= 2 * 132


FWD_SHAPES = [(7, 33, False), (33, 7, False), (51, 51, True),
              (51, 200, False), (17, 300, False)]


@pytest.mark.parametrize("key_split", AF.KEY_SPLITS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Tq,Tk,causal", FWD_SHAPES)
def test_forward_emulation_equals_the_plain_version(Tq, Tk, causal, rate,
                                                    key_split):
    """f32: the kernel's algorithm against the plain version (the same
    Philox mask) and its statistics against attn_stats_plain, tight;
    bf16: against the plain f32 version of the same bf16 inputs, within
    the card's tolerance (P rounds to bf16 at each group's running max)."""
    q, k, v, bias, _ = _emu_inputs(Tq, Tk, causal, Tq * 1000 + Tk)
    seed = 0x5EED
    qt, kt, vt, bt = (torch.from_numpy(a) for a in (q, k, v, bias))
    out, stats = AF.attn_fwd_emulated(qt, kt, vt, bt, seed, rate, key_split)
    want = AF.flash_mha_train_plain(qt, kt, vt, bt, seed, rate)
    assert torch.isfinite(out).all()
    assert _rel(out, want) < EMU_F32_TOL
    want_stats = AF.attn_stats_plain(qt, kt, bt)
    assert _rel(stats[..., 0], want_stats[..., 0]) < EMU_F32_TOL
    assert _rel(stats[..., 1], want_stats[..., 1]) < EMU_F32_TOL
    qb, kb, vb = (t.to(torch.bfloat16) for t in (qt, kt, vt))
    out, _ = AF.attn_fwd_emulated(qb, kb, vb, bt, seed, rate, key_split)
    want = AF.flash_mha_train_plain(qb.float(), kb.float(), vb.float(), bt,
                                    seed, rate)
    assert out.dtype == torch.bfloat16 and _rel(out, want) < EMU_BF16_TOL


@pytest.mark.parametrize("key_split", AF.KEY_SPLITS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Tq,Tk,causal", FWD_SHAPES)
def test_forward_emulation_matches_jax(Tq, Tk, causal, rate, key_split):
    """f32, against the JAX package: its ``flash_mha_train`` kernel
    (interpret mode) at rate 0, its reference on a keep mask fed from
    numpy at rate 0.1; the fully masked query too. Sums in another
    order: FWD_TOL."""
    q, k, v, bias, _ = _emu_inputs(Tq, Tk, causal, Tq + 7 * Tk)
    if rate == 0.0:
        keep = None
        want = JAF.flash_mha_train(*(jnp.asarray(a) for a in (q, k, v)),
                                   jnp.asarray(bias),
                                   jnp.array([3], jnp.int32), 0.0)
    else:
        keep = np.random.RandomState(Tq).rand(B, H, Tq, Tk) < 0.9
        scale = np.float32(65536.0 / AF.dropout_thresh16(rate))
        want = _jax_ref(*(jnp.asarray(a) for a in (q, k, v)),
                        jnp.asarray(bias), jnp.asarray(keep), scale)
    out, _ = AF.attn_fwd_emulated(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), 3, rate, key_split,
        keep=None if keep is None else torch.from_numpy(keep))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=FWD_TOL)


def test_wrapper_cpu_path_takes_the_projections_views():
    """layers.mha hands the wrapper transposed views of the (B, T, H, D)
    projections: on the CPU the plain version gives the same forward and
    gradients as on contiguous copies."""
    r = np.random.RandomState(12)
    qp, kp, vp = (torch.from_numpy(r.randn(B, t, H, D).astype(np.float32))
                  for t in (T, S, S))
    bias = torch.from_numpy(_inputs(5)[3])
    dout = torch.from_numpy(r.randn(B, T, H, D).astype(np.float32))
    results = []
    for make in (lambda t: t.transpose(1, 2),
                 lambda t: t.transpose(1, 2).contiguous()):
        qkv = [make(t).detach().requires_grad_() for t in (qp, kp, vp)]
        assert qkv[0].is_contiguous() == (len(results) == 1)
        out = AF.flash_mha_train(*qkv, bias, 21, 0.1)
        results.append((out, *torch.autograd.grad(out, qkv,
                                                  make(dout))))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_forward_probe_cuts_apply_to_the_source():
    """tools/probe_attn_fwd.py times the forward kernel's parts by cutting
    lines out of csrc/attention.cu: each cut must still find its lines and
    change the source, and the earlier design's file is told apart."""
    import os
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.tools import probe_attn_fwd as PF
    with open(os.path.join(cuda_lib.CSRC_DIR, PF.SOURCE)) as f:
        src = f.read()
    assert PF.design_of(src) == "strided"
    assert PF.design_of("... Params<T> p, T* out ...") == "contiguous"
    copies = {name: PF.cut(src, name) for name in PF.CUTS}
    assert src not in copies.values()
    assert len(set(copies.values())) == len(PF.CUTS)
    assert PF.cut(src, "philox+bias") == PF.cut(copies["philox"], "bias")


# ---------------------------------------------------------------------------
# kernel 9, dropout_bits: one thread a group of four words, its (q, c) from
# the flat index of its (b, h) slab by a multiply-high (no division)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Tk", [3, 4, 200, 201])
@pytest.mark.parametrize("seed", [0, 2 ** 64 - 1])
def test_bits_threads_write_every_element_once_by_the_spec(Tk, seed):
    """The kernel's grid (groups of a (b, h) / 256, H, B) and its threads'
    (q, c), through the magic division as the source computes it: every
    element of (B, H·Tq, Tk) written exactly once (the 16-byte store where
    Tk % 4 == 0, the scalar ones short of Tk otherwise), with the word the
    spec's counter (c, q, h, b) draws for it."""
    bits, writes = AF.dropout_bits_by_threads(seed, 2, 3, 37, Tk)
    assert bool((writes == 1).all())
    assert torch.equal(bits, AF.dropout_bits_plain(seed, 2, 3, 37, Tk))


def test_bits_magic_division_and_launch_match_the_source():
    """n // d by (n · mul >> 32) >> shr for every d up to 1024 and n at the
    ends of [0, 2^31) and around every multiple of d below 4096 (the
    method holds for all n < 2^31), d = 1 left to the kernel's own branch;
    the wrapper's block size is the source's."""
    import os
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.tools import probe_lib
    k = probe_lib.constexprs(os.path.join(cuda_lib.CSRC_DIR, "attention.cu"))
    assert k["BITS_THREADS"] == AF.BITS_THREADS
    ends = torch.cat([torch.arange(4096), 2 ** 31 - 1 - torch.arange(4096)])
    for d in range(2, 1025):
        mul, shr = AF.fast_div_magic(d)
        assert 0 < mul < 2 ** 32 and shr >= 0
        assert torch.equal(((ends * mul) >> 32) >> shr, ends // d), d


def test_bits_probe_variants_apply_to_the_source():
    """tools/probe_dropout_bits.py --variants times copies of
    csrc/attention.cu with one knob of the bits kernel turned: each edit
    must still find its text once and give a source of its own."""
    import os
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.tools import probe_dropout_bits as PD
    from end2end_asr_tpu_torch.tools import probe_lib
    with open(os.path.join(cuda_lib.CSRC_DIR, PD.SOURCE)) as f:
        src = f.read()
    copies = probe_lib.edited_copies(src, PD.VARIANTS, list(PD.VARIANTS),
                                     "test")
    assert src not in copies.values()
    assert len(set(copies.values())) == len(PD.VARIANTS)


def test_bits_bound_counts_bytes_and_the_kernels_integer_work(tmp_path,
                                                              monkeypatch):
    """chip_smoke.py's bound for kernel 9: the larger of 4 bytes a bit over
    3.35 TB/s and the kernel's vector integer instructions (its SASS,
    uniform-datapath, memory and control instructions left out) a group
    of four words times the groups over 132 SMs x 64 lanes x the clock."""
    from end2end_asr_tpu_torch.tools import probe_dropout_bits as PD
    sass = "\n".join([
        "Function : _ZN1a19dropout_bits_kernelILb0EEEvv",
        "        /*0000*/                   IMAD R1, R2, R3, RZ ;",
        "Function : _ZN1a19dropout_bits_kernelILb1EEEvv",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        "        /*0010*/                   IMAD.WIDE.U32 R4, R3, R5, RZ ;",
        "        /*0020*/         LOP3.LUT R6, R4, R7, R8, 0x96, !PT ;",
        "        /*0030*/              @!P0 EXIT ;",
        "        /*0040*/                   UIADD3 UR4, UR4, 0x1, URZ ;",
        "        /*0050*/                   VIADD R9, R9, 0x9e3779b9 ;",
        "        /*0060*/         STG.E.EF.128 desc[UR4][R2.64], R4 ;",
        "        /*0070*/                   NOP;",
        "Function : _ZN1a5otherEv"])
    tool = tmp_path / "cuobjdump"
    tool.write_text(f"#!/bin/sh\ncat <<'X'\n{sass}\nX\n")
    tool.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    ops = PD.sass_opcodes("lib.so", "dropout_bits_kernelILb1E")
    assert ops == {"LDC": 1, "IMAD": 1, "LOP3": 1, "EXIT": 1, "UIADD3": 1,
                   "VIADD": 1, "STG": 1}
    assert PD.int_ops(ops) == 3
    b = PD.bound(12, 8, 200, 200, 76, 132, 1.98e9)
    assert b["groups"] == 960000 and b["bound_by"] == "bytes"
    assert abs(b["bytes_ms"] - 4 * 12 * 8 * 200 * 200 / 3.35e9) < 1e-12
    assert abs(b["ops_ms"] - 76 * 960000 / (132 * 64 * 1.98e6)) < 1e-12
    assert PD.bound(12, 8, 200, 200, 200, 132, 1.98e9)["bound_by"] == \
        "operations"
