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
import torch.nn.functional as Fn

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


# ---------------------------------------------------------------------------
# the decomposition of the bf16 backward kernel (csrc/vgg_block2.cu,
# vgg_block2_bwd_rows_kernel), mirrored here so that its index math is held
# against the plain backward before the card: 8 channel groups of 16 conv3
# channels, each in RBLK blocks over fixed ranges of work items (utterance,
# 40-column strip, conv row pair r) taken r fastest, so a block walks down
# its strips; the rings of x rows (8), dy4 rows (5) and x2 rows (4) indexed
# by row, the halo rows staged only at a strip's first item of the block
# (its "warm" item), an item's dy4 rows built from its pooled row at its
# start, then the next item's x rows and pooled row loaded into the rings
# (here at once: a slot the item still reads would be overwritten); per
# item x2 of the new rows, dx2 and its mask, dW4, dW3, db3, db4 and the
# item's dy3; the blocks' partial
# sums added in block order; dx from dy3 (_dx_mirror). The last strip of a
# row is cut by T, its columns past T zero.
# ---------------------------------------------------------------------------

RW, RBLK, NCG, CG = 40, 16, 8, 16
XRING, DRING, X2RING = 8, 5, 4
# f32: the same products summed in another order (chip_smoke.py
# VGG2_F32_TOL); bf16: a dx2 sum by a bf16 rounding boundary rounds the
# other way, one bf16 ulp on a share of dy3 (chip_smoke.py VGG2_BWD_BF16_TOL)
MIRROR_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -8}


def _rows_mirror(x, w3, b3, w4, out, idx, g, cdt, mutate=None):
    """`mutate`: None, or a fault the mirror must be caught with: "halo"
    (dx2 reads dy4 one column off) or "border" (x2 keeps relu(0 + b3) in
    conv4's padding past the image)."""
    f32 = torch.float32
    rnd = lambda t: t.to(cdt).to(f32)
    B, F, T, _ = x.shape
    Fp, Tp = F // 2, T // 2
    chunks = -(-T // RW)
    n = B * chunks * Fp
    w3c, b3c = rnd(w3).reshape(9, 64, 128), rnd(b3)
    w4c = rnd(w4).reshape(9, 128, 128)                     # (tap, c3, c4)
    # the staged sources, zero outside the image / pool
    xp = Fn.pad(rnd(x), (0, 0, 2, chunks * RW + 2 - T, 2, 2))
    gm = torch.where(out.float() > 0, g.float(), torch.zeros(()))
    gp = Fn.pad(gm, (0, 0, 1, chunks * RW // 2 + 1 - Tp, 1, 1))
    ip = Fn.pad(idx.long(), (0, 0, 1, chunks * RW // 2 + 1 - Tp, 1, 1))
    dy3 = torch.zeros(B, F, T, 128)
    part = torch.zeros(RBLK, 9 * 64 * 128 + 128 + 9 * 128 * 128 + 128)
    o1, o2, o3 = 9 * 64 * 128, 9 * 64 * 128 + 128, 9 * 64 * 128 + 128 + 9 * 128 * 128
    dh = 1 if mutate == "halo" else 0
    for cg in range(NCG):
        ch = slice(CG * cg, CG * cg + CG)
        for blk in range(RBLK):
            lo, hi = n * blk // RBLK, n * (blk + 1) // RBLK
            xr = torch.zeros(XRING, RW + 4, 64)
            dr = torch.zeros(DRING, RW + 2, 128)
            x2r = torch.zeros(X2RING, RW + 2, CG)
            raw = [None] * 3
            acc4, acc3 = torch.zeros(9, CG, 128), torch.zeros(9, 64, CG)
            db3, db4 = torch.zeros(CG), torch.zeros(CG)

            def load_x(b, c0, f0, k):
                for f in range(f0, f0 + k):   # rows f, columns c0-2 ..
                    xr[(f + 2 * XRING) % XRING] = xp[b, f + 2, c0:c0 + RW + 4]

            def load_raw(b, c0, pr0, k):      # pooled columns c0/2-1 ..
                for s in range(k):
                    pr = pr0 + s + 1
                    raw[s] = (gp[b, pr, c0 // 2:c0 // 2 + RW // 2 + 2],
                              ip[b, pr, c0 // 2:c0 // 2 + RW // 2 + 2])

            def build(pr0, k, flo):
                for s in range(k):
                    gr, ir = raw[s]
                    for a in range(2):
                        f = 2 * (pr0 + s) + a
                        if f < flo:
                            continue
                        row = dr[(f + 2 * DRING) % DRING]
                        for c in range(2):
                            d = torch.where(ir == 2 * a + c, gr,
                                            torch.zeros(()))
                            j = torch.arange(RW // 2 + 2) * 2 - 1 + c
                            ok = (j >= 0) & (j < RW + 2)
                            row[j[ok]] = d[ok]

            for it in range(lo, hi):
                r, b = it % Fp, it // Fp // chunks
                c0 = (it // Fp) % chunks * RW
                warm = it == lo or r == 0
                if warm:
                    load_x(b, c0, 2 * r - 2, 6)
                    load_raw(b, c0, r - 1, 3)
                    build(r - 1, 3, 2 * r - 1)
                else:
                    build(r + 1, 1, 2 * r + 2)
                if it + 1 < hi and r + 1 < Fp:
                    load_x(b, c0, 2 * r + 4, 2)
                    load_raw(b, c0, r + 2, 1)
                xs = lambda f: xr[(f + 2 * XRING) % XRING]
                ds = lambda f: dr[(f + 2 * DRING) % DRING]
                x2s = lambda f: x2r[(f + X2RING) % X2RING]
                # x2 of the new rows, columns c0-1 .. c0+RW
                for f in range(2 * r - 1 if warm else 2 * r + 1, 2 * r + 3):
                    y = sum(xs(f - 1 + df)[dt:dt + RW + 2] @ w3c[3 * df + dt][:, ch]
                            for df in range(3) for dt in range(3))
                    t = c0 - 1 + torch.arange(RW + 2)
                    inside = (t >= 0) & (t < T) & bool(0 <= f < F)
                    v = torch.relu(rnd(rnd(y) + b3c[ch]))
                    x2s(f)[:] = v if mutate == "border" and 0 <= f < F \
                        else torch.where(inside[:, None], v, torch.zeros(()))
                for q in range(2):
                    f = 2 * r + q
                    dx2 = sum(ds(f + 1 - df).roll(dh, 0)[2 - dt:2 - dt + RW]
                              @ w4c[3 * df + dt][ch].T
                              for df in range(3) for dt in range(3))
                    own = ds(f)[1:RW + 1]
                    db4 += own[:, ch].sum(0)
                    d3 = rnd(torch.where(x2s(f)[1:RW + 1] > 0, dx2,
                                         torch.zeros(())))
                    for df in range(3):
                        for dt in range(3):
                            acc4[3 * df + dt] += \
                                x2s(f + df - 1)[dt:dt + RW].T @ own
                            acc3[3 * df + dt] += \
                                xs(f + df - 1)[dt + 1:dt + 1 + RW].T @ d3
                    db3 += d3.sum(0)
                    if f < F:
                        k = min(RW, T - c0)
                        dy3[b, f, c0:c0 + k, ch] = d3[:k]
            p = part[blk]
            p[:o1].view(9, 64, 128)[:, :, ch] = acc3
            p[o1:o2][ch] = db3
            p[o2:o3].view(9, 128, 128)[:, ch] = acc4
            p[o3:][ch] = db4
    grads = part[0].clone()
    for blk in range(1, RBLK):
        grads += part[blk]
    return (_dx_mirror(dy3, w3, cdt), grads[:o1].view(3, 3, 64, 128),
            grads[o1:o2], grads[o2:o3].view(3, 3, 128, 128), grads[o3:])


# the dx kernel (vgg_block2_bwd_dx_kernel): DX_BLOCKS blocks over work
# items (utterance, 30-column strip, conv row pair r), r fastest; an item's
# dy3 rows 2r-1 .. 2r+2, columns c0-1 .. c0+30, in a flat tile of 32
# positions a row between two pad rows; output m = 32 q + j of the item's
# 64 = tap (df, dt) over 9 taps and 128 channels of tile row
# m + 2 + 32 (2 - df) - dt (f32 sums, rounded once), kept for j in 1 .. 30
DXW, DX_BLOCKS = 30, 132


def _dx_mirror(dy3, w3, cdt):
    B, F, T, _ = dy3.shape
    Fp, chunks = F // 2, -(-T // DXW)
    n = B * chunks * Fp
    w = w3.to(cdt).float().reshape(9, 64, 128)              # (tap, ci, c3)
    dp = Fn.pad(dy3, (0, 0, 1, chunks * DXW + 1 - T, 1, 1))
    dx = torch.zeros(B, F, T, 64)
    for blk in range(DX_BLOCKS):
        for it in range(n * blk // DX_BLOCKS, n * (blk + 1) // DX_BLOCKS):
            r, b = it % Fp, it // Fp // chunks
            c0 = (it // Fp) % chunks * DXW
            tile = torch.zeros(2 + 4 * (DXW + 2), 128)
            tile[1:-1] = dp[b, 2 * r:2 * r + 4, c0:c0 + DXW + 2].reshape(-1, 128)
            acc = sum(tile[s:s + 64] @ w[3 * df + dt].T
                      for df in range(3) for dt in range(3)
                      for s in [2 + (DXW + 2) * (2 - df) - dt])
            for q in range(2):
                k = min(DXW, T - c0)
                dx[b, 2 * r + q, c0:c0 + k] = \
                    acc[q * (DXW + 2) + 1:q * (DXW + 2) + 1 + k]
    return dx.to(cdt)


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _mirror_case(shape, cdt, seed):
    B, F, T = shape
    x, w3, b3, w4, b4 = _t(_mk(B, F, T, seed=seed))
    x = x.relu()
    out, idx = TV.vgg_block2_plain(x, w3, b3, w4, b4, cdt=cdt)
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        B, F // 2, T // 2, 128).astype(np.float32)).to(cdt)
    want = TV.vgg_block2_bwd_plain(x, w3, b3, w4, out, idx, g, cdt)
    return (x, w3, b3, w4, out, idx, g), want


# F = 4: the smallest that supported2 takes; T not a multiple of the strip
# width; (1, 4, 70) has fewer items than blocks
MIRROR_SHAPES = [(1, 4, 70), (2, 8, 130), (1, 12, 402)]


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MIRROR_SHAPES)
def test_bwd_rows_decomposition_equals_the_plain_backward(shape, cdt):
    args, want = _mirror_case(shape, cdt, seed=sum(shape))
    got = _rows_mirror(*args, cdt)
    for name, a, b in zip(("dx", "dw3", "db3", "dw4", "db4"), got, want):
        assert a.shape == b.shape, name
        assert _rel_l2(a, b) < MIRROR_TOL[cdt], name


@pytest.mark.parametrize("mutate", ["halo", "border"])
def test_bwd_rows_mirror_catches_a_shifted_halo_and_a_leaking_border(mutate):
    """The comparison above sees a dx2 that reads its dy4 halo one column
    off, and x2 past the image's last column (the tail strip's padding)
    left at relu(b3)."""
    args, want = _mirror_case((1, 4, 70), torch.float32, seed=75)
    got = _rows_mirror(*args, torch.float32, mutate=mutate)
    worst = max(_rel_l2(a, b) for a, b in zip(got, want))
    assert worst > 100 * MIRROR_TOL[torch.float32]


def test_bwd_probe_cuts_apply_to_the_source():
    """tools/probe_vgg2_bwd.py times the backward's parts by cutting
    statements out of csrc/vgg_block2.cu: each cut must still find its
    statement, each part's copy differs, and the full copy is the shipped
    source; its --phases copy finds each of its anchors once; --parts full
    cuts nothing, so it times any source (an older design's); --mma-rate's
    arms are the rate kernel's cases."""
    import os
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.tools import probe_vgg2_bwd as PB
    with open(os.path.join(cuda_lib.CSRC_DIR, PB.SOURCE)) as f:
        src = f.read()
    assert PB.variants("int old;", ["full"]) == {"full": "int old;"}
    assert PB._RATE_SRC.count("case ") == len(PB.RATE_ARMS) - 1
    copies = PB.variants(src)
    assert list(copies) == list(PB.PARTS) and copies["full"] == src
    assert len(set(copies.values())) == len(PB.PARTS)
    assert PB.phases_source(src).count("PH(") == 7  # --phases' counters
    with pytest.raises(RuntimeError, match="update the probe"):
        PB.variants(src.replace("    dw4_products(x2s, dys, acc4, r, warp, "
                                "lane);", "    dw4_products(x2s, dys, acc4, "
                                "r, lane, warp);"))
