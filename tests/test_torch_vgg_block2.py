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


# ---------------------------------------------------------------------------
# the decomposition of the bf16 forward kernel (csrc/vgg_block2.cu,
# vgg_block2_fwd_wgmma_kernel), mirrored here so that its index math is
# held against the plain forward before the card: min(items, blocks)
# persistent blocks over fixed ranges of work items (utterance, 100-column
# strip, pooled row r), r fastest; every tile row FQ = 104 positions (x
# columns c0-2 .., x2 columns c0-1 .., conv4 columns c0 ..); a ring of 4 x
# rows and one of 4 x2 rows in two 64-channel halves, laid out flat in
# shared memory as the kernel lays them out, so a tap (df, dt) reads a
# slot from position dt and positions past a row's end read the next
# slot (unwritten memory is NaN here: a valid output that read it would
# be NaN); a warm pass (x2 rows 2r-1, 2r) at a block's first item and at
# a strip's first row; conv3 -> bf16, + b3, relu, zero outside the image
# and in the garbage columns; conv4 over (tap, input half) stages of the
# packed, swizzled weights (ops.vgg_fused._fwd2_stages, read back through
# the swizzle); the pool in (f, t) order with the first maximum winning,
# + b4, relu; pooled columns through the staging tile's rows as the
# transposed stmatrix of the kernel's pool epilogue writes them.
# ---------------------------------------------------------------------------

FQ, FOWN, SM_BLOCKS = 104, 100, 132


def _unswizzle(stages):
    """The stages as the tensor cores read them: row r, channel k from
    chunk (k // 8) ^ (r % 8)."""
    r = torch.arange(128)[:, None]
    k = torch.arange(64)[None, :]
    return stages[:, r, ((k // 8) ^ (r % 8)) * 8 + k % 8]


def _pool_rows(i):
    """Staging rows of the kernel's stmatrix for n8 blocks i - 1, i (i odd):
    fragment column kk holds pooled column 4 (i - 1) + kk // 2 + 4 (kk % 2)."""
    return [4 * (i - 1) + (kk >> 1) + 4 * (kk & 1) for kk in range(8)]


def _fwd_mirror(x, w3, b3, w4, b4, cdt, blocks=SM_BLOCKS, mutate=None):
    """`mutate`: None, or a fault the mirror must be caught with: "tap"
    (conv4's taps read the x2 row one below) or "border" (x2 keeps
    relu(0 + b3) past the image's columns)."""
    f32 = torch.float32
    rnd = lambda t: t.to(cdt).to(f32)
    B, F, T, _ = x.shape
    Fp, Tp = F // 2, T // 2
    strips = -(-T // FOWN)
    n = B * strips * Fp
    s3, s4 = TV._fwd2_stages(rnd(w3), rnd(w4))
    A3, A4 = _unswizzle(s3), _unswizzle(s4)   # (9 | 18, 128 out, 64 in)
    bias3, bias4 = rnd(b3), rnd(b4)
    xp = Fn.pad(rnd(x), (0, 0, 2, strips * FOWN + 2 - T, 2, 2))
    out = torch.full((B, Fp, Tp, 128), float("nan"))
    idx = torch.full((B, Fp, Tp, 128), 9, dtype=torch.uint8)
    slot = lambda f: (f + 4) & 3
    col = torch.arange(FQ)
    dfo = 1 if mutate == "tap" else 0
    grid = min(n, blocks)
    for blk in range(grid):
        lo, hi = n * blk // grid, n * (blk + 1) // grid
        # the rings as rows of 64 channels, with the next buffer's first
        # rows (read by the garbage positions of the last slot) unwritten
        xs = torch.full((4 * FQ + 2, 64), float("nan"))
        x2 = torch.full((8 * FQ + 2, 64), float("nan"))
        for it in range(lo, hi):
            r, q = it % Fp, it // Fp
            c0, b = q % strips * FOWN, q // strips
            warm = it == lo or r == 0
            for pre in ((True, False) if warm else (False,)):
                f0 = 2 * r - 1 if pre else 2 * r + 1
                for f in (range(f0 - 1, f0 + 3) if pre else (f0 + 1, f0 + 2)):
                    xs[slot(f) * FQ:slot(f) * FQ + FQ] = xp[b, f + 2, c0:c0 + FQ]
                for f in (f0, f0 + 1):
                    y = sum(xs[slot(f + t // 3 - 1) * FQ + t % 3:][:FQ]
                            @ A3[t].T for t in range(9))
                    v = torch.relu(rnd(rnd(y) + bias3))
                    tt = c0 - 1 + col
                    inside = (tt >= 0) & (tt < T) & (col < FQ - 2)
                    if mutate == "border":
                        inside = col < FQ - 2
                    v = torch.where(inside[:, None] & (0 <= f < F), v,
                                    torch.zeros(()))
                    for h in range(2):
                        s = (slot(f) * 2 + h) * FQ
                        x2[s:s + FQ] = v[:, 64 * h:64 * h + 64]
            y4 = []
            for g in (2 * r, 2 * r + 1):
                y4.append(rnd(sum(
                    x2[(slot(g + t // 3 - 1 + dfo) * 2 + h) * FQ + t % 3:][:FQ]
                    @ A4[2 * t + h].T for t in range(9) for h in range(2))))
            # windows (f, t) in order (0,0), (0,1), (1,0), (1,1)
            win = torch.stack([y4[0][0::2], y4[0][1::2], y4[1][0::2],
                               y4[1][1::2]])              # (4, 52, 128)
            best, id_ = win[0], torch.zeros(FQ // 2, 128, dtype=torch.uint8)
            for m in range(1, 4):
                gt = win[m] > best
                best = torch.where(gt, win[m], best)
                id_ = torch.where(gt, torch.tensor(m, dtype=torch.uint8), id_)
            val = torch.relu(rnd(best + bias4))
            # the staging tile: pooled rows as the pool epilogue's
            # stmatrix writes them (blocks 12, 13: 13 is zero)
            stage_v = torch.full((56, 128), float("nan"))
            vz = torch.cat([val, torch.zeros(4, 128)])
            for i in range(1, FQ // 8 + 2, 2):
                # a lane's register: block i - 1 (low half, fragment
                # column 2a) and block i (high, 2a + 1), a = lane % 4
                for a in range(4):
                    for e in range(2):
                        stage_v[_pool_rows(i)[2 * a + e]] = \
                            vz[4 * (i - 1) + a + 4 * e]
            np_ = min(FOWN // 2, Tp - c0 // 2)
            out[b, r, c0 // 2:c0 // 2 + np_] = stage_v[:np_]
            idx[b, r, c0 // 2:c0 // 2 + np_] = id_[:np_]
    return out.to(cdt), idx


def _fwd_case(shape, seed):
    B, F, T = shape
    x, w3, b3, w4, b4 = _t(_mk(B, F, T, seed=seed))
    return (x.relu(), w3, b3, w4, b4)


def _idx_clear(args, cdt, gap):
    """Windows whose plain conv4 best and second-best values lie further
    apart than `gap` relative to max(|best|, 1) (chip_smoke.py's test)."""
    x, w3, b3, w4, _ = args
    y4 = Fn.conv2d(TV._x2_plain(x, w3, b3, cdt), TV._nchw(w4, cdt),
                   padding=1).float()
    Bn, C, F, T = y4.shape
    w = y4.reshape(Bn, C, F // 2, 2, T // 2, 2).permute(
        0, 2, 4, 1, 3, 5).reshape(Bn, F // 2, T // 2, C, 4)
    top = w.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) > gap * top[..., 0].abs().clamp_min(1)


# the card's tolerances (chip_smoke.py VGG2_F32_TOL for f32: the same
# products summed in another order; VGG_BF16_ATOL + VGG_BF16_RTOL * |plain|
# elementwise for bf16: a sum by a bf16 rounding boundary rounds the other
# way), and the argmax gaps beyond which it must agree (IDX_GAP_*)
FWD_MIRROR_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}
IDX_GAP = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


@pytest.mark.parametrize("blocks", [SM_BLOCKS, 3])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MIRROR_SHAPES)
def test_fwd_wgmma_decomposition_equals_the_plain_forward(shape, cdt, blocks):
    """The forward's items, strips, rings, warm passes, tap shifts, x2
    halves, garbage columns and epilogue order against the plain forward,
    with one block an item (at these shapes the card's 132 blocks
    outnumber the items) and with 3 blocks walking down their strips."""
    args = _fwd_case(shape, seed=sum(shape))
    got, idx = _fwd_mirror(*args, cdt, blocks=blocks)
    want, want_idx = TV.vgg_block2_plain(*args, cdt=cdt)
    assert got.shape == want.shape and not torch.isnan(got.float()).any()
    if cdt == torch.float32:
        assert _rel_l2(got, want) < FWD_MIRROR_TOL[cdt]
    else:
        tol = FWD_MIRROR_TOL[cdt] * (1 + want.float().abs())
        assert bool(((got.float() - want.float()).abs() <= tol).all())
    clear = _idx_clear(args, cdt, IDX_GAP[cdt])
    assert clear.float().mean() > 0.9
    assert bool((idx == want_idx)[clear].all())


@pytest.mark.parametrize("mutate", ["tap", "border"])
def test_fwd_mirror_catches_a_shifted_tap_and_a_leaking_border(mutate):
    """The comparison above sees conv4's taps read one x2 row off, and
    x2 past the image's last column (the tail strip) left at relu(b3)."""
    args = _fwd_case((1, 4, 70), seed=75)
    got, _ = _fwd_mirror(*args, torch.float32, mutate=mutate)
    want, _ = TV.vgg_block2_plain(*args, cdt=torch.float32)
    got = torch.nan_to_num(got, nan=1e3)
    assert _rel_l2(got, want) > 100 * FWD_MIRROR_TOL[torch.float32]


def test_fwd_stages_pack_the_weights_in_the_kernels_order():
    """_pack_fwd2 (one gather by a cached index) equals _fwd2_stages, and
    reading the stages back through the swizzle gives W3[tap][:, c3] and
    W4[tap][64h .., co]: stage 2t + h of W4."""
    _, w3, _, w4, _ = _t(_mk(1, 4, 2, seed=11))
    p3, p4 = TV._pack_fwd2(w3, w4)
    s3, s4 = TV._fwd2_stages(w3.bfloat16(), w4.bfloat16())
    assert torch.equal(p3.view(9, 128, 64), s3)
    assert torch.equal(p4.view(18, 128, 64), s4)
    a3, a4 = _unswizzle(s3), _unswizzle(s4)
    w3b, w4b = w3.bfloat16().reshape(9, 64, 128), w4.bfloat16().reshape(
        9, 128, 128)
    for t in range(9):
        assert torch.equal(a3[t], w3b[t].T)
        for h in range(2):
            assert torch.equal(a4[2 * t + h], w4b[t, 64 * h:64 * h + 64].T)


def test_fwd_pool_staging_rows_cover_each_pooled_column_once():
    """The pool epilogue's transposed stmatrix puts the 8 pooled columns
    of n8 blocks i - 1, i on 8 distinct staging rows (bank-conflict free:
    8 distinct row % 8) and all 56 rows once over the 7 pairs."""
    rows = [p for i in range(1, FQ // 8 + 2, 2) for p in _pool_rows(i)]
    assert sorted(rows) == list(range(56))
    for i in range(1, FQ // 8 + 2, 2):
        assert sorted(p % 8 for p in _pool_rows(i)) == list(range(8))


def test_fwd_probe_cuts_apply_to_the_source():
    """tools/probe_vgg2_fwd.py times the forward's parts by cutting
    statements out of csrc/vgg_block2.cu: the source is the wgmma design,
    each cut still finds its statement, each part's copy differs and the
    full copy is the shipped source; a changed statement breaks the probe
    loudly; PR 3's tile design (the parent's file) takes its own cuts."""
    import os
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.tools import probe_vgg2_fwd as PF
    with open(os.path.join(cuda_lib.CSRC_DIR, PF.SOURCE)) as f:
        src = f.read()
    assert PF.design_of(src) == "wgmma"
    copies = PF.variants(src)
    assert list(copies) == list(PF.PARTS) and copies["full"] == src
    assert len(set(copies.values())) == len(PF.PARTS)
    assert "out[tid] = out[0];" in copies["conv4"]   # conv4's sums kept
    assert PF.variants(src, ["full"]) == {"full": src}
    with pytest.raises(RuntimeError, match="update the probe"):
        PF.variants(src.replace("conv4_stage(acc4, wst + c * 8192, x2s, r,",
                                "conv4_stage(acc4, wst + 8192 * c, x2s, r,"))
    # the tile design's anchors, as PR 3's kernel has them
    tiles = "\n".join(
        ["template <int CIN, int NOUT, bool STREAM, typename APos, "
         "typename Epi>", "      for (int kc = 0; kc < CIN / 16; ++kc) {",
         "  conv_gemm<CI, C2, true>(\n      xs, w3, C2, ws,",
         "        x2s[p * P2 + n] = D::from_f(",
         "  conv_gemm<C2, C2, true>(\n      x2s, w4, C2, ws,",
         "      [&](int p, int n, float v) { y4s[p * P2 + n] = D::from_f(v); "
         "});", "  for (int e = tid; e < (W / 2) * C2; e += NT) {"])
    assert PF.design_of(tiles) == "tiles"
    t = PF.variants(tiles)
    assert len(set(t.values())) == len(PF.PARTS) and t["full"] == tiles
    assert "conv_gemm<CI, C2, true, false>" in t["staging"]
    assert "bool P = true" in t["conv4"] and "if (false)" in t["conv4"]
