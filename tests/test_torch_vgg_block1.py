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
import torch.nn.functional as Fn

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


# ---------------------------------------------------------------------------
# the backward (kernel 3): gradients of w1, b1, w2, b2, none for spect
# ---------------------------------------------------------------------------

# f32 weight gradients: sums over B·F·T terms in another order; relative
# to the largest |grad| of each tensor
GRAD_F32_TOL = 2e-5


def _port_grads(args, g, cdt=torch.float32):
    spect, *w = [torch.from_numpy(a) for a in args]
    w = [t.requires_grad_() for t in w]
    out = TV.VggBlock1.apply(spect, *w, cdt)
    return [t.numpy() for t in torch.autograd.grad(
        out, w, torch.from_numpy(g).to(cdt))]


def _assert_grads_close(got, want, tol):
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * np.abs(b).max()


def test_bwd_matches_jax_fused_vjp():
    """Against jax.grad of the JAX package's fused vgg_block1 (its Pallas
    backward in interpret mode)."""
    args = _mk(2, 16, 16, seed=5)
    g = np.random.RandomState(6).randn(2, 8, 8, 64).astype(np.float32)
    _, vjp = jax.vjp(lambda *w: vgg_block1(jnp.asarray(args[0]), *w,
                                           jnp.float32),
                     *[jnp.asarray(a) for a in args[1:]])
    want = vjp(jnp.asarray(g))
    _assert_grads_close(_port_grads(args, g), want, GRAD_F32_TOL)


@pytest.mark.parametrize("shape", [(1, 17, 16), (2, 9, 13)])
def test_bwd_matches_composite_at_odd_sizes(shape):
    args = _mk(*shape, seed=7)
    B, F, T = shape
    g = np.random.RandomState(8).randn(B, F // 2, T // 2,
                                       64).astype(np.float32)
    _, vjp = jax.vjp(lambda *w: composite(jnp.asarray(args[0]), *w,
                                          jnp.float32),
                     *[jnp.asarray(a) for a in args[1:]])
    _assert_grads_close(_port_grads(args, g), vjp(jnp.asarray(g)),
                        GRAD_F32_TOL)


def test_bwd_gives_no_input_gradient_and_bf16_runs():
    args = _mk(1, 8, 8, seed=9)
    spect = torch.from_numpy(args[0]).requires_grad_()
    w = [torch.from_numpy(a).requires_grad_() for a in args[1:]]
    out = TV.VggBlock1.apply(spect, *w, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), [spect, *w],
                                allow_unused=True)
    assert grads[0] is None
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads[1:])


def test_bf16_card_tolerance_catches_unrounded_dx1():
    """The bf16 kernel-vs-plain tolerance of the block-1 backward
    (VGG_BWD_BF16_TOL = 1e-3 in tests/test_torch_gpu.py and chip_smoke.py)
    is below what dropping the rounding of dx1 to bf16 before dW1
    (vgg_fused.py:279-284 of the JAX package) does to dW1."""
    import torch.nn.functional as Fn
    from end2end_asr_tpu_torch.ops.pool_vjp import pool_bwd_plain
    B, F, T = 2, 16, 16
    bf = torch.bfloat16
    spect, w1, b1, w2, b2 = [torch.from_numpy(a) for a in _mk(B, F, T, 11)]
    out, idx = TV.vgg_block1_plain(spect, w1, b1, w2, b2, cdt=bf)
    g = torch.from_numpy(np.random.RandomState(12).randn(
        B, F // 2, T // 2, 64).astype(np.float32)).to(bf)
    dw1 = TV.vgg_block1_bwd_plain(spect, w1, b1, w2, out, idx, g, bf)[0]
    # dx1 again, unrounded: x1 as the plain forward, g routed by the pool
    x = spect.to(bf)[:, None]
    x1 = torch.relu(Fn.conv2d(x, w1.to(bf).permute(3, 2, 0, 1), padding=1)
                    + b1.to(bf)[None, :, None, None])
    w2c = w2.to(bf).permute(3, 2, 0, 1)
    gm = torch.where(out > 0, g, torch.zeros((), dtype=bf))
    dy2 = pool_bwd_plain(Fn.conv2d(x1, w2c, padding=1),
                         gm.permute(0, 3, 1, 2)).float()
    dx1 = torch.nn.grad.conv2d_input(x1.shape, w2c.float(), dy2, padding=1)
    dx1 = torch.where(x1 > 0, dx1, torch.zeros(()))
    for d, close in ((dx1.to(bf).float(), True), (dx1, False)):
        got = torch.nn.grad.conv2d_weight(x.float(), (64, 1, 3, 3), d,
                                          padding=1).permute(2, 3, 1, 0)
        rel = ((got - dw1).abs().max() / dw1.abs().max()).item()
        assert (rel < 1e-5) if close else (rel > 1e-3), rel


# ---------------------------------------------------------------------------
# the tiling of the bf16 backward kernel (csrc/vgg_block1.cu,
# vgg_block1_bwd_fused_kernel), mirrored here so that its index math is held
# against the plain backward before the card: work items (utterance, conv
# row pair r, 64 columns c0), the input tile (rows 2r-2 .. 2r+3, columns
# c0-2 .. c0+65), the three staged pooled rows (r-1 .. r+1, columns
# c0/2-1 .. c0/2+32, zero outside the pool), the 4 x 66 x1 and dy2 tiles
# (position (i, j) = conv (2r-1+i, c0-1+j), dy2 routed by the parities of
# i+1 and j+1), per-item dW2 / dx1 / mask / db1 / dW1 / db2 over the 2 x 64
# own positions, FUSED_BLOCKS fixed item ranges summed in block order
# ---------------------------------------------------------------------------

FUSED_BLOCKS, CW = 132, 64
PCOLS = CW // 2 + 2           # pooled columns staged per item


def _fused_mirror(spect, w1, b1, w2, out, idx, g, cdt):
    f32 = torch.float32
    B, F, T = spect.shape
    Fp, Tp = F // 2, T // 2
    rows, chunks = (F + 1) // 2, -(-T // CW)
    n = B * rows * chunks
    rnd = lambda t: t.to(cdt).to(f32)
    w1c = rnd(w1).reshape(9, 64)                          # (tap, ci)
    b1c = rnd(b1)
    w2c = rnd(w2).reshape(9, 64, 64)                      # (tap, ci, co)
    gm = torch.where(out.float() > 0, g.float(), torch.zeros(()))
    # zero-padded sources: x by 2 on each side, the pool by one window
    xp = Fn.pad(spect.float(), (2, CW + 2, 2, 4))
    gp = Fn.pad(gm, (0, 0, 1, PCOLS, 1, 2))
    ip = Fn.pad(idx.long(), (0, 0, 1, PCOLS, 1, 2), value=-1)
    ii, jj = torch.arange(4)[:, None], torch.arange(CW + 2)[None, :]
    pr, pc = (ii + 1) // 2, (jj + 1) // 2
    wp = (2 * ((ii + 1) % 2) + (jj + 1) % 2)[..., None]
    total = torch.zeros(9 * 64 + 64 + 9 * 64 * 64 + 64)
    for blk in range(FUSED_BLOCKS):
        lo, hi = n * blk // FUSED_BLOCKS, n * (blk + 1) // FUSED_BLOCKS
        dw1, db1 = torch.zeros(9, 64), torch.zeros(64)
        dw2, db2 = torch.zeros(9, 64, 64), torch.zeros(64)
        for it in range(lo, hi):
            c0, r, b = (it % chunks) * CW, (it // chunks) % rows, \
                it // (chunks * rows)
            xs = rnd(xp[b, 2 * r:2 * r + 6, c0:c0 + CW + 4])      # 6 x 68
            graw = gp[b, r:r + 3, c0 // 2:c0 // 2 + PCOLS]        # 3 x 34 x 64
            iraw = ip[b, r:r + 3, c0 // 2:c0 // 2 + PCOLS]
            dy2 = torch.where(iraw[pr, pc] == wp, graw[pr, pc],
                              torch.zeros(()))                     # 4 x 66 x 64
            y1 = sum(xs[df:df + 4, dt:dt + CW + 2, None] * w1c[3 * df + dt]
                     for df in range(3) for dt in range(3))
            inside = ((2 * r - 1 + ii >= 0) & (2 * r - 1 + ii < F)
                      & (c0 - 1 + jj >= 0) & (c0 - 1 + jj < T))[..., None]
            x1 = torch.where(inside, torch.relu(rnd(rnd(y1) + b1c)),
                             torch.zeros(()))
            own = dy2[1:3, 1:CW + 1].reshape(2 * CW, 64)
            db2 += own.sum(0)
            dx = torch.zeros(2 * CW, 64)
            for tap in range(9):
                df, dt = divmod(tap, 3)
                dw2[tap] += x1[df:df + 2, dt:dt + CW].reshape(-1, 64).T @ own
                dx += (dy2[2 - df:4 - df, 2 - dt:2 - dt + CW].reshape(-1, 64)
                       @ w2c[tap].T)
            dx = torch.where(x1[1:3, 1:CW + 1].reshape(-1, 64) > 0, dx,
                             torch.zeros(()))
            db1 += dx.sum(0)
            cols = torch.stack([xs[df + 1:df + 3, dt + 1:dt + 1 + CW]
                                .reshape(-1) for df in range(3)
                                for dt in range(3)])       # 9 x 128
            dw1 += cols @ rnd(dx)
        total += torch.cat([dw1.reshape(-1), db1, dw2.reshape(-1), db2])
    o1, o2, o3 = 9 * 64, 10 * 64, 10 * 64 + 9 * 64 * 64
    return (total[:o1].view(3, 3, 1, 64), total[o1:o2],
            total[o2:o3].view(3, 3, 64, 64), total[o3:])


@pytest.mark.parametrize("cdt,tol", [(torch.float32, 2e-5),
                                     (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("shape", [(1, 17, 9), (2, 161, 129), (1, 9, 801)])
def test_fused_bwd_tiling_equals_the_plain_backward(shape, cdt, tol):
    """Odd F (the last row pair half outside the image), odd T, T not a
    multiple of the item width, one item row (F = 9 at T = 801), items at
    every border; bf16 at the card's tolerance (a conv1 sum by a rounding
    boundary may round the other way)."""
    B, F, T = shape
    args = [torch.from_numpy(a) for a in _mk(B, F, T, seed=F + T)]
    out, idx = TV.vgg_block1_plain(*args, cdt=cdt)
    g = torch.from_numpy(np.random.RandomState(T).randn(
        B, F // 2, T // 2, 64).astype(np.float32)).to(cdt)
    want = TV.vgg_block1_bwd_plain(*args[:4], out, idx, g, cdt)
    got = _fused_mirror(*args[:4], out, idx, g, cdt)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= tol * b.abs().max()


# ---------------------------------------------------------------------------
# the tiling of the bf16 forward kernel (csrc/vgg_block1.cu,
# vgg_block1_fwd_wgmma_kernel), mirrored here so that its index math is held
# against the plain forward before the card: work items (utterance, pooled
# row pair rp, 31-column chunk) in min(items, 132) fixed block ranges; the
# input tile (rows 4rp-2 .. 4rp+5, columns c0-2 .. c0+63, c0 = 62 chunk);
# the x1 tile of 6 rows x 64 positions (position 64 i + j = conv (4rp-1+i,
# c0-1+j)) and 8 zero pad positions; consumer half c's products, tap (df,
# dt) reading 128 positions of the flat tile from 64 (2c + df) + dt on; the
# pool windows of accumulator columns (n, n+1, n+64, n+65), n even < 62;
# every output written by exactly one item
# ---------------------------------------------------------------------------

FWD_BLOCKS, FWD_COLS = 132, 62


def _fused_fwd_mirror(spect, w1, b1, w2, b2, cdt):
    f32 = torch.float32
    B, F, T = spect.shape
    Fp, Tp = F // 2, T // 2
    rps, chunks = (Fp + 1) // 2, -(-Tp // (FWD_COLS // 2))
    n = B * rps * chunks
    grid = min(n, FWD_BLOCKS)
    rnd = lambda t: t.to(cdt).to(f32)
    w1c, b1c, b2c = rnd(w1).reshape(9, 64), rnd(b1), rnd(b2)
    w2c = rnd(w2).reshape(9, 64, 64)                      # (tap, ci, co)
    # x zero-padded: rows 4rp-2 .. 4rp+5 and columns c0-2 .. c0+63 of any
    # item lie inside
    xp = Fn.pad(rnd(spect.float()), (2, FWD_COLS + 4, 2, 6))
    ii, jj = torch.arange(6)[:, None], torch.arange(64)[None, :]
    n_even = torch.arange(0, FWD_COLS, 2)                 # window columns
    out = torch.zeros(B, Fp, Tp, 64, dtype=cdt)
    idx = torch.zeros(B, Fp, Tp, 64, dtype=torch.uint8)
    written = torch.zeros(B, Fp, Tp, dtype=torch.int32)
    for blk in range(grid):
        for it in range(n * blk // grid, n * (blk + 1) // grid):
            chunk, rp, b = it % chunks, (it // chunks) % rps, \
                it // (chunks * rps)
            c0 = FWD_COLS * chunk
            xs = xp[b, 4 * rp:4 * rp + 8, c0:c0 + 66]          # 8 x 66
            y1 = sum(xs[df:df + 6, dt:dt + 64, None] * w1c[3 * df + dt]
                     for df in range(3) for dt in range(3))
            inside = ((4 * rp - 1 + ii >= 0) & (4 * rp - 1 + ii < F)
                      & (c0 - 1 + jj >= 0) & (c0 - 1 + jj < T))[..., None]
            x1 = torch.where(inside, torch.relu(rnd(rnd(y1) + b1c)),
                             torch.zeros(()))
            x1 = torch.cat([x1.reshape(6 * 64, 64), torch.zeros(8, 64)])
            for c in range(2):
                acc = torch.zeros(128, 64)                    # (n, co)
                for tap in range(9):
                    df, dt = divmod(tap, 3)
                    s = 64 * (2 * c + df) + dt
                    acc += x1[s:s + 128] @ w2c[tap]
                y = rnd(acc)
                cands = (y[n_even], y[n_even + 1], y[n_even + 64],
                         y[n_even + 65])
                best, arg = cands[0], torch.zeros(31, 64, dtype=torch.uint8)
                for m in (1, 2, 3):
                    take = cands[m] > best
                    best = torch.where(take, cands[m], best)
                    arg = torch.where(take, torch.full_like(arg, m), arg)
                o = torch.relu(rnd(best + b2c))
                fp, tp = 2 * rp + c, 31 * chunk + torch.arange(31)
                keep = tp < Tp
                if fp < Fp:
                    out[b, fp, tp[keep]] = o[keep].to(cdt)
                    idx[b, fp, tp[keep]] = arg[keep]
                    written[b, fp, tp[keep]] += 1
    assert bool((written == 1).all())
    return out, idx


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 17, 9), (2, 161, 129), (1, 9, 801),
                                   (1, 3, 4), (4, 32, 250)])
def test_fused_fwd_tiling_equals_the_plain_forward(shape, cdt):
    """Odd F and T, T not a multiple of the 62-column item, one pooled
    row (F = 3), fewer items than blocks ((1, 9, 801): 26 items), more
    items than blocks ((2, 161, 129): 240; (4, 32, 250): 160, where the
    JAX fused kernel runs too). f32 tight; bf16 at the card's tolerance
    (tests/test_torch_gpu.py: one bf16 ulp where a sum rounds the other
    way, a near-tied pool choice may flip)."""
    B, F, T = shape
    args = _mk(B, F, T, seed=F * T)
    t = [torch.from_numpy(a) for a in args]
    out, idx = _fused_fwd_mirror(*t, cdt)
    want, want_idx = TV.vgg_block1_plain(*t, cdt=cdt)
    jdt = jnp.float32 if cdt == torch.float32 else jnp.bfloat16
    c_out = np.asarray(composite(*[jnp.asarray(a) for a in args],
                                 jdt).astype(jnp.float32))
    got = out.float().numpy()
    assert got.shape == c_out.shape == (B, F // 2, T // 2, 64)
    if cdt == torch.float32:
        np.testing.assert_allclose(got, want.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(got, c_out, rtol=F32_TOL, atol=F32_TOL)
        assert (idx == want_idx).float().mean().item() > 0.999
    else:
        w = want.float()
        assert bool(((out.float() - w).abs()
                     <= 2 ** -6 + 2 ** -6 * w.abs()).all())
        np.testing.assert_allclose(got, c_out, rtol=BF16_TOL, atol=BF16_TOL)
        assert (idx == want_idx).float().mean().item() > 0.99
    if T % 2 == 0 and F >= 8:           # the JAX fused kernel's domain
        f_out, f_idx = _jax_fused(args, jdt)
        tol = F32_TOL if cdt == torch.float32 else BF16_TOL
        np.testing.assert_allclose(got, f_out, rtol=tol, atol=tol)
        assert (idx.numpy() == f_idx).mean() > (
            0.999 if cdt == torch.float32 else 0.97)


def test_fwd_probe_cuts_apply_to_the_source():
    """tools/probe_vgg_fwd.py times the forward kernel's parts by cutting
    lines out of csrc/vgg_block1.cu: each cut must find its lines, and the
    copies must differ from the source and from each other."""
    import os
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.tools import probe_vgg_fwd as PF
    with open(os.path.join(cuda_lib.CSRC_DIR, PF.SOURCE)) as f:
        src = f.read()
    copies = {name: PF.cut(src, name) for name in PF.CUTS}
    assert src not in copies.values()
    assert len(set(copies.values())) == len(PF.CUTS)
    assert set(PF.CHAIN) <= set(PF.CUTS)
