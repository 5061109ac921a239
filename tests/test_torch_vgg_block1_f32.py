"""The f32 block-1 kernels' decomposition (csrc/vgg_block1_f32.cu), mirrored
in torch on the CPU and held against the plain forward and backward
(end2end_asr_tpu_torch.ops.vgg_fused.vgg_block1_plain / _bwd_plain) and the
JAX package's fused kernel (its Pallas forward and backward in interpret
mode) before the card sees it.

What the mirror models, as the kernels do it:
  * the conv tiles (8 conv rows x 32 columns x 64 channels): the forward's
    over the 2 Fp x 2 Tp positions the pool keeps, dx1's over all F x T;
    each reads its 9 taps as offsets into a halo tile (the transposed
    convolution at -s(tap)), K in chunks of 16 channels; tiles past the
    image's last row or column compute and drop those positions;
  * x1 zero outside the image (the forward's halo tile, wgrad's staged x1),
    so conv2's border reads zero and not relu(b1);
  * the pool epilogue through the threads' places: a thread's 8 positions
    (its warp's row pair at columns 2g, 2g+1, 2g+8, 2g+9 of the warp's 16)
    hold whole windows, the first maximum in (f, t) order wins;
  * dy2 formed where a tile or segment is staged, from g, out and idx at
    the pooled positions under it (dx1: 6 x 18 under a tile's halo, a conv
    position at local pooled row (r + 1) / 2, window row (r + 1) % 2;
    wgrad: 8 along a pooled row), zero where the pool drops a row or
    column; dx1 masked by the recomputed x1 > 0 and zero outside the
    image, row F-1 of an odd F included; dW1 and db1 summed a tile at a
    time over SPLITS fixed ranges of tiles; dW2 and db2 over SPLITS fixed
    ranges of K segments (2 conv rows x 16 columns, x1 rebuilt at 4 x 18
    positions from the 6 x 20 inputs under them); the ranges' partial sums
    added in range order.
Mutations that the comparison must catch: a shifted tap, an x1 border that
leaks relu(b1), a dropped range, dx1's last row dropped at odd F, and a
window element taken from the wrong row parity at staging.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from end2end_asr_tpu.ops.vgg_fused import _block1_fwd
from end2end_asr_tpu.ops.vgg_fused import vgg_block1 as jax_vgg_block1
from end2end_asr_tpu_torch.ops import cuda_lib
from end2end_asr_tpu_torch.ops import vgg_fused as TV
from end2end_asr_tpu_torch.tools import probe_lib

# the kernels' tiling, read from csrc/vgg_block1_f32.cu as the probes read it
SOURCE = os.path.join(cuda_lib.CSRC_DIR, "vgg_block1_f32.cu")
K = probe_lib.constexprs(SOURCE)
C, CSLOT, WM, WC, KC, SPLITS, SEG = (K[n] for n in (
    "C", "CSLOT", "WM", "WC", "KC", "SPLITS", "SEG"))
TR, TC, RED, PART = K["TR"], K["TC"], K["RED"], K["PART"]
AR, AC = K["AR"], K["AC"]
# f32 sums in another order, relative to each tensor's largest value (the
# weight gradients sum over B F T positions: ~1e-6 relative)
F32_TOL = 2e-5

# (1, 17, 70): odd F (dx1's third row tile holds row 16 alone), 70 columns
# in tiles of 32, 32 and 6; (2, 9, 40): F = 9, a forward row tile of 8 and
# dx1's of 8 and 1; (1, 10, 37): odd T, the forward's second row tile of 2
# rows. The JAX fused kernel takes even T and F // 2 a multiple of 4
SHAPES = [(1, 17, 70), (2, 9, 40), (1, 10, 37)]
JAX_SHAPES = SHAPES[:2]


def _mk(B, F, T, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, F, T).astype(np.float32),
            (rng.randn(3, 3, 1, 64) * 0.2).astype(np.float32),
            (rng.randn(64) * 0.1).astype(np.float32),
            (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32),
            (rng.randn(64) * 0.1).astype(np.float32))


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return ((a - b.reshape(a.shape)).abs().max()
            / b.abs().max().clamp_min(1e-30)).item()


def _jax_fused(args):
    """The JAX fused forward (Pallas, interpret mode): out, idx."""
    out, (_, idx) = _block1_fwd(*[jnp.asarray(a) for a in args], jnp.float32)
    return (np.array(out), np.transpose(np.array(idx), (0, 1, 3, 2)))


# ---------------------------------------------------------------------------
# the threads' places (place, prow, pcol, pch)
# ---------------------------------------------------------------------------

def conv_places():
    """[(rows, cols, channels)] of the 256 threads of a conv tile: position
    i at (rows[i], cols[i]) of the tile (8 of them), channel j (8)."""
    out = []
    for warp in range(WM * WC):
        for lane in range(32):
            wm, wc, g, c = warp % WM, warp // WM, lane & 3, lane >> 2
            out.append(([2 * wm + i // CSLOT for i in range(2 * CSLOT)],
                        [16 * wc + 2 * g + (i % CSLOT & 1)
                         + 8 * (i % CSLOT >> 1) for i in range(2 * CSLOT)],
                        [4 * c + (j & 3) + 32 * (j >> 2) for j in range(8)]))
    return out


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------

def conv1(x, w1, b1):
    """x1 = relu(conv1(x) + b1) at every image position (B, F, T, 64): the
    9 taps summed from 0 in (df, dt) order, x zero outside the image."""
    B, F, T = x.shape
    xp = Fn.pad(x, (1, 1, 1, 1))
    acc = torch.zeros(B, F, T, C)
    for df in range(3):
        for dt in range(3):
            acc = acc + xp[:, df:df + F, dt:dt + T, None] * w1[df, dt, 0]
    return torch.relu(acc + b1)


def halo_of(a, nf, nt, pad=None):
    """a (B, Fa, Ta, K) at rows -1 .. nf TR, columns -1 .. nt TC: zero
    outside a (`pad` per channel there: the mutation's value)."""
    B, Fa, Ta, K = a.shape
    H, W = nf * TR + 2, nt * TC + 2
    h = Fn.pad(a, (0, 0, 1, max(0, W - 1 - Ta), 1, max(0, H - 1 - Fa)))
    h = h[:, :H, :W]
    if pad is not None:
        inside = torch.zeros(H, W, dtype=torch.bool)
        inside[1:Fa + 1, 1:Ta + 1] = True
        h = torch.where(inside[None, :, :, None], h, pad)
    return h


def conv_tiles(a, w, nf, nt, flip=False, pad=None, mutate=None, halo=None):
    """The conv tiles over (utterance, nf row tiles, nt column tiles): a
    (B, Fa, Ta, 64), w (9, 64 k, 64 n); each tile sums, chunk by chunk of
    KC channels, the 9 taps read at their offsets into its halo tile (a's,
    or halo(f0, t0)'s: a tile's (B, TR + 2, TC + 2, 64) as it is staged).
    Returns (B, nf TR, nt TC, 64), past the image too."""
    if halo is None:
        h = halo_of(a, nf, nt, pad)
        B = a.shape[0]
    else:
        B = halo(0, 0).shape[0]
    out = torch.empty(B, nf * TR, nt * TC, C)
    for fb in range(nf):
        for tb in range(nt):
            f0, t0 = fb * TR, tb * TC
            tile = (h[:, f0:f0 + TR + 2, t0:t0 + TC + 2] if halo is None
                    else halo(f0, t0))
            acc = torch.zeros(B, TR, TC, C)
            for c in range(C // KC):
                ks = slice(KC * c, KC * c + KC)
                for df in range(3):
                    for dt in range(3):
                        sf, st = (2 - df, 2 - dt) if flip else (df, dt)
                        if mutate == "tap" and (df, dt) == (1, 2):
                            st = 1 if st != 1 else 0
                        acc += tile[:, sf:sf + TR, st:st + TC, ks] @ \
                            w[3 * df + dt, ks]
            out[:, f0:f0 + TR, t0:t0 + TC] = acc
    return out


def pool_epilogue(y, b2, F, T):
    """The forward's epilogue on its tiles' sums y (B, nf TR, nt TC, 64),
    through the threads' places: out (B, F/2, T/2, 64), idx."""
    B, Fy, Ty, _ = y.shape
    nf, nt = Fy // TR, Ty // TC
    tiles = y.reshape(B, nf, TR, nt, TC, C).permute(0, 1, 3, 2, 4, 5)
    pl = conv_places()
    R = torch.tensor([p[0] for p in pl])[:, :, None]     # (threads, NP, 1)
    Cc = torch.tensor([p[1] for p in pl])[:, :, None]
    Ch = torch.tensor([p[2] for p in pl])[:, None, :]    # (threads, 1, 8)
    vals = tiles[:, :, :, R, Cc, Ch]        # (B, nf, nt, threads, NP, 8)
    out = torch.full((B, nf * TR // 2, nt * TC // 2, C), float("nan"))
    idx = torch.full(out.shape, 9, dtype=torch.uint8)
    pr = (torch.arange(nf)[:, None, None] * (TR // 2)
          + R[None, None, :, 0, 0] // 2)
    for wdw in range(CSLOT // 2):
        # window order (0,0), (0,1), (1,0), (1,1): positions e, e+1,
        # e+CSLOT, e+CSLOT+1 of the thread, e = 2 wdw
        e0 = 2 * wdw
        elems = [e0, e0 + 1, e0 + CSLOT, e0 + CSLOT + 1]
        best = vals[..., elems[0], :].clone()
        arg = torch.zeros(best.shape, dtype=torch.uint8)
        for k, e in enumerate(elems[1:], 1):
            v = vals[..., e, :]
            arg = torch.where(v > best, torch.full_like(arg, k), arg)
            best = torch.where(v > best, v, best)
        pc = (torch.arange(nt)[None, :, None] * (TC // 2)
              + Cc[None, None, :, 0, 0] // 2 + 4 * wdw)
        prb, pcb = torch.broadcast_tensors(pr, pc)     # (nf, nt, threads)
        ch = Ch[:, 0, :]                               # (threads, 8)
        out[:, prb[..., None], pcb[..., None], ch] = torch.relu(best + b2[ch])
        idx[:, prb[..., None], pcb[..., None], ch] = arg
    return out[:, :F // 2, :T // 2], idx[:, :F // 2, :T // 2]


def mirror_fwd(x, w1, b1, w2, b2, mutate=None):
    B, F, T = x.shape
    nf, nt = -(-(F // 2 * 2) // TR), -(-(T // 2 * 2) // TC)
    pad = torch.relu(b1) if mutate == "border" else None
    y = conv_tiles(conv1(x, w1, b1), w2.reshape(9, C, C), nf, nt, pad=pad,
                   mutate=mutate)
    return pool_epilogue(y, b2, F, T)


def route_dy2(g, out, idx):
    """dy2 (B, 2 Fp, 2 Tp, 64) as a whole: g where out > 0, at the window
    element idx names, zero at the other three (what the staged dy2 must
    equal)."""
    B, Fp, Tp, _ = g.shape
    gm = torch.where(out > 0, g, torch.zeros(()))
    dy2 = torch.empty(B, 2 * Fp, 2 * Tp, C)
    for w in range(4):
        dy2[:, w >> 1::2, w & 1::2] = torch.where(idx == w, gm,
                                                  torch.zeros(()))
    return dy2


def pooled_block(g, out, idx, pr0, nr, pc0, nc):
    """g, out and idx at pooled rows pr0 .. pr0+nr-1, columns pc0 ..
    pc0+nc-1, zero outside the pool's Fp x Tp (the kernels' zero-filled
    copies)."""
    B, Fp, Tp, _ = g.shape
    blocks = []
    for t in (g, out, idx.to(torch.int64)):
        z = torch.zeros(B, nr, nc, C, dtype=t.dtype)
        r0, r1 = max(pr0, 0), min(pr0 + nr, Fp)
        c0, c1 = max(pc0, 0), min(pc0 + nc, Tp)
        if r0 < r1 and c0 < c1:
            z[:, r0 - pr0:r1 - pr0, c0 - pc0:c1 - pc0] = t[:, r0:r1, c0:c1]
        blocks.append(z)
    return blocks


def staged_route(blocks, prow, pcol, wdw):
    """dy2 at positions whose pooled values are blocks[.][:, prow, pcol]
    and whose window element is wdw (index tensors of one shape): g where
    out > 0 and idx == wdw, else 0."""
    gb, ob, ib = (b[:, prow, pcol] for b in blocks)
    keep = (ib == wdw[None, ..., None]) & (ob > 0)
    return torch.where(keep, gb, torch.zeros(()))


def dx1_staged_dy2(g, out, idx, f0, t0, mutate=None):
    """dx1's step: dy2 at its tile's halo (B, TR + 2, TC + 2, 64), built from
    the pooled rows f0/2 - 1 .. f0/2 + TR/2 and columns t0/2 - 1 .. t0/2 +
    TC/2 under it: halo row r (conv row f0 - 1 + r) at local pooled row
    (r + 1) // 2, window row (r + 1) % 2, and so for columns (`mutate`
    "parity": the window row r % 2)."""
    blocks = pooled_block(g, out, idx, f0 // 2 - 1, TR // 2 + 2,
                          t0 // 2 - 1, TC // 2 + 2)
    r = torch.arange(TR + 2)[:, None] + 1
    j = torch.arange(TC + 2)[None, :] + 1
    wrow = (r - 1) % 2 if mutate == "parity" else r % 2
    return staged_route(blocks, (r // 2).expand(-1, TC + 2),
                        (j // 2).expand(TR + 2, -1), 2 * wrow + j % 2)


def wgrad_staged_dy2(g, out, idx, b, pr, tc):
    """wgrad's segment: dy2 at conv rows 2 pr, 2 pr + 1 and columns SEG tc
    .. +SEG-1 (1, 2, SEG, 64), from pooled row pr, columns SEG/2 tc ..
    +SEG/2-1: position (r, j) at pooled column j // 2, window element 2 r +
    j % 2."""
    blocks = pooled_block(g[b:b + 1], out[b:b + 1], idx[b:b + 1], pr, 1,
                          SEG // 2 * tc, SEG // 2)
    r = torch.arange(2)[:, None].expand(-1, SEG)
    j = torch.arange(SEG)[None, :].expand(2, -1)
    return staged_route(blocks, torch.zeros_like(r), j // 2, 2 * r + j % 2)


def _ranges(n):
    return [(n * sp // SPLITS, n * (sp + 1) // SPLITS) for sp in range(SPLITS)]


def _dropped(n, mutate):
    """The range the "split" mutation leaves out: the one that holds item
    n // 2."""
    if mutate != "split":
        return None
    return next(sp for sp, (lo, hi) in enumerate(_ranges(n)) if lo <= n // 2
                < hi)


def dx1_sums(x, w1, b1, w2, g, out, idx, mutate=None):
    """vgg_block1_bwd_dx1_f32_kernel: dx1 over the tiles of all F rows, each
    tile's dy2 formed at staging, masked by the recomputed x1; (SPLITS,
    RED) partial sums of dW1 (tap, ci) and db1, a range's tiles in
    order."""
    B, F, T = x.shape
    rows = F // 2 * 2 if mutate == "last_row" else F
    nf, nt = -(-rows // TR), -(-T // TC)
    w2t = w2.permute(0, 1, 3, 2).reshape(9, C, C)            # (tap, co, ci)
    d = conv_tiles(None, w2t, nf, nt, flip=True,
                   mutate=mutate if mutate == "tap" else None,
                   halo=lambda f0, t0: dx1_staged_dy2(g, out, idx, f0, t0,
                                                      mutate))
    x1 = conv1(x, w1, b1)
    x1t = Fn.pad(x1, (0, 0, 0, nt * TC - T, 0, max(0, nf * TR - F)))
    x1t = x1t[:, :nf * TR]
    inside = torch.zeros(nf * TR, nt * TC, dtype=torch.bool)
    inside[:F, :T] = True
    dx1 = torch.where(inside[None, :, :, None] & (x1t > 0), d, torch.zeros(()))
    xp = Fn.pad(x, (1, nt * TC + 1 - T, 1, max(1, nf * TR + 1 - F)))
    ntiles = B * nf * nt
    drop = _dropped(ntiles, mutate)
    part = torch.zeros(SPLITS, RED)
    for sp, (lo, hi) in enumerate(_ranges(ntiles)):
        for it in range(lo, hi):
            b, fb, tb = it // nt // nf, it // nt % nf, it % nt
            f0, t0 = fb * TR, tb * TC
            dt_ = dx1[b, f0:f0 + TR, t0:t0 + TC]               # (TR, TC, 64)
            s = torch.empty(RED)
            for tap in range(9):
                df, dt = divmod(tap, 3)
                xs = xp[b, f0 + df:f0 + df + TR, t0 + dt:t0 + dt + TC]
                s[tap * C:(tap + 1) * C] = (xs[..., None] * dt_).sum((0, 1))
            s[9 * C:] = dt_.sum((0, 1))
            if sp != drop:
                part[sp] += s
    return part


def segment_x1(x, w1, b1, b, pr, tc, pad=None):
    """wgrad's segment: x1 at conv rows 2 pr - 1 .. 2 pr + 2, columns SEG tc
    - 1 .. SEG tc + SEG (AR x AC), rebuilt from x at the 6 x 20 positions
    under them (zero outside the image), zero outside the image (`pad`:
    that value there, the "border" mutation)."""
    _, F, T = x.shape
    f0, t0 = 2 * pr - 2, SEG * tc - 2
    xs = torch.zeros(1, AR + 2, AC + 2)
    r0, r1, c0, c1 = max(f0, 0), min(f0 + AR + 2, F), max(t0, 0), min(
        t0 + AC + 2, T)
    xs[:, r0 - f0:r1 - f0, c0 - t0:c1 - t0] = x[b:b + 1, r0:r1, c0:c1]
    x1 = conv1(xs, w1, b1)[:, 1:-1, 1:-1]               # (1, AR, AC, 64)
    f = torch.arange(AR)[:, None] + f0 + 1
    t = torch.arange(AC)[None, :] + t0 + 1
    inside = ((f >= 0) & (f < F) & (t >= 0) & (t < T))[None, :, :, None]
    return torch.where(inside, x1, torch.zeros(()) if pad is None else pad)


def wgrad_sums(x, w1, b1, g, out, idx, mutate=None):
    """vgg_block1_bwd_wgrad_f32_kernel: (SPLITS, 9 C C + C) partial sums of
    dW2 (tap, ci, co) and db2 over fixed ranges of K segments (b, pooled
    row, 16 columns; the columns fastest), each segment's x1 rebuilt with
    zero outside the image (`mutate` "border": relu(b1)) and its dy2 formed
    at staging."""
    B, F, T = x.shape
    Fp, tch = F // 2, -(-(T // 2 * 2) // SEG)
    pad = torch.relu(b1) if mutate == "border" else None
    nseg = B * Fp * tch
    drop = _dropped(nseg, mutate)
    part = torch.zeros(SPLITS, 9 * C * C + C)
    for sp, (lo, hi) in enumerate(_ranges(nseg)):
        if sp == drop:
            continue
        acc = torch.zeros(9, C, C)
        for e in range(lo, hi):
            tc, pr, b = e % tch, e // tch % Fp, e // tch // Fp
            x1 = segment_x1(x, w1, b1, b, pr, tc, pad)[0]
            Bm = wgrad_staged_dy2(g, out, idx, b, pr, tc).reshape(-1, C)
            for tap in range(9):
                df, dt = divmod(tap, 3)
                A = x1[df:df + 2, dt:dt + SEG].reshape(-1, C)
                acc[tap] += A.T @ Bm
            part[sp, 9 * C * C:] += Bm.sum(0)
        part[sp, :9 * C * C] = acc.reshape(-1)
    return part


def mirror_bwd(x, w1, b1, w2, out, idx, g, mutate=None):
    p1 = dx1_sums(x, w1, b1, w2, g, out, idx, mutate)
    p2 = wgrad_sums(x, w1, b1, g, out, idx, mutate)
    part = torch.cat([p1, p2], 1)                              # (SPLITS, PART)
    grads = part[0].clone()
    for sp in range(1, SPLITS):
        grads += part[sp]
    o1, o2, o3 = 9 * C, RED, RED + 9 * C * C
    return (grads[:o1].view(3, 3, 1, C), grads[o1:o2],
            grads[o2:o3].view(3, 3, C, C), grads[o3:])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_forward_decomposition_equals_the_plain_forward(shape):
    args = _mk(*shape, seed=sum(shape))
    x, w1, b1, w2, b2 = _torch(args)
    out, idx = mirror_fwd(x, w1, b1, w2, b2)
    want, want_idx = TV.vgg_block1_plain(x, w1, b1, w2, b2, torch.float32)
    assert out.shape == want.shape and not out.isnan().any()
    assert _rel(out, want) < F32_TOL
    assert (idx == want_idx).float().mean() > 0.999
    if shape in JAX_SHAPES:
        f_out, f_idx = _jax_fused(args)
        assert _rel(out, f_out) < F32_TOL
        assert (idx.numpy() == f_idx).mean() > 0.999


def _bwd_case(shape, seed):
    args = _mk(*shape, seed=seed)
    x, w1, b1, w2, b2 = _torch(args)
    out, idx = TV.vgg_block1_plain(x, w1, b1, w2, b2, torch.float32)
    g = np.random.RandomState(seed + 1).randn(*out.shape).astype(np.float32)
    want = TV.vgg_block1_bwd_plain(x, w1, b1, w2, out, idx,
                                   torch.from_numpy(g), torch.float32)
    return args, (x, w1, b1, w2, out, idx, torch.from_numpy(g)), want, g


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_backward_decomposition_equals_the_plain_backward(shape):
    args, targs, want, g = _bwd_case(shape, seed=2 * sum(shape))
    got = mirror_bwd(*targs)
    for name, a, b in zip(("dw1", "db1", "dw2", "db2"), got, want):
        assert a.shape == b.shape and not a.isnan().any(), name
        assert _rel(a, b) < F32_TOL, name
    if shape in JAX_SHAPES:
        # jax.grad of the JAX package's fused block (its Pallas backward in
        # interpret mode, on its own forward's argmax)
        _, vjp = jax.vjp(lambda *w: jax_vgg_block1(jnp.asarray(args[0]), *w,
                                                   jnp.float32),
                         *[jnp.asarray(a) for a in args[1:]])
        jw = vjp(jnp.asarray(g))
        for name, a, b in zip(("dw1", "db1", "dw2", "db2"), got, jw):
            assert _rel(a, np.asarray(b)) < F32_TOL, name


@pytest.mark.parametrize("mutate", ["tap", "border", "split", "last_row",
                                    "parity"])
def test_f32_mirror_catches_each_mutation(mutate):
    """A tap read one column off, x1 outside the image at relu(b1) instead
    of zero (conv2 in the forward, dW2 in the backward), one range's
    partial sums left out, dx1's tiles over the 2 Fp rows the pool keeps
    instead of all F (row F-1 of an odd F then gives dW1 and db1 nothing),
    and dx1's dy2 staged with the window row of the wrong parity each put
    the mirror far outside the tolerance."""
    shape = (1, 17, 70)
    args, targs, want, _ = _bwd_case(shape, seed=2 * sum(shape))
    got = mirror_bwd(*targs, mutate=mutate)
    assert max(_rel(a, b) for a, b in zip(got, want)) > 100 * F32_TOL
    if mutate in ("tap", "border"):
        x, w1, b1, w2, b2 = _torch(_mk(*shape, seed=sum(shape)))
        out, _ = mirror_fwd(x, w1, b1, w2, b2, mutate=mutate)
        want_out, _ = TV.vgg_block1_plain(x, w1, b1, w2, b2, torch.float32)
        assert _rel(out, want_out) > 100 * F32_TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_dy2_formed_at_staging_equals_the_routed_dy2(shape):
    """dx1's tiles and wgrad's segments form dy2 from the pooled g, out and
    idx under them: at every halo position of every tile and every
    position of every segment it equals the whole routed dy2, zero past the
    2 Fp x 2 Tp the pool keeps (an odd last row or column, the halo around
    the image)."""
    targs = _bwd_case(shape, seed=3 * sum(shape))[1]
    _, F, T = targs[0].shape
    out, idx, g = targs[4:]
    dy2 = route_dy2(g, out, idx)
    nf, nt = -(-F // TR), -(-T // TC)
    h = halo_of(dy2, nf, nt)
    assert bool(dy2.ne(0).any())
    for fb in range(nf):
        for tb in range(nt):
            f0, t0 = fb * TR, tb * TC
            assert torch.equal(dx1_staged_dy2(g, out, idx, f0, t0),
                               h[:, f0:f0 + TR + 2, t0:t0 + TC + 2])
    tch = -(-(T // 2 * 2) // SEG)
    dyp = Fn.pad(dy2, (0, 0, 0, tch * SEG - T // 2 * 2))
    for b in range(g.shape[0]):
        for pr in range(F // 2):
            for tc in range(tch):
                assert torch.equal(
                    wgrad_staged_dy2(g, out, idx, b, pr, tc)[0],
                    dyp[b, 2 * pr:2 * pr + 2, SEG * tc:SEG * tc + SEG])


def test_f32_tile_places_cover_every_pooled_output_once_in_whole_windows():
    """Each (position, channel) of a conv tile belongs to one thread; a
    thread's 8 positions are 2 whole pool windows, so the forward's tiles
    (whole windows each: 8 rows and 32 columns are even) write every pooled
    output of the grid once; the four positions an A load instruction reads
    (lane % 4) sit in distinct banks of the x1 tile (XP = 68 floats a
    position) and of dx1's staged chunk (PA = 20), and the eight channel
    float4s of a B load (lane / 4) fill the 32 banks once."""
    seen = torch.zeros(TR, TC, C, dtype=torch.int64)
    places = conv_places()
    pooled = torch.zeros(TR // 2, TC // 2, C, dtype=torch.int64)
    for rows, cols, chans in places:
        for r, c in zip(rows, cols):
            seen[r, c, chans] += 1
        for w in range(CSLOT // 2):
            e = [2 * w + k for k in (0, 1, CSLOT, CSLOT + 1)]
            win = [(rows[i], cols[i]) for i in e]
            r0, c0 = win[0]
            assert r0 % 2 == 0 and c0 % 2 == 0
            assert win == [(r0, c0), (r0, c0 + 1), (r0 + 1, c0),
                           (r0 + 1, c0 + 1)]
            pooled[r0 // 2, c0 // 2, chans] += 1
    assert bool((seen == 1).all()) and bool((pooled == 1).all())
    HC = TC + 2
    for pitch in (C + 4, KC + 4):
        for warp in range(WM * WC):
            lanes = places[32 * warp:32 * warp + 32]
            for i in range(2 * CSLOT):
                banks = set()
                for g in range(4):
                    rows, cols, _ = lanes[g]
                    word = (rows[i] * HC + cols[i]) * pitch
                    banks |= {(word + k) % 32 for k in range(4)}
                assert len(banks) == 16
    chunks = {places[4 * c][2][0] for c in range(8)}
    assert {(ch + k) % 32 for ch in chunks for k in range(4)} == set(
        range(32))
    # the grid of forward tiles at the shapes above: every pooled output
    # of the image once, and no window straddles a tile
    for B, F, T in SHAPES:
        nf, nt = -(-(F // 2 * 2) // TR), -(-(T // 2 * 2) // TC)
        y = torch.arange(nf * TR * nt * TC * C, dtype=torch.float64).reshape(
            1, nf * TR, nt * TC, C)
        out, idx = pool_epilogue(y.float(), torch.zeros(C), F, T)
        assert out.shape == (1, F // 2, T // 2, C)
        assert not out.isnan().any() and bool((idx == 3).all())


def test_f32_ranges_cover_every_tile_and_segment_once():
    """The SPLITS ranges cut dx1's tiles and wgrad's K segments into
    contiguous pieces whatever their count (fewer items than ranges too),
    and a range's dx1 sums (RED floats) and wgrad sums fill PART once."""
    for n in (1, 60, 131, 132, 133, 6300, 48000):
        r = _ranges(n)
        assert r[0][0] == 0 and r[-1][1] == n
        assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(r, r[1:]))
    assert RED + 9 * C * C + C == PART == TV.PART
    # the dx1 tiles of the main path's shape, F = 161 rows in 21 row tiles
    assert -(-161 // TR) == 21 and -(-800 // TC) == 25


def _source():
    with open(SOURCE) as f:
        return f.read()


def test_constants_match_the_source():
    """The source's tiling is the one the mirror's thread places model (8
    warps, a warp's row pair and 16 columns, 4 column slots a lane), its
    partial sums are the wrapper's, the wrapper allocates SPLITS rows of
    them and the scratch the entry cuts, and every kernel of an entry
    carries the prefix the timers sum by."""
    src = _source()
    assert (C, CSLOT, WM, WC, K["NTH"], K["NP"]) == (64, 4, 4, 2, 256, 8)
    assert (TR, TC) == (2 * WM, 4 * CSLOT * WC) == (8, 32)
    assert C % KC == 0 and TC % SEG == 0 and SEG % 2 == 0
    # dx1 stages the pooled positions under a tile's halo, wgrad those
    # under a segment and the inputs under its x1
    assert (K["PR_R"], K["PR_C"]) == (TR // 2 + 2, TC // 2 + 2)
    assert (AR, AC, K["WXR"], K["WXC"], K["WP"]) == (
        4, SEG + 2, AR + 2, AC + 2, SEG // 2)
    assert RED == 9 * C + C and PART == TV.PART
    assert TV.BWD_BLOCKS[torch.float32] == SPLITS
    B, F, T = 2, 17, 71
    assert TV.bwd_scratch(torch.float32, B, F, T) == SPLITS * PART + 9 * C * C
    assert TV.bwd_scratch(torch.bfloat16, B, F, T) == 132 * PART
    names = re.findall(r"__global__ void[^\n]*\n(\w+)\(", src)
    assert names == ["vgg_block1_fwd_f32_kernel",
                     "vgg_block1_bwd_dx1_f32_kernel",
                     "vgg_block1_bwd_wgrad_f32_kernel",
                     "vgg_block1_bwd_reduce_f32_kernel"]


def _c_args(src, entry):
    """The ctypes types of an extern "C" entry's parameters in `src`."""
    sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src).group(1)
    return [cuda_lib.P if "*" in p else cuda_lib.I for p in sig.split(",")]


def test_f32_bindings_and_probes_match_the_entries():
    """The f32 entries live in csrc/vgg_block1_f32.cu with the argument
    lists of the bf16 ones (csrc/vgg_block1.cu, which keeps no f32 entry),
    so the probes call an earlier commit's vgg_block1.cu f32 entry beside
    them with the same arguments."""
    from end2end_asr_tpu_torch.tools import probe_vgg_bwd as PB
    from end2end_asr_tpu_torch.tools import probe_vgg_fwd as PF
    src = _source()
    with open(os.path.join(cuda_lib.CSRC_DIR, "vgg_block1.cu")) as f:
        bf16 = f.read()
    for kernels, entry in ((TV._KERNELS, "vgg_block1_fwd"),
                           (TV._BWD_KERNELS, "vgg_block1_bwd")):
        k = kernels[torch.float32]
        assert k.source == "vgg_block1_f32" and k.symbol == entry + "_f32"
        assert k.argtypes == _c_args(src, entry + "_f32")
        assert kernels[torch.bfloat16].source == "vgg_block1"
        assert kernels[torch.bfloat16].argtypes == _c_args(bf16,
                                                           entry + "_bf16")
        assert entry + "_f32" not in bf16
    assert PF.SOURCES == PB.SOURCES == {"bfloat16": "vgg_block1.cu",
                                        "float32": "vgg_block1_f32.cu"}
    # the probes count the executed products on the source's tiles
    nf, nt = -(-160 // TR), -(-800 // TC)
    assert PF.f32_gflop(12, 161, 800) == pytest.approx(2 * 12 * nf * nt * (
        TR * TC * 64 * 576 + (TR + 2) * (TC + 2) * 64 * 9) / 1e9)
    nseg = 80 * -(-800 // SEG)
    assert PB.f32_gflop(12, 161, 800) == pytest.approx(2 * 12 * (
        -(-161 // TR) * nt * TR * TC * 64 * 594
        + nseg * (2 * SEG * 576 + AR * AC * 9) * 64) / 1e9)


def test_f32_probe_variants_apply_to_the_source():
    """tools/probe_vgg_bwd.py --variants edits csrc/vgg_block1_f32.cu one
    part at a time: each edit must find its lines once, each copy differs
    from the source and from the others, and a changed source breaks the
    probe loudly."""
    from end2end_asr_tpu_torch.tools import probe_vgg_bwd as PB
    src = _source()
    copies = PB.f32_variants(src, PB.F32_VARIANTS)
    assert list(copies) == list(PB.F32_VARIANTS)
    assert len({src, *copies.values()}) == len(copies) + 1
    with pytest.raises(RuntimeError, match="update the probe"):
        PB.f32_variants(src.replace("lds4(bp + (q * SEG + j) * C)",
                                    "lds4(bp + (j + q * SEG) * C)"),
                        ["wgrad_no_b_loads"])
