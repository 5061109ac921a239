"""The f32 block-2 kernels' decomposition (csrc/vgg_block2_f32.cu), mirrored
in torch on the CPU and held against the plain forward and backward
(end2end_asr_tpu_torch.ops.vgg_fused.vgg_block2_plain / _bwd_plain) before
the card sees it.

What the mirror models, as the kernels do it:
  * the convolutions' block tiles (8 conv rows x TC columns; 16 x TC for
    dx), each staging its positions with a one-position halo, zero outside
    the image, and reading a tap as an offset into that halo tile (the
    transposed convolutions at -s(tap)); tiles past the image's last row or
    column compute and drop those positions;
  * x2 written only inside the image, so conv4's border reads zero and not
    relu(0 + b3);
  * the pool epilogue through the threads' places: a thread's 2 CSLOT
    positions (its warp's row pair at columns 2g, 2g+1, 2g+8, 2g+9, ...)
    hold whole windows, the first maximum in (f, t) order wins;
  * dy4 routed by idx in one pass; dy3 = dx2 masked by the recomputed x2;
  * the weight gradients over the fixed SPLITS ranges of K segments (16
    columns of one conv row, two a stage), 14 tiles a range (dW4 one tap,
    dW3 two taps, the last tile's second half idle; db4 and db3 in the tiles
    of tap 4), the ranges' partial sums added in range order.
Mutations that the comparison must catch: a shifted tap, a border that
leaks relu(b3) into conv4 and dW4, and a dropped K range.
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from end2end_asr_tpu_torch.ops import cuda_lib
from end2end_asr_tpu_torch.ops import vgg_fused as TV

# the kernels' tiling (csrc/vgg_block2_f32.cu; test_constants_match_the_source):
# a conv thread owns CSLOT columns of its warp's two rows; 4 CSLOT-column
# conv tiles staged 16 input channels a chunk
CSLOT, SEG, SPLITS, KC = 4, 16, 132, 16
TC = 4 * CSLOT
KP = 2 * SEG
WG_TILES = 14
DW3_SIZE, DW4_SIZE = 9 * 64 * 128, 9 * 128 * 128
PART2 = DW3_SIZE + 128 + DW4_SIZE + 128
# f32 sums in another order, relative to each tensor's largest value
F32_TOL = 1e-5
# the pool argmax must match wherever the two best window values lie
# further apart than this, relative to max(|best|, 1)
IDX_GAP = 1e-4

# T not a multiple of the column tile or of the 16-column segment; F = 4 (the least supported2
# takes) and F = 10 not multiples of the 8- and 16-row tiles; fewer K
# segments than ranges (60) and more (416)
SHAPES = [(1, 4, 70), (2, 10, 34), (2, 16, 200)]


def _mk(B, F, T, seed):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    return (t(rng.randn(B, F, T, 64)).relu(),
            t(rng.randn(3, 3, 64, 128) * (2 / 576) ** 0.5),
            t(rng.randn(128) * 0.1),
            t(rng.randn(3, 3, 128, 128) * (2 / 1152) ** 0.5),
            t(rng.randn(128) * 0.1))


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


# ---------------------------------------------------------------------------
# the threads' places (conv_place, prow, pcol, pch; wg_products)
# ---------------------------------------------------------------------------

def conv_places(TR, NOUT):
    """[(rows, cols, channels)] of the 256 threads of a conv tile of TR rows
    x TC columns x NOUT channels: position i at (rows[i], cols[i]) of the
    tile (2 CSLOT of them), channel j (8)."""
    WM, WN = TR // 2, NOUT // 64
    out = []
    for warp in range(WM * WN):
        for lane in range(32):
            wm, wn, g, c = warp % WM, warp // WM, lane & 3, lane >> 2
            out.append(([2 * wm + i // CSLOT for i in range(2 * CSLOT)],
                        [2 * g + (i % CSLOT & 1) + 8 * (i % CSLOT >> 1)
                         for i in range(2 * CSLOT)],
                        [64 * wn + 4 * c + (j & 3) + 32 * (j >> 2)
                         for j in range(8)]))
    return out


def wgrad_stores():
    """[(dst, src)] a weight-gradient tile: the threads' stores of the
    tile's acc (128 x 128, flat index src) into a range's PART2 floats (dst).
    Of the 128 threads, warp w owns a = 64 (w % 2) + 4 (lane % 8) + (0..3,
    32..35) and n = 64 (w / 2) + 4 (lane / 8) + (0..3, 16..19, 32..35,
    48..51); tiles 9-13 hold dW3 taps 2(u-9) (a < 64) and 2(u-9)+1 (a >= 64,
    none past tap 8)."""
    maps = []
    for u in range(WG_TILES):
        dst, src = [], []
        for warp in range(4):
            for lane in range(32):
                a = torch.tensor([64 * (warp & 1) + 4 * (lane & 7) + (i & 3)
                                  + 32 * (i >> 2) for i in range(8)])[:, None]
                n = torch.tensor([64 * (warp >> 1) + 4 * (lane >> 3) + (j & 3)
                                  + 16 * (j >> 2) for j in range(16)])[None, :]
                tap = u if u < 9 else 2 * (u - 9) + (warp & 1)
                if tap >= 9:
                    continue
                base = (DW3_SIZE + 128 + (u * 128 + a) * 128 if u < 9
                        else (tap * 64 + a % 64) * 128)
                dst.append((base + n).reshape(-1))
                src.append((a * 128 + n).reshape(-1))
        maps.append((torch.cat(dst), torch.cat(src)))
    return maps


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------

def conv_tiles(a, w, TR, flip=False, pad=None, mutate=None):
    """conv_tile over the grid of (utterance, row tile, column tile): a
    (B, F, T, CIN), w (9, CIN, NOUT); each tile stages rows f0-1 .. f0+TR,
    columns t0-1 .. t0+TC of a (`pad` per channel outside the image; the
    kernel's is zero) and adds the 9 taps' products, a tap read at its
    offset into the staged tile. Returns (B, nf TR, nt TC, NOUT): the
    tiles' sums, past the image too."""
    B, F, T, CIN = a.shape
    nf, nt = -(-F // TR), -(-T // TC)
    halo = Fn.pad(a, (0, 0, 1, nt * TC + 1 - T, 1, nf * TR + 1 - F))
    if pad is not None:
        inside = torch.zeros(halo.shape[1:3], dtype=torch.bool)
        inside[1:F + 1, 1:T + 1] = True
        halo = torch.where(inside[None, :, :, None], halo, pad)
    out = torch.empty(B, nf * TR, nt * TC, w.shape[2])
    for fb in range(nf):
        for tb in range(nt):
            f0, t0 = fb * TR, tb * TC
            h = halo[:, f0:f0 + TR + 2, t0:t0 + TC + 2]   # the staged tile
            acc = torch.zeros(B, TR, TC, w.shape[2])
            for df in range(3):
                for dt in range(3):
                    sf, st = (2 - df, 2 - dt) if flip else (df, dt)
                    if mutate == "tap" and (df, dt) == (1, 2):
                        st = 1 if st != 1 else 0
                    acc += h[:, sf:sf + TR, st:st + TC] @ w[3 * df + dt]
            out[:, f0:f0 + TR, t0:t0 + TC] = acc
    return out


def pool_epilogue(y, b4, F, T):
    """The conv4 kernel's epilogue on its tiles' sums y (B, nf 8, nt TC,
    128), through the threads' places: out (B, F/2, T/2, 128), idx."""
    B, Fy, Ty, C = y.shape
    nf, nt = Fy // 8, Ty // TC
    tiles = y.reshape(B, nf, 8, nt, TC, C).permute(0, 1, 3, 2, 4, 5)
    pl = conv_places(8, 128)
    R = torch.tensor([p[0] for p in pl])[:, :, None]     # (threads, NP, 1)
    Cc = torch.tensor([p[1] for p in pl])[:, :, None]
    Ch = torch.tensor([p[2] for p in pl])[:, None, :]    # (threads, 1, 8)
    vals = tiles[:, :, :, R, Cc, Ch]        # (B, nf, nt, threads, NP, 8)
    out = torch.full((B, nf * 4, nt * TC // 2, C), float("nan"))
    idx = torch.full((B, nf * 4, nt * TC // 2, C), 9, dtype=torch.uint8)
    pr = torch.arange(nf)[:, None, None] * 4 + R[None, None, :, 0, 0] // 2
    for wdw in range(CSLOT // 2):
        # window order (0,0), (0,1), (1,0), (1,1): positions e, e+1,
        # e+CSLOT, e+CSLOT+1 of the thread, e = 2 w
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
        out[:, prb[..., None], pcb[..., None], ch] = torch.relu(best + b4[ch])
        idx[:, prb[..., None], pcb[..., None], ch] = arg
    return out[:, :F // 2, :T // 2], idx[:, :F // 2, :T // 2]


def mirror_x2(x, w3, b3):
    y = conv_tiles(x, w3.reshape(9, 64, 128), 8)
    F, T = x.shape[1:3]
    return torch.relu(y[:, :F, :T] + b3)           # inside the image only


def mirror_fwd(x, w3, b3, w4, b4, mutate=None):
    F, T = x.shape[1:3]
    x2 = mirror_x2(x, w3, b3)
    pad = torch.relu(b3) if mutate == "border" else None
    y = conv_tiles(x2, w4.reshape(9, 128, 128), 8, pad=pad, mutate=mutate)
    return pool_epilogue(y, b4, F, T)


def route_dy4(g, out, idx):
    """vgg_block2_bwd_dy4_f32_kernel: g where out > 0, at the window
    element idx names."""
    B, Fp, Tp, C = g.shape
    gm = torch.where(out > 0, g, torch.zeros(()))
    dy4 = torch.empty(B, 2 * Fp, 2 * Tp, C)
    for w in range(4):
        dy4[:, w >> 1::2, w & 1::2] = torch.where(idx == w, gm,
                                                  torch.zeros(()))
    return dy4


def wgrad(x, x2, dy4, dy3, pad=None, drop_middle=False):
    """vgg_block2_bwd_wgrad_f32_kernel and the reduce: (SPLITS, PART2)
    partial sums, a range's segments two a stage, then their sum in range
    order. `pad`: x2 outside the image (zero in the kernel); `drop_middle`:
    the range that holds the middle segment left out."""
    B, F, T, _ = x.shape
    tch = -(-T // SEG)
    nseg = B * F * tch
    drop = next(sp for sp in range(SPLITS) if nseg * (sp + 1) // SPLITS
                > nseg // 2) if drop_middle else None
    xp = Fn.pad(x, (0, 0, 1, tch * SEG + 1 - T, 1, 1))
    x2p = Fn.pad(x2, (0, 0, 1, tch * SEG + 1 - T, 1, 1))
    if pad is not None:
        inside = torch.zeros(x2p.shape[1:3], dtype=torch.bool)
        inside[1:F + 1, 1:T + 1] = True
        x2p = torch.where(inside[None, :, :, None], x2p, pad)
    dyp = [Fn.pad(d, (0, 0, 0, tch * SEG - T)) for d in (dy4, dy3)]
    stores = wgrad_stores()
    part = torch.full((SPLITS, PART2), float("nan"))
    for sp in range(SPLITS):
        lo, hi = nseg * sp // SPLITS, nseg * (sp + 1) // SPLITS
        for u in range(WG_TILES):
            acc, bsum = torch.zeros(128, 128), torch.zeros(128)
            for s0 in range(lo, hi, 2):
                A, Bm = torch.zeros(KP, 128), torch.zeros(KP, 128)
                for k, e in enumerate(range(s0, min(s0 + 2, hi))):
                    tc, f, b = e % tch, e // tch % F, e // tch // F
                    rows, c0 = slice(k * SEG, (k + 1) * SEG), tc * SEG
                    Bm[rows] = dyp[u >= 9][b, f, c0:c0 + SEG]
                    for h in range(1 if u < 9 else 2):
                        tap = u if u < 9 else 2 * (u - 9) + h
                        if tap < 9:
                            df, dt = divmod(tap, 3)
                            src = x2p if u < 9 else xp
                            A[rows, 64 * h:64 * h + src.shape[3]] = \
                                src[b, f + df, c0 + dt:c0 + dt + SEG]
                acc += A.T @ Bm
                bsum += Bm.sum(0)
            if sp == drop:
                acc.zero_(), bsum.zero_()
            dst, src = stores[u]
            part[sp, dst] = acc.reshape(-1)[src]
            if u in (4, 11):
                o = DW3_SIZE + 128 + DW4_SIZE if u == 4 else DW3_SIZE
                part[sp, o:o + 128] = bsum
    grads = part[0].clone()
    for sp in range(1, SPLITS):
        grads += part[sp]
    o1, o2, o3 = DW3_SIZE, DW3_SIZE + 128, DW3_SIZE + 128 + DW4_SIZE
    return (grads[:o1].view(3, 3, 64, 128), grads[o1:o2],
            grads[o2:o3].view(3, 3, 128, 128), grads[o3:])


def mirror_bwd(x, w3, b3, w4, out, idx, g, mutate=None):
    B, F, T, _ = x.shape
    x2 = mirror_x2(x, w3, b3)
    dy4 = route_dy4(g, out, idx)
    w4t = w4.permute(0, 1, 3, 2).reshape(9, 128, 128)      # (tap, c4, c3)
    dx2 = conv_tiles(dy4, w4t, 8, flip=True, mutate=mutate)[:, :F, :T]
    dy3 = torch.where(x2 > 0, dx2, torch.zeros(()))
    pad = torch.relu(b3) if mutate == "border" else None
    dw3, db3, dw4, db4 = wgrad(x, x2, dy4, dy3, pad=pad,
                               drop_middle=mutate == "split")
    w3t = w3.permute(0, 1, 3, 2).reshape(9, 128, 64)       # (tap, c3, ci)
    dx = conv_tiles(dy3, w3t, 16, flip=True)[:, :F, :T]
    return dx, dw3, db3, dw4, db4


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _idx_clear(x, w3, b3, w4):
    """The windows whose plain conv4's two best values lie clearly apart."""
    y4 = Fn.conv2d(TV._x2_plain(x, w3, b3, torch.float32),
                   TV._nchw(w4, torch.float32), padding=1)
    B, C, F, T = y4.shape
    win = y4.reshape(B, C, F // 2, 2, T // 2, 2).permute(
        0, 2, 4, 1, 3, 5).reshape(B, F // 2, T // 2, C, 4)
    top = win.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) > IDX_GAP * top[..., 0].abs(
        ).clamp_min(1.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_forward_decomposition_equals_the_plain_forward(shape):
    x, w3, b3, w4, b4 = _mk(*shape, seed=sum(shape))
    out, idx = mirror_fwd(x, w3, b3, w4, b4)
    want, want_idx = TV.vgg_block2_plain(x, w3, b3, w4, b4, torch.float32)
    assert out.shape == want.shape and not out.isnan().any()
    assert _rel(out, want) < F32_TOL
    clear = _idx_clear(x, w3, b3, w4)
    assert clear.float().mean() > 0.9
    assert bool((idx == want_idx)[clear].all())


def _bwd_case(shape, seed):
    x, w3, b3, w4, b4 = _mk(*shape, seed=seed)
    out, idx = TV.vgg_block2_plain(x, w3, b3, w4, b4, torch.float32)
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        *out.shape).astype(np.float32))
    want = TV.vgg_block2_bwd_plain(x, w3, b3, w4, out, idx, g, torch.float32)
    return (x, w3, b3, w4, out, idx, g), want


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_backward_decomposition_equals_the_plain_backward(shape):
    args, want = _bwd_case(shape, seed=2 * sum(shape))
    got = mirror_bwd(*args)
    for name, a, b in zip(("dx", "dw3", "db3", "dw4", "db4"), got, want):
        assert a.shape == b.shape and not a.isnan().any(), name
        assert _rel(a, b) < F32_TOL, name


@pytest.mark.parametrize("mutate", ["tap", "border", "split"])
def test_f32_mirror_catches_a_shifted_tap_a_leaking_border_and_a_dropped_range(
        mutate):
    """A tap read one column off, x2 outside the image at relu(b3) instead
    of zero (conv4 in the forward, dW4 in the backward), and one K range's
    partial sums left out each put the mirror far outside the tolerance."""
    shape = (2, 10, 34)
    args, want = _bwd_case(shape, seed=2 * sum(shape))
    got = mirror_bwd(*args, mutate=mutate)
    assert max(_rel(a, b) for a, b in zip(got, want)) > 100 * F32_TOL
    if mutate != "split":
        x, w3, b3, w4, b4 = _mk(*shape, seed=sum(shape))
        out, _ = mirror_fwd(x, w3, b3, w4, b4, mutate=mutate)
        want_out, _ = TV.vgg_block2_plain(x, w3, b3, w4, b4, torch.float32)
        assert _rel(out, want_out) > 100 * F32_TOL


@pytest.mark.parametrize("TR,NOUT", [(8, 128), (16, 64)])
def test_f32_conv_places_cover_the_tile_once_in_whole_windows(TR, NOUT):
    """Each (position, channel) of a conv tile belongs to one thread; a
    thread's positions are CSLOT / 2 whole pool windows; the four positions
    an A load instruction reads across a warp (lane % 4) sit in distinct
    banks (a staged position is PA = KC + 4 floats, a float4 four banks),
    and the eight channel float4s of a B load (lane / 4) fill the 32 banks
    once."""
    seen = torch.zeros(TR, TC, NOUT, dtype=torch.int64)
    places = conv_places(TR, NOUT)
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
    assert bool((seen == 1).all())
    PA, HC = KC + 4, TC + 2
    for warp in range(len(places) // 32):
        lanes = places[32 * warp:32 * warp + 32]
        for i in range(2 * CSLOT):
            banks = set()
            for g in range(4):
                rows, cols, _ = lanes[g]
                word = (rows[i] * HC + cols[i]) * PA
                banks |= {(word + k) % 32 for k in range(4)}
            assert len(banks) == 16
        chunks = {lanes[4 * c][2][0] for c in range(8)}
        assert {(ch + k) % 32 for ch in chunks for k in range(4)} == set(
            range(32))


def test_f32_wgrad_ranges_and_tiles_cover_every_sum_once():
    """The SPLITS ranges cut the K segments into contiguous pieces whatever
    their count (fewer segments than ranges too), and the 14 tiles' stores
    plus the two bias rows write each element of a range's PART2 floats
    once: the reduce adds no stale value."""
    for nseg in (1, 60, 131, 132, 133, 24000):
        bounds = [nseg * sp // SPLITS for sp in range(SPLITS + 1)]
        assert bounds[0] == 0 and bounds[-1] == nseg
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))
    hits = torch.zeros(PART2, dtype=torch.int64)
    for u, (dst, src) in enumerate(wgrad_stores()):
        assert src.unique().numel() == src.numel()
        hits.index_add_(0, dst, torch.ones_like(dst))
    hits[DW3_SIZE:DW3_SIZE + 128] += 1
    hits[DW3_SIZE + 128 + DW4_SIZE:] += 1
    assert bool((hits == 1).all())


def test_constants_match_the_source():
    """The mirror's tiling constants are the kernel source's, and the
    wrapper allocates SPLITS rows of partial sums."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "vgg_block2_f32.cu")) as f:
        src = f.read()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert {k: int(const[k]) for k in ("CSLOT", "SEG", "SPLITS", "KC")} == {
        "CSLOT": CSLOT, "SEG": SEG, "SPLITS": SPLITS, "KC": KC}
    assert "constexpr int TC = 4 * CSLOT;" in src
    assert TV.BWD2_BLOCKS[torch.float32] == SPLITS
    assert TV.PART2 == PART2
    # every kernel of an entry carries the prefix the timers sum by
    names = re.findall(r"__global__ void[^\n]*\n(\w+)\(", src)
    assert len(names) == 8
    assert all(n.startswith(("vgg_block2_fwd_", "vgg_block2_bwd_"))
               for n in names)


def _c_args(src, entry):
    """The ctypes types of an extern "C" entry's parameters in `src`."""
    sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src).group(1)
    return [cuda_lib.P if "*" in p else cuda_lib.I for p in sig.split(",")]


def test_f32_bindings_and_probes_match_the_entries():
    """The ctypes argument lists of the f32 entries match their C
    signatures (the forward's x2 scratch, the backward's one scratch of
    three activations), and tools/probe_vgg2_fwd.py reads the design of a
    source: this one's FFMA GEMMs with the scratch, or the earlier
    per-tile kernel without it; --parts full copies a source as it is."""
    from end2end_asr_tpu_torch.tools import probe_vgg2_bwd as PB
    from end2end_asr_tpu_torch.tools import probe_vgg2_fwd as PF
    with open(os.path.join(cuda_lib.CSRC_DIR, "vgg_block2_f32.cu")) as f:
        src = f.read()
    for kernels, entry in ((TV._FWD2_KERNELS, "vgg_block2_fwd_f32"),
                           (TV._BWD2_KERNELS, "vgg_block2_bwd_f32")):
        k = kernels[torch.float32]
        assert k.source == "vgg_block2_f32" and k.symbol == entry
        assert k.argtypes == _c_args(src, entry)
    assert PF.f32_design_of(src) == "fma"
    assert PF.f32_design_of("vgg_block2_fwd_kernel<float>") == "tiles"
    assert PF.f32_argtypes("fma") == TV._FWD2_KERNELS[torch.float32].argtypes
    assert len(PF.f32_argtypes("tiles")) == len(PF.f32_argtypes("fma")) - 1
    assert PF.variants(src, ["full"]) == {"full": src}
    assert PB.variants(src, ["full"]) == {"full": src}
    assert PB.SOURCE_F32 == PF.SOURCE_F32 == "vgg_block2_f32.cu"
    assert TV.BWD2_SCRATCH[torch.float32] == 3


def test_f32_probe_variants_apply_to_the_source():
    """tools/probe_vgg2_bwd.py --variants edits csrc/vgg_block2_f32.cu one
    design choice at a time: each edit must find its line once, each copy
    differs from the source and from the others, and a changed source
    breaks the probe loudly."""
    from end2end_asr_tpu_torch.tools import probe_vgg2_bwd as PB
    with open(os.path.join(cuda_lib.CSRC_DIR, "vgg_block2_f32.cu")) as f:
        src = f.read()
    copies = PB.f32_variants(src, PB.F32_VARIANTS)
    assert list(copies) == list(PB.F32_VARIANTS)
    assert len({src, *copies.values()}) == len(copies) + 1
    with pytest.raises(RuntimeError, match="update the probe"):
        PB.f32_variants(src.replace("constexpr int SPLITS = 132;",
                                    "constexpr int SPLITS = 64;"),
                        ["splits66"])
