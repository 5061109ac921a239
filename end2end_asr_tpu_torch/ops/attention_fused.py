"""Kernels 4, 5 and 9: the training attention with in-kernel dropout
(csrc/attention.cu), its recomputing backward, the dropout bit stream, and
their plain versions.

    out = dropout(softmax(q kᵀ / √dk + bias)) @ v

Replaces ``end2end_asr_tpu/ops/attention_fused.py``: ``_kernels.fwd``
(forward), ``_kernels.bwd`` (backward) and the ``dropout_bits`` test hook.
As there, nothing (Tq, Tk)-sized reaches device memory: the forward keeps
two f32 softmax statistics per query row (the max and the sum; one
log-sum-exp loses the sum under the −1e9 mask, see the source) besides
its output, and the backward recomputes the scores and regenerates the
same dropout mask from the seed. The forward is one launch that reads
q, k, v and writes out in the projections' (B, T, H, D) layout, with the
keys of each tile split among a block's warps where Tq is short
(`fwd_key_split`); `attn_fwd_emulated` is its algorithm in torch, for the
CPU tests. The backward is one launch: one pass over every (query, key)
element, dQ's per-key-tile shares summed in a fixed order (two runs give
the same bits); `attn_bwd_emulated` is its algorithm in torch.

Semantics kept from the JAX package:
  * keep = bits < thresh16·65536 on uint32 bits, thresh16 =
    round((1 − rate)·65536) (``models/layers.dropout_thresh16``), and kept
    probabilities are scaled by 65536/thresh16, so the estimator is
    unbiased; rate 0 (thresh16 = 65536) draws nothing;
  * the mask bias is −1e9, not −inf: a row whose keys are all masked comes
    out uniform and finite;
  * bias and seed get no gradient (the caller detaches the bias).

The random bits are Philox4x32-10, counter-based, with the layout written
once in the spec comment at the top of csrc/attention.cu; `philox_bits`
below is the same function in int64 tensor arithmetic, so the plain
version and the kernel draw the same bits on the CPU and on the card. The
TPU's stream (its own hardware PRNG) cannot be reproduced: tests compare
with the JAX package through keep masks fed from numpy.

Each kernel has two entry points, chosen by q's dtype: bf16 (the
training default), whose products run on the tensor cores (mma.sync,
f32 accumulate), and f32 (``--dtype float32``), whose products run in
full f32 on FMA (no TF32), as the JAX kernel runs in q's dtype
(``cdt = q.dtype``). Both keep f32 softmax statistics and share the
tiling, the dropout and the epilogues (see the source).

Bound on the H100: at the flagship (B=12, H=8, T=200, dk=64) one encoder
self-attention is 4·B·H·Tq·Tk·dk ≈ 1 GFLOP forward (≈1 µs on the bf16
tensor cores, ≈15 µs on f32 FMA) and reads ≈ 9 MB in bf16 (≈3 µs): the
bf16 kernels are bound by launch cost at this size, the f32 ones by FMA.

The seed comes by value (an int: the tests' and the probes' entry) or
as a `DeviceSeed`, a slot of an int64 buffer in device memory that the
kernels read at launch (the `_ds` entry points, the training path's:
models/layers.DropoutRng writes a step's seeds there before the step, so
a CUDA graph of the step draws each replay's masks).

`flash_mha_train` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernels, and raises if it cannot. `dropout_bits`
returns the uint32 bits held in int64 (PyTorch has no comparisons on
uint32 tensors): the kernel writes uint32, widened in one pass.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as Fn

from end2end_asr_tpu_torch.ops import cuda_lib

P, I = cuda_lib.P, cuda_lib.I
U64 = cuda_lib.U64

# q k v bias out stats strides, B H Tq Tk d thresh16, seed, key groups,
# stream
FWD = cuda_lib.CudaKernel("attention", "attn_fwd_bf16",
                          [P] * 7 + [I] * 6 + [U64, I, P])
# q k v bias out stats g dq dk dv strides, B H Tq Tk d thresh16, seed,
# part arrive stream
BWD = cuda_lib.CudaKernel("attention", "attn_bwd_bf16",
                          [P] * 11 + [I] * 6 + [U64, P, P, P])
FWD_F32 = cuda_lib.CudaKernel("attention", "attn_fwd_f32",
                              [P] * 7 + [I] * 6 + [U64, I, P])
BWD_F32 = cuda_lib.CudaKernel("attention", "attn_bwd_f32",
                              [P] * 11 + [I] * 6 + [U64, P, P, P])
BITS = cuda_lib.CudaKernel("attention", "dropout_bits_u32",
                           [P] + [I] * 4 + [U64, P])
KERNELS = {"attn_fwd": FWD, "attn_bwd": BWD, "attn_fwd_f32": FWD_F32,
           "attn_bwd_f32": BWD_F32, "dropout_bits": BITS}
# the device-seed entries of the same kernels (the seed's place in device
# memory instead of its value; the training path's): a launch through one
# counts on its kernel's binding above
_DS = {"attn_fwd": [P] * 7 + [I] * 6 + [P, I, P],
       "attn_bwd": [P] * 11 + [I] * 6 + [P, P, P, P],
       "dropout_bits": [P] + [I] * 4 + [P, P]}
DEVICE_SEED = {
    k: cuda_lib.CudaKernel("attention", kern.symbol + "_ds",
                           _DS[k.replace("_f32", "")], counts=kern)
    for k, kern in KERNELS.items()}
# the entry points by compute dtype: (forward, backward), by value and by
# device seed
_BY_DTYPE = {torch.bfloat16: (FWD, BWD), torch.float32: (FWD_F32, BWD_F32)}
_BY_DTYPE_DS = {torch.bfloat16: (DEVICE_SEED["attn_fwd"],
                                 DEVICE_SEED["attn_bwd"]),
                torch.float32: (DEVICE_SEED["attn_fwd_f32"],
                                DEVICE_SEED["attn_bwd_f32"])}


class DeviceSeed(NamedTuple):
    """A 64-bit Philox seed held in device memory: slot `slot` of the
    int64 tensor `buf` (models/layers.DropoutRng writes a step's seeds
    there before the step). The kernels read it at launch, so a CUDA graph
    that captured the launch draws each replay's seed; the plain versions
    read the same slot."""
    buf: torch.Tensor
    slot: int

    def value(self) -> int:
        """The seed on the host (a device read: the plain versions and
        tests only)."""
        return int(self.buf[self.slot].item())

    def address(self) -> int:
        return self.buf.data_ptr() + self.slot * self.buf.element_size()


def seed_value(seed) -> int:
    """A seed given as an int or as a DeviceSeed, as an int."""
    return seed.value() if isinstance(seed, DeviceSeed) else int(seed)

HEAD_DIMS = (64,)   # head widths the kernels are built for
MASK_BIAS = -1e9
TILE = 64           # queries per tile of the backward; keys per tile
CHUNK = 16          # keys a warp of the backward owns
WARPS = 8           # chunks per key tile at most: the backward's warps
KEY_SPLITS = (1, 2, 4)   # the forward's key groups a block (bf16)


def dropout_thresh16(rate: float) -> int:
    """uint16 keep threshold: round((1-rate)·2^16) (the JAX package's
    models/layers.dropout_thresh16)."""
    return int(round((1.0 - rate) * 65536.0))


# ---------------------------------------------------------------------------
# Philox4x32-10 in int64 tensor arithmetic (spec: csrc/attention.cu)
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a·m for a < 2^32 (int64 tensor) and a
    32-bit constant m, through 16-bit limbs so no product exceeds 2^49."""
    ah, al = a >> 16, a & 0xFFFF
    mh, ml = m >> 16, m & 0xFFFF
    mid = ah * ml + al * mh
    t = al * ml + ((mid & 0xFFFF) << 16)
    lo = t & _MASK32
    hi = (ah * mh + (mid >> 16) + (t >> 32)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 counter words;
    (k0, k1) the uint32 key words. Returns the four uint32 output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(seed: int, B: int, H: int, Tq: int, Tk: int,
                device=None) -> torch.Tensor:
    """(B, H, Tq, Tk) int64 holding the uint32 bits of the attention
    dropout stream: bits[b, h, q, k] = word (k & 3) of
    philox4x32_10(counter=(k >> 2, q, h, b), key=(seed lo, seed hi))."""
    s = seed & 0xFFFFFFFFFFFFFFFF
    kw = (Tk + 3) // 4
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    shape = (B, H, Tq, kw)
    c0 = ar(kw).view(1, 1, 1, kw).expand(shape)
    c1 = ar(Tq).view(1, 1, Tq, 1).expand(shape)
    c2 = ar(H).view(1, H, 1, 1).expand(shape)
    c3 = ar(B).view(B, 1, 1, 1).expand(shape)
    words = philox4x32_10(c0, c1, c2, c3, s & _MASK32, s >> 32)
    return torch.stack(words, dim=-1).reshape(B, H, Tq, 4 * kw)[..., :Tk]


def keep_mask(seed: int, B: int, H: int, Tq: int, Tk: int, thresh16: int,
              device=None) -> torch.Tensor:
    """(B, H, Tq, Tk) bool: the kernels' dropout keep mask."""
    return philox_bits(seed, B, H, Tq, Tk, device) < thresh16 * 65536


def dropout_bits_plain(seed: int, B: int, H: int, Tq: int, Tk: int,
                       device=None) -> torch.Tensor:
    return philox_bits(seed, B, H, Tq, Tk, device).reshape(B, H * Tq, Tk)


def dropout_bits(seed, B: int, H: int, Tq: int, Tk: int,
                 device=None) -> torch.Tensor:
    """(B, H·Tq, Tk) int64 holding the uint32 bits that the forward AND
    backward kernels draw for these shapes (the JAX package's
    ``dropout_bits``). `seed`: an int, or a DeviceSeed (the kernel reads
    it from device memory). On a CUDA device the kernel writes them."""
    device = torch.device(device or "cpu")
    if device.type == "cpu":
        return dropout_bits_plain(seed_value(seed), B, H, Tq, Tk, device)
    if device.type != "cuda":
        raise ValueError(f"dropout_bits: unsupported device {device}")
    out = torch.empty((B, H * Tq, Tk), dtype=torch.uint32, device=device)
    if out.numel():
        with torch.cuda.device(device):
            if isinstance(seed, DeviceSeed):
                DEVICE_SEED["dropout_bits"].launch(
                    out.data_ptr(), B, H, Tq, Tk, seed.address(), _stream())
            else:
                BITS.launch(out.data_ptr(), B, H, Tq, Tk,
                            seed & (2 ** 64 - 1), _stream())
    return out.to(torch.int64)       # zero-extended: one pass


# the kernel's launch (csrc/attention.cu, dropout_bits_u32): one thread a
# group of four words, grid (groups of one (b, h) / BITS_THREADS, H, B)
BITS_THREADS = 256


def fast_div_magic(d: int) -> Tuple[int, int]:
    """(mul, shr) with n // d == (n · mul >> 32) >> shr for 0 <= n < 2^31
    and d >= 2 (csrc/attention.cu, make_fast_div; d = 1 divides by
    nothing)."""
    l = (d - 1).bit_length()                    # ceil(log2 d)
    p = 31 + l
    return ((1 << p) + d - 1) // d, p - 32


def dropout_bits_by_threads(seed: int, B: int, H: int, Tq: int, Tk: int,
                            device=None):
    """The bits as dropout_bits_kernel's threads write them (tests only):
    thread t of block (x, h, b) takes flat group f = 256x + t of the (b, h)
    slab, q = f / ceil(Tk/4) by `fast_div_magic`, c = f - q·ceil(Tk/4),
    stops where q >= Tq, draws Philox (c, q, h, b) and writes its words at
    (b·H + h)·Tq·Tk + q·Tk + 4c + j: all four where Tk % 4 == 0 (one
    16-byte store), else those with 4c + j < Tk. Returns ((B, H·Tq, Tk)
    int64 bits, (B, H·Tq, Tk) int64 count of writes per element)."""
    s = seed & 0xFFFFFFFFFFFFFFFF
    kw = -(-Tk // 4)
    nx = -(-(Tq * kw) // BITS_THREADS)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    f = (BITS_THREADS * ar(nx).view(nx, 1) + ar(BITS_THREADS)).reshape(-1)
    if kw == 1:
        q = f
    else:
        mul, shr = fast_div_magic(kw)
        q = ((f * mul) >> 32) >> shr
    f, q = f[q < Tq], q[q < Tq]
    c = f - q * kw
    shape = (B, H, f.numel())
    c0, c1 = c.expand(shape), q.expand(shape)
    c2 = ar(H).view(1, H, 1).expand(shape)
    c3 = ar(B).view(B, 1, 1).expand(shape)
    words = philox4x32_10(c0, c1, c2, c3, s & _MASK32, s >> 32)
    base = (c3 * H + c2) * (Tq * Tk) + c1 * Tk + 4 * c0
    bits = torch.zeros(B * H * Tq * Tk, dtype=torch.int64, device=device)
    count = torch.zeros_like(bits)
    for j, w in enumerate(words):
        # the 16-byte store writes all four; the scalar ones stop at Tk
        sel = (4 * c0 + j < Tk) | (Tk % 4 == 0)
        idx = (base + j)[sel]
        bits[idx] = w[sel]
        count.index_add_(0, idx, torch.ones_like(idx))
    return bits.view(B, H * Tq, Tk), count.view(B, H * Tq, Tk)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def flash_mha_train_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, seed, rate: float,
                          keep: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """softmax(q kᵀ/√dk + bias) → dropout → @ v with f32 scores and
    softmax, the probabilities rounded to q's dtype before the product
    (as the JAX kernel's p_all). `seed`: an int or a DeviceSeed. `keep`
    (B, H, Tq, Tk) bool overrides the Philox mask (tests feed masks from
    numpy)."""
    B, H, Tq, Dk = q.shape
    Tk = k.shape[2]
    s = (torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
         * (1.0 / math.sqrt(Dk)) + bias.float()[:, None])
    p = torch.softmax(s, dim=-1)
    thresh16 = dropout_thresh16(rate)
    if keep is not None or thresh16 < 65536:
        if keep is None:
            keep = keep_mask(seed_value(seed), B, H, Tq, Tk, thresh16,
                             q.device)
        p = torch.where(keep, p * (65536.0 / thresh16),
                        torch.zeros((), dtype=p.dtype, device=p.device))
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# The forward kernel's algorithm in torch (the CPU tests hold it against
# the plain version and the JAX kernel)
# ---------------------------------------------------------------------------

def fwd_key_split(B: int, H: int, Tq: int, sms: int) -> int:
    """The forward's key groups a block: 1 (64 query rows a block) where
    the ceil(Tq/64)·B·H blocks give each of `sms` SMs two, else the
    smallest split (2: 32 rows, 4: 16 rows) that does, else 4."""
    for wk in KEY_SPLITS:
        if -(-Tq // (TILE // wk)) * B * H >= 2 * sms:
            return wk
    return KEY_SPLITS[-1]


def keep_mask_by_fwd_lanes(seed: int, B: int, H: int, Tq: int, Tk: int,
                           thresh16: int, device=None) -> torch.Tensor:
    """(B, H, Tq, Tk) bool: the keep mask as the forward kernel's lanes
    draw it (csrc/attention.cu, keep_bits_fwd). In 16-query group g and
    8-key tile t, lane L (r0 = 16g + L/4, odd = L & 1) draws the call for
    key group 2t + (L % 4)/2 and query r0 + 8·odd; it keeps words 2·odd +
    {0, 1} (its own elements: row r0 + 8·odd) and sends the other two as
    flags to lane L ^ 1, whose elements of that row they are. Element
    (row r0 + 8·hr, key 8t + 2 (L % 4) + j) is bit j of the row's pair.
    Equal to `keep_mask` when the exchange is right."""
    s = seed & 0xFFFFFFFFFFFFFFFF
    ng, nt = -(-Tq // 16), -(-Tk // 8)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    lane = ar(32)
    odd = lane & 1
    shape = (B, H, ng, nt, 32)
    c0 = 2 * ar(nt).view(1, 1, 1, nt, 1) + ((lane & 3) >> 1)
    c1 = 16 * ar(ng).view(1, 1, ng, 1, 1) + (lane >> 2) + 8 * odd
    w = torch.stack(philox4x32_10(
        c0.expand(shape), c1.expand(shape),
        ar(H).view(1, H, 1, 1, 1).expand(shape),
        ar(B).view(B, 1, 1, 1, 1).expand(shape), s & _MASK32, s >> 32), -1)
    f = (w < thresh16 * 65536).long()
    lo, hi = f[..., 0] | f[..., 1] << 1, f[..., 2] | f[..., 3] << 1
    own = torch.where(odd.bool(), hi, lo)
    got = torch.where(odd.bool(), lo, hi)[..., lane ^ 1]  # the partner's
    pair = (torch.where(odd.bool(), got, own),     # row r0
            torch.where(odd.bool(), own, got))     # row r0 + 8
    keep = torch.zeros(B, H, 16 * ng, 8 * nt, dtype=torch.bool,
                       device=device)
    for hr in range(2):
        for j in range(2):
            row = (16 * ar(ng).view(ng, 1, 1) + (lane >> 2) + 8 * hr)
            key = 8 * ar(nt).view(1, nt, 1) + 2 * (lane & 3) + j
            keep[:, :, row.expand(ng, nt, 32), key.expand(ng, nt, 32)] = (
                (pair[hr] >> j) & 1).bool()
    return keep[:, :, :Tq, :Tk]


def attn_fwd_emulated(q, k, v, bias, seed: int, rate: float,
                      key_split: int = 1,
                      keep: Optional[torch.Tensor] = None):
    """The forward kernel's algorithm in torch (tests only): (out in q's
    dtype, stats (B, H, Tq, 2) f32). Key group wk of `key_split` takes
    keys 64/key_split·wk .. of every 64-key tile with its own online
    softmax (running max m, sum l of the undropped exp(x − m), o = Σ P·V
    with the dropped P rounded to the compute type); the groups' rows are
    then added in group order: m the max of theirs, l and o rescaled to
    it, out = o / l. `keep` (B, H, Tq, Tk) bool overrides the lanes'
    Philox mask."""
    cdt = q.dtype
    B, H, Tq, Dk = q.shape
    Tk = k.shape[2]
    thresh16 = dropout_thresh16(rate)
    if keep is None and thresh16 < 65536:
        keep = keep_mask_by_fwd_lanes(seed, B, H, Tq, Tk, thresh16, q.device)
    kscale = 65536.0 / thresh16 if keep is not None else 1.0
    x = (q.float() @ k.float().transpose(-1, -2) * (1.0 / math.sqrt(Dk))
         + bias.float()[:, None])
    kc = TILE // key_split
    groups = []
    for wk in range(key_split):
        m = torch.full((B, H, Tq), -math.inf, device=q.device)
        l = torch.zeros(B, H, Tq, device=q.device)
        o = torch.zeros(B, H, Tq, Dk, device=q.device)
        for k0 in range(kc * wk, Tk, TILE):
            k1 = min(k0 + kc, Tk)
            xs = x[..., k0:k1]
            mn = torch.maximum(m, xs.amax(-1))
            c = torch.exp(m - mn)
            e = torch.exp(xs - mn[..., None])
            l = l * c + e.sum(-1)
            if keep is not None:
                e = torch.where(keep[..., k0:k1], e * kscale,
                                torch.zeros((), device=q.device))
            o = o * c[..., None] + e.to(cdt).float() @ v[:, :, k0:k1].float()
            m = mn
        groups.append((m, l, o))
    mx = torch.stack([g[0] for g in groups]).amax(0)
    lsum = torch.zeros_like(mx)
    acc = torch.zeros(B, H, Tq, Dk, device=q.device)
    for m, l, o in groups:
        c = torch.exp(m - mx)
        lsum = lsum + l * c
        acc = acc + o * c[..., None]
    return (acc * (1.0 / lsum)[..., None]).to(cdt), torch.stack([mx, lsum],
                                                                -1)


# ---------------------------------------------------------------------------
# The backward kernel's algorithm in torch (the CPU tests hold it against
# the plain backward and the JAX kernel; the card holds the kernel against
# the plain version)
# ---------------------------------------------------------------------------

def key_tiles(Tk: int) -> List[Tuple[int, int]]:
    """The backward's key tiles [(k0, k1)]: ceil(Tk/16) chunks of 16 keys
    (one a warp) spread over ceil(chunks/8) tiles as evenly as they come
    (the kernel's c_lo, c_hi)."""
    nch = -(-Tk // CHUNK)
    nkt = -(-nch // WARPS)
    return [(CHUNK * (t * nch // nkt),
             min(CHUNK * ((t + 1) * nch // nkt), Tk)) for t in range(nkt)]


def attn_stats_plain(q: torch.Tensor, k: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """(B, H, Tq, 2) f32: what the forward kernel saves, the row max m of
    x = q·kᵀ/√dk + bias and the row sum l of exp(x − m)."""
    x = (torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
         * (1.0 / math.sqrt(q.shape[-1])) + bias.float()[:, None])
    m = x.amax(-1)
    return torch.stack([m, torch.exp(x - m[..., None]).sum(-1)], -1)


def keep_mask_by_lanes(seed: int, B: int, H: int, Tq: int, Tk: int,
                       thresh16: int, device=None) -> torch.Tensor:
    """(B, H, Tq, Tk) bool: the keep mask as the backward kernel's lanes
    draw it (csrc/attention.cu, keep_bits). In a warp's 16-key chunk c and
    8-query tile n, lane L (wd = L bits 2-3, hh = L bit 4, p = L % 4)
    draws the call for key group 4c + hh + 2·(wd >> 1) and query 8n + 2p +
    (wd & 1); in round x it sends word wd ^ x to lane L ^ 4x, and the word
    it receives is the keep flag of its element wd ^ x (element i: key row
    16c + L/4 + 8·(i >> 1), query 8n + 2p + (i & 1)). Equal to `keep_mask`
    when the exchange is right."""
    s = seed & 0xFFFFFFFFFFFFFFFF
    nch, nnt = -(-Tk // CHUNK), -(-Tq // 8)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    lane = ar(32)
    wd, hh, pp = (lane >> 2) & 3, lane >> 4, lane & 3
    shape = (B, H, nch, nnt, 32)
    c0 = 4 * ar(nch).view(1, 1, nch, 1, 1) + (hh + 2 * (wd >> 1))
    c1 = 8 * ar(nnt).view(1, 1, 1, nnt, 1) + (2 * pp + (wd & 1))
    words = torch.stack(philox4x32_10(
        c0.expand(shape), c1.expand(shape),
        ar(H).view(1, H, 1, 1, 1).expand(shape),
        ar(B).view(B, 1, 1, 1, 1).expand(shape), s & _MASK32, s >> 32), -1)
    bits = torch.zeros(shape, dtype=torch.int64, device=device)
    for x in range(4):
        src = lane ^ (x << 2)
        sel = (wd[src] ^ x).view(1, 1, 1, 1, 32, 1).expand(*shape, 1)
        got = words[..., src, :].gather(-1, sel).squeeze(-1)
        bits |= (got < thresh16 * 65536).long() << (wd ^ x)
    keep = torch.zeros(B, H, CHUNK * nch, 8 * nnt, dtype=torch.bool,
                       device=device)
    for i in range(4):
        key = (CHUNK * ar(nch).view(nch, 1, 1) + (lane >> 2) + 8 * (i >> 1))
        qry = 8 * ar(nnt).view(1, nnt, 1) + 2 * pp + (i & 1)
        keep[:, :, key.expand(nch, nnt, 32), qry.expand(nch, nnt, 32)] = (
            (bits >> i) & 1).bool()
    return keep[:, :, :Tk, :Tq].transpose(-1, -2)


def attn_bwd_emulated(q, k, v, bias, out, stats, g, seed: int, rate: float,
                      keep: Optional[torch.Tensor] = None):
    """The backward kernel's algorithm in torch (tests only): (dq, dk, dv)
    in q's dtype. Key tiles of `key_tiles`, keys padded to whole 16-key
    chunks (score −inf), queries to whole 64-query tiles (m = +inf,
    1/l = 0, D = 0); P = exp(x − m)·(1/l) from `stats`; D = Σ dO·O with O
    the output in the compute type; the dropped P and dS rounded to the
    compute type before their products; dK, dV summed over the query tiles
    in order, and dQ's per-key-tile shares (f32) added in key-tile order.
    `keep` (B, H, Tq, Tk) bool overrides the lanes' Philox mask."""
    cdt = q.dtype
    B, H, Tq, Dk = q.shape
    Tk = k.shape[2]
    scale = 1.0 / math.sqrt(Dk)
    thresh16 = dropout_thresh16(rate)
    if keep is None and thresh16 < 65536:
        keep = keep_mask_by_lanes(seed, B, H, Tq, Tk, thresh16, q.device)
    kscale = 65536.0 / thresh16 if keep is not None else 1.0
    rnd = lambda t: t.to(cdt).float()
    Tqp = -(-Tq // TILE) * TILE
    rows = lambda t, n: Fn.pad(t.float(), (0, 0, 0, n - t.shape[2]))
    qp, gp = rows(q, Tqp), rows(g, Tqp)
    pad_q = lambda t, fill: torch.cat(
        [t, torch.full((B, H, Tqp - Tq), fill, device=q.device)], -1)
    m = pad_q(stats[..., 0].float(), math.inf)
    linv = pad_q(1.0 / stats[..., 1].float(), 0.0)
    d = pad_q((g.float() * out.to(cdt).float()).sum(-1), 0.0)
    # bias and keep as (B, 1, Tqp, Tk + 64): zero / kept past the edges
    bias_p = Fn.pad(bias.float(), (0, TILE, 0, Tqp - Tq))[:, None]
    keep_p = (Fn.pad(keep.float(), (0, TILE, 0, Tqp - Tq)) if keep is not None
              else None)
    shares, dks, dvs = [], [], []
    for k0, k1 in key_tiles(Tk):
        c = -(-(k1 - k0) // CHUNK) * CHUNK
        kk, vv = rows(k[:, :, k0:k1], c), rows(v[:, :, k0:k1], c)
        real = (torch.arange(c, device=q.device) < k1 - k0)[:, None]
        dka = torch.zeros(B, H, c, Dk, device=q.device)
        dva = torch.zeros_like(dka)
        share = torch.zeros(B, H, Tqp, Dk, device=q.device)
        for q0 in range(0, Tqp, TILE):
            sl = slice(q0, q0 + TILE)
            st = kk @ qp[:, :, sl].transpose(-1, -2)       # S^T: keys x q
            dpt = vv @ gp[:, :, sl].transpose(-1, -2)
            x = torch.where(real, st * scale + bias_p[:, :, sl, k0:k0 + c]
                            .transpose(-1, -2), -math.inf)
            pr = torch.exp(x - m[:, :, None, sl]) * linv[:, :, None, sl]
            kp = (keep_p[:, :, sl, k0:k0 + c].transpose(-1, -2) * kscale
                  if keep_p is not None else 1.0)
            pd = rnd(pr * kp)
            ds = rnd(pr * (dpt * kp - d[:, :, None, sl]))
            dva += pd @ gp[:, :, sl]
            dka += ds @ qp[:, :, sl]
            share[:, :, sl] = ds.transpose(-1, -2) @ kk
        shares.append(share)
        dks.append(dka[:, :, :k1 - k0])
        dvs.append(dva[:, :, :k1 - k0])
    dq = shares[0]
    for sh in shares[1:]:
        dq = dq + sh
    return ((dq[:, :, :Tq] * scale).to(cdt),
            (torch.cat(dks, 2) * scale).to(cdt), torch.cat(dvs, 2).to(cdt))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, bias):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or bias.dim() != 3:
        raise ValueError("flash_mha_train: q/k/v (B, H, T, d), bias "
                         "(B, Tq, Tk)")
    B, H, Tq, Dk = q.shape
    Tk, Dv = k.shape[2], v.shape[3]
    if (k.shape != (B, H, Tk, Dk) or v.shape[:3] != (B, H, Tk)
            or bias.shape != (B, Tq, Tk)):
        raise ValueError("flash_mha_train: shapes disagree: q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} bias {tuple(bias.shape)}")
    if Dk != Dv or Dk not in HEAD_DIMS:
        raise ValueError(f"flash_mha_train: head widths {Dk}/{Dv}; the "
                         f"kernels take dk = dv in {HEAD_DIMS}")
    if q.dtype not in _BY_DTYPE:
        raise ValueError(f"flash_mha_train: q is {q.dtype}; the kernels "
                         "take bf16 or f32")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"flash_mha_train: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_mha_train: {name} on {t.device}")
    if bias.dtype != torch.float32 or bias.device != q.device:
        raise ValueError("flash_mha_train: bias must be f32 on q's device")


def _stream():
    return torch.cuda.current_stream().cuda_stream


# SMs by device index: the forward's grid rule
_SMS = {}


def _sms(device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _strided_ok(t: torch.Tensor) -> bool:
    """The kernels read t through its strides: rows contiguous, every
    row 16-byte aligned."""
    e, (sb, sh, st, sd) = 16 // t.element_size(), t.stride()
    return sd == 1 and not (sb % e or sh % e or st % e or t.data_ptr() % 16)


def _strides(*ts) -> "ctypes.Array":
    return (ctypes.c_longlong * (3 * len(ts)))(
        *(s for t in ts for s in t.stride()[:3]))


def attn_fwd(q, k, v, bias, seed, rate: float):
    """Kernel 4: (out (B, H, Tq, d) in q's dtype, stats (B, H, Tq, 2)
    f32: the row max and row sum of the softmax). bf16 or f32. `seed`: an
    int (the by-value entry) or a DeviceSeed (the device-seed entry, the
    training path's). q, k and v
    are read through their strides (the transposed (B, T, H, D) views of
    the projections need no copy); out is written into (B, Tq, H, D)
    memory and returned as its (B, H, Tq, D) view, so the caller's
    transpose back is a view too. The kernel's key groups a block:
    `fwd_key_split`'s for bf16, 1 for f32."""
    _check(q, k, v, bias)
    bias = bias.contiguous()
    q, k, v = (t if _strided_ok(t) else t.contiguous() for t in (q, k, v))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    out = torch.empty((B, Tq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    stats = torch.empty((B, H, Tq, 2), dtype=torch.float32,
                        device=q.device)
    key_split = (1 if q.dtype == torch.float32
                 else fwd_key_split(B, H, Tq, _sms(q.device)))
    if out.numel():
        with torch.cuda.device(q.device):
            strides = _strides(q, k, v, out)
            by_dev = isinstance(seed, DeviceSeed)
            (_BY_DTYPE_DS if by_dev else _BY_DTYPE)[q.dtype][0].launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
                ctypes.addressof(strides), B, H, Tq, Tk, D,
                dropout_thresh16(rate),
                seed.address() if by_dev else seed & (2 ** 64 - 1),
                key_split, _stream())
    return out, stats


# arrival counters of the backward, one set per (device, stream): the
# kernel's last block of each (b, h) sets its counter back to 0
_ARRIVE = {}


def _arrive(device, n: int) -> torch.Tensor:
    key = (device.index, _stream())
    t = _ARRIVE.get(key)
    if t is None or t.numel() < n:
        t = _ARRIVE[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def attn_bwd(q, k, v, bias, out, stats, g, seed, rate: float):
    """Kernel 5: (dq, dk, dv) in q's dtype, the forward and its mask
    recomputed, in one launch. q, k, v, out and g are read through their
    strides (the (B, T, H, D) layout of the projections, transposed, needs
    no copy), and dq, dk, dv come back in the layouts of q, k, v."""
    _check(q, k, v, bias)
    if out.dtype != q.dtype or g.dtype != q.dtype:
        raise ValueError("attn_bwd: out and g must be in q's dtype")
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"attn_bwd: out {tuple(out.shape)} and g "
                         f"{tuple(g.shape)} must be q's shape")
    bias, stats = bias.contiguous(), stats.contiguous()
    q, k, v, out, g = (t if _strided_ok(t) else t.contiguous()
                       for t in (q, k, v, out, g))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    # empty_like keeps the layout of q, k, v (dense, 16-byte aligned rows)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() and dk.numel():
        nkt = len(key_tiles(Tk))
        with torch.cuda.device(q.device):
            part = arrive = None
            if nkt > 1:
                part = torch.empty(B * H * nkt * Tq * D, dtype=torch.float32,
                                   device=q.device)
                arrive = _arrive(q.device, B * H)
            strides = _strides(q, k, v, g, dq, dk, dv, out)
            by_dev = isinstance(seed, DeviceSeed)
            (_BY_DTYPE_DS if by_dev else _BY_DTYPE)[q.dtype][1].launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
                g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), ctypes.addressof(strides), B, H, Tq, Tk, D,
                dropout_thresh16(rate),
                seed.address() if by_dev else seed & (2 ** 64 - 1),
                part.data_ptr() if part is not None else None,
                arrive.data_ptr() if arrive is not None else None, _stream())
    return dq, dk, dv


class FlashMhaTrain(torch.autograd.Function):
    """Forward kernel 4, backward kernel 5 on CUDA tensors (the backward
    takes q, k, v and g as they come, transposed views of the
    projections, and hands back gradients in their layouts); the plain
    version and its autograd on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias)
            return flash_mha_train_plain(q, k, v, bias, seed, rate)
        if q.device.type != "cuda":
            raise ValueError(f"flash_mha_train: unsupported device "
                             f"{q.device}")
        out, stats = attn_fwd(q, k, v, bias, seed, rate)
        ctx.save_for_backward(q, k, v, bias, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cpu":
            q, k, v, bias = ctx.saved_tensors
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                out = flash_mha_train_plain(*qkv, bias, ctx.seed, ctx.rate)
                dq, dk, dv = torch.autograd.grad(out, qkv, g)
        else:
            q, k, v, bias, out, stats = ctx.saved_tensors
            dq, dk, dv = attn_bwd(q, k, v, bias, out, stats,
                                  g.to(q.dtype), ctx.seed, ctx.rate)
        return dq, dk, dv, None, None, None


def flash_mha_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Fused softmax(q kᵀ/√dk + bias) → dropout(rate) → @ v, as the JAX
    package's ``flash_mha_train``. q, k: (B, H, Tq|Tk, dk); v: (B, H, Tk,
    dv); bias: (B, Tq, Tk) f32 additive mask (0 or −1e9); seed: the 64-bit
    Philox key of this call, an int or a DeviceSeed (the training path's:
    the kernels read it from device memory, the backward the same slot);
    rate in [0, 1). Returns (B, H, Tq, dv) in q's dtype. bias and seed get
    no gradient."""
    if dropout_thresh16(rate) <= 0:
        raise ValueError("flash_mha_train: rate rounds to keep 0; the "
                         "caller takes the plain path (layers.mha)")
    if not isinstance(seed, DeviceSeed):
        seed = int(seed)
    return FlashMhaTrain.apply(q, k, v, bias, seed, float(rate))


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
