"""Transformer building blocks, plain functions on tensors.

Port of the JAX package's ``models/layers.py``. Behavioral contract with
the reference (`models/common_layers.py`):
  * masks — get_non_pad_mask/get_attn_key_pad_mask/get_subsequent_mask
    (common_layers.py:28-74),
  * sinusoidal positional encoding (common_layers.py:76-98),
  * multi-head attention with separate Q/K/V projection widths
    (num_heads*dim_key / num_heads*dim_value) and post-LN residual
    (common_layers.py:144-225): matmul + masked softmax with -inf fill,
    as the JAX package's ``attn_core``, and in training with dropout the
    fused attention kernel (ops/attention_fused.py, -1e9 fill, as the
    JAX package routes it at layers.py:274-283),
  * position-wise FFN with kernel-1 Conv1d (common_layers.py:124-142) as
    two dense layers over the feature axis,
  * inverted dropout with a uint16 keep threshold (layers.py:110-140).

Random bits come from a `DropoutRng`: explicit generators, never the
global one.

Params are the JAX package's pytree with tensors for leaves: nested
dicts (and lists for layer stacks) keyed exactly as there, so a JAX
checkpoint loads without renaming (training/checkpoint.py).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from end2end_asr_tpu_torch.ops import attention_fused as AF
from end2end_asr_tpu_torch.ops.attention_fused import dropout_thresh16
from end2end_asr_tpu_torch.parallel import mesh, tp
from end2end_asr_tpu_torch.utils import profiling

Params = Dict[str, object]

LN_EPS = 1e-5  # torch nn.LayerNorm default

# the tracer's site around each fused attention call in `mha` and the
# reshape of its output (utils/profiling.Recorder.range)
ATTENTION_FORWARD = "attention_forward"

# the seeds a DropoutRng holds in device memory: one step's, or one group
# of steps' (a CUDA graph of K steps)
SEED_SLOTS = 4096


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _hash63(text: str) -> int:
    """A 63-bit integer hashed from `text` (a seed that depends on nothing
    else)."""
    h = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


class _Bits:
    """Draws from the device generator `dev`: the plain dropout's uint16
    bits. `remat` under CUDA-graph capture records a layer's first-run
    draws (`_record`) and replays them to its recompute (`_replay`)."""

    dev: torch.Generator
    _record: Optional[list] = None
    _replay = None

    def _drawn(self, draw) -> torch.Tensor:
        if self._replay is not None:
            return next(self._replay)
        out = draw()
        if self._record is not None:
            self._record.append(out)
        return out

    def bits16(self, shape, device) -> torch.Tensor:
        return self._drawn(lambda: torch.randint(
            0, 65536, tuple(shape), generator=self.dev, device=device,
            dtype=torch.int32))


class DropoutRng(_Bits):
    """The random streams of one training run, seeded from the run's seed:
    `host` (a CPU generator) draws the 64-bit Philox seeds of the
    attention kernel; `dev` (a generator on the training device) draws the
    uint16 bits of the plain dropout; `spec` (on the device too) draws
    SpecAugment's bands, so that turning the augmentation on leaves the
    dropout masks as they were.

    The kernel seeds live in device memory (`seeds`): a step (`begin_step`)
    draws its seeds from `host` up front, in the order the step uses them,
    and writes them there with one copy from pinned memory; `kernel_seed`
    hands out their slots in turn (ops/attention_fused.DeviceSeed), and the
    kernels read the seed at launch. A group of steps (`group`: a CUDA
    graph of K steps) draws the K steps' seeds at once, so the graph reads
    each replay's seeds and the host stream is the one K single steps
    draw. The first step draws as it goes (one copy a seed) and sets how
    many a step takes. Pipeline parallelism's (stack, layer, microbatch)
    streams (`pipe_stream`) draw on the device instead."""

    def __init__(self, seed: int, device):
        device = torch.device(device)
        self.device = device
        self.seed = seed
        self.host = torch.Generator().manual_seed(seed)
        self.dev = torch.Generator(device=device).manual_seed(seed + 1)
        self.spec = torch.Generator(device=device).manual_seed(seed + 2)
        self.seeds: Optional[torch.Tensor] = None   # (SEED_SLOTS,) int64
        self.values: list = []  # the same seeds on the host
        self.drawn = 0          # seeds drawn into `seeds` for this step
        self.slot = 0           # the next kernel_seed's slot
        self.per_step: Optional[int] = None
        self.streams: Dict[tuple, "PipeStream"] = {}
        self._grouped = False

    # -- the kernel seeds ------------------------------------------------
    def _draw(self, n: int) -> None:
        """n more seeds from `host` into slots drawn .. drawn + n."""
        if n <= 0:
            return
        if _capturing(self.device):
            raise RuntimeError(
                "a step under CUDA-graph capture asked for more kernel "
                "seeds than its group drew")
        if self.drawn + n > SEED_SLOTS:
            raise RuntimeError(f"more than {SEED_SLOTS} kernel seeds in "
                               "one step or group")
        new = [int(torch.randint(0, 2 ** 63 - 1, (), generator=self.host))
               for _ in range(n)]
        self.values[self.drawn:] = new
        vals = torch.tensor(new, dtype=torch.int64)
        if self.seeds is None:
            self.seeds = torch.zeros(SEED_SLOTS, dtype=torch.int64,
                                     device=self.device)
        dst = self.seeds[self.drawn:self.drawn + n]
        if self.device.type == "cuda":
            # the caching host allocator keeps the pinned block until the
            # copy has run
            dst.copy_(vals.pin_memory(), non_blocking=True)
        else:
            dst.copy_(vals)
        self.drawn += n

    def _start(self, n: int) -> None:
        self.drawn = self.slot = 0
        self._draw(n)

    def begin_step(self) -> None:
        """Draw a step's seeds (as many as the first step took), unless a
        group has drawn them."""
        if not self._grouped:
            self._start(self.per_step or 0)

    def end_step(self) -> None:
        if self._grouped:
            return
        if self.slot < self.drawn:
            raise RuntimeError(f"the step used {self.slot} of the "
                               f"{self.drawn} kernel seeds drawn for it")
        self.per_step = self.drawn

    @contextlib.contextmanager
    def group(self, steps: int):
        """`steps` steps that run with their seeds drawn at once (a CUDA
        graph of them, its capture and its warm-up): needs `per_step`."""
        if self.per_step is None:
            raise RuntimeError("a group of steps needs one step first")
        self._start(steps * self.per_step)
        self._grouped = True
        try:
            yield
        finally:
            self._grouped = False

    def kernel_seed(self) -> AF.DeviceSeed:
        if self.slot == self.drawn:
            self._draw(1)
        s = AF.DeviceSeed(self.seeds, self.slot)
        self.slot += 1
        return s

    # -- pipeline parallelism's streams, one a (stack, layer, microbatch) --
    def pipe_stream(self, stack: str, layer: int, mb: int) -> "PipeStream":
        """The stream of global layer `layer` of `stack` on microbatch
        `mb`: made once and reused by every step, so that a CUDA graph can
        register its generator."""
        key = (stack, layer, mb)
        s = self.streams.get(key)
        if s is None:
            s = self.streams[key] = PipeStream(self, key)
        return s

    def generators(self):
        """The device generators a CUDA graph of steps must register."""
        return [self.dev, self.spec, *(s.dev for s in self.streams.values())]

    # -- snapshots (warm-up and capture must leave the streams as found) --
    def dropout_state(self):
        """The state of the two dropout streams."""
        return self.host.get_state(), self.dev.get_state()

    def state(self):
        return (self.host.get_state(), self.dev.get_state(),
                self.spec.get_state(), self.drawn, self.slot,
                {k: s.dev.get_state() for k, s in self.streams.items()})

    def set_state(self, st) -> None:
        self.host.set_state(st[0])
        self.dev.set_state(st[1])
        self.spec.set_state(st[2])
        self.drawn, self.slot = st[3], st[4]
        for k, s in self.streams.items():    # those made since: as new
            if k in st[5]:
                s.dev.set_state(st[5][k])
            else:
                s.dev.manual_seed(s.seed)


class PipeStream(_Bits):
    """The dropout stream of one (stack, layer, microbatch) of the
    pipelined forward (JAX: ``fold_in`` of the layer key with the
    microbatch id): a device generator of its own, seeded from the run's
    seed and the key, draws its plain dropout's bits and its attention
    kernels' seeds (a one-element device tensor each). It depends on no
    stage, is not seeded during a capture, and a CUDA graph that
    registers it draws each replay's seeds on the device."""

    slot = 0    # no seed slots: `remat` rewinds nothing but `dev`

    def __init__(self, parent: DropoutRng, key: tuple):
        if _capturing(parent.device):
            raise RuntimeError("a pipeline dropout stream made under "
                               "CUDA-graph capture")
        self.device = parent.device
        self.seed = _hash63(f"{parent.seed}:{':'.join(map(str, key))}")
        self.dev = torch.Generator(device=self.device).manual_seed(self.seed)

    def kernel_seed(self) -> AF.DeviceSeed:
        return AF.DeviceSeed(self._drawn(lambda: torch.randint(
            0, 2 ** 63 - 1, (1,), generator=self.dev, device=self.device,
            dtype=torch.int64)), 0)


def remat(fn, rng: Optional["DropoutRng"], *args):
    """fn(*args) under activation checkpointing (the JAX package's
    jax.checkpoint around a layer): the layer's activations are dropped
    after the forward and recomputed in the backward. The recomputation
    must draw the SAME dropout masks and must not advance the streams a
    second time: it reads the first run's kernel-seed slots (the slot
    index set back) and, eagerly, redraws the plain dropout's bits (and a
    pipeline stream's kernel seeds) with `dev` set back to where the first
    run found it. Under CUDA-graph capture a generator's state cannot be
    set, so the first run keeps its draws for the recompute instead."""
    from torch.utils.checkpoint import checkpoint
    if rng is None:
        return checkpoint(fn, *args, use_reentrant=False)
    capturing = _capturing(rng.device)
    slot = rng.slot
    dev_before = None if capturing else rng.dev.get_state()
    tape: list = []
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            rng._record = tape if capturing else None
            try:
                return fn(*a)
            finally:
                rng._record = None
        slot_now = rng.slot
        dev_now = None if capturing else rng.dev.get_state()
        rng.slot = slot
        if capturing:
            rng._replay = iter(tape)
        else:
            rng.dev.set_state(dev_before)
        try:
            return fn(*a)
        finally:
            rng.slot, rng._replay = slot_now, None
            if not capturing:
                rng.dev.set_state(dev_now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


@functools.lru_cache(maxsize=None)
def _keep_scale(thresh: int, dtype: torch.dtype) -> float:
    """65536/thresh rounded to `dtype`, as a Python float (a step under
    CUDA-graph capture makes no host-to-device copy)."""
    return float(torch.tensor(65536.0 / thresh, dtype=dtype))


def dropout(x: torch.Tensor, rate: float, rng: Optional[DropoutRng] = None,
            bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout with a uint16 integer-compare mask: keep where
    bits < round((1-rate)·2^16), scale by 65536/thresh in x's dtype;
    zeros when the threshold rounds to 0. `bits` (uint16 values, x's
    shape) replace the draw from `rng` (tests pass numpy bits)."""
    if rate <= 0.0:
        return x
    thresh = dropout_thresh16(rate)
    if thresh >= 65536:
        return x
    if thresh <= 0:
        return torch.zeros_like(x)
    if bits is None:
        bits = rng.bits16(x.shape, x.device)
    return torch.where(bits < thresh, x * _keep_scale(thresh, x.dtype),
                       torch.zeros_like(x))


def dropout_rows(x: torch.Tensor, rate: float, rng: DropoutRng,
                 seq: bool = False) -> torch.Tensor:
    """`dropout` of (B, T, H) x; under sequence parallelism (`seq`) x is
    this rank's T slice and its mask is that slice of the mask drawn for
    the whole sequence, so the streams advance as without it."""
    if not (seq and tp.active()) or rate <= 0.0:
        return dropout(x, rate, rng)
    lo, T = tp.seq_rows(x.shape[1])
    thresh = dropout_thresh16(rate)
    bits = (rng.bits16((x.shape[0], T, x.shape[2]), x.device)
            [:, lo:lo + x.shape[1]] if 0 < thresh < 65536 else None)
    return dropout(x, rate, rng, bits=bits)


def dense(p: Params, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w + b, or the low-rank (x @ u) @ v + b when p holds "u"/"v"
    (Low-Rank Transformer, Winata et al. ICASSP 2020), or the int8
    weight-only product when p holds "q8"/"scale" (models/quantize.py).
    Operands are cast to `dtype`; the bias is added in the product's
    dtype.

    Under tensor parallelism a column-parallel shard (mha q/k/v, ffn w1)
    holds its columns of ``b`` while ``v``, ``q8`` and ``scale`` stay
    whole (parallel/tp.py): the product takes their columns of this
    rank, after ``x @ u`` computed whole."""
    if dtype is not None:
        x = x.to(dtype)
    b = p.get("b")
    if "q8" in p:
        # int8 values are exact in bf16, so the cast loses nothing; the
        # scale multiplies in f32
        q8, scale = shard_cols(p["q8"], b, 1), shard_cols(p["scale"], b, 0)
        w = q8.to(dtype or x.dtype)
        return _int8_epilogue(x @ w, scale, b)
    if "u" in p:
        u, v = p["u"], shard_cols(p["v"], b, 1)
        if dtype is not None:
            u, v = u.to(dtype), v.to(dtype)
        w, x = v, x @ u
    else:
        w = p["w"] if dtype is None else p["w"].to(dtype)
    return Fn.linear(x, w.T, None if b is None else b.to(w.dtype))


def shard_cols(t: torch.Tensor, b: Optional[torch.Tensor],
               dim: int) -> torch.Tensor:
    """`t` (a low-rank ``v``, an int8 ``q8`` or ``scale``), or this model
    rank's columns of it where the bias is a shard's."""
    if b is None or b.shape[0] == t.shape[dim]:
        return t
    return tp.model_part(t, dim, b.shape[0])


def _int8_epilogue(xw: torch.Tensor, scale: torch.Tensor,
                   b: Optional[torch.Tensor]) -> torch.Tensor:
    """The int8 product's per-output-channel scale, in f32, and its
    bias, from x @ q8 in the compute dtype."""
    y = (xw.to(torch.float32) * scale).to(xw.dtype)
    return y if b is None else y + b.to(y.dtype)


def row_dense(p: Params, x: torch.Tensor, dtype: torch.dtype,
              seq: bool = False) -> torch.Tensor:
    """The row-parallel product (mha out, ffn w2) in f32: `dense` on one
    rank; under tensor parallelism the rank's partial product, summed
    over the model group by `tp.row_exit` (this rank's T slice of the sum
    under sequence parallelism), and then the bias, added once. The
    partial products take the operands rounded to `dtype` and sum in
    f32, and the sum rounds to `dtype` once, as `dense`'s one product
    does on one rank (bf16 products accumulate in f32). A low-rank
    layer's partial product is x @ (this rank's rows of ``u``), r
    columns wide: ``v`` and the bias apply to its sum; an int8 layer's
    is x @ (its rows of ``q8``): the whole ``scale`` and the bias apply
    to its sum."""
    if not tp.active():
        return dense(p, x, dtype).to(torch.float32)
    f32 = torch.float32
    x = x.to(dtype).to(f32)
    part = lambda t: tp.model_part(t, 0, x.shape[-1]).to(dtype).to(f32)
    if "u" in p:
        xu = tp.row_exit(x @ part(p["u"]), seq).to(dtype)
        return dense({"w": p["v"], "b": p["b"]}, xu, dtype).to(f32)
    if "q8" in p:
        xw = tp.row_exit(x @ part(p["q8"]), seq).to(dtype)
        return _int8_epilogue(xw, p["scale"], p["b"]).to(f32)
    y = x @ p["w"].to(dtype).to(f32)
    y = tp.row_exit(y, seq) + p["b"].to(dtype).to(f32)
    return y.to(dtype).to(f32)


def local_heads(num_heads: int) -> int:
    """The heads of this rank's shard of an attention layer."""
    return num_heads // mesh.model_size()


def layer_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (biased variance, eps inside
    the rsqrt, as torch.nn.LayerNorm), returned in x's dtype."""
    y = Fn.layer_norm(x.to(torch.float32), x.shape[-1:], p["scale"],
                      p["bias"], LN_EPS)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Masks (reference: models/common_layers.py:28-74)
# ---------------------------------------------------------------------------

def non_pad_mask_from_lengths(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T, 1) float mask, 1.0 where t < length. Lengths larger than T
    mask nothing (common_layers.py:37-38) — which is what makes the
    post-conv encoder masks a no-op when raw frame lengths are passed."""
    t = torch.arange(T, device=lengths.device)[None, :]
    return (t < lengths[:, None]).to(torch.float32)[:, :, None]


def non_pad_mask_from_pad(seq: torch.Tensor, pad_idx: int) -> torch.Tensor:
    """(B, T, 1) float mask, 1.0 where token != pad_idx
    (common_layers.py:39-42)."""
    return (seq != pad_idx).to(torch.float32)[:, :, None]


def attn_key_pad_mask(seq_k: torch.Tensor, pad_idx: int,
                      len_q: int) -> torch.Tensor:
    """(B, T_q, T_k) bool, True = masked (common_layers.py:46-55)."""
    pad = seq_k == pad_idx
    return pad[:, None, :].expand(seq_k.shape[0], len_q, seq_k.shape[1])


def subsequent_mask(B: int, T: int, device=None) -> torch.Tensor:
    """(B, T, T) bool causal mask, True = masked (common_layers.py:66-74)."""
    m = torch.triu(torch.ones((T, T), dtype=torch.bool, device=device),
                   diagonal=1)
    return m[None].expand(B, T, T)


def attn_pad_mask_from_lengths(lengths: torch.Tensor, T_k: int,
                               len_q: int) -> torch.Tensor:
    """(B, T_q, T_k) bool, True = masked key positions >= length
    (common_layers.py:57-64)."""
    t = torch.arange(T_k, device=lengths.device)[None, :]
    pad = t >= lengths[:, None]
    return pad[:, None, :].expand(lengths.shape[0], len_q, T_k)


def attn_bias(mask: torch.Tensor) -> torch.Tensor:
    """The fused attention kernel's f32 additive form of a (B, T_q, T_k)
    bool mask: -1e9 where masked, else 0."""
    return torch.where(mask, AF.MASK_BIAS, 0.0).to(torch.float32)


def train_attn_bias(mask: torch.Tensor, dropout_rate: float,
                    rng: Optional[DropoutRng]) -> Optional[torch.Tensor]:
    """attn_bias(mask) when training with dropout (the kernel route of
    `mha`), else None: a training forward builds it once and hands it to
    every layer that shares the mask."""
    if rng is None or dropout_rate <= 0.0:
        return None
    return attn_bias(mask)


# ---------------------------------------------------------------------------
# Sinusoidal positional encoding (common_layers.py:76-98)
# ---------------------------------------------------------------------------

def sinusoid_table(max_length: int, dim_model: int) -> torch.Tensor:
    """(max_length, dim_model) f32 table, identical layout to the
    reference buffer: even columns sin, odd columns cos."""
    position = np.arange(max_length, dtype=np.float32)[:, None]
    exp_term = np.exp(np.arange(0, dim_model, 2, dtype=np.float32)
                      * -(math.log(10000.0) / dim_model))
    pe = np.zeros((max_length, dim_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * exp_term)
    pe[:, 1::2] = np.cos(position * exp_term)
    return torch.from_numpy(pe)


# ---------------------------------------------------------------------------
# Multi-head attention (common_layers.py:144-225)
# ---------------------------------------------------------------------------

def mha(p: Params, query: torch.Tensor, key_: torch.Tensor,
        value: torch.Tensor, num_heads: int, dim_key: int, dim_value: int,
        mask: Optional[torch.Tensor] = None,
        dtype: torch.dtype = torch.bfloat16, dropout_rate: float = 0.0,
        rng: Optional[DropoutRng] = None,
        bias: Optional[torch.Tensor] = None,
        seq: bool = False) -> torch.Tensor:
    """Post-LN residual MHA. query/key_/value: (B, T, H). mask: (B, T_q,
    T_k) bool, True = masked (-inf before the softmax). The projections
    and both attention products run in `dtype`; the softmax and the
    residual/LayerNorm run in float32. With `rng` (training) and
    dropout_rate > 0, the attention probabilities and the output
    projection are dropped; with a mask the attention runs through the
    fused kernel (flash_mha_train), as the JAX package's training path,
    with `bias` (attn_bias(mask), built here when not given).

    Under tensor parallelism (parallel/tp.py) this rank's shard runs
    num_heads / M local heads; `seq` (encoder self-attention under
    sequence parallelism) takes query = key_ = value as this rank's T
    slice and returns its slice."""
    residual = query
    if tp.active():
        num_heads = local_heads(num_heads)
        same = key_ is query
        cross = value is key_
        query = tp.column_entry(query, seq)
        key_ = query if same else tp.column_entry(key_)
        value = key_ if cross else tp.column_entry(value)
    B, Tq, _ = query.shape
    Tk = key_.shape[1]
    q = dense(p["q"], query, dtype).reshape(B, Tq, num_heads, dim_key)
    k = dense(p["k"], key_, dtype).reshape(B, Tk, num_heads, dim_key)
    v = dense(p["v"], value, dtype).reshape(B, Tk, num_heads, dim_value)

    training = rng is not None and dropout_rate > 0.0
    if (training and dropout_thresh16(dropout_rate) > 0
            and mask is not None):
        if bias is None:
            bias = attn_bias(mask)
        # the kernels read the projections through their strides, and
        # the card's out lies in (B, Tq, H, D) memory: no copy either way;
        # the tracer's site ATTENTION_FORWARD (a profiler range where a
        # tool names one, tools/probe_step.py)
        with profiling.RECORDER.range(ATTENTION_FORWARD):
            out = AF.flash_mha_train(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), bias,
                                     rng.kernel_seed(), dropout_rate)
            out = out.transpose(1, 2).reshape(B, Tq, num_heads * dim_value)
    else:
        scale = 1.0 / math.sqrt(dim_key)  # temperature = sqrt(dim_key)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
        if mask is not None:
            attn = attn.masked_fill(mask[:, None, :, :], float("-inf"))
        attn = torch.softmax(attn, dim=-1).to(dtype)
        if training:
            attn = dropout(attn, dropout_rate, rng)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(
            B, Tq, num_heads * dim_value)
    out = row_dense(p["out"], out.to(dtype), dtype, seq)
    if training:
        out = dropout_rows(out, dropout_rate, rng, seq)
    return layer_norm(p["ln"], out + residual)


# ---------------------------------------------------------------------------
# Position-wise FFN, conv-kernel-1 variant (common_layers.py:124-142)
# ---------------------------------------------------------------------------

def ffn(p: Params, x: torch.Tensor,
        dtype: torch.dtype = torch.bfloat16, dropout_rate: float = 0.0,
        rng: Optional[DropoutRng] = None, seq: bool = False) -> torch.Tensor:
    """Post-LN residual FFN; under tensor parallelism on this rank's
    dim_inner / M inner columns (and T slice, with `seq`)."""
    residual = x
    h = torch.relu(dense(p["w1"], tp.column_entry(x, seq), dtype))
    h = row_dense(p["w2"], h, dtype, seq)
    if rng is not None:
        h = dropout_rows(h, dropout_rate, rng, seq)
    return layer_norm(p["ln"], h + residual)
