"""Plain PyTorch reference of the Speech-Transformer the benchmark runs.

Follows the published model (gentaiscool/end2end-asr-pytorch: the
librosa log-magnitude STFT with per-utterance mean / unbiased std, the
VGG front end, post-LN Transformer encoder and decoder, manual label
smoothing, Noam-scheduled Adam) in float32 with plain operations: no
kernels of the program, no caches, no batching tricks. Low-rank layers
(the LRT of Winata et al., ICASSP 2020) are the two products x @ u @ v.

Dropout draws the same random numbers the program's run draws from the
same seed, so that a training step can be followed exactly:
  * attention probabilities: Philox4x32-10 with counter
    (key // 4, query, head, row) and key (seed low, seed high) words, word
    key % 4 of the block, kept where the word < round(0.9 * 2^16) * 2^16;
    one 63-bit seed a call, drawn from a CPU generator seeded with the
    run's seed, in the order the attention calls run;
  * other activations: uint16 draws (int32 `randint` over [0, 2^16)) from
    a generator on the device seeded with the run's seed + 1, kept below
    the same threshold, scaled by 2^16 / threshold.

`Precision("fp8")` rounds every product's operands to float8 e4m3 with a
per-tensor scale: the benchmark's control, one step below the bfloat16
the configurations compute in.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

PAD, SOS, EOS = 0, 1, 2
SEP = "::"
LN_EPS = 1e-5
ADAM_BETAS, ADAM_EPS = (0.9, 0.98), 1e-9


class Precision:
    """Rounding of a product's operands: "f32" leaves them, "fp8" rounds
    them to float8 e4m3 under a per-tensor scale (amax to 448)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        amax = x.detach().abs().amax().clamp_min(1e-30)
        s = amax / 448.0
        r = (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return x + (r - x).detach()     # rounded forward, plain gradient


F32 = Precision("f32")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- the random streams -----------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    ah, al = a >> 16, a & 0xFFFF
    mh, ml = m >> 16, m & 0xFFFF
    mid = ah * ml + al * mh
    t = al * ml + ((mid & 0xFFFF) << 16)
    return (ah * mh + (mid >> 16) + (t >> 32)) & _MASK32, t & _MASK32


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC 2011) on int64 tensors holding
    uint32 words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def attention_keep(seed: int, B: int, H: int, Tq: int, Tk: int,
                   thresh16: int, device) -> torch.Tensor:
    """(B, H, Tq, Tk) bool keep mask of one attention call."""
    s = seed & 0xFFFFFFFFFFFFFFFF
    kw = (Tk + 3) // 4
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    shape = (B, H, Tq, kw)
    words = philox(ar(kw).view(1, 1, 1, kw).expand(shape),
                   ar(Tq).view(1, 1, Tq, 1).expand(shape),
                   ar(H).view(1, H, 1, 1).expand(shape),
                   ar(B).view(B, 1, 1, 1).expand(shape),
                   s & _MASK32, s >> 32)
    bits = torch.stack(words, -1).reshape(B, H, Tq, 4 * kw)[..., :Tk]
    return bits < thresh16 * 65536


class Dropout:
    """The training run's dropout streams (module docstring)."""

    def __init__(self, seed: int, rate: float, device):
        self.thresh = int(round((1.0 - rate) * 65536.0))
        self.scale = 65536.0 / self.thresh
        self.device = torch.device(device)
        self.host = torch.Generator().manual_seed(seed)
        self.dev = torch.Generator(device=self.device).manual_seed(seed + 1)

    def state(self):
        return self.host.get_state(), self.dev.get_state()

    def set_state(self, st) -> None:
        self.host.set_state(st[0])
        self.dev.set_state(st[1])

    def attention_seed(self) -> int:
        return int(torch.randint(0, 2 ** 63 - 1, (), generator=self.host))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        bits = torch.randint(0, 65536, tuple(x.shape), generator=self.dev,
                             device=self.device, dtype=torch.int32)
        return torch.where(bits < self.thresh, x * self.scale,
                           torch.zeros_like(x))


# -- features -----------------------------------------------------------------

def hamming(n: int) -> torch.Tensor:
    """The symmetric Hamming window (scipy.signal.hamming(n))."""
    k = np.arange(n, dtype=np.float64)
    return torch.from_numpy(0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1)))


def frames_of(n_samples: int, n_fft: int, hop: int) -> int:
    """librosa's centred frame count."""
    return 1 + n_samples // hop


def padded_pcm(utts: Sequence[np.ndarray], T: int, n_fft: int,
               hop: int) -> torch.Tensor:
    """(B, (T-1)·hop + n_fft) float32: each int16 utterance cut to the
    samples of T frames, reflect-padded by n_fft/2 at both ends (librosa
    center=True) and zero-filled, scaled by 1/32768."""
    n = (T - 1) * hop
    pad = n_fft // 2
    out = np.zeros((len(utts), n + 2 * pad), np.float32)
    for i, y in enumerate(utts):
        y = np.pad(np.asarray(y[:n], np.float32), pad, mode="reflect")
        out[i, :min(len(y), out.shape[1])] = y[:out.shape[1]]
    return torch.from_numpy(out / 32768.0)


def features(pcm: torch.Tensor, n_frames: torch.Tensor, n_fft: int,
             hop: int, T: int) -> torch.Tensor:
    """log1p |STFT| of T frames, zero past each utterance's frames,
    normalised by its mean and unbiased std over its valid frames:
    (B, n_fft/2 + 1, T) float32."""
    win = hamming(n_fft).to(pcm.device)
    fr = pcm.to(torch.float64).unfold(1, n_fft, hop)[:, :T] * win
    spect = torch.log1p(torch.fft.rfft(fr, dim=-1).abs())   # (B, T, F)
    valid = (torch.arange(T, device=pcm.device)[None, :]
             < n_frames[:, None]).to(spect.dtype)[:, :, None]
    spect = spect * valid
    count = n_frames.to(spect.dtype)[:, None, None] * spect.shape[2]
    mean = spect.sum(dim=(1, 2), keepdim=True) / count
    var = ((spect - mean) ** 2 * valid).sum(dim=(1, 2), keepdim=True) \
        / (count - 1)
    spect = (spect - mean) / var.sqrt() * valid
    return spect.transpose(1, 2).to(torch.float32).contiguous()


# -- the model ------------------------------------------------------------------

def dense(p, x, prec: Precision):
    if "u" in p:
        y = prec(prec(x) @ prec(p["u"])) @ prec(p["v"])
    else:
        y = prec(x) @ prec(p["w"])
    return y + p["b"] if "b" in p else y


def layer_norm(p, x):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], LN_EPS)


def conv3x3(x, p, prec: Precision):
    w = p["w"].permute(3, 2, 0, 1)          # stored (kh, kw, in, out)
    return F.conv2d(prec(x), prec(w), padding=1) + p["b"][None, :, None,
                                                          None]


def vgg(p, spect, prec: Precision):
    """(B, F, T) → (B, T/4, 128·(F/4)), feature index c·F' + f."""
    x = spect[:, None]
    x = F.relu(conv3x3(x, p["conv1"], prec))
    x = F.max_pool2d(F.relu(conv3x3(x, p["conv2"], prec)), 2)
    x = F.relu(conv3x3(x, p["conv3"], prec))
    x = F.max_pool2d(F.relu(conv3x3(x, p["conv4"], prec)), 2)
    B, C, Fq, Tq = x.shape
    return x.permute(0, 3, 1, 2).reshape(B, Tq, C * Fq)


def mha(p, xq, xkv, heads: int, dk: int, dv: int, mask, drop, prec):
    """Post-LN multi-head attention; `mask` (B, Tq, Tk) bool, True =
    masked, or None."""
    B, Tq, _ = xq.shape
    Tk = xkv.shape[1]
    q = dense(p["q"], xq, prec).view(B, Tq, heads, dk).transpose(1, 2)
    k = dense(p["k"], xkv, prec).view(B, Tk, heads, dk).transpose(1, 2)
    v = dense(p["v"], xkv, prec).view(B, Tk, heads, dv).transpose(1, 2)
    s = prec(q) @ prec(k).transpose(-1, -2) / math.sqrt(dk)
    if mask is not None:
        s = s.masked_fill(mask[:, None], float("-inf"))
    a = torch.softmax(s, dim=-1)
    if drop is not None:
        keep = attention_keep(drop.attention_seed(), B, heads, Tq, Tk,
                              drop.thresh, xq.device)
        a = torch.where(keep, a * drop.scale, torch.zeros_like(a))
    o = (prec(a) @ prec(v)).transpose(1, 2).reshape(B, Tq, heads * dv)
    o = dense(p["out"], o, prec)
    if drop is not None:
        o = drop(o)
    return layer_norm(p["ln"], o + xq)


def ffn(p, x, drop, prec):
    h = dense(p["w2"], F.relu(dense(p["w1"], x, prec)), prec)
    if drop is not None:
        h = drop(h)
    return layer_norm(p["ln"], h + x)


def encoder(p, feats, dims, drop, prec):
    """The encoder over every frame (the published model passes raw
    frame counts to its masks, which then mask nothing past the 4x
    subsampling)."""
    T = feats.shape[1]
    x = layer_norm(p["ln_input"], dense(p["input_linear"], feats, prec))
    x = x + p["pe"][:T]
    for lp in p["layers"]:
        x = mha(lp["self_attn"], x, x, *dims, None, drop, prec)
        x = ffn(lp["ffn"], x, drop, prec)
    return x


def decoder(p, seq_in, enc, dims, drop, prec):
    """Logits (B, U, V) of the teacher-forced decoder. In training the
    published model takes EOS for padding: positions holding EOS are
    zeroed and masked as keys."""
    B, U = seq_in.shape
    causal = torch.triu(torch.ones(U, U, dtype=torch.bool,
                                   device=seq_in.device), 1)[None]
    pad = seq_in == EOS
    self_mask = pad[:, None, :] | causal
    non_pad = (~pad).to(torch.float32)[:, :, None]
    x = p["embedding"][seq_in] + p["pe"][:U]
    if drop is not None:
        x = drop(x)
    for lp in p["layers"]:
        x = mha(lp["self_attn"], x, x, *dims, self_mask, drop, prec) \
            * non_pad
        x = mha(lp["enc_attn"], x, enc, *dims, None, drop, prec) * non_pad
        x = ffn(lp["ffn"], x, drop, prec) * non_pad
    return prec(x) @ prec(p["output_linear"]["w"])


def decoder_io(targets: torch.Tensor):
    """(seq_in, gold) of SOS…EOS-wrapped, PAD-padded targets (B, U): the
    published model prepends SOS and pads the input with EOS, appends EOS
    to the gold and pads it with PAD."""
    B, U = targets.shape
    n = (targets != PAD).sum(1, keepdim=True)
    pos = torch.arange(U + 1, device=targets.device)[None]
    t = F.pad(targets, (0, 1), value=PAD)
    shifted = torch.cat([torch.full((B, 1), SOS, device=targets.device,
                                    dtype=targets.dtype), targets], 1)
    seq_in = torch.where(pos <= n, shifted, torch.full_like(shifted, EOS))
    gold = torch.where(pos < n, t, torch.where(pos == n,
                                               torch.full_like(t, EOS),
                                               torch.full_like(t, PAD)))
    return seq_in, gold


def smoothed_ce(logits, gold, eps: float):
    """Mean over non-PAD positions of -Σ q log p, q = 1-ε at the gold and
    ε/C elsewhere."""
    C = logits.shape[-1]
    logp = torch.log_softmax(logits.reshape(-1, C), -1)
    g = gold.reshape(-1)
    keep = g != PAD
    at = logp.gather(1, g.clamp_min(0)[:, None])[:, 0]
    loss = -((eps / C) * (logp.sum(-1) - at) + (1 - eps) * at)
    return loss[keep].sum() / keep.sum()


# -- trees ----------------------------------------------------------------------

def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}{SEP}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}{SEP}"))
        return out
    return {prefix[:-len(SEP)]: tree}


def unflatten(flat: Dict[str, torch.Tensor]):
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


FIXED = ("pe",)


def trainable(key: str) -> bool:
    return key.split(SEP)[-1] not in FIXED


# -- training -------------------------------------------------------------------

class Model:
    """The configuration's sizes the reference needs."""

    def __init__(self, cfg: dict):
        self.dims = (cfg["num_heads"], cfg["dim_key"], cfg["dim_value"])
        self.n_fft = int(cfg["sample_rate"] * cfg["window_size"])
        self.hop = int(cfg["sample_rate"] * cfg["window_stride"])
        self.dim_input = (self.n_fft // 2 + 1) // 4 * 128
        self.dropout = cfg["dropout"]
        self.smoothing = cfg["label_smoothing"]
        self.k_lr, self.warmup = cfg["k_lr"], cfg["warmup"]
        self.min_lr = cfg["min_lr"]

    def noam(self, step: int) -> float:
        return max(self.min_lr, self.k_lr * self.dim_input ** -0.5
                   * min(step ** -0.5, step * self.warmup ** -1.5))

    def loss(self, params, pcm, n_frames, targets, T, drop, prec):
        spect = features(pcm, n_frames, self.n_fft, self.hop, T)
        enc = encoder(params["encoder"], vgg(params["frontend"], spect,
                                             prec), self.dims, drop, prec)
        seq_in, gold = decoder_io(targets)
        logits = decoder(params["decoder"], seq_in, enc, self.dims, drop,
                         prec)
        return smoothed_ce(logits, gold, self.smoothing)

    def train(self, flat: Dict[str, torch.Tensor], batches: List,
              seed: int, prec: Precision = F32) -> dict:
        """Noam-Adam steps from `flat` (float32 leaves), one a batch
        (pcm, n_frames, targets, T) of `batches`, with the run's dropout
        streams. Returns each step's loss, the first step's gradients,
        the first moments and the parameters after the last step."""
        device = next(iter(flat.values())).device
        drop = Dropout(seed, self.dropout, device)
        keys = [k for k in flat if trainable(k)]
        theta = {k: v.detach().clone() for k, v in flat.items()}
        mu = {k: torch.zeros_like(theta[k]) for k in keys}
        nu = {k: torch.zeros_like(theta[k]) for k in keys}
        b1, b2 = ADAM_BETAS
        losses, first = [], None
        for step, (pcm, n_frames, targets, T) in enumerate(batches, 1):
            leaves = {k: (t.detach().requires_grad_() if k in mu
                          else t.detach()) for k, t in theta.items()}
            loss = self.loss(unflatten(leaves), pcm, n_frames, targets, T,
                             drop, prec)
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
            losses.append(float(loss.detach()))
            del loss
            if first is None:
                first = {k: g.detach() for k, g in zip(keys, grads)}
            lr = self.noam(step)
            with torch.no_grad():
                for k, g in zip(keys, grads):
                    mu[k].mul_(b1).add_(g, alpha=1 - b1)
                    nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    m_hat = mu[k] / (1 - b1 ** step)
                    v_hat = nu[k] / (1 - b2 ** step)
                    theta[k] = leaves[k].detach() - lr * m_hat / (
                        v_hat.sqrt() + ADAM_EPS)
            del leaves, grads
        return {"losses": losses, "first_grad": first, "mu": mu,
                "params": {k: theta[k] for k in keys}}
