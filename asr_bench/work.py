"""The work a step or a kernel call must do, computed from shapes.

Model FLOPs count a product of (m, k) by (k, n) as 2·m·k·n and nothing
else (no softmax, norms or elementwise work); a training step is the
forward and its backward (twice the forward's products), with no
recompute, less the first convolution's input gradient, which nothing
needs. They are counted at each utterance's real frames and target
length, so padding lowers the shares built on them.

A kernel's bound is the larger of its operations over the peak FLOP/s
and its bytes over the peak bandwidth, each input byte read once and
each output byte written once, at the shapes it is called with.

Peaks: one NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data
sheet).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _dense(n: int, d_in: int, d_out: int, rank: int = 0) -> float:
    if rank and 0 < rank < min(d_in, d_out):
        return 2.0 * n * rank * (d_in + d_out)
    return 2.0 * n * d_in * d_out


def forward_flops(cfg: dict, vocab: int, frames: int, tgt_len: int,
                  ) -> Dict[str, float]:
    """Forward FLOPs of one utterance of `frames` spectrogram frames and
    a decoder input of `tgt_len` positions, by part."""
    F = int(cfg["sample_rate"] * cfg["window_size"]) // 2 + 1
    dm, di, r = cfg["dim_model"], cfg["dim_inner"], cfg.get("rank", 0)
    nk = cfg["num_heads"] * cfg["dim_key"]
    nv = cfg["num_heads"] * cfg["dim_value"]
    T2, F2 = frames // 2, F // 2
    Te, U = frames // 4, tgt_len
    out = {"conv1": 2.0 * 9 * 64 * F * frames,
           "conv2": 2.0 * 9 * 64 * 64 * F * frames,
           "conv3": 2.0 * 9 * 64 * 128 * F2 * T2,
           "conv4": 2.0 * 9 * 128 * 128 * F2 * T2}

    def attn(nq, nkv):
        return (_dense(nq, dm, nk, r) + _dense(nkv, dm, nk, r)
                + _dense(nkv, dm, nv, r) + _dense(nq, nv, dm, r)
                + 2.0 * nq * nkv * (nk + nv))

    def ffn(n):
        return _dense(n, dm, di, r) + _dense(n, di, dm, r)

    L = cfg["num_layers"]
    out["encoder"] = (_dense(Te, F // 4 * 128, dm)
                      + L * (attn(Te, Te) + ffn(Te)))
    out["decoder"] = L * (attn(U, U) + attn(U, Te) + ffn(U))
    out["output"] = _dense(U, dm, vocab)
    return out


def train_step_flops(cfg: dict, vocab: int,
                     rows: Iterable[Tuple[int, int]]) -> float:
    """Model FLOPs of one training step over rows of (frames, decoder
    positions)."""
    total = 0.0
    for frames, u in rows:
        f = forward_flops(cfg, vocab, frames, u)
        total += 3.0 * sum(f.values()) - f["conv1"]
    return total


# -- kernels ----------------------------------------------------------------

def vgg_block1(B: int, F: int, T: int, size: int = 2) -> Dict[str, float]:
    """The fused VGG block 1 (conv 1→64, relu, conv 64→64, relu, 2x2 max
    pool) at x (B, F, T) in a compute type of `size` bytes: conv2 and its
    weight gradient at the 2F'x2T' positions the pool keeps, conv1 (and,
    backward, its recompute and weight gradient and conv2's input
    gradient) at all F x T; bytes: x and the weights read once, the
    pooled output and its argmax index written once, and backward the
    pooled gradient, output and index read once and the weight gradients
    written once."""
    keep, full = B * (F // 2 * 2) * (T // 2 * 2), B * F * T
    pooled = B * (F // 2) * (T // 2) * 64
    wts = 9 * 64 + 64 + 576 * 64 + 64
    return {"fwd_flop": 2.0 * 64 * (keep * 576 + full * 9),
            "bwd_flop": 2.0 * 64 * ((keep + full) * 576 + 2 * full * 9),
            "fwd_bytes": 4.0 * (full + wts) + (size + 1) * pooled,
            "bwd_bytes": (4.0 * (full + wts) + (2 * size + 1) * pooled
                          + 4 * wts)}


def attention_bwd(B: int, H: int, Tq: int, Tk: int, D: int,
                  size: int = 2) -> Dict[str, float]:
    """The attention backward of one call: dV = Pᵀ dO, dP = dO Vᵀ,
    dQ = dS K, dK = dSᵀ Q (8·B·H·Tq·Tk·D); bytes: q, k, v, out and dout
    read (compute type), the f32 softmax statistics and additive mask
    read, dq, dk, dv written."""
    qo = B * H * Tq * D
    kv = B * H * Tk * D
    return {"flop": 8.0 * B * H * Tq * Tk * D,
            "bytes": size * (3 * qo + 2 * kv) + 4.0 * B * H * Tq
            + 4.0 * B * Tq * Tk + size * (qo + 2 * kv)}


def bound_s(flop: float, nbytes: float,
            peak: float = PEAK_BF16_FLOPS) -> float:
    return max(flop / peak, nbytes / PEAK_BYTES)
