"""Seeded weights of a configuration, made on the device in one draw.

The layout is the model's parameter tree (nested dicts, lists for the
layer stacks): the front end's four 3x3 convolutions stored (kh, kw, in,
out), the encoder's input projection, LayerNorms and layers, the
decoder's embedding, layers and output projection, and the two
sinusoid tables ("pe"), which are not trained. Dense weights are
(in, out); a low-rank layer holds "u" (in, rank) and "v" (rank, out).
Init laws: Xavier-uniform weights, biases uniform in ±1/sqrt(fan_in),
LayerNorm scale 1 and bias 0. One `torch.rand` over every random leaf
from a generator on the device, then a scale a leaf.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from asr_bench.reference.model import SEP, unflatten


def _dense(name: str, d_in: int, d_out: int, rank: int = 0,
           bias: bool = True) -> List[Tuple]:
    xav = lambda a, b: math.sqrt(6.0 / (a + b))
    if rank and 0 < rank < min(d_in, d_out):
        out = [(f"{name}{SEP}u", (d_in, rank), xav(d_in, rank)),
               (f"{name}{SEP}v", (rank, d_out), xav(rank, d_out))]
    else:
        out = [(f"{name}{SEP}w", (d_in, d_out), xav(d_in, d_out))]
    if bias:
        out.append((f"{name}{SEP}b", (d_out,), 1.0 / math.sqrt(d_in)))
    return out


def _ln(name: str, dim: int) -> List[Tuple]:
    return [(f"{name}{SEP}scale", (dim,), "ones"),
            (f"{name}{SEP}bias", (dim,), "zeros")]


def layout(cfg: dict, vocab: int) -> List[Tuple]:
    """[(key, shape, bound or "ones" / "zeros" / "pe")] in tree order."""
    dm, r = cfg["dim_model"], cfg.get("rank", 0)
    nk, nv = cfg["num_heads"] * cfg["dim_key"], cfg["num_heads"] * \
        cfg["dim_value"]
    n_freq = int(cfg["sample_rate"] * cfg["window_size"]) // 2 + 1
    leaves: List[Tuple] = []
    for i, (cin, cout) in enumerate(((1, 64), (64, 64), (64, 128),
                                     (128, 128)), 1):
        fan_in, fan_out = cin * 9, cout * 9
        leaves += [(f"frontend{SEP}conv{i}{SEP}w", (3, 3, cin, cout),
                    math.sqrt(6.0 / (fan_in + fan_out))),
                   (f"frontend{SEP}conv{i}{SEP}b", (cout,),
                    1.0 / math.sqrt(fan_in))]

    def mha(name):
        return (_dense(f"{name}{SEP}q", dm, nk, r)
                + _dense(f"{name}{SEP}k", dm, nk, r)
                + _dense(f"{name}{SEP}v", dm, nv, r)
                + _dense(f"{name}{SEP}out", nv, dm, r)
                + _ln(f"{name}{SEP}ln", dm))

    def ffn(name):
        return (_dense(f"{name}{SEP}w1", dm, cfg["dim_inner"], r)
                + _dense(f"{name}{SEP}w2", cfg["dim_inner"], dm, r)
                + _ln(f"{name}{SEP}ln", dm))

    enc = "encoder"
    leaves += _dense(f"{enc}{SEP}input_linear", n_freq // 4 * 128, dm)
    leaves += _ln(f"{enc}{SEP}ln_input", dm)
    for i in range(cfg["num_layers"]):
        leaves += mha(f"{enc}{SEP}layers{SEP}{i}{SEP}self_attn")
        leaves += ffn(f"{enc}{SEP}layers{SEP}{i}{SEP}ffn")
    leaves.append((f"{enc}{SEP}pe", (cfg["src_max_len"], dm), "pe"))
    dec = "decoder"
    leaves.append((f"{dec}{SEP}embedding", (vocab, cfg["dim_emb"]),
                   math.sqrt(6.0 / (vocab + cfg["dim_emb"]))))
    for i in range(cfg["num_layers"]):
        leaves += mha(f"{dec}{SEP}layers{SEP}{i}{SEP}self_attn")
        leaves += mha(f"{dec}{SEP}layers{SEP}{i}{SEP}enc_attn")
        leaves += ffn(f"{dec}{SEP}layers{SEP}{i}{SEP}ffn")
    leaves.append((f"{dec}{SEP}pe", (cfg["tgt_max_len"] + 1, dm), "pe"))
    leaves += _dense(f"{dec}{SEP}output_linear", dm, vocab, bias=False)
    return leaves


def sinusoid(n: int, dim: int, device) -> torch.Tensor:
    """(n, dim): sin on even columns, cos on odd, 10000^(-2i/dim)."""
    pos = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    rate = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64,
                                  device=device) * -(math.log(1e4) / dim))
    pe = torch.zeros(n, dim, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * rate)
    pe[:, 1::2] = torch.cos(pos * rate)
    return pe.to(torch.float32)


def make_flat(cfg: dict, vocab: int, seed: int,
              device) -> Dict[str, torch.Tensor]:
    """{key: float32 leaf} of the configuration, drawn from `seed`."""
    leaves = layout(cfg, vocab)
    drawn = [(k, s, b) for k, s, b in leaves if not isinstance(b, str)]
    total = sum(math.prod(s) for _, s, _ in drawn)
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    flat, off = {}, 0
    for key, shape, bound in leaves:
        if bound == "ones":
            flat[key] = torch.ones(shape, device=device)
        elif bound == "zeros":
            flat[key] = torch.zeros(shape, device=device)
        elif bound == "pe":
            flat[key] = sinusoid(shape[0], shape[1], device)
        else:
            n = math.prod(shape)
            flat[key] = (u[off:off + n] * bound).view(shape)
            off += n
    return flat


def make_tree(cfg: dict, vocab: int, seed: int, device):
    return unflatten(make_flat(cfg, vocab, seed, device))
