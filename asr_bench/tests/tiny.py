"""A cell of the benchmark cut to a size the CPU runs in seconds: 8 kHz
audio of 1-2 s (81 frequency bins, the 200-frame bucket), one layer of
width 64, batch 2, two steps a dispatch; the cell's own limits."""

import argparse
import time

import torch

from asr_bench import core
from asr_bench import run as R

TRAIN = "aishell_vgg.train_k4"


def files(cell: str, **over):
    bench = core.benchmark()
    c, config, traffic, limits = core.cell_files(cell, bench)
    config = dict(config, sample_rate=8000, num_layers=1, dim_model=64,
                  num_heads=2, dim_key=32, dim_value=32, dim_inner=128,
                  dim_emb=64)
    config.update({k: v for k, v in over.items() if k in config
                   or k in ("rank", "model", "dtype")})
    traffic = dict(traffic, batch=2, pool_batches=4,
                   seconds=[1.0, 1.99], steps_per_dispatch=2)
    return bench, (c, config, traffic, limits)


def run(cell: str, seed: int = 7, seconds: float = 0.5, **over):
    torch.set_num_threads(4)
    bench, f = files(cell, **over)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=0)
    return R.measure(args, torch.device("cpu"), time.time(), bench, f)
