#!/usr/bin/env python3
"""Which hand-off carries a pipeline stage's activations between two gloo
ranks that share one card?

Pipeline parallelism (parallel/pp.py) hands each microbatch's activation
from stage to stage, and its gradient back. One card takes several ranks
only over gloo (NCCL refuses two ranks on one device, parallel/mesh.py),
and gloo's point-to-point calls are documented for CPU tensors only. This
probe tries three hand-offs, in this order, each in a pair of fresh
processes (rank 0 and rank 1 on the same device, a 60 s group timeout, a
120 s limit on the pair, so that a crash or a hang ends only that arm):

  send_recv       ``dist.send`` / ``dist.recv`` of the device tensor;
  pair_broadcast  ``dist.broadcast`` over a group of the two ranks;
  host_staged     a copy into pinned host memory, ``send`` / ``recv`` of
                  the host tensor, a copy back to the device.

Each arm hands the train cell's two activations (batch 12 in 2
microbatches: the encoder's (6, 200, 512) and the decoder's (6, 24, 512),
f32) from rank 0 to rank 1 and a gradient (twice the value) back, checks
both exact, and times a hand-off (host clock, both sides synchronised,
median of REPS after one untimed). One JSON line: per arm whether it ran,
its error if not, its ms and MB/s per shape, and the card's line.

Run on the card:  python -m end2end_asr_tpu_torch.tools.probe_pipe_transport
On the CPU:       add --device cpu
"""

from __future__ import annotations

import argparse
import json
import socket
import statistics
import subprocess
import sys
import time
from datetime import timedelta

import torch
import torch.distributed as dist

ARMS = ("send_recv", "pair_broadcast", "host_staged")
SHAPES = {"encoder": (6, 200, 512), "decoder": (6, 24, 512)}
REPS = 20
ARM_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def hand_off(arm: str, t: torch.Tensor, src: int, dst: int, pair) -> None:
    """`t` of rank `src` into `t` of rank `dst`, by the arm's means."""
    me = dist.get_rank()
    if arm == "send_recv":
        (dist.send if me == src else dist.recv)(t, src if me == dst else dst)
    elif arm == "pair_broadcast":
        dist.broadcast(t, src=src, group=pair)
    else:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        if me == src:
            host.copy_(t)
            dist.send(host, dst)
        else:
            dist.recv(host, src)
            t.copy_(host, non_blocking=True)
            _sync(t.device)


def rank_main(arm: str, rank: int, port: int, device: str) -> None:
    """One rank of one arm: prints its JSON result (rank 0)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)     # both ranks' card
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=2, timeout=timedelta(seconds=60))
    pair = dist.new_group([0, 1])
    out = {"arm": arm, "ok": True, "shapes": {}}
    g = torch.Generator().manual_seed(7)
    for name, shape in SHAPES.items():
        x = torch.randn(shape, generator=g).to(dev)
        buf = x.clone() if rank == 0 else torch.zeros_like(x)
        ms = []
        for i in range(REPS + 1):
            if rank == 0:
                buf.copy_(x)
            _sync(dev)
            dist.barrier()
            t0 = time.perf_counter()
            hand_off(arm, buf, 0, 1, pair)          # the activation
            if rank == 1:
                ok = torch.equal(buf, x)
                buf.mul_(2.0)
            hand_off(arm, buf, 1, 0, pair)          # its gradient
            _sync(dev)
            if i:
                ms.append((time.perf_counter() - t0) * 1e3 / 2)
            if rank == 0:
                ok = torch.equal(buf, 2.0 * x)
            out["ok"] = out["ok"] and bool(ok)
        nbytes = x.numel() * x.element_size()
        med = statistics.median(ms)
        out["shapes"][name] = {"shape": list(shape), "bytes": nbytes,
                               "ms": med, "ms_min": min(ms),
                               "ms_max": max(ms),
                               "MB_per_s": nbytes / 1e6 / (med / 1e3)}
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out), flush=True)


def run_arm(arm: str, device: str) -> dict:
    """Both ranks of `arm` in fresh processes; rank 0's result, or why
    the arm did not run."""
    port = _free_port()
    cmd = lambda r: [sys.executable, "-m",
                     "end2end_asr_tpu_torch.tools.probe_pipe_transport",
                     "--rank", str(r), "--arm", arm, "--port", str(port),
                     "--device", device]
    procs = [subprocess.Popen(cmd(r), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=ARM_TIMEOUT_S))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate())
    codes = [p.returncode for p in procs]
    if codes != [0, 0]:
        return {"arm": arm, "ok": False, "exit_codes": codes,
                "error": " | ".join(e.strip()[-600:] for _, e in outs)}
    return json.loads(outs[0][0].strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--arm", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args.arm, args.rank, args.port, args.device)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    from end2end_asr_tpu_torch.tools.probe_lib import gpu_line
    res = {"device": args.device, "torch": torch.__version__,
           "gpu": gpu_line() if args.device.startswith("cuda") else None,
           "arms": [run_arm(a, args.device) for a in args.arms.split(",")]}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
