"""One rank of tests/test_torch_parallel.py's 2-rank gloo group on the CPU.

`run` joins the group through a FileStore, runs every scenario once and
writes each one's results to `<root>/<scenario>.r<rank>.npz`; the tests
then assert on the files. It imports torch and the port, never jax: the
JAX package's references are computed in the test process. The inputs
(`spec.json`, the parameter and batch .npz files, a corpus) are written
there before the group starts.
"""

import json
import logging
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from end2end_asr_tpu_torch import test as port_test
from end2end_asr_tpu_torch import train as port_train
from end2end_asr_tpu_torch.config import Config
from end2end_asr_tpu_torch.models.layers import DropoutRng
from end2end_asr_tpu_torch.models.transformer import dims_from_config
from end2end_asr_tpu_torch.parallel.zero import ZeroShard
from end2end_asr_tpu_torch.training import checkpoint as TC
from end2end_asr_tpu_torch.training import optimizer as TO
from end2end_asr_tpu_torch.training import steps as TS

STEPS = 2    # CE; CTC and emb_cnn take one step (test_torch_parallel.py)


def load_tree(path):
    with np.load(path) as f:
        return TC.params_from_jax({k: f[k] for k in f.files})


def rank_batch(path, rank, world):
    """This rank's rows of a batch file, as the port's step takes them."""
    with np.load(path) as f:
        arrays = [f[k] for k in ("pcm", "n_frames", "targets",
                                 "tgt_lengths")]
    per = arrays[0].shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    return [torch.from_numpy(a[rows].astype(np.int64)
                             if a.dtype != np.float32 else a[rows].copy())
            for a in arrays]


def run_steps(cfg, params, batch, spect_T, state=None, zero_stage=0,
              rng_seed=None, steps=STEPS):
    """`steps` train steps of the port on this rank's batch; the results
    gathered to full buffers (and, without ZeRO, the moments after the
    first step)."""
    fp = TS.FlatParams(params, torch.device("cpu"))
    zero = (ZeroShard(fp.numel, dist.get_world_size(), dist.get_rank(),
                      zero_stage) if zero_stage else None)
    data = fp.data
    opt = TO.init_opt_state(cfg, data if zero is None else zero.shard(data))
    if zero is not None and zero.stage == 3:
        data = zero.shard(data)
    step = TS.make_train_step_impl(cfg, dims_from_config(cfg), zero=zero)
    rng = None if rng_seed is None else DropoutRng(rng_seed, "cpu")
    out = {"loss": [], "num_correct": [], "num_token": [], "lr": []}
    first = {}
    for i in range(steps):
        data, opt, state, m, _, _ = step(fp, data, opt, rng, *batch,
                                         spect_T, model_state=state)
        for k in out:
            out[k].append(float(m[k]))
        if i == 0 and zero is None:     # the moments of the first step
            first = {"mu1": opt["mu"].numpy(), "nu1": opt["nu"].numpy()}
    if zero is not None:
        opt = zero.gather_opt(opt)
        if zero.stage == 3:
            data = zero.gather(data)
    res = {k: np.asarray(v) for k, v in out.items()}
    res.update(first)
    res.update(data=data.numpy(), mu=opt["mu"].numpy(),
               nu=opt["nu"].numpy(), step=int(opt["step"]))
    for k, v in TC.flatten_params(state or {}).items():
        res["state::" + k] = v.numpy()
    return res


def scenario_steps(rank, world, root, spec):
    cfg = Config.from_dict(spec["cfg"])
    params = load_tree(os.path.join(root, "params.npz"))
    T = spec["T"]
    b = lambda name: rank_batch(os.path.join(root, name + ".npz"), rank,
                                world)
    out = {
        # CE with the interleaved split of the local batch
        "ce_accum2": run_steps(cfg.replace(grad_accum=2), params, b("ce"),
                               T),
        "ctc": run_steps(cfg.replace(loss="ctc"), params, b("ctc"), T,
                         steps=1),
        "spec_augment": run_steps(
            cfg.replace(spec_augment=True, freq_mask_width=20,
                        time_mask_width=20), params, b("ce"), T,
            rng_seed=3),
    }
    # ZeRO-1 and FSDP against plain data parallelism, with the clip on
    zcfg = cfg.replace(grad_accum=2, clip=True, max_norm=0.5)
    for name, stage in (("plain", 0), ("zero1", 1), ("fsdp", 3)):
        out["clip_" + name] = run_steps(zcfg, params, b("ce"), T,
                                        zero_stage=stage)
    ecfg = Config.from_dict(spec["emb_cfg"])
    out["emb_cnn"] = run_steps(ecfg, load_tree(
        os.path.join(root, "emb_params.npz")), b("emb"), T,
        state=load_tree(os.path.join(root, "emb_state.npz")), steps=1)
    return out


def scenario_entry_points(rank, world, root, spec):
    """train --parallel (plain, --zero1, --fsdp: one epoch each, a
    checkpoint each), then test --parallel --verbose on the plain run's
    checkpoint: its HYP lines and metrics."""
    os.chdir(root)
    for name, extra in (("plain", []), ("zero1", ["--zero1"]),
                        ("fsdp", ["--fsdp"])):
        port_train.main(spec["train_argv"] + ["--name", name, "--parallel",
                                              "--device", "cpu", *extra])
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    log = logging.getLogger("end2end_asr_tpu_torch")
    log.addHandler(handler)
    try:
        res = port_test.main(spec["test_argv"] + ["--parallel", "--verbose",
                                                  "--device", "cpu"])
    finally:
        log.removeHandler(handler)
    hyps = [ln for ln in lines if ln.startswith("HYP: ")]
    return {"eval": {"hyps": np.asarray(hyps, dtype=str),
                     "cer": np.asarray(res.get("cer", -1.0))}}


def run(rank, world, root):
    torch.set_num_threads(2)
    store = dist.FileStore(os.path.join(root, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    try:
        with open(os.path.join(root, "spec.json")) as f:
            spec = json.load(f)
        for scenario in (scenario_steps, scenario_entry_points):
            for name, res in scenario(rank, world, root, spec).items():
                np.savez(os.path.join(root, f"{name}.r{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
