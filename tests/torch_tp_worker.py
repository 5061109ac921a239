"""The ranks of tests/test_torch_tp.py and tests/test_torch_dcp.py on the
CPU: one spawn of 4 processes a module, which first run the world-2
scenarios (ranks 0 and 1, --mesh-model 2) in a 2-rank gloo group and then
the world-4 ones (--mesh-data 2 --mesh-model 2) in a 4-rank group.

Each scenario's results go to `<root>/<scenario>.r<rank>.npz`; the tests
assert on the files. It imports torch and the port, never jax: the JAX
package's references are computed in the test process.
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
from end2end_asr_tpu_torch.evaluation import encode_pcm, prepare_params
from end2end_asr_tpu_torch.models.layers import DropoutRng
from end2end_asr_tpu_torch.models.transformer import dims_from_config
from end2end_asr_tpu_torch.parallel import mesh, tp
from end2end_asr_tpu_torch.parallel.zero import ZeroShard
from end2end_asr_tpu_torch.training import checkpoint as TC
from end2end_asr_tpu_torch.training import optimizer as TO
from end2end_asr_tpu_torch.training import steps as TS

from torch_parallel_worker import load_tree, rank_batch

STEPS = 2


def full_buffer(fp_full, local_tree, full_shapes):
    """The unsharded flat buffer (in the full tree's order) of this model
    coordinate's tree: gathered over the model group."""
    flat = TC.flatten_params(tp.gather_tree(local_tree, full_shapes))
    return torch.cat([flat[k].reshape(-1) for k in fp_full.train_keys])


def run_tp_steps(cfg, params, batch_path, spect_T, zero_stage=0,
                 rng_seed=None, steps=STEPS):
    """`steps` train steps of this rank's shard on its data row's batch;
    the parameters and moments gathered to the full buffers."""
    n_model, r = mesh.model_size(), mesh.model_rank()
    full_flat = TC.flatten_params(params)
    full_shapes = {k: tuple(v.shape) for k, v in full_flat.items()}
    fp_full = TS.FlatParams(params, torch.device("cpu"))
    fp = TS.FlatParams(TC.model_rank_tree(params, n_model, r),
                        torch.device("cpu"))
    plan = None
    if n_model > 1:
        plan = tp.FlatPlan(fp, [k for k in fp.train_keys if tp.leaf_dim(
            k, full_shapes[k], n_model) is not None], n_model,
            cfg.seq_parallel)
    zero = (ZeroShard(fp.numel, mesh.data_size(), mesh.data_rank(),
                      zero_stage) if zero_stage else None)
    data = fp.data
    opt = TO.init_opt_state(cfg, data if zero is None else zero.shard(data))
    if zero is not None and zero.stage == 3:
        data = zero.shard(data)
    step = TS.make_train_step_impl(cfg, dims_from_config(cfg), zero=zero,
                                   plan=plan)
    rng = None if rng_seed is None else DropoutRng(rng_seed, "cpu")
    batch = rank_batch(batch_path, mesh.data_rank(), mesh.data_size())
    out = {"loss": [], "num_correct": [], "num_token": [], "lr": []}
    full = lambda buf: full_buffer(fp_full, fp.tree(buf, fixed="zeros"),
                                   full_shapes).numpy()
    first = {}
    for i in range(steps):
        data, opt, _, m, _, _ = step(fp, data, opt, rng, *batch, spect_T)
        for k in out:
            out[k].append(float(m[k]))
        if i == 0:
            o = opt if zero is None else zero.gather_opt(opt)
            first = {"mu1": full(o["mu"]), "nu1": full(o["nu"])}
    if zero is not None:
        opt = zero.gather_opt(opt)
        if zero.stage == 3:
            data = zero.gather(data)
    res = {k: np.asarray(v) for k, v in out.items()}
    res.update(first)
    res.update(data=full(data), mu=full(opt["mu"]), nu=full(opt["nu"]),
               step=int(opt["step"]))
    return res


def tp_steps(root, spec, world):
    """The step scenarios of this layout (spec["steps"][str(world)]:
    name -> {"cfg": overrides, "params": file (default "params"), "batch":
    file, "zero": stage, "rng": seed, "steps": n})."""
    out = {}
    if not spec["steps"].get(str(world)):
        return out
    cfg = Config.from_dict(spec["cfg"])
    for name, sc in spec["steps"][str(world)].items():
        c = cfg.replace(**sc.get("cfg", {}))
        params = load_tree(os.path.join(root, sc.get("params", "params")
                                        + ".npz"))
        out[name] = run_tp_steps(
            c, params, os.path.join(root, sc.get("batch", "ce") + ".npz"),
            spec["T"], zero_stage=sc.get("zero", 0),
            rng_seed=sc.get("rng"), steps=sc.get("steps", STEPS))
    return out


def entry_points(root, spec, world):
    """The entry-point runs of this layout (spec["entry"][str(world)]: a
    list of {"train": argv} / {"test": argv, "name": ...}): the trainer's
    results, and the test's HYP lines, metrics and calls of
    tp.split_seq (the encoder's entry into sequence parallelism)."""
    os.chdir(root)
    out = {}
    for run in spec["entry"].get(str(world), []):
        if "train" in run:
            res = port_train.main(run["train"])
            flat = TC.flatten_params(res["params"])
            out[run["name"]] = {k: v.numpy() for k, v in flat.items()}
            continue
        lines = []
        handler = logging.Handler()
        handler.emit = lambda r: lines.append(r.getMessage())
        log = logging.getLogger("end2end_asr_tpu_torch")
        log.addHandler(handler)
        split_seq, slices = tp.split_seq, [0]

        def counted(x):
            slices[0] += 1
            return split_seq(x)

        tp.split_seq = counted
        try:
            res = port_test.main(run["test"])
        finally:
            log.removeHandler(handler)
            tp.split_seq = split_seq
        hyps = [ln for ln in lines if ln.startswith("HYP: ")]
        out[run["name"]] = {"hyps": np.asarray(hyps, dtype=str),
                            "cer": np.asarray(res.get("cer", -1.0)),
                            "seq_slices": np.asarray(slices[0])}
    return out


def encodes(root, spec, world):
    """The encoder outputs of this layout's runs (spec["encode"][str(world)]:
    a list of {"name", "cfg" (overrides), "params", "batch"}): this model
    rank's shard of the params, the batch whole, as `test` encodes."""
    out = {}
    for run in spec.get("encode", {}).get(str(world), []):
        c = Config.from_dict({**spec["cfg"], **run["cfg"]})
        params = TC.model_rank_tree(
            load_tree(os.path.join(root, run["params"] + ".npz")),
            mesh.model_size(), mesh.model_rank())
        dims = dims_from_config(c)
        with np.load(os.path.join(root, run["batch"] + ".npz")) as b:
            pcm = torch.from_numpy(b["pcm"])
            n_frames = torch.from_numpy(b["n_frames"].astype(np.int64))
        with torch.no_grad():
            enc, _ = encode_pcm(prepare_params(params, dims,
                                               torch.device("cpu")),
                                c, dims, pcm, n_frames, spec["T"])
        out[run["name"]] = {"enc": enc.float().numpy()}
    return out


def _group(root, tag, rank, world):
    store = dist.FileStore(os.path.join(root, "store_" + tag), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=300))


def run(rank, world, root):
    """Ranks 0-1 as a world of 2 at --mesh-model 2, then ranks 0-3 as a
    world of 4 at --mesh-data 2 --mesh-model 2."""
    torch.set_num_threads(1)
    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    for w in (2, world):
        if rank >= w:
            continue
        _group(root, str(w), rank, w)
        try:
            mesh.set_layout(2, w // 2)
            for scenario in (tp_steps, entry_points, encodes):
                for name, res in scenario(root, spec, w).items():
                    np.savez(os.path.join(root, f"{name}.r{rank}.npz"),
                             **res)
        finally:
            mesh.shutdown()
