"""The ranks of tests/test_torch_pp.py on the CPU: one spawn of 4 processes
for the module, which first run the world-2 scenarios in two 2-rank gloo
groups side by side (ranks 0-1 and ranks 2-3) and then the world-4 ones in
a 4-rank group, each scenario at its own data x pipe x model layout.

Each scenario's results go to `<root>/<scenario>.r<rank>.npz`; the tests
assert on the files. It imports torch and the port, never jax: the JAX
package's references are computed in the test process.
"""

import json
import os

import numpy as np
import torch

from end2end_asr_tpu_torch.config import Config
from end2end_asr_tpu_torch.models.layers import DropoutRng
from end2end_asr_tpu_torch.models.transformer import dims_from_config
from end2end_asr_tpu_torch.parallel import mesh, pp, tp
from end2end_asr_tpu_torch.parallel.zero import ZeroShard
from end2end_asr_tpu_torch.training import checkpoint as TC
from end2end_asr_tpu_torch.training import optimizer as TO
from end2end_asr_tpu_torch.training import steps as TS

from torch_parallel_worker import load_tree, rank_batch
from torch_tp_worker import _group, entry_points

STEPS = 2
CPU = torch.device("cpu")


def run_pp_steps(cfg, params, batch_path, spect_T, zero_stage=0,
                 rng_seed=None, steps=STEPS, state=None, group=False):
    """`steps` train steps of this rank's stage (and model shard) on its
    data row's batch, as the trainer sets them up; the parameters and
    moments gathered to the full model's buffers, and the model state.
    `group`: the steps as one K-step dispatch (make_multi_train_step), the
    run's own kernel seeds drawn at once as a CUDA graph's are, after one
    step that sets how many a step takes, its streams put back
    (GraphedSteps' warm-up); the first step's moments are then not
    kept."""
    n_model, n_pipe = mesh.model_size(), mesh.pipe_size()
    fp_full = TS.FlatParams(params, CPU)
    stage = TC.pipe_stage_tree(params, n_pipe, mesh.pipe_rank())
    shapes = {k: tuple(v.shape)
              for k, v in TC.flatten_params(stage).items()}
    local = (TC.model_rank_tree(stage, n_model, mesh.model_rank())
             if n_model > 1 else stage)
    fp = TS.FlatParams(local, CPU)
    plan = tp.FlatPlan(fp, [k for k in fp.train_keys if tp.leaf_dim(
        k, shapes[k], n_model) is not None], n_model, cfg.seq_parallel,
        n_pipe)
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

    def full(buf):
        tree = pp.gather_stages(tp.gather_tree(fp.tree(buf, fixed="zeros"),
                                               shapes))
        flat = TC.flatten_params(tree)
        return torch.cat([flat[k].reshape(-1)
                          for k in fp_full.train_keys]).numpy()

    out = {"loss": [], "num_correct": [], "num_token": [], "lr": []}
    first = {}
    if group:
        st = rng.state()
        step(fp, data, opt, rng, *batch, spect_T, model_state=state)
        rng.set_state(st)
        multi = TS.make_multi_train_step(cfg, step, steps, CPU)
        data, opt, state, ms, hyps, _ = multi(fp, data, opt, rng,
                                              [batch] * steps, spect_T,
                                              model_state=state)
        out = {k: [float(v) for v in ms[k]] for k in out}
        first = {"hyp1": hyps[0].numpy()}
        steps = 0
    for i in range(steps):
        data, opt, state, m, hyp, _ = step(fp, data, opt, rng, *batch,
                                           spect_T, model_state=state)
        for k in out:
            out[k].append(float(m[k]))
        if i == 0:
            o = opt if zero is None else zero.gather_opt(opt)
            first = {"mu1": full(o["mu"]), "nu1": full(o["nu"]),
                     "hyp1": hyp.numpy()}
    if zero is not None:
        opt = zero.gather_opt(opt)
        if zero.stage == 3:
            data = zero.gather(data)
    res = {k: np.asarray(v) for k, v in out.items()}
    res.update(first)
    res.update(data=full(data), mu=full(opt["mu"]), nu=full(opt["nu"]),
               step=int(opt["step"]))
    for k, v in TC.flatten_params(state or {}).items():
        res["state::" + k] = v.numpy()
    return res


def pp_steps(root, spec, tag):
    """The step scenarios of group `tag` (spec["steps"][tag]: name ->
    {"layout": [data, pipe, model], "cfg": overrides, "zero": stage,
    "rng": seed, "params": file (default "params"), "model": "emb" for
    the emb_cnn model, its state and batch, one step; "group": true for
    the steps as one K-step dispatch})."""
    out = {}
    for name, sc in spec["steps"].get(tag, {}).items():
        n_data, n_pipe, n_model = sc["layout"]
        mesh.set_layout(n_model, n_data, n_pipe, CPU)
        emb = sc.get("model") == "emb"
        cfg = Config.from_dict(spec["emb_cfg" if emb else "cfg"])
        c = cfg.replace(mesh_pipe=n_pipe, mesh_model=n_model,
                        **sc.get("cfg", {}))
        f = lambda n: os.path.join(root, ("emb_" if emb else "") + n)
        out[name] = run_pp_steps(
            c, load_tree(f(sc.get("params", "params") + ".npz")),
            f("batch.npz"), spec["T"],
            zero_stage=sc.get("zero", 0), rng_seed=sc.get("rng"),
            steps=1 if emb else STEPS,
            state=load_tree(f("state.npz")) if emb else None,
            group=sc.get("group", False))
    return out


def run(rank, world, root):
    """Two worlds of 2 side by side (ranks 0-1, group "2a", and ranks 2-3,
    group "2b"), then ranks 0-3 as a world of 4 (group "4")."""
    torch.set_num_threads(1)
    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    for tag, w, local in (("2a" if rank < 2 else "2b", 2, rank % 2),
                          ("4", world, rank)):
        _group(root, tag, local, w)
        try:
            for scenario in (pp_steps, entry_points):
                for name, res in scenario(root, spec, tag).items():
                    np.savez(os.path.join(root, f"{name}.r{local}.npz"),
                             **res)
        finally:
            mesh.shutdown()


def gpu_run(rank, root):
    """One of 2 gloo ranks sharing cuda:0 (tests/test_torch_gpu.py): a
    hand-off of the train cell's encoder microbatch each way, then one
    pipelined train step at dropout 0.1 of a small bf16 model; writes what
    the rank saw to `<root>/gpu.r<rank>.json`."""
    from datetime import timedelta

    import torch.distributed as dist

    from end2end_asr_tpu_torch.models.transformer import init_params
    from end2end_asr_tpu_torch.ops import attention_fused as AF
    from end2end_asr_tpu_torch.ops import vgg_fused as V

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(root, "store_gpu"), 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2,
                            timeout=timedelta(seconds=120))
    out = {}
    try:
        mesh.set_layout(1, 1, 2, dev)
        out["transport"] = mesh.TRANSPORT
        x = torch.randn(6, 200, 512, generator=torch.Generator()
                        .manual_seed(0)).to(dev)
        if rank == 0:
            pp.send(x, 1)
            back = pp.recv(x.shape, x.dtype, dev, 1)
            out["hand_off_exact"] = bool(torch.equal(back, 2 * x))
        else:
            got = pp.recv(x.shape, x.dtype, dev, 0)
            out["hand_off_exact"] = bool(torch.equal(got, x))
            pp.send(2 * got, 0)
        # heads of 64: the width the attention kernels are built for
        cfg = Config(feat_extractor="vgg_cnn", num_layers=2, num_heads=2,
                     dim_model=64, dim_key=64, dim_value=64, dim_inner=128,
                     dim_emb=64, dropout=0.1, dtype="bfloat16", mesh_pipe=2)
        params = init_params(cfg, 12, torch.Generator().manual_seed(0))
        stage = TC.pipe_stage_tree(params, 2, rank)
        fp = TS.FlatParams(stage, dev)
        plan = tp.FlatPlan(fp, [], 1, False, 2)
        g = torch.Generator().manual_seed(1)
        T = 200
        pcm = (torch.randn(4, (T - 1) * 160 + 320, generator=g)
               * 0.2).to(dev)
        n_frames = torch.tensor([T, T - 30, T - 9, T], device=dev)
        targets = torch.tensor([[1, 5, 6, 7, 2, 0], [1, 8, 9, 2, 0, 0],
                                [1, 4, 2, 0, 0, 0], [1, 3, 3, 3, 3, 2]],
                               device=dev)
        lengths = (targets != 0).sum(1)
        AF.reset_launches()
        V.reset_launches()
        step = TS.make_train_step_impl(cfg, dims_from_config(cfg), plan=plan)
        res = step(fp, fp.data, TO.init_opt_state(cfg, fp.data),
                   DropoutRng(3, dev), pcm, n_frames, targets, lengths, T)
        torch.cuda.synchronize()
        out.update(loss=float(res[3]["loss"]),
                   attn=[AF.FWD.launches, AF.BWD.launches],
                   vgg=[V.launches(), V.bwd_launches()])
        mesh.shutdown()
    finally:
        # no barrier after a failure: the other rank may wait in a recv
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(root, f"gpu.r{rank}.json"), "w") as f:
        json.dump(out, f)
