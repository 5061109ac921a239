"""Where the LRTRFS encoder at bf16 moves under tensor parallelism, on the
CPU: the port in one process and on a 2-rank model group (gloo), and the
JAX package on one device and on a 2-device model mesh, on the same
JAX-initialised weights (--rank R, tests/port_parity.small_config with 4
heads) and batch (tests/test_torch_train._batch). Prints each pair's
largest absolute and relative difference and the share of elements that
differ:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python tests/lowrank_bf16_gap.py [--rank 8]

tests/test_torch_tp.py::test_low_rank_tp_encoder_at_bf16_is_no_farther_than_jax
holds the port's gap to at most JAX's inside its spawn.
"""

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402


def port_encode(root, model_rank=None):
    """The port's bf16 encoder output of the saved batch: one process, or
    this model rank's shard under a 2-rank group."""
    from end2end_asr_tpu_torch.config import Config
    from end2end_asr_tpu_torch.evaluation import encode_pcm, prepare_params
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.training import checkpoint as TC
    from torch_parallel_worker import load_tree
    with open(os.path.join(root, "cfg.json")) as f:
        cfg = Config.from_dict(json.load(f))
    params = load_tree(os.path.join(root, "params.npz"))
    if model_rank is not None:
        params = TC.model_rank_tree(params, 2, model_rank)
    dims = dims_from_config(cfg)
    with np.load(os.path.join(root, "batch.npz")) as b:
        pcm = torch.from_numpy(b["pcm"])
        n_frames = torch.from_numpy(b["n_frames"].astype(np.int64))
    with torch.no_grad():
        enc, _ = encode_pcm(prepare_params(params, dims, torch.device("cpu")),
                            cfg, dims, pcm, n_frames, cfg.src_max_len)
    return enc.float().numpy()


def rank_main(rank, root):
    from end2end_asr_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), 2), rank=rank, world_size=2)
    try:
        mesh.set_layout(2, 1)
        np.save(os.path.join(root, f"tp{rank}.npy"),
                port_encode(root, mesh.model_rank()))
    finally:
        dist.destroy_process_group()


def gap(a, b) -> dict:
    d = np.abs(a - b)
    return {"max_abs": float(d.max()),
            "max_rel": float(d.max() / np.abs(b).max()),
            "share_differing": float((d > 0).mean())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=8)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from end2end_asr_tpu.models.transformer import dims_from_config
    from end2end_asr_tpu.parallel.tp import make_mesh_2d, shard_params
    from end2end_asr_tpu.training.steps import make_encode_fn
    from port_parity import jax_params, small_config, torch_config
    from test_torch_parallel import _save_batch, _save_tree
    from test_torch_train import T_FRAMES, VOCAB, _batch
    cfg = small_config(rank=args.rank, dtype="bfloat16", batch_size=4,
                       src_max_len=T_FRAMES)
    params = jax_params(cfg, VOCAB, seed=4)
    pcm, n_frames = _batch(0)[:2]
    with tempfile.TemporaryDirectory() as root:
        _save_tree(os.path.join(root, "params.npz"), params)
        _save_batch(os.path.join(root, "batch.npz"), _batch(0))
        with open(os.path.join(root, "cfg.json"), "w") as f:
            json.dump(torch_config(cfg).to_dict(), f)
        one = port_encode(root)
        mp.spawn(rank_main, args=(root,), nprocs=2)
        tp = [np.load(os.path.join(root, f"tp{r}.npy")) for r in range(2)]
    encode = make_encode_fn(cfg, dims_from_config(cfg), from_pcm=True)
    jone, _ = encode(params, {}, pcm, n_frames, spect_T=T_FRAMES)
    jtp, _ = encode(shard_params(make_mesh_2d(2, n_data=1), params), {},
                    pcm, n_frames, spect_T=T_FRAMES)
    jone, jtp = (np.asarray(a, np.float32) for a in (jone, jtp))
    print(json.dumps({
        "rank": args.rank, "shape": list(one.shape),
        "port_ranks_equal": bool(np.array_equal(tp[0], tp[1])),
        "port_tp_vs_one_process": gap(tp[0], one),
        "jax_mesh_vs_one_device": gap(jtp, jone),
        "port_vs_jax_one_device": gap(one, jone)}))


if __name__ == "__main__":
    main()
