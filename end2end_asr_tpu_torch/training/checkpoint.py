"""The weight bridge: the JAX package's checkpoint format, read and written
without JAX.

A checkpoint is `<base>.npz` (flattened pytrees under the groups
``params``, ``opt`` and ``state``, keys joined with ``::``, list indices
as digits) + `<base>.json` (run config ``args``, epoch, vocab maps,
metrics, and ``bf16_keys``: the npz keys stored as uint16 bit patterns
of bfloat16 arrays). This module reads that format into the port's param
pytree (nested dicts and lists of tensors, keyed as in the JAX package),
and writes the same format, so a checkpoint made here loads in the JAX
package's ``load_checkpoint`` and the other way round.

The serving path reads ``params`` and ``state``; training also carries
the optimizer group both ways (``opt::step``, ``opt::mu::…``,
``opt::nu::…`` for Adam; ``opt::lr``, ``opt::buf::…`` for annealing SGD),
the epoch and the metrics, so a run resumes in either package.

``--checkpoint-format orbax`` (the JAX package's sharded format, whose
name the flag keeps) writes the port's own sharded checkpoint:
`<base>.dcp/`, a ``torch.distributed.checkpoint`` directory, beside the
same `<base>.json` sidecar, which rank 0 writes first (`save_sharded`).
Every rank saves only the pieces it holds, and nothing is gathered: the
flat buffer of its model coordinate's parameters (parallel/tp.py) of its
pipeline stage (`pipe_stage_tree`) or, under --fsdp, its slice of it
(parallel/zero.py), and its moments, or their slice under --zero1 /
--fsdp. A piece that several ranks hold
(a model coordinate's buffer on every rank of the data axis, the step,
the model state, the tables) has one key, and DCP writes it once. The
sidecar's ``dcp`` entry records the layout, so `load_checkpoint` reads
the pieces in one process, with no group, and builds the unsharded
trees: a run resumes, and serves, at any layout. A JAX ``.orbax``
directory stays unread: orbax imports jax.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from end2end_asr_tpu_torch.config import Config

SEP = "::"


def params_from_jax(flat: Dict[str, np.ndarray]):
    """The JAX param pytree, flattened to {"a::b::0::c": array}, as the
    port's pytree with tensors (copies) for leaves (see unflatten)."""
    return unflatten({k: (v.clone() if isinstance(v, torch.Tensor)
                          else torch.from_numpy(np.array(v)))
                      for k, v in flat.items()})


def model_rank_tree(tree, n_model: int, r: int):
    """Model coordinate r's shard of the port's full param tree (or of a
    tree shaped like it: the Adam moments) under tensor parallelism over
    n_model ranks, by parallel/tp.py's rule (the JAX package's
    `param_pspecs`); leaves copied."""
    from end2end_asr_tpu_torch.parallel.tp import leaf_dim
    out = {}
    for k, v in flatten_params(tree).items():
        d = leaf_dim(k, tuple(v.shape), n_model)
        out[k] = (v.clone() if d is None
                  else v.chunk(n_model, dim=d)[r].contiguous())
    return unflatten(out)


def pipe_stage_tree(tree, n_pipe: int, s: int):
    """Stage s's part of the port's full param tree (or of a tree shaped
    like it: the Adam moments) under pipeline parallelism over n_pipe
    stages: layers [s·L/S, (s+1)·L/S) of the encoder and of the decoder,
    renumbered from 0, and every leaf outside the stacks; leaves copied."""
    from end2end_asr_tpu_torch.parallel.pp import STACKS, stage_range
    out = dict(tree)
    for k in STACKS:
        if k in tree and "layers" in tree[k]:
            layers = tree[k]["layers"]
            keep = stage_range(len(layers), n_pipe, s)
            out[k] = {**tree[k], "layers": [layers[i] for i in keep]}
    return unflatten({k: v.clone() for k, v in flatten_params(out).items()})


def pipe_join_trees(trees):
    """The full tree from the stages' trees (in stage order): the layers
    of each stack concatenated, every other leaf stage 0's."""
    from end2end_asr_tpu_torch.parallel.pp import STACKS
    out = dict(trees[0])
    for k in STACKS:
        if k in out and "layers" in out[k]:
            out[k] = {**out[k], "layers": [lp for t in trees
                                           for lp in t[k]["layers"]]}
    return out


def unflatten(flat: Dict[str, object]):
    """{"a::b::0::c": leaf} (the JAX pytree, flattened) → the port's
    pytree: nested dicts, lists where every key of a level is a digit,
    the leaves as given (no copy)."""
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def flatten_params(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Inverse of unflatten: {"a::b::0::c": tensor}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_params(v, f"{prefix}{i}{SEP}"))
    elif tree is not None:
        out[prefix[:-len(SEP)]] = tree
    return out


def _to_numpy(t: torch.Tensor):
    """(array, is_bf16): bfloat16 tensors become uint16 bit patterns."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def save_checkpoint(base_path: str, cfg: Config, epoch: int, params,
                    label2id: Dict[str, int], id2label: Dict[int, str],
                    model_state=None, metrics: Optional[Dict] = None,
                    opt_state=None) -> None:
    """Write `<base_path>.npz` + `<base_path>.json` in the JAX package's
    npz format; `opt_state` (a tree of tensors keyed as the JAX
    package's) goes into the ``opt`` group."""
    d = os.path.dirname(base_path)
    if d:
        os.makedirs(d, exist_ok=True)
    arrays, bf16_keys = {}, []
    for group, tree in (("params", params), ("opt", opt_state or {}),
                        ("state", model_state or {})):
        for k, v in flatten_params(tree).items():
            key = group + SEP + k
            arrays[key], is_bf16 = _to_numpy(v)
            if is_bf16:
                bf16_keys.append(key)
    np.savez(base_path + ".npz", **arrays)
    meta = _meta(cfg, epoch, label2id, id2label, metrics)
    if bf16_keys:
        meta["bf16_keys"] = sorted(bf16_keys)
    with open(base_path + ".json", "w", encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False)


def _meta(cfg: Config, epoch: int, label2id, id2label, metrics) -> Dict:
    return {
        "args": cfg.to_dict(),
        "epoch": epoch,
        "label2id": label2id,
        "id2label": {str(k): v for k, v in id2label.items()},
        "metrics": metrics or {},
        "format_version": 1,
    }


def save_sharded(base_path: str, cfg: Config, epoch: int, label2id,
                 id2label, pieces: Dict[str, torch.Tensor], layout: Dict,
                 metrics: Optional[Dict] = None) -> None:
    """`<base_path>.json`, written by rank 0 before the save, and
    `<base_path>.dcp/`: `pieces` ({key: tensor} of this rank,
    training/trainer.py `sharded_pieces`) through
    torch.distributed.checkpoint, collectively over the ranks of the
    group (one process without one). `layout` goes into the sidecar's
    ``dcp`` entry."""
    import torch.distributed.checkpoint as dcp
    from end2end_asr_tpu_torch.parallel import mesh
    d = os.path.dirname(base_path)
    if d:
        os.makedirs(d, exist_ok=True)
    if mesh.is_main():
        meta = _meta(cfg, epoch, label2id, id2label, metrics)
        meta["dcp"] = layout
        with open(base_path + ".json", "w", encoding="utf-8") as f:
            json.dump(meta, f, ensure_ascii=False)
    state = {k: v.detach().cpu() for k, v in pieces.items()}
    dcp.save(state, checkpoint_id=base_path + ".dcp",
             no_dist=not mesh.active())


def _load_sharded(base_path: str, layout: Dict):
    """The unsharded (flat params, flat opt, flat state) of a `.dcp`
    checkpoint, read in this process alone."""
    import torch.distributed.checkpoint as dcp
    from end2end_asr_tpu_torch.parallel.tp import leaf_dim, unshard_flat
    path = base_path + ".dcp"
    md = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
             for k, m in md.items()}
    dcp.load(state, checkpoint_id=path, no_dist=True)
    n_data, n_model = layout["n_data"], layout["n_model"]
    n_pipe = layout.get("n_pipe", 1)
    keys = layout["train_keys"]
    full = {k: tuple(v) for k, v in layout["shapes"].items()}

    def local_shape(k):
        shape, dim = list(full[k]), leaf_dim(k, full[k], n_model)
        if dim is not None:
            shape[dim] //= n_model
        return shape

    def unflat(name: str, s: int) -> Dict[str, torch.Tensor]:
        """Stage s's flat tree of buffer `name` ("params", "mu", ...)."""
        stage = f"s{s}{SEP}" if n_pipe > 1 else ""
        shards = []
        for m in range(n_model):
            one = f"{name}{SEP}{stage}m{m}"
            buf = (state[one] if one in state else torch.cat(
                [state[f"{one}{SEP}d{d}"] for d in range(n_data)]))
            flat, off = {}, 0
            for k in keys:
                shape = local_shape(k)
                n = int(np.prod(shape))
                flat[k] = buf[off:off + n].reshape(shape)
                off += n
            shards.append(flat)
        return unshard_flat(shards, {k: full[k] for k in keys})

    fixed = {k[len("fixed" + SEP):]: v for k, v in state.items()
             if k.startswith("fixed" + SEP)}

    def whole(name: str, zeros: bool) -> Dict[str, torch.Tensor]:
        """The full flat tree of buffer `name`: the stages' trees joined,
        with the fixed tables (zeros for the moments)."""
        stages = []
        for s in range(n_pipe):
            flat = unflat(name, s)
            dt = flat[keys[0]].dtype
            flat.update({f: torch.zeros(v.shape, dtype=dt) if zeros else v
                         for f, v in fixed.items()})
            stages.append(unflatten({k: flat[k] for k in layout["order"]}))
        return flatten_params(pipe_join_trees(stages))

    params = whole("params", zeros=False)
    opt = {}
    for k in layout["opt_keys"]:
        if k in layout["moment_keys"]:
            opt.update({k + SEP + f: v for f, v in whole(k, True).items()})
        else:
            opt[k] = state["opt" + SEP + k]
    model_state = {k[len("state" + SEP):]: v for k, v in state.items()
                   if k.startswith("state" + SEP)}
    return params, opt, model_state


def load_checkpoint(base_path: str):
    """As the JAX package's load_checkpoint: (cfg, epoch, params,
    opt_state or None, model_state, label2id, id2label, metrics) with CPU
    tensors. Accepts the path with or without extension. bfloat16 leaves
    come back as bfloat16 tensors. A `.dcp` checkpoint (`save_sharded`)
    comes back unsharded, whatever layout wrote it."""
    for ext in (".npz", ".json", ".dcp", ".orbax"):
        if base_path.endswith(ext):
            base_path = base_path[:-len(ext)]
    if os.path.isdir(base_path + ".orbax"):
        raise NotImplementedError(
            f"{base_path}.orbax: a JAX orbax checkpoint is not read by the "
            "port: orbax imports jax. Convert it with the JAX package "
            "(--checkpoint-format npz), or save the port's sharded format "
            "(<base>.dcp, --checkpoint-format orbax)")
    with open(base_path + ".json", encoding="utf-8") as f:
        meta = json.load(f)
    groups: Dict[str, Dict] = {"params": {}, "opt": {}, "state": {}}
    if os.path.isdir(base_path + ".dcp"):
        (groups["params"], groups["opt"],
         groups["state"]) = _load_sharded(base_path, meta["dcp"])
    else:
        bf16_keys = set(meta.get("bf16_keys", ()))
        with np.load(base_path + ".npz") as data:
            for key in data.files:
                g, rest = key.split(SEP, 1)
                arr = data[key]
                if key in bf16_keys:  # stored as uint16 bit patterns
                    t = torch.from_numpy(arr.view(np.int16).copy()).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(np.array(arr))
                groups[g][rest] = t
    params = unflatten(groups["params"])
    opt_state = unflatten(groups["opt"]) if groups["opt"] else None
    model_state = unflatten(groups["state"]) if groups["state"] else {}
    cfg = Config.from_dict(meta["args"])
    id2label = {int(k): v for k, v in meta["id2label"].items()}
    return (cfg, meta["epoch"], params, opt_state, model_state,
            meta["label2id"], id2label, meta.get("metrics", {}))


def find_latest_checkpoint(save_folder: str, name: str) -> Optional[str]:
    """Newest epoch_N checkpoint base path under <save_folder>/<name>
    (an `.npz` or a `.dcp` one), or None (train --auto-resume)."""
    d = os.path.join(save_folder, name)
    if not os.path.isdir(d):
        return None
    best, best_epoch = None, -1
    for f in os.listdir(d):
        m = re.fullmatch(r"epoch_(\d+)\.json", f)
        base = os.path.join(d, f[:-5])
        if m and (os.path.exists(base + ".npz")
                  or os.path.isdir(base + ".dcp")):
            if int(m.group(1)) > best_epoch:
                best_epoch = int(m.group(1))
                best = os.path.join(d, f[:-5])
    return best


def checkpoint_paths(save_folder: str, name: str, epoch: Optional[int],
                     best: bool) -> str:
    base = "best_model" if best else f"epoch_{epoch}"
    return os.path.join(save_folder, name, base)
