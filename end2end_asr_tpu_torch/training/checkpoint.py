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

The serving path reads ``params`` and ``state``; the optimizer group is
the training slice's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from end2end_asr_tpu_torch.config import Config

SEP = "::"


def params_from_jax(flat: Dict[str, np.ndarray]):
    """The JAX param pytree, flattened to {"a::b::0::c": array}, as the
    port's pytree: nested dicts, lists where every key of a level is a
    digit, and tensors (copies) for leaves."""
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = (val.clone() if isinstance(val, torch.Tensor)
                           else torch.from_numpy(np.array(val)))

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def flatten_params(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Inverse of params_from_jax: {"a::b::0::c": tensor}."""
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
                    model_state=None, metrics: Optional[Dict] = None
                    ) -> None:
    """Write `<base_path>.npz` + `<base_path>.json` in the JAX package's
    npz format (no optimizer state)."""
    d = os.path.dirname(base_path)
    if d:
        os.makedirs(d, exist_ok=True)
    arrays, bf16_keys = {}, []
    for group, tree in (("params", params), ("state", model_state or {})):
        for k, v in flatten_params(tree).items():
            key = group + SEP + k
            arrays[key], is_bf16 = _to_numpy(v)
            if is_bf16:
                bf16_keys.append(key)
    np.savez(base_path + ".npz", **arrays)
    meta = {
        "args": cfg.to_dict(),
        "epoch": epoch,
        "label2id": label2id,
        "id2label": {str(k): v for k, v in id2label.items()},
        "metrics": metrics or {},
        "format_version": 1,
    }
    if bf16_keys:
        meta["bf16_keys"] = sorted(bf16_keys)
    with open(base_path + ".json", "w", encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False)


def load_checkpoint(base_path: str):
    """Returns (cfg, epoch, params, model_state, label2id, id2label,
    metrics) with CPU tensors. Accepts the path with or without
    extension. bfloat16 leaves come back as bfloat16 tensors."""
    if base_path.endswith(".npz") or base_path.endswith(".json"):
        base_path = base_path.rsplit(".", 1)[0]
    if os.path.isdir(base_path + ".orbax"):
        raise NotImplementedError(
            "orbax checkpoints are not read by the port; save with "
            "--checkpoint-format npz")
    with open(base_path + ".json", encoding="utf-8") as f:
        meta = json.load(f)
    bf16_keys = set(meta.get("bf16_keys", ()))
    groups: Dict[str, Dict] = {"params": {}, "opt": {}, "state": {}}
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
    params = params_from_jax(groups["params"])
    model_state = (params_from_jax(groups["state"])
                   if groups["state"] else {})
    cfg = Config.from_dict(meta["args"])
    id2label = {int(k): v for k, v in meta["id2label"].items()}
    return (cfg, meta["epoch"], params, model_state, meta["label2id"],
            id2label, meta.get("metrics", {}))
