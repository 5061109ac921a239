"""Average the parameters of N checkpoints into a new one (the port's copy
of root ``tools/average_checkpoints.py``).

    python -m end2end_asr_tpu_torch.tools.average_checkpoints out/avg \\
        models/run/epoch_28 models/run/epoch_29 models/run/epoch_30 \\
        [--device cpu]

Uniform averaging of the last or best K epoch checkpoints. Reads and
writes the npz checkpoints of either package (an orbax one raises);
`train` / `test --continue-from` load the result. Metadata (config,
labels, epoch, metrics) is taken from the LAST checkpoint listed; the
optimizer state is dropped (an averaged Adam state is meaningless: resume
from a real epoch checkpoint); the model state (batch-norm running
statistics) is averaged with the weights. The running sums are float64 on
`--device` (default the card), one checkpoint resident at a time, and
each average is cast back to its leaf's dtype, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Iterable, List, Optional

import torch

from end2end_asr_tpu_torch.training.checkpoint import (flatten_params,
                                                       unflatten)


def average_trees(trees: Iterable[Dict], device="cpu") -> Dict:
    """Uniform average over an iterable of pytrees of tensors with the same
    structure, streamed: the float64 sums and ONE tree are resident at a
    time."""
    it = iter(trees)
    first = flatten_params(next(it))
    keys = list(first)
    dtypes = {k: v.dtype for k, v in first.items()}
    sums = {k: v.to(device, torch.float64) for k, v in first.items()}
    del first
    n = 1
    for tree in it:
        more = flatten_params(tree)
        if set(more) != set(keys):
            raise ValueError(
                "checkpoints have different parameter structures "
                f"({sorted(set(more) ^ set(keys))} differ) — are they "
                "from the same run?")
        for k, v in more.items():
            sums[k] += v.to(device, torch.float64)
        n += 1
    if n < 2:
        raise ValueError("need at least 2 checkpoints")
    return unflatten({k: (s / n).to(dtypes[k]).cpu()
                      for k, s in sums.items()})


def main(argv: Optional[List[str]] = None) -> str:
    """Writes `<out>.npz` / `<out>.json` and returns `out`."""
    from end2end_asr_tpu_torch.evaluation import resolve_device
    from end2end_asr_tpu_torch.training.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", help="output checkpoint base path (no ext)")
    ap.add_argument("checkpoints", nargs="+",
                    help="2+ checkpoint base paths to average")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.checkpoints) < 2:
        ap.error("need at least 2 checkpoints")
    device = resolve_device(args.device)
    meta = {}

    def stream():
        # one checkpoint resident at a time; metadata kept from the LAST
        for p in args.checkpoints:
            cfg, epoch, params, _, state, label2id, id2label, m = \
                load_checkpoint(p)
            meta.update(cfg=cfg, epoch=epoch, label2id=label2id,
                        id2label=id2label, metrics=m)
            yield {"params": params, "state": state or {}}

    avg = average_trees(stream(), device)
    save_checkpoint(args.out, meta["cfg"], meta["epoch"], avg["params"],
                    meta["label2id"], meta["id2label"],
                    model_state=avg.get("state", {}),
                    metrics={**(meta["metrics"] or {}),
                             "averaged_from": list(args.checkpoints)})
    print(f"averaged {len(args.checkpoints)} checkpoints -> {args.out}.npz")
    return args.out


if __name__ == "__main__":
    main(sys.argv[1:])
