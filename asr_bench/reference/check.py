"""The comparisons that decide `correct`, against the plain reference.

Training: the reference follows the steps of the program's first
dispatch from the same weights, batches and dropout streams. Compared:
  * loss_rel: the largest relative gap of a step's loss;
  * mu_gap: the optimizer's first moment after the steps (the gradients
    as the optimizer holds them), leaf by leaf, the gap between the
    program's norm and the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf; the worst leaf;
  * update_gap: the same for the parameters' change over the steps.
Leaves whose first gradient in the reference is under a thousandth of
the median leaf's (a key projection's bias under the softmax: nought but
rounding) are left out of both leaf readings: Adam moves them by
rounding alone.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from asr_bench.reference import model as ref

SMALL_GRAD = 1e-3


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2]


def leaf_gap(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             keys: List[str]):
    """(worst gap of norms, its leaf) over `keys`."""
    norms = {k: float(want[k].double().norm()) for k in keys}
    med = _median(list(norms.values()))
    worst, leaf = 0.0, None
    for k in keys:
        g = abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k],
                                                                 med, 1e-30)
        if g > worst or leaf is None:
            worst, leaf = g, k
    return worst, leaf


def train_readings(model: "ref.Model", flat: Dict[str, torch.Tensor],
                   batches: List[tuple], seed: int, losses: List[float],
                   mu: Dict[str, torch.Tensor],
                   theta: Dict[str, torch.Tensor],
                   prec: "ref.Precision" = ref.F32) -> dict:
    """The training readings of a program's first dispatch: its per-step
    `losses`, its first moments `mu` and parameters `theta` by leaf."""
    ref.no_tf32()
    r = model.train(flat, batches, seed, prec)
    return compare_train(r, flat, losses, mu, theta)


def compare_train(r: dict, flat, losses, mu, theta) -> dict:
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, r["losses"]))
    g = {k: float(v.double().norm()) for k, v in r["first_grad"].items()}
    med = _median(list(g.values()))
    keys = [k for k in g if g[k] >= SMALL_GRAD * med]
    mu_gap, mu_leaf = leaf_gap(mu, r["mu"], keys)
    d_prog = {k: theta[k].double() - flat[k].double() for k in keys}
    d_ref = {k: r["params"][k].double() - flat[k].double() for k in keys}
    up_gap, up_leaf = leaf_gap(d_prog, d_ref, keys)
    return {"loss_rel": loss_rel, "mu_gap": mu_gap, "mu_leaf": mu_leaf,
            "update_gap": up_gap, "update_leaf": up_leaf,
            "losses_prog": list(losses), "losses_ref": r["losses"],
            "left_out": sorted(set(g) - set(keys))}
