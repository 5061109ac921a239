"""Functional optimizers on tensor pytrees: Noam-scheduled Adam and
annealing SGD.

Port of the JAX package's ``training/optimizer.py`` (plain tensor code:
the JAX package has no kernel here). A pytree is a tensor, or nested
dicts / lists of tensors; the functions return new trees and state and
modify nothing in place. The train step (training/steps.py) calls them on
flat parameter buffers, a one-leaf tree; its Noam Adam update
(`adam_noam_step`, the finite pick included) runs the elementwise part as
one kernel on a CUDA device (ops/adam.py), the same chain on the CPU.

Noam (utils/optimizer.py:3-32 of the reference):
    rate = max(min_lr, factor · model_size^-0.5 · min(step^-0.5,
                                                      step · warmup^-1.5))
with the reference's quirk kept: model_size is dim_input (the post-conv
feature width), not dim_model. Steps count from 1.

Adam is torch.optim.Adam's rule (betas 0.9/0.98, eps 1e-9 for Noam):
    m̂ = m/(1-β1^t), v̂ = v/(1-β2^t), p -= lr · m̂ / (sqrt(v̂) + eps),
with optional bf16 moment storage (the update computes in f32).
`sgd_annealing_update` is the intended nesterov SGD with lr /= anneal per
step. Clipping is torch.nn.utils.clip_grad_norm_'s global L2 norm. The
updates are elementwise, so they take a slice of a flat buffer and of its
state as they take the whole (ZeRO, parallel/zero.py).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from end2end_asr_tpu_torch.ops.adam import adam_step


class NoamConfig(NamedTuple):
    model_size: int  # args.dim_input (reference quirk)
    factor: float    # args.k_lr
    warmup: int
    min_lr: float
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-9


def tree_map(fn, *trees):
    """fn over the leaves of trees of one structure (dicts and lists are
    nodes; anything else, tuples included, is a leaf)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *(x[i] for x in trees)) for i in range(len(t))]
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def noam_rate(step: torch.Tensor, c: NoamConfig) -> torch.Tensor:
    step = step.to(torch.float32)
    rate = (c.factor * c.model_size ** -0.5
            * torch.minimum(step ** -0.5, step * c.warmup ** -1.5))
    return torch.clamp(rate, min=c.min_lr)


def init_adam_state(params, moments_dtype: Optional[torch.dtype] = None,
                    device=None) -> Dict:
    """Zero moments like the params (in `moments_dtype` when given) and
    step 0 (int32, on `device` or the first leaf's device)."""
    z = tree_map(lambda p: torch.zeros(p.shape, dtype=moments_dtype
                                       or p.dtype, device=p.device), params)
    z2 = tree_map(torch.zeros_like, z)
    dev = device or tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": z, "nu": z2}


def clip_by_global_norm(grads, max_norm: float, reduce_sq=None,
                        sq_weight=None):
    """Scale grads to a global L2 norm of at most max_norm. `reduce_sq`,
    where given, maps the squared sum of these grads to that of the
    whole buffer (a slice's, summed over the ranks under ZeRO; a model
    coordinate's, summed over the model group under tensor parallelism).
    `sq_weight` (a flat buffer's shape) weighs each element's square
    (parallel/tp.FlatPlan: replicated leaves count once over the model
    group)."""
    scale, gnorm = clip_scale(grads, max_norm, reduce_sq, sq_weight)
    return tree_map(lambda g: g * scale, grads), gnorm


def clip_scale(grads, max_norm: float, reduce_sq=None, sq_weight=None):
    """(scale, gnorm) of `clip_by_global_norm`: the factor it multiplies
    the grads by (a 0-d tensor, at most 1) and their global norm."""
    leaves = tree_leaves(grads)
    w = 1.0 if sq_weight is None else sq_weight
    sq = sum(torch.sum(torch.square(g.to(torch.float32)) * w)
             for g in leaves)
    gnorm = torch.sqrt(sq if reduce_sq is None else reduce_sq(sq))
    return torch.clamp(max_norm / (gnorm + 1e-6), max=1.0), gnorm


def adam_update(params, grads, state: Dict, lr, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-8) -> Tuple:
    """One bias-corrected Adam step at the given lr (a 0-d tensor or a
    float). Returns (new_params, new_state)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - beta1 ** t
    bc2 = 1.0 - beta2 ** t

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        mdt = m.dtype
        m = beta1 * m.to(torch.float32) + (1.0 - beta1) * g
        v = beta2 * v.to(torch.float32) + (1.0 - beta2) * torch.square(g)
        denom = torch.sqrt(v / bc2) + eps
        return p - lr * (m / bc1) / denom, m.to(mdt), v.to(mdt)

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"step": step, "mu": pick(1), "nu": pick(2)}


def adam_noam_update(params, grads, state: Dict, c: NoamConfig,
                     clip: bool = False, max_norm: float = 400.0,
                     reduce_sq=None, sq_weight=None):
    """One optimizer step. Returns (new_params, new_state, lr). Params,
    grads and moments may be matching slices of flat buffers (ZeRO,
    parallel/zero.py) or shards (parallel/tp.py); `reduce_sq` and
    `sq_weight` then complete the clip's norm."""
    if clip:
        grads, _ = clip_by_global_norm(grads, max_norm, reduce_sq,
                                       sq_weight)
    lr = noam_rate(state["step"] + 1, c)
    new_params, new_state = adam_update(params, grads, state, lr, c.beta1,
                                        c.beta2, c.eps)
    return new_params, new_state, lr


def adam_noam_step(params: torch.Tensor, grads: torch.Tensor,
                   inv: torch.Tensor, finite: torch.Tensor, state: Dict,
                   c: NoamConfig, clip: bool = False, max_norm: float = 400.0,
                   reduce_sq=None, sq_weight=None):
    """The train step's update (training/steps.py): one Noam Adam step on
    the gradient `grads * inv` where `finite` (a 0-d bool) is true, the
    parameters and the state as they were where it is false. Returns
    (new_params, new_state, lr). `params`, `grads` and the moments are
    matching flat buffers or slices of them (f32 or bf16 moments), as in
    adam_noam_update; `inv` an f32 0-d tensor. On a CUDA device the
    elementwise part is one kernel (ops/adam.adam_step), equal bit for bit
    to what runs elsewhere: adam_noam_update on `grads * inv`, then
    `torch.where(finite, new, old)` over the parameters and the state."""
    pick = lambda new, old: torch.where(finite, new, old)
    if not params.is_cuda:
        upd, new, lr = adam_noam_update(params, grads * inv, state, c,
                                        clip=clip, max_norm=max_norm,
                                        reduce_sq=reduce_sq,
                                        sq_weight=sq_weight)
        return pick(upd, params), tree_map(pick, new, state), lr
    step = state["step"] + 1
    scale = None
    if clip:
        # the norm of the scaled gradient, as clip_by_global_norm takes it
        scale, _ = clip_scale(grads * inv, max_norm, reduce_sq, sq_weight)
    lr = noam_rate(step, c)
    t = step.to(torch.float32)
    p, m, v = adam_step(params, grads, state["mu"], state["nu"], lr=lr,
                        bc1=1.0 - c.beta1 ** t, bc2=1.0 - c.beta2 ** t,
                        inv=inv, finite=finite, clip=scale, beta1=c.beta1,
                        beta2=c.beta2, eps=c.eps)
    return p, {"step": pick(step, state["step"]), "mu": m, "nu": v}, lr


def init_opt_state(cfg, params, device=None) -> Dict:
    """Optimizer state for cfg.opt (the init half of the reference's
    init_optimizer, functions.py:101-114)."""
    if cfg.opt == "sgd_annealing":
        return init_sgd_state(params, cfg.lr, device)
    mdt = (torch.bfloat16 if getattr(cfg, "adam_moments_dtype", "float32")
           == "bfloat16" else None)
    return init_adam_state(params, moments_dtype=mdt, device=device)


def init_sgd_state(params, lr: float, device=None) -> Dict:
    dev = device or tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "lr": torch.tensor(lr, dtype=torch.float32, device=dev),
            "buf": tree_map(torch.zeros_like, params)}


def sgd_annealing_update(params, grads, state: Dict, momentum: float,
                         lr_anneal: float, clip: bool = False,
                         max_norm: float = 400.0, reduce_sq=None,
                         sq_weight=None):
    """As adam_noam_update, for annealing SGD."""
    if clip:
        grads, _ = clip_by_global_norm(grads, max_norm, reduce_sq,
                                       sq_weight)
    lr = state["lr"] / lr_anneal

    def upd(p, g, b):
        g = g.to(torch.float32)
        b = momentum * b + g
        return p - lr * (g + momentum * b), b  # nesterov

    out = tree_map(upd, params, grads, state["buf"])
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"step": state["step"] + 1, "lr": lr,
                     "buf": pick(1)}, lr
