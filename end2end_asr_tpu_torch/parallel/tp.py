"""Tensor parallelism (``--mesh-model``) and sequence parallelism
(``--seq-parallel``): the JAX package's ``parallel/tp.py`` and
``parallel/sp.py``, with the collectives written out (Megatron-LM).

The ranks form a data x model grid (parallel/mesh.py `set_layout`). Each
model coordinate holds a shard of every attention projection and FFN
inner dimension, by the JAX package's rule (`param_pspecs`):

  column-parallel: mha q/k/v (dim_model, H·d) and ffn w1 (dim_model,
      inner): ``w`` split on dim 1, ``b`` on dim 0;
  row-parallel: mha out (H·d, dim_model) and ffn w2 (inner, dim_model):
      ``w`` split on dim 0, ``b`` replicated;
  replicated: everything else (LayerNorms, tables, the conv front end,
      the embedding and output projection, the low-rank factors ``u`` /
      ``v`` and the int8 ``q8`` / ``scale``), and any leaf whose split
      dimension does not divide.

training/checkpoint.py `model_rank_tree` cuts a model coordinate's
shard out of the full tree by that rule. `models/layers.py` runs `mha`
and `ffn` on a rank's local heads and
local inner width: the input enters the column-parallel products through
`column_entry` (identity forward, all-reduce of the input gradient over
the model group) and the row-parallel product's partial output leaves
through `row_exit` (all-reduce forward, identity backward); the
row-parallel bias is added once, after it. The dropout streams stay in
lockstep on the ranks of a model group (each draws the full shape), so
they drop the same elements; the attention kernel seeds by LOCAL head,
as the JAX package's sharded kernel does ("head shards draw the same
mask pattern").

Sequence parallelism (encoder only, as in the JAX package): between the
products the residual stream, LayerNorm, dropout and the non-pad mask
run on this rank's T/M slice of the time axis. `column_entry` becomes an
all-gather over T (backward: reduce-scatter) and `row_exit` a
reduce-scatter over T (backward: all-gather). The encoder's input enters
the slices through `split_seq` and leaves through `gather_seq`. A dropout
mask on a slice is that slice of the mask of the whole sequence, so the
SP step equals the TP step. The gradients of the leaves used only on the
slices (the encoder layers' LayerNorms and row-parallel biases,
`partial_keys`) are partial sums: the step adds them over the model
group.

Low-rank (``--model LRTRFS``) and int8 layers keep their factors ``u`` /
``v`` and their int8 weights ``q8`` / ``scale`` whole on every rank, as
the JAX package's map replicates them, while a column parent's ``b``
shards. A column-parallel shard computes ``x @ u`` whole and takes the
columns of ``v`` (of ``q8`` and ``scale``) that its bias covers; a
row-parallel shard multiplies its input slice by its rows of ``u`` (of
``q8``), sums that partial product over the model group (r columns wide
for a low-rank layer: the all-reduce, or under sequence parallelism the
reduce-scatter over T, where GSPMD puts it for a sharded contracting
dimension) and applies ``v`` (the whole ``scale``) and the bias after the
sum (models/layers.py `dense`, `row_dense`). The gradients of the
factors a rank touches only through its own columns or rows are partial
over the model group (`partial_keys`); the step sums them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from end2end_asr_tpu_torch.parallel import mesh

SEP = "::"
COLUMN_PARENTS = ("q", "k", "v", "w1")   # w on dim 1, b on dim 0
ROW_PARENTS = ("out", "w2")              # w on dim 0, b replicated


# ---------------------------------------------------------------------------
# the shard map (the JAX package's param_pspecs / _leaf_spec)
# ---------------------------------------------------------------------------

def leaf_dim(key: str, shape, n_model: int) -> Optional[int]:
    """The dimension of the leaf `key` ("a::b::q::w") split over the model
    axis, or None where it is replicated."""
    parts = key.split(SEP)
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else None)
    if n_model <= 1:
        return None
    if leaf == "w" and parent in COLUMN_PARENTS:
        return 1 if shape[1] % n_model == 0 else None
    if leaf == "b" and parent in COLUMN_PARENTS:
        return 0 if shape[0] % n_model == 0 else None
    if leaf == "w" and parent in ROW_PARENTS:
        return 0 if shape[0] % n_model == 0 else None
    return None


def param_pspecs(flat: Dict[str, torch.Tensor],
                 n_model: int) -> Dict[str, Optional[int]]:
    """{key: split dimension or None} for a flat param tree (also for its
    Adam moments, which mirror it)."""
    return {k: leaf_dim(k, tuple(v.shape), n_model) for k, v in flat.items()}


def check_tp_divisibility(cfg, n_model: int) -> None:
    """The JAX package's check: whole heads a shard, and dim_inner."""
    if n_model <= 1:
        return
    if cfg.num_heads % n_model != 0:
        raise ValueError(
            f"--num-heads {cfg.num_heads} must be divisible by "
            f"--mesh-model {n_model} (whole attention heads per shard)")
    if cfg.dim_inner % n_model != 0:
        raise ValueError(
            f"--dim-inner {cfg.dim_inner} must be divisible by "
            f"--mesh-model {n_model}")


def unshard_flat(shards: List[Dict[str, torch.Tensor]],
                 full_shapes: Dict[str, Tuple[int, ...]]
                 ) -> Dict[str, torch.Tensor]:
    """The full flat tree from the model coordinates' flat shards (in
    coordinate order); `full_shapes` gives each leaf's unsharded shape."""
    n = len(shards)
    out = {}
    for k, shape in full_shapes.items():
        d = leaf_dim(k, shape, n)
        out[k] = (shards[0][k] if d is None
                  else torch.cat([s[k] for s in shards], dim=d))
    return out


def gather_tree(tree, full_shapes: Dict[str, Tuple[int, ...]]):
    """The unsharded tree on every rank of the model group, from each
    coordinate's shard `tree`: one all-gather a split leaf."""
    from end2end_asr_tpu_torch.training.checkpoint import (flatten_params,
                                                           unflatten)
    n = mesh.model_size()
    flat = flatten_params(tree)
    if n == 1:
        return tree
    out = {}
    for k, v in flat.items():
        d = leaf_dim(k, full_shapes[k], n)
        if d is None:
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(n)]
        dist.all_gather(parts, v.contiguous(), group=mesh.model_group())
        out[k] = torch.cat(parts, dim=d)
    return unflatten(out)


def partial_keys(keys, seq_parallel: bool) -> List[str]:
    """The leaves whose gradients are partial over the model group under
    tensor parallelism: the replicated low-rank factors that a rank uses
    through its own columns or rows only (a column parent's ``u`` and
    ``v``, a row parent's ``u``) and, under sequence parallelism, the
    leaves it applies to a T slice only (the encoder layers' LayerNorms,
    and a row parent's ``v`` and ``b``)."""
    out = []
    for k in keys:
        p = k.split(SEP)
        leaf, parent = p[-1], (p[-2] if len(p) > 1 else None)
        if ((parent in COLUMN_PARENTS and leaf in ("u", "v"))
                or (parent in ROW_PARENTS and leaf == "u")):
            out.append(k)
        elif (seq_parallel and p[0] == "encoder" and len(p) >= 4
              and p[1] == "layers"
              and (parent == "ln"
                   or (parent in ROW_PARENTS and leaf in ("b", "v")))):
            out.append(k)
    return out


def layer_key(key: str) -> bool:
    """Whether the leaf `key` lies in the encoder's or the decoder's layer
    stack (split over the pipeline's stages; every other leaf is on each
    stage)."""
    p = key.split(SEP)
    return len(p) > 2 and p[0] in ("encoder", "decoder") and p[1] == "layers"


class FlatPlan:
    """What the train step needs to know of the flat buffer of one model
    coordinate and pipeline stage (training/steps.FlatParams): the weight
    of each element in the clip's squared norm (1 on a leaf of its own;
    1/M on a leaf replicated over the M model ranks and 1/S on one that
    every one of the S stages holds, whose copies then count once); under
    tensor parallelism, the ranges of the leaves whose gradients are
    partial over the model group (`partial_keys`); under pipeline
    parallelism, the ranges of the leaves outside the layer stacks, whose
    gradients the stages sum (a stage that did not use a leaf adds
    zeros)."""

    def __init__(self, fp, split_keys, n_model: int, seq_parallel: bool,
                 n_pipe: int = 1):
        w, off = [], 0
        self.partial, self.pipe = [], []
        partial = (set(partial_keys(fp.train_keys, seq_parallel))
                   if n_model > 1 else set())
        for k, n in zip(fp.train_keys, fp.sizes):
            weight = 1.0 if k in split_keys else 1.0 / n_model
            if n_pipe > 1 and not layer_key(k):
                weight /= n_pipe
                self.pipe.append((off, n))
            w.append(torch.full((n,), weight))
            if k in partial:
                self.partial.append((off, n))
            off += n
        self.sq_weight = torch.cat(w).to(fp.device)

    @staticmethod
    def _sum_ranges_(g: torch.Tensor, ranges, group) -> torch.Tensor:
        if not ranges:
            return g
        parts = torch.cat([g[o:o + n] for o, n in ranges])
        dist.all_reduce(parts, group=group)
        i = 0
        for o, n in ranges:
            g[o:o + n] = parts[i:i + n]
            i += n
        return g

    def reduce_partial_(self, g: torch.Tensor) -> torch.Tensor:
        """Sum the partial leaves of the flat gradient `g` over the model
        group, in place."""
        return self._sum_ranges_(g, self.partial, mesh.model_group())

    def reduce_pipe_(self, g: torch.Tensor) -> torch.Tensor:
        """Sum the gradient of the leaves outside the stacks over the pipe
        group, in place."""
        return self._sum_ranges_(g, self.pipe, mesh.pipe_group())

    def sum_sq(self, sq: torch.Tensor) -> torch.Tensor:
        """The clip's weighted squared sum over the model coordinates and
        the stages."""
        sq = sum_over_model(sq)
        if mesh.pipe_size() > 1:
            sq = sq.contiguous().clone()
            dist.all_reduce(sq, group=mesh.pipe_group())
        return sq


# ---------------------------------------------------------------------------
# the collectives of the layers (identities with one model rank)
# ---------------------------------------------------------------------------

def active() -> bool:
    return mesh.model_size() > 1


def sum_over_model(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the model group (a copy)."""
    return _all_reduce(t) if active() else t


def model_part(t: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    """This model rank's `width` of the replicated `t` along `dim` (the
    columns or rows of a low-rank factor or an int8 weight that its shard
    of a product uses); raises unless `dim` holds the model ranks'
    widths."""
    n = mesh.model_size()
    if t.shape[dim] != width * n:
        raise ValueError(
            f"a shard of {width} on dimension {dim} of a {tuple(t.shape)} "
            f"leaf does not split it over {n} model ranks")
    return t.narrow(dim, mesh.model_rank() * width, width)


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=mesh.model_group())
    return x


def _gather_t(x: torch.Tensor) -> torch.Tensor:
    """(B, T/M, H) slices → (B, T, H), the model ranks' slices in order."""
    n = mesh.model_size()
    B, t, H = x.shape
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(),
                                group=mesh.model_group())
    return out.view(n, B, t, H).permute(1, 0, 2, 3).reshape(B, n * t, H)


def _reduce_scatter_t(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H) partial sums → this rank's (B, T/M, H) slice of their sum
    over the model group."""
    n = mesh.model_size()
    B, T, H = x.shape
    src = x.reshape(B, n, T // n, H).permute(1, 0, 2, 3).reshape(-1)
    out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src.contiguous(),
                               group=mesh.model_group())
    return out.view(B, T // n, H)


def _slice_t(x: torch.Tensor) -> torch.Tensor:
    t = x.shape[1] // mesh.model_size()
    r = mesh.model_rank()
    return x[:, r * t:(r + 1) * t].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherSeq(torch.autograd.Function):
    """All-gather over T; the backward reduce-scatters the partial input
    gradients of the local products."""

    @staticmethod
    def forward(ctx, x):
        return _gather_t(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_t(g)


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _reduce_scatter_t(x)

    @staticmethod
    def backward(ctx, g):
        return _gather_t(g)


class _SplitSeq(torch.autograd.Function):
    """This rank's slice of a replicated (B, T, H); the backward gathers
    the slices' gradients, so the replicated computation before it gets
    the whole gradient."""

    @staticmethod
    def forward(ctx, x):
        return _slice_t(x)

    @staticmethod
    def backward(ctx, g):
        return _gather_t(g)


class _GatherSeqOut(torch.autograd.Function):
    """The whole (B, T, H) from the slices, for replicated computation
    after it: the backward keeps this rank's slice of its (whole)
    gradient."""

    @staticmethod
    def forward(ctx, x):
        return _gather_t(x)

    @staticmethod
    def backward(ctx, g):
        return _slice_t(g)


def column_entry(x: torch.Tensor, seq: bool = False) -> torch.Tensor:
    """The input of the column-parallel products: `x` itself (its slice
    gathered over T under sequence parallelism)."""
    if not active():
        return x
    return _GatherSeq.apply(x) if seq else _CopyToModel.apply(x)


def row_exit(y: torch.Tensor, seq: bool = False) -> torch.Tensor:
    """The row-parallel product's partial output summed over the model
    group (this rank's T slice of the sum under sequence parallelism)."""
    if not active():
        return y
    return _ReduceScatterSeq.apply(y) if seq else _ReduceFromModel.apply(y)


def split_seq(x: torch.Tensor) -> torch.Tensor:
    return _SplitSeq.apply(x) if active() else x


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    return _GatherSeqOut.apply(x) if active() else x


def seq_rows(T_local: int) -> Tuple[int, int]:
    """(first row, whole T) of this rank's slice of T_local rows."""
    return mesh.model_rank() * T_local, T_local * mesh.model_size()


def check_seq_divisible(T: int) -> None:
    """The JAX package's check: T splits evenly over the model axis."""
    n = mesh.model_size()
    if n > 1 and T % n != 0:
        raise ValueError(
            f"--seq-parallel: encoder time dim {T} must be divisible by "
            f"the model-axis size {n} (adjust --src-buckets)")
