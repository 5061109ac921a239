"""Pipeline parallelism (``--mesh-pipe S``, ``--pipe-microbatches M``): the
JAX package's ``parallel/pp.py``, with the GPipe schedule written out.

The ranks form a data x pipe x model grid (parallel/mesh.py `set_layout`;
JAX `make_mesh_pipe` :95). The encoder's and the decoder's layer stacks
split into S contiguous, equal stages (`check_pp_divisibility` :85,
training/checkpoint.py `pipe_stage_tree`); stage s holds layers
[s·L/S, (s+1)·L/S) of each stack and runs them on every microbatch. Each
batch runs as M microbatches (0 means S), split interleaved: microbatch m
is rows [m::M] (`_interleave_split` :131, `_interleave_merge` :138).

What runs where. The JAX package runs everything outside the stacks on
every stage (pp.py:20-26). Here the front end, the encoder's input
projection and the decoder's embedding run on stage 0 alone, and the
output projection and the loss on the last stage alone: the vgg front end
is the heaviest part of the step. The leaves outside the stacks still sit
in every stage's flat buffer; their gradients are summed over the pipe
group, the stages that did not use a leaf adding zeros
(parallel/tp.py `FlatPlan.reduce_pipe_`), so every stage takes the same
update.

The forward (`pipeline_apply` :144). Stage 0 cuts its input into the
microbatches; every stage runs its layers on microbatch m and hands the
activation to the next stage (`send` / `recv`, mesh.TRANSPORT), m = 0,
1, ... in turn, so stage s+1 works on microbatch m while stage s works on
m+1. The encoder's output is merged on the last stage and shared with the
pipe group (`share_last`): it is a constant of every decoder stage's
cross-attention (the JAX package's psum of the outputs, :216-219).

The backward. JAX pipelines it as the transpose of the same program; here
each rank is a process, so the schedule is written out (`Schedule`),
GPipe's: after the M forwards, the M backwards in reverse microbatch
order, each ``torch.autograd.backward(out_m, grad_m)`` on the gradient
received from the next stage, each input's gradient sent to the previous
stage. The decoder goes first. Its stages' gradients of the encoder's
output are summed over the pipe group (every decoder stage reads it) and
taken by the encoder's last stage before the encoder's backward starts.
Stage 0 then runs one backward through what precedes the stack (the
front end, the embedding).

Dropout (JAX: ``fold_in`` of the layer key with the microbatch id,
pp.py:33-37). Each (layer, microbatch) draws from a stream of its own
(models/layers.PipeStream, `DropoutRng.pipe_stream`), which every rank
makes alike: a device generator seeded from the run's seed and the
(stack, layer, microbatch), made once and reused by every step, draws its
plain dropout's bits and its attention kernels' seeds. So a pipelined
step does not depend on the stage count, the ranks of a model group stay
in lockstep under tensor parallelism, and a CUDA graph of K steps
(training/steps.GraphedSteps, which registers the streams' generators)
draws the masks of K single steps. The sequential path's draws are
untouched; the pipelined path's masks differ from them. Under ``--remat``
a recomputed layer redraws its microbatch's masks (models/layers.py
`remat`).

Under a CUDA graph the hand-offs (`send` / `recv`) and the pipe group's
collectives are captured with the step: the graph's warm-up makes every
NCCL communicator they use first. `HANDOFFS` then counts what ran
eagerly; a graph's hand-offs are its captured ones times its replays
(the tracer's graph counters "handoffs" and "replays", GraphedSteps), as
its kernel launches are.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from end2end_asr_tpu_torch.models import layers as L
from end2end_asr_tpu_torch.parallel import mesh

STACKS = ("encoder", "decoder")

_SCHEDULE: Optional["Schedule"] = None      # the forward being recorded


def active() -> bool:
    return mesh.pipe_size() > 1


def first() -> bool:
    return mesh.pipe_rank() == 0


def last() -> bool:
    return mesh.pipe_rank() == mesh.pipe_size() - 1


def n_micro(dims_n_micro: int) -> int:
    """The microbatch count: --pipe-microbatches, 0 meaning S."""
    return int(dims_n_micro) or mesh.pipe_size()


def check_pp_divisibility(cfg, n_pipe: int) -> None:
    """Fail fast when the stacks cannot split into equal stages
    (pp.py:85)."""
    if n_pipe <= 1:
        return
    if cfg.num_layers % n_pipe != 0:
        raise ValueError(
            f"--num-layers {cfg.num_layers} must be divisible by "
            f"--mesh-pipe {n_pipe} (equal layers per pipeline stage)")


def check_microbatches(batch_size: int, n_data: int, grad_accum: int,
                       n_micro_: int) -> None:
    """Root train.py:156-163: M divides the per-device microbatch."""
    per_dev = batch_size // n_data
    if (per_dev // max(1, grad_accum)) % n_micro_ != 0:
        raise SystemExit(
            f"--pipe-microbatches {n_micro_} must divide the "
            f"per-device microbatch "
            f"{per_dev}//{max(1, grad_accum)} (interleaved "
            f"split stays batch-sharded only then)")


def _interleave_split(a: torch.Tensor, m: int) -> torch.Tensor:
    """(B, ...) -> (M, B/M, ...) with microbatch k = rows [k::M]."""
    B = a.shape[0]
    return a.reshape(B // m, m, *a.shape[1:]).transpose(0, 1)


def _interleave_merge(a: torch.Tensor) -> torch.Tensor:
    """Inverse of _interleave_split: (M, B/M, ...) -> (B, ...)."""
    m, bm = a.shape[0], a.shape[1]
    return a.transpose(0, 1).reshape(m * bm, *a.shape[2:])


def stage_range(n_layers: int, n_pipe: int, s: int) -> range:
    """The global indices of stage s's layers."""
    if n_layers % n_pipe:
        raise ValueError(f"{n_layers} layers do not split over {n_pipe} "
                         f"pipeline stages")
    per = n_layers // n_pipe
    return range(s * per, (s + 1) * per)


# ---------------------------------------------------------------------------
# the hand-offs over the pipe group
# ---------------------------------------------------------------------------

# this process's hand-offs: sends and receives, their bytes, and the host
# seconds spent in them (waits for the peer included)
HANDOFFS = {"count": 0, "bytes": 0, "seconds": 0.0}


def reset_handoffs() -> None:
    HANDOFFS.update(count=0, bytes=0, seconds=0.0)


def _count(t: torch.Tensor, t0: float) -> None:
    HANDOFFS["count"] += 1
    HANDOFFS["bytes"] += t.numel() * t.element_size()
    HANDOFFS["seconds"] += time.perf_counter() - t0


def send(t: torch.Tensor, s: int) -> None:
    """`t` to stage `s` of this rank's pipeline (mesh.TRANSPORT)."""
    t0 = time.perf_counter()
    t = t.detach().contiguous()
    if mesh.TRANSPORT == "host":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    dist.send(t, mesh.stage_rank(s))
    _count(t, t0)


def recv(shape, dtype, device, s: int) -> torch.Tensor:
    """A tensor from stage `s` of this rank's pipeline."""
    t0 = time.perf_counter()
    if mesh.TRANSPORT == "host":
        host = torch.empty(shape, dtype=dtype, pin_memory=True)
        dist.recv(host, mesh.stage_rank(s))
        out = host.to(device)
    else:
        out = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(out, mesh.stage_rank(s))
    _count(out, t0)
    return out


def share_from(t: Optional[torch.Tensor], s: int, shape, dtype,
               device) -> torch.Tensor:
    """Stage s's `t` on every stage of the pipe group (a copy)."""
    out = (t.detach().contiguous().clone() if mesh.pipe_rank() == s
           else torch.empty(shape, dtype=dtype, device=device))
    dist.broadcast(out, mesh.stage_rank(s), group=mesh.pipe_group())
    return out


def sum_over_pipe(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the pipe group, in place; returns it."""
    dist.all_reduce(t, group=mesh.pipe_group())
    return t


def share_last(t: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    """The last stage's f32 `t` (the encoder's output) on every stage. In
    a recorded forward each stage gets a leaf of its own, whose gradient
    `Schedule.backward` sums over the pipe group and hands to `t`'s graph
    on the last stage."""
    out = share_from(t, mesh.pipe_size() - 1, shape, torch.float32, device)
    if _SCHEDULE is None or not torch.is_grad_enabled():
        return out
    out.requires_grad_()
    _SCHEDULE.links.append((t, out))
    return out


def share_metrics(loss, hyp, ncorr, gold):
    """The last stage's (loss, argmax hyp, correct-token count or None) of
    a microbatch on every stage: one broadcast of an f32 vector (the ids
    and the count are exact in f32)."""
    n = gold.numel()
    vec = None
    if last():
        nc = torch.zeros(1) if ncorr is None else ncorr.reshape(1)
        vec = torch.cat([loss.detach().reshape(1).float(),
                         nc.to(loss.device).float(),
                         hyp.reshape(-1).float()])
    vec = share_from(vec, mesh.pipe_size() - 1, (n + 2,), torch.float32,
                     gold.device)
    return (vec[0], vec[2:].round().to(torch.int64).view(gold.shape),
            vec[1].round().to(torch.int64))


def share_state(state):
    """Stage 0's model state (emb_cnn's running statistics: the front end
    runs there) on every stage; the others pass theirs for the shapes."""
    from end2end_asr_tpu_torch.training.checkpoint import (flatten_params,
                                                           unflatten)
    flat = flatten_params(state)
    buf = torch.cat([v.reshape(-1).float() for v in flat.values()])
    buf = share_from(buf, 0, buf.shape, buf.dtype, buf.device)
    out, off = {}, 0
    for k, v in flat.items():
        out[k] = buf[off:off + v.numel()].view(v.shape).to(v.dtype)
        off += v.numel()
    return unflatten(out)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

class StackRun:
    """What one stack's forward leaves for its backward on this stage: the
    microbatches' inputs and outputs, stage 0's entry (the tensor before
    the cut and the leaf cut from it), the last stage's output leaves."""

    def __init__(self, entry, entry_leaf):
        self.entry, self.entry_leaf = entry, entry_leaf
        self.xs: List[torch.Tensor] = []
        self.ys: List[torch.Tensor] = []
        self.out_leaves: List[torch.Tensor] = []

    def backward(self) -> None:
        """The M backwards in reverse microbatch order; the gradients of
        the outputs are the last stage's output leaves' or received from
        the next stage; each input's gradient goes to the previous stage;
        stage 0 ends with one backward through its entry."""
        s, S = mesh.pipe_rank(), mesh.pipe_size()
        for m in reversed(range(len(self.ys))):
            y = self.ys[m]
            g = (self.out_leaves[m].grad if s == S - 1
                 else recv(y.shape, y.dtype, y.device, s + 1))
            torch.autograd.backward(y, g)
            if s > 0:
                send(self.xs[m].grad, s - 1)
        if s == 0 and self.entry_leaf.grad is not None:
            torch.autograd.backward(self.entry, self.entry_leaf.grad)


class Schedule:
    """A recorded pipelined forward (`recording`): its stacks' runs, in
    forward order, and the links of `share_last`."""

    def __init__(self):
        self.runs: List[StackRun] = []
        self.links: List[Tuple[Optional[torch.Tensor], torch.Tensor]] = []

    def backward(self) -> None:
        """After the loss's backward on the last stage: the decoder's
        schedule, the encoder output's gradient summed over the pipe group
        and handed to the encoder's last stage, then the encoder's."""
        encoder, decoder = self.runs
        (enc_out, leaf), = self.links
        decoder.backward()
        g = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        g = sum_over_pipe(g.contiguous())
        if last():
            torch.autograd.backward(enc_out, g)
        encoder.backward()


@contextlib.contextmanager
def recording():
    """Record the pipelined forward inside for `Schedule.backward`."""
    global _SCHEDULE
    sched = _SCHEDULE = Schedule()
    try:
        yield sched
    finally:
        _SCHEDULE = None


def pipeline_apply(stage_layers: Sequence, act: Optional[torch.Tensor],
                   consts: Tuple, layer_step: Callable, n_micro_: int = 0,
                   remat: bool = False, *, stack: str, shape,
                   rng: Optional[L.DropoutRng] = None,
                   device=None) -> Optional[torch.Tensor]:
    """Run this stage's layers of one stack on the M microbatches.

    stage_layers: this stage's layer params (global layers first, first +
        1, ... where first = stage · len(stage_layers)).
    act: the (B, ...) f32 activation entering the stack on stage 0 (None
        on the other stages); `shape` is its shape.
    consts: (B, ...) tensors (or None) that go with each microbatch
        unchanged (masks, biases, the encoder's output).
    layer_step(lp, a, consts_m, rng) -> a: ONE layer on a microbatch,
        with the (layer, microbatch) dropout stream or None.
    Returns the stack's output, merged to (B, ...), on the last stage; None
    on the others. Inside `recording()` with gradients on, the forward is
    recorded for `Schedule.backward`.
    """
    s, S = mesh.pipe_rank(), mesh.pipe_size()
    M = n_micro(n_micro_)
    B = shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by "
                         f"--pipe-microbatches {M}")
    mb_shape = (B // M, *shape[1:])
    record = _SCHEDULE is not None and torch.is_grad_enabled()
    lo = s * len(stage_layers)
    entry_leaf = None
    if s == 0:
        device = act.device
        entry_leaf = act.detach().requires_grad_() if record else act
    run = StackRun(act, entry_leaf)
    split = lambda c: None if c is None else _interleave_split(c, M)
    act_mb, consts_mb = split(entry_leaf), [split(c) for c in consts]
    for m in range(M):
        if s == 0:
            x = act_mb[m]
        else:
            x = recv(mb_shape, torch.float32, device, s - 1)
            if record:
                x.requires_grad_()
        cs = tuple(None if c is None else c[m] for c in consts_mb)
        a = x
        for j, lp in enumerate(stage_layers):
            r = (rng.pipe_stream(stack, lo + j, m) if rng is not None
                 else None)
            if remat:
                a = L.remat(lambda o, lp=lp, cs=cs, r=r:
                            layer_step(lp, o, cs, r), r, a)
            else:
                a = layer_step(lp, a, cs, r)
        if s < S - 1:
            send(a, s + 1)
        run.xs.append(x)
        run.ys.append(a)
    if record:
        _SCHEDULE.runs.append(run)
    if s < S - 1:
        return None
    outs = run.ys
    if record:
        run.out_leaves = [y.detach().requires_grad_() for y in run.ys]
        outs = run.out_leaves
    return _interleave_merge(torch.stack(outs))


def gather_stages(tree):
    """The full param tree (or a tree shaped like it) on every rank of the
    pipe group, from each stage's tree: one all-gather of the stages'
    layers; the leaves outside the stacks are this stage's (every stage
    holds the same)."""
    from end2end_asr_tpu_torch.training.checkpoint import (flatten_params,
                                                           pipe_join_trees,
                                                           unflatten)
    S = mesh.pipe_size()
    if S == 1:
        return tree
    layers = flatten_params({k: {"layers": tree[k]["layers"]}
                             for k in STACKS if k in tree})
    buf = torch.cat([v.reshape(-1) for v in layers.values()])
    out = torch.empty(S * buf.numel(), dtype=buf.dtype, device=buf.device)
    dist.all_gather_into_tensor(out, buf, group=mesh.pipe_group())
    trees = []
    for part in out.view(S, -1):
        flat, off = {}, 0
        for k, v in layers.items():
            flat[k] = part[off:off + v.numel()].view(v.shape)
            off += v.numel()
        part_tree = unflatten(flat)
        trees.append({**tree, **{k: {**tree[k], "layers": v["layers"]}
                                 for k, v in part_tree.items()}})
    return pipe_join_trees(trees)
