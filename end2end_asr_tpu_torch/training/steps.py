"""Train and eval steps.

Port of the JAX package's ``training/steps.py``: per batch, PCM → features
on the device (the STFT kernel, ops/stft.py) → optional SpecAugment
(ops/specaugment.py, its own random stream) → forward (the training
kernels: vgg block 1 and its backward, block 2's fused kernels or its pool
backward, the dropout attention) → loss (cross entropy, or CTC with input
lengths n_frames / spect_T · U_out) → backward → optional clip → Noam Adam
(or annealing SGD) update. The model state (the emb_cnn batch norms'
running statistics) goes in and the new one comes out.

The trainable parameters live in ONE flat f32 buffer (`FlatParams`): the
model reads views of it, the gradients are concatenated into one buffer
like it, and the optimizer runs a few elementwise passes over it instead
of a dozen launches per parameter tensor. The sinusoid tables (``pe``) are not in
it: they get no gradient and no update (the JAX package's stop_gradient).

Data parallelism (parallel/mesh.py): each rank runs this step on its
slice of the global batch and produces, for the ranks' sum, its loss and
gradient weighted by its non-PAD token count (CE) or by 1 (CTC: the
shards are equal), and that weight. One all_reduce of the flat gradient
and one of the scalars (loss, weight, num_correct, num_token), then a
division by the summed weight, give every rank the global batch's values,
so every rank takes the same update and the same skip decision. At world
size 1 both collectives are no-ops: the one-process step is this code.
ZeRO-1 / FSDP (parallel/zero.py) reduce-scatter the gradient instead and
update this rank's slice. Under tensor parallelism (parallel/tp.py) the
buffer holds this model coordinate's shard: those collectives run over
the data axis only, the gradients that are partial over the model group
(sequence parallelism's, and the low-rank factors' that a rank uses
through its own columns or rows) are first summed over it, and the
clip's norm counts the split leaves of every coordinate and the
replicated ones once (`plan`, a parallel.tp.FlatPlan). Under pipeline
parallelism (parallel/pp.py) the buffer holds this stage's layers and the
leaves outside the stacks; each microbatch of the step runs the recorded
pipelined forward, the loss on the last stage and GPipe's backward
schedule (pp.Schedule); the stages then sum the gradients of the leaves
outside the stacks, before the data axis's sum, and the clip's norm
counts those leaves once; the last stage's loss, argmax and token count,
and stage 0's model state, are shared with the pipe group, so the skip
decision is the same on every rank.

Reference behaviours kept (steps.py:56-228 of the JAX package):
  * a non-finite loss skips the update: parameters, optimizer state and
    step stay as they were — chosen on the device by `torch.where`, with
    no host round trip; the model state is NOT held back (steps.py:226
    returns the new state whatever the loss was);
  * ``--grad-accum K`` splits the batch interleaved (microbatch m = rows
    [m::K]) and weights each microbatch's loss and gradients by its
    non-PAD token count, so the result equals the full batch's (nested
    inside the sum over the ranks: the split of the local batch);
  * the teacher-forced argmax and gold come back for the train-CER log.

``--steps-per-dispatch K`` (`make_multi_train_step`, the JAX package's
K-step ``lax.scan``): the trainer hands K consecutive same-shape batches
to one call. On a CUDA device the call replays ONE CUDA graph of the K
steps, captured once a batch shape (`GraphedSteps`): one launch and one
metrics pull a group instead of ~1300 launches a step. The dropout seeds
are read from device memory (models/layers.DropoutRng), so a replay
draws the masks that K single steps draw; under pipeline parallelism the
graph holds the hand-offs between stages and the pipe group's
collectives, and its (layer, microbatch) dropout streams' generators are
registered with it. On CPU tensors the K steps run one after another,
their seeds drawn at once as the graph's are.

The tracer (utils/profiling.RECORDER) stamps each step on its device, so
that a replayed graph's parts are timed: at its start, after the loss
(forward), after the gradients' concatenation (backward) and after the
update; under ``--grad-accum`` the forward and backward stamps mark each
microbatch, so a part sums over them; under pipeline parallelism they
bracket the schedule on the main stream.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from end2end_asr_tpu_torch.config import PAD_TOKEN, Config
from end2end_asr_tpu_torch.models.transformer import (ModelDims, forward,
                                                      forward_state)
from end2end_asr_tpu_torch.ops import cuda_lib
from end2end_asr_tpu_torch.ops.specaugment import apply_spec_augment
from end2end_asr_tpu_torch.ops.stft import batched_features
from end2end_asr_tpu_torch.parallel import mesh, pp
from end2end_asr_tpu_torch.training.checkpoint import (SEP, flatten_params,
                                                       unflatten)
from end2end_asr_tpu_torch.training.loss import (calculate_loss,
                                                 token_accuracy)
from end2end_asr_tpu_torch.training.optimizer import (NoamConfig,
                                                      adam_noam_update,
                                                      noam_rate,
                                                      sgd_annealing_update,
                                                      tree_map)
from end2end_asr_tpu_torch.utils import profiling
from end2end_asr_tpu_torch.utils.profiling import (BACKWARD,
                                                   DISPATCH_END,
                                                   DISPATCH_START, FORWARD,
                                                   STEP_START, UPDATE,
                                                   WRITEBACK)

FIXED_LEAVES = ("pe",)  # no gradient, no update


class FlatParams:
    """The param pytree as one flat f32 buffer of its trainable leaves
    (`data`) plus the fixed leaves. `tree(buf)` is the pytree whose
    trainable leaves are views of `buf`, in the original key order."""

    def __init__(self, params, device):
        flat = flatten_params(params)
        self.order = list(flat)
        self.train_keys = [k for k in self.order
                           if k.split(SEP)[-1] not in FIXED_LEAVES]
        self.fixed = {k: flat[k].to(device) for k in self.order
                      if k not in self.train_keys}
        self.shapes = [tuple(flat[k].shape) for k in self.train_keys]
        self.sizes = [flat[k].numel() for k in self.train_keys]
        self.data = torch.cat([flat[k].reshape(-1).to(torch.float32)
                               for k in self.train_keys]).to(device)
        self.device = self.data.device
        self.numel = self.data.numel()

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for k, shape, n in zip(self.train_keys, self.shapes, self.sizes):
            out[k] = buf[off:off + n].view(shape)
            off += n
        return out

    def tree(self, buf: Optional[torch.Tensor] = None, fixed: str = "keep"):
        """The pytree over `buf` (default: the parameters). fixed="zeros"
        puts zeros at the fixed leaves (optimizer moments: the JAX
        package's moments of the tables are zero)."""
        buf = self.data if buf is None else buf
        return self.assemble(self.views(buf), buf.dtype if fixed == "zeros"
                             else None)

    def assemble(self, trainable: Dict[str, torch.Tensor],
                 zeros_dtype=None):
        """The pytree of the given trainable leaves and the fixed leaves
        (zeros of `zeros_dtype` when given)."""
        v = dict(trainable)
        for k, t in self.fixed.items():
            v[k] = (t if zeros_dtype is None else
                    torch.zeros(t.shape, dtype=zeros_dtype, device=t.device))
        return unflatten({k: v[k] for k in self.order})

    def flatten(self, tree) -> torch.Tensor:
        """The trainable leaves of a tree of this structure as one buffer
        on the parameters' device."""
        flat = flatten_params(tree)
        return torch.cat([flat[k].reshape(-1) for k in self.train_keys]
                         ).to(self.device)


def noam_config_from(cfg: Config) -> NoamConfig:
    # model_size = dim_input (with the conv arithmetic): reference quirk,
    # utils/functions.py:101-107
    return NoamConfig(model_size=cfg.conv_dim_input(), factor=cfg.k_lr,
                      warmup=cfg.warmup, min_lr=cfg.min_lr)


def features(cfg: Config, pcm: torch.Tensor, n_frames: torch.Tensor,
             spect_T: int) -> torch.Tensor:
    """The normalised spectrogram of a batch: the STFT kernel, or its
    plain version under ``--no-pallas-features`` (steps.py:43-53)."""
    return batched_features(pcm, n_frames, cfg.n_fft, cfg.hop_length,
                            cfg.window, T_out=spect_T, normalize=True,
                            use_kernel=cfg.use_pallas_features)


def ctc_input_lengths(n_frames: torch.Tensor, spect_T: int,
                      U_out: int) -> torch.Tensor:
    """The CTC input lengths of steps.py:88-92: the valid share of the
    spectrogram's frames, scaled to the U_out output positions, computed
    in f32 and truncated."""
    return (n_frames.to(torch.float32) / spect_T * U_out).to(torch.int32)


def make_train_step_impl(cfg: Config, dims: ModelDims, zero=None,
                         plan=None):
    """step(fp, data, opt_state, rng, pcm, n_frames, targets, tgt_lengths,
    spect_T, model_state=None) → (new_data, new_opt_state, new_model_state,
    metrics, hyp_seq, gold). `fp` gives the tree structure, `data` the flat
    parameters; nothing is modified in place. metrics: loss (0 when
    skipped), finite, lr, num_correct, num_token — device tensors, the
    global batch's. hyp_seq and gold are this rank's rows.

    Under data parallelism (parallel/mesh.py) the batch is this rank's
    slice of the global batch; the step is built after the process group
    is up. `zero` (a parallel.zero.ZeroShard) shards the optimizer state
    (--zero1) and the parameters (--fsdp): `data` and the moments are then
    this rank's slices at stage 3, the moments alone at stage 1. `plan`
    (a parallel.tp.FlatPlan) is given under tensor and pipeline
    parallelism."""
    noam = noam_config_from(cfg)
    smoothing, loss_type = cfg.label_smoothing, cfg.loss
    accum = max(1, int(cfg.grad_accum))
    world, rank = mesh.data_size(), mesh.data_rank()
    pipe = dims.pipeline and pp.active()
    if loss_type not in ("ce", "ctc"):
        raise ValueError(f"loss is not defined: {loss_type}")

    def micro(fp, data, state, rng, pcm, n_frames, targets, tgt_lengths,
              spect_T):
        # each parameter is its own leaf (a detached view of `data`):
        # gradients of views of ONE leaf would each be scattered into a
        # zero-filled buffer of the whole model before they are summed
        leaves = {k: t.detach().requires_grad_()
                  for k, t in fp.views(data).items()}
        spect = None
        if not pipe or pp.first():
            spect = features(cfg, pcm, n_frames, spect_T)
        if cfg.spec_augment and spect is not None:
            if rng is None:
                raise ValueError("--spec-augment needs the step's random "
                                 "streams (rng)")
            # the bands of the global microbatch, this rank's rows kept
            b = targets.shape[0]
            spect = apply_spec_augment(
                rng.spec, spect, n_frames, n_freq_masks=cfg.n_freq_masks,
                freq_width=cfg.freq_mask_width,
                n_time_masks=cfg.n_time_masks,
                time_width=cfg.time_mask_width, rows=(rank * b, world * b))
        with (pp.recording() if pipe else contextlib.nullcontext()) as sched:
            pred, gold, new_state = forward_state(
                fp.assemble(leaves), state, spect, n_frames, targets, dims,
                train=True, rng=rng, spect_T=spect_T)
        # the weight of this microbatch in the sum over microbatches and
        # ranks: its non-PAD tokens for CE; CTC 'mean' weighs the equal
        # shards alike. The backward runs on the weighted loss, so that a
        # collective inside it (emb_cnn's global batch norm) sums
        # gradients of the weighted losses of all ranks
        w = ((gold != PAD_TOKEN).sum().to(torch.float32)
             if loss_type == "ce" else torch.ones((), device=data.device))
        loss = hyp = ncorr = None
        if pred is not None:
            in_lens = ctc_input_lengths(n_frames, spect_T, pred.shape[1])
            loss = calculate_loss(pred, gold, in_lens, tgt_lengths,
                                  smoothing, loss_type)
            hyp, ncorr = pred.detach().argmax(dim=-1), token_accuracy(
                pred.detach(), gold)
        profiling.RECORDER.stamp(FORWARD, data.device)
        if not pipe:
            grads = torch.autograd.grad(loss * w, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        else:
            # GPipe's backward (parallel/pp.py): the loss on the last
            # stage, then the stacks' schedules; the last stage's loss,
            # hyp and count on every stage
            if loss is not None:
                torch.autograd.backward(loss * w)
            sched.backward()
            grads = [torch.zeros_like(t) if t.grad is None else t.grad
                     for t in leaves.values()]
            loss, hyp, ncorr = pp.share_metrics(loss, hyp, ncorr, gold)
            if new_state:
                new_state = pp.share_state(new_state)
        grad = torch.cat([g.reshape(-1) for g in grads])
        profiling.RECORDER.stamp(BACKWARD, data.device)
        return loss.detach() * w, grad, w, hyp, ncorr, gold, new_state

    def local_sums(fp, data, state, rng, pcm, n_frames, targets,
                   tgt_lengths, spect_T):
        """This rank's weighted loss and gradient sums over the
        microbatches (`--grad-accum`: the interleaved split, microbatch m
        = rows [m::K]), their weight, and its rows' metrics."""
        B = targets.shape[0]
        if B % accum:
            raise ValueError(f"--grad-accum {accum} must divide the batch "
                             f"size {B}")
        g_acc = loss_acc = w_acc = None
        hyps, golds, ncorr = [], [], 0
        for m in range(accum):
            # the state advances once per microbatch (steps.py:104-105)
            loss_w, grad, w, hyp, nc, gold, state = micro(
                fp, data, state, rng, pcm[m::accum], n_frames[m::accum],
                targets[m::accum], tgt_lengths[m::accum], spect_T)
            if g_acc is None:
                g_acc, loss_acc, w_acc = grad, loss_w, w
            else:
                g_acc, loss_acc, w_acc = g_acc + grad, loss_acc + loss_w, \
                    w_acc + w
            hyps.append(hyp)
            golds.append(gold)
            ncorr = ncorr + nc
        # invert the interleave: row m + accum·i of the batch
        order = lambda xs: torch.stack(xs, dim=1).reshape(B, -1)
        gold = order(golds)
        return (loss_acc, g_acc, w_acc, order(hyps), gold, ncorr,
                (gold != PAD_TOKEN).sum(), state)

    def step(fp, data, opt_state, rng, pcm, n_frames, targets, tgt_lengths,
             spect_T, model_state=None):
        profiling.RECORDER.stamp(STEP_START, data.device)
        full = zero.gather(data) if zero is not None and zero.stage == 3 \
            else data
        if rng is not None:
            rng.begin_step()        # this step's kernel seeds
        (loss_w, g, w, hyp_seq, gold, ncorr, ntok,
         new_state) = local_sums(fp, full, model_state, rng, pcm, n_frames,
                                 targets, tgt_lengths, spect_T)
        if rng is not None:
            rng.end_step()
        del full        # --fsdp: the gathered parameters go here
        with torch.no_grad():
            if plan is not None:
                plan.reduce_partial_(g)     # over the model group
                plan.reduce_pipe_(g)        # the pipeline's stages
            # the sums over the ranks: one collective for the gradient,
            # one for the scalars (world size 1: neither runs)
            small = mesh.all_reduce_(torch.stack(
                [loss_w.to(torch.float32), w, ncorr.to(torch.float32),
                 ntok.to(torch.float32)]))
            g = (mesh.all_reduce_(g) if zero is None
                 else zero.reduce_scatter(g))
            inv = 1.0 / small[1].clamp_min(1.0)
            loss, grads = small[0] * inv, g * inv
            num_correct = small[2].round().to(torch.int64)
            num_token = small[3].round().to(torch.int64)
            finite = torch.isfinite(loss)
            # the update runs on the whole buffer, or on this rank's slice
            params = data if zero is None or zero.stage == 3 \
                else zero.shard(data)
            # under ZeRO the clip's squared sum is the slices' over the
            # data axis; under TP and PP the coordinates' and the stages'
            reduce_sq = None if zero is None else mesh.all_reduce_
            sq_weight = None
            if plan is not None:
                sq_weight = plan.sq_weight if zero is None \
                    else zero.shard(plan.sq_weight)
                over_data = reduce_sq
                reduce_sq = lambda sq: plan.sum_sq(
                    sq if over_data is None else over_data(sq))
            if cfg.opt == "sgd_annealing":
                upd, upd_opt, upd_lr = sgd_annealing_update(
                    params, grads, opt_state, cfg.momentum, cfg.lr_anneal,
                    clip=cfg.clip, max_norm=cfg.max_norm,
                    reduce_sq=reduce_sq, sq_weight=sq_weight)
                skip_lr = opt_state["lr"]
            else:
                upd, upd_opt, upd_lr = adam_noam_update(
                    params, grads, opt_state, noam, clip=cfg.clip,
                    max_norm=cfg.max_norm, reduce_sq=reduce_sq,
                    sq_weight=sq_weight)
                skip_lr = noam_rate(opt_state["step"] + 1, noam)
            pick = lambda new, old: torch.where(finite, new, old)
            new_data = pick(upd, params)
            if zero is not None and zero.stage == 1:
                new_data = zero.gather(new_data)
            new_opt = tree_map(pick, upd_opt, opt_state)
            metrics = {"loss": torch.where(finite, loss,
                                           torch.zeros_like(loss)),
                       "finite": finite, "lr": pick(upd_lr, skip_lr),
                       "num_correct": num_correct, "num_token": num_token}
        profiling.RECORDER.stamp(UPDATE, data.device)
        return new_data, new_opt, new_state, metrics, hyp_seq, gold

    return step


def make_multi_train_step(cfg: Config, step, steps: int,
                          device: torch.device):
    """K = `steps` optimizer steps in one dispatch (--steps-per-dispatch;
    the JAX package's make_multi_train_step): multi(fp, data, opt_state,
    rng, batches, spect_T, model_state) with `batches` K tuples (pcm,
    n_frames, targets, tgt_lengths) of one shape → (data, opt_state,
    model_state, metrics {name: (K,)}, hyps (K, B, U), golds (K, B, U)),
    equal to K calls of `step` (make_train_step_impl's). On a CUDA device
    one CUDA graph a shape (GraphedSteps), whatever the data x pipe x model
    layout; raises ValueError where the graph cannot be captured (a gloo
    group), never runs the steps eagerly there. On the CPU the K steps run
    one after another."""
    if device.type == "cuda":
        if dist.is_available() and dist.is_initialized() \
                and dist.get_backend() == "gloo":
            raise ValueError(
                "--steps-per-dispatch > 1 on a CUDA device captures the "
                "steps in a CUDA graph, and gloo's collectives run on the "
                "host, outside any graph: use the NCCL backend (one card a "
                "rank)")
        return GraphedSteps(step, steps)
    return EagerSteps(step)


def stack_outputs(outs):
    """K steps' (metrics, hyp, gold) as ({name: (K,)}, (K, B, U),
    (K, B, U))."""
    ms = {k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]}
    return (ms, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


class EagerSteps:
    """K train steps one after another (the CPU's K-step dispatch), their
    kernel seeds drawn at once (DropoutRng.group) as a graph's are, once a
    step has set how many a step takes. The tracer records the call as a
    ``dispatch`` span with a ``step`` span a step, between the dispatch's
    stamps."""

    def __init__(self, step):
        self.step = step

    def __call__(self, fp, data, opt_state, rng, batches: Sequence,
                 spect_T: int, model_state=None):
        rec, dev = profiling.RECORDER, data.device
        outs = []
        with rec.span("dispatch"):
            rec.stamp(DISPATCH_START, dev)
            with (rng.group(len(batches)) if rng is not None
                  and rng.per_step is not None
                  else contextlib.nullcontext()):
                for b in batches:
                    with rec.span("step"):
                        data, opt_state, model_state, m, hyp, gold = \
                            self.step(fp, data, opt_state, rng, *b, spect_T,
                                      model_state=model_state)
                    outs.append((m, hyp, gold))
            out = (data, opt_state, model_state, *stack_outputs(outs))
            rec.stamp(DISPATCH_END, dev)
        return out

    def close(self) -> None:
        pass


class GraphedSteps:
    """K train steps as one CUDA graph a batch shape.

    The graphs share one memory pool and one set of static buffers for
    the flat parameters, the optimizer state and the model state; each
    graph has its own static inputs (the K stacked batches) and outputs
    (the metrics, hyps and golds of its K steps). A call copies the live
    state into the static buffers (unless it is them: the state a call
    returns), the batches into the inputs, draws the K steps' kernel
    seeds into device memory (DropoutRng.group), replays, and returns the
    static state and copies of the outputs. Each step of the graph writes
    its new parameters, optimizer state and model state back into the
    static buffers, so the next step reads them.

    A shape's first call warms the K steps up on a side stream (the
    streams and the state restored after), then captures them with the
    dropout generators registered (pipeline parallelism's streams' too),
    so that each replay advances them as K eager steps do. The warm-up
    runs every collective and hand-off of the steps, which makes their
    NCCL communicators before the capture. Capture or replay failing
    raises: nothing falls back to eager steps.

    The tracer (utils/profiling.RECORDER) times it: a ``dispatch`` span a
    call with ``stage`` (the input copies, the state's load, the seeds'
    draw), ``launch`` (the replay) and ``outputs`` (their copies), and
    ``capture``; device stamps at the call's start and end and, inside
    the graph, after each step's write-back of its state (besides the
    step's own). Its graph counters, under (`tag`, shape), hold each
    shape's kernel launches of the K steps ("launches": the bindings'
    counts of the capture, put back after it, since a capture runs
    nothing), its pipeline hand-offs ("handoffs", count and bytes, put
    back likewise), the bytes the pool grew by at its capture ("memory"),
    its replays ("replays") and the nodes each part added to the graph
    (`Recorder.counting`)."""

    def __init__(self, step, steps: int):
        self.step, self.K = step, steps
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, tuple] = {}
        self.static = None
        self.tag = profiling.RECORDER.owner("graphed_steps")
        self.per_step: Optional[int] = None    # kernel seeds a step

    # -- the static state ---------------------------------------------------
    def _state_tensors(self, data, opt, model_state) -> List[torch.Tensor]:
        return ([data] + [opt[k] for k in sorted(opt)]
                + list(flatten_params(model_state or {}).values()))

    def _load(self, data, opt, model_state) -> None:
        live = self._state_tensors(data, opt, model_state)
        if self.static is None:
            state = flatten_params(model_state or {})
            self.static = (data.clone(),
                           {k: v.clone() for k, v in opt.items()},
                           unflatten({k: v.clone() for k, v in state.items()}))
        for dst, src in zip(self._state_tensors(*self.static), live):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)

    def _body(self, fp, rng, inputs, spect_T, steps=None):
        data, opt, state = self.static
        outs = []
        for j in range(steps or self.K):
            new = self.step(fp, data, opt, rng, *(t[j] for t in inputs),
                            spect_T, model_state=state)
            for dst, src in zip(self._state_tensors(data, opt, state),
                                self._state_tensors(*new[:3])):
                dst.copy_(src)
            profiling.RECORDER.stamp(WRITEBACK, data.device)
            outs.append(new[3:])
        return stack_outputs(outs)

    def _capture(self, key, fp, rng, inputs, spect_T):
        rec = profiling.RECORDER
        with rec.span("capture"):
            st = rng.state()
            backup = [t.clone() for t in self._state_tensors(*self.static)]
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            # the warm-up (autograd, the kernels' libraries, the caches):
            # the K steps as the graph will run them, after one single step
            # where no step has yet set how many seeds a step draws
            with torch.cuda.stream(side):
                if rng.per_step is None:
                    self._body(fp, rng, inputs, spect_T, steps=1)
                with rng.group(self.K):
                    self._body(fp, rng, inputs, spect_T)
            cur.wait_stream(side)
            rng.set_state(st)
            self.per_step = rng.per_step
            graph = torch.cuda.CUDAGraph()
            for gen in rng.generators():
                graph.register_generator_state(gen)
            counts = cuda_lib.launch_counts()
            handoffs = dict(pp.HANDOFFS)
            torch.cuda.synchronize()
            # the pool's growth: the capture empties the allocator's cache
            # first, so measure from an empty cache
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            with rng.group(self.K):
                with torch.cuda.graph(graph, pool=self.pool,
                                      capture_error_mode="thread_local"):
                    with rec.counting(self.tag, key, self.K):
                        outs = self._body(fp, rng, inputs, spect_T)
            torch.cuda.synchronize()
            now = cuda_lib.launch_counts()
            rec.graph(self.tag, key).update(
                memory=torch.cuda.memory_reserved() - reserved,
                launches={k: now[k] - counts[k] for k in now
                          if now[k] != counts[k]},
                handoffs={k: pp.HANDOFFS[k] - handoffs[k]
                          for k in ("count", "bytes")},
                replays=0)
            cuda_lib.set_launch_counts(counts)
            pp.HANDOFFS.update(handoffs)
            rng.set_state(st)
            for dst, src in zip(self._state_tensors(*self.static), backup):
                dst.copy_(src)
            self.graphs[key] = (graph, inputs, outs)

    def __call__(self, fp, data, opt_state, rng, batches: Sequence,
                 spect_T: int, model_state=None):
        if len(batches) != self.K:
            raise ValueError(f"a group holds {self.K} batches, got "
                             f"{len(batches)}")
        key = (spect_T,) + tuple((tuple(t.shape), t.dtype)
                                 for t in batches[0])
        rec, dev = profiling.RECORDER, data.device
        with rec.span("dispatch"):
            rec.stamp(DISPATCH_START, dev)
            if self.static is None:
                self._load(data, opt_state, model_state)
            entry = self.graphs.get(key)
            if entry is None:
                inputs = [torch.stack([b[i] for b in batches])
                          for i in range(len(batches[0]))]
                self._capture(key, fp, rng, inputs, spect_T)
                entry = self.graphs[key]
            graph, inputs, outs = entry
            with rec.span("stage"):
                for i, buf in enumerate(inputs):
                    for j, b in enumerate(batches):
                        buf[j].copy_(b[i])
                self._load(data, opt_state, model_state)
                if rng.per_step is None:    # a stream that has run no step
                    rng.per_step = self.per_step
                with rng.group(self.K):     # the K steps' kernel seeds
                    rng.slot = rng.drawn
            with rec.span("launch"):
                graph.replay()
            rec.graph(self.tag, key)["replays"] += 1
            with rec.span("outputs"):
                ms, hyps, golds = outs
                out = (*self.static, {k: v.clone() for k, v in ms.items()},
                       hyps.clone(), golds.clone())
            rec.stamp(DISPATCH_END, dev)
        return out

    def close(self) -> None:
        """Free the graphs (before the process group goes: destroying an
        NCCL group whose collectives a live graph holds hangs), and copy
        the tracer's stamps out."""
        torch.cuda.synchronize()
        profiling.RECORDER.collect()
        for graph, _, _ in self.graphs.values():
            graph.reset()
        self.graphs.clear()


def make_eval_step(cfg: Config, dims: ModelDims):
    """eval_step(params, pcm, n_frames, targets, tgt_lengths, spect_T) →
    (loss, hyp_seq, gold): the teacher-forced forward, no dropout, the
    model state read from params["state"] (transformer.with_state);
    pipelined under a pipe layout, as the JAX package's eval forward, the
    last stage's loss and hyp shared with every stage."""
    pipe = dims.pipeline and pp.active()

    @torch.no_grad()
    def eval_step(params, pcm, n_frames, targets, tgt_lengths, spect_T):
        spect = (features(cfg, pcm, n_frames, spect_T)
                 if not pipe or pp.first() else None)
        pred, gold = forward(params, spect, n_frames, targets, dims,
                             train=False, spect_T=spect_T)
        loss = hyp = None
        if pred is not None:
            in_lens = ctc_input_lengths(n_frames, spect_T, pred.shape[1])
            loss = calculate_loss(pred, gold, in_lens, tgt_lengths,
                                  cfg.label_smoothing, cfg.loss)
            hyp = pred.argmax(dim=-1)
        if pipe:
            loss, hyp, _ = pp.share_metrics(loss, hyp, None, gold)
        return loss, hyp, gold

    return eval_step
