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

Reference behaviours kept (steps.py:56-228 of the JAX package):
  * a non-finite loss skips the update: parameters, optimizer state and
    step stay as they were — chosen on the device by `torch.where`, with
    no host round trip; the model state is NOT held back (steps.py:226
    returns the new state whatever the loss was);
  * ``--grad-accum K`` splits the batch interleaved (microbatch m = rows
    [m::K]) and re-weights each microbatch's loss and gradients by its
    non-PAD token count, so the result equals the full batch's;
  * the teacher-forced argmax and gold come back for the train-CER log.
``--steps-per-dispatch K`` needs nothing here: the trainer runs K single
steps, which the JAX package pins equal to its K-step scan.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from end2end_asr_tpu_torch.config import PAD_TOKEN, Config
from end2end_asr_tpu_torch.models.transformer import (ModelDims, forward,
                                                      forward_state)
from end2end_asr_tpu_torch.ops.specaugment import apply_spec_augment
from end2end_asr_tpu_torch.ops.stft import batched_features
from end2end_asr_tpu_torch.training.checkpoint import (SEP, flatten_params,
                                                       unflatten)
from end2end_asr_tpu_torch.training.loss import (calculate_loss,
                                                 token_accuracy)
from end2end_asr_tpu_torch.training.optimizer import (NoamConfig,
                                                      adam_noam_update,
                                                      noam_rate,
                                                      sgd_annealing_update,
                                                      tree_map)

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
                         ).to(self.data.device)


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


def make_train_step_impl(cfg: Config, dims: ModelDims):
    """step(fp, data, opt_state, rng, pcm, n_frames, targets, tgt_lengths,
    spect_T, model_state=None) → (new_data, new_opt_state, new_model_state,
    metrics, hyp_seq, gold). `fp` gives the tree structure, `data` the flat
    parameters; nothing is modified in place. metrics: loss (0 when
    skipped), finite, lr, num_correct, num_token — device tensors."""
    noam = noam_config_from(cfg)
    smoothing, loss_type = cfg.label_smoothing, cfg.loss
    accum = max(1, int(cfg.grad_accum))
    if loss_type not in ("ce", "ctc"):
        raise ValueError(f"loss is not defined: {loss_type}")

    def micro(fp, data, state, rng, pcm, n_frames, targets, tgt_lengths,
              spect_T):
        # each parameter is its own leaf (a detached view of `data`):
        # gradients of views of ONE leaf would each be scattered into a
        # zero-filled buffer of the whole model before they are summed
        leaves = {k: t.detach().requires_grad_()
                  for k, t in fp.views(data).items()}
        spect = features(cfg, pcm, n_frames, spect_T)
        if cfg.spec_augment:
            if rng is None:
                raise ValueError("--spec-augment needs the step's random "
                                 "streams (rng)")
            spect = apply_spec_augment(
                rng.spec, spect, n_frames, n_freq_masks=cfg.n_freq_masks,
                freq_width=cfg.freq_mask_width,
                n_time_masks=cfg.n_time_masks,
                time_width=cfg.time_mask_width)
        pred, gold, new_state = forward_state(
            fp.assemble(leaves), state, spect, n_frames, targets, dims,
            train=True, rng=rng)
        in_lens = ctc_input_lengths(n_frames, spect_T, pred.shape[1])
        loss = calculate_loss(pred, gold, in_lens, tgt_lengths, smoothing,
                              loss_type)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
        grad = torch.cat([g.reshape(-1) for g in grads])
        return loss.detach(), grad, pred.detach(), gold, new_state

    def accumulated(fp, data, state, rng, pcm, n_frames, targets,
                    tgt_lengths, spect_T):
        B = targets.shape[0]
        if B % accum:
            raise ValueError(f"--grad-accum {accum} must divide the batch "
                             f"size {B}")
        g_acc = torch.zeros_like(data)
        loss_acc = torch.zeros((), device=data.device)
        w_acc = torch.zeros((), device=data.device)
        hyps, golds, ncorr = [], [], 0
        for m in range(accum):
            # the state advances once per microbatch (steps.py:104-105)
            loss, grad, pred, gold, state = micro(
                fp, data, state, rng, pcm[m::accum], n_frames[m::accum],
                targets[m::accum], tgt_lengths[m::accum], spect_T)
            # CTC 'mean' weights the equal-sized microbatches uniformly
            w = ((gold != PAD_TOKEN).sum().to(torch.float32)
                 if loss_type == "ce" else torch.ones((), device=data.device))
            g_acc += grad * w
            loss_acc = loss_acc + loss * w
            w_acc = w_acc + w
            hyps.append(pred.argmax(dim=-1))
            golds.append(gold)
            ncorr = ncorr + token_accuracy(pred, gold)
        inv = 1.0 / w_acc.clamp_min(1.0)
        # invert the interleave: row m + accum·i of the batch
        order = lambda xs: torch.stack(xs, dim=1).reshape(B, -1)
        gold = order(golds)
        return (loss_acc * inv, g_acc * inv, order(hyps), gold, ncorr,
                (gold != PAD_TOKEN).sum(), state)

    def step(fp, data, opt_state, rng, pcm, n_frames, targets, tgt_lengths,
             spect_T, model_state=None):
        if accum > 1:
            (loss, grads, hyp_seq, gold, num_correct, num_token,
             new_state) = accumulated(fp, data, model_state, rng, pcm,
                                      n_frames, targets, tgt_lengths, spect_T)
        else:
            loss, grads, pred, gold, new_state = micro(
                fp, data, model_state, rng, pcm, n_frames, targets,
                tgt_lengths, spect_T)
            hyp_seq = pred.argmax(dim=-1)
            num_correct = token_accuracy(pred, gold)
            num_token = (gold != PAD_TOKEN).sum()
        with torch.no_grad():
            finite = torch.isfinite(loss)
            if cfg.opt == "sgd_annealing":
                upd, upd_opt, upd_lr = sgd_annealing_update(
                    data, grads, opt_state, cfg.momentum, cfg.lr_anneal,
                    clip=cfg.clip, max_norm=cfg.max_norm)
                skip_lr = opt_state["lr"]
            else:
                upd, upd_opt, upd_lr = adam_noam_update(
                    data, grads, opt_state, noam, clip=cfg.clip,
                    max_norm=cfg.max_norm)
                skip_lr = noam_rate(opt_state["step"] + 1, noam)
            pick = lambda new, old: torch.where(finite, new, old)
            new_data = pick(upd, data)
            new_opt = tree_map(pick, upd_opt, opt_state)
            metrics = {"loss": torch.where(finite, loss,
                                           torch.zeros_like(loss)),
                       "finite": finite, "lr": pick(upd_lr, skip_lr),
                       "num_correct": num_correct, "num_token": num_token}
        return new_data, new_opt, new_state, metrics, hyp_seq, gold

    return step


def make_eval_step(cfg: Config, dims: ModelDims):
    """eval_step(params, pcm, n_frames, targets, tgt_lengths, spect_T) →
    (loss, hyp_seq, gold): the teacher-forced forward, no dropout, the
    model state read from params["state"] (transformer.with_state)."""

    @torch.no_grad()
    def eval_step(params, pcm, n_frames, targets, tgt_lengths, spect_T):
        spect = features(cfg, pcm, n_frames, spect_T)
        pred, gold = forward(params, spect, n_frames, targets, dims,
                             train=False)
        in_lens = ctc_input_lengths(n_frames, spect_T, pred.shape[1])
        loss = calculate_loss(pred, gold, in_lens, tgt_lengths,
                              cfg.label_smoothing, cfg.loss)
        return loss, pred.argmax(dim=-1), gold

    return eval_step

