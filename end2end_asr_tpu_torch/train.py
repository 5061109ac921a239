"""Training CLI of the port — the flags of root ``train.py`` plus
``--device`` (default ``cuda``).

    python -m end2end_asr_tpu_torch.train --train-manifest-list train.csv \
        --valid-manifest-list dev.csv --labels-path labels.json --name run \
        --feat_extractor vgg_cnn ... [--continue-from ckpt | --auto-resume] \
        [--augment] [--noise-dir noise/] [--device cpu]

Builds the vocabulary (duplicate labels warned), the train loader (the
shuffled BucketingSampler of the run's seed; tempo/gain augmentation with
``--augment``, noise mixed in from ``--noise-dir`` with probability
``--noise-prob``; ``--num-workers`` > 1 gives each row its own
generator, as the JAX loader does) and one valid
loader per manifest, initialises the model from the seed or resumes from
``--continue-from`` / ``--auto-resume`` (checkpoints of either package:
parameters, optimizer state, epoch, metrics; a converted reference
checkpoint's Noam step), and runs the Trainer (``multi_train`` passes
MultiTrainer). Logs to log/<name> and tees the console output into
log/<name>.stdout (both appended to on resume). ``--trace-dir`` takes a
torch.profiler trace of the first epoch. Without a GPU it raises unless
--device cpu is given; on the card TF32 is off
(``evaluation.resolve_device``). ``--spec-augment``, ``--loss ctc``,
``--remat`` and ``--feat_extractor emb_cnn`` (whose batch-norm statistics
are saved and resumed as the checkpoint's model state) are taken as root
``train.py`` takes them.

Data parallelism: ``--parallel`` under torchrun, one process a rank
(parallel/mesh.py; ``nccl`` when each rank has a card of its own,
``gloo`` when ranks share one or run on the CPU), each loader building
its rank's slice of every batch (ragged bins cycled to the full batch);
``--zero1`` / ``--fsdp`` shard the optimizer state / and the parameters
over the ranks (parallel/zero.py). Rank 0 alone logs and writes
checkpoints. Without torchrun's environment ``--parallel`` runs one rank.

    torchrun --standalone --nproc_per_node N -m end2end_asr_tpu_torch.train \
        --parallel [--zero1 | --fsdp] ...        # N cards
    torchrun --standalone --nproc_per_node 2 -m end2end_asr_tpu_torch.train \
        --parallel --device cpu ...              # gloo on the CPU

Tensor parallelism: ``--parallel --mesh-model M`` lays the ranks out as
data x model, model innermost (``--mesh-data`` x M ranks), and each
model coordinate trains its shard of the attention projections and FFN
inner columns (parallel/tp.py); ``--seq-parallel`` also shards the
encoder's time axis between them. ``--checkpoint-format orbax`` writes
the port's sharded checkpoint, ``<base>.dcp/`` (training/checkpoint.py),
which loads at any layout and in one process.

    torchrun --standalone --nproc_per_node 4 -m end2end_asr_tpu_torch.train \
        --parallel --mesh-data 2 --mesh-model 2 [--seq-parallel] \
        [--zero1 | --fsdp] [--checkpoint-format orbax] ...

Pipeline parallelism: ``--parallel --mesh-pipe S`` splits the encoder's
and the decoder's layers into S stages (the layers must divide by S),
ranks laid out data x pipe x model (parallel/mesh.py), and each batch
runs as ``--pipe-microbatches M`` microbatches (0: S; M must divide the
per-device microbatch) on GPipe's schedule (parallel/pp.py). It composes
with --mesh-data, --mesh-model (TP inside each stage), --zero1 / --fsdp
(each stage's buffer sliced over the data axis), --remat, --grad-accum
and --clip, not with --seq-parallel. Stage 0 (rank 0) logs and saves the
gathered checkpoint, the one-process run's file; ``test`` and
``transcribe`` serve it without a pipeline.

    torchrun --standalone --nproc_per_node 4 -m end2end_asr_tpu_torch.train \
        --parallel --mesh-pipe 2 [--pipe-microbatches 4] [--mesh-data 2 |
        --mesh-model 2] [--zero1 | --fsdp] [--remat] ...
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Dict, List, Optional

import torch

from end2end_asr_tpu_torch.config import (ARCH_FIELDS, Config,
                                          config_from_args,
                                          explicit_cli_overrides, load_vocab,
                                          resolve_labels_path)
from end2end_asr_tpu_torch.utils.logger import Logger

logger = logging.getLogger("end2end_asr_tpu_torch")


def refuse_unported(cfg: Config) -> None:
    """Raise NotImplementedError for every option of root train.py that
    the port does not have yet (and root train.py's SystemExit where a
    flag needs --parallel)."""
    if cfg.mesh_pipe > 1 and not cfg.parallel:
        raise SystemExit("--mesh-pipe requires --parallel")
    if cfg.quantize_int8:
        raise SystemExit("--quantize-int8 is eval-only (test/transcribe); "
                         "training runs f32 master weights")
    if cfg.seq_parallel and not (cfg.parallel and cfg.mesh_model > 1):
        raise SystemExit("--seq-parallel requires --parallel "
                         "--mesh-model N (N > 1): it shards the "
                         "encoder time axis across the 'model' axis")
    if cfg.seq_parallel and cfg.mesh_pipe > 1:
        raise SystemExit(
            "--seq-parallel does not compose with --mesh-pipe: the "
            "pipeline's microbatch activations are already 1/M "
            "size, and SP's time-axis constraints inside the "
            "pipelined region are untested — pick one")
    if (cfg.zero1 or cfg.fsdp) and not cfg.parallel:
        raise SystemExit("--zero1/--fsdp require --parallel: they "
                         "shard optimizer moments (and, for --fsdp, "
                         "parameters) over the 'data' mesh axis")
    if cfg.parallel:
        from end2end_asr_tpu_torch.parallel.pp import check_pp_divisibility
        from end2end_asr_tpu_torch.parallel.tp import check_tp_divisibility
        check_pp_divisibility(cfg, cfg.mesh_pipe)
        check_tp_divisibility(cfg, cfg.mesh_model)


def _warn_duplicate_labels(labels_path: str) -> None:
    with open(resolve_labels_path(labels_path), encoding="utf-8") as f:
        raw = "".join(json.load(f))
    seen = set()
    for ch in raw:
        if ch in seen:
            print("multiple label: ", ch)
        seen.add(ch)


def main(argv: Optional[List[str]] = None, trainer_cls=None) -> Dict:
    """Runs the training with `trainer_cls` (default Trainer) and returns
    its result dict."""
    from end2end_asr_tpu_torch.test import split_device_arg
    if argv is None:
        argv = sys.argv[1:]
    device_name, argv = split_device_arg(argv)
    cfg = config_from_args(argv)
    refuse_unported(cfg)

    from end2end_asr_tpu_torch.data.dataset import (ManifestDataset,
                                                    NoiseInjector)
    from end2end_asr_tpu_torch.data.loader import (AudioBatchLoader,
                                                   BucketingSampler)
    from end2end_asr_tpu_torch.evaluation import resolve_device
    from end2end_asr_tpu_torch.models.transformer import (init_params,
                                                          init_state)
    from end2end_asr_tpu_torch.parallel import mesh
    from end2end_asr_tpu_torch.training import checkpoint as ckpt
    from end2end_asr_tpu_torch.training.trainer import Trainer

    device = mesh.rank_device(resolve_device(device_name))
    world, started = (mesh.join_group(device, cfg.mesh_data, cfg.batch_size,
                                      cfg.grad_accum, cfg.mesh_model,
                                      cfg.mesh_pipe)
                      if cfg.parallel else (1, False))
    if cfg.parallel and cfg.mesh_pipe > 1:
        from end2end_asr_tpu_torch.parallel import pp
        pp.check_microbatches(cfg.batch_size, world, cfg.grad_accum,
                              pp.n_micro(cfg.pipe_microbatches))
    main_rank = mesh.is_main()
    os.makedirs("log", exist_ok=True)
    # append on resume: a resumed run keeps the history of the runs before
    resuming = bool(cfg.continue_from or cfg.auto_resume)
    mode = "a" if resuming else "w"
    # rank 0 alone logs: the console output goes to log/<name>.stdout too
    # (root train.py's tee); the other ranks log warnings only
    tee = Logger("log/" + cfg.name + ".stdout", mode=mode) if main_rank \
        else None
    if tee is not None:
        sys.stdout = tee
        handler = logging.FileHandler("log/" + cfg.name, mode=mode,
                                      encoding="utf-8")
        handler.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
    else:
        handler = logging.NullHandler()
    logger.addHandler(handler)
    logger.setLevel(logging.INFO if main_rank else logging.WARNING)
    try:
        if cfg.parallel:
            logger.info(mesh.describe(device))
        if cfg.parallel and cfg.mesh_pipe > 1:
            logger.info("pipeline: %d stages, %d microbatches",
                        cfg.mesh_pipe, pp.n_micro(cfg.pipe_microbatches))
        if main_rank:
            print("=" * 50)
            print("THE EXPERIMENT LOG IS SAVED IN: log/" + cfg.name)
            print("TRAINING MANIFEST: ", list(cfg.train_manifest_list))
            print("VALID MANIFEST: ", list(cfg.valid_manifest_list))
            print("=" * 50)
        start_epoch, metrics, opt_state = 0, None, None
        if cfg.auto_resume and not cfg.continue_from:
            # every rank reads the same checkpoint
            latest = ckpt.find_latest_checkpoint(cfg.save_folder, cfg.name)
            if latest:
                if main_rank:
                    print("AUTO-RESUME from", latest)
                cfg = cfg.replace(continue_from=latest)
        if cfg.continue_from:
            logger.info("Continue from checkpoint: %s", cfg.continue_from)
            (ckpt_cfg, epoch, params, opt_state, model_state, label2id,
             id2label, metrics) = ckpt.load_checkpoint(cfg.continue_from)
            if opt_state is None:
                # converted reference checkpoints carry only the Noam step
                from end2end_asr_tpu_torch.training.optimizer import \
                    init_opt_state
                opt_state = init_opt_state(ckpt_cfg, params)
                opt_state["step"] = torch.tensor(
                    int(metrics.get("noam_step", 0)), dtype=torch.int32)
            # architecture from the checkpoint; flags typed on THIS command
            # line override the rest; run identity follows the CLI
            overrides = {k: getattr(cfg, k)
                         for k in explicit_cli_overrides(argv)
                         if k not in ARCH_FIELDS}
            overrides.update(
                train_manifest_list=cfg.train_manifest_list,
                valid_manifest_list=cfg.valid_manifest_list,
                test_manifest_list=cfg.test_manifest_list,
                epochs=cfg.epochs, name=cfg.name,
                save_folder=cfg.save_folder, batch_size=cfg.batch_size,
                parallel=cfg.parallel, shuffle=cfg.shuffle,
                continue_from=cfg.continue_from)
            cfg = ckpt_cfg.replace(**overrides)
            refuse_unported(cfg)
            start_epoch = epoch
        else:
            label2id, id2label = load_vocab(cfg.labels_path)
            if main_rank:
                _warn_duplicate_labels(cfg.labels_path)
            if cfg.model not in ("TRFS", "LRTRFS"):
                raise SystemExit("The model is not supported, check args --h")
            params = init_params(cfg, len(label2id),
                                 torch.Generator().manual_seed(cfg.seed))
            model_state = init_state(cfg)

        noise = (NoiseInjector(cfg.noise_dir, cfg.sample_rate,
                               (cfg.noise_min, cfg.noise_max))
                 if cfg.noise_dir else None)
        train_data = ManifestDataset(
            list(cfg.train_manifest_list), label2id,
            sample_rate=cfg.sample_rate, augment=cfg.augment,
            noise_injector=noise, noise_prob=cfg.noise_prob)
        # each rank builds its slice of every batch
        part = dict(process_index=mesh.data_rank(), process_count=world)
        train_loader = AudioBatchLoader(
            train_data, cfg, sampler=BucketingSampler(
                len(train_data), cfg.batch_size, seed=cfg.seed), **part)
        valid_loaders = [
            AudioBatchLoader(ManifestDataset([m], label2id,
                                             sample_rate=cfg.sample_rate),
                             cfg, **part)
            for m in cfg.valid_manifest_list]
        if cfg.parallel:
            # one static shape a batch: a ragged bin is cycled to the full
            # batch (Batch.real_rows marks the real prefix at world 1)
            for loader in [train_loader, *valid_loaders]:
                loader.pad_to_full = True
        trainer = (trainer_cls or Trainer)(cfg, label2id, id2label, device,
                                           metrics_every=cfg.metrics_every)
        result = trainer.train(params, opt_state, train_loader,
                               valid_loaders, start_epoch=start_epoch,
                               num_epochs=cfg.epochs, last_metrics=metrics,
                               model_state=model_state)
        # the group ends after a run that ended well; a rank that raised
        # exits, and torchrun stops the others
        if started:
            mesh.shutdown()
        return result
    finally:
        logger.removeHandler(handler)
        handler.close()
        if tee is not None:
            sys.stdout = tee.terminal
            tee.close()


if __name__ == "__main__":
    main()
