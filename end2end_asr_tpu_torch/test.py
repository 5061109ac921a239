"""Evaluation CLI of the port — the flags of root ``test.py`` plus
``--device`` (default ``cuda``).

    python -m end2end_asr_tpu_torch.test --continue-from models/run/best_model \
        --test-manifest-list test.csv [--beam-search --beam-width 8] \
        [--lm-rescoring --lm-path lm.npz [--lm-greedy-as-beam]] \
        [--quantize-int8] [--device cpu]

Loads a checkpoint in the JAX package's format (training/checkpoint.py),
takes the feature and model config FROM THE CHECKPOINT (reference
test.py:78-84) and the decode/search flags, the manifests and any other
explicitly typed flag from the command line, quantises the dense weights
to int8 with --quantize-int8 (models/quantize.py), loads the rescoring
LM with --lm-rescoring (models/lm.py; .npz or a reference .pt), builds
the test loader and runs batch evaluation (greedy or --beam-search).
Without a GPU it raises unless --device cpu is given.

``--parallel`` under torchrun (parallel/mesh.py): each rank builds,
encodes and decodes its slice of every batch (ragged bins cycled to the
full batch), the hypotheses are gathered in row order and rank 0 scores
and prints them, as the one-process run would:

    torchrun --standalone --nproc_per_node N -m end2end_asr_tpu_torch.test \
        --parallel --continue-from ... [--device cpu]

``--parallel --mesh-model M`` is tensor-parallel inference
(parallel/tp.py): the ranks form a data x model grid, each model
coordinate encodes and decodes with its shard of the attention and FFN
weights (greedy and beam, the KV caches holding its local heads), and
the strings are the one-process run's: low-rank (LRTRFS) checkpoints
and --quantize-int8 too (the factors and the int8 weights whole on each
rank, their columns or rows taken at use, as the shard map keeps them),
and a checkpoint trained with --seq-parallel encodes on T slices (each
bucket's encoder length must divide by M). Checkpoints in the port's
sharded format (``<base>.dcp``) load as npz ones do.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from end2end_asr_tpu_torch.config import (ARCH_FIELDS, config_from_args,
                                          explicit_cli_overrides)


def split_device_arg(argv: Optional[List[str]]):
    """(device, remaining argv): --device is the port's own flag."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    ns, rest = p.parse_known_args(argv)
    return ns.device, rest


def main(argv=None, timings: Optional[list] = None):
    """Runs the evaluation and returns the metrics dict; `timings`
    collects per-batch encode/decode times (evaluation.evaluate)."""
    if argv is None:
        argv = sys.argv[1:]
    device_name, argv = split_device_arg(argv)
    cli = config_from_args(argv)
    if not cli.continue_from:
        print("need --continue-from checkpoint")
        sys.exit(1)

    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import (AudioBatchLoader,
                                                   BucketingSampler)
    from end2end_asr_tpu_torch.evaluation import (evaluate, prepare_params,
                                                  resolve_device)
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.parallel import mesh
    from end2end_asr_tpu_torch.training.checkpoint import load_checkpoint

    device = mesh.rank_device(resolve_device(device_name))
    world, started = (mesh.join_group(device, cli.mesh_data, cli.batch_size,
                                      mesh_model=cli.mesh_model)
                      if cli.parallel else (1, False))
    main_rank = mesh.is_main()
    logging.basicConfig(stream=sys.stdout,
                        format="%(asctime)s - %(message)s",
                        level=logging.INFO if main_rank else logging.WARNING)
    if cli.parallel:
        logging.getLogger("end2end_asr_tpu_torch").info(
            mesh.describe(device))

    cfg, _, params, _, model_state, label2id, id2label, _ = load_checkpoint(
        cli.continue_from)
    overrides = {k: getattr(cli, k)
                 for k in explicit_cli_overrides(argv)
                 if k not in ARCH_FIELDS}
    overrides.update(
        test_manifest_list=cli.test_manifest_list,
        batch_size=cli.batch_size, beam_search=cli.beam_search,
        beam_width=cli.beam_width, beam_nbest=cli.beam_nbest,
        lm_rescoring=cli.lm_rescoring, lm_path=cli.lm_path,
        lm_weight=cli.lm_weight, c_weight=cli.c_weight,
        lm_greedy_as_beam=cli.lm_greedy_as_beam,
        decode_max_len=cli.decode_max_len,
        decode_stage_len=cli.decode_stage_len,
        verbose=cli.verbose, continue_from=cli.continue_from)
    # a checkpoint trained with --seq-parallel, or a typed --seq-parallel
    # (an override, as root test.py applies it), serves the encoder on T
    # slices under --parallel --mesh-model M > 1, as root test.py installs
    # parallel/sp.py there; elsewhere the flag does nothing
    cfg = cfg.replace(**overrides)
    cfg = cfg.replace(seq_parallel=bool(cfg.seq_parallel
                                        and mesh.model_size() > 1))
    if cfg.seq_parallel:
        logging.getLogger("end2end_asr_tpu_torch").info(
            "sequence parallelism: the encoder on T/%d slices",
            mesh.model_size())
    if mesh.model_size() > 1:
        from end2end_asr_tpu_torch.parallel.tp import check_tp_divisibility
        check_tp_divisibility(cfg, mesh.model_size())

    if cfg.quantize_int8:
        from end2end_asr_tpu_torch.models.quantize import \
            quantize_for_inference
        params = quantize_for_inference(params)

    test_data = ManifestDataset(list(cfg.test_manifest_list), label2id,
                                sample_rate=cfg.sample_rate)
    test_loader = AudioBatchLoader(
        test_data, cfg,
        sampler=BucketingSampler(len(test_data), cfg.batch_size,
                                 seed=cfg.seed),
        process_index=mesh.data_rank(), process_count=world)
    # one static shape a batch over the ranks: a ragged bin is cycled to
    # the full batch; evaluate() cuts the duplicates
    test_loader.pad_to_full = cli.parallel
    lm = None
    if cfg.lm_rescoring:
        from end2end_asr_tpu_torch.models.lm import LM
        lm = LM(cfg.lm_path, device)
    if mesh.model_size() > 1:
        from end2end_asr_tpu_torch.training.checkpoint import \
            model_rank_tree
        params = model_rank_tree(params, mesh.model_size(),
                                 mesh.model_rank())
    params = prepare_params(params, dims_from_config(cfg), device,
                            model_state)
    results = evaluate(params, cfg, test_loader, id2label, device,
                       verbose=cfg.verbose, timings=timings, lm=lm)
    if started:     # a rank that raised exits; torchrun stops the others
        mesh.shutdown()
    if not main_rank:
        return results
    print("TEST CER:{:.2f}% WER:{:.2f}% CER_EN:{:.2f}% CER_ZH:{:.2f}%".format(
        results["cer"], results["wer"], results["cer_en"],
        results["cer_zh"]))
    return results


if __name__ == "__main__":
    main()
